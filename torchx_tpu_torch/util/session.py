"""Process-wide session id, propagated to subprocesses via env.

Reference analog: torchx/util/session.py — a uuid created once per client
process and forwarded through $TPX_INTERNAL_SESSION_ID so nested runners /
launched jobs correlate telemetry events.
"""

from __future__ import annotations

import os
import uuid
from typing import Optional

from torchx_tpu_torch import settings

_session_id: Optional[str] = None


def get_session_id_or_create_new() -> str:
    global _session_id
    if _session_id is None:
        _session_id = os.environ.get(settings.ENV_TPX_INTERNAL_SESSION_ID) or str(
            uuid.uuid4()
        )
        os.environ[settings.ENV_TPX_INTERNAL_SESSION_ID] = _session_id
    return _session_id


def current_session_id() -> Optional[str]:
    return _session_id
