"""The session's durable trace file.

Port of the trace half of :mod:`torchx_tpu.obs.sinks`. Everything lands
under one session directory, ``~/.torchx_tpu/obs/<session>/`` (the root
overridden by ``$TPX_OBS_DIR``), whose ``trace.jsonl`` holds every span
the session emitted, one JSON object per line, appended by every
participating process: the client and the replicas it launched share the
session through ``$TPX_INTERNAL_SESSION_ID``, so ``tpx trace`` and the gang
monitor read the port's spans beside the launcher's.
"""

from __future__ import annotations

import logging
import os
import uuid
from typing import Optional

from torchx_tpu_torch import settings
from torchx_tpu_torch.obs import trace

TRACE_FILE = "trace.jsonl"

_session_id: Optional[str] = None


def session_id() -> str:
    """The process-wide session id: ``$TPX_INTERNAL_SESSION_ID`` when the
    launcher set it, else a new uuid, exported to the environment so that
    subprocesses join it (``torchx_tpu.util.session``)."""
    global _session_id
    if _session_id is None:
        _session_id = os.environ.get(settings.ENV_TPX_INTERNAL_SESSION_ID) or str(
            uuid.uuid4()
        )
        os.environ[settings.ENV_TPX_INTERNAL_SESSION_ID] = _session_id
    return _session_id


def obs_root() -> str:
    """Root of all durable observability output:
    ``$TPX_OBS_DIR`` or ``~/.torchx_tpu/obs``."""
    return os.environ.get(settings.ENV_TPX_OBS_DIR) or os.path.join(
        os.path.expanduser("~"), ".torchx_tpu", "obs"
    )


def default_session_name() -> str:
    """The session directory's name, ``tpx_<first 8 of the session id>``:
    the name the launcher's runner gives the session its replicas share."""
    return f"tpx_{session_id()[:8]}"


def session_dir(session: Optional[str] = None) -> str:
    """Directory holding one session's trace (and the leases under it)."""
    return os.path.join(obs_root(), session or default_session_name())


def trace_path(session: Optional[str] = None) -> str:
    """The session's JSONL trace file path."""
    return os.path.join(session_dir(session), TRACE_FILE)


class JsonlTraceHandler(logging.Handler):
    """Logging handler appending each record's message (an already
    serialized span) as one line to the session's ``trace.jsonl``.

    The path is resolved at every emit, so it follows changes of
    ``$TPX_OBS_DIR`` mid-process. Single-line ``O_APPEND`` writes keep
    concurrent processes' records whole. Emission is best-effort:
    telemetry never breaks its caller."""

    def emit(self, record: logging.LogRecord) -> None:
        if not trace.tracing_enabled():
            return
        try:
            path = trace_path()
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "a") as f:
                f.write(record.getMessage().rstrip("\n") + "\n")
        except Exception:  # noqa: BLE001 - never break the caller
            self.handleError(record)


def attach_trace_sink() -> None:
    """Send the port's completed spans to the session's ``trace.jsonl``
    (idempotent)."""
    if not any(isinstance(h, JsonlTraceHandler) for h in trace.SPAN_LOGGER.handlers):
        trace.SPAN_LOGGER.addHandler(JsonlTraceHandler())
        trace.SPAN_LOGGER.setLevel(logging.INFO)
