"""Per-replica liveness leases.

Port of the lease half of :mod:`torchx_tpu.supervisor.gang`: a training
replica renews a tiny JSON lease, ``<session>/leases/<replica>.json``,
beside each heartbeat, and the launcher's gang monitor
(``torchx_tpu.supervisor.gang.GangMonitor``, which runs on the client)
reads it as proof of life when the shared trace stream stalls. The file
layout and record are the reference's, so either package reads the other's
leases.
"""

from __future__ import annotations

import json
import os
from typing import Optional

from torchx_tpu_torch.obs import sinks
from torchx_tpu_torch.util.times import epoch_usec

_LEASE_DIR = "leases"


def _lease_dir(session: Optional[str] = None) -> str:
    return os.path.join(sinks.session_dir(session), _LEASE_DIR)


def renew_lease(
    replica: int, step: int = -1, session: Optional[str] = None
) -> str:
    """Renew ``replica``'s liveness lease (an atomic tiny-JSON write:
    temporary file, fsync, rename). -> the lease file's path."""
    d = _lease_dir(session)
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"{int(replica)}.json")
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(
            {"replica": int(replica), "step": int(step), "epoch_usec": epoch_usec()},
            f,
        )
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def read_leases(session: Optional[str] = None) -> dict[int, dict]:
    """All current leases of a session, keyed by replica id (torn or
    foreign files are skipped: leases are best-effort evidence)."""
    d = _lease_dir(session)
    out: dict[int, dict] = {}
    try:
        names = os.listdir(d)
    except OSError:
        return out
    for name in names:
        if not name.endswith(".json"):
            continue
        try:
            with open(os.path.join(d, name)) as f:
                rec = json.load(f)
            out[int(rec["replica"])] = rec
        except (OSError, ValueError, KeyError, TypeError):
            continue
    return out
