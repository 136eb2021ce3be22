"""Crash-safe supervision state: the per-session attempt ledger.

Port of :mod:`torchx_tpu.supervisor.ledger`. The records and the file
layout are the reference's, so each package's reader reads the other's
sessions; the port keeps its own default root,
``~/.torchx_tpu_torch/supervisor``, beside its local-app registry
``~/.tpx_torch_local_apps``, because a port session names the port's
schedulers.

The supervisor loop lives in a client process, and client processes die —
laptops sleep, SSH sessions drop, pods get OOM-killed. Everything the
loop knows (which attempt is live, how many retries each failure class
has consumed, what to resubmit) must therefore be durable *before* it
matters. Each supervised session owns one directory under
``$TPX_SUPERVISOR_DIR`` (default ``~/.torchx_tpu_torch/supervisor``)::

    <root>/<session>/
        meta.json      # scheduler, cfg, AppDef, policy — written once
        ledger.jsonl   # one line per transition, appended as it happens

``meta.json`` holds what a fresh process needs to rebuild the submission
(via :func:`~torchx_tpu_torch.specs.serialize.appdef_from_dict` and the
scheduler's ``materialize_dryrun``); ``ledger.jsonl`` is the transition
history (submitted / resubmitting / finished / ...) that
:meth:`~torchx_tpu_torch.supervisor.api.Supervisor.resume` replays to restore
the attempt and retry counters and find the last live handle. Appends are
line-atomic on POSIX (single small ``write`` on an append-mode fd), so a
crash mid-run costs at most the final line.

All writes are best-effort from the supervisor's point of view: a full
disk degrades resumability, never the run itself.
"""

from __future__ import annotations

import json
import os
from typing import Any, Iterator, Optional

from torchx_tpu_torch import settings
from torchx_tpu_torch.util.times import epoch_usec

META_FILE = "meta.json"
LEDGER_FILE = "ledger.jsonl"


def supervisor_root(root: Optional[str] = None) -> str:
    """The ledger root directory: explicit ``root`` arg, else
    ``$TPX_SUPERVISOR_DIR``, else ``~/.torchx_tpu_torch/supervisor``."""
    return (
        root
        or os.environ.get(settings.ENV_TPX_SUPERVISOR_DIR)
        or os.path.join(os.path.expanduser("~"), ".torchx_tpu_torch", "supervisor")
    )


def list_sessions(root: Optional[str] = None) -> list[str]:
    """Session names with a ``meta.json`` on disk, newest first (by
    meta mtime) — what ``tpx-torch supervise --resume`` can reattach to."""
    base = supervisor_root(root)
    try:
        names = os.listdir(base)
    except OSError:
        return []
    stamped = []
    for name in names:
        meta = os.path.join(base, name, META_FILE)
        try:
            stamped.append((os.path.getmtime(meta), name))
        except OSError:
            continue
    return [name for _, name in sorted(stamped, reverse=True)]


class AttemptLedger:
    """Durable record of one supervised session (see module docstring).

    Constructing the ledger creates nothing; :meth:`write_meta` and
    :meth:`append` create the session directory on first write, and the
    read side (:meth:`read_meta` / :meth:`entries`) works on whatever a
    crashed writer left behind.
    """

    def __init__(self, session: str, root: Optional[str] = None) -> None:
        if not session or "/" in session or session in (".", ".."):
            raise ValueError(f"invalid supervisor session name {session!r}")
        self.session = session
        self.path = os.path.join(supervisor_root(root), session)

    # -- write side (best-effort: never let bookkeeping kill the run) ------

    def write_meta(self, meta: dict[str, Any]) -> None:
        """Persist the session's rebuild recipe (atomic tmp + fsync +
        rename: a reader either sees the whole old doc or the whole new
        one, never a torn meta.json — even through a crash)."""
        try:
            os.makedirs(self.path, exist_ok=True)
            tmp = os.path.join(self.path, META_FILE + ".tmp")
            with open(tmp, "w") as f:
                json.dump(meta, f, indent=2, sort_keys=True)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, os.path.join(self.path, META_FILE))
        except OSError:
            pass

    def append(
        self, transition: str, app_id: Optional[str], **metadata: object
    ) -> None:
        """Append one transition line; stamped with the wall clock so the
        ledger doubles as a human-readable timeline."""
        entry = {
            "transition": transition,
            "app_id": app_id,
            "time_usec": epoch_usec(),
            **metadata,
        }
        try:
            os.makedirs(self.path, exist_ok=True)
            # one complete line per write on an append-mode fd (atomic on
            # POSIX), fsynced so the transition is durable before the
            # supervisor acts on it — resume must never replay less than
            # what the dead client already did
            with open(os.path.join(self.path, LEDGER_FILE), "a") as f:
                f.write(json.dumps(entry) + "\n")
                f.flush()
                os.fsync(f.fileno())
        except (OSError, TypeError, ValueError):
            pass

    # -- read side (resume) ------------------------------------------------

    def exists(self) -> bool:
        """True when the session has a ``meta.json`` to resume from."""
        return os.path.exists(os.path.join(self.path, META_FILE))

    def read_meta(self) -> dict[str, Any]:
        """The session's rebuild recipe; raises ``FileNotFoundError`` with
        the known sessions listed when there is nothing to resume."""
        try:
            with open(os.path.join(self.path, META_FILE)) as f:
                return json.load(f)
        except FileNotFoundError:
            known = ", ".join(list_sessions(os.path.dirname(self.path))) or "(none)"
            raise FileNotFoundError(
                f"no supervised session {self.session!r} under"
                f" {os.path.dirname(self.path)}; known sessions: {known}"
            ) from None

    def entries(self) -> Iterator[dict[str, Any]]:
        """Transition lines, oldest first; a torn final line (writer died
        mid-append) is skipped rather than fatal."""
        try:
            f = open(os.path.join(self.path, LEDGER_FILE))
        except OSError:
            return
        with f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    yield json.loads(line)
                except ValueError:
                    continue
