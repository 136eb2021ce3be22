"""Multi-replica threaded log tee with role/replica prefixes.

Port of :mod:`torchx_tpu.util.log_tee_helpers`.
Reference analog: torchx/util/log_tee_helpers.py — one thread per replica
streams ``runner.log_lines`` to stdout, each line prefixed ``role/replica``
with a stable ANSI color per replica.
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Optional, TextIO

from torchx_tpu_torch.runner.api import Runner
from torchx_tpu_torch.specs.api import AppStatus, is_started

from torchx_tpu_torch.util.colors import colored

_COLOR_CYCLE = ["cyan", "green", "yellow", "blue", "magenta", "red"]


def _colored(prefix: str, idx: int, enabled: bool) -> str:
    return colored(prefix, _COLOR_CYCLE[idx % len(_COLOR_CYCLE)], enabled)


class LineEmitter:
    """Thread-safe line-atomic writer shared by every replica stream.

    Each :meth:`emit` performs ONE ``write()`` of a complete
    newline-terminated line plus a flush, under one lock — concurrent
    replica threads can interleave whole lines but never partial lines
    (separate write("text") / write("\\n") calls, as ``print`` issues,
    interleave under load even when each call is individually atomic)."""

    def __init__(self, out: TextIO = sys.stdout) -> None:
        self._out = out
        self._lock = threading.Lock()

    def emit(self, prefix: str, line: str) -> None:
        text = f"{prefix} {line.rstrip(chr(10))}\n" if prefix else f"{line.rstrip(chr(10))}\n"
        with self._lock:
            self._out.write(text)
            self._out.flush()


def find_role_replicas(
    app_status: Optional[AppStatus], role_name: Optional[str]
) -> list[tuple[str, int]]:
    """All (role, replica_id) pairs, optionally filtered to one role."""
    out: list[tuple[str, int]] = []
    if app_status is None:
        return out
    for role_status in app_status.roles:
        if role_name and role_status.role != role_name:
            continue
        for r in role_status.replicas:
            out.append((role_status.role, r.id))
    return out


def _stream_one(
    runner: Runner,
    app_handle: str,
    role: str,
    replica: int,
    prefix: str,
    should_tail: bool,
    emitter: LineEmitter,
) -> None:
    try:
        for line in runner.log_lines(
            app_handle, role, replica, should_tail=should_tail
        ):
            emitter.emit(prefix, line)
    except Exception as e:  # noqa: BLE001 - log streaming is best-effort
        emitter.emit(prefix, f"<log stream error: {e}>")


def wait_for_app_started(
    runner: Runner, app_handle: str, poll_interval: float = 0.5, timeout: float = 600
) -> Optional[AppStatus]:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        status = runner.status(app_handle)
        if status is None:
            return None
        if is_started(status.state):
            return status
        time.sleep(poll_interval)
    return runner.status(app_handle)


def tee_logs(
    runner: Runner,
    app_handle: str,
    role_name: Optional[str] = None,
    should_tail: bool = True,
    out: TextIO = sys.stderr,
    colors: Optional[bool] = None,
) -> threading.Thread:
    """Spawn one streaming thread per replica; returns a supervisor thread
    that joins them all."""
    status = wait_for_app_started(runner, app_handle)
    replicas = find_role_replicas(status, role_name)
    use_colors = colors if colors is not None else out.isatty()
    emitter = LineEmitter(out)
    threads = []
    for idx, (role, replica) in enumerate(replicas):
        prefix = _colored(f"{role}/{replica}", idx, use_colors)
        t = threading.Thread(
            target=_stream_one,
            args=(runner, app_handle, role, replica, prefix, should_tail, emitter),
            daemon=True,
        )
        t.start()
        threads.append(t)

    def _join_all() -> None:
        for t in threads:
            t.join()

    supervisor = threading.Thread(target=_join_all, daemon=True)
    supervisor.start()
    return supervisor
