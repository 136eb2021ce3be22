"""Human time parsing for log windows (reference analog:
torchx/util/datetime.py — generalized from day-granularity to the
``--since 2h`` style every log CLI actually needs), plus the shared
jittered poll-interval generator used by ``Runner.wait`` and the
supervisor loop, and the clock helpers every telemetry record is
stamped with (one definition of "now" for events, spans, and metrics).
"""

from __future__ import annotations

import math
import random
import re
import time
from datetime import datetime
from typing import Iterator, Optional

# Wall-clock zero for process-relative stamps: events emitted outside a
# measured block (e.g. supervisor transitions) carry "time since this
# module loaded", so consecutive records can still be diffed.
_WALL_ZERO_NS = time.perf_counter_ns()


def epoch_usec() -> int:
    """Current wall time in integer epoch microseconds — the stamp unit
    shared by the launcher's telemetry events and
    :class:`~torchx_tpu_torch.obs.trace.Span`."""
    return int(time.time() * 1e6)


def process_wall_usec() -> int:
    """Monotonic microseconds since this module was first imported
    (process start, for practical purposes)."""
    return (time.perf_counter_ns() - _WALL_ZERO_NS) // 1000


def process_cpu_usec() -> int:
    """This process's total CPU time in microseconds."""
    return time.process_time_ns() // 1000


def stamp_event(event) -> None:  # noqa: ANN001 - TpxEvent; avoids an import cycle
    """Fill any still-``None`` time fields of a telemetry event at emit
    time: ``start_epoch_time_usec`` gets the wall clock, ``wall``/``cpu``
    get process-relative clocks (so instantaneous records — supervisor
    transitions — are diffable). Events measured by ``log_event`` arrive
    with these already set and are left untouched."""
    if event.start_epoch_time_usec is None:
        event.start_epoch_time_usec = epoch_usec()
    if event.wall_time_usec is None:
        event.wall_time_usec = process_wall_usec()
    if event.cpu_time_usec is None:
        event.cpu_time_usec = process_cpu_usec()

_REL = re.compile(r"^(\d+)([smhdw])$")
_UNITS = {"s": 1, "m": 60, "h": 3600, "d": 86400, "w": 604800}


def parse_when(value: Optional[str], now: Optional[float] = None) -> Optional[float]:
    """-> epoch seconds for ``None``/''/relative/''ISO''/epoch inputs.

    Accepted forms:
      - ``"300"`` / ``"1722333444.5"``  absolute epoch seconds
      - ``"2h"`` ``"30m"`` ``"45s"`` ``"7d"`` ``"1w"``  ago-from-now
      - ``"2026-07-29T10:00:00"`` (any ``datetime.fromisoformat`` string)
    """
    if not value:
        return None
    ts = now if now is not None else datetime.now().timestamp()
    m = _REL.match(value)
    if m:
        return ts - int(m.group(1)) * _UNITS[m.group(2)]
    try:
        f = float(value)
    except ValueError:
        f = None
    if f is not None:
        if not math.isfinite(f):
            raise ValueError(f"non-finite time {value!r}")
        return f
    try:
        return datetime.fromisoformat(value).timestamp()
    except ValueError:
        raise ValueError(
            f"cannot parse time {value!r}; use epoch seconds, a relative"
            " window like 2h/30m/7d, or an ISO timestamp"
        ) from None


def poll_intervals(
    initial: float = 1.0,
    factor: float = 1.5,
    max_interval: float = 10.0,
    jitter: float = 0.1,
    rng: Optional[random.Random] = None,
) -> Iterator[float]:
    """Infinite stream of sleep intervals for a status-poll loop: starts at
    ``initial`` seconds, grows by ``factor`` up to ``max_interval``, with
    each value perturbed by ±``jitter`` fraction so a fleet of clients
    polling the same control plane decorrelates instead of thundering.
    Pass a seeded ``rng`` for deterministic tests."""
    if initial <= 0:
        raise ValueError(f"initial poll interval must be > 0, got {initial}")
    rng = rng or random
    interval = initial
    while True:
        yield max(0.0, interval * (1.0 + rng.uniform(-jitter, jitter)))
        interval = min(interval * factor, max_interval)
