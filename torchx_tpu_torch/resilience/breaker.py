"""Circuit breakers for control-plane backends, in two durabilities.

:class:`CircuitBreaker` is the classic in-process closed -> open ->
half-open machine: trip after N *consecutive* transient failures, cool
down, then let exactly one probe through; the probe's outcome decides
between closing and re-opening. One breaker guards each backend (see
:func:`~torchx_tpu_torch.resilience.call.breaker_for`) so a dead control plane
fails fast instead of stacking deadlines on every poll.

:class:`FailureLedger` is the same trip-after-N-consecutive-failures idea
made durable and keyed: a per-user file counting unbroken failures per
string key, where a success clears the key and a key at threshold is
"tripped" until something succeeds against it again. It generalizes the
gcp_batch scope-eviction bookkeeping (``.tpxgcpbatchscopefails``) that
previously lived inline in that scheduler — a revoked project's scope
sits out of ``list()`` fan-out, and the same primitive is available to
any backend that needs cross-process failure memory.
"""

from __future__ import annotations

import enum
import os
import threading
import time
from typing import Callable, Optional


class BreakerState(enum.Enum):
    """The three classic circuit-breaker states."""

    #: calls flow; consecutive transient failures are counted.
    CLOSED = "closed"
    #: calls are refused until the cool-down elapses.
    OPEN = "open"
    #: cool-down elapsed; exactly one probe call is allowed through.
    HALF_OPEN = "half_open"


#: numeric encoding for the ``tpx_control_plane_breaker_state`` gauge.
STATE_VALUES = {
    BreakerState.CLOSED: 0,
    BreakerState.HALF_OPEN: 1,
    BreakerState.OPEN: 2,
}


class CircuitBreaker:
    """In-process breaker guarding one backend's control plane.

    Thread-safe; ``clock`` is injectable (monotonic seconds) so tests can
    step time instead of sleeping. Only *transient* outcomes should be
    recorded as failures — a deterministic auth error says nothing about
    backend health and must not trip the breaker."""

    def __init__(
        self,
        name: str,
        trip_after: int = 5,
        cooldown_seconds: float = 30.0,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        if trip_after < 1:
            raise ValueError(f"trip_after must be >= 1, got {trip_after}")
        if cooldown_seconds < 0:
            raise ValueError(
                f"cooldown_seconds must be >= 0, got {cooldown_seconds}"
            )
        self.name = name
        self.trip_after = trip_after
        self.cooldown_seconds = cooldown_seconds
        self._clock = clock
        self._lock = threading.Lock()
        self._state = BreakerState.CLOSED
        self._consecutive_failures = 0
        self._opened_at: Optional[float] = None
        self._probe_out = False

    @property
    def state(self) -> BreakerState:
        """Current state (OPEN decays to HALF_OPEN once cooled down)."""
        with self._lock:
            self._maybe_half_open()
            return self._state

    def _maybe_half_open(self) -> None:
        if (
            self._state is BreakerState.OPEN
            and self._opened_at is not None
            and self._clock() - self._opened_at >= self.cooldown_seconds
        ):
            self._state = BreakerState.HALF_OPEN

    def allow(self) -> bool:
        """May a call proceed right now? CLOSED always; OPEN never (until
        the cool-down); HALF_OPEN admits one probe then refuses until the
        probe reports back."""
        with self._lock:
            self._maybe_half_open()
            if self._state is BreakerState.CLOSED:
                return True
            if self._state is BreakerState.HALF_OPEN:
                # admit one probe; restart the cool-down so an abandoned
                # probe (caller died) cannot wedge the breaker open forever
                self._state = BreakerState.OPEN
                self._opened_at = self._clock()
                self._probe_out = True
                return True
            return False

    def record_success(self) -> None:
        """A call completed: reset the failure streak and close."""
        with self._lock:
            self._state = BreakerState.CLOSED
            self._consecutive_failures = 0
            self._opened_at = None
            self._probe_out = False

    def record_failure(self) -> None:
        """A call failed transiently: extend the streak; trip to OPEN at
        ``trip_after`` (or immediately when a half-open probe fails)."""
        with self._lock:
            probing = self._probe_out
            self._probe_out = False
            self._consecutive_failures += 1
            if probing or self._consecutive_failures >= self.trip_after:
                self._state = BreakerState.OPEN
                self._opened_at = self._clock()


class FailureLedger:
    """Durable consecutive-failure counter, keyed by string.

    The file is APPEND-ONLY: one ``key`` line per failure, one
    ``key|clear`` tombstone line per success. :meth:`failures` replays
    the lines in order, so a tombstone erases every failure recorded
    before it and none after. Clears used to rewrite the whole file
    (tmp + ``os.replace``), which could silently drop a failure appended
    between the read and the replace; a tombstone is a single O_APPEND
    write, so concurrent writers can no longer undo each other. A key
    with >= ``threshold`` unbroken failures is *tripped* and should sit
    out until a success clears it. Keys must not end with ``|clear``
    (they would parse as tombstones)."""

    CLEAR_SUFFIX = "|clear"

    def __init__(self, path: str, threshold: int = 3) -> None:
        if threshold < 1:
            raise ValueError(f"threshold must be >= 1, got {threshold}")
        self.path = path
        self.threshold = threshold

    def failures(self) -> dict[str, int]:
        """Unbroken failure count per key (missing file = empty),
        replaying failure lines and ``|clear`` tombstones in order."""
        out: dict[str, int] = {}
        try:
            with open(self.path) as f:
                for line in f:
                    key = line.strip()
                    if not key:
                        continue
                    if key.endswith(self.CLEAR_SUFFIX):
                        out.pop(key[: -len(self.CLEAR_SUFFIX)], None)
                    else:
                        out[key] = out.get(key, 0) + 1
        except OSError:
            pass
        return out

    def note(self, key: str, ok: bool) -> None:
        """Record one observation: a failure appends a ``key`` line; a
        success appends a ``key|clear`` tombstone (only when the key has
        recorded failures, so a success on a clean ledger stays a no-op
        and never creates the file). Each append is one O_APPEND write
        of one line — concurrent notes interleave per-line instead of
        racing a whole-file rewrite."""
        try:
            if ok and key not in self.failures():
                return
            line = f"{key}{self.CLEAR_SUFFIX}\n" if ok else f"{key}\n"
            fd = os.open(
                self.path, os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644
            )
            try:
                os.write(fd, line.encode())
            finally:
                os.close(fd)
        except OSError:
            pass

    def tripped(self) -> set[str]:
        """Keys whose unbroken failure count reached the threshold."""
        return {
            key
            for key, count in self.failures().items()
            if count >= self.threshold
        }
