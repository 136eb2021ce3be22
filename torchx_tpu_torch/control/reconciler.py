"""The reconciler: one event loop that owns every watch stream (the
port's copy of :mod:`torchx_tpu.control.reconciler`).

Before the control plane, each caller watching a job ran its own poll
loop. The reconciler inverts that fan-out: it holds exactly ONE
:class:`~torchx_tpu_torch.control.watch.Watcher` per scheduler backend (a
daemon thread pumping ``events(follow=True)``), and every observed
transition is:

1. journaled into the sharded :class:`~torchx_tpu_torch.control.store
   .JobStateStore` (crash-safe daemon restarts),
2. folded into the Runner's describe cache through its writer path
   (:meth:`~torchx_tpu_torch.runner.describe_cache.DescribeCache.put` when the
   event carries a confirming describe, ``invalidate`` when it does not —
   never a second cache), and
3. broadcast on a condition variable so ``Runner.wait`` / supervisor
   waiters blocked in :meth:`wait_event` wake *immediately* instead of
   sleeping out their poll interval.

Any number of runners/daemon threads share one reconciler; it is fully
thread-safe and survives watcher death (a dead stream is logged and its
apps fall back to the callers' poll loops — the reconciler degrades, the
wait path never breaks).

A reconciler built with a ``cell`` (the control daemon's) stamps it on
every event it journals that arrives without one. The watch streams do
not know the daemon's cell, so in the JAX package a job's last record,
the terminal event its sidecar watcher delivered, carries ``cell=''``.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Any, Callable, Optional

from torchx_tpu_torch.control.events import StateEvent
from torchx_tpu_torch.control.store import JobStateStore
from torchx_tpu_torch.obs import metrics as obs_metrics

logger = logging.getLogger(__name__)


class Reconciler:
    """Single owner of all watch streams; see the module docstring.

    Args:
        store: optional durable journal; events are appended before any
            in-memory state changes (crash ordering: disk first).
        clock: injectable monotonic clock for :meth:`wait_event` deadlines
            (the sim harness runs the reconciler on virtual time).
        cell: the federation cell stamped on every ingested event that
            carries none (empty: events are kept as they come).
    """

    def __init__(
        self,
        store: Optional[JobStateStore] = None,
        clock: Callable[[], float] = time.monotonic,
        cell: str = "",
    ) -> None:
        self.store = store
        self._clock = clock
        self.cell = cell
        self._cond = threading.Condition()
        # (scheduler, app_id) -> (seq, event); seq is a global monotonic
        # counter so waiters can tell "new since I started waiting"
        self._events: dict[tuple[str, str], tuple[int, StateEvent]] = {}
        self._seq = 0
        self._lock = threading.Lock()
        self._watchers: dict[str, Any] = {}  # backend -> Watcher
        self._threads: dict[str, threading.Thread] = {}
        self._caches: list[Any] = []  # DescribeCache instances to refresh
        self._subscribers: list[Any] = []  # callables fed every ingest
        self._closed = False

    # -- wiring ------------------------------------------------------------

    def bind_cache(self, cache: Any) -> None:
        """Register a Runner's describe cache for watch-driven refresh
        (idempotent; any number of runners can share the reconciler)."""
        with self._lock:
            if cache not in self._caches:
                self._caches.append(cache)

    def subscribe(self, fn: Any) -> None:
        """Register ``fn(event)`` to run after every ingested transition
        (journal -> cache -> broadcast -> subscribers). The fleet
        scheduler hangs its placement loop off this hook. Subscriber
        exceptions are logged, never propagated into the watch pump; a
        subscriber may call back into the reconciler (ingest/track)."""
        with self._lock:
            if fn not in self._subscribers:
                self._subscribers.append(fn)

    def track(self, backend: str, scheduler: Any, app_id: str) -> None:
        """Start watching one app: joins the backend's existing stream or
        opens it (one watcher thread per backend, ever). Never raises —
        a backend whose watch cannot start just stays on poll."""
        try:
            with self._lock:
                if self._closed:
                    return
                watcher = self._watchers.get(backend)
                if watcher is not None:
                    watcher.add(app_id)
                    return
                watcher = scheduler.watch([app_id])
                self._watchers[backend] = watcher
                t = threading.Thread(
                    target=self._pump,
                    args=(backend, watcher),
                    daemon=True,
                    name=f"tpx-reconcile-{backend}",
                )
                self._threads[backend] = t
            obs_metrics.WATCH_STREAMS.set(
                float(len(self._watchers)), scheduler=backend
            )
            t.start()
        except Exception as e:  # noqa: BLE001 - tracking is an optimization
            logger.warning("cannot watch %s on %s: %s", app_id, backend, e)

    def has_stream(self, backend: str) -> bool:
        """True when a watch stream is already open for ``backend``."""
        with self._lock:
            return backend in self._watchers

    # -- the event loop ----------------------------------------------------

    def _pump(self, backend: str, watcher: Any) -> None:
        try:
            for event in watcher.events(follow=True):
                self.ingest(event)
        except Exception as e:  # noqa: BLE001 - stream death degrades to poll
            logger.warning("watch stream for %s died: %s", backend, e)
        finally:
            with self._lock:
                self._watchers.pop(backend, None)
                self._threads.pop(backend, None)
            obs_metrics.WATCH_STREAMS.set(0.0, scheduler=backend)

    def ingest(self, event: StateEvent) -> None:
        """Apply one observed transition: journal -> cache -> wake.

        Public so the daemon's submit path can seed SUBMITTED events and
        tests can inject transitions without a live watcher."""
        if self.cell and not event.cell:
            event = dataclasses.replace(event, cell=self.cell)
        if self.store is not None:
            self.store.append(event)
        with self._lock:
            caches = list(self._caches)
        for cache in caches:
            try:
                if event.resp is not None or event.state.name == "UNKNOWN":
                    # confirmed describe (or backend-forgot): writer path
                    cache.put(event.scheduler, event.app_id, event.resp)
                else:
                    # stream-only transition: drop the entry so the next
                    # reader re-fetches through the resilient seam
                    cache.invalidate(event.scheduler, event.app_id)
            except Exception:  # noqa: BLE001 - cache refresh is best-effort
                logger.debug("cache refresh failed", exc_info=True)
        with self._cond:
            self._seq += 1
            self._events[(event.scheduler, event.app_id)] = (self._seq, event)
            self._cond.notify_all()
        with self._lock:
            subscribers = list(self._subscribers)
        for fn in subscribers:
            try:
                fn(event)
            except Exception:  # noqa: BLE001 - never kill the watch pump
                logger.warning(
                    "reconciler subscriber failed for %s/%s",
                    event.scheduler,
                    event.app_id,
                    exc_info=True,
                )

    # -- waiter side -------------------------------------------------------

    def latest(self, scheduler: str, app_id: str) -> Optional[StateEvent]:
        """Most recent transition seen this process for one app."""
        with self._cond:
            entry = self._events.get((scheduler, app_id))
            return entry[1] if entry else None

    def wait_event(
        self, scheduler: str, app_id: str, timeout: float
    ) -> Optional[StateEvent]:
        """Block until a NEW event for the app arrives (or ``timeout``).

        An already-recorded terminal/UNKNOWN event returns immediately —
        the ``Runner.wait`` regression case where the job finished between
        two polls must not cost a full poll-interval sleep. Returns the
        event, or None on timeout (callers fall back to their poll)."""
        key = (scheduler, app_id)
        deadline = self._clock() + max(0.0, timeout)
        with self._cond:
            entry = self._events.get(key)
            start_seq = entry[0] if entry else 0
            if entry is not None and (
                entry[1].terminal or entry[1].state.name == "UNKNOWN"
            ):
                return entry[1]
            while True:
                entry = self._events.get(key)
                if entry is not None and entry[0] > start_seq:
                    return entry[1]
                remaining = deadline - self._clock()
                if remaining <= 0 or self._closed:
                    return None
                self._cond.wait(remaining)

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        """Stop every stream and wake every waiter (they fall back to
        polling)."""
        with self._lock:
            self._closed = True
            watchers = list(self._watchers.values())
            threads = list(self._threads.values())
        for w in watchers:
            try:
                w.close()
            except Exception:  # noqa: BLE001
                pass
        for t in threads:
            t.join(timeout=2.0)
        with self._cond:
            self._cond.notify_all()
