"""TTL-with-coalescing cache for scheduler ``describe`` responses.

Port of :mod:`torchx_tpu.runner.describe_cache`.

Every layer of the launcher polls: ``Runner.wait`` ticks, the supervisor
polls *through* ``wait``, ``tpx status`` scripts poll in loops, and log
streaming waits for the app to start. Without a cache each layer issues
its own control-plane call — duplicated gcloud/kubectl round-trips that
put the control plane back on the critical path. This cache gives every
``Runner`` three guarantees:

* **TTL sharing** — passive readers (``status``/``describe``) within
  ``TPX_DESCRIBE_CACHE_TTL`` seconds (default
  :data:`~torchx_tpu_torch.settings.DEFAULT_DESCRIBE_CACHE_TTL`) share one
  backend response.
* **Coalescing** — concurrent fetches of the same app share one in-flight
  backend call instead of stampeding the control plane.
* **Terminal pinning** — a terminal state is immutable, so it is cached
  forever and can never be stale; ``wait``/``supervise`` loops that
  re-check a finished app cost zero backend calls.

``wait()`` polls pass ``fresh=True``: they are cache *writers* (always
refresh through to the backend, modulo coalescing), so a wait loop can
never spin on a stale non-terminal entry, and fault-injection /
resilience semantics of the underlying describe seam are preserved.

Errors are never cached; mutations (``cancel``/``delete``/``resize``)
must call :meth:`DescribeCache.invalidate`.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Optional

from torchx_tpu_torch import settings
from torchx_tpu_torch.obs import metrics as obs_metrics
from torchx_tpu_torch.schedulers.api import DescribeAppResponse
from torchx_tpu_torch.specs.api import is_terminal


def cache_ttl() -> float:
    """TTL for non-terminal entries: $TPX_DESCRIBE_CACHE_TTL, else the
    default; malformed values fall back to the default, negatives clamp
    to 0 (= no caching of non-terminal states)."""
    raw = os.environ.get(settings.ENV_TPX_DESCRIBE_CACHE_TTL)
    if raw is None or not raw.strip():
        return settings.DEFAULT_DESCRIBE_CACHE_TTL
    try:
        return max(0.0, float(raw))
    except ValueError:
        return settings.DEFAULT_DESCRIBE_CACHE_TTL


class _Entry:
    __slots__ = ("resp", "at", "terminal")

    def __init__(self, resp: DescribeAppResponse, at: float, terminal: bool) -> None:
        self.resp = resp
        self.at = at
        self.terminal = terminal


class _Inflight:
    __slots__ = ("event", "resp", "error")

    def __init__(self) -> None:
        self.event = threading.Event()
        self.resp: Optional[DescribeAppResponse] = None
        self.error: Optional[BaseException] = None


class DescribeCache:
    """One instance per :class:`~torchx_tpu_torch.runner.api.Runner`; keyed by
    ``(scheduler, app_id)``. Thread-safe (the fan-out paths hit it from
    worker threads)."""

    def __init__(self, ttl: Optional[float] = None) -> None:
        # ttl=None: read the env per call, so tests / long-lived runners
        # can retune without rebuilding the Runner
        self._ttl = ttl
        self._lock = threading.Lock()
        self._entries: dict[tuple[str, str], _Entry] = {}
        self._inflight: dict[tuple[str, str], _Inflight] = {}

    def get(
        self,
        scheduler: str,
        app_id: str,
        fetch: Callable[[], Optional[DescribeAppResponse]],
        fresh: bool = False,
    ) -> Optional[DescribeAppResponse]:
        """The cached response, or ``fetch()`` routed through the cache.

        ``fresh=True`` (wait polls) bypasses the TTL — but still serves
        pinned terminal states and still coalesces onto an in-flight
        fetch (a result that just landed *is* fresh).
        """
        key = (scheduler, app_id)
        ttl = self._ttl if self._ttl is not None else cache_ttl()
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None and (
                entry.terminal
                or (not fresh and ttl > 0 and time.monotonic() - entry.at < ttl)
            ):
                obs_metrics.DESCRIBE_CACHE_HITS.inc(scheduler=scheduler)
                return entry.resp
            flight = self._inflight.get(key)
            if flight is None:
                flight = _Inflight()
                self._inflight[key] = flight
                owner = True
            else:
                owner = False
        if not owner:
            # coalesce: share the call another thread already has in flight
            flight.event.wait()
            if flight.error is not None:
                raise flight.error
            obs_metrics.DESCRIBE_CACHE_HITS.inc(scheduler=scheduler)
            return flight.resp
        obs_metrics.DESCRIBE_CACHE_MISSES.inc(scheduler=scheduler)
        try:
            resp = fetch()
        except BaseException as e:
            with self._lock:
                self._inflight.pop(key, None)
            flight.error = e  # errors are never cached
            flight.event.set()
            raise
        with self._lock:
            self._inflight.pop(key, None)
            if resp is not None:
                self._entries[key] = _Entry(
                    resp, time.monotonic(), is_terminal(resp.state)
                )
            else:
                # app no longer known to the backend: drop any stale entry
                self._entries.pop(key, None)
        flight.resp = resp
        flight.event.set()
        return resp

    def put(
        self, scheduler: str, app_id: str, resp: Optional[DescribeAppResponse]
    ) -> None:
        """Install a response a WATCH stream (reconciler) observed — the
        same writer path a completing ``get(fresh=True)`` takes: the entry
        is stamped now, terminal states are pinned forever, and ``None``
        (backend forgot the app) drops any stale entry. This is how watch
        events refresh the cache without a second cache layer."""
        with self._lock:
            if resp is None:
                self._entries.pop((scheduler, app_id), None)
                return
            self._entries[(scheduler, app_id)] = _Entry(
                resp, time.monotonic(), is_terminal(resp.state)
            )

    def invalidate(self, scheduler: str, app_id: Optional[str] = None) -> None:
        """Drop cached entries after a mutation (``cancel``/``delete``/
        ``resize``); ``app_id=None`` drops every entry for the scheduler."""
        with self._lock:
            if app_id is not None:
                self._entries.pop((scheduler, app_id), None)
            else:
                for key in [k for k in self._entries if k[0] == scheduler]:
                    del self._entries[key]
