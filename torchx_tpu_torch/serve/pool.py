"""Launcher-driven autoscaling serve pool (``tpx-torch serve-pool``).

Port of :mod:`torchx_tpu.serve.pool`, the controller half of the serving
runtime: submit N ``generate_server`` replicas (the port's, one H100 each
unless the AppDef asks for the CPU) as ONE role through the
:class:`~torchx_tpu_torch.runner.api.Runner`,
probe each replica's ``/healthz`` for queue depth, and autoscale the role
via :meth:`Runner.resize` — so every scale event rides the same ledger
(``log_event("resize", ...)``), describe-cache invalidation, and gang
restart semantics every other ``tpx`` verb uses. Serving is just another
job to the launcher; there is no second control plane.

Three pieces, smallest surface first:

* :class:`Autoscaler` — the pure decision function. ``observe(replicas,
  queue_depth, p99_s) -> desired`` with hysteresis (consecutive-breach
  streaks) and a post-scale cooldown on an injectable clock, so tests
  drive it deterministically with a fake clock and synthetic load.
* :class:`LeastLoadedRouter` — client-side routing state: pick the
  replica with the lowest cache-aware score (in-flight + last probed
  queue depth, minus a longest-cached-prefix bonus computed from the
  replica's probed prefix summary), record request latencies for the
  p99 the autoscaler consumes. The HTTP proxy front-end
  (:func:`serve_router`) is a thin wrapper over it.
* :class:`ServePool` — mechanism. Owns the app handle, runs the
  probe -> autoscale -> resize loop, exports ``tpx_serve_replicas`` /
  ``tpx_serve_scale_events_total`` and ``serve.pool.*`` spans.
* :class:`DisaggServePool` — disaggregated mechanism: ONE app whose
  AppDef carries a prefill role and a decode role, each driven by its
  own :class:`ServePool` controller (independent
  :class:`AutoscalePolicy`s, one ``Runner.resize`` per role) over a
  shared handle; :meth:`DisaggServePool.transfer_config` derives the
  prefill->decode
  :class:`~torchx_tpu_torch.serve.kv_transfer.TransferConfig` from the
  decode gang's current replica URLs.

Standard library only: importing the pool loads neither torch nor the
engine; the replicas are processes of their own.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Optional, Sequence

from torchx_tpu_torch.obs import metrics as obs_metrics
from torchx_tpu_torch.obs import trace as obs_trace
from torchx_tpu_torch.serve.kv_transfer import TransferConfig
from torchx_tpu_torch.serve.prefix_cache import prefix_chain

logger = logging.getLogger(__name__)

__all__ = [
    "AutoscalePolicy",
    "Autoscaler",
    "ReplicaStatus",
    "LeastLoadedRouter",
    "ServePool",
    "DisaggServePool",
    "serve_router",
    "http_probe",
]


# =========================================================================
# Policy: the pure scaling decision
# =========================================================================


@dataclasses.dataclass(frozen=True)
class AutoscalePolicy:
    """Targets and damping for :class:`Autoscaler`.

    ``target_queue_depth`` is *per replica*: scale up when the mean probed
    queue depth breaches it (or TTFT p99 breaches ``target_p99_s``) for
    ``up_streak`` consecutive observations; scale down when depth falls
    under ``down_fraction`` of target AND no p99 breach for
    ``down_streak`` observations. ``cooldown_s`` gates both directions
    after any resize so a gang restart can't trigger a flapping loop.
    """

    min_replicas: int = 1
    max_replicas: int = 4
    target_queue_depth: float = 4.0
    target_p99_s: Optional[float] = None
    up_streak: int = 2
    down_streak: int = 6
    down_fraction: float = 0.25
    cooldown_s: float = 60.0

    def __post_init__(self) -> None:
        if not (0 < self.min_replicas <= self.max_replicas):
            raise ValueError(
                f"0 < min_replicas <= max_replicas violated: "
                f"{self.min_replicas}..{self.max_replicas}"
            )
        if self.target_queue_depth <= 0:
            raise ValueError("target_queue_depth must be > 0")
        if self.up_streak < 1 or self.down_streak < 1:
            raise ValueError("streaks must be >= 1")


class Autoscaler:
    """Hysteresis + cooldown around :class:`AutoscalePolicy`.

    Pure apart from the injected ``clock``: call :meth:`observe` once per
    control interval with what the probes saw; it returns the desired
    replica count (== current means hold). The caller performs the actual
    resize and MUST call :meth:`notify_scaled` when it does, which starts
    the cooldown and resets both streaks.
    """

    def __init__(
        self,
        policy: AutoscalePolicy,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.policy = policy
        self._clock = clock
        self._up = 0
        self._down = 0
        self._last_scale_t: Optional[float] = None

    def _in_cooldown(self) -> bool:
        return (
            self._last_scale_t is not None
            and self._clock() - self._last_scale_t < self.policy.cooldown_s
        )

    def observe(
        self,
        replicas: int,
        queue_depth: float,
        p99_s: Optional[float] = None,
        burn_rate: Optional[float] = None,
    ) -> int:
        """One control observation -> desired replica count.

        ``queue_depth`` is the mean per-replica depth across healthy
        replicas; ``p99_s`` the recent TTFT p99 (None = no latency signal,
        depth alone decides). ``burn_rate`` is the optional SLO signal
        (the engine's worst long-window burn): at >= 1.0 the error budget
        is burning faster than sustainable, which counts as hot and
        vetoes scale-down — the pool must not shrink its way deeper into
        a burning SLO even when the queue looks calm.
        """
        p = self.policy
        burning = burn_rate is not None and burn_rate >= 1.0
        hot = (
            burning
            or queue_depth > p.target_queue_depth
            or (
                p.target_p99_s is not None
                and p99_s is not None
                and p99_s > p.target_p99_s
            )
        )
        cold = (
            not burning
            and queue_depth < p.target_queue_depth * p.down_fraction
            and not (
                p.target_p99_s is not None
                and p99_s is not None
                and p99_s > p.target_p99_s
            )
        )
        self._up = self._up + 1 if hot else 0
        self._down = self._down + 1 if cold else 0
        if self._in_cooldown():
            return replicas
        if hot and self._up >= p.up_streak and replicas < p.max_replicas:
            return replicas + 1
        if cold and self._down >= p.down_streak and replicas > p.min_replicas:
            return replicas - 1
        return replicas

    def notify_scaled(self) -> None:
        """The caller resized: start cooldown, reset hysteresis."""
        self._last_scale_t = self._clock()
        self._up = 0
        self._down = 0


# =========================================================================
# Router: least-loaded pick + latency accounting
# =========================================================================


@dataclasses.dataclass
class ReplicaStatus:
    """What one probe observed about one replica.

    ``prefix_summary`` is the replica engine's published set of cached
    prefix-chain digests (hex, recency-ordered; see
    :func:`torchx_tpu_torch.serve.prefix_cache.prefix_chain`) and
    ``block_size`` the paged-cache granularity those digests were chained
    at — together they let the router score a prompt's
    longest-cached-prefix without shipping token ids in probes."""

    replica_id: int
    url: str
    healthy: bool
    queue_depth: float = 0.0
    prefix_summary: tuple[str, ...] = ()
    block_size: int = 16


def http_probe(url: str, timeout: float = 2.0) -> ReplicaStatus:
    """Default probe: GET ``<url>/healthz`` and read the engine's queue
    depth (the continuous engine merges ``queue_depth`` into healthz; a
    draining or unreachable replica probes unhealthy and takes no new
    traffic) plus its prefix-cache summary for cache-aware routing."""
    rid = -1
    try:
        with urllib.request.urlopen(f"{url}/healthz", timeout=timeout) as r:
            body = json.loads(r.read().decode())
        return ReplicaStatus(
            replica_id=rid,
            url=url,
            healthy=body.get("status") == "ok",
            queue_depth=float(body.get("queue_depth", 0.0)),
            prefix_summary=tuple(body.get("prefix_summary", ())),
            block_size=int(body.get("block_size", 16) or 16),
        )
    except (urllib.error.URLError, OSError, ValueError, json.JSONDecodeError):
        return ReplicaStatus(replica_id=rid, url=url, healthy=False)


class LeastLoadedRouter:
    """Cache-aware routing state over the pool's current replica set.

    :meth:`pick` returns the healthy replica with the lowest score:
    load (in-flight requests this router has outstanding + the last
    probed queue depth — the probe sees load from *other* clients, the
    in-flight count sees our own before the probe catches up) minus
    ``cache_bonus`` per prompt block the replica already holds in its
    prefix cache. The match is computed entirely from probe data: the
    prompt's positional chain digests (:func:`prefix_chain`) intersected
    against each replica's published summary — the deepest digest both
    sides share IS the longest cached prefix, because chain digests
    commit to the whole path. :meth:`record` feeds a bounded latency
    window from which :meth:`p99_s` serves the autoscaler's SLO signal.
    """

    def __init__(self, window: int = 512, cache_bonus: float = 1.0) -> None:
        self._lock = threading.Lock()
        self._replicas: dict[int, ReplicaStatus] = {}
        self._inflight: dict[int, int] = {}
        self._latencies: list[float] = []
        self._window = window
        self.cache_bonus = cache_bonus
        # rollout state lives OUTSIDE the probe-replaced table: a drain
        # mark or canary weight must take effect on the very next pick(),
        # not after the next probe sweep rebuilds _replicas
        self._draining: set[int] = set()
        self._weights: dict[int, float] = {}

    def update(self, statuses: list[ReplicaStatus]) -> None:
        """Replace the routing table with the latest probe sweep (drain
        marks and canary weights survive — they are rollout state, not
        probe state)."""
        with self._lock:
            self._replicas = {s.replica_id: s for s in statuses}
            self._inflight = {
                rid: self._inflight.get(rid, 0) for rid in self._replicas
            }

    def mark_draining(self, replica_id: int) -> None:
        """Exclude ``replica_id`` from :meth:`pick` immediately — the
        first step of a checkpoint rollout, effective before any probe
        notices the replica going away."""
        with self._lock:
            self._draining.add(replica_id)

    def clear_draining(self, replica_id: int) -> None:
        """Readmit ``replica_id`` to the pick set (rollout finished)."""
        with self._lock:
            self._draining.discard(replica_id)

    def set_weight(self, replica_id: int, weight: float) -> None:
        """Traffic weight for ``replica_id`` (default 1.0). The promotion
        controller weights the canary cohort's share of the split; higher
        weight attracts proportionally more traffic."""
        with self._lock:
            if weight == 1.0:
                self._weights.pop(replica_id, None)
            else:
                self._weights[replica_id] = max(1e-6, float(weight))

    def inflight(self, replica_id: int) -> int:
        """Requests this router routed to ``replica_id`` that have not
        :meth:`record`-ed back yet — the rollout seam drains on it."""
        with self._lock:
            return self._inflight.get(replica_id, 0)

    def prefix_blocks(
        self, status: ReplicaStatus, tokens: Sequence[int]
    ) -> int:
        """How many leading blocks of ``tokens`` replica ``status`` has
        cached: the deepest chain digest present in its summary."""
        if not tokens or not status.prefix_summary:
            return 0
        chain = prefix_chain(tokens, status.block_size)
        have = set(status.prefix_summary)
        matched = 0
        for depth, digest in enumerate(chain, start=1):
            if digest in have:
                matched = depth
        return matched

    def pick(
        self, tokens: Optional[Sequence[int]] = None
    ) -> Optional[ReplicaStatus]:
        """Best healthy replica for this prompt (None when none are
        healthy); bumps its in-flight count — pair with :meth:`record`.
        With ``tokens`` the score subtracts the longest-cached-prefix
        bonus; without, it degrades to plain least-loaded. Draining
        replicas are excluded outright; weights divide the load score
        (weight 2 looks half as loaded, weight 0.5 twice as loaded)."""
        with self._lock:
            healthy = [
                s
                for s in self._replicas.values()
                if s.healthy and s.replica_id not in self._draining
            ]
            if not healthy:
                return None
            def _score(s: ReplicaStatus) -> tuple[float, int]:
                load = (
                    self._inflight.get(s.replica_id, 0)
                    + s.queue_depth
                    - (
                        self.cache_bonus * self.prefix_blocks(s, tokens)
                        if tokens is not None
                        else 0.0
                    )
                )
                w = self._weights.get(s.replica_id, 1.0)
                # weight scales attractiveness on both sides of zero: a
                # heavier replica looks less loaded (or more cache-ahead)
                return (load / w if load >= 0 else load * w, s.replica_id)

            best = min(healthy, key=_score)
            self._inflight[best.replica_id] = (
                self._inflight.get(best.replica_id, 0) + 1
            )
            return best

    def record(self, replica_id: int, latency_s: float) -> None:
        """Request to ``replica_id`` finished after ``latency_s``."""
        with self._lock:
            if self._inflight.get(replica_id, 0) > 0:
                self._inflight[replica_id] -= 1
            self._latencies.append(latency_s)
            if len(self._latencies) > self._window:
                del self._latencies[: -self._window]

    def p99_s(self) -> Optional[float]:
        """p99 of the recent latency window (None until any data)."""
        with self._lock:
            if not self._latencies:
                return None
            xs = sorted(self._latencies)
            return xs[min(len(xs) - 1, int(0.99 * len(xs)))]

    def queue_depth(self) -> float:
        """Mean probed depth across healthy replicas (0 when none)."""
        with self._lock:
            healthy = [s for s in self._replicas.values() if s.healthy]
            if not healthy:
                return 0.0
            return sum(s.queue_depth for s in healthy) / len(healthy)


# =========================================================================
# Pool: runner-backed mechanism
# =========================================================================


class ServePool:
    """Probe -> autoscale -> ``Runner.resize`` control loop over one app.

    The pool owns nothing the launcher doesn't already model: replicas are
    the role's gang, scaling is :meth:`Runner.resize` (ledgered, cache
    invalidating, gang-coherent), teardown is :meth:`Runner.cancel`.
    ``probe`` and ``sleep`` are injectable so the e2e test drives the loop
    deterministically against a synthetic workload.
    """

    def __init__(
        self,
        runner: Any,
        app: Any,
        *,
        scheduler: str = "local",
        cfg: Optional[dict] = None,
        role_name: str = "server",
        base_port: int = 8000,
        port_stride: int = 1,
        policy: Optional[AutoscalePolicy] = None,
        probe: Optional[Callable[[int, str], ReplicaStatus]] = None,
        router: Optional[LeastLoadedRouter] = None,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
    ) -> None:
        self._runner = runner
        self._app = app
        self._scheduler = scheduler
        self._cfg = cfg or {}
        self._role_name = role_name
        self._base_port = base_port
        self._port_stride = port_stride
        self.policy = policy or AutoscalePolicy()
        self._probe = probe or self._http_probe
        self.router = router or LeastLoadedRouter()
        self._clock = clock
        self._sleep = sleep
        self.autoscaler = Autoscaler(self.policy, clock=clock)
        self.handle: Optional[str] = None
        self._replicas = next(
            (r.num_replicas for r in app.roles if r.name == role_name),
            1,
        )
        self.scale_events: list[tuple[int, int]] = []  # (from, to)

    # -- lifecycle --------------------------------------------------------

    def start(self) -> str:
        """Submit the app; returns (and retains) its handle."""
        with obs_trace.span(
            "serve.pool.start", app=self._app.name, scheduler=self._scheduler
        ):
            self.handle = self._runner.run(
                self._app, self._scheduler, self._cfg
            )
        obs_metrics.SERVE_REPLICAS.set(self._replicas)
        logger.info(
            "serve pool up: %s with %d replica(s)", self.handle, self._replicas
        )
        return self.handle

    def stop(self) -> None:
        """Cancel the app (replicas drain via their SIGTERM handlers)."""
        if self.handle is not None:
            self._runner.cancel(self.handle)

    @property
    def replicas(self) -> int:
        """Current target replica count."""
        return self._replicas

    def replica_url(self, replica_id: int) -> str:
        """Where replica ``replica_id`` listens (port-stride convention
        shared with ``components.serve.generate_server``)."""
        return f"http://127.0.0.1:{self._base_port + self._port_stride * replica_id}"

    # -- checkpoint rollout ------------------------------------------------

    def rollout_replica(
        self,
        replica_id: int,
        ckpt: str,
        *,
        drain_timeout_s: float = 30.0,
        health_timeout_s: float = 30.0,
        poll_s: float = 0.05,
    ) -> bool:
        """Roll ONE replica onto a new checkpoint: drain → health-confirm,
        the restart between them left to the backend (out of band, as the
        JAX pool does without its ``restart=`` actuator, which comes back
        with its caller: ROADMAP item 2.8). This is the promotion
        controller's only seam into the pool — it never touches replica
        handles directly.

        The replica is marked draining on the router first, so it leaves
        the traffic split on the very next ``pick()``; the health check
        only starts once every request the router had in flight to it has
        :meth:`LeastLoadedRouter.record`-ed back (zero dropped requests).
        Returns True once the replica probes healthy again (and rejoins
        the split), False on drain/health timeout — the caller treats
        False as a failed rollout and rolls back.
        """
        with obs_trace.span(
            "serve.rollout", replica=str(replica_id), ckpt=ckpt
        ):
            self.router.mark_draining(replica_id)
            try:
                deadline = self._clock() + drain_timeout_s
                while self.router.inflight(replica_id) > 0:
                    if self._clock() >= deadline:
                        logger.warning(
                            "replica %d did not drain within %.1fs",
                            replica_id,
                            drain_timeout_s,
                        )
                        return False
                    self._sleep(poll_s)
                deadline = self._clock() + health_timeout_s
                while True:
                    st = self._probe(replica_id, self.replica_url(replica_id))
                    if st.healthy:
                        return True
                    if self._clock() >= deadline:
                        logger.warning(
                            "replica %d not healthy %.1fs after rollout",
                            replica_id,
                            health_timeout_s,
                        )
                        return False
                    self._sleep(poll_s)
            finally:
                self.router.clear_draining(replica_id)

    # -- control loop -----------------------------------------------------

    def _http_probe(self, replica_id: int, url: str) -> ReplicaStatus:
        st = http_probe(url)
        st.replica_id = replica_id
        return st

    def probe_all(self) -> list[ReplicaStatus]:
        """Probe every replica in the current target set."""
        out = []
        for rid in range(self._replicas):
            st = self._probe(rid, self.replica_url(rid))
            st.replica_id = rid
            out.append(st)
        return out

    def step(self) -> Optional[int]:
        """One control iteration: probe, decide, maybe resize.

        Returns the new replica count when a resize happened, else None.
        A resize that the backend refuses (e.g. terminal app) surfaces —
        the loop in :meth:`run` stops on it, the caller decides.
        """
        with obs_trace.span("serve.pool.step", handle=self.handle or ""):
            statuses = self.probe_all()
            self.router.update(statuses)
            depth = self.router.queue_depth()
            p99 = self.router.p99_s()
            obs_metrics.SERVE_QUEUE_DEPTH.set(depth)
            desired = self.autoscaler.observe(self._replicas, depth, p99)
            if desired == self._replicas:
                return None
            return self._resize(desired)

    def _resize(self, desired: int) -> int:
        direction = "up" if desired > self._replicas else "down"
        with obs_trace.span(
            "serve.scale",
            handle=self.handle or "",
            direction=direction,
            to=str(desired),
        ):
            if self.handle is not None:
                self._runner.resize(self.handle, self._role_name, desired)
            self.scale_events.append((self._replicas, desired))
            logger.warning(
                "serve pool scaled %s: %d -> %d replicas",
                direction,
                self._replicas,
                desired,
            )
            self._replicas = desired
            self.autoscaler.notify_scaled()
            obs_metrics.SERVE_REPLICAS.set(desired)
            obs_metrics.SERVE_SCALE_EVENTS.inc(direction=direction)
        return desired

    def run(
        self,
        interval_s: float = 10.0,
        iterations: Optional[int] = None,
        stop_event: Optional[threading.Event] = None,
    ) -> None:
        """The controller loop: step every ``interval_s`` until the app
        terminates, ``iterations`` are spent, or ``stop_event`` fires."""
        done = 0
        while iterations is None or done < iterations:
            if stop_event is not None and stop_event.is_set():
                return
            if self._app_terminal():
                return
            self.step()
            done += 1
            self._sleep(interval_s)

    def _app_terminal(self) -> bool:
        """True when the pool's app reached a terminal state (a status
        poll)."""
        if self.handle is None:
            return False
        status = self._runner.status(self.handle)
        if status is not None and status.state is not None:
            from torchx_tpu_torch.specs.api import is_terminal

            if is_terminal(status.state):
                logger.warning(
                    "serve pool app reached %s; controller exiting",
                    status.state.name,
                )
                return True
        return False


# =========================================================================
# Disaggregated pool: prefill gang + decode gang, one app
# =========================================================================


class DisaggServePool:
    """Two-gang controller for disaggregated serving.

    ONE app (the :func:`torchx_tpu_torch.components.serve.generate_server_disagg`
    AppDef) carries a prefill role and a decode role; each gets its own
    :class:`ServePool` controller — independent
    :class:`AutoscalePolicy`s, separate probe sweeps and routers, one
    ``Runner.resize`` per role — sharing a single submitted handle, so
    every scale event on either gang still rides the launcher's ledger.

    The prefill gang is compute-bound (chunked prefill, prefix-cache
    warm) and scales on queue depth / TTFT p99; the decode gang is
    HBM-bandwidth-bound and scales on its own occupancy signal. Client
    traffic routes to the *prefill* gang (cache-aware);
    :meth:`transfer_config` hands prefill replicas the decode gang's
    current URLs as an ``http:`` transfer spec for the KV handoff.
    """

    def __init__(
        self,
        runner: Any,
        app: Any,
        *,
        scheduler: str = "local",
        cfg: Optional[dict] = None,
        prefill_role: str = "prefill",
        decode_role: str = "decode",
        prefill_policy: Optional[AutoscalePolicy] = None,
        decode_policy: Optional[AutoscalePolicy] = None,
        prefill_base_port: int = 8000,
        decode_base_port: int = 8100,
        port_stride: int = 1,
        probe: Optional[Callable[[int, str], ReplicaStatus]] = None,
        router: Optional[LeastLoadedRouter] = None,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
    ) -> None:
        self._runner = runner
        self._app = app
        self._scheduler = scheduler
        self._cfg = cfg or {}
        self.prefill = ServePool(
            runner,
            app,
            scheduler=scheduler,
            cfg=cfg,
            role_name=prefill_role,
            base_port=prefill_base_port,
            port_stride=port_stride,
            policy=prefill_policy or AutoscalePolicy(),
            probe=probe,
            router=router or LeastLoadedRouter(),
            clock=clock,
            sleep=sleep,
        )
        self.decode = ServePool(
            runner,
            app,
            scheduler=scheduler,
            cfg=cfg,
            role_name=decode_role,
            base_port=decode_base_port,
            port_stride=port_stride,
            policy=decode_policy or AutoscalePolicy(),
            probe=probe,
            router=LeastLoadedRouter(),
            clock=clock,
            sleep=sleep,
        )
        self.handle: Optional[str] = None

    # client traffic enters through the prefill gang: serve_router() and
    # callers treat a DisaggServePool like a ServePool via these two
    @property
    def router(self) -> LeastLoadedRouter:
        """The prefill gang's router — where client traffic enters."""
        return self.prefill.router

    @property
    def replicas(self) -> int:
        """Total replicas across both gangs (the SERVE_REPLICAS gauge)."""
        return self.prefill.replicas + self.decode.replicas

    def start(self) -> str:
        """Submit the two-role app ONCE; both controllers share the
        handle (their resizes address their own role by name)."""
        self.handle = self.prefill.start()
        self.decode.handle = self.handle
        obs_metrics.SERVE_REPLICAS.set(self.replicas)
        return self.handle

    def stop(self) -> None:
        """Cancel the shared two-role app (both gangs go down together)."""
        if self.handle is not None:
            self._runner.cancel(self.handle)

    def transfer_config(self) -> TransferConfig:
        """The prefill->decode transfer path as of the current decode
        gang size — refresh after decode-side scale events."""
        return TransferConfig(
            mode="http",
            endpoints=tuple(
                self.decode.replica_url(rid)
                for rid in range(self.decode.replicas)
            ),
        )

    def step(self) -> tuple[Optional[int], Optional[int]]:
        """One control iteration per gang; returns (prefill, decode) new
        replica counts (None where that gang held)."""
        out = (self.prefill.step(), self.decode.step())
        obs_metrics.SERVE_REPLICAS.set(self.replicas)
        return out

    def run(
        self,
        interval_s: float = 10.0,
        iterations: Optional[int] = None,
        stop_event: Optional[threading.Event] = None,
    ) -> None:
        """Interleaved controller loop over both gangs (same exit
        conditions as :meth:`ServePool.run`)."""
        done = 0
        while iterations is None or done < iterations:
            if stop_event is not None and stop_event.is_set():
                return
            if self.prefill._app_terminal():
                return
            self.step()
            done += 1
            self.prefill._sleep(interval_s)


# =========================================================================
# HTTP router front-end
# =========================================================================


def _make_router_handler(pool: ServePool) -> type:
    router = pool.router

    class Handler(BaseHTTPRequestHandler):
        # one pool-level entry point; replicas keep their own /healthz
        def log_message(self, fmt: str, *args: Any) -> None:
            logger.debug("router: " + fmt, *args)

        def _reply(self, code: int, body: dict) -> None:
            data = json.dumps(body).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self) -> None:
            if self.path == "/healthz":
                statuses = pool.router._replicas  # snapshot for status page
                self._reply(
                    200,
                    {
                        "status": "ok",
                        "replicas": pool.replicas,
                        "healthy": sum(
                            1 for s in statuses.values() if s.healthy
                        ),
                        "queue_depth": router.queue_depth(),
                        "p99_s": router.p99_s(),
                    },
                )
            elif self.path == "/metricz":
                # the router process's registry (routing counters, pool
                # gauges) in proper exposition format — a scrape target
                # for the control daemon's telemetry collector
                text = obs_metrics.REGISTRY.render().encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(text)))
                self.end_headers()
                self.wfile.write(text)
            else:
                self._reply(404, {"error": f"no route {self.path}"})

        def do_POST(self) -> None:
            if self.path != "/v1/generate":
                self._reply(404, {"error": f"no route {self.path}"})
                return
            length = int(self.headers.get("Content-Length", 0))
            payload = self.rfile.read(length)
            # best-effort prompt extraction for the cache-aware score: an
            # unparseable body still routes (least-loaded) and the replica
            # produces the authoritative 400
            tokens = None
            try:
                req = json.loads(payload or b"{}")
                if "tokens" in req and req["tokens"]:
                    tokens = list(req["tokens"][0])
                elif isinstance(req.get("text"), str):
                    tokens = list(req["text"].encode("utf-8"))
                elif isinstance(req.get("text"), list) and req["text"]:
                    tokens = list(req["text"][0].encode("utf-8"))
            except (ValueError, TypeError, KeyError, IndexError):
                tokens = None
            # adopt the caller's trace (or start one) and forward the
            # context to the replica, so router + replica + KV transfer
            # + decode stitch into one timeline per request
            in_tid, in_sid = obs_trace.extract_headers(self.headers)
            with obs_trace.trace_context(in_tid, in_sid):
                with obs_trace.span("serve.route") as sp:
                    trace_id = sp.trace_id if sp is not None else in_tid
                    target = router.pick(tokens)
                    if target is None:
                        self._reply(503, {"error": "no healthy replicas"})
                        return
                    if sp is not None:
                        sp.attrs["replica"] = target.replica_id
                    t0 = time.perf_counter()
                    try:
                        req = urllib.request.Request(
                            f"{target.url}{self.path}",
                            data=payload,
                            headers=obs_trace.inject_headers(
                                {"Content-Type": "application/json"}
                            ),
                        )
                        with urllib.request.urlopen(req, timeout=600) as r:
                            body = r.read()
                            code = r.status
                    except urllib.error.HTTPError as e:
                        body = e.read()
                        code = e.code
                    except (urllib.error.URLError, OSError) as e:
                        self._reply(
                            502,
                            {"error": f"replica {target.replica_id}: {e}"},
                        )
                        router.record(
                            target.replica_id, time.perf_counter() - t0
                        )
                        return
                    router.record(target.replica_id, time.perf_counter() - t0)
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if trace_id:
                # callers (and tests) learn which trace to stitch
                self.send_header(obs_trace.HDR_TRACE_ID, trace_id)
            self.end_headers()
            self.wfile.write(body)

    return Handler


def serve_router(pool: ServePool, port: int = 0) -> ThreadingHTTPServer:
    """Start the least-loaded HTTP proxy for ``pool`` (port 0 = ephemeral;
    read the bound port off ``server.server_address``). Caller runs
    ``serve_forever`` (typically on a daemon thread next to the control
    loop)."""
    server = ThreadingHTTPServer(("", port), _make_router_handler(pool))
    return server
