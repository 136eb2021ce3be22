"""The port's serve pool (``torchx_tpu_torch.serve.pool``) and
``tpx-torch serve-pool`` held to the JAX package's own cases: every case of
``tests/test_serve_pool.py`` (the pure autoscaler decision, least-loaded
routing, and the deterministic resize e2e against the real local
scheduler: fake clock, synthetic probes), each run against the copy.
Added: parity with the JAX package on the same inputs (``TestJaxParity``:
both ``Autoscaler``s give the same ``desired`` sequence and both
``LeastLoadedRouter``s the same picks over one numpy-seeded load, prefix
summaries and weights included; both ``DisaggServePool``s the same
transfer config; exact); the command's replica resources (one H100 a
replica by default, none with ``--device cpu``); and the acceptance run on
the CPU (``TestPoolAcceptance``): a real port ``generate_server`` launched
through ``Runner`` + the local scheduler, whose greedy answer through the
router equals the in-process engine's, whose request stitches into one
trace across the router's and the replica's session directories, and
whose ``/metricz`` the ``Collector`` ingests.

The port's lint gate raises until the analyzer is ported, so an autouse
fixture sets ``TPX_NO_LINT=1``; every case keeps the local scheduler's
registry under ``tmp_path``, sees a card-less host, and starts with the
port's breakers and fault plan reset."""

import json
import os
import sys
import time
import urllib.request
import uuid

import numpy as np
import pytest

from torchx_tpu_torch import settings
from torchx_tpu_torch.obs import metrics as obs_metrics
from torchx_tpu_torch.obs import sinks, timeline
from torchx_tpu_torch.resilience import call as resilience_call
from torchx_tpu_torch.resilience import faults as resilience_faults
from torchx_tpu_torch.runner.api import Runner
from torchx_tpu_torch.schedulers import local_scheduler as lsched
from torchx_tpu_torch.schedulers.local_scheduler import LocalScheduler
from torchx_tpu_torch.serve.pool import (
    AutoscalePolicy,
    Autoscaler,
    LeastLoadedRouter,
    ReplicaStatus,
    ServePool,
)
from torchx_tpu_torch.specs.api import AppDef, Role
from torch_threads import xdist_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _no_lint_own_registry(tmp_path, monkeypatch):
    """The lint gate is bypassed (it raises until ROADMAP queue 1 item 2.8),
    the local scheduler's registry lives in ``tmp_path``, the host has no
    card, and the port's breakers and fault plan start clean."""
    monkeypatch.setenv(settings.ENV_TPX_NO_LINT, "1")
    monkeypatch.setattr(lsched, "_registry_path", lambda: str(tmp_path / "registry"))
    monkeypatch.delenv(settings.ENV_CUDA_VISIBLE_DEVICES, raising=False)
    monkeypatch.setattr(lsched, "driver_gpu_count", lambda: 0)
    resilience_call.reset_breakers()
    resilience_faults.reset()


class FakeClock:
    def __init__(self) -> None:
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


# -- Autoscaler: pure decision --------------------------------------------


class TestAutoscaler:
    def policy(self, **kw):
        defaults = dict(
            min_replicas=1,
            max_replicas=4,
            target_queue_depth=4.0,
            up_streak=2,
            down_streak=3,
            cooldown_s=60.0,
        )
        defaults.update(kw)
        return AutoscalePolicy(**defaults)

    def test_scale_up_needs_consecutive_breaches(self):
        a = Autoscaler(self.policy(), clock=FakeClock())
        assert a.observe(1, 10.0) == 1  # first breach: streak building
        assert a.observe(1, 10.0) == 2  # second: scale up

    def test_streak_resets_on_recovery(self):
        a = Autoscaler(self.policy(), clock=FakeClock())
        assert a.observe(1, 10.0) == 1
        assert a.observe(1, 1.5) == 1  # recovered: streak resets
        assert a.observe(1, 10.0) == 1  # back to one breach, still holding

    def test_cooldown_gates_consecutive_scales(self):
        clock = FakeClock()
        a = Autoscaler(self.policy(), clock=clock)
        a.observe(1, 10.0)
        assert a.observe(1, 10.0) == 2
        a.notify_scaled()
        # still hot, but inside cooldown: hold
        assert a.observe(2, 10.0) == 2
        assert a.observe(2, 10.0) == 2
        clock.advance(61.0)
        # cooldown over and the streak re-built during it
        assert a.observe(2, 10.0) == 3

    def test_p99_breach_scales_up_even_with_shallow_queue(self):
        a = Autoscaler(
            self.policy(target_p99_s=0.5), clock=FakeClock()
        )
        assert a.observe(1, 0.0, p99_s=2.0) == 1
        assert a.observe(1, 0.0, p99_s=2.0) == 2

    def test_scale_down_after_streak_and_not_during_p99_breach(self):
        clock = FakeClock()
        a = Autoscaler(
            self.policy(target_p99_s=0.5, down_streak=2), clock=clock
        )
        # idle queue but p99 still over SLO: never scale down
        assert a.observe(3, 0.0, p99_s=2.0) == 3
        assert a.observe(3, 0.0, p99_s=2.0) == 4  # that's a breach: UP
        a.notify_scaled()
        clock.advance(61.0)
        assert a.observe(4, 0.0, p99_s=0.1) == 4
        assert a.observe(4, 0.0, p99_s=0.1) == 3  # idle + healthy: down

    def test_bounds_respected(self):
        clock = FakeClock()
        a = Autoscaler(
            self.policy(max_replicas=2, down_streak=1), clock=clock
        )
        a.observe(2, 10.0)
        assert a.observe(2, 10.0) == 2  # at ceiling: hold
        assert a.observe(1, 0.0) == 1  # at floor: hold

    def test_policy_validation(self):
        with pytest.raises(ValueError, match="min_replicas"):
            AutoscalePolicy(min_replicas=3, max_replicas=2)
        with pytest.raises(ValueError, match="target_queue_depth"):
            AutoscalePolicy(target_queue_depth=0)
        with pytest.raises(ValueError, match="streak"):
            AutoscalePolicy(up_streak=0)


# -- LeastLoadedRouter -----------------------------------------------------


class TestRouter:
    def statuses(self, depths, healthy=None):
        healthy = healthy or [True] * len(depths)
        return [
            ReplicaStatus(
                replica_id=i, url=f"http://r{i}", healthy=h, queue_depth=d
            )
            for i, (d, h) in enumerate(zip(depths, healthy))
        ]

    def test_pick_least_loaded(self):
        r = LeastLoadedRouter()
        r.update(self.statuses([5.0, 1.0, 3.0]))
        assert r.pick().replica_id == 1

    def test_pick_skips_unhealthy(self):
        r = LeastLoadedRouter()
        r.update(self.statuses([5.0, 1.0], healthy=[True, False]))
        assert r.pick().replica_id == 0

    def test_pick_none_when_all_down(self):
        r = LeastLoadedRouter()
        r.update(self.statuses([1.0], healthy=[False]))
        assert r.pick() is None

    def test_inflight_spreads_before_probe_catches_up(self):
        # equal probed depth: our own un-acked sends must round-robin
        r = LeastLoadedRouter()
        r.update(self.statuses([0.0, 0.0]))
        first = r.pick().replica_id
        second = r.pick().replica_id
        assert {first, second} == {0, 1}
        r.record(first, 0.01)
        assert r.pick().replica_id == first  # freed slot goes first again

    def test_p99_window(self):
        r = LeastLoadedRouter(window=100)
        assert r.p99_s() is None
        for _ in range(99):
            r.record(0, 0.010)
        r.record(0, 5.0)
        assert r.p99_s() == 5.0

    def test_queue_depth_mean_over_healthy(self):
        r = LeastLoadedRouter()
        r.update(self.statuses([2.0, 4.0, 100.0], healthy=[True, True, False]))
        assert r.queue_depth() == 3.0


# -- ServePool e2e: real local scheduler, synthetic load, fake clock -------


def sleeper_app(replicas: int = 1) -> AppDef:
    return AppDef(
        name="fake-serve",
        roles=[
            Role(
                name="server",
                image="",
                entrypoint="sh",
                args=["-c", "sleep 300"],
                num_replicas=replicas,
                port_map={"http": 8000},
            )
        ],
    )


class SyntheticLoad:
    """Injectable probe: every replica healthy at the scripted depth."""

    def __init__(self) -> None:
        self.depth = 0.0

    def __call__(self, replica_id: int, url: str) -> ReplicaStatus:
        return ReplicaStatus(
            replica_id=replica_id, url=url, healthy=True, queue_depth=self.depth
        )


class TestServePoolE2E:
    @pytest.fixture
    def runner(self):
        sched = LocalScheduler(session_name="pool-test", cache_size=10)
        r = Runner("pool-test", {"local": lambda session_name, **kw: sched})
        yield r, sched
        r.close()

    def pool(self, runner, sched, clock, load, **pol):
        defaults = dict(
            min_replicas=1,
            max_replicas=3,
            target_queue_depth=4.0,
            up_streak=2,
            down_streak=2,
            cooldown_s=30.0,
        )
        defaults.update(pol)
        return ServePool(
            runner,
            sleeper_app(),
            scheduler="local",
            policy=AutoscalePolicy(**defaults),
            probe=load,
            clock=clock,
            sleep=lambda s: None,
        )

    def live_replicas(self, sched, app_id):
        return len(sched._apps[app_id].roles.get("server", []))

    def test_load_scales_up_through_ledgered_resize(self, runner):
        r, sched = runner
        clock, load = FakeClock(), SyntheticLoad()
        pool = self.pool(r, sched, clock, load)
        handle = pool.start()
        app_id = handle.rsplit("/", 1)[-1]
        try:
            before = obs_metrics.SERVE_REPLICAS.value()
            assert before == 1
            load.depth = 10.0  # queue builds
            assert pool.step() is None  # hysteresis: one breach holds
            assert pool.step() == 2  # second breach scales up
            assert pool.replicas == 2
            assert self.live_replicas(sched, app_id) == 2  # gang resized
            assert obs_metrics.SERVE_REPLICAS.value() == 2
            # the scale rode the ordinary Runner.resize ledger
            records = timeline.load_records(sinks.trace_path())
            resizes = [r_ for r_ in records if r_.get("api") == "resize"]
            assert resizes and resizes[-1]["app_id"] == app_id
            scale_spans = [
                r_
                for r_ in records
                if timeline.is_span(r_) and r_.get("name") == "serve.scale"
            ]
            assert scale_spans and scale_spans[-1]["attrs"]["direction"] == "up"
        finally:
            pool.stop()

    def test_idle_scales_down_only_after_cooldown(self, runner):
        r, sched = runner
        clock, load = FakeClock(), SyntheticLoad()
        pool = self.pool(r, sched, clock, load)
        handle = pool.start()
        app_id = handle.rsplit("/", 1)[-1]
        try:
            load.depth = 10.0
            pool.step()
            assert pool.step() == 2
            load.depth = 0.0  # load stops
            # inside cooldown: idle observations accumulate but hold
            assert pool.step() is None
            assert pool.step() is None
            assert pool.replicas == 2
            clock.advance(31.0)
            assert pool.step() == 1  # cooldown over, streak satisfied
            assert self.live_replicas(sched, app_id) == 1
            assert pool.scale_events == [(1, 2), (2, 1)]
            assert obs_metrics.SERVE_SCALE_EVENTS.value(direction="down") >= 1
        finally:
            pool.stop()

    def test_resize_error_surfaces(self, runner):
        r, sched = runner
        clock, load = FakeClock(), SyntheticLoad()
        pool = self.pool(r, sched, clock, load)
        handle = pool.start()
        r.cancel(handle)
        # wait for the gang to actually die so resize sees terminal state
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            st = r.status(handle, fresh=True)
            if st is not None and st.state.name in ("CANCELLED", "FAILED"):
                break
            time.sleep(0.05)
        load.depth = 10.0
        pool.step()
        with pytest.raises(ValueError, match="terminal"):
            pool.step()

    def test_run_loop_exits_on_terminal_app(self, runner):
        r, sched = runner
        clock, load = FakeClock(), SyntheticLoad()
        pool = self.pool(r, sched, clock, load)
        pool.start()
        pool.stop()
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            st = r.status(pool.handle, fresh=True)
            if st is not None and st.state.name in ("CANCELLED", "FAILED"):
                break
            time.sleep(0.05)
        pool.run(interval_s=0.0, iterations=50)  # returns, does not spin


class TestServePoolCli:
    def test_cli_registered_and_help(self, capsys):
        from torchx_tpu_torch.cli.main import get_sub_cmds

        assert "serve-pool" in get_sub_cmds()

    def test_replica_url_stride(self):
        pool = ServePool(
            runner=None,
            app=sleeper_app(),
            base_port=8000,
            port_stride=2,
            probe=SyntheticLoad(),
        )
        assert pool.replica_url(0) == "http://127.0.0.1:8000"
        assert pool.replica_url(3) == "http://127.0.0.1:8006"


# -- parity with the JAX package on the same inputs (exact) -----------------


def seeded_load(seed: int, steps: int = 200):
    """Per step: (queue depth, p99 seconds or None, burn rate or None,
    seconds to advance the clock)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        depth = float(rng.choice([0.0, 0.5, 2.0, 6.0, 12.0]))
        p99 = None if rng.uniform() < 0.3 else float(rng.uniform(0.05, 1.5))
        burn = None if rng.uniform() < 0.5 else float(rng.uniform(0.0, 3.0))
        out.append((depth, p99, burn, float(rng.uniform(0, 20))))
    return out


class TestJaxParity:
    def test_autoscalers_give_the_same_desired_sequence(self):
        from torchx_tpu.serve import pool as jpool

        kw = dict(min_replicas=1, max_replicas=6, target_queue_depth=4.0,
                  target_p99_s=0.5, up_streak=2, down_streak=3, cooldown_s=30.0)
        seqs = []
        for mod in (jpool, sys.modules[ServePool.__module__]):
            clock = FakeClock()
            a = mod.Autoscaler(mod.AutoscalePolicy(**kw), clock=clock)
            replicas, seq = 2, []
            for depth, p99, burn, dt in seeded_load(5):
                clock.advance(dt)
                desired = a.observe(replicas, depth, p99, burn_rate=burn)
                if desired != replicas:
                    a.notify_scaled()
                    replicas = desired
                seq.append(desired)
            seqs.append(seq)
        assert seqs[0] == seqs[1]
        assert len(set(seqs[0])) > 2  # the load moved the pool both ways

    def test_routers_make_the_same_picks(self):
        from torchx_tpu.serve import pool as jpool
        from torchx_tpu.serve.prefix_cache import prefix_chain as jchain
        from torchx_tpu_torch.serve.prefix_cache import prefix_chain

        rng = np.random.default_rng(9)
        prompts = [[int(t) for t in rng.integers(0, 1000, int(n))]
                   for n in rng.integers(1, 80, 12)]
        assert [prefix_chain(p, 8) for p in prompts] == [jchain(p, 8) for p in prompts]
        mods = (jpool, sys.modules[ServePool.__module__])
        routers = [m.LeastLoadedRouter(window=64, cache_bonus=1.5) for m in mods]
        trail = [[], []]
        for step in range(60):
            if step % 10 == 0:  # a probe sweep: depths, health and cached prefixes
                statuses = []
                for rid in range(4):
                    cached = prompts[int(rng.integers(len(prompts)))]
                    statuses.append(dict(
                        replica_id=rid, url=f"http://r{rid}", healthy=bool(rng.uniform() > 0.15),
                        queue_depth=float(rng.integers(0, 6)),
                        prefix_summary=tuple(prefix_chain(cached, 8)), block_size=8))
                for m, r in zip(mods, routers):
                    r.update([m.ReplicaStatus(**s) for s in statuses])
            tokens = prompts[int(rng.integers(len(prompts)))] if rng.uniform() < 0.7 else None
            latency = float(rng.uniform(0.01, 2.0))
            for i, r in enumerate(routers):
                picked = r.pick(tokens)
                trail[i].append(None if picked is None else picked.replica_id)
                if picked is not None and step % 3:
                    r.record(picked.replica_id, latency)
                trail[i].append((r.p99_s(), r.queue_depth(), dict(r._inflight)))
        assert trail[0] == trail[1]
        assert len({p for p in trail[0][::2] if p is not None}) > 1

    def test_disagg_pools_give_the_same_transfer_config(self):
        from torchx_tpu.serve import pool as jpool
        from torchx_tpu.specs import api as jspecs
        from torchx_tpu_torch.serve.pool import DisaggServePool
        from torchx_tpu_torch.specs import api as tspecs

        def app(specs):
            return specs.AppDef(name="d", roles=[
                specs.Role(name="prefill", image="", entrypoint="sh", num_replicas=2),
                specs.Role(name="decode", image="", entrypoint="sh", num_replicas=3)])

        got = []
        for cls, specs in ((jpool.DisaggServePool, jspecs), (DisaggServePool, tspecs)):
            p = cls(None, app(specs), decode_base_port=8100, port_stride=2,
                    probe=SyntheticLoad())
            got.append((p.transfer_config().to_spec(), p.replicas,
                        p.prefill.replica_url(1), p.decode.replica_url(2)))
        assert got[0] == got[1]
        assert got[1][0] == "http:" + ",".join(
            f"http://127.0.0.1:{8100 + 2 * i}" for i in range(3))


# -- the command: one H100 a replica unless --device cpu ------------------------


def _parse(argv):
    from torchx_tpu_torch.cli.main import create_parser

    return create_parser(only="serve-pool").parse_args(["serve-pool", *argv])


class TestServePoolResources:
    def test_each_replica_gets_one_h100_by_default(self):
        from torchx_tpu_torch.cli.cmd_serve_pool import build_app

        (role,) = build_app(_parse(["--config", "llama3_1b", "--replicas", "2"])).roles
        assert role.resource.gpu.accelerator_type == "h100-1"
        assert role.resource.gpu.gpus_per_host == 1
        assert "--device" not in role.args and role.num_replicas == 2
        assert role.args[role.args.index("--port-stride") + 1] == "1"
        app = build_app(_parse(["--config", "llama3_1b", "--disaggregate"]))
        assert [r.resource.gpu.accelerator_type for r in app.roles] == ["h100-1"] * 2

    def test_device_cpu_asks_for_no_gpu(self):
        from torchx_tpu_torch.cli.cmd_serve_pool import build_app

        for extra in ([], ["--disaggregate"]):
            app = build_app(_parse(["--config", "tiny", "--device", "cpu", *extra]))
            for role in app.roles:
                assert role.resource.gpu is None
                assert role.args[role.args.index("--device") + 1] == "cpu"

    def test_device_cpu_beside_a_gpu_is_one_error_line(self, capsys):
        from torchx_tpu_torch.cli.main import main

        with pytest.raises(SystemExit) as e:
            main(["serve-pool", "--config", "tiny", "--device", "cpu",
                  "--gpu", "h100-2", "--iterations", "1", "--router-port", "0"])
        assert e.value.code == 1
        err = capsys.readouterr().err
        assert err.startswith("error: --gpu h100-2") and "--device cpu" in err
        assert len(err.strip().splitlines()) == 1

    def test_gpu_replicas_on_a_cardless_host_are_one_error_line(self, capsys):
        from torchx_tpu_torch.cli.main import main

        with pytest.raises(SystemExit) as e:
            main(["serve-pool", "--config", "tiny", "--iterations", "1",
                  "--router-port", "0"])
        assert e.value.code == 1
        err = capsys.readouterr().err
        assert err.startswith("error: ") and "Traceback" not in err
        assert len(err.strip().splitlines()) == 1


# -- acceptance on the CPU: a real port replica through Runner + local -------


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def post(url: str, body: dict, timeout: float = 120.0):
    req = urllib.request.Request(f"{url}/v1/generate", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read()), dict(r.headers)


def wait_healthy(pool, sched, deadline_s: float = 120.0) -> bool:
    """Probe replica 0 until healthy; False when its process ended first
    (a bind refused: the caller relaunches on another port)."""
    from torchx_tpu_torch.serve.pool import http_probe

    app_id = pool.handle.rsplit("/", 1)[-1]
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        if http_probe(pool.replica_url(0), timeout=1.0).healthy:
            return True
        (replica,) = sched._apps[app_id].roles["server"]
        if replica.proc.poll() is not None:
            return False
        time.sleep(0.2)
    raise AssertionError("replica 0 never probed healthy")


def group_pids(pgid: int) -> list:
    """Live (not zombie) processes of process group ``pgid``, from /proc."""
    pids = []
    for entry in os.listdir("/proc"):
        if entry.isdigit():
            try:
                with open(f"/proc/{entry}/stat") as f:
                    fields = f.read().rsplit(")", 1)[1].split()
            except OSError:
                continue
            if int(fields[2]) == pgid and fields[0] != "Z":
                pids.append(int(entry))
    return pids


GREEDY = [5, 17, 99, 3, 250, 41, 7, 7, 88, 12, 300, 2]


class TestPoolAcceptance:
    def test_replica_serves_stitches_and_scrapes(self, tmp_path):
        from torchx_tpu_torch.apps.generate_server import GenerateService
        from torchx_tpu_torch.components.serve import generate_server
        from torchx_tpu_torch.obs import stitch
        from torchx_tpu_torch.obs import trace as obs_trace
        from torchx_tpu_torch.obs.slo import SloEngine, parse_slo
        from torchx_tpu_torch.obs.telemetry import Collector, MetricStore
        from torchx_tpu_torch.serve.pool import serve_router

        sched = LocalScheduler(session_name="pool-accept", cache_size=10)
        runner = Runner("pool-accept", {"local": lambda session_name, **kw: sched})
        router = pool = None
        try:
            for _ in range(3):  # a fresh port when another process took it first
                port = free_port()
                app = generate_server("tiny", port=port, port_stride=1, max_batch=4)
                (role,) = app.roles
                assert role.resource.gpu is None and "cpu" in role.args
                # the replica keeps an obs session of its own, as one on
                # another host would
                role.env[settings.ENV_TPX_INTERNAL_SESSION_ID] = uuid.uuid4().hex
                role.env["PYTHONPATH"] = REPO
                pool = ServePool(runner, app, cfg={"log_dir": str(tmp_path / "logs")},
                                 base_port=port, policy=AutoscalePolicy(min_replicas=1,
                                                                        max_replicas=1))
                pool.start()
                if wait_healthy(pool, sched):
                    break
                pool.stop()
            pool.step()  # the router's table from one probe sweep
            assert pool.router.queue_depth() == 0.0 and pool.scale_events == []
            router = serve_router(pool, 0)
            import threading

            threading.Thread(target=router.serve_forever, daemon=True).start()
            url = f"http://127.0.0.1:{router.server_address[1]}"
            # one request straight to the replica first: its histograms'
            # series exist from then on, so two scrapes give their deltas
            post(pool.replica_url(0), {"tokens": [[1, 2, 3]], "max_new_tokens": 2})
            # the replica's /metricz before and after the routed request
            clock = [0.0]
            store = MetricStore(clock=lambda: clock[0])
            col = Collector(store, interval_s=999, obs_dir=str(tmp_path / "no_sessions"),
                            clock=lambda: clock[0])
            col.add_target(pool.replica_url(0), name="replica-0")
            assert col.collect_once() > 0 and col.errors == {}
            reply, headers = post(url, {"tokens": [GREEDY], "max_new_tokens": 8})
            tid = headers[obs_trace.HDR_TRACE_ID]
            clock[0] = 1.0
            assert col.collect_once() > 0 and col.errors == {}

            service = GenerateService("tiny", device="cpu", max_batch=4)
            try:
                assert reply["tokens"] == service.generate([GREEDY], 8)
            finally:
                service.close()

            st = stitch.stitch(tid)
            assert st is not None and len(st.sessions) == 2 and st.span_count == 2
            (root,) = st.roots
            assert root.span.name == "serve.route" and root.span.attrs["replica"] == 0
            assert [c.span.name for c in root.children] == ["serve.unified"]
            assert os.path.dirname(sinks.trace_path()) in st.sessions

            doc = store.query("tpx_serve_ttft_seconds_count", reduce="rate", range_s=60.0)
            assert [r["value"] * 60.0 for r in doc["result"]] == [1.0]
            eng = SloEngine(store, [parse_slo("p99-ttft")], clock=lambda: clock[0])
            eng.evaluate()
            slow = float(reply["timing"]["ttft_ms"] > 500)
            short, long_ = eng.burns()["p99-ttft"]
            assert short * eng.specs[0].budget == pytest.approx(slow, abs=1e-9)
            assert short == long_
        finally:
            if router is not None:
                router.shutdown()
            if pool is not None and pool.handle is not None:
                pool.stop()
                app_id = pool.handle.rsplit("/", 1)[-1]
                deadline = time.monotonic() + 60
                while time.monotonic() < deadline:
                    st_ = runner.status(pool.handle, fresh=True)
                    if st_ is not None and st_.state.name in ("CANCELLED", "FAILED",
                                                               "SUCCEEDED"):
                        break
                    time.sleep(0.1)
                (replica,) = sched._apps[app_id].roles["server"]
                assert replica.proc.poll() is not None
                # the server under the local scheduler's /bin/sh wrapper
                # drains on SIGTERM and exits on its own: no process of the
                # replica's group outlives the stop
                deadline = time.monotonic() + 60
                while group_pids(replica.proc.pid) and time.monotonic() < deadline:
                    time.sleep(0.05)
                assert group_pids(replica.proc.pid) == []
            runner.close()

    def test_cli_serves_through_its_router(self, tmp_path):
        """``tpx-torch serve-pool --device cpu --config tiny``: the router's
        answer equals the in-process engine's, and on Ctrl-C the command
        cancels its replica and exits 0."""
        import signal
        import subprocess

        from torchx_tpu_torch.apps.generate_server import GenerateService

        base, rport = free_port(), free_port()
        env = dict(os.environ, PYTHONPATH=REPO, TPX_NO_LINT="1", HOME=str(tmp_path))
        proc = subprocess.Popen(
            [sys.executable, "-m", "torchx_tpu_torch.cli.main", "serve-pool", "--device",
             "cpu", "--config", "tiny", "--replicas", "1", "--max-batch", "4",
             "--base-port", str(base), "--router-port", str(rport), "--iterations", "2400",
             "--interval", "0.05"],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            url = f"http://127.0.0.1:{rport}"
            deadline = time.monotonic() + 90
            healthy = 0
            while time.monotonic() < deadline and proc.poll() is None:
                try:
                    with urllib.request.urlopen(f"{url}/healthz", timeout=1) as r:
                        healthy = json.loads(r.read())["healthy"]
                except OSError:
                    pass
                if healthy:
                    break
                time.sleep(0.25)
            assert healthy == 1, proc.poll()
            reply, _ = post(url, {"tokens": [GREEDY], "max_new_tokens": 8})
            service = GenerateService("tiny", device="cpu", max_batch=4)
            try:
                assert reply["tokens"] == service.generate([GREEDY], 8)
            finally:
                service.close()
            proc.send_signal(signal.SIGINT)
            out, err = proc.communicate(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        assert proc.returncode == 0, err
        assert "routing on :" in out and "interrupted; cancelling pool" in out
        from torchx_tpu_torch.serve.pool import http_probe

        # the cancel waited for the replica: nothing listens on its port
        assert not http_probe(f"http://127.0.0.1:{base}", timeout=1.0).healthy
