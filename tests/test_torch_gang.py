"""The port's gang supervision (``torchx_tpu_torch.supervisor.gang`` and the
supervisor's hang detection and reshape) held to the JAX package's own
cases: every case of ``tests/test_gang.py``, each run against the copy.

The port's lint gate raises until the analyzer is ported, so an autouse
fixture sets ``TPX_NO_LINT=1``. The JAX file's acceptance scenarios, all on CPU with no sleeps longer than
the monitor deadline:

(a) a hung replica (heartbeats stop while scheduler status stays RUNNING)
    is detected within the hang deadline, classified ``FailureClass.HANG``,
    killed, and resubmitted;
(b) a checkpoint saved by a gang at ``fsdp=8`` restores onto the four
    ranks of the degraded mesh and training continues from the resumed
    step (the port's checkpointer writes each rank's blocks and restores
    any saved layout into any mesh, so the eight writers and four readers
    run here in one process, one staging name for all);
(c) a corrupt checkpoint step is quarantined on restore (content digest
    mismatch) and the run falls back to the previous verified step.

Plus unit coverage for :class:`GangMonitor` verdicts, liveness leases, the
mesh-shrink arithmetic, and the supervisor's reshape-on-resubmit flow
against a scripted scheduler. Added: parity with the JAX monitor
(``TestJaxParity``): over the same heartbeat and lease files at the same
clock both monitors give the same verdict, detail, survivors and stale
set (exact).
"""

import json
import logging
import random
import time
from types import SimpleNamespace
from typing import Mapping, Optional

import pytest

from torchx_tpu_torch.parallel.mesh_config import (
    AXES,
    MeshConfig,
    mesh_sizes_spec,
    parse_mesh_spec,
    shrink_data_axes,
)
from torchx_tpu_torch import settings
from torchx_tpu_torch.runner.api import Runner
from torchx_tpu_torch.runner.events import get_events_logger
from torchx_tpu_torch.runner.events.api import TpxEvent
from torchx_tpu_torch.schedulers.api import DescribeAppResponse, Scheduler
from torchx_tpu_torch.settings import CHECKPOINT_MANIFEST, ENV_TPX_MESH
from torchx_tpu_torch.specs.api import (
    AppDef,
    AppDryRunInfo,
    AppState,
    CfgVal,
    FailureClass,
    Role,
    runopts,
)
from torchx_tpu_torch.supervisor import Supervisor, SupervisorPolicy
from torchx_tpu_torch.supervisor.gang import (
    GangMonitor,
    GangState,
    GangVerdict,
    read_leases,
    renew_lease,
)
from torch_threads import xdist_torch_threads  # noqa: F401


@pytest.fixture(autouse=True)
def _no_lint(monkeypatch):
    """The port's lint gate raises until ROADMAP queue 1 item 2.8 brings
    the analyzer: the scripted submissions pass it."""
    monkeypatch.setenv(settings.ENV_TPX_NO_LINT, "1")


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

#: fixed "now" for deterministic monitor verdicts (epoch seconds).
NOW = 1_700_000_000.0


def heartbeat(path, replica, ts, step=-1, name="step.window"):
    """Append one heartbeat span line the way train_llama emits them."""
    rec = {
        "kind": "span",
        "name": name,
        "start_epoch_usec": int(ts * 1e6),
        "attrs": {"replica": replica, "step": step},
    }
    with open(path, "a") as f:
        f.write(json.dumps(rec) + "\n")


def monitor(trace_file, replicas=2, deadline=5.0, clock=None, **kw):
    return GangMonitor(
        expected_replicas=replicas,
        hang_deadline_s=deadline,
        trace_file=str(trace_file),
        clock=clock or (lambda: NOW),
        **kw,
    )


class ScriptedScheduler(Scheduler[dict]):
    """Each ``schedule()`` consumes the next scripted terminal outcome;
    ``describe()`` then reports that attempt as immediately terminal."""

    def __init__(self, session_name: str, script=None, **kwargs):
        super().__init__("scripted", session_name)
        self.script = list(script or [])
        self.apps: dict[str, tuple[AppState, Optional[FailureClass]]] = {}
        self.submitted_envs: list[dict[str, str]] = []
        self.cancelled: list[str] = []
        self._counter = 0

    def run_opts(self) -> runopts:
        return runopts()

    def _submit_dryrun(self, app: AppDef, cfg: Mapping[str, CfgVal]):
        return AppDryRunInfo({"app": app})

    def schedule(self, dryrun_info) -> str:
        self._counter += 1
        app_id = f"job_{self._counter}"
        outcome = (
            self.script.pop(0) if self.script else (AppState.SUCCEEDED, None)
        )
        self.apps[app_id] = outcome
        self.submitted_envs.append(dict(dryrun_info._app.roles[0].env))
        return app_id

    def describe(self, app_id: str) -> Optional[DescribeAppResponse]:
        if app_id not in self.apps:
            return None
        state, fclass = self.apps[app_id]
        return DescribeAppResponse(
            app_id=app_id, state=state, failure_class=fclass
        )

    def _cancel_existing(self, app_id: str) -> None:
        self.apps[app_id] = (AppState.CANCELLED, None)
        self.cancelled.append(app_id)


class WarmupScheduler(ScriptedScheduler):
    """Reports RUNNING for the first ``warmup_polls`` describes of each
    app before revealing its scripted outcome — models the compile/warmup
    window between submission and the first heartbeat, during which gang
    checks already run."""

    def __init__(self, session_name, script=None, warmup_polls=2, **kwargs):
        super().__init__(session_name, script=script, **kwargs)
        self.warmup_polls = warmup_polls
        self._polls: dict[str, int] = {}

    def describe(self, app_id: str) -> Optional[DescribeAppResponse]:
        resp = super().describe(app_id)
        if resp is None:
            return resp
        n = self._polls.get(app_id, 0)
        self._polls[app_id] = n + 1
        if n < self.warmup_polls and app_id not in self.cancelled:
            return DescribeAppResponse(app_id=app_id, state=AppState.RUNNING)
        return resp


def make_warmup_runner(script, warmup_polls=2):
    sched = WarmupScheduler("gang", script=script, warmup_polls=warmup_polls)
    runner = Runner("gang", {"scripted": lambda session_name, **kw: sched})
    return runner, sched


RUNNING = (AppState.RUNNING, None)
PREEMPT = (AppState.PREEMPTED, FailureClass.PREEMPTION)
APP_FAIL = (AppState.FAILED, FailureClass.APP)
OK = (AppState.SUCCEEDED, None)


class _CaptureEvents(logging.Handler):
    def __init__(self):
        super().__init__()
        self.events: list[TpxEvent] = []

    def emit(self, record: logging.LogRecord) -> None:
        msg = record.getMessage()
        if json.loads(msg).get("kind") == "span":
            return
        self.events.append(TpxEvent.deserialize(msg))


@pytest.fixture
def capture_events():
    handler = _CaptureEvents()
    logger = get_events_logger()
    logger.addHandler(handler)
    yield handler.events
    logger.removeHandler(handler)


def make_runner(script):
    sched = ScriptedScheduler("gang", script=script)
    runner = Runner("gang", {"scripted": lambda session_name, **kw: sched})
    return runner, sched


def dryrun(runner):
    app = AppDef(
        name="train",
        roles=[Role(name="trainer", image="i", entrypoint="python")],
    )
    return runner.dryrun(app, "scripted")


def gang_policy(**kwargs) -> SupervisorPolicy:
    defaults = dict(
        backoff_seconds=0.01,
        jitter=0.0,
        poll_interval=0.01,
    )
    defaults.update(kwargs)
    return SupervisorPolicy(**defaults)


def run_supervised(script, policy):
    runner, sched = make_runner(script)
    sleeps: list[float] = []
    with runner:
        result = Supervisor(
            runner,
            dryrun(runner),
            policy,
            sleep=sleeps.append,
            rng=random.Random(0),
        ).run()
    return result, sched, sleeps


# ---------------------------------------------------------------------------
# GangMonitor verdicts
# ---------------------------------------------------------------------------


class TestGangMonitor:
    def test_waiting_before_any_evidence(self, tmp_path):
        m = monitor(tmp_path / "trace.jsonl")  # file does not exist yet
        v = m.check()
        assert v.state == GangState.WAITING
        assert not v.unhealthy
        assert v.survivors == 0

    def test_healthy_with_fresh_heartbeats(self, tmp_path):
        tf = tmp_path / "trace.jsonl"
        heartbeat(tf, 0, NOW - 1.0, step=10)
        heartbeat(tf, 1, NOW - 2.0, step=10, name="job.first_step")
        v = monitor(tf).check()
        assert v.state == GangState.HEALTHY
        assert v.survivors == 2 and v.live == (0, 1) and v.lost == ()

    def test_hang_when_all_replicas_stale(self, tmp_path):
        tf = tmp_path / "trace.jsonl"
        heartbeat(tf, 0, NOW - 60.0)
        heartbeat(tf, 1, NOW - 45.0)
        v = monitor(tf).check()
        assert v.state == GangState.HANG
        assert v.unhealthy
        assert v.survivors == 0 and v.lost == (0, 1)
        assert "stale" in v.detail

    def test_partial_loss_counts_survivors(self, tmp_path):
        tf = tmp_path / "trace.jsonl"
        heartbeat(tf, 0, NOW - 1.0, step=20)
        heartbeat(tf, 1, NOW - 60.0, step=18)
        v = monitor(tf).check()
        assert v.state == GangState.PARTIAL_LOSS
        assert v.unhealthy
        assert v.live == (0,) and v.lost == (1,) and v.survivors == 1

    def test_never_seen_replica_grace_then_lost(self, tmp_path):
        """Replica 1 never produced evidence. Ordinary startup skew puts
        replicas' first flushes seconds apart, so right after arming the
        silent replica gets the hang deadline as grace (WAITING, not a
        gang-killing PARTIAL_LOSS); once the deadline passes since arming
        it counts as lost."""
        tf = tmp_path / "trace.jsonl"
        heartbeat(tf, 0, NOW - 1.0)
        clock = {"now": NOW}
        m = monitor(tf, clock=lambda: clock["now"])  # deadline 5.0
        v = m.check()
        assert v.state == GangState.WAITING
        assert not v.unhealthy
        assert v.live == (0,)
        assert "waiting for first evidence" in v.detail
        # replica 0 stays fresh; replica 1 still silent past the deadline
        clock["now"] = NOW + 6.0
        heartbeat(tf, 0, NOW + 5.5)
        v = m.check()
        assert v.state == GangState.PARTIAL_LOSS
        assert v.unhealthy
        assert v.lost == (1,) and v.live == (0,)

    def test_stale_evidence_before_floor_is_ignored(self, tmp_path):
        """A resubmitted attempt's monitor gets an evidence floor: the
        dead predecessor's heartbeats and lease files must read as "no
        evidence yet" (WAITING), not as an instant all-stale HANG while
        the new gang is still compiling."""
        tf = tmp_path / "trace.jsonl"
        heartbeat(tf, 0, NOW - 60.0, step=12)
        heartbeat(tf, 1, NOW - 45.0, step=12)
        # a leftover lease file from the dead attempt (backdate the stamp:
        # renew_lease always writes the real wall clock)
        path = renew_lease(0, step=12, session="gang-floor-test")
        rec = json.loads(open(path).read())
        rec["epoch_usec"] = int((NOW - 40.0) * 1e6)
        with open(path, "w") as f:
            f.write(json.dumps(rec))
        m = monitor(
            tf,
            session="gang-floor-test",
            ignore_evidence_before=NOW - 30.0,
        )
        v = m.check()
        assert v.state == GangState.WAITING
        assert not v.unhealthy
        assert m.replicas == {}
        # evidence stamped after the floor arms the monitor normally
        heartbeat(tf, 0, NOW - 1.0, step=13)
        heartbeat(tf, 1, NOW - 1.0, step=13)
        assert m.check().state == GangState.HEALTHY

    def test_straggler_is_warn_only(self, tmp_path):
        tf = tmp_path / "trace.jsonl"
        heartbeat(tf, 0, NOW - 1.0, step=50)
        heartbeat(tf, 1, NOW - 1.0, step=40)
        v = monitor(tf, straggler_step_lag=5).check()
        assert v.state == GangState.STRAGGLER
        assert not v.unhealthy
        assert "spread" in v.detail
        # within the lag: healthy
        heartbeat(tf, 1, NOW - 0.5, step=46)
        assert monitor(tf, straggler_step_lag=5).check().state == GangState.HEALTHY

    def test_lease_keeps_replica_alive_when_trace_stalls(self, tmp_path):
        """A renewed lease is proof of life even with stale heartbeats —
        the sidecar path for trainers that cannot emit spans."""
        tf = tmp_path / "trace.jsonl"
        now = time.time()
        heartbeat(tf, 0, now - 3600)
        renew_lease(0, step=7, session="gang-lease-test")
        m = monitor(
            tf,
            replicas=1,
            deadline=0.5,
            clock=time.time,
            lease_ttl_s=60.0,
            session="gang-lease-test",
        )
        v = m.check()
        assert v.state == GangState.HEALTHY
        assert read_leases("gang-lease-test")[0]["step"] == 7

    def test_torn_final_line_held_back_then_reread(self, tmp_path):
        tf = tmp_path / "trace.jsonl"
        heartbeat(tf, 0, NOW - 1.0)
        # writer dies (or is mid-write) after half a line
        partial = json.dumps(
            {
                "kind": "span",
                "name": "step.window",
                "start_epoch_usec": int((NOW - 1.0) * 1e6),
                "attrs": {"replica": 1},
            }
        )
        with open(tf, "a") as f:
            f.write(partial[: len(partial) // 2])
        m = monitor(tf)
        m.observe()
        assert set(m.replicas) == {0}
        # the writer finishes the line; the next observe picks it up
        with open(tf, "a") as f:
            f.write(partial[len(partial) // 2 :] + "\n")
        m.observe()
        assert set(m.replicas) == {0, 1}
        assert m.check().state == GangState.HEALTHY

    def test_validation(self, tmp_path):
        with pytest.raises(ValueError):
            GangMonitor(expected_replicas=0, hang_deadline_s=1.0)
        with pytest.raises(ValueError):
            GangMonitor(expected_replicas=1, hang_deadline_s=0.0)


# ---------------------------------------------------------------------------
# mesh-shrink arithmetic (standard library)
# ---------------------------------------------------------------------------


class TestShrinkDataAxes:
    def _sizes(self, **kw):
        base = {a: 1 for a in AXES}
        base.update(kw)
        return base

    def test_binary_step_halves_dp_first(self):
        assert shrink_data_axes(self._sizes(dp=4, fsdp=2))["dp"] == 2
        shrunk = shrink_data_axes(self._sizes(fsdp=8))
        assert shrunk["fsdp"] == 4 and shrunk["dp"] == 1

    def test_target_preserves_fsdp_extent_when_divisible(self):
        """8 -> 4 surviving devices with fsdp=4: parameter shards keep
        their size, the loss folds into dp."""
        shrunk = shrink_data_axes(self._sizes(dp=2, fsdp=4), 4)
        assert shrunk == self._sizes(dp=1, fsdp=4)

    def test_target_collapses_into_fsdp_otherwise(self):
        shrunk = shrink_data_axes(self._sizes(fsdp=8), 4)
        assert shrunk == self._sizes(dp=1, fsdp=4)
        shrunk = shrink_data_axes(self._sizes(dp=1, fsdp=8), 2)
        assert shrunk == self._sizes(dp=1, fsdp=2)

    def test_model_axes_never_shrink(self):
        sizes = self._sizes(tp=2, fsdp=4)
        shrunk = shrink_data_axes(sizes, 4)  # 8 devices -> 4
        assert shrunk["tp"] == 2 and shrunk["fsdp"] == 2
        with pytest.raises(ValueError, match="model"):
            shrink_data_axes(sizes, 1)  # cannot fit tp=2 in 1 device

    def test_unshrinkable_and_non_shrink_targets_raise(self):
        with pytest.raises(ValueError, match="no data parallelism"):
            shrink_data_axes(self._sizes())
        with pytest.raises(ValueError, match="not a shrink"):
            shrink_data_axes(self._sizes(fsdp=4), 8)

    def test_spec_round_trip(self):
        sizes = MeshConfig(fsdp=-1).resolve(8)
        spec = mesh_sizes_spec(sizes)
        assert spec == "pp=1,dp=1,fsdp=8,ep=1,tp=1,sp=1"
        assert parse_mesh_spec(spec).resolve(8) == sizes
        with pytest.raises(ValueError, match="unknown mesh axis"):
            parse_mesh_spec("dpp=2")


# ---------------------------------------------------------------------------
# acceptance (a): hang detected -> killed -> classified HANG -> resubmitted
# ---------------------------------------------------------------------------


class TestHangDetection:
    def test_hung_gang_killed_and_resubmitted(self, tmp_path, capture_events):
        """Scheduler status stays RUNNING while heartbeats are long stale:
        the monitor must flag HANG within the deadline, the supervisor
        kills the attempt, classifies it HANG, and the resubmission
        succeeds — all in well under a second of wall time."""
        tf = tmp_path / "trace.jsonl"
        heartbeat(tf, 0, time.time() - 60.0, step=12)

        runner, sched = make_runner([RUNNING, OK])
        deadline = 1.0
        policy = gang_policy(
            hang_deadline_seconds=deadline,
            gang_check_interval=0.05,
            poll_interval=0.05,
            max_hang_retries=1,
        )
        with runner:
            sup = Supervisor(
                runner,
                dryrun(runner),
                policy,
                sleep=time.sleep,  # Runner.wait timeouts use real time
                rng=random.Random(0),
            )
            sup.monitor_factory = lambda **kw: GangMonitor(
                trace_file=str(tf), **kw
            )
            t0 = time.monotonic()
            result = sup.run()
            elapsed = time.monotonic() - t0

        assert result.succeeded
        assert result.attempts == 2
        assert result.retries[FailureClass.HANG] == 1
        assert result.budget_exhausted is None
        # the supervisor itself killed the wedged attempt
        assert sched.cancelled == ["job_1"]
        # detected within the configured deadline (not via a long sleep)
        assert elapsed < deadline
        sup_events = [e for e in capture_events if e.api == "supervise"]
        by_transition = {
            e.app_metadata["transition"]: e.app_metadata for e in sup_events
        }
        assert by_transition["gang_hang"]["survivors"] == 0
        assert by_transition["gang_hang"]["expected"] == 1
        assert by_transition["gang_hang"]["lost"] == [0]
        assert by_transition["resubmitting"]["failure_class"] == "HANG"

    def test_hang_budget_exhaustion(self, tmp_path):
        tf = tmp_path / "trace.jsonl"
        heartbeat(tf, 0, time.time() - 60.0)
        runner, sched = make_runner([RUNNING, RUNNING])
        policy = gang_policy(
            hang_deadline_seconds=0.5,
            gang_check_interval=0.05,
            poll_interval=0.05,
            max_hang_retries=1,
        )

        def factory(**kw):
            # every attempt hangs for real: the resubmitted gang emits one
            # heartbeat (past the attempt's evidence floor) and then
            # wedges, going stale within the deadline
            if kw.get("ignore_evidence_before"):
                heartbeat(tf, 0, time.time())
            return GangMonitor(trace_file=str(tf), **kw)

        with runner:
            sup = Supervisor(
                runner, dryrun(runner), policy,
                sleep=time.sleep, rng=random.Random(0),
            )
            sup.monitor_factory = factory
            result = sup.run()
        assert not result.succeeded
        assert result.budget_exhausted == FailureClass.HANG
        assert result.retries[FailureClass.HANG] == 1
        assert sched.cancelled == ["job_1", "job_2"]
        assert result.status.failure_class == FailureClass.HANG
        assert "gang HANG" in result.status.msg

    def test_resubmitted_attempt_survives_stale_evidence(self, tmp_path):
        """Regression: the resubmitted attempt's fresh monitor tails the
        SAME session trace and lease files. Attempt 1's stale heartbeats
        must not arm attempt 2's monitor (instant HANG during warmup,
        before attempt 2's first heartbeat) — the evidence floor set at
        resubmission filters them, so attempt 2 warms up under WAITING
        and runs to completion."""
        tf = tmp_path / "trace.jsonl"
        heartbeat(tf, 0, time.time() - 60.0, step=12)

        # attempt 1 hangs; attempt 2 spends several polls "warming up"
        # (RUNNING, no heartbeat yet) before succeeding — exactly the
        # window where stale evidence used to kill it
        runner, sched = make_warmup_runner([RUNNING, OK], warmup_polls=3)
        policy = gang_policy(
            hang_deadline_seconds=1.0,
            gang_check_interval=0.05,
            poll_interval=0.05,
            max_hang_retries=1,
        )
        with runner:
            sup = Supervisor(
                runner, dryrun(runner), policy,
                sleep=time.sleep, rng=random.Random(0),
            )
            sup.monitor_factory = lambda **kw: GangMonitor(
                trace_file=str(tf), **kw
            )
            result = sup.run()
        assert result.succeeded
        assert result.attempts == 2
        assert result.budget_exhausted is None
        # only the genuinely hung first attempt was killed
        assert sched.cancelled == ["job_1"]

    def test_healthy_gang_runs_to_completion(self, tmp_path):
        """Fresh heartbeats must never trip the monitor: an attempt that
        finishes normally under gang watch stays a single attempt."""
        tf = tmp_path / "trace.jsonl"
        heartbeat(tf, 0, time.time(), step=1)
        runner, sched = make_runner([OK])
        policy = gang_policy(
            hang_deadline_seconds=30.0,
            gang_check_interval=0.05,
            poll_interval=0.05,
        )
        with runner:
            sup = Supervisor(
                runner, dryrun(runner), policy,
                sleep=time.sleep, rng=random.Random(0),
            )
            sup.monitor_factory = lambda **kw: GangMonitor(
                trace_file=str(tf), **kw
            )
            result = sup.run()
        assert result.succeeded
        assert result.attempts == 1
        assert sched.cancelled == []


# ---------------------------------------------------------------------------
# elastic reshape on resubmit (scripted scheduler)
# ---------------------------------------------------------------------------


class TestElasticReshape:
    def test_preemption_resubmits_on_shrunken_mesh(self, tmp_path):
        result, sched, _ = run_supervised(
            [PREEMPT, OK],
            gang_policy(
                max_preemptions=2,
                elastic_reshape=True,
                mesh="fsdp=-1",
                devices_per_replica=8,
            ),
        )
        assert result.succeeded and result.attempts == 2
        # launch attempt runs the flag-given mesh; the resubmit overrides
        assert ENV_TPX_MESH not in sched.submitted_envs[0]
        assert (
            sched.submitted_envs[1][ENV_TPX_MESH]
            == "pp=1,dp=1,fsdp=4,ep=1,tp=1,sp=1"
        )

    def test_repeated_preemptions_keep_degrading(self):
        result, sched, _ = run_supervised(
            [PREEMPT, PREEMPT, OK],
            gang_policy(
                max_preemptions=3,
                elastic_reshape=True,
                mesh="fsdp=-1",
                devices_per_replica=8,
            ),
        )
        assert result.succeeded and result.attempts == 3
        assert sched.submitted_envs[1][ENV_TPX_MESH].endswith("fsdp=4,ep=1,tp=1,sp=1")
        assert sched.submitted_envs[2][ENV_TPX_MESH].endswith("fsdp=2,ep=1,tp=1,sp=1")

    def test_unshrinkable_mesh_resubmits_at_same_shape(self):
        result, sched, _ = run_supervised(
            [PREEMPT, OK],
            gang_policy(
                max_preemptions=2,
                elastic_reshape=True,
                mesh="fsdp=-1",
                devices_per_replica=1,
            ),
        )
        assert result.succeeded
        assert (
            sched.submitted_envs[1][ENV_TPX_MESH]
            == "pp=1,dp=1,fsdp=1,ep=1,tp=1,sp=1"
        )

    def test_app_failures_never_reshape(self):
        result, sched, _ = run_supervised(
            [APP_FAIL, OK],
            gang_policy(
                max_app_retries=1,
                elastic_reshape=True,
                mesh="fsdp=-1",
                devices_per_replica=8,
            ),
        )
        assert result.succeeded
        assert ENV_TPX_MESH not in sched.submitted_envs[1]

    def test_gang_verdict_targets_surviving_capacity(self):
        """With a verdict the shrink is a refit to survivors x devices,
        not a blind halving."""
        runner, _ = make_runner([])
        with runner:
            sup = Supervisor(
                runner,
                dryrun(runner),
                gang_policy(
                    elastic_reshape=True, mesh="fsdp=8", devices_per_replica=2
                ),
                sleep=lambda s: None,
            )
            sup._last_verdict = GangVerdict(
                state=GangState.PARTIAL_LOSS,
                detail="3 lost",
                expected=4,
                live=(0,),
                lost=(1, 2, 3),
            )
            sup._maybe_reshape(FailureClass.HANG)
        assert sup._mesh_spec == "pp=1,dp=1,fsdp=2,ep=1,tp=1,sp=1"
        # the verdict is consumed: a later plain preemption halves instead
        assert sup._last_verdict is None

    def test_full_healthy_gang_grows_back_to_launch_mesh(self):
        """Blind preemption halving must not ratchet a healthy job toward
        dp=1: once the monitor saw the full gang live on the degraded
        shape, a verdict-less preemption restores the launch mesh (a
        reschedule is a fresh allocation at the requested size)."""
        runner, _ = make_runner([])
        with runner:
            sup = Supervisor(
                runner,
                dryrun(runner),
                gang_policy(
                    elastic_reshape=True, mesh="fsdp=-1", devices_per_replica=8
                ),
                sleep=lambda s: None,
            )
            degraded = parse_mesh_spec("dp=1,fsdp=4,pp=1,ep=1,tp=1,sp=1")
            sup._current_mesh = {a: getattr(degraded, a) for a in AXES}
            sup._mesh_spec = mesh_sizes_spec(sup._current_mesh)
            sup._gang_was_full = True
            sup._maybe_reshape(FailureClass.PREEMPTION)
        assert sup._mesh_spec == "pp=1,dp=1,fsdp=8,ep=1,tp=1,sp=1"

    def test_preemption_after_healthy_gang_keeps_launch_mesh(self, tmp_path):
        """At the launch shape with a demonstrably whole gang, a plain
        preemption resubmits unchanged — no TPX_MESH override, no blind
        shrink (end to end: healthy verdict observed by the monitor during
        attempt 1, preemption, resubmit)."""
        tf = tmp_path / "trace.jsonl"
        heartbeat(tf, 0, time.time(), step=5)
        runner, sched = make_warmup_runner([PREEMPT, OK], warmup_polls=2)
        policy = gang_policy(
            max_preemptions=2,
            elastic_reshape=True,
            mesh="fsdp=-1",
            devices_per_replica=8,
            hang_deadline_seconds=30.0,
            gang_check_interval=0.05,
            poll_interval=0.05,
        )
        with runner:
            sup = Supervisor(
                runner, dryrun(runner), policy,
                sleep=time.sleep, rng=random.Random(0),
            )
            sup.monitor_factory = lambda **kw: GangMonitor(
                trace_file=str(tf), **kw
            )
            result = sup.run()
        assert result.succeeded and result.attempts == 2
        assert sched.cancelled == []
        assert ENV_TPX_MESH not in sched.submitted_envs[1]

    def test_elastic_reshape_requires_mesh(self):
        with pytest.raises(ValueError, match="mesh"):
            SupervisorPolicy(elastic_reshape=True)

    def test_resume_replays_reshaped_mesh(self):
        """A supervise client that crashes after a reshape must resume onto
        the degraded shape, not the launch one (replayed from the attempt
        ledger's ``submitted`` entries)."""
        runner, sched = make_runner([PREEMPT, OK])
        policy = gang_policy(
            max_preemptions=2,
            elastic_reshape=True,
            mesh="fsdp=-1",
            devices_per_replica=8,
        )
        with runner:
            result = Supervisor(
                runner,
                dryrun(runner),
                policy,
                sleep=lambda s: None,
                rng=random.Random(0),
                session="gang-resume",
            ).run()
            assert result.succeeded
            sup2 = Supervisor.resume(runner, "gang-resume")
        assert sup2._mesh_spec == "pp=1,dp=1,fsdp=4,ep=1,tp=1,sp=1"
        assert sup2._current_mesh["fsdp"] == 4
        assert sup2._policy.elastic_reshape  # policy round-tripped via meta
        # the reattached monitor must not ingest earlier attempts' stale
        # evidence: the floor is the reattached attempt's submission time
        assert sup2._evidence_floor > 0


# ---------------------------------------------------------------------------
# in-job liveness lease helper (train_llama)
# ---------------------------------------------------------------------------


class TestLivenessLeaseHelper:
    def test_first_step_lease_written_when_step_unknown(self):
        """Regression: ``_renew_liveness_lease(None)`` used to die on
        ``int(None)`` inside its broad except — silently skipping the
        first-step lease exactly when lease evidence matters most (before
        ``step.window`` heartbeats start). None must degrade to the
        'step unknown' sentinel, not to no lease at all."""
        from torchx_tpu_torch.examples.train_llama import _renew_liveness_lease

        _renew_liveness_lease(None)
        leases = read_leases()
        assert leases, "lease must be written even with no step known"
        assert all(rec["step"] == -1 for rec in leases.values())


# ---------------------------------------------------------------------------
# acceptance (b): a save at fsdp=8 -> a restore at fsdp=4
# ---------------------------------------------------------------------------


class TestCrossMeshRestore:
    def test_8_device_save_restores_onto_4_device_mesh(self, tmp_path, monkeypatch):
        import torch

        from torchx_tpu_torch import distributed
        from torchx_tpu_torch.parallel.checkpoint import Checkpointer
        from torchx_tpu_torch.parallel.mesh import shard_extent

        # one staging name for the eight writers, as rank 0's broadcast
        # over the gang's group gives it
        monkeypatch.setattr(distributed, "broadcast_from_zero", lambda obj: "gang8")
        specs = {"w": ("fsdp", None)}
        whole = torch.arange(64.0).reshape(8, 8)

        def rank(sizes, r):  # noqa: ANN001, ANN202
            return SimpleNamespace(sizes=sizes,
                                   coords={a: (r if a == "fsdp" else 0) for a in AXES})

        sizes8 = MeshConfig(fsdp=-1).resolve(8)
        writers = [Checkpointer(str(tmp_path), mesh=rank(sizes8, r), specs=specs)
                   for r in range(8)]
        try:
            for r, ckpt in enumerate(writers):
                block = whole[shard_extent(specs["w"], (8, 8), sizes8, rank(sizes8, r).coords)]
                state = {"w": block.clone(), "step": torch.tensor(3, dtype=torch.int32)}
                assert ckpt.save(3, state, force=True)
            for ckpt in writers:
                ckpt.wait()
        finally:
            for ckpt in writers:
                ckpt.close()

        # the degraded shape the supervisor would compute for 8 -> 4
        shrunk = shrink_data_axes(MeshConfig(fsdp=-1).resolve(8), 4)
        sizes4 = parse_mesh_spec(mesh_sizes_spec(shrunk)).resolve(4)
        blocks = []
        for r in range(4):
            reader = Checkpointer(str(tmp_path), read_only=True, mesh=rank(sizes4, r),
                                  specs=specs)
            try:
                step, restored = reader.restore_latest()
            finally:
                reader.close()
            assert step == 3
            # the state now lives on the 4-rank mesh: two rows a rank...
            assert tuple(restored["w"].shape) == (2, 8)
            assert int(restored["step"]) == 3
            # ...and training continues: an update step runs on it
            stepped = {"w": restored["w"] * 0.5, "step": restored["step"] + 1}
            assert int(stepped["step"]) == 4
            blocks.append(stepped["w"])
        assert torch.equal(torch.cat(blocks), whole * 0.5)
        assert float(blocks[0][0, 2]) == 1.0


# ---------------------------------------------------------------------------
# acceptance (c): digest-verified restore quarantines corrupt steps
# ---------------------------------------------------------------------------


class TestDigestVerification:
    def test_corrupt_step_quarantined_and_fallback(self, tmp_path):
        import torch

        from torchx_tpu_torch.parallel.checkpoint import Checkpointer

        ckpt = Checkpointer(str(tmp_path), async_save=False)
        ckpt.save(1, {"w": torch.full((4,), 1.0)})
        ckpt.save(2, {"w": torch.full((4,), 2.0)})
        ckpt.wait()
        ckpt.close()
        manifest = json.loads((tmp_path / CHECKPOINT_MANIFEST).read_text())
        assert manifest["latest_step"] == 2
        assert set(manifest["steps"]) == {"1", "2"}

        # silent corruption: APPEND junk — the payload may still
        # deserialize without an exception, so only the digest catches it
        step2 = tmp_path / "2"
        victim = next(p for p in sorted(step2.rglob("*")) if p.is_file())
        victim.write_bytes(victim.read_bytes() + b"\x00 corrupted")

        ckpt2 = Checkpointer(str(tmp_path))
        try:
            assert ckpt2.verify_step(2) is False
            assert ckpt2.verify_step(1) is True
            live = {"w": torch.zeros(4)}
            step, restored = ckpt2.restore_latest(into=live)
            assert step == 1
            assert float(restored["w"][0]) == 1.0
            # quarantined aside as evidence, never deleted
            assert any(".corrupt" in p.name for p in tmp_path.iterdir())
            # manifest repaired: the client-side supervisor must not inject
            # the quarantined step as the next TPX_RESUME_STEP
            manifest = json.loads((tmp_path / CHECKPOINT_MANIFEST).read_text())
            assert manifest["latest_step"] == 1
            assert "2" not in manifest["steps"]
        finally:
            ckpt2.close()

    def test_undigested_steps_restore_as_before(self, tmp_path):
        """Checkpoints from before the digest table (manifest has no steps
        entry) must restore unverified rather than be treated as corrupt."""
        import torch

        from torchx_tpu_torch.parallel.checkpoint import Checkpointer

        ckpt = Checkpointer(str(tmp_path), async_save=False)
        ckpt.save(5, {"w": torch.full((4,), 5.0)})
        ckpt.wait()
        ckpt.close()
        # simulate a pre-digest manifest
        (tmp_path / CHECKPOINT_MANIFEST).write_text(
            json.dumps({"latest_step": 5})
        )
        ckpt2 = Checkpointer(str(tmp_path))
        try:
            assert ckpt2.verify_step(5) is None
            step, restored = ckpt2.restore_latest(into={"w": torch.zeros(4)})
        finally:
            ckpt2.close()
        assert step == 5
        assert float(restored["w"][0]) == 5.0


# ---------------------------------------------------------------------------
# parity with the JAX monitor on the same files at the same clock (exact)
# ---------------------------------------------------------------------------


def lease(session, replica, ts, step=-1):  # noqa: ANN001, ANN201
    """A lease of ``replica`` stamped ``ts`` (epoch seconds), in the
    layout both packages read (written by the port's :func:`renew_lease`,
    then backdated: it always stamps the wall clock)."""
    path = renew_lease(replica, step=step, session=session)
    rec = json.loads(open(path).read())
    rec["epoch_usec"] = int(ts * 1e6)
    with open(path, "w") as f:
        f.write(json.dumps(rec))


def _verdict(v):  # noqa: ANN001, ANN202
    return (str(v.state), v.detail, v.expected, v.live, v.lost, v.survivors, v.unhealthy)


SCENARIOS = {
    # name -> (monitor kwargs, [(clock offset, writes before the check)])
    "healthy": ({}, [(0.0, [("hb", 0, -1.0, 10), ("hb", 1, -2.0, 10)])]),
    "hang": ({}, [(0.0, [("hb", 0, -60.0, -1), ("hb", 1, -45.0, -1)])]),
    "partial_loss": ({}, [(0.0, [("hb", 0, -1.0, 20), ("hb", 1, -60.0, 18)])]),
    "grace_then_lost": ({}, [(0.0, [("hb", 0, -1.0, -1)]),
                             (6.0, [("hb", 0, 5.5, -1)])]),
    "straggler": ({"straggler_step_lag": 5},
                  [(0.0, [("hb", 0, -1.0, 50), ("hb", 1, -1.0, 40)]),
                   (0.0, [("hb", 1, -0.5, 46)])]),
    "lease_keeps_alive": ({"replicas": 1, "deadline": 0.5, "lease_ttl_s": 60.0},
                          [(0.0, [("hb", 0, -3600.0, -1), ("lease", 0, -1.0, 7)])]),
    "floor": ({"ignore_evidence_before": -30.0},
              [(0.0, [("hb", 0, -60.0, 12), ("hb", 1, -45.0, 12), ("lease", 0, -40.0, 12)]),
               (0.0, [("hb", 0, -1.0, 13), ("hb", 1, -1.0, 13)])]),
    "all_stale_leases": ({"lease_ttl_s": 10.0},
                         [(0.0, [("lease", 0, -20.0, 3), ("lease", 1, -5.0, 3)]),
                          (30.0, [])]),
}


class TestJaxParity:
    @pytest.mark.parametrize("name", sorted(SCENARIOS))
    def test_same_verdicts_as_the_jax_monitor(self, tmp_path, name):
        from torchx_tpu.supervisor.gang import GangMonitor as JGangMonitor

        kwargs, checks = SCENARIOS[name]
        kwargs = dict(kwargs)
        replicas = kwargs.pop("replicas", 2)
        deadline = kwargs.pop("deadline", 5.0)
        if "ignore_evidence_before" in kwargs:
            kwargs["ignore_evidence_before"] += NOW
        tf = tmp_path / "trace.jsonl"
        session = f"gang-parity-{name}"
        clock = {"now": NOW}
        monitors = [
            cls(expected_replicas=replicas, hang_deadline_s=deadline, trace_file=str(tf),
                session=session, clock=lambda: clock["now"], **kwargs)
            for cls in (GangMonitor, JGangMonitor)
        ]
        seen = []
        for offset, writes in checks:
            for kind, replica, ts, step in writes:
                if kind == "hb":
                    heartbeat(tf, replica, NOW + ts, step=step)
                else:
                    lease(session, replica, NOW + ts, step=step)
            clock["now"] = NOW + offset
            mine, theirs = (_verdict(m.check()) for m in monitors)
            assert mine == theirs
            seen.append(mine[0])
        assert {r: vars(h) for r, h in monitors[0].replicas.items()} == \
            {r: vars(h) for r, h in monitors[1].replicas.items()}
        assert seen  # every scenario checked at least once
