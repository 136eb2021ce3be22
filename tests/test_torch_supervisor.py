"""The port's supervisor (``torchx_tpu_torch.supervisor``) held to the JAX
supervisor's own cases: every case of ``tests/test_supervisor.py`` and
``tests/test_resilience.py``'s ``TestAttemptLedger``, ``TestSupervisorResume``
and ``TestAcceptance``, each run against the copy (the SIGKILLed client's
child runs with the repo on ``PYTHONPATH``). Added: parity with the JAX
package on the same inputs (``TestJaxParity``: each package's ledger reads
the other's session entry for entry; both ``latest_checkpoint_step`` agree
on a directory the port's ``Checkpointer`` wrote, on the JAX digit and
pickle layouts and on a corrupt manifest; ``supervisor_policy_to_dict``
gives one dict; the two ``Supervisor`` loops driven by one scripted
scheduler emit the same transitions, failure classes, retries, backoff
delays and resume steps; all exact), and the acceptance run on the CPU
(``TestSupervisedGang``): ``tpx-torch supervise`` runs ``dist.spmd -j 1x2``
of the port's trainer on the local scheduler, attempt 1 is SIGKILLed after
a committed step, and attempt 2 resumes from it, its losses bitwise an
uninterrupted run's.

The port's lint gate raises until the analyzer is ported, so an autouse
fixture sets ``TPX_NO_LINT=1``; every case keeps the local scheduler's
registry under ``tmp_path``, sees a card-less host, and starts with the
port's breakers and fault plan reset."""

import json
import logging
import os
import random
import signal
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest

import torch_gang_cases as gang
from torchx_tpu_torch import settings
from torchx_tpu_torch.obs import metrics as obs_metrics
from torchx_tpu_torch.obs import trace as obs_trace
from torchx_tpu_torch.resilience import CallPolicy
from torchx_tpu_torch.resilience import call as resilience_call
from torchx_tpu_torch.resilience import faults as resilience_faults
from torchx_tpu_torch.runner.api import Runner
from torchx_tpu_torch.runner.events import get_events_logger
from torchx_tpu_torch.runner.events.api import TpxEvent
from torchx_tpu_torch.schedulers import api as sched_api
from torchx_tpu_torch.schedulers import local_scheduler as lsched
from torchx_tpu_torch.settings import CHECKPOINT_MANIFEST, ENV_TPX_RESUME_STEP
from torchx_tpu_torch.specs import api as specs_api
from torchx_tpu_torch.specs.api import (
    AppDef,
    AppDryRunInfo,
    AppState,
    AppStatus,
    FailureClass,
    Role,
)
from torchx_tpu_torch.specs.serialize import (
    supervisor_policy_from_dict,
    supervisor_policy_to_dict,
)
from torchx_tpu_torch.supervisor import (
    AttemptLedger,
    Supervisor,
    SupervisorPolicy,
    latest_checkpoint_step,
    list_sessions,
)
from torch_threads import xdist_torch_threads  # noqa: F401

REPO_ROOT = Path(__file__).resolve().parents[1]


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


def fast_call_policy(**kwargs) -> CallPolicy:
    defaults = dict(backoff_seconds=0.0, jitter=0.0)
    defaults.update(kwargs)
    return CallPolicy(**defaults)


def scripted_scheduler(sched_mod, specs_mod):  # noqa: ANN001, ANN201
    """The scripted scheduler over one package's scheduler and spec APIs:
    each ``schedule()`` consumes the next scripted terminal outcome;
    ``describe()`` then reports that attempt as immediately terminal."""

    class ScriptedScheduler(sched_mod.Scheduler):
        def __init__(self, session_name: str, script=None, **kwargs):
            super().__init__("scripted", session_name)
            self.script = list(script or [])
            self.apps: dict = {}
            self.submitted_envs: list[dict[str, str]] = []
            self._counter = 0

        def run_opts(self):  # noqa: ANN201
            return specs_mod.runopts()

        def _submit_dryrun(self, app, cfg):  # noqa: ANN001, ANN202
            return specs_mod.AppDryRunInfo({"app": app})

        def schedule(self, dryrun_info) -> str:  # noqa: ANN001
            self._counter += 1
            app_id = f"job_{self._counter}"
            outcome = (
                self.script.pop(0) if self.script
                else (specs_mod.AppState.SUCCEEDED, None)
            )
            self.apps[app_id] = outcome
            self.submitted_envs.append(dict(dryrun_info._app.roles[0].env))
            return app_id

        def describe(self, app_id: str):  # noqa: ANN201
            if app_id not in self.apps:
                return None
            state, fclass = self.apps[app_id]
            return sched_mod.DescribeAppResponse(
                app_id=app_id, state=state, failure_class=fclass
            )

        def _cancel_existing(self, app_id: str) -> None:
            self.apps[app_id] = (specs_mod.AppState.CANCELLED, None)

    return ScriptedScheduler


ScriptedScheduler = scripted_scheduler(sched_api, specs_api)


class _CaptureEvents(logging.Handler):
    def __init__(self):
        super().__init__()
        self.events: list[TpxEvent] = []
        self.spans: list[dict] = []

    def emit(self, record: logging.LogRecord) -> None:
        msg = record.getMessage()
        obj = json.loads(msg)
        if obj.get("kind") == "span":
            self.spans.append(obj)
        else:
            self.events.append(TpxEvent.deserialize(msg))


@pytest.fixture
def capture_pipeline():
    """Events from the port's events logger and spans from its span
    logger (the port keeps spans on a logger of their own)."""
    handler = _CaptureEvents()
    loggers = (get_events_logger(), obs_trace.SPAN_LOGGER)
    for lg in loggers:
        lg.addHandler(handler)
    yield handler
    for lg in loggers:
        lg.removeHandler(handler)


@pytest.fixture
def capture_events(capture_pipeline):
    return capture_pipeline.events


def make_runner(script=None):
    sched = ScriptedScheduler("sup", script=script)
    runner = Runner("sup", {"scripted": lambda session_name, **kw: sched})
    return runner, sched


def dryrun(runner):
    app = AppDef(
        name="train",
        roles=[Role(name="trainer", image="i", entrypoint="python")],
    )
    return runner.dryrun(app, "scripted")


def fast_policy(**kwargs) -> SupervisorPolicy:
    defaults = dict(
        backoff_seconds=1.0,
        backoff_factor=2.0,
        jitter=0.0,
        poll_interval=0.01,
    )
    defaults.update(kwargs)
    return SupervisorPolicy(**defaults)


def run_supervised(script, policy):
    runner, sched = make_runner(script)
    sleeps: list[float] = []
    with runner:
        sup = Supervisor(
            runner,
            dryrun(runner),
            policy,
            sleep=sleeps.append,
            rng=random.Random(0),
        )
        result = sup.run()
    return result, sched, sleeps


PREEMPT = (AppState.PREEMPTED, FailureClass.PREEMPTION)
APP_FAIL = (AppState.FAILED, FailureClass.APP)
INFRA_FAIL = (AppState.FAILED, FailureClass.INFRA)
OK = (AppState.SUCCEEDED, None)


# =========================================================================
# tests/test_supervisor.py
# =========================================================================


class TestSupervisorLoop:
    def test_preempted_twice_then_succeeds(self, tmp_path, capture_events):
        """The acceptance scenario: two spot reclaims, each resubmitted
        with backoff and checkpoint resume, then success within budget."""
        ckpt = tmp_path / "ckpt"
        ckpt.mkdir()
        (ckpt / CHECKPOINT_MANIFEST).write_text(json.dumps({"latest_step": 120}))

        result, sched, sleeps = run_supervised(
            [PREEMPT, PREEMPT, OK],
            fast_policy(max_preemptions=3, checkpoint_dir=str(ckpt)),
        )

        assert result.succeeded
        assert result.attempts == 3
        assert result.budget_exhausted is None
        assert result.retries[FailureClass.PREEMPTION] == 2
        assert result.retries[FailureClass.APP] == 0
        assert result.handles == [
            "scripted://sup/job_1",
            "scripted://sup/job_2",
            "scripted://sup/job_3",
        ]
        # first attempt starts fresh; every resubmit resumes from step 120
        assert ENV_TPX_RESUME_STEP not in sched.submitted_envs[0]
        assert sched.submitted_envs[1][ENV_TPX_RESUME_STEP] == "120"
        assert sched.submitted_envs[2][ENV_TPX_RESUME_STEP] == "120"
        assert result.resume_steps == [None, 120, 120]
        # capped exponential backoff: 1s then 2s (jitter=0)
        assert sleeps == [1.0, 2.0]

    def test_each_transition_emits_event(self, tmp_path, capture_events):
        result, _, _ = run_supervised(
            [PREEMPT, OK], fast_policy(max_preemptions=1)
        )
        assert result.succeeded
        sup_events = [e for e in capture_events if e.api == "supervise"]
        transitions = [e.app_metadata["transition"] for e in sup_events]
        assert transitions == ["submitted", "resubmitting", "submitted", "finished"]
        resub = sup_events[1]
        assert resub.app_metadata["failure_class"] == "PREEMPTION"
        assert resub.app_metadata["retry"] == 1
        assert resub.scheduler == "scripted"
        assert resub.app_id == "job_1"

    def test_preemption_budget_exhaustion(self):
        result, _, sleeps = run_supervised(
            [PREEMPT, PREEMPT, PREEMPT], fast_policy(max_preemptions=2)
        )
        assert not result.succeeded
        assert result.attempts == 3
        assert result.budget_exhausted == FailureClass.PREEMPTION
        assert result.retries[FailureClass.PREEMPTION] == 2
        assert result.status.state == AppState.PREEMPTED
        assert len(sleeps) == 2  # no backoff after the budget is spent

    def test_fatal_app_error_stays_failed(self):
        """Default policy: app bugs are deterministic; zero resubmits."""
        result, sched, sleeps = run_supervised([APP_FAIL], fast_policy())
        assert not result.succeeded
        assert result.attempts == 1
        assert result.budget_exhausted == FailureClass.APP
        assert result.status.state == AppState.FAILED
        assert result.status.failure_class == FailureClass.APP
        assert sleeps == []
        assert len(sched.submitted_envs) == 1

    def test_budgets_are_independent(self):
        """Preemptions must not eat the infra budget and vice versa."""
        result, _, _ = run_supervised(
            [PREEMPT, INFRA_FAIL, PREEMPT, INFRA_FAIL, OK],
            fast_policy(max_preemptions=2, max_infra_retries=2),
        )
        assert result.succeeded
        assert result.attempts == 5
        assert result.retries[FailureClass.PREEMPTION] == 2
        assert result.retries[FailureClass.INFRA] == 2

    def test_unclassified_failure_defaults_to_app(self):
        result, _, _ = run_supervised(
            [(AppState.FAILED, None)], fast_policy(max_app_retries=0)
        )
        assert result.budget_exhausted == FailureClass.APP

    def test_cancelled_app_is_not_retried(self):
        result, sched, _ = run_supervised(
            [(AppState.CANCELLED, None)], fast_policy(max_preemptions=5)
        )
        assert not result.succeeded
        assert result.attempts == 1
        assert result.status.state == AppState.CANCELLED

    def test_vanished_app_stops_the_loop(self):
        """A scheduler that forgot the app (expired/deleted) must halt the
        supervisor — resubmitting blind could double-run the job."""
        runner, sched = make_runner([PREEMPT])
        sched.describe = lambda app_id: None  # type: ignore[method-assign]
        with runner:
            result = Supervisor(
                runner, dryrun(runner), fast_policy(), sleep=lambda s: None
            ).run()
        assert result.status is None
        assert result.attempts == 1
        assert not result.succeeded

    def test_runner_supervise_wrapper(self, capture_events):
        runner, sched = make_runner([PREEMPT, OK])
        with runner:
            result = runner.supervise(
                dryrun(runner),
                fast_policy(max_preemptions=1, backoff_seconds=0.01),
            )
        assert result.succeeded
        top = [
            e
            for e in capture_events
            if e.api == "supervise"
            and e.app_metadata
            and "attempts" in e.app_metadata
        ]
        assert top and top[-1].app_metadata["attempts"] == 2

    def test_rejects_raw_dryrun_info(self):
        runner, _ = make_runner([])
        with runner, pytest.raises(ValueError, match="cannot resubmit"):
            Supervisor(runner, AppDryRunInfo({"raw": True}))


class TestPolicy:
    def test_budget_for(self):
        p = SupervisorPolicy(
            max_preemptions=7, max_infra_retries=2, max_app_retries=1
        )
        assert p.budget_for(FailureClass.PREEMPTION) == 7
        assert p.budget_for(FailureClass.INFRA) == 2
        assert p.budget_for(FailureClass.APP) == 1

    def test_backoff_caps_and_grows(self):
        p = SupervisorPolicy(
            backoff_seconds=5, backoff_factor=2, backoff_max_seconds=30, jitter=0
        )
        assert [p.backoff_delay(n) for n in range(1, 6)] == [5, 10, 20, 30, 30]

    def test_jitter_bounds(self):
        p = SupervisorPolicy(backoff_seconds=10, jitter=0.1)
        rng = random.Random(7)
        for n in range(1, 5):
            base = min(10 * 2 ** (n - 1), p.backoff_max_seconds)
            assert base * 0.9 <= p.backoff_delay(n, rng) <= base * 1.1

    def test_validation(self):
        with pytest.raises(ValueError):
            SupervisorPolicy(max_preemptions=-1)
        with pytest.raises(ValueError):
            SupervisorPolicy(backoff_factor=0.5)
        with pytest.raises(ValueError):
            SupervisorPolicy(jitter=1.5)
        with pytest.raises(ValueError):
            SupervisorPolicy(poll_interval=0)

    def test_serialization_round_trip(self):
        p = SupervisorPolicy(
            max_preemptions=5, checkpoint_dir="/ckpt", elastic=True
        )
        d = json.loads(json.dumps(supervisor_policy_to_dict(p)))
        assert supervisor_policy_from_dict(d) == p

    def test_unknown_policy_key_raises(self):
        with pytest.raises(ValueError, match="unknown supervisor policy keys"):
            supervisor_policy_from_dict({"max_preemption": 3})


class TestCheckpointManifest:
    def test_manifest_wins(self, tmp_path):
        (tmp_path / "40").mkdir()
        (tmp_path / CHECKPOINT_MANIFEST).write_text(
            json.dumps({"latest_step": 55})
        )
        assert latest_checkpoint_step(str(tmp_path)) == 55

    def test_fallback_scans_orbax_and_pickle_layouts(self, tmp_path):
        assert latest_checkpoint_step(str(tmp_path)) is None
        (tmp_path / "40").mkdir()
        (tmp_path / "step_30.pkl").write_bytes(b"")
        (tmp_path / "50.corrupt").mkdir()  # quarantined: never a candidate
        assert latest_checkpoint_step(str(tmp_path)) == 40

    def test_corrupt_manifest_falls_back(self, tmp_path):
        (tmp_path / CHECKPOINT_MANIFEST).write_text("{not json")
        (tmp_path / "step_7.pkl").write_bytes(b"")
        assert latest_checkpoint_step(str(tmp_path)) == 7

    def test_missing_directory(self, tmp_path):
        assert latest_checkpoint_step(str(tmp_path / "nope")) is None


class TestWaitTimeout:
    def test_wait_times_out(self):
        runner, sched = make_runner([])
        with runner:
            app_id = sched.schedule(dryrun(runner))
            sched.apps[app_id] = (AppState.RUNNING, None)
            handle = f"scripted://sup/{app_id}"
            with pytest.raises(TimeoutError, match="still"):
                runner.wait(handle, wait_interval=0.01, timeout=0.05)

    def test_wait_returns_before_timeout(self):
        runner, sched = make_runner([OK])
        with runner:
            handle = runner.schedule(dryrun(runner))
            status = runner.wait(handle, wait_interval=0.01, timeout=5)
        assert status.state == AppState.SUCCEEDED


class TestStatusShowsFailureClass:
    def test_status_format_names_the_class(self):
        runner, sched = make_runner([PREEMPT])
        with runner:
            handle = runner.schedule(dryrun(runner))
            status = runner.status(handle)
        assert status.failure_class == FailureClass.PREEMPTION
        assert "PREEMPTED (preemption)" in status.format()
        assert "PREEMPTED (preemption)" in str(status)

    def test_plain_states_unchanged(self):
        assert "SUCCEEDED (" not in AppStatus(state=AppState.SUCCEEDED).format()


class TestLedgerCrashSafety:
    """The client can die at ANY byte of a ledger write; resume must see
    exactly the transitions that completed — never a torn line, never a
    half-replaced meta.json."""

    def test_torn_final_line_skipped_and_restore_replays_complete_lines(self):
        from torchx_tpu_torch.supervisor.ledger import LEDGER_FILE, AttemptLedger

        ledger = AttemptLedger("torn")
        ledger.append(
            "submitted", "job_1", attempt=1,
            handle="scripted://sup/job_1", resume_step=None,
        )
        ledger.append(
            "resubmitting", "job_1", attempt=1,
            failure_class="FailureClass.PREEMPTION",
        )
        ledger.append(
            "submitted", "job_2", attempt=2,
            handle="scripted://sup/job_2", resume_step=7,
            mesh="pp=1,dp=1,fsdp=4,ep=1,tp=1,sp=1",
        )
        # the client is SIGKILLed mid-append: a torn, non-JSON final line
        with open(os.path.join(ledger.path, LEDGER_FILE), "a") as f:
            f.write('{"transition": "resubmitting", "app_id": "job_2", "fail')
        assert [e["transition"] for e in ledger.entries()] == [
            "submitted", "resubmitting", "submitted",
        ]
        # a fresh supervisor restores exactly the completed transitions
        runner, _ = make_runner([])
        with runner:
            sup = Supervisor(
                runner, dryrun(runner), fast_policy(), session="torn-resumer"
            )
            sup._restore(ledger)
        assert sup._resume_handle == "scripted://sup/job_2"
        assert sup._resume_attempts == 2
        assert sup._resume_retries[FailureClass.PREEMPTION] == 1
        assert sup._resume_steps == [None, 7]
        assert sup._mesh_spec == "pp=1,dp=1,fsdp=4,ep=1,tp=1,sp=1"

    def test_meta_replace_is_atomic_past_a_dead_writer_tmp(self):
        from torchx_tpu_torch.supervisor.ledger import META_FILE, AttemptLedger

        ledger = AttemptLedger("meta-atomic")
        ledger.write_meta({"v": 1})
        # a previous writer died between tmp-write and rename, leaving a
        # torn tmp; it must never shadow the committed doc, and the next
        # write_meta must clean it up (same tmp name, atomic replace)
        tmp = os.path.join(ledger.path, META_FILE + ".tmp")
        with open(tmp, "w") as f:
            f.write('{"v": ')
        assert ledger.read_meta() == {"v": 1}
        ledger.write_meta({"v": 2})
        assert ledger.read_meta() == {"v": 2}
        assert not os.path.exists(tmp)


# =========================================================================
# tests/test_resilience.py: TestAttemptLedger, TestSupervisorResume,
# TestAcceptance
# =========================================================================


class TestAttemptLedger:
    @pytest.mark.parametrize("name", ["", "a/b", ".", ".."])
    def test_invalid_session_names(self, name):
        with pytest.raises(ValueError):
            AttemptLedger(name)

    def test_append_and_entries_round_trip(self):
        led = AttemptLedger("s1")
        led.append("submitted", "job_1", attempt=1, handle="x://s/job_1")
        led.append("finished", "job_1", state="SUCCEEDED")
        entries = list(led.entries())
        assert [e["transition"] for e in entries] == ["submitted", "finished"]
        assert entries[0]["handle"] == "x://s/job_1"
        assert entries[0]["time_usec"] > 0

    def test_torn_final_line_is_skipped(self):
        led = AttemptLedger("s2")
        led.append("submitted", "job_1")
        with open(os.path.join(led.path, "ledger.jsonl"), "a") as f:
            f.write('{"transition": "resub')  # writer died mid-append
        assert [e["transition"] for e in led.entries()] == ["submitted"]

    def test_meta_round_trip_and_missing(self):
        led = AttemptLedger("s3")
        assert not led.exists()
        led.write_meta({"scheduler": "local", "app": {}})
        assert led.exists()
        assert led.read_meta()["scheduler"] == "local"
        with pytest.raises(FileNotFoundError) as ei:
            AttemptLedger("nope").read_meta()
        assert "s3" in str(ei.value)  # known sessions listed in the error

    def test_list_sessions_newest_first(self):
        for name in ("old", "new"):
            AttemptLedger(name).write_meta({})
        root = os.environ["TPX_SUPERVISOR_DIR"]
        os.utime(os.path.join(root, "old", "meta.json"), (1, 1))
        os.utime(os.path.join(root, "new", "meta.json"), (2, 2))
        assert list_sessions() == ["new", "old"]


class TestSupervisorResume:
    def test_restore_replays_the_ledger(self):
        led = AttemptLedger("restore1")
        led.append("submitted", "job_1", attempt=1, resume_step=None,
                   handle="scripted://sup/job_1")
        led.append("resubmitting", "job_1",
                   failure_class=str(FailureClass.PREEMPTION))
        led.append("submitted", "job_2", attempt=2, resume_step=120,
                   handle="scripted://sup/job_2")
        runner, _ = make_runner()
        with runner:
            sup = Supervisor(runner, dryrun(runner), fast_policy(),
                             session="restore1")
            sup._restore(led)
        assert sup._resume_attempts == 2
        assert sup._resume_handle == "scripted://sup/job_2"
        assert sup._resume_retries[FailureClass.PREEMPTION] == 1
        assert sup._resume_retries[FailureClass.INFRA] == 0
        assert sup._resume_steps == [None, 120]

    def test_resume_reattaches_without_resubmitting(self, capture_pipeline):
        runner, sched = make_runner(script=[(AppState.SUCCEEDED, None)])
        with runner:
            sup = Supervisor(
                runner, dryrun(runner), fast_policy(), session="reatt",
                sleep=lambda s: None,
            )
            first = sup.run()
            assert first.succeeded and sched._counter == 1

            resumed = Supervisor.resume(runner, "reatt", sleep=lambda s: None)
            assert resumed.session == "reatt"
            result = resumed.run()
        assert result.succeeded
        assert result.attempts == 1
        assert result.handles == ["scripted://sup/job_1"]
        assert sched._counter == 1  # reattached; never submitted again
        reattached = [
            e
            for e in capture_pipeline.events
            if (e.app_metadata or {}).get("transition") == "reattached"
        ]
        assert len(reattached) == 1
        assert [e["transition"] for e in AttemptLedger("reatt").entries()].count(
            "submitted"
        ) == 1

    def test_resume_unknown_session_raises(self):
        runner, _ = make_runner()
        with runner:
            with pytest.raises(FileNotFoundError):
                Supervisor.resume(runner, "ghost")

    def test_resume_before_first_submit_raises(self):
        runner, _ = make_runner()
        with runner:
            sup = Supervisor(runner, dryrun(runner), fast_policy(),
                             session="early")
            sup._write_meta()  # client died between meta and first submit
            with pytest.raises(ValueError, match="no submitted attempt"):
                Supervisor.resume(runner, "early")


class TestAcceptance:
    def test_fault_injected_supervise_completes_with_zero_resubmits(
        self, monkeypatch, capture_pipeline
    ):
        """Two transient faults injected into local status polls are
        absorbed by in-seam retries — the supervised run succeeds on its
        FIRST attempt (no resubmits), with ``launcher.retry`` span and
        retry-metric evidence."""
        from torchx_tpu_torch.schedulers.local_scheduler import LocalScheduler

        monkeypatch.setattr(
            "torchx_tpu_torch.resilience.call.DEFAULT_POLICY", fast_call_policy()
        )
        monkeypatch.setenv(
            settings.ENV_TPX_FAULT_PLAN,
            '[{"backend": "local", "op": "describe", "nth": 2, "times": 2,'
            ' "mode": "transient", "message": "injected 503"}]',
        )
        retries_before = obs_metrics.CONTROL_PLANE_RETRIES.value(
            backend="local", op="describe", kind="UNAVAILABLE"
        )

        sched = LocalScheduler(session_name="acc", cache_size=10)
        runner = Runner(
            "acc", {"local": lambda session_name, **kw: sched}
        )
        app = AppDef(
            name="accjob",
            roles=[
                Role(
                    name="t", image="", entrypoint="sh",
                    args=["-c", "sleep 0.4"],
                )
            ],
        )
        with runner:
            info = runner.dryrun(app, "local")
            sup = Supervisor(
                runner, info, fast_policy(poll_interval=0.02),
                session="accsess",
            )
            result = sup.run()
        sched.close()

        assert result.succeeded
        assert result.attempts == 1  # ZERO resubmits
        assert len(result.handles) == 1
        assert all(n == 0 for n in result.retries.values())
        assert [e["transition"] for e in AttemptLedger("accsess").entries()].count(
            "resubmitting"
        ) == 0

        retries_after = obs_metrics.CONTROL_PLANE_RETRIES.value(
            backend="local", op="describe", kind="UNAVAILABLE"
        )
        assert retries_after - retries_before == 2
        retry_spans = [
            s
            for s in capture_pipeline.spans
            if s["name"] == "launcher.retry"
            and s["attrs"].get("backend") == "local"
            and s["attrs"].get("op") == "describe"
        ]
        assert len(retry_spans) == 2

    def test_sigkill_then_resume_reattaches_to_success(
        self, tmp_path, monkeypatch
    ):
        """SIGKILL the supervising client mid-run, then
        ``Supervisor.resume`` in a fresh process reattaches to the SAME
        handle (no duplicate submission) and drives it to SUCCEEDED. The
        child runs with the repo on ``PYTHONPATH`` (the package is not
        installed)."""
        from torchx_tpu_torch.schedulers.local_scheduler import LocalScheduler

        # child + parent must share the local-scheduler app registry: the
        # child resolves it under $HOME, the parent's monkeypatch is
        # re-pointed at the same file
        registry = tmp_path / ".tpx_torch_local_apps"
        monkeypatch.setattr(lsched, "_registry_path", lambda: str(registry))
        child_src = textwrap.dedent(
            """
            from torchx_tpu_torch.runner.api import Runner
            from torchx_tpu_torch.schedulers.local_scheduler import LocalScheduler
            from torchx_tpu_torch.specs.api import AppDef, Role
            from torchx_tpu_torch.supervisor import Supervisor, SupervisorPolicy

            runner = Runner(
                "crash",
                {"local": lambda session_name, **kw: LocalScheduler(
                    session_name=session_name, cache_size=10)},
            )
            app = AppDef(
                name="crashjob",
                roles=[Role(name="t", image="", entrypoint="sh",
                            args=["-c", "sleep 2"])],
            )
            info = runner.dryrun(app, "local")
            sup = Supervisor(
                runner, info,
                SupervisorPolicy(poll_interval=0.05),
                session="crashsess",
            )
            sup.run()
            """
        )
        script = tmp_path / "crash_child.py"
        script.write_text(child_src)
        env = dict(os.environ, HOME=str(tmp_path), PYTHONPATH=str(REPO_ROOT))
        child = subprocess.Popen(
            [sys.executable, str(script)],
            cwd=str(REPO_ROOT),
            env=env,
            stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL,
        )
        try:
            ledger_file = (
                Path(os.environ["TPX_SUPERVISOR_DIR"])
                / "crashsess"
                / "ledger.jsonl"
            )
            deadline = time.monotonic() + 30
            submitted = None
            while time.monotonic() < deadline and submitted is None:
                if ledger_file.exists():
                    for line in ledger_file.read_text().splitlines():
                        try:
                            entry = json.loads(line)
                        except ValueError:
                            continue
                        if entry.get("transition") == "submitted":
                            submitted = entry
                            break
                if child.poll() is not None:
                    pytest.fail("supervising child exited before the kill")
                time.sleep(0.02)
            assert submitted is not None, "child never submitted"
        finally:
            child.kill()  # SIGKILL: no cleanup handlers run
            child.wait()

        # the replica (its own session) survives the supervisor's death;
        # a fresh client reattaches to the recorded handle
        sched = LocalScheduler(session_name="crash", cache_size=10)
        runner = Runner("crash", {"local": lambda session_name, **kw: sched})
        with runner:
            sup = Supervisor.resume(runner, "crashsess")
            result = sup.run()
        sched.close()

        assert result.succeeded
        assert result.status is not None
        assert result.status.state == AppState.SUCCEEDED
        assert result.attempts == 1
        assert result.handles == [submitted["handle"]]  # the SAME attempt
        transitions = [
            e["transition"] for e in AttemptLedger("crashsess").entries()
        ]
        assert transitions.count("submitted") == 1  # never resubmitted
        assert "reattached" in transitions
        assert transitions[-1] == "finished"


# =========================================================================
# parity with the JAX package on the same inputs (all exact)
# =========================================================================


def _without_clock(entries):  # noqa: ANN001, ANN202
    return [{k: v for k, v in e.items() if k != "time_usec"} for e in entries]


class TestJaxParity:
    def test_each_ledger_reads_the_others_session(self, tmp_path):
        from torchx_tpu.supervisor import ledger as jledger

        root = str(tmp_path / "sup")
        meta = {"scheduler": "local", "app": {"name": "a"}, "cfg": {"log_dir": "/x"}}

        def write(ledger_cls, session):  # noqa: ANN001, ANN202
            led = ledger_cls(session, root=root)
            led.write_meta(meta)
            led.append("submitted", "job_1", attempt=1, resume_step=None,
                       handle="local://s/job_1", mesh=None)
            led.append("resubmitting", "job_1", attempt=1, failure_class="PREEMPTION",
                       retry=1, budget=1, backoff_seconds=1.0, resume_step=3,
                       state="PREEMPTED", mesh=None)
            led.append("finished", "job_2", attempt=2, state="SUCCEEDED")
            return led

        for session, writer, reader in (
                ("port-wrote", AttemptLedger, jledger.AttemptLedger),
                ("jax-wrote", jledger.AttemptLedger, AttemptLedger)):
            w = write(writer, session)
            r = reader(session, root=root)
            assert r.path == w.path
            assert r.exists() and r.read_meta() == meta
            assert list(r.entries()) == list(w.entries())
            assert len(list(r.entries())) == 3
        assert sorted(list_sessions(root)) == ["jax-wrote", "port-wrote"]
        assert list_sessions(root) == jledger.list_sessions(root)

    def test_latest_checkpoint_step_agrees(self, tmp_path):
        import torch

        from torchx_tpu.supervisor import latest_checkpoint_step as jlatest
        from torchx_tpu_torch.parallel.checkpoint import Checkpointer

        dirs = {}
        # the port's Checkpointer: its manifest and digit step dirs
        d = dirs["port"] = tmp_path / "port"
        ck = Checkpointer(str(d), async_save=False)
        ck.save(1, {"w": torch.full((4,), 1.0)})
        ck.save(2, {"w": torch.full((4,), 2.0)})
        ck.close()
        # the JAX layouts: orbax digit dirs, pickle files, a quarantined step
        d = dirs["jax"] = tmp_path / "jax"
        d.mkdir()
        (d / "40").mkdir()
        (d / "step_30.pkl").write_bytes(b"")
        (d / "50.corrupt").mkdir()
        d = dirs["corrupt_manifest"] = tmp_path / "corrupt_manifest"
        d.mkdir()
        (d / CHECKPOINT_MANIFEST).write_text("{not json")
        (d / "step_7.pkl").write_bytes(b"")
        dirs["missing"] = tmp_path / "nope"
        got = {k: (latest_checkpoint_step(str(v)), jlatest(str(v))) for k, v in dirs.items()}
        assert got == {"port": (2, 2), "jax": (40, 40), "corrupt_manifest": (7, 7),
                       "missing": (None, None)}

    def test_policy_dict_is_the_same(self):
        from torchx_tpu.specs.serialize import supervisor_policy_to_dict as jto_dict
        from torchx_tpu.supervisor import SupervisorPolicy as JPolicy

        for kw in ({}, dict(max_preemptions=5, checkpoint_dir="/ckpt", elastic=True),
                   dict(hang_deadline_seconds=30.0, gang_check_interval=0.5,
                        elastic_reshape=True, mesh="fsdp=-1", devices_per_replica=8,
                        backoff_seconds=1.0, jitter=0.0, poll_interval=0.2)):
            mine = supervisor_policy_to_dict(SupervisorPolicy(**kw))
            theirs = jto_dict(JPolicy(**kw))
            assert mine == theirs
            assert json.dumps(mine, sort_keys=True) == json.dumps(theirs, sort_keys=True)

    @pytest.mark.parametrize("script", [
        ("PREEMPT", "PREEMPT", "OK"),
        ("PREEMPT", "INFRA", "PREEMPT", "APP", "OK"),
        ("PREEMPT", "PREEMPT", "PREEMPT"),
        ("APP",),
    ])
    def test_the_two_loops_emit_the_same_history(self, tmp_path, script):
        """One scripted scheduler script through each package's Supervisor
        (jittered backoff from ``random.Random(5)``, a checkpoint manifest):
        the same ledger transitions, failure classes, retries, backoff
        delays and resume steps."""
        from torchx_tpu.runner.api import Runner as JRunner
        from torchx_tpu.schedulers import api as jsched
        from torchx_tpu.specs import api as jspecs
        from torchx_tpu.supervisor import AttemptLedger as JLedger
        from torchx_tpu.supervisor import Supervisor as JSupervisor
        from torchx_tpu.supervisor import SupervisorPolicy as JPolicy

        ckpt = tmp_path / "ckpt"
        ckpt.mkdir()
        (ckpt / CHECKPOINT_MANIFEST).write_text(json.dumps({"latest_step": 17}))
        policy = dict(max_preemptions=2, max_infra_retries=1, max_app_retries=1,
                      backoff_seconds=1.0, backoff_factor=2.0, jitter=0.1,
                      poll_interval=0.01, checkpoint_dir=str(ckpt))

        def run(specs_mod, sched_mod, runner_cls, sup_cls, policy_cls, ledger_cls,
                session):  # noqa: ANN001, ANN202
            outcomes = {"PREEMPT": (specs_mod.AppState.PREEMPTED,
                                    specs_mod.FailureClass.PREEMPTION),
                        "INFRA": (specs_mod.AppState.FAILED, specs_mod.FailureClass.INFRA),
                        "APP": (specs_mod.AppState.FAILED, specs_mod.FailureClass.APP),
                        "OK": (specs_mod.AppState.SUCCEEDED, None)}
            sched = scripted_scheduler(sched_mod, specs_mod)(
                "sup", script=[outcomes[s] for s in script])
            runner = runner_cls("sup", {"scripted": lambda session_name, **kw: sched})
            sleeps: list[float] = []
            with runner:
                app = specs_mod.AppDef(name="train", roles=[
                    specs_mod.Role(name="trainer", image="i", entrypoint="python")])
                result = sup_cls(runner, runner.dryrun(app, "scripted"),
                                 policy_cls(**policy), sleep=sleeps.append,
                                 rng=random.Random(5), session=session).run()
            envs = [{k: v for k, v in e.items() if k == ENV_TPX_RESUME_STEP}
                    for e in sched.submitted_envs]
            return {"sleeps": sleeps, "attempts": result.attempts,
                    "handles": result.handles, "resume_steps": result.resume_steps,
                    "retries": {fc.name: n for fc, n in result.retries.items()},
                    "exhausted": getattr(result.budget_exhausted, "name", None),
                    "state": result.status.state.name, "envs": envs,
                    "ledger": _without_clock(ledger_cls(session).entries())}

        mine = run(specs_api, sched_api, Runner, Supervisor, SupervisorPolicy,
                   AttemptLedger, "port-loop")
        theirs = run(jspecs, jsched, JRunner, JSupervisor, JPolicy, JLedger, "jax-loop")
        assert mine == theirs
        assert len(mine["ledger"]) >= 2


# =========================================================================
# acceptance on the CPU: `tpx-torch supervise` through a SIGKILL
# =========================================================================


def sigkill_exit_code(tmp_path) -> int:  # noqa: ANN001
    """The exit code the port's local scheduler records for a replica whose
    process group is SIGKILLed (taken from a real one, not assumed)."""
    sched = lsched.LocalScheduler(session_name="probe", cache_size=2)
    try:
        app = AppDef(name="probe", roles=[Role(name="p", image="", entrypoint="sleep",
                                               args=["30"])])
        app_id = sched.schedule(sched.submit_dryrun(app, {"log_dir": str(tmp_path / "probe")}))
        (replica,) = sched._apps[app_id].replicas()
        os.killpg(replica.proc.pid, signal.SIGKILL)
        replica.proc.wait(timeout=30)
        return replica.proc.returncode
    finally:
        sched.close()


class TestSupervisedGang:
    """``tpx-torch supervise --no-lint --policy <json>`` runs ``dist.spmd -j
    1x2`` on the local scheduler: two gloo workers train
    ``tests/torch_gang_cases.py``'s tiny config to a total of ``TOTAL``
    steps with a checkpoint directory (every step saved past the warm-up).
    Attempt 1 is SIGKILLed, its replica's process group, right after a
    committed step; the role's env arms ``TPX_SIMULATE_PREEMPTION_EXIT``
    with the code the scheduler records for that kill, so it ends
    PREEMPTED. The ledger then reads resubmitting from the step on disk,
    attempt 2's env carries it as ``TPX_RESUME_STEP``, the trainer reports
    it as ``resumed_from_step``, and attempt 2's losses are bitwise an
    uninterrupted gang's from that step on."""

    TOTAL = 60

    def _case(self, ckpt_dir: str) -> dict:
        return {"name": "train", "kind": "train", "batch": 4, "seq": 32,
                "total_steps": self.TOTAL, "warmup": 1, "data": None, "mesh": "fsdp=2",
                "ckpt_dir": ckpt_dir, "ckpt_every": 1}

    def test_sigkilled_attempt_resumes_bitwise(self, tmp_path):
        # the uninterrupted gang, by hand, beside the supervised one
        ref_proc = gang.run_cases(tmp_path / "ref", 2, [
            self._case(str(tmp_path / "ref" / "ck"))])

        code = sigkill_exit_code(tmp_path)
        out, ck = tmp_path / "out", tmp_path / "ck"
        out.mkdir()
        job = tmp_path / "job.json"
        job.write_text(json.dumps({"out": str(out), "cases": [self._case(str(ck))]}))
        policy = tmp_path / "policy.json"
        policy.write_text(json.dumps({
            "checkpoint_dir": str(ck), "max_preemptions": 1, "backoff_seconds": 0.2,
            "jitter": 0.0, "poll_interval": 0.1}))
        sup_dir = os.environ["TPX_SUPERVISOR_DIR"]
        logs = tmp_path / "apps"
        env = dict(os.environ, PYTHONPATH=str(REPO_ROOT), HOME=str(tmp_path),
                   OMP_NUM_THREADS="1")
        cli = subprocess.Popen(
            [sys.executable, "-m", "torchx_tpu_torch.cli.main", "supervise", "--no-lint",
             "-s", "local", "-cfg", f"log_dir={logs}", "--policy", str(policy),
             "--session", "gangsess",
             "dist.spmd", "-j", "1x2", "--coordinator_port", "0",
             "--env", f"PYTHONPATH={REPO_ROOT},OMP_NUM_THREADS=1,"
                      f"{settings.ENV_TPX_SIMULATE_PREEMPTION_EXIT}={code}",
             "--script", str(REPO_ROOT / "tests" / "torch_gang_cases.py"), "--", str(job)],
            cwd=str(REPO_ROOT), env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, start_new_session=True)
        try:
            ledger = AttemptLedger("gangsess", root=sup_dir)
            deadline = time.monotonic() + 120
            killed_after = None
            while killed_after is None:
                assert time.monotonic() < deadline, "attempt 1 never committed a step"
                assert cli.poll() is None, cli.communicate()
                first = next((e for e in ledger.entries()
                              if e["transition"] == "submitted"), None)
                committed = latest_checkpoint_step(str(ck))
                if first is not None and committed:
                    # the replica's process group, by the pid in the state
                    # file (as the scheduler's own cancel finds it)
                    state = json.loads((logs / first["app_id"] / lsched.STATE_FILE)
                                       .read_text())
                    ((replica,),) = state["roles"].values()
                    os.killpg(replica["pid"], signal.SIGKILL)
                    killed_after = committed
                time.sleep(0.02)
            stdout, stderr = cli.communicate(timeout=180)
        finally:
            try:
                os.killpg(cli.pid, signal.SIGKILL)
            except OSError:
                pass
            cli.wait()
        ((rc_ref, _, err_ref),) = gang.finish([ref_proc])
        assert rc_ref == 0, err_ref[-3000:]
        assert cli.returncode == 0, stdout[-2000:] + stderr[-3000:]

        entries = list(AttemptLedger("gangsess", root=sup_dir).entries())
        assert [e["transition"] for e in entries] == [
            "submitted", "resubmitting", "submitted", "finished"]
        resub = entries[1]
        assert (resub["state"], resub["failure_class"]) == ("PREEMPTED", "PREEMPTION")
        n = resub["resume_step"]
        assert n is not None and n >= killed_after  # what was durable at resubmit
        assert entries[2]["resume_step"] == n and entries[2]["attempt"] == 2
        assert entries[3]["state"] == "SUCCEEDED"
        assert f"(resumed from step {n})" in stdout

        import torch

        res = [torch.load(out / f"rank{r}.pt") for r in range(2)]
        ref = gang.load_results(tmp_path / "ref", 2)
        for r in range(2):
            assert res[r]["train"]["resume_step_env"] == n
            assert res[r]["train"]["resumed_from_step"] == n
            assert len(res[r]["train"]["losses"]) == self.TOTAL - n
            assert res[r]["train"]["losses"] == ref[r]["train"]["losses"][n:]
