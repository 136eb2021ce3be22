"""The port's runner (``torchx_tpu_torch.runner``) held to the JAX
runner's own cases: every case of ``tests/test_runner.py``; the describe
cache, the runner's cache routing, the list fan-out, the merged logs, the
parallel workspace builds and the line emitter of ``tests/test_fastpath.py``
(its lazy CLI cases run in ``tests/test_torch_cli.py``); and
``tests/test_resilience.py::TestPollMissBudget``, each run against the copy.
Added: the seam that names a later item (the lint gate, 2.8),
``Runner.supervise`` running the supervisor (item 2.4), the acceptance run
of ``dist.spmd`` through ``Runner.run_component`` on the local scheduler
(two gloo workers), and
parity with the JAX runner on the same inputs (``TestJaxParity``: the
materialized local request of a CPU-only component, the describe cache's
answers, fetches, hits and misses under one clock).

The port's lint gate raises until the analyzer is ported, so an autouse
fixture sets ``TPX_NO_LINT=1``; every case keeps the local scheduler's
registry under ``tmp_path`` and sees a card-less host."""

import io
import json
import logging
import os
import threading
import time
from typing import Mapping, Optional

import pytest

from torchx_tpu_torch import settings
from torchx_tpu_torch.obs import metrics as obs_metrics
from torchx_tpu_torch.resilience import (
    FailureKind,
    PermanentSchedulerError,
    TransientSchedulerError,
)
from torchx_tpu_torch.runner.api import Runner, UnknownSchedulerError, get_runner
from torchx_tpu_torch.runner.describe_cache import DescribeCache, cache_ttl
from torchx_tpu_torch.runner.events import get_events_logger
from torchx_tpu_torch.runner.events.api import TpxEvent
from torchx_tpu_torch.schedulers import local_scheduler as lsched
from torchx_tpu_torch.schedulers.api import DescribeAppResponse, ListAppResponse, Scheduler
from torchx_tpu_torch.specs.api import (
    AppDef,
    AppDryRunInfo,
    AppState,
    CfgVal,
    Role,
    Workspace,
    runopts,
)
from torch_threads import xdist_torch_threads  # noqa: F401


@pytest.fixture(autouse=True)
def _no_lint_own_registry(tmp_path, monkeypatch):
    """The lint gate is bypassed (it raises until ROADMAP queue 1 item 2.8),
    the local scheduler's registry lives in ``tmp_path``, and the host has
    no card."""
    monkeypatch.setenv(settings.ENV_TPX_NO_LINT, "1")
    monkeypatch.setattr(lsched, "_registry_path", lambda: str(tmp_path / "registry"))
    monkeypatch.delenv(settings.ENV_CUDA_VISIBLE_DEVICES, raising=False)
    monkeypatch.setattr(lsched, "driver_gpu_count", lambda: 0)


# =========================================================================
# tests/test_runner.py
# =========================================================================


class StubScheduler(Scheduler[dict]):
    def __init__(self, session_name: str, **kwargs):
        super().__init__("stub", session_name)
        self.apps: dict[str, AppState] = {}
        self.cancelled: list[str] = []
        self._counter = 0

    def run_opts(self) -> runopts:
        opts = runopts()
        opts.add("knob", type_=str, help="a knob", default="k0")
        return opts

    def _submit_dryrun(self, app: AppDef, cfg: Mapping[str, CfgVal]):
        return AppDryRunInfo({"app": app, "cfg": dict(cfg)})

    def schedule(self, dryrun_info) -> str:
        self._counter += 1
        app_id = f"stub_app_{self._counter}"
        self.apps[app_id] = AppState.RUNNING
        return app_id

    def describe(self, app_id: str) -> Optional[DescribeAppResponse]:
        if app_id not in self.apps:
            return None
        return DescribeAppResponse(app_id=app_id, state=self.apps[app_id])

    def _cancel_existing(self, app_id: str) -> None:
        self.apps[app_id] = AppState.CANCELLED
        self.cancelled.append(app_id)

    def list(self):
        return [ListAppResponse(app_id=a, state=s) for a, s in self.apps.items()]


@pytest.fixture
def runner():
    stub = StubScheduler("test")
    r = Runner("test", {"stub": lambda session_name, **kw: stub})
    yield r
    r.close()


def simple_app(**role_kwargs) -> AppDef:
    defaults = dict(name="r", image="i", entrypoint="echo", args=["hi"])
    defaults.update(role_kwargs)
    return AppDef(name="app", roles=[Role(**defaults)])


class TestRunner:
    def test_run_and_status(self, runner):
        handle = runner.run(simple_app(), "stub")
        assert handle.startswith("stub://test/")
        status = runner.status(handle)
        assert status.state == AppState.RUNNING

    def test_dryrun_resolves_cfg(self, runner):
        info = runner.dryrun(simple_app(), "stub", {"knob": "custom"})
        assert info.request["cfg"]["knob"] == "custom"
        info = runner.dryrun(simple_app(), "stub")
        assert info.request["cfg"]["knob"] == "k0"

    def test_dryrun_validation(self, runner):
        with pytest.raises(ValueError):
            runner.dryrun(AppDef(name="empty"), "stub")
        with pytest.raises(ValueError):
            runner.dryrun(simple_app(entrypoint=""), "stub")
        with pytest.raises(ValueError):
            runner.dryrun(simple_app(num_replicas=0), "stub")
        with pytest.raises(ValueError):
            runner.dryrun(simple_app(min_replicas=5, num_replicas=2), "stub")

    def test_schedule_requires_runner_dryrun(self, runner):
        with pytest.raises(ValueError):
            runner.schedule(AppDryRunInfo({"raw": True}))

    def test_cancel(self, runner):
        handle = runner.run(simple_app(), "stub")
        runner.cancel(handle)
        assert runner.status(handle).state == AppState.CANCELLED

    def test_resize_routes_to_scheduler(self, runner):
        handle = runner.run(simple_app(), "stub")
        # the stub does not implement resize: the optional-capability
        # default must raise a clear NotImplementedError
        with pytest.raises(NotImplementedError, match="does not support resizing"):
            runner.resize(handle, "r", 2)

    def test_status_unknown_app(self, runner):
        assert runner.status("stub://test/ghost") is None

    def test_unknown_scheduler(self, runner):
        with pytest.raises(KeyError):
            runner.run(simple_app(), "nope")

    def test_list(self, runner):
        runner.run(simple_app(), "stub")
        assert len(runner.list("stub")) == 1

    def test_wait_terminal(self, runner):
        handle = runner.run(simple_app(), "stub")
        _, _, app_id = handle.partition("//")[0], None, handle.rsplit("/", 1)[-1]

        def finish():
            sched = runner._scheduler("stub")
            sched.apps[app_id] = AppState.SUCCEEDED

        t = threading.Timer(0.3, finish)
        t.start()
        status = runner.wait(handle, wait_interval=0.05)
        assert status.state == AppState.SUCCEEDED

    def test_run_component_via_stub(self, runner):
        handle = runner.run_component(
            "utils.echo", ["--msg", "yo"], "stub"
        )
        assert handle.startswith("stub://")

    def test_dryrun_does_not_mutate_caller_app(self, runner):
        app = simple_app()
        runner.dryrun(app, "stub", workspace=None)
        assert app.roles[0].env == {}
        before = app.roles[0].image
        runner.dryrun(app, "stub")
        assert app.roles[0].image == before

    def test_component_defaults_applied(self):
        stub = StubScheduler("test")
        r = Runner(
            "test",
            {"stub": lambda session_name, **kw: stub},
            component_defaults={"utils.echo": {"msg": "default-msg"}},
        )
        info = r.dryrun_component("utils.echo", [], "stub")
        assert info.request["app"].roles[0].args == ["default-msg"]


class TestGetRunner:
    def test_get_runner_has_registered_backends(self):
        from torchx_tpu_torch.schedulers import DEFAULT_SCHEDULER_MODULES

        with get_runner() as runner:
            backends = runner.scheduler_backends()
            for expected in DEFAULT_SCHEDULER_MODULES:
                assert expected in backends

    def test_env_param_harvest(self, monkeypatch):
        monkeypatch.setenv("TPX_PARAMS_CACHE_SIZE", "5")
        with get_runner() as runner:
            assert runner._scheduler_params.get("cache_size") == "5"


class TestRunnerLocalE2E:
    def test_echo_end_to_end(self, tmp_path):
        with get_runner("e2e") as runner:
            handle = runner.run_component(
                "utils.echo",
                ["--msg", "runner-e2e"],
                "local",
                {"log_dir": str(tmp_path)},
            )
            status = runner.wait(handle, wait_interval=0.1)
            assert status.state == AppState.SUCCEEDED
            lines = list(runner.log_lines(handle, "echo", 0))
            assert "runner-e2e" in lines


class FlakySequenceScheduler(Scheduler[dict]):
    """``describe()`` follows a script mixing exceptions and states — for
    the consecutive-miss-reset contract of ``Runner.wait``."""

    def __init__(self, session_name: str, script=None, **kwargs):
        super().__init__("flaky", session_name)
        self.script = list(script or [])

    def run_opts(self) -> runopts:
        return runopts()

    def _submit_dryrun(self, app: AppDef, cfg: Mapping[str, CfgVal]):
        return AppDryRunInfo({"app": app})

    def schedule(self, dryrun_info) -> str:
        return "job_1"

    def describe(self, app_id: str) -> Optional[DescribeAppResponse]:
        item = self.script.pop(0) if self.script else AppState.SUCCEEDED
        if isinstance(item, BaseException):
            raise item
        return DescribeAppResponse(app_id=app_id, state=item)

    def _cancel_existing(self, app_id: str) -> None:
        pass


def _flaky_wait(script, budget):
    sched = FlakySequenceScheduler("w", script=script)
    r = Runner("w", {"flaky": lambda session_name, **kw: sched})
    with r:
        status = r.wait(
            "flaky://w/job_1",
            wait_interval=0.01,
            sleep=lambda s: None,
            poll_miss_budget=budget,
        )
    return status, sched


class TestWaitMissReset:
    def test_success_resets_consecutive_miss_counter(self):
        """miss -> success -> miss -> success with budget=1: each miss is
        the FIRST of its streak, so a week-long wait can absorb any number
        of isolated blips (a cumulative counter would raise on blip 2)."""
        status, sched = _flaky_wait(
            [
                ConnectionError("blip 1"),
                AppState.RUNNING,
                ConnectionError("blip 2"),
                AppState.SUCCEEDED,
            ],
            budget=1,
        )
        assert status.state == AppState.SUCCEEDED
        assert not sched.script  # every scripted poll was consumed

    def test_consecutive_misses_still_exhaust_the_budget(self):
        """Control for the reset: two misses in a row DO exceed budget=1."""
        with pytest.raises(ConnectionError, match="back-to-back"):
            _flaky_wait(
                [
                    ConnectionError("blip"),
                    ConnectionError("back-to-back"),
                    AppState.SUCCEEDED,
                ],
                budget=1,
            )


class ResizableStubScheduler(StubScheduler):
    """Stub with resize support, counting backend describes so tests can
    observe the describe cache being (in)validated."""

    def __init__(self, session_name: str, **kwargs):
        super().__init__(session_name, **kwargs)
        self.describe_calls = 0
        self.resized: list[tuple[str, str, int]] = []

    def describe(self, app_id: str):
        self.describe_calls += 1
        return super().describe(app_id)

    def resize(self, app_id: str, role_name: str, num_replicas: int) -> None:
        if self.apps.get(app_id) in (AppState.CANCELLED, AppState.SUCCEEDED):
            raise ValueError(f"cannot resize terminal app {app_id}")
        self.resized.append((app_id, role_name, num_replicas))


class TestRunnerResize:
    """Satellite coverage for Runner.resize: ledger + cache + error path."""

    @pytest.fixture
    def rig(self, monkeypatch):
        monkeypatch.setenv("TPX_DESCRIBE_CACHE_TTL", "300")
        stub = ResizableStubScheduler("test")
        r = Runner("test", {"stub": lambda session_name, **kw: stub})
        yield r, stub
        r.close()

    def test_resize_invalidates_describe_cache(self, rig):
        runner, stub = rig
        handle = runner.run(simple_app(), "stub")
        assert runner.status(handle).state == AppState.RUNNING
        calls = stub.describe_calls
        runner.status(handle)  # within TTL: served from cache
        assert stub.describe_calls == calls
        runner.resize(handle, "r", 3)
        assert stub.resized[-1][1:] == ("r", 3)
        runner.status(handle)  # resize invalidated: backend re-fetched
        assert stub.describe_calls == calls + 1

    def test_resize_terminal_app_raises(self, rig):
        runner, stub = rig
        handle = runner.run(simple_app(), "stub")
        runner.cancel(handle)
        with pytest.raises(ValueError, match="terminal"):
            runner.resize(handle, "r", 2)

    def test_resize_is_ledgered(self, rig):
        runner, stub = rig
        from torchx_tpu_torch.obs import sinks, timeline

        handle = runner.run(simple_app(), "stub")
        runner.resize(handle, "r", 2)
        records = timeline.load_records(sinks.trace_path())
        apis = [rec.get("api") for rec in records if rec.get("api")]
        assert "resize" in apis


# =========================================================================
# tests/test_fastpath.py
# =========================================================================




def _resp(state: AppState = AppState.RUNNING) -> DescribeAppResponse:
    return DescribeAppResponse(app_id="a1", state=state)


class TestDescribeCache:
    def test_ttl_shares_one_fetch(self):
        cache = DescribeCache(ttl=60.0)
        calls = []
        fetch = lambda: calls.append(1) or _resp()  # noqa: E731
        r1 = cache.get("stub", "a1", fetch)
        r2 = cache.get("stub", "a1", fetch)
        assert len(calls) == 1
        assert r1 is r2

    def test_fresh_bypasses_ttl(self):
        cache = DescribeCache(ttl=60.0)
        calls = []
        fetch = lambda: calls.append(1) or _resp()  # noqa: E731
        cache.get("stub", "a1", fetch)
        cache.get("stub", "a1", fetch, fresh=True)
        assert len(calls) == 2

    def test_terminal_state_pinned_even_for_fresh(self):
        cache = DescribeCache(ttl=0.0)
        calls = []
        fetch = lambda: calls.append(1) or _resp(AppState.SUCCEEDED)  # noqa: E731
        cache.get("stub", "a1", fetch)
        r = cache.get("stub", "a1", fetch, fresh=True)
        assert len(calls) == 1
        assert r.state == AppState.SUCCEEDED

    def test_zero_ttl_never_caches_nonterminal(self):
        cache = DescribeCache(ttl=0.0)
        calls = []
        fetch = lambda: calls.append(1) or _resp()  # noqa: E731
        cache.get("stub", "a1", fetch)
        cache.get("stub", "a1", fetch)
        assert len(calls) == 2

    def test_errors_never_cached(self):
        cache = DescribeCache(ttl=60.0)
        calls = []

        def boom():
            calls.append(1)
            raise RuntimeError("control plane down")

        with pytest.raises(RuntimeError):
            cache.get("stub", "a1", boom)
        ok = lambda: calls.append(1) or _resp()  # noqa: E731
        assert cache.get("stub", "a1", ok) is not None
        assert len(calls) == 2

    def test_none_drops_entry(self):
        cache = DescribeCache(ttl=60.0)
        assert cache.get("stub", "a1", lambda: None) is None
        calls = []
        cache.get("stub", "a1", lambda: calls.append(1) or _resp())
        assert len(calls) == 1  # nothing was cached for the None result

    def test_invalidate(self):
        cache = DescribeCache(ttl=60.0)
        calls = []
        fetch = lambda: calls.append(1) or _resp()  # noqa: E731
        cache.get("stub", "a1", fetch)
        cache.invalidate("stub", "a1")
        cache.get("stub", "a1", fetch)
        assert len(calls) == 2

    def test_concurrent_gets_coalesce_to_one_fetch(self):
        cache = DescribeCache(ttl=0.0)  # TTL off: coalescing does the work
        started = threading.Event()
        release = threading.Event()
        calls = []

        def slow_fetch():
            calls.append(1)
            started.set()
            assert release.wait(10)
            return _resp()

        results = []

        def get():
            results.append(cache.get("stub", "a1", slow_fetch, fresh=True))

        t1 = threading.Thread(target=get)
        t1.start()
        assert started.wait(10)
        t2 = threading.Thread(target=get)
        t2.start()
        time.sleep(0.05)  # let t2 reach the coalescing wait
        release.set()
        t1.join(10)
        t2.join(10)
        assert len(calls) == 1
        assert len(results) == 2
        assert all(r is not None and r.state == AppState.RUNNING for r in results)

    def test_cache_ttl_env_parsing(self, monkeypatch):
        from torchx_tpu_torch import settings

        monkeypatch.delenv(settings.ENV_TPX_DESCRIBE_CACHE_TTL, raising=False)
        assert cache_ttl() == settings.DEFAULT_DESCRIBE_CACHE_TTL
        monkeypatch.setenv(settings.ENV_TPX_DESCRIBE_CACHE_TTL, "2.5")
        assert cache_ttl() == 2.5
        monkeypatch.setenv(settings.ENV_TPX_DESCRIBE_CACHE_TTL, "-1")
        assert cache_ttl() == 0.0
        monkeypatch.setenv(settings.ENV_TPX_DESCRIBE_CACHE_TTL, "nope")
        assert cache_ttl() == settings.DEFAULT_DESCRIBE_CACHE_TTL


# =========================================================================
# Runner integration: cache routing + fan-out
# =========================================================================


class CountingScheduler(Scheduler[dict]):
    """Stub backend that counts describe calls and supports logs."""

    def __init__(self, session_name: str, **kwargs):
        super().__init__("stub", session_name)
        self.apps: dict[str, AppState] = {}
        self.describe_calls = 0
        self.list_delay = 0.0
        self.log_lines_by_replica: dict[tuple[str, int], list[str]] = {}
        self._counter = 0

    def run_opts(self) -> runopts:
        return runopts()

    def _submit_dryrun(self, app: AppDef, cfg: Mapping[str, CfgVal]):
        return AppDryRunInfo({"app": app, "cfg": dict(cfg)})

    def schedule(self, dryrun_info) -> str:
        self._counter += 1
        app_id = f"stub_app_{self._counter}"
        self.apps[app_id] = AppState.RUNNING
        return app_id

    def describe(self, app_id: str) -> Optional[DescribeAppResponse]:
        self.describe_calls += 1
        if app_id not in self.apps:
            return None
        return DescribeAppResponse(app_id=app_id, state=self.apps[app_id])

    def _cancel_existing(self, app_id: str) -> None:
        self.apps[app_id] = AppState.CANCELLED

    def list(self):
        if self.list_delay:
            time.sleep(self.list_delay)
        return [ListAppResponse(app_id=a, state=s) for a, s in self.apps.items()]

    def log_iter(
        self,
        app_id,
        role_name,
        k=0,
        regex=None,
        since=None,
        until=None,
        should_tail=False,
        streams=None,
    ):
        lines = self.log_lines_by_replica.get((role_name, k))
        if lines is None:
            raise RuntimeError(f"no logs for {role_name}/{k}")
        for line in lines:
            time.sleep(0.001)
            yield line


def fp_simple_app() -> AppDef:
    return AppDef(
        name="app",
        roles=[Role(name="r", image="i", entrypoint="echo", args=["hi"])],
    )


@pytest.fixture
def stub():
    return CountingScheduler("test")


@pytest.fixture
def fp_runner(stub):
    r = Runner("test", {"stub": lambda session_name, **kw: stub})
    yield r
    r.close()


class TestRunnerCacheRouting:
    def test_status_polls_share_backend_call(self, fp_runner, stub, monkeypatch):
        from torchx_tpu_torch import settings

        monkeypatch.setenv(settings.ENV_TPX_DESCRIBE_CACHE_TTL, "60")
        handle = fp_runner.run(fp_simple_app(), "stub")
        base = stub.describe_calls
        h0 = obs_metrics.DESCRIBE_CACHE_HITS.value(scheduler="stub")
        m0 = obs_metrics.DESCRIBE_CACHE_MISSES.value(scheduler="stub")
        for _ in range(5):
            assert fp_runner.status(handle).state == AppState.RUNNING
        assert stub.describe_calls == base + 1
        assert obs_metrics.DESCRIBE_CACHE_MISSES.value(scheduler="stub") == m0 + 1
        assert obs_metrics.DESCRIBE_CACHE_HITS.value(scheduler="stub") == h0 + 4

    def test_fresh_status_always_hits_backend(self, fp_runner, stub, monkeypatch):
        from torchx_tpu_torch import settings

        monkeypatch.setenv(settings.ENV_TPX_DESCRIBE_CACHE_TTL, "60")
        handle = fp_runner.run(fp_simple_app(), "stub")
        base = stub.describe_calls
        fp_runner.status(handle, fresh=True)
        fp_runner.status(handle, fresh=True)
        assert stub.describe_calls == base + 2

    def test_cancel_invalidates_cache(self, fp_runner, stub, monkeypatch):
        from torchx_tpu_torch import settings

        monkeypatch.setenv(settings.ENV_TPX_DESCRIBE_CACHE_TTL, "60")
        handle = fp_runner.run(fp_simple_app(), "stub")
        assert fp_runner.status(handle).state == AppState.RUNNING
        fp_runner.cancel(handle)
        # CANCELLED must be visible immediately despite the fat TTL
        assert fp_runner.status(handle).state == AppState.CANCELLED

    def test_terminal_state_needs_no_backend_calls(self, fp_runner, stub, monkeypatch):
        from torchx_tpu_torch import settings

        monkeypatch.setenv(settings.ENV_TPX_DESCRIBE_CACHE_TTL, "0")
        handle = fp_runner.run(fp_simple_app(), "stub")
        app_id = handle.rsplit("/", 1)[-1]
        stub.apps[app_id] = AppState.SUCCEEDED
        fp_runner.status(handle, fresh=True)
        base = stub.describe_calls
        for _ in range(3):
            assert fp_runner.status(handle, fresh=True).state == AppState.SUCCEEDED
        assert stub.describe_calls == base


class TestListFanOut:
    def _runner(self, factories):
        return Runner("test", factories)

    def test_registry_order_regardless_of_completion(self):
        slow = CountingScheduler("test")
        slow.apps["slow_1"] = AppState.RUNNING
        slow.list_delay = 0.2
        fast = CountingScheduler("test")
        fast.apps["fast_1"] = AppState.SUCCEEDED
        r = self._runner(
            {
                "slow": lambda session_name, **kw: slow,
                "fast": lambda session_name, **kw: fast,
            }
        )
        try:
            results, errors = r.list_all()
        finally:
            r.close()
        assert errors == {}
        assert list(results) == ["slow", "fast"]  # registry order
        assert [a.app_id for a in results["slow"]] == ["slow_1"]
        assert [a.app_id for a in results["fast"]] == ["fast_1"]

    def test_one_broken_backend_does_not_hide_others(self):
        ok = CountingScheduler("test")
        ok.apps["ok_1"] = AppState.RUNNING

        class Broken(CountingScheduler):
            def list(self):
                raise RuntimeError("unreachable control plane")

        r = self._runner(
            {
                "broken": lambda session_name, **kw: Broken("test"),
                "ok": lambda session_name, **kw: ok,
            }
        )
        try:
            results, errors = r.list_all()
        finally:
            r.close()
        assert [a.app_id for a in results["ok"]] == ["ok_1"]
        assert "broken" in errors
        assert "unreachable" in str(errors["broken"])

    def test_unknown_scheduler_rejected(self, fp_runner):
        with pytest.raises(UnknownSchedulerError):
            fp_runner.list_all(schedulers=["nope"])

    def test_fanout_is_concurrent(self):
        barrier = threading.Barrier(2, timeout=10)

        class Meeting(CountingScheduler):
            def list(self):
                barrier.wait()  # deadlocks unless both lists run at once
                return super().list()

        r = self._runner(
            {
                "a": lambda session_name, **kw: Meeting("test"),
                "b": lambda session_name, **kw: Meeting("test"),
            }
        )
        try:
            results, errors = r.list_all()
        finally:
            r.close()
        assert errors == {}
        assert list(results) == ["a", "b"]


class TestLogMerge:
    def test_per_replica_order_preserved(self, fp_runner, stub):
        handle = fp_runner.run(fp_simple_app(), "stub")
        stub.log_lines_by_replica = {
            ("r", 0): [f"r0 line {i}\n" for i in range(20)],
            ("r", 1): [f"r1 line {i}\n" for i in range(20)],
        }
        got = list(fp_runner.log_lines_multi(handle, {"r": [0, 1]}))
        by_replica: dict[int, list[str]] = {0: [], 1: []}
        for role, rid, line in got:
            assert role == "r"
            assert not line.endswith("\n")
            by_replica[rid].append(line)
        assert by_replica[0] == [f"r0 line {i}" for i in range(20)]
        assert by_replica[1] == [f"r1 line {i}" for i in range(20)]

    def test_stream_error_is_isolated(self, fp_runner, stub):
        handle = fp_runner.run(fp_simple_app(), "stub")
        stub.log_lines_by_replica = {("r", 0): ["ok\n"]}  # replica 1 missing
        got = list(fp_runner.log_lines_multi(handle, {"r": [0, 1]}))
        lines = {(rid, line) for _, rid, line in got}
        assert (0, "ok") in lines
        assert any(rid == 1 and "log stream error" in line for rid, line in lines)

    def test_empty_replicas(self, fp_runner, stub):
        handle = fp_runner.run(fp_simple_app(), "stub")
        assert list(fp_runner.log_lines_multi(handle, {})) == []


# =========================================================================
# Parallel workspace builds
# =========================================================================


class BarrierWorkspace:
    """Mixin host whose builds must overlap to pass the barrier."""

    from torchx_tpu_torch.workspace.api import WorkspaceMixin

    class Impl(WorkspaceMixin[dict]):
        def __init__(self, barrier=None):
            self.barrier = barrier
            self.builds: list[str] = []

        def build_workspace_and_update_role(self, role, workspace, cfg):
            if self.barrier is not None:
                self.barrier.wait()
            self.builds.append(role.image)
            role.image = f"built-{role.image}"


def _role(name: str, image: str, projects: dict) -> Role:
    return Role(
        name=name,
        image=image,
        entrypoint="echo",
        workspace=Workspace(projects=projects),
    )


class TestParallelWorkspaceBuilds:
    def test_distinct_keys_build_concurrently(self):
        barrier = threading.Barrier(2, timeout=10)
        ws = BarrierWorkspace.Impl(barrier)
        roles = [
            _role("a", "img-a", {"./src": "src"}),
            _role("b", "img-b", {"./src": "src"}),
        ]
        ws.build_workspaces(roles, {})  # serial builds would deadlock here
        assert roles[0].image == "built-img-a"
        assert roles[1].image == "built-img-b"

    def test_shared_key_builds_once(self):
        ws = BarrierWorkspace.Impl()
        roles = [
            _role("a", "img", {"./src": "src"}),
            _role("b", "img", {"./src": "src"}),
            _role("c", "other", {"./src": "src"}),
        ]
        ws.build_workspaces(roles, {})
        assert sorted(ws.builds) == ["img", "other"]  # one build per key
        assert roles[0].image == "built-img"
        assert roles[1].image == "built-img"  # cached result, same key
        assert roles[2].image == "built-other"

    def test_roles_without_workspace_untouched(self):
        ws = BarrierWorkspace.Impl()
        plain = Role(name="p", image="img", entrypoint="echo")
        ws.build_workspaces([plain], {})
        assert plain.image == "img"
        assert ws.builds == []

    def test_build_error_propagates(self):
        class Exploding(BarrierWorkspace.Impl):
            def build_workspace_and_update_role(self, role, workspace, cfg):
                raise RuntimeError("docker build failed")

        ws = Exploding()
        roles = [
            _role("a", "img-a", {"./src": "src"}),
            _role("b", "img-b", {"./src": "src"}),
        ]
        with pytest.raises(RuntimeError, match="docker build failed"):
            ws.build_workspaces(roles, {})


# =========================================================================
# Line-atomic log emitter
# =========================================================================


class TestLineEmitter:
    def test_concurrent_emits_never_tear_lines(self):
        from torchx_tpu_torch.util.log_tee_helpers import LineEmitter

        out = io.StringIO()
        emitter = LineEmitter(out)
        n, writers = 200, 8

        def spam(tag: str):
            for i in range(n):
                emitter.emit(f"[{tag}]", f"line {i}")

        threads = [
            threading.Thread(target=spam, args=(f"w{w}",)) for w in range(writers)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        lines = out.getvalue().splitlines()
        assert len(lines) == n * writers
        for line in lines:
            assert line.startswith("[w") and "] line " in line, line

    def test_strips_trailing_newline(self):
        from torchx_tpu_torch.util.log_tee_helpers import LineEmitter

        out = io.StringIO()
        LineEmitter(out).emit("p", "hello\n")
        assert out.getvalue() == "p hello\n"

    def test_no_prefix(self):
        from torchx_tpu_torch.util.log_tee_helpers import LineEmitter

        out = io.StringIO()
        LineEmitter(out).emit("", "bare")
        assert out.getvalue() == "bare\n"



# =========================================================================
# tests/test_resilience.py::TestPollMissBudget
# =========================================================================


class FlakyScheduler(Scheduler[dict]):
    """``describe()`` raises the scripted exceptions first, then reports a
    terminal SUCCEEDED — a control plane that flakes mid-wait."""

    def __init__(self, session_name: str, failures=None, **kwargs):
        super().__init__("flaky", session_name)
        self.failures = list(failures or [])

    def run_opts(self) -> runopts:
        return runopts()

    def _submit_dryrun(self, app: AppDef, cfg: Mapping[str, CfgVal]):
        return AppDryRunInfo({"app": app})

    def schedule(self, dryrun_info) -> str:
        return "job_1"

    def describe(self, app_id: str) -> Optional[DescribeAppResponse]:
        if self.failures:
            raise self.failures.pop(0)
        return DescribeAppResponse(app_id=app_id, state=AppState.SUCCEEDED)

    def _cancel_existing(self, app_id: str) -> None:
        pass


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
    handler = _CaptureEvents()
    logger = get_events_logger()
    logger.addHandler(handler)
    yield handler
    logger.removeHandler(handler)


def flaky_wait(failures, budget):
    sched = FlakyScheduler("w", failures=failures)
    runner = Runner("w", {"flaky": lambda session_name, **kw: sched})
    with runner:
        return runner.wait(
            "flaky://w/job_1",
            wait_interval=0.01,
            sleep=lambda s: None,
            poll_miss_budget=budget,
        )


class TestPollMissBudget:
    def test_absorbs_transient_misses_within_budget(self, capture_pipeline):
        failures = [
            TransientSchedulerError("a", kind=FailureKind.UNAVAILABLE),
            TransientSchedulerError("b", kind=FailureKind.CONNECTION),
        ]
        status = flaky_wait(failures, budget=2)
        assert status is not None and status.state == AppState.SUCCEEDED
        degraded = [
            e
            for e in capture_pipeline.events
            if (e.app_metadata or {}).get("transition") == "poll_degraded"
        ]
        assert len(degraded) == 2
        assert degraded[0].app_metadata["miss"] == 1
        assert degraded[0].app_metadata["kind"] == str(FailureKind.UNAVAILABLE)
        assert degraded[1].app_metadata["miss"] == 2

    def test_budget_exceeded_raises(self):
        failures = [
            TransientSchedulerError("x", kind=FailureKind.UNAVAILABLE)
            for _ in range(3)
        ]
        with pytest.raises(TransientSchedulerError):
            flaky_wait(failures, budget=2)

    def test_consecutive_semantics_reset_on_success(self):
        # default budget of 0 absorbs nothing...
        with pytest.raises(TransientSchedulerError):
            flaky_wait(
                [TransientSchedulerError("x", kind=FailureKind.UNAVAILABLE)],
                budget=0,
            )

    def test_permanent_error_always_raises(self):
        failures = [PermanentSchedulerError("auth", kind=FailureKind.AUTH)]
        with pytest.raises(PermanentSchedulerError):
            flaky_wait(failures, budget=5)


# =========================================================================
# The port's seams and the acceptance run
# =========================================================================


class TestSeams:
    def test_dryrun_without_no_lint_names_the_analyzer_item(self, runner, monkeypatch):
        monkeypatch.delenv(settings.ENV_TPX_NO_LINT)
        with pytest.raises(NotImplementedError, match=r"ROADMAP queue 1 item 2\.8"):
            runner.dryrun(simple_app(), "stub")
        with pytest.raises(NotImplementedError, match=r"item 2\.8 \(analyze/\)"):
            runner.run_component("utils.echo", ["--msg", "x"], "stub")
        # either bypass goes on as the JAX runner does past its gate
        assert runner.dryrun(simple_app(), "stub", no_lint=True).request["cfg"]["knob"] == "k0"
        monkeypatch.setenv(settings.ENV_TPX_NO_LINT, "true")
        assert runner.dryrun(simple_app(), "stub").request["cfg"]["knob"] == "k0"

    def test_supervise_names_the_supervisor_item(self, runner):
        """Item 2.4 (the supervisor) gave ``Runner.supervise`` its body: the
        port's supervisor submits the dryrun once and watches it to its
        end (the stub's app succeeds at once)."""
        from torchx_tpu_torch.supervisor import SupervisorPolicy, SupervisorResult

        info = runner.dryrun(simple_app(), "stub")
        stub = runner._scheduler("stub")
        schedule = stub.schedule

        def schedule_and_succeed(dryrun_info):  # noqa: ANN001, ANN202
            app_id = schedule(dryrun_info)
            stub.apps[app_id] = AppState.SUCCEEDED
            return app_id

        stub.schedule = schedule_and_succeed
        result = runner.supervise(info, SupervisorPolicy(poll_interval=0.01),
                                  session="seam")
        assert isinstance(result, SupervisorResult)
        assert result.succeeded and result.attempts == 1 and result.session == "seam"
        assert list(stub.apps) == ["stub_app_1"]  # one submission


def test_run_component_dist_spmd_on_the_cpu(tmp_path):
    """``dist.spmd -j 1x2`` through ``Runner.run_component`` on the local
    scheduler: one replica of two gloo workers runs the port's probe app
    (its spmd_main binding the rendezvous port itself) and SUCCEEDS."""
    env = {"PYTHONPATH": os.path.dirname(os.path.dirname(os.path.abspath(__file__)))}
    with get_runner("spmd-e2e") as runner:
        handle = runner.run_component(
            "dist.spmd",
            ["-j", "1x2", "--coordinator_port", "0", "--env",
             ",".join(f"{k}={v}" for k, v in env.items()),
             "-m", "torchx_tpu_torch.examples.compute_mesh_size"],
            "local",
            {"log_dir": str(tmp_path)},
        )
        status = runner.wait(handle, wait_interval=0.1, timeout=120)
        assert status.state == AppState.SUCCEEDED, status
        lines = list(runner.log_lines(handle, "spmd", 0))
    # two workers share the replica's stdout: their lines may interleave
    assert "\n".join(lines).count("computed_mesh_size=2") == 2, lines


# =========================================================================
# Parity: the same inputs through the JAX runner and the port's
# =========================================================================


class TestJaxParity:
    @staticmethod
    def _layout(request):
        """Each replica's fields, its log paths relative to the app's log
        root; the parent span (a fresh id in each runner) apart."""
        import dataclasses

        root, out = request.log_dir, {}
        for role, replicas in request.role_params.items():
            for i, rp in enumerate(replicas):
                fields = dataclasses.asdict(rp)
                for k in ("stdout", "stderr", "combined"):
                    fields[k] = os.path.relpath(fields[k], root)
                env = fields["env"]
                for k in (settings.ENV_TPX_LOG_DIR, settings.ENV_TPX_ERROR_FILE):
                    env[k] = os.path.relpath(env[k], root)
                assert len(env.pop(settings.ENV_TPX_PARENT_SPAN)) == 16
                out[(role, i)] = fields
        return out

    @pytest.mark.parametrize("component, args", [
        ("utils.echo", ["--msg", "hello world"]),
        ("utils.sh", ["--num_replicas", "3", "--env", "A=1", "echo", "$TPX_REPLICA_ID"]),
        ("utils.python", ["-c", "print(1)", "--num_replicas", "2"]),
        ("utils.touch", ["--file", "/tmp/x"]),
    ])
    @pytest.mark.parametrize("seed", [0, 7])
    def test_dryrun_request_equals_jax(self, component, args, seed, tmp_path, monkeypatch):
        """A CPU-only component through each runner's ``dryrun_component``
        on its local scheduler: the same app id, and per replica the same
        args, env (the trace id shared), cwd and log layout."""
        import random

        from torchx_tpu.runner import get_runner as jax_get_runner

        monkeypatch.setenv(settings.ENV_TPX_INTERNAL_SESSION_ID, "parity")
        monkeypatch.setenv(settings.ENV_TPX_TRACE_ID, "ab" * 16)
        requests = {}
        for name, make in (("jax", jax_get_runner), ("port", get_runner)):
            with make("parity") as runner:
                random.seed(seed)  # the same app id from both make_unique
                info = runner.dryrun_component(component, args, "local",
                                               {"log_dir": str(tmp_path / name)}, no_lint=True)
            requests[name] = info.request
        jreq, treq = requests["jax"], requests["port"]
        assert treq.app_id == jreq.app_id
        assert treq.log_dir == str(tmp_path / "port" / treq.app_id)
        assert self._layout(treq) == self._layout(jreq)
        assert all(rp.env[settings.ENV_TPX_TRACE_ID] == "ab" * 16
                   for rps in treq.role_params.values() for rp in rps)

    @staticmethod
    def _cache_script(mod, resp_cls, state_cls, metrics, clock):
        """One sequence of gets, puts and invalidations on ``mod``'s cache
        under ``clock``: -> [(step, returned state or error, fetched)], and
        the hits and misses the package's counters took."""
        scheduler = "parity-cache"
        h0 = metrics.DESCRIBE_CACHE_HITS.value(scheduler=scheduler)
        m0 = metrics.DESCRIBE_CACHE_MISSES.value(scheduler=scheduler)
        cache = mod.DescribeCache(ttl=5.0)
        log = []

        def get(step, app_id, state=None, fresh=False, error=False, c=cache):
            fetched = []

            def fetch():
                fetched.append(1)
                if error:
                    raise RuntimeError("control plane down")
                return None if state is None else resp_cls(app_id=app_id,
                                                           state=state_cls[state])
            try:
                resp = c.get(scheduler, app_id, fetch, fresh=fresh)
                got = None if resp is None else resp.state.name
            except RuntimeError:
                got = "error"
            log.append((step, got, bool(fetched)))

        get("first", "a1", "RUNNING")
        clock[0] = 1.0
        get("within ttl", "a1", "PENDING")
        get("fresh", "a1", "PENDING", fresh=True)
        clock[0] = 7.0
        get("past ttl", "a1", "RUNNING")
        get("gone", "a2")
        get("gone again", "a2", "RUNNING")
        cache.put(scheduler, "a1", resp_cls(app_id="a1", state=state_cls.SUCCEEDED))
        clock[0] = 100.0
        get("pinned", "a1", "RUNNING", fresh=True)
        cache.invalidate(scheduler, "a1")
        get("invalidated", "a1", "FAILED")
        get("error", "a3", error=True)
        get("after error", "a3", "RUNNING")
        cache.invalidate(scheduler)
        get("all invalidated", "a3", "PENDING")
        cache.put(scheduler, "a3", None)
        get("put none", "a3", "RUNNING")
        zero = mod.DescribeCache(ttl=0.0)
        get("ttl 0", "a4", "RUNNING", c=zero)
        get("ttl 0 again", "a4", "RUNNING", c=zero)
        return log, (metrics.DESCRIBE_CACHE_HITS.value(scheduler=scheduler) - h0,
                     metrics.DESCRIBE_CACHE_MISSES.value(scheduler=scheduler) - m0)

    def test_describe_cache_hits_and_misses_equal_jax(self, monkeypatch):
        """The same script of cache calls under one clock: the same answer
        and the same fetch at every step, the same hit and miss counts."""
        import types

        from torchx_tpu.obs import metrics as jax_metrics
        from torchx_tpu.runner import describe_cache as jax_cache
        from torchx_tpu.schedulers.api import DescribeAppResponse as JaxResp
        from torchx_tpu.specs.api import AppState as JaxState

        from torchx_tpu_torch.runner import describe_cache as port_cache

        runs = []
        for mod, resp, state, metrics in ((jax_cache, JaxResp, JaxState, jax_metrics),
                                          (port_cache, DescribeAppResponse, AppState,
                                           obs_metrics)):
            clock = [0.0]
            monkeypatch.setattr(mod, "time", types.SimpleNamespace(monotonic=lambda c=clock: c[0]))
            runs.append(self._cache_script(mod, resp, state, metrics, clock))
        (jlog, jcounts), (tlog, tcounts) = runs
        assert tlog == jlog and tcounts == jcounts
        assert [fetched for _, _, fetched in tlog] == [
            True, False, True, True, True, True, False, True, True, True, True, True, True, True]
        assert tcounts == (2, 12)
