"""The port's control plane (``torchx_tpu_torch.control``: the job-state
store, the reconciler, the daemon and its client) held to the JAX
package's own cases: ``TestJobStateStore``, ``TestReconciler``,
``TestRunnerWaitWakePath``, ``TestDescribeCachePut``, ``TestControlDaemon``
and ``TestMaybeClient`` of ``tests/test_control.py``, each run against the
copy (``TestStateEvent`` and ``TestWatchAdapters`` run in
``test_torch_control_watch.py``; ``TestControlPlaneRule`` is the analyzer's,
ROADMAP queue 1 item 2.8).

Added: parity with the JAX package on the same inputs (``TestJaxParity``:
both ``JobStateStore``s write the same records and shards for one seeded
event sequence, both reconcilers keep the same latest events, and a JAX
``ControlClient`` against the port's daemon and the port's client against
a JAX daemon get the same reply bodies on one request sequence, apart
from handles, addresses and times); the cell stamp on a job whose
terminal event the sidecar watcher delivers (``TestJournalCell``); the
CLI's proxy seam (``TestControlClientSeam``); and the acceptance run on
the CPU (``TestControlAcceptance``): ``tpx-torch control --fleet
default:h100-1x2`` in a subprocess, a job placed through ``tpx-torch run``
with ``$TPX_CONTROL_ADDR`` set and seen in ``tpx-torch queue``, a
two-stage ``tpx-torch pipeline`` (train writes a checkpoint, the port's
``eval_main`` scores it), and no process left after ``control`` stops.

The port's lint gate raises until the analyzer is ported, so an autouse
fixture sets ``TPX_NO_LINT=1``; every case keeps the local scheduler's
registry under ``tmp_path``, sees a card-less host, and starts with the
port's breakers and fault plan reset."""

import json
import os
import threading
import time
from typing import Mapping, Optional

import numpy as np
import pytest

from torchx_tpu_torch import settings
from torchx_tpu_torch.control.client import ControlClient, ControlClientError
from torchx_tpu_torch.control.daemon import ControlDaemon
from torchx_tpu_torch.control.events import StateEvent
from torchx_tpu_torch.control.reconciler import Reconciler
from torchx_tpu_torch.control.store import (
    EVENTS_FILE,
    JobStateStore,
    shard_for,
)
from torchx_tpu_torch.resilience import call as resilience_call
from torchx_tpu_torch.resilience import faults as resilience_faults
from torchx_tpu_torch.runner.api import Runner, get_runner
from torchx_tpu_torch.runner.describe_cache import DescribeCache
from torchx_tpu_torch.schedulers import local_scheduler as lsched
from torchx_tpu_torch.schedulers.api import DescribeAppResponse, ListAppResponse, Scheduler
from torchx_tpu_torch.specs.api import (
    AppDef,
    AppDryRunInfo,
    AppState,
    CfgVal,
    Role,
    parse_app_handle,
    runopts,
)
from torch_threads import xdist_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _no_lint_own_registry(tmp_path, monkeypatch):
    """The lint gate is bypassed (it raises until ROADMAP queue 1 item 2.8),
    the local scheduler's registry lives in ``tmp_path``, the host has no
    card, the control root is ``tmp_path``'s, and the port's breakers and
    fault plan start clean."""
    monkeypatch.setenv(settings.ENV_TPX_NO_LINT, "1")
    monkeypatch.setenv(settings.ENV_TPX_CONTROL_DIR, str(tmp_path / "control-root"))
    monkeypatch.delenv(settings.ENV_TPX_CONTROL_ADDR, raising=False)
    monkeypatch.setattr(lsched, "_registry_path", lambda: str(tmp_path / "registry"))
    monkeypatch.delenv(settings.ENV_CUDA_VISIBLE_DEVICES, raising=False)
    monkeypatch.setattr(lsched, "driver_gpu_count", lambda: 0)
    resilience_call.reset_breakers()
    resilience_faults.reset()


# ---------------------------------------------------------------------------
# fixtures and stubs
# ---------------------------------------------------------------------------



# ---------------------------------------------------------------------------
# fixtures and stubs
# ---------------------------------------------------------------------------


class StubScheduler(Scheduler[dict]):
    """Same shape as the runner tests' stub, plus a describe-call counter
    so cache-pinning assertions can see exactly when the backend is hit."""

    def __init__(self, session_name: str = "test", backend: str = "stub", **kwargs):
        super().__init__(backend, session_name)
        self.apps: dict[str, AppState] = {}
        self.describe_calls = 0
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
        return [ListAppResponse(app_id=a, state=s) for a, s in self.apps.items()]


class NoWatchStubScheduler(StubScheduler):
    """A backend whose watch cannot start: the reconciler must degrade
    (tracking is an optimization), and every event in these tests is
    injected deterministically via ``Reconciler.ingest``."""

    def watch(self, app_ids=(), interval=None):
        raise RuntimeError("no watch stream here")


def simple_app(**role_kwargs) -> AppDef:
    defaults = dict(name="r", image="i", entrypoint="echo", args=["hi"])
    defaults.update(role_kwargs)
    return AppDef(name="app", roles=[Role(**defaults)])


def ev(
    app_id: str,
    state: AppState,
    scheduler: str = "stub",
    with_resp: bool = False,
) -> StateEvent:
    resp = (
        DescribeAppResponse(app_id=app_id, state=state) if with_resp else None
    )
    return StateEvent(scheduler=scheduler, app_id=app_id, state=state, resp=resp)


# ---------------------------------------------------------------------------
# StateEvent
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# JobStateStore: sharding, crash safety, concurrency
# ---------------------------------------------------------------------------


class TestJobStateStore:
    def test_append_latest_snapshot(self, tmp_path):
        store = JobStateStore(str(tmp_path / "store"), shards=4)
        store.append(ev("a1", AppState.RUNNING))
        store.append(ev("a1", AppState.SUCCEEDED))
        store.append(ev("a2", AppState.PENDING))
        assert store.latest("stub", "a1").state == AppState.SUCCEEDED
        assert store.latest("stub", "ghost") is None
        assert len(store) == 2
        assert set(store.snapshot()) == {("stub", "a1"), ("stub", "a2")}

    def test_shard_for_is_stable(self):
        # CRC32, not hash(): the same key must land in the same shard in
        # every process, or rehydration would read the wrong files
        assert shard_for("local", "app_1", 8) == shard_for("local", "app_1", 8)
        assert 0 <= shard_for("local", "app_1", 8) < 8
        assert shard_for("x", "y", 1) == 0

    def test_meta_pins_shard_count_across_reopen(self, tmp_path):
        root = str(tmp_path / "store")
        store = JobStateStore(root, shards=8)
        store.append(ev("a1", AppState.RUNNING))
        # a reopen with a DIFFERENT shards argument keeps the on-disk
        # layout — otherwise lookups would scan the wrong shard set
        again = JobStateStore(root, shards=3)
        assert again.shards == 8
        assert again.latest("stub", "a1").state == AppState.RUNNING

    def test_rehydrate_on_restart(self, tmp_path):
        root = str(tmp_path / "store")
        store = JobStateStore(root)
        for i in range(20):
            store.append(ev(f"job_{i}", AppState.RUNNING))
            store.append(ev(f"job_{i}", AppState.SUCCEEDED))
        # "restart": a brand-new store over the same root
        restarted = JobStateStore(root)
        assert len(restarted) == 20
        for i in range(20):
            assert restarted.latest("stub", f"job_{i}").state == AppState.SUCCEEDED

    def test_kill9_mid_append_recovers_complete_lines(self, tmp_path):
        root = str(tmp_path / "store")
        store = JobStateStore(root, shards=2)
        store.append(ev("job_x", AppState.RUNNING))
        store.append(ev("job_x", AppState.SUCCEEDED))
        # the writer is SIGKILLed mid-append: a torn, non-JSON final line
        # in exactly the shard that owns the app
        shard = shard_for("stub", "job_x", store.shards)
        path = os.path.join(root, f"shard-{shard:02d}", EVENTS_FILE)
        with open(path, "a") as f:
            f.write('{"scheduler": "stub", "app_id": "job_x", "sta')
        restarted = JobStateStore(root)
        assert len(restarted) == 1
        assert restarted.latest("stub", "job_x").state == AppState.SUCCEEDED

    def test_concurrent_writers_and_readers(self, tmp_path):
        store = JobStateStore(str(tmp_path / "store"), shards=4)
        writers, per_writer = 4, 25
        barrier = threading.Barrier(writers + 2)
        errors: list[BaseException] = []

        def write(w: int) -> None:
            try:
                barrier.wait()
                for i in range(per_writer):
                    store.append(ev(f"w{w}_job{i}", AppState.RUNNING))
                    store.append(ev(f"w{w}_job{i}", AppState.SUCCEEDED))
            except BaseException as e:  # noqa: BLE001
                errors.append(e)

        def read() -> None:
            try:
                barrier.wait()
                for _ in range(50):
                    snap = store.snapshot()
                    # a reader must only ever see complete events
                    assert all(isinstance(e, StateEvent) for e in snap.values())
            except BaseException as e:  # noqa: BLE001
                errors.append(e)

        threads = [
            threading.Thread(target=write, args=(w,)) for w in range(writers)
        ] + [threading.Thread(target=read) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not errors
        assert len(store) == writers * per_writer
        # and what hit disk rehydrates to the same map
        assert len(JobStateStore(store.root)) == writers * per_writer


# ---------------------------------------------------------------------------

# Reconciler: journal -> cache -> wake
# ---------------------------------------------------------------------------


class TestReconciler:
    def test_ingest_journals_and_records_latest(self, tmp_path):
        store = JobStateStore(str(tmp_path / "store"))
        rec = Reconciler(store=store)
        rec.ingest(ev("a1", AppState.RUNNING))
        rec.ingest(ev("a1", AppState.SUCCEEDED))
        assert rec.latest("stub", "a1").state == AppState.SUCCEEDED
        assert store.latest("stub", "a1").state == AppState.SUCCEEDED

    def test_wait_event_returns_recorded_terminal_immediately(self):
        rec = Reconciler()
        rec.ingest(ev("a1", AppState.SUCCEEDED))
        t0 = time.monotonic()
        got = rec.wait_event("stub", "a1", timeout=10.0)
        assert got is not None and got.state == AppState.SUCCEEDED
        assert time.monotonic() - t0 < 1.0  # no wait at all

    def test_wait_event_wakes_on_new_event(self):
        rec = Reconciler()
        rec.ingest(ev("a1", AppState.RUNNING))
        threading.Timer(0.1, lambda: rec.ingest(ev("a1", AppState.FAILED))).start()
        t0 = time.monotonic()
        got = rec.wait_event("stub", "a1", timeout=10.0)
        assert got is not None and got.state == AppState.FAILED
        assert time.monotonic() - t0 < 5.0

    def test_wait_event_times_out_to_none(self):
        rec = Reconciler()
        assert rec.wait_event("stub", "nothing", timeout=0.05) is None

    def test_ingest_refreshes_bound_cache_via_writer_path(self):
        rec = Reconciler()
        cache = DescribeCache(ttl=600.0)
        rec.bind_cache(cache)
        # a confirmed event installs the response: the next read is a hit
        rec.ingest(ev("a1", AppState.SUCCEEDED, with_resp=True))
        resp = cache.get("stub", "a1", fetch=lambda: pytest.fail("not pinned"))
        assert resp.state == AppState.SUCCEEDED
        # a stream-only (unconfirmed) event invalidates instead: the next
        # reader re-fetches through the resilient seam
        rec.ingest(ev("a2", AppState.RUNNING, with_resp=True))
        rec.ingest(ev("a2", AppState.FAILED, with_resp=False))
        fetched = []
        cache.get(
            "stub",
            "a2",
            fetch=lambda: fetched.append(1)
            or DescribeAppResponse(app_id="a2", state=AppState.FAILED),
        )
        assert fetched == [1]

    def test_track_survives_watchless_backend(self):
        rec = Reconciler()
        sched = NoWatchStubScheduler()
        rec.track("stub", sched, "a1")  # must not raise
        assert not rec.has_stream("stub")

    def test_track_opens_one_stream_per_backend(self):
        rec = Reconciler()
        sched = StubScheduler()
        a1 = sched.schedule(sched._submit_dryrun(simple_app(), {}))
        a2 = sched.schedule(sched._submit_dryrun(simple_app(), {}))
        try:
            rec.track("stub", sched, a1)
            rec.track("stub", sched, a2)
            assert rec.has_stream("stub")
            assert len(rec._watchers) == 1
            sched.apps[a1] = AppState.SUCCEEDED
            sched.apps[a2] = AppState.SUCCEEDED
            # wait_event wakes per TRANSITION (a RUNNING event is a wake
            # too — Runner.wait re-polls on each); loop to terminal
            deadline = time.monotonic() + 10.0
            got = None
            while time.monotonic() < deadline:
                got = rec.wait_event("stub", a1, timeout=1.0)
                if got is not None and got.terminal:
                    break
            assert got is not None and got.state == AppState.SUCCEEDED
        finally:
            rec.close()
        assert not rec.has_stream("stub")


class TestRunnerWaitWakePath:
    def test_terminal_event_between_polls_wakes_immediately(self):
        """The regression case: a terminal event landing while ``wait``
        is paused must wake the waiter at event latency — NOT after the
        30s poll interval — and the follow-up poll must be served from
        the pinned cache entry (zero extra backend describes)."""
        sched = NoWatchStubScheduler()
        runner = Runner("wake", {"stub": lambda session_name, **kw: sched})
        rec = Reconciler()
        runner.attach_reconciler(rec)
        slept: list[float] = []
        try:
            handle = runner.run(simple_app(), "stub")
            _, _, app_id = parse_app_handle(handle)

            def finish():
                sched.apps[app_id] = AppState.SUCCEEDED
                rec.ingest(
                    StateEvent(
                        scheduler="stub",
                        app_id=app_id,
                        state=AppState.SUCCEEDED,
                        resp=DescribeAppResponse(
                            app_id=app_id, state=AppState.SUCCEEDED
                        ),
                    )
                )
                # cache-pinning check: no describe may happen after this
                sched.describe = lambda app_id: pytest.fail(
                    "terminal poll was not served from the pinned cache"
                )

            threading.Timer(0.2, finish).start()
            t0 = time.monotonic()
            status = runner.wait(
                handle, wait_interval=30, sleep=lambda s: slept.append(s)
            )
            elapsed = time.monotonic() - t0
        finally:
            runner.close()
        assert status is not None and status.state == AppState.SUCCEEDED
        assert elapsed < 10.0, f"waiter slept out the poll interval ({elapsed}s)"
        # the pause rode the condition variable, never plain sleep
        assert slept == []

    def test_watch_driven_terminal_pins_cache_like_fresh_wait(self):
        """Describe-cache coherence satellite: a watch-confirmed terminal
        goes through the SAME writer path as ``wait(fresh=True)`` — pinned
        forever, shared by every later reader, no second cache."""
        sched = NoWatchStubScheduler()
        runner = Runner("pin", {"stub": lambda session_name, **kw: sched})
        rec = Reconciler()
        runner.attach_reconciler(rec)
        try:
            handle = runner.run(simple_app(), "stub")
            _, _, app_id = parse_app_handle(handle)
            sched.apps[app_id] = AppState.SUCCEEDED
            rec.ingest(
                StateEvent(
                    scheduler="stub",
                    app_id=app_id,
                    state=AppState.SUCCEEDED,
                    resp=DescribeAppResponse(
                        app_id=app_id, state=AppState.SUCCEEDED
                    ),
                )
            )
            before = sched.describe_calls
            for _ in range(5):
                assert runner.status(handle).state == AppState.SUCCEEDED
            assert runner.status(handle, fresh=True).state == AppState.SUCCEEDED
            assert sched.describe_calls == before
        finally:
            runner.close()

    def test_wait_without_reconciler_still_polls(self):
        sched = StubScheduler()
        runner = Runner("plain", {"stub": lambda session_name, **kw: sched})
        try:
            handle = runner.run(simple_app(), "stub")
            _, _, app_id = parse_app_handle(handle)
            threading.Timer(
                0.1, lambda: sched.apps.__setitem__(app_id, AppState.SUCCEEDED)
            ).start()
            status = runner.wait(handle, wait_interval=0.05)
            assert status.state == AppState.SUCCEEDED
        finally:
            runner.close()


# ---------------------------------------------------------------------------
# DescribeCache.put: the watch writer path
# ---------------------------------------------------------------------------


class TestDescribeCachePut:
    def test_put_terminal_pins_forever(self):
        cache = DescribeCache(ttl=0.0)  # ttl 0: nothing non-terminal survives
        cache.put(
            "s", "a", DescribeAppResponse(app_id="a", state=AppState.FAILED)
        )
        resp = cache.get("s", "a", fetch=lambda: pytest.fail("pinned"))
        assert resp.state == AppState.FAILED
        resp = cache.get(
            "s", "a", fetch=lambda: pytest.fail("pinned"), fresh=True
        )
        assert resp.state == AppState.FAILED

    def test_put_none_drops_entry(self):
        cache = DescribeCache(ttl=600.0)
        cache.put(
            "s", "a", DescribeAppResponse(app_id="a", state=AppState.RUNNING)
        )
        cache.put("s", "a", None)
        fetched = []
        cache.get(
            "s",
            "a",
            fetch=lambda: fetched.append(1)
            or DescribeAppResponse(app_id="a", state=AppState.RUNNING),
        )
        assert fetched == [1]

    def test_put_matches_fresh_get_writer_semantics(self):
        """Parity: installing a terminal via put() leaves the cache in the
        same state as a wait-loop get(fresh=True) that fetched it."""
        terminal = DescribeAppResponse(app_id="a", state=AppState.SUCCEEDED)
        via_get = DescribeCache(ttl=0.0)
        via_get.get("s", "a", fetch=lambda: terminal, fresh=True)
        via_put = DescribeCache(ttl=0.0)
        via_put.put("s", "a", terminal)
        for cache in (via_get, via_put):
            got = cache.get(
                "s", "a", fetch=lambda: pytest.fail("not pinned"), fresh=True
            )
            assert got is terminal


# ---------------------------------------------------------------------------
# the daemon
# ---------------------------------------------------------------------------


@pytest.fixture
def daemon(tmp_path, monkeypatch):
    monkeypatch.setenv("TPX_WATCH_INTERVAL", "0.05")
    d = ControlDaemon(
        runner=get_runner("ctl-test"),
        state_dir=str(tmp_path / "control"),
        tenant_cap=2,
    ).start()
    yield d
    d.close()
    d.runner.close()


class TestControlDaemon:
    def test_healthz_and_discovery(self, daemon):
        client = ControlClient(daemon.addr, daemon.root_token)
        health = client.healthz()
        assert health["status"] == "ok" and health["tenant_cap"] == 2
        with open(daemon.discovery_path()) as f:
            doc = json.load(f)
        assert doc["addr"] == daemon.addr and doc["token"] == daemon.root_token
        mode = os.stat(daemon.discovery_path()).st_mode & 0o777
        assert mode == 0o600  # the token IS the auth boundary

    def test_submit_watch_wait_roundtrip(self, daemon, tmp_path):
        client = ControlClient(daemon.addr, daemon.root_token)
        handle = client.submit(
            "utils.echo",
            ["--msg", "from-the-daemon"],
            "local",
            cfg={"log_dir": str(tmp_path / "logs")},
        )
        assert handle.startswith("local://")
        final = client.wait(handle, timeout=60)
        assert final["state"] == "SUCCEEDED" and final["terminal"]
        # the journal holds the lifecycle (fleet list needs no backend)
        _, _, app_id = parse_app_handle(handle)
        journaled = daemon.store.latest("local", app_id)
        assert journaled is not None
        apps = client.list()
        assert any(a["app_id"] == app_id for a in apps)
        # log attach through the daemon
        lines = list(client.log_lines(handle, "echo", k=0))
        assert any("from-the-daemon" in ln for ln in lines)

    def test_status_unknown_handle_404(self, daemon):
        client = ControlClient(daemon.addr, daemon.root_token)
        with pytest.raises(ControlClientError) as ei:
            client.status("local://ctl-test/ghost_app")
        assert ei.value.code == 404

    def test_bad_token_401(self, daemon):
        client = ControlClient(daemon.addr, "not-a-token")
        with pytest.raises(ControlClientError) as ei:
            client.status("local://ctl-test/anything")
        assert ei.value.code == 401

    def test_session_minting_is_root_only(self, daemon):
        root = ControlClient(daemon.addr, daemon.root_token)
        tenant_token = root.mint_session("team-a")
        tenant = ControlClient(daemon.addr, tenant_token)
        with pytest.raises(ControlClientError) as ei:
            tenant.mint_session("team-b")
        assert ei.value.code == 403

    def test_tenant_cap_429(self, daemon, tmp_path):
        root = ControlClient(daemon.addr, daemon.root_token)
        tenant = ControlClient(daemon.addr, root.mint_session("team-cap"))
        handles = [
            tenant.submit(
                "utils.sh",
                ["sleep", "30"],
                "local",
                cfg={"log_dir": str(tmp_path / f"cap{i}")},
            )
            for i in range(2)
        ]
        try:
            with pytest.raises(ControlClientError) as ei:
                tenant.submit(
                    "utils.sh",
                    ["sleep", "30"],
                    "local",
                    cfg={"log_dir": str(tmp_path / "cap-over")},
                )
            assert ei.value.code == 429
            assert "cap" in ei.value.message
            # the cap is PER tenant: root is not throttled by team-cap
            other = root.submit(
                "utils.echo",
                ["--msg", "hi"],
                "local",
                cfg={"log_dir": str(tmp_path / "other")},
            )
            assert other.startswith("local://")
        finally:
            for h in handles:
                tenant.cancel(h)

    def test_metricz_counts_control_ops(self, daemon):
        client = ControlClient(daemon.addr, daemon.root_token)
        client.healthz()
        client.list()
        import urllib.request

        with urllib.request.urlopen(daemon.addr + "/metricz", timeout=10) as r:
            text = r.read().decode()
        assert "tpx_control_requests_total" in text
        assert 'op="list"' in text

    def test_restart_rehydrates_journal(self, daemon, tmp_path):
        client = ControlClient(daemon.addr, daemon.root_token)
        handle = client.submit(
            "utils.echo",
            ["--msg", "durable"],
            "local",
            cfg={"log_dir": str(tmp_path / "logs")},
        )
        client.wait(handle, timeout=60)
        _, _, app_id = parse_app_handle(handle)
        state_dir = daemon.state_dir
        daemon.close()
        # a brand-new daemon over the same state dir knows the job before
        # making a single backend call
        runner2 = get_runner("ctl-test-2")
        d2 = ControlDaemon(runner=runner2, state_dir=state_dir)
        try:
            assert d2.store.latest("local", app_id) is not None
        finally:
            d2.close()
            runner2.close()

    def test_bad_submit_is_a_clean_400(self, daemon):
        client = ControlClient(daemon.addr, daemon.root_token)
        with pytest.raises(ControlClientError) as ei:
            client.submit("not.a.component", [], "local")
        assert ei.value.code == 400


class TestMaybeClient:
    def test_addr_without_token_raises_401(self, monkeypatch, tmp_path):
        from torchx_tpu_torch.control.client import maybe_client

        monkeypatch.setenv("TPX_CONTROL_ADDR", "http://127.0.0.1:1")
        monkeypatch.delenv("TPX_CONTROL_TOKEN", raising=False)
        monkeypatch.setenv("TPX_CONTROL_DIR", str(tmp_path / "nowhere"))
        with pytest.raises(ControlClientError) as ei:
            maybe_client()
        assert ei.value.code == 401

    def test_unset_means_direct_mode(self, monkeypatch, tmp_path):
        from torchx_tpu_torch.control.client import maybe_client

        monkeypatch.delenv("TPX_CONTROL_ADDR", raising=False)
        monkeypatch.setenv("TPX_CONTROL_DIR", str(tmp_path / "nowhere"))
        assert maybe_client() is None

    def test_discovery_file_resolves_token(self, monkeypatch, tmp_path):
        from torchx_tpu_torch.control.client import maybe_client

        control_dir = tmp_path / "control"
        control_dir.mkdir()
        (control_dir / "control.json").write_text(
            json.dumps(
                {"addr": "http://127.0.0.1:7777", "token": "tok", "pid": 1}
            )
        )
        monkeypatch.setenv("TPX_CONTROL_DIR", str(control_dir))
        monkeypatch.setenv("TPX_CONTROL_ADDR", "http://127.0.0.1:7777")
        monkeypatch.delenv("TPX_CONTROL_TOKEN", raising=False)
        client = maybe_client()
        assert client is not None and client.token == "tok"


# ---------------------------------------------------------------------------
# the cell on every journal record
# ---------------------------------------------------------------------------


def wait_journal_terminal(daemon, app_id: str, timeout: float = 30.0) -> StateEvent:
    """The job's last journal record once it is terminal (the sidecar
    watcher's event lands after ``/v1/wait`` may have returned)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        event = daemon.store.latest("local", app_id)
        if event is not None and event.terminal:
            return event
        time.sleep(0.02)
    raise AssertionError(f"no terminal record for {app_id}: {event}")


class TestJournalCell:
    def test_reconciler_stamps_its_cell_on_unstamped_events(self, tmp_path):
        store = JobStateStore(str(tmp_path / "store"))
        rec = Reconciler(store=store, cell="us-east1")
        rec.ingest(ev("a1", AppState.RUNNING))
        rec.ingest(StateEvent("stub", "a2", AppState.RUNNING, cell="eu-west4"))
        assert store.latest("stub", "a1").cell == "us-east1"
        assert rec.latest("stub", "a1").cell == "us-east1"
        # an event that names its cell keeps it
        assert store.latest("stub", "a2").cell == "eu-west4"
        # without a cell the reconciler keeps events as they come
        plain = Reconciler(store=JobStateStore(str(tmp_path / "plain")))
        plain.ingest(ev("a3", AppState.RUNNING))
        assert plain.store.latest("stub", "a3").cell == ""

    def test_sidecar_terminal_record_carries_the_daemon_cell(self, tmp_path, monkeypatch):
        """The JAX daemon journals the sidecar watcher's terminal event
        with ``cell=''`` (ROADMAP queue 3); the port's reconciler stamps
        the daemon's cell on it, so every record of the job carries it."""
        monkeypatch.setenv("TPX_WATCH_INTERVAL", "0.05")
        d = ControlDaemon(runner=get_runner("ctl-cell"), state_dir=str(tmp_path / "control"),
                          cell="us-east1").start()
        try:
            client = ControlClient(d.addr, d.root_token)
            handle = client.submit("utils.echo", ["--msg", "stamped"], "local",
                                   cfg={"log_dir": str(tmp_path / "logs")})
            assert client.wait(handle, timeout=60)["state"] == "SUCCEEDED"
            _, _, app_id = parse_app_handle(handle)
            event = wait_journal_terminal(d, app_id)
            assert event.source == "sidecar" and event.cell == "us-east1"
            shard = shard_for("local", app_id, d.store.shards)
            path = os.path.join(d.store.root, f"shard-{shard:02d}", EVENTS_FILE)
            with open(path) as f:
                records = [json.loads(line) for line in f]
            mine = [r for r in records if r["app_id"] == app_id]
            assert [r["source"] for r in mine][0] == "daemon" and len(mine) >= 2
            assert {r.get("cell") for r in mine} == {"us-east1"}
        finally:
            d.close()
            d.runner.close()


class TestWaitRidesTheStream:
    def test_wait_returns_on_the_terminal_event(self, tmp_path, monkeypatch):
        """``/v1/wait`` wakes on the sidecar watcher's terminal event, not
        on its 2 s status poll (the JAX daemon's, copied): with a 0.05 s
        watch tick the wait returns well inside one poll period of the
        replica's exit, and the scheduler is described no more often than
        the poll and the watcher's confirming describes account for."""
        monkeypatch.setenv("TPX_WATCH_INTERVAL", "0.05")
        d = ControlDaemon(runner=get_runner("ctl-wait"),
                          state_dir=str(tmp_path / "control")).start()
        try:
            client = ControlClient(d.addr, d.root_token)
            sched = d.runner._scheduler("local")
            calls = []
            describe = sched.describe
            monkeypatch.setattr(sched, "describe",
                                lambda app_id: calls.append(app_id) or describe(app_id))
            handle = client.submit("utils.sh", ["sleep", "3"], "local",
                                   cfg={"log_dir": str(tmp_path / "logs")})
            calls.clear()
            t0 = time.monotonic()
            assert client.wait(handle, timeout=60)["state"] == "SUCCEEDED"
            returned, waited = time.time(), time.monotonic() - t0
            app_id = parse_app_handle(handle)[2]
            event = d.reconciler.latest("local", app_id)
            assert event is not None and event.terminal and event.source == "sidecar"
            (replica,) = sched._apps[app_id].request.role_params["sh"]
            exited = os.path.getmtime(os.path.join(os.path.dirname(replica.stdout),
                                                   lsched.EXITCODE_FILE))
            assert returned - exited < 1.0
            assert len(calls) <= waited / 2.0 + 4, calls
        finally:
            d.close()
            d.runner.close()


# ---------------------------------------------------------------------------
# the CLI's proxy seam
# ---------------------------------------------------------------------------


class TestControlClientSeam:
    def test_unset_addr_is_direct_mode(self):
        from torchx_tpu_torch.cli.cmd_base import control_client

        assert control_client() is None

    def test_addr_without_token_exits_1(self, monkeypatch, capsys):
        from torchx_tpu_torch.cli.cmd_base import control_client

        monkeypatch.setenv(settings.ENV_TPX_CONTROL_ADDR, "http://127.0.0.1:1")
        monkeypatch.delenv(settings.ENV_TPX_CONTROL_TOKEN, raising=False)
        with pytest.raises(SystemExit) as ei:
            control_client()
        assert ei.value.code == 1
        assert "control:" in capsys.readouterr().err

    def test_control_dir_is_the_ports_own_root(self, monkeypatch, tmp_path):
        """A port CLI never finds a JAX daemon's discovery file (or the
        other way round): the default roots differ, ``$TPX_CONTROL_DIR``
        overrides both."""
        from torchx_tpu.control.daemon import control_dir as jax_control_dir
        from torchx_tpu_torch.control.daemon import control_dir

        monkeypatch.delenv(settings.ENV_TPX_CONTROL_DIR)
        monkeypatch.setenv("HOME", str(tmp_path))
        assert control_dir() == str(tmp_path / ".torchx_tpu_torch" / "control")
        assert jax_control_dir() == str(tmp_path / ".torchx_tpu" / "control")
        monkeypatch.setenv(settings.ENV_TPX_CONTROL_DIR, str(tmp_path / "x"))
        assert control_dir() == jax_control_dir() == str(tmp_path / "x")


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------


def seeded_events(seed: int, n: int = 120):
    """(scheduler, app_id, state name, source, time_usec, cell) tuples."""
    rng = np.random.default_rng(seed)
    states = ["SUBMITTED", "PENDING", "RUNNING", "SUCCEEDED", "FAILED", "CANCELLED", "UNKNOWN"]
    out = []
    for i in range(n):
        out.append((
            ["local", "gke", "slurm"][int(rng.integers(3))],
            f"app_{int(rng.integers(40))}",
            states[int(rng.integers(len(states)))],
            ["sidecar", "poll", "kubectl", "daemon"][int(rng.integers(4))],
            1_700_000_000_000_000 + i * 1000 + int(rng.integers(1000)),
            ["", "us-east1"][int(rng.integers(2))],
        ))
    return out


def shard_bytes(root: str) -> dict:
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


VOLATILE = {"handle", "app_id", "addr", "time_usec", "token"}


def normalized(doc):
    """A reply body with handles, addresses, times and tokens masked."""
    if isinstance(doc, dict):
        return {k: (f"<{k}>" if k in VOLATILE else normalized(v)) for k, v in doc.items()}
    if isinstance(doc, list):
        return [normalized(v) for v in doc]
    if isinstance(doc, str) and "://" in doc:
        return "<handle>"
    return doc


def request_sequence(client_cls, error_cls, daemon, log_dir: str) -> list:
    """One fixed request sequence through ``client_cls`` against ``daemon``:
    every reply body (or error code and message), normalized."""
    root = client_cls(daemon.addr, daemon.root_token)
    out = [root.healthz()]
    token = root.mint_session("team-a")
    out.append(("token", type(token).__name__, len(token)))
    tenant = client_cls(daemon.addr, token)
    handle = tenant.submit("utils.echo", ["--msg", "parity"], "local", cfg={"log_dir": log_dir})
    out.append(handle.split("://")[0])
    out.append(tenant.wait(handle, timeout=60))
    out.append(tenant.status(handle))
    _, _, app_id = parse_app_handle(handle)
    wait_journal_terminal(daemon, app_id)
    out.append(root.list())
    out.append(root.queue())
    out.append(root.alerts())
    out.append(root.pipeline_status())
    out.append(root.cell_status())
    out.append(list(tenant.log_lines(handle, "echo", k=0)))
    for call in (
        lambda: tenant.status("local://nobody/ghost_app"),
        lambda: client_cls(daemon.addr, "not-a-token").list(),
        lambda: tenant.mint_session("team-b"),
        lambda: tenant.pipeline_status("pl_404"),
    ):
        try:
            call()
            out.append("no error")
        except error_cls as e:
            out.append((e.code, e.message.replace("local://nobody/ghost_app", "<handle>")))
    try:
        tenant.submit("not.a.component", [], "local")
        out.append("no error")
    except error_cls as e:
        out.append(e.code)
    return normalized(out)


class TestJaxParity:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_stores_write_equal_records_and_shards(self, tmp_path, seed):
        from torchx_tpu.control.events import StateEvent as JStateEvent
        from torchx_tpu.control.store import JobStateStore as JStore
        from torchx_tpu.specs.api import AppState as JAppState

        port = JobStateStore(str(tmp_path / "port"), shards=4)
        jax_ = JStore(str(tmp_path / "jax"), shards=4)
        for sched, app, state, source, t, cell in seeded_events(seed):
            port.append(StateEvent(sched, app, AppState[state], source, t, cell=cell))
            jax_.append(JStateEvent(sched, app, JAppState[state], source, t, cell=cell))
        assert shard_bytes(port.root) == shard_bytes(jax_.root)
        assert {k: e.serialize() for k, e in JobStateStore(port.root).snapshot().items()} == {
            k: e.serialize() for k, e in JStore(jax_.root).snapshot().items()
        }

    def test_reconcilers_keep_equal_latest_events(self, tmp_path):
        from torchx_tpu.control.events import StateEvent as JStateEvent
        from torchx_tpu.control.reconciler import Reconciler as JReconciler
        from torchx_tpu.specs.api import AppState as JAppState

        port, jax_ = Reconciler(), JReconciler()
        keys = set()
        for sched, app, state, source, t, cell in seeded_events(2):
            port.ingest(StateEvent(sched, app, AppState[state], source, t, cell=cell))
            jax_.ingest(JStateEvent(sched, app, JAppState[state], source, t, cell=cell))
            keys.add((sched, app))
        for sched, app in sorted(keys):
            assert port.latest(sched, app).serialize() == jax_.latest(sched, app).serialize()

    def test_clients_and_daemons_answer_alike(self, tmp_path, monkeypatch):
        """A JAX client against the port's daemon and the port's client
        against a JAX daemon: the same reply bodies, handles and times
        apart."""
        from torchx_tpu.control.client import ControlClient as JClient
        from torchx_tpu.control.client import ControlClientError as JClientError
        from torchx_tpu.control.daemon import ControlDaemon as JDaemon
        from torchx_tpu.runner.api import get_runner as jax_get_runner

        monkeypatch.setenv("TPX_WATCH_INTERVAL", "0.05")
        port_d = ControlDaemon(runner=get_runner("parity-port"), cell="c1",
                               state_dir=str(tmp_path / "port")).start()
        try:
            via_port = request_sequence(JClient, JClientError, port_d, str(tmp_path / "lp"))
        finally:
            port_d.close()
            port_d.runner.close()
        jax_d = JDaemon(runner=jax_get_runner("parity-jax"), cell="c1",
                        state_dir=str(tmp_path / "jax")).start()
        try:
            via_jax = request_sequence(ControlClient, ControlClientError, jax_d,
                                       str(tmp_path / "lj"))
        finally:
            jax_d.close()
            jax_d.runner.close()
        assert via_port == via_jax
        # the run really happened on both sides
        assert via_port[3]["state"] == "SUCCEEDED"
        assert any("parity" in line for line in via_port[10])


# ---------------------------------------------------------------------------
# acceptance: the commands end to end on the CPU
# ---------------------------------------------------------------------------


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


TRAIN_CODE = (
    "import hashlib,json,os,sys\n"
    "ckpt=sys.argv[1]\n"
    "p=os.path.join(ckpt,'1'); os.makedirs(p,exist_ok=True)\n"
    "fp=os.path.join(p,'w.bin')\n"
    "open(fp,'wb').write(b'weights-accept')\n"
    "h=hashlib.sha256()\n"
    "h.update(os.path.relpath(fp,p).encode())\n"
    "h.update(open(fp,'rb').read())\n"
    "json.dump({'latest_step':1,'steps':{'1':{'digest':h.hexdigest()}}},"
    "open(os.path.join(ckpt,'MANIFEST.json'),'w'))\n"
)


class TestControlAcceptance:
    def test_fleet_daemon_places_a_run_and_runs_a_pipeline(self, tmp_path):
        """``tpx-torch control --fleet default:h100-1x2`` in a subprocess;
        ``tpx-torch run`` with ``$TPX_CONTROL_ADDR`` set places a job that
        ``tpx-torch queue`` shows running; a two-stage ``tpx-torch
        pipeline`` (train writes a checkpoint, ``eval_main`` scores it)
        succeeds; on Ctrl-C the daemon exits and leaves no process."""
        import signal
        import subprocess
        import sys

        state = tmp_path / "ctl"
        env = dict(os.environ, PYTHONPATH=REPO, TPX_NO_LINT="1", HOME=str(tmp_path),
                   TPX_WATCH_INTERVAL="0.05", TPX_CONTROL_DIR=str(state))
        env.pop(settings.ENV_TPX_CONTROL_ADDR, None)
        cli = [sys.executable, "-m", "torchx_tpu_torch.cli.main"]
        daemon = subprocess.Popen(
            cli + ["control", "--fleet", "default:h100-1x2", "--state-dir", str(state)],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            start_new_session=True)
        run = None
        try:
            lines = []
            addr = ""
            while not addr:
                line = daemon.stdout.readline()
                assert line, (lines, daemon.poll())
                lines.append(line)
                if "export TPX_CONTROL_ADDR=" in line:
                    addr = line.split("=", 1)[1].strip()
            assert any("fleet: 2 GPUs in 1 pool(s)" in ln for ln in lines), lines
            proxied = dict(env, TPX_CONTROL_ADDR=addr)
            mark = tmp_path / "release"
            run = subprocess.Popen(
                cli + ["run", "-s", "local", "-cfg", f"log_dir={tmp_path / 'logs'}",
                       "utils.sh", "sh", "-c",
                       f"while [ ! -e {mark} ]; do sleep 0.05; done; echo placed-run"],
                cwd=REPO, env=proxied, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)
            deadline = time.monotonic() + 60
            snap = {}
            while time.monotonic() < deadline:
                q = subprocess.run(cli + ["queue", "--json"], cwd=REPO, env=proxied,
                                   capture_output=True, text=True, timeout=60)
                assert q.returncode == 0, q.stderr
                snap = json.loads(q.stdout)
                if snap["running"]:
                    break
                time.sleep(0.1)
            (placed,) = snap["running"]
            assert placed["handle"].startswith("local://") and placed["replicas"] == 1
            assert snap["fleet"]["chips_total"] == 2 and snap["fleet"]["chips_free"] == 1
            text = subprocess.run(cli + ["queue"], cwd=REPO, env=proxied,
                                  capture_output=True, text=True, timeout=60).stdout
            assert "1/2 GPUs free" in text and placed["job"] in text
            mark.touch()
            out, err = run.communicate(timeout=120)
            assert run.returncode == 0, err
            assert f"{placed['handle']}: SUCCEEDED" in out

            ckpt, score = tmp_path / "ckpt", tmp_path / "score.json"
            spec = {"name": "accept", "stages": [
                {"name": "train", "kind": "train", "component": "utils.python",
                 "args": ["-c", TRAIN_CODE, str(ckpt)], "ckpt_dir": str(ckpt),
                 "cfg": {"log_dir": str(tmp_path / "pl-logs")}},
                {"name": "eval", "kind": "eval", "component": "utils.python",
                 "args": ["-m", "torchx_tpu_torch.apps.eval_main", "--", "--ckpt",
                          "{train.path}", "--out", str(score)],
                 "depends_on": ["train"], "score_file": str(score),
                 "cfg": {"log_dir": str(tmp_path / "pl-logs")}},
            ]}
            spec_path = tmp_path / "spec.json"
            spec_path.write_text(json.dumps(spec))
            sub = subprocess.run(cli + ["pipeline", "submit", "-f", str(spec_path)],
                                 cwd=REPO, env=proxied, capture_output=True, text=True,
                                 timeout=60)
            assert sub.returncode == 0, sub.stderr
            pid = sub.stdout.strip()
            deadline = time.monotonic() + 90
            doc = {}
            while time.monotonic() < deadline:
                st = subprocess.run(cli + ["pipeline", "status", pid, "--json"], cwd=REPO,
                                    env=proxied, capture_output=True, text=True, timeout=60)
                doc = json.loads(st.stdout)
                if doc["state"] in ("SUCCEEDED", "FAILED", "CANCELLED"):
                    break
                time.sleep(0.2)
            assert doc["state"] == "SUCCEEDED", doc
            stages = {s["name"]: s for s in doc["stages"]}
            assert stages["train"]["artifact"]["step"] == 1
            scored = json.loads(score.read_text())
            assert scored["digest"] == stages["train"]["artifact"]["digest"]
            assert stages["eval"]["artifact"]["score"] == scored["score"]

            daemon.send_signal(signal.SIGINT)
            out, err = daemon.communicate(timeout=60)
            assert daemon.returncode == 0, err
            assert "shutting down" in err
            assert not (state / "control.json").exists()
            deadline = time.monotonic() + 10
            while group_pids(daemon.pid) and time.monotonic() < deadline:
                time.sleep(0.1)
            assert group_pids(daemon.pid) == []
        finally:
            for p in (run, daemon):
                if p is not None and p.poll() is None:
                    p.kill()
                    p.communicate()
