"""The port's watch streams (``torchx_tpu_torch.control``): the
``TestStateEvent`` and ``TestWatchAdapters`` cases of
``tests/test_control.py`` run against the copy (the two that launch a job
do it through the port's runner, as the JAX cases do), and the copy held
to the JAX
package's ``torchx_tpu.control`` on the same seeded inputs: event records,
the kubectl stream parser and the JobSet state mapping. The rest of that
file (the client, daemon, reconciler and store) runs in
``test_torch_control.py``."""

import json
import random
import threading
import time
from typing import Mapping, Optional

import pytest

from torchx_tpu.control import events as jevents
from torchx_tpu.control import watch as jwatch
from torchx_tpu.specs import api as jspecs
from torchx_tpu_torch.control.events import StateEvent, event_from_describe
from torchx_tpu_torch.control.watch import (
    KubectlWatcher,
    LocalSidecarWatcher,
    PollWatcher,
    _iter_json_docs,
    jobset_watch_state,
)
from torchx_tpu_torch.obs import metrics as obs_metrics
from torchx_tpu_torch.schedulers import local_scheduler as lsched
from torchx_tpu_torch.schedulers.api import DescribeAppResponse, ListAppResponse, Scheduler
from torchx_tpu_torch.specs.api import (
    AppDef,
    AppDryRunInfo,
    AppState,
    CfgVal,
    Role,
    runopts,
)
from torch_threads import xdist_torch_threads  # noqa: F401


@pytest.fixture(autouse=True)
def _registry(tmp_path, monkeypatch):
    """The local scheduler's per-user app registry lives in ``tmp_path``."""
    monkeypatch.setattr(lsched, "_registry_path", lambda: str(tmp_path / "registry"))


def run_local_echo(msg: str, log_dir: str):
    """The ``utils.echo`` component run through the port's runner on its
    local scheduler, as the JAX cases run it (``no_lint``: the port's lint
    gate waits for ROADMAP queue 1 item 2.8): -> (the runner's local
    scheduler, app id); closing the scheduler closes all the runner holds."""
    from torchx_tpu_torch.runner.api import get_runner
    from torchx_tpu_torch.specs.api import parse_app_handle

    runner = get_runner("watch-e2e")
    handle = runner.run_component("utils.echo", ["--msg", msg], "local",
                                  {"log_dir": log_dir}, no_lint=True)
    return runner._scheduler("local"), parse_app_handle(handle)[2]


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


class TestStateEvent:
    def test_serialize_roundtrip(self):
        e = ev("a1", AppState.SUCCEEDED, with_resp=True)
        back = StateEvent.deserialize(json.loads(json.dumps(e.serialize())))
        assert (back.scheduler, back.app_id, back.state) == (
            "stub",
            "a1",
            AppState.SUCCEEDED,
        )
        assert back.terminal and back.resp is None  # resp never journaled

    def test_unknown_state_name_degrades(self):
        doc = {"scheduler": "s", "app_id": "a", "state": "FROM_THE_FUTURE"}
        assert StateEvent.deserialize(doc).state == AppState.UNKNOWN

    def test_event_from_none_describe_is_unknown(self):
        e = event_from_describe("stub", "ghost", None)
        assert e.state == AppState.UNKNOWN and e.resp is None

# ---------------------------------------------------------------------------
# Watch adapters: parity across backends
# ---------------------------------------------------------------------------


def collect_events(watcher, timeout: float = 20.0) -> list:
    """Drain ``events(follow=False)`` with a watchdog that closes the
    stream rather than hanging the suite."""
    out: list = []
    killer = threading.Timer(timeout, watcher.close)
    killer.start()
    try:
        out.extend(watcher.events(follow=False))
    finally:
        killer.cancel()
        watcher.close()
    return out


class TestWatchAdapters:
    def test_poll_watcher_emits_transitions(self):
        sched = StubScheduler()
        handle_state = sched.apps
        app_id = sched.schedule(sched._submit_dryrun(simple_app(), {}))
        watcher = PollWatcher(sched, [app_id], interval=0.02)
        threading.Timer(
            0.15, lambda: handle_state.__setitem__(app_id, AppState.SUCCEEDED)
        ).start()
        events = collect_events(watcher)
        assert [e.state for e in events] == [AppState.RUNNING, AppState.SUCCEEDED]
        assert all(e.source == "poll" and e.resp is not None for e in events)

    def test_poll_watcher_dedups_unchanged_state(self):
        sched = StubScheduler()
        app_id = sched.schedule(sched._submit_dryrun(simple_app(), {}))
        watcher = PollWatcher(sched, [app_id], interval=0.01)
        gen = watcher.events(follow=True)
        assert next(gen).state == AppState.RUNNING
        # several more scans with no state change yield nothing new
        calls_before = sched.describe_calls
        time.sleep(0.1)
        sched.apps[app_id] = AppState.FAILED
        assert next(gen).state == AppState.FAILED
        assert sched.describe_calls > calls_before  # it DID keep scanning
        watcher.close()

    def test_poll_watcher_describe_error_keeps_watching(self):
        sched = StubScheduler()
        app_id = sched.schedule(sched._submit_dryrun(simple_app(), {}))
        real_describe = sched.describe
        state = {"boom": True}

        def flaky(app_id):
            if state["boom"]:
                raise RuntimeError("control plane wobble")
            return real_describe(app_id)

        sched.describe = flaky
        watcher = PollWatcher(sched, [app_id], interval=0.02)

        def heal():
            state["boom"] = False
            sched.apps[app_id] = AppState.SUCCEEDED

        threading.Timer(0.15, heal).start()
        events = collect_events(watcher)
        # errors were absorbed; the stream delivered the terminal event
        assert events[-1].state == AppState.SUCCEEDED

    def test_poll_watcher_forgotten_app_ends_as_unknown(self):
        sched = StubScheduler()
        watcher = PollWatcher(sched, ["never_submitted"], interval=0.01)
        events = collect_events(watcher)
        assert [e.state for e in events] == [AppState.UNKNOWN]

    def test_local_sidecar_watcher_real_job(self, tmp_path, monkeypatch):
        monkeypatch.setenv("TPX_WATCH_INTERVAL", "0.05")
        sched, app_id = run_local_echo("watched", str(tmp_path))
        try:
            assert sched.capabilities.watch
            watcher = sched.watch([app_id])
            assert isinstance(watcher, LocalSidecarWatcher)
            events = collect_events(watcher)
            assert events, "sidecar watcher emitted nothing"
            assert events[-1].state == AppState.SUCCEEDED
            assert events[-1].source == "sidecar"
            assert events[-1].resp is not None  # confirmed via describe
        finally:
            sched.close()

    def test_kubectl_watcher_fake_stream(self):
        sched = StubScheduler(backend="gke")
        sched.apps["ns:j1"] = AppState.RUNNING

        running_doc = json.dumps({"metadata": {"name": "j1"}, "status": {}})
        done_doc = json.dumps(
            {
                "metadata": {"name": "j1"},
                "status": {
                    "conditions": [{"type": "Completed", "status": "True"}]
                },
            }
        )

        class FakeProc:
            stdout = [running_doc, "\n", done_doc]

            def terminate(self):
                pass

        spawned: list[list[str]] = []

        def spawn(cmd):
            spawned.append(cmd)
            # the terminal doc must find describe already terminal
            sched.apps["ns:j1"] = AppState.SUCCEEDED
            return FakeProc()

        watcher = KubectlWatcher(sched, ["ns:j1"], interval=0.02, spawn=spawn)
        events = collect_events(watcher)
        assert spawned and "-n" in spawned[0] and "ns" in spawned[0]
        assert events[-1].state == AppState.SUCCEEDED
        # terminal line was CONFIRMED through describe (authoritative
        # classification), so it carries the response
        assert events[-1].resp is not None
        assert events[-1].source in ("kubectl", "poll")

    def test_kubectl_watcher_spawn_failure_degrades_to_poll(self):
        sched = StubScheduler(backend="gke")
        sched.apps["ns:j2"] = AppState.SUCCEEDED

        def no_kubectl(cmd):
            raise OSError("kubectl: not found")

        watcher = KubectlWatcher(sched, ["ns:j2"], interval=0.02, spawn=no_kubectl)
        events = collect_events(watcher)
        assert [e.state for e in events] == [AppState.SUCCEEDED]
        assert events[0].source == "poll"  # the fallback path, same events

    def test_jobset_watch_state_mapping(self):
        def doc(ctype, status="True"):
            return {"status": {"conditions": [{"type": ctype, "status": status}]}}

        assert jobset_watch_state(doc("Completed")) == AppState.SUCCEEDED
        assert jobset_watch_state(doc("Failed")) == AppState.FAILED
        assert (
            jobset_watch_state(doc("FailurePolicyComplete")) == AppState.FAILED
        )
        assert jobset_watch_state(doc("Suspended")) == AppState.PENDING
        # a False condition is not a transition
        assert jobset_watch_state(doc("Completed", "False")) == AppState.RUNNING
        assert jobset_watch_state({}) == AppState.RUNNING

    def test_adapter_parity_three_backends(self, tmp_path, monkeypatch):
        """The ISSUE's parity check: the same lifecycle through the poll
        adapter, the local sidecar adapter, and the kubectl shim produces
        the same transition contract — a deduped sequence ending in ONE
        terminal event that carries a confirming describe."""
        monkeypatch.setenv("TPX_WATCH_INTERVAL", "0.05")
        sequences = {}

        # generic poll
        poll_sched = StubScheduler()
        a = poll_sched.schedule(poll_sched._submit_dryrun(simple_app(), {}))
        threading.Timer(
            0.1, lambda: poll_sched.apps.__setitem__(a, AppState.SUCCEEDED)
        ).start()
        sequences["poll"] = collect_events(PollWatcher(poll_sched, [a], 0.02))

        # kubectl shim
        gke_sched = StubScheduler(backend="gke")
        gke_sched.apps["ns:p"] = AppState.RUNNING
        docs = [
            json.dumps({"metadata": {"name": "p"}, "status": {}}),
            json.dumps(
                {
                    "metadata": {"name": "p"},
                    "status": {
                        "conditions": [{"type": "Completed", "status": "True"}]
                    },
                }
            ),
        ]

        class Proc:
            stdout = docs

            def terminate(self):
                pass

        def spawn(cmd):
            gke_sched.apps["ns:p"] = AppState.SUCCEEDED
            return Proc()

        sequences["kubectl"] = collect_events(
            KubectlWatcher(gke_sched, ["ns:p"], interval=0.02, spawn=spawn)
        )

        # local sidecars, a real process
        sched, app_id = run_local_echo("p", str(tmp_path))
        try:
            sequences["sidecar"] = collect_events(sched.watch([app_id]))
        finally:
            sched.close()

        for name, events in sequences.items():
            assert events, f"{name}: no events"
            terminal = [e for e in events if e.terminal]
            assert len(terminal) == 1, f"{name}: {[e.state for e in events]}"
            assert events[-1] is terminal[0], f"{name}: terminal not last"
            assert terminal[0].state == AppState.SUCCEEDED, name
            assert terminal[0].resp is not None, f"{name}: unconfirmed terminal"
            states = [e.state for e in events]
            assert len(states) == len(set(states)), f"{name}: duplicate states"



# ---------------------------------------------------------------------------
# Parity with the JAX package
# ---------------------------------------------------------------------------


def _rand_docs(seed: int) -> list[dict]:
    rng = random.Random(seed)
    ctypes = ["Completed", "Failed", "FailurePolicyComplete", "Suspended", "StartupPolicy",
              "Running", ""]
    docs = []
    for i in range(60):
        conds = [{"type": rng.choice(ctypes), "status": rng.choice(["True", "False", "true",
                                                                    "Unknown"])}
                 for _ in range(rng.randint(0, 3))]
        doc = {"metadata": {"name": f"j{i}"}, "status": {"conditions": conds}}
        if rng.random() < 0.1:
            doc = {"metadata": {"name": f"j{i}"}, "status": None}
        if rng.random() < 0.1:
            doc["note"] = 'braces "{}" and escapes \\" inside a string'
        docs.append(doc)
    return docs


class TestParityWithJax:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_jobset_states_and_stream_parser(self, seed):
        docs = _rand_docs(seed)
        assert [jobset_watch_state(d).name for d in docs] == \
            [jwatch.jobset_watch_state(d).name for d in docs]
        rng = random.Random(seed)
        text = "".join(rng.choice(["", "\n", "noise ", "]"]) + json.dumps(d) for d in docs)
        text += '{"metadata": {"name": "torn"'  # a stream cut mid-document
        cuts = sorted(rng.sample(range(len(text)), 40))
        chunks = [text[a:b] for a, b in zip([0, *cuts], [*cuts, len(text)])]
        ours = list(_iter_json_docs(iter(chunks)))
        assert ours == list(jwatch._iter_json_docs(iter(chunks))) == docs

    @pytest.mark.parametrize("seed", [3, 4])
    def test_event_records_equal_jax(self, seed):
        rng = random.Random(seed)
        for _ in range(50):
            state = rng.choice(list(AppState))
            kw = dict(scheduler=rng.choice(["local", "gke", "stub"]),
                      app_id=f"a{rng.randint(0, 999)}", source=rng.choice(
                          ["poll", "sidecar", "kubectl"]),
                      time_usec=rng.randint(0, 2**50), cell=rng.choice(["", "us-east"]))
            ours = StateEvent(state=state, **kw)
            theirs = jevents.StateEvent(state=jspecs.AppState[state.name], **kw)
            assert ours.serialize() == theirs.serialize()
            assert ours.terminal == theirs.terminal
            back = StateEvent.deserialize(theirs.serialize())
            assert (back.state.name, back.app_id, back.cell) == (state.name, kw["app_id"],
                                                                 kw["cell"])
        for resp in (None, DescribeAppResponse(app_id="x", state=AppState.FAILED)):
            ours = event_from_describe("s", "x", resp)
            jresp = resp and jevents.DescribeAppResponse(app_id="x",
                                                         state=jspecs.AppState.FAILED)
            theirs = jevents.event_from_describe("s", "x", jresp)
            assert (ours.state.name, ours.source, ours.resp is None) == \
                (theirs.state.name, theirs.source, theirs.resp is None)

    def test_watch_events_counted(self):
        """Every emitted event increments ``tpx_watch_events_total`` by its
        scheduler and source, as the JAX stream does."""
        sched = StubScheduler(backend="count-stub")
        app_id = sched.schedule(sched._submit_dryrun(simple_app(), {}))
        sched.apps[app_id] = AppState.SUCCEEDED
        before = obs_metrics.WATCH_EVENTS.value(scheduler="count-stub", source="poll")
        events = collect_events(PollWatcher(sched, [app_id], interval=0.01))
        assert [e.state for e in events] == [AppState.SUCCEEDED]
        assert obs_metrics.WATCH_EVENTS.value(scheduler="count-stub", source="poll") == \
            before + 1
