"""The port's observability layer (``torchx_tpu_torch.obs``) held to the
JAX package's own cases: every case of ``tests/test_obs.py`` (span model,
metrics registry, durable sinks, destination plumbing, timeline
reconstruction, and the acceptance scenario — a supervised run with an
injected preemption producing ONE trace with nested spans for both
attempts, rendered by ``tpx-torch trace``), each run against the copy.
Cases changed with the port: an entry-point event destination is looked
up in the port's ``tpx_torch.event_handlers`` group. Added: parity with the
JAX package on the same inputs (``TestJaxParity``: each package's timeline
and stitch render the other's ``trace.jsonl`` as it renders its own, both
``Span.deserialize`` read one record alike, ``load_metrics`` sums one
session alike, and ``tpx trace`` / ``tpx-torch trace`` print the same text
on one obs dir; all exact), and the port's own root-span flush
(``TestRootSpanFlush``: at once in a quiet period, else by one timer at the
interval's end or at exit) and its trace sink's open file.

The port's lint gate raises until the analyzer is ported, so an autouse
fixture sets ``TPX_NO_LINT=1``; every case keeps the local scheduler's
registry under ``tmp_path``, sees a card-less host, and starts with the
port's breakers and fault plan reset."""

import json
import logging
import os
from typing import Mapping, Optional

import pytest

from torchx_tpu_torch import settings
from torchx_tpu_torch.obs import metrics as obs_metrics
from torchx_tpu_torch.obs import sinks, timeline
from torchx_tpu_torch.obs import trace as obs_trace
from torchx_tpu_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry
from torchx_tpu_torch.obs.trace import Span
from torchx_tpu_torch.resilience import call as resilience_call
from torchx_tpu_torch.resilience import faults as resilience_faults
from torchx_tpu_torch.runner.api import Runner
from torchx_tpu_torch.runner.events import record
from torchx_tpu_torch.runner.events.api import TpxEvent
from torchx_tpu_torch.schedulers import local_scheduler as lsched
from torchx_tpu_torch.schedulers.api import DescribeAppResponse, Scheduler
from torchx_tpu_torch.settings import (
    ENV_TPX_METRICS_MIN_INTERVAL,
    ENV_TPX_PARENT_SPAN,
    ENV_TPX_SIMULATE_PREEMPTION_EXIT,
    ENV_TPX_TRACE,
    ENV_TPX_TRACE_ID,
)
from torchx_tpu_torch.specs.api import (
    AppDef,
    AppState,
    CfgVal,
    FailureClass,
    Role,
    runopts,
)
from torchx_tpu_torch.supervisor import SupervisorPolicy
from torch_threads import xdist_torch_threads  # noqa: F401


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


# -- span model ------------------------------------------------------------


class TestSpans:
    def test_nesting_via_contextvar(self):
        with obs_trace.span("outer") as outer:
            assert obs_trace.current_span() is outer
            with obs_trace.span("inner") as inner:
                assert inner.trace_id == outer.trace_id
                assert inner.parent_span_id == outer.span_id
            assert obs_trace.current_span() is outer
        assert obs_trace.current_span() is None
        assert outer.parent_span_id is None
        assert outer.duration_usec() is not None

    def test_error_status_on_exception(self):
        with pytest.raises(RuntimeError):
            with obs_trace.span("boom") as sp:
                raise RuntimeError("kapow")
        assert sp.status == "ERROR"
        assert "kapow" in sp.attrs["exception"]

    def test_serialize_round_trip_and_unknown_fields_dropped(self):
        with obs_trace.span("op", scheduler="local") as sp:
            pass
        obj = json.loads(sp.serialize())
        assert obj["kind"] == "span"
        obj["fancy_new_field"] = {"from": "the future"}
        restored = Span.deserialize(json.dumps(obj))
        assert restored.span_id == sp.span_id
        assert restored.attrs == {"scheduler": "local"}
        assert not hasattr(restored, "fancy_new_field")

    def test_root_joins_env_trace(self, monkeypatch):
        monkeypatch.setenv(ENV_TPX_TRACE_ID, "f" * 32)
        monkeypatch.setenv(ENV_TPX_PARENT_SPAN, "a" * 16)
        with obs_trace.span("in_job") as sp:
            assert sp.trace_id == "f" * 32
            assert sp.parent_span_id == "a" * 16

    def test_inject_env_setdefault_vs_force(self, monkeypatch):
        with obs_trace.span("client") as sp:
            env = {ENV_TPX_TRACE_ID: "0" * 32, ENV_TPX_PARENT_SPAN: "old"}
            obs_trace.inject_env(env)
            assert env[ENV_TPX_TRACE_ID] == "0" * 32  # inherited id kept
            assert env[ENV_TPX_PARENT_SPAN] == sp.span_id  # parent refreshed
            obs_trace.inject_env(env, force=True)
            assert env[ENV_TPX_TRACE_ID] == sp.trace_id

    def test_disabled_tracing_is_a_noop(self, monkeypatch):
        monkeypatch.setenv(ENV_TPX_TRACE, "0")
        with obs_trace.span("off") as sp:
            assert sp is None
        assert not os.path.exists(sinks.trace_path())
        assert sinks.flush_metrics() is None
        env: dict = {}
        obs_trace.inject_env(env)
        assert env == {}


class TestEventForwardCompat:
    def test_deserialize_drops_unknown_fields(self):
        ev = TpxEvent(session="s", scheduler="local", api="run", app_id="a1")
        obj = json.loads(ev.serialize())
        obj["brand_new_field"] = 42
        restored = TpxEvent.deserialize(json.dumps(obj))
        assert restored == ev


# -- metrics registry ------------------------------------------------------


class TestMetrics:
    def test_counter(self):
        c = Counter("t_c", "h", ("k",))
        c.inc(k="a")
        c.inc(2, k="a")
        assert c.value(k="a") == 3
        assert c.value(k="b") == 0
        with pytest.raises(ValueError, match="cannot decrease"):
            c.inc(-1, k="a")
        with pytest.raises(ValueError, match="takes labels"):
            c.inc(wrong="a")
        assert c.render() == ['t_c{k="a"} 3']

    def test_gauge(self):
        g = Gauge("t_g", "h")
        g.set(1.5)
        assert g.value() == 1.5
        g.set(0.5)
        assert g.render() == ["t_g 0.5"]

    def test_histogram_cumulative_buckets(self):
        h = Histogram("t_h", "h", buckets=(1.0, 5.0))
        for v in (0.5, 0.7, 3.0, 100.0):
            h.observe(v)
        assert h.count() == 4
        assert h.sum() == pytest.approx(104.2)
        assert h.render() == [
            't_h_bucket{le="1"} 2',
            't_h_bucket{le="5"} 3',
            't_h_bucket{le="+Inf"} 4',
            "t_h_sum 104.2",
            "t_h_count 4",
        ]

    def test_registry_get_or_create_and_kind_clash(self):
        reg = MetricsRegistry()
        c1 = reg.counter("x", "h")
        assert reg.counter("x", "h") is c1
        assert reg.get("x") is c1
        with pytest.raises(ValueError, match="already registered"):
            reg.gauge("x", "h")

    def test_render_documents_empty_instruments(self):
        reg = MetricsRegistry()
        reg.histogram("quiet_seconds", "never observed")
        text = reg.render()
        assert "# HELP quiet_seconds never observed" in text
        assert "# TYPE quiet_seconds histogram" in text


# -- destinations ----------------------------------------------------------


@pytest.fixture
def clean_destinations(monkeypatch):
    from torchx_tpu_torch.runner.events import handlers

    monkeypatch.setattr(handlers, "_DESTINATIONS", dict(handlers._DESTINATIONS))
    monkeypatch.setattr(handlers, "_RESOLVED_EP_FACTORIES", {})
    return handlers


class TestDestinations:
    def test_register_destination(self, clean_destinations):
        handlers = clean_destinations
        marker = logging.StreamHandler()
        handlers.register_destination("mine", lambda: marker)
        assert handlers.get_destination_handler("mine") is marker

    def test_builtin_obs_destinations(self, clean_destinations):
        handlers = clean_destinations
        assert isinstance(
            handlers.get_destination_handler("jsonl"), sinks.JsonlTraceHandler
        )
        assert isinstance(
            handlers.get_destination_handler("prom"), sinks.PromMetricsHandler
        )

    def test_unknown_falls_back_to_null(self, clean_destinations):
        handler = clean_destinations.get_destination_handler("nope")
        assert isinstance(handler, logging.NullHandler)

    def test_broken_entrypoint_falls_back_and_is_not_cached(
        self, clean_destinations, monkeypatch
    ):
        handlers = clean_destinations
        calls = []

        def boom():
            calls.append(1)
            raise RuntimeError("broken plugin")

        monkeypatch.setattr(
            "torchx_tpu_torch.util.entrypoints.load_group",
            lambda group: {"broken": boom},
        )
        assert isinstance(
            handlers.get_destination_handler("broken"), logging.NullHandler
        )
        assert isinstance(
            handlers.get_destination_handler("broken"), logging.NullHandler
        )
        assert len(calls) == 2  # failures retried (and re-warned), not cached

    def test_good_entrypoint_is_resolved_once(
        self, clean_destinations, monkeypatch
    ):
        handlers = clean_destinations
        loads = []

        def fake_load_group(group):
            loads.append(group)
            return {"ep_dest": lambda: logging.StreamHandler}

        monkeypatch.setattr(
            "torchx_tpu_torch.util.entrypoints.load_group", fake_load_group
        )
        h1 = handlers.get_destination_handler("ep_dest")
        h2 = handlers.get_destination_handler("ep_dest")
        assert isinstance(h1, logging.StreamHandler)
        assert isinstance(h2, logging.StreamHandler)
        assert loads == ["tpx_torch.event_handlers"]  # second hit served from cache

    def test_factory_constructor_failure_falls_back(self, clean_destinations):
        handlers = clean_destinations

        def bad_factory():
            raise OSError("disk full")

        handlers.register_destination("bad", bad_factory)
        assert isinstance(
            handlers.get_destination_handler("bad"), logging.NullHandler
        )


# -- sinks + timeline ------------------------------------------------------


class TestSinksAndTimeline:
    def test_spans_and_events_share_one_jsonl(self):
        with obs_trace.span("parent") as parent:
            record(
                TpxEvent(session="s", scheduler="local", api="describe")
            )
        records = timeline.load_records(sinks.trace_path())
        spans = [r for r in records if timeline.is_span(r)]
        events = [r for r in records if not timeline.is_span(r)]
        assert [s["name"] for s in spans] == ["parent"]
        assert events[-1]["api"] == "describe"
        # the event is correlated to the enclosing span at emit time
        assert events[-1]["trace_id"] == parent.trace_id
        assert events[-1]["span_id"] == parent.span_id
        # and events get their clocks stamped at emit (satellite: times.py)
        assert events[-1]["start_epoch_time_usec"] is not None
        assert events[-1]["wall_time_usec"] is not None
        assert events[-1]["cpu_time_usec"] is not None

    def test_load_records_skips_torn_lines(self, tmp_path):
        p = tmp_path / "trace.jsonl"
        p.write_text('{"kind": "span", "name": "ok"}\n{"kind": "sp')
        assert [r["name"] for r in timeline.load_records(str(p))] == ["ok"]

    def test_flush_and_load_metrics(self):
        reg_counter = obs_metrics.RETRIES
        before = reg_counter.value(failure_class="TEST_ONLY")
        reg_counter.inc(failure_class="TEST_ONLY")
        path = sinks.flush_metrics()
        assert path is not None and os.path.exists(path)
        rows = timeline.load_metrics(os.path.dirname(path))
        hits = [
            v
            for n, labels, v in rows
            if n == "tpx_supervisor_retries_total" and "TEST_ONLY" in labels
        ]
        assert hits == [before + 1]

    def test_timeline_orphan_parents_become_roots(self):
        tid = "a" * 32
        recs = [
            json.loads(
                Span(
                    name="child",
                    trace_id=tid,
                    span_id="c" * 16,
                    parent_span_id="missing",
                    start_epoch_usec=10,
                    end_epoch_usec=20,
                ).serialize()
            )
        ]
        roots = timeline.build_timeline(recs, tid)
        assert [r.span.name for r in roots] == ["child"]
        assert "child" in timeline.render_timeline(roots)

    def test_render_metrics_table_collapses_buckets(self):
        rows = [
            ("tpx_launch_seconds_bucket", 'le="1"', 3.0),
            ("tpx_launch_seconds_count", "", 3.0),
        ]
        out = timeline.render_metrics_table(rows)
        assert "tpx_launch_seconds_count" in out
        assert "_bucket" not in out
        out_all = timeline.render_metrics_table(rows, include_buckets=True)
        assert "tpx_launch_seconds_bucket" in out_all

    def test_load_metrics_mixed_pid_dir_with_torn_tail(self, tmp_path):
        d = tmp_path / "sess"
        d.mkdir()
        (d / "metrics-100.prom").write_text(
            "# TYPE tpx_runs_total counter\ntpx_runs_total 3\n"
        )
        # a second process's file, its writer killed mid-line
        (d / "metrics-200.prom").write_text(
            "tpx_runs_total 4\ntpx_queue_depth 2\ntorn_met"
        )
        rows = timeline.load_metrics(str(d))
        assert ("tpx_runs_total", "", 7.0) in rows  # per-pid files sum
        assert ("tpx_queue_depth", "", 2.0) in rows
        assert not any(n.startswith("torn") for n, _, _ in rows)


# -- metrics flush debounce -------------------------------------------------


class TestMetricsFlushDebounce:
    def _record(self):
        return logging.LogRecord(
            "tpx", logging.INFO, __file__, 0, "{}", None, None
        )

    def test_burst_collapses_to_one_write(self, monkeypatch):
        writes = []
        monkeypatch.setattr(
            sinks, "flush_metrics", lambda session=None: writes.append(1)
        )
        h = sinks.PromMetricsHandler(min_interval_s=60.0)
        for _ in range(25):
            h.emit(self._record())
        assert len(writes) == 1  # first emit flushes, the burst defers
        h.flush()
        assert len(writes) == 2  # the deferred final state
        h.flush()
        assert len(writes) == 2  # nothing dirty: flush is a no-op

    def test_writes_resume_after_the_interval(self, monkeypatch):
        writes = []
        monkeypatch.setattr(
            sinks, "flush_metrics", lambda session=None: writes.append(1)
        )
        now = [0.0]
        monkeypatch.setattr(sinks.time, "monotonic", lambda: now[0])
        h = sinks.PromMetricsHandler(min_interval_s=2.0)
        h.emit(self._record())
        h.emit(self._record())
        assert len(writes) == 1
        now[0] = 5.0
        h.emit(self._record())
        assert len(writes) == 2

    def test_close_writes_deferred_state(self, monkeypatch):
        writes = []
        monkeypatch.setattr(
            sinks, "flush_metrics", lambda session=None: writes.append(1)
        )
        h = sinks.PromMetricsHandler(min_interval_s=60.0)
        h.emit(self._record())
        h.emit(self._record())
        h.close()  # logging shutdown path
        assert len(writes) == 2

    def test_env_configures_interval(self, monkeypatch):
        monkeypatch.setenv(ENV_TPX_METRICS_MIN_INTERVAL, "7.5")
        assert sinks.PromMetricsHandler().min_interval_s == 7.5
        monkeypatch.setenv(ENV_TPX_METRICS_MIN_INTERVAL, "junk")
        assert (
            sinks.PromMetricsHandler().min_interval_s
            == settings.DEFAULT_METRICS_MIN_INTERVAL
        )

    def test_operator_alias(self):
        assert sinks.MetricsFlushHandler is sinks.PromMetricsHandler


class TestRootSpanFlush:
    """A root span's textfile flush: at once in a quiet period, else by one
    timer at the interval's end (or at exit); the trace file kept open."""

    @pytest.fixture
    def flush(self, monkeypatch):
        monkeypatch.setenv(ENV_TPX_METRICS_MIN_INTERVAL, "0.3")
        f = sinks._RootSpanFlush()
        monkeypatch.setattr(sinks, "flush_metrics_after_root_span", f)
        before = obs_metrics.SERVE_REPLICAS.value()
        yield f
        obs_metrics.SERVE_REPLICAS.set(before)

    def _replicas(self):
        with open(sinks.metrics_path()) as fh:
            (line,) = [ln for ln in fh if ln.startswith("tpx_serve_replicas ")]
        return float(line.split()[1])

    def test_quiet_root_writes_at_once_and_a_burst_by_its_timer(self, flush):
        import time

        obs_metrics.SERVE_REPLICAS.set(1)
        with obs_trace.span("root.a"):
            obs_metrics.SERVE_REPLICAS.set(7)
            with obs_trace.span("child"):
                pass
            assert not os.path.exists(sinks.metrics_path())  # a child never flushes
        assert self._replicas() == 7
        obs_metrics.SERVE_REPLICAS.set(2)
        with obs_trace.span("root.b"):
            pass
        assert self._replicas() == 7  # inside the interval: deferred
        deadline = time.monotonic() + 5.0
        while self._replicas() != 2 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert self._replicas() == 2 and flush._timer is None

    def test_exit_writes_the_deferred_state(self, flush):
        obs_metrics.SERVE_REPLICAS.set(3)
        with obs_trace.span("root.a"):
            pass
        obs_metrics.SERVE_REPLICAS.set(4)
        with obs_trace.span("root.b"):
            pass
        assert self._replicas() == 3 and flush._timer is not None
        flush._at_exit()
        assert self._replicas() == 4 and flush._timer is None

    def test_another_textfile_writes_at_once(self, flush, tmp_path, monkeypatch):
        with obs_trace.span("root.a"):
            pass
        monkeypatch.setenv(settings.ENV_TPX_OBS_DIR, str(tmp_path / "other"))
        obs_metrics.SERVE_REPLICAS.set(5)
        with obs_trace.span("root.b"):
            pass
        assert sinks.metrics_path().startswith(str(tmp_path / "other"))
        assert self._replicas() == 5

    def test_trace_file_stays_open_and_follows_its_path(self, tmp_path, monkeypatch):
        h = sinks.JsonlTraceHandler()

        def emit(msg):
            h.handle(logging.LogRecord("tpx", logging.INFO, __file__, 0, msg, None, None))

        try:
            emit('{"n": 1}')
            fd = h._fd
            emit('{"n": 2}')
            assert h._fd == fd
            os.remove(sinks.trace_path())  # deleted: opened again
            emit('{"n": 3}')
            with open(sinks.trace_path()) as fh:
                assert fh.read() == '{"n": 3}\n'
            monkeypatch.setenv(settings.ENV_TPX_OBS_DIR, str(tmp_path / "other"))
            emit('{"n": 4}')
            with open(sinks.trace_path()) as fh:
                assert fh.read() == '{"n": 4}\n'
        finally:
            h.close()
        assert h._fd is None


# -- exposition round trip --------------------------------------------------


class TestExpositionRoundTrip:
    def test_registry_render_parses_back_exactly(self):
        from torchx_tpu_torch.obs.telemetry import parse_exposition

        reg = MetricsRegistry()
        c = reg.counter("rt_total", "help", ("path",))
        c.inc(3, path='a"b\\c\nd')  # every escapable character
        h = reg.histogram("rt_seconds", "help", buckets=(0.5,))
        h.observe(0.1)
        h.observe(2.0)
        samples = parse_exposition(reg.render())
        by = {(s.name, s.labels): s for s in samples}
        counter = by[("rt_total", (("path", 'a"b\\c\nd'),))]
        assert counter.value == 3.0 and counter.kind == "counter"
        assert by[("rt_seconds_bucket", (("le", "0.5"),))].value == 1.0
        assert by[("rt_seconds_bucket", (("le", "+Inf"),))].value == 2.0
        assert by[("rt_seconds_count", ())].kind == "histogram"
        assert by[("rt_seconds_sum", ())].value == pytest.approx(2.1)


# -- the acceptance scenario ----------------------------------------------


class ScriptedScheduler(Scheduler[dict]):
    """Each ``schedule()`` consumes the next scripted terminal outcome."""

    def __init__(self, session_name: str, script=None, **kwargs):
        super().__init__("scripted", session_name)
        self.script = list(script or [])
        self.apps: dict[str, tuple[AppState, Optional[FailureClass]]] = {}
        self.submitted_envs: list[dict[str, str]] = []
        self._counter = 0

    def run_opts(self) -> runopts:
        return runopts()

    def _submit_dryrun(self, app: AppDef, cfg: Mapping[str, CfgVal]):
        from torchx_tpu_torch.specs.api import AppDryRunInfo

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


PREEMPT = (AppState.PREEMPTED, FailureClass.PREEMPTION)
OK = (AppState.SUCCEEDED, None)


def supervise_with_preemption():
    """One preemption then success, under Runner.supervise (fast policy)."""
    sched = ScriptedScheduler("obs", script=[PREEMPT, OK])
    runner = Runner("obs", {"scripted": lambda session_name, **kw: sched})
    app = AppDef(
        name="train",
        roles=[Role(name="trainer", image="i", entrypoint="python")],
    )
    with runner:
        info = runner.dryrun(app, "scripted")
        result = runner.supervise(
            info,
            SupervisorPolicy(
                max_preemptions=2,
                backoff_seconds=0.01,
                jitter=0.0,
                poll_interval=0.01,
            ),
        )
    return result, sched


class TestSuperviseTrace:
    def test_one_trace_with_nested_attempt_spans(self):
        result, sched = supervise_with_preemption()
        assert result.succeeded and result.attempts == 2

        records = timeline.load_records(sinks.trace_path())
        spans = [r for r in records if timeline.is_span(r)]
        root = [s for s in spans if s["name"] == "runner.supervise"][-1]
        tid = root["trace_id"]
        in_trace = [s for s in spans if s["trace_id"] == tid]
        names = [s["name"] for s in in_trace]

        # both attempts, the backoff between them, and their submissions
        # all live in ONE trace
        assert names.count("supervisor.attempt") == 2
        assert names.count("supervisor.backoff") == 1
        assert names.count("runner.schedule") == 2
        assert names.count("runner.wait") == 2

        by_id = {s["span_id"]: s for s in in_trace}
        sup_run = next(s for s in in_trace if s["name"] == "supervisor.run")
        assert sup_run["parent_span_id"] == root["span_id"]
        attempts = sorted(
            (s for s in in_trace if s["name"] == "supervisor.attempt"),
            key=lambda s: s["attrs"]["attempt"],
        )
        for s in attempts:
            assert by_id[s["parent_span_id"]]["name"] == "supervisor.run"
        assert attempts[0]["attrs"]["app_id"] == "job_1"
        assert attempts[0]["attrs"]["failure_class"] == "PREEMPTION"
        assert attempts[1]["attrs"]["app_id"] == "job_2"
        assert "resume_step" not in attempts[1]["attrs"]  # no ckpt dir set

        # supervisor transition events carry the same trace id and attach
        # to the attempt spans that emitted them
        sup_events = [
            r
            for r in records
            if not timeline.is_span(r) and r.get("api") == "supervise"
        ]
        transitions = [
            e["app_metadata"]["transition"]
            for e in sup_events
            if e.get("app_metadata", {}).get("transition")
        ]
        assert transitions == ["submitted", "resubmitting", "submitted", "finished"]
        for e in sup_events:
            assert e["trace_id"] == tid

    def test_trace_env_repointed_per_attempt(self):
        result, sched = supervise_with_preemption()
        env1, env2 = sched.submitted_envs
        assert env1[ENV_TPX_TRACE_ID] == env2[ENV_TPX_TRACE_ID]
        # each attempt's in-job spans must hang off THAT attempt's span
        assert env1[ENV_TPX_PARENT_SPAN] != env2[ENV_TPX_PARENT_SPAN]
        records = timeline.load_records(sinks.trace_path())
        spans = {r["span_id"]: r for r in records if timeline.is_span(r)}
        assert spans[env1[ENV_TPX_PARENT_SPAN]]["name"] == "supervisor.attempt"
        assert spans[env2[ENV_TPX_PARENT_SPAN]]["name"] == "supervisor.attempt"
        # and the injected trace is the client's own
        root = [s for s in spans.values() if s["name"] == "runner.supervise"][-1]
        assert env1[ENV_TPX_TRACE_ID] == root["trace_id"]

    def test_metrics_flushed_with_retry_and_launch_series(self):
        supervise_with_preemption()
        path = sinks.metrics_path()
        assert os.path.exists(path)
        text = open(path).read()
        assert 'tpx_supervisor_retries_total{failure_class="PREEMPTION"}' in text
        assert "tpx_launch_seconds_bucket" in text
        assert 'tpx_wait_polls_total{scheduler="scripted"}' in text
        assert "tpx_supervisor_backoff_seconds_total" in text

    def test_tpx_trace_cli_renders_the_timeline(self, capsys):
        result, _ = supervise_with_preemption()
        from torchx_tpu_torch.cli.main import main as cli_main

        cli_main(["trace", result.handle, "--events", "--metrics"])
        out = capsys.readouterr().out
        assert "trace " in out
        assert "runner.supervise" in out
        assert "supervisor.attempt (job_1)" in out
        assert "supervisor.attempt (job_2)" in out
        assert "supervisor.backoff" in out
        assert "· resubmitting" in out  # --events interleaving
        assert "tpx_supervisor_retries_total" in out  # --metrics table

    def test_tpx_trace_cli_unknown_identifier(self, capsys):
        supervise_with_preemption()
        from torchx_tpu_torch.cli.main import main as cli_main

        with pytest.raises(SystemExit):
            cli_main(["trace", "no_such_app"])
        assert "no trace found" in capsys.readouterr().err


class TestLocalPreemptionDrill:
    """The acceptance scenario on the REAL local scheduler: an injected
    preemption (TPX_SIMULATE_PREEMPTION_EXIT drill knob) supervised end to
    end, leaving ONE trace with both attempts and the backoff between."""

    def test_local_supervise_injected_preemption_one_trace(self, tmp_path):
        from torchx_tpu_torch.schedulers.local_scheduler import LocalScheduler

        marker = tmp_path / "preempted-once"
        # first run "loses its capacity" (exits with the drill code);
        # the resubmitted attempt finds the marker and succeeds
        script = (
            f'if [ -e "{marker}" ]; then exit 0; fi;'
            f' touch "{marker}"; exit 67'
        )
        sched = LocalScheduler(session_name="obs-local", cache_size=10)
        runner = Runner("obs-local", {"local": lambda session_name, **kw: sched})
        app = AppDef(
            name="drill",
            roles=[
                Role(
                    name="w",
                    image="",
                    entrypoint="sh",
                    args=["-c", script],
                    env={ENV_TPX_SIMULATE_PREEMPTION_EXIT: "67"},
                )
            ],
        )
        try:
            with runner:
                info = runner.dryrun(
                    app, "local", cfg={"log_dir": str(tmp_path / "logs")}
                )
                result = runner.supervise(
                    info,
                    SupervisorPolicy(
                        max_preemptions=2,
                        backoff_seconds=0.01,
                        jitter=0.0,
                        poll_interval=0.05,
                    ),
                )
        finally:
            sched.close()
        assert result.succeeded and result.attempts == 2

        records = timeline.load_records(sinks.trace_path())
        spans = [r for r in records if timeline.is_span(r)]
        root = [s for s in spans if s["name"] == "runner.supervise"][-1]
        tid = root["trace_id"]
        names = [s["name"] for s in spans if s["trace_id"] == tid]
        assert names.count("supervisor.attempt") == 2
        assert names.count("supervisor.backoff") == 1
        assert names.count("scheduler.spawn") == 2  # real Popen submits
        attempts = sorted(
            (
                s
                for s in spans
                if s["trace_id"] == tid and s["name"] == "supervisor.attempt"
            ),
            key=lambda s: s["attrs"]["attempt"],
        )
        # the drill exit code classified as a real preemption
        assert attempts[0]["attrs"]["failure_class"] == "PREEMPTION"
        assert attempts[0]["attrs"]["state"] == "PREEMPTED"
        assert "failure_class" not in attempts[1]["attrs"]

    def test_drill_knob_absent_keeps_failed_semantics(self, tmp_path):
        from torchx_tpu_torch.schedulers.local_scheduler import LocalScheduler

        sched = LocalScheduler(session_name="obs-nodrill", cache_size=10)
        try:
            app = AppDef(
                name="plain",
                roles=[
                    Role(name="w", image="", entrypoint="sh", args=["-c", "exit 67"])
                ],
            )
            app_id = sched.submit(app, {"log_dir": str(tmp_path / "logs")})
            import time

            from torchx_tpu_torch.specs.api import is_terminal

            for _ in range(200):
                desc = sched.describe(app_id)
                if desc is not None and is_terminal(desc.state):
                    break
                time.sleep(0.05)
            assert desc.state == AppState.FAILED
            assert sched.classify_failure(desc) == FailureClass.APP
        finally:
            sched.close()


# -- in-job helpers --------------------------------------------------------


class TestJobSide:
    def test_spmd_job_span_noop_without_trace_env(self, monkeypatch):
        from torchx_tpu_torch.apps.spmd_main import _job_span

        monkeypatch.delenv(ENV_TPX_TRACE_ID, raising=False)
        with _job_span("job.bootstrap") as sp:
            assert sp is None
        assert not os.path.exists(sinks.trace_path())

    def test_spmd_job_span_joins_client_trace(self, monkeypatch):
        from torchx_tpu_torch.apps.spmd_main import _job_span

        monkeypatch.setenv(ENV_TPX_TRACE_ID, "e" * 32)
        monkeypatch.setenv(ENV_TPX_PARENT_SPAN, "b" * 16)
        with _job_span("job.bootstrap") as sp:
            pass
        assert sp.trace_id == "e" * 32
        assert sp.parent_span_id == "b" * 16

    def test_heartbeat_is_instant_and_flushes_metrics(self):
        sp = obs_trace.heartbeat("job.first_step", launch_to_first_step_s=1.2)
        assert sp.end_epoch_usec is not None
        assert sp.attrs["launch_to_first_step_s"] == 1.2
        assert os.path.exists(sinks.metrics_path())


# -- parity with the JAX package on the same inputs (exact) -----------------


def run_cli(argv, cli_main):
    """-> (exit_code, stdout, stderr) of one in-process CLI call."""
    import io
    from contextlib import redirect_stderr, redirect_stdout

    out, err = io.StringIO(), io.StringIO()
    code = 0
    try:
        with redirect_stdout(out), redirect_stderr(err):
            cli_main(argv)
    except SystemExit as e:
        code = e.code if isinstance(e.code, int) else 1
    return code, out.getvalue(), err.getvalue()


def seeded_trace(trace_mod, record_event, event_cls, seed: int) -> str:
    """One trace written through ``trace_mod``'s spans: a root, nested
    children and a failed grandchild, with numpy-seeded attrs and one event
    correlated to a child. -> its trace id."""
    import numpy as np

    rng = np.random.default_rng(seed)
    with trace_mod.span("runner.run", app_id="app_parity", n=int(rng.integers(100))) as root:
        for i in range(3):
            with trace_mod.span("stage", index=i, cost=float(rng.uniform())):
                if i == 1:
                    record_event(event_cls(session="s", scheduler="local", api="describe",
                                           app_id="app_parity",
                                           app_metadata={"transition": "submitted"}))
                with pytest.raises(RuntimeError):
                    with trace_mod.span("leaf", depth=2):
                        raise RuntimeError(f"boom {i}")
    return root.trace_id


class TestJaxParity:
    def trees(self, tl, records, tid):
        return tl.render_timeline(tl.build_timeline(records, tid), include_events=True)

    def test_each_timeline_renders_the_others_trace(self):
        from torchx_tpu.obs import sinks as jsinks
        from torchx_tpu.obs import timeline as jtimeline
        from torchx_tpu.obs import trace as jtrace
        from torchx_tpu.runner.events import record as jrecord
        from torchx_tpu.runner.events.api import TpxEvent as JTpxEvent

        mine = seeded_trace(obs_trace, record, TpxEvent, seed=3)
        theirs = seeded_trace(jtrace, jrecord, JTpxEvent, seed=3)
        assert sinks.trace_path() == jsinks.trace_path()  # one session dir
        records = timeline.load_records(sinks.trace_path())
        assert records == jtimeline.load_records(sinks.trace_path())
        for tid in (mine, theirs):
            assert timeline.find_trace_ids(records, "app_parity") == \
                jtimeline.find_trace_ids(records, "app_parity")
            rendered = self.trees(timeline, records, tid)
            assert rendered == self.trees(jtimeline, records, tid)
            assert rendered.count("!ERROR") == 3 and "· submitted" in rendered
        # the two packages' records differ only in ids and clocks
        by = {t: [r for r in records if r.get("trace_id") == t] for t in (mine, theirs)}
        strip = ("trace_id", "span_id", "parent_span_id", "start_epoch_usec",
                 "end_epoch_usec", "start_epoch_time_usec", "cpu_time_usec",
                 "wall_time_usec", "session")
        assert [{k: v for k, v in r.items() if k not in strip} for r in by[mine]] == \
            [{k: v for k, v in r.items() if k not in strip} for r in by[theirs]]

    def test_span_deserialize_reads_either_package(self):
        from torchx_tpu.obs import trace as jtrace

        with jtrace.span("theirs", k=1) as js:
            pass
        with obs_trace.span("mine", k=1) as ms:
            pass
        assert obs_trace.Span.deserialize(js.serialize()).__dict__ == js.__dict__
        assert jtrace.Span.deserialize(ms.serialize()).__dict__ == ms.__dict__

    def test_stitch_across_sessions_equal(self):
        from torchx_tpu.obs import stitch as jstitch
        from torchx_tpu_torch.obs import stitch

        with obs_trace.span("serve.route", request_id="req-parity"):
            headers = obs_trace.inject_headers({})
        tid, sid = obs_trace.extract_headers(headers)
        with obs_trace.trace_context(tid, sid):
            with obs_trace.span("serve.unified", sequences=1):
                pass
        # the replica's span in a session dir of its own
        path = sinks.trace_path()
        recs = timeline.load_records(path)
        keep = [r for r in recs if r.get("name") != "serve.unified"]
        move = [r for r in recs if r.get("name") == "serve.unified"]
        with open(path, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in keep)
        other = os.path.join(sinks.obs_root(), "tpx_replica")
        os.makedirs(other)
        with open(os.path.join(other, sinks.TRACE_FILE), "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in move)
        for ident in ("req-parity", tid):
            mine, theirs = stitch.stitch(ident), jstitch.stitch(ident)
            assert (mine.trace_id, mine.sessions, mine.span_count) == \
                (theirs.trace_id, theirs.sessions, theirs.span_count) == \
                (tid, sorted([os.path.dirname(path), other]), 2)
            assert stitch.render_stitched(mine) == jstitch.render_stitched(theirs)
            assert stitch.render_stitched(mine, include_events=True) == \
                jstitch.render_stitched(theirs, include_events=True)

    def test_load_metrics_and_table_equal(self, tmp_path):
        from torchx_tpu.obs import timeline as jtimeline

        import numpy as np

        rng = np.random.default_rng(11)
        d = tmp_path / "sess"
        d.mkdir()
        for pid in (1, 2, 3):
            reg = MetricsRegistry()
            c = reg.counter("tpx_c_total", "h", ("k",))
            h = reg.histogram("tpx_h_seconds", "h", buckets=(0.1, 1.0))
            for _ in range(5):
                c.inc(float(rng.integers(1, 9)), k=str(rng.integers(3)))
                h.observe(float(rng.uniform(0, 2)))
            (d / f"metrics-{pid}.prom").write_text(reg.render())
        rows = timeline.load_metrics(str(d))
        assert rows == jtimeline.load_metrics(str(d))
        for buckets in (False, True):
            assert timeline.render_metrics_table(rows, include_buckets=buckets) == \
                jtimeline.render_metrics_table(rows, include_buckets=buckets)

    def test_tpx_trace_and_tpx_torch_trace_print_the_same(self):
        from torchx_tpu.cli.main import main as jax_main
        from torchx_tpu_torch.cli.main import main as cli_main

        result, _ = supervise_with_preemption()
        tid = seeded_trace(obs_trace, record, TpxEvent, seed=5)
        sinks.flush_metrics()
        for argv in (["trace", result.handle, "--events", "--metrics"],
                     ["trace", tid, "--metrics", "--buckets"],
                     ["trace", "app_parity", "--stitch", "--events"],
                     ["trace", "no_such_app"], ["trace", "no_such_app", "--stitch"]):
            mine = run_cli(argv, cli_main)
            assert mine == run_cli(argv, jax_main), argv
            assert mine[1] or mine[0] == 1
