"""The port's telemetry plane (``torchx_tpu_torch.obs.telemetry``,
``obs.slo``, ``obs.stitch``) held to the JAX package's own cases: the
exposition parser, the bounded MetricStore and its query reducers, the
scrape Collector, the SLO grammar and burn-rate engine with journaled
alert transitions, the stitched trace of one disaggregated serve request
(``tests/test_telemetry.py``'s ``TestParseExposition``,
``TestMetricStore``, ``TestCollector``, ``TestParseSlo``,
``TestSloEngine``, ``TestStitchServeRequest``), and the serve autoscaler's
burn input (``TestAutoscalerBurnInput``), each run against the copy. The
JAX file's fleet, control-daemon and ``tpx top`` cases wait for their
layers (ROADMAP queue 1 items 2.7 and 2.8). Added: parity with the JAX
package on the same inputs (``TestJaxParity``: both parsers read each
package's registry render into equal samples; one numpy-seeded series
ingested into both stores gives equal ``query`` results for every
reducer; both SLO engines give equal burn rates and alert transitions;
both Collectors scrape one ``/metricz`` alike; all exact)."""

import http.server
import json
import math
import os
import threading

import numpy as np
import pytest

from torchx_tpu_torch.obs import sinks, stitch, timeline
from torchx_tpu_torch.obs import trace as obs_trace
from torchx_tpu_torch.obs.slo import SLO_PRESETS, SloEngine, parse_slo
from torchx_tpu_torch.obs.telemetry import (
    Collector,
    MetricStore,
    PromSample,
    parse_exposition,
    scrape_metricz,
)
from torchx_tpu_torch.serve import kv_transfer
from torchx_tpu_torch.serve.pool import AutoscalePolicy, Autoscaler
from torch_threads import xdist_torch_threads  # noqa: F401


TTFT = "tpx_serve_ttft_seconds"


def ttft_text(le_05: int, inf: int, le_01: int = 0) -> str:
    """A TTFT histogram exposition: ``inf - le_05`` observations breach
    the 500ms p99-ttft threshold."""
    return (
        f"# HELP {TTFT} time to first token\n"
        f"# TYPE {TTFT} histogram\n"
        f'{TTFT}_bucket{{le="0.1"}} {le_01}\n'
        f'{TTFT}_bucket{{le="0.5"}} {le_05}\n'
        f'{TTFT}_bucket{{le="+Inf"}} {inf}\n'
        f"{TTFT}_sum {float(inf)}\n"
        f"{TTFT}_count {inf}\n"
    )


def store_with_clock(t0: float = 0.0, capacity: int = 720):
    clock = [t0]
    return MetricStore(capacity=capacity, clock=lambda: clock[0]), clock


# ---------------------------------------------------------------------------
# exposition parsing
# ---------------------------------------------------------------------------


class TestParseExposition:
    def test_typed_samples(self):
        text = (
            "# HELP tpx_runs_total runs\n"
            "# TYPE tpx_runs_total counter\n"
            'tpx_runs_total{scheduler="local"} 3\n'
            "# TYPE tpx_queue_depth gauge\n"
            "tpx_queue_depth 2.5\n"
        )
        samples = parse_exposition(text)
        assert samples == [
            PromSample(
                "tpx_runs_total", (("scheduler", "local"),), 3.0, "counter"
            ),
            PromSample("tpx_queue_depth", (), 2.5, "gauge"),
        ]

    def test_histogram_family_inherits_kind(self):
        samples = parse_exposition(ttft_text(10, 100))
        assert all(s.kind == "histogram" for s in samples)
        bucket = samples[2]
        assert bucket.labels == (("le", "+Inf"),)
        assert bucket.value == 100.0

    def test_trailing_timestamp_and_inf_values(self):
        samples = parse_exposition(
            "a 1 1690000000\nb +Inf\nc -Inf\nd -3.5e-2\n"
        )
        assert [(s.name, s.value) for s in samples] == [
            ("a", 1.0),
            ("b", math.inf),
            ("c", -math.inf),
            ("d", -0.035),
        ]

    def test_label_escapes_and_brace_in_value(self):
        text = 'm{msg="a\\"b\\\\c\\nd",shape="{2,4}"} 7\n'
        (s,) = parse_exposition(text)
        assert dict(s.labels) == {"msg": 'a"b\\c\nd', "shape": "{2,4}"}
        assert s.value == 7.0

    def test_torn_lines_skip_only_themselves(self):
        text = (
            "good 1\n"
            'torn{a="trunca'  # no closing brace: writer died mid-line
            "\n"
            'half{a="x",b="tr} 2\n'  # torn INSIDE a quoted value
            "bad_value nope\n"
            "also_good 2\n"
        )
        samples = parse_exposition(text)
        assert [s.name for s in samples] == ["good", "also_good"]


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------


class TestMetricStore:
    def test_latest_sums_across_sources(self):
        store, _ = store_with_clock()
        store.ingest_text("r0", "# TYPE c counter\nc 3\n")
        store.ingest_text("r1", "# TYPE c counter\nc 4\n")
        assert store.latest("c") == {(): 7.0}
        assert store.kind_of("c") == "counter"
        assert store.names() == ["c"]
        assert len(store) == 2  # one per-source series each

    def test_ring_buffer_is_bounded(self):
        store, clock = store_with_clock(capacity=4)
        for i in range(10):
            clock[0] = float(i)
            store.ingest_text("r0", f"g {i}\n")
        doc = store.query("g")
        (series,) = doc["series"]
        assert len(series["points"]) == 4
        assert series["points"][-1] == [9.0, 9.0]

    def test_scalar_reducers(self):
        store, clock = store_with_clock()
        for i, v in enumerate([1.0, 5.0, 3.0]):
            clock[0] = float(i * 10)
            store.ingest_text("r0", f"g {v}\n")
        clock[0] = 20.0
        assert store.query("g", reduce="last")["result"][0]["value"] == 3.0
        assert store.query("g", reduce="max")["result"][0]["value"] == 5.0
        assert store.query("g", reduce="min")["result"][0]["value"] == 1.0
        assert store.query("g", reduce="avg")["result"][0]["value"] == 3.0

    def test_rate_survives_counter_reset(self):
        store, clock = store_with_clock()
        for t, v in [(0.0, 100.0), (10.0, 160.0), (20.0, 40.0)]:
            clock[0] = t
            store.ingest_text("r0", f"# TYPE c counter\nc {v}\n")
        # increase = 60 (100->160) + 40 (post-reset value) = 100 over 20s
        doc = store.query("c", reduce="rate", range_s=20.0)
        assert doc["result"][0]["value"] == pytest.approx(5.0)

    def test_percentile_from_bucket_deltas(self):
        store, clock = store_with_clock()
        store.ingest_text("r0", ttft_text(0, 0), ts=0.0)
        # 90 of 100 new observations land in (0.1, 0.5]
        store.ingest_text("r0", ttft_text(90, 100, le_01=0), ts=30.0)
        clock[0] = 30.0
        doc = store.query(TTFT, reduce="p50", range_s=60.0)
        value = doc["result"][0]["value"]
        assert 0.1 < value <= 0.5
        # p99 rank falls in the +Inf bucket -> clamp to last finite bound
        doc = store.query(TTFT, reduce="p99", range_s=60.0)
        assert doc["result"][0]["value"] == pytest.approx(0.5)

    def test_unknown_reducer_raises(self):
        store, _ = store_with_clock()
        store.ingest_text("r0", "g 1\n")
        with pytest.raises(ValueError, match="unknown reducer"):
            store.query("g", reduce="median")

    def test_render_prom_round_trips_through_the_parser(self):
        store, _ = store_with_clock()
        text = (
            "# TYPE tpx_requests_total counter\n"
            'tpx_requests_total{status="ok",msg="a\\"b\\\\c"} 5\n'
        )
        store.ingest_text("r0", text)
        store.ingest_text("r1", text)
        reparsed = parse_exposition(store.render_prom())
        (s,) = [r for r in reparsed if r.name == "tpx_requests_total"]
        assert s.kind == "counter"
        assert s.value == 10.0  # summed aggregate survived the round trip
        assert dict(s.labels) == {"status": "ok", "msg": 'a"b\\c'}


# ---------------------------------------------------------------------------
# the collector
# ---------------------------------------------------------------------------


class _MetriczHandler(http.server.BaseHTTPRequestHandler):
    body = "# TYPE up gauge\nup 1\n"

    def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler API
        data = self.body.encode()
        self.send_response(200)
        self.send_header("Content-Type", "text/plain; version=0.0.4")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, *args):  # quiet
        pass


@pytest.fixture
def metricz_server():
    srv = http.server.HTTPServer(("127.0.0.1", 0), _MetriczHandler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()


class TestCollector:
    def test_scrapes_http_targets(self, metricz_server, tmp_path):
        store, _ = store_with_clock()
        col = Collector(store, interval_s=999, obs_dir=str(tmp_path / "none"))
        src = col.add_target(metricz_server, name="replica-0")
        assert src == "replica-0"
        assert col.collect_once() == 1
        assert store.latest("up") == {(): 1.0}
        assert col.errors == {}
        assert scrape_metricz(metricz_server).startswith("# TYPE up")

    def test_dead_target_is_data_not_an_exception(self, tmp_path):
        store, _ = store_with_clock()
        col = Collector(store, interval_s=999, obs_dir=str(tmp_path / "none"))
        col.add_target("http://127.0.0.1:9", name="gone")
        assert col.collect_once() == 0
        assert "gone" in col.errors
        assert col.remove_target("gone") is True
        assert col.remove_target("gone") is False
        assert col.targets() == {}

    def test_tails_textfile_sessions_per_file(self, tmp_path):
        root = tmp_path / "obsroot"
        for session, pid, v in [("s1", 11, 3), ("s1", 22, 4), ("s2", 33, 5)]:
            d = root / session
            d.mkdir(parents=True, exist_ok=True)
            (d / f"metrics-{pid}.prom").write_text(
                f"# TYPE tpx_runs_total counter\ntpx_runs_total {v}\n"
            )
        store, _ = store_with_clock()
        col = Collector(store, interval_s=999, obs_dir=str(root))
        assert col.collect_once() == 3
        # per-pid files are distinct sources; the read side sums them
        assert store.latest("tpx_runs_total") == {(): 12.0}
        assert len(store) == 3

    def test_hooks_run_and_never_kill_the_cycle(self, tmp_path):
        store, _ = store_with_clock()
        col = Collector(store, interval_s=999, obs_dir=str(tmp_path / "none"))
        seen = []
        col.hooks.append(lambda: seen.append("ok"))
        col.hooks.append(lambda: 1 / 0)
        col.collect_once()
        col.collect_once()
        assert seen == ["ok", "ok"]
        assert col.cycles == 2


# ---------------------------------------------------------------------------
# the SLO engine
# ---------------------------------------------------------------------------


class TestParseSlo:
    def test_presets(self):
        spec = parse_slo("p99-ttft")
        assert spec.metric == TTFT and spec.kind == "latency"
        assert spec.threshold_s == 0.5 and spec.objective == 0.99
        for name in SLO_PRESETS:
            parse_slo(name)  # every preset must parse

    def test_latency_grammar_with_ms_suffix(self):
        spec = parse_slo("fast:my_hist<250ms@0.95")
        assert spec.threshold_s == 0.25
        assert spec.budget == pytest.approx(0.05)

    def test_ratio_grammar(self):
        spec = parse_slo('gp:req_total{status="ok"}/req_total@0.999')
        assert spec.kind == "ratio"
        assert spec.good_labels == {"status": "ok"}

    def test_rejects_garbage(self):
        with pytest.raises(ValueError, match="unparseable SLO"):
            parse_slo("nonsense")
        with pytest.raises(ValueError, match="objective"):
            parse_slo("x:m<1s@1.5")
        with pytest.raises(ValueError, match="one metric"):
            parse_slo("x:a/b@0.9")


class TestSloEngine:
    def engine(self, tmp_path, spec="p99-ttft"):
        store, clock = store_with_clock()
        journal = str(tmp_path / "slo_alerts.jsonl")
        eng = SloEngine(
            store, [parse_slo(spec)], journal_path=journal,
            clock=lambda: clock[0],
        )
        return eng, store, clock, journal

    def test_induced_regression_pages_once(self, tmp_path):
        eng, store, clock, journal = self.engine(tmp_path)
        store.ingest_text("r0", ttft_text(0, 0), ts=0.0)
        # 90% of requests breach 500ms: burn 0.9/0.01 = 90 >> fast_burn
        store.ingest_text("r0", ttft_text(10, 100), ts=50.0)
        clock[0] = 50.0
        (alert,) = eng.evaluate()
        assert alert.severity == "page" and alert.state == "firing"
        assert alert.burn_short >= 14 and alert.burn_long >= 14
        assert [a.slo for a in eng.active()] == ["p99-ttft"]
        assert eng.max_burn() >= 14
        assert eng.max_burn("tpx_serve") >= 14
        assert eng.max_burn("tpx_step") == 0.0
        # still firing: burns refresh, nothing re-journaled
        assert eng.evaluate() == []
        lines = open(journal).read().splitlines()
        assert len(lines) == 1
        rec = json.loads(lines[0])
        assert rec["kind"] == "slo_alert" and rec["severity"] == "page"

    def test_steady_run_trips_nothing(self, tmp_path):
        eng, store, clock, journal = self.engine(tmp_path)
        store.ingest_text("r0", ttft_text(0, 0), ts=0.0)
        store.ingest_text("r0", ttft_text(100, 100), ts=50.0)  # all < 500ms
        clock[0] = 50.0
        assert eng.evaluate() == []
        assert eng.active() == []
        assert not os.path.exists(journal)  # no transition, no journal
        assert eng.burns()["p99-ttft"] == (0.0, 0.0)

    def test_recovery_journals_resolved(self, tmp_path):
        eng, store, clock, journal = self.engine(tmp_path)
        store.ingest_text("r0", ttft_text(0, 0), ts=0.0)
        store.ingest_text("r0", ttft_text(10, 100), ts=50.0)
        clock[0] = 50.0
        eng.evaluate()
        # a fast clean minute: the short window drops under the threshold
        store.ingest_text("r0", ttft_text(1010, 1100), ts=700.0)
        clock[0] = 700.0
        (alert,) = eng.evaluate()
        assert alert.state == "resolved"
        assert eng.active() == []
        kinds = [
            json.loads(l)["state"] for l in open(journal).read().splitlines()
        ]
        assert kinds == ["firing", "resolved"]

    def test_ratio_burn(self, tmp_path):
        eng, store, clock, _ = self.engine(tmp_path, spec="goodput")
        base = (
            "# TYPE tpx_serve_requests_total counter\n"
            'tpx_serve_requests_total{{status="ok"}} {ok}\n'
            'tpx_serve_requests_total{{status="error"}} {err}\n'
        )
        store.ingest_text("r0", base.format(ok=1000, err=0), ts=0.0)
        store.ingest_text("r0", base.format(ok=1990, err=10), ts=30.0)
        clock[0] = 30.0
        # 1% errors against a 0.1% budget: burn 10 -> warn, not page
        (alert,) = eng.evaluate()
        assert alert.severity == "warn"
        short, long_ = eng.burns()["goodput"]
        assert short == pytest.approx(10.0, rel=0.01)

    def test_zero_traffic_is_zero_burn(self, tmp_path):
        eng, _, clock, journal = self.engine(tmp_path)
        clock[0] = 100.0
        assert eng.evaluate() == []
        assert eng.burns()["p99-ttft"] == (0.0, 0.0)
        assert not os.path.exists(journal)


# ---------------------------------------------------------------------------
# stitching: the acceptance scenarios
# ---------------------------------------------------------------------------


def _split_sessions(names_to_move: set, other_session: str) -> None:
    """Rewrite this process's trace.jsonl keeping only some spans, moving
    the rest into a second session dir — simulating the decode replica's
    separate obs session without a second process."""
    path = sinks.trace_path()
    records = timeline.load_records(path)
    keep, move = [], []
    for r in records:
        (move if r.get("name") in names_to_move else keep).append(r)
    with open(path, "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in keep)
    other = os.path.join(sinks.obs_root(), other_session)
    os.makedirs(other, exist_ok=True)
    with open(os.path.join(other, sinks.TRACE_FILE), "a") as f:
        f.writelines(json.dumps(r) + "\n" for r in move)


def make_payload(request_id: str) -> kv_transfer.KvPayload:
    kv = np.zeros((1, 1, 1, 1, 1), dtype=np.float32)
    return kv_transfer.KvPayload(
        request_id=request_id,
        tokens=[1, 2],
        generated=[3],
        cache_len=2,
        max_new_tokens=4,
        temperature=0.0,
        seed=0,
        eos_id=None,
        block_size=1,
        k=kv,
        v=kv,
    )


class TestStitchServeRequest:
    def test_disagg_request_is_one_stitched_trace(self):
        rid = "req-stitch-01"
        # router: open the request span, stamp the HTTP headers
        with obs_trace.span("serve.route", request_id=rid):
            headers = obs_trace.inject_headers({})
        # prefill replica: adopt the header context, stamp the payload
        payload = make_payload(rid)
        tid, sid = obs_trace.extract_headers(headers)
        with obs_trace.trace_context(tid, sid):
            with obs_trace.span("serve.prefill", request_id=rid):
                kv_transfer.stamp_trace(payload)
        assert payload.trace_id == tid
        # transfer + decode: only the payload's trace context crosses
        with kv_transfer.payload_span(payload, "serve.kv_transfer"):
            pass
        with kv_transfer.payload_span(payload, "serve.decode"):
            pass
        # decode's spans live in ANOTHER session dir
        _split_sessions({"serve.kv_transfer", "serve.decode"}, "tpx_decode")

        records, _ = stitch.collect_records()
        assert stitch.resolve_trace_ids(records, rid) == [tid]  # exactly one
        st = stitch.stitch(rid)
        assert st is not None and st.trace_id == tid
        assert st.span_count == 4
        assert len(st.sessions) == 2
        (root,) = st.roots
        assert root.span.name == "serve.route"
        (prefill,) = root.children
        assert prefill.span.name == "serve.prefill"
        assert sorted(c.span.name for c in prefill.children) == [
            "serve.decode",
            "serve.kv_transfer",
        ]
        rendered = stitch.render_stitched(st)
        assert "4 spans from 2 sessions" in rendered
        assert "serve.kv_transfer" in rendered

    def test_unstamped_payload_spans_do_not_join(self):
        rid = "req-stitch-02"
        with obs_trace.span("serve.route", request_id=rid) as route:
            pass
        payload = make_payload(rid)  # never stamped: pre-trace sender
        with kv_transfer.payload_span(payload, "serve.decode") as sp:
            assert sp.trace_id != route.trace_id

    def test_stitch_unknown_ident_is_none(self):
        assert stitch.stitch("no-such-request") is None


class TestAutoscalerBurnInput:
    def policy(self):
        return AutoscalePolicy(
            min_replicas=1, max_replicas=4, up_streak=1,
            down_streak=1, cooldown_s=0.0,
        )

    def test_burning_counts_as_hot_even_when_calm(self):
        asc = Autoscaler(self.policy(), clock=lambda: 0.0)
        assert asc.observe(2, queue_depth=0.0, burn_rate=2.0) == 3

    def test_burning_vetoes_scale_down(self):
        asc = Autoscaler(self.policy(), clock=lambda: 0.0)
        # calm queue + intact budgets: the normal scale-down fires
        assert asc.observe(2, queue_depth=0.0, burn_rate=0.2) == 1

    def test_no_signal_preserves_depth_behavior(self):
        asc = Autoscaler(self.policy(), clock=lambda: 0.0)
        assert asc.observe(2, queue_depth=10.0) == 3


# ---------------------------------------------------------------------------
# parity with the JAX package on the same inputs (exact)
# ---------------------------------------------------------------------------


def _rows(samples):
    return [(s.name, s.labels, s.value, s.kind) for s in samples]


def seeded_scrapes(seed: int, n: int = 12):
    """``n`` scrapes of three sources, 10 s apart: a counter per status
    (with one reset), a gauge, and a TTFT histogram whose cumulative
    buckets grow by numpy-seeded increments. -> [(ts, source, text)]."""
    rng = np.random.default_rng(seed)
    out = []
    state = {src: {"ok": 0, "err": 0, "b": [0, 0, 0]} for src in ("r0", "r1", "file:s/m.prom")}
    for i in range(n):
        for src, st in state.items():
            st["ok"] += int(rng.integers(0, 50))
            st["err"] += int(rng.integers(0, 3))
            if src == "r1" and i == n // 2:
                st["ok"] = int(rng.integers(0, 5))  # the replica restarted
            inc = rng.integers(0, 20, size=3)
            st["b"] = [st["b"][0] + int(inc[0]), st["b"][1] + int(inc[0] + inc[1]),
                       st["b"][2] + int(inc.sum())]
            text = (
                "# TYPE tpx_serve_requests_total counter\n"
                f'tpx_serve_requests_total{{status="ok"}} {st["ok"]}\n'
                f'tpx_serve_requests_total{{status="error"}} {st["err"]}\n'
                "# TYPE tpx_serve_queue_depth gauge\n"
                f"tpx_serve_queue_depth {float(rng.uniform(0, 8))}\n"
                + ttft_text(st["b"][1], st["b"][2], le_01=st["b"][0])
            )
            out.append((10.0 * i, src, text))
    return out


class TestJaxParity:
    def test_parsers_read_each_registry_alike(self):
        from torchx_tpu.obs import metrics as jmetrics
        from torchx_tpu.obs.telemetry import parse_exposition as jparse
        from torchx_tpu_torch.obs import metrics as tmetrics

        rng = np.random.default_rng(0)
        for mod in (jmetrics, tmetrics):
            reg = mod.MetricsRegistry()
            c = reg.counter("p_total", "h", ("path",))
            c.inc(3, path='a"b\\c\nd{}')
            h = reg.histogram("p_seconds", "h", buckets=(0.1, 0.5, 1.0))
            for v in rng.uniform(0, 2, 50):
                h.observe(float(v))
            reg.gauge("p_gauge", "h").set(float(rng.normal()))
            assert len(parse_exposition(reg.render())) == 8  # 1 + 6 of h + 1
            for text in (reg.render(), mod.REGISTRY.render()):
                assert _rows(parse_exposition(text)) == _rows(jparse(text))

    def test_store_queries_equal_for_every_reducer(self):
        from torchx_tpu.obs.telemetry import MetricStore as JStore

        clock = [0.0]
        mine = MetricStore(capacity=8, clock=lambda: clock[0])
        theirs = JStore(capacity=8, clock=lambda: clock[0])
        for ts, src, text in seeded_scrapes(7):
            assert mine.ingest_text(src, text, ts=ts) == theirs.ingest_text(src, text, ts=ts)
        clock[0] = 115.0
        assert mine.names() == theirs.names() and len(mine) == len(theirs)
        assert mine.render_prom() == theirs.render_prom()
        reducers = ("last", "sum", "avg", "max", "min", "rate", "p50", "p90", "p95", "p99")
        cases = 0
        for name in ("tpx_serve_requests_total", "tpx_serve_queue_depth", TTFT,
                     f"{TTFT}_count"):
            for labels in (None, {"status": "ok"}):
                for range_s in (None, 30.0, 120.0):
                    for reduce in (None, *reducers):
                        doc = mine.query(name, labels=labels, reduce=reduce, range_s=range_s)
                        assert doc == theirs.query(name, labels=labels, reduce=reduce,
                                                   range_s=range_s), (name, reduce, range_s)
                        cases += bool(doc.get("result"))
            assert mine.histogram_deltas(TTFT, 60.0) == theirs.histogram_deltas(TTFT, 60.0)
        assert cases > 60  # the reducers produced values, not empty results

    def test_slo_engines_burn_and_alert_alike(self, tmp_path):
        from torchx_tpu.obs.slo import SloEngine as JEngine
        from torchx_tpu.obs.slo import parse_slo as jparse_slo
        from torchx_tpu.obs.telemetry import MetricStore as JStore

        clock = [0.0]
        specs = ["p99-ttft", "goodput", "fast:tpx_serve_ttft_seconds<100ms@0.9"]
        mine_store = MetricStore(clock=lambda: clock[0])
        theirs_store = JStore(clock=lambda: clock[0])
        mine = SloEngine(mine_store, [parse_slo(s) for s in specs],
                         journal_path=str(tmp_path / "mine.jsonl"), clock=lambda: clock[0])
        theirs = JEngine(theirs_store, [jparse_slo(s) for s in specs],
                         journal_path=str(tmp_path / "theirs.jsonl"), clock=lambda: clock[0])
        transitions = 0
        for ts, src, text in seeded_scrapes(3, n=40):
            mine_store.ingest_text(src, text, ts=ts)
            theirs_store.ingest_text(src, text, ts=ts)
            clock[0] = ts
            a = [x.to_json() for x in mine.evaluate()]
            assert a == [x.to_json() for x in theirs.evaluate()]
            transitions += len(a)
            assert mine.burns() == theirs.burns()
            assert [x.to_json() for x in mine.active()] == \
                [x.to_json() for x in theirs.active()]
            for prefix in (None, "tpx_serve", "tpx_step"):
                assert mine.max_burn(prefix) == theirs.max_burn(prefix)
        assert transitions  # the seeded load fires (and clears) alerts
        assert (tmp_path / "mine.jsonl").read_text() == (tmp_path / "theirs.jsonl").read_text()

    def test_collectors_scrape_alike(self, metricz_server, tmp_path):
        from torchx_tpu.obs.telemetry import Collector as JCollector
        from torchx_tpu.obs.telemetry import MetricStore as JStore

        root = tmp_path / "obsroot"
        for session, pid, v in [("s1", 11, 3), ("s2", 33, 5)]:
            d = root / session
            d.mkdir(parents=True)
            (d / f"metrics-{pid}.prom").write_text(
                f"# TYPE tpx_runs_total counter\ntpx_runs_total {v}\n")
        stores = (MetricStore(clock=lambda: 5.0), JStore(clock=lambda: 5.0))
        got = []
        for store, cls in zip(stores, (Collector, JCollector)):
            col = cls(store, interval_s=999, obs_dir=str(root), clock=lambda: 5.0)
            col.add_target(metricz_server, name="replica-0")
            col.add_target("http://127.0.0.1:9", name="gone")
            got.append((col.collect_once(), sorted(col.errors), store.render_prom(),
                        store.query("tpx_runs_total", reduce="sum")))
        assert got[0] == got[1]
        assert got[0][0] == 3 and got[0][1] == ["gone"]
