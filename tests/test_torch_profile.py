"""The port's step profiler and metrics textfile on the CPU, against the JAX
package's: ``StepProfiler.record_step``, ``summarize``, ``diff_summaries``
and ``render_summary`` equal the reference's on the same measured inputs
(exactly, apart from the record timestamp), a journal the port writes is
read by the JAX package's ``load_profile`` + ``summarize`` and its ``tpx
profile`` command to the same summary, the ``.prom`` textfile holds the
reference's family names and buckets, the prefetcher's wait observer, and
the trainer's ``--profile`` / ``TPX_PROFILE`` / ``--profile-dir``."""

import json
import logging
import os
import time

import numpy as np
import pytest

from torchx_tpu.analyze import costmodel as jcost
from torchx_tpu.analyze import plan as jplan
from torchx_tpu.obs import metrics as jmetrics
from torchx_tpu.obs import profile as jprofile
from torchx_tpu_torch.analyze import costmodel as tcost
from torchx_tpu_torch.examples import train_llama as ttrain
from torchx_tpu_torch.models import llama as tllama
from torchx_tpu_torch.obs import metrics as tmetrics
from torchx_tpu_torch.obs import profile as tprofile
from torchx_tpu_torch.obs import sinks
from torchx_tpu_torch.parallel.prefetch import Prefetcher
from torch_threads import xdist_torch_threads  # noqa: F401

#: Models of the attribution: the reference's test model (two mesh axes of
#: modeled collectives), one card (no collectives), and the llama3_1b
#: training step on one H100 (989e12 FLOP/s, 4 x 2048 tokens).
MODELS = {
    "two_axes": dict(flops_per_token=1000.0, tokens_per_step=100, peak_flops=1e6,
                     param_count=1000, comm_axis_s={"fsdp": 0.02, "dp": 0.01},
                     generation="cpu"),
    "one_card": dict(flops_per_token=1000.0, tokens_per_step=100, peak_flops=1e6,
                     param_count=1000, generation="cpu"),
    "llama3_1b_h100": dict(flops_per_token=tllama.llama3_1b(max_seq=2048).flops_per_token(),
                           tokens_per_step=8192, peak_flops=989e12,
                           param_count=tllama.llama3_1b().param_count(),
                           generation="NVIDIA H100 80GB HBM3"),
}


def _measured(seed, n=5):
    """Per step: (wall_s, measured phase seconds), drawn with numpy; some
    steps have a device slice below twice the optimizer's, or no save."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        fb = float(rng.choice([rng.uniform(0.0, 0.02), rng.uniform(0.1, 0.5)]))
        m = {"data_wait": float(rng.uniform(0, 0.05)), "forward_backward": fb,
             "host": float(rng.uniform(0, 0.01))}
        if i % 2:
            m["checkpoint"] = float(rng.uniform(0, 0.2))
        out.append((sum(m.values()) + float(rng.uniform(0, 1e-3)), m))
    return out


def _pair(name, tmp_path):
    kw = MODELS[name]
    jp = jprofile.StepProfiler(jprofile.AttributionModel(**kw),
                               path=str(tmp_path / "jax.jsonl"), clock=lambda: 1.0)
    tp = tprofile.StepProfiler(tprofile.AttributionModel(**kw),
                               path=str(tmp_path / "port.jsonl"), clock=lambda: 2.0)
    return jp, tp


def _no_ts(rec):
    return {k: v for k, v in rec.items() if k != "ts"}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_records_and_summaries_equal_the_reference(tmp_path, name):
    jp, tp = _pair(name, tmp_path)
    kw = MODELS[name]
    assert tp.model.to_dict() == jp.model.to_dict()
    for attr in ("ideal_compute_s", "optimizer_s", "total_comm_s", "compute_slack_s"):
        assert getattr(tp.model, attr) == getattr(jp.model, attr), attr
    jrecs, trecs = [], []
    for step, (wall, m) in enumerate(_measured(len(kw)), start=1):
        jrecs.append(jp.record_step(step, wall_s=wall, measured=dict(m)))
        trecs.append(tp.record_step(step, wall_s=wall, measured=dict(m)))
        assert _no_ts(trecs[-1]) == _no_ts(jrecs[-1])
        # the phases sum back to the measured slices
        assert sum(trecs[-1]["phases"].values()) + sum(
            trecs[-1]["grad_sync"].values()) == pytest.approx(sum(m.values()))
    ts, js = tprofile.summarize(trecs), jprofile.summarize(jrecs)
    assert ts == js
    assert tprofile.render_summary(ts) == jprofile.render_summary(js)
    half = tprofile.summarize(trecs[:2])
    assert tprofile.diff_summaries(half, ts) == jprofile.diff_summaries(
        jprofile.summarize(jrecs[:2]), js)


def test_the_jax_reader_reads_the_ports_journal(tmp_path, capsys):
    from torchx_tpu.cli.main import main

    _, tp = _pair("llama3_1b_h100", tmp_path)
    for step, (wall, m) in enumerate(_measured(3, n=4), start=1):
        tp.record_step(step, wall_s=wall, measured=m)
    summary = tp.close(calibrate=False)
    with open(tp.path, "ab") as f:  # a torn final line, as a kill leaves
        f.write(b'{"kind": "step", "wall_')
    jrecs = jprofile.load_profile(tp.path)
    assert jrecs == tprofile.load_profile(tp.path)
    assert [r["kind"] for r in jrecs] == ["meta"] + ["step"] * 4
    assert jprofile.summarize(jrecs) == summary == tprofile.summarize(
        tprofile.load_profile(str(tmp_path / "port.jsonl")))
    main(["profile", tp.path, "--json"])
    assert json.loads(capsys.readouterr().out)["steps"] == 4
    # a session directory names its journal
    os.replace(tp.path, tmp_path / tprofile.PROFILE_FILE)
    assert jprofile.load_profile(str(tmp_path)) == tprofile.load_profile(str(tmp_path))[:5]


def test_attribution_model_of_one_card():
    kw = {k: MODELS["one_card"][k]
          for k in ("flops_per_token", "tokens_per_step", "peak_flops", "param_count")}
    assert (tprofile.attribution_model(**kw).to_dict()
            == jprofile.attribution_model(**kw).to_dict())
    # pp's traffic is ported: a plan that sets it models the JAX cost
    # model's stage_activations bytes over the link rate
    tplan = tcost.ParallelPlan(model=tcost.ModelShape.of(tllama.llama_tiny()),
                               sizes={"pp": 2}, batch=8, seq=128)
    jp = jplan.ParallelPlan(role="train", model=jplan.MODEL_SHAPES["tiny"], mesh_spec="",
                            sizes={"pp": 2}, batch=8, seq=128)
    want = {t.axis: t.bytes_per_step / 10e9 for t in jcost.collective_traffic(jp)}
    assert tprofile.attribution_model(plan=tplan, **kw).comm_axis_s == want == {
        "pp": want["pp"]}
    assert tprofile.ASSUMED_MFU == __import__("torchx_tpu.tune.rank").tune.rank.ASSUMED_MFU
    assert tprofile.CORE_PHASES == jprofile.CORE_PHASES
    assert tprofile.PHASES == jprofile.PHASES
    assert tprofile.OPTIMIZER_FLOPS_PER_PARAM == jprofile.OPTIMIZER_FLOPS_PER_PARAM


@pytest.mark.parametrize("config", ["llama3_1b", "tiny"])
@pytest.mark.parametrize("dp,fsdp", [(1, 2), (2, 1), (2, 2), (1, 4)])
def test_collective_bytes_are_the_cost_models(config, dp, fsdp):
    """The data axes' bytes a step equal the JAX cost model's
    ``collective_traffic``, byte for byte; over the card's link rate (the
    CPU's the reference's CPU-sim figure) they are the attribution's
    modeled grad_sync seconds a gang's records carry."""
    sizes = {"dp": dp, "fsdp": fsdp}
    jp = jplan.ParallelPlan(role="train", model=jplan.MODEL_SHAPES[config], mesh_spec="",
                            sizes=sizes, batch=8, seq=128)
    tp = tcost.ParallelPlan(model=tcost.ModelShape.of(tllama.get_config(config)),
                            sizes=sizes, batch=8, seq=128)
    want = {t.axis: t.bytes_per_step for t in jcost.collective_traffic(jp)}
    got = {t.axis: t.bytes_per_step for t in tcost.collective_traffic(tp)}
    assert got == want and set(got) == {a for a, n in sizes.items() if n > 1}
    kw = {k: MODELS["one_card"][k]
          for k in ("flops_per_token", "tokens_per_step", "peak_flops", "param_count")}
    for gen, rate in (("cpu", 10e9), ("NVIDIA H100 80GB HBM3", 450e9)):
        model = tprofile.attribution_model(plan=tp, generation=gen, **kw)
        assert model.comm_axis_s == {a: b / rate for a, b in want.items()}


@pytest.mark.parametrize("config", ["llama3_1b", "tiny"])
@pytest.mark.parametrize("sizes", [dict(tp=2), dict(sp=2), dict(fsdp=2, tp=2),
                                   dict(dp=2, sp=2)],
                         ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_model_axes_bytes_are_the_cost_models(config, sizes):
    """The tp and sp terms (and fsdp's and dp's beside them) equal the JAX
    cost model's ``collective_traffic`` byte for byte, at llama3_1b's step
    shape (batch 4, seq 2048) and the tiny test shape."""
    batch, seq = (4, 2048) if config == "llama3_1b" else (4, 32)
    jp = jplan.ParallelPlan(role="train", model=jplan.MODEL_SHAPES[config], mesh_spec="",
                            sizes=sizes, batch=batch, seq=seq)
    tp = tcost.ParallelPlan(model=tcost.ModelShape.of(tllama.get_config(config)),
                            sizes=sizes, batch=batch, seq=seq)
    want = {t.axis: t.bytes_per_step for t in jcost.collective_traffic(jp)}
    got = {t.axis: t.bytes_per_step for t in tcost.collective_traffic(tp)}
    assert got == want and set(got) == set(sizes)


@pytest.mark.parametrize("config", ["mixtral_8x7b", "moe_tiny", "tiny"])
@pytest.mark.parametrize("sizes", [dict(ep=2), dict(fsdp=2, ep=2), dict(ep=2, tp=2)],
                         ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_ep_bytes_are_the_cost_models(config, sizes):
    """The ep term of a MoE plan and its parameter slice (the fsdp bytes
    divided by ep) equal the JAX cost model's ``collective_traffic`` byte
    for byte, at mixtral_8x7b's step shape (batch 4, seq 2048) and the tiny
    test shapes; a dense model under ep has no ep term and no ep slice."""
    batch, seq = (4, 2048) if config == "mixtral_8x7b" else (4, 32)
    jp = jplan.ParallelPlan(role="train", model=jplan.MODEL_SHAPES[config], mesh_spec="",
                            sizes=sizes, batch=batch, seq=seq)
    tp = tcost.ParallelPlan(model=tcost.ModelShape.of(tllama.get_config(config)),
                            sizes=sizes, batch=batch, seq=seq)
    want = {t.axis: t.bytes_per_step for t in jcost.collective_traffic(jp)}
    got = {t.axis: t.bytes_per_step for t in tcost.collective_traffic(tp)}
    assert got == want
    assert ("ep" in got) == (config != "tiny")


@pytest.mark.parametrize("config", ["llama3_1b", "tiny", "mixtral_8x7b"])
@pytest.mark.parametrize("sizes,ring", [
    (dict(pp=2), False), (dict(pp=4), False), (dict(pp=2, fsdp=2), False),
    (dict(pp=2, tp=2), False), (dict(pp=2, ep=2), False), (dict(sp=2), True),
    (dict(sp=4), True), (dict(pp=2, sp=2), True), (dict(pp=2, sp=2), False)],
    ids=lambda v: ",".join(f"{k}={n}" for k, n in v.items()) if isinstance(v, dict)
    else ("ring" if v else "gather"))
def test_pp_and_ring_bytes_are_the_cost_models(config, sizes, ring):
    """The pp term (stage_activations), the ring's sp term (ring_kv_permute)
    and every per-layer term at a stage's layers, ceil(n_layers / pp),
    equal the JAX cost model's ``collective_traffic`` byte for byte, at the
    presets' step shape (batch 4, seq 2048) and the tiny test shape."""
    batch, seq = (4, 32) if config == "tiny" else (4, 2048)
    jp = jplan.ParallelPlan(role="train", model=jplan.MODEL_SHAPES[config], mesh_spec="",
                            sizes=sizes, batch=batch, seq=seq, ring_attention=ring)
    tp = tcost.ParallelPlan(model=tcost.ModelShape.of(tllama.get_config(config)),
                            sizes=sizes, batch=batch, seq=seq, ring_attention=ring)
    want = {t.axis: t.bytes_per_step for t in jcost.collective_traffic(jp)}
    got = {t.axis: t.bytes_per_step for t in tcost.collective_traffic(tp)}
    assert got == want
    assert ("pp" in got) == (sizes.get("pp", 1) > 1)


def test_tp_bytes_count_a_stages_layers():
    """At pp=2,tp=2 the tp term counts the 8 layers of a stage of
    llama3_1b's 16, as the JAX term does: half the bytes of tp=2 alone."""
    m = tcost.ModelShape.of(tllama.get_config("llama3_1b"))
    traffic = {}
    for sizes in (dict(tp=2), dict(pp=2, tp=2)):
        plan = tcost.ParallelPlan(model=m, sizes=sizes, batch=4, seq=2048)
        traffic[len(sizes)] = {t.axis: t.bytes_per_step for t in tcost.collective_traffic(plan)}
    act = 4 * 2048 * 2 * 2048  # b x s x dtype bytes x dim
    assert traffic[2]["tp"] == int(4 * 8 * 2 * 0.5 * act) == traffic[1]["tp"] // 2


#: The training instruments, by the name of the module attribute.
INSTRUMENTS = ("LAUNCH_TO_FIRST_STEP", "STEP_SECONDS", "LAUNCH_STAGE_SECONDS",
               "PROFILE_PHASE_SECONDS", "PROFILE_MFU", "PROFILE_DATA_WAIT_FRAC",
               "PROFILE_OVERLAP_FRAC")


@pytest.mark.parametrize("attr", INSTRUMENTS)
def test_instruments_match_the_reference(attr):
    t, j = getattr(tmetrics, attr), getattr(jmetrics, attr)
    assert (t.name, t.help, t.kind, tuple(t.labelnames)) == (
        j.name, j.help, j.kind, tuple(j.labelnames))
    assert getattr(t, "buckets", None) == getattr(j, "buckets", None)


def test_prom_textfile_holds_the_reference_families(tmp_path, monkeypatch):
    monkeypatch.setenv("TPX_OBS_DIR", str(tmp_path))
    monkeypatch.delenv("TPX_TRACE", raising=False)
    tmetrics.STEP_SECONDS.observe(0.3, phase="total")
    tmetrics.LAUNCH_STAGE_SECONDS.observe(1.5, stage="import")
    _, tp = _pair("one_card", tmp_path)
    tp.record_step(1, wall_s=0.3, measured={"forward_backward": 0.25, "data_wait": 0.01,
                                              "host": 0.01})
    tp.close()  # exports the gauges and flushes the textfile
    path = sinks.metrics_path()
    assert path.startswith(str(tmp_path)) and path.endswith(f"metrics-{os.getpid()}.prom")
    text = open(path).read()
    for attr in INSTRUMENTS:
        assert f"# TYPE {getattr(jmetrics, attr).name} " in text, attr
    bounds = [float(b) for b in jmetrics.STEP_SECONDS.buckets]
    for b in bounds:
        assert f'tpx_step_seconds_bucket{{phase="total",le="{tmetrics._format_value(b)}"}}' in text
    assert 'tpx_profile_phase_seconds{phase="forward_backward"}' in text
    assert not [n for n in os.listdir(os.path.dirname(path)) if n.startswith(".metrics_")]
    monkeypatch.setenv("TPX_TRACE", "0")  # tracing off: nothing is written
    assert sinks.flush_metrics() is None


def test_prom_handler_debounces(tmp_path, monkeypatch):
    monkeypatch.setenv("TPX_OBS_DIR", str(tmp_path))
    now = [100.0]
    writes = []
    monkeypatch.setattr(sinks, "flush_metrics", lambda: writes.append(now[0]))
    h = sinks.PromMetricsHandler(min_interval_s=2.0, clock=lambda: now[0])
    rec = logging.LogRecord("x", logging.INFO, "", 0, "m", None, None)
    h.emit(rec)  # the first event of a quiet period writes
    now[0] += 0.5
    h.emit(rec)  # inside the interval: deferred
    assert writes == [100.0]
    now[0] += 2.0
    h.emit(rec)
    now[0] += 0.1
    h.emit(rec)
    h.close()  # the deferred state is written at close
    assert writes == [100.0, 102.5, 102.6]
    monkeypatch.setenv("TPX_METRICS_MIN_INTERVAL", "0.25")
    assert sinks.PromMetricsHandler().min_interval_s == 0.25


def test_wait_observer_sees_every_counted_wait():
    def slow():
        for i in range(4):
            time.sleep(0.01)
            yield i

    seen = []
    for depth in (0, 2):
        seen.clear()
        p = Prefetcher(slow(), depth=depth)
        p.set_wait_observer(seen.append)
        assert list(p) == [0, 1, 2, 3]
        assert len(seen) == 5  # the four batches and the end of the stream
        assert sum(seen) == pytest.approx(p.data_wait_s) and p.data_wait_s >= 0.01
        p.set_wait_observer(None)
        p.close()

    def boom(_):
        raise RuntimeError("observer fault")

    p = Prefetcher(iter([1, 2]), depth=0)
    p.set_wait_observer(boom)  # an observer never breaks the loop
    assert list(p) == [1, 2]


@pytest.fixture
def obs_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("TPX_OBS_DIR", str(tmp_path / "obs"))
    monkeypatch.delenv("TPX_TRACE", raising=False)
    monkeypatch.delenv("TPX_PROFILE", raising=False)
    # the CPU has no peak; give the attribution one, as a card would
    monkeypatch.setattr(ttrain, "device_peak_flops", lambda dev: 1e12)
    return tmp_path


def _check_profile(out, path, steps):
    recs = [r for r in tprofile.load_profile(path) if r["kind"] == "step"]
    timed = steps - 1
    assert len(recs) == timed and [r["step"] for r in recs] == list(range(2, steps + 1))
    for r in recs:
        for ph in tprofile.CORE_PHASES:
            assert r["phases"][ph] > 0, (ph, r)
        # the measured phases cover the step's wall time
        assert sum(r["phases"].values()) <= r["wall_s"]
        assert sum(r["phases"].values()) >= 0.5 * r["wall_s"]
    assert out["profile"] == jprofile.summarize(jprofile.load_profile(path))
    assert out["profile"]["steps"] == timed


def test_profile_flag_and_env(obs_dir, monkeypatch, capsys, tmp_path):
    ttrain.main(["--config", "tiny", "--batch", "2", "--seq", "16", "--steps", "4",
                 "--device", "cpu", "--profile"])
    out = json.loads(capsys.readouterr().out.split("final:", 1)[1])
    path = os.path.join(sinks.session_dir(), tprofile.PROFILE_FILE)
    _check_profile(out, path, 4)
    # the metrics textfile of the run holds its step histogram
    text = open(sinks.metrics_path()).read()
    assert 'tpx_step_seconds_count{phase="total"} ' in text
    os.remove(path)
    monkeypatch.setenv("TPX_PROFILE", "1")
    out = ttrain.train(tllama.llama_tiny(), 2, 16, 3, device="cpu", log_every=1)
    _check_profile(out, path, 3)
    monkeypatch.setenv("TPX_PROFILE", "0")
    out = ttrain.train(tllama.llama_tiny(), 2, 16, 2, device="cpu", log_every=1)
    assert out["profile"] is None


def test_data_wait_is_credited_from_a_token_file(obs_dir):
    path = obs_dir / "tokens.bin"
    np.random.default_rng(7).integers(0, 512, 4000).astype(np.uint32).tofile(path)
    out = ttrain.train(tllama.llama_tiny(), 2, 16, 4, device="cpu", log_every=1,
                       data_path=str(path), prefetch=0, profile=True)
    recs = [r for r in tprofile.load_profile(os.path.join(sinks.session_dir(),
                                                          tprofile.PROFILE_FILE))
            if r["kind"] == "step"]
    assert len(recs) == 3 and all(r["phases"]["data_wait"] > 0 for r in recs)
    # the profiled steps' waits are part of the run's data_wait_s
    assert sum(r["phases"]["data_wait"] for r in recs) <= out["data_wait_s"]


def test_profile_dir_writes_a_chrome_trace(obs_dir):
    trace_dir = obs_dir / "trace"
    out = ttrain.train(tllama.llama_tiny(), 2, 16, 3, device="cpu", log_every=0,
                       profile_dir=str(trace_dir))
    assert out["profile_trace"] == str(trace_dir / f"trace-{os.getpid()}.json")
    events = json.load(open(out["profile_trace"]))["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    assert out["profile"] is None
    # one step: the only step is the timed one
    out = ttrain.train(tllama.llama_tiny(), 2, 16, 1, device="cpu", log_every=1,
                       profile=True)
    assert out["profile"]["steps"] == 1
