"""The port's memory fit before launch, on the CPU: the traced probe
(:mod:`torchx_tpu_torch.parallel.aot_fit`), its subprocess ABI, the fit
table, and the analytic ``hbm_fit`` (:mod:`torchx_tpu_torch.analyze.costmodel`),
held to the JAX package's.

* ``args_bytes`` of the probe for ``llama_tiny`` and ``moe_tiny`` at
  ``fsdp=4,tp=2`` against JAX's ``compile_fit`` on the 8-device CPU mesh:
  equal once three differences are taken out, each computed here from the
  shapes: JAX's three int32 step counters (the port counts its steps on
  the host), the token buffer (JAX's ``[b/4, s+1]`` int32, the port's
  int64), and the caching allocator's rounding of each of the port's
  storages to 512 bytes.
* ``temp_bytes`` rises from ``full`` to ``dots`` to ``dots_attn`` by the
  bytes each policy saves a layer, times the layers.
* ``hbm_fit`` equals JAX's component by component for the same plan and
  budget, at several meshes and policies, training and serving.
* ``python -m torchx_tpu_torch.parallel.aot_fit`` in a subprocess: a JSON
  list in, one JSON line out, a bad request its own ``error``.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch.distributed as dist

from torchx_tpu.analyze import costmodel as jcost
from torchx_tpu.analyze import plan as jplan
from torchx_tpu.models import llama as jllama
from torchx_tpu.models import moe as jmoe
from torchx_tpu.parallel import aot_fit as jfit
from torchx_tpu.parallel.mesh import MeshConfig, make_mesh
from torchx_tpu_torch.analyze import costmodel
from torchx_tpu_torch.apps import aot_memory_fit
from torchx_tpu_torch.models import llama as tllama
from torchx_tpu_torch.models import moe as tmoe
from torchx_tpu_torch.parallel import aot_fit
from torchx_tpu_torch.parallel.mesh_config import parse_mesh_spec
from torch_threads import xdist_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, SEQ = 8, 64


@pytest.mark.parametrize("name", ["llama_tiny", "moe_tiny"])
def test_args_bytes_match_jax(name):
    cfg_j = {"llama_tiny": jllama.llama_tiny, "moe_tiny": jmoe.moe_tiny}[name]()
    cfg_t = {"llama_tiny": tllama.llama_tiny, "moe_tiny": tmoe.moe_tiny}[name]()
    mesh = make_mesh(MeshConfig(fsdp=4, tp=2), devices=jax.devices()[:8])
    want = jfit.compile_fit(cfg_j, mesh, BATCH, SEQ).args_bytes
    got = aot_fit.trace_fit(cfg_t, "fsdp=4,tp=2", BATCH, SEQ)
    with aot_fit.gang_mesh("fsdp=4,tp=2") as m:
        params, opt = aot_fit.abstract_train_state(
            dataclasses.replace(cfg_t, max_seq=SEQ), m)
        state = [t.untyped_storage().nbytes()
                 for t in tllama.leaves(params) + opt.mu + opt.nu]
    rows = BATCH // 4
    counters, jax_tokens, port_tokens = 3 * 4, rows * (SEQ + 1) * 4, rows * (SEQ + 1) * 8
    assert sum(state) == want - counters - jax_tokens
    assert got.args_bytes == sum(map(aot_fit.alloc_bytes, state + [port_tokens]))


def test_temps_rise_by_the_saved_bytes():
    """``llama_tiny`` (2 layers, b 2, s 64, f32, the plain attention): a
    layer's q, k, v, ``wo``, gate and up products under ``dots``, its
    ``attn_out`` more under ``dots_attn`` (tests/test_torch_remat.py holds
    these to JAX's residuals)."""
    cfg = tllama.llama_tiny(remat=True, kernels="cuda")
    temps = {p: aot_fit.trace_fit(dataclasses.replace(cfg, remat_policy=p), None, 2, 64)
             for p in ("full", "dots", "dots_attn")}
    tok = 2 * 64 * 4  # one f32 unit of width a token
    d, kv, f = cfg.dim, cfg.n_kv_heads * cfg.head_dim, cfg.ffn_dim
    dots = tok * (d + 2 * kv + d + 2 * f)
    attn = tok * cfg.n_heads * cfg.head_dim
    assert temps["dots"].temp_bytes - temps["full"].temp_bytes == cfg.n_layers * dots
    assert temps["dots_attn"].temp_bytes - temps["dots"].temp_bytes == cfg.n_layers * attn
    for r in temps.values():
        assert r.peak_bytes == r.args_bytes + r.temp_bytes and r.fits


def test_probe_leaves_no_group_and_refuses_a_live_one(tmp_path):
    aot_fit.trace_fit(tllama.llama_tiny(), "fsdp=2", 4, 32)
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        with pytest.raises(RuntimeError, match="subprocess"):
            aot_fit.trace_fit(tllama.llama_tiny(), "fsdp=2", 4, 32)
    finally:
        dist.destroy_process_group()


def _plans(model_j, model_t, sizes, batch, seq, **kw):
    common = dict(sizes=sizes, batch=batch, seq=seq, **kw)
    return (jplan.ParallelPlan(role="trainer", model=model_j, mesh_spec="", **common,
                               hbm_bytes_per_chip=aot_fit.H100_HBM_BYTES,
                               hbm_source="override"),
            costmodel.ParallelPlan(model=model_t, **common,
                                   hbm_bytes_per_chip=aot_fit.H100_HBM_BYTES,
                                   hbm_source="override"))


CASES = [
    ("llama3_1b", "fsdp=1", 4, 2048, "full", {}),
    ("llama3_1b", "fsdp=1", 4, 2048, "dots", {}),
    ("llama3_1b", "fsdp=1", 4, 2048, "dots_attn", {}),
    ("llama3_8b", "fsdp=2,tp=2", 8, 4096, "dots", {}),
    ("llama3_1b", "dp=2,sp=2", 8, 2048, "dots_attn", {}),
    ("llama3_1b", "pp=2", 4, 2048, "full", {}),
    ("llama3_1b", "pp=2,fsdp=2", 8, 2048, "dots", {}),
    ("mixtral_8x7b", "pp=2,ep=2", 4, 2048, "dots_attn", {}),
    ("mixtral_8x7b", "fsdp=2,ep=2", 4, 2048, "full", {}),
    ("moe_tiny", "ep=2,tp=2", 8, 64, "dots", {}),
    ("llama3_8b", "tp=2", 1, 8192, "full", dict(serve=True, max_batch=8)),
    ("llama3_8b", "fsdp=1", 1, 8192, "full",
     dict(serve=True, int8=True, max_batch=16, prefix_reserve=0.25)),
]


@pytest.mark.parametrize("config,mesh,batch,seq,policy,serve", CASES)
def test_hbm_fit_matches_jax(config, mesh, batch, seq, policy, serve):
    cfg = tllama.get_config(config)
    sizes = parse_mesh_spec(mesh).resolve(int(np.prod(
        [int(v.split("=")[1]) for v in mesh.split(",")])))
    plan_j, plan_t = _plans(jplan.MODEL_SHAPES[config], costmodel.ModelShape.of(cfg), sizes,
                            batch, seq, remat_policy=policy, **serve)
    want, got = jcost.hbm_fit(plan_j), costmodel.hbm_fit(plan_t)
    assert got.components == want.components
    assert got.to_dict() == want.to_dict()


def test_hbm_fit_reckons_one_residual_more_than_dots_saves():
    """The reference's ``dots`` reckoning counts the MLP residual add,
    which JAX's checkpoint does not save (nor the port's): at llama_tiny,
    with the layer input, 576 units of width a token and a layer against
    512 saved (ROADMAP queue 3); beyond the input, 512 against 448."""
    cfg = tllama.llama_tiny()
    plans = {p: costmodel.ParallelPlan(model=costmodel.ModelShape.of(cfg),
                                       sizes={}, batch=2, seq=64, remat_policy=p)
             for p in ("full", "dots")}
    acts = {p: costmodel.hbm_fit(plan).components["activations"] for p, plan in plans.items()}
    per_unit = 2 * 64 * 4 * cfg.n_layers
    assert (acts["dots"] - acts["full"]) // per_unit == 512
    saved = aot_fit.trace_fit(tllama.llama_tiny(remat=True, remat_policy="dots"), None, 2, 64)
    base = aot_fit.trace_fit(tllama.llama_tiny(remat=True), None, 2, 64)
    assert (saved.temp_bytes - base.temp_bytes) // per_unit == 512 - cfg.dim


def _probe(requests):
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-m", "torchx_tpu_torch.parallel.aot_fit"],
                          input=json.dumps(requests), capture_output=True, text=True,
                          env=env, timeout=300, check=False)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    return json.loads(lines[0])


def test_probe_main_abi():
    good = {"config": "tiny", "mesh_spec": "fsdp=2,tp=2", "batch": 4, "seq": 32,
            "remat_policy": "dots", "overrides": {"remat": True}}
    bad = {"config": "no_such_config", "mesh_spec": "", "batch": 4, "seq": 32}
    odd = {"config": "tiny", "mesh_spec": "fsdp=3", "batch": 4, "seq": 32}
    out = _probe([good, bad, odd])
    assert [r["request"] for r in out] == [good, bad, odd]
    assert out[0]["remat_policy"] == "dots" and out[0]["fits"]
    direct = aot_fit.trace_fit(tllama.llama_tiny(remat=True, remat_policy="dots",
                                                 kernels="cuda"), "fsdp=2,tp=2", 4, 32)
    assert out[0]["peak_bytes"] == direct.peak_bytes
    assert "unknown config" in out[1]["error"]
    assert "error" in out[2] and "fits" not in out[2]


def test_probe_request_rebuilds_the_config():
    cfg = tmoe.moe_tiny(n_layers=3, remat=True, remat_policy="dots_attn", kernels="cuda")
    req = aot_fit.probe_request(cfg, "ep=2", 4, 64)
    assert aot_fit._request_cfg(json.loads(json.dumps(req))) == cfg


def test_fit_table(capsys):
    rc = aot_memory_fit.main(["--config", "tiny", "--mesh", "fsdp=2,tp=2",
                              "--cases", "4:64:full,4:64:dots"])
    out = capsys.readouterr().out
    assert rc == 0 and "gang: 4 x H100" in out
    rows = [x for x in out.splitlines() if x.startswith("| 4 | 64 |")]
    assert [r.split("|")[3].strip() for r in rows] == ["full", "dots"]
    assert aot_memory_fit.main(["--config", "tiny", "--mesh", "fsdp=1",
                                "--cases", "4:64:full", "--hbm-bytes", "1000"]) == 1


@pytest.mark.parametrize("mesh,ring", [("pp=2,fsdp=1", False), ("sp=2,fsdp=1", True),
                                       ("pp=2,sp=2,fsdp=1", True)])
def test_probe_traces_pp_and_ring_meshes(mesh, ring):
    """Rank 0 of a pp or ring mesh traced on the fake process group (the
    pipeline's and the ring's messages move nothing on meta tensors): its
    resident state is its stage's layers and the leaves every stage holds,
    plus both moments and the tokens, each storage rounded as the caching
    allocator rounds it; the step's temporaries come on top."""
    cfg = tllama.llama_tiny(remat=True, use_ring_attention=ring)
    r = aot_fit.trace_fit(cfg, mesh, batch=4, seq=32)
    sizes = parse_mesh_spec(mesh).resolve(int(np.prod([int(a.split("=")[1])
                                                       for a in mesh.split(",")])))
    specs = dict(tllama.named_leaves(tllama.param_specs(cfg, pp=sizes["pp"] > 1)))
    shapes = {n: t.shape for n, t in tllama.named_leaves(tllama.init_params(cfg, None, "meta"))}
    state = 0
    for name, shape in shapes.items():
        n = np.prod(shape) // (sizes["pp"] if specs[name][0] == "pp" else 1)
        state += aot_fit.alloc_bytes(int(n) * 4)
    assert r.args_bytes == 3 * state + aot_fit.alloc_bytes(4 * 33 * 8)
    assert r.temp_bytes > 0 and r.fits
    assert not dist.is_initialized()
    rc = aot_memory_fit.main(["--config", "tiny", "--mesh", mesh, "--cases", "4:32:full"]
                             + (["--ring-attention"] if ring else []))
    assert rc == 0


def test_north_star_and_model_state():
    cfg = aot_fit.north_star_cfg()
    assert (cfg.remat_policy, cfg.loss_chunk, cfg.kernels, cfg.n_layers) == (
        "dots", 2048, "cuda", 32)
    assert aot_fit.model_state_bytes_per_device(cfg, 16) == \
        jfit.model_state_bytes_per_device(jfit.north_star_cfg(), 16)


def test_card_facts_come_from_the_specs_table():
    """The fit's budget and the cost model's link rate are the specs
    layer's H100 entry, with the values they had as constants."""
    from torchx_tpu_torch.specs.api import GPU_GENERATIONS, GpuSlice

    assert aot_fit.H100_HBM_BYTES == 85_017_493_504 and type(aot_fit.H100_HBM_BYTES) is int
    assert aot_fit.H100_HBM_BYTES == GpuSlice("h100", 1).hbm_bytes_per_gpu
    assert costmodel.LINK_BYTES_PER_S == {"h100": 450e9}
    assert costmodel.LINK_BYTES_PER_S["h100"].hex() == (450e9).hex()
    assert costmodel.link_bytes_per_s("NVIDIA H100 80GB HBM3") == 450e9
    assert set(costmodel.LINK_BYTES_PER_S) == set(GPU_GENERATIONS)
