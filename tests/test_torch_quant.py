"""The port's int8 (``torchx_tpu_torch/ops/quant.py``) against the JAX
package's, on the CPU, on the same numpy-seeded inputs.

* Weight-only serving: ``quantize`` and ``quantize_params`` bitwise (2-D,
  ``[L, in, out]`` stacks, the ``tiny`` and ``moe_tiny`` trees, whose
  expert stacks, router and embedding stay as they are), ``size_bytes``
  equal; the plain ``int8_matmul`` within 1e-5 in f32 (as
  ``tests/test_quant.py``) and one bf16 ulp in bf16; ``forward_with_cache``
  and the serving engine on a quantized tree against the JAX ones (greedy
  tokens equal).
* The int8 training dot against ``maybe_matmul(..., int8_training=True)``
  with AQT: output and both gradients bitwise, f32 and bf16 (the int8
  operands and the rescale are AQT's, step for step); ``loss_fn`` at
  ``tiny`` under both scopes against the JAX ``loss_fn`` and its gradients;
  the JAX criteria (|loss_fp - loss_i8| < 0.2, scope ``"ffn"`` leaves the
  attention exact); the MoE warning; remat reproduces the forward.
* The entry points: ``generate_server --int8`` (unified, from a port
  trainer's checkpoint, prefill and decode roles) and ``train_llama --int8
  / --int8-scope`` (losses against the JAX trainer's, resume bitwise).
"""

import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchx_tpu.examples import train_llama as jtrain
from torchx_tpu.models import generate as jgen
from torchx_tpu.models import llama as jllama
from torchx_tpu.models import moe as jmoe
from torchx_tpu.ops import quant as jquant
from torchx_tpu.serve import engine as jengine
from torchx_tpu_torch import _build, convert
from torchx_tpu_torch.apps import generate_server as gs
from torchx_tpu_torch.examples import train_llama as ttrain
from torchx_tpu_torch.models import generate as tgen
from torchx_tpu_torch.models import llama as tllama
from torchx_tpu_torch.models import moe as tmoe
from torchx_tpu_torch.ops import quant as tquant
from torchx_tpu_torch.serve.engine import ServeEngine, ServeRequest
from torch_threads import xdist_torch_threads  # noqa: F401

pytest.importorskip("aqt")

DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _pair(arr, dtype):
    """One numpy array as (torch, jax) tensors of ``dtype`` holding the same
    values (bf16 rounded once, by JAX, and carried over exactly)."""
    t_dt, j_dt = DTYPES[dtype]
    j = jnp.asarray(arr).astype(j_dt)
    return torch.from_numpy(np.array(j.astype(jnp.float32))).to(t_dt), j


def _np(x):
    """A torch or jax tensor as f32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _flat(tree):
    return dict(tllama.named_leaves(tree))


@pytest.fixture(scope="module")
def tiny():
    cfg_j, cfg_t = jllama.CONFIGS["tiny"](), tllama.llama_tiny()
    p_j = jllama.init_params(cfg_j, jax.random.PRNGKey(0))
    p_t = convert.params_from_jax(jax.tree.map(np.asarray, p_j), cfg_t, requires_grad=False)
    return cfg_j, cfg_t, p_j, p_t


@pytest.fixture(scope="module")
def tiny_q(tiny):
    """The tiny tree quantized by the JAX package and carried over."""
    cfg_j, cfg_t, p_j, _ = tiny
    q_j = jquant.quantize_params(p_j)
    q_t = convert.params_from_jax(jax.tree.map(np.asarray, q_j), cfg_t, requires_grad=False)
    return q_j, q_t


# -- weight-only quantization ------------------------------------------------


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [(64, 32), (3, 64, 48), (2, 3, 16, 24)])
def test_quantize_bitwise(shape, dtype):
    w_t, w_j = _pair(np.random.default_rng(1).standard_normal(shape) * 0.3, dtype)
    q_j, s_j = jquant.quantize(w_j)
    q_t, s_t = tquant.quantize(w_t)
    assert q_t.dtype == torch.int8 and s_t.dtype == torch.float32
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    np.testing.assert_array_equal(tquant.dequantize(q_t, s_t, torch.float32).numpy(),
                                  np.asarray(jquant.dequantize(q_j, s_j, jnp.float32)))


def test_per_layer_scales_on_stacked_weights():
    w = torch.stack([torch.full((8, 4), 0.01), torch.full((8, 4), 100.0)])
    q, scale = tquant.quantize(w)
    assert scale.shape == (2, 1, 4)
    torch.testing.assert_close(tquant.dequantize(q, scale, torch.float32), w, rtol=0.01, atol=0)


@pytest.mark.parametrize("family", ["tiny", "moe_tiny"])
def test_quantize_params_bitwise(family):
    if family == "tiny":
        cfg_j, cfg_t, init = jllama.CONFIGS["tiny"](), tllama.llama_tiny(), jllama.init_params
    else:
        cfg_j, cfg_t, init = jmoe.moe_tiny(), tmoe.moe_tiny(), jmoe.init_params
    p_j = init(cfg_j, jax.random.PRNGKey(3))
    p_t = convert.params_from_jax(jax.tree.map(np.asarray, p_j), cfg_t, requires_grad=False)
    q_j = jquant.quantize_params(p_j)
    q_t = tquant.quantize_params(p_t)
    want = _flat(convert.params_from_jax(jax.tree.map(np.asarray, q_j), cfg_t,
                                         requires_grad=False))
    got = _flat(q_t)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        assert torch.equal(got[name], want[name]), name
    assert tquant.size_bytes(q_t) == jquant.size_bytes(q_j)
    # what stays float: the embedding, the norms and, on MoE, the router
    # and the expert stacks (the same tensors, untouched)
    kept = ["embed", "final_norm"]
    kept += ["w_router", "w_gate", "w_up", "w_down"] if family == "moe_tiny" else []
    for key in kept:
        src = p_t["layers"][key] if key.startswith("w_") else p_t[key]
        out = q_t["layers"][key] if key.startswith("w_") else q_t[key]
        assert out is src, key
    assert isinstance(q_t["layers"]["wq"], dict) and q_t["layers"]["wq"]["q"].dtype == torch.int8


def test_quantize_params_in_place_drops_the_float_leaves(tiny):
    _, cfg, _, p_t = tiny
    tree = {k: (dict(v) if isinstance(v, dict) else v) for k, v in p_t.items()}
    out = tquant.quantize_params(tree, inplace=True)
    assert out is tree
    assert all(isinstance(tree["layers"][k], dict)
               for k in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"))
    assert isinstance(p_t["layers"]["wq"], torch.Tensor)  # the source tree kept its own
    assert tquant.size_bytes(tree) < 0.75 * tquant.size_bytes(p_t)


def test_convert_takes_quantized_records(tiny, tiny_q):
    _, cfg, _, p_t = tiny
    _, q_t = tiny_q
    assert q_t["layers"]["wq"]["q"].dtype == torch.int8
    assert not q_t["layers"]["wq"]["q"].requires_grad
    shapes = convert.expected_shapes(cfg, quantized=True)
    got = {n: tuple(t.shape) for n, t in _flat(q_t).items()}
    assert got == dict(tllama.named_leaves(shapes))
    # a float dtype casts the float leaves only
    cast = convert.params_from_jax(
        jax.tree.map(np.asarray, jquant.quantize_params(jllama.init_params(
            jllama.CONFIGS["tiny"](), jax.random.PRNGKey(0)))),
        cfg, dtype=torch.bfloat16, requires_grad=False)
    assert cast["embed"].dtype == torch.bfloat16
    assert cast["layers"]["wq"]["q"].dtype == torch.int8
    assert cast["layers"]["wq"]["scale"].dtype == torch.float32


# -- the int8-weight matmul: the plain version --------------------------------


@pytest.mark.parametrize("dtype,out", [("float32", None), ("bfloat16", None),
                                       ("bfloat16", "float32"), ("float32", "float32")])
def test_int8_matmul_plain_matches_jax(dtype, out):
    rng = np.random.default_rng(4)
    x_t, x_j = _pair(rng.standard_normal((2, 5, 64)), dtype)
    w = rng.standard_normal((64, 48)).astype(np.float32)
    q_j, s_j = jquant.quantize(jnp.asarray(w))
    q_t, s_t = torch.from_numpy(np.asarray(q_j)), torch.from_numpy(np.asarray(s_j))
    out_t = DTYPES[out][0] if out else None
    out_j = DTYPES[out][1] if out else None
    got = tquant.int8_matmul(x_t, q_t, s_t, out_dtype=out_t)
    want = jquant.int8_matmul(x_j, q_j, s_j, out_dtype=out_j)
    assert got.shape == (2, 5, 48) and got.dtype == (out_t or x_t.dtype)
    if got.dtype == torch.float32:
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    else:  # one bf16 ulp: 2**-8 relative
        np.testing.assert_allclose(_np(got), _np(want), rtol=2**-8, atol=1e-6)
    # the CPU wrapper is the plain version, and counts no launch
    _build.reset_launches()
    assert torch.equal(got, tquant._int8_matmul_plain(x_t, q_t, s_t, out_t))
    assert not any(_build.launch_counts().values())


#: chip_smoke.py's INT8_F32_CASE: m, k, n (K and N no multiple of a stage)
INT8_F32_CASE = (17, 520, 1040)


def _tf32(x):
    """hopper.cuh ``to_tf32`` (``cvt.rna``): round the bits to 10 mantissa
    bits, ties away from zero."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _emulate_int8_tf32(x, q, scale, passes):
    """int8_tf32_kernel's arithmetic: x split into TF32 hi + lo, q widened
    (exact in TF32), ``passes`` products a stage (2: x_lo q + x_hi q; 1:
    x_hi q alone), each 64-row stage summed apart and added to the f32 sum,
    the scale after it."""
    hi = _tf32(x)
    lo = _tf32(x - hi)
    qf = q.float()
    acc = torch.zeros(x.shape[0], q.shape[1])
    for k0 in range(0, q.shape[0], tquant.BLOCK_K):
        ks = slice(k0, k0 + tquant.BLOCK_K)
        part = lo[:, ks] @ qf[ks] if passes == 2 else torch.zeros_like(acc)
        acc = acc + (part + hi[:, ks] @ qf[ks])
    return acc * scale.reshape(-1)


def _int8_f32_case():
    m, k, n = INT8_F32_CASE
    rng = np.random.default_rng(11)
    x = rng.standard_normal((m, k)).astype(np.float32)
    q_j, s_j = jquant.quantize(jnp.asarray(rng.standard_normal((k, n)).astype(np.float32)))
    want_j = torch.from_numpy(np.array(jquant.int8_matmul(jnp.asarray(x), q_j, s_j)))
    return (torch.from_numpy(x), torch.from_numpy(np.array(q_j)),
            torch.from_numpy(np.array(s_j)), want_j)


def _rel_to_largest(got, want):
    return float((got - want).abs().max() / want.abs().max())


def test_int8_tf32_two_passes_meet_plain_and_jax():
    """The f32-activation kernel's two TF32 passes (x split hi + lo against
    the exact int8 weight) within 1e-5 of the largest value of the plain
    version and of the JAX ``int8_matmul`` on the same numpy inputs."""
    x, q, scale, want_j = _int8_f32_case()
    assert torch.equal(_tf32(q.float()), q.float())  # an int8 weight is exact in TF32
    got = _emulate_int8_tf32(x, q, scale, passes=2)
    assert _rel_to_largest(got, tquant._int8_matmul_plain(x, q, scale)) <= 1e-5
    assert _rel_to_largest(got, want_j) <= 1e-5


def test_int8_tf32_one_pass_misses_tolerance():
    """x_hi alone (one TF32 pass, 11 significant bits) misses 1e-5: the
    kernel issues two."""
    x, q, scale, _ = _int8_f32_case()
    got = _emulate_int8_tf32(x, q, scale, passes=1)
    assert _rel_to_largest(got, tquant._int8_matmul_plain(x, q, scale)) > 1e-5


def test_maybe_matmul_both_forms():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 8)).astype(np.float32)
    w = rng.standard_normal((8, 4)).astype(np.float32)
    q_j, s_j = jquant.quantize(jnp.asarray(w))
    rec = {"q": torch.from_numpy(np.asarray(q_j)), "scale": torch.from_numpy(np.asarray(s_j))}
    plain = tquant.maybe_matmul(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(plain.numpy(), np.asarray(jquant.maybe_matmul(
        jnp.asarray(x), jnp.asarray(w))), rtol=1e-6, atol=1e-6)
    quantized = tquant.maybe_matmul(torch.from_numpy(x), rec)
    np.testing.assert_allclose(quantized.numpy(), np.asarray(jquant.maybe_matmul(
        jnp.asarray(x), {"q": q_j, "scale": s_j})), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(plain.numpy(), quantized.numpy(), rtol=0.02, atol=0.02)
    as_f64 = tquant.maybe_matmul(torch.from_numpy(x), torch.from_numpy(w), out_dtype=torch.float64)
    assert as_f64.dtype == torch.float64


@pytest.mark.parametrize("m,n,k,block_m", [(8, 4096, 4096, 16), (8, 1024, 4096, 16),
                                           (8, 128256, 4096, 16), (8, 4096, 14336, 16),
                                           (2048, 4096, 4096, 128), (17, 1040, 14336, 128)])
def test_split_k_covers_the_k_range(m, n, k, block_m):
    slots = 2 * 132 if block_m == 16 else 132  # the blocks an H100 holds at once
    splits, per = tquant.split_k(m, n, k, block_m, slots=slots)
    steps = -(-k // tquant.BLOCK_K)
    assert (splits - 1) * per < steps <= splits * per  # no split is empty
    tiles = -(-m // block_m) * -(-n // tquant.BLOCK_N)
    assert splits == 1 if tiles >= slots else splits >= 1
    assert tiles * splits <= max(tiles, slots)  # one wave where it splits
    assert per >= min(4, steps) or splits == 1


# -- the int8-weight matmul: the launch plan at llama3_8b's shapes ------------

#: llama3_8b's five (K, N): wq/wo, wk/wv, w_gate/w_up, w_down, the lm head.
LLAMA3_8B_KN = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096), (4096, 128256)]
#: The rows the engine sends: decode, the busy slots (1-16); prefill, r
#: rows of one bucket (r <= 4) at a power-of-two width of at least 16.
DECODE_M = list(range(1, 17))
PREFILL_M = sorted({r * w for r in range(1, 5) for w in (16 << i for i in range(8))
                    if r * w <= 2048})


def _k_ranges(plan, k):
    """The [begin, end) k range of each split, as the kernels compute it."""
    step = plan.per * tquant.BLOCK_K
    return [(z * step, min(k, (z + 1) * step)) for z in range(plan.splits)]


@pytest.mark.parametrize("k,n", LLAMA3_8B_KN)
@pytest.mark.parametrize("m", sorted(set(DECODE_M + PREFILL_M)))
def test_launch_plan(m, k, n):
    """Which path the call takes, its tiles, splits that cover the k range
    exactly once, and scratch that the wrapper's holder provides (the head,
    N 128256, with f32 output, as the model calls it)."""
    out_f32 = n == 128256
    plan = tquant.launch_plan(m, n, k, x_f32=False, sms=132, out_f32=out_f32)
    if m <= tquant.WGMMA_TALL_M or out_f32:
        wide_m = 128
    else:  # 256-row tiles where their splits stay long
        tall = tquant.split_k(m, n, k, 256, 132)[1] >= tquant.TALL_MIN_STEPS
        wide_m = 256 if tall else 128
    short = tquant.split_k(m, n, k, wide_m, 132)[1] < tquant.DECODE_MIN_STEPS
    want = tquant.PATH_DECODE if m <= tquant.DECODE_MAX_M or short else tquant.PATH_WGMMA
    assert plan.path == want
    assert plan.block_m == (16 if want == tquant.PATH_DECODE else wide_m)
    assert plan.tiles == -(-m // plan.block_m) * -(-n // tquant.BLOCK_N)
    ranges = _k_ranges(plan, k)
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    assert all(a < b for a, b in ranges)  # none empty
    assert all(ranges[i][1] == ranges[i + 1][0] for i in range(len(ranges) - 1))
    slots = 132 * (2 if want == tquant.PATH_DECODE else 1)
    assert plan.tiles * plan.splits <= max(plan.tiles, slots)
    if plan.splits > 1:
        assert (plan.work, plan.counters) == (plan.splits * m * n, plan.tiles)
    else:
        assert (plan.work, plan.counters) == (0, 0)
    work, counters = tquant._Scratch().fit(plan, torch.device("cpu"))
    assert work.numel() >= plan.work and work.dtype == torch.float32
    assert counters.numel() >= plan.counters and counters.dtype == torch.int32
    assert not counters.any()


def test_decode_plans_split_and_prefill_fills_the_card():
    """At 8 busy slots every projection but the head splits its k range;
    a full-width prefill chunk splits only where its tiles would leave
    SMs idle."""
    for k, n in LLAMA3_8B_KN:
        decode = tquant.launch_plan(8, n, k, x_f32=False, sms=132)
        assert (decode.splits > 1) == (n != 128256), (k, n, decode)
        # 256-row tiles: wk / wv's 64 tiles split in two to fill the card
        prefill = tquant.launch_plan(2048, n, k, x_f32=False, sms=132)
        assert (prefill.block_m, prefill.splits) == (256, 2 if n == 1024 else 1)
    assert tquant.launch_plan(8, 64, 64, x_f32=True, sms=132).path == tquant.PATH_TF32


@pytest.mark.parametrize("m,k,n,block_m", [
    (512, 4096, 4096, 256), (512, 4096, 1024, 128), (256, 4096, 4096, 128),
    (256, 14336, 4096, 256), (192, 4096, 14336, 256), (128, 4096, 14336, 128),
    (2048, 4096, 128256, 128), (16, 4096, 4096, 16), (32, 4096, 4096, 128),
    (64, 4096, 1024, 16), (128, 4096, 1024, 16), (192, 4096, 1024, 128)])
def test_int8_paths_follow_the_sweep(m, k, n, block_m):
    """The kernel (16-row blocks: decode) and tile heights chip_smoke.py's
    int8 sweep (``--phases build,int8sweep``) found fastest on the card at
    these llama3_8b shapes."""
    plan = tquant.launch_plan(m, n, k, x_f32=False, sms=132, out_f32=n == 128256)
    assert plan.block_m == block_m
    assert (plan.path == tquant.PATH_DECODE) == (block_m == 16)


def test_scratch_holds_the_largest_need_and_never_shrinks():
    """One holder across every plan of the engine's shapes: it grows to the
    largest need, then serves every call with the same tensors."""
    scratch = tquant._Scratch()
    plans = [tquant.launch_plan(m, n, k, False, 132, out_f32=n == 128256)
             for k, n in LLAMA3_8B_KN for m in DECODE_M + PREFILL_M]
    for plan in plans:
        work, counters = scratch.fit(plan, torch.device("cpu"))
        assert work.numel() >= plan.work and counters.numel() >= plan.counters
    held = (scratch.work, scratch.counters)
    assert held[0].numel() == max(p.work for p in plans)
    assert held[1].numel() == max(p.counters for p in plans)
    for plan in plans:
        assert all(a is b for a, b in zip(scratch.fit(plan, torch.device("cpu")), held))


def test_int8_matmul_on_cpu_makes_no_plan_and_no_scratch():
    """A CPU call takes the plain version: no plan, no scratch."""
    tquant._PLANS.clear()
    x = torch.ones((3, 64))
    q = torch.ones((64, 16), dtype=torch.int8)
    y = tquant.int8_matmul(x, q, torch.ones((1, 16)))
    assert torch.equal(y, torch.full((3, 16), 64.0))
    assert not tquant._PLANS and not tquant._SCRATCH


# -- the int8 training dot ----------------------------------------------------


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("xs,ws", [((64, 128), (128, 96)), ((2, 24, 64), (64, 48))])
def test_int8_dot_matches_aqt(dtype, xs, ws):
    """Output and both gradients bitwise against AQT's config_v4 dot (the
    tolerance reached: 0, in f32 and in bf16)."""
    rng = np.random.default_rng(6)
    x_t, x_j = _pair(rng.standard_normal(xs), dtype)
    w_t, w_j = _pair(rng.standard_normal(ws) * 0.05, dtype)
    g_t, g_j = _pair(rng.standard_normal((*xs[:-1], ws[1])) * 1e-3, dtype)
    y_j, vjp = jax.vjp(lambda a, b: jquant.maybe_matmul(a, b, int8_training=True), x_j, w_j)
    dx_j, dw_j = vjp(g_j)
    x_t.requires_grad_(True)
    w_t.requires_grad_(True)
    tquant.reset_int8_dot_calls()
    y_t = tquant.maybe_matmul(x_t, w_t, int8_training=True)
    assert tquant.int8_dot_calls() == 1
    y_t.backward(g_t)
    assert tquant.int8_dot_calls() == 3
    assert y_t.dtype == x_t.dtype and x_t.grad.dtype == x_t.dtype
    np.testing.assert_array_equal(_np(y_t), _np(y_j))
    np.testing.assert_array_equal(_np(x_t.grad), _np(dx_j))
    np.testing.assert_array_equal(_np(w_t.grad), _np(dw_j))


def test_int8_dot_quantizes_along_the_contracting_axis():
    """One scale per row of x: a row 1000x larger leaves the others' int8
    operands (and so their outputs) as they were."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((32, 64)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((64, 16)).astype(np.float32))
    y = tquant.int8_dot(x, w)
    x2 = x.clone()
    x2[0] *= 1000
    y2 = tquant.int8_dot(x2, w)
    assert torch.equal(y[1:], y2[1:])
    qx, sx = tquant._aqt_quantize(x, 1)
    assert sx.shape == (32, 1) and int(qx.abs().max()) == 127
    torch.testing.assert_close(sx[:, 0], x.abs().amax(1) / 127.5)


def test_int8_dot_rejects_mixed_dtypes():
    with pytest.raises(ValueError, match="share a dtype"):
        tquant.int8_dot(torch.ones(32, 8), torch.ones(8, 8, dtype=torch.bfloat16))


# -- the model ----------------------------------------------------------------


def _batch(seed, b=2, s=32, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (b, s + 1)).astype(np.int32)


@pytest.mark.parametrize("scope", ["all", "ffn"])
def test_loss_and_grads_match_jax(tiny, scope):
    """loss_fn at tiny (f32) with int8 matmuls against the JAX loss_fn with
    AQT. Each dot is bitwise AQT's on equal inputs (test_int8_dot_matches_aqt),
    but the f32 ops between the dots round differently in the two
    frameworks (~1e-7), and a value that lands that close to a rounding
    boundary takes the other int8 code, moving its products by one
    quantum (~1/127 of its row's or column's largest value). Reached over
    four batches: loss 1.2e-5 relative, gradients 1.2e-2 of each leaf's
    largest value (scope "ffn" 2.8e-3); held to 5e-5 and 3e-2."""
    cfg_j, _, p_j, p_t = tiny
    cfg_j = jllama.llama_tiny(int8_matmuls=True, int8_scope=scope)
    cfg_t = tllama.llama_tiny(int8_matmuls=True, int8_scope=scope)
    tok = _batch(9)
    loss_j, g_j = jax.value_and_grad(jllama.loss_fn)(p_j, {"tokens": jnp.asarray(tok)}, cfg_j)
    p = {k: ({kk: vv.clone().requires_grad_(True) for kk, vv in v.items()}
             if isinstance(v, dict) else v.clone().requires_grad_(True))
         for k, v in p_t.items()}
    loss_t = tllama.loss_fn(p, {"tokens": torch.from_numpy(tok).long()}, cfg_t)
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=5e-5)
    want = dict(zip(_flat(p_t), jax.tree.leaves(g_j)))
    for name, leaf in _flat(p).items():
        ref = np.asarray(want[name])
        np.testing.assert_allclose(leaf.grad.numpy(), ref, rtol=0,
                                   atol=3e-2 * float(np.abs(ref).max()), err_msg=name)


def test_the_jax_criteria(tiny):
    """tests/test_quant.py's: int8 loss within 0.2 of the float loss; scope
    "ffn" quantizes (output differs) but no more than scope "all"."""
    _, _, _, p_t = tiny
    tokens = torch.from_numpy(_batch(10)).long()
    loss = {s: float(tllama.loss_fn(p_t, {"tokens": tokens}, tllama.llama_tiny(
        int8_matmuls=s is not None, int8_scope=s or "all"))) for s in (None, "all", "ffn")}
    assert abs(loss[None] - loss["all"]) < 0.2, loss
    ref = tllama.forward(p_t, tokens, tllama.llama_tiny())
    err = {s: float((tllama.forward(p_t, tokens, tllama.llama_tiny(
        int8_matmuls=True, int8_scope=s)) - ref).abs().mean()) for s in ("all", "ffn")}
    assert err["ffn"] > 0 and err["ffn"] <= err["all"] + 1e-6, err


def test_scope_ffn_leaves_the_attention_exact(tiny, monkeypatch):
    """Under scope "ffn" the int8 dot sees the FFN's products only, 3 a
    layer; under "all" the attention projections too, 7 a layer."""
    _, cfg, _, p_t = tiny
    seen = []
    dot = tquant.int8_dot

    def recording(x, w):
        seen.append(tuple(w.shape))
        return dot(x, w)

    monkeypatch.setattr(tquant, "int8_dot", recording)
    tokens = torch.from_numpy(_batch(11)).long()
    ffn = {(cfg.dim, cfg.ffn_dim), (cfg.ffn_dim, cfg.dim)}
    for scope, per_layer in (("ffn", 3), ("all", 7)):
        seen.clear()
        tllama.forward(p_t, tokens, tllama.llama_tiny(int8_matmuls=True, int8_scope=scope))
        assert len(seen) == per_layer * cfg.n_layers
        assert (set(seen) <= ffn) == (scope == "ffn")


def test_int8_scope_validated():
    with pytest.raises(ValueError, match="int8_scope"):
        tllama.llama_tiny(int8_scope="attn")


@pytest.mark.parametrize("scope,words", [("all", "only the attention projections"),
                                         ("ffn", "NOTHING quantizes")])
def test_moe_warning(scope, words):
    cfg = tmoe.moe_tiny(int8_matmuls=True, int8_scope=scope)
    params = tllama.init_params(cfg, torch.Generator().manual_seed(0))
    tokens = torch.zeros((1, 16), dtype=torch.long)
    with pytest.warns(UserWarning, match="does not cover the MoE expert einsums") as rec:
        tllama.forward(params, tokens, cfg)
    assert any(words in str(w.message) for w in rec)


def test_remat_recomputes_the_same_int8_operands(tiny):
    """With remat each layer's forward reruns in the backward: the dynamic
    quantization must give the forward's int8 operands again, so loss and
    gradients equal the run without remat bitwise; the dot runs once in the
    forward, once in the recompute and twice in the backward."""
    _, cfg, _, p_t = tiny
    tokens = torch.from_numpy(_batch(12)).long()
    out = {}
    for remat in (False, True):
        p = {k: ({kk: vv.clone().requires_grad_(True) for kk, vv in v.items()}
                 if isinstance(v, dict) else v.clone().requires_grad_(True))
             for k, v in p_t.items()}
        c = tllama.llama_tiny(int8_matmuls=True, remat=remat)
        tquant.reset_int8_dot_calls()
        loss = tllama.loss_fn(p, {"tokens": tokens}, c)
        loss.backward()
        out[remat] = (loss, p, tquant.int8_dot_calls())
    assert torch.equal(out[False][0], out[True][0])
    for name, leaf in _flat(out[False][1]).items():
        assert torch.equal(leaf.grad, _flat(out[True][1])[name].grad), name
    assert out[False][2] == 7 * cfg.n_layers * 3
    assert out[True][2] == 7 * cfg.n_layers * 4


# -- serving a quantized tree -------------------------------------------------


def test_forward_with_cache_matches_jax(tiny, tiny_q):
    cfg_j, cfg_t, p_j, p_t = tiny
    q_j, q_t = tiny_q
    prompt = np.random.default_rng(13).integers(0, 512, (2, 8)).astype(np.int32)
    cache_j = jgen.init_kv_cache(cfg_j, 2, 16)
    logits_j, _ = jgen.forward_with_cache(q_j, jnp.asarray(prompt), cache_j, jnp.int32(0), cfg_j)
    cache_t = tgen.init_kv_cache(cfg_t, 2, 16)
    logits_t, cache_t = tgen.forward_with_cache(q_t, torch.from_numpy(prompt).long(), cache_t,
                                                0, cfg_t)
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), rtol=1e-5, atol=1e-5)
    # one decode step on
    nxt = np.asarray(jnp.argmax(logits_j[:, -1], -1))[:, None].astype(np.int32)
    _, cache_j = jgen.forward_with_cache(q_j, jnp.asarray(prompt), jgen.init_kv_cache(
        cfg_j, 2, 16), jnp.int32(0), cfg_j)
    step_j, _ = jgen.forward_with_cache(q_j, jnp.asarray(nxt), cache_j, jnp.int32(8), cfg_j)
    step_t, _ = tgen.forward_with_cache(q_t, torch.from_numpy(nxt).long(), cache_t, 8, cfg_t)
    np.testing.assert_allclose(step_t.numpy(), np.asarray(step_j), rtol=1e-5, atol=1e-5)
    # tests/test_quant.py's criterion: int8 logits track the float ones
    fp, _ = tgen.forward_with_cache(p_t, torch.from_numpy(prompt).long(),
                                    tgen.init_kv_cache(cfg_t, 2, 16), 0, cfg_t)
    assert float((logits_t - fp).abs().mean() / fp.abs().mean()) < 0.05


def test_untied_int8_head_keeps_the_f32_sum():
    """An untied head (llama3_8b's layout) is quantized, and the logits are
    the f32 sum: the same as the plain product with an f32 output."""
    cfg = tllama.llama_tiny(tie_embeddings=False)
    params = tllama.init_params(cfg, torch.Generator().manual_seed(2))
    for leaf in tllama.leaves(params):
        leaf.requires_grad_(False)
    q = tquant.quantize_params(params)
    assert isinstance(q["lm_head"], dict)
    x = torch.randn(3, cfg.dim)
    got = tgen._lm_head_rows(q, x, cfg)
    assert got.dtype == torch.float32
    want = tquant._int8_matmul_plain(x, q["lm_head"]["q"], q["lm_head"]["scale"], torch.float32)
    assert torch.equal(got, want)


MIXED = [[1, 2, 3], [7, 8], [4, 5, 6, 7, 8, 9, 10], [11], [3, 1], list(range(20, 40))]


def test_engine_greedy_matches_the_jax_engine(tiny, tiny_q, monkeypatch):
    """The continuous-batching engine on the quantized tree gives the JAX
    engine's greedy tokens; every projection's input reaches the int8
    matmul contiguous (the kernel raises on anything else)."""
    cfg_j, cfg_t, _, _ = tiny
    q_j, q_t = tiny_q
    seen = []
    int8_matmul = tquant.int8_matmul

    def checking(x, q, scale, out_dtype=None):
        seen.append(x.is_contiguous() and q.is_contiguous() and scale.is_contiguous())
        return int8_matmul(x, q, scale, out_dtype)

    monkeypatch.setattr(tgen, "int8_matmul", checking)
    monkeypatch.setattr(tquant, "int8_matmul", checking)
    eng = ServeEngine(q_t, cfg_t, max_slots=4, block_size=8, max_prefill_batch=2).start()
    jeng = jengine.ServeEngine(q_j, cfg_j, max_slots=4, block_size=8,
                               max_prefill_batch=2).start()
    try:
        reqs = [eng.submit(ServeRequest(prompt=p, max_new_tokens=5)) for p in MIXED]
        jreqs = [jeng.submit(jengine.ServeRequest(prompt=p, max_new_tokens=5)) for p in MIXED]
        for r, jr in zip(reqs, jreqs):
            assert r.wait(timeout=120) and r.error is None
            assert jr.wait(timeout=120) and jr.error is None
            assert r.tokens == jr.tokens
    finally:
        eng.stop()
        jeng.stop()
    assert seen and all(seen)
    # and the dense generate on the same tree
    for p, r in zip(MIXED, reqs):
        dense = tgen.generate(q_t, torch.tensor([p]), cfg_t, 5)
        assert r.tokens == dense[0].tolist()


# -- the entry points ---------------------------------------------------------


def _start(**kw):
    srv = gs.serve("tiny", port=0, device="cpu", max_batch=4, **kw)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


def _stop(srv):
    srv.shutdown()
    srv.service.close()
    srv.server_close()


def _post(url, body):
    req = urllib.request.Request(f"{url}/v1/generate", data=json.dumps(body).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


def _health(url):
    with urllib.request.urlopen(f"{url}/healthz", timeout=60) as resp:
        return json.loads(resp.read())


PROMPTS = [[1, 2, 3], list(range(4, 24)), list(range(100, 140))]


def _engine_tokens(params, cfg, prompts, new):
    eng = ServeEngine(params, cfg, max_slots=4, block_size=16).start()
    try:
        return [eng.generate(p, new, timeout=120).tokens for p in prompts]
    finally:
        eng.stop()


def test_server_int8_answers_and_says_so():
    srv, url = _start(int8=True)
    try:
        service = srv.service
        assert service.int8 and _health(url)["int8"] is True
        layers = service.params["layers"]
        assert all(layers[k]["q"].dtype == torch.int8 and layers[k]["scale"].dtype ==
                   torch.float32 for k in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"))
        assert service.params["embed"].dtype == torch.float32  # the tiny config's dtype
        outs = [_post(url, {"tokens": [p], "max_new_tokens": 6})["tokens"][0] for p in PROMPTS]
        assert [len(o) - len(p) for o, p in zip(outs, PROMPTS)] == [6] * len(PROMPTS)
        # the seeded init quantized, served by an engine of its own
        ref = tllama.init_params(service.cfg, torch.Generator().manual_seed(0))
        for leaf in tllama.leaves(ref):
            leaf.requires_grad_(False)
        want = _engine_tokens(tquant.quantize_params(ref), service.cfg, PROMPTS, 6)
        assert outs == want
    finally:
        _stop(srv)
    plain, url = _start()
    try:
        assert plain.service.int8 is False and _health(url)["int8"] is False
    finally:
        _stop(plain)


def test_server_int8_serves_a_port_trainers_checkpoint(tmp_path):
    d = str(tmp_path / "ck")
    seen = {}
    ttrain.train(tllama.llama_tiny(int8_matmuls=True), 2, 16, 2, device="cpu", log_every=0,
                 warmup=2, ckpt_dir=d, on_state=lambda e, s: seen.update({e: s}))
    srv, url = _start(ckpt_dir=d, int8=True)
    try:
        health = _health(url)
        assert health["int8"] is True and health["ckpt_step"] == 2
        outs = [_post(url, {"tokens": [p], "max_new_tokens": 5})["tokens"][0] for p in PROMPTS]
    finally:
        _stop(srv)
    final = {k.removeprefix("params."): v.detach().clone()
             for k, v in seen["final"].items() if k.startswith("params.")}
    params = tquant.quantize_params(tllama.unflatten(final))
    assert outs == _engine_tokens(params, tllama.llama_tiny(), PROMPTS, 5)


def test_server_int8_prefill_and_decode_roles():
    dec, dec_url = _start(serve_role="decode", int8=True)
    pre, pre_url = _start(serve_role="prefill", kv_transfer=f"http:{dec_url}", int8=True)
    uni, uni_url = _start(int8=True)
    try:
        assert _health(dec_url)["int8"] and _health(pre_url)["int8"]
        for p in PROMPTS:
            body = {"tokens": [p], "max_new_tokens": 6}
            assert _post(pre_url, body)["tokens"] == _post(uni_url, body)["tokens"]
    finally:
        for srv in (pre, dec, uni):
            _stop(srv)


def test_trainer_int8_flags(monkeypatch):
    """--int8 and --int8-scope map onto the config as the JAX trainer maps
    them (--int8-scope implies --int8; the default scope is "all"), and the
    run's record names the scope."""
    seen = []

    def fake_train(cfg, *a, **kw):
        seen.append((cfg.int8_matmuls, cfg.int8_scope))
        return {}

    monkeypatch.setattr(ttrain, "train", fake_train)
    for argv, want in ((["--int8"], (True, "all")), (["--int8-scope", "ffn"], (True, "ffn")),
                       (["--int8", "--int8-scope", "all"], (True, "all")), ([], (False, "all"))):
        ttrain.main(["--device", "cpu", *argv])
        assert seen[-1] == want, argv
    assert not {"--int8", "--int8-scope"} & set(ttrain.NOT_PORTED_FLAGS)


def test_trainer_int8_scope_ffn_runs(capsys):
    ttrain.main(["--config", "tiny", "--int8-scope", "ffn", "--steps", "3", "--device", "cpu",
                 "--batch", "2", "--seq", "16"])
    final = json.loads(capsys.readouterr().out.split("final:", 1)[1])
    assert final["int8_scope"] == "ffn" and len(final["losses"]) == 3
    assert all(np.isfinite(final["losses"]))


def test_trainer_int8_steps_match_the_jax_trainer():
    """Three AdamW steps of the tiny config with int8 FFN matmuls from the
    same weights on the same batches, against the JAX trainer's. The first
    step's loss is held to the loss test's 5e-5. After an update, the
    int8 codes that flipped between the frameworks (see
    test_loss_and_grads_match_jax) can turn a near-zero gradient's sign,
    and Adam, whose early updates are about lr * sign(g), moves that
    weight by up to 2 lr the other way. Reached over two seeds and both
    scopes: losses 3.0e-4 relative by step 3, parameters 5.6e-4 (lr 3e-4);
    held to 5e-4 and 1e-3."""
    cfg_j = jllama.llama_tiny(int8_matmuls=True, int8_scope="ffn")
    cfg_t = tllama.llama_tiny(int8_matmuls=True, int8_scope="ffn")
    p_j = jllama.init_params(cfg_j, jax.random.PRNGKey(21))
    opt_j = jtrain.make_optimizer(lr=3e-4, warmup=2)
    state = jtrain.TrainState(params=p_j, opt_state=opt_j.init(p_j),
                              step=jnp.zeros((), jnp.int32))
    step_j = jtrain.make_train_step(cfg_j, None, opt_j)
    p_t = convert.params_from_jax(jax.tree.map(np.asarray, p_j), cfg_t)
    opt_t = ttrain.make_optimizer(tllama.leaves(p_t), lr=3e-4, warmup=2)
    step_t = ttrain.make_train_step(cfg_t, opt_t)
    for i in range(3):
        tok = _batch(30 + i, s=64)
        state, loss_j, _ = step_j(state, {"tokens": jnp.asarray(tok)})
        out = step_t(p_t, {"tokens": torch.from_numpy(tok)})
        np.testing.assert_allclose(float(out["loss"]), float(loss_j), rtol=5e-4 if i else 5e-5)
    for (name, b), a in zip(tllama.named_leaves(p_t), jax.tree.leaves(state.params)):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a), rtol=0, atol=1e-3,
                                   err_msg=name)


def test_trainer_int8_resume_is_bitwise(tmp_path):
    """An int8 run saves the float master tree; 2 + 2 steps across the
    checkpoint equal 4 uninterrupted ones bitwise."""
    cfg = tllama.llama_tiny(int8_matmuls=True, int8_scope="ffn")

    def run(steps, **kw):
        seen = {}
        out = ttrain.train(cfg, 2, 16, steps, device="cpu", log_every=0, warmup=2,
                           on_state=lambda e, s: seen.update({e: s}), **kw)
        return out, {k: v.clone() for k, v in seen["final"].items()}

    whole, s_whole = run(4)
    d = str(tmp_path / "ck")
    a, _ = run(2, ckpt_dir=d)
    b, s_b = run(2, ckpt_dir=d)
    assert (b["resumed_from_step"], b["final_step"]) == (2, 4)
    assert a["losses"] + b["losses"] == whole["losses"]
    assert whole["int8_scope"] == "ffn"
    assert all(v.dtype != torch.int8 for v in s_b.values())
    for name in s_whole:
        assert torch.equal(s_b[name], s_whole[name]), name
