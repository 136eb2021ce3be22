"""The mma flash kernels' arithmetic, on the CPU.

``csrc/flash_fwd_mma.cuh``, ``csrc/flash_dq_mma.cuh`` and
``csrc/flash_dkv_mma.cuh`` run the flash forward, dq and dk/dv on the
tensor cores by mma.sync where the wgmma kernels do not reach: f32 at
head_dim 64, 128 and 256, and bf16 at 256. The tensor
cores take f32 operands only as TF32 (11 significant bits), so the f32
kernels split each operand into TF32 hi + lo (``cvt.rna``: round to nearest,
ties away from zero) and form every product as lo*hi + hi*lo + hi*hi. The
kernels cannot run here, so their loops are emulated in f32 PyTorch: kv
tiles (forward, dq) or q tiles (dk/dv) of the instance's size
(``ops.fused.MMA_TILES``), the base-2 online softmax, the TF32 rounding done
on the bits as ``cvt.rna`` does it. With three passes the emulation meets
the port's plain versions and the JAX package's Pallas kernels (run in the
interpreter on the same numpy inputs) within the port's f32 tolerances,
2e-5 forward and 5e-4 dq and dk/dv (chip_smoke.py ``F32_TOL``); with one
pass it misses 2e-5, which is why the kernels issue three. The bf16
head_dim-256 instances' arithmetic (exact bf16 products, P and dS split
into bf16 hi + lo) meets 1e-3; masked by segment ids too.
"""

import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_flash_variants import _parts, _rel
from torchx_tpu.ops import fused as jfused
from torchx_tpu_torch.ops import fused
from torch_threads import xdist_torch_threads  # noqa: F401

LOG2E = math.log2(math.e)
CSRC = Path(fused.__file__).resolve().parent.parent / "csrc"
#: chip_smoke.py's F32_ATTN_CASES: b, s, h, kvh, d, causal
F32_ATTN_CASES = [
    (2, 256, 2, 2, 64, True), (1, 128, 2, 2, 64, False),
    (2, 256, 4, 2, 64, True), (1, 256, 4, 1, 64, True),
    (1, 128, 2, 1, 128, True), (1, 256, 2, 2, 256, False),
    (1, 256, 4, 2, 256, True),
]
F32_TOL = {"fwd": 2e-5, "dkv": 5e-4}
BF16_TOL = 1e-3
#: packed documents whose boundaries fall inside the tiles; in the second
#: row the first document ends at 150, so its later rows see whole kv tiles
#: of another segment before their own (the forward's running-max guard)
SEGMENTS = torch.tensor([[0] * 37 + [1] * 100 + [2] * 119, [0] * 150 + [1] * 106],
                        dtype=torch.int32)


def tf32(x):
    """``cvt.rna.tf32.f32``: add half of the dropped range to the bits, then
    clear the 13 low mantissa bits (round to nearest, ties away from 0)."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x):
    """hopper.cuh ``split_tf32``: hi = tf32(x), lo = tf32(x - hi)."""
    hi = tf32(x)
    return hi, tf32(x - hi)


def mm(a, b, mode):
    """``a @ b`` as the kernels form it: "x3" three TF32 products (lo*hi,
    hi*lo, hi*hi, each exact in f32, summed in f32), "x1" one (hi*hi),
    "bf16" the exact product of bf16 values (f32 sums)."""
    if mode == "bf16":
        return a @ b
    (ah, al), (bh, bl) = split(a), split(b)
    if mode == "x1":
        return ah @ bh
    return al @ bh + ah @ bl + ah @ bh


def mm_p(p, y, mode):
    """P @ Y with P (probabilities or dS) from the accumulators: f32 split
    as any operand; in bf16 P split into bf16 hi + lo, two products."""
    if mode == "bf16":
        return sum(part @ y for part in _parts(p, "split"))
    return mm(p, y, mode)


def _heads(x, n_rep):
    """[b, s, kvh, d] -> f32 [b, h, s, d], each KV head read n_rep times."""
    return x.float().repeat_interleave(n_rep, dim=2).transpose(1, 2)


def _same(seg, rows, cols):
    return (seg[:, rows, None] == seg[:, None, cols])[:, None]


def emulate_fwd(q, k, v, causal, mode, bk, seg=None):
    """flash_fwd_mma_kernel's loops: bk-row kv tiles, S = Q K^T, the scale
    applied in base 2, the online softmax with the masked instance's
    running-max guard, O += P V, then O / l and lse."""
    b, s, h, d = q.shape
    n_rep = h // k.shape[2]
    qf, kf, vf = q.float().transpose(1, 2), _heads(k, n_rep), _heads(v, n_rep)
    scale_log2 = LOG2E / math.sqrt(d)
    m = torch.full((b, h, s), -math.inf)
    l = torch.zeros(b, h, s)  # noqa: E741
    acc = torch.zeros(b, h, s, d)
    rows = torch.arange(s)
    for k0 in range(0, s, bk):
        cols = torch.arange(k0, k0 + bk)
        x = mm(qf, kf[:, :, cols].transpose(-1, -2), mode) * scale_log2
        if causal:
            x = x.masked_fill(cols[None, :] > rows[:, None], -math.inf)
        if seg is not None:
            x = x.masked_fill(~_same(seg, rows, cols), -math.inf)
        m_new = torch.maximum(m, x.amax(-1))
        ref = torch.where(m_new == -math.inf, 0.0, m_new)
        alpha = torch.exp2(m - ref)
        p = torch.exp2(x - ref[..., None])
        l = l * alpha + p.sum(-1)  # noqa: E741
        acc = acc * alpha[..., None] + mm_p(p, vf[:, :, cols], mode)
        m = m_new
    lse = (m + torch.log2(l)) * math.log(2)
    return (acc / l[..., None]).transpose(1, 2), lse


def emulate_dq(q, k, v, do, lse, delta, causal, mode, bk, seg=None):
    """flash_dq_mma_kernel's loops: bk-row kv tiles, S = Q K^T and
    dP = dO V^T, P from lse in base 2, dS = P (dP - delta), dQ += dS K;
    dQ times the scale at the end."""
    b, s, h, d = q.shape
    n_rep = h // k.shape[2]
    qf, dof = q.float().transpose(1, 2), do.float().transpose(1, 2)
    kf, vf = _heads(k, n_rep), _heads(v, n_rep)
    rows = torch.arange(s)
    dq = torch.zeros(b, h, s, d)
    for k0 in range(0, s, bk):
        cols = torch.arange(k0, k0 + bk)
        kt = kf[:, :, cols]
        p = torch.exp2(mm(qf, kt.transpose(-1, -2), mode) * (LOG2E / math.sqrt(d))
                       - (lse * LOG2E)[..., None])
        if causal:
            p = p.masked_fill(cols[None, :] > rows[:, None], 0.0)
        if seg is not None:
            p = p.masked_fill(~_same(seg, rows, cols), 0.0)
        dp = mm(dof, vf[:, :, cols].transpose(-1, -2), mode)
        dq = dq + mm_p(p * (dp - delta[..., None]), kt, mode)
    return (dq / math.sqrt(d)).transpose(1, 2)


def emulate_dkv(q, k, v, do, lse, delta, causal, mode, bq, seg=None):
    """flash_dkv_mma_kernel's loops: per KV head its query heads in order
    and their bq-row q tiles, S^T = K Q^T and dP^T = V dO^T, P^T from lse,
    dS^T = P^T (dP^T - delta), dV += P^T dO, dK += dS^T Q; dK times the
    scale at the end."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    n_rep = h // kvh
    qf, dof = q.float().transpose(1, 2), do.float().transpose(1, 2)
    kf, vf = k.float().transpose(1, 2), v.float().transpose(1, 2)
    keys = torch.arange(s)
    dk, dv = torch.zeros(b, kvh, s, d), torch.zeros(b, kvh, s, d)
    for rep in range(n_rep):
        heads = torch.arange(kvh) * n_rep + rep
        for q0 in range(0, s, bq):
            qs = torch.arange(q0, q0 + bq)
            qh, doh = qf[:, heads][:, :, qs], dof[:, heads][:, :, qs]
            st = mm(kf, qh.transpose(-1, -2), mode)
            p = torch.exp2(st * (LOG2E / math.sqrt(d))
                           - (lse[:, heads][:, :, qs] * LOG2E)[:, :, None, :])
            if causal:
                p = p.masked_fill(qs[None, :] < keys[:, None], 0.0)
            if seg is not None:
                p = p.masked_fill(~_same(seg, keys, qs), 0.0)
            dpt = mm(vf, doh.transpose(-1, -2), mode)
            ds = p * (dpt - delta[:, heads][:, :, qs][:, :, None, :])
            dv = dv + mm_p(p, doh, mode)
            dk = dk + mm_p(ds, qh, mode)
    return (dk / math.sqrt(d)).transpose(1, 2), dv.transpose(1, 2)


def _inputs(b, s, h, kvh, d, dtype, seed):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(shape).astype(np.float32)
              for shape in ((b, s, h, d), (b, s, kvh, d), (b, s, kvh, d), (b, s, h, d))]
    return [torch.tensor(a).to(dtype) for a in arrays]


def _jax_flash(q, k, v, do, causal):
    """The JAX package's Pallas forward and backward in the interpreter on
    the same values: o and dq [b, s, h, d], lse [b, h, s], and dk, dv
    folded over each KV head's query heads to [b, s, kvh, d]."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    n_rep = h // kvh

    def bh(x):  # noqa: ANN001, ANN202
        return jnp.asarray(x.float().transpose(1, 2).reshape(b * x.shape[2], s, d).numpy())

    q3, do3 = bh(q), bh(do)
    k3 = bh(k.repeat_interleave(n_rep, dim=2))
    v3 = bh(v.repeat_interleave(n_rep, dim=2))
    o3, lse = jfused._flash_fwd(q3, k3, v3, causal, 128, 128, True)
    dq3, dk3, dv3 = jfused._flash_bwd(q3, k3, v3, o3, lse, do3, causal, 128, 128, True)

    def fold(x):  # noqa: ANN001, ANN202
        x = torch.from_numpy(np.array(x)).reshape(b, kvh, n_rep, s, d).sum(dim=2)
        return x.transpose(1, 2)

    def per_head(x):  # noqa: ANN001, ANN202
        return torch.from_numpy(np.array(x)).reshape(b, h, s, d).transpose(1, 2)

    lse = torch.from_numpy(np.array(lse)).reshape(b, h, s)
    return per_head(o3), lse, per_head(dq3), fold(dk3), fold(dv3)


def _errors(case, dtype, mode, seg=None, jax_too=False):
    """-> {name: relative error} of the emulated o, lse, dq, dk, dv against
    the port's plain versions (and, with ``jax_too``, the JAX kernels)."""
    b, s, h, kvh, d, causal = case
    q, k, v, do = _inputs(b, s, h, kvh, d, dtype, seed=s + h + d + causal)
    _, bk_fwd = fused.MMA_TILES[("flash_fwd", dtype, d)]
    _, bk_dq = fused.MMA_TILES[("flash_dq", dtype, d)]
    bq_dkv, _ = fused.MMA_TILES[("flash_dkv", dtype, d)]
    o_p, lse_p = fused._flash_fwd_plain(q, k, v, causal, seg)
    delta = fused._flash_delta(do, o_p)
    args = (q, k, v, do, lse_p, delta, causal)
    dq_p = fused._flash_dq_plain(*args, seg)
    dk_p, dv_p = fused._flash_dkv_plain(*args, seg)
    o_e, lse_e = emulate_fwd(q, k, v, causal, mode, bk_fwd, seg)
    dq_e = emulate_dq(*args, mode, bk_dq, seg)
    dk_e, dv_e = emulate_dkv(*args, mode, bq_dkv, seg)
    errs = {"o": _rel(o_e, o_p), "lse": _rel(lse_e, lse_p), "dq": _rel(dq_e, dq_p),
            "dk": _rel(dk_e, dk_p), "dv": _rel(dv_e, dv_p)}
    if jax_too:
        o_j, lse_j, dq_j, dk_j, dv_j = _jax_flash(q, k, v, do, causal)
        errs.update(jax_o=_rel(o_e, o_j), jax_lse=_rel(lse_e, lse_j), jax_dq=_rel(dq_e, dq_j),
                    jax_dk=_rel(dk_e, dk_j), jax_dv=_rel(dv_e, dv_j))
    return errs


def _within(errs, fwd_tol, bwd_tol):
    return all(e <= (fwd_tol if name.removeprefix("jax_") in ("o", "lse") else bwd_tol)
               for name, e in errs.items())


def test_tf32_rounding_is_cvt_rna():
    """Ties round away from zero; every result has its 13 low bits clear;
    hi + lo keeps ~22 significant bits where hi alone keeps 11."""
    half = 2.0 ** -11  # half a TF32 ulp at 1
    x = torch.tensor([1 + half, -(1 + half), 1 + 3 * half, 1 + half / 2, 3.0], dtype=torch.float32)
    want = torch.tensor([1 + 2 * half, -(1 + 2 * half), 1 + 4 * half, 1.0, 3.0])
    assert torch.equal(tf32(x), want)
    y = torch.tensor(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    hi, lo = split(y)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    assert float(((hi - y) / y).abs().max()) <= 2.0 ** -11
    assert float(((hi + lo - y) / y).abs().max()) <= 2.0 ** -21


@pytest.mark.parametrize("case", F32_ATTN_CASES)
def test_three_tf32_passes_meet_plain_and_jax(case):
    """The f32 instances' arithmetic within 2e-5 (forward) and 5e-4 (dq,
    dk/dv) of the port's plain versions and of the JAX Pallas kernels."""
    errs = _errors(case, torch.float32, "x3", jax_too=True)
    assert _within(errs, F32_TOL["fwd"], F32_TOL["dkv"]), errs


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 256])
def test_three_tf32_passes_meet_plain_with_segments(d, causal):
    """The masked f32 instances' arithmetic within the unmasked tolerances
    of the masked plain versions."""
    errs = _errors((2, 256, 4, 2, d, causal), torch.float32, "x3", seg=SEGMENTS)
    assert _within(errs, F32_TOL["fwd"], F32_TOL["dkv"]), errs


def test_one_tf32_pass_misses_tolerance():
    """One TF32 pass (hi*hi, ~3 decimal digits) misses the f32 forward's
    2e-5: the kernels issue three."""
    errs = _errors((2, 256, 2, 2, 64, True), torch.float32, "x1")
    assert max(errs["o"], errs["lse"]) > F32_TOL["fwd"], errs


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("n_rep", [1, 2])
def test_bf16_d256_split_meets_tolerance(n_rep, causal, masked):
    """The bf16 head_dim-256 instances' arithmetic (P and dS split into bf16
    hi + lo) within 1e-3 of the (masked) plain versions: forward, dq and
    dk/dv."""
    seg = SEGMENTS if masked else None
    errs = _errors((2, 256, 2 * n_rep, 2, 256, causal), torch.bfloat16, "bf16", seg=seg)
    assert _within(errs, BF16_TOL, BF16_TOL), errs


def _cuh_tiles(kernel):
    """{(dtype, head_dim, block_q, block_kv)} of TPX_FLASH_*_MMA_TILES."""
    text = (CSRC / f"{kernel}_mma.cuh").read_text()
    tag = kernel.removeprefix("flash_").upper()
    lists = re.findall(rf"#define TPX_FLASH_{tag}_MMA_TILES_\w+\(X\)(.*)", text)
    assert lists, kernel
    types = {"float": torch.float32, "__nv_bfloat16": torch.bfloat16}
    return {(types[t], int(d), int(bq), int(bk)) for line in lists
            for t, d, bq, bk in re.findall(r"X\((\w+), (\d+), (\d+), (\d+)\)", line)}


@pytest.mark.parametrize("kernel", ["flash_fwd", "flash_dq", "flash_dkv"])
def test_mma_tiles_name_the_compiled_instances(kernel):
    """MMA_TILES is what the .cuh instantiates, one tile per dtype and head
    dim: f32 at every flash head dim, bf16 at 256."""
    want = {(dtype, d, *tile) for (kern, dtype, d), tile in fused.MMA_TILES.items()
            if kern == kernel}
    assert _cuh_tiles(kernel) == want
    assert {(dtype, d) for dtype, d, _, _ in want} == {
        *((torch.float32, d) for d in fused.FLASH_HEAD_DIMS), (torch.bfloat16, 256)}
