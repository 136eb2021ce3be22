"""The flash kernels' variant rule and the tensor-core kernels' arithmetic,
on the CPU.

``ops.fused.flash_variant`` sends bf16 at head_dim 64 and 128 to the wgmma
kernels (``csrc/flash_fwd_wgmma.cu``, ``csrc/flash_dq_wgmma.cu``,
``csrc/flash_dkv_wgmma.cu``) and the rest, per kernel, to the mma.sync
forward and dk/dv and the CUDA-core dq (tests/test_torch_flash_tf32.py
emulates the mma kernels). The wgmma
kernels cannot run here, so their arithmetic is emulated in f32 PyTorch
step by step: bf16 inputs, exact products summed in f32, the scale applied
to S in f32 in base 2, the forward's online softmax over 128-wide kv
tiles, and the probabilities P (forward and dk/dv) and dS (dq and dk)
split into bf16 hi + lo before the second product. The emulation must meet the port's plain versions within 1e-5
relative; with one bf16 rounding in place of the split it misses the
card's 1e-3 tolerance (chip_smoke.py ``BF16_TOL``), which is why the
kernels issue each of those products twice. With segment ids the masked
instances' arithmetic, the forward's running-max guard included, meets the
masked plain versions as well.
"""

import math

import numpy as np
import pytest
import torch

from torchx_tpu_torch.ops import fused
from torch_threads import xdist_torch_threads  # noqa: F401

LOG2E = math.log2(math.e)
#: chip_smoke.py's bf16 tolerance for the flash kernels
BF16_TOL = 1e-3


def _parts(x, rounding):
    """The bf16 terms a kernel feeds the tensor cores for f32 ``x``."""
    hi = x.bfloat16().float()
    if rounding == "single":
        return [hi]
    return [hi, (x - hi).bfloat16().float()]


def _heads(x, n_rep):
    """[b, s, kvh, d] -> f32 [b, h, s, d], each KV head read n_rep times."""
    return x.float().repeat_interleave(n_rep, dim=2).transpose(1, 2)


def _emulate_fwd(q, k, v, causal, rounding, tile=128, seg=None, guard=True):
    b, s, h, d = q.shape
    n_rep = h // k.shape[2]
    qf, kf, vf = q.float().transpose(1, 2), _heads(k, n_rep), _heads(v, n_rep)
    scale_log2 = LOG2E / math.sqrt(d)
    m = torch.full((b, h, s), -math.inf)
    l = torch.zeros(b, h, s)  # noqa: E741
    acc = torch.zeros(b, h, s, d)
    rows = torch.arange(s)[:, None]
    for kt in range(s // tile):
        kv = slice(kt * tile, (kt + 1) * tile)
        x = (qf @ kf[:, :, kv].transpose(-1, -2)) * scale_log2
        if causal:
            x = x.masked_fill(torch.arange(kv.start, kv.stop)[None, :] > rows, -math.inf)
        if seg is not None:
            x = x.masked_fill(seg[:, None, :, None] != seg[:, None, None, kv], -math.inf)
        m_new = torch.maximum(m, x.amax(-1))
        # a row whose keys so far all lie in other segments keeps max -inf:
        # the masked kernel takes 0 as its softmax reference there
        ref = torch.where(m_new == -math.inf, 0.0, m_new) if guard else m_new
        alpha = torch.exp2(m - ref)
        p = torch.exp2(x - ref[..., None])
        l = l * alpha + p.sum(-1)  # noqa: E741
        acc = acc * alpha[..., None]
        for part in _parts(p, rounding):
            acc = acc + part @ vf[:, :, kv]
        m = m_new
    lse = (m + torch.log2(l)) * math.log(2)
    return (acc / l[..., None]).transpose(1, 2), lse


def _emulate_dkv(q, k, v, do, lse, delta, causal, rounding, seg=None):
    b, s, h, d = q.shape
    kvh = k.shape[2]
    n_rep = h // kvh
    qf, dof = q.float().transpose(1, 2), do.float().transpose(1, 2)
    kf, vf = _heads(k, n_rep), _heads(v, n_rep)
    # transposed tiles [b, h, kv, q], as the kernel holds them
    p = torch.exp2((kf @ qf.transpose(-1, -2)) * (LOG2E / math.sqrt(d))
                   - (lse * LOG2E)[:, :, None, :])
    if causal:
        p = p.masked_fill(torch.arange(s)[None, :] < torch.arange(s)[:, None], 0.0)
    if seg is not None:
        p = p.masked_fill((seg[:, :, None] != seg[:, None, :])[:, None], 0.0)
    ds = p * (vf @ dof.transpose(-1, -2) - delta[:, :, None, :])
    dv = sum(part @ dof for part in _parts(p, rounding))
    dk = sum(part @ qf for part in _parts(ds, rounding)) / math.sqrt(d)

    def fold(x):  # noqa: ANN001, ANN202
        return x.transpose(1, 2).reshape(b, s, kvh, n_rep, d).sum(dim=3)

    return fold(dk), fold(dv)


def _emulate_dq(q, k, v, do, lse, delta, causal, rounding, seg=None):
    d = q.shape[-1]
    n_rep = q.shape[2] // k.shape[2]
    qf, dof = q.float().transpose(1, 2), do.float().transpose(1, 2)
    kf, vf = _heads(k, n_rep), _heads(v, n_rep)
    # [b, h, q, kv] tiles, as the kernel holds them
    p = torch.exp2((qf @ kf.transpose(-1, -2)) * (LOG2E / math.sqrt(d))
                   - (lse * LOG2E)[..., None])
    if causal:
        s = q.shape[1]
        p = p.masked_fill(torch.arange(s)[None, :] > torch.arange(s)[:, None], 0.0)
    if seg is not None:
        p = p.masked_fill((seg[:, :, None] != seg[:, None, :])[:, None], 0.0)
    ds = p * (dof @ vf.transpose(-1, -2) - delta[..., None])
    # the scale multiplies dq once, in the f32 epilogue
    dq = sum(part @ kf for part in _parts(ds, rounding)) * (1 / math.sqrt(d))
    return dq.transpose(1, 2)


def _rel(a, b):
    """max |a - b| over max |b| (floored at 1), as chip_smoke.py's rel_err."""
    return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))


def _case(b, s, h, kvh, d, causal, rounding, seg=None):
    """-> relative errors of the emulated o, lse, dq, dk, dv against the
    port's plain versions on the same bf16 inputs (masked by the segment
    ids ``seg`` where given)."""
    rng = np.random.default_rng(0)

    def rnd(*shape):  # noqa: ANN001, ANN202
        return torch.tensor(rng.standard_normal(shape).astype(np.float32)).bfloat16()

    q, k, v, do = rnd(b, s, h, d), rnd(b, s, kvh, d), rnd(b, s, kvh, d), rnd(b, s, h, d)
    o_p, lse_p = fused._flash_fwd_plain(q, k, v, causal, seg)
    o_e, lse_e = _emulate_fwd(q, k, v, causal, rounding, seg=seg)
    args = (q, k, v, do, lse_p, fused._flash_delta(do, o_p), causal)
    dq_p = fused._flash_dq_plain(*args, seg)
    dq_e = _emulate_dq(*args, rounding, seg=seg)
    dk_p, dv_p = fused._flash_dkv_plain(*args, seg)
    dk_e, dv_e = _emulate_dkv(*args, rounding, seg=seg)
    return {"o": _rel(o_e, o_p), "lse": _rel(lse_e, lse_p), "dq": _rel(dq_e, dq_p),
            "dk": _rel(dk_e, dk_p), "dv": _rel(dv_e, dv_p)}


@pytest.mark.parametrize("shape", [(1, 256, 4, 1, 64), (2, 256, 4, 2, 128)])
def test_hi_lo_split_meets_plain(shape):
    """Causal GQA: the kernels' arithmetic with the hi + lo split is within
    1e-5 of the f32 plain versions."""
    errs = _case(*shape, causal=True, rounding="split")
    assert max(errs.values()) <= 1e-5, errs


#: two rows of packed documents whose boundaries fall inside the 128-row
#: tiles; in the second the first document ends at 150, so its rows
#: 150-255 see the whole first kv tile masked
SEGMENTS = torch.tensor([[0] * 37 + [1] * 100 + [2] * 119, [0] * 150 + [1] * 106],
                        dtype=torch.int32)


@pytest.mark.parametrize("causal", [True, False])
def test_hi_lo_split_meets_plain_with_segments(causal):
    """The masked kernels' arithmetic (flash_*_wgmma.cu with kSeg) within
    1e-5 of the masked plain versions."""
    errs = _case(2, 256, 4, 2, 64, causal, "split", seg=SEGMENTS)
    assert max(errs.values()) <= 1e-5, errs


def test_masked_forward_needs_the_running_max_guard():
    """Rows whose first kv tile lies wholly in another segment keep a
    running max of -inf; without the masked forward's reference of 0 there,
    exp2(-inf - -inf) turns them NaN."""
    q = torch.randn(2, 256, 4, 64, generator=torch.Generator().manual_seed(1)).bfloat16()
    kv = q[:, :, :2].contiguous()
    o_n, _ = _emulate_fwd(q, kv, kv, True, "split", seg=SEGMENTS, guard=False)
    assert torch.isnan(o_n[1, 150:]).all() and not torch.isnan(o_n[1, :150]).any()
    o_g, _ = _emulate_fwd(q, kv, kv, True, "split", seg=SEGMENTS)
    assert not torch.isnan(o_g).any()


def test_single_bf16_rounding_misses_tolerance():
    """The usual design, P and dS rounded once to bf16, misses 1e-3 on dk/dv."""
    errs = _case(1, 256, 4, 1, 64, causal=True, rounding="single")
    assert max(errs["dk"], errs["dv"]) > BF16_TOL, errs


def test_single_bf16_rounding_misses_tolerance_on_dq():
    """dS rounded once to bf16 misses 1e-3 on dq too: flash_dq_wgmma
    splits it."""
    errs = _case(1, 256, 4, 1, 64, causal=True, rounding="single")
    assert errs["dq"] > BF16_TOL, errs


@pytest.mark.parametrize("kernel", ["flash_fwd", "flash_dq", "flash_dkv"])
@pytest.mark.parametrize("head_dim", [64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_flash_variant_rule(dtype, head_dim, kernel):
    """Per kernel: wgmma for bf16 at 64 and 128; elsewhere mma (dq too:
    no kernel of the port runs on the CUDA cores)."""
    want = "wgmma" if dtype == torch.bfloat16 and head_dim in (64, 128) else "mma"
    assert fused.flash_variant(kernel, dtype, head_dim) == want


def test_pick_variant_refuses_what_wgmma_cannot_take():
    """Each variant refuses the kernels, dtypes and head dims it has no
    instance for: wgmma bf16 at 64/128 only, mma f32 at 64/128/256 and
    bf16 at 256, for each of the three kernels; no simt variant is left."""
    f32 = torch.zeros(1, 128, 2, 64)
    bf = f32.bfloat16()
    bf256 = torch.zeros(1, 128, 2, 256).bfloat16()
    for kernel in fused.FLASH_KERNELS:
        assert fused._pick_variant(kernel, None, (f32,)) == "mma"
        assert fused._pick_variant(kernel, None, (bf,)) == "wgmma"
        assert fused._pick_variant(kernel, None, (bf256,)) == "mma"
        assert fused._pick_variant(kernel, "mma", (bf256,)) == "mma"
    with pytest.raises(ValueError, match="wgmma kernels take bf16"):
        fused._pick_variant("flash_fwd", "wgmma", (f32,))
    with pytest.raises(ValueError, match="wgmma kernels take bf16"):
        fused._pick_variant("flash_dkv", "wgmma", (bf256,))
    with pytest.raises(ValueError, match="mma kernels take f32"):
        fused._pick_variant("flash_dq", "mma", (bf,))
    with pytest.raises(ValueError, match="mma kernels take f32"):
        fused._pick_variant("flash_fwd", "mma", (bf,))
    with pytest.raises(ValueError, match="variant must be one of"):
        fused._pick_variant("flash_dq", "simt", (f32,))
    with pytest.raises(ValueError, match="variant must be one of"):
        fused._pick_variant("flash_dkv", "simt", (bf256,))
    with pytest.raises(ValueError, match="variant must be one of"):
        fused._pick_variant("flash_fwd", "tensor", (bf,))
    with pytest.raises(ValueError, match="kernel must be one of"):
        fused.flash_variant("flash_bwd", torch.float32, 64)


@pytest.mark.parametrize("wrapper", ["_flash_fwd", "_flash_dq", "_flash_dkv"])
def test_wrappers_pick_variant_before_launch(wrapper, monkeypatch):
    """Each flash wrapper routes a non-CPU tensor through _pick_variant,
    which refuses before anything launches (meta tensors: no data, no card;
    the device checks of _dims are stubbed)."""
    monkeypatch.setattr(fused, "_dims", lambda *a: [])
    monkeypatch.setattr(fused._build, "cuda_lib", lambda: pytest.fail("launched"))
    fn = getattr(fused, wrapper)

    def call(q, variant):  # noqa: ANN001, ANN202
        lse = torch.zeros(q.shape[0], q.shape[2], q.shape[1], device="meta")
        more = () if wrapper == "_flash_fwd" else (q, lse, lse)
        return fn(q, q, q, *more, True, variant=variant)

    f32 = torch.zeros(1, 128, 2, 64, device="meta")
    with pytest.raises(ValueError, match="wgmma kernels take bf16"):
        call(f32, "wgmma")
    with pytest.raises(ValueError, match="wgmma kernels take bf16"):
        call(torch.zeros(1, 128, 2, 256, device="meta", dtype=torch.bfloat16), "wgmma")
    with pytest.raises(ValueError, match="variant must be one of"):
        call(f32.bfloat16(), "tensor")
    # each wrapper refuses the CUDA-core variant, which no kernel has now,
    # and mma where it has no instance (bf16 at head_dim 64)
    with pytest.raises(ValueError, match="variant must be one of"):
        call(f32, "simt")
    with pytest.raises(ValueError, match="mma kernels take f32"):
        call(f32.bfloat16(), "mma")
