"""The port's hand-written kernels on the card, against their plain PyTorch
versions. Marked ``cuda``: they skip where no CUDA device is present and
run on the H100 with (the repo's conftest imports JAX, which the card's
machine does not have, hence ``--noconftest``)::

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

f32 comparisons run with TF32 off (``torch.backends.cuda.matmul.allow_tf32
= False``), at the CPU parity tests' tolerances; the bf16 tensor-core
(wgmma) flash kernels at chip_smoke.py's 1e-3, relative to the largest
reference value. The mma flash kernels (f32, and bf16 at head_dim 256) and
the int8-weight matmul (its f32-activation path on TF32 mma.sync among
them) alone::

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -k "mma or int8"
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from torchx_tpu_torch import _build
from torchx_tpu_torch.examples import train_llama
from torchx_tpu_torch.examples.data import TokenDataset
from torchx_tpu_torch.models import generate as tgen
from torchx_tpu_torch.models import llama
from torchx_tpu_torch.ops import fused, norms
from torchx_tpu_torch.ops import paged_attention as pa
from torchx_tpu_torch.parallel import checkpoint as ckpt_mod
from torchx_tpu_torch.parallel.checkpoint import Checkpointer
from torchx_tpu_torch.parallel.prefetch import device_prefetch
from torchx_tpu_torch.serve.engine import ServeEngine
from torch_threads import xdist_torch_threads  # noqa: F401

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run on the card only")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


def _randn(gen, *shape, dtype=torch.float32):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("n_rep,causal", [(1, True), (4, True), (2, False)])
def test_flash_kernels_match_plain(gen, d, n_rep, causal):
    b, s, kvh = 2, 256, 2
    q = _randn(gen, b, s, kvh * n_rep, d)
    k, v = _randn(gen, b, s, kvh, d), _randn(gen, b, s, kvh, d)
    do = _randn(gen, *q.shape)
    o_p, lse_p = fused._flash_fwd_plain(q, k, v, causal)
    o_k, lse_k = fused._flash_fwd(q, k, v, causal)
    torch.testing.assert_close(o_k, o_p, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(lse_k, lse_p, rtol=2e-5, atol=2e-5)
    delta = fused._flash_delta(do, o_p)
    args = (q, k, v, do, lse_p, delta, causal)
    torch.testing.assert_close(
        fused._flash_dq(*args), fused._flash_dq_plain(*args), rtol=5e-4, atol=5e-4
    )
    for a, b_ in zip(fused._flash_dkv(*args), fused._flash_dkv_plain(*args)):
        torch.testing.assert_close(a, b_, rtol=5e-4, atol=5e-4)


def _rel(a, b):
    """max |a - b| over max |b| (floored at 1), as chip_smoke.py's rel_err."""
    return float((a.float() - b.float()).abs().max()) / max(1.0, float(b.float().abs().max()))


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("n_rep", [1, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_wgmma_kernels_match_plain(gen, d, n_rep, causal):
    b, s, kvh = 2, 512, 2
    q = _randn(gen, b, s, kvh * n_rep, d, dtype=torch.bfloat16)
    k = _randn(gen, b, s, kvh, d, dtype=torch.bfloat16)
    v = _randn(gen, b, s, kvh, d, dtype=torch.bfloat16)
    do = _randn(gen, *q.shape, dtype=torch.bfloat16)
    o_p, lse_p = fused._flash_fwd_plain(q, k, v, causal)
    o_k, lse_k = fused._flash_fwd(q, k, v, causal, variant="wgmma")
    assert _rel(o_k, o_p) <= 1e-3 and _rel(lse_k, lse_p) <= 1e-3
    args = (q, k, v, do, lse_p, fused._flash_delta(do, o_p), causal)
    assert _rel(fused._flash_dq(*args, variant="wgmma"), fused._flash_dq_plain(*args)) <= 1e-3
    for a, b_ in zip(fused._flash_dkv(*args, variant="wgmma"), fused._flash_dkv_plain(*args)):
        assert _rel(a, b_) <= 1e-3


#: every compiled tile of the wgmma kernels (ops/fused.py WGMMA_TILES)
TILE_CASES = [(kernel, d, bq, bk) for (kernel, d), (q_tiles, kv_tiles) in fused.WGMMA_TILES.items()
              for bq in q_tiles for bk in kv_tiles]


@pytest.mark.parametrize("kernel,d,bq,bk", TILE_CASES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("masked", [False, True])
def test_every_wgmma_tile_matches_plain(gen, kernel, d, bq, bk, causal, masked):
    """Each compiled tile of each wgmma kernel, with and without segment ids
    (documents whose boundaries fall inside every tile), launched at that
    tile, within chip_smoke.py's 1e-3 of the plain version; s 384 takes
    every tile of the grid."""
    b, s, kvh, n_rep = 2, 384, 2, 2
    q = _randn(gen, b, s, kvh * n_rep, d, dtype=torch.bfloat16)
    k = _randn(gen, b, s, kvh, d, dtype=torch.bfloat16)
    v = _randn(gen, b, s, kvh, d, dtype=torch.bfloat16)
    do = _randn(gen, *q.shape, dtype=torch.bfloat16)
    seg = None
    if masked:
        lengths = [37, 100, 150, 97]
        seg = torch.repeat_interleave(torch.arange(len(lengths)), torch.tensor(lengths))
        seg = seg.to(torch.int32).expand(b, s).contiguous().cuda()
    assert fused.fit_tile(kernel, "wgmma", d, s, bq, bk) == (bq, bk)
    tile = (bq, bk)
    o_p, lse_p = fused._flash_fwd_plain(q, k, v, causal, seg)
    args = (q, k, v, do, lse_p, fused._flash_delta(do, o_p), causal, seg)
    name = f"{kernel}_wgmma" + ("_seg" if masked else "")
    _build.reset_launches()
    if kernel == "flash_fwd":
        o_k, lse_k = fused._flash_fwd(q, k, v, causal, seg, variant="wgmma", tile=tile)
        assert _rel(o_k, o_p) <= 1e-3 and _rel(lse_k, lse_p) <= 1e-3
    elif kernel == "flash_dq":
        got = fused._flash_dq(*args, variant="wgmma", tile=tile)
        assert _rel(got, fused._flash_dq_plain(*args)) <= 1e-3
    else:
        for a, b_ in zip(fused._flash_dkv(*args, variant="wgmma", tile=tile),
                         fused._flash_dkv_plain(*args)):
            assert _rel(a, b_) <= 1e-3
    torch.cuda.synchronize()
    assert _build.launch_counts()[name] == 1


#: every mma instance: (kernel, dtype, head_dim) of ops/fused.py MMA_TILES
MMA_CASES = sorted({(kernel, dtype, d) for kernel, dtype, d in fused.MMA_TILES},
                   key=lambda c: (c[0], str(c[1]), c[2]))


@pytest.mark.parametrize("kernel,dtype,d", MMA_CASES, ids=lambda v: str(v).removeprefix("torch."))
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("masked", [False, True])
def test_every_mma_instance_matches_plain(gen, kernel, dtype, d, causal, masked):
    """Each mma instance, with and without segment ids (documents whose
    boundaries fall inside every tile), launched once at its tile, against
    the plain version: f32 within 2e-5 (forward) and 5e-4 (dq, dk/dv), bf16
    within 1e-3, relative to the largest reference value."""
    b, s, kvh, n_rep = 2, 384, 2, 2
    q = _randn(gen, b, s, kvh * n_rep, d, dtype=dtype)
    k, v = (_randn(gen, b, s, kvh, d, dtype=dtype) for _ in range(2))
    do = _randn(gen, *q.shape, dtype=dtype)
    seg = None
    if masked:
        lengths = [37, 100, 150, 97]
        seg = torch.repeat_interleave(torch.arange(len(lengths)), torch.tensor(lengths))
        seg = seg.to(torch.int32).expand(b, s).contiguous().cuda()
    o_p, lse_p = fused._flash_fwd_plain(q, k, v, causal, seg)
    _build.reset_launches()
    if kernel == "flash_fwd":
        got, want = fused._flash_fwd(q, k, v, causal, seg, variant="mma"), (o_p, lse_p)
        tol = 2e-5 if dtype == torch.float32 else 1e-3
    else:
        args = (q, k, v, do, lse_p, fused._flash_delta(do, o_p), causal, seg)
        if kernel == "flash_dq":
            got, want = (fused._flash_dq(*args, variant="mma"),), (fused._flash_dq_plain(*args),)
        else:
            got, want = fused._flash_dkv(*args, variant="mma"), fused._flash_dkv_plain(*args)
        tol = 5e-4 if dtype == torch.float32 else 1e-3
    torch.cuda.synchronize()
    assert _build.launch_counts()[f"{kernel}_mma" + ("_seg" if masked else "")] == 1
    for a, b_ in zip(got, want):
        assert _rel(a, b_) <= tol


@pytest.mark.parametrize("dtype,d", [(torch.float32, 64), (torch.float32, 256),
                                     (torch.bfloat16, 256)])
def test_flash_dkv_mma_is_deterministic(gen, dtype, d):
    q, do = (_randn(gen, 2, 1024, 8, d, dtype=dtype) for _ in range(2))
    k, v = (_randn(gen, 2, 1024, 4, d, dtype=dtype) for _ in range(2))
    o, lse = fused._flash_fwd(q, k, v, True)
    args = (q, k, v, do, lse, fused._flash_delta(do, o), True)
    first, second = fused._flash_dkv(*args), fused._flash_dkv(*args)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("dtype,d", [(torch.float32, 64), (torch.float32, 256),
                                     (torch.bfloat16, 256)])
@pytest.mark.parametrize("masked", [False, True])
def test_flash_dq_mma_is_deterministic(gen, dtype, d, masked):
    """dq is owned by one CTA a q tile and summed without atomics: two
    calls agree bitwise, masked or not."""
    seg = _packed_ids(2, 1024, 300, seed=3) if masked else None
    q, do = (_randn(gen, 2, 1024, 8, d, dtype=dtype) for _ in range(2))
    k, v = (_randn(gen, 2, 1024, 4, d, dtype=dtype) for _ in range(2))
    o, lse = fused._flash_fwd(q, k, v, True, seg)
    args = (q, k, v, do, lse, fused._flash_delta(do, o), True, seg)
    assert torch.equal(fused._flash_dq(*args), fused._flash_dq(*args))


def test_flash_dkv_wgmma_is_deterministic(gen):
    q, do = (_randn(gen, 2, 1024, 8, 64, dtype=torch.bfloat16) for _ in range(2))
    k, v = (_randn(gen, 2, 1024, 2, 64, dtype=torch.bfloat16) for _ in range(2))
    o, lse = fused._flash_fwd(q, k, v, True)
    args = (q, k, v, do, lse, fused._flash_delta(do, o), True)
    first, second = fused._flash_dkv(*args), fused._flash_dkv(*args)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("d", [64, 128])
def test_flash_dq_wgmma_is_deterministic(gen, d):
    q, do = (_randn(gen, 2, 1024, 8, d, dtype=torch.bfloat16) for _ in range(2))
    k, v = (_randn(gen, 2, 1024, 2, d, dtype=torch.bfloat16) for _ in range(2))
    o, lse = fused._flash_fwd(q, k, v, True)
    args = (q, k, v, do, lse, fused._flash_delta(do, o), True)
    assert torch.equal(fused._flash_dq(*args), fused._flash_dq(*args))


def test_flash_autograd_bf16(gen):
    q = _randn(gen, 2, 512, 8, 64, dtype=torch.bfloat16).requires_grad_()
    k = _randn(gen, 2, 512, 2, 64, dtype=torch.bfloat16).requires_grad_()
    v = _randn(gen, 2, 512, 2, 64, dtype=torch.bfloat16).requires_grad_()
    _build.reset_launches()
    out = fused.flash_attention(q, k, v)
    out.float().square().sum().backward()
    counts = _build.launch_counts()
    assert (counts["flash_fwd_wgmma"], counts["flash_dq_wgmma"], counts["flash_dkv_wgmma"]) == (
        1, 1, 1)
    assert counts["flash_fwd_mma"] == counts["flash_dq_mma"] == counts["flash_dkv_mma"] == 0
    assert out.dtype == torch.bfloat16 and k.grad.shape == k.shape
    assert all(torch.isfinite(t.grad).all() for t in (q, k, v))


def test_wrong_inputs_raise(gen):
    q = _randn(gen, 1, 256, 2, 64)
    with pytest.raises(ValueError, match="dtype"):
        fused._flash_fwd(q, q.half(), q.half(), True)
    with pytest.raises(ValueError, match="contiguous"):
        fused._flash_fwd(q, q.transpose(1, 2).contiguous().transpose(1, 2), q, True)


def _packed_ids(b, s, max_len, seed):
    """int32 [b, s] ids of packed documents with lengths drawn in
    [1, max_len] (boundaries fall inside tiles); the last row is one
    document."""
    rng = np.random.default_rng(seed)
    seg = np.zeros((b, s), np.int32)
    for row in range(b - 1):
        pos, doc = 0, 0
        while pos < s:
            n = int(rng.integers(1, max_len + 1))
            seg[row, pos:pos + n] = doc
            pos, doc = pos + n, doc + 1
    return torch.tensor(seg, device="cuda")


@pytest.mark.parametrize("variant,dtype,d", [
    ("mma", torch.float32, 64), ("mma", torch.float32, 256), ("mma", torch.bfloat16, 256),
    ("wgmma", torch.bfloat16, 64), ("wgmma", torch.bfloat16, 128),
])
@pytest.mark.parametrize("causal", [True, False])
def test_masked_flash_kernels_match_plain(gen, variant, dtype, d, causal):
    """Segment-masked fwd, dq and dk/dv against their plain versions (f32
    at the CPU parity tolerances, bf16 at 1e-3 relative); the one-document
    row bitwise the unmasked kernel's. "mma": each kernel's variant by the
    rule, the mma forward, dq and dk/dv."""
    variant = None if variant == "mma" else variant
    b, s, kvh, n_rep = 3, 512, 2, 2
    seg = _packed_ids(b, s, 200, seed=d + causal)
    q = _randn(gen, b, s, kvh * n_rep, d, dtype=dtype)
    k, v = (_randn(gen, b, s, kvh, d, dtype=dtype) for _ in range(2))
    do = _randn(gen, *q.shape, dtype=dtype)
    o_p, lse_p = fused._flash_fwd_plain(q, k, v, causal, seg)
    o_k, lse_k = fused._flash_fwd(q, k, v, causal, seg, variant=variant)
    args = (q, k, v, do, lse_p, fused._flash_delta(do, o_p), causal)
    dq_p, dq_k = fused._flash_dq_plain(*args, seg), fused._flash_dq(*args, seg, variant=variant)
    dkv_p, dkv_k = fused._flash_dkv_plain(*args, seg), fused._flash_dkv(*args, seg, variant=variant)
    pairs = [(o_k, o_p, 2e-5), (lse_k, lse_p, 2e-5), (dq_k, dq_p, 5e-4),
             (dkv_k[0], dkv_p[0], 5e-4), (dkv_k[1], dkv_p[1], 5e-4)]
    for got, want, tol in pairs:
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, rtol=tol, atol=tol)
        else:
            assert _rel(got, want) <= 1e-3
    o_u, lse_u = fused._flash_fwd(q, k, v, causal, variant=variant)
    dq_u = fused._flash_dq(*args, variant=variant)
    dk_u, dv_u = fused._flash_dkv(*args, variant=variant)
    for masked, plain in zip((o_k, lse_k, dq_k, *dkv_k), (o_u, lse_u, dq_u, dk_u, dv_u)):
        assert torch.equal(masked[-1], plain[-1])


@pytest.mark.parametrize("d", [64, 128])
def test_masked_wgmma_backward_is_deterministic(gen, d):
    seg = _packed_ids(2, 1024, 300, seed=1)
    q, do = (_randn(gen, 2, 1024, 8, d, dtype=torch.bfloat16) for _ in range(2))
    k, v = (_randn(gen, 2, 1024, 2, d, dtype=torch.bfloat16) for _ in range(2))
    o, lse = fused._flash_fwd(q, k, v, True, seg)
    args = (q, k, v, do, lse, fused._flash_delta(do, o), True, seg)
    assert torch.equal(fused._flash_dq(*args), fused._flash_dq(*args))
    first, second = fused._flash_dkv(*args), fused._flash_dkv(*args)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_attention_flash_with_segments_launches_masked_kernels(gen):
    from torchx_tpu_torch.ops.attention import attention

    seg = _packed_ids(2, 512, 100, seed=2)
    q = _randn(gen, 2, 512, 8, 64, dtype=torch.bfloat16).requires_grad_()
    k = _randn(gen, 2, 512, 2, 64, dtype=torch.bfloat16).requires_grad_()
    v = _randn(gen, 2, 512, 2, 64, dtype=torch.bfloat16).requires_grad_()
    _build.reset_launches()
    out = attention(q, k, v, segment_ids=seg, impl="flash")
    out.float().square().sum().backward()
    counts = _build.launch_counts()
    assert [counts[f"flash_{n}_wgmma_seg"] for n in ("fwd", "dq", "dkv")] == [1, 1, 1]
    assert sum(counts.values()) == 3
    assert all(torch.isfinite(t.grad).all() for t in (q, k, v))
    with pytest.raises(ValueError, match="segment_ids must be int32"):
        attention(q, k, v, segment_ids=seg.long(), impl="flash")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_norm_kernels_match_plain(gen, dtype):
    n, d = 300, 384  # rows not a multiple of the program count
    x, r, dy = (_randn(gen, n, d, dtype=dtype) for _ in range(3))
    w = (1 + 0.1 * _randn(gen, d)).to(dtype)
    y_k, s_k = fused._norm_res_fwd(x, r, w, 1e-5)
    y_p, s_p = fused._rms_norm_residual_math(x, r, w, 1e-5)
    assert torch.equal(s_k, s_p)  # the residual stream is bitwise
    tol = 1e-6 if dtype == torch.float32 else 2**-7  # one bf16 rounding step
    torch.testing.assert_close(y_k.float(), y_p.float(), rtol=tol, atol=tol)
    dx_k, dw_k = norms._bwd(x, dy, w, 1e-5)
    dx_p, dw_p = norms._bwd_math(x, w, dy, 1e-5)
    dx_tol = max(tol, 2e-5)
    torch.testing.assert_close(dx_k.float(), dx_p.float(), rtol=dx_tol, atol=dx_tol)
    torch.testing.assert_close(dw_k, dw_p, rtol=2e-5, atol=2e-4)


def test_dw_is_deterministic(gen):
    x, dy = _randn(gen, 4096, 256), _randn(gen, 4096, 256)
    w = torch.ones(256, device="cuda")
    assert torch.equal(norms._bwd(x, dy, w, 1e-5)[1], norms._bwd(x, dy, w, 1e-5)[1])


@pytest.mark.parametrize("n,d", [(8192, 2048), (8190, 2048), (8192, 4096)])
def test_rms_norm_bwd_bf16_shapes(gen, n, d):
    """The llama3_1b rows, a ragged row count and llama3_8b's width: dx and
    dw at test_norm_kernels_match_plain's bf16 tolerances, dw bitwise
    repeatable."""
    x, dy = (_randn(gen, n, d, dtype=torch.bfloat16) for _ in range(2))
    w = (1 + 0.1 * _randn(gen, d)).to(torch.bfloat16)
    dx_k, dw_k = norms._bwd(x, dy, w, 1e-5)
    dx_p, dw_p = norms._bwd_math(x, w, dy, 1e-5)
    torch.testing.assert_close(dx_k.float(), dx_p.float(), rtol=2**-7, atol=2**-7)
    torch.testing.assert_close(dw_k, dw_p, rtol=2e-5, atol=2e-4)
    assert torch.equal(dw_k, norms._bwd(x, dy, w, 1e-5)[1])


def test_model_step_kernels_vs_reference(gen):
    """A small f32 model: loss and grads through the kernels equal the
    plain ops' to the CPU parity tolerances."""
    base = llama.llama_tiny(dim=128, n_heads=2, n_kv_heads=1, ffn_dim=256, remat=True)
    params = llama.init_params(base, gen, "cuda")
    batch = train_llama.synthetic_batch(base, 2, 256, device="cuda")
    results = []
    _build.reset_launches()
    for kernels, impl in (("cuda", "auto"), ("reference", "xla")):
        cfg = dataclasses.replace(base, kernels=kernels, attn_impl=impl, max_seq=256)
        loss = llama.loss_fn(params, batch, cfg)
        results.append((loss, torch.autograd.grad(loss, llama.leaves(params))))
    counts = _build.launch_counts()
    # f32: the mma forward, dq and dk/dv
    assert counts["flash_dkv_mma"] == base.n_layers
    assert counts["flash_dq_mma"] == base.n_layers
    torch.testing.assert_close(results[0][0], results[1][0], rtol=1e-5, atol=1e-5)
    for a, b in zip(results[0][1], results[1][1]):
        torch.testing.assert_close(a, b, rtol=5e-4, atol=5e-5)


def test_device_prefetch_to_cuda(gen, tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 1000, 8192, dtype=np.uint32).tofile(path)
    rows = TokenDataset(str(path), 64, 4)
    with device_prefetch(({"tokens": r} for r in rows), "cuda", depth=2) as pf:
        got = [next(pf)["tokens"] for _ in range(3)]
    for batch, want in zip(got, rows):
        assert batch.is_cuda
        assert torch.equal(batch.cpu(), torch.from_numpy(want))


# -- serving: the paged ops, the decode step and the engine on the card ----


def _paged_case(seed=0, dtype=torch.float32):
    """CPU tensors: pools [9, 4, 2, 16], two slots' tables over distinct
    blocks, new K/V rows and queries."""
    g = torch.Generator().manual_seed(seed)
    pool_k = torch.randn((9, 4, 2, 16), generator=g).to(dtype)
    pool_v = torch.randn((9, 4, 2, 16), generator=g).to(dtype)
    tables = torch.tensor([[3, 5, 1, 0], [2, 7, 0, 0]])
    return dict(
        pool_k=pool_k, pool_v=pool_v, tables=tables,
        positions=torch.tensor([9, 6]), lengths=torch.tensor([10, 7]),
        new=torch.randn((2, 2, 16), generator=g).to(dtype),
        q=torch.randn((2, 4, 16), generator=g).to(dtype),
        chunk_pos=torch.tensor([[6, 7, 8], [4, 5, 6]]),
        chunk_new=torch.randn((2, 3, 2, 16), generator=g).to(dtype),
        chunk_q=torch.randn((2, 3, 4, 16), generator=g).to(dtype),
    )


def _paged_ops(c):
    k, v = c["pool_k"].clone(), c["pool_v"].clone()
    pa.append_kv(k, c["tables"], c["positions"], c["new"])
    pa.scatter_kv_chunk(v, c["tables"], c["chunk_pos"], c["chunk_new"])
    pa.write_prefill(k, c["tables"][1, :2], c["chunk_new"][0].repeat(3, 1, 1)[:8])
    return {
        "k": k, "v": v,
        "gather": pa.gather_kv(k, c["tables"]),
        "attn": pa.paged_attention(c["q"], k, v, c["tables"], c["lengths"]),
        "chunk": pa.paged_attention_chunk(c["chunk_q"], k, v, c["tables"], c["chunk_pos"]),
    }


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_ops_match_cpu(gen, dtype):
    """The pool writes and gathers bitwise, the attention within f32 (or one
    bf16 rounding) of the CPU results."""
    c = _paged_case(dtype=dtype)
    cpu = _paged_ops(c)
    card = _paged_ops({k: t.cuda() for k, t in c.items()})
    for name in ("k", "v", "gather"):
        assert torch.equal(card[name].cpu(), cpu[name]), name
    tol = 2e-5 if dtype == torch.float32 else 2**-7
    for name in ("attn", "chunk"):
        torch.testing.assert_close(card[name].cpu().float(), cpu[name].float(),
                                   rtol=tol, atol=tol)


def test_paged_index_out_of_range_raises_before_launch(gen):
    c = {k: t.cuda() for k, t in _paged_case().items()}
    bad = c["tables"].clone()
    bad[0, 1] = 9  # past the pool's 9 blocks
    with pytest.raises(IndexError, match="out of range"):
        pa.gather_kv(c["pool_k"], bad)
    with pytest.raises(IndexError, match="out of range"):
        pa.append_kv(c["pool_k"], c["tables"], torch.tensor([16, 0], device="cuda"), c["new"])
    with pytest.raises(IndexError, match="out of range"):
        pa.write_prefill(c["pool_k"], torch.tensor([-1], device="cuda"), c["chunk_new"][0][:4])
    # the context is healthy: no device-side assert fired
    out = pa.gather_kv(c["pool_k"], c["tables"])
    torch.cuda.synchronize()
    assert out.shape == (2, 16, 2, 16)


def test_matmul_f32_out_dtype_matches_upcast(gen):
    """cuBLAS's f32 output of a bf16 product against the upcast f32 product
    (both exact products, f32 sums in another order)."""
    a = _randn(gen, 3, 64, 256, dtype=torch.bfloat16)
    b = _randn(gen, 3, 256, 96, dtype=torch.bfloat16)
    got = pa.matmul_f32(a, b)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, a.float() @ b.float(), rtol=1e-5, atol=1e-4)
    got2 = pa.matmul_f32(a[0], b[0])
    torch.testing.assert_close(got2, a[0].float() @ b[0].float(), rtol=1e-5, atol=1e-4)


def _tiny_serving(device):
    """The tiny f32 config and its seeded weights (made on the CPU), on
    ``device``, not requiring grad."""
    cfg = llama.llama_tiny()
    params = llama.init_params(cfg, torch.Generator().manual_seed(0))
    return cfg, {
        k: ({kk: vv.detach().to(device) for kk, vv in v.items()} if isinstance(v, dict)
            else v.detach().to(device))
        for k, v in params.items()
    }


def test_paged_decode_step_on_card_matches_cpu(gen):
    """One decode step over 4 slots (two live, one sampled) from the same
    pools: the same tokens, the pools' new rows within f32 tolerance."""
    cfg = llama.llama_tiny()
    g = torch.Generator().manual_seed(3)
    pools = {k: torch.randn((cfg.n_layers, 8, 8, cfg.n_kv_heads, cfg.head_dim), generator=g)
             for k in ("k", "v")}
    args = dict(tokens=torch.tensor([5, 9, 0, 0]), positions=torch.tensor([3, 12, 0, 0]),
                tables=torch.tensor([[1, 0], [2, 3], [0, 0], [0, 0]]),
                seeds=torch.tensor([0, 1, 0, 0]), temps=torch.tensor([0.0, 0.8, 0.0, 0.0]))
    outs = []
    for dev in ("cpu", "cuda"):
        _, params = _tiny_serving(dev)
        p = {k: v.clone().to(dev) for k, v in pools.items()}
        nxt = tgen.paged_decode_step(
            params, pools=p, cfg=cfg, **{k: v.to(dev) for k, v in args.items()})
        outs.append((nxt.cpu(), {k: v.cpu() for k, v in p.items()}))
    assert torch.equal(outs[0][0], outs[1][0])
    for k in ("k", "v"):
        torch.testing.assert_close(outs[1][1][k], outs[0][1][k], rtol=1e-5, atol=1e-5)


def test_engine_on_card_matches_dense(gen):
    cfg, params = _tiny_serving("cuda")
    assert not any(t.requires_grad for t in llama.leaves(params))
    eng = ServeEngine(params, cfg, max_slots=4, block_size=8, max_prefill_batch=2).start()
    try:
        prompts = [[1, 2, 3], [7, 8], [4, 5, 6, 7, 8, 9, 10], [11]]
        reqs = [eng.generate(p, 6, timeout=120) for p in prompts]
    finally:
        eng.stop()
    assert eng.pools["k"].is_cuda
    for p, r in zip(prompts, reqs):
        dense = tgen.generate(params, torch.tensor([p], device="cuda"), cfg, 6)
        assert r.tokens == dense[0].tolist()


# -- checkpoints of CUDA state ------------------------------------------------


def _cuda_state(gen, n=1 << 20):
    return {
        "params.w": _randn(gen, n, dtype=torch.bfloat16),
        "opt.mu.w": _randn(gen, n, dtype=torch.bfloat16),
        "params.b": _randn(gen, 64, 33),
        "opt.count": torch.tensor(3, dtype=torch.int64),
        "step": torch.tensor(3, dtype=torch.int64),
    }


def test_checkpoint_bf16_state_round_trip_bitwise(gen, tmp_path):
    state = _cuda_state(gen)
    ckpt = Checkpointer(str(tmp_path))
    assert ckpt.save(3, state)
    ckpt.close()
    live = {k: torch.zeros_like(v) for k, v in state.items()}
    step, out = Checkpointer(str(tmp_path)).restore_latest(into=live)
    assert step == 3 and out is live
    for k, v in state.items():
        assert out[k].device == v.device and torch.equal(out[k], v), k


def test_checkpoint_snapshot_is_fenced_before_a_kernel(gen, tmp_path, monkeypatch):
    """A kernel launched right after save() returns updates the tensors in
    place; the checkpoint still holds the values of the save. The card
    sleeps before the save, so an unfenced copy would still be in flight
    when the writer reads its buffers."""
    gate = threading.Event()
    real = ckpt_mod.Checkpointer._write

    def held(self, step, host):
        assert gate.wait(timeout=60)
        real(self, step, host)

    monkeypatch.setattr(ckpt_mod.Checkpointer, "_write", held)
    state = _cuda_state(gen, n=64 << 20)
    want = {k: v.cpu() for k, v in state.items()}
    ckpt = Checkpointer(str(tmp_path))
    torch.cuda._sleep(200_000_000)
    ckpt.save(1, state)
    state["params.w"].mul_(-1)  # the next step's in-place update
    state["opt.mu.w"].add_(1)
    gate.set()
    ckpt.wait()
    got = ckpt.restore(1)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    ckpt.close()


def test_checkpoint_restore_lands_on_the_card(gen, tmp_path):
    d = str(tmp_path / "ck")
    train_llama.train(llama.llama_tiny(), 2, 16, 3, device="cuda", log_every=0, ckpt_dir=d)
    seen = {}

    def grab(event, state):
        if event == "restored":
            seen.update(state)

    out = train_llama.train(llama.llama_tiny(), 2, 16, 2, device="cuda", log_every=0,
                            ckpt_dir=d, on_state=grab)
    assert out["resumed_from_step"] == 3 and out["final_step"] == 5
    assert all(v.is_cuda for k, v in seen.items() if k not in ("opt.count", "step"))
    assert out["checkpoint"]["restores"][0]["h2d_s"] >= 0


def test_checkpoint_pinned_buffers_are_reused(gen, tmp_path):
    state = _cuda_state(gen)
    ckpt = Checkpointer(str(tmp_path))
    ckpt.prepare(state)
    ptrs = {k: b.data_ptr() for k, b in ckpt._buffers.items()}
    assert all(b.is_pinned() for k, b in ckpt._buffers.items() if state[k].is_cuda)
    for step in (1, 2, 3):
        ckpt.save(step, state)
        assert {k: b.data_ptr() for k, b in ckpt._buffers.items()} == ptrs
    ckpt.wait()
    assert [w["step"] for w in ckpt.writes] == [1, 2, 3]
    ckpt.close()


def _spmd_train(d, steps, tmp_path):
    """The trainer as two gloo ranks sharing the card (``fsdp=2``,
    ``--ckpt-dir d``); -> rank 0's final summary."""
    import json
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cmd = [sys.executable, "-m", "torchx_tpu_torch.apps.spmd_main", "--nproc-per-node", "2",
           "--backend", "gloo", "--port", "0", "--timeout", "120",
           "-m", "torchx_tpu_torch.examples.train_llama", "--", "--device", "cuda",
           "--config", "tiny", "--batch", "4", "--seq", "16", "--steps", str(steps),
           "--mesh", "fsdp=2", "--ckpt-dir", d, "--log-every", "1"]
    env = dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="1",
               TPX_OBS_DIR=str(tmp_path / "obs"))
    out = subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=repo,
                         timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    return json.loads(out.stdout.split("final:", 1)[1].splitlines()[0])


def test_checkpoint_of_two_ranks_sharing_the_card(gen, tmp_path):
    """Two gloo ranks on the card save one sharded step (a file a rank and
    the index), resume from it, and one process restores it onto the card
    bitwise as a reader without a mesh assembles it."""
    import os

    d = str(tmp_path / "ck")
    first = _spmd_train(d, 3, tmp_path)
    assert first["world"] == 2 and first["final_step"] == 3
    assert sorted(os.listdir(os.path.join(d, "3"))) == ["index.json", "shard-0.pt",
                                                        "shard-1.pt"]
    again = _spmd_train(d, 2, tmp_path)
    assert again["resumed_from_step"] == 3 and again["final_step"] == 5
    whole = Checkpointer(d, read_only=True).restore(5)
    seen = {}
    out = train_llama.train(llama.llama_tiny(), 4, 16, 1, device="cuda", log_every=0,
                            ckpt_dir=d, on_state=lambda e, s: seen.update(
                                {k: v.clone() for k, v in s.items()}) if e == "restored"
                            else None)
    assert out["resumed_from_step"] == 5 and set(seen) == set(whole)
    for k, v in seen.items():
        assert torch.equal(v.cpu(), whole[k]), k
        assert v.is_cuda or k in ("opt.count", "step")


# -- the step profiler and the disaggregated roles on the card ---------------


def test_profiled_cuda_step_is_fenced_and_traced(gen, tmp_path, monkeypatch):
    """A profiled step on the card: one record per timed step whose
    forward_backward phase covers the fenced device step, and a
    torch.profiler trace holding the card's kernels."""
    import json
    import os

    from torchx_tpu_torch.obs import profile, sinks

    monkeypatch.setenv("TPX_OBS_DIR", str(tmp_path / "obs"))
    cfg = llama.llama_tiny(dim=128, n_heads=2, n_kv_heads=1, ffn_dim=256)
    out = train_llama.train(cfg, 2, 128, 4, device="cuda", kernels="cuda", log_every=1,
                            profile=True, profile_dir=str(tmp_path / "trace"))
    recs = [r for r in profile.load_profile(
        os.path.join(sinks.session_dir(), profile.PROFILE_FILE)) if r["kind"] == "step"]
    assert len(recs) == 3 == out["profile"]["steps"]
    for r, step_s in zip(recs, out["step_times_s"][1:]):
        ph = r["phases"]
        # the fence puts the device step inside forward_backward + optimizer
        assert ph["forward_backward"] + ph["optimizer"] <= step_s
        assert ph["forward_backward"] + ph["optimizer"] >= 0.5 * step_s
        assert sum(ph.values()) <= r["wall_s"] and r["mfu"] > 0
    events = json.load(open(out["profile_trace"]))["traceEvents"]
    assert any(e.get("cat") == "kernel" for e in events)


def test_world_one_mesh_on_card_is_bitwise_the_single_device_step(gen):
    """The sharded trainer on the card at a world of one (NCCL through an
    in-process store): gathers and reduce-scatters of one rank, the kernels
    on the gathered weights, give the single-device trainer's losses,
    gradient norms, state and launches, bitwise (bf16: the wgmma flash
    kernels, whose backward is repeatable)."""
    import torch.distributed as dist

    cfg = llama.llama_tiny(dim=128, n_heads=2, n_kv_heads=1, ffn_dim=256,
                           dtype=torch.bfloat16)
    runs = []
    for mesh in (None, "fsdp=-1"):
        box = {}

        def keep(event, state, box=box):
            if event == "final":
                box.update({k: v.clone() for k, v in state.items()})

        out = train_llama.train(cfg, 2, 128, 3, device="cuda", kernels="cuda", warmup=1,
                                log_every=0, mesh=mesh, grad_bucket_mb=4 if mesh else 0,
                                on_state=keep)
        runs.append((out, box))
    (a, sa), (b, sb) = runs
    assert b["backend"] == "nccl" and b["world"] == 1 and not dist.is_initialized()
    assert a["losses"] == b["losses"] and a["grad_norms"] == b["grad_norms"]
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert a["launches"] == b["launches"] == b["launches_by_rank"][0]
    assert b["launches"]["flash_fwd_wgmma"] > 0


def test_disaggregated_pair_equals_unified_on_card(gen):
    """f32 on the card: a prefill replica's K/V payload (through its bytes)
    decoded by a second engine gives the unified engine's greedy tokens."""
    from torchx_tpu_torch.serve.engine import ServeRequest, serve_kv_payload
    from torchx_tpu_torch.serve.kv_transfer import KvPayload

    cfg, params = _tiny_serving("cuda")
    engines = [ServeEngine(params, cfg, max_slots=2, block_size=8).start() for _ in range(3)]
    pre, dec, uni = engines
    try:
        for prompt in ([1, 2, 3], list(range(4, 24)), list(range(30, 70))):
            want = uni.generate(prompt, 6, timeout=120).tokens
            req = pre.submit(ServeRequest(prompt=prompt, max_new_tokens=6,
                                          prefill_only=True))
            assert req.wait(timeout=120) and req.error is None
            payload = KvPayload.from_bytes(req.handoff.to_bytes())
            assert payload.k.dtype == np.float32
            out = serve_kv_payload(dec, payload, timeout=120)
            assert prompt + out["tokens"] == want
    finally:
        for e in engines:
            e.stop()


# -- int8: the int8-weight matmul kernel and the int8 training dot -----------


def _int8_inputs(gen, m, k, n, dtype):
    from torchx_tpu_torch.ops import quant

    x = _randn(gen, m, k, dtype=dtype)
    q, scale = quant.quantize(_randn(gen, k, n) * k**-0.5)
    return x, q, scale


#: (M, K, N) of the bf16 cases: M from a decode step (1-16) to a prefill
#: chunk (2048), across the two paths' threshold; K of llama3_8b and one no
#: multiple of the 64-row stage; the lm head's N at decode rows; and ragged
#: N (no multiple of the 128-column tile).
INT8_BF16_CASES = (
    [(m, k, n) for m in (1, 8, 16, 17, 64, 100, 128, 512, 2048)
     for k in (4096, 14336, 1040) for n in (1024, 4096)]
    + [(m, k, 128256) for m in (1, 8) for k in (4096, 14336, 1040)]
    + [(m, k, n) for m in (1, 8, 17, 2048) for k, n in ((4096, 1040), (14336, 4112), (520, 16))]
)
#: f32 activations (the TF32 mma.sync kernel): the ragged cases.
INT8_F32_CASES = [(m, k, n) for m in (1, 8, 17, 2048)
                  for k, n in ((4096, 1040), (14336, 4112), (520, 16))]


@pytest.mark.parametrize(
    "m,k,n,dtype,out",
    [(*c, torch.bfloat16, out) for c in INT8_BF16_CASES for out in (None, torch.float32)]
    + [(*c, torch.float32, None) for c in INT8_F32_CASES],
)
def test_int8_matmul_matches_plain(gen, m, k, n, dtype, out):
    """Against the plain version on the same tensors: f32 outputs within
    1e-5 of the largest value, bf16 ones within one bf16 rounding (8e-3
    relative); two calls bitwise equal; one launch a call."""
    from torchx_tpu_torch.ops import quant

    x, q, scale = _int8_inputs(gen, m, k, n, dtype)
    name = quant.kernel_name(dtype)
    _build.reset_launches()
    y = quant.int8_matmul(x, q, scale, out_dtype=out)
    assert _build.launch_counts()[name] == 1
    want = quant._int8_matmul_plain(x, q, scale, out)
    assert y.shape == (m, n) and y.dtype == (out or dtype)
    if y.dtype == torch.float32:
        assert _rel(y, want) <= 1e-5, _rel(y, want)
    else:
        big = float(want.float().abs().max())
        torch.testing.assert_close(y.float(), want.float(), rtol=8e-3, atol=1e-5 * big)
    assert torch.equal(y, quant.int8_matmul(x, q, scale, out_dtype=out))


def test_int8_matmul_interleaved_shapes_share_the_counters(gen):
    """Split calls of different shapes in turns on one stream (decode
    splits of three widths, split wgmma calls of both tile heights): each
    call finds its tile counters at 0, so each result equals its shape's
    first, bitwise."""
    from torchx_tpu_torch.ops import quant

    shapes = [(8, 4096, 4096), (8, 4096, 1024), (512, 4096, 1024), (512, 4096, 4096),
              (3, 1040, 4096)]
    plans = [quant.launch_plan(m, n, k, False, 132) for m, k, n in shapes]
    assert all(p.splits > 1 for p in plans)
    assert {p.path for p in plans} == {quant.PATH_DECODE, quant.PATH_WGMMA}
    cases = [_int8_inputs(gen, m, k, n, torch.bfloat16) for m, k, n in shapes]
    first = [quant.int8_matmul(*c) for c in cases]
    for c, y in zip(cases, first):
        big = float(quant._int8_matmul_plain(*c).float().abs().max())
        torch.testing.assert_close(y.float(), quant._int8_matmul_plain(*c).float(), rtol=8e-3,
                                   atol=1e-5 * big)
    for _ in range(3):
        for c, y in zip(cases, first):
            assert torch.equal(quant.int8_matmul(*c), y)
    torch.cuda.synchronize()


@pytest.mark.parametrize("m", [8, 2048])
def test_int8_matmul_allocates_only_the_output(gen, m):
    """After a shape's first call on a stream, a call allocates its output
    and nothing else (the split-k scratch is held)."""
    from torchx_tpu_torch.ops import quant

    x, q, scale = _int8_inputs(gen, m, 4096, 1024, torch.bfloat16)
    quant.int8_matmul(x, q, scale)
    before = torch.cuda.memory_stats()["allocation.all.allocated"]
    quant.int8_matmul(x, q, scale)
    assert torch.cuda.memory_stats()["allocation.all.allocated"] - before == 1


@pytest.mark.parametrize("m", [8, 2048])
def test_int8_matmul_runs_one_device_kernel(gen, m):
    """A call is one kernel on the card: no separate split-k pass."""
    from torch.profiler import ProfilerActivity, profile

    from torchx_tpu_torch.ops import quant

    x, q, scale = _int8_inputs(gen, m, 4096, 4096, torch.bfloat16)
    quant.int8_matmul(x, q, scale)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        quant.int8_matmul(x, q, scale)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events() if e.device_type.name == "CUDA"]
    assert len(kernels) == 1 and "int8" in kernels[0], kernels


def test_int8_matmul_takes_leading_axes(gen):
    from torchx_tpu_torch.ops import quant

    x, q, scale = _int8_inputs(gen, 2 * 24, 256, 96, torch.bfloat16)
    y = quant.int8_matmul(x.view(2, 24, 256), q, scale)
    assert y.shape == (2, 24, 96) and torch.equal(y.view(48, 96), quant.int8_matmul(x, q, scale))


def test_int8_matmul_wrong_inputs_raise(gen):
    from torchx_tpu_torch.ops import quant

    x, q, scale = _int8_inputs(gen, 8, 256, 96, torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA device"):
        quant.int8_matmul(x, q.cpu(), scale)  # a CPU weight
    with pytest.raises(ValueError, match="contiguous"):
        quant.int8_matmul(_randn(gen, 8, 512, dtype=torch.bfloat16)[:, ::2], q, scale)
    with pytest.raises(ValueError, match="scale"):
        quant.int8_matmul(x, q, scale[..., :95].contiguous())
    with pytest.raises(ValueError, match="contract"):
        quant.int8_matmul(x[:, :128].contiguous(), q, scale)
    with pytest.raises(ValueError, match="multiple"):
        x2, q2, s2 = _int8_inputs(gen, 8, 256, 100, torch.bfloat16)
        quant.int8_matmul(x2, q2, s2)
    with pytest.raises(ValueError, match="output"):
        quant.int8_matmul(x, q, scale, out_dtype=torch.float16)


def test_int_mm_shape_rules_raise(gen):
    """torch._int_mm on the card takes m > 16 and k, n multiples of 8: the
    int8 training dot raises outside them and never falls back to bf16."""
    from torchx_tpu_torch.ops import quant

    a = torch.ones((16, 64), dtype=torch.int8, device="cuda")
    b = torch.ones((64, 32), dtype=torch.int8, device="cuda")
    for lhs, rhs in ((a, b), (a[:, :60].contiguous(), b[:60]), (a, b[:, :12])):
        with pytest.raises(ValueError, match="_int_mm"):
            quant._int_mm(lhs, rhs)
    with pytest.raises(ValueError, match="_int_mm"):
        quant.int8_dot(_randn(gen, 8, 64, dtype=torch.bfloat16),
                       _randn(gen, 64, 32, dtype=torch.bfloat16))
    lhs = torch.randint(-127, 128, (17, 64), dtype=torch.int8, device="cuda")
    assert torch.equal(quant._int_mm(lhs, b).cpu(), lhs.cpu().int() @ b.cpu().int())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_dot_on_card_equals_cpu(gen, dtype):
    """The int8 training dot's forward and both gradients on the card equal
    the CPU's bitwise: the int32 sums are exact and each elementwise step
    rounds once in the operands' dtype on both devices."""
    from torchx_tpu_torch.ops import quant

    x, w = _randn(gen, 64, 128, dtype=dtype), (_randn(gen, 128, 96) * 0.05).to(dtype)
    g = (_randn(gen, 64, 96) * 1e-3).to(dtype)
    out = {}
    for dev in ("cuda", "cpu"):
        xd = x.detach().to(dev).requires_grad_(True)
        wd = w.detach().to(dev).requires_grad_(True)
        y = quant.maybe_matmul(xd, wd, int8_training=True)
        y.backward(g.to(dev))
        out[dev] = [t.detach().cpu() for t in (y, xd.grad, wd.grad)]
    for a, b in zip(out["cuda"], out["cpu"]):
        assert torch.equal(a, b)


def test_int8_engine_on_card_matches_dense(gen):
    """The tiny f32 tree quantized, served on the card: every projection
    runs the f32 int8 kernel (TF32 mma.sync), and the engine's greedy
    tokens equal the dense generate's on the same tree."""
    from torchx_tpu_torch.ops import quant

    cfg, params = _tiny_serving("cuda")
    qp = quant.quantize_params(params)
    _build.reset_launches()
    eng = ServeEngine(qp, cfg, max_slots=4, block_size=8, max_prefill_batch=2).start()
    try:
        prompts = [[1, 2, 3], [7, 8], [4, 5, 6, 7, 8, 9, 10], [11]]
        reqs = [eng.generate(p, 6, timeout=120) for p in prompts]
    finally:
        eng.stop()
    assert _build.launch_counts()["int8_matmul_tf32"] > 0
    for p, r in zip(prompts, reqs):
        dense = tgen.generate(qp, torch.tensor([p], device="cuda"), cfg, 6)
        assert r.tokens == dense[0].tolist()
