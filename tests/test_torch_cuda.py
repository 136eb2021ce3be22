"""The port's hand-written kernels on the card, against their plain PyTorch
versions. Marked ``cuda``: they skip where no CUDA device is present and
run on the H100 with (the repo's conftest imports JAX, which the card's
machine does not have, hence ``--noconftest``)::

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

f32 comparisons run with TF32 off (``torch.backends.cuda.matmul.allow_tf32
= False``), at the CPU parity tests' tolerances; the bf16 tensor-core
(wgmma) flash kernels at chip_smoke.py's 1e-3, relative to the largest
reference value.
"""

import dataclasses

import numpy as np
import pytest
import torch

from torchx_tpu_torch import _build
from torchx_tpu_torch.examples import train_llama
from torchx_tpu_torch.examples.data import TokenDataset
from torchx_tpu_torch.models import llama
from torchx_tpu_torch.ops import fused, norms
from torchx_tpu_torch.parallel.prefetch import device_prefetch

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
    assert counts["flash_fwd_simt"] == counts["flash_dq_simt"] == counts["flash_dkv_simt"] == 0
    assert out.dtype == torch.bfloat16 and k.grad.shape == k.shape
    assert all(torch.isfinite(t.grad).all() for t in (q, k, v))


def test_wrong_inputs_raise(gen):
    q = _randn(gen, 1, 256, 2, 64)
    with pytest.raises(ValueError, match="dtype"):
        fused._flash_fwd(q, q.half(), q.half(), True)
    with pytest.raises(ValueError, match="contiguous"):
        fused._flash_fwd(q, q.transpose(1, 2).contiguous().transpose(1, 2), q, True)


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
    assert _build.launch_counts()["flash_dkv_simt"] == base.n_layers  # f32: simt
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
