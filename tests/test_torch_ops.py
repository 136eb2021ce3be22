"""Parity of the PyTorch port's ops with the JAX package's, on the CPU.

The same inputs, made with numpy from a seed, go through the JAX function
and its port. Where the JAX function reaches a Pallas kernel it runs in
interpret mode, as tests/test_fused.py runs it; on CPU tensors the port's
kernel wrappers run their plain PyTorch versions. Tolerances are those of
tests/test_fused.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchx_tpu.ops import fused as jfused
from torchx_tpu.ops import norms as jnorms
from torchx_tpu.ops import rope as jrope
from torchx_tpu.ops.attention import xla_attention as j_xla_attention
from torchx_tpu_torch import _build
from torchx_tpu_torch.ops import fused, norms, rope
from torchx_tpu_torch.ops.attention import attention, xla_attention
from torch_threads import xdist_torch_threads  # noqa: F401


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a, grad=False):
    return torch.tensor(a, requires_grad=grad)


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=tol)


def _packed_ids(rng, b, s, max_len):
    """int32 [b, s] ids of packed documents, lengths drawn in [1, max_len]
    (boundaries fall inside the 64/128-row tiles); the last row is one
    document."""
    seg = np.zeros((b, s), np.int32)
    for row in range(b - 1):
        pos, doc = 0, 0
        while pos < s:
            n = int(rng.integers(1, max_len + 1))
            seg[row, pos:pos + n] = doc
            pos, doc = pos + n, doc + 1
    return seg


class TestRope:
    def test_frequencies(self):
        for start in (0, 96):
            cj, sj = jrope.rope_frequencies(64, 128, 500000.0, start=start)
            ct, st = rope.rope_frequencies(64, 128, 500000.0, start=start)
            _close(cj, ct, 1e-6)
            _close(sj, st, 1e-6)

    def test_apply(self):
        rng = np.random.default_rng(0)
        x = _randn(rng, 2, 16, 4, 32)
        cos, sin = jrope.rope_frequencies(32, 16)
        cos, sin = np.asarray(cos), np.asarray(sin)
        out_j = jrope.apply_rope(jnp.asarray(x), cos, sin)
        out_t = rope.apply_rope(_t(x), _t(cos), _t(sin))
        assert out_t.dtype == torch.float32
        _close(out_j, out_t, 1e-6)


class TestXlaAttention:
    @pytest.mark.parametrize("causal", [True, False])
    @pytest.mark.parametrize("n_rep", [1, 2])
    def test_matches_jax(self, causal, n_rep):
        rng = np.random.default_rng(1)
        q = _randn(rng, 2, 32, 2 * n_rep, 16)
        k, v = _randn(rng, 2, 32, 2, 16), _randn(rng, 2, 32, 2, 16)
        out_j = j_xla_attention(q, k, v, causal=causal)
        out_t = xla_attention(_t(q), _t(k), _t(v), causal=causal)
        _close(out_j, out_t, 1e-5)

    def test_segment_ids(self):
        rng = np.random.default_rng(2)
        q, k, v = (_randn(rng, 2, 16, 2, 16) for _ in range(3))
        seg = np.repeat(np.array([[0, 1], [0, 0]]), 8, axis=1).astype(np.int32)
        out_j = j_xla_attention(q, k, v, segment_ids=jnp.asarray(seg))
        out_t = attention(_t(q), _t(k), _t(v), segment_ids=torch.tensor(seg))
        _close(out_j, out_t, 1e-5)

    def test_auto_takes_plain_path_on_cpu(self):
        rng = np.random.default_rng(3)
        q, k, v = (_t(_randn(rng, 1, 512, 2, 64)) for _ in range(3))
        _build.reset_launches()
        torch.testing.assert_close(
            attention(q, k, v, impl="auto"), xla_attention(q, k, v), rtol=0, atol=0
        )
        assert sum(_build.launch_counts().values()) == 0

    def test_flash_rejects_segment_ids(self):
        """impl='flash' off the CPU refuses ids its kernels cannot take
        (meta tensors: no data, no card), before anything launches. Good
        ids on meta tensors trace the flash operator's fake implementation
        (shapes only: the fit probe's path), which launches nothing; the
        wrappers themselves still refuse meta tensors
        (test_wrappers_raise_off_cpu_without_kernel)."""
        q = torch.zeros(1, 128, 2, 64, device="meta")
        for bad in (torch.zeros(1, 128, device="meta"),  # float
                    torch.zeros(1, 128, dtype=torch.int64, device="meta"),
                    torch.zeros(2, 128, dtype=torch.int32, device="meta")):
            with pytest.raises(ValueError, match="segment_ids must be int32"):
                attention(q, q, q, segment_ids=bad, impl="flash")
        seg = torch.zeros(1, 128, dtype=torch.int32, device="meta")
        _build.reset_launches()
        out = attention(q, q, q, segment_ids=seg, impl="flash")
        assert out.device.type == "meta" and out.shape == q.shape
        assert sum(_build.launch_counts().values()) == 0

    def test_flash_takes_segment_ids(self):
        """On CPU tensors impl='flash' with segment ids runs the kernels'
        plain versions and equals the plain attention."""
        rng = np.random.default_rng(7)
        q = _t(_randn(rng, 2, 128, 4, 64), True)
        k, v = _t(_randn(rng, 2, 128, 2, 64), True), _t(_randn(rng, 2, 128, 2, 64), True)
        seg = torch.tensor(_packed_ids(rng, 2, 128, 50))
        _build.reset_launches()
        out = attention(q, k, v, segment_ids=seg, impl="flash")
        assert out.grad_fn is not None and "flash_fwd" in type(out.grad_fn).__name__
        assert sum(_build.launch_counts().values()) == 0
        _close(out.detach(), xla_attention(q, k, v, segment_ids=seg).detach(), 2e-5)


class TestRmsNorm:
    @pytest.mark.parametrize("fused_mode", ["cuda", "never"])
    def test_forward_and_grads(self, fused_mode):
        rng = np.random.default_rng(4)
        x, dy = _randn(rng, 2, 16, 128), _randn(rng, 2, 16, 128)
        w = (1 + 0.1 * _randn(rng, 128)).astype(np.float32)

        def loss_j(x, w):
            return jnp.sum(jnorms.rms_norm(x, w, 1e-5, fused="interpret") * dy)

        y_j = jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5, fused="interpret")
        g_j = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
        xt, wt = _t(x, True), _t(w, True)
        y_t = norms.rms_norm(xt, wt, 1e-5, fused=fused_mode)
        (y_t * _t(dy)).sum().backward()
        _close(y_j, y_t.detach(), 1e-6)
        _close(g_j[0], xt.grad, 2e-5)
        _close(g_j[1], wt.grad, 2e-5)

    def test_auto_reads_env(self, monkeypatch):
        x, w = torch.randn(4, 128), torch.ones(128)
        monkeypatch.delenv(norms.ENV_TPX_FUSED_NORM, raising=False)
        assert norms.rms_norm(x, w).grad_fn is None  # plain: no Function node
        monkeypatch.setenv(norms.ENV_TPX_FUSED_NORM, "bogus")
        with pytest.raises(ValueError, match="fused"):
            norms.rms_norm(x, w)

    def test_bwd_kernel_plain_version_matches_pallas(self):
        """The kernel's plain version against the Pallas kernel itself."""
        rng = np.random.default_rng(5)
        x, dy = _randn(rng, 64, 256), _randn(rng, 64, 256)
        w = (1 + 0.1 * _randn(rng, 256)).astype(np.float32)
        dx_j, dw_j = jnorms._bwd_pallas(x, dy, jnp.asarray(w), 1e-5, interpret=True)
        dx_t, dw_t = norms._bwd(_t(x), _t(dy), _t(w), 1e-5)
        assert dw_t.dtype == torch.float32
        _close(dx_j, dx_t, 2e-5)
        _close(dw_j, dw_t, 2e-5)


class TestRmsNormResidual:
    @pytest.mark.parametrize("shape", [(2, 16, 128), (4, 8, 256)])
    def test_forward_and_grads(self, shape):
        rng = np.random.default_rng(6)
        x, r, dy = _randn(rng, *shape), _randn(rng, *shape), _randn(rng, *shape)
        w = (1 + 0.1 * _randn(rng, shape[-1])).astype(np.float32)

        def loss_j(x, r, w):
            y, s = jfused.rms_norm_residual(x, r, w, kernels="interpret")
            return jnp.sum(y * dy) + jnp.sum(s)

        y_j, s_j = jfused.rms_norm_residual(x, r, w, kernels="interpret")
        g_j = jax.grad(loss_j, argnums=(0, 1, 2))(x, r, w)
        xt, rt, wt = _t(x, True), _t(r, True), _t(w, True)
        y_t, s_t = fused.rms_norm_residual(xt, rt, wt, kernels="cuda")
        ((y_t * _t(dy)).sum() + s_t.sum()).backward()
        assert np.array_equal(np.asarray(s_j), s_t.detach().numpy())
        _close(y_j, y_t.detach(), 1e-6)
        for a, b in zip(g_j, (xt.grad, rt.grad, wt.grad)):
            _close(a, b, 2e-5)

    def test_untileable_takes_plain_path(self):
        x, r, w = torch.randn(2, 8, 64), torch.randn(2, 8, 64), torch.ones(64)
        y, s = fused.rms_norm_residual(x, r, w, kernels="cuda")
        assert y.grad_fn is None and torch.equal(s, x + r)


class TestFlashAttention:
    @pytest.mark.parametrize("causal", [True, False])
    @pytest.mark.parametrize("n_rep", [1, 2, 4])
    @pytest.mark.parametrize("seq", [128, 256])
    def test_forward_and_grads(self, seq, n_rep, causal):
        rng = np.random.default_rng(seq + n_rep + causal)
        b, kvh, d = 2, 1, 64
        q = _randn(rng, b, seq, kvh * n_rep, d)
        k, v = _randn(rng, b, seq, kvh, d), _randn(rng, b, seq, kvh, d)
        dy = _randn(rng, *q.shape)
        flash_j = functools.partial(
            jfused.flash_attention, causal=causal, kernels="interpret",
            block_q=128, block_kv=128,
        )
        out_j, vjp = jax.vjp(flash_j, q, k, v)
        g_j = vjp(jnp.asarray(dy))
        qt, kt, vt = _t(q, True), _t(k, True), _t(v, True)
        out_t = fused.flash_attention(qt, kt, vt, causal=causal, kernels="cuda")
        out_t.backward(_t(dy))
        _close(out_j, out_t.detach(), 2e-5)
        for a, b_ in zip(g_j, (qt.grad, kt.grad, vt.grad)):
            assert a.shape == tuple(b_.shape)
            _close(a, b_, 5e-4)

    def test_gating_returns_none(self):
        q = torch.zeros(1, 128, 2, 16)  # head_dim 16: not tiled
        assert fused.flash_attention(q, q, q) is None
        q = torch.zeros(1, 100, 2, 64)  # ragged sequence
        assert fused.flash_attention(q, q, q) is None
        q = torch.zeros(1, 128, 2, 64)
        assert fused.flash_attention(q, q, q, kernels="reference") is None
        assert fused.flash_attention(q, q, q) is not None

    def test_wrappers_raise_off_cpu_without_kernel(self):
        """A tensor that is neither on the CPU nor on a CUDA device gets no
        plain fallback."""
        q = torch.zeros(1, 128, 2, 64, device="meta")
        with pytest.raises(ValueError, match="no kernel"):
            fused._flash_fwd(q, q, q, True)
        x = torch.zeros(8, 128, device="meta")
        with pytest.raises(ValueError, match="no kernel"):
            fused._norm_res_fwd(x, x, torch.zeros(128, device="meta"), 1e-5)
        with pytest.raises(ValueError, match="no kernel"):
            norms._bwd(x, x, torch.zeros(128, device="meta"), 1e-5)

    def test_plain_versions_count_no_launch(self):
        _build.reset_launches()
        q = torch.randn(1, 128, 2, 64, requires_grad=True)
        fused.flash_attention(q, q, q).sum().backward()
        assert _build.launch_counts() == dict.fromkeys(_build.KERNELS, 0)


class TestFlashSegments:
    """The masked flash path (plain versions on CPU tensors) against the
    JAX package's plain attention with segment ids, and against its
    splash kernel run in the Pallas interpreter."""

    @pytest.mark.parametrize("causal", [True, False])
    @pytest.mark.parametrize("n_rep", [1, 2])
    def test_matches_jax_xla_attention(self, causal, n_rep):
        rng = np.random.default_rng(20 + n_rep + causal)
        b, s, kvh, d = 3, 256, 2, 64
        q = _randn(rng, b, s, kvh * n_rep, d)
        k, v = _randn(rng, b, s, kvh, d), _randn(rng, b, s, kvh, d)
        dy = _randn(rng, *q.shape)
        seg = _packed_ids(rng, b, s, 90)
        out_j, vjp = jax.vjp(
            lambda q, k, v: j_xla_attention(q, k, v, causal=causal, segment_ids=seg), q, k, v
        )
        g_j = vjp(jnp.asarray(dy))
        qt, kt, vt = _t(q, True), _t(k, True), _t(v, True)
        out_t = fused.flash_attention(
            qt, kt, vt, causal=causal, kernels="cuda", segment_ids=torch.tensor(seg)
        )
        out_t.backward(_t(dy))
        _close(out_j, out_t.detach(), 2e-5)
        for a, b_ in zip(g_j, (qt.grad, kt.grad, vt.grad)):
            _close(a, b_, 5e-4)

    def test_cross_document_pairs_get_no_gradient(self):
        """A key's gradient depends only on the queries of its own
        document: a loss on document 0's rows leaves every later key's dk
        and dv exactly 0."""
        rng = np.random.default_rng(24)
        q, k, v = (_t(_randn(rng, 1, 128, 2, 64), True) for _ in range(3))
        seg = torch.tensor(np.repeat(np.arange(2, dtype=np.int32), [77, 51])[None])
        out = fused.flash_attention(q, k, v, causal=False, segment_ids=seg)
        out[:, :77].sum().backward()
        assert torch.count_nonzero(k.grad[:, 77:]) == 0
        assert torch.count_nonzero(v.grad[:, 77:]) == 0
        assert torch.count_nonzero(q.grad[:, 77:]) == 0
        assert torch.count_nonzero(k.grad[:, :77]) > 0

    def test_matches_jax_splash_interpret(self):
        from torchx_tpu.ops.attention import splash_attention

        rng = np.random.default_rng(25)
        b, s, h, kvh, d = 2, 256, 4, 2, 64
        q = _randn(rng, b, s, h, d)
        k, v = _randn(rng, b, s, kvh, d), _randn(rng, b, s, kvh, d)
        seg = _packed_ids(rng, b, s, 90)
        out_j = splash_attention(
            q, k, v, causal=True, segment_ids=jnp.asarray(seg), interpret=True
        )
        out_t = attention(_t(q), _t(k), _t(v), segment_ids=torch.tensor(seg), impl="flash")
        _close(out_j, out_t, 5e-3)


class TestResolveKernels:
    def test_mapping(self):
        assert fused.resolve_kernels("pallas") == "cuda"
        assert fused.resolve_kernels("cuda") == "cuda"
        assert fused.resolve_kernels("reference") == "reference"
        with pytest.raises(ValueError):
            fused.resolve_kernels("interpret")
