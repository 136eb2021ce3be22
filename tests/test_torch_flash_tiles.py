"""The flash kernels' tile as a launch setting, on the CPU.

``attn_block_q`` / ``attn_block_kv`` go from ``LlamaConfig`` through
``attention`` and ``flash_attention`` into the three wgmma kernels, each
launching at the tile ``ops.fused.fit_tile`` gives: the JAX package's
``_fit_block`` on the compiled tiles (``WGMMA_TILES``, the instances of
``csrc/flash_*_wgmma.cuh``). The kernels cannot run here, so each one's
loops are emulated tile by tile in f32 PyTorch, with the kernels' own
index arithmetic (the kv tiles a forward or dq CTA streams, the q tile a
dk/dv CTA starts at, the tiles a warpgroup skips or masks) and
tests/test_torch_flash_variants.py's arithmetic (exact products summed in
f32, base-2 softmax, P and dS split into bf16 hi + lo): at every compiled
tile, masked and not, causal and full, within 1e-5 of the plain versions.
"""

import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_flash_variants import _parts, _rel
from torchx_tpu.models import llama as jllama
from torchx_tpu.ops.attention import _fit_block
from torchx_tpu_torch import convert
from torchx_tpu_torch.models import llama as tllama
from torchx_tpu_torch.ops import fused
from torchx_tpu_torch.ops.attention import attention
from torch_threads import xdist_torch_threads  # noqa: F401

LOG2E = math.log2(math.e)
CSRC = Path(fused.__file__).resolve().parent.parent / "csrc"
#: every compiled tile: (kernel, head_dim, block_q, block_kv)
TILES = [(kernel, d, bq, bk) for (kernel, d), (q_tiles, kv_tiles) in fused.WGMMA_TILES.items()
         for bq in q_tiles for bk in kv_tiles]
#: b, s, h, kvh
SHAPE = (2, 256, 4, 2)
#: packed documents whose boundaries fall inside every tile; in the second
#: row the first document ends at 150, so its later rows see whole kv tiles
#: of another segment before their own (the forward's running-max guard)
SEGMENTS = torch.tensor([[0] * 37 + [1] * 100 + [2] * 119, [0] * 150 + [1] * 106],
                        dtype=torch.int32)


def _inputs(d):
    b, s, h, kvh = SHAPE
    rng = np.random.default_rng(d)

    def rnd(*shape):  # noqa: ANN001, ANN202
        return torch.tensor(rng.standard_normal(shape).astype(np.float32)).bfloat16()

    return rnd(b, s, h, d), rnd(b, s, kvh, d), rnd(b, s, kvh, d), rnd(b, s, h, d)


def _heads(x, n_rep):
    """[b, s, kvh, d] -> f32 [b, h, s, d], each KV head read n_rep times."""
    return x.float().repeat_interleave(n_rep, dim=2).transpose(1, 2)


def _same(seg, rows, cols):
    """[b, 1, len(rows), len(cols)]: where a query and a key share a segment."""
    return (seg[:, rows, None] == seg[:, None, cols])[:, None]


def _emulate_fwd(q, k, v, causal, bq, bk, seg=None):
    """flash_fwd_wgmma_kernel's loops: per CTA of bq rows the kv tiles up to
    its last row's diagonal, per warpgroup of 64 rows the tiles it skips
    (after its rows) and masks (crossing its diagonal), the online softmax."""
    b, s, h, d = q.shape
    n_rep = h // k.shape[2]
    qf, kf, vf = q.float().transpose(1, 2), _heads(k, n_rep), _heads(v, n_rep)
    scale_log2 = LOG2E / math.sqrt(d)
    o = torch.zeros(b, h, s, d)
    lse = torch.zeros(b, h, s)
    for q0 in range(0, s, bq):
        nk = (q0 + bq + bk - 1) // bk if causal else s // bk
        for r0 in range(q0, q0 + bq, 64):
            rows = torch.arange(r0, r0 + 64)
            m = torch.full((b, h, 64), -math.inf)
            l = torch.zeros(b, h, 64)  # noqa: E741
            acc = torch.zeros(b, h, 64, d)
            for kt in range(nk):
                k0 = kt * bk
                if causal and k0 > r0 + 63:
                    continue
                cols = torch.arange(k0, k0 + bk)
                x = (qf[:, :, rows] @ kf[:, :, cols].transpose(-1, -2)) * scale_log2
                if causal and k0 + bk - 1 > r0:
                    x = x.masked_fill(cols[None, :] > rows[:, None], -math.inf)
                ref_guard = seg is not None
                if seg is not None:
                    x = x.masked_fill(~_same(seg, rows, cols), -math.inf)
                m_new = torch.maximum(m, x.amax(-1))
                ref = torch.where(m_new == -math.inf, 0.0, m_new) if ref_guard else m_new
                alpha = torch.exp2(m - ref)
                p = torch.exp2(x - ref[..., None])
                l = l * alpha + p.sum(-1)  # noqa: E741
                acc = acc * alpha[..., None]
                for part in _parts(p, "split"):
                    acc = acc + part @ vf[:, :, cols]
                m = m_new
            o[:, :, rows] = acc / l[..., None]
            lse[:, :, rows] = (m + torch.log2(l)) * math.log(2)
    return o.transpose(1, 2), lse


def _emulate_dq(q, k, v, do, lse, delta, causal, bq, bk, seg=None):
    """flash_dq_wgmma_kernel's loops: the forward's kv tiles per CTA and
    warpgroup, dQ summed over them from dS split into hi + lo."""
    b, s, h, d = q.shape
    n_rep = h // k.shape[2]
    qf, dof = q.float().transpose(1, 2), do.float().transpose(1, 2)
    kf, vf = _heads(k, n_rep), _heads(v, n_rep)
    dq = torch.zeros(b, h, s, d)
    for q0 in range(0, s, bq):
        nk = (q0 + bq + bk - 1) // bk if causal else s // bk
        for r0 in range(q0, q0 + bq, 64):
            rows = torch.arange(r0, r0 + 64)
            acc = torch.zeros(b, h, 64, d)
            for kt in range(nk):
                k0 = kt * bk
                if causal and k0 > r0 + 63:
                    continue
                cols = torch.arange(k0, k0 + bk)
                p = torch.exp2((qf[:, :, rows] @ kf[:, :, cols].transpose(-1, -2))
                               * (LOG2E / math.sqrt(d)) - (lse[:, :, rows] * LOG2E)[..., None])
                if causal and k0 + bk - 1 > r0:
                    p = p.masked_fill(cols[None, :] > rows[:, None], 0.0)
                if seg is not None:
                    p = p.masked_fill(~_same(seg, rows, cols), 0.0)
                ds = p * (dof[:, :, rows] @ vf[:, :, cols].transpose(-1, -2)
                          - delta[:, :, rows, None])
                for part in _parts(ds, "split"):
                    acc = acc + part @ kf[:, :, cols]
            dq[:, :, rows] = acc / math.sqrt(d)
    return dq.transpose(1, 2)


def _emulate_dkv(q, k, v, do, lse, delta, causal, bq, bkv, seg=None):
    """flash_dkv_wgmma_kernel's loops: per CTA of bkv kv rows the q tiles
    from the one holding its first key, over the KV head's query heads in
    order, per warpgroup of 64 kv rows the tiles it skips (before its keys)
    and masks (crossing its diagonal); dK and dV summed from P^T and dS^T
    split into hi + lo."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    n_rep = h // kvh
    qf, dof = q.float().transpose(1, 2), do.float().transpose(1, 2)
    kf, vf = k.float().transpose(1, 2), v.float().transpose(1, 2)
    dk, dv = torch.zeros(b, kvh, s, d), torch.zeros(b, kvh, s, d)
    for kt in range(s // bkv):
        q_begin = kt * bkv // bq if causal else 0
        for kv0 in range(kt * bkv, (kt + 1) * bkv, 64):
            keys = torch.arange(kv0, kv0 + 64)
            dk_acc, dv_acc = torch.zeros(b, kvh, 64, d), torch.zeros(b, kvh, 64, d)
            for rep in range(n_rep):
                heads = torch.arange(kvh) * n_rep + rep
                for qt in range(q_begin, s // bq):
                    q0 = qt * bq
                    if causal and not q0 + bq > kv0:
                        continue
                    qs = torch.arange(q0, q0 + bq)
                    qh, doh = qf[:, heads][:, :, qs], dof[:, heads][:, :, qs]
                    p = torch.exp2((kf[:, :, keys] @ qh.transpose(-1, -2))
                                   * (LOG2E / math.sqrt(d))
                                   - (lse[:, heads][:, :, qs] * LOG2E)[:, :, None, :])
                    if causal and q0 < kv0 + 64:
                        p = p.masked_fill(qs[None, :] < keys[:, None], 0.0)
                    if seg is not None:
                        p = p.masked_fill(~_same(seg, keys, qs), 0.0)
                    ds = p * (vf[:, :, keys] @ doh.transpose(-1, -2)
                              - delta[:, heads][:, :, qs][:, :, None, :])
                    for part in _parts(p, "split"):
                        dv_acc = dv_acc + part @ doh
                    for part in _parts(ds, "split"):
                        dk_acc = dk_acc + part @ qh
            dk[:, :, keys], dv[:, :, keys] = dk_acc / math.sqrt(d), dv_acc
    return dk.transpose(1, 2), dv.transpose(1, 2)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kernel,d,bq,bk", TILES)
def test_every_tile_meets_plain(kernel, d, bq, bk, causal, masked):
    """Each compiled tile's loops, with and without segment ids, within
    1e-5 relative of the (masked) plain versions."""
    q, k, v, do = _inputs(d)
    seg = SEGMENTS if masked else None
    o_p, lse_p = fused._flash_fwd_plain(q, k, v, causal, seg)
    if kernel == "flash_fwd":
        o_e, lse_e = _emulate_fwd(q, k, v, causal, bq, bk, seg)
        errs = [_rel(o_e, o_p), _rel(lse_e, lse_p)]
    else:
        args = (q, k, v, do, lse_p, fused._flash_delta(do, o_p), causal)
        if kernel == "flash_dq":
            errs = [_rel(_emulate_dq(*args, bq, bk, seg), fused._flash_dq_plain(*args, seg))]
        else:
            got = _emulate_dkv(*args, bq, bk, seg)
            errs = [_rel(a, b) for a, b in zip(got, fused._flash_dkv_plain(*args, seg))]
    assert max(errs) <= 1e-5, errs


def _cuh_tiles(kernel):
    """{(head_dim, block_q, block_kv)} of a kernel's TPX_FLASH_*_TILES lists."""
    text = (CSRC / f"{kernel}_wgmma.cuh").read_text()
    tag = kernel.removeprefix("flash_").upper()
    lists = re.findall(rf"#define TPX_FLASH_{tag}_TILES_\w+\(X\)(.*)", text)
    assert lists, kernel
    return {tuple(map(int, t)) for line in lists
            for t in re.findall(r"X\((\d+), (\d+), (\d+)\)", line)}


@pytest.mark.parametrize("kernel", ["flash_fwd", "flash_dq", "flash_dkv"])
def test_the_tables_name_the_compiled_instances(kernel):
    """WGMMA_TILES is the product the .cuh instantiates, tile for tile, and
    every default tile is compiled."""
    want = {(d, bq, bk) for (kern, d), (qs, kvs) in fused.WGMMA_TILES.items() if kern == kernel
            for bq in qs for bk in kvs}
    assert _cuh_tiles(kernel) == want
    for d in fused.WGMMA_HEAD_DIMS:
        assert (d, *fused.DEFAULT_TILES[(kernel, d)]) in want


REQUESTS = (1, 32, 50, 64, 100, 128, 160, 192, 256, 384, 512, 1024, 4096)
SEQS = (128, 256, 384, 512, 768, 1152, 2048, 2304)


@pytest.mark.parametrize("kernel,d", list(fused.WGMMA_TILES))
def test_fit_agrees_with_the_jax_rule(kernel, d):
    """Over a grid of requests and sequences each axis takes the largest
    compiled tile at most the request (clamped up to the smallest) that
    divides the sequence; at or above JAX's 128-lane floor that is JAX's
    ``_fit_block`` wherever JAX's result is a compiled tile, else the
    largest compiled tile below JAX's result."""
    for axis, tiles in enumerate(fused.WGMMA_TILES[(kernel, d)]):
        for s in SEQS:
            for r in REQUESTS:
                req = (r, 0) if axis == 0 else (0, r)
                got = fused.fit_tile(kernel, "wgmma", d, s, *req)[axis]
                assert got == max(t for t in tiles if t <= max(r, tiles[0]) and s % t == 0)
                if r >= 128:
                    jax_blk = _fit_block(r, s)
                    want = jax_blk if jax_blk in tiles else max(
                        t for t in tiles if t < jax_blk and s % t == 0)
                    assert got == want, (kernel, d, axis, s, r)


def test_zero_takes_the_default_table_and_mma_its_one_tile():
    """0 takes DEFAULT_TILES for wgmma; each mma instance, dq's too, has
    one tile that every request fits to; no simt kernel is left."""
    for (kernel, d), tile in fused.DEFAULT_TILES.items():
        assert fused.fit_tile(kernel, "wgmma", d, 2048) == tile
    assert {kernel for kernel, _, _ in fused.MMA_TILES} == set(fused.FLASH_KERNELS)
    for (kernel, dtype, d), tile in fused.MMA_TILES.items():
        assert fused.fit_tile(kernel, "mma", d, 2048, 128, 16, dtype=dtype) == tile
        assert fused.fit_tile(kernel, "mma", d, 2048, dtype=dtype) == tile
    for kernel in fused.FLASH_KERNELS:
        with pytest.raises(ValueError, match="variant must be one of"):
            fused.fit_tile(kernel, "simt", 256, 2048)
    with pytest.raises(ValueError, match="no mma kernel for flash_dq"):
        fused.fit_tile("flash_dq", "mma", 64, 2048, dtype=torch.bfloat16)


def test_negative_tiles_raise():
    """A negative request raises at every entry: the config, attention,
    flash_attention, the fit rule and the kernel wrappers."""
    with pytest.raises(ValueError, match="attn_block_q and attn_block_kv must be >= 0"):
        tllama.llama_tiny(attn_block_q=-64)
    with pytest.raises(ValueError, match="attn_block_q and attn_block_kv must be >= 0"):
        tllama.llama3_1b(attn_block_kv=-1)
    q = torch.zeros(1, 128, 2, 64)
    with pytest.raises(ValueError, match="block_kv must be an int >= 0"):
        fused.flash_attention(q, q, q, block_kv=-128)
    with pytest.raises(ValueError, match="block_q must be an int >= 0"):
        attention(q, q, q, impl="flash", block_q=-1)
    with pytest.raises(ValueError, match="block_q must be an int >= 0"):
        fused.fit_tile("flash_dq", "wgmma", 64, 128, -64, 0)
    with pytest.raises(ValueError, match="block_kv must be an int >= 0"):
        fused._flash_fwd(q, q, q, True, tile=(0, -64))


def _cfgs(**fields):
    shape = dict(dim=128, n_heads=2, n_kv_heads=1, ffn_dim=256, **fields)
    return (jllama.llama_tiny(kernels="interpret", **shape),
            tllama.llama_tiny(kernels="cuda", **shape))


def _sorted_leaves(params):
    """The leaves in the JAX pytree's order (sorted keys)."""
    out = []
    for key in sorted(params):
        val = params[key]
        out.extend(_sorted_leaves(val) if isinstance(val, dict) else [val])
    return out


def _step(cfg_t, p_host, tok):
    """Loss and gradients of the port's step on fresh leaves."""
    p_t = convert.params_from_jax(p_host, cfg_t)
    loss = tllama.loss_fn(p_t, {"tokens": torch.from_numpy(tok)}, cfg_t)
    loss.backward()
    return loss.detach(), [p.grad for p in _sorted_leaves(p_t)]


@pytest.mark.parametrize("tile", [(64, 64), (128, 32), (192, 0)])
def test_a_step_with_tiles_set(tile):
    """llama_tiny (head_dim 64, seq 128, kernels "cuda") with attn_block_q /
    attn_block_kv set: bitwise the step with 0 on the CPU (the plain
    versions have no tile), and within the model tests' parity tolerance
    (1e-5 on the loss, 5e-4 / 5e-5 on the gradients) of the JAX step given
    the same fields, its Pallas kernels in interpret mode at their fit."""
    fields = dict(attn_block_q=tile[0], attn_block_kv=tile[1])
    cfg_j, cfg_t = _cfgs(**fields)
    p_j = jllama.init_params(cfg_j, jax.random.PRNGKey(52))
    p_host = jax.tree.map(np.asarray, p_j)
    tok = np.random.default_rng(53).integers(0, 512, (2, 129)).astype(np.int32)
    loss, grads = _step(cfg_t, p_host, tok)
    loss0, grads0 = _step(_cfgs()[1], p_host, tok)
    assert torch.equal(loss, loss0)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads0))
    l_j, g_j = jax.value_and_grad(jllama.loss_fn)(p_j, {"tokens": jnp.asarray(tok)}, cfg_j)
    np.testing.assert_allclose(loss.item(), float(l_j), rtol=1e-5, atol=1e-5)
    for got, want in zip(grads, jax.tree.leaves(g_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-4, atol=5e-5)
