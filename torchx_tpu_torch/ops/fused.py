"""Fused training kernels: flash attention and residual-add + RMSNorm.

Port of :mod:`torchx_tpu.ops.fused`, the ``--kernels cuda`` hot path:

* :func:`flash_attention` — an autograd Function over three CUDA C++
  kernels (``csrc/flash_attn.cu``): the forward (``lse`` and O saved in
  f32), and the standard two-kernel backward, ``delta = rowsum(dO * O)``
  computed outside the kernels, one kernel accumulating ``dq`` over kv
  tiles and one accumulating ``dk``/``dv`` over q tiles and over the query
  heads that share a KV head (native GQA: KV is never repeated).
* :func:`rms_norm_residual` — ``s = x + residual`` in the input dtype, then
  ``y = rms_norm(s) * w`` in f32, one Triton pass returning ``(y, s)``. Its
  backward runs the RMSNorm dx+dw kernel of :mod:`.norms` on ``s`` and
  sends the ``s`` cotangent through both inputs.

The norm-residual kernel replaces ``_norm_res_kernel`` (launched by
``_norm_res_pallas``) of ``torchx_tpu/ops/fused.py``. On an H100 it is
bound by bytes: it reads x, residual and w and writes y and s, a few
operations per byte. It reads each row once into registers, adds in the
input dtype (bitwise the unfused add), reduces in f32 with IEEE
``1/sqrt`` (not ``rsqrt``, as the JAX forward does for its bitwise parity)
and writes both outputs in the same pass.

Selection (the ``--kernels`` flag): ``"cuda"`` routes through the kernels,
``"reference"`` never enters this module. On a CUDA tensor each wrapper
launches its kernel or raises; only a tensor on the CPU takes the kernel's
plain PyTorch version, which the CPU parity tests and ``chip_smoke.py``'s
comparison use. :func:`flash_attention` returns ``None`` when its shape
gate fails, and the caller keeps the plain attention path.
"""

from typing import Optional

import torch

from torchx_tpu_torch import _build
from torchx_tpu_torch.ops.attention import _repeat_kv
from torchx_tpu_torch.ops.norms import _bwd, _check_rows, _rms_norm_fwd_math

#: The "already softmax-dead" constant the plain attention uses.
NEG_INF = -1e30

#: Head dims the flash kernels tile.
FLASH_HEAD_DIMS = (64, 128, 256)

#: The port's ``--kernels`` values.
KERNEL_MODES = ("reference", "cuda")

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_KERNELS: dict = {}
triton = tl = None  # imported by _triton_norm_res() on the first launch


def flash_shapes_ok(s_q: int, s_k: int, head_dim: int) -> bool:
    """Static gate for the flash kernels: a tiled head dim, 128-multiple
    self-attention sequences."""
    return (
        head_dim in FLASH_HEAD_DIMS
        and s_q == s_k
        and s_q % 128 == 0
        and s_q >= 128
    )


def norm_shapes_ok(d: int) -> bool:
    """Static gate for the fused norm kernel: lane-aligned feature dim."""
    return d % 128 == 0


# ---------------------------------------------------------------------------
# flash attention: plain versions (CPU tensors, and the card's comparison)
# ---------------------------------------------------------------------------


def _scores(q, k, causal):  # noqa: ANN001, ANN202
    """f32 logits [b, h, s, s] of q*scale against the repeated k, masked."""
    scale = q.shape[-1] ** -0.5
    kf = _repeat_kv(k, q.shape[2] // k.shape[2]).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, kf)
    if causal:
        keep = torch.ones(s.shape[-2:], dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, NEG_INF)
    return s


def _flash_fwd_plain(q, k, v, causal):  # noqa: ANN001, ANN202
    """-> (o f32 [b, s, h, d], lse f32 [b, h, s])."""
    s = _scores(q, k, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)  # noqa: E741
    vf = _repeat_kv(v, q.shape[2] // v.shape[2]).float()
    acc = torch.einsum("bhqk,bkhd->bhqd", p, vf)
    return (acc / l).transpose(1, 2).contiguous(), (m + torch.log(l))[..., 0]


def _probs_and_ds(q, k, v, do, lse, delta, causal):  # noqa: ANN001, ANN202
    p = torch.exp(_scores(q, k, causal) - lse[..., None])
    vf = _repeat_kv(v, q.shape[2] // v.shape[2]).float()
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), vf)
    return p, p * (dp - delta[..., None])


def _fold_heads(x, kv_heads):  # noqa: ANN001, ANN202
    """[b, s, h, d] per query head -> [b, s, kv_heads, d], summed over the
    query heads sharing each KV head (the transpose of _repeat_kv)."""
    b, s, h, d = x.shape
    return x.reshape(b, s, kv_heads, h // kv_heads, d).sum(dim=3)


def _flash_dq_plain(q, k, v, do, lse, delta, causal):  # noqa: ANN001, ANN202
    _, ds = _probs_and_ds(q, k, v, do, lse, delta, causal)
    kf = _repeat_kv(k, q.shape[2] // k.shape[2]).float()
    return torch.einsum("bhqk,bkhd->bqhd", ds, kf) * q.shape[-1] ** -0.5


def _flash_dkv_plain(q, k, v, do, lse, delta, causal):  # noqa: ANN001, ANN202
    p, ds = _probs_and_ds(q, k, v, do, lse, delta, causal)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * q.shape[-1] ** -0.5
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    return _fold_heads(dk, k.shape[2]), _fold_heads(dv, v.shape[2])


# ---------------------------------------------------------------------------
# flash attention: kernel wrappers
# ---------------------------------------------------------------------------


def _check_flash(q, k, v, *more):  # noqa: ANN001, ANN202
    if not q.is_cuda:
        raise ValueError(f"flash attention: no kernel for device {q.device}")
    b, s, h, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, s) or k.shape[3] != d:
        raise ValueError(f"flash attention: q {q.shape} vs k {k.shape} v {v.shape}")
    if h % k.shape[2] or not flash_shapes_ok(s, s, d):
        raise ValueError(f"flash attention: shapes q {q.shape} k {k.shape} not tiled")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"flash attention: unsupported dtype {q.dtype}")
    for t in (q, k, v, *more):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("flash attention: tensors must be contiguous on one device")
    for t in (k, v) + more[:1]:
        if t.dtype != q.dtype:
            raise ValueError("flash attention: q, k, v and dO must share a dtype")
    return b, s, h, k.shape[2], d


def _dims(q, k, v, causal, *more):  # noqa: ANN001, ANN202
    b, s, h, kvh, d = _check_flash(q, k, v, *more)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    return [b, s, h, kvh, d, int(causal), _DTYPE_CODE[q.dtype], stream]


def _flash_fwd(q, k, v, causal):  # noqa: ANN001, ANN202
    """[b, s, h, d], [b, s, kvh, d] x2 -> (o f32 [b, s, h, d], lse f32
    [b, h, s])."""
    if q.device.type == "cpu":
        return _flash_fwd_plain(q, k, v, causal)
    dims = _dims(q, k, v, causal)
    b, s, h = q.shape[:3]
    o = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = _build.cuda_lib().tpx_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), *dims,
        )
    _build.check(rc, "flash_fwd")
    _build.count_launch("flash_fwd")
    return o, lse


def _flash_dq(q, k, v, do, lse, delta, causal):  # noqa: ANN001, ANN202
    """-> dq f32 [b, s, h, d]."""
    if q.device.type == "cpu":
        return _flash_dq_plain(q, k, v, do, lse, delta, causal)
    dims = _dims(q, k, v, causal, do, lse, delta)
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = _build.cuda_lib().tpx_flash_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), *dims,
        )
    _build.check(rc, "flash_dq")
    _build.count_launch("flash_dq")
    return dq


def _flash_dkv(q, k, v, do, lse, delta, causal):  # noqa: ANN001, ANN202
    """-> (dk, dv) f32 [b, s, kvh, d], summed over each KV head's query
    heads."""
    if q.device.type == "cpu":
        return _flash_dkv_plain(q, k, v, do, lse, delta, causal)
    dims = _dims(q, k, v, causal, do, lse, delta)
    dk = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty(v.shape, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = _build.cuda_lib().tpx_flash_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *dims,
        )
    _build.check(rc, "flash_dkv")
    _build.count_launch("flash_dkv")
    return dk, dv


def _flash_delta(do, o_f32):  # noqa: ANN001, ANN202
    """delta = rowsum(dO * O) in f32, [b, s, h, d] -> [b, h, s]."""
    return (do.float() * o_f32).sum(dim=-1).transpose(1, 2).contiguous()


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):  # noqa: ANN001, ANN205
        o, lse = _flash_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o.to(q.dtype)

    @staticmethod
    def backward(ctx, do):  # noqa: ANN001, ANN205
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = _flash_delta(do, o)
        dq = _flash_dq(q, k, v, do, lse, delta, ctx.causal)
        dk, dv = _flash_dkv(q, k, v, do, lse, delta, ctx.causal)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None


def flash_attention(
    q: torch.Tensor,  # [b, s, h, d]
    k: torch.Tensor,  # [b, s, kv_h, d]
    v: torch.Tensor,
    causal: bool = True,
    kernels: str = "cuda",
) -> Optional[torch.Tensor]:
    """Flash attention, or ``None`` when the gate says "use the plain path":
    ``kernels`` is not "cuda", the shapes fail :func:`flash_shapes_ok`, or
    the query heads are not a multiple of the KV heads."""
    if kernels != "cuda":
        return None
    if not flash_shapes_ok(q.shape[1], k.shape[1], q.shape[-1]):
        return None
    if q.shape[2] % k.shape[2]:
        return None
    return _FlashAttention.apply(
        q.contiguous(), k.contiguous(), v.contiguous(), causal
    )


# ---------------------------------------------------------------------------
# fused residual-add + RMSNorm
# ---------------------------------------------------------------------------


def _rms_norm_residual_math(x, res, weight, eps):  # noqa: ANN001, ANN202
    """The plain version: exactly the unfused op sequence."""
    s = x + res
    return _rms_norm_fwd_math(s, weight, eps), s


def _triton_norm_res():  # noqa: ANN202
    """Define the Triton kernel on first use: triton is imported here,
    never when the module is imported."""
    if _KERNELS:
        return _KERNELS["norm_res"]
    _build.setup_triton_cache()
    global triton, tl
    import triton
    import triton.language as tl

    @triton.jit
    def norm_res_fwd_kernel(
        x_ptr, r_ptr, w_ptr, y_ptr, s_ptr, d, eps, BLOCK_D: tl.constexpr
    ):
        row = tl.program_id(0).to(tl.int64)
        cols = tl.arange(0, BLOCK_D)
        m = cols < d
        x = tl.load(x_ptr + row * d + cols, mask=m, other=0.0)
        r = tl.load(r_ptr + row * d + cols, mask=m, other=0.0)
        s = x + r  # input dtype: bitwise the unfused add
        tl.store(s_ptr + row * d + cols, s, mask=m)
        sf = s.to(tl.float32)
        rrms = tl.div_rn(1.0, tl.sqrt_rn(tl.sum(sf * sf, axis=0) / d + eps))
        w = tl.load(w_ptr + cols, mask=m, other=0.0).to(tl.float32)
        y = (sf * rrms) * w
        tl.store(y_ptr + row * d + cols, y.to(y_ptr.dtype.element_ty), mask=m)

    _KERNELS["norm_res"] = norm_res_fwd_kernel
    return norm_res_fwd_kernel


def _norm_res_fwd(x2d, r2d, weight, eps):  # noqa: ANN001, ANN202
    """-> (y [n, d], s [n, d]): the Triton kernel on a CUDA tensor, its
    plain version only for a tensor on the CPU."""
    if x2d.device.type == "cpu":
        return _rms_norm_residual_math(x2d, r2d, weight, eps)
    if not x2d.is_cuda:
        raise ValueError(f"rms_norm_residual: no kernel for device {x2d.device}")
    _check_rows("rms_norm_residual", x2d, r2d, weight)
    if r2d.dtype != x2d.dtype or r2d.shape != x2d.shape:
        raise ValueError("rms_norm_residual: x and residual must match")
    kernel = _triton_norm_res()
    n, d = x2d.shape
    block_d = triton.next_power_of_2(d)
    y = torch.empty_like(x2d)
    s = torch.empty_like(x2d)
    kernel[(n,)](
        x2d, r2d, weight, y, s, d, eps,
        BLOCK_D=block_d, num_warps=max(1, min(16, block_d // 256)),
    )
    _build.count_launch("norm_res_fwd")
    return y, s


class _RmsNormResidual(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, res, weight, eps):  # noqa: ANN001, ANN205
        d = x.shape[-1]
        y, s = _norm_res_fwd(x.reshape(-1, d), res.reshape(-1, d), weight, eps)
        ctx.save_for_backward(s, weight)
        ctx.eps = eps
        return y.reshape(x.shape), s.reshape(x.shape)

    @staticmethod
    def backward(ctx, dy, ds_out):  # noqa: ANN001, ANN205
        s, weight = ctx.saved_tensors
        d = s.shape[-1]
        # the dx+dw kernel of ops/norms runs on the summed stream s; the
        # extra ds_out cotangent (s is also an output) adds straight through
        dx, dw = _bwd(s, dy.reshape(-1, d).contiguous(), weight, ctx.eps)
        ds = dx.reshape(ds_out.shape).to(s.dtype) + ds_out
        return ds, ds, dw.to(weight.dtype), None


def rms_norm_residual(
    x: torch.Tensor,
    residual: torch.Tensor,
    weight: torch.Tensor,
    eps: float = 1e-5,
    kernels: str = "reference",
) -> tuple[torch.Tensor, torch.Tensor]:
    """``s = x + residual; y = rms_norm(s) * weight`` -> ``(y, s)``.

    Any gate failure takes the plain op sequence, with identical values."""
    if kernels != "cuda" or not norm_shapes_ok(x.shape[-1]):
        return _rms_norm_residual_math(x, residual, weight, eps)
    return _RmsNormResidual.apply(
        x.contiguous(), residual.contiguous(), weight, eps
    )


def resolve_kernels(requested: str) -> str:
    """Map a ``--kernels`` request to the port's value: the JAX package's
    ``"pallas"`` is the port's ``"cuda"``. ``"cuda"`` stays ``"cuda"`` on
    every device: on a CUDA device it never degrades to ``"reference"``
    (on the CPU its wrappers run their plain versions)."""
    resolved = {"pallas": "cuda"}.get(requested, requested)
    if resolved not in KERNEL_MODES:
        raise ValueError(
            f"kernels must be one of {KERNEL_MODES} (or 'pallas'),"
            f" got {requested!r}"
        )
    return resolved
