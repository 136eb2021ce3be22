"""RMSNorm, with a fused dx+dw backward kernel written in Triton.

Port of :mod:`torchx_tpu.ops.norms`. RMSNorm computes in float32 whatever
the input dtype and casts back. :func:`rms_norm`'s ``fused`` switch selects
the backward: the plain autograd backward, or one Triton kernel producing
``dx`` and ``dw`` in a single read of ``x`` and ``dy``.

The kernel replaces the Pallas TPU kernel ``_bwd_kernel`` (launched by
``_bwd_pallas``) of ``torchx_tpu/ops/norms.py``. It is bound by bytes on an
H100: per row it reads ``x`` and ``dy`` and writes ``dx`` (about 5
operations per byte moved), so the bound is the memory rate. Its design
reads each row once, keeps every intermediate in registers, and writes per
program a ``dw`` partial in f32. On the TPU the grid ran in order and
carried ``dw`` through it; Hopper's programs run in parallel, so a second
Triton pass sums the partials in a fixed order, which keeps ``dw``
deterministic.
"""

import os

import torch

from torchx_tpu_torch import _build

#: The port's own copy of the JAX package's environment switch name.
ENV_TPX_FUSED_NORM = "TPX_FUSED_NORM"
FUSED_MODES = ("auto", "cuda", "never")

_KERNELS: dict = {}
triton = tl = None  # imported by _triton_kernels() on the first launch


def _rms_norm_fwd_math(
    x: torch.Tensor, weight: torch.Tensor, eps: float
) -> torch.Tensor:
    xf = x.float()
    rrms = torch.reciprocal(
        torch.sqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    )
    return ((xf * rrms) * weight.float()).to(x.dtype)


def _bwd_math(x, weight, dy, eps):  # noqa: ANN001
    """The plain backward: returns (dx, dw[f32])."""
    xf = x.float()
    dyf = dy.float()
    wf = weight.float()
    rrms = torch.reciprocal(
        torch.sqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    )
    xhat = xf * rrms
    dw = torch.sum(dyf * xhat, dim=tuple(range(x.dim() - 1)))
    dxhat = dyf * wf
    c = torch.mean(dxhat * xhat, dim=-1, keepdim=True)
    dx = (rrms * (dxhat - xhat * c)).to(x.dtype)
    return dx, dw


def _triton_kernels():  # noqa: ANN202
    """Define the Triton kernels on first use: triton is imported here,
    never when the module is imported."""
    if _KERNELS:
        return _KERNELS["bwd"], _KERNELS["reduce"]
    _build.setup_triton_cache()
    global triton, tl
    import triton
    import triton.language as tl

    @triton.jit
    def rms_norm_bwd_kernel(
        x_ptr, dy_ptr, w_ptr, dx_ptr, dwp_ptr, n_rows, d, rows_per_prog, eps,
        BLOCK_D: tl.constexpr,
    ):
        pid = tl.program_id(0)
        cols = tl.arange(0, BLOCK_D)
        cmask = cols < d
        w = tl.load(w_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
        dw = tl.zeros([BLOCK_D], dtype=tl.float32)
        for i in range(0, rows_per_prog):
            row = pid * rows_per_prog + i
            m = cmask & (row < n_rows)
            off = row.to(tl.int64) * d + cols
            x = tl.load(x_ptr + off, mask=m, other=0.0).to(tl.float32)
            dy = tl.load(dy_ptr + off, mask=m, other=0.0).to(tl.float32)
            rrms = tl.div_rn(1.0, tl.sqrt_rn(tl.sum(x * x, axis=0) / d + eps))
            xhat = x * rrms
            dxhat = dy * w
            c = tl.sum(dxhat * xhat, axis=0) / d
            dx = rrms * (dxhat - xhat * c)
            tl.store(dx_ptr + off, dx.to(dx_ptr.dtype.element_ty), mask=m)
            dw += dy * xhat
        tl.store(dwp_ptr + pid.to(tl.int64) * d + cols, dw, mask=cmask)

    @triton.jit
    def dw_reduce_kernel(
        dwp_ptr, dw_ptr, n_parts, d, BLOCK_P: tl.constexpr, BLOCK_C: tl.constexpr
    ):
        cols = tl.program_id(0) * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = cols < d
        acc = tl.zeros([BLOCK_C], dtype=tl.float32)
        for p0 in range(0, n_parts, BLOCK_P):
            parts = p0 + tl.arange(0, BLOCK_P)
            m = (parts[:, None] < n_parts) & cmask[None, :]
            tile = tl.load(
                dwp_ptr + parts[:, None].to(tl.int64) * d + cols[None, :],
                mask=m,
                other=0.0,
            )
            acc += tl.sum(tile, axis=0)
        tl.store(dw_ptr + cols, acc, mask=cmask)

    _KERNELS.update(bwd=rms_norm_bwd_kernel, reduce=dw_reduce_kernel)
    return rms_norm_bwd_kernel, dw_reduce_kernel


def _check_rows(name: str, *tensors: torch.Tensor) -> None:
    ref = tensors[0]
    for t in tensors:
        if t.device != ref.device or not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous on one device")
        if t.dtype not in (torch.float32, torch.bfloat16, torch.float16):
            raise ValueError(f"{name}: unsupported dtype {t.dtype}")


def _bwd(x2d, dy2d, weight, eps: float):  # noqa: ANN001
    """-> (dx [n, d] in x's dtype, dw [d] f32).

    The Triton kernel on a CUDA tensor; its plain version only for a tensor
    on the CPU."""
    if x2d.device.type == "cpu":
        return _bwd_math(x2d, weight, dy2d, eps)
    if not x2d.is_cuda:
        raise ValueError(f"rms_norm backward: no kernel for device {x2d.device}")
    _check_rows("rms_norm backward", x2d, dy2d, weight)
    bwd_kernel, reduce_kernel = _triton_kernels()
    n, d = x2d.shape
    block_d = triton.next_power_of_2(d)
    sms = torch.cuda.get_device_properties(x2d.device).multi_processor_count
    rows_per_prog = triton.cdiv(n, 2 * sms)
    n_prog = triton.cdiv(n, rows_per_prog)
    dx = torch.empty_like(x2d)
    dw_parts = torch.empty((n_prog, d), dtype=torch.float32, device=x2d.device)
    dw = torch.empty((d,), dtype=torch.float32, device=x2d.device)
    bwd_kernel[(n_prog,)](
        x2d, dy2d, weight, dx, dw_parts, n, d, rows_per_prog, eps,
        BLOCK_D=block_d, num_warps=max(1, min(16, block_d // 256)),
    )
    reduce_kernel[(triton.cdiv(d, 128),)](
        dw_parts, dw, n_prog, d, BLOCK_P=32, BLOCK_C=128, num_warps=4
    )
    _build.count_launch("rms_norm_bwd")
    return dx, dw


class _RmsNormFused(torch.autograd.Function):
    """RMSNorm whose backward is the fused dx+dw kernel."""

    @staticmethod
    def forward(ctx, x, weight, eps):  # noqa: ANN001, ANN205
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return _rms_norm_fwd_math(x, weight, eps)

    @staticmethod
    def backward(ctx, dy):  # noqa: ANN001, ANN205
        x, weight = ctx.saved_tensors
        d = x.shape[-1]
        dx, dw = _bwd(
            x.reshape(-1, d), dy.reshape(-1, d).contiguous(), weight, ctx.eps
        )
        return dx.reshape(x.shape), dw.to(weight.dtype), None


def rms_norm(
    x: torch.Tensor,
    weight: torch.Tensor,
    eps: float = 1e-5,
    fused: str = "auto",
) -> torch.Tensor:
    """RMS-normalize ``x`` over its last axis and scale by ``weight``.

    ``fused`` selects the backward:

    * "auto" (default) — the value of ``TPX_FUSED_NORM``, "never" when
      unset: the JAX package measured the plain backward faster on its
      hardware and made it the default; the port keeps the default.
    * "cuda" — the fused dx+dw kernel (its plain version on a CPU tensor).
    * "never" — the plain autograd backward.
    """
    if fused == "auto":
        fused = os.environ.get(ENV_TPX_FUSED_NORM, "never")
    if fused not in ("cuda", "never"):
        raise ValueError(f"fused must be one of {FUSED_MODES}, got {fused!r}")
    if fused == "never":
        return _rms_norm_fwd_math(x, weight, eps)
    return _RmsNormFused.apply(x.contiguous(), weight, eps)
