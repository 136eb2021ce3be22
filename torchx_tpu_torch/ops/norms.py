"""RMSNorm, with a fused dx+dw backward kernel written in Triton.

Port of :mod:`torchx_tpu.ops.norms`. RMSNorm computes in float32 whatever
the input dtype and casts back. :func:`rms_norm`'s ``fused`` switch selects
the backward: the plain autograd backward, or one Triton kernel producing
``dx`` and ``dw`` in a single read of ``x`` and ``dy``.

The kernel replaces the Pallas TPU kernel ``_bwd_kernel`` (launched by
``_bwd_pallas``) of ``torchx_tpu/ops/norms.py``. It is bound by bytes on an
H100: per row it reads ``x`` and ``dy`` and writes ``dx`` (about 5
operations per byte moved), so the bound is the memory rate, and the
design is about keeping enough bytes in flight. Each program walks its
share of the rows ``ROWS`` at a time as one ``[ROWS, d]`` block, so the
loads of several rows are issued together and the two row reductions of a
block (the mean square, and the ``dxhat . xhat`` term) share one round of
cross-warp traffic; a few programs per SM hide each other's latency.
Every intermediate stays in registers, and each program writes one ``dw``
partial in f32. On the TPU the grid ran in order and carried ``dw``
through it; Hopper's programs run in parallel, so a second Triton pass
sums the partials in a fixed order, which keeps ``dw`` deterministic (no
float atomics). :data:`BWD_CONFIG` holds the launch settings, chosen from
the sweep of ``chip_smoke.py --phases build,sweep``.
"""

import os

import torch

from torchx_tpu_torch import _build
from torchx_tpu_torch.settings import ENV_TPX_FUSED_NORM

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
        ROWS: tl.constexpr, BLOCK_D: tl.constexpr, STAGES: tl.constexpr,
    ):
        pid = tl.program_id(0)
        cols = tl.arange(0, BLOCK_D)
        cmask = cols < d
        w = tl.load(w_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
        dw = tl.zeros([BLOCK_D], dtype=tl.float32)
        # rows_per_prog is a multiple of ROWS: programs never overlap
        for i in tl.range(0, rows_per_prog, ROWS, num_stages=STAGES):
            rows = pid * rows_per_prog + i + tl.arange(0, ROWS)
            m = (rows < n_rows)[:, None] & cmask[None, :]
            off = rows.to(tl.int64)[:, None] * d + cols[None, :]
            x = tl.load(x_ptr + off, mask=m, other=0.0).to(tl.float32)
            dy = tl.load(dy_ptr + off, mask=m, other=0.0).to(tl.float32)
            rrms = tl.div_rn(1.0, tl.sqrt_rn(tl.sum(x * x, axis=1) / d + eps))
            xhat = x * rrms[:, None]
            dxhat = dy * w[None, :]
            c = tl.sum(dxhat * xhat, axis=1) / d
            dx = rrms[:, None] * (dxhat - xhat * c[:, None])
            tl.store(dx_ptr + off, dx.to(dx_ptr.dtype.element_ty), mask=m)
            dw += tl.sum(dy * xhat, axis=0)
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


#: rms_norm_bwd's launch: rows per block, warps per program, programs per
#: SM, software-pipeline stages of the row loop (1: none), and columns per
#: program of the dw pass. The fastest of chip_smoke.py's sweep on an H100
#: at [8192, 2048] bf16: 0.044 ms against 0.075 ms for the row-at-a-time
#: design (1, 8, 2, 1, 128), whose few bytes in flight per SM and 16-program
#: dw pass bounded it.
BWD_CONFIG = (4, 4, 2, 2, 16)
#: The row width BWD_CONFIG was chosen at. A wider row gets proportionally
#: more warps (at most 16), so that each thread holds as many values of
#: the [ROWS, d] block as at this width: at d 4096 with 4 warps each thread
#: would hold 128 f32 values per array, and the kernel took 1.56 ms against
#: the plain version's 1.40 (chip_smoke.py, Mixtral's dim 4096).
BWD_WIDTH = 2048


def _bwd(x2d, dy2d, weight, eps: float, config=BWD_CONFIG):  # noqa: ANN001
    """-> (dx [n, d] in x's dtype, dw [d] f32).

    The Triton kernel on a CUDA tensor, launched with ``config`` (see
    :data:`BWD_CONFIG`); its plain version only for a tensor on the CPU."""
    if x2d.device.type == "cpu":
        return _bwd_math(x2d, weight, dy2d, eps)
    if not x2d.is_cuda:
        raise ValueError(f"rms_norm backward: no kernel for device {x2d.device}")
    _check_rows("rms_norm backward", x2d, dy2d, weight)
    bwd_kernel, reduce_kernel = _triton_kernels()
    rows, num_warps, per_sm, stages, reduce_cols = config
    n, d = x2d.shape
    num_warps = min(16, num_warps * max(1, triton.next_power_of_2(d) // BWD_WIDTH))
    sms = torch.cuda.get_device_properties(x2d.device).multi_processor_count
    rows_per_prog = triton.cdiv(triton.cdiv(n, per_sm * sms), rows) * rows
    n_prog = triton.cdiv(n, rows_per_prog)
    dx = torch.empty_like(x2d)
    dw_parts = torch.empty((n_prog, d), dtype=torch.float32, device=x2d.device)
    dw = torch.empty((d,), dtype=torch.float32, device=x2d.device)
    bwd_kernel[(n_prog,)](
        x2d, dy2d, weight, dx, dw_parts, n, d, rows_per_prog, eps,
        ROWS=rows, BLOCK_D=triton.next_power_of_2(d), STAGES=stages,
        num_warps=num_warps,
    )
    reduce_kernel[(triton.cdiv(d, reduce_cols),)](
        dw_parts, dw, n_prog, d, BLOCK_P=4096 // reduce_cols, BLOCK_C=reduce_cols,
        num_warps=4,
    )
    _build.count_launch("rms_norm_bwd")
    return dx, dw


@torch.library.custom_op("tpx::rms_norm_bwd", mutates_args=())
def rms_norm_bwd_op(
    x: torch.Tensor, dy: torch.Tensor, weight: torch.Tensor, eps: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The dx+dw backward kernel as one operator, over x's last axis: ->
    (dx in x's shape and dtype, dw [d] f32). The fit probe traces its fake
    implementation on meta tensors."""
    d = x.shape[-1]
    dx, dw = _bwd(x.reshape(-1, d), dy.reshape(-1, d).contiguous(), weight, eps)
    return dx.reshape(x.shape), dw


@rms_norm_bwd_op.register_fake
def _(x, dy, weight, eps):  # noqa: ANN001, ANN202
    return torch.empty_like(x), x.new_empty((x.shape[-1],), dtype=torch.float32)


class _RmsNormFused(torch.autograd.Function):
    """RMSNorm whose backward is the fused dx+dw kernel (the forward is
    plain ops, which a remat policy and the fit probe see as they are)."""

    @staticmethod
    def forward(ctx, x, weight, eps):  # noqa: ANN001, ANN205
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return _rms_norm_fwd_math(x, weight, eps)

    @staticmethod
    def backward(ctx, dy):  # noqa: ANN001, ANN205
        x, weight = ctx.saved_tensors
        dx, dw = rms_norm_bwd_op(x, dy, weight, ctx.eps)
        return dx, dw.to(weight.dtype), None


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
