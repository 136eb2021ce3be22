"""Int8 for the port: weight-only serving and the trainer's int8 matmuls.

Port of :mod:`torchx_tpu.ops.quant`, with its names. Two unrelated halves:

* **Weight-only serving.** :func:`quantize_params` turns every projection
  matrix into ``{"q": int8, "scale": f32}`` with symmetric
  per-output-channel scales (bitwise the JAX package's), and
  :func:`int8_matmul` computes ``(x @ q) * scale`` with the sum in f32 and
  the scale applied after it. PyTorch has no int8 x bf16 product on CUDA,
  and widening the weights first would move 5 bytes per weight where bf16
  serving moves 2; so on a CUDA tensor :func:`int8_matmul` launches the
  hand-written kernel of ``csrc/int8_matmul.cu``, which reads each int8
  weight once, and raises if it cannot. Only a tensor on the CPU takes the
  plain version (:func:`_int8_matmul_plain`), which the CPU tests and
  chip_smoke.py's comparison use.
* **Training.** ``maybe_matmul(..., int8_training=True)`` is the
  counterpart of the JAX package's AQT ``config_v4`` dot
  (``torchx_tpu.ops.quant.aqt_dot_general``): both operands of the
  forward and of both backward products are quantized dynamically to
  int8, int8 x int8 ->
  int32 through ``torch._int_mm``, then rescaled, and the gradient passes
  straight through the rounding. AQT's numerics, matched bitwise: each
  operand is calibrated by its absolute maximum along the product's
  contracting axis (one scale per row of the left operand, one per column
  of the right: ``CalibrationMode.CONTRACTING_AXIS``, not per tensor),
  ``IntSymmetric(bits=8, preserve_zero=True, preserve_max_val=False)``
  (bound 127.5, values clipped to +-127 and rounded half to even), all in
  the operand's dtype; the backward requantizes the unquantized operands
  over its own contracting axes (``use_fwd_quant=False``); the int32 sum
  is cast to the operands' dtype and multiplied by the left scale, then
  the right, in that dtype (``QTensor.dequant``). Rounding is
  deterministic (the JAX function turns stochastic rounding off), so a
  remat recompute reproduces the forward's int8 operands.

Nothing here needs a GPU at import time.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional

import torch

from torchx_tpu_torch import _build

Params = dict[str, Any]

#: The projection matrices :func:`quantize_params` quantizes (the FFN,
#: attention and head matmuls carry nearly all weight bytes; norms and
#: embeddings stay exact).
_QUANT_KEYS = {
    "wq", "wk", "wv", "wo",
    "w_gate", "w_up", "w_down",
    "lm_head",
}


# ---------------------------------------------------------------------------
# weight-only quantization
# ---------------------------------------------------------------------------


def _div(t: torch.Tensor, c: float) -> torch.Tensor:
    """``t / c`` as an IEEE division on every device: PyTorch's CUDA
    division by a Python scalar multiplies by its reciprocal, which rounds
    otherwise than the JAX package's division (and the CPU's)."""
    return t / torch.full((), c, dtype=t.dtype, device=t.device)


def _quantize_block(w: torch.Tensor, keep: set[int]) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 of ``w`` with one f32 scale per index of the ``keep``
    axes (the JAX function's arithmetic, step for step)."""
    wf = w.float()
    reduce = tuple(i for i in range(w.ndim) if i not in keep)
    absmax = wf.abs().amax(dim=reduce, keepdim=True) if reduce else wf.abs()
    scale = _div(torch.clamp(absmax, min=1e-8), 127.0)
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize(w: torch.Tensor, axis: int = -1) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (int8 weights, f32 scale) with symmetric per-channel scales.

    ``axis`` is the output-channel axis (kept exact). A stack (``ndim >=
    3``, such as ``[L, in, out]``) keeps its leading layer axis too, so
    every layer gets its own scales, and is quantized one layer at a time
    (a whole-leaf f32 copy of llama3_8b's ``w_gate`` would take 7.5 GB).
    The scale is ``[1, out]`` for a matrix, ``[L, 1, out]`` for a stack."""
    axis = axis % w.ndim
    if w.ndim < 3:
        return _quantize_block(w, {axis})
    keep = {axis - 1} if axis else set()
    scale_shape = [w.shape[0]] + [
        w.shape[i] if i == axis else 1 for i in range(1, w.ndim)
    ]
    q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    scale = torch.empty(scale_shape, dtype=torch.float32, device=w.device)
    for i in range(w.shape[0]):
        q[i], scale[i] = _quantize_block(w[i], keep)
    return q, scale


def dequantize(
    q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype = torch.bfloat16
) -> torch.Tensor:
    """int8 x per-channel scale -> float weights."""
    return (q.float() * scale).to(dtype)


def _quantizable(key: str, v: Any) -> bool:
    return (
        key in _QUANT_KEYS
        and isinstance(v, torch.Tensor)
        and v.is_floating_point()
        # a matrix or an [L, in, out] layer stack; expert-stacked MoE
        # weights (ndim 4) keep their einsum path exact
        and v.ndim in (2, 3)
    )


def quantize_params(params: Params, inplace: bool = False) -> Params:
    """Quantize every projection matrix of a Llama or MoE parameter tree.

    Returns a tree of the same structure in which each quantized leaf
    becomes ``{"q": int8, "scale": f32}``; everything else is the same
    tensor. ``inplace=True`` writes each record into ``params`` itself as
    soon as it exists, dropping the tree's reference to the float leaf, so
    that a caller holding no other reference frees each leaf before the
    next is quantized (the peak stays near the float tree plus one
    leaf)."""

    def walk(node: Any) -> Any:
        if not isinstance(node, dict):
            return node
        out = node if inplace else {}
        for k in list(node):
            v = node[k]
            if _quantizable(k, v):
                with torch.no_grad():
                    q, scale = quantize(v)
                del v
                out[k] = {"q": q, "scale": scale}
            else:
                out[k] = walk(v)
        return out

    return walk(params)


def size_bytes(params: Params) -> int:
    """Total bytes of every tensor in the tree."""
    if isinstance(params, dict):
        return sum(size_bytes(v) for v in params.values())
    return params.numel() * params.element_size()


# ---------------------------------------------------------------------------
# int8-weight matmul: the kernel's wrapper and its plain version
# ---------------------------------------------------------------------------

#: The kernels' tile: output columns per block and k rows per stage
#: (``csrc/int8_matmul.cu``).
BLOCK_N, BLOCK_K = 128, 64
#: The kernel paths, by the C launcher's code: f32 activations on TF32
#: mma.sync (16-row blocks, x split into TF32 hi + lo: two products, bound
#: by the weight bytes); bf16 at decode (mma.sync, 16-row blocks, bound by
#: the weight bytes); bf16 at prefill (wgmma fed by TMA, 128- or 256-row
#: blocks, bound by operations).
PATH_TF32, PATH_DECODE, PATH_WGMMA = 0, 1, 2
#: The blocks of each path that one SM holds at once, by shared memory:
#: the TF32 ring and its split x tile take 57 KB (three in the SM's 228
#: KB), the decode ring 45 KB, the wgmma one 145-209 KB.
_BLOCKS_PER_SM = {PATH_TF32: 3, PATH_DECODE: 2, PATH_WGMMA: 1}
#: The wgmma kernel's 256-row tiles (four warpgroups share each widened
#: weight tile) serve bf16-output calls of more rows than this whose
#: 256-row plan keeps at least ``TALL_MIN_STEPS`` k steps per split: a
#: split's last block adds every split's partial tile alone, which only a
#: long split amortizes. Smaller calls, short splits and f32 outputs take
#: 128-row tiles (chip_smoke.py ``--phases build,int8sweep``, PERF.md).
WGMMA_TALL_M = 128
TALL_MIN_STEPS = 32
#: bf16 calls with at most this many rows take the decode kernel, and so
#: do larger ones whose wgmma plan would split k into runs of fewer than
#: ``DECODE_MIN_STEPS`` steps (a few column tiles, as wk / wv's 8): where
#: the two kernels cross on llama3_8b's shapes (chip_smoke.py ``--phases
#: build,int8sweep``, PERF.md).
DECODE_MAX_M = 16
DECODE_MIN_STEPS = 8


def _int8_matmul_plain(
    x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, out_dtype: Optional[torch.dtype] = None
) -> torch.Tensor:
    """The kernel's plain version: the weights widened (exact: |q| <= 127
    fits any float's mantissa), the product and its sum in f32, the scale
    after the sum."""
    return ((x.float() @ q.float()) * scale.reshape(-1)).to(out_dtype or x.dtype)


def kernel_name(x_dtype: torch.dtype) -> str:
    """The launch-count name of the kernel a CUDA ``x`` of this dtype
    takes: bf16 (either bf16 path) or f32 (TF32 mma.sync)."""
    return "int8_matmul" if x_dtype == torch.bfloat16 else "int8_matmul_tf32"


def split_k(m: int, n: int, k: int, block_m: int, slots: int) -> tuple[int, int]:
    """-> (splits, k steps per split) of the kernel's k loop. Where the
    output tiles alone fill fewer than ``slots`` blocks (the blocks the card
    holds at once), the k range is split so that the blocks come close to
    ``slots``, each over at least 4 steps of ``BLOCK_K``; every split is
    non-empty. The kernel's last block of a tile adds the partial sums in
    split order, so the result is deterministic."""
    steps = math.ceil(k / BLOCK_K)
    tiles = math.ceil(m / block_m) * math.ceil(n / BLOCK_N)
    splits = 1
    if tiles < slots:
        splits = max(1, min(steps // 4, slots // tiles))
    per = math.ceil(steps / splits)
    return math.ceil(steps / per), per


class Plan(NamedTuple):
    """One call's launch: the path, its block rows, the k split, the output
    tiles, and the scratch a split needs (f32 workspace elements, one int32
    counter per tile; none without a split)."""

    path: int
    block_m: int
    splits: int
    per: int
    tiles: int
    work: int
    counters: int


def launch_plan(m: int, n: int, k: int, x_f32: bool, sms: int, out_f32: bool = False) -> Plan:
    """The launch of an ``[m, k] x [k, n]`` call on a card with ``sms`` SMs
    (``out_f32``: f32 output from bf16 activations)."""
    path, block_m = PATH_TF32 if x_f32 else PATH_DECODE, 16
    if not x_f32 and m > DECODE_MAX_M:
        slots = sms * _BLOCKS_PER_SM[PATH_WGMMA]
        tall = m > WGMMA_TALL_M and not out_f32
        wide_m = 256 if tall and split_k(m, n, k, 256, slots)[1] >= TALL_MIN_STEPS else 128
        if split_k(m, n, k, wide_m, slots)[1] >= DECODE_MIN_STEPS:
            path, block_m = PATH_WGMMA, wide_m
    splits, per = split_k(m, n, k, block_m, sms * _BLOCKS_PER_SM[path])
    tiles = math.ceil(m / block_m) * math.ceil(n / BLOCK_N)
    split = splits > 1
    return Plan(path, block_m, splits, per, tiles, splits * m * n if split else 0,
                tiles if split else 0)


_X_DTYPES = (torch.float32, torch.bfloat16)


def _explain_bad_inputs(x, q, scale, out_dtype):  # noqa: ANN001, ANN202
    """Raise the ValueError that names what the kernel does not take."""
    if x.dtype not in _X_DTYPES:
        raise ValueError(f"int8_matmul: x must be bf16 or f32, got {x.dtype}")
    if q.dtype != torch.int8 or q.ndim != 2:
        raise ValueError(
            f"int8_matmul: q must be a 2-D int8 [K, N], got {q.dtype} {tuple(q.shape)}"
        )
    k, n = q.shape
    if x.ndim < 1 or x.shape[-1] != k:
        raise ValueError(
            f"int8_matmul: x {tuple(x.shape)} does not contract with q {tuple(q.shape)}"
        )
    if scale.dtype != torch.float32 or scale.numel() != n:
        raise ValueError(
            f"int8_matmul: scale must be f32 with {n} values,"
            f" got {scale.dtype} {tuple(scale.shape)}"
        )
    if out_dtype not in (x.dtype, torch.float32):
        raise ValueError(f"int8_matmul: the output is x's dtype or f32, not {out_dtype}")
    for name, t in (("x", x), ("q", q), ("scale", scale)):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"int8_matmul: {name} must lie on x's CUDA device ({t.device})")
        if not t.is_contiguous():
            raise ValueError(f"int8_matmul: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"int8_matmul: {name} must be 16-byte aligned")
    if k % 8 or n % 16:
        raise ValueError(f"int8_matmul: K must be a multiple of 8 and N of 16, got {k}, {n}")
    raise AssertionError("unreachable: the inputs passed every check")


def _check_int8_matmul(x, q, scale, out_dtype) -> None:  # noqa: ANN001
    """Raise unless the kernel takes these inputs: x bf16 or f32 and q a
    2-D int8 [K, N] on x's CUDA device, scale f32 with N values, out_dtype
    x's or f32, all contiguous and 16-byte aligned, K % 8 == 0, N % 16 ==
    0. One expression on the way through; the message is built only on
    the way out."""
    dev = x.device
    if not (
        x.is_cuda and q.device == dev and scale.device == dev
        and x.dtype in _X_DTYPES and q.dtype == torch.int8 and scale.dtype == torch.float32
        and q.dim() == 2 and x.dim() >= 1 and x.shape[-1] == q.shape[0]
        and scale.numel() == q.shape[1] and (out_dtype == x.dtype or out_dtype == torch.float32)
        and not (q.shape[0] % 8 or q.shape[1] % 16)
        and x.is_contiguous() and q.is_contiguous() and scale.is_contiguous()
        and not (x.data_ptr() % 16 or q.data_ptr() % 16 or scale.data_ptr() % 16)
    ):
        _explain_bad_inputs(x, q, scale, out_dtype)


#: Launch plans by (M, N, K, x's dtype, out dtype, device): a decode step
#: calls the same few shapes each time.
_PLANS: dict[tuple, Plan] = {}


class _Scratch:
    """The split-k workspace (f32) and tile counters (int32, left at 0 by
    every call) of one (device, stream). They grow when a call needs more
    and are never allocated per call: the kernels of one stream run in
    order, so each call finds the counters at 0."""

    __slots__ = ("work", "counters")

    def __init__(self) -> None:
        self.work: Optional[torch.Tensor] = None
        self.counters: Optional[torch.Tensor] = None

    def fit(self, plan: Plan, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
        if self.work is None or self.work.numel() < plan.work:
            self.work = torch.empty(plan.work, dtype=torch.float32, device=device)
        if self.counters is None or self.counters.numel() < plan.counters:
            self.counters = torch.zeros(plan.counters, dtype=torch.int32, device=device)
        return self.work, self.counters


#: Scratch by (device index, stream handle).
_SCRATCH: dict[tuple[int, int], _Scratch] = {}


def _int8_matmul_cuda(x, q, scale, out_dtype):  # noqa: ANN001, ANN202
    """Launch ``csrc/int8_matmul.cu``: one kernel per call, whatever the
    path and split; nothing allocated but the output once the call's
    shape has run on this stream."""
    _check_int8_matmul(x, q, scale, out_dtype)
    dev = x.device
    k, n = q.shape
    m = x.numel() // k
    y = torch.empty((*x.shape[:-1], n), dtype=out_dtype, device=dev)
    if m == 0:
        return y
    idx = dev.index
    key = (m, n, k, x.dtype, out_dtype, idx)
    plan = _PLANS.get(key)
    if plan is None:
        sms = torch.cuda.get_device_properties(idx).multi_processor_count
        plan = _PLANS[key] = launch_plan(m, n, k, x.dtype == torch.float32, sms,
                                         out_dtype == torch.float32)
    stream = torch._C._cuda_getCurrentRawStream(idx)
    work_ptr = counters_ptr = None
    if plan.splits > 1:
        scratch = _SCRATCH.get((idx, stream))
        if scratch is None:
            scratch = _SCRATCH[(idx, stream)] = _Scratch()
        work, counters = scratch.fit(plan, dev)
        work_ptr, counters_ptr = work.data_ptr(), counters.data_ptr()
    rc = _build.cuda_lib().tpx_int8_matmul(
        x.data_ptr(), q.data_ptr(), scale.data_ptr(), y.data_ptr(), work_ptr, counters_ptr,
        m, n, k, plan.path, plan.block_m, out_dtype == torch.float32, plan.splits, plan.per,
        stream,
    )
    name = kernel_name(x.dtype)
    if rc:
        _build.check(rc, name)
    _build.count_launch(name)
    return y


def int8_matmul(
    x: torch.Tensor,  # [..., in] bf16 / f32
    q: torch.Tensor,  # [in, out] int8
    scale: torch.Tensor,  # [1, out] f32
    out_dtype: Optional[torch.dtype] = None,  # default: x.dtype
) -> torch.Tensor:
    """``x @ dequantize(q, scale)`` with the f32 sum rescaled after the
    contraction. ``out_dtype=torch.float32`` keeps the f32 result (the lm
    head: logits must not round through bf16). On CUDA tensors the
    hand-written kernel, else the plain version."""
    if x.is_cuda or q.is_cuda or scale.is_cuda:
        return _int8_matmul_cuda(x, q, scale, out_dtype or x.dtype)
    return _int8_matmul_plain(x, q, scale, out_dtype)


# ---------------------------------------------------------------------------
# the int8 training dot (AQT config_v4's numerics)
# ---------------------------------------------------------------------------

_DOT_CALLS = {"int8_dot": 0}


def int8_dot_calls() -> int:
    """How many int8 x int8 -> int32 products the training dot has run
    (forward and both backward products each count one)."""
    return _DOT_CALLS["int8_dot"]


def reset_int8_dot_calls() -> None:
    _DOT_CALLS["int8_dot"] = 0


def _aqt_quantize(t: torch.Tensor, dim: int) -> tuple[torch.Tensor, torch.Tensor]:
    """AQT's absmax calibration along ``dim`` (the product's contracting
    axis) and ``IntSymmetric(8, preserve_zero, not preserve_max_val)``,
    in ``t``'s dtype: -> (int8, scale in t's dtype, ``dim`` kept as 1)."""
    absmax = t.abs().amax(dim=dim, keepdim=True)
    absmax = torch.where(absmax == 0, torch.ones_like(absmax), absmax)
    scale = _div(absmax, 127.5)
    inv = torch.reciprocal(scale)
    inv = torch.where(torch.isinf(inv), torch.ones_like(inv), inv)
    q = torch.round(torch.clamp(t * inv, -127.0, 127.0)).to(torch.int8)
    return q, scale


def _int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 [m, k] x int8 [k, n] -> int32 through ``torch._int_mm``, the
    left operand row-major and the right column-major (cuBLASLt's int8
    layout). On the card cuBLASLt takes m > 16 and k, n multiples of 8; a
    product outside those rules raises, never falls back."""
    m, k = a.shape
    n = b.shape[1]
    if a.is_cuda and (m <= 16 or k % 8 or n % 8):
        raise ValueError(
            f"int8 training dot: torch._int_mm on CUDA needs m > 16 and k, n multiples"
            f" of 8; got m={m}, k={k}, n={n}"
        )
    _DOT_CALLS["int8_dot"] += 1
    return torch._int_mm(a.contiguous(), b.t().contiguous().t())


def _rescale(
    acc: torch.Tensor, s_lhs: torch.Tensor, s_rhs: torch.Tensor, dtype: torch.dtype
) -> torch.Tensor:
    """AQT's ``QTensor.dequant`` of the int32 sum: cast to the operands'
    dtype, times the left operand's scale, then the right's."""
    return acc.to(dtype) * s_lhs * s_rhs


class _Int8Dot(torch.autograd.Function):
    """``x [m, k] @ w [k, n]``, forward and backward in int8 (AQT
    ``config_v4``, deterministic rounding, straight-through gradient)."""

    @staticmethod
    def forward(ctx, x, w):  # noqa: ANN001, ANN205
        ctx.save_for_backward(x, w)
        qx, sx = _aqt_quantize(x, 1)  # per row of x
        qw, sw = _aqt_quantize(w, 0)  # per column of w
        return _rescale(_int_mm(qx, qw), sx, sw, x.dtype)

    @staticmethod
    def backward(ctx, g):  # noqa: ANN001, ANN205
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            # dlhs = g . w^T, contracting over n
            qg, sg = _aqt_quantize(g, 1)
            qw, sw = _aqt_quantize(w, 1)
            dx = _rescale(_int_mm(qg, qw.t()), sg, sw.t(), x.dtype)
        if ctx.needs_input_grad[1]:
            # drhs = x^T . g, contracting over m; AQT computes (g^T x)^T,
            # so g is the left operand of the rescale
            qg, sg = _aqt_quantize(g, 0)
            qx, sx = _aqt_quantize(x, 0)
            dw = _rescale(_int_mm(qx.t(), qg), sg, sx.t(), w.dtype)
        return dx, dw


def int8_dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x [..., k] @ w [k, n]`` through the int8 training dot."""
    if x.dtype != w.dtype:
        raise ValueError(f"int8 training dot: x and w must share a dtype ({x.dtype}, {w.dtype})")
    y = _Int8Dot.apply(x.reshape(-1, x.shape[-1]), w)
    return y.reshape(*x.shape[:-1], w.shape[1])


def maybe_matmul(
    x: torch.Tensor,
    w: Any,
    out_dtype: Optional[torch.dtype] = None,
    int8_training: bool = False,
) -> torch.Tensor:
    """``x @ w`` for a plain matrix or a quantized ``{"q", "scale"}``
    record, so one model body serves both. ``int8_training=True`` routes a
    plain matrix through the int8 training dot (forward and backward in
    int8)."""
    if isinstance(w, dict) and "q" in w:
        return int8_matmul(x, w["q"], w["scale"], out_dtype=out_dtype)
    if int8_training:
        return int8_dot(x, w).to(out_dtype or x.dtype)
    y = x @ w
    return y.to(out_dtype) if out_dtype is not None else y
