"""Fused training kernels: flash attention and residual-add + RMSNorm.

Port of :mod:`torchx_tpu.ops.fused`, the ``--kernels cuda`` hot path:

* :func:`flash_attention` — two ``torch.library`` operators over CUDA C++
  kernels, ``tpx::flash_fwd`` (O and ``lse`` in f32, the residuals the
  backward reads) with its autograd formula, and ``tpx::flash_bwd``, the
  standard two-kernel backward, ``delta = rowsum(dO * O)`` computed outside
  the kernels, one
  kernel accumulating ``dq`` over kv tiles and one accumulating
  ``dk``/``dv`` over q tiles and over the query heads that share a KV head
  (native GQA: KV is never repeated). Each kernel comes in variants,
  chosen per kernel by the static rule :func:`flash_variant`: ``wgmma``
  on the tensor cores for bf16 at head_dim 64 and 128
  (``csrc/flash_fwd_wgmma.cu``, ``csrc/flash_dq_wgmma.cu``,
  ``csrc/flash_dkv_wgmma.cu``); elsewhere (f32, and bf16 at head_dim 256)
  ``mma``, on the tensor cores by mma.sync, f32 in three TF32 passes
  (``csrc/flash_fwd_mma.cu``, ``csrc/flash_dq_mma.cu``,
  ``csrc/flash_dkv_mma.cu``). The wgmma
  kernels take their tile as a launch setting, ``block_q`` / ``block_kv``
  as the JAX package's Pallas grids name them
  (``LlamaConfig.attn_block_q/kv``), each launch at the compiled tile
  :func:`fit_tile` gives (0: the card's default, :data:`DEFAULT_TILES`);
  the mma kernels have one tile each. Optional ``segment_ids``
  (``[b, s]`` int32, one array for queries and keys, as the JAX package
  hands ``SegmentIds(q=seg, kv=seg)`` to the library splash kernel) mask
  packed documents: a query sees only keys of its own segment, in all
  three kernels, so pairs across documents get exactly zero gradient.
* :func:`rms_norm_residual` — ``s = x + residual`` in the input dtype, then
  ``y = rms_norm(s) * w`` in f32, one Triton pass returning ``(y, s)``
  (the operator ``tpx::norm_res_fwd``). Its backward runs the RMSNorm dx+dw
  kernel of :mod:`.norms` (``tpx::rms_norm_bwd``) on ``s`` and sends the
  ``s`` cotangent through both inputs.

Each operator has a fake implementation that allocates what its kernel
allocates: meta tensors run it (the fit probe, :mod:`torchx_tpu_torch.parallel.aot_fit`),
and a remat policy sees each forward as one operator (``"dots_attn"``
saves the flash forward's outputs).

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
from torchx_tpu_torch.ops.norms import _check_rows, _rms_norm_fwd_math, rms_norm_bwd_op

#: The "already softmax-dead" constant the plain attention uses.
NEG_INF = -1e30

#: Head dims the flash kernels tile.
FLASH_HEAD_DIMS = (64, 128, 256)

#: Head dims of the tensor-core (wgmma) flash kernels.
WGMMA_HEAD_DIMS = (64, 128)

FLASH_VARIANTS = ("wgmma", "mma")
FLASH_KERNELS = ("flash_fwd", "flash_dq", "flash_dkv")

#: The flash kernels' tiles, as the JAX package's Pallas grids name them
#: (``torchx_tpu/ops/fused.py`` ``_flash_fwd`` / ``_flash_bwd``):
#: ``block_q`` is the query rows a forward or dq CTA owns and the query rows
#: a dk/dv step streams; ``block_kv`` the kv rows a forward or dq step
#: streams and the kv rows a dk/dv CTA owns. The wgmma kernels' compiled
#: tiles, ``(block_q values, block_kv values)`` by kernel and head dim, each
#: pair an instance of ``csrc/flash_*_wgmma.cuh`` (``TPX_FLASH_*_TILES``;
#: tests/test_torch_flash_tiles.py holds the two equal).
WGMMA_TILES = {
    ("flash_fwd", 64): ((64, 128), (64, 128)),
    ("flash_fwd", 128): ((64, 128), (64, 128)),
    ("flash_dq", 64): ((64, 128), (64, 128)),
    ("flash_dq", 128): ((64, 128), (64, 128)),
    ("flash_dkv", 64): ((32, 64), (64, 128)),
    ("flash_dkv", 128): ((32,), (64, 128)),
}
#: The tile a request of 0 takes, by kernel and head dim: the fastest of
#: ``chip_smoke.py --phases build,sweep`` at llama3_1b's attention shape
#: (head_dim 64) and Mixtral's (128), b 4, s 2048, causal, where it beats
#: the kernels' first tiles by more than their 3% spread between calls. On
#: an H100 80GB HBM3 at 700 W (ms, first tiles in brackets): head_dim 64,
#: forward 0.2783 (128, 128: 0.3043), dq 0.2718 (128, 128: 0.3127), dk/dv
#: 0.5195 (64, 128: 0.5545); head_dim 128, forward 0.4183 (the first tile),
#: dq 0.4624 (128, 64: 0.5107), dk/dv 0.9551 (32, 128: 1.0329).
DEFAULT_TILES = {
    ("flash_fwd", 64): (64, 64), ("flash_fwd", 128): (128, 128),
    ("flash_dq", 64): (64, 64), ("flash_dq", 128): (128, 128),
    ("flash_dkv", 64): (64, 64), ("flash_dkv", 128): (32, 64),
}
#: The mma kernels' one tile ``(block_q, block_kv)`` by kernel, dtype and
#: head dim, each an instance of ``csrc/flash_*_mma.cuh``
#: (``TPX_FLASH_*_MMA_TILES``; tests/test_torch_flash_tf32.py holds the two
#: equal): every request fits to it. The forward's and dk/dv's each picked
#: from a grid that ptxas compiled (``nvcc -Xptxas -v``) among those without
#: spills whose tiles and their two-stage ring fit a block's 227 KB; dq's
#: the fastest of such a grid on an H100 (``chip_smoke.py --phases
#: build,dqgrid``).
MMA_TILES = {
    ("flash_fwd", torch.float32, 64): (64, 64),
    ("flash_fwd", torch.float32, 128): (64, 32),
    ("flash_fwd", torch.float32, 256): (64, 32),
    ("flash_fwd", torch.bfloat16, 256): (64, 32),
    ("flash_dq", torch.float32, 64): (128, 64),
    ("flash_dq", torch.float32, 128): (128, 32),
    ("flash_dq", torch.float32, 256): (32, 32),
    ("flash_dq", torch.bfloat16, 256): (64, 16),
    ("flash_dkv", torch.float32, 64): (32, 64),
    ("flash_dkv", torch.float32, 128): (16, 64),
    ("flash_dkv", torch.float32, 256): (32, 32),
    ("flash_dkv", torch.bfloat16, 256): (32, 64),
}

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


def flash_variant(kernel: str, dtype: torch.dtype, head_dim: int) -> str:
    """Which kernel ``kernel`` ("flash_fwd", "flash_dq" or "flash_dkv")
    launches on a CUDA tensor.

    ``"wgmma"`` (tensor cores, TMA-fed) for bf16 at head_dim 64 and 128,
    the llama3_1b and llama3_8b shapes, where the three wgmma kernels build
    without spills (``nvcc -Xptxas -v``, printed by chip_smoke.py's build
    phase). Elsewhere, f32 (whose products the bf16 tensor cores cannot
    take) and bf16 at head_dim 256 (where a wgmma warpgroup's O or dK/dV
    accumulators alone would take 256 registers a thread): ``"mma"``
    (mma.sync on the tensor cores, f32 in three TF32 passes). A rule on
    kernel, dtype and shape alone: no launch is ever retried on another
    variant."""
    if kernel not in FLASH_KERNELS:
        raise ValueError(f"flash attention: kernel must be one of {FLASH_KERNELS}")
    if dtype == torch.bfloat16 and head_dim in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "mma"


def check_tiles(block_q: int, block_kv: int) -> None:
    """A tile request is a row count, or 0 for the card's default."""
    for name, v in (("block_q", block_q), ("block_kv", block_kv)):
        if not isinstance(v, int) or v < 0:
            raise ValueError(f"flash attention: {name} must be an int >= 0, got {v!r}")


def _fit(requested: int, seq: int, tiles: tuple[int, ...]) -> int:
    """The JAX package's ``_fit_block`` on the compiled tiles: the largest
    one at most ``requested`` (clamped up to the smallest, as the JAX rule
    clamps up to 128 lanes) that divides ``seq``."""
    want = max(requested, tiles[0])
    fits = [t for t in tiles if t <= want and seq % t == 0]
    if not fits:
        raise ValueError(f"flash attention: no tile of {tiles} divides sequence {seq}")
    return fits[-1]


def fit_tile(kernel: str, variant: str, head_dim: int, seq: int, block_q: int = 0,
             block_kv: int = 0, dtype: Optional[torch.dtype] = None) -> tuple[int, int]:
    """The tile ``(block_q, block_kv)`` that ``kernel`` ("flash_fwd",
    "flash_dq" or "flash_dkv") of ``variant`` launches with at ``head_dim``
    and sequence ``seq`` for a request (0: :data:`DEFAULT_TILES`' value on
    that axis). For wgmma each axis takes the largest compiled tile at most
    the request that divides ``seq`` (:func:`_fit`); nothing else changes a
    tile. The mma kernels have one tile by ``dtype`` (:data:`MMA_TILES`)."""
    check_tiles(block_q, block_kv)
    if variant not in FLASH_VARIANTS:
        raise ValueError(f"flash attention: variant must be one of {FLASH_VARIANTS}")
    if variant == "mma":
        if (kernel, dtype, head_dim) not in MMA_TILES:
            raise ValueError(f"flash attention: no mma kernel for {kernel} in {dtype} at"
                             f" head_dim {head_dim}")
        return MMA_TILES[(kernel, dtype, head_dim)]
    q_tiles, kv_tiles = WGMMA_TILES[(kernel, head_dim)]
    dq, dkv = DEFAULT_TILES[(kernel, head_dim)]
    return _fit(block_q or dq, seq, q_tiles), _fit(block_kv or dkv, seq, kv_tiles)


def norm_shapes_ok(d: int) -> bool:
    """Static gate for the fused norm kernel: lane-aligned feature dim."""
    return d % 128 == 0


# ---------------------------------------------------------------------------
# flash attention: plain versions (CPU tensors, and the card's comparison)
# ---------------------------------------------------------------------------


def _scores(q, k, causal, segment_ids=None):  # noqa: ANN001, ANN202
    """f32 logits [b, h, s, s] of q*scale against the repeated k, masked
    (causally, and across segments where ``segment_ids`` [b, s] is
    given)."""
    scale = q.shape[-1] ** -0.5
    kf = _repeat_kv(k, q.shape[2] // k.shape[2]).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, kf)
    if causal:
        keep = torch.ones(s.shape[-2:], dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, NEG_INF)
    if segment_ids is not None:
        same = segment_ids[:, :, None] == segment_ids[:, None, :]
        s = s.masked_fill(~same[:, None], NEG_INF)
    return s


def _flash_fwd_plain(q, k, v, causal, segment_ids=None):  # noqa: ANN001, ANN202
    """-> (o f32 [b, s, h, d], lse f32 [b, h, s])."""
    s = _scores(q, k, causal, segment_ids)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)  # noqa: E741
    vf = _repeat_kv(v, q.shape[2] // v.shape[2]).float()
    acc = torch.einsum("bhqk,bkhd->bhqd", p, vf)
    return (acc / l).transpose(1, 2).contiguous(), (m + torch.log(l))[..., 0]


def _probs_and_ds(q, k, v, do, lse, delta, causal, segment_ids):  # noqa: ANN001, ANN202
    p = torch.exp(_scores(q, k, causal, segment_ids) - lse[..., None])
    vf = _repeat_kv(v, q.shape[2] // v.shape[2]).float()
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), vf)
    return p, p * (dp - delta[..., None])


def _fold_heads(x, kv_heads):  # noqa: ANN001, ANN202
    """[b, s, h, d] per query head -> [b, s, kv_heads, d], summed over the
    query heads sharing each KV head (the transpose of _repeat_kv)."""
    b, s, h, d = x.shape
    return x.reshape(b, s, kv_heads, h // kv_heads, d).sum(dim=3)


def _flash_dq_plain(q, k, v, do, lse, delta, causal, segment_ids=None):  # noqa: ANN001, ANN202
    _, ds = _probs_and_ds(q, k, v, do, lse, delta, causal, segment_ids)
    kf = _repeat_kv(k, q.shape[2] // k.shape[2]).float()
    return torch.einsum("bhqk,bkhd->bqhd", ds, kf) * q.shape[-1] ** -0.5


def _flash_dkv_plain(q, k, v, do, lse, delta, causal, segment_ids=None):  # noqa: ANN001, ANN202
    p, ds = _probs_and_ds(q, k, v, do, lse, delta, causal, segment_ids)
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


def _check_segments(segment_ids, q):  # noqa: ANN001, ANN202
    """The kernels take int32 ids [b, s], contiguous, on q's device, 16-byte
    aligned (the wgmma kernels bring them by bulk copy)."""
    b, s = q.shape[:2]
    if segment_ids.dtype != torch.int32 or tuple(segment_ids.shape) != (b, s):
        raise ValueError(
            f"flash attention: segment_ids must be int32 [{b}, {s}], got"
            f" {segment_ids.dtype} {tuple(segment_ids.shape)}"
        )
    if segment_ids.device != q.device or not segment_ids.is_contiguous():
        raise ValueError("flash attention: segment_ids must be contiguous on q's device")
    if segment_ids.data_ptr() % 16:
        raise ValueError("flash attention: segment_ids must be 16-byte aligned")


def _dims(q, k, v, causal, *more):  # noqa: ANN001, ANN202
    b, s, h, kvh, d = _check_flash(q, k, v, *more)
    return [b, s, h, kvh, d, int(causal), _DTYPE_CODE[q.dtype]]


def _pick_variant(kernel, variant, tensors):  # noqa: ANN001, ANN202
    """The variant ``kernel`` launches: ``variant`` if given (chip_smoke.py
    and the card tests name it), else :func:`flash_variant`; refused where
    that variant has no kernel for the dtype and head dim. The wgmma and
    mma kernels' TMA needs 16-byte aligned tensors."""
    q = tensors[0]
    dtype, d = q.dtype, q.shape[-1]
    variant = variant or flash_variant(kernel, dtype, d)
    if variant not in FLASH_VARIANTS:
        raise ValueError(f"flash attention: variant must be one of {FLASH_VARIANTS}")
    if variant == "wgmma" and (dtype != torch.bfloat16 or d not in WGMMA_HEAD_DIMS):
        raise ValueError(
            f"flash attention: the wgmma kernels take bf16 at head_dim"
            f" {WGMMA_HEAD_DIMS}, got {dtype} at {d}"
        )
    if variant == "mma" and (kernel, dtype, d) not in MMA_TILES:
        raise ValueError(
            f"flash attention: the mma kernels take f32 at head_dim {FLASH_HEAD_DIMS}"
            f" and bf16 at 256, got {kernel} in {dtype} at {d}"
        )
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"flash attention: {variant} needs 16-byte aligned tensors")
    return variant


def _launch(kernel, variant, inputs, outputs, causal, segment_ids=None, tile=(0, 0)):  # noqa: ANN001, ANN202
    """Launch ``kernel`` ("flash_fwd", "flash_dq" or "flash_dkv") of the
    chosen variant on CUDA tensors: inputs (q, k, v[, do, lse, delta]),
    then the outputs and the segment ids (null for none), all as pointers,
    then the dims and the tile :func:`fit_tile` gives for the request
    ``tile`` (block_q, block_kv)."""
    seg_ptr = None
    if segment_ids is not None:
        _check_segments(segment_ids, inputs[0])
        seg_ptr = segment_ids.data_ptr()
    dims = _dims(*inputs[:3], causal, *inputs[3:])
    variant = _pick_variant(kernel, variant, inputs)
    q = inputs[0]
    tile = fit_tile(kernel, variant, q.shape[-1], q.shape[1], *tile, dtype=q.dtype)
    fn = getattr(_build.cuda_lib(), f"tpx_{kernel}_{variant}")
    dims += tile
    dims.append(torch.cuda.current_stream(q.device).cuda_stream)
    with torch.cuda.device(q.device):
        rc = fn(*(t.data_ptr() for t in (*inputs, *outputs)), seg_ptr, *dims)
    name = f"{kernel}_{variant}" + ("" if segment_ids is None else "_seg")
    _build.check(rc, name)
    _build.count_launch(name)


def _flash_fwd(q, k, v, causal, segment_ids=None, variant=None, tile=(0, 0)):  # noqa: ANN001, ANN202
    """[b, s, h, d], [b, s, kvh, d] x2 (, int32 segment ids [b, s]) ->
    (o f32 [b, s, h, d], lse f32 [b, h, s]). ``tile``: the (block_q,
    block_kv) request (:func:`fit_tile`); the plain version has none."""
    if q.device.type == "cpu":
        check_tiles(*tile)
        return _flash_fwd_plain(q, k, v, causal, segment_ids)
    b, s, h = q.shape[:3]
    o = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    _launch("flash_fwd", variant, (q, k, v), (o, lse), causal, segment_ids, tile)
    return o, lse


def _flash_dq(q, k, v, do, lse, delta, causal, segment_ids=None, variant=None, tile=(0, 0)):  # noqa: ANN001, ANN202
    """-> dq f32 [b, s, h, d]."""
    if q.device.type == "cpu":
        check_tiles(*tile)
        return _flash_dq_plain(q, k, v, do, lse, delta, causal, segment_ids)
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    _launch("flash_dq", variant, (q, k, v, do, lse, delta), (dq,), causal, segment_ids, tile)
    return dq


def _flash_dkv(q, k, v, do, lse, delta, causal, segment_ids=None, variant=None, tile=(0, 0)):  # noqa: ANN001, ANN202
    """-> (dk, dv) f32 [b, s, kvh, d], summed over each KV head's query
    heads."""
    if q.device.type == "cpu":
        check_tiles(*tile)
        return _flash_dkv_plain(q, k, v, do, lse, delta, causal, segment_ids)
    dk = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty(v.shape, dtype=torch.float32, device=q.device)
    _launch("flash_dkv", variant, (q, k, v, do, lse, delta), (dk, dv), causal, segment_ids,
            tile)
    return dk, dv


def _flash_delta(do, o_f32):  # noqa: ANN001, ANN202
    """delta = rowsum(dO * O) in f32, [b, s, h, d] -> [b, h, s]."""
    return (do.float() * o_f32).sum(dim=-1).transpose(1, 2).contiguous()


@torch.library.custom_op("tpx::flash_fwd", mutates_args=())
def flash_fwd_op(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
    segment_ids: Optional[torch.Tensor], block_q: int, block_kv: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The flash forward as one operator: -> (o f32 [b, s, h, d], lse f32
    [b, h, s]), the backward's residuals. A remat policy saves these two
    outputs as one op's (``"dots_attn"``), and the fit probe traces the
    op's fake implementation on meta tensors. ``block_q``/``block_kv``:
    the tile request (:func:`fit_tile`)."""
    return _flash_fwd(q, k, v, causal, segment_ids, tile=(block_q, block_kv))


@flash_fwd_op.register_fake
def _(q, k, v, causal, segment_ids, block_q, block_kv):  # noqa: ANN001, ANN202
    b, s, h = q.shape[:3]
    return (q.new_empty(q.shape, dtype=torch.float32),
            q.new_empty((b, h, s), dtype=torch.float32))


@torch.library.custom_op("tpx::flash_bwd", mutates_args=())
def flash_bwd_op(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
    do: torch.Tensor, causal: bool, segment_ids: Optional[torch.Tensor], block_q: int,
    block_kv: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The flash backward as one operator: ``delta``, then the dq kernel
    and the dk/dv kernel, each at the tile the request fits to. -> (dq,
    dk, dv) f32."""
    delta = _flash_delta(do, o)
    tile = (block_q, block_kv)
    dq = _flash_dq(q, k, v, do, lse, delta, causal, segment_ids, tile=tile)
    dk, dv = _flash_dkv(q, k, v, do, lse, delta, causal, segment_ids, tile=tile)
    return dq, dk, dv


@flash_bwd_op.register_fake
def _(q, k, v, o, lse, do, causal, segment_ids, block_q, block_kv):  # noqa: ANN001, ANN202
    return (q.new_empty(q.shape, dtype=torch.float32),
            k.new_empty(k.shape, dtype=torch.float32),
            v.new_empty(v.shape, dtype=torch.float32))


def _flash_setup(ctx, inputs, output):  # noqa: ANN001, ANN202
    q, k, v, causal, segment_ids, block_q, block_kv = inputs
    ctx.save_for_backward(q, k, v, *output, segment_ids)
    ctx.causal, ctx.tile = causal, (block_q, block_kv)
    ctx.set_materialize_grads(False)  # lse gets no gradient


def _flash_backward(ctx, do, _dlse):  # noqa: ANN001, ANN202
    q, k, v, o, lse, segment_ids = ctx.saved_tensors
    # the kernels take dO in q's dtype: the gradient of o's cast to it, back
    do = do.to(q.dtype).contiguous()
    dq, dk, dv = flash_bwd_op(q, k, v, o, lse, do, ctx.causal, segment_ids, *ctx.tile)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None, None


flash_fwd_op.register_autograd(_flash_backward, setup_context=_flash_setup)


def flash_attention(
    q: torch.Tensor,  # [b, s, h, d]
    k: torch.Tensor,  # [b, s, kv_h, d]
    v: torch.Tensor,
    causal: bool = True,
    kernels: str = "cuda",
    segment_ids: Optional[torch.Tensor] = None,  # [b, s] int32
    block_q: int = 0,
    block_kv: int = 0,
) -> Optional[torch.Tensor]:
    """Flash attention, or ``None`` when the gate says "use the plain path":
    ``kernels`` is not "cuda", the shapes fail :func:`flash_shapes_ok`, or
    the query heads are not a multiple of the KV heads. ``segment_ids``
    masks packed documents (the kernels check their dtype and shape).
    ``block_q``/``block_kv`` request the kernels' tile (0: the card's
    default), each kernel launching at the tile :func:`fit_tile` gives."""
    check_tiles(block_q, block_kv)
    if kernels != "cuda":
        return None
    if not flash_shapes_ok(q.shape[1], k.shape[1], q.shape[-1]):
        return None
    if q.shape[2] % k.shape[2]:
        return None
    if segment_ids is not None:
        segment_ids = segment_ids.contiguous()
        # refused before the operator, whose fake implementation (meta
        # tensors, the fit probe) checks nothing
        _check_segments(segment_ids, q)
    o, _ = flash_fwd_op(q.contiguous(), k.contiguous(), v.contiguous(), causal, segment_ids,
                        block_q, block_kv)
    return o.to(q.dtype)


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


@torch.library.custom_op("tpx::norm_res_fwd", mutates_args=())
def norm_res_fwd_op(
    x: torch.Tensor, residual: torch.Tensor, weight: torch.Tensor, eps: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The fused residual-add + RMSNorm forward as one operator: -> (y, s)
    in x's shape and dtype."""
    d = x.shape[-1]
    y, s = _norm_res_fwd(x.reshape(-1, d), residual.reshape(-1, d), weight, eps)
    return y.reshape(x.shape), s.reshape(x.shape)


@norm_res_fwd_op.register_fake
def _(x, residual, weight, eps):  # noqa: ANN001, ANN202
    return torch.empty_like(x), torch.empty_like(x)


def _norm_res_setup(ctx, inputs, output):  # noqa: ANN001, ANN202
    _, _, weight, eps = inputs
    ctx.save_for_backward(output[1], weight)
    ctx.eps = eps


def _norm_res_backward(ctx, dy, ds_out):  # noqa: ANN001, ANN202
    s, weight = ctx.saved_tensors
    # the dx+dw kernel of ops/norms runs on the summed stream s; the extra
    # ds_out cotangent (s is also an output) adds straight through
    dx, dw = rms_norm_bwd_op(s, dy, weight, ctx.eps)
    ds = dx.to(s.dtype) + ds_out
    return ds, ds, dw.to(weight.dtype), None


norm_res_fwd_op.register_autograd(_norm_res_backward, setup_context=_norm_res_setup)


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
    return norm_res_fwd_op(x.contiguous(), residual.contiguous(), weight, eps)


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
