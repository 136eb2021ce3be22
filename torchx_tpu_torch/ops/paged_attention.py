"""Paged (block-table) KV-cache attention for continuous-batching decode.

Port of :mod:`torchx_tpu.ops.paged_attention`. K and V live in one pool
per layer, ``[num_blocks, block_size, kvh, hd]``; a slot's block table
maps its logical positions to physical blocks. Block 0 is the trash block:
unassigned table entries point at it, writes from inactive slots land in
it, and the length mask keeps it out of every softmax.

The writers (:func:`append_kv`, :func:`scatter_kv_chunk`,
:func:`write_prefill`) update the pool **in place** and return it: the JAX
engine donates its pools so that XLA writes them in place, and an
out-of-place write here would copy the whole pool for every layer at every
step.

JAX clamps an out-of-range gather and drops an out-of-range scatter;
torch raises on the CPU and asserts on the device, which poisons the CUDA
context. So every public function here checks its block ids and positions
first (:func:`check_range`, one host sync for a CUDA tensor) and raises
``IndexError`` before any kernel indexes with them.

The attention scores are f32 from bf16 operands, as the JAX einsums'
``preferred_element_type=float32`` (:func:`matmul_f32`); GQA views the
query heads as ``[kvh, n_rep]`` against the un-repeated cache, which
computes the JAX package's repeat-then-attend function without
materialising the repeat.
"""

from __future__ import annotations

from typing import Optional

import torch

#: Physical block index every unassigned block-table entry points at.
#: Writes from inactive/padded slots land here; masked attention never
#: reads it as valid context.
TRASH_BLOCK = 0

_MASKED = -1e30


def check_range(*checks: tuple[str, torch.Tensor, int]) -> None:
    """Raise ``IndexError`` unless every entry of each ``(name, idx, hi)``
    lies in ``[0, hi)``. All are reduced together, so CUDA tensors cost one
    sync, taken before any kernel indexes with them."""
    live = [c for c in checks if c[1].numel()]
    if not live:
        return
    bad = torch.stack([((idx < 0) | (idx >= hi)).any() for _, idx, hi in live])
    if bool(bad.any()):
        name, idx, hi = live[int(bad.int().argmax())]
        raise IndexError(
            f"{name}: index out of range [0, {hi}): min {int(idx.min())},"
            f" max {int(idx.max())}"
        )


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with f32 output, as a JAX einsum with
    ``preferred_element_type=float32``: products of bf16 inputs are exact
    in f32, sums run in f32. On CUDA a bf16/f16 pair takes cuBLAS's f32
    output directly (``out_dtype``); elsewhere the operands are upcast
    (exact) and multiplied in f32. TF32 must stay off (torch's default)."""
    if a.is_cuda and a.dtype in (torch.bfloat16, torch.float16) and a.dtype == b.dtype:
        if a.dim() == 2:
            return torch.mm(a, b, out_dtype=torch.float32)
        lead = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
        a3 = a.expand(*lead, *a.shape[-2:]).reshape(-1, *a.shape[-2:])
        b3 = b.expand(*lead, *b.shape[-2:]).reshape(-1, *b.shape[-2:])
        out = torch.bmm(a3, b3, out_dtype=torch.float32)
        return out.reshape(*lead, *out.shape[-2:])
    return a.float() @ b.float()


def gather_kv(pool: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """Gather one layer's pooled K (or V) into per-slot contiguous views.

    ``pool``: ``[num_blocks, block_size, kvh, hd]``; ``tables``:
    ``[slots, blocks_per_slot]`` physical block ids. Returns
    ``[slots, blocks_per_slot * block_size, kvh, hd]``: position ``p`` of
    slot ``i`` is ``pool[tables[i, p // bs], p % bs]``.
    """
    check_range(("gather_kv tables", tables, pool.shape[0]))
    return _gather(pool, tables)


def _gather(pool: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    slots, bpr = tables.shape
    _, bs, kvh, hd = pool.shape
    return pool[tables].reshape(slots, bpr * bs, kvh, hd)


def _attend(
    q: torch.Tensor,  # [slots, t, h, hd]
    k: torch.Tensor,  # [slots, S, kvh, hd] gathered
    v: torch.Tensor,
    visible: torch.Tensor,  # [slots, t, S] bool
) -> torch.Tensor:
    """Masked softmax attention of ``t`` query tokens per slot over the
    gathered cache, GQA as a ``[kvh, n_rep]`` view of the query heads.
    -> ``[slots, t, h, hd]``."""
    slots, t, h, d = q.shape
    kvh = k.shape[2]
    n_rep = h // kvh
    # [slots, kvh, n_rep * t, hd]: query head j reads KV head j // n_rep
    qg = q.reshape(slots, t, kvh, n_rep, d).permute(0, 2, 3, 1, 4)
    qg = qg.reshape(slots, kvh, n_rep * t, d)
    kt = k.permute(0, 2, 3, 1)  # [slots, kvh, hd, S]
    logits = matmul_f32(qg, kt) * d**-0.5  # [slots, kvh, n_rep * t, S]
    logits = logits.view(slots, kvh, n_rep, t, -1)
    logits.masked_fill_(~visible[:, None, None], _MASKED)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = probs.view(slots, kvh, n_rep * t, -1) @ v.permute(0, 2, 1, 3)
    out = out.view(slots, kvh, n_rep, t, d).permute(0, 3, 1, 2, 4)
    return out.reshape(slots, t, h, d)


def paged_attention(
    q: torch.Tensor,  # [slots, h, hd] — ONE query token per slot
    k_pool: torch.Tensor,  # [num_blocks, bs, kvh, hd]
    v_pool: torch.Tensor,
    tables: torch.Tensor,  # [slots, blocks_per_slot]
    lengths: torch.Tensor,  # [slots] — valid tokens (incl. current)
) -> torch.Tensor:
    """Single-token decode attention against the paged cache.

    Positions at or beyond ``lengths[i]`` (unwritten block tails and every
    unassigned trash block) are masked out of slot ``i``'s softmax.
    Returns ``[slots, h, hd]``.
    """
    check_range(("paged_attention tables", tables, k_pool.shape[0]))
    return _paged_attention(q, k_pool, v_pool, tables, lengths)


def _paged_attention(q, k_pool, v_pool, tables, lengths):  # noqa: ANN001, ANN202
    k = _gather(k_pool, tables)
    v = _gather(v_pool, tables)
    S = k.shape[1]
    visible = torch.arange(S, device=q.device)[None, :] < lengths[:, None]
    return _attend(q[:, None], k, v, visible[:, None])[:, 0]


def paged_attention_chunk(
    q: torch.Tensor,  # [slots, t, h, hd] — a chunk of query tokens per slot
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    tables: torch.Tensor,  # [slots, blocks_per_slot]
    positions: torch.Tensor,  # [slots, t] — absolute position of each query
) -> torch.Tensor:
    """Multi-query-token attention against the paged cache: query ``j`` of
    slot ``i`` attends to every cached position ``s <= positions[i, j]``
    (a cached prefix and the chunk's own K/V, scattered in first). Padded
    query rows produce garbage the caller never samples.
    Returns ``[slots, t, h, hd]``.
    """
    check_range(("paged_attention_chunk tables", tables, k_pool.shape[0]))
    return _paged_attention_chunk(q, k_pool, v_pool, tables, positions)


def _paged_attention_chunk(q, k_pool, v_pool, tables, positions):  # noqa: ANN001, ANN202
    k = _gather(k_pool, tables)
    v = _gather(v_pool, tables)
    S = k.shape[1]
    visible = torch.arange(S, device=q.device)[None, None, :] <= positions[:, :, None]
    return _attend(q, k, v, visible)


def scatter_kv_chunk(
    pool: torch.Tensor,  # [num_blocks, bs, kvh, hd]
    tables: torch.Tensor,  # [slots, blocks_per_slot]
    positions: torch.Tensor,  # [slots, t] — logical position of each new token
    new: torch.Tensor,  # [slots, t, kvh, hd]
    valid: Optional[torch.Tensor] = None,  # [slots, t] bool — False: trash
) -> torch.Tensor:
    """Scatter a chunk of new K (or V) tokens per slot into table
    positions, in place. Token ``j`` of slot ``i`` lands at
    ``tables[i, positions[i, j] // bs]`` offset ``positions[i, j] % bs``;
    invalid (padding) tokens go to the trash block, since their positions
    can lie past the table, where the clipped block index would alias a
    live block."""
    check_range(("scatter_kv_chunk tables", tables, pool.shape[0]))
    return _scatter_kv_chunk(pool, tables, positions, new, valid)


def _scatter_kv_chunk(pool, tables, positions, new, valid):  # noqa: ANN001, ANN202
    slots, t = positions.shape
    bs = pool.shape[1]
    block_idx = torch.clamp(positions // bs, 0, tables.shape[1] - 1)
    block_ids = torch.gather(tables, 1, block_idx)  # [slots, t]
    if valid is not None:
        block_ids = torch.where(valid, block_ids, TRASH_BLOCK)
    offsets = positions % bs
    pool[block_ids.reshape(-1), offsets.reshape(-1)] = new.reshape(
        slots * t, *new.shape[2:]
    ).to(pool.dtype)
    return pool


def append_kv(
    pool: torch.Tensor,  # [num_blocks, bs, kvh, hd]
    tables: torch.Tensor,  # [slots, blocks_per_slot]
    positions: torch.Tensor,  # [slots] — logical position being written
    new: torch.Tensor,  # [slots, kvh, hd]
) -> torch.Tensor:
    """Scatter one new K (or V) token per slot into its table position, in
    place. Inactive slots (a trash table entry) overwrite trash; their
    collisions there do not matter, since nothing masked-in reads it."""
    check_range(
        ("append_kv tables", tables, pool.shape[0]),
        ("append_kv positions", positions, tables.shape[1] * pool.shape[1]),
    )
    return _append_kv(pool, tables, positions, new)


def _append_kv(pool, tables, positions, new):  # noqa: ANN001, ANN202
    slots = tables.shape[0]
    bs = pool.shape[1]
    block_ids = tables[torch.arange(slots, device=tables.device), positions // bs]
    pool[block_ids, positions % bs] = new.to(pool.dtype)
    return pool


def write_prefill(
    pool: torch.Tensor,  # [num_blocks, bs, kvh, hd]
    block_ids: torch.Tensor,  # [n_bucket_blocks] physical ids (trash-padded)
    kv: torch.Tensor,  # [t_bucket, kvh, hd] — t_bucket = n_bucket_blocks * bs
) -> torch.Tensor:
    """Bulk-write a prefilled prompt's K (or V) rows into its assigned
    blocks, in place. Rows past the true prompt length are padding and land
    in the slot's own last block past its valid length (masked) or, for
    wholly unused bucket blocks, in the trash block."""
    check_range(("write_prefill block_ids", block_ids, pool.shape[0]))
    nb = block_ids.shape[0]
    bs = pool.shape[1]
    pool[block_ids] = kv.reshape(nb, bs, *kv.shape[1:]).to(pool.dtype)
    return pool
