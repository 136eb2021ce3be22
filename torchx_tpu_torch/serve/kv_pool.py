"""Paged KV-cache planning and block allocation (host side).

Port of :mod:`torchx_tpu.serve.kv_pool`. The JAX module sizes the pool
against a TPU's HBM; here :func:`plan_pool`'s default budget is the CUDA
card's own memory (``torch.cuda.get_device_properties(dev).total_memory``),
and ``GIB`` and the headroom constant are copied. Everything else is the
same numpy code.

The dense decode path costs ``L * 2 * max_seq * kvh * hd`` bytes per
sequence regardless of how many tokens the request actually produces, so
concurrency is bounded by worst-case ``max_seq``. Here KV memory is one
fixed pool of ``num_blocks`` blocks of ``block_size`` tokens shared by
every active slot; a slot holds only the blocks its tokens occupy, so the
same HBM budget admits far more concurrent sequences (vLLM's central
observation).

Nothing here runs on device: :func:`plan_pool` does the analytic memory
sizing, and :class:`BlockAllocator` + :class:`SlotTables` manage physical
blocks and per-slot block tables as plain numpy, which the engine
(:mod:`torchx_tpu_torch.serve.engine`) uploads to the device each step.

Block 0 is the *trash block* (``ops.paged_attention.TRASH_BLOCK``): never
allocated, the target of every unassigned table entry, so inactive slots
in the fixed-shape step harmlessly read/write it under the length mask.
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque

import numpy as np

import torch

from torchx_tpu_torch.ops.paged_attention import TRASH_BLOCK

GIB = 1024**3
#: Share of device memory a plan may fill (the JAX package's
#: ``aot_fit.DEFAULT_HEADROOM``): the rest is left to activations, the
#: allocator's fragmentation and the runtime.
DEFAULT_HEADROOM = 0.9

__all__ = [
    "PoolPlan",
    "plan_pool",
    "BlockAllocator",
    "SlotTables",
]


@dataclasses.dataclass(frozen=True)
class PoolPlan:
    """Resolved geometry of a paged KV pool for one model config.

    ``kv_budget_bytes`` is HBM after headroom and parameters;
    ``dense_slots`` is how many sequences the *dense* ``[max_seq]`` cache
    would fit in the same budget — the bench's occupancy comparison.
    """

    num_blocks: int
    block_size: int
    blocks_per_slot: int
    max_slots: int
    kv_bytes: int
    kv_budget_bytes: int
    dense_slots: int

    @property
    def pool_tokens(self) -> int:
        """Total KV token capacity (excluding the trash block)."""
        return (self.num_blocks - 1) * self.block_size

    def occupancy_report(self) -> dict:
        """Paged-vs-dense concurrency at the same HBM budget, as a dict
        (serialised into the serving bench's JSON output).

        ``kv_bytes_gib`` is the actual pool footprint
        (``num_blocks * block_bytes``); the block grid rarely tiles the
        budget exactly, so the unusable remainder is reported separately
        as ``kv_slack_gib`` rather than rounded into equality with
        ``kv_budget_gib``.
        """
        slack = self.kv_budget_bytes - self.kv_bytes
        return {
            "num_blocks": self.num_blocks,
            "block_size": self.block_size,
            "blocks_per_slot": self.blocks_per_slot,
            "paged_slots": self.max_slots,
            "dense_slots": self.dense_slots,
            "kv_budget_gib": round(self.kv_budget_bytes / GIB, 3),
            "kv_bytes_gib": round(self.kv_bytes / GIB, 6),
            "kv_slack_gib": round(slack / GIB, 6),
            "pool_tokens": self.pool_tokens,
        }


def _kv_itemsize(cfg) -> int:
    # serving caches are stored in the model compute dtype
    return torch.empty((), dtype=cfg.dtype).element_size()


def device_memory_bytes(device: torch.device | str = "cuda") -> int:
    """Total memory of the CUDA ``device``; raises where there is none."""
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(
            f"no CUDA device to size the KV pool against ({dev}); pass hbm_bytes"
        )
    return torch.cuda.get_device_properties(dev).total_memory


def plan_pool(
    cfg,
    *,
    hbm_bytes: int | None = None,
    headroom: float = DEFAULT_HEADROOM,
    block_size: int = 16,
    max_slots: int | None = None,
    mean_tokens_per_seq: int | None = None,
) -> PoolPlan:
    """Size a paged KV pool against a device-memory budget for ``cfg``.

    Budget = ``hbm_bytes * headroom`` minus parameter bytes (serving holds
    no optimizer state, so params are ``param_count * itemsize``);
    ``hbm_bytes`` defaults to the CUDA card's memory
    (:func:`device_memory_bytes`).
    ``num_blocks`` fills the remainder; ``max_slots`` (the engine's fixed
    slot-array size) defaults to oversubscribing the pool assuming
    sequences average ``mean_tokens_per_seq`` tokens (default
    ``max_seq / 4`` — serving traffic rarely decodes to the cap), capped
    so a single full-length sequence always fits.
    """
    if hbm_bytes is None:
        hbm_bytes = device_memory_bytes()
    itemsize = _kv_itemsize(cfg)
    param_bytes = cfg.param_count() * itemsize
    budget = int(hbm_bytes * headroom) - param_bytes
    if budget <= 0:
        raise ValueError(
            f"params ({param_bytes / GIB:.1f} GiB) exceed HBM budget "
            f"({hbm_bytes * headroom / GIB:.1f} GiB); no room for KV pool"
        )
    # one block, all layers, K and V
    block_bytes = cfg.n_layers * 2 * block_size * cfg.n_kv_heads * cfg.head_dim * itemsize
    num_blocks = budget // block_bytes
    blocks_per_slot = math.ceil(cfg.max_seq / block_size)
    if num_blocks < blocks_per_slot + 1:  # +1: trash block
        raise ValueError(
            f"KV budget ({budget / GIB:.2f} GiB) fits only {num_blocks} "
            f"blocks; one {cfg.max_seq}-token sequence needs "
            f"{blocks_per_slot}"
        )
    dense_seq_bytes = (
        cfg.n_layers * 2 * cfg.max_seq * cfg.n_kv_heads * cfg.head_dim * itemsize
    )
    dense_slots = budget // dense_seq_bytes
    if max_slots is None:
        mean_tokens = mean_tokens_per_seq or max(block_size, cfg.max_seq // 4)
        mean_blocks = math.ceil(mean_tokens / block_size)
        max_slots = max(1, (num_blocks - 1) // mean_blocks)
    kv_bytes = num_blocks * block_bytes
    return PoolPlan(
        num_blocks=int(num_blocks),
        block_size=block_size,
        blocks_per_slot=blocks_per_slot,
        max_slots=int(max_slots),
        kv_bytes=int(kv_bytes),
        kv_budget_bytes=int(budget),
        dense_slots=int(dense_slots),
    )


class BlockAllocator:
    """Refcounting free-list allocator over the physical blocks of one
    KV pool.

    Allocation is all-or-nothing: :meth:`alloc` returns ``None`` rather
    than a partial grant, so the engine can atomically decide to admit,
    wait, or preempt. Block ``TRASH_BLOCK`` is never handed out.

    Every allocated block carries a reference count (1 on :meth:`alloc`):
    the prefix cache and any slot sharing a cached prefix each hold one
    reference via :meth:`retain`, and :meth:`release` (or its legacy
    alias :meth:`free`) returns the block to the free list only when the
    count reaches zero. A shared block (refcount > 1) must never be
    written in place — the engine copy-on-writes the partial tail block
    through :meth:`is_shared` before appending to it.

    Freeing a block that is already free (double-free) or freeing the
    trash block raises ``ValueError`` instead of silently corrupting the
    free list.
    """

    def __init__(self, num_blocks: int) -> None:
        if num_blocks < 2:
            raise ValueError(f"need >= 2 blocks (1 is trash), got {num_blocks}")
        self.num_blocks = num_blocks
        self._free: deque[int] = deque(
            b for b in range(num_blocks) if b != TRASH_BLOCK
        )
        # refcount per physical block; 0 == free (trash stays pinned at 0
        # and is rejected everywhere by the explicit guards)
        self._refs = np.zeros((num_blocks,), np.int32)

    @property
    def free_blocks(self) -> int:
        """Blocks currently available to allocate."""
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        """Blocks currently held by slots (excludes the trash block)."""
        return self.num_blocks - 1 - len(self._free)

    def _check(self, b: int) -> None:
        if b == TRASH_BLOCK:
            raise ValueError("trash block is never allocated/retained/freed")
        if not 0 < b < self.num_blocks:
            raise ValueError(f"block {b} outside pool of {self.num_blocks}")

    def alloc(self, n: int) -> list[int] | None:
        """Take ``n`` blocks (each with refcount 1), or ``None`` (and take
        nothing) if fewer are free."""
        if n < 0:
            raise ValueError(f"negative allocation: {n}")
        if n > len(self._free):
            return None
        out = [self._free.popleft() for _ in range(n)]
        self._refs[out] += 1
        return out

    def refcount(self, block: int) -> int:
        """Current reference count of ``block`` (0 == free)."""
        self._check(block)
        return int(self._refs[block])

    def is_shared(self, block: int) -> bool:
        """True when more than one holder references ``block`` — writing
        it in place would corrupt another holder's prefix (COW trigger)."""
        return self.refcount(block) > 1

    def retain(self, blocks: list[int]) -> None:
        """Add one reference to each allocated block (prefix sharing)."""
        for b in blocks:
            self._check(b)
            if self._refs[b] == 0:
                raise ValueError(f"retaining free block {b}")
        for b in blocks:
            self._refs[b] += 1

    def release(self, blocks: list[int]) -> list[int]:
        """Drop one reference per block; blocks reaching refcount 0 go
        back to the free list. Returns the blocks actually freed.

        Raises ``ValueError`` on the trash block or a block that is
        already free (double-free) — validated for the whole batch before
        any count moves, so a raise leaves the allocator unchanged.
        """
        for b in blocks:
            self._check(b)
        counts: dict[int, int] = {}
        for b in blocks:
            counts[b] = counts.get(b, 0) + 1
            if counts[b] > self._refs[b]:
                raise ValueError(
                    f"double-free of block {b} "
                    f"(refcount {int(self._refs[b])})"
                )
        freed: list[int] = []
        for b in blocks:
            self._refs[b] -= 1
            if self._refs[b] == 0:
                self._free.append(b)
                freed.append(b)
        return freed

    def free(self, blocks: list[int]) -> None:
        """Drop one reference per block (see :meth:`release`); the
        historical name for the owner's release path."""
        self.release(blocks)


class SlotTables:
    """Per-slot block tables + valid lengths, host side (numpy).

    The engine passes :attr:`tables` into the decode step every
    iteration; unassigned entries stay ``TRASH_BLOCK``
    so inactive slots are inert under the mask. One instance is shared by
    all layers — every layer of a sequence uses the same physical block
    ids into its own layer-indexed pool.
    """

    def __init__(self, max_slots: int, blocks_per_slot: int) -> None:
        self.max_slots = max_slots
        self.blocks_per_slot = blocks_per_slot
        self.tables = np.full((max_slots, blocks_per_slot), TRASH_BLOCK, np.int32)
        self.lengths = np.zeros((max_slots,), np.int32)
        self._blocks: list[list[int]] = [[] for _ in range(max_slots)]

    def assign(self, slot: int, blocks: list[int]) -> None:
        """Append physical ``blocks`` to ``slot``'s table."""
        held = self._blocks[slot]
        if len(held) + len(blocks) > self.blocks_per_slot:
            raise ValueError(
                f"slot {slot}: {len(held)}+{len(blocks)} blocks exceeds "
                f"blocks_per_slot={self.blocks_per_slot}"
            )
        self.tables[slot, len(held) : len(held) + len(blocks)] = blocks
        held.extend(blocks)

    def blocks_of(self, slot: int) -> list[int]:
        """Physical blocks currently held by ``slot``."""
        return list(self._blocks[slot])

    def replace_block(self, slot: int, index: int, block: int) -> None:
        """Swap the physical block at table ``index`` — the engine's
        copy-on-write path after duplicating a shared tail block."""
        if index >= len(self._blocks[slot]):
            raise ValueError(
                f"slot {slot} holds {len(self._blocks[slot])} blocks; "
                f"cannot replace index {index}"
            )
        self._blocks[slot][index] = block
        self.tables[slot, index] = block

    def token_capacity(self, slot: int, block_size: int) -> int:
        """Token capacity of ``slot``'s currently-assigned blocks."""
        return len(self._blocks[slot]) * block_size

    def release(self, slot: int) -> list[int]:
        """Clear ``slot`` back to trash and return its blocks for
        :meth:`BlockAllocator.free`."""
        blocks = self._blocks[slot]
        self._blocks[slot] = []
        self.tables[slot, :] = TRASH_BLOCK
        self.lengths[slot] = 0
        return blocks
