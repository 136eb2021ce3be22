"""Bucketed gradient sync over ``dp`` (the ``--grad-bucket-mb`` knob).

The port of :mod:`torchx_tpu.parallel.overlap`. After the backward, every
gradient is summed over the ``dp`` axis, where each rank holds the whole
(``fsdp``-sharded) state. Fused into one collective, that sum waits for
the whole backward; split into size-capped buckets in reverse-layer order
(the order the backward produces gradients), each bucket's ``all_reduce``
could start as soon as its leaves exist.

Here each bucket is one flat buffer of its leaves, issued in the plan's
order, and summed so that the result is bitwise the same for any
bucketing (one bucket for the whole tree included), as the reference's
contract says: the buffer is all-gathered and every rank adds the ranks'
copies in rank order, so an element's summation order depends on nothing
but the ranks. An ``all_reduce`` would not do: above two ranks a ring's
summation order follows an element's position in the buffer, which the
bucketing moves. At ``dp`` 2 the gather receives the bytes a ring
all-reduce does; at ``dp`` d it receives d/2 times as many (each rank
receives d - 1 copies of the buffer, a ring 2 (d - 1) / d). The gather
goes in chunks of at most :data:`GATHER_CHUNK_BYTES`, so that besides the
flat copy of its leaves a sync holds d chunks at once, not d copies of the
whole bucket (for llama3_1b's fused sync at ``dp`` 4, about 10 GB a rank);
the chunking moves no add. The plan, the
ladder of candidate caps and the auto choice are the JAX package's, over
this rank's tensors: the buffers that the collective moves (with ``fsdp``
> 1, the shards; the JAX package plans on the global shapes).

The buckets do not overlap the backward yet: the stacked layer leaves get
their gradient only when the backward ends, and the buckets run one after
another after it (ROADMAP). Until they overlap it, the flag only changes
how many collectives the ``dp`` sum takes, and what that costs on the card
is the only thing a measurement could show.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from torchx_tpu_torch.parallel.mesh import collective_range

#: Candidate bucket caps (MiB) tried by auto selection, small first —
#: smaller buckets start overlapping earlier in the backward pass.
BUCKET_MB_CANDIDATES: Tuple[int, ...] = (4, 8, 16, 32, 64, 128)

#: Auto selection aims near this many buckets: enough boundaries for the
#: scheduler to overlap, few enough that per-collective launch latency
#: stays amortized.
TARGET_BUCKETS = 8

_MIB = 1024 * 1024

#: Bytes of a sync's buffer gathered at once (:func:`rank_order_sum`): a
#: rank's transient gather buffer holds ``dp`` times this many.
GATHER_CHUNK_BYTES = 64 * _MIB


def tree_leaves(tree: Any) -> list:
    """The leaves of a tree of dicts, lists and tuples, in the JAX pytree's
    order (dict keys sorted, depth first)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """Size-capped grouping of gradient-tree leaves, reverse-layer order.

    ``buckets`` holds tuples of *flattened-leaf indices*; iteration order
    is the issue order (last-produced leaves first). A leaf larger than
    the cap gets a bucket of its own."""

    bucket_bytes: int
    buckets: Tuple[Tuple[int, ...], ...]
    total_bytes: int
    leaf_bytes: Tuple[int, ...] = dataclasses.field(default=(), repr=False)

    @property
    def n_buckets(self) -> int:
        """Number of buckets (== number of per-bucket reduces issued)."""
        return len(self.buckets)

    @property
    def largest_bucket_bytes(self) -> int:
        """Byte size of the largest bucket."""
        return max((sum(self.leaf_bytes[i] for i in b) for b in self.buckets), default=0)

    def describe(self) -> dict:
        """Loggable summary: cap, bucket count, total and largest MiB."""
        return {
            "bucket_mb": self.bucket_bytes // _MIB,
            "n_buckets": self.n_buckets,
            "total_mb": round(self.total_bytes / _MIB, 3),
            "largest_bucket_mb": round(self.largest_bucket_bytes / _MIB, 3),
        }


def plan_buckets(tree: Any, bucket_bytes: int) -> BucketPlan:
    """Greedy size-capped bucketing of ``tree``'s leaves (tensors, on any
    device, ``meta`` too) in **reverse** flatten order (the backward
    finishes the last layers first). Deterministic: the same leaves and
    cap give the same plan."""
    sizes = tuple(t.numel() * t.element_size() for t in tree_leaves(tree))
    buckets: list[Tuple[int, ...]] = []
    cur: list[int] = []
    cur_bytes = 0
    for idx in reversed(range(len(sizes))):
        nb = sizes[idx]
        if cur and cur_bytes + nb > bucket_bytes:
            buckets.append(tuple(cur))
            cur, cur_bytes = [], 0
        cur.append(idx)
        cur_bytes += nb
        if cur_bytes >= bucket_bytes:  # oversize leaf: own bucket
            buckets.append(tuple(cur))
            cur, cur_bytes = [], 0
    if cur:
        buckets.append(tuple(cur))
    return BucketPlan(int(bucket_bytes), tuple(buckets), sum(sizes), sizes)


@dataclasses.dataclass(frozen=True)
class BucketTrial:
    """One auto-selection candidate, recorded so that the trainer can log
    why a cap was (not) chosen."""

    bucket_mb: int
    n_buckets: int
    largest_bucket_mb: float
    chosen: bool
    reason: str

    def to_dict(self) -> dict:
        """JSON form for the trainer's results."""
        return dataclasses.asdict(self)


def resolve_bucket_mb(
    tree: Any,
    requested: Any = "auto",
    candidates: Sequence[int] = BUCKET_MB_CANDIDATES,
) -> Tuple[int, Tuple[BucketTrial, ...]]:
    """Resolve a ``--grad-bucket-mb`` request against a gradient tree.

    An explicit positive integer passes through (one trial record).
    ``"auto"``/``0`` walks the candidate ladder smallest-first and picks
    the first cap yielding at most :data:`TARGET_BUCKETS` buckets; the
    largest candidate when none does."""
    if requested not in ("auto", 0, "0", None):
        mb = int(requested)
        if mb <= 0:
            raise ValueError(f"--grad-bucket-mb must be positive, got {mb}")
        plan = plan_buckets(tree, mb * _MIB)
        trial = BucketTrial(
            bucket_mb=mb,
            n_buckets=plan.n_buckets,
            largest_bucket_mb=round(plan.largest_bucket_bytes / _MIB, 3),
            chosen=True,
            reason="explicit --grad-bucket-mb",
        )
        return mb, (trial,)

    trials: list[BucketTrial] = []
    chosen: Optional[int] = None
    for mb in candidates:
        plan = plan_buckets(tree, mb * _MIB)
        ok = plan.n_buckets <= TARGET_BUCKETS
        pick = ok and chosen is None
        if pick:
            chosen = mb
        trials.append(
            BucketTrial(
                bucket_mb=mb,
                n_buckets=plan.n_buckets,
                largest_bucket_mb=round(plan.largest_bucket_bytes / _MIB, 3),
                chosen=pick,
                reason=(
                    "first cap with <= %d buckets" % TARGET_BUCKETS
                    if pick
                    else (
                        "acceptable but a smaller cap was already chosen"
                        if ok
                        else "too many buckets (collective launch latency)"
                    )
                ),
            )
        )
    if chosen is None:  # tiny trees: even the largest cap over-fragments
        chosen = candidates[-1]
        trials[-1] = dataclasses.replace(
            trials[-1], chosen=True, reason="largest candidate (fallback)"
        )
    return chosen, tuple(trials)


def bucketed_sync(
    grads: Sequence[torch.Tensor], plan: Optional[BucketPlan], group: Any
) -> int:
    """Sum ``grads`` (in place) over ``group``: one all-gather per bucket
    of ``plan`` of a flat buffer of its leaves (one per dtype), in the
    plan's order, then the ranks' copies added in rank order
    (:func:`rank_order_sum`). ``plan`` None is the off switch: one fused
    sync of every leaf. A group of one rank has nothing to sum and issues
    nothing. -> the number of syncs issued (one a bucket and dtype, each
    gathered in chunks of :data:`GATHER_CHUNK_BYTES`)."""
    grads = list(grads)
    if dist.get_world_size(group) == 1:
        return 0
    buckets = plan.buckets if plan is not None else (tuple(reversed(range(len(grads)))),)
    issued = 0
    for bucket in buckets:
        by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
        for i in bucket:
            by_dtype.setdefault(grads[i].dtype, []).append(grads[i])
        for leaves in by_dtype.values():
            flat = torch.cat([g.reshape(-1) for g in leaves])
            rank_order_sum(flat, group)
            offset = 0
            for g in leaves:
                g.copy_(flat[offset:offset + g.numel()].view_as(g))
                offset += g.numel()
            issued += 1
    return issued


def rank_order_sum(flat: torch.Tensor, group: Any) -> torch.Tensor:
    """Sum the contiguous 1-d ``flat`` over ``group`` in place, ``((x0 +
    x1) + x2) + ...`` in rank order on every rank: an
    ``all_gather_into_tensor`` of each chunk of at most
    :data:`GATHER_CHUNK_BYTES`, then the adds in ``flat``'s dtype, each
    element on its own, so that the result depends neither on where
    ``flat`` lies in a buffer nor on the chunks. -> ``flat``."""
    n = dist.get_world_size(group)
    step = max(1, GATHER_CHUNK_BYTES // flat.element_size())
    gathered = flat.new_empty(n * min(step, flat.numel()))
    for lo in range(0, flat.numel(), step):
        chunk = flat[lo:lo + step]
        parts = gathered[:n * chunk.numel()]
        with collective_range(group):
            dist.all_gather_into_tensor(parts, chunk, group=group)
        parts = parts.view(n, chunk.numel())
        chunk.copy_(parts[0])
        for r in range(1, n):
            chunk.add_(parts[r])
    return flat
