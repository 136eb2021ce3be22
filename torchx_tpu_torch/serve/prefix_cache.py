"""Refcounted radix prefix cache over the paged KV pool.

The port's copy of :mod:`torchx_tpu.serve.prefix_cache` (it needs no JAX);
only its imports differ.

Serving traffic is dominated by shared prefixes — the same system prompt
in front of every request, few-shot preambles, multi-turn histories. The
paged pool already stores KV block-wise, so a prefix that two sequences
share can be *one* set of physical blocks with two references instead of
being recomputed per request (SGLang's RadixAttention observation).

:class:`PrefixCache` is the host-side index: a radix tree keyed on token
ids at **block granularity** — each node owns exactly one physical block
holding ``block_size`` tokens, and a root-to-node path spells out a
block-aligned prefix. The cache holds its own reference on every adopted
block through :class:`~torchx_tpu_torch.serve.kv_pool.BlockAllocator`, so
blocks survive the completing slot and are shared into later slots via
:meth:`match` (which retains them for the new holder).

Only *full* blocks are ever cached, and :meth:`match` never covers the
final prompt token (the engine must compute at least one position to
produce logits), so a matched block is never written by its sharers —
the engine's copy-on-write tail guard is the backstop, not the hot path.

Eviction is LRU over nodes whose block has refcount 1 (cache-only, no
live slot): :meth:`evict` frees the least-recently-touched such leaves
under pool pressure, and an optional ``max_blocks`` cap bounds how much
of the pool the cache may pin (the ``--prefix-cache-reserve`` fraction
the cost model accounts for).

Hit/miss accounting feeds ``tpx_serve_prefix_*`` metrics and the serving
bench's prefix-hit-rate scorecard. Routers use :func:`prefix_chain` /
:meth:`summary` — positionally-chained digests of block keys — to score
replicas by longest cached prefix without shipping token ids around.
"""

from __future__ import annotations

import hashlib
import itertools
import threading
from typing import TYPE_CHECKING, Optional, Sequence

from torchx_tpu_torch.obs import metrics as obs_metrics

if TYPE_CHECKING:  # annotation-only, as in the JAX package's module
    from torchx_tpu_torch.serve.kv_pool import BlockAllocator

__all__ = ["PrefixCache", "prefix_chain"]


def _chain_digest(parent: bytes, chunk: tuple[int, ...]) -> bytes:
    h = hashlib.blake2b(digest_size=8)
    h.update(parent)
    h.update(b"|".join(str(t).encode() for t in chunk))
    return h.digest()


def prefix_chain(
    tokens: Sequence[int], block_size: int, max_blocks: int = 64
) -> list[str]:
    """Chained per-block digests of ``tokens``: entry ``i`` identifies the
    whole prefix ``tokens[: (i+1) * block_size]``. Routers compare these
    against replica summaries to find the longest cached prefix without
    exchanging raw token ids."""
    out: list[str] = []
    parent = b""
    n_full = min(len(tokens) // block_size, max_blocks)
    for i in range(n_full):
        chunk = tuple(tokens[i * block_size : (i + 1) * block_size])
        parent = _chain_digest(parent, chunk)
        out.append(parent.hex())
    return out


class _Node:
    __slots__ = ("chunk", "block", "children", "parent", "last_used", "digest")

    def __init__(
        self,
        chunk: tuple[int, ...],
        block: int,
        parent: Optional["_Node"],
        stamp: int,
    ) -> None:
        self.chunk = chunk
        self.block = block
        self.parent = parent
        self.children: dict[tuple[int, ...], _Node] = {}
        self.last_used = stamp
        self.digest = _chain_digest(
            parent.digest if parent is not None else b"", chunk
        )


class PrefixCache:
    """Radix tree of cached full KV blocks (see module docstring).

    Thread-safe: the engine loop matches/inserts/evicts while HTTP
    threads read :meth:`stats` and :meth:`summary`.
    """

    def __init__(
        self,
        alloc: BlockAllocator,
        block_size: int,
        *,
        max_blocks: Optional[int] = None,
    ) -> None:
        self.alloc = alloc
        self.block_size = block_size
        self.max_blocks = max_blocks  # None: bounded only by pool pressure
        self._root: dict[tuple[int, ...], _Node] = {}
        self._nodes = 0
        self._stamp = itertools.count()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.hit_tokens = 0
        self.lookup_tokens = 0
        self.evictions = 0

    @property
    def cached_blocks(self) -> int:
        """Blocks currently pinned by the cache."""
        return self._nodes

    # -- lookup ------------------------------------------------------------

    def match(self, tokens: Sequence[int]) -> tuple[list[int], int]:
        """Longest cached block-aligned prefix of ``tokens``.

        Returns ``(blocks, n_tokens)`` with one reference **retained per
        returned block on behalf of the caller** (release them through
        the normal slot-release path). Never covers the final token:
        the engine always has at least one position left to prefill, so
        the sampled "first" token has logits to come from.
        """
        bs = self.block_size
        # at least one token must remain uncached
        limit = max(0, (len(tokens) - 1) // bs)
        blocks: list[int] = []
        with self._lock:
            stamp = next(self._stamp)
            node: Optional[_Node] = None
            children = self._root
            for i in range(limit):
                chunk = tuple(tokens[i * bs : (i + 1) * bs])
                child = children.get(chunk)
                if child is None:
                    break
                child.last_used = stamp
                blocks.append(child.block)
                node = child
                children = child.children
            # touch the whole path so LRU evicts leaves before their parents
            while node is not None:
                node.last_used = stamp
                node = node.parent
            if blocks:
                self.alloc.retain(blocks)
                self.hits += 1
                obs_metrics.SERVE_PREFIX_HITS.inc()
            else:
                self.misses += 1
                obs_metrics.SERVE_PREFIX_MISSES.inc()
            matched = len(blocks) * bs
            self.hit_tokens += matched
            self.lookup_tokens += len(tokens)
            if matched:
                obs_metrics.SERVE_PREFIX_HIT_TOKENS.inc(matched)
        return blocks, matched

    # -- insertion ---------------------------------------------------------

    def insert(self, tokens: Sequence[int], blocks: Sequence[int]) -> int:
        """Index the full blocks of a prefilled/completed sequence.

        ``blocks[i]`` must hold tokens ``tokens[i*bs : (i+1)*bs]``; only
        ``len(tokens) // block_size`` full blocks are considered. New
        nodes adopt the caller's block with a cache-owned reference
        (:meth:`BlockAllocator.retain`); chunks already present keep the
        existing node's block — the caller's duplicate stays the
        caller's to release. Returns the number of newly adopted blocks.
        """
        bs = self.block_size
        n_full = min(len(tokens) // bs, len(blocks))
        adopted = 0
        with self._lock:
            stamp = next(self._stamp)
            parent: Optional[_Node] = None
            children = self._root
            for i in range(n_full):
                chunk = tuple(tokens[i * bs : (i + 1) * bs])
                node = children.get(chunk)
                if node is None:
                    if (
                        self.max_blocks is not None
                        and self._nodes >= self.max_blocks
                        and not self._evict_locked(1)
                    ):
                        break  # cap reached, nothing evictable
                    block = int(blocks[i])
                    self.alloc.retain([block])
                    node = _Node(chunk, block, parent, stamp)
                    children[chunk] = node
                    self._nodes += 1
                    adopted += 1
                node.last_used = stamp
                parent = node
                children = node.children
            obs_metrics.SERVE_PREFIX_CACHED_BLOCKS.set(self._nodes)
        return adopted

    # -- eviction ----------------------------------------------------------

    def evict(self, n_blocks: int) -> int:
        """Free up to ``n_blocks`` cache-only blocks (refcount 1), least
        recently used leaves first. Returns how many were freed — the
        engine calls this under pool pressure before preempting slots."""
        with self._lock:
            freed = self._evict_locked(n_blocks)
            obs_metrics.SERVE_PREFIX_CACHED_BLOCKS.set(self._nodes)
            return freed

    def _evict_locked(self, n_blocks: int) -> int:
        freed = 0
        while freed < n_blocks:
            victim = self._lru_evictable_leaf()
            if victim is None:
                break
            siblings = (
                victim.parent.children if victim.parent is not None else self._root
            )
            del siblings[victim.chunk]
            self._nodes -= 1
            self.alloc.release([victim.block])
            self.evictions += 1
            obs_metrics.SERVE_PREFIX_EVICTIONS.inc()
            freed += 1
        return freed

    def _lru_evictable_leaf(self) -> Optional[_Node]:
        best: Optional[_Node] = None
        stack = list(self._root.values())
        while stack:
            node = stack.pop()
            if node.children:
                stack.extend(node.children.values())
            elif self.alloc.refcount(node.block) == 1 and (
                best is None or node.last_used < best.last_used
            ):
                best = node
        return best

    # -- introspection -----------------------------------------------------

    def stats(self) -> dict:
        """Hit/miss accounting for ``/healthz`` and the bench scorecard."""
        with self._lock:
            lookups = self.hits + self.misses
            return {
                "cached_blocks": self._nodes,
                "hits": self.hits,
                "misses": self.misses,
                "hit_rate": self.hits / lookups if lookups else 0.0,
                "hit_tokens": self.hit_tokens,
                "lookup_tokens": self.lookup_tokens,
                "token_hit_rate": (
                    self.hit_tokens / self.lookup_tokens
                    if self.lookup_tokens
                    else 0.0
                ),
                "evictions": self.evictions,
            }

    def summary(self, max_entries: int = 128) -> list[str]:
        """Digests of the most-recently-used cached prefixes, for the
        cache-aware router (compare against :func:`prefix_chain`)."""
        with self._lock:
            nodes: list[_Node] = []
            stack = list(self._root.values())
            while stack:
                node = stack.pop()
                nodes.append(node)
                stack.extend(node.children.values())
            nodes.sort(key=lambda n: n.last_used, reverse=True)
            return [n.digest.hex() for n in nodes[:max_entries]]
