"""Continuous-batching decode engine over a paged KV cache.

Port of :mod:`torchx_tpu.serve.engine`. The JAX engine jits one decode
step and one prefill per width bucket, donating the pools so XLA updates
them in place; here the same step functions run eagerly
(:mod:`torchx_tpu_torch.models.generate`, each under ``torch.no_grad``
in whatever thread calls it) and write the pools in place themselves. The
host builds the step's slot arrays in numpy, checks every block id and
position there (:meth:`ServeEngine._upload`), and uploads them to the
parameters' device. Sampling keys on (seed, position), as the JAX
engine's ``_fold_keys`` does, so preemption and prefix hits keep a
request's tokens.

The batch-to-completion server (`apps/generate_server.py`'s coalescing
batcher) decodes every admitted batch to its full ``max_new_tokens``
before the next batch starts: a request arriving mid-decode waits out the
whole window, and slots whose sequences finish early idle until the
stragglers do. Decode is memory-bandwidth-bound, so throughput is
(occupied slots) x (step rate) — idle slots are thrown-away bandwidth.

This engine keeps a **fixed slot array** decoding continuously:

* one :func:`torchx_tpu_torch.models.generate.paged_decode_step` per
  step over static ``[max_slots]`` shapes, whichever requests occupy
  the slots;
* **admission** between steps: waiting requests are prefilled in
  width-bucketed groups (the JAX engine's buckets) and dropped into
  free slots, with KV blocks allocated from the shared paged pool
  (:mod:`torchx_tpu_torch.serve.kv_pool`);
* **eviction** per step: a slot that hits EOS or its token budget
  completes immediately — its caller unblocks, its blocks return to the
  pool, and the slot is free for the next admission *that same step*;
* **preemption** under pool pressure: if a mid-decode slot can't get its
  next block, the youngest slot is evicted back to the wait queue (its
  finished tokens kept; decode resumes exactly — sampling keys are a pure
  function of (seed, position));
* **prefix reuse**: admission consults the refcounted radix
  :class:`~torchx_tpu_torch.serve.prefix_cache.PrefixCache` and prefills only
  the *uncached suffix* of each prompt (width-bucketed on suffix length,
  via :func:`~torchx_tpu_torch.models.generate.paged_prefill_chunk`); newly
  computed full blocks are inserted back on prefill and on completion.
  Cached blocks are shared by refcount — a shared tail block about to be
  written is copy-on-write copied first, and under pool pressure the
  engine evicts cache-only blocks before preempting live slots;
* **disaggregation seams**: a request marked ``prefill_only`` completes
  at prefill with its KV blocks exported as a
  :class:`~torchx_tpu_torch.serve.kv_transfer.KvPayload` (the prefill-replica
  role), and :meth:`ServeEngine.submit_prefilled` admits a transferred
  payload straight into a decode slot — scattering the received blocks
  into the pool with no prefill pass (the decode-replica role). A
  draining engine rejects handoffs with :class:`EngineStopped` so the
  sender requeues to another decode target.

Requests carry per-sequence temperature, seed, and EOS, so unrelated
requests share every device step. The engine emits ``serve.*`` spans /
heartbeats and ``tpx_serve_*`` metrics through the obs registry.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import math
import threading
import time
from collections import deque
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from torchx_tpu_torch.models import generate as gen
from torchx_tpu_torch.models import llama
from torchx_tpu_torch.obs import metrics as obs_metrics
from torchx_tpu_torch.obs import trace as obs_trace
from torchx_tpu_torch.ops.paged_attention import TRASH_BLOCK
from torchx_tpu_torch.serve.kv_pool import BlockAllocator, PoolPlan, SlotTables
from torchx_tpu_torch.serve.kv_transfer import KvPayload, new_request_id
from torchx_tpu_torch.serve.prefix_cache import PrefixCache

logger = logging.getLogger(__name__)

__all__ = [
    "ServeRequest",
    "ServeEngine",
    "EngineStopped",
    "serve_kv_payload",
]


class EngineStopped(RuntimeError):
    """Raised by :meth:`ServeEngine.submit` once the engine is draining or
    stopped — the SIGTERM drain path returns 503s off this."""


@dataclasses.dataclass
class ServeRequest:
    """One generation request moving through the engine.

    Callers fill the first block and :meth:`wait`; the engine appends to
    ``generated`` as tokens decode and sets ``done`` at completion.
    Timing: ``ttft_s`` is enqueue -> first token, ``tpot_s`` the mean gap
    between subsequent tokens — the two serving-latency axes.
    """

    prompt: Sequence[int]
    max_new_tokens: int
    temperature: float = 0.0
    seed: int = 0
    eos_id: Optional[int] = None
    #: disaggregated mode: complete at prefill and export the computed
    #: KV blocks as ``handoff`` instead of occupying a decode slot.
    prefill_only: bool = False
    handoff: Optional[KvPayload] = None

    generated: list[int] = dataclasses.field(default_factory=list)
    error: Optional[str] = None
    done: threading.Event = dataclasses.field(default_factory=threading.Event)
    t_enqueue: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the request completes (True) or ``timeout`` (False)."""
        return self.done.wait(timeout)

    @property
    def tokens(self) -> list[int]:
        """prompt + generated, the full sequence."""
        return list(self.prompt) + self.generated

    @property
    def ttft_s(self) -> float:
        """Seconds from enqueue to first generated token."""
        return max(0.0, self.t_first - self.t_enqueue)

    @property
    def tpot_s(self) -> float:
        """Mean seconds per generated token after the first."""
        n = len(self.generated)
        if n <= 1:
            return 0.0
        return max(0.0, self.t_done - self.t_first) / (n - 1)


@dataclasses.dataclass
class _SlotState:
    req: ServeRequest
    cache_len: int  # tokens currently in the KV cache for this sequence
    last_tok: int  # most recent sampled token (next step's input)
    admit_seq: int  # admission order; highest = youngest = preemption victim


@dataclasses.dataclass
class _Admit:
    """One request through admission: its cached prefix + fresh blocks."""

    req: ServeRequest
    toks: list[int]  # prompt + already-generated (resume) tokens
    cached_blocks: list[int]  # retained from the prefix cache
    cached_tokens: int  # block-aligned prefix length served from cache
    new_blocks: list[int]  # freshly allocated for the suffix


@dataclasses.dataclass
class _Handoff:
    """A transferred prefill (KV blocks + continuation state) waiting for
    a decode slot."""

    req: ServeRequest
    k: np.ndarray  # [L, n_blocks, bs, kvh, hd]
    v: np.ndarray
    cache_len: int
    last_tok: int


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1)).bit_length()


class ServeEngine:
    """The continuous-batching serving engine (see module docstring).

    ``max_slots``/``block_size``/``num_blocks`` fix the pool geometry;
    pass a :class:`~torchx_tpu_torch.serve.kv_pool.PoolPlan` (from
    :func:`~torchx_tpu_torch.serve.kv_pool.plan_pool`) via :meth:`from_plan` to
    size them against the card's memory. The default ``num_blocks`` gives
    every slot a half-``max_seq`` budget — mild oversubscription; the
    preemption path covers the tail. The pools live on the device of
    ``params``; parameters that require grad are refused (serving runs no
    backward, and the engine thread would build a graph over the pools).
    """

    def __init__(
        self,
        params: llama.Params,
        cfg: llama.LlamaConfig,
        *,
        max_slots: int = 8,
        block_size: int = 16,
        num_blocks: Optional[int] = None,
        max_prefill_batch: int = 4,
        enable_prefix_cache: bool = True,
        prefix_cache_reserve: float = 0.0,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
    ) -> None:
        if block_size & (block_size - 1):
            raise ValueError(f"block_size must be a power of 2, got {block_size}")
        if any(leaf.requires_grad for leaf in llama.leaves(params)):
            raise ValueError(
                "serving parameters must not require grad (convert with"
                " requires_grad=False, or detach them)"
            )
        self._params = params
        self.device = params["embed"].device
        self._cfg = cfg
        self.max_slots = max_slots
        self.block_size = block_size
        self.blocks_per_slot = math.ceil(cfg.max_seq / block_size)
        if num_blocks is None:
            num_blocks = 1 + max_slots * max(1, self.blocks_per_slot // 2)
        if num_blocks < self.blocks_per_slot + 1:
            raise ValueError(
                f"num_blocks={num_blocks} cannot hold one max_seq sequence"
                f" ({self.blocks_per_slot} blocks + trash)"
            )
        self.num_blocks = num_blocks
        self.max_prefill_batch = max(1, max_prefill_batch)
        self._clock = clock
        self._sleep = sleep

        self.pools = gen.init_kv_pools(cfg, num_blocks, block_size, self.device)
        self.alloc = BlockAllocator(num_blocks)
        self.tables = SlotTables(max_slots, self.blocks_per_slot)
        self._slots: list[Optional[_SlotState]] = [None] * max_slots
        self._admit_counter = itertools.count()
        self.prefix_cache: Optional[PrefixCache] = None
        if enable_prefix_cache:
            cap = (
                max(1, int(prefix_cache_reserve * num_blocks))
                if prefix_cache_reserve > 0
                else None
            )
            self.prefix_cache = PrefixCache(
                self.alloc, block_size, max_blocks=cap
            )

        self._lock = threading.Lock()
        self._waiting: deque[ServeRequest] = deque()
        self._handoffs: deque[_Handoff] = deque()
        self._prefilling = 0  # popped from _waiting, not yet slotted/done
        # the requests of that count, so that a failed step fails them too
        self._admitting: list[ServeRequest] = []
        self._work = threading.Event()
        self._stop = threading.Event()
        self._draining = False
        #: why the loop stopped, if a step raised (then nothing is admitted)
        self.failure: Optional[str] = None
        self._thread: Optional[threading.Thread] = None
        self.requests_done = 0
        self.tokens_out = 0
        self.steps = 0
        self._steps_since_beat = 0

    @classmethod
    def from_plan(
        cls,
        params: llama.Params,
        cfg: llama.LlamaConfig,
        plan: PoolPlan,
        **kwargs,
    ) -> "ServeEngine":
        """Build an engine with the geometry a :func:`plan_pool` sizing
        chose for the HBM budget."""
        return cls(
            params,
            cfg,
            max_slots=plan.max_slots,
            block_size=plan.block_size,
            num_blocks=plan.num_blocks,
            **kwargs,
        )

    # -- public API --------------------------------------------------------

    def start(self) -> "ServeEngine":
        """Spawn the engine loop thread (idempotent)."""
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="serve-engine", daemon=True
            )
            self._thread.start()
        return self

    def submit(self, req: ServeRequest) -> ServeRequest:
        """Enqueue a request for admission; raises :class:`EngineStopped`
        when draining/stopped, ValueError when it can never fit."""
        total = len(req.prompt) + req.max_new_tokens
        if total > self._cfg.max_seq:
            raise ValueError(
                f"prompt + new tokens ({total}) exceeds max_seq"
                f" {self._cfg.max_seq}"
            )
        if req.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        vocab = self._cfg.vocab_size
        if any(not 0 <= t < vocab for t in list(req.prompt) + req.generated):
            raise ValueError(f"token ids must lie in [0, {vocab})")
        with self._lock:
            if self.failure:
                raise EngineStopped(self.failure)
            if self._draining or self._stop.is_set():
                raise EngineStopped("engine is draining; not admitting requests")
            req.t_enqueue = self._clock()
            self._waiting.append(req)
            obs_metrics.SERVE_QUEUE_DEPTH.set(len(self._waiting))
        self._work.set()
        return req

    def submit_prefilled(
        self,
        req: ServeRequest,
        k: np.ndarray,
        v: np.ndarray,
        cache_len: int,
        last_tok: int,
    ) -> ServeRequest:
        """Admit a sequence whose KV was prefilled on another replica.

        ``k``/``v`` are block-granular ``[L, n, bs, kvh, hd]`` arrays
        covering ``cache_len`` tokens; decode continues from ``last_tok``
        with no prefill pass. Raises :class:`EngineStopped` while
        draining — the transfer sender requeues to another decode
        target (the disaggregated drain-race contract)."""
        n_need = math.ceil(cache_len / self.block_size)
        if k.shape[1] != n_need or v.shape[1] != n_need:
            raise ValueError(
                f"payload has {k.shape[1]} blocks; cache_len={cache_len} "
                f"needs {n_need} at block_size={self.block_size}"
            )
        remaining = req.max_new_tokens - len(req.generated)
        if cache_len + remaining > self._cfg.max_seq:
            raise ValueError(
                f"cached tokens + remaining new tokens "
                f"({cache_len}+{remaining}) exceeds max_seq {self._cfg.max_seq}"
            )
        with self._lock:
            if self._draining or self._stop.is_set():
                raise EngineStopped("engine is draining; not accepting handoffs")
            if req.t_enqueue == 0.0:
                req.t_enqueue = self._clock()
            self._handoffs.append(_Handoff(req, k, v, cache_len, last_tok))
        self._work.set()
        return req

    def _admit_handoffs(self) -> bool:
        """Place transferred prefills into free slots: scatter the
        received blocks into the pool, no device prefill needed."""
        worked = False
        while True:
            free = [i for i, s in enumerate(self._slots) if s is None]
            with self._lock:
                if not self._handoffs or not free:
                    return worked
                h = self._handoffs[0]
                blocks = self._alloc_pressure(
                    math.ceil(h.cache_len / self.block_size)
                )
                if blocks is None:
                    return worked  # pool pressure; retry next loop pass
                self._handoffs.popleft()
                self._prefilling += 1  # visible to drain() until slotted
                self._admitting = [h.req]
            with obs_trace.span(
                "serve.kv_import", blocks=len(blocks), cache_len=h.cache_len
            ):
                idx = self._upload(np.asarray(blocks, np.int64), self.num_blocks)
                for name, arr in (("k", h.k), ("v", h.v)):
                    pool = self.pools[name]
                    pool[:, idx] = torch.as_tensor(np.asarray(arr)).to(
                        device=pool.device, dtype=pool.dtype
                    )
            seq = list(h.req.prompt) + h.req.generated
            if self.prefix_cache is not None:
                self.prefix_cache.insert(seq[: h.cache_len], blocks)
            slot = free[0]
            self.tables.assign(slot, blocks)
            self.tables.lengths[slot] = h.cache_len
            self._slots[slot] = _SlotState(
                req=h.req,
                cache_len=h.cache_len,
                last_tok=h.last_tok,
                admit_seq=next(self._admit_counter),
            )
            with self._lock:
                self._prefilling -= 1
                self._admitting = []
            self._update_gauges()
            worked = True

    def generate(
        self,
        prompt: Sequence[int],
        max_new_tokens: int,
        temperature: float = 0.0,
        seed: int = 0,
        eos_id: Optional[int] = None,
        timeout: Optional[float] = None,
    ) -> ServeRequest:
        """Submit and block until done — the one-call convenience path."""
        req = ServeRequest(
            prompt=list(prompt),
            max_new_tokens=max_new_tokens,
            temperature=temperature,
            seed=seed,
            eos_id=eos_id,
        )
        self.submit(req)
        if not req.wait(timeout):
            raise TimeoutError(f"generation did not finish in {timeout}s")
        if req.error:
            raise RuntimeError(req.error)
        return req

    def stats(self) -> dict:
        """Engine occupancy/queue snapshot (feeds ``/healthz`` and the
        serve pool's load probe)."""
        with self._lock:
            active = sum(1 for s in self._slots if s is not None)
            out = {
                "active_slots": active,
                "max_slots": self.max_slots,
                "occupancy": active / self.max_slots,
                "queue_depth": len(self._waiting),
                "handoffs_pending": len(self._handoffs),
                "kv_blocks_used": self.alloc.used_blocks,
                "kv_blocks_free": self.alloc.free_blocks,
                "requests_done": self.requests_done,
                "tokens_out": self.tokens_out,
                "steps": self.steps,
                "draining": self._draining,
                "failure": self.failure,
            }
        if self.prefix_cache is not None:
            out["prefix_cache"] = self.prefix_cache.stats()
        return out

    def prefix_summary(self, max_entries: int = 128) -> list[str]:
        """Digests of this engine's hottest cached prefixes — published
        on ``/healthz`` for the cache-aware router."""
        if self.prefix_cache is None:
            return []
        return self.prefix_cache.summary(max_entries)

    @property
    def queue_depth(self) -> int:
        """Requests waiting for a slot (the autoscaler's primary signal)."""
        with self._lock:
            return len(self._waiting)

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Stop admitting, finish everything in flight, return True when
        empty (False on timeout). The SIGTERM grace path."""
        with self._lock:
            self._draining = True
        deadline = None if timeout is None else self._clock() + timeout
        while True:
            with self._lock:
                empty = (
                    not self._waiting
                    and not self._handoffs
                    and self._prefilling == 0
                    and all(s is None for s in self._slots)
                )
            if empty:
                return True
            if deadline is not None and self._clock() > deadline:
                return False
            self._sleep(0.005)

    def stop(self, timeout: float = 5.0) -> None:
        """Kill the loop thread; in-flight requests get ``error`` set."""
        self._stop.set()
        self._work.set()
        if self._thread is not None:
            self._thread.join(timeout)
        self._fail_all("engine stopped")

    # -- engine loop -------------------------------------------------------

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                worked = self._admit_handoffs()
                worked = self._admit() or worked
                worked = self._decode_once() or worked
            except Exception as e:  # noqa: BLE001 — a step bug must not hang callers
                # the engine stops for good (a CUDA error poisons the
                # context): in-flight requests fail, later submits raise
                logger.exception("serve engine step failed")
                self.failure = f"engine step failed: {type(e).__name__}: {e}"
                self._stop.set()
                self._fail_all(self.failure)
                return
            if not worked:
                self._work.wait(0.002)
                self._work.clear()

    def _fail_all(self, msg: str) -> None:
        with self._lock:
            pending = list(self._waiting)
            pending.extend(h.req for h in self._handoffs)
            pending.extend(self._admitting)
            self._waiting.clear()
            self._handoffs.clear()
            self._admitting = []
            self._prefilling = 0
        for i, st in enumerate(self._slots):
            if st is not None:
                self._slots[i] = None
                pending.append(st.req)
        for req in pending:
            if not req.done.is_set():
                req.error = msg
                req.t_done = self._clock()
                req.done.set()
                obs_metrics.SERVE_REQUESTS.inc(status="error")

    # -- admission / prefill ----------------------------------------------

    def _upload(self, arr: np.ndarray, hi: Optional[int] = None) -> torch.Tensor:
        """A host-built array to the engine's device; an index array is
        checked against ``[0, hi)`` here, before it reaches the card."""
        if hi is not None and arr.size and (arr.min() < 0 or arr.max() >= hi):
            raise IndexError(
                f"engine index out of range [0, {hi}): {arr.min()}..{arr.max()}"
            )
        return torch.from_numpy(arr).to(self.device)

    def _bucket_width(self, plen: int) -> int:
        return min(
            max(self.block_size, _next_pow2(plen)),
            _next_pow2(self._cfg.max_seq),
        )

    def _alloc_pressure(self, n: int) -> Optional[list[int]]:
        """:meth:`BlockAllocator.alloc` that spills cache-only blocks
        first: under pool pressure, LRU prefix-cache entries are cheaper
        to reclaim than preempting a live slot."""
        blocks = self.alloc.alloc(n)
        if blocks is None and self.prefix_cache is not None:
            self.prefix_cache.evict(n - self.alloc.free_blocks)
            blocks = self.alloc.alloc(n)
        return blocks

    def _admit(self) -> bool:
        free_slots = [i for i, s in enumerate(self._slots) if s is None]
        if not free_slots:
            return False
        admitted: list[_Admit] = []
        with self._lock:
            if not self._waiting:
                return False
            width: Optional[int] = None
            limit = min(len(free_slots), self.max_prefill_batch)
            for req in list(self._waiting):
                if len(admitted) >= limit:
                    break
                toks = list(req.prompt) + req.generated
                cached_blocks: list[int] = []
                cached_tokens = 0
                if self.prefix_cache is not None:
                    # retains the matched blocks on our behalf; never
                    # covers the last token, so suffix_len >= 1
                    cached_blocks, cached_tokens = self.prefix_cache.match(toks)
                suffix_len = len(toks) - cached_tokens
                w = self._bucket_width(suffix_len)
                if width is None:
                    width = w  # head of queue picks this round's bucket
                if w != width:
                    if cached_blocks:
                        self.alloc.release(cached_blocks)
                    continue
                need = math.ceil(len(toks) / self.block_size) - len(cached_blocks)
                new_blocks = self._alloc_pressure(need)
                if new_blocks is None:
                    if cached_blocks:
                        self.alloc.release(cached_blocks)
                    break  # pool pressure: admit what fits, retry later
                admitted.append(
                    _Admit(req, toks, cached_blocks, cached_tokens, new_blocks)
                )
            for a in admitted:
                self._waiting.remove(a.req)
            # visible to drain(): popped but not yet in a slot/completed
            self._prefilling += len(admitted)
            self._admitting = [a.req for a in admitted]
            obs_metrics.SERVE_QUEUE_DEPTH.set(len(self._waiting))
        if not admitted:
            return False

        rows = _next_pow2(len(admitted))
        tokens = np.zeros((rows, width), np.int64)
        prefix_lens = np.zeros((rows,), np.int64)
        suffix_lens = np.ones((rows,), np.int64)
        tables_rows = np.full((rows, self.blocks_per_slot), TRASH_BLOCK, np.int64)
        seeds = np.zeros((rows,), np.int64)
        temps = np.zeros((rows,), np.float32)
        cached_total = 0
        for r, a in enumerate(admitted):
            blocks = a.cached_blocks + a.new_blocks
            sfx = a.toks[a.cached_tokens :]
            tokens[r, : len(sfx)] = sfx
            prefix_lens[r] = a.cached_tokens
            suffix_lens[r] = len(sfx)
            tables_rows[r, : len(blocks)] = blocks
            seeds[r] = a.req.seed & 0xFFFFFFFF
            temps[r] = a.req.temperature
            cached_total += a.cached_tokens

        with obs_trace.span(
            "serve.prefill",
            rows=len(admitted),
            width=width,
            cached_tokens=cached_total,
        ):
            # the first token's key is (seed, absolute position of the
            # last prompt token): a cache-hit suffix prefill draws the
            # same first token a cold prefill would
            first = gen.paged_prefill_chunk(
                self._params,
                self._upload(tokens, self._cfg.vocab_size),
                self._upload(prefix_lens, self._cfg.max_seq),
                self._upload(suffix_lens),
                self._upload(tables_rows, self.num_blocks),
                self.pools,
                self._cfg,
                self._upload(seeds),
                self._upload(temps),
            ).cpu().numpy()

        now = self._clock()
        for r, a in enumerate(admitted):
            req = a.req
            blocks = a.cached_blocks + a.new_blocks
            resumed = bool(req.generated)  # preempted earlier; TTFT already set
            tok = int(first[r])
            req.generated.append(tok)
            if not resumed:
                req.t_first = now
                obs_metrics.SERVE_TTFT_SECONDS.observe(req.ttft_s)
            obs_metrics.SERVE_TOKENS.inc(phase="prefill")
            self.tokens_out += 1
            # index the freshly computed full blocks while they're valid —
            # the next same-prefix request prefills only its tail
            if self.prefix_cache is not None:
                self.prefix_cache.insert(a.toks, blocks)
            if req.prefill_only:
                # a request its first token already finishes never needs
                # the decode side: no handoff, the caller reads .tokens
                if not self._finished(req, tok):
                    req.handoff = self._export_handoff(req, a.toks, blocks)
                self.alloc.release(blocks)
                self._complete(req, now)
                continue
            if self._finished(req, tok):
                self.alloc.release(blocks)
                self._complete(req, now)
                continue
            slot = free_slots.pop(0)
            self.tables.assign(slot, blocks)
            self.tables.lengths[slot] = len(a.toks)
            self._slots[slot] = _SlotState(
                req=req,
                cache_len=len(a.toks),
                last_tok=tok,
                admit_seq=next(self._admit_counter),
            )
        with self._lock:
            self._prefilling -= len(admitted)
            self._admitting = []
        self._update_gauges()
        return True

    def _export_handoff(
        self, req: ServeRequest, toks: list[int], blocks: list[int]
    ) -> KvPayload:
        """Snapshot the prefilled K/V blocks for transfer to a decode
        replica (the ``prefill_only`` completion path), as f32 numpy (an
        exact upcast of a bf16 pool; numpy has no bf16)."""
        idx = self._upload(np.asarray(blocks, np.int64), self.num_blocks)
        return KvPayload(
            request_id=new_request_id(),
            tokens=list(toks),
            generated=list(req.generated),
            cache_len=len(toks),
            max_new_tokens=req.max_new_tokens,
            temperature=req.temperature,
            seed=req.seed,
            eos_id=req.eos_id,
            block_size=self.block_size,
            k=self.pools["k"][:, idx].float().cpu().numpy(),
            v=self.pools["v"][:, idx].float().cpu().numpy(),
        )

    # -- decode ------------------------------------------------------------

    def _finished(self, req: ServeRequest, tok: int) -> bool:
        return len(req.generated) >= req.max_new_tokens or (
            req.eos_id is not None and tok == req.eos_id
        )

    def _complete(self, req: ServeRequest, now: float) -> None:
        req.t_done = now
        req.done.set()
        self.requests_done += 1
        obs_metrics.SERVE_REQUESTS.inc(status="ok")
        if len(req.generated) > 1:
            obs_metrics.SERVE_TPOT_SECONDS.observe(req.tpot_s)

    def _preempt_youngest(self) -> bool:
        victims = [
            (st.admit_seq, i) for i, st in enumerate(self._slots) if st is not None
        ]
        if not victims:
            return False
        _, slot = max(victims)
        st = self._slots[slot]
        self._slots[slot] = None
        self.alloc.free(self.tables.release(slot))
        with self._lock:
            self._waiting.appendleft(st.req)  # resumes via re-prefill
            obs_metrics.SERVE_QUEUE_DEPTH.set(len(self._waiting))
        obs_metrics.SERVE_PREEMPTIONS.inc()
        return True

    def _copy_block(self, src: int, dst: int) -> None:
        """Device-side copy of one physical block across all layers, in
        place."""
        for bad in (src, dst):
            if not 0 <= bad < self.num_blocks:
                raise IndexError(f"block {bad} outside pool of {self.num_blocks}")
        for pool in self.pools.values():
            pool[:, dst] = pool[:, src]

    def _ensure_capacity(self, slot: int, write_pos: int) -> bool:
        """Make sure ``slot`` holds a *writable* block for ``write_pos``:
        grows the table lazily, copy-on-writes a shared tail block
        (another holder — cache or sibling slot — still reads it), and
        preempts the youngest slot under pool pressure. False if ``slot``
        itself was preempted away."""
        idx = write_pos // self.block_size
        while True:
            have = len(self.tables.blocks_of(slot))
            if have >= idx + 1:
                tail = self.tables.blocks_of(slot)[idx]
                if not self.alloc.is_shared(tail):
                    return True
                fresh = self._alloc_pressure(1)
                if fresh is not None:
                    self._copy_block(tail, fresh[0])
                    self.tables.replace_block(slot, idx, fresh[0])
                    self.alloc.release([tail])
                    obs_metrics.SERVE_COW_COPIES.inc()
                    return True
            else:
                blocks = self._alloc_pressure(idx + 1 - have)
                if blocks is not None:
                    self.tables.assign(slot, blocks)
                    continue  # re-check the (fresh, unshared) tail
            self._preempt_youngest()
            if self._slots[slot] is None:
                return False  # preempted ourselves: nothing else to evict

    def _decode_once(self) -> bool:
        active = [(i, st) for i, st in enumerate(self._slots) if st is not None]
        if not active:
            return False
        for slot, st in active:
            if self._slots[slot] is None:
                continue  # preempted by an earlier slot's capacity grab
            self._ensure_capacity(slot, st.cache_len)

        tokens = np.zeros((self.max_slots,), np.int64)
        positions = np.zeros((self.max_slots,), np.int64)
        seeds = np.zeros((self.max_slots,), np.int64)
        temps = np.zeros((self.max_slots,), np.float32)
        stepping: list[tuple[int, _SlotState]] = []
        for slot, st in enumerate(self._slots):
            if st is None:
                continue
            tokens[slot] = st.last_tok
            positions[slot] = st.cache_len
            seeds[slot] = st.req.seed & 0xFFFFFFFF
            temps[slot] = st.req.temperature
            stepping.append((slot, st))
        if not stepping:
            return False

        nxt = gen.paged_decode_step(
            self._params,
            self._upload(tokens, self._cfg.vocab_size),
            self._upload(positions, self.blocks_per_slot * self.block_size),
            self._upload(self.tables.tables.astype(np.int64), self.num_blocks),
            self.pools,
            self._cfg,
            self._upload(seeds),
            self._upload(temps),
        ).cpu().numpy()
        self.steps += 1

        now = self._clock()
        for slot, st in stepping:
            st.cache_len += 1
            self.tables.lengths[slot] = st.cache_len
            tok = int(nxt[slot])
            st.last_tok = tok
            st.req.generated.append(tok)
            self.tokens_out += 1
            obs_metrics.SERVE_TOKENS.inc(phase="decode")
            if self._finished(st.req, tok):
                self._slots[slot] = None
                blocks = self.tables.release(slot)
                if self.prefix_cache is not None:
                    # index the completed sequence's full blocks (cache
                    # holds cache_len tokens: everything but the final
                    # sampled token) before dropping the slot's refs
                    seq = list(st.req.prompt) + st.req.generated
                    self.prefix_cache.insert(seq[: st.cache_len], blocks)
                self.alloc.release(blocks)
                self._complete(st.req, now)
        self._update_gauges()
        self._steps_since_beat += 1
        if self._steps_since_beat >= 64:
            self._steps_since_beat = 0
            obs_trace.heartbeat(
                "serve.window",
                steps=self.steps,
                tokens=self.tokens_out,
                requests=self.requests_done,
            )
        return True

    def _update_gauges(self) -> None:
        active = sum(1 for s in self._slots if s is not None)
        obs_metrics.SERVE_SLOTS_ACTIVE.set(active)
        obs_metrics.SERVE_OCCUPANCY.set(active / self.max_slots)
        obs_metrics.SERVE_KV_BLOCKS_USED.set(self.alloc.used_blocks)


def serve_kv_payload(
    engine: ServeEngine,
    payload: KvPayload,
    timeout: Optional[float] = None,
) -> dict:
    """Decode-replica handler for one transferred prefill: admit the
    payload via :meth:`ServeEngine.submit_prefilled`, wait for
    completion, and return the transport reply. The ``/v1/kv`` endpoint
    and the file-spool pump both route here; :class:`EngineStopped`
    (draining) propagates as
    :class:`~torchx_tpu_torch.serve.kv_transfer.TransferRejected` so the
    prefill side requeues."""
    from torchx_tpu_torch.serve.kv_transfer import TransferRejected

    if payload.block_size != engine.block_size:
        raise ValueError(
            f"payload block_size {payload.block_size} != engine "
            f"block_size {engine.block_size}"
        )
    req = ServeRequest(
        prompt=list(payload.tokens),
        max_new_tokens=payload.max_new_tokens,
        temperature=payload.temperature,
        seed=payload.seed,
        eos_id=payload.eos_id,
        generated=list(payload.generated),
    )
    try:
        engine.submit_prefilled(
            req,
            payload.k,
            payload.v,
            payload.cache_len,
            last_tok=payload.generated[-1],
        )
    except EngineStopped as e:
        raise TransferRejected(str(e)) from e
    if not req.wait(timeout):
        raise TimeoutError(
            f"transferred request {payload.request_id} did not finish"
        )
    if req.error:
        raise RuntimeError(req.error)
    return {"request_id": payload.request_id, "tokens": req.generated}
