"""Generation server: HTTP inference over the KV-cache decode loop.

Port of :mod:`torchx_tpu.apps.generate_server`: load a model config with
seeded random weights onto the CUDA card, and serve token-in/token-out
generation over plain HTTP, with no framework dependencies.

    python -m torchx_tpu_torch.apps.generate_server \
        --config llama3_1b [--ckpt-dir DIR] [--device cuda] [--port 8000]

Runs on the CUDA device unless ``--device cpu`` is given, and raises where
no CUDA device is present. ``--ckpt-dir`` serves the parameters of the
trainer's newest checkpoint step that verifies against its digest (only
the ``params.*`` entries are read), through a read-only reader: a bad step
is skipped and logged, and nothing in the directory is renamed or written,
so a server pointed at a live training directory leaves its resume point
alone. Every preset of the JAX server's ``all_configs()`` is served, the
MoE family included. ``--int8`` serves weight-only int8: after the init
or the ``--ckpt-dir`` load, every projection matrix becomes an int8 matrix
with per-output-channel f32 scales
(:func:`torchx_tpu_torch.ops.quant.quantize_params`), each float leaf
freed as soon as its record exists, and every projection runs the
hand-written int8-weight matmul kernel on the card; the prefill and decode
roles take it too (their handoff carries K/V only).

API (JSON):
    GET  /healthz            -> {"status": "ok", "model": ..., "requests": N,
                                 "ckpt_step": step served or null}
                                (503 {"status": "draining"} during SIGTERM
                                grace)
    GET  /metricz            -> tpx_* metrics, Prometheus text format
    POST /v1/generate        {"tokens": [[...]], "max_new_tokens": 16,
                              "temperature": 0.0}
                          or {"text": "...", ...} (byte-level codec, the
                              same tokenization datapreproc defaults to)
                          -> {"tokens": [[...]]} / {"text": [...]}
    POST /v1/kv              (decode role) an octet-stream ``KvPayload``
                             -> {"request_id": ..., "tokens": [generated]};
                             400 for a body that is no payload, 503 at a
                             role that is not decode or while draining

Two serving engines, selected by ``--engine``:

* ``continuous`` (default): the :mod:`torchx_tpu_torch.serve.engine`
  continuous-batching loop — a fixed ``--max-batch`` slot array decoding
  over a paged KV cache, with requests admitted into free slots between
  steps and completions returned the step they finish. Arbitrary prompt
  lengths, temperatures, and seeds share one device step.
* ``coalesce``: the legacy batch-to-completion batcher — compatible
  sequences (same prompt length / max_new / temperature) from concurrent
  clients merge into one device batch within a few-ms window, and each
  batch decodes to completion before the next dispatch. Kept as the
  serving-bench baseline and for bit-exact parity with
  :func:`torchx_tpu_torch.models.generate.generate`.

Disaggregated serving, selected by ``--serve-role`` (continuous engine
only):

* ``prefill`` runs the cache-aware prefill, then streams each prompt's
  K/V blocks (an npz :class:`~torchx_tpu_torch.serve.kv_transfer.KvPayload`
  of f32 ``[L, n_blocks, bs, kvh, hd]`` arrays, the JAX package's wire
  format) to a decode replica named by ``--kv-transfer``
  (``http:<url>[,<url>...]`` or ``file:<dir>``) and relays its completion;
* ``decode`` admits payloads posted to ``/v1/kv`` (or, given a
  ``file:<dir>`` spec, pumped from that spool) straight into decode slots.

A port replica and a JAX replica exchange payloads either way.

On SIGTERM the server drains instead of dying mid-request: admission
stops, ``/healthz`` flips to 503 (so routers and the serve pool stop
sending traffic), in-flight slots decode to completion, then the process
exits 0.

The engine and the batcher decode on threads of their own; the step
functions run under ``torch.no_grad`` in the calling thread, and the
parameters are loaded with ``requires_grad=False``, so no decode step
builds an autograd graph.
"""

from __future__ import annotations

import argparse
import codecs
import dataclasses
import json
import logging
import os
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional

import torch

from torchx_tpu_torch.settings import ENV_TPX_REPLICA_ID

logger = logging.getLogger(__name__)


def _load_params(ckpt_dir: str, cfg: Any, device: torch.device) -> tuple[int, dict]:
    """-> (step, params) of the newest trainer checkpoint step under
    ``ckpt_dir`` that verifies: its ``params.*`` entries, memory-mapped
    (the optimizer moments are never read), checked against ``cfg``'s
    shapes, cast to its dtype and loaded onto ``device``. Read-only: bad
    steps are skipped and logged, never moved."""
    from torchx_tpu_torch.convert import expected_shapes
    from torchx_tpu_torch.models import llama
    from torchx_tpu_torch.parallel.checkpoint import Checkpointer

    reader = Checkpointer(ckpt_dir, read_only=True)
    step, flat = reader.restore_latest(prefix="params.")  # logs each skipped step
    if flat is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    named = {k.removeprefix("params."): v for k, v in flat.items()}
    want = dict(llama.named_leaves(expected_shapes(cfg)))
    got = {name: tuple(t.shape) for name, t in named.items()}
    if got != want:
        raise ValueError(
            f"checkpoint step {step} under {ckpt_dir} holds parameters {got},"
            f" not the config's {want}"
        )
    params = llama.unflatten({name: t.to(device, cfg.dtype) for name, t in named.items()})
    return step, params


class ServiceDraining(RuntimeError):
    """Raised for requests arriving during the SIGTERM drain window; the
    HTTP layer maps it to 503 so load balancers retry elsewhere."""


@dataclasses.dataclass
class _Pending:
    """One sequence awaiting decode, owned by a handler thread until the
    batcher thread fills ``result`` (or ``error``) and sets ``done``."""

    tokens: list[int]
    key: tuple  # (prompt_len, max_new_tokens, temperature) — seed is NOT
    # part of the key: rows carry their own seed and sample from their own
    # folded stream, so differently-seeded requests share a device batch
    seed: int = 0
    done: threading.Event = dataclasses.field(default_factory=threading.Event)
    result: Optional[list[int]] = None
    error: Optional[Exception] = None
    # serving-latency telemetry (bench_serving.py percentiles): when this
    # sequence entered the queue, when its device batch dispatched, and
    # when the batch finished — queue_ms = coalescing/backlog wait,
    # total_ms = request-observed latency
    t_enqueue: float = 0.0
    t_dispatch: float = 0.0
    t_done: float = 0.0


class GenerateService:
    """Model + serving engine, shared by all handler threads.

    ``engine="continuous"`` (default) runs the
    :class:`torchx_tpu_torch.serve.engine.ServeEngine` continuous-batching loop:
    ``max_batch`` decode slots over a paged KV pool, admission/eviction
    every step, any mix of prompt lengths / temperatures / seeds in one
    compiled step.

    ``engine="coalesce"`` keeps the legacy batch-to-completion batcher:
    handler threads enqueue sequences and a single batcher thread drains
    the queue in a short window, merging compatible sequences (same prompt
    length / max_new / temperature) into ONE device batch that decodes to
    completion before the next dispatch.

    Seed semantics (both engines): every sequence samples from its own
    per-row PRNG stream derived from its request seed, so a (prompt, seed,
    temperature) triple reproduces the same tokens regardless of what
    other traffic it batched with: a draw keys on (seed, position), so
    both engines and :func:`torchx_tpu_torch.models.generate.generate`
    agree at the same seed.

    ``device`` is the CUDA card unless ``"cpu"`` is asked for; where no
    card is present, construction raises.
    """

    def __init__(
        self,
        config: str,
        ckpt_dir: Optional[str] = None,
        int8: bool = False,
        seed: int = 0,
        batch_window_ms: float = 3.0,
        max_batch: int = 16,
        engine: str = "continuous",
        block_size: int = 16,
        num_blocks: Optional[int] = None,
        serve_role: str = "unified",
        kv_transfer: Optional[str] = None,
        enable_prefix_cache: bool = True,
        prefix_cache_reserve: float = 0.0,
        device: Optional[str] = None,
    ) -> None:
        if engine not in ("continuous", "coalesce"):
            raise ValueError(
                f"unknown engine {engine!r}; have 'continuous', 'coalesce'"
            )
        if serve_role not in ("unified", "prefill", "decode"):
            raise ValueError(
                f"unknown serve role {serve_role!r}; have 'unified',"
                f" 'prefill', 'decode'"
            )
        if serve_role != "unified" and engine != "continuous":
            raise ValueError(
                f"serve role {serve_role!r} requires the continuous engine"
                f" (got {engine!r})"
            )
        if serve_role == "prefill" and not kv_transfer:
            raise ValueError(
                "prefill role needs a --kv-transfer spec (decode targets)"
            )
        from torchx_tpu_torch.examples.train_llama import resolve_device
        from torchx_tpu_torch.models import llama

        self.device = resolve_device(device)
        configs = llama.all_configs()
        if config not in configs:
            raise ValueError(f"unknown config {config!r}; have {sorted(configs)}")
        self.cfg = configs[config]()
        self.name = config
        if ckpt_dir:
            self.ckpt_step, self.params = _load_params(ckpt_dir, self.cfg, self.device)
        else:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            self.params = llama.init_params(self.cfg, gen, self.device)
            self.ckpt_step = None
        for leaf in llama.leaves(self.params):
            leaf.requires_grad_(False)
        if int8:
            from torchx_tpu_torch.ops.quant import quantize_params

            # in place: each float leaf is freed once its int8 record exists
            quantize_params(self.params, inplace=True)
        self.int8 = int8
        self.requests = 0
        self.batches = 0  # device dispatches (< enqueued seqs when coalesced)
        self.batched_sequences = 0
        self.batch_window_s = batch_window_ms / 1000.0
        self.max_batch = max_batch
        self.engine_mode = engine
        self.serve_role = serve_role
        self.draining = False
        self._closed = False
        self._failure: Optional[str] = None  # a coalesced batch raised
        self._count_lock = threading.Lock()
        self._engine = None
        # prefill role: KV handoffs in flight to decode replicas; drain()
        # waits these out, or a SIGTERM mid-transfer drops the request
        self._transferring = 0
        self._transfer_done = threading.Condition()
        self._transfer = None
        self._spool_stop: Optional[threading.Event] = None
        self._spool_thread: Optional[threading.Thread] = None
        if engine == "continuous":
            from torchx_tpu_torch.serve.engine import ServeEngine

            self._engine = ServeEngine(
                self.params,
                self.cfg,
                max_slots=max_batch,
                block_size=block_size,
                num_blocks=num_blocks,
                enable_prefix_cache=enable_prefix_cache,
                prefix_cache_reserve=prefix_cache_reserve,
            ).start()
            from torchx_tpu_torch.serve import kv_transfer as kvt

            if serve_role == "prefill":
                self._transfer = kvt.make_transfer(kvt.TransferConfig.from_spec(kv_transfer))
            elif serve_role == "decode" and kv_transfer:
                # a decode role given a file: spec pumps the spool dir
                # itself (HTTP decode targets are served by /v1/kv)
                tcfg = kvt.TransferConfig.from_spec(kv_transfer)
                if tcfg.mode == "file":
                    self._spool_stop = threading.Event()
                    self._spool_thread = threading.Thread(
                        target=kvt.serve_spool,
                        args=(tcfg.endpoints[0], self.handle_kv_payload, self._spool_stop),
                        name="tpx-kv-spool",
                        daemon=True,
                    )
                    self._spool_thread.start()
            return
        self._submit_lock = threading.Lock()  # orders enqueue vs close
        self._queue: "queue.Queue[Optional[_Pending]]" = queue.Queue()
        self._batcher = threading.Thread(
            target=self._batch_loop, name="tpx-batcher", daemon=True
        )
        self._batcher.start()

    def close(self) -> None:
        """Stop the serving engine (idempotent). Work enqueued before close
        drains to completion; work racing close fails fast — never hangs."""
        if self._engine is not None:
            self._closed = True
            if self._spool_stop is not None:
                self._spool_stop.set()
            self._engine.drain(timeout=60)
            self._wait_transfers(timeout=60)
            self._engine.stop()
            if self._spool_thread is not None:
                self._spool_thread.join(timeout=5)
            return
        with self._submit_lock:
            # under the same lock generate() enqueues with, so every put
            # either lands before the sentinel (drained by the batcher) or
            # observes _closed and raises
            self._closed = True
            self._queue.put(None)
        self._batcher.join(timeout=60)
        if self._batcher.is_alive():
            # a dispatch (e.g. cold compile) outlived the join budget; the
            # loop will finish it, drain its backlog, and exit on the
            # sentinel — nothing is stranded, we just stop waiting
            logger.warning("batcher still draining at close(); detaching")

    @property
    def failure(self) -> Optional[str]:
        """Why the engine stopped, after a device step raised (a CUDA
        error poisons the context): the service then refuses work."""
        return self._engine.failure if self._engine is not None else self._failure

    def _check_tokens(self, tokens: list[list[int]]) -> None:
        """Token ids from the request, checked before they reach the
        device (an embedding gather out of range would assert there)."""
        vocab = self.cfg.vocab_size
        if any(not 0 <= t < vocab for seq in tokens for t in seq):
            raise ValueError(f"token ids must lie in [0, {vocab})")

    def drain(self, grace_s: float = 30.0) -> bool:
        """SIGTERM grace: stop admitting (:attr:`draining` flips healthz to
        503 and fails new requests fast), finish everything in flight.
        True when fully drained within ``grace_s``."""
        self.draining = True
        if self._engine is not None:
            if self._spool_stop is not None:
                self._spool_stop.set()
            t0 = time.monotonic()
            ok = self._engine.drain(timeout=grace_s)
            # prefill role: handoffs the engine finished may still be
            # streaming to decode replicas; in flight until their reply
            left = max(0.0, grace_s - (time.monotonic() - t0))
            return self._wait_transfers(timeout=left) and ok
        deadline = time.monotonic() + grace_s
        with self._submit_lock:
            self._closed = True
            self._queue.put(None)
        self._batcher.join(timeout=max(0.0, deadline - time.monotonic()))
        return not self._batcher.is_alive()

    def _wait_transfers(self, timeout: float) -> bool:
        """Block until every in-flight KV handoff has its decode reply
        (prefill role; trivially True elsewhere)."""
        deadline = time.monotonic() + timeout
        with self._transfer_done:
            while self._transferring > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._transfer_done.wait(remaining)
        return True

    def handle_kv_payload(self, payload: Any) -> dict:
        """Decode role: admit one prefilled handoff and decode it out.

        Raises :class:`~torchx_tpu_torch.serve.kv_transfer.TransferRejected`
        at another role and while draining, so the prefill side requeues to
        another decode replica."""
        from torchx_tpu_torch.serve.engine import serve_kv_payload
        from torchx_tpu_torch.serve.kv_transfer import TransferRejected, payload_span

        if self.serve_role != "decode":
            raise TransferRejected(f"replica role is {self.serve_role!r}, not decode")
        if self.draining or self._closed:
            raise TransferRejected("decode replica draining; requeue")
        with self._count_lock:
            self.requests += 1
        # decode inside the handoff's originating trace, so the request's
        # stitched timeline covers router -> prefill -> transfer -> decode
        with payload_span(payload, "serve.decode"):
            return serve_kv_payload(self._engine, payload)

    # -- batcher thread ----------------------------------------------------

    def _batch_loop(self) -> None:
        """Single dispatcher: groups compatible pendings, keeps a local
        backlog for incompatible ones so the OLDEST deferred key becomes
        the next group head (no starvation under a sustained stream of one
        key), and on shutdown drains queue + backlog before exiting."""
        from collections import deque

        backlog: "deque[_Pending]" = deque()
        shutdown = False
        while True:
            if backlog:
                item = backlog.popleft()
            elif shutdown:
                return
            else:
                item = self._queue.get()
                if item is None:
                    return
            group = [item]
            deadline = time.monotonic() + self.batch_window_s
            # adopt compatible backlog items first (they are oldest)
            for p in list(backlog):
                if len(group) >= self.max_batch:
                    break
                if p.key == item.key:
                    backlog.remove(p)
                    group.append(p)
            while not shutdown and len(group) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    shutdown = True  # drain backlog, then exit above
                    break
                if nxt.key == item.key:
                    group.append(nxt)
                else:
                    backlog.append(nxt)
            self._dispatch(group)

    def _dispatch(self, group: list[_Pending]) -> None:
        """One device batch of compatible sequences, decoded to completion
        by the dense :func:`generate` (eager: no shape buckets to pad to;
        each row samples from its own seed, as a solo call would)."""
        from torchx_tpu_torch.models import generate as gen

        _, max_new, temperature = group[0].key
        now = time.monotonic()
        for p in group:
            p.t_dispatch = now
        try:
            if self._failure:
                raise RuntimeError(self._failure)
            batch = torch.tensor([p.tokens for p in group], device=self.device)
            out = gen.generate(
                self.params,
                batch,
                self.cfg,
                max_new_tokens=max_new,
                temperature=temperature,
                seed=[p.seed & 0xFFFFFFFF for p in group],
            ).cpu()
            self.batches += 1
            self.batched_sequences += len(group)
            for row, p in enumerate(group):
                p.result = [int(x) for x in out[row]]
        except Exception as e:  # noqa: BLE001 - surfaced per-request
            # inputs were checked before they were queued, so this is a
            # device or program fault: no later batch runs
            if not self._failure:
                logger.exception("coalesced batch failed")
                self._failure = f"batch failed: {type(e).__name__}: {e}"
            for p in group:
                p.error = e
        finally:
            now = time.monotonic()
            for p in group:
                p.t_done = now
                p.done.set()

    def generate(
        self,
        tokens: list[list[int]],
        max_new_tokens: int,
        temperature: float = 0.0,
        seed: int = 0,
        eos_id: Optional[int] = None,
    ) -> list[list[int]]:
        return self.generate_timed(
            tokens, max_new_tokens, temperature=temperature, seed=seed,
            eos_id=eos_id,
        )[0]

    def generate_timed(
        self,
        tokens: list[list[int]],
        max_new_tokens: int,
        temperature: float = 0.0,
        seed: int = 0,
        eos_id: Optional[int] = None,
    ) -> tuple[list[list[int]], dict]:
        """:meth:`generate` plus per-request latency telemetry:
        ``{"queue_ms", "total_ms", "ttft_ms"}`` — the admission/backlog
        wait, the end-to-end latency of the request's slowest sequence,
        and the time to its first decoded token. The HTTP layer attaches
        it to responses as ``timing`` so serving benchmarks can report
        percentiles without server-side scraping. ``eos_id`` stops a
        sequence early on that token (continuous engine only; the
        coalescing baseline always decodes the full budget)."""
        if not tokens or any(not t for t in tokens):
            raise ValueError("tokens must be non-empty sequences")
        self._check_tokens(tokens)
        if self.failure:
            raise RuntimeError(f"generate service failed: {self.failure}")
        longest = max(len(t) for t in tokens)
        if longest + max_new_tokens > self.cfg.max_seq:
            raise ValueError(
                f"prompt length {longest} + {max_new_tokens} new tokens"
                f" exceeds max_seq {self.cfg.max_seq}"
            )
        if self.draining:
            raise ServiceDraining("server is draining; retry elsewhere")
        if self._closed:
            raise RuntimeError("generate service is closed")
        with self._count_lock:
            self.requests += 1
        if self._engine is not None:
            return self._generate_engine(
                tokens, max_new_tokens, temperature, seed, eos_id
            )
        # one _Pending per sequence, keyed by EXACT length (padding would
        # pollute the causal context — correctness over cleverness; one
        # compile per distinct (length, max_new) pair, cached by jit). The
        # batcher thread merges compatible sequences ACROSS requests into
        # single device batches.
        t_enqueue = time.monotonic()
        pendings = [
            _Pending(
                tokens=list(t),
                key=(len(t), max_new_tokens, round(temperature, 3)),
                seed=seed,
                t_enqueue=t_enqueue,
            )
            for t in tokens
        ]
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("generate service is closed")
            for p in pendings:
                self._queue.put(p)
        for p in pendings:
            p.done.wait()
        errors = [p.error for p in pendings if p.error is not None]
        if errors:
            raise errors[0]
        # request-level timing: the slowest sequence bounds the response.
        # batch-to-completion delivers all tokens at once, so the first
        # token arrives when the batch does: ttft == total
        total_ms = round(
            max((p.t_done - p.t_enqueue) for p in pendings) * 1e3, 2
        )
        timing = {
            "queue_ms": round(
                max((p.t_dispatch - p.t_enqueue) for p in pendings) * 1e3, 2
            ),
            "total_ms": total_ms,
            "ttft_ms": total_ms,
        }
        return [p.result for p in pendings], timing

    def _generate_engine(
        self,
        tokens: list[list[int]],
        max_new_tokens: int,
        temperature: float,
        seed: int,
        eos_id: Optional[int],
    ) -> tuple[list[list[int]], dict]:
        from torchx_tpu_torch.serve.engine import EngineStopped, ServeRequest

        if self.serve_role == "prefill":
            return self._generate_disagg(
                tokens, max_new_tokens, temperature, seed, eos_id
            )
        reqs = [
            ServeRequest(
                prompt=list(t),
                max_new_tokens=max_new_tokens,
                temperature=round(temperature, 3),
                seed=seed,
                eos_id=eos_id,
            )
            for t in tokens
        ]
        try:
            for r in reqs:
                self._engine.submit(r)
        except EngineStopped as e:
            raise ServiceDraining(str(e)) from e
        for r in reqs:
            r.wait()
        errors = [r.error for r in reqs if r.error is not None]
        if errors:
            raise RuntimeError(errors[0])
        with self._count_lock:
            self.batches = self._engine.steps
            self.batched_sequences += len(reqs)
        timing = {
            "queue_ms": round(max(r.ttft_s for r in reqs) * 1e3, 2),
            "total_ms": round(
                max(r.t_done - r.t_enqueue for r in reqs) * 1e3, 2
            ),
            "ttft_ms": round(max(r.ttft_s for r in reqs) * 1e3, 2),
        }
        return [r.tokens for r in reqs], timing

    def _generate_disagg(
        self,
        tokens: list[list[int]],
        max_new_tokens: int,
        temperature: float,
        seed: int,
        eos_id: Optional[int],
    ) -> tuple[list[list[int]], dict]:
        """Prefill role: run the cache-aware prefill here, then send each
        prefilled KV payload to a decode replica and relay its completion.
        TTFT is the first token sampled here; the decode replica owns the
        rest of the latency."""
        from torchx_tpu_torch.serve.engine import EngineStopped, ServeRequest

        reqs = [
            ServeRequest(
                prompt=list(t),
                max_new_tokens=max_new_tokens,
                temperature=round(temperature, 3),
                seed=seed,
                eos_id=eos_id,
                prefill_only=True,
            )
            for t in tokens
        ]
        t0 = time.monotonic()
        # the handoff window counts as in flight for drain(): a SIGTERM
        # between prefill and the decode reply must not drop the request
        with self._transfer_done:
            self._transferring += len(reqs)
        try:
            try:
                for r in reqs:
                    self._engine.submit(r)
            except EngineStopped as e:
                raise ServiceDraining(str(e)) from e
            outs: list[list[int]] = []
            ttft = 0.0
            for r in reqs:
                r.wait()
                if r.error is not None:
                    raise RuntimeError(r.error)
                ttft = max(ttft, r.ttft_s)
                if r.handoff is None:  # finished at the first token
                    outs.append(r.tokens)
                    continue
                result = self._transfer.send(r.handoff)
                # transfer replies carry generated tokens only; restore
                # the prompt+generated shape the unified path returns
                outs.append(list(r.prompt) + [int(x) for x in result["tokens"]])
        finally:
            with self._transfer_done:
                self._transferring -= len(reqs)
                self._transfer_done.notify_all()
        with self._count_lock:
            self.batches = self._engine.steps
            self.batched_sequences += len(reqs)
        total_ms = round((time.monotonic() - t0) * 1e3, 2)
        timing = {
            "queue_ms": round(ttft * 1e3, 2),
            "total_ms": total_ms,
            "ttft_ms": round(ttft * 1e3, 2),
        }
        return outs, timing

    def generate_stream(
        self,
        tokens: list[int],
        max_new_tokens: int,
        temperature: float = 0.0,
        seed: int = 0,
        chunk: int = 8,
    ):
        """Yield lists of new token ids as they decode (single sequence).

        Streaming bypasses the batcher — a stream holds the device for its
        whole decode, so it trades coalescing for time-to-first-token;
        token-identical to the batch path at the same seed."""
        if self.draining:
            raise ServiceDraining("server is draining; retry elsewhere")
        if self._closed:
            raise RuntimeError("generate service is closed")
        if not tokens:
            raise ValueError("tokens must be a non-empty sequence")
        if len(tokens) + max_new_tokens > self.cfg.max_seq:
            raise ValueError(
                f"prompt length {len(tokens)} + {max_new_tokens} new tokens"
                f" exceeds max_seq {self.cfg.max_seq}"
            )
        self._check_tokens([tokens])
        if self.failure:
            raise RuntimeError(f"generate service failed: {self.failure}")
        from torchx_tpu_torch.models import generate as gen

        with self._count_lock:
            self.requests += 1
        batch = torch.tensor([tokens], device=self.device)
        # gen.generate_stream ALSO validates eagerly (chunk/max_new/max_seq)
        # before returning its generator, so every argument error surfaces
        # here — before the caller commits an HTTP status line
        it = gen.generate_stream(
            self.params,
            batch,
            self.cfg,
            max_new_tokens=max_new_tokens,
            temperature=round(temperature, 3),
            seed=seed & 0xFFFFFFFF,
            chunk=chunk,
        )

        def rows():
            for piece in it:
                yield [int(x) for x in piece[0]]

        return rows()


def _make_handler(service: GenerateService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt: str, *args: Any) -> None:  # quiet
            pass

        def _reply(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self) -> None:  # noqa: N802
            if self.path == "/healthz":
                body = {
                    "status": "draining" if service.draining else "ok",
                    "model": service.name,
                    "engine": service.engine_mode,
                    "serve_role": service.serve_role,
                    "int8": service.int8,
                    "ckpt_step": service.ckpt_step,
                    "requests": service.requests,
                    "batches": service.batches,
                    "batched_sequences": service.batched_sequences,
                }
                if service._engine is not None:
                    body.update(service._engine.stats())
                    # cache-aware routing inputs: what this replica holds
                    body["block_size"] = service._engine.block_size
                    body["prefix_summary"] = service._engine.prefix_summary()
                failed = service.failure is not None
                if failed:
                    body["status"] = "failed"
                    body["failure"] = service.failure
                body["device"] = str(service.device)
                # a draining (or failed) replica must fail its health check
                # so routers and the serve pool stop sending it traffic
                self._reply(503 if service.draining or failed else 200, body)
            elif self.path == "/metricz":
                from torchx_tpu_torch.obs.metrics import REGISTRY

                text = REGISTRY.render().encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(text)))
                self.end_headers()
                self.wfile.write(text)
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def _handle_kv(self) -> None:
            """Decode-role KV handoff intake (the ``HttpTransfer`` sender):
            octet-stream payload in, decode completion out; 503 at another
            role or while draining, so the prefill side requeues."""
            from torchx_tpu_torch.serve.kv_transfer import KvPayload, TransferRejected

            try:
                n = int(self.headers.get("Content-Length", 0))
                payload = KvPayload.from_bytes(self.rfile.read(n))
                self._reply(200, service.handle_kv_payload(payload))
            except TransferRejected as e:
                self._reply(503, {"error": str(e)})
            except (KeyError, ValueError, TypeError, OSError) as e:
                self._reply(400, {"error": f"{type(e).__name__}: {e}"})
            except Exception as e:  # noqa: BLE001 - surface, don't kill the server
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

        def _stream(self, tokens: list[int], req: dict, text_mode: bool) -> None:
            """JSONL streaming response (one line per decoded chunk,
            terminated by {\"done\": true}); connection closes at the end.

            The iterator is created BEFORE the 200 goes out — validation
            errors still surface as a clean 400. Once streaming has begun
            no status line may be written; mid-stream failures just end
            the stream (the missing done marker tells the client)."""
            it = service.generate_stream(
                tokens,
                max_new_tokens=int(req.get("max_new_tokens", 16)),
                temperature=float(req.get("temperature", 0.0)),
                seed=int(req.get("seed", 0)),
                # clamp: chunk < 1 would raise, huge chunks defeat streaming
                chunk=max(1, min(int(req.get("stream_chunk", 8)), 64)),
            )
            self._streamed = True  # no _reply may run after this point
            self.send_response(200)
            self.send_header("Content-Type", "application/jsonl")
            self.send_header("Connection", "close")
            self.end_headers()
            # multibyte UTF-8 sequences can split across chunk boundaries;
            # an incremental decoder carries the partial bytes over
            decoder = codecs.getincrementaldecoder("utf-8")("replace")
            try:
                for piece in it:
                    if text_mode:
                        payload = {
                            "text_delta": decoder.decode(
                                bytes(b for b in piece if 0 <= b < 256)
                            )
                        }
                    else:
                        payload = {"tokens": piece}
                    self.wfile.write(json.dumps(payload).encode() + b"\n")
                    self.wfile.flush()
                if text_mode:
                    tail = decoder.decode(b"", final=True)
                    if tail:
                        self.wfile.write(
                            json.dumps({"text_delta": tail}).encode() + b"\n"
                        )
                self.wfile.write(b'{"done": true}\n')
            except (BrokenPipeError, ConnectionResetError):
                pass  # client went away mid-stream; nothing to reply to

        def do_POST(self) -> None:  # noqa: N802
            if self.path == "/v1/kv":
                self._handle_kv()
                return
            if self.path != "/v1/generate":
                self._reply(404, {"error": f"unknown path {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                text_mode = "text" in req and "tokens" not in req
                if text_mode:
                    texts = req["text"]
                    if isinstance(texts, str):
                        texts = [texts]
                    tokens = [list(t.encode("utf-8")) for t in texts]
                else:
                    tokens = req["tokens"]
                if req.get("stream"):
                    if len(tokens) != 1:
                        self._reply(
                            400,
                            {"error": "stream mode takes exactly one sequence"},
                        )
                        return
                    self._stream(tokens[0], req, text_mode)
                    return
                eos = req.get("eos_id")
                # adopt the router's trace context (HTTP headers): the
                # replica's span — and, on a prefill role, the KV
                # transfer it triggers — join the request's one trace
                from torchx_tpu_torch.obs import trace as obs_trace

                tid, sid = obs_trace.extract_headers(self.headers)
                with obs_trace.trace_context(tid, sid):
                    with obs_trace.span(
                        f"serve.{service.serve_role}", sequences=len(tokens)
                    ):
                        out, timing = service.generate_timed(
                            tokens,
                            max_new_tokens=int(req.get("max_new_tokens", 16)),
                            temperature=float(req.get("temperature", 0.0)),
                            seed=int(req.get("seed", 0)),
                            eos_id=None if eos is None else int(eos),
                        )
                if text_mode:
                    self._reply(
                        200,
                        {
                            "text": [
                                bytes(
                                    b for b in seq if 0 <= b < 256
                                ).decode("utf-8", errors="replace")
                                for seq in out
                            ],
                            "timing": timing,
                        },
                    )
                else:
                    self._reply(200, {"tokens": out, "timing": timing})
            except ServiceDraining as e:
                self._reply(503, {"error": str(e)})
            except (KeyError, ValueError, TypeError) as e:
                if getattr(self, "_streamed", False):
                    logger.warning("stream aborted mid-flight: %s", e)
                else:
                    self._reply(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 - surface, don't kill the server
                if getattr(self, "_streamed", False):
                    logger.error(
                        "stream aborted mid-flight: %s: %s", type(e).__name__, e
                    )
                else:
                    self._reply(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def serve(
    config: str,
    port: int = 8000,
    ckpt_dir: Optional[str] = None,
    int8: bool = False,
    ready_event: Optional[threading.Event] = None,
    batch_window_ms: float = 3.0,
    max_batch: int = 16,
    engine: str = "continuous",
    block_size: int = 16,
    num_blocks: Optional[int] = None,
    serve_role: str = "unified",
    kv_transfer: Optional[str] = None,
    enable_prefix_cache: bool = True,
    prefix_cache_reserve: float = 0.0,
    device: Optional[str] = None,
) -> ThreadingHTTPServer:
    service = GenerateService(
        config,
        ckpt_dir=ckpt_dir,
        int8=int8,
        batch_window_ms=batch_window_ms,
        max_batch=max_batch,
        engine=engine,
        block_size=block_size,
        num_blocks=num_blocks,
        serve_role=serve_role,
        kv_transfer=kv_transfer,
        enable_prefix_cache=enable_prefix_cache,
        prefix_cache_reserve=prefix_cache_reserve,
        device=device,
    )
    server = ThreadingHTTPServer(("", port), _make_handler(service))
    server.service = service  # for tests / shutdown hooks
    if ready_event is not None:
        ready_event.set()
    return server


def make_drain(
    server: ThreadingHTTPServer,
    service: GenerateService,
    grace_s: float = 30.0,
) -> Any:
    """The SIGTERM drain sequence, as a callable (testable without
    signals): stop admission + fail ``/healthz``, let in-flight slots
    decode out, then shut the HTTP loop down so :func:`main` returns and
    the process exits 0 inside the preemption notice window."""

    def _drain() -> None:
        logger.warning("SIGTERM: draining (grace %.0fs)", grace_s)
        ok = service.drain(grace_s)
        if not ok:
            logger.warning("drain grace expired with requests in flight")
        server.shutdown()

    return _drain


def _install_drain_handler(
    server: ThreadingHTTPServer,
    service: GenerateService,
    grace_s: float = 30.0,
) -> bool:
    """Arm SIGTERM -> graceful drain (mirrors train_llama's preemption
    handler: main thread only, previous handler semantics preserved by
    process exit). The handler thread exists because ``server.shutdown``
    must not run on the thread ``serve_forever`` occupies."""
    import signal

    if threading.current_thread() is not threading.main_thread():
        return False
    drain = make_drain(server, service, grace_s)

    def _on_sigterm(signum, frame):  # noqa: ANN001
        threading.Thread(target=drain, name="tpx-drain", daemon=True).start()

    try:
        signal.signal(signal.SIGTERM, _on_sigterm)
    except (ValueError, OSError):  # no signal support here
        return False
    return True


def main(argv: Optional[list[str]] = None) -> None:
    parser = argparse.ArgumentParser(prog="generate_server", description=__doc__)
    parser.add_argument("--config", required=True, help="model config name")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument(
        "--ckpt-dir", default=None,
        help="serve the newest verified trainer checkpoint under this directory"
        " (read-only; default: seeded random weights)",
    )
    parser.add_argument(
        "--int8", action="store_true",
        help="weight-only int8: quantize every projection matrix (per-output-channel"
        " scales) and run them through the int8-weight matmul kernel",
    )
    parser.add_argument(
        "--device",
        default="cuda",
        help="cuda (default; raises where no card is present) or cpu",
    )
    parser.add_argument(
        "--batch-window-ms",
        type=float,
        default=3.0,
        help="how long the coalescing batcher waits for concurrent requests",
    )
    parser.add_argument(
        "--max-batch",
        type=int,
        default=16,
        help="decode slots (continuous) / max sequences per batch (coalesce)",
    )
    parser.add_argument(
        "--engine",
        choices=("continuous", "coalesce"),
        default="continuous",
        help="continuous batching over paged KV (default), or the legacy"
        " batch-to-completion coalescer",
    )
    parser.add_argument(
        "--block-size", type=int, default=16, help="paged KV-cache block size"
    )
    parser.add_argument(
        "--num-blocks",
        type=int,
        default=None,
        help="paged KV pool size in blocks (default: sized from max-batch)",
    )
    parser.add_argument(
        "--serve-role",
        choices=("unified", "prefill", "decode"),
        default="unified",
        help="'unified' (default) prefills and decodes in one replica;"
        " 'prefill' streams computed KV blocks to decode replicas"
        " (--kv-transfer); 'decode' accepts them on /v1/kv",
    )
    parser.add_argument(
        "--kv-transfer",
        default=None,
        help="prefill->decode transport spec: http:<url>[,<url>...] (decode"
        " replicas, tried in order on rejection) or file:<spool dir>",
    )
    parser.add_argument(
        "--no-prefix-cache",
        action="store_true",
        help="disable the radix prefix cache (every prompt prefills cold)",
    )
    parser.add_argument(
        "--prefix-cache-reserve",
        type=float,
        default=0.0,
        help="cap cached prefix blocks at this fraction of the KV pool"
        " (0 = share the whole pool, evicting under pressure)",
    )
    parser.add_argument(
        "--drain-grace-s",
        type=float,
        default=30.0,
        help="SIGTERM drain budget before shutdown proceeds anyway",
    )
    parser.add_argument(
        "--port-stride",
        type=int,
        default=0,
        help="listen on port + stride * TPX_REPLICA_ID, so a serve pool's"
        " replicas co-located by the local scheduler get distinct ports",
    )
    args = parser.parse_args(argv)
    if args.port_stride and args.port:
        replica_id = int(os.environ.get(ENV_TPX_REPLICA_ID, "0") or "0")
        args.port += args.port_stride * replica_id
    t0 = time.monotonic()
    server = serve(
        args.config,
        args.port,
        args.ckpt_dir,
        args.int8,
        batch_window_ms=args.batch_window_ms,
        max_batch=args.max_batch,
        engine=args.engine,
        block_size=args.block_size,
        num_blocks=args.num_blocks,
        serve_role=args.serve_role,
        kv_transfer=args.kv_transfer,
        enable_prefix_cache=not args.no_prefix_cache,
        prefix_cache_reserve=args.prefix_cache_reserve,
        device=args.device,
    )
    _install_drain_handler(server, server.service, args.drain_grace_s)
    # report the BOUND port: with --port 0 the OS picks one, and whatever
    # launched us (serve pool, smoke test) reads it from this line
    port = server.server_address[1]
    print(
        f"generate_server: {args.config} [{args.engine}] on :{port}"
        f" ({server.service.device})"
        f" (loaded in {time.monotonic() - t0:.1f}s)",
        flush=True,
    )
    server.serve_forever()
    server.server_close()


if __name__ == "__main__":
    main()
