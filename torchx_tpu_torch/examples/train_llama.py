"""Llama pretraining on GPUs: the port of
:mod:`torchx_tpu.examples.train_llama`, dense and MoE, on one card and
across a gang of them (the ``pp``, ``dp``, ``fsdp``, ``ep``, ``tp`` and
``sp`` mesh axes).

    python -m torchx_tpu_torch.examples.train_llama --config llama3_1b \\
        --batch 4 --seq 2048 --steps 10 --kernels cuda
    python -m torchx_tpu_torch.apps.spmd_main -m torchx_tpu_torch.examples.train_llama \\
        -- --config llama3_1b --batch 8 --seq 2048 --kernels cuda --mesh fsdp=-1

Runs on the CUDA device unless ``--device cpu`` is given, and raises where
no CUDA device is present. Prints each step's loss, tokens/s and model
FLOPs utilization (MFU; a MoE config counts its active parameters, as the
JAX trainer does) and, for a MoE config, the router's ``router_aux``,
``router_entropy`` and ``router_overflow``, then a JSON summary with the
launch count of each hand-written kernel.

The launcher contract of the JAX trainer: with ``--ckpt-dir`` it resumes
from the newest checkpoint that verifies (the data stream too) and saves
every ``--ckpt-every`` steps (:mod:`torchx_tpu_torch.parallel.checkpoint`);
on SIGTERM (a preemption notice) it saves the current step, waits until it
is durable and exits 0; a run saves its last step whatever ``--steps`` is.
Under the launcher's tracing (``$TPX_TRACE_ID``) it emits the ``launch.*``
spans, the ``job.first_step`` and ``step.window`` heartbeats into the
session's ``trace.jsonl``, renews its replica's liveness lease and writes
its metrics textfile (``metrics-<pid>.prom``) at the end of the run.

``--profile`` (or ``TPX_PROFILE=1``) attributes each timed step to phases
(:mod:`torchx_tpu_torch.obs.profile`) and appends one record per step to
the session's ``profile.jsonl``, which ``tpx profile`` reads; it fences
every step, as the unprofiled loop already does. ``--profile-dir DIR``
writes a ``torch.profiler`` Chrome trace (CPU and CUDA activity) of the
timed steps into DIR.

``--int8`` (and ``--int8-scope all|ffn``, which implies it) routes the layer
projections through the int8 training dot (AQT's numerics, forward and both
backward products in int8; :mod:`torchx_tpu_torch.ops.quant`), as the JAX
trainer maps the flags; MFU keeps the bf16 formula and peak, and the master
weights (and so the checkpoints) stay in the model dtype.

``--mesh`` (``$TPX_MESH`` overrides it), or a process group already up
(``spmd_main`` initializes one; its default mesh is ``fsdp=-1``, the JAX
trainer's), trains the state sharded over the world: each rank keeps its
``fsdp`` shard of every weight and both moments, gathers a layer's weights
for its use, and computes its rows of the global ``--batch``; the gradient
is reduce-scattered over ``fsdp`` and summed over ``dp`` in
``--grad-bucket-mb`` buckets. Rank 0 prints the lines and the summary
(tokens/s per card, MFU on the global tokens, the world, mesh, backend,
buckets, and each rank's launches and peak memory). A preemption notice
on any rank stops every rank after the same step. With ``--ckpt-dir`` a
gang checkpoints as one: each rank writes the blocks of the state it owns,
rank 0 commits the step once every rank's file is durable, and a restore
reads a step saved at any world into the current mesh, so that a gang
resumed on fewer or more cards (``$TPX_MESH``) continues where it stopped
(:mod:`torchx_tpu_torch.parallel.checkpoint`). A MoE config shards its
experts over ``ep`` x ``tp`` (:mod:`torchx_tpu_torch.models.moe`).
``pp`` pipelines the layers over stages (GPipe,
:mod:`torchx_tpu_torch.parallel.pipeline`), and ``--ring-attention`` runs
attention under ``sp`` as ring attention
(:mod:`torchx_tpu_torch.ops.ring_attention`). Refused, as the reference
refuses them: layers that ``pp`` does not divide, and a rank's rows that
the microbatches do not divide. Not ported yet, and refused with the
ROADMAP item named: ``ep * tp`` that does not divide a MoE config's
experts, ``tp`` that does not divide the KV heads, the ffn width (dense) or
the vocabulary, ``sp`` that does not divide the sequence, and int8 matmuls
under ``tp``.

``--remat-policy`` picks what each checkpointed layer saves (``full``,
``dots``, ``dots_attn``: :mod:`torchx_tpu_torch.models.llama`), or
``auto``: the cheapest recompute whose step, traced on meta tensors
(:mod:`torchx_tpu_torch.parallel.aot_fit`), fits the card's memory; a
gang resolves it once, on the smallest card's budget
(:func:`resolve_remat_policy`). It prints ``remat auto -> <policy>
(<verdicts>)`` and reports the policy and the trials in its results.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import itertools
import json
import math
import os
import threading
import time
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from torchx_tpu_torch import _build, distributed, settings
from torchx_tpu_torch.analyze import costmodel
from torchx_tpu_torch.examples.data import TokenDataset
from torchx_tpu_torch.models import llama
from torchx_tpu_torch.obs import metrics as obs_metrics
from torchx_tpu_torch.obs import sinks
from torchx_tpu_torch.obs import trace as obs_trace
from torchx_tpu_torch.obs.profile import StepProfiler, attribution_model
from torchx_tpu_torch.ops.fused import resolve_kernels
from torchx_tpu_torch.parallel import overlap
from torchx_tpu_torch.parallel.checkpoint import Checkpointer
from torchx_tpu_torch.parallel.mesh import Mesh, collective_range, holds_first_copy, make_mesh
from torchx_tpu_torch.parallel.mesh_config import MeshConfig, mesh_sizes_spec, parse_mesh_spec
from torchx_tpu_torch.parallel.prefetch import Prefetcher, device_prefetch

_PROCESS_START = time.monotonic()

# The first train() call of a process anchors launch-to-first-step to the
# process start (import time counts); later calls time only themselves.
_FIRST_TRAIN_PENDING = True

#: Dense bf16 peak FLOP/s of one card, matched as a substring of
#: ``torch.cuda.get_device_name()`` (NVIDIA's data sheet, SXM part).
PEAK_FLOPS = {
    "h100": 989e12,
}

#: Flags of the JAX trainer this port does not have yet: none since pp and
#: ``--ring-attention`` were ported.
NOT_PORTED_FLAGS: tuple[str, ...] = ()


def resolve_device(device: Optional[str | torch.device]) -> torch.device:
    """``None`` means the CUDA device, which must exist: the port never
    carries on quietly on the CPU. ``"cpu"`` must be asked for."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card (pass device='cpu' /"
            " --device cpu to run on the CPU)"
        )
    return dev


def device_peak_flops(device: torch.device) -> Optional[float]:
    """Peak dense bf16 FLOP/s of the card, or None where unknown (and on
    the CPU, which has no MFU)."""
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device).lower()
    for key, flops in PEAK_FLOPS.items():
        if key in name:
            return flops
    return None


def warmup_cosine_decay(
    count: int, peak: float, warmup: int, decay_steps: int, end: float
) -> float:
    """optax.warmup_cosine_decay_schedule(0 -> peak over ``warmup`` steps,
    then cosine to ``end`` at ``decay_steps``, warmup included)."""
    if count < warmup:
        return peak * count / warmup
    span = decay_steps - warmup
    t = min(count - warmup, span)
    cosine = 0.5 * (1 + math.cos(math.pi * t / span))
    alpha = end / peak if peak else 0.0
    return peak * ((1 - alpha) * cosine + alpha)


class AdamW:
    """The JAX trainer's optax chain, in place on the parameter tensors:
    ``clip_by_global_norm(1.0)``, then AdamW (b1 0.9, b2 0.95, eps 1e-8,
    decoupled ``weight_decay`` on every leaf) on
    ``warmup_cosine_decay_schedule(0 -> lr over warmup, decay_steps=100_000
    including warmup, end lr * 0.1)``.

    Moments take each parameter's dtype (bf16 parameters keep bf16 moments,
    as optax does; no f32 master copy), and every step follows optax's
    operation order and casts. Updates the parameters in place and clears
    their ``.grad``.

    Under a mesh the parameters are this rank's shards: ``counted`` flags
    the leaves whose block this rank counts in the global norm (its first
    copy among the ranks of ``norm_group``, ``pp`` x ``fsdp`` x ``ep`` x
    ``tp``, which hold each leaf's blocks once between them;
    :func:`clip_norm_layout`), and
    the counted squared sums are added up over that group in one
    all-reduce. The ``dp`` and ``sp`` copies compute the same norm."""

    B1, B2, EPS, MAX_NORM, DECAY_STEPS = 0.9, 0.95, 1e-8, 1.0, 100_000

    def __init__(
        self, params: list[torch.Tensor], lr: float, warmup: int, weight_decay: float,
        counted: Optional[list[bool]] = None, norm_group: Any = None,
    ) -> None:
        self.params = params
        self.lr, self.warmup, self.weight_decay = lr, warmup, weight_decay
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0
        self.counted, self.norm_group = counted, norm_group

    def _squared_sums(self, grads: list[torch.Tensor]) -> list[torch.Tensor]:
        """Each leaf's sum of squares over the whole (unsharded) leaf: the
        counted blocks' local sums (zero for a block this rank does not
        count) added up over ``norm_group`` in one all-reduce (f32 on the
        wire; a group of one, or a sum with zeros, returns them exact)."""
        import torch.distributed as dist

        sq = [torch.sum(torch.square(g)) for g in grads]
        part = torch.stack([s.float() if c else torch.zeros_like(s, dtype=torch.float32)
                            for s, c in zip(sq, self.counted)])
        with collective_range(self.norm_group):
            dist.all_reduce(part, group=self.norm_group)
        return [part[i].to(s.dtype) for i, s in enumerate(sq)]

    def schedule(self, count: int) -> float:
        """Learning rate of update ``count`` (0-based; 0 at count 0)."""
        return warmup_cosine_decay(
            count, self.lr, self.warmup, self.DECAY_STEPS, self.lr * 0.1
        )

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """Apply one update from the parameters' ``.grad``. -> the global
        gradient norm before clipping (a device scalar; no host sync)."""
        grads = [p.grad for p in self.params]
        if any(g is None for g in grads):
            raise RuntimeError("AdamW.step: a parameter has no gradient")
        if self.counted is None:
            sq = sum(torch.sum(torch.square(g)) for g in grads)
        else:
            sq = sum(self._squared_sums(grads))
        g_norm = torch.sqrt(sq)
        keep = g_norm < self.MAX_NORM
        count_inc = self.count + 1
        b1, b2, f32 = self.B1, self.B2, np.float32
        # optax's bias corrections are f32 scalars
        bc1 = f32(1) - f32(b1) ** f32(count_inc)
        bc2 = f32(1) - f32(b2) ** f32(count_inc)
        step_size = -self.schedule(self.count)
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            dt = g.dtype
            g = torch.where(keep, g, (g / g_norm.to(dt)) * self.MAX_NORM)
            mu.copy_((1 - b1) * g + b1 * mu)
            nu.copy_((1 - b2) * g**2 + b2 * nu)
            mu_hat = mu / torch.tensor(bc1, device=g.device).to(dt)
            nu_hat = nu / torch.tensor(bc2, device=g.device).to(dt)
            u = mu_hat / (torch.sqrt(nu_hat) + self.EPS)
            u = u + self.weight_decay * p
            u = torch.tensor(step_size, dtype=dt, device=g.device) * u
            p.copy_(p + u)
            p.grad = None
        self.count = count_inc
        return g_norm


def make_optimizer(
    params: list[torch.Tensor], lr: float = 3e-4, weight_decay: float = 0.1,
    warmup: int = 100, counted: Optional[list[bool]] = None, norm_group: Any = None,
) -> AdamW:
    """The JAX trainer's ``make_optimizer`` over ``params`` (this rank's
    shards under a mesh: see :class:`AdamW`)."""
    return AdamW(params, lr=lr, warmup=warmup, weight_decay=weight_decay,
                 counted=counted, norm_group=norm_group)


def clip_norm_layout(cfg: llama.LlamaConfig, mesh: Mesh) -> tuple[list[bool], Any]:
    """(``counted``, ``norm_group``) of :class:`AdamW` under ``mesh``: a
    leaf's block counts on the rank that holds its first copy among the
    ``pp`` x ``fsdp`` x ``ep`` x ``tp`` ranks (coordinate 0 on each of
    those axes that does not shard it), so that the all-reduce over them
    adds every block once: a stage's layers, an ``fsdp`` or ``tp`` shard or
    a block of experts on each of its ranks, a replicated leaf (the norms;
    the embedding, whole over ``tp``; the embedding, the final norm and the
    head, whole on every stage; every leaf but the experts over ``ep``)
    once."""
    coords = {a: mesh.coords[a] for a in ("pp", "fsdp", "ep", "tp")}
    return ([holds_first_copy(spec, coords)
             for spec in llama.leaves(llama.mesh_param_specs(cfg, mesh))], mesh.shard_group)


def make_train_step(
    cfg: llama.LlamaConfig, optimizer: AdamW, mesh: Optional[Mesh] = None,
    grad_plan: Optional[overlap.BucketPlan] = None,
) -> Callable[[llama.Params, dict[str, torch.Tensor]], dict[str, torch.Tensor]]:
    """-> ``step(params, batch)``: loss, backward, one optimizer update in
    place. Returns device scalars (no host sync): the loss before the
    update, the router aux vector and the gradient norm.

    Under ``mesh`` (``params`` this rank's shards, ``batch`` its rows) the
    backward leaves each shard's gradient summed over ``fsdp``; the step
    then sums every gradient over ``dp`` x ``sp`` (``grad_plan``'s
    buckets, or one fused sync), and returns the loss of the whole batch,
    the same on every rank."""

    def step(params: llama.Params, batch: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        loss, aux = llama.loss_and_aux(params, batch, cfg, mesh)
        loss.backward()
        loss = loss.detach()
        if mesh is not None:
            import torch.distributed as dist

            overlap.bucketed_sync([p.grad for p in optimizer.params], grad_plan,
                                  mesh.grad_group)
            with collective_range(mesh.token_group):
                dist.all_reduce(loss, group=mesh.token_group)
        grad_norm = optimizer.step()
        return {"loss": loss, "aux": aux.detach(), "grad_norm": grad_norm}

    return step


def synthetic_batch(
    cfg: llama.LlamaConfig, batch: int, seq: int, seed: int = 0,
    device: torch.device | str = "cpu",
) -> dict[str, torch.Tensor]:
    """Uniform random tokens ``[batch, seq+1]`` (the model runs on
    ``tokens[:, :-1]``), drawn on ``device`` from a seeded generator."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    tokens = torch.randint(
        0, cfg.vocab_size, (batch, seq + 1), generator=gen, device=device
    )
    return {"tokens": tokens}


def checkpoint_state(
    params: llama.Params, optimizer: AdamW, step: int
) -> dict[str, torch.Tensor]:
    """The trainer's state as the flat name -> tensor dict a checkpoint
    step holds: ``params.<path>``, ``opt.mu.<path>``, ``opt.nu.<path>``
    (views of the live tensors, so a restore into them lands in place and
    the optimizer's references stay valid; under a mesh, this rank's
    shards), and ``opt.count`` and ``step`` (int64 scalars)."""
    named = llama.named_leaves(params)
    state = {f"params.{name}": p.detach() for name, p in named}
    for (name, _), mu, nu in zip(named, optimizer.mu, optimizer.nu):
        state[f"opt.mu.{name}"] = mu
        state[f"opt.nu.{name}"] = nu
    state["opt.count"] = torch.tensor(optimizer.count, dtype=torch.int64)
    state["step"] = torch.tensor(step, dtype=torch.int64)
    return state


def checkpoint_specs(cfg: llama.LlamaConfig, pp: bool = False) -> dict[str, tuple]:
    """The mesh spec of each sharded entry of :func:`checkpoint_state`:
    a parameter's from ``llama.param_specs`` (a MoE config's experts over
    ``ep`` x ``tp``; with ``pp`` the layers over the stages), and each
    moment its parameter's (the scalars are replicated)."""
    specs = {}
    for name, spec in llama.named_leaves(llama.param_specs(cfg, pp=pp)):
        for prefix in ("params.", "opt.mu.", "opt.nu."):
            specs[prefix + name] = spec
    return specs


# -- launcher hooks: all no-ops unless the launcher traces this process ------


def _traced() -> bool:
    """Under the launcher's tracing, on the replica's first worker: one
    trace stream and one lease per replica, as the gang monitor counts
    replicas."""
    return bool(os.environ.get(settings.ENV_TPX_TRACE_ID)) and distributed.local_rank() == 0


def _replica_id() -> int:
    """This process's replica id in the gang: the launcher-injected
    ``TPX_REPLICA_ID`` (the id the gang monitor expects), else 0."""
    try:
        return int(os.environ.get(settings.ENV_TPX_REPLICA_ID, ""))
    except ValueError:
        return 0


def _renew_liveness_lease(step: Optional[int]) -> None:
    """Best-effort per-replica liveness lease beside each heartbeat, so
    the gang monitor tells a live replica from a stopped gang even when
    the trace stream stalls. Lease I/O never takes training down."""
    try:
        from torchx_tpu_torch.supervisor.gang import renew_lease

        renew_lease(_replica_id(), step=-1 if step is None else int(step))
    except Exception:  # noqa: BLE001 - liveness is advisory
        pass


def _launch_span(name: str, **attrs: Any) -> contextlib.AbstractContextManager:
    """A ``launch.*`` breakdown span under the launcher's tracing, else a
    no-op."""
    if not _traced():
        return contextlib.nullcontext()
    return obs_trace.span(name, **attrs)


def _report_first_step(
    first_step_s: float, resumed_step: int, breakdown: dict[str, float]
) -> None:
    """Join the launcher's trace with a ``job.first_step`` heartbeat
    carrying launch-to-first-step and its stages."""
    if not _traced():
        return
    obs_metrics.LAUNCH_TO_FIRST_STEP.observe(first_step_s)
    obs_trace.heartbeat(
        "job.first_step",
        launch_to_first_step_s=round(first_step_s, 3),
        resumed_step=resumed_step or None,
        replica=_replica_id(),
        **{f"stage_{k}_s": round(v, 3) for k, v in breakdown.items()},
    )
    _renew_liveness_lease(resumed_step)


def _step_heartbeat(**attrs: Any) -> None:
    """A ``step.window`` heartbeat per log line, with the step and its
    loss (exact, so that a run killed before its final summary still
    leaves its losses): the steady-state counterpart of the ``launch.*``
    spans."""
    if not _traced():
        return
    obs_trace.heartbeat("step.window", replica=_replica_id(), **attrs)
    _renew_liveness_lease(int(attrs.get("step", -1)))


def _profile_enabled(flag: bool) -> bool:
    """True when per-step phase profiling is on: the trainer's
    ``--profile`` flag or the launcher-injected ``TPX_PROFILE`` switch."""
    if flag:
        return True
    return os.environ.get(settings.ENV_TPX_PROFILE, "").lower() in (
        "1", "true", "yes", "on",
    )


def _make_profiler(
    cfg: llama.LlamaConfig, tokens_per_step: int, flops_per_token: float,
    peak: Optional[float], dev: torch.device, plan: Optional[costmodel.ParallelPlan] = None,
) -> StepProfiler:
    """A :class:`StepProfiler` on this run's arithmetic. Under a mesh,
    ``plan`` gives each live axis its modeled ``grad_sync`` seconds (the
    cost model's bytes over the card's link rate); without one the
    collective terms are zero. Without a known peak (the CPU) the modeled
    optimizer slice and MFU are zero."""
    return StepProfiler(attribution_model(
        flops_per_token=flops_per_token,
        tokens_per_step=tokens_per_step,
        peak_flops=peak or 0.0,
        param_count=cfg.param_count(),
        plan=plan,
        generation=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    ))


def _install_preempt_handler() -> tuple[Optional[threading.Event], Callable[[], None]]:
    """Arm a SIGTERM preemption-grace handler (main thread only).

    A preemption delivers SIGTERM with a short notice before the hard
    kill. The handler only sets an event that the train loop polls after
    each step; the loop then forces a save, waits until it is durable and
    exits cleanly inside the notice. -> ``(event, restore)``, where
    ``restore()`` reinstates the previous handler; ``(None, noop)`` off
    the main thread."""
    import signal

    if threading.current_thread() is not threading.main_thread():
        return None, lambda: None
    evt = threading.Event()

    def _on_sigterm(signum, frame):  # noqa: ANN001
        evt.set()

    try:
        prev = signal.signal(signal.SIGTERM, _on_sigterm)
    except (ValueError, OSError):  # no signal support here
        return None, lambda: None

    def _restore() -> None:
        try:
            signal.signal(signal.SIGTERM, prev)
        except (ValueError, OSError):
            pass

    return evt, _restore


def check_model_axes(cfg: llama.LlamaConfig, sizes: dict[str, int], seq: int,
                     batch: Optional[int] = None) -> None:
    """Raise where the resolved mesh ``sizes`` asks for what the reference
    refuses: layers that ``pp`` does not divide, and (given the global
    ``batch``) a rank's rows that the pipeline's microbatches do not divide
    (the reference divides the global batch; a rank here splits its own
    rows). Raise, naming the ROADMAP item, where it asks for what is not
    ported: an ``ep * tp`` that does not divide a MoE config's experts, a
    ``tp`` that does not divide the KV heads (so the query heads), the ffn
    width (a dense config's: a MoE config's experts keep theirs whole) or
    the vocabulary, an ``sp`` that does not divide the sequence, int8
    matmuls under ``tp``."""
    from torchx_tpu_torch.parallel import pipeline

    pp, data = sizes["pp"], sizes["dp"] * sizes["fsdp"]
    if pp > 1:
        # no rows to split without the batch (or with one that dp x fsdp
        # does not split, which the mesh refuses itself): the layers alone
        rows = batch // data if batch and batch % data == 0 else 0
        pipeline.validate(cfg.n_layers, pp, rows,
                          pipeline.auto_microbatches(cfg.pp_microbatches, pp, rows))
    ep, tp, sp = sizes["ep"], sizes["tp"], sizes["sp"]
    n_experts = getattr(cfg, "n_experts", 0)
    if n_experts and n_experts % (ep * tp):
        raise NotImplementedError(
            f"ep={ep} x tp={tp} does not divide the {n_experts} experts: each rank of"
            " ep x tp computes whole experts (ROADMAP queue 1 item 1.2)"
        )
    if tp > 1:
        widths = {"n_kv_heads": cfg.n_kv_heads, "vocab_size": cfg.vocab_size}
        if not n_experts:
            widths["ffn_dim"] = cfg.ffn_dim
        odd = {k: v for k, v in widths.items() if v % tp}
        if odd:
            raise NotImplementedError(
                f"tp={tp} does not divide {odd}: each tp rank computes whole KV heads,"
                " ffn columns and vocab rows (ROADMAP queue 1 item 1.2)"
            )
        if cfg.int8_matmuls:
            raise NotImplementedError(
                f"int8 matmuls under tp={tp} are not ported: AQT scales along the"
                " contracting axis, which wo and w_down split over tp (ROADMAP queue 1"
                " item 1.2)"
            )
    if seq % sp:
        raise NotImplementedError(
            f"sp={sp} does not divide the sequence {seq}: each sp rank computes an"
            " equal block of positions (ROADMAP queue 1 item 1.2)"
        )


def _open_mesh(
    mesh: Optional[str | MeshConfig], cfg: llama.LlamaConfig, dev: torch.device,
    batch: Optional[int] = None,
) -> Optional[Mesh]:
    """The training mesh: None (the single-device path) without a mesh and
    without a process group; else ``mesh`` (a ``--mesh`` spec or a
    :class:`MeshConfig`; default ``fsdp=-1``, the JAX trainer's) over the
    group, which a world of one initializes here (NCCL on the card, gloo
    on the CPU). What is not ported raises, naming its ROADMAP item
    (:func:`check_model_axes`), before a group is initialized where the
    spec alone shows it."""
    if mesh is None and not dist.is_initialized():
        return None
    config = parse_mesh_spec(mesh) if isinstance(mesh, str) else mesh or MeshConfig()
    given = {a: max(v, 1) for a, v in dataclasses.asdict(config).items()}
    check_model_axes(cfg, given, cfg.max_seq)
    distributed.init_from_env(backend="gloo" if dev.type == "cpu" else "nccl")
    check_model_axes(cfg, config.resolve(dist.get_world_size()), cfg.max_seq, batch)  # a -1
    return make_mesh(config)


def resolve_remat_policy(
    cfg: llama.LlamaConfig, m: Optional[Mesh], batch: int, seq: int, grad_bucket_mb: Any = 0,
) -> tuple[str, list[Any]]:
    """``remat_policy="auto"`` -> the policy whose traced step fits the
    card, and the trials (:func:`~torchx_tpu_torch.parallel.remat_auto.choose_remat_policy`).
    Without a mesh the probe traces in this process against this card's
    memory. A gang resolves once: the smallest card's memory (a MIN
    all-reduce), rank 0 traces every candidate on rank 0's shards in a
    subprocess, where the gang's own process group is out of reach, and
    broadcasts the answer, so that every rank runs one program. The probe
    assumes one fused gradient sum unless ``grad_bucket_mb`` is a cap."""
    from torchx_tpu_torch.parallel import aot_fit, remat_auto

    if m is None:
        return remat_auto.choose_remat_policy(cfg, None, batch, seq)
    budget = torch.tensor([remat_auto.device_hbm_bytes()], dtype=torch.int64,
                          device="cuda" if m.backend == "nccl" else "cpu")
    dist.all_reduce(budget, op=dist.ReduceOp.MIN)
    answer: list[Any] = [None, None]
    if dist.get_rank() == 0:
        cap = int(grad_bucket_mb) if str(grad_bucket_mb).isdigit() else 0
        requests = [aot_fit.probe_request(
            dataclasses.replace(cfg, remat=True, remat_policy=p), mesh_sizes_spec(m.sizes),
            batch, seq, hbm_bytes=int(budget), devices=dist.get_world_size(),
            grad_bucket_mb=cap) for p in remat_auto.POLICY_ORDER]
        results = dict(zip(remat_auto.POLICY_ORDER, aot_fit.run_probe(requests)))

        def fit_fn(c: llama.LlamaConfig) -> aot_fit.FitResult:
            r = results[c.remat_policy]
            if "error" in r:
                raise RuntimeError(r["error"])
            return aot_fit.FitResult(batch, seq, c.remat_policy, r["args_bytes"],
                                     r["temp_bytes"], r["peak_bytes"], r["fits"])

        answer = list(remat_auto.choose_remat_policy(cfg, None, batch, seq,
                                                     hbm_bytes=int(budget), fit_fn=fit_fn))
    dist.broadcast_object_list(answer, src=0)
    return answer[0], answer[1]


def train(
    cfg: llama.LlamaConfig,
    batch: int,
    seq: int,
    steps: int,
    lr: float = 3e-4,
    warmup: int = 100,
    data_path: Optional[str] = None,
    prefetch: int = 2,
    kernels: str = "reference",
    device: Optional[str | torch.device] = None,
    seed: int = 0,
    log_every: int = 1,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 0,
    on_state: Optional[Callable[[str, dict[str, torch.Tensor]], None]] = None,
    profile: bool = False,
    profile_dir: Optional[str] = None,
    mesh: Optional[str | MeshConfig] = None,
    grad_bucket_mb: Any = 0,
) -> dict[str, Any]:
    """Train ``steps`` steps of ``cfg`` from a seeded init, or from the
    newest checkpoint under ``ckpt_dir``. -> metrics: losses, step times,
    tokens/s and MFU over the steps after the first (which pays the
    kernels' builds and Triton's compiles), peak device memory, each
    kernel's launches, and the launcher's results (``final_step``,
    ``resumed_from_step``, ``preempted``, ``launch_to_first_step_s``).

    With ``mesh``, or inside a process group (``spmd_main``), each rank
    trains its shards of the state (``fsdp``) on its rows of the global
    ``batch`` (:func:`_open_mesh`); ``grad_bucket_mb`` (a cap in MiB,
    ``"auto"``, or 0 for one fused sync) buckets the ``dp`` gradient sum.
    Rank 0 prints; every rank returns the metrics, with each rank's
    launches and peak memory. A group that this call initialized it also
    destroys. Without a mesh and a group, the single-device path runs.

    Checkpoints follow the JAX trainer: saves every ``ckpt_every`` global
    steps (100 when 0), but not on the first step nor on the up to three
    warm-up steps after it, and a forced save of the last step when it is
    not on disk yet; unlike the JAX trainer, a one-step run saves its step
    too. ``on_state(event, state)``, where given, sees
    :func:`checkpoint_state`'s views of the live state right after a
    restore (``"restored"``) and at the end (``"final"``).

    ``profile`` (or ``$TPX_PROFILE``) attributes each timed step (those
    after the first, or the only one) with a :class:`StepProfiler`; its
    summary is ``results["profile"]``. ``profile_dir`` writes a
    ``torch.profiler`` Chrome trace of the timed steps there
    (``results["profile_trace"]``)."""
    had_group = dist.is_initialized()
    try:
        return _train(
            cfg, batch, seq, steps, lr, warmup, data_path, prefetch, kernels, device,
            seed, log_every, ckpt_dir, ckpt_every, on_state, profile, profile_dir,
            mesh, grad_bucket_mb,
        )
    finally:
        if not had_group and dist.is_initialized():
            dist.destroy_process_group()


def _train(
    cfg: llama.LlamaConfig, batch: int, seq: int, steps: int, lr: float, warmup: int,
    data_path: Optional[str], prefetch: int, kernels: str,
    device: Optional[str | torch.device], seed: int, log_every: int,
    ckpt_dir: Optional[str], ckpt_every: int,
    on_state: Optional[Callable[[str, dict[str, torch.Tensor]], None]],
    profile: bool, profile_dir: Optional[str], mesh: Optional[str | MeshConfig],
    grad_bucket_mb: Any,
) -> dict[str, Any]:
    global _FIRST_TRAIN_PENDING
    t_call = time.monotonic()
    launch_ref = _PROCESS_START if _FIRST_TRAIN_PENDING else t_call
    _FIRST_TRAIN_PENDING = False
    # launch-to-first-step by stage (the launch.* spans' names)
    breakdown: dict[str, float] = {}

    def _stage(stage: str, seconds: float) -> None:
        breakdown[stage] = seconds
        obs_metrics.LAUNCH_STAGE_SECONDS.observe(seconds, stage=stage)

    _stage("import", t_call - launch_ref)
    t0 = time.monotonic()
    with _launch_span("launch.backend_init"):
        dev = resolve_device(device)
        cfg = dataclasses.replace(cfg, max_seq=seq, kernels=resolve_kernels(kernels))
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        m = _open_mesh(mesh, cfg, dev, batch)
    _stage("backend_init", time.monotonic() - t0)
    world = dist.get_world_size() if m is not None else 1
    rank0 = m is None or dist.get_rank() == 0
    remat_trials = None
    if cfg.remat_policy == "auto":
        if cfg.remat:
            # the cheapest recompute whose traced step fits the card
            t0 = time.monotonic()
            with _launch_span("launch.remat_select"):
                policy, trials = resolve_remat_policy(cfg, m, batch, seq, grad_bucket_mb)
            cfg = dataclasses.replace(cfg, remat_policy=policy)
            _stage("remat_select", time.monotonic() - t0)
            remat_trials = [dataclasses.asdict(t) for t in trials]
            if rank0:
                verdicts = ", ".join(f"{t.policy}={'fits' if t.fits else 'no'}" for t in trials)
                print(f"remat auto -> {policy} ({verdicts})", flush=True)
        else:
            # remat off: the policy is never consulted, but "auto" must not
            # reach the results as if it were one
            cfg = dataclasses.replace(cfg, remat_policy="full")
    # what the step does: "none" when remat is off
    remat_policy_used = cfg.remat_policy if cfg.remat else "none"
    if grad_bucket_mb not in (0, "0", None, "") and m is None:
        raise ValueError("--grad-bucket-mb buckets the gang's gradient sync: give --mesh")
    if m is not None and dev.type == "cuda" and cfg.kernels == "cuda":
        with distributed.on_process_zero_first():  # one nvcc build, not one a rank
            _build.build()

    ckpt, latest = None, None
    if ckpt_dir:
        ckpt_every = ckpt_every or 100  # ckpt_dir alone must still checkpoint
        # a gang's checkpointers: each rank writes the blocks it owns
        ckpt = Checkpointer(ckpt_dir, save_interval_steps=ckpt_every, mesh=m,
                            specs=checkpoint_specs(cfg, m.sizes["pp"] > 1)
                            if m is not None else None)
        latest = ckpt.latest_step()  # a directory listing, no tensor IO
    resumed_step = latest or 0

    t0 = time.monotonic()
    with _launch_span("launch.init_state"):
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        params = llama.init_params(cfg, gen, dev)
        counted, norm_group = None, None
        if m is not None:
            # every rank draws the whole seeded init and keeps its shards
            params = llama.shard_params(params, cfg, m)
            counted, norm_group = clip_norm_layout(cfg, m)
        optimizer = make_optimizer(llama.leaves(params), lr=lr, warmup=warmup,
                                   counted=counted, norm_group=norm_group)
        if ckpt is not None:  # the pinned snapshot buffers, once
            ckpt.prepare(checkpoint_state(params, optimizer, 0))
    _stage("init_state", time.monotonic() - t0)
    grad_plan, grad_bucket_mb_used, bucket_trials = None, 0, ()
    if grad_bucket_mb not in (0, "0", None, ""):
        grad_bucket_mb_used, bucket_trials = overlap.resolve_bucket_mb(params, grad_bucket_mb)
        grad_plan = overlap.plan_buckets(params, grad_bucket_mb_used * 1024 * 1024)
        if rank0:
            print(f"grad buckets -> {grad_plan.describe()}", flush=True)
    step_fn = make_train_step(cfg, optimizer, m, grad_plan)
    if latest is not None:
        t0 = time.monotonic()
        live = checkpoint_state(params, optimizer, 0)
        with _launch_span("launch.restore", step=latest):
            step_r, restored = ckpt.restore_latest(into=live)
        if restored is None:
            # every step vanished since the listing: train from scratch
            resumed_step = 0
            print("no restorable checkpoint step (all quarantined); starting fresh",
                  flush=True)
        else:
            resumed_step = step_r
            optimizer.count = int(live["opt.count"])
            _stage("restore", time.monotonic() - t0)
            print(f"resumed from checkpoint step {resumed_step}", flush=True)
            if on_state is not None:
                on_state("restored", live)

    t0 = time.monotonic()
    with _launch_span("launch.data_setup"):
        # this rank's rows of every global batch (all of them off a mesh), so
        # that any world sees the same global batches
        mine = m.batch_rows(batch) if m is not None else slice(None)
        if data_path:
            # the stream continues at the restored step (after a fallback
            # past a corrupt step too: it is built after the restore)
            rows = TokenDataset(data_path, seq, batch, seed=seed, start_step=resumed_step)
            batches = device_prefetch(
                ({"tokens": r[mine]} for r in rows), dev, depth=prefetch
            )
        else:
            # a constant device batch through a passthrough prefetcher: one
            # code path and an honest (about 0) data-wait account
            data = synthetic_batch(cfg, batch, seq, seed=seed, device=dev)
            data = {k: v[mine] for k, v in data.items()}
            batches = Prefetcher(itertools.repeat(data), depth=0)
    _stage("data_setup", time.monotonic() - t0)

    counts0 = _build.launch_counts()
    losses, grad_norms, step_times, overlaps = [], [], [], []
    is_moe = bool(getattr(cfg, "n_experts", 0))
    router: dict[str, list[float]] = {"router_aux": [], "router_entropy": [],
                                      "router_overflow": []}
    peak = device_peak_flops(dev)
    flops_per_token = cfg.flops_per_token()
    tokens_per_step = batch * seq  # the global batch's
    # no periodic save on the first step nor on these warm-up steps
    warmup_steps = min(3, max(steps - 2, 0))
    global_step = resumed_step
    first_step_s = None
    window_t0, window_steps, window_wait = time.monotonic(), 0, 0.0
    profiler = None
    if _profile_enabled(profile) and rank0:
        plan = None
        if m is not None:
            plan = costmodel.ParallelPlan(model=costmodel.ModelShape.of(cfg),
                                          sizes=dict(m.sizes), batch=batch, seq=seq,
                                          ring_attention=cfg.use_ring_attention)
        profiler = _make_profiler(cfg, tokens_per_step // world, flops_per_token, peak, dev,
                                  plan=plan)
        # per-next() waits credit the current step's data_wait
        batches.set_wait_observer(profiler.observe_wait)
    torch_prof = None
    profile_trace = None

    prof = None  # the profiler while the step in flight is a timed one

    def _phase(name: str) -> contextlib.AbstractContextManager:
        return prof.phase(name) if prof is not None else contextlib.nullcontext()

    preempt_evt, restore_sigterm = _install_preempt_handler()
    preempted = False
    try:
        for i in range(steps):
            # the timed steps, which step_time_s averages: those after the
            # first (it pays the builds), or the only one
            timed = i > 0 or steps == 1
            if profile_dir and torch_prof is None and timed:
                activities = [torch.profiler.ProfilerActivity.CPU]
                if dev.type == "cuda":
                    activities.append(torch.profiler.ProfilerActivity.CUDA)
                torch_prof = torch.profiler.profile(activities=activities)
                torch_prof.start()
            prof = profiler if timed else None
            if prof is not None:
                prof.begin_step()
            overlaps.append(ckpt is not None and ckpt.writing())
            t0 = time.monotonic()
            with _launch_span("launch.first_step") if i == 0 else contextlib.nullcontext():
                b = next(batches)
                with _phase("forward_backward"):
                    out = step_fn(params, b)
                    loss = float(out["loss"])  # waits for the step
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
            t1 = time.monotonic()
            step_times.append(t1 - t0)
            losses.append(loss)
            grad_norms.append(float(out["grad_norm"]))
            if is_moe:
                aux = out["aux"].tolist()
                router["router_aux"].append(aux[llama.AUX_BALANCE])
                router["router_entropy"].append(aux[llama.AUX_ENTROPY])
                router["router_overflow"].append(aux[llama.AUX_OVERFLOW])
            global_step += 1
            window_steps += 1
            note = ""
            if i == 0:
                first_step_s = t1 - launch_ref
                _stage("first_step", t1 - t0)
                _report_first_step(first_step_s, resumed_step, breakdown)
                note = f" launch-to-first-step={first_step_s:.1f}s"
            if ckpt is not None and i > warmup_steps and global_step % ckpt_every == 0:
                with _phase("checkpoint"):
                    ckpt.save(global_step, checkpoint_state(params, optimizer, global_step))
            if distributed.any_rank(preempt_evt is not None and preempt_evt.is_set()):
                preempted = True
                if ckpt is not None:
                    ckpt.save(global_step, checkpoint_state(params, optimizer, global_step),
                              force=True)
                    # durable BEFORE the hard kill lands; in a gang, every
                    # rank waits here until rank 0 has committed the step
                    ckpt.wait()
                if rank0:
                    print(f"preemption notice: checkpointed step {global_step}, exiting",
                          flush=True)
                break
            if log_every and (i + 1) % log_every == 0:
                with _phase("host"):
                    tps = tokens_per_step / step_times[-1]
                    mfu = f" MFU={tps / world * flops_per_token / peak:.1%}" if peak else ""
                    moe_note = (
                        f" router_aux={router['router_aux'][-1]:.3f}"
                        f" router_entropy={router['router_entropy'][-1]:.2f}"
                        f" router_overflow={router['router_overflow'][-1]:.1%}"
                        if is_moe else ""
                    )
                    if rank0:
                        print(f"step {global_step} loss={loss:.4f} tokens/sec={tps:,.0f}"
                              f"{mfu}{moe_note}{note}", flush=True)
                    now = time.monotonic()
                    window_dt = (now - window_t0) / window_steps
                    wait_per_step = (batches.data_wait_s - window_wait) / window_steps
                    window_t0, window_steps, window_wait = now, 0, batches.data_wait_s
                    obs_metrics.STEP_SECONDS.observe(window_dt, phase="total")
                    obs_metrics.STEP_SECONDS.observe(wait_per_step, phase="data_wait")
                    _step_heartbeat(
                        step=global_step,
                        loss=loss,
                        avg_step_s=round(window_dt, 6),
                        data_wait_s=round(wait_per_step, 6),
                        mfu=round(tokens_per_step / world / window_dt * flops_per_token
                                  / peak, 4)
                        if peak else None,
                        remat_policy=remat_policy_used,
                    )
            if prof is not None:
                prof.end_step(global_step)
        data_wait_s = batches.data_wait_s
    finally:
        restore_sigterm()
        batches.close()
        if torch_prof is not None:
            torch_prof.stop()
    if torch_prof is not None:
        os.makedirs(profile_dir, exist_ok=True)
        profile_trace = os.path.join(profile_dir, f"trace-{os.getpid()}.json")
        torch_prof.export_chrome_trace(profile_trace)
        print(f"profile trace written to {profile_trace}", flush=True)
    buffer_bytes = 0
    if ckpt is not None:
        if ckpt.latest_step() != global_step:  # the final state, any run length
            ckpt.save(global_step, checkpoint_state(params, optimizer, global_step),
                      force=True)
        buffer_bytes = ckpt.buffer_bytes
        ckpt.close()
    profile_summary = None
    if profiler is not None:
        batches.set_wait_observer(None)
        # the summary, the tpx_profile_* gauges and the metrics textfile
        profile_summary = profiler.close()
    elif _traced():
        sinks.flush_metrics()
    if on_state is not None:
        on_state("final", checkpoint_state(params, optimizer, global_step))
    counts = _build.launch_counts()
    launches = {k: counts[k] - counts0[k] for k in counts}
    timed = step_times[1:] or step_times
    step_s = sum(timed) / len(timed)
    tps = tokens_per_step / step_s
    peak_memory = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    checkpoint = None
    if ckpt is not None:
        checkpoint = {
            "dir": ckpt.directory, "every": ckpt_every, "saves": ckpt.saves,
            "writes": ckpt.writes, "restores": ckpt.restores,
            "skipped": ckpt.skipped, "step_overlaps_write": overlaps,
            "buffer_bytes": buffer_bytes,
        }
    by_rank = [(launches, peak_memory, checkpoint)]
    if m is not None:
        by_rank = [None] * world
        dist.all_gather_object(by_rank, (launches, peak_memory, checkpoint))
    return {
        "loss": losses[-1],
        "losses": losses,
        "grad_norms": grad_norms,
        "step_times_s": step_times,
        "step_time_s": step_s,
        "tokens_per_sec": tps,
        "tokens_per_sec_per_card": tps / world,
        "mfu": tps / world * flops_per_token / peak if peak else None,
        "data_wait_s": data_wait_s,
        "peak_memory_bytes": peak_memory,
        "launches": launches,
        "launches_per_step": {k: v / len(losses) for k, v in launches.items()},
        "kernels": cfg.kernels,
        "remat_policy": remat_policy_used,
        # "auto"'s candidates: each policy's traced rank-0 peak and verdict
        "remat_trials": remat_trials,
        # the int8 training dot's scope, None when the projections run in bf16
        "int8_scope": cfg.int8_scope if cfg.int8_matmuls else None,
        "device": str(dev),
        "device_name": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "launch_to_first_step_s": first_step_s,
        "launch_breakdown": breakdown,
        "final_step": global_step,
        "resumed_from_step": resumed_step,
        # True when a SIGTERM notice cut the run short (its last step is
        # durable; the supervisor resubmits from it)
        "preempted": preempted,
        "checkpoint": checkpoint,
        "profile": profile_summary,
        "profile_trace": profile_trace,
        # the gang: world 1, no mesh and no backend on the single-device path
        "world": world,
        "mesh": mesh_sizes_spec(m.sizes) if m is not None else None,
        "backend": m.backend if m is not None else None,
        "grad_bucket_mb": grad_bucket_mb_used,
        "grad_buckets": grad_plan.n_buckets if grad_plan else 0,
        **({"grad_bucket_trials": [t.to_dict() for t in bucket_trials]} if bucket_trials else {}),
        "launches_by_rank": [r[0] for r in by_rank],
        "peak_memory_bytes_by_rank": [r[1] for r in by_rank],
        # each rank's saves, writes and restores (a gang writes a file a rank)
        "checkpoint_by_rank": [r[2] for r in by_rank] if ckpt is not None else None,
        # per step, MoE configs only (the JAX trainer's log fields)
        **(router if is_moe else {}),
    }


def int8_config(cfg: llama.LlamaConfig, int8: bool = False,
                scope: Optional[str] = None) -> llama.LlamaConfig:
    """``--int8`` / ``--int8-scope`` on ``cfg``, as the JAX trainer maps
    them: a scope implies int8, and the default scope is ``"all"``."""
    if int8 or scope:
        return dataclasses.replace(cfg, int8_matmuls=True, int8_scope=scope or "all")
    return cfg


def main(argv: Optional[list[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--config", default="tiny", choices=sorted(llama.all_configs())
    )
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--seq", type=int, default=128)
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--lr", type=float, default=3e-4)
    parser.add_argument("--warmup", type=int, default=100)
    parser.add_argument(
        "--data", default=None,
        help="packed uint32 token file (see datapreproc); synthetic data when unset",
    )
    parser.add_argument(
        "--prefetch", type=int, default=2,
        help="input prefetch depth (batches staged ahead of the step; 0 = synchronous)",
    )
    parser.add_argument(
        "--kernels", default="reference", choices=["reference", "cuda", "pallas"],
        help="'cuda' routes attention and the residual-add + RMSNorm through"
        " the hand-written kernels ('pallas', the JAX trainer's name, means"
        " the same); default the plain PyTorch ops",
    )
    parser.add_argument(
        "--remat-policy", default=None, choices=["full", "dots", "dots_attn", "auto"],
        help="rematerialization policy (default: the config's own); 'auto' traces"
        " each candidate's step and picks the cheapest recompute that fits the card",
    )
    parser.add_argument(
        "--ring-attention", action="store_true",
        help="attention under sp as ring attention: each rank's query block against"
        " the K/V blocks passed around the sp ring, in place of the sequence gather",
    )
    parser.add_argument(
        "--int8", action="store_true",
        help="int8 training matmuls for the layer projections (AQT's numerics)",
    )
    parser.add_argument(
        "--int8-scope", default=None, choices=["all", "ffn"],
        help="which projections to quantize (implies --int8; default all)",
    )
    parser.add_argument(
        "--device", default=None,
        help="torch device (default: cuda, which must exist; 'cpu' to run on the CPU)",
    )
    parser.add_argument(
        "--log-every", type=int, default=None, help="steps between log lines, >= 1"
    )
    parser.add_argument(
        "--ckpt-dir", default=None, help="checkpoint directory (enables save+resume)"
    )
    parser.add_argument(
        "--ckpt-every", type=int, default=0,
        help="save every N steps (default 100 when --ckpt-dir is set)",
    )
    parser.add_argument(
        "--profile", action="store_true",
        help="per-step phase attribution (data_wait / forward_backward /"
        " optimizer / checkpoint / host) appended to the obs session's"
        " profile.jsonl (view with `tpx profile`); also enabled by"
        " TPX_PROFILE=1",
    )
    parser.add_argument(
        "--profile-dir", default=None,
        help="write a torch.profiler Chrome trace of the timed steps here",
    )
    parser.add_argument(
        "--mesh", default=None,
        help="axis sizes pp/dp/fsdp/ep/tp/sp, e.g. dp=2,fsdp=-1, fsdp=2,tp=2,"
        " fsdp=2,ep=2 or pp=2,sp=2; $TPX_MESH overrides it. Default: the"
        " single-device step, or fsdp=-1 inside a process group (spmd_main)",
    )
    parser.add_argument(
        "--grad-bucket-mb", default="0",
        help="bucket the dp gradient sum: a size cap in MiB, 'auto' (the"
        " candidate ladder), or 0 for one fused sync",
    )
    args, unknown = parser.parse_known_args(argv)
    if unknown:
        parser.error(f"unrecognized arguments: {' '.join(unknown)}")
    if args.log_every is not None and args.log_every < 1:
        parser.error("--log-every must be >= 1")
    cfg = int8_config(llama.get_config(args.config), args.int8, args.int8_scope)
    if args.remat_policy:
        cfg = dataclasses.replace(cfg, remat_policy=args.remat_policy)
    if args.ring_attention:
        cfg = dataclasses.replace(cfg, use_ring_attention=True)
    metrics = train(
        cfg,
        args.batch,
        args.seq,
        args.steps,
        lr=args.lr,
        warmup=args.warmup,
        data_path=args.data,
        prefetch=args.prefetch,
        kernels=args.kernels,
        device=args.device,
        log_every=args.log_every or 1,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every,
        profile=args.profile,
        profile_dir=args.profile_dir,
        # an elastic reshape overrides --mesh: the supervisor injects the
        # degraded shape of a resubmitted attempt as $TPX_MESH
        mesh=os.environ.get(settings.ENV_TPX_MESH) or args.mesh,
        grad_bucket_mb=args.grad_bucket_mb,
    )
    if distributed.is_process_zero():
        print("final:", json.dumps(metrics), flush=True)


if __name__ == "__main__":
    main()
