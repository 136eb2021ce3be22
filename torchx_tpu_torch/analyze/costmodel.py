"""The static cost model of a training plan: per-card memory
(:func:`hbm_fit`) and per-step collective bytes (:func:`collective_traffic`),
the port of :mod:`torchx_tpu.analyze.costmodel`.

:func:`hbm_fit` is the analytic estimate beside the traced one
(:func:`torchx_tpu_torch.parallel.aot_fit.trace_fit`): parameters,
AdamW's two moments and the gradients at the parameters' shards, the
activations a remat policy keeps (:func:`_activation_bytes`), the
cross-entropy's logits (:func:`_logits_bytes`) and the batch; for a
serving role the KV pool and the decode state. Its arithmetic is the
reference's, component for component (``tests/test_torch_aot_fit.py``);
the budget is the card's (``hbm_bytes_per_chip``: an H100 80GB's
memory unless the caller reads the card's), never a TPU table's.

The port of the ``_ring`` factor and the ``fsdp``, ``dp``, ``tp``, ``sp``,
``ep`` and ``pp`` terms, over a copy of the few
:class:`~torchx_tpu.analyze.plan.ParallelPlan` and
:class:`~torchx_tpu.analyze.plan.ModelShape` fields they read. The bytes
are the reference's to the byte (``tests/test_torch_profile.py``), so that
a gang's ``grad_sync`` slices are modeled as the JAX trainer's are. With
``b`` the rows and ``s`` the positions a rank computes (``batch / (dp *
fsdp)``, ``seq / sp``), ``layers`` a stage's (``ceil(n_layers / pp)``)
and ``act`` = ``b * s`` times the parameter bytes:

* ``fsdp``: ZeRO-3, every parameter gathered in the forward and again in
  the backward, and the gradient reduce-scattered: ``3 x ring(fsdp)``
  times the bytes of a rank's ``pp`` x ``tp`` block of the parameters (for
  a MoE model, its ``pp`` x ``tp`` x ``ep`` block: the reference divides
  every leaf by ``pp`` and ``ep``, the replicated ones too);
* ``dp``: the gradient all-reduced over the ``fsdp`` shard a rank holds:
  ``2 x ring(dp)`` times its bytes;
* ``tp``: two all-reduces a layer (after ``wo`` and ``w_down``) in the
  forward and their mirrors in the backward, ``4 x layers x 2 x ring(tp)
  x act x dim``;
* ``sp``: each layer's K and V gathered over the sequence,
  ``layers x 2 x ring(sp) x act x 2 x n_kv_heads x head_dim``; with ring
  attention the ``sp - 1`` hops of each layer's K/V block, ``layers x (sp
  - 1) x act x 2 x n_kv_heads x head_dim``;
* ``ep`` (a MoE model): the dispatch and combine all-to-alls forward and
  backward, ``4 x ring(ep) x act x dim x top_k``: one layer's, since the
  reference leaves out the layer count its ``tp`` term has;
* ``pp``: a stage's activations to the next stage and their gradient
  back, ``2 x act x dim x (pp - 1) / pp``.

These are the reference's reckonings, not the port's traffic: the port's
``dp`` x ``sp`` sum all-gathers and adds in rank order
(:mod:`torchx_tpu_torch.parallel.overlap`), which moves ``d / 2`` times a
ring's bytes over ``d`` ranks; its ``sp`` gather carries q with K and V;
the remat recompute repeats the forward's ``tp`` all-reduces and ``sp``
gathers; the vocab-parallel cross-entropy and the tied embedding's
gradient add their own; a MoE layer exchanges no token over ``ep`` and
sums its output over ``ep`` x ``tp`` instead (an all-reduce a layer
forward, again in the recompute, and the gradients of its input and gate
weights backward); the ring's backward sends each K/V block's gradient
back and its remat recompute sends the blocks again; the pipeline
broadcasts the last stage's outputs and stage 0's input gradient to every
stage.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

from torchx_tpu_torch.parallel.aot_fit import DEFAULT_HEADROOM, H100_HBM_BYTES
from torchx_tpu_torch.specs.api import GPU_GENERATIONS

#: Bytes a second one card sends to its peers, by ``generation`` substring
#: (``torch.cuda.get_device_name``), from the specs layer's generation
#: table: an H100 SXM's NVLink 4, 450 GB/s each way.
LINK_BYTES_PER_S = {gen: info["link_bytes_per_s"] for gen, info in GPU_GENERATIONS.items()}
#: Anywhere else (the CPU): the reference's CPU-sim figure
#: (``torchx_tpu.tune.rank._DEFAULT_PERF``), arbitrary but consistent.
DEFAULT_LINK_BYTES_PER_S = 10e9

def link_bytes_per_s(generation: str) -> float:
    """The link rate of ``generation`` (a card's name), or the default."""
    name = generation.lower()
    for key, rate in LINK_BYTES_PER_S.items():
        if key in name:
            return rate
    return DEFAULT_LINK_BYTES_PER_S


@dataclasses.dataclass(frozen=True)
class ModelShape:
    """The fields of the reference's ``ModelShape`` the ported axes and
    :func:`hbm_fit` read."""

    param_count: int
    dtype_bytes: int
    n_layers: int
    dim: int
    n_kv_heads: int
    head_dim: int
    n_experts: int = 0  # 0: dense
    top_k: int = 0
    n_heads: int = 0
    ffn_dim: int = 0
    vocab_size: int = 0
    max_seq: int = 0
    loss_chunk: int = 512
    capacity_factor: float = 2.0

    @property
    def is_moe(self) -> bool:
        """True when the FFN is a mixture-of-experts block."""
        return self.n_experts > 0

    @classmethod
    def of(cls, cfg: Any) -> "ModelShape":
        """The shape of a ``LlamaConfig`` or ``MoEConfig`` (its exact
        parameter count)."""
        import torch

        itemsize = torch.empty((), dtype=cfg.dtype).element_size()
        return cls(param_count=int(cfg.param_count()), dtype_bytes=itemsize,
                   n_layers=cfg.n_layers, dim=cfg.dim, n_kv_heads=cfg.n_kv_heads,
                   head_dim=cfg.head_dim, n_experts=getattr(cfg, "n_experts", 0),
                   top_k=getattr(cfg, "top_k", 0), n_heads=cfg.n_heads,
                   ffn_dim=cfg.ffn_dim, vocab_size=cfg.vocab_size, max_seq=cfg.max_seq,
                   loss_chunk=cfg.loss_chunk,
                   capacity_factor=getattr(cfg, "capacity_factor", 2.0))


@dataclasses.dataclass(frozen=True)
class ParallelPlan:
    """The fields of the reference's ``ParallelPlan`` the ported axes and
    :func:`hbm_fit` read: the model, the resolved axis sizes, the global
    batch and sequence of a step, the remat policy, whether attention runs
    as ring attention over ``sp``, and for a serving role
    its slots, int8 weights and prefix-cache reserve. The budget is a
    card's memory: ``hbm_source`` says whether it was read from the card
    (``"device"``), given (``"override"``) or is the H100 80GB default
    (``"assumed"``)."""

    model: ModelShape
    sizes: dict[str, int]
    batch: int
    seq: int
    remat_policy: str = "full"
    ring_attention: bool = False
    int8: bool = False
    serve: bool = False
    max_batch: int = 16  # serve decode slots
    prefix_reserve: float = 0.0  # prefix-cache block reserve fraction
    hbm_bytes_per_chip: int = H100_HBM_BYTES
    hbm_source: str = "assumed"

    def axis(self, name: str) -> int:
        """Resolved size of one mesh axis (1 when absent)."""
        return int(self.sizes.get(name, 1))

    @property
    def data_shards(self) -> int:
        """Batch-dimension sharding factor (dp * fsdp)."""
        return self.axis("dp") * self.axis("fsdp")


@dataclasses.dataclass(frozen=True)
class HbmFit:
    """Per-card static memory fit."""

    components: dict[str, int]  # name -> bytes (per card)
    total_bytes: int
    budget_bytes: int  # per-card memory
    headroom: float
    fits: bool
    source: str  # where the budget came from (plan.hbm_source)

    @property
    def verdict(self) -> str:
        return "fits" if self.fits else "exceeds"

    def to_dict(self) -> dict:
        return {
            "components": dict(sorted(self.components.items())),
            "total_bytes": self.total_bytes,
            "budget_bytes": self.budget_bytes,
            "headroom": self.headroom,
            "usable_bytes": int(self.budget_bytes * self.headroom),
            "fits": self.fits,
            "verdict": self.verdict,
            "source": self.source,
        }


@dataclasses.dataclass(frozen=True)
class AxisTraffic:
    """Per-step collective bytes one mesh axis moves, per device."""

    axis: str
    bytes_per_step: int


def _ring(k: int) -> float:
    """Ring-algorithm per-device traffic factor for a k-way collective."""
    return (k - 1) / k if k > 1 else 0.0


def hbm_fit(plan: ParallelPlan, headroom: float = DEFAULT_HEADROOM) -> HbmFit:
    """Static per-card memory use against the plan's per-card budget, the
    reference's arithmetic (without its calibration scale)."""
    m = plan.model
    dtype = m.dtype_bytes
    pp, tp, sp, ep = (plan.axis(a) for a in ("pp", "tp", "sp", "ep"))
    # params shard over (fsdp, tp); MoE expert weights over (ep, tp); layers
    # over pp. The reference divides every leaf, the replicated ones too.
    param_shards = pp * plan.axis("fsdp") * tp * (ep if m.is_moe else 1)
    param_bytes = math.ceil(m.param_count * dtype / param_shards)

    comps: dict[str, int] = {}
    b_local = max(1, math.ceil(plan.batch / plan.data_shards))
    s_local = max(1, math.ceil(plan.seq / sp))
    if plan.serve:
        comps["params"] = math.ceil(m.param_count / param_shards) if plan.int8 else param_bytes
        # paged KV pool sized for max_batch full-length sequences
        comps["kv_pool"] = math.ceil(
            plan.max_batch * m.n_layers * 2 * m.max_seq * m.n_kv_heads * m.head_dim
            * dtype / tp)
        comps["decode_state"] = plan.max_batch * m.dim * dtype
        # a prefix-cache reserve holds that fraction of the pool on top of
        # the live sequences' budget
        if plan.prefix_reserve > 0:
            comps["prefix_cache"] = math.ceil(plan.prefix_reserve * comps["kv_pool"])
    else:
        comps["params"] = param_bytes
        comps["optimizer"] = 2 * param_bytes  # AdamW mu + nu in the param dtype
        comps["gradients"] = param_bytes  # the backward's transient peak
        comps["activations"] = _activation_bytes(plan, b_local, s_local)
        comps["logits"] = _logits_bytes(plan, b_local, s_local)
        comps["batch"] = b_local * plan.seq * 4 * 2  # tokens + targets, int32
    total = sum(comps.values())
    budget = plan.hbm_bytes_per_chip
    return HbmFit(components=comps, total_bytes=total, budget_bytes=budget,
                  headroom=headroom, fits=total <= int(budget * headroom),
                  source=plan.hbm_source)


def _activation_bytes(plan: ParallelPlan, b: int, s: int) -> int:
    """Per-card activations of the plan's remat policy, the reference's
    reckoning: ``full`` keeps each layer's input plus one layer's working
    set; ``dots`` also each projection output and two residual adds a
    layer; ``dots_attn`` the attention output too. The reference counts
    one ``[b, s, dim]`` a layer more than its ``"dots"`` saves (the MLP
    residual add: 576 units a token and a layer where its checkpoint saves
    512 at ``llama_tiny``); kept, so that the two estimates match."""
    m = plan.model
    dtype = m.dtype_bytes
    tp = plan.axis("tp")
    layers = max(1, math.ceil(m.n_layers / plan.axis("pp")))
    d = m.dim
    token_bytes = b * s * dtype  # one [b, s] slice, one unit wide

    residuals = layers * token_bytes * d
    saved = 0
    if plan.remat_policy in ("dots", "dots_attn"):
        per_layer_units = (
            m.n_heads * m.head_dim / tp  # q
            + 2 * m.n_kv_heads * m.head_dim / tp  # k, v
            + d  # attn residual add
            + 2 * m.ffn_dim / tp  # gate, up
            + d  # mlp residual add
        )
        if plan.remat_policy == "dots_attn":
            per_layer_units += m.n_heads * m.head_dim / tp
        saved = int(layers * token_bytes * per_layer_units)
    # one layer's live working set during the (re)compute
    working = int(token_bytes * (4 * d + 2 * m.ffn_dim / tp))
    if m.is_moe:
        # GShard dispatch/combine one-hots [b, s, E, capacity] in f32 and the
        # dispatched expert inputs [E/ep, capacity, d]
        e_local = max(1, math.ceil(m.n_experts / plan.axis("ep")))
        cap = max(1, int(m.capacity_factor * s * m.top_k / m.n_experts))
        working += 2 * b * s * m.n_experts * cap * 4
        working += e_local * cap * b * d * dtype
    return int(residuals + saved + working)


def _logits_bytes(plan: ParallelPlan, b: int, s: int) -> int:
    """Cross-entropy logits: f32 ``[b, chunk, vocab / tp]`` and its
    gradient with loss chunking on, the whole ``[b, s, vocab / tp]``
    otherwise."""
    m = plan.model
    chunk = min(s, m.loss_chunk) if m.loss_chunk else s
    return int(2 * b * chunk * math.ceil(m.vocab_size / plan.axis("tp")) * 4)


def collective_traffic(plan: ParallelPlan) -> list[AxisTraffic]:
    """Per-step, per-device collective bytes of every live axis, in the
    reference's order (fsdp, dp, tp, sp, ep, pp)."""
    m = plan.model
    pp, fsdp, dp, tp, sp, ep = (plan.axis(a) for a in ("pp", "fsdp", "dp", "tp", "sp", "ep"))
    b = max(1, math.ceil(plan.batch / (dp * fsdp)))
    s = max(1, math.ceil(plan.seq / sp))
    layers = max(1, math.ceil(m.n_layers / pp))  # a stage's
    act_tok = b * s * m.dtype_bytes
    # the parameter bytes a rank sees un-fsdp-sharded (pp stages, tp blocks
    # and, for a MoE model, ep blocks stay local)
    param_slice = m.param_count * m.dtype_bytes / (pp * tp * (ep if m.is_moe else 1))
    out = []
    if fsdp > 1:
        out.append(AxisTraffic("fsdp", int(3 * _ring(fsdp) * param_slice)))
    if dp > 1:
        out.append(AxisTraffic("dp", int(2 * _ring(dp) * param_slice / fsdp)))
    if tp > 1:
        out.append(AxisTraffic("tp", int(4 * layers * 2 * _ring(tp) * act_tok * m.dim)))
    if sp > 1:
        kv_bytes = act_tok * 2 * m.n_kv_heads * m.head_dim
        if plan.ring_attention:
            out.append(AxisTraffic("sp", int(layers * (sp - 1) * kv_bytes)))
        else:
            out.append(AxisTraffic("sp", int(layers * 2 * _ring(sp) * kv_bytes)))
    if ep > 1 and m.is_moe:
        out.append(AxisTraffic("ep", int(4 * _ring(ep) * act_tok * m.dim * m.top_k)))
    if pp > 1:
        out.append(AxisTraffic("pp", int(2 * act_tok * m.dim * (pp - 1) / pp)))
    return out
