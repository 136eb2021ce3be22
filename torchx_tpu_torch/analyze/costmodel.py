"""Per-step collective bytes of a training plan: the data axes and the
model axes of :func:`torchx_tpu.analyze.costmodel.collective_traffic`.

The port of the ``_ring`` factor and the ``fsdp``, ``dp``, ``tp``, ``sp``
and ``ep`` terms, over a copy of the few :class:`~torchx_tpu.analyze.plan.ParallelPlan`
and :class:`~torchx_tpu.analyze.plan.ModelShape` fields they read. The
bytes are the reference's to the byte (``tests/test_torch_profile.py``),
so that a gang's ``grad_sync`` slices are modeled as the JAX trainer's
are. With ``b`` the rows and ``s`` the positions a rank computes
(``batch / (dp * fsdp)``, ``seq / sp``) and ``act`` = ``b * s`` times the
parameter bytes:

* ``fsdp``: ZeRO-3, every parameter gathered in the forward and again in
  the backward, and the gradient reduce-scattered: ``3 x ring(fsdp)``
  times the bytes of a rank's ``tp`` block of the parameters (for a MoE
  model, its ``tp`` x ``ep`` block: the reference divides every leaf by
  ``ep``, the replicated ones too);
* ``dp``: the gradient all-reduced over the ``fsdp`` shard a rank holds:
  ``2 x ring(dp)`` times its bytes;
* ``tp``: two all-reduces a layer (after ``wo`` and ``w_down``) in the
  forward and their mirrors in the backward, ``4 x layers x 2 x ring(tp)
  x act x dim``;
* ``sp``: each layer's K and V gathered over the sequence,
  ``layers x 2 x ring(sp) x act x 2 x n_kv_heads x head_dim``;
* ``ep`` (a MoE model): the dispatch and combine all-to-alls forward and
  backward, ``4 x ring(ep) x act x dim x top_k``: one layer's, since the
  reference leaves out the layer count its ``tp`` term has.

These are the reference's reckonings, not the port's traffic: the port's
``dp`` x ``sp`` sum all-gathers and adds in rank order
(:mod:`torchx_tpu_torch.parallel.overlap`), which moves ``d / 2`` times a
ring's bytes over ``d`` ranks; its ``sp`` gather carries q with K and V;
the remat recompute repeats the forward's ``tp`` all-reduces and ``sp``
gathers; the vocab-parallel cross-entropy and the tied embedding's
gradient add their own; a MoE layer exchanges no token over ``ep`` and
sums its output over ``ep`` x ``tp`` instead (an all-reduce a layer
forward, again in the recompute, and the gradients of its input and gate
weights backward). ``pp`` is not ported, and a plan that sets it raises.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

#: Bytes a second one card sends to its peers, by ``generation`` substring
#: (``torch.cuda.get_device_name``): an H100 SXM's NVLink 4, 900 GB/s in
#: both directions together, 450 GB/s each way (NVIDIA's H100 data sheet).
LINK_BYTES_PER_S = {"h100": 450e9}
#: Anywhere else (the CPU): the reference's CPU-sim figure
#: (``torchx_tpu.tune.rank._DEFAULT_PERF``), arbitrary but consistent.
DEFAULT_LINK_BYTES_PER_S = 10e9

_UNPORTED_AXES = ("pp",)


def link_bytes_per_s(generation: str) -> float:
    """The link rate of ``generation`` (a card's name), or the default."""
    name = generation.lower()
    for key, rate in LINK_BYTES_PER_S.items():
        if key in name:
            return rate
    return DEFAULT_LINK_BYTES_PER_S


@dataclasses.dataclass(frozen=True)
class ModelShape:
    """The fields of the reference's ``ModelShape`` the ported axes read."""

    param_count: int
    dtype_bytes: int
    n_layers: int
    dim: int
    n_kv_heads: int
    head_dim: int
    n_experts: int = 0  # 0: dense
    top_k: int = 0

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
                   top_k=getattr(cfg, "top_k", 0))


@dataclasses.dataclass(frozen=True)
class ParallelPlan:
    """The fields of the reference's ``ParallelPlan`` the ported axes read:
    the model, the resolved axis sizes, and the global batch and sequence
    of a step."""

    model: ModelShape
    sizes: dict[str, int]
    batch: int
    seq: int

    def axis(self, name: str) -> int:
        """Resolved size of one mesh axis (1 when absent)."""
        return int(self.sizes.get(name, 1))


@dataclasses.dataclass(frozen=True)
class AxisTraffic:
    """Per-step collective bytes one mesh axis moves, per device."""

    axis: str
    bytes_per_step: int


def _ring(k: int) -> float:
    """Ring-algorithm per-device traffic factor for a k-way collective."""
    return (k - 1) / k if k > 1 else 0.0


def collective_traffic(plan: ParallelPlan) -> list[AxisTraffic]:
    """Per-step, per-device collective bytes of every live ported axis, in
    the reference's order (fsdp, dp, tp, sp, ep)."""
    unported = {a: plan.axis(a) for a in _UNPORTED_AXES if plan.axis(a) > 1}
    if unported:
        raise NotImplementedError(
            f"mesh axes {unported}: their traffic is not ported (pp: ROADMAP queue 1"
            " item 1.4)")
    m = plan.model
    fsdp, dp, tp, sp, ep = (plan.axis(a) for a in ("fsdp", "dp", "tp", "sp", "ep"))
    b = max(1, math.ceil(plan.batch / (dp * fsdp)))
    s = max(1, math.ceil(plan.seq / sp))
    act_tok = b * s * m.dtype_bytes
    # the parameter bytes a rank sees un-fsdp-sharded (tp blocks and, for a
    # MoE model, ep blocks stay local)
    param_slice = m.param_count * m.dtype_bytes / (tp * (ep if m.is_moe else 1))
    out = []
    if fsdp > 1:
        out.append(AxisTraffic("fsdp", int(3 * _ring(fsdp) * param_slice)))
    if dp > 1:
        out.append(AxisTraffic("dp", int(2 * _ring(dp) * param_slice / fsdp)))
    if tp > 1:
        out.append(AxisTraffic("tp", int(4 * m.n_layers * 2 * _ring(tp) * act_tok * m.dim)))
    if sp > 1:
        kv_bytes = act_tok * 2 * m.n_kv_heads * m.head_dim
        out.append(AxisTraffic("sp", int(m.n_layers * 2 * _ring(sp) * kv_bytes)))
    if ep > 1 and m.is_moe:
        out.append(AxisTraffic("ep", int(4 * _ring(ep) * act_tok * m.dim * m.top_k)))
    return out
