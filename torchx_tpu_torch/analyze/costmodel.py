"""Per-step collective bytes of a training plan: the data axes of
:func:`torchx_tpu.analyze.costmodel.collective_traffic`.

The port of the ``_ring`` factor and the ``fsdp`` and ``dp`` terms, over a
copy of the few :class:`~torchx_tpu.analyze.plan.ParallelPlan` and
:class:`~torchx_tpu.analyze.plan.ModelShape` fields they read. The bytes
are the reference's to the byte (``tests/test_torch_profile.py``), so that
a gang's ``grad_sync`` slices are modeled as the JAX trainer's are:

* ``fsdp``: ZeRO-3, every parameter gathered in the forward and again in
  the backward, and the gradient reduce-scattered: ``3 x ring(fsdp)``
  times the parameter bytes;
* ``dp``: the gradient all-reduced over the ``fsdp`` shard a rank holds:
  ``2 x ring(dp)`` times its bytes.

These are the ring algorithm's bytes. The port's ``dp`` sum all-gathers
and sums in rank order (:mod:`torchx_tpu_torch.parallel.overlap`), which
moves ``dp / 2`` times as many; the model keeps the reference's bytes.
The model axes (``tp``, ``sp``, ``ep``, ``pp``) are not ported, and a plan
that sets one raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any

#: Bytes a second one card sends to its peers, by ``generation`` substring
#: (``torch.cuda.get_device_name``): an H100 SXM's NVLink 4, 900 GB/s in
#: both directions together, 450 GB/s each way (NVIDIA's H100 data sheet).
LINK_BYTES_PER_S = {"h100": 450e9}
#: Anywhere else (the CPU): the reference's CPU-sim figure
#: (``torchx_tpu.tune.rank._DEFAULT_PERF``), arbitrary but consistent.
DEFAULT_LINK_BYTES_PER_S = 10e9

_MODEL_AXES = ("pp", "tp", "sp", "ep")


def link_bytes_per_s(generation: str) -> float:
    """The link rate of ``generation`` (a card's name), or the default."""
    name = generation.lower()
    for key, rate in LINK_BYTES_PER_S.items():
        if key in name:
            return rate
    return DEFAULT_LINK_BYTES_PER_S


@dataclasses.dataclass(frozen=True)
class ModelShape:
    """The fields of the reference's ``ModelShape`` the data axes read."""

    param_count: int
    dtype_bytes: int

    @classmethod
    def of(cls, cfg: Any) -> "ModelShape":
        """The shape of a ``LlamaConfig`` (its exact parameter count)."""
        import torch

        itemsize = torch.empty((), dtype=cfg.dtype).element_size()
        return cls(param_count=int(cfg.param_count()), dtype_bytes=itemsize)


@dataclasses.dataclass(frozen=True)
class ParallelPlan:
    """The fields of the reference's ``ParallelPlan`` the data axes read:
    the model and the resolved axis sizes."""

    model: ModelShape
    sizes: dict[str, int]

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
    """Per-step, per-device collective bytes of every live data axis."""
    model_axes = {a: plan.axis(a) for a in _MODEL_AXES if plan.axis(a) > 1}
    if model_axes:
        raise NotImplementedError(
            f"mesh axes {model_axes}: the model axes' traffic is not ported (ROADMAP"
            " queue 1 item 1.3)")
    fsdp, dp = plan.axis("fsdp"), plan.axis("dp")
    param_slice = plan.model.param_count * plan.model.dtype_bytes
    out = []
    if fsdp > 1:
        out.append(AxisTraffic("fsdp", int(3 * _ring(fsdp) * param_slice)))
    if dp > 1:
        out.append(AxisTraffic("dp", int(2 * _ring(dp) * param_slice / fsdp)))
    return out
