"""Fleet scheduler: priority classes, gang placement, preemption market
(the port's copy of :mod:`torchx_tpu.fleet`, on H100 units).

This package turns the control daemon from a pass-through submitter into
a fleet scheduler. Demand arrives as gangs (N replicas of
:class:`~torchx_tpu_torch.specs.api.GpuSlice`-shaped units: up to eight
H100s on one NVLink host, or whole hosts); the scheduler orders them by
priority class and per-tenant fair share, places them all-or-nothing onto
a modeled fleet with pool locality preference, consults the memory
placement oracle (whose plan-shaped half waits for the analyzer, ROADMAP
queue 1 item 2.8: :func:`~torchx_tpu_torch.fleet.placer.require_oracle`),
and — when a high class cannot place — runs an **elastic preemption
market**: shrink the cheapest elastic victim via the mesh-reshape path
instead of killing it, record the debt, grow it back when capacity
frees. Non-elastic victims are checkpoint-preempted and requeued at
their original class position.

Layering: standard library only (``tests/test_torch_isolation.py``). The
decision layers (:mod:`~torchx_tpu_torch.fleet.model`,
:mod:`~torchx_tpu_torch.fleet.queue`, :mod:`~torchx_tpu_torch.fleet.placer`,
:mod:`~torchx_tpu_torch.fleet.market`) are pure; only
:class:`~torchx_tpu_torch.fleet.api.FleetScheduler` touches the world, and
only through the :class:`~torchx_tpu_torch.fleet.api.FleetExecutor` seam the
daemon implements.
"""

from torchx_tpu_torch.fleet.api import (
    FleetExecutor,
    FleetJob,
    FleetScheduler,
    parse_quotas,
)
from torchx_tpu_torch.fleet.market import (
    MarketAction,
    Preempt,
    Shrink,
    Victim,
    plan_market,
)
from torchx_tpu_torch.fleet.model import (
    DEFAULT_CLASS,
    PRIORITY_CLASSES,
    FleetModel,
    GangRequest,
    SlicePool,
    SliceUnit,
    priority_index,
)
from torchx_tpu_torch.fleet.placer import (
    PlacementDecision,
    hbm_refusal,
    plan_placement,
    require_oracle,
)
from torchx_tpu_torch.fleet.queue import (
    FleetJournal,
    FleetQueue,
    QueuedGang,
    over_quota,
)

__all__ = [
    "PRIORITY_CLASSES",
    "DEFAULT_CLASS",
    "priority_index",
    "SliceUnit",
    "SlicePool",
    "GangRequest",
    "FleetModel",
    "FleetQueue",
    "QueuedGang",
    "FleetJournal",
    "over_quota",
    "PlacementDecision",
    "plan_placement",
    "hbm_refusal",
    "require_oracle",
    "Victim",
    "Shrink",
    "Preempt",
    "MarketAction",
    "plan_market",
    "FleetScheduler",
    "FleetExecutor",
    "FleetJob",
    "parse_quotas",
]
