"""The elastic preemption market: who pays when a high class can't place.

The port's copy of :mod:`torchx_tpu.fleet.market`.

When a gang of class *c* cannot place and plain capacity won't appear,
the market takes capacity from gangs of **strictly lower** classes,
cheapest sacrifice first:

* An **elastic** victim (training gang running with a reshapeable mesh)
  is *shrunk*, not killed: the scheduler resubmits it on fewer slices
  through the PR 7 mesh-reshape path (``$TPX_MESH`` through the attempt
  ledger), records the **debt** (its launch size), and grows it back when
  capacity frees. A shrink costs one checkpoint-resume, not the job.
* A **non-elastic** victim falls back to checkpoint-preempt: cancelled
  and requeued at its original position in its class (priority-ordered
  requeue), to re-place when capacity returns.

Victim order: lowest class first (``preemptible`` before ``batch``),
youngest first within a class — the cheapest progress is sacrificed
first. The market is all-or-nothing like placement itself: if the
combined plan cannot free enough suitable slices, NOTHING is executed
(no speculative shrinking that still leaves the demand queued).

This module is the pure decision layer — it inspects victims and returns
a plan; :mod:`torchx_tpu_torch.fleet.api` executes plans through the daemon's
runner.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Union


@dataclass(frozen=True)
class Victim:
    """The market's view of one running gang (built by the scheduler).

    ``suitable`` is True when this gang's slices can host the demanding
    gang's replicas (chip count fits); freeing unsuitable slices helps
    nobody, so such gangs are never victimized for this demand."""

    job: str
    priority: int
    elastic: bool
    replicas: int
    min_replicas: int
    seq: int
    suitable: bool


@dataclass(frozen=True)
class Shrink:
    """Market action: reshape ``job`` down to ``to_replicas`` slices,
    freeing ``freed`` of them, and record the grow-back debt."""

    job: str
    to_replicas: int
    freed: int


@dataclass(frozen=True)
class Preempt:
    """Market action: checkpoint-preempt ``job`` (cancel + requeue at its
    original class position), freeing all ``freed`` of its slices."""

    job: str
    freed: int


MarketAction = Union[Shrink, Preempt]


def plan_market(
    needed_units: int,
    gang_priority: int,
    victims: list[Victim],
) -> list[MarketAction]:
    """Assemble the cheapest all-or-nothing plan freeing ``needed_units``
    suitable slices for a gang of class rank ``gang_priority``.

    Returns the action list, or ``[]`` when no combination of eligible
    victims frees enough (the demand stays queued untouched)."""
    if needed_units <= 0:
        return []
    eligible = [
        v
        for v in victims
        if v.suitable and v.priority > gang_priority
    ]
    # lowest class first, youngest first: cheapest progress pays first
    eligible.sort(key=lambda v: (-v.priority, -v.seq))
    plan: list[MarketAction] = []
    freed = 0
    for v in eligible:
        if freed >= needed_units:
            break
        if v.elastic:
            headroom = v.replicas - v.min_replicas
            if headroom <= 0:
                continue
            take = min(headroom, needed_units - freed)
            plan.append(
                Shrink(job=v.job, to_replicas=v.replicas - take, freed=take)
            )
            freed += take
        else:
            plan.append(Preempt(job=v.job, freed=v.replicas))
            freed += v.replicas
    if freed < needed_units:
        return []
    return plan
