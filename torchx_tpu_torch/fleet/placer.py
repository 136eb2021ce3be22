"""Topology-aware gang placement over the modeled fleet (the port's copy
of :mod:`torchx_tpu.fleet.placer`).

Placement is all-or-nothing (gang admission): a decision either names one
free slice per replica or nothing. Preference order, the JAX placer's:

1. **Locality** — all replicas from ONE pool when any single pool can
   host the whole gang (a pool models one network locality domain; a
   unit of up to eight H100s is one NVLink host, a larger unit whole
   hosts), lowest slice indices first (contiguity).
2. **Exact card fit** — a 4-GPU replica lands on a 4-GPU unit before a
   16-GPU unit; fragmenting big units is a last resort.

Before any pool is considered, the analyzer's cost model acts as the
**placement oracle** in the JAX package: for plan-shaped roles its deep
preflight re-runs the static memory fit against *that pool's generation*
and refuses the pools whose verdict is an ERROR; a gang every pool
refuses is **infeasible**. The port's deep preflight comes with the rest
of ``analyze/`` (ROADMAP queue 1 item 2.8), so :func:`hbm_refusal` passes
a role that is not plan-shaped, exactly as the JAX oracle does (its
TPX705 info), and raises :class:`NotImplementedError` naming that item
for a plan-shaped one. It never skips the oracle in silence.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Optional

from torchx_tpu_torch.analyze.plan import plan_shape
from torchx_tpu_torch.fleet.model import FleetModel, GangRequest, SliceUnit
from torchx_tpu_torch.specs.api import Role

logger = logging.getLogger(__name__)


@dataclass
class PlacementDecision:
    """The placer's answer for one gang.

    Attributes:
        units: one free slice per replica when the gang fits NOW
            (empty = not placeable at current free capacity).
        infeasible: non-empty when no pool in the fleet can EVER host the
            gang (oracle refusal or shape mismatch) — the gang should be
            rejected, not queued.
        refusals: per-pool oracle refusal messages (diagnostic detail).
    """

    units: list[SliceUnit] = field(default_factory=list)
    infeasible: str = ""
    refusals: dict[str, str] = field(default_factory=dict)

    @property
    def placed(self) -> bool:
        """True when :attr:`units` covers the whole gang."""
        return bool(self.units)


def require_oracle(role: Role, gang: GangRequest, where: str = "") -> None:
    """The oracle's seam: raise :class:`NotImplementedError` naming ROADMAP
    queue 1 item 2.8 when ``role`` is plan-shaped (a ``--config`` preset,
    the JAX analyzer's own test), since its memory fit needs the deep
    preflight the port has not brought over yet. A role that is not
    plan-shaped returns, as the JAX oracle passes it (TPX705 info)."""
    shape = plan_shape(role)
    if shape is None:
        return
    config, serve = shape
    raise NotImplementedError(
        f"role {role.name!r} is plan-shaped (--config {config},"
        f" {'serving' if serve else 'training'}), so the fleet's placement"
        f" oracle must check its memory fit{where} on"
        f" {gang.replicas * gang.chips_per_replica} cards; that check is the"
        " analyzer's deep preflight, which is not ported yet (ROADMAP queue 1"
        " item 2.8 (analyze/explain.py deep_preflight))"
    )


def hbm_refusal(
    role: Role, gang: GangRequest, hbm_bytes: int, generation: str = ""
) -> Optional[str]:
    """The placement oracle for one (role, pool-generation) pair.

    In the JAX package this re-runs deep preflight with the pool's
    per-chip memory as the budget and the gang's total chips as the
    device count, refusing on any ERROR-severity verdict. Roles that are
    not plan-shaped pass there (nothing to verify — the TPX705 skip is
    info, not an error), and pass here the same way. For a plan-shaped
    role :func:`require_oracle` raises: the port places no gang whose fit
    nobody checked."""
    require_oracle(
        role, gang, where=f" against {generation or 'a'} pool's {hbm_bytes} bytes a card"
    )
    return None


def plan_placement(
    gang: GangRequest,
    model: FleetModel,
    role: Optional[Role] = None,
) -> PlacementDecision:
    """Fit one gang onto the fleet's free slices (see module docstring).

    ``role`` enables the HBM oracle; None (synthetic/bench demand, or
    jobs with no resolvable plan) skips it."""
    decision = PlacementDecision()
    # pools whose slice shape can host one replica at all
    capable = [
        p for p in model.pools if p.shape.gpus >= gang.chips_per_replica
    ]
    if not capable:
        decision.infeasible = (
            f"no pool has {gang.chips_per_replica}-chip slices"
            f" (largest: {max(p.shape.gpus for p in model.pools)})"
        )
        return decision
    # the oracle prunes pools whose generation cannot hold the plan
    allowed = []
    for pool in capable:
        if role is not None:
            refusal = hbm_refusal(
                role,
                gang,
                pool.shape.hbm_bytes_per_gpu,
                generation=pool.shape.accelerator,
            )
            if refusal is not None:
                decision.refusals[pool.name] = refusal
                continue
        allowed.append(pool)
    if not allowed:
        worst = next(iter(decision.refusals.values()))
        decision.infeasible = (
            f"every capable pool refused by the placement oracle ({worst})"
        )
        return decision

    allowed_names = {p.name for p in allowed}
    free = [
        u
        for u in model.free_units()
        if u.pool in allowed_names and u.chips >= gang.chips_per_replica
    ]
    by_pool: dict[str, list[SliceUnit]] = {}
    for u in free:
        by_pool.setdefault(u.pool, []).append(u)

    # 1) a single pool that can host the whole gang: one locality domain.
    #    Tightest fit first (least card waste), then name for stability.
    whole = [
        (units[0].chips - gang.chips_per_replica, pool, units)
        for pool, units in by_pool.items()
        if len(units) >= gang.replicas
    ]
    if whole:
        _waste, _pool, units = min(whole, key=lambda t: (t[0], t[1]))
        decision.units = sorted(units, key=lambda u: u.index)[: gang.replicas]
        return decision

    # 2) spill across pools: exact fits first, then smallest waste, then
    #    stable pool/index order — still no partial placement.
    if len(free) >= gang.replicas:
        ranked = sorted(
            free,
            key=lambda u: (u.chips - gang.chips_per_replica, u.pool, u.index),
        )
        decision.units = ranked[: gang.replicas]
    return decision
