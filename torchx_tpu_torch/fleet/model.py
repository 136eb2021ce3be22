"""The fleet data model: slice pools, gang demands, priority classes (the
port's copy of :mod:`torchx_tpu.fleet.model`, on GPU slices).

The scheduler does not talk to cloud inventory APIs — it schedules onto a
*modeled* fleet: named pools of identical :class:`~torchx_tpu_torch.specs.api
.GpuSlice` shapes (``FleetModel``), each slice being one all-or-nothing
unit of placement. A unit of up to eight H100s is one NVLink host; a
larger unit is whole hosts (``h100-16`` is two), so a gang replica either
gets a whole unit or nothing. Per-generation card counts and memory come
straight from ``specs/api.py``; the placer turns the memory number into a
deep-preflight placement oracle.

Demand is a :class:`GangRequest`: ``replicas`` units of
``chips_per_replica`` GPUs for one tenant in one priority class. The
field and wire names keep the JAX package's ``chips`` (the control
client, the journal and the metrics speak them); here a "chip" is one
card. The class ladder is fixed::

    serve > interactive > batch > preemptible

Everything here is standard library + specs only — the daemon imports it
on its fast path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Optional

from torchx_tpu_torch.specs.api import GpuSlice

#: The priority ladder, highest first. Lower index = scheduled earlier =
#: may take capacity from any class with a higher index (the market).
PRIORITY_CLASSES = ("serve", "interactive", "batch", "preemptible")

#: Classes the preemption market may take capacity from (anything below
#: the top class can be a victim of a strictly higher class).
DEFAULT_CLASS = "batch"


def priority_index(klass: str) -> int:
    """Class name -> rank (0 = highest). Unknown names raise."""
    try:
        return PRIORITY_CLASSES.index(klass)
    except ValueError:
        raise ValueError(
            f"unknown priority class {klass!r};"
            f" known: {', '.join(PRIORITY_CLASSES)}"
        ) from None


@dataclass(frozen=True)
class SliceUnit:
    """One placeable GPU slice inside a pool: the atom of the fleet.

    Attributes:
        uid: stable id, ``"<pool>/<index>"``.
        pool: owning pool name.
        index: position within the pool (contiguity preference sorts on it).
        shape: the pool's :class:`~torchx_tpu_torch.specs.api.GpuSlice`.
    """

    uid: str
    pool: str
    index: int
    shape: GpuSlice

    @property
    def chips(self) -> int:
        """Cards in this slice (the unit of quota accounting)."""
        return self.shape.gpus

    @property
    def hbm_bytes_per_chip(self) -> int:
        """Per-card memory of the slice's generation — the oracle's budget."""
        return self.shape.hbm_bytes_per_gpu


@dataclass(frozen=True)
class SlicePool:
    """``count`` identical slices under one name (one locality domain:
    replicas placed in one pool are considered network-adjacent; the cards
    of one host within a slice share NVLink)."""

    name: str
    shape: GpuSlice
    count: int

    def __post_init__(self) -> None:
        if self.count <= 0:
            raise ValueError(f"pool {self.name!r}: count must be positive")


@dataclass(frozen=True)
class GangRequest:
    """One gang's demand: what the queue orders and the placer fits.

    Attributes:
        job: the fleet-assigned job id (stable across shrink/grow).
        tenant: quota + fair-share accounting key.
        klass: priority class name (one of :data:`PRIORITY_CLASSES`).
        replicas: gang size in slices — all-or-nothing (gang admission).
        chips_per_replica: cards each replica needs from its slice.
        elastic: True when the gang tolerates a mesh-reshape shrink (the
            market shrinks it instead of killing it).
        mesh: launch mesh spec (``"fsdp=-1"`` style) the reshape arithmetic
            resolves and refits; empty = axis defaults.
        min_replicas: the floor a shrink may not cross (>= 1).
    """

    job: str
    tenant: str
    klass: str = DEFAULT_CLASS
    replicas: int = 1
    chips_per_replica: int = 1
    elastic: bool = False
    mesh: str = ""
    min_replicas: int = 1

    def __post_init__(self) -> None:
        priority_index(self.klass)  # validate
        if self.replicas <= 0 or self.chips_per_replica <= 0:
            raise ValueError(
                f"gang {self.job!r}: replicas and chips_per_replica must be"
                " positive"
            )
        if not 1 <= self.min_replicas <= self.replicas:
            raise ValueError(
                f"gang {self.job!r}: min_replicas must be in"
                f" [1, {self.replicas}]"
            )

    @property
    def priority(self) -> int:
        """Class rank (0 = highest)."""
        return priority_index(self.klass)

    @property
    def chips(self) -> int:
        """Total card demand at launch size."""
        return self.replicas * self.chips_per_replica


class FleetModel:
    """The modeled fleet: pools of slices plus the assignment map.

    The model is pure bookkeeping — ``assign``/``release`` never talk to a
    backend. The scheduler layers admission, placement, and the market on
    top of it and keeps it consistent with what was actually submitted.
    """

    def __init__(self, pools: Iterable[SlicePool]) -> None:
        self.pools = list(pools)
        if not self.pools:
            raise ValueError("a fleet needs at least one pool")
        seen: set[str] = set()
        self._units: list[SliceUnit] = []
        for pool in self.pools:
            if pool.name in seen:
                raise ValueError(f"duplicate pool name {pool.name!r}")
            seen.add(pool.name)
            for i in range(pool.count):
                self._units.append(
                    SliceUnit(
                        uid=f"{pool.name}/{i}",
                        pool=pool.name,
                        index=i,
                        shape=pool.shape,
                    )
                )
        self._by_uid = {u.uid: u for u in self._units}
        self._owner: dict[str, str] = {}  # uid -> job id
        # reverse index + stable position, so units_of is O(holdings) —
        # the market calls it per candidate victim per pass, which at
        # 1000-slice sim scale made the O(fleet) scan the bottleneck
        self._held: dict[str, set[str]] = {}  # job id -> uids
        self._pos = {u.uid: i for i, u in enumerate(self._units)}

    # -- construction ------------------------------------------------------

    @classmethod
    def from_spec(cls, spec: str) -> "FleetModel":
        """Parse ``"name:gen-GPUSxCOUNT,..."`` — e.g.
        ``"default:h100-8x4,big:h100-16x2"`` is 4 eight-GPU H100 hosts under
        ``default`` plus 2 two-host units of 16 under ``big``."""
        pools = []
        for part in str(spec).split(","):
            part = part.strip()
            if not part:
                continue
            name, _, rest = part.partition(":")
            if not rest:
                name, rest = "default", part
            gen, _, dims = rest.partition("-")
            chips_s, _, count_s = dims.partition("x")
            try:
                chips, count = int(chips_s), int(count_s or "1")
            except ValueError:
                raise ValueError(
                    f"bad fleet pool spec {part!r};"
                    " expected name:gen-GPUSxCOUNT"
                ) from None
            pools.append(
                SlicePool(
                    name=name.strip(),
                    shape=GpuSlice(accelerator=gen.strip(), gpus=chips),
                    count=count,
                )
            )
        return cls(pools)

    # -- inventory ---------------------------------------------------------

    def units(self) -> list[SliceUnit]:
        """Every slice in the fleet, pool order then index order."""
        return list(self._units)

    def unit(self, uid: str) -> SliceUnit:
        """Look one slice up by uid (KeyError on unknown)."""
        return self._by_uid[uid]

    def free_units(self) -> list[SliceUnit]:
        """Slices with no owner, in stable pool/index order."""
        return [u for u in self._units if u.uid not in self._owner]

    def owner_of(self, uid: str) -> Optional[str]:
        """Owning job id of a slice, or None when free."""
        return self._owner.get(uid)

    def units_of(self, job: str) -> list[SliceUnit]:
        """The slices a job currently holds, pool/index order."""
        held = self._held.get(job)
        if not held:
            return []
        return [
            self._by_uid[uid] for uid in sorted(held, key=self._pos.__getitem__)
        ]

    @property
    def total_chips(self) -> int:
        """Sum of cards over every slice in the model."""
        return sum(u.chips for u in self._units)

    @property
    def free_chips(self) -> int:
        """Sum of cards over currently unowned slices."""
        return sum(u.chips for u in self.free_units())

    # -- assignment --------------------------------------------------------

    def assign(self, uids: Iterable[str], job: str) -> None:
        """Mark slices owned by ``job``; assigning an owned slice raises
        (the scheduler must never double-book a slice)."""
        uids = list(uids)
        for uid in uids:
            if uid not in self._by_uid:
                raise KeyError(f"unknown slice {uid!r}")
            owner = self._owner.get(uid)
            if owner is not None and owner != job:
                raise ValueError(
                    f"slice {uid!r} already owned by {owner!r}"
                )
        for uid in uids:
            self._owner[uid] = job
            self._held.setdefault(job, set()).add(uid)

    def release(self, uids: Iterable[str]) -> None:
        """Free specific slices (no-op for already-free uids)."""
        for uid in uids:
            owner = self._owner.pop(uid, None)
            if owner is not None:
                held = self._held.get(owner)
                if held is not None:
                    held.discard(uid)
                    if not held:
                        del self._held[owner]

    def release_job(self, job: str) -> list[str]:
        """Free every slice a job holds; returns the freed uids."""
        freed = [u.uid for u in self.units_of(job)]
        self.release(freed)
        return freed

    def snapshot(self) -> dict:
        """JSON-shaped inventory view for ``/v1/queue`` / ``tpx-torch queue``."""
        return {
            "pools": [
                {
                    "name": p.name,
                    "accelerator": p.shape.accelerator,
                    "chips_per_slice": p.shape.gpus,
                    "slices": p.count,
                }
                for p in self.pools
            ],
            "chips_total": self.total_chips,
            "chips_free": self.free_chips,
        }
