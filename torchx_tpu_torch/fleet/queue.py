"""Gang-aware priority queue + the fleet's durable decision journal.

The port's copy of :mod:`torchx_tpu.fleet.queue`.

Ordering is three-keyed: priority class first (``serve`` beats
``preemptible``), then *fair share within the class* — the tenant with
the fewest chips currently placed goes first, so one chatty tenant
cannot starve its classmates — then submission order. Admission is
gang-aware by construction: a gang sits in this queue until the placer
can fit **all** of its slices; there is no partial-placement state.

The journal is the ``JobStateStore`` idiom reduced to one file: one JSON
line per decision (submit / place / reshape / requeue / terminal /
infeasible), appended on an append-mode fd and fsync'd before the
scheduler acts on it, so a daemon restart replays the exact queue and
placement state (torn trailing lines from a crash are skipped, never
fatal).
"""

from __future__ import annotations

import json
import logging
import os
from dataclasses import dataclass
from typing import Any, Iterator, Mapping, Optional

from torchx_tpu_torch.fleet.model import GangRequest
from torchx_tpu_torch.util.times import epoch_usec

logger = logging.getLogger(__name__)

JOURNAL_FILE = "journal.jsonl"


@dataclass
class QueuedGang:
    """One queue entry: the demand plus its arrival bookkeeping.

    ``seq`` is the FIFO tiebreaker and survives a checkpoint-preempt
    requeue (a preempted gang goes back *ahead* of everything submitted
    after it in its class)."""

    req: GangRequest
    seq: int
    enqueued_at: float


class FleetQueue:
    """The pending-gang set with class/fair-share/FIFO ordering."""

    def __init__(self) -> None:
        self._items: dict[str, QueuedGang] = {}  # job id -> entry
        self._seq = 0

    def next_seq(self) -> int:
        """Allocate the next FIFO sequence number."""
        self._seq += 1
        return self._seq

    def bump_seq(self, floor: int) -> None:
        """Raise the sequence counter to at least ``floor`` (rehydration:
        replayed entries keep their original order; new submits go after)."""
        self._seq = max(self._seq, floor)

    def push(
        self, req: GangRequest, now: float, seq: Optional[int] = None
    ) -> QueuedGang:
        """Enqueue a gang (or re-enqueue a preempted one with its old
        ``seq``); returns the entry."""
        entry = QueuedGang(
            req=req,
            seq=self.next_seq() if seq is None else seq,
            enqueued_at=now,
        )
        self._items[req.job] = entry
        return entry

    def remove(self, job: str) -> Optional[QueuedGang]:
        """Drop a gang from the queue (placed / cancelled / infeasible)."""
        return self._items.pop(job, None)

    def get(self, job: str) -> Optional[QueuedGang]:
        """The queue entry for one job, or None."""
        return self._items.get(job)

    def __len__(self) -> int:
        return len(self._items)

    def ordered(
        self, placed_chips: Optional[Mapping[str, int]] = None
    ) -> list[QueuedGang]:
        """Scheduling order: (class rank, tenant's placed chips, seq).

        ``placed_chips`` maps tenant -> chips currently running; the
        tenant with the least gets served first within a class (classic
        fair share). Missing tenants count as zero."""
        placed = placed_chips or {}

        def key(entry: QueuedGang) -> tuple:
            return (
                entry.req.priority,
                int(placed.get(entry.req.tenant, 0)),
                entry.seq,
            )

        return sorted(self._items.values(), key=key)

    def position(
        self, job: str, placed_chips: Optional[Mapping[str, int]] = None
    ) -> Optional[int]:
        """1-based queue position under the current ordering, or None."""
        for i, entry in enumerate(self.ordered(placed_chips)):
            if entry.req.job == job:
                return i + 1
        return None


def over_quota(
    req: GangRequest,
    placed_chips: Mapping[str, int],
    quotas: Mapping[str, int],
) -> bool:
    """Would placing this gang push its tenant past its chip quota?

    Quotas are expressed in chips; a tenant with no quota entry is
    unlimited. Admission (enqueue) is never quota-gated — only placement
    is, so a gang waits out its tenant's burst instead of bouncing."""
    quota = quotas.get(req.tenant)
    if quota is None:
        return False
    return int(placed_chips.get(req.tenant, 0)) + req.chips > int(quota)


class FleetJournal:
    """Fsync'd JSONL decision log (see module docstring).

    Like the supervisor's attempt ledger, constructing it creates
    nothing; the first :meth:`append` creates the directory. Unlike the
    ledger, appends here are NOT best-effort — a scheduler that cannot
    journal must not act, so ``append`` raises on I/O failure."""

    def __init__(self, path: str) -> None:
        self.path = path

    def append(self, kind: str, **fields: Any) -> None:
        """Durably record one decision before it takes effect."""
        entry = {"kind": kind, "time_usec": epoch_usec(), **fields}
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        # one complete line per write on an append-mode fd (atomic on
        # POSIX), fsynced: the decision is on disk before the scheduler
        # submits/cancels anything it could not reconstruct
        with open(self.path, "a") as f:
            f.write(json.dumps(entry, sort_keys=True) + "\n")
            f.flush()
            os.fsync(f.fileno())

    def entries(self) -> Iterator[dict]:
        """Replay every journaled decision; a torn trailing line (crash
        mid-append) is skipped, not fatal."""
        try:
            f = open(self.path)
        except OSError:
            return
        with f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    doc = json.loads(line)
                except ValueError:
                    logger.warning(
                        "fleet journal %s: skipping torn line", self.path
                    )
                    continue
                if isinstance(doc, dict):
                    yield doc
