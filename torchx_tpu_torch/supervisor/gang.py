"""Gang health: hang/straggler/partial-loss detection from heartbeats.

Port of :mod:`torchx_tpu.supervisor.gang`, both halves: the in-job lease
writer (:func:`renew_lease`, which the port's trainer calls beside each
heartbeat) and the client's :class:`GangMonitor`. The trace records and the
lease files are the reference's, so either package's monitor judges the
other's jobs.

The scheduler's status API answers "does the backend think the job is
running?" — it cannot see a gang wedged inside a collective, a replica
whose host silently died mid-gang, or one straggler holding the other
N-1 replicas hostage. Those failure modes leave status reading RUNNING
forever while no step ever completes.

This module closes that gap from the *client* side, with no new agent on
the workers: training jobs already emit ``job.first_step``/``step.window``
heartbeats into the session's shared ``trace.jsonl`` (see
``examples/train_llama.py``), and renew small per-replica liveness leases
via :func:`renew_lease`. :class:`GangMonitor` tails both between status
polls and folds them into a :class:`GangVerdict`; the supervisor turns a
``HANG``/``PARTIAL_LOSS`` verdict into kill + classify as
:attr:`FailureClass.HANG <torchx_tpu_torch.specs.api.FailureClass.HANG>` +
resubmit (optionally onto a reshaped mesh — see
``SupervisorPolicy.elastic_reshape``).

Everything here is standard library and file-based on purpose: it runs in
the launcher process, works with any scheduler backend, and survives the
supervisor itself crashing (the evidence is durable JSONL, not in-memory
state).
"""

from __future__ import annotations

import dataclasses
import enum
import json
import os
import time
from typing import Callable, Optional

from torchx_tpu_torch.obs import sinks
from torchx_tpu_torch.util.times import epoch_usec

__all__ = [
    "HEARTBEAT_SPANS",
    "GangState",
    "ReplicaHealth",
    "GangVerdict",
    "GangMonitor",
    "renew_lease",
    "read_leases",
]

#: span names that count as liveness evidence in the trace stream.
HEARTBEAT_SPANS = ("job.first_step", "step.window")

_LEASE_DIR = "leases"


class GangState(str, enum.Enum):
    """What the liveness evidence says about the gang.

    WAITING: no heartbeat/lease seen yet — the job is still compiling or
        warming up; the hang deadline is not armed (a slow first compile
        is indistinguishable from a hang without a first signal). Also
        covers the arming window right after the first evidence, while
        not-yet-seen replicas still have startup-skew grace.
    HEALTHY: every expected replica produced fresh evidence.
    STRAGGLER: all replicas live, but the step spread exceeds the
        configured lag — warn-only, the gang still makes progress.
    PARTIAL_LOSS: some (not all) replicas went stale past the deadline —
        part of the gang is gone while the rest spins in a collective.
    HANG: every replica went stale past the deadline — no progress at
        all while the scheduler still reports RUNNING.
    """

    WAITING = "WAITING"
    HEALTHY = "HEALTHY"
    STRAGGLER = "STRAGGLER"
    PARTIAL_LOSS = "PARTIAL_LOSS"
    HANG = "HANG"

    def __str__(self) -> str:
        return self.value


@dataclasses.dataclass
class ReplicaHealth:
    """Latest liveness evidence for one replica."""

    #: global replica id within the role's gang.
    replica: int
    #: epoch seconds of the freshest heartbeat span seen, 0 if none.
    last_heartbeat: float = 0.0
    #: epoch seconds of the freshest lease renewal seen, 0 if none.
    last_lease: float = 0.0
    #: highest training step the replica reported, -1 if unknown.
    last_step: int = -1

    def last_seen(self) -> float:
        """Freshest evidence from any source (epoch seconds; 0 = never)."""
        return max(self.last_heartbeat, self.last_lease)


@dataclasses.dataclass(frozen=True)
class GangVerdict:
    """One gang-health assessment: state + the evidence behind it."""

    #: the assessment; see :class:`GangState`.
    state: GangState
    #: human-readable one-liner with the numbers behind the verdict.
    detail: str
    #: replicas the gang is supposed to have.
    expected: int
    #: replica ids with fresh evidence.
    live: tuple = ()
    #: replica ids stale past the deadline (or never seen once armed).
    lost: tuple = ()

    @property
    def survivors(self) -> int:
        """How many replicas still show fresh liveness evidence."""
        return len(self.live)

    @property
    def unhealthy(self) -> bool:
        """True for the states the supervisor must act on (kill+retry)."""
        return self.state in (GangState.HANG, GangState.PARTIAL_LOSS)


def _lease_dir(session: Optional[str] = None) -> str:
    return os.path.join(sinks.session_dir(session), _LEASE_DIR)


def renew_lease(
    replica: int, step: int = -1, session: Optional[str] = None
) -> str:
    """Renew a per-replica liveness lease (atomic tiny-JSON write).

    Called from inside the job (alongside the ``step.window`` heartbeat,
    or from a sidecar when the trainer cannot emit spans); the monitor
    treats a lease younger than its TTL as proof of life even when the
    trace stream stalls. Returns the lease file path.
    """
    d = _lease_dir(session)
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"{int(replica)}.json")
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(
            {"replica": int(replica), "step": int(step), "epoch_usec": epoch_usec()},
            f,
        )
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def read_leases(session: Optional[str] = None) -> dict[int, dict]:
    """All current leases for a session, keyed by replica id (torn or
    foreign files are skipped — leases are best-effort evidence)."""
    d = _lease_dir(session)
    out: dict[int, dict] = {}
    try:
        names = os.listdir(d)
    except OSError:
        return out
    for name in names:
        if not name.endswith(".json"):
            continue
        try:
            with open(os.path.join(d, name)) as f:
                rec = json.load(f)
            out[int(rec["replica"])] = rec
        except (OSError, ValueError, KeyError, TypeError):
            continue
    return out


class GangMonitor:
    """Tails a session's heartbeats + leases and judges gang health.

    Reads are incremental (byte offset into ``trace.jsonl``) so calling
    :meth:`check` every few seconds stays O(new evidence), not O(run
    length). The monitor is passive — it never writes; acting on a
    verdict (kill, reclassify, resubmit) is the supervisor's job.

    ``clock`` is injectable for tests; it must be comparable with the
    epoch-microsecond stamps heartbeats and leases carry (i.e. epoch
    seconds).

    ``ignore_evidence_before`` (epoch seconds) drops heartbeats and
    leases stamped earlier — the supervisor sets it to the submission
    time of a *resubmitted* attempt so the fresh monitor never judges
    the new gang on its dead predecessor's stale evidence (which would
    read as an instant HANG during warmup/compile, before the new
    attempt's first heartbeat).
    """

    def __init__(
        self,
        expected_replicas: int,
        hang_deadline_s: float,
        *,
        lease_ttl_s: float = 0.0,
        straggler_step_lag: int = 0,
        session: Optional[str] = None,
        trace_file: Optional[str] = None,
        clock: Callable[[], float] = time.time,
        ignore_evidence_before: float = 0.0,
    ) -> None:
        if expected_replicas < 1:
            raise ValueError(
                f"expected_replicas must be >= 1, got {expected_replicas}"
            )
        if hang_deadline_s <= 0:
            raise ValueError(
                f"hang_deadline_s must be > 0, got {hang_deadline_s}"
            )
        self.expected_replicas = expected_replicas
        self.hang_deadline_s = hang_deadline_s
        self.lease_ttl_s = lease_ttl_s or hang_deadline_s
        self.straggler_step_lag = straggler_step_lag
        self.session = session
        self.trace_file = trace_file or sinks.trace_path(session)
        self.clock = clock
        self.ignore_evidence_before = ignore_evidence_before
        self.replicas: dict[int, ReplicaHealth] = {}
        self._offset = 0
        # set by the first check() that sees any evidence: never-seen
        # replicas get a hang_deadline_s grace from this instant before
        # they count as lost (startup skew — replicas flush their first
        # heartbeat seconds apart)
        self._armed_at: Optional[float] = None

    # -- evidence ingestion -------------------------------------------------

    def observe(self) -> None:
        """Fold new trace lines and current leases into the replica map."""
        self._tail_trace()
        now_lease = read_leases(self.session) if self.session is not None else {}
        if not now_lease and self.session is None:
            now_lease = read_leases()
        for rid, rec in now_lease.items():
            ts = float(rec.get("epoch_usec", 0)) / 1e6
            if ts < self.ignore_evidence_before:
                continue  # leftover lease file from a previous attempt
            h = self.replicas.setdefault(rid, ReplicaHealth(replica=rid))
            h.last_lease = max(h.last_lease, ts)
            step = int(rec.get("step", -1))
            h.last_step = max(h.last_step, step)

    def _tail_trace(self) -> None:
        try:
            with open(self.trace_file, "rb") as f:
                f.seek(self._offset)
                chunk = f.read()
        except OSError:
            return
        if not chunk:
            return
        # hold back a torn final line; re-read it once the writer finishes
        complete, nl, _rest = chunk.rpartition(b"\n")
        if not nl:
            return
        self._offset += len(complete) + 1
        for raw in complete.split(b"\n"):
            if not raw.strip():
                continue
            try:
                rec = json.loads(raw)
            except ValueError:
                continue
            if rec.get("kind") != "span" or rec.get("name") not in HEARTBEAT_SPANS:
                continue
            ts = float(rec.get("start_epoch_usec", 0)) / 1e6
            if ts < self.ignore_evidence_before:
                continue  # a previous attempt's heartbeat
            attrs = rec.get("attrs") or {}
            try:
                rid = int(attrs.get("replica", 0))
            except (TypeError, ValueError):
                rid = 0
            h = self.replicas.setdefault(rid, ReplicaHealth(replica=rid))
            h.last_heartbeat = max(h.last_heartbeat, ts)
            try:
                step = int(attrs.get("step", -1))
            except (TypeError, ValueError):
                step = -1
            h.last_step = max(h.last_step, step)

    # -- judgment -----------------------------------------------------------

    def check(self) -> GangVerdict:
        """Ingest fresh evidence and return the current verdict."""
        self.observe()
        now = self.clock()
        if not self.replicas:
            return GangVerdict(
                state=GangState.WAITING,
                detail="no heartbeats or leases observed yet",
                expected=self.expected_replicas,
            )
        if self._armed_at is None:
            self._armed_at = now
        live, lost, pending = [], [], []
        for rid in range(self.expected_replicas):
            h = self.replicas.get(rid)
            if h is None:
                # never produced evidence: ordinary startup skew can put
                # replicas' first flushes seconds apart, so a silent
                # replica only counts as lost once the hang deadline has
                # passed since the gang armed (first evidence observed)
                if now - self._armed_at <= self.hang_deadline_s:
                    pending.append(rid)
                else:
                    lost.append(rid)
                continue
            fresh = (
                now - h.last_heartbeat <= self.hang_deadline_s
                if h.last_heartbeat
                else False
            )
            if not fresh and h.last_lease:
                fresh = now - h.last_lease <= self.lease_ttl_s
            (live if fresh else lost).append(rid)
        # replicas reporting beyond the expected range still count as live
        # evidence of *something*, but the verdict is over the expected set
        if not live and not pending:
            return GangVerdict(
                state=GangState.HANG,
                detail=(
                    f"all {self.expected_replicas} replicas stale past"
                    f" {self.hang_deadline_s:.1f}s hang deadline"
                ),
                expected=self.expected_replicas,
                live=(),
                lost=tuple(lost),
            )
        if lost:
            return GangVerdict(
                state=GangState.PARTIAL_LOSS,
                detail=(
                    f"{len(lost)}/{self.expected_replicas} replicas stale past"
                    f" {self.hang_deadline_s:.1f}s deadline: {lost}"
                ),
                expected=self.expected_replicas,
                live=tuple(live),
                lost=tuple(lost),
            )
        if pending:
            return GangVerdict(
                state=GangState.WAITING,
                detail=(
                    f"{len(live)}/{self.expected_replicas} replicas"
                    f" reporting; waiting for first evidence from"
                    f" {pending} (armed {now - self._armed_at:.1f}s ago)"
                ),
                expected=self.expected_replicas,
                live=tuple(live),
            )
        if self.straggler_step_lag:
            steps = [
                self.replicas[r].last_step
                for r in live
                if self.replicas[r].last_step >= 0
            ]
            if steps and max(steps) - min(steps) > self.straggler_step_lag:
                return GangVerdict(
                    state=GangState.STRAGGLER,
                    detail=(
                        f"step spread {max(steps) - min(steps)} exceeds"
                        f" straggler lag {self.straggler_step_lag}"
                        f" (min={min(steps)}, max={max(steps)})"
                    ),
                    expected=self.expected_replicas,
                    live=tuple(live),
                )
        return GangVerdict(
            state=GangState.HEALTHY,
            detail=f"{len(live)}/{self.expected_replicas} replicas live",
            expected=self.expected_replicas,
            live=tuple(live),
        )
