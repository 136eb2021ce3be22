"""The fleet scheduler: queue -> placer -> market, driven by watch events.

The port's copy of :mod:`torchx_tpu.fleet.api`.

:class:`FleetScheduler` sits between the control daemon's submit path and
the reconciler. Submits become :class:`~torchx_tpu_torch.fleet.model
.GangRequest` demands; the daemon's old 429 becomes a queue position.
Every decision — enqueue, place, shrink, grow, requeue, refusal — is
fsync-journaled *before* it is executed, so a daemon restart rehydrates
the exact queue and placement state.

The scheduler is event-driven: it subscribes to the reconciler's watch
stream, and any terminal transition of a fleet-placed job releases its
slices and re-runs the placement loop (grow-backs + queued gangs). The
elastic shrink/grow path is the PR 7 mesh-reshape machinery driven from
the *scheduler* side: the victim is cancelled and resubmitted with a
refit ``$TPX_MESH`` (``shrink_data_axes`` arithmetic), each attempt
recorded in a per-job :class:`~torchx_tpu_torch.supervisor.ledger
.AttemptLedger` exactly like a supervised resubmission, and the recorded
debt is repaid — the gang grows back to its launch mesh — as soon as
capacity frees.

Execution is behind the small :class:`FleetExecutor` seam so the daemon
(real runner), tests, and the bench's virtual-time simulator share one
scheduler implementation.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Optional

from torchx_tpu_torch.fleet.market import Preempt, Shrink, Victim, plan_market
from torchx_tpu_torch.fleet.model import (
    PRIORITY_CLASSES,
    FleetModel,
    GangRequest,
)
from torchx_tpu_torch.fleet.placer import plan_placement, require_oracle
from torchx_tpu_torch.fleet.queue import FleetJournal, FleetQueue, over_quota
from torchx_tpu_torch.obs import metrics as obs_metrics
from torchx_tpu_torch.obs import trace as obs_trace
from torchx_tpu_torch.specs.api import Role, parse_app_handle
from torchx_tpu_torch.supervisor.ledger import AttemptLedger

logger = logging.getLogger(__name__)

#: FleetJob lifecycle states.
QUEUED, RUNNING, DONE, INFEASIBLE = "queued", "running", "done", "infeasible"


@dataclass
class FleetJob:
    """One gang's full scheduler-side record.

    ``recipe`` is the resubmission material (serialized AppDef +
    scheduler + cfg) — journaled with the submit so a restarted daemon
    can still place a queued gang, and re-materialized on every
    shrink/grow resubmit. ``debt`` is the launch replica count owed to a
    shrunk gang (0 = whole)."""

    req: GangRequest
    recipe: dict
    seq: int
    enqueued_at: float
    state: str = QUEUED
    handle: str = ""
    units: list[str] = field(default_factory=list)
    cur_replicas: int = 0
    debt: int = 0
    reason: str = ""
    _role_cache: Optional[Role] = field(default=None, repr=False)

    @property
    def shrunk(self) -> bool:
        """Running below launch size with a grow-back owed."""
        return self.state == RUNNING and self.debt > 0

    def role(self) -> Optional[Role]:
        """The gang's first role, materialized from the recipe (None for
        synthetic demand with no AppDef — the oracle then skips it)."""
        if self._role_cache is None and self.recipe.get("appdef"):
            from torchx_tpu_torch.specs.serialize import appdef_from_dict

            app = appdef_from_dict(self.recipe["appdef"])
            if app.roles:
                self._role_cache = app.roles[0]
        return self._role_cache


class FleetExecutor:
    """What the scheduler needs from the world to act on a decision.

    The daemon implements this over its Runner (materialize + submit +
    reconciler tracking); tests and the bench substitute fakes. Both
    methods are called with the scheduler's lock held — implementations
    must not call back into the scheduler."""

    def schedule(self, job: FleetJob, mesh_spec: Optional[str]) -> str:
        """Materialize ``job.recipe`` at ``job.cur_replicas`` replicas
        (injecting ``$TPX_MESH`` when ``mesh_spec`` is set) and submit;
        returns the app handle."""
        raise NotImplementedError

    def cancel(self, handle: str) -> None:
        """Best-effort cancel of a previously returned handle."""
        raise NotImplementedError


def parse_quotas(specs: Optional[list[str]]) -> dict[str, int]:
    """CLI quota flags (``tenant=chips`` strings) -> quota map."""
    quotas: dict[str, int] = {}
    for item in specs or []:
        tenant, _, chips = str(item).partition("=")
        if not tenant or not chips:
            raise ValueError(f"bad quota {item!r}; expected tenant=chips")
        quotas[tenant.strip()] = int(chips)
    return quotas


class FleetScheduler:
    """Priority classes + quotas + topology-aware placement + the market.

    Args:
        model: the modeled fleet to place onto.
        state_dir: journal + attempt-ledger root (the daemon passes its
            own state dir; everything lands under ``<state_dir>/fleet``).
        quotas: per-tenant chip quotas (absent tenant = unlimited).
        clock: injectable monotonic clock (tests/bench drive virtual time).
    """

    def __init__(
        self,
        model: FleetModel,
        state_dir: str,
        quotas: Optional[dict[str, int]] = None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.model = model
        self.quotas = dict(quotas or {})
        self.clock = clock
        root = os.path.join(state_dir, "fleet")
        self.journal = FleetJournal(os.path.join(root, "journal.jsonl"))
        self._ledger_root = os.path.join(root, "attempts")
        self.queue = FleetQueue()
        self._jobs: dict[str, FleetJob] = {}
        self._by_handle: dict[tuple[str, str], str] = {}
        self._executor: Optional[FleetExecutor] = None
        self._lock = threading.RLock()
        self._counter = 0
        # jobs whose executor submit failed during the CURRENT loop; they
        # stay queued but are not retried until the next loop trigger
        self._loop_failed: set[str] = set()
        self.reshapes = 0  # shrinks executed (kills avoided)
        self.grows = 0
        self.kills = 0  # checkpoint-preempts (non-elastic victims)
        # telemetry-plane burn-rate probe (set_slo_signal); None = no
        # telemetry, market behaves as before
        self._slo_signal: Optional[Callable[[], Optional[float]]] = None

    # -- wiring ------------------------------------------------------------

    def bind(self, executor: FleetExecutor) -> None:
        """Attach the execution seam (must happen before submits)."""
        self._executor = executor

    def ledger(self, job: str) -> AttemptLedger:
        """The per-job attempt ledger (``submitted`` entries carry the
        ``$TPX_MESH`` of every reshape, PR 7 style)."""
        return AttemptLedger(job, root=self._ledger_root)

    def set_slo_signal(
        self, fn: Callable[[], Optional[float]]
    ) -> None:
        """Attach the telemetry plane's burn-rate probe (the daemon wires
        its :class:`~torchx_tpu_torch.obs.slo.SloEngine` here). While the worst
        long-window burn stays below 1.0 — error budget not actually
        burning — the market executes elastic shrinks only and defers
        checkpoint-preempt kills; at or past 1.0 the full market runs."""
        self._slo_signal = fn

    @contextlib.contextmanager
    def _job_span(self, job: FleetJob, name: str, **attrs: Any):
        """Emit one lifecycle span inside the gang's own journaled trace,
        tagged ``fleet_job`` so ``tpx-torch trace --stitch <job>`` resolves it
        by name."""
        tid = str(job.recipe.get("trace_id") or "") or None
        with obs_trace.trace_context(tid):
            with obs_trace.span(name, fleet_job=job.req.job, **attrs) as sp:
                yield sp

    # -- submit ------------------------------------------------------------

    def submit(self, req: GangRequest, recipe: Optional[dict] = None) -> dict:
        """Admit one gang: journal, enqueue, and run the placement loop.

        Returns ``{"job", "status", ...}`` where status is ``placed``
        (with ``handle``), ``queued`` (with ``position``), or
        ``infeasible`` (with ``reason``) — the daemon maps these onto
        its HTTP replies. A request with an empty ``job`` gets a fleet id
        assigned.

        A gang whose role is plan-shaped raises :class:`NotImplementedError`
        here, before anything is journaled or queued: its placement needs
        the memory oracle, which waits for ROADMAP queue 1 item 2.8
        (:func:`~torchx_tpu_torch.fleet.placer.require_oracle`)."""
        role = FleetJob(req=req, recipe=dict(recipe or {}), seq=0, enqueued_at=0.0).role()
        if role is not None:
            require_oracle(role, req)
        with self._lock:
            if not req.job:
                self._counter += 1
                req = replace(req, job=f"fj-{self._counter:04d}")
            now = self.clock()
            seq = self.queue.next_seq()
            job = FleetJob(
                req=req, recipe=dict(recipe or {}), seq=seq, enqueued_at=now
            )
            # One trace per gang lifecycle. Stamping the id into the
            # journaled recipe makes it survive daemon restarts AND lets
            # the executor export $TPX_TRACE_ID into the gang's env, so
            # replica spans land in the same stitched timeline.
            job.recipe.setdefault("trace_id", obs_trace.new_trace_id())
            self._jobs[req.job] = job
            with self._job_span(
                job, "fleet.submit", klass=req.klass, replicas=req.replicas
            ):
                self.journal.append(
                    "submit",
                    job=req.job,
                    seq=seq,
                    tenant=req.tenant,
                    klass=req.klass,
                    replicas=req.replicas,
                    chips_per_replica=req.chips_per_replica,
                    elastic=req.elastic,
                    mesh=req.mesh,
                    min_replicas=req.min_replicas,
                    recipe=job.recipe,
                )
                self.queue.push(req, now, seq=seq)
            self._schedule_loop()
            return self._submit_reply(job)

    def _submit_reply(self, job: FleetJob) -> dict:
        reply: dict[str, Any] = {"job": job.req.job, "class": job.req.klass}
        if job.state == RUNNING:
            reply.update(status="placed", handle=job.handle)
        elif job.state == INFEASIBLE:
            reply.update(status="infeasible", reason=job.reason)
        else:
            reply.update(
                status="queued",
                position=self.queue.position(
                    job.req.job, self._placed_chips()
                ),
            )
        return reply

    def cancel_job(self, job_id: str) -> bool:
        """Cancel by fleet job id: dequeue a queued gang or cancel a
        running one's current attempt (its terminal event then frees the
        slices). Returns False for unknown ids."""
        with self._lock:
            job = self._jobs.get(job_id)
            if job is None:
                return False
            if job.state == QUEUED:
                self.queue.remove(job_id)
                job.state = DONE
                job.reason = "cancelled"
                self.journal.append("terminal", job=job_id, state="CANCELLED")
                self._update_gauges()
                return True
            if job.state == RUNNING and self._executor is not None:
                self._executor.cancel(job.handle)
                return True
            return False

    # -- the event side ----------------------------------------------------

    def on_event(self, event: Any) -> None:
        """Reconciler subscription: a terminal transition of the current
        attempt of a fleet job frees its slices and re-runs the loop.
        Stale handles (attempts the market already replaced) are ignored
        — the reshape path cancels on purpose."""
        terminal = bool(
            getattr(event, "terminal", False)
            or getattr(event.state, "name", "") == "UNKNOWN"
        )
        if not terminal:
            return
        key = (event.scheduler, event.app_id)
        with self._lock:
            job_id = self._by_handle.pop(key, None)
            if job_id is None:
                return
            job = self._jobs.get(job_id)
            if job is None or job.state != RUNNING:
                return
            job.state = DONE
            job.reason = getattr(event.state, "name", str(event.state))
            self.model.release_job(job_id)
            job.units = []
            with self._job_span(job, "fleet.terminal", state=job.reason):
                self.journal.append("terminal", job=job_id, state=job.reason)
            self._schedule_loop()

    def running_handles(self) -> list[str]:
        """Current attempt handles of every running fleet job (the daemon
        re-tracks these with the reconciler after a restart)."""
        with self._lock:
            return [
                j.handle
                for j in self._jobs.values()
                if j.state == RUNNING and j.handle
            ]

    # -- the placement loop ------------------------------------------------

    def _placed_chips(self) -> dict[str, int]:
        """Chips currently held per tenant (quota + fair-share input)."""
        placed: dict[str, int] = {}
        for job in self._jobs.values():
            if job.state == RUNNING:
                placed[job.req.tenant] = placed.get(job.req.tenant, 0) + (
                    job.cur_replicas * job.req.chips_per_replica
                )
        return placed

    def _schedule_loop(self) -> None:
        """Drain the queue in priority order, running the market for
        blocked gangs, then repay shrink debts — repeat until a full pass
        makes no progress. Called with the lock held."""
        self._loop_failed = set()
        with obs_trace.span("fleet.schedule", queued=len(self.queue)):
            progress = True
            while progress:
                progress = self._pass_queue() or self._pass_growback()
        self._update_gauges()

    def _pass_queue(self) -> bool:
        placed_chips = self._placed_chips()
        # shared per-pass market context: nothing mutates between FAILED
        # market attempts inside one pass, so the running-victim snapshot
        # is computed once and fruitless (priority, replicas, chips) keys
        # are never re-planned — the difference between O(queue * fleet)
        # and O(distinct shapes * fleet) per pass at 1000-slice sim scale
        ctx: dict[str, Any] = {
            "memo": set(),
            "victims": None,
            "free": {},
            "blocked": set(),
        }
        for entry in self.queue.ordered(placed_chips):
            job = self._jobs[entry.req.job]
            if job.req.job in self._loop_failed:
                continue
            if over_quota(job.req, placed_chips, self.quotas):
                continue
            role = job.role()
            # role-less demand makes plan_placement a pure function of
            # (shape, free units), and free units don't change between
            # blocked outcomes within a pass — skip re-planning a shape
            # that already came back blocked (never memoize placed or
            # infeasible: those return out of the pass immediately)
            pkey = (
                (entry.req.replicas, entry.req.chips_per_replica, entry.req.mesh)
                if role is None
                else None
            )
            if pkey is not None and pkey in ctx["blocked"]:
                if self._run_market(job, ctx):
                    return True
                continue
            decision = plan_placement(job.req, self.model, role=role)
            if decision.infeasible:
                self.queue.remove(job.req.job)
                job.state = INFEASIBLE
                job.reason = decision.infeasible
                self.journal.append(
                    "infeasible", job=job.req.job, reason=job.reason
                )
                logger.warning(
                    "fleet: gang %s infeasible: %s",
                    job.req.job,
                    job.reason,
                )
                return True
            if decision.placed:
                self._place(job, decision.units)
                return True
            if pkey is not None:
                ctx["blocked"].add(pkey)
            if self._run_market(job, ctx):
                return True
        return False

    def _run_market(
        self, job: FleetJob, ctx: Optional[dict] = None
    ) -> bool:
        """Try to free capacity for one blocked gang via the market."""
        need = job.req.chips_per_replica
        if ctx is None:
            ctx = {"memo": set(), "victims": None, "free": {}}
        key = (job.req.priority, job.req.replicas, need)
        if key in ctx["memo"]:
            return False
        if ctx["victims"] is None:
            snapshot = []
            for other in self._jobs.values():
                if other.state != RUNNING:
                    continue
                units = self.model.units_of(other.req.job)
                snapshot.append(
                    (
                        other,
                        bool(units),
                        min((u.chips for u in units), default=0),
                    )
                )
            ctx["victims"] = snapshot
        victims = [
            Victim(
                job=other.req.job,
                priority=other.req.priority,
                elastic=other.req.elastic and other.req.mesh != "",
                replicas=other.cur_replicas,
                min_replicas=other.req.min_replicas,
                seq=other.seq,
                suitable=has_units and min_chips >= need,
            )
            for other, has_units, min_chips in ctx["victims"]
            if other.req.job != job.req.job
        ]
        if need not in ctx["free"]:
            ctx["free"][need] = sum(
                1 for u in self.model.free_units() if u.chips >= need
            )
        free_suitable = ctx["free"][need]
        actions = plan_market(
            job.req.replicas - free_suitable, job.req.priority, victims
        )
        if actions and self._gentle_market():
            # SLO budgets are healthy: defer the expensive checkpoint
            # kills and take only the elastic shrinks this pass.
            actions = [a for a in actions if isinstance(a, Shrink)]
        if not actions:
            ctx["memo"].add(key)
            return False
        with obs_trace.span(
            "fleet.preempt",
            demand=job.req.job,
            actions=len(actions),
        ):
            for action in actions:
                victim = self._jobs[action.job]
                if isinstance(action, Shrink):
                    self._reshape(
                        victim,
                        action.to_replicas,
                        kind="shrink",
                        beneficiary=job.req.job,
                    )
                elif isinstance(action, Preempt):
                    self._checkpoint_preempt(victim, beneficiary=job.req.job)
        decision = plan_placement(job.req, self.model, role=job.role())
        if decision.placed:
            self._place(job, decision.units)
        return True

    def _gentle_market(self) -> bool:
        """True when the telemetry plane reports every SLO burning below
        1.0 — budgets intact, so preemption kills can wait. No signal
        (or a failing probe) means no gating: full market."""
        if self._slo_signal is None:
            return False
        try:
            burn = self._slo_signal()
        except Exception:  # noqa: BLE001 - telemetry must not wedge placement
            logger.debug("fleet: slo signal probe failed", exc_info=True)
            return False
        return burn is not None and burn < 1.0

    def _pass_growback(self) -> bool:
        """Repay shrink debts, highest class / oldest first, when free
        capacity covers the missing replicas (and quota allows)."""
        placed_chips = self._placed_chips()
        shrunk = sorted(
            (j for j in self._jobs.values() if j.shrunk),
            key=lambda j: (j.req.priority, j.seq),
        )
        for job in shrunk:
            if job.req.job in self._loop_failed:
                continue
            missing = job.req.replicas - job.cur_replicas
            need = job.req.chips_per_replica
            # the quota check reads the missing replicas' cards; the floor
            # goes to 1, since a debt below min_replicas is no request of
            # its own (the JAX copy keeps it and raises: ROADMAP queue 3)
            grow_req = replace(job.req, replicas=missing, min_replicas=1)
            if over_quota(grow_req, placed_chips, self.quotas):
                continue
            extra = [
                u for u in self.model.free_units() if u.chips >= need
            ][:missing]
            if len(extra) < missing:
                continue
            self._grow(job, extra)
            return True
        return False

    # -- decision execution ------------------------------------------------

    def _place(self, job: FleetJob, units: list) -> None:
        """Journal + execute one placement (initial submit, mesh=None:
        the app launches on its own default mesh)."""
        uids = [u.uid for u in units]
        job.cur_replicas = job.req.replicas
        job.debt = 0
        with self._job_span(
            job, "fleet.place", replicas=job.cur_replicas, units=len(uids)
        ):
            self.journal.append(
                "place",
                job=job.req.job,
                units=uids,
                replicas=job.cur_replicas,
            )
            self.queue.remove(job.req.job)
            self.model.assign(uids, job.req.job)
            job.units = uids
            if not self._try_schedule(job, mesh_spec=None):
                return
            job.state = RUNNING
        waited = max(0.0, self.clock() - job.enqueued_at)
        obs_metrics.FLEET_GANG_WAIT_SECONDS.observe(
            waited, klass=job.req.klass
        )
        obs_metrics.FLEET_PLACEMENTS.inc(klass=job.req.klass)

    def _reshape(
        self, job: FleetJob, to_replicas: int, kind: str, beneficiary: str
    ) -> None:
        """Shrink (or regrow) a running elastic gang via cancel +
        ``$TPX_MESH`` resubmit through its attempt ledger."""
        spec = self._mesh_spec_for(job, to_replicas)
        keep = job.units[:to_replicas]
        freed = job.units[to_replicas:]
        with self._job_span(
            job,
            "fleet.reshape",
            direction=kind,
            replicas=to_replicas,
            beneficiary=beneficiary,
        ):
            self.journal.append(
                "reshape",
                job=job.req.job,
                direction=kind,
                replicas=to_replicas,
                mesh=spec,
                units=keep,
                beneficiary=beneficiary,
            )
            old_handle = job.handle
            self._unmap_handle(old_handle)
            if self._executor is not None and old_handle:
                self._executor.cancel(old_handle)
            self.model.release(freed)
            job.units = keep
            job.cur_replicas = to_replicas
            job.debt = (
                job.req.replicas if to_replicas < job.req.replicas else 0
            )
            self._try_schedule(job, mesh_spec=spec)
        if kind == "shrink":
            self.reshapes += 1
            obs_metrics.FLEET_PREEMPTIONS.inc(kind="shrink")
            logger.info(
                "fleet: shrank %s to %d replica(s) (mesh %s) for %s",
                job.req.job,
                to_replicas,
                spec,
                beneficiary,
            )

    def _grow(self, job: FleetJob, extra_units: list) -> None:
        """Repay a shrink debt: reclaim slices and resubmit at the launch
        mesh (the gang resumes from its last verified checkpoint)."""
        uids = [u.uid for u in extra_units]
        self.model.assign(uids, job.req.job)
        job.units = job.units + uids
        self._reshape(
            job, job.req.replicas, kind="grow", beneficiary=job.req.job
        )
        self.grows += 1
        obs_metrics.FLEET_GROWBACKS.inc()
        logger.info(
            "fleet: grew %s back to %d replicas", job.req.job, job.req.replicas
        )

    def _checkpoint_preempt(self, job: FleetJob, beneficiary: str) -> None:
        """Non-elastic victim: cancel and requeue at its original class
        position (priority-ordered requeue)."""
        with self._job_span(job, "fleet.requeue", beneficiary=beneficiary):
            self.journal.append(
                "requeue", job=job.req.job, beneficiary=beneficiary
            )
            old_handle = job.handle
            self._unmap_handle(old_handle)
            if self._executor is not None and old_handle:
                self._executor.cancel(old_handle)
            self.model.release_job(job.req.job)
            job.units = []
            job.handle = ""
            job.cur_replicas = 0
            job.debt = 0
            job.state = QUEUED
            job.enqueued_at = self.clock()
            self.queue.push(job.req, job.enqueued_at, seq=job.seq)
        self.kills += 1
        obs_metrics.FLEET_PREEMPTIONS.inc(kind="requeue")
        logger.info(
            "fleet: checkpoint-preempted %s for %s", job.req.job, beneficiary
        )

    def _try_schedule(self, job: FleetJob, mesh_spec: Optional[str]) -> bool:
        """Run the executor for one attempt; on failure the gang goes
        back to the queue instead of leaking slices."""
        if self._executor is None:
            raise RuntimeError("FleetScheduler has no executor bound")
        try:
            handle = self._executor.schedule(job, mesh_spec)
        except Exception as e:  # noqa: BLE001 - requeue, don't wedge the loop
            logger.warning(
                "fleet: scheduling %s failed (%s); requeued", job.req.job, e
            )
            self._loop_failed.add(job.req.job)
            self.model.release_job(job.req.job)
            job.units = []
            job.handle = ""
            job.state = QUEUED
            self.queue.push(job.req, self.clock(), seq=job.seq)
            return False
        job.handle = handle
        job.state = RUNNING
        scheduler, _, app_id = parse_app_handle(handle)
        self._by_handle[(scheduler, app_id)] = job.req.job
        self.ledger(job.req.job).append(
            "submitted",
            app_id,
            handle=handle,
            mesh=mesh_spec,
            replicas=job.cur_replicas,
        )
        self.journal.append(
            "attempt", job=job.req.job, handle=handle, mesh=mesh_spec
        )
        return True

    def _unmap_handle(self, handle: str) -> None:
        if not handle:
            return
        try:
            scheduler, _, app_id = parse_app_handle(handle)
        except ValueError:
            return
        self._by_handle.pop((scheduler, app_id), None)

    def _mesh_spec_for(self, job: FleetJob, replicas: int) -> str:
        """Refit the launch mesh onto ``replicas`` slices: full explicit
        spec at launch size, ``shrink_data_axes`` below it (dp/fsdp give;
        model axes never change)."""
        from torchx_tpu_torch.parallel.mesh_config import (
            MeshConfig,
            mesh_sizes_spec,
            parse_mesh_spec,
            shrink_data_axes,
        )

        cpr = job.req.chips_per_replica
        cfg = (
            parse_mesh_spec(job.req.mesh) if job.req.mesh else MeshConfig()
        )
        launch = cfg.resolve(job.req.replicas * cpr)
        if replicas >= job.req.replicas:
            return mesh_sizes_spec(launch)
        return mesh_sizes_spec(shrink_data_axes(launch, replicas * cpr))

    # -- introspection -----------------------------------------------------

    def job(self, job_id: str) -> Optional[FleetJob]:
        """One job's record by fleet id (None when unknown)."""
        with self._lock:
            return self._jobs.get(job_id)

    def queue_snapshot(self) -> dict:
        """The ``/v1/queue`` payload: ordered queue, running set, fleet
        inventory, and the market's running totals."""
        with self._lock:
            placed_chips = self._placed_chips()
            now = self.clock()
            queued = []
            for i, entry in enumerate(self.queue.ordered(placed_chips)):
                job = self._jobs[entry.req.job]
                queued.append(
                    {
                        "position": i + 1,
                        "job": entry.req.job,
                        "tenant": entry.req.tenant,
                        "class": entry.req.klass,
                        "replicas": entry.req.replicas,
                        "chips": entry.req.chips,
                        "waited_seconds": round(
                            max(0.0, now - entry.enqueued_at), 3
                        ),
                        "quota_blocked": over_quota(
                            entry.req, placed_chips, self.quotas
                        ),
                    }
                )
            running = []
            for job in self._jobs.values():
                if job.state != RUNNING:
                    continue
                running.append(
                    {
                        "job": job.req.job,
                        "tenant": job.req.tenant,
                        "class": job.req.klass,
                        "handle": job.handle,
                        "replicas": job.cur_replicas,
                        "launch_replicas": job.req.replicas,
                        "shrunk": job.shrunk,
                        "units": list(job.units),
                    }
                )
            return {
                "enabled": True,
                "queue": queued,
                "running": running,
                "fleet": self.model.snapshot(),
                "market": {
                    "reshapes": self.reshapes,
                    "growbacks": self.grows,
                    "kills": self.kills,
                },
            }

    def _update_gauges(self) -> None:
        depth: dict[str, int] = {k: 0 for k in PRIORITY_CLASSES}
        for entry in self.queue.ordered():
            depth[entry.req.klass] += 1
        for klass, n in depth.items():
            obs_metrics.FLEET_QUEUE_DEPTH.set(float(n), klass=klass)
        obs_metrics.FLEET_CHIPS.set(
            float(self.model.total_chips), state="total"
        )
        obs_metrics.FLEET_CHIPS.set(float(self.model.free_chips), state="free")
        for tenant, chips in self._placed_chips().items():
            obs_metrics.FLEET_TENANT_CHIPS.set(float(chips), tenant=tenant)

    # -- rehydration -------------------------------------------------------

    def rehydrate(self) -> int:
        """Replay the journal after a daemon restart: queued gangs go
        back in (original order), running placements re-own their slices
        and handles. Returns the number of live jobs restored."""
        with self._lock:
            by_job: dict[str, FleetJob] = {}
            max_seq = 0
            for e in self.journal.entries():
                kind, job_id = e.get("kind"), str(e.get("job", ""))
                if kind == "submit":
                    try:
                        req = GangRequest(
                            job=job_id,
                            tenant=str(e.get("tenant", "")),
                            klass=str(e.get("klass", "batch")),
                            replicas=int(e.get("replicas", 1)),
                            chips_per_replica=int(
                                e.get("chips_per_replica", 1)
                            ),
                            elastic=bool(e.get("elastic", False)),
                            mesh=str(e.get("mesh", "")),
                            min_replicas=int(e.get("min_replicas", 1)),
                        )
                    except ValueError:
                        continue
                    seq = int(e.get("seq", 0))
                    max_seq = max(max_seq, seq)
                    by_job[job_id] = FleetJob(
                        req=req,
                        recipe=dict(e.get("recipe") or {}),
                        seq=seq,
                        enqueued_at=self.clock(),
                    )
                    if job_id.startswith("fj-"):
                        try:
                            self._counter = max(
                                self._counter, int(job_id[3:])
                            )
                        except ValueError:
                            pass
                    continue
                job = by_job.get(job_id)
                if job is None:
                    continue
                if kind == "place":
                    job.state = RUNNING
                    job.units = list(e.get("units") or [])
                    job.cur_replicas = int(e.get("replicas", 1))
                    job.debt = 0
                elif kind == "reshape":
                    job.units = list(e.get("units") or [])
                    job.cur_replicas = int(e.get("replicas", 1))
                    job.debt = (
                        job.req.replicas
                        if job.cur_replicas < job.req.replicas
                        else 0
                    )
                elif kind == "attempt":
                    job.handle = str(e.get("handle", ""))
                elif kind == "requeue":
                    job.state = QUEUED
                    job.units = []
                    job.handle = ""
                    job.cur_replicas = 0
                    job.debt = 0
                elif kind in ("terminal", "infeasible"):
                    job.state = DONE
            restored = 0
            self.queue.bump_seq(max_seq)
            for job in by_job.values():
                if job.state == QUEUED:
                    self._jobs[job.req.job] = job
                    self.queue.push(job.req, job.enqueued_at, seq=job.seq)
                    restored += 1
                elif job.state == RUNNING and job.units:
                    try:
                        self.model.assign(job.units, job.req.job)
                    except (KeyError, ValueError):
                        logger.warning(
                            "fleet rehydrate: dropping %s (slices moved)",
                            job.req.job,
                        )
                        continue
                    self._jobs[job.req.job] = job
                    if job.handle:
                        try:
                            sched, _, app_id = parse_app_handle(job.handle)
                            self._by_handle[(sched, app_id)] = job.req.job
                        except ValueError:
                            pass
                    restored += 1
            if restored:
                logger.info(
                    "fleet: rehydrated %d job(s) from %s",
                    restored,
                    self.journal.path,
                )
            self._update_gauges()
            return restored
