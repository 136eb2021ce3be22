"""Event-driven pipeline engine over the control plane's watch stream.

The port's copy of :mod:`torchx_tpu.pipelines.engine`.

:class:`PipelineEngine` advances :class:`~torchx_tpu_torch.pipelines.dag.PipelineSpec`
DAGs off :meth:`Reconciler.subscribe <torchx_tpu_torch.control.reconciler.Reconciler.subscribe>`
watch events — no stage is ever polled. A stage submission returns
immediately; the terminal :class:`~torchx_tpu_torch.control.events.StateEvent`
for its app is what harvests the artifact (checkpoint manifest for train
stages, score record for eval stages), applies the eval gate, and submits
the next generation.

Durability follows the fleet journal's contract exactly (it *is* the same
:class:`~torchx_tpu_torch.fleet.queue.FleetJournal` class): every decision —
submit, stage submit, stage completion, gate verdict, each canary
replica rolled, rollback, promotion, terminal pipeline state — is an
fsync'd JSONL line written *before* the action it records is considered
done. :meth:`rehydrate` replays that journal after a daemon restart:
completed stages never re-run, running stages are re-attached to their
watch streams, and a pipeline killed mid-canary resumes its promotion
with the already-rolled replica set instead of re-rolling.

The engine is deliberately daemon-agnostic: submission goes through an
injected *executor* (``submit``/``resolve``/``cancel`` duck type — the
daemon's wires stages through the fleet scheduler with per-kind priority
classes), the serve pool for promote stages comes from an injectable
``pool_provider``, and the SLO burn signal is a plain callable.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from torchx_tpu_torch.fleet.queue import FleetJournal
from torchx_tpu_torch.obs import metrics as obs_metrics
from torchx_tpu_torch.obs import trace as obs_trace
from torchx_tpu_torch.pipelines.dag import (
    Artifact,
    PipelineSpec,
    PipelineStage,
    checkpoint_artifact,
    resolve_args,
    score_artifact,
)
from torchx_tpu_torch.pipelines.promote import PROMOTED, PromotionController

__all__ = [
    "PIPELINE_STATES",
    "STAGE_STATES",
    "StageRun",
    "PipelineRun",
    "PipelineEngine",
]

logger = logging.getLogger(__name__)

#: pipeline lifecycle states (terminal: PROMOTED, SUCCEEDED, FAILED,
#: ROLLED_BACK, CANCELLED).
PIPELINE_STATES = (
    "PENDING",
    "RUNNING",
    "CANARY",
    "PROMOTED",
    "SUCCEEDED",
    "FAILED",
    "ROLLED_BACK",
    "CANCELLED",
)

_TERMINAL = {"PROMOTED", "SUCCEEDED", "FAILED", "ROLLED_BACK", "CANCELLED"}

#: per-stage states.
STAGE_STATES = (
    "PENDING",
    "QUEUED",
    "RUNNING",
    "SUCCEEDED",
    "FAILED",
    "CANCELLED",
    "ROLLED_BACK",
)


@dataclass
class StageRun:
    """One stage's runtime record inside a :class:`PipelineRun`."""

    stage: PipelineStage
    state: str = "PENDING"
    handle: str = ""
    scheduler: str = ""
    app_id: str = ""
    fleet_job: str = ""
    error: str = ""
    artifact: Optional[Artifact] = None
    started_usec: int = 0
    finished_usec: int = 0

    def to_dict(self) -> dict:
        """Status-payload form (spec fields + runtime state)."""
        return {
            "name": self.stage.name,
            "kind": self.stage.kind,
            "state": self.state,
            "handle": self.handle,
            "fleet_job": self.fleet_job,
            "error": self.error,
            "artifact": self.artifact.to_dict() if self.artifact else None,
        }


@dataclass
class PipelineRun:
    """One submitted pipeline: its spec, per-stage runs, and lifecycle."""

    pid: str
    spec: PipelineSpec
    tenant: str = ""
    state: str = "PENDING"
    stages: dict[str, StageRun] = field(default_factory=dict)
    #: replica ids rolled by this run's promotion attempt(s) — journaled,
    #: so a restart resumes the canary instead of re-rolling.
    rolled: set[int] = field(default_factory=set)
    reason: str = ""

    @property
    def terminal(self) -> bool:
        """True once the run reached a terminal lifecycle state."""
        return self.state in _TERMINAL

    def to_dict(self) -> dict:
        """Status-payload form."""
        return {
            "pipeline": self.pid,
            "name": self.spec.name,
            "tenant": self.tenant,
            "state": self.state,
            "reason": self.reason,
            "rolled": sorted(self.rolled),
            "stages": [
                self.stages[s.name].to_dict() for s in self.spec.stages
            ],
        }


class PipelineEngine:
    """The DAG engine: journal-backed, watch-event-driven, restartable.

    Args:
        journal_path: fsync'd JSONL decision journal (same durability
            class as the fleet queue journal).
        executor: stage submitter — ``submit(tenant, pid, stage, args)
            -> {"handle": ...}`` or ``{"queued": True, "fleet_job":
            ...}``; optional ``resolve(fleet_job) -> handle`` and
            ``cancel(handle)``. Bind later with :meth:`bind`.
        reconciler: optional; lets :meth:`rehydrate` recover terminal
            events recorded while the daemon was down.
        slo_signal: current worst SLO burn rate (promotion burn gate).
        pool_provider: ``pool_provider(stage) -> ServePool | None`` —
            where a promote stage finds the serve pool to roll.
        clock: injectable wall clock (stage start/finish stamps and the
            promotion controller's observation window run on it — the sim
            harness passes a virtual clock; the port's ``sim/`` comes with
            ROADMAP queue 1 item 2.8).
        sleep: injectable sleep, paired with ``clock`` (promotion canary
            observation windows).
    """

    def __init__(
        self,
        journal_path: str,
        executor: Optional[Any] = None,
        *,
        reconciler: Optional[Any] = None,
        slo_signal: Optional[Callable[[], Optional[float]]] = None,
        pool_provider: Optional[Callable[[PipelineStage], Any]] = None,
        clock: Callable[[], float] = time.time,
        sleep: Callable[[float], None] = time.sleep,
    ) -> None:
        self._journal = FleetJournal(journal_path)
        self._executor = executor
        self._reconciler = reconciler
        self._slo_signal = slo_signal
        self._pool_provider = pool_provider
        self._clock = clock
        self._sleep = sleep
        self._lock = threading.RLock()
        self._runs: dict[str, PipelineRun] = {}
        self._handles: dict[tuple[str, str], tuple[str, str]] = {}
        self._seq = 0
        self._incumbent: Optional[dict] = None
        self._threads: list[threading.Thread] = []
        self._closed = False

    # -- wiring ------------------------------------------------------------

    def bind(self, executor: Any) -> None:
        """Attach (or replace) the stage executor."""
        with self._lock:
            self._executor = executor

    def set_slo_signal(self, signal: Callable[[], Optional[float]]) -> None:
        """Attach the burn-rate feed used by promotion gates."""
        with self._lock:
            self._slo_signal = signal

    def set_pool_provider(
        self, provider: Callable[[PipelineStage], Any]
    ) -> None:
        """Attach the serve-pool lookup used by promote stages."""
        with self._lock:
            self._pool_provider = provider

    @property
    def incumbent(self) -> Optional[dict]:
        """The last promoted checkpoint (``ckpt``/``digest``/``step``/
        ``score``) — the baseline the next candidate is gated against."""
        with self._lock:
            return dict(self._incumbent) if self._incumbent else None

    def active_threads(self) -> list[threading.Thread]:
        """Promotion threads started by this engine (live and dead). The
        sim harness waits on these between virtual-time steps so canary
        outcomes land deterministically."""
        with self._lock:
            return list(self._threads)

    def close(self) -> None:
        """Stop accepting work and give in-flight promotion threads a
        moment to reach their next journal point."""
        with self._lock:
            self._closed = True
            threads = list(self._threads)
        for t in threads:
            t.join(timeout=2.0)

    # -- submission --------------------------------------------------------

    def submit(self, spec: PipelineSpec, tenant: str = "") -> str:
        """Validate, journal, and start a pipeline; returns its id."""
        spec.validate()
        with self._lock:
            if self._closed:
                raise RuntimeError("pipeline engine is closed")
            self._seq += 1
            pid = f"pl_{self._seq}"
            self._journal.append(
                "submit", pipeline=pid, tenant=tenant, spec=spec.to_dict()
            )
            run = PipelineRun(pid=pid, spec=spec, tenant=tenant)
            run.stages = {s.name: StageRun(stage=s) for s in spec.stages}
            self._runs[pid] = run
            obs_metrics.PIPELINE_ACTIVE.set(self._active_count())
            with obs_trace.span(
                "pipeline.submit", pipeline=pid, spec=spec.name
            ):
                self._advance(run)
        return pid

    def cancel(self, pid: str) -> dict:
        """Cancel a pipeline: running stage apps are cancelled on their
        backends, the decision is journaled, the state goes CANCELLED."""
        with self._lock:
            run = self._runs.get(pid)
            if run is None:
                raise KeyError(f"unknown pipeline {pid!r}")
            if run.terminal:
                return run.to_dict()
            for srun in run.stages.values():
                if srun.state in ("QUEUED", "RUNNING") and srun.handle:
                    self._cancel_handle(srun.handle)
                if srun.state in ("PENDING", "QUEUED", "RUNNING"):
                    srun.state = "CANCELLED"
            self._set_state(run, "CANCELLED", reason="cancelled by client")
            return run.to_dict()

    def status(self, pid: Optional[str] = None) -> dict:
        """One pipeline's full record, or a summary of all of them."""
        with self._lock:
            if pid is not None:
                run = self._runs.get(pid)
                if run is None:
                    raise KeyError(f"unknown pipeline {pid!r}")
                doc = run.to_dict()
                doc["incumbent"] = (
                    dict(self._incumbent) if self._incumbent else None
                )
                return doc
            return {
                "pipelines": [
                    self._runs[k].to_dict() for k in sorted(self._runs)
                ],
                "incumbent": dict(self._incumbent) if self._incumbent else None,
            }

    # -- the event path ----------------------------------------------------

    def on_event(self, event: Any) -> None:
        """Reconciler subscriber: advance DAGs off watch events.

        Exceptions never propagate past here by the reconciler's
        subscriber contract, but the engine still catches per-run errors
        so one poisoned pipeline cannot stall the rest.
        """
        with self._lock:
            if self._closed:
                return
            self._resolve_queued()
            key = (str(event.scheduler), str(event.app_id))
            owner = self._handles.get(key)
            if owner is None:
                return
            pid, stage_name = owner
            run = self._runs.get(pid)
            if run is None or run.terminal:
                return
            srun = run.stages[stage_name]
            state_name = getattr(event.state, "name", str(event.state))
            if state_name == "SUCCEEDED":
                self._handles.pop(key, None)
                self._complete_stage(run, srun)
            elif state_name in ("FAILED", "CANCELLED", "UNKNOWN"):
                self._handles.pop(key, None)
                self._finish_stage(
                    run,
                    srun,
                    "CANCELLED" if state_name == "CANCELLED" else "FAILED",
                    error=f"stage app reached {state_name}",
                )
                self._fail(run, f"stage {srun.stage.name} {state_name}")

    def _resolve_queued(self) -> None:
        """Fleet-queued stages get their handle once the market places the
        gang; resolution is lazy, on every event tick."""
        if self._executor is None or not hasattr(self._executor, "resolve"):
            return
        for run in self._runs.values():
            if run.terminal:
                continue
            for srun in run.stages.values():
                if srun.state != "QUEUED" or not srun.fleet_job:
                    continue
                try:
                    handle = self._executor.resolve(srun.fleet_job)
                except Exception as e:  # noqa: BLE001 - keep the queue state
                    logger.debug("resolve %s failed: %s", srun.fleet_job, e)
                    continue
                if handle:
                    self._record_handle(run, srun, str(handle))

    # -- stage mechanics ---------------------------------------------------

    def _advance(self, run: PipelineRun) -> None:
        """Submit every stage whose dependencies are all satisfied; called
        with the lock held, idempotent, re-entrant-safe."""
        if run.terminal:
            return
        for stage in run.spec.stages:
            srun = run.stages[stage.name]
            if srun.state != "PENDING":
                continue
            deps = [run.stages[d] for d in stage.depends_on]
            if any(d.state in ("FAILED", "CANCELLED", "ROLLED_BACK") for d in deps):
                continue
            if not all(d.state == "SUCCEEDED" for d in deps):
                continue
            if stage.kind == "promote":
                self._start_promotion(run, srun)
            else:
                self._submit_stage(run, srun)
        if run.state == "PENDING" and any(
            s.state in ("QUEUED", "RUNNING") for s in run.stages.values()
        ):
            self._set_state(run, "RUNNING", terminal_metric=False)
        if not run.terminal and all(
            s.state == "SUCCEEDED" for s in run.stages.values()
        ):
            # a DAG without a promote stage still has a clean terminal
            self._set_state(run, "SUCCEEDED", reason="all stages succeeded")

    def _submit_stage(self, run: PipelineRun, srun: StageRun) -> None:
        if self._executor is None:
            raise RuntimeError("pipeline engine has no executor bound")
        stage = srun.stage
        artifacts = {
            name: sr.artifact
            for name, sr in run.stages.items()
            if sr.artifact is not None
        }
        try:
            args = resolve_args(stage.args, artifacts)
            result = self._executor.submit(
                run.tenant, run.pid, stage, args
            )
        except Exception as e:  # noqa: BLE001 - a bad stage fails its run
            srun.state = "FAILED"
            srun.error = f"{type(e).__name__}: {e}"
            self._journal.append(
                "stage_done",
                pipeline=run.pid,
                stage=stage.name,
                state="FAILED",
                error=srun.error,
            )
            obs_metrics.PIPELINE_STAGES.inc(kind=stage.kind, state="FAILED")
            self._fail(run, f"stage {stage.name} submit failed: {srun.error}")
            return
        srun.started_usec = int(self._clock() * 1e6)
        if result.get("handle"):
            self._record_handle(run, srun, str(result["handle"]))
        else:
            srun.state = "QUEUED"
            srun.fleet_job = str(result.get("fleet_job", ""))
            self._journal.append(
                "stage_submit",
                pipeline=run.pid,
                stage=stage.name,
                fleet_job=srun.fleet_job,
                handle="",
            )

    def _record_handle(
        self, run: PipelineRun, srun: StageRun, handle: str
    ) -> None:
        from torchx_tpu_torch.specs.api import parse_app_handle

        scheduler, _, app_id = parse_app_handle(handle)
        srun.state = "RUNNING"
        srun.handle = handle
        srun.scheduler = scheduler
        srun.app_id = app_id
        if not srun.started_usec:
            srun.started_usec = int(self._clock() * 1e6)
        self._handles[(scheduler, app_id)] = (run.pid, srun.stage.name)
        self._journal.append(
            "stage_submit",
            pipeline=run.pid,
            stage=srun.stage.name,
            handle=handle,
            scheduler=scheduler,
            app_id=app_id,
            fleet_job=srun.fleet_job,
        )
        obs_metrics.PIPELINE_STAGES.inc(kind=srun.stage.kind, state="RUNNING")

    def _complete_stage(self, run: PipelineRun, srun: StageRun) -> None:
        """A stage's app succeeded: harvest its artifact, apply the eval
        gate, journal, and advance the DAG."""
        stage = srun.stage
        try:
            if stage.kind == "train" and stage.ckpt_dir:
                srun.artifact = checkpoint_artifact(stage.ckpt_dir)
            elif stage.kind == "eval":
                srun.artifact = score_artifact(stage.score_file)
        except ValueError as e:
            self._finish_stage(run, srun, "FAILED", error=str(e))
            self._fail(run, f"stage {stage.name}: {e}")
            return
        if stage.kind == "eval" and stage.threshold is not None:
            score = srun.artifact.score if srun.artifact else None
            passed = score is not None and score >= stage.threshold
            self._journal.append(
                "gate",
                pipeline=run.pid,
                stage=stage.name,
                passed=passed,
                score=score,
                threshold=stage.threshold,
            )
            obs_metrics.PIPELINE_GATES.inc(
                decision="pass" if passed else "fail"
            )
            if not passed:
                self._finish_stage(
                    run,
                    srun,
                    "FAILED",
                    error=(
                        f"eval gate failed: score {score} <"
                        f" threshold {stage.threshold}"
                    ),
                    artifact=srun.artifact,
                )
                self._fail(run, f"eval gate failed at stage {stage.name}")
                return
        self._finish_stage(run, srun, "SUCCEEDED", artifact=srun.artifact)
        self._advance(run)

    def _finish_stage(
        self,
        run: PipelineRun,
        srun: StageRun,
        state: str,
        error: str = "",
        artifact: Optional[Artifact] = None,
    ) -> None:
        srun.state = state
        srun.error = error
        srun.finished_usec = int(self._clock() * 1e6)
        self._journal.append(
            "stage_done",
            pipeline=run.pid,
            stage=srun.stage.name,
            state=state,
            error=error,
            artifact=artifact.to_dict() if artifact else None,
        )
        obs_metrics.PIPELINE_STAGES.inc(kind=srun.stage.kind, state=state)
        if srun.started_usec:
            obs_metrics.PIPELINE_STAGE_SECONDS.observe(
                max(0.0, (srun.finished_usec - srun.started_usec) / 1e6),
                kind=srun.stage.kind,
            )

    def _fail(self, run: PipelineRun, reason: str) -> None:
        if run.terminal:
            return
        for srun in run.stages.values():
            if srun.state in ("QUEUED", "RUNNING") and srun.handle:
                self._cancel_handle(srun.handle)
                srun.state = "CANCELLED"
        self._set_state(run, "FAILED", reason=reason)

    def _cancel_handle(self, handle: str) -> None:
        if self._executor is None or not hasattr(self._executor, "cancel"):
            return
        try:
            self._executor.cancel(handle)
        except Exception as e:  # noqa: BLE001 - cancel is best-effort
            logger.debug("cancel of %s failed: %s", handle, e)

    def _set_state(
        self,
        run: PipelineRun,
        state: str,
        reason: str = "",
        terminal_metric: bool = True,
    ) -> None:
        run.state = state
        if reason:
            run.reason = reason
        self._journal.append(
            "pipeline_state", pipeline=run.pid, state=state, reason=reason
        )
        if run.terminal and terminal_metric:
            obs_metrics.PIPELINE_RUNS.inc(state=state)
        obs_metrics.PIPELINE_ACTIVE.set(self._active_count())

    def _active_count(self) -> int:
        return sum(1 for r in self._runs.values() if not r.terminal)

    # -- promotion ---------------------------------------------------------

    def _start_promotion(self, run: PipelineRun, srun: StageRun) -> None:
        srun.state = "RUNNING"
        srun.started_usec = int(self._clock() * 1e6)
        self._journal.append(
            "stage_submit",
            pipeline=run.pid,
            stage=srun.stage.name,
            handle="",
            promote=True,
        )
        obs_metrics.PIPELINE_STAGES.inc(kind="promote", state="RUNNING")
        self._set_state(run, "CANARY", terminal_metric=False)
        t = threading.Thread(
            target=self._run_promotion,
            args=(run, srun),
            daemon=True,
            name=f"tpx-promote-{run.pid}",
        )
        self._threads.append(t)
        t.start()

    def _dependency_closure(
        self, run: PipelineRun, stage: PipelineStage
    ) -> list[StageRun]:
        out, seen, frontier = [], set(), list(stage.depends_on)
        while frontier:
            name = frontier.pop()
            if name in seen:
                continue
            seen.add(name)
            srun = run.stages[name]
            out.append(srun)
            frontier.extend(srun.stage.depends_on)
        return out

    def _run_promotion(self, run: PipelineRun, srun: StageRun) -> None:
        stage = srun.stage
        with self._lock:
            closure = self._dependency_closure(run, stage)
            candidate = next(
                (
                    s.artifact
                    for s in closure
                    if s.artifact is not None and s.artifact.kind == "checkpoint"
                ),
                None,
            )
            score_art = next(
                (
                    s.artifact
                    for s in closure
                    if s.artifact is not None and s.artifact.kind == "score"
                ),
                None,
            )
            wants_baseline = any(
                s.stage.kind == "eval" and s.stage.baseline == "incumbent"
                for s in closure
            )
            incumbent = dict(self._incumbent) if self._incumbent else None
            rolled = set(run.rolled)
        if candidate is None:
            with self._lock:
                self._finish_stage(
                    run,
                    srun,
                    "FAILED",
                    error="promote stage has no upstream checkpoint artifact",
                )
                self._fail(run, f"stage {stage.name}: no checkpoint to promote")
            return
        score = score_art.score if score_art is not None else None
        baseline = (
            incumbent.get("score")
            if wants_baseline and incumbent is not None
            else None
        )
        pool = None
        if self._pool_provider is not None:
            try:
                pool = self._pool_provider(stage)
            except Exception as e:  # noqa: BLE001 - degrade to gate-only
                logger.warning("pool provider failed for %s: %s", stage.name, e)

        def journal(event: str, **fields: Any) -> None:
            with self._lock:
                self._journal.append(
                    "promote_step",
                    pipeline=run.pid,
                    stage=stage.name,
                    event=event,
                    **fields,
                )
                if event == "replica_rolled" and fields.get("why") in (
                    "canary",
                    "promote",
                ):
                    run.rolled.add(int(fields["replica"]))
                elif event == "rollback":
                    obs_metrics.PIPELINE_ROLLBACKS.inc(
                        reason=str(fields.get("reason", ""))
                    )
                elif event == "gate":
                    obs_metrics.PIPELINE_GATES.inc(
                        decision="pass" if fields.get("passed") else "fail"
                    )

        controller = PromotionController(
            pool,
            slo_signal=self._slo_signal,
            canary_fraction=stage.canary_fraction,
            burn_threshold=stage.burn_threshold,
            observe_s=stage.observe_s,
            # bound the observe window to ~200 burn samples so long
            # windows (hours of virtual time in the simulator) don't
            # degenerate into tens of thousands of poll wakeups
            poll_s=max(0.05, stage.observe_s / 200.0),
            journal=journal,
            already_rolled=rolled,
            clock=self._clock,
            sleep=self._sleep,
        )
        with obs_trace.span(
            "pipeline.promote", pipeline=run.pid, stage=stage.name
        ):
            try:
                result = controller.run(
                    candidate,
                    score=score,
                    baseline_score=baseline,
                    incumbent_ckpt=incumbent.get("ckpt", "") if incumbent else "",
                )
            except Exception as e:  # noqa: BLE001 - a dead canary rolls back
                logger.exception("promotion crashed for %s", run.pid)
                with self._lock:
                    self._finish_stage(run, srun, "FAILED", error=str(e))
                    self._fail(run, f"promotion crashed: {e}")
                return
        with self._lock:
            if run.terminal:
                return
            if result == PROMOTED:
                self._finish_stage(run, srun, "SUCCEEDED", artifact=candidate)
                self._incumbent = {
                    "ckpt": candidate.path,
                    "digest": candidate.digest,
                    "step": candidate.step,
                    "score": score,
                }
                self._journal.append(
                    "incumbent", pipeline=run.pid, **self._incumbent
                )
                self._set_state(run, "PROMOTED", reason="canary gates passed")
            else:
                self._finish_stage(
                    run, srun, "ROLLED_BACK", error="canary gate rolled back"
                )
                self._set_state(
                    run, "ROLLED_BACK", reason="canary gate rolled back"
                )

    # -- rehydration -------------------------------------------------------

    def rehydrate(self) -> list[dict]:
        """Replay the journal after a restart.

        Rebuilds every run, re-maps running stage handles, restores the
        incumbent baseline and the pipeline-id sequence, recovers stage
        completions that landed in the reconciler's store while the
        daemon was down, and resumes mid-canary promotions with their
        journaled already-rolled replica set. Returns the handles the
        caller must re-attach to watch streams:
        ``[{"handle", "scheduler", "app_id", "tenant"}, ...]``.
        """
        with self._lock:
            for entry in self._journal.entries():
                try:
                    self._replay(entry)
                except Exception as e:  # noqa: BLE001 - skip poison entries
                    logger.warning(
                        "pipeline journal replay skipped %r: %s",
                        entry.get("kind"),
                        e,
                    )
            retrack = []
            for run in self._runs.values():
                if run.terminal:
                    continue
                for srun in run.stages.values():
                    if srun.state in ("QUEUED", "RUNNING") and srun.handle:
                        retrack.append(
                            {
                                "handle": srun.handle,
                                "scheduler": srun.scheduler,
                                "app_id": srun.app_id,
                                "tenant": run.tenant,
                            }
                        )
            obs_metrics.PIPELINE_ACTIVE.set(self._active_count())
            # completions recorded while we were down: the store already
            # holds the terminal event, the watch stream won't repeat it
            if self._reconciler is not None:
                for item in list(retrack):
                    event = self._reconciler.latest(
                        item["scheduler"], item["app_id"]
                    )
                    if event is not None and getattr(event, "terminal", False):
                        self.on_event(event)
            for run in list(self._runs.values()):
                if run.terminal:
                    continue
                promote = next(
                    (
                        s
                        for s in run.stages.values()
                        if s.stage.kind == "promote" and s.state == "RUNNING"
                    ),
                    None,
                )
                if promote is not None:
                    logger.info(
                        "resuming mid-canary promotion of %s (rolled=%s)",
                        run.pid,
                        sorted(run.rolled),
                    )
                    t = threading.Thread(
                        target=self._run_promotion,
                        args=(run, promote),
                        daemon=True,
                        name=f"tpx-promote-{run.pid}",
                    )
                    self._threads.append(t)
                    t.start()
                else:
                    self._advance(run)
            return retrack

    def _replay(self, entry: dict) -> None:
        kind = entry.get("kind")
        pid = str(entry.get("pipeline", ""))
        if kind == "submit":
            spec = PipelineSpec.from_dict(entry.get("spec") or {})
            run = PipelineRun(
                pid=pid, spec=spec, tenant=str(entry.get("tenant", ""))
            )
            run.stages = {s.name: StageRun(stage=s) for s in spec.stages}
            self._runs[pid] = run
            try:
                self._seq = max(self._seq, int(pid.split("_", 1)[1]))
            except (IndexError, ValueError):
                pass
            return
        run = self._runs.get(pid)
        if run is None:
            return
        if kind == "stage_submit":
            srun = run.stages.get(str(entry.get("stage", "")))
            if srun is None:
                return
            handle = str(entry.get("handle", ""))
            srun.fleet_job = str(entry.get("fleet_job", "") or srun.fleet_job)
            if handle:
                from torchx_tpu_torch.specs.api import parse_app_handle

                scheduler, _, app_id = parse_app_handle(handle)
                srun.state = "RUNNING"
                srun.handle = handle
                srun.scheduler = scheduler
                srun.app_id = app_id
                self._handles[(scheduler, app_id)] = (pid, srun.stage.name)
            elif entry.get("promote"):
                srun.state = "RUNNING"
                run.state = "CANARY"
            else:
                srun.state = "QUEUED"
        elif kind == "stage_done":
            srun = run.stages.get(str(entry.get("stage", "")))
            if srun is None:
                return
            srun.state = str(entry.get("state", "FAILED"))
            srun.error = str(entry.get("error", "") or "")
            if entry.get("artifact"):
                srun.artifact = Artifact.from_dict(entry["artifact"])
            if srun.handle:
                self._handles.pop((srun.scheduler, srun.app_id), None)
        elif kind == "promote_step":
            if entry.get("event") == "replica_rolled" and entry.get(
                "why"
            ) in ("canary", "promote"):
                run.rolled.add(int(entry.get("replica", -1)))
        elif kind == "pipeline_state":
            run.state = str(entry.get("state", run.state))
            run.reason = str(entry.get("reason", "") or run.reason)
        elif kind == "incumbent":
            self._incumbent = {
                "ckpt": str(entry.get("ckpt", "")),
                "digest": str(entry.get("digest", "")),
                "step": int(entry.get("step", -1)),
                "score": entry.get("score"),
            }
