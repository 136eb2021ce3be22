"""The supervisor engine: babysit one app through preemptions to success.

Port of :mod:`torchx_tpu.supervisor.api`: the same state machine, ledger
transitions, events and spans, over the port's runner and schedulers.

Scheduler-agnostic by construction — it only speaks the Runner/Scheduler
contract (``schedule`` / ``status`` / ``cancel``), consumes the
:class:`~torchx_tpu_torch.specs.api.FailureClass` the backends attach to terminal
states, and re-materializes fresh submissions from the attempt's
:class:`~torchx_tpu_torch.specs.api.AppDryRunInfo`. The loop:

    SUBMITTED -> poll -> terminal?
        SUCCEEDED / CANCELLED          -> done
        PREEMPTED / FAILED (classified) -> budget left?
            yes -> backoff -> inject resume step -> resubmit
            no  -> give up (final status stands)

Checkpoint resume is wired through the manifest sidecar
(:data:`~torchx_tpu_torch.settings.CHECKPOINT_MANIFEST`): this module runs on
the client and must never import torch, so it reads the JSON the in-job
:class:`~torchx_tpu_torch.parallel.checkpoint.Checkpointer` maintains and
falls back to scanning the step layout on disk.

Every transition emits a :class:`~torchx_tpu_torch.runner.events.api.TpxEvent`
(``api="supervise"``) with the transition name, attempt number, failure
class, and resume step in ``app_metadata`` — the audit trail for "why did
my job restart at 3am".
"""

from __future__ import annotations

import copy
import json
import logging
import os
import random
import re
import time
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Callable, Optional

from torchx_tpu_torch import settings
from torchx_tpu_torch.obs import metrics as obs_metrics
from torchx_tpu_torch.obs import trace as obs_trace
from torchx_tpu_torch.runner.events import record
from torchx_tpu_torch.runner.events.api import TpxEvent
from torchx_tpu_torch.specs.api import (
    AppDryRunInfo,
    AppHandle,
    AppState,
    AppStatus,
    FailureClass,
    parse_app_handle,
)
from torchx_tpu_torch.parallel.mesh_config import (
    mesh_sizes_spec,
    parse_mesh_spec,
    shrink_data_axes,
)
from torchx_tpu_torch.schedulers.ids import make_unique
from torchx_tpu_torch.supervisor.gang import GangMonitor, GangState, GangVerdict
from torchx_tpu_torch.supervisor.ledger import AttemptLedger
from torchx_tpu_torch.supervisor.policy import SupervisorPolicy

if TYPE_CHECKING:  # import cycle: runner.api imports specs, we import runner
    from torchx_tpu_torch.runner.api import Runner

logger = logging.getLogger(__name__)


def latest_checkpoint_step(directory: str) -> Optional[int]:
    """Newest checkpoint step under ``directory``, or None, WITHOUT
    importing torch (this runs on the client).

    Prefers the ``MANIFEST.json`` the port's in-job Checkpointer writes;
    falls back to scanning the on-disk step layout (digit-named step dirs,
    the port's and the reference's orbax ones, and the reference's
    ``step_N.pkl`` pickle files) for checkpoints that predate the manifest.
    ``.corrupt``-quarantined steps never match either pattern."""
    manifest = os.path.join(directory, settings.CHECKPOINT_MANIFEST)
    try:
        with open(manifest) as f:
            step = json.load(f).get("latest_step")
        if isinstance(step, int):
            return step
    except (OSError, ValueError):
        pass
    try:
        entries = os.listdir(directory)
    except OSError:
        return None
    steps = []
    for name in entries:
        if name.isdigit() and os.path.isdir(os.path.join(directory, name)):
            steps.append(int(name))
        elif m := re.fullmatch(r"step_(\d+)\.pkl", name):
            steps.append(int(m.group(1)))
    return max(steps, default=None)


@dataclass
class SupervisorResult:
    """Outcome of one :meth:`Supervisor.run`: the final status plus the
    full attempt history for reporting and tests."""

    #: status of the last attempt (terminal), or None if it vanished.
    status: Optional[AppStatus]
    #: handle of every attempt, oldest first; the last one is the survivor.
    handles: list[AppHandle] = field(default_factory=list)
    #: total submissions (== len(handles)).
    attempts: int = 0
    #: resubmissions consumed per failure class.
    retries: dict[FailureClass, int] = field(default_factory=dict)
    #: checkpoint step injected on each resubmit (None = fresh start).
    resume_steps: list[Optional[int]] = field(default_factory=list)
    #: set when a retry budget ran out and the failure stood.
    budget_exhausted: Optional[FailureClass] = None
    #: durable session name; ``tpx-torch supervise --resume <session>`` reattaches.
    session: str = ""

    @property
    def handle(self) -> Optional[AppHandle]:
        """Handle of the final attempt."""
        return self.handles[-1] if self.handles else None

    @property
    def succeeded(self) -> bool:
        """True iff the final attempt reached SUCCEEDED."""
        return self.status is not None and self.status.state == AppState.SUCCEEDED


class Supervisor:
    """Drives one :class:`~torchx_tpu_torch.specs.api.AppDryRunInfo` to completion
    under a :class:`~torchx_tpu_torch.supervisor.policy.SupervisorPolicy`.

    Construct with a live :class:`~torchx_tpu_torch.runner.api.Runner` (the
    session that produced the dryrun) and call :meth:`run`. ``sleep`` and
    ``rng`` are injectable for tests — a scripted fake scheduler plus a
    recording sleep makes the whole state machine deterministic."""

    def __init__(
        self,
        runner: "Runner",
        dryrun_info: AppDryRunInfo,
        policy: Optional[SupervisorPolicy] = None,
        sleep: Callable[[float], None] = time.sleep,
        rng: Optional[random.Random] = None,
        session: Optional[str] = None,
        clock: Callable[[], float] = time.time,
    ) -> None:
        if dryrun_info._app is None or not dryrun_info._scheduler:
            raise ValueError(
                "dryrun_info was not produced by Runner.dryrun/materialize_dryrun"
                " (missing _app/_scheduler); the supervisor cannot resubmit it"
            )
        self._runner = runner
        self._dryrun_info = dryrun_info
        self._policy = policy or SupervisorPolicy()
        self._sleep = sleep
        self._clock = clock
        self._rng = rng or random.Random()
        self.session = session or make_unique("sup")
        self._ledger = AttemptLedger(self.session)
        # resume state (populated by :meth:`resume`): reattach here instead
        # of submitting a fresh first attempt, with restored counters
        self._resume_handle: Optional[AppHandle] = None
        self._resume_attempts = 0
        self._resume_retries: dict[FailureClass, int] = {}
        self._resume_steps: list[Optional[int]] = []
        # gang health: factory is injectable so tests can hand the monitor
        # a synthetic trace file / clock; verdict of the attempt the gang
        # monitor killed, consumed by the reshape step
        self.monitor_factory: Callable[..., GangMonitor] = GangMonitor
        self._last_verdict: Optional[GangVerdict] = None
        # heartbeats/leases stamped before this epoch belong to a previous
        # attempt: each resubmission advances the floor so the fresh
        # monitor never reads the dead attempt's evidence as an instant
        # HANG while the new gang is still compiling
        self._evidence_floor = 0.0
        # did the monitor see every expected replica live on the current
        # shape? consumed by _maybe_reshape's preemption grow-back
        self._gang_was_full = False
        # elastic reshape: resolved axis sizes of the mesh the CURRENT
        # attempt runs on (None until the first reshape when no resume
        # replayed one); the spec string injected as $TPX_MESH
        self._current_mesh: Optional[dict[str, int]] = None
        self._mesh_spec: Optional[str] = None

    # -- crash-safe resume -------------------------------------------------

    @classmethod
    def resume(
        cls,
        runner: "Runner",
        session: str,
        sleep: Callable[[float], None] = time.sleep,
        rng: Optional[random.Random] = None,
    ) -> "Supervisor":
        """Reattach to a supervised session after the client crashed.

        Rebuilds the submission recipe from the session's ``meta.json``
        (AppDef + cfg + policy re-materialized through the scheduler's own
        ``materialize_dryrun``) and replays ``ledger.jsonl`` to restore the
        attempt counter, per-class retry counts, and — crucially — the
        handle of the last submitted attempt. :meth:`run` then polls that
        live handle instead of submitting a duplicate: a job that kept
        running while the supervisor was dead is simply picked back up.
        """
        from torchx_tpu_torch.specs.serialize import (
            appdef_from_dict,
            supervisor_policy_from_dict,
        )

        ledger = AttemptLedger(session)
        meta = ledger.read_meta()
        scheduler = meta["scheduler"]
        app = appdef_from_dict(meta["app"])
        policy = supervisor_policy_from_dict(meta.get("policy") or {})
        sched = runner._scheduler(scheduler)
        info = sched.materialize_dryrun(app, meta.get("cfg") or {})
        sup = cls(runner, info, policy, sleep=sleep, rng=rng, session=session)
        sup._restore(ledger)
        if sup._resume_handle is None:
            raise ValueError(
                f"session {session!r} has no submitted attempt to reattach"
                " to (the original client died before its first submit);"
                " start a fresh supervise instead"
            )
        return sup

    def _restore(self, ledger: AttemptLedger) -> None:
        retries: dict[FailureClass, int] = {fc: 0 for fc in FailureClass}
        for entry in ledger.entries():
            transition = entry.get("transition")
            if transition == "submitted":
                self._resume_attempts = max(
                    self._resume_attempts, int(entry.get("attempt") or 0)
                )
                handle = entry.get("handle")
                if handle:
                    self._resume_handle = str(handle)
                    ts = entry.get("time_usec")
                    if ts:
                        # evidence older than the reattached attempt's own
                        # submission came from an earlier attempt
                        self._evidence_floor = float(ts) / 1e6
                step = entry.get("resume_step")
                self._resume_steps.append(
                    int(step) if step is not None else None
                )
                mesh = entry.get("mesh")
                if mesh:
                    # replay the reshaped mesh so a resumed session keeps
                    # resubmitting onto the degraded shape, not the launch one
                    self._mesh_spec = str(mesh)
                    self._current_mesh = self._sizes_from_spec(str(mesh))
            elif transition == "resubmitting":
                name = str(entry.get("failure_class") or "").rsplit(".", 1)[-1]
                try:
                    retries[FailureClass[name]] += 1
                except KeyError:
                    pass
        self._resume_retries = retries

    # -- event plumbing ----------------------------------------------------

    def _emit(
        self, transition: str, app_id: Optional[str], **metadata: object
    ) -> None:
        record(
            TpxEvent(
                session=self._runner._name,
                scheduler=self._dryrun_info._scheduler or "",
                api="supervise",
                app_id=app_id,
                app_metadata={"transition": transition, **metadata},
            )
        )
        # the same transition goes to the durable ledger so a fresh client
        # can reconstruct the loop's exact state after a crash
        self._ledger.append(transition, app_id, **metadata)

    def _write_meta(self) -> None:
        from torchx_tpu_torch.specs.serialize import (
            appdef_to_dict,
            supervisor_policy_to_dict,
        )

        try:
            meta = {
                "session": self.session,
                "scheduler": self._dryrun_info._scheduler or "",
                "runner_session": self._runner._name,
                "app": appdef_to_dict(self._dryrun_info._app),
                "cfg": dict(self._dryrun_info._cfg or {}),
                "policy": supervisor_policy_to_dict(self._policy),
            }
        except (TypeError, ValueError) as e:  # unserializable cfg value
            logger.warning(
                "session %s: could not persist resume metadata (%s);"
                " --resume will not be available",
                self.session,
                e,
            )
            return
        self._ledger.write_meta(meta)

    # -- gang / mesh helpers -----------------------------------------------

    def _total_replicas(self) -> int:
        app = self._dryrun_info._app
        assert app is not None  # checked in __init__
        return max(1, sum(r.num_replicas for r in app.roles))

    def _total_devices(self) -> int:
        return self._total_replicas() * self._policy.devices_per_replica

    def _sizes_from_spec(self, spec: str) -> Optional[dict[str, int]]:
        """Resolved axis sizes for a spec: a fully-explicit spec resolves
        against its own product; a wildcard one against the launch device
        count. None when the spec cannot resolve (caller skips reshaping)."""
        try:
            cfg = parse_mesh_spec(spec)
            sizes = {
                a: getattr(cfg, a)
                for a in ("pp", "dp", "fsdp", "ep", "tp", "sp")
            }
            if -1 not in sizes.values():
                return sizes
            return cfg.resolve(self._total_devices())
        except ValueError as e:
            logger.warning("cannot resolve mesh spec %r: %s", spec, e)
            return None

    def _maybe_reshape(self, fclass: FailureClass) -> None:
        """After PREEMPTION/HANG, degrade the mesh for the next attempt.

        With a gang verdict (the monitor killed the attempt and counted
        survivors) the data axes are refit to the surviving capacity;
        without one (plain scheduler-reported preemption) the shape
        degrades one binary step. A shape that cannot shrink further —
        or a target that cannot preserve the model axes — keeps the
        current shape: resubmitting at the same size is always safe.

        The blind binary step must not ratchet a healthy job toward dp=1
        across a long run's occasional preemptions: once the monitor has
        seen the full gang live during the attempt (``_gang_was_full``), a
        verdict-less preemption restores the launch mesh instead — a
        reschedule is a fresh allocation at the requested size, and the
        capacity demonstrably came back."""
        policy = self._policy
        verdict = self._last_verdict
        self._last_verdict = None
        if not policy.elastic_reshape or not policy.mesh:
            return
        if fclass not in (FailureClass.PREEMPTION, FailureClass.HANG):
            return
        cur = self._current_mesh or self._sizes_from_spec(policy.mesh)
        if cur is None:
            return
        target = None
        if verdict is not None and 0 < verdict.survivors < verdict.expected:
            target = verdict.survivors * policy.devices_per_replica
        elif fclass is FailureClass.PREEMPTION and self._gang_was_full:
            launch = self._sizes_from_spec(policy.mesh)
            if launch is not None and launch != cur:
                self._current_mesh = launch
                self._mesh_spec = mesh_sizes_spec(launch)
                obs_metrics.GANG_RESHAPES.inc()
                logger.info(
                    "elastic grow-back: %s -> %s (full gang was healthy"
                    " before the preemption)",
                    mesh_sizes_spec(cur),
                    self._mesh_spec,
                )
            return  # gang was demonstrably whole: never blind-shrink it
        try:
            new = shrink_data_axes(cur, target)
        except ValueError as e:
            logger.warning(
                "keeping mesh %s: %s", mesh_sizes_spec(cur), e
            )
            self._current_mesh = cur
            self._mesh_spec = mesh_sizes_spec(cur)
            return
        self._current_mesh = new
        self._mesh_spec = mesh_sizes_spec(new)
        obs_metrics.GANG_RESHAPES.inc()
        logger.info(
            "elastic reshape: %s -> %s%s",
            mesh_sizes_spec(cur),
            self._mesh_spec,
            f" ({verdict.survivors}/{verdict.expected} replicas survive)"
            if verdict is not None
            else "",
        )

    # -- attempt mechanics -------------------------------------------------

    def _submit(self, attempt: int, resume_step: Optional[int]) -> AppHandle:
        """Re-materialize and submit one attempt. Works on a deep copy of
        the original AppDef (resume env must not accumulate across
        attempts) and goes through the scheduler's own materialize so each
        attempt gets a fresh unique app id."""
        if attempt > 1:
            # floor BEFORE scheduling so nothing the new attempt emits can
            # land below it; the first attempt keeps floor 0 (pre-submit
            # evidence can only be ours)
            self._evidence_floor = self._clock()
        self._gang_was_full = False
        info = self._dryrun_info
        app = copy.deepcopy(info._app)
        assert app is not None  # checked in __init__
        for role in app.roles:
            if resume_step is not None:
                role.env[self._policy.resume_env] = str(resume_step)
            if self._mesh_spec:
                # degraded shape from an elastic reshape: trainers honor
                # $TPX_MESH over their --mesh flag
                role.env[settings.ENV_TPX_MESH] = self._mesh_spec
            # re-point the in-job trace context at THIS attempt (the
            # deep-copied env still carries the dryrun-time context)
            obs_trace.inject_env(role.env, force=True)
        sched = self._runner._scheduler(info._scheduler)
        new_info = sched.materialize_dryrun(app, info._cfg or {})
        handle = self._runner.schedule(new_info)
        _, _, app_id = parse_app_handle(handle)
        self._emit(
            "submitted",
            app_id,
            attempt=attempt,
            resume_step=resume_step,
            handle=handle,
            mesh=self._mesh_spec,
        )
        return handle

    def _await_terminal(self, handle: AppHandle) -> Optional[AppStatus]:
        """Block until the attempt reaches a terminal state (or vanishes).

        With ``policy.elastic`` the backend's elastic watcher runs first —
        in-attempt shrink-restarts are its job; only the attempt's terminal
        outcome comes back to the supervisor. With a hang deadline set the
        gang monitor interleaves with status polling
        (:meth:`_await_terminal_gang`)."""
        if self._policy.elastic:
            try:
                self._runner.watch_elastic(
                    handle, poll_interval=self._policy.poll_interval
                )
            except ValueError:
                logger.debug(
                    "backend has no elastic watcher; falling back to polling"
                )
        if self._policy.hang_deadline_seconds > 0:
            return self._await_terminal_gang(handle)
        return self._runner.wait(
            handle, wait_interval=self._policy.poll_interval, rng=self._rng,
            sleep=self._sleep,
            poll_miss_budget=self._policy.poll_miss_budget,
        )

    def _await_terminal_gang(self, handle: AppHandle) -> Optional[AppStatus]:
        """Status polling interleaved with gang-health checks.

        ``Runner.wait`` runs in ``gang_check_interval`` slices; every
        timeout slice the monitor re-reads heartbeats/leases. An unhealthy
        verdict (HANG / PARTIAL_LOSS) means the scheduler still says
        RUNNING but the gang is dead: the supervisor kills the attempt
        itself and synthesizes a terminal FAILED status classified
        :attr:`FailureClass.HANG` so the normal budget/backoff/resume path
        takes over. STRAGGLER is warn-only (event + metric, once per
        verdict change)."""
        policy = self._policy
        monitor = self.monitor_factory(
            expected_replicas=self._total_replicas(),
            hang_deadline_s=policy.hang_deadline_seconds,
            lease_ttl_s=policy.lease_ttl_seconds,
            straggler_step_lag=policy.straggler_step_lag,
            ignore_evidence_before=self._evidence_floor,
        )
        _, _, app_id = parse_app_handle(handle)
        last_state: Optional[GangState] = None
        while True:
            try:
                return self._runner.wait(
                    handle,
                    wait_interval=min(
                        policy.poll_interval, policy.gang_check_interval
                    ),
                    timeout=policy.gang_check_interval,
                    rng=self._rng,
                    sleep=self._sleep,
                    poll_miss_budget=policy.poll_miss_budget,
                )
            except TimeoutError:
                pass  # the attempt is still running: gang-check it
            verdict = monitor.check()
            if verdict.state != last_state and verdict.state not in (
                GangState.HEALTHY,
                GangState.WAITING,
            ):
                obs_metrics.GANG_UNHEALTHY.inc(kind=str(verdict.state))
                self._emit(
                    "gang_" + str(verdict.state).lower(),
                    app_id,
                    detail=verdict.detail,
                    survivors=verdict.survivors,
                    expected=verdict.expected,
                    lost=list(verdict.lost),
                )
            last_state = verdict.state
            if verdict.state in (GangState.HEALTHY, GangState.STRAGGLER):
                # every expected replica live on the current shape —
                # capacity evidence for the preemption grow-back
                self._gang_was_full = True
            if not verdict.unhealthy:
                continue
            logger.warning(
                "app %s gang %s: %s; killing the attempt",
                app_id,
                verdict.state,
                verdict.detail,
            )
            self._last_verdict = verdict
            try:
                self._runner.cancel(handle)
            except Exception as e:  # best effort: the kill must not mask
                logger.warning("cancel of hung app %s failed: %s", app_id, e)
            return AppStatus(
                state=AppState.FAILED,
                msg=f"gang {verdict.state}: {verdict.detail}",
                failure_class=FailureClass.HANG,
            )

    # -- the state machine -------------------------------------------------

    def run(self) -> SupervisorResult:
        """Run attempts until SUCCEEDED/CANCELLED, a budget is exhausted,
        or the app vanishes from its scheduler; returns the full
        :class:`SupervisorResult` history.

        Each attempt (submit → wait-to-terminal → classification) is one
        ``supervisor.attempt`` span and each backoff sleep one
        ``supervisor.backoff`` span, all nested under the caller's trace —
        together with the transition events this is the full audit trail
        the trace renders."""
        # umbrella span: guarantees all attempts share ONE trace even when
        # run() is called directly (Runner.supervise adds its own parent)
        self._write_meta()
        with obs_trace.span(
            "supervisor.run",
            session=self._runner._name,
            scheduler=self._dryrun_info._scheduler,
        ) as root:
            result = self._run_attempts()
            if root is not None:
                root.attrs["attempts"] = result.attempts
                if result.status is not None:
                    root.attrs["state"] = str(result.status.state)
        return result

    def _run_attempts(self) -> SupervisorResult:
        policy = self._policy
        retries: dict[FailureClass, int] = {fc: 0 for fc in FailureClass}
        for fc, n in self._resume_retries.items():
            retries[fc] = n
        result = SupervisorResult(
            status=None, retries=retries, session=self.session
        )

        # a resumed session reattaches to the last submitted attempt (it
        # may still be running — or already terminal, in which case the
        # normal classification path below takes over immediately)
        reattach = self._resume_handle
        self._resume_handle = None
        resume_step: Optional[int] = None
        attempt = self._resume_attempts
        if reattach is not None and self._resume_steps:
            resume_step = self._resume_steps[-1]
        while True:
            if reattach is None:
                attempt += 1
            with obs_trace.span(
                "supervisor.attempt",
                session=self._runner._name,
                attempt=attempt,
                resume_step=resume_step,
            ) as asp:
                if reattach is not None:
                    handle = reattach
                    reattach = None
                    _, _, rid = parse_app_handle(handle)
                    self._emit("reattached", rid, attempt=attempt)
                else:
                    handle = self._submit(attempt, resume_step)
                result.handles.append(handle)
                result.resume_steps.append(resume_step)
                result.attempts = attempt

                status = self._await_terminal(handle)
                result.status = status
                _, _, app_id = parse_app_handle(handle)
                if asp is not None:
                    asp.attrs["app_id"] = app_id
                    if status is not None:
                        asp.attrs["state"] = str(status.state)
                if status is None:
                    # the scheduler forgot the app (expired / deleted from
                    # under us); resubmitting blind could double-run — stop.
                    self._emit("vanished", app_id, attempt=attempt)
                    logger.warning("app %s vanished from its scheduler", app_id)
                    return result
                if status.state in (AppState.SUCCEEDED, AppState.CANCELLED):
                    self._emit(
                        "finished",
                        app_id,
                        attempt=attempt,
                        state=str(status.state),
                    )
                    return result

                # terminal failure: classify conservatively (APP) when the
                # backend attached nothing
                fclass = status.failure_class or FailureClass.APP
                if asp is not None:
                    asp.attrs["failure_class"] = str(fclass)
                retries[fclass] += 1
                budget = policy.budget_for(fclass)
                if retries[fclass] > budget:
                    retries[fclass] = budget  # report consumed, not attempted
                    result.budget_exhausted = fclass
                    self._emit(
                        "budget_exhausted",
                        app_id,
                        attempt=attempt,
                        failure_class=str(fclass),
                        budget=budget,
                        state=str(status.state),
                    )
                    logger.error(
                        "app %s: %s budget (%d) exhausted; final state %s",
                        app_id,
                        fclass,
                        budget,
                        status.state,
                    )
                    return result

                obs_metrics.RETRIES.inc(failure_class=str(fclass))
                delay = policy.backoff_delay(retries[fclass], rng=self._rng)
                if policy.checkpoint_dir:
                    resume_step = latest_checkpoint_step(policy.checkpoint_dir)
                self._maybe_reshape(fclass)
                self._emit(
                    "resubmitting",
                    app_id,
                    attempt=attempt,
                    failure_class=str(fclass),
                    retry=retries[fclass],
                    budget=budget,
                    backoff_seconds=round(delay, 3),
                    resume_step=resume_step,
                    state=str(status.state),
                    mesh=self._mesh_spec,
                )
                logger.info(
                    "app %s %s (%s); retry %d/%d in %.1fs%s",
                    app_id,
                    status.state,
                    fclass,
                    retries[fclass],
                    budget,
                    delay,
                    f", resuming from step {resume_step}"
                    if resume_step is not None
                    else "",
                )
            with obs_trace.span(
                "supervisor.backoff",
                session=self._runner._name,
                failure_class=str(fclass),
                retry=retries[fclass],
                delay_seconds=round(delay, 3),
            ):
                self._sleep(delay)
            obs_metrics.BACKOFF_SECONDS.inc(delay)


def supervise(
    runner: "Runner",
    dryrun_info: AppDryRunInfo,
    policy: Optional[SupervisorPolicy] = None,
) -> SupervisorResult:
    """Convenience wrapper: build a :class:`Supervisor` and :meth:`run` it."""
    return Supervisor(runner, dryrun_info, policy).run()
