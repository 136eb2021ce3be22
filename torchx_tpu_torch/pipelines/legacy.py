"""Pre-DAG-engine pipeline runners, kept for import compatibility.

The port's copy of :mod:`torchx_tpu.pipelines.legacy`.

These are the kfp-era execution paths that predate the journaled,
event-driven :mod:`torchx_tpu_torch.pipelines.engine`: a KFP/Argo workflow
materializer and a blocking generation-by-generation local runner over a
:class:`~torchx_tpu_torch.pipelines.api.Pipeline`. The old module paths
(``torchx_tpu_torch.pipelines.kfp``, ``torchx_tpu_torch.pipelines.local_runner``)
re-export them behind deprecation warnings; new code should submit a
:class:`~torchx_tpu_torch.pipelines.dag.PipelineSpec` through the control
daemon instead.

A stage whose GPU slice spans more than one host (``resource.gpu.hosts >
1``) becomes a JobSet, as a multi-host TPU slice does in the JAX copy,
and a one-host stage a pod from the port's GKE pod template (whose
rendezvous port is the component's, so no ``coordinator_port`` is
passed).
"""

from __future__ import annotations

import json
import logging
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Mapping, Optional

from torchx_tpu_torch.pipelines.api import Pipeline, topo_order
from torchx_tpu_torch.specs.api import AppDef, AppHandle, AppState, AppStatus, CfgVal

logger = logging.getLogger(__name__)


# =========================================================================
# KFP/Argo materialization (was pipelines/kfp.py)
# =========================================================================


def _stage_template(name: str, app: AppDef, namespace: str) -> dict[str, Any]:
    from torchx_tpu_torch.schedulers.gke_scheduler import (
        app_to_jobset,
        role_to_pod_template,
        sanitize_name,
    )

    role = app.roles[0]
    multi_host = (
        (role.resource.gpu is not None and role.resource.gpu.hosts > 1)
        or len(app.roles) > 1
        or role.num_replicas > 1
    )
    if multi_host:
        jobset = app_to_jobset(
            app,
            # same 40-char budget as GKEScheduler._submit_dryrun: leaves
            # room in the 63-char pod-name cap for the role name plus
            # job/pod index suffixes
            app_name=sanitize_name(f"{name}-{app.name}", max_len=40),
            namespace=namespace,
            queue=None,
            service_account=None,
        )
        return {
            "name": name,
            "resource": {
                "action": "create",
                "setOwnerReference": True,
                "successCondition": "status.terminalState == Completed",
                "failureCondition": "status.terminalState == Failed",
                # Argo's resource.manifest field is a string (YAML/JSON)
                "manifest": json.dumps(jobset, indent=2),
            },
        }
    pod = role_to_pod_template(
        role,
        app_name=sanitize_name(app.name),
        coordinator_host="localhost",
        service_account=None,
    )
    return {
        "name": name,
        "container": pod["spec"]["containers"][0],
        "metadata": pod["metadata"],
        "nodeSelector": pod["spec"].get("nodeSelector", {}),
        "tolerations": pod["spec"].get("tolerations", []),
        "volumes": pod["spec"].get("volumes", []),
    }


def pipeline_to_workflow(
    pipeline: Pipeline, namespace: str = "default"
) -> dict[str, Any]:
    """-> Argo Workflow resource dict implementing the DAG.

    Each stage's AppDef role becomes an Argo template (container + GPU
    resource limits + node selectors, reusing the GKE scheduler's pod
    materialization); multi-host GPU stages are emitted as ``resource``
    templates creating the same JobSet the GKE scheduler would submit.
    The result is a plain dict — submit it with ``argo submit``, the Argo
    REST API, or mount it into a KFP v2 pipeline.
    """
    from torchx_tpu_torch.schedulers.gke_scheduler import sanitize_name

    topo_order(pipeline)  # validates names/cycles
    # sanitize each stage name once and reuse the result so template/task/
    # dependency refs all carry the identical string
    names = {s.name: sanitize_name(s.name) for s in pipeline.stages}
    templates = [
        _stage_template(names[s.name], s.app, namespace) for s in pipeline.stages
    ]
    dag_tasks = [
        {
            "name": names[s.name],
            "template": names[s.name],
            "dependencies": [names[d] for d in s.depends_on],
        }
        for s in pipeline.stages
    ]
    return {
        "apiVersion": "argoproj.io/v1alpha1",
        "kind": "Workflow",
        "metadata": {
            "generateName": f"{sanitize_name(pipeline.name)}-",
            "namespace": namespace,
        },
        "spec": {
            "entrypoint": "dag",
            "templates": [
                {"name": "dag", "dag": {"tasks": dag_tasks}},
                *templates,
            ],
        },
    }


# =========================================================================
# Blocking local runner (was pipelines/local_runner.py)
# =========================================================================


@dataclass
class PipelineRun:
    """Per-stage handles + terminal statuses of one :func:`run_pipeline`."""

    pipeline: str
    handles: dict[str, AppHandle] = field(default_factory=dict)
    statuses: dict[str, AppStatus] = field(default_factory=dict)

    @property
    def state(self) -> AppState:
        """FAILED if any stage failed/cancelled, RUNNING while stages are
        outstanding, else SUCCEEDED."""
        if any(
            s.state in (AppState.FAILED, AppState.CANCELLED)
            for s in self.statuses.values()
        ):
            return AppState.FAILED
        if len(self.statuses) < len(self.handles) or not self.handles:
            return AppState.RUNNING
        return AppState.SUCCEEDED


def run_pipeline(
    runner: Any,
    pipeline: Pipeline,
    scheduler: str,
    cfg: Optional[Mapping[str, CfgVal]] = None,
    wait_interval: float = 1.0,
    sleep: Callable[[float], None] = time.sleep,
) -> PipelineRun:
    """Execute the DAG generation-by-generation; returns per-stage handles
    + terminal statuses. All stages of a generation are submitted
    concurrently, then awaited; a failed stage fails the pipeline and
    cancels its in-flight siblings (fail-fast). Each stage's run is
    lineage-linked to its dependencies via the tracker's parent-run
    mechanism."""
    run = PipelineRun(pipeline=pipeline.name)
    for generation in topo_order(pipeline):
        # submit the whole generation
        for stage in generation:
            parent = (
                run.handles.get(stage.depends_on[0]) if stage.depends_on else None
            )
            handle = runner.run(
                stage.app, scheduler, cfg, parent_run_id=parent
            )
            run.handles[stage.name] = handle
            _link_extra_parents(run, stage, handle)
            logger.info("pipeline %s: stage %s -> %s", pipeline.name, stage.name, handle)

        # poll the generation concurrently: first failure cancels the
        # still-running siblings (fail-fast — a dead stage must not let a
        # 3-hour GPU sibling run to completion)
        pending = {s.name for s in generation}
        failed = False
        while pending:
            for name in list(pending):
                status = runner.status(run.handles[name])
                if status is None:
                    raise RuntimeError(f"stage {name} vanished ({run.handles[name]})")
                if status.is_terminal():
                    pending.discard(name)
                    run.statuses[name] = status
                    if status.state != AppState.SUCCEEDED:
                        failed = True
            if failed and pending:
                for name in list(pending):
                    logger.warning("cancelling in-flight stage %s", name)
                    runner.cancel(run.handles[name])
                    st = runner.status(run.handles[name])
                    if st is not None:
                        run.statuses[name] = st
                    pending.discard(name)
                break
            if pending:
                sleep(wait_interval)
        if failed:
            logger.error("pipeline %s failed; skipping downstream stages", pipeline.name)
            return run
    return run


def _link_extra_parents(run: PipelineRun, stage, handle: AppHandle) -> None:  # noqa: ANN001
    """Stages with multiple dependencies get lineage to ALL parents: the
    first rides the runner's parent_run_id env; the rest are written
    client-side into the configured trackers (best-effort)."""
    extra = [run.handles[d] for d in stage.depends_on[1:] if d in run.handles]
    if not extra:
        return
    try:
        from torchx_tpu_torch.runner.config import load_tracker_sections
        from torchx_tpu_torch.tracker.api import _load_tracker

        for name, config in load_tracker_sections().items():
            tracker = _load_tracker(name, config)
            if tracker is None:
                continue
            for parent in extra:
                tracker.add_source(handle, parent)
    except Exception as e:  # noqa: BLE001 - lineage is best-effort
        logger.warning("could not record extra lineage for %s: %s", stage.name, e)
