"""GKE scheduler: gang-schedule GPU slices via JobSet (+ optional Kueue).

The port's copy of :mod:`torchx_tpu.schedulers.gke_scheduler`, on GPU node
pools in place of TPU slices. Reference analog:
torchx/schedulers/kubernetes_scheduler.py (1131 LoC), which maps AppDef ->
Volcano Job CRD. This backend maps AppDef -> **JobSet**
(jobset.x-k8s.io/v1alpha2), the stack GKE documents for multi-host
training:

* one ReplicatedJob per role; for GPU slice roles each Job is an **Indexed
  Job** with ``completions = parallelism = slice.hosts`` (one pod per host,
  whose ``spmd_main`` starts one worker a card);
* ``Role.num_replicas`` > 1 on a GPU role means N slices:
  ``replicatedJob.replicas = N``, every slice's pods joining one process
  group through the ``TPX_SLICE_ID`` / ``TPX_HOST_ID`` /
  ``TPX_HOSTS_PER_SLICE`` decomposition, and ``TPX_NUM_SLICES`` the slice
  count that ``macros.num_replicas`` and a resize read;
* GPU placement via the node selector ``cloud.google.com/gke-accelerator``
  (``nvidia-h100-80gb``), the ``nvidia.com/gpu`` resource limit (cards a
  host) and a toleration of GKE's ``nvidia.com/gpu`` taint — the role the
  Volcano task + nvidia.com/gpu limits play in the reference
  (kubernetes_scheduler.py:330-381);
* gang semantics come from JobSet's failure policy (any pod failure
  restarts the whole set, up to ``max_retries``) plus optional Kueue queue
  admission (``kueue.x-k8s.io/queue-name`` label) in place of Volcano
  gang scheduling (reference :553-569);
* rendezvous: JobSet's per-job headless service gives pods stable DNS;
  the coordinator address is the role-0/job-0/pod-0 DNS name injected as
  ``TPX_COORDINATOR_HOST`` (analog of ``VC_{role}_0_HOSTS``, reference
  :524). ``macros.replica_id`` substitutes to ``$(TPX_REPLICA_ID)`` which
  kubelet expands from the Job completion index at runtime.

The kubernetes client import is deferred and injectable: all request
materialization is plain dicts, so dryrun tests run with no cluster
(reference test strategy, kubernetes_scheduler_test.py).
"""

from __future__ import annotations

import copy
import json
import logging
import math
import os
import re
import time
from dataclasses import dataclass, field
from typing import Any, Iterable, Iterator, Mapping, Optional, TYPE_CHECKING

from torchx_tpu_torch import settings
from torchx_tpu_torch.resilience.call import resilient_call
from torchx_tpu_torch.resilience.policy import NON_IDEMPOTENT
from torchx_tpu_torch.schedulers.api import (
    safe_int as _safe_int,
    DescribeAppResponse,
    ListAppResponse,
    Scheduler,
    SchedulerCapabilities,
    Stream,
    filter_regex,
)
from torchx_tpu_torch.schedulers.ids import cleanup, make_unique, sanitize_name
from torchx_tpu_torch.util.strings import normalize_str
from torchx_tpu_torch.schedulers.structured_opts import StructuredOpts
from torchx_tpu_torch.specs.api import (
    AppDef,
    AppDryRunInfo,
    AppState,
    BindMount,
    CfgVal,
    DeviceMount,
    FailureClass,
    GPU_GENERATIONS,
    ReplicaStatus,
    Role,
    RoleStatus,
    VolumeMount,
    is_terminal,
    macros,
    runopts,
)
from torchx_tpu_torch.specs.overlays import apply_overlay, get_overlay
from torchx_tpu_torch.workspace.docker_workspace import DockerWorkspaceMixin

if TYPE_CHECKING:
    from kubernetes.client import ApiClient

logger = logging.getLogger(__name__)

JOBSET_GROUP = "jobset.x-k8s.io"
JOBSET_VERSION = "v1alpha2"
JOBSET_PLURAL = "jobsets"

# node overhead subtracted from requests so pods fit on the node after
# kubelet reservations (reference kubernetes_scheduler.py:155-161)
RESERVED_MILLICPU = 100
RESERVED_MEMMB = 1024

# JobSet condition type -> AppState (reference state maps :203-254)
JOBSET_STATE_MAP = {
    "Completed": AppState.SUCCEEDED,
    "Failed": AppState.FAILED,
    "Suspended": AppState.PENDING,
    "StartupPolicyCompleted": AppState.RUNNING,
}

POD_STATE_MAP = {
    "Pending": AppState.PENDING,
    "Running": AppState.RUNNING,
    "Succeeded": AppState.SUCCEEDED,
    "Failed": AppState.FAILED,
    "Unknown": AppState.UNKNOWN,
}

LABEL_APP_NAME = "tpx.sh/app-name"
LABEL_ROLE_NAME = "tpx.sh/role-name"
# elastic floor, surfaced to autoscalers and enforced by resize
ANNOTATION_MIN_REPLICAS = "tpx.sh/min-replicas"
LABEL_VERSION = "tpx.sh/version"
ANNOTATION_APP = "tpx.sh/appdef"


@dataclass
class GKEOpts(StructuredOpts):
    """Typed run config for the gke scheduler (StructuredOpts generates the
    runopts schema from these fields + attribute docstrings)."""

    namespace: str = "default"
    """k8s namespace to submit into."""

    queue: Optional[str] = None
    """Kueue LocalQueue name for gang admission (jobs submit suspended and
    Kueue unsuspends when the full slice fits)."""

    service_account: Optional[str] = None
    """k8s service account for the pods."""

    elastic_controller: bool = False
    """run the elastic shrink controller as an in-cluster Job (survives
    operator disconnect; requires a role with min_replicas, a
    service_account with jobset get/delete/create + batch/v1 RBAC, and a
    role image with the ``kubernetes`` extra installed —
    ``pip install torchx-tpu[kubernetes]``, which carries the port's
    ``tpx-torch``)."""


@dataclass
class GKEJob:
    """Materialized request: the JobSet resource + images to push."""

    namespace: str
    resource: dict[str, Any]
    images_to_push: dict[str, tuple[str, str]] = field(default_factory=dict)
    # in-cluster elastic controller Job (``elastic_controller=True``):
    # created alongside the JobSet so slice-failure shrink keeps working
    # after the operator's `tpx watch` process is gone
    controller: Optional[dict[str, Any]] = None

    def __str__(self) -> str:
        payload = self.resource
        if self.controller is not None:
            payload = {"jobset": self.resource, "controller": self.controller}
        return json.dumps(payload, indent=2, default=str)


# =========================================================================
# Request materialization (pure functions -> testable without a cluster)
# =========================================================================


def role_to_container(role: Role) -> dict[str, Any]:
    gpu = role.resource.gpu
    limits: dict[str, Any] = {}
    requests: dict[str, Any] = {}
    if role.resource.cpu > 0:
        mcpu = int(role.resource.cpu * 1000)
        limits["cpu"] = f"{mcpu}m"
        requests["cpu"] = f"{max(0, mcpu - RESERVED_MILLICPU)}m"
    if role.resource.memMB > 0:
        limits["memory"] = f"{role.resource.memMB}M"
        requests["memory"] = f"{max(0, role.resource.memMB - RESERVED_MEMMB)}M"
    if gpu is not None:
        limits["nvidia.com/gpu"] = gpu.gpus_per_host
        requests["nvidia.com/gpu"] = gpu.gpus_per_host
    for dev, count in role.resource.devices.items():
        limits[dev] = count
        requests[dev] = count

    volume_mounts = []
    for i, m in enumerate(role.mounts):
        if isinstance(m, BindMount):
            volume_mounts.append(
                {"name": f"mount-{i}", "mountPath": m.dst_path, "readOnly": m.read_only}
            )
        elif isinstance(m, VolumeMount):
            volume_mounts.append(
                {"name": f"mount-{i}", "mountPath": m.dst_path, "readOnly": m.read_only}
            )
        elif isinstance(m, DeviceMount):
            volume_mounts.append(
                {
                    "name": f"mount-{i}",
                    "mountPath": m.dst_path,
                    "readOnly": "w" not in m.permissions,
                }
            )
    # /dev/shm tmpfs for framework IPC (reference :370-381)
    volume_mounts.append({"name": "dshm", "mountPath": "/dev/shm"})

    env = [{"name": k, "value": v} for k, v in role.env.items()]
    ports = [
        {"name": name[:15], "containerPort": port}
        for name, port in role.port_map.items()
    ]
    return {
        "name": sanitize_name(role.name),
        "image": role.image,
        "command": [role.entrypoint, *role.args],
        "env": env,
        "ports": ports,
        "resources": {"limits": limits, "requests": requests},
        "volumeMounts": volume_mounts,
    }


def role_to_pod_template(
    role: Role,
    app_name: str,
    coordinator_host: str,
    service_account: Optional[str],
    num_slices: int = 1,
) -> dict[str, Any]:
    """Pod template for one host of a GPU slice (or CPU replica) of the role.

    Gang identity follows the canonical JobSet multi-slice pattern: the pod
    template is shared by all child Jobs (slices), so per-slice identity must
    come from fieldRefs at pod start. Kubelet env expansion is
    substitution-only, so for ``num_slices > 1`` we inject the
    (TPX_SLICE_ID, TPX_HOST_ID, TPX_HOSTS_PER_SLICE) decomposition and the
    spmd bootstrap derives the global TPX_REPLICA_ID — matching
    ``role_replica_env`` so every backend forms one global world of
    ``hosts * num_slices`` processes. A GPU role's pods also name their
    slice (``TPX_GPU_ACCELERATOR_TYPE``, ``TPX_GPU_TOPOLOGY``), as
    ``role_replica_env`` does on every other backend; a resize reads the
    first to tell a slice role from a plain GPU job.
    """
    gpu = role.resource.gpu
    num_hosts = gpu.hosts if gpu else role.num_replicas

    container = role_to_container(role)
    # gang identity: completion index -> host index; kubelet expands
    # $(JOB_COMPLETION_INDEX) references in env/args at pod start
    identity: list[dict[str, Any]] = [
        {
            "name": "JOB_COMPLETION_INDEX",
            "valueFrom": {
                "fieldRef": {
                    "fieldPath": "metadata.annotations['batch.kubernetes.io/job-completion-index']"
                }
            },
        },
    ]
    if gpu is not None and num_slices > 1:
        identity += [
            {
                "name": "JOB_INDEX",
                "valueFrom": {
                    "fieldRef": {
                        "fieldPath": "metadata.annotations['jobset.sigs.k8s.io/job-index']"
                    }
                },
            },
            {"name": settings.ENV_TPX_SLICE_ID, "value": "$(JOB_INDEX)"},
            {"name": settings.ENV_TPX_HOST_ID, "value": "$(JOB_COMPLETION_INDEX)"},
            {"name": settings.ENV_TPX_HOSTS_PER_SLICE, "value": str(num_hosts)},
            {
                "name": settings.ENV_TPX_NUM_REPLICAS,
                "value": str(num_hosts * num_slices),
            },
        ]
        if settings.ENV_TPX_NUM_SLICES not in role.env:
            # early in the env list so later $() references expand; a
            # user-provided override in role.env still wins downstream
            identity.append(
                {
                    "name": settings.ENV_TPX_NUM_SLICES,
                    "value": str(num_slices),
                }
            )
    else:
        identity += [
            {
                "name": settings.ENV_TPX_REPLICA_ID,
                "value": "$(JOB_COMPLETION_INDEX)",
            },
            {"name": settings.ENV_TPX_NUM_REPLICAS, "value": str(num_hosts)},
        ]
    if gpu is not None:
        identity += [
            {"name": settings.ENV_TPX_GPU_ACCELERATOR_TYPE, "value": gpu.accelerator_type},
            {"name": settings.ENV_TPX_GPU_TOPOLOGY, "value": gpu.default_topology()},
        ]
    container["env"] = [
        *identity,
        {"name": settings.ENV_TPX_ROLE_NAME, "value": role.name},
        {"name": settings.ENV_TPX_COORDINATOR_HOST, "value": coordinator_host},
        {"name": settings.ENV_TPX_APP_ID, "value": app_name},
        {"name": settings.ENV_TPX_ERROR_FILE, "value": "/tmp/tpx_error.json"},
        *container["env"],
    ]

    volumes: list[dict[str, Any]] = []
    for i, m in enumerate(role.mounts):
        if isinstance(m, BindMount):
            volumes.append(
                {"name": f"mount-{i}", "hostPath": {"path": m.src_path}}
            )
        elif isinstance(m, VolumeMount):
            volumes.append(
                {
                    "name": f"mount-{i}",
                    "persistentVolumeClaim": {"claimName": m.src},
                }
            )
        elif isinstance(m, DeviceMount):
            volumes.append(
                {"name": f"mount-{i}", "hostPath": {"path": m.src_path}}
            )
    volumes.append({"name": "dshm", "emptyDir": {"medium": "Memory"}})

    spec: dict[str, Any] = {
        "restartPolicy": "Never",
        "containers": [container],
        "volumes": volumes,
    }
    if service_account:
        spec["serviceAccountName"] = service_account
    # GPU node pools: a slice role (Resource.gpu) pins its generation's
    # accelerator pool, a GPU role of a mixed cluster (Resource.devices
    # nvidia.com/gpu) its gke.accelerator capability's; both tolerate GKE's
    # GPU taint. A gce.machine_type capability pins the instance type for
    # any kind of role
    selector: dict[str, str] = {}
    accel = (
        GPU_GENERATIONS[gpu.accelerator]["gke_accelerator"]
        if gpu is not None
        else role.resource.capabilities.get("gke.accelerator")
    )
    if accel:
        selector["cloud.google.com/gke-accelerator"] = str(accel)
    machine = role.resource.capabilities.get("gce.machine_type")
    if machine:
        selector["node.kubernetes.io/instance-type"] = str(machine)
    if selector:
        spec["nodeSelector"] = selector
    if gpu is not None or role.resource.devices.get("nvidia.com/gpu"):
        spec["tolerations"] = [
            {
                "key": "nvidia.com/gpu",
                "operator": "Exists",
                "effect": "NoSchedule",
            }
        ]

    return {
        "metadata": {
            "labels": {
                LABEL_APP_NAME: app_name,
                # the UN-truncated cleaned role name: pod-name selectors and
                # describe() key off this label, so it must be derivable from
                # role.name alone (the replicatedJob name may carry a
                # budget-truncation suffix that cannot be recomputed without
                # the whole AppDef)
                LABEL_ROLE_NAME: normalize_str(cleanup(role.name)),
            },
        },
        "spec": spec,
    }


def app_to_jobset(
    app: AppDef,
    app_name: str,
    namespace: str,
    queue: Optional[str],
    service_account: Optional[str],
) -> dict[str, Any]:
    """AppDef -> JobSet resource dict. A gang's rendezvous port is its
    component's (``dist.spmd --coordinator_port``): no second coordinator
    is wired, so the JAX backend's ``coordinator_port`` is not copied."""
    replicated_jobs = []
    max_retries = max((r.max_retries for r in app.roles), default=0)

    # Pod names are {jobset}-{replicatedJob}-{jobIndex}-{podIndex}, capped
    # at 63 chars by k8s — budget each role's sanitized name against the
    # app name AND its index suffixes, and compute it ONCE so every
    # consumer (rj name, coordinator DNS) sees the same budgeted string.
    role_names: dict[str, str] = {}
    for role in app.roles:
        r_gpu = role.resource.gpu
        r_hosts = r_gpu.hosts if r_gpu else 1
        n_jobs = role.num_replicas if r_gpu else 1
        n_pods = r_hosts if r_gpu else role.num_replicas
        suffix = len(str(max(n_jobs, 1) - 1)) + len(str(max(n_pods, 1) - 1)) + 3
        budget = 63 - len(app_name) - suffix
        if budget < 8:
            # both in-tree callers cap app_name at 40 chars, which always
            # leaves >= 8; a silent floor here would emit pods k8s rejects
            # at admission (the failure mode the reference checks for at
            # kubernetes_scheduler.py:862-889)
            raise ValueError(
                f"app name {app_name!r} ({len(app_name)} chars) leaves"
                f" {budget} chars for role {role.name!r} in the 63-char"
                " pod-name cap; shorten the app name to <= 40 chars"
            )
        role_names[role.name] = sanitize_name(role.name, max_len=min(53, budget))

    for role in app.roles:
        role_name = role_names[role.name]
        gpu = role.resource.gpu
        hosts = gpu.hosts if gpu else 1
        # For GPU slice roles: one Job per slice (replicas=num_replicas),
        # each an indexed job over the slice's hosts. CPU roles (and GPU
        # roles of a mixed cluster): one job, indexed over num_replicas pods.
        if gpu:
            job_replicas, completions = role.num_replicas, hosts
        else:
            job_replicas, completions = 1, role.num_replicas

        # JobSet DNS: {jobset}-{replicatedJob}-{jobIndex}-{podIndex}.{jobset}
        role0 = role_names[app.roles[0].name]
        coordinator_host = f"{app_name}-{role0}-0-0.{app_name}"

        multislice = bool(gpu) and role.num_replicas > 1
        values = macros.Values(
            img_root="",
            app_id=app_name,
            # multi-slice: an AppDef "replica" is a slice, so the macro is
            # the slice id (TPX_SLICE_ID resolves from the JobSet job index)
            replica_id=f"$({settings.ENV_TPX_SLICE_ID})"
            if multislice
            else f"$({settings.ENV_TPX_REPLICA_ID})",
            # deferred to kubelet env expansion rather than baked as a
            # literal so a `resize` that rewrites the env var propagates to
            # every arg that referenced the macro (for multislice roles the
            # convention is that the macro means the slice count, which
            # resize keeps in TPX_NUM_SLICES)
            num_replicas=f"$({settings.ENV_TPX_NUM_SLICES})"
            if multislice
            else f"$({settings.ENV_TPX_NUM_REPLICAS})",
            coordinator_env=settings.ENV_TPX_COORDINATOR_HOST,
        )
        # multi-slice: the slice id comes from the JobSet job-index fieldRef
        # in the pod template (TPX_NUM_SLICES itself is injected early in
        # the identity env block so $() references expand); every slice
        # joins one process group at slice 0's host 0
        srole = values.apply(role)

        pod_template = role_to_pod_template(
            srole,
            app_name,
            coordinator_host,
            service_account,
            num_slices=role.num_replicas if multislice else 1,
        )

        job_spec: dict[str, Any] = {
            "parallelism": completions,
            "completions": completions,
            "completionMode": "Indexed",
            "backoffLimit": 0,  # gang: restarts are JobSet-level
            "template": pod_template,
        }
        rj: dict[str, Any] = {
            "name": role_name,
            "replicas": job_replicas,
            "template": {"spec": job_spec},
        }
        if role.min_replicas is not None:
            # elastic lower bound. SPMD worlds resize by restart (checkpoint
            # resume + warm compile cache make that cheap); the bound maps to
            # the real admission mechanism available per role shape:
            #  - CPU roles are one Indexed Job over num_replicas pods -> Kueue
            #    partial admission (job-min-parallelism) can admit the Job
            #    with fewer pods when the queue is tight
            #  - GPU slice roles are one Job per slice; Kueue has no partial
            #    admission for JobSet children, so the floor rides
            #    tpx.sh/min-replicas for external autoscalers AND is injected
            #    as TPX_MIN_REPLICAS so in-job bootstrap logic knows how far
            #    the world may legally shrink on restart
            annotations = {ANNOTATION_MIN_REPLICAS: str(role.min_replicas)}
            if not gpu:
                annotations["kueue.x-k8s.io/job-min-parallelism"] = str(
                    role.min_replicas
                )
            rj["template"]["metadata"] = {"annotations": annotations}
            container = pod_template["spec"]["containers"][0]
            container["env"].insert(
                0,
                {
                    "name": settings.ENV_TPX_MIN_REPLICAS,
                    "value": str(role.min_replicas),
                },
            )
        replicated_jobs.append(rj)

    jobset_spec: dict[str, Any] = {
        "replicatedJobs": replicated_jobs,
        "successPolicy": {"operator": "All", "targetReplicatedJobs": []},
    }
    if max_retries > 0:
        jobset_spec["failurePolicy"] = {"maxRestarts": max_retries}

    metadata: dict[str, Any] = {
        "name": app_name,
        "namespace": namespace,
        "labels": {LABEL_APP_NAME: app_name},
    }
    if queue:
        metadata.setdefault("labels", {})["kueue.x-k8s.io/queue-name"] = queue
        jobset_spec["suspend"] = True  # Kueue admits by unsuspending

    resource = {
        "apiVersion": f"{JOBSET_GROUP}/{JOBSET_VERSION}",
        "kind": "JobSet",
        "metadata": metadata,
        "spec": jobset_spec,
    }

    # per-role raw-request overlays (reference :164-192)
    for role in app.roles:
        overlay = get_overlay(role, "gke")
        if overlay:
            resource = apply_overlay(resource, overlay)
    return resource


def resize_jobset(
    jobset: Mapping[str, Any], role_name: str, num_replicas: int
) -> Optional[dict[str, Any]]:
    """Rewrite a live JobSet to a coherent ``num_replicas``-sized world for
    one role; returns a fresh body ready for re-creation, or ``None`` when
    the role is already at the requested size (no restart warranted).

    AppDef units: slices for GPU slice roles, pod replicas for the others.
    Every world-size-derived value is rewritten together (Job replicas or
    parallelism/completions, TPX_NUM_REPLICAS, TPX_NUM_SLICES — and
    args that referenced ``macros.num_replicas`` follow automatically,
    since materialization defers that macro to kubelet ``$(VAR)``
    expansion of these env vars) so the restarted gang agrees on its size
    — the GKE analog of the local scheduler's elastic rebuild, where env
    is re-derived rather than patched piecemeal. Floors declared via the
    ``tpx.sh/min-replicas`` annotation are enforced.
    """
    if num_replicas < 1:
        raise ValueError(f"num_replicas must be >= 1, got {num_replicas}")
    body = copy.deepcopy(dict(jobset))
    # strip server-managed fields so the body is valid for re-creation
    body.pop("status", None)
    meta = body.get("metadata", {})
    for k in ("resourceVersion", "uid", "creationTimestamp", "generation", "managedFields"):
        meta.pop(k, None)

    want = normalize_str(cleanup(role_name))
    for rj in body.get("spec", {}).get("replicatedJobs", []):
        job_spec = rj.get("template", {}).get("spec", {})
        pod_template = job_spec.get("template", {})
        labels = pod_template.get("metadata", {}).get("labels", {})
        if labels.get(LABEL_ROLE_NAME) != want:
            continue
        annotations = rj.get("template", {}).get("metadata", {}).get("annotations", {})
        floor = annotations.get(ANNOTATION_MIN_REPLICAS)
        if floor is not None and num_replicas < int(floor):
            raise ValueError(
                f"cannot resize role {role_name!r} to {num_replicas}:"
                f" below its declared min_replicas floor of {floor}"
            )
        container = pod_template.get("spec", {}).get("containers", [{}])[0]
        # a slice role's pods name their slice (role_to_pod_template); a GPU
        # job of a mixed cluster carries nvidia.com/gpu limits too, but
        # resizes like a CPU role, by pod count
        is_slice = any(
            e.get("name") == settings.ENV_TPX_GPU_ACCELERATOR_TYPE
            for e in container.get("env", [])
        )
        current = (
            int(rj.get("replicas", 1))
            if is_slice
            else int(job_spec.get("parallelism", 1))
        )
        if num_replicas == current:
            return None  # already at the requested size: no restart
        if is_slice:
            # slice units: one child Job per slice; hosts-per-slice fixed
            if num_replicas > int(rj.get("replicas", 1)) and not any(
                e.get("name") == settings.ENV_TPX_SLICE_ID
                for e in container.get("env", [])
            ):
                # a single-slice template carries no slice-id fieldRef
                # decomposition, so pods of a grown set could not derive
                # global replica ids — growth needs a fresh submit
                raise ValueError(
                    f"role {role_name!r} was submitted single-slice; its pod"
                    " template has no multi-slice identity wiring, so it can"
                    " only shrink (resubmit the app to grow)"
                )
            hosts = int(job_spec.get("completions", 1))
            rj["replicas"] = num_replicas
            world = hosts * num_replicas
        else:
            job_spec["parallelism"] = num_replicas
            job_spec["completions"] = num_replicas
            world = num_replicas
        for env in container.get("env", []):
            if env.get("name") == settings.ENV_TPX_NUM_REPLICAS:
                env["value"] = str(world)
            elif env.get("name") == settings.ENV_TPX_NUM_SLICES:
                env["value"] = str(num_replicas)
        break
    else:
        raise ValueError(
            f"role {role_name!r} not found in jobset"
            f" {meta.get('name', '<unnamed>')}"
        )

    if (body.get("metadata", {}).get("labels", {})).get("kueue.x-k8s.io/queue-name"):
        # resubmit suspended: Kueue re-admits when the resized gang fits —
        # this is what makes shrink-to-fit under queue pressure work
        body["spec"]["suspend"] = True
    return body


def plan_elastic_shrink(
    jobset: Mapping[str, Any],
) -> Optional[tuple[str, Optional[int]]]:
    """Decide whether a failing elastic gang should shrink, from the raw
    JobSet dict (pure function -> fixture-testable, like jobset_state).

    Scans roles carrying the ``tpx.sh/min-replicas`` floor annotation for
    failed child Jobs (one child Job == one slice for GPU roles). Returns
    ``(role_name, new_size)`` to shrink to the surviving slice count,
    ``(role_name, None)`` when survivors are below the floor (un-rescuable),
    or ``None`` when nothing relevant failed. CPU roles are left to Kueue's
    ``job-min-parallelism`` — slice-granular shrink is a GPU-gang concern.
    """
    status = jobset.get("status") or {}
    by_name = {
        str(s.get("name")): s for s in status.get("replicatedJobsStatus") or []
    }
    for rj in jobset.get("spec", {}).get("replicatedJobs", []):
        tmpl = rj.get("template", {})
        annotations = tmpl.get("metadata", {}).get("annotations", {}) or {}
        floor = annotations.get(ANNOTATION_MIN_REPLICAS)
        if floor is None:
            continue
        st = by_name.get(str(rj.get("name"))) or {}
        failed = int(st.get("failed") or 0)
        if failed <= 0:
            continue
        pod_labels = (
            tmpl.get("spec", {})
            .get("template", {})
            .get("metadata", {})
            .get("labels", {})
            or {}
        )
        role_name = pod_labels.get(LABEL_ROLE_NAME) or str(rj.get("name"))
        current = int(rj.get("replicas", 1))
        new_size = current - failed
        if new_size < max(1, int(floor)):
            return role_name, None
        return role_name, new_size
    return None


CONTROLLER_SUFFIX = "-tpx-watch"
LABEL_CONTROLLER_FOR = "tpx.sh/controller-for"


def elastic_controller_job(
    app_name: str,
    namespace: str,
    image: str,
    service_account: Optional[str],
    session_name: str,
    max_restarts: int = 3,
) -> dict[str, Any]:
    """In-cluster elastic controller: a plain batch/v1 Job running
    ``tpx-torch watch gke://...`` against its own JobSet, so slice-failure
    shrink (:func:`plan_elastic_shrink` via :meth:`GKEScheduler.resize`)
    keeps working when the operator's terminal is gone — the in-cluster
    analog of the local scheduler's in-process elastic restart.

    Deliberately NOT a child of the JobSet (resize deletes + re-creates
    the set; the controller must survive that) and not owner-referenced;
    it exits when the app reaches a terminal state, GCs itself via
    ``ttlSecondsAfterFinished``, and cancel/delete remove it eagerly.
    The pod authenticates via the mounted ``service_account`` token
    (``load_incluster_config`` fallback in ``_api_client``), which needs
    get/delete/create on jobsets. The shrink budget is process-local: a
    controller pod restart (restartPolicy OnFailure, e.g. after a
    transient apiserver error) starts a fresh budget, and once
    ``backoffLimit`` is spent the app keeps running without elastic
    protection — `tpx-torch watch` client-side remains available as a
    backstop.
    """
    handle = f"gke://{session_name}/{namespace}:{app_name}"
    pod_spec: dict[str, Any] = {
        "restartPolicy": "OnFailure",
        "containers": [
            {
                "name": "tpx-elastic-controller",
                "image": image,
                "command": [
                    "python",
                    "-u",
                    "-m",
                    "torchx_tpu_torch.cli.main",
                    "watch",
                    handle,
                    "--max-restarts",
                    str(max_restarts),
                ],
                # binary units (Mi/Gi), and 1Gi of limit headroom: the
                # watch path imports no torch (the launcher layers are
                # accelerator-free), but role images bundle heavyweight
                # libraries whose import-time cost we don't control, and
                # an OOMKill loop here burns backoffLimit until elastic
                # protection silently lapses — describe() surfaces that
                # state, the headroom avoids it
                "resources": {
                    "limits": {"cpu": "250m", "memory": "1Gi"},
                    "requests": {"cpu": "100m", "memory": "256Mi"},
                },
            }
        ],
    }
    if service_account:
        pod_spec["serviceAccountName"] = service_account
    return {
        "apiVersion": "batch/v1",
        "kind": "Job",
        "metadata": {
            "name": f"{app_name}{CONTROLLER_SUFFIX}",
            "namespace": namespace,
            "labels": {LABEL_CONTROLLER_FOR: app_name},
        },
        "spec": {
            "backoffLimit": 6,
            # a cleanly-finished app leaves no one to call delete(): let
            # the cluster GC the completed controller Job + pod
            "ttlSecondsAfterFinished": 3600,
            "template": {
                "metadata": {"labels": {LABEL_CONTROLLER_FOR: app_name}},
                "spec": pod_spec,
            },
        },
    }


# =========================================================================
# Scheduler
# =========================================================================


# Feature profile for the preflight analyzer (torchx_tpu_torch.analyze): the most
# capable backend — JobSet multi-role, multi-slice gangs, volume mounts,
# failurePolicy restarts, node-disruption preemption classification, and
# concrete resource requests from cpu/memMB.
CAPABILITIES = SchedulerCapabilities(
    mounts=True,
    multi_role=True,
    multislice=True,
    delete=True,
    resize=True,
    logs=True,
    native_retries=True,
    concrete_resources=True,
    classifies_preemption=True,
    # native event source: kubectl's streaming watch (see
    # GKEScheduler.watch); degrades to the poll adapter without kubectl
    watch=True,
    # pod IPs resolve over cluster DNS; /metricz is scrapeable in-cluster
    metricz_scrape=True,
)


class GKEScheduler(DockerWorkspaceMixin, Scheduler[GKEJob]):
    """Submits AppDefs as JobSets to a GKE (or any JobSet-enabled) cluster."""

    capabilities = CAPABILITIES

    def __init__(
        self,
        session_name: str,
        client: Optional["ApiClient"] = None,
        docker_client: Optional[Any] = None,
    ) -> None:
        super().__init__(docker_client=docker_client, backend="gke", session_name=session_name)
        self._client = client

    # -- k8s clients (deferred import; injectable) -------------------------

    def _api_client(self) -> "ApiClient":
        if self._client is None:
            from kubernetes import client as k8s_client, config as k8s_config

            try:
                k8s_config.load_kube_config()
            except Exception:  # noqa: BLE001 - in-cluster fallback
                k8s_config.load_incluster_config()
            self._client = k8s_client.ApiClient()
        return self._client

    def _custom_objects_api(self):  # noqa: ANN202
        from kubernetes.client import CustomObjectsApi

        return CustomObjectsApi(self._api_client())

    def _core_api(self):  # noqa: ANN202
        from kubernetes.client import CoreV1Api

        return CoreV1Api(self._api_client())

    def _batch_api(self):  # noqa: ANN202
        from kubernetes.client import BatchV1Api

        return BatchV1Api(self._api_client())

    # -- runopts ----------------------------------------------------------

    def run_opts(self) -> runopts:
        return GKEOpts.to_runopts() | self.workspace_opts()

    # -- dryrun / schedule -------------------------------------------------

    def _submit_dryrun(
        self, app: AppDef, cfg: Mapping[str, CfgVal]
    ) -> AppDryRunInfo[GKEJob]:
        opts = GKEOpts.from_cfg(cfg)
        namespace = opts.namespace or "default"  # '' from `-cfg namespace=`
        # 40-char app budget leaves room in the 63-char pod-name cap for a
        # >=8-char role name plus multi-digit job/pod index suffixes
        app_name = sanitize_name(make_unique(app.name), max_len=40)
        images_to_push = self.dryrun_push_images(app, cfg)
        resource = app_to_jobset(
            app,
            app_name,
            namespace=namespace,
            queue=opts.queue,
            service_account=opts.service_account,
        )
        controller: Optional[dict[str, Any]] = None
        if opts.elastic_controller:
            elastic_role = next(
                (r for r in app.roles if r.min_replicas is not None), None
            )
            if elastic_role is None:
                raise ValueError(
                    "elastic_controller=True requires a role with a"
                    " min_replicas floor (e.g. dist.spmd -j min:max)"
                )
            # the role image carries torchx_tpu_torch (its entrypoint is
            # `python -m torchx_tpu_torch.apps...`), so the controller reuses it
            controller = elastic_controller_job(
                app_name,
                namespace=namespace,
                image=elastic_role.image,
                service_account=opts.service_account,
                session_name=self.session_name,
                max_restarts=max(1, elastic_role.max_retries or 3),
            )
        req = GKEJob(
            namespace=namespace,
            resource=resource,
            images_to_push=images_to_push,
            controller=controller,
        )
        return AppDryRunInfo(req)

    def schedule(self, dryrun_info: AppDryRunInfo[GKEJob]) -> str:
        req = dryrun_info.request
        self.push_images(req.images_to_push)
        from kubernetes.client.rest import ApiException

        try:
            resilient_call(
                lambda: self._custom_objects_api().create_namespaced_custom_object(
                    group=JOBSET_GROUP,
                    version=JOBSET_VERSION,
                    namespace=req.namespace,
                    plural=JOBSET_PLURAL,
                    body=req.resource,
                ),
                backend=self.backend,
                op="submit",
                policy=NON_IDEMPOTENT,
            )
        except ApiException as e:
            if e.status == 409:
                raise ValueError(
                    f"jobset {req.resource['metadata']['name']} already exists"
                ) from e
            raise
        app_id = f"{req.namespace}:{req.resource['metadata']['name']}"
        if req.controller is not None:
            # the JobSet is already live: a controller-create failure must
            # not raise (the caller would lose the handle of a running,
            # capacity-consuming app) — degrade to unprotected + loud
            try:
                self._batch_api().create_namespaced_job(
                    namespace=req.namespace, body=req.controller
                )
            except Exception as e:  # noqa: BLE001 - degrade, don't orphan
                logger.error(
                    "%s: elastic controller Job creation failed (%s);"
                    " the app is RUNNING but NOT elastic-protected —"
                    " run `tpx-torch watch gke://%s/%s` client-side as a backstop",
                    app_id,
                    e,
                    self.session_name,
                    app_id,
                )
        return app_id

    # -- monitoring --------------------------------------------------------

    @staticmethod
    def _parse_app_id(app_id: str) -> tuple[str, str]:
        namespace, _, name = app_id.partition(":")
        if not name:
            raise ValueError(f"invalid gke app id {app_id!r}; expected namespace:name")
        return namespace, name

    def watch(self, app_ids=(), interval=None):
        """Native event stream: one ``kubectl get jobsets -w`` subprocess
        per watched namespace (shared by every JobSet in it), with
        terminal lines confirmed through :meth:`describe` so preemption
        classification stays authoritative. Falls back to the generic
        poll scan for namespaces where kubectl cannot be spawned."""
        from torchx_tpu_torch.control.watch import KubectlWatcher

        return KubectlWatcher(self, app_ids, interval=interval)

    def describe(self, app_id: str) -> Optional[DescribeAppResponse]:
        namespace, name = self._parse_app_id(app_id)
        from kubernetes.client.rest import ApiException

        try:
            jobset = resilient_call(
                lambda: self._custom_objects_api().get_namespaced_custom_object(
                    group=JOBSET_GROUP,
                    version=JOBSET_VERSION,
                    namespace=namespace,
                    plural=JOBSET_PLURAL,
                    name=name,
                ),
                backend=self.backend,
                op="describe",
            )
        except ApiException as e:
            if e.status == 404:
                return None
            raise
        resp = describe_jobset(jobset, self._list_pods(namespace, name))
        note = self._controller_health_note(namespace, name)
        if note:
            resp.msg = f"{resp.msg}; {note}" if resp.msg else note
        return resp

    def _controller_health_note(self, namespace: str, name: str) -> str:
        """Non-empty when the in-cluster elastic controller Job has failed
        (backoffLimit exhausted — e.g. an OOMKill loop): from that point
        the app runs WITHOUT elastic protection, which an operator reading
        ``tpx status`` must see rather than discover at the next slice
        failure (advisor r4). Best-effort: no controller Job, no note."""
        try:
            job = self._batch_api().read_namespaced_job(
                name=f"{name}{CONTROLLER_SUFFIX}", namespace=namespace
            )
            status = getattr(job, "status", None)
            conditions = list(getattr(status, "conditions", None) or [])
            for cond in conditions:
                if (
                    getattr(cond, "type", "") == "Failed"
                    and getattr(cond, "status", "") == "True"
                ):
                    reason = getattr(cond, "reason", "") or "Failed"
                    return (
                        "elastic controller FAILED "
                        f"({reason}): slice-failure shrink is no longer "
                        "armed — run `tpx-torch watch` client-side or resubmit"
                    )
        except Exception:  # noqa: BLE001 - health note is best-effort
            return ""
        return ""

    def _list_pods(self, namespace: str, name: str) -> list[dict[str, Any]]:
        try:
            pods = self._core_api().list_namespaced_pod(
                namespace=namespace,
                label_selector=f"jobset.sigs.k8s.io/jobset-name={name}",
            )
            return [p.to_dict() if hasattr(p, "to_dict") else p for p in pods.items]
        except Exception:  # noqa: BLE001 - pod detail is best-effort
            return []

    def list(self) -> list[ListAppResponse]:
        out = []
        jobsets = resilient_call(
            lambda: self._custom_objects_api().list_cluster_custom_object(
                group=JOBSET_GROUP, version=JOBSET_VERSION, plural=JOBSET_PLURAL
            ),
            backend=self.backend,
            op="list",
        )
        for js in jobsets.get("items", []):
            meta = js.get("metadata", {})
            out.append(
                ListAppResponse(
                    app_id=f"{meta.get('namespace')}:{meta.get('name')}",
                    state=jobset_state(js),
                    name=meta.get("name", ""),
                )
            )
        return out

    def _cancel_existing(self, app_id: str) -> None:
        """Suspend (preserves spec + logs) rather than delete (reference
        cancel=abort-preserving-spec, :901-934). The elastic controller
        Job (if any) is removed — a suspended set must not be 'rescued'."""
        namespace, name = self._parse_app_id(app_id)
        resilient_call(
            lambda: self._custom_objects_api().patch_namespaced_custom_object(
                group=JOBSET_GROUP,
                version=JOBSET_VERSION,
                namespace=namespace,
                plural=JOBSET_PLURAL,
                name=name,
                body={"spec": {"suspend": True}},
            ),
            backend=self.backend,
            op="cancel",
        )
        self._delete_controller(namespace, name)

    def _delete_controller(self, namespace: str, name: str) -> None:
        """Remove the in-cluster elastic controller Job, if one exists.

        Best-effort: this runs for EVERY cancel/delete (the scheduler
        can't know whether the app was submitted with a controller), so
        an RBAC denial on batch/v1 must not break cancel/delete of apps
        that never had one."""
        try:
            self._batch_api().delete_namespaced_job(
                name=f"{name}{CONTROLLER_SUFFIX}",
                namespace=namespace,
                propagation_policy="Background",
            )
        except Exception as e:  # noqa: BLE001 - cleanup is advisory
            status = getattr(e, "status", None)
            if status != 404:
                logger.warning(
                    "could not delete elastic controller %s%s in %s: %s",
                    name,
                    CONTROLLER_SUFFIX,
                    namespace,
                    e,
                )

    def delete(self, app_id: str) -> None:
        namespace, name = self._parse_app_id(app_id)
        from kubernetes.client.rest import ApiException

        try:
            resilient_call(
                lambda: self._custom_objects_api().delete_namespaced_custom_object(
                    group=JOBSET_GROUP,
                    version=JOBSET_VERSION,
                    namespace=namespace,
                    plural=JOBSET_PLURAL,
                    name=name,
                ),
                backend=self.backend,
                op="delete",
            )
        except ApiException as e:
            if e.status != 404:
                raise
        self._delete_controller(namespace, name)

    # seconds between deletion polls during resize (tests set this to 0)
    resize_poll_interval: float = 1.0

    def resize(self, app_id: str, role_name: str, num_replicas: int) -> None:
        """Resize one role's gang by replace: JobSet pod templates are
        immutable and a JobSet-level restart would reuse the stale world
        env, so the resize primitive is delete + re-create of the rewritten
        set under the same name. With a Kueue queue the new set goes back
        suspended and Kueue re-admits when the resized gang fits; user code
        resumes from its checkpoint (warm compile cache makes the restart
        cheap — docs/performance.md)."""
        namespace, name = self._parse_app_id(app_id)
        from kubernetes.client.rest import ApiException

        api = self._custom_objects_api()
        common = dict(
            group=JOBSET_GROUP,
            version=JOBSET_VERSION,
            namespace=namespace,
            plural=JOBSET_PLURAL,
            name=name,
        )
        try:
            jobset = api.get_namespaced_custom_object(**common)
        except ApiException as e:
            if e.status == 404:
                raise ValueError(f"app {app_id} does not exist") from e
            raise
        body = resize_jobset(jobset, role_name, num_replicas)
        if body is None:
            logger.info(
                "%s role %s is already %d wide; not restarting the gang",
                app_id,
                role_name,
                num_replicas,
            )
            return
        # Rescue the rewritten body to disk BEFORE the delete: the
        # delete/poll/create window is up to 120 polls long, and if this
        # process dies inside it the app would otherwise be gone with
        # nothing to resubmit. `kubectl apply -f <path>` recovers.
        rescue_path = self._write_resize_rescue(name, body)
        logger.info(
            "resize %s: rewritten body saved to %s (kubectl apply -f it"
            " if this process dies mid-resize)",
            app_id,
            rescue_path,
        )
        # foreground propagation: the JobSet object only 404s once its
        # child Jobs/pods are gone too, so the poll below doubles as
        # waiting for the old gang's GPU capacity to actually free up
        api.delete_namespaced_custom_object(
            **common, propagation_policy="Foreground"
        )
        for _ in range(120):
            try:
                api.get_namespaced_custom_object(**common)
            except ApiException as e:
                if e.status == 404:
                    break
                raise
            time.sleep(self.resize_poll_interval)
        else:
            raise RuntimeError(
                f"jobset {name} was not deleted in time; resize aborted"
                f" before re-creation (re-run once the deletion finishes,"
                f" or `kubectl apply -f {rescue_path}`)"
            )
        try:
            api.create_namespaced_custom_object(
                group=JOBSET_GROUP,
                version=JOBSET_VERSION,
                namespace=namespace,
                plural=JOBSET_PLURAL,
                body=body,
            )
        except Exception:
            # the old set is gone; the pre-delete rescue file is the
            # operator's path to resubmission
            logger.error(
                "re-creation of jobset %s failed AFTER deletion; the"
                " resized body was saved to %s — fix the rejection and"
                " `kubectl apply -f` it",
                name,
                rescue_path,
            )
            raise
        else:
            try:
                os.unlink(rescue_path)
            except OSError:
                pass

    @staticmethod
    def _write_resize_rescue(name: str, body: dict) -> str:
        import tempfile

        fd, path = tempfile.mkstemp(prefix=f"tpx-resize-{name}-", suffix=".json")
        with open(fd, "w") as f:
            json.dump(body, f, indent=2, default=str)
        return path

    def watch_elastic(
        self,
        app_id: str,
        poll_interval: float = 10.0,
        timeout: Optional[float] = None,
        max_restarts: int = 3,
    ) -> int:
        """Failure-driven elastic controller: the GKE analog of the local
        scheduler's ``_try_elastic_restart`` (local_scheduler.py), run
        operator-side because JobSet has no in-cluster shrink semantics.

        Polls the JobSet; when a slice of a role carrying the
        ``tpx.sh/min-replicas`` floor fails, shrinks the gang to the
        surviving slice count via :meth:`resize` (delete + re-create; user
        code resumes from its checkpoint exactly as with the manual
        ``resize`` verb — under Kueue the resized set re-enters the queue
        suspended). Returns the number of shrink-restarts performed.
        Stops on: terminal app state, survivors below the floor, restart
        budget exhausted, or ``timeout`` seconds elapsed.
        """
        namespace, name = self._parse_app_id(app_id)
        from kubernetes.client.rest import ApiException

        api = self._custom_objects_api()
        deadline = time.monotonic() + timeout if timeout else None
        restarts = 0
        while True:
            try:
                jobset = api.get_namespaced_custom_object(
                    group=JOBSET_GROUP,
                    version=JOBSET_VERSION,
                    namespace=namespace,
                    plural=JOBSET_PLURAL,
                    name=name,
                )
            except ApiException as e:
                if e.status == 404:
                    return restarts  # deleted out from under the watcher
                raise
            state = jobset_state(jobset)
            plan = plan_elastic_shrink(jobset)
            if plan is not None:
                role_name, new_size = plan
                if new_size is None:
                    logger.error(
                        "%s role %s: survivors below the min-replicas floor;"
                        " not rescuable by shrinking",
                        app_id,
                        role_name,
                    )
                    return restarts
                if restarts >= max_restarts:
                    logger.error(
                        "%s: shrink budget (%d) exhausted", app_id, max_restarts
                    )
                    return restarts
                logger.info(
                    "%s role %s: slice failure detected; shrinking to %d",
                    app_id,
                    role_name,
                    new_size,
                )
                self.resize(app_id, role_name, new_size)
                restarts += 1
            elif is_terminal(state):
                return restarts
            if deadline is not None and time.monotonic() >= deadline:
                return restarts
            time.sleep(poll_interval)

    supports_log_windows = True  # since via since_seconds, until via stamps

    def log_iter(
        self,
        app_id: str,
        role_name: str,
        k: int = 0,
        regex: Optional[str] = None,
        since: Optional[float] = None,
        until: Optional[float] = None,
        should_tail: bool = False,
        streams: Optional[Stream] = None,
    ) -> Iterable[str]:
        """Pod logs with real window fidelity: ``since`` maps to the API's
        ``since_seconds``, ``until`` is applied client-side from kubelet
        RFC3339 line stamps (``timestamps=True``; stamps are stripped
        before yielding so output is byte-identical to the unwindowed
        path), and stdout/stderr selection raises — the kubelet keeps one
        combined stream per container (reference analog:
        kubernetes_scheduler.py:1025-1045)."""
        if streams not in (None, Stream.COMBINED):
            raise ValueError(
                f"kubernetes pod logs are a single combined stream;"
                f" selecting {streams} is not supported on gke"
            )
        namespace, name = self._parse_app_id(app_id)
        pod_name = self._resolve_pod_name(namespace, name, role_name, k)
        core = self._core_api()
        kwargs: dict[str, Any] = {}
        if since is not None:
            age = time.time() - since
            if age <= 0:
                return iter(())  # window entirely in the future: nothing
            # ceil keeps the window inclusive (int() would start it up to
            # 1s late and drop in-window lines)
            kwargs["since_seconds"] = max(1, math.ceil(age))
        if until is not None:
            kwargs["timestamps"] = True
        resp = core.read_namespaced_pod_log(
            name=pod_name,
            namespace=namespace,
            follow=should_tail,
            _preload_content=False,
            **kwargs,
        )
        lines = (ln.decode("utf-8", errors="replace").rstrip("\n") for ln in resp)
        if until is not None:
            lines = _strip_until(lines, until)
        if regex:
            lines = filter_regex(regex, lines)
        return lines

    def _resolve_pod_name(
        self, namespace: str, name: str, role_name: str, k: int
    ) -> str:
        """Job-created pods carry a random suffix, so the name cannot be
        computed — resolve replica ``k`` by listing the jobset's pods for
        the role and ordering by (job index, completion index); across
        multi-slice jobs ``k`` counts hosts globally."""
        # select by our own role label, not the replicatedJob name: that
        # name is budget-truncated against the 63-char pod cap inside
        # app_to_jobset and cannot be recomputed from role_name alone
        pods = self._core_api().list_namespaced_pod(
            namespace=namespace,
            label_selector=(
                f"jobset.sigs.k8s.io/jobset-name={name},"
                f"{LABEL_ROLE_NAME}={normalize_str(cleanup(role_name))}"
            ),
        )
        indexed: list[tuple[int, int, str]] = []
        for pod in pods.items:
            meta = pod.metadata
            labels = meta.labels or {}
            annotations = meta.annotations or {}
            job_index = int(labels.get("jobset.sigs.k8s.io/job-index", 0))
            completion_index = int(
                annotations.get("batch.kubernetes.io/job-completion-index", 0)
            )
            indexed.append((job_index, completion_index, meta.name))
        indexed.sort()
        if k >= len(indexed):
            raise ValueError(
                f"replica {k} of role {role_name} not found"
                f" ({len(indexed)} pods exist for jobset {name})"
            )
        return indexed[k][2]


def _strip_until(lines: Iterable[str], until: float) -> Iterator[str]:
    """Drop lines stamped after ``until`` and strip the kubelet RFC3339
    timestamp prefix from the rest. Unstamped lines (shouldn't happen with
    ``timestamps=True``, but be permissive) pass through whole."""
    from datetime import datetime

    for line in lines:
        stamp, _, payload = line.partition(" ")
        try:
            # kubelet stamps are RFC3339Nano with trailing zeros trimmed
            # (Go time formatting); Python 3.10's fromisoformat accepts
            # only 3 or 6 fractional digits, so normalize to exactly 6
            norm = re.sub(
                r"\.(\d+)",
                lambda m: "." + (m.group(1) + "000000")[:6],
                stamp.replace("Z", "+00:00"),
            )
            ts = datetime.fromisoformat(norm).timestamp()
        except ValueError:
            yield line
            continue
        if ts > until:
            return
        yield payload


# =========================================================================
# Status mapping (pure functions over dicts -> fixture-testable)
# =========================================================================


def jobset_state(jobset: Mapping[str, Any]) -> AppState:
    status = jobset.get("status") or {}
    conditions = status.get("conditions") or []
    for cond in reversed(conditions):
        if cond.get("status") == "True" and cond.get("type") in JOBSET_STATE_MAP:
            return JOBSET_STATE_MAP[cond["type"]]
    if jobset.get("spec", {}).get("suspend"):
        return AppState.PENDING
    if status.get("replicatedJobsStatus"):
        return AppState.RUNNING
    return AppState.PENDING if status else AppState.SUBMITTED


# Pod DisruptionTarget reasons that mean the NODE (not the app) ended the
# pod: spot/preemptible reclaim, node drain, taint eviction, shutdown.
# Any DisruptionTarget=True condition is infra-initiated; the reason set
# here is what GKE emits for spot GPU node reclaim and the maintenance
# drains of GPU node pools (host maintenance evicts, it cannot live-migrate
# a GPU VM).
_DISRUPTION_REASONS = frozenset(
    {
        "PreemptionByScheduler",
        "PreemptionByKubeScheduler",
        "TerminationByKubelet",
        "DeletionByTaintManager",
        "EvictionByEvictionAPI",
        "NodeShutdown",
    }
)


def _pod_disruption_reason(pods: Iterable[Mapping[str, Any]]) -> Optional[str]:
    """First node-disruption condition found across the app's pods, or None.

    GKE marks pods killed by spot reclaim / node drain with a
    ``DisruptionTarget`` condition (status=True); the reason distinguishes
    scheduler preemption from kubelet/node-shutdown termination. Pod dicts
    come from the k8s client's ``to_dict()`` (snake_case) or raw watch
    events (camelCase); both shapes are read."""
    for pod in pods:
        status = pod.get("status") or {}
        for cond in status.get("conditions") or []:
            if cond.get("type") != "DisruptionTarget":
                continue
            if str(cond.get("status")) != "True":
                continue
            return str(cond.get("reason") or "DisruptionTarget")
    return None


def classify_jobset_failure(
    jobset: Mapping[str, Any], pods: list[Mapping[str, Any]]
) -> tuple[AppState, Optional[FailureClass], str]:
    """-> (state, failure_class, note) for a FAILED JobSet.

    A JobSet reports Failed for both "the container exited 1" and "the
    spot node under it vanished"; the retry decision needs them apart.
    Node-disruption pod conditions (and preemption-shaped Failed-condition
    messages) reclassify to PREEMPTED/PREEMPTION; everything else stays
    FAILED with the conservative APP class."""
    reason = _pod_disruption_reason(pods)
    if reason is not None:
        return (
            AppState.PREEMPTED,
            FailureClass.PREEMPTION,
            f"node disruption: {reason}",
        )
    for cond in (jobset.get("status") or {}).get("conditions") or []:
        if cond.get("type") == "Failed" and cond.get("status") == "True":
            text = f"{cond.get('reason', '')} {cond.get('message', '')}"
            if re.search(r"preempt|node (was )?(deleted|shut ?down)|spot", text, re.I):
                return AppState.PREEMPTED, FailureClass.PREEMPTION, text.strip()
    return AppState.FAILED, FailureClass.APP, ""


def _role_completions(jobset: Mapping[str, Any]) -> dict[str, int]:
    """replicatedJob name -> completions (hosts per slice), from the spec."""
    out: dict[str, int] = {}
    for rj in (jobset.get("spec") or {}).get("replicatedJobs") or []:
        name = rj.get("name")
        spec = ((rj.get("template") or {}).get("spec")) or {}
        if name:
            out[str(name)] = _safe_int(spec.get("completions"), 1) or 1
    return out


def describe_jobset(
    jobset: Mapping[str, Any], pods: list[Mapping[str, Any]]
) -> DescribeAppResponse:
    state = jobset_state(jobset)
    failure_class: Optional[FailureClass] = None
    failure_note = ""
    if state == AppState.FAILED:
        state, failure_class, failure_note = classify_jobset_failure(jobset, pods)
    status = jobset.get("status") or {}
    completions = _role_completions(jobset)
    roles: dict[str, RoleStatus] = {}
    for pod in pods:
        meta = pod.get("metadata") or {}
        labels = meta.get("labels") or {}
        role = labels.get(LABEL_ROLE_NAME) or labels.get(
            "jobset.sigs.k8s.io/replicatedjob-name", "unknown"
        )
        # completions are keyed by replicatedJob name in the spec, which can
        # be a budget-truncated variant of the display role name — look up
        # via the pod's jobset-controller label, not the display name
        rj_name = labels.get("jobset.sigs.k8s.io/replicatedjob-name", str(role))
        annotations = meta.get("annotations") or {}
        host_idx = _safe_int(
            annotations.get("batch.kubernetes.io/job-completion-index")
        )
        # multi-slice: two slices' pods share completion indexes; the global
        # replica id folds in the JobSet job index (slice) when present
        slice_idx = _safe_int(
            labels.get("jobset.sigs.k8s.io/job-index")
            or annotations.get("jobset.sigs.k8s.io/job-index")
        )
        idx = slice_idx * completions.get(rj_name, 1) + host_idx
        phase = ((pod.get("status") or {}).get("phase")) or "Unknown"
        pod_ip = (pod.get("status") or {}).get("pod_ip") or (
            pod.get("status") or {}
        ).get("podIP", "")
        roles.setdefault(role, RoleStatus(role=role)).replicas.append(
            ReplicaStatus(
                id=idx,
                state=POD_STATE_MAP.get(phase, AppState.UNKNOWN),
                role=role,
                hostname=pod_ip or meta.get("name", ""),
            )
        )
    for rs in roles.values():
        rs.replicas.sort(key=lambda r: r.id)
    restarts = _safe_int(status.get("restarts"))
    return DescribeAppResponse(
        app_id=f"{jobset.get('metadata', {}).get('namespace')}:"
        f"{jobset.get('metadata', {}).get('name')}",
        state=state,
        num_restarts=restarts,
        msg=failure_note,
        roles_statuses=sorted(roles.values(), key=lambda r: r.role),
        failure_class=failure_class,
    )


def create_scheduler(session_name: str, **kwargs: Any) -> GKEScheduler:
    known = {"client", "docker_client"}
    return GKEScheduler(
        session_name=session_name,
        **{k: v for k, v in kwargs.items() if k in known},
    )
