"""Vertex AI custom-training scheduler: managed GPU training jobs.

The port's copy of :mod:`torchx_tpu.schedulers.vertex_scheduler`, on A3
GPU machines in place of TPU machines. The managed-training backend analog
of the reference's SageMaker scheduler
(torchx/schedulers/aws_sagemaker_scheduler.py:407-421 submits a
``CreateTrainingJob`` request materialized from the AppDef) — re-thought
for GCP: an AppDef materializes into a Vertex AI ``CustomJob`` whose
worker pools carry GPU ``machineSpec``s (``a3-highgpu-{n}g`` with
``acceleratorType`` ``NVIDIA_H100_80GB`` x ``n``), submitted through
``google-cloud-aiplatform``.

Design notes:
- A GPU role of ``h`` hosts is worker pool 0 with one replica and, for
  ``h > 1``, a second pool of ``h - 1`` replicas (Vertex's first pool takes
  exactly one replica). A TPU slice had its per-host identity from the TPU
  runtime, which the port does not read; here each container starts with a
  ``/bin/sh -c`` prelude (like gcp_batch's bootstrap) that exports
  ``TPX_REPLICA_ID`` and ``TPX_COORDINATOR_HOST`` from Vertex's
  ``CLUSTER_SPEC``: the first pool's replica is replica 0, the second
  pool's index ``i`` is ``i + 1``, and the coordinator is the first pool's
  host. Vertex takes at most four pools.
- Everything up to ``schedule()`` is pure materialization: ``dryrun``
  produces the complete CustomJob dict and is fully testable without the
  google-cloud-aiplatform SDK or a GCP project.
- The SDK import is deferred and the client injectable, mirroring the
  docker/gke schedulers' testability contract.
"""

from __future__ import annotations

import json
import logging
import os
from dataclasses import dataclass, field
from typing import Any, Iterable, Mapping, Optional

from torchx_tpu_torch import settings
from torchx_tpu_torch.resilience.call import resilient_call
from torchx_tpu_torch.resilience.policy import NON_IDEMPOTENT
from torchx_tpu_torch.schedulers.api import (
    DescribeAppResponse,
    ListAppResponse,
    Scheduler,
    SchedulerCapabilities,
    Stream,
    filter_regex,
    dquote as _dquote,
    rfc3339 as _rfc3339,
)
from torchx_tpu_torch.schedulers.ids import make_unique
from torchx_tpu_torch.specs.api import (
    AppDef,
    AppDryRunInfo,
    AppState,
    CfgVal,
    GPU_GENERATIONS,
    ReplicaStatus,
    Role,
    RoleStatus,
    macros,
    runopts,
)
from torchx_tpu_torch.workspace.docker_workspace import DockerWorkspaceMixin

logger = logging.getLogger(__name__)

#: Worker pools a CustomJob may have (Vertex AI's ``workerPoolSpecs``).
MAX_WORKER_POOLS = 4

# Vertex JobState -> AppState (JOB_STATE_* enum names / numbers)
VERTEX_STATE_MAP = {
    "JOB_STATE_QUEUED": AppState.PENDING,
    "JOB_STATE_PENDING": AppState.PENDING,
    "JOB_STATE_RUNNING": AppState.RUNNING,
    "JOB_STATE_SUCCEEDED": AppState.SUCCEEDED,
    "JOB_STATE_FAILED": AppState.FAILED,
    "JOB_STATE_CANCELLING": AppState.CANCELLED,
    "JOB_STATE_CANCELLED": AppState.CANCELLED,
    "JOB_STATE_PAUSED": AppState.PENDING,
    "JOB_STATE_EXPIRED": AppState.FAILED,
}

LABEL_APP_NAME = "tpx-app-name"
LABEL_SESSION = "tpx-session"

VERTEX_JOBS_FILE = ".tpx_torch_vertex_jobs"


def gpu_machine_spec(role: Role) -> dict[str, Any]:
    """One host of the role's GPU slice: its A3 machine type
    (``GpuSlice.machine_type``) and its cards under Vertex's accelerator
    name."""
    gpu = role.resource.gpu
    return {
        "machineType": gpu.machine_type,
        "acceleratorType": GPU_GENERATIONS[gpu.accelerator]["vertex_accelerator"],
        "acceleratorCount": gpu.gpus_per_host,
    }


def cpu_machine_spec(role: Role) -> dict[str, Any]:
    """Machine spec for roles without a GPU slice: an explicit ``gce.machine_type``
    capability wins (heterogeneous-fleet catalog, named_resources_gcp);
    GPU roles add acceleratorType/Count from the devices dict; otherwise
    the smallest n2-standard covering the cpu/mem ask."""
    caps = role.resource.capabilities
    gpus = int(role.resource.devices.get("nvidia.com/gpu", 0))
    machine = caps.get("gce.machine_type")
    if machine is None:
        cpu = max(1, int(role.resource.cpu or 1))
        mem_gb = max(1, (int(role.resource.memMB or 0) + 1023) // 1024)
        machine = "n2-standard-128"
        for vcpus in (2, 4, 8, 16, 32, 48, 64, 80, 96, 128):
            if vcpus >= cpu and vcpus * 4 >= mem_gb:  # n2-standard: 4 GB/vCPU
                machine = f"n2-standard-{vcpus}"
                break
    spec: dict[str, Any] = {"machineType": str(machine)}
    if gpus:
        # Vertex accelerator enums are UPPER_SNAKE of the GKE label
        accel = str(caps.get("gke.accelerator", "nvidia-tesla-t4"))
        spec["acceleratorType"] = accel.upper().replace("-", "_")
        spec["acceleratorCount"] = gpus
    return spec


def _pool_count(role: Role) -> int:
    """Worker pools a role takes: two for a GPU slice of several hosts (a
    one-replica pool, then the other hosts), else one."""
    gpu = role.resource.gpu
    return 2 if gpu is not None and gpu.hosts > 1 else 1


def _identity_prelude(first_pool: int) -> list[str]:
    """Shell lines exporting a GPU replica's ``TPX_REPLICA_ID`` and
    ``TPX_COORDINATOR_HOST`` from Vertex's ``CLUSTER_SPEC`` (``task.type``
    ``workerpool<k>``, ``task.index``, ``cluster.workerpool0``): the role's
    first pool (``first_pool``) holds replica 0, its second pool's index
    ``i`` is replica ``i + 1``, and the coordinator is the job's first
    pool's host, as every other backend puts it on role 0's replica 0.
    Without ``CLUSTER_SPEC`` (a one-replica job) the replica is 0 on
    localhost."""
    replica = (
        "import json, os; t = json.loads(os.environ.get('CLUSTER_SPEC') or '{}')"
        ".get('task') or {}; print(int(t.get('index', 0))"
        f" + int(t.get('type', '') == 'workerpool{first_pool + 1}'))"
    )
    coordinator = (
        "import json, os; c = json.loads(os.environ.get('CLUSTER_SPEC') or '{}')"
        ".get('cluster') or {}; print((c.get('workerpool0') or ['localhost'])[0]"
        ".rsplit(':', 1)[0])"
    )
    return [
        f'export {settings.ENV_TPX_REPLICA_ID}="$(python3 -c "{replica}")"',
        f'export {settings.ENV_TPX_COORDINATOR_HOST}="$(python3 -c "{coordinator}")"',
    ]


def role_to_worker_pools(role: Role, app_name: str, first_pool: int = 0) -> list[dict[str, Any]]:
    """One role -> its worker pools (``first_pool`` is the index its first
    pool takes in the job). A CPU role is one pool of ``num_replicas``; a GPU
    role of ``h`` hosts is one pool of one replica plus, for ``h > 1``, one
    of ``h - 1``, every container starting with the identity prelude."""
    gpu = role.resource.gpu
    values = macros.Values(
        img_root="",
        app_id=app_name,
        # a CPU role's replicas share one spec; a GPU replica's id is the
        # prelude's export, expanded by the shell
        replica_id=f"${settings.ENV_TPX_REPLICA_ID}" if gpu else "0",
        num_replicas=str(role.num_replicas),
        coordinator_env=settings.ENV_TPX_COORDINATOR_HOST,
    )
    srole = values.apply(role)
    env = [
        {"name": settings.ENV_TPX_APP_ID, "value": app_name},
        {"name": settings.ENV_TPX_ROLE_NAME, "value": role.name},
        {
            "name": settings.ENV_TPX_NUM_REPLICAS,
            "value": str(gpu.hosts if gpu else role.num_replicas),
        },
        {"name": settings.ENV_TPX_ERROR_FILE, "value": "/tmp/tpx_error.json"},
        *({"name": k, "value": v} for k, v in srole.env.items()),
    ]
    if gpu is None:
        return [{
            "machineSpec": cpu_machine_spec(role),
            "replicaCount": role.num_replicas,
            "containerSpec": {
                "imageUri": srole.image,
                "command": [srole.entrypoint],
                "args": list(srole.args),
                "env": env,
            },
        }]
    env[3:3] = [
        {"name": settings.ENV_TPX_GPU_ACCELERATOR_TYPE, "value": gpu.accelerator_type},
        {"name": settings.ENV_TPX_GPU_TOPOLOGY, "value": gpu.default_topology()},
    ]
    cmd = " ".join(_dquote(a) for a in [srole.entrypoint, *srole.args])
    script = "\n".join([*_identity_prelude(first_pool), f"exec {cmd}"])
    return [
        {
            "machineSpec": gpu_machine_spec(role),
            "replicaCount": count,
            "containerSpec": {
                "imageUri": srole.image,
                "command": ["/bin/sh", "-c", script],
                "args": [],
                "env": env,
            },
        }
        for count in ([1, gpu.hosts - 1] if gpu.hosts > 1 else [1])
    ]


def app_to_custom_job(
    app: AppDef,
    app_name: str,
    session_name: str,
    service_account: Optional[str] = None,
    network: Optional[str] = None,
    staging_bucket: Optional[str] = None,
) -> dict[str, Any]:
    """AppDef -> Vertex AI CustomJob resource dict (pure, dryrun-testable)."""
    pools: list[dict[str, Any]] = []
    for role in app.roles:
        pools += role_to_worker_pools(role, app_name, first_pool=len(pools))
    job_spec: dict[str, Any] = {"workerPoolSpecs": pools}
    if service_account:
        job_spec["serviceAccount"] = service_account
    if network:
        job_spec["network"] = network
    if staging_bucket:
        job_spec["baseOutputDirectory"] = {"outputUriPrefix": staging_bucket}
    from torchx_tpu_torch.specs.api import RetryPolicy

    # Vertex restarts the whole job on worker failure when enabled — that
    # matches APPLICATION/ROLE (gang) retry semantics only; REPLICA-scoped
    # retries must NOT trigger a whole-job restart (the same contract the
    # local scheduler enforces)
    if any(
        r.max_retries > 0 and r.retry_policy != RetryPolicy.REPLICA
        for r in app.roles
    ):
        job_spec["scheduling"] = {"restartJobOnWorkerRestart": True}
    return {
        "displayName": app_name,
        "jobSpec": job_spec,
        "labels": {LABEL_APP_NAME: app_name, LABEL_SESSION: session_name},
    }


@dataclass
class VertexJob:
    """Materialized request: CustomJob dict + where to create it."""

    project: str
    region: str
    custom_job: dict[str, Any]
    images_to_push: dict[str, tuple[str, str]] = field(default_factory=dict)

    def __str__(self) -> str:
        return json.dumps(self.custom_job, indent=2, default=str)

    @property
    def parent(self) -> str:
        return f"projects/{self.project}/locations/{self.region}"


# Feature profile for the preflight analyzer (torchx_tpu_torch.analyze): worker
# pools map multi-role apps and machine specs are concrete, but CustomJobs
# have no mounts, no delete()/resize(), and a GPU role is limited to a
# single slice (num_replicas == 1).
CAPABILITIES = SchedulerCapabilities(
    mounts=False,
    multi_role=True,
    multislice=False,
    delete=False,
    resize=False,
    logs=True,
    native_retries=True,
    concrete_resources=True,
    classifies_preemption=False,
)


class VertexScheduler(DockerWorkspaceMixin, Scheduler[VertexJob]):
    """Submits AppDefs as Vertex AI CustomJobs (managed GPU training)."""

    capabilities = CAPABILITIES

    # since/until become server-side Cloud Logging timestamp filters
    supports_log_windows = True

    def __init__(
        self,
        session_name: str,
        client: Optional[Any] = None,
        docker_client: Optional[Any] = None,
    ) -> None:
        super().__init__(
            docker_client=docker_client,
            backend="vertex",
            session_name=session_name,
        )
        self.__client = client

    def _run_cmd(self, cmd: list, **kwargs: Any) -> Any:
        """Raw gcloud seam (monkeypatched in tests); production calls go
        through :meth:`Scheduler._cmd` for deadlines/retries/breakers."""
        import subprocess

        return subprocess.run(cmd, capture_output=True, text=True, **kwargs)

    @property
    def _client(self) -> Any:
        if self.__client is None:
            try:
                from google.cloud import aiplatform_v1
            except ImportError as e:
                raise ModuleNotFoundError(
                    "the vertex scheduler needs google-cloud-aiplatform:"
                    " pip install google-cloud-aiplatform"
                ) from e
            self.__client = aiplatform_v1.JobServiceClient()
        return self.__client

    def run_opts(self) -> runopts:
        opts = super().workspace_opts()
        opts.add("project", type_=str, required=True, help="GCP project id")
        opts.add(
            "region", type_=str, default="us-central1", help="Vertex AI region"
        )
        opts.add(
            "service_account",
            type_=str,
            default=None,
            help="service account email the job runs as",
        )
        opts.add(
            "network",
            type_=str,
            default=None,
            help="full VPC network name for private connectivity",
        )
        opts.add(
            "staging_bucket",
            type_=str,
            default=None,
            help="gs:// prefix for job outputs (baseOutputDirectory)",
        )
        return opts

    def _validate(self, app: AppDef, cfg: Mapping[str, CfgVal]) -> None:
        for role in app.roles:
            gpu = role.resource.gpu if role.resource is not None else None
            if gpu is not None and role.num_replicas > 1:
                raise ValueError(
                    "Vertex AI custom jobs run ONE slice per GPU role"
                    " (no multi-slice support); use the gke scheduler"
                    f" for multi-slice (role {role.name!r} asks for"
                    f" {role.num_replicas} slices)"
                )
        pools = sum(_pool_count(r) for r in app.roles)
        if pools > MAX_WORKER_POOLS:
            raise ValueError(
                f"app {app.name!r} needs {pools} worker pools (a GPU role of"
                " several hosts takes two), and a Vertex AI custom job takes at"
                f" most {MAX_WORKER_POOLS}; use the gke scheduler"
            )

    def _submit_dryrun(
        self, app: AppDef, cfg: Mapping[str, CfgVal]
    ) -> AppDryRunInfo[VertexJob]:
        # Scheduler.submit() does not route through the Runner's _validate
        # call, so enforce the backend constraints here
        self._validate(app, cfg)
        app_name = make_unique(app.name)
        req = VertexJob(
            project=str(cfg.get("project")),
            region=str(cfg.get("region") or "us-central1"),
            custom_job=app_to_custom_job(
                app,
                app_name,
                self.session_name,
                service_account=cfg.get("service_account"),  # type: ignore[arg-type]
                network=cfg.get("network"),  # type: ignore[arg-type]
                staging_bucket=cfg.get("staging_bucket"),  # type: ignore[arg-type]
            ),
        )
        req.images_to_push = self.dryrun_push_images(app, dict(cfg))
        # role images may have been re-pointed at pushed tags after the
        # worker pools were materialized — re-point the pool specs too
        pool_roles = [r for r in app.roles for _ in range(_pool_count(r))]
        for pool, role in zip(req.custom_job["jobSpec"]["workerPoolSpecs"], pool_roles):
            pool["containerSpec"]["imageUri"] = role.image
        return AppDryRunInfo(req, fmt=lambda r: str(r))

    def schedule(self, dryrun_info: AppDryRunInfo[VertexJob]) -> str:
        req = dryrun_info.request
        self.push_images(req.images_to_push)
        job = resilient_call(
            lambda: self._client.create_custom_job(
                parent=req.parent, custom_job=req.custom_job
            ),
            backend=self.backend,
            op="submit",
            policy=NON_IDEMPOTENT,
        )
        # resource name: projects/{p}/locations/{r}/customJobs/{numeric id}
        name = getattr(job, "name", "") or ""
        app_id = req.custom_job["displayName"]
        _save_job_name(app_id, name)
        return app_id

    # -- monitoring --------------------------------------------------------

    def describe(self, app_id: str) -> Optional[DescribeAppResponse]:
        name = _load_job_name(app_id)
        if name is None:
            return None
        try:
            job = resilient_call(
                lambda: self._client.get_custom_job(name=name),
                backend=self.backend,
                op="describe",
            )
        except Exception as e:
            # only a definitive NotFound maps to "no such app"; transport
            # or auth errors must surface so status pollers don't mistake a
            # live job for a deleted one (matched by name: the google SDK
            # is an optional dependency)
            if type(e).__name__ == "NotFound":
                return None
            raise
        return describe_custom_job(app_id, _job_to_dict(job))

    def list(self) -> list[ListAppResponse]:
        raise NotImplementedError(
            "vertex scheduler list() needs a project/region-scoped query;"
            " use `gcloud ai custom-jobs list` or describe(app_id)"
        )

    def _cancel_existing(self, app_id: str) -> None:
        name = _load_job_name(app_id)
        if name is not None:
            resilient_call(
                lambda: self._client.cancel_custom_job(name=name),
                backend=self.backend,
                op="cancel",
            )

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
        """Worker logs land in Cloud Logging; fetched via gcloud so the
        scheduler needs no logging SDK (same pattern as gcp_batch's logs).
        since/until map to server-side ``timestamp`` filters; Vertex keeps
        one combined stream per job, so stream selection raises."""
        if streams not in (None, Stream.COMBINED):
            raise ValueError(
                f"vertex job logs are a single combined Cloud Logging"
                f" stream; selecting {streams} is not supported"
            )
        name = _load_job_name(app_id)
        if name is None:
            raise ValueError(f"unknown app: {app_id}")
        # name = projects/{project}/locations/{region}/customJobs/{id}:
        # scope the query to the JOB's project, not the gcloud default
        parts = name.split("/")
        project = parts[1] if len(parts) > 3 else ""
        job_id = parts[-1]
        filt = f'resource.labels.job_id="{job_id}"'
        if since is not None:
            filt += f' AND timestamp>="{_rfc3339(since)}"'
        if until is not None:
            filt += f' AND timestamp<="{_rfc3339(until)}"'
        proc = self._cmd(
            [
                "gcloud",
                "logging",
                "read",
                filt,
                *(["--project", project] if project else []),
                "--format=value(textPayload)",
                "--order=asc",
                "--freshness=30d",
            ],
            op="logs",
        )
        if proc.returncode != 0:
            raise RuntimeError(f"gcloud logging read failed: {proc.stderr}")
        lines: Iterable[str] = iter(proc.stdout.splitlines())
        if regex:
            lines = filter_regex(regex, lines)
        return lines


def _job_to_dict(job: Any) -> dict[str, Any]:
    """Accept proto messages, SDK objects, or plain dicts."""
    if isinstance(job, Mapping):
        return dict(job)
    state = getattr(job, "state", "")
    state = getattr(state, "name", state)  # proto enum -> name
    err = getattr(job, "error", None)
    return {
        "state": state,
        "error": {"message": getattr(err, "message", "")} if err else None,
    }


def describe_custom_job(
    app_id: str, job: Mapping[str, Any]
) -> DescribeAppResponse:
    raw_state = str(job.get("state") or "")
    state = VERTEX_STATE_MAP.get(raw_state, AppState.UNKNOWN)
    err = job.get("error") or {}
    return DescribeAppResponse(
        app_id=app_id,
        state=state,
        structured_error_msg=str(err.get("message", "")) if err else "",
        roles_statuses=[
            RoleStatus(
                role="worker",
                replicas=[ReplicaStatus(id=0, state=state, role="worker")],
            )
        ],
    )


# -- app_id -> CustomJob resource-name registry (cross-process, same
#    pattern as the slurm job-dir registry) --------------------------------


def _registry_path() -> str:
    return os.path.join(os.path.expanduser("~"), VERTEX_JOBS_FILE)


def _save_job_name(app_id: str, name: str) -> None:
    from torchx_tpu_torch.util import registry

    registry.record(_registry_path(), app_id, name)


def _load_job_name(app_id: str) -> Optional[str]:
    from torchx_tpu_torch.util import registry

    return registry.lookup(_registry_path(), app_id)


def create_scheduler(session_name: str, **kwargs: Any) -> VertexScheduler:
    known = {"client", "docker_client"}
    return VertexScheduler(
        session_name=session_name,
        **{k: v for k, v in kwargs.items() if k in known},
    )
