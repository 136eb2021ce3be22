"""GCP Batch scheduler: multi-node gang jobs via ``gcloud batch``.

The port's copy of :mod:`torchx_tpu.schedulers.gcp_batch_scheduler`, on
GPU VMs in place of TPU VMs. Reference analog:
torchx/schedulers/aws_batch_scheduler.py (854 LoC), which maps AppDef ->
an AWS Batch multi-node-parallel job (roles -> node-groups with
targetNodes ranges at :196-291, job registration + submit at :500-520). The GCP-native counterpart maps AppDef -> a **Batch Job**
(batch.googleapis.com) JSON config:

* one **taskGroup per role**: ``taskCount`` = gang hosts, one task per VM
  (``taskCountPerNode: 1``), ``requireHostsFile`` + ``permissiveSsh`` for
  in-gang rendezvous — the role node-groups play in the reference;
* gang identity is derived *in the task*, not baked per-replica: Batch
  injects ``BATCH_TASK_INDEX`` (≙ the job completion index on GKE) and
  writes the taskgroup hosts file, so the bootstrap exports
  ``TPX_REPLICA_ID``/``TPX_COORDINATOR_HOST`` from those — same contract
  as every other backend (schedulers/api.py role_replica_env);
* GPU slices ride the A3 machine family: a host of ``n`` H100s is
  ``a3-highgpu-{n}g`` (``GpuSlice.machine_type``) with its cards asked for
  as ``policy.accelerators`` (``nvidia-h100-80gb`` x ``n``) and the
  drivers installed by Batch (``installGpuDrivers``), in
  ``allocationPolicy.instances[]`` — the role EFA devices + instance types
  play at the reference's :330-358;
* retries: ``taskSpec.maxRetryCount`` (REPLICA scope) or Batch-level task
  rescheduling; structured state from ``status.state`` +
  ``status.taskGroups[].counts``.

All gcloud calls go through ``self._run_cmd`` so tests inject canned JSON
(the reference's mock-client strategy, aws_batch_scheduler_test.py); the
job config materialization is a pure function over dicts, asserted on by
dryrun tests with no cloud.
"""

from __future__ import annotations

import json
import logging
import shlex
import subprocess
from dataclasses import dataclass, field
from typing import Any, Iterable, Mapping, Optional

from torchx_tpu_torch import settings
from torchx_tpu_torch.resilience.policy import NON_IDEMPOTENT
from torchx_tpu_torch.schedulers.api import (
    DescribeAppResponse,
    dquote as _dquote,
    safe_int as _safe_int,
    ListAppResponse,
    Scheduler,
    SchedulerCapabilities,
    Stream,
    filter_regex,
    rfc3339 as _rfc3339,
    gpu_hosts_for_role,
)
from torchx_tpu_torch.schedulers.ids import make_unique, sanitize_name
from torchx_tpu_torch.schedulers.structured_opts import StructuredOpts
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

# Batch job state -> AppState (``gcloud batch jobs describe`` status.state)
BATCH_STATE_MAP: dict[str, AppState] = {
    "STATE_UNSPECIFIED": AppState.UNKNOWN,
    "QUEUED": AppState.PENDING,
    "SCHEDULED": AppState.PENDING,
    "RUNNING": AppState.RUNNING,
    "SUCCEEDED": AppState.SUCCEEDED,
    "FAILED": AppState.FAILED,
    "CANCELLATION_IN_PROGRESS": AppState.CANCELLED,
    "CANCELLED": AppState.CANCELLED,
    "DELETION_IN_PROGRESS": AppState.CANCELLED,
}

# where Batch writes the taskgroup hosts file on the VM (and where we
# mount it inside container runnables)
HOSTS_FILE = "/etc/cloudbatch-taskgroup-hosts"


@dataclass
class GCPBatchOpts(StructuredOpts):
    """Typed run config for the gcp_batch scheduler."""

    project: Optional[str] = None
    """GCP project id (defaults to the gcloud configured project)."""

    location: str = "us-central1"
    """Batch region to submit into."""

    machine_type: str = "e2-standard-4"
    """machine type for CPU roles (GPU slice roles derive theirs from the
    slice)."""



@dataclass
class GCPBatchJob:
    """Materialized request: the Batch job config + submit identifiers."""

    name: str
    location: str
    project: Optional[str]
    config: dict[str, Any]
    images_to_push: dict[str, tuple[str, str]] = field(default_factory=dict)

    def __str__(self) -> str:
        return json.dumps(self.config, indent=2, default=str)


def _bootstrap(role: Role, app_id: str, num_hosts: int) -> str:
    """Shell prelude every task runs: derive the gang identity the other
    backends inject as env (role_replica_env) from Batch's own variables,
    then exec the role's entrypoint."""
    env_lines = [
        f"export {settings.ENV_TPX_APP_ID}={shlex.quote(app_id)}",
        f"export {settings.ENV_TPX_ROLE_NAME}={shlex.quote(role.name)}",
        f'export {settings.ENV_TPX_REPLICA_ID}="${{BATCH_TASK_INDEX:-0}}"',
        f"export {settings.ENV_TPX_NUM_REPLICAS}={num_hosts}",
        # rendezvous: host 0 of the taskgroup (first line of the hosts
        # file Batch writes when requireHostsFile is set)
        f'export {settings.ENV_TPX_COORDINATOR_HOST}="$(head -n1 {HOSTS_FILE}'
        ' 2>/dev/null | cut -d" " -f1)"',
        f'[ -n "${settings.ENV_TPX_COORDINATOR_HOST}" ] ||'
        f" export {settings.ENV_TPX_COORDINATOR_HOST}=localhost",
        f"export {settings.ENV_TPX_ERROR_FILE}=/tmp/tpx_error.json",
    ]
    for k, v in sorted(role.env.items()):
        env_lines.append(f"export {k}={_dquote(v)}")
    cmd = " ".join(_dquote(a) for a in [role.entrypoint, *role.args])
    return "\n".join([*env_lines, f"exec {cmd}"])


def role_to_task_group(role: Role, app_id: str) -> dict[str, Any]:
    """One role -> one Batch taskGroup (reference: role -> node-group,
    aws_batch_scheduler.py:196-291)."""
    gpu = role.resource.gpu if role.resource is not None else None
    num_hosts = gpu_hosts_for_role(role)

    values = macros.Values(
        img_root="",
        app_id=app_id,
        # the bootstrap exports the derived id before exec'ing, and args
        # are double-quoted so the reference expands at runtime
        replica_id=f"${settings.ENV_TPX_REPLICA_ID}",
        num_replicas=str(num_hosts),
        coordinator_env=settings.ENV_TPX_COORDINATOR_HOST,
    )
    srole = values.apply(role)
    script = _bootstrap(srole, app_id, num_hosts)

    runnable: dict[str, Any]
    if srole.image:
        runnable = {
            "container": {
                "imageUri": srole.image,
                "entrypoint": "/bin/sh",
                "commands": ["-c", script],
                # the hosts file lives on the VM; containers need it for
                # coordinator derivation
                "volumes": [f"{HOSTS_FILE}:{HOSTS_FILE}:ro"],
            }
        }
    else:
        runnable = {"script": {"text": script}}

    task_spec: dict[str, Any] = {
        "runnables": [runnable],
        "maxRetryCount": srole.max_retries,
    }
    if role.resource is not None and not gpu:
        task_spec["computeResource"] = {
            "cpuMilli": int(role.resource.cpu * 1000),
            "memoryMib": role.resource.memMB,
        }

    group: dict[str, Any] = {
        "taskSpec": task_spec,
        "taskCount": num_hosts,
        "parallelism": num_hosts,  # gang: all hosts at once
        "taskCountPerNode": 1,
        # in-gang rendezvous surface (hosts file + ssh between tasks)
        "requireHostsFile": True,
        "permissiveSsh": True,
    }
    return group


def app_to_batch_job(
    app: AppDef, app_id: str, opts: GCPBatchOpts
) -> dict[str, Any]:
    """AppDef -> Batch Job config dict (pure; dryrun tests assert on it).

    Single-role apps only: the Batch API accepts exactly one taskGroup per
    job and honors one instance policy — multi-role apps belong on the GKE
    backend."""
    if len(app.roles) != 1:
        raise ValueError(
            f"gcp_batch supports single-role apps (a Batch job is one"
            f" taskGroup); app {app.name!r} has {len(app.roles)} roles —"
            " use the gke backend for multi-role apps"
        )
    (role,) = app.roles
    task_group = role_to_task_group(role, app_id)
    gpu = role.resource.gpu if role.resource is not None else None
    instance: dict[str, Any]
    if gpu:
        # one host of the slice: its A3 machine, its cards, and the drivers
        # Batch installs on the VM for them
        instance = {
            "policy": {
                "machineType": gpu.machine_type,
                "accelerators": [{
                    "type": GPU_GENERATIONS[gpu.accelerator]["gke_accelerator"],
                    "count": gpu.gpus_per_host,
                }],
            },
            "installGpuDrivers": True,
        }
    else:
        # per-role machine pin (heterogeneous catalog) beats the run cfg
        caps = role.resource.capabilities if role.resource is not None else {}
        machine = str(caps.get("gce.machine_type") or opts.machine_type)
        instance = {"policy": {"machineType": machine}}

    labels = {
        "tpx-app-name": app_id,
        "tpx-role-name": sanitize_name(role.name, max_len=63),
    }
    config: dict[str, Any] = {
        "taskGroups": [task_group],
        "allocationPolicy": {
            "instances": [instance],
            "labels": dict(labels),
        },
        "labels": dict(labels),
        "logsPolicy": {"destination": "CLOUD_LOGGING"},
    }
    return config


def describe_batch_job(
    name: str, payload: Mapping[str, Any], roles: list[str]
) -> DescribeAppResponse:
    """Map a ``gcloud batch jobs describe`` JSON payload onto AppStatus
    (pure; fixture-testable like describe_jobset)."""
    status = payload.get("status") or {}
    state = BATCH_STATE_MAP.get(str(status.get("state", "")), AppState.UNKNOWN)
    roles_statuses = []
    group_status = status.get("taskGroups") or {}
    for i, role_name in enumerate(roles):
        counts = (group_status.get(f"group{i}") or {}).get("counts") or {}
        replicas = []
        idx = 0
        for batch_state, n in counts.items():
            mapped = BATCH_STATE_MAP.get(batch_state, AppState.UNKNOWN)
            for _ in range(_safe_int(n)):
                replicas.append(
                    ReplicaStatus(
                        id=idx, role=role_name, state=mapped, hostname=""
                    )
                )
                idx += 1
        roles_statuses.append(RoleStatus(role=role_name, replicas=replicas))
    return DescribeAppResponse(
        app_id=name, state=state, roles_statuses=roles_statuses
    )


# Feature profile for the preflight analyzer (torchx_tpu_torch.analyze): Batch
# jobs are single-role (one taskGroup), honor maxRetryCount natively, and
# build concrete machine requests from cpu/memMB.
CAPABILITIES = SchedulerCapabilities(
    mounts=False,
    multi_role=False,
    multislice=False,
    delete=True,
    resize=False,
    logs=True,
    native_retries=True,
    concrete_resources=True,
    classifies_preemption=False,
)


class GCPBatchScheduler(DockerWorkspaceMixin, Scheduler[GCPBatchJob]):
    """Submits AppDefs as GCP Batch jobs through the gcloud CLI."""

    capabilities = CAPABILITIES

    # since/until become server-side Cloud Logging timestamp filters
    supports_log_windows = True

    def __init__(self, session_name: str, docker_client: Optional[Any] = None) -> None:
        super().__init__(
            docker_client=docker_client,
            backend="gcp_batch",
            session_name=session_name,
        )
        # last-submitted run cfg; list() reuses it for project/location scope
        self._session_opts: Optional[GCPBatchOpts] = None

    def _run_cmd(self, cmd: list[str], **kwargs: Any) -> subprocess.CompletedProcess:
        """Raw gcloud subprocess seam (tests monkeypatch this); call sites
        go through :meth:`Scheduler._cmd` for deadlines, classified
        retries, and the backend breaker."""
        return subprocess.run(cmd, capture_output=True, text=True, **kwargs)

    def run_opts(self) -> runopts:
        return GCPBatchOpts.to_runopts() | self.workspace_opts()

    def _gcloud(self, opts_or_job: Any, *args: str) -> list[str]:
        cmd = ["gcloud", "batch", "jobs", *args]
        cmd += ["--location", opts_or_job.location]
        if opts_or_job.project:
            cmd += ["--project", opts_or_job.project]
        return cmd

    # -- dryrun / schedule -------------------------------------------------

    def _submit_dryrun(
        self, app: AppDef, cfg: Mapping[str, CfgVal]
    ) -> AppDryRunInfo[GCPBatchJob]:
        opts = GCPBatchOpts.from_cfg(cfg)
        # Batch job ids and label values cap at 63 chars (hash-suffix
        # truncation keeps derived strings stable, same as the GKE budget)
        app_id = sanitize_name(make_unique(app.name), max_len=60)
        images_to_push = self.dryrun_push_images(app, cfg)
        config = app_to_batch_job(app, app_id, opts)
        req = GCPBatchJob(
            name=app_id,
            location=opts.location,
            project=opts.project,
            config=config,
            images_to_push=images_to_push,
        )
        return AppDryRunInfo(req)

    def schedule(self, dryrun_info: AppDryRunInfo[GCPBatchJob]) -> str:
        req = dryrun_info.request
        # remember where this session actually submits, for list() scoping
        # (set here, not in dryrun: a dryrun that is never scheduled must
        # not retarget list())
        self._session_opts = GCPBatchOpts(
            project=req.project, location=req.location
        )
        self.push_images(req.images_to_push)
        proc = self._cmd(
            self._gcloud(req, "submit", req.name, "--config", "-"),
            op="submit",
            policy=NON_IDEMPOTENT,
            input=json.dumps(req.config),
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"gcloud batch jobs submit failed: {proc.stderr.strip()}"
            )
        # durable scope registry: a FRESH process's list() must still query
        # the project/location this job went to (slurm job-dir pattern).
        # Resolve the gcloud default NOW so the stored scope is canonical —
        # storing None would later dedupe against explicit-project scopes
        # as if they were different projects (duplicate list() rows)
        scope_project = req.project or self._gcloud_project()
        _record_scope(scope_project, req.location)
        # a successful submit proves the scope live again: un-evict it
        _note_scope_result(scope_project, req.location, ok=True)
        if req.project:
            return f"{req.project}:{req.location}:{req.name}"
        return f"{req.location}:{req.name}"

    # -- monitoring --------------------------------------------------------

    @dataclass
    class _Id:
        location: str
        name: str
        project: Optional[str] = None

    @staticmethod
    def _parse_app_id(app_id: str) -> "GCPBatchScheduler._Id":
        """``location:name`` or ``project:location:name`` (the project
        prefix is minted at schedule() time when a project cfg was given,
        so every later verb targets the right project)."""
        parts = app_id.split(":")
        if len(parts) == 2 and all(parts):
            return GCPBatchScheduler._Id(location=parts[0], name=parts[1])
        if len(parts) == 3 and all(parts):
            return GCPBatchScheduler._Id(
                project=parts[0], location=parts[1], name=parts[2]
            )
        raise ValueError(
            f"invalid gcp_batch app id {app_id!r}; expected"
            " [project:]location:name"
        )

    def _describe_json(self, job: "GCPBatchScheduler._Id") -> Optional[dict]:
        """Raw ``gcloud batch jobs describe`` payload, or None when the job
        is unknown / the output is unparseable (shared by describe and the
        log-UID resolution)."""
        proc = self._cmd(
            self._gcloud(job, "describe", job.name, "--format", "json"),
            op="describe",
        )
        if proc.returncode != 0:
            return None
        try:
            payload = json.loads(proc.stdout or "{}")
        except json.JSONDecodeError:
            return None
        return payload if isinstance(payload, dict) else None

    def describe(self, app_id: str) -> Optional[DescribeAppResponse]:
        job = self._parse_app_id(app_id)
        payload = self._describe_json(job)
        if payload is None:
            return None
        # single-role jobs: the real role name rides the job label we set
        # at materialization (Batch taskGroups carry no names)
        role_name = (payload.get("labels") or {}).get("tpx-role-name") or "role0"
        return describe_batch_job(app_id, payload, [role_name])

    def list(self) -> list[ListAppResponse]:
        # Batch listing is location-scoped but list() takes no cfg: union
        # every scope this USER ever submitted to (durable registry, so a
        # fresh CLI process still finds explicit-project jobs) plus the
        # session's last-submitted scope, falling back to the
        # gcloud-configured project + default location when neither exists.
        default_project = self._gcloud_project()
        raw: list[tuple[Optional[str], str]] = []
        if self._session_opts is not None:
            raw.append(
                (self._session_opts.project, self._session_opts.location)
            )
        # eviction filters HERE, not in _known_scopes(): _record_scope
        # uses _known_scopes() as its already-durable check, and an
        # evicted-but-recorded scope must not be re-appended on resubmit
        raw.extend(
            sorted(
                _known_scopes() - _evicted_scopes(),
                key=lambda s: (s[0] or "", s[1]),
            )
        )
        if default_project is not None and (
            default_project,
            GCPBatchOpts.location,
        ) not in _evicted_scopes():
            # default-project jobs (submitted by gcloud directly or by a
            # pre-registry version) must not vanish once any scope exists
            # — but a default scope that keeps failing (revoked project)
            # sits out like any other evicted scope
            raw.append((default_project, GCPBatchOpts.location))
        scopes: list[tuple[Optional[str], str]] = []
        for project, location in raw:
            scope = (project or default_project, location)
            if scope not in scopes:
                scopes.append(scope)
        if not scopes:
            scopes.append((default_project, GCPBatchOpts.location))
        out: list[ListAppResponse] = []
        seen: set[str] = set()
        for project, location in scopes:
            opts = GCPBatchOpts(project=project, location=location)
            proc = self._cmd(
                self._gcloud(opts, "list", "--format", "json"), op="list"
            )
            _note_scope_result(project, location, proc.returncode == 0)
            if proc.returncode != 0:
                continue
            try:
                jobs = json.loads(proc.stdout or "[]")
            except json.JSONDecodeError:
                continue
            # mint ids with the project prefix when known, so describe/
            # cancel/log on a listed id target the same project list()
            # queried
            prefix = f"{project}:{location}" if project else location
            for j in jobs:
                name = str(j.get("name", "")).rsplit("/", 1)[-1]
                app_id = f"{prefix}:{name}"
                if app_id in seen:
                    continue
                seen.add(app_id)
                state = BATCH_STATE_MAP.get(
                    str((j.get("status") or {}).get("state", "")),
                    AppState.UNKNOWN,
                )
                out.append(
                    ListAppResponse(app_id=app_id, state=state, name=name)
                )
        return out

    def _gcloud_project(self) -> Optional[str]:
        """The gcloud-configured default project, or None."""
        proc = self._cmd(["gcloud", "config", "get-value", "project"], op="config")
        if proc.returncode != 0:
            return None
        val = (proc.stdout or "").strip()
        return val if val and val != "(unset)" else None

    def _cancel_existing(self, app_id: str) -> None:
        job = self._parse_app_id(app_id)
        proc = self._cmd(
            self._gcloud(job, "cancel", job.name, "--quiet"), op="cancel"
        )
        if proc.returncode != 0:
            # older gcloud has no `cancel`; deletion also stops the job
            self._cmd(
                self._gcloud(job, "delete", job.name, "--quiet"), op="cancel"
            )

    def delete(self, app_id: str) -> None:
        job = self._parse_app_id(app_id)
        self._cmd(self._gcloud(job, "delete", job.name, "--quiet"), op="delete")

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
        """Cloud Logging fetch (the CloudWatch analog of the reference's
        aws_batch log_iter); no tail, single page of recent entries.
        since/until map to server-side ``timestamp`` filters; Batch keeps
        one combined log per task, so stream selection raises."""
        if streams not in (None, Stream.COMBINED):
            raise ValueError(
                f"gcp_batch task logs are a single combined Cloud Logging"
                f" stream; selecting {streams} is not supported"
            )
        job = self._parse_app_id(app_id)
        # Batch stamps log entries with the server-generated job UID, not
        # the submitted job id — resolve it via describe first
        payload = self._describe_json(job)
        uid = (payload or {}).get("uid") or job.name
        filt = (
            f'labels.job_uid="{uid}" AND '
            f'labels.task_index="{k}"'
        )
        if since is not None:
            filt += f' AND timestamp>="{_rfc3339(since)}"'
        if until is not None:
            filt += f' AND timestamp<="{_rfc3339(until)}"'
        cmd = [
            "gcloud",
            "logging",
            "read",
            filt,
            "--format",
            "json",
            "--order",
            "asc",
        ]
        if job.project:
            cmd += ["--project", job.project]
        proc = self._cmd(cmd, op="logs")
        if proc.returncode != 0:
            raise RuntimeError(
                f"gcloud logging read failed: {proc.stderr.strip()}"
            )
        try:
            entries = json.loads(proc.stdout or "[]")
        except json.JSONDecodeError:
            entries = []
        lines = (str(e.get("textPayload", "")).rstrip("\n") for e in entries)
        if regex:
            lines = filter_regex(regex, lines)
        return lines


# -- durable scope registry ---------------------------------------------
# one line per DISTINCT submitted scope (``scope = project|location``) in
# the user's home dir, the slurm job-dir registry's pattern: list()
# from a fresh process unions these scopes instead of falling back to the
# gcloud default and missing explicit-project jobs

GCP_BATCH_SCOPES_FILE = ".tpx_torch_gcp_batch_scopes"


def _scopes_path() -> str:
    import os

    return os.path.join(os.path.expanduser("~"), GCP_BATCH_SCOPES_FILE)


def _dedup_keeper() -> Any:
    """Compaction predicate: keep the first line per distinct scope value
    (staleness can't be probed without gcloud, but duplicates can go)."""
    seen: set[str] = set()

    def keep(value: str) -> bool:
        if value in seen:
            return False
        seen.add(value)
        return True

    return keep


def _record_scope(project: Optional[str], location: str) -> None:
    if (project or None, location) in _known_scopes():
        return  # already durable; keep the file at one line per scope
    from torchx_tpu_torch.util import registry

    registry.record(
        _scopes_path(),
        "scope",
        f"{project or ''}|{location}",
        keep=_dedup_keeper(),
    )


def _known_scopes() -> set[tuple[Optional[str], str]]:
    from torchx_tpu_torch.util import registry

    out: set[tuple[Optional[str], str]] = set()
    for _, value in registry.entries(_scopes_path()):
        project, sep, location = value.partition("|")
        if sep and location:
            out.add((project or None, location))
    return out


# -- scope failure tracking / eviction ----------------------------------
# A recorded scope whose project was deleted or revoked would otherwise
# add one failing gcloud subprocess to EVERY list() forever (advisor r4).
# The bookkeeping is one instance of the shared durable-breaker primitive
# (:class:`torchx_tpu_torch.resilience.breaker.FailureLedger`): each failed
# list per scope counts one unbroken failure, a successful list (or a new
# submit to the scope) clears the streak, and a scope at the threshold is
# skipped by list() until it succeeds again via submit. The file is the
# port's own, beside the JAX launcher's (which keeps its format).

GCP_BATCH_SCOPE_FAILS_FILE = ".tpx_torch_gcp_batch_scope_fails"
SCOPE_EVICT_FAILURES = 3


def _fails_path() -> str:
    import os

    return os.path.join(os.path.expanduser("~"), GCP_BATCH_SCOPE_FAILS_FILE)


def _scope_key(project: Optional[str], location: str) -> str:
    return f"{project or ''}|{location}"


def _scope_ledger() -> "FailureLedger":
    from torchx_tpu_torch.resilience.breaker import FailureLedger

    return FailureLedger(_fails_path(), threshold=SCOPE_EVICT_FAILURES)


def _scope_failures() -> dict[str, int]:
    return _scope_ledger().failures()


def _note_scope_result(project: Optional[str], location: str, ok: bool) -> None:
    """Best-effort failure bookkeeping (a lost concurrent update costs at
    most one miscounted failure, which the next list corrects)."""
    _scope_ledger().note(_scope_key(project, location), ok)


def _evicted_scopes() -> set[tuple[Optional[str], str]]:
    out: set[tuple[Optional[str], str]] = set()
    for key in _scope_ledger().tripped():
        project, sep, location = key.partition("|")
        if sep and location:
            out.add((project or None, location))
    return out


def create_scheduler(session_name: str, **kwargs: Any) -> GCPBatchScheduler:
    return GCPBatchScheduler(session_name, **kwargs)
