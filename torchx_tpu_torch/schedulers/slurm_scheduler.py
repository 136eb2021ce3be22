"""Slurm scheduler: AppDef -> one heterogeneous sbatch job.

The port's copy of :mod:`torchx_tpu.schedulers.slurm_scheduler`, on GPU
nodes. Reference analog: torchx/schedulers/slurm_scheduler.py (931 LoC). Kept
design: every replica is a hetjob group materialized into a bash script
with ``#SBATCH hetjob`` separators and a single ``srun`` with
``:``-separated groups (reference :285-330); the coordinator host is
derived from het-group-0's nodelist (reference rank0 via
``SLURM_JOB_NODELIST_HET_GROUP_0``, :538); retries requeue the job while
``TPX_MAX_RETRIES > SLURM_RESTART_COUNT`` (reference :313-327); describe
goes through ``squeue --json`` falling back to ``sacct --parsable2``
(reference :572-810); per-replica logs land in
``slurm-{jobid}-{role}-{replica}.{out,err}`` with a job-dir registry file
(reference :52,913-931).

GPU twist: a role with a GpuSlice expands to one het group per host
(``gpu_hosts_for_role``), and each group exports the gang identity env the
SPMD bootstrap consumes (``role_replica_env``; the coordinator comes from
het group 0's node list). A GPU role's groups ask Slurm for the cards
(``--gpus-per-node=<gpus_per_host>``, and the same for a
``devices["nvidia.com/gpu"]`` count): on a GPU cluster a job that asks for
no GRES sees no card.

All subprocess calls go through ``self._run_cmd`` so tests inject canned
squeue/sacct/sbatch output (reference test strategy:
slurm-squeue-output.json fixtures).
"""

from __future__ import annotations

import json
import logging
import os
import shlex
import subprocess
import tempfile
from dataclasses import dataclass
from typing import Any, Iterable, Mapping, Optional

from torchx_tpu_torch import settings
from torchx_tpu_torch.resilience.policy import NON_IDEMPOTENT
from torchx_tpu_torch.schedulers.api import (
    dquote as _dquote,
    DescribeAppResponse,
    EPOCH_STAMPER,
    ListAppResponse,
    Scheduler,
    SchedulerCapabilities,
    Stream,
    filter_regex,
    gpu_hosts_for_role,
    role_replica_env,
    window_stamped_lines,
)
from torchx_tpu_torch.specs.api import (
    AppDef,
    AppDryRunInfo,
    AppState,
    CfgVal,
    ReplicaStatus,
    Role,
    RoleStatus,
    macros,
    runopts,
)
from torchx_tpu_torch.workspace.dir_workspace import DirWorkspaceMixin

logger = logging.getLogger(__name__)

SLURM_JOB_DIRS_FILE = ".tpx_torch_slurm_dirs"

SLURM_STATE_MAP: dict[str, AppState] = {
    "PENDING": AppState.PENDING,
    "CONFIGURING": AppState.PENDING,
    "REQUEUED": AppState.PENDING,
    "REQUEUE_FED": AppState.PENDING,
    "REQUEUE_HOLD": AppState.PENDING,
    "SUSPENDED": AppState.PENDING,
    "RUNNING": AppState.RUNNING,
    "COMPLETING": AppState.RUNNING,
    "RESIZING": AppState.RUNNING,
    "SIGNALING": AppState.RUNNING,
    "STAGE_OUT": AppState.RUNNING,
    "COMPLETED": AppState.SUCCEEDED,
    "FAILED": AppState.FAILED,
    "BOOT_FAIL": AppState.FAILED,
    "DEADLINE": AppState.FAILED,
    "NODE_FAIL": AppState.FAILED,
    "OUT_OF_MEMORY": AppState.FAILED,
    "TIMEOUT": AppState.FAILED,
    "PREEMPTED": AppState.FAILED,
    "CANCELLED": AppState.CANCELLED,
    "REVOKED": AppState.CANCELLED,
}


def slurm_state(state_str: str) -> AppState:
    # sacct can report "CANCELLED by 12345"; pending rows can be blank
    parts = state_str.split()
    if not parts:
        return AppState.UNKNOWN
    return SLURM_STATE_MAP.get(parts[0].rstrip("+"), AppState.UNKNOWN)


def _gpu_opts(role: Role) -> list[str]:
    """``--gpus-per-node`` for a role's cards: its slice's ``gpus_per_host``,
    else its ``nvidia.com/gpu`` named-device count; none for a CPU role."""
    res = role.resource
    gpus = res.gpu.gpus_per_host if res.gpu is not None else res.devices.get("nvidia.com/gpu")
    return [f"--gpus-per-node={int(gpus)}"] if gpus else []


def _slice_env(role: Role) -> dict[str, str]:
    """A GPU role's slice as ``role_replica_env`` names it (accelerator type
    and topology), for the elastic group, whose replica ids come at run
    time."""
    if role.resource.gpu is None:
        return {}
    return {
        settings.ENV_TPX_GPU_ACCELERATOR_TYPE: role.resource.gpu.accelerator_type,
        settings.ENV_TPX_GPU_TOPOLOGY: role.resource.gpu.default_topology(),
    }


@dataclass
class SlurmReplicaRequest:
    """One hetjob group == one replica (reference :178-271)."""

    name: str  # {role}-{replica}
    sbatch_opts: list[str]
    srun_opts: list[str]
    env: dict[str, str]
    cmd: list[str]


@dataclass
class SlurmBatchRequest:
    cmd: list[str]  # sbatch argv (script path appended at schedule time)
    replicas: list[SlurmReplicaRequest]
    job_dir: Optional[str]
    max_retries: int = 0
    # (min_hosts, max_hosts) for an elastic single-role gang: materialized
    # as one RANGED group (``--nodes=min-max``) instead of het groups, so
    # slurm itself may start — or requeue — the job with any surviving node
    # count in range (the slurm-native analog of torchrun --nnodes min:max)
    elastic_range: Optional[tuple[int, int]] = None
    # hosts per AppDef unit (slice) — the srun step rounds the allocation
    # down to a whole-slice multiple, and TPX_MIN_REPLICAS stays in AppDef
    # units (matching the GKE backend's injection)
    elastic_hosts_per_unit: int = 1

    def script(self) -> str:
        return materialize_script(self)

    def __str__(self) -> str:
        return " ".join(self.cmd) + " <<script>>\n" + self.script()


def _role_to_replicas(
    role: Role, cfg: Mapping[str, CfgVal]
) -> list[SlurmReplicaRequest]:
    out = []
    num = gpu_hosts_for_role(role)
    partition = cfg.get("partition")
    for replica_id in range(num):
        values = macros.Values(
            img_root=role.image,
            app_id="${SLURM_JOB_ID}",
            replica_id=str(replica_id),
            num_replicas=str(num),
            coordinator_env=settings.ENV_TPX_COORDINATOR_HOST,
        )
        rrole = values.apply(role)
        # per-group job name: describe() parses {role}-{replica} back out of
        # squeue/sacct JobName (reference slurm_scheduler.py:260)
        sbatch_opts = [
            f"--job-name={role.name}-{replica_id}",
            "--nodes=1",
            "--ntasks-per-node=1",
        ]
        if partition:
            sbatch_opts.append(f"--partition={shlex.quote(str(partition))}")
        if rrole.resource.cpu > 0:
            sbatch_opts.append(f"--cpus-per-task={int(rrole.resource.cpu)}")
        if rrole.resource.memMB > 0 and not cfg.get("nomem"):
            sbatch_opts.append(f"--mem={int(rrole.resource.memMB)}")
        sbatch_opts.extend(_gpu_opts(rrole))
        if cfg.get("time"):
            sbatch_opts.append(f"--time={cfg['time']}")
        for cap, val in rrole.resource.capabilities.items():
            if cap == "slurm.constraint":
                sbatch_opts.append(f"--constraint={val}")
        env = dict(rrole.env)
        # the gang identity; the coordinator is exported once for the job,
        # from het group 0's node list (materialize_script)
        identity = role_replica_env(role, replica_id, "", settings.TPX_COORDINATOR_PORT)
        identity.pop(settings.ENV_TPX_COORDINATOR_HOST)
        env.update(identity)
        out.append(
            SlurmReplicaRequest(
                name=f"{role.name}-{replica_id}",
                sbatch_opts=sbatch_opts,
                srun_opts=["--kill-on-bad-exit=1", "--wait=60"],
                env=env,
                cmd=[rrole.entrypoint, *rrole.args],
            )
        )
    return out


def _elastic_replica(role: Role, cfg: Mapping[str, CfgVal]) -> SlurmReplicaRequest:
    """Template for the single RANGED group of an elastic gang.

    Identity env cannot be baked per-replica (the started size is only
    known at run time), so the macros defer to ``TPX_REPLICA_ID`` /
    ``TPX_NUM_REPLICAS``, which the per-task wrapper derives from
    ``SLURM_PROCID`` / ``SLURM_NTASKS`` (see :func:`materialize_script`).
    """
    values = macros.Values(
        img_root=role.image,
        app_id="${SLURM_JOB_ID}",
        replica_id="${TPX_REPLICA_ID}",
        num_replicas="${TPX_NUM_REPLICAS}",
        coordinator_env=settings.ENV_TPX_COORDINATOR_HOST,
    )
    rrole = values.apply(role)
    partition = cfg.get("partition")
    sbatch_opts = [
        f"--job-name={role.name}-0",  # describe() parses {role}-{replica}
        "--ntasks-per-node=1",
    ]
    if partition:
        sbatch_opts.append(f"--partition={shlex.quote(str(partition))}")
    if rrole.resource.cpu > 0:
        sbatch_opts.append(f"--cpus-per-task={int(rrole.resource.cpu)}")
    if rrole.resource.memMB > 0 and not cfg.get("nomem"):
        sbatch_opts.append(f"--mem={int(rrole.resource.memMB)}")
    sbatch_opts.extend(_gpu_opts(rrole))
    if cfg.get("time"):
        sbatch_opts.append(f"--time={cfg['time']}")
    for cap, val in rrole.resource.capabilities.items():
        if cap == "slurm.constraint":
            sbatch_opts.append(f"--constraint={val}")
    env = dict(rrole.env)
    env[settings.ENV_TPX_ROLE_NAME] = role.name
    env.update(_slice_env(rrole))
    return SlurmReplicaRequest(
        name=role.name,
        sbatch_opts=sbatch_opts,
        srun_opts=["--kill-on-bad-exit=1", "--wait=60"],
        env=env,
        cmd=[rrole.entrypoint, *rrole.args],
    )


# Task-side stamping wrapper for het groups: a FIXED single-quoted
# ``bash -c`` body (no per-group escaping) whose positional params are the
# already-batch-shell-expanded command argv. Lines gain an epoch-millis
# prefix (shared ``EPOCH_STAMPER``) which ``log_iter`` strips on read and
# uses for since/until windows — the slurm analog of the local Tee's
# stamps and kubelet's ``timestamps=true``.
# pipelines, not process substitutions: bash waits for every pipeline
# member before exiting, so the stampers are fully drained when slurmstepd
# reaps the task (procsubs are NOT waited on — a crash's final traceback
# lines would race the reaper and vanish from the .err file); pipefail
# propagates the command's exit status through both pipelines
_STAMP_WRAPPER = (
    "'set -o pipefail;"
    " { (\"$@\") 2>&1 1>&3 | python3 -u -c \"$TPX_STAMP\" >&2; } 3>&1"
    " | python3 -u -c \"$TPX_STAMP\"' tpx"
)


def materialize_script(req: SlurmBatchRequest) -> str:
    """The full sbatch script: SBATCH headers (hetjob groups, or one ranged
    group for an elastic gang), coordinator export, requeue-on-failure
    logic, and the single srun line."""
    if req.elastic_range is not None:
        return _materialize_elastic_script(req)
    lines = ["#!/bin/bash"]
    for i, rep in enumerate(req.replicas):
        if i > 0:
            lines.append("#SBATCH hetjob")
        lines.extend(f"#SBATCH {opt}" for opt in rep.sbatch_opts)
    lines += [
        "",
        "set -e",
        "# coordinator = first node of het group 0 (role-0/replica-0)",
        'export TPX_COORDINATOR_HOST=$(scontrol show hostnames'
        ' "${SLURM_JOB_NODELIST_HET_GROUP_0:-$SLURM_JOB_NODELIST}" | head -n 1)',
        f"export TPX_APP_ID=tpx-${{SLURM_JOB_ID}}",
        f"export TPX_STAMP={shlex.quote(EPOCH_STAMPER)}",
        "",
    ]
    if req.max_retries > 0:
        lines += [
            f"export TPX_MAX_RETRIES={req.max_retries}",
            "tpx_requeue() {",
            '  if [ "${SLURM_RESTART_COUNT:-0}" -lt "$TPX_MAX_RETRIES" ]; then',
            '    scontrol requeue "$SLURM_JOB_ID"',
            "  fi",
            "}",
            "trap tpx_requeue ERR",
            "",
        ]
    srun_groups = []
    for i, rep in enumerate(req.replicas):
        # _dquote (not shlex single-quotes) so runtime macros like
        # ${SLURM_JOB_ID} and $TPX_COORDINATOR_HOST still expand; and
        # ${SLURM_JOB_ID} (the het-leader id, uniform across groups) in the
        # log file names rather than %j (which expands to each het
        # component's own id, breaking log_iter lookup for groups > 0)
        env_prefix = " ".join(
            f"{k}={_dquote(v)}" for k, v in sorted(rep.env.items())
        )
        group = " ".join(
            [
                f"--het-group={i}" if len(req.replicas) > 1 else "",
                *rep.srun_opts,
                f"--output=slurm-${{SLURM_JOB_ID}}-{rep.name}.out",
                f"--error=slurm-${{SLURM_JOB_ID}}-{rep.name}.err",
                ("env " + env_prefix) if env_prefix else "env",
                "bash -c " + _STAMP_WRAPPER,
                " ".join(_dquote(c) for c in rep.cmd),
            ]
        ).strip()
        srun_groups.append(group)
    lines.append("srun " + " : ".join(srun_groups))
    lines.append("")
    return "\n".join(lines)


def _materialize_elastic_script(req: SlurmBatchRequest) -> str:
    """Elastic gang: ONE ranged group (``--nodes=min-max``) instead of het
    groups — slurm may start the job with any node count in range, and a
    ``scontrol requeue`` after a node failure restarts it with whatever
    survives (still >= min), which is the slurm-native shrink-and-restart:
    the analog of the local scheduler's elastic restart and torchrun's
    ``--nnodes min:max`` rendezvous. Each task derives its identity from
    ``SLURM_PROCID``/``SLURM_NTASKS`` at run time, so the restarted world
    re-forms coherently at the new size and user code resumes from its
    checkpoint."""
    assert req.elastic_range is not None
    min_hosts, max_hosts = req.elastic_range
    hpu = max(1, req.elastic_hosts_per_unit)
    # TPX_MIN_REPLICAS is in AppDef units (slices for GPU roles) to match
    # the GKE backend's injection — in-job bootstrap logic shares it
    min_units = max(1, min_hosts // hpu)
    (rep,) = req.replicas
    lines = ["#!/bin/bash"]
    lines.append(f"#SBATCH --nodes={min_hosts}-{max_hosts}")
    lines.extend(f"#SBATCH {opt}" for opt in rep.sbatch_opts)
    lines += [
        "",
        "set -e",
        'export TPX_COORDINATOR_HOST=$(scontrol show hostnames'
        ' "$SLURM_JOB_NODELIST" | head -n 1)',
        f"export TPX_APP_ID=tpx-${{SLURM_JOB_ID}}",
        f"export TPX_STAMP={shlex.quote(EPOCH_STAMPER)}",
        f"export {settings.ENV_TPX_MIN_REPLICAS}={min_units}",
        f"export TPX_HOSTS_PER_UNIT={hpu}",
        "# slurm may start/requeue the ranged job with any node count in",
        "# range; a GPU gang only works in whole-slice multiples, so the",
        "# srun step is clamped to the largest usable multiple and spare",
        "# hosts idle until the next requeue",
        f'TPX_USABLE_NODES=$(( SLURM_JOB_NUM_NODES / {hpu} * {hpu} ))',
        f'if [ "$TPX_USABLE_NODES" -lt {min_units * hpu} ]; then',
        f'  echo "tpx: $SLURM_JOB_NUM_NODES nodes < {min_units * hpu} usable minimum" >&2',
        "  exit 1",
        "fi",
        "",
    ]
    if req.max_retries > 0:
        lines += [
            f"export TPX_MAX_RETRIES={req.max_retries}",
            "tpx_requeue() {",
            '  if [ "${SLURM_RESTART_COUNT:-0}" -lt "$TPX_MAX_RETRIES" ]; then',
            "    # ranged --nodes: the requeued job may restart smaller",
            '    scontrol requeue "$SLURM_JOB_ID"',
            "  fi",
            "}",
            "trap tpx_requeue ERR",
            "",
        ]
    env_prefix = " ".join(
        f"{k}={_dquote(v)}" for k, v in sorted(rep.env.items())
    )
    # the wrapper runs ON each task node (bash -c under srun), where
    # SLURM_PROCID/SLURM_NTASKS are set; single-quoting via shlex defers
    # all expansion from the batch shell to the task shell
    # same drained-pipeline stamping as _STAMP_WRAPPER (see comment there)
    inner = (
        'export TPX_REPLICA_ID="$SLURM_PROCID"'
        ' TPX_NUM_REPLICAS="$SLURM_NTASKS"; set -o pipefail; '
        + "{ ("
        + (("env " + env_prefix + " ") if env_prefix else "")
        + " ".join(_dquote(c) for c in rep.cmd)
        + ') 2>&1 1>&3 | python3 -u -c "$TPX_STAMP" >&2; } 3>&1'
        + ' | python3 -u -c "$TPX_STAMP"'
    )
    lines.append(
        "srun "
        + " ".join(rep.srun_opts)
        # clamp the step to the whole-slice node count computed above
        + ' --nodes="$TPX_USABLE_NODES" --ntasks="$TPX_USABLE_NODES"'
        + f" --output=slurm-${{SLURM_JOB_ID}}-{rep.name}-%t.out"
        + f" --error=slurm-${{SLURM_JOB_ID}}-{rep.name}-%t.err"
        + f" bash -c {shlex.quote(inner)}"
    )
    lines.append("")
    return "\n".join(lines)


# Feature profile for the preflight analyzer (torchx_tpu_torch.analyze): sbatch
# carries multi-role het jobs and exports a TPX_MAX_RETRIES restart budget,
# and sacct requeue records classify preemption — but there is no mount
# materialization, no delete(), and no in-place resize.
CAPABILITIES = SchedulerCapabilities(
    mounts=False,
    multi_role=True,
    multislice=False,
    delete=False,
    resize=False,
    logs=True,
    native_retries=True,
    concrete_resources=True,
    classifies_preemption=True,
    # compute nodes share the cluster network with the control daemon
    metricz_scrape=True,
)


class SlurmScheduler(DirWorkspaceMixin, Scheduler[SlurmBatchRequest]):
    """Submits AppDefs as heterogeneous sbatch jobs."""

    capabilities = CAPABILITIES
    supports_log_windows = True  # wrapper-stamped log lines (_STAMP_WRAPPER)

    def __init__(self, session_name: str) -> None:
        super().__init__(backend="slurm", session_name=session_name)
        self._mem_probe_cache: dict[str, bool] = {}

    def _run_cmd(self, cmd: list[str], **kwargs: Any) -> subprocess.CompletedProcess:
        """Single subprocess seam — tests monkeypatch this. Call sites go
        through :meth:`Scheduler._cmd` so every slurm CLI call gets the
        control-plane deadline, classified retries, and the backend
        breaker."""
        return subprocess.run(cmd, capture_output=True, text=True, **kwargs)

    def run_opts(self) -> runopts:
        opts = runopts()
        opts.add("partition", type_=str, help="slurm partition", default=None)
        opts.add(
            "time", type_=str, help="job time limit (e.g. 2:00:00)", default=None
        )
        opts.add(
            "nomem",
            type_=bool,
            help="do not pass --mem (for clusters with RealMemory"
            " misconfigured; reference analog of the partition mem probe)",
            default=False,
        )
        opts.add(
            "comment", type_=str, help="sbatch --comment metadata", default=None
        )
        return opts | self.workspace_opts()

    def _submit_dryrun(
        self, app: AppDef, cfg: Mapping[str, CfgVal]
    ) -> AppDryRunInfo[SlurmBatchRequest]:
        cfg = dict(cfg)
        if not cfg.get("nomem") and not self._partition_supports_mem(
            cfg.get("partition")
        ):
            # partitions with unset RealMemory reject --mem outright
            # (reference analog: the aws slurm partition memory probe)
            logger.info(
                "partition %s reports no usable RealMemory; dropping --mem",
                cfg.get("partition") or "<default>",
            )
            cfg["nomem"] = True
        elastic_role = next(
            (r for r in app.roles if r.min_replicas is not None), None
        )
        elastic_range: Optional[tuple[int, int]] = None
        if elastic_role is not None:
            if len(app.roles) != 1:
                raise ValueError(
                    "slurm elastic gangs (min_replicas) require a"
                    " single-role app: the ranged --nodes allocation is"
                    " job-wide — split other roles into their own apps"
                )
            # min_replicas is in AppDef units (slices for GPU roles);
            # slurm nodes are hosts, and GPU gangs shrink in whole slices
            hosts_per_unit = (
                elastic_role.resource.gpu.hosts
                if elastic_role.resource is not None
                and elastic_role.resource.gpu is not None
                else 1
            )
            elastic_range = (
                max(1, elastic_role.min_replicas) * hosts_per_unit,
                gpu_hosts_for_role(elastic_role),
            )
            replicas = [_elastic_replica(elastic_role, cfg)]
        else:
            replicas = []
            for role in app.roles:
                replicas.extend(_role_to_replicas(role, cfg))
        cmd = ["sbatch", "--parsable"]
        if cfg.get("comment"):
            cmd.append(f"--comment={cfg['comment']}")
        req = SlurmBatchRequest(
            cmd=cmd,
            replicas=replicas,
            job_dir=str(cfg["job_dir"]) if cfg.get("job_dir") else None,
            max_retries=max((r.max_retries for r in app.roles), default=0),
            elastic_range=elastic_range,
            elastic_hosts_per_unit=(
                hosts_per_unit if elastic_range is not None else 1
            ),
        )
        return AppDryRunInfo(req)

    def _partition_supports_mem(self, partition: Optional[CfgVal]) -> bool:
        """Probe ``sinfo`` for the partition's configured node memory:
        RealMemory=1 (slurm's unset marker) means ``--mem`` requests can
        never be satisfied and must be dropped. Probe failures (no slurm
        on PATH, standalone dryruns) keep --mem. Cached per partition."""
        key = str(partition) if partition else ""
        if key in self._mem_probe_cache:
            return self._mem_probe_cache[key]
        cmd = ["sinfo", "--noheader", "--format=%m"]
        if partition:
            cmd += ["--partition", str(partition)]
        try:
            proc = self._cmd(cmd, op="probe")
        except (OSError, subprocess.SubprocessError):
            self._mem_probe_cache[key] = True
            return True
        if proc.returncode != 0:
            ok = True  # can't probe: keep --mem
        else:
            vals = [v.strip().rstrip("+") for v in proc.stdout.split()]
            ok = not vals or any(v.isdigit() and int(v) > 1 for v in vals)
        self._mem_probe_cache[key] = ok
        return ok

    def schedule(self, dryrun_info: AppDryRunInfo[SlurmBatchRequest]) -> str:
        req = dryrun_info.request
        job_dir = req.job_dir or tempfile.mkdtemp(prefix="tpx_slurm_")
        script_path = os.path.join(job_dir, "tpx_sbatch.sh")
        with open(script_path, "w") as f:
            f.write(req.script())
        proc = self._cmd(
            [*req.cmd, script_path],
            op="submit",
            policy=NON_IDEMPOTENT,
            cwd=job_dir,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"sbatch failed (rc={proc.returncode}):\n{proc.stderr}"
            )
        job_id = proc.stdout.strip().split(";")[0]
        _save_job_dir(job_id, job_dir)
        return job_id

    # -- monitoring --------------------------------------------------------

    def describe(self, app_id: str) -> Optional[DescribeAppResponse]:
        resp = self._describe_squeue(app_id)
        if resp is not None:
            return resp
        return self._describe_sacct(app_id)

    def _describe_squeue(self, app_id: str) -> Optional[DescribeAppResponse]:
        proc = self._cmd(["squeue", "--json", "-j", app_id], op="describe")
        if proc.returncode != 0:
            return None
        try:
            payload = json.loads(proc.stdout)
        except json.JSONDecodeError:
            return None
        jobs = payload.get("jobs") or []
        if not jobs:
            return None
        return _describe_from_squeue_jobs(app_id, jobs)

    def _describe_sacct(self, app_id: str) -> Optional[DescribeAppResponse]:
        proc = self._cmd(
            ["sacct", "--parsable2", "-j", app_id, "--format", "JobID,JobName,State"],
            op="describe",
        )
        if proc.returncode != 0 or not proc.stdout.strip():
            return None
        lines = proc.stdout.strip().splitlines()
        if len(lines) < 2:
            return None
        header = lines[0].split("|")
        roles: dict[str, RoleStatus] = {}
        app_state = AppState.UNKNOWN
        for line in lines[1:]:
            row = dict(zip(header, line.split("|")))
            job_id = row.get("JobID", "")
            if "." in job_id:  # step rows
                continue
            state = slurm_state(row.get("State", ""))
            name = row.get("JobName", "")
            if job_id.split("+")[0] == app_id:
                app_state = state if app_state == AppState.UNKNOWN else app_state
                if _is_worse(state, app_state):
                    app_state = state
            role, _, rep = name.rpartition("-")
            if role and rep.isdigit():
                roles.setdefault(role, RoleStatus(role=role)).replicas.append(
                    ReplicaStatus(id=int(rep), state=state, role=role)
                )
        return DescribeAppResponse(
            app_id=app_id,
            state=app_state,
            roles_statuses=list(roles.values()),
        )

    def list(self) -> list[ListAppResponse]:
        proc = self._cmd(["squeue", "--json", "--me"], op="list")
        if proc.returncode != 0:
            raise RuntimeError(f"squeue failed: {proc.stderr}")
        payload = json.loads(proc.stdout)
        out = []
        for job in payload.get("jobs", []):
            out.append(
                ListAppResponse(
                    app_id=str(job.get("job_id")),
                    state=_squeue_job_state(job),
                    name=job.get("name", ""),
                )
            )
        return out

    def _cancel_existing(self, app_id: str) -> None:
        proc = self._cmd(["scancel", app_id], op="cancel")
        if proc.returncode != 0:
            raise RuntimeError(f"scancel failed: {proc.stderr}")

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
        # the batch-script wrapper stamps every line with epoch millis
        # (``_STAMP_WRAPPER``), so since/until windows apply here the same
        # way they do on the local Tee; stamps are stripped before yielding, and
        # pre-stamping legacy log files pass through unwindowed.
        job_dir = _load_job_dir(app_id)
        if job_dir is None:
            raise RuntimeError(
                f"no job dir recorded for {app_id} in {SLURM_JOB_DIRS_FILE}"
            )
        ext = "err" if streams == Stream.STDERR else "out"
        log_file = os.path.join(job_dir, f"slurm-{app_id}-{role_name}-{k}.{ext}")
        if not os.path.exists(log_file):
            # non-het (single-replica) jobs may write slurm-{id}.out
            fallback = os.path.join(job_dir, f"slurm-{app_id}.{ext}")
            if os.path.exists(fallback):
                log_file = fallback
        lines: Iterable[str] = window_stamped_lines(
            _read_lines(log_file), since, until
        )
        if regex:
            lines = filter_regex(regex, lines)
        return lines


def _read_lines(path: str) -> Iterable[str]:
    if not os.path.exists(path):
        return iter(())
    with open(path, errors="replace") as f:
        return iter(f.read().splitlines())


_STATE_BADNESS = {
    AppState.FAILED: 3,
    AppState.CANCELLED: 2,
    AppState.RUNNING: 1,
}


def _is_worse(a: AppState, b: AppState) -> bool:
    return _STATE_BADNESS.get(a, 0) > _STATE_BADNESS.get(b, 0)


def _squeue_job_nodes(job: Mapping[str, Any]) -> str:
    """Allocated node list across squeue --json format generations:
    pre-23.02 ``job_resources.nodes`` is a string; 24.05 made it an object
    (``{"count": .., "list": [..]}``); some builds use ``allocated_nodes``
    or omit job_resources entirely for pending jobs."""
    res = job.get("job_resources") or {}
    if not isinstance(res, Mapping):
        return ""
    nodes = res.get("nodes", res.get("allocated_nodes", ""))
    if isinstance(nodes, Mapping):
        node_list = nodes.get("list")
        if isinstance(node_list, list):
            return ",".join(str(n) for n in node_list)
        return str(nodes.get("nodes", "") or "")
    if isinstance(nodes, list):  # allocated_nodes: [{"nodename": ...}]
        return ",".join(
            str(n.get("nodename", n) if isinstance(n, Mapping) else n)
            for n in nodes
        )
    return str(nodes or "")


def _squeue_job_state(job: Mapping[str, Any]) -> AppState:
    js = job.get("job_state")
    if isinstance(js, list):
        js = js[0] if js else "UNKNOWN"
    return slurm_state(str(js))


def _describe_from_squeue_jobs(
    app_id: str, jobs: list[Mapping[str, Any]]
) -> DescribeAppResponse:
    roles: dict[str, RoleStatus] = {}
    app_state = AppState.UNKNOWN
    for job in jobs:
        state = _squeue_job_state(job)
        if app_state == AppState.UNKNOWN or _is_worse(state, app_state):
            app_state = state
        name = str(job.get("name", ""))
        role, _, rep = name.rpartition("-")
        if role and rep.isdigit():
            roles.setdefault(role, RoleStatus(role=role)).replicas.append(
                ReplicaStatus(
                    id=int(rep),
                    state=state,
                    role=role,
                    hostname=_squeue_job_nodes(job),
                )
            )
    if not roles:
        # single sbatch job (not hetjob-split): synthesize one role from name
        name = str(jobs[0].get("name", "job"))
        roles[name] = RoleStatus(
            role=name,
            replicas=[ReplicaStatus(id=0, state=app_state, role=name)],
        )
    return DescribeAppResponse(
        app_id=app_id, state=app_state, roles_statuses=list(roles.values())
    )


# =========================================================================
# Job-dir registry (reference :52,913-931)
# =========================================================================


def _registry_path() -> str:
    return os.path.join(os.path.expanduser("~"), SLURM_JOB_DIRS_FILE)


def _save_job_dir(job_id: str, job_dir: str) -> None:
    from torchx_tpu_torch.util import registry

    registry.record(_registry_path(), job_id, job_dir, keep=os.path.isdir)


def _load_job_dir(job_id: str) -> Optional[str]:
    from torchx_tpu_torch.util import registry

    return registry.lookup(_registry_path(), job_id)


def create_scheduler(session_name: str, **kwargs: Any) -> SlurmScheduler:
    return SlurmScheduler(session_name=session_name)
