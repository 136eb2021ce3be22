"""Docker scheduler: one container per replica on a shared network.

The port's copy of :mod:`torchx_tpu.schedulers.docker_scheduler`, with a
GPU request in place of the TPU device nodes. Reference analog:
torchx/schedulers/docker_scheduler.py (503 LoC). Kept design: all
replicas of an app share a user-defined bridge network; the coordinator
host is the *container name* of role-0/replica-0 (docker's embedded DNS
resolves container names on user networks — the analog of
``TORCHX_RANK0_HOST`` = container name at reference :243,290); resource
limits map to mem_limit/nano_cpus; ``restart_policy: on-failure`` carries
``max_retries`` (reference :316-320); logs stream through the docker logs
API.

A GPU role's replica gets its share of the cards the CUDA driver sees on
the docker host through the NVIDIA container toolkit's GPU request
(``device_requests``: driver ``nvidia``, capability ``gpu``, the cards by
UUID), split between the role's replicas as the local scheduler splits
``CUDA_VISIBLE_DEVICES`` (:func:`~.devices.gpu_device_request`). The
toolkit also gives the container the driver's libraries. The role's
``nvidia.com/gpu`` named device is that same request, so it mounts no
``/dev/nvidia<N>`` node; a role with that count and no GPU slice (a mixed
fleet's GPU job) asks for the same request with that many cards a
replica, where the JAX copy mounts ``/dev/nvidia0 .. n-1``.

The docker SDK import is deferred and injectable so dryrun tests run
without a daemon.
"""

from __future__ import annotations

import fnmatch
import logging
import os
from dataclasses import dataclass, field
from typing import Any, Iterable, Mapping, Optional, TYPE_CHECKING

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
    role_replica_env,
    gpu_hosts_for_role,
)
from torchx_tpu_torch.schedulers.devices import get_device_mounts, gpu_device_request
from torchx_tpu_torch.schedulers.ids import make_unique
from torchx_tpu_torch.specs.api import (
    AppDef,
    AppDryRunInfo,
    AppState,
    BindMount,
    CfgVal,
    DeviceMount,
    ReplicaStatus,
    RoleStatus,
    VolumeMount,
    macros,
    runopts,
)
from torchx_tpu_torch.workspace.docker_workspace import DockerWorkspaceMixin

if TYPE_CHECKING:
    from docker import DockerClient

logger = logging.getLogger(__name__)

NETWORK_NAME = "tpx"
LABEL_APP_ID = "tpx.sh/app-id"
LABEL_ROLE = "tpx.sh/role-name"
LABEL_REPLICA = "tpx.sh/replica-id"

CONTAINER_STATE_MAP = {
    "created": AppState.SUBMITTED,
    "restarting": AppState.RUNNING,
    "running": AppState.RUNNING,
    "paused": AppState.PENDING,
    "removing": AppState.RUNNING,
    "dead": AppState.FAILED,
}


@dataclass
class DockerContainer:
    image: str
    command: list[str]
    kwargs: dict[str, Any]  # passed to client.containers.run


@dataclass
class DockerJob:
    app_id: str
    containers: list[DockerContainer] = field(default_factory=list)

    def __str__(self) -> str:
        import json

        return json.dumps(
            [
                {"image": c.image, "command": c.command, **c.kwargs}
                for c in self.containers
            ],
            indent=2,
            default=str,
        )


# Feature profile for the preflight analyzer (torchx_tpu_torch.analyze): docker
# materializes mounts and honors MaximumRetryCount, but one daemon on one
# host cannot wire multi-slice DCN training or classify spot reclamation.
CAPABILITIES = SchedulerCapabilities(
    mounts=True,
    multi_role=True,
    multislice=False,
    delete=True,
    resize=False,
    logs=True,
    native_retries=True,
    concrete_resources=False,  # unset cpu/memMB simply means "no limits"
    classifies_preemption=False,
    # published container ports are scrapeable from the docker host
    metricz_scrape=True,
)


class DockerScheduler(DockerWorkspaceMixin, Scheduler[DockerJob]):
    capabilities = CAPABILITIES
    supports_log_windows = True  # docker daemon applies since/until
    def __init__(
        self,
        session_name: str,
        docker_client: Optional["DockerClient"] = None,
    ) -> None:
        super().__init__(
            docker_client=docker_client, backend="local_docker", session_name=session_name
        )

    @property
    def _client(self) -> "DockerClient":
        return self._docker_client

    def run_opts(self) -> runopts:
        opts = runopts()
        opts.add(
            "copy_env",
            type_=list,
            help="glob patterns of client env vars to copy into containers",
            default=None,
        )
        opts.add(
            "env",
            type_=dict,
            help="extra env vars for all containers",
            default=None,
        )
        opts.add(
            "privileged",
            type_=bool,
            help="run containers privileged (a GPU role's cards come through the"
            " NVIDIA container toolkit's device request and need no privilege)",
            default=False,
        )
        return opts | self.workspace_opts()

    def _submit_dryrun(
        self, app: AppDef, cfg: Mapping[str, CfgVal]
    ) -> AppDryRunInfo[DockerJob]:
        app_id = make_unique(app.name)
        req = DockerJob(app_id=app_id)
        copy_env = cfg.get("copy_env") or []
        extra_env = cfg.get("env") or {}

        coordinator = f"{app_id}-{app.roles[0].name}-0"
        for role in app.roles:
            num = gpu_hosts_for_role(role)
            for replica_id in range(num):
                values = macros.Values(
                    img_root="",
                    app_id=app_id,
                    replica_id=str(replica_id),
                    num_replicas=str(num),
                    coordinator_env=settings.ENV_TPX_COORDINATOR_HOST,
                )
                rrole = values.apply(role)
                name = f"{app_id}-{role.name}-{replica_id}"
                env = dict(rrole.env)
                if copy_env:
                    for pat in copy_env:
                        for k, v in os.environ.items():
                            if fnmatch.fnmatch(k, str(pat)):
                                env.setdefault(k, v)
                env.update({k: str(v) for k, v in dict(extra_env).items()})
                env[settings.ENV_TPX_APP_ID] = app_id
                env[settings.ENV_TPX_JOB_ID] = (
                    f"{self.backend}://{self.session_name}/{app_id}"
                )
                env[settings.ENV_TPX_ERROR_FILE] = "/tmp/tpx_error.json"
                env.update(
                    role_replica_env(
                        role,
                        replica_id,
                        coordinator_host=coordinator,
                        coordinator_port=settings.TPX_COORDINATOR_PORT,
                    )
                )

                mounts = []
                devices = []
                for m in rrole.mounts:
                    if isinstance(m, BindMount):
                        mounts.append(
                            {
                                "type": "bind",
                                "source": m.src_path,
                                "target": m.dst_path,
                                "read_only": m.read_only,
                            }
                        )
                    elif isinstance(m, VolumeMount):
                        mounts.append(
                            {
                                "type": "volume",
                                "source": m.src,
                                "target": m.dst_path,
                                "read_only": m.read_only,
                            }
                        )
                    elif isinstance(m, DeviceMount):
                        devices.append(f"{m.src_path}:{m.dst_path}:{m.permissions}")
                gpu = rrole.resource.gpu
                # a replica's cards a host: its GPU slice's, else a named
                # nvidia.com/gpu count (a mixed fleet's GPU job); either is
                # its device request below, never /dev/nvidia<N> mounts
                gpus_per_host = (
                    gpu.gpus_per_host if gpu is not None
                    else int(rrole.resource.devices.get("nvidia.com/gpu", 0))
                )
                # the other named devices (e.g. the EFA NIC) map to mounts
                named = {k: v for k, v in rrole.resource.devices.items()
                         if k != "nvidia.com/gpu"}
                for dm in get_device_mounts(named):
                    devices.append(f"{dm.src_path}:{dm.dst_path}:{dm.permissions}")

                kwargs: dict[str, Any] = {
                    "name": name,
                    "environment": env,
                    "labels": {
                        LABEL_APP_ID: app_id,
                        LABEL_ROLE: role.name,
                        LABEL_REPLICA: str(replica_id),
                    },
                    "hostname": name,
                    "network": NETWORK_NAME,
                    "detach": True,
                }
                if mounts:
                    kwargs["mounts"] = mounts
                if devices:
                    kwargs["devices"] = devices
                if gpus_per_host > 0:  # this replica's share of the host's cards
                    kwargs["device_requests"] = [
                        gpu_device_request(gpus_per_host, replica_id, num)
                    ]
                if cfg.get("privileged"):
                    kwargs["privileged"] = True
                if rrole.max_retries > 0:
                    kwargs["restart_policy"] = {
                        "Name": "on-failure",
                        "MaximumRetryCount": rrole.max_retries,
                    }
                if rrole.resource.memMB > 0:
                    kwargs["mem_limit"] = f"{int(rrole.resource.memMB)}m"
                if rrole.resource.cpu > 0:
                    kwargs["nano_cpus"] = int(rrole.resource.cpu * 1e9)

                req.containers.append(
                    DockerContainer(
                        image=rrole.image,
                        command=[rrole.entrypoint, *rrole.args],
                        kwargs=kwargs,
                    )
                )
        return AppDryRunInfo(req)

    def schedule(self, dryrun_info: AppDryRunInfo[DockerJob]) -> str:
        req = dryrun_info.request
        self._ensure_network()
        try:
            for c in req.containers:
                resilient_call(
                    lambda c=c: self._client.containers.run(
                        c.image, c.command, **c.kwargs
                    ),
                    backend=self.backend,
                    op="submit",
                    policy=NON_IDEMPOTENT,
                )
        except Exception:
            self._cancel_existing(req.app_id)
            raise
        return req.app_id

    def _ensure_network(self) -> None:
        try:
            self._client.networks.create(
                NETWORK_NAME, driver="bridge", check_duplicate=True
            )
        except Exception as e:  # noqa: BLE001 - racing creates are fine
            if "already exists" not in str(e):
                logger.debug("network create: %s", e)

    def _containers(self, app_id: str) -> list[Any]:
        return resilient_call(
            lambda: self._client.containers.list(
                all=True, filters={"label": f"{LABEL_APP_ID}={app_id}"}
            ),
            backend=self.backend,
            op="describe",
        )

    def describe(self, app_id: str) -> Optional[DescribeAppResponse]:
        containers = self._containers(app_id)
        if not containers:
            return None
        roles: dict[str, RoleStatus] = {}
        states = []
        for c in containers:
            role = c.labels.get(LABEL_ROLE, "unknown")
            replica = int(c.labels.get(LABEL_REPLICA, 0))
            if c.status == "exited":
                rc = (c.attrs.get("State") or {}).get("ExitCode", 0)
                state = AppState.SUCCEEDED if rc == 0 else AppState.FAILED
            else:
                state = CONTAINER_STATE_MAP.get(c.status, AppState.UNKNOWN)
            states.append(state)
            roles.setdefault(role, RoleStatus(role=role)).replicas.append(
                ReplicaStatus(id=replica, state=state, role=role, hostname=c.name)
            )
        return DescribeAppResponse(
            app_id=app_id,
            state=_aggregate_states(states),
            roles_statuses=list(roles.values()),
        )

    def list(self) -> list[ListAppResponse]:
        containers = resilient_call(
            lambda: self._client.containers.list(
                all=True, filters={"label": LABEL_APP_ID}
            ),
            backend=self.backend,
            op="list",
        )
        per_app: dict[str, list[AppState]] = {}
        for c in containers:
            app_id = c.labels.get(LABEL_APP_ID, "")
            state = CONTAINER_STATE_MAP.get(c.status, AppState.UNKNOWN)
            if c.status == "exited":
                rc = (c.attrs.get("State") or {}).get("ExitCode", 0)
                state = AppState.SUCCEEDED if rc == 0 else AppState.FAILED
            per_app.setdefault(app_id, []).append(state)
        return [
            ListAppResponse(app_id=app_id, state=_aggregate_states(states))
            for app_id, states in per_app.items()
        ]

    def _cancel_existing(self, app_id: str) -> None:
        for c in self._containers(app_id):
            try:
                c.stop(timeout=10)
            except Exception as e:  # noqa: BLE001
                logger.warning("stopping %s: %s", c.name, e)

    def delete(self, app_id: str) -> None:
        for c in self._containers(app_id):
            c.remove(force=True)

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
        containers = self._client.containers.list(
            all=True,
            filters={
                "label": [
                    f"{LABEL_APP_ID}={app_id}",
                    f"{LABEL_ROLE}={role_name}",
                    f"{LABEL_REPLICA}={k}",
                ]
            },
        )
        if not containers:
            raise ValueError(f"no container for {app_id}/{role_name}/{k}")
        c = containers[0]
        kwargs: dict[str, Any] = {
            "stdout": streams in (None, Stream.COMBINED, Stream.STDOUT),
            "stderr": streams in (None, Stream.COMBINED, Stream.STDERR),
        }
        if since:
            kwargs["since"] = since
        if until:
            kwargs["until"] = until
        if should_tail:
            raw = c.logs(stream=True, follow=True, **kwargs)
            lines: Iterable[str] = (
                ln.decode("utf-8", errors="replace").rstrip("\n") for ln in raw
            )
        else:
            raw = c.logs(**kwargs)
            lines = raw.decode("utf-8", errors="replace").splitlines()
        if regex:
            lines = filter_regex(regex, lines)
        return lines


def _aggregate_states(states: list[AppState]) -> AppState:
    """Gang aggregation: any FAILED fails the app; any RUNNING keeps it
    running (a partially-finished gang is not terminal); all SUCCEEDED
    succeeds."""
    if not states:
        return AppState.UNKNOWN
    if any(s == AppState.FAILED for s in states):
        return AppState.FAILED
    if any(s == AppState.RUNNING for s in states):
        return AppState.RUNNING
    if all(s == AppState.SUCCEEDED for s in states):
        return AppState.SUCCEEDED
    return states[0]


def create_scheduler(session_name: str, **kwargs: Any) -> DockerScheduler:
    known = {"docker_client"}
    return DockerScheduler(
        session_name=session_name,
        **{k: v for k, v in kwargs.items() if k in known},
    )
