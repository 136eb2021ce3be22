"""Local scheduler: runs each replica as a host subprocess.

The port's copy of :mod:`torchx_tpu.schedulers.local_scheduler`. Reference
analog: torchx/schedulers/local_scheduler.py (1211 LoC). Kept behaviors:
ImageProvider abstraction, per-replica log dirs with stdout/stderr/combined
Tee, macro substitution, coordinator env injection, error-file injection,
LRU app cache, SIGTERM->SIGKILL kill ladder, orphan cleanup on client
signals, tail-follow log iteration.

On a GPU host:

* replicas of a GPU role get their share of the host's cards as
  ``CUDA_VISIBLE_DEVICES`` (``auto_set_cuda_visible_devices``, the
  reference's own partitioning, :855-945): replica ``i`` sees the role's
  ``gpus_per_host`` cards from ``i * gpus_per_host`` on, and ``spmd_main``
  starts one worker a card it sees. The host's cards are the launcher's own
  ``CUDA_VISIBLE_DEVICES``, else the CUDA driver's count. A gang that asks
  for more cards than the host has is refused at dryrun;
* a GPU role on a host with no card is refused at dryrun too, unless the
  caller asks for the CPU with ``gpu_simulate=True``: the replica then sees
  no card (``CUDA_VISIBLE_DEVICES=""``) and the role's own arguments choose
  the CPU (``spmd_main --nproc-per-node N`` on gloo). Nothing runs a GPU
  role on the CPU unless asked;
* the injected rendezvous env is ``TPX_COORDINATOR_HOST=localhost`` plus the
  gang identity vars consumed by ``torchx_tpu_torch.distributed.gang_info``
  (the analog of TORCHX_RANK0_HOST at reference :990-993).

Its state is the port's own: the per-user registry ``~/.tpx_torch_local_apps``
and the default log root ``<tmp>/torchx_tpu_torch/<session>``, so that this
launcher and the JAX package's never list or cancel each other's jobs.
"""

from __future__ import annotations

import logging
import os
import signal
import subprocess
import tempfile
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, IO, Iterable, Mapping, Optional, TextIO

from torchx_tpu_torch import settings
from torchx_tpu_torch.resilience.call import resilient_call
from torchx_tpu_torch.schedulers.api import (
    DescribeAppResponse,
    ListAppResponse,
    Scheduler,
    SchedulerCapabilities,
    Stream,
    filter_regex,
    gpu_hosts_for_role,
    role_replica_env,
    window_stamped_lines,
)
from torchx_tpu_torch.schedulers.ids import make_unique
from torchx_tpu_torch.schedulers.streams import Tee
from torchx_tpu_torch.specs.api import (
    AppDef,
    AppDryRunInfo,
    AppState,
    CfgVal,
    NONE,
    ReplicaStatus,
    RetryPolicy,
    Role,
    RoleStatus,
    is_terminal,
    macros,
    runopts,
)

logger = logging.getLogger(__name__)

KILL_GRACE_SECONDS = 10
APP_CACHE_SIZE = 100

# Cross-process visibility: each app's owning scheduler writes a state file
# under its log dir and records app_id -> log_dir in a per-user registry,
# so `tpx status`/`tpx log` from ANOTHER process can still find and read it
# (the reference's local scheduler is in-process only; log files were
# always on disk — this makes the metadata reachable too).
STATE_FILE = ".tpx_state.json"

#: per-replica exit-code sidecar written by the /bin/sh launch wrapper;
#: read by _describe_external to recover terminal state after the owning
#: client process crashed (its in-memory Popen handles died with it).
EXITCODE_FILE = "exitcode"
APPS_REGISTRY = ".tpx_torch_local_apps"


def _registry_path() -> str:
    return os.path.join(os.path.expanduser("~"), APPS_REGISTRY)


def _registry_record(app_id: str, log_dir: str) -> None:
    from torchx_tpu_torch.util import registry

    # compaction drops entries whose log dirs are gone; lock-protected so
    # concurrent submits never lose each other's lines
    registry.record(_registry_path(), app_id, log_dir, keep=os.path.isdir)


def _registry_entries() -> list[tuple[str, str]]:
    from torchx_tpu_torch.util import registry

    return registry.entries(_registry_path())


def _registry_lookup(app_id: str) -> Optional[str]:
    from torchx_tpu_torch.util import registry

    return registry.lookup(_registry_path(), app_id)


def _recover_sidecar_state(log_dir: str, payload: dict) -> AppState:
    """Terminal state of a crashed-owner app from exit-code sidecars.

    The owner process died before writing a terminal state (SIGKILL, OOM,
    power loss), but each replica's /bin/sh launch wrapper durably wrote
    its exit code. All replicas 0 -> SUCCEEDED; any nonzero -> FAILED; any
    sidecar missing (replica still running when the machine died, or a
    pre-sidecar writer) -> UNKNOWN, exactly the pre-recovery behavior. A
    SUCCESS marker short-circuits (the owner DID finish; only the state
    file write was lost)."""
    if os.path.exists(os.path.join(log_dir, "SUCCESS")):
        return AppState.SUCCEEDED
    codes: list[int] = []
    for role_name, replicas in payload.get("roles", {}).items():
        for r in replicas:
            rc_file = os.path.join(
                log_dir, role_name, str(r.get("id", 0)), EXITCODE_FILE
            )
            try:
                with open(rc_file) as f:
                    codes.append(int(f.read().strip()))
            except (OSError, ValueError):
                return AppState.UNKNOWN
    if not codes:
        return AppState.UNKNOWN
    return AppState.SUCCEEDED if all(c == 0 for c in codes) else AppState.FAILED


def _state_file_says_cancelled(log_dir: str) -> bool:
    import json

    try:
        with open(os.path.join(log_dir, STATE_FILE)) as f:
            return json.load(f).get("state") == AppState.CANCELLED.name
    except (OSError, json.JSONDecodeError):
        return False


def _atomic_write_json(path: str, payload: dict) -> None:
    """Unique-tmp + os.replace: concurrent writers (owner vs external
    canceller) can't truncate each other's in-flight tmp, and readers
    never observe partial JSON."""
    import json
    import tempfile as _tempfile

    fd, tmp = _tempfile.mkstemp(dir=os.path.dirname(path), prefix=".tpx_state_")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _pid_start_time(pid: int) -> Optional[int]:
    """Process start time (clock ticks) from /proc — disambiguates pid
    reuse. None where /proc is unavailable."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            fields = f.read().rsplit(") ", 1)[-1].split()
        return int(fields[19])  # starttime is field 22 overall
    except (OSError, ValueError, IndexError):
        return None


def _pid_alive(pid: int, start_time: Optional[int] = None) -> bool:
    try:
        os.kill(pid, 0)
    except (ProcessLookupError, PermissionError):
        return False
    if start_time is not None:
        current = _pid_start_time(pid)
        if current is not None and current != start_time:
            return False  # pid was reused by an unrelated process
    return True


# =========================================================================
# Image providers
# =========================================================================


class ImageProvider:
    """Resolves a Role.image to a local directory (reference :110-279)."""

    def fetch(self, image: str) -> str:
        """Returns the root dir for the image; '' means no chroot."""
        raise NotImplementedError

    def get_entrypoint(self, img_root: str, role_args_entrypoint: str) -> str:
        entrypoint = role_args_entrypoint
        if img_root and not os.path.isabs(entrypoint):
            candidate = os.path.join(img_root, entrypoint)
            if os.path.exists(candidate):
                return candidate
        return entrypoint


class LocalDirectoryImageProvider(ImageProvider):
    """image is an existing local directory path."""

    def fetch(self, image: str) -> str:
        if not os.path.isdir(image):
            raise ValueError(
                f"image {image!r} must be an existing local directory"
                " for the local scheduler"
            )
        return image


class CWDImageProvider(ImageProvider):
    """ignore image entirely; run from the current working directory."""

    def fetch(self, image: str) -> str:
        return os.getcwd()


# =========================================================================
# GPU host inventory / partitioning
# =========================================================================


def driver_gpu_count() -> int:
    """Cards the CUDA driver gives this process (``cuInit`` and
    ``cuDeviceGetCount`` of ``libcuda`` through ctypes, no torch): the count
    ``torch.cuda.device_count()`` reports. 0 where no driver loads or it
    finds no device. The ``/dev/nvidia<N>`` nodes are no count: a container
    may hold the node of a card it cannot use (an H100 machine of one card
    had ``nvidia0`` and ``nvidia7``)."""
    import ctypes

    try:
        lib = ctypes.CDLL("libcuda.so.1")
    except OSError:
        return 0
    count = ctypes.c_int(0)
    if lib.cuInit(0) != 0 or lib.cuDeviceGetCount(ctypes.byref(count)) != 0:
        return 0
    return count.value


def driver_gpu_uuids() -> list[str]:
    """The UUIDs of the cards the CUDA driver gives this process, in ordinal
    order, as ``nvidia-smi`` and the NVIDIA container toolkit name them:
    ``GPU-`` and the UUID's 8-4-4-4-12 hex groups (``cuDeviceGet`` and
    ``cuDeviceGetUuid`` of ``libcuda`` through ctypes, no torch). A CUDA
    ordinal need not be ``nvidia-smi``'s index (CUDA orders fastest first,
    nvidia-smi by PCI bus, and the launcher's ``CUDA_VISIBLE_DEVICES``
    renumbers), a UUID names one card everywhere. [] where no driver loads
    or it finds no device."""
    import ctypes

    try:
        lib = ctypes.CDLL("libcuda.so.1")
    except OSError:
        return []
    count = ctypes.c_int(0)
    if lib.cuInit(0) != 0 or lib.cuDeviceGetCount(ctypes.byref(count)) != 0:
        return []
    uuids = []
    for ordinal in range(count.value):
        dev, raw = ctypes.c_int(0), (ctypes.c_ubyte * 16)()
        if lib.cuDeviceGet(ctypes.byref(dev), ordinal) != 0 or lib.cuDeviceGetUuid(raw, dev) != 0:
            return []
        h = bytes(raw).hex()
        uuids.append(f"GPU-{h[:8]}-{h[8:12]}-{h[12:16]}-{h[16:20]}-{h[20:]}")
    return uuids


def local_gpus() -> list[str]:
    """The cards this launcher may hand out, as ``CUDA_VISIBLE_DEVICES``
    entries, found without importing torch.

    Where the launcher's own ``CUDA_VISIBLE_DEVICES`` is set, that list wins
    (its entries, in order; set but empty means no card): the launcher then
    partitions what it was itself given, and replica ``i``'s entries index
    into that list. Otherwise the CUDA driver's count does
    (:func:`driver_gpu_count`), as ordinals ``0 .. n-1``."""
    raw = os.environ.get(settings.ENV_CUDA_VISIBLE_DEVICES)
    if raw is not None:
        return [d.strip() for d in raw.split(",") if d.strip()]
    return [str(i) for i in range(driver_gpu_count())]


def local_gpu_count() -> int:
    """Cards on this host, as :func:`local_gpus` finds them."""
    return len(local_gpus())


def gpu_device_env(
    gpus_per_host: int,
    replica_id: int,
    replicas_on_host: int,
    host_gpus: list[str],
    simulate: bool,
    partition: bool = True,
) -> dict[str, str]:
    """``CUDA_VISIBLE_DEVICES`` for one replica of a GPU role: replica ``i``
    of the ``replicas_on_host`` colocated replicas sees the cards
    ``[i * gpus_per_host, (i + 1) * gpus_per_host)`` of ``host_gpus`` (the
    ``CUDA_VISIBLE_DEVICES`` entries of :func:`local_gpus`), the reference's
    ``auto_set_cuda_visible_devices`` (local_scheduler.py:855-945). A
    replica sees its role's cards and no more, since ``spmd_main`` starts
    one worker a card it sees.

    Raises at dryrun time rather than wedging a collective at run time:
    when the gang asks for more cards than the host has, and when the host
    has no card and ``simulate`` is off. With ``simulate`` a card-less host
    gives the replica no card (``CUDA_VISIBLE_DEVICES=""``). With
    ``partition`` off the replica inherits the launcher's view unchanged.
    """
    if not host_gpus:
        if not simulate:
            raise ValueError(
                f"the role asks for {gpus_per_host} GPU(s) a host but this host has"
                " no card; pass gpu_simulate=True to run it with no card visible"
                " (its arguments must then ask for the CPU)"
            )
        return {settings.ENV_CUDA_VISIBLE_DEVICES: ""}
    if not partition:
        return {}  # replica sees what the launcher sees
    share = gpu_share(gpus_per_host, replica_id, replicas_on_host, host_gpus,
                      remedy="reduce the slice or the replicas, or disable"
                      " auto_set_cuda_visible_devices")
    return {settings.ENV_CUDA_VISIBLE_DEVICES: ",".join(share)}


def gpu_share(
    gpus_per_host: int,
    replica_id: int,
    replicas_on_host: int,
    host_gpus: list[str],
    remedy: str = "reduce the slice or the replicas",
) -> list[str]:
    """Replica ``i``'s cards among ``replicas_on_host`` colocated replicas:
    ``host_gpus[i * gpus_per_host:(i + 1) * gpus_per_host]``, the split of
    :func:`gpu_device_env` and of the docker backend's GPU request. Raises
    naming ``remedy`` when the replicas ask for more cards than the host
    has."""
    wanted = gpus_per_host * replicas_on_host
    if wanted > len(host_gpus):
        raise ValueError(
            f"{replicas_on_host} replica(s) of {gpus_per_host} GPU(s) each need"
            f" {wanted} cards, and this host has {len(host_gpus)}; {remedy}"
        )
    start = (replica_id % replicas_on_host) * gpus_per_host
    return host_gpus[start:start + gpus_per_host]


def _slice_hosts(role: Role) -> int:
    """Hosts in one slice of the role: a GPU role's ``gpu.hosts``, else 1
    (the unit a gang grows and shrinks by)."""
    if role.resource is not None and role.resource.gpu is not None:
        return role.resource.gpu.hosts
    return 1


# =========================================================================
# Materialized request
# =========================================================================


@dataclass
class ReplicaParam:
    """Everything needed to Popen one replica (pre-substituted)."""

    args: list[str]
    env: dict[str, str]
    stdout: str
    stderr: str
    combined: str
    cwd: Optional[str] = None


@dataclass
class PopenRequest:
    app_id: str
    log_dir: str
    role_params: dict[str, list[ReplicaParam]] = field(default_factory=dict)
    # retained for elastic restarts: rebuilding a SMALLER gang needs the
    # original roles (min_replicas/max_retries) and submit-time cfg
    app: Optional[AppDef] = None
    cfg: dict[str, CfgVal] = field(default_factory=dict)


# =========================================================================
# Live process bookkeeping
# =========================================================================


class _LocalReplica:
    def __init__(
        self,
        role_name: str,
        replica_id: int,
        proc: subprocess.Popen,
        stdout: Optional[IO],
        stderr: Optional[IO],
        tee: Optional[Tee],
        error_file: str,
    ) -> None:
        self.role_name = role_name
        self.replica_id = replica_id
        self.proc = proc
        self.stdout = stdout
        self.stderr = stderr
        self.tee = tee
        self.error_file = error_file

    def terminate(self) -> None:
        """SIGTERM the whole process group, wait, then SIGKILL survivors."""
        try:
            pgid = os.getpgid(self.proc.pid)
            os.killpg(pgid, signal.SIGTERM)
        except ProcessLookupError:
            pass
        try:
            self.proc.wait(timeout=KILL_GRACE_SECONDS)
        except subprocess.TimeoutExpired:
            try:
                os.killpg(os.getpgid(self.proc.pid), signal.SIGKILL)
            except ProcessLookupError:
                pass
            self.proc.wait()
        self._close_files()

    def _close_files(self) -> None:
        if self.tee:
            self.tee.close()
            self.tee = None
        for f in (self.stdout, self.stderr):
            if f:
                f.close()
        self.stdout = self.stderr = None

    def is_alive(self) -> bool:
        return self.proc.poll() is None

    def failed(self) -> bool:
        rc = self.proc.returncode
        return rc is not None and rc != 0


class _LocalApp:
    def __init__(
        self,
        app_id: str,
        log_dir: str,
        request: Optional[PopenRequest] = None,
    ) -> None:
        self.app_id = app_id
        self.log_dir = log_dir
        self.roles: dict[str, list[_LocalReplica]] = {}
        self.state = AppState.PENDING
        self.last_updated = time.time()
        self.request = request  # for elastic gang rebuilds
        self.num_restarts = 0  # app-wide total (surfaced in describe)
        self.role_restarts: dict[str, int] = {}  # per-role budget tracking

    def write_state_file(self) -> None:
        """Snapshot for cross-process status/log (best-effort)."""
        import json

        payload = {
            "app_id": self.app_id,
            "state": self.state.name,
            "log_dir": self.log_dir,
            "roles": {
                name: [
                    {
                        "id": r.replica_id,
                        "pid": r.proc.pid,
                        "pid_start": _pid_start_time(r.proc.pid),
                    }
                    for r in replicas
                ]
                for name, replicas in self.roles.items()
            },
        }
        try:
            os.makedirs(self.log_dir, exist_ok=True)
            _atomic_write_json(os.path.join(self.log_dir, STATE_FILE), payload)
        except OSError as e:
            logger.debug("could not write state file: %s", e)

    def add_replica(self, role_name: str, replica: _LocalReplica) -> None:
        self.roles.setdefault(role_name, []).append(replica)

    def replicas(self) -> Iterable[_LocalReplica]:
        for rs in self.roles.values():
            yield from rs

    def set_state(self, state: AppState) -> None:
        self.state = state
        self.last_updated = time.time()
        self.write_state_file()

    def kill(self) -> None:
        for r in self.replicas():
            r.terminate()
        if not is_terminal(self.state):
            self.set_state(AppState.CANCELLED)

    def first_error_file(self) -> str:
        """Earliest-written error file among failed replicas (reference
        _LocalAppDef._get_error_file, :422-433)."""
        candidates = [
            r.error_file
            for r in self.replicas()
            if r.failed() and os.path.exists(r.error_file)
        ]
        if not candidates:
            return ""
        return min(candidates, key=lambda p: os.path.getmtime(p))


# =========================================================================
# Scheduler
# =========================================================================


# Feature profile for the preflight analyzer (torchx_tpu_torch.analyze): local
# subprocesses simulate gangs, multi-slice identity env, elastic restarts
# and (via TPX_SIMULATE_PREEMPTION_EXIT) preemption classification — but
# mounts are silently ignored by Popen, so they are declared unsupported.
CAPABILITIES = SchedulerCapabilities(
    mounts=False,
    multi_role=True,
    multislice=True,
    delete=True,
    resize=True,
    logs=True,
    native_retries=True,
    concrete_resources=False,
    classifies_preemption=True,
    # native event source: the state file + exitcode sidecars every job
    # leaves next to its logs (see LocalScheduler.watch)
    watch=True,
    # replicas bind loopback ports the daemon's collector can scrape
    metricz_scrape=True,
)


class LocalScheduler(Scheduler[PopenRequest]):
    """Executes AppDef roles as local subprocesses."""

    capabilities = CAPABILITIES

    # combined.log lines are epoch-stamped by the Tee (streams.py), so
    # since/until windows are honored on the default combined stream
    supports_log_windows = True

    def __init__(
        self,
        session_name: str,
        image_provider: Optional[ImageProvider] = None,
        cache_size: int = APP_CACHE_SIZE,
        extra_paths: Optional[list[str]] = None,
    ) -> None:
        super().__init__("local", session_name)
        self._image_provider = image_provider or CWDImageProvider()
        self._apps: dict[str, _LocalApp] = {}
        self._external_dirs: dict[str, str] = {}  # app_id -> log_dir cache
        self._cache_size = cache_size
        self._extra_paths = extra_paths or []
        self._installed_signal_cleanup = False

    # -- runopts ----------------------------------------------------------

    def run_opts(self) -> runopts:
        opts = runopts()
        opts.add(
            "log_dir",
            type_=str,
            default=None,
            help="root dir for per-replica logs (default: a tmp dir)",
        )
        opts.add(
            "prepend_cwd",
            type_=bool,
            default=False,
            help="prepend CWD to PATH when resolving entrypoints",
        )
        opts.add(
            "auto_set_cuda_visible_devices",
            type_=bool,
            default=True,
            help="give each replica of a GPU role its share of the host's"
            " cards via CUDA_VISIBLE_DEVICES",
        )
        opts.add(
            "gpu_simulate",
            type_=bool,
            default=False,
            help="when a role requests GPUs but this host has no card, run"
            " it anyway with no card visible (CUDA_VISIBLE_DEVICES=''; the"
            " role's arguments must ask for the CPU); off, such a role is"
            " refused at dryrun",
        )
        return opts

    # -- dryrun -----------------------------------------------------------

    def _submit_dryrun(
        self, app: AppDef, cfg: Mapping[str, CfgVal]
    ) -> AppDryRunInfo[PopenRequest]:
        app_id = make_unique(app.name)
        base_log_dir = cfg.get("log_dir") or os.path.join(
            tempfile.gettempdir(), "torchx_tpu_torch", self.session_name
        )
        log_dir = os.path.join(str(base_log_dir), app_id)
        request = PopenRequest(
            app_id=app_id, log_dir=log_dir, app=app, cfg=dict(cfg)
        )
        for role in app.roles:
            request.role_params[role.name] = self._build_role_replicas(
                role, app_id, log_dir, cfg
            )
        return AppDryRunInfo(request, fmt=_pretty_request)

    def _build_role_replicas(
        self,
        role: Role,
        app_id: str,
        log_dir: str,
        cfg: Mapping[str, CfgVal],
        num_replicas: Optional[int] = None,
    ) -> list[ReplicaParam]:
        """Materialize the Popen params for one role's gang.

        ``num_replicas`` overrides the role-derived gang size — the elastic
        restart path rebuilds a SMALLER world after host loss (every replica
        gets fresh TPX_NUM_REPLICAS / TPX_REPLICA_ID for the resized mesh).
        """
        img_root = self._image_provider.fetch(role.image)
        replicas: list[ReplicaParam] = []
        host_gpus: Optional[list[str]] = None  # counted for a GPU role only
        if num_replicas is None:
            num_replicas = gpu_hosts_for_role(role)
        else:
            # elastic resize: rebuild the role at the new world size so
            # EVERY derived env agrees (TPX_NUM_REPLICAS, slice
            # decomposition) — not just a patched world size. For GPU
            # roles num_replicas is in host units and the caller
            # guarantees it is a whole-slice multiple.
            hosts = _slice_hosts(role)
            import dataclasses as _dc

            role = _dc.replace(role, num_replicas=num_replicas // hosts)
        for replica_id in range(num_replicas):
            values = macros.Values(
                img_root=img_root,
                app_id=app_id,
                replica_id=str(replica_id),
                num_replicas=str(num_replicas),
                coordinator_env=settings.ENV_TPX_COORDINATOR_HOST,
            )
            rrole = values.apply(role)
            replica_log_dir = os.path.join(log_dir, role.name, str(replica_id))

            env = dict(os.environ)
            env.update(rrole.env)
            env["PYTHONUNBUFFERED"] = "1"
            env[settings.ENV_TPX_APP_ID] = app_id
            env[settings.ENV_TPX_JOB_ID] = f"{self.backend}://{self.session_name}/{app_id}"
            env[settings.ENV_TPX_LOG_DIR] = replica_log_dir
            error_file = os.path.join(replica_log_dir, "error.json")
            env[settings.ENV_TPX_ERROR_FILE] = error_file
            env.update(
                role_replica_env(
                    role,
                    replica_id,
                    coordinator_host="localhost",
                    coordinator_port=settings.TPX_COORDINATOR_PORT,
                )
            )
            if role.resource is not None and role.resource.gpu is not None:
                if host_gpus is None:
                    host_gpus = local_gpus()
                env.update(
                    gpu_device_env(
                        role.resource.gpu.gpus_per_host,
                        replica_id,
                        replicas_on_host=num_replicas,
                        host_gpus=host_gpus,
                        simulate=bool(cfg.get("gpu_simulate", False)),
                        partition=bool(cfg.get("auto_set_cuda_visible_devices", True)),
                    )
                )
            paths = [p for p in self._extra_paths]
            if cfg.get("prepend_cwd"):
                paths.insert(0, os.getcwd())
            if img_root:
                paths.append(img_root)
            if paths:
                env["PATH"] = os.pathsep.join(paths + [env.get("PATH", "")])

            entrypoint = self._image_provider.get_entrypoint(
                img_root, rrole.entrypoint
            )
            replicas.append(
                ReplicaParam(
                    args=[entrypoint, *rrole.args],
                    env=env,
                    stdout=os.path.join(replica_log_dir, "stdout.log"),
                    stderr=os.path.join(replica_log_dir, "stderr.log"),
                    combined=os.path.join(replica_log_dir, "combined.log"),
                    cwd=img_root or None,
                )
            )
        return replicas

    # -- schedule ---------------------------------------------------------

    def schedule(self, dryrun_info: AppDryRunInfo[PopenRequest]) -> str:
        from torchx_tpu_torch.obs import trace as obs_trace

        request = dryrun_info.request
        self._evict_lru()
        self._install_signal_cleanup()
        app = _LocalApp(request.app_id, request.log_dir, request=request)
        try:
            with obs_trace.span(
                "scheduler.spawn",
                session=self.session_name,
                scheduler=self.backend,
                app_id=request.app_id,
                replicas=sum(len(r) for r in request.role_params.values()),
            ):
                for role_name, replicas in request.role_params.items():
                    for replica_id, rp in enumerate(replicas):
                        app.add_replica(
                            role_name, self._popen(role_name, replica_id, rp)
                        )
        except Exception:
            app.kill()
            raise
        app.set_state(AppState.RUNNING)
        _registry_record(request.app_id, request.log_dir)
        self._apps[request.app_id] = app
        return request.app_id

    def _popen(self, role_name: str, replica_id: int, rp: ReplicaParam) -> _LocalReplica:
        os.makedirs(os.path.dirname(rp.stdout), exist_ok=True)
        stdout = open(rp.stdout, "wb")
        stderr = open(rp.stderr, "wb")
        tee = Tee(Path(rp.combined), Path(rp.stdout), Path(rp.stderr))
        # /bin/sh wrapper persists the replica's exit code next to its logs
        # (atomic tmp+rename). The launcher's in-memory proc handle dies
        # with the client process; the sidecar is what lets a RESUMED
        # supervise client (or any other process) recover SUCCEEDED vs
        # FAILED after the owner crashed. Exit codes pass through exactly
        # (`exit "$rc"`), so drills comparing proc.poll() to a specific
        # code (TPX_SIMULATE_PREEMPTION_EXIT) are unaffected.
        rc_file = os.path.join(os.path.dirname(rp.stdout), EXITCODE_FILE)
        try:
            os.unlink(rc_file)
        except OSError:
            pass
        wrapped = [
            "/bin/sh",
            "-c",
            '"$@"; rc=$?; printf %s "$rc" > "$0.tmp" && mv -f "$0.tmp" "$0"; exit "$rc"',
            rc_file,
            *rp.args,
        ]
        proc = subprocess.Popen(
            wrapped,
            env=rp.env,
            stdout=stdout,
            stderr=stderr,
            cwd=rp.cwd,
            start_new_session=True,  # own process group: clean gang kill
        )
        logger.debug(
            "started %s/%s pid=%d: %s", role_name, replica_id, proc.pid, rp.args
        )
        return _LocalReplica(
            role_name,
            replica_id,
            proc,
            stdout,
            stderr,
            tee,
            error_file=rp.env.get(settings.ENV_TPX_ERROR_FILE, ""),
        )

    def _evict_lru(self) -> None:
        while len(self._apps) >= self._cache_size:
            terminal = [
                (a.last_updated, app_id)
                for app_id, a in self._apps.items()
                if is_terminal(a.state)
            ]
            if not terminal:
                raise RuntimeError(
                    f"app cache full ({self._cache_size}) with no terminal"
                    " apps to evict; wait for or cancel running apps"
                )
            _, oldest = min(terminal)
            self._apps.pop(oldest)

    def _install_signal_cleanup(self) -> None:
        """Kill all child gangs if the client process dies (reference
        :541-549). Only from the main thread; no-op otherwise."""
        if self._installed_signal_cleanup:
            return
        if threading.current_thread() is not threading.main_thread():
            return
        for sig in (signal.SIGTERM, signal.SIGINT, signal.SIGHUP):
            prev = signal.getsignal(sig)

            def handler(signum, frame, prev=prev):  # noqa: ANN001
                self.close()
                if callable(prev):
                    prev(signum, frame)
                else:
                    signal.signal(signum, signal.SIG_DFL)
                    signal.raise_signal(signum)

            try:
                signal.signal(sig, handler)
            except ValueError:
                return  # not main thread after all
        self._installed_signal_cleanup = True

    # -- monitoring -------------------------------------------------------

    def describe(self, app_id: str) -> Optional[DescribeAppResponse]:
        # even the in-process backend routes status through the resilient
        # seam: TPX_FAULT_PLAN drills (inject transient failures into the
        # supervisor's poll loop) exercise the same retry/breaker/span
        # machinery that guards gcloud/kubectl on the cloud backends
        return resilient_call(
            lambda: self._describe_impl(app_id),
            backend=self.backend,
            op="describe",
        )

    def _describe_impl(self, app_id: str) -> Optional[DescribeAppResponse]:
        app = self._apps.get(app_id)
        if app is None:
            return self._describe_external(app_id)
        self._update_app_state(app)
        roles_statuses = []
        for role_name, replicas in app.roles.items():
            rs = RoleStatus(role=role_name)
            for r in replicas:
                rc = r.proc.poll()
                if rc is None:
                    state = AppState.RUNNING
                elif rc == 0:
                    state = AppState.SUCCEEDED
                else:
                    state = (
                        AppState.CANCELLED
                        if app.state == AppState.CANCELLED
                        else AppState.FAILED
                    )
                rs.replicas.append(
                    ReplicaStatus(
                        id=r.replica_id,
                        state=state,
                        role=role_name,
                        hostname="localhost",
                    )
                )
            roles_statuses.append(rs)

        structured_error_msg = NONE
        err_file = app.first_error_file()
        if app.state == AppState.FAILED and err_file:
            try:
                structured_error_msg = Path(err_file).read_text()
            except OSError:
                pass

        return DescribeAppResponse(
            app_id=app_id,
            state=app.state,
            num_restarts=app.num_restarts,
            structured_error_msg=structured_error_msg,
            ui_url=f"file://{app.log_dir}",
            roles_statuses=roles_statuses,
        )

    def _describe_external(self, app_id: str) -> Optional[DescribeAppResponse]:
        """Status of an app owned by ANOTHER process, from its state file.

        Terminal states are authoritative (the owner wrote them); for a
        still-RUNNING file, pid liveness decides between RUNNING and
        UNKNOWN (owner gone — exit codes are unknowable across processes).
        """
        import json

        log_dir = self._external_dirs.get(app_id) or _registry_lookup(app_id)
        if log_dir is None:
            return None
        self._external_dirs[app_id] = log_dir  # skip registry rescans on polls
        try:
            with open(os.path.join(log_dir, STATE_FILE)) as f:
                payload = json.load(f)
        except (OSError, json.JSONDecodeError):
            return None
        try:
            state = AppState[payload.get("state", "UNKNOWN")]
        except KeyError:  # unrecognized state name (newer writer / bad file)
            state = AppState.UNKNOWN
        if not is_terminal(state):
            procs = [
                (r["pid"], r.get("pid_start"))
                for replicas in payload.get("roles", {}).values()
                for r in replicas
            ]
            if any(_pid_alive(p, st) for p, st in procs):
                state = AppState.RUNNING
            else:
                # owner died without writing a terminal state; the launch
                # wrapper's exit-code sidecars are the crash-safe record
                state = _recover_sidecar_state(log_dir, payload)
        roles_statuses = [
            RoleStatus(
                role=name,
                replicas=[
                    ReplicaStatus(
                        id=r["id"], state=state, role=name, hostname="localhost"
                    )
                    for r in replicas
                ],
            )
            for name, replicas in payload.get("roles", {}).items()
        ]
        return DescribeAppResponse(
            app_id=app_id,
            state=state,
            ui_url=f"file://{log_dir}",
            roles_statuses=roles_statuses,
        )

    def _update_app_state(self, app: _LocalApp) -> None:
        if is_terminal(app.state):
            return
        any_alive = False
        any_failed = False
        for r in app.replicas():
            rc = r.proc.poll()
            if rc is None:
                any_alive = True
            else:
                r._close_files()
                if rc != 0:
                    any_failed = True
        if any_failed:
            # fail fast: kill the rest of the gang (SPMD semantics — a dead
            # host wedges the collective anyway). If an external `tpx
            # cancel` already marked the app CANCELLED on disk, honor that
            # instead of recording the SIGTERM'd children as a failure.
            if _state_file_says_cancelled(app.log_dir):
                for r in app.replicas():
                    if r.is_alive():
                        r.terminate()
                app.set_state(AppState.CANCELLED)
            elif self._simulated_preemption(app):
                for r in app.replicas():
                    if r.is_alive():
                        r.terminate()
                app.set_state(AppState.PREEMPTED)
            elif self._try_elastic_restart(app):
                return
            else:
                for r in app.replicas():
                    if r.is_alive():
                        r.terminate()
                app.set_state(AppState.FAILED)
        elif not any_alive:
            if _state_file_says_cancelled(app.log_dir):
                # an external cancel landed and the replicas exited 0
                # (graceful SIGTERM handling) — a cancelled run must not
                # report SUCCEEDED or mint a SUCCESS marker
                app.set_state(AppState.CANCELLED)
            else:
                app.set_state(AppState.SUCCEEDED)
                Path(app.log_dir, "SUCCESS").touch()

    def _simulated_preemption(self, app: _LocalApp) -> bool:
        """True when a preemption drill is armed and a replica tripped it.

        Opt-in only: a role env must set ``TPX_SIMULATE_PREEMPTION_EXIT``
        to an exit code, and some replica must have exited with exactly
        that code. The attempt then terminates PREEMPTED (the base
        ``classify_failure`` maps it to FailureClass.PREEMPTION), which
        lets ``tpx supervise`` be drilled against real spot semantics on
        a laptop. Everything else — elastic restart, FAILED fast-kill —
        is untouched when the env var is absent.
        """
        request = app.request
        if request is None:
            return False
        drill_code: Optional[int] = None
        for replicas in request.role_params.values():
            for rp in replicas:
                raw = rp.env.get(settings.ENV_TPX_SIMULATE_PREEMPTION_EXIT)
                if raw:
                    try:
                        drill_code = int(raw)
                    except ValueError:
                        return False
                    break
            if drill_code is not None:
                break
        if drill_code is None:
            return False
        return any(r.proc.poll() == drill_code for r in app.replicas())

    def _try_elastic_restart(self, app: _LocalApp) -> bool:
        """Shrink-and-restart a failed elastic gang (elastic min/max under
        preemption).

        SPMD worlds resize by restart: when a replica of a role with
        ``min_replicas`` dies, the surviving budget (``max_retries``)
        relaunches the WHOLE gang with a smaller world — every replica gets
        fresh TPX_REPLICA_ID / TPX_NUM_REPLICAS so ``spmd_main`` re-forms
        its process group over the resized mesh and user code resumes from
        its last checkpoint. The analog of torchrun's ``--nnodes min:max``
        elastic rendezvous (reference components/dist.py:294-296), with the
        world size fixed per process group.
        """
        request = app.request
        if request is None or request.app is None:
            return False
        # plan per-role: every FAILED role must be restartable within ITS
        # OWN budget, and decides its new size; healthy roles restart as-is
        # only when some failed role is APPLICATION-scoped (ROLE-scoped
        # failures leave healthy roles running untouched)
        new_sizes: dict[str, int] = {}
        failed_roles: set[str] = set()
        role_scoped_only = True
        for role in request.app.roles:
            replicas = app.roles.get(role.name, [])
            n_failed = sum(1 for r in replicas if r.failed())
            cur = len(replicas)
            if n_failed == 0:
                continue  # planned below once the restart scope is known
            failed_roles.add(role.name)
            # each role consumes ITS OWN budget: a restart triggered by
            # role A must not burn role B's retries (and vice versa)
            spent = app.role_restarts.get(role.name, 0)
            if spent >= role.max_retries and role.min_replicas is None:
                return False  # this role's own budget is spent
            if role.min_replicas is None:
                # rigid gang: APPLICATION restarts the whole app, ROLE
                # restarts just this role, both at FULL size (the local
                # analog of JobSet maxRestarts / slurm requeue);
                # REPLICA-scoped retries are fatal for a gang
                if role.retry_policy == RetryPolicy.REPLICA:
                    return False
                if role.retry_policy == RetryPolicy.APPLICATION:
                    role_scoped_only = False
                new_sizes[role.name] = cur
                continue
            # elastic: shrink, budgeted by max_retries as well
            if spent >= max(1, role.max_retries):
                return False
            role_scoped_only = False  # a resized world needs a full restart
            hosts = _slice_hosts(role)
            # GPU gangs shrink in whole slices: a slice's hosts are one
            # unit of the gang's mesh, and a part of one is not a slice
            new_n = ((cur - n_failed) // hosts) * hosts
            if new_n < max(1, role.min_replicas * hosts):
                return False  # below the elastic floor
            new_sizes[role.name] = new_n
        if not new_sizes:
            return False  # nothing actually failed
        if not role_scoped_only:
            # APPLICATION/elastic scope: healthy roles restart at full size
            for role in request.app.roles:
                if role.name not in new_sizes:
                    new_sizes[role.name] = len(app.roles.get(role.name, []))
        attempt = app.num_restarts + 1
        logger.warning(
            "gang restart #%d of %s (%s-scoped): %s",
            attempt,
            app.app_id,
            "role" if role_scoped_only else "app",
            {
                r: f"{len(app.roles.get(r, []))} -> {n}"
                for r, n in new_sizes.items()
            },
        )
        for role_name in new_sizes:
            self._teardown_role_gang(app, role_name)
        app.num_restarts = attempt
        for role_name in failed_roles:
            app.role_restarts[role_name] = app.role_restarts.get(role_name, 0) + 1
        try:
            for role in request.app.roles:
                if role.name not in new_sizes:
                    continue  # ROLE-scoped restart: healthy role kept alive
                self._launch_role_gang(
                    app, role, new_sizes[role.name], attempt, request.cfg
                )
        except Exception:
            app.kill()
            app.set_state(AppState.FAILED)
            return True  # state handled (failed during relaunch)
        app.set_state(AppState.RUNNING)
        return True

    def _teardown_role_gang(self, app: _LocalApp, role_name: str) -> None:
        """Stop one role's replicas and drop them from the app (shared by
        elastic restart and manual resize)."""
        for r in app.roles.get(role_name, []):
            if r.is_alive():
                r.terminate()
            else:
                r._close_files()
        app.roles.pop(role_name, None)

    def _launch_role_gang(
        self,
        app: _LocalApp,
        role: Role,
        num_replicas: int,
        attempt: int,
        cfg: Mapping[str, CfgVal],
    ) -> None:
        """(Re)launch one role's gang ``num_replicas`` hosts wide, rotating
        the previous attempt's logs aside."""
        params = self._build_role_replicas(
            role,
            app.app_id,
            app.log_dir,
            cfg,
            num_replicas=num_replicas,
        )
        for replica_id, rp in enumerate(params):
            _rotate_attempt_logs(rp, attempt)
            app.add_replica(role.name, self._popen(role.name, replica_id, rp))

    def watch(self, app_ids=(), interval=None):
        """Native event stream: mtime-polls the state file and counts the
        per-replica ``exitcode`` sidecars the launch wrapper writes, so a
        tick over N jobs costs N ``stat`` calls and a describe only fires
        to *confirm* an observed change (state writes, external cancels,
        replica exits all bump one of those signals)."""
        from torchx_tpu_torch.control.watch import LocalSidecarWatcher

        return LocalSidecarWatcher(self, app_ids, interval=interval)

    def list(self) -> list[ListAppResponse]:
        return resilient_call(
            lambda: self._list_impl(), backend=self.backend, op="list"
        )

    def _list_impl(self) -> list[ListAppResponse]:
        out = []
        for app_id, app in self._apps.items():
            self._update_app_state(app)
            out.append(ListAppResponse(app_id=app_id, state=app.state, name=app_id))
        # apps owned by other processes, via the registry (one scan total)
        for app_id, log_dir in dict(_registry_entries()).items():
            if app_id in self._apps:
                continue
            self._external_dirs.setdefault(app_id, log_dir)
            desc = self._describe_external(app_id)
            if desc is not None:
                out.append(
                    ListAppResponse(app_id=app_id, state=desc.state, name=app_id)
                )
        return out

    def _cancel_existing(self, app_id: str) -> None:
        def _do() -> None:
            app = self._apps.get(app_id)
            if app is not None:
                app.kill()
                return
            self._cancel_external(app_id)

        resilient_call(_do, backend=self.backend, op="cancel")

    def _cancel_external(self, app_id: str) -> None:
        """Kill an app owned by another process: SIGTERM its process groups
        (replicas start_new_session, so pgid == pid) and mark the state
        file CANCELLED for every future reader."""
        import json

        desc = self._describe_external(app_id)
        if desc is None or is_terminal(desc.state):
            return
        log_dir = self._external_dirs.get(app_id) or _registry_lookup(app_id)
        try:
            with open(os.path.join(log_dir, STATE_FILE)) as f:
                payload = json.load(f)
        except (OSError, json.JSONDecodeError):
            return
        # mark CANCELLED on disk FIRST: the live owner polls its children
        # and must find the mark before it can misread their SIGTERM deaths
        # as a failure (or a graceful exit-0 as success)
        payload["state"] = AppState.CANCELLED.name
        try:
            _atomic_write_json(os.path.join(log_dir, STATE_FILE), payload)
        except OSError:
            pass
        for replicas in payload.get("roles", {}).values():
            for r in replicas:
                if not _pid_alive(r["pid"], r.get("pid_start")):
                    continue  # dead or pid reused by an unrelated process
                try:
                    os.killpg(r["pid"], signal.SIGTERM)
                except (ProcessLookupError, PermissionError):
                    pass

    def delete(self, app_id: str) -> None:
        """Cancel (if still running) and forget the app entirely: the
        session cache, the external-dir cache, and the per-user registry
        entry — ``exists``/``describe``/``list`` stop reporting it. Log
        files on disk are left for the operator to reclaim."""
        self.cancel(app_id)
        self._apps.pop(app_id, None)
        self._external_dirs.pop(app_id, None)
        from torchx_tpu_torch.util import registry

        registry.remove(_registry_path(), app_id)

    def resize(self, app_id: str, role_name: str, num_replicas: int) -> None:
        """Manual gang resize (grow or shrink) — the operator-driven
        counterpart of ``_try_elastic_restart``'s shrink-on-failure. The
        whole role gang restarts with a coherent world: every replica gets
        fresh TPX_NUM_REPLICAS / TPX_REPLICA_ID / slice decomposition, and
        user code resumes from its checkpoint."""
        app = self._apps.get(app_id)
        if app is None:
            registered = _registry_lookup(app_id)
            raise ValueError(
                f"unknown app: {app_id}"
                if registered is None
                else f"app {app_id} is owned by another process; resize from"
                " the session that submitted it"
            )
        self._update_app_state(app)
        if is_terminal(app.state):
            raise ValueError(f"cannot resize terminal app {app_id} ({app.state.name})")
        request = app.request
        if request is None or request.app is None:
            raise ValueError(f"app {app_id} has no retained request; cannot resize")
        role = next((r for r in request.app.roles if r.name == role_name), None)
        if role is None:
            raise ValueError(f"app {app_id} has no role {role_name!r}")
        if num_replicas < 1:
            raise ValueError(f"num_replicas must be >= 1, got {num_replicas}")
        if role.min_replicas is not None and num_replicas < role.min_replicas:
            raise ValueError(
                f"cannot resize role {role_name!r} to {num_replicas}: below"
                f" its declared min_replicas floor of {role.min_replicas}"
            )
        hosts = _slice_hosts(role)
        new_hosts = num_replicas * hosts  # whole slices only, by construction
        if new_hosts == len(app.roles.get(role_name, [])):
            return  # already at the requested size
        attempt = app.num_restarts + 1
        logger.warning(
            "manual resize of %s role %s: %d -> %d replicas (gang restart #%d)",
            app_id,
            role_name,
            len(app.roles.get(role_name, [])),
            new_hosts,
            attempt,
        )
        self._teardown_role_gang(app, role_name)
        app.num_restarts = attempt
        try:
            self._launch_role_gang(app, role, new_hosts, attempt, request.cfg)
        except Exception:
            app.kill()
            app.set_state(AppState.FAILED)
            raise
        app.set_state(AppState.RUNNING)

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
        app = self._apps.get(app_id)
        if app is not None:
            log_root = app.log_dir
        else:
            external = _registry_lookup(app_id)
            if external is None:
                raise ValueError(f"unknown app: {app_id}")
            log_root = external
        stream = streams or Stream.COMBINED
        fname = {
            Stream.STDOUT: "stdout.log",
            Stream.STDERR: "stderr.log",
            Stream.COMBINED: "combined.log",
        }[stream]
        log_file = os.path.join(log_root, role_name, str(k), fname)
        it: Iterable[str] = LogIterator(self, app_id, log_file, should_tail)
        # combined.log lines are epoch-stamped by the Tee: apply the window
        # and strip the stamps. stdout/stderr are the raw process FDs — no
        # stamps, so windows cannot apply there; say so instead of silently
        # returning the full log.
        if stream is Stream.COMBINED:
            it = window_stamped_lines(it, since, until)
        elif since or until:
            logger.warning(
                "since/until only apply to the local combined stream"
                " (stdout/stderr are raw process files with no line"
                " timestamps); showing the full %s log",
                stream.value,
            )
        if regex:
            it = filter_regex(regex, it)
        return it

    def close(self) -> None:
        for app in self._apps.values():
            if not is_terminal(app.state):
                app.kill()

    def __del__(self) -> None:
        try:
            self.close()
        except Exception:
            pass


def _rotate_attempt_logs(rp: ReplicaParam, attempt: int) -> None:
    """Move the previous attempt's log files aside (``stdout.log`` ->
    ``stdout.log.<attempt-1>``) so log paths stay stable for ``log_iter``
    while history is preserved."""
    error_file = os.path.join(os.path.dirname(rp.stdout), "error.json")
    for path in (rp.stdout, rp.stderr, rp.combined, error_file):
        if os.path.exists(path):
            try:
                os.replace(path, f"{path}.{attempt - 1}")
            except OSError:
                pass


class LogIterator:
    """File-follow log iterator with app-finished detection (reference
    LogIterator, local_scheduler.py:1130-1196)."""

    def __init__(
        self,
        scheduler: LocalScheduler,
        app_id: str,
        log_file: str,
        should_tail: bool,
        poll_interval: float = 0.1,
    ) -> None:
        self._scheduler = scheduler
        self._app_id = app_id
        self._log_file = log_file
        self._should_tail = should_tail
        self._poll = poll_interval
        self._fp: Optional[TextIO] = None
        self._app_finished = False

    def _check_finished(self) -> None:
        resp = self._scheduler.describe(self._app_id)
        self._app_finished = (
            resp is None
            or is_terminal(resp.state)
            or resp.state == AppState.UNKNOWN  # owner process gone
        )

    def __iter__(self):
        # wait for the file to exist (app may still be starting)
        while not os.path.isfile(self._log_file):
            self._check_finished()
            if self._app_finished and not os.path.isfile(self._log_file):
                return
            time.sleep(self._poll)
        with open(self._log_file, errors="replace") as fp:
            while True:
                line = fp.readline()
                if line:
                    if line.endswith("\n"):
                        yield line[:-1]
                    else:
                        yield line
                    continue
                if self._app_finished or not self._should_tail:
                    # one final drain already happened (readline returned '')
                    return
                self._check_finished()
                time.sleep(self._poll)


def _pretty_request(req: PopenRequest) -> str:
    lines = [f"app_id: {req.app_id}", f"log_dir: {req.log_dir}", "roles:"]
    for role, replicas in req.role_params.items():
        lines.append(f"  {role}:")
        for i, rp in enumerate(replicas):
            lines.append(f"    [{i}] cmd: {' '.join(rp.args)}")
    return "\n".join(lines)


def create_scheduler(session_name: str, **kwargs: Any) -> LocalScheduler:
    known = {"image_provider", "cache_size", "extra_paths"}
    return LocalScheduler(
        session_name=session_name,
        **{k: v for k, v in kwargs.items() if k in known},
    )
