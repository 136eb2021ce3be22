"""Core data model of the launcher: the port of :mod:`torchx_tpu.specs.api`.

This is the foundation layer: everything else in the launcher imports it and
it imports nothing above it (AppDef / Role / Resource / mounts / macros /
AppStatus / runopts / app handles).

The one departure from the JAX package: a :class:`Resource` carries a
:class:`GpuSlice` (a GPU generation and a count of cards, spread over hosts
of :data:`GPU_GENERATIONS`' size) in place of the TPU slice model, because
the port's jobs run on NVIDIA H100s: ``Resource.gpu`` in place of
``Resource.tpu``, with the reading surface the launcher's layers use
(``hosts``, ``gpus_per_host``, ``hbm_bytes_per_gpu``, ``accelerator_type``,
``from_type``, ``default_topology``).

Standard library only: a launcher process loads no ``torch``.
"""

from __future__ import annotations

import copy
import json
import re
import warnings
from dataclasses import dataclass, field
from datetime import datetime
from enum import Enum
from string import Template
from typing import Any, Callable, Generic, Iterator, Mapping, Optional, TypeVar, Union

# =========================================================================
# GPU slice model
# =========================================================================

#: Physical facts per GPU generation, the one source the port reads them
#: from (``parallel/aot_fit.py``'s budget, ``analyze/costmodel.py``'s link
#: rate):
#:
#: * ``gpus_per_host``: cards on one host, one NVLink domain; a multi-host
#:   slice is built of whole hosts. The H100's host is GCP's
#:   ``a3-highgpu-8g`` (``named_resources_gcp.py``'s ``gpu_h100_8``).
#: * ``hbm_bytes``: one card's memory as the card reports it
#:   (``torch.cuda.get_device_properties(0).total_memory`` of an NVIDIA H100
#:   80GB HBM3 at 700 W, read by chip_smoke.py), the memory-fit budget.
#: * ``link_bytes_per_s``: what one card sends to its peers a second, NVLink
#:   4 on the H100 SXM: 900 GB/s both ways together, 450 GB/s each way
#:   (NVIDIA's H100 data sheet).
#: * ``gke_accelerator``: the GKE node-pool label
#:   (``cloud.google.com/gke-accelerator``), which is also the accelerator
#:   type GCP Batch and Compute Engine take (``nvidia-h100-80gb``).
#: * ``machine_types``: cards a host -> the Compute Engine machine type that
#:   carries them, the A3 High family of GCP's "GPU machine types" document
#:   (cloud.google.com/compute/docs/gpus, "A3 High": a3-highgpu-1g, -2g,
#:   -4g and -8g with 1, 2, 4 and 8 H100 80GB). A slice of another count
#:   a host has no machine (gcp_batch and vertex refuse it).
#: * ``vertex_accelerator``: Vertex AI's ``acceleratorType`` enum name
#:   (cloud.google.com/vertex-ai/docs/reference/rest/v1/MachineSpec).
GPU_GENERATIONS: dict[str, dict[str, Any]] = {
    "h100": {
        "gpus_per_host": 8,
        "hbm_bytes": 85_017_493_504,
        "link_bytes_per_s": 450e9,
        "gke_accelerator": "nvidia-h100-80gb",
        "machine_types": {1: "a3-highgpu-1g", 2: "a3-highgpu-2g", 4: "a3-highgpu-4g",
                          8: "a3-highgpu-8g"},
        "vertex_accelerator": "NVIDIA_H100_80GB",
    },
}

_ACCEL_TYPE_RE = re.compile(r"^(?P<gen>[a-z0-9]+)-(?P<count>\d+)$")


@dataclass(frozen=True)
class GpuSlice:
    """A gang's GPUs: the unit of accelerator allocation.

    A slice of up to one host's cards lives on one host; a larger slice is
    whole hosts of ``gpus_per_host`` cards each, one process per host, so a
    count that does not fill whole hosts is refused.

    Attributes:
        accelerator: generation, a key of :data:`GPU_GENERATIONS` (``"h100"``).
        gpus: total cards in the slice.
    """

    accelerator: str
    gpus: int

    def __post_init__(self) -> None:
        if self.accelerator not in GPU_GENERATIONS:
            raise ValueError(
                f"unknown GPU generation: {self.accelerator!r};"
                f" known: {sorted(GPU_GENERATIONS)}"
            )
        if self.gpus <= 0:
            raise ValueError(f"gpus must be positive, got {self.gpus}")
        per_host = GPU_GENERATIONS[self.accelerator]["gpus_per_host"]
        if self.gpus > per_host and self.gpus % per_host:
            raise ValueError(
                f"{self.gpus} {self.accelerator} GPUs do not fill whole hosts of"
                f" {per_host}: a slice larger than one host takes whole hosts"
            )

    # -- derived facts -----------------------------------------------------

    @property
    def hbm_bytes_per_gpu(self) -> int:
        """Per-card memory: the memory-fit budget."""
        return GPU_GENERATIONS[self.accelerator]["hbm_bytes"]

    @property
    def gpus_per_host(self) -> int:
        """Cards each host of the slice exposes: the whole count up to one
        host, else a whole host's."""
        return min(self.gpus, GPU_GENERATIONS[self.accelerator]["gpus_per_host"])

    @property
    def hosts(self) -> int:
        """Number of hosts (== launcher processes) in the slice."""
        return self.gpus // self.gpus_per_host

    @property
    def machine_type(self) -> str:
        """The Compute Engine machine type of one host of the slice
        (:data:`GPU_GENERATIONS`' ``machine_types``, ``a3-highgpu-8g`` for
        eight H100s), which GCP Batch and Vertex AI ask for. Raises where no
        machine type carries ``gpus_per_host`` cards."""
        types = GPU_GENERATIONS[self.accelerator]["machine_types"]
        if self.gpus_per_host not in types:
            raise ValueError(
                f"no {self.accelerator} machine type carries {self.gpus_per_host} GPUs;"
                f" hosts come with {sorted(types)}"
            )
        return types[self.gpus_per_host]

    def default_topology(self) -> str:
        """``<hosts>x<gpus_per_host>``: one NVLink domain a host, all to all
        within it; hosts reach each other over the network."""
        return f"{self.hosts}x{self.gpus_per_host}"

    # -- naming ------------------------------------------------------------

    @property
    def accelerator_type(self) -> str:
        """``<generation>-<gpus>``, e.g. ``"h100-16"``."""
        return f"{self.accelerator}-{self.gpus}"

    @classmethod
    def from_type(cls, accelerator_type: str) -> "GpuSlice":
        """Parse an accelerator-type string.

        >>> GpuSlice.from_type("h100-16").hosts
        2
        """
        m = _ACCEL_TYPE_RE.match(accelerator_type.strip().lower())
        if not m:
            raise ValueError(f"malformed GPU accelerator type: {accelerator_type!r}")
        if m.group("gen") not in GPU_GENERATIONS:
            raise ValueError(f"unknown GPU generation in {accelerator_type!r}")
        return cls(accelerator=m.group("gen"), gpus=int(m.group("count")))

    def __str__(self) -> str:
        return f"GpuSlice({self.accelerator_type}, gpus={self.gpus})"


# =========================================================================
# Resource
# =========================================================================


@dataclass
class Resource:
    """Per-replica resource requirements.

    Attributes:
        cpu: logical CPUs (on a GPU host this is usually the host's share).
        memMB: host RAM in MB.
        gpu: the GPU slice this replica's gang occupies, or None for CPU-only.
            NOTE: ``gpu`` describes the *whole slice for the role*; a role
            with a multi-host slice gets ``gpu.hosts`` replicas scheduled by
            GPU-aware backends (one process per host).
        capabilities: scheduler-interpreted extras (machine type, disk, spot).
        devices: named host devices with counts, e.g. ``{"nvidia.com/gpu": 8}``:
            the cards ONE host exposes to the replica (the k8s limit).
        tags: freeform labels propagated to backends that support them.
    """

    cpu: float = -1
    memMB: int = -1
    gpu: Optional[GpuSlice] = None
    capabilities: dict[str, Any] = field(default_factory=dict)
    devices: dict[str, int] = field(default_factory=dict)
    tags: dict[str, str] = field(default_factory=dict)

    @staticmethod
    def copy(original: "Resource", **capabilities: Any) -> "Resource":
        res = copy.deepcopy(original)
        res.capabilities.update(capabilities)
        return res


NULL_RESOURCE = Resource(cpu=-1, memMB=-1)

# Sentinel used by components: "scheduler should fill in the resource".
RESOURCE_UNSET = "__UNSET__"


# =========================================================================
# Mounts
# =========================================================================


class MountType(str, Enum):
    BIND = "bind"
    VOLUME = "volume"
    DEVICE = "device"


@dataclass
class BindMount:
    """Bind-mount a host path into the replica container."""

    src_path: str
    dst_path: str
    read_only: bool = False


@dataclass
class VolumeMount:
    """Mount a named volume (docker volume / k8s PVC / GCS fuse bucket)."""

    src: str
    dst_path: str
    read_only: bool = False


@dataclass
class DeviceMount:
    """Expose a host device node inside the container."""

    src_path: str
    dst_path: str
    permissions: str = "rwm"


def parse_mounts(opts: list[str]) -> list[Union[BindMount, VolumeMount, DeviceMount]]:
    """Parse docker-style mount options into typed mounts.

    Format (repeating)::

        type=<bind|volume|device>,src=<src>,dst=<dst>[,readonly][,perm=<rwm>]

    ``--mount type=bind,src=/host,dst=/job,readonly``

    Reference analog: torchx/specs/builders.py:311-376.
    """
    mounts: list[Union[BindMount, VolumeMount, DeviceMount]] = []
    cur: dict[str, str] = {}
    groups: list[dict[str, str]] = []
    for opt in opts:
        for kv in opt.split(","):
            kv = kv.strip()
            if not kv:
                continue
            if "=" in kv:
                k, _, v = kv.partition("=")
            else:
                k, v = kv, "true"
            k = k.lower()
            if k == "type" and cur:
                groups.append(cur)
                cur = {}
            cur[k] = v
    if cur:
        groups.append(cur)

    for g in groups:
        mtype = g.get("type")
        if mtype is None:
            raise ValueError(f"mount spec missing type=: {g}")
        src = g.get("src") or g.get("source")
        dst = g.get("dst") or g.get("destination") or g.get("target")
        readonly = g.get("readonly", "false").lower() in ("true", "1", "")
        if mtype == MountType.BIND.value:
            if not src or not dst:
                raise ValueError(f"bind mount needs src and dst: {g}")
            mounts.append(BindMount(src_path=src, dst_path=dst, read_only=readonly))
        elif mtype == MountType.VOLUME.value:
            if not src or not dst:
                raise ValueError(f"volume mount needs src and dst: {g}")
            mounts.append(VolumeMount(src=src, dst_path=dst, read_only=readonly))
        elif mtype == MountType.DEVICE.value:
            if not src:
                raise ValueError(f"device mount needs src: {g}")
            mounts.append(
                DeviceMount(
                    src_path=src, dst_path=dst or src, permissions=g.get("perm", "rwm")
                )
            )
        else:
            raise ValueError(f"unknown mount type {mtype!r} in {g}")
    dsts: dict[str, int] = {}
    for i, m in enumerate(mounts):
        if m.dst_path in dsts:
            raise ValueError(
                f"duplicate mount destination {m.dst_path!r}: mounts"
                f" #{dsts[m.dst_path] + 1} and #{i + 1} would shadow each"
                " other (each mount needs a distinct dst)"
            )
        dsts[m.dst_path] = i
    return mounts


# =========================================================================
# Workspace spec
# =========================================================================


@dataclass
class Workspace:
    """Maps local project directories to destination subdirs in the image.

    ``{"./src": "app/src", "./conf": "conf"}`` copies two local trees into
    the built workspace image / job dir (reference analog:
    torchx/specs/api.py:340-411).
    """

    projects: dict[str, str] = field(default_factory=dict)

    @classmethod
    def from_str(cls, spec: str) -> "Workspace":
        """Either a single path ("." / "./proj") or a YAML/JSON-ish mapping
        string ``src1=dst1,src2=dst2``."""
        spec = spec.strip()
        if not spec:
            return cls()
        if "=" not in spec:
            return cls(projects={spec: ""})
        projects = {}
        for pair in spec.split(","):
            src, _, dst = pair.partition("=")
            projects[src.strip()] = dst.strip()
        return cls(projects=projects)

    def merge_into(self, other: "Workspace") -> "Workspace":
        merged = dict(other.projects)
        merged.update(self.projects)
        return Workspace(projects=merged)

    def __bool__(self) -> bool:
        return bool(self.projects)


# =========================================================================
# Macros
# =========================================================================


class macros:
    """Template variables substituted into Role args/env at materialize time.

    Reference analog: torchx/specs/api.py:183-274. The launcher's twist:
    ``coordinator_env`` substitutes to the *name* of the scheduler-specific
    env var that holds the coordinator (replica-0) hostname; the value is
    resolved by the shell at runtime — e.g.
    ``--coordinator=$${coordinator_env}:8476`` (the reference's rank0_env
    trick, specs/api.py:216-222).
    """

    img_root = "${img_root}"
    app_id = "${app_id}"
    replica_id = "${replica_id}"
    num_replicas = "${num_replicas}"
    coordinator_env = "${coordinator_env}"

    @dataclass
    class Values:
        img_root: str = ""
        app_id: str = ""
        replica_id: str = ""
        num_replicas: str = ""
        coordinator_env: str = "TPX_COORDINATOR_HOST"

        def apply(self, role: "Role") -> "Role":
            """Return a deep-copied Role with macros substituted in args,
            env values, entrypoint and mount paths."""
            role = copy.deepcopy(role)
            role.entrypoint = self.substitute(role.entrypoint)
            role.args = [self.substitute(a) for a in role.args]
            role.env = {k: self.substitute(v) for k, v in role.env.items()}
            for m in role.mounts:
                if isinstance(m, (BindMount, DeviceMount)):
                    m.src_path = self.substitute(m.src_path)
                    m.dst_path = self.substitute(m.dst_path)
                elif isinstance(m, VolumeMount):
                    m.dst_path = self.substitute(m.dst_path)
            return role

        def substitute(self, arg: str) -> str:
            return Template(arg).safe_substitute(
                img_root=self.img_root,
                app_id=self.app_id,
                replica_id=self.replica_id,
                num_replicas=self.num_replicas,
                coordinator_env=self.coordinator_env,
            )


# =========================================================================
# Role / AppDef
# =========================================================================


class RetryPolicy(str, Enum):
    """What to restart when a replica fails.

    REPLICA: restart only the failed replica (stateless services).
    APPLICATION: restart the whole app (SPMD training — a dead host kills the
        gang's collectives, so the whole gang must restart; the default).
    ROLE: restart all replicas of the failed role.
    """

    REPLICA = "REPLICA"
    APPLICATION = "APPLICATION"
    ROLE = "ROLE"


@dataclass
class Role:
    """A homogeneous gang of replicas (one container/process template).

    For GPU roles, ``num_replicas`` is the number of *hosts*: one launcher
    process per host, which starts a worker a card. GPU-aware schedulers keep
    ``num_replicas == resource.gpu.hosts`` in sync.

    Reference analog: torchx/specs/api.py:277-505.
    """

    name: str
    image: str = ""
    min_replicas: Optional[int] = None  # elastic lower bound; None = rigid gang
    entrypoint: str = ""
    args: list[str] = field(default_factory=list)
    env: dict[str, str] = field(default_factory=dict)
    num_replicas: int = 1
    max_retries: int = 0
    retry_policy: RetryPolicy = RetryPolicy.APPLICATION
    resource: Resource = field(default_factory=lambda: copy.deepcopy(NULL_RESOURCE))
    port_map: dict[str, int] = field(default_factory=dict)
    metadata: dict[str, Any] = field(default_factory=dict)
    mounts: list[Union[BindMount, VolumeMount, DeviceMount]] = field(default_factory=list)
    workspace: Optional[Workspace] = None
    # Hook applied to the raw scheduler request during submit_dryrun
    # (reference analog: Role.pre_proc, schedulers/api.py:410-422).
    pre_proc: Optional[Callable[[str, Any], Any]] = None

    def pre_proc_fn(self, scheduler: str, dryrun_info: Any) -> Any:
        if self.pre_proc is None:
            return dryrun_info
        return self.pre_proc(scheduler, dryrun_info)


@dataclass
class AppDef:
    """An application: a named set of roles launched as one job."""

    name: str
    roles: list[Role] = field(default_factory=list)
    metadata: dict[str, str] = field(default_factory=dict)


# =========================================================================
# Status model
# =========================================================================


class AppState(int, Enum):
    """Lifecycle states (reference analog: torchx/specs/api.py:529-560).

    PREEMPTED is the launcher's addition: spot/queued capacity was reclaimed
    by the provider. It is terminal for the *attempt* (the gang is gone) but
    retryable by policy — the supervisor treats it as its own failure class
    with its own budget (see the launcher's supervisor).
    """

    UNSUBMITTED = 0
    SUBMITTED = 1
    PENDING = 2
    RUNNING = 3
    SUCCEEDED = 4
    FAILED = 5
    CANCELLED = 6
    UNKNOWN = 7
    PREEMPTED = 8

    def __str__(self) -> str:
        return self.name


class FailureClass(str, Enum):
    """Why a terminal attempt failed — the retry-decision signal.

    Schedulers classify failures via :meth:`Scheduler.classify_failure`
    (populated from backend detail: spot-reclamation markers, node
    disruption conditions); the supervisor keeps an independent retry
    budget per class.

    PREEMPTION: the provider took the capacity back (spot reclaim, node
        drain/disruption). Always worth retrying — nothing is wrong with
        the app.
    INFRA: the control plane failed the attempt (stockout, provisioning
        error, scheduler fault). Retryable a few times.
    APP: the application itself exited non-zero. The conservative default
        for unclassifiable failures — retrying a buggy app burns money.
    HANG: the scheduler still reports RUNNING but the gang stopped making
        progress (heartbeats went stale, liveness leases expired — see
        the supervisor's gang monitor). The supervisor kills the
        attempt itself and synthesizes this class; budgeted separately
        because a hang is usually a wedged collective or a lost replica,
        not an app bug.
    """

    PREEMPTION = "PREEMPTION"
    INFRA = "INFRA"
    APP = "APP"
    HANG = "HANG"

    def __str__(self) -> str:
        return self.value


_TERMINAL_STATES = frozenset(
    (AppState.SUCCEEDED, AppState.FAILED, AppState.CANCELLED, AppState.PREEMPTED)
)
_STARTED_STATES = frozenset(
    (
        AppState.RUNNING,
        AppState.SUCCEEDED,
        AppState.FAILED,
        AppState.CANCELLED,
        AppState.PREEMPTED,
    )
)


def is_terminal(state: AppState) -> bool:
    return state in _TERMINAL_STATES


def is_started(state: AppState) -> bool:
    return state in _STARTED_STATES


NONE: str = "<NONE>"


@dataclass
class ReplicaStatus:
    id: int
    state: AppState
    role: str
    hostname: str = ""
    structured_error_msg: str = NONE


@dataclass
class RoleStatus:
    role: str
    replicas: list[ReplicaStatus] = field(default_factory=list)


@dataclass
class AppStatus:
    """Status of a submitted app, aggregated over roles/replicas.

    ``structured_error_msg`` carries the JSON error file content written by
    the first failed replica (see settings.ENV_TPX_ERROR_FILE); ``format()``
    pretty-prints it (reference analog: specs/api.py:596-778).

    ``failure_class`` is the scheduler's classification of *why* a terminal
    failure happened (:class:`FailureClass`), when known — ``tpx status``
    then shows ``FAILED (preemption)`` instead of a bare FAILED.
    """

    state: AppState
    num_restarts: int = 0
    msg: str = ""
    structured_error_msg: str = NONE
    ui_url: Optional[str] = None
    roles: list[RoleStatus] = field(default_factory=list)
    failure_class: Optional[FailureClass] = None

    def is_terminal(self) -> bool:
        return is_terminal(self.state)

    def _state_str(self) -> str:
        """State plus failure classification when known: ``FAILED (preemption)``."""
        if self.failure_class is not None and self.state in (
            AppState.FAILED,
            AppState.PREEMPTED,
        ):
            return f"{self.state} ({self.failure_class.value.lower()})"
        return str(self.state)

    def raise_for_status(self) -> None:
        if self.state != AppState.SUCCEEDED:
            raise AppStatusError(self, f"job did not succeed: {self}")

    def _error_details(self) -> str:
        if self.structured_error_msg == NONE:
            return ""
        try:
            err = json.loads(self.structured_error_msg)
        except json.JSONDecodeError:
            return self.structured_error_msg
        if not isinstance(err, dict):  # user code may write arbitrary JSON
            return self.structured_error_msg
        msg = err.get("message", {})
        if isinstance(msg, str):
            return msg
        ext = msg.get("extraInfo", {})
        ts = ext.get("timestamp")
        when = (
            datetime.fromtimestamp(int(ts)).isoformat() if ts else "<unknown time>"
        )
        return (
            f"{msg.get('message', '')}\n"
            f"  exitcode: {err.get('exitcode', '<n/a>')}\n"
            f"  hostname: {err.get('hostname', '<n/a>')}\n"
            f"  timestamp: {when}\n"
            f"  python_traceback: {ext.get('py_callstack', '<n/a>')}"
        )

    def format(self, colored: bool = False) -> str:
        def paint(state: AppState) -> str:
            if not colored:
                return str(state)
            from torchx_tpu_torch.util.colors import colored as c, state_color

            return c(state.name, state_color(state.name))

        top = paint(self.state)
        if self.failure_class is not None and self.state in (
            AppState.FAILED,
            AppState.PREEMPTED,
        ):
            top = f"{top} ({self.failure_class.value.lower()})"
        lines = [
            f"AppStatus:",
            f"  state: {top}",
            f"  num_restarts: {self.num_restarts}",
        ]
        if self.msg:
            lines.append(f"  msg: {self.msg}")
        if self.ui_url:
            lines.append(f"  ui_url: {self.ui_url}")
        details = self._error_details()
        if details:
            lines.append("  error:")
            lines.extend("    " + ln for ln in details.splitlines())
        for rs in self.roles:
            lines.append(f"  role: {rs.role}")
            for r in rs.replicas:
                host = f" on {r.hostname}" if r.hostname else ""
                lines.append(f"    [{r.id}] {paint(r.state)}{host}")
        return "\n".join(lines)

    def __str__(self) -> str:
        return (
            f"AppStatus(state={self._state_str()},"
            f" num_restarts={self.num_restarts}, msg={self.msg!r})"
        )


class AppStatusError(Exception):
    def __init__(self, status: AppStatus, message: str) -> None:
        super().__init__(f"{message}\n{status.format()}")
        self.status = status


# =========================================================================
# Dry-run info
# =========================================================================

T = TypeVar("T")


@dataclass
class AppDryRunInfo(Generic[T]):
    """The fully materialized scheduler request, pre-submission.

    This is the single most important testability hook in the design
    (reference analog: schedulers/api.py:410-426): ``submit_dryrun`` returns
    the complete backend payload (Popen argv / sbatch script / JobSet dict)
    without submitting, so tests assert on it with no cluster.
    """

    request: T
    fmt: Callable[[T], str] = str
    # filled in by Scheduler.submit_dryrun:
    _app: Optional[AppDef] = None
    _cfg: Optional[Mapping[str, Any]] = None
    _scheduler: Optional[str] = None

    def __str__(self) -> str:
        return self.fmt(self.request)


# =========================================================================
# runopts — typed scheduler run-config schema
# =========================================================================

CfgVal = Union[str, int, float, bool, list[str], dict[str, str], None]


class InvalidRunConfigException(Exception):
    def __init__(self, reason: str, cfg_key: str, runopts_: "runopts") -> None:
        super().__init__(f"{reason}. Available options:\n{runopts_}")
        self.cfg_key = cfg_key


@dataclass
class runopt:
    default: CfgVal
    opt_type: type
    is_required: bool
    help: str


# (schema-identity, key) pairs already warned about as unknown-
# passthrough: warn once per key PER SCHEMA, not per process — a typo'd
# key on scheduler B must still warn after scheduler A warned about its
# own key of the same name (advisor r4). Schema identity is the frozen
# set of declared opt names, NOT id(self): run_opts() builds a fresh
# runopts per call, so instance identity would re-warn on every submit
# (and GC'd-id reuse would falsely suppress).
_warned_unknown_opts: set[tuple[frozenset, str]] = set()


class runopts:
    """Schema + validator for per-scheduler run configs.

    Reference analog: torchx/specs/api.py:838-1154 (runopts container with
    resolve() validation, string/JSON parsing, camelCase aliasing, merge).
    """

    def __init__(self) -> None:
        self._opts: dict[str, runopt] = {}

    def add(
        self,
        cfg_key: str,
        type_: type,
        help: str,
        default: CfgVal = None,
        required: bool = False,
    ) -> None:
        if required and default is not None:
            raise ValueError(f"required option {cfg_key} must not have a default")
        self._opts[cfg_key] = runopt(default, type_, required, help)

    def get(self, key: str) -> Optional[runopt]:
        return self._opts.get(key)

    def __iter__(self) -> Iterator[tuple[str, runopt]]:
        return iter(self._opts.items())

    def __or__(self, other: "runopts") -> "runopts":
        merged = runopts()
        merged._opts = {**self._opts, **other._opts}
        return merged

    @staticmethod
    def canonical(key: str) -> str:
        """camelCase -> snake_case aliasing so ``imageRepo`` finds ``image_repo``."""
        return re.sub(r"(?<=[a-z0-9])([A-Z])", r"_\1", key).lower()

    def resolve(self, cfg: Mapping[str, CfgVal]) -> dict[str, CfgVal]:
        """Validate + fill defaults. Unknown keys warn-pass-through (so
        plugins can piggyback), wrong types and missing-required raise."""
        resolved: dict[str, CfgVal] = {}
        seen = set()
        for key, val in cfg.items():
            ckey = key if key in self._opts else self.canonical(key)
            opt = self._opts.get(ckey)
            if opt is None:
                # the passthrough exists for plugin/forward compat, so a
                # legitimate plugin key must not warn on every submit:
                # warn once per key per schema (fresh runopts instances of
                # the same schema share warned-ness; see module note)
                schema_id = frozenset(self._opts)
                if (schema_id, key) not in _warned_unknown_opts:
                    _warned_unknown_opts.add((schema_id, key))
                    warnings.warn(
                        f"unknown runopt {key!r} passed through unvalidated"
                        f" (known: {sorted(self._opts)})",
                        stacklevel=2,
                    )
                resolved[key] = val  # pass through for forward/plugin compat
                continue
            seen.add(ckey)
            if val is None:
                resolved[ckey] = opt.default
                continue
            val = self._coerce(ckey, val, opt)
            resolved[ckey] = val
        for key, opt in self._opts.items():
            if key in seen:
                continue
            if opt.is_required:
                raise InvalidRunConfigException(
                    f"missing required option: {key}", key, self
                )
            resolved[key] = opt.default
        return resolved

    def _coerce(self, key: str, val: CfgVal, opt: runopt) -> CfgVal:
        t = opt.opt_type
        if isinstance(val, str) and t is not str:
            return _decode_cfg_str(val, t, key, self)
        if t is float and isinstance(val, int) and not isinstance(val, bool):
            return float(val)
        if not isinstance(val, t):
            raise InvalidRunConfigException(
                f"option {key} expected {t.__name__},"
                f" got {type(val).__name__} ({val!r})",
                key,
                self,
            )
        return val

    def cfg_from_str(self, cfg_str: str) -> dict[str, CfgVal]:
        """Parse ``k1=v1,k2=v2;k3=v3`` (both ``,`` and ``;`` separate pairs;
        a list-typed value uses ``,`` within — parse is type-directed)."""
        cfg: dict[str, CfgVal] = {}
        if not cfg_str.strip():
            return cfg
        for pair in re.split(r"[;,]", cfg_str):
            pair = pair.strip()
            if not pair:
                continue
            if "=" not in pair:
                # continuation of a previous list/dict value (the value itself
                # contained commas, which also separate cfg pairs)
                last = next(reversed(cfg), None)
                if last is not None and isinstance(cfg[last], list):
                    cfg[last].append(pair)  # type: ignore[union-attr]
                    continue
                if last is not None and isinstance(cfg[last], dict) and ":" in pair:
                    k, _, v = pair.partition(":")
                    cfg[last][k] = v  # type: ignore[index]
                    continue
                raise InvalidRunConfigException(
                    f"malformed cfg pair {pair!r} (expected key=value)", pair, self
                )
            key, _, val = pair.partition("=")
            key = key.strip()
            ckey = key if key in self._opts else self.canonical(key)
            opt = self._opts.get(ckey)
            if opt is not None and opt.opt_type is list:
                cfg[ckey] = val.split(",") if val else []
            elif opt is not None:
                cfg[ckey] = _decode_cfg_str(val, opt.opt_type, ckey, self)
            else:
                cfg[key] = val
        return cfg

    def cfg_from_json_repr(self, json_repr: str) -> dict[str, CfgVal]:
        return {k: v for k, v in json.loads(json_repr).items()}

    def __repr__(self) -> str:
        lines = []
        for key, opt in self._opts.items():
            req = "required" if opt.is_required else f"default: {opt.default!r}"
            lines.append(f"    {key} ({opt.opt_type.__name__}, {req}): {opt.help}")
        return "\n".join(lines) or "    <no options>"

    __str__ = __repr__


def _decode_cfg_str(val: str, t: type, key: str, opts: runopts) -> CfgVal:
    try:
        if t is bool:
            low = val.strip().lower()
            if low in ("true", "1", "yes", "on"):
                return True
            if low in ("false", "0", "no", "off"):
                return False
            raise ValueError(f"not a bool: {val!r}")
        if t is int:
            return int(val)
        if t is float:
            return float(val)
        if t is list:
            return val.split(",") if val else []
        if t is dict:
            return dict(p.split(":", 1) for p in val.split(",") if p)
        return val
    except (ValueError, TypeError) as e:
        raise InvalidRunConfigException(
            f"option {key} could not parse {val!r} as {t.__name__}: {e}", key, opts
        ) from e


# =========================================================================
# App handles
# =========================================================================

AppHandle = str

_HANDLE_RE = re.compile(
    r"^(?P<scheduler>[a-z_\-0-9]+)://(?P<session>[^/]*)/(?P<app_id>.+)$"
)


class MalformedAppHandleException(Exception):
    def __init__(self, app_handle: str) -> None:
        super().__init__(
            f"malformed app handle: {app_handle!r}"
            " (expected scheduler://[session]/app_id)"
        )


def make_app_handle(scheduler_backend: str, session_name: str, app_id: str) -> AppHandle:
    return f"{scheduler_backend}://{session_name}/{app_id}"


def parse_app_handle(app_handle: AppHandle) -> tuple[str, str, str]:
    """-> (scheduler_backend, session_name, app_id)"""
    m = _HANDLE_RE.match(app_handle)
    if not m:
        raise MalformedAppHandleException(app_handle)
    return m.group("scheduler"), m.group("session"), m.group("app_id")


# =========================================================================
# Structured error files (in-job side writes, client side reads)
# =========================================================================


def make_structured_error(message: str, exitcode: int = 1, hostname: str = "") -> str:
    """JSON error payload written to $TPX_ERROR_FILE by failing replicas;
    format mirrors the torchelastic error file the reference consumes
    (specs/api.py:689-719)."""
    import socket
    import time

    return json.dumps(
        {
            "message": {
                "message": message,
                "extraInfo": {"timestamp": int(time.time()), "py_callstack": ""},
            },
            "exitcode": exitcode,
            "hostname": hostname or socket.gethostname(),
        }
    )
