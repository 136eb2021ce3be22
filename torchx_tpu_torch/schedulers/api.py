"""Scheduler interface: the lifecycle contract every backend implements.

The port's copy of :mod:`torchx_tpu.schedulers.api`, with GPU slices in
place of TPU slices. Reference analog: torchx/schedulers/api.py:364-526.
The load-bearing design decision (kept): ``submit = resolve cfg -> build workspace -> submit_dryrun
-> schedule`` where ``submit_dryrun`` returns the *complete materialized
backend request* without submitting — tests assert on that request object
with no cluster (reference api.py:410-426).
"""

from __future__ import annotations

import subprocess
from abc import ABC, abstractmethod
from dataclasses import dataclass
from enum import Enum
from typing import Any, Generic, Iterable, Mapping, Optional, TypeVar

from torchx_tpu_torch.specs.api import (
    AppDef,
    AppDryRunInfo,
    AppState,
    CfgVal,
    FailureClass,
    Role,
    RoleStatus,
    runopts,
)

T = TypeVar("T")


class Stream(str, Enum):
    STDOUT = "stdout"
    STDERR = "stderr"
    COMBINED = "combined"


@dataclass
class DescribeAppResponse:
    """Scheduler's view of a submitted app (reference api.py:330-345).

    ``failure_class`` carries the backend's classification of a terminal
    failure when the describe payload itself reveals it (spot reclamation,
    node disruption); :meth:`Scheduler.classify_failure` reads it before
    falling back to the conservative default.
    """

    app_id: str = "<NOT_SET>"
    state: AppState = AppState.UNSUBMITTED
    num_restarts: int = -1
    msg: str = ""
    structured_error_msg: str = "<NONE>"
    ui_url: Optional[str] = None
    roles_statuses: list[RoleStatus] = None  # type: ignore[assignment]
    roles: list[Role] = None  # type: ignore[assignment]
    failure_class: Optional[FailureClass] = None

    def __post_init__(self) -> None:
        if self.roles_statuses is None:
            self.roles_statuses = []
        if self.roles is None:
            self.roles = []


@dataclass
class ListAppResponse:
    app_id: str
    state: AppState
    name: str = ""


@dataclass(frozen=True)
class SchedulerCapabilities:
    """Static feature profile of a scheduler backend.

    Declared as a module-level ``CAPABILITIES`` constant (and ``capabilities``
    class attribute) by every backend in :mod:`torchx_tpu_torch.schedulers` so the
    preflight analyzer (:mod:`torchx_tpu_torch.analyze`) can reject AppDefs that
    use features the target backend cannot honor *before* submission — e.g.
    mounts on a backend that ignores them, multi-role apps on gcp_batch, or
    a retry budget on a backend with no native restart support.

    Attributes:
        mounts: backend materializes Bind/Volume/Device mounts.
        multi_role: backend can launch more than one role per app.
        requires_gpu: backend only accepts roles with a GPU resource.
        multislice: backend wires a multi-slice gang's identity (a GPU
            role with ``num_replicas > 1``: ``TPX_SLICE_ID`` / ``TPX_HOST_ID``
            / ``TPX_HOSTS_PER_SLICE``).
        delete: backend implements :meth:`Scheduler.delete` — terminal
            attempts can be cleaned up by the supervisor before resubmit.
        resize: backend implements :meth:`Scheduler.resize`.
        logs: backend implements :meth:`Scheduler.log_iter`.
        native_retries: backend honors ``Role.max_retries`` itself
            (in-place restarts that do not consume supervisor budgets).
        concrete_resources: backend builds real resource requests from
            ``Resource.cpu`` / ``Resource.memMB`` (unset values fall back
            to backend defaults but are worth a warning).
        classifies_preemption: backend can distinguish PREEMPTED from FAILED
            in :meth:`Scheduler.classify_failure` — without it, preemptions
            burn the supervisor's (default zero) APP_ERROR budget.
        watch: backend has a *native* event source behind
            :meth:`Scheduler.watch` (local sidecar mtime, GKE kubectl
            stream) — transitions surface at event latency. Without it the
            same ``watch()`` interface still works but rides the generic
            poll adapter, so hang/terminal detection latency degrades to
            the watch poll interval (what analyze rule TPX601 warns about).
        metricz_scrape: replicas launched by this backend expose a
            ``/metricz`` endpoint the control daemon's telemetry
            collector can reach over the network (loopback for local
            backends, cluster DNS for GKE). Without it, SLO specs over
            replica-side metrics see no samples — burn rates stay zero
            and the alerts are dead weight (analyze rule TPX214).
    """

    mounts: bool = False
    multi_role: bool = True
    requires_gpu: bool = False
    multislice: bool = False
    delete: bool = False
    resize: bool = False
    logs: bool = True
    native_retries: bool = False
    concrete_resources: bool = False
    classifies_preemption: bool = False
    watch: bool = False
    metricz_scrape: bool = False


def dquote(s: str) -> str:
    """Double-quote a string for bash: metachars are safe but ``$VAR`` /
    ``${VAR}`` references (runtime macro values like the replica id) still
    expand. Command substitution is neutralized both ways — backticks and
    ``$(...)`` are escaped, since intentional variable expansion never
    requires running commands from inside role args/env values. Shared by
    every scheduler that materializes shell scripts."""
    out = (
        s.replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("`", "\\`")
        .replace("$(", "\\$(")
    )
    return '"' + out + '"'


def safe_int(value: Any, default: int = 0) -> int:
    """int() that never raises (scheduler payloads are untrusted JSON)."""
    try:
        return int(value)
    except (TypeError, ValueError):
        return default


def filter_regex(regex: str, data: Iterable[str]) -> Iterable[str]:
    """Lazily filter log lines by a regex (reference api.py:528-539)."""
    import re

    r = re.compile(regex)
    return (line for line in data if r.search(line))


_STAMP_RE = None  # compiled lazily; the pattern matches a real epoch only

# stdin->stdout line stamper (``<epoch.millis> <line>``) run as
# ``python3 -u -c``; shared by the remote-host wrappers and the slurm
# batch-script wrapper so every backend's window filter can reuse
# parse_epoch_stamp
EPOCH_STAMPER = (
    "import sys,time\n"
    "for line in sys.stdin:\n"
    "    sys.stdout.write(f'{time.time():.3f} '+line)\n"
    "    sys.stdout.flush()\n"
)



def parse_epoch_stamp(line: str) -> "tuple[Optional[float], str]":
    """-> (epoch or None, payload) for log lines stamped ``<epoch.millis> ``.

    Shared by the remote-host stampers and the local Tee: anything not
    shaped like a real epoch (legacy logs, raw writes, lines that merely
    start with a number like '3 retries left') passes through unstamped."""
    global _STAMP_RE
    if _STAMP_RE is None:
        import re

        _STAMP_RE = re.compile(r"^\d{9,12}\.\d{3}$")
    head, sep, rest = line.partition(" ")
    if sep and _STAMP_RE.match(head):
        return float(head), rest
    return None, line


def rfc3339(epoch: float) -> str:
    """Epoch seconds -> the RFC3339 UTC form Cloud Logging filters expect
    (shared by the gcp_batch and vertex log windows)."""
    from datetime import datetime, timezone

    return (
        datetime.fromtimestamp(epoch, tz=timezone.utc)
        .isoformat()
        .replace("+00:00", "Z")
    )


def window_stamped_lines(
    lines: Iterable[str],
    since: Optional[float] = None,
    until: Optional[float] = None,
) -> Iterable[str]:
    """Apply a since/until window to epoch-stamped lines and strip the
    stamps. Unstamped lines pass through whole (no stamp -> no window)."""
    for line in lines:
        ts, payload = parse_epoch_stamp(line)
        if ts is not None:
            if since is not None and ts < since:
                continue
            if until is not None and ts > until:
                continue
        yield payload


def split_lines(text: str) -> list[str]:
    """Split keeping trailing newlines on each line (reference api.py:541-554)."""
    lines = text.splitlines(keepends=True)
    return lines


class Scheduler(ABC, Generic[T]):
    """Backend lifecycle contract.

    Subclasses implement ``_submit_dryrun`` (materialize the full request),
    ``schedule`` (actually submit), ``describe``, ``list``, and
    ``_cancel_existing``; optionally ``log_iter``, ``delete``, ``_validate``.
    """

    # Feature profile consulted by the preflight analyzer; backends override
    # with their module's CAPABILITIES constant. None = unknown backend
    # profile, capability rules are skipped.
    capabilities: Optional[SchedulerCapabilities] = None

    def __init__(self, backend: str, session_name: str) -> None:
        self.backend = backend
        self.session_name = session_name

    # -- control-plane seam ------------------------------------------------

    def _cmd(
        self, cmd: list[str], op: str, **kwargs: Any
    ) -> "subprocess.CompletedProcess":
        """Run one control-plane CLI call through the resilient seam
        (:func:`torchx_tpu_torch.resilience.call.resilient_cmd`): default
        deadline, transient-vs-permanent classification, per-kind retries,
        the backend's circuit breaker, and ``TPX_FAULT_PLAN`` injection.

        Backends keep ``_run_cmd`` as the raw subprocess seam (and the
        test monkeypatch point); call sites go through ``_cmd`` with a
        logical ``op`` name ("describe", "list", ...) so retries and
        faults are attributable. Non-idempotent ops (submits) must pass
        ``policy=NON_IDEMPOTENT`` — a call that may have reached the
        control plane is never replayed."""
        from torchx_tpu_torch.resilience.call import resilient_cmd

        run_cmd = getattr(self, "_run_cmd", None)
        if run_cmd is None:
            raise NotImplementedError(
                f"{type(self).__name__} has no _run_cmd subprocess seam"
            )
        return resilient_cmd(
            run_cmd, cmd, backend=self.backend, op=op, **kwargs
        )

    # -- submission path ---------------------------------------------------

    def submit(self, app: AppDef, cfg: Mapping[str, CfgVal]) -> str:
        """Convenience: resolve + workspace + dryrun + schedule."""
        resolved = self.run_opts().resolve(cfg)
        from torchx_tpu_torch.workspace.api import WorkspaceMixin

        if isinstance(self, WorkspaceMixin):
            self.build_workspaces(app.roles, resolved)
        return self.schedule(self.materialize_dryrun(app, resolved))

    def submit_dryrun(self, app: AppDef, cfg: Mapping[str, CfgVal]) -> AppDryRunInfo[T]:
        """Materialize the complete backend request WITHOUT submitting."""
        return self.materialize_dryrun(app, self.run_opts().resolve(cfg))

    def materialize_dryrun(
        self, app: AppDef, resolved_cfg: Mapping[str, CfgVal]
    ) -> AppDryRunInfo[T]:
        """Like submit_dryrun but for callers (Runner) that already resolved
        the cfg — the single materialization point; cfg is resolved exactly
        once per submission path."""
        from torchx_tpu_torch.obs import trace as obs_trace

        with obs_trace.span(
            "scheduler.dryrun",
            session=self.session_name,
            scheduler=self.backend,
            app=app.name,
        ):
            dryrun_info = self._submit_dryrun(app, resolved_cfg)
            for role in app.roles:
                dryrun_info = role.pre_proc_fn(self.backend, dryrun_info)
        dryrun_info._app = app
        dryrun_info._cfg = resolved_cfg
        dryrun_info._scheduler = self.backend
        return dryrun_info

    @abstractmethod
    def _submit_dryrun(self, app: AppDef, cfg: Mapping[str, CfgVal]) -> AppDryRunInfo[T]:
        ...

    @abstractmethod
    def schedule(self, dryrun_info: AppDryRunInfo[T]) -> str:
        """Submit the materialized request; returns the backend app_id."""
        ...

    # -- monitoring path ---------------------------------------------------

    @abstractmethod
    def describe(self, app_id: str) -> Optional[DescribeAppResponse]:
        """The backend's view of the app (state, per-replica statuses),
        or None when the id is unknown."""
        ...

    def list(self) -> list[ListAppResponse]:
        """All apps this backend knows about. Optional."""
        raise NotImplementedError(
            f"{self.backend} scheduler does not support listing apps"
        )

    def watch(
        self, app_ids: "Iterable[str]" = (), interval: Optional[float] = None
    ) -> Any:
        """An event stream over the given apps: a
        :class:`~torchx_tpu_torch.control.watch.Watcher` whose ``events()``
        iterator yields one :class:`~torchx_tpu_torch.control.events.StateEvent`
        per observed state transition.

        Every backend supports this interface; only backends that declare
        the ``watch`` capability back it with a native event source
        (sidecar mtime, kubectl stream). The default is the generic poll
        adapter — still one coalesced describe scan per tick regardless of
        how many waiters consume the stream, and still routed through the
        backend's resilient describe seam."""
        from torchx_tpu_torch.control.watch import PollWatcher

        return PollWatcher(self, app_ids, interval=interval)

    def exists(self, app_id: str) -> bool:
        """True when the backend still knows ``app_id``."""
        return self.describe(app_id) is not None

    def classify_failure(
        self, resp: DescribeAppResponse
    ) -> Optional[FailureClass]:
        """Classify a terminal failure for retry policy (supervisor hook).

        Returns None for non-failure states. The default is conservative:
        PREEMPTED maps to PREEMPTION, everything else that FAILED is an APP
        failure unless the backend's describe already attached a more
        specific ``failure_class`` (retrying a buggy app by default burns
        money; backends that can tell infra faults apart override this or
        populate the response field).
        """
        if resp.state == AppState.PREEMPTED:
            return resp.failure_class or FailureClass.PREEMPTION
        if resp.state == AppState.FAILED:
            return resp.failure_class or FailureClass.APP
        return None

    def cancel(self, app_id: str) -> None:
        """Stop the app if it exists (idempotent); state/logs remain
        describable where the backend allows."""
        if self.exists(app_id):
            self._cancel_existing(app_id)

    @abstractmethod
    def _cancel_existing(self, app_id: str) -> None:
        ...

    def delete(self, app_id: str) -> None:
        """Remove all backend records of a (terminal) app. Optional."""
        raise NotImplementedError(
            f"{self.backend} scheduler does not support app deletion"
        )

    def resize(self, app_id: str, role_name: str, num_replicas: int) -> None:
        """Resize a running role's gang to ``num_replicas`` (AppDef units:
        slices for GPU roles, replicas for CPU roles). Optional.

        SPMD worlds resize by restart: implementations relaunch the gang
        with a coherent world (fresh TPX_NUM_REPLICAS / replica ids /
        slice decomposition) and user code resumes from its checkpoint.
        The manual counterpart of the automatic shrink-on-failure elastic
        path; honors ``Role.min_replicas`` as the floor.
        """
        raise NotImplementedError(
            f"{self.backend} scheduler does not support resizing apps"
        )

    # True when this backend's log_iter actually applies since/until
    # windows (docker: daemon-side; the local Tee and remote
    # hosts: stamped log lines). Backends
    # whose log files carry no per-line timestamps leave it False and the
    # Runner warns rather than silently showing an unwindowed log.
    supports_log_windows: bool = False

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
        """Stream one replica's log lines (optionally regex-filtered,
        time-windowed when ``supports_log_windows``, followed with
        ``should_tail``). Optional."""
        raise NotImplementedError(
            f"{self.backend} scheduler does not support log iteration"
        )

    # -- config / validation ----------------------------------------------

    def run_opts(self) -> runopts:
        """This backend's typed run-config schema (empty by default;
        StructuredOpts subclasses generate theirs from field docstrings)."""
        return runopts()

    def _pre_build_validate(self, app: AppDef, cfg: Mapping[str, CfgVal]) -> None:
        """Hook before workspace build (cheap checks)."""

    def _validate(self, app: AppDef, cfg: Mapping[str, CfgVal]) -> None:
        """Hook after workspace build, before dryrun."""

    def close(self) -> None:
        """Release client connections / child processes. Idempotent."""


# =========================================================================
# Gang expansion: roles with multi-host GPU slices -> per-host replicas
# =========================================================================


def gpu_hosts_for_role(role: Role) -> int:
    """Number of host processes a role's gang needs.

    For GPU roles the gang size is derived from the slice: one replica per
    host (``spmd_main`` there starts one worker a card), and
    ``num_replicas`` then means *number of slices* when >1. CPU roles just
    use num_replicas.
    """
    if role.resource is not None and role.resource.gpu is not None:
        return role.resource.gpu.hosts * max(1, role.num_replicas)
    return role.num_replicas


def role_replica_env(
    role: Role,
    replica_id: int,
    coordinator_host: str,
    coordinator_port: int,
) -> dict[str, str]:
    """Env vars every scheduler injects into each replica: gang identity +
    coordinator bootstrap for ``torch.distributed`` (the analog of the
    reference's c10d endpoint wiring, components/dist.py:234-243).

    A GPU role's replicas also name their slice (``TPX_GPU_ACCELERATOR_TYPE``,
    ``TPX_GPU_TOPOLOGY``) and, for more than one slice, their place in it
    (``TPX_SLICE_ID``, ``TPX_HOST_ID``, ``TPX_HOSTS_PER_SLICE``). All slices
    join one process group at ``coordinator_host``; there is no second
    coordinator for a data-center network, so ``coordinator_port`` (kept
    for the backends' common signature) is not read here."""
    from torchx_tpu_torch import settings

    num = gpu_hosts_for_role(role)
    env = {
        settings.ENV_TPX_REPLICA_ID: str(replica_id),
        settings.ENV_TPX_ROLE_NAME: role.name,
        settings.ENV_TPX_NUM_REPLICAS: str(num),
        settings.ENV_TPX_COORDINATOR_HOST: coordinator_host,
    }
    if role.resource is not None and role.resource.gpu is not None:
        gpu = role.resource.gpu
        env[settings.ENV_TPX_GPU_ACCELERATOR_TYPE] = gpu.accelerator_type
        env[settings.ENV_TPX_GPU_TOPOLOGY] = gpu.default_topology()
        if role.num_replicas > 1:  # multi-slice identity
            # same surface as the GKE pod template's decomposition (there
            # the bootstrap derives the global id from these; here both
            # forms are present and TPX_REPLICA_ID wins)
            env[settings.ENV_TPX_SLICE_ID] = str(replica_id // gpu.hosts)
            env[settings.ENV_TPX_HOST_ID] = str(replica_id % gpu.hosts)
            env[settings.ENV_TPX_HOSTS_PER_SLICE] = str(gpu.hosts)
    return env
