"""Experiment tracking / lineage API.

Port of :mod:`torchx_tpu.tracker.api`.
Reference analog: torchx/tracker/api.py (275 LoC):

* :class:`TrackerBase` — backend ABC (artifacts, metadata, lineage, run ids).
* :class:`AppRun` — the in-job API; ``AppRun.run_from_env()`` reads the env
  vars the Runner injected at dryrun (TPX_JOB_ID / TPX_TRACKERS /
  TPX_TRACKER_<NAME>_CONFIG) and fans writes out to every configured backend.

Client side, :func:`tracker_config_env_vars` turns the entries configured in
``.tpxconfig`` ``[tracker:<name>]`` sections into those env vars. Tracker
factories come from the port's own entry-point group,
``tpx_torch.trackers`` (a plugin of the JAX launcher's ``tpx_trackers`` or
``tpx.trackers`` is not loaded), the plugin registry, a ``module:fn``
spec, or the builtins ``fsspec`` and ``mlflow``.
"""

from __future__ import annotations

import importlib
import logging
import os
from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from typing import Any, Iterable, Mapping, Optional

from torchx_tpu_torch import settings

logger = logging.getLogger(__name__)


@dataclass
class TrackerArtifact:
    name: str
    path: str
    metadata: Optional[Mapping[str, Any]] = None


@dataclass
class TrackerSource:
    source_run_id: str
    artifact_name: Optional[str] = None


@dataclass
class Lineage:
    run_id: str
    sources: list[TrackerSource]
    # downstream runs that declared run_id as a source (backends that can
    # answer the reverse query populate it; others leave it empty)
    descendants: list[str] = field(default_factory=list)


class TrackerBase(ABC):
    """Backend contract (reference tracker/api.py:61-122)."""

    @abstractmethod
    def add_artifact(
        self, run_id: str, name: str, path: str, metadata: Optional[Mapping[str, Any]] = None
    ) -> None:
        """Record a named artifact (path/URL + optional metadata) on a run."""
        ...

    @abstractmethod
    def artifacts(self, run_id: str) -> Mapping[str, TrackerArtifact]:
        """All artifacts of a run, keyed by name."""
        ...

    @abstractmethod
    def add_metadata(self, run_id: str, **kwargs: Any) -> None:
        """Merge key=value metadata onto a run."""
        ...

    @abstractmethod
    def metadata(self, run_id: str) -> Mapping[str, Any]:
        """A run's accumulated metadata."""
        ...

    @abstractmethod
    def add_source(
        self, run_id: str, source_id: str, artifact_name: Optional[str] = None
    ) -> None:
        """Link ``source_id`` (a parent run, optionally one artifact of
        it) as an input of this run — the lineage edge."""
        ...

    @abstractmethod
    def sources(
        self, run_id: str, artifact_name: Optional[str] = None
    ) -> Iterable[TrackerSource]:
        """The runs (optionally filtered to one artifact) this run
        consumed."""
        ...

    @abstractmethod
    def run_ids(self, **kwargs: str) -> Iterable[str]:
        """Known run ids, newest last; backends may accept filter
        kwargs (e.g. ``parent_run_id``)."""
        ...

    def lineage(self, run_id: str) -> Lineage:
        """The run's source edges as a :class:`Lineage` record."""
        return Lineage(run_id=run_id, sources=list(self.sources(run_id)))


# =========================================================================
# Factory / env-var plumbing
# =========================================================================

# entry-point group name for tracker backend factories (the port's own, the
# one its plugin registry reads too)
TRACKER_ENTRYPOINT_GROUP = "tpx_torch.trackers"


def _load_tracker(name: str, config: Optional[str]) -> Optional[TrackerBase]:
    """name is either an entry-point name or a ``module:fn`` factory spec;
    the factory takes (config: str | None) and returns a TrackerBase."""
    factory = None
    try:
        from importlib.metadata import entry_points

        for ep in entry_points(group=TRACKER_ENTRYPOINT_GROUP):
            if ep.name == name:
                factory = ep.load()
                break
    except Exception:  # noqa: BLE001
        pass
    if factory is None:
        # plugin registry wins over module:fn interpretation (a plugin may
        # legitimately register a colon-containing name)
        try:
            from torchx_tpu_torch.plugins import get_plugin_trackers

            factory = get_plugin_trackers().get(name)
        except ImportError:
            pass
    if factory is None and ":" in name:
        mod_name, _, fn_name = name.partition(":")
        try:
            factory = getattr(importlib.import_module(mod_name), fn_name)
        except (ImportError, AttributeError) as e:
            logger.warning("cannot load tracker %r: %s", name, e)
            return None
    if factory is None:
        # builtin shorthand
        if name == "fsspec":
            from torchx_tpu_torch.tracker.backend.fsspec import create as factory
        elif name == "mlflow":
            from torchx_tpu_torch.tracker.mlflow import create as factory
        else:
            logger.warning("unknown tracker backend %r", name)
            return None
    try:
        return factory(config)
    except Exception as e:  # noqa: BLE001
        logger.warning("tracker %r factory failed: %s", name, e)
        return None


def trackers_from_environ() -> dict[str, TrackerBase]:
    """In-job: instantiate every tracker named in $TPX_TRACKERS."""
    names = [
        n.strip()
        for n in os.environ.get(settings.ENV_TPX_TRACKERS, "").split(",")
        if n.strip()
    ]
    out: dict[str, TrackerBase] = {}
    for name in names:
        key = name.replace(":", "_").replace(".", "_").upper()
        config = os.environ.get(f"{settings.ENV_TPX_TRACKER_PREFIX}{key}_CONFIG")
        tracker = _load_tracker(name, config)
        if tracker is not None:
            out[name] = tracker
    return out


def tracker_config_env_vars(
    parent_run_id: Optional[str] = None,
    trackers: Optional[Mapping[str, Optional[str]]] = None,
) -> dict[str, str]:
    """Client side: env vars the Runner injects into every role at dryrun
    (reference runner/api.py:68-87,358-391). ``trackers`` maps backend name
    -> optional config string; default comes from .tpxconfig [tracker:*]."""
    if trackers is None:
        from torchx_tpu_torch.runner.config import load_tracker_sections

        trackers = load_tracker_sections()
    if not trackers:
        return {}
    env = {settings.ENV_TPX_TRACKERS: ",".join(trackers)}
    for name, config in trackers.items():
        if config:
            key = name.replace(":", "_").replace(".", "_").upper()
            env[f"{settings.ENV_TPX_TRACKER_PREFIX}{key}_CONFIG"] = config
    if parent_run_id:
        env[settings.ENV_TPX_PARENT_RUN_ID] = parent_run_id
    return env


# =========================================================================
# In-job AppRun facade
# =========================================================================


class AppRun:
    """Job-side tracking handle fanning out to all configured backends."""

    _instance: Optional["AppRun"] = None

    def __init__(self, id: str, backends: Mapping[str, TrackerBase]) -> None:
        self.id = id
        self.backends = dict(backends)

    @classmethod
    def run_from_env(cls) -> "AppRun":
        """Singleton built from scheduler-injected env (TPX_JOB_ID et al.).

        Outside a tpx-launched job, returns an id of "<unknown_run_id>" with
        zero backends: all calls become no-ops so user code runs unchanged.
        """
        if cls._instance is None:
            run_id = os.environ.get(settings.ENV_TPX_JOB_ID, "<unknown_run_id>")
            backends = trackers_from_environ()
            run = cls(run_id, backends)
            parent = os.environ.get(settings.ENV_TPX_PARENT_RUN_ID)
            if parent:
                run.add_source(parent)
            cls._instance = run
        return cls._instance

    def add_metadata(self, **kwargs: Any) -> None:
        """Fan ``key=value`` metadata out to every configured backend."""
        for b in self.backends.values():
            b.add_metadata(self.id, **kwargs)

    def add_artifact(
        self, name: str, path: str, metadata: Optional[Mapping[str, Any]] = None
    ) -> None:
        """Record an artifact on this job's run in every backend."""
        for b in self.backends.values():
            b.add_artifact(self.id, name, path, metadata)

    def add_source(self, source_id: str, artifact_name: Optional[str] = None) -> None:
        """Link a parent run as an input of this job's run."""
        for b in self.backends.values():
            b.add_source(self.id, source_id, artifact_name)
