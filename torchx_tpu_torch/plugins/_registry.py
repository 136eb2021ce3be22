"""Plugin discovery registry: the port of :mod:`torchx_tpu.plugins._registry`.

Reference analog: torchx/plugins/_registry.py (552 LoC). Plugins extend the
launcher with schedulers, named resources, and trackers through two
discovery sources:

1. **Entry points** — groups ``tpx_torch.schedulers``,
   ``tpx_torch.named_resources``, ``tpx_torch.trackers``: each entry loads
   to a factory (schedulers/trackers) or a mapping-returning function
   (named resources).
2. **Namespace packages** — any importable ``tpx_torch_plugins.<name>`` module
   whose module-level ``register(registry)`` function is called with a
   :class:`PluginRegistrar` to register programmatically (supports implicit
   namespace dirs on sys.path).

The groups and the namespace are the port's own, not the JAX launcher's
(``tpx.*``, ``tpx_plugins``): a plugin written for the JAX launcher imports
``torchx_tpu`` and hands back its objects (a ``Resource`` with a TPU
slice), which this launcher must neither load nor mix with its own.

$TPX_PLUGINS_SOURCE is a bitmask enabling sources (1 = entry points,
2 = namespace packages; default 3 = both; 0 disables plugins entirely).
Discovery is lazy and cached; a failing plugin is captured — with its
traceback — into the error report rather than breaking the CLI.
"""

from __future__ import annotations

import enum
import importlib
import logging
import os
import pkgutil
import traceback
from dataclasses import dataclass, field
from typing import Any, Callable, Mapping, Optional

from torchx_tpu_torch import settings

logger = logging.getLogger(__name__)

NAMESPACE_PACKAGE = "tpx_torch_plugins"

EP_GROUP_SCHEDULERS = "tpx_torch.schedulers"
EP_GROUP_NAMED_RESOURCES = "tpx_torch.named_resources"
EP_GROUP_TRACKERS = "tpx_torch.trackers"


class PluginType(enum.Enum):
    SCHEDULER = "scheduler"
    NAMED_RESOURCE = "named_resource"
    TRACKER = "tracker"


class PluginSource(enum.IntFlag):
    ENTRY_POINTS = 1
    NAMESPACE = 2
    ALL = 3


@dataclass
class PluginError:
    plugin: str
    error: str
    tb: str


@dataclass
class _Registry:
    schedulers: dict[str, Callable[..., Any]] = field(default_factory=dict)
    named_resources: dict[str, Callable[[], Any]] = field(default_factory=dict)
    trackers: dict[str, Callable[[Optional[str]], Any]] = field(default_factory=dict)
    errors: list[PluginError] = field(default_factory=list)


class PluginRegistrar:
    """Handed to namespace-package ``register(registrar)`` hooks."""

    def __init__(self, registry: _Registry) -> None:
        self._registry = registry

    def scheduler(self, name: str, factory: Callable[..., Any]) -> None:
        self._registry.schedulers[name] = factory

    def named_resource(self, name: str, factory: Callable[[], Any]) -> None:
        self._registry.named_resources[name] = factory

    def tracker(self, name: str, factory: Callable[[Optional[str]], Any]) -> None:
        self._registry.trackers[name] = factory


_registry: Optional[_Registry] = None


def _enabled_sources() -> PluginSource:
    raw = os.environ.get(settings.ENV_TPX_PLUGINS_SOURCE)
    if raw is None:
        return PluginSource.ALL
    try:
        return PluginSource(int(raw))
    except ValueError:
        logger.warning("bad %s=%r; using ALL", settings.ENV_TPX_PLUGINS_SOURCE, raw)
        return PluginSource.ALL


def _capture(registry: _Registry, plugin: str, e: Exception) -> None:
    registry.errors.append(
        PluginError(plugin=plugin, error=str(e), tb=traceback.format_exc())
    )
    logger.warning("plugin %s failed to load: %s", plugin, e)


def _discover_entry_points(registry: _Registry) -> None:
    try:
        from importlib.metadata import entry_points
    except ImportError:  # pragma: no cover
        return
    for group, target in (
        (EP_GROUP_SCHEDULERS, registry.schedulers),
        (EP_GROUP_NAMED_RESOURCES, registry.named_resources),
        (EP_GROUP_TRACKERS, registry.trackers),
    ):
        try:
            eps = entry_points(group=group)
        except Exception as e:  # noqa: BLE001
            _capture(registry, group, e)
            continue
        for ep in eps:
            try:
                loaded = ep.load()
                if group == EP_GROUP_NAMED_RESOURCES and ep.name.endswith(
                    "named_resources"
                ):
                    # catalog convention: an entry named *named_resources
                    # returns a mapping of many factories. Other entries are
                    # single-resource factories and are NOT invoked at
                    # discovery time (they may probe their environment).
                    result = loaded()
                    if isinstance(result, Mapping):
                        registry.named_resources.update(result)
                    else:
                        raise TypeError(
                            f"{ep.name} must return a mapping of factories"
                        )
                else:
                    target[ep.name] = loaded
            except Exception as e:  # noqa: BLE001
                _capture(registry, f"{group}:{ep.name}", e)


def _discover_namespace(registry: _Registry) -> None:
    try:
        ns = importlib.import_module(NAMESPACE_PACKAGE)
    except ImportError:
        return
    registrar = PluginRegistrar(registry)
    paths = list(getattr(ns, "__path__", []))
    for info in pkgutil.iter_modules(paths, NAMESPACE_PACKAGE + "."):
        try:
            module = importlib.import_module(info.name)
            register = getattr(module, "register", None)
            if callable(register):
                register(registrar)
        except Exception as e:  # noqa: BLE001
            _capture(registry, info.name, e)


def get_registry(invalidate_cache: bool = False) -> _Registry:
    global _registry
    if _registry is not None and not invalidate_cache:
        return _registry
    registry = _Registry()
    sources = _enabled_sources()
    if sources & PluginSource.ENTRY_POINTS:
        _discover_entry_points(registry)
    if sources & PluginSource.NAMESPACE:
        _discover_namespace(registry)
    # programmatic registrations (decorators) always apply
    from torchx_tpu_torch.plugins import _registration

    registry.schedulers.update(_registration._SCHEDULERS)
    registry.named_resources.update(_registration._NAMED_RESOURCES)
    registry.trackers.update(_registration._TRACKERS)
    _registry = registry
    if invalidate_cache:
        # downstream caches merged from this registry must refresh too
        try:
            from torchx_tpu_torch.specs import invalidate_named_resources_cache

            invalidate_named_resources_cache()
        except ImportError:
            pass
    return registry


def error_report() -> str:
    """Human-readable report of plugin load failures (YAML-ish)."""
    lines = []
    for err in get_registry().errors:
        lines.append(f"- plugin: {err.plugin}")
        lines.append(f"  error: {err.error}")
    return "\n".join(lines) or "no plugin errors"
