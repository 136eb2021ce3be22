"""Public interface of the specs layer: the port of :mod:`torchx_tpu.specs`.

Re-exports the data model and hosts the named-resource registry with merge
order generic < gcp < gpu < custom ($TPX_CUSTOM_NAMED_RESOURCES) < plugins
(the port's own plugin groups, :mod:`torchx_tpu_torch.plugins`).
"""

from __future__ import annotations

import importlib
import logging
import os
from typing import Callable, Mapping, Optional

from torchx_tpu_torch import settings
from torchx_tpu_torch.specs.api import (  # noqa: F401
    NONE,
    NULL_RESOURCE,
    RESOURCE_UNSET,
    AppDef,
    AppDryRunInfo,
    AppHandle,
    AppState,
    AppStatus,
    AppStatusError,
    BindMount,
    CfgVal,
    DeviceMount,
    FailureClass,
    GpuSlice,
    InvalidRunConfigException,
    MalformedAppHandleException,
    MountType,
    ReplicaStatus,
    Resource,
    RetryPolicy,
    Role,
    RoleStatus,
    VolumeMount,
    Workspace,
    is_started,
    is_terminal,
    macros,
    make_app_handle,
    make_structured_error,
    parse_app_handle,
    parse_mounts,
    runopt,
    runopts,
)
from torchx_tpu_torch.specs.named_resources_gcp import named_resources_gcp
from torchx_tpu_torch.specs.named_resources_generic import named_resources_generic
from torchx_tpu_torch.specs.named_resources_gpu import gpu_slice, named_resources_gpu

logger = logging.getLogger(__name__)

_named_resource_factories: Optional[dict[str, Callable[[], Resource]]] = None


def _load_custom_factories() -> Mapping[str, Callable[[], Resource]]:
    """$TPX_CUSTOM_NAMED_RESOURCES is a comma list of ``module[:fn]`` specs;
    each fn returns a mapping of name -> factory."""
    out: dict[str, Callable[[], Resource]] = {}
    spec = os.environ.get(settings.ENV_TPX_CUSTOM_NAMED_RESOURCES, "")
    for entry in filter(None, (s.strip() for s in spec.split(","))):
        mod_name, _, fn_name = entry.partition(":")
        try:
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, fn_name or "named_resources")
            out.update(fn())
        except Exception as e:  # noqa: BLE001 - custom modules must not kill the CLI
            logger.warning("failed to load custom named resources %r: %s", entry, e)
    return out


def _factories() -> dict[str, Callable[[], Resource]]:
    global _named_resource_factories
    if _named_resource_factories is None:
        merged: dict[str, Callable[[], Resource]] = {}
        merged.update(named_resources_generic())
        merged.update(named_resources_gcp())
        merged.update(named_resources_gpu())
        merged.update(_load_custom_factories())
        try:  # plugins may not be importable during bootstrap
            from torchx_tpu_torch.plugins import get_plugin_named_resources

            merged.update(get_plugin_named_resources())
        except ImportError:
            pass
        _named_resource_factories = merged
    return _named_resource_factories


class _NamedResources(Mapping[str, Resource]):
    """Lazy mapping view: ``named_resources["h100-16"]`` -> Resource.

    Falls back to parsing unknown keys as accelerator-type strings so any
    slice size works without being pre-registered.
    """

    def __getitem__(self, name: str) -> Resource:
        f = _factories().get(name)
        if f is not None:
            return f()
        try:
            return gpu_slice(name)
        except ValueError:
            raise KeyError(
                f"unknown named resource {name!r}; known: {sorted(_factories())[:20]}..."
            ) from None

    def __contains__(self, name: object) -> bool:
        if name in _factories():
            return True
        try:
            gpu_slice(str(name))
            return True
        except ValueError:
            return False

    def __iter__(self):
        return iter(_factories())

    def __len__(self) -> int:
        return len(_factories())


named_resources: Mapping[str, Resource] = _NamedResources()


def resource(
    cpu: Optional[float] = None,
    memMB: Optional[int] = None,
    gpu: Optional[str] = None,
    h: Optional[str] = None,
) -> Resource:
    """Resource factory used by components.

    ``h`` (named resource, e.g. "h100-16" or "cpu_small") wins over explicit
    cpu/memMB/gpu (an accelerator type, "h100-8"), matching the reference's precedence
    (torchx/specs/__init__.py:75-181).
    """
    if h:
        return named_resources[h]
    return Resource(
        cpu=cpu if cpu is not None else 1,
        memMB=memMB if memMB is not None else 1024,
        gpu=GpuSlice.from_type(gpu) if gpu else None,
    )


def get_named_resources() -> Mapping[str, Callable[[], Resource]]:
    """Every registered named resource (generic < gcp < gpu < custom env <
    plugins, later wins), keyed by name."""
    return dict(_factories())


def invalidate_named_resources_cache() -> None:
    """Re-merge the registry on next access (called when plugins reload)."""
    global _named_resource_factories
    _named_resource_factories = None
