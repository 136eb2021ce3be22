"""Plugin system public interface: the port of :mod:`torchx_tpu.plugins`,
discovering under the port's own entry-point groups and namespace package
(:mod:`._registry`). Consumed by :data:`torchx_tpu_torch.specs.named_resources`
(named-resource plugins) and, once ported, the scheduler factories and the
tracker layer.
"""

from typing import Any, Callable, Mapping, Optional

from torchx_tpu_torch.plugins._registration import Share, register  # noqa: F401
from torchx_tpu_torch.plugins._registry import (  # noqa: F401
    PluginRegistrar,
    PluginSource,
    PluginType,
    error_report,
    get_registry,
)


def get_plugin_schedulers() -> Mapping[str, Callable[..., Any]]:
    """Scheduler factories registered by plugins, keyed by backend name
    (override built-ins of the same name)."""
    return dict(get_registry().schedulers)


def get_plugin_named_resources() -> Mapping[str, Callable[[], Any]]:
    """Named-resource factories registered by plugins."""
    return dict(get_registry().named_resources)


def get_plugin_trackers() -> Mapping[str, Callable[[Optional[str]], Any]]:
    """Tracker factories registered by plugins (config-string arg)."""
    return dict(get_registry().trackers)
