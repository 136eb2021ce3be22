"""Scheduler registry: name -> deferred factory.

The port's copy of :mod:`torchx_tpu.schedulers`. Reference analog:
torchx/schedulers/__init__.py:16-68. The first entry is the default
scheduler; plugins (entry-point group ``tpx_torch.schedulers``) can override
the whole table. The built-in table is the JAX package's, in its order,
less ``tpu_vm``: Cloud TPU queued resources allocate TPU slices only, so
that backend has no GPU machine, and GPU VMs without Kubernetes are reached
through ``gcp_batch``.
"""

from __future__ import annotations

import importlib
from typing import Any, Callable

from torchx_tpu_torch.schedulers.api import Scheduler

SchedulerFactory = Callable[..., Scheduler]

# name -> "module:function". Order matters: first is the default.
DEFAULT_SCHEDULER_MODULES: dict[str, str] = {
    "local": "torchx_tpu_torch.schedulers.local_scheduler:create_scheduler",
    "gke": "torchx_tpu_torch.schedulers.gke_scheduler:create_scheduler",
    "slurm": "torchx_tpu_torch.schedulers.slurm_scheduler:create_scheduler",
    "local_docker": "torchx_tpu_torch.schedulers.docker_scheduler:create_scheduler",
    "vertex": "torchx_tpu_torch.schedulers.vertex_scheduler:create_scheduler",
    "gcp_batch": "torchx_tpu_torch.schedulers.gcp_batch_scheduler:create_scheduler",
}


def _deferred(module_fn: str) -> SchedulerFactory:
    def factory(session_name: str, **kwargs: Any) -> Scheduler:
        mod_name, _, fn_name = module_fn.partition(":")
        mod = importlib.import_module(mod_name)
        return getattr(mod, fn_name)(session_name=session_name, **kwargs)

    return factory


def get_scheduler_factories(
    skip_defaults: bool = False,
) -> dict[str, SchedulerFactory]:
    """Name -> factory for every backend: the built-in six (deferred
    imports) plus plugin-registered ones, which override by name."""
    factories: dict[str, SchedulerFactory] = {}
    if not skip_defaults:
        factories = {k: _deferred(v) for k, v in DEFAULT_SCHEDULER_MODULES.items()}
    try:
        from torchx_tpu_torch.plugins import get_plugin_schedulers

        factories.update(get_plugin_schedulers())
    except ImportError:
        pass
    return factories


def get_default_scheduler_name() -> str:
    """The first registered backend ("local"), the CLI's default."""
    return next(iter(DEFAULT_SCHEDULER_MODULES))
