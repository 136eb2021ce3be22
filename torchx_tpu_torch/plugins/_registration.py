"""Programmatic plugin registration decorators.

Reference analog: torchx/plugins/_registration.py (434 LoC):

    from torchx_tpu_torch.plugins import register

    @register.scheduler("mysched", alias="ms")
    def create_scheduler(session_name, **kwargs): ...

    @register.named_resource("superpod", fractions=True)
    def superpod() -> Resource: ...

    @register.tracker("mytracker")
    def create_tracker(config): ...

``fractions=True`` on a GPU named resource additionally registers
``<name>_half`` / ``<name>_quarter`` variants whose slices hold half /
quarter of the cards (the reference's fractional-GPU shares,
_registration.py:36-52): on a multi-tenant host, replicas with fractional
resources share the host's cards.
"""

from __future__ import annotations

import copy
import enum
from typing import Any, Callable, Optional

_SCHEDULERS: dict[str, Callable[..., Any]] = {}
_NAMED_RESOURCES: dict[str, Callable[[], Any]] = {}
_TRACKERS: dict[str, Callable[[Optional[str]], Any]] = {}


class Share(enum.Enum):
    WHOLE = 1
    HALF = 2
    QUARTER = 4


def _fractional(factory: Callable[[], Any], share: Share) -> Callable[[], Any]:
    def fraction() -> Any:
        from torchx_tpu_torch.specs.api import GpuSlice, Resource

        res: Resource = copy.deepcopy(factory())
        divisor = share.value
        res.cpu = max(1, int(res.cpu // divisor))
        res.memMB = max(1, res.memMB // divisor)
        if res.gpu is not None and res.gpu.gpus >= divisor:
            res.gpu = GpuSlice(
                accelerator=res.gpu.accelerator,
                gpus=res.gpu.gpus // divisor,
            )
        res.tags["tpx.share"] = share.name.lower()
        return res

    return fraction


class register:
    """Decorator namespace (used as ``@register.scheduler(...)``)."""

    @staticmethod
    def scheduler(
        name: str, alias: Optional[str] = None
    ) -> Callable[[Callable[..., Any]], Callable[..., Any]]:
        def deco(factory: Callable[..., Any]) -> Callable[..., Any]:
            _SCHEDULERS[name] = factory
            if alias:
                _SCHEDULERS[alias] = factory
            return factory

        return deco

    @staticmethod
    def named_resource(
        name: str, alias: Optional[str] = None, fractions: bool = False
    ) -> Callable[[Callable[[], Any]], Callable[[], Any]]:
        def deco(factory: Callable[[], Any]) -> Callable[[], Any]:
            _NAMED_RESOURCES[name] = factory
            if alias:
                _NAMED_RESOURCES[alias] = factory
            if fractions:
                _NAMED_RESOURCES[f"{name}_half"] = _fractional(factory, Share.HALF)
                _NAMED_RESOURCES[f"{name}_quarter"] = _fractional(
                    factory, Share.QUARTER
                )
            return factory

        return deco

    @staticmethod
    def tracker(
        name: str, alias: Optional[str] = None
    ) -> Callable[[Callable[[Optional[str]], Any]], Callable[[Optional[str]], Any]]:
        def deco(factory: Callable[[Optional[str]], Any]) -> Callable[[Optional[str]], Any]:
            _TRACKERS[name] = factory
            if alias:
                _TRACKERS[alias] = factory
            return factory

        return deco


def clear_registrations() -> None:
    """Test helper: reset programmatic registrations."""
    _SCHEDULERS.clear()
    _NAMED_RESOURCES.clear()
    _TRACKERS.clear()
