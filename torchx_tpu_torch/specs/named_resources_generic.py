"""Generic t-shirt-size named resources (CPU-only helper roles).

Copied from the JAX package as it is (reference analog:
torchx/specs/named_resources_generic.py:46-61).
"""

from __future__ import annotations

from typing import Callable, Mapping

from torchx_tpu_torch.specs.api import Resource

GiB = 1024


def _mk(name: str, cpu: int, mem_gb: int) -> Callable[[], Resource]:
    def factory() -> Resource:
        return Resource(cpu=cpu, memMB=mem_gb * GiB)

    factory.__name__ = name
    return factory


def named_resources_generic() -> Mapping[str, Callable[[], Resource]]:
    return {
        "cpu_nano": _mk("cpu_nano", 1, 1),
        "cpu_micro": _mk("cpu_micro", 1, 2),
        "cpu_small": _mk("cpu_small", 2, 8),
        "cpu_medium": _mk("cpu_medium", 8, 32),
        "cpu_large": _mk("cpu_large", 16, 64),
        "cpu_xlarge": _mk("cpu_xlarge", 32, 128),
    }
