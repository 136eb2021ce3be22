"""Structured CLI argument parsers shared by components.

Port of :mod:`torchx_tpu.components.structured_arg` (reference analog:
torchx/components/structured_arg.py, 236 LoC) —
``StructuredNameArgument`` ({experiment}/{run} name parsing) and
``StructuredJArgument`` (-j with per-host device inference from the named
resource).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from torchx_tpu_torch.specs import named_resources


@dataclasses.dataclass
class StructuredNameArgument:
    """``{app_name}/{role_name}`` with either side optional."""

    app_name: str
    role_name: str

    @classmethod
    def parse_from(
        cls, name: str, default_app: str = "app", default_role: str = "role"
    ) -> "StructuredNameArgument":
        """Parse ``app[/role]`` (either part optional) into names."""
        if "/" in name:
            app, _, role = name.partition("/")
            return cls(app_name=app or default_app, role_name=role or default_role)
        return cls(app_name=name or default_app, role_name=default_role)


@dataclasses.dataclass
class StructuredJArgument:
    """``[min_replicas:]replicas[xnproc]`` where nproc (workers per replica,
    one a card) is inferred from the named resource's GPU slice when
    omitted.

    >>> StructuredJArgument.parse_from("2x4").replicas
    2
    >>> StructuredJArgument.parse_from("2", h="h100-8").nproc
    8
    """

    replicas: int
    nproc: int
    min_replicas: Optional[int] = None

    @classmethod
    def parse_from(cls, j: str, h: Optional[str] = None) -> "StructuredJArgument":
        """Parse a ``-j`` string, inferring nproc from the named
        resource ``h`` when the ``x nproc`` part is omitted."""
        from torchx_tpu_torch.components.dist import parse_j

        min_replicas, replicas, nproc = parse_j(j)
        if nproc is None:
            if h is not None and h in named_resources:
                res = named_resources[h]
                nproc = res.gpu.gpus_per_host if res.gpu else 1
            else:
                nproc = 1
        return cls(replicas=replicas, nproc=nproc, min_replicas=min_replicas)

    def __str__(self) -> str:
        prefix = f"{self.min_replicas}:" if self.min_replicas else ""
        return f"{prefix}{self.replicas}x{self.nproc}"
