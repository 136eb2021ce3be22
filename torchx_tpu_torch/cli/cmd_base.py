"""SubCommand base: the port of :mod:`torchx_tpu.cli.cmd_base`
(reference analog: torchx/cli/cmd_base.py)."""

from __future__ import annotations

import argparse
import sys
from abc import ABC, abstractmethod
from typing import Any, Optional


class SubCommand(ABC):
    @abstractmethod
    def add_arguments(self, subparser: argparse.ArgumentParser) -> None:
        ...

    @abstractmethod
    def run(self, args: argparse.Namespace) -> None:
        ...


def control_client() -> Optional[Any]:
    """The CLI's proxy decision: a
    :class:`~torchx_tpu_torch.control.client.ControlClient` when
    ``$TPX_CONTROL_ADDR`` points at a ``tpx-torch control`` daemon, None for
    direct-runner mode. A set address with no reachable token is an
    operator error and exits 1 (silently falling back would run the job
    outside the daemon's tenancy caps)."""
    from torchx_tpu_torch.control.client import ControlClientError, maybe_client

    try:
        return maybe_client()
    except ControlClientError as e:
        print(f"control: {e.message}", file=sys.stderr)
        sys.exit(1)
