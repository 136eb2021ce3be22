"""SubCommand base: the port of :mod:`torchx_tpu.cli.cmd_base`
(reference analog: torchx/cli/cmd_base.py)."""

from __future__ import annotations

import argparse
import os
from abc import ABC, abstractmethod
from typing import Any, Optional

from torchx_tpu_torch import settings


class SubCommand(ABC):
    @abstractmethod
    def add_arguments(self, subparser: argparse.ArgumentParser) -> None:
        ...

    @abstractmethod
    def run(self, args: argparse.Namespace) -> None:
        ...


def control_client() -> Optional[Any]:
    """The CLI's proxy decision: None for direct-runner mode when
    ``$TPX_CONTROL_ADDR`` is unset. A set address names a ``tpx control``
    daemon, whose client (``control/client.py``) is not ported yet: this
    raises :class:`NotImplementedError` naming ROADMAP queue 1 item 2.7,
    and never falls back to direct mode (that would run the job outside
    the daemon's tenancy caps)."""
    if not os.environ.get(settings.ENV_TPX_CONTROL_ADDR):
        return None
    raise NotImplementedError(
        f"${settings.ENV_TPX_CONTROL_ADDR} names a control daemon, whose client"
        " is not ported yet (ROADMAP queue 1 item 2.7 (control/client.py));"
        f" unset ${settings.ENV_TPX_CONTROL_ADDR} to run directly"
    )
