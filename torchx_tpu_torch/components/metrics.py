"""Metrics/observability components.

Port of :mod:`torchx_tpu.components.metrics` (reference analog:
torchx/components/metrics.py:31-86, tensorboard wrapped
in process_monitor).
"""

from __future__ import annotations

from typing import Optional

import torchx_tpu_torch.specs as specs
from torchx_tpu_torch.version import TORCHX_TPU_IMAGE


def tensorboard(
    logdir: str,
    image: str = TORCHX_TPU_IMAGE,
    timeout: float = 86400.0,
    port: int = 6006,
    start_on_file: Optional[str] = None,
    exit_on_file: Optional[str] = None,
) -> specs.AppDef:
    """Run a TensorBoard server next to a training job, supervised by
    process_monitor so it starts when training produces logs and exits when
    training finishes.

    Args:
        logdir: log directory (local or fsspec URL) to serve
        image: image to use
        timeout: maximum seconds to keep the server up
        port: port to serve on
        start_on_file: wait for this marker file before starting
        exit_on_file: exit when this marker file appears
    """
    monitor_args = ["-m", "torchx_tpu_torch.apps.process_monitor", "--timeout", str(timeout)]
    if start_on_file:
        monitor_args += ["--start_on_file", start_on_file]
    if exit_on_file:
        monitor_args += ["--exit_on_file", exit_on_file]
    monitor_args += [
        "--",
        "tensorboard",
        "--bind_all",
        "--port",
        str(port),
        "--logdir",
        logdir,
    ]
    return specs.AppDef(
        name="tensorboard",
        roles=[
            specs.Role(
                name="tensorboard",
                image=image,
                entrypoint="python",
                args=monitor_args,
                port_map={"http": port},
                resource=specs.Resource(cpu=2, memMB=4096),
            )
        ],
    )
