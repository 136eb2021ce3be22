"""Named-device -> mount mapping.

Reference analog: torchx/schedulers/devices.py:17-54 — translates the
named devices in ``Resource.devices`` (e.g. the EFA NIC on AWS, the
``nvidia.com/gpu`` count of a GKE node) into the DeviceMounts a container
backend needs. For GPU roles the docker backend mounts the cards this host
actually has via :func:`local_gpu_device_mounts` (keyed on
``Resource.gpu``, not the devices dict).
"""

from __future__ import annotations

import logging
from typing import Callable

from torchx_tpu_torch.specs.api import DeviceMount

logger = logging.getLogger(__name__)


def _nvidia_mounts(count: int) -> list[DeviceMount]:
    return [
        DeviceMount(src_path=f"/dev/nvidia{i}", dst_path=f"/dev/nvidia{i}")
        for i in range(count)
    ] + [
        DeviceMount(src_path="/dev/nvidiactl", dst_path="/dev/nvidiactl"),
        DeviceMount(src_path="/dev/nvidia-uvm", dst_path="/dev/nvidia-uvm"),
    ]


# NOTE: a GPU role's cards come from Resource.gpu, not from a named device
# (see specs/api.py Resource.devices contract): the docker backend mounts
# them via local_gpu_device_mounts() keyed on Resource.gpu instead.
DEVICE_MAPPINGS: dict[str, Callable[[int], list[DeviceMount]]] = {
    "nvidia.com/gpu": _nvidia_mounts,
}


def local_gpu_device_mounts() -> list[DeviceMount]:
    """Mounts for the cards THIS host has (used by the docker scheduler for
    GPU roles): every ``/dev/nvidia<N>`` node, in order of N, plus the
    driver's control nodes ``/dev/nvidiactl`` and ``/dev/nvidia-uvm``. No
    card node, no mounts."""
    import glob
    import re

    cards = [p for p in glob.glob("/dev/nvidia[0-9]*") if re.fullmatch(r"/dev/nvidia\d+", p)]
    if not cards:
        return []
    cards.sort(key=lambda p: int(p[len("/dev/nvidia"):]))
    nodes = [*cards, "/dev/nvidiactl", "/dev/nvidia-uvm"]
    return [DeviceMount(src_path=dev, dst_path=dev) for dev in nodes]


def get_device_mounts(devices: dict[str, int]) -> list[DeviceMount]:
    """Resource.devices -> DeviceMounts; unknown names warn and skip
    (backends that understand them natively, like k8s resource limits,
    consume them from Resource.devices directly)."""
    mounts: list[DeviceMount] = []
    for name, count in devices.items():
        mapper = DEVICE_MAPPINGS.get(name)
        if mapper is None:
            logger.warning("no device mount mapping for %r; skipping", name)
            continue
        mounts.extend(mapper(count))
    return mounts
