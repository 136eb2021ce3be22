"""Named-device -> mount mapping, and a GPU role's card request.

Reference analog: torchx/schedulers/devices.py:17-54 — translates the
named devices in ``Resource.devices`` (e.g. the EFA NIC on AWS, the
``nvidia.com/gpu`` count of a GKE node) into the DeviceMounts a container
backend needs. A GPU role's cards come from ``Resource.gpu`` instead: the
docker backend asks the NVIDIA container toolkit for the replica's share of
the cards the CUDA driver sees (:func:`gpu_device_request`), which also
gives the container the driver's libraries. No ``/dev/nvidia<N>`` node
decides a count: a machine may hold the node of a card it cannot use (an
H100 machine of one card had ``nvidia0`` and ``nvidia7``).
"""

from __future__ import annotations

import logging
from typing import Any, Callable

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
# (see specs/api.py Resource.devices contract): the docker backend asks for
# them with gpu_device_request() keyed on Resource.gpu instead.
DEVICE_MAPPINGS: dict[str, Callable[[int], list[DeviceMount]]] = {
    "nvidia.com/gpu": _nvidia_mounts,
}


def local_gpu_ids() -> list[str]:
    """The cards this launcher may hand out (``local_scheduler.local_gpus``:
    its own ``CUDA_VISIBLE_DEVICES``, else the CUDA driver's count), named
    as the NVIDIA container toolkit takes them. The toolkit's ids are
    ``nvidia-smi`` indices or UUIDs, not CUDA ordinals, so an entry that is
    an ordinal becomes the UUID the driver gives that ordinal in this
    process (the driver applies the launcher's ``CUDA_VISIBLE_DEVICES``, so
    ordinal ``j`` is entry ``j``). Entries that are UUIDs already stay; where
    no driver answers for every entry, the entries stay as they are."""
    from torchx_tpu_torch.schedulers import local_scheduler

    gpus = local_scheduler.local_gpus()
    if all(g.startswith(("GPU-", "MIG-")) for g in gpus):
        return gpus
    uuids = local_scheduler.driver_gpu_uuids()
    return uuids if len(uuids) == len(gpus) else gpus


def gpu_device_request(
    gpus_per_host: int, replica_id: int, replicas_on_host: int
) -> dict[str, Any]:
    """The NVIDIA container toolkit's GPU request for one replica of a GPU
    role on this host: driver ``nvidia``, capabilities ``[["gpu"]]`` and the
    replica's share of :func:`local_gpu_ids` by id, split as the local
    scheduler's ``gpu_device_env`` splits ``CUDA_VISIBLE_DEVICES``. In the
    keyword form of ``docker.types.DeviceRequest``, which the docker SDK's
    ``device_requests`` takes as a plain dict. Raises when the host has no
    card or fewer than the replicas ask for."""
    from torchx_tpu_torch.schedulers import local_scheduler

    host_gpus = local_gpu_ids()
    if not host_gpus:
        raise ValueError(
            f"the role asks for {gpus_per_host} GPU(s) a host but the CUDA driver"
            " finds no card on this docker host"
        )
    ids = local_scheduler.gpu_share(gpus_per_host, replica_id, replicas_on_host, host_gpus)
    return {"driver": "nvidia", "device_ids": ids, "capabilities": [["gpu"]]}


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
