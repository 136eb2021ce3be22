"""Named resources for GPU slices: the port's counterpart of the JAX
package's ``named_resources_tpu.py``.

Maps slice names (``"h100-16"``, or ``"h100_16"``) to fully specified
:class:`Resource` objects: host CPU/RAM per replica, the :class:`GpuSlice`,
the cards one host exposes as ``devices["nvidia.com/gpu"]`` (the k8s
limit), and the GKE node-pool label of the generation.

A replica runs on one host. Its CPU and RAM are the host shape of the gcp
catalog (:mod:`named_resources_gcp`: the H100's ``a3-highgpu-8g``, 208 vCPU,
1872 GB, with its allocatable tax), divided per GPU for a slice smaller
than a host.
"""

from __future__ import annotations

from typing import Callable, Mapping

from torchx_tpu_torch.specs.api import GPU_GENERATIONS, GpuSlice, Resource
from torchx_tpu_torch.specs.named_resources_gcp import _GPU_SHAPES, MEM_TAX, GiB

#: The gcp catalog's host each generation's slices are cut from.
_HOST_SHAPE = {"h100": "gpu_h100_8"}

#: The slice sizes registered by name. Any other size that fills whole
#: hosts resolves through :func:`gpu_slice` (``named_resources["h100-24"]``).
_CATALOG_GPUS: dict[str, list[int]] = {"h100": [1, 2, 4, 8, 16, 32, 64]}


def _resource(sl: GpuSlice) -> Resource:
    host_gpus, _, _, host_cpu, host_mem_gb = _GPU_SHAPES[_HOST_SHAPE[sl.accelerator]]
    share = sl.gpus_per_host
    return Resource(
        cpu=host_cpu * share // host_gpus,
        memMB=int(host_mem_gb * GiB * MEM_TAX * share / host_gpus),
        gpu=sl,
        devices={"nvidia.com/gpu": share},
        capabilities={
            "gke.accelerator": GPU_GENERATIONS[sl.accelerator]["gke_accelerator"],
            "gpu.accelerator_type": sl.accelerator_type,
        },
    )


def gpu_slice(accelerator_type: str) -> Resource:
    """Resource for an arbitrary accelerator-type string, e.g. "h100-24"."""
    return _resource(GpuSlice.from_type(accelerator_type))


def _mk(gen: str, gpus: int) -> Callable[[], Resource]:
    def factory() -> Resource:
        return _resource(GpuSlice(accelerator=gen, gpus=gpus))

    factory.__name__ = f"{gen}_{gpus}"
    return factory


def named_resources_gpu() -> Mapping[str, Callable[[], Resource]]:
    """Registry: both ``h100_16`` and the accelerator type ``h100-16``."""
    out: dict[str, Callable[[], Resource]] = {}
    for gen, sizes in _CATALOG_GPUS.items():
        for gpus in sizes:
            f = _mk(gen, gpus)
            out[f"{gen}_{gpus}"] = f
            out[GpuSlice(accelerator=gen, gpus=gpus).accelerator_type] = f
    return out
