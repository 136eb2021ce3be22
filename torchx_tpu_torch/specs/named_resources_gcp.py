"""Named resources for heterogeneous GCP fleets: GPU node pools and GCE
machine types.

The GCP analog of the reference's AWS instance-type catalog
(torchx/specs/named_resources_aws.py:1-631, which models EC2 shapes with
GPU counts and EFA device plumbing). Copied from the JAX package as it is;
the port's H100 slices, which carry a :class:`~.api.GpuSlice`, live in
their own catalog (:mod:`named_resources_gpu`). This module covers the node
pools of a mixed cluster:

* **GPU shapes** — ``Resource.devices["nvidia.com/gpu"]`` carries the GPU
  count (the k8s resource limit), ``capabilities["gke.accelerator"]``
  carries the GKE node-pool accelerator label
  (``cloud.google.com/gke-accelerator``), and
  ``capabilities["gce.machine_type"]`` the backing instance type. The GKE
  backend turns these into limits + node selectors + the GPU taint
  toleration; the docker backend maps the devices dict to ``/dev/nvidia*``
  mounts (schedulers/devices.py).
* **GCE machine types** — plain CPU shapes that pin
  ``node.kubernetes.io/instance-type`` on GKE and ``machineType`` on
  gcp_batch/vertex.

Memory carries an allocatable tax (MEM_TAX,
reference named_resources_aws.py:48).
"""

from __future__ import annotations

from typing import Callable, Mapping

from torchx_tpu_torch.specs.api import Resource

MEM_TAX = 0.96
GiB = 1024


def _gpu(
    name: str,
    gpus: int,
    accelerator: str,
    machine_type: str,
    cpu: int,
    mem_gb: int,
) -> Callable[[], Resource]:
    def factory() -> Resource:
        return Resource(
            cpu=cpu,
            memMB=int(mem_gb * GiB * MEM_TAX),
            devices={"nvidia.com/gpu": gpus},
            capabilities={
                "gke.accelerator": accelerator,
                "gce.machine_type": machine_type,
            },
        )

    factory.__name__ = name
    return factory


def _machine(name: str, machine_type: str, cpu: int, mem_gb: int) -> Callable[[], Resource]:
    def factory() -> Resource:
        return Resource(
            cpu=cpu,
            memMB=int(mem_gb * GiB * MEM_TAX),
            capabilities={"gce.machine_type": machine_type},
        )

    factory.__name__ = name
    return factory


# GPU node-pool shapes: (gpus, gke accelerator label, machine type, vCPU, GB)
_GPU_SHAPES: dict[str, tuple[int, str, str, int, int]] = {
    # A100 40GB (a2-highgpu): 12 vCPU / 85 GB per GPU
    "gpu_a100_1": (1, "nvidia-tesla-a100", "a2-highgpu-1g", 12, 85),
    "gpu_a100_2": (2, "nvidia-tesla-a100", "a2-highgpu-2g", 24, 170),
    "gpu_a100_4": (4, "nvidia-tesla-a100", "a2-highgpu-4g", 48, 340),
    "gpu_a100_8": (8, "nvidia-tesla-a100", "a2-highgpu-8g", 96, 680),
    # A100 80GB (a2-ultragpu)
    "gpu_a100_80gb_1": (1, "nvidia-a100-80gb", "a2-ultragpu-1g", 12, 170),
    "gpu_a100_80gb_8": (8, "nvidia-a100-80gb", "a2-ultragpu-8g", 96, 1360),
    # H100 80GB (a3-highgpu): sold as whole 8-GPU hosts
    "gpu_h100_8": (8, "nvidia-h100-80gb", "a3-highgpu-8g", 208, 1872),
    # L4 (g2-standard): 1-8 GPUs
    "gpu_l4_1": (1, "nvidia-l4", "g2-standard-12", 12, 48),
    "gpu_l4_2": (2, "nvidia-l4", "g2-standard-24", 24, 96),
    "gpu_l4_4": (4, "nvidia-l4", "g2-standard-48", 48, 192),
    "gpu_l4_8": (8, "nvidia-l4", "g2-standard-96", 96, 384),
    # T4 / V100 legacy pools (attachable to n1)
    "gpu_t4_1": (1, "nvidia-tesla-t4", "n1-standard-8", 8, 30),
    "gpu_t4_4": (4, "nvidia-tesla-t4", "n1-standard-32", 32, 120),
    "gpu_v100_1": (1, "nvidia-tesla-v100", "n1-standard-8", 8, 30),
    "gpu_v100_8": (8, "nvidia-tesla-v100", "n1-standard-96", 96, 360),
}

# GCE machine types for CPU roles: (machine type, vCPU, GB)
_MACHINE_SHAPES: dict[str, tuple[str, int, int]] = {
    "gce_e2_standard_4": ("e2-standard-4", 4, 16),
    "gce_e2_standard_8": ("e2-standard-8", 8, 32),
    "gce_n2_standard_8": ("n2-standard-8", 8, 32),
    "gce_n2_standard_16": ("n2-standard-16", 16, 64),
    "gce_n2_standard_32": ("n2-standard-32", 32, 128),
    "gce_c3_standard_22": ("c3-standard-22", 22, 88),
    "gce_c3_standard_44": ("c3-standard-44", 44, 176),
    "gce_n2_highmem_16": ("n2-highmem-16", 16, 128),
    "gce_n2_highmem_32": ("n2-highmem-32", 32, 256),
}


def named_resources_gcp() -> Mapping[str, Callable[[], Resource]]:
    out: dict[str, Callable[[], Resource]] = {}
    for name, (gpus, accel, machine, cpu, mem) in _GPU_SHAPES.items():
        out[name] = _gpu(name, gpus, accel, machine, cpu, mem)
    for name, (machine, cpu, mem) in _MACHINE_SHAPES.items():
        out[name] = _machine(name, machine, cpu, mem)
        out[machine] = out[name]  # raw GCE naming ("n2-standard-8") too
    return out
