"""compute_mesh_size — the end-to-end probe app, on torch.distributed.

The port of :mod:`torchx_tpu.examples.compute_mesh_size`: one
``all_reduce`` of a one over every rank of the gang validates the launch,
the rendezvous, the process group and a global collective. Run it through
the bootstrap, which starts one worker per card and joins the group:

    python -m torchx_tpu_torch.apps.spmd_main -m torchx_tpu_torch.examples.compute_mesh_size
    python -m torchx_tpu_torch.apps.spmd_main --nproc-per-node 2 \\
        -m torchx_tpu_torch.examples.compute_mesh_size          # the CPU, gloo

Alone, it initializes a group of one.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from torchx_tpu_torch import distributed, settings


def compute_mesh_size() -> int:
    """Sum a one over every rank; print it beside the world size."""
    distributed.init_from_env()
    n_global = dist.get_world_size()
    dev = torch.device("cuda", torch.cuda.current_device()) if dist.get_backend() == "nccl" \
        else torch.device("cpu")
    ones = torch.ones(1, device=dev)
    dist.all_reduce(ones)
    mesh_size = int(ones.item())
    print(
        f"process={dist.get_rank()}/{n_global}"
        f" local_devices={distributed.local_device_count()} global_devices={n_global}"
        f" computed_mesh_size={mesh_size}",
        flush=True,
    )
    if mesh_size != n_global:
        raise RuntimeError(f"all_reduce summed {mesh_size} over {n_global} ranks")
    return mesh_size


def maybe_inject_fault() -> None:
    """Fault-injection hook: ``TPX_EXAMPLE_THROWS=1`` always throws;
    ``TPX_EXAMPLE_THROWS=once:/path/marker`` throws only on the first
    attempt (creates the marker); ``TPX_EXAMPLE_THROWS_REPLICA=N`` scopes
    the fault to one replica of the gang."""
    spec = os.environ.get(settings.ENV_TPX_EXAMPLE_THROWS)
    if not spec:
        return
    want = os.environ.get(settings.ENV_TPX_EXAMPLE_THROWS_REPLICA)
    if want is not None and os.environ.get(settings.ENV_TPX_REPLICA_ID, "0") != want:
        return
    if spec.startswith("once:"):
        marker = spec[len("once:"):]
        if os.path.exists(marker):
            return
        with open(marker, "w"):
            pass
    raise RuntimeError(f"injected failure (TPX_EXAMPLE_THROWS={spec})")


def main() -> None:
    maybe_inject_fault()
    size = compute_mesh_size()
    print(f"mesh size: {size}", flush=True)


if __name__ == "__main__":
    main()
