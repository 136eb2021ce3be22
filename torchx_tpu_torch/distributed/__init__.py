"""In-job distributed helpers: the port of :mod:`torchx_tpu.distributed`.

The launcher injects the gang identity (``TPX_REPLICA_ID``,
``TPX_NUM_REPLICAS``, ``TPX_COORDINATOR_HOST``) into every replica.
:func:`init_from_env` turns it into a live ``torch.distributed`` process
group, which :mod:`torchx_tpu_torch.apps.spmd_main` calls for the user's
code (the reference TorchX's ``init_pg(backend="auto")``).

A JAX replica is one process per host that owns all of the host's chips.
Here a replica is still one host, but it runs one process per card, the
torch idiom: ``spmd_main`` starts the workers and tells each its place in
the replica through ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE`` (torchrun's
names). A worker's global rank is ``replica_id * local_world + local_rank``
and the world is ``num_replicas * local_world``.

Divergences from the JAX package: the GKE TPU fallbacks
(``TPU_WORKER_ID``, ``TPU_WORKER_HOSTNAMES``) are not read; and the process
group is initialized at world 1 too (through an in-process store, no port),
because torch's collectives need a group where JAX needs no coordinator.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import time
from typing import Any, Callable, Iterator, Optional

import torch
import torch.distributed as dist

from torchx_tpu_torch import settings

#: torchrun's names for a worker's place within its replica (host).
ENV_LOCAL_RANK = "LOCAL_RANK"
ENV_LOCAL_WORLD_SIZE = "LOCAL_WORLD_SIZE"

#: The port of the gang's rendezvous store on the coordinator, which replica
#: 0's ``spmd_main`` hosts (:func:`host_store`). ``spmd_main`` sets it for its
#: workers in every gang of more than one rank.
ENV_STORE_PORT = "TPX_TORCH_STORE_PORT"

#: Seconds a collective (and the rendezvous) may wait for its peers before
#: it raises, so that a rank that died leaves no peer hanging for good.
DEFAULT_TIMEOUT_S = 600.0


def is_tpx_job() -> bool:
    """True when running inside a tpx-launched replica."""
    return settings.ENV_TPX_APP_ID in os.environ


def gang_info() -> tuple[int, int, str]:
    """(replica_id, num_replicas, coordinator_host) from the injected env.

    ``TPX_REPLICA_ID`` is the global id; backends that inject the
    multi-slice decomposition instead give ``slice_id * hosts_per_slice +
    host_id``. Defaults: replica 0 of 1 on ``localhost``."""
    raw = os.environ.get(settings.ENV_TPX_REPLICA_ID)
    if raw is None:
        slice_id = os.environ.get(settings.ENV_TPX_SLICE_ID)
        host_id = os.environ.get(settings.ENV_TPX_HOST_ID)
        per_slice = os.environ.get(settings.ENV_TPX_HOSTS_PER_SLICE)
        if slice_id is not None and host_id is not None and per_slice is not None:
            raw = str(int(slice_id) * int(per_slice) + int(host_id))
    replica = int(raw or 0)
    num = int(os.environ.get(settings.ENV_TPX_NUM_REPLICAS) or 0)
    coordinator = os.environ.get(settings.ENV_TPX_COORDINATOR_HOST, "")
    return replica, num or 1, coordinator or "localhost"


def replica_id() -> int:
    """This process's replica (host) id within the role's gang (0-based)."""
    return gang_info()[0]


def num_replicas() -> int:
    """Replicas (hosts) in the role's gang."""
    return gang_info()[1]


def coordinator_address(port: Optional[int] = None) -> str:
    """``host:port`` of replica 0, where the rendezvous store listens."""
    host = gang_info()[2]
    return f"{host}:{port or settings.TPX_COORDINATOR_PORT}"


def local_rank() -> int:
    """This worker's index among its replica's workers (0 outside
    ``spmd_main``)."""
    return int(os.environ.get(ENV_LOCAL_RANK) or 0)


def local_device_count() -> int:
    """Workers (one per card) in this process's replica."""
    return int(os.environ.get(ENV_LOCAL_WORLD_SIZE) or 1)


def world_layout() -> tuple[int, int]:
    """(global rank, world size) of this worker, from the gang's env."""
    replica, n, _ = gang_info()
    nproc = local_device_count()
    return replica * nproc + local_rank(), n * nproc


def default_backend() -> str:
    """NCCL where the process has a card, gloo on the CPU."""
    return "nccl" if torch.cuda.is_available() else "gloo"


def init_from_env(
    backend: Optional[str] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> None:
    """Initialize the default process group from the gang's env. Idempotent:
    a no-op where a group is up already.

    ``backend`` overrides :func:`default_backend`. A world of 1 rendezvouses
    through an in-process store. A larger one joins, as a client, the TCP
    store that replica 0's ``spmd_main`` hosts on the coordinator at
    ``$TPX_TORCH_STORE_PORT`` (:func:`host_store`), waiting for it up to
    ``timeout_s``; outside ``spmd_main`` such a world is refused."""
    if dist.is_initialized():
        return
    rank, world = world_layout()
    backend = backend or default_backend()
    timeout = datetime.timedelta(seconds=timeout_s)
    if world == 1:
        dist.init_process_group(
            backend, store=dist.HashStore(), rank=0, world_size=1, timeout=timeout
        )
        return
    store_port = os.environ.get(ENV_STORE_PORT)
    if not store_port:
        raise RuntimeError(
            f"a gang of {world} ranks rendezvouses through the store that replica 0's "
            "spmd_main hosts: launch it with torchx_tpu_torch.apps.spmd_main"
        )
    store = dist.TCPStore(gang_info()[2], int(store_port), world, is_master=False,
                          timeout=timeout)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                            timeout=timeout)


def host_store(port: int, timeout_s: float = DEFAULT_TIMEOUT_S) -> "dist.TCPStore":
    """The gang's rendezvous store, hosted by replica 0's ``spmd_main`` on
    ``port`` (0: a port the system picks, read back as ``.port``), which
    hands the bound port to its workers as ``$TPX_TORCH_STORE_PORT``. At
    port 0 nothing is chosen first and bound later, so no other process can
    take the port in between."""
    return dist.TCPStore("127.0.0.1", port, None, is_master=True,
                         timeout=datetime.timedelta(seconds=timeout_s),
                         wait_for_workers=False)


def world_device_count() -> int:
    """Ranks (cards) across the whole gang: the process group's world."""
    return dist.get_world_size() if dist.is_initialized() else 1


def is_process_zero() -> bool:
    """True on the gang's rank 0 (the logging and checkpoint guard)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    """All ranks meet: a one-element all-reduce on the default group (on
    the card under NCCL), a no-op without a group."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return
    dev = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dist.all_reduce(torch.zeros(1, device=dev))


def any_rank(flag: bool) -> bool:
    """``flag`` set on any rank of the default group (a MAX all-reduce, on
    the card under NCCL); the flag itself without a group or at a world of
    one. Ranks that must take one branch together (stop at a step, raise
    on a failed restore) decide with it, so that none waits in a later
    collective for a rank that took the other."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return flag
    dev = "cuda" if dist.get_backend() == "nccl" else "cpu"
    t = torch.tensor([int(flag)], device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def broadcast_from_zero(obj: Any) -> Any:
    """Rank 0's ``obj`` (picklable) on every rank of the default group;
    ``obj`` itself without a group."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def poll_until(
    ready: Callable[[], bool], timeout_s: float, what: str, interval_s: float = 0.05,
) -> float:
    """Wait until ``ready()``, polling every ``interval_s``. -> the seconds
    waited; raises :class:`TimeoutError` naming ``what`` past ``timeout_s``.

    Ranks coordinate through durable files on their shared disk with it
    where a collective cannot serve: a checkpoint's commit runs on writer
    threads while the step loop issues its own collectives on the same
    group, and a c10d call from a second thread would interleave with
    them. A rank that died leaves the waiter a timeout, never a hang."""
    t0 = time.monotonic()
    while not ready():
        if time.monotonic() - t0 > timeout_s:
            raise TimeoutError(f"{what}: not there after {timeout_s:.0f} s")
        time.sleep(interval_s)
    return time.monotonic() - t0


@contextlib.contextmanager
def on_process_zero_first() -> Iterator[None]:
    """Rank 0 runs the body before everyone else (a build or download done
    once), the reference's ``on_rank0_first``; the barrier is a collective
    on the default group."""
    if is_process_zero():
        yield
        barrier()
    else:
        barrier()
        yield
