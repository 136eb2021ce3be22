"""Distributed components — the heart of the launcher.

Port of :mod:`torchx_tpu.components.dist` (reference analog:
torchx/components/dist.py, dist.ddp at :162-308). Where ``dist.ddp``
gang-launches ``nodes x procs`` torchrun agents that rendezvous over a c10d
TCPStore, the flagship :func:`spmd` gang-launches **one replica per GPU
host**, each :mod:`torchx_tpu_torch.apps.spmd_main`, which starts one worker
per visible card and joins them in a ``torch.distributed`` group whose
store address comes from the launcher's rendezvous macro
(``macros.coordinator_env`` ≙ the reference's ``rank0_env`` trick at
dist.py:234-243).

Topology model (the JAX component's, with an H100 slice in place of a TPU
slice):

* ``--gpu h100-16`` (or ``-h h100_8``) selects a slice; the gang size is
  the slice's host count (one replica a host of 8 cards; the scheduler
  gives each replica its host's cards) — the user never counts processes
  by hand.
* ``-j N`` with a GPU resource means **N slices**.
* without a GPU resource, ``-j {replicas}x{nproc}`` runs ``replicas``
  replicas of ``nproc`` gloo workers each on the CPU (``--nproc-per-node
  {nproc} --backend gloo``; 1 worker without ``x``) — the local test mode
  (reference analog of ``-j {nnodes}x{nproc_per_node}``).
* ``-j min:max`` lower bound sets ``min_replicas`` for elastic gangs
  (reference dist.py:294-296).
* ``--coordinator_port 0`` lets a one-replica gang's ``spmd_main`` bind the
  rendezvous port itself (a gang of several replicas needs a fixed one).
"""

from __future__ import annotations

import re
import shlex
from typing import Optional

import torchx_tpu_torch.specs as specs
from torchx_tpu_torch import settings
from torchx_tpu_torch.specs.api import macros
from torchx_tpu_torch.version import TORCHX_TPU_IMAGE

# Debug env preset (reference analog: _TORCH_DEBUG_FLAGS, dist.py:70-83):
# NCCL's and torch.distributed's verbose logs, C++ stack traces.
_GPU_DEBUG_FLAGS: dict[str, str] = {
    "NCCL_DEBUG": "INFO",
    "TORCH_DISTRIBUTED_DEBUG": "DETAIL",
    "TORCH_SHOW_CPP_STACKTRACES": "1",
}

_J_RE = re.compile(
    r"^(?:(?P<min>\d+):)?(?P<replicas>\d+)(?:x(?P<nproc>\d+))?$"
)


def parse_j(j: str) -> tuple[Optional[int], int, Optional[int]]:
    """``[min:]replicas[xnproc]`` -> (min_replicas, replicas, nproc).

    >>> parse_j("2x4")
    (None, 2, 4)
    >>> parse_j("1:4")
    (1, 4, None)
    """
    m = _J_RE.match(j.strip())
    if not m:
        raise ValueError(
            f"invalid -j format {j!r}; expected [min_replicas:]replicas[xnproc]"
        )
    return (
        int(m.group("min")) if m.group("min") else None,
        int(m.group("replicas")),
        int(m.group("nproc")) if m.group("nproc") else None,
    )


def spmd(
    *script_args: str,
    script: Optional[str] = None,
    m: Optional[str] = None,
    image: str = TORCHX_TPU_IMAGE,
    name: str = "/",
    gpu: Optional[str] = None,
    h: Optional[str] = None,
    j: str = "1",
    env: Optional[dict[str, str]] = None,
    cpu: int = 2,
    memMB: int = 4096,
    max_retries: int = 0,
    mounts: Optional[list[str]] = None,
    debug: bool = False,
    coordinator_port: int = settings.TPX_COORDINATOR_PORT,
) -> specs.AppDef:
    """Launch a torch SPMD application on an H100 slice (or gloo workers
    on the CPU).

    One replica per GPU host, each ``spmd_main``: one worker per visible
    card, all joined in one ``torch.distributed`` group (NCCL) with the
    rendezvous wired by the launcher, then the user script/module runs
    in each worker. The GPU analog of ``dist.ddp`` without torchrun.

    Args:
        script_args: arguments to the main module or script
        script: script to run (either script or m must be set)
        m: python module to run as __main__
        image: container image (or local dir for the local scheduler)
        name: job name override in the form ``{name}/{role}``
        gpu: GPU accelerator type, e.g. ``h100-8`` / ``h100-16``
        h: named resource (e.g. ``h100_8`` or ``cpu_small``); wins over gpu
        j: ``[min:]replicas[xnproc]`` — replicas = slices when a GPU resource
            is set, else processes; nproc = gloo workers per replica (CPU
            mode only)
        env: extra environment variables
        cpu: cpu per replica (CPU mode only)
        memMB: RAM MB per replica (CPU mode only)
        max_retries: scheduler retries for the whole gang
        mounts: docker-style mount specs
        debug: enable verbose NCCL/torch.distributed debug env preset
        coordinator_port: rendezvous store port on replica 0 (0: a
            one-replica gang's spmd_main binds one itself)
    """
    if (script is None) == (m is None):
        raise ValueError("exactly one of --script and -m must be set")

    min_replicas, replicas, nproc = parse_j(j)

    if gpu or h:
        resource = specs.resource(h=h) if h else specs.named_resources[str(gpu)]
    else:
        resource = specs.resource(cpu=cpu, memMB=memMB)

    workers: list[str] = []
    if resource.gpu is None:
        # local/CI mode: each replica runs `nproc` gloo workers on the CPU
        workers = ["--nproc-per-node", str(nproc or 1), "--backend", "gloo"]
    role_env: dict[str, str] = {}
    if debug:
        role_env.update(_GPU_DEBUG_FLAGS)
    if env:
        role_env.update(env)

    app_name, role_name = _parse_name(name, default_role="spmd")
    if not app_name:
        app_name = _infer_app_name(script, m)

    if script:
        prog = ["--script", script]
    else:
        prog = ["-m", str(m)]

    cmd = [
        "-u",
        "-m",
        "torchx_tpu_torch.apps.spmd_main",
        "--port",
        str(coordinator_port),
        *workers,
        *prog,
        "--",
        *script_args,
    ]

    return specs.AppDef(
        name=app_name,
        roles=[
            specs.Role(
                name=role_name,
                image=image,
                min_replicas=min_replicas,
                entrypoint="python",
                args=cmd,
                env=role_env,
                num_replicas=replicas,
                max_retries=max_retries,
                retry_policy=specs.RetryPolicy.APPLICATION,
                resource=resource,
                port_map={"coordinator": coordinator_port},
                mounts=specs.parse_mounts(mounts) if mounts else [],
            )
        ],
    )


def _parse_name(name: str, default_role: str) -> tuple[str, str]:
    """``{app}/{role}`` with either side optional (reference
    StructuredNameArgument, components/structured_arg.py)."""
    if "/" in name:
        app, _, role = name.partition("/")
        return app, role or default_role
    return name, default_role


def _infer_app_name(script: Optional[str], m: Optional[str]) -> str:
    if script:
        stem = script.rsplit("/", 1)[-1]
        return stem.removesuffix(".py") or "spmd"
    assert m is not None
    return m.rsplit(".", 1)[-1]


def ddp(
    *script_args: str,
    script: Optional[str] = None,
    m: Optional[str] = None,
    image: str = TORCHX_TPU_IMAGE,
    name: str = "/",
    h: Optional[str] = None,
    j: str = "1x2",
    env: Optional[dict[str, str]] = None,
    cpu: int = 2,
    memMB: int = 4096,
    max_retries: int = 0,
    rdzv_port: int = 29500,
    debug: bool = False,
) -> specs.AppDef:
    """Launch a torch DistributedDataParallel app via torchrun (compat
    component for torch workloads launched by torchrun; :func:`spmd` is
    the port's own bootstrap).

    Builds the same c10d rendezvous wiring as the reference's dist.ddp
    (torchx/components/dist.py:224-287): single node uses a dynamic
    localhost endpoint, multi-node defers the coordinator hostname to the
    scheduler-injected env var at runtime.

    Args:
        script_args: arguments to the main module or script
        script: script to run (either script or m must be set)
        m: python module to run as __main__
        image: container image
        name: job name override in the form ``{name}/{role}``
        h: named resource
        j: ``[min_nnodes:]nnodes x nproc_per_node``
        env: extra env variables
        cpu: cpu per replica
        memMB: RAM MB per replica
        max_retries: scheduler retries
        rdzv_port: c10d rendezvous port on the rank0 host
        debug: verbose torch debug env
    """
    if (script is None) == (m is None):
        raise ValueError("exactly one of --script and -m must be set")
    min_nnodes, nnodes, nproc = parse_j(j)
    nproc = nproc or 1
    app_name, role_name = _parse_name(name, default_role="ddp")
    if not app_name:
        app_name = _infer_app_name(script, m)

    single_node = nnodes == 1 and min_nnodes is None
    nnodes_arg = f"{min_nnodes}:{nnodes}" if min_nnodes else str(nnodes)

    role_env = dict(env or {})
    if debug:
        role_env.update(
            {
                "TORCH_DISTRIBUTED_DEBUG": "DETAIL",
                "TORCH_SHOW_CPP_STACKTRACES": "1",
            }
        )

    # multi-node: the coordinator hostname is only known at runtime (the env
    # var *name* comes from the macro; the shell expands the value on each
    # replica — reference dist.py:234-243). `$$` survives macro substitution
    # as a literal `$` for the runtime shell.
    # "$${" + "${coordinator_env}" + ":=localhost}" --macro-substitutes-to->
    # "${TPX_COORDINATOR_HOST:=localhost}:PORT" for the runtime shell.
    rdzv_endpoint = (
        "localhost:0"
        if single_node
        else f"$${{{macros.coordinator_env}:=localhost}}:{rdzv_port}"
    )
    torchrun_args = [
        "-m",
        "torch.distributed.run",
        "--rdzv_backend",
        "c10d",
        "--rdzv_endpoint",
        rdzv_endpoint,
        "--rdzv_id",
        macros.app_id,
        "--nnodes",
        nnodes_arg,
        "--nproc_per_node",
        str(nproc),
        "--tee",
        "3",
        "--role",
        role_name,
    ]
    if script:
        torchrun_args += [script, *script_args]
    else:
        torchrun_args += ["-m", str(m), *script_args]

    if single_node:
        entrypoint = "python"
        args = ["-u", *torchrun_args]
    else:
        entrypoint = "sh"
        shell_cmd = " ".join(
            a if a.startswith("$") else shlex.quote(a)
            for a in ["python", "-u", *torchrun_args]
        )
        args = ["-c", shell_cmd]

    return specs.AppDef(
        name=app_name,
        roles=[
            specs.Role(
                name=role_name,
                image=image,
                min_replicas=min_nnodes,
                entrypoint=entrypoint,
                args=args,
                env=role_env,
                num_replicas=nnodes,
                max_retries=max_retries,
                resource=specs.resource(cpu=cpu, memMB=memMB, h=h),
                port_map={"c10d": rdzv_port},
            )
        ],
    )
