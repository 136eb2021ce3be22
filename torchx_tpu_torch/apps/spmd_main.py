"""SPMD bootstrap: one worker per card, each in the gang's process group,
each running the user's code. The port of :mod:`torchx_tpu.apps.spmd_main`.

The launcher injects the gang identity (``TPX_REPLICA_ID``,
``TPX_NUM_REPLICAS``, ``TPX_COORDINATOR_HOST``) into every replica, one
replica a host. A JAX replica is one process that owns all of its host's
chips; here, the torch idiom, a replica starts one worker process per card
(``--nproc-per-node``, default ``torch.cuda.device_count()``; it must be
given on the CPU). Worker ``local_rank`` of replica ``r`` is global rank
``r * nproc + local_rank`` of a world of ``num_replicas * nproc``: it sets
its card (``torch.cuda.set_device``) before any other CUDA call, joins the
process group (:func:`torchx_tpu_torch.distributed.init_from_env`: NCCL on
cards, gloo on the CPU, ``--backend`` to choose) and runs the target
in-process. With one worker the target runs in this process, as the JAX
bootstrap runs it. A worker that exits non-zero ends its siblings and this
process exits non-zero; SIGTERM, the launcher's preemption notice, is
forwarded to every worker; no worker outlives this process.

    python -m torchx_tpu_torch.apps.spmd_main [--port P] [--nproc-per-node N] \\
        (--script S | -m MOD) [-- args...]

In a gang of more than one rank, replica 0's process hosts the
rendezvous store at ``--port`` and every worker joins it as a client.
``--port 0`` (a gang of one replica only) lets the system pick the port,
which this process reads back and hands to its workers, as ``dist.ddp``'s
``--rdzv_endpoint localhost:0`` does for one node, so that no other process
can take the port between its choice and its bind.

Divergence from the JAX bootstrap: the process group is initialized at a
world of one too, since torch's collectives need a group (JAX skips
``jax.distributed`` for one process).

On failure a worker writes the structured error JSON of the launcher
(``make_structured_error``) to ``$TPX_ERROR_FILE``; with several workers,
the first to fail is the one whose error the file keeps.

The workers are watched here, not by ``torch.distributed.elastic``'s
``start_processes``: its context answers a signal by closing its workers,
with SIGKILL after a fixed grace, where the preemption notice must reach
the trainer and leave it to save its step for as long as the launcher
allows.
"""

from __future__ import annotations

import argparse
import json
import os
import runpy
import signal
import socket
import subprocess
import sys
import time
import traceback
from contextlib import nullcontext
from typing import Any, ContextManager, Optional

from torchx_tpu_torch import settings

_PROCESS_START = time.monotonic()

#: Seconds the siblings of a failed worker get to exit on SIGTERM before
#: they are killed.
SIBLING_GRACE_S = 10.0


def make_structured_error(message: str, exitcode: int = 1, hostname: str = "") -> str:
    """JSON error payload a failing replica writes to ``$TPX_ERROR_FILE``:
    a copy of ``torchx_tpu.specs.api.make_structured_error`` (the
    torchelastic error file's format, which the launcher reads)."""
    return json.dumps(
        {
            "message": {
                "message": message,
                "extraInfo": {"timestamp": int(time.time()), "py_callstack": ""},
            },
            "exitcode": exitcode,
            "hostname": hostname or socket.gethostname(),
        }
    )


def _job_span(name: str, **attrs: Any) -> ContextManager[Any]:
    """A span joining the client's trace via the injected $TPX_TRACE_ID /
    $TPX_PARENT_SPAN, or a no-op when this process was not launched under
    tracing."""
    if not os.environ.get(settings.ENV_TPX_TRACE_ID):
        return nullcontext()
    from torchx_tpu_torch.obs import trace as obs_trace

    return obs_trace.span(name, **attrs)


def write_error_file(message: str, exitcode: int = 1, path: Optional[str] = None) -> None:
    """The structured error, to ``path`` (default ``$TPX_ERROR_FILE``);
    nothing without one."""
    path = path or os.environ.get(settings.ENV_TPX_ERROR_FILE)
    if not path:
        return
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            f.write(make_structured_error(message, exitcode=exitcode))
    except OSError:
        pass


def run_worker(args: argparse.Namespace, rest: list[str]) -> None:
    """This process as one worker: its card, the process group, then the
    target, in-process."""
    import torch

    from torchx_tpu_torch import distributed

    replica, _, _ = distributed.gang_info()
    # the resolved global replica id, also where only the (slice, host)
    # decomposition was injected
    os.environ.setdefault(settings.ENV_TPX_REPLICA_ID, str(replica))
    try:
        with _job_span(
            "job.bootstrap",
            replica=replica,
            local_rank=distributed.local_rank(),
            no_init=args.no_init or None,
            import_s=round(time.monotonic() - _PROCESS_START, 3),
        ):
            if torch.cuda.is_available():
                torch.cuda.set_device(distributed.local_rank() % torch.cuda.device_count())
            if not args.no_init:
                distributed.init_from_env(args.backend, args.timeout)
        sys.argv = [args.script or args.module, *rest]
        if os.environ.get(settings.ENV_TPX_TRACE_ID):
            # instantaneous marker: the group is up, user code starts now
            from torchx_tpu_torch.obs import trace as obs_trace

            obs_trace.heartbeat(
                "job.exec", replica=replica, target=args.script or args.module
            )
        try:
            if args.script:
                runpy.run_path(args.script, run_name="__main__")
            else:
                runpy.run_module(args.module, run_name="__main__", alter_sys=True)
        except SystemExit as e:
            if e.code not in (None, 0):
                raise
        _close_group()
    except SystemExit as e:
        code = e.code if isinstance(e.code, int) else 1
        write_error_file(f"SystemExit: {e.code}", exitcode=code)
        raise
    except BaseException as e:
        write_error_file(f"{type(e).__name__}: {e}\n{traceback.format_exc()}")
        raise


def _close_group() -> None:
    """After the target returned: every rank meets, then the group goes, so
    that no rank leaves while a peer still talks to its store."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def _worker_error_file(error_file: str, local_rank: int) -> str:
    return f"{error_file}.worker{local_rank}"


def run_workers(argv: list[str], nproc: int) -> int:
    """Start ``nproc`` workers (this module again, with ``LOCAL_RANK`` and
    ``LOCAL_WORLD_SIZE`` set) and watch them: the first to exit non-zero
    ends the others (SIGTERM, then SIGKILL after :data:`SIBLING_GRACE_S`).
    SIGTERM and SIGINT to this process are forwarded to every worker.
    -> 0 when every worker exited 0, else the first failure's code."""
    from torchx_tpu_torch import distributed

    error_file = os.environ.get(settings.ENV_TPX_ERROR_FILE)
    procs: list[subprocess.Popen] = []

    def forward(signum: int, frame: Any) -> None:  # noqa: ARG001
        for p in procs:
            if p.poll() is None:
                p.send_signal(signum)

    previous = {s: signal.signal(s, forward) for s in (signal.SIGTERM, signal.SIGINT)}
    failed: Optional[tuple[int, int]] = None  # (local rank, exit code)
    try:
        for i in range(nproc):
            env = dict(os.environ, **{distributed.ENV_LOCAL_RANK: str(i),
                                      distributed.ENV_LOCAL_WORLD_SIZE: str(nproc)})
            # one intra-op thread a worker unless asked otherwise, as torchrun
            # does: N workers of a host's cores' width each oversubscribe it
            env.setdefault("OMP_NUM_THREADS", "1")
            if error_file:
                env[settings.ENV_TPX_ERROR_FILE] = _worker_error_file(error_file, i)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "torchx_tpu_torch.apps.spmd_main", *argv], env=env
            ))
        while failed is None and any(p.poll() is None for p in procs):
            for i, p in enumerate(procs):
                if p.poll() not in (None, 0):
                    failed = (i, p.returncode)
                    break
            time.sleep(0.05)
        if failed is None:  # every worker has exited; one may have failed last
            failed = next(((i, p.returncode) for i, p in enumerate(procs) if p.returncode),
                          None)
        if failed is not None:
            for p in procs:
                if p.poll() is None:
                    p.terminate()
            deadline = time.monotonic() + SIBLING_GRACE_S
            for p in procs:
                try:
                    p.wait(timeout=max(0.0, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for s, h in previous.items():
            signal.signal(s, h)
    if error_file:
        _collect_error_file(error_file, nproc, failed)
    if failed is None:
        return 0
    code = failed[1]
    return code if code > 0 else 128 - code  # killed by signal -code


def _collect_error_file(error_file: str, nproc: int, failed: Optional[tuple[int, int]]) -> None:
    """The first failed worker's error file becomes the replica's (or a
    note of its exit code where it wrote none); the per-worker files go."""
    if failed is not None:
        own = _worker_error_file(error_file, failed[0])
        if os.path.exists(own):
            os.replace(own, error_file)
        else:
            write_error_file(
                f"worker {failed[0]} of {nproc} exited with code {failed[1]}",
                exitcode=failed[1], path=error_file,
            )
    for i in range(nproc):
        try:
            os.unlink(_worker_error_file(error_file, i))
        except OSError:
            pass


def main(argv: Optional[list[str]] = None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = argparse.ArgumentParser(prog="spmd_main", description=__doc__)
    parser.add_argument(
        "--port", type=int, default=settings.TPX_COORDINATOR_PORT,
        help="the rendezvous port on replica 0 (0: any free port, for a gang "
             "of one replica)",
    )
    parser.add_argument("--no-init", action="store_true", help="skip the process group")
    parser.add_argument(
        "--nproc-per-node", type=int, default=None,
        help="workers in this replica, one a card (default: the visible cards)",
    )
    parser.add_argument(
        "--backend", default=None,
        help="process-group backend (default: nccl with cards, gloo without)",
    )
    parser.add_argument(
        "--timeout", type=float, default=600.0,
        help="seconds a rendezvous or collective waits for its peers",
    )
    group = parser.add_mutually_exclusive_group(required=True)
    group.add_argument("--script", help="path to user python script")
    group.add_argument("-m", dest="module", help="user python module")
    args, rest = parser.parse_known_args(argv)
    if rest and rest[0] == "--":
        rest = rest[1:]

    from torchx_tpu_torch import distributed

    if distributed.ENV_LOCAL_RANK in os.environ:  # a worker of this replica
        run_worker(args, rest)
        return
    # a store port is this process's to give, never inherited
    os.environ.pop(distributed.ENV_STORE_PORT, None)
    if args.port == 0 and distributed.num_replicas() > 1:
        parser.error(f"--port 0 takes a gang of one replica ({distributed.num_replicas()} "
                     "here): the other hosts could not find the port")
    import torch

    nproc = args.nproc_per_node
    if nproc is None:
        if not torch.cuda.is_available():
            parser.error("no CUDA device: give --nproc-per-node (and run gloo on the CPU)")
        nproc = torch.cuda.device_count()
    if nproc < 1:
        parser.error("--nproc-per-node must be >= 1")
    backend = args.backend or distributed.default_backend()
    if backend == "nccl" and nproc > torch.cuda.device_count():
        parser.error(
            f"NCCL takes one card a rank: {nproc} workers, {torch.cuda.device_count()} cards"
        )
    store = None  # held until every worker has ended
    if distributed.num_replicas() * nproc > 1 and not args.no_init:
        if distributed.replica_id() == 0:
            store = distributed.host_store(args.port, args.timeout)
        os.environ[distributed.ENV_STORE_PORT] = str(store.port if store else args.port)
    if nproc == 1:
        os.environ[distributed.ENV_LOCAL_RANK] = "0"
        os.environ[distributed.ENV_LOCAL_WORLD_SIZE] = "1"
        run_worker(args, rest)
        return
    sys.exit(run_workers(argv, nproc))


if __name__ == "__main__":
    main()
