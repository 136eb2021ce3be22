"""Memory fit of a training step before launch: does a config fit a card?

The port of :mod:`torchx_tpu.parallel.aot_fit`. XLA's buffer assignment
(``compiled.memory_analysis()``) has no torch twin, so the probe traces
one whole training step, the trainer's own (forward, backward, the
gradient sums of a mesh, clip and AdamW: ``make_train_step``), on
tensors of the ``meta`` device: shapes and dtypes without data, so no
card and no host memory is needed. The kernels' operators
(``tpx::flash_fwd``, ``tpx::flash_bwd``, ``tpx::norm_res_fwd``,
``tpx::rms_norm_bwd``) run their fake implementations, which allocate
what the kernels allocate, and the remat policies act as they do on the
card. :class:`LiveBytes` counts the storages the step creates and frees,
each rounded as the CUDA caching allocator rounds a request (to 512
bytes), against the resident state (parameters, both moments, the
batch).

A mesh larger than the machine is traced in one process:
:func:`gang_mesh` starts a fake process group (torch's ``fake`` backend
over a ``FakeStore``, whose collectives move nothing) of the mesh's
world, as rank 0, and the probe reckons rank 0's shards and collectives'
buffers; under ``pp`` rank 0 is stage 0, and the pipeline's and the
ring's point-to-point messages, which the fake group refuses on meta
tensors, move nothing (their receiving buffers are booked where the
caller allocates them). It never touches a live process group and never
allocates on a card: a trainer inside a gang runs it in a subprocess
(:func:`probe_fits` through ``python -m torchx_tpu_torch.parallel.aot_fit``,
a JSON list of requests on stdin, one JSON line of results on stdout).

What the probe does not see: the caching allocator's slack (a block it
does not split keeps up to 1 MiB beyond the request), cuBLAS's workspace,
and scratch a kernel allocates and frees inside its operator (the flash
backward's ``delta``, the norm backward's ``dw`` partials, a few MiB at
llama3_1b's shapes).

``python -m torchx_tpu_torch.apps.aot_memory_fit`` prints the operator's
fit table for a gang of H100s.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import sys
import weakref
from typing import Any, Iterator, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from torchx_tpu_torch.specs.api import GPU_GENERATIONS

GIB = 1024**3

#: ``torch.cuda.get_device_properties(0).total_memory`` of an NVIDIA H100
#: 80GB HBM3, from the specs layer's generation table: the budget off the
#: card.
H100_HBM_BYTES = GPU_GENERATIONS["h100"]["hbm_bytes"]
#: Share of a card's memory the fit may use: room for the CUDA context's
#: workspaces, the caching allocator's slack and fragmentation.
DEFAULT_HEADROOM = 0.9

#: The caching allocator rounds every request up to a multiple of this.
ALLOC_ROUND = 512


def alloc_bytes(nbytes: int) -> int:
    """The bytes the CUDA caching allocator books for a request of
    ``nbytes`` (a multiple of 512; nothing for an empty tensor)."""
    return 0 if nbytes == 0 else -(-nbytes // ALLOC_ROUND) * ALLOC_ROUND


class LiveBytes(TorchDispatchMode):
    """Counts the bytes of the storages alive while it is active: every
    storage an operator's output brings in, until its last reference dies.
    :meth:`add_args` books the resident tensors (whose storages exist
    before the step) apart. ``live`` and ``peak`` include the arguments;
    ``temp_peak`` is the peak of the rest."""

    def __init__(self) -> None:
        super().__init__()
        self.args = 0
        self.live = 0
        self.peak = 0
        # storage id -> (weak reference, bytes, shape and dtype of the
        # tensor that brought it in, resident)
        self._storages: dict[int, tuple[Any, int, tuple, torch.dtype, bool]] = {}

    def _book(self, t: torch.Tensor, resident: bool = False) -> int:
        st = t.untyped_storage()
        key = id(st)
        known = self._storages.get(key)
        if known is not None and known[0]() is st:
            return 0
        n = alloc_bytes(st.nbytes())

        def freed(_ref: Any, key: int = key, n: int = n) -> None:
            self._storages.pop(key, None)
            self.live -= n

        self._storages[key] = (weakref.ref(st, freed), n, tuple(t.shape), t.dtype, resident)
        self.live += n
        self.peak = max(self.peak, self.live)
        return n

    def add_args(self, tensors: Any) -> None:
        """Book the storages of ``tensors`` (a pytree) as resident."""
        for t in tree_leaves(tensors):
            if isinstance(t, torch.Tensor):
                self.args += self._book(t, resident=True)

    @property
    def temp_peak(self) -> int:
        return self.peak - self.args

    def live_tensors(self) -> list[tuple[tuple, torch.dtype, int]]:
        """(shape, dtype, bytes) of each storage the step brought in and
        still holds, as the tensor that brought it in had them (the
        resident arguments left out)."""
        return [(shape, dtype, n) for ref, n, shape, dtype, resident in self._storages.values()
                if ref() is not None and not resident]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):  # noqa: ANN001, ANN204
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._book(t)
        return out


@dataclasses.dataclass
class FitResult:
    """One traced step's memory on rank 0, as the JAX package's."""

    batch: int
    seq: int
    remat_policy: str
    args_bytes: int  # per-rank parameters + moments + batch
    temp_bytes: int  # per-rank peak of everything else the step allocates
    peak_bytes: int  # per-rank live peak, the arguments included: args + temps
    fits: bool

    def row(self) -> str:
        """This result as one markdown fit-table row."""
        return (
            f"| {self.batch} | {self.seq} | {self.remat_policy} "
            f"| {self.args_bytes / GIB:.1f} | {self.temp_bytes / GIB:.1f} "
            f"| {self.peak_bytes / GIB:.1f} | {'yes' if self.fits else 'NO'} |"
        )


def _mesh_config(mesh: Any) -> Any:
    from torchx_tpu_torch.parallel.mesh_config import MeshConfig, parse_mesh_spec

    return parse_mesh_spec(mesh) if isinstance(mesh, str) else mesh or MeshConfig()


def mesh_world(mesh: Any, world: Optional[int] = None) -> int:
    """The ranks of the gang ``mesh`` (a spec such as ``fsdp=4,tp=2`` or a
    ``MeshConfig``) names: ``world`` where given (it resolves a ``-1``),
    else the product of its sizes."""
    config = _mesh_config(mesh)
    if world is not None:
        return int(world)
    sizes = dataclasses.asdict(config).values()
    if any(v == -1 for v in sizes):
        raise ValueError(f"mesh {mesh!r} has a -1 axis: give the gang's world")
    return math.prod(max(v, 1) for v in sizes)


@contextlib.contextmanager
def gang_mesh(mesh: Any, world: Optional[int] = None) -> Iterator[Any]:
    """The mesh of rank 0 of a gang of ``world`` cards laid out as ``mesh``,
    over a fake process group in this process (its collectives move no
    data), destroyed on exit. The JAX package's ``tpu_topology_mesh``
    compiles for a slice without its chips; this traces for a gang
    without its cards. Raises where a process group is already up: the
    probe never touches a live one."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from torchx_tpu_torch.parallel.mesh import make_mesh

    if dist.is_initialized():
        raise RuntimeError(
            "a process group is up: trace the fit in a subprocess"
            " (python -m torchx_tpu_torch.parallel.aot_fit)")
    n = mesh_world(mesh, world)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield make_mesh(_mesh_config(mesh))
    finally:
        dist.destroy_process_group()


def abstract_train_state(cfg: Any, mesh: Any = None) -> tuple[Any, Any]:
    """(parameters, optimizer) of the trainer on the meta device: this
    rank's shards under ``mesh`` (:func:`llama.shard_params`), AdamW's two
    moments beside them, the clip norm's layout of the mesh."""
    from torchx_tpu_torch.examples.train_llama import clip_norm_layout, make_optimizer
    from torchx_tpu_torch.models import llama

    params = llama.init_params(cfg, None, "meta")
    counted = norm_group = None
    if mesh is not None:
        params = llama.shard_params(params, cfg, mesh)
        counted, norm_group = clip_norm_layout(cfg, mesh)
    optimizer = make_optimizer(llama.leaves(params), warmup=100, counted=counted,
                               norm_group=norm_group)
    return params, optimizer


def _trace_step(cfg: Any, mesh: Any, batch: int, seq: int, grad_bucket_mb: int) -> LiveBytes:
    from torchx_tpu_torch.examples.train_llama import check_model_axes, make_train_step
    from torchx_tpu_torch.parallel import overlap

    rows = batch
    if mesh is not None:
        check_model_axes(cfg, mesh.sizes, seq, batch)
        mesh.batch_rows(batch)  # raises where the batch does not split
        rows = batch // mesh.data_size
    params, optimizer = abstract_train_state(cfg, mesh)
    tokens = torch.empty((rows, seq + 1), dtype=torch.int64, device="meta")
    plan = (overlap.plan_buckets(params, grad_bucket_mb * 1024 * 1024)
            if grad_bucket_mb else None)
    step = make_train_step(cfg, optimizer, mesh, plan)
    tracker = LiveBytes()
    tracker.add_args((params, optimizer.mu, optimizer.nu, tokens))
    with tracker:
        out = step(params, {"tokens": tokens})
        del out
    return tracker


def trace_fit(
    cfg: Any,
    mesh: Any = None,
    batch: int = 8,
    seq: int = 2048,
    hbm_bytes: Optional[int] = None,
    headroom: float = DEFAULT_HEADROOM,
    world: Optional[int] = None,
    grad_bucket_mb: int = 0,
) -> FitResult:
    """Trace one training step of ``cfg`` at the global ``batch`` and
    ``seq`` on rank 0 of the gang ``mesh`` (a spec or ``MeshConfig``; None
    for one card without a process group) and read its memory fit against
    ``hbm_bytes`` (default :data:`H100_HBM_BYTES`) times ``headroom``. The
    counterpart of the JAX package's ``compile_fit``. ``grad_bucket_mb``
    is the trainer's bucket cap of the ``dp`` x ``sp`` gradient sum (0:
    one fused sum)."""
    cfg = dataclasses.replace(cfg, max_seq=seq)
    if mesh is None:
        tracker = _trace_step(cfg, None, batch, seq, grad_bucket_mb)
    else:
        with gang_mesh(mesh, world) as m:
            tracker = _trace_step(cfg, m, batch, seq, grad_bucket_mb)
    budget = H100_HBM_BYTES if hbm_bytes is None else int(hbm_bytes)
    return FitResult(
        batch=batch, seq=seq, remat_policy=cfg.remat_policy if cfg.remat else "none",
        args_bytes=tracker.args, temp_bytes=tracker.temp_peak, peak_bytes=tracker.peak,
        fits=tracker.peak <= budget * headroom,
    )


def north_star_cfg() -> Any:
    """llama3_8b as the JAX package's north star trains it: bf16, ``"dots"``
    remat, chunked cross-entropy over 2048 positions; attention through the
    flash kernels (``kernels="cuda"``) at the H100's tiles in place of the
    JAX config's 512/512 TPU tiles: 0/0, the card's default table
    (``ops.fused.DEFAULT_TILES``), which ``chip_smoke.py --phases
    build,sweep`` chose at head_dim 128 (b 4, s 2048, causal, bf16; H100
    80GB HBM3, 700 W). No one (block_q, block_kv) request reaches the three
    kernels' fastest tiles there (the forward's and dq's stream 128 kv rows,
    dk/dv's owns 64): the best, 128/128, costs 4.664 ms of flash for 4
    forwards and 2 of each backward against the table's 4.508."""
    from torchx_tpu_torch.models import llama

    return llama.llama3_8b(remat=True, remat_policy="dots", loss_chunk=2048, kernels="cuda",
                           attn_block_q=0, attn_block_kv=0)


def model_state_bytes_per_device(cfg: Any, n_devices: int) -> int:
    """Analytic parameters + Adam moments per device (all sharded at
    scale): 3x the parameter bytes spread over the mesh (the JAX
    package's formula)."""
    itemsize = torch.empty((), dtype=cfg.dtype).element_size()
    return 3 * cfg.param_count() * itemsize // n_devices


#: Presets a request's ``overrides`` start from: the class's defaults.
_BASES = {"LlamaConfig": "llama3_8b", "MoEConfig": "mixtral_8x7b"}


def probe_request(cfg: Any, mesh: Any, batch: int, seq: int, **extra: Any) -> dict[str, Any]:
    """A :func:`probe_fits` request for any ``cfg``: the preset of its
    class and the fields that differ from it as ``overrides`` (a dtype by
    name), so that a subprocess rebuilds ``cfg`` exactly."""
    from torchx_tpu_torch.models import llama

    name = _BASES[type(cfg).__name__]
    base = llama.get_config(name)
    overrides = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if v != getattr(base, f.name):
            overrides[f.name] = str(v).removeprefix("torch.") if isinstance(v, torch.dtype) else v
    mesh_spec = mesh if isinstance(mesh, str) or mesh is None else ",".join(
        f"{a}={v}" for a, v in dataclasses.asdict(mesh).items() if v != 1)
    return {"config": name, "overrides": overrides, "mesh_spec": mesh_spec,
            "batch": batch, "seq": seq, **extra}


def _request_cfg(req: dict[str, Any]) -> Any:
    from torchx_tpu_torch.models import llama

    overrides = dict(req.get("overrides") or {})
    if "dtype" in overrides:
        overrides["dtype"] = getattr(torch, overrides["dtype"])
    if req.get("remat_policy"):
        overrides["remat_policy"] = req["remat_policy"]
    scope = req.get("int8_scope") or "none"
    if scope != "none":
        overrides["int8_matmuls"] = True
        overrides["int8_scope"] = scope
    overrides.setdefault("kernels", req.get("kernels") or "cuda")
    cfg = llama.get_config(req["config"])
    return dataclasses.replace(cfg, **overrides)


def probe_fits(requests: list[dict[str, Any]]) -> list[dict[str, Any]]:
    """Batch :func:`trace_fit` for the launcher's prune stage and for a
    gang's ``--remat-policy auto``: one process serves every request. Each
    request carries ``config`` (a preset name), ``mesh_spec``, ``batch``,
    ``seq`` and optionally ``remat_policy``, ``int8_scope``, ``hbm_bytes``,
    ``headroom`` (the JAX package's keys) and the port's ``devices`` (the
    world a ``-1`` axis resolves against), ``overrides`` (config fields)
    and ``kernels`` (default ``"cuda"``); each result mirrors
    :class:`FitResult` plus the echoed request, or carries ``error``: one
    candidate's failure never fails the batch."""
    out: list[dict[str, Any]] = []
    for req in requests:
        result: dict[str, Any] = {"request": req}
        try:
            r = trace_fit(
                _request_cfg(req), req.get("mesh_spec") or None, int(req["batch"]),
                int(req["seq"]), hbm_bytes=req.get("hbm_bytes"),
                headroom=float(req.get("headroom") or DEFAULT_HEADROOM),
                world=req.get("devices"), grad_bucket_mb=int(req.get("grad_bucket_mb") or 0),
            )
            result.update({"fits": r.fits, "args_bytes": r.args_bytes,
                           "temp_bytes": r.temp_bytes, "peak_bytes": r.peak_bytes,
                           "remat_policy": r.remat_policy})
        except Exception as e:  # noqa: BLE001 - one candidate's verdict
            result["error"] = f"{type(e).__name__}: {e}"
        out.append(result)
    return out


def run_probe(requests: list[dict[str, Any]], timeout_s: float = 600.0) -> list[dict[str, Any]]:
    """:func:`probe_fits` in a subprocess (``python -m
    torchx_tpu_torch.parallel.aot_fit``) that sees no card, for a process
    whose own process group the probe's fake group must not meet."""
    import os
    import pathlib
    import subprocess

    root = str(pathlib.Path(__file__).resolve().parents[2])
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env["PYTHONPATH"] = os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p)
    proc = subprocess.run(
        [sys.executable, "-m", "torchx_tpu_torch.parallel.aot_fit"],
        input=json.dumps(requests), capture_output=True, text=True, env=env,
        timeout=timeout_s, check=False,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"fit probe exited {proc.returncode}: {proc.stderr[-2000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _probe_main() -> int:
    """``python -m torchx_tpu_torch.parallel.aot_fit``: JSON requests on
    stdin, one JSON line of results on stdout."""
    requests = json.load(sys.stdin)
    if not isinstance(requests, list):
        raise SystemExit("expected a JSON list of probe requests on stdin")
    print(json.dumps(probe_fits(requests)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(_probe_main())
