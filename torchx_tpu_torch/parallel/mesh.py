"""The training mesh over a ``torch.distributed`` world, and the
collectives that move a sharded parameter, its gradient and the
activations of the model axes.

The port of :mod:`torchx_tpu.parallel.mesh`'s data axes and of the model
axes (``tp``, ``sp`` and the MoE family's ``ep``). JAX lays the 6-axis
mesh (pp, dp, fsdp, ep, tp, sp) over its devices and lets GSPMD insert the
collectives; here :func:`make_mesh` lays the same axes, in the same order,
over the ranks of the default process group (a ``DeviceMesh``), and the
model calls the collectives itself:

* :func:`gather_param` all-gathers a parameter's ``fsdp`` shards for one
  use; its backward reduce-scatters (sums) the gradient, so that each rank
  keeps the gradient of its own shard, summed over ``fsdp``;
* :func:`replicated_param` marks a parameter every ``fsdp`` rank holds
  whole (the norms' weights); its backward sums the gradient over
  ``fsdp``;
* ``tp`` (Megatron): :func:`copy_to_tp` at the input of a column-parallel
  product (identity; the backward all-reduces over ``tp``),
  :func:`reduce_from_tp` at the output of a row-parallel one (all-reduce;
  the backward is the identity), and :func:`tp_block` for a tensor every
  ``tp`` rank holds whole of which each uses its own block (the tied
  embedding as the vocab-parallel head);
* ``sp``: :func:`gather_sequence` all-gathers the sequence before
  attention (the backward reduce-scatters) and :func:`sequence_block`
  takes this rank's positions back (the backward pads with zeros);
* ``pp``: the stacked layer axis shards over the pipeline stages, each
  rank holding its stage's layers; :func:`send_recv` moves a microbatch's
  activations between neighbouring stages
  (:mod:`torchx_tpu_torch.parallel.pipeline`);
* ``sp`` without a gather: :func:`ppermute` rotates a tensor around a
  group (ring attention's K/V blocks; the backward rotates back) and
  :func:`all_to_all` re-shards one dimension for another (Ulysses'
  sequence for heads; the backward is the inverse exchange);
* ``ep``: a MoE layer's experts shard over the expert group (``ep`` x
  ``tp``, :attr:`Mesh.expert_group`), whose ranks hold the same tokens:
  :func:`copy_to_experts` marks what enters this rank's experts (identity;
  the backward sums over the group) and :func:`reduce_from_experts` sums
  their combined output (the backward is the identity), as ``tp`` does for
  a dense FFN; :func:`earlier_sp_sum` gives the router the counts of the
  earlier ``sp`` ranks' positions;
* every gradient is summed over :attr:`Mesh.grad_group` (``dp`` x ``sp``:
  the ranks that hold the same shards and compute on other tokens) after
  the backward (:mod:`torchx_tpu_torch.parallel.overlap`).

Rank ``r``'s coordinates are ``r``'s index in the row-major
``[pp, dp, fsdp, ep, tp, sp]`` array of ranks, as device ``r`` is in the
JAX mesh, so a shard here equals JAX's addressable shard on device ``r``.
``pp`` is outermost: a stage's ranks are a contiguous block, and each keeps
its ``dp`` / ``fsdp`` / ``ep`` / ``tp`` / ``sp`` groups inside its stage.

Order of collectives: a rank issues collectives over several subgroups
(``fsdp``, ``tp``, ``sp``, the expert, grad and token groups), and every rank of a
group must issue that group's collectives in the same order. The model
guarantees it by running one program on every rank: the same layers, the
same chunks, the same collectives, in program order. Under remat the
checkpointed layer issues its gathers and all-reduces again in the
recompute, in the same order on every rank. On NCCL two ranks that issue
them in different orders hang (gloo may too); a collective must never
depend on data that differs between the ranks of one group.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from torchx_tpu_torch.parallel.mesh_config import AXES, MeshConfig

#: The axes a MoE layer's experts shard over, ``ep``-major, as the JAX
#: package's ``moe.param_specs`` shards them.
EXPERT_AXES = ("ep", "tp")

#: The mesh axes of every group the meshes of this process made, by the
#: group's id: the name of the profiler range around a collective over it.
_GROUP_AXES: dict[int, str] = {}


def collective_range(group: Any) -> Any:
    """A profiler range ``collective:<axes>`` around one collective over
    ``group`` (its mesh axes, such as ``tp`` or ``dp,sp``; ``other`` for a
    group no mesh made), so that a trace can book the collective's work to
    its group. Without a profiler it costs a few microseconds."""
    return torch.profiler.record_function("collective:" + _GROUP_AXES.get(id(group), "other"))


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The mesh of this rank: axis sizes, this rank's coordinate on each
    axis, and the process groups its collectives run over (each group:
    the ranks that differ from this one only in the named coordinates)."""

    device_mesh: DeviceMesh
    sizes: dict[str, int]
    coords: dict[str, int]
    #: ranks that differ only in their ``dp`` / ``fsdp`` coordinate
    dp_group: Any
    fsdp_group: Any
    backend: str
    #: ranks that differ only in their ``tp`` / ``sp`` coordinate
    tp_group: Any = None
    sp_group: Any = None
    #: ``dp`` x ``sp``: ranks that hold the same shards of every leaf and
    #: compute on other tokens, over which every gradient is summed after
    #: the backward (``fsdp`` sums inside it; ``tp`` ranks compute the same
    #: tokens and never sum)
    grad_group: Any = None
    #: ``dp`` x ``fsdp`` x ``sp``: every rank that computes other tokens of
    #: one batch (the loss's mean, a mask's count and the router's means
    #: run over it)
    token_group: Any = None
    #: ``pp`` x ``fsdp`` x ``ep`` x ``tp``: the ranks among which each
    #: leaf's blocks lie (the global gradient norm adds its blocks' squares
    #: over it)
    shard_group: Any = None
    #: ``ep`` x ``tp``: the ranks that compute the same tokens and split a
    #: MoE layer's experts between them
    expert_group: Any = None
    #: ranks that differ only in their ``pp`` coordinate: the stages, in
    #: stage order
    pp_group: Any = None

    @property
    def stage(self) -> int:
        """This rank's pipeline stage (its ``pp`` coordinate)."""
        return self.coords["pp"]

    @property
    def n_stages(self) -> int:
        return self.sizes["pp"]

    @property
    def data_size(self) -> int:
        """Ranks one batch's rows are split between (``dp * fsdp``)."""
        return self.sizes["dp"] * self.sizes["fsdp"]

    @property
    def token_size(self) -> int:
        """Ranks one batch's tokens are split between (``dp * fsdp * sp``)."""
        return self.data_size * self.sizes["sp"]

    @property
    def data_index(self) -> int:
        """This rank's block of a batch: ``dp``-major over ``dp`` x ``fsdp``,
        as the JAX package's ``BATCH_SPEC`` = ``P(("dp", "fsdp"), None)``
        shards it."""
        return self.coords["dp"] * self.sizes["fsdp"] + self.coords["fsdp"]

    def batch_rows(self, global_batch: int) -> slice:
        """The rows of a ``[global_batch, ...]`` batch that this rank
        computes: block :attr:`data_index` of :attr:`data_size`."""
        if global_batch % self.data_size:
            raise ValueError(
                f"global batch {global_batch} does not split over the"
                f" {self.data_size} ranks of dp x fsdp"
            )
        n = global_batch // self.data_size
        return slice(self.data_index * n, (self.data_index + 1) * n)

    def positions(self, seq: int) -> slice:
        """The positions of a ``seq``-long sequence that this rank computes
        under ``sp``: block ``coords["sp"]`` of ``sizes["sp"]``."""
        sp = self.sizes["sp"]
        if seq % sp:
            raise ValueError(f"sequence {seq} does not split over the {sp} ranks of sp")
        n = seq // sp
        return slice(self.coords["sp"] * n, (self.coords["sp"] + 1) * n)

    def parts(self, axes: Any) -> tuple[int, int]:
        """(number of shards, this rank's shard index) of a dimension that
        a spec entry ``axes`` shards (:func:`parts`)."""
        return parts(axes, self.sizes, self.coords)

    def experts(self, n_experts: int) -> slice:
        """The experts of a ``n_experts``-expert layer this rank holds and
        computes: block :attr:`expert_group` index of the expert axis, as
        ``parts(EXPERT_AXES)`` lays it out."""
        n, idx = self.parts(EXPERT_AXES)
        if n_experts % n:
            raise ValueError(f"{n_experts} experts do not split over the {n} ranks of ep x tp")
        step = n_experts // n
        return slice(idx * step, (idx + 1) * step)

    def unshard(self, x: torch.Tensor, spec: tuple) -> torch.Tensor:
        """The parameter this rank computes with, from its shard ``x``
        under ``spec`` (one entry per dimension of ``x``), differentiably: a
        gather over ``fsdp`` where the spec shards a dimension over it,
        else the replicated marker. A block over ``tp``, ``ep`` or both
        stays local: the model computes on this rank's heads, ffn columns,
        vocab block or experts; so does a stage's block of layers over
        ``pp``."""
        dim = None
        for d, axes in enumerate(spec):
            if axes == "fsdp" and dim is None:
                dim = d
            elif (not set(_axis_names(axes)) <= {"pp", *EXPERT_AXES}
                  and self.parts(axes)[0] > 1):
                raise ValueError(
                    f"spec {spec}: one dimension over fsdp, the layer axis over pp and"
                    " one over ep and tp are the model's layouts"
                )
        if dim is None:
            return replicated_param(x, self.fsdp_group)
        return gather_param(x, dim, self.fsdp_group)


def _axis_names(axes: Any) -> tuple[str, ...]:
    return () if axes is None else (axes,) if isinstance(axes, str) else tuple(axes)


def parts(axes: Any, sizes: dict[str, int], coords: dict[str, int]) -> tuple[int, int]:
    """(number of shards, shard index) of a dimension that a spec entry
    ``axes`` (None, an axis name or a tuple of them) shards, for the rank at
    ``coords`` of a mesh of ``sizes``: the index is taken over the named
    axes in the entry's order, row-major."""
    n, idx = 1, 0
    for a in _axis_names(axes):
        n, idx = n * sizes[a], idx * sizes[a] + coords[a]
    return n, idx


def shard_extent(
    spec: tuple, shape: tuple, sizes: dict[str, int], coords: dict[str, int],
) -> tuple[slice, ...]:
    """The block of a whole tensor of ``shape`` that the rank at ``coords``
    of a mesh of ``sizes`` holds under ``spec`` (one entry per dimension,
    so a sharded last dimension is named as such): one slice a dimension.
    A pure function of the layout, no process group: a checkpoint's writer
    and its readers at another mesh compute each other's blocks with it."""
    if len(spec) != len(shape):
        raise ValueError(f"spec {spec} has {len(spec)} entries for a {len(shape)}-d shape")
    out = []
    for d, axes in enumerate(spec):
        n, idx = parts(axes, sizes, coords)
        if shape[d] % n:
            raise ValueError(f"dimension {d} of {tuple(shape)} does not split {n} ways")
        step = shape[d] // n
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)


def holds_first_copy(spec: tuple, coords: dict[str, int]) -> bool:
    """True where the rank at ``coords`` holds the first copy of its block
    under ``spec``: its coordinate is 0 on every axis that does not shard
    the tensor (the ``dp`` replicas of an ``fsdp`` shard; every rank but
    rank 0 for a replicated tensor), so that each block has one owner."""
    sharding = {a for axes in spec for a in _axis_names(axes)}
    return all(c == 0 for a, c in coords.items() if a not in sharding)


def _subgroups(ranks: torch.Tensor, sizes: dict[str, int], axes: tuple[str, ...]) -> Any:
    """This rank's group of the ranks that differ only in their ``axes``
    coordinates: one group per coordinate of the other axes, created on
    every rank in the same order. -> this rank's."""
    inner = [AXES.index(a) for a in axes]
    outer = [i for i in range(len(AXES)) if i not in inner]
    rows = ranks.permute(*outer, *inner).reshape(-1, math.prod(sizes[a] for a in axes))
    group, _ = dist.new_subgroups_by_enumeration(rows.tolist())
    _GROUP_AXES[id(group)] = ",".join(axes)
    return group


def make_mesh(config: Optional[MeshConfig] = None) -> Mesh:
    """The mesh over the default process group's ranks (which must be up),
    axes in :data:`AXES` order, ``config`` resolved against the world size
    (default ``MeshConfig()``: everything on ``fsdp``)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group (distributed.init_from_env)")
    world = dist.get_world_size()
    sizes = (config or MeshConfig()).resolve(world)
    ranks = torch.arange(world).reshape([sizes[a] for a in AXES])
    backend = dist.get_backend()
    device_mesh = DeviceMesh(
        "cuda" if backend == "nccl" else "cpu", ranks, mesh_dim_names=AXES
    )
    coords = {a: int(device_mesh.get_local_rank(a)) for a in AXES}
    for a in AXES:
        _GROUP_AXES[id(device_mesh.get_group(a))] = a
    pp_group = device_mesh.get_group("pp")
    if backend == "nccl":
        # the pipeline's and the ring's point-to-point exchanges pair ranks
        # of these groups: their communicators are made here, by every rank
        # of each group at once, and not by a batch of sends only some of
        # the ranks issue
        for a in ("pp", "sp"):
            if sizes[a] > 1:
                dist.all_reduce(torch.zeros(1, device="cuda"), group=device_mesh.get_group(a))
    return Mesh(
        device_mesh=device_mesh,
        sizes=sizes,
        coords=coords,
        dp_group=device_mesh.get_group("dp"),
        fsdp_group=device_mesh.get_group("fsdp"),
        backend=backend,
        tp_group=device_mesh.get_group("tp"),
        sp_group=device_mesh.get_group("sp"),
        grad_group=_subgroups(ranks, sizes, ("dp", "sp")),
        token_group=_subgroups(ranks, sizes, ("dp", "fsdp", "sp")),
        shard_group=_subgroups(ranks, sizes, ("pp", "fsdp", *EXPERT_AXES)),
        expert_group=_subgroups(ranks, sizes, EXPERT_AXES),
        pp_group=pp_group,
    )


def shard(x: torch.Tensor, spec: tuple, mesh: Mesh) -> torch.Tensor:
    """This rank's shard of the whole tensor ``x`` under ``spec`` (one
    entry per dimension: None, an axis name or a tuple of them), a fresh
    contiguous tensor."""
    return x[shard_extent(spec, tuple(x.shape), mesh.sizes, mesh.coords)].contiguous().clone()


def _all_gather(shard_: torch.Tensor, dim: int, group: Any) -> torch.Tensor:
    """The shards of ``group`` concatenated along ``dim``, in a fresh
    contiguous tensor (the kernels take plain contiguous tensors).
    ``all_gather_into_tensor`` concatenates along dimension 0; another
    dimension is laid out by one copy from the stacked shards."""
    n = dist.get_world_size(group)
    s = tuple(shard_.shape)
    buf = shard_.new_empty((n * s[0], *s[1:]))
    with collective_range(group):
        dist.all_gather_into_tensor(buf, shard_.contiguous(), group=group)
    if dim == 0:
        return buf
    return buf.view(n, *s).movedim(0, dim).reshape(*s[:dim], n * s[dim], *s[dim + 1:])


def gather_batch(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The whole batch's rows from every rank's block ``x`` (its
    :meth:`Mesh.batch_rows`), in :attr:`Mesh.data_index` order: gathered
    over ``fsdp``, then over ``dp``. Not differentiable (tokens, masks)."""
    for group in (mesh.fsdp_group, mesh.dp_group):
        if dist.get_world_size(group) > 1:
            x = _all_gather(x, 0, group)
    return x


def _reduce_scatter(full: torch.Tensor, dim: int, group: Any) -> torch.Tensor:
    """The sum over ``group`` of ``full``, each rank keeping its block
    along ``dim`` (the inverse layout of :func:`_all_gather`)."""
    n = dist.get_world_size(group)
    s = list(full.shape)
    s[dim] //= n
    if dim == 0:
        inp = full.contiguous()
    else:
        inp = full.reshape(*s[:dim], n, *s[dim:]).movedim(dim, 0).contiguous()
    out = full.new_empty(s)
    with collective_range(group):
        dist.reduce_scatter_tensor(out, inp.view(n * s[0], *s[1:]), group=group)
    return out


class _GatherParam(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard_: torch.Tensor, dim: int, group: Any) -> torch.Tensor:  # noqa: ANN001
        ctx.dim, ctx.group = dim, group
        return _all_gather(shard_, dim, group)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):  # noqa: ANN001, ANN205
        return _reduce_scatter(grad, ctx.dim, ctx.group), None, None


class _ReplicatedParam(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group: Any) -> torch.Tensor:  # noqa: ANN001
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):  # noqa: ANN001, ANN205
        grad = grad.contiguous().clone()
        with collective_range(ctx.group):
            dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _GroupMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group: Any) -> torch.Tensor:  # noqa: ANN001
        ctx.group = group
        out = x.contiguous().clone()
        with collective_range(group):
            dist.all_reduce(out, group=group)
        return out / dist.get_world_size(group)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):  # noqa: ANN001, ANN205
        grad = grad.contiguous().clone()
        with collective_range(ctx.group):
            dist.all_reduce(grad, group=ctx.group)
        return grad / dist.get_world_size(ctx.group), None


def group_mean(x: torch.Tensor, group: Any) -> torch.Tensor:
    """The mean of ``x`` over the ranks of ``group`` (each holding the
    same number of rows of a batch, so the mean of their means is the
    batch's), differentiably: every rank's output depends on every rank's
    ``x``, so the gradient flows back summed over the group's outputs.
    Over a group of one rank, ``x`` itself."""
    if dist.get_world_size(group) == 1:
        return x
    return _GroupMean.apply(x, group)


def gather_param(shard_: torch.Tensor, dim: int, group: Any) -> torch.Tensor:
    """The whole parameter from the ``group``'s shards along ``dim``
    (``all_gather_into_tensor``); the gradient flows back as a
    ``reduce_scatter_tensor`` sum, each rank keeping its shard's. Over a
    group of one rank, the shard itself (no collective: on gloo each one
    would copy through the host)."""
    if dist.get_world_size(group) == 1:
        return shard_
    return _GatherParam.apply(shard_, dim, group)


def replicated_param(x: torch.Tensor, group: Any) -> torch.Tensor:
    """``x`` itself, held whole by every rank of ``group``, whose ranks
    compute on different rows: the gradient flows back summed over
    ``group`` (``all_reduce``; none over a group of one rank)."""
    if dist.get_world_size(group) == 1:
        return x
    return _ReplicatedParam.apply(x, group)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group: Any) -> torch.Tensor:  # noqa: ANN001
        out = x.contiguous().clone()
        with collective_range(group):
            dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):  # noqa: ANN001, ANN205
        return grad, None


class _Block(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, dim: int, n: int, idx: int,  # noqa: ANN001
                group: Any) -> torch.Tensor:
        ctx.dim, ctx.n, ctx.idx, ctx.group = dim, n, idx, group
        step = x.shape[dim] // n
        return x.narrow(dim, idx * step, step).contiguous()

    @staticmethod
    def backward(ctx, grad: torch.Tensor):  # noqa: ANN001, ANN205
        if ctx.group is not None:  # every rank's block: their gradients gathered
            return _all_gather(grad, ctx.dim, ctx.group), None, None, None, None
        shape = list(grad.shape)
        step = shape[ctx.dim]
        shape[ctx.dim] *= ctx.n
        out = grad.new_zeros(shape)
        out.narrow(ctx.dim, ctx.idx * step, step).copy_(grad)
        return out, None, None, None, None


def copy_to_tp(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The input of a column-parallel product (each ``tp`` rank multiplies
    the whole ``x`` by its block of columns). Forward: ``x`` itself.
    Backward: the gradient all-reduced (summed) over ``tp``, since each
    rank's columns contribute their part of ``x``'s gradient."""
    return _ReplicatedParam.apply(x, mesh.tp_group)


def reduce_from_tp(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The output of a row-parallel product (``wo``, ``w_down``: each
    ``tp`` rank's partial sum over its rows). Forward: ``x`` all-reduced
    (summed) over ``tp``. Backward: the identity, since every rank's
    partial sum receives the whole output's gradient."""
    return _AllReduce.apply(x, mesh.tp_group)


def tp_block(x: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """This rank's ``tp`` block along ``dim`` of a tensor every ``tp`` rank
    holds whole and uses only its block of (the tied embedding as the
    vocab-parallel head). Forward: the block. Backward: the blocks'
    gradients all-gathered over ``tp`` along ``dim``, so that the whole
    tensor's gradient is the same on every ``tp`` rank and holds every
    block's part once."""
    return _Block.apply(x, dim, mesh.sizes["tp"], mesh.coords["tp"], mesh.tp_group)


def gather_sequence(x: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """The whole sequence from this ``sp`` rank's positions ``x`` along
    ``dim``. Forward: an all-gather over ``sp``. Backward: a reduce-scatter
    over ``sp``, each rank keeping the gradient of its own positions summed
    over the ranks (each computed attention for every position, but only
    its own positions' outputs carry a gradient)."""
    return _GatherParam.apply(x, dim, mesh.sp_group)


def sequence_block(x: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """This ``sp`` rank's positions (:meth:`Mesh.positions`) of the whole
    sequence ``x`` along ``dim``. Forward: the block. Backward: the
    gradient placed at those positions, zeros elsewhere."""
    return _Block.apply(x, dim, mesh.sizes["sp"], mesh.coords["sp"], None)


def max_over_tp(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The elementwise maximum of ``x`` over ``tp`` (all-reduce MAX), out
    of the graph: a logsumexp's shift, on which no gradient depends."""
    out = x.detach().contiguous().clone()
    with collective_range(mesh.tp_group):
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=mesh.tp_group)
    return out


def copy_to_experts(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """What enters this rank's experts of a MoE layer (the layer's input,
    the router's gate weights), which every rank of the expert group holds
    whole. Forward: ``x`` itself. Backward: the gradient summed over the
    group, since each rank's experts contribute their part of it (none over
    a group of one rank)."""
    return replicated_param(x, mesh.expert_group)


def reduce_from_experts(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The MoE layer's output from this rank's experts, summed over the
    expert group. Forward: an all-reduce. Backward: the identity, since
    every rank's part receives the whole output's gradient. Over a group
    of one rank, ``x`` itself."""
    if dist.get_world_size(mesh.expert_group) == 1:
        return x
    return _AllReduce.apply(x, mesh.expert_group)


def earlier_sp_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of ``x`` over the ``sp`` ranks before this one (coordinates
    below this rank's; zeros on the first), out of the graph: one
    all-gather over ``sp``. The router offsets each expert's slots by the
    earlier positions' routings with it, so that a row's capacity slots are
    the whole sequence's."""
    n = mesh.sizes["sp"]
    out = torch.zeros_like(x)
    if n == 1:
        return out
    parts_ = _all_gather(x.detach(), 0, mesh.sp_group).view(n, *x.shape)
    for i in range(mesh.coords["sp"]):  # in rank order, so every rank adds alike
        out += parts_[i]
    return out


def _staged(t: torch.Tensor, group: Any) -> bool:
    """True where ``t`` crosses ``group`` through the host: under gloo a
    point-to-point message, an all-to-all and a broadcast of a tensor on
    the card are copied to host memory and back by the port itself, not
    left to gloo's CUDA support, which does not cover point-to-point
    messages (the one-card machine runs its two-rank checks on gloo). NCCL
    moves them on the card."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def broadcast(x: torch.Tensor, src: int, group: Any) -> None:
    """``x`` of the rank of index ``src`` in ``group`` into ``x`` on every
    rank of it, in place (through the host under gloo: :func:`_staged`)."""
    host = x.cpu() if _staged(x, group) else x
    with collective_range(group):
        dist.broadcast(host, src=dist.get_global_rank(group, src), group=group)
    if host is not x:
        x.copy_(host)


def send_recv(sends: list, recvs: list, group: Any) -> None:
    """One batch of point-to-point messages over ``group``: each
    ``(tensor, peer)`` of ``sends`` to the rank of index ``peer`` in the
    group, and into each ``(buffer, peer)`` of ``recvs`` from that rank, in
    one ``batch_isend_irecv``; returns once every message has landed. The
    peers' batches must pair up: every send with the peer's receive of the
    same shape. Under gloo, tensors on the card travel through the host
    (:func:`_staged`). Tensors on the meta device (the fit probe's trace,
    on a fake process group that refuses them here) move nothing: the
    receiving buffers are the caller's, already booked."""
    if any(t.is_meta for t, _ in [*sends, *recvs]):
        return
    ranks = dist.get_process_group_ranks(group)
    staged = [(buf, torch.empty_like(buf, device="cpu") if _staged(buf, group) else buf)
              for buf, _ in recvs]
    ops = [dist.P2POp(dist.isend, t.detach().cpu().contiguous() if _staged(t, group)
                      else t.detach().contiguous(), ranks[peer], group)
           for t, peer in sends]
    ops += [dist.P2POp(dist.irecv, host, ranks[peer], group)
            for (_, host), (_, peer) in zip(staged, recvs)]
    if not ops:
        return
    with collective_range(group):
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    for buf, host in staged:
        if host is not buf:
            buf.copy_(host)


def _rotate(x: torch.Tensor, group: Any, shift: int) -> torch.Tensor:
    n, idx = dist.get_world_size(group), dist.get_group_rank(group, dist.get_rank())
    out = torch.empty_like(x)
    send_recv([(x, (idx + shift) % n)], [(out, (idx - shift) % n)], group)
    return out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group: Any, shift: int) -> torch.Tensor:  # noqa: ANN001
        ctx.group, ctx.shift = group, shift
        return _rotate(x, group, shift)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):  # noqa: ANN001, ANN205
        return _rotate(grad, ctx.group, -ctx.shift), None, None


def ppermute(x: torch.Tensor, group: Any, shift: int = 1) -> torch.Tensor:
    """``x`` of the rank ``shift`` places before this one in ``group``
    (cyclic): each rank sends its ``x`` ``shift`` places on, as JAX's
    ``ppermute`` with the permutation ``i -> i + shift``. Backward: the
    gradient sent back the other way. Every rank of the group must call it
    (each call sends and receives once); over a group of one rank, ``x``
    itself."""
    if dist.get_world_size(group) == 1:
        return x
    return _PPermute.apply(x, group, shift)


def _all_to_all(x: torch.Tensor, split_dim: int, concat_dim: int, group: Any) -> torch.Tensor:
    n = dist.get_world_size(group)
    chunks = torch.stack(x.chunk(n, dim=split_dim))  # [n, ...]: chunk j to rank j
    src = chunks.cpu() if _staged(x, group) else chunks
    out = torch.empty_like(src)
    with collective_range(group):
        dist.all_to_all_single(out, src, group=group)
    out = out.to(x.device)
    return torch.cat(out.unbind(0), dim=concat_dim)  # rank i's chunk at block i


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, split_dim: int, concat_dim: int,  # noqa: ANN001
                group: Any) -> torch.Tensor:
        ctx.dims, ctx.group = (split_dim, concat_dim), group
        return _all_to_all(x, split_dim, concat_dim, group)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):  # noqa: ANN001, ANN205
        split_dim, concat_dim = ctx.dims
        return _all_to_all(grad, concat_dim, split_dim, ctx.group), None, None, None


def all_to_all(x: torch.Tensor, split_dim: int, concat_dim: int, group: Any) -> torch.Tensor:
    """The tiled all-to-all of JAX's ``all_to_all(..., tiled=True)``: ``x``
    split into ``n`` blocks along ``split_dim``, block ``j`` sent to rank
    ``j`` of ``group``, and the blocks received from the ranks concatenated
    along ``concat_dim`` in rank order (``[b, s/n, h, d]`` -> ``[b, s, h/n,
    d]`` for ``split_dim`` 2, ``concat_dim`` 1). Backward: the inverse
    exchange. Over a group of one rank, ``x`` itself."""
    if dist.get_world_size(group) == 1:
        return x
    return _AllToAll.apply(x, split_dim, concat_dim, group)
