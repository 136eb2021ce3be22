"""The training mesh over a ``torch.distributed`` world, and the FSDP
collectives that move a sharded parameter and its gradient.

The port of :mod:`torchx_tpu.parallel.mesh`'s data axes. JAX lays the
6-axis mesh (pp, dp, fsdp, ep, tp, sp) over its devices and lets GSPMD
insert the collectives; here :func:`make_mesh` lays the same axes, in the
same order, over the ranks of the default process group (a
``DeviceMesh``), and the model calls the collectives itself:

* :func:`gather_param` all-gathers a parameter's ``fsdp`` shards for one
  use; its backward reduce-scatters (sums) the gradient, so that each rank
  keeps the gradient of its own shard, summed over ``fsdp``;
* :func:`replicated_param` marks a parameter every ``fsdp`` rank holds
  whole (the norms' weights); its backward sums the gradient over
  ``fsdp``;
* the ``dp`` sum of every gradient comes after the backward
  (:mod:`torchx_tpu_torch.parallel.overlap`).

Rank ``r``'s coordinates are ``r``'s index in the row-major
``[pp, dp, fsdp, ep, tp, sp]`` array of ranks, as device ``r`` is in the
JAX mesh, so a shard here equals JAX's addressable shard on device ``r``.
Only the data axes (``dp``, ``fsdp``) shard anything yet; ``tp``, ``sp``,
``ep`` and ``pp`` are laid out but must have size 1 (ROADMAP queue 1 item
2).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from torchx_tpu_torch.parallel.mesh_config import AXES, MeshConfig

#: The axes a batch shards over, outermost first, as the JAX package's
#: ``BATCH_SPEC`` = ``P(("dp", "fsdp"), None)`` shards it.
DATA_AXES = ("dp", "fsdp")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The mesh of this rank: axis sizes, this rank's coordinate on each
    axis, and the process groups of the data axes."""

    device_mesh: DeviceMesh
    sizes: dict[str, int]
    coords: dict[str, int]
    #: ranks that differ only in their ``dp`` / ``fsdp`` coordinate
    dp_group: Any
    fsdp_group: Any
    #: ranks that differ only in their data coordinates (dp and fsdp): the
    #: ranks that split one batch between them
    data_group: Any
    backend: str

    @property
    def data_size(self) -> int:
        """Ranks one batch is split between (``dp * fsdp``)."""
        return self.sizes["dp"] * self.sizes["fsdp"]

    @property
    def data_index(self) -> int:
        """This rank's block of a batch, in ``DATA_AXES``' order."""
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

    def parts(self, axes: Any) -> tuple[int, int]:
        """(number of shards, this rank's shard index) of a dimension that
        a spec entry ``axes`` shards (:func:`parts`)."""
        return parts(axes, self.sizes, self.coords)

    def unshard(self, x: torch.Tensor, spec: tuple) -> torch.Tensor:
        """The whole parameter from this rank's shard ``x`` under ``spec``
        (one entry per dimension of ``x``), differentiably: a gather over
        ``fsdp`` where the spec shards a dimension, else the replicated
        marker."""
        dim = None
        for d, axes in enumerate(spec):
            if axes == "fsdp" and dim is None:
                dim = d
            elif self.parts(axes)[0] > 1:
                raise NotImplementedError(
                    f"spec {spec}: only one dimension sharded over fsdp is ported"
                    " (tp/sp/ep/pp: ROADMAP queue 1 item 2)"
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
    # the data group: the ranks sharing every model-axis coordinate, one
    # group per such coordinate, created on every rank in the same order
    model = [AXES.index(a) for a in AXES if a not in DATA_AXES]
    data = [AXES.index(a) for a in DATA_AXES]
    rows = ranks.permute(*model, *data).reshape(-1, math.prod(sizes[a] for a in DATA_AXES))
    data_group, _ = dist.new_subgroups_by_enumeration(rows.tolist())
    return Mesh(
        device_mesh=device_mesh,
        sizes=sizes,
        coords=coords,
        dp_group=device_mesh.get_group("dp"),
        fsdp_group=device_mesh.get_group("fsdp"),
        data_group=data_group,
        backend=backend,
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
    dist.all_gather_into_tensor(buf, shard_.contiguous(), group=group)
    if dim == 0:
        return buf
    return buf.view(n, *s).movedim(0, dim).reshape(*s[:dim], n * s[dim], *s[dim + 1:])


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
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _GroupMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group: Any) -> torch.Tensor:  # noqa: ANN001
        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out / dist.get_world_size(group)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):  # noqa: ANN001, ANN205
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad / dist.get_world_size(ctx.group), None


def group_mean(x: torch.Tensor, group: Any) -> torch.Tensor:
    """The mean of ``x`` over the ranks of ``group`` (each holding the
    same number of rows of a batch, so the mean of their means is the
    batch's), differentiably: every rank's output depends on every rank's
    ``x``, so the gradient flows back summed over the group's outputs."""
    return _GroupMean.apply(x, group)


def gather_param(shard_: torch.Tensor, dim: int, group: Any) -> torch.Tensor:
    """The whole parameter from the ``group``'s shards along ``dim``
    (``all_gather_into_tensor``); the gradient flows back as a
    ``reduce_scatter_tensor`` sum, each rank keeping its shard's."""
    return _GatherParam.apply(shard_, dim, group)


def replicated_param(x: torch.Tensor, group: Any) -> torch.Tensor:
    """``x`` itself, held whole by every rank of ``group``, whose ranks
    compute on different rows: the gradient flows back summed over
    ``group`` (``all_reduce``)."""
    return _ReplicatedParam.apply(x, group)
