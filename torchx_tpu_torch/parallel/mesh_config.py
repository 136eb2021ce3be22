"""The mesh's shape model: axis sizes, specs, and elastic reshaping.

A copy of :mod:`torchx_tpu.parallel.mesh_config` (pure arithmetic, no
runtime), kept in the port so that the port imports nothing of the JAX
package. :class:`MeshConfig` sizes the canonical 6-axis training mesh (see
:mod:`torchx_tpu_torch.parallel.mesh` for the process groups over it); the
launcher's supervisor computes *degraded* shapes after a preemption or hang
(``dp``/``fsdp`` shrink, ``tp``/``ep``/``sp``/``pp`` are preserved — model
and expert sharding cannot change without re-planning the program) and
injects the result as a ``TPX_MESH`` spec string into the resubmitted
attempt.

Spec strings are the CLI ``--mesh`` syntax (``dp=2,fsdp=-1,tp=4``), the
shared currency between the launcher, the attempt ledger, and the in-job
trainer.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

AXES = ("pp", "dp", "fsdp", "ep", "tp", "sp")

#: axes an elastic reshape may shrink (pure data parallelism): losing
#: capacity reduces throughput, not the model's sharding plan.
DATA_AXES = ("dp", "fsdp")

#: axes an elastic reshape must preserve: resizing any of these changes
#: how parameters/experts are laid out and needs a full re-plan.
MODEL_AXES = ("pp", "ep", "tp", "sp")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Mesh axis sizes; -1 on at most one axis means "all remaining
    devices"."""

    pp: int = 1
    dp: int = 1
    fsdp: int = -1
    ep: int = 1
    tp: int = 1
    sp: int = 1

    def resolve(self, n_devices: int) -> dict[str, int]:
        """Concrete axis sizes for ``n_devices`` (the single -1 axis
        absorbs the remainder); raises when sizes don't multiply out."""
        sizes = {a: getattr(self, a) for a in AXES}
        wild = [a for a, s in sizes.items() if s == -1]
        if len(wild) > 1:
            raise ValueError(f"at most one -1 axis allowed, got {wild}")
        fixed = math.prod(s for s in sizes.values() if s != -1)
        if wild:
            if n_devices % fixed:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes {sizes}"
                )
            sizes[wild[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(
                f"mesh {sizes} needs {fixed} devices, have {n_devices}"
            )
        return sizes


def axis_networks(
    sizes: dict[str, int], chips_per_slice: int
) -> dict[str, str]:
    """Classify each mesh axis as ``"ici"``, ``"dcn"`` or ``"mixed"``
    (``"none"`` for size-1 axes) from the slice topology.

    ``make_mesh`` (parallel/mesh.py) reshapes the rank list in
    :data:`AXES` order, outermost (``pp``) to innermost (``sp``), and the
    device list enumerates slices contiguously — so an axis's position in
    the flat rank order decides which interconnect its collectives
    traverse. With ``stride(axis)`` = product of the sizes of the axes
    *after* it:

    * ``stride * size <= chips_per_slice`` — every hop along the axis
      stays inside one slice: **ici**.
    * ``stride >= chips_per_slice`` — every hop crosses a slice boundary:
      **dcn**.
    * otherwise the axis straddles the boundary: **mixed** (part of each
      ring is ICI, part DCN — the DCN segment paces the collective).

    ``sizes`` must be fully resolved (no -1); extra keys are ignored.
    """
    out: dict[str, str] = {}
    stride = 1
    for axis in reversed(AXES):
        size = int(sizes.get(axis, 1))
        if size <= 1:
            out[axis] = "none"
            continue
        extent = stride * size
        if extent <= chips_per_slice:
            out[axis] = "ici"
        elif stride >= chips_per_slice:
            out[axis] = "dcn"
        else:
            out[axis] = "mixed"
        stride = extent
    return out


def parse_mesh_spec(spec: str) -> MeshConfig:
    """``"dp=2,fsdp=-1,tp=4"`` -> :class:`MeshConfig` (unnamed axes keep
    their defaults; unknown axis names raise)."""
    kwargs: dict[str, int] = {}
    for pair in spec.split(","):
        if not pair.strip():
            continue
        k, _, v = pair.partition("=")
        k = k.strip()
        if k not in AXES:
            raise ValueError(f"unknown mesh axis {k!r}; valid axes: {AXES}")
        kwargs[k] = int(v)
    return MeshConfig(**kwargs)


def mesh_sizes_spec(sizes: dict[str, int]) -> str:
    """Resolved axis sizes -> a fully-explicit spec string (every axis
    named, no -1), suitable for the attempt ledger and ``TPX_MESH``."""
    return ",".join(f"{a}={int(sizes[a])}" for a in AXES)


def shrink_data_axes(
    sizes: dict[str, int], target_devices: Optional[int] = None
) -> dict[str, int]:
    """A degraded mesh shape after capacity loss: shrink ``dp`` first,
    then ``fsdp``, never the model axes.

    ``sizes`` are fully-resolved axis sizes (no -1). With
    ``target_devices`` the data axes are refit to exactly that device
    count (used when the gang monitor knows how many replicas survive);
    without it the shape degrades one binary step — halve ``dp`` when it
    can shrink, else halve ``fsdp`` (used when all the supervisor knows is
    "the attempt was preempted"). Raises :class:`ValueError` when the
    target cannot preserve the model axes or there is no data parallelism
    left to give up — the caller then resubmits at the current shape.
    """
    model = math.prod(sizes[a] for a in MODEL_AXES)
    cur_data = sizes["dp"] * sizes["fsdp"]
    if target_devices is None:
        if sizes["dp"] > 1:
            return {**sizes, "dp": sizes["dp"] // 2}
        if sizes["fsdp"] > 1:
            return {**sizes, "fsdp": sizes["fsdp"] // 2}
        raise ValueError(
            f"mesh {mesh_sizes_spec(sizes)} has no data parallelism left to"
            " shrink (dp=fsdp=1)"
        )
    if target_devices < model or target_devices % model:
        raise ValueError(
            f"{target_devices} surviving devices cannot preserve the model"
            f" axes of {mesh_sizes_spec(sizes)} (pp*ep*tp*sp={model})"
        )
    data = target_devices // model
    if data >= cur_data:
        raise ValueError(
            f"target {target_devices} devices is not a shrink of"
            f" {mesh_sizes_spec(sizes)}"
        )
    # preserve the fsdp extent when possible (parameter shards stay the
    # same size across the restore), folding the loss into dp; otherwise
    # collapse dp and give fsdp whatever data parallelism remains
    fsdp = sizes["fsdp"]
    if fsdp > 0 and data % fsdp == 0:
        return {**sizes, "dp": data // fsdp, "fsdp": fsdp}
    return {**sizes, "dp": 1, "fsdp": data}
