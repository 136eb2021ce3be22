"""Pipeline data model: a DAG of AppDef stages.

The port's copy of :mod:`torchx_tpu.pipelines.api`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from graphlib import CycleError, TopologicalSorter

from torchx_tpu_torch.specs.api import AppDef


@dataclass
class Stage:
    """One node of the DAG: an app plus the names of stages it needs."""

    name: str
    app: AppDef
    depends_on: list[str] = field(default_factory=list)


@dataclass
class Pipeline:
    name: str
    stages: list[Stage] = field(default_factory=list)

    def stage(self, name: str, app: AppDef, depends_on: list[str] | None = None) -> "Pipeline":
        """Builder-style stage append (returns self for chaining)."""
        self.stages.append(Stage(name=name, app=app, depends_on=depends_on or []))
        return self


def topo_order(pipeline: Pipeline) -> list[list[Stage]]:
    """-> stages grouped into parallel-executable generations, dependency
    order. Raises ValueError on cycles or unknown dependencies."""
    by_name = {s.name: s for s in pipeline.stages}
    if len(by_name) != len(pipeline.stages):
        raise ValueError("duplicate stage names in pipeline")
    for s in pipeline.stages:
        for dep in s.depends_on:
            if dep not in by_name:
                raise ValueError(f"stage {s.name!r} depends on unknown stage {dep!r}")
    ts: TopologicalSorter = TopologicalSorter(
        {s.name: set(s.depends_on) for s in pipeline.stages}
    )
    try:
        ts.prepare()
    except CycleError as e:
        raise ValueError(f"pipeline has a dependency cycle: {e}") from e
    generations: list[list[Stage]] = []
    while ts.is_active():
        ready = list(ts.get_ready())
        generations.append([by_name[n] for n in ready])
        ts.done(*ready)
    return generations
