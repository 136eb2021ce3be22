"""The pipeline DAG model: typed stages wired by artifact edges.

The port's copy of :mod:`torchx_tpu.pipelines.dag`.

A :class:`PipelineSpec` is the declarative half of the train→eval→promote
subsystem: a named DAG whose nodes are component submissions (``train``,
``eval``) or an in-process promotion action (``promote``), and whose edges
carry typed :class:`Artifact` records — a train stage publishes the
PR 7-verified checkpoint (path + MANIFEST.json content digest + step), an
eval stage publishes a score. Downstream stage args reference upstream
artifacts with ``{stage.field}`` placeholders (``{train.path}``,
``{train.digest}``, ``{eval.score}``), resolved by the engine at submit
time so a stage never starts before its inputs exist.

Everything here is stdlib-only and jax-free (enforced by
``scripts/lint_internal.py``): specs travel over the daemon's HTTP API
and through the fsync'd pipeline journal as plain dicts
(:meth:`PipelineSpec.to_dict` / :meth:`PipelineSpec.from_dict`).
"""

from __future__ import annotations

import graphlib
import json
import os
import re
from dataclasses import asdict, dataclass, field
from typing import Any, Mapping, Optional

__all__ = [
    "ROLE_METADATA_KEY",
    "STAGE_KINDS",
    "Artifact",
    "PipelineStage",
    "PipelineSpec",
    "checkpoint_artifact",
    "score_artifact",
    "resolve_args",
]

#: role-metadata key the engine stamps on every submitted stage role with
#: the stage kind (``train``/``eval``/``promote``) — the analyzer's TPX603
#: promotion-observability rule keys off it.
ROLE_METADATA_KEY = "tpx/pipeline"

#: valid :attr:`PipelineStage.kind` values.
STAGE_KINDS = ("train", "eval", "promote")

_PLACEHOLDER = re.compile(r"\{([A-Za-z0-9_.-]+)\.(path|digest|step|score)\}")


@dataclass
class Artifact:
    """A typed edge payload produced by a finished stage.

    ``kind`` is ``"checkpoint"`` (train stages: ``path``/``digest``/``step``
    from the checkpoint MANIFEST.json) or ``"score"`` (eval stages:
    ``score`` plus the checkpoint identity it was measured on).
    """

    kind: str
    path: str = ""
    digest: str = ""
    step: int = -1
    score: Optional[float] = None

    def to_dict(self) -> dict:
        """Plain-dict form for the journal and the HTTP status payload."""
        return asdict(self)

    @classmethod
    def from_dict(cls, doc: Mapping[str, Any]) -> "Artifact":
        """Inverse of :meth:`to_dict`."""
        return cls(
            kind=str(doc.get("kind", "")),
            path=str(doc.get("path", "")),
            digest=str(doc.get("digest", "")),
            step=int(doc.get("step", -1)),
            score=(
                float(doc["score"]) if doc.get("score") is not None else None
            ),
        )

    def field(self, name: str) -> str:
        """Placeholder field lookup (``path``/``digest``/``step``/``score``)."""
        value = getattr(self, name)
        if value is None:
            raise KeyError(f"artifact has no {name!r} value")
        return str(value)


#: default fleet priority class per stage kind: training rides the batch
#: queue (preemptible, checkpointing), eval gates are interactive (a human
#: decision waits on them), promotion touches the serve pool.
_DEFAULT_PRIORITY = {"train": "batch", "eval": "interactive", "promote": "serve"}


@dataclass
class PipelineStage:
    """One DAG node.

    ``train``/``eval`` stages are component submissions (``component`` +
    ``args`` + ``scheduler``/``cfg``), submitted through the fleet
    scheduler when one is attached (``priority`` defaults per kind:
    train=batch, eval=interactive, promote=serve). ``promote`` stages run
    in-process in the daemon: they roll the upstream checkpoint onto a
    canary fraction of the serve pool and gate on eval score + SLO burn.
    """

    name: str
    kind: str
    component: str = ""
    args: list[str] = field(default_factory=list)
    scheduler: str = "local"
    cfg: dict = field(default_factory=dict)
    depends_on: list[str] = field(default_factory=list)
    priority: str = ""
    replicas: int = 1
    #: train: directory whose MANIFEST.json publishes the checkpoint edge.
    ckpt_dir: str = ""
    #: eval: JSON file the eval app writes its score record to.
    score_file: str = ""
    #: eval: absolute score floor — below it the gate fails the pipeline
    #: before any canary starts.
    threshold: Optional[float] = None
    #: eval: ``"incumbent"`` additionally compares the score against the
    #: last promoted checkpoint's score during the canary phase.
    baseline: str = ""
    #: promote: fraction of serve replicas rolled as the canary cohort.
    canary_fraction: float = 0.25
    #: promote: SLO burn rate at/above which the canary rolls back.
    burn_threshold: float = 1.0
    #: promote: how long to watch the canary's burn signal before deciding.
    observe_s: float = 0.0

    def __post_init__(self) -> None:
        if self.kind not in STAGE_KINDS:
            raise ValueError(
                f"stage {self.name!r}: kind must be one of {STAGE_KINDS},"
                f" got {self.kind!r}"
            )
        if not self.name:
            raise ValueError("stage name must be non-empty")
        if not self.priority:
            self.priority = _DEFAULT_PRIORITY[self.kind]
        if self.kind == "eval" and not self.score_file:
            raise ValueError(
                f"eval stage {self.name!r} needs score_file (where the"
                " eval app writes its score record)"
            )

    def to_dict(self) -> dict:
        """Plain-dict form for the journal and the HTTP API."""
        return asdict(self)

    @classmethod
    def from_dict(cls, doc: Mapping[str, Any]) -> "PipelineStage":
        """Inverse of :meth:`to_dict`; unknown keys are ignored."""
        kwargs = {
            k: doc[k]
            for k in (
                "name",
                "kind",
                "component",
                "args",
                "scheduler",
                "cfg",
                "depends_on",
                "priority",
                "replicas",
                "ckpt_dir",
                "score_file",
                "threshold",
                "baseline",
                "canary_fraction",
                "burn_threshold",
                "observe_s",
            )
            if k in doc
        }
        return cls(**kwargs)


@dataclass
class PipelineSpec:
    """A named, validated DAG of :class:`PipelineStage` nodes."""

    name: str
    stages: list[PipelineStage] = field(default_factory=list)

    def stage(self, name: str) -> PipelineStage:
        """Stage lookup by name (KeyError when absent)."""
        for s in self.stages:
            if s.name == name:
                return s
        raise KeyError(f"pipeline {self.name!r} has no stage {name!r}")

    def validate(self) -> None:
        """Reject duplicate names, unknown dependencies and cycles."""
        if not self.name:
            raise ValueError("pipeline name must be non-empty")
        if not self.stages:
            raise ValueError(f"pipeline {self.name!r} has no stages")
        names = [s.name for s in self.stages]
        if len(names) != len(set(names)):
            raise ValueError(f"pipeline {self.name!r} has duplicate stage names")
        known = set(names)
        graph: dict[str, set[str]] = {}
        for s in self.stages:
            missing = [d for d in s.depends_on if d not in known]
            if missing:
                raise ValueError(
                    f"stage {s.name!r} depends on unknown stage(s) {missing}"
                )
            graph[s.name] = set(s.depends_on)
        try:
            tuple(graphlib.TopologicalSorter(graph).static_order())
        except graphlib.CycleError as e:
            raise ValueError(f"pipeline {self.name!r} has a cycle: {e}") from e

    def generations(self) -> list[list[PipelineStage]]:
        """Stages grouped into dependency generations (topological)."""
        self.validate()
        sorter = graphlib.TopologicalSorter(
            {s.name: set(s.depends_on) for s in self.stages}
        )
        sorter.prepare()
        out: list[list[PipelineStage]] = []
        while sorter.is_active():
            ready = list(sorter.get_ready())
            out.append([self.stage(n) for n in sorted(ready)])
            sorter.done(*ready)
        return out

    def to_dict(self) -> dict:
        """Plain-dict form for the journal and the HTTP API."""
        return {
            "name": self.name,
            "stages": [s.to_dict() for s in self.stages],
        }

    @classmethod
    def from_dict(cls, doc: Mapping[str, Any]) -> "PipelineSpec":
        """Inverse of :meth:`to_dict`; validates the result."""
        spec = cls(
            name=str(doc.get("name", "")),
            stages=[
                PipelineStage.from_dict(s) for s in doc.get("stages", [])
            ],
        )
        spec.validate()
        return spec


def checkpoint_artifact(ckpt_dir: str) -> Artifact:
    """The checkpoint edge published by a finished train stage.

    Reads the directory's MANIFEST.json sidecar (written by
    :mod:`torchx_tpu_torch.parallel.checkpoint`, digests included) without
    importing any accelerator code: ``latest_step`` names the newest
    finalized save, ``steps[str(step)]["digest"]`` is its sha256 content
    digest. Raises ``ValueError`` when the manifest is missing, unreadable
    or has no finalized step — a train stage that "succeeded" without a
    verifiable checkpoint must fail its pipeline, not promote garbage.
    """
    from torchx_tpu_torch import settings

    path = os.path.join(ckpt_dir, settings.CHECKPOINT_MANIFEST)
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        raise ValueError(f"no readable checkpoint manifest at {path}: {e}") from e
    step = doc.get("latest_step")
    if not isinstance(step, int) or step < 0:
        raise ValueError(f"{path} records no finalized step")
    rec = doc.get("steps", {}).get(str(step))
    digest = str(rec.get("digest", "")) if isinstance(rec, dict) else ""
    return Artifact(kind="checkpoint", path=ckpt_dir, digest=digest, step=step)


def score_artifact(score_file: str) -> Artifact:
    """The score edge published by a finished eval stage.

    Reads the JSON record ``apps/eval_main.py`` writes (``score`` required;
    ``ckpt``/``digest``/``step`` echo the evaluated checkpoint identity).
    Raises ``ValueError`` when missing or scoreless.
    """
    try:
        with open(score_file) as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        raise ValueError(f"no readable score record at {score_file}: {e}") from e
    if doc.get("score") is None:
        raise ValueError(f"{score_file} has no 'score' field")
    return Artifact(
        kind="score",
        path=str(doc.get("ckpt", "")),
        digest=str(doc.get("digest", "")),
        step=int(doc.get("step", -1)),
        score=float(doc["score"]),
    )


def resolve_args(
    args: list[str], artifacts: Mapping[str, Artifact]
) -> list[str]:
    """Substitute ``{stage.field}`` placeholders with upstream artifact
    values (fields: ``path``/``digest``/``step``/``score``). An unknown
    stage or a field the artifact doesn't carry raises ``KeyError`` — a
    stage must never launch with a dangling input."""

    def _sub(match: "re.Match[str]") -> str:
        stage, fld = match.group(1), match.group(2)
        if stage not in artifacts:
            raise KeyError(
                f"arg references {stage}.{fld} but stage {stage!r} published"
                " no artifact"
            )
        return artifacts[stage].field(fld)

    return [_PLACEHOLDER.sub(_sub, str(a)) for a in args]
