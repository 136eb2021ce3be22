"""Train→eval→promote pipelines: DAG orchestration over the control plane.

The port's copy of :mod:`torchx_tpu.pipelines`.

"Jobs are not products" — this package turns the launcher's primitives
into lifecycles. A :class:`PipelineSpec` declares a DAG of typed stages
(``train`` → ``eval`` → ``promote``) whose edges carry
:class:`Artifact` records: the train stage publishes its verified
checkpoint (path + MANIFEST.json content digest + step), the eval stage
scores it (``apps/eval_main.py`` re-verifies the digest first), and the
promote stage rolls it onto a canary fraction of the serve pool, gated
by the eval score and the SLO engine's burn rate — promote to 100% or
automatic rollback.

:class:`PipelineEngine` executes the DAG event-driven off the control
daemon's reconciler watch stream (no polling), journals every decision
to fsync'd JSONL with the fleet journal's durability contract, and
rehydrates mid-pipeline — including mid-canary — after a daemon
restart. Submit through the daemon (``POST /v1/pipelines``) or the
``tpx-torch pipeline`` CLI.

The kfp-era runners (``kfp.py``, ``local_runner.py``) are retired into
:mod:`torchx_tpu_torch.pipelines.legacy` behind deprecation shims; the legacy
:class:`Pipeline`/:class:`Stage` builder model they consume remains in
:mod:`torchx_tpu_torch.pipelines.api`.
"""

from torchx_tpu_torch.pipelines.api import Pipeline, Stage, topo_order  # noqa: F401
from torchx_tpu_torch.pipelines.dag import (  # noqa: F401
    ROLE_METADATA_KEY,
    STAGE_KINDS,
    Artifact,
    PipelineSpec,
    PipelineStage,
    checkpoint_artifact,
    resolve_args,
    score_artifact,
)
from torchx_tpu_torch.pipelines.engine import (  # noqa: F401
    PIPELINE_STATES,
    STAGE_STATES,
    PipelineEngine,
    PipelineRun,
    StageRun,
)
from torchx_tpu_torch.pipelines.promote import PromotionController  # noqa: F401

__all__ = [
    "Pipeline",
    "Stage",
    "topo_order",
    "ROLE_METADATA_KEY",
    "STAGE_KINDS",
    "Artifact",
    "PipelineStage",
    "PipelineSpec",
    "checkpoint_artifact",
    "score_artifact",
    "resolve_args",
    "PIPELINE_STATES",
    "STAGE_STATES",
    "StageRun",
    "PipelineRun",
    "PipelineEngine",
    "PromotionController",
]
