"""Deprecated shim: moved to :mod:`torchx_tpu_torch.pipelines.legacy`.

The blocking generation-by-generation runner predates the journaled,
event-driven :mod:`torchx_tpu_torch.pipelines.engine`; it lives on unchanged
in ``legacy`` and stays importable from here.
"""

from torchx_tpu_torch.deprecations import deprecated_module
from torchx_tpu_torch.pipelines.legacy import (  # noqa: F401
    PipelineRun,
    run_pipeline,
)

deprecated_module(__name__, replacement="torchx_tpu_torch.pipelines.legacy")
