"""Deprecated shim: moved to :mod:`torchx_tpu_torch.pipelines.legacy`.

The DAG engine (:mod:`torchx_tpu_torch.pipelines.engine`) owns the pipelines
namespace now; the KFP/Argo workflow materializer lives on unchanged in
``legacy`` and stays importable from here.
"""

from torchx_tpu_torch.deprecations import deprecated_module
from torchx_tpu_torch.pipelines.legacy import pipeline_to_workflow  # noqa: F401

deprecated_module(__name__, replacement="torchx_tpu_torch.pipelines.legacy")
