"""Observability: traces, metrics, durable sinks, and the telemetry plane.

Port of :mod:`torchx_tpu.obs`:

* :mod:`torchx_tpu_torch.obs.trace` — the :class:`Span` model with
  contextvar propagation; every Runner API call, scheduler spawn and
  supervisor attempt nests under one trace, and the trace context rides
  into the job via ``$TPX_TRACE_ID`` / ``$TPX_PARENT_SPAN`` and across
  HTTP hops via ``X-Tpx-Trace-Id`` / ``X-Tpx-Parent-Span``;
* :mod:`torchx_tpu_torch.obs.metrics` — a dependency-free metrics
  registry (counters / gauges / fixed-bucket histograms) with the
  launcher's and the serving stack's instruments;
* :mod:`torchx_tpu_torch.obs.sinks` — durable output under
  ``~/.torchx_tpu/obs/<session>/``: a JSONL trace/event sink and a
  Prometheus-textfile metrics exporter;
* :mod:`torchx_tpu_torch.obs.timeline` — reads it all back for
  ``tpx-torch trace <app-handle>``;
* :mod:`torchx_tpu_torch.obs.telemetry` — the telemetry plane: a
  collector scrapes replica ``/metricz`` endpoints and tails textfile
  sessions into bounded ring-buffer series, queried by reducer;
* :mod:`torchx_tpu_torch.obs.slo` — declarative SLO specs evaluated as
  multi-window burn rates with journaled alert transitions; the serve
  autoscaler consumes the burn signal;
* :mod:`torchx_tpu_torch.obs.stitch` — cross-process trace stitching:
  ``tpx-torch trace --stitch`` reassembles one timeline per request from
  the router's and the replicas' session directories;
* :mod:`torchx_tpu_torch.obs.profile` — per-step phase attribution for
  the trainer, rendered by ``tpx-torch profile``.

Importing the package loads no torch.
"""

from torchx_tpu_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    REGISTRY,
)
from torchx_tpu_torch.obs.sinks import (
    JsonlTraceHandler,
    flush_metrics,
    obs_root,
    session_dir,
    trace_path,
)
from torchx_tpu_torch.obs.trace import (
    Span,
    current_span,
    current_trace_id,
    heartbeat,
    inject_env,
    span,
    tracing_enabled,
)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "JsonlTraceHandler",
    "MetricsRegistry",
    "REGISTRY",
    "Span",
    "current_span",
    "current_trace_id",
    "flush_metrics",
    "heartbeat",
    "inject_env",
    "obs_root",
    "session_dir",
    "span",
    "trace_path",
    "tracing_enabled",
]
