"""Control-plane resilience: deadlines, classified retries, circuit
breakers, and deterministic fault injection.

The port's copy of :mod:`torchx_tpu.resilience`.

The launcher's value is babysitting jobs through a flaky control plane,
so the launcher <-> cloud edge is guarded as the job <-> capacity edge
is. Every backend control-plane interaction (gcloud /
kubectl / sbatch subprocesses, SDK calls, even the local scheduler's
status path) flows through one seam —
:func:`~torchx_tpu_torch.resilience.call.resilient_call` /
:func:`~torchx_tpu_torch.resilience.call.resilient_cmd` — which:

* applies a per-call deadline (``TPX_CONTROL_PLANE_TIMEOUT``; a hung
  gcloud degrades into a classified failure instead of blocking forever),
* classifies failures into a :class:`~torchx_tpu_torch.resilience.errors.FailureKind`
  (transient 429/quota/deadline/connection vs permanent auth/invalid),
* retries transients under a :class:`~torchx_tpu_torch.resilience.policy.CallPolicy`
  (per-kind budgets, capped exponential backoff + jitter),
* guards each backend with a :class:`~torchx_tpu_torch.resilience.breaker.CircuitBreaker`
  (closed -> open -> half-open; fail fast while the backend is down),
* threads the ``TPX_FAULT_PLAN`` chaos-drill injector
  (:mod:`torchx_tpu_torch.resilience.faults`) through the identical code path,
* and emits ``launcher.retry`` / ``launcher.breaker`` spans plus the
  ``tpx_control_plane_{calls,retries,breaker_state}`` metrics.

:class:`~torchx_tpu_torch.resilience.breaker.FailureLedger` is the durable
cousin of the breaker (trip-after-N-consecutive-failures persisted per
user), generalizing the gcp_batch scope-eviction file into a shared
primitive.
"""

from torchx_tpu_torch.resilience.breaker import (
    BreakerState,
    CircuitBreaker,
    FailureLedger,
)
from torchx_tpu_torch.resilience.call import (
    breaker_for,
    control_plane_timeout,
    resilient_call,
    resilient_cmd,
)
from torchx_tpu_torch.resilience.errors import (
    BreakerOpenError,
    FailureKind,
    PermanentSchedulerError,
    SchedulerCallError,
    TransientSchedulerError,
    classify_exception,
    classify_proc,
    classify_text,
    is_transient,
)
from torchx_tpu_torch.resilience.faults import (
    FaultInjector,
    FaultPlan,
    FaultRule,
    fault_plan_active,
)
from torchx_tpu_torch.resilience.policy import NON_IDEMPOTENT, CallPolicy

__all__ = [
    "BreakerOpenError",
    "BreakerState",
    "CallPolicy",
    "CircuitBreaker",
    "FailureKind",
    "FailureLedger",
    "FaultInjector",
    "FaultPlan",
    "FaultRule",
    "NON_IDEMPOTENT",
    "PermanentSchedulerError",
    "SchedulerCallError",
    "TransientSchedulerError",
    "breaker_for",
    "classify_exception",
    "classify_proc",
    "classify_text",
    "control_plane_timeout",
    "fault_plan_active",
    "is_transient",
    "resilient_call",
    "resilient_cmd",
]
