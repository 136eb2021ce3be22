"""Preemption-aware job supervisor: auto-resubmit with retry budgets,
capped exponential backoff, and checkpoint-resume wiring.

The missing layer between "the scheduler restarts replicas inside one job"
(RetryPolicy / JobSet failurePolicy) and "the operator resubmits the job by
hand": a client-side loop that watches one app to a terminal state,
classifies *why* it died (:class:`~torchx_tpu_torch.specs.api.FailureClass`),
and — within independent per-class budgets — re-materializes the original
:class:`~torchx_tpu_torch.specs.api.AppDryRunInfo` and submits a fresh attempt,
telling it which checkpoint step to resume from. See
:class:`~torchx_tpu_torch.supervisor.api.Supervisor` for the state machine and
:class:`~torchx_tpu_torch.supervisor.policy.SupervisorPolicy` for the knobs.

Gang health (:mod:`torchx_tpu_torch.supervisor.gang`) extends the loop to
failures the scheduler cannot see: a :class:`GangMonitor` tails the job's
heartbeats and liveness leases between status polls, and a HANG /
PARTIAL_LOSS verdict makes the supervisor kill the attempt, classify it
``FailureClass.HANG``, and — with ``elastic_reshape`` — resubmit onto a
degraded mesh that fits the surviving capacity.
"""

from torchx_tpu_torch.supervisor.api import (
    Supervisor,
    SupervisorResult,
    latest_checkpoint_step,
    supervise,
)
from torchx_tpu_torch.supervisor.gang import (
    GangMonitor,
    GangState,
    GangVerdict,
    read_leases,
    renew_lease,
)
from torchx_tpu_torch.supervisor.ledger import AttemptLedger, list_sessions
from torchx_tpu_torch.supervisor.policy import SupervisorPolicy

__all__ = [
    "AttemptLedger",
    "GangMonitor",
    "GangState",
    "GangVerdict",
    "Supervisor",
    "SupervisorPolicy",
    "SupervisorResult",
    "latest_checkpoint_step",
    "list_sessions",
    "read_leases",
    "renew_lease",
    "supervise",
]
