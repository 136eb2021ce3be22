"""Per-call retry policy for the resilient control-plane seam.

The shape mirrors :class:`~torchx_tpu_torch.supervisor.policy.SupervisorPolicy`
one layer down: where the supervisor budgets *resubmissions* per
:class:`~torchx_tpu_torch.specs.api.FailureClass`, a :class:`CallPolicy` budgets
*retries of one control-plane call* per
:class:`~torchx_tpu_torch.resilience.errors.FailureKind`, with the same capped
exponential backoff + jitter scheme. Budgets default to a few quick
retries for throttling/transport blips and zero for everything permanent
— a launcher should shrug off a 429, not mask a revoked credential.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Mapping, Optional

from torchx_tpu_torch.resilience.errors import FailureKind, is_transient


def _default_retries() -> dict[FailureKind, int]:
    """Default per-kind retry budgets (retries, not attempts: 2 means up
    to 3 calls total). Permanent kinds are hard-zeroed in
    :meth:`CallPolicy.retries_for` regardless of this table."""
    return {
        FailureKind.TIMEOUT: 1,
        FailureKind.RATE_LIMIT: 3,
        FailureKind.QUOTA: 2,
        FailureKind.UNAVAILABLE: 2,
        FailureKind.CONNECTION: 2,
    }


@dataclass
class CallPolicy:
    """Knobs governing one resilient control-plane call."""

    #: per-call deadline in seconds, applied as the subprocess timeout by
    #: :func:`~torchx_tpu_torch.resilience.call.resilient_cmd`; None defers to
    #: the ``TPX_CONTROL_PLANE_TIMEOUT`` setting.
    timeout: Optional[float] = None
    #: retry budget per failure kind (missing kind = 0 retries).
    retries: Mapping[FailureKind, int] = field(default_factory=_default_retries)
    #: first retry delay, seconds.
    backoff_seconds: float = 0.5
    #: multiplier per consecutive retry.
    backoff_factor: float = 2.0
    #: ceiling on a single delay, seconds.
    backoff_max_seconds: float = 15.0
    #: ± fraction of random perturbation on every delay.
    jitter: float = 0.1

    def __post_init__(self) -> None:
        if self.timeout is not None and self.timeout <= 0:
            raise ValueError(f"timeout must be > 0, got {self.timeout}")
        if self.backoff_seconds < 0 or self.backoff_max_seconds < 0:
            raise ValueError("backoff delays must be >= 0")
        if self.backoff_factor < 1.0:
            raise ValueError(
                f"backoff_factor must be >= 1.0, got {self.backoff_factor}"
            )
        if not 0.0 <= self.jitter < 1.0:
            raise ValueError(f"jitter must be in [0, 1), got {self.jitter}")
        for kind, budget in self.retries.items():
            if budget < 0:
                raise ValueError(f"retry budget for {kind} must be >= 0")

    def retries_for(self, kind: FailureKind) -> int:
        """Retry budget for one failure kind; permanent kinds always 0."""
        if not is_transient(kind):
            return 0
        return int(self.retries.get(kind, 0))

    def backoff_delay(
        self, retry_number: int, rng: Optional[random.Random] = None
    ) -> float:
        """Jittered delay (seconds) before retry ``retry_number`` (1-based):
        capped exponential, same scheme as
        :meth:`~torchx_tpu_torch.supervisor.policy.SupervisorPolicy.backoff_delay`."""
        if retry_number < 1:
            raise ValueError(f"retry_number must be >= 1, got {retry_number}")
        base = min(
            self.backoff_seconds * self.backoff_factor ** (retry_number - 1),
            self.backoff_max_seconds,
        )
        r = rng or random
        return max(0.0, base * (1.0 + r.uniform(-self.jitter, self.jitter)))


#: policy for non-idempotent calls (submits): deadline + classification
#: still apply, but a call that MAY have reached the control plane is
#: never replayed — a duplicate job is worse than a failed submit.
NON_IDEMPOTENT = CallPolicy(retries={})
