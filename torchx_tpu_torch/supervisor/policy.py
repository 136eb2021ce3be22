"""Retry policy for the supervisor: per-failure-class budgets and backoff.

Port of :mod:`torchx_tpu.supervisor.policy`, field for field, so a policy
file and a session's ``meta.json`` read the same in either package.

The central design decision: preemptions, infra failures, and app failures
are NOT the same event and must not share one retry counter. A spot H100
node may be reclaimed a dozen times over a
long run — that is the product working as priced, and resubmitting is free
progress as long as checkpoints land. An app bug, on the other hand, will
fail deterministically forever; resubmitting it burns quota. So each
:class:`~torchx_tpu_torch.specs.api.FailureClass` gets its own budget, with
defaults tilted accordingly (many preemptions, a few infra retries, zero
app retries).
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Optional

from torchx_tpu_torch import settings
from torchx_tpu_torch.specs.api import FailureClass


@dataclass
class SupervisorPolicy:
    """Knobs for one supervised run; round-trips through
    :func:`torchx_tpu_torch.specs.serialize.supervisor_policy_to_dict` so the CLI
    can load it from a JSON file.

    Budgets are *independent*: ``max_preemptions=8`` and
    ``max_app_retries=0`` means the eighth spot reclaim still resubmits,
    while the first genuine application error stays FAILED.
    """

    # -- retry budgets, one per FailureClass -------------------------------
    #: resubmissions allowed after spot/preemption reclaims.
    max_preemptions: int = 8
    #: resubmissions allowed after control-plane / node failures.
    max_infra_retries: int = 3
    #: resubmissions allowed after application (exit-code) failures.
    #: Default 0: an app bug fails deterministically; retrying burns quota.
    max_app_retries: int = 0
    #: resubmissions allowed after gang hangs / partial gang loss detected
    #: by the gang monitor (scheduler still says RUNNING, heartbeats
    #: stale). A hang is usually a wedged collective, worth a couple of
    #: kill+resubmit cycles.
    max_hang_retries: int = 2

    # -- capped exponential backoff between resubmissions ------------------
    #: first delay before a resubmit, seconds.
    backoff_seconds: float = 5.0
    #: multiplier applied per consecutive retry of the same class.
    backoff_factor: float = 2.0
    #: ceiling on any single delay, seconds.
    backoff_max_seconds: float = 300.0
    #: ± fraction of random perturbation applied to every delay so many
    #: supervisors recovering from one zone-wide event decorrelate.
    jitter: float = 0.1

    # -- monitoring --------------------------------------------------------
    #: cap on the jittered incremental poll interval while an attempt runs.
    poll_interval: float = 10.0
    #: consecutive status polls allowed to fail with a *transient* error
    #: (classified by :mod:`torchx_tpu_torch.resilience.errors`) before the
    #: failure surfaces. Within the budget the poll loop degrades to a
    #: warning + ``poll_degraded`` event and keeps waiting — a control
    #: plane blip must not make the supervisor lose a healthy job.
    poll_miss_budget: int = 3
    #: run the elastic watcher (shrink-on-failure) during each attempt when
    #: the backend has one, instead of plain status polling.
    elastic: bool = False

    # -- gang health (hang detection while status reads RUNNING) -----------
    #: seconds without any fresh heartbeat/lease before a replica counts as
    #: stale; 0 disables gang monitoring entirely (plain wait).
    hang_deadline_seconds: float = 0.0
    #: how often the gang monitor re-reads heartbeats between polls.
    gang_check_interval: float = 5.0
    #: liveness-lease TTL the monitor uses for replicas that renew leases;
    #: 0 falls back to ``hang_deadline_seconds``.
    lease_ttl_seconds: float = 0.0
    #: warn (event + metric, no kill) when the fastest and slowest replica
    #: drift more than this many steps apart; 0 disables straggler checks.
    straggler_step_lag: int = 0

    # -- elastic mesh reshape on resubmit ----------------------------------
    #: after PREEMPTION/HANG, recompute a degraded mesh (shrink dp/fsdp,
    #: preserve pp/ep/tp/sp) and inject it as ``TPX_MESH`` on resubmit.
    #: Requires ``mesh``.
    elastic_reshape: bool = False
    #: the job's launch mesh spec (``--mesh`` syntax); basis for reshapes.
    mesh: Optional[str] = None
    #: accelerator devices each replica contributes to the mesh (surviving
    #: replicas × this = the device count a degraded shape must fit).
    devices_per_replica: int = 1

    # -- checkpoint resume -------------------------------------------------
    #: client-visible checkpoint directory to read the step manifest from;
    #: None disables resume injection (the app's own restore_latest still
    #: applies in-job).
    checkpoint_dir: Optional[str] = None
    #: env var injected into every role with the resume step.
    resume_env: str = field(default=settings.ENV_TPX_RESUME_STEP)

    def __post_init__(self) -> None:
        for name in (
            "max_preemptions",
            "max_infra_retries",
            "max_app_retries",
            "max_hang_retries",
        ):
            if getattr(self, name) < 0:
                raise ValueError(f"{name} must be >= 0, got {getattr(self, name)}")
        if self.backoff_seconds < 0 or self.backoff_max_seconds < 0:
            raise ValueError("backoff delays must be >= 0")
        if self.backoff_factor < 1.0:
            raise ValueError(
                f"backoff_factor must be >= 1.0, got {self.backoff_factor}"
            )
        if not 0.0 <= self.jitter < 1.0:
            raise ValueError(f"jitter must be in [0, 1), got {self.jitter}")
        if self.poll_interval <= 0:
            raise ValueError(f"poll_interval must be > 0, got {self.poll_interval}")
        if self.poll_miss_budget < 0:
            raise ValueError(
                f"poll_miss_budget must be >= 0, got {self.poll_miss_budget}"
            )
        if self.hang_deadline_seconds < 0 or self.lease_ttl_seconds < 0:
            raise ValueError("gang deadlines must be >= 0")
        if self.gang_check_interval <= 0:
            raise ValueError(
                f"gang_check_interval must be > 0, got {self.gang_check_interval}"
            )
        if self.straggler_step_lag < 0:
            raise ValueError(
                f"straggler_step_lag must be >= 0, got {self.straggler_step_lag}"
            )
        if self.devices_per_replica < 1:
            raise ValueError(
                f"devices_per_replica must be >= 1, got {self.devices_per_replica}"
            )
        if self.elastic_reshape and not self.mesh:
            raise ValueError("elastic_reshape requires a mesh spec")
        if self.mesh is not None:
            # validate early: a bad spec should fail at policy build, not
            # mid-recovery (parse only — jax-free)
            from torchx_tpu_torch.parallel.mesh_config import parse_mesh_spec

            parse_mesh_spec(self.mesh)

    def budget_for(self, failure_class: FailureClass) -> int:
        """The retry budget governing one failure class."""
        return {
            FailureClass.PREEMPTION: self.max_preemptions,
            FailureClass.INFRA: self.max_infra_retries,
            FailureClass.APP: self.max_app_retries,
            FailureClass.HANG: self.max_hang_retries,
        }[failure_class]

    def backoff_delay(
        self, retry_number: int, rng: Optional[random.Random] = None
    ) -> float:
        """Jittered delay (seconds) before retry ``retry_number`` (1-based
        count of consecutive retries for the failing class): capped
        exponential ``backoff_seconds * factor**(n-1)``, perturbed by
        ±``jitter``. A seeded ``rng`` makes tests deterministic."""
        if retry_number < 1:
            raise ValueError(f"retry_number must be >= 1, got {retry_number}")
        base = min(
            self.backoff_seconds * self.backoff_factor ** (retry_number - 1),
            self.backoff_max_seconds,
        )
        r = rng or random
        return max(0.0, base * (1.0 + r.uniform(-self.jitter, self.jitter)))
