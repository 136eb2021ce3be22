"""Canary promotion: roll a verified checkpoint into the serve pool, or back.

The port's copy of :mod:`torchx_tpu.pipelines.promote`.

:class:`PromotionController` is the in-process actuator behind a
``promote`` stage. It drives the serve pool's per-replica rollout seam
(:meth:`torchx_tpu_torch.serve.pool.ServePool.rollout_replica`: drain →
restart on the new ``--ckpt`` → health-confirm) over a canary fraction of
replicas, weights the :class:`~torchx_tpu_torch.serve.pool.LeastLoadedRouter`'s
traffic split toward the canary cohort, watches the SLO engine's
burn-rate signal for an observation window, and then either promotes to
100% or rolls the canaries back onto the incumbent checkpoint.

Two gates, both journaled through the engine's fsync'd pipeline journal:

* **eval-score regression** — the candidate's eval score fell below the
  incumbent's recorded baseline;
* **SLO burn** — the worst burn rate sampled during the canary window
  reached the stage's ``burn_threshold``.

Either one triggers automatic rollback; neither firing promotes. With no
serve pool attached (a daemon running without serving, e.g. the tier-1
smoke) the controller degrades to the score+burn gates alone — exactly
the condition the analyzer's TPX603 rule warns about when the *metrics*
half is also missing.

Every side effect is reported through the injected ``journal`` callback
*before* the next one is taken, so a daemon killed mid-canary resumes
from the journal with the ``already_rolled`` replica set instead of
re-rolling (or orphaning) replicas.
"""

from __future__ import annotations

import logging
import math
import time
from typing import Any, Callable, Optional, Sequence

from torchx_tpu_torch.pipelines.dag import Artifact

__all__ = ["PromotionController"]

logger = logging.getLogger(__name__)

#: promotion outcomes returned by :meth:`PromotionController.run`.
PROMOTED = "promoted"
ROLLED_BACK = "rolled_back"


class PromotionController:
    """One promote stage's canary rollout, gate and rollback policy.

    Args:
        pool: a :class:`~torchx_tpu_torch.serve.pool.ServePool` (or anything
            with ``replicas``/``router``/``rollout_replica``); None
            degrades to gate-only promotion (no replicas to roll).
        slo_signal: callable returning the current worst SLO burn rate
            (e.g. ``daemon.slo_engine.max_burn``); None skips the burn
            gate.
        canary_fraction: fraction of the pool rolled before the gate.
        canary_weight: router weight applied to canary replicas during
            the observation window (restored to 1.0 afterwards).
        burn_threshold: burn rate at/above which the canary rolls back.
        observe_s: seconds to watch ``slo_signal`` after the canary is up.
        poll_s: burn-signal sampling interval inside the window.
        journal: ``journal(event, **fields)`` callback; every decision is
            journaled before the action that follows it.
        already_rolled: replica ids a previous attempt already rolled
            (rehydration after a daemon restart) — they are not re-rolled
            but still counted as canaries for rollback.
        clock/sleep: injectable time sources for deterministic tests.
    """

    def __init__(
        self,
        pool: Optional[Any] = None,
        *,
        slo_signal: Optional[Callable[[], Optional[float]]] = None,
        canary_fraction: float = 0.25,
        canary_weight: float = 1.0,
        burn_threshold: float = 1.0,
        observe_s: float = 0.0,
        poll_s: float = 0.05,
        journal: Optional[Callable[..., None]] = None,
        already_rolled: Optional[Sequence[int]] = None,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
    ) -> None:
        self._pool = pool
        self._slo_signal = slo_signal
        self._canary_fraction = max(0.0, min(1.0, canary_fraction))
        self._canary_weight = canary_weight
        self._burn_threshold = burn_threshold
        self._observe_s = observe_s
        self._poll_s = max(1e-3, poll_s)
        self._journal = journal or (lambda event, **fields: None)
        self.already_rolled = set(already_rolled or ())
        self._clock = clock
        self._sleep = sleep

    # -- helpers -----------------------------------------------------------

    def _replica_ids(self) -> list[int]:
        if self._pool is None:
            return []
        return list(range(int(self._pool.replicas)))

    def _router(self) -> Optional[Any]:
        return getattr(self._pool, "router", None)

    def _roll(self, rid: int, ckpt: str, reason: str) -> bool:
        """One replica through the pool's drain→restart→confirm seam; the
        journal entry lands only after the replica is confirmed healthy."""
        ok = bool(self._pool.rollout_replica(rid, ckpt))
        if ok:
            self._journal("replica_rolled", replica=rid, ckpt=ckpt, why=reason)
            self.already_rolled.add(rid)
        return ok

    def _observe_burn(self) -> float:
        """Worst burn rate over the observation window (early exit the
        moment the threshold is reached — no point burning longer)."""
        worst = 0.0
        if self._slo_signal is None:
            if self._observe_s > 0:
                self._sleep(self._observe_s)
            return worst
        deadline = self._clock() + self._observe_s
        while True:
            try:
                burn = self._slo_signal()
            except Exception as e:  # noqa: BLE001 - a dead signal gates nothing
                logger.debug("slo signal failed during canary: %s", e)
                burn = None
            if burn is not None:
                worst = max(worst, float(burn))
                if worst >= self._burn_threshold:
                    return worst
            if self._clock() >= deadline:
                return worst
            self._sleep(min(self._poll_s, max(0.0, deadline - self._clock())))

    # -- the promotion ----------------------------------------------------

    def run(
        self,
        candidate: Artifact,
        *,
        score: Optional[float] = None,
        baseline_score: Optional[float] = None,
        incumbent_ckpt: str = "",
    ) -> str:
        """Canary → observe → gate → promote or roll back.

        Returns ``"promoted"`` or ``"rolled_back"``. The incumbent
        checkpoint path (``incumbent_ckpt``) is what canaries are rolled
        *back* onto; empty means there is nothing to restore (first ever
        promotion) and rollback only restores router weights.
        """
        replicas = self._replica_ids()
        n_canary = (
            min(len(replicas), max(1, math.ceil(len(replicas) * self._canary_fraction)))
            if replicas
            else 0
        )
        canaries = replicas[:n_canary]
        self._journal(
            "canary_start",
            ckpt=candidate.path,
            digest=candidate.digest,
            step=candidate.step,
            canaries=canaries,
            resumed=sorted(self.already_rolled),
        )
        router = self._router()
        try:
            for rid in canaries:
                if rid in self.already_rolled:
                    continue
                if not self._roll(rid, candidate.path, "canary"):
                    self._rollback(canaries, incumbent_ckpt, "rollout_failed")
                    return ROLLED_BACK
                if router is not None and hasattr(router, "set_weight"):
                    router.set_weight(rid, self._canary_weight)

            worst_burn = self._observe_burn()
            regressed = (
                score is not None
                and baseline_score is not None
                and score < baseline_score
            )
            burned = (
                self._slo_signal is not None
                and worst_burn >= self._burn_threshold
            )
            if regressed or burned:
                reason = "eval_regression" if regressed else "slo_burn"
                self._journal(
                    "gate",
                    passed=False,
                    reason=reason,
                    score=score,
                    baseline=baseline_score,
                    burn=worst_burn,
                    burn_threshold=self._burn_threshold,
                )
                self._rollback(canaries, incumbent_ckpt, reason)
                return ROLLED_BACK

            self._journal(
                "gate",
                passed=True,
                score=score,
                baseline=baseline_score,
                burn=worst_burn,
                burn_threshold=self._burn_threshold,
            )
            for rid in replicas:
                if rid in self.already_rolled:
                    continue
                if not self._roll(rid, candidate.path, "promote"):
                    self._rollback(replicas, incumbent_ckpt, "rollout_failed")
                    return ROLLED_BACK
            self._journal("promoted", ckpt=candidate.path, digest=candidate.digest)
            return PROMOTED
        finally:
            if router is not None and hasattr(router, "set_weight"):
                for rid in replicas:
                    router.set_weight(rid, 1.0)

    def _rollback(
        self, cohort: Sequence[int], incumbent_ckpt: str, reason: str
    ) -> None:
        """Journal the rollback decision, then restore every replica this
        attempt (or a resumed prior attempt) rolled."""
        rolled = sorted(set(cohort) & self.already_rolled)
        self._journal(
            "rollback",
            reason=reason,
            replicas=rolled,
            incumbent=incumbent_ckpt,
        )
        if self._pool is None or not incumbent_ckpt:
            return
        for rid in rolled:
            try:
                self._pool.rollout_replica(rid, incumbent_ckpt)
            except Exception as e:  # noqa: BLE001 - restore the rest anyway
                logger.warning("rollback of replica %d failed: %s", rid, e)
