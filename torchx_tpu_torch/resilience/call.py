"""The single seam every control-plane interaction goes through.

Two entry points, one behavior:

* :func:`resilient_cmd` wraps a backend's raw ``_run_cmd`` subprocess
  seam (gcloud / kubectl / sbatch / squeue ...): applies the default
  control-plane deadline (``TPX_CONTROL_PLANE_TIMEOUT``), classifies
  non-zero exits by stderr and timeouts structurally, and retries
  transient outcomes within the :class:`~torchx_tpu_torch.resilience.policy.CallPolicy`
  budget. Callers keep their ``returncode``-based semantics: when the
  budget is exhausted the last failing ``CompletedProcess`` is returned
  (a timeout synthesizes one with returncode 124), never raised.
* :func:`resilient_call` wraps an arbitrary callable (SDK invocations,
  in-process scheduler methods): exceptions are classified via
  :func:`~torchx_tpu_torch.resilience.errors.classify_exception` and transient
  ones retried; the *original* exception is re-raised when the budget is
  exhausted so existing caller ``except`` clauses keep working.

Both consult the per-backend :class:`~torchx_tpu_torch.resilience.breaker.CircuitBreaker`
(fail fast while a backend is down), thread the deterministic
``TPX_FAULT_PLAN`` injector through the exact same code path real
failures take, and emit the observability surface: ``launcher.retry`` /
``launcher.breaker`` spans plus the ``tpx_control_plane_*`` metrics.
"""

from __future__ import annotations

import logging
import os
import random
import subprocess
import time
from typing import Any, Callable, Optional, TypeVar

from torchx_tpu_torch import settings
from torchx_tpu_torch.obs import metrics as obs_metrics
from torchx_tpu_torch.obs import trace as obs_trace
from torchx_tpu_torch.resilience import faults
from torchx_tpu_torch.resilience.breaker import (
    STATE_VALUES,
    BreakerState,
    CircuitBreaker,
)
from torchx_tpu_torch.resilience.errors import (
    BreakerOpenError,
    FailureKind,
    classify_exception,
    classify_proc,
    is_transient,
)
from torchx_tpu_torch.resilience.policy import CallPolicy

logger = logging.getLogger(__name__)

T = TypeVar("T")

#: the policy used when a call site passes none; tests may swap it for a
#: near-zero-backoff variant to keep retry paths fast.
DEFAULT_POLICY = CallPolicy()

#: synthesized returncode for an exhausted-deadline subprocess call
#: (the shell convention for "killed by timeout(1)").
TIMEOUT_RETURNCODE = 124


def control_plane_timeout() -> Optional[float]:
    """The default per-call deadline in seconds from
    ``TPX_CONTROL_PLANE_TIMEOUT`` (default
    :data:`~torchx_tpu_torch.settings.DEFAULT_CONTROL_PLANE_TIMEOUT`);
    ``0``/``off``/``none`` disables the deadline entirely."""
    raw = os.environ.get(settings.ENV_TPX_CONTROL_PLANE_TIMEOUT)
    if raw is None or not raw.strip():
        return settings.DEFAULT_CONTROL_PLANE_TIMEOUT
    if raw.strip().lower() in ("0", "off", "none", "false"):
        return None
    try:
        value = float(raw)
    except ValueError:
        logger.warning(
            "unparseable %s=%r; using default %ss",
            settings.ENV_TPX_CONTROL_PLANE_TIMEOUT,
            raw,
            settings.DEFAULT_CONTROL_PLANE_TIMEOUT,
        )
        return settings.DEFAULT_CONTROL_PLANE_TIMEOUT
    return value if value > 0 else None


# -- per-backend breakers -------------------------------------------------

_breakers: dict[str, CircuitBreaker] = {}


def breaker_for(backend: str) -> CircuitBreaker:
    """The process-wide circuit breaker guarding one backend
    (get-or-create; all seam calls for a backend share it)."""
    breaker = _breakers.get(backend)
    if breaker is None:
        breaker = _breakers.setdefault(backend, CircuitBreaker(backend))
    return breaker


def reset_breakers() -> None:
    """Drop every breaker (tests)."""
    _breakers.clear()


def _note_breaker_transition(
    breaker: CircuitBreaker, backend: str, before: BreakerState
) -> None:
    after = breaker.state
    if after is before:
        return
    obs_metrics.BREAKER_STATE.set(STATE_VALUES[after], backend=backend)
    with obs_trace.span(
        "launcher.breaker",
        backend=backend,
        state=after.value,
        previous=before.value,
    ):
        pass
    log = logger.warning if after is BreakerState.OPEN else logger.info
    log("%s control plane breaker: %s -> %s", backend, before.value, after.value)


def _check_breaker(backend: str, op: str) -> CircuitBreaker:
    breaker = breaker_for(backend)
    if not breaker.allow():
        obs_metrics.CONTROL_PLANE_CALLS.inc(
            backend=backend, op=op, status="rejected"
        )
        raise BreakerOpenError(
            f"{backend} control plane breaker is open"
            f" (cooling down after repeated transient failures);"
            f" refusing {op}",
            kind=FailureKind.UNAVAILABLE,
            backend=backend,
            op=op,
        )
    return breaker


def _backoff(
    policy: CallPolicy,
    backend: str,
    op: str,
    kind: FailureKind,
    retry_number: int,
    sleep: Callable[[float], None],
    rng: Optional[random.Random],
) -> None:
    """One retry pause: metric + ``launcher.retry`` span around the sleep."""
    delay = policy.backoff_delay(retry_number, rng=rng)
    obs_metrics.CONTROL_PLANE_RETRIES.inc(
        backend=backend, op=op, kind=kind.value
    )
    logger.info(
        "%s.%s failed (%s); retry %d/%d in %.2fs",
        backend,
        op,
        kind.value,
        retry_number,
        policy.retries_for(kind),
        delay,
    )
    with obs_trace.span(
        "launcher.retry",
        backend=backend,
        op=op,
        kind=kind.value,
        retry=retry_number,
        delay_seconds=round(delay, 3),
    ):
        sleep(delay)


def resilient_call(
    fn: Callable[[], T],
    *,
    backend: str,
    op: str,
    policy: Optional[CallPolicy] = None,
    sleep: Callable[[float], None] = time.sleep,
    rng: Optional[random.Random] = None,
) -> T:
    """Invoke ``fn`` under classification, retries, the backend breaker,
    and fault injection.

    Raised exceptions are classified; transient kinds are retried within
    ``policy``'s per-kind budget with capped jittered backoff. On budget
    exhaustion (or any permanent kind) the original exception propagates
    unchanged — callers' existing ``except`` clauses (SDK NotFound
    handling etc.) are preserved. A permanent failure still proves the
    backend reachable, so it records breaker *success*."""
    policy = policy or DEFAULT_POLICY
    breaker = _check_breaker(backend, op)
    injector = faults.active_injector()
    retries_used: dict[FailureKind, int] = {}
    while True:
        before = breaker.state
        try:
            rule = injector.check(backend, op) if injector else None
            result: Any = (
                injector.fire(rule, backend, op)  # type: ignore[union-attr]
                if rule is not None
                else fn()
            )
        except Exception as exc:  # noqa: BLE001 - classified below
            kind = classify_exception(exc)
            if not is_transient(kind):
                breaker.record_success()
                _note_breaker_transition(breaker, backend, before)
                obs_metrics.CONTROL_PLANE_CALLS.inc(
                    backend=backend, op=op, status="error"
                )
                raise
            breaker.record_failure()
            _note_breaker_transition(breaker, backend, before)
            used = retries_used.get(kind, 0)
            if used >= policy.retries_for(kind):
                obs_metrics.CONTROL_PLANE_CALLS.inc(
                    backend=backend, op=op, status="error"
                )
                raise
            retries_used[kind] = used + 1
            _backoff(policy, backend, op, kind, used + 1, sleep, rng)
            continue
        breaker.record_success()
        _note_breaker_transition(breaker, backend, before)
        obs_metrics.CONTROL_PLANE_CALLS.inc(backend=backend, op=op, status="ok")
        return result


def resilient_cmd(
    run: Callable[..., subprocess.CompletedProcess],
    cmd: list[str],
    *,
    backend: str,
    op: str,
    policy: Optional[CallPolicy] = None,
    sleep: Callable[[float], None] = time.sleep,
    rng: Optional[random.Random] = None,
    **kwargs: Any,
) -> subprocess.CompletedProcess:
    """Run one control-plane subprocess through the resilient seam.

    ``run`` is the backend's raw ``_run_cmd`` (kept as the monkeypatchable
    test seam). The per-call deadline defaults to
    :func:`control_plane_timeout` unless the caller or policy supplies
    one. Non-zero exits classify by stderr; transient classes retry within
    budget, then the last failing ``CompletedProcess`` is *returned* so
    existing ``returncode != 0`` handling applies. A hung call raises
    ``subprocess.TimeoutExpired`` inside, retries, and finally returns a
    synthesized ``CompletedProcess`` with returncode
    :data:`TIMEOUT_RETURNCODE` — a deadline must degrade like any other
    failed call, not crash a poll loop that predates deadlines."""
    policy = policy or DEFAULT_POLICY
    if "timeout" not in kwargs:
        deadline = (
            policy.timeout if policy.timeout is not None else control_plane_timeout()
        )
        if deadline is not None:
            kwargs["timeout"] = deadline
    breaker = _check_breaker(backend, op)
    injector = faults.active_injector()
    retries_used: dict[FailureKind, int] = {}
    while True:
        before = breaker.state
        failure: Optional[FailureKind] = None
        proc: Optional[subprocess.CompletedProcess] = None
        try:
            rule = injector.check(backend, op) if injector else None
            if rule is not None:
                payload = injector.fire(rule, backend, op)  # may raise
                proc = subprocess.CompletedProcess(
                    args=cmd, returncode=0, stdout=payload, stderr=""
                )
            else:
                proc = run(cmd, **kwargs)
            failure = classify_proc(proc)
        except subprocess.TimeoutExpired as exc:
            failure = FailureKind.TIMEOUT
            proc = subprocess.CompletedProcess(
                args=cmd,
                returncode=TIMEOUT_RETURNCODE,
                stdout="",
                stderr=(
                    f"{backend} {op} timed out after {exc.timeout}s"
                    f" (control-plane deadline; raise"
                    f" ${settings.ENV_TPX_CONTROL_PLANE_TIMEOUT} if the"
                    f" call is legitimately slow)"
                ),
            )
        except Exception as exc:  # noqa: BLE001 - injected / transport errors
            kind = classify_exception(exc)
            if not is_transient(kind):
                breaker.record_success()
                _note_breaker_transition(breaker, backend, before)
                obs_metrics.CONTROL_PLANE_CALLS.inc(
                    backend=backend, op=op, status="error"
                )
                raise
            breaker.record_failure()
            _note_breaker_transition(breaker, backend, before)
            used = retries_used.get(kind, 0)
            if used >= policy.retries_for(kind):
                obs_metrics.CONTROL_PLANE_CALLS.inc(
                    backend=backend, op=op, status="error"
                )
                raise
            retries_used[kind] = used + 1
            _backoff(policy, backend, op, kind, used + 1, sleep, rng)
            continue

        if failure is None:
            breaker.record_success()
            _note_breaker_transition(breaker, backend, before)
            obs_metrics.CONTROL_PLANE_CALLS.inc(
                backend=backend, op=op, status="ok"
            )
            return proc
        if not is_transient(failure):
            # deterministic failure, but the control plane answered:
            # reachability-wise that is a breaker success
            breaker.record_success()
            _note_breaker_transition(breaker, backend, before)
            obs_metrics.CONTROL_PLANE_CALLS.inc(
                backend=backend, op=op, status="error"
            )
            return proc
        breaker.record_failure()
        _note_breaker_transition(breaker, backend, before)
        used = retries_used.get(failure, 0)
        if used >= policy.retries_for(failure):
            obs_metrics.CONTROL_PLANE_CALLS.inc(
                backend=backend, op=op, status="error"
            )
            return proc
        retries_used[failure] = used + 1
        _backoff(policy, backend, op, failure, used + 1, sleep, rng)
