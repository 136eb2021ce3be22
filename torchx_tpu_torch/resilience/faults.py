"""Deterministic fault injection for the resilient control-plane seam.

``TPX_FAULT_PLAN`` (inline JSON or a path to a JSON file) arms a plan of
:class:`FaultRule` entries that the seam consults before every real call
— the chaos-drill counterpart of the local scheduler's
``TPX_SIMULATE_PREEMPTION_EXIT`` knob, one layer down: where that drills
*job* failure handling, a fault plan drills *control-plane* failure
handling (retries, breakers, poll-miss budgets) without a flaky cloud.

A plan is a JSON list of rules (or ``{"rules": [...]}``)::

    [{"backend": "local", "op": "describe", "nth": 2, "times": 2,
      "mode": "transient", "message": "injected 429"}]

Rule fields: ``backend``/``op`` are fnmatch patterns against the seam's
call coordinates; ``nth`` (1-based, per matching backend+op counter)
pins the first call to fire on, ``times`` how many consecutive calls
fire (``nth`` omitted = fire on the first ``times`` matching calls);
``mode`` is one of:

* ``transient`` — raise :class:`~torchx_tpu_torch.resilience.errors.TransientSchedulerError`
  (kind UNAVAILABLE): exercises retry/backoff/poll-miss paths;
* ``permanent`` — raise :class:`~torchx_tpu_torch.resilience.errors.PermanentSchedulerError`;
* ``timeout`` — raise ``subprocess.TimeoutExpired``: exercises the
  deadline path exactly as a hung gcloud would;
* ``garbage`` — the call "succeeds" but returns garbage stdout
  (subprocess seams get a fake zero-exit ``CompletedProcess``): exercises
  downstream parse hardening.

Determinism: counters are plain per-``(backend, op)`` call counts in
process memory, so the same plan against the same call sequence always
fires on the same calls. :func:`reset` clears counters and the plan
cache (tests; the env var is re-read after a reset).
"""

from __future__ import annotations

import json
import os
import subprocess
import threading
from dataclasses import dataclass, field
from fnmatch import fnmatch
from typing import Any, Optional

from torchx_tpu_torch import settings
from torchx_tpu_torch.resilience.errors import (
    FailureKind,
    PermanentSchedulerError,
    TransientSchedulerError,
)

#: the ``mode`` values a rule may carry.
FAULT_MODES = ("transient", "permanent", "timeout", "garbage")

#: stdout payload of ``garbage`` faults — deliberately unparseable as
#: JSON/ids so downstream parsing must cope.
GARBAGE_PAYLOAD = "\x00<<injected-garbage>>\x00 not json } ]"


@dataclass
class FaultRule:
    """One entry of a fault plan (see the module docstring for semantics)."""

    #: fnmatch pattern against the backend name ("local", "gcp_batch", ...).
    backend: str = "*"
    #: fnmatch pattern against the seam op ("describe", "submit", ...).
    op: str = "*"
    #: 1-based index (per backend+op call counter) of the first call to
    #: fire on; None = fire from the first matching call.
    nth: Optional[int] = None
    #: how many consecutive matching calls fire.
    times: int = 1
    #: failure mode, one of :data:`FAULT_MODES`.
    mode: str = "transient"
    #: message carried by the injected error.
    message: str = "injected fault"

    def __post_init__(self) -> None:
        if self.mode not in FAULT_MODES:
            raise ValueError(
                f"fault mode must be one of {FAULT_MODES}, got {self.mode!r}"
            )
        if self.nth is not None and self.nth < 1:
            raise ValueError(f"nth is 1-based, got {self.nth}")
        if self.times < 1:
            raise ValueError(f"times must be >= 1, got {self.times}")

    def matches(self, backend: str, op: str, count: int) -> bool:
        """Does this rule fire on call number ``count`` (1-based) of
        ``backend``/``op``?"""
        if not fnmatch(backend, self.backend) or not fnmatch(op, self.op):
            return False
        first = self.nth if self.nth is not None else 1
        return first <= count < first + self.times


@dataclass
class FaultPlan:
    """A parsed ``TPX_FAULT_PLAN``: an ordered list of rules (first match
    wins per call)."""

    rules: list[FaultRule] = field(default_factory=list)

    @classmethod
    def parse(cls, raw: str) -> "FaultPlan":
        """Parse inline JSON, or read the file at ``raw`` when it names
        one. Raises ``ValueError`` on malformed plans — a typo'd chaos
        drill must fail loudly, not silently not inject."""
        text = raw
        if not raw.lstrip().startswith(("[", "{")) and os.path.exists(raw):
            with open(raw) as f:
                text = f.read()
        try:
            data = json.loads(text)
        except json.JSONDecodeError as e:
            raise ValueError(f"unparseable TPX_FAULT_PLAN: {e}") from e
        if isinstance(data, dict):
            data = data.get("rules", [])
        if not isinstance(data, list):
            raise ValueError("TPX_FAULT_PLAN must be a list of rules")
        rules = []
        for entry in data:
            if not isinstance(entry, dict):
                raise ValueError(f"fault rule must be an object, got {entry!r}")
            known = {f for f in FaultRule.__dataclass_fields__}
            unknown = set(entry) - known
            if unknown:
                raise ValueError(
                    f"unknown fault rule keys {sorted(unknown)};"
                    f" valid keys: {sorted(known)}"
                )
            rules.append(FaultRule(**entry))
        return cls(rules=rules)


class FaultInjector:
    """Stateful executor of one :class:`FaultPlan`: counts calls per
    ``(backend, op)`` and applies the first matching rule."""

    def __init__(self, plan: FaultPlan) -> None:
        self.plan = plan
        self._counts: dict[tuple[str, str], int] = {}
        self._lock = threading.Lock()

    def check(self, backend: str, op: str) -> Optional[FaultRule]:
        """Advance the call counter for ``backend``/``op`` and return the
        rule that fires on this call, if any."""
        with self._lock:
            key = (backend, op)
            self._counts[key] = self._counts.get(key, 0) + 1
            count = self._counts[key]
        for rule in self.plan.rules:
            if rule.matches(backend, op, count):
                return rule
        return None

    def fire(self, rule: FaultRule, backend: str, op: str) -> Any:
        """Apply one rule: raise for ``transient``/``permanent``/``timeout``
        modes, return the garbage payload for ``garbage`` (subprocess
        seams wrap it into a fake ``CompletedProcess``)."""
        msg = f"{rule.message} [fault-plan {backend}.{op}]"
        if rule.mode == "transient":
            raise TransientSchedulerError(
                msg, kind=FailureKind.UNAVAILABLE, backend=backend, op=op
            )
        if rule.mode == "permanent":
            raise PermanentSchedulerError(
                msg, kind=FailureKind.UNKNOWN, backend=backend, op=op
            )
        if rule.mode == "timeout":
            raise subprocess.TimeoutExpired(cmd=f"{backend}.{op}", timeout=0.0)
        return GARBAGE_PAYLOAD


_lock = threading.Lock()
_cached_raw: Optional[str] = None
_cached_injector: Optional[FaultInjector] = None


def active_injector() -> Optional[FaultInjector]:
    """The process-wide injector for the current ``TPX_FAULT_PLAN``, or
    None when no plan is armed. The injector (and its deterministic
    counters) persists while the env value is unchanged; changing or
    unsetting the variable swaps in a fresh one."""
    global _cached_raw, _cached_injector
    raw = os.environ.get(settings.ENV_TPX_FAULT_PLAN)
    with _lock:
        if raw != _cached_raw:
            _cached_raw = raw
            _cached_injector = (
                FaultInjector(FaultPlan.parse(raw)) if raw else None
            )
        return _cached_injector


def fault_plan_active() -> bool:
    """True when ``TPX_FAULT_PLAN`` is set and non-empty (the preflight
    analyzer's TPX502 gate against chaos-drilling real submits)."""
    return bool(os.environ.get(settings.ENV_TPX_FAULT_PLAN))


def reset() -> None:
    """Drop the cached injector and its counters (tests)."""
    global _cached_raw, _cached_injector
    with _lock:
        _cached_raw = None
        _cached_injector = None
