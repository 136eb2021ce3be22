"""Failure taxonomy for the launcher <-> control-plane edge.

Every remote backend talks to its control plane through fallible channels
(gcloud/kubectl subprocesses, HTTP SDKs). Failures split into two classes
with opposite correct reactions:

* **transient** — 429s, quota exhaustion, deadline overruns, connection
  resets, 5xx: the call may well succeed if repeated, so the resilient
  seam retries it under a :class:`~torchx_tpu_torch.resilience.policy.CallPolicy`;
* **permanent** — auth errors, malformed requests, missing resources:
  deterministic, retrying burns time and quota, fail immediately.

The classifier maps the three observable shapes of a failed control-plane
call — a subprocess timeout, a non-zero exit with stderr text, a raised
SDK exception — onto one :class:`FailureKind`, and :func:`is_transient`
decides which side of the line each kind falls on. Patterns follow the
wording gcloud / kubectl / googleapis actually emit (``RESOURCE_EXHAUSTED``,
``Quota exceeded``, ``DEADLINE_EXCEEDED``, ``connection reset by peer``).
"""

from __future__ import annotations

import enum
import re
import subprocess
from typing import Optional


class FailureKind(enum.Enum):
    """What went wrong with one control-plane call (the classifier's
    output and the retry-budget key of
    :class:`~torchx_tpu_torch.resilience.policy.CallPolicy`)."""

    #: the call overran its deadline (subprocess timeout, DEADLINE_EXCEEDED).
    TIMEOUT = "TIMEOUT"
    #: the control plane throttled us (429 / too many requests).
    RATE_LIMIT = "RATE_LIMIT"
    #: quota / RESOURCE_EXHAUSTED — capacity may free up.
    QUOTA = "QUOTA"
    #: 5xx / "service unavailable" / "internal error" — their side, not ours.
    UNAVAILABLE = "UNAVAILABLE"
    #: transport-level failure (connection reset/refused, broken pipe, DNS).
    CONNECTION = "CONNECTION"
    #: authentication / authorization failure — deterministic until fixed.
    AUTH = "AUTH"
    #: the named resource does not exist — retrying cannot create it.
    NOT_FOUND = "NOT_FOUND"
    #: the request itself is malformed — a launcher bug, never retried.
    INVALID = "INVALID"
    #: unrecognized failure; classified permanent so unknown errors
    #: surface immediately instead of burning a retry budget.
    UNKNOWN = "UNKNOWN"


#: kinds the resilient seam may retry.
TRANSIENT_KINDS = frozenset(
    {
        FailureKind.TIMEOUT,
        FailureKind.RATE_LIMIT,
        FailureKind.QUOTA,
        FailureKind.UNAVAILABLE,
        FailureKind.CONNECTION,
    }
)


def is_transient(kind: FailureKind) -> bool:
    """True when ``kind`` is worth retrying (see :data:`TRANSIENT_KINDS`)."""
    return kind in TRANSIENT_KINDS


class SchedulerCallError(RuntimeError):
    """Base of the taxonomy: one failed control-plane call, annotated with
    the backend, the logical operation, and the classified kind."""

    def __init__(
        self,
        message: str,
        *,
        kind: FailureKind = FailureKind.UNKNOWN,
        backend: str = "",
        op: str = "",
    ) -> None:
        super().__init__(message)
        self.kind = kind
        self.backend = backend
        self.op = op


class TransientSchedulerError(SchedulerCallError):
    """A control-plane failure that may succeed if repeated (throttling,
    quota, deadline, connection loss). The resilient seam retries these
    within budget; :meth:`~torchx_tpu_torch.runner.api.Runner.wait` absorbs them
    up to its poll-miss budget instead of aborting a supervised run."""


class PermanentSchedulerError(SchedulerCallError):
    """A deterministic control-plane failure (auth, malformed request,
    missing resource). Never retried."""


class BreakerOpenError(TransientSchedulerError):
    """Raised without attempting the call when the backend's circuit
    breaker is open (the backend failed too many consecutive times and is
    cooling down). Transient by definition (kind defaults to UNAVAILABLE):
    the breaker re-probes after its cool-down."""

    def __init__(
        self,
        message: str,
        *,
        kind: FailureKind = FailureKind.UNAVAILABLE,
        backend: str = "",
        op: str = "",
    ) -> None:
        super().__init__(message, kind=kind, backend=backend, op=op)


# -- stderr / message pattern table ---------------------------------------
# Ordered: the first matching pattern wins, so throttling text that also
# mentions a 403 ("rate limit exceeded for project") classifies RATE_LIMIT
# (transient), not AUTH.
_PATTERNS: tuple[tuple[FailureKind, "re.Pattern[str]"], ...] = (
    (
        FailureKind.RATE_LIMIT,
        re.compile(r"\b429\b|too many requests|rate.?limit", re.I),
    ),
    (
        FailureKind.QUOTA,
        re.compile(r"resource.?exhausted|quota", re.I),
    ),
    (
        FailureKind.TIMEOUT,
        re.compile(r"deadline.?exceeded|timed?.?out", re.I),
    ),
    (
        FailureKind.CONNECTION,
        re.compile(
            r"connection (reset|refused|aborted|closed)|broken pipe"
            r"|network is unreachable|remote end closed|name resolution"
            r"|temporary failure in name",
            re.I,
        ),
    ),
    (
        FailureKind.UNAVAILABLE,
        re.compile(
            r"\b50[023]\b|unavailable|internal error|backend error"
            r"|server error|try again later",
            re.I,
        ),
    ),
    (
        FailureKind.AUTH,
        re.compile(
            r"\b40[13]\b|permission denied|unauthenticated|unauthorized"
            r"|forbidden|credential",
            re.I,
        ),
    ),
    (
        FailureKind.NOT_FOUND,
        re.compile(r"\b404\b|not.?found|does not exist|no such", re.I),
    ),
    (
        FailureKind.INVALID,
        re.compile(r"\b400\b|invalid.?argument|bad request|malformed", re.I),
    ),
)


def classify_text(text: str) -> FailureKind:
    """Classify an error message (typically gcloud/kubectl stderr) by the
    pattern table; :data:`FailureKind.UNKNOWN` when nothing matches."""
    for kind, pattern in _PATTERNS:
        if pattern.search(text or ""):
            return kind
    return FailureKind.UNKNOWN


def classify_proc(proc: subprocess.CompletedProcess) -> Optional[FailureKind]:
    """Classify a finished subprocess: None for success (returncode 0),
    otherwise the kind derived from its stderr (falling back to stdout —
    some gcloud verbs print errors there)."""
    if proc.returncode == 0:
        return None
    text = (getattr(proc, "stderr", "") or "") + "\n" + (
        getattr(proc, "stdout", "") or ""
    )
    return classify_text(text)


# HTTP status -> kind, for SDK exceptions that carry one (kubernetes
# ApiException.status, google.api_core errors' .code).
_STATUS_KINDS = {
    408: FailureKind.TIMEOUT,
    429: FailureKind.RATE_LIMIT,
    500: FailureKind.UNAVAILABLE,
    502: FailureKind.UNAVAILABLE,
    503: FailureKind.UNAVAILABLE,
    504: FailureKind.TIMEOUT,
    401: FailureKind.AUTH,
    403: FailureKind.AUTH,
    404: FailureKind.NOT_FOUND,
    400: FailureKind.INVALID,
}

# Exception type names -> kind, so google/kubernetes/docker errors classify
# without importing their (optional) packages.
_TYPENAME_KINDS = {
    "DeadlineExceeded": FailureKind.TIMEOUT,
    "GatewayTimeout": FailureKind.TIMEOUT,
    "TooManyRequests": FailureKind.RATE_LIMIT,
    "ResourceExhausted": FailureKind.QUOTA,
    "ServiceUnavailable": FailureKind.UNAVAILABLE,
    "InternalServerError": FailureKind.UNAVAILABLE,
    "ServerError": FailureKind.UNAVAILABLE,
    "RetryError": FailureKind.UNAVAILABLE,
    "Unauthenticated": FailureKind.AUTH,
    "Unauthorized": FailureKind.AUTH,
    "PermissionDenied": FailureKind.AUTH,
    "Forbidden": FailureKind.AUTH,
    "NotFound": FailureKind.NOT_FOUND,
    "InvalidArgument": FailureKind.INVALID,
    "BadRequest": FailureKind.INVALID,
}


def classify_exception(exc: BaseException) -> FailureKind:
    """Classify a raised exception from any control-plane channel.

    Resolution order: the taxonomy's own errors carry their kind;
    ``subprocess.TimeoutExpired`` and stdlib connection errors classify
    structurally; SDK exceptions classify by HTTP status attribute
    (``status``/``code``) then by type name (no optional imports needed);
    anything else falls back to the stderr pattern table over ``str(exc)``.
    """
    if isinstance(exc, SchedulerCallError):
        return exc.kind
    if isinstance(exc, subprocess.TimeoutExpired):
        return FailureKind.TIMEOUT
    if isinstance(exc, (ConnectionError, TimeoutError)):
        return (
            FailureKind.TIMEOUT
            if isinstance(exc, TimeoutError)
            else FailureKind.CONNECTION
        )
    for attr in ("status", "code"):
        value = getattr(exc, attr, None)
        if isinstance(value, int) and value in _STATUS_KINDS:
            return _STATUS_KINDS[value]
    for cls in type(exc).__mro__:
        kind = _TYPENAME_KINDS.get(cls.__name__)
        if kind is not None:
            return kind
    return classify_text(str(exc))
