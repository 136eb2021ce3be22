"""Spans for the serving and launch paths.

Port of :mod:`torchx_tpu.obs.trace`: :func:`span` times a block as one
:class:`Span` (:func:`start_span` / :func:`end_span` where a ``with``
block cannot nest), :func:`heartbeat` emits a zero-duration marker,
:func:`inject_env` hands the current context to a job's environment at
submit, :func:`inject_headers` to an HTTP hop (router -> replica), and
:func:`trace_context` / :func:`extract_headers` adopt a trace context that
arrived over HTTP headers or in a KV payload. Spans carrying one
``trace_id`` form a trace; ``parent_span_id`` links them into a tree. A
``contextvars.ContextVar`` holds the active span, so nested spans parent
themselves; a process whose environment carries ``$TPX_TRACE_ID`` /
``$TPX_PARENT_SPAN`` joins that trace at its root.

Completed spans (:func:`record_span`) are written as JSON lines, at INFO,
to the logger ``torchx_tpu_torch.obs.spans``, which does not propagate; the
first span made attaches the session's ``trace.jsonl`` sink to it (through
the events logger, as the JAX package's spans ride its events pipeline).
The field names are the JAX package's, so each package reads the other's
traces. ``$TPX_TRACE=0`` turns tracing off.
"""

from __future__ import annotations

import contextvars
import json
import logging
import os
import uuid
from contextlib import contextmanager
from dataclasses import asdict, dataclass, field, fields
from typing import Any, Iterator, Optional

from torchx_tpu_torch.settings import ENV_TPX_PARENT_SPAN, ENV_TPX_TRACE, ENV_TPX_TRACE_ID
from torchx_tpu_torch.util.times import epoch_usec

#: record-discriminator value in the JSONL stream ("kind" key).
SPAN_KIND = "span"

#: HTTP headers carrying trace context across service hops.
HDR_TRACE_ID = "X-Tpx-Trace-Id"
HDR_PARENT_SPAN = "X-Tpx-Parent-Span"

SPAN_LOGGER = logging.getLogger("torchx_tpu_torch.obs.spans")
SPAN_LOGGER.propagate = False
SPAN_LOGGER.addHandler(logging.NullHandler())

_CURRENT: contextvars.ContextVar[Optional["Span"]] = contextvars.ContextVar(
    "tpx_torch_current_span", default=None
)


def tracing_enabled() -> bool:
    """True unless ``$TPX_TRACE`` is 0/false/off (read at every emit)."""
    return os.environ.get(ENV_TPX_TRACE, "1").lower() not in ("0", "false", "off")


def new_trace_id() -> str:
    """A fresh 32-hex-char trace id."""
    return uuid.uuid4().hex


def new_span_id() -> str:
    """A fresh 16-hex-char span id."""
    return uuid.uuid4().hex[:16]


@dataclass
class Span:
    """One timed, attributed operation within a trace (epoch
    microseconds; ``status`` "OK" or "ERROR"; small JSON-safe ``attrs``)."""

    name: str
    trace_id: str
    span_id: str
    parent_span_id: Optional[str] = None
    start_epoch_usec: int = 0
    end_epoch_usec: Optional[int] = None
    attrs: dict[str, Any] = field(default_factory=dict)
    status: str = "OK"
    session: str = ""

    def duration_usec(self) -> Optional[int]:
        """Span duration in microseconds, or None while still open."""
        if self.end_epoch_usec is None:
            return None
        return self.end_epoch_usec - self.start_epoch_usec

    def serialize(self) -> str:
        """One JSON line, discriminated by ``"kind": "span"``."""
        return json.dumps({"kind": SPAN_KIND, **asdict(self)}, default=str)

    @staticmethod
    def deserialize(data: str) -> "Span":
        """Inverse of :meth:`serialize`; unknown fields are dropped, so an
        older reader survives a newer writer."""
        obj = json.loads(data)
        known = {f.name for f in fields(Span)}
        return Span(**{k: v for k, v in obj.items() if k in known})


def current_span() -> Optional[Span]:
    """The active span in this context, or None."""
    return _CURRENT.get()


def current_trace_id() -> Optional[str]:
    """Trace id of the active span, else the inherited ``$TPX_TRACE_ID``."""
    span_ = _CURRENT.get()
    if span_ is not None:
        return span_.trace_id
    return os.environ.get(ENV_TPX_TRACE_ID) or None


def current_span_id() -> Optional[str]:
    """Span id of the active span, else ``$TPX_PARENT_SPAN``."""
    span_ = _CURRENT.get()
    if span_ is not None:
        return span_.span_id
    return os.environ.get(ENV_TPX_PARENT_SPAN) or None


def inject_env(env: dict[str, str], force: bool = False) -> None:
    """Write the current trace context into a job's environment (the
    submit-time hook: ``Runner.dryrun`` calls it on every role). The trace
    id is kept where the environment has one already, unless ``force``; the
    parent span is always refreshed. No-op with tracing off."""
    if not tracing_enabled():
        return
    trace_id, span_id = current_trace_id(), current_span_id()
    if trace_id:
        if force:
            env[ENV_TPX_TRACE_ID] = trace_id
        else:
            env.setdefault(ENV_TPX_TRACE_ID, trace_id)
    if span_id:
        env[ENV_TPX_PARENT_SPAN] = span_id


def start_span(name: str, session: str = "", **attrs: Any) -> tuple[Optional[Span], Any]:
    """Open a span and make it current; -> ``(span, token)`` for
    :func:`end_span`, ``(None, None)`` with tracing off. For instrumentation
    that cannot nest a ``with`` block (``runner.events.log_event``);
    prefer :func:`span`."""
    if not tracing_enabled():
        return None, None
    parent = _CURRENT.get()
    if parent is not None:
        trace_id, parent_id = parent.trace_id, parent.span_id or None
    else:
        trace_id = os.environ.get(ENV_TPX_TRACE_ID) or new_trace_id()
        parent_id = os.environ.get(ENV_TPX_PARENT_SPAN) or None
    sp = Span(
        name=name,
        trace_id=trace_id,
        span_id=new_span_id(),
        parent_span_id=parent_id,
        start_epoch_usec=epoch_usec(),
        attrs={k: v for k, v in attrs.items() if v is not None},
        session=session,
    )
    return sp, _CURRENT.set(sp)


def end_span(span_: Optional[Span], token: Any, exc: Optional[BaseException] = None) -> None:
    """Close a span of :func:`start_span`: restore the previous context,
    stamp the end, mark ERROR on ``exc``, and emit it."""
    if span_ is None:
        return
    _CURRENT.reset(token)
    span_.end_epoch_usec = epoch_usec()
    if exc is not None:
        span_.status = "ERROR"
        span_.attrs.setdefault("exception", f"{type(exc).__name__}: {exc}")
    record_span(span_)


@contextmanager
def span(name: str, session: str = "", **attrs: Any) -> Iterator[Optional[Span]]:
    """Time a block as one span, parented on the current context (or the
    inherited environment context at the root), tagged with the launcher
    ``session`` that opened it. Yields the open span, or None when tracing
    is off; marked ERROR if the block raises."""
    sp, token = start_span(name, session=session, **attrs)
    try:
        yield sp
    except BaseException as e:
        end_span(sp, token, exc=e)
        raise
    else:
        end_span(sp, token)


@contextmanager
def trace_context(
    trace_id: Optional[str], parent_span_id: Optional[str] = None
) -> Iterator[None]:
    """Adopt a remote trace context for the duration of a block: spans
    opened inside join ``trace_id`` under ``parent_span_id``. No-op when
    ``trace_id`` is falsy or tracing is off."""
    if not trace_id or not tracing_enabled():
        yield
        return
    anchor = Span(name="", trace_id=trace_id, span_id=parent_span_id or "")
    token = _CURRENT.set(anchor)
    try:
        yield
    finally:
        _CURRENT.reset(token)


def inject_headers(headers: dict[str, str]) -> dict[str, str]:
    """Stamp the current trace context into an HTTP header dict (the
    send-side twin of :func:`inject_env` for service hops). -> the dict,
    untouched with no context or tracing off."""
    if not tracing_enabled():
        return headers
    trace_id, span_id = current_trace_id(), current_span_id()
    if trace_id:
        headers[HDR_TRACE_ID] = trace_id
    if span_id:
        headers[HDR_PARENT_SPAN] = span_id
    return headers


def extract_headers(headers: Any) -> tuple[Optional[str], Optional[str]]:
    """``(trace_id, parent_span_id)`` from request headers (any mapping
    with ``.get``), ``(None, None)`` when absent."""
    return headers.get(HDR_TRACE_ID) or None, headers.get(HDR_PARENT_SPAN) or None


def heartbeat(name: str, session: str = "", **attrs: Any) -> Optional[Span]:
    """Emit an instantaneous (zero-duration) span: a progress marker. Also
    flushes the metrics textfile, so the marker and its metrics land
    together."""
    if not tracing_enabled():
        return None
    with span(name, session=session, **attrs) as sp:
        pass
    from torchx_tpu_torch.obs import sinks

    sinks.flush_metrics()
    return sp


def record_span(span_: Span) -> None:
    """Emit one completed span on the span logger, the session's
    ``trace.jsonl`` sink attached first (once, by the events logger). A
    root span's completion also asks for a flush of the session's metrics
    textfile, so a finished top-level operation leaves its metrics behind:
    at once in a quiet period, else within ``$TPX_METRICS_MIN_INTERVAL``
    (:data:`~torchx_tpu_torch.obs.sinks.flush_metrics_after_root_span`)."""
    if not tracing_enabled():
        return
    from torchx_tpu_torch.runner.events import get_events_logger

    get_events_logger()
    SPAN_LOGGER.info(span_.serialize())
    if span_.parent_span_id is None:
        from torchx_tpu_torch.obs import sinks

        sinks.flush_metrics_after_root_span()
