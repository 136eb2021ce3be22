"""Spans for the serving path.

The port's copy of what the engine and the server use of
:mod:`torchx_tpu.obs.trace`: :func:`span` times a block as one
:class:`Span`, :func:`heartbeat` emits a zero-duration marker, and
:func:`trace_context` / :func:`extract_headers` adopt a trace context that
arrived over HTTP headers or in a KV payload. Spans carrying one
``trace_id`` form a trace; ``parent_span_id`` links them into a tree. A
``contextvars.ContextVar`` holds the active span, so nested spans parent
themselves; a process whose environment carries ``$TPX_TRACE_ID`` /
``$TPX_PARENT_SPAN`` joins that trace at its root.

Completed spans are written as JSON lines, at INFO, to the logger
``torchx_tpu_torch.obs.spans``, which does not propagate: attach a handler
to keep them. ``$TPX_TRACE=0`` turns tracing off.
"""

from __future__ import annotations

import contextvars
import json
import logging
import os
import time
import uuid
from contextlib import contextmanager
from dataclasses import asdict, dataclass, field
from typing import Any, Iterator, Optional

#: The JAX package's environment names (its ``settings``), copied.
ENV_TPX_TRACE = "TPX_TRACE"
ENV_TPX_TRACE_ID = "TPX_TRACE_ID"
ENV_TPX_PARENT_SPAN = "TPX_PARENT_SPAN"

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


def epoch_usec() -> int:
    """Current wall time in integer epoch microseconds."""
    return int(time.time() * 1e6)


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

    def duration_usec(self) -> Optional[int]:
        """Span duration in microseconds, or None while still open."""
        if self.end_epoch_usec is None:
            return None
        return self.end_epoch_usec - self.start_epoch_usec

    def serialize(self) -> str:
        """One JSON line, discriminated by ``"kind": "span"``."""
        return json.dumps({"kind": SPAN_KIND, **asdict(self)}, default=str)


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


@contextmanager
def span(name: str, **attrs: Any) -> Iterator[Optional[Span]]:
    """Time a block as one span, parented on the current context (or the
    inherited environment context at the root). Yields the open span, or
    None when tracing is off; marked ERROR if the block raises."""
    if not tracing_enabled():
        yield None
        return
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
    )
    token = _CURRENT.set(sp)
    try:
        yield sp
    except BaseException as e:
        sp.status = "ERROR"
        sp.attrs.setdefault("exception", f"{type(e).__name__}: {e}")
        raise
    finally:
        _CURRENT.reset(token)
        sp.end_epoch_usec = epoch_usec()
        SPAN_LOGGER.info(sp.serialize())


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


def extract_headers(headers: Any) -> tuple[Optional[str], Optional[str]]:
    """``(trace_id, parent_span_id)`` from request headers (any mapping
    with ``.get``), ``(None, None)`` when absent."""
    return headers.get(HDR_TRACE_ID) or None, headers.get(HDR_PARENT_SPAN) or None


def heartbeat(name: str, **attrs: Any) -> Optional[Span]:
    """Emit an instantaneous (zero-duration) span: a progress marker."""
    with span(name, **attrs) as sp:
        pass
    return sp
