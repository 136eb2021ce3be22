"""Telemetry: every Runner API call is wrapped in :func:`log_event`.

Port of :mod:`torchx_tpu.runner.events` (reference analog:
torchx/runner/events/__init__.py:79-175). Events go to a non-propagating
logger named ``torchx_tpu_torch.events`` whose destination is pluggable via
$TPX_EVENT_DESTINATION (default: "null" — drop; "console" — stderr; "log"
— normal logging; "jsonl"/"prom" — the durable obs sinks). Organizations
point this at their telemetry pipeline with a logging handler.

Spans travel on the port's span logger (``torchx_tpu_torch.obs.spans``).
When the events logger is first made, the session's JSONL sink is attached
to both, so that events and the runner's spans persist together in
``~/.torchx_tpu/obs/<session>/trace.jsonl`` whatever the destination
(tracing on, ``$TPX_TRACE`` default). ``log_event`` opens a
``runner.<api>`` span around each call, which is how the whole Runner
surface shows up in a trace without per-method instrumentation.
"""

from __future__ import annotations

import logging
import os
import time
import traceback
from types import TracebackType
from typing import Optional, Type

from torchx_tpu_torch import settings
from torchx_tpu_torch.runner.events.api import TpxEvent
from torchx_tpu_torch.util.times import epoch_usec, stamp_event

_events_logger: Optional[logging.Logger] = None


def get_events_logger(destination: Optional[str] = None) -> logging.Logger:
    """The process-wide telemetry logger (non-propagating; destination
    from ``TPX_EVENT_DESTINATION``, default "null"). The durable JSONL
    trace sink rides alongside the chosen destination, and on the span
    logger; it checks ``$TPX_TRACE`` per record, so attaching it
    unconditionally costs nothing when tracing is off."""
    global _events_logger
    if _events_logger is None:
        from torchx_tpu_torch.obs.sinks import JsonlTraceHandler, attach_trace_sink
        from torchx_tpu_torch.runner.events.handlers import get_destination_handler

        dest = destination or os.environ.get(
            settings.ENV_TPX_EVENT_DESTINATION, "null"
        )
        logger = logging.getLogger("torchx_tpu_torch.events")
        logger.setLevel(logging.INFO)
        logger.propagate = False  # never leak telemetry into app logs
        logger.addHandler(get_destination_handler(dest))
        if dest != "jsonl":  # don't write the trace file twice
            logger.addHandler(JsonlTraceHandler())
        attach_trace_sink()
        _events_logger = logger
    return _events_logger


def record(event: TpxEvent) -> None:
    """Emit one serialized :class:`TpxEvent` to the events logger,
    stamping any unset time fields (:func:`~torchx_tpu_torch.util.times.stamp_event`)
    and the current trace/span correlation ids at emit time."""
    stamp_event(event)
    if event.trace_id is None or event.span_id is None:
        from torchx_tpu_torch.obs import trace as obs_trace

        if event.trace_id is None:
            event.trace_id = obs_trace.current_trace_id()
        if event.span_id is None:
            event.span_id = obs_trace.current_span_id()
    get_events_logger().info(event.serialize())


class log_event:
    """Context manager measuring cpu/wall time and capturing exceptions for
    one Runner API call. Also opens a ``runner.<api>`` span for the call's
    duration (sharing the event's timing and trace correlation) and feeds
    the API latency/call metrics."""

    def __init__(
        self,
        api: str,
        scheduler: str = "",
        app_id: Optional[str] = None,
        app_image: Optional[str] = None,
        runcfg: Optional[str] = None,
        session: str = "",
    ) -> None:
        self._event = TpxEvent(
            session=session,
            scheduler=scheduler,
            api=api,
            app_id=app_id,
            app_image=app_image,
            runcfg=runcfg,
        )

    def __enter__(self) -> "log_event":
        from torchx_tpu_torch.obs import trace as obs_trace

        self._start_cpu = time.process_time_ns()
        self._start_wall = time.perf_counter_ns()
        self._event.start_epoch_time_usec = epoch_usec()
        self._span, self._token = obs_trace.start_span(
            f"runner.{self._event.api}",
            session=self._event.session,
            scheduler=self._event.scheduler or None,
            app_id=self._event.app_id,
        )
        if self._span is not None:
            self._event.trace_id = self._span.trace_id
            self._event.span_id = self._span.span_id
        return self

    def __exit__(
        self,
        exc_type: Optional[Type[BaseException]],
        exc: Optional[BaseException],
        tb: Optional[TracebackType],
    ) -> bool:
        from torchx_tpu_torch.obs import metrics as obs_metrics
        from torchx_tpu_torch.obs import trace as obs_trace

        self._event.cpu_time_usec = (time.process_time_ns() - self._start_cpu) // 1000
        self._event.wall_time_usec = (time.perf_counter_ns() - self._start_wall) // 1000
        if exc is not None:
            self._event.raw_exception = "".join(
                traceback.format_exception(exc_type, exc, tb)
            )
            self._event.exception_type = exc_type.__name__ if exc_type else None
            if tb is not None:
                frame = traceback.extract_tb(tb)[-1]
                self._event.exception_source_location = (
                    f"{frame.filename}:{frame.lineno}:{frame.name}"
                )
        wall_s = self._event.wall_time_usec / 1e6
        obs_metrics.API_LATENCY.observe(
            wall_s, api=self._event.api, scheduler=self._event.scheduler
        )
        obs_metrics.API_CALLS.inc(
            api=self._event.api,
            scheduler=self._event.scheduler,
            status="error" if exc is not None else "ok",
        )
        if self._span is not None:
            # the call may have learned the app id mid-flight (schedule)
            if self._event.app_id:
                self._span.attrs["app_id"] = self._event.app_id
        obs_trace.end_span(self._span, self._token, exc=exc)
        record(self._event)
        return False
