"""Durable observability sinks: the session's trace file and metrics
textfile.

Port of :mod:`torchx_tpu.obs.sinks`. Everything lands under one session
directory, ``~/.torchx_tpu/obs/<session>/`` (the root overridden by
``$TPX_OBS_DIR``):

* ``trace.jsonl`` — every span the session emitted, one JSON object per
  line, appended by every participating process: the client and the
  replicas it launched share the session through
  ``$TPX_INTERNAL_SESSION_ID``, so ``tpx trace`` and the gang monitor read
  the port's spans beside the launcher's;
* ``metrics-<pid>.prom`` — each process's metrics registry in Prometheus
  text format, rewritten atomically on flush (per-pid files, so processes
  never clobber each other; textfile collectors and ``tpx trace
  --metrics`` aggregate the glob).
"""

from __future__ import annotations

import atexit
import logging
import os
import tempfile
import threading
import time
from typing import Callable, Optional

from torchx_tpu_torch import settings
from torchx_tpu_torch.obs import trace
from torchx_tpu_torch.util.session import get_session_id_or_create_new

TRACE_FILE = "trace.jsonl"
METRICS_GLOB = "metrics-*.prom"

logger = logging.getLogger(__name__)

def obs_root() -> str:
    """Root of all durable observability output:
    ``$TPX_OBS_DIR`` or ``~/.torchx_tpu/obs``."""
    return os.environ.get(settings.ENV_TPX_OBS_DIR) or os.path.join(
        os.path.expanduser("~"), ".torchx_tpu", "obs"
    )


def default_session_name() -> str:
    """The session directory's name, ``tpx_<first 8 of the session id>``:
    the name the launcher's runner gives the session its replicas share."""
    return f"tpx_{get_session_id_or_create_new()[:8]}"


def session_dir(session: Optional[str] = None) -> str:
    """Directory holding one session's trace, metrics textfiles, profile
    journal and leases."""
    return os.path.join(obs_root(), session or default_session_name())


def trace_path(session: Optional[str] = None) -> str:
    """The session's JSONL trace file path."""
    return os.path.join(session_dir(session), TRACE_FILE)


def metrics_path(session: Optional[str] = None) -> str:
    """This process's metrics textfile path within the session dir."""
    return os.path.join(session_dir(session), f"metrics-{os.getpid()}.prom")


class JsonlTraceHandler(logging.Handler):
    """Logging handler appending each record's message (an already
    serialized span) as one line to the session's ``trace.jsonl``.

    The path is resolved at every emit, so it follows changes of
    ``$TPX_OBS_DIR`` mid-process. The file stays open between records
    (one ``write`` a record: on an H100 machine's host a span cost
    0.55-1.10 ms with the file opened for each record, 0.14-0.21 ms with
    it kept open; PERF.md §6) and is opened again when the path changes
    or the file was deleted. Single-line ``O_APPEND`` writes keep
    concurrent processes' records whole. Emission is best-effort:
    telemetry never breaks its caller."""

    def __init__(self) -> None:
        super().__init__()
        self._fd: Optional[int] = None
        self._fd_path = ""

    def _file(self, path: str) -> int:
        if self._fd is not None:
            if path == self._fd_path and os.fstat(self._fd).st_nlink > 0:
                return self._fd
            os.close(self._fd)
            self._fd = None
        os.makedirs(os.path.dirname(path), exist_ok=True)
        self._fd = os.open(path, os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o666)
        self._fd_path = path
        return self._fd

    def emit(self, record: logging.LogRecord) -> None:
        if not trace.tracing_enabled():
            return
        try:
            line = record.getMessage().rstrip("\n") + "\n"
            os.write(self._file(trace_path()), line.encode())
        except Exception:  # noqa: BLE001 - never break the caller
            self.handleError(record)

    def close(self) -> None:
        with self.lock:
            if self._fd is not None:
                os.close(self._fd)
                self._fd = None
        super().close()


def attach_trace_sink() -> None:
    """Send the port's completed spans to the session's ``trace.jsonl``
    (idempotent)."""
    if not any(isinstance(h, JsonlTraceHandler) for h in trace.SPAN_LOGGER.handlers):
        trace.SPAN_LOGGER.addHandler(JsonlTraceHandler())
        trace.SPAN_LOGGER.setLevel(logging.INFO)


def metrics_min_interval_s() -> float:
    """Least seconds between two debounced textfile flushes:
    ``$TPX_METRICS_MIN_INTERVAL``, else the default (2 s)."""
    raw = os.environ.get(settings.ENV_TPX_METRICS_MIN_INTERVAL, "")
    try:
        return float(raw) if raw else settings.DEFAULT_METRICS_MIN_INTERVAL
    except ValueError:
        return settings.DEFAULT_METRICS_MIN_INTERVAL


class PromMetricsHandler(logging.Handler):
    """Logging handler keeping the metrics textfile current.

    Flushes are debounced: re-rendering the whole registry per event is
    O(metrics) disk work, and a burst can emit hundreds of events in a
    second. The first event of a quiet period flushes at once; later
    events inside ``min_interval_s`` (``$TPX_METRICS_MIN_INTERVAL``,
    default 2 s) only mark the registry dirty, and the next emit past the
    interval, or :meth:`flush` / :meth:`close` (which ``logging`` calls at
    shutdown), writes the final state. Nothing is lost: the textfile is a
    snapshot of the whole registry, so one deferred write covers every
    skipped one."""

    def __init__(
        self,
        min_interval_s: Optional[float] = None,
        clock: Optional[Callable[[], float]] = None,
    ) -> None:
        super().__init__()
        self._clock = clock if clock is not None else time.monotonic
        self.min_interval_s = (
            metrics_min_interval_s()
            if min_interval_s is None
            else float(min_interval_s)
        )
        self._lock_flush = threading.Lock()
        self._last_flush = -float("inf")  # monotonic stamp of the last write
        self._dirty = False

    def emit(self, record: logging.LogRecord) -> None:
        try:
            with self._lock_flush:
                now = self._clock()
                if now - self._last_flush < self.min_interval_s:
                    self._dirty = True
                    return
                self._last_flush = now
                self._dirty = False
            flush_metrics()
        except Exception:  # noqa: BLE001
            self.handleError(record)

    def flush(self) -> None:
        """Write any debounce-deferred state now."""
        with self._lock_flush:
            if not self._dirty:
                return
            self._dirty = False
            self._last_flush = self._clock()
        try:
            flush_metrics()
        except Exception:  # noqa: BLE001 - never break shutdown
            pass

    def close(self) -> None:
        self.flush()
        super().close()


#: the operator-facing name of the textfile flusher
MetricsFlushHandler = PromMetricsHandler


class _RootSpanFlush:
    """The textfile flush a root span's end asks for, debounced as
    :class:`PromMetricsHandler`'s (:func:`metrics_min_interval_s`). The
    first request of a quiet period for a textfile writes it at once;
    later requests inside the interval only arm one timer, which writes
    the registry at the interval's end, so the file is never older than
    the interval; a timer still armed at exit writes before the process
    ends. A serving process ends a root span for every prefill group and
    every request, each on the way to a client's tokens: written at each
    one, the flush cost a root span 1.5-2.7 ms on an H100 machine's host
    (PERF.md §6). The records are the JAX package's; only when the file
    is written differs."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._last_path = ""
        self._last = -float("inf")  # monotonic stamp of the last write
        self._timer: Optional[threading.Timer] = None
        atexit.register(self._at_exit)

    def __call__(self) -> None:
        path = metrics_path()
        with self._lock:
            now = time.monotonic()
            wait = self._last + metrics_min_interval_s() - now
            if path == self._last_path and wait > 0:
                if self._timer is None:
                    self._timer = threading.Timer(wait, self._trailing, (path,))
                    self._timer.daemon = True
                    self._timer.start()
                return
            self._last_path, self._last = path, now
        _write_metrics(path)

    def _trailing(self, path: str) -> None:
        with self._lock:
            self._timer = None
            if path == self._last_path:
                self._last = time.monotonic()
        _write_metrics(path)

    def _at_exit(self) -> None:
        with self._lock:
            timer, self._timer = self._timer, None
        if timer is not None:
            timer.cancel()
            _write_metrics(*timer.args)


#: the process's root-span flush (:func:`torchx_tpu_torch.obs.trace.record_span`)
flush_metrics_after_root_span = _RootSpanFlush()


def flush_metrics(session: Optional[str] = None) -> Optional[str]:
    """Atomically write this process's metrics registry to its ``.prom``
    textfile (a temporary file, then ``os.replace``, so a reader never
    sees half a file). No-op with tracing disabled. -> the path written,
    or None."""
    return _write_metrics(metrics_path(session))


def _write_metrics(path: str) -> Optional[str]:
    if not trace.tracing_enabled():
        return None
    from torchx_tpu_torch.obs.metrics import REGISTRY

    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), prefix=".metrics_")
        try:
            with os.fdopen(fd, "w") as f:
                f.write(REGISTRY.render())
            os.replace(tmp, path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
    except OSError as e:
        logger.debug("could not flush metrics to %s: %s", path, e)
        return None
    return path
