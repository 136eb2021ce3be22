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
    ``$TPX_OBS_DIR`` mid-process. Single-line ``O_APPEND`` writes keep
    concurrent processes' records whole. Emission is best-effort:
    telemetry never breaks its caller."""

    def emit(self, record: logging.LogRecord) -> None:
        if not trace.tracing_enabled():
            return
        try:
            path = trace_path()
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "a") as f:
                f.write(record.getMessage().rstrip("\n") + "\n")
        except Exception:  # noqa: BLE001 - never break the caller
            self.handleError(record)


def attach_trace_sink() -> None:
    """Send the port's completed spans to the session's ``trace.jsonl``
    (idempotent)."""
    if not any(isinstance(h, JsonlTraceHandler) for h in trace.SPAN_LOGGER.handlers):
        trace.SPAN_LOGGER.addHandler(JsonlTraceHandler())
        trace.SPAN_LOGGER.setLevel(logging.INFO)


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
        if min_interval_s is None:
            raw = os.environ.get(settings.ENV_TPX_METRICS_MIN_INTERVAL, "")
            try:
                min_interval_s = float(raw) if raw else None
            except ValueError:
                min_interval_s = None
        self.min_interval_s = (
            settings.DEFAULT_METRICS_MIN_INTERVAL
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


def flush_metrics(session: Optional[str] = None) -> Optional[str]:
    """Atomically write this process's metrics registry to its ``.prom``
    textfile (a temporary file, then ``os.replace``, so a reader never
    sees half a file). No-op with tracing disabled. -> the path written,
    or None."""
    if not trace.tracing_enabled():
        return None
    from torchx_tpu_torch.obs.metrics import REGISTRY

    path = metrics_path(session)
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
