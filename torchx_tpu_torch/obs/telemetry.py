"""Fleet telemetry: bounded time-series store + the scrape collector.

Port of :mod:`torchx_tpu.obs.telemetry`. The obs layer writes
*per-process* Prometheus textfiles and the serving stack exposes
*per-replica* ``/metricz`` endpoints; this module is the central metric
plane that aggregates them:

* :func:`parse_exposition` — a forgiving Prometheus text-format parser
  (``# TYPE``-aware, full label unescaping, torn lines skipped — the same
  holdback discipline as the JSONL journals);
* :class:`MetricStore` — bounded per-series ring buffers keyed by
  ``(source, name, labels)`` with counter/gauge/histogram-aware merge
  across sources at read time: counters, histogram buckets and sums ADD
  across replicas/processes, so the aggregated fleet view stays
  semantically correct;
* query reducers (:meth:`MetricStore.query`) — ``last``/``sum``/``avg``/
  ``max``/``min``, counter ``rate``, and histogram percentiles
  (``p50``/``p90``/``p95``/``p99``) computed from windowed bucket deltas;
* :class:`Collector` — the periodic ingest loop: registered replica
  ``/metricz`` targets (HTTP scrape) plus every obs session's
  ``metrics-*.prom`` textfiles, each cycle followed by registered hooks
  (an SLO engine's evaluation hangs there).

Standard library only: a collector runs in launcher processes, which load
no torch.
"""

from __future__ import annotations

import glob
import logging
import math
import os
import re
import threading
import time
import urllib.request
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Optional

from torchx_tpu_torch import settings
from torchx_tpu_torch.obs import sinks

logger = logging.getLogger(__name__)

__all__ = [
    "PromSample",
    "parse_exposition",
    "Series",
    "MetricStore",
    "scrape_metricz",
    "Collector",
]

#: canonical label encoding inside the store: sorted (key, value) pairs.
LabelSet = tuple[tuple[str, str], ...]

# name{...labels...} value — labels greedy to the LAST brace so quoted
# label values containing "}" survive; the value is never a brace.
_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?\s+(?P<value>\S+)(?:\s+\d+)?$"
)
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:\\.|[^"\\])*)"')
_TYPE_RE = re.compile(r"^#\s*TYPE\s+(\S+)\s+(\S+)\s*$")
_HELP_RE = re.compile(r"^#\s*HELP\s+(\S+)\s+(.*)$")


def _unescape(value: str) -> str:
    """Inverse of the exposition-format label escaping."""
    return (
        value.replace("\\n", "\n").replace('\\"', '"').replace("\\\\", "\\")
    )


def _parse_value(raw: str) -> Optional[float]:
    low = raw.lower()
    if low in ("+inf", "inf"):
        return math.inf
    if low == "-inf":
        return -math.inf
    try:
        return float(raw)
    except ValueError:
        return None


@dataclass(frozen=True)
class PromSample:
    """One parsed exposition line: a metric name, its canonical label set,
    the sample value, and the ``# TYPE`` kind in force when it was read
    (``counter``/``gauge``/``histogram``/``untyped``)."""

    name: str
    labels: LabelSet
    value: float
    kind: str = "untyped"


def parse_exposition(text: str) -> list[PromSample]:
    """Parse Prometheus text format into :class:`PromSample` rows.

    Tolerant by design — a torn tail line, an unparseable value, or a
    malformed label set skips that LINE, never the whole payload (a
    crashed writer may leave a partially-written textfile; readers must
    survive, exactly like :func:`torchx_tpu_torch.obs.timeline.load_records`).
    ``# TYPE`` lines assign the kind to subsequent samples of that family
    (``name``, ``name_bucket``, ``name_sum``, ``name_count``)."""
    kinds: dict[str, str] = {}
    out: list[PromSample] = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            m = _TYPE_RE.match(line)
            if m:
                kinds[m.group(1)] = m.group(2)
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            continue
        value = _parse_value(m.group("value"))
        if value is None:
            continue
        raw_labels = m.group("labels")
        labels: list[tuple[str, str]] = []
        if raw_labels:
            # reject a label blob whose pairs don't reconstruct it — a
            # torn line truncated inside a quoted value must not half-parse
            matched_len = 0
            for lm in _LABEL_RE.finditer(raw_labels):
                labels.append((lm.group(1), _unescape(lm.group(2))))
                matched_len = lm.end()
            tail = raw_labels[matched_len:].strip().rstrip(",").strip()
            if tail:
                continue
        name = m.group("name")
        base = re.sub(r"_(bucket|sum|count)$", "", name)
        kind = kinds.get(name) or kinds.get(base, "untyped")
        out.append(
            PromSample(
                name=name, labels=tuple(sorted(labels)), value=value, kind=kind
            )
        )
    return out


@dataclass
class Series:
    """One source's bounded ring buffer for one ``(name, labels)`` series.

    ``samples`` holds ``(epoch_seconds, value)`` pairs, oldest first,
    capped at the store's capacity (appending past it drops the oldest
    sample — bounded memory no matter how long the daemon runs)."""

    name: str
    labels: LabelSet
    kind: str = "untyped"
    samples: deque = field(default_factory=deque)

    def last(self) -> Optional[float]:
        """Most recent value, or None for an empty series."""
        return self.samples[-1][1] if self.samples else None

    def window(self, range_s: Optional[float], now: float) -> list:
        """Samples inside ``[now - range_s, now]`` (all, when range is
        None), oldest first."""
        if range_s is None:
            return list(self.samples)
        lo = now - range_s
        return [(t, v) for t, v in self.samples if t >= lo]

    def delta(self, range_s: Optional[float], now: float) -> float:
        """Cumulative-counter increase over the window. A mid-window
        counter reset (value decreased) contributes the post-reset value,
        the standard Prometheus ``increase()`` approximation."""
        win = self.window(range_s, now)
        if len(win) < 2:
            return 0.0
        total = 0.0
        prev = win[0][1]
        for _, v in win[1:]:
            total += v - prev if v >= prev else v
            prev = v
        return max(0.0, total)


_PERCENTILE_RE = re.compile(r"^p(\d{1,2}(?:\.\d+)?)$")

#: reducers accepted by :meth:`MetricStore.query` (percentiles besides).
SCALAR_REDUCERS = ("last", "sum", "avg", "max", "min", "rate")


class MetricStore:
    """Bounded multi-source time-series store with merge-aware reads.

    Writes are per ``(source, name, labels)`` ring buffer
    (:meth:`ingest` / :meth:`ingest_text`); reads aggregate across
    sources: counters/histogram components SUM (each replica counts its
    own events), gauges SUM too (fleet totals — the standard
    textfile-collector convention :func:`timeline.load_metrics` already
    follows). Thread-safe: the daemon's collector writes while HTTP
    readers query.
    """

    def __init__(
        self,
        capacity: int = settings.DEFAULT_TELEMETRY_CAPACITY,
        clock: Callable[[], float] = time.time,
    ) -> None:
        self.capacity = int(capacity)
        self.clock = clock
        self._lock = threading.Lock()
        self._series: dict[tuple[str, str, LabelSet], Series] = {}
        self._kinds: dict[str, str] = {}

    def __len__(self) -> int:
        """Number of per-source series currently stored."""
        with self._lock:
            return len(self._series)

    def ingest(
        self,
        source: str,
        samples: Iterable[PromSample],
        ts: Optional[float] = None,
    ) -> int:
        """Append one scrape's samples under ``source``; returns the
        number of samples ingested. Each distinct label set gets its own
        ring buffer; kinds upgrade ``untyped`` series when a later scrape
        carries ``# TYPE``."""
        now = self.clock() if ts is None else ts
        n = 0
        with self._lock:
            for s in samples:
                key = (source, s.name, s.labels)
                series = self._series.get(key)
                if series is None:
                    series = Series(
                        name=s.name,
                        labels=s.labels,
                        kind=s.kind,
                        samples=deque(maxlen=self.capacity),
                    )
                    self._series[key] = series
                if s.kind != "untyped":
                    series.kind = s.kind
                    self._kinds[s.name] = s.kind
                elif s.name not in self._kinds:
                    self._kinds.setdefault(s.name, s.kind)
                series.samples.append((now, s.value))
                n += 1
        return n

    def ingest_text(
        self, source: str, text: str, ts: Optional[float] = None
    ) -> int:
        """Parse exposition ``text`` and ingest it under ``source``."""
        return self.ingest(source, parse_exposition(text), ts=ts)

    def names(self) -> list[str]:
        """Sorted distinct metric names across all sources."""
        with self._lock:
            return sorted({name for _, name, _ in self._series})

    def kind_of(self, name: str) -> str:
        """Recorded ``# TYPE`` kind for ``name`` (``untyped`` default)."""
        with self._lock:
            return self._kinds.get(name, "untyped")

    def _matching(
        self, name: str, labels: Optional[dict] = None
    ) -> list[tuple[str, Series]]:
        want = dict(labels or {})
        out = []
        with self._lock:
            for (source, sname, lset), series in self._series.items():
                if sname != name:
                    continue
                have = dict(lset)
                if any(have.get(k) != str(v) for k, v in want.items()):
                    continue
                out.append((source, series))
        return out

    # -- aggregated reads --------------------------------------------------

    def latest(self, name: str, labels: Optional[dict] = None) -> dict:
        """Latest value per label set, summed across sources."""
        acc: dict[LabelSet, float] = {}
        for _, series in self._matching(name, labels):
            v = series.last()
            if v is None:
                continue
            acc[series.labels] = acc.get(series.labels, 0.0) + v
        return {k: acc[k] for k in sorted(acc)}

    def render_prom(self) -> str:
        """The aggregated fleet exposition: every series summed across
        sources, with ``# HELP``/``# TYPE`` headers and proper label
        escaping — what the daemon serves as its ``/metricz``."""
        from torchx_tpu_torch.obs.metrics import _escape, _format_value

        lines: list[str] = []
        for name in self.names():
            kind = self.kind_of(name)
            lines.append(f"# HELP {name} aggregated across fleet sources")
            lines.append(f"# TYPE {name} {kind}")
            for labels, value in self.latest(name).items():
                if labels:
                    inner = ",".join(
                        f'{k}="{_escape(v)}"' for k, v in labels
                    )
                    lines.append(f"{name}{{{inner}}} {_format_value(value)}")
                else:
                    lines.append(f"{name} {_format_value(value)}")
        return "\n".join(lines) + ("\n" if lines else "")

    def histogram_deltas(
        self,
        name: str,
        range_s: Optional[float],
        now: Optional[float] = None,
        labels: Optional[dict] = None,
    ) -> dict[LabelSet, list[tuple[float, float]]]:
        """Windowed cumulative-bucket increases of histogram ``name``,
        grouped by label set minus ``le`` and summed across sources:
        ``{labels: [(le, delta), ...]}`` sorted by ``le``. The SLO
        engine's raw material."""
        now = self.clock() if now is None else now
        acc: dict[LabelSet, dict[float, float]] = {}
        for _, series in self._matching(f"{name}_bucket", labels):
            lab = dict(series.labels)
            le = _parse_value(lab.pop("le", ""))
            if le is None:
                continue
            group = tuple(sorted(lab.items()))
            by_le = acc.setdefault(group, {})
            by_le[le] = by_le.get(le, 0.0) + series.delta(range_s, now)
        return {
            group: sorted(by_le.items())
            for group, by_le in sorted(acc.items())
        }

    def percentile(
        self,
        name: str,
        q: float,
        range_s: Optional[float] = None,
        now: Optional[float] = None,
        labels: Optional[dict] = None,
    ) -> dict[LabelSet, float]:
        """Per-label-set ``q``-percentile (0..100) of histogram ``name``
        over the window, linear-interpolated within the winning bucket
        (the classic ``histogram_quantile`` estimate)."""
        out: dict[LabelSet, float] = {}
        for group, buckets in self.histogram_deltas(
            name, range_s, now=now, labels=labels
        ).items():
            total = buckets[-1][1] if buckets else 0.0
            if total <= 0:
                continue
            rank = (q / 100.0) * total
            lo_bound, lo_count = 0.0, 0.0
            value = buckets[-1][0]
            for le, cum in buckets:
                if cum >= rank:
                    width = le - lo_bound
                    frac = (
                        (rank - lo_count) / (cum - lo_count)
                        if cum > lo_count
                        else 0.0
                    )
                    value = (
                        lo_bound + width * frac
                        if math.isfinite(le)
                        else lo_bound
                    )
                    break
                lo_bound, lo_count = le, cum
            out[group] = value
        return out

    def query(
        self,
        name: str,
        labels: Optional[dict] = None,
        reduce: Optional[str] = None,
        range_s: Optional[float] = None,
        now: Optional[float] = None,
    ) -> dict:
        """The JSON query API: raw windowed series plus an optional
        reduced scalar per label set.

        Reducers: ``last``/``sum`` (same thing for the cross-source
        aggregate), ``avg``/``max``/``min`` over the window, ``rate``
        (counter increase / window seconds), and ``pNN`` histogram
        percentiles. Unknown reducers raise ``ValueError``."""
        now = self.clock() if now is None else now
        matches = self._matching(name, labels)
        series_out = [
            {
                "source": source,
                "labels": dict(s.labels),
                "points": [[t, v] for t, v in s.window(range_s, now)],
            }
            for source, s in sorted(matches, key=lambda x: (x[0], x[1].labels))
        ]
        doc: dict[str, Any] = {
            "name": name,
            "kind": self.kind_of(name),
            "reduce": reduce or "none",
            "range_s": range_s,
            "series": series_out,
        }
        if not reduce:
            return doc
        pm = _PERCENTILE_RE.match(reduce)
        result: dict[LabelSet, float] = {}
        if pm:
            result = self.percentile(
                name, float(pm.group(1)), range_s=range_s, now=now, labels=labels
            )
        elif reduce in ("last", "sum"):
            result = self.latest(name, labels)
        elif reduce == "rate":
            span = range_s or 60.0
            for _, s in matches:
                d = s.delta(range_s, now)
                result[s.labels] = result.get(s.labels, 0.0) + d / span
        elif reduce in ("avg", "max", "min"):
            fn = {"avg": None, "max": max, "min": min}[reduce]
            per: dict[LabelSet, list[float]] = {}
            for _, s in matches:
                vals = [v for _, v in s.window(range_s, now)]
                if vals:
                    per.setdefault(s.labels, []).extend(vals)
            for lset, vals in per.items():
                result[lset] = (
                    sum(vals) / len(vals) if fn is None else fn(vals)
                )
        else:
            raise ValueError(
                f"unknown reducer {reduce!r}; use one of"
                f" {SCALAR_REDUCERS} or pNN"
            )
        doc["result"] = [
            {"labels": dict(lset), "value": value}
            for lset, value in sorted(result.items())
        ]
        return doc


def scrape_metricz(url: str, timeout: float = 5.0) -> str:
    """GET one replica's Prometheus exposition. ``url`` may be a base
    (``http://host:port``) or already end in ``/metricz``."""
    target = url if url.rstrip("/").endswith("/metricz") else (
        url.rstrip("/") + "/metricz"
    )
    with urllib.request.urlopen(target, timeout=timeout) as resp:
        return resp.read().decode("utf-8", "replace")


class Collector:
    """The periodic ingest loop (the control daemon's, in the JAX package).

    Each cycle: scrape every registered HTTP target, re-read every obs
    session's ``metrics-*.prom`` textfiles (per-file sources, so per-pid
    writers never clobber each other in the store), then run the
    registered hooks (the daemon's SLO evaluation). Scrape failures are
    counted per target and never abort the cycle."""

    def __init__(
        self,
        store: MetricStore,
        interval_s: Optional[float] = None,
        obs_dir: Optional[str] = None,
        clock: Callable[[], float] = time.time,
    ) -> None:
        if interval_s is None:
            raw = os.environ.get(settings.ENV_TPX_TELEMETRY_INTERVAL, "")
            try:
                interval_s = float(raw) if raw else None
            except ValueError:
                interval_s = None
        self.store = store
        self.interval_s = (
            settings.DEFAULT_TELEMETRY_INTERVAL
            if interval_s is None
            else float(interval_s)
        )
        self.obs_dir = obs_dir
        self.clock = clock
        self.hooks: list[Callable[[], None]] = []
        self.errors: dict[str, str] = {}
        self.cycles = 0
        self._targets: dict[str, str] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def add_target(self, url: str, name: Optional[str] = None) -> str:
        """Register one ``/metricz`` scrape target; returns its source
        name (used as the store's source key and in error reports)."""
        key = name or url
        with self._lock:
            self._targets[key] = url
        return key

    def remove_target(self, name: str) -> bool:
        """Drop a scrape target by its source name."""
        with self._lock:
            return self._targets.pop(name, None) is not None

    def targets(self) -> dict[str, str]:
        """Snapshot of registered targets (``{name: url}``)."""
        with self._lock:
            return dict(self._targets)

    def collect_once(self) -> int:
        """One full cycle; returns samples ingested. Never raises."""
        n = 0
        ts = self.clock()
        for name, url in self.targets().items():
            try:
                n += self.store.ingest_text(
                    name, scrape_metricz(url), ts=ts
                )
                self.errors.pop(name, None)
            except Exception as e:  # noqa: BLE001 - a dead replica is data
                self.errors[name] = f"{type(e).__name__}: {e}"
        root = self.obs_dir or sinks.obs_root()
        for path in glob.glob(
            os.path.join(root, "*", sinks.METRICS_GLOB)
        ):
            try:
                with open(path) as f:
                    text = f.read()
            except OSError:
                continue
            session = os.path.basename(os.path.dirname(path))
            source = f"file:{session}/{os.path.basename(path)}"
            n += self.store.ingest_text(source, text, ts=ts)
        for hook in list(self.hooks):
            try:
                hook()
            except Exception as e:  # noqa: BLE001 - hooks must not kill it
                logger.warning("telemetry hook failed: %s", e)
        self.cycles += 1
        return n

    def start(self) -> "Collector":
        """Run :meth:`collect_once` every ``interval_s`` on a daemon
        thread until :meth:`stop`."""
        if self._thread is not None:
            return self
        self._stop.clear()

        def _loop() -> None:
            while not self._stop.wait(self.interval_s):
                self.collect_once()

        self._thread = threading.Thread(
            target=_loop, name="tpx-telemetry", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop the collect loop (idempotent)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
