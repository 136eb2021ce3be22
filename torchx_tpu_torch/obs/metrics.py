"""In-process metrics registry with a Prometheus text exporter.

The port's copy of the registry of :mod:`torchx_tpu.obs.metrics` and of
its serving instruments (the ``tpx_serve_*`` counters, gauges and
histograms the engine, the prefix cache and the KV transfer emit).
Counters, gauges and fixed-bucket histograms, labeled and thread-safe;
:meth:`MetricsRegistry.render` emits the Prometheus text exposition
format that ``generate_server``'s ``/metricz`` serves.
"""

from __future__ import annotations

import threading
from bisect import bisect_left
from typing import Mapping, Optional, Sequence

LabelValues = tuple[str, ...]

#: default histogram buckets (seconds), tuned for launcher latencies:
#: sub-second API calls up to multi-minute scheduling waits.
DEFAULT_BUCKETS: tuple[float, ...] = (
    0.005,
    0.025,
    0.1,
    0.5,
    1.0,
    5.0,
    15.0,
    30.0,
    60.0,
    120.0,
    300.0,
    600.0,
)


def _format_labels(names: Sequence[str], values: LabelValues) -> str:
    if not names:
        return ""
    pairs = ",".join(
        f'{n}="{_escape(v)}"' for n, v in zip(names, values)
    )
    return "{" + pairs + "}"


def _escape(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _format_value(v: float) -> str:
    return str(int(v)) if float(v).is_integer() else repr(float(v))


class _Metric:
    """Shared label plumbing for all instrument types."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: Sequence[str]) -> None:  # noqa: A002
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()

    def _key(self, labels: Mapping[str, str]) -> LabelValues:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"metric {self.name} takes labels {self.labelnames},"
                f" got {tuple(labels)}"
            )
        return tuple(str(labels[n]) for n in self.labelnames)

    def render(self) -> list[str]:
        """One Prometheus text-format sample line per labeled series."""
        raise NotImplementedError


class Counter(_Metric):
    """Monotonically increasing count (e.g. polls, retries)."""

    kind = "counter"

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = ()) -> None:  # noqa: A002
        super().__init__(name, help, labelnames)
        self._values: dict[LabelValues, float] = {}

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        """Add ``amount`` (must be >= 0) to the labeled series."""
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels: str) -> float:
        """Current value of the labeled series (0 if never incremented)."""
        return self._values.get(self._key(labels), 0.0)

    def render(self) -> list[str]:
        with self._lock:
            return [
                f"{self.name}{_format_labels(self.labelnames, k)} {_format_value(v)}"
                for k, v in sorted(self._values.items())
            ]


class Gauge(_Metric):
    """A value that can go up and down (e.g. active attempts)."""

    kind = "gauge"

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = ()) -> None:  # noqa: A002
        super().__init__(name, help, labelnames)
        self._values: dict[LabelValues, float] = {}

    def set(self, value: float, **labels: str) -> None:
        """Set the labeled series to ``value``."""
        key = self._key(labels)
        with self._lock:
            self._values[key] = float(value)

    def value(self, **labels: str) -> float:
        """Current value of the labeled series (0 if never set)."""
        return self._values.get(self._key(labels), 0.0)

    def render(self) -> list[str]:
        with self._lock:
            return [
                f"{self.name}{_format_labels(self.labelnames, k)} {_format_value(v)}"
                for k, v in sorted(self._values.items())
            ]


class Histogram(_Metric):
    """Fixed-bucket distribution (cumulative buckets, Prometheus style)."""

    kind = "histogram"

    def __init__(
        self,
        name: str,
        help: str,  # noqa: A002
        labelnames: Sequence[str] = (),
        buckets: Sequence[float] = DEFAULT_BUCKETS,
    ) -> None:
        super().__init__(name, help, labelnames)
        if list(buckets) != sorted(buckets) or not buckets:
            raise ValueError(f"histogram {name} buckets must be sorted and non-empty")
        self.buckets = tuple(float(b) for b in buckets)
        # per-series: [bucket counts..., +Inf count], sum
        self._counts: dict[LabelValues, list[int]] = {}
        self._sums: dict[LabelValues, float] = {}

    def observe(self, value: float, **labels: str) -> None:
        """Record one observation into the labeled series."""
        key = self._key(labels)
        idx = bisect_left(self.buckets, value)
        with self._lock:
            counts = self._counts.setdefault(key, [0] * (len(self.buckets) + 1))
            counts[idx] += 1
            self._sums[key] = self._sums.get(key, 0.0) + float(value)

    def count(self, **labels: str) -> int:
        """Total observations in the labeled series."""
        return sum(self._counts.get(self._key(labels), ()))

    def sum(self, **labels: str) -> float:
        """Sum of observations in the labeled series."""
        return self._sums.get(self._key(labels), 0.0)

    def render(self) -> list[str]:
        lines = []
        with self._lock:
            for key in sorted(self._counts):
                counts = self._counts[key]
                cumulative = 0
                names = (*self.labelnames, "le")
                for bound, n in zip(self.buckets, counts):
                    cumulative += n
                    values = (*key, _format_value(bound))
                    lines.append(
                        f"{self.name}_bucket{_format_labels(names, values)} {cumulative}"
                    )
                cumulative += counts[-1]
                values = (*key, "+Inf")
                lines.append(
                    f"{self.name}_bucket{_format_labels(names, values)} {cumulative}"
                )
                lines.append(
                    f"{self.name}_sum{_format_labels(self.labelnames, key)}"
                    f" {_format_value(self._sums[key])}"
                )
                lines.append(
                    f"{self.name}_count{_format_labels(self.labelnames, key)}"
                    f" {cumulative}"
                )
        return lines


class MetricsRegistry:
    """Name-keyed collection of instruments; ``counter``/``gauge``/
    ``histogram`` are get-or-create (idempotent across modules), and
    :meth:`render` emits the whole registry in Prometheus text format."""

    def __init__(self) -> None:
        self._metrics: dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def __repr__(self) -> str:
        # stable (no object address): this repr lands in generated docs
        return f"MetricsRegistry({sorted(self._metrics)})"

    def _get_or_create(self, cls, name: str, *args, **kwargs) -> _Metric:  # noqa: ANN001,ANN002
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if not isinstance(existing, cls):
                    raise ValueError(
                        f"metric {name} already registered as {existing.kind}"
                    )
                return existing
            metric = cls(name, *args, **kwargs)
            self._metrics[name] = metric
            return metric

    def counter(
        self, name: str, help: str, labelnames: Sequence[str] = ()  # noqa: A002
    ) -> Counter:
        """Get or create a :class:`Counter`."""
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(
        self, name: str, help: str, labelnames: Sequence[str] = ()  # noqa: A002
    ) -> Gauge:
        """Get or create a :class:`Gauge`."""
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(
        self,
        name: str,
        help: str,  # noqa: A002
        labelnames: Sequence[str] = (),
        buckets: Sequence[float] = DEFAULT_BUCKETS,
    ) -> Histogram:
        """Get or create a :class:`Histogram` with fixed ``buckets``."""
        return self._get_or_create(Histogram, name, help, labelnames, buckets)

    def get(self, name: str) -> Optional[_Metric]:
        """The registered instrument, or None."""
        return self._metrics.get(name)

    def render(self) -> str:
        """The whole registry in Prometheus text exposition format
        (HELP/TYPE headers + one line per labeled series). Series-less
        instruments render headers only, so the page documents every
        metric the launcher can emit."""
        out: list[str] = []
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        for m in metrics:
            out.append(f"# HELP {m.name} {m.help}")
            out.append(f"# TYPE {m.name} {m.kind}")
            out.extend(m.render())
        return "\n".join(out) + "\n"


#: the process-wide registry every instrument below lives in.
REGISTRY = MetricsRegistry()

#: serving-engine slot occupancy: fraction of decode slots holding an
#: active sequence this step (sustained occupancy is what keeps
#: HBM-bandwidth-bound decode fed — the continuous-batching win).
SERVE_OCCUPANCY = REGISTRY.gauge(
    "tpx_serve_slot_occupancy",
    "fraction of decode slots active in the serving engine",
)

#: decode slots currently holding an active sequence.
SERVE_SLOTS_ACTIVE = REGISTRY.gauge(
    "tpx_serve_slots_active",
    "decode slots currently active in the serving engine",
)

#: requests admitted but not yet completed, waiting for a free slot.
SERVE_QUEUE_DEPTH = REGISTRY.gauge(
    "tpx_serve_queue_depth",
    "requests waiting for a decode slot in the serving engine",
)

#: paged KV blocks currently allocated to live sequences.
SERVE_KV_BLOCKS_USED = REGISTRY.gauge(
    "tpx_serve_kv_blocks_used",
    "paged KV-cache blocks held by active sequences",
)

#: decode tokens produced, by phase ("prefill" first tokens vs "decode").
SERVE_TOKENS = REGISTRY.counter(
    "tpx_serve_tokens_total",
    "tokens produced by the serving engine",
    ("phase",),
)

#: completed requests, by outcome ("ok"/"error").
SERVE_REQUESTS = REGISTRY.counter(
    "tpx_serve_requests_total",
    "requests completed by the serving engine",
    ("status",),
)

#: sequences preempted (blocks reclaimed, request requeued) because the
#: KV pool ran out of free blocks mid-decode.
SERVE_PREEMPTIONS = REGISTRY.counter(
    "tpx_serve_preemptions_total",
    "sequences preempted for KV-pool pressure and requeued",
)

#: time-to-first-token per request, seconds.
SERVE_TTFT_SECONDS = REGISTRY.histogram(
    "tpx_serve_ttft_seconds",
    "request time-to-first-token in seconds",
    buckets=(0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 15.0, 60.0),
)

#: per-token decode latency (time-per-output-token) per request, seconds.
SERVE_TPOT_SECONDS = REGISTRY.histogram(
    "tpx_serve_tpot_seconds",
    "request mean time-per-output-token in seconds",
    buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 5.0),
)

#: prefix-cache lookups that matched at least one cached block.
SERVE_PREFIX_HITS = REGISTRY.counter(
    "tpx_serve_prefix_hits_total",
    "prefix-cache lookups that reused cached KV blocks",
)

#: prefix-cache lookups that matched nothing (cold prefix).
SERVE_PREFIX_MISSES = REGISTRY.counter(
    "tpx_serve_prefix_misses_total",
    "prefix-cache lookups with no cached prefix",
)

#: prompt tokens served from cached KV blocks instead of re-prefilling.
SERVE_PREFIX_HIT_TOKENS = REGISTRY.counter(
    "tpx_serve_prefix_hit_tokens_total",
    "prompt tokens whose KV came from the prefix cache",
)

#: KV blocks currently pinned by the prefix cache (refcount held).
SERVE_PREFIX_CACHED_BLOCKS = REGISTRY.gauge(
    "tpx_serve_prefix_cached_blocks",
    "paged KV blocks pinned by the prefix cache",
)

#: cache-only blocks evicted (LRU) under pool pressure or reserve cap.
SERVE_PREFIX_EVICTIONS = REGISTRY.counter(
    "tpx_serve_prefix_evictions_total",
    "prefix-cache blocks evicted back to the free list",
)

#: copy-on-write block copies (shared tail block about to be written).
SERVE_COW_COPIES = REGISTRY.counter(
    "tpx_serve_cow_copies_total",
    "shared KV blocks copied before an in-place append",
)

#: prefill->decode KV handoffs, by outcome ("ok"/"rejected"/"error") —
#: "rejected" is a draining decode target (the transfer is requeued).
SERVE_KV_TRANSFERS = REGISTRY.counter(
    "tpx_serve_kv_transfers_total",
    "KV block transfers between prefill and decode replicas",
    ("status",),
)

#: payload bytes moved prefill->decode (K+V blocks, serialized).
SERVE_KV_TRANSFER_BYTES = REGISTRY.counter(
    "tpx_serve_kv_transfer_bytes_total",
    "bytes of KV blocks streamed from prefill to decode replicas",
)
