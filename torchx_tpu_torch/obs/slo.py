"""Declarative SLOs evaluated as multi-window burn rates.

Port of :mod:`torchx_tpu.obs.slo`. The serve autoscaler acts on
instantaneous probes (queue depth, a single p99 sample). This module
gives it — and operators — the standard SRE alternative: an **SLO spec**
(an objective over a metric already flowing through the telemetry
:class:`~torchx_tpu_torch.obs.telemetry.MetricStore`) evaluated as **burn
rates** over two windows. Burn rate is ``error_fraction / error_budget``
(budget = ``1 - objective``): burn 1.0 spends the budget exactly at the
objective's natural pace, 14 spends a 30-day budget in ~2 days. An alert
fires only when BOTH windows exceed the threshold — the short window
gates on "is it still happening", the long window on "is it material" —
the classic multi-window multi-burn-rate recipe.

Two spec kinds:

* **latency** — ``name:metric<threshold@objective``: the fraction of
  histogram observations above ``threshold`` seconds is the error
  fraction (computed from windowed cumulative-bucket deltas);
* **ratio** — ``name:metric{good=labels}/metric@objective``: good over
  total counter increases (e.g. goodput from ``status="ok"`` vs all).

:class:`SloEngine` evaluates every spec per collector cycle, journals
``slo_alert`` firing/resolved transitions as JSONL (append-only,
journal-before-act like the fleet), and exposes :meth:`SloEngine.active`
for dashboards and :meth:`SloEngine.max_burn` as the scalar signal the
autoscaler consumes (:class:`~torchx_tpu_torch.serve.pool.Autoscaler`'s
``burn_rate``).

Standard library only.
"""

from __future__ import annotations

import json
import logging
import math
import os
import re
import time
from dataclasses import dataclass, field, replace
from typing import Callable, Optional

from torchx_tpu_torch.obs.telemetry import MetricStore
from torchx_tpu_torch.util.jsonl import append_jsonl

logger = logging.getLogger(__name__)

__all__ = [
    "SloSpec",
    "parse_slo",
    "SLO_PRESETS",
    "Alert",
    "SloEngine",
    "ROLE_METADATA_KEY",
]

#: fast burn consumes the budget ~14x the sustainable pace (page),
#: slow burn ~6x (warn) — the canonical SRE-workbook thresholds.
FAST_BURN = 14.0
SLOW_BURN = 6.0

#: AppDef role metadata key declaring the SLO specs a serve role is
#: expected to meet (same grammar as ``tpx control --slo``); analyze
#: rule TPX214 cross-checks it against the backend's scrape reachability.
ROLE_METADATA_KEY = "tpx/slo"


@dataclass(frozen=True)
class SloSpec:
    """One declarative objective over a telemetry metric.

    ``kind`` is ``"latency"`` (histogram ``metric``, error = observation
    above ``threshold_s``) or ``"ratio"`` (counter ``metric`` filtered by
    ``good_labels`` over the same counter filtered by ``total_labels``).
    ``objective`` is the target good fraction (0 < objective < 1)."""

    name: str
    metric: str
    objective: float
    kind: str = "latency"
    threshold_s: float = 0.0
    good_labels: dict = field(default_factory=dict)
    total_labels: dict = field(default_factory=dict)
    short_window_s: float = 60.0
    long_window_s: float = 600.0
    fast_burn: float = FAST_BURN
    slow_burn: float = SLOW_BURN

    @property
    def budget(self) -> float:
        """The error budget, ``1 - objective`` (floored at a tiny
        positive value so burn stays finite)."""
        return max(1e-9, 1.0 - self.objective)


# name : metric < threshold @ objective        (latency)
# name : metric{k=v,...} / metric[{k=v,...}] @ objective   (ratio)
_LATENCY_RE = re.compile(
    r"^(?P<name>[\w.-]+):(?P<metric>[a-zA-Z_:][\w:]*)"
    r"<(?P<thresh>[\d.]+(?:ms|s)?)@(?P<obj>[\d.]+)$"
)
_RATIO_RE = re.compile(
    r"^(?P<name>[\w.-]+):(?P<metric>[a-zA-Z_:][\w:]*)"
    r"(?:\{(?P<good>[^}]*)\})?/(?P<tmetric>[a-zA-Z_:][\w:]*)"
    r"(?:\{(?P<total>[^}]*)\})?@(?P<obj>[\d.]+)$"
)


def _parse_labels(raw: Optional[str]) -> dict:
    out: dict = {}
    for part in (raw or "").split(","):
        part = part.strip()
        if not part:
            continue
        k, _, v = part.partition("=")
        out[k.strip()] = v.strip().strip('"')
    return out


def _parse_threshold(raw: str) -> float:
    if raw.endswith("ms"):
        return float(raw[:-2]) / 1000.0
    return float(raw[:-1]) if raw.endswith("s") else float(raw)


#: named shorthands accepted anywhere a spec string is (``--slo p99-ttft``):
#: four exemplar objectives over the metrics the stack
#: already emits.
SLO_PRESETS: dict[str, str] = {
    # serve: 99% of requests reach first token within 500ms
    "p99-ttft": "p99-ttft:tpx_serve_ttft_seconds<0.5@0.99",
    # serve: 99.9% of requests finish with status="ok"
    "goodput": (
        'goodput:tpx_serve_requests_total{status="ok"}'
        "/tpx_serve_requests_total@0.999"
    ),
    # train: 95% of steps complete within 30s
    "step-time": "step-time:tpx_step_seconds<30@0.95",
    # fleet: 90% of gangs wait under 60s for placement
    "gang-wait": "gang-wait:tpx_fleet_gang_wait_seconds<60@0.90",
}


def parse_slo(spec: str) -> SloSpec:
    """Parse one SLO spec string (or a :data:`SLO_PRESETS` name).

    Grammar: ``name:metric<threshold@objective`` (threshold in seconds,
    an ``ms``/``s`` suffix allowed) for latency, or
    ``name:metric{k=v}/metric@objective`` for good/total ratios. Raises
    ``ValueError`` on anything else."""
    spec = SLO_PRESETS.get(spec.strip(), spec.strip())
    m = _LATENCY_RE.match(spec)
    if m:
        obj = float(m.group("obj"))
        if not 0.0 < obj < 1.0:
            raise ValueError(f"SLO objective must be in (0,1): {spec!r}")
        return SloSpec(
            name=m.group("name"),
            metric=m.group("metric"),
            objective=obj,
            kind="latency",
            threshold_s=_parse_threshold(m.group("thresh")),
        )
    m = _RATIO_RE.match(spec)
    if m:
        if m.group("metric") != m.group("tmetric"):
            raise ValueError(
                f"ratio SLO must divide one metric by itself: {spec!r}"
            )
        obj = float(m.group("obj"))
        if not 0.0 < obj < 1.0:
            raise ValueError(f"SLO objective must be in (0,1): {spec!r}")
        return SloSpec(
            name=m.group("name"),
            metric=m.group("metric"),
            objective=obj,
            kind="ratio",
            good_labels=_parse_labels(m.group("good")),
            total_labels=_parse_labels(m.group("total")),
        )
    raise ValueError(
        f"unparseable SLO spec {spec!r}; expected"
        " name:metric<thresh@obj or name:metric{{k=v}}/metric@obj"
        f" or a preset ({', '.join(sorted(SLO_PRESETS))})"
    )


@dataclass
class Alert:
    """One firing (or just-resolved) SLO alert."""

    slo: str
    severity: str  # "page" (fast burn) | "warn" (slow burn)
    state: str  # "firing" | "resolved"
    burn_short: float
    burn_long: float
    since: float
    ts: float

    def to_json(self) -> dict:
        """The journal/API encoding (``kind: slo_alert``)."""
        return {
            "kind": "slo_alert",
            "slo": self.slo,
            "severity": self.severity,
            "state": self.state,
            "burn_short": round(self.burn_short, 3),
            "burn_long": round(self.burn_long, 3),
            "since": self.since,
            "ts": self.ts,
        }


class SloEngine:
    """Evaluate SLO specs against a :class:`MetricStore` and journal
    alert transitions.

    Hang :meth:`evaluate` off the telemetry collector's hook list so
    burn rates refresh once per scrape cycle. Transitions (off→warn,
    warn→page, any→resolved) append one JSONL line to ``journal_path``;
    steady states journal nothing, so a steady run leaves an empty
    journal."""

    def __init__(
        self,
        store: MetricStore,
        specs: list[SloSpec],
        journal_path: Optional[str] = None,
        clock: Callable[[], float] = time.time,
    ) -> None:
        self.store = store
        self.specs = list(specs)
        self.journal_path = journal_path
        self.clock = clock
        self._active: dict[str, Alert] = {}
        self._burns: dict[str, tuple[float, float]] = {}

    # -- burn math ---------------------------------------------------------

    def _error_fraction(self, spec: SloSpec, window_s: float, now: float) -> float:
        """Window error fraction for one spec; 0.0 on zero traffic (no
        observations can't violate an objective)."""
        if spec.kind == "latency":
            good = bad = 0.0
            deltas = self.store.histogram_deltas(
                spec.metric, window_s, now=now
            )
            for buckets in deltas.values():
                total = buckets[-1][1] if buckets else 0.0
                under = 0.0
                for le, cum in buckets:
                    if le <= spec.threshold_s or math.isclose(
                        le, spec.threshold_s, rel_tol=1e-9
                    ):
                        under = cum
                    else:
                        break
                good += under
                bad += max(0.0, total - under)
        else:
            doc = self.store.query(
                spec.metric,
                labels=spec.good_labels or None,
                reduce="rate",
                range_s=window_s,
                now=now,
            )
            good = sum(r["value"] for r in doc.get("result", []))
            doc = self.store.query(
                spec.metric,
                labels=spec.total_labels or None,
                reduce="rate",
                range_s=window_s,
                now=now,
            )
            total_rate = sum(r["value"] for r in doc.get("result", []))
            bad = max(0.0, total_rate - good)
        denom = good + bad
        return bad / denom if denom > 0 else 0.0

    def burn_rates(self, spec: SloSpec, now: Optional[float] = None) -> tuple[float, float]:
        """(short-window, long-window) burn rates for one spec."""
        now = self.clock() if now is None else now
        return (
            self._error_fraction(spec, spec.short_window_s, now) / spec.budget,
            self._error_fraction(spec, spec.long_window_s, now) / spec.budget,
        )

    # -- evaluation / alerting ---------------------------------------------

    def _journal(self, alert: Alert) -> None:
        if not self.journal_path:
            return
        try:
            append_jsonl(self.journal_path, alert.to_json())
        except OSError as e:
            logger.warning("slo journal write failed: %s", e)

    def evaluate(self, now: Optional[float] = None) -> list[Alert]:
        """Evaluate every spec; journal and return the transitions.

        Severity requires BOTH windows over the threshold: ``page`` at
        ``fast_burn``, else ``warn`` at ``slow_burn``, else resolved."""
        now = self.clock() if now is None else now
        transitions: list[Alert] = []
        for spec in self.specs:
            short, long_ = self.burn_rates(spec, now=now)
            self._burns[spec.name] = (short, long_)
            if short >= spec.fast_burn and long_ >= spec.fast_burn:
                severity: Optional[str] = "page"
            elif short >= spec.slow_burn and long_ >= spec.slow_burn:
                severity = "warn"
            else:
                severity = None
            current = self._active.get(spec.name)
            if severity is not None:
                if current is None or current.severity != severity:
                    alert = Alert(
                        slo=spec.name,
                        severity=severity,
                        state="firing",
                        burn_short=short,
                        burn_long=long_,
                        since=current.since if current else now,
                        ts=now,
                    )
                    self._active[spec.name] = alert
                    self._journal(alert)
                    transitions.append(alert)
                else:
                    # still firing: refresh the burns without journaling
                    self._active[spec.name] = replace(
                        current, burn_short=short, burn_long=long_, ts=now
                    )
            elif current is not None:
                resolved = replace(
                    current,
                    state="resolved",
                    burn_short=short,
                    burn_long=long_,
                    ts=now,
                )
                del self._active[spec.name]
                self._journal(resolved)
                transitions.append(resolved)
        return transitions

    def active(self) -> list[Alert]:
        """Currently-firing alerts, pages first then by name."""
        return sorted(
            self._active.values(),
            key=lambda a: (a.severity != "page", a.slo),
        )

    def burns(self) -> dict[str, tuple[float, float]]:
        """Last-evaluated (short, long) burns per SLO name."""
        return dict(self._burns)

    def max_burn(self, metric_prefix: Optional[str] = None) -> float:
        """Max long-window burn across specs (optionally only those whose
        metric starts with ``metric_prefix``) — the scalar the serve
        autoscaler and fleet market take as their SLO signal. 0.0 when
        nothing matches or nothing has been evaluated."""
        best = 0.0
        for spec in self.specs:
            if metric_prefix and not spec.metric.startswith(metric_prefix):
                continue
            burns = self._burns.get(spec.name)
            if burns:
                best = max(best, burns[1])
        return best
