"""Read stored traces back and render them as an indented timeline.

Port of :mod:`torchx_tpu.obs.timeline`, the inspection half of the obs
subsystem: ``tpx-torch trace`` feeds an app handle (or raw trace id)
through :func:`find_trace_ids` / :func:`build_timeline` /
:func:`render_timeline` to answer "where did my launch time go", entirely
from the JSONL files under the obs directory — no scheduler round-trips,
works after the job is gone. The records are the JAX package's, so either
package renders the other's traces.
"""

from __future__ import annotations

import glob
import json
import os
import re
from dataclasses import dataclass, field
from typing import Any, Iterable, Optional

from torchx_tpu_torch.obs import sinks
from torchx_tpu_torch.obs.trace import SPAN_KIND, Span


def load_records(path: str) -> list[dict[str, Any]]:
    """Parse one JSONL file into dicts, silently skipping unparseable
    lines (a crashed writer may leave a torn tail; readers must survive)."""
    records: list[dict[str, Any]] = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    obj = json.loads(line)
                except ValueError:
                    continue
                if isinstance(obj, dict):
                    records.append(obj)
    except OSError:
        pass
    return records


def iter_trace_files(obs_dir: Optional[str] = None) -> Iterable[str]:
    """Every session's ``trace.jsonl`` under the obs root, newest session
    first (mtime order) so searches hit recent runs before old ones."""
    root = obs_dir or sinks.obs_root()
    paths = glob.glob(os.path.join(root, "*", sinks.TRACE_FILE))
    return sorted(paths, key=lambda p: os.path.getmtime(p), reverse=True)


def is_span(record: dict[str, Any]) -> bool:
    """True when a JSONL record is a serialized span (vs a TpxEvent)."""
    return record.get("kind") == SPAN_KIND


def _record_app_id(record: dict[str, Any]) -> Optional[str]:
    if is_span(record):
        return (record.get("attrs") or {}).get("app_id")
    return record.get("app_id")


def find_trace_ids(records: list[dict[str, Any]], app_id: str) -> list[str]:
    """Trace ids that touched ``app_id`` (order of first appearance). A
    supervised run keeps one trace across attempts, so this is normally a
    single id; multiple ids mean the app was driven by separate client
    invocations (e.g. ``tpx run`` then ``tpx status``)."""
    out: list[str] = []
    for r in records:
        tid = r.get("trace_id")
        if tid and _record_app_id(r) == app_id and tid not in out:
            out.append(tid)
    return out


@dataclass
class TimelineNode:
    """One span plus its children, ordered by start time."""

    span: Span
    children: list["TimelineNode"] = field(default_factory=list)
    #: TpxEvent records correlated to this span (via their span_id).
    events: list[dict[str, Any]] = field(default_factory=list)


def build_timeline(
    records: list[dict[str, Any]], trace_id: str
) -> list[TimelineNode]:
    """Reconstruct one trace's span tree from mixed JSONL records.

    Returns the root nodes (usually one) sorted by start time; spans whose
    parent never got recorded (crashed writer) surface as roots rather
    than vanishing. TpxEvent records carrying a ``span_id`` are attached
    to their span for ``--events`` rendering."""
    nodes: dict[str, TimelineNode] = {}
    events: list[dict[str, Any]] = []
    for r in records:
        if r.get("trace_id") != trace_id:
            continue
        if is_span(r):
            span = Span.deserialize(json.dumps(r))
            nodes[span.span_id] = TimelineNode(span)
        else:
            events.append(r)
    roots: list[TimelineNode] = []
    for node in nodes.values():
        parent = nodes.get(node.span.parent_span_id or "")
        if parent is not None and parent is not node:
            parent.children.append(node)
        else:
            roots.append(node)
    for ev in events:
        node = nodes.get(ev.get("span_id") or "")
        if node is not None:
            node.events.append(ev)
    for node in nodes.values():
        node.children.sort(key=lambda n: n.span.start_epoch_usec)
        node.events.sort(key=lambda e: e.get("start_epoch_time_usec") or 0)
    roots.sort(key=lambda n: n.span.start_epoch_usec)
    return roots


def _fmt_duration(usec: Optional[int]) -> str:
    if usec is None:
        return "open"
    s = usec / 1e6
    if s < 0.001:
        return f"{usec}us"
    if s < 1:
        return f"{s * 1000:.1f}ms"
    return f"{s:.2f}s"


_HIDDEN_ATTRS = {"app_id"}  # shown inline with the name, not in the attr list


def _fmt_attrs(attrs: dict[str, Any]) -> str:
    parts = [
        f"{k}={v}"
        for k, v in attrs.items()
        if k not in _HIDDEN_ATTRS and v is not None
    ]
    return f"  [{', '.join(parts)}]" if parts else ""


def render_timeline(
    roots: list[TimelineNode],
    include_events: bool = False,
) -> str:
    """Render a span tree as an indented timeline: per-line relative start
    offset (from the trace's first span), name, app id, duration, attrs,
    and an ``!ERROR`` marker on failed spans."""
    if not roots:
        return "(no spans)"
    t0 = min(r.span.start_epoch_usec for r in roots)
    lines: list[str] = []

    def walk(node: TimelineNode, depth: int) -> None:
        sp = node.span
        offset = (sp.start_epoch_usec - t0) / 1e6
        app_id = sp.attrs.get("app_id")
        name = f"{sp.name} ({app_id})" if app_id else sp.name
        err = "  !ERROR" if sp.status == "ERROR" else ""
        lines.append(
            f"+{offset:9.3f}s  {'  ' * depth}{name}"
            f"  {_fmt_duration(sp.duration_usec())}"
            f"{_fmt_attrs(sp.attrs)}{err}"
        )
        if include_events:
            for ev in node.events:
                ts = ev.get("start_epoch_time_usec")
                eoff = f"+{(ts - t0) / 1e6:9.3f}s" if ts else " " * 11
                meta = ev.get("app_metadata") or {}
                label = meta.get("transition") or ev.get("api") or "event"
                detail = ", ".join(
                    f"{k}={v}"
                    for k, v in meta.items()
                    if k != "transition" and v is not None
                )
                lines.append(
                    f"{eoff}  {'  ' * (depth + 1)}· {label}"
                    + (f"  [{detail}]" if detail else "")
                )
        for child in node.children:
            walk(child, depth + 1)

    for root in roots:
        walk(root, 0)
    return "\n".join(lines)


# -- metrics table ---------------------------------------------------------

_PROM_LINE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(?P<labels>[^}]*)\})?\s+(?P<value>\S+)$"
)


def load_metrics(session_dir: str) -> list[tuple[str, str, float]]:
    """Parse every ``metrics-*.prom`` textfile in a session dir into
    ``(name, labels, value)`` rows, summing series that appear in several
    processes' files (counters/histograms aggregate correctly; a gauge
    duplicated across processes is summed too, which is the standard
    textfile-collector caveat)."""
    acc: dict[tuple[str, str], float] = {}
    order: list[tuple[str, str]] = []
    for path in sorted(glob.glob(os.path.join(session_dir, sinks.METRICS_GLOB))):
        try:
            with open(path) as f:
                text = f.read()
        except OSError:
            continue
        for line in text.splitlines():
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            m = _PROM_LINE.match(line)
            if not m:
                continue
            try:
                value = float(m.group("value"))
            except ValueError:
                continue
            key = (m.group("name"), m.group("labels") or "")
            if key not in acc:
                order.append(key)
            acc[key] = acc.get(key, 0.0) + value
    return [(name, labels, acc[(name, labels)]) for name, labels in order]


def render_metrics_table(
    rows: list[tuple[str, str, float]], include_buckets: bool = False
) -> str:
    """Align metric rows into a readable table; histogram ``_bucket``
    series are collapsed by default (``_count``/``_sum`` tell the story)."""
    visible = [
        (n, l, v)
        for n, l, v in rows
        if include_buckets or not n.endswith("_bucket")
    ]
    if not visible:
        return "(no metrics)"
    name_w = max(len(n) for n, _, _ in visible)
    label_w = max(len(l) for _, l, _ in visible)
    return "\n".join(
        f"{n:<{name_w}}  {l:<{label_w}}  {_strip_float(v)}"
        for n, l, v in visible
    )


def _strip_float(v: float) -> str:
    return str(int(v)) if v.is_integer() else f"{v:.6g}"
