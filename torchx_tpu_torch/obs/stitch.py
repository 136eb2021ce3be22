"""Cross-session trace stitching: one timeline from many writers.

A single serve request now leaves spans in up to four places — the
router's process, the prefill replica, the KV transfer, and the decode
replica — and a fleet job's lifecycle spans come from the control
daemon's process while its in-job heartbeats come from the gang's. Each
writer has its own obs session dir; :mod:`torchx_tpu_torch.obs.timeline`
reads one dir at a time, so the picture stays sharded.

Port of :mod:`torchx_tpu.obs.stitch`, the merge layer ``tpx-torch trace
--stitch`` uses: gather every
session's records, resolve an operator-friendly identifier (app id,
serve ``request_id``, fleet job name, or raw 32-hex trace id) to a trace
id, and rebuild one tree across all of them. Orphan spans — parents
recorded by a writer whose file we can't see — surface as extra roots
rather than vanishing, same holdback discipline as the journals.

Standard library only.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field
from typing import Any, Optional

from torchx_tpu_torch.obs import timeline

__all__ = [
    "collect_records",
    "resolve_trace_ids",
    "StitchedTrace",
    "stitch",
    "render_stitched",
]

_TRACE_ID_RE = re.compile(r"^[0-9a-f]{32}$")

#: span attrs an identifier is matched against (beyond app_id): the
#: serve request id stamped by the router/replicas and the fleet job
#: name stamped by the scheduler's lifecycle spans.
_IDENT_ATTRS = ("app_id", "request_id", "fleet_job")


def collect_records(
    obs_dir: Optional[str] = None,
) -> tuple[list[dict[str, Any]], list[str]]:
    """Load every session's trace records under the obs root.

    Returns ``(records, source_files)`` with one source path per record
    (parallel lists), newest session first — the raw material for
    resolution and stitching."""
    records: list[dict[str, Any]] = []
    sources: list[str] = []
    for path in timeline.iter_trace_files(obs_dir):
        recs = timeline.load_records(path)
        records.extend(recs)
        sources.extend([path] * len(recs))
    return records, sources


def resolve_trace_ids(records: list[dict[str, Any]], ident: str) -> list[str]:
    """Trace ids matching an operator identifier, in order of first
    appearance. A 32-hex string is taken as a literal trace id; anything
    else matches span attrs ``app_id``/``request_id``/``fleet_job`` and
    event ``app_id`` fields."""
    if _TRACE_ID_RE.match(ident):
        return [ident]
    out: list[str] = []
    for r in records:
        tid = r.get("trace_id")
        if not tid or tid in out:
            continue
        if timeline.is_span(r):
            attrs = r.get("attrs") or {}
            if any(attrs.get(k) == ident for k in _IDENT_ATTRS):
                out.append(tid)
        elif r.get("app_id") == ident:
            out.append(tid)
    return out


@dataclass
class StitchedTrace:
    """One reconstructed cross-session trace."""

    trace_id: str
    roots: list[timeline.TimelineNode]
    #: session dirs that contributed at least one record.
    sessions: list[str] = field(default_factory=list)
    span_count: int = 0


def stitch(
    ident: str, obs_dir: Optional[str] = None
) -> Optional[StitchedTrace]:
    """Resolve ``ident`` and rebuild its trace across every session dir.

    Returns None when nothing matches. With multiple matching traces the
    newest (first found — files iterate newest-first) wins, matching
    ``tpx trace``'s behavior."""
    records, sources = collect_records(obs_dir)
    ids = resolve_trace_ids(records, ident)
    if not ids:
        return None
    trace_id = ids[0]
    sessions = sorted(
        {
            os.path.dirname(src)
            for r, src in zip(records, sources)
            if r.get("trace_id") == trace_id
        }
    )
    roots = timeline.build_timeline(records, trace_id)
    count = sum(
        1
        for r in records
        if r.get("trace_id") == trace_id and timeline.is_span(r)
    )
    return StitchedTrace(
        trace_id=trace_id, roots=roots, sessions=sessions, span_count=count
    )


def render_stitched(st: StitchedTrace, include_events: bool = False) -> str:
    """Render a stitched trace: a provenance header (which session dirs
    fed it) above the merged indented timeline."""
    lines = [
        f"trace {st.trace_id}  "
        f"({st.span_count} spans from {len(st.sessions)} sessions)"
    ]
    lines += [f"  session {s}" for s in st.sessions]
    lines.append(timeline.render_timeline(st.roots, include_events=include_events))
    return "\n".join(lines)
