"""``tpx-torch trace`` — render a stored launch trace as an indented timeline.

Port of :mod:`torchx_tpu.cli.cmd_trace`. Reads the JSONL trace files the
obs subsystem writes under ``~/.torchx_tpu/obs/<session>/`` (see
:mod:`torchx_tpu_torch.obs.sinks`) — no scheduler round-trips, so it works
long after the job is gone. The records are the JAX package's, so either
package's command renders the other's traces::

    tpx-torch trace local://tpx_ab12cd34/myapp_xyz
    tpx-torch trace myapp_xyz --events
    tpx-torch trace 4f1d...32-hex-trace-id... --metrics
    tpx-torch trace 4f1d...32-hex-trace-id... --stitch   # router + replicas

The identifier may be a full app handle, a bare app id, or a raw trace
id. ``--events`` interleaves the TpxEvent audit records (supervisor
transitions and API calls) under their spans; ``--metrics`` appends the
session's aggregated Prometheus metrics table.
"""

from __future__ import annotations

import argparse
import os
import re
import sys
from typing import Any, Optional

from torchx_tpu_torch.cli.cmd_base import SubCommand

_TRACE_ID_RE = re.compile(r"^[0-9a-f]{32}$")
_HANDLE_RE = re.compile(r"^\w+://[^/]*/(?P<app_id>[^/]+)")


def _app_id_of(identifier: str) -> str:
    """App id from a full handle, or the identifier itself when bare."""
    m = _HANDLE_RE.match(identifier)
    return m.group("app_id") if m else identifier


class CmdTrace(SubCommand):
    """Inspect stored traces (see module docstring)."""

    def add_arguments(self, subparser: argparse.ArgumentParser) -> None:
        subparser.add_argument(
            "identifier",
            help="app handle (scheduler://session/app_id), bare app id,"
            " or 32-hex trace id",
        )
        subparser.add_argument(
            "--events",
            action="store_true",
            help="interleave TpxEvent records under their spans",
        )
        subparser.add_argument(
            "--metrics",
            action="store_true",
            help="append the session's aggregated metrics table",
        )
        subparser.add_argument(
            "--buckets",
            action="store_true",
            help="with --metrics: include histogram _bucket series",
        )
        subparser.add_argument(
            "--stitch",
            action="store_true",
            help="stitch one timeline across ALL session dirs (router,"
            " replicas, KV transfer, fleet daemon); identifier may also"
            " be a serve request_id or fleet job name",
        )
        subparser.add_argument(
            "--obs-dir",
            default=None,
            help="obs root to search (default: $TPX_OBS_DIR or"
            " ~/.torchx_tpu/obs)",
        )

    def run(self, args: argparse.Namespace) -> None:
        from torchx_tpu_torch.obs import timeline

        if args.stitch:
            self._run_stitch(args)
            return

        files = list(timeline.iter_trace_files(args.obs_dir))
        if not files:
            print("no traces recorded yet", file=sys.stderr)
            sys.exit(1)

        # merge records across sessions: a client and its replicas normally
        # share one session dir, but a raw trace id may span several
        records: list[dict[str, Any]] = []
        file_of_record: list[str] = []
        for path in files:
            recs = timeline.load_records(path)
            records.extend(recs)
            file_of_record.extend([path] * len(recs))

        trace_id: Optional[str] = None
        if _TRACE_ID_RE.match(args.identifier):
            trace_id = args.identifier
        else:
            app_id = _app_id_of(args.identifier)
            trace_ids = timeline.find_trace_ids(records, app_id)
            if trace_ids:
                trace_id = trace_ids[0]  # files are newest-first: first hit
                if len(trace_ids) > 1:
                    print(
                        f"note: {len(trace_ids)} traces touched {app_id};"
                        f" showing the newest ({trace_id})",
                        file=sys.stderr,
                    )
        session_dirs = sorted(
            {
                os.path.dirname(f)
                for f, r in zip(file_of_record, records)
                if r.get("trace_id") == trace_id
            }
        )
        roots = timeline.build_timeline(records, trace_id) if trace_id else []
        if not roots:
            print(f"no trace found for: {args.identifier}", file=sys.stderr)
            sys.exit(1)

        print(f"trace {trace_id}")
        print(timeline.render_timeline(roots, include_events=args.events))

        if args.metrics:
            rows: list[tuple[str, str, float]] = []
            for d in session_dirs:
                rows.extend(timeline.load_metrics(d))
            print()
            print(
                timeline.render_metrics_table(
                    rows, include_buckets=args.buckets
                )
            )

    def _run_stitch(self, args: argparse.Namespace) -> None:
        from torchx_tpu_torch.obs import stitch, timeline

        ident = _app_id_of(args.identifier)
        st = stitch.stitch(ident, obs_dir=args.obs_dir)
        if st is None:
            print(f"no trace found for: {args.identifier}", file=sys.stderr)
            sys.exit(1)
        print(stitch.render_stitched(st, include_events=args.events))
        if args.metrics:
            rows: list[tuple[str, str, float]] = []
            for d in st.sessions:
                rows.extend(timeline.load_metrics(d))
            print()
            print(
                timeline.render_metrics_table(
                    rows, include_buckets=args.buckets
                )
            )
