"""``tpx-torch tracker`` — query experiment tracking backends from the client.

Port of :mod:`torchx_tpu.cli.cmd_tracker`. Reference analog: torchx/cli/cmd_tracker.py (136 LoC). Subcommands operate
on the trackers configured in .tpxconfig ``[tracker:*]`` sections:

    tpx-torch tracker list runs
    tpx-torch tracker list metadata <run_id>
    tpx-torch tracker list artifacts <run_id>
    tpx-torch tracker lineage <run_id>
"""

from __future__ import annotations

import argparse
import json
import sys

from torchx_tpu_torch.cli.cmd_base import SubCommand
from torchx_tpu_torch.runner.config import load_tracker_sections
from torchx_tpu_torch.tracker.api import TrackerBase, _load_tracker


def _trackers() -> dict[str, TrackerBase]:
    out = {}
    for name, config in load_tracker_sections().items():
        t = _load_tracker(name, config)
        if t is not None:
            out[name] = t
    if not out:
        print(
            "no trackers configured; add a [tracker:<name>] section to"
            " .tpxconfig (e.g. [tracker:fsspec] with config = <root-path>)",
            file=sys.stderr,
        )
        sys.exit(1)
    return out


class CmdTracker(SubCommand):
    def add_arguments(self, subparser: argparse.ArgumentParser) -> None:
        sub = subparser.add_subparsers(dest="tracker_cmd", required=True)

        p_list = sub.add_parser("list", help="list runs / metadata / artifacts")
        p_list.add_argument(
            "what", choices=["runs", "metadata", "artifacts"], help="what to list"
        )
        p_list.add_argument("run_id", nargs="?", default=None)
        p_list.set_defaults(tracker_fn=self._list)

        p_lineage = sub.add_parser("lineage", help="show run lineage sources")
        p_lineage.add_argument("run_id")
        p_lineage.set_defaults(tracker_fn=self._lineage)

    def run(self, args: argparse.Namespace) -> None:
        args.tracker_fn(args)

    def _list(self, args: argparse.Namespace) -> None:
        trackers = _trackers()
        # with multiple backends, prefix each line so outputs are attributable
        prefix = (lambda name: f"[{name}] ") if len(trackers) > 1 else (lambda name: "")
        for name, tracker in trackers.items():
            if args.what == "runs":
                for run_id in tracker.run_ids():
                    print(f"{prefix(name)}{run_id}")
            elif args.what == "metadata":
                if not args.run_id:
                    print("run_id required for metadata", file=sys.stderr)
                    sys.exit(1)
                if len(trackers) > 1:
                    print(f"[{name}]")
                print(json.dumps(dict(tracker.metadata(args.run_id)), indent=2))
            elif args.what == "artifacts":
                if not args.run_id:
                    print("run_id required for artifacts", file=sys.stderr)
                    sys.exit(1)
                for artifact in tracker.artifacts(args.run_id).values():
                    print(f"{prefix(name)}{artifact.name}\t{artifact.path}")

    def _lineage(self, args: argparse.Namespace) -> None:
        trackers = _trackers()
        prefix = (lambda name: f"[{name}] ") if len(trackers) > 1 else (lambda name: "")
        for name, tracker in trackers.items():
            lineage = tracker.lineage(args.run_id)
            for src in lineage.sources:
                suffix = f" (artifact: {src.artifact_name})" if src.artifact_name else ""
                print(f"{prefix(name)}upstream: {src.source_run_id}{suffix}")
            for rid in lineage.descendants:
                print(f"{prefix(name)}downstream: {rid}")
