"""``tpx-torch profile`` — render a run's step-time phase attribution.

Port of :mod:`torchx_tpu.cli.cmd_profile`. The journal is the reference's,
so either package's command reads the other's profiles.

Reads the ``profile.jsonl`` journals the step profiler
(:mod:`torchx_tpu_torch.obs.profile`) appends under the obs session dirs
(``$TPX_OBS_DIR`` or ``~/.torchx_tpu/obs``) — no scheduler round-trips,
so it works long after the job is gone::

    tpx-torch profile                      # newest session with a profile
    tpx-torch profile tpx_ab12cd34         # a specific session dir
    tpx-torch profile path/to/profile.jsonl --json
    tpx-torch profile --diff run_a run_b   # before/after phase comparison

The default view is the phase timeline (per-phase seconds/fractions with
bars) plus the roofline/MFU and collective-overlap lines; ``--json``
emits the stable v1 summary schema; ``--diff`` compares two sessions
per-phase (tolerating disjoint phase sets — absent phases read as zero).
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional

from torchx_tpu_torch.cli.cmd_base import SubCommand


def _resolve(target: Optional[str], obs_dir: Optional[str]) -> str:
    """Resolve a CLI target to a profile-journal path.

    ``None`` -> the newest session dir under the obs root that contains a
    ``profile.jsonl``; an existing file -> itself; an existing dir -> its
    journal; anything else -> ``<obs root>/<target>/profile.jsonl``.
    Exits with a diagnostic when nothing resolves.
    """
    from torchx_tpu_torch.obs import sinks
    from torchx_tpu_torch.obs.profile import PROFILE_FILE

    root = obs_dir or sinks.obs_root()
    if target is None:
        candidates: list[tuple[float, str]] = []
        try:
            for name in os.listdir(root):
                path = os.path.join(root, name, PROFILE_FILE)
                if os.path.isfile(path):
                    candidates.append((os.path.getmtime(path), path))
        except OSError:
            pass
        if not candidates:
            print(f"no profiles recorded under {root}", file=sys.stderr)
            sys.exit(1)
        return max(candidates)[1]
    if os.path.isfile(target):
        return target
    if os.path.isdir(target):
        path = os.path.join(target, PROFILE_FILE)
    else:
        path = os.path.join(root, target, PROFILE_FILE)
    if not os.path.isfile(path):
        print(f"no profile found for: {target} ({path})", file=sys.stderr)
        sys.exit(1)
    return path


def _load_summary(target: Optional[str], obs_dir: Optional[str]) -> dict:
    from torchx_tpu_torch.obs import profile

    records = profile.load_profile(_resolve(target, obs_dir))
    return profile.summarize(records)


class CmdProfile(SubCommand):
    """Render step-profile journals (see module docstring)."""

    def add_arguments(self, subparser: argparse.ArgumentParser) -> None:
        subparser.add_argument(
            "session",
            nargs="?",
            default=None,
            help="session dir name, session path, or profile.jsonl path"
            " (default: the newest profiled session)",
        )
        subparser.add_argument(
            "--json",
            dest="json_out",
            action="store_true",
            help="emit the stable v1 summary schema instead of text",
        )
        subparser.add_argument(
            "--diff",
            nargs=2,
            metavar=("A", "B"),
            default=None,
            help="compare two sessions/journals per-phase (B - A)",
        )
        subparser.add_argument(
            "--obs-dir",
            default=None,
            help="obs root to search (default: $TPX_OBS_DIR or"
            " ~/.torchx_tpu/obs)",
        )

    def run(self, args: argparse.Namespace) -> None:
        import json

        from torchx_tpu_torch.obs import profile

        if args.diff is not None:
            a = _load_summary(args.diff[0], args.obs_dir)
            b = _load_summary(args.diff[1], args.obs_dir)
            d = profile.diff_summaries(a, b)
            if args.json_out:
                print(json.dumps(d, indent=2, sort_keys=True))
            else:
                print(profile.render_diff(d))
            return
        summary = _load_summary(args.session, args.obs_dir)
        if summary.get("steps", 0) == 0:
            print("profile journal has no step records", file=sys.stderr)
            sys.exit(1)
        if args.json_out:
            print(json.dumps(summary, indent=2, sort_keys=True))
        else:
            print(profile.render_summary(summary))
