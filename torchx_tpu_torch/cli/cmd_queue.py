"""``tpx-torch queue`` — the fleet scheduler's queue and placement view;
the port of :mod:`torchx_tpu.cli.cmd_queue`.

Asks the control daemon's ``/v1/queue`` for the scheduler snapshot:
queued gangs in scheduling order (priority class, fair share within the
class, FIFO), running placements (with shrink state), the modeled
fleet's inventory, and the preemption market's running totals. Finds the
daemon like every other proxied verb — ``$TPX_CONTROL_ADDR`` or the
discovery file (``require_env=False``, same as ``tpx-torch control`` status
checks).
"""

from __future__ import annotations

import argparse
import json
import sys

from torchx_tpu_torch.cli.cmd_base import SubCommand


class CmdQueue(SubCommand):
    def add_arguments(self, subparser: argparse.ArgumentParser) -> None:
        subparser.add_argument(
            "--json",
            action="store_true",
            help="print the raw /v1/queue snapshot as JSON",
        )

    def run(self, args: argparse.Namespace) -> None:
        from torchx_tpu_torch.control.client import ControlClientError, maybe_client

        try:
            client = maybe_client(require_env=False)
        except ControlClientError as e:
            print(f"queue: {e.message}", file=sys.stderr)
            sys.exit(1)
        if client is None:
            print(
                "queue: no control daemon found (start `tpx-torch control"
                " --fleet ...` or set TPX_CONTROL_ADDR)",
                file=sys.stderr,
            )
            sys.exit(1)
        try:
            snap = client.queue()
        except ControlClientError as e:
            print(f"queue: {e.message}", file=sys.stderr)
            sys.exit(1)
        if args.json:
            print(json.dumps(snap, indent=2, sort_keys=True))
            return
        if not snap.get("enabled"):
            print("queue: daemon is running without a fleet scheduler")
            return
        fleet = snap.get("fleet", {})
        market = snap.get("market", {})
        print(
            f"fleet: {fleet.get('chips_free')}/{fleet.get('chips_total')}"
            f" GPUs free | reshapes {market.get('reshapes', 0)}"
            f" growbacks {market.get('growbacks', 0)}"
            f" kills {market.get('kills', 0)}"
        )
        running = snap.get("running", [])
        print(f"running ({len(running)}):")
        for r in running:
            shrunk = (
                f" SHRUNK {r['replicas']}/{r['launch_replicas']}"
                if r.get("shrunk")
                else f" x{r['replicas']}"
            )
            print(
                f"  {r['job']:<10} {r['class']:<12} {r['tenant']:<12}"
                f"{shrunk}  {r['handle']}"
            )
        queued = snap.get("queue", [])
        print(f"queued ({len(queued)}):")
        for q in queued:
            note = " (quota)" if q.get("quota_blocked") else ""
            print(
                f"  #{q['position']:<3} {q['job']:<10} {q['class']:<12}"
                f" {q['tenant']:<12} x{q['replicas']}"
                f" ({q['chips']} GPUs, waited {q['waited_seconds']}s){note}"
            )
