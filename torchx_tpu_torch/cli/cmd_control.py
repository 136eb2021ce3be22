"""``tpx-torch control`` — run the control-plane daemon (foreground); the
port of :mod:`torchx_tpu.cli.cmd_control`.

Starts the multi-tenant daemon (:mod:`torchx_tpu_torch.control.daemon`): one
process owning the Runner, every watch stream, and the sharded job-state
store, serving submit/status/list/cancel/wait/log over localhost JSON.
Point other shells at it with::

    export TPX_CONTROL_ADDR=<printed addr>

(the bearer token is read from the daemon's 0600 discovery file, or set
``TPX_CONTROL_TOKEN`` explicitly) and every ``tpx-torch`` verb proxies through
the daemon instead of driving schedulers directly.
"""

from __future__ import annotations

import argparse
import sys

from torchx_tpu_torch.cli.cmd_base import SubCommand


class CmdControl(SubCommand):
    def add_arguments(self, subparser: argparse.ArgumentParser) -> None:
        subparser.add_argument(
            "--host", default="127.0.0.1", help="bind address (loopback only)"
        )
        subparser.add_argument(
            "--port", type=int, default=0, help="bind port (0 = OS-assigned)"
        )
        subparser.add_argument(
            "--state-dir",
            default=None,
            help="discovery file + job-state store root"
            " (default $TPX_CONTROL_DIR, else ~/.torchx_tpu_torch/control)",
        )
        subparser.add_argument(
            "--tenant-cap",
            type=int,
            default=None,
            help="max concurrently active jobs per tenant (429 past it)",
        )
        subparser.add_argument(
            "--print-token",
            action="store_true",
            help="also print the root token (it is always in the 0600"
            " discovery file; printing it puts it in scrollback)",
        )
        subparser.add_argument(
            "--fleet",
            default=None,
            metavar="SPEC",
            help="enable the fleet scheduler on this modeled fleet, e.g."
            " 'default:h100-8x4,big:h100-16x2' (name:gen-GPUSxCOUNT,...: four"
            " 8-GPU hosts and two 2-host units of 16); submits then"
            " queue/place/preempt instead of 429ing",
        )
        subparser.add_argument(
            "--fleet-quota",
            action="append",
            default=None,
            metavar="TENANT=GPUS",
            help="per-tenant GPU quota for the fleet scheduler"
            " (repeatable; tenants without one are unlimited)",
        )
        subparser.add_argument(
            "--slo",
            action="append",
            default=None,
            metavar="SPEC",
            help="SLO spec the telemetry plane evaluates as burn rates"
            " (repeatable): name:metric<thresh@obj,"
            " name:metric{k=v}/metric@obj, or a preset"
            " (p99-ttft, goodput, step-time, gang-wait)",
        )
        subparser.add_argument(
            "--scrape-interval",
            type=float,
            default=None,
            metavar="SECONDS",
            help="telemetry collector cycle"
            " (default $TPX_TELEMETRY_INTERVAL or 5s)",
        )
        subparser.add_argument(
            "--cell",
            default=None,
            metavar="NAME",
            help="federation cell name this daemon answers as"
            " (default $TPX_CELL or 'default'); the federation layer that"
            " routes across cells comes with ROADMAP queue 1 item 2.8",
        )

    def run(self, args: argparse.Namespace) -> None:
        from torchx_tpu_torch.control.daemon import ControlDaemon, control_dir

        fleet = None
        if args.fleet:
            from torchx_tpu_torch.fleet.api import FleetScheduler, parse_quotas
            from torchx_tpu_torch.fleet.model import FleetModel

            fleet = FleetScheduler(
                FleetModel.from_spec(args.fleet),
                state_dir=args.state_dir or control_dir(),
                quotas=parse_quotas(args.fleet_quota),
            )
        daemon = ControlDaemon(
            host=args.host,
            port=args.port,
            state_dir=args.state_dir,
            tenant_cap=args.tenant_cap,
            fleet=fleet,
            slos=args.slo,
            scrape_interval=args.scrape_interval,
            cell=args.cell,
        )
        recovered = len(daemon.store)
        print(
            f"tpx-torch control: serving on {daemon.addr}"
            f" (cell {daemon.cell}, state {daemon.state_dir},"
            f" {recovered} jobs rehydrated)",
            flush=True,
        )
        if fleet is not None:
            snap = fleet.queue_snapshot()
            print(
                f"  fleet: {snap['fleet']['chips_total']} GPUs in"
                f" {len(snap['fleet']['pools'])} pool(s),"
                f" {len(snap['queue'])} queued /"
                f" {len(snap['running'])} running rehydrated",
                flush=True,
            )
        if daemon.slo_engine is not None and daemon.slo_engine.specs:
            print(
                "  slo: "
                + ", ".join(s.name for s in daemon.slo_engine.specs),
                flush=True,
            )
        print(f"  export TPX_CONTROL_ADDR={daemon.addr}", flush=True)
        if args.print_token:
            print(f"  export TPX_CONTROL_TOKEN={daemon.root_token}", flush=True)
        try:
            daemon.serve_forever()
        except KeyboardInterrupt:
            print("tpx-torch control: shutting down", file=sys.stderr)
            daemon.close()
