"""``tpx-torch log`` — fan-out log tailing across replicas.

Port of :mod:`torchx_tpu.cli.cmd_log`; with ``$TPX_CONTROL_ADDR`` set the
plain attach path streams through the control daemon. Reference analog:
torchx/cli/cmd_log.py (211 LoC). Identifier grammar::

    SCHEDULER://[SESSION]/APP_ID[/ROLE[/REPLICA_IDS,..]]
"""

from __future__ import annotations

import argparse
import re
import sys

from torchx_tpu_torch.cli.cmd_base import SubCommand, control_client
from torchx_tpu_torch.runner.api import get_runner
from torchx_tpu_torch.util.log_tee_helpers import (
    LineEmitter,
    find_role_replicas,
    wait_for_app_started,
)

_ID_RE = re.compile(
    r"^(?P<scheduler>\w+)://(?P<session>[^/]*)/(?P<app_id>[^/]+)"
    r"(?:/(?P<role>[^/]+)(?:/(?P<replicas>[\d,]+))?)?$"
)


class CmdLog(SubCommand):
    def add_arguments(self, subparser: argparse.ArgumentParser) -> None:
        subparser.add_argument(
            "identifier", help="scheduler://session/app_id[/role[/replica,..]]"
        )
        subparser.add_argument("-t", "--tail", action="store_true", help="follow logs")
        subparser.add_argument("--regex", default=None, help="filter lines by regex")
        subparser.add_argument(
            "--since",
            default=None,
            help="window start: epoch seconds, relative (2h/30m/7d), or ISO time",
        )
        subparser.add_argument(
            "--until",
            default=None,
            help="window end: epoch seconds, relative (2h/30m/7d), or ISO time",
        )
        subparser.add_argument(
            "--streams",
            choices=["stdout", "stderr", "combined"],
            default=None,
            help="which stream to read (backend-dependent; default combined)",
        )

    def run(self, args: argparse.Namespace) -> None:
        m = _ID_RE.match(args.identifier)
        if not m:
            print(f"malformed identifier: {args.identifier}", file=sys.stderr)
            sys.exit(1)
        scheduler, session, app_id = (
            m.group("scheduler"),
            m.group("session"),
            m.group("app_id"),
        )
        role = m.group("role")
        replica_ids = (
            [int(r) for r in m.group("replicas").split(",")]
            if m.group("replicas")
            else None
        )
        from datetime import datetime

        from torchx_tpu_torch.schedulers.api import Stream
        from torchx_tpu_torch.util.times import parse_when

        try:
            since_ts = parse_when(args.since)
            until_ts = parse_when(args.until)
            since = (
                datetime.fromtimestamp(since_ts) if since_ts is not None else None
            )
            until = (
                datetime.fromtimestamp(until_ts) if until_ts is not None else None
            )
        except (ValueError, OverflowError, OSError) as e:
            print(f"cannot parse time window: {e}", file=sys.stderr)
            sys.exit(1)
        streams = Stream(args.streams) if args.streams else None

        app_handle = f"{scheduler}://{session}/{app_id}"
        client = control_client()
        if client is not None and not (since or until or args.regex or streams):
            # daemon mode handles the plain attach path; windowed /
            # filtered / stream-selected reads stay direct (those options
            # ride scheduler-specific machinery the daemon doesn't proxy)
            self._run_proxied(client, app_handle, role, replica_ids, args)
            return
        with get_runner() as runner:
            status = wait_for_app_started(runner, app_handle)
            if status is None:
                print(f"app not found: {app_handle}", file=sys.stderr)
                sys.exit(1)
            pairs = find_role_replicas(status, role)
            if replica_ids is not None:
                pairs = [(r, i) for r, i in pairs if i in replica_ids]
            if not pairs:
                print("no matching replicas", file=sys.stderr)
                sys.exit(1)
            replicas: dict[str, list[int]] = {}
            for r, i in pairs:
                replicas.setdefault(r, []).append(i)
            # concurrent fan-out with a line-atomic emitter: streams are
            # read in parallel (runner.log_lines_multi pump threads) and
            # every emitted line is one complete write — no interleaved
            # partial lines under load
            emitter = LineEmitter(sys.stdout)
            for r, i, line in runner.log_lines_multi(
                app_handle,
                replicas,
                regex=args.regex,
                since=since,
                until=until,
                should_tail=args.tail,
                streams=streams,
            ):
                emitter.emit(f"{r}/{i}", line)

    def _run_proxied(
        self,
        client,  # noqa: ANN001
        app_handle: str,
        role: str,
        replica_ids,  # noqa: ANN001
        args: argparse.Namespace,
    ) -> None:
        """Log attach through the control daemon: resolve role/replica
        pairs from the daemon's status payload, then stream each replica's
        JSONL log feed."""
        from torchx_tpu_torch.control.client import ControlClientError

        try:
            status = client.status(app_handle)
        except ControlClientError as e:
            if e.code == 404:
                print(f"app not found: {app_handle}", file=sys.stderr)
            else:
                print(f"control: {e.message}", file=sys.stderr)
            sys.exit(1)
        pairs = []
        for r in status.get("roles", []):
            if role and r.get("role") != role:
                continue
            for rid in r.get("replicas", []):
                if replica_ids is not None and rid not in replica_ids:
                    continue
                pairs.append((r.get("role", "app"), rid))
        if not pairs:
            print("no matching replicas", file=sys.stderr)
            sys.exit(1)
        try:
            for r, rid in pairs:
                for line in client.log_lines(
                    app_handle, r, k=rid, tail=args.tail
                ):
                    print(f"{r}/{rid} {line}")
        except ControlClientError as e:
            print(f"control: {e.message}", file=sys.stderr)
            sys.exit(1)
