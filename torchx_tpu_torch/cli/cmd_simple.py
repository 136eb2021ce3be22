"""Thin Runner-wrapper subcommands: status / describe / list / cancel /
delete / resize / watch / runopts / builtins / configure.

Port of :mod:`torchx_tpu.cli.cmd_simple`. With ``$TPX_CONTROL_ADDR`` set,
``status``, ``list`` and ``cancel`` go through the control daemon
(:func:`~torchx_tpu_torch.cli.cmd_base.control_client`).

Reference analog: torchx/cli/cmd_*.py (~400 LoC combined).
"""

from __future__ import annotations

import argparse
import json
import sys

from torchx_tpu_torch.cli.cmd_base import SubCommand, control_client
from torchx_tpu_torch.runner import config as tpx_config
from torchx_tpu_torch.runner.api import get_runner


class CmdStatus(SubCommand):
    def add_arguments(self, subparser: argparse.ArgumentParser) -> None:
        subparser.add_argument("app_handle", help="scheduler://session/app_id")

    def run(self, args: argparse.Namespace) -> None:
        client = control_client()
        if client is not None:
            self._run_proxied(client, args)
            return
        from torchx_tpu_torch.util.colors import supports_color

        with get_runner() as runner:
            status = runner.status(args.app_handle)
            if status is None:
                print(f"app not found: {args.app_handle}", file=sys.stderr)
                sys.exit(1)
            print(status.format(colored=supports_color()))

    def _run_proxied(self, client, args: argparse.Namespace) -> None:  # noqa: ANN001
        from torchx_tpu_torch.control.client import ControlClientError

        try:
            st = client.status(args.app_handle)
        except ControlClientError as e:
            if e.code == 404:
                print(f"app not found: {args.app_handle}", file=sys.stderr)
            else:
                print(f"control: {e.message}", file=sys.stderr)
            sys.exit(1)
        line = f"{st.get('handle', args.app_handle)}: {st.get('state')}"
        if st.get("failure_class"):
            line += f" ({st['failure_class']})"
        print(line)
        if st.get("msg"):
            print(st["msg"])


class CmdDescribe(SubCommand):
    def add_arguments(self, subparser: argparse.ArgumentParser) -> None:
        subparser.add_argument("app_handle", help="scheduler://session/app_id")

    def run(self, args: argparse.Namespace) -> None:
        with get_runner() as runner:
            app = runner.describe(args.app_handle)
            if app is None:
                print(f"app not found: {args.app_handle}", file=sys.stderr)
                sys.exit(1)
            print(json.dumps({"name": app.name, "roles": [r.name for r in app.roles]}, indent=2))


class CmdList(SubCommand):
    def add_arguments(self, subparser: argparse.ArgumentParser) -> None:
        subparser.add_argument(
            "-s",
            "--scheduler",
            default=None,
            help="scheduler backend to list (default: every backend,"
            " queried concurrently)",
        )

    def run(self, args: argparse.Namespace) -> None:
        client = control_client()
        if client is not None:
            from torchx_tpu_torch.control.client import ControlClientError

            try:
                if args.scheduler:
                    for app in client.list(args.scheduler):
                        print(f"{app.get('app_id')}\t{app.get('state')}")
                else:
                    # fleet view straight from the daemon's journal — no
                    # backend round-trips at all
                    for app in client.list():
                        print(
                            f"{app.get('scheduler')}\t{app.get('app_id')}"
                            f"\t{app.get('state')}"
                        )
            except ControlClientError as e:
                print(f"control: {e.message}", file=sys.stderr)
                sys.exit(1)
            return
        with get_runner() as runner:
            if args.scheduler:
                for app in runner.list(args.scheduler):
                    print(f"{app.app_id}\t{app.state}\t{app.name}")
                return
            # no -s: fan out across every backend; results print in
            # registry order, one line per app prefixed by the backend,
            # and an unreachable backend degrades to a stderr note
            results, errors = runner.list_all()
            for name, apps in results.items():
                for app in apps:
                    print(f"{name}\t{app.app_id}\t{app.state}\t{app.name}")
            for name, err in errors.items():
                print(f"{name}: <unavailable: {err}>", file=sys.stderr)


class CmdCancel(SubCommand):
    def add_arguments(self, subparser: argparse.ArgumentParser) -> None:
        subparser.add_argument("app_handle")

    def run(self, args: argparse.Namespace) -> None:
        client = control_client()
        if client is not None:
            from torchx_tpu_torch.control.client import ControlClientError

            try:
                client.cancel(args.app_handle)
            except ControlClientError as e:
                print(f"control: {e.message}", file=sys.stderr)
                sys.exit(1)
            print(f"cancelled {args.app_handle}")
            return
        with get_runner() as runner:
            runner.cancel(args.app_handle)
            print(f"cancelled {args.app_handle}")


class CmdDelete(SubCommand):
    def add_arguments(self, subparser: argparse.ArgumentParser) -> None:
        subparser.add_argument("app_handle")

    def run(self, args: argparse.Namespace) -> None:
        with get_runner() as runner:
            runner.delete(args.app_handle)
            print(f"deleted {args.app_handle}")


class CmdResize(SubCommand):
    """Resize a running role's gang: `tpx-torch resize <handle> <role> <n>`
    (n in AppDef units — slices for GPU roles). The gang restarts with a
    coherent world size and resumes from its checkpoint."""

    def add_arguments(self, subparser: argparse.ArgumentParser) -> None:
        subparser.add_argument("app_handle")
        subparser.add_argument("role_name")
        subparser.add_argument("num_replicas", type=int)

    def run(self, args: argparse.Namespace) -> None:
        with get_runner() as runner:
            try:
                runner.resize(args.app_handle, args.role_name, args.num_replicas)
            except (ValueError, NotImplementedError) as e:
                # terminal app, unknown role, or a backend without resize:
                # an operator mistake, not a stack trace
                print(f"error: {e}", file=sys.stderr)
                sys.exit(1)
            print(
                f"resized {args.app_handle}/{args.role_name}"
                f" to {args.num_replicas}"
            )


class CmdWatch(SubCommand):
    """Failure-driven elastic controller: `tpx-torch watch <handle>` observes a
    running app and auto-shrinks roles with a min_replicas floor when
    slices fail (the operator-side analog of the local scheduler's elastic
    restart). Blocks until the app terminates or the budget is spent."""

    def add_arguments(self, subparser: argparse.ArgumentParser) -> None:
        subparser.add_argument("app_handle")
        subparser.add_argument(
            "--interval", type=float, default=10.0, help="poll seconds"
        )
        subparser.add_argument(
            "--timeout", type=float, default=None, help="give up after seconds"
        )
        subparser.add_argument(
            "--max-restarts", type=int, default=3, help="shrink budget"
        )

    def run(self, args: argparse.Namespace) -> None:
        with get_runner() as runner:
            n = runner.watch_elastic(
                args.app_handle,
                poll_interval=args.interval,
                timeout=args.timeout,
                max_restarts=args.max_restarts,
            )
            print(f"watch done: {n} elastic shrink-restart(s)")


class CmdRunopts(SubCommand):
    def add_arguments(self, subparser: argparse.ArgumentParser) -> None:
        subparser.add_argument(
            "scheduler", nargs="?", default=None, help="show only this scheduler"
        )

    def run(self, args: argparse.Namespace) -> None:
        with get_runner() as runner:
            names = [args.scheduler] if args.scheduler else runner.scheduler_backends()
            for name in names:
                print(f"{name}:")
                try:
                    print(runner.scheduler_run_opts(name))
                except Exception as e:  # noqa: BLE001 - optional backend deps
                    print(f"    <unavailable: {e}>")
                print()


class CmdBuiltins(SubCommand):
    def add_arguments(self, subparser: argparse.ArgumentParser) -> None:
        subparser.add_argument(
            "--print", dest="print_component", default=None, help="print component source"
        )

    def run(self, args: argparse.Namespace) -> None:
        from torchx_tpu_torch.specs.finder import get_builtin_source, get_components

        if args.print_component:
            print(get_builtin_source(args.print_component))
            return
        components = get_components()
        print(f"Found {len(components)} builtin components:")
        for name, c in sorted(components.items()):
            print(f"  {name} - {c.description}")


class CmdConfigure(SubCommand):
    def add_arguments(self, subparser: argparse.ArgumentParser) -> None:
        subparser.add_argument(
            "-s",
            "--schedulers",
            default=None,
            help="comma list of schedulers to emit sections for (default: all)",
        )
        subparser.add_argument(
            "--required_only", action="store_true", help="only required options"
        )

    def run(self, args: argparse.Namespace) -> None:
        with get_runner() as runner:
            names = (
                args.schedulers.split(",")
                if args.schedulers
                else runner.scheduler_backends()
            )
            opts = {}
            for name in names:
                try:
                    opts[name] = runner.scheduler_run_opts(name)
                except Exception:  # noqa: BLE001
                    continue
            with open(tpx_config.CONFIG_FILE, "w") as f:
                tpx_config.dump(f, opts, required_only=args.required_only)
            print(f"wrote {tpx_config.CONFIG_FILE}")
