"""``tpx-torch run`` — materialize a component and submit it.

Port of :mod:`torchx_tpu.cli.cmd_run`. The analyzer is not ported yet
(ROADMAP queue 1 item 2.8), so the runner's lint gate raises
:class:`NotImplementedError` unless ``--no-lint`` (or ``$TPX_NO_LINT``)
passes it; the command prints that as one error line and exits 1, where
the JAX command prints a ``LintError``. With ``$TPX_CONTROL_ADDR`` set,
submit, wait and log go through the control daemon.

Reference analog: torchx/cli/cmd_run.py (505 LoC): component + args parsing
(with default component from .tpxconfig ``[cli:run]``), ``--dryrun``
printing the AppDef and materialized scheduler request, ``--wait`` /
``--log`` streaming, and auto-wait for local runs.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys

from torchx_tpu_torch.cli.cmd_base import SubCommand, control_client
from torchx_tpu_torch.runner import config as tpx_config
from torchx_tpu_torch.runner.api import Runner, get_runner
from torchx_tpu_torch.specs.finder import (
    ComponentNotFoundException,
    ComponentValidationException,
)

logger = logging.getLogger(__name__)


class CmdRun(SubCommand):
    def add_arguments(self, subparser: argparse.ArgumentParser) -> None:
        subparser.add_argument(
            "-s",
            "--scheduler",
            type=str,
            default=None,
            help="scheduler backend to submit to (default: first registered)",
        )
        subparser.add_argument(
            "-cfg",
            "--scheduler_args",
            type=str,
            default="",
            help="scheduler run config as comma-separated k=v pairs",
        )
        subparser.add_argument(
            "--dryrun",
            action="store_true",
            help="print the materialized AppDef and scheduler request, do not submit",
        )
        subparser.add_argument(
            "--wait",
            action="store_true",
            help="block until the app reaches a terminal state",
        )
        subparser.add_argument(
            "--log",
            action="store_true",
            help="stream all replica logs (implies --wait)",
        )
        subparser.add_argument(
            "--workspace",
            type=str,
            default=None,
            help="local workspace to package into the job image",
        )
        subparser.add_argument(
            "--parent_run_id", type=str, default=None, help="tracker parent run id"
        )
        subparser.add_argument(
            "--no-lint",
            action="store_true",
            help="skip the preflight analyzer gate (not ported yet: without this"
            " flag or $TPX_NO_LINT the run stops at the gate)",
        )
        subparser.add_argument(
            "--stdin",
            action="store_true",
            help="read an AppDef JSON job spec from stdin instead of a"
            " component (see torchx_tpu_torch.specs.serialize)",
        )
        subparser.add_argument(
            "conf_args",
            nargs=argparse.REMAINDER,
            help="component name followed by its arguments"
            " (e.g. dist.spmd -j 1x4 --script train.py)",
        )

    def run(self, args: argparse.Namespace) -> None:
        if not args.dryrun and not args.stdin:
            client = control_client()
            if client is not None:
                # daemon mode: submit/wait/log ride the control plane;
                # --dryrun and --stdin stay direct (they need the local
                # materialization machinery, not a running scheduler)
                self._run_proxied(client, args)
                return
        with get_runner(component_defaults=tpx_config.load_sections("component")) as runner:
            self._run(runner, args)

    def _run_proxied(self, client, args: argparse.Namespace) -> None:  # noqa: ANN001
        from torchx_tpu_torch.control.client import ControlClientError

        scheduler = args.scheduler
        if scheduler is None:
            from torchx_tpu_torch.schedulers import get_default_scheduler_name

            scheduler = (
                tpx_config.get_config("cli", "run", "scheduler")
                or get_default_scheduler_name()
            )
        component, component_args = self._parse_component(args.conf_args)
        try:
            app_handle = client.submit(
                component,
                component_args,
                scheduler,
                cfg_str=args.scheduler_args,
                workspace=args.workspace,
            )
        except ControlClientError as e:
            print(f"error: {e.message}", file=sys.stderr)
            if args.no_lint:
                # the daemon lints its submits itself: --no-lint stays here
                print(
                    "error: --no-lint does not reach the control daemon; start"
                    " `tpx-torch control` with TPX_NO_LINT=1 (until the"
                    " analyzer lands, ROADMAP item 2.8)",
                    file=sys.stderr,
                )
            sys.exit(1)
        print(app_handle)
        if not (args.wait or args.log or scheduler == "local"):
            return
        try:
            final = client.wait(app_handle)
        except KeyboardInterrupt:
            logger.warning("ctrl-c: cancelling %s", app_handle)
            client.cancel(app_handle)
            raise
        if args.log:
            # terminal logs, attached through the daemon, one role/replica
            # at a time (the direct path's live tee needs scheduler access)
            for role in final.get("roles", []):
                for rid in role.get("replicas", []):
                    for line in client.log_lines(
                        app_handle, role.get("role", "app"), k=rid
                    ):
                        print(f"{role.get('role')}/{rid} {line}")
        state = final.get("state")
        line = f"{app_handle}: {state}"
        if final.get("failure_class"):
            line += f" ({final['failure_class']})"
        print(line)
        if state != "SUCCEEDED":
            sys.exit(1)

    def _run(self, runner: Runner, args: argparse.Namespace) -> None:
        from torchx_tpu_torch.obs import trace as obs_trace

        # one root span over submit + wait, so `tpx-torch run --wait` leaves a
        # single trace instead of one per Runner call
        with obs_trace.span("tpx.run", session=runner._name):
            self._run_traced(runner, args)

    def _run_traced(self, runner: Runner, args: argparse.Namespace) -> None:
        scheduler = args.scheduler
        if scheduler is None:
            from torchx_tpu_torch.schedulers import get_default_scheduler_name

            scheduler = (
                tpx_config.get_config("cli", "run", "scheduler")
                or get_default_scheduler_name()
            )

        cfg = runner.scheduler_run_opts(scheduler).cfg_from_str(args.scheduler_args)
        tpx_config.apply(scheduler, cfg)

        if args.stdin:
            leftover = [a for a in args.conf_args if a != "--"]
            if leftover:
                print(
                    f"error: --stdin reads the job spec from stdin; remove"
                    f" the component arguments {leftover!r}",
                    file=sys.stderr,
                )
                sys.exit(1)
            self._run_from_stdin(runner, args, scheduler, cfg)
            return

        component, component_args = self._parse_component(args.conf_args)

        try:
            if args.dryrun:
                dryrun_info = runner.dryrun_component(
                    component,
                    component_args,
                    scheduler,
                    cfg,
                    workspace=args.workspace,
                    parent_run_id=args.parent_run_id,
                    no_lint=args.no_lint,
                )
                print("=== APPLICATION ===")
                print(_pretty_app(dryrun_info._app))
                print("=== SCHEDULER REQUEST ===")
                print(dryrun_info)
                return
            app_handle = runner.run_component(
                component,
                component_args,
                scheduler,
                cfg,
                workspace=args.workspace,
                parent_run_id=args.parent_run_id,
                no_lint=args.no_lint,
            )
        except NotImplementedError as e:  # the lint gate: item 2.8
            print(f"error: {e}", file=sys.stderr)
            sys.exit(1)
        except (ComponentValidationException, ComponentNotFoundException) as e:
            print(f"error: {e}", file=sys.stderr)
            sys.exit(1)
        except ValueError as e:
            # component functions raise ValueError for bad arg combinations
            # (e.g. malformed -j); show it cleanly, not as a traceback
            print(f"error: {e}", file=sys.stderr)
            sys.exit(1)

        print(app_handle)
        self._maybe_wait(runner, args, scheduler, app_handle)

    def _run_from_stdin(self, runner: Runner, args, scheduler: str, cfg) -> None:  # noqa: ANN001
        from torchx_tpu_torch.specs.serialize import appdef_from_dict

        try:
            app = appdef_from_dict(json.load(sys.stdin))
        except (json.JSONDecodeError, ValueError, KeyError, TypeError, AttributeError) as e:
            print(f"error: invalid job spec on stdin: {e}", file=sys.stderr)
            sys.exit(1)
        try:
            if args.dryrun:
                info = runner.dryrun(
                    app,
                    scheduler,
                    cfg,
                    workspace=args.workspace,
                    parent_run_id=args.parent_run_id,
                    no_lint=args.no_lint,
                )
                print("=== APPLICATION ===")
                print(_pretty_app(info._app))
                print("=== SCHEDULER REQUEST ===")
                print(info)
                return
            handle = runner.run(
                app,
                scheduler,
                cfg,
                workspace=args.workspace,
                parent_run_id=args.parent_run_id,
                no_lint=args.no_lint,
            )
        except (NotImplementedError, ValueError) as e:
            print(f"error: {e}", file=sys.stderr)
            sys.exit(1)
        print(handle)
        self._maybe_wait(runner, args, scheduler, handle)

    def _maybe_wait(self, runner: Runner, args, scheduler: str, app_handle: str) -> None:  # noqa: ANN001
        """Local runs auto-wait (ctrl-c cleans up children); --wait/--log
        force it elsewhere (reference cmd_run.py:321-324)."""
        if not (args.wait or args.log or scheduler == "local"):
            return
        log_thread = None
        if args.log:
            from torchx_tpu_torch.util.log_tee_helpers import tee_logs

            log_thread = tee_logs(runner, app_handle, should_tail=True)
        try:
            status = runner.wait(app_handle, wait_interval=1)
        except KeyboardInterrupt:
            logger.warning("ctrl-c: cancelling %s", app_handle)
            runner.cancel(app_handle)
            raise
        if log_thread is not None:
            log_thread.join(timeout=10)
        if status is None:
            print("job not found while waiting", file=sys.stderr)
            sys.exit(1)
        print(status.format())
        if status.state.name != "SUCCEEDED":
            sys.exit(1)

    def _parse_component(self, conf_args: list[str]) -> tuple[str, list[str]]:
        """First positional is the component name; a missing name falls back
        to .tpxconfig [cli:run] component= (reference cmd_run.py:120-180)."""
        if conf_args and conf_args[0] == "--":
            conf_args = conf_args[1:]
        if not conf_args or conf_args[0].startswith("-"):
            default = tpx_config.get_config("cli", "run", "component")
            if not default:
                print(
                    "error: no component specified and no default component"
                    " configured in .tpxconfig [cli:run]",
                    file=sys.stderr,
                )
                sys.exit(1)
            return default, conf_args
        return conf_args[0], conf_args[1:]


def _pretty_app(app) -> str:  # noqa: ANN001
    if app is None:
        return "<none>"
    out = {
        "name": app.name,
        "roles": [
            {
                "name": r.name,
                "image": r.image,
                "entrypoint": r.entrypoint,
                "args": r.args,
                "env": r.env,
                "num_replicas": r.num_replicas,
                "resource": {
                    "cpu": r.resource.cpu,
                    "memMB": r.resource.memMB,
                    "gpu": str(r.resource.gpu) if r.resource.gpu else None,
                },
            }
            for r in app.roles
        ],
    }
    return json.dumps(out, indent=2)
