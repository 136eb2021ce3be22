"""``tpx-torch supervise`` — run a component under the preemption-aware
supervisor.

Port of :mod:`torchx_tpu.cli.cmd_supervise`. ``tpx-torch run`` submits and
walks away; ``tpx-torch supervise`` submits and stays: it watches the app
to a terminal state, classifies the failure (preemption / infra / app),
and auto-resubmits within per-class retry budgets with capped exponential
backoff, injecting the latest checkpoint step (``--checkpoint-dir``) so
each attempt resumes instead of restarting from scratch. This is the
intended way to train on preemptible GPU capacity::

    tpx-torch supervise --no-lint -s local --checkpoint-dir /ckpt/run1 \\
        --max-preemptions 16 dist.spmd --gpu h100-8 \\
        -m torchx_tpu_torch.examples.train_llama -- --ckpt-dir /ckpt/run1

The analyzer is not ported yet (ROADMAP queue 1 item 2.8): ``--no-lint``
(or ``$TPX_NO_LINT``) passes the runner's lint gate, which otherwise
stops the command with one error line.

Policy comes from ``--policy policy.json``
(:func:`~torchx_tpu_torch.specs.serialize.supervisor_policy_from_dict`) with
individual flags overriding file values.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys

from torchx_tpu_torch.cli.cmd_base import SubCommand
from torchx_tpu_torch.cli.cmd_run import CmdRun
from torchx_tpu_torch.obs import trace as obs_trace
from torchx_tpu_torch.runner import config as tpx_config
from torchx_tpu_torch.runner.api import Runner, get_runner
from torchx_tpu_torch.specs.finder import (
    ComponentNotFoundException,
    ComponentValidationException,
)

logger = logging.getLogger(__name__)


class CmdSupervise(SubCommand):
    """Submit a component and babysit it to success (see module docstring)."""

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
            " flag or $TPX_NO_LINT the command stops at the gate)",
        )
        subparser.add_argument(
            "--policy",
            type=str,
            default=None,
            help="JSON file with SupervisorPolicy fields; flags below"
            " override file values",
        )
        subparser.add_argument(
            "--max-preemptions",
            type=int,
            default=None,
            help="resubmits allowed after preemptions (default 8)",
        )
        subparser.add_argument(
            "--max-infra-retries",
            type=int,
            default=None,
            help="resubmits allowed after infra failures (default 3)",
        )
        subparser.add_argument(
            "--max-retries",
            type=int,
            default=None,
            help="resubmits allowed after application failures (default 0:"
            " app bugs fail deterministically)",
        )
        subparser.add_argument(
            "--backoff",
            type=float,
            default=None,
            help="initial resubmit backoff in seconds (default 5; doubles"
            " per consecutive retry, capped at --backoff-max)",
        )
        subparser.add_argument(
            "--backoff-max",
            type=float,
            default=None,
            help="ceiling on a single backoff delay in seconds (default 300)",
        )
        subparser.add_argument(
            "--poll-interval",
            type=float,
            default=None,
            help="cap on the jittered status poll interval (default 10s)",
        )
        subparser.add_argument(
            "--checkpoint-dir",
            type=str,
            default=None,
            help="checkpoint dir to read the latest step from; injected as"
            " TPX_RESUME_STEP on every resubmit",
        )
        subparser.add_argument(
            "--elastic",
            action="store_true",
            default=None,
            help="run the backend's elastic watcher during each attempt",
        )
        subparser.add_argument(
            "--poll-miss-budget",
            type=int,
            default=None,
            help="consecutive transient status-poll failures absorbed"
            " (as poll_degraded warnings) before surfacing (default 3)",
        )
        subparser.add_argument(
            "--hang-deadline",
            type=float,
            default=None,
            help="seconds without heartbeats/leases before the gang counts"
            " as hung (kill + classify HANG + resubmit; default 0: off)",
        )
        subparser.add_argument(
            "--gang-check-interval",
            type=float,
            default=None,
            help="seconds between gang-health checks while an attempt runs"
            " (default 5)",
        )
        subparser.add_argument(
            "--lease-ttl",
            type=float,
            default=None,
            help="liveness-lease TTL in seconds (default: the hang deadline)",
        )
        subparser.add_argument(
            "--straggler-step-lag",
            type=int,
            default=None,
            help="warn when replicas drift more than this many steps apart"
            " (default 0: off)",
        )
        subparser.add_argument(
            "--max-hang-retries",
            type=int,
            default=None,
            help="resubmits allowed after gang hangs (default 2)",
        )
        subparser.add_argument(
            "--elastic-reshape",
            action="store_true",
            default=None,
            help="after PREEMPTION/HANG, shrink the mesh's data axes to the"
            " surviving capacity and resubmit with $TPX_MESH (needs --mesh)",
        )
        subparser.add_argument(
            "--mesh",
            type=str,
            default=None,
            help="the job's launch mesh spec (pp/dp/fsdp/ep/tp/sp, e.g."
            " dp=2,fsdp=-1); the basis --elastic-reshape degrades from",
        )
        subparser.add_argument(
            "--devices-per-replica",
            type=int,
            default=None,
            help="accelerator devices each replica contributes to the mesh"
            " (default 1)",
        )
        subparser.add_argument(
            "--session",
            type=str,
            default=None,
            help="name for the durable supervision session (default:"
            " auto-generated; shown on start for --resume)",
        )
        subparser.add_argument(
            "--resume",
            type=str,
            default=None,
            metavar="SESSION",
            help="reattach to a crashed supervise session: restore its"
            " attempt/retry state from the on-disk ledger and keep"
            " watching the live attempt instead of resubmitting",
        )
        subparser.add_argument(
            "conf_args",
            nargs=argparse.REMAINDER,
            help="component name followed by its arguments"
            " (e.g. dist.spmd -j 1x4 --script train.py)",
        )

    def _build_policy(self, args: argparse.Namespace):  # noqa: ANN202
        from torchx_tpu_torch.specs.serialize import supervisor_policy_from_dict
        from torchx_tpu_torch.supervisor.policy import SupervisorPolicy

        if args.policy:
            with open(args.policy) as f:
                policy = supervisor_policy_from_dict(json.load(f))
        else:
            policy = SupervisorPolicy()
        overrides = {
            "max_preemptions": args.max_preemptions,
            "max_infra_retries": args.max_infra_retries,
            "max_app_retries": args.max_retries,
            "backoff_seconds": args.backoff,
            "backoff_max_seconds": args.backoff_max,
            "poll_interval": args.poll_interval,
            "checkpoint_dir": args.checkpoint_dir,
            "elastic": args.elastic,
            "poll_miss_budget": args.poll_miss_budget,
            "hang_deadline_seconds": args.hang_deadline,
            "gang_check_interval": args.gang_check_interval,
            "lease_ttl_seconds": args.lease_ttl,
            "straggler_step_lag": args.straggler_step_lag,
            "max_hang_retries": args.max_hang_retries,
            "elastic_reshape": args.elastic_reshape,
            "mesh": args.mesh,
            "devices_per_replica": args.devices_per_replica,
        }
        for name, value in overrides.items():
            if value is not None:
                setattr(policy, name, value)
        policy.__post_init__()  # re-validate after overrides
        return policy

    def run(self, args: argparse.Namespace) -> None:
        with get_runner(
            component_defaults=tpx_config.load_sections("component")
        ) as runner:
            self._run(runner, args)

    def _run(self, runner: Runner, args: argparse.Namespace) -> None:
        # one root span over dryrun + supervise: every attempt, backoff,
        # and in-job heartbeat lands in a single trace
        with obs_trace.span("tpx.supervise", session=runner._name):
            self._run_traced(runner, args)

    def _run_traced(self, runner: Runner, args: argparse.Namespace) -> None:
        if args.resume:
            self._run_resume(runner, args)
            return
        scheduler = args.scheduler
        if scheduler is None:
            from torchx_tpu_torch.schedulers import get_default_scheduler_name

            scheduler = (
                tpx_config.get_config("cli", "run", "scheduler")
                or get_default_scheduler_name()
            )
        cfg = runner.scheduler_run_opts(scheduler).cfg_from_str(args.scheduler_args)
        tpx_config.apply(scheduler, cfg)

        component, component_args = CmdRun()._parse_component(args.conf_args)
        try:
            policy = self._build_policy(args)
            dryrun_info = runner.dryrun_component(
                component,
                component_args,
                scheduler,
                cfg,
                workspace=args.workspace,
                parent_run_id=args.parent_run_id,
                no_lint=args.no_lint,
            )
        except (
            ComponentValidationException,
            ComponentNotFoundException,
            OSError,
            json.JSONDecodeError,
            NotImplementedError,  # the lint gate: item 2.8
        ) as e:
            print(f"error: {e}", file=sys.stderr)
            sys.exit(1)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            sys.exit(1)

        try:
            result = runner.supervise(dryrun_info, policy, session=args.session)
        except KeyboardInterrupt:
            logger.warning("ctrl-c: supervisor stopped; the current attempt"
                           " keeps running (cancel it with `tpx-torch cancel`)")
            raise
        self._report(result)

    def _run_resume(self, runner: Runner, args: argparse.Namespace) -> None:
        from torchx_tpu_torch.supervisor.api import Supervisor

        try:
            supervisor = Supervisor.resume(runner, args.resume)
        except (FileNotFoundError, ValueError, KeyError) as e:
            print(f"error: {e}", file=sys.stderr)
            sys.exit(1)
        print(f"session: {supervisor.session} (reattaching)")
        try:
            result = supervisor.run()
        except KeyboardInterrupt:
            logger.warning("ctrl-c: supervisor stopped; the current attempt"
                           " keeps running (cancel it with `tpx-torch cancel`)")
            raise
        self._report(result)

    def _report(self, result) -> None:  # noqa: ANN001
        if result.session:
            print(
                f"session: {result.session} (resume after a crash with:"
                f" tpx-torch supervise --resume {result.session})"
            )
        for i, (handle, step) in enumerate(
            zip(result.handles, result.resume_steps), start=1
        ):
            resumed = f" (resumed from step {step})" if step is not None else ""
            print(f"attempt {i}: {handle}{resumed}")
        if result.status is not None:
            print(result.status.format())
        if result.budget_exhausted is not None:
            print(
                f"{result.budget_exhausted.value.lower()} retry budget"
                " exhausted",
                file=sys.stderr,
            )
        if not result.succeeded:
            sys.exit(1)
