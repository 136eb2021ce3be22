"""``tpx-torch pipeline`` — submit and watch train→eval→promote DAGs; the
port of :mod:`torchx_tpu.cli.cmd_pipeline`.

Proxies the control daemon's ``/v1/pipelines`` verbs: ``submit`` POSTs a
:class:`~torchx_tpu_torch.pipelines.dag.PipelineSpec` JSON file, ``status``
renders one pipeline's stage-by-stage record (or the full list plus the
current incumbent checkpoint), ``cancel`` stops a running pipeline.
Finds the daemon like every other proxied verb — ``$TPX_CONTROL_ADDR``
or the discovery file (``require_env=False``).
"""

from __future__ import annotations

import argparse
import json
import sys

from torchx_tpu_torch.cli.cmd_base import SubCommand


class CmdPipeline(SubCommand):
    def add_arguments(self, subparser: argparse.ArgumentParser) -> None:
        sub = subparser.add_subparsers(dest="action", required=True)

        submit = sub.add_parser(
            "submit", help="submit a pipeline spec (JSON file)"
        )
        submit.add_argument(
            "--file",
            "-f",
            required=True,
            help="path to a PipelineSpec JSON file"
            ' ({"name": ..., "stages": [...]})',
        )

        status = sub.add_parser(
            "status", help="one pipeline's stages, or all pipelines"
        )
        status.add_argument(
            "pipeline",
            nargs="?",
            default=None,
            help="pipeline id (pl_N); omit to list all",
        )
        status.add_argument(
            "--json",
            action="store_true",
            help="print the raw /v1/pipelines reply as JSON",
        )

        cancel = sub.add_parser("cancel", help="cancel a running pipeline")
        cancel.add_argument("pipeline", help="pipeline id (pl_N)")

    def run(self, args: argparse.Namespace) -> None:
        from torchx_tpu_torch.control.client import ControlClientError, maybe_client

        try:
            client = maybe_client(require_env=False)
        except ControlClientError as e:
            print(f"pipeline: {e.message}", file=sys.stderr)
            sys.exit(1)
        if client is None:
            print(
                "pipeline: no control daemon found (start `tpx-torch control"
                " ...` or set TPX_CONTROL_ADDR)",
                file=sys.stderr,
            )
            sys.exit(1)
        try:
            if args.action == "submit":
                with open(args.file) as f:
                    spec = json.load(f)
                reply = client.pipeline_submit(spec)
                print(reply.get("pipeline", ""))
            elif args.action == "cancel":
                reply = client.pipeline_cancel(args.pipeline)
                print(f"{args.pipeline}: {reply.get('state')}")
            else:
                reply = client.pipeline_status(args.pipeline)
                if args.json:
                    print(json.dumps(reply, indent=2, sort_keys=True))
                    return
                self._render(reply, args.pipeline)
        except OSError as e:
            print(f"pipeline: {e}", file=sys.stderr)
            sys.exit(1)
        except ControlClientError as e:
            print(f"pipeline: {e.message}", file=sys.stderr)
            sys.exit(1)

    def _render(self, reply: dict, pipeline: str | None) -> None:
        runs = [reply] if pipeline else reply.get("pipelines", [])
        incumbent = reply.get("incumbent")
        if incumbent:
            print(
                f"incumbent: {incumbent.get('ckpt')}"
                f" step {incumbent.get('step')}"
                f" score {incumbent.get('score')}"
            )
        if not runs:
            print("no pipelines")
            return
        for run in runs:
            reason = f"  ({run['reason']})" if run.get("reason") else ""
            print(
                f"{run['pipeline']:<8} {run['name']:<20}"
                f" {run['state']}{reason}"
            )
            for srun in run.get("stages", []):
                where = srun.get("handle") or srun.get("fleet_job") or ""
                err = f"  {srun['error']}" if srun.get("error") else ""
                art = srun.get("artifact") or {}
                tail = ""
                if art.get("kind") == "checkpoint":
                    tail = f"  step={art.get('step')}"
                elif art.get("kind") == "score":
                    tail = f"  score={art.get('score')}"
                print(
                    f"  {srun['name']:<16} {srun['kind']:<8}"
                    f" {srun['state']:<11} {where}{tail}{err}"
                )
