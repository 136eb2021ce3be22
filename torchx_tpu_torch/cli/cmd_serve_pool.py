"""``tpx-torch serve-pool`` — launcher-driven autoscaling generate_server pool.

Port of :mod:`torchx_tpu.cli.cmd_serve_pool`. Submits N ``generate_server``
replicas as one role through the Runner, starts a least-loaded HTTP router
in front of them, and runs the probe -> autoscale -> ``Runner.resize``
control loop until interrupted::

    TPX_NO_LINT=1 tpx-torch serve-pool --config llama3_1b --replicas 2 \\
        --max-replicas 6 --base-port 8000 --router-port 9000 \\
        --target-queue-depth 4 --target-p99-ms 500

Each replica gets one H100 (``--gpu h100-1``, the default) and serves on
it; ``--device cpu`` gives the replicas no GPU resource and serves on the
CPU, and is refused beside a ``--gpu``. The runner's lint gate needs the analyzer, which is not ported yet
(ROADMAP queue 1 item 2.8): ``$TPX_NO_LINT=1`` passes it.

Every scale event is an ordinary ledgered resize — ``tpx-torch trace`` shows
``serve.scale`` spans next to the ``runner.resize`` calls they made, and
``tpx_serve_replicas`` / ``tpx_serve_scale_events_total`` land in the
metrics sink. Ctrl-C cancels the app; replicas drain via their SIGTERM
handlers.

``--disaggregate`` splits serving into a prefill gang (cache-aware
chunked prefill over the radix prefix cache, client-facing) and a
decode gang (pure decode over KV blocks streamed from prefill via
``--kv-transfer``), each autoscaled independently::

    tpx-torch serve-pool --config llama3_1b --disaggregate \\
        --prefill-replicas 1 --decode-replicas 2 \\
        --decode-base-port 8100 --prefix-cache-reserve 0.25
"""

from __future__ import annotations

import argparse
import logging
import sys
import threading
from typing import Any

from torchx_tpu_torch.cli.cmd_base import SubCommand

logger = logging.getLogger(__name__)

# what a replica asks for without --gpu: one H100
DEFAULT_GPU = "h100-1"


def build_app(args: argparse.Namespace) -> Any:
    """The pool's AppDef from the parsed arguments: ``generate_server`` (or
    ``generate_server_disagg`` with ``--disaggregate``) with ``gpu=--gpu``
    for each replica, or no GPU resource (``--device cpu``). Raises
    ``ValueError`` when ``--gpu`` and ``--device cpu`` are both given."""
    from torchx_tpu_torch.components.serve import (
        generate_server,
        generate_server_disagg,
    )

    if args.device == "cpu":
        if args.gpu is not None:
            raise ValueError(
                f"--gpu {args.gpu} asks for a card a replica; --device cpu"
                " serves on the CPU: pass one of them"
            )
        gpu = None
    else:
        gpu = args.gpu or DEFAULT_GPU
    if args.disaggregate:
        return generate_server_disagg(
            args.config,
            prefill_port=args.base_port,
            decode_port=args.decode_base_port,
            ckpt_dir=args.ckpt_dir,
            gpu=gpu,
            max_batch=args.max_batch,
            prefill_replicas=args.prefill_replicas,
            decode_replicas=args.decode_replicas,
            port_stride=args.port_stride,
            kv_transfer=args.kv_transfer,
            prefix_cache_reserve=args.prefix_cache_reserve,
        )
    return generate_server(
        args.config,
        port=args.base_port,
        ckpt_dir=args.ckpt_dir,
        gpu=gpu,
        engine=args.engine,
        max_batch=args.max_batch,
        num_replicas=args.replicas,
        port_stride=args.port_stride,
        prefix_cache=not args.no_prefix_cache,
        prefix_cache_reserve=args.prefix_cache_reserve,
    )


class CmdServePool(SubCommand):
    """Run the serving control plane (see module docstring)."""

    def add_arguments(self, subparser: argparse.ArgumentParser) -> None:
        subparser.add_argument("--config", required=True, help="model config")
        subparser.add_argument(
            "-s",
            "--scheduler",
            default="local",
            help="scheduler backend for the replicas",
        )
        subparser.add_argument(
            "--replicas", type=int, default=1, help="initial replica count"
        )
        subparser.add_argument("--min-replicas", type=int, default=1)
        subparser.add_argument("--max-replicas", type=int, default=4)
        subparser.add_argument(
            "--base-port",
            type=int,
            default=8000,
            help="replica i serves on base-port + port-stride * i",
        )
        subparser.add_argument("--port-stride", type=int, default=1)
        subparser.add_argument(
            "--router-port",
            type=int,
            default=9000,
            help="least-loaded proxy port (0 = ephemeral)",
        )
        subparser.add_argument(
            "--target-queue-depth",
            type=float,
            default=4.0,
            help="per-replica queue depth that triggers scale-up",
        )
        subparser.add_argument(
            "--target-p99-ms",
            type=float,
            default=None,
            help="TTFT p99 SLO in ms; breaches also trigger scale-up",
        )
        subparser.add_argument(
            "--cooldown-s",
            type=float,
            default=60.0,
            help="minimum seconds between resizes",
        )
        subparser.add_argument(
            "--interval",
            type=float,
            default=5.0,
            help="control-loop probe interval seconds",
        )
        subparser.add_argument(
            "--iterations",
            type=int,
            default=None,
            help="stop after N control iterations (default: run forever)",
        )
        subparser.add_argument(
            "--engine", choices=("continuous", "coalesce"), default="continuous"
        )
        subparser.add_argument("--max-batch", type=int, default=16)
        subparser.add_argument("--ckpt-dir", default=None)
        subparser.add_argument(
            "--disaggregate",
            action="store_true",
            help="split serving into a prefill gang (cache-aware chunked"
            " prefill) and a decode gang (pure decode over transferred KV)"
            " with independent autoscale policies",
        )
        subparser.add_argument(
            "--prefill-replicas",
            type=int,
            default=1,
            help="initial prefill gang size (disaggregated mode)",
        )
        subparser.add_argument(
            "--decode-replicas",
            type=int,
            default=1,
            help="initial decode gang size (disaggregated mode)",
        )
        subparser.add_argument(
            "--decode-base-port",
            type=int,
            default=8100,
            help="decode replica i serves on decode-base-port + stride * i",
        )
        subparser.add_argument(
            "--kv-transfer",
            default=None,
            help="prefill->decode KV transfer spec (local | file:<dir> |"
            " http:<url>[,...]); default: http over the decode port range",
        )
        subparser.add_argument(
            "--prefix-cache-reserve",
            type=float,
            default=0.0,
            help="cap cached prefix blocks at this fraction of each"
            " replica's KV pool (0 = share the whole pool)",
        )
        subparser.add_argument(
            "--no-prefix-cache",
            action="store_true",
            help="disable the radix prefix cache on replicas",
        )
        subparser.add_argument(
            "--gpu",
            default=None,
            help="GPU resource of each replica (a named resource's"
            f" accelerator type; default {DEFAULT_GPU}: one H100)",
        )
        subparser.add_argument(
            "--device",
            choices=("cuda", "cpu"),
            default="cuda",
            help="cuda (default): each replica serves on its --gpu; cpu:"
            " no GPU resource, the replicas serve on the CPU (not with"
            " --gpu)",
        )

    def run(self, args: argparse.Namespace) -> None:
        # deferred imports: `tpx-torch --help` imports no command module
        from torchx_tpu_torch.runner.api import get_runner
        from torchx_tpu_torch.serve.pool import (
            AutoscalePolicy,
            DisaggServePool,
            ServePool,
            serve_router,
        )

        policy = AutoscalePolicy(
            min_replicas=args.min_replicas,
            max_replicas=args.max_replicas,
            target_queue_depth=args.target_queue_depth,
            target_p99_s=(
                args.target_p99_ms / 1000.0
                if args.target_p99_ms is not None
                else None
            ),
            cooldown_s=args.cooldown_s,
        )
        try:
            app = build_app(args)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            sys.exit(1)
        with get_runner() as runner:
            if args.disaggregate:
                pool = DisaggServePool(
                    runner,
                    app,
                    scheduler=args.scheduler,
                    prefill_base_port=args.base_port,
                    decode_base_port=args.decode_base_port,
                    port_stride=args.port_stride,
                    prefill_policy=policy,
                    decode_policy=policy,
                )
            else:
                pool = ServePool(
                    runner,
                    app,
                    scheduler=args.scheduler,
                    base_port=args.base_port,
                    port_stride=args.port_stride,
                    policy=policy,
                )
            try:
                handle = pool.start()
            except (NotImplementedError, ValueError) as e:
                # the lint gate (item 2.8), or a GPU role on a host
                # without its cards
                print(f"error: {e}", file=sys.stderr)
                sys.exit(1)
            router = serve_router(pool, args.router_port)
            rport = router.server_address[1]
            threading.Thread(
                target=router.serve_forever, name="tpx-router", daemon=True
            ).start()
            print(f"serve pool {handle}: routing on :{rport}", flush=True)
            try:
                pool.run(interval_s=args.interval, iterations=args.iterations)
            except KeyboardInterrupt:
                print("interrupted; cancelling pool", flush=True)
            finally:
                router.shutdown()
                pool.stop()
