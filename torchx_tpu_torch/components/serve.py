"""Serving components: the port of :mod:`torchx_tpu.components.serve`
(reference analog: torchx/components/serve.py:19-77; ``generate_server``
goes beyond the reference — an actual inference server on the H100, not
just a registration client). The port's server runs on the card unless
asked for the CPU, so a server without a GPU resource is given ``--device
cpu``."""

from __future__ import annotations

from typing import Optional

import torchx_tpu_torch.specs as specs
from torchx_tpu_torch.version import TORCHX_TPU_IMAGE


def model_server(
    model_path: str,
    management_api: str,
    model_name: str = "model",
    image: str = TORCHX_TPU_IMAGE,
    timeout: float = 60.0,
) -> specs.AppDef:
    """Register a model archive with a running model server's management
    API (a one-shot registration client, not the server itself).

    Args:
        model_path: url/path of the model artifact to register
        management_api: base URL of the server management API
        model_name: name to register the model under
        image: image to use
        timeout: registration request timeout seconds
    """
    return specs.AppDef(
        name="model-server-register",
        roles=[
            specs.Role(
                name="register",
                image=image,
                entrypoint="python",
                args=[
                    "-m",
                    "torchx_tpu_torch.apps.serve_main",
                    "--model_path",
                    model_path,
                    "--management_api",
                    management_api,
                    "--model_name",
                    model_name,
                    "--timeout",
                    str(timeout),
                ],
                resource=specs.Resource(cpu=1, memMB=1024),
            )
        ],
    )


def generate_server(
    config: str,
    port: int = 8000,
    ckpt_dir: Optional[str] = None,
    int8: bool = False,
    image: str = TORCHX_TPU_IMAGE,
    gpu: Optional[str] = None,
    cpu: int = 4,
    memMB: int = 16384,
    batch_window_ms: float = 3.0,
    max_batch: int = 16,
    engine: str = "continuous",
    block_size: int = 16,
    num_blocks: Optional[int] = None,
    num_replicas: int = 1,
    port_stride: int = 0,
    prefix_cache: bool = True,
    prefix_cache_reserve: float = 0.0,
) -> specs.AppDef:
    """Serve KV-cache generation for a model family over HTTP
    (POST /v1/generate, GET /healthz, GET /metricz) — the GPU
    serving half the reference delegates to TorchServe. The default
    ``continuous`` engine runs continuous batching over a paged KV cache
    (:mod:`torchx_tpu_torch.serve.engine`); ``coalesce`` selects the legacy
    batch-to-completion batcher thread.

    Args:
        config: model config name (e.g. ``llama3_1b``)
        port: HTTP port to listen on
        ckpt_dir: checkpoint directory to restore weights from
        int8: serve int8 weight-only quantized (half the weight bytes)
        image: container image
        gpu: GPU accelerator type (e.g. ``h100-1``); CPU when unset
        cpu: cpu count for CPU serving
        memMB: memory for CPU serving
        batch_window_ms: coalesce-engine batching window
        max_batch: decode slots (continuous) / max coalesced batch
        engine: ``continuous`` (paged KV) or ``coalesce`` (legacy)
        block_size: paged KV-cache block size (continuous engine)
        num_blocks: paged KV pool size in blocks (default: from max_batch)
        num_replicas: server replicas (a serve pool resizes this)
        port_stride: replica i listens on ``port + stride * i`` so a pool's
            co-located replicas get distinct ports
        prefix_cache: radix prefix cache over the paged pool (continuous)
        prefix_cache_reserve: cap cached prefix blocks at this fraction of
            the KV pool (0 = share the whole pool)
    """
    args = [
        "-m",
        "torchx_tpu_torch.apps.generate_server",
        "--config",
        config,
        "--port",
        str(port),
        "--batch-window-ms",
        str(batch_window_ms),
        "--max-batch",
        str(max_batch),
        "--engine",
        engine,
        "--block-size",
        str(block_size),
    ]
    if num_blocks is not None:
        args += ["--num-blocks", str(num_blocks)]
    if port_stride:
        args += ["--port-stride", str(port_stride)]
    if ckpt_dir:
        args += ["--ckpt-dir", ckpt_dir]
    if int8:
        args += ["--int8"]
    if not prefix_cache:
        args += ["--no-prefix-cache"]
    if prefix_cache_reserve > 0:
        args += ["--prefix-cache-reserve", str(prefix_cache_reserve)]
    if not gpu:
        args += ["--device", "cpu"]
    resource = specs.resource(cpu=cpu, memMB=memMB, gpu=gpu)
    return specs.AppDef(
        name=f"generate-{config}",
        roles=[
            specs.Role(
                name="server",
                image=image,
                entrypoint="python",
                args=args,
                num_replicas=num_replicas,
                port_map={"http": port},
                resource=resource,
            )
        ],
    )


def generate_server_disagg(
    config: str,
    prefill_port: int = 8000,
    decode_port: int = 8100,
    ckpt_dir: Optional[str] = None,
    int8: bool = False,
    image: str = TORCHX_TPU_IMAGE,
    gpu: Optional[str] = None,
    cpu: int = 4,
    memMB: int = 16384,
    max_batch: int = 16,
    block_size: int = 16,
    num_blocks: Optional[int] = None,
    prefill_replicas: int = 1,
    decode_replicas: int = 1,
    port_stride: int = 1,
    kv_transfer: Optional[str] = None,
    prefix_cache_reserve: float = 0.0,
) -> specs.AppDef:
    """Disaggregated generation serving: ONE app, two gangs.

    The ``prefill`` role takes client traffic, runs the cache-aware
    chunked prefill (radix prefix cache over the paged pool), and
    streams each prompt's computed KV blocks to the ``decode`` role over
    the declared transfer path; decode replicas accept handoffs on
    ``/v1/kv`` and batch pure decode steps. Both roles carry the
    transfer spec in role metadata (``tpx/kv_transfer``) so submit-time
    analysis (TPX213) can verify the pair is actually wired — a
    prefill/decode split without a transfer path is an assembly error,
    caught before any card is provisioned.

    Args:
        config: model config name (e.g. ``llama3_1b``)
        prefill_port: prefill gang's base HTTP port
        decode_port: decode gang's base HTTP port
        ckpt_dir: checkpoint directory to restore weights from
        int8: serve int8 weight-only quantized
        image: container image
        gpu: GPU accelerator type; CPU when unset
        cpu: cpu count for CPU serving
        memMB: memory for CPU serving
        max_batch: decode slots per replica
        block_size: paged KV-cache block size
        num_blocks: paged KV pool size in blocks (default: from max_batch)
        prefill_replicas: prefill gang size (its pool resizes this)
        decode_replicas: decode gang size (its pool resizes this)
        port_stride: replica i listens on ``port + stride * i``
        kv_transfer: transfer spec; defaults to ``http:`` over the decode
            gang's port range at the current ``decode_replicas``
        prefix_cache_reserve: cap cached prefix blocks at this fraction
            of the prefill pool (0 = share the whole pool)
    """
    if kv_transfer is None:
        kv_transfer = "http:" + ",".join(
            f"http://127.0.0.1:{decode_port + port_stride * i}"
            for i in range(decode_replicas)
        )
    # the torch-free module, so that component loading stays light
    from torchx_tpu_torch.serve.kv_transfer import ROLE_METADATA_KEY, TransferConfig

    spec = TransferConfig.from_spec(kv_transfer).to_spec()  # validate early

    def _role_args(role: str, port: int) -> list[str]:
        args = [
            "-m",
            "torchx_tpu_torch.apps.generate_server",
            "--config",
            config,
            "--port",
            str(port),
            "--max-batch",
            str(max_batch),
            "--engine",
            "continuous",
            "--block-size",
            str(block_size),
            "--serve-role",
            role,
            "--kv-transfer",
            spec,
        ]
        if role == "prefill" and prefix_cache_reserve > 0:
            args += ["--prefix-cache-reserve", str(prefix_cache_reserve)]
        if num_blocks is not None:
            args += ["--num-blocks", str(num_blocks)]
        if port_stride:
            args += ["--port-stride", str(port_stride)]
        if ckpt_dir:
            args += ["--ckpt-dir", ckpt_dir]
        if int8:
            args += ["--int8"]
        if not gpu:
            args += ["--device", "cpu"]
        return args

    resource = specs.resource(cpu=cpu, memMB=memMB, gpu=gpu)
    return specs.AppDef(
        name=f"generate-{config}-disagg",
        roles=[
            specs.Role(
                name="prefill",
                image=image,
                entrypoint="python",
                args=_role_args("prefill", prefill_port),
                num_replicas=prefill_replicas,
                port_map={"http": prefill_port},
                resource=resource,
                metadata={ROLE_METADATA_KEY: spec},
            ),
            specs.Role(
                name="decode",
                image=image,
                entrypoint="python",
                args=_role_args("decode", decode_port),
                num_replicas=decode_replicas,
                port_map={"http": decode_port},
                resource=resource,
                metadata={ROLE_METADATA_KEY: spec},
            ),
        ],
    )
