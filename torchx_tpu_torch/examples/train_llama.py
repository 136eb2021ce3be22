"""Llama pretraining on one GPU: the port of
:mod:`torchx_tpu.examples.train_llama`'s dense, single-device path.

    python -m torchx_tpu_torch.examples.train_llama --config llama3_1b \\
        --batch 4 --seq 2048 --steps 10 --kernels cuda

Runs on the CUDA device unless ``--device cpu`` is given, and raises where
no CUDA device is present. Prints each step's loss, tokens/s and model
FLOPs utilization (MFU), then a JSON summary with the launch count of each
hand-written kernel. The JAX trainer's meshes, checkpoints, profiler,
gradient buckets, int8 and ring attention are not ported yet (ROADMAP);
their flags raise.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import math
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from torchx_tpu_torch import _build
from torchx_tpu_torch.examples.data import TokenDataset
from torchx_tpu_torch.models import llama
from torchx_tpu_torch.ops.fused import resolve_kernels
from torchx_tpu_torch.parallel.prefetch import Prefetcher, device_prefetch

#: Dense bf16 peak FLOP/s of one card, matched as a substring of
#: ``torch.cuda.get_device_name()`` (NVIDIA's data sheet, SXM part).
PEAK_FLOPS = {
    "h100": 989e12,
}

#: Flags of the JAX trainer this port does not have yet.
NOT_PORTED_FLAGS = (
    "--mesh", "--ring-attention", "--remat-policy", "--int8", "--int8-scope",
    "--grad-bucket-mb", "--log-every", "--profile-dir", "--profile",
    "--ckpt-dir", "--ckpt-every",
)


def resolve_device(device: Optional[str | torch.device]) -> torch.device:
    """``None`` means the CUDA device, which must exist: the port never
    carries on quietly on the CPU. ``"cpu"`` must be asked for."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card (pass device='cpu' /"
            " --device cpu to run on the CPU)"
        )
    return dev


def device_peak_flops(device: torch.device) -> Optional[float]:
    """Peak dense bf16 FLOP/s of the card, or None where unknown (and on
    the CPU, which has no MFU)."""
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device).lower()
    for key, flops in PEAK_FLOPS.items():
        if key in name:
            return flops
    return None


def warmup_cosine_decay(
    count: int, peak: float, warmup: int, decay_steps: int, end: float
) -> float:
    """optax.warmup_cosine_decay_schedule(0 -> peak over ``warmup`` steps,
    then cosine to ``end`` at ``decay_steps``, warmup included)."""
    if count < warmup:
        return peak * count / warmup
    span = decay_steps - warmup
    t = min(count - warmup, span)
    cosine = 0.5 * (1 + math.cos(math.pi * t / span))
    alpha = end / peak if peak else 0.0
    return peak * ((1 - alpha) * cosine + alpha)


class AdamW:
    """The JAX trainer's optax chain, in place on the parameter tensors:
    ``clip_by_global_norm(1.0)``, then AdamW (b1 0.9, b2 0.95, eps 1e-8,
    decoupled ``weight_decay`` on every leaf) on
    ``warmup_cosine_decay_schedule(0 -> lr over warmup, decay_steps=100_000
    including warmup, end lr * 0.1)``.

    Moments take each parameter's dtype (bf16 parameters keep bf16 moments,
    as optax does; no f32 master copy), and every step follows optax's
    operation order and casts. Updates the parameters in place and clears
    their ``.grad``."""

    B1, B2, EPS, MAX_NORM, DECAY_STEPS = 0.9, 0.95, 1e-8, 1.0, 100_000

    def __init__(
        self, params: list[torch.Tensor], lr: float, warmup: int, weight_decay: float
    ) -> None:
        self.params = params
        self.lr, self.warmup, self.weight_decay = lr, warmup, weight_decay
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0

    def schedule(self, count: int) -> float:
        """Learning rate of update ``count`` (0-based; 0 at count 0)."""
        return warmup_cosine_decay(
            count, self.lr, self.warmup, self.DECAY_STEPS, self.lr * 0.1
        )

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """Apply one update from the parameters' ``.grad``. -> the global
        gradient norm before clipping (a device scalar; no host sync)."""
        grads = [p.grad for p in self.params]
        if any(g is None for g in grads):
            raise RuntimeError("AdamW.step: a parameter has no gradient")
        sq = sum(torch.sum(torch.square(g)) for g in grads)
        g_norm = torch.sqrt(sq)
        keep = g_norm < self.MAX_NORM
        count_inc = self.count + 1
        b1, b2, f32 = self.B1, self.B2, np.float32
        # optax's bias corrections are f32 scalars
        bc1 = f32(1) - f32(b1) ** f32(count_inc)
        bc2 = f32(1) - f32(b2) ** f32(count_inc)
        step_size = -self.schedule(self.count)
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            dt = g.dtype
            g = torch.where(keep, g, (g / g_norm.to(dt)) * self.MAX_NORM)
            mu.copy_((1 - b1) * g + b1 * mu)
            nu.copy_((1 - b2) * g**2 + b2 * nu)
            mu_hat = mu / torch.tensor(bc1, device=g.device).to(dt)
            nu_hat = nu / torch.tensor(bc2, device=g.device).to(dt)
            u = mu_hat / (torch.sqrt(nu_hat) + self.EPS)
            u = u + self.weight_decay * p
            u = torch.tensor(step_size, dtype=dt, device=g.device) * u
            p.copy_(p + u)
            p.grad = None
        self.count = count_inc
        return g_norm


def make_optimizer(
    params: list[torch.Tensor], lr: float = 3e-4, weight_decay: float = 0.1,
    warmup: int = 100,
) -> AdamW:
    """The JAX trainer's ``make_optimizer`` over ``params``."""
    return AdamW(params, lr=lr, warmup=warmup, weight_decay=weight_decay)


def make_train_step(
    cfg: llama.LlamaConfig, optimizer: AdamW
) -> Callable[[llama.Params, dict[str, torch.Tensor]], dict[str, torch.Tensor]]:
    """-> ``step(params, batch)``: loss, backward, one optimizer update in
    place. Returns device scalars (no host sync): the loss before the
    update, the router aux vector and the gradient norm."""

    def step(params: llama.Params, batch: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        loss, aux = llama.loss_and_aux(params, batch, cfg)
        loss.backward()
        grad_norm = optimizer.step()
        return {"loss": loss.detach(), "aux": aux.detach(), "grad_norm": grad_norm}

    return step


def synthetic_batch(
    cfg: llama.LlamaConfig, batch: int, seq: int, seed: int = 0,
    device: torch.device | str = "cpu",
) -> dict[str, torch.Tensor]:
    """Uniform random tokens ``[batch, seq+1]`` (the model runs on
    ``tokens[:, :-1]``), drawn on ``device`` from a seeded generator."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    tokens = torch.randint(
        0, cfg.vocab_size, (batch, seq + 1), generator=gen, device=device
    )
    return {"tokens": tokens}


def train(
    cfg: llama.LlamaConfig,
    batch: int,
    seq: int,
    steps: int,
    lr: float = 3e-4,
    warmup: int = 100,
    data_path: Optional[str] = None,
    prefetch: int = 2,
    kernels: str = "reference",
    device: Optional[str | torch.device] = None,
    seed: int = 0,
    log_every: int = 1,
) -> dict[str, Any]:
    """Train ``steps`` steps of ``cfg`` from a seeded init. -> metrics:
    losses, step times, tokens/s and MFU over the steps after the first
    (which pays the kernels' builds and Triton's compiles), peak device
    memory, and each kernel's launches over the run and per step."""
    dev = resolve_device(device)
    cfg = dataclasses.replace(cfg, max_seq=seq, kernels=resolve_kernels(kernels))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = llama.init_params(cfg, gen, dev)
    optimizer = make_optimizer(llama.leaves(params), lr=lr, warmup=warmup)
    step_fn = make_train_step(cfg, optimizer)
    if data_path:
        rows = TokenDataset(data_path, seq, batch, seed=seed)
        batches = device_prefetch(
            ({"tokens": r} for r in rows), dev, depth=prefetch
        )
    else:
        # a constant device batch through a passthrough prefetcher: one code
        # path and an honest (about 0) data-wait account
        data = synthetic_batch(cfg, batch, seq, seed=seed, device=dev)
        batches = Prefetcher(itertools.repeat(data), depth=0)

    counts0 = _build.launch_counts()
    losses, grad_norms, step_times = [], [], []
    peak = device_peak_flops(dev)
    flops_per_token = cfg.flops_per_token()
    try:
        for i in range(steps):
            t0 = time.monotonic()
            out = step_fn(params, next(batches))
            loss = float(out["loss"])  # waits for the step
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            step_times.append(time.monotonic() - t0)
            losses.append(loss)
            grad_norms.append(float(out["grad_norm"]))
            if log_every and (i + 1) % log_every == 0:
                tps = batch * seq / step_times[-1]
                mfu = f" MFU={tps * flops_per_token / peak:.1%}" if peak else ""
                print(f"step {i + 1} loss={loss:.4f} tokens/sec={tps:,.0f}{mfu}", flush=True)
        data_wait_s = batches.data_wait_s
    finally:
        batches.close()
    counts = _build.launch_counts()
    launches = {k: counts[k] - counts0[k] for k in counts}
    timed = step_times[1:] or step_times
    step_s = sum(timed) / len(timed)
    tps = batch * seq / step_s
    return {
        "loss": losses[-1],
        "losses": losses,
        "grad_norms": grad_norms,
        "step_times_s": step_times,
        "step_time_s": step_s,
        "tokens_per_sec": tps,
        "mfu": tps * flops_per_token / peak if peak else None,
        "data_wait_s": data_wait_s,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None,
        "launches": launches,
        "launches_per_step": {k: v / steps for k, v in launches.items()},
        "kernels": cfg.kernels,
        "remat_policy": cfg.remat_policy if cfg.remat else "none",
        "device": str(dev),
        "device_name": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }


def main(argv: Optional[list[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--config", default="tiny", choices=sorted(llama.CONFIGS) + list(llama.MOE_CONFIGS)
    )
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--seq", type=int, default=128)
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--lr", type=float, default=3e-4)
    parser.add_argument("--warmup", type=int, default=100)
    parser.add_argument(
        "--data", default=None,
        help="packed uint32 token file (see datapreproc); synthetic data when unset",
    )
    parser.add_argument(
        "--prefetch", type=int, default=2,
        help="input prefetch depth (batches staged ahead of the step; 0 = synchronous)",
    )
    parser.add_argument(
        "--kernels", default="reference", choices=["reference", "cuda", "pallas"],
        help="'cuda' routes attention and the residual-add + RMSNorm through"
        " the hand-written kernels ('pallas', the JAX trainer's name, means"
        " the same); default the plain PyTorch ops",
    )
    parser.add_argument(
        "--device", default=None,
        help="torch device (default: cuda, which must exist; 'cpu' to run on the CPU)",
    )
    args, unknown = parser.parse_known_args(argv)
    for arg in unknown:
        flag = arg.split("=", 1)[0]
        if flag in NOT_PORTED_FLAGS:
            raise NotImplementedError(
                f"{flag} is not ported yet (ROADMAP queue 1); the port runs the"
                " dense single-device step"
            )
    if unknown:
        parser.error(f"unrecognized arguments: {' '.join(unknown)}")
    metrics = train(
        llama.get_config(args.config),
        args.batch,
        args.seq,
        args.steps,
        lr=args.lr,
        warmup=args.warmup,
        data_path=args.data,
        prefetch=args.prefetch,
        kernels=args.kernels,
        device=args.device,
    )
    print("final:", json.dumps(metrics), flush=True)


if __name__ == "__main__":
    main()
