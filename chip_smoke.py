#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``torchx_tpu_torch``) on one NVIDIA H100.

Run from the root of a checkout, on a machine with one CUDA card::

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure exits non-zero:

1. build — compile the CUDA kernels from ``torchx_tpu_torch/csrc``.
2. kernels — each kernel of the training step against its plain PyTorch
   version on the card. The flash forward, dq and dk/dv have two variants
   (``ops.fused.flash_variant``): the CUDA-core ``simt`` kernels in f32 at
   the CPU tests' tolerances, and both variants in bf16 at the llama3_1b
   main-path shapes, the tensor-core ``wgmma`` ones also at head_dim 128
   with n_rep 1 and 4, causal and full. The wgmma dq and dk/dv and the
   norm backward's dw must be bitwise repeatable. Times (CUDA events after
   warm-up) of every kernel, the plain version and one PyTorch library
   call as a yardstick, and the least time the card could take
   (``bound_ms``).
3. train — ``train`` on llama3_1b at full width (16 layers, dim 2048,
   32/8 heads, vocab 128256, tied), bf16, ``kernels="cuda"``, batch 4,
   seq 2048, synthetic tokens; launch counts reset just before and read just
   after, checked against n_layers x (1 + remat recompute) per step for the
   forward kernels and n_layers for the backward ones: the bf16 step runs
   the ``wgmma`` flash kernels and no ``simt`` one.
4. reference — one step of the same config at 2 layers with the kernels
   and with plain PyTorch ops, losses and gradient norms compared.

``--phases build,sweep`` times the RMSNorm backward kernel over its launch
settings (``ops.norms.BWD_CONFIG``).

Prints the kernels line, the card's name and power limit, and as its last
line ``{"ok": true, "device": {...}}``. Exits non-zero, printing no result,
where no CUDA device is present or the port cannot be imported.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import subprocess
import sys
import time

PHASES = ("build", "kernels", "train", "reference")
#: Run only when asked for (``--phases ...,profile``): where a step's
#: device time goes, by kernel.
EXTRA_PHASES = ("profile", "sweep")

#: H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor-core rate and
#: HBM bandwidth.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

#: Where each kernel lives in the repo, and the TPU kernel it replaces.
KERNEL_INFO = {
    "flash_fwd_wgmma": ("cuda", "torchx_tpu_torch/csrc/flash_fwd_wgmma.cu",
                        "torchx_tpu/ops/fused.py:87"),
    "flash_fwd_simt": ("cuda", "torchx_tpu_torch/csrc/flash_attn.cu",
                       "torchx_tpu/ops/fused.py:87"),
    "flash_dq_wgmma": ("cuda", "torchx_tpu_torch/csrc/flash_dq_wgmma.cu",
                       "torchx_tpu/ops/fused.py:167"),
    "flash_dq_simt": ("cuda", "torchx_tpu_torch/csrc/flash_attn.cu",
                      "torchx_tpu/ops/fused.py:167"),
    "flash_dkv_wgmma": ("cuda", "torchx_tpu_torch/csrc/flash_dkv_wgmma.cu",
                        "torchx_tpu/ops/fused.py:198"),
    "flash_dkv_simt": ("cuda", "torchx_tpu_torch/csrc/flash_attn.cu",
                       "torchx_tpu/ops/fused.py:198"),
    "norm_res_fwd": ("triton", "torchx_tpu_torch/ops/fused.py",
                     "torchx_tpu/ops/fused.py:361"),
    "rms_norm_bwd": ("triton", "torchx_tpu_torch/ops/norms.py",
                     "torchx_tpu/ops/norms.py:54"),
}

# main-path shapes: llama3_1b attention and the [batch*seq, dim] norm rows
ATTN = dict(b=4, s=2048, h=32, kvh=8, d=64)
NORM = dict(n=4 * 2048, d=2048)
EPS = 1e-5


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def fail(phase: str, msg: str) -> None:
    emit({"phase": phase, "ok": False, "error": msg})
    raise SystemExit(1)


#: Cycles of the sleep kernel that each timing starts with (~50 ms at the
#: H100's clock): the host enqueues every timed call while the card sleeps.
HOST_LEAD_CYCLES = 100_000_000


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:  # noqa: ANN001
    """Mean device milliseconds per call: CUDA events around ``iters``
    calls, all enqueued behind a sleep kernel, so that the events time the
    card and not the host's launch overhead (which exceeds a short kernel's
    run: two Triton launches take longer to enqueue than the norm backward
    takes to run)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOST_LEAD_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_err(a, b) -> float:  # noqa: ANN001
    return float((a.float() - b.float()).abs().max())


def rel_err(a, b) -> float:  # noqa: ANN001
    """max |a - b| over max |b| (max |b| floored at 1)."""
    return max_err(a, b) / max(1.0, float(b.float().abs().max()))


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def _attn_inputs(b, s, h, kvh, d, dtype, gen):  # noqa: ANN001, ANN202
    import torch

    def rnd(*shape):  # noqa: ANN001, ANN202
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    return rnd(b, s, h, d), rnd(b, s, kvh, d), rnd(b, s, kvh, d), rnd(b, s, h, d)


def _flash_case(b, s, h, kvh, d, causal, dtype, gen, variants):  # noqa: ANN001, ANN202
    """Errors (relative, absolute) of the flash kernels of the given
    variants against their plain versions."""
    from torchx_tpu_torch.ops import fused

    q, k, v, do = _attn_inputs(b, s, h, kvh, d, dtype, gen)
    o_p, lse_p = fused._flash_fwd_plain(q, k, v, causal)
    delta = fused._flash_delta(do, o_p)
    args = (q, k, v, do, lse_p, delta, causal)
    dq_p = fused._flash_dq_plain(*args)
    dk_p, dv_p = fused._flash_dkv_plain(*args)
    out = {}
    for var in variants:
        o_k, lse_k = fused._flash_fwd(q, k, v, causal, variant=var)
        dq_k = fused._flash_dq(*args, variant=var)
        dk_k, dv_k = fused._flash_dkv(*args, variant=var)
        out[f"flash_fwd_{var}"] = (max(rel_err(o_k, o_p), rel_err(lse_k, lse_p)),
                                   max(max_err(o_k, o_p), max_err(lse_k, lse_p)))
        out[f"flash_dq_{var}"] = (rel_err(dq_k, dq_p), max_err(dq_k, dq_p))
        out[f"flash_dkv_{var}"] = (max(rel_err(dk_k, dk_p), rel_err(dv_k, dv_p)),
                                   max(max_err(dk_k, dk_p), max_err(dv_k, dv_p)))
    return out


def family(name: str) -> str:
    """A kernel's name without its variant: the key of its tolerance and
    its bound (both variants compute the same function)."""
    return name.removesuffix("_wgmma").removesuffix("_simt")


def _norm_case(n, d, dtype, gen):  # noqa: ANN001, ANN202
    """Errors of the two norm kernels against their plain versions; the
    residual stream s must be bitwise equal."""
    import torch

    from torchx_tpu_torch.ops import fused, norms

    x = torch.randn((n, d), generator=gen, device="cuda").to(dtype)
    r = torch.randn((n, d), generator=gen, device="cuda").to(dtype)
    w = (1 + 0.1 * torch.randn((d,), generator=gen, device="cuda")).to(dtype)
    dy = torch.randn((n, d), generator=gen, device="cuda").to(dtype)
    y_k, s_k = fused._norm_res_fwd(x, r, w, EPS)
    y_p, s_p = fused._rms_norm_residual_math(x, r, w, EPS)
    if not torch.equal(s_k, s_p):
        fail("kernels", f"norm_res_fwd: residual stream s not bitwise ({dtype})")
    dx_k, dw_k = norms._bwd(x, dy, w, EPS)
    dx_p, dw_p = norms._bwd_math(x, w, dy, EPS)
    return {
        "norm_res_fwd": (rel_err(y_k, y_p), max_err(y_k, y_p)),
        "rms_norm_bwd": (max(rel_err(dx_k, dx_p), rel_err(dw_k, dw_p)),
                         max(max_err(dx_k, dx_p), max_err(dw_k, dw_p))),
    }


#: f32 tolerances: those of the CPU parity tests (tests/test_torch_ops.py)
F32_TOL = {"flash_fwd": 2e-5, "flash_dq": 5e-4, "flash_dkv": 5e-4,
           "norm_res_fwd": 1e-6, "rms_norm_bwd": 2e-5}
#: bf16 tolerances at the main-path shapes, relative to the largest
#: reference value. Kernel and plain version read the same bf16 values and
#: sum in f32, so the simt flash kernels differ by summation order only and
#: the wgmma ones also by the bf16 hi + lo split of P and dS (~1e-6, where
#: one bf16 rounding would cost ~2e-3: tests/test_torch_flash_variants.py);
#: the norm kernels' bf16 outputs (y, dx) may differ by one bf16 rounding
#: step (2**-8 relative) where the f32 sums round to either side.
BF16_TOL = {"flash_fwd": 1e-3, "flash_dq": 1e-3, "flash_dkv": 1e-3,
            "norm_res_fwd": 2 ** -7, "rms_norm_bwd": 2 ** -7}

F32_ATTN_CASES = [  # b, s, h, kvh, d, causal
    (2, 256, 2, 2, 64, True), (1, 128, 2, 2, 64, False),
    (2, 256, 4, 2, 64, True), (1, 256, 4, 1, 64, True),
    (1, 128, 2, 1, 128, True), (1, 256, 2, 2, 256, False),
    (1, 256, 4, 2, 256, True),
]
#: bf16 cases of the wgmma kernels beside the main shapes: head_dim 128
#: (llama3_8b), n_rep 1 and 4, causal and full
BF16_WGMMA_CASES = [  # b, s, h, kvh, d, causal
    (2, 1024, 4, 4, 128, True), (2, 1024, 8, 2, 128, True),
    (2, 1024, 4, 4, 128, False), (2, 1024, 8, 2, 128, False),
    (2, 1024, 8, 2, 64, False),
]


def _bounds(dtype_bytes: int = 2) -> dict[str, tuple[float, str, float, float]]:
    """-> kernel -> (bound_ms, bound_by, flops, bytes) at the main shapes.

    Each input read once and each output written once; the causal mask
    means s(s+1)/2 query-key pairs need computing."""
    b, s, h, kvh, d = (ATTN[x] for x in ("b", "s", "h", "kvh", "d"))
    pairs = b * h * s * (s + 1) / 2
    qo = b * s * h * d
    kv = b * s * kvh * d
    rows = b * h * s
    n, dn = NORM["n"], NORM["d"]
    work = {
        # QK^T and PV
        "flash_fwd": (2 * 2 * pairs * d,
                      (qo + 2 * kv) * dtype_bytes + qo * 4 + rows * 4),
        # QK^T, dO V^T, dS K
        "flash_dq": (3 * 2 * pairs * d,
                     (2 * qo + 2 * kv) * dtype_bytes + 2 * rows * 4 + qo * 4),
        # K Q^T, V dO^T, P^T dO, dS^T Q
        "flash_dkv": (4 * 2 * pairs * d,
                      (2 * qo + 2 * kv) * dtype_bytes + 2 * rows * 4 + 2 * kv * 4),
        # add, square, sum, scale, weight: ~6 per element
        "norm_res_fwd": (6 * n * dn, (4 * n * dn + dn) * dtype_bytes),
        # ~10 per element
        "rms_norm_bwd": (10 * n * dn, (3 * n * dn + dn) * dtype_bytes + dn * 4),
    }
    out = {}
    for name, (flops, nbytes) in work.items():
        t_ops = flops / PEAK_BF16_FLOPS
        t_bytes = nbytes / PEAK_BYTES
        out[name] = (
            1e3 * max(t_ops, t_bytes),
            "operations" if t_ops > t_bytes else "bytes",
            flops,
            nbytes,
        )
    return out


#: SDPA's backward computes dq, dk and dv in one call: the share of its time
#: that each backward kernel's function takes, by FLOPs of the seven products
#: of the port's split backward (dq: Q K^T, dO V^T, dS K; dk/dv: K Q^T,
#: V dO^T, P^T dO, dS^T Q)
LIBRARY_SHARE = {
    "flash_dq": (3 / 7, "dq: 3 of the split backward's 7 products, by FLOPs"),
    "flash_dkv": (4 / 7, "dk, dv: 4 of the split backward's 7 products, by FLOPs"),
}


def phase_kernels() -> list[dict]:
    import torch
    import torch.nn.functional as F

    from torchx_tpu_torch import _build
    from torchx_tpu_torch.ops import fused, norms

    # f32 comparisons are exact f32: no TF32 in the plain versions' matmuls
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    f32_err: dict[str, float] = {}
    for case in F32_ATTN_CASES:
        for name, (rel, _) in _flash_case(
            *case, torch.float32, gen, ("simt",)
        ).items():
            tol = F32_TOL[family(name)]
            emit({"phase": "kernels", "check": name, "dtype": "float32",
                  "shape": list(case), "err": rel, "tol": tol})
            if not rel <= tol:
                fail("kernels", f"{name} f32 {case}: err {rel} > {tol}")
            f32_err[name] = max(f32_err.get(name, 0.0), rel)
    for name, (rel, _) in _norm_case(32, 128, torch.float32, gen).items():
        if not rel <= F32_TOL[name]:
            fail("kernels", f"{name} f32: err {rel} > {F32_TOL[name]}")
        f32_err[name] = rel
    torch.cuda.synchronize()

    # bf16: both flash variants at the main-path shapes, the wgmma ones at
    # the other shapes they take
    bf16 = {**_flash_case(*ATTN.values(), True, torch.bfloat16, gen, fused.FLASH_VARIANTS),
            **_norm_case(NORM["n"], NORM["d"], torch.bfloat16, gen)}
    checks = [("main", name, rel) for name, (rel, _) in bf16.items()]
    for case in BF16_WGMMA_CASES:
        checks += [(case, name, rel) for name, (rel, _) in _flash_case(
            *case, torch.bfloat16, gen, ("wgmma",)).items()]
    for case, name, rel in checks:
        tol = BF16_TOL[family(name)]
        if case != "main":
            emit({"phase": "kernels", "check": name, "dtype": "bfloat16",
                  "shape": list(case), "err": rel, "tol": tol})
        if not rel <= tol:
            fail("kernels", f"{name} bf16 {case}: err {rel} > {tol}")

    # timings at the main-path shapes
    q, k, v, do = _attn_inputs(*ATTN.values(), torch.bfloat16, gen)
    o, lse = fused._flash_fwd(q, k, v, True)
    delta = fused._flash_delta(do, o)
    n, dn = NORM["n"], NORM["d"]
    x = torch.randn((n, dn), generator=gen, device="cuda").to(torch.bfloat16)
    r = torch.randn((n, dn), generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.ones((dn,), device="cuda", dtype=torch.bfloat16)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    qg, kg, vg = (t.detach().requires_grad_() for t in (qt, kt, vt))
    sdpa_out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True, enable_gqa=True)
    do_t = do.transpose(1, 2)
    xg, wg = x.detach().requires_grad_(), w.detach().requires_grad_()
    rms_out = F.rms_norm(xg, (dn,), wg, EPS)

    def sdpa_bwd():  # noqa: ANN202
        return torch.autograd.grad(sdpa_out, (qg, kg, vg), do_t, retain_graph=True)

    def rms_bwd():  # noqa: ANN202
        return torch.autograd.grad(rms_out, (xg, wg), r, retain_graph=True)

    def sdpa_fwd():  # noqa: ANN202
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)

    def fwd(var):  # noqa: ANN001, ANN202
        return lambda: fused._flash_fwd(q, k, v, True, variant=var)

    def dq(var):  # noqa: ANN001, ANN202
        return lambda: fused._flash_dq(q, k, v, do, lse, delta, True, variant=var)

    def dkv(var):  # noqa: ANN001, ANN202
        return lambda: fused._flash_dkv(q, k, v, do, lse, delta, True, variant=var)

    # the wgmma backward kernels and the norm backward's dw own their sums
    # (no atomics): two calls must agree bitwise
    repeat = {"flash_dq_wgmma": lambda: (dq("wgmma")(),), "flash_dkv_wgmma": dkv("wgmma"),
              "rms_norm_bwd": lambda: norms._bwd(x, r, w, EPS)}
    for name, fn in repeat.items():
        if not all(torch.equal(a, b) for a, b in zip(fn(), fn())):
            fail("kernels", f"{name}: two calls differ")
    emit({"phase": "kernels", "check": "bitwise repeatable", "kernels": list(repeat)})

    sdpa_fwd_call = "F.scaled_dot_product_attention(enable_gqa=True), forward"
    sdpa_bwd_call = "SDPA backward: dq, dk and dv in one call"
    runs = {
        "flash_fwd_wgmma": (
            fwd("wgmma"), lambda: fused._flash_fwd_plain(q, k, v, True),
            sdpa_fwd, sdpa_fwd_call,
        ),
        "flash_fwd_simt": (
            fwd("simt"), lambda: fused._flash_fwd_plain(q, k, v, True),
            sdpa_fwd, sdpa_fwd_call,
        ),
        "flash_dq_wgmma": (
            dq("wgmma"), lambda: fused._flash_dq_plain(q, k, v, do, lse, delta, True),
            sdpa_bwd, sdpa_bwd_call,
        ),
        "flash_dq_simt": (
            dq("simt"), lambda: fused._flash_dq_plain(q, k, v, do, lse, delta, True),
            sdpa_bwd, sdpa_bwd_call,
        ),
        "flash_dkv_wgmma": (
            dkv("wgmma"), lambda: fused._flash_dkv_plain(q, k, v, do, lse, delta, True),
            sdpa_bwd, sdpa_bwd_call,
        ),
        "flash_dkv_simt": (
            dkv("simt"), lambda: fused._flash_dkv_plain(q, k, v, do, lse, delta, True),
            sdpa_bwd, sdpa_bwd_call,
        ),
        "norm_res_fwd": (
            lambda: fused._norm_res_fwd(x, r, w, EPS),
            lambda: fused._rms_norm_residual_math(x, r, w, EPS),
            lambda: F.rms_norm(x + r, (dn,), w, EPS),
            "F.rms_norm(x + r) (the add is a second call)",
        ),
        "rms_norm_bwd": (
            lambda: norms._bwd(x, r, w, EPS),
            lambda: norms._bwd_math(x, w, r, EPS),
            rms_bwd,
            "F.rms_norm backward: dx and dw in one autograd.grad call",
        ),
    }
    bounds = _bounds()
    rows = []
    for name, (kern, plain, lib, lib_call) in runs.items():
        route, source, replaces = KERNEL_INFO[name]
        bound_ms, bound_by, flops, nbytes = bounds[family(name)]
        ms = time_ms(kern)
        library_ms = time_ms(lib)
        share, share_of = LIBRARY_SHARE.get(family(name), (None, None))
        rows.append({
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": None, "max_abs_err": bf16[name][1], "rel_err": bf16[name][0],
            "tol": BF16_TOL[family(name)],
            # the wgmma kernels take bf16 only
            "f32_rel_err": f32_err.get(name),
            "f32_tol": F32_TOL[family(name)] if name in f32_err else None,
            "ms": ms, "plain_ms": time_ms(plain, iters=3),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "library_call": lib_call,
            "library_share_ms": share and share * library_ms, "library_share": share_of,
            "flops": flops, "bytes": nbytes,
            "roofline_share": bound_ms / ms,
        })
    torch.cuda.synchronize()
    del sdpa_out, rms_out
    _build.reset_launches()
    return rows


# ---------------------------------------------------------------------------
# phases 3 and 4: the trainer
# ---------------------------------------------------------------------------

TRAIN = dict(batch=4, seq=2048, steps=6)
#: bf16 tolerances of the reference check, relative: the kernels keep the
#: attention probabilities in f32 where the plain path rounds them to bf16
#: before the PV product (as the JAX plain path does), about 2**-9 per layer
#: on the loss; the gradient norm is summed in bf16 as optax sums it, three
#: significant digits.
REF_LOSS_RTOL = 1e-2
REF_GRAD_NORM_RTOL = 5e-2


def phase_train() -> dict:
    import torch

    from torchx_tpu_torch import _build
    from torchx_tpu_torch.examples.train_llama import train
    from torchx_tpu_torch.models import llama

    cfg = llama.llama3_1b()
    torch.cuda.empty_cache()
    _build.reset_launches()
    out = train(cfg, TRAIN["batch"], TRAIN["seq"], TRAIN["steps"],
                kernels="cuda", device="cuda", warmup=1, log_every=1)
    counts = _build.launch_counts()
    losses = out["losses"]
    if not all(math.isfinite(x) for x in losses):
        fail("train", f"non-finite loss: {losses}")
    # remat recomputes each layer's forward in the backward
    fwd = cfg.n_layers * (1 + int(cfg.remat)) * TRAIN["steps"]
    bwd = cfg.n_layers * TRAIN["steps"]
    # bf16 at head_dim 64: flash_variant picks the wgmma kernels
    expected = {"flash_fwd_wgmma": fwd, "flash_fwd_simt": 0, "norm_res_fwd": fwd,
                "flash_dq_wgmma": bwd, "flash_dq_simt": 0, "flash_dkv_wgmma": bwd,
                "flash_dkv_simt": 0, "rms_norm_bwd": bwd}
    emit({"phase": "train", "config": "llama3_1b", "n_layers": cfg.n_layers,
          "dim": cfg.dim, "heads": [cfg.n_heads, cfg.n_kv_heads],
          "vocab": cfg.vocab_size, "tied": cfg.tie_embeddings, **TRAIN,
          "losses": losses, "grad_norms": out["grad_norms"],
          "step_times_s": out["step_times_s"], "step_time_s": out["step_time_s"],
          "tokens_per_sec": out["tokens_per_sec"], "mfu": out["mfu"],
          "peak_memory_bytes": out["peak_memory_bytes"],
          "launches": counts, "expected_launches": expected})
    if counts != expected:
        fail("train", f"launch counts {counts} != expected {expected}")
    return counts, expected


def phase_reference() -> None:
    import dataclasses

    import torch

    from torchx_tpu_torch.examples.train_llama import (
        make_optimizer, make_train_step, synthetic_batch,
    )
    from torchx_tpu_torch.models import llama

    res = {}
    for kernels, attn_impl in (("cuda", "auto"), ("reference", "xla")):
        # the reference run takes the plain attention ("xla") too: under
        # "auto" a CUDA tensor would reach the flash kernels
        cfg = dataclasses.replace(
            llama.llama3_1b(n_layers=2), max_seq=TRAIN["seq"], kernels=kernels,
            attn_impl=attn_impl,
        )
        torch.cuda.empty_cache()
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        params = llama.init_params(cfg, gen, "cuda")
        step = make_train_step(cfg, make_optimizer(llama.leaves(params)))
        batch = synthetic_batch(cfg, TRAIN["batch"], TRAIN["seq"], device="cuda")
        out = step(params, batch)
        res[kernels] = {"loss": float(out["loss"]), "grad_norm": float(out["grad_norm"])}
        del params, step, out
    k, r = res["cuda"], res["reference"]
    loss_rel = abs(k["loss"] - r["loss"]) / abs(r["loss"])
    gn_rel = abs(k["grad_norm"] - r["grad_norm"]) / abs(r["grad_norm"])
    emit({"phase": "reference", "n_layers": 2, "cuda": k, "reference": r,
          "loss_rel_diff": loss_rel, "loss_rtol": REF_LOSS_RTOL,
          "grad_norm_rel_diff": gn_rel, "grad_norm_rtol": REF_GRAD_NORM_RTOL})
    if not (math.isfinite(k["loss"]) and loss_rel <= REF_LOSS_RTOL
            and gn_rel <= REF_GRAD_NORM_RTOL):
        fail("reference", f"kernels {k} vs reference {r}")



#: Kernel-name fragments -> the group a step's device time is booked to.
PROFILE_GROUPS = (
    ("flash_fwd", ("flash_fwd_wgmma_kernel", "flash_fwd_kernel")),
    ("flash_dq", ("flash_dq_wgmma_kernel", "flash_dq_kernel")),
    ("flash_dkv", ("flash_dkv_wgmma_kernel", "flash_dkv_kernel")),
    ("norm_res_fwd", ("norm_res_fwd_kernel",)),
    ("rms_norm_bwd", ("rms_norm_bwd_kernel", "dw_reduce_kernel")),
    ("matmul", ("gemm", "xmma", "cutlass", "nvjet", "sm90_")),
)


def phase_profile() -> None:
    """Profile one llama3_1b step after a warm-up step (torch.profiler,
    CUDA activity): device time by kernel group and the device's busy share
    of the step's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from torchx_tpu_torch.examples.train_llama import (
        make_optimizer, make_train_step, synthetic_batch,
    )
    from torchx_tpu_torch.models import llama

    import dataclasses

    cfg = dataclasses.replace(llama.llama3_1b(), max_seq=TRAIN["seq"], kernels="cuda")
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = llama.init_params(cfg, gen, "cuda")
    step = make_train_step(cfg, make_optimizer(llama.leaves(params)))
    batch = synthetic_batch(cfg, TRAIN["batch"], TRAIN["seq"], device="cuda")
    step(params, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        step(params, batch)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    kernels = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us > 0:
            kernels[ev.key] = (us / 1e3, ev.count)
    groups: dict[str, float] = {}
    for name, (ms, _) in kernels.items():
        group = next((g for g, frags in PROFILE_GROUPS
                      if any(f in name for f in frags)), "other")
        groups[group] = groups.get(group, 0.0) + ms
    busy = sum(groups.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]
    emit({"phase": "profile", "step_wall_ms": wall * 1e3, "device_busy_ms": busy,
          "device_busy_share": busy / (wall * 1e3), "groups_ms": groups,
          "top_kernels": [{"name": n[:120], "ms": ms, "count": c} for n, (ms, c) in top]})


#: The RMSNorm backward's launch settings the sweep phase times (see
#: ``ops.norms.BWD_CONFIG``): rows per block, warps, programs per SM,
#: pipeline stages of the row loop, columns per program of the dw pass.
#: (1, 8, 2, 1, 128) is the design the kernel had before it took row blocks.
SWEEP = dict(rows=(1, 2, 4, 8), warps=(4, 8, 16), per_sm=(1, 2, 4), stages=(1, 2),
             reduce_cols=(16, 32, 128))


def phase_sweep() -> None:
    """Time the RMSNorm backward at the main-path shape over ``SWEEP``,
    each setting checked against the plain version first."""
    import itertools

    import torch
    import torch.nn.functional as F

    from torchx_tpu_torch.ops import norms

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    n, dn = NORM["n"], NORM["d"]
    x, dy = (torch.randn((n, dn), generator=gen, device="cuda").to(torch.bfloat16)
             for _ in range(2))
    w = (1 + 0.1 * torch.randn((dn,), generator=gen, device="cuda")).to(torch.bfloat16)
    dx_p, dw_p = norms._bwd_math(x, w, dy, EPS)
    xg, wg = x.detach().requires_grad_(), w.detach().requires_grad_()
    out = F.rms_norm(xg, (dn,), wg, EPS)
    library_ms = time_ms(lambda: torch.autograd.grad(out, (xg, wg), dy, retain_graph=True))
    bound_ms = _bounds()["rms_norm_bwd"][0]
    results = []
    for cfg in itertools.product(*SWEEP.values()):
        try:
            dx, dw = norms._bwd(x, dy, w, EPS, config=cfg)
            err = max(rel_err(dx, dx_p), rel_err(dw, dw_p))
            ms = time_ms(lambda: norms._bwd(x, dy, w, EPS, config=cfg), iters=20)  # noqa: B023
            results.append({"config": cfg, "ms": ms, "share_of_bound": bound_ms / ms,
                            "err": err, "ok": err <= BF16_TOL["rms_norm_bwd"]})
        except Exception as e:  # noqa: BLE001 - a setting that fails to build is a result
            results.append({"config": cfg, "error": f"{type(e).__name__}: {e}"[:300]})
    results.sort(key=lambda r: r.get("ms", math.inf))
    emit({"phase": "sweep", "kernel": "rms_norm_bwd", "shape": [n, dn],
          "config_keys": list(SWEEP), "default": norms.BWD_CONFIG,
          "bound_ms": bound_ms, "library_ms": library_ms, "results": results})
    if not all(r.get("ok", True) for r in results):
        fail("sweep", "a setting disagrees with the plain version")


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


def ptxas_summary(log: str) -> dict[str, str]:
    """kernel<type,head_dim> -> ptxas's spill and register lines, from the
    ``-Xptxas -v`` build log, and ptxas's warnings (such as a wgmma
    serialised for want of registers)."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function .*?\d(flash_\w+?_kernel)I(\w*?)Li(\d+)E", line)
        if m:
            dtype = "f32" if m.group(2) == "f" else "bf16"
            name = f"{m.group(1)}<{dtype},{m.group(3)}>"
            out[name] = ""
        elif name and ("spill" in line or "Used" in line):
            out[name] = (out[name] + "; " + line.split(":", 1)[-1].strip()).strip("; ")
        elif re.search(r"\(C\d+\)", line):
            out.setdefault("warnings", []).append(line.split(":", 1)[-1].strip()[:200])
    return out


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", default=",".join(PHASES),
                        help=f"comma-separated subset of {PHASES + EXTRA_PHASES}")
    args = parser.parse_args(argv)
    phases = args.phases.split(",")
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device: the port runs on the card", file=sys.stderr)
        return 2
    try:
        from torchx_tpu_torch import _build
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e})", file=sys.stderr)
        return 2

    t0 = time.monotonic()
    card = card_line()
    emit({"phase": "start", "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    build_s = _build.build()
    emit({"phase": "build", "ok": True, "seconds": build_s,
          "library": _build.build_info.get("library"),
          "ptxas": ptxas_summary(_build.build_info.get("log", ""))})

    kernel_rows = phase_kernels() if "kernels" in phases else []
    for row in kernel_rows:
        emit({"phase": "kernels", **row})
    if "train" in phases:
        counts, expected = phase_train()
        for row in kernel_rows:
            row["launches"] = counts[row["name"]]
            row["launches_per_step"] = counts[row["name"]] / TRAIN["steps"]
        # the simt flash kernels are off the bf16 main path (expected 0)
        if any(row["launches"] == 0 for row in kernel_rows if expected[row["name"]]):
            fail("train", "a kernel of the path was never launched")
    if "reference" in phases:
        phase_reference()
    if "profile" in phases:
        phase_profile()
    if "sweep" in phases:
        phase_sweep()

    if kernel_rows:
        print(json.dumps({"kernels": kernel_rows}), flush=True)
    print(card, flush=True)
    emit({"phase": "end", "seconds": time.monotonic() - t0})
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
