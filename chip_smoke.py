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
5. serve — ``generate_server`` in-process on 127.0.0.1 (continuous engine,
   8 slots, block size 16, the default pool) with llama3_1b at full width
   and depth, bf16, seeded random weights: 8 concurrent ``/v1/generate``
   requests (six greedy prompts of 32, 257, 512, 700, 1024 and 1500
   tokens, the 1024 one sharing its first 512 tokens with the 512 one, and
   two sampled at temperature 0.8, seed 7, on one 100-token prompt; 64 new
   tokens each; admitted once all are queued), a seed-8 request, a greedy
   re-send that must hit the prefix cache, then ``/healthz`` and
   ``/metricz``. Checks: each greedy
   token's logit within 5e-2 of its row's maximum when the prompt and
   completion are teacher-forced through the plain forward; at 2 layers
   in f32 the engine's greedy tokens equal the dense ``generate``'s; the
   same-seed pair is token-identical and seed 8 differs; the re-send
   equals its cold answer; pools and parameters on the card. Prints
   TTFT, TPOT, the decode-step time with all 8 slots busy, tokens/s, peak
   memory and the pool's geometry. The serving path launches none of the
   kernels of the kernels line, which the phase checks.

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

PHASES = ("build", "kernels", "train", "reference", "serve")
#: Run only when asked for (``--phases ...,profile``): where a training
#: step's and a decode step's device time goes, by kernel.
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



# ---------------------------------------------------------------------------
# phase 5: serving
# ---------------------------------------------------------------------------

#: The serve phase's traffic: (prompt length, temperature, seed) of the 8
#: concurrent requests; the two sampled ones share one prompt.
SERVE_REQUESTS = [(32, 0.0, 0), (100, 0.8, 7), (100, 0.8, 7), (257, 0.0, 0),
                  (512, 0.0, 0), (700, 0.0, 0), (1024, 0.0, 0), (1500, 0.0, 0)]
SERVE = dict(max_batch=8, block_size=16, new_tokens=64, seed=0)
#: A greedy token's logit may lie this far below its row's maximum when
#: the sequence is teacher-forced through the plain forward in bf16: the
#: engine (paged attention, bucketed prefill) and the plain forward round
#: differently, and a near-tie may go either way.
SERVE_LOGIT_GAP = 5e-2
#: Prompts (by index into SERVE_REQUESTS) of the exact f32 check at 2 layers.
F32_PROMPTS = (0, 3, 5)


def _serve_prompts(vocab: int) -> list[list[int]]:
    import numpy as np

    rng = np.random.default_rng(SERVE["seed"])
    prompts, by_len = [], {}
    for n, _, _ in SERVE_REQUESTS:
        if n not in by_len:
            by_len[n] = [int(t) for t in rng.integers(0, vocab, n)]
        prompts.append(by_len[n])
    # the 1024-token prompt opens with the 512-token one
    prompts[6] = prompts[4] + prompts[6][512:]
    return prompts


def _post(port: int, body: dict) -> dict:
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as resp:
        return json.loads(resp.read())


def _get(port: int, path: str) -> tuple[int, str]:
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _teacher_forced_gaps(params, cfg, prompt, completion):  # noqa: ANN001, ANN202
    """Per generated token: (row max - the token's logit, argmax matched),
    the sequence teacher-forced through the plain forward."""
    import dataclasses

    import torch

    from torchx_tpu_torch.models import llama

    plain = dataclasses.replace(cfg, kernels="reference", attn_impl="xla", remat=False)
    seq = torch.tensor([prompt + completion[:-1]], device="cuda")
    with torch.no_grad():
        logits = llama.forward(params, seq, plain)[0, len(prompt) - 1:]
    tok = torch.tensor(completion, device="cuda")
    chosen = logits.gather(1, tok[:, None])[:, 0]
    gaps = (logits.max(dim=1).values - chosen).tolist()
    matched = (logits.argmax(dim=1) == tok).tolist()
    return gaps, matched


def _percentile(xs: list[float], q: float) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))]


def phase_serve() -> dict:
    """The serving path at llama3_1b full width and depth (module
    docstring, phase 5). -> the serve line's numbers."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from torchx_tpu_torch import _build
    from torchx_tpu_torch.apps import generate_server
    from torchx_tpu_torch.models import generate as gen
    from torchx_tpu_torch.models import llama
    from torchx_tpu_torch.serve.engine import ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t_setup = time.monotonic()
    server = generate_server.serve(
        "llama3_1b", port=0, device="cuda", max_batch=SERVE["max_batch"],
        block_size=SERVE["block_size"])
    service = server.service
    engine = service._engine
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port = server.server_address[1]
    cfg, params = service.cfg, service.params
    setup_s = time.monotonic() - t_setup

    # time every decode step of the engine's loop with its active slots
    steps: list[tuple[int, float]] = []
    decode_once = engine._decode_once

    def timed_decode() -> bool:
        active = sum(s is not None for s in engine._slots)
        t0 = time.perf_counter()
        worked = decode_once()
        if worked:
            steps.append((active, time.perf_counter() - t0))
        return worked

    engine._decode_once = timed_decode
    # and every prefill group: (rows, bucket width, seconds to its tokens)
    prefills: list[tuple[int, int, float]] = []
    prefill_chunk = gen.paged_prefill_chunk

    def timed_prefill(params_, tokens, *args):  # noqa: ANN001, ANN202
        t0 = time.perf_counter()
        first = prefill_chunk(params_, tokens, *args).cpu()
        prefills.append((*tokens.shape, time.perf_counter() - t0))
        return first

    gen.paged_prefill_chunk = timed_prefill
    # the measured batch arrives as one burst: admission waits until all
    # of it is queued (otherwise the first arrival is prefilled alone)
    gate = threading.Event()
    gate.set()
    admit = engine._admit

    def gated_admit() -> bool:
        gate.wait()
        return admit()

    engine._admit = gated_admit
    try:
        prompts = _serve_prompts(cfg.vocab_size)
        n_new = SERVE["new_tokens"]
        bodies = [{"tokens": [p], "max_new_tokens": n_new, "temperature": t, "seed": sd}
                  for p, (_, t, sd) in zip(prompts, SERVE_REQUESTS)]
        # one short request first: cuBLAS and the allocator warm up outside
        # the measured batch
        _post(port, {"tokens": [[1, 2, 3]], "max_new_tokens": 2})
        steps.clear()
        prefills.clear()
        gate.clear()
        t0 = time.monotonic()
        with ThreadPoolExecutor(len(bodies)) as pool:
            futures = [pool.submit(_post, port, b) for b in bodies]
            deadline = time.monotonic() + 60
            while engine.queue_depth < len(bodies) and time.monotonic() < deadline:
                time.sleep(0.001)
            gate.set()
            replies = [f.result() for f in futures]
        batch_s = time.monotonic() - t0
        burst_steps, burst_prefills = list(steps), list(prefills)
        full_steps = [dt for active, dt in burst_steps if active == SERVE["max_batch"]]
        outs = [r["tokens"][0] for r in replies]
        completions = [o[len(p):] for o, p in zip(outs, prompts)]
        if any(len(c) != n_new for c in completions):
            fail("serve", f"completion lengths {[len(c) for c in completions]} != {n_new}")

        # sampled: the same-seed pair agrees, seed 8 differs
        seed8 = _post(port, {**bodies[1], "seed": 8})["tokens"][0][len(prompts[1]):]
        # prefix cache: a greedy re-send hits and equals its cold answer
        # (the shortest prompt: its cold and warm prefills differ least in
        # width, so bf16 rounding differs least)
        hits0 = engine.stats()["prefix_cache"]["hits"]
        resend = _post(port, bodies[0])["tokens"][0]
        prefix = engine.stats()["prefix_cache"]
        health_code, health = _get(port, "/healthz")
        metric_code, metricz = _get(port, "/metricz")
        peak = torch.cuda.max_memory_allocated()
        pool_bytes = sum(t.numel() * t.element_size() for t in engine.pools.values())
        on_card = all(t.is_cuda for t in list(engine.pools.values()) + llama.leaves(params))

        # greedy, bf16, full depth: teacher-forced logit gaps
        gaps, matched = [], []
        for i, (_, temp, _) in enumerate(SERVE_REQUESTS):
            if temp == 0:
                g, m = _teacher_forced_gaps(params, cfg, prompts[i], completions[i])
                gaps += g
                matched += m
    finally:
        gen.paged_prefill_chunk = prefill_chunk
        server.shutdown()
        service.close()
        server.server_close()
    launches = _build.launch_counts()
    ttft = [r["timing"]["ttft_ms"] for r in replies]
    tpot = [(r["timing"]["total_ms"] - r["timing"]["ttft_ms"]) / (n_new - 1) for r in replies]
    out = {
        "phase": "serve", "config": "llama3_1b", "n_layers": cfg.n_layers, "dim": cfg.dim,
        "dtype": "bfloat16", "engine": "continuous", "setup_s": setup_s,
        "requests": len(replies), "new_tokens": n_new,
        "prompt_lens": [n for n, _, _ in SERVE_REQUESTS],
        "ttft_ms": ttft, "ttft_p50_ms": _percentile(ttft, 0.5), "ttft_max_ms": max(ttft),
        "ttft_1500_ms": ttft[7], "tpot_ms": tpot, "tpot_p50_ms": _percentile(tpot, 0.5),
        "tpot_max_ms": max(tpot),
        "decode_steps": len(burst_steps), "full_steps": len(full_steps),
        "decode_step_full_ms": 1e3 * sum(full_steps) / max(1, len(full_steps)),
        "decode_ms_total": 1e3 * sum(dt for _, dt in burst_steps),
        "prefills": [{"rows": r, "width": w, "ms": 1e3 * dt} for r, w, dt in burst_prefills],
        "batch_s": batch_s, "tokens_per_s": len(replies) * n_new / batch_s,
        "peak_memory_bytes": peak,
        "pool": {"num_blocks": engine.num_blocks, "block_size": engine.block_size,
                 "blocks_per_slot": engine.blocks_per_slot, "max_slots": engine.max_slots,
                 "bytes": pool_bytes},
        "greedy_max_logit_gap": max(gaps), "greedy_gap_tol": SERVE_LOGIT_GAP,
        "greedy_argmax_share": sum(matched) / len(matched), "greedy_tokens": len(gaps),
        "sampled_equal": completions[1] == completions[2],
        "seed8_differs": seed8 != completions[1],
        "prefix_hits": prefix["hits"] - hits0, "prefix_cache": prefix,
        "resend_equal": resend == outs[0],
        "healthz": health_code, "metricz": metric_code,
        "on_card": on_card, "launches": launches,
    }
    emit(out)
    if not max(gaps) <= SERVE_LOGIT_GAP:
        fail("serve", f"greedy logit gap {max(gaps)} > {SERVE_LOGIT_GAP}")
    if not (out["sampled_equal"] and out["seed8_differs"]):
        fail("serve", "sampled requests: same seed differs or seed 8 agrees")
    if not (out["resend_equal"] and out["prefix_hits"] > 0):
        fail("serve", "the greedy re-send missed the prefix cache or changed")
    if not on_card:
        fail("serve", "pools or parameters are not on the card")
    if health_code != 200 or metric_code != 200 or "tpx_serve_tokens_total" not in metricz:
        fail("serve", f"healthz {health_code} / metricz {metric_code}: {health[:200]}")
    if any(launches.values()):
        fail("serve", f"the serving path launched a kernel of the kernels line: {launches}")
    if not full_steps:
        fail("serve", "no decode step ran with all slots busy")

    # greedy, f32, 2 layers: the engine equals the dense generate exactly
    cfg32 = llama.llama3_1b(n_layers=2, dtype=torch.float32)
    gen32 = torch.Generator(device="cuda")
    gen32.manual_seed(SERVE["seed"])
    params32 = llama.init_params(cfg32, gen32, "cuda")
    for leaf in llama.leaves(params32):
        leaf.requires_grad_(False)
    eng32 = ServeEngine(params32, cfg32, max_slots=SERVE["max_batch"],
                        block_size=SERVE["block_size"]).start()
    try:
        reqs = [eng32.generate(prompts[i], n_new, timeout=300) for i in F32_PROMPTS]
    finally:
        eng32.stop()
    exact = []
    for i, r in zip(F32_PROMPTS, reqs):
        dense = gen.generate(params32, torch.tensor([prompts[i]], device="cuda"), cfg32, n_new)
        exact.append(r.tokens == dense[0].tolist())
    emit({"phase": "serve", "check": "f32 engine equals dense generate", "n_layers": 2,
          "prompt_lens": [SERVE_REQUESTS[i][0] for i in F32_PROMPTS], "equal": exact})
    if not all(exact):
        fail("serve", f"f32 engine tokens differ from the dense generate: {exact}")
    return out


#: Kernel-name fragments -> the group a step's device time is booked to.
PROFILE_GROUPS = (
    ("flash_fwd", ("flash_fwd_wgmma_kernel", "flash_fwd_kernel")),
    ("flash_dq", ("flash_dq_wgmma_kernel", "flash_dq_kernel")),
    ("flash_dkv", ("flash_dkv_wgmma_kernel", "flash_dkv_kernel")),
    ("norm_res_fwd", ("norm_res_fwd_kernel",)),
    ("rms_norm_bwd", ("rms_norm_bwd_kernel", "dw_reduce_kernel")),
    ("matmul", ("gemm", "xmma", "cutlass", "nvjet", "sm90_")),
    ("gather/scatter", ("index", "gather", "scatter")),
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
    emit({"phase": "profile", "path": "train step", **_device_summary(prof, wall)})
    del params, step, batch
    _profile_decode()


def _device_summary(prof, wall_s: float) -> dict:  # noqa: ANN001
    """Device time by kernel group and the top kernels of a profile, and
    the device's busy share of ``wall_s``."""
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
    return {"step_wall_ms": wall_s * 1e3, "device_busy_ms": busy,
            "device_busy_share": busy / (wall_s * 1e3), "groups_ms": groups,
            "top_kernels": [{"name": n[:120], "ms": ms, "count": c} for n, (ms, c) in top]}


def _profile_decode() -> None:
    """Profile one paged decode step of llama3_1b at 8 busy slots, each
    1024 tokens deep in the engine's default pool (after two warm-up
    steps): the host's share of an eager decode step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from torchx_tpu_torch.models import generate as gen
    from torchx_tpu_torch.models import llama

    cfg = llama.llama3_1b()
    torch.cuda.empty_cache()
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    params = llama.init_params(cfg, g, "cuda")
    for leaf in llama.leaves(params):
        leaf.requires_grad_(False)
    slots, bs, depth = SERVE["max_batch"], SERVE["block_size"], 1024
    bpr = cfg.max_seq // bs
    pools = gen.init_kv_pools(cfg, 1 + slots * (bpr // 2), bs, "cuda")
    tables = torch.zeros((slots, bpr), dtype=torch.int64, device="cuda")
    per = depth // bs
    tables[:, :per] = 1 + torch.arange(slots * per, device="cuda").view(slots, per)
    positions = torch.full((slots,), depth - 1, dtype=torch.int64, device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (slots,), generator=g, device="cuda")
    seeds = torch.zeros((slots,), dtype=torch.int64, device="cuda")
    temps = torch.zeros((slots,), device="cuda")

    def step():  # noqa: ANN202
        return gen.paged_decode_step(params, tokens, positions, tables, pools, cfg,
                                     seeds, temps).cpu()

    step()
    step()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        step()
        wall = time.monotonic() - t0
    emit({"phase": "profile", "path": "decode step", "slots": slots, "depth": depth,
          **_device_summary(prof, wall)})


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
    if "serve" in phases:
        phase_serve()
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
