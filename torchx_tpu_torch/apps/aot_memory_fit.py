"""The memory fit table of a training config on a gang of H100s, before
renting the gang: the port of the JAX package's ``scripts/aot_memory_fit.py``.

Traces one training step of each case on meta tensors for rank 0 of the
mesh (:func:`torchx_tpu_torch.parallel.aot_fit.trace_fit`: no card, no
process group of the gang's size), and prints beside it the analytic
estimate (:func:`torchx_tpu_torch.analyze.costmodel.hbm_fit`)::

    python -m torchx_tpu_torch.apps.aot_memory_fit                  # llama3_8b, fsdp=8,tp=2
    python -m torchx_tpu_torch.apps.aot_memory_fit --config llama3_1b --mesh fsdp=4 \\
        --cases 4:2048:full,4:2048:dots,4:2048:dots_attn
    python -m torchx_tpu_torch.apps.aot_memory_fit --config llama3_1b --mesh pp=2,sp=2 \
        --ring-attention --cases 4:8192:full

Exits 1 when a case does not fit (or its trace fails).
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional

from torchx_tpu_torch.parallel.aot_fit import (
    DEFAULT_HEADROOM,
    GIB,
    H100_HBM_BYTES,
    mesh_world,
    north_star_cfg,
    trace_fit,
)


def main(argv: Optional[list[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--mesh", default="fsdp=8,tp=2",
                        help="the gang's axis sizes, e.g. fsdp=8,tp=2 (16 cards)")
    parser.add_argument("--devices", type=int, default=None,
                        help="the gang's cards, where the mesh has a -1 axis")
    parser.add_argument("--config", default="llama3_8b",
                        help="a preset; llama3_8b is traced as the north star"
                        " (dots remat, 2048-position loss chunks, the flash kernels)")
    parser.add_argument("--cases", default="8:8192:dots,16:8192:dots,16:8192:full",
                        help="comma list of batch:seq:remat_policy (global batch)")
    parser.add_argument("--hbm-bytes", type=int, default=H100_HBM_BYTES,
                        help="a card's memory (default an H100 80GB's)")
    parser.add_argument("--headroom", type=float, default=DEFAULT_HEADROOM)
    parser.add_argument("--ring-attention", action="store_true",
                        help="attention under sp as ring attention (the trainer's flag)")
    args = parser.parse_args(argv)

    from torchx_tpu_torch.analyze import costmodel
    from torchx_tpu_torch.models import llama
    from torchx_tpu_torch.parallel.mesh_config import parse_mesh_spec

    n = mesh_world(args.mesh, args.devices)
    sizes = parse_mesh_spec(args.mesh).resolve(n)
    base = north_star_cfg() if args.config == "llama3_8b" else dataclasses.replace(
        llama.get_config(args.config), kernels="cuda")
    base = dataclasses.replace(base, use_ring_attention=args.ring_attention)
    print(f"gang: {n} x H100, mesh {sizes}")
    print(f"budget: {args.hbm_bytes / GIB:.1f} GiB a card x {args.headroom} headroom")
    print("\n| batch | seq | remat | args GiB/card | temps GiB/card | peak GiB/card | fits"
          " | hbm_fit GiB/card |")
    print("|---|---|---|---|---|---|---|---|")
    ok = True
    for case in args.cases.split(","):
        b, s, policy = case.strip().split(":")
        cfg = dataclasses.replace(base, remat=True, remat_policy=policy)
        plan = costmodel.ParallelPlan(
            model=costmodel.ModelShape.of(cfg), sizes=sizes, batch=int(b), seq=int(s),
            remat_policy=policy, ring_attention=args.ring_attention,
            hbm_bytes_per_chip=args.hbm_bytes, hbm_source="override")
        analytic = costmodel.hbm_fit(plan, args.headroom).total_bytes / GIB
        try:
            r = trace_fit(cfg, args.mesh, int(b), int(s), hbm_bytes=args.hbm_bytes,
                          headroom=args.headroom, world=n)
        except Exception as e:  # noqa: BLE001 - one case's row
            print(f"| {b} | {s} | {policy} | - | - | trace failed: {e} | NO"
                  f" | {analytic:.1f} |")
            ok = False
            continue
        print(f"{r.row()} {analytic:.1f} |")
        ok = ok and r.fits
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
