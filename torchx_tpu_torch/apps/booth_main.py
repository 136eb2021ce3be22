"""Booth-function test objective: the port of :mod:`torchx_tpu.apps.booth_main`
(reference analog: torchx/apps/utils/booth_main.py).

f(x1,x2) = (x1 + 2*x2 - 7)^2 + (2*x1 + x2 - 5)^2 — global min at (1, 3).
Records the value through the in-job tracker so hpo/tracker integration can
be validated end-to-end.
"""

from __future__ import annotations

import argparse


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description="booth test objective")
    parser.add_argument("--x1", type=float, required=True)
    parser.add_argument("--x2", type=float, required=True)
    args = parser.parse_args(argv)
    value = (args.x1 + 2 * args.x2 - 7) ** 2 + (2 * args.x1 + args.x2 - 5) ** 2
    from torchx_tpu_torch.tracker import app_run_from_env

    app_run_from_env().add_metadata(booth_value=value, x1=args.x1, x2=args.x2)
    print(f"booth({args.x1}, {args.x2}) = {value}")


if __name__ == "__main__":
    main()
