"""fsspec-powered copy app: the port of :mod:`torchx_tpu.apps.copy_main`
(reference analog: torchx/apps/utils/copy_main.py)."""

from __future__ import annotations

import argparse


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description="copy a file/dir between URLs")
    parser.add_argument("--src", required=True)
    parser.add_argument("--dst", required=True)
    args = parser.parse_args(argv)
    from torchx_tpu_torch.util.io import copy_path

    copy_path(args.src, args.dst)
    print(f"copied {args.src} -> {args.dst}")


if __name__ == "__main__":
    main()
