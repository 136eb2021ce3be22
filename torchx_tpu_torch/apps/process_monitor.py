"""process_monitor — run a command with timeout / start-on-file / exit-on-file.

Port of :mod:`torchx_tpu.apps.process_monitor`.
Reference analog: torchx/apps/utils/process_monitor.py. Wraps a sidecar
process (e.g. a TensorBoard server) so it starts only once a marker file
exists (the trainer wrote its first logs) and exits once another appears
(training finished) or a timeout lapses — the glue that lets finite jobs
host infinite servers.

    python -m torchx_tpu_torch.apps.process_monitor \
        --timeout 3600 \
        --start_on_file /mnt/logs/STARTED \
        --exit_on_file /mnt/logs/DONE \
        -- tensorboard --logdir /mnt/logs
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time


def _exists(path: str) -> bool:
    if "://" in path:
        try:
            import fsspec

            fs, _, (p,) = fsspec.get_fs_token_paths(path)
            return fs.exists(p)
        except ImportError:
            raise SystemExit("fsspec required for remote marker files")
    return os.path.exists(path)


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--timeout", type=float, default=0, help="seconds; 0 = none")
    parser.add_argument("--start_on_file", default=None)
    parser.add_argument("--exit_on_file", default=None)
    parser.add_argument("--poll_interval", type=float, default=5.0)
    parser.add_argument("cmd", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    cmd = args.cmd
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        parser.error("no command given")

    deadline = time.monotonic() + args.timeout if args.timeout else None

    if args.start_on_file:
        while not _exists(args.start_on_file):
            if deadline and time.monotonic() > deadline:
                print(f"timeout waiting for {args.start_on_file}", file=sys.stderr)
                sys.exit(1)
            time.sleep(args.poll_interval)

    proc = subprocess.Popen(cmd)
    try:
        while True:
            rc = proc.poll()
            if rc is not None:
                sys.exit(rc)
            if args.exit_on_file and _exists(args.exit_on_file):
                break
            if deadline and time.monotonic() > deadline:
                break
            time.sleep(args.poll_interval)
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()


if __name__ == "__main__":
    main()
