"""Scored checkpoint eval: the app behind a pipeline's eval gate.

A copy of :mod:`torchx_tpu.apps.eval_main`, stdlib only, whose record and
exit codes are the reference's byte for byte. It verifies the checkpoint
it was handed (recomputes the sha256 content digest of the latest
finalized step and compares it against the MANIFEST.json record, the
digest recipe of :mod:`torchx_tpu_torch.parallel.checkpoint`), produces a
score, and writes an fsync'd JSON record the pipeline engine's eval gate
reads::

    python -m torchx_tpu_torch.apps.eval_main \\
        --ckpt /path/to/ckpt_dir --out /path/to/score.json [--score 0.97]

``--score`` forces the result (deterministic gates); without it the score
is derived from the verified digest, stable for a given checkpoint, which
is what a gate test needs from a stub evaluator. A digest mismatch
(corrupt or tampered payload) exits 1: a gate must never score garbage.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
from typing import Optional


def _digest_dir(path: str) -> str:
    """sha256 over relpath + bytes of every file, sorted — byte-for-byte
    the manifest writer's recipe (parallel/checkpoint._digest_path)."""
    h = hashlib.sha256()
    if os.path.isdir(path):
        for root, dirs, files in sorted(os.walk(path)):
            dirs.sort()
            for name in sorted(files):
                fp = os.path.join(root, name)
                h.update(os.path.relpath(fp, path).encode())
                with open(fp, "rb") as f:
                    for chunk in iter(lambda: f.read(1 << 20), b""):
                        h.update(chunk)
    else:
        with open(path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
    return h.hexdigest()


def verify_checkpoint(ckpt_dir: str) -> tuple[int, str]:
    """-> (latest_step, digest) after recomputing and matching the
    manifest's recorded digest; raises ValueError on a missing manifest,
    no finalized step, or a digest mismatch. A manifest entry without a
    digest (pre-digest checkpoint) passes unverified, matching
    ``CheckpointManager.verify_step``'s None-means-proceed contract."""
    manifest = os.path.join(ckpt_dir, "MANIFEST.json")
    try:
        with open(manifest) as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        raise ValueError(f"no readable manifest at {manifest}: {e}") from e
    step = doc.get("latest_step")
    if not isinstance(step, int) or step < 0:
        raise ValueError(f"{manifest} records no finalized step")
    rec = doc.get("steps", {}).get(str(step)) or {}
    digest = str(rec.get("digest", ""))
    payload = rec.get("path") or _step_payload(ckpt_dir, step)
    if digest and payload is not None:
        actual = _digest_dir(payload)
        if actual != digest:
            raise ValueError(
                f"checkpoint step {step} digest mismatch: manifest"
                f" {digest[:12]}… vs on-disk {actual[:12]}…"
            )
    return step, digest


def _step_payload(ckpt_dir: str, step: int) -> Optional[str]:
    """Best-effort payload path for ``step``: the orbax convention is a
    directory (or file) named after the step number."""
    for name in (str(step), f"step_{step}", f"{step}.ckpt"):
        path = os.path.join(ckpt_dir, name)
        if os.path.exists(path):
            return path
    return None


def _score_from_digest(digest: str) -> float:
    """Deterministic stub score in [0, 1) derived from the digest."""
    if not digest:
        return 0.5
    return int(digest[:8], 16) / float(0xFFFFFFFF)


def main(argv: Optional[list[str]] = None) -> int:
    """Entry point; returns the process exit code."""
    parser = argparse.ArgumentParser(
        prog="eval_main", description="score a verified checkpoint"
    )
    parser.add_argument(
        "--ckpt", required=True, help="checkpoint directory to evaluate"
    )
    parser.add_argument(
        "--out", required=True, help="where to write the score JSON record"
    )
    parser.add_argument(
        "--score",
        type=float,
        default=None,
        help="force the score (deterministic gates in tests/smoke)",
    )
    parser.add_argument(
        "--no-verify",
        action="store_true",
        help="skip the digest check (checkpoints without manifests)",
    )
    args = parser.parse_args(argv)

    step, digest = -1, ""
    if not args.no_verify:
        try:
            step, digest = verify_checkpoint(args.ckpt)
        except ValueError as e:
            print(f"eval_main: checkpoint verification failed: {e}", file=sys.stderr)
            return 1

    score = args.score if args.score is not None else _score_from_digest(digest)
    record = {
        "score": score,
        "ckpt": args.ckpt,
        "digest": digest,
        "step": step,
    }
    out_dir = os.path.dirname(os.path.abspath(args.out))
    os.makedirs(out_dir, exist_ok=True)
    tmp = args.out + ".tmp"
    with open(tmp, "w") as f:
        json.dump(record, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, args.out)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
