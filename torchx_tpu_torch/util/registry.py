"""Per-user ``key = value`` registry files with safe concurrent access.

Shared by the local scheduler's app registry and the slurm job-dir
registry (one behavior to maintain). Writers serialize on a sidecar
``.lock`` file (fcntl); compaction rewrites through a temp file +
``os.replace`` so lock-free readers only ever observe a complete old or
new file, never a truncated one.
"""

from __future__ import annotations

import logging
import os
import tempfile
from typing import Callable, Optional

logger = logging.getLogger(__name__)

COMPACT_THRESHOLD_BYTES = 256 * 1024


def record(
    path: str,
    key: str,
    value: str,
    keep: Optional[Callable[[str], bool]] = None,
) -> None:
    """Append ``key = value``; when the file is large, first drop entries
    whose value fails ``keep`` — writers hold the sidecar lock so
    concurrent appends/compactions cannot lose each other's entries."""
    try:
        with _locked(path):
            if (
                keep is not None
                and os.path.exists(path)
                and os.path.getsize(path) > COMPACT_THRESHOLD_BYTES
            ):
                _compact(path, keep)
            with open(path, "a") as f:
                f.write(f"{key} = {value}\n")
    except OSError as e:
        logger.debug("could not record %s in %s: %s", key, path, e)


def _compact(path: str, keep: Callable[[str], bool]) -> None:
    """Caller holds the lock. tmp + os.replace so readers never see a
    partial file."""
    with open(path) as f:
        lines = f.readlines()
    kept = [ln for ln in lines if keep(ln.partition(" = ")[2].strip())]
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".", prefix=".reg_")
    try:
        with os.fdopen(fd, "w") as f:
            f.writelines(kept)
        os.replace(tmp, path)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def remove(path: str, key: str) -> None:
    """Drop every entry for ``key`` (idempotent; missing file is a no-op).
    Rewrites through the same locked tmp + ``os.replace`` path as
    compaction, so readers never observe a partial file."""
    try:
        with _locked(path):
            if not os.path.exists(path):
                return
            with open(path) as f:
                lines = f.readlines()
            kept = [
                ln for ln in lines if ln.partition(" = ")[0].strip() != key
            ]
            if len(kept) == len(lines):
                return
            fd, tmp = tempfile.mkstemp(
                dir=os.path.dirname(path) or ".", prefix=".reg_"
            )
            try:
                with os.fdopen(fd, "w") as f:
                    f.writelines(kept)
                os.replace(tmp, path)
            except OSError:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
    except OSError as e:
        logger.debug("could not remove %s from %s: %s", key, path, e)


def lookup(path: str, key: str) -> Optional[str]:
    try:
        with open(path) as f:
            for line in f:
                k, _, v = line.partition(" = ")
                if k.strip() == key:
                    return v.strip()
    except OSError:
        return None
    return None


def entries(path: str) -> list[tuple[str, str]]:
    """All (key, value) pairs, later entries last (callers may dedup)."""
    try:
        with open(path) as f:
            return [
                (k.strip(), v.strip())
                for line in f
                if " = " in line
                for k, _, v in [line.partition(" = ")]
            ]
    except OSError:
        return []


class _locked:
    """Exclusive sidecar-file lock (best-effort where fcntl is missing)."""

    def __init__(self, path: str) -> None:
        self._lock_path = path + ".lock"
        self._fd: Optional[int] = None

    def __enter__(self) -> "_locked":
        self._fd = os.open(self._lock_path, os.O_RDWR | os.O_CREAT, 0o600)
        try:
            import fcntl

            fcntl.flock(self._fd, fcntl.LOCK_EX)
        except (ImportError, OSError):
            pass
        return self

    def __exit__(self, *exc) -> None:  # noqa: ANN002
        if self._fd is not None:
            os.close(self._fd)
