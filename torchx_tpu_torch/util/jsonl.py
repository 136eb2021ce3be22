"""Crash-safe JSONL + JSON-state helpers: the durable-IO seam.

Every journal in the repo shares one durability contract (enforced by
``tpx selfcheck`` TPX93x):

* appends are line-atomic (one ``write`` of a complete line on an
  O_APPEND handle) and flushed + fsync'd before the write is claimed
  durable — :func:`append_jsonl`;
* state files are rewritten atomically (tmp + fsync + ``os.replace``)
  so readers never observe a torn file — :func:`rewrite_json`;
* readers hold back a torn final line (a killed writer leaves at most
  one) instead of crashing or silently swallowing mid-file corruption —
  :func:`iter_jsonl` / :func:`read_jsonl`.

The helpers are stdlib-only.
"""

from __future__ import annotations

import json
import os
from typing import Any, Iterator


def append_jsonl(path: str, record: dict[str, Any]) -> None:
    """Durably append one record: mkdir + O_APPEND + flush + fsync.

    One ``write()`` of the complete newline-terminated line, so
    concurrent same-file appenders (O_APPEND is atomic on POSIX for
    short writes) interleave whole lines, never fragments."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    line = json.dumps(record, sort_keys=True) + "\n"
    with open(path, "a") as f:
        f.write(line)
        f.flush()
        os.fsync(f.fileno())


def iter_jsonl(path: str, *, skip: str = "tail") -> Iterator[dict[str, Any]]:
    """Parsed records of one JSONL file, torn-line holdback included.

    Args:
        path: the journal file; missing file yields nothing.
        skip: ``"tail"`` (default) holds back only a torn FINAL line —
            the one shape a crashed writer legally leaves — and raises
            ``ValueError`` on mid-file garbage (that is corruption, not
            a crash artifact). ``"all"`` skips every unparseable line
            (for feeds written by foreign processes, e.g. scraped
            textfiles).
    """
    if skip not in ("tail", "all"):
        raise ValueError(f"skip must be 'tail' or 'all', got {skip!r}")
    if not os.path.exists(path):
        return
    with open(path) as f:
        lines = f.readlines()
    last = len(lines) - 1
    for i, line in enumerate(lines):
        if not line.strip():
            continue
        try:
            yield json.loads(line)
        except ValueError:
            if skip == "all":
                continue
            if i == last:
                return  # torn final line from a killed writer: hold back
            raise ValueError(
                f"{path}:{i + 1}: corrupt journal line (not a torn tail)"
            )


def read_jsonl(path: str, *, skip: str = "tail") -> list[dict[str, Any]]:
    """:func:`iter_jsonl`, materialized."""
    return list(iter_jsonl(path, skip=skip))


def rewrite_json(path: str, obj: Any, *, indent: int = 2) -> None:
    """Atomically rewrite a JSON state file: tmp + fsync + os.replace.

    A process killed mid-write leaves either the old file or the new
    one, never a torn hybrid — and a concurrent reader always sees a
    complete document."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=indent)
        f.write("\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
