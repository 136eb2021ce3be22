"""Sharded on-disk job-state store: the reconciler's durable journal (the
port's copy of :mod:`torchx_tpu.control.store`; the same shards and
records).

A control daemon tracking thousands of concurrent jobs must survive its
own death the way the supervisor does: everything it knows has to be on
disk *before* it matters, and a SIGKILL mid-write may cost at most the
final line. The store follows the
:class:`~torchx_tpu_torch.supervisor.ledger.AttemptLedger` crash-safety idiom,
scaled out to fleet write rates by sharding::

    <root>/
        meta.json          # shard count + format version, fsync'd atomic
        shard-00/events.jsonl
        shard-01/events.jsonl
        ...

Events append to the shard owned by their ``(scheduler, app_id)`` key
(stable CRC32 — NOT ``hash()``, which is seed-randomized per process), as
one complete line per ``write`` on an append-mode fd (line-atomic on
POSIX) followed by flush+fsync. Rehydration replays every shard oldest-
first and keeps the last event per app; a torn final line (writer died
mid-append) is skipped, not fatal. Shard count is pinned by ``meta.json``:
a store reopened with a different ``shards`` argument keeps the on-disk
layout (otherwise rehydration would look in the wrong shard).

Writes are best-effort from the caller's point of view — a full disk
degrades daemon restart fidelity, never a live submit path.
"""

from __future__ import annotations

import json
import os
import threading
import zlib
from typing import Optional

from torchx_tpu_torch.control.events import StateEvent

META_FILE = "meta.json"
EVENTS_FILE = "events.jsonl"
FORMAT_VERSION = 1
DEFAULT_SHARDS = 8


def shard_for(scheduler: str, app_id: str, shards: int) -> int:
    """Stable shard index for one app key (process-independent)."""
    key = f"{scheduler}/{app_id}".encode()
    return zlib.crc32(key) % max(1, shards)


class JobStateStore:
    """Durable latest-state map over every app the reconciler has seen.

    Thread-safe: the reconciler's event loop appends while daemon HTTP
    threads read ``latest``/``snapshot``. One lock per shard keeps
    concurrent appends to different shards unserialized.
    """

    def __init__(self, root: str, shards: int = DEFAULT_SHARDS) -> None:
        self.root = root
        self.shards = self._pin_shards(shards)
        self._locks = [threading.Lock() for _ in range(self.shards)]
        self._latest: dict[tuple[str, str], StateEvent] = {}
        self._latest_lock = threading.Lock()
        self.rehydrate()

    # -- layout ------------------------------------------------------------

    def _pin_shards(self, shards: int) -> int:
        """Honor an existing store's shard count over the argument, and
        persist the choice for the next process (atomic + fsync'd meta,
        the AttemptLedger ``write_meta`` idiom)."""
        meta_path = os.path.join(self.root, META_FILE)
        try:
            with open(meta_path) as f:
                existing = int(json.load(f).get("shards", 0))
            if existing > 0:
                return existing
        except (OSError, ValueError):
            pass
        shards = max(1, int(shards))
        try:
            os.makedirs(self.root, exist_ok=True)
            tmp = meta_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(
                    {"version": FORMAT_VERSION, "shards": shards}, f, sort_keys=True
                )
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, meta_path)
        except OSError:
            pass
        return shards

    def _shard_file(self, shard: int) -> str:
        return os.path.join(self.root, f"shard-{shard:02d}", EVENTS_FILE)

    # -- write side --------------------------------------------------------

    def append(self, event: StateEvent) -> None:
        """Journal one event (line-atomic append + fsync) and fold it into
        the in-memory latest-state map."""
        shard = shard_for(event.scheduler, event.app_id, self.shards)
        path = self._shard_file(shard)
        with self._locks[shard]:
            try:
                os.makedirs(os.path.dirname(path), exist_ok=True)
                with open(path, "a") as f:
                    f.write(json.dumps(event.serialize()) + "\n")
                    f.flush()
                    os.fsync(f.fileno())
            except (OSError, TypeError, ValueError):
                pass
        with self._latest_lock:
            self._latest[(event.scheduler, event.app_id)] = event

    # -- read side ---------------------------------------------------------

    def rehydrate(self) -> int:
        """Rebuild the latest-state map from every shard on disk (what a
        restarted daemon calls before serving status). Returns the number
        of distinct apps recovered; torn/garbage lines are skipped."""
        latest: dict[tuple[str, str], StateEvent] = {}
        for shard in range(self.shards):
            try:
                f = open(self._shard_file(shard))
            except OSError:
                continue
            with f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        event = StateEvent.deserialize(json.loads(line))
                    except ValueError:
                        continue  # torn final line from a killed writer
                    if event.app_id:
                        latest[(event.scheduler, event.app_id)] = event
        with self._latest_lock:
            self._latest = latest
        return len(latest)

    def latest(self, scheduler: str, app_id: str) -> Optional[StateEvent]:
        """Most recent event recorded for one app, or None."""
        with self._latest_lock:
            return self._latest.get((scheduler, app_id))

    def snapshot(self) -> dict[tuple[str, str], StateEvent]:
        """Copy of the whole latest-state map (daemon ``/v1/list`` fuel)."""
        with self._latest_lock:
            return dict(self._latest)

    def __len__(self) -> int:
        with self._latest_lock:
            return len(self._latest)
