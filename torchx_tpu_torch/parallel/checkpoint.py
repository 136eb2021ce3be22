"""Checkpoint save and restore of the trainer's state.

Port of :mod:`torchx_tpu.parallel.checkpoint`: its snapshot-then-write
design written with torch, for one process and for a gang of ranks that
each hold shards of the state. The launcher's failure story is that
schedulers restart the gang and the application makes itself resumable;
this module is the in-job half.

Layout, shared with the launcher's readers (``supervisor/api.py``'s
``latest_checkpoint_step`` and the ``eval_main`` gate)::

    <dir>/MANIFEST.json   {"latest_step": N, "steps": {"N": {"digest": ...}}}
    <dir>/<N>/state.pt    one process: one torch.save file, a flat name ->
                          tensor dict
    <dir>/<N>/shard-<r>.pt, <dir>/<N>/index.json
                          a gang (a ``mesh`` of more than one rank): each
                          rank's file of the blocks it owns, and rank 0's
                          index of every entry's spec, whole shape, dtype
                          and which file holds which block

In a gang each block is written once, by its first copy's rank
(:func:`~torchx_tpu_torch.parallel.mesh.holds_first_copy`: the ``dp``
and ``sp`` replicas of a block write nothing, each ``tp`` rank writes its
``tp`` blocks, each ``pp`` stage its layers' blocks, the stages' copies of
the leaves outside the layers are stage 0's, an entry whole on every rank
is rank 0's), into one
staging directory whose name rank 0 broadcasts when the checkpointer is
built. Each rank fsyncs its file and renames it to its
final name; rank 0 then waits (polling the files, with a timeout: a rank
that died leaves an error, never a step that looks finished), renames the
staging directory to the step, digests it and commits the manifest. No
other rank touches the manifest, retention or quarantine; each waits on
its writer thread until the manifest names the step, so that every rank
agrees on which steps are in flight or on disk. Restore reads any saved
layout into any mesh: a rank copies, from the files memory-mapped, the
parts of the saved blocks that overlap its own
(:func:`~torchx_tpu_torch.parallel.mesh.shard_extent`), and a reader
without a mesh gets whole tensors.

A step is written as ``<dir>/<N>.tmp.<pid>/``, fsynced, then renamed to
its digit name, so a process killed mid-write never leaves a step that
looks finished. Its digest (sha256 over each file's relative path and
bytes, in sorted order) and ``latest_step`` enter the manifest only after
the payload is durable. ``restore_latest`` verifies a step against its
digest before loading it and moves a bad one aside to ``<N>.corrupt``
(``.corrupt1``, ...), with the manifest repaired; a reader opened with
``read_only=True`` (the server) skips and reports bad steps and changes
nothing on disk. A gang restores the newest step on every rank and never
skips: rank 0 verifies the digest, every rank loads its blocks, and one
flag all-reduce makes a failure on any rank raise on every rank (ranks
that skipped independently would resume from different steps).

``save`` returns once the state is snapshotted into host buffers that the
checkpointer owns (pinned, allocated once, for CUDA tensors; the D2H copy
ends in a stream sync), so the caller may update its tensors in place the
moment it returns. Serialization, fsync, digest, manifest and retention run
on a background thread, and a write's failure is raised at the next
``save`` or ``wait``.

A save of the step already in flight, or already the newest on disk,
waits for that write and writes nothing. A save of a newer step waits only
until the write in flight has serialized the buffers, then starts beside
its fsync and digest: at most two writes are in flight, and the manifest's
``latest_step`` never moves backwards. A preemption notice that lands
during a periodic write then costs the rest of that write's serialization
and one write, not the whole of both (PERF.md).
"""

from __future__ import annotations

import hashlib
import json
import logging
import math
import os
import shutil
import threading
import time
from typing import Any, Optional

import torch

from torchx_tpu_torch import distributed, settings
from torchx_tpu_torch.parallel.mesh import holds_first_copy, parts, shard_extent
from torchx_tpu_torch.parallel.mesh_config import AXES

logger = logging.getLogger(__name__)

#: The payload file of a one-process step directory.
PAYLOAD = "state.pt"
#: A gang step's index of its entries and their blocks (rank 0's).
INDEX = "index.json"
#: Seconds a gang's commit waits for the other ranks' files (rank 0) or
#: for rank 0's manifest (the others) before it raises.
COMMIT_TIMEOUT_S = distributed.DEFAULT_TIMEOUT_S


def shard_file(rank: int) -> str:
    """The name of rank ``rank``'s file in a gang step."""
    return f"shard-{rank}.pt"


def _coords(rank: int, sizes: dict[str, int]) -> dict[str, int]:
    """Rank ``rank``'s coordinates: its index in the row-major array of
    ranks over :data:`AXES` (the mesh's own order)."""
    out = {}
    for a in reversed(AXES):
        rank, out[a] = divmod(rank, sizes[a])
    return {a: out[a] for a in AXES}


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def layout_index(entries: dict[str, tuple[tuple, tuple, torch.dtype]],
                 sizes: dict[str, int]) -> dict:
    """The index of a gang step: for every entry ``name -> (spec, whole
    shape, dtype)``, its blocks on a mesh of ``sizes``, each in the file of
    the rank that owns it, as ``{"file", "start", "stop"}`` (one bound a
    dimension). JSON-ready; rank 0 writes it as ``index.json``."""
    world = math.prod(sizes[a] for a in AXES)
    coords = [_coords(r, sizes) for r in range(world)]
    out = {}
    for name, (spec, shape, dtype) in entries.items():
        pieces = []
        for r, c in enumerate(coords):
            if holds_first_copy(spec, c):
                ext = shard_extent(spec, shape, sizes, c)
                pieces.append({"file": shard_file(r), "start": [e.start for e in ext],
                               "stop": [e.stop for e in ext]})
        out[name] = {"spec": [list(a) if isinstance(a, tuple) else a for a in spec],
                     "shape": list(shape), "dtype": _dtype_name(dtype), "pieces": pieces}
    return {"format": 1, "world": world, "mesh": {a: sizes[a] for a in AXES},
            "entries": out}


def index_files(index: dict) -> list[str]:
    """The files a gang step's index names, sorted."""
    return sorted({p["file"] for e in index["entries"].values() for p in e["pieces"]})


def _digest_path(path: str) -> Optional[str]:
    """sha256 content digest of one finalized step payload: a file hashes
    its bytes; a directory hashes every file's relpath + bytes in sorted
    order. None when unreadable. The recipe of
    ``torchx_tpu.parallel.checkpoint._digest_path``."""
    h = hashlib.sha256()
    try:
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
    except OSError:
        return None
    return h.hexdigest()


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class CheckpointMismatch(ValueError):
    """The checkpoint holds another state's names, shapes or dtypes: a
    different model, not a damaged file, so no step is quarantined."""


class Checkpointer:
    """Asynchronous checkpoints of a flat name -> tensor state: saves on
    an interval, retention of the newest ``max_to_keep`` steps, verified
    restore with fallback past corrupt steps.

    Timings of each save, write and restore are appended to
    :attr:`saves`, :attr:`writes` and :attr:`restores` (host clock;
    ``save`` and ``restore`` end in a device sync).

    ``mesh`` (anything with the ``sizes`` and ``coords`` of
    :class:`~torchx_tpu_torch.parallel.mesh.Mesh`) makes this rank's
    checkpointer one of a gang when it spans more than one rank: the state
    it is given is this rank's blocks, each entry sharded by its spec in
    ``specs`` (name -> one mesh-axis entry a dimension; a missing name is
    replicated), and every rank of the gang must build its checkpointer at
    the same point (rank 0 broadcasts the staging name over the default
    group) and call ``save`` and ``restore_latest`` with the same steps.
    :data:`COMMIT_TIMEOUT_S` bounds a gang's wait for its ranks' files and
    for rank 0's commit."""

    def __init__(
        self,
        directory: str,
        max_to_keep: int = 3,
        save_interval_steps: int = 1,
        async_save: bool = True,
        read_only: bool = False,
        mesh: Any = None,
        specs: Optional[dict[str, tuple]] = None,
    ) -> None:
        self.directory = os.path.abspath(os.path.expanduser(directory))
        self.read_only = read_only
        self._max_to_keep = max_to_keep
        self._save_interval = save_interval_steps
        self._async = async_save
        if not read_only:
            os.makedirs(self.directory, exist_ok=True)
        self._mesh = mesh
        self._specs = dict(specs or {})
        world = math.prod(mesh.sizes[a] for a in AXES) if mesh is not None else 1
        #: True for a rank of a gang (a mesh of more than one rank)
        self.gang = world > 1
        self._rank = 0
        #: a gang's staging name, rank 0's, the same on every rank
        self._tag: Optional[str] = None
        if self.gang:
            self._rank = parts(AXES, mesh.sizes, mesh.coords)[1]  # row-major
            if not read_only:
                self._tag = distributed.broadcast_from_zero(
                    f"{os.getpid()}-{time.time_ns()}")
        # host snapshot buffers by name, reused by every save and restore
        self._buffers: dict[str, torch.Tensor] = {}
        # the newest write and the event set once it no longer reads the
        # buffers; an older write past that point may still be in its
        # fsync and digest
        self._writer: Optional[threading.Thread] = None
        self._released = threading.Event()
        self._released.set()
        self._older: Optional[threading.Thread] = None
        # per write in flight, by step: its record in ``writes``, the event
        # set once it no longer reads the buffers, and (a gang's) the
        # step's index
        self._jobs: dict[int, tuple[dict, threading.Event, Optional[dict]]] = {}
        self._writer_error: Optional[BaseException] = None
        # guards the latched writer error and the writer handles, which the
        # writer threads and the step loop all touch
        self._lock = threading.Lock()
        # orders the writers' manifest rewrites and retention
        self._manifest_lock = threading.Lock()
        #: per save: step, wait_s (for the previous write), snapshot_s
        #: (buffer copies and the device sync), bytes
        self.saves: list[dict] = []
        #: per background write, in the order the writes started: step,
        #: serialize_s (torch.save), fsync_s (fsync and rename), digest_s
        #: (the sha256 read-back), write_s (all of it, to the manifest),
        #: bytes (this rank's file). In a gang, rank 0's record adds
        #: commit_wait_s (its wait for the other ranks' files), the other
        #: ranks' commit_s (their wait for rank 0's manifest; digest_s 0)
        self.writes: list[dict] = []
        #: per restore: step, verify_s (0 on a gang's ranks but rank 0),
        #: read_s, h2d_s
        self.restores: list[dict] = []
        #: steps a restore walked past: (step, reason)
        self.skipped: list[tuple[int, str]] = []

    # -- saving ------------------------------------------------------------

    def prepare(self, state: dict[str, torch.Tensor]) -> None:
        """Allocate the host buffers for ``state`` now (pinned for CUDA
        tensors; in a gang, for the entries this rank writes only), so the
        first save stalls only for its copy."""
        self._buffers_for(self._owned(state))

    @property
    def buffer_bytes(self) -> int:
        """Bytes of the host snapshot buffers this checkpointer holds
        (pinned where the state is on the card)."""
        return sum(b.numel() * b.element_size() for b in self._buffers.values())

    def _spec(self, name: str, ndim: int) -> tuple:
        return tuple(self._specs.get(name, (None,) * ndim))

    def _owned(self, state: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """The entries of ``state`` this rank writes: all of them off a
        gang; in a gang, the blocks whose first copy it holds."""
        if not self.gang:
            return state
        return {k: v for k, v in state.items()
                if holds_first_copy(self._spec(k, v.dim()), self._mesh.coords)}

    def _index_of(self, state: dict[str, torch.Tensor]) -> dict:
        """A gang step's index for ``state``, this rank's blocks: each
        entry's whole shape is its block's times the parts of its spec."""
        entries = {}
        for name, t in state.items():
            spec = self._spec(name, t.dim())
            whole = tuple(n * parts(axes, self._mesh.sizes, self._mesh.coords)[0]
                          for n, axes in zip(t.shape, spec))
            entries[name] = (spec, whole, t.dtype)
        return layout_index(entries, self._mesh.sizes)

    def _buffers_for(self, state: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        out = {}
        for name, t in state.items():
            buf = self._buffers.get(name)
            if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
                buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
                self._buffers[name] = buf
            out[name] = buf
        return out

    def save(self, step: int, state: dict[str, torch.Tensor], force: bool = False) -> bool:
        """Save ``state`` as ``step`` if the interval policy says so (or
        ``force``). -> whether a save was started (async) or done (sync).

        When ``step`` is the step in flight or the newest on disk, this
        waits until it is durable and returns False: the step is written
        once, with or without ``force``. Otherwise it returns once the
        snapshot is in host memory: it waits until the write in flight no
        longer reads the buffers and any older write is done (their errors
        raised here), then copies every tensor into the buffers and syncs
        the device; the new write runs beside the rest of the previous
        one."""
        if self.read_only:
            raise RuntimeError(f"checkpointer for {self.directory} is read-only")
        if step % self._save_interval and not force:
            return False
        t0 = time.monotonic()
        with self._lock:
            in_flight = step in self._jobs
        if in_flight or step == next(iter(self._list_steps()), None):
            self.wait()
            self.saves.append({"step": step, "wait_s": time.monotonic() - t0,
                               "snapshot_s": 0.0, "bytes": 0, "rewrite_skipped": True})
            return False
        self._join(older=True)  # at most two writes in flight
        self._released.wait()
        self._raise_writer_error()
        t1 = time.monotonic()
        index = self._index_of(state) if self.gang else None
        state = self._owned(state)
        host = self._buffers_for(state)
        devices = set()
        for name, t in state.items():
            t = t.detach()
            host[name].copy_(t, non_blocking=t.is_cuda)
            if t.is_cuda:
                devices.add(t.device)
        for dev in devices:
            torch.cuda.current_stream(dev).synchronize()
        nbytes = sum(b.numel() * b.element_size() for b in host.values())
        self.saves.append({"step": step, "wait_s": t1 - t0,
                           "snapshot_s": time.monotonic() - t1, "bytes": nbytes})
        record = {"step": step}
        self.writes.append(record)
        released = threading.Event()
        with self._lock:
            self._jobs[step] = (record, released, index)
        if not self._async:
            self._write(step, host)
            return True
        t = threading.Thread(
            target=self._writer_main, args=(step, host),
            name=f"tpx-ckpt-writer-{step}", daemon=True,
        )
        with self._lock:
            self._older = self._writer
            self._writer, self._released = t, released
        t.start()
        return True

    def _writer_main(self, step: int, host: dict[str, torch.Tensor]) -> None:
        try:
            self._write(step, host)
        except BaseException as e:  # noqa: BLE001 - latched, re-raised at wait/save
            with self._lock:
                self._writer_error = e

    def _write(self, step: int, host: dict[str, torch.Tensor]) -> None:
        """Payload to ``<step>.tmp.<pid>`` (then the buffers are released
        to the next snapshot), fsync, rename to
        ``<step>``; then the digest (a read-back of the file) and
        ``latest_step`` into the manifest, then retention. ``latest_step``
        never names a step that is not durable, and never moves back to an
        older step whose write ends after a newer one's."""
        with self._lock:
            record, released, index = self._jobs[step]
        try:
            if self.gang:
                self._write_gang_step(step, host, record, released, index)
            else:
                self._write_step(step, host, record, released)
        finally:
            released.set()
            with self._lock:
                del self._jobs[step]

    def _write_step(
        self, step: int, host: dict[str, torch.Tensor], record: dict,
        released: threading.Event,
    ) -> None:
        t0 = time.monotonic()
        final = os.path.join(self.directory, str(step))
        tmp = f"{final}.tmp.{os.getpid()}"
        try:
            os.makedirs(tmp)
            payload = os.path.join(tmp, PAYLOAD)
            try:
                torch.save(host, payload)
            finally:
                released.set()
            t1 = time.monotonic()
            fd = os.open(payload, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
            self._publish(tmp, final)
        finally:
            if os.path.exists(tmp):
                shutil.rmtree(tmp, ignore_errors=True)
        t2 = time.monotonic()
        nbytes = os.path.getsize(os.path.join(final, PAYLOAD))
        digest_s = self._commit(step, final, {})
        record.update({
            "serialize_s": t1 - t0, "fsync_s": t2 - t1, "digest_s": digest_s,
            "write_s": time.monotonic() - t0, "bytes": nbytes,
        })

    def _publish(self, tmp: str, final: str) -> None:
        """The durable staging directory ``tmp`` renamed to the step's
        ``final`` name (a re-save of the step replaces it), then the
        directory entry made durable."""
        _fsync_dir(tmp)
        if os.path.exists(final):
            old = f"{final}.old.{os.getpid()}"
            os.rename(final, old)
            os.rename(tmp, final)
            shutil.rmtree(old)
        else:
            os.rename(tmp, final)
        _fsync_dir(self.directory)

    def _commit(self, step: int, final: str, extra: dict) -> float:
        """The durable step ``final``'s digest, then ``latest_step`` and the
        digest (and ``extra``) into the manifest, then retention. -> the
        digest's seconds."""
        t0 = time.monotonic()
        digest = _digest_path(final)
        if digest is None:
            raise OSError(f"cannot read back checkpoint step {final}")
        digest_s = time.monotonic() - t0
        with self._manifest_lock:
            latest = self._read_manifest().get("latest_step")
            newer = isinstance(latest, int) and latest > step and os.path.isdir(
                os.path.join(self.directory, str(latest)))
            self._mutate_manifest(latest="keep" if newer else step,
                                  set_steps={step: {"digest": digest, **extra}})
            self._prune(step)
        return digest_s

    def _write_gang_step(
        self, step: int, host: dict[str, torch.Tensor], record: dict,
        released: threading.Event, index: dict,
    ) -> None:
        """A gang's write of ``step``: this rank's blocks to
        ``shard-<rank>.pt`` in the staging directory (fsync, then the
        rename that makes the name mean durable). Rank 0 also writes the
        index, waits for every file the index names, renames the staging
        directory to the step and commits it (:meth:`_commit`); the other
        ranks wait until the manifest names the step."""
        t0 = time.monotonic()
        final = os.path.join(self.directory, str(step))
        stage = f"{final}.tmp.{self._tag}"
        nbytes = 0
        try:
            os.makedirs(stage, exist_ok=True)
            if host:
                payload = os.path.join(stage, shard_file(self._rank))
                part = f"{payload}.part"
                try:
                    torch.save(host, part)
                finally:
                    released.set()
                t1 = time.monotonic()
                nbytes = os.path.getsize(part)
                fd = os.open(part, os.O_RDONLY)
                try:
                    os.fsync(fd)
                finally:
                    os.close(fd)
                os.rename(part, payload)
                _fsync_dir(stage)
            else:  # every block of this rank is another rank's to write
                released.set()
                t1 = time.monotonic()
            t2 = time.monotonic()
            record.update({"serialize_s": t1 - t0, "fsync_s": t2 - t1, "bytes": nbytes})
            if self._rank != 0:
                commit_s = distributed.poll_until(
                    lambda: self._committed(step), COMMIT_TIMEOUT_S,
                    f"rank 0's commit of checkpoint step {step}")
                record.update({"digest_s": 0.0, "commit_s": commit_s,
                               "write_s": time.monotonic() - t0})
                return
            tmp = os.path.join(stage, f"{INDEX}.part")
            with open(tmp, "w") as f:
                json.dump(index, f, sort_keys=True)
                f.flush()
                os.fsync(f.fileno())
            os.rename(tmp, os.path.join(stage, INDEX))
            files = [os.path.join(stage, n) for n in index_files(index)]
            commit_wait_s = distributed.poll_until(
                lambda: all(os.path.exists(p) for p in files), COMMIT_TIMEOUT_S,
                f"the ranks' files of checkpoint step {step}")
            self._publish(stage, final)
        except BaseException:
            if self._rank == 0:  # no step that looks finished
                shutil.rmtree(stage, ignore_errors=True)
            raise
        digest_s = self._commit(step, final, {"tag": self._tag})
        record.update({"commit_wait_s": commit_wait_s, "digest_s": digest_s,
                       "write_s": time.monotonic() - t0})

    def _committed(self, step: int) -> bool:
        """True once rank 0 has committed ``step`` for this gang: the
        manifest records it, or a newer step (retention may have dropped
        it since), under this gang's staging name."""
        steps = self._read_manifest().get("steps")
        if not isinstance(steps, dict):
            return False
        return any(isinstance(rec, dict) and rec.get("tag") == self._tag
                   and k.isdigit() and int(k) >= step for k, rec in steps.items())

    def _prune(self, step: int) -> None:
        """Retention after ``step``'s write: drop all but the newest
        ``max_to_keep`` steps, never a step another write is still on."""
        with self._lock:
            busy = set(self._jobs) - {step}
        pruned = [s for s in sorted(self._list_steps())[: -self._max_to_keep]
                  if s not in busy]
        for old in pruned:
            shutil.rmtree(os.path.join(self.directory, str(old)))
        if pruned:
            self._mutate_manifest(drop_steps=pruned)

    def _join(self, older: bool = False) -> None:
        """Join the older write (``older``) or both writes."""
        with self._lock:
            threads = [self._older] if older else [self._older, self._writer]
        for t in threads:
            if t is not None:
                t.join()
        with self._lock:
            if self._older in threads:
                self._older = None
            if self._writer in threads:
                self._writer = None

    def _raise_writer_error(self) -> None:
        with self._lock:
            err, self._writer_error = self._writer_error, None
        if err is not None:
            raise RuntimeError("background checkpoint write failed") from err

    def writing(self) -> bool:
        """True while a background write is in flight."""
        with self._lock:
            return any(t is not None and t.is_alive() for t in (self._writer, self._older))

    def wait(self) -> None:
        """Block until the writes in flight are durable, digested and in
        the manifest (in a gang, committed by rank 0); a failed write
        raises here."""
        self._join()
        self._raise_writer_error()

    def close(self) -> None:
        """Flush the in-flight write (its failure raises, as at
        :meth:`wait`) and release the host buffers."""
        self.wait()
        self._buffers.clear()

    # -- manifest ----------------------------------------------------------

    def _manifest_path(self) -> str:
        return os.path.join(self.directory, settings.CHECKPOINT_MANIFEST)

    def _read_manifest(self) -> dict:
        try:
            with open(self._manifest_path()) as f:
                doc = json.load(f)
            return doc if isinstance(doc, dict) else {}
        except (OSError, ValueError):
            return {}

    def _mutate_manifest(
        self, latest: object = "keep", set_steps: Optional[dict] = None,
        drop_steps: tuple = (),
    ) -> None:
        """Atomically rewrite MANIFEST.json: ``latest`` replaces
        ``latest_step`` unless ``"keep"``; ``set_steps`` (step -> its
        record, ``{"digest": ...}``) and ``drop_steps`` update the per-step
        table."""
        doc = self._read_manifest()
        if latest != "keep":
            doc["latest_step"] = latest
        steps = doc.get("steps")
        if not isinstance(steps, dict):
            steps = {}
        for step, rec in (set_steps or {}).items():
            steps[str(step)] = rec
        for step in drop_steps:
            steps.pop(str(step), None)
        doc["steps"] = steps
        path = self._manifest_path()
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    # -- reading -----------------------------------------------------------

    def _list_steps(self) -> list[int]:
        """Finalized steps on disk, newest first: digit-named directories
        (``.tmp.``, ``.old.`` and ``.corrupt`` names never match)."""
        try:
            names = os.listdir(self.directory)
        except OSError:
            return []
        return sorted(
            (int(n) for n in names
             if n.isdigit() and os.path.isdir(os.path.join(self.directory, n))),
            reverse=True,
        )

    def all_steps(self) -> list[int]:
        """Finalized steps, newest first (an in-flight write is waited
        for: it is a step once finalized)."""
        self._join()
        return self._list_steps()

    def latest_step(self) -> Optional[int]:
        """Newest finalized step, or None."""
        return next(iter(self.all_steps()), None)

    def verify_step(self, step: int) -> Optional[bool]:
        """A step's payload against its recorded digest: True verified,
        False mismatch (or the payload is gone), None no digest recorded
        (unverifiable: callers proceed)."""
        rec = self._read_manifest().get("steps", {}).get(str(step))
        digest = rec.get("digest") if isinstance(rec, dict) else None
        if not digest:
            return None
        path = os.path.join(self.directory, str(step))
        if not os.path.isdir(path):
            return False
        return _digest_path(path) == digest

    @staticmethod
    def resume_step_from_env() -> Optional[int]:
        """The step the supervisor asked this resubmitted run to resume
        from (``$TPX_RESUME_STEP``), or None on a fresh run."""
        raw = os.environ.get(settings.ENV_TPX_RESUME_STEP, "")
        try:
            return int(raw)
        except ValueError:
            return None

    def restore(
        self, step: int, into: Optional[dict[str, torch.Tensor]] = None, prefix: str = "",
    ) -> dict[str, torch.Tensor]:
        """Load ``step``'s entries whose names start with ``prefix``.

        Without ``into``: -> CPU tensors: of a one-process step read by one
        process, memory-mapped from the payload (only what is touched is
        read); else each entry's block of this rank (whole tensors off a
        gang), assembled from the blocks of the step's files. With ``into``
        (name -> live tensor, on any device; in a gang, this rank's
        blocks): each entry is read into the host buffers, then copied
        into its live tensor in place; the names, shapes (of the blocks)
        and dtypes must match (:class:`CheckpointMismatch` otherwise).
        -> ``into``."""
        self._join()  # the step may still be in flight
        t0 = time.monotonic()
        path = os.path.join(self.directory, str(step))
        if into is None and not self.gang and not os.path.exists(os.path.join(path, INDEX)):
            loaded = torch.load(os.path.join(path, PAYLOAD), map_location="cpu",
                                weights_only=True, mmap=True)
            return {k: v for k, v in loaded.items() if k.startswith(prefix)}
        return self._restore_blocks(step, path, into, prefix, t0)

    def _read_index(self, path: str) -> tuple[dict, dict[str, dict]]:
        """-> (the step's index, the files already opened by name): a gang
        step's ``index.json``; a one-process step's entries as whole
        blocks of its payload."""
        try:
            with open(os.path.join(path, INDEX)) as f:
                return json.load(f), {}
        except FileNotFoundError:
            pass
        loaded = torch.load(os.path.join(path, PAYLOAD), map_location="cpu",
                            weights_only=True, mmap=True)
        entries = {k: {"shape": list(v.shape), "dtype": _dtype_name(v.dtype),
                       "pieces": [{"file": PAYLOAD, "start": [0] * v.dim(),
                                   "stop": list(v.shape)}]}
                   for k, v in loaded.items()}
        return {"entries": entries}, {PAYLOAD: loaded}

    def _extent(self, name: str, shape: tuple) -> tuple[slice, ...]:
        """This rank's block of entry ``name`` (whole off a gang)."""
        if not self.gang:
            return tuple(slice(0, n) for n in shape)
        return shard_extent(self._spec(name, len(shape)), shape, self._mesh.sizes,
                            self._mesh.coords)

    def _restore_blocks(
        self, step: int, path: str, into: Optional[dict[str, torch.Tensor]], prefix: str,
        t0: float,
    ) -> dict[str, torch.Tensor]:
        """:meth:`restore` from the step's index: each entry's block of this
        rank copied from the parts of the saved blocks that overlap it,
        their files memory-mapped and opened only when one overlaps."""
        index, files = self._read_index(path)
        entries = {k: e for k, e in index["entries"].items() if k.startswith(prefix)}
        if into is not None and set(entries) != set(into):
            raise CheckpointMismatch(
                f"step {step} holds {sorted(set(entries) - set(into))[:5]} more and"
                f" {sorted(set(into) - set(entries))[:5]} fewer entries than the state"
            )
        owned = self._owned(into) if into is not None else {}
        out = {}
        for name, e in entries.items():
            shape, dtype = tuple(e["shape"]), getattr(torch, e["dtype"])
            ext = self._extent(name, shape)
            block = tuple(x.stop - x.start for x in ext)
            if into is not None:
                dst = into[name]
                if tuple(dst.shape) != block or dst.dtype != dtype:
                    raise CheckpointMismatch(
                        f"step {step} {name}: a {block} {dtype} block of {shape} in the"
                        f" checkpoint, {tuple(dst.shape)} {dst.dtype} in the state"
                    )
            if name in owned:  # the pinned snapshot buffer of this block
                buf = self._buffers_for({name: into[name]})[name]
            else:
                buf = torch.empty(block, dtype=dtype)
            filled = 0
            for p in e["pieces"]:
                lo = [max(a, x.start) for a, x in zip(p["start"], ext)]
                hi = [min(b, x.stop) for b, x in zip(p["stop"], ext)]
                if any(a >= b for a, b in zip(lo, hi)):
                    continue
                if p["file"] not in files:
                    files[p["file"]] = torch.load(os.path.join(path, p["file"]),
                                                  map_location="cpu", weights_only=True,
                                                  mmap=True)
                src = files[p["file"]][name]
                buf[tuple(slice(a - x.start, b - x.start) for a, b, x in zip(lo, hi, ext))] \
                    .copy_(src[tuple(slice(a - s, b - s)
                                     for a, b, s in zip(lo, hi, p["start"]))])
                filled += math.prod(b - a for a, b in zip(lo, hi))
            if filled != buf.numel():
                raise RuntimeError(f"step {step} {name}: its blocks cover {filled} of"
                                   f" {buf.numel()} elements")
            out[name] = buf
        if into is None:
            return out
        t1 = time.monotonic()
        devices = set()
        for name, dst in into.items():
            dst.copy_(out[name], non_blocking=dst.is_cuda)
            if dst.is_cuda:
                devices.add(dst.device)
        for dev in devices:
            torch.cuda.current_stream(dev).synchronize()
        self.restores.append({"step": step, "read_s": t1 - t0,
                              "h2d_s": time.monotonic() - t1})
        return into

    def restore_latest(
        self, into: Optional[dict[str, torch.Tensor]] = None, prefix: str = "",
    ) -> tuple[Optional[int], Optional[dict[str, torch.Tensor]]]:
        """-> ``(step, state)`` from the newest step that verifies and
        loads, or ``(None, None)`` when there is no step.

        Walks newest to oldest. A step whose digest mismatches, or whose
        payload fails to load, is skipped: moved aside to ``.corrupt``
        with the manifest repaired, or, read-only, listed in
        :attr:`skipped` and left alone. When every step fails this raises
        rather than let the caller reinitialize over real data loss. A
        :class:`CheckpointMismatch` (another model's state) raises at
        once.

        A gang restores the newest step on every rank, and skips nothing:
        rank 0 verifies its digest, each rank loads its blocks, and a
        failure on any rank raises on every rank (one flag all-reduce over
        the default group)."""
        steps = self.all_steps()
        if not steps:
            return None, None
        if self.gang:
            return steps[0], self._restore_gang(steps[0], into, prefix)
        last_err: Optional[BaseException] = None
        for step in steps:
            t0 = time.monotonic()
            verified = self.verify_step(step)
            verify_s = time.monotonic() - t0
            if verified is False:
                last_err = RuntimeError(f"step {step} content digest mismatch")
                self._skip(step, "content digest mismatch")
                continue
            try:
                state = self.restore(step, into, prefix)
            except CheckpointMismatch:
                raise
            except Exception as e:  # noqa: BLE001 - per-step corruption
                last_err = e
                self._skip(step, f"unreadable ({type(e).__name__}: {e})")
                continue
            if self.restores and self.restores[-1]["step"] == step:
                self.restores[-1]["verify_s"] = verify_s
            return step, state
        raise RuntimeError(
            f"all {len(steps)} retained checkpoints under {self.directory}"
            " failed to restore; refusing to silently reinitialize"
        ) from last_err

    def _restore_gang(
        self, step: int, into: Optional[dict[str, torch.Tensor]], prefix: str,
    ) -> dict[str, torch.Tensor]:
        err: Optional[BaseException] = None
        state = None
        t0 = time.monotonic()
        try:
            if self._rank == 0 and self.verify_step(step) is False:
                raise RuntimeError(f"step {step} content digest mismatch")
            verify_s = time.monotonic() - t0
            state = self.restore(step, into, prefix)
        except Exception as e:  # noqa: BLE001 - raised below, on every rank
            err = e
        if distributed.any_rank(err is not None):
            if isinstance(err, CheckpointMismatch):
                raise err
            raise RuntimeError(
                f"checkpoint step {step} under {self.directory} failed to restore on a"
                " rank of the gang; no rank falls back to an older step (move the step"
                " aside to resume from the one before)"
            ) from err
        if into is not None:
            self.restores[-1]["verify_s"] = verify_s
        return state

    def _skip(self, step: int, reason: str) -> None:
        logger.warning("checkpoint step %d: %s; trying the previous step", step, reason)
        self.skipped.append((step, reason))
        if not self.read_only:
            self._quarantine(step)

    def _quarantine(self, step: int) -> None:
        """Move a bad step aside (never delete: it is evidence) and point
        the manifest at the newest surviving step, so the supervisor never
        injects a quarantined step as the resume step."""
        path = os.path.join(self.directory, str(step))
        if os.path.exists(path):
            dst, n = f"{path}.corrupt", 0
            while os.path.exists(dst):
                n += 1
                dst = f"{path}.corrupt{n}"
            os.rename(path, dst)
            logger.warning("quarantined corrupt checkpoint %s -> %s", path, dst)
        survivors = self._list_steps()
        self._mutate_manifest(
            latest=survivors[0] if survivors else None, drop_steps=(step,)
        )
