"""Checkpoint save and restore of the trainer's state.

Port of :mod:`torchx_tpu.parallel.checkpoint`, its single-process
snapshot-then-write design written with torch. The launcher's failure story
is that schedulers restart the gang and the application makes itself
resumable; this module is the in-job half.

Layout, shared with the launcher's readers (``supervisor/api.py``'s
``latest_checkpoint_step`` and the ``eval_main`` gate)::

    <dir>/MANIFEST.json   {"latest_step": N, "steps": {"N": {"digest": ...}}}
    <dir>/<N>/state.pt    one torch.save file: a flat name -> tensor dict

A step is written as ``<dir>/<N>.tmp.<pid>/``, fsynced, then renamed to
its digit name, so a process killed mid-write never leaves a step that
looks finished. Its digest (sha256 over each file's relative path and
bytes, in sorted order) and ``latest_step`` enter the manifest only after
the payload is durable. ``restore_latest`` verifies a step against its
digest before loading it and moves a bad one aside to ``<N>.corrupt``
(``.corrupt1``, ...), with the manifest repaired; a reader opened with
``read_only=True`` (the server) skips and reports bad steps and changes
nothing on disk.

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
import os
import shutil
import threading
import time
from typing import Optional

import torch

from torchx_tpu_torch import settings

logger = logging.getLogger(__name__)

#: The payload file of a step directory.
PAYLOAD = "state.pt"


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
    ``save`` and ``restore`` end in a device sync)."""

    def __init__(
        self,
        directory: str,
        max_to_keep: int = 3,
        save_interval_steps: int = 1,
        async_save: bool = True,
        read_only: bool = False,
    ) -> None:
        self.directory = os.path.abspath(os.path.expanduser(directory))
        self.read_only = read_only
        self._max_to_keep = max_to_keep
        self._save_interval = save_interval_steps
        self._async = async_save
        if not read_only:
            os.makedirs(self.directory, exist_ok=True)
        # host snapshot buffers by name, reused by every save and restore
        self._buffers: dict[str, torch.Tensor] = {}
        # the newest write and the event set once it no longer reads the
        # buffers; an older write past that point may still be in its
        # fsync and digest
        self._writer: Optional[threading.Thread] = None
        self._released = threading.Event()
        self._released.set()
        self._older: Optional[threading.Thread] = None
        # per write in flight, by step: its record in ``writes`` and the
        # event set once it no longer reads the buffers
        self._jobs: dict[int, tuple[dict, threading.Event]] = {}
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
        #: bytes
        self.writes: list[dict] = []
        #: per restore: step, verify_s, read_s, h2d_s
        self.restores: list[dict] = []
        #: steps a restore walked past: (step, reason)
        self.skipped: list[tuple[int, str]] = []

    # -- saving ------------------------------------------------------------

    def prepare(self, state: dict[str, torch.Tensor]) -> None:
        """Allocate the host buffers for ``state`` now (pinned for CUDA
        tensors), so the first save stalls only for its copy."""
        self._buffers_for(state)

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
            self._jobs[step] = (record, released)
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
            record, released = self._jobs[step]
        try:
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
            _fsync_dir(tmp)
            if os.path.exists(final):  # a re-save of the step replaces it
                old = f"{final}.old.{os.getpid()}"
                os.rename(final, old)
                os.rename(tmp, final)
                shutil.rmtree(old)
            else:
                os.rename(tmp, final)
            _fsync_dir(self.directory)
        finally:
            if os.path.exists(tmp):
                shutil.rmtree(tmp, ignore_errors=True)
        t2 = time.monotonic()
        digest = _digest_path(final)
        if digest is None:
            raise OSError(f"cannot read back checkpoint step {final}")
        t3 = time.monotonic()
        nbytes = os.path.getsize(os.path.join(final, PAYLOAD))
        with self._manifest_lock:
            latest = self._read_manifest().get("latest_step")
            newer = isinstance(latest, int) and latest > step and os.path.isdir(
                os.path.join(self.directory, str(latest)))
            self._mutate_manifest(latest="keep" if newer else step,
                                  set_digests={step: digest})
            self._prune(step)
        record.update({
            "serialize_s": t1 - t0, "fsync_s": t2 - t1, "digest_s": t3 - t2,
            "write_s": time.monotonic() - t0, "bytes": nbytes,
        })

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
        the manifest; a failed write raises here."""
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
        self, latest: object = "keep", set_digests: Optional[dict] = None,
        drop_steps: tuple = (),
    ) -> None:
        """Atomically rewrite MANIFEST.json: ``latest`` replaces
        ``latest_step`` unless ``"keep"``; ``set_digests`` and
        ``drop_steps`` update the per-step digest table."""
        doc = self._read_manifest()
        if latest != "keep":
            doc["latest_step"] = latest
        steps = doc.get("steps")
        if not isinstance(steps, dict):
            steps = {}
        for step, digest in (set_digests or {}).items():
            steps[str(step)] = {"digest": digest}
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

        Without ``into``: -> CPU tensors memory-mapped from the payload
        (only what is touched is read). With ``into`` (name -> live tensor,
        on any device): each entry is read into the host buffers, then
        copied into its live tensor in place; the names, shapes and dtypes
        must match (:class:`CheckpointMismatch` otherwise). -> ``into``."""
        self._join()  # the step may still be in flight
        t0 = time.monotonic()
        loaded = torch.load(
            os.path.join(self.directory, str(step), PAYLOAD),
            map_location="cpu", weights_only=True, mmap=True,
        )
        loaded = {k: v for k, v in loaded.items() if k.startswith(prefix)}
        if into is None:
            return loaded
        if set(loaded) != set(into):
            raise CheckpointMismatch(
                f"step {step} holds {sorted(set(loaded) - set(into))[:5]} more and"
                f" {sorted(set(into) - set(loaded))[:5]} fewer entries than the state"
            )
        for name, dst in into.items():
            src = loaded[name]
            if src.shape != dst.shape or src.dtype != dst.dtype:
                raise CheckpointMismatch(
                    f"step {step} {name}: {tuple(src.shape)} {src.dtype} in the"
                    f" checkpoint, {tuple(dst.shape)} {dst.dtype} in the state"
                )
        host = self._buffers_for(into)
        for name in into:
            host[name].copy_(loaded[name])
        t1 = time.monotonic()
        devices = set()
        for name, dst in into.items():
            dst.copy_(host[name], non_blocking=dst.is_cuda)
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
        once."""
        steps = self.all_steps()
        if not steps:
            return None, None
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
