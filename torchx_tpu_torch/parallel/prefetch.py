"""Input prefetch for the training loop.

Port of :mod:`torchx_tpu.parallel.prefetch`. :class:`Prefetcher` keeps a
producer thread up to ``depth`` batches ahead of its consumer, running
batch assembly and the host->device copy of batch N+1 while the device
computes batch N; every moment the consumer's ``next()`` blocks is counted
in :attr:`Prefetcher.data_wait_s` and handed to the wait observer, where
one is set (the step profiler's ``observe_wait``).

Depth semantics:

* ``depth >= 1`` — a daemon producer thread and a FIFO queue of that size;
  one producer and one queue keep the order, so seeded streams stay
  deterministic.
* ``depth == 0`` — synchronous passthrough: ``next()`` runs the source and
  the placement inline, still timed as data wait.

Errors of the source or the placement are raised by the consumer's
``next()``. :meth:`Prefetcher.close` (also the context-manager exit) stops
and joins the producer.

:func:`device_put` is the placement: on a CUDA device it copies from
pinned host memory, non-blocking, on a side stream, and hands the batch
over only once the copy is done; on the CPU it is a plain synchronous copy.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Iterable, Iterator, Optional

import numpy as np
import torch

_DONE = object()  # source exhausted


class _Failure:
    """Exception crossing the thread boundary."""

    def __init__(self, exc: BaseException) -> None:
        self.exc = exc


class Prefetcher:
    """Iterator staying up to ``depth`` placed batches ahead of its consumer.

    ``source`` is any iterable of batches; ``place`` (optional) maps each
    raw batch to its device-resident form and runs on the producer thread,
    so copies overlap compute. With ``depth=0`` everything runs inline in
    ``next()``.
    """

    def __init__(
        self,
        source: Iterable[Any],
        *,
        depth: int = 2,
        place: Optional[Callable[[Any], Any]] = None,
    ) -> None:
        if depth < 0:
            raise ValueError(f"prefetch depth must be >= 0, got {depth}")
        self._source = iter(source)
        self._place = place if place is not None else (lambda x: x)
        self._wait_s = 0.0
        self._wait_observer: Optional[Callable[[float], None]] = None
        self._served = 0
        self._closed = False
        self._exhausted = False
        self._queue: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        if depth > 0:
            self._queue = queue.Queue(maxsize=depth)
            self._thread = threading.Thread(
                target=self._produce, daemon=True, name="tpx-prefetch"
            )
            self._thread.start()

    # -- producer side -----------------------------------------------------

    def _offer(self, item: Any) -> None:
        # bounded put that stays responsive to close()
        assert self._queue is not None
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.2)
                return
            except queue.Full:
                continue

    def _produce(self) -> None:
        try:
            for raw in self._source:
                self._offer(self._place(raw))
                if self._stop.is_set():
                    return
            self._offer(_DONE)
        except BaseException as e:  # noqa: BLE001 - re-raised on the consumer side
            self._offer(_Failure(e))

    # -- consumer side -----------------------------------------------------

    def __iter__(self) -> Iterator[Any]:
        return self

    def __next__(self) -> Any:
        if self._closed or self._exhausted:
            raise StopIteration
        t0 = time.monotonic()
        try:
            if self._queue is None:  # depth=0 passthrough
                try:
                    return self._place(next(self._source))
                except StopIteration:
                    self._exhausted = True
                    raise
            item = self._queue.get()
            if item is _DONE:
                self._exhausted = True
                raise StopIteration
            if isinstance(item, _Failure):
                self._exhausted = True
                raise item.exc
            self._served += 1
            return item
        finally:
            dt = time.monotonic() - t0
            self._wait_s += dt
            if self._wait_observer is not None:
                try:
                    self._wait_observer(dt)
                except Exception:  # noqa: BLE001 - observers never break the loop
                    pass

    def set_wait_observer(
        self, observer: Optional[Callable[[float], None]]
    ) -> None:
        """Install a per-``next()`` wait callback (seconds blocked), or
        None to uninstall. It runs on the consumer thread inside
        ``next()`` and sees every interval :attr:`data_wait_s` counts;
        its exceptions are swallowed."""
        self._wait_observer = observer

    @property
    def data_wait_s(self) -> float:
        """Cumulative seconds the consumer spent blocked waiting for data
        (queue waits, or inline production time in passthrough mode)."""
        return self._wait_s

    @property
    def batches_served(self) -> int:
        """Batches handed to the consumer so far (excludes queued ones)."""
        return self._served

    def close(self) -> None:
        """Stop the producer and join its thread (idempotent)."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        if self._queue is not None:
            while True:  # unblock a producer waiting on a full queue
                try:
                    self._queue.get_nowait()
                except queue.Empty:
                    break
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def __enter__(self) -> "Prefetcher":
        return self

    def __exit__(self, *exc_info: Any) -> None:
        self.close()


def device_put(device: torch.device | str) -> Callable[[Any], Any]:
    """A ``place`` callable moving host batches (numpy arrays or tensors,
    or dicts of them) onto ``device``.

    On a CUDA device: pinned host memory, a non-blocking copy on a side
    stream, and a wait for that copy on the producer thread, so the batch
    handed to the consumer is complete; the tensor is recorded on the
    consumer's stream (the stream current where this is called) so the
    allocator does not reuse its memory early. On the CPU: synchronous."""
    device = torch.device(device)
    side = consumer = None
    if device.type == "cuda":
        side = torch.cuda.Stream(device=device)
        consumer = torch.cuda.current_stream(device)

    def put_leaf(x: Any) -> torch.Tensor:
        t = torch.from_numpy(x) if isinstance(x, np.ndarray) else x
        if side is None:
            return t.to(device)
        with torch.cuda.stream(side):
            out = t.pin_memory().to(device, non_blocking=True)
        side.synchronize()
        out.record_stream(consumer)
        return out

    def place(batch: Any) -> Any:
        if isinstance(batch, dict):
            return {k: put_leaf(v) for k, v in batch.items()}
        return put_leaf(batch)

    return place


def device_prefetch(
    source: Iterable[Any],
    device: torch.device | str,
    *,
    depth: int = 2,
) -> Prefetcher:
    """:class:`Prefetcher` over host batches placed on ``device``."""
    return Prefetcher(source, depth=depth, place=device_put(device))
