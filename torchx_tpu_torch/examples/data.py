"""Token-memmap input for the trainer.

Port of :class:`torchx_tpu.examples.data.TokenDataset`: random crops of
``seq+1`` tokens from the packed uint32 corpus that ``datapreproc`` writes,
per-process contiguous shards, and crops seeded per (seed, process, step),
so a run resumed at step N continues the stream at step N. The process
index and count are passed in (the JAX package asked JAX for them).
"""

from __future__ import annotations

import itertools
from typing import Iterator

import numpy as np


class TokenDataset:
    """Random-crop batches of ``seq+1`` tokens from a memmapped corpus.

    ``batch`` is the GLOBAL batch size; each process yields its
    ``batch / process_count`` local rows as int32 numpy arrays.
    """

    def __init__(
        self,
        path: str,
        seq: int,
        batch: int,
        seed: int = 0,
        start_step: int = 0,
        process_index: int = 0,
        process_count: int = 1,
    ) -> None:
        data = np.memmap(path, dtype=np.uint32, mode="r")
        pi, pc = process_index, process_count
        if batch % pc:
            raise ValueError(f"global batch {batch} not divisible by {pc} processes")
        shard_len = len(data) // pc
        if shard_len < seq + 1:
            raise ValueError(
                f"corpus shard ({shard_len} tokens) smaller than seq+1={seq + 1}"
            )
        self._data = data[pi * shard_len : (pi + 1) * shard_len]
        self._seq = seq
        self._local_batch = batch // pc
        self._seed = seed
        self._start_step = start_step
        self._pi = pi

    def __iter__(self) -> Iterator[np.ndarray]:
        # valid crop starts are [0, len - (seq+1)]; integers() high is
        # exclusive, so the bound is len - seq
        n = len(self._data) - self._seq
        for step in itertools.count(self._start_step):
            rng = np.random.default_rng((self._seed, self._pi, step))
            starts = rng.integers(0, n, size=self._local_batch)
            yield np.stack(
                [self._data[s : s + self._seq + 1] for s in starts]
            ).astype(np.int32)
