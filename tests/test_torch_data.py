"""The PyTorch port's input pipeline: TokenDataset crops identical to the
JAX package's, and the Prefetcher's depth, order, wait and error
semantics, with host->device placement (synchronous on the CPU)."""

import time

import numpy as np
import pytest
import torch

from torchx_tpu.examples.data import TokenDataset as JaxTokenDataset
from torchx_tpu_torch.examples.data import TokenDataset
from torchx_tpu_torch.parallel.prefetch import Prefetcher, device_prefetch, device_put
from torch_threads import xdist_torch_threads  # noqa: F401


@pytest.fixture
def corpus(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 50_000, 10_000, dtype=np.uint32).tofile(path)
    return str(path)


class TestTokenDataset:
    @pytest.mark.parametrize("pi,pc", [(0, 1), (1, 2), (2, 4)])
    def test_crops_match_jax(self, corpus, pi, pc):
        kw = dict(seed=3, start_step=5, process_index=pi, process_count=pc)
        ours = iter(TokenDataset(corpus, 64, 8, **kw))
        ref = iter(JaxTokenDataset(corpus, 64, 8, **kw))
        for _ in range(3):
            a, b = next(ours), next(ref)
            assert a.dtype == np.int32 and a.shape == (8 // pc, 65)
            np.testing.assert_array_equal(a, b)

    def test_rejects_bad_shapes(self, corpus):
        with pytest.raises(ValueError, match="divisible"):
            TokenDataset(corpus, 64, 3, process_count=2)
        with pytest.raises(ValueError, match="smaller"):
            TokenDataset(corpus, 20_000, 2)


class TestPrefetcher:
    def test_order_and_wait_under_slow_producer(self):
        def slow():
            for i in range(8):
                time.sleep(0.005)
                yield i

        with Prefetcher(slow(), depth=2) as pf:
            assert list(pf) == list(range(8))
            assert pf.batches_served == 8 and pf.data_wait_s > 0

    def test_depth_zero_is_inline(self):
        pf = Prefetcher(iter([1, 2]), depth=0, place=lambda x: x * 10)
        assert pf._thread is None
        assert list(pf) == [10, 20]
        with pytest.raises(ValueError):
            Prefetcher(iter([]), depth=-1)

    def test_error_reaches_consumer(self):
        def bad():
            yield 1
            raise RuntimeError("corrupt shard")

        pf = Prefetcher(bad(), depth=2)
        assert next(pf) == 1
        with pytest.raises(RuntimeError, match="corrupt shard"):
            next(pf)
        pf.close()

    def test_close_releases_blocked_producer(self):
        pf = Prefetcher(iter(range(1000)), depth=1)
        next(pf)
        thread = pf._thread
        pf.close()
        thread.join(timeout=5)
        assert not thread.is_alive()

    def test_device_prefetch_on_cpu(self, corpus):
        rows = TokenDataset(corpus, 16, 4)
        with device_prefetch(({"tokens": r} for r in rows), "cpu", depth=2) as pf:
            batch = next(pf)
        assert isinstance(batch["tokens"], torch.Tensor)
        assert batch["tokens"].shape == (4, 17) and batch["tokens"].dtype == torch.int32
        np.testing.assert_array_equal(batch["tokens"].numpy(), next(iter(rows)))

    def test_device_put_passes_tensors(self):
        place = device_put("cpu")
        t = torch.arange(4)
        assert torch.equal(place(t), t)
        assert torch.equal(place({"a": np.arange(3)})["a"], torch.arange(3))
