"""Serving runtime: continuous batching over a paged KV cache.

Port of :mod:`torchx_tpu.serve` (its serve pool, ``serve/pool.py``, is not
ported yet):

* :mod:`torchx_tpu_torch.serve.kv_pool` — host-side paged KV-cache
  planning and block allocation (the device-side gather/scatter lives in
  :mod:`torchx_tpu_torch.ops.paged_attention`);
* :mod:`torchx_tpu_torch.serve.engine` — the continuous-batching decode
  engine: a fixed slot array, per-step admission and eviction, bucketed
  prefill interleaved with decode;
* :mod:`torchx_tpu_torch.serve.prefix_cache` — refcounted radix prefix
  cache over the pool;
* :mod:`torchx_tpu_torch.serve.kv_transfer` — the prefill->decode
  KV-block transfer seam for disaggregated serving.
"""

# Lazy re-exports (PEP 562), as the JAX package's: importing one submodule
# does not import the others.
_EXPORTS = {
    "BlockAllocator": "torchx_tpu_torch.serve.kv_pool",
    "PoolPlan": "torchx_tpu_torch.serve.kv_pool",
    "plan_pool": "torchx_tpu_torch.serve.kv_pool",
    "PrefixCache": "torchx_tpu_torch.serve.prefix_cache",
    "prefix_chain": "torchx_tpu_torch.serve.prefix_cache",
    "TransferConfig": "torchx_tpu_torch.serve.kv_transfer",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod), name)


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
