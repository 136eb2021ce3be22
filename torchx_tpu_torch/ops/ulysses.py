"""Ulysses attention: all-to-all sequence parallelism, the port of
:mod:`torchx_tpu.ops.ulysses`.

The second context-parallel strategy beside
:mod:`torchx_tpu_torch.ops.ring_attention`: instead of rotating K/V
blocks, Ulysses re-shards. A tiled all-to-all over ``sp``
(:func:`~torchx_tpu_torch.parallel.mesh.all_to_all`) turns the
sequence-sharded ``[b, s/P, h, d]`` into the head-sharded ``[b, s, h/P,
d]``, each rank runs plain causal attention over its heads
(:func:`~torchx_tpu_torch.ops.attention.xla_attention`), and a second
all-to-all transposes back. Two all-to-alls instead of ``P - 1`` hops, but
the head counts must divide by the mesh axes and each rank holds the whole
sequence for its heads. No model path calls it, as in the reference.
"""

from __future__ import annotations

from typing import Any

import torch

from torchx_tpu_torch.ops.attention import xla_attention
from torchx_tpu_torch.parallel import mesh as mesh_ops


def ulysses_attention(
    q: torch.Tensor,  # [b, s/sp, h/tp, d]: this rank's positions and heads
    k: torch.Tensor,  # [b, s/sp, kvh/tp, d]
    v: torch.Tensor,
    mesh: Any,
) -> torch.Tensor:
    """Causal attention over the ``sp``-sharded sequence through two
    all-to-alls over ``sp``; -> this rank's positions ``[b, s/sp, h/tp,
    d]``. Raises unless the query and KV head counts (whole, ``tp`` times
    the local ones) divide by ``sp x tp``, as the reference does."""
    n, h_shard = mesh.sizes["sp"], mesh.sizes["tp"]
    heads, kv_heads = q.shape[2] * h_shard, k.shape[2] * h_shard
    if heads % (n * h_shard) or kv_heads % (n * h_shard):
        raise ValueError(
            f"ulysses needs heads divisible by mesh axes sp={n} x tp={h_shard};"
            f" got q heads {heads}, kv heads {kv_heads}"
        )

    def seq_to_heads(x: torch.Tensor) -> torch.Tensor:
        return mesh_ops.all_to_all(x, 2, 1, mesh.sp_group)

    out = xla_attention(seq_to_heads(q), seq_to_heads(k), seq_to_heads(v), causal=True)
    return mesh_ops.all_to_all(out, 1, 2, mesh.sp_group)
