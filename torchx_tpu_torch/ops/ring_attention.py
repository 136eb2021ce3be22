"""Ring attention: causal attention over sequence shards (context
parallel), the port of :mod:`torchx_tpu.ops.ring_attention`.

Long-context training shards the sequence over the ``sp`` mesh axis.
Attention then needs every query to see all earlier keys, which live on
other ranks. Each rank keeps its query block and passes its K/V block
around the ``sp`` ring (:func:`~torchx_tpu_torch.parallel.mesh.ppermute`,
``n - 1`` hops), merging the blocks it sees with an online softmax (running
max ``m``, normaliser ``l``, f32 accumulator), so that no rank ever forms
logits wider than one block.

With sequence blocks laid out contiguously (block ``i`` holds positions
``[i * B, (i + 1) * B)``), block ``j`` is fully visible to query block
``i`` when ``j < i``, causal when ``j == i`` and masked when ``j > i``. A
masked block adds exactly 0, so its arithmetic is skipped; it still
travels, since the ring feeds the next rank.

Each ring step runs under ``torch.utils.checkpoint``, as the JAX package
checkpoints its scan step: the backward recomputes the block's logits
instead of keeping an ``[n, b, h, sq, sk]`` stack. The K/V blocks travel at
their own KV head count; the reference repeats them to every query head
first, which sends ``n_heads / n_kv_heads`` times the bytes for the same
output. The products are plain torch einsums, as the reference's are
outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch.utils.checkpoint import checkpoint

from torchx_tpu_torch.ops.attention import name_attn_out
from torchx_tpu_torch.parallel import mesh as mesh_ops

_NEG_INF = -1e30

#: Block modes: skipped (masked), causal (the diagonal), fully visible.
SKIP, CAUSAL, FULL = 0, 1, 2


def block_mode(src: int, mine: int) -> int:
    """How query block ``mine`` sees K/V block ``src``."""
    return CAUSAL if src == mine else FULL if src < mine else SKIP


def _merge(
    q: torch.Tensor,  # [b, sq, h, d]
    kv: torch.Tensor,  # [2, b, sk, kvh, d]: one K/V block
    o: torch.Tensor,  # [b, h, sq, d] f32
    m: torch.Tensor,  # [b, h, sq] f32
    l: torch.Tensor,  # [b, h, sq] f32
    causal: bool,
    scale: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The online-softmax merge of one visible block into ``(o, m, l)``.
    Query head ``j`` reads KV head ``j // (h / kvh)`` (the reference's KV
    repeat), here as a grouped product."""
    b, sq, h, d = q.shape
    kvh, sk = kv.shape[3], kv.shape[2]
    k, v = kv[0].float(), kv[1].float()
    qg = q.float().reshape(b, sq, kvh, h // kvh, d)
    # f32 operands: exact products of bf16 inputs, f32 accumulation
    logits = torch.einsum("bqgrd,bkgd->bgrqk", qg, k).reshape(b, h, sq, sk) * scale
    if causal:
        tril = torch.ones((sq, sk), dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~tril, _NEG_INF)
    m_new = torch.maximum(m, logits.amax(dim=-1))
    alpha = torch.exp(m - m_new)  # rescales the earlier blocks' sums
    p = torch.exp(logits - m_new[..., None])
    l_new = l * alpha + p.sum(dim=-1)
    pv = torch.einsum("bgrqk,bkgd->bgrqd", p.reshape(b, kvh, h // kvh, sq, sk), v)
    return o * alpha[..., None] + pv.reshape(b, h, sq, d), m_new, l_new


def ring_attention(
    q: torch.Tensor,  # [b, s/sp, h, d]: this rank's positions
    k: torch.Tensor,  # [b, s/sp, kvh, d]
    v: torch.Tensor,
    mesh: Any,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Causal attention of this ``sp`` rank's query block over the whole
    sequence, whose K/V blocks the ``sp`` ranks pass around their ring.
    ``q``, ``k`` and ``v`` are this rank's positions (``mesh.positions``)
    at its local heads; -> its positions' output ``[b, s/sp, h, d]`` in
    ``q``'s dtype, named for the ``"dots_attn"`` remat policy
    (:func:`~torchx_tpu_torch.ops.attention.name_attn_out`). Differentiable:
    the backward of each hop sends the K/V gradient back one rank. Every
    rank of the ``sp`` group must call it."""
    n, mine = mesh.sizes["sp"], mesh.coords["sp"]
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    b, sq, h, d = q.shape
    o = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, sq), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    kv = torch.stack([k, v])  # one message a hop
    for i in range(n):
        if i:
            kv = mesh_ops.ppermute(kv, mesh.sp_group, 1)
        mode = block_mode((mine - i) % n, mine)
        if mode == SKIP:
            # nothing to merge, but the block's gradient must exist on every
            # rank: each hop's backward sends and receives on all ranks of
            # the ring at once, so no rank may leave one out
            o = o + 0.0 * kv.sum()
            continue
        o, m, l = checkpoint(_merge, q, kv, o, m, l, mode == CAUSAL, scale,
                             use_reentrant=False)
    out = o / torch.clamp(l[..., None], min=1e-30)
    return name_attn_out(out.transpose(1, 2).to(q.dtype))
