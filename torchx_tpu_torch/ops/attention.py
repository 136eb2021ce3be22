"""Causal multi-head attention with GQA.

Port of :mod:`torchx_tpu.ops.attention`. Selection (``impl``):

* ``"xla"`` — plain softmax attention (f32 logits and softmax, GQA by KV
  repeat, masked logit -1e30, probabilities cast to the q dtype before the
  PV product). Runs everywhere; the numerical reference of the kernels.
  The name is kept from the JAX package, whose plain path XLA compiled.
* ``"flash"`` — the port's flash kernels (:func:`.fused.flash_attention`):
  GQA-native, O(seq) memory, masked by ``segment_ids`` where given (the
  JAX package's ``"splash"`` with ``SegmentIds``), tiled as ``block_q`` /
  ``block_kv`` ask (the splash kernel's ``BlockSizes``). On a CUDA tensor
  they launch or raise; a CPU tensor takes their plain versions.
* ``"auto"`` — the flash kernels on a CUDA tensor wherever the JAX
  package's ``auto`` picks the splash kernel on a TPU (head_dim in
  {64, 128, 256}, both sequences multiples of 128, seq >= 512, no
  ``segment_ids``), else ``"xla"``: with ``segment_ids`` ``auto`` takes
  the plain path, as the JAX ``auto`` does.
"""

from __future__ import annotations

from typing import Optional

import torch

IMPLS = ("auto", "xla", "flash")


def _repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[b, s, kv_heads, d] -> [b, s, kv_heads*n_rep, d]"""
    if n_rep == 1:
        return x
    b, s, h, d = x.shape
    return x[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(b, s, h * n_rep, d)


def xla_attention(
    q: torch.Tensor,  # [b, s, h, d]
    k: torch.Tensor,  # [b, s, kv_h, d]
    v: torch.Tensor,
    causal: bool = True,
    segment_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain softmax attention (f32 softmax, GQA via KV repeat); runs
    everywhere and is the numerical reference for the kernels."""
    n_rep = q.shape[2] // k.shape[2]
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)
    scale = q.shape[-1] ** -0.5
    # f32 operands: exact products of bf16 inputs, f32 accumulation (the
    # JAX einsum's preferred_element_type=float32)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    s_q, s_k = q.shape[1], k.shape[1]
    if causal:
        mask = torch.ones((s_q, s_k), dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~mask[None, None], -1e30)
    if segment_ids is not None:
        seg_mask = segment_ids[:, :, None] == segment_ids[:, None, :]
        logits = logits.masked_fill(~seg_mask[:, None], -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


@torch.library.custom_op("tpx::attn_out", mutates_args=())
def name_attn_out(x: torch.Tensor) -> torch.Tensor:
    """The plain attention's output as one operator's (a copy): the value
    the ``"dots_attn"`` remat policy saves, as the JAX package's
    ``checkpoint_name(attn_out, "attn_out")`` names it. The flash path
    needs no name: its forward is an operator of its own."""
    return x.clone()


@name_attn_out.register_fake
def _(x):  # noqa: ANN001, ANN202
    return torch.empty_like(x)


name_attn_out.register_autograd(lambda ctx, grad: grad)


def _flash_auto_ok(q: torch.Tensor, k: torch.Tensor) -> bool:
    """The JAX package's ``_pallas_ok`` gate, the shapes at which its
    ``auto`` picks the splash kernel."""
    _, s_q, _, d = q.shape
    s_k = k.shape[1]
    return d in (64, 128, 256) and s_q % 128 == 0 and s_k % 128 == 0 and s_q >= 512


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    segment_ids: Optional[torch.Tensor] = None,
    impl: str = "auto",
    block_q: int = 0,
    block_kv: int = 0,
) -> torch.Tensor:
    """[b, s, heads, head_dim] x3 -> [b, s, heads, head_dim].
    ``block_q``/``block_kv`` tune the flash kernels' tiling (0: the card's
    default; :func:`.fused.fit_tile`); the plain path has none."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    use_flash = impl == "flash" or (
        impl == "auto"
        and segment_ids is None
        and q.is_cuda
        and _flash_auto_ok(q, k)
    )
    if use_flash:
        from torchx_tpu_torch.ops.fused import flash_attention

        out = flash_attention(
            q, k, v, causal=causal, kernels="cuda", segment_ids=segment_ids,
            block_q=block_q, block_kv=block_kv,
        )
        if out is not None:
            return out
        if impl == "flash":
            raise ValueError(
                f"impl='flash': shapes q={tuple(q.shape)} k={tuple(k.shape)}"
                " fail the flash kernels' gate (flash_shapes_ok)"
            )
    # one operator's output, as the flash path's is: "dots_attn" saves it
    return name_attn_out(xla_attention(q, k, v, causal=causal, segment_ids=segment_ids))
