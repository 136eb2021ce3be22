"""Rotary position embeddings (RoPE), Llama-3 style.

Port of :mod:`torchx_tpu.ops.rope`: frequencies in float32, the rotation
computed in float32 and cast back to the input dtype.
"""

from __future__ import annotations

import torch


def rope_frequencies(
    head_dim: int,
    max_seq: int,
    theta: float = 500000.0,
    start: int = 0,
    device: torch.device | str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (cos, sin), each [max_seq, head_dim//2], float32.

    ``start`` offsets the position index."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    inv_freq = 1.0 / (theta ** (exponent / head_dim))
    t = torch.arange(max_seq, dtype=torch.float32, device=device) + float(start)
    freqs = torch.outer(t, inv_freq)  # [seq, head_dim/2]
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(
    x: torch.Tensor,  # [batch, seq, heads, head_dim]
    cos: torch.Tensor,  # [seq, head_dim/2] (already sliced to positions)
    sin: torch.Tensor,
) -> torch.Tensor:
    """Rotate [batch, seq, heads, head_dim] by the given frequencies."""
    x1, x2 = x.float().chunk(2, dim=-1)
    c = cos[None, :, None, :]
    s = sin[None, :, None, :]
    return torch.cat((x1 * c - x2 * s, x2 * c + x1 * s), dim=-1).to(x.dtype)
