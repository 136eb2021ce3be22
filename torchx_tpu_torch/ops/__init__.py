"""Ops of the Llama training step: RoPE, attention, RMSNorm and the fused
kernels (flash attention, residual-add + RMSNorm)."""
