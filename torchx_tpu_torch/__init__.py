"""torchx_tpu_torch — the PyTorch/CUDA port of torchx_tpu's Llama trainer.

The dense, single-device Llama training step of :mod:`torchx_tpu`, written
in PyTorch, with the five Pallas TPU kernels on its path rewritten by hand
for NVIDIA Hopper (``sm_90a``): the flash-attention forward and its two
backward kernels in CUDA C++ on the tensor cores (``csrc/flash_*_wgmma.cu``
for bf16 at head_dim 64 and 128, ``csrc/flash_*_mma.cu`` by mma.sync for f32
and head_dim 256), the fused residual-add + RMSNorm forward and the RMSNorm
dx+dw backward in Triton.

The package imports neither ``jax`` nor ``torchx_tpu``. Kernels are built
on first use (:mod:`torchx_tpu_torch._build`); on a CUDA tensor each
wrapper launches its kernel or raises, and only a tensor on the CPU takes
the kernel's plain PyTorch version.
"""
