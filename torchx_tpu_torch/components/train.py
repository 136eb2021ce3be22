"""Training component pointers: the port of :mod:`torchx_tpu.components.train`
(reference analog: torchx/components/train.py).

There is deliberately no generic ``train`` component: training apps are too
varied for one template. Use :py:func:`torchx_tpu_torch.components.dist.spmd` to
launch any torch SPMD trainer (see ``torchx_tpu_torch/examples/train_llama.py`` for
the flagship example), or write a custom component
(``tpx run ./my_component.py:my_trainer``).
"""
