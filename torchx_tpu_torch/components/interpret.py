"""Interpretability component pointers: the port of
:mod:`torchx_tpu.components.interpret` (reference analog:
torchx/components/interpret.py — a docs-only stub pointing at examples).

There is no generic ``interpret`` component: model-analysis apps are
ordinary python apps. Launch them with :func:`torchx_tpu_torch.components.utils.python`
or :func:`torchx_tpu_torch.components.dist.spmd` (sharded analysis over a mesh),
e.g.::

    tpx run -s local utils.python -m my_project.analyze_attention -- --ckpt ...
"""
