"""Built-in components: plain functions returning AppDef.

Discovered by specs.finder; names are relative to this package
(``dist.spmd``, ``utils.echo``). Port of :mod:`torchx_tpu.components`
(reference analog: torchx/components/).
"""
