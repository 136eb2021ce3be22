"""Which roles carry a parallelism plan: the first piece of the port of
:mod:`torchx_tpu.analyze.plan`.

The JAX analyzer resolves a role into a ``ParallelPlan`` when its args
name a ``--config`` preset it knows, and the deep preflight (``tpx
explain``, the fleet placer's memory oracle) then checks that plan's
memory fit. A role that names no preset is not plan-shaped: the JAX
preflight reports it as TPX705 info and passes it.

This module keeps the port's own copy of the reading half: recovering
the trainer's argv from a role (:func:`_script_argv`), its flags
(:func:`_flag_values`) and the preset names, so that a caller can tell a
plan-shaped role from one that is not (:func:`plan_shape`). The plan
itself, its cost model fit and the preflight's rules come with the rest
of ``analyze/`` (ROADMAP queue 1 item 2.8).

Standard library only: a launcher process loads no ``torch``.
"""

from __future__ import annotations

from typing import Optional

from torchx_tpu_torch.specs.api import Role

#: The ``--config`` presets the JAX analyzer's ``MODEL_SHAPES`` mirrors
#: (the model presets of ``models/llama.py`` and ``models/moe.py``).
MODEL_PRESETS = ("tiny", "llama3_1b", "llama3_8b", "moe_tiny", "mixtral_8x7b")

#: Serve-shaped entrypoint modules: no optimizer state, a KV pool instead
#: of activations.
SERVE_MODULES = ("torchx_tpu_torch.apps.generate_server",)


def _script_argv(role: Role) -> tuple[str, list[str]]:
    """(entry module, trainer argv) recovered from a role's arg list.

    Handles the ``dist.spmd`` shape (``-m torchx_tpu_torch.apps.spmd_main
    ... -m <user module> -- <script args>``, where the user module is the
    *last* ``-m``/``--script`` value before the ``--`` separator) and the
    direct ``python -m <module> <args>`` shape.
    """
    args = [str(a) for a in role.args]
    module = ""
    if "--" in args:
        sep = args.index("--")
        head, tail = args[:sep], args[sep + 1 :]
    else:
        head, tail = args, []
    i = 0
    last_module_at = -1
    while i < len(head):
        if head[i] in ("-m", "--script") and i + 1 < len(head):
            module = head[i + 1]
            last_module_at = i + 1
            i += 2
            continue
        i += 1
    if tail:
        return module, tail
    # direct `python -m module flags...`: the flags follow the module
    if last_module_at >= 0:
        return module, head[last_module_at + 1 :]
    return module, []


def _flag_values(argv: list[str]) -> tuple[dict[str, str], set[str]]:
    """Last-wins ``--flag value`` / ``--flag=value`` map + the set of
    bare flags seen (for store_true options)."""
    values: dict[str, str] = {}
    bare: set[str] = set()
    i = 0
    while i < len(argv):
        tok = argv[i]
        if tok.startswith("--"):
            if "=" in tok:
                k, _, v = tok.partition("=")
                values[k] = v
            elif i + 1 < len(argv) and not argv[i + 1].startswith("-"):
                values[tok] = argv[i + 1]
                bare.add(tok)
                i += 2
                continue
            else:
                bare.add(tok)
        i += 1
    return values, bare


def plan_shape(role: Role) -> Optional[tuple[str, bool]]:
    """``(config, serve)`` when the role is plan-shaped, else None.

    Plan-shaped is the JAX analyzer's own test (``plan_from_role``): the
    role's trainer argv names a ``--config`` in :data:`MODEL_PRESETS`.
    ``serve`` is True when the entry module is a serving one."""
    module, argv = _script_argv(role)
    if not argv and not module:
        return None
    values, _bare = _flag_values(argv)
    config = values.get("--config")
    if config is None or config not in MODEL_PRESETS:
        return None
    return config, any(m in module for m in SERVE_MODULES)
