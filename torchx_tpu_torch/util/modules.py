"""Dynamic import helpers (reference analog: torchx/util/modules.py).

Library surface for plugin/user code resolving ``pkg.module:attr``
strings and optional-dependency attributes without hard imports. The
launcher's own registries (schedulers, finder) keep their eager variants
on purpose — a broken builtin must raise loudly, while a broken PLUGIN
string degrades to "absent", which is what these helpers encode.
"""

from __future__ import annotations

import importlib
from types import ModuleType
from typing import Any, Callable, Optional, TypeVar, Union

T = TypeVar("T")


def load_module(path: str) -> Optional[Union[ModuleType, Callable[..., Any]]]:
    """Resolve ``full.module.path[:attr]`` to the module or its attribute;
    ``None`` when anything along the way fails to import (callers treat a
    bad plugin string as absent, not fatal)."""
    module_path, _, attr = path.partition(":")
    try:
        module = importlib.import_module(module_path)
        return getattr(module, attr) if attr else module
    except Exception:  # noqa: BLE001 - any import-time failure means "not loadable"
        return None


def import_attr(name: str, attr: str, default: T) -> T:
    """``name.attr`` if the module imports, else ``default``.

    For optional dependencies: a MISSING module yields the default, but a
    module that imports and lacks the attribute raises AttributeError —
    that is a bug in the module, not an absent dependency.
    """
    try:
        mod = importlib.import_module(name)
    except ModuleNotFoundError:
        return default
    return getattr(mod, attr)
