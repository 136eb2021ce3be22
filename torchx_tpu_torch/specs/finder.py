"""Component finder: resolve a component name to a function.

Port of :mod:`torchx_tpu.specs.finder` (reference analog:
torchx/specs/finder.py, 501 LoC). Resolution order:

1. entry-point-registered component modules (the port's own
   ``[tpx_torch.components]`` group; the JAX launcher's ``tpx.components``
   is not read) — organizations replace the builtin namespace wholesale,
2. builtins: recursive walk of ``torchx_tpu_torch.components`` modules,
3. custom file components: ``path/to/file.py:fn_name``.

Every resolved fn is AST-linted (file_linter) so broken components fail
with line-anchored errors rather than deep argparse tracebacks.
"""

from __future__ import annotations

import importlib
import inspect
import os
import pkgutil
from dataclasses import dataclass, field
from types import ModuleType
from typing import Callable, Optional

from torchx_tpu_torch.specs.api import AppDef
from torchx_tpu_torch.specs.file_linter import get_fn_docstring, validate

COMPONENT_ENTRYPOINT_GROUP = "tpx_torch.components"


class ComponentNotFoundException(Exception):
    pass


class ComponentValidationException(Exception):
    pass


@dataclass
class _Component:
    name: str  # canonical "module.fn" or "file.py:fn"
    description: str
    fn_name: str
    fn: Callable[..., AppDef]
    validation_errors: list[str] = field(default_factory=list)


# =========================================================================
# Builtins walk
# =========================================================================


def _base_modules() -> list[ModuleType]:
    mods: list[ModuleType] = []
    try:
        from importlib.metadata import entry_points

        for ep in entry_points(group=COMPONENT_ENTRYPOINT_GROUP):
            loaded = ep.load()
            if isinstance(loaded, ModuleType):
                mods.append(loaded)
    except Exception:  # noqa: BLE001
        pass
    if not mods:
        import torchx_tpu_torch.components as builtin

        mods.append(builtin)
    return mods


def _walk_module(module: ModuleType) -> list[ModuleType]:
    """module + all submodules (recursive)."""
    out = [module]
    if hasattr(module, "__path__"):
        for info in pkgutil.walk_packages(module.__path__, module.__name__ + "."):
            if ".test" in info.name or info.name.endswith("_test"):
                continue
            try:
                out.append(importlib.import_module(info.name))
            except ImportError:
                continue
    return out


def _is_component_fn(fn: object) -> bool:
    if not inspect.isfunction(fn):
        return False
    if fn.__name__.startswith("_"):
        return False
    sig = inspect.signature(fn)
    return sig.return_annotation in (AppDef, "AppDef", "specs.AppDef")


_components_cache: Optional[dict[str, _Component]] = None


def get_components(invalidate_cache: bool = False) -> dict[str, _Component]:
    """All discoverable builtin components, keyed by short name
    (``dist.spmd``, ``utils.echo``)."""
    global _components_cache
    if _components_cache is not None and not invalidate_cache:
        return _components_cache
    out: dict[str, _Component] = {}
    for base in _base_modules():
        base_name = base.__name__
        for module in _walk_module(base):
            rel = module.__name__[len(base_name) :].lstrip(".")
            for fn_name, fn in inspect.getmembers(module, _is_component_fn):
                if fn.__module__ != module.__name__:
                    continue  # skip re-exports
                name = f"{rel}.{fn_name}" if rel else fn_name
                summary, _ = get_fn_docstring(fn)
                out[name] = _Component(
                    name=name,
                    description=summary,
                    fn_name=fn_name,
                    fn=fn,
                    validation_errors=_validate_fn(fn),
                )
    _components_cache = out
    return out


def _validate_fn(fn: Callable) -> list[str]:
    try:
        path = inspect.getfile(fn)
    except TypeError:
        return []
    errors = validate(path, fn.__name__)
    return [f"{e.line}:{e.char} {e.description}" for e in errors]


# =========================================================================
# Custom file components
# =========================================================================


def _load_custom_component(path: str, fn_name: str) -> _Component:
    if not os.path.isfile(path):
        raise ComponentNotFoundException(f"component file not found: {path}")
    errors = validate(path, fn_name)
    spec = importlib.util.spec_from_file_location(
        f"tpx_custom_component_{os.path.basename(path).removesuffix('.py')}", path
    )
    assert spec is not None and spec.loader is not None
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    fn = getattr(module, fn_name, None)
    if fn is None:
        raise ComponentNotFoundException(f"{fn_name!r} not found in {path}")
    summary, _ = get_fn_docstring(fn)
    return _Component(
        name=f"{path}:{fn_name}",
        description=summary,
        fn_name=fn_name,
        fn=fn,
        validation_errors=[f"{e.line}:{e.char} {e.description}" for e in errors],
    )


# =========================================================================
# Public resolution API
# =========================================================================


def get_component(name: str) -> _Component:
    """Resolve ``dist.spmd`` (builtin/entrypoint) or ``file.py:fn`` (custom)."""
    if ":" in name:
        path, _, fn_name = name.rpartition(":")
        component = _load_custom_component(path, fn_name)
    else:
        components = get_components()
        if name not in components:
            raise ComponentNotFoundException(
                f"component {name!r} not found; available: {sorted(components)}"
            )
        component = components[name]
    if component.validation_errors:
        raise ComponentValidationException(
            f"component {name} failed validation:\n  "
            + "\n  ".join(component.validation_errors)
        )
    return component


def get_builtin_source(name: str) -> str:
    """Source code of a builtin component fn (``tpx builtins --print``;
    reference finder.py:466-501)."""
    component = get_component(name)
    return inspect.getsource(component.fn)
