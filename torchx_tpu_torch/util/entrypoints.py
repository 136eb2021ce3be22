"""Deferred entry-point loading (reference analog: torchx/util/entrypoints.py).

``load_group`` returns {name: deferred-loader} so importing a package with
heavy/broken entry points costs nothing until a specific one is used.
"""

from __future__ import annotations

from typing import Any, Callable, Optional


def load_group(
    group: str, default: Optional[dict[str, Any]] = None
) -> dict[str, Callable[[], Any]]:
    try:
        from importlib.metadata import entry_points
    except ImportError:  # pragma: no cover
        return dict(default or {})
    try:
        eps = list(entry_points(group=group))
    except Exception:  # noqa: BLE001
        eps = []
    if not eps:
        return dict(default or {})

    out: dict[str, Callable[[], Any]] = {}
    for ep in eps:
        out[ep.name] = _deferred(ep)
    return out


def _deferred(ep) -> Callable[[], Any]:  # noqa: ANN001
    def load() -> Any:
        return ep.load()

    load.__name__ = f"load_{ep.name}"
    return load


def load(group: str, name: str, default: Any = None) -> Any:
    loaders = load_group(group)
    if name in loaders:
        return loaders[name]()
    return default
