"""Deprecation helpers (reference analog: torchx/deprecations.py)."""

from __future__ import annotations

import functools
import warnings
from typing import Any, Callable, TypeVar

F = TypeVar("F", bound=Callable[..., Any])


def deprecated(replacement: str = "", since: str = "") -> Callable[[F], F]:
    """Mark a function deprecated; calling it emits a UserWarning once."""

    def deco(fn: F) -> F:
        msg = f"{fn.__module__}.{fn.__qualname__} is deprecated"
        if since:
            msg += f" since {since}"
        if replacement:
            msg += f"; use {replacement} instead"

        @functools.wraps(fn)
        def wrapper(*args: Any, **kwargs: Any) -> Any:
            warnings.warn(msg, UserWarning, stacklevel=2)
            return fn(*args, **kwargs)

        return wrapper  # type: ignore[return-value]

    return deco


def deprecated_module(name: str, replacement: str) -> None:
    """Call at module import time to warn the whole module is deprecated."""
    warnings.warn(
        f"module {name} is deprecated; use {replacement} instead",
        UserWarning,
        stacklevel=3,
    )
