"""String -> typed-value decoding for component function arguments.

Reference analog: torchx/util/types.py. Component functions declare typed
params (int/str/float/bool/list[str]/dict[str,str]/Optional[...]), the CLI
passes strings, and this module decodes them according to the annotation.
"""

from __future__ import annotations

import inspect
import typing
from typing import Any, Optional, Union


def none_throws(x: Optional[Any], msg: str = "unexpected None") -> Any:
    if x is None:
        raise AssertionError(msg)
    return x


def _unwrap_optional(t: Any) -> Any:
    origin = typing.get_origin(t)
    if origin is Union or origin is getattr(__import__("types"), "UnionType", None):
        args = [a for a in typing.get_args(t) if a is not type(None)]
        if len(args) == 1:
            return args[0]
    return t


def is_bool(t: Any) -> bool:
    return _unwrap_optional(t) is bool


def decode(value: str, annotation: Any) -> Any:
    """Decode a CLI string per the annotation. Non-strings pass through."""
    if not isinstance(value, str):
        return value
    t = _unwrap_optional(annotation)
    if t in (Any, inspect.Parameter.empty, str, None):
        return value
    if t is bool:
        return value.strip().lower() in ("true", "1", "yes", "on")
    if t is int:
        return int(value)
    if t is float:
        return float(value)
    origin = typing.get_origin(t)
    if origin in (list, typing.List):
        (elem_t,) = typing.get_args(t) or (str,)
        if value == "":
            return []
        return [decode(v, elem_t) for v in value.split(",")]
    if origin in (dict, typing.Dict):
        args = typing.get_args(t) or (str, str)
        key_t, val_t = args
        out = {}
        if value == "":
            return out
        for pair in value.split(","):
            if "=" in pair:
                k, _, v = pair.partition("=")
            else:
                k, _, v = pair.partition(":")
            out[decode(k, key_t)] = decode(v, val_t)
        return out
    # fall back: constructor from string (e.g. enums, pathlib.Path)
    try:
        return t(value)
    except Exception:
        return value


def decode_optional(value: Optional[str], annotation: Any) -> Any:
    if value is None:
        return None
    return decode(value, annotation)
