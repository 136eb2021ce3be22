"""StructuredOpts: dataclass sugar over runopts.

Reference analog: torchx/schedulers/api.py:79-315. Scheduler authors declare
a dataclass whose fields (with attribute docstrings) define the run config;
``to_runopts()`` generates the equivalent :class:`runopts` (docstrings become
help text, harvested from source — attribute docstrings don't exist at
runtime), and ``from_cfg`` parses a resolved cfg mapping back into a typed
instance. Nested dataclass fields flatten with dots (``k8s.context``).
"""

from __future__ import annotations

import ast
import dataclasses
import inspect
import textwrap
import typing
from typing import Any, Mapping, Optional, TypeVar, Union

from torchx_tpu_torch.specs.api import CfgVal, runopts

S = TypeVar("S", bound="StructuredOpts")


def _attr_docs(cls: type) -> dict[str, str]:
    """Attribute docstrings via AST: a string literal immediately following
    an annotated assignment (the convention sphinx documents)."""
    docs: dict[str, str] = {}
    try:
        src = textwrap.dedent(inspect.getsource(cls))
    except (OSError, TypeError):
        return docs
    tree = ast.parse(src)
    cls_node = tree.body[0]
    if not isinstance(cls_node, ast.ClassDef):
        return docs
    prev_name: Optional[str] = None
    for node in cls_node.body:
        if isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            prev_name = node.target.id
        elif (
            isinstance(node, ast.Expr)
            and isinstance(node.value, ast.Constant)
            and isinstance(node.value.value, str)
            and prev_name
        ):
            docs[prev_name] = " ".join(node.value.value.split())
            prev_name = None
        else:
            prev_name = None
    return docs


def _unwrap_optional(t: Any) -> tuple[Any, bool]:
    origin = typing.get_origin(t)
    if origin is Union or origin is getattr(__import__("types"), "UnionType", None):
        args = [a for a in typing.get_args(t) if a is not type(None)]
        if len(args) == 1:
            return args[0], True
    return t, False


def _base_type(t: Any) -> type:
    t, _ = _unwrap_optional(t)
    origin = typing.get_origin(t)
    if origin is not None:
        return origin if origin in (list, dict) else origin
    return t if isinstance(t, type) else str


@dataclasses.dataclass
class StructuredOpts:
    """Base class for typed scheduler run configs."""

    @classmethod
    def to_runopts(cls) -> runopts:
        opts = runopts()
        docs = _attr_docs(cls)
        hints = typing.get_type_hints(cls)
        for f in dataclasses.fields(cls):
            if not f.init:
                continue
            ftype = hints.get(f.name, f.type)
            inner, _ = _unwrap_optional(ftype)
            if dataclasses.is_dataclass(inner) and issubclass(inner, StructuredOpts):
                # nested group: flatten as group.key
                for key, opt in inner.to_runopts():
                    opts.add(
                        f"{f.name}.{key}",
                        type_=opt.opt_type,
                        help=opt.help,
                        default=opt.default,
                        required=opt.is_required,
                    )
                continue
            default: CfgVal
            required = False
            if f.default is not dataclasses.MISSING:
                default = f.default
            elif f.default_factory is not dataclasses.MISSING:  # type: ignore[misc]
                default = f.default_factory()  # type: ignore[misc]
            else:
                default = None
                required = True
            opts.add(
                f.name,
                type_=_base_type(ftype),
                help=docs.get(f.name, f.name),
                default=default if not required else None,
                required=required,
            )
        return opts

    @classmethod
    def from_cfg(cls: type[S], cfg: Mapping[str, CfgVal]) -> S:
        """Build a typed instance from a resolved cfg mapping (unknown keys
        ignored; nested groups gathered from dotted keys)."""
        hints = typing.get_type_hints(cls)
        kwargs: dict[str, Any] = {}
        for f in dataclasses.fields(cls):
            if not f.init:
                continue
            ftype = hints.get(f.name, f.type)
            inner, _ = _unwrap_optional(ftype)
            if dataclasses.is_dataclass(inner) and issubclass(inner, StructuredOpts):
                prefix = f.name + "."
                sub = {
                    k[len(prefix) :]: v for k, v in cfg.items() if k.startswith(prefix)
                }
                kwargs[f.name] = inner.from_cfg(sub)
                continue
            if f.name in cfg and cfg[f.name] is not None:
                kwargs[f.name] = cfg[f.name]
        return cls(**kwargs)

    # Mapping-ish access for backward compat with dict-style cfg handling
    def __getitem__(self, key: str) -> Any:
        try:
            return getattr(self, key)
        except AttributeError:
            raise KeyError(key) from None

    def get(self, key: str, default: Any = None) -> Any:
        return getattr(self, key, default)
