"""AST linter + docstring help extraction for component functions.

Reference analog: torchx/specs/file_linter.py (397 LoC). A *component* is a
plain function returning AppDef; to stay CLI-renderable it must:

* annotate every parameter with a supported type
  (str/int/float/bool/Optional of those/list[...]/dict[...]),
* annotate its return type as AppDef,
* carry a docstring (google style recommended) — the summary becomes the
  component help and the Args: entries become per-flag help.

``validate(path, fn_name)`` returns LinterMessages; ``get_fn_docstring``
parses help text with a built-in minimal google-docstring parser (no
third-party docstring_parser dependency).
"""

from __future__ import annotations

import ast
import inspect
import re
from dataclasses import dataclass
from typing import Callable, Optional

_SUPPORTED_SIMPLE = {"str", "int", "float", "bool"}
_SUPPORTED_CONTAINERS = {"list", "List", "dict", "Dict", "Optional", "Union"}


@dataclass
class LinterMessage:
    """One finding about a component function's source.

    ``code`` is the stable diagnostic code shared with the preflight
    analyzer (the launcher's ``analyze`` layer): TPX001 syntax/not-found, TPX002
    missing annotation, TPX003 unsupported type, TPX004 ``**kwargs``,
    TPX005 return annotation, TPX006 missing docstring (warning).
    """

    name: str
    description: str
    line: int = 0
    char: int = 0
    severity: str = "error"
    code: str = "TPX001"


# =========================================================================
# Docstring parsing (google style)
# =========================================================================

_SECTION_RE = re.compile(r"^\s*(Args|Arguments|Returns|Raises|Example[s]?|Note[s]?):\s*$")
_ARG_RE = re.compile(r"^\s{2,}(\*{0,2}\w+)\s*(?:\([^)]*\))?\s*:\s*(.*)$")


def parse_docstring(docstring: Optional[str]) -> tuple[str, dict[str, str]]:
    """-> (summary, {arg_name: help}). Tolerates missing/empty docstrings."""
    if not docstring:
        return "", {}
    lines = docstring.expandtabs().splitlines()
    summary_lines: list[str] = []
    args: dict[str, str] = {}
    section = None
    current_arg: Optional[str] = None
    for line in lines:
        m = _SECTION_RE.match(line)
        if m:
            section = m.group(1)
            current_arg = None
            continue
        if section is None:
            if line.strip():
                summary_lines.append(line.strip())
            elif summary_lines:
                section = "__post_summary__"
            continue
        if section in ("Args", "Arguments"):
            am = _ARG_RE.match(line)
            if am:
                current_arg = am.group(1).lstrip("*")
                args[current_arg] = am.group(2).strip()
            elif current_arg and line.strip():
                args[current_arg] += " " + line.strip()
    return " ".join(summary_lines), args


def get_fn_docstring(fn: Callable) -> tuple[str, dict[str, str]]:
    """Summary + per-arg help for a component fn; args missing from the
    docstring get a placeholder (reference file_linter.py:60-103)."""
    summary, args = parse_docstring(fn.__doc__)
    if not summary:
        summary = f"{fn.__name__} component"
    for param in inspect.signature(fn).parameters.values():
        args.setdefault(param.name, f"{param.name} (no docstring)")
    return summary, args


# =========================================================================
# AST validation
# =========================================================================


def _annotation_ok(node: Optional[ast.expr]) -> bool:
    if node is None:
        return False
    if isinstance(node, ast.Name):
        return node.id in _SUPPORTED_SIMPLE or node.id in _SUPPORTED_CONTAINERS
    if isinstance(node, ast.Attribute):
        return node.attr in _SUPPORTED_SIMPLE | _SUPPORTED_CONTAINERS
    if isinstance(node, ast.Subscript):
        return _annotation_ok(node.value)
    if isinstance(node, ast.Constant):
        if node.value is None:
            return True
        # ``from __future__ import annotations`` style string annotations:
        # "str | None", "Optional[int]", ... — parse and validate the inner
        # expression.
        if isinstance(node.value, str):
            try:
                inner = ast.parse(node.value, mode="eval")
            except SyntaxError:
                return False
            return _annotation_ok(inner.body)
        return False
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.BitOr):
        return _annotation_ok(node.left) and _annotation_ok(node.right)
    return False


def _returns_appdef(node: Optional[ast.expr]) -> bool:
    if isinstance(node, ast.Name):
        return node.id == "AppDef"
    if isinstance(node, ast.Attribute):
        return node.attr == "AppDef"
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value.endswith("AppDef")
    return False


def validate(
    path: str, component_function: str, include_warnings: bool = False
) -> list[LinterMessage]:
    """Parse the file and validate the named component fn is CLI-renderable."""
    with open(path) as f:
        source = f.read()
    return validate_source(source, component_function, path, include_warnings)


def validate_source(
    source: str,
    component_function: str,
    path: str = "<string>",
    include_warnings: bool = False,
) -> list[LinterMessage]:
    """Validate one component fn in ``source``. Returns error-severity
    messages only unless ``include_warnings`` is set (the preflight
    analyzer wants the warnings too)."""
    errors: list[LinterMessage] = []
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [
            LinterMessage(
                name=component_function,
                description=f"syntax error: {e}",
                line=e.lineno or 0,
                code="TPX001",
            )
        ]
    fn_node: Optional[ast.FunctionDef] = None
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if node.name == component_function:
                fn_node = node  # type: ignore[assignment]
                break
    if fn_node is None:
        return [
            LinterMessage(
                name=component_function,
                description=f"function {component_function!r} not found in {path}",
                code="TPX001",
            )
        ]

    def err(desc: str, node: ast.AST, code: str) -> None:
        errors.append(
            LinterMessage(
                name=component_function,
                description=desc,
                line=getattr(node, "lineno", 0),
                char=getattr(node, "col_offset", 0),
                code=code,
            )
        )

    a = fn_node.args
    all_args = list(a.posonlyargs) + list(a.args) + list(a.kwonlyargs)
    for arg in all_args:
        if arg.annotation is None:
            err(
                f"parameter {arg.arg!r} is missing a type annotation",
                arg,
                "TPX002",
            )
        elif not _annotation_ok(arg.annotation):
            err(
                f"parameter {arg.arg!r} has unsupported type"
                f" {ast.unparse(arg.annotation)} (supported:"
                " str/int/float/bool, Optional/list/dict of those)",
                arg,
                "TPX003",
            )
    if a.vararg is not None and a.vararg.annotation is not None:
        if not _annotation_ok(a.vararg.annotation):
            err(f"*{a.vararg.arg} has unsupported annotation", a.vararg, "TPX003")
    if a.kwarg is not None:
        err("**kwargs is not supported in component functions", a.kwarg, "TPX004")
    if fn_node.returns is None or not _returns_appdef(fn_node.returns):
        err(
            "component function must have return annotation -> AppDef",
            fn_node,
            "TPX005",
        )
    if ast.get_docstring(fn_node) is None:
        errors.append(
            LinterMessage(
                name=component_function,
                description=f"{component_function} is missing a docstring",
                line=fn_node.lineno,
                severity="warning",
                code="TPX006",
            )
        )
    if include_warnings:
        return errors
    return [e for e in errors if e.severity == "error"]
