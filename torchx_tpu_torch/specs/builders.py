"""Component materialization: fn signature -> argparse -> AppDef.

Reference analog: torchx/specs/builders.py (376 LoC). Given a component
function, build an argparse parser from its signature + docstring, decode
the typed values, call the function, and return the AppDef.
"""

from __future__ import annotations

import argparse
import inspect
from typing import Any, Callable, Mapping, Optional

from torchx_tpu_torch.specs.api import AppDef
from torchx_tpu_torch.specs.file_linter import get_fn_docstring
from torchx_tpu_torch.util.types import decode


class ComponentArgumentError(Exception):
    pass


class _NoExitArgumentParser(argparse.ArgumentParser):
    """argparse that raises instead of sys.exit so library callers survive."""

    def error(self, message: str) -> None:  # type: ignore[override]
        raise ComponentArgumentError(f"{self.prog}: {message}\n{self.format_usage()}")


class ComponentHelpFormatter(argparse.HelpFormatter):
    """Marks required flags in help (reference TorchXArgumentHelpFormatter,
    file_linter.py:35-57)."""

    def _get_help_string(self, action: argparse.Action) -> str:
        help_str = action.help or ""
        if action.required:
            return f"{help_str} (required)"
        if action.default is not None and action.default != argparse.SUPPRESS:
            return f"{help_str} (default: {action.default})"
        return help_str


def build_parser(
    fn: Callable[..., AppDef],
    prog: Optional[str] = None,
) -> tuple[argparse.ArgumentParser, dict[str, inspect.Parameter]]:
    """Create the parser for a component fn. VAR_POSITIONAL params become
    trailing positional args (the common ``*script_args`` pattern)."""
    summary, arg_help = get_fn_docstring(fn)
    parser = _NoExitArgumentParser(
        prog=prog or fn.__name__,
        description=summary,
        formatter_class=ComponentHelpFormatter,
        # '-h' belongs to the component ('--help' still works): a component
        # may legitimately define an '-h' named-resource flag
        # (reference builders.py:52-63)
        add_help=False,
    )
    parser.add_argument(
        "--help", action="help", default=argparse.SUPPRESS, help="show this help"
    )
    params: dict[str, inspect.Parameter] = {}
    try:
        sig = inspect.signature(fn, eval_str=True)
    except (NameError, TypeError):
        sig = inspect.signature(fn)
    for name, param in sig.parameters.items():
        params[name] = param
        help_text = arg_help.get(name, "")
        if param.kind == inspect.Parameter.VAR_POSITIONAL:
            parser.add_argument(
                name, nargs=argparse.REMAINDER, help=help_text, default=[]
            )
            continue
        if param.kind == inspect.Parameter.VAR_KEYWORD:
            raise ComponentArgumentError(
                f"component {fn.__name__} uses **{name}; not supported"
            )
        flag = f"--{name}"
        aliases = [flag]
        if len(name) == 1:
            aliases = [f"-{name}", flag]
        if param.default is inspect.Parameter.empty:
            parser.add_argument(*aliases, required=True, help=help_text, type=str)
        else:
            default = param.default
            parser.add_argument(
                *aliases, required=False, help=help_text, type=str, default=default
            )
    return parser, params


def materialize_appdef(
    fn: Callable[..., AppDef],
    cli_args: list[str],
    defaults: Optional[Mapping[str, str]] = None,
) -> AppDef:
    """Parse CLI-style args against the component signature and invoke it.

    ``defaults`` (from .tpxconfig ``[component:<name>]`` sections) fill in
    any flag the CLI didn't pass.
    """
    if defaults:
        cli_args = _apply_defaults(cli_args, defaults)
    parser, params = build_parser(fn)
    parsed = parser.parse_args(cli_args)

    call_args: list[Any] = []
    call_kwargs: dict[str, Any] = {}
    for name, param in params.items():
        value = getattr(parsed, name)
        if param.kind == inspect.Parameter.VAR_POSITIONAL:
            # REMAINDER may capture a leading "--" separator; drop it
            rest = list(value)
            if rest and rest[0] == "--":
                rest = rest[1:]
            ann = (
                param.annotation
                if param.annotation is not inspect.Parameter.empty
                else str
            )
            call_args.extend(decode(v, ann) for v in rest)
            continue
        decoded = (
            decode(value, param.annotation) if isinstance(value, str) else value
        )
        call_kwargs[name] = decoded

    appdef = fn(*call_args, **call_kwargs)
    if not isinstance(appdef, AppDef):
        raise ComponentArgumentError(
            f"component {fn.__name__} returned {type(appdef).__name__}, expected AppDef"
        )
    return appdef


def _apply_defaults(cli_args: list[str], defaults: Mapping[str, str]) -> list[str]:
    """Prepend --k v pairs for defaults not explicitly passed. Must come
    before any VAR_POSITIONAL remainder, hence prepend."""
    present = set()
    for a in cli_args:
        if a.startswith("--"):
            present.add(a[2:].split("=", 1)[0])
        if a == "--":
            break
    extra: list[str] = []
    for k, v in defaults.items():
        if k not in present:
            extra.extend([f"--{k}", v])
    return extra + cli_args


def component_args_from_str(args_str: str) -> list[str]:
    """Split a shell-ish component arg string (reference builders.py:155)."""
    import shlex

    return shlex.split(args_str)
