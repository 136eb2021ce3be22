"""``tpx-torch`` CLI entry point: the port of :mod:`torchx_tpu.cli.main`
(reference analog: torchx/cli/main.py).

Subcommands can be overridden/extended via the ``tpx_torch.cli.cmds``
entry-point group (reference cli/main.py:51-71).

Dispatch is LAZY: ``main`` peeks at argv for the command name and imports
only that subcommand's module, so ``tpx-torch list`` never pays for the
run path's deps and ``tpx-torch --help`` renders from name-only stubs
without importing any subcommand at all. ``get_sub_cmds`` /
``create_parser()`` (no ``only``) remain the eager full-registry views.

The command table keeps every name of the JAX package's, in its order. A
command whose layer is not ported yet is a stand-in from
:mod:`~torchx_tpu_torch.cli.cmd_unported` that exits 1 naming the ROADMAP
item that brings it.
"""

from __future__ import annotations

import argparse
import importlib
import logging
import sys
from typing import Optional

from torchx_tpu_torch.cli.cmd_base import SubCommand
from torchx_tpu_torch.version import __version__

CMDS_ENTRYPOINT_GROUP = "tpx_torch.cli.cmds"

# name -> (module, class): the static dispatch table. Kept as strings so
# `tpx-torch <cmd>` imports exactly one of these modules; order is the help
# / registry order. "tracker" is optional (extra deps) — see _load_cmd.
BUILTIN_CMDS: dict[str, tuple[str, str]] = {
    "run": ("torchx_tpu_torch.cli.cmd_run", "CmdRun"),
    "lint": ("torchx_tpu_torch.cli.cmd_unported", "CmdLint"),
    "explain": ("torchx_tpu_torch.cli.cmd_unported", "CmdExplain"),
    "tune": ("torchx_tpu_torch.cli.cmd_unported", "CmdTune"),
    "supervise": ("torchx_tpu_torch.cli.cmd_supervise", "CmdSupervise"),
    "status": ("torchx_tpu_torch.cli.cmd_simple", "CmdStatus"),
    "describe": ("torchx_tpu_torch.cli.cmd_simple", "CmdDescribe"),
    "list": ("torchx_tpu_torch.cli.cmd_simple", "CmdList"),
    "log": ("torchx_tpu_torch.cli.cmd_log", "CmdLog"),
    "trace": ("torchx_tpu_torch.cli.cmd_trace", "CmdTrace"),
    "profile": ("torchx_tpu_torch.cli.cmd_profile", "CmdProfile"),
    "cancel": ("torchx_tpu_torch.cli.cmd_simple", "CmdCancel"),
    "delete": ("torchx_tpu_torch.cli.cmd_simple", "CmdDelete"),
    "resize": ("torchx_tpu_torch.cli.cmd_simple", "CmdResize"),
    "watch": ("torchx_tpu_torch.cli.cmd_simple", "CmdWatch"),
    "runopts": ("torchx_tpu_torch.cli.cmd_simple", "CmdRunopts"),
    "builtins": ("torchx_tpu_torch.cli.cmd_simple", "CmdBuiltins"),
    "configure": ("torchx_tpu_torch.cli.cmd_simple", "CmdConfigure"),
    "tracker": ("torchx_tpu_torch.cli.cmd_tracker", "CmdTracker"),
    "serve-pool": ("torchx_tpu_torch.cli.cmd_serve_pool", "CmdServePool"),
    "control": ("torchx_tpu_torch.cli.cmd_control", "CmdControl"),
    "cell": ("torchx_tpu_torch.cli.cmd_unported", "CmdCell"),
    "queue": ("torchx_tpu_torch.cli.cmd_queue", "CmdQueue"),
    "top": ("torchx_tpu_torch.cli.cmd_unported", "CmdTop"),
    "pipeline": ("torchx_tpu_torch.cli.cmd_pipeline", "CmdPipeline"),
    "sim": ("torchx_tpu_torch.cli.cmd_unported", "CmdSim"),
    "selfcheck": ("torchx_tpu_torch.cli.cmd_unported", "CmdSelfcheck"),
}


def _load_builtin(name: str) -> SubCommand:
    module, cls = BUILTIN_CMDS[name]
    return getattr(importlib.import_module(module), cls)()


def _load_cmd(name: str) -> Optional[SubCommand]:
    """Load ONE command by name, or None when unknown/unloadable.

    Precedence matches the eager registry: the builtin tracker shadows a
    plugin of the same name; every other plugin shadows its builtin; a
    broken plugin falls back to the builtin it shadowed (or None)."""
    if name == "tracker":
        try:
            return _load_builtin("tracker")
        except ImportError:
            pass  # optional deps missing: fall through to a plugin, if any
    from torchx_tpu_torch.util.entrypoints import load_group

    loader = load_group(CMDS_ENTRYPOINT_GROUP).get(name)
    if loader is not None:
        try:
            return loader()()
        except Exception:  # noqa: BLE001 - a broken plugin must not kill the CLI
            pass
    if name in BUILTIN_CMDS and name != "tracker":
        return _load_builtin(name)
    return None


def _known_cmds() -> list[str]:
    """Every dispatchable command name, WITHOUT importing any command
    module ("tracker" is listed optimistically; its import is validated
    on load). Metadata-only entry-point scan for plugins."""
    names = list(BUILTIN_CMDS)
    from torchx_tpu_torch.util.entrypoints import load_group

    names += [n for n in load_group(CMDS_ENTRYPOINT_GROUP) if n not in names]
    return names


def _peek_cmd(argv: list[str]) -> Optional[str]:
    """First positional token of argv = the subcommand name (skipping the
    global options and, for ``--log_level``, its value)."""
    it = iter(argv)
    for tok in it:
        if tok in ("--log_level", "--log-level"):
            next(it, None)  # skip the level value
            continue
        if tok.startswith("-"):
            continue  # --version / --help / --log_level=X
        return tok
    return None


def get_sub_cmds() -> dict[str, SubCommand]:
    """The full eager registry (imports every command module): builtins,
    then entry-point plugins (which may override builtins), then the
    optional tracker command."""
    cmds: dict[str, SubCommand] = {
        name: _load_builtin(name) for name in BUILTIN_CMDS if name != "tracker"
    }
    from torchx_tpu_torch.util.entrypoints import load_group

    for name, loader in load_group(CMDS_ENTRYPOINT_GROUP).items():
        try:
            cmds[name] = loader()()
        except Exception:  # noqa: BLE001 - a broken plugin must not kill the CLI
            pass
    try:
        cmds["tracker"] = _load_builtin("tracker")
    except ImportError:
        pass
    return cmds


def _base_parser() -> tuple[argparse.ArgumentParser, argparse._SubParsersAction]:
    parser = argparse.ArgumentParser(
        prog="tpx-torch",
        description="tpx-torch — the universal job launcher on PyTorch and CUDA",
    )
    parser.add_argument(
        "--version", action="version", version=f"tpx-torch {__version__}"
    )
    parser.add_argument("--log_level", default="INFO", help="client log level")
    subparsers = parser.add_subparsers(title="sub-commands", dest="cmd")
    return parser, subparsers


def create_parser(only: Optional[str] = None) -> argparse.ArgumentParser:
    """The ``tpx-torch`` argument parser.

    With ``only=<cmd>`` (the lazy dispatch path) just that command's
    module is imported and registered; unknown/unloadable names register
    nothing, so parsing then yields argparse's invalid-choice error.
    Without ``only``, the full eager registry is registered."""
    parser, subparsers = _base_parser()
    if only is None:
        for name, cmd in get_sub_cmds().items():
            sub = subparsers.add_parser(name)
            cmd.add_arguments(sub)
            sub.set_defaults(func=cmd.run)
        return parser
    cmd = _load_cmd(only)
    if cmd is not None:
        sub = subparsers.add_parser(only)
        cmd.add_arguments(sub)
        sub.set_defaults(func=cmd.run)
    return parser


def _stub_parser() -> argparse.ArgumentParser:
    """A parser whose subcommands are name-only stubs: renders the full
    help listing and argparse's invalid-choice diagnostics without
    importing a single command module."""
    parser, subparsers = _base_parser()
    for name in _known_cmds():
        subparsers.add_parser(name)
    return parser


def main(argv: Optional[list[str]] = None) -> None:
    args_list = sys.argv[1:] if argv is None else list(argv)
    cmd_name = _peek_cmd(args_list)
    if cmd_name is not None and cmd_name in _known_cmds():
        parser = create_parser(only=cmd_name)
    else:
        # no command / --help / --version / unknown command
        parser = _stub_parser()
    args = parser.parse_args(args_list)
    logging.basicConfig(
        level=getattr(logging, str(args.log_level).upper(), logging.INFO),
        format="%(levelname)s %(asctime)s %(name)s: %(message)s",
        stream=sys.stderr,
    )
    if not hasattr(args, "func"):
        parser.print_help()
        sys.exit(1)
    from torchx_tpu_torch.runner.api import UnknownSchedulerError

    try:
        args.func(args)
    except (UnknownSchedulerError, NotImplementedError) as e:
        # NotImplementedError: a seam that names the ROADMAP item of a
        # layer the port has not brought over yet (the runner's lint gate,
        # the fleet placer's memory oracle)
        print(f"error: {e}", file=sys.stderr)
        sys.exit(1)
    except BrokenPipeError:
        # `tpx-torch ... | head` closed the pipe; not an error
        try:
            sys.stdout.close()
        except Exception:  # noqa: BLE001
            pass
        sys.exit(0)


if __name__ == "__main__":
    main()
