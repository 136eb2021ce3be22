""".tpxconfig — INI-based layered configuration.

Port of :mod:`torchx_tpu.runner.config`.
Reference analog: torchx/runner/config.py (556 LoC). Sections:

* ``[<scheduler>]`` — default run-cfg values for that scheduler,
* ``[component:<name>]`` — default component arguments,
* ``[cli:<cmd>]`` — default CLI arguments (e.g. default component for run),
* ``[tracker:<name>]`` — tracker backends to enable (+ ``config = ...``).

Precedence (highest wins): explicit CLI/-cfg values > file named by
$TPXCONFIG > $HOME/.tpxconfig > ./.tpxconfig > code defaults.
"""

from __future__ import annotations

import configparser
import logging
import os
from pathlib import Path
from typing import Mapping, Optional, TextIO

from torchx_tpu_torch import settings
from torchx_tpu_torch.specs.api import CfgVal, runopts

logger = logging.getLogger(__name__)

CONFIG_FILE = ".tpxconfig"
_NONE = "None"


def _config_files(dirs: Optional[list[str]] = None) -> list[str]:
    """Ordered lowest→highest precedence."""
    files: list[str] = []
    search_dirs: list[str] = []
    if dirs is not None:
        search_dirs = dirs
    else:
        # later files override earlier ones: $TPXCONFIG > $HOME > CWD
        search_dirs = [os.getcwd(), str(Path.home())]
    for d in search_dirs:
        f = os.path.join(d, CONFIG_FILE)
        if os.path.isfile(f):
            files.append(f)
    env_file = os.environ.get(settings.ENV_TPXCONFIG)
    if env_file and os.path.isfile(env_file):
        files.append(env_file)
    return files


def _read_all(dirs: Optional[list[str]] = None) -> configparser.ConfigParser:
    cp = configparser.ConfigParser()
    # preserve case of option names (component arg names are case-sensitive)
    cp.optionxform = str  # type: ignore[method-assign,assignment]
    for f in _config_files(dirs):
        try:
            cp.read(f)
        except configparser.Error as e:
            logger.warning("skipping malformed config %s: %s", f, e)
    return cp


# =========================================================================
# Scheduler run-cfg sections
# =========================================================================


def load(scheduler: str, f: TextIO, cfg: dict[str, CfgVal]) -> None:
    """Merge the ``[{scheduler}]`` section of an open file into cfg
    (only keys not already present)."""
    cp = configparser.ConfigParser()
    cp.optionxform = str  # type: ignore[method-assign,assignment]
    cp.read_string(f.read())
    _merge_section(cp, scheduler, cfg)


def _merge_section(
    cp: configparser.ConfigParser, section: str, cfg: dict[str, CfgVal]
) -> None:
    if not cp.has_section(section):
        return
    for key, value in cp.items(section):
        if key not in cfg or cfg[key] is None:
            cfg[key] = None if value == _NONE else value


def apply(
    scheduler: str, cfg: dict[str, CfgVal], dirs: Optional[list[str]] = None
) -> None:
    """Fill missing cfg values from all .tpxconfig files on the lookup path.

    Values already in cfg (from the CLI) always win; within the files, later
    (higher-precedence) files win.
    """
    cp = _read_all(dirs)
    _merge_section(cp, scheduler, cfg)


def get_config(
    prefix: str,
    name: str,
    key: str,
    dirs: Optional[list[str]] = None,
) -> Optional[str]:
    """One value from a ``[prefix:name]`` section (e.g.
    ``get_config("component", "dist.spmd", "j")``), or None."""
    cp = _read_all(dirs)
    section = f"{prefix}:{name}"
    if cp.has_section(section) and cp.has_option(section, key):
        val = cp.get(section, key)
        return None if val == _NONE else val
    return None


def load_sections(
    prefix: str, dirs: Optional[list[str]] = None
) -> dict[str, dict[str, str]]:
    """All ``[prefix:*]`` sections -> {name: {key: value}}."""
    cp = _read_all(dirs)
    out: dict[str, dict[str, str]] = {}
    for section in cp.sections():
        if section.startswith(prefix + ":"):
            name = section[len(prefix) + 1 :]
            out[name] = dict(cp.items(section))
    return out


def load_tracker_sections(
    dirs: Optional[list[str]] = None,
) -> dict[str, Optional[str]]:
    """[tracker:<name>] sections -> {name: config-string-or-None}."""
    return {
        name: body.get("config")
        for name, body in load_sections("tracker", dirs).items()
    }


def dump(
    f: TextIO,
    schedulers: Optional[Mapping[str, runopts]] = None,
    required_only: bool = False,
) -> None:
    """Write a skeleton .tpxconfig with all (or required-only) runopts
    (used by ``tpx configure``; reference config.py dump)."""
    if schedulers is None:
        from torchx_tpu_torch.runner.api import get_runner

        with get_runner() as runner:
            schedulers = runner.run_opts()
    for name, opts in schedulers.items():
        lines = [f"[{name}]"]
        for key, opt in opts:
            if required_only and not opt.is_required:
                continue
            default = "" if opt.default is None else str(opt.default)
            comment = "" if opt.is_required else "#"
            lines.append(f"{comment}{key} = {default or _NONE}")
        lines.append("")
        f.write("\n".join(lines) + "\n")
