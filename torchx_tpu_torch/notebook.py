"""Notebook helpers: the ``%%workspacefile`` cell magic.

Port of :mod:`torchx_tpu.notebook`.
Reference analog: torchx/notebook.py (41 LoC) — lets notebook users build a
workspace incrementally by writing cells into an in-memory (or on-disk)
workspace directory that ``tpx run --workspace`` then packages.

Usage::

    from torchx_tpu_torch.notebook import get_workspace
    ws = get_workspace()          # a temp dir workspace for this kernel

    %%workspacefile main.py
    print("hello")

then ``runner.run_component(..., workspace=str(ws))``.
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional

_workspace_dir: Optional[str] = None


def get_workspace() -> str:
    """The kernel-lifetime workspace directory (created on first use)."""
    global _workspace_dir
    if _workspace_dir is None:
        _workspace_dir = tempfile.mkdtemp(prefix="tpx_notebook_ws_")
    return _workspace_dir


def workspacefile(line: str, cell: str) -> None:
    """``%%workspacefile relative/path.py`` cell magic body."""
    rel = line.strip()
    if not rel:
        raise ValueError("usage: %%workspacefile <relative-path>")
    ws = get_workspace()
    path = os.path.normpath(os.path.join(ws, rel))
    if os.path.isabs(rel) or not path.startswith(ws + os.sep):
        raise ValueError(
            f"workspace file path must be relative and stay inside the"
            f" workspace, got {rel!r}"
        )
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(cell)
    print(f"wrote {path}")


def load_ipython_extension(ipython) -> None:  # noqa: ANN001
    """``%load_ext torchx_tpu_torch.notebook`` registers the magic."""
    ipython.register_magic_function(workspacefile, magic_kind="cell")
