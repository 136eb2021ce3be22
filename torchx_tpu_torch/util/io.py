"""URL-agnostic file IO over fsspec with a stdlib fallback
(reference analog: torchx/util/io.py, generalized: the reference reads
packaged conf files; training jobs also shuttle checkpoints/corpora through
``gs://`` URLs, so these helpers accept any fsspec URL).
"""

from __future__ import annotations

import os
import shutil


def copy_path(src: str, dst: str) -> None:
    """Copy a file (any fsspec URL) or a local directory tree."""
    if os.path.isdir(src):  # local tree: byte-stream open would fail
        shutil.copytree(src, dst, dirs_exist_ok=True)
        return
    try:
        import fsspec

        with fsspec.open(src, "rb") as r, fsspec.open(dst, "wb") as w:
            shutil.copyfileobj(r, w)
        return
    except ImportError:
        pass
    os.makedirs(os.path.dirname(os.path.abspath(dst)) or ".", exist_ok=True)
    shutil.copyfile(src, dst)


def read_text(path: str) -> str:
    """Text contents of a local path or fsspec URL."""
    try:
        import fsspec

        with fsspec.open(path, "r") as f:
            return f.read()
    except ImportError:
        with open(path) as f:
            return f.read()


def exists(path: str) -> bool:
    try:
        import fsspec

        fs, rel = fsspec.core.url_to_fs(path)
        return bool(fs.exists(rel))
    except ImportError:
        return os.path.exists(path)
