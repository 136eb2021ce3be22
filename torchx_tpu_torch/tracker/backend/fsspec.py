"""Filesystem-tree tracker backend.

Port of :mod:`torchx_tpu.tracker.backend.fsspec`.
Reference analog: torchx/tracker/backend/fsspec.py (291 LoC). Encodes runs,
artifacts, metadata and lineage as a directory tree on any fsspec-mountable
filesystem (local, gs://, s3://):

    <root>/<quoted_run_id>/
        artifacts/<name>.json      {"name","path","metadata"}
        metadata.json              merged key-value metadata
        sources/<quoted_source>.json

Works without the fsspec package for plain local paths (a GCS/S3 root then
requires fsspec to be importable).
"""

from __future__ import annotations

import json
import os
import urllib.parse
from typing import Any, Iterable, Mapping, Optional

from torchx_tpu_torch.tracker.api import TrackerArtifact, TrackerBase, TrackerSource


def _quote(run_id: str) -> str:
    return urllib.parse.quote(run_id, safe="")


def _unquote(name: str) -> str:
    return urllib.parse.unquote(name)


class _LocalFS:
    """Minimal fs shim so local roots need no fsspec install."""

    def makedirs(self, path: str, exist_ok: bool = True) -> None:
        os.makedirs(path, exist_ok=exist_ok)

    def open(self, path: str, mode: str):  # noqa: ANN202
        if "w" in mode:
            os.makedirs(os.path.dirname(path), exist_ok=True)
        return open(path, mode)

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def ls(self, path: str) -> list[str]:
        try:
            return [os.path.join(path, p) for p in os.listdir(path)]
        except FileNotFoundError:
            return []


class _RemoteFS:
    """Adapts an fsspec filesystem to the _LocalFS contract (missing
    directories list as empty instead of raising)."""

    def __init__(self, fs) -> None:  # noqa: ANN001
        self._fs = fs

    def makedirs(self, path: str, exist_ok: bool = True) -> None:
        self._fs.makedirs(path, exist_ok=exist_ok)

    def open(self, path: str, mode: str):  # noqa: ANN202
        return self._fs.open(path, mode)

    def exists(self, path: str) -> bool:
        return self._fs.exists(path)

    def ls(self, path: str) -> list[str]:
        try:
            return list(self._fs.ls(path, detail=False))
        except FileNotFoundError:
            return []


def _fs_for(root: str):  # noqa: ANN202
    if "://" in root:
        import fsspec

        fs, _, _ = fsspec.get_fs_token_paths(root)
        return _RemoteFS(fs)
    return _LocalFS()


class FsspecTracker(TrackerBase):
    def __init__(self, root: str) -> None:
        self._root = root.rstrip("/")
        self._fs = _fs_for(root)

    # -- paths --------------------------------------------------------------

    def _run_dir(self, run_id: str) -> str:
        return f"{self._root}/{_quote(run_id)}"

    # -- artifacts ----------------------------------------------------------

    def add_artifact(
        self,
        run_id: str,
        name: str,
        path: str,
        metadata: Optional[Mapping[str, Any]] = None,
    ) -> None:
        p = f"{self._run_dir(run_id)}/artifacts/{_quote(name)}.json"
        with self._fs.open(p, "w") as f:
            json.dump({"name": name, "path": path, "metadata": dict(metadata or {})}, f)

    def artifacts(self, run_id: str) -> Mapping[str, TrackerArtifact]:
        out = {}
        for p in self._fs.ls(f"{self._run_dir(run_id)}/artifacts"):
            with self._fs.open(p, "r") as f:
                data = json.load(f)
            out[data["name"]] = TrackerArtifact(
                name=data["name"], path=data["path"], metadata=data.get("metadata")
            )
        return out

    # -- metadata -----------------------------------------------------------

    def add_metadata(self, run_id: str, **kwargs: Any) -> None:
        p = f"{self._run_dir(run_id)}/metadata.json"
        existing: dict[str, Any] = {}
        if self._fs.exists(p):
            with self._fs.open(p, "r") as f:
                existing = json.load(f)
        existing.update(kwargs)
        with self._fs.open(p, "w") as f:
            json.dump(existing, f, default=str)

    def metadata(self, run_id: str) -> Mapping[str, Any]:
        p = f"{self._run_dir(run_id)}/metadata.json"
        if not self._fs.exists(p):
            return {}
        with self._fs.open(p, "r") as f:
            return json.load(f)

    # -- lineage ------------------------------------------------------------

    def add_source(
        self, run_id: str, source_id: str, artifact_name: Optional[str] = None
    ) -> None:
        p = f"{self._run_dir(run_id)}/sources/{_quote(source_id)}.json"
        with self._fs.open(p, "w") as f:
            json.dump({"source_run_id": source_id, "artifact_name": artifact_name}, f)

    def sources(
        self, run_id: str, artifact_name: Optional[str] = None
    ) -> Iterable[TrackerSource]:
        for p in self._fs.ls(f"{self._run_dir(run_id)}/sources"):
            with self._fs.open(p, "r") as f:
                data = json.load(f)
            src = TrackerSource(
                source_run_id=data["source_run_id"],
                artifact_name=data.get("artifact_name"),
            )
            if artifact_name is None or src.artifact_name == artifact_name:
                yield src

    # -- run listing ----------------------------------------------------------

    def run_ids(self, **kwargs: str) -> Iterable[str]:
        for p in self._fs.ls(self._root):
            yield _unquote(os.path.basename(p.rstrip("/")))


def create(config: Optional[str]) -> FsspecTracker:
    """Factory (entry-point / $TPX_TRACKER_<N>_CONFIG target). ``config`` is
    the root path/URL."""
    if not config:
        raise ValueError(
            "fsspec tracker requires a root path config, e.g."
            " [tracker:fsspec] config = /mnt/experiments"
        )
    return FsspecTracker(config)
