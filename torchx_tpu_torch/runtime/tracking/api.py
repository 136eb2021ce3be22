"""In-job result tracking (the older, simpler sibling of the tracker
subsystem).

Port of :mod:`torchx_tpu.runtime.tracking.api`.
Reference analog: torchx/runtime/tracking/api.py:20-126 — a minimal
put/get store for per-trial results keyed ``(run_id, key)``, used by hpo
loops that just need "write the objective value where the client can read
it". For anything richer use ``torchx_tpu_torch.tracker.AppRun``.

Usage (in the app)::

    tracker = FsspecResultTracker("/mnt/results")
    tracker[trial_id] = {"loss": 0.12, "mfu": 0.46}

and (in the client)::

    print(FsspecResultTracker("/mnt/results")[trial_id])
"""

from __future__ import annotations

import abc
import json
import os
from typing import Any, Mapping, Optional


class ResultTracker(abc.ABC):
    @abc.abstractmethod
    def put(self, key: str, value: Mapping[str, Any]) -> None:
        ...

    @abc.abstractmethod
    def get(self, key: str) -> Optional[Mapping[str, Any]]:
        ...

    def __setitem__(self, key: Any, value: Mapping[str, Any]) -> None:
        self.put(str(key), value)

    def __getitem__(self, key: Any) -> Mapping[str, Any]:
        result = self.get(str(key))
        if result is None:
            raise KeyError(key)
        return result


class FsspecResultTracker(ResultTracker):
    """One JSON file per key under a root dir/URL."""

    def __init__(self, root: str) -> None:
        self._root = str(root).rstrip("/")

    def _path(self, key: str) -> str:
        import urllib.parse

        return f"{self._root}/{urllib.parse.quote(key, safe='')}.json"

    def _open(self, path: str, mode: str):  # noqa: ANN202
        if "://" in self._root:
            import fsspec

            return fsspec.open(path, mode).open()
        if "w" in mode:
            os.makedirs(os.path.dirname(path), exist_ok=True)
        return open(path, mode)

    def put(self, key: str, value: Mapping[str, Any]) -> None:
        with self._open(self._path(key), "w") as f:
            json.dump(dict(value), f, default=str)

    def get(self, key: str) -> Optional[Mapping[str, Any]]:
        try:
            with self._open(self._path(key), "r") as f:
                return json.load(f)
        except (OSError, FileNotFoundError):
            return None
