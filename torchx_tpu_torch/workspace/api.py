"""Workspace layer: package local code into the job's image.

Reference analog: torchx/workspace/api.py (247 LoC). ``WorkspaceMixin`` is
mixed into scheduler classes; ``build_workspaces`` re-points ``role.image``
at the built artifact (a patched docker image, or a snapshot directory).
Includes the ``.tpxignore``/``.dockerignore`` walker with ``!`` negation.
"""

from __future__ import annotations

import fnmatch
import os
import posixpath
from abc import abstractmethod
from typing import Any, Generic, Iterable, Mapping, TypeVar

from torchx_tpu_torch.specs.api import CfgVal, Role, Workspace, runopts

T = TypeVar("T")  # workspace build artifact type

IGNORE_FILES = (".tpxignore", ".torchxignore", ".dockerignore")


class WorkspaceMixin(Generic[T]):
    """Adds workspace building to a Scheduler.

    ``build_workspaces(roles, cfg)`` builds each distinct (image, workspace)
    pair once (build cache) and mutates ``role.image`` to the result
    (reference api.py:97-154).
    """

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        super().__init__(*args, **kwargs)

    def workspace_opts(self) -> runopts:
        """Extra runopts this workspace type contributes to the
        scheduler's schema (empty by default)."""
        return runopts()

    @abstractmethod
    def build_workspace_and_update_role(
        self, role: Role, workspace: Workspace, cfg: Mapping[str, CfgVal]
    ) -> None:
        """Build the workspace for one role and mutate role.image in place."""
        ...

    def build_workspaces(
        self, roles: list[Role], cfg: Mapping[str, CfgVal],
        max_workers: int = 4,
    ) -> None:
        """Build each role's workspace (once per distinct (image,
        projects) pair — results are cached) and mutate ``role.image`` to
        the built artifact.

        Distinct pairs build CONCURRENTLY on a bounded thread pool (each
        build is mostly subprocess/IO: docker build, snapshot copy), so a
        multi-role app pays the wall-clock of its slowest build rather
        than the sum. Role mutation order stays deterministic: the first
        role carrying each key is the one whose build runs; the rest take
        the cached image afterwards, in role order."""
        # capture keys BEFORE building: builds mutate role.image in place
        role_keys = [
            (role, (role.image, tuple(sorted(role.workspace.projects.items()))))
            for role in roles
            if role.workspace
        ]
        keyed: dict[tuple[str, tuple[tuple[str, str], ...]], Role] = {}
        for role, key in role_keys:
            keyed.setdefault(key, role)
        if not keyed:
            return

        import logging

        log = logging.getLogger(__name__)

        def _build(role: Role) -> str:
            old_image = role.image
            self.build_workspace_and_update_role(role, role.workspace, cfg)
            if role.image != old_image:
                log.info(
                    "built workspace for role %s: %s -> %s",
                    role.name,
                    old_image,
                    role.image,
                )
            return role.image

        cache: dict[tuple[str, tuple[tuple[str, str], ...]], str] = {}
        if len(keyed) == 1:
            ((key, role),) = keyed.items()
            cache[key] = _build(role)
        else:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(
                max_workers=min(max_workers, len(keyed)),
                thread_name_prefix="tpx-ws-build",
            ) as pool:
                futures = {
                    key: pool.submit(_build, role) for key, role in keyed.items()
                }
            for key in futures:
                cache[key] = futures[key].result()  # re-raises build errors
        for role, key in role_keys:
            role.image = cache[key]

    # push contract for docker-ish backends (reference api.py:169-179)
    def dryrun_push_images(self, app: Any, cfg: Mapping[str, CfgVal]) -> Any:
        """Plan remote-image pushes for locally-built images; returns an
        opaque plan for :meth:`push_images` (None = nothing to push)."""
        return None

    def push_images(self, images_to_push: Any) -> None:
        """Execute the push plan from :meth:`dryrun_push_images`."""
        pass


# =========================================================================
# Ignore-file walker
# =========================================================================


def _load_ignore_patterns(root: str) -> list[str]:
    patterns: list[str] = []
    for name in IGNORE_FILES:
        path = os.path.join(root, name)
        if os.path.isfile(path):
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if line and not line.startswith("#"):
                        patterns.append(line)
    return patterns


def _is_ignored(rel_path: str, patterns: list[str]) -> bool:
    """dockerignore-style matching with ``!`` negation; last match wins."""
    ignored = False
    for pat in patterns:
        negate = pat.startswith("!")
        if negate:
            pat = pat[1:]
        pat = pat.rstrip("/")
        # a pattern matches the path itself or any parent directory
        hit = fnmatch.fnmatch(rel_path, pat) or fnmatch.fnmatch(
            rel_path, pat + "/*"
        )
        if not hit:
            parts = rel_path.split("/")
            hit = any(
                fnmatch.fnmatch("/".join(parts[: i + 1]), pat)
                for i in range(len(parts))
            )
        if hit:
            ignored = not negate
    return ignored


def walk_workspace(root: str) -> Iterable[tuple[str, str]]:
    """Yield (abs_path, rel_path) for every non-ignored file under root,
    honoring .tpxignore/.dockerignore (reference api.py:182-247)."""
    root = os.path.abspath(root)
    patterns = _load_ignore_patterns(root)
    for dirpath, dirnames, filenames in os.walk(root):
        rel_dir = os.path.relpath(dirpath, root)
        rel_dir = "" if rel_dir == "." else rel_dir.replace(os.sep, "/")
        # prune ignored directories in place so we never descend
        dirnames[:] = [
            d
            for d in dirnames
            if not _is_ignored(posixpath.join(rel_dir, d) if rel_dir else d, patterns)
        ]
        for fname in filenames:
            rel = posixpath.join(rel_dir, fname) if rel_dir else fname
            if fname in IGNORE_FILES:
                continue
            if _is_ignored(rel, patterns):
                continue
            yield os.path.join(dirpath, fname), rel
