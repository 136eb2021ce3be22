"""Directory workspaces: snapshot local code into a job dir.

Reference analog: torchx/workspace/dir_workspace.py (66 LoC). Used by the
Slurm / bare-VM path where the "image" is a shared-filesystem directory.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Mapping

from torchx_tpu_torch.specs.api import CfgVal, Role, Workspace, runopts
from torchx_tpu_torch.workspace.api import WorkspaceMixin, walk_workspace


def copy_workspace(workspace: Workspace, dst_root: str) -> int:
    """Copy every non-ignored file of every project into dst_root;
    returns the file count."""
    count = 0
    for src_dir, dst_sub in workspace.projects.items():
        dst_dir = os.path.join(dst_root, dst_sub) if dst_sub else dst_root
        for abs_path, rel_path in walk_workspace(src_dir):
            dst = os.path.join(dst_dir, rel_path)
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            shutil.copy2(abs_path, dst)
            count += 1
    return count


class DirWorkspaceMixin(WorkspaceMixin[None]):
    """Copies the workspace into ``{job_dir}/workspace`` and points
    role.image there."""

    def workspace_opts(self) -> runopts:
        """Adds ``job_dir`` (shared directory the workspace copies into)."""
        opts = runopts()
        opts.add(
            "job_dir",
            type_=str,
            default=None,
            help="shared-filesystem directory to snapshot the workspace into"
            " (e.g. an NFS/Lustre path visible on all hosts)",
        )
        return opts

    def build_workspace_and_update_role(
        self, role: Role, workspace: Workspace, cfg: Mapping[str, CfgVal]
    ) -> None:
        job_dir = cfg.get("job_dir")
        if job_dir is None:
            return  # no job dir configured: run from the original image/dir
        dst = os.path.join(str(job_dir), "workspace")
        os.makedirs(dst, exist_ok=True)
        copy_workspace(workspace, dst)
        role.image = dst


class TmpDirWorkspaceMixin(DirWorkspaceMixin):
    """Like DirWorkspaceMixin but snapshots into a fresh temp dir — the
    local-scheduler workspace mode."""

    def build_workspace_and_update_role(
        self, role: Role, workspace: Workspace, cfg: Mapping[str, CfgVal]
    ) -> None:
        dst = tempfile.mkdtemp(prefix="tpx_workspace_")
        copy_workspace(workspace, dst)
        role.image = dst
