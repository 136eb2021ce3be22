"""Docker workspaces: patch the role image with local code.

Reference analog: torchx/workspace/docker_workspace.py (274 LoC):
tar a build context from the workspace (auto-generating
``Dockerfile.tpx`` = ``FROM $image\\nCOPY . .`` when absent), docker-build a
patched image labeled with the launcher version, re-point ``role.image`` at
the built sha, and push ``sha256:`` images to ``image_repo`` before remote
submission.

The docker SDK import is deferred and injectable so dryrun-level tests run
without a docker daemon.
"""

from __future__ import annotations

import hashlib
import io
import logging
import os
import tarfile
from typing import Any, Mapping, Optional, TYPE_CHECKING

from torchx_tpu_torch.specs.api import AppDef, CfgVal, Role, Workspace, runopts
from torchx_tpu_torch.version import __version__
from torchx_tpu_torch.workspace.api import WorkspaceMixin, walk_workspace

if TYPE_CHECKING:
    from docker import DockerClient

logger = logging.getLogger(__name__)

TPX_DOCKERFILE = "Dockerfile.tpx"
_DEFAULT_DOCKERFILE = b"""ARG IMAGE
FROM $IMAGE

COPY . .
"""

LABEL_VERSION = "sh.tpx.version"
LABEL_CONTENT_HASH = "sh.tpx.content-hash"


class DockerWorkspaceMixin(WorkspaceMixin["dict[str, tuple[str, str]]"]):
    """Builds patched images; tracks sha-images that need pushing."""

    def __init__(
        self,
        *args: Any,
        docker_client: Optional["DockerClient"] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(*args, **kwargs)
        self.__docker_client = docker_client

    @property
    def _docker_client(self) -> "DockerClient":
        if self.__docker_client is None:
            import docker

            self.__docker_client = docker.from_env()
        return self.__docker_client

    def workspace_opts(self) -> runopts:
        """Adds ``image_repo`` (remote repo for patched images)."""
        opts = runopts()
        opts.add(
            "image_repo",
            type_=str,
            default=None,
            help="remote repo to push patched images to (e.g."
            " us-docker.pkg.dev/proj/repo/app); required for remote schedulers"
            " when a workspace is used",
        )
        return opts

    def build_workspace_and_update_role(
        self, role: Role, workspace: Workspace, cfg: Mapping[str, CfgVal]
    ) -> None:
        # skip-if-unchanged: an image labeled with the same content digest
        # already has this exact workspace baked in — re-point and return
        # without a build (reference analog: torchx/workspace/api.py:97-154
        # build caching + docker_workspace.py:92-144 image re-point).
        # The digest keys on the RESOLVED base image id (not just the tag)
        # so a re-pulled/moved tag invalidates the cache.
        context, digest = build_context_with_digest(
            f"{role.image}@{self._resolve_image_id(role.image)}", workspace
        )
        cached = self._find_cached_image(digest)
        if cached is not None:
            logger.info("workspace unchanged (digest %s); reusing %s",
                        digest[:12], cached[:19])
            role.image = cached
            context.close()
            return
        try:
            image, _ = self._docker_client.images.build(
                fileobj=context,
                custom_context=True,
                pull=False,
                rm=True,
                labels={LABEL_VERSION: __version__, LABEL_CONTENT_HASH: digest},
                buildargs={"IMAGE": role.image},
            )
        finally:
            context.close()
        role.image = image.id  # sha256:... until pushed

    def _resolve_image_id(self, image: str) -> str:
        try:
            return str(self._docker_client.images.get(image).id)
        except Exception:  # noqa: BLE001 - unknown local image: tag alone keys the digest
            return ""

    def _find_cached_image(self, digest: str) -> Optional[str]:
        try:
            images = self._docker_client.images.list(
                filters={"label": f"{LABEL_CONTENT_HASH}={digest}"}
            )
        except Exception as e:  # noqa: BLE001 - cache probe must never block a build
            logger.debug("image-cache lookup failed (%s); building", e)
            return None
        return images[0].id if images else None

    # -- push contract (reference docker_workspace.py:146-189) -------------

    def dryrun_push_images(
        self, app: AppDef, cfg: Mapping[str, CfgVal]
    ) -> dict[str, tuple[str, str]]:
        """Rewrite any ``sha256:`` role images to ``{image_repo}:{hash}``
        tags and return {old_image: (repo, tag)} for :meth:`push_images`."""
        images_to_push: dict[str, tuple[str, str]] = {}
        image_repo = cfg.get("image_repo")
        for role in app.roles:
            if role.image.startswith("sha256:"):
                if not image_repo:
                    raise KeyError(
                        f"role {role.name} has a locally-built image"
                        f" ({role.image[:19]}...); configure image_repo to"
                        " push it for remote execution"
                    )
                tag = role.image.removeprefix("sha256:")[:12]
                images_to_push[role.image] = (str(image_repo), tag)
                role.image = f"{image_repo}:{tag}"
        return images_to_push

    def push_images(self, images_to_push: dict[str, tuple[str, str]]) -> None:
        """Tag + push each locally-built image to its planned repo:tag."""
        if not images_to_push:
            return
        client = self._docker_client
        for local_image, (repo, tag) in images_to_push.items():
            img = client.images.get(local_image)
            img.tag(repo, tag=tag)
            logger.info("pushing %s:%s ...", repo, tag)
            for line in client.images.push(repo, tag=tag, stream=True, decode=True):
                if "error" in line:
                    raise RuntimeError(f"failed to push {repo}:{tag}: {line['error']}")


def build_context_with_digest(
    image: str, workspace: Workspace
) -> tuple[io.BytesIO, str]:
    """One walk over the workspace tree -> (tar build context, content digest).

    The digest covers everything the build recipe depends on — base image
    key, generated Dockerfile, builder version, and each entry's path,
    permission bits, and bytes (symlinks hash their target; non-regular
    files like FIFOs hash a type tag and are never opened) — so any edit
    forces a rebuild while an untouched tree reuses the cached image. Each
    file is read ONCE, feeding the hash and the tar together.

    A user-provided ``Dockerfile.tpx`` in the workspace root wins over the
    generated ``COPY . .`` one (reference docker_workspace.py:30-37).
    """
    h = hashlib.sha256()
    h.update(image.encode())
    h.update(_DEFAULT_DOCKERFILE)
    h.update(__version__.encode())
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as tar:
        has_custom_dockerfile = False
        for src_dir, dst_sub in sorted(workspace.projects.items()):
            entries = sorted(walk_workspace(src_dir), key=lambda e: e[1])
            for abs_path, rel_path in entries:
                arcname = os.path.join(dst_sub, rel_path) if dst_sub else rel_path
                if arcname == TPX_DOCKERFILE:
                    has_custom_dockerfile = True
                    arcname = "Dockerfile"
                info = tar.gettarinfo(abs_path, arcname=arcname)
                h.update(f"\x00{arcname}\x00{info.mode & 0o777:o}\x00".encode())
                if info.issym():
                    h.update(b"link:" + info.linkname.encode())
                    tar.addfile(info)
                elif info.isreg():
                    with open(abs_path, "rb") as f:
                        data = f.read()
                    h.update(data)
                    tar.addfile(info, io.BytesIO(data))
                else:  # FIFO/device/etc: archive the entry, never open it
                    h.update(b"special:" + str(info.type).encode())
                    tar.addfile(info)
        if not has_custom_dockerfile:
            info = tarfile.TarInfo("Dockerfile")
            info.size = len(_DEFAULT_DOCKERFILE)
            tar.addfile(info, io.BytesIO(_DEFAULT_DOCKERFILE))
    buf.seek(0)
    return buf, h.hexdigest()


def workspace_digest(image: str, workspace: Workspace) -> str:
    """Deterministic content hash of (base image key, workspace tree)."""
    context, digest = build_context_with_digest(image, workspace)
    context.close()
    return digest


def build_context(image: str, workspace: Workspace) -> io.BytesIO:
    """In-memory tar build context: workspace files + Dockerfile."""
    return build_context_with_digest(image, workspace)[0]
