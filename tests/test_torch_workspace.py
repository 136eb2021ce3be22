"""The port's overlays and workspace layers (``torchx_tpu_torch.specs.overlays``,
``torchx_tpu_torch.workspace``): the overlay and workspace cases of
``tests/test_overlays_workspace.py`` run against the copy, and overlays,
the ignore-file walk and the docker build context held to the JAX
package's on the same inputs; its ``StructuredOpts`` cases run against
``torchx_tpu_torch.schedulers.structured_opts``."""

import copy
import os
import shutil
import tarfile
from dataclasses import dataclass, field
from typing import Optional
from unittest import mock

import pytest

from torchx_tpu.specs import Workspace as JWorkspace
from torchx_tpu.specs import overlays as joverlays
from torchx_tpu.workspace import api as jws_api
from torchx_tpu.workspace import dir_workspace as jdir
from torchx_tpu.workspace import docker_workspace as jdocker
from torchx_tpu_torch.schedulers.structured_opts import StructuredOpts
from torchx_tpu_torch.specs.api import Resource, Role, Workspace
from torchx_tpu_torch.specs.overlays import (
    DEL,
    JOIN,
    PUT,
    apply_overlay,
    get_overlay,
    set_overlay,
    validate_overlay,
)
from torchx_tpu_torch.workspace import WorkspaceMixin, walk_workspace
from torchx_tpu_torch.workspace.dir_workspace import (
    DirWorkspaceMixin,
    TmpDirWorkspaceMixin,
    copy_workspace,
)
from torchx_tpu_torch.workspace.docker_workspace import (
    LABEL_CONTENT_HASH,
    LABEL_VERSION,
    DockerWorkspaceMixin,
    build_context,
    build_context_with_digest,
    workspace_digest,
)
from torch_threads import xdist_torch_threads  # noqa: F401


class TestOverlays:
    def test_strategic_merge(self):
        target = {"a": {"b": 1, "c": 2}, "keep": True}
        out = apply_overlay(target, {"a": {"b": 9}})
        assert out == {"a": {"b": 9, "c": 2}, "keep": True}
        assert target["a"]["b"] == 1  # original untouched

    def test_put_replaces(self):
        out = apply_overlay({"a": {"b": 1}}, {PUT("a"): {"x": 1}})
        assert out["a"] == {"x": 1}

    def test_del(self):
        out = apply_overlay({"a": 1, "b": 2}, {DEL("a"): None})
        assert out == {"b": 2}

    def test_join_by_name(self):
        target = {"containers": [{"name": "main", "image": "a"}, {"name": "side"}]}
        out = apply_overlay(
            target,
            {
                JOIN("containers"): [
                    {"name": "main", "image": "b"},
                    {"name": "new"},
                ]
            },
        )
        names = [c["name"] for c in out["containers"]]
        assert names == ["main", "side", "new"]
        assert out["containers"][0]["image"] == "b"

    def test_join_custom_key(self):
        target = {"env": [{"key": "A", "v": 1}]}
        out = apply_overlay(target, {JOIN("env", "key"): [{"key": "A", "v": 2}]})
        assert out["env"] == [{"key": "A", "v": 2}]

    def test_validate(self):
        assert validate_overlay({"a": 1}) == []
        assert validate_overlay({DEL("a"): "not-empty"})
        assert validate_overlay("nope")
        assert validate_overlay({PUT(""): 1})

    def test_role_attachment(self):
        role = Role(name="r", image="i")
        set_overlay(role, "gke", {"a": 1})
        assert get_overlay(role, "gke") == {"a": 1}
        assert get_overlay(role, "slurm") is None
        with pytest.raises(ValueError):
            set_overlay(role, "gke", {DEL("x"): "bad"})


def _tree(tmp_path):
    (tmp_path / "src").mkdir(parents=True)
    (tmp_path / "src" / "main.py").write_text("print()")
    (tmp_path / "data").mkdir()
    (tmp_path / "data" / "big.bin").write_text("x" * 10)
    (tmp_path / "keep.bin").write_text("k")
    (tmp_path / ".git").mkdir()
    (tmp_path / ".git" / "obj").write_text("g")
    (tmp_path / ".tpxignore").write_text("*.bin\n!keep.bin\n.git\ndata\n")
    return tmp_path


@dataclass
class _Nested(StructuredOpts):
    context: str = "default-ctx"
    """kube context to use."""


@dataclass
class _MyOpts(StructuredOpts):
    namespace: str = "default"
    """namespace to submit into."""
    replicas: int = 1
    """number of replicas."""
    queue: Optional[str] = None
    """queue name."""
    k8s: _Nested = field(default_factory=_Nested)


class TestStructuredOpts:
    def test_to_runopts_docs_and_defaults(self):
        opts = _MyOpts.to_runopts()
        d = dict(opts)
        assert d["namespace"].default == "default"
        assert d["namespace"].help == "namespace to submit into."
        assert d["replicas"].opt_type is int
        assert "k8s.context" in d  # nested group flattened

    def test_from_cfg(self):
        cfg = _MyOpts.to_runopts().resolve(
            {"namespace": "ml", "replicas": "3", "k8s.context": "prod"}
        )
        typed = _MyOpts.from_cfg(cfg)
        assert typed.namespace == "ml"
        assert typed.replicas == 3
        assert typed.k8s.context == "prod"
        assert typed["namespace"] == "ml"  # mapping protocol
        assert typed.get("nope", "dflt") == "dflt"


class TestWorkspaceWalk:
    def test_ignore_with_negation(self, tmp_path):
        root = _tree(tmp_path)
        rels = {rel for _, rel in walk_workspace(str(root))}
        assert rels == {"src/main.py", "keep.bin"}

    def test_copy_workspace(self, tmp_path):
        root = _tree(tmp_path)
        dst = tmp_path / "out"
        n = copy_workspace(Workspace(projects={str(root): "app"}), str(dst))
        assert n == 2
        assert (dst / "app" / "src" / "main.py").exists()

    def test_dir_mixin_points_image(self, tmp_path):
        root = _tree(tmp_path)

        class S(DirWorkspaceMixin):
            pass

        role = Role(name="r", image="orig")
        S().build_workspace_and_update_role(
            role, Workspace(projects={str(root): ""}), {"job_dir": str(tmp_path / "jd")}
        )
        assert role.image == str(tmp_path / "jd" / "workspace")

    def test_build_context_generates_dockerfile(self, tmp_path):
        root = _tree(tmp_path)
        buf = build_context("base:1", Workspace(projects={str(root): ""}))
        with tarfile.open(fileobj=buf) as tar:
            names = tar.getnames()
            assert "Dockerfile" in names
            assert "src/main.py" in names
            df = tar.extractfile("Dockerfile").read().decode()
            assert "COPY . ." in df

    def test_build_context_custom_dockerfile(self, tmp_path):
        root = _tree(tmp_path)
        (root / "Dockerfile.tpx").write_text("FROM custom\n")
        buf = build_context("base:1", Workspace(projects={str(root): ""}))
        with tarfile.open(fileobj=buf) as tar:
            df = tar.extractfile("Dockerfile").read().decode()
            assert df == "FROM custom\n"


class TestDockerBuildCache:
    """Skip-if-unchanged: the second build of an identical workspace reuses
    the labeled image with no docker build call."""

    def make_tree(self, tmp_path):
        (tmp_path / "src").mkdir()
        (tmp_path / "src" / "main.py").write_text("print('v1')")
        return tmp_path

    def make_mixin(self):
        client = mock.MagicMock()
        built = mock.MagicMock()
        built.id = "sha256:" + "a" * 64
        client.images.build.return_value = (built, iter(()))
        # image store: return cached images only for digests seen by build
        store: dict[str, object] = {}

        def record_build(**kwargs):
            digest = kwargs["labels"][LABEL_CONTENT_HASH]
            store[digest] = built
            return (built, iter(()))

        def list_images(filters):
            label = filters["label"]
            digest = label.split("=", 1)[1]
            return [store[digest]] if digest in store else []

        client.images.build.side_effect = record_build
        client.images.list.side_effect = list_images

        class WS(DockerWorkspaceMixin):
            pass

        return WS(docker_client=client), client

    def test_digest_stable_and_content_sensitive(self, tmp_path):
        root = self.make_tree(tmp_path)
        ws = Workspace(projects={str(root): ""})
        d1 = workspace_digest("base:1", ws)
        assert d1 == workspace_digest("base:1", ws)  # deterministic
        assert d1 != workspace_digest("base:2", ws)  # base image matters
        (root / "src" / "main.py").write_text("print('v2')")
        assert d1 != workspace_digest("base:1", ws)  # content matters

    def test_second_build_skipped_when_unchanged(self, tmp_path):
        root = self.make_tree(tmp_path)
        ws = Workspace(projects={str(root): ""})
        mixin, client = self.make_mixin()

        def fresh_role():
            return Role(
                name="r", image="base:1", entrypoint="python",
                resource=Resource(cpu=1, memMB=1024),
            )

        r1 = fresh_role()
        mixin.build_workspace_and_update_role(r1, ws, {})
        assert client.images.build.call_count == 1
        assert r1.image.startswith("sha256:")
        assert client.images.build.call_args.kwargs["labels"][LABEL_VERSION] == "0.1.0"

        r2 = fresh_role()
        mixin.build_workspace_and_update_role(r2, ws, {})
        assert client.images.build.call_count == 1  # no second build
        assert r2.image == r1.image

        # an edit invalidates the cache and rebuilds
        (root / "src" / "main.py").write_text("print('v2')")
        r3 = fresh_role()
        mixin.build_workspace_and_update_role(r3, ws, {})
        assert client.images.build.call_count == 2

    def test_digest_tolerates_symlinks_and_fifos(self, tmp_path):
        """Dangling symlinks and FIFOs neither crash nor hang the digest
        (they are archived as entries, never opened)."""
        root = self.make_tree(tmp_path)
        os.symlink("/nonexistent/target", root / "dangling")
        os.mkfifo(root / "pipe")
        ws = Workspace(projects={str(root): ""})
        d1 = workspace_digest("base:1", ws)
        # the symlink target participates in the digest
        os.remove(root / "dangling")
        os.symlink("/other/target", root / "dangling")
        assert workspace_digest("base:1", ws) != d1

    def test_cache_probe_failure_falls_back_to_build(self, tmp_path):
        root = self.make_tree(tmp_path)
        ws = Workspace(projects={str(root): ""})
        mixin, client = self.make_mixin()
        client.images.list.side_effect = RuntimeError("daemon unreachable")
        role = Role(
            name="r", image="base:1", entrypoint="python",
            resource=Resource(cpu=1, memMB=1024),
        )
        mixin.build_workspace_and_update_role(role, ws, {})
        assert client.images.build.call_count == 1

    def test_push_plan_and_push(self):
        from torchx_tpu_torch.specs.api import AppDef

        mixin, client = self.make_mixin()
        app = AppDef(name="a", roles=[Role(name="r", image="sha256:" + "b" * 64),
                                      Role(name="s", image="repo/img:1")])
        with pytest.raises(KeyError, match="image_repo"):
            mixin.dryrun_push_images(copy.deepcopy(app), {})
        plan = mixin.dryrun_push_images(app, {"image_repo": "us-docker.pkg.dev/p/r"})
        assert plan == {"sha256:" + "b" * 64: ("us-docker.pkg.dev/p/r", "b" * 12)}
        assert [r.image for r in app.roles] == ["us-docker.pkg.dev/p/r:" + "b" * 12,
                                                "repo/img:1"]
        client.images.push.return_value = iter([{"status": "ok"}])
        mixin.push_images(plan)
        client.images.push.assert_called_once()
        client.images.push.return_value = iter([{"error": "denied"}])
        with pytest.raises(RuntimeError, match="denied"):
            mixin.push_images(plan)


class TestBuildWorkspaces:
    def test_each_distinct_workspace_builds_once(self, tmp_path):
        builds = []

        class S(WorkspaceMixin):
            def build_workspace_and_update_role(self, role, workspace, cfg):
                builds.append((role.image, tuple(workspace.projects)))
                role.image = f"built-{role.image}-{len(builds)}"

        ws_a, ws_b = Workspace(projects={"a": ""}), Workspace(projects={"b": ""})
        roles = [Role(name="r0", image="img", workspace=ws_a),
                 Role(name="r1", image="img", workspace=ws_a),
                 Role(name="r2", image="img", workspace=ws_b),
                 Role(name="r3", image="plain")]
        S().build_workspaces(roles, {})
        assert sorted(builds) == [("img", ("a",)), ("img", ("b",))]
        assert roles[0].image == roles[1].image != roles[2].image
        assert roles[3].image == "plain"
        assert S().workspace_opts().resolve({}) == {}

    def test_tmp_dir_mixin_and_job_dir_option(self, tmp_path):
        root = _tree(tmp_path)
        role = Role(name="r", image="orig")
        TmpDirWorkspaceMixin().build_workspace_and_update_role(
            role, Workspace(projects={str(root): ""}), {})
        try:
            assert os.path.isfile(os.path.join(role.image, "src", "main.py"))
        finally:
            shutil.rmtree(role.image)
        role = Role(name="r", image="orig")
        DirWorkspaceMixin().build_workspace_and_update_role(
            role, Workspace(projects={str(root): ""}), {"job_dir": None})
        assert role.image == "orig"  # no job dir: run from the original image
        assert DirWorkspaceMixin().workspace_opts().resolve({}) == {"job_dir": None}


# -- parity with the JAX package's layers -------------------------------------

OVERLAYS = [
    ({"a": {"b": 1, "c": 2}, "keep": True}, {"a": {"b": 9}}),
    ({"a": {"b": 1}}, {PUT("a"): {"x": 1}}),
    ({"a": 1, "b": 2}, {DEL("a"): None, DEL("zz"): None}),
    ({"containers": [{"name": "main", "image": "a"}, {"name": "side"}, "bare"]},
     {JOIN("containers"): [{"name": "main", "image": "b", "env": {"K": "1"}}, {"name": "new"},
                           "x"]}),
    ({"env": [{"key": "A", "v": 1}]}, {JOIN("env", "key"): [{"key": "A", "v": 2}]}),
    ({"spec": 3}, {"spec": {"template": {"a": 1}}}),
    ({"spec": {"template": {"metadata": {"labels": {"a": "1"}}}}},
     {"spec": {"template": {"metadata": {"labels": {"b": "2"}}, PUT("x"): [1]}}}),
    ({"list": 1}, {JOIN("list"): [{"name": "n"}]}),
    ({"a": []}, {JOIN("a"): {"not": "a list"}}),
]


@pytest.mark.parametrize("target, overlay", OVERLAYS)
def test_apply_overlay_equals_the_jax_packages(target, overlay):
    def run(fn):
        try:
            return fn(copy.deepcopy(target), overlay)
        except ValueError as e:
            return ("raised", str(e))

    assert run(apply_overlay) == run(joverlays.apply_overlay)
    assert validate_overlay(overlay) == joverlays.validate_overlay(overlay)
    assert (PUT("k"), JOIN("k", "id"), DEL("k")) == (joverlays.PUT("k"),
                                                     joverlays.JOIN("k", "id"),
                                                     joverlays.DEL("k"))


@pytest.mark.parametrize("bad", ["nope", {1: 2}, {DEL("a"): "x"}, {PUT(""): 1},
                                 {"a": {DEL("b"): {"c": 1}}}])
def test_validate_overlay_equals_the_jax_packages(bad):
    assert validate_overlay(bad) == joverlays.validate_overlay(bad)


IGNORES = [
    "*.bin\n!keep.bin\n.git\ndata\n",
    "",
    "# comment\nsrc/\n",
    "**/*.py\n!src/main.py\n",
    "data/*\n!data/big.bin\n",
]


@pytest.mark.parametrize("ignore", IGNORES)
def test_walk_workspace_equals_the_jax_packages(tmp_path, ignore):
    root = _tree(tmp_path / "ws")
    (root / "src" / "pkg").mkdir()
    (root / "src" / "pkg" / "mod.py").write_text("x = 1")
    (root / ".dockerignore").write_text("*.log\n")
    (root / "run.log").write_text("log")
    (root / ".tpxignore").write_text(ignore)
    assert sorted(walk_workspace(str(root))) == sorted(jws_api.walk_workspace(str(root)))
    ours, theirs = tmp_path / "o", tmp_path / "t"
    assert (copy_workspace(Workspace(projects={str(root): "app"}), str(ours))
            == jdir.copy_workspace(JWorkspace(projects={str(root): "app"}), str(theirs)))
    assert sorted(p.relative_to(ours) for p in ours.rglob("*")) \
        == sorted(p.relative_to(theirs) for p in theirs.rglob("*"))


@pytest.mark.parametrize("custom_dockerfile", [False, True])
def test_build_context_equals_the_jax_packages(tmp_path, custom_dockerfile):
    """The same tar members, bytes and content digest from either package,
    so a workspace image built by one launcher is found by the other."""
    root = _tree(tmp_path / "a")
    other = tmp_path / "b"
    (other / "conf").mkdir(parents=True)
    (other / "conf" / "c.yaml").write_text("k: v")
    os.symlink("src/main.py", root / "link")
    if custom_dockerfile:
        (root / "Dockerfile.tpx").write_text("FROM custom\n")
    projects = {str(root): "", str(other): "cfg"}
    buf, digest = build_context_with_digest("base:1@sha256:x", Workspace(projects=projects))
    jbuf, jdigest = jdocker.build_context_with_digest("base:1@sha256:x",
                                                      JWorkspace(projects=projects))
    assert digest == jdigest
    assert buf.getvalue() == jbuf.getvalue()
    with tarfile.open(fileobj=buf) as tar:
        names = tar.getnames()
    assert "Dockerfile" in names and "cfg/conf/c.yaml" in names and "link" in names
    assert workspace_digest("base:2", Workspace(projects=projects)) \
        == jdocker.workspace_digest("base:2", JWorkspace(projects=projects))
    assert (LABEL_VERSION, LABEL_CONTENT_HASH) == (jdocker.LABEL_VERSION,
                                                   jdocker.LABEL_CONTENT_HASH)
