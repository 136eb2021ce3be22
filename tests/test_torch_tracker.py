"""The port's trackers (``torchx_tpu_torch.tracker``: the API, the fsspec
and MLflow backends, ``AppRun``) and its result tracker
(``torchx_tpu_torch.runtime.tracking``), held to the JAX layer's cases run
against the copy: ``tests/test_tracker_plugins.py`` less the registry
cases that ``tests/test_torch_plugins.py`` runs (of its two tracker cases,
the ``trackers_from_environ`` halves are here), and every case of
``tests/test_mlflow_tracker.py``, against the same in-memory fake MLflow
client (mlflow is not installed; as in the JAX file, a stub module stands
in for it); and parity with the JAX trackers on the same inputs
(``TestJaxParity``: the fsspec store byte for byte, ``AppRun`` from one
environment, the MLflow client's state)."""

from __future__ import annotations

import re
import sys
import types
from dataclasses import dataclass, field
from typing import Optional

import pytest

from torchx_tpu_torch.plugins import get_registry, register
from torchx_tpu_torch.plugins._registration import clear_registrations
from torchx_tpu_torch.runtime.tracking import FsspecResultTracker
from torchx_tpu_torch.tracker.api import (
    AppRun,
    tracker_config_env_vars,
    trackers_from_environ,
)
from torchx_tpu_torch.tracker.backend.fsspec import FsspecTracker
from torch_threads import xdist_torch_threads  # noqa: F401


class TestFsspecTracker:
    def test_metadata_roundtrip(self, tmp_path):
        t = FsspecTracker(str(tmp_path))
        t.add_metadata("run1", lr=0.1, model="llama")
        t.add_metadata("run1", step=5)
        md = t.metadata("run1")
        assert md == {"lr": 0.1, "model": "llama", "step": 5}

    def test_artifacts_roundtrip(self, tmp_path):
        t = FsspecTracker(str(tmp_path))
        t.add_artifact("run1", "ckpt", "/mnt/ckpt/100", {"step": 100})
        arts = t.artifacts("run1")
        assert arts["ckpt"].path == "/mnt/ckpt/100"
        assert arts["ckpt"].metadata == {"step": 100}

    def test_lineage(self, tmp_path):
        t = FsspecTracker(str(tmp_path))
        t.add_source("child", "parent-run", artifact_name="ckpt")
        (src,) = list(t.sources("child"))
        assert src.source_run_id == "parent-run"
        assert src.artifact_name == "ckpt"
        assert list(t.sources("child", artifact_name="other")) == []

    def test_run_ids_with_handle_chars(self, tmp_path):
        t = FsspecTracker(str(tmp_path))
        run_id = "local://session/app_123"
        t.add_metadata(run_id, a=1)
        assert list(t.run_ids()) == [run_id]

    def test_empty(self, tmp_path):
        t = FsspecTracker(str(tmp_path))
        assert t.metadata("nope") == {}
        assert t.artifacts("nope") == {}


class TestAppRunFromEnv:
    def test_env_roundtrip(self, tmp_path, monkeypatch):
        monkeypatch.setenv("TPX_JOB_ID", "local://s/app1")
        monkeypatch.setenv("TPX_TRACKERS", "fsspec")
        monkeypatch.setenv("TPX_TRACKER_FSSPEC_CONFIG", str(tmp_path))
        AppRun._instance = None
        run = AppRun.run_from_env()
        assert run.id == "local://s/app1"
        run.add_metadata(objective=0.5)
        t = FsspecTracker(str(tmp_path))
        assert t.metadata("local://s/app1")["objective"] == 0.5
        AppRun._instance = None

    def test_no_env_is_noop(self, monkeypatch):
        monkeypatch.delenv("TPX_JOB_ID", raising=False)
        monkeypatch.delenv("TPX_TRACKERS", raising=False)
        AppRun._instance = None
        run = AppRun.run_from_env()
        assert run.id == "<unknown_run_id>"
        run.add_metadata(x=1)  # no backends: must not raise
        AppRun._instance = None

    def test_parent_lineage_autolink(self, tmp_path, monkeypatch):
        monkeypatch.setenv("TPX_JOB_ID", "local://s/child")
        monkeypatch.setenv("TPX_TRACKERS", "fsspec")
        monkeypatch.setenv("TPX_TRACKER_FSSPEC_CONFIG", str(tmp_path))
        monkeypatch.setenv("TPX_PARENT_RUN_ID", "local://s/parent")
        AppRun._instance = None
        AppRun.run_from_env()
        srcs = list(FsspecTracker(str(tmp_path)).sources("local://s/child"))
        assert srcs[0].source_run_id == "local://s/parent"
        AppRun._instance = None

    def test_client_env_injection(self):
        env = tracker_config_env_vars(
            parent_run_id="p1", trackers={"fsspec": "/mnt/exp"}
        )
        assert env["TPX_TRACKERS"] == "fsspec"
        assert env["TPX_TRACKER_FSSPEC_CONFIG"] == "/mnt/exp"
        assert env["TPX_PARENT_RUN_ID"] == "p1"

    def test_client_env_injection_empty(self):
        assert tracker_config_env_vars(trackers={}) == {}


class TestResultTracker:
    def test_roundtrip(self, tmp_path):
        t = FsspecResultTracker(str(tmp_path))
        t["trial/1"] = {"loss": 0.5}
        assert t["trial/1"] == {"loss": 0.5}

    def test_missing_key(self, tmp_path):
        with pytest.raises(KeyError):
            FsspecResultTracker(str(tmp_path))["nope"]


class TestPlugins:
    """The tracker halves of the JAX class's two tracker cases; their
    registry halves run in ``tests/test_torch_plugins.py``."""

    def teardown_method(self):
        clear_registrations()
        get_registry(invalidate_cache=True)

    def test_plugin_tracker_with_colon_name(self, tmp_path, monkeypatch):
        from torchx_tpu_torch.tracker.backend.fsspec import FsspecTracker as FT

        @register.tracker("myorg:prod")
        def create(config):  # noqa: ANN001
            return FT(str(tmp_path))

        get_registry(invalidate_cache=True)
        monkeypatch.setenv("TPX_TRACKERS", "myorg:prod")
        assert "myorg:prod" in trackers_from_environ()

    def test_register_tracker_reachable_from_env(self, tmp_path, monkeypatch):
        from torchx_tpu_torch.tracker.backend.fsspec import FsspecTracker as FT

        @register.tracker("custom_t")
        def create(config):  # noqa: ANN001
            return FT(str(tmp_path))

        get_registry(invalidate_cache=True)
        monkeypatch.setenv("TPX_TRACKERS", "custom_t")
        trackers = trackers_from_environ()
        assert "custom_t" in trackers


# -- tests/test_mlflow_tracker.py ----------------------------------------------


@dataclass
class _Info:
    run_id: str
    artifact_uri: str


@dataclass
class _Data:
    tags: dict = field(default_factory=dict)
    params: dict = field(default_factory=dict)
    metrics: dict = field(default_factory=dict)


@dataclass
class _Run:
    info: _Info
    data: _Data = field(default_factory=_Data)


@dataclass
class _FileInfo:
    path: str
    is_dir: bool


class _PagedList(list):
    """Mimics mlflow's PagedList: a list with a ``token`` attribute."""

    token: Optional[str] = None


class FakeMlflowClient:
    def __init__(self, tracking_uri: Optional[str] = None) -> None:
        self.tracking_uri = tracking_uri
        self.experiments: dict[str, str] = {}
        self.runs: dict[str, _Run] = {}
        self.artifact_store: dict[str, list[str]] = {}  # run -> file paths
        self._n = 0

    def get_experiment_by_name(self, name):
        if name in self.experiments:
            return types.SimpleNamespace(experiment_id=self.experiments[name])
        return None

    def create_experiment(self, name):
        self.experiments[name] = f"exp-{len(self.experiments)}"
        return self.experiments[name]

    def create_run(self, experiment_id, tags=None, run_name=None):
        self._n += 1
        rid = f"mlrun-{self._n}"
        run = _Run(
            info=_Info(run_id=rid, artifact_uri=f"mlflow-artifacts:/{rid}"),
            data=_Data(tags=dict(tags or {})),
        )
        self.runs[rid] = run
        self.artifact_store[rid] = []
        return run

    def get_run(self, run_id):
        return self.runs[run_id]

    # paginate with tiny pages so _all_runs' page_token loop is exercised
    PAGE_SIZE = 2

    def search_runs(
        self,
        experiment_ids,
        filter_string: Optional[str] = None,
        page_token: Optional[str] = None,
    ):
        out = list(self.runs.values())
        if filter_string:
            m = re.search(r"= '([^']*)'", filter_string)
            want = m.group(1) if m else ""
            out = [r for r in out if r.data.tags.get("tpx.run_id") == want]

        start = int(page_token) if page_token else 0
        page = _PagedList(out[start : start + self.PAGE_SIZE])
        page.token = (
            str(start + self.PAGE_SIZE)
            if start + self.PAGE_SIZE < len(out)
            else None
        )
        return page

    def set_tag(self, run_id, key, value):
        self.runs[run_id].data.tags[key] = value

    def log_param(self, run_id, key, value):
        self.runs[run_id].data.params[key] = str(value)

    def log_metric(self, run_id, key, value):
        self.runs[run_id].data.metrics[key] = value

    def log_artifact(self, run_id, local_path, artifact_path=None):
        import os

        name = os.path.basename(local_path)
        dest = f"{artifact_path}/{name}" if artifact_path else name
        self.artifact_store[run_id].append(dest)

    def log_artifacts(self, run_id, local_dir, artifact_path=None):
        import os

        for root, _dirs, files in os.walk(local_dir):
            for f in files:
                rel = os.path.relpath(os.path.join(root, f), local_dir)
                dest = f"{artifact_path}/{rel}" if artifact_path else rel
                self.artifact_store[run_id].append(dest)

    def list_artifacts(self, run_id, path=None):
        # one flat level per call, emulating the real API
        seen: dict[str, _FileInfo] = {}
        prefix = f"{path}/" if path else ""
        for p in self.artifact_store[run_id]:
            if not p.startswith(prefix):
                continue
            rest = p[len(prefix) :]
            head = rest.split("/", 1)[0]
            full = prefix + head
            seen[full] = _FileInfo(path=full, is_dir="/" in rest)
        return list(seen.values())


@pytest.fixture
def tracker(monkeypatch):
    """MLflowTracker wired to the fake client via a stub mlflow module."""
    fake_clients = []

    def client_factory(tracking_uri=None):
        c = FakeMlflowClient(tracking_uri)
        fake_clients.append(c)
        return c

    mlflow_mod = types.ModuleType("mlflow")
    tracking_mod = types.ModuleType("mlflow.tracking")
    tracking_mod.MlflowClient = client_factory
    mlflow_mod.tracking = tracking_mod
    monkeypatch.setitem(sys.modules, "mlflow", mlflow_mod)
    monkeypatch.setitem(sys.modules, "mlflow.tracking", tracking_mod)

    from torchx_tpu_torch.tracker.mlflow import MLflowTracker

    t = MLflowTracker(tracking_uri="fake://x", experiment_name="tpx-test")
    t._fake = fake_clients[0]
    return t


class TestMLflowTracker:
    def test_run_mapping_is_stable(self, tracker):
        a = tracker._mlflow_run("app-1")
        b = tracker._mlflow_run("app-1")
        assert a == b
        run = tracker._fake.runs[a]
        assert run.data.tags["tpx.run_id"] == "app-1"

    def test_metadata_params_vs_metrics(self, tracker):
        tracker.add_metadata("app-1", lr=3e-4, steps=100, name="llama", flag=True)
        md = tracker.metadata("app-1")
        assert md["name"] == "llama" and md["flag"] == "True"  # params
        assert md["lr"] == 3e-4 and md["steps"] == 100.0  # metrics

    def test_local_file_artifact_logged_to_store(self, tracker, tmp_path):
        f = tmp_path / "model.ckpt"
        f.write_text("weights")
        tracker.add_artifact("app-1", "ckpt", str(f), metadata={"step": 42})
        arts = tracker.artifacts("app-1")
        assert set(arts) == {"ckpt"}
        # resolved to the artifact-store URI, not the local path
        assert arts["ckpt"].path.startswith("mlflow-artifacts:/")
        assert arts["ckpt"].metadata == {"step": 42}
        mlrun = tracker._mlflow_run("app-1")
        assert "ckpt/model.ckpt" in tracker._fake.artifact_store[mlrun]

    def test_dir_artifact_logged_recursively(self, tracker, tmp_path):
        d = tmp_path / "ckpt_dir"
        (d / "sub").mkdir(parents=True)
        (d / "a.txt").write_text("1")
        (d / "sub" / "b.txt").write_text("2")
        tracker.add_artifact("app-1", "ckpt", str(d))
        mlrun = tracker._mlflow_run("app-1")
        assert sorted(tracker._fake.artifact_store[mlrun]) == [
            "ckpt/a.txt",
            "ckpt/sub/b.txt",
        ]

    def test_remote_artifact_becomes_pointer(self, tracker):
        tracker.add_artifact("app-1", "data", "gs://bucket/data")
        arts = tracker.artifacts("app-1")
        assert arts["data"].path == "gs://bucket/data"

    def test_store_only_artifacts_surface(self, tracker):
        # logged via raw mlflow, outside add_artifact
        mlrun = tracker._mlflow_run("app-1")
        tracker._fake.artifact_store[mlrun].append("profile/trace.json")
        arts = tracker.artifacts("app-1")
        assert "profile" in arts

    def test_lineage_upstream_and_downstream(self, tracker):
        tracker.add_source("train-1", "data-prep-1", artifact_name="tokens")
        tracker.add_source("eval-1", "train-1")
        lineage = tracker.lineage("train-1")
        assert [s.source_run_id for s in lineage.sources] == ["data-prep-1"]
        assert lineage.sources[0].artifact_name == "tokens"
        assert lineage.descendants == ["eval-1"]

    def test_source_order_stable_past_ten(self, tracker):
        # tag suffixes sort numerically: "source.10" after "source.2"
        for i in range(12):
            tracker.add_source("train-1", f"shard-{i}")
        order = [s.source_run_id for s in tracker.sources("train-1")]
        assert order == [f"shard-{i}" for i in range(12)]

    def test_descendants_paginated(self, tracker):
        # FakeMlflowClient pages at 2 runs; 4 tracked runs + sources forces
        # descendants() through multiple page tokens
        for name in ("eval-1", "eval-2", "eval-3"):
            tracker.add_source(name, "train-1")
        tracker.add_metadata("train-1", x=1)
        assert set(tracker.descendants("train-1")) == {
            "eval-1",
            "eval-2",
            "eval-3",
        }
        assert set(tracker.run_ids()) == {
            "train-1",
            "eval-1",
            "eval-2",
            "eval-3",
        }

    def test_run_ids_and_source_filter(self, tracker):
        tracker.add_source("eval-1", "train-1")
        tracker.add_metadata("train-1", x=1)
        assert set(tracker.run_ids()) == {"eval-1", "train-1"}
        assert list(tracker.run_ids(source_run_id="train-1")) == ["eval-1"]

    def test_log_params_flat(self, tracker):
        from dataclasses import dataclass as dc

        @dc
        class Opt:
            lr: float = 3e-4
            warmup: int = 100

        cfg = {"model": "llama3_1b", "opt": Opt(), "layers": [1, 2]}
        tracker.log_params_flat("app-1", cfg)
        md = tracker.metadata("app-1")
        assert md["model"] == "llama3_1b"
        assert md["opt.lr"] == 3e-4
        assert md["opt.warmup"] == 100.0
        assert md["layers"] == "[1, 2]"

    def test_factory_config_parse(self, tracker, monkeypatch):
        from torchx_tpu_torch.tracker.mlflow import create

        t = create("fake://host:5000;experiment=myexp")
        assert t._fake if hasattr(t, "_fake") else True
        assert "myexp" in t._client.experiments


def test_trackers_come_from_the_ports_own_entry_point_group(tmp_path, monkeypatch):
    """A tracker factory installed under the port's group
    ``tpx_torch.trackers`` is built from ``$TPX_TRACKERS``; one installed
    only under the JAX launcher's ``tpx_trackers`` is not loaded."""
    dist = tmp_path / "tpx_fake_tracker-0.1.dist-info"
    dist.mkdir()
    (dist / "METADATA").write_text("Metadata-Version: 2.1\nName: tpx-fake-tracker\n"
                                   "Version: 0.1\n")
    (dist / "entry_points.txt").write_text(
        "[tpx_trackers]\njax_only = tpx_fake_tracker_entry:jax_only\n"
        "[tpx_torch.trackers]\nport_t = tpx_fake_tracker_entry:port_t\n")
    (tmp_path / "tpx_fake_tracker_entry.py").write_text(
        "from torchx_tpu_torch.tracker.backend.fsspec import FsspecTracker\n"
        "def port_t(config):\n    return FsspecTracker(config)\n"
        "def jax_only(config):\n    raise AssertionError('the JAX group was read')\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.setenv("TPX_TRACKERS", "port_t,jax_only")
    monkeypatch.setenv("TPX_TRACKER_PORT_T_CONFIG", str(tmp_path / "runs"))
    try:
        trackers = trackers_from_environ()
    finally:
        sys.modules.pop("tpx_fake_tracker_entry", None)
        get_registry(invalidate_cache=True)
    assert list(trackers) == ["port_t"]
    assert isinstance(trackers["port_t"], FsspecTracker)


# -- parity: the same inputs through the JAX package and the port -------------


def _tree(root) -> dict:
    """Every file under ``root``: relative path -> bytes."""
    import os

    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def _drive_tracker(tracker, ckpt: str) -> dict:
    """One sequence of writes to ``tracker``, then everything it reads back,
    as plain values."""
    tracker.add_metadata("local://s/app1", lr=0.1, model="llama", nested={"a": [1, 2]},
                         flag=True)
    tracker.add_metadata("local://s/app1", step=5)
    tracker.add_artifact("local://s/app1", "ckpt", ckpt, {"step": 100})
    tracker.add_artifact("local://s/app1", "logs", "s3://bucket/logs")
    tracker.add_source("local://s/app2", "local://s/app1", artifact_name="ckpt")
    tracker.add_source("local://s/app2", "local://s/app0")
    return {
        "metadata": dict(tracker.metadata("local://s/app1")),
        "artifacts": {k: (a.name, a.path, a.metadata)
                      for k, a in tracker.artifacts("local://s/app1").items()},
        "sources": [(s.source_run_id, s.artifact_name)
                    for s in tracker.sources("local://s/app2")],
        "sources_of_ckpt": [s.source_run_id
                            for s in tracker.sources("local://s/app2", artifact_name="ckpt")],
        "run_ids": sorted(tracker.run_ids()),
    }


class TestJaxParity:
    def test_fsspec_store_equals_jax(self, tmp_path):
        """The same writes through each package's fsspec tracker leave the
        same files, byte for byte, and read back the same."""
        from torchx_tpu.tracker.backend.fsspec import FsspecTracker as JaxFsspecTracker

        reads = {}
        for name, cls in (("jax", JaxFsspecTracker), ("port", FsspecTracker)):
            reads[name] = _drive_tracker(cls(str(tmp_path / name)), "/mnt/ckpt/100")
        assert reads["port"] == reads["jax"]
        assert _tree(tmp_path / "port") == _tree(tmp_path / "jax") != {}

    def test_app_run_from_env_equals_jax(self, tmp_path, monkeypatch):
        """The in-job handle built from the same environment writes the same
        store, and the client's environment for a job is the same."""
        from torchx_tpu.runtime.tracking import FsspecResultTracker as JaxResultTracker
        from torchx_tpu.tracker import api as jax_api

        from torchx_tpu_torch.tracker import api as port_api

        monkeypatch.setenv("TPX_JOB_ID", "local://s/child")
        monkeypatch.setenv("TPX_TRACKERS", "fsspec")
        monkeypatch.setenv("TPX_PARENT_RUN_ID", "local://s/parent")
        for name, api, results in (("jax", jax_api, JaxResultTracker),
                                   ("port", port_api, FsspecResultTracker)):
            monkeypatch.setenv("TPX_TRACKER_FSSPEC_CONFIG", str(tmp_path / name / "runs"))
            api.AppRun._instance = None
            try:
                run = api.AppRun.run_from_env()
                assert list(api.trackers_from_environ()) == ["fsspec"]
                run.add_metadata(objective=0.5, name="trial")
                run.add_artifact("ckpt", "/mnt/ckpt/7", {"step": 7})
                run.add_source("local://s/other", artifact_name="data")
            finally:
                api.AppRun._instance = None
            store = results(str(tmp_path / name / "results"))
            store["trial/1"] = {"loss": 0.5, "steps": [1, 2]}
            store["trial/2"] = {"loss": None}
        assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")
        for kw in ({"parent_run_id": "p1", "trackers": {"fsspec": "/mnt/exp", "mlflow": None}},
                   {"trackers": {}}, {"parent_run_id": "p2"}):
            assert port_api.tracker_config_env_vars(**kw) == jax_api.tracker_config_env_vars(**kw)

    def test_mlflow_client_calls_equal_jax(self, tmp_path, monkeypatch):
        """The same writes through each package's MLflow tracker, each on
        its own fake client: the same experiments, runs, tags, params,
        metrics and artifact store, and the same reads."""
        import dataclasses

        clients = []

        def client_factory(tracking_uri=None):
            clients.append(FakeMlflowClient(tracking_uri))
            return clients[-1]

        mlflow_mod = types.ModuleType("mlflow")
        tracking_mod = types.ModuleType("mlflow.tracking")
        tracking_mod.MlflowClient = client_factory
        mlflow_mod.tracking = tracking_mod
        monkeypatch.setitem(sys.modules, "mlflow", mlflow_mod)
        monkeypatch.setitem(sys.modules, "mlflow.tracking", tracking_mod)

        from torchx_tpu.tracker.mlflow import MLflowTracker as JaxMLflowTracker

        from torchx_tpu_torch.tracker.mlflow import MLflowTracker

        ckpt = tmp_path / "model.ckpt"
        ckpt.write_text("weights")
        reads = []
        for cls in (JaxMLflowTracker, MLflowTracker):
            tracker = cls(tracking_uri="fake://x", experiment_name="tpx-parity")
            read = _drive_tracker(tracker, str(ckpt))
            tracker.log_params_flat("local://s/app1", {"opt": {"lr": 1e-3, "betas": [0.9, 0.95]}})
            read["lineage"] = dataclasses.asdict(tracker.lineage("local://s/app1"))
            read["descendants"] = sorted(tracker.run_ids(source_run_id="local://s/app1"))
            reads.append(read)
        jax_client, port_client = clients
        assert reads[1] == reads[0]
        assert port_client.experiments == jax_client.experiments
        assert port_client.runs == jax_client.runs and port_client.runs
        assert port_client.artifact_store == jax_client.artifact_store
