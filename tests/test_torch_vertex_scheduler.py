"""The port's Vertex AI backend
(``torchx_tpu_torch.schedulers.vertex_scheduler``): every case of
``tests/test_vertex_scheduler.py`` run against the copy on the
materialized CustomJob dict, with no cloud project. Its TPU machine specs
are written as A3 GPU specs (``a3-highgpu-{n}g``, ``NVIDIA_H100_80GB`` x
``n``); a slice of ``h`` hosts is a one-replica pool plus a pool of
``h - 1``, each container exporting its identity from ``CLUSTER_SPEC``
(run here through ``/bin/sh`` with Vertex's variables faked); an app of
more than four pools is refused; and the copy is held to the JAX
package's backend on the same app (``TestJaxParity``)."""

from unittest import mock

import pytest

from torchx_tpu_torch.schedulers.vertex_scheduler import (
    VertexScheduler,
    app_to_custom_job,
    cpu_machine_spec,
    describe_custom_job,
    gpu_machine_spec,
)
from torchx_tpu_torch.specs.api import (
    AppDef,
    AppState,
    Resource,
    Role,
    GpuSlice,
    macros,
)


def gpu_role(gpus=16, **kwargs) -> Role:
    defaults = dict(
        name="trainer",
        image="gcr.io/proj/img:1",
        entrypoint="python",
        args=["-m", "train", f"--app={macros.app_id}"],
        resource=Resource(cpu=208, memMB=448 * 1024, gpu=GpuSlice("h100", gpus)),
    )
    defaults.update(kwargs)
    return Role(**defaults)


@pytest.fixture(autouse=True)
def _registry_and_breakers(tmp_path, monkeypatch):
    """The job-name registry under ``tmp_path``, and fresh control-plane
    breakers."""
    from torchx_tpu_torch.resilience import call as resilience_call
    from torchx_tpu_torch.resilience import faults as resilience_faults

    monkeypatch.setattr("torchx_tpu_torch.schedulers.vertex_scheduler._registry_path",
                        lambda: str(tmp_path / "tpx_torch_vertex_jobs"))
    resilience_call.reset_breakers()
    resilience_faults.reset()


@pytest.fixture
def sched():
    return VertexScheduler("test", client=mock.MagicMock())


class TestCustomJobMaterialization:
    def test_gpu_machine_spec_multihost(self):
        spec = gpu_machine_spec(gpu_role())  # h100-16: 2 hosts of 8
        assert spec == {"machineType": "a3-highgpu-8g",
                        "acceleratorType": "NVIDIA_H100_80GB", "acceleratorCount": 8}

    def test_gpu_machine_spec_single_host(self):
        spec = gpu_machine_spec(gpu_role(gpus=4))
        assert spec == {"machineType": "a3-highgpu-4g",
                        "acceleratorType": "NVIDIA_H100_80GB", "acceleratorCount": 4}
        assert "tpuTopology" not in spec

    # A multi-host slice rides 8-GPU A3 VMs: one pool of one replica (Vertex's
    # first pool takes one), the other hosts in a second pool.
    @pytest.mark.parametrize(
        "gpus, machine_type, per_host, replica_counts",
        [
            (1, "a3-highgpu-1g", 1, [1]),
            (2, "a3-highgpu-2g", 2, [1]),
            (8, "a3-highgpu-8g", 8, [1]),
            (16, "a3-highgpu-8g", 8, [1, 1]),
            (32, "a3-highgpu-8g", 8, [1, 3]),
        ],
    )
    def test_gpu_machine_spec_and_pools(self, gpus, machine_type, per_host, replica_counts):
        job = app_to_custom_job(AppDef(name="t", roles=[gpu_role(gpus=gpus)]), "t-x", "s")
        pools = job["jobSpec"]["workerPoolSpecs"]
        assert [p["replicaCount"] for p in pools] == replica_counts
        for pool in pools:
            assert pool["machineSpec"] == {"machineType": machine_type,
                                           "acceleratorType": "NVIDIA_H100_80GB",
                                           "acceleratorCount": per_host}

    def test_unknown_generation_raises(self):
        with pytest.raises(ValueError, match="no h100 machine type carries 3 GPUs"):
            gpu_machine_spec(gpu_role(gpus=3))

    def test_gpu_machine_spec_from_catalog(self):
        from torchx_tpu_torch.specs import named_resources

        role = Role(
            name="scorer", image="i", entrypoint="python",
            resource=named_resources["gpu_a100_4"],
        )
        spec = cpu_machine_spec(role)
        assert spec == {
            "machineType": "a2-highgpu-4g",
            "acceleratorType": "NVIDIA_TESLA_A100",
            "acceleratorCount": 4,
        }

    def test_machine_type_capability_wins(self):
        role = Role(
            name="r", image="i", entrypoint="python",
            resource=Resource(
                cpu=6, memMB=40 * 1024,
                capabilities={"gce.machine_type": "c3-standard-22"},
            ),
        )
        assert cpu_machine_spec(role) == {"machineType": "c3-standard-22"}

    def test_cpu_machine_spec_covers_ask(self):
        role = Role(
            name="r", image="i", entrypoint="python",
            resource=Resource(cpu=6, memMB=40 * 1024),
        )
        assert cpu_machine_spec(role) == {"machineType": "n2-standard-16"}

    def test_worker_pools_and_env(self):
        app = AppDef(name="train", roles=[gpu_role()])
        job = app_to_custom_job(app, "train-abc12", "sess")
        assert job["displayName"] == "train-abc12"
        pools = job["jobSpec"]["workerPoolSpecs"]
        # 2 hosts: a one-replica pool, then the other host
        assert [p["replicaCount"] for p in pools] == [1, 1]
        for pool in pools:
            cs = pool["containerSpec"]
            assert cs["imageUri"] == "gcr.io/proj/img:1"
            assert cs["command"][:2] == ["/bin/sh", "-c"]
            assert '"--app=train-abc12"' in cs["command"][2]  # macro substituted
            env = {e["name"]: e["value"] for e in cs["env"]}
            assert env["TPX_APP_ID"] == "train-abc12"
            assert env["TPX_NUM_REPLICAS"] == "2"  # per-host procs in the slice
        assert job["labels"]["tpx-session"] == "sess"

    def test_retries_enable_restart_scheduling(self):
        app = AppDef(name="t", roles=[gpu_role(max_retries=2)])
        job = app_to_custom_job(app, "t-x", "s")
        assert job["jobSpec"]["scheduling"] == {"restartJobOnWorkerRestart": True}

    def test_replica_retry_policy_never_restarts_the_job(self):
        from torchx_tpu_torch.specs.api import RetryPolicy

        app = AppDef(
            name="t",
            roles=[gpu_role(max_retries=2, retry_policy=RetryPolicy.REPLICA)],
        )
        job = app_to_custom_job(app, "t-x", "s")
        assert "scheduling" not in job["jobSpec"]

    def test_multislice_rejected_on_submit_path(self, sched):
        # Scheduler.submit()/submit_dryrun() must hit the validation too,
        # not just the Runner path
        app = AppDef(name="t", roles=[gpu_role(num_replicas=2)])
        with pytest.raises(ValueError, match="multi-slice"):
            sched.submit_dryrun(app, {"project": "p"})

    def test_optional_infra_fields(self):
        app = AppDef(name="t", roles=[gpu_role()])
        job = app_to_custom_job(
            app, "t-x", "s",
            service_account="sa@proj.iam.gserviceaccount.com",
            network="projects/1/global/networks/vpc",
            staging_bucket="gs://bucket/out",
        )
        js = job["jobSpec"]
        assert js["serviceAccount"].startswith("sa@")
        assert js["network"].endswith("/vpc")
        assert js["baseOutputDirectory"] == {"outputUriPrefix": "gs://bucket/out"}

    def test_dryrun_materializes_full_request(self, sched):
        app = AppDef(name="t", roles=[gpu_role()])
        info = sched.submit_dryrun(app, {"project": "my-proj", "region": "us-east5"})
        req = info.request
        assert req.parent == "projects/my-proj/locations/us-east5"
        assert req.custom_job["jobSpec"]["workerPoolSpecs"]

    def test_multislice_rejected(self, sched):
        app = AppDef(name="t", roles=[gpu_role(num_replicas=2)])
        with pytest.raises(ValueError, match="multi-slice"):
            sched._validate(app, {})


class TestVertexLifecycle:
    def make_sched(self, tmp_path, monkeypatch, state="JOB_STATE_RUNNING"):
        client = mock.MagicMock()
        created = mock.MagicMock()
        created.name = "projects/p/locations/r/customJobs/123"
        client.create_custom_job.return_value = created
        got = mock.MagicMock()
        got.state.name = state
        got.error = None
        client.get_custom_job.return_value = got
        return VertexScheduler("test", client=client), client

    def test_schedule_describe_cancel(self, tmp_path, monkeypatch):
        sched, client = self.make_sched(tmp_path, monkeypatch)
        app = AppDef(name="t", roles=[gpu_role()])
        app_id = sched.submit(app, {"project": "p", "region": "r"})
        assert app_id.startswith("t-")
        kwargs = client.create_custom_job.call_args.kwargs
        assert kwargs["parent"] == "projects/p/locations/r"
        resp = sched.describe(app_id)
        assert resp.state == AppState.RUNNING
        sched.cancel(app_id)
        client.cancel_custom_job.assert_called_once_with(
            name="projects/p/locations/r/customJobs/123"
        )

    def test_describe_unknown_app(self, tmp_path, monkeypatch):
        sched, _ = self.make_sched(tmp_path, monkeypatch)
        assert sched.describe("nope") is None

    def test_log_iter_window_filters(self, tmp_path, monkeypatch):
        sched, client = self.make_sched(tmp_path, monkeypatch)
        app_id = sched.submit(
            AppDef(name="t", roles=[gpu_role()]), {"project": "p", "region": "r"}
        )
        calls = []

        def fake_run(cmd, **kwargs):
            calls.append(cmd)
            return mock.MagicMock(returncode=0, stdout="a\nb\n", stderr="")

        monkeypatch.setattr("subprocess.run", fake_run)
        lines = list(
            sched.log_iter(app_id, "w", 0, since=1785283200.0, until=1785286800.0)
        )
        assert lines == ["a", "b"]
        filt = calls[-1][3]
        assert 'timestamp>="2026-07-29T00:00:00Z"' in filt
        assert 'timestamp<="2026-07-29T01:00:00Z"' in filt

    def test_log_iter_rejects_stream_selection(self, tmp_path, monkeypatch):
        from torchx_tpu_torch.schedulers.api import Stream

        sched, _ = self.make_sched(tmp_path, monkeypatch)
        app_id = sched.submit(
            AppDef(name="t", roles=[gpu_role()]), {"project": "p", "region": "r"}
        )
        with pytest.raises(ValueError, match="combined"):
            sched.log_iter(app_id, "w", 0, streams=Stream.STDERR)

    def test_state_map_and_error_surface(self):
        resp = describe_custom_job(
            "a",
            {"state": "JOB_STATE_FAILED", "error": {"message": "OOM on host 2"}},
        )
        assert resp.state == AppState.FAILED
        assert "OOM" in resp.structured_error_msg
        assert describe_custom_job("a", {"state": "JOB_STATE_WEIRD"}).state == (
            AppState.UNKNOWN
        )


# =========================================================================
# A GPU replica's identity from CLUSTER_SPEC; the pool limit
# =========================================================================

import json  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from torchx_tpu_torch.schedulers.vertex_scheduler import MAX_WORKER_POOLS  # noqa: E402


def _run_container(pool: dict, cluster_spec, tmp_path) -> dict:
    """Run a pool's container command through ``/bin/sh`` as Vertex would,
    with ``CLUSTER_SPEC`` set (or not) and ``python3`` this interpreter; the
    entrypoint prints the identity it was given."""
    bindir = tmp_path / "bin"
    if not bindir.exists():
        bindir.mkdir()
        (bindir / "python3").symlink_to(sys.executable)
    env = {"PATH": f"{bindir}:/usr/bin:/bin"}
    env.update({e["name"]: e["value"] for e in pool["containerSpec"]["env"]})
    if cluster_spec is not None:
        env["CLUSTER_SPEC"] = json.dumps(cluster_spec)
    out = subprocess.run(pool["containerSpec"]["command"], env=env, capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return json.loads(out)


def _spec(task_type: str, index: int) -> dict:
    return {"cluster": {"workerpool0": ["cmle-training-workerpool0-ab12-0:2222"],
                        "workerpool1": ["cmle-training-workerpool1-ab12-0:2222",
                                        "cmle-training-workerpool1-ab12-1:2222"]},
            "environment": "cloud", "task": {"type": task_type, "index": index},
            "job": "{}"}


@pytest.mark.skipif(shutil.which("sh") is None, reason="needs /bin/sh")
class TestClusterSpecIdentity:
    def _pools(self, gpus):
        probe = ("import json, os; print(json.dumps({k: os.environ.get(k) for k in"
                 " ('TPX_REPLICA_ID', 'TPX_COORDINATOR_HOST', 'TPX_NUM_REPLICAS')}"
                 " | {'arg': __import__('sys').argv[1]}))")
        role = gpu_role(gpus=gpus, entrypoint="python3",
                        args=["-c", probe, f"--replica={macros.replica_id}"])
        return app_to_custom_job(AppDef(name="t", roles=[role]), "t-x", "s")[
            "jobSpec"]["workerPoolSpecs"]

    def test_three_hosts_number_themselves(self, tmp_path):
        pools = self._pools(24)
        assert [p["replicaCount"] for p in pools] == [1, 2]
        seen = [_run_container(pools[0], _spec("workerpool0", 0), tmp_path)]
        seen += [_run_container(pools[1], _spec("workerpool1", i), tmp_path) for i in (0, 1)]
        assert [s["TPX_REPLICA_ID"] for s in seen] == ["0", "1", "2"]
        assert [s["arg"] for s in seen] == ["--replica=0", "--replica=1", "--replica=2"]
        assert {s["TPX_COORDINATOR_HOST"] for s in seen} == {"cmle-training-workerpool0-ab12-0"}
        assert {s["TPX_NUM_REPLICAS"] for s in seen} == {"3"}

    def test_one_host_without_cluster_spec(self, tmp_path):
        (pool,) = self._pools(8)
        seen = _run_container(pool, None, tmp_path)
        assert (seen["TPX_REPLICA_ID"], seen["TPX_COORDINATOR_HOST"]) == ("0", "localhost")


class TestWorkerPoolLimit:
    def test_more_than_four_pools_refused(self, sched):
        roles = [gpu_role(name=f"r{i}") for i in range(3)]  # 3 two-host slices: 6 pools
        with pytest.raises(ValueError, match="needs 6 worker pools"):
            sched.submit_dryrun(AppDef(name="t", roles=roles), {"project": "p"})
        cpu = Role(name="c", image="i", entrypoint="python", resource=Resource(cpu=2, memMB=1024))
        info = sched.submit_dryrun(AppDef(name="t", roles=roles[:1] + [cpu, cpu]),
                                   {"project": "p"})
        assert len(info.request.custom_job["jobSpec"]["workerPoolSpecs"]) == MAX_WORKER_POOLS

    def test_image_repointed_on_every_pool(self, sched):
        role = gpu_role(image="sha256:" + "a" * 64)
        cpu = Role(name="c", image="img:2", entrypoint="python",
                   resource=Resource(cpu=2, memMB=1024))
        info = sched.submit_dryrun(AppDef(name="t", roles=[role, cpu]),
                                   {"project": "p", "image_repo": "gcr.io/p/r"})
        images = [p["containerSpec"]["imageUri"]
                  for p in info.request.custom_job["jobSpec"]["workerPoolSpecs"]]
        assert images == ["gcr.io/p/r:" + "a" * 12] * 2 + ["img:2"]

    def test_no_tpu_names(self, sched):
        text = str(sched.submit_dryrun(AppDef(name="t", roles=[gpu_role(gpus=32)]),
                                       {"project": "p"}))
        assert not [n for n in ("hightpu", "tpuTopology", "TPU_WORKER", "TPX_TPU_") if n in text]


# =========================================================================
# Parity with the JAX package's backend
# =========================================================================

from torchx_tpu.schedulers import vertex_scheduler as jvertex  # noqa: E402
from torchx_tpu.specs import api as japi  # noqa: E402
from torchx_tpu.specs import named_resources as jnamed  # noqa: E402
from torchx_tpu_torch.schedulers import vertex_scheduler as tvertex  # noqa: E402
from torchx_tpu_torch.schedulers.api import dquote  # noqa: E402
from torchx_tpu_torch.specs import named_resources  # noqa: E402


class TestJaxParity:
    """The same app through both packages' ``submit_dryrun``, ``make_unique``
    pinned: equal CustomJobs for CPU roles (and a mixed fleet's GPU role);
    for a GPU role against its TPU twin (``h100-16`` against ``v5p-8``, two
    hosts each) the JAX package's one pool becomes two pools with the GPU
    spec, the identity prelude before the same command, and the slice's
    name in the env."""

    @pytest.fixture(autouse=True)
    def _pinned(self, monkeypatch):
        for mod in (tvertex, jvertex):
            monkeypatch.setattr(mod, "make_unique", lambda name: f"{name}-fixed0")

    @staticmethod
    def _dryruns(troles, jroles, cfg):
        client = mock.MagicMock()
        ours = VertexScheduler("s", client=client).submit_dryrun(
            AppDef(name="app", roles=troles), cfg).request
        theirs = jvertex.VertexScheduler("s", client=client).submit_dryrun(
            japi.AppDef(name="app", roles=jroles), cfg).request
        return ours, theirs

    @pytest.mark.parametrize("cfg", [
        {"project": "p"},
        {"project": "p", "region": "us-east5", "service_account": "sa@p",
         "network": "projects/1/global/networks/v", "staging_bucket": "gs://b/o"},
    ])
    def test_cpu_job_equal_jax(self, cfg):
        kw = {"name": "reader", "image": "img:2", "entrypoint": "python", "num_replicas": 3,
              "args": ["-m", "read", f"--app={macros.app_id}"], "max_retries": 1,
              "env": {"K": "v"}}
        gkw = {"name": "scorer", "image": "img:3", "entrypoint": "python"}
        ours, theirs = self._dryruns(
            [Role(resource=Resource(cpu=6, memMB=40 * 1024), **kw),
             Role(resource=named_resources["gpu_a100_4"], **gkw)],
            [japi.Role(resource=japi.Resource(cpu=6, memMB=40 * 1024), **kw),
             japi.Role(resource=jnamed["gpu_a100_4"], **gkw)], cfg)
        assert (ours.project, ours.region, ours.parent) == \
            (theirs.project, theirs.region, theirs.parent)
        assert ours.custom_job == theirs.custom_job

    def test_gpu_twin(self):
        kw = {"name": "trainer", "image": "img:1", "entrypoint": "python",
              "args": ["-m", "train", f"--app={macros.app_id}"], "max_retries": 2}
        ours, theirs = self._dryruns(
            [Role(resource=Resource(cpu=200, memMB=1000, gpu=GpuSlice("h100", 16)), **kw)],
            [japi.Role(resource=japi.Resource(cpu=200, memMB=1000,
                                              tpu=japi.TpuSlice("v5p", 8)), **kw)],
            {"project": "p"})
        (want,) = theirs.custom_job["jobSpec"].pop("workerPoolSpecs")
        pools = ours.custom_job["jobSpec"].pop("workerPoolSpecs")
        assert ours.custom_job == theirs.custom_job  # name, labels, scheduling
        assert want["machineSpec"] == {"machineType": "ct5p-hightpu-4t",
                                       "tpuTopology": "2x2x2"}
        assert [p["replicaCount"] for p in pools] == [1, 1] and want["replicaCount"] == 1
        want_cs = want["containerSpec"]
        env = list(want_cs["env"])
        env[3:3] = [{"name": "TPX_GPU_ACCELERATOR_TYPE", "value": "h100-16"},
                    {"name": "TPX_GPU_TOPOLOGY", "value": "2x8"}]
        command = " ".join(dquote(a) for a in [*want_cs["command"], *want_cs["args"]])
        for pool in pools:
            assert pool["machineSpec"] == gpu_machine_spec(Role(
                name="x", image="", resource=Resource(gpu=GpuSlice("h100", 16))))
            cs = pool["containerSpec"]
            assert (cs["imageUri"], cs["env"], cs["args"]) == (want_cs["imageUri"], env, [])
            shell, flag, script = cs["command"]
            assert (shell, flag) == ("/bin/sh", "-c")
            lines = script.splitlines()
            assert lines[-1] == f"exec {command}"
            assert [ln.split("=", 1)[0] for ln in lines[:-1]] == [
                "export TPX_REPLICA_ID", "export TPX_COORDINATOR_HOST"]
