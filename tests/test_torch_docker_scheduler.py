"""The port's docker backend (``torchx_tpu_torch.schedulers.docker_scheduler``)
with a mock client: every case of ``tests/test_docker_scheduler.py`` and
``tests/test_devices.py::test_docker_scheduler_maps_named_devices`` run
against the copy, its TPU-host expansion written as an H100 slice's; the
GPU request that replaced the ``/dev/nvidia<N>`` nodes (a replica names
its share of the cards the CUDA driver sees, by UUID); and the copy held to
the JAX package's backend on the same app (``TestJaxParity``)."""

import ctypes
from unittest import mock

import pytest

from torchx_tpu.schedulers import docker_scheduler as jdocker
from torchx_tpu.specs import api as japi
from torchx_tpu_torch import settings
from torchx_tpu_torch.resilience import call as resilience_call
from torchx_tpu_torch.resilience import faults as resilience_faults
from torchx_tpu_torch.schedulers import devices
from torchx_tpu_torch.schedulers import docker_scheduler as tdocker
from torchx_tpu_torch.schedulers import local_scheduler as lsched
from torchx_tpu_torch.schedulers.docker_scheduler import DockerScheduler
from torchx_tpu_torch.specs import named_resources
from torchx_tpu_torch.specs.api import (
    AppDef,
    AppState,
    BindMount,
    GpuSlice,
    Resource,
    Role,
)
from torch_threads import xdist_torch_threads  # noqa: F401


def uuids(n: int) -> list[str]:
    return [f"GPU-{i:08x}-aaaa-bbbb-cccc-{i:012x}" for i in range(n)]


@pytest.fixture(autouse=True)
def _host(monkeypatch):
    """A docker host whose CUDA driver finds no card (a case that wants
    cards gives them with :func:`cards`), and fresh control-plane
    breakers."""
    monkeypatch.delenv(settings.ENV_CUDA_VISIBLE_DEVICES, raising=False)
    monkeypatch.setattr(lsched, "driver_gpu_count", lambda: 0)
    monkeypatch.setattr(lsched, "driver_gpu_uuids", lambda: [])
    resilience_call.reset_breakers()
    resilience_faults.reset()


def cards(monkeypatch, n: int) -> list[str]:
    """The CUDA driver finds ``n`` cards on this host."""
    ids = uuids(n)
    monkeypatch.setattr(lsched, "driver_gpu_count", lambda: n)
    monkeypatch.setattr(lsched, "driver_gpu_uuids", lambda: list(ids))
    return ids


@pytest.fixture
def sched():
    return DockerScheduler("test", docker_client=mock.MagicMock())


def app(**role_kwargs) -> AppDef:
    defaults = dict(
        name="r",
        image="img:1",
        entrypoint="python",
        args=["-m", "t"],
        num_replicas=2,
        resource=Resource(cpu=2, memMB=2048),
    )
    defaults.update(role_kwargs)
    return AppDef(name="app", roles=[Role(**defaults)])


class TestDockerDryrun:
    def test_containers_share_network_and_coordinator(self, sched):
        info = sched.submit_dryrun(app(), {})
        req = info.request
        assert len(req.containers) == 2
        c0, c1 = req.containers
        assert c0.kwargs["network"] == "tpx"
        # coordinator = container name of role replica 0
        assert c0.kwargs["environment"]["TPX_COORDINATOR_HOST"] == c0.kwargs["name"]
        assert c1.kwargs["environment"]["TPX_COORDINATOR_HOST"] == c0.kwargs["name"]
        assert c1.kwargs["environment"]["TPX_REPLICA_ID"] == "1"

    def test_resource_limits(self, sched):
        info = sched.submit_dryrun(app(), {})
        c = info.request.containers[0]
        assert c.kwargs["mem_limit"] == "2048m"
        assert c.kwargs["nano_cpus"] == int(2e9)

    def test_restart_policy(self, sched):
        info = sched.submit_dryrun(app(max_retries=3), {})
        assert info.request.containers[0].kwargs["restart_policy"] == {
            "Name": "on-failure",
            "MaximumRetryCount": 3,
        }

    def test_mounts(self, sched):
        info = sched.submit_dryrun(
            app(mounts=[BindMount(src_path="/data", dst_path="/data", read_only=True)]),
            {},
        )
        (m,) = info.request.containers[0].kwargs["mounts"]
        assert m["source"] == "/data" and m["read_only"] is True

    def test_gpu_role_expands_hosts(self, sched, monkeypatch):
        cards(monkeypatch, 16)
        info = sched.submit_dryrun(
            app(
                num_replicas=1,
                resource=Resource(cpu=1, memMB=1, gpu=GpuSlice("h100", 16)),
            ),
            {},
        )
        # a slice above one host's eight takes whole hosts: 16 cards -> 2 hosts
        assert len(info.request.containers) == 2

    def test_copy_env_globs(self, sched, monkeypatch):
        monkeypatch.setenv("TPX_TEST_SECRETVAR", "v")
        monkeypatch.setenv("OTHER", "x")
        info = sched.submit_dryrun(app(), {"copy_env": ["TPX_TEST_*"]})
        env = info.request.containers[0].kwargs["environment"]
        assert env["TPX_TEST_SECRETVAR"] == "v"
        assert "OTHER" not in env

    def test_schedule_runs_containers(self, sched):
        info = sched.submit_dryrun(app(), {})
        app_id = sched.schedule(info)
        assert app_id == info.request.app_id
        assert sched._client.containers.run.call_count == 2

    def test_maps_named_devices(self, monkeypatch):
        # tests/test_devices.py maps a mixed fleet's nvidia.com/gpu count on
        # a role without a GPU slice to /dev/nvidia<N> mounts; here it is
        # the role's device request for the driver's cards by UUID, as a
        # slice role's is, and no node is mounted
        ids = cards(monkeypatch, 2)
        sched = DockerScheduler("t", docker_client=mock.MagicMock())
        role = Role(name="g", image="i", entrypoint="e",
                    resource=Resource(cpu=1, memMB=1, devices={"nvidia.com/gpu": 1}))
        info = sched.submit_dryrun(AppDef(name="g", roles=[role]), {})
        kwargs = info.request.containers[0].kwargs
        assert kwargs["device_requests"] == [
            {"driver": "nvidia", "device_ids": ids[:1], "capabilities": [["gpu"]]}]
        assert not any(d.startswith("/dev/nvidia") for d in kwargs.get("devices", []))


class TestDockerDescribe:
    def _container(self, role, replica, status, exit_code=0, name="c"):
        c = mock.MagicMock()
        c.labels = {
            "tpx.sh/app-id": "app1",
            "tpx.sh/role-name": role,
            "tpx.sh/replica-id": str(replica),
        }
        c.status = status
        c.attrs = {"State": {"ExitCode": exit_code}}
        c.name = name
        return c

    def test_running(self, sched):
        sched._client.containers.list.return_value = [
            self._container("r", 0, "running"),
            self._container("r", 1, "running"),
        ]
        resp = sched.describe("app1")
        assert resp.state == AppState.RUNNING
        assert len(resp.roles_statuses[0].replicas) == 2

    def test_failed_dominates(self, sched):
        sched._client.containers.list.return_value = [
            self._container("r", 0, "exited", exit_code=1),
            self._container("r", 1, "running"),
        ]
        assert sched.describe("app1").state == AppState.FAILED

    def test_all_succeeded(self, sched):
        sched._client.containers.list.return_value = [
            self._container("r", 0, "exited", exit_code=0),
        ]
        assert sched.describe("app1").state == AppState.SUCCEEDED

    def test_list_partial_not_terminal(self, sched):
        sched._client.containers.list.return_value = [
            self._container("r", 0, "exited", exit_code=0),
            self._container("r", 1, "running"),
        ]
        (app,) = sched.list()
        assert app.state == AppState.RUNNING

    def test_missing(self, sched):
        sched._client.containers.list.return_value = []
        assert sched.describe("ghost") is None


def gpu_app(gpus: int, num_replicas: int = 1, **resource) -> AppDef:
    res = resource.pop("res", None) or Resource(cpu=1, memMB=64, gpu=GpuSlice("h100", gpus))
    return AppDef(name="g", roles=[Role(name="w", image="img:1", entrypoint="python",
                                        num_replicas=num_replicas, resource=res)])


def requests_of(info) -> list[list[str]]:
    """Each container's requested card ids."""
    out = []
    for c in info.request.containers:
        (req,) = c.kwargs["device_requests"]
        assert (req["driver"], req["capabilities"]) == ("nvidia", [["gpu"]])
        out.append(req["device_ids"])
    return out


class TestGpuDeviceRequest:
    """A GPU replica names its share of the driver's cards; no
    ``/dev/nvidia<N>`` node is mounted or counted."""

    def test_no_card_refused(self, sched):
        with pytest.raises(ValueError, match="finds no card"):
            sched.submit_dryrun(gpu_app(1), {})

    def test_one_driver_card_beside_two_nodes(self, sched, monkeypatch):
        """The H100 machine of one card had nodes nvidia0 and nvidia7: the
        request names the driver's one card, and no node is mounted."""
        import glob
        import os

        monkeypatch.setattr(glob, "glob", lambda p, **kw: ["/dev/nvidia0", "/dev/nvidia7"])
        monkeypatch.setattr(os.path, "exists", lambda p: True)
        (card,) = cards(monkeypatch, 1)
        info = sched.submit_dryrun(gpu_app(1), {})
        assert requests_of(info) == [[card]]
        assert "devices" not in info.request.containers[0].kwargs
        with pytest.raises(ValueError, match="need 2 cards, and this host has 1"):
            sched.submit_dryrun(gpu_app(2), {})

    def test_two_replicas_split_eight_cards(self, sched, monkeypatch):
        ids = cards(monkeypatch, 8)
        info = sched.submit_dryrun(gpu_app(4, num_replicas=2), {})
        assert requests_of(info) == [ids[:4], ids[4:]]
        # the split is the local scheduler's CUDA_VISIBLE_DEVICES split
        for rid, got in enumerate(requests_of(info)):
            env = lsched.gpu_device_env(4, rid, 2, ids, simulate=False)
            assert env[settings.ENV_CUDA_VISIBLE_DEVICES].split(",") == got

    def test_launcher_cuda_visible_devices(self, sched, monkeypatch):
        """The launcher's own CUDA_VISIBLE_DEVICES decides the cards: UUID
        entries as they are; ordinals as the UUIDs the driver gives them
        under it; ordinals as they are where no driver answers."""
        given = uuids(4)[2:]
        monkeypatch.setenv(settings.ENV_CUDA_VISIBLE_DEVICES, ",".join(given))
        assert requests_of(sched.submit_dryrun(gpu_app(2), {})) == [given]
        monkeypatch.setenv(settings.ENV_CUDA_VISIBLE_DEVICES, "3,5")
        monkeypatch.setattr(lsched, "driver_gpu_uuids", lambda: ["GPU-c", "GPU-d"])
        assert requests_of(sched.submit_dryrun(gpu_app(1, num_replicas=2), {})) == \
            [["GPU-c"], ["GPU-d"]]
        monkeypatch.setattr(lsched, "driver_gpu_uuids", lambda: [])
        assert requests_of(sched.submit_dryrun(gpu_app(2), {})) == [["3", "5"]]
        monkeypatch.setenv(settings.ENV_CUDA_VISIBLE_DEVICES, "")
        with pytest.raises(ValueError, match="finds no card"):
            sched.submit_dryrun(gpu_app(1), {})

    def test_named_gpu_resource_requests_not_mounts(self, sched, monkeypatch):
        """``h100-16`` also carries ``devices["nvidia.com/gpu"] = 8``: that is
        the request, not eight node mounts."""
        ids = cards(monkeypatch, 16)
        info = sched.submit_dryrun(gpu_app(0, res=named_resources["h100-16"]), {})
        assert requests_of(info) == [ids[:8], ids[8:]]
        assert all("devices" not in c.kwargs for c in info.request.containers)

    def test_named_gpu_count_without_a_slice(self, sched, monkeypatch):
        """A mixed fleet's role asks ``devices["nvidia.com/gpu"] = n`` with no
        GPU slice: each replica gets its share of the driver's cards by
        UUID and no node mount, and more cards than the host's are refused,
        as for a slice role."""
        ids = cards(monkeypatch, 4)
        res = Resource(cpu=1, memMB=64, devices={"nvidia.com/gpu": 2})
        info = sched.submit_dryrun(gpu_app(0, num_replicas=2, res=res), {})
        assert requests_of(info) == [ids[:2], ids[2:]]
        assert all("devices" not in c.kwargs for c in info.request.containers)
        with pytest.raises(ValueError, match="need 6 cards, and this host has 4"):
            sched.submit_dryrun(gpu_app(0, num_replicas=3, res=res), {})
        cards(monkeypatch, 0)
        with pytest.raises(ValueError, match="finds no card"):
            sched.submit_dryrun(gpu_app(0, res=Resource(devices={"nvidia.com/gpu": 1})), {})

    def test_driver_gpu_uuids_format(self, monkeypatch):
        """``cuDeviceGetUuid``'s 16 bytes as nvidia-smi prints them, one per
        ordinal; nothing where the driver fails."""

        class FakeCuda:
            def __init__(self, n, fail_at=None):
                self.n, self.fail_at = n, fail_at

            def cuInit(self, flags):
                return 0

            def cuDeviceGetCount(self, ref):
                ref._obj.value = self.n
                return 0

            def cuDeviceGet(self, ref, ordinal):
                ref._obj.value = ordinal
                return 1 if ordinal == self.fail_at else 0

            def cuDeviceGetUuid(self, raw, dev):
                for i in range(16):
                    raw[i] = (dev.value * 16 + i) & 0xFF
                return 0

        monkeypatch.setattr(lsched, "driver_gpu_uuids", DRIVER_GPU_UUIDS)
        monkeypatch.setattr(ctypes, "CDLL", lambda name: FakeCuda(2))
        assert lsched.driver_gpu_uuids() == [
            "GPU-00010203-0405-0607-0809-0a0b0c0d0e0f",
            "GPU-10111213-1415-1617-1819-1a1b1c1d1e1f"]
        monkeypatch.setattr(ctypes, "CDLL", lambda name: FakeCuda(2, fail_at=1))
        assert lsched.driver_gpu_uuids() == []

        def no_driver(name):
            raise OSError("libcuda.so.1: cannot open shared object file")

        monkeypatch.setattr(ctypes, "CDLL", no_driver)
        assert lsched.driver_gpu_uuids() == []

    def test_local_gpu_ids(self, monkeypatch):
        assert devices.local_gpu_ids() == []
        ids = cards(monkeypatch, 2)
        assert devices.local_gpu_ids() == ids  # the driver's ordinals, as UUIDs


#: the CUDA driver query itself (every case above fakes it)
DRIVER_GPU_UUIDS = lsched.driver_gpu_uuids


class TestJaxParity:
    """The same app through both packages' ``submit_dryrun``, ``make_unique``
    pinned: equal containers for a CPU role; for a GPU role against its TPU
    twin (``h100-16`` against a two-host ``v5p-16``) they differ in the
    accelerator's names and the port's device request only."""

    @pytest.fixture(autouse=True)
    def _pinned(self, monkeypatch):
        for mod in (tdocker, jdocker):
            monkeypatch.setattr(mod, "make_unique", lambda name: f"{name}-fixed0")

    def _pair(self, trole: Role, jrole: "japi.Role", cfg=None):
        ours = DockerScheduler("s", docker_client=mock.MagicMock()).submit_dryrun(
            AppDef(name="app", roles=[trole]), cfg or {})
        theirs = jdocker.DockerScheduler("s", docker_client=mock.MagicMock()).submit_dryrun(
            japi.AppDef(name="app", roles=[jrole]), cfg or {})
        as_dicts = [[{"image": c.image, "command": c.command, **c.kwargs}
                     for c in info.request.containers] for info in (ours, theirs)]
        return as_dicts

    def test_cpu_role_containers_equal_jax(self, monkeypatch):
        monkeypatch.setenv("TPX_PARITY_X", "1")
        kw = dict(name="r", image="img:1", entrypoint="python", args=["-m", "t", "--x=1"],
                  num_replicas=3, max_retries=2, env={"A": "b"})
        ours, theirs = self._pair(
            Role(resource=Resource(cpu=2, memMB=2048), **kw,
                 mounts=[BindMount(src_path="/d", dst_path="/d")]),
            japi.Role(resource=japi.Resource(cpu=2, memMB=2048), **kw,
                      mounts=[japi.BindMount(src_path="/d", dst_path="/d")]),
            {"copy_env": ["TPX_PARITY_*"], "env": {"E": "f"}, "privileged": True})
        assert ours == theirs
        assert len(ours) == 3

    def test_gpu_role_differs_in_the_accelerator_only(self, monkeypatch):
        ids = cards(monkeypatch, 16)
        kw = dict(name="r", image="img:1", entrypoint="python", args=["-m", "t"])
        ours, theirs = self._pair(
            Role(resource=Resource(cpu=8, memMB=4096, gpu=GpuSlice("h100", 16)), **kw),
            japi.Role(resource=japi.Resource(cpu=8, memMB=4096, tpu=japi.TpuSlice("v5p", 8)),
                      **kw))
        assert len(ours) == len(theirs) == 2
        for rid, (o, t) in enumerate(zip(ours, theirs)):
            (req,) = o.pop("device_requests")
            assert req["device_ids"] == ids[rid * 8:(rid + 1) * 8]
            t.pop("devices", None)  # the TPU host's /dev/accel* nodes, where present
            oenv, tenv = o.pop("environment"), t.pop("environment")
            assert o == t
            assert {k: v for k, v in oenv.items() if not k.startswith("TPX_GPU_")} == \
                {k: v for k, v in tenv.items() if not k.startswith("TPX_TPU_")}
            assert (oenv["TPX_GPU_ACCELERATOR_TYPE"], oenv["TPX_GPU_TOPOLOGY"]) == \
                ("h100-16", "2x8")

    def test_privileged_help_names_no_tpu(self):
        help_text = DockerScheduler("s", docker_client=mock.MagicMock()).run_opts() \
            .get("privileged").help
        assert "TPU" not in help_text and "device request" in help_text
