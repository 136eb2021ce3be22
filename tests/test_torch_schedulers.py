"""The port's scheduler contract (``torchx_tpu_torch.schedulers``): the
cases of ``tests/test_scheduler_conformance.py`` over the port's whole
table (the JAX table less ``tpu_vm``) and its
``TestLocalSchedulerLifecycle``, the GPU mapping and unknown-device cases of
``tests/test_devices.py``, run against the copy; a GPU replica's card
request (``devices.gpu_device_request``), which counts the CUDA driver's
cards and no ``/dev/nvidia<N>`` node; and the copy held to the
JAX package's ``torchx_tpu.schedulers`` on the same seeded inputs: app ids
(``ids.cleanup`` / ``sanitize_name`` / ``make_unique``), the ``Tee``'s
stamped bytes, ``StructuredOpts`` -> ``runopts``, the shell and log-line
helpers of ``api.py``, and each replica's gang identity. This host has no
card, so the GPU role of the conformance app passes ``gpu_simulate=True``
on the local scheduler, and the docker host is given eight cards."""

import dataclasses
import random
import re
from pathlib import Path
from unittest import mock
import string
import time
from dataclasses import dataclass, field
from typing import Optional

import pytest

from torchx_tpu.schedulers import api as japi
from torchx_tpu.schedulers import ids as jids
from torchx_tpu.schedulers import local_scheduler as jlocal
from torchx_tpu.schedulers import streams as jstreams
from torchx_tpu.schedulers.structured_opts import StructuredOpts as JStructuredOpts
from torchx_tpu.specs import api as jspecs
from torchx_tpu_torch import settings
from torchx_tpu_torch.schedulers import (
    DEFAULT_SCHEDULER_MODULES,
    get_default_scheduler_name,
    get_scheduler_factories,
)
from torchx_tpu_torch.schedulers import api as tapi
from torchx_tpu_torch.schedulers import ids as tids
from torchx_tpu_torch.schedulers import local_scheduler as lsched
from torchx_tpu_torch.schedulers import streams as tstreams
from torchx_tpu_torch.schedulers.api import DescribeAppResponse, Scheduler
from torchx_tpu_torch.schedulers.devices import (
    DEVICE_MAPPINGS,
    get_device_mounts,
    gpu_device_request,
)
from torchx_tpu_torch.schedulers.structured_opts import StructuredOpts
from torchx_tpu_torch.specs.api import (
    AppDef,
    AppDryRunInfo,
    AppState,
    FailureClass,
    GpuSlice,
    Resource,
    Role,
    is_terminal,
    runopts,
)
from torch_threads import xdist_torch_threads  # noqa: F401


@pytest.fixture(autouse=True)
def _no_card_and_own_registry(tmp_path, monkeypatch):
    """A card-less host whatever the environment says; the per-user app
    registry in ``tmp_path``."""
    monkeypatch.setattr(lsched, "_registry_path", lambda: str(tmp_path / "registry"))
    monkeypatch.delenv(settings.ENV_CUDA_VISIBLE_DEVICES, raising=False)
    monkeypatch.setattr(lsched, "driver_gpu_count", lambda: 0)


# -- conformance (tests/test_scheduler_conformance.py) ----------------------


def make_scheduler(name: str) -> Scheduler:
    factory = get_scheduler_factories()[name]
    kwargs = {}
    if name == "gke":
        kwargs["client"] = object()  # never used at dryrun level
    if name == "local_docker":
        kwargs["docker_client"] = mock.MagicMock()
    if name == "vertex":
        kwargs["client"] = mock.MagicMock()
    if name == "gcp_batch":
        kwargs["docker_client"] = mock.MagicMock()
    return factory(session_name="conformance", **kwargs)


def sample_app(name: str) -> AppDef:
    role = Role(
        name="trainer",
        image="img:1"
        if name in ("gke", "local_docker", "vertex", "gcp_batch")
        else "",
        entrypoint="python",
        args=["-m", "train"],
        resource=Resource(cpu=2, memMB=1024, gpu=GpuSlice("h100", 8)),
    )
    return AppDef(name="conf-test", roles=[role])


MINIMAL_CFG = {
    "local": {"gpu_simulate": True},
    "local_docker": {},
    "gke": {},
    "slurm": {},
    "vertex": {"project": "test-proj"},
    "gcp_batch": {"project": "test-proj"},
}

ALL = sorted(DEFAULT_SCHEDULER_MODULES)


@pytest.fixture
def docker_host_cards(monkeypatch):
    """The docker host's CUDA driver finds eight cards (the conformance
    app's slice)."""
    monkeypatch.setattr(lsched, "driver_gpu_count", lambda: 8)
    monkeypatch.setattr(lsched, "driver_gpu_uuids",
                        lambda: [f"GPU-{i:08x}-0000-0000-0000-000000000000" for i in range(8)])


class TestSchedulerConformance:
    def test_only_ported_backends_are_listed(self):
        from torchx_tpu.schedulers import DEFAULT_SCHEDULER_MODULES as JAX_TABLE

        # the JAX package's order, less the backend with no GPU machine
        assert list(DEFAULT_SCHEDULER_MODULES) == [n for n in JAX_TABLE if n != "tpu_vm"] == [
            "local", "gke", "slurm", "local_docker", "vertex", "gcp_batch"]
        assert ALL == sorted(MINIMAL_CFG)
        assert set(get_scheduler_factories()) >= set(ALL)
        for name, target in DEFAULT_SCHEDULER_MODULES.items():
            assert target == JAX_TABLE[name].replace("torchx_tpu.", "torchx_tpu_torch.")

    @pytest.mark.parametrize("name", ALL)
    def test_factory_and_backend_name(self, name):
        sched = make_scheduler(name)
        assert isinstance(sched, Scheduler)
        assert sched.backend == name
        assert sched.session_name == "conformance"
        sched.close()  # idempotent

    @pytest.mark.parametrize("name", ALL)
    def test_run_opts_shape(self, name):
        opts = make_scheduler(name).run_opts()
        assert isinstance(opts, runopts)
        for key, opt in opts:
            assert opt.help, f"{name}.{key} has no help text"
            assert not (opt.is_required and opt.default is not None)

    @pytest.mark.parametrize("name", ALL)
    def test_submit_dryrun_contract(self, name, tmp_path, docker_host_cards):
        """submit_dryrun materializes the full request without touching any
        backend, and stamps the dryrun info (the core testability design)."""
        sched = make_scheduler(name)
        cfg = dict(MINIMAL_CFG[name])
        if name == "local":
            cfg["log_dir"] = str(tmp_path)
        info = sched.submit_dryrun(sample_app(name), cfg)
        assert isinstance(info, AppDryRunInfo)
        assert info._scheduler == name
        assert info._app is not None and info._app.name == "conf-test"
        assert info._cfg is not None
        assert str(info)  # every request pretty-prints

    @pytest.mark.parametrize("name", ALL)
    def test_pre_proc_hook_applies(self, name, tmp_path, docker_host_cards):
        marker = {}

        def pre_proc(backend, dryrun_info):  # noqa: ANN001
            marker["backend"] = backend
            return dryrun_info

        app = sample_app(name)
        app.roles[0].pre_proc = pre_proc
        cfg = dict(MINIMAL_CFG[name])
        if name == "local":
            cfg["log_dir"] = str(tmp_path)
        make_scheduler(name).submit_dryrun(app, cfg)
        assert marker["backend"] == name

    @pytest.mark.parametrize("name", ["local"])
    def test_cancel_nonexistent_is_noop(self, name):
        make_scheduler(name).cancel("ghost-app-id")  # must not raise

    def test_default_scheduler_is_first(self):
        assert get_default_scheduler_name() == next(iter(DEFAULT_SCHEDULER_MODULES))
        assert get_default_scheduler_name() == "local"

    @pytest.mark.parametrize("name", ALL)
    def test_classify_failure_contract(self, name):
        """Every backend honors the supervisor's classification contract:
        PREEMPTED -> PREEMPTION, bare FAILED -> APP (conservative), a
        describe-attached class wins, non-failures -> None."""
        sched = make_scheduler(name)

        def resp(state, fclass=None):
            return DescribeAppResponse(
                app_id="x", state=state, failure_class=fclass
            )

        assert (
            sched.classify_failure(resp(AppState.PREEMPTED))
            == FailureClass.PREEMPTION
        )
        assert sched.classify_failure(resp(AppState.FAILED)) == FailureClass.APP
        assert (
            sched.classify_failure(resp(AppState.FAILED, FailureClass.INFRA))
            == FailureClass.INFRA
        )
        for state in (
            AppState.RUNNING,
            AppState.PENDING,
            AppState.SUCCEEDED,
            AppState.CANCELLED,
        ):
            assert sched.classify_failure(resp(state)) is None


def _run_local_echo(sched, tmp_path, timeout: float = 20.0) -> str:
    """Submit a trivial echo app on the local scheduler and wait for a
    terminal state; returns the app id."""
    role = Role(
        name="echo",
        image="",
        entrypoint="echo",
        args=["conformance"],
        resource=Resource(cpu=1, memMB=64),
    )
    info = sched.submit_dryrun(
        AppDef(name="conf-lifecycle", roles=[role]), {"log_dir": str(tmp_path)}
    )
    app_id = sched.schedule(info)
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        desc = sched.describe(app_id)
        if desc is not None and is_terminal(desc.state):
            return app_id
        time.sleep(0.05)
    raise AssertionError(f"app {app_id} never reached a terminal state")


class TestLocalSchedulerLifecycle:
    """Lifecycle contract checked end-to-end on the one backend that can
    actually run jobs in CI."""

    def test_terminal_state_stays_terminal(self, tmp_path):
        sched = make_scheduler("local")
        try:
            app_id = _run_local_echo(sched, tmp_path)
            first = sched.describe(app_id).state
            assert is_terminal(first)
            # repeated describes (and a cancel) must never un-terminal it
            sched.cancel(app_id)
            for _ in range(3):
                assert sched.describe(app_id).state == first
        finally:
            sched.close()

    def test_exists_false_after_delete(self, tmp_path):
        sched = make_scheduler("local")
        try:
            app_id = _run_local_echo(sched, tmp_path)
            assert sched.exists(app_id)
            sched.delete(app_id)
            assert not sched.exists(app_id)
            assert sched.describe(app_id) is None
            assert app_id not in [a.app_id for a in sched.list()]
            sched.delete(app_id)  # idempotent
        finally:
            sched.close()


# -- devices (tests/test_devices.py) ----------------------------------------


class TestDeviceMounts:
    def test_gpu_mapping(self):
        gpu = get_device_mounts({"nvidia.com/gpu": 1})
        assert gpu[0].src_path == "/dev/nvidia0"
        assert any("nvidiactl" in m.src_path for m in gpu)

    def test_unknown_device_skipped(self):
        assert get_device_mounts({"vendor.com/thing": 1}) == []

    def test_gpu_mapping_equals_jax(self):
        from torchx_tpu.schedulers import devices as jdevices

        assert set(DEVICE_MAPPINGS) == set(jdevices.DEVICE_MAPPINGS) == {"nvidia.com/gpu"}
        for n in (1, 2, 8):
            ours = [(m.src_path, m.dst_path, m.permissions)
                    for m in get_device_mounts({"nvidia.com/gpu": n})]
            assert ours == [(m.src_path, m.dst_path, m.permissions)
                            for m in jdevices.get_device_mounts({"nvidia.com/gpu": n})]
            assert len(ours) == n + 2



def _uuids(n: int) -> list[str]:
    return [f"GPU-{i:08x}-1111-2222-3333-{i:012x}" for i in range(n)]


class TestGpuDeviceRequest:
    """A GPU replica's card request counts the CUDA driver's cards, split
    as ``gpu_device_env`` splits them; the ``/dev/nvidia<N>`` nodes decide
    nothing (these cases replaced the test of ``local_gpu_device_mounts``, which
    globbed them)."""

    @pytest.fixture
    def nodes(self, monkeypatch):
        """Every glob finds the one-card H100 machine's two nodes, whatever
        the driver says."""
        import glob

        monkeypatch.setattr(glob, "glob", lambda pattern, **kw: ["/dev/nvidia0", "/dev/nvidia7"])

    def _driver(self, monkeypatch, n: int) -> list[str]:
        ids = _uuids(n)
        monkeypatch.setattr(lsched, "driver_gpu_count", lambda: n)
        monkeypatch.setattr(lsched, "driver_gpu_uuids", lambda: list(ids))
        return ids

    def test_no_card(self, nodes):
        with pytest.raises(ValueError, match="finds no card"):
            gpu_device_request(1, 0, 1)

    def test_one_driver_card_beside_two_nodes(self, nodes, monkeypatch):
        (card,) = self._driver(monkeypatch, 1)
        assert gpu_device_request(1, 0, 1) == {
            "driver": "nvidia", "device_ids": [card], "capabilities": [["gpu"]]}
        with pytest.raises(ValueError, match="need 2 cards, and this host has 1"):
            gpu_device_request(2, 0, 1)

    def test_two_replicas_split_eight_cards(self, nodes, monkeypatch):
        ids = self._driver(monkeypatch, 8)
        shares = [gpu_device_request(4, rid, 2)["device_ids"] for rid in range(2)]
        assert shares == [ids[:4], ids[4:]]
        assert [lsched.gpu_device_env(4, rid, 2, ids, simulate=False)
                [settings.ENV_CUDA_VISIBLE_DEVICES] for rid in range(2)] == \
            [",".join(share) for share in shares]

    @pytest.mark.parametrize("visible, driver, want", [
        ("GPU-a,GPU-b", [], ["GPU-a", "GPU-b"]),        # UUIDs: as given
        ("3,5", ["GPU-c", "GPU-d"], ["GPU-c", "GPU-d"]),  # ordinals: the driver's UUIDs
        ("3,5", [], ["3", "5"]),                         # no driver to ask: as given
    ])
    def test_launcher_cuda_visible_devices(self, nodes, monkeypatch, visible, driver, want):
        monkeypatch.setenv(settings.ENV_CUDA_VISIBLE_DEVICES, visible)
        monkeypatch.setattr(lsched, "driver_gpu_count", lambda: 8)  # not read: the env wins
        monkeypatch.setattr(lsched, "driver_gpu_uuids", lambda: list(driver))
        assert gpu_device_request(2, 0, 1)["device_ids"] == want
        assert [gpu_device_request(1, rid, 2)["device_ids"] for rid in range(2)] == \
            [[w] for w in want]

    def test_no_source_globs_device_nodes(self):
        """No ``/dev/nvidia<N>`` glob decides a count anywhere in the port."""
        pkg = Path(__file__).resolve().parent.parent / "torchx_tpu_torch"
        found = [f"{p.relative_to(pkg)}:{i}" for p in sorted(pkg.rglob("*.py"))
                 for i, line in enumerate(p.read_text().splitlines(), 1)
                 if re.search(r"glob\(.*/dev/nvidia", line)]
        assert found == []


# -- parity with the JAX package --------------------------------------------


def _names(seed: int, n: int = 200) -> list[str]:
    rng = random.Random(seed)
    alphabet = string.ascii_letters + string.digits + "-_. /:éß" + "Ω"
    return ["".join(rng.choice(alphabet) for _ in range(rng.randint(0, 90))) for _ in range(n)]


class TestIdsParity:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_cleanup_and_sanitize(self, seed):
        for name in _names(seed):
            assert tids.cleanup(name) == jids.cleanup(name), name
            for max_len in (8, 20, 53, 63):
                assert tids.sanitize_name(name, max_len) == jids.sanitize_name(name, max_len)

    @pytest.mark.parametrize("seed", [5, 6])
    def test_make_unique_under_one_seed(self, seed):
        names = _names(seed, 20)
        random.seed(seed)
        ours = [tids.make_unique(n) for n in names]
        random.seed(seed)
        assert ours == [jids.make_unique(n) for n in names]


class TestTeeParity:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_stamped_bytes_equal_jax(self, tmp_path, monkeypatch, seed):
        """The same stdout/stderr bytes (complete lines, blank lines,
        non-UTF-8 bytes and a trailing partial line) through each
        package's Tee, under one clock: byte-equal combined logs."""
        rng = random.Random(seed)

        def blob() -> bytes:
            lines = [bytes(rng.randrange(256) for _ in range(rng.randint(0, 40))).replace(
                b"\n", b"") for _ in range(rng.randint(1, 30))]
            return b"\n".join(lines) + (b"\n" if rng.random() < 0.5 else b"")

        out, err = blob(), blob()
        monkeypatch.setattr(time, "time", lambda: 1760789012.3456)
        combined = {}
        for name, mod in (("jax", jstreams), ("port", tstreams)):
            d = tmp_path / name
            d.mkdir()
            (d / "stdout.log").write_bytes(out)
            (d / "stderr.log").write_bytes(err)
            tee = mod.Tee(d / "combined.log", d / "stdout.log", d / "stderr.log")
            tee.close()
            combined[name] = (d / "combined.log").read_bytes()
        assert combined["port"] == combined["jax"]
        assert combined["port"].startswith(b"1760789012.346 ")


@dataclass
class _TNested(StructuredOpts):
    context: str = "default-ctx"
    """kube context to use."""


@dataclass
class _TOpts(StructuredOpts):
    namespace: str = "default"
    """namespace to submit into."""
    replicas: int = 1
    """number of replicas."""
    queue: Optional[str] = None
    """queue name."""
    tags: list = field(default_factory=list)
    """labels, as a list."""
    limit: Optional[int] = None
    k8s: _TNested = field(default_factory=_TNested)


@dataclass
class _JNested(JStructuredOpts):
    context: str = "default-ctx"
    """kube context to use."""


@dataclass
class _JOpts(JStructuredOpts):
    namespace: str = "default"
    """namespace to submit into."""
    replicas: int = 1
    """number of replicas."""
    queue: Optional[str] = None
    """queue name."""
    tags: list = field(default_factory=list)
    """labels, as a list."""
    limit: Optional[int] = None
    k8s: _JNested = field(default_factory=_JNested)


def _opts_table(opts) -> list[tuple]:
    return [(k, o.opt_type, o.default, o.help, o.is_required) for k, o in opts]


class TestStructuredOptsParity:
    def test_runopts_equal_jax(self):
        ours, theirs = _TOpts.to_runopts(), _JOpts.to_runopts()
        assert _opts_table(ours) == _opts_table(theirs)
        assert repr(ours) == repr(theirs)

    @pytest.mark.parametrize("cfg", [
        {},
        {"namespace": "ml", "replicas": "3", "k8s.context": "prod"},
        {"queue": "q1", "tags": "a,b", "replicas": 2, "limit": 4},
    ])
    def test_from_cfg_equal_jax(self, cfg):
        ours = _TOpts.from_cfg(_TOpts.to_runopts().resolve(cfg))
        theirs = _JOpts.from_cfg(_JOpts.to_runopts().resolve(cfg))
        mine = dataclasses.asdict(ours)
        assert mine == dataclasses.asdict(theirs)
        assert ours.k8s.context == theirs.k8s.context


class TestApiParity:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_shell_and_log_line_helpers(self, seed):
        rng = random.Random(seed)
        alphabet = "ab $`\\\"'(){}|;&\n" + string.digits
        for _ in range(200):
            s = "".join(rng.choice(alphabet) for _ in range(rng.randint(0, 30)))
            assert tapi.dquote(s) == japi.dquote(s)
            assert tapi.split_lines(s) == japi.split_lines(s)
            stamped = f"{rng.uniform(1e9, 2e9):.3f} {s}"
            for line in (s, stamped, f"{rng.randint(0, 99)} retries left"):
                assert tapi.parse_epoch_stamp(line) == japi.parse_epoch_stamp(line)
            assert tapi.safe_int(s, -1) == japi.safe_int(s, -1)
        lines = [f"{1_700_000_000 + i:.3f} line{i}" for i in range(20)] + ["raw"]
        for since, until in ((None, None), (1_700_000_005, None), (None, 1_700_000_010),
                             (1_700_000_003, 1_700_000_004)):
            assert list(tapi.window_stamped_lines(lines, since, until)) == \
                list(japi.window_stamped_lines(lines, since, until))
        assert tapi.rfc3339(1_700_000_000.25) == japi.rfc3339(1_700_000_000.25)
        assert tapi.EPOCH_STAMPER == japi.EPOCH_STAMPER

    def test_capabilities_rename_only_the_accelerator(self):
        ours = {f.name for f in dataclasses.fields(tapi.SchedulerCapabilities)}
        theirs = {f.name for f in dataclasses.fields(japi.SchedulerCapabilities)}
        assert ours - theirs == {"requires_gpu"} and theirs - ours == {"requires_tpu"}
        assert dataclasses.asdict(lsched.CAPABILITIES) == {
            ("requires_gpu" if k == "requires_tpu" else k): v for k, v in
            dataclasses.asdict(jlocal.CAPABILITIES).items()}

    @pytest.mark.parametrize("num_replicas", [1, 2, 3])
    def test_gang_identity_equals_jax(self, num_replicas):
        """The same hosts a role (h100-16 and v5p-16 are both 2 hosts) and
        the same identity env a replica; the accelerator names are the
        port's own, and no DCN coordinator is wired."""
        jrole = jspecs.Role(name="w", image="", num_replicas=num_replicas,
                            resource=jspecs.Resource(tpu=jspecs.TpuSlice("v5p", 8)))
        trole = Role(name="w", image="", num_replicas=num_replicas,
                     resource=Resource(gpu=GpuSlice("h100", 16)))
        n = tapi.gpu_hosts_for_role(trole)
        assert n == japi.tpu_hosts_for_role(jrole) == 2 * num_replicas
        for rid in range(n):
            ours = tapi.role_replica_env(trole, rid, "h0", 29500)
            theirs = japi.role_replica_env(jrole, rid, "h0", 29500)
            jax_only = {k for k in theirs if k.startswith(("TPX_TPU_", "MEGASCALE_"))}
            assert {k: v for k, v in theirs.items() if k not in jax_only} == \
                {k: v for k, v in ours.items() if not k.startswith("TPX_GPU_")}
            assert ours[settings.ENV_TPX_GPU_ACCELERATOR_TYPE] == "h100-16"
            assert ours[settings.ENV_TPX_GPU_TOPOLOGY] == "2x8"
        cpu = Role(name="c", image="", num_replicas=3)
        assert tapi.gpu_hosts_for_role(cpu) == 3
        assert tapi.role_replica_env(cpu, 1, "h", 1) == japi.role_replica_env(
            jspecs.Role(name="c", image="", num_replicas=3), 1, "h", 1)


# -- acceptance: the CLI's dryrun of an H100 gang on every remote backend -----


def _two_hosts_of_eight(name: str, request: str) -> list[int]:
    """Cards a host for each host the printed request asks for."""
    import json

    if name == "slurm":
        groups = request.split("#SBATCH hetjob")
        assert all("#SBATCH --nodes=1\n" in g for g in groups)
        return [int(re.search(r"#SBATCH --gpus-per-node=(\d+)", g).group(1)) for g in groups]
    doc = json.loads(request)
    if name == "gke":
        (rj,) = doc["spec"]["replicatedJobs"]
        pod = rj["template"]["spec"]["template"]["spec"]
        assert pod["nodeSelector"]["cloud.google.com/gke-accelerator"] == "nvidia-h100-80gb"
        cards = pod["containers"][0]["resources"]["limits"]["nvidia.com/gpu"]
        return [cards] * (rj["replicas"] * rj["template"]["spec"]["parallelism"])
    if name == "local_docker":
        return [len(c["device_requests"][0]["device_ids"]) for c in doc]
    if name == "vertex":
        pools = doc["jobSpec"]["workerPoolSpecs"]
        assert {p["machineSpec"]["acceleratorType"] for p in pools} == {"NVIDIA_H100_80GB"}
        return [p["machineSpec"]["acceleratorCount"] for p in pools
                for _ in range(p["replicaCount"])]
    assert name == "gcp_batch"
    (group,) = doc["taskGroups"]
    (inst,) = doc["allocationPolicy"]["instances"]
    (accel,) = inst["policy"]["accelerators"]
    assert (accel["type"], inst["policy"]["machineType"]) == ("nvidia-h100-80gb", "a3-highgpu-8g")
    return [accel["count"]] * group["taskCount"]


class TestRemoteDryrunAcceptance:
    """``tpx-torch run --dryrun -s <backend> dist.spmd --gpu h100-16`` on
    every remote backend prints a request for two hosts of eight H100s (the
    docker host is given sixteen cards by its launcher's
    ``CUDA_VISIBLE_DEVICES``)."""

    @pytest.mark.parametrize("name", [n for n in ALL if n != "local"])
    def test_two_hosts_of_eight_h100s(self, name, monkeypatch):
        import io
        from contextlib import redirect_stdout

        from torchx_tpu_torch.cli.main import main as cli_main

        monkeypatch.setenv(settings.ENV_CUDA_VISIBLE_DEVICES, ",".join(_uuids(16)))
        cfg = ["-cfg", "project=p"] if name in ("vertex", "gcp_batch") else []
        out = io.StringIO()
        with redirect_stdout(out):
            cli_main(["run", "--dryrun", "--no-lint", "-s", name, *cfg, "dist.spmd",
                      "--gpu", "h100-16", "-m", "train"])
        request = out.getvalue().split("=== SCHEDULER REQUEST ===", 1)[1]
        assert _two_hosts_of_eight(name, request) == [8, 8]
        assert not [t for t in ("google.com/tpu", "gke-tpu-", "hightpu", "tpuTopology",
                                "MEGASCALE", "TPX_TPU_") if t in request]
