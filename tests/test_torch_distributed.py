"""The port's gang bootstrap against the JAX package's: the settings names,
``gang_info`` on a table of environments, the structured error file, and
``spmd_main`` running ``compute_mesh_size`` as 2 replicas of 1 worker and
as 1 replica of 2 workers (gloo on the CPU), a failing target's error
file, exit code and ended siblings.

Every gang here runs in a session of its own under a deadline, past which
it is killed with its workers.
"""

import json
import os
import time

import pytest
import torch.distributed as dist

import torch_gang_cases as gang
from torchx_tpu import distributed as jdist
from torchx_tpu import settings as jsettings
from torchx_tpu.specs.api import make_structured_error as j_structured_error
from torchx_tpu_torch import distributed as tdist
from torchx_tpu_torch import settings as tsettings
from torchx_tpu_torch.apps import spmd_main
from torchx_tpu_torch.examples import compute_mesh_size
from torch_threads import xdist_torch_threads  # noqa: F401

GANG_NAMES = (
    "ENV_TPX_APP_ID", "ENV_TPX_REPLICA_ID", "ENV_TPX_NUM_REPLICAS", "ENV_TPX_SLICE_ID",
    "ENV_TPX_HOST_ID", "ENV_TPX_HOSTS_PER_SLICE", "ENV_TPX_COORDINATOR_HOST",
    "TPX_COORDINATOR_PORT", "ENV_TPX_ERROR_FILE", "ENV_TPX_MESH", "ENV_TPX_TRACE_ID",
    "ENV_TPX_EXAMPLE_THROWS", "ENV_TPX_EXAMPLE_THROWS_REPLICA",
)
GANG_ENV = ("TPX_REPLICA_ID", "TPX_NUM_REPLICAS", "TPX_COORDINATOR_HOST", "TPX_SLICE_ID",
            "TPX_HOST_ID", "TPX_HOSTS_PER_SLICE", "TPX_APP_ID", "TPU_WORKER_ID",
            "TPU_WORKER_HOSTNAMES")


def test_settings_values_are_the_jax_packages():
    for name in GANG_NAMES:
        assert getattr(tsettings, name) == getattr(jsettings, name), name
    # the GKE TPU fallbacks are a TPU assumption the port does not copy
    assert not hasattr(tsettings, "ENV_TPU_WORKER_ID")
    assert not hasattr(tsettings, "ENV_TPU_WORKER_HOSTNAMES")


ENVS = [
    {},
    {"TPX_REPLICA_ID": "3", "TPX_NUM_REPLICAS": "4", "TPX_COORDINATOR_HOST": "host-0"},
    {"TPX_REPLICA_ID": "0", "TPX_NUM_REPLICAS": "1"},
    {"TPX_SLICE_ID": "1", "TPX_HOST_ID": "2", "TPX_HOSTS_PER_SLICE": "4",
     "TPX_NUM_REPLICAS": "8", "TPX_COORDINATOR_HOST": "h"},
    {"TPX_SLICE_ID": "1", "TPX_HOST_ID": "2", "TPX_NUM_REPLICAS": "8"},  # incomplete
    {"TPX_REPLICA_ID": "5", "TPX_SLICE_ID": "1", "TPX_HOST_ID": "0",
     "TPX_HOSTS_PER_SLICE": "4", "TPX_NUM_REPLICAS": "8"},  # the global id wins
    {"TPX_NUM_REPLICAS": "", "TPX_COORDINATOR_HOST": ""},
    {"TPX_APP_ID": "app-1", "TPX_REPLICA_ID": "1", "TPX_NUM_REPLICAS": "2"},
]


def _set_env(monkeypatch, env):
    for k in GANG_ENV:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)


@pytest.mark.parametrize("env", ENVS, ids=range(len(ENVS)))
def test_gang_info_matches_jax(monkeypatch, env):
    _set_env(monkeypatch, env)
    assert tdist.gang_info() == jdist.gang_info()
    assert tdist.replica_id() == jdist.replica_id()
    assert tdist.num_replicas() == jdist.num_replicas()
    assert tdist.is_tpx_job() == jdist.is_tpx_job()
    for port in (None, 1234):
        assert tdist.coordinator_address(port) == jdist.coordinator_address(port)


@pytest.mark.parametrize("env", [
    {"TPU_WORKER_ID": "2", "TPU_WORKER_HOSTNAMES": "a,b,c"},
    {"TPU_WORKER_ID": "1"},
])
def test_gke_tpu_fallbacks_are_not_read(monkeypatch, env):
    """The stated divergence: without the launcher's variables the JAX
    package falls back to GKE's TPU_WORKER_*; the port does not."""
    _set_env(monkeypatch, env)
    assert tdist.gang_info() == (0, 1, "localhost")
    assert jdist.gang_info() != tdist.gang_info()


def test_world_layout(monkeypatch):
    _set_env(monkeypatch, {"TPX_REPLICA_ID": "2", "TPX_NUM_REPLICAS": "3"})
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    assert tdist.world_layout() == (2 * 4 + 1, 3 * 4)
    assert tdist.local_device_count() == 4


def test_init_from_env_is_idempotent_at_world_one(monkeypatch):
    _set_env(monkeypatch, {})
    assert tdist.default_backend() == "gloo"  # no card here
    assert tdist.is_process_zero() and tdist.world_device_count() == 1
    tdist.init_from_env()
    try:
        tdist.init_from_env()  # a no-op on a group that is up
        assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
        assert tdist.is_process_zero()
        seen = []
        with tdist.on_process_zero_first():
            seen.append(1)
        assert seen == [1]
    finally:
        dist.destroy_process_group()


def test_structured_error_is_the_jax_packages():
    a = json.loads(spmd_main.make_structured_error("boom", exitcode=3, hostname="h"))
    b = json.loads(j_structured_error("boom", exitcode=3, hostname="h"))
    for d in (a, b):
        d["message"]["extraInfo"].pop("timestamp")
    assert a == b


def _gang_env(replica, n):
    return {"TPX_REPLICA_ID": str(replica), "TPX_NUM_REPLICAS": str(n),
            "TPX_COORDINATOR_HOST": "127.0.0.1"}


PROBE = ["--timeout", "60", "-m", "torchx_tpu_torch.examples.compute_mesh_size"]


def test_spmd_main_two_replicas_of_one_worker():
    def launch(port):
        return [gang.start(["--nproc-per-node", "1", "--port", str(port), *PROBE],
                           _gang_env(r, 2)) for r in range(2)]

    for rc, out, err in gang.finish_replicas(launch, timeout=120):
        assert rc == 0, err[-2000:]
        assert "computed_mesh_size=2" in out and "global_devices=2" in out


def test_spmd_main_one_replica_of_two_workers():
    (rc, out, err), = gang.finish(
        [gang.start(["--nproc-per-node", "2", "--port", "0", *PROBE])], timeout=120)
    assert rc == 0, err[-2000:]
    assert out.count("computed_mesh_size=2") == 2
    assert "process=0/2" in out and "process=1/2" in out


FAILING = """
import os, sys, time
import torch.distributed as dist
rank = dist.get_rank()
with open(os.path.join(sys.argv[1], f"pid{rank}"), "w") as f:
    f.write(str(os.getpid()))
if rank == 1:
    time.sleep(1)
    raise ValueError("rank 1 fails")
time.sleep(600)  # rank 0 would outlive the run: its parent must end it
"""


def _alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


def test_a_failing_worker_ends_the_gang(tmp_path):
    script = tmp_path / "fail.py"
    script.write_text(FAILING)
    err_file = tmp_path / "err" / "error.json"
    t0 = time.monotonic()
    (rc, out, err), = gang.finish([gang.start(
        ["--nproc-per-node", "2", "--port", "0", "--timeout", "60",
         "--script", str(script), "--", str(tmp_path)],
        {"TPX_ERROR_FILE": str(err_file)})], timeout=120)
    assert rc not in (0, None), err[-2000:]
    assert time.monotonic() - t0 < 60  # rank 0 was ended, not waited for
    payload = json.loads(err_file.read_text())
    assert set(payload) == {"message", "exitcode", "hostname"}
    assert set(payload["message"]) == {"message", "extraInfo"}
    assert "ValueError: rank 1 fails" in payload["message"]["message"]
    assert payload["exitcode"] == 1
    assert sorted(os.listdir(err_file.parent)) == ["error.json"]  # per-worker files gone
    pids = [int((tmp_path / f"pid{r}").read_text()) for r in range(2)]
    assert not any(_alive(p) for p in pids)


NOTICE = """
import os, signal, sys, time
import torch.distributed as dist
rank = dist.get_rank()
def on_term(signum, frame):
    open(os.path.join(sys.argv[1], f"notice{rank}"), "w").close()
    sys.exit(0)
signal.signal(signal.SIGTERM, on_term)
open(os.path.join(sys.argv[1], f"ready{rank}"), "w").close()
time.sleep(600)
"""


def test_sigterm_is_forwarded_to_every_worker(tmp_path):
    """The launcher's preemption notice reaches each worker, whose handler
    exits cleanly; the gang then exits 0."""
    import signal

    script = tmp_path / "notice.py"
    script.write_text(NOTICE)
    proc = gang.start(["--nproc-per-node", "2", "--port", "0",
                       "--timeout", "60", "--script", str(script), "--", str(tmp_path)])
    deadline = time.monotonic() + 60
    while not all((tmp_path / f"ready{r}").exists() for r in range(2)):
        assert time.monotonic() < deadline and proc.poll() is None, proc.communicate()
        time.sleep(0.1)
    proc.send_signal(signal.SIGTERM)
    (rc, out, err), = gang.finish([proc], timeout=60)
    assert rc == 0, err[-2000:]
    assert all((tmp_path / f"notice{r}").exists() for r in range(2))


def test_a_failing_single_worker_writes_the_error_file(tmp_path):
    err_file = tmp_path / "error.json"
    (rc, out, err), = gang.finish([gang.start(
        ["--nproc-per-node", "1", *PROBE],
        {"TPX_ERROR_FILE": str(err_file), "TPX_EXAMPLE_THROWS": "1"})], timeout=120)
    assert rc == 1
    assert "injected failure" in json.loads(err_file.read_text())["message"]["message"]


def test_the_fault_hook_once(tmp_path, monkeypatch):
    marker = tmp_path / "marker"
    monkeypatch.setenv("TPX_EXAMPLE_THROWS", f"once:{marker}")
    with pytest.raises(RuntimeError, match="injected failure"):
        compute_mesh_size.maybe_inject_fault()
    compute_mesh_size.maybe_inject_fault()  # the second attempt passes
    monkeypatch.setenv("TPX_EXAMPLE_THROWS", "1")
    monkeypatch.setenv("TPX_EXAMPLE_THROWS_REPLICA", "7")
    compute_mesh_size.maybe_inject_fault()  # scoped to another replica


def test_compute_mesh_size_alone_is_a_world_of_one(capsys, monkeypatch):
    _set_env(monkeypatch, {})
    try:
        assert compute_mesh_size.compute_mesh_size() == 1
    finally:
        dist.destroy_process_group()
    assert "computed_mesh_size=1" in capsys.readouterr().out


def test_spmd_main_on_the_cpu_needs_a_worker_count():
    (rc, out, err), = gang.finish([gang.start(PROBE)], timeout=120)
    assert rc == 2 and "--nproc-per-node" in err


def test_port_zero_workers_join_the_replicas_own_store(tmp_path):
    """``--port 0`` at one replica of two workers: the replica binds the
    store itself and hands its port to its workers, which join it as
    clients; the port it names is not the default one."""
    probe = tmp_path / "probe.py"
    probe.write_text("import os, sys, torch.distributed as dist\n"
                     f"port = os.environ[{tdist.ENV_STORE_PORT!r}]\n"
                     "sys.stdout.write(f'store_port {port} {dist.get_rank()} "  # one write a line
                     "{dist.get_world_size()}\\n')\n")
    (rc, out, err), = gang.finish([gang.start(
        ["--nproc-per-node", "2", "--port", "0", "--timeout", "60", "--script", str(probe)],
        {tdist.ENV_STORE_PORT: "1"})], timeout=120)  # an inherited port is never used
    assert rc == 0, err[-2000:]
    lines = sorted(line.split()[1:] for line in out.splitlines() if line.startswith("store_port"))
    assert [rank for _, rank, _ in lines] == ["0", "1"] and {w for *_, w in lines} == {"2"}
    port = {p for p, _, _ in lines}
    assert len(port) == 1 and port != {"1"} and port != {str(tsettings.TPX_COORDINATOR_PORT)}


def test_port_zero_is_refused_with_two_replicas():
    """Other hosts could not find a port that replica 0 picked: ``--port
    0`` with ``TPX_NUM_REPLICAS`` above 1 exits 2 with a message."""
    (rc, out, err), = gang.finish(
        [gang.start(["--nproc-per-node", "1", "--port", "0", *PROBE], _gang_env(0, 2))],
        timeout=60)
    assert rc == 2 and "--port 0 takes a gang of one replica (2 here)" in err
