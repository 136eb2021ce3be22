"""The port's local scheduler (``torchx_tpu_torch.schedulers.local_scheduler``)
against real subprocesses: every case of ``tests/test_local_scheduler.py``
run against the copy, its TPU slices written as H100 slices
(``GpuSlice``), its ``tpu_device_env`` cases as ``gpu_device_env`` cases
(partition, no partition, over-subscription, no card refused, no card with
``gpu_simulate``); and the copy held to the JAX package's scheduler on the
same inputs: the materialized request of one app, and the watch stream of
one real job. This host has no card, so a GPU role here passes
``gpu_simulate=True``. Every case keeps its registry under ``tmp_path``."""

import os
import random
import tempfile
import threading
import time
from pathlib import Path

import pytest

from torchx_tpu.schedulers import local_scheduler as jlocal
from torchx_tpu.specs import api as japi
from torchx_tpu_torch import settings
from torchx_tpu_torch.schedulers.api import Stream
from torchx_tpu_torch.schedulers import local_scheduler as lsched
from torchx_tpu_torch.schedulers.local_scheduler import (
    CWDImageProvider,
    LocalDirectoryImageProvider,
    LocalScheduler,
    gpu_device_env,
)
from torchx_tpu_torch.specs import api as tapi
from torchx_tpu_torch.specs.api import (
    AppDef,
    AppState,
    GpuSlice,
    Resource,
    Role,
    macros,
)
from torch_threads import xdist_torch_threads  # noqa: F401

#: a GPU role on this card-less host runs only when asked
SIM = {"gpu_simulate": True}
#: the driver count itself (every case below sees a card-less host)
DRIVER_GPU_COUNT = lsched.driver_gpu_count


@pytest.fixture(autouse=True)
def _registry(tmp_path, monkeypatch):
    """The per-user app registry of every case lives in ``tmp_path``, and
    the host has no card whatever the environment says (a case that wants
    cards sets ``CUDA_VISIBLE_DEVICES`` itself)."""
    monkeypatch.setattr(lsched, "_registry_path", lambda: str(tmp_path / "registry"))
    monkeypatch.setattr(jlocal, "_registry_path", lambda: str(tmp_path / "jax-registry"))
    monkeypatch.delenv(settings.ENV_CUDA_VISIBLE_DEVICES, raising=False)
    monkeypatch.setattr(lsched, "driver_gpu_count", lambda: 0)


@pytest.fixture
def sched():
    s = LocalScheduler(session_name="test", cache_size=10)
    yield s
    s.close()


def sh_role(name: str, script: str, num_replicas: int = 1, **kwargs) -> Role:
    return Role(
        name=name,
        image="",
        entrypoint="sh",
        args=["-c", script],
        num_replicas=num_replicas,
        **kwargs,
    )


def wait_terminal(sched: LocalScheduler, app_id: str, timeout: float = 30) -> AppState:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        desc = sched.describe(app_id)
        assert desc is not None
        if desc.state in (AppState.SUCCEEDED, AppState.FAILED, AppState.CANCELLED):
            return desc.state
        time.sleep(0.05)
    raise TimeoutError(f"app {app_id} did not finish")


class TestElasticRestart:
    """Elastic gangs (min_replicas) shrink-and-restart on replica death,
    resuming from the app's own checkpoint with a resized world
    (BASELINE config 4: elastic min/max rendezvous under preemption)."""

    def elastic_script(self, ckpt_dir: str) -> str:
        # replica 2 "is preempted" (exit 1) before the checkpoint reaches
        # step 5; after the elastic restart the world is smaller, replica 2
        # no longer exists, and survivors resume from the checkpoint.
        # Replica 2 writes step 5 only once replica 0 has read its start,
        # and replica 0 writes step 10 only on the attempt that resumed
        # (start >= 5): a first attempt that the scheduler has not ended
        # yet never leaves the restart a later checkpoint to read
        return (
            f"CK={ckpt_dir}/progress; start=0; "
            '[ -f "$CK" ] && start=$(cat "$CK"); '
            '[ "$TPX_REPLICA_ID" = "0" ] && touch "$CK.read0"; '
            'if [ "$TPX_REPLICA_ID" = "2" ] && [ "$start" -lt 5 ]; then '
            'while [ ! -f "$CK.read0" ]; do sleep 0.01; done; '
            'echo 5 > "$CK"; exit 1; fi; '
            'echo "world=$TPX_NUM_REPLICAS start=$start"; '
            "sleep 0.5; "
            '[ "$TPX_REPLICA_ID" = "0" ] && [ "$start" -ge 5 ] && echo 10 > "$CK"; exit 0'
        )

    def test_shrink_restart_resumes_from_checkpoint(self, sched, tmp_path):
        ckpt = tmp_path / "ckpt"
        ckpt.mkdir()
        app = AppDef(
            name="elastic",
            roles=[
                sh_role(
                    "w",
                    self.elastic_script(str(ckpt)),
                    num_replicas=3,
                    min_replicas=1,
                    max_retries=2,
                )
            ],
        )
        app_id = sched.submit(app, {"log_dir": str(tmp_path)})
        assert wait_terminal(sched, app_id, timeout=30) == AppState.SUCCEEDED
        desc = sched.describe(app_id)
        assert desc.num_restarts == 1
        # the relaunched gang is 2 wide and resumed from the checkpoint
        out0 = (tmp_path / app_id / "w" / "0" / "stdout.log").read_text()
        assert "world=2 start=5" in out0
        # attempt-0 logs were rotated aside, not clobbered
        assert (tmp_path / app_id / "w" / "0" / "stdout.log.0").exists()
        # only 2 replicas in the final gang
        (rs,) = desc.roles_statuses
        assert len(rs.replicas) == 2
        assert (ckpt / "progress").read_text().strip() == "10"

    def test_no_restart_below_min(self, sched, tmp_path):
        ckpt = tmp_path / "ckpt"
        ckpt.mkdir()
        app = AppDef(
            name="floor",
            roles=[
                sh_role(
                    "w",
                    self.elastic_script(str(ckpt)),
                    num_replicas=3,
                    min_replicas=3,  # can't shrink below the floor
                    max_retries=2,
                )
            ],
        )
        app_id = sched.submit(app, {"log_dir": str(tmp_path)})
        assert wait_terminal(sched, app_id, timeout=30) == AppState.FAILED
        assert sched.describe(app_id).num_restarts == 0

    def test_rigid_gang_restarts_full_size(self, sched, tmp_path):
        """No min_replicas, but max_retries with the default APPLICATION
        retry policy: the gang restarts at FULL size (the local analog of
        JobSet maxRestarts / slurm requeue)."""
        ckpt = tmp_path / "ckpt"
        ckpt.mkdir()
        app = AppDef(
            name="rigid",
            roles=[
                sh_role(
                    "w",
                    self.elastic_script(str(ckpt)),
                    num_replicas=3,
                    max_retries=2,
                )
            ],
        )
        app_id = sched.submit(app, {"log_dir": str(tmp_path)})
        assert wait_terminal(sched, app_id, timeout=30) == AppState.SUCCEEDED
        desc = sched.describe(app_id)
        assert desc.num_restarts == 1
        (rs,) = desc.roles_statuses
        assert len(rs.replicas) == 3  # full size, not shrunk
        out0 = (tmp_path / app_id / "w" / "0" / "stdout.log").read_text()
        assert "world=3 start=5" in out0  # resumed from checkpoint

    def test_rigid_gang_fatal_without_retries(self, sched, tmp_path):
        ckpt = tmp_path / "ckpt"
        ckpt.mkdir()
        app = AppDef(
            name="rigid0",
            roles=[
                sh_role(
                    "w",
                    self.elastic_script(str(ckpt)),
                    num_replicas=3,  # max_retries defaults to 0
                )
            ],
        )
        app_id = sched.submit(app, {"log_dir": str(tmp_path)})
        assert wait_terminal(sched, app_id, timeout=30) == AppState.FAILED
        assert sched.describe(app_id).num_restarts == 0

    def test_replica_retry_policy_is_fatal_for_gang(self, sched, tmp_path):
        from torchx_tpu_torch.specs.api import RetryPolicy

        ckpt = tmp_path / "ckpt"
        ckpt.mkdir()
        app = AppDef(
            name="rep",
            roles=[
                sh_role(
                    "w",
                    self.elastic_script(str(ckpt)),
                    num_replicas=3,
                    max_retries=2,
                    retry_policy=RetryPolicy.REPLICA,
                )
            ],
        )
        app_id = sched.submit(app, {"log_dir": str(tmp_path)})
        assert wait_terminal(sched, app_id, timeout=30) == AppState.FAILED

    def test_gpu_gang_shrinks_whole_slices(self, sched, tmp_path):
        """A GPU gang (2 slices of h100-16, 2 hosts each) losing one host
        must shrink to ONE whole slice (2 hosts), not 3 — and the relaunched
        world's env must be internally consistent (no stale multi-slice
        identity)."""
        script = (
            'if [ "$TPX_REPLICA_ID" = "3" ] && [ ! -f %s/died ]; then '
            "touch %s/died; exit 1; fi; "
            'echo "world=$TPX_NUM_REPLICAS per_slice=${TPX_HOSTS_PER_SLICE:-none}'
            ' slice=${TPX_SLICE_ID:-none} type=$TPX_GPU_ACCELERATOR_TYPE"; sleep 0.5; exit 0'
        ) % (tmp_path, tmp_path)
        role = Role(
            name="w",
            image="",
            entrypoint="sh",
            args=["-c", script],
            num_replicas=2,  # slices
            min_replicas=1,
            max_retries=2,
            resource=Resource(cpu=1, memMB=256, gpu=GpuSlice("h100", 16)),
        )
        app_id = sched.submit(AppDef(name="gpu-elastic", roles=[role]),
                              {"log_dir": str(tmp_path), **SIM})
        assert wait_terminal(sched, app_id, timeout=30) == AppState.SUCCEEDED
        desc = sched.describe(app_id)
        assert desc.num_restarts == 1
        (rs,) = desc.roles_statuses
        assert len(rs.replicas) == 2  # one whole slice, not 3 hosts
        out0 = (tmp_path / app_id / "w" / "0" / "stdout.log").read_text()
        assert "world=2 per_slice=none slice=none type=h100-16" in out0

    def test_role_scoped_restart_keeps_healthy_roles_running(self, sched, tmp_path):
        """RetryPolicy.ROLE: only the failed role relaunches; the healthy
        role's processes are left untouched (same pid across the restart)."""
        from torchx_tpu_torch.specs.api import RetryPolicy

        flaky = (
            f"if [ ! -f {tmp_path}/fired ]; then touch {tmp_path}/fired;"
            ' exit 1; fi; echo "recovered"; exit 0'
        )
        steady = f'echo "pid=$$" >> {tmp_path}/steady.pids; sleep 3; exit 0'
        app = AppDef(
            name="rolescope",
            roles=[
                sh_role(
                    "flaky", flaky, num_replicas=1, max_retries=1,
                    retry_policy=RetryPolicy.ROLE,
                ),
                sh_role("steady", steady, num_replicas=1),
            ],
        )
        app_id = sched.submit(app, {"log_dir": str(tmp_path)})
        assert wait_terminal(sched, app_id, timeout=30) == AppState.SUCCEEDED
        assert sched.describe(app_id).num_restarts == 1
        # the steady role ran exactly once — it was never killed/relaunched
        pids = (tmp_path / "steady.pids").read_text().strip().splitlines()
        assert len(pids) == 1
        # only the flaky role's logs were rotated
        assert (tmp_path / app_id / "flaky" / "0" / "stdout.log.0").exists()
        assert not (tmp_path / app_id / "steady" / "0" / "stdout.log.0").exists()

    def test_per_role_budget_not_pooled(self, sched, tmp_path):
        """A role's own max_retries bounds ITS restarts even when another
        role in the app carries a bigger budget."""
        always_fails = 'exit 1'
        app = AppDef(
            name="pooled",
            roles=[
                sh_role("a", always_fails, num_replicas=1, max_retries=1),
                sh_role("b", "sleep 5", num_replicas=1, max_retries=3),
            ],
        )
        app_id = sched.submit(app, {"log_dir": str(tmp_path)})
        assert wait_terminal(sched, app_id, timeout=30) == AppState.FAILED
        # role a restarted once (its budget), NOT three times (b's budget)
        assert sched.describe(app_id).num_restarts == 1

    def test_budgets_are_per_role_both_directions(self, sched, tmp_path):
        """Role A's restart must not consume role B's budget: after A
        restarts once (its budget), B's FIRST failure still gets B's own
        retry. Both roles are ROLE-scoped with max_retries=1."""
        from torchx_tpu_torch.specs.api import RetryPolicy

        a = (
            f"if [ ! -f {tmp_path}/a-fired ]; then touch {tmp_path}/a-fired;"
            " exit 1; fi; exit 0"
        )
        # b fails AFTER a recovered (ordering via marker file), once
        b = (
            f"while [ ! -f {tmp_path}/a-fired ]; do sleep 0.1; done; "
            f"if [ ! -f {tmp_path}/b-fired ]; then sleep 0.5;"
            f" touch {tmp_path}/b-fired; exit 1; fi; exit 0"
        )
        app = AppDef(
            name="two-budgets",
            roles=[
                sh_role("a", a, num_replicas=1, max_retries=1,
                        retry_policy=RetryPolicy.ROLE),
                sh_role("b", b, num_replicas=1, max_retries=1,
                        retry_policy=RetryPolicy.ROLE),
            ],
        )
        app_id = sched.submit(app, {"log_dir": str(tmp_path)})
        assert wait_terminal(sched, app_id, timeout=30) == AppState.SUCCEEDED
        # each role consumed exactly its own single retry
        assert sched.describe(app_id).num_restarts == 2

    def test_restart_budget_exhausted(self, sched, tmp_path):
        # every attempt fails (replica 0 always dies) -> FAILED after
        # max_retries restarts
        app = AppDef(
            name="burn",
            roles=[
                sh_role(
                    "w",
                    'if [ "$TPX_REPLICA_ID" = "0" ]; then exit 1; fi; sleep 20',
                    num_replicas=3,
                    min_replicas=1,
                    max_retries=1,
                )
            ],
        )
        app_id = sched.submit(app, {"log_dir": str(tmp_path)})
        assert wait_terminal(sched, app_id, timeout=30) == AppState.FAILED
        assert sched.describe(app_id).num_restarts == 1


class TestLocalScheduler:
    def test_submit_success(self, sched, tmp_path):
        app = AppDef(name="ok", roles=[sh_role("r", "echo hello")])
        app_id = sched.submit(app, {"log_dir": str(tmp_path)})
        assert wait_terminal(sched, app_id) == AppState.SUCCEEDED
        out = tmp_path / app_id / "r" / "0" / "stdout.log"
        assert out.read_text().strip() == "hello"
        # SUCCESS marker written
        assert (tmp_path / app_id / "SUCCESS").exists()

    def test_submit_failure_kills_gang(self, sched, tmp_path):
        app = AppDef(
            name="fail",
            roles=[
                sh_role("bad", "exit 3"),
                sh_role("slow", "sleep 30"),
            ],
        )
        app_id = sched.submit(app, {"log_dir": str(tmp_path)})
        state = wait_terminal(sched, app_id, timeout=20)
        assert state == AppState.FAILED
        # gang fail-fast: the sleeper must not still be running
        desc = sched.describe(app_id)
        slow = [rs for rs in desc.roles_statuses if rs.role == "slow"][0]
        assert all(r.state != AppState.RUNNING for r in slow.replicas)

    def test_macro_substitution(self, sched, tmp_path):
        app = AppDef(
            name="macro",
            roles=[
                sh_role(
                    "m",
                    f"echo replica={macros.replica_id} app={macros.app_id}",
                    num_replicas=2,
                )
            ],
        )
        app_id = sched.submit(app, {"log_dir": str(tmp_path)})
        wait_terminal(sched, app_id)
        out0 = (tmp_path / app_id / "m" / "0" / "stdout.log").read_text()
        out1 = (tmp_path / app_id / "m" / "1" / "stdout.log").read_text()
        assert f"replica=0 app={app_id}" in out0
        assert f"replica=1 app={app_id}" in out1

    def test_gang_env_injection(self, sched, tmp_path):
        app = AppDef(
            name="env",
            roles=[sh_role("e", "echo $TPX_REPLICA_ID/$TPX_NUM_REPLICAS-$TPX_COORDINATOR_HOST", num_replicas=2)],
        )
        app_id = sched.submit(app, {"log_dir": str(tmp_path)})
        wait_terminal(sched, app_id)
        assert (tmp_path / app_id / "e" / "1" / "stdout.log").read_text().strip() == (
            "1/2-localhost"
        )

    def test_gpu_role_expands_to_hosts(self, sched, tmp_path):
        # h100-32 = 32 cards = 4 hosts of 8 -> 4 replicas
        role = sh_role("t", "echo $TPX_NUM_REPLICAS")
        role.resource = Resource(cpu=1, memMB=512, gpu=GpuSlice("h100", 32))
        app = AppDef(name="gpu", roles=[role])
        info = sched.submit_dryrun(app, {"log_dir": str(tmp_path), **SIM})
        assert len(info.request.role_params["t"]) == 4
        env = info.request.role_params["t"][0].env
        assert env["TPX_NUM_REPLICAS"] == "4"
        assert env["TPX_GPU_ACCELERATOR_TYPE"] == "h100-32"
        assert env["TPX_GPU_TOPOLOGY"] == "4x8"
        # no local card here: asked for, the replica sees none
        assert env["CUDA_VISIBLE_DEVICES"] == ""
        # not asked for, the role is refused at dryrun, naming the opt
        with pytest.raises(ValueError, match="gpu_simulate"):
            sched.submit_dryrun(app, {"log_dir": str(tmp_path)})

    def test_multislice_env(self, sched, tmp_path):
        role = sh_role("t", "true")
        role.resource = Resource(cpu=1, memMB=512, gpu=GpuSlice("h100", 8))
        role.num_replicas = 2  # 2 slices x 1 host
        app = AppDef(name="ms", roles=[role])
        info = sched.submit_dryrun(app, {"log_dir": str(tmp_path), **SIM})
        params = info.request.role_params["t"]
        assert len(params) == 2
        assert [p.env["TPX_SLICE_ID"] for p in params] == ["0", "1"]
        assert [p.env["TPX_HOST_ID"] for p in params] == ["0", "0"]
        assert params[0].env["TPX_HOSTS_PER_SLICE"] == "1"
        # one process group across slices: no DCN coordinator wiring
        assert not any(k.startswith("MEGASCALE_") and k not in os.environ
                       for p in params for k in p.env)

    def test_cancel(self, sched, tmp_path):
        app = AppDef(name="c", roles=[sh_role("s", "sleep 60")])
        app_id = sched.submit(app, {"log_dir": str(tmp_path)})
        time.sleep(0.2)
        sched.cancel(app_id)
        assert wait_terminal(sched, app_id) == AppState.CANCELLED

    def test_error_file_surfaced(self, sched, tmp_path):
        script = (
            'mkdir -p "$(dirname $TPX_ERROR_FILE)"; '
            'echo \'{"message": {"message": "kaboom", "extraInfo": {}}, "exitcode": 5, "hostname": "h"}\' > $TPX_ERROR_FILE; '
            "exit 5"
        )
        app = AppDef(name="err", roles=[sh_role("e", script)])
        app_id = sched.submit(app, {"log_dir": str(tmp_path)})
        assert wait_terminal(sched, app_id) == AppState.FAILED
        desc = sched.describe(app_id)
        assert "kaboom" in desc.structured_error_msg

    def test_log_iter(self, sched, tmp_path):
        app = AppDef(name="logs", roles=[sh_role("l", "echo a; echo b; echo c")])
        app_id = sched.submit(app, {"log_dir": str(tmp_path)})
        wait_terminal(sched, app_id)
        lines = list(sched.log_iter(app_id, "l", 0, streams=Stream.STDOUT))
        assert lines == ["a", "b", "c"]

    def test_log_iter_tail(self, sched, tmp_path):
        app = AppDef(
            name="tail", roles=[sh_role("t", "echo first; sleep 0.8; echo last")]
        )
        app_id = sched.submit(app, {"log_dir": str(tmp_path)})
        lines = list(
            sched.log_iter(app_id, "t", 0, should_tail=True, streams=Stream.STDOUT)
        )
        assert lines == ["first", "last"]

    def test_log_iter_regex(self, sched, tmp_path):
        app = AppDef(name="re", roles=[sh_role("r", "echo keep; echo drop")])
        app_id = sched.submit(app, {"log_dir": str(tmp_path)})
        wait_terminal(sched, app_id)
        lines = list(
            sched.log_iter(app_id, "r", 0, regex="keep", streams=Stream.STDOUT)
        )
        assert lines == ["keep"]

    def test_list(self, sched, tmp_path):
        app = AppDef(name="lst", roles=[sh_role("x", "true")])
        app_id = sched.submit(app, {"log_dir": str(tmp_path)})
        wait_terminal(sched, app_id)
        listing = sched.list()
        assert any(a.app_id == app_id for a in listing)

    def test_lru_eviction(self, tmp_path):
        sched = LocalScheduler(session_name="lru", cache_size=2)
        try:
            ids = []
            for i in range(3):
                app = AppDef(name=f"a{i}", roles=[sh_role("r", "true")])
                app_id = sched.submit(app, {"log_dir": str(tmp_path)})
                wait_terminal(sched, app_id)
                ids.append(app_id)
            # evicted from the in-process cache, but still describable via
            # the on-disk state file (terminal state is authoritative)
            evicted = sched.describe(ids[0])
            assert evicted is not None and evicted.state == AppState.SUCCEEDED
            assert sched.describe(ids[2]) is not None
        finally:
            sched.close()

    def test_combined_stream(self, sched, tmp_path):
        app = AppDef(name="comb", roles=[sh_role("c", "echo out; echo err 1>&2")])
        app_id = sched.submit(app, {"log_dir": str(tmp_path)})
        wait_terminal(sched, app_id)
        time.sleep(0.3)  # allow tee to drain
        combined = (tmp_path / app_id / "c" / "0" / "combined.log").read_text()
        assert "out" in combined and "err" in combined
        # every tee'd line leads with an epoch stamp (what log windows use)
        from torchx_tpu_torch.schedulers.api import parse_epoch_stamp

        for raw in combined.splitlines():
            ts, payload = parse_epoch_stamp(raw)
            assert ts is not None and payload in ("out", "err")

    def test_log_windows_on_combined(self, sched, tmp_path):
        app = AppDef(name="win", roles=[sh_role("w", "echo early; echo late")])
        app_id = sched.submit(app, {"log_dir": str(tmp_path)})
        wait_terminal(sched, app_id)
        time.sleep(0.3)  # allow tee to drain
        now = time.time()
        # stamps are stripped from the default (combined) stream
        lines = list(sched.log_iter(app_id, "w", 0))
        assert lines == ["early", "late"]
        # a window entirely in the past excludes everything
        assert list(sched.log_iter(app_id, "w", 0, until=now - 3600)) == []
        # a window entirely in the future excludes everything
        assert list(sched.log_iter(app_id, "w", 0, since=now + 3600)) == []
        # a window spanning now includes everything
        assert (
            list(sched.log_iter(app_id, "w", 0, since=now - 3600, until=now + 60))
            == ["early", "late"]
        )

    def test_dir_image_provider(self, tmp_path):
        img = tmp_path / "img"
        img.mkdir()
        (img / "hello.sh").write_text("#!/bin/sh\necho from-image\n")
        os.chmod(img / "hello.sh", 0o755)
        sched = LocalScheduler(
            session_name="dir", image_provider=LocalDirectoryImageProvider()
        )
        try:
            app = AppDef(
                name="img",
                roles=[
                    Role(name="r", image=str(img), entrypoint="hello.sh", args=[])
                ],
            )
            app_id = sched.submit(app, {"log_dir": str(tmp_path / "logs")})
            assert wait_terminal(sched, app_id) == AppState.SUCCEEDED
            out = tmp_path / "logs" / app_id / "r" / "0" / "stdout.log"
            assert out.read_text().strip() == "from-image"
        finally:
            sched.close()

    def test_dir_image_provider_rejects_missing(self):
        with pytest.raises(ValueError):
            LocalDirectoryImageProvider().fetch("/definitely/not/a/dir")


class TestCrossProcessState:
    def test_second_scheduler_reads_terminal_state(self, tmp_path, monkeypatch):
        monkeypatch.setattr(
            "torchx_tpu_torch.schedulers.local_scheduler._registry_path",
            lambda: str(tmp_path / "registry"),
        )
        owner = LocalScheduler(session_name="owner")
        try:
            app = AppDef(name="xp", roles=[sh_role("r", "echo cross-process")])
            app_id = owner.submit(app, {"log_dir": str(tmp_path)})
            wait_terminal(owner, app_id)
        finally:
            owner.close()
        # a different scheduler instance (≈ another CLI process)
        other = LocalScheduler(session_name="other")
        try:
            desc = other.describe(app_id)
            assert desc is not None and desc.state == AppState.SUCCEEDED
            lines = list(other.log_iter(app_id, "r", 0, streams=Stream.STDOUT))
            assert lines == ["cross-process"]
        finally:
            other.close()

    def test_orphaned_running_state_reports_unknown(self, tmp_path, monkeypatch):
        import json

        monkeypatch.setattr(
            "torchx_tpu_torch.schedulers.local_scheduler._registry_path",
            lambda: str(tmp_path / "registry"),
        )
        # forge a state file whose owner died mid-run (pid 1 is not ours;
        # use an impossible pid)
        log_dir = tmp_path / "ghost-app"
        log_dir.mkdir()
        (log_dir / ".tpx_state.json").write_text(
            json.dumps(
                {
                    "app_id": "ghost-app",
                    "state": "RUNNING",
                    "log_dir": str(log_dir),
                    "roles": {"r": [{"id": 0, "pid": 2**22 + 12345}]},
                }
            )
        )
        (tmp_path / "registry").write_text(f"ghost-app = {log_dir}\n")
        sched = LocalScheduler(session_name="reader")
        try:
            desc = sched.describe("ghost-app")
            assert desc is not None and desc.state == AppState.UNKNOWN
        finally:
            sched.close()


class TestCrossProcessCancelList:
    def test_cancel_from_other_process(self, tmp_path, monkeypatch):
        monkeypatch.setattr(
            "torchx_tpu_torch.schedulers.local_scheduler._registry_path",
            lambda: str(tmp_path / "registry"),
        )
        owner = LocalScheduler(session_name="owner")
        other = LocalScheduler(session_name="other")
        try:
            app = AppDef(name="xc", roles=[sh_role("r", "sleep 60")])
            app_id = owner.submit(app, {"log_dir": str(tmp_path)})
            time.sleep(0.3)
            # cancel from the NON-owning scheduler
            other.cancel(app_id)
            desc = other.describe(app_id)
            assert desc.state == AppState.CANCELLED
            # the owner honors the on-disk CANCELLED mark rather than
            # recording its SIGTERM'd children as a failure
            assert wait_terminal(owner, app_id, timeout=15) == AppState.CANCELLED
        finally:
            owner.close()
            other.close()

    def test_list_includes_external(self, tmp_path, monkeypatch):
        monkeypatch.setattr(
            "torchx_tpu_torch.schedulers.local_scheduler._registry_path",
            lambda: str(tmp_path / "registry"),
        )
        owner = LocalScheduler(session_name="owner")
        try:
            app = AppDef(name="xl", roles=[sh_role("r", "true")])
            app_id = owner.submit(app, {"log_dir": str(tmp_path)})
            wait_terminal(owner, app_id)
        finally:
            owner.close()
        other = LocalScheduler(session_name="other")
        try:
            listing = other.list()
            assert any(a.app_id == app_id for a in listing)
        finally:
            other.close()


def cards(n: int) -> list[str]:
    """A host of ``n`` cards as the launcher lists them."""
    return [str(i) for i in range(n)]


class TestGpuDeviceEnv:
    def test_partitioning(self):
        env = gpu_device_env(4, replica_id=1, replicas_on_host=2, host_gpus=cards(8),
                             simulate=False)
        assert env["CUDA_VISIBLE_DEVICES"] == "4,5,6,7"

    def test_single_replica_sees_its_own_cards_only(self):
        # one replica of a 2-card role on an 8-card host: 2 workers, not 8
        env = gpu_device_env(2, 0, replicas_on_host=1, host_gpus=cards(8), simulate=False)
        assert env == {"CUDA_VISIBLE_DEVICES": "0,1"}

    def test_partition_disabled_on_real_host(self):
        env = gpu_device_env(4, 0, replicas_on_host=2, host_gpus=cards(8), simulate=True,
                             partition=False)
        assert env == {}  # the replica sees what the launcher sees

    def test_oversubscription_raises(self):
        with pytest.raises(ValueError, match="need 16 cards"):
            gpu_device_env(2, 5, replicas_on_host=8, host_gpus=cards(4), simulate=True)
        with pytest.raises(ValueError, match="need 2 cards"):  # one card too many
            gpu_device_env(2, 0, replicas_on_host=1, host_gpus=cards(1), simulate=False)

    def test_simulation(self):
        env = gpu_device_env(4, 0, 1, host_gpus=[], simulate=True)
        assert env == {"CUDA_VISIBLE_DEVICES": ""}

    def test_no_sim_no_cards_refused(self):
        with pytest.raises(ValueError, match="no card; pass gpu_simulate=True"):
            gpu_device_env(4, 0, 1, host_gpus=[], simulate=False)

    def test_launcher_list_wins_and_is_indexed(self, monkeypatch):
        """The launcher's own CUDA_VISIBLE_DEVICES is the card list: its
        length is the count and a replica's entries index into it."""
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3, 5,GPU-abc,7")
        assert lsched.local_gpus() == ["3", "5", "GPU-abc", "7"]
        assert lsched.local_gpu_count() == 4
        env = gpu_device_env(2, 1, replicas_on_host=2, host_gpus=lsched.local_gpus(),
                             simulate=False)
        assert env == {"CUDA_VISIBLE_DEVICES": "GPU-abc,7"}
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
        assert lsched.local_gpu_count() == 0  # set but empty: no card
        monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
        monkeypatch.setattr(lsched, "driver_gpu_count", lambda: 2)
        assert lsched.local_gpus() == ["0", "1"]  # the driver's ordinals

    def test_driver_count(self, monkeypatch):
        """The CUDA driver's count through ctypes, no torch: its answer,
        and 0 without a driver or a device."""
        import ctypes

        class Lib:
            def __init__(self, init_rc=0, n=3):
                self.init_rc, self.n = init_rc, n

            def cuInit(self, flags):  # noqa: N802 - the driver's name
                return self.init_rc

            def cuDeviceGetCount(self, ref):  # noqa: N802
                ref._obj.value = self.n
                return 0

        for lib, want in ((Lib(), 3), (Lib(init_rc=100), 0), (Lib(n=0), 0)):
            monkeypatch.setattr(ctypes, "CDLL", lambda name, lib=lib: lib)
            assert DRIVER_GPU_COUNT() == want

        def missing(name):
            raise OSError(f"{name}: cannot open shared object file")

        monkeypatch.setattr(ctypes, "CDLL", missing)
        assert DRIVER_GPU_COUNT() == 0

    def test_dryrun_partitions_the_host(self, sched, tmp_path, monkeypatch):
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0,1,2,3,4,5,6,7")
        role = sh_role("t", "true", num_replicas=3)
        role.resource = Resource(cpu=1, memMB=64, gpu=GpuSlice("h100", 2))
        info = sched.submit_dryrun(AppDef(name="part", roles=[role]), {"log_dir": str(tmp_path)})
        assert [p.env["CUDA_VISIBLE_DEVICES"] for p in info.request.role_params["t"]] == \
            ["0,1", "2,3", "4,5"]
        role.num_replicas = 5  # 10 cards asked of 8
        with pytest.raises(ValueError, match="need 10 cards"):
            sched.submit_dryrun(AppDef(name="over", roles=[role]), {"log_dir": str(tmp_path)})
        info = sched.submit_dryrun(AppDef(name="over", roles=[role]),
                                   {"log_dir": str(tmp_path),
                                    "auto_set_cuda_visible_devices": False})
        assert all(p.env["CUDA_VISIBLE_DEVICES"] == "0,1,2,3,4,5,6,7"
                   for p in info.request.role_params["t"])


class TestManualResize:
    """Operator-driven `resize` (the manual counterpart of the elastic
    shrink-on-failure path): the role gang restarts with a coherent world
    and resumes from its checkpoint."""

    def resize_script(self, tmp_path) -> str:
        # each attempt logs its world, then waits long enough for the test
        # to resize mid-flight (the resized attempt exits promptly)
        return (
            f'echo "world=$TPX_NUM_REPLICAS id=$TPX_REPLICA_ID"; '
            f'if [ -f {tmp_path}/resized ]; then exit 0; fi; '
            "sleep 30"
        )

    def test_shrink_and_grow(self, sched, tmp_path):
        app = AppDef(
            name="manual",
            roles=[
                sh_role(
                    "w",
                    self.resize_script(tmp_path),
                    num_replicas=4,
                    min_replicas=2,
                )
            ],
        )
        app_id = sched.submit(app, {"log_dir": str(tmp_path)})
        # shrink 4 -> 2
        sched.resize(app_id, "w", 2)
        desc = sched.describe(app_id)
        (rs,) = desc.roles_statuses
        assert len(rs.replicas) == 2
        assert desc.num_restarts == 1
        # grow 2 -> 3 (local gangs can grow: they are just processes)
        (tmp_path / "resized").touch()
        sched.resize(app_id, "w", 3)
        assert wait_terminal(sched, app_id, timeout=30) == AppState.SUCCEEDED
        out0 = (tmp_path / app_id / "w" / "0" / "stdout.log").read_text()
        assert "world=3 id=0" in out0
        # both earlier attempts' logs were rotated aside
        assert (tmp_path / app_id / "w" / "0" / "stdout.log.0").exists()
        assert (tmp_path / app_id / "w" / "0" / "stdout.log.1").exists()

    def test_floor_enforced(self, sched, tmp_path):
        app = AppDef(
            name="floor",
            roles=[
                sh_role(
                    "w",
                    self.resize_script(tmp_path),
                    num_replicas=3,
                    min_replicas=2,
                )
            ],
        )
        app_id = sched.submit(app, {"log_dir": str(tmp_path)})
        with pytest.raises(ValueError, match="below its declared min_replicas"):
            sched.resize(app_id, "w", 1)
        sched.cancel(app_id)

    def test_gpu_role_resizes_in_slice_units(self, sched, tmp_path):
        script = (
            'echo "world=$TPX_NUM_REPLICAS per_slice=${TPX_HOSTS_PER_SLICE:-none}'
            ' slice=${TPX_SLICE_ID:-none}"; '
            f'if [ -f {tmp_path}/resized ]; then exit 0; fi; sleep 30'
        )
        role = Role(
            name="w",
            image="",
            entrypoint="sh",
            args=["-c", script],
            num_replicas=3,  # slices of 2 hosts each
            min_replicas=1,
            resource=Resource(cpu=1, memMB=256, gpu=GpuSlice("h100", 16)),
        )
        app_id = sched.submit(
            AppDef(name="gpu-resize", roles=[role]), {"log_dir": str(tmp_path), **SIM}
        )
        (tmp_path / "resized").touch()
        sched.resize(app_id, "w", 2)  # 3 slices -> 2 slices = 4 hosts
        desc = sched.describe(app_id)
        (rs,) = desc.roles_statuses
        assert len(rs.replicas) == 4
        assert wait_terminal(sched, app_id, timeout=30) == AppState.SUCCEEDED
        out0 = (tmp_path / app_id / "w" / "0" / "stdout.log").read_text()
        assert "world=4 per_slice=2 slice=0" in out0

    def test_resize_unknown_app_or_role(self, sched, tmp_path):
        with pytest.raises(ValueError, match="unknown app"):
            sched.resize("ghost", "w", 2)
        app = AppDef(
            name="r", roles=[sh_role("w", "sleep 30", num_replicas=2)]
        )
        app_id = sched.submit(app, {"log_dir": str(tmp_path)})
        with pytest.raises(ValueError, match="has no role"):
            sched.resize(app_id, "ghost", 2)
        sched.cancel(app_id)

    def test_resize_terminal_app_raises(self, sched, tmp_path):
        app = AppDef(name="done", roles=[sh_role("w", "exit 0")])
        app_id = sched.submit(app, {"log_dir": str(tmp_path)})
        assert wait_terminal(sched, app_id, timeout=30) == AppState.SUCCEEDED
        with pytest.raises(ValueError, match="terminal"):
            sched.resize(app_id, "w", 2)

    def test_noop_resize_keeps_gang(self, sched, tmp_path):
        app = AppDef(
            name="noop", roles=[sh_role("w", "sleep 30", num_replicas=2)]
        )
        app_id = sched.submit(app, {"log_dir": str(tmp_path)})
        sched.resize(app_id, "w", 2)  # same size: no restart
        assert sched.describe(app_id).num_restarts == 0
        sched.cancel(app_id)


class TestParityWithJax:
    """The copy against the JAX package's scheduler on the same inputs."""

    @staticmethod
    def _app(mod, resource=None):
        roles = [
            mod.Role(name="trainer", image="", entrypoint="python",
                     args=["-m", "train", "--lr", "3e-4", f"{mod.macros.replica_id}"],
                     env={"A": "1", "WHO": mod.macros.app_id}, num_replicas=2,
                     resource=resource),
            mod.Role(name="eval", image="", entrypoint="sh",
                     args=["-c", f"echo {mod.macros.num_replicas}"]),
        ]
        return mod.AppDef(name="Parity_App.v1", roles=roles)

    @staticmethod
    def _layout(request, root):
        """(args, env, log paths relative to the app's log root) a replica."""
        out = {}
        for role, replicas in request.role_params.items():
            for i, rp in enumerate(replicas):
                rel = {k: os.path.relpath(getattr(rp, k), root)
                       for k in ("stdout", "stderr", "combined")}
                env = {k: (os.path.relpath(v, root) if k in (settings.ENV_TPX_LOG_DIR,
                                                              settings.ENV_TPX_ERROR_FILE)
                           else v) for k, v in rp.env.items()}
                out[(role, i)] = (rp.args, env, rel, rp.cwd)
        return out

    def _dryruns(self, jres, tres, seed, monkeypatch):
        # the JAX package's span sink mints the session id on first use:
        # fix it first, so that both requests copy the same environment
        monkeypatch.setenv(settings.ENV_TPX_INTERNAL_SESSION_ID, "parity")
        jsched = jlocal.LocalScheduler(session_name="parity")
        tsched = LocalScheduler(session_name="parity")
        random.seed(seed)  # the same app id from both make_unique
        jinfo = jsched.submit_dryrun(self._app(japi, jres), {"tpu_simulate": True})
        random.seed(seed)
        tinfo = tsched.submit_dryrun(self._app(tapi, tres), SIM)
        return jinfo.request, tinfo.request

    @pytest.mark.parametrize("seed", [0, 7])
    def test_cpu_app_request_equals_jax(self, seed, monkeypatch):
        """A CPU-only app: the same app id, args, TPX_* env and log layout
        under the respective default roots, ``<tmp>/torchx_tpu/<session>``
        and ``<tmp>/torchx_tpu_torch/<session>``."""
        jreq, treq = self._dryruns(None, None, seed, monkeypatch)
        assert treq.app_id == jreq.app_id
        tmp = tempfile.gettempdir()
        assert jreq.log_dir == os.path.join(tmp, "torchx_tpu", "parity", jreq.app_id)
        assert treq.log_dir == os.path.join(tmp, "torchx_tpu_torch", "parity", treq.app_id)
        assert self._layout(treq, treq.log_dir) == self._layout(jreq, jreq.log_dir)
        tpx = {k for _, env, _, _ in self._layout(treq, treq.log_dir).values()
               for k in env if k.startswith("TPX_")}
        assert {"TPX_APP_ID", "TPX_JOB_ID", "TPX_LOG_DIR", "TPX_ERROR_FILE", "TPX_REPLICA_ID",
                "TPX_NUM_REPLICAS", "TPX_ROLE_NAME", "TPX_COORDINATOR_HOST"} <= tpx

    def test_accelerator_app_differs_only_in_device_names(self, monkeypatch):
        """A four-host slice each (v5p-32, h100-32): everything equal but
        the TPU names of the JAX request and the GPU names of the port's."""
        jreq, treq = self._dryruns(
            japi.Resource(cpu=1, memMB=64, tpu=japi.TpuSlice("v5p", 16)),
            Resource(cpu=1, memMB=64, gpu=GpuSlice("h100", 32)), 3, monkeypatch)
        jl, tl = self._layout(jreq, jreq.log_dir), self._layout(treq, treq.log_dir)
        assert set(jl) == set(tl) and len([k for k in tl if k[0] == "trainer"]) == 8
        jax_only = {"TPX_TPU_ACCELERATOR_TYPE", "TPX_TPU_TOPOLOGY", "JAX_PLATFORMS",
                    "XLA_FLAGS", "TPX_SLICE_ID", "TPX_HOST_ID", "TPX_HOSTS_PER_SLICE",
                    "MEGASCALE_NUM_SLICES", "MEGASCALE_SLICE_ID",
                    "MEGASCALE_COORDINATOR_ADDRESS"}
        port_only = {"TPX_GPU_ACCELERATOR_TYPE", "TPX_GPU_TOPOLOGY", "CUDA_VISIBLE_DEVICES",
                     "TPX_SLICE_ID", "TPX_HOST_ID", "TPX_HOSTS_PER_SLICE"}
        for key in tl:
            (jargs, jenv, jrel, jcwd), (targs, tenv, trel, tcwd) = jl[key], tl[key]
            assert (targs, trel, tcwd) == (jargs, jrel, jcwd)
            differ = {k for k in set(jenv) | set(tenv) if jenv.get(k) != tenv.get(k)}
            assert differ <= jax_only | port_only, differ
            if key[0] == "trainer":
                assert tenv["TPX_GPU_ACCELERATOR_TYPE"] == "h100-32"
                assert tenv["CUDA_VISIBLE_DEVICES"] == ""
                # the multi-slice identity is the same where both set it
                assert all(tenv[k] == jenv[k] for k in
                           ("TPX_SLICE_ID", "TPX_HOST_ID", "TPX_HOSTS_PER_SLICE"))
            else:
                assert not differ

    @pytest.mark.parametrize("rc", [0, 3])
    def test_sidecar_watch_events_equal_jax(self, tmp_path, monkeypatch, rc):
        """The same real ``sh -c`` job, submitted and watched by each
        package's local scheduler: the same (state, source, confirmed)
        sequence, RUNNING then the terminal state."""
        monkeypatch.setenv("TPX_WATCH_INTERVAL", "0.05")
        seqs = {}
        for name, mod, make in (("jax", japi, jlocal.LocalScheduler),
                                ("port", None, LocalScheduler)):
            s = make(session_name="watch-parity")
            try:
                role_cls = mod.Role if mod else Role
                app_cls = mod.AppDef if mod else AppDef
                app = app_cls(name="w", roles=[role_cls(
                    name="r", image="", entrypoint="sh", args=["-c", f"sleep 0.6; exit {rc}"])])
                app_id = s.submit(app, {"log_dir": str(tmp_path / name)})
                watcher = s.watch([app_id])
                killer = threading.Timer(20, watcher.close)
                killer.start()
                try:
                    events = list(watcher.events(follow=False))
                finally:
                    killer.cancel()
                    watcher.close()
                seqs[name] = [(e.state.name, e.source, e.resp is not None, e.terminal)
                              for e in events]
            finally:
                s.close()
        terminal = "SUCCEEDED" if rc == 0 else "FAILED"
        assert seqs["port"] == seqs["jax"] == [("RUNNING", "sidecar", True, False),
                                               (terminal, "sidecar", True, True)]
