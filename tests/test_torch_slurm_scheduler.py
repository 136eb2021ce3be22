"""The port's slurm backend (``torchx_tpu_torch.schedulers.slurm_scheduler``)
with canned CLI output: every case of ``tests/test_slurm_scheduler.py``
run against the copy, its ``v5p-16`` role (two hosts) written as
``h100-16`` (two hosts of eight), and the squeue/sacct fixtures read from
that file's own ``tests/fixtures``; the GPU request (``--gpus-per-node``)
and each het group's identity env against ``role_replica_env``; and the
copy held to the JAX package's backend on the same app
(``TestJaxParity``). Every case keeps the job-dir registry under
``tmp_path``."""

import json
import subprocess
import re
from unittest import mock

import pytest

from torchx_tpu_torch.schedulers.slurm_scheduler import (
    SlurmScheduler,
    slurm_state,
)
from torchx_tpu_torch.specs.api import (
    AppDef,
    AppState,
    Resource,
    Role,
    GpuSlice,
    macros,
)


def gpu_role(**kwargs) -> Role:
    defaults = dict(
        name="trainer",
        image="/shared/job",
        entrypoint="python",
        args=["-m", "train", f"--id={macros.app_id}"],
        resource=Resource(cpu=208, memMB=1000, gpu=GpuSlice("h100", 16)),
    )
    defaults.update(kwargs)
    return Role(**defaults)


def completed(stdout="", rc=0, stderr=""):
    return subprocess.CompletedProcess([], returncode=rc, stdout=stdout, stderr=stderr)


@pytest.fixture(autouse=True)
def _registry_and_breakers(tmp_path, monkeypatch):
    """The port's job-dir registry in ``tmp_path`` (``tests/conftest.py``
    redirects the JAX package's), and fresh control-plane breakers."""
    from torchx_tpu_torch.resilience import call as resilience_call
    from torchx_tpu_torch.resilience import faults as resilience_faults

    monkeypatch.setattr(
        "torchx_tpu_torch.schedulers.slurm_scheduler._registry_path",
        lambda: str(tmp_path / "tpx_torch_slurm_dirs"),
    )
    resilience_call.reset_breakers()
    resilience_faults.reset()


@pytest.fixture
def sched():
    return SlurmScheduler("test")


class TestSbatchMaterialization:
    def test_gpu_role_het_groups(self, sched):
        app = AppDef(name="t", roles=[gpu_role()])
        info = sched.submit_dryrun(app, {})
        script = info.request.script()
        # h100-16: 16 cards -> 2 hosts of 8 -> 2 het groups
        assert script.count("#SBATCH hetjob") == 1
        assert script.count("--het-group=") == 2
        assert "--cpus-per-task=208" in script
        assert "TPX_COORDINATOR_HOST=$(scontrol show hostnames" in script
        assert 'TPX_REPLICA_ID="0"' in script and 'TPX_REPLICA_ID="1"' in script
        assert "--kill-on-bad-exit=1" in script

    def test_het_groups_stamped_via_wrapper(self, sched):
        app = AppDef(name="t", roles=[gpu_role()])
        script = sched.submit_dryrun(app, {}).request.script()
        # every task's stdout/stderr rides through the epoch stamper so
        # log_iter can window; argv stays batch-shell-expanded positionals,
        # and pipelines (not procsubs) guarantee the stampers are drained
        # before slurmstepd reaps the task
        assert "export TPX_STAMP=" in script
        assert script.count("bash -c 'set -o pipefail;") == 2
        assert script.count('{ ("$@") 2>&1 1>&3') == 2
        assert '| python3 -u -c "$TPX_STAMP" >&2; } 3>&1' in script

    def test_elastic_script_stamped(self, sched):
        app = AppDef(name="t", roles=[gpu_role(min_replicas=1, num_replicas=2)])
        script = sched.submit_dryrun(app, {}).request.script()
        assert "export TPX_STAMP=" in script
        assert '$TPX_STAMP' in script

    def test_macro_substitution_defers_job_id(self, sched):
        app = AppDef(name="t", roles=[gpu_role()])
        script = sched.submit_dryrun(app, {}).request.script()
        # double-quoted, not single-quoted: the macro must expand at runtime
        assert '"--id=${SLURM_JOB_ID}"' in script
        assert "'--id=${SLURM_JOB_ID}'" not in script

    def test_per_group_job_names(self, sched):
        app = AppDef(name="t", roles=[gpu_role()])
        script = sched.submit_dryrun(app, {}).request.script()
        assert "#SBATCH --job-name=trainer-0" in script
        assert "#SBATCH --job-name=trainer-1" in script

    def test_log_files_use_leader_job_id(self, sched):
        app = AppDef(name="t", roles=[gpu_role()])
        script = sched.submit_dryrun(app, {}).request.script()
        assert "--output=slurm-${SLURM_JOB_ID}-trainer-0.out" in script
        assert "%j" not in script

    def test_requeue_on_retries(self, sched):
        app = AppDef(name="t", roles=[gpu_role(max_retries=2)])
        script = sched.submit_dryrun(app, {}).request.script()
        assert "scontrol requeue" in script
        assert "TPX_MAX_RETRIES=2" in script
        assert "trap tpx_requeue ERR" in script

    def test_no_requeue_without_retries(self, sched):
        app = AppDef(name="t", roles=[gpu_role()])
        assert "requeue" not in sched.submit_dryrun(app, {}).request.script()

    def test_partition_time_nomem(self, sched):
        app = AppDef(name="t", roles=[gpu_role()])
        script = sched.submit_dryrun(
            app, {"partition": "tpu", "time": "2:00:00", "nomem": True}
        ).request.script()
        assert "--partition=tpu" in script
        assert "--time=2:00:00" in script
        assert "--mem=" not in script

    def test_schedule_parses_job_id(self, sched, tmp_path, monkeypatch):
        monkeypatch.setattr(
            sched, "_run_cmd", lambda cmd, **kw: completed(stdout="1234\n")
        )
        monkeypatch.setattr(
            "torchx_tpu_torch.schedulers.slurm_scheduler._registry_path",
            lambda: str(tmp_path / "jobdirs"),
        )
        app = AppDef(name="t", roles=[gpu_role()])
        info = sched.submit_dryrun(app, {"job_dir": str(tmp_path)})
        app_id = sched.schedule(info)
        assert app_id == "1234"
        assert (tmp_path / "tpx_sbatch.sh").exists()
        assert "1234 = " in (tmp_path / "jobdirs").read_text()

    def test_schedule_sbatch_failure(self, sched, tmp_path, monkeypatch):
        monkeypatch.setattr(
            sched, "_run_cmd", lambda cmd, **kw: completed(rc=1, stderr="bad partition")
        )
        app = AppDef(name="t", roles=[gpu_role()])
        info = sched.submit_dryrun(app, {"job_dir": str(tmp_path)})
        with pytest.raises(RuntimeError, match="bad partition"):
            sched.schedule(info)


class TestSlurmDescribe:
    def test_describe_squeue(self, sched, monkeypatch):
        payload = {
            "jobs": [
                {
                    "job_id": 1234,
                    "name": "trainer-0",
                    "job_state": ["RUNNING"],
                    "job_resources": {"nodes": "node01"},
                },
                {
                    "job_id": 1235,
                    "name": "trainer-1",
                    "job_state": "RUNNING",
                },
            ]
        }
        monkeypatch.setattr(
            sched, "_run_cmd", lambda cmd, **kw: completed(stdout=json.dumps(payload))
        )
        resp = sched.describe("1234")
        assert resp.state == AppState.RUNNING
        (rs,) = resp.roles_statuses
        assert rs.role == "trainer" and len(rs.replicas) == 2
        assert rs.replicas[0].hostname == "node01"

    def test_describe_falls_back_to_sacct(self, sched, monkeypatch):
        sacct_out = (
            "JobID|JobName|State\n"
            "1234+0|trainer-0|COMPLETED\n"
            "1234+0.batch|batch|COMPLETED\n"
            "1234+1|trainer-1|COMPLETED\n"
        )
        def run_cmd(cmd, **kw):
            if cmd[0] == "squeue":
                return completed(rc=1, stderr="Invalid job id")
            return completed(stdout=sacct_out)

        monkeypatch.setattr(sched, "_run_cmd", run_cmd)
        resp = sched.describe("1234")
        assert resp.state == AppState.SUCCEEDED
        (rs,) = resp.roles_statuses
        assert len(rs.replicas) == 2

    def test_describe_failed_dominates(self, sched, monkeypatch):
        sacct_out = (
            "JobID|JobName|State\n"
            "1234+0|trainer-0|COMPLETED\n"
            "1234+1|trainer-1|FAILED\n"
        )
        def run_cmd(cmd, **kw):
            if cmd[0] == "squeue":
                return completed(rc=1)
            return completed(stdout=sacct_out)

        monkeypatch.setattr(sched, "_run_cmd", run_cmd)
        assert sched.describe("1234").state == AppState.FAILED

    def test_describe_missing(self, sched, monkeypatch):
        monkeypatch.setattr(sched, "_run_cmd", lambda cmd, **kw: completed(rc=1))
        assert sched.describe("9999") is None

    def test_cancel(self, sched, monkeypatch):
        calls = []

        def run_cmd(cmd, **kw):
            calls.append(cmd)
            if cmd[0] == "squeue":
                return completed(stdout=json.dumps({"jobs": [{"job_id": 1, "name": "x", "job_state": "RUNNING"}]}))
            return completed()

        monkeypatch.setattr(sched, "_run_cmd", run_cmd)
        sched.cancel("1")
        assert ["scancel", "1"] in calls

    def test_log_iter(self, sched, tmp_path, monkeypatch):
        monkeypatch.setattr(
            "torchx_tpu_torch.schedulers.slurm_scheduler._registry_path",
            lambda: str(tmp_path / "jobdirs"),
        )
        (tmp_path / "jobdirs").write_text(f"77 = {tmp_path}\n")
        (tmp_path / "slurm-77-trainer-0.out").write_text("line1\nline2\n")
        lines = list(sched.log_iter("77", "trainer", 0))
        assert lines == ["line1", "line2"]


class TestStateMap:
    def test_states(self):
        assert slurm_state("COMPLETED") == AppState.SUCCEEDED
        assert slurm_state("CANCELLED by 1000") == AppState.CANCELLED
        assert slurm_state("NODE_FAIL") == AppState.FAILED
        assert slurm_state("WEIRD") == AppState.UNKNOWN


# =========================================================================
# Recorded-fixture tests: format generations the parsers must survive
# (reference analog: slurm-squeue-output.json, slurm_scheduler.py:661-810)
# =========================================================================

import os

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


def fixture(name: str) -> str:
    with open(os.path.join(FIXTURES, name)) as f:
        return f.read()


class TestSqueueFormatGenerations:
    def test_v24_object_nodes(self, sched, monkeypatch):
        """24.05 squeue: job_state is a list, job_resources.nodes an object."""
        monkeypatch.setattr(
            sched, "_run_cmd",
            lambda cmd, **kw: completed(stdout=fixture("squeue_v24.json")),
        )
        resp = sched.describe("4001")
        assert resp.state == AppState.RUNNING
        (rs,) = resp.roles_statuses
        by_id = {r.id: r for r in rs.replicas}
        assert by_id[0].hostname == "tpu-node-3"
        assert by_id[1].state == AppState.PENDING
        assert by_id[1].hostname == ""  # job_resources: null (pending)

    def test_v22_string_nodes_and_allocated_nodes(self, sched, monkeypatch):
        """pre-23.02: job_state is a string; nodes is a string or
        allocated_nodes a list of {nodename}."""
        monkeypatch.setattr(
            sched, "_run_cmd",
            lambda cmd, **kw: completed(stdout=fixture("squeue_v22.json")),
        )
        resp = sched.describe("1234")
        (rs,) = resp.roles_statuses
        by_id = {r.id: r for r in rs.replicas}
        assert by_id[0].hostname == "gpu-compute-[01-02]"
        assert by_id[1].hostname == "gpu-compute-03"

    def test_truncated_payload_falls_through(self, sched, monkeypatch):
        """A half-written/truncated squeue JSON must not crash describe —
        it falls through to sacct (which here has nothing)."""

        def run_cmd(cmd, **kw):
            if cmd[0] == "squeue":
                return completed(stdout='{"jobs": [{"job_id": 1, "na')
            return completed(stdout="")

        monkeypatch.setattr(sched, "_run_cmd", run_cmd)
        assert sched.describe("1") is None


class TestSacctFormatVariants:
    def test_het_offsets_steps_and_blank_state(self, sched, monkeypatch):
        """sacct rows: het-job `+N` ids, `.batch`/`.0` step rows (skipped),
        'CANCELLED by uid' states, and a blank state column."""

        def run_cmd(cmd, **kw):
            if cmd[0] == "squeue":
                return completed(rc=1)  # job left the queue
            return completed(stdout=fixture("sacct_variants.txt"))

        monkeypatch.setattr(sched, "_run_cmd", run_cmd)
        resp = sched.describe("777")
        assert resp is not None
        assert resp.state == AppState.CANCELLED
        (rs,) = [r for r in resp.roles_statuses if r.role == "spmd"]
        assert {r.id: r.state for r in rs.replicas} == {
            0: AppState.CANCELLED,
            1: AppState.SUCCEEDED,
        }

    def test_sacct_header_only(self, sched, monkeypatch):
        def run_cmd(cmd, **kw):
            if cmd[0] == "squeue":
                return completed(rc=1)
            return completed(stdout="JobID|JobName|State\n")

        monkeypatch.setattr(sched, "_run_cmd", run_cmd)
        assert sched.describe("777") is None

    def test_multi_role_rows_grouped_and_worst_state_wins(self, sched, monkeypatch):
        """sacct rows for a two-role hetjob (trainer-0/1, tb-0): replicas
        group under their role and one FAILED row fails the app even when
        later rows completed."""
        sacct_out = (
            "JobID|JobName|State\n"
            "900+0|trainer-0|FAILED\n"
            "900+1|trainer-1|COMPLETED\n"
            "900+2|tb-0|COMPLETED\n"
        )

        def run_cmd(cmd, **kw):
            if cmd[0] == "squeue":
                return completed(rc=1)
            return completed(stdout=sacct_out)

        monkeypatch.setattr(sched, "_run_cmd", run_cmd)
        resp = sched.describe("900")
        assert resp.state == AppState.FAILED
        roles = {r.role: r for r in resp.roles_statuses}
        assert set(roles) == {"trainer", "tb"}
        assert len(roles["trainer"].replicas) == 2
        assert len(roles["tb"].replicas) == 1

    def test_preempted_and_timeout_map_to_failed(self):
        # requeue-able terminal states must read as failures (retry machinery
        # keys off FAILED), not unknowns
        assert slurm_state("PREEMPTED") == AppState.FAILED
        assert slurm_state("TIMEOUT") == AppState.FAILED
        assert slurm_state("COMPLETING") == AppState.RUNNING
        assert slurm_state("REQUEUED") == AppState.PENDING
        assert slurm_state("CANCELLED+") == AppState.CANCELLED  # federation '+'
        assert slurm_state("") == AppState.UNKNOWN


class TestSlurmList:
    def test_list_me(self, sched, monkeypatch):
        payload = {
            "jobs": [
                {"job_id": 11, "name": "a-x1", "job_state": ["RUNNING"]},
                {"job_id": 12, "name": "b-x2", "job_state": "PENDING"},
            ]
        }
        calls = []

        def run_cmd(cmd, **kw):
            calls.append(cmd)
            return completed(stdout=json.dumps(payload))

        monkeypatch.setattr(sched, "_run_cmd", run_cmd)
        apps = sched.list()
        assert [a.app_id for a in apps] == ["11", "12"]
        assert apps[0].state == AppState.RUNNING
        assert apps[1].state == AppState.PENDING
        assert ["squeue", "--json", "--me"] in calls

    def test_list_squeue_failure_raises(self, sched, monkeypatch):
        monkeypatch.setattr(
            sched, "_run_cmd", lambda cmd, **kw: completed(rc=1, stderr="down")
        )
        with pytest.raises(RuntimeError, match="squeue failed"):
            sched.list()


class TestSlurmLogIter:
    @pytest.fixture
    def job_dir(self, tmp_path, monkeypatch):
        monkeypatch.setattr(
            "torchx_tpu_torch.schedulers.slurm_scheduler._registry_path",
            lambda: str(tmp_path / "jobdirs"),
        )
        (tmp_path / "jobdirs").write_text(f"55 = {tmp_path}\n")
        return tmp_path

    def test_stderr_stream(self, sched, job_dir):
        from torchx_tpu_torch.schedulers.api import Stream

        (job_dir / "slurm-55-trainer-0.err").write_text("E1\nE2\n")
        lines = list(sched.log_iter("55", "trainer", 0, streams=Stream.STDERR))
        assert lines == ["E1", "E2"]

    def test_non_het_fallback_filename(self, sched, job_dir):
        # single-replica jobs write slurm-{id}.out without role/replica parts
        (job_dir / "slurm-55.out").write_text("solo\n")
        assert list(sched.log_iter("55", "trainer", 0)) == ["solo"]

    def test_regex_filter(self, sched, job_dir):
        (job_dir / "slurm-55-trainer-0.out").write_text("keep 1\ndrop\nkeep 2\n")
        assert list(sched.log_iter("55", "trainer", 0, regex="keep")) == [
            "keep 1",
            "keep 2",
        ]

    def test_window_on_stamped_lines(self, sched, job_dir):
        # the batch-script wrapper stamps epoch millis; log_iter windows
        # on them and strips the stamp (7/7 backends honor windows)
        (job_dir / "slurm-55-trainer-0.out").write_text(
            "1700000000.000 early\n1700000100.000 mid\n1700000200.000 late\n"
        )
        assert list(
            sched.log_iter("55", "trainer", 0, since=1700000050.0)
        ) == ["mid", "late"]
        assert list(
            sched.log_iter(
                "55", "trainer", 0, since=1700000050.0, until=1700000150.0
            )
        ) == ["mid"]

    def test_stamps_stripped_without_window(self, sched, job_dir):
        (job_dir / "slurm-55-trainer-0.out").write_text(
            "1700000000.000 stamped\nlegacy unstamped\n"
        )
        assert list(sched.log_iter("55", "trainer", 0)) == [
            "stamped",
            "legacy unstamped",
        ]

    def test_legacy_unstamped_passes_window(self, sched, job_dir):
        # pre-stamping log files carry no timestamps: windows can't apply,
        # lines pass through whole rather than vanishing
        (job_dir / "slurm-55-trainer-0.out").write_text("legacy line\n")
        assert list(
            sched.log_iter("55", "trainer", 0, since=1700000050.0)
        ) == ["legacy line"]

    def test_supports_log_windows_flag(self, sched):
        assert type(sched).supports_log_windows is True

    def test_unknown_job_dir_raises(self, sched, job_dir):
        with pytest.raises(RuntimeError, match="no job dir recorded"):
            sched.log_iter("66", "trainer", 0)

    def test_missing_file_yields_nothing(self, sched, job_dir):
        assert list(sched.log_iter("55", "trainer", 3)) == []


class TestSqueueNodeFormats:
    """_squeue_job_nodes across the format generations the parsers must
    survive (reference parses 3 SLURM JSON formats, :661-810)."""

    def test_object_with_list(self):
        from torchx_tpu_torch.schedulers.slurm_scheduler import _squeue_job_nodes

        job = {"job_resources": {"nodes": {"count": 2, "list": ["n1", "n2"]}}}
        assert _squeue_job_nodes(job) == "n1,n2"

    def test_object_with_nodes_string(self):
        from torchx_tpu_torch.schedulers.slurm_scheduler import _squeue_job_nodes

        job = {"job_resources": {"nodes": {"nodes": "n[01-04]"}}}
        assert _squeue_job_nodes(job) == "n[01-04]"

    def test_allocated_nodes_dicts(self):
        from torchx_tpu_torch.schedulers.slurm_scheduler import _squeue_job_nodes

        job = {
            "job_resources": {
                "allocated_nodes": [{"nodename": "a"}, {"nodename": "b"}]
            }
        }
        assert _squeue_job_nodes(job) == "a,b"

    def test_null_and_garbage(self):
        from torchx_tpu_torch.schedulers.slurm_scheduler import _squeue_job_nodes

        assert _squeue_job_nodes({}) == ""
        assert _squeue_job_nodes({"job_resources": None}) == ""
        assert _squeue_job_nodes({"job_resources": "weird"}) == ""


class TestCancelFailure:
    def test_scancel_error_raises(self, sched, monkeypatch):
        def run_cmd(cmd, **kw):
            if cmd[0] == "squeue":
                return completed(
                    stdout=json.dumps(
                        {"jobs": [{"job_id": 1, "name": "x", "job_state": "RUNNING"}]}
                    )
                )
            return completed(rc=1, stderr="Access denied")

        monkeypatch.setattr(sched, "_run_cmd", run_cmd)
        with pytest.raises(RuntimeError, match="scancel failed"):
            sched.cancel("1")


class TestElasticGang:
    """min_replicas -> one RANGED --nodes group; slurm restarts a requeued
    job with whatever node count survives (>= the floor)."""

    def _dryrun(self, sched, **role_kwargs):
        role_kwargs.setdefault("min_replicas", 1)
        role_kwargs.setdefault("max_retries", 2)
        app = AppDef(name="t", roles=[gpu_role(**role_kwargs)])
        return sched.submit_dryrun(app, {})

    def test_ranged_nodes_no_hetjob(self, sched):
        # h100-16 slice = 2 hosts; min 1 slice -> 2-2 ... use 2 slices
        info = self._dryrun(sched, num_replicas=2, min_replicas=1)
        script = info.request.script()
        # 2 slices x 2 hosts max, floor 1 slice x 2 hosts
        assert "#SBATCH --nodes=2-4" in script
        assert "hetjob" not in script
        assert "--ntasks-per-node=1" in script
        assert info.request.elastic_range == (2, 4)

    def test_runtime_identity_derivation(self, sched):
        script = self._dryrun(sched, num_replicas=2, min_replicas=1).request.script()
        # identity comes from slurm at RUN time (size known only then)
        assert 'TPX_REPLICA_ID="$SLURM_PROCID"' in script
        assert 'TPX_NUM_REPLICAS="$SLURM_NTASKS"' in script
        # AppDef units (1 slice), matching GKE's TPX_MIN_REPLICAS injection
        assert "export TPX_MIN_REPLICAS=1" in script
        assert "export TPX_HOSTS_PER_UNIT=2" in script
        # whole-slice rounding: the srun step is clamped so a requeue that
        # lands on 3 surviving nodes runs a 2-host (1-slice) gang
        assert "TPX_USABLE_NODES=$(( SLURM_JOB_NUM_NODES / 2 * 2 ))" in script
        assert '--nodes="$TPX_USABLE_NODES" --ntasks="$TPX_USABLE_NODES"' in script
        # the macro-substituted arg defers to the task-derived env
        assert "--id=${SLURM_JOB_ID}" in script

    def test_requeue_trap_present(self, sched):
        script = self._dryrun(sched, num_replicas=2, min_replicas=1).request.script()
        assert "scontrol requeue" in script
        assert "trap tpx_requeue ERR" in script

    def test_per_task_log_files(self, sched):
        script = self._dryrun(sched, num_replicas=2, min_replicas=1).request.script()
        # %t = task id, matching log_iter's slurm-{id}-{role}-{k}.{out}
        assert "--output=slurm-${SLURM_JOB_ID}-trainer-%t.out" in script

    def test_multi_role_elastic_rejected(self, sched):
        cpu = Role(
            name="reader", image="/x", entrypoint="python",
            resource=Resource(cpu=2, memMB=100),
        )
        app = AppDef(
            name="t", roles=[gpu_role(min_replicas=1), cpu]
        )
        with pytest.raises(ValueError, match="single-role"):
            sched.submit_dryrun(app, {})

    def test_elastic_lifecycle_requeued_then_resized(self, sched, monkeypatch):
        """Canned lifecycle: sbatch -> squeue shows RUNNING on 4 nodes ->
        node failure requeues -> squeue shows REQUEUED then RUNNING on 2
        nodes -> sacct shows COMPLETED. The launcher's view stays coherent
        through the shrink."""
        phases = iter(
            [
                ("sinfo", completed(stdout="128000\n")),  # mem probe
                ("sbatch", completed(stdout="999\n")),
                ("squeue", completed(stdout=json.dumps({"jobs": [
                    {"job_id": 999, "name": "trainer-0",
                     "job_state": ["RUNNING"],
                     "job_resources": {"nodes": "n[0-3]"}}]}))),
                ("squeue", completed(stdout=json.dumps({"jobs": [
                    {"job_id": 999, "name": "trainer-0",
                     "job_state": ["REQUEUED"]}]}))),
                ("squeue", completed(stdout=json.dumps({"jobs": [
                    {"job_id": 999, "name": "trainer-0",
                     "job_state": ["RUNNING"],
                     "job_resources": {"nodes": "n[0-1]"}}]}))),
                ("squeue", completed(rc=1)),  # left the queue
                ("sacct", completed(stdout=(
                    "JobID|JobName|State\n"
                    "999|trainer-0|COMPLETED\n"
                    "999.batch|batch|COMPLETED\n"
                ))),
            ]
        )

        def run_cmd(cmd, **kw):
            expect, out = next(phases)
            assert cmd[0] == expect, (cmd, expect)
            return out

        monkeypatch.setattr(sched, "_run_cmd", run_cmd)
        app = AppDef(
            name="t", roles=[gpu_role(num_replicas=2, min_replicas=1,
                                      max_retries=2)]
        )
        app_id = sched.schedule(sched.submit_dryrun(app, {}))
        assert app_id == "999"
        assert sched.describe(app_id).state == AppState.RUNNING
        assert sched.describe(app_id).state == AppState.PENDING  # requeued
        assert sched.describe(app_id).state == AppState.RUNNING  # shrunk
        final = sched.describe(app_id)
        assert final.state == AppState.SUCCEEDED


class TestMemProbe:
    def _probe(self, sched, monkeypatch, sinfo_out, rc=0):
        calls = []

        def run_cmd(cmd, **kw):
            calls.append(cmd)
            if cmd[0] == "sinfo":
                return completed(stdout=sinfo_out, rc=rc)
            return completed(stdout="1\n")

        monkeypatch.setattr(sched, "_run_cmd", run_cmd)
        return calls

    def test_unset_realmemory_drops_mem(self, sched, monkeypatch):
        self._probe(sched, monkeypatch, "1\n1\n")
        script = sched.submit_dryrun(
            AppDef(name="t", roles=[gpu_role()]), {"partition": "tpu"}
        ).request.script()
        assert "--mem=" not in script

    def test_real_memory_keeps_mem(self, sched, monkeypatch):
        self._probe(sched, monkeypatch, "128000+\n")
        script = sched.submit_dryrun(
            AppDef(name="t", roles=[gpu_role()]), {"partition": "tpu"}
        ).request.script()
        assert "--mem=1000" in script

    def test_probe_failure_keeps_mem(self, sched, monkeypatch):
        self._probe(sched, monkeypatch, "", rc=1)
        script = sched.submit_dryrun(
            AppDef(name="t", roles=[gpu_role()]), {"partition": "x"}
        ).request.script()
        assert "--mem=1000" in script

    def test_probe_cached_per_partition(self, sched, monkeypatch):
        calls = self._probe(sched, monkeypatch, "128000\n")
        app = AppDef(name="t", roles=[gpu_role()])
        sched.submit_dryrun(app, {"partition": "tpu"})
        sched.submit_dryrun(app, {"partition": "tpu"})
        assert sum(1 for c in calls if c[0] == "sinfo") == 1


class TestSacctRequeueVariant:
    def test_requeued_job_with_extern_steps(self, sched, monkeypatch):
        """Third sacct variant: a requeued job mid-restart — REQUEUED top
        row maps to PENDING, `.extern`/`.batch`/`.0` step rows (including
        truncated `CANCELLED+` states) are skipped, and the launcher keeps
        polling rather than declaring the app dead."""

        def run_cmd(cmd, **kw):
            if cmd[0] == "squeue":
                return completed(rc=1)
            return completed(stdout=fixture("sacct_requeue.txt"))

        monkeypatch.setattr(sched, "_run_cmd", run_cmd)
        resp = sched.describe("888")
        assert resp is not None
        assert resp.state == AppState.PENDING  # requeued, not failed
        (rs,) = [r for r in resp.roles_statuses if r.role == "spmd"]
        assert {r.id: r.state for r in rs.replicas} == {0: AppState.PENDING}


# =========================================================================
# GPU nodes: the cards asked for, each group's identity
# =========================================================================

from torchx_tpu.schedulers import slurm_scheduler as jslurm  # noqa: E402
from torchx_tpu.specs import api as japi  # noqa: E402
from torchx_tpu_torch import settings  # noqa: E402
from torchx_tpu_torch.schedulers.api import role_replica_env  # noqa: E402
from torchx_tpu_torch.specs import named_resources  # noqa: E402


def no_probe(cmd, **kw):
    """``sinfo`` answers nothing: ``--mem`` stays."""
    return completed(rc=1)


class TestGpuRequest:
    @pytest.mark.parametrize("resource, per_node", [
        (Resource(cpu=8, memMB=100, gpu=GpuSlice("h100", 16)), 8),
        (Resource(cpu=8, memMB=100, gpu=GpuSlice("h100", 4)), 4),
        (Resource(cpu=8, memMB=100, devices={"nvidia.com/gpu": 2}), 2),
        (named_resources["h100-16"], 8),  # a slice and its named-device count: one ask
        (Resource(cpu=8, memMB=100), None),
    ])
    def test_gpus_per_node(self, sched, monkeypatch, resource, per_node):
        monkeypatch.setattr(sched, "_run_cmd", no_probe)
        app = AppDef(name="t", roles=[gpu_role(resource=resource)])
        script = sched.submit_dryrun(app, {}).request.script()
        groups = script.count("#SBATCH --job-name=")
        if per_node is None:
            assert "--gpus-per-node" not in script
        else:
            assert script.count(f"#SBATCH --gpus-per-node={per_node}\n") == groups
            assert script.count("--gpus-per-node") == groups

    def test_elastic_group_asks_for_cards(self, sched, monkeypatch):
        monkeypatch.setattr(sched, "_run_cmd", no_probe)
        app = AppDef(name="t", roles=[gpu_role(num_replicas=2, min_replicas=1)])
        script = sched.submit_dryrun(app, {}).request.script()
        assert "#SBATCH --gpus-per-node=8" in script
        assert 'TPX_GPU_ACCELERATOR_TYPE="h100-16"' in script
        assert 'TPX_GPU_TOPOLOGY="2x8"' in script

    @pytest.mark.parametrize("num_replicas", [1, 2])
    def test_identity_env_is_role_replica_env(self, sched, monkeypatch, num_replicas):
        """Each het group's identity is ``role_replica_env``'s for its
        replica; the coordinator is the script's export from het group 0."""
        monkeypatch.setattr(sched, "_run_cmd", no_probe)
        role = gpu_role(num_replicas=num_replicas)
        req = sched.submit_dryrun(AppDef(name="t", roles=[role]), {}).request
        assert len(req.replicas) == 2 * num_replicas
        for rid, group in enumerate(req.replicas):
            want = role_replica_env(role, rid, "", settings.TPX_COORDINATOR_PORT)
            want.pop(settings.ENV_TPX_COORDINATOR_HOST)
            assert {k: group.env[k] for k in want} == want
            assert settings.ENV_TPX_COORDINATOR_HOST not in group.env
        assert "export TPX_COORDINATOR_HOST=$(scontrol show hostnames" in req.script()

    def test_no_tpu_names(self, sched, monkeypatch):
        monkeypatch.setattr(sched, "_run_cmd", no_probe)
        for role in (gpu_role(), gpu_role(num_replicas=2, min_replicas=1)):
            script = sched.submit_dryrun(AppDef(name="t", roles=[role]), {}).request.script()
            assert "TPX_TPU_" not in script and "MEGASCALE" not in script

    def test_own_job_dir_registry(self):
        from torchx_tpu_torch.schedulers import slurm_scheduler

        assert slurm_scheduler.SLURM_JOB_DIRS_FILE == ".tpx_torch_slurm_dirs"
        assert slurm_scheduler.SLURM_JOB_DIRS_FILE != jslurm.SLURM_JOB_DIRS_FILE


class TestJaxParity:
    """The same app through both packages' ``submit_dryrun``: equal sbatch
    scripts for CPU roles (but for the elastic script's comment, which names
    a GPU gang); for a GPU role against its TPU twin (``h100-16`` against
    ``v5p-16``, two hosts each) the scripts differ in the GPU ask and the
    accelerator's env names only."""

    @pytest.fixture
    def pair(self, monkeypatch):
        ours, theirs = SlurmScheduler("s"), jslurm.SlurmScheduler("s")
        monkeypatch.setattr(ours, "_run_cmd", no_probe)
        monkeypatch.setattr(theirs, "_run_cmd", no_probe)
        return ours, theirs

    @staticmethod
    def _roles(**kw):
        kw = {"name": "trainer", "image": "/shared/job", "entrypoint": "python",
              "args": ["-m", "train", f"--id={macros.app_id}",
                       f"--r={macros.replica_id}", "--msg=a b\"c$d"], **kw}
        res = dict(cpu=16, memMB=2000, capabilities={"slurm.constraint": "a100"})
        return (Role(resource=Resource(**res), **kw),
                japi.Role(resource=japi.Resource(**res), **kw))

    @pytest.mark.parametrize("role_kw, cfg", [
        ({}, {}),
        ({"num_replicas": 3, "max_retries": 2, "env": {"K": "v $X"}},
         {"partition": "p1", "time": "1:00:00", "comment": "c"}),
        ({"num_replicas": 4, "min_replicas": 2, "max_retries": 1}, {"nomem": True}),
    ])
    def test_cpu_scripts_equal_jax(self, pair, role_kw, cfg):
        ours, theirs = pair
        trole, jrole = self._roles(**role_kw)
        other_t, other_j = self._roles(name="reader")
        roles = ([trole], [jrole]) if "min_replicas" in role_kw else \
            ([trole, other_t], [jrole, other_j])
        mine = ours.submit_dryrun(AppDef(name="t", roles=roles[0]), cfg).request
        want = theirs.submit_dryrun(japi.AppDef(name="t", roles=roles[1]), cfg).request
        assert mine.cmd == want.cmd
        # the elastic script's comment names the port's gang
        assert mine.script() == want.script().replace("# range; a TPU gang", "# range; a GPU gang")
        assert (mine.elastic_range, mine.max_retries) == (want.elastic_range, want.max_retries)

    @pytest.mark.parametrize("elastic", [False, True])
    def test_gpu_twin_differs_in_the_ask_only(self, pair, elastic):
        ours, theirs = pair
        kw = {"num_replicas": 2, "min_replicas": 1} if elastic else {}
        trole = gpu_role(**kw)
        jrole = japi.Role(name=trole.name, image=trole.image, entrypoint=trole.entrypoint,
                          args=list(trole.args),
                          resource=japi.Resource(cpu=208, memMB=1000,
                                                 tpu=japi.TpuSlice("v5p", 8)), **kw)
        mine = ours.submit_dryrun(AppDef(name="t", roles=[trole]), {}).request.script()
        want = theirs.submit_dryrun(japi.AppDef(name="t", roles=[jrole]), {}).request.script()
        assert mine.count("--gpus-per-node=8") == (1 if elastic else 2)
        groups = 1 if elastic else 2
        assert mine.count('TPX_GPU_ACCELERATOR_TYPE="h100-16"') == groups
        assert mine.count('TPX_GPU_TOPOLOGY="2x8"') == groups
        assert want.count('TPX_TPU_ACCELERATOR_TYPE="v5p-16"') == groups
        accel = re.compile(r'TPX_(GPU|TPU)_\w+="[^"]*" ?')
        strip = accel.sub("", mine.replace("#SBATCH --gpus-per-node=8\n", ""))
        want = accel.sub("", want.replace("# range; a TPU gang", "# range; a GPU gang"))
        assert strip == want
