"""The port's GCP Batch backend
(``torchx_tpu_torch.schedulers.gcp_batch_scheduler``): every case of
``tests/test_gcp_batch_scheduler.py`` run against the copy, on the
materialized Batch job config and a lifecycle driven with canned gcloud
output. Its TPU slices are written as H100 slices: a host of ``n`` cards
is an ``a3-highgpu-{n}g`` VM with ``nvidia-h100-80gb`` x ``n`` asked for and
the drivers installed by Batch, in place of the TPU-VM machine families;
and the copy is held to the JAX package's backend on the same app
(``TestJaxParity``). The scope registries live under ``tmp_path``."""

import json
import subprocess
from unittest import mock

import pytest

from torchx_tpu_torch.schedulers.gcp_batch_scheduler import (
    GCPBatchOpts,
    GCPBatchScheduler,
    app_to_batch_job,
    describe_batch_job,
    role_to_task_group,
)
from torchx_tpu_torch.specs.api import (
    AppDef,
    AppState,
    Resource,
    Role,
    GpuSlice,
    macros,
)


@pytest.fixture(autouse=True)
def _isolated_scopes(tmp_path, monkeypatch):
    """Point the durable scope registry at tmp so tests never touch ~, and
    start each case with fresh control-plane breakers."""
    from torchx_tpu_torch.resilience import call as resilience_call
    from torchx_tpu_torch.resilience import faults as resilience_faults
    from torchx_tpu_torch.schedulers import gcp_batch_scheduler as mod

    resilience_call.reset_breakers()
    resilience_faults.reset()

    monkeypatch.setattr(
        mod, "_scopes_path", lambda: str(tmp_path / "scopes")
    )
    monkeypatch.setattr(
        mod, "_fails_path", lambda: str(tmp_path / "scope_fails")
    )


def gpu_role(gpus=16, num_replicas=1, **kwargs) -> Role:
    return Role(
        name="trainer",
        image="gcr.io/proj/img:1",
        entrypoint="python",
        args=["-m", "train", f"--replica={macros.replica_id}"],
        num_replicas=num_replicas,
        resource=Resource(
            cpu=208, memMB=448 * 1024, gpu=GpuSlice("h100", gpus)
        ),
        **kwargs,
    )


def cpu_role(**kwargs) -> Role:
    defaults = dict(
        name="reader",
        image="",
        entrypoint="sh",
        args=["-c", "echo hi"],
        num_replicas=2,
        resource=Resource(cpu=2, memMB=4096),
    )
    defaults.update(kwargs)
    return Role(**defaults)


class TestMaterialization:
    def test_gpu_role_task_group(self):
        group = role_to_task_group(gpu_role(), "app-1")
        # h100-16 = 2 hosts of 8, one task per VM, gang parallelism
        assert group["taskCount"] == 2
        assert group["parallelism"] == 2
        assert group["taskCountPerNode"] == 1
        assert group["requireHostsFile"] is True
        (runnable,) = group["taskSpec"]["runnables"]
        script = runnable["container"]["commands"][1]
        assert "export TPX_NUM_REPLICAS=2" in script
        assert 'TPX_REPLICA_ID="${BATCH_TASK_INDEX:-0}"' in script
        assert "cloudbatch-taskgroup-hosts" in script  # coordinator source
        # the replica-id macro rides the exported env var, double-quoted so
        # the shell expands it at runtime
        assert '"--replica=$TPX_REPLICA_ID"' in script

    def test_container_runnable_mounts_hosts_file(self):
        group = role_to_task_group(gpu_role(), "app-1")
        (runnable,) = group["taskSpec"]["runnables"]
        assert runnable["container"]["imageUri"] == "gcr.io/proj/img:1"
        assert (
            "/etc/cloudbatch-taskgroup-hosts:/etc/cloudbatch-taskgroup-hosts:ro"
            in runnable["container"]["volumes"]
        )

    def test_imageless_role_uses_script_runnable(self):
        group = role_to_task_group(cpu_role(), "app-1")
        (runnable,) = group["taskSpec"]["runnables"]
        assert "script" in runnable
        assert "echo hi" in runnable["script"]["text"]

    def test_cpu_role_compute_resource(self):
        group = role_to_task_group(cpu_role(), "app-1")
        assert group["taskSpec"]["computeResource"] == {
            "cpuMilli": 2000,
            "memoryMib": 4096,
        }
        assert group["taskCount"] == 2

    def test_retries(self):
        group = role_to_task_group(cpu_role(max_retries=3), "app-1")
        assert group["taskSpec"]["maxRetryCount"] == 3

    def test_multislice_hosts(self):
        group = role_to_task_group(gpu_role(num_replicas=2), "app-1")
        assert group["taskCount"] == 4  # 2 slices x 2 hosts

    def test_gpu_machine_type_single_host(self):
        # h100-8 fits on one host: the 8-GPU A3 VM, its cards, its drivers
        cfg = app_to_batch_job(
            AppDef(name="a", roles=[gpu_role(gpus=8)]),
            "app-1",
            GCPBatchOpts(),
        )
        (inst,) = cfg["allocationPolicy"]["instances"]
        assert inst == {
            "policy": {
                "machineType": "a3-highgpu-8g",
                "accelerators": [{"type": "nvidia-h100-80gb", "count": 8}],
            },
            "installGpuDrivers": True,
        }

    @pytest.mark.parametrize(
        "gpus, machine_type, per_host",
        [
            (1, "a3-highgpu-1g", 1),
            (2, "a3-highgpu-2g", 2),
            (4, "a3-highgpu-4g", 4),
            (16, "a3-highgpu-8g", 8),  # multi-host = 8-GPU VMs
            (64, "a3-highgpu-8g", 8),
        ],
    )
    def test_gpu_machine_type_geometry(self, gpus, machine_type, per_host):
        cfg = app_to_batch_job(
            AppDef(name="a", roles=[gpu_role(gpus=gpus)]),
            "app-1",
            GCPBatchOpts(),
        )
        (inst,) = cfg["allocationPolicy"]["instances"]
        assert inst["policy"]["machineType"] == machine_type
        assert inst["policy"]["accelerators"] == [
            {"type": "nvidia-h100-80gb", "count": per_host}]
        assert cfg["taskGroups"][0]["taskCount"] == max(1, gpus // 8)

    def test_unknown_accelerator_raises(self):
        # h100-3 is a valid slice but no A3 machine carries 3 cards
        with pytest.raises(ValueError, match="no h100 machine type carries 3 GPUs"):
            app_to_batch_job(
                AppDef(name="a", roles=[gpu_role(gpus=3)]),
                "app-1",
                GCPBatchOpts(),
            )

    def test_cpu_machine_type_from_opts(self):
        cfg = app_to_batch_job(
            AppDef(name="a", roles=[cpu_role()]),
            "app-1",
            GCPBatchOpts(machine_type="n2-standard-8"),
        )
        (inst,) = cfg["allocationPolicy"]["instances"]
        assert inst["policy"]["machineType"] == "n2-standard-8"

    def test_labels_and_logging(self):
        cfg = app_to_batch_job(
            AppDef(name="a", roles=[cpu_role()]), "app-1", GCPBatchOpts()
        )
        assert cfg["labels"]["tpx-app-name"] == "app-1"
        assert cfg["labels"]["tpx-role-name"] == "reader"
        assert cfg["logsPolicy"]["destination"] == "CLOUD_LOGGING"

    def test_multi_role_rejected(self):
        # the Batch API takes exactly one taskGroup per job
        with pytest.raises(ValueError, match="single-role"):
            app_to_batch_job(
                AppDef(name="a", roles=[gpu_role(), cpu_role()]),
                "app-1",
                GCPBatchOpts(),
            )


class TestDescribeMapping:
    def test_running_with_counts(self):
        payload = {
            "status": {
                "state": "RUNNING",
                "taskGroups": {
                    "group0": {"counts": {"RUNNING": 3, "SUCCEEDED": 1}}
                },
            }
        }
        resp = describe_batch_job("loc:app", payload, ["trainer"])
        assert resp.state == AppState.RUNNING
        (rs,) = resp.roles_statuses
        states = sorted(r.state.name for r in rs.replicas)
        assert states == ["RUNNING", "RUNNING", "RUNNING", "SUCCEEDED"]

    def test_malformed_payload_never_crashes(self):
        resp = describe_batch_job(
            "loc:app",
            {"status": {"state": "FAILED", "taskGroups": {"group0": {"counts": {"FAILED": "x"}}}}},
            ["w"],
        )
        assert resp.state == AppState.FAILED
        (rs,) = resp.roles_statuses
        assert rs.replicas == []

    def test_empty_payload(self):
        resp = describe_batch_job("loc:app", {}, ["w"])
        assert resp.state == AppState.UNKNOWN


def proc(rc=0, stdout="", stderr=""):
    return subprocess.CompletedProcess([], rc, stdout=stdout, stderr=stderr)


class TestLifecycle:
    def _sched(self, run_cmd):
        sched = GCPBatchScheduler("test")
        sched._run_cmd = run_cmd
        return sched

    def test_schedule_submits_config_on_stdin(self):
        calls = []

        def run_cmd(cmd, **kwargs):
            calls.append((cmd, kwargs))
            return proc()

        sched = self._sched(run_cmd)
        app = AppDef(name="train", roles=[cpu_role()])
        info = sched.submit_dryrun(app, {"location": "us-east1"})
        app_id = sched.schedule(info)
        assert app_id.startswith("us-east1:train-")
        (cmd, kwargs) = calls[0]
        assert cmd[:4] == ["gcloud", "batch", "jobs", "submit"]
        assert "--location" in cmd and "us-east1" in cmd
        config = json.loads(kwargs["input"])
        assert config["taskGroups"][0]["taskCount"] == 2

    def test_schedule_failure_raises(self):
        sched = self._sched(lambda cmd, **kw: proc(rc=1, stderr="quota"))
        info = sched.submit_dryrun(AppDef(name="t", roles=[cpu_role()]), {})
        with pytest.raises(RuntimeError, match="quota"):
            sched.schedule(info)

    def test_describe_parses_state(self):
        payload = json.dumps(
            {
                "taskGroups": [{}],
                "labels": {"tpx-role-name": "trainer"},
                "status": {
                    "state": "SUCCEEDED",
                    "taskGroups": {"group0": {"counts": {"SUCCEEDED": 2}}},
                },
            }
        )
        sched = self._sched(lambda cmd, **kw: proc(stdout=payload))
        resp = sched.describe("us-central1:app-1")
        assert resp.state == AppState.SUCCEEDED
        # the real role name is recovered from the job label
        (rs,) = resp.roles_statuses
        assert rs.role == "trainer"

    def test_project_qualified_app_id_routes_project(self):
        calls = []

        def run_cmd(cmd, **kwargs):
            calls.append(cmd)
            return proc()

        sched = self._sched(run_cmd)
        app = AppDef(name="train", roles=[cpu_role()])
        info = sched.submit_dryrun(
            app, {"location": "us-east1", "project": "my-proj"}
        )
        app_id = sched.schedule(info)
        assert app_id.startswith("my-proj:us-east1:train-")
        sched.delete(app_id)
        delete_cmd = calls[-1]
        assert "--project" in delete_cmd and "my-proj" in delete_cmd

    def test_describe_missing_returns_none(self):
        sched = self._sched(lambda cmd, **kw: proc(rc=1, stderr="NOT_FOUND"))
        assert sched.describe("us-central1:gone") is None

    def test_list(self):
        payload = json.dumps(
            [
                {
                    "name": "projects/p/locations/l/jobs/app-1",
                    "status": {"state": "RUNNING"},
                }
            ]
        )
        sched = self._sched(
            lambda cmd, **kw: proc(
                stdout="(unset)" if "config" in cmd else payload
            )
        )
        (item,) = sched.list()
        assert item.name == "app-1"
        assert item.state == AppState.RUNNING

    def test_list_scoped_to_session_cfg(self):
        # jobs submitted with an explicit project/location must stay visible
        # to list(), and listed ids must carry the project prefix so later
        # describe/cancel target the same project
        payload = json.dumps(
            [
                {
                    "name": "projects/my-proj/locations/eu-west4/jobs/app-1",
                    "status": {"state": "RUNNING"},
                }
            ]
        )
        calls = []

        def run_cmd(cmd, **kwargs):
            calls.append(cmd)
            if "config" in cmd:
                return proc(stdout="(unset)")
            return proc(stdout=payload if "list" in cmd else "{}")

        sched = self._sched(run_cmd)
        info = sched.submit_dryrun(
            AppDef(name="t", roles=[cpu_role()]),
            {"location": "eu-west4", "project": "my-proj"},
        )
        sched.schedule(info)  # list() scopes to SUBMITTED cfg, not dryruns
        (item,) = sched.list()
        assert item.app_id == "my-proj:eu-west4:app-1"
        list_cmd = calls[-1]
        assert "--project" in list_cmd and "my-proj" in list_cmd
        assert "--location" in list_cmd and "eu-west4" in list_cmd

    def test_list_scope_survives_fresh_process(self):
        # the scope registry is durable: a NEW scheduler instance (fresh
        # CLI process) must still query the explicit project a job was
        # submitted to, instead of the gcloud default
        payload = json.dumps(
            [
                {
                    "name": "projects/my-proj/locations/eu-west4/jobs/app-1",
                    "status": {"state": "RUNNING"},
                }
            ]
        )
        submitter = self._sched(lambda cmd, **kw: proc(stdout="{}"))
        info = submitter.submit_dryrun(
            AppDef(name="t", roles=[cpu_role()]),
            {"location": "eu-west4", "project": "my-proj"},
        )
        submitter.schedule(info)

        calls = []

        def run_cmd(cmd, **kwargs):
            calls.append(cmd)
            return proc(stdout=payload if "list" in cmd else "")

        fresh = self._sched(run_cmd)  # no _session_opts
        (item,) = fresh.list()
        assert item.app_id == "my-proj:eu-west4:app-1"
        list_cmd = calls[-1]
        assert "--project" in list_cmd and "my-proj" in list_cmd
        assert "--location" in list_cmd and "eu-west4" in list_cmd

    def test_list_evicts_scope_after_repeated_failures(self):
        """A registered scope whose gcloud calls keep failing (revoked /
        deleted project) must stop adding a failing subprocess to every
        list() — evicted after 3 unbroken failures (advisor r4)."""
        submitter = self._sched(lambda cmd, **kw: proc(stdout="{}"))
        info = submitter.submit_dryrun(
            AppDef(name="t", roles=[cpu_role()]),
            {"location": "eu-west4", "project": "dead-proj"},
        )
        submitter.schedule(info)

        calls = []

        def failing(cmd, **kwargs):
            calls.append(cmd)
            if "config" in cmd:
                return proc(stdout="(unset)")
            return proc(rc=1, stderr="PERMISSION_DENIED")

        fresh = self._sched(failing)
        for _ in range(3):
            fresh.list()
        dead_before = sum(
            1 for c in calls if "list" in c and "dead-proj" in c
        )
        assert dead_before == 3
        fresh.list()  # 4th: evicted — the dead scope is never queried
        # (list() may still fall back to the DEFAULT scope, which is fine:
        # the advisor's complaint was the dead scope's eternal failure)
        assert (
            sum(1 for c in calls if "list" in c and "dead-proj" in c)
            == dead_before
        )

    def test_successful_submit_unevicts_scope(self):
        from torchx_tpu_torch.schedulers import gcp_batch_scheduler as mod

        for _ in range(mod.SCOPE_EVICT_FAILURES):
            mod._note_scope_result("dead-proj", "eu-west4", ok=False)
        assert ("dead-proj", "eu-west4") in mod._evicted_scopes()
        sched = self._sched(lambda cmd, **kw: proc(stdout="{}"))
        info = sched.submit_dryrun(
            AppDef(name="t", roles=[cpu_role()]),
            {"location": "eu-west4", "project": "dead-proj"},
        )
        sched.schedule(info)
        assert ("dead-proj", "eu-west4") not in mod._evicted_scopes()

    def test_list_unions_scopes_dedup(self):
        # session scope == registered scope: one gcloud call, no dup rows
        payload = json.dumps(
            [
                {
                    "name": "projects/my-proj/locations/eu-west4/jobs/app-1",
                    "status": {"state": "RUNNING"},
                }
            ]
        )
        calls = []

        def run_cmd(cmd, **kwargs):
            calls.append(cmd)
            if "config" in cmd:
                return proc(stdout="(unset)")
            return proc(stdout=payload if "list" in cmd else "{}")

        sched = self._sched(run_cmd)
        info = sched.submit_dryrun(
            AppDef(name="t", roles=[cpu_role()]),
            {"location": "eu-west4", "project": "my-proj"},
        )
        sched.schedule(info)
        items = sched.list()
        assert [i.app_id for i in items] == ["my-proj:eu-west4:app-1"]
        assert sum(1 for c in calls if "list" in c) == 1

    def test_list_keeps_default_project_jobs_with_explicit_scope(self):
        # a default-project job (submitted via raw gcloud) must not vanish
        # from list() once an explicit-project scope is registered
        explicit = json.dumps(
            [
                {
                    "name": "projects/my-proj/locations/eu-west4/jobs/app-1",
                    "status": {"state": "RUNNING"},
                }
            ]
        )
        default = json.dumps(
            [
                {
                    "name": "projects/dflt/locations/us-central1/jobs/raw-1",
                    "status": {"state": "RUNNING"},
                }
            ]
        )

        def run_cmd(cmd, **kwargs):
            if "config" in cmd:
                return proc(stdout="dflt\n")
            if "list" in cmd:
                return proc(
                    stdout=explicit if "my-proj" in cmd else default
                )
            return proc(stdout="{}")

        sched = self._sched(run_cmd)
        info = sched.submit_dryrun(
            AppDef(name="t", roles=[cpu_role()]),
            {"location": "eu-west4", "project": "my-proj"},
        )
        sched.schedule(info)
        ids = {i.app_id for i in sched.list()}
        assert ids == {"my-proj:eu-west4:app-1", "dflt:us-central1:raw-1"}

    def test_list_no_duplicates_when_default_equals_explicit(self):
        # scope recorded as resolved default + session None-project scope
        # must collapse to ONE query/row, not duplicate prefixless ids
        payload = json.dumps(
            [
                {
                    "name": "projects/dflt/locations/us-central1/jobs/j-1",
                    "status": {"state": "RUNNING"},
                }
            ]
        )
        calls = []

        def run_cmd(cmd, **kwargs):
            calls.append(cmd)
            if "config" in cmd:
                return proc(stdout="dflt\n")
            return proc(stdout=payload if "list" in cmd else "{}")

        sched = self._sched(run_cmd)
        info = sched.submit_dryrun(
            AppDef(name="t", roles=[cpu_role()]), {}
        )  # no explicit project: scope records the RESOLVED default
        sched.schedule(info)
        items = sched.list()
        assert [i.app_id for i in items] == ["dflt:us-central1:j-1"]
        assert sum(1 for c in calls if "list" in c) == 1

    def test_list_falls_back_to_gcloud_project(self):
        # no session cfg: list() asks gcloud for the configured project
        jobs = json.dumps(
            [{"name": "projects/p/locations/l/jobs/j-1", "status": {"state": "QUEUED"}}]
        )

        def run_cmd(cmd, **kwargs):
            if "config" in cmd:
                return proc(stdout="cfg-proj\n")
            return proc(stdout=jobs)

        sched = self._sched(run_cmd)
        (item,) = sched.list()
        assert item.app_id == "cfg-proj:us-central1:j-1"

    def test_cancel_falls_back_to_delete(self):
        calls = []

        def run_cmd(cmd, **kwargs):
            calls.append(cmd)
            # `cancel` unsupported on this gcloud -> rc 2, then delete ok
            return proc(rc=2 if "cancel" in cmd else 0, stdout="{}")

        sched = self._sched(run_cmd)
        # exists() check hits describe first; feed it a running job
        sched.describe = lambda app_id: describe_batch_job(
            app_id, {"status": {"state": "RUNNING"}}, ["w"]
        )
        sched.cancel("us-central1:app-1")
        assert any("cancel" in c for c in calls)
        assert any("delete" in c for c in calls)

    def test_invalid_app_id(self):
        sched = self._sched(lambda cmd, **kw: proc())
        with pytest.raises(ValueError, match="location:name"):
            sched.describe("nocolon")
        with pytest.raises(ValueError, match="location:name"):
            sched.describe("a:b:c:d")

    def test_log_iter_filters_on_server_uid(self):
        entries = json.dumps(
            [{"textPayload": "step 1\n"}, {"textPayload": "step 2 done\n"}]
        )
        calls = []

        def run_cmd(cmd, **kwargs):
            calls.append(cmd)
            if "describe" in cmd:
                # Batch stamps logs with the server-generated UID
                return proc(stdout=json.dumps({"uid": "app-1-7f3e0d"}))
            return proc(stdout=entries)

        sched = self._sched(run_cmd)
        lines = list(sched.log_iter("us-central1:app-1", "w", 1, regex="done"))
        assert lines == ["step 2 done"]
        read_cmd = calls[-1]
        assert read_cmd[:3] == ["gcloud", "logging", "read"]
        assert 'labels.job_uid="app-1-7f3e0d"' in read_cmd[3]
        assert 'labels.task_index="1"' in read_cmd[3]

    def test_log_iter_uid_fallback_when_describe_fails(self):
        calls = []

        def run_cmd(cmd, **kwargs):
            calls.append(cmd)
            if "describe" in cmd:
                return proc(rc=1, stderr="gone")
            return proc(stdout="[]")

        sched = self._sched(run_cmd)
        list(sched.log_iter("us-central1:app-1", "w", 0))
        assert 'labels.job_uid="app-1"' in calls[-1][3]

    def test_log_iter_window_filters(self):
        calls = []

        def run_cmd(cmd, **kwargs):
            calls.append(cmd)
            if "describe" in cmd:
                return proc(stdout=json.dumps({"uid": "u1"}))
            return proc(stdout="[]")

        sched = self._sched(run_cmd)
        # 2026-07-29T00:00:00Z .. +1h
        list(sched.log_iter("us-central1:app-1", "w", 0, since=1785283200.0,
                            until=1785286800.0))
        filt = calls[-1][3]
        assert 'timestamp>="2026-07-29T00:00:00Z"' in filt
        assert 'timestamp<="2026-07-29T01:00:00Z"' in filt

    def test_log_iter_rejects_stream_selection(self):
        from torchx_tpu_torch.schedulers.api import Stream

        sched = self._sched(lambda cmd, **kw: proc())
        with pytest.raises(ValueError, match="combined"):
            sched.log_iter("us-central1:app-1", "w", 0, streams=Stream.STDOUT)

    def test_long_app_name_capped_to_63(self):
        sched = self._sched(lambda cmd, **kw: proc())
        app = AppDef(name="x" * 80, roles=[cpu_role()])
        info = sched.submit_dryrun(app, {})
        assert len(info.request.name) <= 60
        labels = info.request.config["labels"]
        assert all(len(v) <= 63 for v in labels.values())


class TestRegistry:
    def test_gcp_batch_registered(self):
        from torchx_tpu_torch.schedulers import get_scheduler_factories

        assert "gcp_batch" in get_scheduler_factories()


# =========================================================================
# Parity with the JAX package's backend
# =========================================================================

from torchx_tpu.schedulers import gcp_batch_scheduler as jbatch  # noqa: E402
from torchx_tpu.specs import api as japi  # noqa: E402
from torchx_tpu_torch.schedulers import gcp_batch_scheduler as tbatch  # noqa: E402


class TestJaxParity:
    """The same app through both packages' ``submit_dryrun``, ``make_unique``
    pinned: equal Batch jobs for a CPU role; for a GPU role against its TPU
    twin (``h100-16`` against ``v5p-8``, two hosts each) they differ in the
    instance policy only (the A3 machine, its accelerators and the
    drivers)."""

    @pytest.fixture(autouse=True)
    def _pinned(self, monkeypatch):
        for mod in (tbatch, jbatch):
            monkeypatch.setattr(mod, "make_unique", lambda name: f"{name}-fixed0")

    @staticmethod
    def _dryruns(trole, jrole, cfg):
        ours = GCPBatchScheduler("s", docker_client=mock.MagicMock()).submit_dryrun(
            AppDef(name="app", roles=[trole]), cfg).request
        theirs = jbatch.GCPBatchScheduler("s", docker_client=mock.MagicMock()).submit_dryrun(
            japi.AppDef(name="app", roles=[jrole]), cfg).request
        return ours, theirs

    @pytest.mark.parametrize("kw, cfg", [
        ({"image": ""}, {}),
        ({"image": "gcr.io/p/i:1", "max_retries": 2, "env": {"K": "v $X"}},
         {"project": "p", "location": "eu-west4", "machine_type": "n2-standard-16"}),
    ])
    def test_cpu_job_equal_jax(self, kw, cfg):
        kw = {"name": "reader", "entrypoint": "sh", "num_replicas": 3,
              "args": ["-c", f"echo {macros.replica_id} of {macros.num_replicas}"], **kw}
        ours, theirs = self._dryruns(Role(resource=Resource(cpu=4, memMB=8192), **kw),
                                     japi.Role(resource=japi.Resource(cpu=4, memMB=8192), **kw),
                                     cfg)
        assert (ours.name, ours.location, ours.project, ours.config) == \
            (theirs.name, theirs.location, theirs.project, theirs.config)

    def test_gpu_twin_differs_in_the_instance_only(self):
        kw = {"name": "trainer", "image": "gcr.io/p/i:1", "entrypoint": "python",
              "args": ["-m", "train", f"--r={macros.replica_id}"]}
        ours, theirs = self._dryruns(
            Role(resource=Resource(cpu=200, memMB=1000, gpu=GpuSlice("h100", 16)), **kw),
            japi.Role(resource=japi.Resource(cpu=200, memMB=1000,
                                             tpu=japi.TpuSlice("v5p", 8)), **kw), {})
        (mine,) = ours.config["allocationPolicy"].pop("instances")
        (want,) = theirs.config["allocationPolicy"].pop("instances")
        assert want == {"policy": {"machineType": "ct5p-hightpu-4t"}}
        assert mine == {"policy": {"machineType": "a3-highgpu-8g", "accelerators": [
            {"type": "nvidia-h100-80gb", "count": 8}]}, "installGpuDrivers": True}
        assert ours.config == theirs.config
        assert "hightpu" not in str(ours.config)

    def test_own_scope_files(self):
        assert (tbatch.GCP_BATCH_SCOPES_FILE, tbatch.GCP_BATCH_SCOPE_FAILS_FILE) == \
            (".tpx_torch_gcp_batch_scopes", ".tpx_torch_gcp_batch_scope_fails")
        assert tbatch.GCP_BATCH_SCOPES_FILE != jbatch.GCP_BATCH_SCOPES_FILE
