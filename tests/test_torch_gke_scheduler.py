"""The port's GKE backend (``torchx_tpu_torch.schedulers.gke_scheduler``):
every case of ``tests/test_gke_scheduler.py`` run against the copy on the
materialized JobSet dict, with no cluster. Its TPU slices are written as
H100 slices (``h100-16``: two hosts of eight): an Indexed Job over the
slice's hosts, ``nvidia.com/gpu`` cards a host, the
``cloud.google.com/gke-accelerator`` pool and GKE's ``nvidia.com/gpu``
taint; its multi-slice cases read ``TPX_NUM_SLICES`` where the JAX ones
read ``MEGASCALE_NUM_SLICES`` (the DCN wiring is not copied); the JobSet
fixtures are read from that file's own ``tests/fixtures``. Then the spot
and maintenance classification against GPU node-pool pod conditions, and
the copy held to the JAX package's backend on the same app
(``TestJaxParity``)."""

import pytest
from unittest import mock

from torchx_tpu_torch.schedulers.api import DescribeAppResponse
from torchx_tpu_torch.schedulers.gke_scheduler import (
    GKEScheduler,
    app_to_jobset,
    describe_jobset,
    jobset_state,
    sanitize_name,
)
from torchx_tpu_torch.specs.api import (
    AppDef,
    AppState,
    Resource,
    Role,
    GpuSlice,
    VolumeMount,
    macros,
)
from torchx_tpu_torch.specs.overlays import DEL, PUT, set_overlay


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


@pytest.fixture(autouse=True)
def _breakers():
    """Fresh control-plane breakers: a case's failing fake calls must not
    open the gke breaker for the next case."""
    from torchx_tpu_torch.resilience import call as resilience_call
    from torchx_tpu_torch.resilience import faults as resilience_faults

    resilience_call.reset_breakers()
    resilience_faults.reset()


def make_jobset(app, **kwargs):
    defaults = dict(
        app_name="app-x", namespace="default", queue=None, service_account=None
    )
    defaults.update(kwargs)
    return app_to_jobset(app, **defaults)


class TestJobSetMaterialization:
    def test_gpu_role_indexed_job(self):
        js = make_jobset(AppDef(name="a", roles=[gpu_role()]))
        assert js["kind"] == "JobSet"
        (rj,) = js["spec"]["replicatedJobs"]
        assert rj["name"] == "trainer"
        assert rj["replicas"] == 1
        spec = rj["template"]["spec"]
        # h100-16: 16 cards -> 2 hosts of 8
        assert spec["parallelism"] == 2 and spec["completions"] == 2
        assert spec["completionMode"] == "Indexed"
        assert spec["backoffLimit"] == 0

    def test_gpu_node_selectors_and_limits(self):
        js = make_jobset(AppDef(name="a", roles=[gpu_role()]))
        pod = js["spec"]["replicatedJobs"][0]["template"]["spec"]["template"]
        assert pod["spec"]["nodeSelector"] == {
            "cloud.google.com/gke-accelerator": "nvidia-h100-80gb"}
        container = pod["spec"]["containers"][0]
        assert container["resources"]["limits"]["nvidia.com/gpu"] == 8
        assert container["resources"]["requests"]["nvidia.com/gpu"] == 8
        assert pod["spec"]["tolerations"] == [
            {"key": "nvidia.com/gpu", "operator": "Exists", "effect": "NoSchedule"}]

    # An a3-highgpu-8g node pool is nodes of 8 H100s: the JobSet must ask
    # for one pod a host with nvidia.com/gpu: <cards a host>, or it can
    # never schedule.
    @pytest.mark.parametrize(
        "gpus, hosts, gpu_limit, topology",
        [
            (1, 1, 1, "1x1"),
            (4, 1, 4, "1x4"),
            (8, 1, 8, "1x8"),
            (16, 2, 8, "2x8"),
            (32, 4, 8, "4x8"),
        ],
    )
    def test_h100_geometry(self, gpus, hosts, gpu_limit, topology):
        js = make_jobset(AppDef(name="a", roles=[gpu_role(gpus=gpus)]))
        (rj,) = js["spec"]["replicatedJobs"]
        spec = rj["template"]["spec"]
        assert spec["parallelism"] == hosts and spec["completions"] == hosts
        pod = spec["template"]["spec"]
        sel = pod["nodeSelector"]
        assert sel["cloud.google.com/gke-accelerator"] == "nvidia-h100-80gb"
        limits = pod["containers"][0]["resources"]["limits"]
        assert limits["nvidia.com/gpu"] == gpu_limit
        env = {e["name"]: e.get("value") for e in pod["containers"][0]["env"]}
        assert env["TPX_GPU_TOPOLOGY"] == topology
        assert env["TPX_GPU_ACCELERATOR_TYPE"] == f"h100-{gpus}"

    def test_replica_id_via_completion_index(self):
        js = make_jobset(AppDef(name="a", roles=[gpu_role()]))
        container = js["spec"]["replicatedJobs"][0]["template"]["spec"]["template"][
            "spec"
        ]["containers"][0]
        env = {e["name"]: e for e in container["env"]}
        assert env["TPX_REPLICA_ID"]["value"] == "$(JOB_COMPLETION_INDEX)"
        assert env["JOB_COMPLETION_INDEX"]["valueFrom"]["fieldRef"][
            "fieldPath"
        ].endswith("job-completion-index']")
        # macro in args resolves to the env reference, expanded by kubelet
        assert "--replica=$(TPX_REPLICA_ID)" in container["command"]

    def test_coordinator_dns(self):
        js = make_jobset(AppDef(name="a", roles=[gpu_role()]))
        container = js["spec"]["replicatedJobs"][0]["template"]["spec"]["template"][
            "spec"
        ]["containers"][0]
        env = {e["name"]: e.get("value") for e in container["env"]}
        assert env["TPX_COORDINATOR_HOST"] == "app-x-trainer-0-0.app-x"
        assert env["TPX_NUM_REPLICAS"] == "2"

    def test_multislice(self):
        js = make_jobset(AppDef(name="a", roles=[gpu_role(num_replicas=2)]))
        (rj,) = js["spec"]["replicatedJobs"]
        assert rj["replicas"] == 2  # one Job per slice
        container = rj["template"]["spec"]["template"]["spec"]["containers"][0]
        env = {e["name"]: e.get("value") for e in container["env"]}
        assert env["TPX_NUM_SLICES"] == "2"
        assert not [k for k in env if k.startswith("MEGASCALE")]

    def test_multislice_global_gang_identity(self):
        """All slices form ONE torch.distributed world: global world size,
        slice decomposition from the JobSet job index, one coordinator."""
        js = make_jobset(AppDef(name="a", roles=[gpu_role(num_replicas=2)]))
        (rj,) = js["spec"]["replicatedJobs"]
        container = rj["template"]["spec"]["template"]["spec"]["containers"][0]
        env = {e["name"]: e for e in container["env"]}
        # h100-16 -> 2 hosts/slice, 2 slices -> world of 4 processes
        assert env["TPX_NUM_REPLICAS"]["value"] == "4"
        # the global id is derived at bootstrap from the decomposition;
        # the pod template must NOT pin a per-slice TPX_REPLICA_ID
        assert "TPX_REPLICA_ID" not in env
        assert env["TPX_SLICE_ID"]["value"] == "$(JOB_INDEX)"
        assert env["TPX_HOST_ID"]["value"] == "$(JOB_COMPLETION_INDEX)"
        assert env["TPX_HOSTS_PER_SLICE"]["value"] == "2"
        assert env["JOB_INDEX"]["valueFrom"]["fieldRef"]["fieldPath"].endswith(
            "jobset.sigs.k8s.io/job-index']"
        )
        # every slice points at the same coordinator (slice 0 host 0), and
        # no second coordinator is wired for a data-center network
        assert env["TPX_COORDINATOR_HOST"]["value"] == "app-x-trainer-0-0.app-x"
        assert not [k for k in env if k.startswith("MEGASCALE")]
        # an AppDef "replica" is a slice: the macro resolves to the slice id
        assert "--replica=$(TPX_SLICE_ID)" in container["command"]

    def test_gang_info_derives_global_id_from_decomposition(self, monkeypatch):
        from torchx_tpu_torch.distributed import gang_info

        monkeypatch.delenv("TPX_REPLICA_ID", raising=False)
        monkeypatch.setenv("TPX_SLICE_ID", "1")
        monkeypatch.setenv("TPX_HOST_ID", "2")
        monkeypatch.setenv("TPX_HOSTS_PER_SLICE", "4")
        monkeypatch.setenv("TPX_NUM_REPLICAS", "8")
        monkeypatch.setenv("TPX_COORDINATOR_HOST", "h0")
        assert gang_info() == (6, 8, "h0")
        # an explicit global id always wins over the decomposition
        monkeypatch.setenv("TPX_REPLICA_ID", "5")
        assert gang_info() == (5, 8, "h0")

    def test_min_replicas_elastic_mapping(self):
        # CPU role: Kueue partial admission on the child Job
        role = Role(
            name="reader",
            image="img",
            entrypoint="python",
            num_replicas=4,
            min_replicas=2,
            resource=Resource(cpu=2, memMB=4096),
        )
        js = make_jobset(AppDef(name="a", roles=[role]))
        (rj,) = js["spec"]["replicatedJobs"]
        ann = rj["template"]["metadata"]["annotations"]
        assert ann["kueue.x-k8s.io/job-min-parallelism"] == "2"
        assert ann["tpx.sh/min-replicas"] == "2"
        container = rj["template"]["spec"]["template"]["spec"]["containers"][0]
        env = {e["name"]: e.get("value") for e in container["env"]}
        assert env["TPX_MIN_REPLICAS"] == "2"

        # GPU slice role: no Job-level partial admission (JobSet children), but the
        # floor is surfaced to autoscalers and the in-job bootstrap
        js = make_jobset(
            AppDef(name="a", roles=[gpu_role(num_replicas=2, min_replicas=1)])
        )
        (rj,) = js["spec"]["replicatedJobs"]
        ann = rj["template"]["metadata"]["annotations"]
        assert ann["tpx.sh/min-replicas"] == "1"
        assert "kueue.x-k8s.io/job-min-parallelism" not in ann
        container = rj["template"]["spec"]["template"]["spec"]["containers"][0]
        env = {e["name"]: e.get("value") for e in container["env"]}
        assert env["TPX_MIN_REPLICAS"] == "1"

    def test_cpu_role(self):
        role = Role(
            name="reader",
            image="img",
            entrypoint="python",
            args=["-m", "read"],
            num_replicas=3,
            resource=Resource(cpu=2, memMB=4096),
        )
        js = make_jobset(AppDef(name="a", roles=[role]))
        spec = js["spec"]["replicatedJobs"][0]["template"]["spec"]
        assert spec["completions"] == 3 and spec["parallelism"] == 3
        pod_spec = spec["template"]["spec"]
        assert "nodeSelector" not in pod_spec
        container = pod_spec["containers"][0]
        assert container["resources"]["limits"]["cpu"] == "2000m"
        assert container["resources"]["requests"]["cpu"] == "1900m"  # reserved

    def test_retries_to_failure_policy(self):
        js = make_jobset(AppDef(name="a", roles=[gpu_role(max_retries=3)]))
        assert js["spec"]["failurePolicy"] == {"maxRestarts": 3}

    def test_kueue_queue_suspends(self):
        js = make_jobset(AppDef(name="a", roles=[gpu_role()]), queue="tpu-queue")
        assert js["metadata"]["labels"]["kueue.x-k8s.io/queue-name"] == "tpu-queue"
        assert js["spec"]["suspend"] is True

    def test_volume_mounts(self):
        role = gpu_role(mounts=[VolumeMount(src="ckpts", dst_path="/ckpt")])
        js = make_jobset(AppDef(name="a", roles=[role]))
        pod_spec = js["spec"]["replicatedJobs"][0]["template"]["spec"]["template"][
            "spec"
        ]
        vols = {v["name"]: v for v in pod_spec["volumes"]}
        assert vols["mount-0"]["persistentVolumeClaim"]["claimName"] == "ckpts"
        assert "dshm" in vols  # /dev/shm tmpfs always present

    def test_overlay_applied(self):
        role = gpu_role()
        set_overlay(
            role,
            "gke",
            {
                "metadata": {"labels": {"team": "research"}},
                PUT("apiVersion"): "jobset.x-k8s.io/v1beta1",
            },
        )
        js = make_jobset(AppDef(name="a", roles=[role]))
        assert js["metadata"]["labels"]["team"] == "research"
        assert js["metadata"]["name"] == "app-x"  # merge kept siblings
        assert js["apiVersion"] == "jobset.x-k8s.io/v1beta1"

    def test_sanitize_name(self):
        assert sanitize_name("My Job!") == "my-job"
        long = sanitize_name("x" * 100)
        assert len(long) <= 53
        # truncation must be deterministic: selectors, container names, and
        # coordinator DNS all re-derive the same string
        assert sanitize_name("x" * 100) == long
        # ...and distinct long names must not collide after truncation
        assert sanitize_name("x" * 99) != long

    def test_pod_names_fit_63_chars_multislice(self):
        """JobSet pod names are {jobset}-{job}-{jobIndex}-{podIndex}; with
        worst-case app AND role names plus multi-slice double-digit
        suffixes, every derived pod name must fit the k8s 63-char limit."""
        role = gpu_role(num_replicas=12)  # 2-digit job index
        role.name = "a-very-long-role-name-that-will-be-truncated-somewhere"
        # the scheduler budgets app names to 40 chars (gke_scheduler.py
        # _submit_dryrun) so role + index suffixes fit the 63 cap
        app_name = sanitize_name("overlong-app-name-" + "y" * 80, max_len=40)
        js = app_to_jobset(
            AppDef(name="a", roles=[role]),
            app_name=app_name,
            namespace="default",
            queue=None,
            service_account=None,
        )
        (rj,) = js["spec"]["replicatedJobs"]
        hosts = rj["template"]["spec"]["completions"]
        worst = f"{app_name}-{rj['name']}-{role.num_replicas - 1}-{hosts - 1}"
        assert len(worst) <= 63, worst
        # the coordinator DNS name derives from the same parts
        container = rj["template"]["spec"]["template"]["spec"]["containers"][0]
        env = {e["name"]: e.get("value") for e in container["env"]}
        assert env["TPX_COORDINATOR_HOST"].startswith(f"{app_name}-")
        # the pod label keeps the UN-truncated role name so log/describe can
        # find pods without re-deriving the budgeted replicatedJob name
        labels = rj["template"]["spec"]["template"]["metadata"]["labels"]
        assert labels["tpx.sh/role-name"] == role.name
        assert len(rj["name"]) < len(role.name)  # rj name was budgeted

    def test_app_name_over_budget_raises(self):
        role = gpu_role()
        with pytest.raises(ValueError, match="63-char"):
            app_to_jobset(
                AppDef(name="a", roles=[role]),
                app_name="z" * 60,  # leaves < 8 chars for the role
                namespace="default",
                queue=None,
                service_account=None,
            )


class TestGKESchedulerDryrun:
    def test_submit_dryrun(self):
        sched = GKEScheduler("test", client=object())
        app = AppDef(name="train", roles=[gpu_role()])
        info = sched.submit_dryrun(app, {"namespace": "ml"})
        assert info._scheduler == "gke"
        assert info.request.namespace == "ml"
        assert info.request.resource["kind"] == "JobSet"
        name = info.request.resource["metadata"]["name"]
        assert name.startswith("train-")

    def test_workspace_requires_repo_for_sha(self):
        sched = GKEScheduler("test", client=object())
        role = gpu_role()
        role.image = "sha256:" + "a" * 64
        app = AppDef(name="t", roles=[role])
        with pytest.raises(KeyError):
            sched.submit_dryrun(app, {})

    def test_image_repo_rewrites_sha(self):
        sched = GKEScheduler("test", client=object())
        role = gpu_role()
        role.image = "sha256:" + "a" * 64
        app = AppDef(name="t", roles=[role])
        info = sched.submit_dryrun(app, {"image_repo": "gcr.io/p/r"})
        assert info.request.images_to_push == {
            "sha256:" + "a" * 64: ("gcr.io/p/r", "a" * 12)
        }
        container = info.request.resource["spec"]["replicatedJobs"][0]["template"][
            "spec"
        ]["template"]["spec"]["containers"][0]
        assert container["image"] == "gcr.io/p/r:" + "a" * 12


class TestGKELogPodResolution:
    def _pod(self, name, job_index, completion_index):
        pod = mock.MagicMock()
        pod.metadata.name = name
        pod.metadata.labels = {"jobset.sigs.k8s.io/job-index": str(job_index)}
        pod.metadata.annotations = {
            "batch.kubernetes.io/job-completion-index": str(completion_index)
        }
        return pod

    def test_resolves_kth_replica_across_slices(self):
        sched = GKEScheduler("t", client=object())
        pods = mock.MagicMock()
        # two slices (job index) x two hosts (completion index), random order
        pods.items = [
            self._pod("app-tr-1-1-xyz", 1, 1),
            self._pod("app-tr-0-0-abc", 0, 0),
            self._pod("app-tr-1-0-def", 1, 0),
            self._pod("app-tr-0-1-ghi", 0, 1),
        ]
        core = mock.MagicMock()
        core.list_namespaced_pod.return_value = pods
        with mock.patch.object(sched, "_core_api", return_value=core):
            assert sched._resolve_pod_name("ns", "app", "tr", 0) == "app-tr-0-0-abc"
            # selects by the tpx role label, NOT the replicatedJob name: the
            # rj name may carry a budget-truncation suffix that cannot be
            # recomputed from the role name alone
            core.list_namespaced_pod.assert_called_with(
                namespace="ns",
                label_selector=(
                    "jobset.sigs.k8s.io/jobset-name=app,tpx.sh/role-name=tr"
                ),
            )
            assert sched._resolve_pod_name("ns", "app", "tr", 2) == "app-tr-1-0-def"
            with pytest.raises(ValueError, match="not found"):
                sched._resolve_pod_name("ns", "app", "tr", 4)


class TestJobSetStateMapping:
    def test_completed(self):
        js = {"status": {"conditions": [{"type": "Completed", "status": "True"}]}}
        assert jobset_state(js) == AppState.SUCCEEDED

    def test_failed(self):
        js = {"status": {"conditions": [{"type": "Failed", "status": "True"}]}}
        assert jobset_state(js) == AppState.FAILED

    def test_suspended_spec(self):
        assert jobset_state({"spec": {"suspend": True}, "status": {}}) == AppState.PENDING

    def test_running(self):
        js = {"status": {"replicatedJobsStatus": [{"active": 4}]}}
        assert jobset_state(js) == AppState.RUNNING

    def test_describe_with_pods(self):
        js = {
            "metadata": {"namespace": "default", "name": "app-x"},
            "status": {
                "restarts": 1,
                "replicatedJobsStatus": [{"active": 2}],
            },
        }
        pods = [
            {
                "metadata": {
                    "labels": {"tpx.sh/role-name": "trainer"},
                    "annotations": {"batch.kubernetes.io/job-completion-index": "1"},
                    "name": "app-x-trainer-0-1",
                },
                "status": {"phase": "Running", "podIP": "10.0.0.7"},
            }
        ]
        resp = describe_jobset(js, pods)
        assert isinstance(resp, DescribeAppResponse)
        assert resp.state == AppState.RUNNING
        assert resp.num_restarts == 1
        (rs,) = resp.roles_statuses
        assert rs.replicas[0].id == 1
        assert rs.replicas[0].hostname == "10.0.0.7"


# =========================================================================
# Recorded-fixture tests: degraded/malformed JobSet status payloads
# (reference analog: kubernetes_scheduler_test.py describe fixtures)
# =========================================================================

import json
import os

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


def load_fixture(name: str):
    with open(os.path.join(FIXTURES, name)) as f:
        return json.load(f)


class TestDescribeJobsetFixtures:
    def test_degraded_multislice(self):
        """2-slice JobSet mid-failure: restarts as a string, mixed pod
        phases, a garbage completion-index, and global replica ids folding
        in the slice index."""
        fx = load_fixture("jobset_degraded.json")
        resp = describe_jobset(fx["jobset"], fx["pods"])
        assert resp.state == AppState.RUNNING  # no terminal condition yet
        assert resp.num_restarts == 1  # "1" parsed
        (rs,) = resp.roles_statuses
        pairs = sorted((r.id, r.state) for r in rs.replicas)
        # slice 0 hosts -> ids 0,1; slice 1 hosts -> ids 2,3; the garbage
        # completion-index degrades to host 0 of slice 1 -> a second id 2
        assert pairs == [
            (0, AppState.RUNNING),
            (1, AppState.FAILED),
            (2, AppState.PENDING),
            (2, AppState.RUNNING),
        ]
        hostnames = {r.id: r.hostname for r in rs.replicas if r.state == AppState.RUNNING}
        assert hostnames[0] == "10.0.0.1"  # podIP
        assert hostnames[2] == "10.0.0.3"  # pod_ip variant

    def test_malformed_payload_never_crashes(self):
        """Future/partial payloads: null restarts, unknown condition types,
        condition without type/status, null pod metadata, unknown phase."""
        fx = load_fixture("jobset_malformed.json")
        resp = describe_jobset(fx["jobset"], fx["pods"])
        assert resp.state == AppState.PENDING  # nothing definitive
        assert resp.num_restarts == 0
        roles = {r.role: r for r in resp.roles_statuses}
        assert roles["unknown"].replicas[0].state == AppState.UNKNOWN
        assert roles["w"].replicas[0].state == AppState.SUCCEEDED

    def test_empty_everything(self):
        resp = describe_jobset({}, [])
        assert resp.state == AppState.SUBMITTED
        assert resp.roles_statuses == []


# =========================================================================
# Client lifecycle paths (schedule / describe / cancel / delete / list /
# log_iter) against an injected fake kubernetes module — the reference
# pattern of mock-client tests (kubernetes_scheduler_test.py), no cluster
# =========================================================================

import sys
import types


class _FakeApiException(Exception):
    def __init__(self, status):
        self.status = status


@pytest.fixture
def fake_k8s(monkeypatch):
    """Install a stub `kubernetes` package so the scheduler's deferred
    `from kubernetes.client.rest import ApiException` resolves."""
    root = types.ModuleType("kubernetes")
    client = types.ModuleType("kubernetes.client")
    rest = types.ModuleType("kubernetes.client.rest")
    rest.ApiException = _FakeApiException
    client.rest = rest
    client.BatchV1Api = lambda api: mock.MagicMock()
    root.client = client
    monkeypatch.setitem(sys.modules, "kubernetes", root)
    monkeypatch.setitem(sys.modules, "kubernetes.client", client)
    monkeypatch.setitem(sys.modules, "kubernetes.client.rest", rest)
    return _FakeApiException


class TestGKELifecycle:
    def _sched_with_api(self, monkeypatch, custom=None, core=None):
        sched = GKEScheduler("t", client=object())
        if custom is not None:
            monkeypatch.setattr(sched, "_custom_objects_api", lambda: custom)
        if core is not None:
            monkeypatch.setattr(sched, "_core_api", lambda: core)
        return sched

    def test_schedule_creates_jobset_and_returns_app_id(
        self, monkeypatch, fake_k8s
    ):
        custom = mock.MagicMock()
        sched = self._sched_with_api(monkeypatch, custom=custom)
        app = AppDef(name="train", roles=[gpu_role()])
        info = sched.submit_dryrun(app, {"namespace": "ml"})
        app_id = sched.schedule(info)
        ns, name = app_id.split(":")
        assert ns == "ml" and name.startswith("train-")
        kwargs = custom.create_namespaced_custom_object.call_args.kwargs
        assert kwargs["namespace"] == "ml"
        assert kwargs["plural"] == "jobsets"
        assert kwargs["body"]["kind"] == "JobSet"

    def test_schedule_conflict_raises_value_error(self, monkeypatch, fake_k8s):
        custom = mock.MagicMock()
        custom.create_namespaced_custom_object.side_effect = fake_k8s(409)
        sched = self._sched_with_api(monkeypatch, custom=custom)
        info = sched.submit_dryrun(AppDef(name="t", roles=[gpu_role()]), {})
        with pytest.raises(ValueError, match="already exists"):
            sched.schedule(info)

    def test_schedule_other_api_errors_propagate(self, monkeypatch, fake_k8s):
        custom = mock.MagicMock()
        custom.create_namespaced_custom_object.side_effect = fake_k8s(503)
        sched = self._sched_with_api(monkeypatch, custom=custom)
        info = sched.submit_dryrun(AppDef(name="t", roles=[gpu_role()]), {})
        with pytest.raises(_FakeApiException):
            sched.schedule(info)

    def test_describe_404_returns_none(self, monkeypatch, fake_k8s):
        custom = mock.MagicMock()
        custom.get_namespaced_custom_object.side_effect = fake_k8s(404)
        sched = self._sched_with_api(monkeypatch, custom=custom)
        assert sched.describe("ml:gone") is None

    def test_describe_fetches_jobset_and_pods(self, monkeypatch, fake_k8s):
        custom = mock.MagicMock()
        custom.get_namespaced_custom_object.return_value = {
            "status": {
                "conditions": [{"type": "Completed", "status": "True"}]
            }
        }
        core = mock.MagicMock()
        core.list_namespaced_pod.return_value.items = []
        sched = self._sched_with_api(monkeypatch, custom=custom, core=core)
        resp = sched.describe("ml:app1")
        assert resp.state == AppState.SUCCEEDED
        sel = core.list_namespaced_pod.call_args.kwargs["label_selector"]
        assert sel == "jobset.sigs.k8s.io/jobset-name=app1"

    def test_describe_surfaces_failed_elastic_controller(
        self, monkeypatch, fake_k8s
    ):
        """A controller Job that exhausted its backoffLimit (e.g. OOMKill
        loop) means the app runs WITHOUT elastic protection — `tpx status`
        must say so instead of leaving it to the next slice failure
        (advisor r4)."""
        custom = mock.MagicMock()
        custom.get_namespaced_custom_object.return_value = {"status": {}}
        core = mock.MagicMock()
        core.list_namespaced_pod.return_value.items = []
        sched = self._sched_with_api(monkeypatch, custom=custom, core=core)
        batch = mock.MagicMock()
        cond = types.SimpleNamespace(
            type="Failed", status="True", reason="BackoffLimitExceeded"
        )
        batch.read_namespaced_job.return_value = types.SimpleNamespace(
            status=types.SimpleNamespace(conditions=[cond])
        )
        monkeypatch.setattr(sched, "_batch_api", lambda: batch)
        resp = sched.describe("ml:app1")
        assert "elastic controller FAILED" in resp.msg
        assert "BackoffLimitExceeded" in resp.msg
        name = batch.read_namespaced_job.call_args.kwargs["name"]
        assert name == "app1-tpx-watch"

    def test_describe_healthy_controller_no_note(self, monkeypatch, fake_k8s):
        custom = mock.MagicMock()
        custom.get_namespaced_custom_object.return_value = {"status": {}}
        core = mock.MagicMock()
        core.list_namespaced_pod.return_value.items = []
        sched = self._sched_with_api(monkeypatch, custom=custom, core=core)
        batch = mock.MagicMock()
        batch.read_namespaced_job.return_value = types.SimpleNamespace(
            status=types.SimpleNamespace(conditions=[])
        )
        monkeypatch.setattr(sched, "_batch_api", lambda: batch)
        resp = sched.describe("ml:app1")
        assert resp.msg == ""

    def test_describe_pod_listing_is_best_effort(self, monkeypatch, fake_k8s):
        custom = mock.MagicMock()
        custom.get_namespaced_custom_object.return_value = {"status": {}}
        core = mock.MagicMock()
        core.list_namespaced_pod.side_effect = RuntimeError("rbac denied")
        sched = self._sched_with_api(monkeypatch, custom=custom, core=core)
        assert sched.describe("ml:app1") is not None  # pods degrade to []

    def test_cancel_suspends_preserving_spec(self, monkeypatch, fake_k8s):
        custom = mock.MagicMock()
        # cancel() checks liveness via describe first
        custom.get_namespaced_custom_object.return_value = {
            "status": {"replicatedJobsStatus": [{"name": "r"}]}
        }
        core = mock.MagicMock()
        core.list_namespaced_pod.return_value.items = []
        sched = self._sched_with_api(monkeypatch, custom=custom, core=core)
        sched.cancel("ml:app1")
        kwargs = custom.patch_namespaced_custom_object.call_args.kwargs
        assert kwargs["body"] == {"spec": {"suspend": True}}
        custom.delete_namespaced_custom_object.assert_not_called()

    def test_delete_tolerates_404(self, monkeypatch, fake_k8s):
        custom = mock.MagicMock()
        custom.delete_namespaced_custom_object.side_effect = fake_k8s(404)
        sched = self._sched_with_api(monkeypatch, custom=custom)
        sched.delete("ml:gone")  # no raise

    def test_delete_other_errors_propagate(self, monkeypatch, fake_k8s):
        custom = mock.MagicMock()
        custom.delete_namespaced_custom_object.side_effect = fake_k8s(500)
        sched = self._sched_with_api(monkeypatch, custom=custom)
        with pytest.raises(_FakeApiException):
            sched.delete("ml:app")

    def test_list_cluster_jobsets(self, monkeypatch, fake_k8s):
        custom = mock.MagicMock()
        custom.list_cluster_custom_object.return_value = {
            "items": [
                {
                    "metadata": {"namespace": "ml", "name": "a"},
                    "status": {"replicatedJobsStatus": [{}]},
                },
                {
                    "metadata": {"namespace": "dev", "name": "b"},
                    "spec": {"suspend": True},
                },
            ]
        }
        sched = self._sched_with_api(monkeypatch, custom=custom)
        apps = sched.list()
        assert [(a.app_id, a.state) for a in apps] == [
            ("ml:a", AppState.RUNNING),
            ("dev:b", AppState.PENDING),
        ]

    def test_log_iter_streams_pod_log(self, monkeypatch, fake_k8s):
        core = mock.MagicMock()
        pod = mock.MagicMock()
        pod.metadata.name = "app1-w-0-0-xyz"
        pod.metadata.labels = {}
        pod.metadata.annotations = {}
        core.list_namespaced_pod.return_value.items = [pod]
        core.read_namespaced_pod_log.return_value = [b"l1\n", b"l2 match\n"]
        sched = self._sched_with_api(monkeypatch, core=core)
        lines = list(sched.log_iter("ml:app1", "w", 0, regex="match"))
        assert lines == ["l2 match"]
        kwargs = core.read_namespaced_pod_log.call_args.kwargs
        assert kwargs["name"] == "app1-w-0-0-xyz"
        assert kwargs["follow"] is False

    def test_invalid_app_id(self, monkeypatch, fake_k8s):
        sched = GKEScheduler("t", client=object())
        with pytest.raises(ValueError, match="expected namespace:name"):
            sched.describe("no-colon-here")

    def _log_sched(self, monkeypatch, log_lines):
        core = mock.MagicMock()
        pod = mock.MagicMock()
        pod.metadata.name = "app1-w-0-0-xyz"
        pod.metadata.labels = {}
        pod.metadata.annotations = {}
        core.list_namespaced_pod.return_value.items = [pod]
        core.read_namespaced_pod_log.return_value = log_lines
        return self._sched_with_api(monkeypatch, core=core), core

    def test_log_iter_since_maps_to_since_seconds(self, monkeypatch, fake_k8s):
        import time

        sched, core = self._log_sched(monkeypatch, [b"x\n"])
        list(sched.log_iter("ml:app1", "w", 0, since=time.time() - 120))
        kwargs = core.read_namespaced_pod_log.call_args.kwargs
        assert 115 <= kwargs["since_seconds"] <= 125

    def test_log_iter_until_filters_and_strips_stamps(self, monkeypatch, fake_k8s):
        # kubelet RFC3339Nano stamps; line 3 is past the window
        sched, core = self._log_sched(
            monkeypatch,
            [
                b"2026-07-29T10:00:00.123456789Z first\n",
                b"2026-07-29T10:00:05.000000000Z second\n",
                b"2026-07-29T10:30:00.000000000Z too late\n",
            ],
        )
        from datetime import datetime, timezone

        until = datetime(2026, 7, 29, 10, 1, tzinfo=timezone.utc).timestamp()
        lines = list(sched.log_iter("ml:app1", "w", 0, until=until))
        assert lines == ["first", "second"]
        assert core.read_namespaced_pod_log.call_args.kwargs["timestamps"] is True

    def test_log_iter_rejects_stream_selection(self, monkeypatch, fake_k8s):
        from torchx_tpu_torch.schedulers.api import Stream

        sched, _ = self._log_sched(monkeypatch, [])
        with pytest.raises(ValueError, match="combined stream"):
            sched.log_iter("ml:app1", "w", 0, streams=Stream.STDERR)


# =========================================================================
# Resize (Kueue-driven shrink-to-fit / manual gang resize)
# =========================================================================

from torchx_tpu_torch.schedulers.gke_scheduler import resize_jobset


class TestResizeJobset:
    def _multislice_jobset(self, **role_kwargs):
        role_kwargs.setdefault("num_replicas", 4)
        return make_jobset(
            AppDef(name="a", roles=[gpu_role(**role_kwargs)])
        )

    def test_gpu_shrink_rewrites_world(self):
        js = self._multislice_jobset(min_replicas=2)
        body = resize_jobset(js, "trainer", 2)
        (rj,) = body["spec"]["replicatedJobs"]
        assert rj["replicas"] == 2
        hosts = rj["template"]["spec"]["completions"]
        container = rj["template"]["spec"]["template"]["spec"]["containers"][0]
        env = {e["name"]: e.get("value") for e in container["env"]}
        assert env["TPX_NUM_REPLICAS"] == str(hosts * 2)
        assert env["TPX_NUM_SLICES"] == "2"
        # the floor wiring is untouched
        assert env["TPX_MIN_REPLICAS"] == "2"

    def test_floor_enforced(self):
        js = self._multislice_jobset(min_replicas=2)
        with pytest.raises(ValueError, match="below its declared min_replicas"):
            resize_jobset(js, "trainer", 1)

    def test_single_slice_growth_rejected(self):
        # a single-slice pod template has no slice-id fieldRef wiring, so a
        # grown gang could not derive global replica ids
        js = make_jobset(AppDef(name="a", roles=[gpu_role(num_replicas=1)]))
        with pytest.raises(ValueError, match="only shrink"):
            resize_jobset(js, "trainer", 3)

    def test_multislice_shrink_to_one(self):
        js = self._multislice_jobset()
        body = resize_jobset(js, "trainer", 1)
        (rj,) = body["spec"]["replicatedJobs"]
        assert rj["replicas"] == 1
        container = rj["template"]["spec"]["template"]["spec"]["containers"][0]
        env = {e["name"]: e.get("value") for e in container["env"]}
        hosts = rj["template"]["spec"]["completions"]
        assert env["TPX_NUM_REPLICAS"] == str(hosts)
        assert env["TPX_NUM_SLICES"] == "1"

    def test_cpu_role_resizes_parallelism(self):
        role = Role(
            name="reader",
            image="img",
            entrypoint="python",
            num_replicas=4,
            min_replicas=1,
            resource=Resource(cpu=2, memMB=4096),
        )
        js = make_jobset(AppDef(name="a", roles=[role]))
        body = resize_jobset(js, "reader", 2)
        spec = body["spec"]["replicatedJobs"][0]["template"]["spec"]
        assert spec["parallelism"] == 2 and spec["completions"] == 2
        container = spec["template"]["spec"]["containers"][0]
        env = {e["name"]: e.get("value") for e in container["env"]}
        assert env["TPX_NUM_REPLICAS"] == "2"

    def test_unknown_role_raises(self):
        js = self._multislice_jobset()
        with pytest.raises(ValueError, match="not found in jobset"):
            resize_jobset(js, "ghost", 2)

    def test_same_size_returns_none(self):
        js = self._multislice_jobset(num_replicas=4)
        assert resize_jobset(js, "trainer", 4) is None

    def test_macro_args_follow_resize_via_env_expansion(self):
        # materialization defers macros.num_replicas to kubelet $(VAR)
        # expansion, so args stay coherent across a resize without any
        # string rewriting
        role = gpu_role(num_replicas=4)
        role.args.append(f"--world={macros.num_replicas}")
        js = make_jobset(AppDef(name="a", roles=[role]))
        (rj,) = js["spec"]["replicatedJobs"]
        container = rj["template"]["spec"]["template"]["spec"]["containers"][0]
        assert "--world=$(TPX_NUM_SLICES)" in container["command"]
        env = {e["name"]: e.get("value") for e in container["env"]}
        assert env["TPX_NUM_SLICES"] == "4"
        body = resize_jobset(js, "trainer", 2)
        container = body["spec"]["replicatedJobs"][0]["template"]["spec"][
            "template"
        ]["spec"]["containers"][0]
        env = {e["name"]: e.get("value") for e in container["env"]}
        assert env["TPX_NUM_SLICES"] == "2"
        assert "--world=$(TPX_NUM_SLICES)" in container["command"]

    def test_server_fields_stripped_and_kueue_resuspended(self):
        js = make_jobset(
            AppDef(name="a", roles=[gpu_role(num_replicas=2)]),
            queue="tpu-queue",
        )
        # simulate a live object: server-managed fields + running state
        js["metadata"]["resourceVersion"] = "123"
        js["metadata"]["uid"] = "abc"
        js["status"] = {"conditions": []}
        js["spec"]["suspend"] = False  # Kueue admitted it
        body = resize_jobset(js, "trainer", 1)
        assert "status" not in body
        assert "resourceVersion" not in body["metadata"]
        assert "uid" not in body["metadata"]
        # goes back suspended so Kueue re-admits the resized gang
        assert body["spec"]["suspend"] is True
        # the original fetched object is untouched (deep copy)
        assert js["spec"]["replicatedJobs"][0]["replicas"] == 2


class TestResizeLifecycle:
    def test_resize_replaces_jobset(self, monkeypatch, fake_k8s):
        js = make_jobset(
            AppDef(name="a", roles=[gpu_role(num_replicas=4, min_replicas=1)]),
            namespace="ml",
        )
        js["metadata"]["resourceVersion"] = "9"
        custom = mock.MagicMock()
        # get: live jobset, then 404 after deletion
        custom.get_namespaced_custom_object.side_effect = [js, fake_k8s(404)]
        sched = GKEScheduler("t", client=object())
        sched.resize_poll_interval = 0
        monkeypatch.setattr(sched, "_custom_objects_api", lambda: custom)
        sched.resize("ml:app-x", "trainer", 2)
        del_kwargs = custom.delete_namespaced_custom_object.call_args.kwargs
        assert del_kwargs["propagation_policy"] == "Foreground"
        body = custom.create_namespaced_custom_object.call_args.kwargs["body"]
        assert body["spec"]["replicatedJobs"][0]["replicas"] == 2
        assert "resourceVersion" not in body["metadata"]

    def test_resize_missing_app_raises(self, monkeypatch, fake_k8s):
        custom = mock.MagicMock()
        custom.get_namespaced_custom_object.side_effect = fake_k8s(404)
        sched = GKEScheduler("t", client=object())
        monkeypatch.setattr(sched, "_custom_objects_api", lambda: custom)
        with pytest.raises(ValueError, match="does not exist"):
            sched.resize("ml:gone", "trainer", 2)

    def test_resize_aborts_if_deletion_never_lands(self, monkeypatch, fake_k8s):
        js = make_jobset(
            AppDef(name="a", roles=[gpu_role(num_replicas=4)]), namespace="ml"
        )
        custom = mock.MagicMock()
        custom.get_namespaced_custom_object.return_value = js  # never 404s
        sched = GKEScheduler("t", client=object())
        sched.resize_poll_interval = 0
        monkeypatch.setattr(sched, "_custom_objects_api", lambda: custom)
        with pytest.raises(RuntimeError, match="not deleted in time"):
            sched.resize("ml:app-x", "trainer", 2)
        custom.create_namespaced_custom_object.assert_not_called()

    def test_resize_same_size_is_noop(self, monkeypatch, fake_k8s):
        js = make_jobset(
            AppDef(name="a", roles=[gpu_role(num_replicas=4)]), namespace="ml"
        )
        custom = mock.MagicMock()
        custom.get_namespaced_custom_object.return_value = js
        sched = GKEScheduler("t", client=object())
        monkeypatch.setattr(sched, "_custom_objects_api", lambda: custom)
        sched.resize("ml:app-x", "trainer", 4)
        custom.delete_namespaced_custom_object.assert_not_called()
        custom.create_namespaced_custom_object.assert_not_called()


# =========================================================================
# Failure-driven elastic loop (watch_elastic: observe slice failure ->
# auto-shrink to the surviving count -> Kueue re-admission)
# =========================================================================

from torchx_tpu_torch.schedulers.gke_scheduler import plan_elastic_shrink


def _with_status(js, role_job_name, failed=0, extra_status=None):
    body = copy.deepcopy(js)
    body["status"] = {
        "replicatedJobsStatus": [
            {"name": role_job_name, "failed": failed, "ready": 1}
        ],
        **(extra_status or {}),
    }
    return body


import copy


class TestPlanElasticShrink:
    def _elastic_jobset(self, num_replicas=4, min_replicas=2):
        return make_jobset(
            AppDef(
                name="a",
                roles=[
                    gpu_role(num_replicas=num_replicas, min_replicas=min_replicas)
                ],
            ),
            namespace="ml",
            queue="tpu-queue",
        )

    def _job_name(self, js):
        return js["spec"]["replicatedJobs"][0]["name"]

    def test_no_failure_no_plan(self):
        js = self._elastic_jobset()
        assert plan_elastic_shrink(_with_status(js, self._job_name(js), 0)) is None

    def test_failure_plans_shrink_to_survivors(self):
        js = self._elastic_jobset(num_replicas=4, min_replicas=2)
        plan = plan_elastic_shrink(_with_status(js, self._job_name(js), 1))
        assert plan == ("trainer", 3)

    def test_below_floor_is_unrescuable(self):
        js = self._elastic_jobset(num_replicas=3, min_replicas=3)
        plan = plan_elastic_shrink(_with_status(js, self._job_name(js), 1))
        assert plan == ("trainer", None)

    def test_rigid_role_ignored(self):
        # no min_replicas -> no floor annotation -> the watcher leaves the
        # JobSet's own failure policy in charge
        js = make_jobset(
            AppDef(name="a", roles=[gpu_role(num_replicas=4)]), namespace="ml"
        )
        assert plan_elastic_shrink(_with_status(js, self._job_name(js), 2)) is None


class _ElasticClusterFake:
    """Stateful fake custom-objects API scripting a slice failure: the
    watcher sees a failing JobSet, resize() deletes + re-creates it, and
    the recreated (shrunken) set then completes."""

    def __init__(self, failing_jobset):
        self.jobset = failing_jobset
        self.deleted = False
        self.created_bodies = []

    def get_namespaced_custom_object(self, **kwargs):
        if self.deleted and not self.created_bodies:
            raise _FakeApiException(404)
        return self.jobset

    def delete_namespaced_custom_object(self, **kwargs):
        self.deleted = True

    def create_namespaced_custom_object(self, body, **kwargs):
        self.created_bodies.append(body)
        # recreated set: healthy, then terminally Completed so the watcher
        # exits its poll loop
        self.jobset = copy.deepcopy(body)
        self.jobset["status"] = {
            "replicatedJobsStatus": [{"name": "x", "failed": 0}],
            "conditions": [{"type": "Completed", "status": "True"}],
        }


class TestWatchElastic:
    def test_slice_failure_triggers_shrink_and_readmission(
        self, monkeypatch, fake_k8s
    ):
        js = make_jobset(
            AppDef(
                name="a", roles=[gpu_role(num_replicas=4, min_replicas=2)]
            ),
            namespace="ml",
            queue="tpu-queue",
        )
        job_name = js["spec"]["replicatedJobs"][0]["name"]
        fake = _ElasticClusterFake(_with_status(js, job_name, failed=1))
        sched = GKEScheduler("t", client=object())
        sched.resize_poll_interval = 0
        monkeypatch.setattr(sched, "_custom_objects_api", lambda: fake)
        n = sched.watch_elastic("ml:app-x", poll_interval=0)
        assert n == 1
        (body,) = fake.created_bodies
        (rj,) = body["spec"]["replicatedJobs"]
        # shrunk to the 3 surviving slices, world env rewritten coherently
        assert rj["replicas"] == 3
        hosts = rj["template"]["spec"]["completions"]
        env = {
            e["name"]: e.get("value")
            for e in rj["template"]["spec"]["template"]["spec"]["containers"][0][
                "env"
            ]
        }
        assert env["TPX_NUM_REPLICAS"] == str(3 * hosts)
        assert env["TPX_NUM_SLICES"] == "3"
        # under Kueue the resized set re-enters the queue suspended
        assert body["spec"]["suspend"] is True

    def test_below_floor_stops_without_restart(self, monkeypatch, fake_k8s):
        js = make_jobset(
            AppDef(
                name="a", roles=[gpu_role(num_replicas=2, min_replicas=2)]
            ),
            namespace="ml",
        )
        job_name = js["spec"]["replicatedJobs"][0]["name"]
        fake = _ElasticClusterFake(_with_status(js, job_name, failed=1))
        sched = GKEScheduler("t", client=object())
        monkeypatch.setattr(sched, "_custom_objects_api", lambda: fake)
        assert sched.watch_elastic("ml:app-x", poll_interval=0) == 0
        assert not fake.created_bodies

    def test_terminal_app_exits_watch(self, monkeypatch, fake_k8s):
        js = make_jobset(
            AppDef(
                name="a", roles=[gpu_role(num_replicas=4, min_replicas=2)]
            ),
            namespace="ml",
        )
        job_name = js["spec"]["replicatedJobs"][0]["name"]
        done = _with_status(
            js,
            job_name,
            failed=0,
            extra_status={
                "conditions": [{"type": "Completed", "status": "True"}]
            },
        )
        fake = _ElasticClusterFake(done)
        sched = GKEScheduler("t", client=object())
        monkeypatch.setattr(sched, "_custom_objects_api", lambda: fake)
        assert sched.watch_elastic("ml:app-x", poll_interval=0) == 0

    def test_gone_jobset_exits_watch(self, monkeypatch, fake_k8s):
        fake = mock.MagicMock()
        fake.get_namespaced_custom_object.side_effect = _FakeApiException(404)
        sched = GKEScheduler("t", client=object())
        monkeypatch.setattr(sched, "_custom_objects_api", lambda: fake)
        assert sched.watch_elastic("ml:app-x", poll_interval=0) == 0


# =========================================================================
# Heterogeneous node pools: GPU + GCE machine-type roles beside GPU slices
# =========================================================================


class TestHeterogeneousPools:
    def _mixed_app(self):
        from torchx_tpu_torch.specs import named_resources

        gpu_res = named_resources["gpu_a100_4"]
        cpu_res = named_resources["gce_n2_standard_8"]
        return AppDef(
            name="mixed",
            roles=[
                gpu_role(gpus=16),
                Role(
                    name="scorer",
                    image="gcr.io/p/gpu:1",
                    entrypoint="python",
                    num_replicas=2,
                    resource=gpu_res,
                ),
                Role(
                    name="reader",
                    image="gcr.io/p/cpu:1",
                    entrypoint="python",
                    num_replicas=1,
                    resource=cpu_res,
                ),
            ],
        )

    def test_mixed_roles_materialize_their_pools(self):
        js = make_jobset(self._mixed_app())
        by_name = {rj["name"]: rj for rj in js["spec"]["replicatedJobs"]}
        assert set(by_name) == {"trainer", "scorer", "reader"}

        slice_pod = by_name["trainer"]["template"]["spec"]["template"]["spec"]
        assert slice_pod["nodeSelector"] == {
            "cloud.google.com/gke-accelerator": "nvidia-h100-80gb"}
        assert slice_pod["containers"][0]["resources"]["limits"]["nvidia.com/gpu"] == 8
        assert by_name["trainer"]["template"]["spec"]["parallelism"] == 2

        gpu_pod = by_name["scorer"]["template"]["spec"]["template"]["spec"]
        sel = gpu_pod["nodeSelector"]
        assert sel["cloud.google.com/gke-accelerator"] == "nvidia-tesla-a100"
        assert sel["node.kubernetes.io/instance-type"] == "a2-highgpu-4g"
        limits = gpu_pod["containers"][0]["resources"]["limits"]
        assert limits["nvidia.com/gpu"] == 4
        assert gpu_pod["tolerations"][0]["key"] == "nvidia.com/gpu"
        # GPU pods are plain parallel jobs, 2 replicas
        assert by_name["scorer"]["template"]["spec"]["parallelism"] == 2

        cpu_pod = by_name["reader"]["template"]["spec"]["template"]["spec"]
        assert cpu_pod["nodeSelector"] == {
            "node.kubernetes.io/instance-type": "n2-standard-8"
        }
        assert "tolerations" not in cpu_pod
        assert "nvidia.com/gpu" not in cpu_pod["containers"][0]["resources"]["limits"]

    def test_gpu_catalog_shapes(self):
        from torchx_tpu_torch.specs import named_resources

        r = named_resources["gpu_h100_8"]
        assert r.devices == {"nvidia.com/gpu": 8}
        assert r.capabilities["gke.accelerator"] == "nvidia-h100-80gb"
        assert r.capabilities["gce.machine_type"] == "a3-highgpu-8g"
        assert r.cpu == 208

    def test_gce_raw_name_lookup(self):
        from torchx_tpu_torch.specs import named_resources

        r = named_resources["n2-standard-16"]
        assert r.cpu == 16 and r.gpu is None
        assert r.capabilities["gce.machine_type"] == "n2-standard-16"


# =========================================================================
# In-cluster elastic controller (elastic_controller=True): shrink keeps
# working after the operator's `tpx watch` terminal is gone
# =========================================================================


class _FakeBatchApi:
    def __init__(self):
        self.created = []
        self.deleted = []

    def create_namespaced_job(self, namespace, body):
        self.created.append((namespace, body))

    def delete_namespaced_job(self, name, namespace, **kwargs):
        self.deleted.append((namespace, name))


class TestElasticControllerJob:
    def _dryrun(self, sched, **cfg):
        app = AppDef(
            name="a", roles=[gpu_role(num_replicas=4, min_replicas=2)]
        )
        cfg.setdefault("elastic_controller", True)
        cfg.setdefault("namespace", "ml")
        return sched.submit_dryrun(app, cfg)

    def test_dryrun_emits_controller_manifest(self):
        sched = GKEScheduler("sess", client=object())
        info = self._dryrun(sched, service_account="tpx-sa")
        req = info.request
        ctrl = req.controller
        assert ctrl is not None and ctrl["kind"] == "Job"
        app_name = req.resource["metadata"]["name"]
        assert ctrl["metadata"]["name"] == f"{app_name}-tpx-watch"
        assert ctrl["metadata"]["namespace"] == "ml"
        pod = ctrl["spec"]["template"]["spec"]
        # existing service_account plumbing gives the pod its RBAC identity
        assert pod["serviceAccountName"] == "tpx-sa"
        assert pod["restartPolicy"] == "OnFailure"
        container = pod["containers"][0]
        # the role image carries torchx_tpu_torch, so the controller reuses it
        assert container["image"] == "gcr.io/proj/img:1"
        assert container["command"][:5] == [
            "python", "-u", "-m", "torchx_tpu_torch.cli.main", "watch",
        ]
        assert container["command"][5] == f"gke://sess/ml:{app_name}"

    def test_no_controller_without_flag(self):
        sched = GKEScheduler("sess", client=object())
        app = AppDef(
            name="a", roles=[gpu_role(num_replicas=4, min_replicas=2)]
        )
        info = sched.submit_dryrun(app, {"namespace": "ml"})
        assert info.request.controller is None

    def test_controller_requires_elastic_role(self):
        sched = GKEScheduler("sess", client=object())
        app = AppDef(name="a", roles=[gpu_role(num_replicas=4)])
        with pytest.raises(ValueError, match="min_replicas"):
            sched.submit_dryrun(app, {"elastic_controller": True})

    def test_schedule_creates_and_delete_removes(
        self, monkeypatch, fake_k8s
    ):
        sched = GKEScheduler("sess", client=object())
        batch = _FakeBatchApi()
        custom = mock.MagicMock()
        monkeypatch.setattr(sched, "_batch_api", lambda: batch)
        monkeypatch.setattr(sched, "_custom_objects_api", lambda: custom)
        info = self._dryrun(sched, service_account="tpx-sa")
        app_id = sched.schedule(info)
        (created,) = batch.created
        assert created[0] == "ml"
        assert created[1]["metadata"]["name"].endswith("-tpx-watch")
        sched.delete(app_id)
        (deleted,) = batch.deleted
        assert deleted == ("ml", created[1]["metadata"]["name"])

    def test_cancel_removes_controller(self, monkeypatch, fake_k8s):
        sched = GKEScheduler("sess", client=object())
        batch = _FakeBatchApi()
        custom = mock.MagicMock()
        monkeypatch.setattr(sched, "_batch_api", lambda: batch)
        monkeypatch.setattr(sched, "_custom_objects_api", lambda: custom)
        monkeypatch.setattr(
            sched, "describe", lambda app_id: mock.MagicMock(
                state=AppState.RUNNING
            )
        )
        sched.cancel("ml:app-x")
        assert ("ml", "app-x-tpx-watch") in batch.deleted

    def test_controller_pod_performs_shrink(self, monkeypatch, fake_k8s):
        """Full lifecycle on a fake cluster: the shrink is performed by the
        controller Job's OWN command (the materialized `tpx watch` argv,
        executed here as the pod would), NOT by the test harness."""
        sched = GKEScheduler("sess", client=object())
        sched.resize_poll_interval = 0
        batch = _FakeBatchApi()
        monkeypatch.setattr(sched, "_batch_api", lambda: batch)

        info = self._dryrun(sched)
        monkeypatch.setattr(sched, "_custom_objects_api", mock.MagicMock())
        sched.schedule(info)
        assert batch.created  # the controller Job went to the cluster

        # ...later, a slice fails while the operator is disconnected:
        js = copy.deepcopy(info.request.resource)
        job_name = js["spec"]["replicatedJobs"][0]["name"]
        cluster = _ElasticClusterFake(_with_status(js, job_name, failed=1))
        monkeypatch.setattr(sched, "_custom_objects_api", lambda: cluster)

        # --- what the controller pod runs -------------------------------
        command = info.request.controller["spec"]["template"]["spec"][
            "containers"
        ][0]["command"]
        assert command[3] == "torchx_tpu_torch.cli.main"
        argv = command[4:] + ["--interval", "0"]

        from torchx_tpu_torch.cli import cmd_simple
        from torchx_tpu_torch.cli.main import main as cli_main
        from torchx_tpu_torch.runner.api import Runner

        # the pod builds its own runner via get_runner(); point it at the
        # same fake cluster (in the pod this is load_incluster_config)
        monkeypatch.setattr(
            cmd_simple,
            "get_runner",
            lambda *a, **kw: Runner(
                "sess", {"gke": lambda session_name, **kw2: sched}
            ),
        )
        cli_main(argv)

        # the shrink happened, and the CLI (not this test) drove it
        (body,) = cluster.created_bodies
        (rj,) = body["spec"]["replicatedJobs"]
        assert rj["replicas"] == 3


# =========================================================================
# Spot and maintenance classification on GPU node pools
# =========================================================================

from torchx_tpu_torch.schedulers.gke_scheduler import classify_jobset_failure  # noqa: E402
from torchx_tpu_torch.specs.api import FailureClass  # noqa: E402


def _failed_jobset(message=""):
    return {
        "metadata": {"namespace": "ml", "name": "app-x"},
        "status": {"conditions": [{"type": "Failed", "status": "True",
                                   "reason": "FailedJobs", "message": message}]},
    }


def _gpu_pod(conditions, phase="Failed", index="0"):
    """A pod of an a3-highgpu-8g node pool, as the k8s client's
    ``to_dict()`` gives it."""
    return {
        "metadata": {"name": f"app-x-trainer-0-{index}-abcde",
                     "labels": {"tpx.sh/role-name": "trainer"},
                     "annotations": {"batch.kubernetes.io/job-completion-index": index}},
        "spec": {"node_name": "gke-h100-pool-1a2b3c4d-x9z8",
                 "node_selector": {"cloud.google.com/gke-accelerator": "nvidia-h100-80gb"}},
        "status": {"phase": phase, "conditions": conditions},
    }


class TestGpuNodePoolClassification:
    """A JobSet's Failed means both "the container exited 1" and "the spot
    node under it went away": GKE's ``DisruptionTarget`` pod condition on a
    GPU node pool (spot reclaim, a maintenance drain: a GPU VM cannot live
    migrate, so host maintenance evicts it) reads as PREEMPTION."""

    @pytest.mark.parametrize("reason, message", [
        ("TerminationByKubelet", "Pod was terminated in response to imminent node shutdown."),
        ("PreemptionByScheduler", "Kubernetes Scheduler: preempting to accommodate a"
                                  " higher priority pod"),
        ("DeletionByTaintManager", "Taint manager: deleting due to NoExecute taint"
                                   " `cloud.google.com/impending-node-termination`"),
        ("EvictionByEvictionAPI", "Eviction API: evicting (node drain for maintenance)"),
    ])
    def test_disruption_condition_is_preemption(self, reason, message):
        pods = [_gpu_pod([{"type": "DisruptionTarget", "status": "True", "reason": reason,
                           "message": message}]), _gpu_pod([], phase="Running", index="1")]
        state, fclass, note = classify_jobset_failure(_failed_jobset(), pods)
        assert (state, fclass) == (AppState.PREEMPTED, FailureClass.PREEMPTION)
        assert reason in note
        resp = describe_jobset(_failed_jobset(), pods)
        assert resp.state == AppState.PREEMPTED and resp.failure_class == FailureClass.PREEMPTION

    def test_failed_condition_naming_spot_is_preemption(self):
        state, fclass, _ = classify_jobset_failure(
            _failed_jobset("node gke-h100-spot-pool-x was deleted: spot VM preempted"), [])
        assert (state, fclass) == (AppState.PREEMPTED, FailureClass.PREEMPTION)

    @pytest.mark.parametrize("conditions", [
        [],
        [{"type": "DisruptionTarget", "status": "False", "reason": "TerminationByKubelet"}],
        [{"type": "Ready", "status": "False", "reason": "PodFailed"}],
    ])
    def test_app_failure_stays_app(self, conditions):
        resp = describe_jobset(_failed_jobset("container exited 1"), [_gpu_pod(conditions)])
        assert (resp.state, resp.failure_class) == (AppState.FAILED, FailureClass.APP)

    def test_camel_case_watch_payload(self):
        pod = _gpu_pod([{"type": "DisruptionTarget", "status": "True",
                         "reason": "PreemptionByKubeScheduler"}])
        pod["status"]["podIP"] = "10.8.0.3"
        resp = describe_jobset(_failed_jobset(), [pod])
        assert resp.failure_class == FailureClass.PREEMPTION
        assert resp.roles_statuses[0].replicas[0].hostname == "10.8.0.3"


TPU_NAMES = ("google.com/tpu", "gke-tpu-", "hightpu", "tpuTopology", "MEGASCALE", "TPX_TPU_")


class TestNoTpuNames:
    @pytest.mark.parametrize("role_kw", [
        {}, {"num_replicas": 3}, {"num_replicas": 4, "min_replicas": 2}, {"gpus": 4}])
    def test_gpu_requests_carry_no_tpu_name(self, role_kw):
        sched = GKEScheduler("s", client=object())
        cfg = {"elastic_controller": True} if "min_replicas" in role_kw else {}
        info = sched.submit_dryrun(AppDef(name="a", roles=[gpu_role(**role_kw)]), cfg)
        text = str(info)
        assert not [name for name in TPU_NAMES if name in text]
        assert "nvidia.com/gpu" in text and "nvidia-h100-80gb" in text


# =========================================================================
# Parity with the JAX package's backend
# =========================================================================

from torchx_tpu.schedulers import gke_scheduler as jgke  # noqa: E402
from torchx_tpu.specs import api as japi  # noqa: E402
from torchx_tpu.specs import named_resources as jnamed  # noqa: E402
from torchx_tpu_torch.schedulers import gke_scheduler as tgke  # noqa: E402
from torchx_tpu_torch.specs import named_resources  # noqa: E402


def _as_gpu(jax_jobset: dict, gpus_per_host: int, accel_type: str, topology: str) -> dict:
    """The JAX package's JobSet of a TPU role with the named substitutions
    made: the ``google.com/tpu`` limit and request become ``nvidia.com/gpu``,
    the TPU selectors the GPU pool's, the taint toleration GKE's GPU taint;
    the ``MEGASCALE_*`` wiring goes, ``MEGASCALE_NUM_SLICES`` becoming
    ``TPX_NUM_SLICES``; and the slice's name joins the identity env, as
    ``role_replica_env`` gives it elsewhere."""
    js = json.loads(json.dumps(jax_jobset).replace("MEGASCALE_NUM_SLICES", "TPX_NUM_SLICES"))
    for rj in js["spec"]["replicatedJobs"]:
        pod = rj["template"]["spec"]["template"]["spec"]
        (container,) = pod["containers"]
        if "google.com/tpu" not in container["resources"]["limits"]:
            continue
        for kind in ("limits", "requests"):
            del container["resources"][kind]["google.com/tpu"]
            container["resources"][kind]["nvidia.com/gpu"] = gpus_per_host
        pod["nodeSelector"] = {"cloud.google.com/gke-accelerator": "nvidia-h100-80gb"}
        pod["tolerations"] = [{"key": "nvidia.com/gpu", "operator": "Exists",
                               "effect": "NoSchedule"}]
        env = [e for e in container["env"]
               if e["name"] not in ("MEGASCALE_SLICE_ID", "MEGASCALE_COORDINATOR_ADDRESS")]
        at = next(i for i, e in enumerate(env) if e["name"] == "TPX_ROLE_NAME")
        env[at:at] = [{"name": "TPX_GPU_ACCELERATOR_TYPE", "value": accel_type},
                      {"name": "TPX_GPU_TOPOLOGY", "value": topology}]
        container["env"] = env
    return js


class TestJaxParity:
    """The same app through both packages' ``submit_dryrun``, ``make_unique``
    pinned: equal JobSets for CPU roles, equal controller Jobs but for the
    CLI's module; for a GPU role against its TPU twin (``h100-16`` against
    ``v5p-8``, two hosts each) the JobSets differ only in the substitutions
    :func:`_as_gpu` makes."""

    @pytest.fixture(autouse=True)
    def _pinned(self, monkeypatch):
        for mod in (tgke, jgke):
            monkeypatch.setattr(mod, "make_unique", lambda name: f"{name}-fixed0")

    @staticmethod
    def _dryruns(troles, jroles, cfg):
        ours = GKEScheduler("s", client=object()).submit_dryrun(
            AppDef(name="app", roles=troles), cfg).request
        theirs = jgke.GKEScheduler("s", client=object()).submit_dryrun(
            japi.AppDef(name="app", roles=jroles), cfg).request
        return ours, theirs

    @staticmethod
    def _cpu_roles(**kw):
        kw = {"name": "reader", "image": "img:2", "entrypoint": "python",
              "args": ["-m", "read", f"--r={macros.replica_id}",
                       f"--n={macros.num_replicas}"], "num_replicas": 3, **kw}
        caps = {"gce.machine_type": "n2-standard-8"}
        return (Role(resource=Resource(cpu=8, memMB=30000, capabilities=caps), **kw,
                     mounts=[VolumeMount(src="ckpt", dst_path="/ckpt")]),
                japi.Role(resource=japi.Resource(cpu=8, memMB=30000, capabilities=caps),
                          **kw, mounts=[japi.VolumeMount(src="ckpt", dst_path="/ckpt")]))

    @pytest.mark.parametrize("role_kw, cfg", [
        ({}, {}),
        ({"max_retries": 2, "env": {"K": "v"}}, {"namespace": "ml", "queue": "q",
                                                   "service_account": "sa"}),
        ({"min_replicas": 1}, {"elastic_controller": True, "namespace": "ml"}),
    ])
    def test_cpu_jobset_equal_jax(self, role_kw, cfg):
        trole, jrole = self._cpu_roles(**role_kw)
        gpu_t = Role(name="scorer", image="img:3", entrypoint="python",
                     resource=named_resources["gpu_a100_4"], num_replicas=2)
        gpu_j = japi.Role(name="scorer", image="img:3", entrypoint="python",
                          resource=jnamed["gpu_a100_4"], num_replicas=2)
        ours, theirs = self._dryruns([trole, gpu_t], [jrole, gpu_j], cfg)
        assert ours.namespace == theirs.namespace
        assert ours.resource == theirs.resource
        if ours.controller is None:
            assert theirs.controller is None
        else:
            ctrl = json.loads(json.dumps(ours.controller).replace(
                "torchx_tpu_torch.cli.main", "torchx_tpu.cli.main"))
            assert ctrl == theirs.controller

    @pytest.mark.parametrize("role_kw", [
        {}, {"num_replicas": 3}, {"num_replicas": 4, "min_replicas": 2, "max_retries": 1}])
    def test_gpu_twin_differs_in_the_named_fields(self, role_kw):
        kw = {"name": "trainer", "image": "img:1", "entrypoint": "python",
              "args": ["-m", "train", f"--r={macros.replica_id}",
                       f"--world={macros.num_replicas}"], **role_kw}
        ours, theirs = self._dryruns(
            [Role(resource=Resource(cpu=200, memMB=1000, gpu=GpuSlice("h100", 16)), **kw)],
            [japi.Role(resource=japi.Resource(cpu=200, memMB=1000,
                                              tpu=japi.TpuSlice("v5p", 8)), **kw)],
            {"queue": "q"})
        assert ours.resource == _as_gpu(theirs.resource, 8, "h100-16", "2x8")

