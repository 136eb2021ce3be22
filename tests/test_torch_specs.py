"""The port's specs layer (``torchx_tpu_torch.specs``): every case of
``tests/test_specs_api.py`` and of ``tests/test_serialize_util.py``'s
serialization run against the copy (the TPU slice cases as H100 slice
cases), and the data model held to the JAX package's on the same inputs."""

import dataclasses
import json
import warnings

import pytest

from torchx_tpu import specs as jspecs
from torchx_tpu.specs import serialize as jserialize
from torchx_tpu.specs.named_resources_gcp import named_resources_gcp as jgcp
from torchx_tpu.specs.named_resources_generic import named_resources_generic as jgeneric
from torchx_tpu_torch import specs as tspecs
from torchx_tpu_torch.specs import (
    AppDef,
    AppState,
    AppStatus,
    BindMount,
    DeviceMount,
    GpuSlice,
    InvalidRunConfigException,
    MalformedAppHandleException,
    Resource,
    RetryPolicy,
    Role,
    VolumeMount,
    Workspace,
    is_started,
    is_terminal,
    macros,
    make_app_handle,
    make_structured_error,
    named_resources,
    parse_app_handle,
    parse_mounts,
    resource,
    runopts,
)
from torchx_tpu_torch.specs.api import GPU_GENERATIONS
from torchx_tpu_torch.specs.named_resources_gcp import named_resources_gcp
from torchx_tpu_torch.specs.named_resources_generic import named_resources_generic
from torchx_tpu_torch.specs.named_resources_gpu import named_resources_gpu
from torchx_tpu_torch.specs.serialize import appdef_from_dict, appdef_to_dict
from torch_threads import xdist_torch_threads  # noqa: F401


class TestGpuSlice:
    def test_naming(self):
        s = GpuSlice.from_type("h100-16")
        assert (s.accelerator, s.gpus) == ("h100", 16)
        assert s.accelerator_type == "h100-16"
        assert str(s) == "GpuSlice(h100-16, gpus=16)"
        assert GpuSlice.from_type(" H100-8 ") == GpuSlice("h100", 8)

    # A slice of up to one host's cards lives on that host; a larger one is
    # whole 8-card hosts (a3-highgpu-8g). A wrong host count makes every
    # multi-host request unschedulable.
    @pytest.mark.parametrize(
        "acc_type, gpus_per_host, hosts, topology",
        [
            ("h100-1", 1, 1, "1x1"),
            ("h100-2", 2, 1, "1x2"),
            ("h100-4", 4, 1, "1x4"),
            ("h100-8", 8, 1, "1x8"),
            ("h100-16", 8, 2, "2x8"),
            ("h100-64", 8, 8, "8x8"),
        ],
    )
    def test_host_geometry(self, acc_type, gpus_per_host, hosts, topology):
        s = GpuSlice.from_type(acc_type)
        assert s.gpus_per_host == gpus_per_host
        assert s.hosts == hosts
        assert s.default_topology() == topology
        assert s.hosts * s.gpus_per_host == s.gpus

    @pytest.mark.parametrize("gpus", [12, 20, 65])
    def test_partial_hosts_refused(self, gpus):
        with pytest.raises(ValueError, match="whole hosts"):
            GpuSlice(accelerator="h100", gpus=gpus)
        with pytest.raises(ValueError, match="whole hosts"):
            GpuSlice.from_type(f"h100-{gpus}")

    def test_card_facts(self):
        s = GpuSlice("h100", 1)
        assert s.hbm_bytes_per_gpu == 85_017_493_504
        info = GPU_GENERATIONS["h100"]
        assert (info["gpus_per_host"], info["link_bytes_per_s"], info["gke_accelerator"]) \
            == (8, 450e9, "nvidia-h100-80gb")

    def test_unknown_generation(self):
        with pytest.raises(ValueError, match="unknown GPU generation"):
            GpuSlice(accelerator="a100", gpus=4)
        with pytest.raises(ValueError, match="unknown GPU generation"):
            GpuSlice.from_type("v5p-8")
        with pytest.raises(ValueError):
            GpuSlice(accelerator="h100", gpus=0)

    @pytest.mark.parametrize("bad", ["h100", "h100-", "h100-x", "-8", "h100_8", "h100-8-2"])
    def test_malformed_type(self, bad):
        with pytest.raises(ValueError, match="malformed"):
            GpuSlice.from_type(bad)

    def test_frozen(self):
        with pytest.raises(dataclasses.FrozenInstanceError):
            GpuSlice("h100", 8).gpus = 16


class TestNamedResources:
    def test_catalog_lookup(self):
        r = named_resources["h100_16"]
        assert r.gpu is not None and r.gpu.gpus == 16
        assert r.cpu == 208 and r.devices == {"nvidia.com/gpu": 8}
        assert r.capabilities["gke.accelerator"] == "nvidia-h100-80gb"

    def test_cloud_name_lookup(self):
        r = named_resources["h100-32"]
        assert r.gpu.gpus == 32 and r.gpu.hosts == 4

    def test_uncataloged_size_fallback(self):
        assert "h100-24" not in named_resources_gpu()
        r = named_resources["h100-24"]
        assert r.gpu.gpus == 24 and r.gpu.hosts == 3

    def test_host_share_below_a_host(self):
        # the gcp catalog's a3-highgpu-8g divided per GPU
        host = named_resources["gpu_h100_8"]
        for n in (1, 2, 4, 8):
            r = named_resources[f"h100-{n}"]
            assert r.cpu == host.cpu * n // 8 == 26 * n
            assert r.memMB == int(1872 * 1024 * 0.96 * n / 8)
            assert r.devices == {"nvidia.com/gpu": n}
        assert named_resources["h100-8"].memMB == host.memMB

    def test_catalog_sizes_and_names(self):
        names = set(named_resources_gpu())
        sizes = [1, 2, 4, 8, 16, 32, 64]
        assert names == {f"h100_{n}" for n in sizes} | {f"h100-{n}" for n in sizes}
        for n in sizes:
            assert named_resources[f"h100_{n}"] == named_resources[f"h100-{n}"]

    def test_gcp_catalog_not_shadowed(self):
        gcp = named_resources_gcp()
        assert not set(named_resources_gpu()) & (set(gcp) | set(named_resources_generic()))
        for name in gcp:  # gpu_h100_8 among them
            assert named_resources[name] == gcp[name]()
        assert named_resources["gpu_h100_8"].gpu is None

    def test_generic(self):
        r = named_resources["cpu_small"]
        assert r.cpu == 2 and r.gpu is None

    def test_contains(self):
        assert "h100-32" in named_resources
        assert "h100-12" not in named_resources  # not whole hosts
        assert "nonsense" not in named_resources

    def test_unknown_raises(self):
        with pytest.raises(KeyError):
            named_resources["gpu_a100"]
        with pytest.raises(KeyError):
            named_resources["v5p-32"]

    def test_resource_factory_h_wins(self):
        r = resource(cpu=1, memMB=1, h="h100-4")
        assert r.gpu.gpus == 4 and r.cpu != 1

    def test_resource_factory_gpu_str(self):
        r = resource(gpu="h100-16")
        assert r.gpu.gpus == 16 and r.gpu.hosts == 2
        assert resource().gpu is None and (resource().cpu, resource().memMB) == (1, 1024)

    def test_custom_named_resources_env(self, tmp_path, monkeypatch):
        (tmp_path / "my_resources.py").write_text(
            "from torchx_tpu_torch.specs.api import Resource\n"
            "def named_resources():\n"
            "    return {'h100-8': lambda: Resource(cpu=3, memMB=3)}\n"
        )
        monkeypatch.syspath_prepend(str(tmp_path))
        monkeypatch.setenv("TPX_CUSTOM_NAMED_RESOURCES", "my_resources,no_such_module")
        tspecs.invalidate_named_resources_cache()
        try:
            assert named_resources["h100-8"].cpu == 3  # custom wins over the gpu catalog
            assert "h100-8" in tspecs.get_named_resources()
        finally:
            monkeypatch.delenv("TPX_CUSTOM_NAMED_RESOURCES")
            tspecs.invalidate_named_resources_cache()
        assert named_resources["h100-8"].cpu == 208


class TestMounts:
    def test_parse_bind(self):
        (m,) = parse_mounts(["type=bind,src=/host,dst=/job,readonly"])
        assert isinstance(m, BindMount)
        assert m.src_path == "/host" and m.dst_path == "/job" and m.read_only

    def test_parse_multiple_groups(self):
        ms = parse_mounts(
            ["type=bind,src=/a,dst=/b", "type=volume,src=models,dst=/models"]
        )
        assert isinstance(ms[0], BindMount) and isinstance(ms[1], VolumeMount)

    def test_parse_device(self):
        (m,) = parse_mounts(["type=device,src=/dev/nvidia0"])
        assert isinstance(m, DeviceMount) and m.dst_path == "/dev/nvidia0"

    def test_parse_errors(self):
        with pytest.raises(ValueError):
            parse_mounts(["src=/a,dst=/b"])
        with pytest.raises(ValueError):
            parse_mounts(["type=bind,src=/a"])
        with pytest.raises(ValueError):
            parse_mounts(["type=nope,src=/a,dst=/b"])


class TestMacros:
    def test_apply_substitutes_args_env_entrypoint(self):
        role = Role(
            name="trainer",
            image="img",
            entrypoint="bash",
            args=["-c", f"run --id {macros.app_id} --replica {macros.replica_id}"],
            env={"LOGROOT": f"{macros.img_root}/logs"},
            mounts=[BindMount(src_path=f"{macros.img_root}/d", dst_path="/d")],
        )
        v = macros.Values(
            img_root="/img", app_id="app_1", replica_id="3", num_replicas="4"
        )
        out = v.apply(role)
        assert out.args == ["-c", "run --id app_1 --replica 3"]
        assert out.env["LOGROOT"] == "/img/logs"
        assert out.mounts[0].src_path == "/img/d"
        # original untouched
        assert macros.app_id in role.args[1]

    def test_coordinator_env_substitution(self):
        role = Role(
            name="t",
            image="i",
            entrypoint="sh",
            args=["-c", f"echo $${macros.coordinator_env}"],
        )
        out = macros.Values(coordinator_env="MY_COORD_HOST").apply(role)
        # one $ remains for the runtime shell to expand
        assert out.args[1] == "echo $MY_COORD_HOST"


class TestStatus:
    def test_terminal_and_started(self):
        assert is_terminal(AppState.SUCCEEDED)
        assert is_terminal(AppState.FAILED)
        assert not is_terminal(AppState.RUNNING)
        assert is_started(AppState.RUNNING)
        assert not is_started(AppState.PENDING)

    def test_raise_for_status(self):
        AppStatus(state=AppState.SUCCEEDED).raise_for_status()
        from torchx_tpu_torch.specs import AppStatusError

        with pytest.raises(AppStatusError):
            AppStatus(state=AppState.FAILED).raise_for_status()

    def test_structured_error_format(self):
        err = make_structured_error("boom", exitcode=2, hostname="worker-0")
        st = AppStatus(state=AppState.FAILED, structured_error_msg=err)
        text = st.format()
        assert "boom" in text and "exitcode: 2" in text and "worker-0" in text

    def test_format_plain(self):
        st = AppStatus(state=AppState.RUNNING, msg="ok")
        assert "RUNNING" in st.format()


class TestRunopts:
    def make(self) -> runopts:
        opts = runopts()
        opts.add("log_dir", type_=str, help="log dir", default="/tmp/logs")
        opts.add("replicas", type_=int, help="n", default=1)
        opts.add("mounts", type_=list, help="mounts", default=None)
        opts.add("labels", type_=dict, help="labels", default=None)
        opts.add("detach", type_=bool, help="detach", default=False)
        opts.add("project", type_=str, help="gcp project", required=True)
        return opts

    def test_resolve_defaults_and_required(self):
        opts = self.make()
        cfg = opts.resolve({"project": "p1"})
        assert cfg["log_dir"] == "/tmp/logs" and cfg["replicas"] == 1
        with pytest.raises(InvalidRunConfigException):
            opts.resolve({})

    def test_resolve_type_error(self):
        with pytest.raises(InvalidRunConfigException):
            self.make().resolve({"project": "p", "replicas": "abc"})

    def test_str_coercion_and_camel_alias(self):
        cfg = self.make().resolve({"project": "p", "replicas": "3", "Detach": "true"})
        assert cfg["replicas"] == 3 and cfg["detach"] is True

    def test_cfg_from_str(self):
        opts = self.make()
        cfg = opts.cfg_from_str("project=p,replicas=2;detach=yes")
        assert cfg == {"project": "p", "replicas": 2, "detach": True}

    def test_cfg_from_str_list_continuation(self):
        opts = self.make()
        cfg = opts.cfg_from_str("mounts=a,b,c;project=p")
        assert cfg["mounts"] == ["a", "b", "c"]

    def test_cfg_from_str_dict(self):
        cfg = self.make().cfg_from_str("labels=team:ml")
        assert cfg["labels"] == {"team": "ml"}

    def test_cfg_from_str_dict_multi_entry(self):
        cfg = self.make().cfg_from_str("labels=a:1,b:2;project=p")
        assert cfg["labels"] == {"a": "1", "b": "2"}
        assert cfg["project"] == "p"

    def test_error_details_non_dict_json(self):
        st = AppStatus(state=AppState.FAILED, structured_error_msg='"oom killed"')
        assert "oom killed" in st.format()

    def test_unknown_passthrough(self):
        cfg = self.make().resolve({"project": "p", "plugin_knob": "x"})
        assert cfg["plugin_knob"] == "x"

    def test_unknown_warns_once_per_key_per_schema(self):
        """Same schema: one warning however often it resolves, across fresh
        instances; a different schema still warns for its own unknown key
        of the same name."""
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            self.make().resolve({"project": "p", "plugin_knob2": "x"})
            self.make().resolve({"project": "p", "plugin_knob2": "y"})
        hits = [x for x in w if "plugin_knob2" in str(x.message)]
        assert len(hits) == 1

        other_schema = runopts()
        other_schema.add("unrelated", type_=str, help="")
        with warnings.catch_warnings(record=True) as w2:
            warnings.simplefilter("always")
            other_schema.resolve({"plugin_knob2": "z"})
        hits_b = [x for x in w2 if "plugin_knob2" in str(x.message)]
        assert len(hits_b) == 1

    def test_merge(self):
        a = runopts()
        a.add("x", type_=int, help="", default=1)
        b = runopts()
        b.add("y", type_=int, help="", default=2)
        merged = a | b
        assert {k for k, _ in merged} == {"x", "y"}

    def test_json_repr(self):
        cfg = self.make().cfg_from_json_repr(json.dumps({"project": "p"}))
        assert cfg == {"project": "p"}


class TestHandles:
    def test_roundtrip(self):
        h = make_app_handle("gke", "sess", "app_abc123")
        assert parse_app_handle(h) == ("gke", "sess", "app_abc123")

    def test_empty_session(self):
        assert parse_app_handle("local://" + "/app1") == ("local", "", "app1")

    def test_malformed(self):
        with pytest.raises(MalformedAppHandleException):
            parse_app_handle("not-a-handle")


class TestWorkspaceSpec:
    def test_from_str_single(self):
        assert Workspace.from_str(".").projects == {".": ""}

    def test_from_str_mapping(self):
        ws = Workspace.from_str("./src=app/src,./conf=conf")
        assert ws.projects == {"./src": "app/src", "./conf": "conf"}

    def test_merge(self):
        a = Workspace(projects={"x": "1"})
        b = Workspace(projects={"x": "0", "y": "2"})
        assert a.merge_into(b).projects == {"x": "1", "y": "2"}


class TestRoleAppDef:
    def test_defaults(self):
        role = Role(name="r", image="i")
        assert role.num_replicas == 1
        app = AppDef(name="a", roles=[role])
        assert app.roles[0].name == "r"

    def test_resource_copy(self):
        r = Resource(cpu=1, memMB=2, capabilities={"a": 1})
        r2 = Resource.copy(r, b=2)
        assert r2.capabilities == {"a": 1, "b": 2}
        assert r.capabilities == {"a": 1}


class TestSerialize:
    def make_app(self, resource=None):
        return AppDef(
            name="train",
            metadata={"team": "ml"},
            roles=[
                Role(
                    name="trainer",
                    image="img:1",
                    entrypoint="python",
                    args=["-m", "t"],
                    env={"A": "1"},
                    num_replicas=2,
                    min_replicas=1,
                    max_retries=3,
                    retry_policy=RetryPolicy.APPLICATION,
                    port_map={"coordinator": 8476},
                    resource=resource or Resource(cpu=8, memMB=1024, gpu=GpuSlice("h100", 16)),
                    mounts=[BindMount(src_path="/a", dst_path="/b", read_only=True)],
                )
            ],
        )

    def test_roundtrip(self):
        app = self.make_app()
        restored = appdef_from_dict(appdef_to_dict(app))
        assert restored == app
        assert appdef_to_dict(app)["roles"][0]["resource"]["gpu"] == {"accelerator": "h100",
                                                                     "gpus": 16}

    def test_workspace_roundtrip(self):
        app = self.make_app()
        app.roles[0].workspace = Workspace(projects={"./src": "app/src"})
        restored = appdef_from_dict(appdef_to_dict(app))
        assert restored == app
        assert restored.roles[0].workspace.projects == {"./src": "app/src"}

    def test_from_dict_minimal(self):
        app = appdef_from_dict(
            {"roles": [{"name": "r", "entrypoint": "echo", "args": ["hi"]}]}
        )
        assert app.roles[0].entrypoint == "echo"
        assert app.roles[0].resource.gpu is None

    def test_from_dict_no_roles(self):
        with pytest.raises(ValueError):
            appdef_from_dict({"name": "x"})

    def test_a_tpu_slice_is_refused_by_name(self):
        from torchx_tpu.specs.api import TpuSlice

        japp = jspecs.AppDef(name="t", roles=[jspecs.Role(
            name="trainer", resource=jspecs.Resource(tpu=TpuSlice("v5p", 16)))])
        with pytest.raises(ValueError, match="'tpu'"):
            appdef_from_dict(jserialize.appdef_to_dict(japp))

    def test_bad_gpu_entries_raise(self):
        spec = {"roles": [{"name": "r", "resource": {"gpu": {"accelerator": "h100",
                                                             "gpus": 12}}}]}
        with pytest.raises(ValueError, match="whole hosts"):
            appdef_from_dict(spec)
        spec["roles"][0]["resource"]["gpu"] = {"accelerator": "v5p", "gpus": 8}
        with pytest.raises(ValueError, match="unknown GPU generation"):
            appdef_from_dict(spec)

    def test_supervisor_policy_waits_for_its_layer(self):
        """Its layer (ROADMAP queue 1 item 2.4) has landed: an empty dict is
        the default policy, and a mistyped key raises."""
        from torchx_tpu_torch.specs.serialize import supervisor_policy_from_dict
        from torchx_tpu_torch.supervisor import SupervisorPolicy

        assert supervisor_policy_from_dict({}) == SupervisorPolicy()
        with pytest.raises(ValueError, match="unknown supervisor policy keys"):
            supervisor_policy_from_dict({"max_preemption": 1})


# -- parity with the JAX package's specs --------------------------------------

MOUNTS = [
    ["type=bind,src=/host,dst=/job,readonly"],
    ["type=bind,src=/a,dst=/b", "type=volume,src=models,dst=/models,readonly=false"],
    ["type=device,src=/dev/nvidia0,perm=rw"],
    ["type=bind,source=/x,target=/y", "type=device,src=/dev/fuse,dst=/dev/f"],
    ["src=/a,dst=/b"],
    ["type=bind,src=/a"],
    ["type=volume,dst=/b"],
    ["type=nope,src=/a,dst=/b"],
    ["type=bind,src=/a,dst=/b", "type=volume,src=v,dst=/b"],
]


def _outcome(fn, *args):
    try:
        return fn(*args)
    except Exception as e:  # noqa: BLE001 - the exception is the outcome compared
        return (type(e).__name__, str(e))


def _plain(obj):
    """A dataclass or list of them as plain data (the two packages' classes
    differ by module)."""
    if isinstance(obj, list):
        return [_plain(o) for o in obj]
    if dataclasses.is_dataclass(obj):
        return (type(obj).__name__, dataclasses.asdict(obj))
    return obj


@pytest.mark.parametrize("opts", MOUNTS)
def test_parse_mounts_equals_the_jax_packages(opts):
    assert _plain(_outcome(parse_mounts, opts)) == _plain(_outcome(jspecs.parse_mounts, opts))


def test_macros_apply_equals_the_jax_packages():
    def role(mod):
        return mod.Role(
            name="trainer", image="img", entrypoint=f"{macros.img_root}/bin/run",
            args=["-c", f"run --id {macros.app_id} --r {macros.replica_id}"
                  f" --n {macros.num_replicas} --coord $${macros.coordinator_env} ${{other}}"],
            env={"LOGROOT": f"{macros.img_root}/logs", "K": "$$literal"},
            mounts=[mod.BindMount(src_path=f"{macros.img_root}/d", dst_path=f"/{macros.app_id}"),
                    mod.VolumeMount(src=macros.app_id, dst_path=f"/v/{macros.replica_id}"),
                    mod.DeviceMount(src_path="/dev/nvidia0", dst_path=f"/d{macros.replica_id}")],
        )

    for values in ({"img_root": "/img", "app_id": "app_1", "replica_id": "3",
                    "num_replicas": "4"}, {"coordinator_env": "MY_HOST"}, {}):
        ours = macros.Values(**values).apply(role(tspecs))
        theirs = jspecs.macros.Values(**values).apply(role(jspecs))
        assert (ours.entrypoint, ours.args, ours.env, _plain(ours.mounts)) \
            == (theirs.entrypoint, theirs.args, theirs.env, _plain(theirs.mounts))


def _schema(mod):
    opts = mod.runopts()
    opts.add("log_dir", type_=str, help="log dir", default="/tmp/logs")
    opts.add("replicas", type_=int, help="n", default=1)
    opts.add("ratio", type_=float, help="r", default=0.5)
    opts.add("mounts", type_=list, help="mounts", default=None)
    opts.add("labels", type_=dict, help="labels", default=None)
    opts.add("detach", type_=bool, help="detach", default=False)
    opts.add("image_repo", type_=str, help="repo", default=None)
    opts.add("project", type_=str, help="gcp project", required=True)
    return opts


CFGS = [
    {"project": "p1"},
    {},
    {"project": "p", "replicas": "3", "Detach": "true", "imageRepo": "r"},
    {"project": "p", "replicas": "abc"},
    {"project": "p", "replicas": 2.5},
    {"project": "p", "ratio": 2},
    {"project": "p", "detach": "maybe"},
    {"project": "p", "mounts": "a,b", "labels": "a:1,b:2"},
    {"project": "p", "replicas": None},
    {"project": "p", "parity_plugin_knob": "x"},
]


@pytest.mark.parametrize("cfg", CFGS)
def test_runopts_resolve_equals_the_jax_packages(cfg):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ours = _outcome(_schema(tspecs).resolve, cfg)
        theirs = _outcome(_schema(jspecs).resolve, cfg)
    assert ours == theirs
    assert repr(_schema(tspecs)) == repr(_schema(jspecs))


CFG_STRS = ["", "project=p,replicas=2;detach=yes", "mounts=a,b,c;project=p",
            "labels=team:ml", "labels=a:1,b:2;project=p", "unknown=1,replicas=x",
            "project=p,stray", "ratio=0.25;imageRepo=r"]


@pytest.mark.parametrize("cfg_str", CFG_STRS)
def test_cfg_from_str_equals_the_jax_packages(cfg_str):
    ours = _outcome(_schema(tspecs).cfg_from_str, cfg_str)
    theirs = _outcome(_schema(jspecs).cfg_from_str, cfg_str)
    assert ours == theirs


@pytest.mark.parametrize("handle", ["gke://sess/app_abc123", "local:///app1", "not-a-handle",
                                    "slurm://s/a/b/c", "UPPER://s/a", "docker://s/"])
def test_app_handles_equal_the_jax_packages(handle):
    ours = _outcome(parse_app_handle, handle)
    theirs = _outcome(jspecs.parse_app_handle, handle)
    assert ours == theirs
    if isinstance(ours, tuple) and len(ours) == 3:
        assert make_app_handle(*ours) == jspecs.make_app_handle(*theirs) == handle


def test_status_model_equals_the_jax_packages():
    assert [(s.name, s.value) for s in AppState] == [(s.name, s.value) for s in jspecs.AppState]
    assert [s.value for s in RetryPolicy] == [s.value for s in jspecs.RetryPolicy]
    for state in AppState:
        jstate = jspecs.AppState(state.value)
        assert (is_terminal(state), is_started(state)) == (jspecs.is_terminal(jstate),
                                                           jspecs.is_started(jstate))
    err = json.dumps({"message": {"message": "boom", "extraInfo": {"timestamp": 0,
                                                                   "py_callstack": "tb"}},
                      "exitcode": 3, "hostname": "w0"})
    for msg in (err, '"oom"', "not json", tspecs.NONE):
        ours = AppStatus(state=AppState.FAILED, msg="m", structured_error_msg=msg,
                         failure_class=tspecs.FailureClass.PREEMPTION,
                         roles=[tspecs.RoleStatus("r", [tspecs.ReplicaStatus(
                             0, AppState.FAILED, "r", "h0")])])
        theirs = jspecs.AppStatus(state=jspecs.AppState.FAILED, msg="m", structured_error_msg=msg,
                                  failure_class=jspecs.FailureClass.PREEMPTION,
                                  roles=[jspecs.RoleStatus("r", [jspecs.ReplicaStatus(
                                      0, jspecs.AppState.FAILED, "r", "h0")])])
        assert ours.format() == theirs.format() and str(ours) == str(theirs)
        assert ours.format(colored=True) == theirs.format(colored=True)


@pytest.mark.parametrize("spec", ["", ".", "./src=app/src,./conf=conf", " a = b "])
def test_workspace_spec_equals_the_jax_packages(spec):
    assert Workspace.from_str(spec).projects == jspecs.Workspace.from_str(spec).projects


def _resource_data(res):
    return (res.cpu, res.memMB, res.capabilities, res.devices, res.tags)


@pytest.mark.parametrize("catalog, ours", [(jgeneric, named_resources_generic),
                                           (jgcp, named_resources_gcp)])
def test_catalogs_equal_the_jax_packages(catalog, ours):
    theirs = catalog()
    assert list(ours()) == list(theirs)
    for name, factory in ours().items():
        res = factory()
        assert res.gpu is None and theirs[name]().tpu is None
        assert _resource_data(res) == _resource_data(theirs[name]()), name
        assert _resource_data(named_resources[name]) == _resource_data(jspecs.named_resources[name])
        assert factory.__name__ == theirs[name].__name__


def _app(mod, with_extras: bool):
    ws = mod.Workspace(projects={"./src": "app/src"}) if with_extras else None
    return mod.AppDef(
        name="train", metadata={"team": "ml", "tpx/x": "1"},
        roles=[
            mod.Role(name="trainer", image="img:1", entrypoint="python", args=["-m", "t"],
                     env={"A": "1"}, num_replicas=2, min_replicas=1 if with_extras else None,
                     max_retries=3, retry_policy=mod.RetryPolicy.ROLE,
                     port_map={"coordinator": 8476},
                     metadata={"overlays": {"gke": {"a": 1}}},
                     resource=mod.Resource(cpu=8, memMB=1024, capabilities={"spot": True},
                                           devices={"nvidia.com/gpu": 8}, tags={"t": "1"}),
                     mounts=[mod.BindMount(src_path="/a", dst_path="/b", read_only=True),
                             mod.VolumeMount(src="v", dst_path="/v"),
                             mod.DeviceMount(src_path="/dev/fuse", dst_path="/dev/fuse")],
                     workspace=ws),
            mod.Role(name="side"),
        ],
    )


@pytest.mark.parametrize("with_extras", [False, True])
def test_serialization_equals_the_jax_packages(with_extras):
    """An AppDef without accelerators: each package's JSON is byte-equal
    after a round trip through the other package's reader, and the two
    differ only in the accelerator key's name (``gpu`` for ``tpu``, both
    null)."""
    ours = json.dumps(appdef_to_dict(_app(tspecs, with_extras)))
    theirs = json.dumps(jserialize.appdef_to_dict(_app(jspecs, with_extras)))
    via_theirs = json.dumps(appdef_to_dict(appdef_from_dict(json.loads(theirs))))
    via_ours = json.dumps(jserialize.appdef_to_dict(jserialize.appdef_from_dict(json.loads(ours))),
                          )
    assert via_theirs == ours
    assert via_ours == theirs
    assert appdef_from_dict(json.loads(theirs)) == _app(tspecs, with_extras)
    assert ours.replace('"gpu": null', '"tpu": null') == theirs


# -- components: the builder and the linter against the JAX package's ---------

COMPONENT_SRC = '''
from typing import Optional
def trainer(name: str, steps: int = 10, lr: float = 3e-4, tags: Optional[list[str]] = None,
            env: dict[str, str] = None, dry: bool = False, *script_args: str) -> "AppDef":
    """Train a model.

    Args:
        name: job name
        steps: how many
            steps to run
        lr: learning rate
    """
    return AppDef(name=name, roles=[Role(name="t", entrypoint="python",
                                          args=[str(steps), str(lr), str(dry), *(tags or []),
                                                *script_args],
                                          env=env or {})])
def bad(x, y: set, **kw) -> int:
    return 1
'''


def _component(mod):
    ns = {"AppDef": mod.AppDef, "Role": mod.Role}
    exec(COMPONENT_SRC, ns)  # noqa: S102 - a fixed test source
    return ns["trainer"]


@pytest.mark.parametrize("argv", [
    ["--name", "a"],
    ["--name", "a", "--steps", "3", "--lr", "0.1", "--tags", "x,y", "--env", "K=V,L:M",
     "--dry", "true"],
    ["--steps", "3"],
    ["--name", "a", "--nope", "1"],
])
def test_materialize_appdef_equals_the_jax_packages(argv):
    from torchx_tpu.specs import builders as jbuilders
    from torchx_tpu_torch.specs import builders

    def run(mod, ser, fn):
        try:
            return json.dumps(ser(mod.materialize_appdef(fn, list(argv), {"lr": "0.5"})))
        except mod.ComponentArgumentError as e:
            return ("raised", str(e))

    ours = run(builders, appdef_to_dict, _component(tspecs))
    theirs = run(jbuilders, jserialize.appdef_to_dict, _component(jspecs))
    if isinstance(theirs, str):
        theirs = theirs.replace('"tpu": null', '"gpu": null')
    assert ours == theirs
    assert builders.component_args_from_str("--a 'b c'") == ["--a", "b c"]


def test_file_linter_equals_the_jax_packages():
    from torchx_tpu.specs import file_linter as jlinter
    from torchx_tpu_torch.specs import file_linter

    for fn in ("trainer", "bad", "missing"):
        ours = file_linter.validate_source(COMPONENT_SRC, fn, include_warnings=True)
        theirs = jlinter.validate_source(COMPONENT_SRC, fn, include_warnings=True)
        assert [dataclasses.asdict(m) for m in ours] == [dataclasses.asdict(m) for m in theirs]
    assert [m.code for m in file_linter.validate_source(COMPONENT_SRC, "bad")] \
        == ["TPX002", "TPX003", "TPX004", "TPX005"]
    assert file_linter.validate_source("def (", "x")[0].code == "TPX001"
    doc = _component(tspecs).__doc__
    assert file_linter.parse_docstring(doc) == jlinter.parse_docstring(doc)
