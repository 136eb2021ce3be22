"""The port's components (``torchx_tpu_torch.components``), its finder and
its linter, held to every case of ``tests/test_components.py`` and
``tests/test_components_extra.py`` run against the copy (reference analog:
torchx/components/test/, specs/test/builders_test, finder_test). The TPU
cases are translated one for one: ``--tpu v5p-32`` is ``--gpu h100-16``
(16 cards, 2 hosts), ``h="v5litepod-8"`` is ``h="h100-8"``, the CPU mode's
``XLA_FLAGS`` device count is ``--nproc-per-node N --backend gloo`` and the
debug preset is NCCL's. Added: ``dist.spmd``'s GPU and CPU requests as the
port's local scheduler materializes them, the serve components'
``--device cpu`` without a card, and parity with the JAX package on the
same inputs (``TestJaxParity``: ``dist.spmd`` and ``dist.ddp`` AppDefs,
the finder's builtins, the linter's findings)."""

import subprocess
import sys
import time
import warnings

import pytest

from torchx_tpu_torch import settings
from torchx_tpu_torch.components import metrics, serve, utils
from torchx_tpu_torch.components.component_test_base import ComponentTestCase
from torchx_tpu_torch.components.dist import parse_j
from torchx_tpu_torch.components.structured_arg import (
    StructuredJArgument,
    StructuredNameArgument,
)
from torchx_tpu_torch.schedulers import local_scheduler as lsched
from torchx_tpu_torch.specs.builders import (
    ComponentArgumentError,
    component_args_from_str,
    materialize_appdef,
)
from torchx_tpu_torch.specs.file_linter import parse_docstring, validate_source
from torchx_tpu_torch.specs.finder import (
    ComponentNotFoundException,
    get_component,
    get_components,
)
from torch_threads import xdist_torch_threads  # noqa: F401


@pytest.fixture(autouse=True)
def _no_lint_own_registry(tmp_path, monkeypatch):
    """The runner's lint gate is bypassed (it raises until ROADMAP queue 1
    item 2.8), the local scheduler's registry lives in ``tmp_path``, and the
    host has no card."""
    monkeypatch.setenv(settings.ENV_TPX_NO_LINT, "1")
    monkeypatch.setattr(lsched, "_registry_path", lambda: str(tmp_path / "registry"))
    monkeypatch.delenv(settings.ENV_CUDA_VISIBLE_DEVICES, raising=False)
    monkeypatch.setattr(lsched, "driver_gpu_count", lambda: 0)


class TestParseJ:
    def test_forms(self):
        assert parse_j("2x4") == (None, 2, 4)
        assert parse_j("4") == (None, 4, None)
        assert parse_j("1:4") == (1, 4, None)
        assert parse_j("1:4x8") == (1, 4, 8)

    def test_invalid(self):
        for bad in ("", "x4", "ax2", "1:2:3"):
            with pytest.raises(ValueError):
                parse_j(bad)


class TestFinder:
    def test_builtins_discovered(self):
        components = get_components()
        for expected in ("dist.spmd", "dist.ddp", "utils.echo", "utils.sh", "utils.python"):
            assert expected in components, expected

    def test_get_component_unknown(self):
        with pytest.raises(ComponentNotFoundException):
            get_component("nope.nothing")

    def test_custom_file_component(self, tmp_path):
        f = tmp_path / "comp.py"
        f.write_text(
            "from torchx_tpu_torch.specs import AppDef, Role\n"
            "def my_comp(msg: str = 'hi') -> AppDef:\n"
            "    '''My component.\n\n    Args:\n        msg: the message\n    '''\n"
            "    return AppDef(name='x', roles=[Role(name='r', image='i', entrypoint='echo', args=[msg])])\n"
        )
        c = get_component(f"{f}:my_comp")
        app = materialize_appdef(c.fn, ["--msg", "yo"])
        assert app.roles[0].args == ["yo"]

    def test_custom_file_component_missing_fn(self, tmp_path):
        f = tmp_path / "comp.py"
        f.write_text("x = 1\n")
        with pytest.raises(ComponentNotFoundException):
            get_component(f"{f}:nope")


class TestMaterialize:
    def test_spmd_materialize(self):
        c = get_component("dist.spmd")
        app = materialize_appdef(
            c.fn,
            ["-j", "2x4", "--script", "train.py", "--", "--lr", "0.1"],
        )
        role = app.roles[0]
        assert role.num_replicas == 2
        assert "--script" in role.args and "train.py" in role.args
        assert role.args[-2:] == ["--lr", "0.1"]
        # the JAX case's XLA_FLAGS device count: 4 gloo workers a replica
        i = role.args.index("--nproc-per-node")
        assert role.args[i:i + 4] == ["--nproc-per-node", "4", "--backend", "gloo"]

    def test_spmd_gpu_slice(self):
        c = get_component("dist.spmd")
        app = materialize_appdef(c.fn, ["--gpu", "h100-16", "-m", "train"])
        role = app.roles[0]
        assert role.resource.gpu.gpus == 16 and role.resource.gpu.hosts == 2
        assert role.num_replicas == 1  # one slice; hosts derived by scheduler

    def test_spmd_elastic(self):
        c = get_component("dist.spmd")
        app = materialize_appdef(c.fn, ["-j", "1:4", "-m", "train"])
        assert app.roles[0].min_replicas == 1
        assert app.roles[0].num_replicas == 4

    def test_spmd_requires_script_or_m(self):
        c = get_component("dist.spmd")
        with pytest.raises(ValueError):
            materialize_appdef(c.fn, ["-j", "1"])

    def test_ddp_single_node_endpoint(self):
        c = get_component("dist.ddp")
        app = materialize_appdef(c.fn, ["-j", "1x2", "--script", "t.py"])
        args = " ".join(app.roles[0].args)
        assert "localhost:0" in args

    def test_ddp_multi_node_defers_endpoint(self):
        c = get_component("dist.ddp")
        app = materialize_appdef(c.fn, ["-j", "2x2", "--script", "t.py"])
        role = app.roles[0]
        assert role.entrypoint == "sh"
        joined = " ".join(role.args)
        # macro still unsubstituted at materialize time
        assert "${coordinator_env}" in joined

    def test_echo_defaults(self):
        c = get_component("utils.echo")
        app = materialize_appdef(c.fn, [])
        assert app.roles[0].args == ["hello world"]

    def test_component_defaults_from_config(self):
        c = get_component("utils.echo")
        app = materialize_appdef(c.fn, [], defaults={"msg": "from-config"})
        assert app.roles[0].args == ["from-config"]

    def test_cli_overrides_config_defaults(self):
        c = get_component("utils.echo")
        app = materialize_appdef(
            c.fn, ["--msg", "from-cli"], defaults={"msg": "from-config"}
        )
        assert app.roles[0].args == ["from-cli"]

    def test_required_arg_missing(self):
        c = get_component("utils.touch")
        with pytest.raises(ComponentArgumentError):
            materialize_appdef(c.fn, [])

    def test_dict_and_bool_decoding(self):
        c = get_component("dist.spmd")
        app = materialize_appdef(
            c.fn,
            ["-m", "t", "--env", "A=1,B=2", "--debug", "true"],
        )
        role = app.roles[0]
        assert role.env["A"] == "1" and role.env["B"] == "2"
        assert role.env["NCCL_DEBUG"] == "INFO"  # debug preset applied

    def test_args_from_str(self):
        assert component_args_from_str("-j 1x2 --msg 'a b'") == ["-j", "1x2", "--msg", "a b"]


class TestLinter:
    def test_valid_component(self):
        src = (
            "def c(x: int, y: str = 'a') -> AppDef:\n"
            "    '''doc'''\n"
            "    return AppDef(name='x')\n"
        )
        assert validate_source(src, "c") == []

    def test_missing_annotation(self):
        src = "def c(x) -> AppDef:\n    '''d'''\n    return None\n"
        errors = validate_source(src, "c")
        assert any("missing a type annotation" in e.description for e in errors)

    def test_unsupported_type(self):
        src = "def c(x: object) -> AppDef:\n    '''d'''\n    return None\n"
        errors = validate_source(src, "c")
        assert any("unsupported type" in e.description for e in errors)

    def test_missing_return(self):
        src = "def c(x: int):\n    '''d'''\n    return None\n"
        errors = validate_source(src, "c")
        assert any("return annotation" in e.description for e in errors)

    def test_kwargs_rejected(self):
        src = "def c(**kw: str) -> AppDef:\n    '''d'''\n    return None\n"
        errors = validate_source(src, "c")
        assert any("kwargs" in e.description for e in errors)

    def test_fn_not_found(self):
        errors = validate_source("x = 1", "c")
        assert errors and "not found" in errors[0].description

    def test_all_builtins_lint_clean(self):
        for name, c in get_components().items():
            assert c.validation_errors == [], f"{name}: {c.validation_errors}"

    def test_parse_docstring(self):
        summary, args = parse_docstring(
            "Does a thing.\n\n"
            "    Args:\n"
            "        alpha: first arg\n"
            "            continued help\n"
            "        beta: second arg\n"
        )
        assert summary == "Does a thing."
        assert args["alpha"] == "first arg continued help"
        assert args["beta"] == "second arg"


# -- tests/test_components_extra.py -----------------------------------------


class TestStructuredArgs:
    def test_name_parse(self):
        a = StructuredNameArgument.parse_from("exp/run")
        assert (a.app_name, a.role_name) == ("exp", "run")
        a = StructuredNameArgument.parse_from("justapp")
        assert a.app_name == "justapp" and a.role_name == "role"
        a = StructuredNameArgument.parse_from("/justrole")
        assert a.app_name == "app" and a.role_name == "justrole"

    def test_j_parse_explicit(self):
        a = StructuredJArgument.parse_from("1:2x4")
        assert (a.min_replicas, a.replicas, a.nproc) == (1, 2, 4)
        assert str(a) == "1:2x4"

    def test_j_nproc_inferred_from_named_resource(self):
        a = StructuredJArgument.parse_from("2", h="h100-8")
        assert a.nproc == 8
        a = StructuredJArgument.parse_from("2", h="cpu_small")
        assert a.nproc == 1


class TestAuxComponents(ComponentTestCase):
    def test_tensorboard_lints(self):
        self.validate(metrics, "tensorboard")

    def test_model_server_lints(self):
        self.validate(serve, "model_server")

    def test_tensorboard_materializes(self):
        app = materialize_appdef(
            metrics.tensorboard,
            ["--logdir", "/mnt/logs", "--exit_on_file", "/mnt/logs/DONE"],
        )
        args = " ".join(app.roles[0].args)
        assert "process_monitor" in args
        assert "--logdir /mnt/logs" in args
        assert "--exit_on_file /mnt/logs/DONE" in args
        assert app.roles[0].port_map["http"] == 6006

    def test_model_server_materializes(self):
        app = materialize_appdef(
            serve.model_server,
            [
                "--model_path",
                "gs://b/m",
                "--management_api",
                "http://srv:8081",
            ],
        )
        args = app.roles[0].args
        assert "gs://b/m" in args and "http://srv:8081" in args

    def test_run_component_helper(self, tmp_path=None):
        handle = self.run_component(
            utils.echo, ["--msg", "from-component-test"], scheduler="local"
        )
        assert handle.startswith("local://")


class TestProcessMonitor:
    def test_exit_on_file(self, tmp_path):
        marker = tmp_path / "DONE"
        proc = subprocess.Popen(
            [
                sys.executable,
                "-m",
                "torchx_tpu_torch.apps.process_monitor",
                "--poll_interval",
                "0.1",
                "--",
                "sleep",
                "30",
            ],
        )
        time.sleep(1.0)
        assert proc.poll() is None
        marker.write_text("")
        # no exit_on_file passed -> still running; now test with the flag
        proc.terminate()
        proc.wait()

        proc = subprocess.Popen(
            [
                sys.executable,
                "-m",
                "torchx_tpu_torch.apps.process_monitor",
                "--poll_interval",
                "0.1",
                "--exit_on_file",
                str(marker),
                "--",
                "sleep",
                "30",
            ],
        )
        assert proc.wait(timeout=15) == 0

    def test_timeout(self):
        t0 = time.monotonic()
        rc = subprocess.run(
            [
                sys.executable,
                "-m",
                "torchx_tpu_torch.apps.process_monitor",
                "--timeout",
                "1",
                "--poll_interval",
                "0.1",
                "--",
                "sleep",
                "30",
            ],
            timeout=20,
        ).returncode
        assert rc == 0
        assert time.monotonic() - t0 < 15

    def test_propagates_exit_code(self):
        rc = subprocess.run(
            [
                sys.executable,
                "-m",
                "torchx_tpu_torch.apps.process_monitor",
                "--poll_interval",
                "0.1",
                "--",
                "sh",
                "-c",
                "exit 3",
            ],
            timeout=20,
        ).returncode
        assert rc == 3


class TestNotebook:
    def test_workspacefile(self, monkeypatch, tmp_path):
        import torchx_tpu_torch.notebook as nb

        monkeypatch.setattr(nb, "_workspace_dir", str(tmp_path))
        nb.workspacefile("sub/main.py", "print('hi')\n")
        assert (tmp_path / "sub" / "main.py").read_text() == "print('hi')\n"

    def test_empty_line_rejected(self):
        import torchx_tpu_torch.notebook as nb

        with pytest.raises(ValueError):
            nb.workspacefile("", "x")


class TestDeprecations:
    def test_deprecated_warns(self):
        from torchx_tpu_torch.deprecations import deprecated

        @deprecated(replacement="new_fn", since="0.2")
        def old_fn():
            return 42

        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            assert old_fn() == 42
        assert any("new_fn" in str(x.message) for x in w)


# -- the port's dist.spmd and serve components, as requested ------------------


class TestSpmdRequests:
    """``dist.spmd`` through the runner's dryrun on the port's local
    scheduler: the replicas it starts and the bootstrap each one runs."""

    def _replicas(self, args, cfg=None):
        from torchx_tpu_torch.runner.api import get_runner

        app = materialize_appdef(get_component("dist.spmd").fn, args)
        with get_runner("spmd-requests") as runner:
            info = runner.dryrun(app, "local", {"log_dir": "/tmp/unused", **(cfg or {})})
        (replicas,) = info.request.role_params.values()
        return app.roles[0], replicas

    def test_gpu_slice_is_one_replica_a_host(self):
        role, replicas = self._replicas(["--gpu", "h100-16", "-m", "train", "--", "--x"],
                                        {"gpu_simulate": True})
        assert len(replicas) == role.resource.gpu.hosts == 2
        for i, rp in enumerate(replicas):
            j = rp.args.index("-m")
            assert rp.args[j:j + 2] == ["-m", "torchx_tpu_torch.apps.spmd_main"]
            # one worker a visible card: spmd_main counts them itself, on NCCL
            assert "--nproc-per-node" not in rp.args and "--backend" not in rp.args
            assert rp.args[-3:] == ["train", "--", "--x"]
            assert rp.env["TPX_REPLICA_ID"] == str(i) and rp.env["TPX_NUM_REPLICAS"] == "2"

    def test_named_resource_and_slices(self):
        role, replicas = self._replicas(["-h", "h100_8", "-j", "2", "-m", "train"],
                                        {"gpu_simulate": True})
        assert role.resource.gpu.gpus == 8 and role.num_replicas == 2
        assert len(replicas) == 2  # two slices of one host each

    def test_cpu_mode_runs_gloo_workers(self):
        role, replicas = self._replicas(["-j", "3x2", "--script", "t.py"])
        assert role.resource.gpu is None and len(replicas) == 3
        assert role.env == {}  # no JAX_PLATFORMS / XLA_FLAGS
        for rp in replicas:
            i = rp.args.index("--nproc-per-node")
            assert rp.args[i:i + 4] == ["--nproc-per-node", "2", "--backend", "gloo"]
        _, (one,) = self._replicas(["-m", "train"])
        i = one.args.index("--nproc-per-node")
        assert one.args[i:i + 4] == ["--nproc-per-node", "1", "--backend", "gloo"]

    def test_coordinator_port_reaches_spmd_main(self):
        _, (rp,) = self._replicas(["-j", "1x2", "--coordinator_port", "0", "-m", "train"])
        i = rp.args.index("--port")
        assert rp.args[i + 1] == "0"


class TestServeDevice:
    """The port's server runs on the card unless asked for the CPU: a
    server without a GPU resource is given ``--device cpu``."""

    def test_generate_server(self):
        cpu = materialize_appdef(serve.generate_server, ["--config", "tiny"]).roles[0]
        assert cpu.args[-2:] == ["--device", "cpu"] and cpu.resource.gpu is None
        assert cpu.args[:2] == ["-m", "torchx_tpu_torch.apps.generate_server"]
        card = materialize_appdef(serve.generate_server,
                                  ["--config", "tiny", "--gpu", "h100-1"]).roles[0]
        assert "--device" not in card.args and card.resource.gpu.gpus == 1

    def test_disaggregated_pair(self):
        app = materialize_appdef(serve.generate_server_disagg, ["--config", "tiny"])
        for role in app.roles:
            assert role.args[-2:] == ["--device", "cpu"]
            assert role.args[role.args.index("--serve-role") + 1] == role.name
        app = materialize_appdef(serve.generate_server_disagg,
                                 ["--config", "tiny", "--gpu", "h100-1"])
        assert all("--device" not in r.args and r.resource.gpu.gpus == 1 for r in app.roles)


# -- parity: the same inputs through the JAX package and the port -----------


class TestJaxParity:
    """``dist.spmd`` / ``dist.ddp`` built from the same arguments by both
    packages, the finder's builtins and the linter's findings on the same
    sources: equal but for the named TPU/GPU differences."""

    JAX_CPU_ENV = {"JAX_PLATFORMS", "XLA_FLAGS"}

    @staticmethod
    def _apps(fn_name, jkw, tkw, *args):
        import dataclasses

        from torchx_tpu.components import dist as jdist

        from torchx_tpu_torch.components import dist as tdist

        japp = getattr(jdist, fn_name)(*args, **jkw)
        tapp = getattr(tdist, fn_name)(*args, **tkw)
        (jrole,), (trole,) = japp.roles, tapp.roles
        jd, td = dataclasses.asdict(japp), dataclasses.asdict(tapp)
        assert {k: v for k, v in td.items() if k != "roles"} == \
            {k: v for k, v in jd.items() if k != "roles"}
        return jrole, trole, dataclasses.asdict(jrole), dataclasses.asdict(trole)

    @pytest.mark.parametrize("jkw, tkw", [
        ({}, {}),
        ({"j": "2x2"}, {"j": "2x2"}),
        ({"j": "3"}, {"j": "3"}),
        ({"j": "1:2x4", "max_retries": 3}, {"j": "1:2x4", "max_retries": 3}),
        ({"env": {"A": "1"}, "debug": True, "name": "job"},
         {"env": {"A": "1"}, "debug": True, "name": "job"}),
        ({"coordinator_port": 0, "cpu": 4, "memMB": 1024},
         {"coordinator_port": 0, "cpu": 4, "memMB": 1024}),
        ({"tpu": "v5p-16"}, {"gpu": "h100-16"}),
        ({"tpu": "v5litepod-8", "j": "2", "debug": True}, {"gpu": "h100-8", "j": "2", "debug": True}),
        ({"h": "tpu_v5p_16", "image": "img:1"}, {"h": "h100_8", "image": "img:1"}),
    ], ids=["default", "2x2", "3", "min-retries", "env-debug-name", "port0-cpu-mem",
            "slice", "slices-debug", "named-image"])
    @pytest.mark.parametrize("target", [{"m": "my.mod"}, {"script": "train.py"}])
    def test_spmd_appdef_equals_jax(self, jkw, tkw, target):
        from torchx_tpu import version as jversion
        from torchx_tpu.components import dist as jdist

        from torchx_tpu_torch import version as tversion
        from torchx_tpu_torch.components import dist as tdist

        jrole, trole, jd, td = self._apps("spmd", {**jkw, **target}, {**tkw, **target},
                                          "--lr", "0.1")
        same = set(jd) - {"image", "args", "env", "resource"}
        assert {k: td[k] for k in same} == {k: jd[k] for k in same}
        image = jkw.get("image")
        assert (jrole.image, trole.image) == (image or jversion.TORCHX_TPU_IMAGE,
                                             image or tversion.TORCHX_TPU_IMAGE)
        on_cpu = jrole.resource.tpu is None
        assert (trole.resource.gpu is None) == on_cpu
        # the bootstrap's module; on the CPU the port's gloo workers in place
        # of the JAX process's simulated devices
        args = ["torchx_tpu.apps.spmd_main" if a == "torchx_tpu_torch.apps.spmd_main" else a
                for a in trole.args]
        if on_cpu:
            nproc = (jkw.get("j", "1").split("x") + ["1"])[1]
            i = args.index("--port") + 2
            assert args[i:i + 4] == ["--nproc-per-node", nproc, "--backend", "gloo"]
            del args[i:i + 4]
            assert (trole.resource.cpu, trole.resource.memMB) == \
                (jrole.resource.cpu, jrole.resource.memMB)
        else:
            assert trole.resource == (tdist.specs.resource(h=tkw["h"]) if "h" in tkw
                                      else tdist.specs.named_resources[tkw["gpu"]])
        assert args == jrole.args
        jenv = {k: v for k, v in jrole.env.items()
                if k not in self.JAX_CPU_ENV and k not in jdist._TPU_DEBUG_FLAGS}
        tenv = {k: v for k, v in trole.env.items() if k not in tdist._GPU_DEBUG_FLAGS}
        assert tenv == jenv
        if jkw.get("debug"):
            assert {k: trole.env[k] for k in tdist._GPU_DEBUG_FLAGS} == tdist._GPU_DEBUG_FLAGS

    @pytest.mark.parametrize("kw", [
        {"j": "1x2"}, {"j": "2x4", "rdzv_port": 29600}, {"j": "3", "debug": True},
        {"env": {"A": "1"}, "max_retries": 2, "name": "ddp-job", "image": "img:1"},
    ])
    def test_ddp_appdef_equals_jax(self, kw):
        from torchx_tpu import version as jversion

        from torchx_tpu_torch import version as tversion

        jrole, trole, jd, td = self._apps("ddp", {**kw, "script": "t.py"},
                                          {**kw, "script": "t.py"}, "--x", "1")
        same = set(jd) - {"image", "resource"}
        assert {k: td[k] for k in same} == {k: jd[k] for k in same}
        assert (jrole.image, trole.image) == (kw.get("image", jversion.TORCHX_TPU_IMAGE),
                                             kw.get("image", tversion.TORCHX_TPU_IMAGE))
        assert jrole.resource.tpu is None and trole.resource.gpu is None
        assert (trole.resource.cpu, trole.resource.memMB) == \
            (jrole.resource.cpu, jrole.resource.memMB)

    def test_builtin_components_equal_jax(self):
        """The same builtin names, each lint-clean in both, with the same
        parameters and defaults but the accelerator's (``tpu`` is ``gpu``)
        and the default image."""
        import inspect

        from torchx_tpu.specs import finder as jfinder

        jcomps, tcomps = jfinder.get_components(), get_components()
        assert sorted(tcomps) == sorted(jcomps)
        for name in jcomps:
            jc, tc = jcomps[name], tcomps[name]
            assert tc.validation_errors == jc.validation_errors == [], name
            jparams = inspect.signature(jc.fn).parameters
            tparams = inspect.signature(tc.fn).parameters
            assert list(tparams) == [{"tpu": "gpu"}.get(p, p) for p in jparams], name
            for p, jp in jparams.items():
                tp = tparams[{"tpu": "gpu"}.get(p, p)]
                if p not in ("tpu", "image"):
                    assert (tp.kind, tp.default) == (jp.kind, jp.default), (name, p)

    @pytest.mark.parametrize("src", [
        "def c(x: int, y: str = 'a') -> AppDef:\n    '''doc'''\n    return AppDef(name='x')\n",
        "def c(x) -> AppDef:\n    '''d'''\n    return None\n",
        "def c(x: object) -> AppDef:\n    '''d'''\n    return None\n",
        "def c(x: int):\n    '''d'''\n    return None\n",
        "def c(**kw: str) -> AppDef:\n    '''d'''\n    return None\n",
        "def c(x: int) -> AppDef:\n    return None\n",
        "def c(x: Optional[list[str]] = None, *a: str) -> specs.AppDef:\n    '''d'''\n",
        "def c(:\n",
        "x = 1\n",
    ], ids=["valid", "annotation", "type", "return", "kwargs", "docstring", "varargs",
            "syntax", "not-found"])
    def test_linter_findings_equal_jax(self, src):
        import dataclasses

        from torchx_tpu.specs.file_linter import validate_source as jvalidate

        for warnings_too in (False, True):
            jmsgs = [dataclasses.asdict(m) for m in jvalidate(src, "c", "f.py", warnings_too)]
            tmsgs = [dataclasses.asdict(m) for m in validate_source(src, "c", "f.py", warnings_too)]
            assert tmsgs == jmsgs
