"""The PyTorch port stands alone: importing it loads neither JAX nor the
JAX package, no module imports them (or imports Triton at module level),
and its entry points (the trainer and the generation server) run on the
CUDA device unless the CPU is asked for."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from torchx_tpu_torch.apps import generate_server
from torchx_tpu_torch.examples import train_llama
from torchx_tpu_torch.models import llama
from torch_threads import xdist_torch_threads  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "torchx_tpu_torch"
FORBIDDEN = ("jax", "torchx_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _sources():
    return sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, importlib.util, pkgutil, sys\n"
        "import torchx_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "torchx_tpu_torch.__path__, 'torchx_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "spec = importlib.util.spec_from_file_location('chip_smoke', sys.argv[1])\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules if m == 'triton' or m == 'jax'"
        " or m.startswith('jax.') or m == 'torchx_tpu'"
        " or m.startswith('torchx_tpu.'))\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", code, str(REPO / "chip_smoke.py")],
        env=env, capture_output=True, text=True, timeout=300, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    # every module was walked: each .py file but the package's __init__
    assert int(proc.stdout.split()[0]) == len(list(PKG.rglob("*.py"))) - 1


#: The serving modules, which must exist and stand alone.
SERVING_MODULES = (
    "ops/paged_attention.py", "models/generate.py", "obs/metrics.py", "obs/trace.py",
    "serve/kv_pool.py", "serve/prefix_cache.py", "serve/kv_transfer.py",
    "serve/engine.py", "serve/__init__.py", "apps/generate_server.py",
)


#: The int8 modules (weight-only serving and the int8 training dot) and
#: the int8-weight matmul kernel's source.
INT8_SOURCES = ("ops/quant.py", "csrc/int8_matmul.cu")


def test_int8_sources_are_present_and_built():
    from torchx_tpu_torch import _build

    for rel in INT8_SOURCES:
        assert (PKG / rel).is_file(), rel
    assert PKG / "csrc" / "int8_matmul.cu" in _build._sources()
    assert {"int8_matmul", "int8_matmul_tf32"} <= set(_build.KERNELS)
    assert not [name for name in _build.KERNELS if "simt" in name]
    # the build directory, where nvcc writes the library, stays untracked
    ignored = (REPO / ".gitignore").read_text().split()
    assert _build.BUILD_DIR.relative_to(REPO).as_posix() + "/" in ignored


#: The gang's modules (the bootstrap, the mesh, the gradient buckets).
GANG_MODULES = (
    "distributed/__init__.py", "apps/spmd_main.py", "examples/compute_mesh_size.py",
    "parallel/mesh_config.py", "parallel/mesh.py", "parallel/overlap.py",
)


def test_gang_modules_are_present():
    sources = {p.relative_to(PKG).as_posix() for p in _sources() if PKG in p.parents}
    assert set(GANG_MODULES) <= sources


def test_serving_modules_are_present():
    sources = {p.relative_to(PKG).as_posix() for p in _sources() if PKG in p.parents}
    assert set(SERVING_MODULES) <= sources


#: The checkpoint and launcher-contract modules, which must exist and stand
#: alone (the AST check below covers them like every source).
CHECKPOINT_MODULES = (
    "settings.py", "obs/sinks.py", "supervisor/__init__.py", "supervisor/gang.py",
    "parallel/checkpoint.py", "apps/eval_main.py",
)


def test_checkpoint_modules_are_present():
    sources = {p.relative_to(PKG).as_posix() for p in _sources() if PKG in p.parents}
    assert set(CHECKPOINT_MODULES) <= sources


#: The launcher's layers: helpers, specs, plugins, workspaces; the
#: control-plane seam, the scheduler contract with the local backend, and
#: the watch streams; the runner, the trackers, the in-job result tracker
#: and the components; the supervisor and the command line; the control
#: plane (client, daemon, reconciler, store), the fleet scheduler and the
#: pipelines.
LAUNCHER_PACKAGES = ("util", "specs", "plugins", "workspace", "resilience", "schedulers",
                     "control", "runner", "tracker", "runtime", "components", "supervisor",
                     "cli", "fleet", "pipelines")
#: The launcher's apps and helpers outside those packages, loaded the same way.
LAUNCHER_APPS = ("apps.process_monitor", "apps.copy_main", "apps.booth_main",
                 "apps.serve_main", "notebook")
#: The telemetry plane and the serve pool (with what they import of the
#: serving stack), which launcher processes load beside the run path, and
#: the analyzer's plan-shape reader, which the fleet placer loads.
LAUNCHER_OBS_SERVE = ("obs", "obs.metrics", "obs.trace", "obs.sinks", "obs.timeline",
                      "obs.stitch", "obs.telemetry", "obs.slo", "serve.pool",
                      "serve.kv_transfer", "serve.prefix_cache", "analyze.plan")
LAUNCHER_MODULES = (
    "settings.py", "version.py", "deprecations.py",
    *(f"util/{m}.py" for m in ("__init__", "strings", "colors", "io", "modules", "entrypoints",
                               "types", "times", "jsonl", "registry", "session",
                               "log_tee_helpers")),
    *(f"specs/{m}.py" for m in ("__init__", "api", "builders", "file_linter", "overlays",
                                "serialize", "named_resources_generic", "named_resources_gcp",
                                "named_resources_gpu", "finder")),
    "plugins/__init__.py", "plugins/_registration.py", "plugins/_registry.py",
    "workspace/__init__.py", "workspace/api.py", "workspace/dir_workspace.py",
    "workspace/docker_workspace.py",
    *(f"resilience/{m}.py" for m in ("__init__", "errors", "policy", "breaker", "faults",
                                     "call")),
    *(f"schedulers/{m}.py" for m in ("__init__", "api", "ids", "streams", "structured_opts",
                                     "devices", "local_scheduler", "docker_scheduler",
                                     "slurm_scheduler", "gke_scheduler",
                                     "gcp_batch_scheduler", "vertex_scheduler")),
    *(f"control/{m}.py" for m in ("__init__", "events", "watch", "client", "daemon",
                                  "reconciler", "store")),
    *(f"fleet/{m}.py" for m in ("__init__", "api", "model", "placer", "queue", "market")),
    *(f"pipelines/{m}.py" for m in ("__init__", "api", "dag", "promote", "engine", "legacy",
                                    "kfp", "local_runner")),
    *(f"runner/{m}.py" for m in ("__init__", "api", "config", "describe_cache")),
    *(f"runner/events/{m}.py" for m in ("__init__", "api", "handlers")),
    "tracker/__init__.py", "tracker/api.py", "tracker/mlflow.py", "tracker/backend/__init__.py",
    "tracker/backend/fsspec.py",
    "runtime/__init__.py", "runtime/tracking/__init__.py", "runtime/tracking/api.py",
    *(f"components/{m}.py" for m in ("__init__", "dist", "structured_arg", "serve", "utils",
                                     "metrics", "train", "interpret", "component_test_base",
                                     "integration_tests")),
    *(f"supervisor/{m}.py" for m in ("__init__", "api", "gang", "ledger", "policy")),
    *(f"cli/{m}.py" for m in ("__init__", "main", "cmd_base", "cmd_run", "cmd_simple",
                              "cmd_log", "cmd_tracker", "cmd_supervise", "cmd_profile",
                              "cmd_trace", "cmd_serve_pool", "cmd_unported", "cmd_control",
                              "cmd_queue", "cmd_pipeline")),
    *(f"obs/{m}.py" for m in ("__init__", "telemetry", "slo", "timeline", "stitch")),
    "serve/pool.py", "analyze/plan.py",
)
#: The apps and helpers of ``LAUNCHER_APPS``, as files.
LAUNCHER_APP_FILES = tuple(m.replace(".", "/") + ".py" for m in LAUNCHER_APPS)


def test_launcher_modules_are_present():
    sources = {p.relative_to(PKG).as_posix() for p in _sources() if PKG in p.parents}
    assert set(LAUNCHER_MODULES) | set(LAUNCHER_APP_FILES) <= sources
    # the TPU slice catalog has the GPU one in its place; the TPU-VM backend
    # has no GPU machine (Cloud TPU queued resources allocate TPU slices only)
    assert "specs/named_resources_tpu.py" not in sources
    assert "schedulers/tpu_vm_scheduler.py" not in sources
    # a remote backend or a control-plane service comes with its own layer
    assert not {s for s in sources if s.startswith(("schedulers/", "control/", "resilience/",
                                                    "runner/", "tracker/", "runtime/",
                                                    "components/", "supervisor/", "cli/",
                                                    "fleet/", "pipelines/"))} \
        - set(LAUNCHER_MODULES)


def test_launcher_modules_load_no_torch():
    """A launcher process loads no CUDA: importing every module of the
    launcher's layers (the control plane, the fleet and the pipelines
    among them), the telemetry plane and the serve pool brings in neither
    torch nor jax nor the JAX package, nor the serving engine or the
    models."""
    code = (
        "import importlib, pkgutil, sys\n"
        "names = ['torchx_tpu_torch.settings', 'torchx_tpu_torch.version',"
        " 'torchx_tpu_torch.deprecations']\n"
        f"for pkg in {LAUNCHER_PACKAGES!r}:\n"
        "    mod = importlib.import_module('torchx_tpu_torch.' + pkg)\n"
        "    names += [mod.__name__] + [m.name for m in pkgutil.walk_packages("
        "mod.__path__, mod.__name__ + '.')]\n"
        f"names += ['torchx_tpu_torch.' + m for m in {LAUNCHER_APPS + LAUNCHER_OBS_SERVE!r}]\n"
        "for n in names: importlib.import_module(n)\n"
        "from torchx_tpu_torch.specs import named_resources\n"
        "named_resources['h100-16']\n"
        "from torchx_tpu_torch.specs.finder import get_components\n"
        "assert 'dist.spmd' in get_components()\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('torch', 'jax', 'torchx_tpu', 'triton'))\n"
        "bad += [m for m in sys.modules if m == 'torchx_tpu_torch.serve.engine'"
        " or m.startswith('torchx_tpu_torch.models')]\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    # the obs, serve and analyze files of LAUNCHER_MODULES are loaded by
    # name, among LAUNCHER_OBS_SERVE, not by walking their packages
    by_name = sum(m.startswith(("obs/", "serve/", "analyze/")) for m in LAUNCHER_MODULES)
    assert int(proc.stdout.split()[0]) == \
        len(LAUNCHER_MODULES) - by_name + len(LAUNCHER_APPS) + len(LAUNCHER_OBS_SERVE)


def test_a_jax_entry_point_is_not_loaded(tmp_path, monkeypatch):
    """A plugin installed for the JAX launcher (entry-point group
    ``tpx.named_resources``) is never imported by the port's registry,
    which reads its own group ``tpx_torch.named_resources``."""
    from torchx_tpu.plugins import _registry as jregistry
    from torchx_tpu_torch.plugins import _registry as tregistry

    dist = tmp_path / "tpx_fake_plugin-0.1.dist-info"
    dist.mkdir()
    (dist / "METADATA").write_text("Metadata-Version: 2.1\nName: tpx-fake-plugin\n"
                                   "Version: 0.1\n")
    (dist / "entry_points.txt").write_text(
        "[tpx.named_resources]\njax_named_resources = tpx_fake_jax_entry:named_resources\n"
        "[tpx_torch.named_resources]\n"
        "torch_named_resources = tpx_fake_torch_entry:named_resources\n")
    for mod, name in (("tpx_fake_jax_entry", "from_jax_group"),
                      ("tpx_fake_torch_entry", "from_port_group")):
        (tmp_path / f"{mod}.py").write_text(
            f"def named_resources():\n    return {{{name!r}: lambda: None}}\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    try:
        port = tregistry.get_registry(invalidate_cache=True).named_resources
        assert "from_port_group" in port and "from_jax_group" not in port
        assert "tpx_fake_jax_entry" not in sys.modules
        # the JAX launcher reads it: the entry point is installed
        assert "from_jax_group" in jregistry.get_registry(invalidate_cache=True).named_resources
    finally:
        monkeypatch.undo()
        for mod in ("tpx_fake_jax_entry", "tpx_fake_torch_entry"):
            sys.modules.pop(mod, None)
        tregistry.get_registry(invalidate_cache=True)
        jregistry.get_registry(invalidate_cache=True)


def test_eval_main_is_stdlib_only():
    """The eval gate runs without an accelerator runtime: it imports the
    standard library only, as the JAX package's copy does."""
    tree = ast.parse((PKG / "apps" / "eval_main.py").read_text())
    mods = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names}
    mods |= {(n.module or "").split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom)}
    assert mods <= set(sys.stdlib_module_names) | {"__future__"}, mods


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            bad = [n for n in names if _forbidden(n)]
            assert not bad, f"{path.relative_to(REPO)}:{node.lineno} imports {bad}"
        for node in tree.body:  # module level: triton only inside functions
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                mod = node.module if isinstance(node, ast.ImportFrom) else node.names[0].name
                assert not (mod or "").startswith("triton"), path


class TestDevice:
    def test_train_without_cuda_raises(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_llama.train(llama.llama_tiny(), batch=1, seq=16, steps=1, device=None)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_llama.main(["--steps", "1"])

    def test_server_without_cuda_raises(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            generate_server.GenerateService("tiny")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            generate_server.main(["--config", "tiny", "--port", "0"])

    def test_server_flag_defaults_to_the_card(self, monkeypatch):
        seen = {}

        def fake_serve(config, port, *args, **kw):
            seen.update(kw)
            raise SystemExit(0)

        monkeypatch.setattr(generate_server, "serve", fake_serve)
        with pytest.raises(SystemExit):
            generate_server.main(["--config", "tiny"])
        assert seen["device"] == "cuda"

    def test_spmd_main_without_cuda_needs_the_cpu_asked_for(self, monkeypatch, capsys):
        from torchx_tpu_torch import distributed
        from torchx_tpu_torch.apps import spmd_main

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        monkeypatch.setenv("LOCAL_RANK", "0")
        monkeypatch.delenv("LOCAL_RANK")
        with pytest.raises(SystemExit):
            spmd_main.main(["-m", "torchx_tpu_torch.examples.compute_mesh_size"])
        assert "no CUDA device" in capsys.readouterr().err
        assert distributed.default_backend() == "gloo"

    def test_spmd_main_defaults_to_one_worker_a_card_on_nccl(self, monkeypatch):
        from torchx_tpu_torch import distributed
        from torchx_tpu_torch.apps import spmd_main

        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        for name in ("LOCAL_RANK", "LOCAL_WORLD_SIZE"):  # unset, and unset after
            monkeypatch.setenv(name, "0")
            monkeypatch.delenv(name)
        seen = []
        monkeypatch.setattr(spmd_main, "run_worker", lambda args, rest: seen.append(rest))
        spmd_main.main(["-m", "x", "--", "--flag"])
        assert seen == [["--flag"]] and os.environ["LOCAL_WORLD_SIZE"] == "1"
        assert distributed.default_backend() == "nccl"
        # two ranks on one card: NCCL refuses, so the bootstrap does first
        monkeypatch.delenv("LOCAL_RANK")
        with pytest.raises(SystemExit):
            spmd_main.main(["--nproc-per-node", "2", "-m", "x"])

    def test_main_on_cpu(self, capsys):
        train_llama.main(["--config", "tiny", "--batch", "2", "--seq", "16",
                          "--steps", "2", "--device", "cpu", "--kernels", "pallas"])
        out = capsys.readouterr().out
        final = json.loads(out.split("final:", 1)[1])
        assert final["kernels"] == "cuda" and len(final["losses"]) == 2

    def test_jax_only_flags_raise(self, capsys):
        # every flag of the JAX trainer is ported: the mesh's axes, pp and
        # --ring-attention among them (tests/test_torch_fsdp.py,
        # tests/test_torch_tp.py, tests/test_torch_ep.py,
        # tests/test_torch_pp.py, tests/test_torch_ring.py). Ring attention
        # is inert on one device; pp=2 needs a gang of two
        assert train_llama.NOT_PORTED_FLAGS == ()
        train_llama.main(["--device", "cpu", "--steps", "1", "--batch", "2", "--seq", "16",
                          "--ring-attention"])
        assert '"losses"' in capsys.readouterr().out
        with pytest.raises(ValueError, match="1 devices not divisible"):
            train_llama.main(["--device", "cpu", "--mesh=pp=2"])
        # the remat policies run (tests/test_torch_remat.py)
        assert "--remat-policy" not in train_llama.NOT_PORTED_FLAGS
        for policy in ("full", "dots", "dots_attn", "auto"):
            train_llama.main(["--device", "cpu", "--steps", "1", "--batch", "2", "--seq", "16",
                              f"--remat-policy={policy}"])
        assert capsys.readouterr().out.count("final:") == 4
        with pytest.raises(ValueError, match="give --mesh"):
            train_llama.main(["--device", "cpu", "--grad-bucket-mb=4"])
        with pytest.raises(SystemExit):
            train_llama.main(["--device", "cpu", "--no-such-flag"])
        # int8 is ported (its flags: tests/test_torch_quant.py)
        assert not {"--int8", "--int8-scope"} & set(train_llama.NOT_PORTED_FLAGS)

    def test_unported_model_options_raise(self):
        # ring attention, which raised before it was ported, is a config:
        # without sp it changes nothing (tests/test_torch_ring.py runs it)
        ring = llama.llama_tiny(use_ring_attention=True)
        params = llama.init_params(ring, torch.Generator().manual_seed(0))
        batch = {"tokens": torch.arange(9)[None] % 512}
        assert torch.equal(llama.loss_fn(params, batch, ring),
                           llama.loss_fn(params, batch, llama.llama_tiny()))
        # the remat policies, which raised before they were ported, run
        for policy in ("full", "dots", "dots_attn"):
            cfg = llama.llama_tiny(remat=True, remat_policy=policy)
            params = llama.init_params(cfg, torch.Generator().manual_seed(0))
            llama.loss_fn(params, {"tokens": torch.zeros((1, 9), dtype=torch.int64)},
                          cfg).backward()
        with pytest.raises(ValueError, match="remat_policy"):
            llama.llama_tiny(remat_policy="selective")
        # int8 matmuls, which raised before int8 was ported, are a config
        assert llama.llama_tiny(int8_matmuls=True, int8_scope="ffn").int8_matmuls
        with pytest.raises(ValueError):
            llama.llama_tiny(kernels="interpret")
        # the MoE presets, which raised before the MoE family was ported, run
        assert llama.get_config("mixtral_8x7b").n_experts == 8
        train_llama.main(["--config", "moe_tiny", "--batch", "2", "--seq", "16",
                          "--steps", "1", "--device", "cpu"])

    def test_chip_smoke_fails_without_the_card_or_the_repo(self, tmp_path):
        runs = [(REPO, REPO / "chip_smoke.py")]
        lone = tmp_path / "chip_smoke.py"
        shutil.copy(REPO / "chip_smoke.py", lone)
        runs.append((tmp_path, lone))
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        for cwd, script in runs:
            proc = subprocess.run(
                [sys.executable, str(script)], cwd=cwd, env=env,
                capture_output=True, text=True, timeout=120,
            )
            assert proc.returncode != 0
            assert '"ok": true' not in proc.stdout


def test_chip_smoke_specs_phase(monkeypatch, capsys):
    """The specs phase's checks, rehearsed with the card's answers faked:
    an H100 whose total_memory is the table's passes, another card or
    another size fails the run."""
    import importlib.util
    import types

    spec = importlib.util.spec_from_file_location("chip_smoke_specs", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    total = 85_017_493_504
    for name, memory, ok in (("NVIDIA H100 80GB HBM3", total, True),
                             ("NVIDIA A100-SXM4-80GB", total, False),
                             ("NVIDIA H100 80GB HBM3", total - 1, False)):
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0, n=name: n)
        monkeypatch.setattr(torch.cuda, "get_device_properties",
                            lambda i=0, m=memory: types.SimpleNamespace(total_memory=m))
        if ok:
            smoke.phase_specs("NVIDIA H100 80GB HBM3, 700.00 W")
        else:
            with pytest.raises(SystemExit):
                smoke.phase_specs("card")
        line = json.loads(capsys.readouterr().out.splitlines()[0])
        assert (line["phase"], line["hbm_bytes_per_gpu"], line["total_memory"]) \
            == ("specs", total, memory)
        assert line["accelerator_type"] == "h100-1" and line["devices"] == {"nvidia.com/gpu": 1}


def test_chip_smoke_local_phase(monkeypatch, capsys, tmp_path):
    """The local phase and gang A's launch through the port's control
    daemon (``/v1/submit`` of ``dist.spmd``, ``/v1/wait``), rehearsed on the
    CPU with one card faked: a tiny trainer submitted as the component's
    arguments ends SUCCEEDED with its replica given card "0" and a first
    step line seen, the wait returning on the reconciler's terminal event
    with the daemon's ``tpx_step_seconds`` equal to the job's textfile;
    the phase line counts the card, and the dryrun asking one card more is
    refused; a count that differs from torch's fails."""
    import importlib.util

    from torchx_tpu_torch.runner.api import Runner
    from torchx_tpu_torch.schedulers import local_scheduler

    spec = importlib.util.spec_from_file_location("chip_smoke_local", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    monkeypatch.setattr(local_scheduler, "_registry_path", lambda: str(tmp_path / "registry"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    monkeypatch.delenv("TPX_NO_LINT", raising=False)  # the launch sets it for its daemon
    trainer = ["--device", "cpu", "--config", "tiny", "--steps", "2", "--batch", "2",
               "--seq", "16"]
    dryrun = Runner.dryrun

    def one_worker(self, app, *a, **kw):  # noqa: ANN001, ANN202
        args = app.roles[0].args  # the faked card is no count for spmd_main here
        if "--nproc-per-node" not in args:
            args[args.index("-m", 2):args.index("-m", 2)] = ["--nproc-per-node", "1"]
        return dryrun(self, app, *a, **kw)

    monkeypatch.setattr(Runner, "dryrun", one_worker)
    monkeypatch.setattr(smoke, "gang_a_args", lambda: trainer)
    final, record = smoke._daemon_spmd(1, str(tmp_path), "gang", timeout_s=120)
    assert final["final_step"] == 2 and final["world"] == 1
    assert (record["state"], record["gpu"], record["cuda_visible_devices"]) == \
        ("SUCCEEDED", "h100-1", "0")
    assert record["component"] == "dist.spmd"
    assert record["app_handle"] == f"local://chip_smoke/{record['app_id']}"
    assert 0 < record["submit_to_first_step_s"] <= record["submit_to_succeeded_s"]
    assert record["launch_breakdown_s"]["first_step"] > 0
    marks = record["launch_marks_s"]  # the job ran under the runner's trace
    assert list(marks) == ["spmd_main_start", "bootstrap_start", "group_up", "target_exec",
                           "train_start", "first_step"]
    assert 0 < marks["spmd_main_start"] < marks["bootstrap_start"] <= marks["group_up"] \
        <= marks["target_exec"] < marks["train_start"] < marks["first_step"] \
        < record["submit_to_succeeded_s"]
    assert (tmp_path / "registry").read_text().strip() == ""  # deleted after reading
    # the runner's own trace went under the run's root, not the session's
    assert list((tmp_path / "obs").glob("*/trace.jsonl"))
    daemon = record["daemon"]
    assert record["route"] == "control daemon"
    assert daemon["status_state"] == daemon["runner_status_state"] == "SUCCEEDED"
    assert daemon["terminal_event"]["state"] == "SUCCEEDED"
    assert 0 <= daemon["exit_to_wait_s"] < 5 and 0 < daemon["start_s"]
    assert daemon["submit_round_trip_s"] >= daemon["submit_handler_s"] > 0
    assert daemon["telemetry"]["steps_counted"] == 2
    assert all(v["equal"] for k, v in daemon["telemetry"].items()
               if k.startswith("tpx_step_seconds"))
    capsys.readouterr()
    smoke.phase_local({"launcher": record}, "NVIDIA H100 80GB HBM3, 700.00 W")
    line = json.loads(capsys.readouterr().out.splitlines()[0])
    assert (line["phase"], line["local_gpu_count"], line["device_count"]) == ("local", 1, 1)
    assert line["over_subscribed"] == "h100-2"
    assert "need 2 cards, and this host has 1" in line["over_subscription_refused"]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(SystemExit):
        smoke.phase_local({"launcher": record}, "card")


def test_chip_smoke_remote_phase(monkeypatch, capsys):
    """The remote phase rehearsed on the CPU with one card faked (the
    launcher's ``CUDA_VISIBLE_DEVICES`` names its UUID, torch reports it):
    gang A's app dryrun through the five remote backends in a subprocess
    that loads no torch, each asking for one host of one H100, docker
    naming that card; a count that differs from the request's fails."""
    import importlib.util
    import types

    spec = importlib.util.spec_from_file_location("chip_smoke_remote", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    uuid = "5f1a7c3e-0b2d-4e6f-8a9b-0c1d2e3f4a5b"
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", f"GPU-{uuid}")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i=0: types.SimpleNamespace(uuid=uuid))
    res = smoke.phase_remote("NVIDIA H100 80GB HBM3, 700.00 W")
    line = json.loads(capsys.readouterr().out.splitlines()[0])
    assert line == json.loads(json.dumps(res))
    assert (line["phase"], line["accelerator_type"], line["hosts"], line["gpus_per_host"]) \
        == ("remote", "h100-1", 1, 1)
    assert line["loaded"] == [] and set(line["stub_calls"]) <= {"slurm"}
    b = line["backends"]
    assert b["local_docker"]["device_ids"] == [[f"GPU-{uuid}"]]
    assert line["docker_ids_are_torch_uuids"] is True
    assert (b["gke"]["cards_per_host"], b["gcp_batch"]["cards_per_host"]) == (1, 1)
    assert (b["slurm"]["cards_per_host"], b["vertex"]["cards_per_host"]) == ([1], [1])
    assert (b["vertex"]["machine"], b["gcp_batch"]["machine"]) == (["a3-highgpu-1g"],
                                                                  "a3-highgpu-1g")
    assert b["slurm"]["identity_equals_role_replica_env"] == [True]
    assert all(not v["tpu_names"] for v in b.values())
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(SystemExit):
        smoke.phase_remote("card")


def test_chip_smoke_pool_phase_refuses_a_cpu_replica(monkeypatch, capsys, tmp_path):
    """The pool phase's launch rehearsed on the CPU with one card faked: a
    ``ServePool`` submits the replica through ``Runner`` and the local
    scheduler on ``h100-1``; a replica that serves on the CPU (a tiny one
    told ``--device cpu``) fails the phase, and no process of it is left."""
    import importlib.util
    import socket

    from torchx_tpu_torch.components import serve
    from torchx_tpu_torch.schedulers import local_scheduler

    spec = importlib.util.spec_from_file_location("chip_smoke_pool", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    monkeypatch.setattr(local_scheduler, "_registry_path", lambda: str(tmp_path / "registry"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda *a: (1 << 30, 80 << 30))
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    monkeypatch.setenv("TPX_OBS_DIR", str(tmp_path / "obs"))
    monkeypatch.setattr(smoke, "free_card", lambda: None)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    monkeypatch.setattr(smoke, "_free_port", lambda: port)
    real = serve.generate_server

    def tiny_on_the_cpu(config, **kw):  # noqa: ANN001, ANN202
        app = real("tiny", **{**kw, "max_batch": 4})
        assert kw["gpu"] == "h100-1" and app.roles[0].resource.gpu is not None
        app.roles[0].args += ["--device", "cpu"]
        return app

    monkeypatch.setattr(serve, "generate_server", tiny_on_the_cpu)
    with pytest.raises(SystemExit):
        smoke.phase_pool({"resend": []}, "card")
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert line == {"phase": "pool", "ok": False, "error": "the replica serves on cpu"}
    left = []
    for entry in os.listdir("/proc"):
        try:
            with open(f"/proc/{entry}/cmdline", "rb") as f:
                argv = f.read().split(b"\0")
        except OSError:
            continue
        if b"torchx_tpu_torch.apps.generate_server" in argv and str(port).encode() in argv:
            left.append(entry)
    assert left == []
