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


def test_serving_modules_are_present():
    sources = {p.relative_to(PKG).as_posix() for p in _sources() if PKG in p.parents}
    assert set(SERVING_MODULES) <= sources


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

    def test_main_on_cpu(self, capsys):
        train_llama.main(["--config", "tiny", "--batch", "2", "--seq", "16",
                          "--steps", "2", "--device", "cpu", "--kernels", "pallas"])
        out = capsys.readouterr().out
        final = json.loads(out.split("final:", 1)[1])
        assert final["kernels"] == "cuda" and len(final["losses"]) == 2

    def test_jax_only_flags_raise(self):
        for flag in ("--mesh=fsdp=-1", "--int8", "--ckpt-dir"):
            with pytest.raises(NotImplementedError, match="not ported yet"):
                train_llama.main(["--device", "cpu", flag])
        with pytest.raises(SystemExit):
            train_llama.main(["--device", "cpu", "--no-such-flag"])

    def test_unported_model_options_raise(self):
        for kw in ({"int8_matmuls": True}, {"use_ring_attention": True},
                   {"remat_policy": "dots"}):
            with pytest.raises(NotImplementedError, match="not ported yet"):
                llama.llama_tiny(**kw)
        with pytest.raises(ValueError):
            llama.llama_tiny(kernels="interpret")
        with pytest.raises(NotImplementedError, match="MoE"):
            train_llama.main(["--config", "mixtral_8x7b", "--device", "cpu"])

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
