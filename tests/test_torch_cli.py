"""The port's command line (``tpx-torch``, ``torchx_tpu_torch.cli``) held to
the JAX CLI's own cases: every case of ``tests/test_cli.py`` and of
``tests/test_fastpath.py::TestLazyCli``, each run against the copy. Cases
changed with the port: the local scheduler's run options name
``gpu_simulate`` where the JAX ones name ``tpu_simulate``, and "``tpx
list`` never imports jax" becomes "``tpx-torch list`` imports neither
torch nor jax nor ``torchx_tpu``". Added: every command of the JAX table
whose layer is not ported yet exits 1 naming its ROADMAP item; the
runner's lint gate ends a command with one error line naming its item; a
set ``$TPX_CONTROL_ADDR`` sends ``run``, ``status``, ``list``, ``log`` and
``cancel`` through the control daemon; and parity with the JAX CLI on the same inputs
(``TestJaxParity``: the command table, and ``profile``'s text, ``--json``
and ``--diff`` views of the same journals, exact).

The port's lint gate raises until the analyzer is ported, so an autouse
fixture sets ``TPX_NO_LINT=1`` (the gate's own case unsets it); every case
keeps the local scheduler's registry under ``tmp_path`` and sees a
card-less host."""

import io
import json
import os
import subprocess
import sys
from contextlib import nullcontext, redirect_stderr, redirect_stdout
from unittest import mock

import pytest

from torchx_tpu_torch import settings
from torchx_tpu_torch.cli.main import BUILTIN_CMDS, create_parser, get_sub_cmds, main
from torchx_tpu_torch.schedulers import local_scheduler as lsched
from torch_threads import xdist_torch_threads  # noqa: F401

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _no_lint_own_registry(tmp_path, monkeypatch):
    """The lint gate is bypassed (it raises until ROADMAP queue 1 item 2.8),
    the local scheduler's registry lives in ``tmp_path``, no control daemon
    is named, and the host has no card."""
    monkeypatch.setenv(settings.ENV_TPX_NO_LINT, "1")
    monkeypatch.delenv(settings.ENV_TPX_CONTROL_ADDR, raising=False)
    monkeypatch.setattr(lsched, "_registry_path", lambda: str(tmp_path / "registry"))
    monkeypatch.delenv(settings.ENV_CUDA_VISIBLE_DEVICES, raising=False)
    monkeypatch.setattr(lsched, "driver_gpu_count", lambda: 0)


def run_cli(argv, stdin_text=None, cli_main=main):
    """-> (exit_code, stdout, stderr)"""
    out, err = io.StringIO(), io.StringIO()
    code = 0
    stdin_patch = (
        mock.patch.object(sys, "stdin", io.StringIO(stdin_text))
        if stdin_text is not None
        else nullcontext()
    )
    try:
        with redirect_stdout(out), redirect_stderr(err), stdin_patch:
            cli_main(argv)
    except SystemExit as e:
        code = e.code if isinstance(e.code, int) else 1
    return code, out.getvalue(), err.getvalue()


# =========================================================================
# tests/test_cli.py
# =========================================================================


class TestParser:
    def test_all_subcommands_registered(self):
        cmds = get_sub_cmds()
        for expected in (
            "run",
            "status",
            "describe",
            "list",
            "log",
            "cancel",
            "delete",
            "runopts",
            "builtins",
            "configure",
            "tracker",
            "top",
        ):
            assert expected in cmds, expected

    def test_no_subcommand_prints_help(self):
        code, out, err = run_cli([])
        assert code == 1

    def test_version(self):
        with pytest.raises(SystemExit) as e:
            create_parser().parse_args(["--version"])
        assert e.value.code == 0


class TestCmdRun:
    def test_dryrun_echo(self):
        code, out, _ = run_cli(
            ["run", "-s", "local", "--dryrun", "utils.echo", "--msg", "cli-test"]
        )
        assert code == 0
        assert "=== APPLICATION ===" in out
        assert "cli-test" in out

    def test_unknown_component(self):
        code, _, err = run_cli(["run", "-s", "local", "no.such.component"])
        assert code == 1
        assert "not found" in err

    def test_component_value_error_clean(self):
        code, _, err = run_cli(
            ["run", "-s", "local", "--dryrun", "dist.spmd", "-j", "zzz", "-m", "x"]
        )
        assert code == 1
        assert "error:" in err and "Traceback" not in err

    def test_unknown_scheduler(self):
        code, _, err = run_cli(["run", "-s", "marscluster", "utils.echo"])
        assert code == 1

    def test_stdin_dryrun(self):
        spec = json.dumps(
            {
                "name": "j",
                "roles": [
                    {"name": "r", "entrypoint": "echo", "args": ["hi"], "image": ""}
                ],
            }
        )
        code, out, _ = run_cli(
            ["run", "-s", "local", "--dryrun", "--stdin"], stdin_text=spec
        )
        assert code == 0 and '"hi"' in out

    def test_stdin_rejects_component_args(self):
        code, _, err = run_cli(
            ["run", "-s", "local", "--stdin", "utils.echo"], stdin_text="{}"
        )
        assert code == 1 and "--stdin" in err

    def test_stdin_invalid_json(self):
        code, _, err = run_cli(
            ["run", "-s", "local", "--stdin"], stdin_text="not json"
        )
        assert code == 1 and "invalid job spec" in err

    def test_run_and_status_roundtrip(self, tmp_path):
        code, out, _ = run_cli(
            [
                "run",
                "-s",
                "local",
                "-cfg",
                f"log_dir={tmp_path}",
                "utils.echo",
                "--msg",
                "roundtrip",
            ]
        )
        assert code == 0
        assert "SUCCEEDED" in out
        handle = next(ln for ln in out.splitlines() if ln.startswith("local://"))
        # cross-process state: a fresh runner (≈ another terminal) reads the
        # app's on-disk state file and reports the terminal status
        code2, out2, _ = run_cli(["status", handle])
        assert code2 == 0 and "SUCCEEDED" in out2


class TestCmdLogAndCopy:
    def test_runner_log_lines_roundtrip(self, tmp_path):
        # CmdLog's backing API (its thread fan-out needs a shared live
        # scheduler instance, so the CLI wrapper is covered by the
        # malformed-identifier case below + the runner path here)
        from torchx_tpu_torch.runner.api import get_runner

        with get_runner("log-test") as runner:
            handle = runner.run_component(
                "utils.echo",
                ["--msg", "log-line"],
                "local",
                {"log_dir": str(tmp_path)},
            )
            runner.wait(handle, wait_interval=0.1)
            lines = list(runner.log_lines(handle, "echo", 0))
            assert "log-line" in lines

    def test_copy_component_e2e(self, tmp_path):
        from torchx_tpu_torch.runner.api import get_runner

        src = tmp_path / "src.txt"
        src.write_text("payload")
        dst = tmp_path / "out" / "dst.txt"
        with get_runner("copy-test") as runner:
            handle = runner.run_component(
                "utils.copy",
                ["--src", str(src), "--dst", str(dst)],
                "local",
                {"log_dir": str(tmp_path / "logs")},
            )
            status = runner.wait(handle, wait_interval=0.1)
        assert status.state.name == "SUCCEEDED"
        assert dst.read_text() == "payload"

    def test_log_identifier_parse_error(self):
        code, _, err = run_cli(["log", "not-an-identifier"])
        assert code == 1 and "malformed" in err

    def test_log_bad_since_errors(self):
        code, _, err = run_cli(
            ["log", "--since", "yesterdayish", "local://s/app/role/0"]
        )
        assert code == 1 and "cannot parse time" in err


class TestCmdBuiltinsRunopts:
    def test_builtins_lists_components(self):
        code, out, _ = run_cli(["builtins"])
        assert code == 0
        assert "dist.spmd" in out and "utils.echo" in out

    def test_builtins_print_source(self):
        code, out, _ = run_cli(["builtins", "--print", "utils.echo"])
        assert code == 0
        assert "def echo(" in out

    def test_runopts_single(self):
        code, out, _ = run_cli(["runopts", "local"])
        assert code == 0
        assert "log_dir" in out and "gpu_simulate" in out

    def test_status_missing_app(self):
        code, _, err = run_cli(["status", "local://x/nope"])
        assert code == 1 and "not found" in err


class TestCmdConfigure:
    def test_writes_config(self, tmp_path, monkeypatch):
        monkeypatch.chdir(tmp_path)
        code, out, _ = run_cli(["configure", "-s", "local"])
        assert code == 0
        text = (tmp_path / ".tpxconfig").read_text()
        assert "[local]" in text and "log_dir" in text


class TestCmdResize:
    """Satellite coverage for `tpx-torch resize`: dispatch + clean error path."""

    def _patched_runner(self, monkeypatch, resize_fn):
        from contextlib import contextmanager

        class FakeRunner:
            def resize(self, handle, role, n):
                resize_fn(handle, role, n)

        @contextmanager
        def fake_get_runner(*a, **kw):
            yield FakeRunner()

        monkeypatch.setattr(
            "torchx_tpu_torch.cli.cmd_simple.get_runner", fake_get_runner
        )

    def test_dispatch_and_output(self, monkeypatch):
        seen = []
        self._patched_runner(
            monkeypatch, lambda h, r, n: seen.append((h, r, n))
        )
        code, out, _ = run_cli(["resize", "local://s/app_1", "server", "3"])
        assert code == 0
        assert seen == [("local://s/app_1", "server", 3)]
        assert "resized local://s/app_1/server to 3" in out

    def test_terminal_app_errors_cleanly(self, monkeypatch):
        def boom(h, r, n):
            raise ValueError(f"cannot resize terminal app {h}")

        self._patched_runner(monkeypatch, boom)
        code, _, err = run_cli(["resize", "local://s/app_1", "server", "2"])
        assert code == 1
        assert "terminal" in err and "Traceback" not in err

    def test_backend_without_resize_errors_cleanly(self, monkeypatch):
        def unsupported(h, r, n):
            raise NotImplementedError("stub does not support resizing")

        self._patched_runner(monkeypatch, unsupported)
        code, _, err = run_cli(["resize", "stub://s/app_1", "server", "2"])
        assert code == 1 and "resizing" in err

    def test_non_integer_replicas_rejected(self):
        code, _, err = run_cli(["resize", "local://s/app_1", "server", "lots"])
        assert code == 2  # argparse usage error


# =========================================================================
# tests/test_fastpath.py::TestLazyCli
# =========================================================================


def _probe_cli(argv: list[str], forbidden: list[str], env: dict = None) -> None:
    """Run ``main(argv)`` in a fresh interpreter (the repo on
    ``PYTHONPATH``) and assert none of the ``forbidden`` modules were
    imported (the lazy-dispatch contract)."""
    code = f"""
import json, sys
from torchx_tpu_torch.cli.main import main
try:
    main({argv!r})
except SystemExit:
    pass
print(json.dumps([m for m in {forbidden!r} if m in sys.modules]))
"""
    proc = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True,
        text=True,
        timeout=120,
        cwd=REPO_ROOT,
        env={**os.environ, "PYTHONPATH": REPO_ROOT, **(env or {})},
    )
    assert proc.returncode == 0, proc.stderr
    leaked = json.loads(proc.stdout.strip().splitlines()[-1])
    assert leaked == [], f"lazily-dispatched CLI imported {leaked}"


class TestLazyCli:
    HEAVY = [
        "torch",
        "jax",
        "numpy",
        "torchx_tpu",
        "torchx_tpu_torch.cli.cmd_run",
        "torchx_tpu_torch.cli.cmd_unported",
        "torchx_tpu_torch.examples.train_llama",
        "torchx_tpu_torch.parallel.aot_fit",
    ]

    def test_help_imports_no_subcommand_modules(self):
        _probe_cli(["--help"], self.HEAVY)

    def test_list_never_imports_jax(self, tmp_path):
        """``tpx-torch list`` imports neither torch nor jax nor the JAX
        package (nor the run path)."""
        _probe_cli(["list", "-s", "local"],
                   ["torch", "jax", "torchx_tpu", "torchx_tpu_torch.cli.cmd_run"],
                   env={"HOME": str(tmp_path)})

    def test_peek_cmd(self):
        from torchx_tpu_torch.cli.main import _peek_cmd

        assert _peek_cmd(["status", "x"]) == "status"
        assert _peek_cmd(["--log_level", "DEBUG", "list"]) == "list"
        assert _peek_cmd(["--log-level", "DEBUG", "list"]) == "list"
        assert _peek_cmd(["--log_level=DEBUG", "list"]) == "list"
        assert _peek_cmd(["--version"]) is None
        assert _peek_cmd([]) is None

    def test_create_parser_only_registers_one(self):
        parser = create_parser(only="status")
        args = parser.parse_args(["status", "local://s/app"])
        assert hasattr(args, "func")
        with pytest.raises(SystemExit):
            parser.parse_args(["list", "-s", "local"])

    def test_unknown_command_is_an_error(self):
        with pytest.raises(SystemExit) as e:
            main(["definitely-not-a-command"])
        assert e.value.code not in (0, None)


# =========================================================================
# the seams: each names the ROADMAP item that lifts it
# =========================================================================

#: command -> the ROADMAP queue 1 item(s) its message names
UNPORTED = {
    "lint": ("2.8",), "explain": ("2.8",), "tune": ("2.8",), "sim": ("2.8",),
    "selfcheck": ("2.8",), "cell": ("2.8",), "top": ("2.7", "2.8"),
}


class TestSeams:
    @pytest.mark.parametrize("name", sorted(UNPORTED))
    def test_unported_command_exits_naming_its_item(self, name):
        for argv in ([name], [name, "--help"], [name, "--once", "x", "-s", "local"]):
            code, out, err = run_cli(argv)
            assert code == 1, (argv, out, err)
            assert f"tpx-torch {name}" in err and "Traceback" not in err
            for item in UNPORTED[name]:
                assert f"item{'s' if len(UNPORTED[name]) > 1 else ''} " in err
                assert item in err

    def test_every_jax_command_is_in_the_table_in_order(self):
        from torchx_tpu.cli.main import BUILTIN_CMDS as JAX_CMDS

        assert list(BUILTIN_CMDS) == list(JAX_CMDS)
        stand_ins = {n for n, (mod, _) in BUILTIN_CMDS.items() if mod.endswith("cmd_unported")}
        assert stand_ins == set(UNPORTED)

    def test_lint_gate_is_one_error_line(self, monkeypatch):
        monkeypatch.delenv(settings.ENV_TPX_NO_LINT)
        for argv in (["run", "-s", "local", "--dryrun", "utils.echo", "--msg", "x"],
                     ["supervise", "-s", "local", "utils.echo", "--msg", "x"]):
            code, out, err = run_cli(argv)
            assert code == 1
            assert err.startswith("error: ") and "2.8" in err and "Traceback" not in err
            assert len(err.strip().splitlines()) == 1
        code, out, _ = run_cli(["run", "-s", "local", "--dryrun", "--no-lint",
                                "utils.echo", "--msg", "x"])
        assert code == 0 and "=== APPLICATION ===" in out

    def test_a_control_daemon_address_reaches_the_daemon(self, monkeypatch, tmp_path):
        """With ``$TPX_CONTROL_ADDR`` set, ``run``, ``status``, ``list``,
        ``log`` and ``cancel`` go through the control daemon (its journal
        and its log stream), as the JAX commands do; an address with no
        token is one ``control:`` error line."""
        from torchx_tpu_torch.control.daemon import ControlDaemon
        from torchx_tpu_torch.runner.api import get_runner

        monkeypatch.setenv("TPX_WATCH_INTERVAL", "0.05")
        monkeypatch.setenv(settings.ENV_TPX_CONTROL_DIR, str(tmp_path / "ctl"))
        d = ControlDaemon(runner=get_runner("cli-proxy"), state_dir=str(tmp_path / "ctl")).start()
        try:
            monkeypatch.setenv(settings.ENV_TPX_CONTROL_ADDR, d.addr)
            code, out, err = run_cli(["run", "-s", "local", "-cfg", f"log_dir={tmp_path / 'l'}",
                                      "utils.echo", "--msg", "proxied"])
            assert code == 0, err
            handle = out.splitlines()[0]
            assert handle.startswith("local://") and f"{handle}: SUCCEEDED" in out
            app_id = handle.rsplit("/", 1)[1]
            assert d.store.latest("local", app_id) is not None
            code, out, _ = run_cli(["status", handle])
            assert code == 0 and out.startswith(f"{handle}: SUCCEEDED")
            code, out, _ = run_cli(["list"])
            assert code == 0 and f"local\t{app_id}\t" in out
            code, out, _ = run_cli(["log", f"{handle}/echo/0"])
            assert code == 0 and "echo/0 proxied" in out
            code, out, _ = run_cli(["cancel", handle])
            assert code == 0 and out.strip() == f"cancelled {handle}"
            monkeypatch.setenv(settings.ENV_TPX_CONTROL_ADDR, "http://127.0.0.1:1")
            code, _, err = run_cli(["list"])
            assert code == 1 and err.startswith("control: ") and "Traceback" not in err
        finally:
            d.close()
            d.runner.close()

    def test_no_lint_through_a_daemon_names_the_daemons_setting(self, monkeypatch,
                                                                 tmp_path):
        """The daemon lints its submits in its own environment: a proxied
        ``run --no-lint`` that the daemon's lint gate refuses says where the
        setting belongs, and a daemon with ``TPX_NO_LINT=1`` takes it."""
        from torchx_tpu_torch.control.daemon import ControlDaemon
        from torchx_tpu_torch.runner.api import get_runner

        monkeypatch.setenv("TPX_WATCH_INTERVAL", "0.05")
        monkeypatch.setenv(settings.ENV_TPX_CONTROL_DIR, str(tmp_path / "ctl"))
        d = ControlDaemon(runner=get_runner("cli-nolint"), state_dir=str(tmp_path / "ctl")).start()
        try:
            monkeypatch.setenv(settings.ENV_TPX_CONTROL_ADDR, d.addr)
            argv = ["run", "--no-lint", "-s", "local", "-cfg", f"log_dir={tmp_path / 'l'}",
                    "utils.echo", "--msg", "x"]
            monkeypatch.delenv(settings.ENV_TPX_NO_LINT)
            code, out, err = run_cli(argv)
            lines = err.strip().splitlines()
            assert code == 1 and not out and "Traceback" not in err
            assert "2.8" in lines[0] and "TPX_NO_LINT=1" in lines[-1]
            monkeypatch.setenv(settings.ENV_TPX_NO_LINT, "1")
            code, out, err = run_cli(argv)
            assert code == 0 and "SUCCEEDED" in out, err
        finally:
            d.close()
            d.runner.close()

    def test_supervise_runs_to_success_on_the_local_scheduler(self, tmp_path):
        code, out, err = run_cli([
            "supervise", "--no-lint", "-s", "local", "-cfg", f"log_dir={tmp_path}",
            "--poll-interval", "0.05", "--session", "cli-sup", "utils.echo",
            "--msg", "supervised"])
        assert code == 0, err
        assert "session: cli-sup" in out and "attempt 1: local://" in out
        assert "SUCCEEDED" in out


# =========================================================================
# parity with the JAX CLI on the same inputs (exact)
# =========================================================================


class TestJaxParity:
    def test_profile_views_equal_the_jax_commands(self, tmp_path):
        """``profile`` (text and ``--json``) and ``profile --diff`` of two
        journals the port's step profiler wrote print what the JAX
        command prints."""
        import numpy as np

        from torchx_tpu.cli.main import main as jax_main
        from torchx_tpu.obs import profile as jprofile
        from torchx_tpu_torch.obs import profile as tprofile

        model = dict(flops_per_token=6.0e9, tokens_per_step=8192, peak_flops=989e12,
                     param_count=1_000_000_000, generation="NVIDIA H100 80GB HBM3")
        paths = []
        for seed in (1, 2):
            path = str(tmp_path / f"run{seed}.jsonl")
            prof = tprofile.StepProfiler(tprofile.AttributionModel(**model), path=path,
                                         clock=lambda: 2.0)
            rng = np.random.default_rng(seed)
            for step in range(1, 5):
                m = {"data_wait": float(rng.uniform(0, 0.05)),
                     "forward_backward": float(rng.uniform(0.1, 0.5)),
                     "host": float(rng.uniform(0, 0.01))}
                prof.record_step(step, wall_s=sum(m.values()), measured=m)
            prof.close(calibrate=False)
            paths.append(path)
        for argv in (["profile", paths[0]], ["profile", paths[0], "--json"],
                     ["profile", "--diff", *paths], ["profile", "--diff", *paths, "--json"]):
            mine = run_cli(argv)
            theirs = run_cli(argv, cli_main=jax_main)
            assert mine == theirs, argv
            assert mine[0] == 0 and mine[1]
        a, b = (tprofile.summarize(tprofile.load_profile(p)) for p in paths)
        assert tprofile.render_diff(tprofile.diff_summaries(a, b)) == \
            jprofile.render_diff(jprofile.diff_summaries(a, b))
