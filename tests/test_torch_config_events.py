"""The port's ``.tpxconfig`` layering and telemetry events
(``torchx_tpu_torch.runner.config``, ``torchx_tpu_torch.runner.events``)
held to every case of ``tests/test_config_events.py``, run against the
copy (reference analogs: torchx/runner/test/config_test.py,
runner/test/events/); and parity with the JAX modules on the same inputs
(``TestJaxParity``: every ``.tpxconfig`` reader on one set of files, the
skeleton a ``dump`` writes, ``TpxEvent`` records and ``log_event``'s
output)."""

import io
import json

from torchx_tpu_torch.runner import config as tpx_config
from torchx_tpu_torch.runner.events import log_event
from torchx_tpu_torch.runner.events.api import TpxEvent
from torchx_tpu_torch.specs.api import runopts
from torch_threads import xdist_torch_threads  # noqa: F401


def write_cfg(path, text):
    path.write_text(text)


class TestConfig:
    def test_apply_fills_missing_only(self, tmp_path):
        write_cfg(
            tmp_path / ".tpxconfig",
            "[local]\nlog_dir = /cfg/logs\nprepend_cwd = true\n",
        )
        cfg = {"log_dir": "/cli/logs"}
        tpx_config.apply("local", cfg, dirs=[str(tmp_path)])
        assert cfg["log_dir"] == "/cli/logs"  # CLI wins
        assert cfg["prepend_cwd"] == "true"  # filled from file

    def test_precedence_between_dirs(self, tmp_path):
        low = tmp_path / "low"
        high = tmp_path / "high"
        low.mkdir()
        high.mkdir()
        write_cfg(low / ".tpxconfig", "[local]\nlog_dir = /low\n")
        write_cfg(high / ".tpxconfig", "[local]\nlog_dir = /high\n")
        cfg = {}
        tpx_config.apply("local", cfg, dirs=[str(low), str(high)])
        assert cfg["log_dir"] == "/high"

    def test_none_sentinel(self, tmp_path):
        write_cfg(tmp_path / ".tpxconfig", "[local]\nlog_dir = None\n")
        cfg = {}
        tpx_config.apply("local", cfg, dirs=[str(tmp_path)])
        assert cfg["log_dir"] is None

    def test_component_sections(self, tmp_path):
        write_cfg(
            tmp_path / ".tpxconfig",
            "[component:dist.spmd]\nj = 2x4\n[component:utils.echo]\nmsg = hi\n",
        )
        sections = tpx_config.load_sections("component", dirs=[str(tmp_path)])
        assert sections == {"dist.spmd": {"j": "2x4"}, "utils.echo": {"msg": "hi"}}

    def test_cli_section(self, tmp_path):
        write_cfg(tmp_path / ".tpxconfig", "[cli:run]\ncomponent = dist.spmd\n")
        assert (
            tpx_config.get_config("cli", "run", "component", dirs=[str(tmp_path)])
            == "dist.spmd"
        )

    def test_tracker_sections(self, tmp_path):
        write_cfg(
            tmp_path / ".tpxconfig",
            "[tracker:fsspec]\nconfig = /tmp/experiments\n[tracker:custom:mod]\n",
        )
        trackers = tpx_config.load_tracker_sections(dirs=[str(tmp_path)])
        assert trackers["fsspec"] == "/tmp/experiments"
        assert trackers["custom:mod"] is None

    def test_dump_roundtrip(self, tmp_path):
        opts = runopts()
        opts.add("log_dir", type_=str, help="h", default="/d")
        opts.add("project", type_=str, help="h", required=True)
        buf = io.StringIO()
        tpx_config.dump(buf, {"local": opts})
        text = buf.getvalue()
        assert "[local]" in text
        assert "project =" in text
        assert "#log_dir = /d" in text

    def test_malformed_file_skipped(self, tmp_path):
        write_cfg(tmp_path / ".tpxconfig", "not an ini [[[")
        cfg = {}
        tpx_config.apply("local", cfg, dirs=[str(tmp_path)])  # no raise
        assert cfg == {}


class TestEvents:
    def test_log_event_records_timing(self):
        with log_event("run", "local", session="s") as ev:
            pass
        assert ev._event.wall_time_usec is not None
        assert ev._event.api == "run"

    def test_log_event_captures_exception(self):
        try:
            with log_event("run", "local", session="s") as ev:
                raise RuntimeError("boom")
        except RuntimeError:
            pass
        assert ev._event.exception_type == "RuntimeError"
        assert "boom" in ev._event.raw_exception
        assert ev._event.exception_source_location is not None

    def test_event_serialization_roundtrip(self):
        ev = TpxEvent(session="s", scheduler="local", api="run", app_id="a1")
        restored = TpxEvent.deserialize(ev.serialize())
        assert restored == ev
        assert json.loads(ev.serialize())["app_id"] == "a1"


class TestConfigEnvPrecedence:
    def test_tpxconfig_env_wins_over_home_and_cwd(self, tmp_path, monkeypatch):
        """$TPXCONFIG > $HOME/.tpxconfig > ./.tpxconfig (reference
        precedence, runner/config.py docstring)."""
        from torchx_tpu_torch.runner import config as cfg_mod

        env_file = tmp_path / "env.tpxconfig"
        env_file.write_text("[local]\nlog_dir = /from-env\n")
        home = tmp_path / "home"
        home.mkdir()
        (home / ".tpxconfig").write_text("[local]\nlog_dir = /from-home\n")
        cwd = tmp_path / "cwd"
        cwd.mkdir()
        (cwd / ".tpxconfig").write_text("[local]\nlog_dir = /from-cwd\n")
        monkeypatch.setenv("TPXCONFIG", str(env_file))
        monkeypatch.setenv("HOME", str(home))
        monkeypatch.chdir(cwd)
        out: dict = {}
        cfg_mod.apply("local", out)
        assert out["log_dir"] == "/from-env"
        # without the env file, HOME wins over CWD
        monkeypatch.delenv("TPXCONFIG")
        out2: dict = {}
        cfg_mod.apply("local", out2)
        assert out2["log_dir"] == "/from-home"

    def test_explicit_cfg_beats_every_file(self, tmp_path, monkeypatch):
        from torchx_tpu_torch.runner import config as cfg_mod

        (tmp_path / ".tpxconfig").write_text("[local]\nlog_dir = /from-file\n")
        monkeypatch.chdir(tmp_path)
        out = {"log_dir": "/explicit"}
        cfg_mod.apply("local", out)
        assert out["log_dir"] == "/explicit"


# -- parity: the same inputs through the JAX package and the port -----------


PARITY_CFG = """[local]
log_dir = /cfg/logs
prepend_cwd = true
gpu_simulate = None

[component:dist.spmd]
j = 2x4
h = None

[tracker:fsspec]
config = /mnt/exp

[tracker:mlflow]

[tracker:myorg:prod]
config = uri=fake://x
"""


class TestJaxParity:
    @staticmethod
    def _read(config_mod, dirs):
        """Every reader of one set of files, on one package's module."""
        out = {}
        for name, cfg in (("empty", {}), ("cli", {"log_dir": "/cli", "prepend_cwd": None})):
            config_mod.apply("local", cfg, dirs=dirs)
            out[name] = cfg
        cfg = {"log_dir": "/cli"}
        config_mod.load("local", io.StringIO(PARITY_CFG), cfg)
        out["load"] = cfg
        out["get"] = [config_mod.get_config(p, n, k, dirs=dirs) for p, n, k in (
            ("component", "dist.spmd", "j"), ("component", "dist.spmd", "h"),
            ("component", "dist.spmd", "nope"), ("component", "utils.echo", "msg"))]
        out["sections"] = config_mod.load_sections("component", dirs=dirs)
        out["trackers"] = config_mod.load_tracker_sections(dirs=dirs)
        return out

    def test_tpxconfig_readers_equal_jax(self, tmp_path, monkeypatch):
        """One pair of ``.tpxconfig`` files (the later wins), and the same
        files found through ``$TPXCONFIG``, ``$HOME`` and the working
        directory: every reader gives what the JAX one gives."""
        from torchx_tpu.runner import config as jax_config

        low, high = tmp_path / "low", tmp_path / "high"
        for d in (low, high):
            d.mkdir()
        write_cfg(low / ".tpxconfig", PARITY_CFG)
        write_cfg(high / ".tpxconfig", "[local]\nlog_dir = /high\n\n[tracker:fsspec]\n"
                                       "config = /mnt/high\n")
        dirs = [str(low), str(high)]
        port = self._read(tpx_config, dirs)
        assert port == self._read(jax_config, dirs)
        assert port["trackers"] == {"fsspec": "/mnt/high", "mlflow": None,
                                    "myorg:prod": "uri=fake://x"}
        monkeypatch.setenv("TPXCONFIG", str(high / ".tpxconfig"))
        monkeypatch.setenv("HOME", str(low))
        monkeypatch.chdir(tmp_path)
        assert self._read(tpx_config, None) == self._read(jax_config, None)

    def test_tpxconfig_dump_equals_jax(self):
        """The skeleton ``.tpxconfig`` of the same options is the same text;
        of each local scheduler's own options, the same but for the two
        accelerator options that the port names for cards."""
        from torchx_tpu.runner import config as jax_config
        from torchx_tpu.runner import get_runner as jax_get_runner
        from torchx_tpu.specs.api import runopts as jax_runopts

        from torchx_tpu_torch.runner import get_runner

        texts = []
        for config_mod, opts in ((jax_config, jax_runopts()), (tpx_config, runopts())):
            opts.add("log_dir", str, "where logs go")
            opts.add("region", str, "the region", required=True)
            opts.add("retries", int, "how many", default=3)
            opts.add("dry", bool, "dry", default=False)
            for required_only in (False, True):
                f = io.StringIO()
                config_mod.dump(f, {"sched": opts}, required_only=required_only)
                texts.append(f.getvalue())
        assert texts[2:] == texts[:2]
        local = []
        for config_mod, make in ((jax_config, jax_get_runner), (tpx_config, get_runner)):
            with make() as runner:
                f = io.StringIO()
                config_mod.dump(f, {"local": runner.run_opts()["local"]})
                local.append(f.getvalue().splitlines())
        jlines, tlines = local
        renamed = {"#auto_set_tpu_chips = True": "#auto_set_cuda_visible_devices = True",
                   "#tpu_simulate = True": "#gpu_simulate = False"}
        assert tlines == [renamed.get(line, line) for line in jlines]

    def test_event_records_equal_jax(self):
        """The same ``TpxEvent`` serializes to the same JSON in both, and
        each package reads the other's."""
        from torchx_tpu.runner.events.api import TpxEvent as JaxEvent

        fields = dict(session="s", scheduler="local", api="run", app_id="a1",
                      app_image="img", app_metadata={"attempts": 2}, runcfg="k=v",
                      source="CLI", cpu_time_usec=5, wall_time_usec=7,
                      start_epoch_time_usec=11, raw_exception="tb", exception_type="E",
                      exception_source_location="f.py:1:g", trace_id="ab" * 16,
                      span_id="cd" * 8)
        for kw in (fields, dict(session="s", scheduler="local", api="status")):
            jev, tev = JaxEvent(**kw), TpxEvent(**kw)
            assert tev.serialize() == jev.serialize() and str(tev) == str(jev)
            assert TpxEvent.deserialize(jev.serialize()) == tev
            assert JaxEvent.deserialize(tev.serialize()) == jev

    def test_log_event_output_equals_jax(self):
        """The records each package's ``log_event`` puts on its events
        logger for the same calls (one that sets the app's metadata, one
        that raises) are the same but for the clocks and the fresh trace
        ids (the JAX logger also carries the spans, which the port sends on
        its span logger)."""
        import logging

        from torchx_tpu.runner.events import get_events_logger as jax_events_logger
        from torchx_tpu.runner.events import log_event as jax_log_event

        from torchx_tpu_torch.runner.events import get_events_logger

        class Capture(logging.Handler):
            def __init__(self):
                super().__init__()
                self.records = []

            def emit(self, record):
                self.records.append(json.loads(record.getMessage()))

        def calls(log):
            with log("status", "local", "app-1", app_image="img", session="s") as ev:
                ev._event.app_metadata = {"a": 1}
            try:
                with log("run", "local", session="s", runcfg="k=v"):
                    raise RuntimeError("boom")
            except RuntimeError:
                pass

        out = []
        for log, logger in ((jax_log_event, jax_events_logger()),
                            (log_event, get_events_logger())):
            capture = Capture()
            logger.addHandler(capture)
            try:
                calls(log)
            finally:
                logger.removeHandler(capture)
            events = [r for r in capture.records if r.get("kind") != "span"]
            for r in events:
                for k in ("cpu_time_usec", "wall_time_usec", "start_epoch_time_usec"):
                    assert r.pop(k) >= 0
                assert (len(r.pop("trace_id")), len(r.pop("span_id"))) == (32, 16)
            out.append(events)
        jax_events, port_events = out
        assert port_events == jax_events and len(port_events) == 2
        assert port_events[1]["exception_type"] == "RuntimeError"
