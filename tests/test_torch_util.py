"""The port's launcher helpers (``torchx_tpu_torch.util``, ``version``,
``deprecations``): the util cases of ``tests/test_serialize_util.py`` run
against the copy, and each helper held to the JAX package's on the same
inputs."""

import json
import random
import typing
import warnings
from datetime import datetime
from typing import Optional

import pytest

from torchx_tpu import deprecations as jdeprecations
from torchx_tpu import version as jversion
from torchx_tpu.util import colors as jcolors
from torchx_tpu.util import jsonl as jjsonl
from torchx_tpu.util import registry as jregistry
from torchx_tpu.util import strings as jstrings
from torchx_tpu.util import times as jtimes
from torchx_tpu.util import types as jtypes
from torchx_tpu_torch import deprecations, version
from torchx_tpu_torch.util import colors, jsonl, registry, session, strings, times, types
from torchx_tpu_torch.util.colors import colored, state_color
from torchx_tpu_torch.util.strings import normalize_str, truncate_middle
from torch_threads import xdist_torch_threads  # noqa: F401


class TestUtilStrings:
    def test_normalize(self):
        assert normalize_str("My Job!x") == "my-job-x"
        assert len(normalize_str("x" * 100)) <= 63

    def test_truncate_middle(self):
        assert truncate_middle("abcdef", 10) == "abcdef"
        out = truncate_middle("abcdefghijklmno", 9)
        assert len(out) == 9 and "..." in out
        assert out.startswith("abc") and out.endswith("o")


class TestUtilColors:
    def test_colored(self):
        assert colored("x", "red") == "\x1b[31mx\x1b[0m"
        assert colored("x", "red", enabled=False) == "x"
        assert colored("x", "nope") == "x"

    def test_state_color(self):
        assert state_color("FAILED") == "red"
        assert state_color("RUNNING") == "green"
        assert state_color("???") == "gray"


class TestUtilModules:
    def test_load_module_plain_and_attr(self):
        from torchx_tpu_torch.util.modules import load_module

        mod = load_module("torchx_tpu_torch.util.strings")
        assert mod is not None
        fn = load_module("torchx_tpu_torch.util.modules:load_module")
        assert fn is load_module
        assert load_module("no.such.module") is None
        assert load_module("torchx_tpu_torch.util.modules:nope") is None

    def test_import_attr_optional_dependency(self):
        from torchx_tpu_torch.util.modules import import_attr

        assert import_attr("not_installed_pkg", "X", default=42) == 42
        got = import_attr("torchx_tpu_torch.util.modules", "import_attr", default=None)
        assert got is import_attr
        # module exists but attr missing: a bug, not an absent dep
        with pytest.raises(AttributeError):
            import_attr("torchx_tpu_torch.util.modules", "nope", default=1)


class TestUtilIO:
    def test_copy_and_read(self, tmp_path):
        from torchx_tpu_torch.util.io import copy_path, exists, read_text

        src = tmp_path / "a.txt"
        src.write_text("payload")
        dst = tmp_path / "sub" / "b.txt"
        copy_path(str(src), str(dst))
        assert read_text(str(dst)) == "payload"
        assert exists(str(dst)) and not exists(str(tmp_path / "nope"))


class TestUtilTimes:
    def test_parse_when_forms(self):
        from torchx_tpu_torch.util.times import parse_when

        assert parse_when(None) is None
        assert parse_when("") is None
        assert parse_when("1722333444.5") == 1722333444.5
        assert parse_when("2h", now=10_000.0) == 10_000.0 - 7200
        assert parse_when("30m", now=10_000.0) == 10_000.0 - 1800
        assert parse_when("1w", now=700_000.0) == 700_000.0 - 604800
        iso = "2026-07-29T10:00:00"
        assert parse_when(iso) == datetime.fromisoformat(iso).timestamp()
        with pytest.raises(ValueError, match="cannot parse"):
            parse_when("yesterdayish")


# -- parity with the JAX package's helpers -----------------------------------

NAMES = ["My Job!x", "x" * 100, "--a__b--", "Ünïcode job", "", "trailing-", "a" * 63 + "-b"]


@pytest.mark.parametrize("name", NAMES)
def test_strings_equal_the_jax_packages(name):
    assert strings.normalize_str(name) == jstrings.normalize_str(name)
    assert strings.normalize_str(name, 10) == jstrings.normalize_str(name, 10)
    for n in (0, 2, 3, 4, 9, 200):
        assert strings.truncate_middle(name, n) == jstrings.truncate_middle(name, n)


def test_colors_equal_the_jax_packages():
    for state in ("RUNNING", "SUCCEEDED", "FAILED", "CANCELLED", "PREEMPTED", "PENDING",
                  "SUBMITTED", "UNKNOWN"):
        assert colors.state_color(state) == jcolors.state_color(state)
        for enabled in (True, False):
            assert (colors.colored(state, colors.state_color(state), enabled)
                    == jcolors.colored(state, jcolors.state_color(state), enabled))


DECODE = [
    ("3", int), ("2.5", float), ("yes", bool), ("off", Optional[bool]), ("a,b", list[str]),
    ("", list[str]), ("1,2", list[int]), ("k=v,x:y", dict[str, str]), ("", dict[str, int]),
    ("7", Optional[int]), ("plain", str), ("plain", typing.Any), ("z", complex),
]


@pytest.mark.parametrize("value, annotation", DECODE)
def test_types_decode_equals_the_jax_packages(value, annotation):
    assert types.decode(value, annotation) == jtypes.decode(value, annotation)
    assert types.is_bool(annotation) == jtypes.is_bool(annotation)
    assert types.decode_optional(None, annotation) is None


@pytest.mark.parametrize("value", [None, "", "300", "1722333444.5", "2h", "45s", "7d", "1w",
                                   "2026-07-29T10:00:00", "nan", "yesterdayish"])
def test_parse_when_equals_the_jax_packages(value):
    def run(fn):
        try:
            return fn(value, now=1_000_000.0)
        except ValueError as e:
            return ("raised", str(e))

    assert run(times.parse_when) == run(jtimes.parse_when)


def test_poll_intervals_equal_the_jax_packages():
    ours = times.poll_intervals(0.5, 2.0, 4.0, 0.1, rng=random.Random(7))
    theirs = jtimes.poll_intervals(0.5, 2.0, 4.0, 0.1, rng=random.Random(7))
    assert [next(ours) for _ in range(8)] == [next(theirs) for _ in range(8)]
    with pytest.raises(ValueError):
        next(times.poll_intervals(0))


def test_clocks():
    assert abs(times.epoch_usec() - jtimes.epoch_usec()) < 60_000_000
    assert times.process_wall_usec() >= 0 and times.process_cpu_usec() >= 0

    class Event:
        start_epoch_time_usec = wall_time_usec = None
        cpu_time_usec = 5

    ev = Event()
    times.stamp_event(ev)
    assert ev.start_epoch_time_usec > 0 and ev.wall_time_usec >= 0 and ev.cpu_time_usec == 5


def test_jsonl_is_read_both_ways(tmp_path):
    ours, theirs = str(tmp_path / "a.jsonl"), str(tmp_path / "b.jsonl")
    for i in range(3):
        jsonl.append_jsonl(ours, {"i": i, "k": "x"})
        jjsonl.append_jsonl(theirs, {"i": i, "k": "x"})
    assert (tmp_path / "a.jsonl").read_bytes() == (tmp_path / "b.jsonl").read_bytes()
    with open(ours, "a") as f:
        f.write('{"torn')
    assert jsonl.read_jsonl(ours) == jjsonl.read_jsonl(ours) == [{"i": i, "k": "x"}
                                                                 for i in range(3)]
    with open(ours, "a") as f:
        f.write('\n{"i": 9}\n')
    for mod in (jsonl, jjsonl):
        with pytest.raises(ValueError, match="corrupt"):
            mod.read_jsonl(ours)
        assert len(mod.read_jsonl(ours, skip="all")) == 4
    jsonl.rewrite_json(str(tmp_path / "s.json"), {"a": [1, 2]})
    jjsonl.rewrite_json(str(tmp_path / "t.json"), {"a": [1, 2]})
    assert (tmp_path / "s.json").read_bytes() == (tmp_path / "t.json").read_bytes()


def test_registry_files_are_shared(tmp_path, monkeypatch):
    path = str(tmp_path / "reg")
    registry.record(path, "app1", "/dir/1")
    jregistry.record(path, "app2", "/dir/2")
    assert registry.entries(path) == jregistry.entries(path) == [("app1", "/dir/1"),
                                                                 ("app2", "/dir/2")]
    assert registry.lookup(path, "app2") == jregistry.lookup(path, "app2") == "/dir/2"
    jregistry.remove(path, "app1")
    registry.remove(path, "app2")
    assert registry.entries(path) == []
    # compaction keeps what ``keep`` keeps, in both copies
    monkeypatch.setattr(registry, "COMPACT_THRESHOLD_BYTES", 0)
    for i in range(4):
        registry.record(path, f"a{i}", "live" if i % 2 else "dead", keep=lambda v: v == "live")
    # each record first drops the dead entries already written
    assert registry.entries(path) == [("a1", "live"), ("a3", "live")]
    assert registry.lookup(str(tmp_path / "missing"), "x") is None


def test_session_id_is_created_once_and_exported(monkeypatch):
    from torchx_tpu_torch import settings

    monkeypatch.setattr(session, "_session_id", None)
    monkeypatch.setenv(settings.ENV_TPX_INTERNAL_SESSION_ID, "feedface")
    assert session.current_session_id() is None
    assert session.get_session_id_or_create_new() == "feedface"
    monkeypatch.setattr(session, "_session_id", None)
    monkeypatch.delenv(settings.ENV_TPX_INTERNAL_SESSION_ID)
    sid = session.get_session_id_or_create_new()
    assert session.get_session_id_or_create_new() == session.current_session_id() == sid
    import os

    assert os.environ[settings.ENV_TPX_INTERNAL_SESSION_ID] == sid


def test_entrypoints_defer_loading(monkeypatch):
    from torchx_tpu_torch.util import entrypoints

    assert entrypoints.load_group("tpx_torch.no_such_group", {"a": 1}) == {"a": 1}
    assert entrypoints.load("tpx_torch.no_such_group", "x", default=3) == 3


def test_version_and_deprecations():
    # the version keys the workspace digest: the JAX package's, the image the port's
    assert version.__version__ == jversion.__version__
    assert version.TORCHX_TPU_IMAGE.endswith(f"torchx-tpu-torch:{version.__version__}")
    assert version.TORCHX_TPU_IMAGE != jversion.TORCHX_TPU_IMAGE

    def old(x):
        return x + 1

    for mod in (deprecations, jdeprecations):
        wrapped = mod.deprecated(replacement="new", since="0.1")(old)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            assert wrapped(1) == 2
        assert "deprecated since 0.1; use new instead" in str(w[0].message)
    with pytest.warns(UserWarning, match="module m is deprecated; use n instead"):
        deprecations.deprecated_module("m", "n")


def test_jsonl_records_are_sorted_json(tmp_path):
    path = str(tmp_path / "x.jsonl")
    jsonl.append_jsonl(path, {"b": 1, "a": 2})
    assert (tmp_path / "x.jsonl").read_text() == json.dumps({"a": 2, "b": 1}) + "\n"
