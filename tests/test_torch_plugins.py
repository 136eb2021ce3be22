"""The port's plugin registry (``torchx_tpu_torch.plugins``): the cases of
``tests/test_tracker_plugins.py``'s ``TestPlugins`` run against the copy,
with the port's own entry-point groups and namespace package. Of its two
tracker cases, the registry halves run here and the ``trackers_from_environ``
halves in ``tests/test_torch_tracker.py``."""

import sys

import pytest

from torchx_tpu.plugins import _registry as jregistry
from torchx_tpu_torch.plugins import error_report, get_registry, register
from torchx_tpu_torch.plugins import _registry as tregistry
from torchx_tpu_torch.plugins._registration import Share, clear_registrations
from torchx_tpu_torch.specs.api import GpuSlice, Resource
from torch_threads import xdist_torch_threads  # noqa: F401

NS = tregistry.NAMESPACE_PACKAGE


@pytest.fixture(autouse=True)
def _fresh_registry():
    """Each case starts and ends with no registrations and no cached
    namespace modules (the namespace directories live in ``tmp_path``)."""
    clear_registrations()
    yield
    clear_registrations()
    for name in [m for m in sys.modules if m == NS or m.startswith(NS + ".")]:
        del sys.modules[name]
    get_registry(invalidate_cache=True)


def _namespace(tmp_path, monkeypatch, files: dict[str, str]):
    ns = tmp_path / NS
    ns.mkdir()
    for name, text in files.items():
        (ns / name).write_text(text)
    monkeypatch.syspath_prepend(str(tmp_path))


class TestPlugins:
    def test_register_scheduler(self):
        @register.scheduler("mysched", alias="ms")
        def create(session_name, **kw):  # noqa: ANN001
            return "sched-instance"

        reg = get_registry(invalidate_cache=True)
        assert reg.schedulers["mysched"] is create
        assert reg.schedulers["ms"] is create
        from torchx_tpu_torch.plugins import get_plugin_schedulers
        from torchx_tpu_torch.schedulers import get_scheduler_factories

        assert get_plugin_schedulers()["mysched"] is create
        assert "mysched" in get_scheduler_factories()

    def test_register_named_resource_with_fractions(self):
        @register.named_resource("superpod", fractions=True)
        def superpod():
            return Resource(cpu=208, memMB=1000, gpu=GpuSlice("h100", 8))

        reg = get_registry(invalidate_cache=True)
        assert set(reg.named_resources) >= {
            "superpod",
            "superpod_half",
            "superpod_quarter",
        }
        half = reg.named_resources["superpod_half"]()
        assert half.gpu.gpus == 4
        assert half.cpu == 104 and half.memMB == 500
        assert half.tags["tpx.share"] == "half"
        quarter = reg.named_resources["superpod_quarter"]()
        assert quarter.gpu.gpus == 2 and quarter.tags["tpx.share"] == "quarter"
        assert superpod().gpu.gpus == 8  # the whole share is untouched

    def test_fraction_keeps_a_slice_smaller_than_its_divisor(self):
        @register.named_resource("one_card", fractions=True)
        def one_card():
            return Resource(cpu=3, memMB=3, gpu=GpuSlice("h100", 1))

        reg = get_registry(invalidate_cache=True)
        quarter = reg.named_resources["one_card_quarter"]()
        assert quarter.gpu.gpus == 1 and (quarter.cpu, quarter.memMB) == (1, 1)
        assert Share.QUARTER.value == 4

    def test_named_resource_visible_after_cache_invalidation(self):
        from torchx_tpu_torch.specs import named_resources

        _ = named_resources["cpu_small"]  # populate the specs-level cache

        @register.named_resource("late_resource")
        def late():
            return Resource(cpu=7, memMB=7)

        get_registry(invalidate_cache=True)
        assert named_resources["late_resource"].cpu == 7

    def test_plugin_tracker_with_colon_name(self):
        @register.tracker("myorg:prod", alias="prod")
        def create(config):  # noqa: ANN001
            return ("tracker", config)

        reg = get_registry(invalidate_cache=True)
        assert reg.trackers["myorg:prod"] is reg.trackers["prod"] is create
        from torchx_tpu_torch.plugins import get_plugin_trackers

        assert get_plugin_trackers()["myorg:prod"]("cfg") == ("tracker", "cfg")

    def test_register_tracker_reachable_from_env(self):
        # the registry half; reading $TPX_TRACKERS: tests/test_torch_tracker.py
        @register.tracker("custom_t")
        def create(config):  # noqa: ANN001
            return config

        get_registry(invalidate_cache=True)
        from torchx_tpu_torch.plugins import get_plugin_trackers

        assert get_plugin_trackers()["custom_t"] is create

    def test_namespace_package_discovery(self, tmp_path, monkeypatch):
        _namespace(tmp_path, monkeypatch, {"myplug.py": (
            "def register(registrar):\n"
            "    registrar.scheduler('ns_sched', lambda session_name, **kw: 'x')\n"
            "    registrar.named_resource('ns_res', lambda: None)\n"
            "    registrar.tracker('ns_t', lambda config: None)\n"
        )})
        reg = get_registry(invalidate_cache=True)
        assert "ns_sched" in reg.schedulers
        assert "ns_res" in reg.named_resources and "ns_t" in reg.trackers

    def test_broken_namespace_plugin_captured(self, tmp_path, monkeypatch):
        _namespace(tmp_path, monkeypatch, {"broken.py": "raise RuntimeError('boom')\n"})
        reg = get_registry(invalidate_cache=True)
        assert any("broken" in e.plugin for e in reg.errors)
        assert "boom" in error_report()

    def test_plugins_disabled_by_env(self, tmp_path, monkeypatch):
        @register.scheduler("always_there")
        def create(session_name, **kw):  # noqa: ANN001
            return "x"

        _namespace(tmp_path, monkeypatch, {"p.py": (
            "def register(r):\n    r.scheduler('ns_only', lambda **kw: 'y')\n")})
        monkeypatch.setenv("TPX_PLUGINS_SOURCE", "0")
        reg = get_registry(invalidate_cache=True)
        assert "ns_only" not in reg.schedulers
        # programmatic registrations always apply
        assert "always_there" in reg.schedulers
        monkeypatch.setenv("TPX_PLUGINS_SOURCE", "bogus")  # warns, then reads all
        assert "ns_only" in get_registry(invalidate_cache=True).schedulers

    def test_no_plugin_errors(self):
        assert get_registry(invalidate_cache=True).errors == []
        assert error_report() == "no plugin errors"


def test_the_port_has_its_own_groups():
    ours = (tregistry.EP_GROUP_SCHEDULERS, tregistry.EP_GROUP_NAMED_RESOURCES,
            tregistry.EP_GROUP_TRACKERS, tregistry.NAMESPACE_PACKAGE)
    theirs = (jregistry.EP_GROUP_SCHEDULERS, jregistry.EP_GROUP_NAMED_RESOURCES,
              jregistry.EP_GROUP_TRACKERS, jregistry.NAMESPACE_PACKAGE)
    assert ours == ("tpx_torch.schedulers", "tpx_torch.named_resources", "tpx_torch.trackers",
                    "tpx_torch_plugins")
    assert not set(ours) & set(theirs)
    assert [s.value for s in tregistry.PluginSource] == [s.value for s in jregistry.PluginSource]
    assert [t.value for t in tregistry.PluginType] == [t.value for t in jregistry.PluginType]


def test_a_jax_namespace_plugin_is_not_read(tmp_path, monkeypatch):
    (tmp_path / jregistry.NAMESPACE_PACKAGE).mkdir()
    (tmp_path / jregistry.NAMESPACE_PACKAGE / "jaxplug.py").write_text(
        "def register(r):\n    r.scheduler('jax_only', lambda **kw: 'j')\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    try:
        assert "jax_only" in jregistry.get_registry(invalidate_cache=True).schedulers
        assert "jax_only" not in get_registry(invalidate_cache=True).schedulers
    finally:
        for name in [m for m in sys.modules if m.startswith(jregistry.NAMESPACE_PACKAGE)]:
            del sys.modules[name]
        monkeypatch.undo()
        jregistry.get_registry(invalidate_cache=True)


def test_scheduler_entry_points_reach_the_factories(tmp_path, monkeypatch):
    """A backend installed under ``tpx_torch.schedulers`` joins the port's
    scheduler table; one installed under the JAX launcher's
    ``tpx.schedulers`` is not imported by the port."""
    from torchx_tpu_torch.schedulers import get_scheduler_factories

    dist = tmp_path / "tpx_fake_sched-0.1.dist-info"
    dist.mkdir()
    (dist / "METADATA").write_text("Metadata-Version: 2.1\nName: tpx-fake-sched\n"
                                   "Version: 0.1\n")
    (dist / "entry_points.txt").write_text(
        "[tpx.schedulers]\njax_sched = tpx_fake_jax_sched:create\n"
        "[tpx_torch.schedulers]\nport_sched = tpx_fake_port_sched:create\n")
    for mod in ("tpx_fake_jax_sched", "tpx_fake_port_sched"):
        (tmp_path / f"{mod}.py").write_text("def create(session_name, **kw):\n    return None\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    try:
        factories = (get_registry(invalidate_cache=True), get_scheduler_factories())[1]
        assert "port_sched" in factories and "local" in factories
        assert "jax_sched" not in factories
        assert "tpx_fake_jax_sched" not in sys.modules
    finally:
        monkeypatch.undo()
        for mod in ("tpx_fake_jax_sched", "tpx_fake_port_sched"):
            sys.modules.pop(mod, None)
        get_registry(invalidate_cache=True)
