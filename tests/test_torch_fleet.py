"""The port's fleet scheduler (``torchx_tpu_torch.fleet``) held to the JAX
package's own cases: every case of ``tests/test_fleet.py`` but the TPX602
``TestFleetClassRule`` (5) and the three memory-oracle cases, which wait
for the analyzer (ROADMAP queue 1 item 2.8), each run against the copy:
the modeled fleet and gang requests, queue ordering (class / fair share /
FIFO) and quotas, the durable decision journal, placement, the
preemption market, the ``FleetScheduler`` facade (shrink -> grow-back
through the attempt ledger, rehydration) and the daemon e2e paths (fleet
submits on the real local scheduler, queue ordering over HTTP, the
legacy 429 contract, restart rehydration).

Pools are H100 units: ``v5e-4x8`` reads ``h100-4x8`` (eight 4-GPU
units), and a JAX case over two generations uses two ``h100`` pools,
since ``GPU_GENERATIONS`` has one. In place of the oracle cases,
``test_oracle_seam_names_item_2_8``: a plan-shaped role reaches the seam
and raises naming 2.8, before anything is journaled; a role that is not
plan-shaped is placed. Added: parity with the JAX package on the same
inputs (``TestJaxParity``: both ``FleetScheduler``s, driven by one seeded
stream of synthetic gangs and terminal events, make the same placements,
shrinks, preemptions and grow-backs and write the same journal records,
clocks and trace ids apart).

The port's lint gate raises until the analyzer is ported, so an autouse
fixture sets ``TPX_NO_LINT=1``; every case keeps the local scheduler's
registry under ``tmp_path``, sees a card-less host, and starts with the
port's breakers and fault plan reset."""


import json
import time
import types
import urllib.error
import urllib.request

import pytest

from torchx_tpu_torch.control.client import ControlClient, ControlClientError
from torchx_tpu_torch.control.daemon import ControlDaemon
from torchx_tpu_torch.fleet import (
    FleetJournal,
    FleetModel,
    FleetQueue,
    FleetScheduler,
    GangRequest,
    Preempt,
    Shrink,
    SlicePool,
    Victim,
    over_quota,
    parse_quotas,
    plan_market,
    plan_placement,
    priority_index,
)
from torchx_tpu_torch.runner.api import get_runner
from torchx_tpu_torch.specs.api import AppDef, Role, GpuSlice
from torchx_tpu_torch.specs.serialize import appdef_to_dict

import numpy as np

from torchx_tpu_torch import settings
from torchx_tpu_torch.resilience import call as resilience_call
from torchx_tpu_torch.resilience import faults as resilience_faults
from torchx_tpu_torch.schedulers import local_scheduler as lsched
from torch_threads import xdist_torch_threads  # noqa: F401


@pytest.fixture(autouse=True)
def _no_lint_own_registry(tmp_path, monkeypatch):
    """The lint gate is bypassed (it raises until ROADMAP queue 1 item 2.8),
    the local scheduler's registry lives in ``tmp_path``, the host has no
    card, and the port's breakers and fault plan start clean."""
    monkeypatch.setenv(settings.ENV_TPX_NO_LINT, "1")
    monkeypatch.setattr(lsched, "_registry_path", lambda: str(tmp_path / "registry"))
    monkeypatch.delenv(settings.ENV_CUDA_VISIBLE_DEVICES, raising=False)
    monkeypatch.setattr(lsched, "driver_gpu_count", lambda: 0)
    resilience_call.reset_breakers()
    resilience_faults.reset()


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


class FakeExec:
    """A FleetExecutor double: mints handles, records every call."""

    def __init__(self) -> None:
        self.n = 0
        self.calls: list = []
        self.fail_next = False

    def schedule(self, job, mesh_spec):
        if self.fail_next:
            self.fail_next = False
            raise RuntimeError("backend said no")
        self.n += 1
        self.calls.append((job.req.job, job.cur_replicas, mesh_spec))
        return f"local://fake/app-{self.n}"

    def cancel(self, handle):
        self.calls.append(("cancel", handle))


def terminal_event(app_id: str, state: str = "SUCCEEDED"):
    return types.SimpleNamespace(
        scheduler="local",
        app_id=app_id,
        terminal=True,
        state=types.SimpleNamespace(name=state),
    )


def make_fs(tmp_path, spec: str, quotas=None) -> tuple:
    clock = [0.0]
    fs = FleetScheduler(
        FleetModel.from_spec(spec),
        state_dir=str(tmp_path),
        quotas=quotas,
        clock=lambda: clock[0],
    )
    ex = FakeExec()
    fs.bind(ex)
    return fs, ex, clock


def gang(job="", tenant="t", klass="batch", replicas=1, chips=1, **kw):
    return GangRequest(
        job=job,
        tenant=tenant,
        klass=klass,
        replicas=replicas,
        chips_per_replica=chips,
        **kw,
    )


def llama_role() -> Role:
    from torchx_tpu_torch.components import dist

    app = dist.spmd(
        "--config",
        "llama3_8b",
        "--mesh",
        "fsdp=-1",
        m="my.custom_trainer",
        j="1x8",
    )
    return app.roles[0]


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


class TestFleetModel:
    def test_from_spec(self):
        m = FleetModel.from_spec("default:h100-4x8,big:h100-8x2")
        assert m.total_chips == 4 * 8 + 8 * 2
        assert len(m.units()) == 10
        assert m.unit("big/1").shape.accelerator == "h100"

    def test_bare_spec_gets_default_pool_name(self):
        m = FleetModel.from_spec("h100-4x2")
        assert [p.name for p in m.pools] == ["default"]

    def test_bad_spec_raises(self):
        with pytest.raises(ValueError, match="bad fleet pool spec"):
            FleetModel.from_spec("h100-fourxtwo")
        with pytest.raises(ValueError, match="at least one pool"):
            FleetModel.from_spec("")
        with pytest.raises(ValueError, match="duplicate pool"):
            FleetModel(
                [
                    SlicePool("a", GpuSlice("h100", 4), 1),
                    SlicePool("a", GpuSlice("h100", 4), 1),
                ]
            )

    def test_assign_release_accounting(self):
        m = FleetModel.from_spec("p:h100-4x2")
        m.assign(["p/0"], "j1")
        assert m.owner_of("p/0") == "j1"
        assert m.free_chips == 4
        with pytest.raises(ValueError, match="already owned"):
            m.assign(["p/0"], "j2")
        assert m.release_job("j1") == ["p/0"]
        assert m.free_chips == 8

    def test_gang_request_validation(self):
        with pytest.raises(ValueError, match="unknown priority class"):
            gang(klass="gold")
        with pytest.raises(ValueError, match="min_replicas"):
            gang(replicas=2, min_replicas=3)
        g = gang(klass="serve", replicas=2, chips=4)
        assert g.chips == 8
        assert g.priority == priority_index("serve") == 0
        assert priority_index("preemptible") == 3


# ---------------------------------------------------------------------------
# queue + quota + journal
# ---------------------------------------------------------------------------


class TestQueueOrdering:
    def test_class_then_fairshare_then_fifo(self):
        q = FleetQueue()
        q.push(gang(job="b1", tenant="big", klass="batch"), 0.0)
        q.push(gang(job="b2", tenant="small", klass="batch"), 0.0)
        q.push(gang(job="s1", tenant="big", klass="serve"), 0.0)
        # serve beats batch regardless of arrival; within batch the
        # tenant with fewer placed chips goes first
        order = [e.req.job for e in q.ordered({"big": 100, "small": 2})]
        assert order == ["s1", "b2", "b1"]
        assert q.position("b1", {"big": 100, "small": 2}) == 3
        # equal placed chips -> FIFO
        assert [e.req.job for e in q.ordered()] == ["s1", "b1", "b2"]

    def test_requeue_keeps_original_seq(self):
        q = FleetQueue()
        first = q.push(gang(job="old", klass="batch"), 0.0)
        q.remove("old")
        q.push(gang(job="new", klass="batch"), 1.0)
        q.push(gang(job="old", klass="batch"), 2.0, seq=first.seq)
        assert [e.req.job for e in q.ordered()] == ["old", "new"]

    def test_over_quota(self):
        quotas = parse_quotas(["capped=8"])
        assert not over_quota(gang(tenant="free", chips=999), {}, quotas)
        assert not over_quota(
            gang(tenant="capped", replicas=2, chips=4), {}, quotas
        )
        assert over_quota(
            gang(tenant="capped", chips=1), {"capped": 8}, quotas
        )
        with pytest.raises(ValueError, match="expected tenant=chips"):
            parse_quotas(["nope"])


class TestFleetJournal:
    def test_roundtrip_and_torn_line(self, tmp_path):
        j = FleetJournal(str(tmp_path / "j.jsonl"))
        j.append("submit", job="a", seq=1)
        j.append("place", job="a", units=["p/0"])
        with open(j.path, "a") as f:
            f.write('{"kind": "torn')  # crash mid-append
        kinds = [e["kind"] for e in j.entries()]
        assert kinds == ["submit", "place"]

    def test_missing_file_is_empty(self, tmp_path):
        assert list(FleetJournal(str(tmp_path / "none.jsonl")).entries()) == []


# ---------------------------------------------------------------------------
# the placer (+ the HBM oracle)
# ---------------------------------------------------------------------------


class TestPlacer:
    def test_single_pool_contiguity_preferred(self):
        m = FleetModel.from_spec("a:h100-4x2,b:h100-4x4")
        d = plan_placement(gang(replicas=3, chips=4), m)
        # only pool b can host the whole gang; lowest indices first
        assert [u.uid for u in d.units] == ["b/0", "b/1", "b/2"]

    def test_exact_fit_beats_fragmenting_big_slices(self):
        m = FleetModel.from_spec("small:h100-4x2,big:h100-8x2")
        d = plan_placement(gang(replicas=2, chips=4), m)
        assert [u.uid for u in d.units] == ["small/0", "small/1"]

    def test_spill_across_pools_when_no_pool_fits_alone(self):
        m = FleetModel.from_spec("a:h100-4x1,b:h100-4x1")
        d = plan_placement(gang(replicas=2, chips=4), m)
        assert sorted(u.uid for u in d.units) == ["a/0", "b/0"]

    def test_insufficient_capacity_queues_not_infeasible(self):
        m = FleetModel.from_spec("a:h100-4x1")
        m.assign(["a/0"], "other")
        d = plan_placement(gang(replicas=1, chips=4), m)
        assert not d.placed and not d.infeasible

    def test_gang_admission_is_all_or_nothing(self):
        m = FleetModel.from_spec("a:h100-4x2")
        d = plan_placement(gang(replicas=3, chips=4), m)
        assert d.units == []  # 2 free, 3 needed: nothing placed

    def test_no_capable_pool_is_infeasible(self):
        m = FleetModel.from_spec("a:h100-4x2")
        d = plan_placement(gang(replicas=1, chips=8), m)
        assert "no pool has 8-chip slices" in d.infeasible

    def test_oracle_seam_names_item_2_8(self, tmp_path):
        """In place of the three oracle cases (ROADMAP queue 1 item 2.8): a
        plan-shaped role (``--config llama3_8b``) reaches the seam and
        raises naming 2.8, from the placer and from a scheduler submit
        (before anything is journaled); a role that names no preset is
        placed, as the JAX oracle passes it (TPX705 info)."""
        role = llama_role()
        m = FleetModel.from_spec("edge:h100-1x2,big:h100-8x2")
        with pytest.raises(NotImplementedError, match="item 2.8"):
            plan_placement(gang(replicas=1, chips=8), m, role=role)
        plain = Role(name="sh", image="i", entrypoint="sh", args=["-c", "true"])
        d = plan_placement(gang(replicas=1, chips=8), m, role=plain)
        assert d.placed and d.units[0].pool == "big"
        fs, ex, _ = make_fs(tmp_path, "edge:h100-1x2")
        app = AppDef(name="llama", roles=[role])
        with pytest.raises(NotImplementedError, match="deep_preflight"):
            fs.submit(gang(replicas=1), {"appdef": appdef_to_dict(app), "scheduler": "local"})
        assert ex.n == 0 and list(fs.journal.entries()) == [] and fs.queue_snapshot()["queue"] == []
        r = fs.submit(gang(replicas=1),
                      {"appdef": appdef_to_dict(AppDef(name="sh", roles=[plain])),
                       "scheduler": "local"})
        assert r["status"] == "placed" and r["job"] == "fj-0001" and ex.n == 1



# ---------------------------------------------------------------------------
# the market
# ---------------------------------------------------------------------------


def victim(job, klass, seq, elastic=True, replicas=4, min_replicas=1, ok=True):
    return Victim(
        job=job,
        priority=priority_index(klass),
        elastic=elastic,
        replicas=replicas,
        min_replicas=min_replicas,
        seq=seq,
        suitable=ok,
    )


class TestMarket:
    def test_elastic_victim_is_shrunk_not_killed(self):
        plan = plan_market(2, 0, [victim("v", "batch", 1)])
        assert plan == [Shrink(job="v", to_replicas=2, freed=2)]

    def test_shrink_respects_min_replicas(self):
        plan = plan_market(2, 0, [victim("v", "batch", 1, min_replicas=3)])
        # only 1 replica of headroom: not enough alone -> no plan
        assert plan == []

    def test_lowest_class_youngest_pays_first(self):
        plan = plan_market(
            2,
            0,
            [
                victim("old-preempt", "preemptible", 1, replicas=2),
                victim("young-preempt", "preemptible", 5, replicas=2),
                victim("batch", "batch", 2, replicas=4),
            ],
        )
        assert [a.job for a in plan] == ["young-preempt", "old-preempt"]

    def test_non_elastic_falls_back_to_preempt(self):
        plan = plan_market(
            2, 0, [victim("v", "batch", 1, elastic=False, replicas=2)]
        )
        assert plan == [Preempt(job="v", freed=2)]

    def test_equal_or_higher_class_is_never_victimized(self):
        assert plan_market(1, 1, [victim("peer", "interactive", 1)]) == []
        assert plan_market(1, 1, [victim("above", "serve", 1)]) == []

    def test_all_or_nothing(self):
        # one elastic victim with 1 headroom cannot cover a need of 3
        plan = plan_market(3, 0, [victim("v", "batch", 1, replicas=2)])
        assert plan == []

    def test_unsuitable_victims_are_skipped(self):
        assert plan_market(1, 0, [victim("v", "batch", 1, ok=False)]) == []


# ---------------------------------------------------------------------------
# the scheduler facade
# ---------------------------------------------------------------------------


class TestFleetScheduler:
    def test_place_queue_and_gang_admission(self, tmp_path):
        fs, ex, _ = make_fs(tmp_path, "sim:h100-1x4")
        r1 = fs.submit(gang(replicas=3), {"scheduler": "local"})
        assert r1["status"] == "placed"
        # 1 free slice, gang of 3: queued whole, nothing partially placed
        r2 = fs.submit(gang(tenant="u", replicas=3), {"scheduler": "local"})
        assert r2["status"] == "queued" and r2["position"] == 1
        assert fs.model.free_chips == 1
        assert ex.n == 1

    def test_quota_blocks_placement_not_admission(self, tmp_path):
        fs, ex, _ = make_fs(tmp_path, "sim:h100-1x4", quotas={"capped": 2})
        r1 = fs.submit(
            gang(tenant="capped", replicas=3), {"scheduler": "local"}
        )
        assert r1["status"] == "queued"  # 3 chips > quota of 2
        snap = fs.queue_snapshot()
        assert snap["queue"][0]["quota_blocked"] is True
        # an unlimited tenant sails past the quota-blocked gang
        r2 = fs.submit(gang(tenant="free", replicas=4), {"scheduler": "local"})
        assert r2["status"] == "placed"

    def test_shrink_then_growback_through_the_ledger(self, tmp_path):
        fs, ex, _ = make_fs(tmp_path, "sim:h100-1x4")
        low = fs.submit(
            gang(
                klass="batch",
                tenant="research",
                replicas=4,
                elastic=True,
                mesh="fsdp=-1",
                min_replicas=1,
            ),
            {"scheduler": "local"},
        )
        high = fs.submit(
            gang(klass="serve", tenant="prod", replicas=2),
            {"scheduler": "local"},
        )
        assert high["status"] == "placed"
        assert fs.reshapes == 1 and fs.kills == 0
        low_job = fs.job(low["job"])
        assert low_job.cur_replicas == 2 and low_job.shrunk
        # serve completes -> the debt is repaid at the full launch mesh
        fs.on_event(terminal_event("app-3"))
        assert fs.grows == 1
        assert low_job.cur_replicas == 4 and not low_job.shrunk
        meshes = [
            e.get("mesh") for e in fs.ledger(low["job"]).entries()
        ]
        assert meshes == [
            None,
            "pp=1,dp=1,fsdp=2,ep=1,tp=1,sp=1",
            "pp=1,dp=1,fsdp=4,ep=1,tp=1,sp=1",
        ]

    def test_non_elastic_victim_requeued_then_replaced(self, tmp_path):
        fs, ex, _ = make_fs(tmp_path, "sim:h100-1x2")
        low = fs.submit(
            gang(klass="preemptible", tenant="spot", replicas=2),
            {"scheduler": "local"},
        )
        high = fs.submit(
            gang(klass="interactive", tenant="dev", replicas=2),
            {"scheduler": "local"},
        )
        assert high["status"] == "placed"
        assert fs.kills == 1 and fs.reshapes == 0
        assert fs.job(low["job"]).state == "queued"
        fs.on_event(terminal_event("app-2"))  # interactive finishes
        assert fs.job(low["job"]).state == "running"
        assert ("cancel", "local://fake/app-1") in ex.calls

    def test_executor_failure_requeues_without_leaking_slices(self, tmp_path):
        fs, ex, _ = make_fs(tmp_path, "sim:h100-1x2")
        ex.fail_next = True
        r = fs.submit(gang(replicas=2), {"scheduler": "local"})
        assert r["status"] == "queued"
        assert fs.model.free_chips == 2
        # next loop trigger retries it
        fs.on_event(terminal_event("no-such-app"))  # unknown handle: no-op
        r2 = fs.submit(gang(tenant="u", replicas=2), {"scheduler": "local"})
        assert r2["status"] == "queued"  # first gang placed on its retry
        assert fs.job(r["job"]).state == "running"

    def test_journal_rehydration(self, tmp_path):
        fs, ex, _ = make_fs(tmp_path, "sim:h100-1x4")
        running = fs.submit(
            gang(
                klass="batch",
                replicas=4,
                elastic=True,
                mesh="fsdp=-1",
            ),
            {"scheduler": "local"},
        )
        fs.submit(gang(tenant="u", klass="serve", replicas=2), {"scheduler": "local"})
        # serve shrank batch to 2; now replay the journal from scratch
        fs2, _, _ = make_fs(tmp_path, "sim:h100-1x4")
        assert fs2.rehydrate() == 2
        j = fs2.job(running["job"])
        assert j.state == "running" and j.cur_replicas == 2 and j.shrunk
        assert fs2.model.free_chips == 0
        # new submits keep queueing behind the rehydrated state
        r3 = fs2.submit(gang(tenant="w", replicas=1), {"scheduler": "local"})
        assert r3["status"] == "queued"

    def test_cancel_queued_job(self, tmp_path):
        fs, ex, _ = make_fs(tmp_path, "sim:h100-1x1")
        fs.submit(gang(replicas=1), {"scheduler": "local"})
        queued = fs.submit(gang(tenant="u", replicas=1), {"scheduler": "local"})
        assert fs.cancel_job(queued["job"]) is True
        assert fs.job(queued["job"]).state == "done"
        assert fs.cancel_job("fj-9999") is False


# ---------------------------------------------------------------------------
# daemon e2e (real LocalScheduler)
# ---------------------------------------------------------------------------


def make_daemon(tmp_path, monkeypatch, fleet_spec=None, quotas=None, **kw):
    monkeypatch.setenv("TPX_WATCH_INTERVAL", "0.05")
    state_dir = str(tmp_path / "control")
    fleet = None
    if fleet_spec:
        fleet = FleetScheduler(
            FleetModel.from_spec(fleet_spec),
            state_dir=state_dir,
            quotas=quotas,
        )
    return ControlDaemon(
        runner=get_runner("fleet-test"),
        state_dir=state_dir,
        fleet=fleet,
        **kw,
    ).start()


def wait_until(predicate, timeout=60.0, interval=0.1):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return False


class TestFleetDaemon:
    def test_shrink_and_growback_e2e(self, tmp_path, monkeypatch):
        d = make_daemon(tmp_path, monkeypatch, fleet_spec="sim:h100-1x4")
        try:
            client = ControlClient(d.addr, d.root_token)
            low = client.submit_job(
                "utils.sh",
                ["sleep", "30"],
                "local",
                cfg={"log_dir": str(tmp_path / "low")},
                priority="batch",
                elastic=True,
                mesh="fsdp=-1",
                replicas=4,
                min_replicas=1,
            )
            assert low.get("handle", "").startswith("local://")
            # high-priority gang forces the elastic shrink, placing NOW
            high = client.submit_job(
                "utils.sh",
                ["sleep", "1"],
                "local",
                cfg={"log_dir": str(tmp_path / "high")},
                priority="serve",
                replicas=2,
            )
            assert high.get("handle", "").startswith("local://")
            entries = list(d.fleet.ledger(low["fleet_job"]).entries())
            assert [e.get("mesh") for e in entries] == [
                None,
                "pp=1,dp=1,fsdp=2,ep=1,tp=1,sp=1",
            ]
            assert [e.get("replicas") for e in entries] == [4, 2]
            # the shrunk attempt really runs on 2 replicas with the env
            snap = client.queue()
            mine = next(
                r for r in snap["running"] if r["job"] == low["fleet_job"]
            )
            assert mine["shrunk"] and mine["replicas"] == 2
            assert snap["market"]["reshapes"] == 1
            assert snap["market"]["kills"] == 0
            # serve finishes (~1s): the watch stream triggers the grow-back
            assert wait_until(
                lambda: client.queue()["market"]["growbacks"] == 1
            ), "grow-back never happened"
            entries = list(d.fleet.ledger(low["fleet_job"]).entries())
            assert entries[-1].get("mesh") == "pp=1,dp=1,fsdp=4,ep=1,tp=1,sp=1"
            assert entries[-1].get("replicas") == 4
            mine = next(
                r
                for r in client.queue()["running"]
                if r["job"] == low["fleet_job"]
            )
            assert not mine["shrunk"] and mine["replicas"] == 4
        finally:
            d.close()
            d.runner.close()

    def test_queue_ordering_metrics_and_202(self, tmp_path, monkeypatch):
        d = make_daemon(tmp_path, monkeypatch, fleet_spec="sim:h100-1x4")
        try:
            client = ControlClient(d.addr, d.root_token)
            filler = client.submit_job(
                "utils.sh",
                ["sleep", "30"],
                "local",
                cfg={"log_dir": str(tmp_path / "filler")},
                priority="serve",
                replicas=4,
            )
            assert filler.get("handle")
            batch = client.submit_job(
                "utils.sh",
                ["sleep", "1"],
                "local",
                cfg={"log_dir": str(tmp_path / "b")},
                priority="batch",
            )
            inter = client.submit_job(
                "utils.sh",
                ["sleep", "1"],
                "local",
                cfg={"log_dir": str(tmp_path / "i")},
                priority="interactive",
            )
            assert batch["queued"] and inter["queued"]
            # interactive outranks batch despite arriving later
            snap = client.queue()
            assert [q["class"] for q in snap["queue"]] == [
                "interactive",
                "batch",
            ]
            assert snap["queue"][0]["job"] == inter["fleet_job"]
            # the legacy handle-now verb surfaces queueing as a 202
            with pytest.raises(ControlClientError) as ei:
                client.submit(
                    "utils.sh",
                    ["sleep", "1"],
                    "local",
                    cfg={"log_dir": str(tmp_path / "x")},
                )
            assert ei.value.code == 202 and "tpx-torch queue" in ei.value.message
            # fleet gauges are on /metricz
            with urllib.request.urlopen(d.addr + "/metricz") as resp:
                text = resp.read().decode()
            assert 'tpx_fleet_queue_depth{klass="interactive"} 1' in text
            assert 'tpx_fleet_chips{state="free"} 0' in text
            assert "tpx_fleet_placements_total" in text
            # a queued gang can be cancelled by fleet job id
            client._request("/v1/cancel", {"job": batch["fleet_job"]})
            assert all(
                q["job"] != batch["fleet_job"]
                for q in client.queue()["queue"]
            )
        finally:
            d.close()
            d.runner.close()

    def test_legacy_429_retry_after_contract(self, tmp_path, monkeypatch):
        d = make_daemon(tmp_path, monkeypatch, tenant_cap=1)
        try:
            client = ControlClient(d.addr, d.root_token)
            client.submit(
                "utils.sh",
                ["sleep", "30"],
                "local",
                cfg={"log_dir": str(tmp_path / "one")},
            )
            req = urllib.request.Request(
                d.addr + "/v1/submit",
                data=json.dumps(
                    {
                        "component": "utils.sh",
                        "args": ["sleep", "1"],
                        "scheduler": "local",
                        "cfg": {"log_dir": str(tmp_path / "two")},
                    }
                ).encode(),
                headers={
                    "Authorization": f"Bearer {d.root_token}",
                    "Content-Type": "application/json",
                },
                method="POST",
            )
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(req)
            err = ei.value
            assert err.code == 429
            assert err.headers["Retry-After"] == "5"
            body = json.loads(err.read())
            assert body["code"] == "tenant_cap_exceeded"
            assert body["tenant"] == "root"
            assert body["active"] == 1 and body["cap"] == 1
            assert body["retry_after_seconds"] == 5
        finally:
            d.close()
            d.runner.close()

    def test_daemon_restart_rehydrates_the_queue(self, tmp_path, monkeypatch):
        # one 4-chip slice: a 2-replica x 4-chip gang can NEVER place now
        # but is not infeasible (the pool shape fits) -> it queues durably
        d = make_daemon(tmp_path, monkeypatch, fleet_spec="sim:h100-4x1")
        batch = inter = None
        try:
            client = ControlClient(d.addr, d.root_token)
            batch = client.submit_job(
                "utils.sh",
                ["sleep", "1"],
                "local",
                cfg={"log_dir": str(tmp_path / "b")},
                priority="batch",
                replicas=2,
                chips=4,
            )
            inter = client.submit_job(
                "utils.sh",
                ["sleep", "1"],
                "local",
                cfg={"log_dir": str(tmp_path / "i")},
                priority="interactive",
                replicas=2,
                chips=4,
            )
            assert batch["queued"] and inter["queued"]
        finally:
            d.close()
            d.runner.close()
        d2 = make_daemon(tmp_path, monkeypatch, fleet_spec="sim:h100-4x1")
        try:
            client = ControlClient(d2.addr, d2.root_token)
            snap = client.queue()
            assert [q["job"] for q in snap["queue"]] == [
                inter["fleet_job"],
                batch["fleet_job"],
            ]
            assert snap["fleet"]["chips_free"] == 4
        finally:
            d2.close()
            d2.runner.close()

    def test_infeasible_submit_is_409(self, tmp_path, monkeypatch):
        d = make_daemon(tmp_path, monkeypatch, fleet_spec="sim:h100-4x1")
        try:
            client = ControlClient(d.addr, d.root_token)
            with pytest.raises(ControlClientError) as ei:
                client.submit_job(
                    "utils.sh",
                    ["sleep", "1"],
                    "local",
                    cfg={"log_dir": str(tmp_path / "big")},
                    chips=8,  # no pool has 8-chip slices
                )
            assert ei.value.code == 409
            assert "cannot fit this fleet" in ei.value.message
        finally:
            d.close()
            d.runner.close()

    def test_queue_endpoint_without_fleet(self, tmp_path, monkeypatch):
        d = make_daemon(tmp_path, monkeypatch)
        try:
            client = ControlClient(d.addr, d.root_token)
            assert client.queue() == {"enabled": False}
        finally:
            d.close()
            d.runner.close()


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------

MASKED = {"time_usec", "trace_id", "accelerator"}


def masked(doc):
    """Journal records and snapshots with wall clocks, trace ids and the
    pools' generation names masked."""
    if isinstance(doc, dict):
        return {k: (f"<{k}>" if k in MASKED else masked(v)) for k, v in doc.items()}
    if isinstance(doc, (list, tuple)):
        return [masked(v) for v in doc]
    return doc


def drive_fleet(fleet_mod, spec: str, seed: int, state_dir: str, steps: int = 80) -> dict:
    """One seeded stream of synthetic gangs and terminal events through a
    ``FleetScheduler`` of ``fleet_mod`` (the port's or the JAX package's):
    every reply, snapshot and market count, the executor's calls and the
    journal."""
    clock = [0.0]
    fs = fleet_mod.FleetScheduler(
        fleet_mod.FleetModel.from_spec(spec),
        state_dir=state_dir,
        quotas={"capped": 6},
        clock=lambda: clock[0],
    )
    ex = FakeExec()
    fs.bind(ex)
    rng = np.random.default_rng(seed)
    log = []
    for _ in range(steps):
        clock[0] += float(rng.integers(1, 5))
        handles = sorted(fs.running_handles())
        if handles and rng.random() < 0.4:
            handle = handles[int(rng.integers(len(handles)))]
            state = ["SUCCEEDED", "FAILED", "CANCELLED"][int(rng.integers(3))]
            fs.on_event(terminal_event(handle.rsplit("/", 1)[1], state))
            log.append(("terminal", handle, state))
        else:
            elastic = bool(rng.integers(2))
            replicas = int(rng.integers(1, 5))
            req = fleet_mod.GangRequest(
                job="",
                tenant=["research", "prod", "capped"][int(rng.integers(3))],
                klass=fleet_mod.PRIORITY_CLASSES[int(rng.integers(4))],
                replicas=replicas,
                chips_per_replica=int(rng.integers(1, 3)),
                elastic=elastic,
                mesh="fsdp=-1" if elastic else "",
                # a floor above 1 can trip the JAX copy's grow-back fault
                # (test_growback_below_the_floor)
                min_replicas=1,
            )
            log.append(("submit", fs.submit(req, {"scheduler": "local"})))
        log.append(("snapshot", masked(fs.queue_snapshot())))
        log.append(("market", fs.reshapes, fs.kills, fs.grows))
    return {"log": log, "calls": ex.calls, "journal": masked(list(fs.journal.entries())),
            "ledgers": {j: [masked(e) for e in fs.ledger(j).entries()]
                        for j in sorted({c[0] for c in ex.calls if c[0] != "cancel"})}}


class TestJaxParity:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_schedulers_decide_and_journal_alike(self, tmp_path, seed):
        import torchx_tpu.fleet as jax_fleet
        import torchx_tpu_torch.fleet as port_fleet

        port = drive_fleet(port_fleet, "sim:h100-2x4,big:h100-4x2", seed, str(tmp_path / "port"))
        jax_ = drive_fleet(jax_fleet, "sim:v5e-2x4,big:v5p-4x2", seed, str(tmp_path / "jax"))
        assert port == jax_
        # the stream exercised the market, not placement alone
        kinds = {e["kind"] for e in port["journal"]}
        assert {"submit", "place", "terminal"} <= kinds
        assert any(m[1] or m[2] for m in (e for e in port["log"] if e[0] == "market"))

    def test_models_and_placements_agree(self):
        import torchx_tpu.fleet as jax_fleet

        rng = np.random.default_rng(7)
        for _ in range(50):
            p = FleetModel.from_spec("a:h100-2x3,b:h100-8x2,c:h100-1x4")
            j = jax_fleet.FleetModel.from_spec("a:v5e-2x3,b:v5p-8x2,c:v5e-1x4")
            for uid in [u.uid for u in p.units() if rng.random() < 0.3]:
                p.assign([uid], "other")
                j.assign([uid], "other")
            g = dict(job="g", tenant="t", replicas=int(rng.integers(1, 6)),
                     chips_per_replica=int([1, 2, 4, 8][int(rng.integers(4))]))
            dp = plan_placement(GangRequest(**g), p)
            dj = jax_fleet.plan_placement(jax_fleet.GangRequest(**g), j)
            assert [u.uid for u in dp.units] == [u.uid for u in dj.units]
            assert dp.infeasible == dj.infeasible
            assert masked(p.snapshot()) == masked(j.snapshot())

    def test_growback_below_the_floor(self, tmp_path):
        """A fault of the JAX copy, not copied (ROADMAP queue 3): an elastic
        gang shrunk by fewer replicas than its ``min_replicas`` makes the
        JAX grow-back pass build a ``GangRequest`` whose floor exceeds its
        size, and the scheduling loop raises; the port grows it back."""
        import torchx_tpu.fleet as jax_fleet
        import torchx_tpu_torch.fleet as port_fleet

        def run(fleet_mod, spec, state_dir):
            fs = fleet_mod.FleetScheduler(fleet_mod.FleetModel.from_spec(spec),
                                          state_dir=state_dir)
            ex = FakeExec()
            fs.bind(ex)
            fs.submit(fleet_mod.GangRequest(job="", tenant="r", replicas=4, elastic=True,
                                            mesh="fsdp=-1", min_replicas=3),
                      {"scheduler": "local"})
            fs.submit(fleet_mod.GangRequest(job="", tenant="p", klass="serve", replicas=1),
                      {"scheduler": "local"})
            return fs

        with pytest.raises(ValueError, match="min_replicas must be in"):
            run(jax_fleet, "sim:v5e-1x4", str(tmp_path / "jax"))
        fs = run(port_fleet, "sim:h100-1x4", str(tmp_path / "port"))
        assert fs.reshapes == 1 and fs.grows == 0
        fs.on_event(terminal_event("app-3"))
        assert fs.grows == 1 and fs.job("fj-0001").cur_replicas == 4
