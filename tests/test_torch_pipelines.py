"""The port's pipelines (``torchx_tpu_torch.pipelines``) and the serve
pool's rollout hooks held to the JAX package's own cases: every case of
``tests/test_pipelines.py`` but ``TestPromotionScrapeRule`` (3, the
analyzer's TPX603, ROADMAP queue 1 item 2.8), run against the copy: the
DAG model, the eval app's digest chain, the router's rollout seams (drain
exclusion, canary weights, in-flight counts), the serve pool's zero-drop
per-replica rollout, the promotion controller's gates, the engine end to
end on the real local scheduler behind the port's control daemon, and the
deprecation shims. With them ``tests/test_tpu_vm_pipelines.py``'s
``TestPipelineModel``, ``TestLocalPipelineRun`` and ``TestKfpAdapter`` (its
pipeline built here from the port's components, the train stage on two
H100 hosts, ``--gpu h100-16``, in place of ``--tpu v5p-32``), and
``tests/test_telemetry.py``'s ``TestStitchFleetJob``, ``TestGentleMarket``
and ``TestDaemonTelemetryPlane`` (its ``tpx top`` frame waits for
``cmd_top``, item 2.8, as ``TestTopSnapshot`` does).

Added: parity with the JAX package on the same inputs (``TestJaxParity``:
both ``PromotionController``s decide alike on one seeded score and burn
series, both ``PipelineEngine``s drive the same ``PipelineSpec``s through
the same stage transitions and gates with fake executors and write the
same journal, clocks apart, and both routers and pools roll out alike).

The port's lint gate raises until the analyzer is ported, so an autouse
fixture sets ``TPX_NO_LINT=1``; every case keeps the local scheduler's
registry under ``tmp_path``, sees a card-less host, and starts with the
port's breakers and fault plan reset."""

import hashlib
import http.server
import json
import os
import threading
import time
import types

import numpy as np
import pytest

from torchx_tpu_torch import settings
from torchx_tpu_torch.control.client import ControlClient, ControlClientError
from torchx_tpu_torch.control.daemon import ControlDaemon
from torchx_tpu_torch.fleet import FleetModel, FleetScheduler, GangRequest
from torchx_tpu_torch.obs import stitch
from torchx_tpu_torch.obs.telemetry import parse_exposition
from torchx_tpu_torch.pipelines import Pipeline, topo_order
from torchx_tpu_torch.pipelines.dag import (
    Artifact,
    PipelineSpec,
    PipelineStage,
    checkpoint_artifact,
    resolve_args,
    score_artifact,
)
from torchx_tpu_torch.pipelines.legacy import pipeline_to_workflow, run_pipeline
from torchx_tpu_torch.pipelines.promote import PROMOTED, ROLLED_BACK, PromotionController
from torchx_tpu_torch.resilience import call as resilience_call
from torchx_tpu_torch.resilience import faults as resilience_faults
from torchx_tpu_torch.runner.api import get_runner
from torchx_tpu_torch.schedulers import local_scheduler as lsched
from torchx_tpu_torch.serve.pool import LeastLoadedRouter, ReplicaStatus
from torchx_tpu_torch.specs.api import AppDef, AppState, Role
from torch_threads import xdist_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _no_lint_own_registry(tmp_path, monkeypatch):
    """The lint gate is bypassed (it raises until ROADMAP queue 1 item 2.8),
    the local scheduler's registry lives in ``tmp_path``, the host has no
    card, the replicas import the repo's packages, and the port's breakers
    and fault plan start clean."""
    monkeypatch.setenv(settings.ENV_TPX_NO_LINT, "1")
    monkeypatch.setenv("PYTHONPATH", REPO)
    monkeypatch.setattr(lsched, "_registry_path", lambda: str(tmp_path / "registry"))
    monkeypatch.delenv(settings.ENV_CUDA_VISIBLE_DEVICES, raising=False)
    monkeypatch.setattr(lsched, "driver_gpu_count", lambda: 0)
    resilience_call.reset_breakers()
    resilience_faults.reset()


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def write_checkpoint(ckpt_dir: str, payload: bytes = b"weights-v1") -> str:
    """A minimal finalized checkpoint: step-1 payload + MANIFEST.json with
    the writer's sha256 relpath+bytes digest. Returns the digest."""
    step_dir = os.path.join(ckpt_dir, "1")
    os.makedirs(step_dir, exist_ok=True)
    fp = os.path.join(step_dir, "w.bin")
    with open(fp, "wb") as f:
        f.write(payload)
    h = hashlib.sha256()
    h.update(os.path.relpath(fp, step_dir).encode())
    h.update(payload)
    digest = h.hexdigest()
    with open(os.path.join(ckpt_dir, "MANIFEST.json"), "w") as f:
        json.dump({"latest_step": 1, "steps": {"1": {"digest": digest}}}, f)
    return digest


def statuses(n: int, healthy=None) -> list:
    healthy = set(range(n)) if healthy is None else set(healthy)
    return [
        ReplicaStatus(replica_id=i, url=f"http://x:{i}", healthy=i in healthy)
        for i in range(n)
    ]


class FakePool:
    """The promotion controller's pool contract, recording every roll."""

    def __init__(self, replicas: int = 4, fail_on=(), block_on=None):
        self.replicas = replicas
        self.router = LeastLoadedRouter()
        self.router.update(statuses(replicas))
        self.rolls: list = []  # (replica_id, ckpt)
        self._fail_on = set(fail_on)
        self._block_on = block_on  # (replica_id, threading.Event)

    def rollout_replica(self, replica_id: int, ckpt: str, **kw) -> bool:
        if self._block_on and replica_id == self._block_on[0]:
            self._block_on[1].wait()
        self.rolls.append((replica_id, ckpt))
        return replica_id not in self._fail_on


# ---------------------------------------------------------------------------
# DAG model
# ---------------------------------------------------------------------------


class TestDagModel:
    def spec(self):
        return PipelineSpec(
            name="p",
            stages=[
                PipelineStage(name="train", kind="train", component="utils.python"),
                PipelineStage(
                    name="eval",
                    kind="eval",
                    component="utils.python",
                    depends_on=["train"],
                    score_file="/tmp/s.json",
                ),
                PipelineStage(
                    name="promote", kind="promote", depends_on=["eval"]
                ),
            ],
        )

    def test_validate_accepts_well_formed(self):
        self.spec().validate()

    def test_generations_are_topological(self):
        gens = self.spec().generations()
        assert [[s.name for s in g] for g in gens] == [
            ["train"],
            ["eval"],
            ["promote"],
        ]

    def test_default_priorities_by_kind(self):
        spec = self.spec()
        assert spec.stage("train").priority == "batch"
        assert spec.stage("eval").priority == "interactive"
        assert spec.stage("promote").priority == "serve"

    def test_rejects_bad_kind(self):
        with pytest.raises(ValueError, match="kind"):
            PipelineStage(name="x", kind="deploy")

    def test_eval_requires_score_file(self):
        with pytest.raises(ValueError, match="score_file"):
            PipelineStage(name="e", kind="eval")

    def test_rejects_duplicate_names(self):
        spec = self.spec()
        spec.stages.append(PipelineStage(name="train", kind="train"))
        with pytest.raises(ValueError, match="duplicate"):
            spec.validate()

    def test_rejects_unknown_dependency(self):
        spec = self.spec()
        spec.stages[1].depends_on = ["nope"]
        with pytest.raises(ValueError, match="unknown"):
            spec.validate()

    def test_rejects_cycle(self):
        spec = self.spec()
        spec.stages[0].depends_on = ["promote"]
        with pytest.raises(ValueError, match="cycle"):
            spec.validate()

    def test_round_trips_through_dict(self):
        spec = self.spec()
        again = PipelineSpec.from_dict(spec.to_dict())
        assert again.to_dict() == spec.to_dict()

    def test_resolve_args_substitutes_artifact_fields(self):
        arts = {
            "train": Artifact(kind="checkpoint", path="/c", digest="abc", step=7)
        }
        out = resolve_args(
            ["--ckpt", "{train.path}", "--expect", "{train.digest}@{train.step}"],
            arts,
        )
        assert out == ["--ckpt", "/c", "--expect", "abc@7"]

    def test_resolve_args_rejects_dangling_reference(self):
        with pytest.raises(KeyError, match="eval"):
            resolve_args(["{eval.score}"], {})

    def test_checkpoint_artifact_reads_manifest(self, tmp_path):
        digest = write_checkpoint(str(tmp_path))
        art = checkpoint_artifact(str(tmp_path))
        assert (art.kind, art.step, art.digest) == ("checkpoint", 1, digest)

    def test_checkpoint_artifact_requires_manifest(self, tmp_path):
        with pytest.raises(ValueError, match="manifest"):
            checkpoint_artifact(str(tmp_path))

    def test_checkpoint_artifact_requires_finalized_step(self, tmp_path):
        (tmp_path / "MANIFEST.json").write_text('{"steps": {}}')
        with pytest.raises(ValueError, match="finalized"):
            checkpoint_artifact(str(tmp_path))

    def test_score_artifact_requires_score(self, tmp_path):
        f = tmp_path / "s.json"
        f.write_text('{"ckpt": "/c"}')
        with pytest.raises(ValueError, match="score"):
            score_artifact(str(f))
        f.write_text('{"score": 0.25, "step": 3}')
        art = score_artifact(str(f))
        assert (art.kind, art.score, art.step) == ("score", 0.25, 3)


# ---------------------------------------------------------------------------
# eval app: digest re-verification
# ---------------------------------------------------------------------------


class TestEvalMain:
    def test_scores_a_verified_checkpoint(self, tmp_path):
        from torchx_tpu_torch.apps.eval_main import main

        write_checkpoint(str(tmp_path / "ckpt"))
        out = str(tmp_path / "score.json")
        rc = main(["--ckpt", str(tmp_path / "ckpt"), "--out", out, "--score", "0.9"])
        assert rc == 0
        doc = json.load(open(out))
        assert doc["score"] == 0.9
        assert doc["step"] == 1
        assert doc["digest"]

    def test_rejects_tampered_payload(self, tmp_path, capsys):
        from torchx_tpu_torch.apps.eval_main import main

        write_checkpoint(str(tmp_path / "ckpt"))
        # corrupt the payload after the manifest recorded its digest
        with open(tmp_path / "ckpt" / "1" / "w.bin", "wb") as f:
            f.write(b"tampered")
        out = str(tmp_path / "score.json")
        rc = main(["--ckpt", str(tmp_path / "ckpt"), "--out", out])
        assert rc == 1
        assert not os.path.exists(out)
        assert "digest mismatch" in capsys.readouterr().err

    def test_digest_derived_score_is_deterministic(self, tmp_path):
        from torchx_tpu_torch.apps.eval_main import main

        write_checkpoint(str(tmp_path / "ckpt"))
        a, b = str(tmp_path / "a.json"), str(tmp_path / "b.json")
        assert main(["--ckpt", str(tmp_path / "ckpt"), "--out", a]) == 0
        assert main(["--ckpt", str(tmp_path / "ckpt"), "--out", b]) == 0
        assert json.load(open(a))["score"] == json.load(open(b))["score"]


# ---------------------------------------------------------------------------
# router: drain exclusion + canary weights
# ---------------------------------------------------------------------------


class TestRouterRollout:
    def test_draining_replica_leaves_split_immediately(self):
        r = LeastLoadedRouter()
        r.update(statuses(2))
        r.mark_draining(0)
        # no probe sweep between mark and pick: 0 must already be gone
        for _ in range(5):
            assert r.pick().replica_id == 1
        r.clear_draining(0)
        # readmitted and now the least loaded: it takes the next pick
        assert r.pick().replica_id == 0

    def test_drain_mark_survives_probe_update(self):
        r = LeastLoadedRouter()
        r.update(statuses(2))
        r.mark_draining(0)
        r.update(statuses(2))  # probe sweep rebuilds the table
        assert r.pick().replica_id == 1

    def test_weight_attracts_traffic(self):
        r = LeastLoadedRouter()
        r.update(statuses(2))
        r.set_weight(1, 4.0)
        # equal load: ties break toward the lower id unless weighted
        picks = [r.pick().replica_id for _ in range(4)]
        assert picks.count(1) > picks.count(0)

    def test_weight_scales_negative_scores_toward_canary(self):
        # a cache bonus can push load negative; weight must still attract
        r = LeastLoadedRouter(cache_bonus=3.0)
        summary = ("d0",)
        r.update(
            [
                ReplicaStatus(
                    replica_id=i,
                    url=f"http://x:{i}",
                    healthy=True,
                    prefix_summary=summary,
                    block_size=4,
                )
                for i in range(2)
            ]
        )
        r.set_weight(1, 4.0)
        from torchx_tpu_torch.serve.prefix_cache import prefix_chain

        tokens = list(range(4))
        assert prefix_chain(tokens, 4)  # sanity: at least one block
        # patch the summaries to actually match the prompt's first chain digest
        chain = prefix_chain(tokens, 4)
        r.update(
            [
                ReplicaStatus(
                    replica_id=i,
                    url=f"http://x:{i}",
                    healthy=True,
                    prefix_summary=(chain[0],),
                    block_size=4,
                )
                for i in range(2)
            ]
        )
        r.set_weight(1, 4.0)
        assert r.pick(tokens).replica_id == 1

    def test_inflight_counts_route_and_record(self):
        r = LeastLoadedRouter()
        r.update(statuses(1))
        assert r.inflight(0) == 0
        r.pick()
        r.pick()
        assert r.inflight(0) == 2
        r.record(0, 0.01)
        assert r.inflight(0) == 1


# ---------------------------------------------------------------------------
# serve pool: zero-drop per-replica rollout
# ---------------------------------------------------------------------------


class TestServePoolRollout:
    def make_pool(self, probed, healthy=True):
        from torchx_tpu_torch.serve.pool import ServePool
        from torchx_tpu_torch.specs.api import AppDef, Role

        app = AppDef(
            name="srv",
            roles=[
                Role(name="server", image="i", entrypoint="x", num_replicas=2)
            ],
        )
        router = LeastLoadedRouter()
        router.update(statuses(2))
        clock = {"t": 0.0}

        def sleep(dt):
            clock["t"] += dt
            # in-flight requests complete while the rollout waits: this is
            # the drain the seam must observe before the health check
            if router.inflight(0) > 0:
                router.record(0, 0.01)

        def probe(rid, url):
            # the replica's in-flight count when the health check reaches it
            probed.append((rid, router.inflight(rid)))
            return ReplicaStatus(replica_id=rid, url=url, healthy=healthy)

        pool = ServePool(
            runner=object(),
            app=app,
            router=router,
            probe=probe,
            clock=lambda: clock["t"],
            sleep=sleep,
        )
        return pool, router

    def test_rollout_waits_for_inflight_then_health_confirms(self):
        probed = []
        pool, router = self.make_pool(probed)
        # two requests in flight to replica 0 (replica 1 briefly unhealthy
        # so the least-loaded split can't spread them)
        router.update(statuses(2, healthy=[0]))
        router.pick(), router.pick()
        router.update(statuses(2))
        assert router.inflight(0) == 2
        assert pool.rollout_replica(0, "/new/ckpt") is True
        # the health check came with ZERO requests still in flight (no drops)
        assert probed == [(0, 0)]
        # the replica rejoined the split after health-confirm
        assert 0 in {router.pick().replica_id for _ in range(4)}

    def test_rollout_fails_on_drain_timeout(self):
        probed = []
        pool, router = self.make_pool(probed)
        # a request that never records back
        router._inflight[0] = 1
        pool._sleep = lambda dt: setattr(
            pool, "_now", getattr(pool, "_now", 0.0) + dt
        )
        pool._clock = lambda: getattr(pool, "_now", 0.0)
        assert pool.rollout_replica(0, "/new", drain_timeout_s=0.2) is False
        assert probed == []
        # the drain mark was cleared even on failure
        assert 0 in {router.pick().replica_id for _ in range(4)}

    def test_rollout_fails_when_the_replica_stays_unhealthy(self):
        probed = []
        pool, router = self.make_pool(probed, healthy=False)
        assert pool.rollout_replica(0, "/new", health_timeout_s=0.2) is False
        assert probed and {rid for rid, _ in probed} == {0}
        # out of the split while it drained, back in after the failure
        router.update(statuses(2))
        assert 0 in {router.pick().replica_id for _ in range(4)}


# ---------------------------------------------------------------------------
# promotion controller (unit, fake pool)
# ---------------------------------------------------------------------------


class TestPromotionController:
    def candidate(self):
        return Artifact(kind="checkpoint", path="/new", digest="d", step=5)

    def test_promotes_canary_then_rest(self):
        pool = FakePool(replicas=4)
        events = []
        c = PromotionController(
            pool,
            canary_fraction=0.5,
            journal=lambda e, **f: events.append((e, f)),
        )
        assert c.run(self.candidate(), score=0.9, baseline_score=0.5) == PROMOTED
        assert [r for r, _ in pool.rolls] == [0, 1, 2, 3]
        kinds = [e for e, _ in events]
        assert kinds[0] == "canary_start"
        assert ("gate", True) in [
            (e, f.get("passed")) for e, f in events if e == "gate"
        ]
        assert kinds[-1] == "promoted"

    def test_eval_regression_rolls_canary_back(self):
        pool = FakePool(replicas=4)
        events = []
        c = PromotionController(
            pool,
            canary_fraction=0.5,
            journal=lambda e, **f: events.append((e, f)),
        )
        out = c.run(
            self.candidate(), score=0.2, baseline_score=0.9, incumbent_ckpt="/old"
        )
        assert out == ROLLED_BACK
        # canaries 0,1 rolled forward, then restored to the incumbent;
        # replicas 2,3 never touched
        assert pool.rolls == [
            (0, "/new"),
            (1, "/new"),
            (0, "/old"),
            (1, "/old"),
        ]
        rb = next(f for e, f in events if e == "rollback")
        assert rb["reason"] == "eval_regression"
        assert rb["incumbent"] == "/old"

    def test_slo_burn_rolls_canary_back(self):
        pool = FakePool(replicas=2)
        events = []
        c = PromotionController(
            pool,
            slo_signal=lambda: 2.5,
            burn_threshold=1.0,
            observe_s=0.5,
            canary_fraction=0.5,
            journal=lambda e, **f: events.append((e, f)),
            clock=lambda: 0.0,
            sleep=lambda dt: None,
        )
        out = c.run(self.candidate(), score=0.9, incumbent_ckpt="/old")
        assert out == ROLLED_BACK
        rb = next(f for e, f in events if e == "rollback")
        assert rb["reason"] == "slo_burn"

    def test_resume_skips_already_rolled(self):
        pool = FakePool(replicas=4)
        c = PromotionController(
            pool, canary_fraction=0.5, already_rolled=[0]
        )
        assert c.run(self.candidate(), score=0.9) == PROMOTED
        # replica 0 was rolled by the pre-restart attempt: never re-rolled
        assert [r for r, _ in pool.rolls] == [1, 2, 3]

    def test_failed_rollout_rolls_back(self):
        pool = FakePool(replicas=4, fail_on={1})
        c = PromotionController(pool, canary_fraction=0.5)
        out = c.run(self.candidate(), score=0.9, incumbent_ckpt="/old")
        assert out == ROLLED_BACK
        # only replica 0 completed a forward roll; it alone is restored
        assert pool.rolls[-1] == (0, "/old")

    def test_gate_only_mode_without_pool(self):
        c = PromotionController(None)
        assert c.run(self.candidate(), score=0.9, baseline_score=0.5) == PROMOTED
        assert (
            c.run(self.candidate(), score=0.2, baseline_score=0.9)
            == ROLLED_BACK
        )

    def test_weights_restored_after_promotion(self):
        pool = FakePool(replicas=2)
        c = PromotionController(pool, canary_fraction=0.5, canary_weight=3.0)
        assert c.run(self.candidate(), score=0.9) == PROMOTED
        assert pool.router._weights == {}


# ---------------------------------------------------------------------------
# engine end-to-end on the real local scheduler
# ---------------------------------------------------------------------------


def _train_code(ckpt: str) -> str:
    return (
        "import hashlib,json,os\n"
        f"ckpt={ckpt!r}\n"
        "p=os.path.join(ckpt,'1'); os.makedirs(p,exist_ok=True)\n"
        "fp=os.path.join(p,'w.bin')\n"
        "open(fp,'wb').write(b'weights-'+os.path.basename(ckpt).encode())\n"
        "h=hashlib.sha256()\n"
        "h.update(os.path.relpath(fp,p).encode())\n"
        "h.update(open(fp,'rb').read())\n"
        "json.dump({'latest_step':1,'steps':{'1':{'digest':h.hexdigest()}}},"
        "open(os.path.join(ckpt,'MANIFEST.json'),'w'))\n"
    )


def _spec(base: str, tag: str, score: float, **promote_kw) -> dict:
    ckpt = os.path.join(base, f"ckpt-{tag}")
    score_file = os.path.join(base, f"score-{tag}.json")
    logs = os.path.join(base, "logs")
    stages = [
        {
            "name": "train",
            "kind": "train",
            "component": "utils.python",
            "args": ["-c", _train_code(ckpt)],
            "ckpt_dir": ckpt,
            "cfg": {"log_dir": logs},
        },
        {
            "name": "eval",
            "kind": "eval",
            "component": "utils.python",
            "args": [
                "-m",
                "torchx_tpu_torch.apps.eval_main",
                "--",
                "--ckpt",
                "{train.path}",
                "--out",
                score_file,
                "--score",
                str(score),
            ],
            "depends_on": ["train"],
            "score_file": score_file,
            "threshold": 0.1,
            "baseline": "incumbent",
            "cfg": {"log_dir": logs},
        },
        {
            "name": "promote",
            "kind": "promote",
            "depends_on": ["eval"],
            "observe_s": promote_kw.pop("observe_s", 0.0),
            **promote_kw,
        },
    ]
    return {"name": f"pl-{tag}", "stages": stages}


def _wait_terminal(daemon, pid: str, timeout: float = 60.0) -> dict:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        doc = daemon.pipelines.status(pid)
        if doc["state"] in (
            "PROMOTED",
            "SUCCEEDED",
            "FAILED",
            "ROLLED_BACK",
            "CANCELLED",
        ):
            return doc
        time.sleep(0.05)
    raise AssertionError(f"pipeline {pid} never terminal: {doc}")


def _journal_entries(state_dir: str) -> list:
    out = []
    with open(os.path.join(state_dir, "pipelines.jsonl")) as f:
        for line in f:
            out.append(json.loads(line))
    return out


@pytest.fixture
def daemon_factory(tmp_path, monkeypatch):
    """Builds ControlDaemons over one shared state_dir (restart tests
    construct a second one after closing the first)."""
    from torchx_tpu_torch.control.daemon import ControlDaemon
    from torchx_tpu_torch.runner.api import get_runner

    monkeypatch.setenv("TPX_WATCH_INTERVAL", "0.05")
    made = []

    def make(**kw):
        d = ControlDaemon(
            runner=get_runner(f"pl-test-{len(made)}"),
            state_dir=str(tmp_path / "control"),
            tenant_cap=8,
            telemetry=False,
            **kw,
        )
        made.append(d)
        return d

    yield make
    for d in made:
        d.close()


class TestPipelineEndToEnd:
    def test_happy_path_promotes_over_http(self, tmp_path, daemon_factory):
        from torchx_tpu_torch.control.client import ControlClient

        daemon = daemon_factory().start()
        client = ControlClient(daemon.addr, daemon.root_token)
        reply = client.pipeline_submit(_spec(str(tmp_path), "v1", 0.9))
        pid = reply["pipeline"]
        doc = _wait_terminal(daemon, pid)
        assert doc["state"] == "PROMOTED", doc
        states = {s["name"]: s["state"] for s in doc["stages"]}
        assert states == {
            "train": "SUCCEEDED",
            "eval": "SUCCEEDED",
            "promote": "SUCCEEDED",
        }
        # the artifact edge carried the digest train published
        ckpt_art = next(
            s["artifact"] for s in doc["stages"] if s["name"] == "train"
        )
        assert ckpt_art["digest"]
        assert doc["incumbent"]["digest"] == ckpt_art["digest"]
        assert doc["incumbent"]["score"] == 0.9
        # the same record over the HTTP list + status verbs
        listing = client.pipeline_status()
        assert [p["pipeline"] for p in listing["pipelines"]] == [pid]
        # every decision journaled
        kinds = {e["kind"] for e in _journal_entries(daemon.state_dir)}
        assert {
            "submit",
            "stage_submit",
            "stage_done",
            "gate",
            "promote_step",
            "pipeline_state",
            "incumbent",
        } <= kinds

    def test_eval_threshold_gate_fails_pipeline(self, tmp_path, daemon_factory):
        daemon = daemon_factory()
        spec = _spec(str(tmp_path), "bad", 0.05)  # below threshold 0.1
        pid = daemon.pipelines.submit(
            PipelineSpec.from_dict(spec), tenant="root"
        )
        doc = _wait_terminal(daemon, pid)
        assert doc["state"] == "FAILED"
        states = {s["name"]: s["state"] for s in doc["stages"]}
        assert states["eval"] == "FAILED"
        assert states["promote"] == "PENDING"  # never started
        gates = [
            e
            for e in _journal_entries(daemon.state_dir)
            if e["kind"] == "gate"
        ]
        assert gates and gates[-1]["passed"] is False

    def test_eval_regression_rolls_canary_back(self, tmp_path, daemon_factory):
        """The acceptance scenario: an induced eval-score regression on
        the candidate auto-rolls the canary back onto the incumbent
        checkpoint, with the rollback decision journaled."""
        pools = []

        def pool_provider(stage):
            pool = FakePool(replicas=4)
            pools.append(pool)
            return pool

        daemon = daemon_factory(pipeline_pool_provider=pool_provider)
        # pipeline 1 promotes at 0.9 and becomes the incumbent
        pid1 = daemon.pipelines.submit(
            PipelineSpec.from_dict(
                _spec(str(tmp_path), "v1", 0.9, canary_fraction=0.5)
            ),
            tenant="root",
        )
        assert _wait_terminal(daemon, pid1)["state"] == "PROMOTED"
        incumbent_ckpt = daemon.pipelines.incumbent["ckpt"]
        # pipeline 2 regresses to 0.3 < incumbent 0.9 -> auto-rollback
        pid2 = daemon.pipelines.submit(
            PipelineSpec.from_dict(
                _spec(str(tmp_path), "v2", 0.3, canary_fraction=0.5)
            ),
            tenant="root",
        )
        doc = _wait_terminal(daemon, pid2)
        assert doc["state"] == "ROLLED_BACK", doc
        states = {s["name"]: s["state"] for s in doc["stages"]}
        assert states["promote"] == "ROLLED_BACK"
        # the canary cohort (replicas 0,1 of 4 at fraction 0.5) went
        # forward onto v2, then back onto the incumbent's checkpoint
        pool2 = pools[-1]
        v2_ckpt = os.path.join(str(tmp_path), "ckpt-v2")
        assert pool2.rolls == [
            (0, v2_ckpt),
            (1, v2_ckpt),
            (0, incumbent_ckpt),
            (1, incumbent_ckpt),
        ]
        # the rollback decision is durably journaled with its reason
        rollbacks = [
            e
            for e in _journal_entries(daemon.state_dir)
            if e["kind"] == "promote_step" and e.get("event") == "rollback"
        ]
        assert rollbacks and rollbacks[-1]["reason"] == "eval_regression"
        assert rollbacks[-1]["incumbent"] == incumbent_ckpt
        # the incumbent is unchanged: v1 still owns the pool
        assert daemon.pipelines.incumbent["ckpt"] == incumbent_ckpt

    def test_slo_burn_rolls_canary_back(self, tmp_path, daemon_factory):
        """The other acceptance gate: an induced SLO burn at/over the
        threshold during the canary window rolls back."""
        pools = []

        def pool_provider(stage):
            pool = FakePool(replicas=2)
            pools.append(pool)
            return pool

        daemon = daemon_factory(pipeline_pool_provider=pool_provider)
        daemon.pipelines.set_slo_signal(lambda: 2.0)  # burning hard
        pid = daemon.pipelines.submit(
            PipelineSpec.from_dict(
                _spec(
                    str(tmp_path),
                    "v1",
                    0.9,
                    canary_fraction=0.5,
                    burn_threshold=1.0,
                    observe_s=0.2,
                )
            ),
            tenant="root",
        )
        doc = _wait_terminal(daemon, pid)
        assert doc["state"] == "ROLLED_BACK", doc
        rollbacks = [
            e
            for e in _journal_entries(daemon.state_dir)
            if e["kind"] == "promote_step" and e.get("event") == "rollback"
        ]
        assert rollbacks and rollbacks[-1]["reason"] == "slo_burn"
        assert daemon.pipelines.incumbent is None  # nothing ever promoted

    def test_restart_mid_canary_resumes_pipeline(
        self, tmp_path, daemon_factory
    ):
        """Kill the daemon mid-canary: the restarted daemon rehydrates the
        pipeline from its journal and resumes the canary from the exact
        replica it stopped at — completed stages are not re-run, rolled
        replicas are not re-rolled."""
        release = threading.Event()
        pool1 = FakePool(replicas=4, block_on=(1, release))

        daemon1 = daemon_factory(pipeline_pool_provider=lambda s: pool1)
        pid = daemon1.pipelines.submit(
            PipelineSpec.from_dict(
                _spec(str(tmp_path), "v1", 0.9, canary_fraction=0.5)
            ),
            tenant="root",
        )
        # wait until replica 0 is rolled and journaled, replica 1 blocked
        deadline = time.monotonic() + 60
        while not pool1.rolls:
            assert time.monotonic() < deadline, "canary never started"
            time.sleep(0.02)
        assert pool1.rolls[0][0] == 0
        # kill the daemon mid-canary (the promote thread is parked on
        # replica 1; close() gives up on joining it after its timeout)
        daemon1.close()
        mid = _journal_entries(daemon1.state_dir)
        rolled = [
            e
            for e in mid
            if e["kind"] == "promote_step"
            and e.get("event") == "replica_rolled"
        ]
        assert [e["replica"] for e in rolled] == [0]

        pool2 = FakePool(replicas=4)
        daemon2 = daemon_factory(pipeline_pool_provider=lambda s: pool2)
        doc = _wait_terminal(daemon2, pid)
        assert doc["state"] == "PROMOTED", doc
        # replica 0 (already rolled pre-restart) was NOT re-rolled; the
        # resumed canary started at replica 1 and promotion finished 2,3
        assert [r for r, _ in pool2.rolls] == [1, 2, 3]
        # completed train/eval stages were not re-submitted: exactly one
        # stage_submit journal entry per app stage across both daemons
        submits = [
            e
            for e in _journal_entries(daemon2.state_dir)
            if e["kind"] == "stage_submit" and not e.get("promote")
        ]
        assert sorted(e["stage"] for e in submits) == ["eval", "train"]
        # the resumed attempt journaled what it inherited
        starts = [
            e
            for e in _journal_entries(daemon2.state_dir)
            if e["kind"] == "promote_step"
            and e.get("event") == "canary_start"
        ]
        assert starts[-1]["resumed"] == [0]
        release.set()  # unpark the orphaned thread

    def test_cancel_over_http(self, tmp_path, daemon_factory):
        from torchx_tpu_torch.control.client import ControlClient

        daemon = daemon_factory().start()
        client = ControlClient(daemon.addr, daemon.root_token)
        spec = _spec(str(tmp_path), "v1", 0.9)
        # a train stage that runs long enough to cancel
        spec["stages"][0]["args"] = ["-c", "import time; time.sleep(60)"]
        pid = client.pipeline_submit(spec)["pipeline"]
        doc = client.pipeline_cancel(pid)
        assert doc["state"] == "CANCELLED"
        assert daemon.pipelines.status(pid)["state"] == "CANCELLED"

    def test_unknown_pipeline_is_404_over_http(self, daemon_factory):
        from torchx_tpu_torch.control.client import ControlClient, ControlClientError

        daemon = daemon_factory().start()
        client = ControlClient(daemon.addr, daemon.root_token)
        with pytest.raises(ControlClientError) as ei:
            client.pipeline_status("pl_999")
        assert ei.value.code == 404
        with pytest.raises(ControlClientError) as ei:
            client.pipeline_submit({"name": "x", "stages": []})
        assert ei.value.code == 400


# ---------------------------------------------------------------------------
# deprecation shims
# ---------------------------------------------------------------------------


class TestLegacyShims:
    def test_kfp_shim_warns_and_reexports(self):
        import importlib
        import warnings

        import torchx_tpu_torch.pipelines.kfp as kfp

        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            importlib.reload(kfp)
        assert any(
            issubclass(x.category, UserWarning) and "deprecated" in str(x.message)
            for x in w
        ), [x.category for x in w]
        from torchx_tpu_torch.pipelines.legacy import pipeline_to_workflow

        assert kfp.pipeline_to_workflow is pipeline_to_workflow

    def test_local_runner_shim_warns_and_reexports(self):
        import importlib
        import warnings

        import torchx_tpu_torch.pipelines.local_runner as lr

        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            importlib.reload(lr)
        assert any(
            issubclass(x.category, UserWarning) and "deprecated" in str(x.message)
            for x in w
        ), [x.category for x in w]
        from torchx_tpu_torch.pipelines.legacy import run_pipeline

        assert lr.run_pipeline is run_pipeline

# ---------------------------------------------------------------------------
# the legacy pipeline model and runner (tests/test_tpu_vm_pipelines.py)
# ---------------------------------------------------------------------------


def build_pipeline(workdir: str, gpu=None) -> Pipeline:
    """The JAX example's data -> train -> eval pipeline
    (``examples/pipeline_data_train_eval.py`` ``build_pipeline``) from the
    port's components: ``--gpu`` in place of ``--tpu``."""
    from torchx_tpu_torch.components import dist, utils
    from torchx_tpu_torch.specs.builders import materialize_appdef

    data = materialize_appdef(
        utils.sh,
        ["--", "sh", "-c", f"mkdir -p {workdir} && echo dataset > {workdir}/data.txt"],
    )
    train_args = ["-m", "torchx_tpu_torch.examples.train_llama", "--", "--config", "tiny",
                  "--steps", "2", "--mesh", "fsdp=-1"]
    train_args = ["--gpu", gpu, *train_args] if gpu else ["-j", "1x2", *train_args]
    train = materialize_appdef(dist.spmd, train_args)
    evaluate = materialize_appdef(
        utils.sh, ["--", "sh", "-c", f"test -f {workdir}/data.txt && echo eval-ok"]
    )
    return (
        Pipeline(name="data-train-eval")
        .stage("data", data)
        .stage("train", train, depends_on=["data"])
        .stage("eval", evaluate, depends_on=["train"])
    )


class TestPipelineModel:
    def app(self, name="a"):
        return AppDef(
            name=name, roles=[Role(name="r", image="", entrypoint="true")]
        )

    def test_topo_generations(self):
        p = (
            Pipeline("p")
            .stage("a", self.app())
            .stage("b", self.app(), depends_on=["a"])
            .stage("c", self.app(), depends_on=["a"])
            .stage("d", self.app(), depends_on=["b", "c"])
        )
        gens = topo_order(p)
        names = [[s.name for s in g] for g in gens]
        assert names[0] == ["a"]
        assert sorted(names[1]) == ["b", "c"]
        assert names[2] == ["d"]

    def test_cycle_detected(self):
        p = (
            Pipeline("p")
            .stage("a", self.app(), depends_on=["b"])
            .stage("b", self.app(), depends_on=["a"])
        )
        with pytest.raises(ValueError, match="cycle"):
            topo_order(p)

    def test_unknown_dep(self):
        p = Pipeline("p").stage("a", self.app(), depends_on=["ghost"])
        with pytest.raises(ValueError, match="unknown"):
            topo_order(p)

    def test_duplicate_names(self):
        p = Pipeline("p").stage("a", self.app()).stage("a", self.app())
        with pytest.raises(ValueError, match="duplicate"):
            topo_order(p)


class TestLocalPipelineRun:
    def sh_app(self, name, script):
        return AppDef(
            name=name,
            roles=[Role(name=name, image="", entrypoint="sh", args=["-c", script])],
        )

    def test_three_stage_success(self, tmp_path):
        p = (
            Pipeline("p")
            .stage("data", self.sh_app("data", f"echo d > {tmp_path}/data"))
            .stage(
                "train",
                self.sh_app("train", f"test -f {tmp_path}/data && echo t > {tmp_path}/model"),
                depends_on=["data"],
            )
            .stage(
                "eval",
                self.sh_app("eval", f"test -f {tmp_path}/model"),
                depends_on=["train"],
            )
        )
        with get_runner("pipe-test") as runner:
            run = run_pipeline(
                runner, p, "local", {"log_dir": str(tmp_path / "logs")}, wait_interval=0.1
            )
        assert run.state == AppState.SUCCEEDED
        assert set(run.statuses) == {"data", "train", "eval"}

    def test_fail_fast_cancels_sibling(self, tmp_path):
        p = (
            Pipeline("p")
            .stage("fast-fail", self.sh_app("fastfail", "sleep 0.3; exit 1"))
            .stage("slow", self.sh_app("slow", "sleep 60"))
        )
        import time as _time

        t0 = _time.monotonic()
        with get_runner("pipe-ff") as runner:
            run = run_pipeline(
                runner, p, "local", {"log_dir": str(tmp_path)}, wait_interval=0.1
            )
        assert run.state == AppState.FAILED
        # the 60s sibling must have been cancelled promptly
        assert _time.monotonic() - t0 < 30
        assert run.statuses["slow"].state in (AppState.CANCELLED, AppState.FAILED)

    def test_failure_skips_downstream(self, tmp_path):
        p = (
            Pipeline("p")
            .stage("bad", self.sh_app("bad", "exit 1"))
            .stage("after", self.sh_app("after", "true"), depends_on=["bad"])
        )
        with get_runner("pipe-fail") as runner:
            run = run_pipeline(
                runner, p, "local", {"log_dir": str(tmp_path)}, wait_interval=0.1
            )
        assert run.state == AppState.FAILED
        assert "after" not in run.handles  # never submitted


class TestKfpAdapter:
    def test_workflow_emission(self):
        p = build_pipeline("/tmp/w", gpu="h100-16")
        wf = pipeline_to_workflow(p)
        assert wf["kind"] == "Workflow"
        templates = {t["name"]: t for t in wf["spec"]["templates"]}
        dag_tasks = {t["name"]: t for t in templates["dag"]["dag"]["tasks"]}
        assert dag_tasks["train"]["dependencies"] == ["data"]
        assert dag_tasks["eval"]["dependencies"] == ["train"]
        # a GPU train stage over two hosts becomes a JobSet resource template;
        # the manifest must be a string (Argo CRD contract)
        assert "resource" in templates["train"]
        manifest = templates["train"]["resource"]["manifest"]
        assert isinstance(manifest, str)
        assert json.loads(manifest)["kind"] == "JobSet"
        # single-pod stages are plain container templates
        assert "container" in templates["data"]

# ---------------------------------------------------------------------------
# fleet stitching, the gentle market and the daemon telemetry plane (tests/test_telemetry.py)
# ---------------------------------------------------------------------------


TTFT = "tpx_serve_ttft_seconds"


def ttft_text(le_05: int, inf: int, le_01: int = 0) -> str:
    """A TTFT histogram exposition: ``inf - le_05`` observations breach
    the 500ms p99-ttft threshold."""
    return (
        f"# HELP {TTFT} time to first token\n"
        f"# TYPE {TTFT} histogram\n"
        f'{TTFT}_bucket{{le="0.1"}} {le_01}\n'
        f'{TTFT}_bucket{{le="0.5"}} {le_05}\n'
        f'{TTFT}_bucket{{le="+Inf"}} {inf}\n'
        f"{TTFT}_sum {float(inf)}\n"
        f"{TTFT}_count {inf}\n"
    )


class _MetriczHandler(http.server.BaseHTTPRequestHandler):
    body = "# TYPE up gauge\nup 1\n"

    def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler API
        data = self.body.encode()
        self.send_response(200)
        self.send_header("Content-Type", "text/plain; version=0.0.4")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, *args):  # quiet
        pass


@pytest.fixture
def metricz_server():
    srv = http.server.HTTPServer(("127.0.0.1", 0), _MetriczHandler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()


def fleet_fixture(tmp_path, spec="sim:h100-1x4"):
    class FakeExec:
        def __init__(self):
            self.n = 0
            self.calls = []

        def schedule(self, job, mesh_spec):
            self.n += 1
            self.calls.append((job.req.job, job.cur_replicas, mesh_spec))
            return f"local://fake/app-{self.n}"

        def cancel(self, handle):
            self.calls.append(("cancel", handle))

    clock = [0.0]
    fs = FleetScheduler(
        FleetModel.from_spec(spec),
        state_dir=str(tmp_path),
        clock=lambda: clock[0],
    )
    ex = FakeExec()
    fs.bind(ex)
    return fs, ex, clock


def terminal_event(app_id: str, state: str = "SUCCEEDED"):
    return types.SimpleNamespace(
        scheduler="local",
        app_id=app_id,
        terminal=True,
        state=types.SimpleNamespace(name=state),
    )


class TestStitchFleetJob:
    def test_lifecycle_includes_shrink_and_growback(self, tmp_path):
        fs, ex, _ = fleet_fixture(tmp_path / "fleet")
        fs.submit(
            GangRequest(
                job="batchjob",
                tenant="research",
                klass="batch",
                replicas=4,
                chips_per_replica=1,
                elastic=True,
                mesh="fsdp=-1",
                min_replicas=1,
            ),
            {"scheduler": "local"},
        )
        fs.submit(
            GangRequest(
                job="servejob",
                tenant="prod",
                klass="serve",
                replicas=2,
                chips_per_replica=1,
            ),
            {"scheduler": "local"},
        )
        assert fs.reshapes == 1
        fs.on_event(terminal_event("app-3"))  # serve done -> grow back
        assert fs.grows == 1

        st = stitch.stitch("batchjob")
        assert st is not None
        assert st.trace_id == fs.job("batchjob").recipe["trace_id"]
        spans = []

        def walk(node):
            spans.append(node.span)
            for c in node.children:
                walk(c)

        for r in st.roots:
            walk(r)
        names = [s.name for s in spans]
        assert "fleet.submit" in names and "fleet.place" in names
        directions = [
            s.attrs.get("direction")
            for s in spans
            if s.name == "fleet.reshape"
        ]
        assert sorted(directions) == ["grow", "shrink"]
        assert all(s.attrs.get("fleet_job") == "batchjob" for s in spans)

        # the serve gang owns its own distinct trace
        st2 = stitch.stitch("servejob")
        assert st2 is not None and st2.trace_id != st.trace_id
        names2 = {r.span.name for r in st2.roots}
        assert "fleet.terminal" in names2

    def test_trace_id_survives_rehydration(self, tmp_path):
        fs, _, _ = fleet_fixture(tmp_path / "fleet")
        fs.submit(
            GangRequest(
                job="jobx", tenant="t", klass="batch",
                replicas=1, chips_per_replica=1,
            ),
            {"scheduler": "local"},
        )
        tid = fs.job("jobx").recipe["trace_id"]
        fs2, _, _ = fleet_fixture(tmp_path / "fleet")
        assert fs2.rehydrate() >= 1
        assert fs2.job("jobx").recipe["trace_id"] == tid


class TestGentleMarket:
    def submit_pair(self, fs):
        low = fs.submit(
            GangRequest(
                job="spotjob", tenant="spot", klass="preemptible",
                replicas=2, chips_per_replica=1,
            ),
            {"scheduler": "local"},
        )
        high = fs.submit(
            GangRequest(
                job="devjob", tenant="dev", klass="interactive",
                replicas=2, chips_per_replica=1,
            ),
            {"scheduler": "local"},
        )
        return low, high

    def test_healthy_budgets_defer_checkpoint_kills(self, tmp_path):
        fs, ex, _ = fleet_fixture(tmp_path / "fleet", spec="sim:h100-1x2")
        fs.set_slo_signal(lambda: 0.3)
        low, high = self.submit_pair(fs)
        assert high["status"] == "queued"
        assert fs.kills == 0
        assert fs.job("spotjob").state == "running"
        assert ("cancel", "local://fake/app-1") not in ex.calls

    def test_burning_budget_runs_the_full_market(self, tmp_path):
        fs, ex, _ = fleet_fixture(tmp_path / "fleet", spec="sim:h100-1x2")
        fs.set_slo_signal(lambda: 1.5)
        low, high = self.submit_pair(fs)
        assert high["status"] == "placed"
        assert fs.kills == 1
        assert fs.job("spotjob").state == "queued"

    def test_no_signal_means_no_gating(self, tmp_path):
        fs, ex, _ = fleet_fixture(tmp_path / "fleet", spec="sim:h100-1x2")
        assert fs._gentle_market() is False
        low, high = self.submit_pair(fs)
        assert high["status"] == "placed" and fs.kills == 1

    def test_failing_probe_means_no_gating(self, tmp_path):
        fs, _, _ = fleet_fixture(tmp_path / "fleet", spec="sim:h100-1x2")

        def boom():
            raise RuntimeError("telemetry down")

        fs.set_slo_signal(boom)
        assert fs._gentle_market() is False

    def test_elastic_shrinks_still_run_under_gentle(self, tmp_path):
        fs, _, _ = fleet_fixture(tmp_path / "fleet")
        fs.set_slo_signal(lambda: 0.2)
        fs.submit(
            GangRequest(
                job="batchjob", tenant="r", klass="batch",
                replicas=4, chips_per_replica=1,
                elastic=True, mesh="fsdp=-1", min_replicas=1,
            ),
            {"scheduler": "local"},
        )
        high = fs.submit(
            GangRequest(
                job="servejob", tenant="prod", klass="serve",
                replicas=2, chips_per_replica=1,
            ),
            {"scheduler": "local"},
        )
        assert high["status"] == "placed"
        assert fs.reshapes == 1 and fs.kills == 0



@pytest.fixture
def tel_daemon(tmp_path, monkeypatch):
    monkeypatch.setenv("TPX_WATCH_INTERVAL", "0.05")
    # _ingest_self folds the process-global registry into the store;
    # give the daemon a fresh one so metrics recorded by earlier tests
    # in this process don't sum into the queries below
    from torchx_tpu_torch.obs import metrics as obs_metrics

    monkeypatch.setattr(obs_metrics, "REGISTRY", obs_metrics.MetricsRegistry())
    d = ControlDaemon(
        runner=get_runner("telemetry-test"),
        state_dir=str(tmp_path / "control"),
        slos=["p99-ttft"],
        scrape_interval=999.0,
    ).start()
    yield d
    d.close()
    d.runner.close()


class TestDaemonTelemetryPlane:
    def test_query_and_alerts_see_a_regression(self, tel_daemon):
        import time as _time

        d = tel_daemon
        client = ControlClient(d.addr, d.root_token)
        now = _time.time()
        d.telemetry_store.ingest_text("replica-0", ttft_text(0, 0), ts=now - 30)
        d.telemetry_store.ingest_text("replica-0", ttft_text(10, 100), ts=now)

        names = client.metrics_query()["names"]
        assert f"{TTFT}_bucket" in names
        doc = client.metrics_query(name=TTFT, reduce="p99", range_s=600.0)
        # the p99 rank lands in the +Inf bucket: clamped to the last
        # finite bound, i.e. exactly the breached 500ms threshold
        assert doc["result"]
        assert doc["result"][0]["value"] == pytest.approx(0.5)

        # no evaluation yet: specs known, nothing firing
        reply = client.alerts()
        assert reply["enabled"] and reply["slos"] == ["p99-ttft"]
        assert reply["alerts"] == []

        d.slo_engine.evaluate()
        reply = client.alerts()
        (alert,) = reply["alerts"]
        assert alert["severity"] == "page" and alert["state"] == "firing"
        assert reply["burns"]["p99-ttft"]["long"] >= 14
        assert os.path.exists(
            os.path.join(d.state_dir, "slo_alerts.jsonl")
        )

        # (the JAX case also renders the regression in the `tpx top` frame:
        # cmd_top waits for ROADMAP queue 1 item 2.8, as TestTopSnapshot does)
        # and in the scalar the autoscaler/market consume
        assert d.slo_engine.max_burn("tpx_serve") >= 14

    def test_scrape_target_registration(self, tel_daemon, metricz_server):
        client = ControlClient(tel_daemon.addr, tel_daemon.root_token)
        reply = client.add_scrape_target(metricz_server, name="r0")
        assert reply["source"] == "r0"
        assert reply["targets"] == {"r0": metricz_server}
        tel_daemon.collector.collect_once()
        assert tel_daemon.telemetry_store.latest("up") == {(): 1.0}
        assert client.remove_scrape_target("r0")["ok"] is True
        with pytest.raises(ControlClientError):
            client.remove_scrape_target("r0")

    def test_bad_reducer_is_a_clean_400(self, tel_daemon):
        client = ControlClient(tel_daemon.addr, tel_daemon.root_token)
        tel_daemon.telemetry_store.ingest_text("r0", "g 1\n")
        with pytest.raises(ControlClientError) as ei:
            client.metrics_query(name="g", reduce="median")
        assert "unknown reducer" in str(ei.value)

    def test_metricz_serves_the_fleet_aggregate(self, tel_daemon):
        tel_daemon.telemetry_store.ingest_text(
            "r0", "# TYPE up gauge\nup 1\n"
        )
        tel_daemon.telemetry_store.ingest_text(
            "r1", "# TYPE up gauge\nup 1\n"
        )
        body = tel_daemon.render_metricz()
        (s,) = [r for r in parse_exposition(body) if r.name == "up"]
        assert s.value == 2.0 and s.kind == "gauge"


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------


class RecordingPool:
    """The promotion controller's pool contract over a given router class,
    failing the rolls a seeded draw marks."""

    def __init__(self, router_cls, replicas: int, fail_on=()):
        self.replicas = replicas
        self.router = router_cls()
        self.rolls: list = []
        self._fail_on = set(fail_on)

    def rollout_replica(self, replica_id: int, ckpt: str, **kw) -> bool:
        self.rolls.append((replica_id, ckpt))
        return replica_id not in self._fail_on


def promotion_trace(promote_mod, pool_mod, dag_mod, seed: int) -> list:
    """One seeded series of candidates, scores, baselines, burns and roll
    failures through ``promote_mod.PromotionController``: every outcome,
    roll, journal event and router weight left behind."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(40):
        replicas = int(rng.integers(0, 6))
        fail_on = {int(r) for r in rng.integers(0, 6, size=int(rng.integers(0, 2)))}
        pool = RecordingPool(pool_mod.LeastLoadedRouter, replicas, fail_on) if replicas else None
        burns = [round(float(b), 3) for b in rng.uniform(0.0, 2.0, size=4)]
        feed = iter(burns * 50)
        events = []
        t = [0.0]
        c = promote_mod.PromotionController(
            pool,
            slo_signal=(lambda: next(feed)) if rng.random() < 0.6 else None,
            canary_fraction=float(rng.choice([0.25, 0.5, 1.0])),
            canary_weight=float(rng.choice([1.0, 2.0])),
            burn_threshold=float(rng.choice([1.0, 1.5])),
            observe_s=float(rng.choice([0.0, 0.2])),
            poll_s=0.05,
            journal=lambda e, **f: events.append((e, f)),
            already_rolled=[0] if rng.random() < 0.2 else None,
            clock=lambda: t[0],
            sleep=lambda dt: t.__setitem__(0, t[0] + dt),
        )
        cand = dag_mod.Artifact(kind="checkpoint", path=f"/ckpt/{i}", digest=f"d{i}", step=i)
        score = round(float(rng.uniform(0, 1)), 3)
        baseline = round(float(rng.uniform(0, 1)), 3) if rng.random() < 0.7 else None
        outcome = c.run(cand, score=score, baseline_score=baseline,
                        incumbent_ckpt="/old" if rng.random() < 0.5 else "")
        out.append((outcome, pool.rolls if pool else None, events,
                     pool.router._weights if pool else None, sorted(c.already_rolled)))
    return out


class FakeStageExec:
    """A pipeline stage submitter minting handles, recording every call."""

    def __init__(self):
        self.calls: list = []
        self.cancels: list = []

    def submit(self, tenant, pipeline, stage, args):
        self.calls.append((tenant, pipeline, stage.name, stage.kind, list(args)))
        return {"handle": f"local://fake/{pipeline}-{stage.name}"}

    def cancel(self, handle):
        self.cancels.append(handle)


def masked_times(doc):
    keys = {"time_usec", "started_at", "finished_at", "submitted_at"}
    if isinstance(doc, dict):
        return {k: (f"<{k}>" if k in keys else masked_times(v)) for k, v in doc.items()}
    if isinstance(doc, (list, tuple)):
        return [masked_times(v) for v in doc]
    return doc


def engine_trace(engine_mod, dag_mod, base: str, seed: int) -> dict:
    """Seeded train -> eval -> promote specs through one
    ``engine_mod.PipelineEngine`` with a fake executor: each stage's
    terminal state arrives as an event; returns every status, call and
    journal record (clocks masked)."""
    rng = np.random.default_rng(seed)
    ex = FakeStageExec()
    engine = engine_mod.PipelineEngine(os.path.join(base, "pipelines.jsonl"), executor=ex,
                                       clock=lambda: 1000.0)
    statuses_ = []
    for i in range(6):
        ckpt = os.path.join(base, f"ckpt-{i}")
        write_checkpoint(ckpt, payload=f"w{i}".encode())
        score_file = os.path.join(base, f"score-{i}.json")
        score = round(float(rng.uniform(0, 1)), 3)
        spec = dag_mod.PipelineSpec.from_dict({"name": f"pl{i}", "stages": [
            {"name": "train", "kind": "train", "component": "utils.sh", "args": ["x"],
             "ckpt_dir": ckpt},
            {"name": "eval", "kind": "eval", "component": "utils.sh",
             "args": ["--ckpt", "{train.path}", "--digest", "{train.digest}"],
             "depends_on": ["train"], "score_file": score_file,
             "threshold": float(rng.choice([0.0, 0.3])), "baseline": "incumbent"},
            {"name": "promote", "kind": "promote", "depends_on": ["eval"]},
        ]})
        pid = engine.submit(spec, tenant="t")
        outcome = ["SUCCEEDED", "SUCCEEDED", "SUCCEEDED", "FAILED"][int(rng.integers(4))]
        ev = types.SimpleNamespace(scheduler="local", app_id=f"{pid}-train", terminal=True,
                                   state=types.SimpleNamespace(name=outcome))
        engine.on_event(ev)
        if outcome == "SUCCEEDED":
            with open(score_file, "w") as f:
                art = checkpoint_artifact(ckpt)
                json.dump({"score": score, "ckpt": ckpt, "digest": art.digest,
                           "step": art.step}, f)
            engine.on_event(types.SimpleNamespace(
                scheduler="local", app_id=f"{pid}-eval", terminal=True,
                state=types.SimpleNamespace(name="SUCCEEDED")))
        for t in engine.active_threads():
            t.join(timeout=30)
        statuses_.append(masked_times(engine.status(pid)))
    journal = [masked_times(json.loads(line))
               for line in open(os.path.join(base, "pipelines.jsonl"))]
    engine.close()
    return {"status": statuses_, "calls": ex.calls, "cancels": ex.cancels,
            "journal": journal, "list": masked_times(engine.status())}


class TestJaxParity:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_promotion_controllers_decide_alike(self, seed):
        from torchx_tpu.pipelines import dag as jdag
        from torchx_tpu.pipelines import promote as jpromote
        from torchx_tpu.serve import pool as jpool
        from torchx_tpu_torch.pipelines import dag, promote
        from torchx_tpu_torch.serve import pool

        port = promotion_trace(promote, pool, dag, seed)
        jax_ = promotion_trace(jpromote, jpool, jdag, seed)
        assert port == jax_
        outcomes = {o[0] for o in port}
        assert outcomes == {PROMOTED, ROLLED_BACK}

    def test_engines_drive_one_spec_alike(self, tmp_path):
        from torchx_tpu.pipelines import dag as jdag
        from torchx_tpu.pipelines import engine as jengine
        from torchx_tpu_torch.pipelines import dag, engine

        # the same paths on both sides: the records name them
        port = engine_trace(engine, dag, str(tmp_path / "run"), seed=0)
        os.rename(tmp_path / "run", tmp_path / "port")
        jax_ = engine_trace(jengine, jdag, str(tmp_path / "run"), seed=0)
        assert port == jax_
        states = {s["state"] for s in port["status"]}
        assert states == {"PROMOTED", "ROLLED_BACK", "FAILED"}

    def test_routers_keep_rollout_state_alike(self):
        from torchx_tpu.serve import pool as jpool

        rng = np.random.default_rng(11)
        port, jax_ = LeastLoadedRouter(), jpool.LeastLoadedRouter()
        picks = ([], [])
        for step in range(300):
            op = int(rng.integers(6))
            rid = int(rng.integers(4))
            if op == 0:
                healthy = [i for i in range(4) if rng.random() < 0.8]
                depths = [int(d) for d in rng.integers(3, size=4)]
                for r, status_cls in ((port, ReplicaStatus), (jax_, jpool.ReplicaStatus)):
                    r.update([status_cls(replica_id=i, url=f"http://x:{i}",
                                         healthy=i in healthy, queue_depth=depths[i])
                              for i in range(4)])
            elif op == 1:
                port.mark_draining(rid), jax_.mark_draining(rid)
            elif op == 2:
                port.clear_draining(rid), jax_.clear_draining(rid)
            elif op == 3:
                w = float(rng.choice([0.5, 1.0, 2.0, 4.0]))
                port.set_weight(rid, w), jax_.set_weight(rid, w)
            elif op == 4:
                lat = float(rng.uniform(0.001, 0.1))
                port.record(rid, lat), jax_.record(rid, lat)
            a, b = port.pick(), jax_.pick()
            picks[0].append(None if a is None else a.replica_id)
            picks[1].append(None if b is None else b.replica_id)
            assert [port.inflight(i) for i in range(4)] == [jax_.inflight(i) for i in range(4)]
        assert picks[0] == picks[1]
        assert len({p for p in picks[0] if p is not None}) > 1

    def test_pools_roll_out_alike(self):
        from torchx_tpu.serve import pool as jpool
        from torchx_tpu.specs import api as jspecs
        from torchx_tpu_torch.serve import pool as ppool
        from torchx_tpu_torch.specs import api as pspecs

        def rollouts(pool_mod, specs_mod, seed):
            rng = np.random.default_rng(seed)
            out = []
            for _ in range(20):
                app = specs_mod.AppDef(name="srv", roles=[specs_mod.Role(
                    name="server", image="i", entrypoint="x", num_replicas=3)])
                router = pool_mod.LeastLoadedRouter()
                router.update([pool_mod.ReplicaStatus(replica_id=i, url=f"http://x:{i}",
                                                      healthy=True) for i in range(3)])
                for _ in range(int(rng.integers(4))):
                    router.pick()
                clock = {"t": 0.0}
                drains = bool(rng.integers(2))
                healthy_after = float(rng.choice([0.0, 0.5, 100.0]))
                probes = []

                def sleep(dt):
                    clock["t"] += dt
                    if drains:
                        for i in range(3):
                            if router.inflight(i) > 0:
                                router.record(i, 0.01)

                def probe(rid, url):
                    probes.append((rid, router.inflight(rid)))
                    return pool_mod.ReplicaStatus(
                        replica_id=rid, url=url, healthy=clock["t"] >= healthy_after)

                pool = pool_mod.ServePool(
                    runner=object(), app=app, router=router, probe=probe,
                    clock=lambda: clock["t"], sleep=sleep)
                rid = int(rng.integers(3))
                ok = pool.rollout_replica(rid, "/new", drain_timeout_s=1.0, health_timeout_s=2.0)
                out.append((rid, ok, probes[:3], len(probes), round(clock["t"], 6),
                            [router.inflight(i) for i in range(3)]))
            return out

        port = rollouts(ppool, pspecs, 5)
        assert port == rollouts(jpool, jspecs, 5)
        assert {o[1] for o in port} == {True, False}

    def test_pools_poll_to_the_end_alike(self):
        """``ServePool.run``: the same seeded probes scale both pools
        alike, and the status poll that first answers a terminal state
        ends both loops before another step (one poll a step)."""
        from torchx_tpu.serve import pool as jpool
        from torchx_tpu.specs import api as jspecs
        from torchx_tpu_torch.serve import pool as ppool
        from torchx_tpu_torch.specs import api as pspecs

        def drive(pool_mod, specs_mod):
            rng = np.random.default_rng(21)
            clock = [0.0]

            class FakeRunner:
                def __init__(self):
                    self.resizes, self.status_calls = [], 0

                def run(self, app, scheduler, cfg):
                    return "local://s/app_1"

                def status(self, handle):
                    self.status_calls += 1
                    state = (specs_mod.AppState.FAILED if self.status_calls > 40
                             else specs_mod.AppState.RUNNING)
                    return specs_mod.AppStatus(state=state)

                def resize(self, handle, role, n):
                    self.resizes.append((role, n))

            def probe(rid, url):
                clock[0] += 7.0
                return pool_mod.ReplicaStatus(replica_id=rid, url=url, healthy=True,
                                              queue_depth=int(rng.integers(0, 12)))

            runner = FakeRunner()
            app = specs_mod.AppDef(name="srv", roles=[specs_mod.Role(
                name="server", image="i", entrypoint="x", num_replicas=2)])
            pool = pool_mod.ServePool(
                runner, app, probe=probe, clock=lambda: clock[0], sleep=lambda dt: None,
                policy=pool_mod.AutoscalePolicy(min_replicas=1, max_replicas=6))
            pool.start()
            pool.run(interval_s=0.001, iterations=100)
            return runner.resizes, runner.status_calls, pool.scale_events

        port = drive(ppool, pspecs)
        assert port == drive(jpool, jspecs)
        resizes, status_calls, _ = port
        assert resizes and status_calls == 41
