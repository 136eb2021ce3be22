"""Checkpoints of the port's trainer as a gang, on the CPU: ``llama_tiny``
(the ``tiny`` preset, f32) trained by 2 and 4 gloo ranks through
``spmd_main`` with ``--ckpt-dir``.

A SIGTERM to one rank of an ``fsdp=2`` gang stops both at one step and
commits it once (a file a rank, rank 0's index and manifest); the gang
resumes bitwise after that step and after a periodic save; the step
restores bitwise into ``fsdp=1`` (one process) and ``fsdp=4``, whose
continued losses stay within 1e-4 of one process (the gang tolerance of
``tests/test_torch_fsdp.py``); at ``dp=2,fsdp=2`` each block is written
once; a corrupt newest step raises on both ranks and no rank falls back;
the JAX launcher's readers and the port's server read a gang's step. A
step saved at ``fsdp=1,tp=2`` holds each rank's ``tp`` blocks and every
leaf whole over ``tp`` once, and restores bitwise at world 1, at
``fsdp=2`` and at ``tp=2``, where the resumed losses are the uninterrupted
run's bitwise. The world-2 gang also runs the MoE router's balance term
over two ranks against the JAX package's on the whole batch, and the
world-4 gang a profiled ``dp=2,fsdp=2`` run whose ``grad_sync`` slices
carry the JAX cost model's bytes.

The drill's gang runs first, the ``tp`` gang beside it; then one world-2
and one world-4 gang run all their cases side by side, each on its own
copy of a saved directory (``tests/torch_gang_cases.py``), killed past a
deadline.
"""

import json
import os
import shutil
import signal
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_gang_cases as gang
from torchx_tpu.analyze import costmodel as jcost
from torchx_tpu.analyze import plan as jplan
from torchx_tpu.apps import eval_main as jeval
from torchx_tpu.models import moe as jmoe
from torchx_tpu.supervisor import api as jsup
from torchx_tpu_torch.apps import generate_server as gs
from torchx_tpu_torch.examples import train_llama as ttrain
from torchx_tpu_torch.models import llama as tllama
from torchx_tpu_torch.parallel import checkpoint as ckpt_mod
from torchx_tpu_torch.parallel.checkpoint import Checkpointer
from torchx_tpu_torch.parallel.mesh import shard_extent
from torchx_tpu_torch.parallel.mesh_config import AXES, parse_mesh_spec
from torch_threads import xdist_torch_threads  # noqa: F401

TRAIN = dict(kind="train", config="tiny", batch=4, seq=16, warmup=1)
TOL = 1e-4
#: the tp gang: fsdp 1, two tp ranks, saving its last step
TP_MESH, TP_STEPS = "fsdp=1,tp=2", 3
#: the balance term over two ranks against the whole batch's, f32
MOE_TOL = 1e-6


def _token_file(path):
    np.random.default_rng(5).integers(0, 512, 8192, dtype=np.uint32).tofile(path)
    return str(path)


def _flip_byte(path):
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        byte = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([byte[0] ^ 0xFF]))


def _listing(directory):
    out = {}
    for root, _, files in os.walk(directory):
        for name in files:
            p = os.path.join(root, name)
            out[os.path.relpath(p, directory)] = (os.path.getsize(p), os.stat(p).st_mtime_ns)
    return out


def _drill(tmp, data):
    """An fsdp=2 gang saving every 2 steps, SIGTERM to its rank 1 after
    the step-2 line. -> (rc, stdout, results)."""
    d = str(tmp / "drill")
    proc = gang.run_cases(tmp / "j_drill", 2, [dict(
        name="drill", mesh="fsdp=2", data=data, steps=100000, log_every=1, ckpt_dir=d,
        ckpt_every=2, **TRAIN)])
    deadline = time.monotonic() + 90
    lines = []
    while not (lines and lines[-1].startswith("step 2 ")):
        assert time.monotonic() < deadline and proc.poll() is None, "".join(lines)
        lines.append(proc.stdout.readline())
    with open(f"/proc/{proc.pid}/task/{proc.pid}/children") as f:
        workers = [int(pid) for pid in f.read().split()]
    assert len(workers) == 2
    os.kill(workers[1], signal.SIGTERM)
    (rc, out, err), = gang.finish([proc], timeout=90)
    assert rc == 0, ("".join(lines) + out)[-3000:] + err[-3000:]
    return d, "".join(lines) + out, gang.load_results(tmp / "j_drill", 2)


def _write_moe(tmp):
    """moe_tiny's layer 0 from the JAX init and a batch of 4 rows."""
    p_j = jmoe.init_params(jmoe.moe_tiny(), jax.random.PRNGKey(81))
    layer = {k: np.asarray(v[0]) for k, v in p_j["layers"].items()}
    np.savez(tmp / "moe_layer.npz", **layer)
    x = np.random.default_rng(82).standard_normal((4, 32, 64)).astype(np.float32)
    np.savez(tmp / "moe_x.npz", x=x)
    return layer, x


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gangckpt")
    data = _token_file(tmp / "tokens.bin")
    # a tp=2 gang saving its last step, beside the drill
    tp_dir = str(tmp / "ck_tp")
    tp_proc = gang.run_cases(tmp / "j_tp", 2, [dict(
        name="tp", mesh=TP_MESH, data=data, steps=TP_STEPS, ckpt_dir=tp_dir, **TRAIN)])
    drill_dir, drill_out, drill = _drill(tmp, data)
    (rc, out, err), = gang.finish([tp_proc])
    assert rc == 0, (out[-3000:], err[-3000:])
    n = drill[0]["drill"]["final_step"]
    copies = {}
    for name in ("resume", "corrupt", "fsdp4", "one", "contract"):
        copies[name] = str(tmp / f"ck_{name}")
        shutil.copytree(drill_dir, copies[name])
    for name in ("tp_one", "tp_fsdp2", "tp_tp2"):
        copies[name] = str(tmp / f"ck_{name}")
        shutil.copytree(tp_dir, copies[name])
    _flip_byte(os.path.join(copies["corrupt"], str(n), "shard-1.pt"))
    corrupt_before = _listing(copies["corrupt"])
    moe_layer, moe_x = _write_moe(tmp)
    ref_steps = max(9, n + 3)
    cases2 = [
        dict(name="ref", mesh="fsdp=2", data=data, steps=ref_steps, **TRAIN),
        dict(name="periodic", mesh="fsdp=2", data=data, steps=6, ckpt_every=2,
             ckpt_dir=str(tmp / "ck_periodic"), **TRAIN),
        dict(name="periodic_resume", mesh="fsdp=2", data=data, steps=3, ckpt_every=2,
             ckpt_dir=str(tmp / "ck_periodic"), **TRAIN),
        dict(name="term_resume", mesh="fsdp=2", data=data, steps=3,
             ckpt_dir=copies["resume"], **TRAIN),
        dict(name="corrupt", mesh="fsdp=2", data=data, steps=1, ckpt_dir=copies["corrupt"],
             expect_error=True, **TRAIN),
        dict(name="moe", kind="moe_balance", mesh="fsdp=2", init=str(tmp / "moe_layer.npz"),
             batches=str(tmp / "moe_x.npz")),
        dict(name="tp_ref", mesh=TP_MESH, data=data, steps=2 * TP_STEPS, **TRAIN),
        dict(name="tp_fsdp2", mesh="fsdp=2", data=data, steps=1,
             ckpt_dir=copies["tp_fsdp2"], **TRAIN),
        dict(name="tp_tp2", mesh=TP_MESH, data=data, steps=TP_STEPS,
             ckpt_dir=copies["tp_tp2"], **TRAIN),
    ]
    cases4 = [
        dict(name="fsdp=4", mesh="fsdp=4", data=data, steps=3, ckpt_dir=copies["fsdp4"],
             **TRAIN),
        dict(name="dp", mesh="dp=2,fsdp=2", data=data, steps=3, grad_bucket_mb=1,
             ckpt_dir=str(tmp / "ck_dp"), profile=True, **TRAIN),
    ]
    obs = str(tmp / "obs")
    procs = [gang.run_cases(tmp, 2, cases2), gang.run_cases(tmp, 4, cases4,
                                                             {"TPX_OBS_DIR": obs})]
    for rc, out, err in gang.finish(procs):
        assert rc == 0, (out[-3000:], err[-3000:])
    return {"tmp": tmp, "data": data, "n": n, "drill_dir": drill_dir, "tp_dir": tp_dir,
            "tp": gang.load_results(tmp / "j_tp", 2),
            "drill_out": drill_out, "drill": drill, "copies": copies,
            "corrupt_before": corrupt_before, "moe": (moe_layer, moe_x), "obs": obs,
            2: gang.load_results(tmp, 2), 4: gang.load_results(tmp, 4)}


def _specs():
    return ttrain.checkpoint_specs(tllama.llama_tiny())


def _coords(spec, world, rank):
    sizes = parse_mesh_spec(spec).resolve(world)
    c = np.unravel_index(rank, [sizes[a] for a in AXES])
    return sizes, {a: int(x) for a, x in zip(AXES, c)}


def _block(whole, name, spec, world, rank):
    sizes, coords = _coords(spec, world, rank)
    t = whole[name]
    return t[shard_extent(_specs().get(name, (None,) * t.dim()), tuple(t.shape), sizes,
                          coords)]


def _whole(d, step):
    """The unsharded state of ``step``, as a reader without a mesh gets it."""
    return Checkpointer(d, read_only=True).restore(step)


def test_sigterm_to_one_rank_commits_one_step(runs):
    """Both ranks stop at one step, preempted; the step is committed once:
    rank 0's index and manifest, one file a rank, its digest verified."""
    n, d = runs["n"], runs["drill_dir"]
    finals = [r["drill"] for r in runs["drill"]]
    assert all(f["preempted"] and f["final_step"] == n for f in finals)
    assert f"preemption notice: checkpointed step {n}, exiting" in runs["drill_out"]
    assert sorted(os.listdir(os.path.join(d, str(n)))) == \
        ["index.json", "shard-0.pt", "shard-1.pt"]
    assert not [x for x in os.listdir(d) if ".tmp." in x]
    assert json.load(open(os.path.join(d, "MANIFEST.json")))["latest_step"] == n
    assert Checkpointer(d, read_only=True).verify_step(n) is True
    writes = [f["checkpoint"]["writes"][-1] for f in finals]
    assert writes[0]["step"] == writes[1]["step"] == n
    assert "commit_wait_s" in writes[0] and "commit_s" in writes[1]
    # each rank's snapshot buffers hold its own blocks only (the replicated
    # entries are rank 0's)
    held = [f["checkpoint"]["buffer_bytes"] for f in finals]
    assert held[0] > held[1] > 0
    # the shards the ranks held at the end are the step's blocks
    whole = _whole(d, n)
    for rank, f in enumerate(finals):
        for name, got in f["params"].items():
            assert torch.equal(got, _block(whole, name, "fsdp=2", 2, rank)), name


def test_resume_is_bitwise_after_a_periodic_save_and_a_sigterm(runs):
    """An fsdp=2 gang resumed at fsdp=2 continues the uninterrupted run's
    losses bitwise: from the periodic save of step 6 and from the step the
    SIGTERM saved (the token stream resumes at the restored step)."""
    res = runs[2][0]
    ref, n = res["ref"]["losses"], runs["n"]
    assert res["periodic"]["losses"] == ref[:6]
    assert [w["step"] for w in res["periodic"]["checkpoint"]["writes"]] == [6]
    assert res["periodic_resume"]["resumed_from_step"] == 6
    assert res["periodic_resume"]["losses"] == ref[6:9]
    assert runs["drill"][0]["drill"]["losses"] == ref[:n]
    assert res["term_resume"]["resumed_from_step"] == n
    assert res["term_resume"]["losses"] == ref[n:n + 3]
    for r in runs[2]:
        assert r["term_resume"]["losses"] == res["term_resume"]["losses"]


@pytest.fixture(scope="module")
def one_process(runs):
    """The drill's step restored and continued 3 steps by one process."""
    box = {}
    out = ttrain.train(tllama.llama_tiny(), TRAIN["batch"], TRAIN["seq"], 3,
                       warmup=TRAIN["warmup"], data_path=runs["data"], prefetch=0,
                       kernels="cuda", device="cpu", log_every=0,
                       ckpt_dir=runs["copies"]["one"],
                       on_state=lambda e, s: box.update(
                           {k: v.clone() for k, v in s.items()}) if e == "restored" else None)
    return out, box


@pytest.mark.parametrize("spec,world", [("fsdp=1", 1), ("fsdp=4", 4)])
def test_a_step_saved_at_fsdp2_restores_at_another_size(runs, one_process, spec, world):
    """Every restored block is bitwise its slice of the unsharded state
    (the embedding, wo and w_down shard their last dimension), and the
    continued losses are within 1e-4 of one process's and of the
    uninterrupted fsdp=2 run's."""
    n = runs["n"]
    whole = _whole(runs["drill_dir"], n)
    one, restored_one = one_process
    if world == 1:
        results, losses = [{"restored": restored_one, "resumed_from_step": n}], one["losses"]
    else:
        results = [r["fsdp=4"] for r in runs[4]]
        losses = results[0]["losses"]
    assert set(results[0]["restored"]) == set(whole)
    for rank, res in enumerate(results):
        assert res["resumed_from_step"] == n
        for name, got in res["restored"].items():
            assert torch.equal(got, _block(whole, name, spec, world, rank)), (rank, name)
    np.testing.assert_allclose(losses, one["losses"], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(losses, runs[2][0]["ref"]["losses"][n:n + 3], rtol=TOL,
                               atol=TOL)


def test_dp_replicas_write_each_block_once(runs):
    """At dp=2,fsdp=2 only the ranks of dp coordinate 0 write, and the
    index covers every entry's whole shape exactly once."""
    d = str(runs["tmp"] / "ck_dp")
    step = jsup.latest_checkpoint_step(d)
    files = sorted(os.listdir(os.path.join(d, str(step))))
    assert files == ["index.json", "shard-0.pt", "shard-1.pt"]
    index = json.load(open(os.path.join(d, str(step), ckpt_mod.INDEX)))
    assert index["world"] == 4 and index["mesh"]["dp"] == 2 and index["mesh"]["fsdp"] == 2
    for name, e in index["entries"].items():
        cover = np.zeros(e["shape"], dtype=np.int64)
        for p in e["pieces"]:
            cover[tuple(slice(a, b) for a, b in zip(p["start"], p["stop"]))] += 1
        assert (cover == 1).all(), name
    writes = [r["dp"]["checkpoint"]["writes"][-1] for r in runs[4]]
    assert [w["bytes"] > 0 for w in writes] == [True, True, False, False]
    # the index round-trips: the same layout from the specs and the mesh
    entries = {k: (tuple(tuple(a) if isinstance(a, list) else a for a in e["spec"]),
                   tuple(e["shape"]), getattr(torch, e["dtype"]))
               for k, e in index["entries"].items()}
    assert json.loads(json.dumps(ckpt_mod.layout_index(entries, index["mesh"]))) == index


def test_a_corrupt_newest_step_raises_on_every_rank(runs):
    """A flipped byte in one rank's file of the newest step: both ranks
    raise (no hang), neither falls back to the older step, and nothing on
    disk moves."""
    for r in runs[2]:
        err = r["corrupt"]["error"]
        assert err.startswith("RuntimeError") and "failed to restore" in err, err
    assert _listing(runs["copies"]["corrupt"]) == runs["corrupt_before"]


def test_the_jax_launcher_reads_a_gang_step(runs, tmp_path):
    """latest_checkpoint_step and verify_checkpoint read a two-rank step;
    one flipped byte of one rank's file fails the gate."""
    d, n = runs["copies"]["contract"], runs["n"]
    assert jsup.latest_checkpoint_step(d) == n
    assert jeval.verify_checkpoint(d)[0] == n
    bad = str(tmp_path / "bad")
    shutil.copytree(d, bad)
    _flip_byte(os.path.join(bad, str(n), "shard-0.pt"))
    with pytest.raises(ValueError, match="digest mismatch"):
        jeval.verify_checkpoint(bad)


def test_the_server_serves_a_gang_step(runs, tmp_path):
    """generate_server --ckpt-dir on a two-rank step: the greedy tokens of
    a one-process save of the same state."""
    d, n = runs["copies"]["contract"], runs["n"]
    single = str(tmp_path / "single")
    ckpt = Checkpointer(single)
    ckpt.save(n, _whole(d, n))
    ckpt.close()
    assert os.listdir(os.path.join(single, str(n))) == [ckpt_mod.PAYLOAD]
    prompts = [[1, 2, 3], [9, 8, 7, 6, 5]]
    got = []
    for directory in (d, single):
        svc = gs.GenerateService("tiny", ckpt_dir=directory, device="cpu", max_batch=2)
        try:
            assert svc.ckpt_step == n
            got.append(svc.generate(prompts, 8))
        finally:
            svc.close()
    assert got[0] == got[1]


def test_moe_balance_over_two_ranks_is_the_whole_batchs(runs):
    """Each rank routes half the batch; the balance term is the JAX
    package's on the whole batch (per-expert means averaged over the data
    group before their product)."""
    layer, x = runs["moe"]
    _, aux_j = jmoe.moe_ffn(jmoe.moe_tiny(), {k: jnp.asarray(v) for k, v in layer.items()},
                            jnp.asarray(x))
    for r in runs[2]:
        np.testing.assert_allclose(float(r["moe"]["aux"][tllama.AUX_BALANCE]),
                                   float(aux_j[tllama.AUX_BALANCE]), rtol=MOE_TOL,
                                   atol=MOE_TOL)


def test_a_gangs_profile_has_a_grad_sync_slice_per_data_axis(runs):
    """The profiled dp=2,fsdp=2 run: rank 0's records carry grad_sync for
    dp and fsdp, modeled from the JAX cost model's bytes."""
    from torchx_tpu_torch.analyze import costmodel

    prof = runs[4][0]["dp"]["profile"]
    assert set(prof["grad_sync_seconds"]) == {"dp", "fsdp"}
    plan = jplan.ParallelPlan(role="train", model=jplan.MODEL_SHAPES["tiny"], mesh_spec="",
                              sizes={"dp": 2, "fsdp": 2}, batch=TRAIN["batch"],
                              seq=TRAIN["seq"])
    want = {t.axis: t.bytes_per_step for t in jcost.collective_traffic(plan)}
    modeled = prof["meta"]["comm_modeled_axis_s"]
    assert {a: round(s * costmodel.DEFAULT_LINK_BYTES_PER_S) for a, s in modeled.items()} \
        == want
    records = []
    for root, _, files in os.walk(runs["obs"]):
        if "profile.jsonl" in files:
            records += [json.loads(x) for x in open(os.path.join(root, "profile.jsonl"))]
    steps = [r for r in records if r["kind"] == "step"]
    assert steps and all(set(r["grad_sync"]) == {"dp", "fsdp"} for r in steps)


def _cover(index):
    """Each entry's pieces counted over its whole shape, and the files
    holding them."""
    out = {}
    for name, e in index["entries"].items():
        cover = np.zeros(e["shape"], dtype=np.int64)
        for p in e["pieces"]:
            cover[tuple(slice(a, b) for a, b in zip(p["start"], p["stop"]))] += 1
        out[name] = (cover, {p["file"] for p in e["pieces"]})
    return out


def test_a_step_saved_at_tp2_holds_each_block_once(runs):
    """At fsdp=1,tp=2 each rank writes a file of its tp blocks, a leaf
    whole over tp is written once (rank 0's), rank 0 commits the manifest,
    each rank's final shards are the step's blocks bitwise, and the JAX
    launcher's readers accept the step."""
    d = runs["tp_dir"]
    step = jsup.latest_checkpoint_step(d)
    assert step == TP_STEPS and jeval.verify_checkpoint(d)[0] == step
    assert sorted(os.listdir(os.path.join(d, str(step)))) == \
        ["index.json", "shard-0.pt", "shard-1.pt"]
    index = json.load(open(os.path.join(d, str(step), ckpt_mod.INDEX)))
    assert index["world"] == 2 and index["mesh"]["tp"] == 2
    specs = _specs()
    for name, (cover, files) in _cover(index).items():
        assert (cover == 1).all(), name
        tp_sharded = "tp" in specs.get(name, ())
        assert files == ({"shard-0.pt", "shard-1.pt"} if tp_sharded else {"shard-0.pt"}), name
    whole = _whole(d, step)
    for rank, r in enumerate(runs["tp"]):
        assert r["tp"]["final_step"] == step
        for name, got in r["tp"]["params"].items():
            assert torch.equal(got, _block(whole, name, TP_MESH, 2, rank)), (rank, name)


@pytest.mark.parametrize("spec,world", [("fsdp=1", 1), ("fsdp=2", 2), (TP_MESH, 2)])
def test_a_step_saved_at_tp2_restores_at_another_mesh(runs, spec, world):
    """Every restored block is bitwise its slice of the unsharded state, at
    world 1 (one process), fsdp=2 and tp=2; resumed at tp=2 the gang
    continues the uninterrupted tp=2 run's losses bitwise."""
    whole = _whole(runs["tp_dir"], TP_STEPS)
    if world == 1:
        box = {}
        out = ttrain.train(tllama.llama_tiny(), TRAIN["batch"], TRAIN["seq"], 1,
                           warmup=TRAIN["warmup"], data_path=runs["data"], prefetch=0,
                           kernels="cuda", device="cpu", log_every=0,
                           ckpt_dir=runs["copies"]["tp_one"],
                           on_state=lambda e, st: box.update(
                               {k: v.clone() for k, v in st.items()})
                           if e == "restored" else None)
        results = [{"restored": box, "resumed_from_step": out["resumed_from_step"]}]
    else:
        results = [r["tp_fsdp2" if spec == "fsdp=2" else "tp_tp2"] for r in runs[2]]
    for rank, res in enumerate(results):
        assert res["resumed_from_step"] == TP_STEPS
        assert set(res["restored"]) == set(whole)
        for name, got in res["restored"].items():
            assert torch.equal(got, _block(whole, name, spec, world, rank)), (rank, name)
    if spec == TP_MESH:
        ref = runs[2][0]["tp_ref"]["losses"]
        assert runs["tp"][0]["tp"]["losses"] == ref[:TP_STEPS]
        for res in results:
            assert res["losses"] == ref[TP_STEPS:]

