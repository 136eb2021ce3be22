"""The port's trainer as a gang on the CPU: llama_tiny (dim 128, 2/1
heads, ffn 256, 2 layers, f32) trained by 2 and 4 gloo ranks through
``spmd_main`` under ``fsdp=2``, ``dp=2`` and ``dp=2,fsdp=2``, held to the
single-device trainer on the same global batches (losses, gradient norms
and every rank's shards within 1e-5 after 3 steps; one case with a
``loss_mask``, one on ``moe_tiny``), and ``fsdp=2`` held to the JAX trainer's own ``fsdp=2``
step (``make_mesh(MeshConfig(fsdp=2))`` over two of conftest's 8 CPU
devices) within 1e-4 after 4 steps, ``tests/test_torch_model.py``'s
trajectory tolerance. Then ``$TPX_MESH`` over ``--mesh``, and what is not
ported raising.

The two gangs start once for the module, side by side; each runs all of
its cases (``tests/torch_gang_cases.py``) and is killed, workers and all,
past its deadline.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

import torch_gang_cases as gang
from torchx_tpu.examples import train_llama as jtrain
from torchx_tpu.models import llama as jllama
from torchx_tpu.parallel import mesh as jmesh_lib
from torchx_tpu_torch import convert
from torchx_tpu_torch.examples import train_llama as ttrain
from torchx_tpu_torch.models import llama as tllama
from torchx_tpu_torch.parallel.mesh import Mesh
from torchx_tpu_torch.parallel.mesh import shard as shard_of
from torchx_tpu_torch.parallel.mesh_config import AXES, parse_mesh_spec
from torch_threads import xdist_torch_threads  # noqa: F401

TRAIN = dict(batch=4, seq=32, steps=3, warmup=1)
#: the mask case and the JAX case: make_train_step on JAX-initialized
#: weights, the trainer's lr, warmup 2 (tests/test_torch_model.py's)
STEP = dict(lr=3e-4, warmup=2)
TOL = 1e-5
JAX_TOL = 1e-4


def _token_file(path):
    np.random.default_rng(0).integers(0, 512, 8192, dtype=np.uint32).tofile(path)
    return str(path)


def _jax_cfg():
    return jllama.llama_tiny(kernels="reference", **gang.SHAPE)


def _write_init(path):
    p_j = jllama.init_params(_jax_cfg(), jax.random.PRNGKey(60))
    flat = {"/".join(str(k.key) for k in kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(p_j)[0]}
    np.savez(path, **flat)
    return p_j


def _write_batches(path, steps, mask):
    rng = np.random.default_rng(61)
    arrays = {"tokens": rng.integers(0, 512, (steps, 4, 33)).astype(np.int32)}
    if mask:
        arrays["loss_mask"] = (rng.random((steps, 4, 33)) < 0.7).astype(np.float32)
    np.savez(path, **arrays)
    return arrays


@pytest.fixture(scope="module")
def gangs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fsdp")
    data = _token_file(tmp / "tokens.bin")
    p_j = _write_init(tmp / "init.npz")
    batches = {
        "mask": _write_batches(tmp / "mask.npz", 3, mask=True),
        "jax": _write_batches(tmp / "jax.npz", 4, mask=False),
    }
    train = dict(kind="train", data=data, **TRAIN)
    step = dict(kind="step", init=str(tmp / "init.npz"), **STEP)
    cases2 = [
        dict(name="fsdp=2", mesh="fsdp=2", **train),
        dict(name="moe fsdp=2", mesh="fsdp=2", config="moe_tiny", **train),
        dict(name="dp=2", mesh="dp=2", grad_bucket_mb=1, **train),
        dict(name="mask", mesh="fsdp=2", batches=str(tmp / "mask.npz"), **step),
        dict(name="jax", mesh="fsdp=2", batches=str(tmp / "jax.npz"), **step),
    ]
    cases4 = [dict(name="dp=2,fsdp=2", mesh="dp=2,fsdp=2", grad_bucket_mb="auto", **train)]
    procs = [gang.run_cases(tmp, 2, cases2), gang.run_cases(tmp, 4, cases4)]
    runs = gang.finish(procs)
    for rc, out, err in runs:
        assert rc == 0, (out[-3000:], err[-3000:])
    return {"data": data, "p_j": p_j, "batches": batches,
            2: gang.load_results(tmp, 2), 4: gang.load_results(tmp, 4)}


def _mesh_at(spec: str, world: int, rank: int) -> Mesh:
    """The sizes and coordinates of rank ``rank`` (no process group: the
    sharding arithmetic needs no more)."""
    sizes = parse_mesh_spec(spec).resolve(world)
    coords = np.unravel_index(rank, [sizes[a] for a in AXES])
    return Mesh(None, sizes, {a: int(c) for a, c in zip(AXES, coords)}, None, None,
                "gloo")


def _single_device(data, cfg=None):
    box = {}

    def on_state(event, state):
        if event == "final":
            box.update({k: v.detach().clone() for k, v in state.items()
                        if k.startswith("params.")})

    out = ttrain.train(cfg or gang.tiny(), data_path=data, prefetch=0, kernels="cuda",
                       device="cpu", log_every=0, on_state=on_state, **TRAIN)
    return out, box


def _assert_shards_match(results, whole, spec_str, world, tol, cfg=None):
    specs = dict(tllama.named_leaves(tllama.param_specs(cfg or gang.tiny())))
    for rank, res in enumerate(results):
        mesh = _mesh_at(spec_str, world, rank)
        for name, got in res["params"].items():
            want = shard_of(whole[name], specs[name[len("params."):]], mesh)
            torch.testing.assert_close(got, want, rtol=tol, atol=tol,
                                       msg=lambda m: f"rank {rank} {name}: {m}")


@pytest.mark.parametrize("spec,world", [("fsdp=2", 2), ("dp=2", 2), ("dp=2,fsdp=2", 4)])
def test_gang_trains_as_one_device(gangs, spec, world):
    """Every rank's losses and gradient norms, and its shards after 3
    steps, within 1e-5 of the single-device trainer on the same global
    batches (a token file: a new batch each step)."""
    ref, whole = _single_device(gangs["data"])
    results = [r[spec] for r in gangs[world]]
    for res in results:
        assert res["world"] == world and res["mesh"] == \
            ",".join(f"{a}={v}" for a, v in parse_mesh_spec(spec).resolve(world).items())
        np.testing.assert_allclose(res["losses"], ref["losses"], rtol=TOL)
        np.testing.assert_allclose(res["grad_norms"], ref["grad_norms"], rtol=TOL)
    _assert_shards_match(results, whole, spec, world, TOL)
    if spec != "fsdp=2":  # a dp axis: the buckets
        assert results[0]["grad_buckets"] >= 1


def test_moe_under_fsdp_trains_as_one_device(gangs):
    """moe_tiny at fsdp=2, refused before the ep axis was ported: each rank
    routes its rows with the whole batch's balance term, and its losses,
    gradient norms and shards after 3 steps are within 1e-5 of the
    single-device trainer's."""
    cfg = tllama.get_config("moe_tiny")
    ref, whole = _single_device(gangs["data"], cfg)
    results = [r["moe fsdp=2"] for r in gangs[2]]
    for res in results:
        np.testing.assert_allclose(res["losses"], ref["losses"], rtol=TOL)
        np.testing.assert_allclose(res["grad_norms"], ref["grad_norms"], rtol=TOL)
    _assert_shards_match(results, whole, "fsdp=2", 2, TOL, cfg)


def _step_reference(case, p_j):
    """make_train_step without a mesh on the same weights and batches."""
    cfg = gang.tiny()
    params = convert.params_from_jax(jax.tree.map(np.asarray, p_j), cfg)
    opt = ttrain.make_optimizer(tllama.leaves(params), **STEP)
    step = ttrain.make_train_step(cfg, opt)
    losses, norms = [], []
    for i in range(case["tokens"].shape[0]):
        batch = {k: torch.from_numpy(v[i]) for k, v in case.items()}
        out = step(params, batch)
        losses.append(float(out["loss"]))
        norms.append(float(out["grad_norm"]))
    whole = {f"params.{k}": v.detach() for k, v in tllama.named_leaves(params)}
    return losses, norms, whole


def test_loss_mask_counts_the_whole_batch(gangs):
    """With a loss_mask the kept targets are counted over the whole batch:
    fsdp=2 within 1e-5 of one device."""
    losses, norms, whole = _step_reference(gangs["batches"]["mask"], gangs["p_j"])
    results = [r["mask"] for r in gangs[2]]
    for res in results:
        np.testing.assert_allclose(res["losses"], losses, rtol=TOL)
        np.testing.assert_allclose(res["grad_norms"], norms, rtol=TOL)
    _assert_shards_match(results, whole, "fsdp=2", 2, TOL)


def test_fsdp2_matches_the_jax_fsdp2_step(gangs):
    """4 steps of the JAX trainer's make_train_step on a 2-device fsdp mesh
    and of the port's on 2 gloo ranks, from the same JAX init and
    batches: losses and every parameter within 1e-4."""
    cfg_j = _jax_cfg()
    mesh = jmesh_lib.make_mesh(jmesh_lib.MeshConfig(fsdp=2), devices=jax.devices()[:2])
    params = jllama.shard_params(gangs["p_j"], cfg_j, mesh)
    opt = jtrain.make_optimizer(**STEP)
    state = jtrain.TrainState(params=params, opt_state=opt.init(params),
                              step=jnp.zeros((), jnp.int32))
    step = jtrain.make_train_step(cfg_j, mesh, opt)
    losses = []
    for tok in gangs["batches"]["jax"]["tokens"]:
        batch = {"tokens": jax.device_put(tok, NamedSharding(mesh, jmesh_lib.BATCH_SPEC))}
        state, loss, _ = step(state, batch)
        losses.append(float(loss))
    results = [r["jax"] for r in gangs[2]]
    for res in results:
        np.testing.assert_allclose(res["losses"], losses, rtol=JAX_TOL, atol=JAX_TOL)
    whole = {f"params.{'.'.join(str(k.key) for k in kp)}": torch.from_numpy(np.array(v))
             for kp, v in jax.tree_util.tree_flatten_with_path(state.params)[0]}
    _assert_shards_match(results, whole, "fsdp=2", 2, JAX_TOL)


def test_a_preemption_notice_stops_every_rank_at_one_step():
    """A notice that reaches one rank of a training gang (SIGTERM to one
    worker) stops every rank at the same step: no rank waits in a
    collective for one that left, and the gang exits 0, preempted."""
    import signal
    import time

    proc = gang.start(["--nproc-per-node", "2", "--port", "0",
                       "--timeout", "60", "-m", "torchx_tpu_torch.examples.train_llama",
                       "--", "--device", "cpu", "--config", "tiny", "--mesh", "fsdp=2",
                       "--batch", "4", "--seq", "16", "--steps", "100000"])
    deadline = time.monotonic() + 60
    line = ""
    while not line.startswith("step 2 "):
        assert time.monotonic() < deadline and proc.poll() is None
        line = proc.stdout.readline()
    with open(f"/proc/{proc.pid}/task/{proc.pid}/children") as f:
        workers = [int(pid) for pid in f.read().split()]
    assert len(workers) == 2
    os.kill(workers[1], signal.SIGTERM)
    (rc, out, err), = gang.finish([proc], timeout=60)
    assert rc == 0, err[-2000:]
    final = json.loads(out.split("final:", 1)[1])
    assert final["preempted"] and final["world"] == 2
    assert "preemption notice" in out


def _final(capsys):
    return json.loads(capsys.readouterr().out.split("final:", 1)[1])


def test_tpx_mesh_overrides_the_flag(monkeypatch, capsys):
    """$TPX_MESH (an elastic reshape's shape) wins over --mesh: --mesh
    fsdp=2 cannot resolve on one rank, TPX_MESH's fsdp=-1 can."""
    argv = ["--config", "tiny", "--batch", "2", "--seq", "16", "--steps", "1",
            "--device", "cpu", "--mesh", "fsdp=2"]
    with pytest.raises(ValueError, match="needs 2 devices"):
        ttrain.main(argv)
    monkeypatch.setenv("TPX_MESH", "dp=1,fsdp=-1")
    ttrain.main(argv)
    final = _final(capsys)
    assert final["world"] == 1 and final["backend"] == "gloo"
    assert final["mesh"] == "pp=1,dp=1,fsdp=1,ep=1,tp=1,sp=1"
    assert not torch.distributed.is_initialized()  # the world-1 group is gone


def test_no_mesh_no_group_is_the_single_device_path(capsys):
    ttrain.main(["--config", "tiny", "--batch", "2", "--seq", "16", "--steps", "1",
                 "--device", "cpu"])
    final = _final(capsys)
    assert (final["world"], final["mesh"], final["backend"]) == (1, None, None)


def test_world_one_mesh_is_bitwise_the_single_device_step():
    """At a world of one the sharded path (gathers and reduce-scatters of
    one, the buckets off for a dp of one) changes no bit."""
    runs = []
    for mesh in (None, "fsdp=-1"):
        box = {}
        out = ttrain.train(
            gang.tiny(), batch=2, seq=32, steps=3, warmup=1, device="cpu", kernels="cuda",
            log_every=0, mesh=mesh, grad_bucket_mb=4 if mesh else 0,
            on_state=lambda e, s, box=box: box.update(
                {k: v.clone() for k, v in s.items()}) if e == "final" else None,
        )
        runs.append((out, box))
    (a, sa), (b, sb) = runs
    assert a["losses"] == b["losses"] and a["grad_norms"] == b["grad_norms"]
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert b["launches_by_rank"] == [b["launches"]]


@pytest.mark.parametrize("kw,match", [
    ({"mesh": "tp=3"}, "item 1.2"),  # the tiny config's 2 KV heads
    ({"mesh": "sp=3"}, "item 1.2"),  # a 16-token sequence
    ({"mesh": "tp=2", "int8": True}, "item 1.2"),
    ({"mesh": "ep=4,tp=2", "config": "moe_tiny"}, "item 1.2"),  # 8 ranks for 4 experts
    ({"mesh": "ep=3", "config": "moe_tiny"}, "item 1.2"),
    # pp is ported (tests/test_torch_pp.py): the tiny config's 2 layers do
    # not split over 4 stages, which the reference refuses too
    pytest.param({"mesh": "pp=4"}, "2 layers not divisible by 4 stages", id="kw5-item 1.4"),
    ({"grad_bucket_mb": 4}, "give --mesh"),
])
def test_what_is_not_ported_raises(kw, match):
    cfg = ttrain.int8_config(tllama.get_config(kw.pop("config", "tiny")), kw.pop("int8", False))
    with pytest.raises((NotImplementedError, ValueError), match=match):
        ttrain.train(cfg, batch=2, seq=16, steps=1, device="cpu", log_every=0, **kw)
    assert not torch.distributed.is_initialized()
