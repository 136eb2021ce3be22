"""Expert parallelism (the ``ep`` mesh axis) of the port's trainer as a gang
on the CPU, held to the JAX trainer on the same mesh.

``moe_tiny`` (4 experts, top 2, 4/2 heads, ffn 128, vocab 512, f32): 4
steps of the JAX trainer's ``make_train_step`` on a CPU mesh (conftest
gives JAX 8 devices) and of the port's on gloo ranks through ``spmd_main``,
from one JAX init and the same batches, at ``ep=2``, ``fsdp=2``,
``ep=2,tp=2``, ``fsdp=2,ep=2`` and ``ep=2,sp=2``, and with
``capacity_factor=0.5``, where tokens are dropped, at ``ep=2,sp=2`` (the
capacity slots must be the whole row's), ``fsdp=2,ep=2`` and ``ep=4`` (one
expert a rank): losses and every parameter shard
within 1e-4 (``JAX_TOL`` of ``tests/test_torch_fsdp.py``), the router and
every expert block included, and each step's router aux vector within
1e-5. Then, against the single-device trainer, bitwise: the dense ``tiny``
preset at ``ep=2`` (every leaf replicated over ``ep``) and ``moe_tiny`` at
a world of one through ``spmd_main``. Checkpoints: a MoE gang saved at
``fsdp=2,ep=2`` restores bitwise at ``ep=2`` and in one process, one saved
at ``ep=2`` restores bitwise at ``fsdp=2,ep=2``, and the JAX launcher's
``verify_checkpoint`` accepts each step. What ``ep`` cannot split raises.

One world-1, one world-2 and one world-4 gang run all their cases side by
side (``tests/torch_gang_cases.py``): each gang saves first and then
restores the other's step, while this process computes the JAX steps.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

import torch_gang_cases as gang
from torchx_tpu.apps import eval_main as jeval
from torchx_tpu.examples import train_llama as jtrain
from torchx_tpu.models import llama as jllama
from torchx_tpu.models import moe as jmoe
from torchx_tpu.parallel import mesh as jmesh_lib
from torchx_tpu_torch.examples import train_llama as ttrain
from torchx_tpu_torch.models import llama as tllama
from torchx_tpu_torch.models import moe as tmoe
from torchx_tpu_torch.parallel.checkpoint import Checkpointer
from torchx_tpu_torch.parallel.mesh import Mesh
from torchx_tpu_torch.parallel.mesh import shard as shard_of
from torchx_tpu_torch.parallel.mesh_config import AXES, parse_mesh_spec
from torch_threads import xdist_torch_threads  # noqa: F401

#: make_train_step on JAX-initialized weights: the trainer's lr, warmup 2
STEP = dict(lr=3e-4, warmup=2)
JAX_TOL = 1e-4
#: the router's aux vector (balance, entropy, overflow) against JAX's, f32
AUX_TOL = 1e-5
#: the JAX comparisons, by name: (mesh, world, capacity factor)
MESHES = {"ep=2": ("ep=2", 2, 2.0), "fsdp=2": ("fsdp=2", 2, 2.0),
          "ep=2,tp=2": ("ep=2,tp=2", 4, 2.0), "fsdp=2,ep=2": ("fsdp=2,ep=2", 4, 2.0),
          "ep=2,sp=2": ("ep=2,sp=2", 4, 2.0), "drops ep=2,sp=2": ("ep=2,sp=2", 4, 0.5),
          "drops fsdp=2,ep=2": ("fsdp=2,ep=2", 4, 0.5), "drops ep=4": ("ep=4", 4, 0.5)}
#: the trainer's cases: a token file, 3 steps
TRAIN = dict(kind="train", batch=4, seq=32, steps=3, warmup=1)
#: the checkpointing gangs' meshes, by world
SAVED = {2: "ep=2", 4: "fsdp=2,ep=2"}


def _write_init(path):
    p_j = jmoe.init_params(jmoe.moe_tiny(kernels="reference"), jax.random.PRNGKey(90))
    flat = {"/".join(str(k.key) for k in kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(p_j)[0]}
    np.savez(path, **flat)
    return jax.tree.map(np.asarray, p_j)


def _write_batches(path, steps):
    rng = np.random.default_rng(91)
    arrays = {"tokens": rng.integers(0, 512, (steps, 4, 33)).astype(np.int32)}
    np.savez(path, **arrays)
    return arrays


def _jax_steps(p_host, name, batches):
    """The JAX trainer's make_train_step on the mesh of ``name`` over the
    first devices. -> (losses, aux vectors, the final parameters whole)."""
    spec, world, cf = MESHES[name]
    sizes = parse_mesh_spec(spec).resolve(world)
    mesh = jmesh_lib.make_mesh(jmesh_lib.MeshConfig(**sizes), devices=jax.devices()[:world])
    cfg = jmoe.moe_tiny(kernels="reference", capacity_factor=cf)
    # make_train_step donates its state: a fresh copy of the host init
    params = jmoe.shard_params(jax.tree.map(jnp.asarray, p_host), cfg, mesh)
    opt = jtrain.make_optimizer(**STEP)
    state = jtrain.TrainState(params=params, opt_state=opt.init(params),
                              step=jnp.zeros((), jnp.int32))
    step = jtrain.make_train_step(cfg, mesh, opt)
    losses, auxes = [], []
    for i in range(batches["tokens"].shape[0]):
        batch = {k: jax.device_put(v[i], NamedSharding(mesh, jmesh_lib.BATCH_SPEC))
                 for k, v in batches.items()}
        state, loss, aux = step(state, batch)
        losses.append(float(loss))
        auxes.append(np.asarray(aux).tolist())
    whole = {f"params.{'.'.join(str(k.key) for k in kp)}": torch.from_numpy(np.array(v))
             for kp, v in jax.tree_util.tree_flatten_with_path(state.params)[0]}
    return losses, auxes, whole


def _token_file(path):
    np.random.default_rng(92).integers(0, 512, 8192, dtype=np.uint32).tofile(path)
    return str(path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ep")
    p_host = _write_init(tmp / "init.npz")
    batches = _write_batches(tmp / "jax.npz", 4)
    data = _token_file(tmp / "tokens.bin")

    def step(name):
        spec, _, cf = MESHES[name]
        return dict(name=name, kind="step", mesh=spec, kernels="reference", config="moe_tiny",
                    model={"capacity_factor": cf}, init=str(tmp / "init.npz"),
                    batches=str(tmp / "jax.npz"), **STEP)

    def save(world):
        return dict(name="save", mesh=SAVED[world], config="moe_tiny", data=data,
                    ckpt_dir=str(tmp / f"ck{world}"), done=str(tmp / f"saved{world}"), **TRAIN)

    def restore(world, other):
        return dict(name="restore", mesh=SAVED[world], config="moe_tiny", data=data,
                    after=str(tmp / f"saved{other}"), copy_from=str(tmp / f"ck{other}"),
                    ckpt_dir=str(tmp / f"ck{other}_at{world}"), **{**TRAIN, "steps": 1})

    cases = {
        1: [dict(name="moe world 1", mesh="fsdp=-1", config="moe_tiny", data=data, **TRAIN)],
        2: [save(2), step("ep=2"), step("fsdp=2"),
            dict(name="dense ep=2", mesh="ep=2", config="tiny", data=data, **TRAIN),
            restore(2, 4)],
        4: [save(4), *(step(n) for n in MESHES if MESHES[n][1] == 4), restore(4, 2)],
    }
    procs = [gang.run_cases(tmp, n, c) for n, c in cases.items()]
    # the JAX steps while the gangs run, side by side (XLA compiles them)
    with ThreadPoolExecutor(len(MESHES)) as pool:
        futures = {name: pool.submit(_jax_steps, p_host, name, batches) for name in MESHES}
        jax_runs = {k: f.result() for k, f in futures.items()}
    for rc, out, err in gang.finish(procs):
        assert rc == 0, (out[-3000:], err[-3000:])
    return {"tmp": tmp, "jax": jax_runs, "data": data,
            **{n: gang.load_results(tmp, n) for n in cases}}


def _mesh_at(spec: str, world: int, rank: int) -> Mesh:
    sizes = parse_mesh_spec(spec).resolve(world)
    coords = np.unravel_index(rank, [sizes[a] for a in AXES])
    return Mesh(None, sizes, {a: int(c) for a, c in zip(AXES, coords)}, None, None,
                "gloo")


def _specs(config="moe_tiny"):
    return ttrain.checkpoint_specs(tllama.get_config(config))


def _assert_blocks(results, whole, spec, key, tol=None, config="moe_tiny"):
    """Every rank's ``key`` entries against their blocks of ``whole``:
    within ``tol``, or bitwise."""
    specs = _specs(config)
    for rank, res in enumerate(results):
        mesh = _mesh_at(spec, len(results), rank)
        assert set(res[key]) <= set(whole) and res[key]
        for name, got in res[key].items():
            want = shard_of(whole[name], specs.get(name, (None,) * got.dim()), mesh)
            if tol is None:
                assert torch.equal(got, want), (rank, name)
            else:
                torch.testing.assert_close(got, want, rtol=tol, atol=tol,
                                           msg=lambda m: f"rank {rank} {name}: {m}")


@pytest.mark.parametrize("name", list(MESHES))
def test_matches_the_jax_step_on_the_same_mesh(runs, name):
    """4 steps from one JAX init: every rank's losses and its shard of
    every parameter (the router and each expert block included) within
    1e-4 of the JAX trainer's on the same mesh, and each step's router aux
    vector within 1e-5. With capacity factor 0.5 the JAX run drops more
    than a tenth of the routings, so that the comparison holds the port to
    the whole row's capacity slots (under sp, each rank's slots after the
    earlier ranks')."""
    spec, world, cf = MESHES[name]
    losses, auxes, whole = runs["jax"][name]
    if cf < 1:
        assert min(a[tllama.AUX_OVERFLOW] for a in auxes) > 0.1, auxes
    results = [r[name] for r in runs[world]]
    for res in results:
        np.testing.assert_allclose(res["losses"], losses, rtol=JAX_TOL, atol=JAX_TOL)
        np.testing.assert_allclose(res["auxes"], auxes, rtol=AUX_TOL, atol=AUX_TOL)
    assert {n for res in results for n in res["params"]} == set(whole)
    _assert_blocks(results, whole, spec, "params", JAX_TOL)


def _single_device(data, config, ckpt_dir=None, steps=TRAIN["steps"]):
    box = {}

    def on_state(event, state):
        if event == ("restored" if ckpt_dir else "final"):
            box.update({k: v.detach().clone() for k, v in state.items()})

    out = ttrain.train(tllama.get_config(config), TRAIN["batch"], TRAIN["seq"], steps,
                       warmup=TRAIN["warmup"], data_path=data, prefetch=0, kernels="cuda",
                       device="cpu", log_every=0, on_state=on_state, ckpt_dir=ckpt_dir)
    return out, box


@pytest.mark.parametrize("name,config,world", [("dense ep=2", "tiny", 2),
                                               ("moe world 1", "moe_tiny", 1)])
def test_the_gang_is_bitwise_the_single_device_trainer(runs, name, config, world):
    """The dense preset at ep=2 (each rank computes the whole step, every
    leaf replicated over ep) and moe_tiny at a world of one through
    spmd_main: losses, gradient norms and every shard bitwise the
    single-device trainer's."""
    ref, whole = _single_device(runs["data"], config)
    results = [r[name] for r in runs[world]]
    for res in results:
        assert res["world"] == world
        assert res["losses"] == ref["losses"] and res["grad_norms"] == ref["grad_norms"]
    whole = {k: v for k, v in whole.items() if k.startswith("params.")}
    assert set(results[0]["params"]) == set(whole)
    _assert_blocks(results, whole, results[0]["mesh"], "params", config=config)


@pytest.mark.parametrize("saved,restored", [(4, 2), (2, 4), (4, 1)],
                         ids=["fsdp=2,ep=2 at ep=2", "ep=2 at fsdp=2,ep=2",
                              "fsdp=2,ep=2 in one process"])
def test_a_moe_step_restores_bitwise_at_another_mesh(runs, saved, restored, tmp_path):
    """A step saved by a MoE gang: every restored block (parameters and
    both moments, expert blocks included) bitwise its slice of the whole
    state that a reader without a mesh assembles, and the saving ranks'
    final shards bitwise the step's blocks; the JAX launcher's
    verify_checkpoint accepts the step."""
    import shutil

    d = str(runs["tmp"] / f"ck{saved}")
    step, _ = jeval.verify_checkpoint(d)
    assert step == TRAIN["steps"]
    whole = Checkpointer(d, read_only=True).restore(step)
    savers = [r["save"] for r in runs[saved]]
    assert all(r["final_step"] == step for r in savers)
    _assert_blocks(savers, whole, SAVED[saved], "params")
    if restored == 1:
        copy = str(tmp_path / "ck")
        shutil.copytree(d, copy)
        out, box = _single_device(runs["data"], "moe_tiny", ckpt_dir=copy, steps=1)
        results = [{"restored": box, "resumed_from_step": out["resumed_from_step"]}]
        spec = "fsdp=1"
    else:
        results = [r["restore"] for r in runs[restored]]
        spec = SAVED[restored]
        assert jeval.verify_checkpoint(str(runs["tmp"] / f"ck{saved}_at{restored}"))[0] \
            == step + 1
    for res in results:
        assert res["resumed_from_step"] == step and set(res["restored"]) == set(whole)
    _assert_blocks(results, whole, spec, "restored")


@pytest.mark.parametrize("mesh,match", [
    ("ep=4,tp=2", "item 1.2"), ("ep=3", "item 1.2"),
    # pp is ported (tests/test_torch_pp.py): what it cannot split, moe_tiny's
    # 2 layers over 4 stages, raises as the reference does
    pytest.param("pp=4", "2 layers not divisible by 4 stages", id="pp=2-item 1.4")])
def test_what_ep_cannot_split_raises(mesh, match):
    """ep x tp must divide moe_tiny's 4 experts (8 and 3 do not), and pp
    its 2 layers (4 does not). Each raises before a process group
    starts."""
    with pytest.raises((NotImplementedError, ValueError), match=match):
        ttrain.train(tmoe.moe_tiny(), batch=2, seq=16, steps=1, device="cpu", log_every=0,
                     mesh=mesh)
    assert not torch.distributed.is_initialized()


def test_param_specs_are_the_jax_trees():
    """The MoE specs equal the JAX package's ``moe.param_specs`` leaf for
    leaf, the experts over ("ep", "tp"); the dense ones its
    ``llama.param_specs``."""
    def jax_specs(tree):
        return {"/".join(str(k.key) for k in kp): tuple(v) for kp, v in
                jax.tree_util.tree_flatten_with_path(
                    tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]}

    for j, t in ((jmoe.param_specs(jmoe.moe_tiny()), tllama.param_specs(tmoe.moe_tiny())),
                 (jllama.param_specs(jllama.llama_tiny()),
                  tllama.param_specs(tllama.llama_tiny()))):
        assert {n.replace(".", "/"): s for n, s in tllama.named_leaves(t)} == jax_specs(j)
    assert tllama.param_specs(tmoe.moe_tiny())["layers"]["w_gate"][1] == ("ep", "tp")
