"""The model axes ``tp`` and ``sp`` of the port's trainer as a gang on the
CPU, held to the JAX trainer on the same mesh.

``llama_tiny`` (4/2 heads, ffn 128, vocab 512, f32) with its embedding
tied: 4 steps of the JAX trainer's ``make_train_step`` on a CPU mesh
(conftest gives JAX 8 devices) and of the port's on gloo ranks through
``spmd_main``, from one JAX init and the same batches, at ``tp=2``,
``sp=2``, ``fsdp=2,tp=2`` and ``dp=2,sp=2``: losses and every parameter
shard within 1e-4 (``JAX_TOL`` of ``tests/test_torch_fsdp.py``), the tied
embedding included; the masked loss under ``sp=2`` (untied) alike. Then
the trainer on the ``tiny`` preset (untied) at those meshes against the
single-device trainer, its profiled runs' ``grad_sync`` slices per live
axis carrying the JAX cost model's bytes, and the autograd functions of
``parallel/mesh.py`` on two ranks, forward and backward exact against the
same arithmetic in one process.

One world-2 and one world-4 gang run all their cases
(``tests/torch_gang_cases.py``) while this process computes the JAX steps.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

import torch_gang_cases as gang
from torchx_tpu.analyze import costmodel as jcost
from torchx_tpu.analyze import plan as jplan
from torchx_tpu.examples import train_llama as jtrain
from torchx_tpu.models import llama as jllama
from torchx_tpu.parallel import mesh as jmesh_lib
from torchx_tpu_torch.analyze import costmodel as tcost
from torchx_tpu_torch.examples import train_llama as ttrain
from torchx_tpu_torch.models import llama as tllama
from torchx_tpu_torch.parallel.mesh import Mesh
from torchx_tpu_torch.parallel.mesh import shard as shard_of
from torchx_tpu_torch.parallel.mesh_config import AXES, parse_mesh_spec
from torch_threads import xdist_torch_threads  # noqa: F401

#: make_train_step on JAX-initialized weights: the trainer's lr, warmup 2
STEP = dict(lr=3e-4, warmup=2)
JAX_TOL = 1e-4
#: the trainer at a mesh against one device (tests/test_torch_fsdp.py's)
TOL = 1e-5
TRAIN = dict(kind="train", config="tiny", batch=4, seq=32, steps=3, warmup=1)
#: the meshes, by world
MESHES = {"tp=2": 2, "sp=2": 2, "fsdp=2,tp=2": 4, "dp=2,sp=2": 4}


def _jax_cfg(tie: bool):
    return jllama.llama_tiny(kernels="reference", tie_embeddings=tie)


def _write_init(path, tie: bool):
    p_j = jllama.init_params(_jax_cfg(tie), jax.random.PRNGKey(70))
    flat = {"/".join(str(k.key) for k in kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(p_j)[0]}
    np.savez(path, **flat)
    return jax.tree.map(np.asarray, p_j)


def _write_batches(path, steps, mask):
    rng = np.random.default_rng(71)
    arrays = {"tokens": rng.integers(0, 512, (steps, 4, 33)).astype(np.int32)}
    if mask:
        arrays["loss_mask"] = (rng.random((steps, 4, 33)) < 0.7).astype(np.float32)
    np.savez(path, **arrays)
    return arrays


def _jax_steps(p_host, tie, spec, batches):
    """The JAX trainer's make_train_step on the mesh ``spec`` over the
    first devices. -> (losses, the final parameters as whole tensors)."""
    sizes = parse_mesh_spec(spec).resolve(MESHES[spec])
    mesh = jmesh_lib.make_mesh(jmesh_lib.MeshConfig(**sizes),
                               devices=jax.devices()[:MESHES[spec]])
    cfg = _jax_cfg(tie)
    params = jllama.shard_params(jax.tree.map(jnp.asarray, p_host), cfg, mesh)
    opt = jtrain.make_optimizer(**STEP)
    state = jtrain.TrainState(params=params, opt_state=opt.init(params),
                              step=jnp.zeros((), jnp.int32))
    step = jtrain.make_train_step(cfg, mesh, opt)
    losses = []
    for i in range(batches["tokens"].shape[0]):
        batch = {k: jax.device_put(v[i], NamedSharding(mesh, jmesh_lib.BATCH_SPEC))
                 for k, v in batches.items()}
        state, loss, _ = step(state, batch)
        losses.append(float(loss))
    whole = {f"params.{'.'.join(str(k.key) for k in kp)}": torch.from_numpy(np.array(v))
             for kp, v in jax.tree_util.tree_flatten_with_path(state.params)[0]}
    return losses, whole


def _token_file(path):
    np.random.default_rng(72).integers(0, 512, 8192, dtype=np.uint32).tofile(path)
    return str(path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    p_tied = _write_init(tmp / "tied.npz", tie=True)
    p_untied = _write_init(tmp / "untied.npz", tie=False)
    batches = {"jax": _write_batches(tmp / "jax.npz", 4, mask=False),
               "mask": _write_batches(tmp / "mask.npz", 3, mask=True)}
    data = _token_file(tmp / "tokens.bin")

    def step(spec, tie=True, name=None, which="jax"):
        return dict(name=name or f"step {spec}", kind="step", mesh=spec, kernels="reference",
                    model={"tie_embeddings": tie}, init=str(tmp / ("tied.npz" if tie else
                                                                  "untied.npz")),
                    batches=str(tmp / f"{which}.npz"), **STEP)

    def train(spec, **kw):
        return dict(name=f"train {spec}", mesh=spec, data=data, profile=True, **TRAIN, **kw)

    cases = {2: [step("tp=2"), step("sp=2"), step("sp=2", tie=False, name="mask", which="mask"),
                 dict(name="collectives", kind="collectives"), train("tp=2"), train("sp=2")],
             4: [step("fsdp=2,tp=2"), step("dp=2,sp=2"), train("fsdp=2,tp=2"),
                 train("dp=2,sp=2", grad_bucket_mb=1)]}
    procs = [gang.run_cases(tmp, n, c, {"TPX_OBS_DIR": str(tmp / f"obs{n}")})
             for n, c in cases.items()]
    # the JAX steps while the gangs run, side by side (XLA compiles them)
    with ThreadPoolExecutor(5) as pool:
        futures = {spec: pool.submit(_jax_steps, p_tied, True, spec, batches["jax"])
                   for spec in MESHES}
        futures["mask"] = pool.submit(_jax_steps, p_untied, False, "sp=2", batches["mask"])
        jax_runs = {k: f.result() for k, f in futures.items()}
    for rc, out, err in gang.finish(procs):
        assert rc == 0, (out[-3000:], err[-3000:])
    return {"jax": jax_runs, "data": data, 2: gang.load_results(tmp, 2),
            4: gang.load_results(tmp, 4)}


def _mesh_at(spec: str, world: int, rank: int) -> Mesh:
    sizes = parse_mesh_spec(spec).resolve(world)
    coords = np.unravel_index(rank, [sizes[a] for a in AXES])
    return Mesh(None, sizes, {a: int(c) for a, c in zip(AXES, coords)}, None, None,
                "gloo")


def _assert_shards_match(results, whole, spec, tie, tol):
    specs = dict(tllama.named_leaves(tllama.param_specs(tllama.llama_tiny(
        tie_embeddings=tie))))
    assert {name for res in results for name in res["params"]} == set(whole)
    for rank, res in enumerate(results):
        mesh = _mesh_at(spec, len(results), rank)
        for name, got in res["params"].items():
            want = shard_of(whole[name], specs[name[len("params."):]], mesh)
            torch.testing.assert_close(got, want, rtol=tol, atol=tol,
                                       msg=lambda m: f"rank {rank} {name}: {m}")


@pytest.mark.parametrize("spec", list(MESHES))
def test_matches_the_jax_step_on_the_same_mesh(runs, spec):
    """4 steps from one JAX init (tied embedding): every rank's losses and
    its shard of every parameter within 1e-4 of the JAX trainer's on the
    same mesh."""
    losses, whole = runs["jax"][spec]
    results = [r[f"step {spec}"] for r in runs[MESHES[spec]]]
    for res in results:
        np.testing.assert_allclose(res["losses"], losses, rtol=JAX_TOL, atol=JAX_TOL)
    _assert_shards_match(results, whole, spec, True, JAX_TOL)


def test_masked_loss_under_sp_matches_the_jax_step(runs):
    """A loss_mask under sp=2 (untied head): the kept targets are counted
    over the ranks that split the tokens, as the JAX step counts them."""
    losses, whole = runs["jax"]["mask"]
    results = [r["mask"] for r in runs[2]]
    for res in results:
        np.testing.assert_allclose(res["losses"], losses, rtol=JAX_TOL, atol=JAX_TOL)
    _assert_shards_match(results, whole, "sp=2", False, JAX_TOL)


@pytest.fixture(scope="module")
def single_device(runs):
    box = {}

    def on_state(event, state):
        if event == "final":
            box.update({k: v.detach().clone() for k, v in state.items()
                        if k.startswith("params.")})

    kw = {k: v for k, v in TRAIN.items() if k not in ("kind", "config")}
    out = ttrain.train(tllama.llama_tiny(), data_path=runs["data"], prefetch=0,
                       kernels="cuda", device="cpu", log_every=0, on_state=on_state, **kw)
    return out, box


@pytest.mark.parametrize("spec", list(MESHES))
def test_the_trainer_at_a_model_mesh_is_one_device(runs, single_device, spec):
    """The trainer (tiny preset, untied head, a token file): every rank's
    losses, gradient norms and shards after 3 steps within 1e-5 of the
    single-device trainer, and the same loss on every rank."""
    ref, whole = single_device
    results = [r[f"train {spec}"] for r in runs[MESHES[spec]]]
    for res in results:
        assert res["mesh"] == ",".join(f"{a}={v}" for a, v in
                                       parse_mesh_spec(spec).resolve(len(results)).items())
        assert res["losses"] == results[0]["losses"]
        np.testing.assert_allclose(res["losses"], ref["losses"], rtol=TOL)
        np.testing.assert_allclose(res["grad_norms"], ref["grad_norms"], rtol=TOL)
    _assert_shards_match(results, whole, spec, False, TOL)


@pytest.mark.parametrize("spec", list(MESHES))
def test_a_profiled_gang_has_a_grad_sync_slice_per_live_axis(runs, spec):
    """Rank 0's profile carries grad_sync for each live axis, modeled from
    the JAX cost model's bytes at the run's batch and sequence."""
    prof = runs[MESHES[spec]][0][f"train {spec}"]["profile"]
    sizes = {a: n for a, n in parse_mesh_spec(spec).resolve(MESHES[spec]).items() if n > 1}
    assert set(prof["grad_sync_seconds"]) == set(sizes)
    plan = jplan.ParallelPlan(role="train", model=jplan.MODEL_SHAPES["tiny"], mesh_spec=spec,
                              sizes=sizes, batch=TRAIN["batch"], seq=TRAIN["seq"])
    want = {t.axis: t.bytes_per_step for t in jcost.collective_traffic(plan)}
    modeled = prof["meta"]["comm_modeled_axis_s"]
    assert {a: round(s * tcost.DEFAULT_LINK_BYTES_PER_S) for a, s in modeled.items()} == want


def _expected(name, inputs):
    """What the named function gives on two ranks, reckoned in one
    process from both ranks' inputs: [(output, input gradient)] by rank."""
    x = [i["x"] for i in inputs]
    whole = inputs[0]["whole"]
    if name == "copy_to_tp":  # identity; the gradient summed
        return [(x[r], inputs[0]["g"] + inputs[1]["g"]) for r in range(2)]
    if name == "reduce_from_tp":  # summed; the gradient passed through
        return [(x[0] + x[1], inputs[r]["g"]) for r in range(2)]
    if name == "max_over_tp":
        return [(torch.maximum(x[0], x[1]), None) for r in range(2)]
    if name == "tp_block":  # a block; the blocks' gradients gathered
        g = torch.cat([inputs[0]["g_block"], inputs[1]["g_block"]], dim=1)
        return [(whole[:, 3 * r:3 * r + 3], g) for r in range(2)]
    if name == "gather_sequence":  # gathered; the gradient reduce-scattered
        g = inputs[0]["g_whole"] + inputs[1]["g_whole"]
        return [(torch.cat(x, dim=1), g[:, 6 * r:6 * r + 6]) for r in range(2)]
    assert name == "sequence_block"  # a block; the gradient padded with zeros
    out = []
    for r in range(2):
        g = torch.zeros_like(whole)
        g[:, 3 * r:3 * r + 3] = inputs[r]["g_block"]
        out.append((whole[:, 3 * r:3 * r + 3], g))
    return out


@pytest.mark.parametrize("name", ["copy_to_tp", "reduce_from_tp", "tp_block", "max_over_tp",
                                  "gather_sequence", "sequence_block"])
def test_the_model_axes_collectives_are_their_arithmetic(runs, name):
    """Forward and backward of each autograd function on two gloo ranks,
    bitwise the same arithmetic on both ranks' inputs in one process."""
    inputs = [gang.collective_inputs(r) for r in range(2)]
    for rank, (y, grad) in enumerate(_expected(name, inputs)):
        got = runs[2][rank]["collectives"][name]
        assert torch.equal(got["y"], y), (rank, "forward")
        assert (got["grad"] is None) if grad is None else torch.equal(got["grad"], grad), \
            (rank, "backward")
