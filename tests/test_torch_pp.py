"""Pipeline parallelism (the ``pp`` mesh axis) of the port on gloo ranks,
held to the JAX package's pipeline and trainer.

* ``pipeline_apply`` on ``tests/test_pipeline_parallel.py``'s MLP body and
  aux body, inputs drawn from a seed with numpy, at ``pp=2`` and ``pp=4``
  (one microbatch too): the output within 1e-6 of JAX's, the gradients of
  the input and of every stage's layers within 1e-5, the aux within 1e-5.
* 4 steps of ``make_train_step`` from one JAX init at ``pp=2``,
  ``pp=2,fsdp=2``, ``pp=2,tp=2`` (``llama_tiny``, tied, f32) and for
  ``moe_tiny`` at ``pp=2``, ``pp=2,ep=2`` and ``pp=2,fsdp=2`` (capacity
  factor 0.5: tokens dropped; each data rank computes its block of JAX's
  microbatches, ``microbatch_rows``): losses and every parameter
  shard within 1e-4 of the JAX trainer's on the same mesh (the router's
  aux vector within 1e-5), the dense ones also of the port's single-device
  step (a MoE step's balance term is the microbatches' under ``pp``, as
  JAX's is, so not the whole batch's); after every step each stage holds
  the same embedding and final norm, bitwise.
* The remat policies at ``pp=2``: ``dots`` and ``dots_attn`` bitwise
  ``full``; ``"auto"`` resolved through the fit probe of the ``pp`` mesh.
* The trainer (``tiny``, a token file) at ``pp=2`` within 1e-5 of the
  single-device trainer; its checkpoint restores bitwise in one process,
  one saved at ``fsdp=2`` restores bitwise at ``pp=2``, and the JAX
  launcher's readers accept both steps. What ``pp`` cannot split raises.

One world-2 and one world-4 gang run all their cases
(``tests/torch_gang_cases.py``) while this process computes the JAX
references. The helpers of the JAX and single-device steps serve
``tests/test_torch_ring.py`` too.
"""

import shutil
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
from torchx_tpu.parallel.pipeline import make_pp_mesh
from torchx_tpu.parallel.pipeline import pipeline_apply as jpipeline_apply
from torchx_tpu_torch import convert
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
AUX_TOL = 1e-5
#: the trainer against one device (tests/test_torch_fsdp.py's)
TOL = 1e-5
#: family -> (JAX config, port config, fields of both)
FAMILIES = {"llama_tiny": (jllama.llama_tiny, tllama.llama_tiny, {"tie_embeddings": True}),
            "moe_tiny": (jmoe.moe_tiny, tmoe.moe_tiny, {})}
#: the steps held to JAX: name -> (family, mesh, world)
STEPS = {"pp=2": ("llama_tiny", "pp=2", 2), "pp=2,fsdp=2": ("llama_tiny", "pp=2,fsdp=2", 4),
         "pp=2,tp=2": ("llama_tiny", "pp=2,tp=2", 4), "moe pp=2": ("moe_tiny", "pp=2", 2),
         "moe pp=2,ep=2": ("moe_tiny", "pp=2,ep=2", 4),
         "moe pp=2,fsdp=2": ("moe_tiny", "pp=2,fsdp=2", 4)}
#: config fields of a step beside its family's (both sides): capacity
#: factor 0.5 drops tokens
STEP_FIELDS = {"moe pp=2,fsdp=2": {"capacity_factor": 0.5}}
#: pipeline_apply cases: name -> (op, stages, layers, width, rows, microbatches)
PIPES = {"mlp pp=2": ("pipeline", 2, 4, 8, 8, 4), "aux pp=2": ("pipeline_aux", 2, 8, 16, 16, 4),
         "mlp pp=4": ("pipeline", 4, 8, 16, 16, 4), "one microbatch pp=4": ("pipeline", 4, 4, 8, 4, 1),
         "aux pp=4": ("pipeline_aux", 4, 8, 16, 16, 4)}
TRAIN = dict(kind="train", config="tiny", batch=4, seq=32, steps=3, warmup=1)


# -- helpers, shared with tests/test_torch_ring.py ---------------------------


def _cfgs(family, **overrides):
    cfg_j, cfg_t, fields = FAMILIES[family]
    return cfg_j(kernels="reference", **fields, **overrides), cfg_t(**fields, **overrides)


def write_init(path, family):
    """JAX's init of ``family`` (seeded), saved by path; -> the host tree."""
    cfg_j, _ = _cfgs(family)
    init = jmoe.init_params if family == "moe_tiny" else jllama.init_params
    p_j = init(cfg_j, jax.random.PRNGKey(95))
    flat = {"/".join(str(k.key) for k in kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(p_j)[0]}
    np.savez(path, **flat)
    return jax.tree.map(np.asarray, p_j)


def write_batches(path, steps):
    tokens = np.random.default_rng(96).integers(0, 512, (steps, 4, 33)).astype(np.int32)
    np.savez(path, tokens=tokens)
    return {"tokens": tokens}


def jax_steps(p_host, family, spec, world, batches, overrides=None):
    """The JAX trainer's make_train_step on ``spec`` over the first
    ``world`` devices. -> (losses, aux vectors, the final parameters as
    whole tensors)."""
    sizes = parse_mesh_spec(spec).resolve(world)
    mesh = jmesh_lib.make_mesh(jmesh_lib.MeshConfig(**sizes), devices=jax.devices()[:world])
    cfg, _ = _cfgs(family, **(overrides or {}))
    shard = jmoe.shard_params if family == "moe_tiny" else jllama.shard_params
    params = shard(jax.tree.map(jnp.asarray, p_host), cfg, mesh)
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


def one_device_steps(init_path, family, batches, overrides=None):
    """The port's make_train_step on one device from the same init and
    batches. -> (losses, the final parameters by name)."""
    _, cfg = _cfgs(family, **(overrides or {}))
    init = np.load(init_path)
    tree = {}
    for path in init.files:
        node = tree
        *parents, key = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[key] = init[path]
    params = convert.params_from_jax(tree, cfg)
    opt = ttrain.make_optimizer(tllama.leaves(params), **STEP)
    step = ttrain.make_train_step(cfg, opt)
    losses = [float(step(params, {"tokens": torch.from_numpy(t)})["loss"])
              for t in batches["tokens"]]
    return losses, {f"params.{k}": v.detach() for k, v in tllama.named_leaves(params)}


def mesh_at(spec, world, rank):
    sizes = parse_mesh_spec(spec).resolve(world)
    coords = np.unravel_index(rank, [sizes[a] for a in AXES])
    return Mesh(None, sizes, {a: int(c) for a, c in zip(AXES, coords)}, None, None, "gloo")


def assert_shards_match(results, whole, spec, family, tol, key="params"):
    """Every rank's ``key`` shards against their blocks of ``whole`` under
    the mesh's specs (the layers over pp): within ``tol``, or bitwise."""
    _, cfg = _cfgs(family)
    specs = {}
    for rank, res in enumerate(results):
        mesh = mesh_at(spec, len(results), rank)
        if not specs:
            specs = ttrain.checkpoint_specs(cfg, mesh.sizes["pp"] > 1)
        assert set(res[key]) <= set(whole) and res[key]
        for name, got in res[key].items():
            want = shard_of(whole[name], specs.get(name, (None,) * got.dim()), mesh)
            if tol is None:
                assert torch.equal(got, want), (rank, name)
            else:
                torch.testing.assert_close(got, want, rtol=tol, atol=tol,
                                           msg=lambda m: f"rank {rank} {name}: {m}")


# -- the gangs -----------------------------------------------------------------


def _mlp_inputs(path, layers, width, rows):
    rng = np.random.default_rng(97 + layers + width)
    arrays = {"w": (rng.standard_normal((layers, width, width)) * 0.3).astype(np.float32),
              "b": (rng.standard_normal((layers, width)) * 0.1).astype(np.float32),
              "x": rng.standard_normal((rows, width)).astype(np.float32)}
    np.savez(path, **arrays)
    return arrays


def _jax_pipeline(op, stages, n_micro, arrays):
    """JAX's pipeline_apply on make_pp_mesh(stages): -> (output, aux,
    gradients of x, w and b) of the sum of the output's squares (plus the
    aux)."""
    mesh = make_pp_mesh(stages)
    with_aux = op == "pipeline_aux"

    def body(x, layer):
        y = jnp.tanh(x @ layer["w"] + layer["b"])
        return (y, jnp.mean(x)) if with_aux else y

    def run(x, params):
        return jpipeline_apply(body, params, x, mesh, n_microbatches=n_micro, with_aux=with_aux)

    def loss(x, params):
        out = run(x, params)
        return jnp.sum(out[0] ** 2) + out[1] if with_aux else jnp.sum(out ** 2)

    x = jnp.asarray(arrays["x"])
    params = {"w": jnp.asarray(arrays["w"]), "b": jnp.asarray(arrays["b"])}
    res = jax.jit(run)(x, params)
    out, aux = res if with_aux else (res, None)
    gx, gp = jax.grad(loss, argnums=(0, 1))(x, params)
    return (np.asarray(out), None if aux is None else float(aux),
            [np.asarray(gx), np.asarray(gp["w"]), np.asarray(gp["b"])])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pp")
    hosts = {f: write_init(tmp / f"{f}.npz", f) for f in FAMILIES}
    batches = write_batches(tmp / "batches.npz", 4)
    data = str(tmp / "tokens.bin")
    np.random.default_rng(98).integers(0, 512, 8192, dtype=np.uint32).tofile(data)
    pipes = {name: _mlp_inputs(tmp / f"{name}.npz", *case[2:5]) for name, case in PIPES.items()}

    def step(name, **model):
        family, spec, _ = STEPS.get(name, ("llama_tiny", name, 2))
        case = dict(name=name, kind="step", mesh=spec, kernels="reference",
                    init=str(tmp / f"{family}.npz"), batches=str(tmp / "batches.npz"), **STEP)
        if family == "moe_tiny":
            case["config"] = "moe_tiny"
            case["model"] = {**STEP_FIELDS.get(name, {}), **model}
        else:
            case["model"] = {"tie_embeddings": True, **model}
        return case

    def ops(name):
        op, stages, _, _, _, n_micro = PIPES[name]
        return dict(name=name, kind="ops", op=op, mesh=f"pp={stages},fsdp=1",
                    inputs=str(tmp / f"{name}.npz"), n_micro=n_micro)

    def train(name, mesh, **kw):
        return dict(name=name, mesh=mesh, data=data, **{**TRAIN, **kw})

    remat = [dict(step(f"pp=2 {p}", remat=True, remat_policy=p), mesh="pp=2")
             for p in ("full", "dots", "dots_attn")]
    cases = {
        2: [train("save pp=2", "pp=2", ckpt_dir=str(tmp / "ck_pp2")),
            train("save fsdp=2", "fsdp=2", ckpt_dir=str(tmp / "ck_fsdp2"),
                  done=str(tmp / "saved_fsdp2")),
            train("restore at pp=2", "pp=2", after=str(tmp / "saved_fsdp2"),
                  copy_from=str(tmp / "ck_fsdp2"), ckpt_dir=str(tmp / "ck_fsdp2_at_pp2"),
                  steps=1),
            step("pp=2"), step("moe pp=2"), *remat, ops("mlp pp=2"), ops("aux pp=2"),
            dict(kind="train", name="auto pp=2", mesh="pp=2", batch=2, seq=64, steps=2,
                 warmup=1, data=None, model=dict(remat=True, remat_policy="auto"))],
        4: [step("pp=2,fsdp=2"), step("pp=2,tp=2"), step("moe pp=2,ep=2"),
            step("moe pp=2,fsdp=2"), ops("mlp pp=4"),
            ops("one microbatch pp=4"), ops("aux pp=4")],
    }
    procs = [gang.run_cases(tmp, n, c) for n, c in cases.items()]
    with ThreadPoolExecutor(len(STEPS) + len(PIPES)) as pool:
        step_futures = {name: pool.submit(jax_steps, hosts[family], family, spec, world,
                                          batches, STEP_FIELDS.get(name))
                        for name, (family, spec, world) in STEPS.items()}
        pipe_futures = {name: pool.submit(_jax_pipeline, case[0], case[1], case[5], pipes[name])
                        for name, case in PIPES.items()}
        jax_runs = {k: f.result() for k, f in step_futures.items()}
        jax_pipes = {k: f.result() for k, f in pipe_futures.items()}
    one = one_device_steps(tmp / "llama_tiny.npz", "llama_tiny", batches)
    for rc, out, err in gang.finish(procs, timeout=420):
        assert rc == 0, (out[-3000:], err[-3000:])
    return {"tmp": tmp, "data": data, "jax": jax_runs, "pipes": jax_pipes, "one": one,
            **{n: gang.load_results(tmp, n) for n in cases}}


# -- the tests -------------------------------------------------------------------


@pytest.mark.parametrize("name", list(PIPES))
def test_pipeline_matches_the_jax_pipeline(runs, name):
    """Every stage returns the last stage's output (1e-6 of JAX's), the
    aux summed over the stages' layers and averaged over the microbatches
    (1e-5), the input's gradient (every stage: stage 0's, broadcast) and
    its own layers' gradients within 1e-5 of JAX's."""
    op, stages, layers, *_ = PIPES[name]
    out, aux, (gx, gw, gb) = runs["pipes"][name]
    for stage, res in enumerate(runs[stages]):
        got = res[name]
        np.testing.assert_allclose(got["out"].numpy(), out, atol=1e-6)
        if aux is not None:
            np.testing.assert_allclose(float(got["aux"]), aux, atol=AUX_TOL)
        blk = slice(stage * layers // stages, (stage + 1) * layers // stages)
        for g, want in zip(got["grads"], (gx, gw[blk], gb[blk])):
            np.testing.assert_allclose(g.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("name", list(STEPS))
def test_matches_the_jax_step_on_the_same_mesh(runs, name):
    """4 steps from one JAX init: every rank's losses and its shard of
    every parameter within 1e-4 of the JAX trainer's on the same mesh (a
    MoE step's router aux within 1e-5); the dense steps also of the
    single-device step."""
    family, spec, world = STEPS[name]
    losses, auxes, whole = runs["jax"][name]
    results = [r[name] for r in runs[world]]
    for res in results:
        np.testing.assert_allclose(res["losses"], losses, rtol=JAX_TOL, atol=JAX_TOL)
        if family == "moe_tiny":
            np.testing.assert_allclose(res["auxes"], auxes, rtol=AUX_TOL, atol=AUX_TOL)
    assert {n for res in results for n in res["params"]} == set(whole)
    assert_shards_match(results, whole, spec, family, JAX_TOL)
    if family == "llama_tiny":
        one_losses, one_whole = runs["one"]
        np.testing.assert_allclose(one_losses, losses, rtol=JAX_TOL, atol=JAX_TOL)
        assert_shards_match(results, one_whole, spec, family, JAX_TOL)


@pytest.mark.parametrize("name", list(STEPS))
def test_every_stage_holds_the_same_replicated_leaves(runs, name):
    """After every step the leaves outside the layers (the embedding, the
    final norm, an untied head) are bitwise the same on the ranks that
    differ only in their stage."""
    family, spec, world = STEPS[name]
    results = [r[name] for r in runs[world]]
    by_rest = {}
    for rank, res in enumerate(results):
        coords = mesh_at(spec, world, rank).coords
        by_rest.setdefault(tuple(v for a, v in coords.items() if a != "pp"), []).append(res)
    for group in by_rest.values():
        assert len(group) == 2
        a, b = group
        assert len(a["replicated"]) == 4
        for sa, sb in zip(a["replicated"], b["replicated"]):
            assert set(sa) == {"embed", "final_norm"} | (
                {"lm_head"} if family == "moe_tiny" else set())
            assert all(torch.equal(sa[k], sb[k]) for k in sa)


def test_remat_policies_are_bitwise_full_under_pp(runs):
    """At pp=2 (remat on), "dots" and "dots_attn" give "full"'s losses,
    gradient norms and every shard bitwise."""
    for r in runs[2]:
        full = r["pp=2 full"]
        for policy in ("dots", "dots_attn"):
            other = r[f"pp=2 {policy}"]
            assert other["losses"] == full["losses"], policy
            assert other["grad_norms"] == full["grad_norms"], policy
            for k, v in full["params"].items():
                assert torch.equal(other["params"][k], v), (policy, k)


def test_auto_resolves_through_the_probe_under_pp(runs):
    """--remat-policy auto at pp=2: rank 0's probe traces stage 0 of the
    pp mesh in a subprocess, and both stages train the policy it names."""
    auto = [r["auto pp=2"] for r in runs[2]]
    assert auto[0]["remat_policy"] == auto[1]["remat_policy"] == "dots_attn"
    assert auto[0]["remat_trials"] == auto[1]["remat_trials"]
    assert all(t["fits"] for t in auto[0]["remat_trials"])


def _single_device(data, ckpt_dir=None, steps=TRAIN["steps"]):
    box = {}

    def on_state(event, state):
        if event == ("restored" if ckpt_dir else "final"):
            box.update({k: v.detach().clone() for k, v in state.items()})

    out = ttrain.train(tllama.get_config("tiny"), TRAIN["batch"], TRAIN["seq"], steps,
                       warmup=TRAIN["warmup"], data_path=data, prefetch=0, kernels="cuda",
                       device="cpu", log_every=0, on_state=on_state, ckpt_dir=ckpt_dir)
    return out, box


def test_the_trainer_at_pp_is_one_device(runs):
    """The trainer (tiny preset, untied head, a token file) at pp=2: both
    ranks' losses, gradient norms and shards after 3 steps within 1e-5 of
    the single-device trainer's, and the same loss on both ranks."""
    ref, whole = _single_device(runs["data"])
    results = [r["save pp=2"] for r in runs[2]]
    for res in results:
        assert res["mesh"] == "pp=2,dp=1,fsdp=1,ep=1,tp=1,sp=1"
        assert res["losses"] == results[0]["losses"]
        np.testing.assert_allclose(res["losses"], ref["losses"], rtol=TOL)
        np.testing.assert_allclose(res["grad_norms"], ref["grad_norms"], rtol=TOL)
    whole = {k: v for k, v in whole.items() if k.startswith("params.")}
    for res, rank in zip(results, range(2)):
        specs = ttrain.checkpoint_specs(tllama.get_config("tiny"), pp=True)
        mesh = mesh_at("pp=2", 2, rank)
        for name, got in res["params"].items():
            torch.testing.assert_close(got, shard_of(whole[name], specs[name], mesh),
                                       rtol=TOL, atol=TOL)


def test_a_pp_step_restores_bitwise_in_one_process(runs, tmp_path):
    """The pp=2 gang's last step: each stage wrote its layers and stage 0
    the leaves outside them; one process restores every entry bitwise the
    whole state a reader without a mesh assembles, the saving ranks' final
    shards are its blocks, and the JAX launcher's readers accept it."""
    from torchx_tpu.supervisor.api import latest_checkpoint_step

    d = str(runs["tmp"] / "ck_pp2")
    step, _ = jeval.verify_checkpoint(d)
    assert step == TRAIN["steps"] == latest_checkpoint_step(d)
    whole = Checkpointer(d, read_only=True).restore(step)
    savers = [r["save pp=2"] for r in runs[2]]
    specs = ttrain.checkpoint_specs(tllama.get_config("tiny"), pp=True)
    for rank, res in enumerate(savers):
        mesh = mesh_at("pp=2", 2, rank)
        for name, got in res["params"].items():
            assert torch.equal(got, shard_of(whole[name], specs[name], mesh)), (rank, name)
    copy = str(tmp_path / "ck")
    shutil.copytree(d, copy)
    out, box = _single_device(runs["data"], ckpt_dir=copy, steps=1)
    assert out["resumed_from_step"] == step and set(box) == set(whole)
    for name, got in box.items():
        assert torch.equal(got, whole[name]), name


def test_an_fsdp_step_restores_bitwise_at_pp(runs):
    """A step saved at fsdp=2 restores into pp=2: every restored block
    (parameters and both moments) bitwise its slice of the whole state; the
    JAX launcher's verify_checkpoint accepts the step the pp gang then
    saved."""
    d = str(runs["tmp"] / "ck_fsdp2")
    step, _ = jeval.verify_checkpoint(d)
    whole = Checkpointer(d, read_only=True).restore(step)
    results = [r["restore at pp=2"] for r in runs[2]]
    for res in results:
        assert res["resumed_from_step"] == step
    assert_shards_match(results, whole, "pp=2", "llama_tiny", None, key="restored")
    assert jeval.verify_checkpoint(str(runs["tmp"] / "ck_fsdp2_at_pp2"))[0] == step + 1


@pytest.mark.parametrize("rows,data_size,n_micro", [(2, 2, 2), (4, 2, 4), (6, 3, 2),
                                                     (8, 4, 2), (4, 2, 1)])
def test_microbatch_rows_are_blocks_of_the_reference_microbatches(rows, data_size, n_micro):
    """Under pp a MoE step's data ranks compute the rows of
    ``microbatch_rows``: every row of the batch once, and rank r's
    microbatch m is block r of the reference's microbatch m, rows m * mb to
    (m + 1) * mb of the whole batch."""
    from torchx_tpu_torch.parallel.pipeline import microbatch_rows

    by_rank = [microbatch_rows(rows, data_size, r, n_micro) for r in range(data_size)]
    assert sorted(torch.cat(by_rank).tolist()) == list(range(rows * data_size))
    mb = rows * data_size // n_micro
    for m in range(n_micro):
        blocks = [idx.chunk(n_micro)[m].tolist() for idx in by_rank]
        assert sum(blocks, []) == list(range(m * mb, (m + 1) * mb))


@pytest.mark.parametrize("spec,microbatches,match", [
    ("pp=4", 0, "2 layers not divisible by 4 stages"),
    ("pp=2", 3, "batch 4 not divisible by 3 microbatches"),
    ("pp=2,fsdp=2", 4, "batch 2 not divisible by 4 microbatches"),
])
def test_what_pp_cannot_split_raises(spec, microbatches, match):
    """The reference's two refusals: layers that pp does not divide (the
    trainer raises before a process group starts), and a rank's rows that
    the microbatches do not divide."""
    cfg = tllama.llama_tiny(pp_microbatches=microbatches)
    sizes = parse_mesh_spec(spec).resolve(int(np.prod([int(a.split("=")[1])
                                                       for a in spec.split(",")])))
    with pytest.raises(ValueError, match=match):
        ttrain.check_model_axes(cfg, sizes, 16, batch=4)
    if not microbatches:
        with pytest.raises(ValueError, match=match):
            ttrain.train(cfg, batch=4, seq=16, steps=1, device="cpu", log_every=0, mesh=spec)
        assert not torch.distributed.is_initialized()
