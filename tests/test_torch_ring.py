"""Ring attention and Ulysses attention of the port on gloo ranks, held to
the JAX package's, and the trainer with ``--ring-attention`` held to the
JAX trainer on the same mesh.

* ``ring_attention`` and ``ulysses_attention`` on the inputs of the JAX
  package's ``TestRingAttention`` shape (b 4, s 32, 8/4 heads, d 16),
  drawn from a seed with numpy, at ``sp=2`` and ``sp=4``: every rank's
  output positions and the gradient of its q, k and v against JAX's
  (``jax.grad`` of the same sum of squares, under a mesh of the same
  ``sp``) at ``tests/test_model_stack.py``'s tolerances: 2e-5 forward and
  1e-4 gradients for the ring, 1e-6 / 1e-5 for Ulysses.
* 4 steps of the port's ``make_train_step`` (``llama_tiny``, tied, f32)
  with ``use_ring_attention`` at ``sp=2`` and ``pp=2,sp=2``: losses and
  every parameter shard within 1e-4 of the JAX trainer's on the same mesh
  and of the port's single-device step.
* Ulysses refuses heads that ``sp x tp`` does not divide; under
  ``"dots_attn"`` a layer saves the ring's output, as JAX names it.

One world-2 and one world-4 gang run all their cases
(``tests/torch_gang_cases.py``) while this process computes the JAX
references.
"""

import collections
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_gang_cases as gang
from test_torch_pp import (JAX_TOL, STEP, assert_shards_match, jax_steps, one_device_steps,
                           write_batches, write_init)
from torchx_tpu.ops.attention import xla_attention as jxla_attention
from torchx_tpu.ops.ring_attention import ring_attention as jring
from torchx_tpu.ops.ulysses import ulysses_attention as julysses
from torchx_tpu.parallel import mesh as jmesh_lib
from torchx_tpu_torch.models import llama as tllama
from torchx_tpu_torch.ops.ulysses import ulysses_attention
from torchx_tpu_torch.parallel import aot_fit
from torchx_tpu_torch.parallel.mesh import Mesh
from torchx_tpu_torch.parallel.mesh_config import AXES, parse_mesh_spec
from torch_threads import xdist_torch_threads  # noqa: F401

#: tests/test_model_stack.py's: (forward, gradient) by op
TOLS = {"ring": (2e-5, 1e-4), "ulysses": (1e-6, 1e-5)}
SHAPE = dict(b=4, s=32, h=8, kvh=4, d=16)
#: the ring's trainer steps: mesh -> world
MESHES = {"sp=2": 2, "pp=2,sp=2": 4}


def _write_qkv(path):
    rng = np.random.default_rng(80)
    b, s, h, kvh, d = SHAPE.values()
    arrays = {"q": rng.standard_normal((b, s, h, d)).astype(np.float32),
              "k": rng.standard_normal((b, s, kvh, d)).astype(np.float32),
              "v": rng.standard_normal((b, s, kvh, d)).astype(np.float32)}
    np.savez(path, **arrays)
    return arrays


def _jax_op(op, n, qkv):
    """JAX's op at sp=n over the first n devices: -> (output, (dq, dk, dv))
    of the sum of the output's squares."""
    mesh = jmesh_lib.make_mesh(jmesh_lib.MeshConfig(fsdp=1, sp=n), devices=jax.devices()[:n])
    fn = jring if op == "ring" else julysses
    q, k, v = (jnp.asarray(qkv[x]) for x in "qkv")
    out = jax.jit(lambda q, k, v: fn(q, k, v, mesh))(q, k, v)
    grads = jax.grad(lambda q, k, v: jnp.sum(fn(q, k, v, mesh) ** 2), argnums=(0, 1, 2))(
        q, k, v)
    ref = jxla_attention(q, k, v, causal=True)
    return np.asarray(out), [np.asarray(g) for g in grads], np.asarray(ref)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ring")
    qkv = _write_qkv(tmp / "qkv.npz")
    p_host = write_init(tmp / "init.npz", "llama_tiny")
    batches = write_batches(tmp / "batches.npz", 4)

    def ops(op, spec):
        return dict(name=f"{op} {spec}", kind="ops", op=op, mesh=spec, inputs=str(tmp / "qkv.npz"))

    def step(spec):
        return dict(name=f"step {spec}", kind="step", mesh=spec, kernels="reference",
                    model={"tie_embeddings": True, "use_ring_attention": True},
                    init=str(tmp / "init.npz"), batches=str(tmp / "batches.npz"), **STEP)

    cases = {2: [ops("ring", "sp=2,fsdp=1"), ops("ulysses", "sp=2,fsdp=1"), step("sp=2")],
             4: [ops("ring", "sp=4,fsdp=1"), ops("ulysses", "sp=4,fsdp=1"), step("pp=2,sp=2")]}
    procs = [gang.run_cases(tmp, n, c) for n, c in cases.items()]
    with ThreadPoolExecutor(6) as pool:
        op_futures = {(op, n): pool.submit(_jax_op, op, n, qkv)
                      for op in ("ring", "ulysses") for n in (2, 4)}
        step_futures = {spec: pool.submit(jax_steps, p_host, "llama_tiny", spec, world, batches,
                                          {"use_ring_attention": True})
                        for spec, world in MESHES.items()}
        jax_ops = {k: f.result() for k, f in op_futures.items()}
        jax_runs = {k: f.result() for k, f in step_futures.items()}
    one = one_device_steps(tmp / "init.npz", "llama_tiny", batches)
    for rc, out, err in gang.finish(procs):
        assert rc == 0, (out[-3000:], err[-3000:])
    return {"ops": jax_ops, "jax": jax_runs, "one": one,
            **{n: gang.load_results(tmp, n) for n in cases}}


@pytest.mark.parametrize("op", ["ring", "ulysses"])
@pytest.mark.parametrize("n", [2, 4])
def test_matches_the_jax_op(runs, op, n):
    """Every rank's positions of the output, and the gradients of its q, k
    and v (the ring sends each K/V block's gradient back to its owner),
    against JAX's op under a mesh of the same sp; JAX's own against the
    plain whole-sequence attention."""
    out_j, grads_j, ref = runs["ops"][(op, n)]
    fwd_tol, grad_tol = TOLS[op]
    np.testing.assert_allclose(out_j, ref, atol=fwd_tol)
    for rank, res in enumerate(runs[n]):
        got = res[f"{op} sp={n},fsdp=1"]
        pos = slice(rank * SHAPE["s"] // n, (rank + 1) * SHAPE["s"] // n)
        np.testing.assert_allclose(got["out"].numpy(), out_j[:, pos], atol=fwd_tol)
        for g, want in zip(got["grads"], grads_j):
            np.testing.assert_allclose(g.numpy(), want[:, pos], atol=grad_tol)


@pytest.mark.parametrize("spec", list(MESHES))
def test_ring_step_matches_the_jax_step_and_one_device(runs, spec):
    """4 steps with ring attention from one JAX init (tied embedding):
    every rank's losses and its shard of every parameter within 1e-4 of the
    JAX trainer's on the same mesh and of the single-device step."""
    losses, _, whole = runs["jax"][spec]
    one_losses, one_whole = runs["one"]
    results = [r[f"step {spec}"] for r in runs[MESHES[spec]]]
    np.testing.assert_allclose(one_losses, losses, rtol=JAX_TOL, atol=JAX_TOL)
    for res in results:
        np.testing.assert_allclose(res["losses"], losses, rtol=JAX_TOL, atol=JAX_TOL)
    assert_shards_match(results, whole, spec, "llama_tiny", JAX_TOL)
    assert_shards_match(results, one_whole, spec, "llama_tiny", JAX_TOL)


def test_ulysses_heads_not_divisible_raises():
    """6 heads over sp=4, and 8 query heads over sp=2 x tp=2 with 2 KV
    heads: JAX's error, before any collective."""
    def mesh(**sizes):
        full = parse_mesh_spec(",".join(f"{a}={v}" for a, v in sizes.items())).resolve(
            int(np.prod(list(sizes.values()))))
        return Mesh(None, full, {a: 0 for a in AXES}, None, None, "gloo")

    q = torch.zeros((2, 8, 6, 8))
    with pytest.raises(ValueError, match="divisible"):
        ulysses_attention(q, q, q, mesh(fsdp=1, sp=4))
    kv = torch.zeros((2, 8, 1, 8))  # 2 KV heads over tp=2: one a rank
    with pytest.raises(ValueError, match="divisible"):
        ulysses_attention(torch.zeros((2, 8, 4, 8)), kv, kv, mesh(fsdp=1, tp=2, sp=2))


def _saved_after_forward(cfg, b, s):
    """The storages rank 0 of an ``sp=2`` gang holds after the forward of
    ``cfg`` (its shards, meta tensors, a fake process group), by (size,
    dtype)."""
    with aot_fit.gang_mesh("sp=2,fsdp=1") as mesh:
        params = tllama.shard_params(tllama.init_params(cfg, None, "meta"), cfg, mesh)
        tokens = torch.zeros((b, s // 2), dtype=torch.int64, device="meta")
        tracker = aot_fit.LiveBytes()
        tracker.add_args((params, tokens))
        with tracker:
            x, _ = tllama.forward_features(params, tokens, cfg, mesh)
            live = tracker.live_tensors()
    out = collections.Counter((int(np.prod(shape)), str(dtype)) for shape, dtype, _ in live)
    out[(x.numel(), str(x.dtype))] -= 1
    return +out


def test_dots_attn_saves_the_ring_output():
    """Under ``"dots_attn"`` each layer keeps the ring's output ([b, s/sp,
    h, d] in the model dtype, named as the plain attention's) beside what
    ``"dots"`` keeps, as JAX's ``checkpoint_name(attn_out)`` saves it."""
    b, s = 2, 32
    cfg = tllama.llama_tiny(remat=True, use_ring_attention=True, max_seq=s)
    saved = {p: _saved_after_forward(dataclasses.replace(cfg, remat_policy=p), b, s)
             for p in ("dots", "dots_attn")}
    assert saved["dots_attn"] - saved["dots"] == collections.Counter(
        {(b * s // 2 * cfg.n_heads * cfg.head_dim, "torch.float32"): cfg.n_layers})
