"""The port's bucketed gradient sync (``torchx_tpu_torch.parallel.overlap``)
against the JAX package's: the same buckets, trials and descriptions on the
same trees (tensors of the JAX arrays' shapes and dtypes), and on gloo
ranks the bucketed sum over ``dp`` bitwise one fused sync and the rank-order
sum, at ``dp`` 2 and 4 (the reference's contract: the sum's order depends
on the ranks alone, not on an element's place in a bucket).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_gang_cases as gang
from torchx_tpu.models import llama as jllama
from torchx_tpu.parallel import overlap as joverlap
from torchx_tpu_torch.models import llama as tllama
from torchx_tpu_torch.parallel import overlap
from torch_threads import xdist_torch_threads  # noqa: F401

MIB = 1024 * 1024
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _trees():
    """(JAX tree, the port's tree of tensors of the same shapes/dtypes)."""
    out = []
    ks = jax.random.split(jax.random.PRNGKey(0), 4)
    for dtype in (jnp.float32, jnp.bfloat16):
        tree = {
            "wq": jax.random.normal(ks[0], (8, 64, 32), dtype=dtype),
            "wo": jax.random.normal(ks[1], (8, 32, 64), dtype=dtype),
            "norm": jax.random.normal(ks[2], (8, 64), dtype=dtype),
            "emb": jax.random.normal(ks[3], (8, 128, 64), dtype=dtype),
        }
        out.append(tree)
    out.append([jnp.zeros((1024,)), jnp.zeros((8,)), jnp.zeros((8,))])
    # the llama3_1b parameter tree, by shape only
    cfg = jllama.llama3_1b()
    out.append(jax.eval_shape(lambda: jllama.init_params(cfg, jax.random.PRNGKey(0))))
    return [(t, jax.tree.map(lambda x: torch.empty(x.shape, dtype=DTYPES[str(x.dtype)],
                                                     device="meta"), t)) for t in out]


@pytest.mark.parametrize("which", range(4))
@pytest.mark.parametrize("cap", [64, 4 * 1024, MIB, 32 * MIB, 10_000 * MIB])
def test_plan_buckets_matches_jax(which, cap):
    jtree, ttree = _trees()[which]
    a, b = joverlap.plan_buckets(jtree, cap), overlap.plan_buckets(ttree, cap)
    assert (b.buckets, b.total_bytes, b.n_buckets, b.largest_bucket_bytes) == \
        (a.buckets, a.total_bytes, a.n_buckets, a.largest_bucket_bytes)
    assert b.describe() == a.describe()


@pytest.mark.parametrize("which", range(4))
@pytest.mark.parametrize("requested", ["auto", 0, "0", None, 4, "32"])
def test_resolve_bucket_mb_matches_jax(which, requested):
    jtree, ttree = _trees()[which]
    a_mb, a_trials = joverlap.resolve_bucket_mb(jtree, requested)
    b_mb, b_trials = overlap.resolve_bucket_mb(ttree, requested)
    assert b_mb == a_mb
    assert [t.to_dict() for t in b_trials] == [t.to_dict() for t in a_trials]


def test_invalid_request_raises_as_jax():
    for mod in (joverlap, overlap):
        with pytest.raises(ValueError, match="must be positive"):
            mod.resolve_bucket_mb({"a": jnp.zeros(4)}, -1)


def test_tree_leaves_is_the_pytree_order():
    cfg = tllama.llama_tiny()
    params = tllama.init_params(cfg, torch.Generator().manual_seed(0))
    assert [id(x) for x in overlap.tree_leaves(params)] == \
        [id(x) for x in tllama.leaves(params)]
    j = jllama.init_params(jllama.llama_tiny(), jax.random.PRNGKey(0))
    assert [x.shape for x in jax.tree.leaves(j)] == \
        [tuple(x.shape) for x in overlap.tree_leaves(params)]


@pytest.fixture(scope="module")
def synced(tmp_path_factory):
    """bucketed_sync on 2 and 4 gloo ranks (dp=2, dp=4), a 1 MiB cap, each
    sync gathered in 96 KiB chunks (leaves and buckets span several)."""
    tmp = tmp_path_factory.mktemp("overlap")
    procs = [gang.run_cases(tmp, n, [dict(name="sync", kind="sync", mesh=f"dp={n}",
                                          bucket_mb=1, chunk_bytes=96 * 1024)])
             for n in (2, 4)]
    for rc, out, err in gang.finish(procs):
        assert rc == 0, (out[-3000:], err[-3000:])
    return {n: [r["sync"] for r in gang.load_results(tmp, n)] for n in (2, 4)}


def _expected_sum(results):
    """The per-leaf sum over ranks in rank order, ``((x0 + x1) + x2) + ...``
    in the leaf's dtype, one rounding an add."""
    out = []
    for i in range(len(results[0]["local"])):
        acc = results[0]["local"][i].clone()
        for r in results[1:]:
            acc += r["local"][i]
        out.append(acc)
    return out


def _assert_bitwise(results):
    want = _expected_sum(results)
    for r in results:
        for f, b, w in zip(r["fused"], r["bucketed"], want):
            assert torch.equal(f, b) and torch.equal(b, w)


def test_bucketed_equals_fused_bitwise_at_dp2(synced):
    results = synced[2]
    for r in results:
        assert r["n_buckets"] > 1 and r["issued"][1] > r["issued"][0] == 2  # 2 dtypes
    _assert_bitwise(results)  # every rank holds the same sum


def test_bucketed_equals_fused_within_rounding_at_dp4(synced):
    """Bitwise at dp 4 too: the rank-order sum does not depend on where a
    leaf lies in its bucket (a ring all-reduce's order would)."""
    results = synced[4]
    assert results[0]["n_buckets"] > 1
    _assert_bitwise(results)


def test_a_group_of_one_issues_nothing():
    import torch.distributed as dist

    from torchx_tpu_torch import distributed
    from torchx_tpu_torch.parallel.mesh import make_mesh

    distributed.init_from_env(backend="gloo")
    try:
        grads = [torch.ones(3), torch.full((2,), 2.0)]
        assert overlap.bucketed_sync(grads, None, make_mesh().dp_group) == 0
        assert grads[0].tolist() == [1.0] * 3
    finally:
        dist.destroy_process_group()
