"""The port's mesh against the JAX package's: the shape model
(``parallel/mesh_config.py``, a copy) under hypothesis, ``param_specs``'
tree, every rank's ``shard_params`` shard against JAX's addressable shard
on the same device of the same mesh (conftest gives JAX 8 CPU devices), a
batch's rows against ``BATCH_SPEC``'s, and ``make_mesh`` with the
collectives of a parameter at a world of one (gloo, in this process).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.sharding import NamedSharding

from torchx_tpu.models import llama as jllama
from torchx_tpu.parallel import mesh as jmesh
from torchx_tpu.parallel import mesh_config as jmc
from torchx_tpu_torch import convert, distributed
from torchx_tpu_torch.models import llama as tllama
from torchx_tpu_torch.parallel import mesh as tmesh
from torchx_tpu_torch.parallel import mesh_config as tmc
from torch_threads import xdist_torch_threads  # noqa: F401

AXES = tmc.AXES
SHAPE = dict(dim=128, n_heads=2, n_kv_heads=1, ffn_dim=256)

sizes_st = st.fixed_dictionaries({a: st.sampled_from([1, 2, 3, 4]) for a in AXES})


def _both(fn_name, *args):
    """The JAX copy's result and the port's of one function (a raised
    ValueError as its message; a MeshConfig as its sizes)."""
    out = []
    for mod in (jmc, tmc):
        try:
            res = getattr(mod, fn_name)(*args)
        except ValueError as e:
            res = ("ValueError", str(e))
        out.append(tuple(getattr(res, a) for a in AXES) if hasattr(res, "resolve") else res)
    return out


def test_the_copy_has_the_same_names():
    assert tmc.AXES == jmc.AXES
    assert tmc.DATA_AXES == jmc.DATA_AXES and tmc.MODEL_AXES == jmc.MODEL_AXES
    assert tmc.MeshConfig() == tmc.MeshConfig(**vars(jmc.MeshConfig()))


@settings(max_examples=60, deadline=None)
@given(st.fixed_dictionaries({a: st.sampled_from([-1, 1, 2, 4]) for a in AXES}),
       st.sampled_from([1, 2, 4, 8, 16, 12]))
def test_resolve_matches(kw, n):
    results = []
    for mod in (jmc, tmc):
        try:
            results.append(mod.MeshConfig(**kw).resolve(n))
        except ValueError as e:
            results.append(str(e))
    assert results[0] == results[1]


@settings(max_examples=60, deadline=None)
@given(sizes_st, st.sampled_from([1, 2, 4, 8, 16]))
def test_axis_networks_matches(sizes, chips):
    assert tmc.axis_networks(sizes, chips) == jmc.axis_networks(sizes, chips)


@settings(max_examples=60, deadline=None)
@given(st.dictionaries(st.sampled_from(AXES + ("xp",)), st.integers(-1, 8), max_size=4))
def test_parse_and_spec_match(kw):
    spec = ",".join(f"{k}={v}" for k, v in kw.items())
    a, b = _both("parse_mesh_spec", spec)
    assert a == b
    if not isinstance(a[0], str):
        sizes = dict(zip(AXES, a))
        assert tmc.mesh_sizes_spec(sizes) == jmc.mesh_sizes_spec(sizes)


@settings(max_examples=60, deadline=None)
@given(sizes_st, st.one_of(st.none(), st.integers(1, 64)))
def test_shrink_data_axes_matches(sizes, target):
    a, b = _both("shrink_data_axes", sizes, target)
    assert a == b


@pytest.mark.parametrize("tie", [True, False])
def test_param_specs_is_the_jax_tree(tie):
    cfg_j = jllama.llama_tiny(tie_embeddings=tie, **SHAPE)
    cfg_t = tllama.llama_tiny(tie_embeddings=tie, **SHAPE)
    j = {"/".join(str(k.key) for k in kp): tuple(v)
         for kp, v in jax.tree_util.tree_flatten_with_path(
             jllama.param_specs(cfg_j), is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)
         )[0]}
    t = {name.replace(".", "/"): spec for name, spec in tllama.named_leaves(tllama.param_specs(cfg_t))}
    assert t == j


def test_param_specs_refuses_moe():
    """MoE specs were refused until the ep axis was ported: a MoE config's
    specs are now the dense ones with the router over fsdp and the experts
    over ("ep", "tp") (tests/test_torch_ep.py holds them to JAX's)."""
    specs = tllama.param_specs(tllama.get_config("moe_tiny"))
    dense = tllama.dense_param_specs(tllama.get_config("moe_tiny"))
    assert specs["layers"].pop("w_router") == (None, "fsdp", None)
    for key in ("w_gate", "w_up", "w_down"):
        assert specs["layers"][key][1] == ("ep", "tp") != dense["layers"][key][1]
        specs["layers"][key] = dense["layers"][key]
    assert specs == dense


def _mesh_at(sizes: dict, rank: int) -> tmesh.Mesh:
    coords = np.unravel_index(rank, [sizes[a] for a in AXES])
    return tmesh.Mesh(None, dict(sizes), {a: int(c) for a, c in zip(AXES, coords)},
                      None, None, "gloo")


MESHES = [dict(fsdp=2), dict(fsdp=4), dict(dp=2, fsdp=2), dict(dp=2, fsdp=4), dict(dp=4, fsdp=2),
          dict(fsdp=2, tp=2), dict(dp=2, fsdp=2, tp=2)]


@pytest.mark.parametrize("tie", [True, False])
@pytest.mark.parametrize("kw", MESHES, ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_shard_params_is_the_addressable_shard(kw, tie):
    """Rank r's shard of every leaf equals the shard JAX's shard_params
    puts on device r of the same mesh (tp too: the arithmetic is the
    same, though only the data axes run)."""
    cfg_j = jllama.llama_tiny(tie_embeddings=tie, **SHAPE)
    cfg_t = tllama.llama_tiny(tie_embeddings=tie, **SHAPE)
    config = jmesh.MeshConfig(**{**dict(fsdp=1), **kw})
    n = int(np.prod(list(kw.values())))
    devices = jax.devices()[:n]
    mesh = jmesh.make_mesh(config, devices=devices)
    p_j = jllama.init_params(cfg_j, jax.random.PRNGKey(3))
    sharded = jllama.shard_params(p_j, cfg_j, mesh)
    p_t = convert.params_from_jax(jax.tree.map(np.asarray, p_j), cfg_t)
    sizes = config.resolve(n)
    j_leaves = jax.tree.leaves(sharded)
    for rank, dev in enumerate(devices):
        mine = tllama.shard_params(p_t, cfg_t, _mesh_at(sizes, rank))
        for arr, (name, got) in zip(j_leaves, tllama.named_leaves(mine)):
            want = next(s.data for s in arr.addressable_shards if s.device == dev)
            np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want), err_msg=name)
            assert got.requires_grad and got.is_contiguous()


@pytest.mark.parametrize("kw", [dict(fsdp=4), dict(dp=2, fsdp=2), dict(dp=4, fsdp=2),
                                dict(dp=2, fsdp=2, tp=2)])
def test_batch_rows_are_batch_specs(kw):
    config = jmesh.MeshConfig(**{**dict(fsdp=1), **kw})
    n = int(np.prod(list(kw.values())))
    devices = jax.devices()[:n]
    mesh = jmesh.make_mesh(config, devices=devices)
    tokens = np.arange(16 * 3).reshape(16, 3)
    arr = jax.device_put(tokens, NamedSharding(mesh, jmesh.BATCH_SPEC))
    sizes = config.resolve(n)
    for rank, dev in enumerate(devices):
        want = next(s.data for s in arr.addressable_shards if s.device == dev)
        np.testing.assert_array_equal(tokens[_mesh_at(sizes, rank).batch_rows(16)],
                                      np.asarray(want))


def test_batch_rows_need_a_divisible_batch():
    with pytest.raises(ValueError, match="does not split"):
        _mesh_at(tmc.MeshConfig(dp=2, fsdp=2).resolve(4), 0).batch_rows(6)


@pytest.fixture
def world_one():
    distributed.init_from_env(backend="gloo")
    yield
    dist.destroy_process_group()


def test_make_mesh_at_world_one(world_one):
    m = tmesh.make_mesh()
    assert m.sizes == dict.fromkeys(AXES, 1) and m.coords == dict.fromkeys(AXES, 0)
    assert m.device_mesh.mesh_dim_names == AXES and m.backend == "gloo"
    assert m.batch_rows(4) == slice(0, 4) and m.data_size == 1
    for g in (m.dp_group, m.fsdp_group, m.token_group, m.expert_group):
        assert dist.get_world_size(g) == 1
    with pytest.raises(ValueError):
        tmesh.make_mesh(tmc.MeshConfig(fsdp=2))


@pytest.mark.parametrize("spec", [(None, "fsdp"), ("fsdp", None), (None, None)])
def test_unshard_at_world_one(world_one, spec):
    """A gather (or the replicated marker) of one rank is the tensor, and
    its backward the gradient, whatever dimension it names."""
    m = tmesh.make_mesh()
    x = torch.randn(6, 4, requires_grad=True)
    y = m.unshard(x, spec)
    assert torch.equal(y, x) and y.is_contiguous()
    g = torch.randn(6, 4)
    (y * g).sum().backward()
    assert torch.equal(x.grad, g)


def test_unshard_refuses_model_axes(world_one):
    """A tp, ep or (ep, tp) block stays local: at fsdp 1 the unshard of a
    spec naming them on one dimension and fsdp on another is the block
    itself (its gradient too); so is a stage's block of layers over pp; an
    axis no parameter shards over (sp) raises."""
    m = dataclasses.replace(tmesh.make_mesh(),
                            sizes=tmc.MeshConfig(fsdp=1, ep=2, tp=2).resolve(4))
    x = torch.randn(6, 4, requires_grad=True)
    for spec in ((None, "tp"), ("fsdp", "tp"), ("tp", "fsdp"), ("ep", "fsdp"),
                 (("ep", "tp"), "fsdp")):
        y = m.unshard(x, spec)
        assert torch.equal(y, x) and y.shape == x.shape
    g = torch.randn(6, 4)
    (y * g).sum().backward()
    assert torch.equal(x.grad, g)
    m = dataclasses.replace(m, sizes=tmc.MeshConfig(fsdp=1, pp=2).resolve(2))
    assert torch.equal(m.unshard(x, ("pp", None)), x)
    m = dataclasses.replace(m, sizes=tmc.MeshConfig(fsdp=1, sp=2).resolve(2))
    with pytest.raises(ValueError, match="model's layouts"):
        m.unshard(torch.zeros(4, 4), (None, "sp"))


def test_make_mesh_needs_a_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_mesh()
