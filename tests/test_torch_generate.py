"""Parity of the port's dense KV-cache generation with the JAX package's,
on the CPU: prefill and decode logits, greedy tokens, the streaming path
against the batch path, and the max_seq guard. Weights come from the JAX
``init_params`` through ``convert.params_from_jax(requires_grad=False)``;
prompts are made with numpy from a seed. f32 (the ``tiny`` config)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchx_tpu.models import generate as jgen
from torchx_tpu.models import llama as jllama
from torchx_tpu_torch import convert
from torchx_tpu_torch.models import generate as tgen
from torchx_tpu_torch.models import llama as tllama
from torch_threads import xdist_torch_threads  # noqa: F401


@pytest.fixture(scope="module")
def tiny():
    cfg_j = jllama.CONFIGS["tiny"]()
    cfg_t = tllama.llama_tiny()
    p_j = jllama.init_params(cfg_j, jax.random.PRNGKey(0))
    p_t = convert.params_from_jax(jax.tree.map(np.asarray, p_j), cfg_t, requires_grad=False)
    return cfg_j, cfg_t, p_j, p_t


def _prompts(seed, shape, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def test_converted_params_do_not_require_grad(tiny):
    _, _, _, p_t = tiny
    assert not any(t.requires_grad for t in tllama.leaves(p_t))


def test_forward_with_cache_matches_jax(tiny):
    """Prefill logits, then one decode step's, within 1e-5 (f32); the
    caches agree too."""
    cfg_j, cfg_t, p_j, p_t = tiny
    tok = _prompts(1, (2, 12))
    c_j = jgen.init_kv_cache(cfg_j, 2, 16)
    l_j, c_j = jgen.forward_with_cache(p_j, jnp.asarray(tok), c_j, jnp.int32(0), cfg_j)
    c_t = tgen.init_kv_cache(cfg_t, 2, 16)
    l_t, c_t = tgen.forward_with_cache(p_t, torch.from_numpy(tok).long(), c_t, 0, cfg_t)
    assert l_t.dtype == torch.float32 and l_t.shape == (2, 12, cfg_t.vocab_size)
    np.testing.assert_allclose(l_t.numpy(), np.asarray(l_j), rtol=1e-5, atol=1e-5)
    nxt = _prompts(2, (2, 1))
    l_j, c_j = jgen.forward_with_cache(p_j, jnp.asarray(nxt), c_j, jnp.int32(12), cfg_j)
    l_t, c_t = tgen.forward_with_cache(p_t, torch.from_numpy(nxt).long(), c_t, 12, cfg_t)
    np.testing.assert_allclose(l_t.numpy(), np.asarray(l_j), rtol=1e-5, atol=1e-5)
    for k in ("k", "v"):
        np.testing.assert_allclose(c_t[k].numpy(), np.asarray(c_j[k]), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(3, 5), (1, 17)])
def test_greedy_generate_matches_jax(tiny, shape):
    cfg_j, cfg_t, p_j, p_t = tiny
    prompt = _prompts(shape[1], shape)
    out_j = np.asarray(jgen.generate(p_j, jnp.asarray(prompt), cfg_j, max_new_tokens=10))
    out_t = tgen.generate(p_t, torch.from_numpy(prompt).long(), cfg_t, max_new_tokens=10)
    assert out_t.shape == out_j.shape
    assert out_t.tolist() == out_j.tolist()


@pytest.mark.parametrize("temperature,chunk", [(0.0, 3), (0.8, 4), (0.8, 1)])
def test_stream_equals_generate(tiny, temperature, chunk):
    _, cfg_t, _, p_t = tiny
    prompt = torch.from_numpy(_prompts(3, (2, 6))).long()
    full = tgen.generate(p_t, prompt, cfg_t, 9, temperature=temperature, seed=5)
    pieces = list(tgen.generate_stream(
        p_t, prompt, cfg_t, 9, temperature=temperature, seed=5, chunk=chunk))
    assert all(p.shape[1] <= chunk for p in pieces[1:]) and pieces[0].shape[1] == 1
    assert torch.equal(torch.cat(pieces, dim=1), full[:, 6:])


def test_sampled_rows_follow_their_own_seed(tiny):
    """Row i of a call with per-row seeds draws what a one-row call with
    its seed draws; another seed draws otherwise."""
    _, cfg_t, _, p_t = tiny
    prompt = torch.from_numpy(_prompts(4, (3, 5))).long()
    both = tgen.generate(p_t, prompt, cfg_t, 8, temperature=1.0, seed=[11, 12, 13])
    for i, s in enumerate((11, 12, 13)):
        one = tgen.generate(p_t, prompt[i : i + 1], cfg_t, 8, temperature=1.0, seed=s)
        assert torch.equal(one[0], both[i])
    other = tgen.generate(p_t, prompt, cfg_t, 8, temperature=1.0, seed=99)
    assert not torch.equal(other, both)


def test_max_seq_overflow_raises(tiny):
    _, cfg_t, _, p_t = tiny
    prompt = torch.ones((1, cfg_t.max_seq - 3), dtype=torch.long)
    with pytest.raises(ValueError, match="max_seq"):
        tgen.generate(p_t, prompt, cfg_t, 4)
    with pytest.raises(ValueError, match="max_seq"):
        tgen.generate_stream(p_t, prompt, cfg_t, 4)
    with pytest.raises(ValueError, match="chunk"):
        tgen.generate_stream(p_t, prompt[:, :4], cfg_t, 4, chunk=0)
    cache = tgen.init_kv_cache(cfg_t, 1, 8)
    with pytest.raises(ValueError, match="exceed"):
        tgen.forward_with_cache(p_t, torch.ones((1, 4), dtype=torch.long), cache, 6, cfg_t)


def test_token_out_of_vocab_raises(tiny):
    _, cfg_t, _, p_t = tiny
    with pytest.raises(IndexError, match="out of range"):
        tgen.generate(p_t, torch.tensor([[1, cfg_t.vocab_size]]), cfg_t, 2)


def test_gumbel_draws_follow_softmax():
    """The hash-noise Gumbel-max draw samples softmax(logits / T): over
    20,000 positions each token's frequency is within 0.015 of its
    probability, and the noise is a pure function of (seed, position)."""
    logits = torch.tensor([1.0, 0.5, 0.0, -0.5, 2.0, -1.0, 0.25, 1.5])
    temp = 0.8
    n = 20000
    pos = torch.arange(n)
    rows = logits.expand(n, -1)
    draws = tgen._sample_rows(rows, torch.full((n,), 7), pos, torch.full((n,), temp))
    freq = torch.bincount(draws, minlength=8).float() / n
    torch.testing.assert_close(freq, torch.softmax(logits / temp, 0), rtol=0, atol=0.015)
    again = tgen._sample_rows(rows, torch.full((n,), 7), pos, torch.full((n,), temp))
    assert torch.equal(draws, again)
    greedy = tgen._sample_rows(rows[:4], torch.zeros(4), pos[:4], torch.zeros(4))
    assert greedy.tolist() == [4] * 4
