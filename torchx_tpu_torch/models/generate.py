"""KV-cache autoregressive generation for the Llama family.

Port of :mod:`torchx_tpu.models.generate`: the dense path (prefill collects
each layer's K/V into ``[L, b, max_seq, kvh, hd]`` buffers, then each
decode step attends one query token against them) and the paged path of
the continuous-batching engine (K/V in block-table pools,
:mod:`torchx_tpu_torch.ops.paged_attention`, with a position, a seed and a
temperature per slot). The JAX package's ``lax.scan`` over the stacked
layers is a Python loop over the layer index, and nothing is jitted: every
function runs eagerly, under ``torch.no_grad``, and writes its caches and
pools in place.

The attention scores and the lm-head logits are f32 from bf16 operands
(:func:`~torchx_tpu_torch.ops.paged_attention.matmul_f32`), as the JAX
einsums' ``preferred_element_type=float32``: a bf16 logit row would flip
greedy argmaxes over a 128256-token vocabulary.

**Sampling.** Greedy rows take the first maximum, as ``jnp.argmax`` does,
so greedy tokens match the JAX package. Sampled tokens cannot follow JAX's
threefry stream; they keep its engine's contract instead: a row's draw is
a pure function of (seed, position of the last token read) and of nothing
else in the batch, so a preempted request resumes with the same tokens, a
prefix-cache hit draws the same first token as a cold prefill, and the
dense :func:`generate`, :func:`generate_stream` and both serving engines
draw the same tokens for the same seed. The draw is Gumbel-max on the
device: ``argmax(logits / T + g)`` with ``g = -log(-log(u))`` and ``u``
from an integer hash of (seed, position, vocab index), the whole slot
array in one pass, with no host loop and no extra sync
(:func:`_gumbel_noise`).
"""

from __future__ import annotations

from typing import Iterator, Sequence, Union

import torch

from torchx_tpu_torch.models import llama
from torchx_tpu_torch.ops.norms import rms_norm
from torchx_tpu_torch.ops.paged_attention import (
    _append_kv,
    _paged_attention,
    _paged_attention_chunk,
    _scatter_kv_chunk,
    check_range,
    matmul_f32,
)
from torchx_tpu_torch.ops.rope import apply_rope, rope_frequencies

KVCache = dict[str, torch.Tensor]  # {"k": [L,b,S,kvh,hd], "v": ...}
KVPools = dict[str, torch.Tensor]  # {"k": [L,num_blocks,block_size,kvh,hd]}
Seeds = Union[int, Sequence[int], torch.Tensor]

_MASKED = -1e30


def _layer(params: llama.Params, i: int) -> dict[str, torch.Tensor]:
    """Layer ``i``'s slice of the stacked layer weights (views)."""
    return {key: w[i] for key, w in params["layers"].items()}


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

_MASK32 = 0xFFFFFFFF


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer finaliser on int64 tensors holding values in
    [0, 2**32): every product stays below 2**63, so it is exact and the
    same on every device."""
    x = ((x >> 16) ^ x) * 0x45D9F3B & _MASK32
    x = ((x >> 16) ^ x) * 0x45D9F3B & _MASK32
    return (x >> 16) ^ x


def _gumbel_noise(
    seeds: torch.Tensor,  # [rows] int
    positions: torch.Tensor,  # [rows] int — position of the last token read
    vocab: int,
) -> torch.Tensor:
    """-> [rows, vocab] f32 Gumbel(0, 1) noise, a pure function of (seed,
    position, vocab index)."""
    s = seeds.to(torch.int64) & _MASK32
    p = positions.to(torch.int64) & _MASK32
    row = _mix32(_mix32(s ^ 0x2545F491) ^ p)  # [rows]
    col = (torch.arange(vocab, dtype=torch.int64, device=seeds.device) * 0x9E3779B9) & _MASK32
    h = _mix32(_mix32(row[:, None] ^ col[None, :]) ^ 0x68E31DA4)
    u = ((h >> 8).to(torch.float32) + 0.5) * 2.0**-24  # (0, 1), 24 bits
    return -torch.log(-torch.log(u))


def _sample_rows(
    logits: torch.Tensor,  # [rows, vocab] f32
    seeds: torch.Tensor,  # [rows]
    positions: torch.Tensor,  # [rows] — position of the last token read
    temps: torch.Tensor,  # [rows] f32 — <= 0 means greedy for that row
) -> torch.Tensor:
    """Per-row sampling where temperature is data: each row greedy-decodes
    or draws at its own temperature from its own (seed, position) noise.
    -> [rows] int64."""
    greedy = torch.argmax(logits, dim=-1)
    safe_t = torch.where(temps > 0, temps, 1.0)[:, None]
    noise = _gumbel_noise(seeds, positions, logits.shape[-1])
    sampled = torch.argmax(logits / safe_t + noise, dim=-1)
    return torch.where(temps > 0, sampled, greedy)


def _seed_rows(seed: Seeds, b: int, device: torch.device) -> torch.Tensor:
    """An int seed for every row, or one seed per row -> [b] int64."""
    if isinstance(seed, int):
        return torch.full((b,), seed, dtype=torch.int64, device=device)
    seeds = torch.as_tensor(seed, dtype=torch.int64, device=device)
    if seeds.shape != (b,):
        raise ValueError(f"need one seed or {b} seeds, got shape {tuple(seeds.shape)}")
    return seeds


def _sample(
    logits_t: torch.Tensor,  # [b, vocab]
    seeds: torch.Tensor,  # [b]
    position: int,  # position of the last token read
    temperature: float,
) -> torch.Tensor:
    """Greedy at temperature 0, else a draw at ``temperature``: the ONE
    rule :func:`generate` and :func:`generate_stream` share."""
    b = logits_t.shape[0]
    pos = torch.full((b,), position, dtype=torch.int64, device=logits_t.device)
    temps = torch.full((b,), float(temperature), device=logits_t.device)
    return _sample_rows(logits_t, seeds, pos, temps)


# ---------------------------------------------------------------------------
# dense KV cache
# ---------------------------------------------------------------------------


def init_kv_cache(
    cfg: llama.LlamaConfig, batch: int, max_seq: int, device: torch.device | str = "cpu"
) -> KVCache:
    """Zeroed [layers, batch, max_seq, kv_heads, head_dim] K/V buffers."""
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
    }


def _cached_attention(
    q: torch.Tensor,  # [b, t, h, d] (t = tokens this call)
    k_cache: torch.Tensor,  # [b, S, kvh, d] — positions >= valid_len are zeros
    v_cache: torch.Tensor,
    q_pos: torch.Tensor,  # [t] absolute positions of the query tokens
) -> torch.Tensor:
    b, t, h, d = q.shape
    S, kvh = k_cache.shape[1], k_cache.shape[2]
    n_rep = h // kvh
    qg = q.reshape(b, t, kvh, n_rep, d).permute(0, 2, 3, 1, 4).reshape(b, kvh, n_rep * t, d)
    logits = matmul_f32(qg, k_cache.permute(0, 2, 3, 1)) * d**-0.5
    logits = logits.view(b, kvh, n_rep, t, S)
    # key position s is visible to the query at absolute position p iff s <= p
    visible = torch.arange(S, device=q.device)[None, :] <= q_pos[:, None]  # [t, S]
    logits.masked_fill_(~visible, _MASKED)
    probs = torch.softmax(logits, dim=-1).to(q.dtype).view(b, kvh, n_rep * t, S)
    out = probs @ v_cache.permute(0, 2, 1, 3)  # [b, kvh, n_rep * t, d]
    return out.view(b, kvh, n_rep, t, d).permute(0, 3, 1, 2, 4).reshape(b, t, h, d)


def _layer_step(
    cfg: llama.LlamaConfig,
    cos: torch.Tensor,  # [t, hd/2] rope rows for these positions
    sin: torch.Tensor,
    q_pos: torch.Tensor,  # [t]
    x: torch.Tensor,  # [b, t, d]
    layer: dict[str, torch.Tensor],
    k_cache: torch.Tensor,  # [b, S, kvh, hd] this layer's cache (written in place)
    v_cache: torch.Tensor,
    start: int,  # where these t tokens go in the cache
) -> torch.Tensor:
    b, t, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    attn_in = rms_norm(x, layer["attn_norm"], cfg.norm_eps)
    q = apply_rope((attn_in @ layer["wq"]).reshape(b, t, h, hd), cos, sin)
    k = apply_rope((attn_in @ layer["wk"]).reshape(b, t, kvh, hd), cos, sin)
    v = (attn_in @ layer["wv"]).reshape(b, t, kvh, hd)
    k_cache[:, start : start + t] = k
    v_cache[:, start : start + t] = v
    attn = _cached_attention(q, k_cache, v_cache, q_pos)
    x = x + attn.reshape(b, t, h * hd) @ layer["wo"]
    mlp_in = rms_norm(x, layer["mlp_norm"], cfg.norm_eps)
    down, _aux = llama.ffn(cfg, layer, mlp_in)
    return x + down


def _lm_head_rows(params: llama.Params, x: torch.Tensor, cfg: llama.LlamaConfig) -> torch.Tensor:
    """[..., d] -> [..., vocab] f32 logits."""
    lead = x.shape[:-1]
    out = matmul_f32(x.reshape(-1, x.shape[-1]), llama.lm_head(params, cfg))
    return out.reshape(*lead, -1)


@torch.no_grad()
def forward_with_cache(
    params: llama.Params,
    tokens: torch.Tensor,  # [b, t]
    cache: KVCache,
    start: int,  # absolute position of tokens[:, 0]
    cfg: llama.LlamaConfig,
) -> tuple[torch.Tensor, KVCache]:
    """-> (logits [b, t, vocab] f32, the cache, updated in place). Used for
    both prefill (t = prompt length) and decode (t = 1)."""
    check_range(("forward_with_cache tokens", tokens, cfg.vocab_size))
    return _forward_with_cache(params, tokens, cache, start, cfg)


def _forward_with_cache(params, tokens, cache, start, cfg):  # noqa: ANN001, ANN202
    b, t = tokens.shape
    S = cache["k"].shape[2]
    if start < 0 or start + t > S:
        raise ValueError(f"positions [{start}, {start + t}) exceed the cache's {S}")
    dev = tokens.device
    x = params["embed"][tokens].to(cfg.dtype)
    q_pos = torch.arange(start, start + t, device=dev)
    cos, sin = rope_frequencies(cfg.head_dim, t, cfg.rope_theta, start=start, device=dev)
    for i in range(cfg.n_layers):
        x = _layer_step(
            cfg, cos, sin, q_pos, x, _layer(params, i), cache["k"][i], cache["v"][i], start
        )
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _lm_head_rows(params, x, cfg), cache


def _check_total(t0: int, max_new_tokens: int, cfg: llama.LlamaConfig) -> int:
    total = t0 + max_new_tokens
    if total > cfg.max_seq:
        raise ValueError(f"prompt + new tokens ({total}) exceeds max_seq {cfg.max_seq}")
    return total


def _prefill(
    params: llama.Params,
    prompt: torch.Tensor,
    cfg: llama.LlamaConfig,
    total: int,
    seeds: torch.Tensor,
    temperature: float,
) -> tuple[KVCache, torch.Tensor]:
    """Shared prompt pass: -> (cache, first sampled token [b])."""
    b, t0 = prompt.shape
    cache = init_kv_cache(cfg, b, total, prompt.device)
    logits, cache = _forward_with_cache(params, prompt, cache, 0, cfg)
    return cache, _sample(logits[:, -1], seeds, t0 - 1, temperature)


@torch.no_grad()
def generate(
    params: llama.Params,
    prompt: torch.Tensor,  # [b, t0] int
    cfg: llama.LlamaConfig,
    max_new_tokens: int,
    temperature: float = 0.0,
    seed: Seeds = 0,
) -> torch.Tensor:
    """-> [b, t0 + max_new_tokens]; greedy when temperature == 0.

    ``seed`` is one seed for every row or one per row; row ``i`` draws the
    tokens a one-row call with its seed draws (see the module docstring)."""
    b, t0 = prompt.shape
    total = _check_total(t0, max_new_tokens, cfg)
    check_range(("generate prompt", prompt, cfg.vocab_size))
    seeds = _seed_rows(seed, b, prompt.device)
    cache, tok = _prefill(params, prompt, cfg, total, seeds, temperature)
    out = [tok]
    for i in range(max_new_tokens - 1):
        logits, cache = _forward_with_cache(params, tok[:, None], cache, t0 + i, cfg)
        tok = _sample(logits[:, -1], seeds, t0 + i, temperature)
        out.append(tok)
    return torch.cat([prompt, torch.stack(out, dim=1).to(prompt.dtype)], dim=1)


def generate_stream(
    params: llama.Params,
    prompt: torch.Tensor,  # [b, t0] int
    cfg: llama.LlamaConfig,
    max_new_tokens: int,
    temperature: float = 0.0,
    seed: Seeds = 0,
    chunk: int = 8,
) -> Iterator[torch.Tensor]:
    """Streaming :func:`generate`: yields ``[b, n]`` CPU tensors of NEW
    tokens (n <= ``chunk``), token-identical to :func:`generate` at the same
    seed (the shared ``_prefill``/``_sample``). One host transfer per chunk.
    Arguments are validated here, before the generator is returned."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    b, t0 = prompt.shape
    total = _check_total(t0, max_new_tokens, cfg)
    check_range(("generate_stream prompt", prompt, cfg.vocab_size))
    seeds = _seed_rows(seed, b, prompt.device)

    @torch.no_grad()
    def run() -> Iterator[torch.Tensor]:
        cache, tok = _prefill(params, prompt, cfg, total, seeds, temperature)
        yield tok[:, None].cpu()
        produced = 1
        while produced < max_new_tokens:
            n = min(chunk, max_new_tokens - produced)
            toks = []
            for _ in range(n):
                pos = t0 + produced - 1
                logits, cache = _forward_with_cache(params, tok[:, None], cache, pos, cfg)
                tok = _sample(logits[:, -1], seeds, pos, temperature)
                toks.append(tok)
                produced += 1
            yield torch.stack(toks, dim=1).cpu()

    return run()


# ---------------------------------------------------------------------------
# Paged-KV serving path (continuous batching; see torchx_tpu_torch/serve/)
# ---------------------------------------------------------------------------
#
# The dense path's layer math, with K/V in block-table pools
# ([L, num_blocks, block_size, kvh, hd]) and a position, seed and
# temperature per slot, so unrelated requests share one step.


def init_kv_pools(
    cfg: llama.LlamaConfig,
    num_blocks: int,
    block_size: int,
    device: torch.device | str = "cpu",
) -> KVPools:
    """Zeroed paged K/V pools, ``[layers, num_blocks, block_size, kvh, hd]``
    (block 0 is the trash block, see :mod:`..ops.paged_attention`)."""
    shape = (cfg.n_layers, num_blocks, block_size, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
    }


def _rope_rows(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """:func:`apply_rope` for one token per row at per-row positions:
    ``x`` [rows, heads, hd], ``cos``/``sin`` [rows, hd/2] (the same f32
    rotation, so paged decode matches the dense path bit for bit)."""
    x1, x2 = x.float().chunk(2, dim=-1)
    c, s = cos[:, None, :], sin[:, None, :]
    return torch.cat((x1 * c - x2 * s, x2 * c + x1 * s), dim=-1).to(x.dtype)


def _rope_chunk(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """:func:`apply_rope` at per-(row, token) positions: ``x`` [b, t,
    heads, hd], ``cos``/``sin`` [b, t, hd/2]."""
    x1, x2 = x.float().chunk(2, dim=-1)
    c, s = cos[:, :, None, :], sin[:, :, None, :]
    return torch.cat((x1 * c - x2 * s, x2 * c + x1 * s), dim=-1).to(x.dtype)


def _paged_layer_step(
    cfg: llama.LlamaConfig,
    cos: torch.Tensor,  # [slots, hd/2] rope rows at each slot's position
    sin: torch.Tensor,
    positions: torch.Tensor,  # [slots] — cache index the new token writes to
    tables: torch.Tensor,  # [slots, blocks_per_slot]
    x: torch.Tensor,  # [slots, 1, d]
    layer: dict[str, torch.Tensor],
    k_pool: torch.Tensor,  # [num_blocks, bs, kvh, hd] this layer's pool
    v_pool: torch.Tensor,
) -> torch.Tensor:
    slots = x.shape[0]
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    attn_in = rms_norm(x, layer["attn_norm"], cfg.norm_eps)
    q = _rope_rows((attn_in @ layer["wq"]).reshape(slots, h, hd), cos, sin)
    k = _rope_rows((attn_in @ layer["wk"]).reshape(slots, kvh, hd), cos, sin)
    v = (attn_in @ layer["wv"]).reshape(slots, kvh, hd)
    _append_kv(k_pool, tables, positions, k)
    _append_kv(v_pool, tables, positions, v)
    attn = _paged_attention(q, k_pool, v_pool, tables, positions + 1)
    x = x + attn.reshape(slots, 1, h * hd) @ layer["wo"]
    mlp_in = rms_norm(x, layer["mlp_norm"], cfg.norm_eps)
    down, _aux = llama.ffn(cfg, layer, mlp_in)
    return x + down


@torch.no_grad()
def paged_decode_step(
    params: llama.Params,
    tokens: torch.Tensor,  # [slots] — last sampled token per slot
    positions: torch.Tensor,  # [slots] — where each token's K/V goes
    tables: torch.Tensor,  # [slots, blocks_per_slot] block tables
    pools: KVPools,
    cfg: llama.LlamaConfig,
    seeds: torch.Tensor,  # [slots] per-slot sampling seeds
    temps: torch.Tensor,  # [slots] f32 — <= 0 greedy
) -> torch.Tensor:
    """One continuous-batching decode step over the whole slot array.

    -> next token [slots]; the pools are updated in place. Every slot
    advances one token against its own block table at its own position;
    inactive slots (table all trash, position 0) compute garbage that lands
    in the trash block and is never read. Each slot samples with the key
    (seed, position), ``position`` being where the token it reads sits.
    """
    num_blocks, bs = pools["k"].shape[1:3]
    check_range(
        ("paged_decode_step tables", tables, num_blocks),
        ("paged_decode_step positions", positions, tables.shape[1] * bs),
        ("paged_decode_step tokens", tokens, cfg.vocab_size),
    )
    x = params["embed"][tokens].to(cfg.dtype)[:, None, :]  # [slots, 1, d]
    cos_full, sin_full = rope_frequencies(
        cfg.head_dim, cfg.max_seq, cfg.rope_theta, device=tokens.device
    )
    cos, sin = cos_full[positions], sin_full[positions]  # [slots, hd/2]
    for i in range(cfg.n_layers):
        x = _paged_layer_step(
            cfg, cos, sin, positions, tables, x, _layer(params, i),
            pools["k"][i], pools["v"][i],
        )
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)[:, 0, :]  # [slots, d]
    logits = _lm_head_rows(params, x, cfg)
    return _sample_rows(logits, seeds, positions, temps)


@torch.no_grad()
def paged_prefill(
    params: llama.Params,
    prompts: torch.Tensor,  # [b, t], right-padded to the bucket width
    true_lens: torch.Tensor,  # [b] — real prompt lengths
    block_ids: torch.Tensor,  # [b, t // block_size] physical blocks per row
    pools: KVPools,
    cfg: llama.LlamaConfig,
    seeds: torch.Tensor,  # [b]
    temps: torch.Tensor,  # [b] f32
) -> torch.Tensor:
    """Prefill a bucket of prompts straight into the paged pools.

    Runs the dense prefill over the right-padded bucket (causal masking
    keeps every position < ``true_lens[i]`` exact despite the padding),
    writes the bucket's K/V into each row's assigned blocks in place, and
    samples the first token from the logits at ``true_lens[i] - 1``. ``t``
    must be a multiple of the pool block size; rows that need fewer blocks
    pad ``block_ids`` with the trash block. -> first token [b].
    """
    b, t = prompts.shape
    bs = pools["k"].shape[2]
    if t % bs:
        raise ValueError(f"bucket width {t} is not a multiple of block_size {bs}")
    check_range(
        ("paged_prefill block_ids", block_ids, pools["k"].shape[1]),
        ("paged_prefill true_lens - 1", true_lens - 1, t),
        ("paged_prefill prompts", prompts, cfg.vocab_size),
    )
    cache = init_kv_cache(cfg, b, t, prompts.device)
    logits, cache = _forward_with_cache(params, prompts, cache, 0, cfg)
    nb = t // bs
    kvh, hd = cfg.n_kv_heads, cfg.head_dim
    pools["k"][:, block_ids] = cache["k"].reshape(cfg.n_layers, b, nb, bs, kvh, hd)
    pools["v"][:, block_ids] = cache["v"].reshape(cfg.n_layers, b, nb, bs, kvh, hd)
    rows = torch.arange(b, device=prompts.device)
    last = logits[rows, true_lens - 1]  # [b, vocab]
    return _sample_rows(last, seeds, true_lens - 1, temps)


def _paged_chunk_layer_step(
    cfg: llama.LlamaConfig,
    cos: torch.Tensor,  # [b, t, hd/2] rope rows at each token's position
    sin: torch.Tensor,
    positions: torch.Tensor,  # [b, t] absolute cache positions
    valid: torch.Tensor,  # [b, t] bool — real suffix tokens
    tables: torch.Tensor,  # [b, blocks_per_slot]
    x: torch.Tensor,  # [b, t, d]
    layer: dict[str, torch.Tensor],
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
) -> torch.Tensor:
    b, t, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    attn_in = rms_norm(x, layer["attn_norm"], cfg.norm_eps)
    q = _rope_chunk((attn_in @ layer["wq"]).reshape(b, t, h, hd), cos, sin)
    k = _rope_chunk((attn_in @ layer["wk"]).reshape(b, t, kvh, hd), cos, sin)
    v = (attn_in @ layer["wv"]).reshape(b, t, kvh, hd)
    _scatter_kv_chunk(k_pool, tables, positions, k, valid)
    _scatter_kv_chunk(v_pool, tables, positions, v, valid)
    attn = _paged_attention_chunk(q, k_pool, v_pool, tables, positions)
    x = x + attn.reshape(b, t, h * hd) @ layer["wo"]
    mlp_in = rms_norm(x, layer["mlp_norm"], cfg.norm_eps)
    down, _aux = llama.ffn(cfg, layer, mlp_in)
    return x + down


@torch.no_grad()
def paged_prefill_chunk(
    params: llama.Params,
    tokens: torch.Tensor,  # [b, t] suffix tokens, right-padded
    prefix_lens: torch.Tensor,  # [b] — cached tokens already in the pool
    suffix_lens: torch.Tensor,  # [b] — real suffix lengths (>= 1)
    tables: torch.Tensor,  # [b, blocks_per_slot] full per-row block tables
    pools: KVPools,
    cfg: llama.LlamaConfig,
    seeds: torch.Tensor,  # [b]
    temps: torch.Tensor,  # [b] f32
) -> torch.Tensor:
    """Prefill only the *uncached suffix* of each prompt against the pool.

    Row ``i``'s first ``prefix_lens[i]`` tokens already sit in cached
    blocks of ``tables[i]``; this computes K/V for the suffix chunk,
    scatters it into the row's fresh blocks in place, and attends each
    suffix token causally over cached prefix + chunk. With ``prefix_lens =
    0`` it is a cold paged prefill, so cached and cold requests run the
    same program. ``t`` is the suffix bucket width; the first token is
    sampled from the logits at each row's last real suffix position, keyed
    by its absolute position. -> first token [b].
    """
    b, t = tokens.shape
    dev = tokens.device
    check_range(
        ("paged_prefill_chunk tables", tables, pools["k"].shape[1]),
        ("paged_prefill_chunk tokens", tokens, cfg.vocab_size),
        ("paged_prefill_chunk suffix_lens - 1", suffix_lens - 1, t),
        ("paged_prefill_chunk prefix_lens", prefix_lens, cfg.max_seq),
    )
    x = params["embed"][tokens].to(cfg.dtype)  # [b, t, d]
    cos_full, sin_full = rope_frequencies(cfg.head_dim, cfg.max_seq, cfg.rope_theta, device=dev)
    positions = prefix_lens[:, None] + torch.arange(t, device=dev)[None, :]
    pos_safe = torch.clamp(positions, 0, cfg.max_seq - 1)
    cos, sin = cos_full[pos_safe], sin_full[pos_safe]  # [b, t, hd/2]
    valid = torch.arange(t, device=dev)[None, :] < suffix_lens[:, None]
    for i in range(cfg.n_layers):
        x = _paged_chunk_layer_step(
            cfg, cos, sin, positions, valid, tables, x, _layer(params, i),
            pools["k"][i], pools["v"][i],
        )
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)  # [b, t, d]
    last = x[torch.arange(b, device=dev), suffix_lens - 1]  # [b, d]
    logits = _lm_head_rows(params, last, cfg)
    return _sample_rows(logits, seeds, prefix_lens + suffix_lens - 1, temps)
