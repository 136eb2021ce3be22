"""The port's serving path against the JAX package's, on the CPU: the
paged-KV ops (pool writes bitwise, attention within 2e-5), paged prefill +
decode against dense greedy, the host-side pool bookkeeping replayed op by
op, and the continuous-batching engine (greedy tokens equal to the JAX
engine's across mixed prompt lengths, shared steps, EOS, the sampling
contract, preemption, prefix reuse, the handoff seam and in-place pools).
f32, the ``tiny`` config; weights from the JAX ``init_params`` through
``convert.params_from_jax(requires_grad=False)``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchx_tpu.models import llama as jllama
from torchx_tpu.ops import paged_attention as jpa
from torchx_tpu.serve import engine as jengine
from torchx_tpu.serve import kv_pool as jkv_pool
from torchx_tpu.serve import prefix_cache as jprefix
from torchx_tpu_torch import convert
from torchx_tpu_torch.models import generate as tgen
from torchx_tpu_torch.models import llama as tllama
from torchx_tpu_torch.obs import metrics
from torchx_tpu_torch.ops import paged_attention as tpa
from torchx_tpu_torch.serve import kv_pool as tkv_pool
from torchx_tpu_torch.serve import prefix_cache as tprefix
from torchx_tpu_torch.serve.engine import EngineStopped, ServeEngine, ServeRequest
from torchx_tpu_torch.serve.kv_transfer import KvPayload
from torch_threads import xdist_torch_threads  # noqa: F401

GIB = 1024**3


@pytest.fixture(scope="module")
def tiny():
    cfg_j = jllama.CONFIGS["tiny"]()
    cfg_t = tllama.llama_tiny()
    p_j = jllama.init_params(cfg_j, jax.random.PRNGKey(0))
    p_t = convert.params_from_jax(jax.tree.map(np.asarray, p_j), cfg_t, requires_grad=False)
    return cfg_j, cfg_t, p_j, p_t


def dense(p_t, cfg_t, prompt, max_new, temperature=0.0, seed=0):
    out = tgen.generate(p_t, torch.tensor([prompt]), cfg_t, max_new,
                        temperature=temperature, seed=seed)
    return out[0].tolist()


# -- the paged ops ------------------------------------------------------------


def _pools(seed, nb=12, bs=4, kvh=2, hd=8):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((nb, bs, kvh, hd)).astype(np.float32),
            rng.standard_normal((nb, bs, kvh, hd)).astype(np.float32))


TABLES = np.array([[3, 5, 1, 0], [2, 7, 9, 0], [0, 0, 0, 0]], np.int32)


class TestPagedOps:
    def test_gather_kv_bitwise(self):
        k, _ = _pools(0)
        got = tpa.gather_kv(torch.from_numpy(k), torch.from_numpy(TABLES).long())
        want = np.asarray(jpa.gather_kv(jnp.asarray(k), jnp.asarray(TABLES)))
        assert np.array_equal(got.numpy(), want)

    def test_append_kv_bitwise_and_in_place(self):
        k, _ = _pools(1)
        new = np.random.default_rng(2).standard_normal((3, 2, 8)).astype(np.float32)
        pos = np.array([9, 5, 0], np.int32)  # slot 2 is inactive: trash
        pool = torch.from_numpy(k.copy())
        ptr = pool.data_ptr()
        out = tpa.append_kv(pool, torch.from_numpy(TABLES).long(),
                            torch.from_numpy(pos).long(), torch.from_numpy(new))
        want = np.asarray(jpa.append_kv(jnp.asarray(k), jnp.asarray(TABLES),
                                        jnp.asarray(pos), jnp.asarray(new)))
        assert out is pool and pool.data_ptr() == ptr
        assert np.array_equal(pool.numpy(), want)

    def test_scatter_kv_chunk_bitwise_with_padding(self):
        k, _ = _pools(3)
        pos = np.array([[6, 7, 8, 9], [9, 10, 11, 40], [0, 1, 2, 3]], np.int32)
        valid = np.array([[1, 1, 1, 0], [1, 1, 0, 0], [0, 0, 0, 0]], bool)
        new = np.random.default_rng(4).standard_normal((3, 4, 2, 8)).astype(np.float32)
        pool = torch.from_numpy(k.copy())
        tpa.scatter_kv_chunk(pool, torch.from_numpy(TABLES).long(), torch.from_numpy(pos).long(),
                             torch.from_numpy(new), torch.from_numpy(valid))
        want = np.asarray(jpa.scatter_kv_chunk(
            jnp.asarray(k), jnp.asarray(TABLES), jnp.asarray(pos), jnp.asarray(new),
            jnp.asarray(valid)))
        # padding collides in the trash block, whose contents nobody reads
        assert np.array_equal(pool.numpy()[1:], want[1:])

    def test_write_prefill_bitwise(self):
        k, _ = _pools(5)
        ids = np.array([4, 6, 0], np.int32)
        kv = np.random.default_rng(6).standard_normal((12, 2, 8)).astype(np.float32)
        pool = torch.from_numpy(k.copy())
        tpa.write_prefill(pool, torch.from_numpy(ids).long(), torch.from_numpy(kv))
        want = np.asarray(jpa.write_prefill(jnp.asarray(k), jnp.asarray(ids), jnp.asarray(kv)))
        assert np.array_equal(pool.numpy(), want)

    @pytest.mark.parametrize("h", [2, 4])
    def test_paged_attention_matches_jax(self, h):
        k, v = _pools(7)
        q = np.random.default_rng(8).standard_normal((3, h, 8)).astype(np.float32)
        lengths = np.array([10, 11, 1], np.int32)
        got = tpa.paged_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                  torch.from_numpy(TABLES).long(), torch.from_numpy(lengths))
        want = jpa.paged_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   jnp.asarray(TABLES), jnp.asarray(lengths))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)

    def test_paged_attention_chunk_matches_jax(self):
        k, v = _pools(9)
        q = np.random.default_rng(10).standard_normal((3, 4, 4, 8)).astype(np.float32)
        pos = np.array([[6, 7, 8, 9], [9, 10, 11, 12], [0, 1, 2, 3]], np.int32)
        got = tpa.paged_attention_chunk(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            torch.from_numpy(TABLES).long(), torch.from_numpy(pos).long())
        want = jpa.paged_attention_chunk(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         jnp.asarray(TABLES), jnp.asarray(pos))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)

    def test_out_of_range_indices_raise(self):
        k, _ = _pools(0)
        bad = torch.from_numpy(TABLES).long().clone()
        bad[1, 0] = 12
        with pytest.raises(IndexError, match="out of range"):
            tpa.gather_kv(torch.from_numpy(k), bad)
        with pytest.raises(IndexError, match="out of range"):
            tpa.append_kv(torch.from_numpy(k), torch.from_numpy(TABLES).long(),
                          torch.tensor([16, 0, 0]), torch.zeros((3, 2, 8)))
        with pytest.raises(IndexError, match="out of range"):
            tpa.write_prefill(torch.from_numpy(k), torch.tensor([-1]), torch.zeros((4, 2, 8)))


def test_paged_prefill_plus_decode_matches_dense_greedy(tiny):
    """The JAX package's tests/test_serve_engine.py equivalence, on the
    port: a bucket prefill into the pool, then decode steps over a fixed
    slot array with lazy block growth, equal to dense greedy decoding."""
    _, cfg, _, params = tiny
    bs = 8
    pools = tgen.init_kv_pools(cfg, num_blocks=33, block_size=bs)
    alloc = tkv_pool.BlockAllocator(33)
    prompts = [[1, 2, 3], [4, 5, 6, 7, 8], [9]]
    max_new = 6
    pad = np.zeros((4, bs), np.int64)
    true_lens = np.ones((4,), np.int64)
    rows_blocks = np.full((4, 1), tpa.TRASH_BLOCK, np.int64)
    held = []
    for i, p in enumerate(prompts):
        pad[i, : len(p)] = p
        true_lens[i] = len(p)
        held.append(alloc.alloc(1))
        rows_blocks[i, 0] = held[-1][0]
    zeros = torch.zeros(4, dtype=torch.long)
    first = tgen.paged_prefill(params, torch.from_numpy(pad), torch.from_numpy(true_lens),
                               torch.from_numpy(rows_blocks), pools, cfg, zeros,
                               torch.zeros(4))
    tables = tkv_pool.SlotTables(max_slots=4, blocks_per_slot=cfg.max_seq // bs)
    out = [list(p) for p in prompts]
    last = [int(first[i]) for i in range(3)]
    lens = [int(x) for x in true_lens[:3]]
    for i in range(3):
        tables.assign(i, held[i])
        out[i].append(last[i])
    for _ in range(max_new - 1):
        for i in range(3):
            if lens[i] + 1 > tables.token_capacity(i, bs):
                tables.assign(i, alloc.alloc(1))
        nxt = tgen.paged_decode_step(
            params, torch.tensor(last + [0]), torch.tensor(lens + [0]),
            torch.from_numpy(tables.tables).long(), pools, cfg, zeros, torch.zeros(4))
        for i in range(3):
            out[i].append(int(nxt[i]))
            last[i] = int(nxt[i])
            lens[i] += 1
    for i, p in enumerate(prompts):
        assert out[i] == dense(params, cfg, p, max_new), f"row {i} diverged"


def test_decode_step_writes_pools_in_place(tiny):
    _, cfg, _, params = tiny
    pools = tgen.init_kv_pools(cfg, 9, 8)
    ptrs = {k: v.data_ptr() for k, v in pools.items()}
    before = {k: v.clone() for k, v in pools.items()}
    tables = torch.zeros((2, cfg.max_seq // 8), dtype=torch.long)
    tables[0, 0] = 3
    tgen.paged_decode_step(params, torch.tensor([5, 0]), torch.tensor([2, 0]), tables, pools,
                           cfg, torch.zeros(2, dtype=torch.long), torch.zeros(2))
    for k, v in pools.items():
        assert v.data_ptr() == ptrs[k] and not v.requires_grad
        assert not torch.equal(v[:, 3, 2], before[k][:, 3, 2])  # the new token's row
        assert torch.equal(v[:, 4:], before[k][:, 4:])  # nothing else moved


# -- host-side bookkeeping, replayed against the JAX package's ------------------


class TestBookkeeping:
    def test_plan_pool_matches_jax(self, tiny):
        cfg_j, cfg_t, _, _ = tiny
        for kw in (dict(block_size=16), dict(block_size=8, max_slots=3),
                   dict(block_size=16, mean_tokens_per_seq=40)):
            pj = jkv_pool.plan_pool(cfg_j, hbm_bytes=GIB, headroom=0.9, **kw)
            pt = tkv_pool.plan_pool(cfg_t, hbm_bytes=GIB, headroom=0.9, **kw)
            assert pt == tkv_pool.PoolPlan(**vars(pj))
            assert pt.occupancy_report() == pj.occupancy_report()
        with pytest.raises(ValueError, match="exceed"):
            tkv_pool.plan_pool(tllama.llama3_1b(), hbm_bytes=GIB)

    def test_plan_pool_default_needs_the_card(self, tiny, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tkv_pool.plan_pool(tiny[1])

    def test_allocator_and_tables_replay(self):
        ja, ta = jkv_pool.BlockAllocator(10), tkv_pool.BlockAllocator(10)
        jt, tt = jkv_pool.SlotTables(3, 4), tkv_pool.SlotTables(3, 4)
        ops = [("alloc", 3), ("alloc", 4), ("retain", [1, 2]), ("release", [1]),
               ("alloc", 5), ("release", [2, 3]), ("alloc", 2), ("release", [1, 4, 5]),
               ("alloc", 9), ("alloc", 3)]
        for op, arg in ops:
            assert getattr(ta, op)(arg) == getattr(ja, op)(arg), (op, arg)
            assert (ta.free_blocks, ta.used_blocks) == (ja.free_blocks, ja.used_blocks)
        for a in (ja, ta):
            with pytest.raises(ValueError):
                a.release([0])
        for t in (jt, tt):
            t.assign(0, [4, 5])
            t.assign(2, [7])
            t.replace_block(0, 1, 9)
            t.lengths[0] = 7
        assert np.array_equal(tt.tables, jt.tables) and np.array_equal(tt.lengths, jt.lengths)
        assert tt.release(0) == jt.release(0)
        assert np.array_equal(tt.tables, jt.tables)

    def test_prefix_cache_replay(self):
        caches = []
        for kv_pool, prefix in ((jkv_pool, jprefix), (tkv_pool, tprefix)):
            alloc = kv_pool.BlockAllocator(16)
            cache = prefix.PrefixCache(alloc, 4, max_blocks=6)
            log = []
            seq_a = list(range(1, 14))
            seq_b = seq_a[:8] + [50, 51, 52, 53, 54]
            blocks_a = alloc.alloc(4)
            cache.insert(seq_a, blocks_a)
            alloc.release(blocks_a)
            log.append(cache.match(seq_b))
            log.append(cache.match(seq_a))
            blocks_b = alloc.alloc(4)
            cache.insert(seq_b, blocks_b)
            log.append(cache.evict(2))
            log.append(cache.stats())
            log.append(cache.summary(8))
            log.append((alloc.free_blocks, alloc.used_blocks))
            caches.append(log)
        assert caches[0] == caches[1]
        assert tprefix.prefix_chain(list(range(40)), 8) == jprefix.prefix_chain(
            list(range(40)), 8)


# -- the engine -------------------------------------------------------------


@pytest.fixture(scope="module")
def engine(tiny):
    _, cfg, _, params = tiny
    eng = ServeEngine(params, cfg, max_slots=4, block_size=8, max_prefill_batch=2).start()
    yield eng
    eng.stop()


MIXED = [[1, 2, 3], [7, 8], [4, 5, 6, 7, 8, 9, 10], [11], [3, 1], list(range(20, 40))]


class TestServeEngine:
    def test_greedy_matches_jax_engine_across_mixed_lengths(self, tiny, engine):
        cfg_j, _, p_j, _ = tiny
        reqs = [engine.submit(ServeRequest(prompt=p, max_new_tokens=5)) for p in MIXED]
        jeng = jengine.ServeEngine(p_j, cfg_j, max_slots=4, block_size=8,
                                   max_prefill_batch=2).start()
        try:
            jreqs = [jeng.submit(jengine.ServeRequest(prompt=p, max_new_tokens=5))
                     for p in MIXED]
            for r in jreqs:
                assert r.wait(timeout=120) and r.error is None
        finally:
            jeng.stop()
        for r, jr in zip(reqs, jreqs):
            assert r.wait(timeout=120) and r.error is None
            assert r.tokens == jr.tokens

    def test_greedy_matches_dense(self, tiny, engine):
        _, cfg, _, params = tiny
        reqs = [engine.submit(ServeRequest(prompt=p, max_new_tokens=7)) for p in MIXED]
        for p, r in zip(MIXED, reqs):
            assert r.wait(timeout=120) and r.error is None
            assert r.tokens == dense(params, cfg, p, 7)

    def test_continuous_batching_shares_steps(self, engine):
        steps0 = engine.steps
        reqs = [engine.submit(ServeRequest(prompt=[i + 1, i + 2], max_new_tokens=6))
                for i in range(4)]
        for r in reqs:
            assert r.wait(timeout=120)
        assert engine.steps - steps0 < 4 * 6

    def test_eos_at_its_first_occurrence(self, tiny, engine):
        _, cfg, _, params = tiny
        prompt = [4, 5, 6, 7, 8, 9, 10]
        full = dense(params, cfg, prompt, 8)
        gen_toks = full[len(prompt):]
        # the first generated token that does not occur earlier in the
        # stream: the engine must stop right after emitting it
        j = next(i for i in range(1, len(gen_toks)) if gen_toks[i] not in gen_toks[:i])
        r = engine.generate(prompt, max_new_tokens=8, eos_id=gen_toks[j], timeout=120)
        assert r.generated == gen_toks[: j + 1]

    def test_sampled_determinism_and_seed_sensitivity(self, tiny, engine):
        _, cfg, _, params = tiny
        a = engine.generate([5, 6], 6, temperature=0.8, seed=42, timeout=120)
        b = engine.generate([5, 6], 6, temperature=0.8, seed=42, timeout=120)
        c = engine.generate([5, 6], 6, temperature=0.8, seed=43, timeout=120)
        assert a.tokens == b.tokens
        assert a.tokens != c.tokens
        # (seed, position) keys: the dense path draws the same tokens
        assert a.tokens == dense(params, cfg, [5, 6], 6, temperature=0.8, seed=42)

    def test_submit_validation(self, tiny, engine):
        _, cfg, _, _ = tiny
        with pytest.raises(ValueError, match="max_seq"):
            engine.submit(ServeRequest(prompt=[1] * cfg.max_seq, max_new_tokens=4))
        with pytest.raises(ValueError, match="max_new_tokens"):
            engine.submit(ServeRequest(prompt=[1], max_new_tokens=0))
        with pytest.raises(ValueError, match="token ids"):
            engine.submit(ServeRequest(prompt=[1, cfg.vocab_size], max_new_tokens=2))

    def test_stats_shape(self, engine):
        s = engine.stats()
        for k in ("active_slots", "occupancy", "queue_depth", "kv_blocks_used",
                  "requests_done", "steps", "prefix_cache", "failure"):
            assert k in s
        assert s["failure"] is None

    def test_warm_prefix_hit_equals_cold(self, tiny):
        _, cfg, _, params = tiny
        eng = ServeEngine(params, cfg, max_slots=2, block_size=4).start()
        try:
            prompt = list(range(30, 51))
            cold = eng.generate(prompt, 6, temperature=0.7, seed=3, timeout=120)
            hits = eng.stats()["prefix_cache"]["hits"]
            warm = eng.generate(prompt, 6, temperature=0.7, seed=3, timeout=120)
            assert eng.stats()["prefix_cache"]["hits"] == hits + 1
            assert warm.tokens == cold.tokens
            greedy = eng.generate(prompt, 6, timeout=120)
            assert greedy.tokens == dense(params, cfg, prompt, 6)
        finally:
            eng.stop()

    def test_preemption_under_block_pressure_preserves_tokens(self, tiny):
        _, cfg, _, params = tiny
        # 16 usable blocks of 8 tokens against 4 sequences of 43 tokens (6
        # blocks each): the youngest slots are preempted and resumed
        eng = ServeEngine(params, cfg, max_slots=4, block_size=8, num_blocks=17).start()
        try:
            preempted = metrics.SERVE_PREEMPTIONS.value()
            prompts = [[i + 1, i + 2, i + 3] for i in range(4)]
            reqs = [eng.submit(ServeRequest(prompt=p, max_new_tokens=40, temperature=t,
                                            seed=i))
                    for i, (p, t) in enumerate(zip(prompts, (0.0, 0.9, 0.0, 0.9)))]
            for r in reqs:
                assert r.wait(timeout=240) and r.error is None
            assert metrics.SERVE_PREEMPTIONS.value() > preempted
            for i, (p, r) in enumerate(zip(prompts, reqs)):
                assert r.tokens == dense(params, cfg, p, 40, r.temperature, seed=i)
        finally:
            eng.stop()

    def test_submit_prefilled_payload_equals_unified(self, tiny):
        _, cfg, _, params = tiny
        prompt = list(range(60, 75))
        eng = ServeEngine(params, cfg, max_slots=2, block_size=4).start()
        try:
            unified = eng.generate(prompt, 8, temperature=0.6, seed=9, timeout=120)
            req = eng.submit(ServeRequest(prompt=prompt, max_new_tokens=8, temperature=0.6,
                                          seed=9, prefill_only=True))
            assert req.wait(timeout=120) and req.error is None
            payload = KvPayload.from_bytes(req.handoff.to_bytes())
        finally:
            eng.stop()
        decode = ServeEngine(params, cfg, max_slots=2, block_size=4,
                             enable_prefix_cache=False).start()
        try:
            from torchx_tpu_torch.serve.engine import serve_kv_payload

            reply = serve_kv_payload(decode, payload, timeout=120)
        finally:
            decode.stop()
        assert prompt + reply["tokens"] == unified.tokens

    def test_drain_then_submit_raises(self, tiny):
        _, cfg, _, params = tiny
        eng = ServeEngine(params, cfg, max_slots=2, block_size=8).start()
        try:
            r = eng.submit(ServeRequest(prompt=[1, 2], max_new_tokens=3))
            assert eng.drain(timeout=120) is True
            assert r.done.is_set() and r.error is None
            with pytest.raises(EngineStopped):
                eng.submit(ServeRequest(prompt=[1], max_new_tokens=1))
        finally:
            eng.stop()

    def test_geometry_and_grad_validation(self, tiny):
        _, cfg, _, params = tiny
        with pytest.raises(ValueError, match="power of 2"):
            ServeEngine(params, cfg, block_size=12)
        with pytest.raises(ValueError, match="num_blocks"):
            ServeEngine(params, cfg, block_size=8, num_blocks=4)
        trainable = tllama.init_params(cfg, torch.Generator().manual_seed(0))
        with pytest.raises(ValueError, match="require grad"):
            ServeEngine(trainable, cfg)
        plan = tkv_pool.plan_pool(cfg, hbm_bytes=GIB, block_size=8, max_slots=2)
        eng = ServeEngine.from_plan(params, cfg, plan)
        assert (eng.max_slots, eng.block_size, eng.num_blocks) == (2, 8, plan.num_blocks)

    def test_a_failed_step_stops_the_engine(self, tiny, monkeypatch):
        _, cfg, _, params = tiny
        eng = ServeEngine(params, cfg, max_slots=2, block_size=8)

        def boom(*a, **k):
            raise RuntimeError("device fault")

        monkeypatch.setattr(tgen, "paged_prefill_chunk", boom)
        eng.start()
        try:
            r = eng.submit(ServeRequest(prompt=[1, 2], max_new_tokens=3))
            assert r.wait(timeout=60) and "device fault" in r.error
            with pytest.raises(EngineStopped, match="device fault"):
                eng.submit(ServeRequest(prompt=[1], max_new_tokens=1))
            assert "device fault" in eng.stats()["failure"]
        finally:
            eng.stop()
