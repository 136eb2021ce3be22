"""Parity of the PyTorch port's MoE family (``torchx_tpu_torch.models.moe``)
with the JAX package's, on the CPU, ``moe_tiny`` in f32: the MoE FFN and its
router aux (with forced capacity overflow), the loss with the router term
and every gradient, a 3-step AdamW trajectory, the serving engine against
the JAX engine, ``generate_server --config moe_tiny`` over HTTP, and a MoE
checkpoint saved, resumed bitwise and verified by ``eval_main``.

Weights come from the JAX ``moe.init_params`` through
``torchx_tpu_torch.convert``; inputs are made with numpy from a seed.
Tolerances are the dense tests' (tests/test_torch_model.py).
"""

import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchx_tpu.examples import train_llama as jtrain
from torchx_tpu.models import llama as jllama
from torchx_tpu.models import moe as jmoe
from torchx_tpu.serve import engine as jengine
from torchx_tpu_torch import convert
from torchx_tpu_torch.apps import eval_main as teval
from torchx_tpu_torch.apps import generate_server as gs
from torchx_tpu_torch.examples import train_llama as ttrain
from torchx_tpu_torch.models import generate as tgen
from torchx_tpu_torch.models import llama as tllama
from torchx_tpu_torch.models import moe as tmoe
from torchx_tpu_torch.obs import profile as tprofile
from torchx_tpu_torch.serve.engine import ServeEngine, ServeRequest
from torch_threads import xdist_torch_threads  # noqa: F401

JAX_KERNELS = {"reference": "reference", "cuda": "interpret"}


def _cfgs(**kw):
    return jmoe.moe_tiny(**kw), tmoe.moe_tiny(**kw)


def _params(cfg_j, cfg_t, seed=71, requires_grad=True):
    p_j = jmoe.init_params(cfg_j, jax.random.PRNGKey(seed))
    p_t = convert.params_from_jax(
        jax.tree.map(np.asarray, p_j), cfg_t, requires_grad=requires_grad
    )
    return p_j, p_t


def _named_leaves(params, prefix=""):
    out = []
    for key in sorted(params):
        val = params[key]
        if isinstance(val, dict):
            out.extend(_named_leaves(val, f"{prefix}{key}/"))
        else:
            out.append((f"{prefix}{key}", val))
    return out


def _tokens(seed, shape=(2, 65), vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


class TestConfig:
    @pytest.mark.parametrize("name", ["moe_tiny", "mixtral_8x7b"])
    def test_counts_match_jax(self, name):
        cfg_j, cfg_t = jmoe.CONFIGS[name](), tmoe.CONFIGS[name]()
        assert cfg_t.param_count() == cfg_j.param_count()
        assert cfg_t.active_param_count() == cfg_j.active_param_count()
        assert cfg_t.flops_per_token() == cfg_j.flops_per_token()
        for field in ("dim", "n_layers", "n_heads", "n_kv_heads", "ffn_dim", "vocab_size",
                      "n_experts", "top_k", "capacity_factor", "router_aux_coef",
                      "rope_theta", "tie_embeddings", "max_seq"):
            assert getattr(cfg_t, field) == getattr(cfg_j, field), field

    def test_presets_resolve_through_llama(self):
        assert set(tmoe.CONFIGS) <= set(tllama.all_configs())
        cfg = tllama.get_config("mixtral_8x7b")
        assert isinstance(cfg, tmoe.MoEConfig) and cfg.n_experts == 8 and cfg.top_k == 2
        with pytest.raises(ValueError, match="unknown config"):
            tllama.get_config("nope")

    def test_init_layout_and_scale(self):
        cfg = tmoe.moe_tiny(n_layers=3)
        p = tmoe.init_params(cfg, torch.Generator().manual_seed(0))
        shapes = {k: tuple(v.shape) for k, v in p["layers"].items()}
        want = convert.expected_shapes(cfg)["layers"]
        assert shapes == want
        assert want["w_gate"] == (3, 4, 64, 128) and want["w_router"] == (3, 64, 4)
        # each expert's matrix drawn on its own, at the dense init's scale
        np.testing.assert_allclose(p["layers"]["w_down"].detach().std().item(), 128**-0.5,
                                   rtol=0.05)
        assert not torch.equal(p["layers"]["w_gate"][0, 0], p["layers"]["w_gate"][0, 1])
        assert all(t.requires_grad for t in tllama.leaves(p))


class TestMoeFfn:
    @pytest.mark.parametrize("capacity_factor", [2.0, 0.5])
    def test_matches_jax(self, capacity_factor):
        cfg_j, cfg_t = _cfgs(capacity_factor=capacity_factor)
        p_j, p_t = _params(cfg_j, cfg_t)
        layer_j = {k: v[0] for k, v in p_j["layers"].items()}
        layer_t = {k: v[0].detach() for k, v in p_t["layers"].items()}
        x = np.random.default_rng(72).standard_normal((2, 32, 64)).astype(np.float32)
        out_j, aux_j = jmoe.moe_ffn(cfg_j, layer_j, jnp.asarray(x))
        out_t, aux_t = tmoe.moe_ffn(cfg_t, layer_t, torch.from_numpy(x))
        np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(aux_t.numpy(), np.asarray(aux_j), rtol=1e-6, atol=1e-6)
        # a token whose every choice was dropped comes out exactly 0: the
        # same tokens in both
        dropped_j = np.all(np.asarray(out_j) == 0, axis=-1)
        dropped_t = np.all(out_t.numpy() == 0, axis=-1)
        np.testing.assert_array_equal(dropped_t, dropped_j)
        if capacity_factor < 1:
            assert float(aux_t[tllama.AUX_OVERFLOW]) > 0 and dropped_t.any()
        else:
            # each expert takes a token at most once, and capacity is s
            assert float(aux_t[tllama.AUX_OVERFLOW]) == 0

    def test_decode_width_drops_nothing(self):
        """At s = 1 (the decode step) the capacity is 1 per expert per
        row, and the top-k experts are distinct: nothing drops."""
        cfg = tmoe.mixtral_8x7b_shape(dim=64, n_heads=4, n_kv_heads=2, ffn_dim=32,
                                      vocab_size=64, n_layers=1, dtype=torch.float32)
        p = tmoe.init_params(cfg, torch.Generator().manual_seed(1))
        layer = {k: v[0].detach() for k, v in p["layers"].items()}
        _, aux = tmoe.moe_ffn(cfg, layer, torch.randn(8, 1, 64))
        assert float(aux[tllama.AUX_OVERFLOW]) == 0

    def test_aux_gradient_reaches_the_router_only_through_balance(self):
        cfg = tmoe.moe_tiny()
        p = tmoe.init_params(cfg, torch.Generator().manual_seed(2))
        layer = {k: v[0] for k, v in p["layers"].items()}
        _, aux = tmoe.moe_ffn(cfg, layer, torch.randn(2, 16, 64))
        (g_ent,) = torch.autograd.grad(aux[1] + aux[2], layer["w_router"], allow_unused=True,
                                       retain_graph=True)
        assert g_ent is None or torch.count_nonzero(g_ent) == 0
        (g_bal,) = torch.autograd.grad(aux[0], layer["w_router"])
        assert torch.count_nonzero(g_bal) > 0


class TestLossAndGrads:
    @pytest.mark.parametrize("kernels,loss_chunk", [("reference", 512), ("cuda", 32)])
    def test_matches_jax(self, kernels, loss_chunk):
        """dim 128 / head_dim 64 so that ``kernels="cuda"`` routes every
        layer through the kernel wrappers (their plain versions here) while
        the JAX side runs its Pallas kernels in interpret mode."""
        shape = dict(dim=128, n_heads=2, n_kv_heads=1, ffn_dim=256, loss_chunk=loss_chunk)
        cfg_j = jmoe.moe_tiny(kernels=JAX_KERNELS[kernels], **shape)
        cfg_t = tmoe.moe_tiny(kernels=kernels, **shape)
        p_j, p_t = _params(cfg_j, cfg_t, seed=73)
        tok = _tokens(74, (2, 129))
        (l_j, aux_j), g_j = jax.value_and_grad(jllama.loss_and_aux, has_aux=True)(
            p_j, {"tokens": jnp.asarray(tok)}, cfg_j
        )
        l_t, aux_t = tllama.loss_and_aux(p_t, {"tokens": torch.from_numpy(tok)}, cfg_t)
        l_t.backward()
        # the router term is in both losses
        assert float(aux_t[tllama.AUX_BALANCE].detach()) > 0.5
        np.testing.assert_allclose(l_t.item(), float(l_j), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(aux_t.detach().numpy(), np.asarray(aux_j),
                                   rtol=1e-6, atol=1e-6)
        grads_j = jax.tree.leaves(g_j)
        named = _named_leaves(p_t)
        assert len(grads_j) == len(named)
        for g, (name, p) in zip(grads_j, named):
            assert p.grad is not None, name
            np.testing.assert_allclose(
                p.grad.numpy(), np.asarray(g), rtol=5e-4, atol=5e-5, err_msg=name
            )

    def test_router_coefficient_is_applied(self):
        cfg0, cfg1 = tmoe.moe_tiny(router_aux_coef=0.0), tmoe.moe_tiny(router_aux_coef=0.5)
        p = tmoe.init_params(cfg0, torch.Generator().manual_seed(3))
        batch = {"tokens": torch.from_numpy(_tokens(75))}
        with torch.no_grad():
            l0, aux = tllama.loss_and_aux(p, batch, cfg0)
            l1, _ = tllama.loss_and_aux(p, batch, cfg1)
        torch.testing.assert_close(l1 - l0, 0.5 * aux[tllama.AUX_BALANCE], rtol=1e-5, atol=1e-6)

    def test_remat_matches_no_remat(self):
        """Remat recomputes the routing in the backward: grads and the aux
        vector through ``checkpoint`` equal the unrematerialised ones."""
        cfg, cfg_r = tmoe.moe_tiny(), tmoe.moe_tiny(remat=True)
        p = tmoe.init_params(cfg, torch.Generator().manual_seed(4))
        batch = {"tokens": torch.from_numpy(_tokens(76))}
        outs = []
        for c in (cfg, cfg_r):
            loss, aux = tllama.loss_and_aux(p, batch, c)
            outs.append((aux.detach(), torch.autograd.grad(loss, tllama.leaves(p))))
        torch.testing.assert_close(outs[0][0], outs[1][0], rtol=0, atol=0)
        for a, b in zip(outs[0][1], outs[1][1]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


class TestTrainer:
    def test_trajectory_matches_jax(self):
        """3 steps of make_train_step + make_optimizer (warmup 2, lr 3e-4)
        in f32: losses, router aux and final parameters within 1e-4 of the
        JAX trainer's (see tests/test_torch_model.py for why 1e-4 holds at
        this lr)."""
        cfg_j, cfg_t = _cfgs()
        p_j, p_t = _params(cfg_j, cfg_t, seed=77)
        opt_j = jtrain.make_optimizer(lr=3e-4, warmup=2)
        state = jtrain.TrainState(
            params=p_j, opt_state=opt_j.init(p_j), step=jnp.zeros((), jnp.int32)
        )
        step_j = jtrain.make_train_step(cfg_j, None, opt_j)
        step_t = ttrain.make_train_step(
            cfg_t, ttrain.make_optimizer(tllama.leaves(p_t), lr=3e-4, warmup=2)
        )
        rng = np.random.default_rng(78)
        for _ in range(3):
            tok = rng.integers(0, 512, (2, 65)).astype(np.int32)
            state, loss_j, aux_j = step_j(state, {"tokens": jnp.asarray(tok)})
            out = step_t(p_t, {"tokens": torch.from_numpy(tok)})
            np.testing.assert_allclose(float(out["loss"]), float(loss_j), rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(out["aux"].numpy(), np.asarray(aux_j),
                                       rtol=1e-4, atol=1e-4)
        for a, (name, b) in zip(jax.tree.leaves(state.params), _named_leaves(p_t)):
            np.testing.assert_allclose(
                b.detach().numpy(), np.asarray(a), rtol=1e-4, atol=1e-4, err_msg=name
            )

    def test_main_prints_router_fields(self, capsys):
        ttrain.main(["--config", "moe_tiny", "--batch", "2", "--seq", "32", "--steps", "2",
                     "--device", "cpu"])
        out = capsys.readouterr().out
        lines = [x for x in out.splitlines() if x.startswith("step ")]
        assert len(lines) == 2
        for line in lines:
            for field in ("router_aux=", "router_entropy=", "router_overflow="):
                assert field in line, line
        final = json.loads(out.split("final:", 1)[1])
        for key in ("router_aux", "router_entropy", "router_overflow"):
            assert len(final[key]) == 2 and all(np.isfinite(final[key]))
        assert all(0 < e <= 1 for e in final["router_entropy"])

    def test_dense_results_carry_no_router_fields(self):
        out = ttrain.train(tllama.llama_tiny(), 2, 16, 1, device="cpu", log_every=0)
        assert "router_aux" not in out

    def test_profile_records_take_the_moe_arithmetic(self, tmp_path, monkeypatch):
        """The step profiler's model carries the MoE config's own
        flops_per_token (active parameters) and param_count (all)."""
        monkeypatch.setenv("TPX_OBS_DIR", str(tmp_path))
        cfg = tmoe.moe_tiny()
        seen = {}
        real = ttrain._make_profiler

        def spy(*args, **kw):
            prof = real(*args, **kw)
            seen["model"] = prof.model
            return prof

        monkeypatch.setattr(ttrain, "_make_profiler", spy)
        ttrain.train(cfg, 2, 32, 3, device="cpu", log_every=0, profile=True)
        model = seen["model"]
        want = tmoe.moe_tiny(max_seq=32)
        assert model.flops_per_token == want.flops_per_token()
        assert model.param_count == want.param_count() > want.active_param_count()
        recs = [r for r in tprofile.load_profile(str(next(tmp_path.glob("tpx_*"))))
                if r["kind"] == "step"]
        assert len(recs) == 2


# -- serving ------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    cfg_j, cfg_t = _cfgs()
    p_j, p_t = _params(cfg_j, cfg_t, seed=79, requires_grad=False)
    return cfg_j, cfg_t, p_j, p_t


MIXED = [[1, 2, 3], [7, 8], [4, 5, 6, 7, 8, 9, 10], [11], [3, 1], list(range(20, 40))]


class TestServing:
    def test_engine_greedy_matches_jax_engine(self, tiny):
        cfg_j, cfg_t, p_j, p_t = tiny
        eng = ServeEngine(p_t, cfg_t, max_slots=4, block_size=8, max_prefill_batch=2).start()
        jeng = jengine.ServeEngine(p_j, cfg_j, max_slots=4, block_size=8,
                                   max_prefill_batch=2).start()
        try:
            reqs = [eng.submit(ServeRequest(prompt=p, max_new_tokens=5)) for p in MIXED]
            jreqs = [jeng.submit(jengine.ServeRequest(prompt=p, max_new_tokens=5))
                     for p in MIXED]
            for r, jr in zip(reqs, jreqs):
                assert r.wait(timeout=120) and r.error is None
                assert jr.wait(timeout=120) and jr.error is None
                assert r.tokens == jr.tokens
        finally:
            eng.stop()
            jeng.stop()

    def test_dense_generate_matches_jax(self, tiny):
        from torchx_tpu.models import generate as jgen

        cfg_j, cfg_t, p_j, p_t = tiny
        prompt = [[5, 6, 7, 8, 9]]
        out_j = jgen.generate(p_j, jnp.asarray(prompt, jnp.int32), cfg_j, 6)
        out_t = tgen.generate(p_t, torch.tensor(prompt), cfg_t, 6)
        assert out_t[0].tolist() == np.asarray(out_j)[0].tolist()

    def test_server_over_http(self):
        srv = gs.serve("moe_tiny", port=0, device="cpu", max_batch=2)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        try:
            health = json.loads(urllib.request.urlopen(f"{url}/healthz").read())
            assert health["status"] == "ok" and health["model"] == "moe_tiny"
            prompts = [[1, 2, 3], [9, 8, 7, 6, 5]]
            req = urllib.request.Request(
                f"{url}/v1/generate",
                data=json.dumps({"tokens": prompts, "max_new_tokens": 6}).encode())
            got = json.loads(urllib.request.urlopen(req, timeout=120).read())["tokens"]
            svc = srv.service
            assert isinstance(svc.cfg, tmoe.MoEConfig)
            for prompt, out in zip(prompts, got):
                want = tgen.generate(svc.params, torch.tensor([prompt]), svc.cfg, 6)
                assert out == want[0].tolist()
        finally:
            srv.shutdown()
            srv.service.close()
            srv.server_close()


# -- checkpoints ----------------------------------------------------------------


def _train(steps, **kw):
    seen = {}
    out = ttrain.train(tmoe.moe_tiny(), 2, 32, steps, device="cpu", log_every=0, warmup=2,
                       on_state=lambda e, s: seen.update({e: s}), **kw)
    return out, {k: v.clone() for k, v in seen["final"].items()}


def test_checkpoint_resumes_bitwise_and_verifies(tmp_path):
    whole, s_whole = _train(6)
    d = str(tmp_path / "ck")
    a, _ = _train(3, ckpt_dir=d)
    b, s_b = _train(3, ckpt_dir=d)
    assert (b["final_step"], b["resumed_from_step"]) == (6, 3)
    assert a["losses"] + b["losses"] == whole["losses"]
    assert a["router_aux"] + b["router_aux"] == whole["router_aux"]
    assert {"params.layers.w_router", "opt.mu.layers.w_gate"} <= set(s_b)
    assert s_b["params.layers.w_gate"].shape == (2, 4, 64, 128)
    assert set(s_b) == set(s_whole)
    for name in s_whole:
        assert torch.equal(s_b[name], s_whole[name]), name
    assert teval.main(["--ckpt", d, "--out", str(tmp_path / "s.json")]) == 0
    assert json.loads((tmp_path / "s.json").read_text())["step"] == 6
    # the server loads the MoE parameters the trainer saved
    svc = gs.GenerateService("moe_tiny", device="cpu", ckpt_dir=d)
    try:
        assert svc.ckpt_step == 6
        assert torch.equal(svc.params["layers"]["w_down"], s_b["params.layers.w_down"])
    finally:
        svc.close()


def test_train_state_from_jax_takes_the_moe_leaves():
    cfg_j, cfg_t = _cfgs()
    p_j = jmoe.init_params(cfg_j, jax.random.PRNGKey(80))
    opt = jtrain.make_optimizer(lr=3e-4, warmup=2)
    state = jtrain.TrainState(params=p_j, opt_state=opt.init(p_j),
                              step=jnp.zeros((), jnp.int32))
    st = convert.train_state_from_jax(jax.tree.map(np.asarray, state), cfg_t)
    assert st["params"]["layers"]["w_up"].shape == (2, 4, 64, 128)
    assert st["mu"]["layers"]["w_router"].shape == (2, 64, 4)
    with pytest.raises(ValueError, match="do not match"):
        convert.params_from_jax(jax.tree.map(np.asarray, p_j), tllama.llama_tiny())
