"""Parity of the PyTorch port's Llama and trainer with the JAX package's,
on the CPU: loss and every gradient, the converter's layouts, and a 4-step
training trajectory. Weights come from the JAX ``init_params`` through
``torchx_tpu_torch.convert``; tokens are made with numpy from a seed.

The config is the flash- and norm-tileable one of tests/test_fused.py
(dim 128, head_dim 64), so ``kernels="cuda"`` routes every layer through
the kernel wrappers (their plain versions on CPU tensors) while the JAX
side runs its Pallas kernels in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchx_tpu.examples import train_llama as jtrain
from torchx_tpu.models import llama as jllama
from torchx_tpu_torch import convert
from torchx_tpu_torch.examples import train_llama as ttrain
from torchx_tpu_torch.models import llama as tllama
from torch_threads import xdist_torch_threads  # noqa: F401

JAX_KERNELS = {"reference": "reference", "cuda": "interpret"}


def _cfgs(kernels, **kw):
    shape = dict(dim=128, n_heads=2, n_kv_heads=1, ffn_dim=256, **kw)
    return (
        jllama.llama_tiny(kernels=JAX_KERNELS[kernels], **shape),
        tllama.llama_tiny(kernels=kernels, **shape),
    )


def _params(cfg_j, cfg_t, seed=51):
    p_j = jllama.init_params(cfg_j, jax.random.PRNGKey(seed))
    return p_j, convert.params_from_jax(jax.tree.map(np.asarray, p_j), cfg_t)


def _named_leaves(params, prefix=""):
    """(path, tensor) pairs in the JAX pytree's leaf order (sorted keys)."""
    out = []
    for key in sorted(params):
        val = params[key]
        if isinstance(val, dict):
            out.extend(_named_leaves(val, f"{prefix}{key}/"))
        else:
            out.append((f"{prefix}{key}", val))
    return out


def _tokens(seed, shape=(2, 129), vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


class TestLossAndGrads:
    @pytest.mark.parametrize(
        "kernels,loss_chunk",
        [("reference", 512), ("cuda", 512), ("reference", 32), ("cuda", 32)],
    )
    def test_matches_jax(self, kernels, loss_chunk):
        cfg_j, cfg_t = _cfgs(kernels, loss_chunk=loss_chunk)
        p_j, p_t = _params(cfg_j, cfg_t)
        tok = _tokens(50)
        l_j, g_j = jax.value_and_grad(jllama.loss_fn)(
            p_j, {"tokens": jnp.asarray(tok)}, cfg_j
        )
        l_t = tllama.loss_fn(p_t, {"tokens": torch.from_numpy(tok)}, cfg_t)
        l_t.backward()
        np.testing.assert_allclose(l_t.item(), float(l_j), rtol=1e-5, atol=1e-5)
        grads_j = jax.tree.leaves(g_j)
        named = _named_leaves(p_t)
        assert len(grads_j) == len(named)
        for g, (name, p) in zip(grads_j, named):
            assert p.grad is not None, name
            np.testing.assert_allclose(
                p.grad.numpy(), np.asarray(g), rtol=5e-4, atol=5e-5, err_msg=name
            )

    def test_loss_mask(self):
        cfg_j, cfg_t = _cfgs("reference", loss_chunk=32)
        p_j, p_t = _params(cfg_j, cfg_t)
        tok = _tokens(52)
        mask = (np.random.default_rng(53).random(tok.shape) > 0.3).astype(np.int32)
        l_j = jllama.loss_fn(
            p_j, {"tokens": jnp.asarray(tok), "loss_mask": jnp.asarray(mask)}, cfg_j
        )
        l_t = tllama.loss_fn(
            p_t, {"tokens": torch.from_numpy(tok), "loss_mask": torch.from_numpy(mask)},
            cfg_t,
        )
        np.testing.assert_allclose(l_t.item(), float(l_j), rtol=1e-5, atol=1e-5)

    def test_remat_matches_no_remat(self):
        _, cfg_t = _cfgs("cuda")
        cfg_r = tllama.llama_tiny(
            dim=128, n_heads=2, n_kv_heads=1, ffn_dim=256, kernels="cuda", remat=True
        )
        gen = torch.Generator().manual_seed(0)
        p = tllama.init_params(cfg_t, gen)
        batch = {"tokens": torch.from_numpy(_tokens(54))}
        grads = []
        for cfg in (cfg_t, cfg_r):
            loss = tllama.loss_fn(p, batch, cfg)
            grads.append(torch.autograd.grad(loss, tllama.leaves(p)))
        for a, b in zip(*grads):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


class TestConvert:
    @pytest.mark.parametrize("tie", [True, False])
    def test_layouts_and_logits(self, tie):
        cfg_j = jllama.llama_tiny(tie_embeddings=tie)
        cfg_t = tllama.llama_tiny(tie_embeddings=tie)
        p_j, p_t = _params(cfg_j, cfg_t, seed=7)
        assert ("lm_head" in p_t) is (not tie)
        assert p_t["layers"]["wq"].shape == (2, 64, 64)  # [L, in, out]
        assert p_t["layers"]["wk"].shape == (2, 64, 32)
        assert p_t["layers"]["w_down"].shape == (2, 128, 64)
        head = tllama.lm_head(p_t, cfg_t)
        assert head.shape == (64, 512)
        if tie:
            assert head.data_ptr() == p_t["embed"].data_ptr()
        tok = _tokens(8, (2, 16))
        logits_j = jllama.forward(p_j, jnp.asarray(tok), cfg_j)
        logits_t = tllama.forward(p_t, torch.from_numpy(tok), cfg_t)
        np.testing.assert_allclose(
            logits_t.detach().numpy(), np.asarray(logits_j), rtol=1e-5, atol=1e-5
        )

    def test_rejects_mismatched_tree(self):
        cfg_j, cfg_t = jllama.llama_tiny(), tllama.llama_tiny()
        tree = jax.tree.map(np.asarray, jllama.init_params(cfg_j, jax.random.PRNGKey(0)))
        with pytest.raises(ValueError, match="keys"):
            convert.params_from_jax(tree, tllama.llama_tiny(tie_embeddings=True))
        tree["layers"]["wq"] = tree["layers"]["wq"].transpose(0, 2, 1)[:, :, :32]
        with pytest.raises(ValueError, match="shapes"):
            convert.params_from_jax(tree, cfg_t)

    def test_bf16_leaves(self):
        cfg_j = jllama.llama_tiny(dtype=jnp.bfloat16)
        tree = jax.tree.map(np.asarray, jllama.init_params(cfg_j, jax.random.PRNGKey(0)))
        p_t = convert.params_from_jax(tree, tllama.llama_tiny(dtype=torch.bfloat16))
        assert p_t["embed"].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            p_t["embed"].detach().float().numpy(), tree["embed"].astype(np.float32)
        )

    def test_init_shapes_match_jax(self):
        cfg_j, cfg_t = jllama.llama_tiny(), tllama.llama_tiny()
        p_j = jllama.init_params(cfg_j, jax.random.PRNGKey(0))
        p_t = tllama.init_params(cfg_t, torch.Generator().manual_seed(0))
        shapes_j = [tuple(x.shape) for x in jax.tree.leaves(p_j)]
        shapes_t = [tuple(x.shape) for x in tllama.leaves(p_t)]
        assert shapes_t == shapes_j
        assert cfg_t.param_count() == cfg_j.param_count()
        assert cfg_t.flops_per_token() == cfg_j.flops_per_token()
        # the same init scale: N(0, 1) * in_dim**-0.5
        np.testing.assert_allclose(
            p_t["layers"]["w_down"].detach().std().item(), 128**-0.5, rtol=0.05
        )


class TestTrainer:
    def test_trajectory_matches_jax(self):
        """4 steps of make_train_step + make_optimizer (warmup 2, the
        trainer's default lr 3e-4) in f32: losses and final parameters
        within 1e-4 of the JAX trainer's.

        Adam divides each gradient by its own running rms, so where a
        gradient is near zero (|g| ~ 1e-7, sqrt(v) ~ eps) the f32
        summation-order noise of the two frameworks (~1e-9) becomes a few
        percent of that element's update. Parameter differences therefore
        scale with lr: at lr 1e-3 one embedding element of 65536 differed by
        1.4e-4 after 4 steps, so the 1e-4 tolerance is a statement about the
        trainer's lr, not about larger ones."""
        cfg_j, cfg_t = _cfgs("cuda")
        p_j, p_t = _params(cfg_j, cfg_t, seed=60)
        opt_j = jtrain.make_optimizer(lr=3e-4, warmup=2)
        state = jtrain.TrainState(
            params=p_j, opt_state=opt_j.init(p_j), step=jnp.zeros((), jnp.int32)
        )
        step_j = jtrain.make_train_step(cfg_j, None, opt_j)
        opt_t = ttrain.make_optimizer(tllama.leaves(p_t), lr=3e-4, warmup=2)
        step_t = ttrain.make_train_step(cfg_t, opt_t)
        assert opt_t.schedule(0) == 0.0  # optax's warmup starts at 0
        p0 = [p.detach().clone() for p in tllama.leaves(p_t)]
        rng = np.random.default_rng(61)
        for i in range(4):
            tok = rng.integers(0, 512, (2, 129)).astype(np.int32)
            state, loss_j, _ = step_j(state, {"tokens": jnp.asarray(tok)})
            out = step_t(p_t, {"tokens": torch.from_numpy(tok)})
            np.testing.assert_allclose(
                float(out["loss"]), float(loss_j), rtol=1e-4, atol=1e-4
            )
            if i == 0:  # lr 0 at step 0: the first update moves nothing
                for a, b in zip(p0, tllama.leaves(p_t)):
                    torch.testing.assert_close(a, b.detach(), rtol=0, atol=0)
        for a, (name, b) in zip(
            jax.tree.leaves(state.params), _named_leaves(p_t)
        ):
            np.testing.assert_allclose(
                b.detach().numpy(), np.asarray(a), rtol=1e-4, atol=1e-4, err_msg=name
            )

    def test_schedule_matches_optax(self):
        import optax

        sched = optax.warmup_cosine_decay_schedule(
            0.0, 3e-4, 100, decay_steps=100_000, end_value=3e-5
        )
        opt = ttrain.make_optimizer([torch.zeros(1)], lr=3e-4, warmup=100)
        for count in (0, 1, 50, 99, 100, 101, 5000, 99_999, 100_000, 200_000):
            # optax evaluates the schedule in f32, the port in double
            np.testing.assert_allclose(opt.schedule(count), float(sched(count)), rtol=1e-5)

    def test_bf16_state_stays_bf16(self):
        cfg = tllama.llama_tiny(dtype=torch.bfloat16)
        p = tllama.init_params(cfg, torch.Generator().manual_seed(0))
        opt = ttrain.make_optimizer(tllama.leaves(p), lr=1e-3, warmup=1)
        step = ttrain.make_train_step(cfg, opt)
        out = step(p, {"tokens": torch.from_numpy(_tokens(3, (2, 17)))})
        assert torch.isfinite(out["loss"])
        assert all(t.dtype == torch.bfloat16 for t in tllama.leaves(p))
        assert all(t.dtype == torch.bfloat16 for t in opt.mu + opt.nu)

    def test_train_on_cpu(self):
        cfg = tllama.llama_tiny(dim=128, n_heads=2, n_kv_heads=1, ffn_dim=256)
        out = ttrain.train(
            cfg, batch=2, seq=128, steps=2, kernels="cuda", device="cpu", log_every=0
        )
        assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
        assert out["kernels"] == "cuda" and out["device"] == "cpu"
        assert out["mfu"] is None  # no device peak: no MFU on the CPU
        # CPU tensors take the plain versions: no kernel was launched
        assert out["launches"] == {k: 0 for k in out["launches"]}

    def test_train_with_token_file(self, tmp_path):
        path = tmp_path / "tokens.bin"
        np.random.default_rng(0).integers(0, 512, 4096, dtype=np.uint32).tofile(path)
        out = ttrain.train(
            tllama.llama_tiny(), batch=2, seq=32, steps=2, data_path=str(path),
            prefetch=2, device="cpu", log_every=0,
        )
        assert all(np.isfinite(out["losses"])) and out["data_wait_s"] >= 0
