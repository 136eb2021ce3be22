"""The remat policies of the port (``full``, ``dots``, ``dots_attn``) and
``--remat-policy auto``, on the CPU, held to the JAX package's.

* Each policy's loss and every gradient are bitwise the port's ``"full"``
  (f32; ``llama_tiny``, ``moe_tiny``, int8 scope ``all``; the plain ops and
  the kernels' wrappers), and within the one-device parity tolerances of
  ``jax.grad`` under the same JAX policy (``remat=True``: ``llama_tiny``
  sets ``remat=False``, under which no JAX policy applies).
* What each policy keeps alive after the forward, counted as storages by
  the fit probe's :class:`LiveBytes`, against JAX's ``saved_residuals`` of
  the same forward, tensor for tensor by size and dtype (the port's
  products keep their ``[b*s, n]`` shape: ``mm``'s output). Differences,
  each named where it is tested: the flash path saves the forward's ``o``
  (f32) and ``lse`` where JAX names ``attn_out`` in the model dtype.
* The MoE dispatch, combine and expert products stay batched (``bmm``)
  when a batch or expert dimension has size 1, so ``"dots"`` never saves
  them (JAX's ``dots_with_no_batch_dims_saveable`` does not).
* ``choose_remat_policy``: the JAX package's ``TestChooseRematPolicy``
  cases (``tests/test_prefetch.py``) against the port's.
* The trainer: ``--remat-policy``, ``"auto"`` resolved and reported, and
  a two-rank gloo gang at ``fsdp=2``, ``tp=2`` and (MoE) ``ep=2`` under
  ``"dots"``: losses bitwise the same mesh's ``"full"`` run and within
  1e-4 of the JAX step on that mesh; ``"auto"`` resolved once for the
  gang.
"""

import collections
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.ad_checkpoint import saved_residuals
from jax.sharding import NamedSharding

import torch_gang_cases as gang
from torchx_tpu.examples import train_llama as jtrain
from torchx_tpu.models import llama as jllama
from torchx_tpu.models import moe as jmoe
from torchx_tpu.parallel import mesh as jmesh_lib
from torchx_tpu_torch import convert
from torchx_tpu_torch.examples import train_llama as ttrain
from torchx_tpu_torch.models import llama as tllama
from torchx_tpu_torch.models import moe as tmoe
from torchx_tpu_torch.parallel import remat_auto
from torchx_tpu_torch.parallel.aot_fit import FitResult, LiveBytes
from torch_threads import xdist_torch_threads  # noqa: F401

POLICIES = ("full", "dots", "dots_attn")
#: config name -> (JAX config, port config): every one with remat on
CONFIGS = {
    "llama_tiny": (jllama.llama_tiny, tllama.llama_tiny, {}),
    "moe_tiny": (jmoe.moe_tiny, tmoe.moe_tiny, {}),
    "int8_all": (jllama.llama_tiny, tllama.llama_tiny,
                 dict(int8_matmuls=True, int8_scope="all")),
}
#: the flash- and norm-tileable shape of tests/test_torch_model.py
SHAPE = dict(dim=128, n_heads=2, n_kv_heads=1, ffn_dim=256)


def _cfgs(name, policy, kernels="reference", **kw):
    mk_j, mk_t, extra = CONFIGS[name]
    jk = {"reference": "reference", "cuda": "interpret"}[kernels]
    return (mk_j(remat=True, remat_policy=policy, kernels=jk, **extra, **kw),
            mk_t(remat=True, remat_policy=policy, kernels=kernels, **extra, **kw))


def _tokens(seed, shape=(2, 65), vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _params(cfg_j, cfg_t, seed=61):
    init = jmoe.init_params if getattr(cfg_j, "n_experts", 0) else jllama.init_params
    p_j = init(cfg_j, jax.random.PRNGKey(seed))
    return p_j, convert.params_from_jax(jax.tree.map(np.asarray, p_j), cfg_t)


def _port_grads(cfg_t, p_t, tok):
    params = tllama.unflatten({k: v.detach().clone().requires_grad_(True)
                               for k, v in tllama.named_leaves(p_t)})
    loss, _ = tllama.loss_and_aux(params, {"tokens": torch.from_numpy(tok).long()}, cfg_t)
    loss.backward()
    return loss.detach(), [p.grad for p in tllama.leaves(params)]


class TestPolicies:
    @pytest.mark.parametrize("kernels", ["reference", "cuda"])
    @pytest.mark.parametrize("name", sorted(CONFIGS))
    def test_every_policy_bitwise_full(self, name, kernels):
        """Saving a product changes when it is computed, not its value."""
        kw = dict(SHAPE, max_seq=128) if kernels == "cuda" else {}
        cfg_j, cfg_t = _cfgs(name, "full", kernels, **kw)
        _, p_t = _params(cfg_j, cfg_t)
        tok = _tokens(62, (2, 129) if kernels == "cuda" else (2, 65))
        loss_f, grads_f = _port_grads(cfg_t, p_t, tok)
        for policy in ("dots", "dots_attn"):
            loss, grads = _port_grads(dataclasses.replace(cfg_t, remat_policy=policy), p_t, tok)
            assert torch.equal(loss, loss_f), policy
            for a, b in zip(grads, grads_f):
                assert torch.equal(a, b), policy

    @pytest.mark.parametrize("policy", POLICIES)
    @pytest.mark.parametrize("name", sorted(CONFIGS))
    def test_matches_jax_under_the_same_policy(self, name, policy):
        """The one-device parity tolerances: loss 1e-5, gradients 5e-4 /
        5e-5 (tests/test_torch_model.py, tests/test_torch_moe.py); int8:
        loss 5e-5 and gradients 3e-2 of each leaf's largest value, at the
        weights and batch of tests/test_torch_quant.py's parity test, which
        set that tolerance there and says why the two differ (an f32
        rounding moves a value across an int8 code boundary). At other
        weights the int8 losses part further (7.1e-5 relative with
        PRNGKey(61), 9.4e-5 with another batch), whatever the policy: JAX's
        own loss is the same under every policy and without remat."""
        cfg_j, cfg_t = _cfgs(name, policy)
        int8 = cfg_t.int8_matmuls
        p_j, p_t = _params(cfg_j, cfg_t, seed=0 if int8 else 61)
        tok = _tokens(9, (2, 33)) if int8 else _tokens(63)
        (l_j, _), g_j = jax.value_and_grad(jllama.loss_and_aux, has_aux=True)(
            p_j, {"tokens": jnp.asarray(tok)}, cfg_j)
        l_t, grads = _port_grads(cfg_t, p_t, tok)
        np.testing.assert_allclose(l_t.item(), float(l_j), rtol=5e-5 if int8 else 1e-5,
                                   atol=0 if int8 else 1e-5)
        for g, (path, _), got in zip(jax.tree.leaves(g_j), tllama.named_leaves(p_t), grads):
            ref = np.asarray(g)
            if int8:
                np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                           atol=3e-2 * float(np.abs(ref).max()), err_msg=path)
            else:
                np.testing.assert_allclose(got.numpy(), ref, rtol=5e-4, atol=5e-5, err_msg=path)

    def test_auto_is_resolved_before_the_forward(self):
        cfg = tllama.llama_tiny(remat=True, remat_policy="auto")
        p = tllama.init_params(cfg, torch.Generator().manual_seed(0))
        with pytest.raises(ValueError, match="must be resolved"):
            tllama.loss_fn(p, {"tokens": torch.from_numpy(_tokens(64)).long()}, cfg)
        # remat off consults no policy
        cfg = dataclasses.replace(cfg, remat=False)
        assert torch.isfinite(tllama.loss_fn(p, {"tokens": torch.from_numpy(_tokens(64)).long()},
                                             cfg))
        with pytest.raises(ValueError, match="remat_policy"):
            tllama.llama_tiny(remat_policy="everything")


# -- what each policy saves ---------------------------------------------------

#: batch and sequence of the comparison (no activation's leading
#: dimensions equal a weight's [L, dim] at these sizes)
B, S = 3, 40


def _jax_saved(cfg_j):
    """JAX's residuals of ``forward`` by (size, dtype): a layer-stacked
    ``[L, b, s, ...]`` one counts L times, each ``[b, s, ...]``."""
    init = jmoe.init_params if getattr(cfg_j, "n_experts", 0) else jllama.init_params
    cfg_j = dataclasses.replace(cfg_j, max_seq=S)
    params = init(cfg_j, jax.random.PRNGKey(0))
    tokens = jnp.zeros((B, S), jnp.int32)
    out = collections.Counter()
    for aval, _ in saved_residuals(lambda p: jllama.forward(p, tokens, cfg_j), params):
        shape = tuple(aval.shape)
        if shape[:3] == (cfg_j.n_layers, B, S):
            out[(int(np.prod(shape[1:])), str(aval.dtype))] += cfg_j.n_layers
        elif shape[:2] == (B, S):
            out[(int(np.prod(shape)), str(aval.dtype))] += 1
    return out


def _port_saved(cfg_t, b=B, s=S, activations_only=True):
    """The storages the port's ``forward`` holds after it runs, its output
    (the logits) left out, by (size, dtype), on meta tensors (the fit
    probe's counter); with ``activations_only``, as :func:`_jax_saved`
    counts them: those of ``[b, s, ...]`` or ``[b*s, ...]``."""
    cfg_t = dataclasses.replace(cfg_t, max_seq=s)
    params = tllama.init_params(cfg_t, None, "meta")
    tokens = torch.zeros((b, s), dtype=torch.int64, device="meta")
    tracker = LiveBytes()
    tracker.add_args((params, tokens))
    with tracker:
        logits = tllama.forward(params, tokens, cfg_t)
        live = tracker.live_tensors()
    out = collections.Counter()
    for shape, dtype, _ in live:
        if not activations_only or shape[:2] == (b, s) or shape[0] == b * s:
            out[(int(np.prod(shape)), str(dtype).removeprefix("torch."))] += 1
    out[(logits.numel(), "float32")] -= 1
    return +out


def _big(counter, floor):
    """The entries above ``floor`` elements: the norms' ``[b, s, 1]``
    statistics, which the two frameworks keep in different numbers, left
    out."""
    return collections.Counter({k: v for k, v in counter.items() if k[0] > floor})


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_saved_activations_match_jax(name):
    """Each policy's activations, tensor for tensor: ``full`` each layer's
    input (JAX's stacked scan carry) and the final hidden state; ``dots``
    adds the q/k/v, ``wo``, gate and up products (a MoE config: q/k/v,
    ``wo`` and the router's logits), in int32 for the int8 dot; ``dots_attn``
    adds ``attn_out``. Neither keeps the down projection, which only the
    residual add reads."""
    got, want = {}, {}
    for policy in POLICIES:
        cfg_j, cfg_t = _cfgs(name, policy)
        got[policy] = _big(_port_saved(cfg_t), B * S)
        want[policy] = _big(_jax_saved(cfg_j), B * S)
        assert got[policy] == want[policy], policy
    # the policies differ (llama_tiny alone sets remat=False, under which
    # every JAX policy saves the same residuals)
    assert want["full"] != want["dots"] != want["dots_attn"]


def test_flash_path_saves_o_and_lse():
    """On the kernels' path ``"dots_attn"`` saves the flash forward
    operator's two outputs, the backward's residuals: ``o`` in f32 and
    ``lse`` [b, h, s], where JAX saves ``attn_out`` in the model dtype
    (the same tensor in f32; in bf16, twice its bytes) and recomputes its
    kernel's residuals. ``"dots"`` saves no attention output."""
    cfg = tllama.llama_tiny(remat=True, kernels="cuda", **SHAPE)
    s, h, hd = 128, cfg.n_heads, cfg.head_dim
    saved = {p: _port_saved(dataclasses.replace(cfg, remat_policy=p), B, s, False)
             for p in POLICIES}
    L = cfg.n_layers
    assert saved["dots_attn"] - saved["dots"] == collections.Counter(
        {(B * s * h * hd, "float32"): L, (B * h * s, "float32"): L})
    assert not saved["dots"] - saved["full"] - collections.Counter(
        {(B * s * n, "float32"): 2 * L
         for n in (h * hd, cfg.n_kv_heads * hd, cfg.ffn_dim)})


@pytest.mark.parametrize("b,experts", [(1, 4), (2, 1), (1, 1)])
def test_moe_products_stay_batched(b, experts):
    """One row a rank, or one expert a rank (``ep`` x ``tp`` = E): the
    dispatch, expert and combine einsums still dispatch ``bmm``, which no
    policy saves; the router's product is the MoE layer's only ``mm``."""
    from torch.utils._python_dispatch import TorchDispatchMode

    seen = []

    class Ops(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen.append(func)
            return func(*args, **(kwargs or {}))

    cfg = tmoe.moe_tiny(n_experts=experts, top_k=1)
    layer = {k: v[0] for k, v in tllama.init_params(
        cfg, torch.Generator().manual_seed(0))["layers"].items()}
    x = torch.randn(b, 16, cfg.dim)
    with Ops():
        tmoe.moe_ffn(cfg, layer, x)
    assert seen.count(torch.ops.aten.mm.default) == 1
    assert seen.count(torch.ops.aten.bmm.default) >= 5


# -- choose_remat_policy ------------------------------------------------------


def _fit(policy, fits, peak):
    return FitResult(batch=8, seq=64, remat_policy=policy, args_bytes=peak // 2,
                     temp_bytes=peak // 2, peak_bytes=peak, fits=fits)


class TestChooseRematPolicy:
    """The JAX package's cases (tests/test_prefetch.py), against the port's
    selection, on one card (mesh None)."""

    cfg = tllama.llama_tiny()

    def _choose(self, fit_fn):
        return remat_auto.choose_remat_policy(self.cfg, None, 8, 64, fit_fn=fit_fn)

    def test_picks_cheapest_recompute_that_fits(self):
        policy, trials = self._choose(lambda c: _fit(c.remat_policy, True, 100))
        assert policy == remat_auto.POLICY_ORDER[0] == "dots_attn"
        assert [t.policy for t in trials] == ["dots_attn"]
        assert trials[0].fits and trials[0].peak_bytes == 100

    def test_falls_through_to_next_policy(self):
        policy, trials = self._choose(
            lambda c: _fit(c.remat_policy, c.remat_policy == "dots", 100))
        assert policy == "dots"
        assert [(t.policy, t.fits) for t in trials] == [("dots_attn", False), ("dots", True)]

    def test_nothing_fits_returns_full(self):
        policy, trials = self._choose(lambda c: _fit(c.remat_policy, False, 10**15))
        assert policy == "full"
        assert [t.policy for t in trials] == list(remat_auto.POLICY_ORDER)
        assert not any(t.fits for t in trials)

    def test_failed_trial_is_a_nonfit_verdict(self):
        def flaky(c):
            if c.remat_policy == "dots_attn":
                raise RuntimeError("CUDA out of memory")
            return _fit(c.remat_policy, True, 100)

        policy, trials = self._choose(flaky)
        assert policy == "dots"
        assert "out of memory" in trials[0].error
        assert not trials[0].fits and trials[0].peak_bytes == 0

    def test_candidates_carry_remat_enabled_and_policy(self):
        seen = []

        def spy(c):
            seen.append((c.remat, c.remat_policy))
            return _fit(c.remat_policy, c.remat_policy == "full", 100)

        self._choose(spy)
        assert seen == [(True, p) for p in remat_auto.POLICY_ORDER]

    def test_default_oracle_traces_against_the_budget(self):
        """Without ``fit_fn`` each candidate is traced (meta tensors, no
        card): a budget between two candidates' peaks picks the smaller."""
        cfg = tllama.llama_tiny(remat=True)
        peaks = {t.policy: t.peak_bytes for t in remat_auto.choose_remat_policy(
            cfg, None, 2, 64, hbm_bytes=10**12)[1]}
        assert list(peaks) == ["dots_attn"]
        _, trials = remat_auto.choose_remat_policy(cfg, None, 2, 64, hbm_bytes=1)
        peaks = {t.policy: t.peak_bytes for t in trials}
        assert peaks["dots_attn"] > peaks["dots"] > peaks["full"] > 0
        budget = (peaks["dots"] + peaks["full"]) / 2 / 0.9
        policy, trials = remat_auto.choose_remat_policy(cfg, None, 2, 64, hbm_bytes=budget)
        assert policy == "full" and [t.fits for t in trials] == [False, False, True]

    def test_budget_off_the_card_is_an_h100s(self):
        from torchx_tpu_torch.parallel.aot_fit import H100_HBM_BYTES

        if torch.cuda.is_available():
            pytest.skip("reads the card's memory where there is one")
        assert remat_auto.device_hbm_bytes() == H100_HBM_BYTES


# -- the trainer --------------------------------------------------------------


class TestTrainer:
    def test_flag_and_records(self, capsys):
        ttrain.main(["--config", "tiny", "--batch", "2", "--seq", "16", "--steps", "1",
                     "--device", "cpu", "--remat-policy", "dots"])
        final = json.loads(capsys.readouterr().out.split("final:", 1)[1])
        # llama_tiny trains without remat: the policy is not consulted
        assert final["remat_policy"] == "none" and final["remat_trials"] is None

    def test_auto_resolves_and_reports(self, capsys):
        cfg = tllama.llama_tiny(remat=True, remat_policy="auto")
        out = ttrain.train(cfg, 2, 64, 2, device="cpu", log_every=1)
        line = [x for x in capsys.readouterr().out.splitlines() if x.startswith("remat auto")]
        assert line == ["remat auto -> dots_attn (dots_attn=fits)"]
        assert out["remat_policy"] == "dots_attn"
        assert out["remat_trials"][0]["policy"] == "dots_attn"
        assert out["remat_trials"][0]["fits"] and out["remat_trials"][0]["peak_bytes"] > 0
        assert "remat_select" in out["launch_breakdown"]
        # the losses of the policy it resolved to
        fixed = ttrain.train(dataclasses.replace(cfg, remat_policy="dots_attn"), 2, 64, 2,
                             device="cpu")
        assert out["losses"] == fixed["losses"]
        # remat off: "auto" becomes "full" in the config, "none" in the records
        off = ttrain.train(dataclasses.replace(cfg, remat=False), 2, 64, 1, device="cpu")
        assert off["remat_policy"] == "none" and off["remat_trials"] is None


# -- a gang --------------------------------------------------------------------

#: make_train_step on JAX-initialized weights, as tests/test_torch_tp.py
STEP = dict(lr=3e-4, warmup=2)
JAX_TOL = 1e-4
#: (config, mesh): dense at fsdp=2 and tp=2, MoE at ep=2
GANG_MESHES = (("llama", "fsdp=2"), ("llama", "tp=2"), ("moe", "ep=2"))
#: the dense gang's shape: flash-tileable, two KV heads for tp=2
GANG_SHAPE = dict(SHAPE, n_kv_heads=2)


def _gang_cfgs(family, policy):
    if family == "moe":
        return (jmoe.moe_tiny(kernels="reference", remat=True, remat_policy=policy),
                dict(remat=True, remat_policy=policy))
    return (jllama.llama_tiny(kernels="interpret", remat=True, remat_policy=policy,
                              **GANG_SHAPE),
            dict(GANG_SHAPE, remat=True, remat_policy=policy))


def _jax_losses(cfg_j, mesh_spec, p_host, tokens):
    """The JAX trainer's ``make_train_step`` on ``mesh_spec`` over two of
    the CPU devices, as tests/test_torch_tp.py runs it."""
    from torchx_tpu_torch.parallel.mesh_config import parse_mesh_spec

    sizes = parse_mesh_spec(mesh_spec).resolve(2)
    mesh = jmesh_lib.make_mesh(jmesh_lib.MeshConfig(**sizes), devices=jax.devices()[:2])
    init_fn, _ = jllama.model_fns(cfg_j)
    shard = jmoe.shard_params if init_fn is jmoe.init_params else jllama.shard_params
    params = shard(jax.tree.map(jnp.asarray, p_host), cfg_j, mesh)
    opt = jtrain.make_optimizer(**STEP)
    state = jtrain.TrainState(params=params, opt_state=opt.init(params),
                              step=jnp.zeros((), jnp.int32))
    step = jtrain.make_train_step(cfg_j, mesh, opt)
    losses = []
    for t in tokens:
        batch = {"tokens": jax.device_put(jnp.asarray(t),
                                          NamedSharding(mesh, jmesh_lib.BATCH_SPEC))}
        state, loss, _ = step(state, batch)
        losses.append(float(loss))
    return losses


@pytest.fixture(scope="module")
def gang_results(tmp_path_factory):
    """One two-rank gang: for each mesh a ``"full"`` and a ``"dots"`` run of
    the same steps, and a ``"auto"`` trainer run."""
    tmp = tmp_path_factory.mktemp("remat_gang")
    rng = np.random.default_rng(65)
    cases, host = [], {}
    for family, mesh in GANG_MESHES:
        cfg_j, _ = _gang_cfgs(family, "full")
        init = jmoe.init_params if family == "moe" else jllama.init_params
        p_j = jax.tree.map(np.asarray, init(cfg_j, jax.random.PRNGKey(66)))
        path = str(tmp / f"init_{family}.npz")
        np.savez(path, **{"/".join(str(k.key) for k in kp): v
                          for kp, v in jax.tree_util.tree_flatten_with_path(p_j)[0]})
        seq = 128 if family == "llama" else 32
        tokens = rng.integers(0, 512, (3, 2, seq + 1)).astype(np.int32)
        batches = str(tmp / f"batches_{family}_{mesh}.npz")
        np.savez(batches, tokens=tokens)
        host[(family, mesh)] = (p_j, tokens)
        for policy in ("full", "dots"):
            _, model = _gang_cfgs(family, policy)
            case = dict(kind="step", name=f"{family} {mesh} {policy}", mesh=mesh, init=path,
                        batches=batches, model=model, **STEP)
            if family == "moe":
                case.update(config="moe_tiny", kernels="reference")
            cases.append(case)
    cases.append(dict(kind="train", name="auto", mesh="fsdp=2", batch=2, seq=64, steps=2,
                      warmup=1, data=None, model=dict(remat=True, remat_policy="auto")))
    proc = gang.run_cases(tmp, 2, cases)
    (rc, out, err), = gang.finish([proc], timeout=420)
    assert rc == 0, err[-3000:]
    return gang.load_results(tmp, 2), host, out


@pytest.mark.parametrize("family,mesh", GANG_MESHES)
def test_gang_dots_bitwise_full_and_near_jax(gang_results, family, mesh):
    results, host, _ = gang_results
    p_j, tokens = host[(family, mesh)]
    for r in results:
        full, dots = r[f"{family} {mesh} full"], r[f"{family} {mesh} dots"]
        assert dots["losses"] == full["losses"]
        assert dots["grad_norms"] == full["grad_norms"]
        for k, v in full["params"].items():
            assert torch.equal(dots["params"][k], v), k
    cfg_j, _ = _gang_cfgs(family, "dots")
    want = _jax_losses(cfg_j, mesh, p_j, tokens)
    np.testing.assert_allclose(results[0][f"{family} {mesh} dots"]["losses"], want,
                               rtol=JAX_TOL, atol=JAX_TOL)


def test_gang_resolves_auto_once(gang_results):
    """Rank 0 traces the candidates in a subprocess against the smaller
    card's budget (both ranks read the H100 default here) and broadcasts:
    both ranks train the same policy and print one line."""
    results, _, out = gang_results
    assert [r["auto"]["remat_policy"] for r in results] == ["dots_attn", "dots_attn"]
    assert results[0]["auto"]["remat_trials"] == results[1]["auto"]["remat_trials"]
    assert out.count("remat auto -> dots_attn") == 1
