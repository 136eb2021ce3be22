"""The port's trainer across a checkpoint, on the CPU: resume is bitwise the
uninterrupted run (f32, synthetic data and a token file), saves land on the
JAX trainer's steps, a JAX training state continues in the port, the
SIGTERM drill of a trainer subprocess, the launcher's heartbeats and
leases, and ``generate_server --ckpt-dir`` and ``eval_main`` on a trainer's
directory, which they leave as it was."""

import json
import os
import signal
import subprocess
import sys
import threading
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchx_tpu.apps import eval_main as jeval
from torchx_tpu.examples import train_llama as jtrain
from torchx_tpu.models import llama as jllama
from torchx_tpu.parallel.mesh import MeshConfig
from torchx_tpu.supervisor import api as jsup
from torchx_tpu.supervisor import gang as jgang
from torchx_tpu_torch import convert, settings
from torchx_tpu_torch.apps import eval_main as teval
from torchx_tpu_torch.apps import generate_server as gs
from torchx_tpu_torch.examples import train_llama as ttrain
from torchx_tpu_torch.models import generate as tgen
from torchx_tpu_torch.models import llama as tllama
from torchx_tpu_torch.util import session as tsession
from torch_threads import xdist_torch_threads  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
TINY = dict(batch=2, seq=16)


def _tiny():
    return tllama.llama_tiny()


def _train(steps, **kw):
    """The port's trainer on the tiny config, CPU, quiet; -> (results,
    final flat state)."""
    seen = {}
    out = ttrain.train(_tiny(), TINY["batch"], TINY["seq"], steps, device="cpu",
                       log_every=0, warmup=2, on_state=lambda e, s: seen.update({e: s}),
                       **kw)
    return out, {k: v.clone() for k, v in seen["final"].items()}


def _token_file(tmp_path, n=4000):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(7).integers(0, 512, n).astype(np.uint32).tofile(path)
    return str(path)


def _listing(directory):
    out = {}
    for root, _, files in os.walk(directory):
        for name in files:
            p = os.path.join(root, name)
            st = os.stat(p)
            out[os.path.relpath(p, directory)] = (st.st_size, st.st_mtime_ns)
    return out


class TestResume:
    @pytest.mark.parametrize("data", ["synthetic", "file"])
    def test_three_plus_three_is_six_bitwise(self, tmp_path, data):
        kw = {"data_path": _token_file(tmp_path)} if data == "file" else {}
        whole, s_whole = _train(6, **kw)
        d = str(tmp_path / "ck")
        a, _ = _train(3, ckpt_dir=d, **kw)
        b, s_b = _train(3, ckpt_dir=d, **kw)
        assert (a["final_step"], a["resumed_from_step"]) == (3, 0)
        assert (b["final_step"], b["resumed_from_step"]) == (6, 3)
        assert a["losses"] + b["losses"] == whole["losses"]
        assert a["grad_norms"] + b["grad_norms"] == whole["grad_norms"]
        # parameters, both moments, the update count and the step, bitwise
        assert set(s_b) == set(s_whole) and len(s_b) == 3 * len(tllama.leaves(
            tllama.init_params(_tiny(), torch.Generator()))) + 2
        for name in s_whole:
            assert torch.equal(s_b[name], s_whole[name]), name
        assert int(s_b["opt.count"]) == int(s_b["step"]) == 6

    def test_restored_state_is_the_saved_state(self, tmp_path):
        d = str(tmp_path / "ck")
        _, saved = _train(3, ckpt_dir=d)
        seen = {}

        def grab(event, state):
            if event == "restored":
                seen.update({k: v.clone() for k, v in state.items()})

        ttrain.train(_tiny(), 2, 16, 2, device="cpu", log_every=0, warmup=2,
                     ckpt_dir=d, on_state=grab)
        assert set(seen) == set(saved)
        for name in saved:
            assert torch.equal(seen[name], saved[name]), name

    def test_fallback_past_a_corrupt_step_rebuilds_the_stream(self, tmp_path):
        data = _token_file(tmp_path)
        whole, s_whole = _train(6, data_path=data)
        d = tmp_path / "ck"
        _train(3, ckpt_dir=str(d), data_path=data)
        _train(3, ckpt_dir=str(d), data_path=data)  # saves step 6
        with open(d / "6" / "state.pt", "r+b") as f:
            f.seek(100)
            f.write(b"\x00\x01\x02")
        c, s_c = _train(3, ckpt_dir=str(d), data_path=data)
        assert c["resumed_from_step"] == 3 and c["final_step"] == 6
        assert [s for s, _ in c["checkpoint"]["skipped"]] == [6]
        assert (d / "6.corrupt").is_dir()
        # the data stream resumed at step 3 too: steps 4-6 as uninterrupted
        assert c["losses"] == whole["losses"][3:]
        for name in s_whole:
            assert torch.equal(s_c[name], s_whole[name]), name

    def test_everything_quarantined_starts_fresh(self, tmp_path):
        d = tmp_path / "ck"
        _train(3, ckpt_dir=str(d))
        os.rename(d / "3", d / "3.corrupt")
        out, _ = _train(2, ckpt_dir=str(d))
        assert out["resumed_from_step"] == 0 and out["final_step"] == 2


#: (steps, ckpt_every): a one-step run (the port saves its step, the JAX
#: trainer nothing), a final forced save off the interval, and interval
#: saves with retention (3 kept)
SAVE_CASES = [(1, 1), (5, 3), (12, 2)]


@pytest.mark.parametrize("steps,every", SAVE_CASES)
def test_saves_land_on_the_jax_trainers_steps(tmp_path, steps, every):
    jd, td = tmp_path / "jax", tmp_path / "port"
    # batch 8: the tests' JAX runs on 8 CPU devices (fsdp=-1 shards the batch)
    jtrain.train(jllama.llama_tiny(), MeshConfig(dp=1, fsdp=-1, tp=1, sp=1),
                 batch=8, seq=16, steps=steps, ckpt_dir=str(jd), ckpt_every=every,
                 log_every=100)
    ttrain.train(_tiny(), 8, 16, steps, device="cpu", log_every=0,
                 ckpt_dir=str(td), ckpt_every=every)

    def saved(d):
        names = sorted(int(n) for n in os.listdir(d) if n.isdigit())
        try:
            doc = json.loads((d / "MANIFEST.json").read_text())
        except FileNotFoundError:
            doc = {}
        return names, doc.get("latest_step"), sorted(int(s) for s in doc.get("steps", {}))

    if steps == 1:
        # the one divergence: the JAX trainer returns before its final save,
        # so a one-step run leaves it nothing; the port saves its step
        assert saved(jd) == ([], None, [])
        assert saved(td) == ([1], 1, [1])
        assert jsup.latest_checkpoint_step(str(td)) == 1
        return
    assert saved(td) == saved(jd)
    assert jsup.latest_checkpoint_step(str(td)) == jsup.latest_checkpoint_step(str(jd))


def test_a_jax_state_continues_in_the_port():
    """train_state_from_jax of the JAX state after 2 steps, 2 more steps in
    the port, against 4 JAX steps: losses and parameters within 1e-4 (the
    trajectory tolerance of test_torch_model.py, at the trainer's lr)."""
    shape = dict(dim=128, n_heads=2, n_kv_heads=1, ffn_dim=256)
    cfg_j, cfg_t = jllama.llama_tiny(**shape), tllama.llama_tiny(**shape)
    p_j = jllama.init_params(cfg_j, jax.random.PRNGKey(70))
    opt_j = jtrain.make_optimizer(lr=3e-4, warmup=2)
    state = jtrain.TrainState(params=p_j, opt_state=opt_j.init(p_j),
                              step=jnp.zeros((), jnp.int32))
    step_j = jtrain.make_train_step(cfg_j, None, opt_j)
    rng = np.random.default_rng(71)
    toks = [rng.integers(0, 512, (2, 129)).astype(np.int32) for _ in range(4)]
    for tok in toks[:2]:
        state, _, _ = step_j(state, {"tokens": jnp.asarray(tok)})

    ts = convert.train_state_from_jax(jax.tree.map(np.asarray, state), cfg_t)
    assert (ts["count"], ts["step"]) == (2, 2)
    adam = state.opt_state[1][0]
    for (name, mu), (_, nu), (_, want_mu), (_, want_nu) in zip(
        tllama.named_leaves(ts["mu"]), tllama.named_leaves(ts["nu"]),
        _jax_named(adam.mu), _jax_named(adam.nu),
    ):
        np.testing.assert_array_equal(mu.numpy(), np.asarray(want_mu), err_msg=name)
        np.testing.assert_array_equal(nu.numpy(), np.asarray(want_nu), err_msg=name)

    p_t = ts["params"]
    opt_t = ttrain.make_optimizer(tllama.leaves(p_t), lr=3e-4, warmup=2)
    opt_t.mu, opt_t.nu = tllama.leaves(ts["mu"]), tllama.leaves(ts["nu"])
    opt_t.count = ts["count"]
    step_t = ttrain.make_train_step(cfg_t, opt_t)
    for tok in toks[2:]:
        state, loss_j, _ = step_j(state, {"tokens": jnp.asarray(tok)})
        out = step_t(p_t, {"tokens": torch.from_numpy(tok)})
        np.testing.assert_allclose(float(out["loss"]), float(loss_j), rtol=1e-4, atol=1e-4)
    for (name, b), a in zip(tllama.named_leaves(p_t), jax.tree.leaves(state.params)):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a), rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    assert opt_t.count == int(state.opt_state[1][0].count) == 4


def _jax_named(tree):
    return [(jax.tree_util.keystr(p), x) for p, x in jax.tree_util.tree_leaves_with_path(tree)]


def test_sigterm_drill(tmp_path):
    """SIGTERM after the second step line: the subprocess saves the step it
    is on, waits until it is durable, exits 0 and reports preempted; the
    manifest names that step, eval_main verifies it, and a rerun resumes
    from it."""
    d = str(tmp_path / "ck")
    cmd = [sys.executable, "-m", "torchx_tpu_torch.examples.train_llama",
           "--config", "tiny", "--device", "cpu", "--batch", "2", "--seq", "16",
           "--steps", "1000000", "--ckpt-dir", d, "--log-every", "1"]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, env=env, cwd=REPO)
    try:
        lines, step_lines = [], 0
        while step_lines < 2:
            line = proc.stdout.readline()
            assert line, "".join(lines)
            lines.append(line)
            step_lines += line.startswith("step ")
        proc.send_signal(signal.SIGTERM)
        rest, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    out = "".join(lines) + rest
    assert proc.returncode == 0, out
    final = json.loads(out.split("final:", 1)[1])
    saved = final["final_step"]
    assert final["preempted"] is True and saved >= 2
    assert f"preemption notice: checkpointed step {saved}, exiting" in out
    assert jsup.latest_checkpoint_step(d) == saved
    assert jeval.verify_checkpoint(d)[0] == saved
    assert teval.main(["--ckpt", d, "--out", str(tmp_path / "score.json")]) == 0
    again, _ = _train(2, ckpt_dir=d)
    assert again["resumed_from_step"] == saved and again["final_step"] == saved + 2


def test_launcher_heartbeats_and_lease(tmp_path, monkeypatch):
    """Under the launcher's tracing the trainer's spans reach the session's
    trace.jsonl and its lease the session's leases: the JAX gang monitor
    reads both and judges the replica healthy."""
    from torchx_tpu.obs import trace as jtrace

    monkeypatch.setenv(settings.ENV_TPX_OBS_DIR, str(tmp_path))
    monkeypatch.setenv(settings.ENV_TPX_INTERNAL_SESSION_ID, "feedc0de00")
    monkeypatch.setenv(settings.ENV_TPX_TRACE_ID, "ab" * 16)
    monkeypatch.setenv(settings.ENV_TPX_REPLICA_ID, "0")
    monkeypatch.setattr(tsession, "_session_id", None)
    out, _ = _train(3, ckpt_dir=str(tmp_path / "ck"))
    session = "tpx_feedc0de"
    lines = (tmp_path / session / "trace.jsonl").read_text().splitlines()
    spans = [jtrace.Span.deserialize(x) for x in lines]
    names = [s.name for s in spans]
    assert {"launch.backend_init", "launch.init_state", "launch.data_setup",
            "launch.first_step", "job.first_step"} <= set(names)
    assert all(s.trace_id == "ab" * 16 for s in spans)
    first = spans[names.index("job.first_step")]
    assert first.attrs["replica"] == 0 and first.attrs["launch_to_first_step_s"] > 0
    windows = [s.attrs["step"] for s in spans if s.name == "step.window"]
    assert windows == [] and out["launch_to_first_step_s"] > 0  # log_every=0
    leases = jgang.read_leases(session)
    assert set(leases) == {0}
    monitor = jgang.GangMonitor(1, hang_deadline_s=600, session=session)
    assert monitor.check().state == jgang.GangState.HEALTHY

    ttrain.train(_tiny(), 2, 16, 3, device="cpu", log_every=1)
    lines = (tmp_path / session / "trace.jsonl").read_text().splitlines()
    windows = [json.loads(x)["attrs"]["step"] for x in lines
               if json.loads(x)["name"] == "step.window"]
    assert windows == [1, 2, 3]
    assert jgang.read_leases(session)[0]["step"] == 3


class TestServeAndEvalOnATrainerDir:
    def _serve(self, d):
        srv = gs.serve("tiny", port=0, device="cpu", ckpt_dir=d, max_batch=2)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        return srv, f"http://127.0.0.1:{srv.server_address[1]}"

    @staticmethod
    def _stop(srv):
        srv.shutdown()
        srv.service.close()
        srv.server_close()

    def test_served_tokens_are_the_trained_parameters_own(self, tmp_path):
        d = str(tmp_path / "ck")
        _, trained = _train(3, ckpt_dir=d)
        before, manifest = _listing(d), Path(d, "MANIFEST.json").read_bytes()
        srv, url = self._serve(d)
        try:
            health = json.loads(urllib.request.urlopen(f"{url}/healthz").read())
            assert health["ckpt_step"] == 3
            prompts = [[1, 2, 3], [9, 8, 7, 6, 5]]
            req = urllib.request.Request(
                f"{url}/v1/generate",
                data=json.dumps({"tokens": prompts, "max_new_tokens": 8}).encode())
            got = json.loads(urllib.request.urlopen(req).read())["tokens"]
            assert all(not p.requires_grad for p in tllama.leaves(srv.service.params))
        finally:
            self._stop(srv)
        params = tllama.unflatten(
            {k.removeprefix("params."): v for k, v in trained.items() if k.startswith("params.")})
        for prompt, out in zip(prompts, got):
            want = tgen.generate(params, torch.tensor([prompt]), _tiny(), 8)[0].tolist()
            assert out == want
        assert _listing(d) == before
        assert Path(d, "MANIFEST.json").read_bytes() == manifest
        assert teval.main(["--ckpt", d, "--out", str(tmp_path / "s.json")]) == 0
        assert json.loads((tmp_path / "s.json").read_text())["step"] == 3

    def test_a_bad_newest_step_is_skipped_and_left_alone(self, tmp_path):
        """The reference's server quarantines the trainer's steps it cannot
        load; the port's reader serves the previous step and renames
        nothing."""
        d = tmp_path / "ck"
        _train(3, ckpt_dir=str(d))
        _train(3, ckpt_dir=str(d))
        with open(d / "6" / "state.pt", "r+b") as f:
            f.seek(200)
            f.write(b"\xff\xfe")
        before = _listing(d)
        svc = gs.GenerateService("tiny", ckpt_dir=str(d), device="cpu", max_batch=2)
        try:
            assert svc.ckpt_step == 3
        finally:
            svc.close()
        assert _listing(d) == before and not any(".corrupt" in n for n in os.listdir(d))
        assert teval.main(["--ckpt", str(d), "--out", str(tmp_path / "s.json")]) == 1

    def test_no_checkpoint_and_another_model_raise(self, tmp_path):
        with pytest.raises(FileNotFoundError, match="no checkpoint"):
            gs.GenerateService("tiny", ckpt_dir=str(tmp_path / "absent"), device="cpu")
        assert not (tmp_path / "absent").exists()
        d = str(tmp_path / "wide")
        ttrain.train(tllama.llama_tiny(dim=128), 2, 16, 2, device="cpu", log_every=0,
                     ckpt_dir=d)
        with pytest.raises(ValueError, match="not the config's"):
            gs.GenerateService("tiny", ckpt_dir=d, device="cpu")
