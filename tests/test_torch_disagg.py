"""The port's disaggregated serving roles over real HTTP on the CPU
(``--device cpu``, the ``tiny`` config, f32, the JAX package's weights
through ``convert.params_from_jax``): a prefill replica streaming K/V
payloads to a decode replica gives the unified server's tokens and the JAX
package's disaggregated pair's, a repeat hits the prefill replica's prefix
cache, the ``/v1/kv`` contract (400 for a body that is no payload, 503 at
a role that is not decode and while draining), the file-spool transport,
and payloads crossing between the two packages either way."""

import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from torchx_tpu.models import llama as jllama
from torchx_tpu.serve import engine as jengine
from torchx_tpu.serve import kv_transfer as jkvt
from torchx_tpu_torch import convert
from torchx_tpu_torch.apps import generate_server as gs
from torchx_tpu_torch.models import llama as tllama
from torchx_tpu_torch.serve import kv_transfer as tkvt
from torch_threads import xdist_torch_threads  # noqa: F401

#: Prompts of 1 to 3 blocks of 16 (the servers' default block size).
PROMPTS = [[1, 2, 3], list(range(4, 24)), list(range(100, 140)), [9]]
NEW = 6
BLOCK = 16


@pytest.fixture(scope="module")
def jax_tiny():
    cfg = jllama.CONFIGS["tiny"]()
    return cfg, jllama.init_params(cfg, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def jax_weights(jax_tiny):
    """Every port server of this module starts on the JAX package's seed-0
    weights (the port's seeded init draws other numbers)."""
    _, p_j = jax_tiny
    host = jax.tree.map(np.asarray, p_j)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tllama, "init_params", lambda cfg, gen, device: convert.params_from_jax(
            host, cfg, device=device, requires_grad=False))
        yield


def _start(**kw):
    srv = gs.serve("tiny", port=0, device="cpu", max_batch=4, **kw)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


def _stop(srv):
    srv.shutdown()
    srv.service.close()
    srv.server_close()


@pytest.fixture(scope="module")
def replicas(jax_weights):
    """A decode replica, a prefill replica sending to it over HTTP, and a
    unified replica."""
    dec, dec_url = _start(serve_role="decode")
    pre, pre_url = _start(serve_role="prefill", kv_transfer=f"http:{dec_url}")
    uni, uni_url = _start()
    yield {"decode": (dec, dec_url), "prefill": (pre, pre_url), "unified": (uni, uni_url)}
    for srv in (pre, dec, uni):
        _stop(srv)


def post(url, payload, raw=None):
    data = raw if raw is not None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def get_json(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _generate(url, prompts, **kw):
    code, body = post(f"{url}/v1/generate", {"tokens": prompts, "max_new_tokens": NEW, **kw})
    assert code == 200, body
    return body["tokens"]


def _jax_pair(jax_tiny, prompts, max_new=NEW):
    """The JAX package's disaggregated pair: a prefill engine's handoffs
    through its LocalTransfer into a decode engine (the model of
    tests/test_serve_disagg.py)."""
    cfg, params = jax_tiny
    pre = jengine.ServeEngine(params, cfg, max_slots=2, block_size=BLOCK).start()
    dec = jengine.ServeEngine(params, cfg, max_slots=2, block_size=BLOCK).start()
    try:
        transfer = jkvt.LocalTransfer(
            {"decode": lambda p: jengine.serve_kv_payload(dec, p, timeout=120)})
        outs = []
        for prompt in prompts:
            req = jengine.ServeRequest(prompt=list(prompt), max_new_tokens=max_new,
                                       prefill_only=True)
            pre.submit(req)
            assert req.wait(timeout=120) and req.error is None
            if req.handoff is None:
                outs.append(req.tokens)
                continue
            out = transfer.send(req.handoff)
            outs.append(list(prompt) + [int(t) for t in out["tokens"]])
        return outs
    finally:
        pre.stop()
        dec.stop()


def test_greedy_equals_unified_and_the_jax_pair(replicas, jax_tiny):
    disagg = _generate(replicas["prefill"][1], PROMPTS)
    unified = _generate(replicas["unified"][1], PROMPTS)
    assert disagg == unified
    assert disagg == _jax_pair(jax_tiny, PROMPTS)
    # every prompt but the one-token budget went through the decode replica
    dec = replicas["decode"][0].service
    assert dec.requests >= len(PROMPTS)


def test_sampled_stream_continues_across_the_handoff(replicas):
    kw = dict(temperature=0.8, seed=7)
    assert _generate(replicas["prefill"][1], PROMPTS[1:3], **kw) == _generate(
        replicas["unified"][1], PROMPTS[1:3], **kw)


def test_a_repeat_is_a_prefix_hit(replicas):
    srv, url = replicas["prefill"]
    prompt = [list(range(200, 240))]
    cold = _generate(url, prompt)
    hits = srv.service._engine.stats()["prefix_cache"]["hits"]
    assert _generate(url, prompt) == cold
    assert srv.service._engine.stats()["prefix_cache"]["hits"] > hits
    code, health = get_json(f"{url}/healthz")
    assert code == 200 and health["serve_role"] == "prefill"
    assert health["block_size"] == BLOCK and health["prefix_summary"]
    assert get_json(f"{replicas['decode'][1]}/healthz")[1]["serve_role"] == "decode"


def _payload(srv, prompt):
    """A prefill-only handoff exported by ``srv``'s engine."""
    from torchx_tpu_torch.serve.engine import ServeRequest

    req = srv.service._engine.submit(ServeRequest(prompt=list(prompt), max_new_tokens=NEW,
                                                  prefill_only=True))
    assert req.wait(timeout=120) and req.error is None and req.handoff is not None
    return req.handoff


def test_kv_contract(replicas):
    pre, pre_url = replicas["prefill"]
    dec, dec_url = replicas["decode"]
    uni_url = replicas["unified"][1]
    code, body = post(f"{dec_url}/v1/kv", None, raw=b"not an npz payload")
    assert code == 400 and "error" in body
    raw = _payload(pre, PROMPTS[1]).to_bytes()
    for url in (pre_url, uni_url):  # roles that are not decode
        code, body = post(f"{url}/v1/kv", None, raw=raw)
        assert code == 503 and "not decode" in body["error"]
    code, body = post(f"{dec_url}/v1/kv", None, raw=raw)
    assert code == 200 and PROMPTS[1] + body["tokens"] == _generate(uni_url, [PROMPTS[1]])[0]
    dec.service.draining = True  # a draining target rejects: the sender requeues
    try:
        code, body = post(f"{dec_url}/v1/kv", None, raw=raw)
        assert code == 503 and "draining" in body["error"]
    finally:
        dec.service.draining = False


def test_payloads_cross_both_ways(replicas, jax_tiny):
    """A port payload decodes in a JAX decode engine, and a JAX payload in
    the port's decode replica, each to the unified server's tokens."""
    cfg, params = jax_tiny
    prompt = PROMPTS[2]
    want = _generate(replicas["unified"][1], [prompt])[0]
    port_raw = _payload(replicas["prefill"][0], prompt).to_bytes()
    jdec = jengine.ServeEngine(params, cfg, max_slots=2, block_size=BLOCK).start()
    jpre = jengine.ServeEngine(params, cfg, max_slots=2, block_size=BLOCK).start()
    try:
        out = jengine.serve_kv_payload(jdec, jkvt.KvPayload.from_bytes(port_raw), timeout=120)
        assert prompt + [int(t) for t in out["tokens"]] == want
        req = jengine.ServeRequest(prompt=list(prompt), max_new_tokens=NEW, prefill_only=True)
        jpre.submit(req)
        assert req.wait(timeout=120) and req.error is None
        jax_raw = req.handoff.to_bytes()
    finally:
        jdec.stop()
        jpre.stop()
    theirs = tkvt.KvPayload.from_bytes(jax_raw)
    assert theirs.k.dtype == np.float32 and theirs.k.shape[0] == cfg.n_layers
    code, body = post(f"{replicas['decode'][1]}/v1/kv", None, raw=jax_raw)
    assert code == 200 and prompt + body["tokens"] == want


def test_file_spool_roles(jax_weights, tmp_path):
    spool = f"file:{tmp_path / 'spool'}"
    dec, _ = _start(serve_role="decode", kv_transfer=spool)
    pre, pre_url = _start(serve_role="prefill", kv_transfer=spool)
    uni, uni_url = _start()
    try:
        assert _generate(pre_url, PROMPTS[:2]) == _generate(uni_url, PROMPTS[:2])
        assert dec.service.requests == 2
    finally:
        for srv in (pre, dec, uni):
            _stop(srv)


def test_prefill_drain_waits_for_its_handoffs(replicas):
    """drain() on a prefill replica counts the handoffs still in flight."""
    svc = replicas["prefill"][0].service
    with svc._transfer_done:
        svc._transferring += 1
    assert svc._wait_transfers(timeout=0.05) is False
    with svc._transfer_done:
        svc._transferring -= 1
        svc._transfer_done.notify_all()
    assert svc._wait_transfers(timeout=1) is True
