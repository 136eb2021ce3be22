"""The port's generation server over real HTTP on the CPU (``--device
cpu``, the ``tiny`` config): health and metrics, token and text requests,
the JSONL stream, the coalescing engine against the continuous one, the
SIGTERM drain, and the options that are not ported yet."""

import json
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from torchx_tpu_torch.apps import generate_server as gs
from torchx_tpu_torch.models import generate as tgen


def _start(**kw):
    srv = gs.serve("tiny", port=0, device="cpu", **kw)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


def _stop(srv):
    srv.shutdown()
    srv.service.close()
    srv.server_close()


@pytest.fixture(scope="module")
def server():
    srv, url = _start(max_batch=4)
    yield srv, url
    _stop(srv)


def post(url, payload, raw=False):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            body = resp.read()
            return resp.status, body if raw else json.loads(body)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


class TestEndpoints:
    def test_healthz_reports_the_engine(self, server):
        _, url = server
        code, body = get(f"{url}/healthz")
        body = json.loads(body)
        assert code == 200 and body["status"] == "ok" and body["device"] == "cpu"
        for k in ("occupancy", "queue_depth", "active_slots", "kv_blocks_free",
                  "block_size", "prefix_summary"):
            assert k in body, body

    def test_tokens_match_dense_generate(self, server):
        srv, url = server
        code, body = post(f"{url}/v1/generate",
                          {"tokens": [[1, 2, 3], [9, 8, 7, 6, 5]], "max_new_tokens": 6})
        assert code == 200 and set(body["timing"]) == {"queue_ms", "total_ms", "ttft_ms"}
        svc = srv.service
        for seq, out in zip(([1, 2, 3], [9, 8, 7, 6, 5]), body["tokens"]):
            want = tgen.generate(svc.params, torch.tensor([seq]), svc.cfg, 6)[0].tolist()
            assert out == want

    def test_text_mode_byte_codec(self, server):
        _, url = server
        code, body = post(f"{url}/v1/generate", {"text": "hé", "max_new_tokens": 3})
        assert code == 200 and isinstance(body["text"], list)
        assert body["text"][0].startswith("hé")

    def test_metricz_exports_serving_metrics(self, server):
        _, url = server
        post(f"{url}/v1/generate", {"tokens": [[2, 3]], "max_new_tokens": 2})
        code, text = get(f"{url}/metricz")
        assert code == 200
        for name in ("tpx_serve_tokens_total", "tpx_serve_slot_occupancy",
                     "tpx_serve_ttft_seconds_bucket"):
            assert name in text

    def test_stream_matches_batch(self, server):
        _, url = server
        req = {"tokens": [[4, 5, 6]], "max_new_tokens": 7, "temperature": 0.9, "seed": 3}
        _, batch = post(f"{url}/v1/generate", req)
        code, raw = post(f"{url}/v1/generate", {**req, "stream": True, "stream_chunk": 3},
                         raw=True)
        lines = [json.loads(x) for x in raw.decode().splitlines()]
        assert code == 200 and lines[-1] == {"done": True}
        streamed = [t for line in lines[:-1] for t in line["tokens"]]
        assert [4, 5, 6] + streamed == batch["tokens"][0]

    def test_errors_are_4xx_and_unported_kv_is_501(self, server):
        _, url = server
        assert post(f"{url}/v1/generate", {"max_new_tokens": 2})[0] == 400
        assert post(f"{url}/v1/generate", {"tokens": [[1] * 200]})[0] == 400
        code, body = post(f"{url}/v1/generate",
                          {"tokens": [[1], [2]], "stream": True})
        assert code == 400 and "one sequence" in body["error"]
        code, body = post(f"{url}/v1/generate", {"tokens": [[1, 512]], "max_new_tokens": 2})
        assert code == 400 and "token ids" in body["error"]
        code, body = post(f"{url}/v1/kv", {})
        assert code == 501 and "not ported yet" in body["error"]
        assert get(f"{url}/nowhere")[0] == 404


def test_coalesce_matches_continuous():
    """Both engines give the same tokens, greedy and sampled (a draw keys
    on (seed, position) in both)."""
    cont = gs.GenerateService("tiny", device="cpu", engine="continuous", max_batch=4)
    coal = gs.GenerateService("tiny", device="cpu", engine="coalesce", batch_window_ms=50,
                              max_batch=4)
    try:
        for prompt, temp, seed in (([1, 2, 3], 0.0, 0), ([9, 8, 7, 6], 0.7, 5)):
            a = cont.generate([prompt], 8, temperature=temp, seed=seed)
            b = coal.generate([prompt], 8, temperature=temp, seed=seed)
            assert a == b
        # concurrent compatible requests share a batch, each row as alone
        outs = {}
        threads = [threading.Thread(target=lambda s=s: outs.update(
            {s: coal.generate([[s, s + 1]], 4)})) for s in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert coal.batches < coal.batched_sequences == 5
        for s_, out in outs.items():
            assert out == cont.generate([[s_, s_ + 1]], 4)
    finally:
        cont.close()
        coal.close()


class TestDrain:
    def test_drain_finishes_inflight_then_rejects(self):
        svc = gs.GenerateService("tiny", device="cpu", engine="continuous", max_batch=4)
        try:
            results = []
            t = threading.Thread(target=lambda: results.append(
                svc.generate([[1, 2]], max_new_tokens=4)))
            t.start()
            time.sleep(0.05)
            assert svc.drain(grace_s=120) is True
            t.join(timeout=60)
            assert results and len(results[0][0]) == 6
            with pytest.raises(gs.ServiceDraining):
                svc.generate([[1]], max_new_tokens=1)
        finally:
            svc.close()

    def test_draining_healthz_and_generate_are_503(self):
        srv, url = _start()
        try:
            srv.service.drain(grace_s=60)
            code, body = get(f"{url}/healthz")
            assert code == 503 and json.loads(body)["status"] == "draining"
            code, body = post(f"{url}/v1/generate", {"tokens": [[1]], "max_new_tokens": 1})
            assert code == 503 and "drain" in body["error"]
        finally:
            _stop(srv)

    def test_coalesce_drain_stops_admission(self):
        svc = gs.GenerateService("tiny", device="cpu", engine="coalesce", batch_window_ms=1)
        try:
            svc.generate([[1, 2]], max_new_tokens=2)
            assert svc.drain(grace_s=60) is True
            with pytest.raises(gs.ServiceDraining):
                svc.generate([[1]], max_new_tokens=1)
        finally:
            svc.close()

    def test_make_drain_sequence(self):
        calls = []

        class FakeServer:
            def shutdown(self):
                calls.append("shutdown")

        class FakeService:
            def drain(self, grace_s):
                calls.append(("drain", grace_s))
                return True

        gs.make_drain(FakeServer(), FakeService(), grace_s=7.5)()
        assert calls == [("drain", 7.5), "shutdown"]


@pytest.mark.parametrize("kw", [dict(serve_role="prefill"), dict(serve_role="decode"),
                                dict(kv_transfer="local"), dict(int8=True),
                                dict(ckpt_dir="/nonexistent")])
def test_unported_options_raise(kw):
    with pytest.raises(NotImplementedError, match="not ported yet"):
        gs.GenerateService("tiny", device="cpu", **kw)


def test_a_failed_batch_stops_the_coalescer(monkeypatch):
    svc = gs.GenerateService("tiny", device="cpu", engine="coalesce", batch_window_ms=1)
    try:
        def boom(*a, **k):
            raise RuntimeError("device fault")

        monkeypatch.setattr(tgen, "generate", boom)
        with pytest.raises(RuntimeError, match="device fault"):
            svc.generate([[1, 2]], 2)
        assert "device fault" in svc.failure
        with pytest.raises(RuntimeError, match="service failed"):
            svc.generate([[1, 2]], 2)
    finally:
        svc.close()


def test_unknown_and_moe_configs_raise():
    with pytest.raises(ValueError, match="unknown config"):
        gs.GenerateService("nope", device="cpu")
    with pytest.raises(NotImplementedError, match="MoE"):
        gs.GenerateService("moe_tiny", device="cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        gs.GenerateService("tiny", device="cpu", engine="bogus")
