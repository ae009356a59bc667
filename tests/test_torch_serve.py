"""The port's HTTP server (minigpt4_tpu_torch.serve) on the CPU, as
tests/test_serve.py drives the JAX package's: health and models, an image
session round trip, concurrent sessions, 404s, window-batched serving over
the page pool against a server without batching, the OpenAI endpoint
streamed and not, and the options the port does not serve yet.
"""

import base64
import gc
import io
import json
import threading
import urllib.error
import urllib.request
import weakref

import numpy as np
import pytest
from PIL import Image

from fixtures import build_gq_models, build_tiny_models
from minigpt4_tpu_torch import serve

IMAGE = np.random.default_rng(0).integers(0, 255, (40, 40, 3), dtype=np.uint8)


def _start(model, llm, **kw):
    httpd = serve.start_server(model, llm, port=0, session_ctx=256, n_ctx=256, n_batch=32,
                               device="cpu", **kw)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


@pytest.fixture(scope="module")
def gq_files(tmp_path_factory):
    return build_gq_models(tmp_path_factory.mktemp("torch_serve"))


@pytest.fixture(scope="module")
def paged_server(gq_files):
    """Window batching over a pool of 8 pages."""
    httpd, base = _start(*gq_files, batch_window_s=0.2, paged_pages=8)
    yield base, httpd
    httpd.shutdown()
    httpd.server_close()
    httpd.pool.close()


@pytest.fixture(scope="module")
def plain_server(gq_files):
    """Each session decodes alone."""
    httpd, base = _start(*gq_files)
    yield base, httpd
    httpd.shutdown()
    httpd.server_close()
    httpd.pool.close()


def test_server_close_stops_the_batcher_and_frees_the_pool(gq_files):
    """The window batcher's thread holds the pool: server_close ends it, and
    the pool (the engine's weights and caches) can then be freed."""
    httpd, base = _start(*gq_files, batch_window_s=0.05)
    sid = json.loads(_post(base, "/v1/sessions")[1])["session_id"]
    st, raw = _post(base, f"/v1/sessions/{sid}/chat",
                    json.dumps({"message": "hi", "limit": 2, "temp": 0.0}).encode())
    assert st == 200 and json.loads(raw)["text"]
    thread, pool = httpd.batcher._thread, weakref.ref(httpd.pool)
    httpd.shutdown()
    httpd.server_close()
    httpd.pool.close()
    assert not thread.is_alive()
    del httpd
    gc.collect()
    assert pool() is None


def _post(base, path, data=b"", timeout=120):
    req = urllib.request.Request(base + path, data=data, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read()


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=60) as r:
        return r.status, json.loads(r.read())


def _chat(base, msg, limit=6, **kw):
    _, body = _post(base, "/v1/sessions")
    sid = json.loads(body)["session_id"]
    _, body = _post(base, f"/v1/sessions/{sid}/chat",
                    json.dumps({"message": msg, "limit": limit, "temp": 0.0, **kw}).encode())
    return json.loads(body)["text"]


def _png(arr) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def test_health_and_models(paged_server):
    base, _ = paged_server
    st, h = _get(base, "/v1/health")
    assert st == 200 and h["ok"] is True
    assert "tok_s_30s" in h and h["prefix_cache"] == {"enabled": False}
    assert h["paged"] == {"free_pages": 8, "total_pages": 8, "broken": False}
    st, models = _get(base, "/v1/models")
    assert models["data"][0]["id"] == serve.MODEL_ID


def test_session_image_chat_roundtrip(plain_server):
    base, httpd = plain_server
    _, body = _post(base, "/v1/sessions")
    sid = json.loads(body)["session_id"]
    st, body = _post(base, f"/v1/sessions/{sid}/image", _png(IMAGE))
    assert st == 200 and json.loads(body)["ok"]
    s = httpd.pool._sessions[sid]
    assert s.is_image_chat and s.embedding.shape == (4, 256)
    st, body = _post(base, f"/v1/sessions/{sid}/chat",
                     json.dumps({"message": "what is this?", "limit": 6, "temp": 0.0}).encode())
    assert st == 200 and isinstance(json.loads(body)["text"], str)
    st, body = _post(base, f"/v1/sessions/{sid}/chat?stream=1",
                     json.dumps({"message": "and?", "limit": 4, "temp": 0.0}).encode())
    assert st == 200 and isinstance(body.decode(), str)
    req = urllib.request.Request(f"{base}/v1/sessions/{sid}", method="DELETE")
    with urllib.request.urlopen(req, timeout=30) as r:
        assert json.loads(r.read())["ok"]
    assert sid not in httpd.pool._sessions


def test_concurrent_sessions(paged_server):
    base, _ = paged_server
    texts = {}

    def run(i):
        texts[i] = _chat(base, "hello", limit=5)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(texts) == 3 and len(set(texts.values())) == 1  # same prompt, same text


def test_unknown_session_and_path_404(plain_server):
    base, _ = plain_server
    for method, path in (("POST", "/v1/sessions/9999/chat"), ("DELETE", "/v1/sessions/9999"),
                         ("GET", "/v1/nothing"), ("POST", "/v1/nothing")):
        req = urllib.request.Request(base + path, data=b"{}" if method == "POST" else None,
                                     method=method)
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=30)
        assert e.value.code == 404


def test_window_batched_paged_serving(paged_server, plain_server):
    """Concurrent generations decode as one paged group, with the text of
    sessions that decode alone, and every page returns to the pool."""
    base, httpd = paged_server
    texts = {}
    groups = []
    orig = httpd.pool.generate_batch_stream

    def spy(sessions, *a, **k):
        groups.append(len(sessions))
        return orig(sessions, *a, **k)

    httpd.pool.generate_batch_stream = spy
    try:
        threads = [threading.Thread(target=lambda i=i: texts.__setitem__(i, _chat(base, f"prompt {i}")))
                   for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        httpd.pool.generate_batch_stream = orig
    assert len(texts) == 3 and max(groups) >= 2  # lanes shared a group
    assert httpd.pool.paged_pool.free_pages == 8
    _, h = _get(base, "/v1/health")
    assert h["paged"]["free_pages"] == 8 and h["metrics"]["tokens_generated"] > 0
    for i in range(3):
        assert _chat(plain_server[0], f"prompt {i}") == texts[i]


def test_chat_completions(plain_server):
    base, httpd = plain_server

    def chat(messages, **kw):
        _, body = _post(base, "/v1/chat/completions", json.dumps(
            {"messages": messages, "temperature": 0.0, "max_tokens": 8, **kw}).encode())
        return json.loads(body)

    open_sessions = _get(base, "/v1/health")[1]["sessions"]
    r = chat([{"role": "user", "content": "hello there"}])
    assert r["object"] == "chat.completion"
    text1 = r["choices"][0]["message"]["content"]
    u = r["usage"]
    assert u["prompt_tokens"] > 0
    assert u["total_tokens"] == u["prompt_tokens"] + u["completion_tokens"]
    assert r["choices"][0]["finish_reason"] in ("stop", "length")
    assert chat([{"role": "user", "content": "hello there"}])["choices"][0]["message"][
        "content"] == text1  # stateless and deterministic
    r3 = chat([{"role": "user", "content": "hello there"},
               {"role": "assistant", "content": text1},
               {"role": "user", "content": "and then?"}])
    assert isinstance(r3["choices"][0]["message"]["content"], str)
    # logprobs take the host path: the same greedy tokens, each the top-1
    r = chat([{"role": "user", "content": "hello there"}], logprobs=True, top_logprobs=3)
    assert r["choices"][0]["message"]["content"] == text1
    for e in r["choices"][0]["logprobs"]["content"]:
        assert e["top_logprobs"][0]["token"] == e["token"] and len(e["top_logprobs"]) == 3
    # seeded sampling repeats; a huge logit bias forces its token at temp 0
    a, b = (chat([{"role": "user", "content": "hi"}], temperature=0.9, seed=7) for _ in "ab")
    assert a["choices"][0]["message"]["content"] == b["choices"][0]["message"]["content"]
    tid = 3 + ord("A")  # the byte token of "A"
    r = chat([{"role": "user", "content": "hi"}], max_tokens=4, logit_bias={str(tid): 1000.0})
    assert r["choices"][0]["message"]["content"] == httpd.pool.engine.tokenizer.id_to_str(tid) * 4
    _, h = _get(base, "/v1/health")
    assert h["sessions"] == open_sessions  # ephemeral sessions never leak
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base, "/v1/chat/completions",
              json.dumps({"messages": [{"role": "assistant", "content": "hi"}]}).encode())
    assert e.value.code == 400


def test_chat_completions_stream_and_image(paged_server):
    base, _ = paged_server
    url = "data:image/png;base64," + base64.b64encode(_png(IMAGE)).decode()
    msgs = [{"role": "user", "content": [{"type": "text", "text": "what is in the picture?"},
                                         {"type": "image_url", "image_url": {"url": url}}]}]
    req = urllib.request.Request(base + "/v1/chat/completions", method="POST", data=json.dumps(
        {"messages": msgs, "temperature": 0.0, "max_tokens": 6, "stream": True}).encode())
    with urllib.request.urlopen(req, timeout=120) as r:
        assert r.headers["Content-Type"] == "text/event-stream"
        events = [ln for ln in r.read().decode().split("\n\n") if ln.startswith("data: ")]
    assert events[-1] == "data: [DONE]"
    chunks = [json.loads(e[6:]) for e in events[:-1]]
    assert all(c["object"] == "chat.completion.chunk" for c in chunks)
    text = "".join(c["choices"][0]["delta"].get("content", "") for c in chunks)
    assert chunks[-1]["choices"][0]["finish_reason"] in ("stop", "length")
    _, body = _post(base, "/v1/chat/completions", json.dumps(
        {"messages": msgs, "temperature": 0.0, "max_tokens": 6}).encode())
    assert json.loads(body)["choices"][0]["message"]["content"] == text
    bad = [{"role": "user", "content": [{"type": "image_url",
                                         "image_url": {"url": "http://example.com/x.png"}}]}]
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base, "/v1/chat/completions", json.dumps({"messages": bad}).encode())
    assert e.value.code == 500


def test_stop_filter_straddles_token_boundaries():
    sf = serve._StopFilter(["XY"])
    assert sf.feed("aX") == "a"
    assert sf.feed("Yb") == "" and sf.stopped
    assert sf.flush() == ""
    sf = serve._StopFilter(["QQ"])
    assert sf.feed("ab") == "a" and sf.feed("c") == "b"
    assert sf.flush() == "c" and not sf.stopped
    sf = serve._StopFilter([])
    assert sf.feed("xyz") == "xyz" and sf.flush() == ""


def test_tiny_model_batched_server_matches_plain(tmp_path):
    """The 2-layer f32 fixture (head dim 8) through a window-batched dense
    server: the text of a server without batching."""
    model, llm = build_tiny_models(tmp_path)
    got_srv, got = _start(model, llm, batch_window_s=0.2)
    want_srv, want = _start(model, llm)
    try:
        texts = {}
        threads = [threading.Thread(target=lambda i=i: texts.__setitem__(i, _chat(got, f"q {i}")))
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert [texts[i] for i in range(2)] == [_chat(want, f"q {i}") for i in range(2)]
    finally:
        for srv in (got_srv, want_srv):
            srv.shutdown()
            srv.pool.close()


@pytest.mark.parametrize("flag,item", [("--continuous", "item 13"), ("--max-batch=4", "item 13"),
                                       ("--speculative-k=4", "item 14"),
                                       ("--no-prefix-cache", None), ("--park-idle", "item 16"),
                                       ("--tp=2", "item 11")])
def test_unported_options_fail_at_start_up(flag, item, capsys):
    """An option of the JAX server that the port does not serve yet stops the
    server before it loads anything, naming its ROADMAP item."""
    if item is None:  # the prefix cache is off already: asking for it off is fine
        with pytest.raises(FileNotFoundError):
            serve.main(["missing-model.bin", "missing-llm.bin", flag, "--device", "cpu"])
        return
    with pytest.raises(SystemExit):
        serve.main(["missing-model.bin", "missing-llm.bin", flag])
    assert f"ROADMAP Queue 1, {item}" in capsys.readouterr().err
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
        serve.start_server("missing-model.bin", "missing-llm.bin", continuous=True)


def test_w8a8_f8_smooth_options_reach_the_engine(tmp_path, monkeypatch):
    """--quant-mode w8a8 --smooth-scales F --cache-dtype f8 load: the
    decoder's weights are i8 with the scales folded in (its norm weights
    divided by them) over an e4m3 cache, and a chat runs."""
    import torch

    from minigpt4_tpu_torch import quality
    from minigpt4_tpu_torch.formats import LlamaFileReader

    model, llm = build_gq_models(tmp_path)
    scales = quality.compute_smooth_scales(llm, [np.arange(3, 40, dtype=np.int32)], device="cpu")
    quality.save_smooth_scales(tmp_path / "scales.npz", scales)
    started = []
    real = serve.start_server

    def start(*a, **k):
        httpd = real(*a, **k)
        httpd.serve_forever = lambda: None  # bound, not served
        started.append(httpd)
        return httpd

    monkeypatch.setattr(serve, "start_server", start)
    serve.main([str(model), str(llm), "--device", "cpu", "--port", "0", "--n-ctx", "256",
                "--session-ctx", "256", "--quant-mode", "w8a8",
                "--smooth-scales", str(tmp_path / "scales.npz"),
                "--cache-dtype", "f8"])
    pool = started[0].pool
    try:
        eng = pool.engine
        assert eng.quant_mode == "w8a8" and eng.cache_dtype == torch.float8_e4m3fn
        with LlamaFileReader(llm) as r:
            norm = r.tensor_f32("layers.0.attention_norm.weight")
        assert np.allclose(eng.llm_params["layers"]["attention_norm"][0].numpy(),
                           norm / scales["attn"][0])
        s = pool.new_session()
        s.ask("hello")
        assert s.state.cache["k"].dtype == torch.float8_e4m3fn
        assert len(list(s.generate(limit=4))) > 0
    finally:
        started[0].server_close()
        pool.close()
