"""HTTP serving on the PyTorch port: a stdlib JSON API over
:class:`~minigpt4_tpu_torch.engine.sessions.SessionPool`.

Counterpart of ``minigpt4_tpu/serve.py`` for window-batched serving over
the paged KV pool.  On a machine with an NVIDIA GPU:

    python -m minigpt4_tpu_torch.serve model.bin vicuna.bin --session-ctx 512 \\
        --batch-window-ms 30 --paged-pages 32

API (JSON unless noted):
  GET    /v1/models                            -> OpenAI model list
  GET    /v1/health                            -> {"ok", "sessions", "metrics",
                                                   "tok_s_30s", "prefix_cache",
                                                   "paged"?}
  POST   /v1/sessions                          -> {"session_id": int}
  POST   /v1/sessions/{id}/image   (PNG/JPEG body) -> {"ok": true}
  POST   /v1/sessions/{id}/chat    {"message", "limit"?, "temp"?, "top_k"?,
                                    "top_p"?, "mirostat"?, "logit_bias"?,
                                    "seed"?}   -> {"text": "..."}
                                    (?stream=1 -> chunked text/plain stream)
  DELETE /v1/sessions/{id}                     -> {"ok": true}
  POST   /v1/chat/completions                  -> OpenAI chat completion over an
                                                  ephemeral session (stream or not)

Device work serializes inside the pool; HTTP handling is threaded.  With
``--batch-window-ms`` the generations that arrive within the window decode
as one batched group (``SessionPool.generate_batch_stream``), over the page
pool when ``--paged-pages`` gives one.
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import queue
import re
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .engine.engine import MiniGPT4Engine
from .engine.sampling import SamplingParams
from .engine.sessions import SessionPool
from .image import preprocess

MODEL_ID = "minigpt4-tpu"
MAX_BATCH = 8  # lanes of a window group
# options of the JAX package's server that the port does not serve yet: the
# ROADMAP item of each and the values that ask for nothing the port lacks;
# any other value fails at start-up
UNPORTED = {
    "continuous": ("continuous batching (ROADMAP Queue 1, item 13)", (False,)),
    "max_batch": ("continuous batching (ROADMAP Queue 1, item 13)", (None,)),
    "speculative_k": ("speculative decoding (ROADMAP Queue 1, item 14)", (0,)),
    "draft_llm": ("draft-model speculative decoding (ROADMAP Queue 1, item 14)", (None,)),
    "draft_head": ("draft-head speculative decoding (ROADMAP Queue 1, item 14)", (None,)),
    "prefix_cache_mb": ("the radix prefix cache (ROADMAP Queue 1, item 15)", (None,)),
    "park_idle": ("parking idle sessions in host memory (ROADMAP Queue 1, item 16)", (False,)),
    "ctx_shift": ("context shift (ROADMAP Queue 1, item 5)", (False,)),
    "tp": ("serving over tp, which needs a rank-0 controller (ROADMAP Queue 1, item 11b)", (1,)),
}


def decode_image(body: bytes) -> np.ndarray:
    """An uploaded image (PNG, JPEG, ...) -> uint8 [H, W, 3] RGB."""
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(body)).convert("RGB"))


class _Batcher:
    """Window batching: the generations that arrive within ``window_s`` of
    the first decode together through SessionPool.generate_batch_stream, so
    every decode step reads the weights once for the whole group.  Prompts
    prefill per session before they are submitted; a group runs until its
    last lane finished (static batching).  :meth:`close` stops its thread,
    which holds the pool."""

    _DONE = object()
    _STOP = object()

    def __init__(self, pool: SessionPool, window_s: float):
        self.pool = pool
        self.window_s = window_s
        self._q: queue.Queue = queue.Queue()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def submit(self, session, limit: int, params) -> queue.Queue:
        """The session must hold a prepared prompt.  Returns a queue of str
        tokens that ends with _Batcher._DONE (after an exception, if one)."""
        out: queue.Queue = queue.Queue()
        self._q.put((session, limit, params, out))
        return out

    def close(self) -> None:
        """Decode what was submitted, then end the thread."""
        self._q.put(self._STOP)
        self._thread.join()

    def _run(self) -> None:
        stop = False
        while not stop:
            first = self._q.get()
            if first is self._STOP:
                return
            group = [first]
            deadline = time.monotonic() + self.window_s
            while len(group) < MAX_BATCH:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is self._STOP:
                    stop = True
                    break
                group.append(nxt)
            # mixed sampling configs share one group (per-lane rows); only
            # mirostat keeps host state and decodes per session
            rest = [g for g in group if g[2].mirostat == 0]
            if rest:
                self._decode_group(rest)
            for g in group:
                if g[2].mirostat != 0:
                    self._decode_single(g)

    def _decode_single(self, req) -> None:
        session, limit, params, out = req
        try:
            for token in self.pool.generate(session, limit, params):
                out.put(token)
        except Exception as e:
            print(f"[serve] mirostat decode failed: {type(e).__name__}: {e}", file=sys.stderr)
            out.put(e)
        out.put(self._DONE)

    def _decode_group(self, group) -> None:
        outs = [g[3] for g in group]
        err = None
        try:
            for updates in self.pool.generate_batch_stream(
                    [g[0] for g in group], limit=[g[1] for g in group],
                    params=[g[2] for g in group]):
                for i, token in updates:
                    outs[i].put(token)
        except Exception as e:
            print(f"[serve] batched decode failed: {type(e).__name__}: {e}", file=sys.stderr)
            err = e
        for out in outs:
            if err is not None:
                out.put(err)  # the handler re-raises it
            out.put(self._DONE)


class _Server:
    """Thin HTTP adapter; the pool's registry is the one record of which
    sessions exist."""

    def __init__(self, pool: SessionPool, batch_window_s: float = 0.0):
        self.pool = pool
        self.batcher = _Batcher(pool, batch_window_s) if batch_window_s > 0 else None

    def create(self) -> int:
        return self.pool.new_session().session_id

    def get(self, sid: int):
        return self.pool._sessions.get(sid)

    def drop(self, sid: int) -> bool:
        s = self.pool._sessions.get(sid)
        if s is not None:
            s.close()
        return s is not None

    def count(self) -> int:
        return len(self.pool._sessions)


class _StopFilter:
    """OpenAI ``stop``-sequence truncation over a token stream.  Emitted text
    never contains a stop sequence and generation ends when one completes;
    a tail of ``max(len(stop)) - 1`` characters is held back until it can no
    longer begin a match (sequences may straddle tokens)."""

    def __init__(self, stops: list[str]):
        self.stops = [s for s in stops if s]
        self._hold = max((len(s) for s in self.stops), default=1) - 1
        self._buf = ""
        self.stopped = False

    def feed(self, token: str) -> str:
        """The text safe to emit for this token ('' while the tail is held
        back); sets ``stopped`` when a sequence completed."""
        if not self.stops:
            return token
        self._buf += token
        cut = min((i for s in self.stops if (i := self._buf.find(s)) >= 0), default=-1)
        if cut >= 0:
            self.stopped = True
            out, self._buf = self._buf[:cut], ""
            return out
        emit = len(self._buf) - self._hold
        if emit <= 0:
            return ""
        out, self._buf = self._buf[:emit], self._buf[emit:]
        return out

    def flush(self) -> str:
        """The held-back tail, once the stream ended without a stop."""
        out, self._buf = self._buf, ""
        return out if not self.stopped else ""


def _host_generate(srv: _Server, s, limit: int, params, logprobs_top: int | None = None,
                   presence: float = 0.0, frequency: float = 0.0):
    """Per-token host-sampled generation for the OpenAI knobs the device loop
    does not carry: ``logprobs`` (the [V] distribution per step) and
    presence/frequency penalties (logits depend on the generated counts).
    The reference's own chat loop (minigpt4_library.py:609-657) with its EOS
    rules.  Yields (token, logprob, top_logprobs)."""
    import dataclasses

    pool = srv.pool
    nobias = dataclasses.replace(params, logit_bias=None) if params.logit_bias else params
    counts: dict[int, int] = {}
    chat = ""
    for _ in range(limit):
        logits = s.last_logits
        if logits is None or s.n_past >= s.state.n_ctx:
            return
        logits = np.asarray(logits, np.float32).copy()
        for tid, b in (params.logit_bias or {}).items():
            if 0 <= int(tid) < logits.size:
                logits[int(tid)] += float(b)
        lp_dist = None
        if logprobs_top is not None:
            x = logits - logits.max()
            lp_dist = x - np.log(np.exp(x).sum())
        penalized = logits
        if counts and (presence or frequency):
            penalized = logits.copy()
            for tid, c in counts.items():
                penalized[tid] -= presence + frequency * c
        tid = s.sampler.sample(penalized, nobias)
        counts[tid] = counts.get(tid, 0) + 1
        token = pool.engine.tokenizer.id_to_str(tid)
        pool._add_tokens(s, [tid])
        chat += token
        if MiniGPT4Engine.contains_eos_token(token):
            continue
        if MiniGPT4Engine.is_eos(chat):
            return
        if lp_dist is None:
            yield token, None, None
            continue
        k = max(int(logprobs_top), 0)
        order = np.argsort(-lp_dist, kind="stable")[:k]
        tops = [(pool.engine.tokenizer.id_to_str(int(t)), float(lp_dist[t])) for t in order]
        yield token, float(lp_dist[tid]), tops


def _generation_tokens(srv: _Server, s, limit: int, params):
    """One generation's tokens: through the window batcher where there is
    one (device sampling only: mirostat keeps host state), else the
    session's own stream."""
    if srv.batcher is None or params.mirostat != 0:
        yield from s.generate(limit=limit, params=params)
        return
    out = srv.batcher.submit(s, limit, params)
    while True:
        tok = out.get()
        if tok is srv.batcher._DONE:
            return
        if isinstance(tok, Exception):
            raise tok
        yield tok


def _reseed(s, seed: int) -> None:
    """A seeded request: both samplers (host chain and the device generator)."""
    s.sampler.reset(seed)
    s.state.generator.manual_seed(seed)


def make_handler(srv: _Server):
    sess_re = re.compile(r"^/v1/sessions/(\d+)(/(image|chat))?$")

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"  # chunked transfer needs 1.1 framing

        def log_message(self, *a):  # quiet
            pass

        def _json(self, code: int, obj) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _body(self) -> bytes:
            return self.rfile.read(int(self.headers.get("Content-Length", 0)))

        def _chunk(self, data: bytes) -> None:
            self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")

        def do_GET(self):
            if self.path == "/v1/models":
                self._json(200, {"object": "list", "data": [{
                    "id": MODEL_ID, "object": "model", "owned_by": "minigpt4_tpu_torch"}]})
            elif self.path == "/v1/health":
                pool = srv.pool
                body = {"ok": True, "sessions": srv.count(), "metrics": dict(pool.metrics),
                        "tok_s_30s": round(pool.generation_rate(), 2),
                        "prefix_cache": {"enabled": False}}
                if pool.paged_pool is not None:  # paged-KV capacity gauges
                    body["paged"] = {"free_pages": pool.paged_pool.free_pages,
                                     "total_pages": pool.paged_pool.n_pages,
                                     "broken": pool.paged_pool.broken}
                self._json(200, body)
            else:
                self._json(404, {"error": "not found"})

        def do_DELETE(self):
            m = sess_re.match(self.path)
            if m and not m.group(2):
                ok = srv.drop(int(m.group(1)))
                self._json(200 if ok else 404, {"ok": ok})
            else:
                self._json(404, {"error": "not found"})

        def _oai_parse_user(self, content):
            """OpenAI user content -> (text, pixels or None).  A string or a
            parts array; image parts must be data: URLs (nothing is fetched)."""
            if isinstance(content, str):
                return content, None
            text, pixels = [], None
            for part in content or []:
                if part.get("type") == "text":
                    text.append(part.get("text", ""))
                elif part.get("type") == "image_url" and pixels is None:
                    url = (part.get("image_url") or {}).get("url", "")
                    if not url.startswith("data:"):
                        raise ValueError("image_url must be a data: URL")
                    img = decode_image(base64.b64decode(url.split(",", 1)[1]))
                    pixels = preprocess(img, size=srv.pool.engine.vision_cfg.vit.image_size)
            return "".join(text), pixels

        def _chat_completions(self):
            """OpenAI-compatible chat over an ephemeral session: the messages
            replay through the reference's Vicuna-v0 template (system
            prompt, `Human:` / `### Assistant:` turns, the first image as the
            32-row embedding), then the last user turn generates."""
            req = json.loads(self._body() or b"{}")
            messages = req.get("messages") or []
            if not messages or messages[-1].get("role") != "user":
                self._json(400, {"error": {"message": "messages must end with a user turn",
                                           "type": "invalid_request_error"}})
                return
            lb = {int(k): float(v) for k, v in (req.get("logit_bias") or {}).items()}
            params = SamplingParams(temp=float(req.get("temperature", 0.8)),
                                    top_p=float(req.get("top_p", 0.9)),
                                    top_k=int(req.get("top_k", 40)),
                                    mirostat=int(req.get("mirostat", 0)),
                                    logit_bias=lb or None)
            stops = req.get("stop")
            stops = ([stops] if isinstance(stops, str) else list(stops or []))[:8]
            presence = float(req.get("presence_penalty") or 0.0)
            frequency = float(req.get("frequency_penalty") or 0.0)
            want_lp = bool(req.get("logprobs"))
            top_lp = int(req.get("top_logprobs") or 0)
            limit = int(req.get("max_tokens") or 256)
            s = srv.pool.new_session()
            try:
                srv.pool.system_prompt(s)
                have_img = False
                for m in messages[:-1]:
                    role, content = m.get("role"), m.get("content")
                    if role == "user":
                        text, px = self._oai_parse_user(content)
                        if px is not None and not have_img:
                            s.encode_image(px)
                            s.is_image_chat = have_img = True
                        s.ask(text)
                    elif role == "assistant":
                        # a replayed reply ends with the "###" separator the
                        # live decode leaves in the cache
                        reply = (content if isinstance(content, str)
                                 else "".join(p.get("text", "") for p in (content or [])))
                        srv.pool._add_strings(s, reply + "###")
                text, px = self._oai_parse_user(messages[-1].get("content"))
                if px is not None and not have_img:
                    s.encode_image(px)
                    s.is_image_chat = True
                s.ask(text)
                prompt_tokens = s.n_past
                if req.get("seed") is not None:
                    _reseed(s, int(req["seed"]))
                host = want_lp or presence != 0.0 or frequency != 0.0 or params.mirostat != 0

                def token_iter():
                    if host:
                        yield from _host_generate(srv, s, limit, params,
                                                  logprobs_top=top_lp if want_lp else None,
                                                  presence=presence, frequency=frequency)
                    else:
                        for tok in _generation_tokens(srv, s, limit, params):
                            yield tok, None, None

                def lp_entry(tok, lp, tops):
                    return {"token": tok, "logprob": lp, "top_logprobs": [
                        {"token": t, "logprob": v} for t, v in (tops or [])]}

                rid = f"chatcmpl-{s.session_id}-{int(time.time())}"
                model = req.get("model", MODEL_ID)
                sf = _StopFilter(stops)
                if req.get("stream", False):
                    self.send_response(200)
                    self.send_header("Content-Type", "text/event-stream")
                    self.send_header("Transfer-Encoding", "chunked")
                    self.end_headers()

                    def sse(delta, entry=None, finish=None):
                        c = {"index": 0, "delta": delta, "finish_reason": finish}
                        if want_lp:
                            c["logprobs"] = {"content": [entry]} if entry else None
                        obj = {"id": rid, "object": "chat.completion.chunk", "model": model,
                               "choices": [c]}
                        self._chunk(f"data: {json.dumps(obj)}\n\n".encode())

                    n = 0
                    try:
                        for tok, lp, tops in token_iter():
                            n += 1
                            text = sf.feed(tok)
                            if sf.stopped:
                                if text:
                                    sse({"content": text})
                                break
                            if text or want_lp:
                                sse({"content": text} if text else {},
                                    lp_entry(tok, lp, tops) if want_lp else None)
                        tail = sf.flush()
                        if tail:
                            sse({"content": tail})
                        sse({}, finish="length" if n >= limit and not sf.stopped else "stop")
                        self._chunk(b"data: [DONE]\n\n")
                    except Exception:
                        pass  # headers are out: only the stream can end
                    self.wfile.write(b"0\r\n\r\n")
                    return
                parts, entries, n = [], [], 0
                for tok, lp, tops in token_iter():
                    n += 1
                    text = sf.feed(tok)
                    if text:
                        parts.append(text)
                    if sf.stopped:
                        break
                    if want_lp:
                        entries.append(lp_entry(tok, lp, tops))
                parts.append(sf.flush())
                choice = {"index": 0,
                          "message": {"role": "assistant", "content": "".join(parts)},
                          "finish_reason": "length" if n >= limit and not sf.stopped else "stop"}
                if want_lp:
                    choice["logprobs"] = {"content": entries}
                resp = {"id": rid, "object": "chat.completion", "created": int(time.time()),
                        "model": model, "choices": [choice],
                        "usage": {"prompt_tokens": prompt_tokens,
                                  "completion_tokens": s.n_past - prompt_tokens,
                                  "total_tokens": s.n_past}}
            finally:
                # closed before the response: a client that then polls
                # /v1/health never sees the ephemeral session
                s.close()
            self._json(200, resp)

        def do_POST(self):
            path = self.path.split("?")[0]
            if path == "/v1/chat/completions":
                try:
                    self._chat_completions()
                except Exception as e:
                    try:
                        self._json(500, {"error": {"message": f"{type(e).__name__}: {e}",
                                                   "type": "server_error"}})
                    except Exception:
                        pass
                return
            if path == "/v1/sessions":
                self._json(200, {"session_id": srv.create()})
                return
            m = sess_re.match(path)
            if not m or not m.group(3):
                self._json(404, {"error": "not found"})
                return
            s = srv.get(int(m.group(1)))
            if s is None:
                self._json(404, {"error": "no such session"})
                return
            try:
                if m.group(3) == "image":
                    img = decode_image(self._body())
                    s.upload_image(preprocess(img, size=srv.pool.engine.vision_cfg.vit.image_size))
                    self._json(200, {"ok": True})
                    return
                req = json.loads(self._body() or b"{}")
                lb = {int(k): float(v) for k, v in (req.get("logit_bias") or {}).items()}
                params = SamplingParams(temp=float(req.get("temp", 0.8)),
                                        top_k=int(req.get("top_k", 40)),
                                        top_p=float(req.get("top_p", 0.9)),
                                        mirostat=int(req.get("mirostat", 0)),
                                        logit_bias=lb or None)
                if req.get("seed") is not None:
                    _reseed(s, int(req["seed"]))
                limit = int(req.get("limit", 256))
                s.ask(str(req.get("message", "")))
                if "stream=1" in self.path:
                    self.send_response(200)
                    self.send_header("Content-Type", "text/plain; charset=utf-8")
                    self.send_header("Transfer-Encoding", "chunked")
                    self.end_headers()
                    try:
                        for tok in _generation_tokens(srv, s, limit, params):
                            self._chunk(tok.encode())
                    except Exception:
                        pass  # headers are out: only the stream can end
                    self.wfile.write(b"0\r\n\r\n")
                    return
                self._json(200, {"text": "".join(_generation_tokens(srv, s, limit, params))})
            except Exception as e:  # engine errors become 500s; serving goes on
                try:
                    self._json(500, {"error": f"{type(e).__name__}: {e}"})
                except Exception:
                    pass

    return Handler


class _HTTPServer(ThreadingHTTPServer):
    """The HTTP server; ``server_close`` also stops the window batcher."""

    batcher = None

    def server_close(self) -> None:
        super().server_close()
        if self.batcher is not None:
            self.batcher.close()


def start_server(model_path, llm_path, host: str = "127.0.0.1", port: int = 8000,
                 session_ctx: int = 512, batch_window_s: float = 0.0,
                 paged_pages: int | None = None, **engine_kwargs) -> ThreadingHTTPServer:
    """Load the model, build the session pool and bind the server (not yet
    serving: call ``serve_forever``; ``shutdown`` stops serving,
    ``server_close`` releases the socket and stops the batcher, whose
    thread holds the pool).  ``port=0`` binds an ephemeral port.  Where the
    window batcher decodes paged groups from captured CUDA graphs, the pool
    captures them first for every lane count up to MAX_BATCH
    (:meth:`SessionPool.warmup`; its figures are ``httpd.warmup``, else
    None).
    Options of the JAX package's server that the port does not serve yet
    (``UNPORTED``) raise NotImplementedError naming their ROADMAP item."""
    for name, (what, served) in UNPORTED.items():
        if name in engine_kwargs and engine_kwargs.pop(name) not in served:
            raise NotImplementedError(f"{name}: {what} is not ported yet")
    pool = SessionPool(model_path, llm_path, session_ctx=session_ctx,
                       paged_pool_pages=paged_pages, **engine_kwargs)
    warm = None
    if batch_window_s > 0 and pool.paged_pool is not None and pool.engine.graphs_enabled:
        try:
            warm = pool.warmup(range(1, MAX_BATCH + 1))
        except BaseException:
            pool.close()
            raise
    srv = _Server(pool, batch_window_s=batch_window_s)
    httpd = _HTTPServer((host, port), make_handler(srv))
    httpd.pool = pool  # for tests and shutdown
    httpd.warmup = warm
    httpd.batcher = srv.batcher
    return httpd


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description="minigpt4_tpu_torch HTTP serving")
    ap.add_argument("model_path")
    ap.add_argument("llm_model_path")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--session-ctx", type=int, default=512)
    ap.add_argument("--n-ctx", type=int, default=2048)
    ap.add_argument("--batch-window-ms", type=float, default=0.0,
                    help="decode the generations arriving within this window as one "
                    "batched group (0 = each session decodes alone)")
    ap.add_argument("--paged-pages", type=int, default=0, metavar="N",
                    help="share a KV pool of N 128-position pages across the lanes of "
                    "batched groups: a lane holds device memory for the positions it "
                    "used, not a full session_ctx (0 = dense stacked caches)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--quant-mode", choices=["auto", "repack", "gq", "qtensor", "w8a8"],
                    default="auto",
                    help="form of quantized weights (MiniGPT4Engine quant_mode): auto = gq for "
                    "the decoder where it applies, one byte per code, repacked otherwise and "
                    "for the vision weights; gq = gq wherever it applies, the 4/5/6-bit codes "
                    "packed (0.5-0.75 B each); repack = repacked everywhere; w8a8 = i8 codes "
                    "and activations where K %% 256 == 0; qtensor = packed bytes dequantized "
                    "per call.  MINIGPT4_TPU_GQ_PACK=0 or 1 decides the gq packing instead")
    ap.add_argument("--cache-dtype", choices=["auto", "bf16", "f32", "f8"], default="auto",
                    help="KV cache element type (f8 = e4m3); auto = the engine's default, bf16")
    ap.add_argument("--smooth-scales", default=None, metavar="NPZ",
                    help="smooth-quant scales of minigpt4_tpu_torch.quality (--save-scales), "
                    "folded into the decoder's w8a8 weights (auto resolves to w8a8)")
    # the JAX server's options that the port does not serve yet: accepted so
    # that asking for one names its ROADMAP item instead of a usage error
    ap.add_argument("--continuous", action="store_true")
    ap.add_argument("--max-batch", type=int, default=None)
    ap.add_argument("--park-idle", action="store_true")
    ap.add_argument("--speculative-k", type=int, default=0)
    ap.add_argument("--draft-llm", default=None)
    ap.add_argument("--draft-head", default=None)
    ap.add_argument("--ctx-shift", action="store_true")
    ap.add_argument("--prefix-cache-mb", type=int, default=None)
    ap.add_argument("--no-prefix-cache", action="store_true")
    ap.add_argument("--tp", type=int, default=1)
    args = ap.parse_args(argv)
    try:
        httpd = start_server(args.model_path, args.llm_model_path, args.host, args.port,
                             session_ctx=args.session_ctx, n_ctx=args.n_ctx,
                             batch_window_s=args.batch_window_ms / 1e3,
                             paged_pages=args.paged_pages or None, device=args.device,
                             quant_mode=args.quant_mode,
                             cache_dtype=None if args.cache_dtype == "auto" else args.cache_dtype,
                             smooth_scales=args.smooth_scales,
                             **{name: getattr(args, name) for name in UNPORTED})
    except NotImplementedError as e:
        ap.error(str(e))
    print(f"serving on http://{args.host}:{args.port}", flush=True)
    httpd.serve_forever()


if __name__ == "__main__":
    main()
