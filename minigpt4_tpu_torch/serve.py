"""HTTP serving on the PyTorch port: a stdlib JSON API over
:class:`~minigpt4_tpu_torch.engine.sessions.SessionPool`.

Counterpart of ``minigpt4_tpu/serve.py``.  On a machine with an NVIDIA GPU:

    python -m minigpt4_tpu_torch.serve model.bin vicuna.bin --session-ctx 512 \\
        --continuous --max-batch 8 --paged-pages 32 --park-idle

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
``--continuous`` generations join one running group of ``--max-batch``
lanes at chunk boundaries (``sessions.ContinuousBatcher``); with
``--batch-window-ms`` the generations that arrive within the window decode
as one batched group (``SessionPool.generate_batch_stream``).  Both decode
over the page pool when ``--paged-pages`` gives one.  ``--park-idle`` moves
a session's cache to host memory between turns.  The radix prefix cache
(on unless ``--no-prefix-cache``; ``--prefix-cache-mb``) serves every
session's system prompt after the first, and the OpenAI route captures each
transcript so that the next request of a conversation prefills only its new
turn.

``--speculative-k K`` decodes by speculation (n-gram drafts verified K at a
time: greedy streams give plain greedy's ids, sampled ones speculative
sampling's draws), in single sessions and in both batchers, whose groups
fall back to plain chunks while their acceptance does not pay
(``engine._SpecGovernor``, the ``spec_demotions`` metric).
``--draft-llm`` or ``--draft-head`` drafts a session's greedy stream with a
smaller model instead.

``--tp N`` serves one model over N tensor-parallel ranks, one process each
(on one card they share it over gloo; with N cards each rank has its own):

    python -m minigpt4_tpu_torch.serve model.bin vicuna.bin --tp 2 \
        --continuous --max-batch 8 --paged-pages 32 [--speculative-k 8]

starts the N - 1 other ranks itself (spawned processes, a ``file://``
rendezvous in a temporary directory); under ``torchrun`` each process takes
its rank from ``RANK`` instead.  Rank 0 serves HTTP; every other rank loads
the same model and replays rank 0's device operations
(``parallel/controller.py``), every collective with a deadline
(``TP_TIMEOUT_S``).  A rank that fails or disagrees fails the request, and
every request after it.  The prefix cache is off under tp.
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import os
import queue
import re
import shutil
import signal
import sys
import tempfile
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np

from .engine.engine import MiniGPT4Engine, check_tp, resolve_decoder_mode
from .engine.sampling import SamplingParams
from .engine.sessions import ContinuousBatcher, SessionPool
from .formats import LlamaFileReader
from .image import preprocess

MODEL_ID = "minigpt4-tpu"
MAX_BATCH = 8  # lanes of a window group
TP_TIMEOUT_S = 300.0  # the deadline of every collective of a tp server


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
    sessions exist.  ``continuous`` takes precedence over a batch window."""

    def __init__(self, pool: SessionPool, batch_window_s: float = 0.0,
                 continuous: bool = False, max_batch: int = 8, park_idle: bool = False):
        self.pool = pool
        self.park_idle = park_idle
        if continuous:
            self.batcher = ContinuousBatcher(pool, max_batch=max_batch)
        elif batch_window_s > 0:
            self.batcher = _Batcher(pool, batch_window_s)
        else:
            self.batcher = None

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


def _generation_tokens(srv: _Server, s, limit: int, params, park: bool = True):
    """One generation's tokens: through the batcher where there is one
    (device sampling only: mirostat keeps host state), else the session's
    own stream; then, under --park-idle, the session parks (``park=False``
    for an ephemeral session that closes right after)."""
    if srv.batcher is None or params.mirostat != 0:
        yield from s.generate(limit=limit, params=params)
    else:
        out = srv.batcher.submit(s, limit, params)
        while True:
            tok = out.get()
            if tok is srv.batcher._DONE:
                break
            if isinstance(tok, Exception):
                raise tok
            yield tok
    if park and srv.park_idle:
        s.park()  # the turn is done: the cache waits in host memory


def _reseed(s, seed: int) -> None:
    """A seeded request: both samplers (host chain and the device generator)."""
    s.reseed(seed)


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
                        "prefix_cache": pool.prefix_cache_stats()}
                if pool.paged_pool is not None:  # paged-KV capacity gauges
                    body["paged"] = {"free_pages": pool.paged_pool.free_pages,
                                     "total_pages": pool.paged_pool.n_pages,
                                     "broken": pool.paged_pool.broken,
                                     "preemptions": getattr(srv.batcher, "preemptions", 0)}
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
                # the transcript as the engine's template pieces, fed at once:
                # the longest run of them the radix cache holds installs
                pieces, have_img = [], False
                for m in messages:
                    role, content = m.get("role"), m.get("content")
                    if role == "user":
                        text, px = self._oai_parse_user(content)
                        emb = None
                        if px is not None and not have_img:
                            emb, have_img = s.encode_image(px), True
                        pieces += srv.pool.engine.chat_pieces(text, emb)
                    elif role == "assistant":
                        # a replayed reply ends with the "###" separator the
                        # live decode leaves in the cache
                        reply = (content if isinstance(content, str)
                                 else "".join(p.get("text", "") for p in (content or [])))
                        pieces.append(("text", reply + "###"))
                srv.pool.feed(s, pieces)
                # the whole replayed transcript into the radix cache before
                # decoding: the conversation's next request (these messages,
                # the reply, a new turn) then prefills only its new turn
                srv.pool.capture_prefix(s)
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
                        for tok in _generation_tokens(srv, s, limit, params, park=False):
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
                try:
                    self._json(200, {"session_id": srv.create()})
                except Exception as e:  # a broken tp controller refuses every call
                    self._json(500, {"error": f"{type(e).__name__}: {e}"})
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
                    if srv.park_idle:
                        s.park()  # the user types the question meanwhile
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
    """The HTTP server; ``server_close`` also stops the batcher and, under
    tp, the other ranks (``_TPRanks``)."""

    batcher = None
    ranks = None

    def server_close(self) -> None:
        super().server_close()
        if self.batcher is not None:
            self.batcher.close()
        if self.ranks is not None:
            self.ranks.close()


class _TPRanks:
    """Rank 0's side of a tp server: its controller, the follower processes
    it spawned (none under torchrun) and the process group it made."""

    def __init__(self, ctl, procs: list, rendezvous: str | None, own_group: bool):
        self.ctl, self.procs, self.rendezvous, self.own_group = ctl, procs, rendezvous, own_group

    def close(self, timeout_s: float = 60.0) -> None:
        """Stop the followers' loops, join the followers (killed past
        ``timeout_s``) and take the process group down where it was made
        here."""
        import torch.distributed as dist

        try:
            self.ctl.stop()
        finally:
            self.ctl.pool._ctl = None  # the pool is this rank's own again
            deadline = time.monotonic() + timeout_s
            for p in self.procs:
                p.join(max(0.0, deadline - time.monotonic()))
                if p.is_alive():
                    p.kill()
                    p.join(10)
            if self.own_group and dist.is_initialized():
                dist.destroy_process_group()
            if self.rendezvous:
                shutil.rmtree(self.rendezvous, ignore_errors=True)

    def failed(self) -> list[int]:
        """Spawned ranks that exited with an error."""
        return [r + 1 for r, p in enumerate(self.procs) if p.exitcode not in (None, 0)]


def _follower_main(rank: int, tp: int, init_method: str, timeout_s: float, args: tuple,
                   kwargs: dict) -> None:
    """A spawned follower rank: join the group, build the same pool and
    follow rank 0 until it stops (exit code 1 on an error)."""
    import torch.distributed as dist

    from .parallel.mesh import init_tp

    try:
        init_tp(tp, kwargs.get("device", "cuda"), init_method=init_method, rank=rank,
                timeout_s=timeout_s)
        start_server(*args, tp=tp, tp_timeout_s=timeout_s, **kwargs)
    except BaseException:
        print(f"[serve] tp rank {rank} failed:\n{traceback.format_exc()}", file=sys.stderr,
              flush=True)
        raise SystemExit(1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def start_server(model_path, llm_path, host: str = "127.0.0.1", port: int = 8000,
                 session_ctx: int = 512, batch_window_s: float = 0.0, continuous: bool = False,
                 max_batch: int = 8, park_idle: bool = False, paged_pages: int | None = None,
                 prefix_cache: bool = True, prefix_cache_mb: int = 512, tp: int = 1,
                 tp_timeout_s: float = TP_TIMEOUT_S, pool: SessionPool | None = None,
                 **engine_kwargs) -> ThreadingHTTPServer | None:
    """Load the model, build the session pool and bind the server (not yet
    serving: call ``serve_forever``; ``shutdown`` stops serving,
    ``server_close`` releases the socket and stops the batcher, whose
    thread holds the pool).  ``port=0`` binds an ephemeral port.  Where the
    batcher decodes from captured CUDA graphs, they are captured first: the
    continuous batcher's two chunks at ``max_batch`` lanes
    (:meth:`ContinuousBatcher.warmup`), or the window batcher's paged
    group at every lane count up to MAX_BATCH (:meth:`SessionPool.warmup`);
    the figures are ``httpd.warmup``, else None.

    ``tp`` > 1 serves over tensor-parallel ranks (module docstring).  In a
    process of a group that exists already (``torch.distributed``
    initialized, as ``parallel.dryrun.run_ranks`` makes it) or under
    ``torchrun`` (``RANK`` set), this process is its rank: rank 0 returns
    the server, any other rank follows rank 0 until the server closes and
    returns None.  Otherwise this process becomes rank 0 and spawns the
    others first; the server returns with them running, and
    ``server_close`` stops them (``httpd.ranks``).  ``tp_timeout_s`` is the
    deadline of every collective.

    ``pool``: serve a loaded ``SessionPool`` (over the engine's tp ranks, on
    every rank of a group that exists) instead of loading the files; the
    pool's own settings stand, and closing the server leaves it open."""
    if tp > 1:
        return _start_tp(model_path, llm_path, tp, tp_timeout_s, dict(
            host=host, port=port, session_ctx=session_ctx, batch_window_s=batch_window_s,
            continuous=continuous, max_batch=max_batch, park_idle=park_idle,
            paged_pages=paged_pages, prefix_cache=prefix_cache,
            prefix_cache_mb=prefix_cache_mb, **engine_kwargs), pool)
    if pool is None:
        pool = SessionPool(model_path, llm_path, session_ctx=session_ctx,
                           paged_pool_pages=paged_pages, prefix_cache=prefix_cache,
                           prefix_cache_mb=prefix_cache_mb, **engine_kwargs)
    return _serve_pool(pool, host, port, batch_window_s, continuous, max_batch, park_idle)


def _serve_pool(pool: SessionPool, host: str, port: int, batch_window_s: float,
                continuous: bool, max_batch: int, park_idle: bool) -> ThreadingHTTPServer:
    """Bind the HTTP server over a loaded pool (``start_server``)."""
    srv = warm = None
    try:
        srv = _Server(pool, batch_window_s=batch_window_s, continuous=continuous,
                      max_batch=max_batch, park_idle=park_idle)
        if pool.engine.graphs_enabled:
            if continuous:
                warm = srv.batcher.warmup()
            elif batch_window_s > 0 and pool.paged_pool is not None:
                warm = pool.warmup(range(1, MAX_BATCH + 1))
    except BaseException:
        if srv is not None and srv.batcher is not None:
            srv.batcher.close()
        pool.close()
        raise
    httpd = _HTTPServer((host, port), make_handler(srv))
    httpd.pool = pool  # for tests and shutdown
    httpd.warmup = warm
    httpd.batcher = srv.batcher
    return httpd


def _start_tp(model_path, llm_path, tp: int, timeout_s: float, kw: dict,
              pool: SessionPool | None = None):
    """``start_server`` over ``tp`` ranks (its docstring)."""
    import multiprocessing as mp

    import torch.distributed as dist

    from .parallel.controller import Controller
    from .parallel.mesh import init_tp

    server_kw = {k: kw.pop(k) for k in ("host", "port", "batch_window_s", "continuous",
                                        "max_batch", "park_idle")}
    device = kw.get("device", "cuda")
    own_pool = pool is None
    if own_pool:
        with LlamaFileReader(llm_path) as reader:  # JAX's refusals, before any rank starts
            check_tp(reader, resolve_decoder_mode(kw.get("quant_mode", "auto"),
                                                  kw.get("smooth_scales")), tp)
    # a given pool's engine has joined its group already
    procs, rendezvous, own_group = [], None, own_pool and not dist.is_initialized()
    if own_group and "RANK" not in os.environ:
        # this process is rank 0: spawn the others, then join the group
        rendezvous = tempfile.mkdtemp(prefix="mgt_serve_")
        init = Path(rendezvous, "rendezvous").as_uri()
        ctx = mp.get_context("spawn")
        follower_kw = dict(kw, **{k: server_kw[k] for k in ("batch_window_s", "continuous",
                                                             "max_batch", "park_idle")})
        procs = [ctx.Process(target=_follower_main, daemon=True,
                             args=(r, tp, init, timeout_s, (model_path, llm_path), follower_kw))
                 for r in range(1, tp)]
        for p in procs:
            p.start()
        init_tp(tp, device, init_method=init, rank=0, timeout_s=timeout_s)
    elif own_group:  # torchrun
        init_tp(tp, device, timeout_s=timeout_s)
    ranks = None
    try:
        if own_pool:
            pool = SessionPool(model_path, llm_path, tp=tp,
                               paged_pool_pages=kw.pop("paged_pages"), **kw)
        ctl = Controller(pool, timeout_s)
        if not ctl.leader:  # rank 0's batcher makes this rank's (a replicated "new")
            try:
                ctl.follow()
            finally:
                pool._ctl = None
                if own_pool:
                    pool.close()
                if own_group:
                    dist.destroy_process_group()
            return None
        ranks = _TPRanks(ctl, procs, rendezvous, own_group)
        httpd = _serve_pool(pool, **server_kw)
        httpd.ranks = ranks
        return httpd
    except BaseException:
        if ranks is not None:
            ranks.close()
        else:
            for p in procs:
                p.kill()
            if own_group and dist.is_initialized():
                dist.destroy_process_group()
            if rendezvous:
                shutil.rmtree(rendezvous, ignore_errors=True)
        raise


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
    ap.add_argument("--ctx-shift", action="store_true",
                    help="when a session fills its context, drop its oldest turns after the "
                    "system prompt and image and slide its KV cache instead of stopping")
    ap.add_argument("--smooth-scales", default=None, metavar="NPZ",
                    help="smooth-quant scales of minigpt4_tpu_torch.quality (--save-scales), "
                    "folded into the decoder's w8a8 weights (auto resolves to w8a8)")
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching: generations join one running group of "
                    "--max-batch lanes at chunk boundaries instead of waiting for it to drain "
                    "(takes precedence over --batch-window-ms)")
    ap.add_argument("--max-batch", type=int, default=8,
                    help="lanes of the --continuous group (dense: one stacked cache of this "
                    "many sessions; paged: page-table rows)")
    ap.add_argument("--park-idle", action="store_true",
                    help="between turns, move each session's KV cache to host memory, trimmed "
                    "to its consumed prefix; the next request puts it back")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="turn off the radix prefix cache (every session then prefills the "
                    "system prompt, and every OpenAI request its whole transcript)")
    ap.add_argument("--prefix-cache-mb", type=int, default=512, metavar="MB",
                    help="host memory for the radix prefix cache (least recently used "
                    "entries go first)")
    ap.add_argument("--speculative-k", type=int, default=0,
                    help="speculative decoding verify width, up to 32 (0 = off): n-gram "
                    "drafted, block-verified; greedy output is token-identical, sampled "
                    "output runs speculative sampling")
    ap.add_argument("--draft-llm", default=None, metavar="PATH",
                    help="a smaller llama file of the same tokenizer that drafts greedy "
                    "single-session decode")
    ap.add_argument("--draft-head", default=None, metavar="PATH",
                    help="a draft-head artifact (train/draft.py) that drafts greedy "
                    "single-session decode")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel ranks, one process each (spawned here, or one per "
                    "torchrun process); rank 0 serves HTTP")
    args = ap.parse_args(argv)
    try:
        httpd = start_server(args.model_path, args.llm_model_path, args.host, args.port,
                             session_ctx=args.session_ctx, n_ctx=args.n_ctx,
                             batch_window_s=args.batch_window_ms / 1e3,
                             paged_pages=args.paged_pages or None, device=args.device,
                             quant_mode=args.quant_mode,
                             cache_dtype=None if args.cache_dtype == "auto" else args.cache_dtype,
                             smooth_scales=args.smooth_scales,
                             context_shift=args.ctx_shift, continuous=args.continuous,
                             max_batch=args.max_batch, park_idle=args.park_idle,
                             prefix_cache=not args.no_prefix_cache,
                             prefix_cache_mb=args.prefix_cache_mb,
                             speculative_k=args.speculative_k, draft_llm_path=args.draft_llm,
                             draft_head_path=args.draft_head, tp=args.tp)
    except ValueError as e:  # a refused configuration (tp placement, knobs)
        ap.error(str(e))
    if httpd is None:  # a follower rank under torchrun: rank 0 closed the server
        return
    print(f"serving on http://{args.host}:{httpd.server_address[1]}", flush=True)
    if args.tp == 1:
        httpd.serve_forever()
        return
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(0))  # a terminated server stops its ranks
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()


if __name__ == "__main__":
    main()
