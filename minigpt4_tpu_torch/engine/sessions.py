"""Concurrent chat sessions over one loaded model (the serving layer).

Counterpart of ``minigpt4_tpu/engine/sessions.py``.  The reference holds
one global cursor (minigpt4.cpp:2521); here the model weights are loaded
once and each :class:`ChatSession` owns a :class:`~.engine.DecodeState`
(KV cache of ``session_ctx`` positions, cursor, pending logits, sampling
generator) on which the engine's operations act.

  * A lock serializes device work (prefill, decode chunks, group joins and
    detaches); host work (tokenizing, detokenizing, EOS scans) interleaves.
  * :meth:`SessionPool.generate_batch_stream` decodes several prepared
    sessions together (window batching): every decode step reads the
    weights once for all lanes.  With a page pool (``paged_pool_pages``)
    each lane's consumed prefix is copied into 128-position pages of one
    shared pool (``engine/paged.py``) and decoded through the paged
    flash-decode kernel; otherwise, or when the pool cannot take the whole
    group, the lanes' caches stack into one dense group cache.
  * :class:`ContinuousBatcher` runs one group of ``max_batch`` lanes for
    good: requests join at chunk boundaries and leave when they finish,
    over the page pool (a dry pool preempts the youngest lane) or over one
    stacked cache allocated once.
  * A session can be parked (:meth:`ChatSession.park`): its cache waits in
    pageable host memory between turns (``engine/hostcopy.py``); every
    operation puts it back first, and a paged group admits it straight from
    the host copy.
  * The radix prefix cache keeps computed prefixes (KV rows and pending
    logits, in pageable host memory, keyed by the token ids fed from
    position 0): from the second session on, the system prompt installs its
    rows instead of prefilling them, and a replayed conversation installs
    all but its new turn.  Only exact hits install (the state a capture
    left after the same template pieces), so a hit gives the bits of the
    prefill it replaces.

On a CUDA engine at tp = 1 a session's own steps (prefill, single steps,
decode chunks, speculative and drafted dispatches) replay the engine's
graphs shared by every session of ``session_ctx`` positions, over its
resident cache (``MiniGPT4Engine._resident_of``: a step first copies the
session's buffer in whole, so the graphs do not grow with the sessions),
and the paged group's and the batcher's steps replay captured CUDA graphs
(``engine/graphs.py``): per lane count and chunk length, one for
all-greedy groups and one for every other mix of configs (the traced
thresholds of ``device_sampling.lane_rows``), one more where a lane carries
a logit bias, one where a lane carries a residual ban, and the verify
passes' dispatches (greedy and sampled, per pass count).  The batcher's lane
count is fixed, so it needs two graphs for its plain chunks;
:meth:`SessionPool.warmup` and :meth:`ContinuousBatcher.warmup` capture them
ahead of time, and the greedy verify dispatch of the first speculative step
with ``speculative_k`` > 1.  The dense window group, whose stacked cache is
made anew per group, runs eagerly.

With a tensor-parallel engine (``tp=N``, one process per rank, every rank
running the same calls) the lane caches, the batcher's slots and the page
pool hold the rank's heads (``parallel/spmd.py``), a parked session this
rank's shard; lanes, page tables and cursors are the same on every rank,
and every step runs eagerly.  The prefix cache is off there, as the JAX
package's is under a mesh.  Where rank 0 alone takes requests (the HTTP
server), a ``parallel.controller.Controller`` replays each device-touching
call of a pool, its sessions and its batcher (the methods marked
``replicated``) on the other ranks, in rank 0's order.

With an engine of ``context_shift=True`` a session's prefill and its own
decode shift its context where the JAX ``SessionPool`` does (the engine's
operations on the session's state, and before each mirostat token); a
window group leaves out a session without room for a chunk, as JAX's, and a
batcher lane that reaches the end detaches, shifts and rejoins.

With an engine of ``speculative_k`` > 1 a session's stream speculates
(``MiniGPT4Engine.generate``, with its drafter where it has one), and both
batchers run batched verify passes: every lane drafts from its own n-gram
history (``hist``, on the device, kept across steps), all-greedy groups
verify by argmax (plain greedy's ids) and any other group by speculative
sampling, each lane carrying its residual ban between steps.  A
:class:`_SpecGovernor` demotes a group to plain chunks while its tokens per
lane-pass stay below break-even (``metrics["spec_demotions"]``), and
probes again after a cooldown.  The batched verify steps replay captured
graphs where the group's plain chunks do (the dense window group runs
eagerly).  Lane caches and the page pool hold the engine's cache type
(``MiniGPT4Engine.cache_dtype``).
"""

from __future__ import annotations

import dataclasses
import queue
import sys
import threading
import time
from collections import OrderedDict, deque

import numpy as np
import torch

from ..models import llama as llama_mod
from .device_sampling import lane_rows
from .engine import (DECODE_CHUNK, EOS_SUFFIX, EOS_TOKEN_SUFFIX, DecodeState, MiniGPT4Engine,
                     _fit_passes, _lane_hist, _SpecGovernor)
from .graphs import StepGraphs
from .hostcopy import copy_from_host_, host_copy
from .paged import PagedKVPool, PoolExhausted
from .sampling import Sampler, SamplingParams
from ..parallel.controller import _Discard, replicated, replicated_stream


class ChatSession:
    """One conversation: owns a decode state and a host sampler; shares the
    model of its pool."""

    def __init__(self, pool: "SessionPool", session_id: int, seed: int):
        self._pool = pool
        self.session_id = session_id
        self.state = pool.engine.new_state(pool.session_ctx, seed)
        self.sampler = Sampler(seed)
        self.embedding: np.ndarray | None = None
        self.is_image_chat = False

    @property
    def _ctl(self):
        return self._pool._ctl

    @property
    def n_past(self) -> int:
        return self.state.n_past

    @property
    def last_logits(self) -> np.ndarray | None:
        """Host copy of the pending logits."""
        lg = self.state.logits
        return None if lg is None else lg.float().cpu().numpy()

    @replicated
    def encode_image(self, pixels: np.ndarray) -> np.ndarray:
        emb = self._pool.encode_image(pixels)
        self.embedding = emb
        return emb

    @replicated
    def upload_image(self, pixels: np.ndarray) -> None:
        self.reset()
        self._pool.system_prompt(self)
        self.encode_image(pixels)
        self.is_image_chat = True

    @replicated
    def ask(self, question: str) -> None:
        if self.is_image_chat and self.embedding is not None:
            self._pool.begin_chat_image(self, self.embedding, question)
            self.is_image_chat = False
        else:
            self._pool.begin_chat(self, question)

    def generate(self, limit: int = 256, params: SamplingParams | None = None):
        yield from self._pool.generate(self, limit, params or SamplingParams())

    @replicated
    def reset(self) -> None:
        self.state.reset()
        self.is_image_chat = False
        self.embedding = None

    @replicated
    def park(self) -> None:
        """Move this session's KV cache to host memory, trimmed to the
        consumed prefix, while the user thinks (:meth:`DecodeState.park`).
        Every operation of the pool puts it back first; a paged group admits
        it from the host copy.  ``serve.py --park-idle`` parks after each
        turn."""
        with self._pool._lock:
            self.state.park()

    @replicated
    def reseed(self, seed: int) -> None:
        """Reseed both samplers: the host chain and the device generator (a
        seeded request)."""
        self.sampler.reset(seed)
        self.state.generator.manual_seed(seed)

    @replicated
    def close(self) -> None:
        self._pool._release(self)


def _consume_lane_tokens(lane: dict, token_ids, tokenizer, bump):
    """Advance one lane's host bookkeeping over freshly evaluated token ids.

    Mutates ``lane`` (keys: session, limit, chat, emitted, ends) and the
    session's token history; returns ``(deliver, finished)``: the tokens to
    send to the client and whether the lane hit EOS or its limit (the
    reference's EOS rules, minigpt4.cpp:2764-2782).  Shared by the window
    groups and the continuous batcher."""
    deliver: list[str] = []
    for tid in token_ids:
        token = tokenizer.id_to_str(int(tid))
        lane["chat"] += token
        lane["emitted"] += 1
        lane["ends"] += 1  # this token was evaluated
        lane["session"].state.tokens.append(int(tid))
        bump()
        if token == EOS_TOKEN_SUFFIX:
            if lane["emitted"] >= lane["limit"]:
                return deliver, True
            continue
        if lane["chat"].endswith(EOS_SUFFIX):
            return deliver, True
        deliver.append(token)
        if lane["emitted"] >= lane["limit"]:
            return deliver, True
    return deliver, False


def _detach_lane_state(st: DecodeState, ends: int, pos_now: int, cache: dict | None,
                       logits_row: torch.Tensor | None) -> None:
    """Return a lane's state to its session, rolling back overshoot: cursor
    and token history truncate to the consumed prefix; a rolled-back lane's
    pending logits belong to the overshoot and are dropped (the next
    prefill installs fresh ones)."""
    st.cache = cache
    st.n_past = ends
    del st.tokens[ends:]
    st.logits = logits_row if ends == pos_now else None
    # the drafter's rows past ``ends`` belong to the rolled-back continuation
    st.draft_past = min(st.draft_past, ends)


def _put_hist(hist: torch.Tensor, pos: list[int], lane_tokens: list) -> None:
    """Write each lane's plain-chunk tokens into ``hist`` from its cursor, in
    place, dropping what falls past the context (a finished lane's
    overshoot), as JAX's scatter drops it: a demoted step must leave no gap
    below a cursor that would starve the drafts when speculation resumes."""
    c = hist.shape[1]
    ii, jj, vv = [], [], []
    for i, (p, toks) in enumerate(zip(pos, lane_tokens)):
        for j, t in enumerate(toks):
            if p + j < c:
                ii.append(i)
                jj.append(p + j)
                vv.append(int(t))
    if ii:
        hist[torch.tensor(ii).to(hist.device), torch.tensor(jj).to(hist.device)] = (
            torch.tensor(vv, dtype=hist.dtype).to(hist.device))


class SessionPool:
    """One loaded engine and the decode states of its sessions.

    ``prefix_cache`` / ``prefix_cache_mb``: the radix prefix cache and its
    host-memory budget (JAX's defaults: on, 512 MB); off under tp.
    ``engine``: a loaded engine to serve instead of loading the files (a
    pool of the same process may share it; :meth:`close` closes it)."""

    def __init__(self, model_path, llm_path, session_ctx: int = 512, seed: int = 1337,
                 paged_pool_pages: int | None = None, prefix_cache: bool = True,
                 prefix_cache_mb: int = 512, engine: MiniGPT4Engine | None = None,
                 **engine_kwargs):
        self.engine = engine or MiniGPT4Engine(model_path, llm_path, seed=seed, **engine_kwargs)
        self.session_ctx = session_ctx
        self.seed = seed
        self._lock = threading.Lock()
        self._ctl = None  # the tp controller that replicates this pool's calls, if any
        self._metrics_lock = threading.Lock()  # counters move across streams
        self._rate_events: deque[tuple[float, int]] = deque(maxlen=4096)
        self._next_id = 0
        self._sessions: dict[int, ChatSession] = {}
        self.metrics = {"sessions_created": 0, "images_encoded": 0,
                        "tokens_prefilled": 0, "tokens_generated": 0,
                        "prefix_cache_hits": 0, "prefix_cache_misses": 0,
                        "spec_demotions": 0}
        self._session_cfg = dataclasses.replace(self.engine.cache_cfg, n_ctx=session_ctx)
        # the radix prefix cache: token ids fed from position 0 -> {"k", "v":
        # host bits of rows [0, n), "logits": host [V], "bytes"}, in LRU order
        self.prefix_cache = bool(prefix_cache) and self.engine.tp == 1
        self.prefix_cache_mb = int(prefix_cache_mb)
        self._prefix_cache: OrderedDict[tuple[int, ...], dict] = OrderedDict()
        self._prefix_bytes = 0
        # the shared KV page pool: a batched group then holds device memory
        # for the positions its lanes consumed, not B x session_ctx
        self.paged_pool = None
        self._paged_graphs: StepGraphs | None = None  # the captured steps of paged_pool
        if paged_pool_pages:
            self.paged_pool = self._new_paged_pool(paged_pool_pages)

    def _new_paged_pool(self, n_pages: int) -> PagedKVPool:
        return PagedKVPool(self._session_cfg, n_pages, self.session_ctx,
                           self.engine.cache_dtype, self.engine.device)

    def _bump(self, name: str, by: int = 1) -> None:
        with self._metrics_lock:
            self.metrics[name] += by
            if name == "tokens_generated":
                self._rate_events.append((time.monotonic(), by))

    def generation_rate(self, window_s: float = 30.0) -> float:
        """Aggregate decode tok/s over the trailing window (/v1/health)."""
        now = time.monotonic()
        with self._metrics_lock:
            while self._rate_events and self._rate_events[0][0] < now - window_s:
                self._rate_events.popleft()
            if not self._rate_events:
                return 0.0
            total = sum(by for _, by in self._rate_events)
            span = max(now - self._rate_events[0][0], 1e-3)
        return total / span

    # -- session lifecycle --
    @replicated
    def new_session(self) -> ChatSession:
        with self._lock:
            sid = self._next_id
            self._next_id += 1
            s = ChatSession(self, sid, self.seed + sid)
            self._sessions[sid] = s
            self.metrics["sessions_created"] += 1
            return s

    def _release(self, s: ChatSession) -> None:
        self._sessions.pop(s.session_id, None)

    # -- device operations, under the lock --
    @replicated
    def encode_image(self, pixels: np.ndarray) -> np.ndarray:
        with self._lock:
            self.metrics["images_encoded"] += 1
            return self.engine.encode_image(pixels)

    def _prefill(self, s: ChatSession, kind: str, x) -> None:
        """One piece, ("ids", token ids) or ("rows", embedding rows), into
        the session under the lock (a parked session is put back first)."""
        with self._lock:
            st = s.state
            st.ensure_device()
            n0 = st.n_past
            if kind == "ids":
                self.engine.add_tokens(x, st=st)
                self._bump("tokens_prefilled", len(x))
            else:
                self.engine.add_embedding(x, st=st)
                self._bump("tokens_prefilled", st.n_past - n0)

    @replicated
    def feed(self, s: ChatSession, pieces: list[tuple]) -> None:
        """Feed pieces of the engine's templates (``system_pieces``,
        ``chat_pieces``: ("text", str), ("rows", embedding), ("keep", None))
        or ("ids", token ids) to the session in order, as the engine's own
        templates feed them.  The longest leading run of pieces whose end
        state the radix cache holds installs instead of prefilling
        (:meth:`_radix_fast_forward`)."""
        tokenize = self.engine.tokenizer.tokenize
        pieces = [("ids", [int(t) for t in tokenize(x, add_bos=True)]) if kind == "text"
                  else (kind, x) for kind, x in pieces]
        with self._lock:
            s.state.ensure_device()
            served = self._radix_fast_forward(s.state, pieces)
        for kind, x in pieces[served:]:
            if kind == "keep":
                s.state.n_keep = s.state.n_past  # context-shift keep marker
            else:
                self._prefill(s, kind, x)

    def _add_tokens(self, s: ChatSession, tokens: list[int]) -> None:
        self.feed(s, [("ids", tokens)])

    # -- the radix prefix cache --
    @staticmethod
    def _pure(st: DecodeState) -> bool:
        """A state that is exactly the token ids fed from position 0 (no
        embedding rows, no rolled-back gap): the condition for matching and
        for capturing a prefix."""
        return st.n_past == len(st.tokens) and all(t >= 0 for t in st.tokens)

    def _exact(self, key: tuple) -> tuple | None:
        """(entry key, pending logits) where the cache holds the state after
        the ids ``key`` exactly: an entry of that key, or a longer entry that
        kept the pending logits of a pruned prefix of that length; else
        None."""
        if key in self._prefix_cache:
            return key, self._prefix_cache[key]["logits"]
        n = len(key)
        for other, ent in self._prefix_cache.items():
            logits = ent["logits_at"].get(n)
            if logits is not None and other[:n] == key:
                return other, logits
        return None

    def _radix_fast_forward(self, st: DecodeState, pieces: list[tuple]) -> int:
        """Install the longest leading run of ``pieces`` whose end state the
        radix cache holds exactly (:meth:`_exact`); returns the number of
        pieces served.  Caller holds the lock and has put the state on its
        device.

        The run's rows and pending logits are copied as bits into the
        state's own cache tensors, so what follows is computed from the very
        state its prefill would have left.  Unlike JAX's, a run that ends
        inside a longer entry (JAX's partial hit, which feeds the last token
        again) or past a shorter one (its extension, which prefills the
        rest in one piece) is not served: that prefill would feed other
        chunks than the uncached path, give other roundings, and at a near
        tie other ids.  Embedding rows end the run."""
        if not self.prefix_cache or not self._pure(st):
            return 0
        n0 = len(st.tokens)
        ends, ids = [], list(st.tokens)  # (pieces served, ids fed) after each ids piece
        for i, (kind, x) in enumerate(pieces):
            if kind == "rows":
                break
            if kind == "ids":
                ids += x
                ends.append((i + 1, tuple(ids)))
        for served, key in reversed(ends):
            # worth installing only past the computed prefix and one token
            if len(key) <= n0 + 1 or len(key) > st.n_ctx:
                continue
            hit = self._exact(key)
            if hit is None:
                continue
            entry_key, logits = hit
            ent = self._prefix_cache[entry_key]
            self._prefix_cache.move_to_end(entry_key)  # LRU touch
            n = len(key)
            for kv in ("k", "v"):
                copy_from_host_(llama_mod._bits(st.cache[kv])[:, :, :, :n], ent[kv][:, :, :, :n])
            st.n_past = n
            st.tokens = list(key)
            st.logits = logits.to(st.cache["k"].device, copy=True)
            pos = n0
            for kind, x in pieces[:served]:
                if kind == "ids":
                    pos += len(x)
                elif kind == "keep":
                    st.n_keep = pos
            self._bump("prefix_cache_hits")
            return served
        return 0

    @staticmethod
    def _same_rows(a: dict, b: dict, n: int) -> bool:
        return all(torch.equal(a[kv][:, :, :, :n], b[kv][:, :, :, :n]) for kv in ("k", "v"))

    def capture_prefix(self, s: ChatSession) -> bool:
        """Capture the session's state (KV rows, pending logits) into the
        radix cache, keyed by its token ids, in pageable host memory
        (``engine/hostcopy.py``), evicting the least recently used entries
        past ``prefix_cache_mb``.  Entries that are strict prefixes of the
        new key are pruned, their pending logits kept in the new entry
        (``logits_at``), so each stays an exact hit; a state a longer entry
        holds only keeps its logits there.  Either happens only where the
        rows are the same bits; otherwise both entries stay.  The OpenAI
        route calls this before decoding, so that the next request of the
        conversation prefills only its new turn.  False where nothing could
        be captured (cache off, a parked or batched state, embedding
        rows)."""
        if not self.prefix_cache:
            return False
        with self._lock:
            st = s.state
            if st.cache is None or st.logits is None or st.n_past == 0 or not self._pure(st):
                return False
            key = tuple(st.tokens)
            n = st.n_past
            hit = self._exact(key)
            if hit is not None:
                self._prefix_cache.move_to_end(hit[0])
                return True
            ent = {kv: host_copy(llama_mod._bits(st.cache[kv][:, :, :, :n])) for kv in ("k", "v")}
            ent["logits"] = host_copy(st.logits)
            for other, longer in self._prefix_cache.items():
                if len(other) > n and other[:n] == key and self._same_rows(longer, ent, n):
                    longer["logits_at"][n] = ent["logits"]
                    self._prefix_cache.move_to_end(other)
                    return True
            ent["bytes"] = ent["k"].nbytes + ent["v"].nbytes
            ent["logits_at"] = {}
            for other in [o for o in self._prefix_cache if len(o) < n and key[:len(o)] == o]:
                old = self._prefix_cache[other]
                if self._same_rows(old, ent, len(other)):
                    ent["logits_at"].update(old["logits_at"])
                    ent["logits_at"][len(other)] = old["logits"]
                    self._prefix_bytes -= self._prefix_cache.pop(other)["bytes"]
            self._prefix_cache[key] = ent
            self._prefix_bytes += ent["bytes"]
            self._bump("prefix_cache_misses")
            while (self._prefix_bytes > self.prefix_cache_mb * 1_000_000
                   and len(self._prefix_cache) > 1):
                old_key, old = self._prefix_cache.popitem(last=False)
                self._prefix_bytes -= old["bytes"]
                self._rehome(old_key, old)
        return True

    def _rehome(self, key: tuple, ent: dict) -> None:
        """Hand the pending logits an evicted entry kept for pruned prefixes
        to the most recently used entry that holds the same rows of that
        prefix: the system prompt outlives the transcript that pruned it."""
        for m, logits in ent["logits_at"].items():
            for other in reversed(self._prefix_cache):
                held = self._prefix_cache[other]
                if len(other) <= m or other[:m] != key[:m]:
                    continue
                if m not in held["logits_at"] and self._same_rows(held, ent, m):
                    held["logits_at"][m] = logits
                break

    def prefix_cache_stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._prefix_cache), "bytes": self._prefix_bytes}

    # -- chat protocol: the engine's templates, through the prefix cache --
    def system_prompt(self, s: ChatSession) -> None:
        """The system prompt, captured: every fresh session's system prompt
        installs from the cache from the second session on."""
        self.feed(s, self.engine.system_pieces())
        self.capture_prefix(s)

    def begin_chat_image(self, s: ChatSession, embedding: np.ndarray, q: str) -> None:
        self.feed(s, self.engine.chat_pieces(q, embedding))

    def begin_chat(self, s: ChatSession, q: str) -> None:
        self.feed(s, self.engine.chat_pieces(q))

    @replicated_stream
    def generate(self, s: ChatSession, limit: int, params: SamplingParams):
        """One session's stream: device-sampled chunks through the engine,
        or, for mirostat, the session's host sampler one token at a time.
        A parked session is put back on its device first."""
        with self._lock:
            s.state.ensure_device()
        if params.mirostat != 0:
            chat = ""
            for _ in range(limit):
                if self.engine.context_shift and s.n_past + 1 > s.state.n_ctx:
                    with self._lock:
                        self.engine.ctx_shift(s.state, 1)
                logits = s.last_logits
                if logits is None or s.n_past >= s.state.n_ctx:
                    return
                tid = s.sampler.sample(logits, params)
                token = self.engine.tokenizer.id_to_str(tid)
                self._add_tokens(s, [tid])
                self._bump("tokens_generated")
                chat += token
                if MiniGPT4Engine.contains_eos_token(token):
                    continue
                if MiniGPT4Engine.is_eos(chat):
                    break
                yield token
            return
        for token in self.engine.generate(limit, params, st=s.state, lock=self._lock):
            self._bump("tokens_generated")
            yield token

    def generate_batch(self, sessions: list[ChatSession], limit=256, params=None,
                       decode_chunk: int = 16, paged: bool = True) -> list[str]:
        """Non-streaming wrapper over :meth:`generate_batch_stream`."""
        out = [""] * len(sessions)
        for updates in self.generate_batch_stream(sessions, limit, params, decode_chunk, paged):
            for i, token in updates:
                out[i] += token
        return out

    @replicated_stream
    def generate_batch_stream(self, sessions: list[ChatSession],
                              limit: int | list[int] = 256,
                              params: SamplingParams | list[SamplingParams] | None = None,
                              decode_chunk: int = 16, paged: bool = True):
        """Decode several prepared sessions together: every decode step reads
        the weights once for all of them.

        Sessions may sit at different cursors.  Static batching: the group
        decodes until every session hit EOS or its limit; finished lanes ride
        along and their overshoot is rolled back when they detach.  Sessions
        without room for one decode chunk are left out (no updates); the
        group stops when an active lane runs out of context.  ``params`` may
        be a list, one per session: each lane samples under its own config
        in the same step (device sampling only, no mirostat).  With a page
        pool the group decodes paged when the pool can take it whole, and
        densely otherwise; ``paged=False`` decodes it densely regardless.
        Parked sessions join from their host copies (a session left out
        stays parked).

        With an engine of ``speculative_k`` > 1 each step runs batched verify
        passes instead (JAX's ``generate_batch_stream``): every lane drafts
        from its own history, an all-greedy group verifies by argmax (plain
        greedy's ids) and any other group by speculative sampling, each lane
        carrying its residual ban; a :class:`_SpecGovernor` demotes the group
        to plain chunks while speculation does not pay, counted in
        ``metrics["spec_demotions"]``.

        Yields, once per decode step, a list of (session index, token) in
        the order per-session generation would emit them."""
        n_all = len(sessions)
        if isinstance(params, (list, tuple)):
            if len(params) != n_all:
                raise ValueError(f"params list ({len(params)}) != sessions ({n_all})")
            plist_all = [p or SamplingParams() for p in params]
        else:
            plist_all = [params or SamplingParams()] * n_all
        if any(p.mirostat != 0 for p in plist_all):
            raise ValueError("generate_batch uses device sampling (no mirostat)")
        if any(s.state.logits is None for s in sessions):
            raise ValueError("every session needs a prepared prompt (ask/prefill)")
        limits_all = [limit] * n_all if isinstance(limit, int) else list(limit)
        act = [i for i, s in enumerate(sessions) if s.n_past + decode_chunk <= s.state.n_ctx]
        if not act:
            return
        batch = [sessions[i] for i in act]
        rows = lane_rows([plist_all[i] for i in act], self.engine.llm_cfg.n_vocab,
                         self.engine.device)
        if paged and self.paged_pool is not None:
            admitted = self._try_admit_paged(batch)
            if admitted is not None:
                lane_pages, pool = admitted
                yield from self._paged_batch_stream(act, batch, lane_pages, pool, limits_all,
                                                    rows, decode_chunk)
                return
        yield from self._dense_batch_stream(act, batch, limits_all, rows, decode_chunk)

    def _lanes(self, act, batch, limits_all) -> list[dict]:
        return [{"session": s, "limit": limits_all[act[i]], "chat": "", "emitted": 0,
                 "ends": s.n_past} for i, s in enumerate(batch)]

    def _decode(self, cache, logits, pos, rows, gens, decode_chunk, page_table=None,
                steps: StepGraphs | None = None, ban: list[int] | None = None):
        """One decode chunk of a group whose lanes draw from ``gens``,
        replaying ``steps``' graph where given; returns (token ids per lane,
        the final logits).  ``ban``: the lanes' residual bans (traced rows);
        where one is set the chunk excludes them at its first step (JAX's
        ``decode_loop_dyn_ban``, key "decode_ban"; without a ban its draws
        are the same, and it takes the plain key).  Caller holds the lock."""
        eng = self.engine
        ban0 = (torch.tensor(ban, dtype=torch.long).to(logits.device)
                if ban is not None and any(b >= 0 for b in ban) else None)
        with torch.no_grad():
            if steps is not None:
                tokens, logits = steps.decode_chunk(logits, pos, decode_chunk, gens, rows,
                                                    page_table, ban=ban0)
            else:
                tokens, logits = llama_mod.decode_loop(
                    eng.llm_params, cache, logits, pos, decode_chunk, gens, rows, eng.llm_cfg,
                    page_table=page_table, tp=eng.tp_group, ban0=ban0)
        return tokens.tolist(), logits

    def _paged_steps(self, pool: PagedKVPool) -> StepGraphs | None:
        """The captured steps over ``pool``'s page pools (made on first use,
        in the engine's graph memory pool), or None where the engine runs
        eagerly.  Caller holds the lock."""
        eng = self.engine
        if not eng.graphs_enabled:
            return None
        if self._paged_graphs is None or self._paged_graphs.cache["k"] is not pool.k:
            self._paged_graphs = StepGraphs(eng.llm_params, eng.llm_cfg,
                                            {"k": pool.k, "v": pool.v}, eng.device,
                                            eng.graph_pool)
        return self._paged_graphs

    def warmup(self, lanes=range(1, 9), decode_chunk: int = 16) -> dict:
        """Capture ahead of time the paged group's decode chunks that a
        server replays: at each lane count of ``lanes``, the all-greedy
        chunk and the traced one, which serves every other mix of configs
        without a logit bias, and with the engine's ``speculative_k`` > 1
        the greedy verify dispatch of a group's first speculative step (as
        the JAX engine's warmup compiles its greedy speculative loop).  The
        lanes' tables hold only the pool's trash page, so no page a lane
        owns is written.  Returns the seconds, the graphs of the paged group
        and the bytes of the engine's graph memory pool.  Refused where the
        group runs eagerly (no page pool, a CPU engine, tp > 1)."""
        eng = self.engine
        if self.paged_pool is None or not eng.graphs_enabled:
            raise RuntimeError("warmup captures the paged group's CUDA graphs: this pool "
                               f"has no page pool or runs eagerly (device {eng.device}, "
                               f"tp={eng.tp})")
        v = eng.llm_cfg.n_vocab
        t0 = time.perf_counter()
        with self._lock, torch.no_grad():
            pool = self._live_paged_pool()
            steps = self._paged_steps(pool)
            for b in lanes:
                table = torch.full((b, pool.maxp + 1), pool.trash_page, dtype=torch.int32,
                                   device=eng.device)
                logits = torch.zeros((b, v), dtype=torch.float32, device=eng.device)
                gens = [torch.Generator(device=eng.device) for _ in range(b)]
                for params in (SamplingParams(temp=0.0), SamplingParams()):
                    steps.decode_chunk(logits, 0, decode_chunk, gens,
                                       lane_rows([params] * b, v, eng.device), table,
                                       capture=True)
                self._warmup_spec(steps, logits, decode_chunk, table)
            torch.cuda.synchronize(eng.device)
        return {"warmup_s": time.perf_counter() - t0, "graphs": len(steps.graphs),
                "keys": list(steps.graphs), "pool_bytes": eng.graph_stats()["pool_bytes"]}

    def _warmup_spec(self, steps: StepGraphs, logits: torch.Tensor, decode_chunk: int,
                     table: torch.Tensor | None = None) -> None:
        """With ``speculative_k`` > 1, capture the greedy verify dispatch of
        a group's first speculative step (a fresh governor's pass count) at
        the lane count of ``logits``, from position 0, over empty histories
        (through ``table``, or the dense cache's first positions)."""
        k = self.engine.speculative_k
        if k <= 1:
            return
        passes = _SpecGovernor().passes_for(decode_chunk, k)
        if passes * k > self.session_ctx:
            return
        hist = torch.full((logits.shape[0], self.session_ctx), -1, dtype=torch.long,
                          device=logits.device)
        steps.spec_chunk(logits, 0, hist, passes, k, table, capture=True)

    def _dense_batch_stream(self, act, batch, limits_all, rows, decode_chunk):
        """The group's lane caches stacked on the batch axis."""
        n = len(batch)
        n_ctx = self.session_ctx
        with self._lock:
            for s in batch:
                s.state.ensure_device()  # a parked lane joins
            cache = {kv: torch.cat([s.state.cache[kv] for s in batch], dim=1)
                     for kv in ("k", "v")}
            logits = torch.stack([s.state.logits for s in batch])
            for s in batch:
                # the group cache is the live copy until detach
                s.state.cache = None
        lanes = self._lanes(act, batch, limits_all)
        pos_host = [s.n_past for s in batch]
        done = [False] * n
        bump = lambda: self._bump("tokens_generated")  # noqa: E731
        group = self._spec_group(batch, rows)
        try:
            while not all(done):
                max_pos = max(pos_host[i] for i in range(n) if not done[i])
                if max_pos + decode_chunk > n_ctx:
                    break  # an active lane is out of context: stop the group
                spec, span, n_passes = self._spec_plan(group, decode_chunk, max_pos, n_ctx)
                # a finished lane past the cache end writes onto its last
                # position (models/llama.forward): stop before that position
                # could hold the lane's history
                if any(done[i] and pos_host[i] + span > n_ctx
                       and lanes[i]["ends"] > n_ctx - span for i in range(n)):
                    break
                with self._lock:
                    lane_tokens, logits = self._group_step(
                        group, cache, logits, pos_host, [s.state.generator for s in batch],
                        decode_chunk, n_passes if spec else 0, done)
                pos_host = [p + len(t) for p, t in zip(pos_host, lane_tokens)]
                yield self._deliver(act, lanes, lane_tokens, done, bump)
        finally:
            self._end_spec_group(group)
            with self._lock:
                err = None
                for i, s in enumerate(batch):
                    try:
                        _detach_lane_state(s.state, lanes[i]["ends"], pos_host[i],
                                           {kv: cache[kv][:, i:i + 1].clone()
                                            for kv in ("k", "v")}, logits[i])
                        s.state.spec_ban = self._lane_ban(group, i, lanes[i], pos_host[i])
                    except Exception as e:
                        self._reset_lane_session(s.state)
                        err = err or e
                if err is not None:
                    raise err

    # -- batched speculation --
    def _spec_group(self, batch: list[ChatSession], rows) -> dict:
        """The speculative state of a window group: its rows, the lanes'
        histories (with speculation on), their residual bans (traced rows;
        host ints) and its governor."""
        states = [s.state for s in batch]
        use_spec = self.engine.speculative_k > 1
        return {"rows": rows, "gov": _SpecGovernor(),
                "hist": (_lane_hist(states, self.session_ctx, self.engine.device)
                         if use_spec else None),
                "ban": [st.spec_ban for st in states] if rows.traced is not None else None}

    def _spec_plan(self, group: dict, decode_chunk: int, max_pos: int,
                   n_ctx: int) -> tuple[bool, int, int]:
        """(speculate, positions the step may advance, verify passes) for the
        next step of a group whose furthest active lane is at ``max_pos``:
        passes scaled to the acceptance and halved toward the context end;
        a plain chunk where no speculative step fits or the governor
        demoted the group."""
        k = self.engine.speculative_k
        if k <= 1:
            return False, decode_chunk, 0
        gov = group["gov"]
        n_passes = _fit_passes(gov.passes_for(decode_chunk, k), max_pos, k, n_ctx, floor=2)
        if n_passes and gov.want_spec():
            return True, n_passes * k, n_passes
        return False, decode_chunk, 0

    def _group_step(self, group: dict, cache, logits, pos, gens, decode_chunk: int,
                    n_passes: int, done, page_table=None, steps: StepGraphs | None = None):
        """One step of a group: ``n_passes`` > 0 speculative verify passes,
        else a plain chunk (the banned chunk where a lane carries a ban),
        each replaying ``steps``' graph where given (JAX's ``paged_spec_loop``,
        ``paged_spec_loop_stoch`` and ``paged_decode_loop_dyn_ban`` over a
        page table, their dense twins without).  Updates the group's
        history, bans and governor; returns (token ids per lane, the final
        logits).  Caller holds the lock."""
        rows, eng = group["rows"], self.engine
        k = eng.speculative_k
        if n_passes:
            with torch.no_grad():
                if rows.traced is None:
                    if steps is not None:
                        out = steps.spec_chunk(logits, pos, group["hist"], n_passes, k,
                                               page_table)
                    else:
                        out = llama_mod.speculative_decode_loop(
                            eng.llm_params, cache, logits, pos, group["hist"], n_passes, k,
                            eng.llm_cfg, page_table=page_table, tp=eng.tp_group)
                    tokens, counts, logits, group["hist"] = out
                else:
                    ban_dev = torch.tensor(group["ban"], dtype=torch.long).to(eng.device)
                    if steps is not None:
                        out = steps.spec_chunk_stoch(logits, pos, group["hist"], ban_dev,
                                                     n_passes, k, gens, rows, page_table)
                    else:
                        out = llama_mod.stochastic_speculative_decode_loop(
                            eng.llm_params, cache, logits, pos, group["hist"], ban_dev, gens,
                            rows, n_passes, k, eng.llm_cfg, page_table=page_table,
                            tp=eng.tp_group)
                    tokens, counts, logits, group["hist"], ban_out = out
                    group["ban"] = ban_out.tolist()
            toks, cnts = tokens.tolist(), counts.tolist()
            lane_tokens = [[t for row, c in zip(tr, cr) for t in row[:c]]
                           for tr, cr in zip(toks, cnts)]
            act = [i for i in range(len(lane_tokens)) if not done[i]]
            group["gov"].observe(sum(len(lane_tokens[i]) for i in act), n_passes, len(act))
            return lane_tokens, logits
        lane_tokens, logits = self._decode(cache, logits, pos, rows, gens, decode_chunk,
                                           page_table, steps, group["ban"])
        if group["ban"] is not None:
            group["ban"] = [-1] * len(lane_tokens)
        if group["hist"] is not None:
            _put_hist(group["hist"], pos, lane_tokens)
        return lane_tokens, logits

    def _end_spec_group(self, group: dict) -> None:
        if group["gov"].demotions:
            self._bump("spec_demotions", group["gov"].demotions)

    @staticmethod
    def _lane_ban(group: dict, i: int, lane: dict, pos: int) -> int:
        """The residual ban lane ``i`` hands back to its session: its own
        where its pending logits survive the detach (nothing rolled back),
        else none."""
        ban = group["ban"]
        return ban[i] if ban is not None and lane["ends"] == pos else -1

    def _deliver(self, act, lanes, lane_tokens, done, bump) -> list[tuple[int, str]]:
        updates: list[tuple[int, str]] = []
        for i, lane in enumerate(lanes):
            if done[i]:
                continue
            deliver, done[i] = _consume_lane_tokens(lane, lane_tokens[i],
                                                    self.engine.tokenizer, bump)
            updates.extend((act[i], token) for token in deliver)
        return updates

    def _reset_lane_session(self, st: DecodeState) -> None:
        """Last-resort recovery of a lane whose state could not be read back:
        the conversation is gone, the session restarts empty."""
        try:
            st.cache = llama_mod.init_cache(self._session_cfg, 1, self.engine.cache_dtype,
                                            self.engine.device)
        except Exception:
            st.cache = None
        st.reset()

    def _live_paged_pool(self) -> PagedKVPool | None:
        """The usable page pool, rebuilding a retired (broken) one once every
        group's pages have drained out of it; None while the broken pool
        still holds pages or the rebuild fails.  Caller holds the lock."""
        pool = self.paged_pool
        if pool is None or not pool.broken:
            return pool
        if pool.allocated_pages:
            return None
        try:
            pool = self.paged_pool = self._new_paged_pool(pool.n_pages)
        except Exception:
            return None
        return pool

    def _try_admit_paged(self, batch: list[ChatSession]):
        """Copy every lane's consumed prefix into pool pages, all or nothing,
        a parked lane from its host copy (only its used rows cross to the
        card).  Returns (page ids per lane, the admitting pool), or None when
        the pool cannot take the whole group now (the group then decodes
        densely).  Lanes drop their dense caches and parked copies only after
        every lane was copied; a failure frees the group's pages and leaves
        every lane as it was."""
        with self._lock:
            pool = self._live_paged_pool()
            if pool is None:
                return None
            if sum(pool.pages_for(s.n_past) for s in batch) > pool.free_pages:
                return None
            lane_pages: list[list[int]] = []
            try:
                for s in batch:
                    st = s.state
                    lane_pages.append(pool.admit_host(st.parked, st.n_past) if st.parked is not None
                                      else pool.admit(st.cache, st.n_past))
            except Exception:
                for pages in lane_pages:
                    pool.free(pages)
                return None
            for s in batch:
                s.state.cache = s.state.parked = None  # the pool copy is the live one
            return lane_pages, pool

    def _paged_batch_stream(self, act, batch, lane_pages, pool, limits_all, rows,
                            decode_chunk):
        """Decode an admitted group over the page pool (the contract of
        :meth:`generate_batch_stream`).  Active lanes get pages one chunk
        ahead; finished lanes write their overshoot into the pool's trash
        page through the table's last slot, so no guard is needed for them.
        A dry pool ends the group early: the lanes detach and can continue
        in a later group.  ``pool`` is the object that admitted
        ``lane_pages``, never a re-read of ``self.paged_pool``."""
        n = len(batch)
        n_ctx = min(self.session_ctx, pool.capacity)
        with self._lock:
            # a lane admitted from its parked copy has its logits on the host
            logits = torch.stack([s.state.logits.to(self.engine.device) for s in batch])
        table = np.stack([pool.table_row(p) for p in lane_pages])
        table_dev = None  # uploaded once, and again after a lane grew
        lanes = self._lanes(act, batch, limits_all)
        pos_host = [s.n_past for s in batch]
        done = [False] * n
        bump = lambda: self._bump("tokens_generated")  # noqa: E731
        group = self._spec_group(batch, rows)
        try:
            while not all(done):
                max_pos = max(pos_host[i] for i in range(n) if not done[i])
                if max_pos + decode_chunk > n_ctx:
                    break
                spec, span, n_passes = self._spec_plan(group, decode_chunk, max_pos, n_ctx)
                with self._lock:
                    try:
                        for i in range(n):
                            if not done[i]:
                                grown = pool.extend(lane_pages[i], pos_host[i] + span)
                                if len(grown) != len(lane_pages[i]):
                                    lane_pages[i] = grown
                                    table[i] = pool.table_row(grown)
                                    table_dev = None
                    except PoolExhausted:
                        break  # pool dry: the lanes detach and resume later
                    if table_dev is None:
                        table_dev = torch.tensor(table, dtype=torch.int32).to(self.engine.device)
                    try:
                        lane_tokens, logits = self._group_step(
                            group, {"k": pool.k, "v": pool.v}, logits, pos_host,
                            [s.state.generator for s in batch], decode_chunk,
                            n_passes if spec else 0, done, table_dev, self._paged_steps(pool))
                    except Exception:
                        pool.broken = True  # the pool's contents are unknown now
                        raise
                pos_host = [p + len(t) for p, t in zip(pos_host, lane_tokens)]
                yield self._deliver(act, lanes, lane_tokens, done, bump)
        finally:
            self._end_spec_group(group)
            # every lane's pages go back into a private dense cache and the
            # pool, also when the consumer closed the stream early
            with self._lock:
                err = None
                for i, s in enumerate(batch):
                    try:
                        if pool.broken:
                            raise RuntimeError("paged pool retired mid-group")
                        dense = pool.evict(lane_pages[i], self.session_ctx)
                        _detach_lane_state(s.state, lanes[i]["ends"], pos_host[i], dense,
                                           logits[i])
                        s.state.spec_ban = self._lane_ban(group, i, lanes[i], pos_host[i])
                    except Exception as e:
                        try:
                            pool.free(lane_pages[i])
                        except ValueError:
                            pass  # evict freed them already
                        self._reset_lane_session(s.state)
                        err = err or e
                if err is not None:
                    raise err

    def close(self) -> None:
        self.engine.close()


IDLE = SamplingParams(temp=0.0)  # the rows of a batcher's free slots


class ContinuousBatcher:
    """Continuous (in-flight) batching, the JAX package's
    ``ContinuousBatcher``: up to ``max_batch`` generations share one decode
    group of fixed lane count, and a request joins at a chunk boundary
    instead of waiting for the running group to drain.

      * Dense mode (no page pool, or ``paged=False``): one stacked cache
        ``[L, max_batch, H, session_ctx, Dh]`` allocated once.  A join copies
        the session's cache into its slot in place (bits, no cast); a leave
        clones the slot back into a private cache and rolls back overshoot
        (:func:`_detach_lane_state`).  Idle slots decode at position 0 of
        their own slot, which the next join overwrites.
      * Paged mode (the pool's :class:`~.paged.PagedKVPool`): one page-table
        row per slot; a join copies the session's rows into fresh pages (a
        parked session from its host copy) and needs one growth page free
        per active lane; a leave gathers the pages back.  Idle rows hold only
        the trash page.  When the pool runs dry the youngest lane (by join
        order) is preempted: it detaches whole and rejoins once pages free,
        resuming its stream where it stopped.
      * A lane that reaches the context end leaves; under ``context_shift``
        it detaches, shifts its context and rejoins, so its stream goes on.

    Each lane samples under its own config in the same dispatch
    (``device_sampling.lane_rows``: all-greedy steps keep the static key,
    any other mix the traced one) and draws from its session's generator;
    an idle slot draws from a generator of the batcher's own, which nothing
    reads.  On a CUDA engine at tp = 1 the group's decode chunks replay
    captured CUDA graphs: the pool's paged steps, or steps over the stacked
    cache in the engine's graph pool, whose address never moves.  Two keys
    (all-greedy and traced) serve every plain step, and one per pass count
    the verify steps (greedy and sampled) and the banned chunk;
    :meth:`warmup` captures the two and the first greedy verify dispatch
    ahead of time.  Mirostat is refused (it samples on the host).  Over tp
    ranks the slots hold the rank's heads and every step runs eagerly; with
    a controlled pool (``parallel/controller.py``) rank 0's worker thread
    runs each round of admissions and one step as one replicated operation
    (:meth:`_cycle`), which every other rank's batcher, built alike and
    without a thread, applies in the same order.

    With an engine of ``speculative_k`` > 1 a step runs batched verify
    passes (JAX's speculative branch of ``_step``): each slot keeps its
    lane's history in a row of ``_hist`` (written at the join, kept through
    plain steps) and its residual ban in ``_ban`` (taken from the session at
    the join, handed back at the leave).  A step whose furthest lane has no
    room for the speculative span, or that the governor demoted, decodes a
    plain chunk; the governor starts afresh whenever the group drains.

    Requests enter through :meth:`submit`, which returns a queue of str
    tokens ending with ``_DONE`` (after an exception, where one occurred);
    a worker thread admits them and decodes.  No failure moves work to
    another path: a failed join, admission or step reaches the request's
    queue as an error."""

    _DONE = object()
    _STOP = object()

    def __init__(self, pool: SessionPool, max_batch: int = 8,
                 decode_chunk: int = DECODE_CHUNK, paged: bool | None = None):
        eng = pool.engine
        if paged and pool.paged_pool is None:
            raise ValueError("paged=True needs a pool with a page pool (paged_pool_pages)")
        self.pool = pool
        self.B = max_batch
        self.decode_chunk = decode_chunk
        self.paged = pool.paged_pool is not None if paged is None else paged
        dev = eng.device
        if self.paged:
            ppool = pool.paged_pool
            self._cache = None
            self._pages: list[list[int]] = [[] for _ in range(max_batch)]
            self._table = np.full((max_batch, ppool.maxp + 1), ppool.trash_page, np.int32)
            self._table_dev: torch.Tensor | None = None  # uploaded again after a change
        else:
            self._cache = llama_mod.init_cache(pool._session_cfg, max_batch, eng.cache_dtype,
                                               dev)
        self._dense_steps: StepGraphs | None = None
        self._logits = torch.zeros((max_batch, eng.llm_cfg.n_vocab), dtype=torch.float32,
                                   device=dev)
        # batched speculation: the slots' token histories, residual bans and
        # the group's governor
        self._hist = (torch.full((max_batch, pool.session_ctx), -1, dtype=torch.long, device=dev)
                      if eng.speculative_k > 1 else None)
        self._ban = [-1] * max_batch
        self._gov = _SpecGovernor()
        self._gov_reported = 0  # demotions already counted in the pool's metrics
        self._pos = [0] * max_batch
        self._idle_gens = [torch.Generator(device=dev).manual_seed(pool.seed ^ 0x00C0FFEE)
                           for _ in range(max_batch)]
        self._lanes: list[dict | None] = [None] * max_batch  # None: a free slot
        self._deferred: list[tuple] = []  # waiting for a slot or pages
        self._deferred_since: dict[int, float] = {}  # id(out) -> first deferral
        self._join_seq = 0
        self.joins = 0  # requests that joined while other lanes decoded
        self.preemptions = 0  # lanes preempted by a dry page pool
        self._q: queue.Queue = queue.Queue()
        self._outs: dict[int, queue.Queue] = {}  # request id -> its token queue (rank 0)
        self._next_rid = 0
        self._closed = False
        self._thread = None
        ctl = pool._ctl
        if ctl is not None and ctl.leader:
            ctl.register(self, "ContinuousBatcher", {"max_batch": max_batch,
                                                     "decode_chunk": decode_chunk,
                                                     "paged": paged})
        if ctl is None or ctl.leader:  # a follower's batcher runs rank 0's cycles
            self._thread = threading.Thread(target=self._run, daemon=True)
            self._thread.start()

    @property
    def _ctl(self):
        return self.pool._ctl

    # -- the interface of the serve layer's window batcher --
    def submit(self, session: ChatSession, limit: int, params: SamplingParams) -> queue.Queue:
        """The session must hold a prepared prompt.  Returns a queue of str
        tokens that ends with ``_DONE`` (after an exception, where one)."""
        out: queue.Queue = queue.Queue()
        if self._closed:
            out.put(RuntimeError("continuous batcher is closed"))
            out.put(self._DONE)
            return out
        self._q.put((session, limit, params, out))
        return out

    def close(self) -> None:
        """Stop the worker: active lanes detach (their sessions roll back to
        the consumed prefix), and every waiting client gets ``_DONE``."""
        self._closed = True
        self._q.put(self._STOP)
        if self._thread is not None:
            self._thread.join(timeout=60)

    def warmup(self) -> dict:
        """Capture the group's two decode chunks (all-greedy and traced
        rows), and with ``speculative_k`` > 1 its first greedy verify
        dispatch, ahead of time, before any lane joins: in paged mode through
        :meth:`SessionPool.warmup` at this lane count (idle rows write only
        the trash page), in dense mode over the stacked cache at position 0
        of every slot.  Returns the seconds, graphs and graph-pool bytes.
        Refused where the group runs eagerly (a CPU engine)."""
        eng = self.pool.engine
        if not eng.graphs_enabled:
            raise RuntimeError(f"warmup captures CUDA graphs: this engine runs eagerly "
                               f"(device {eng.device})")
        if self.paged:
            return self.pool.warmup(lanes=(self.B,), decode_chunk=self.decode_chunk)
        v = eng.llm_cfg.n_vocab
        t0 = time.perf_counter()
        with self.pool._lock, torch.no_grad():
            if any(lane is not None for lane in self._lanes):
                raise RuntimeError("warmup writes every slot: it runs before any lane joins")
            steps = self._steps()
            logits = torch.zeros((self.B, v), dtype=torch.float32, device=eng.device)
            gens = [torch.Generator(device=eng.device) for _ in range(self.B)]
            for params in (IDLE, SamplingParams()):
                steps.decode_chunk(logits, 0, self.decode_chunk, gens,
                                   lane_rows([params] * self.B, v, eng.device), capture=True)
            self.pool._warmup_spec(steps, logits, self.decode_chunk)
            torch.cuda.synchronize(eng.device)
        return {"warmup_s": time.perf_counter() - t0, "graphs": len(steps.graphs),
                "keys": list(steps.graphs), "pool_bytes": eng.graph_stats()["pool_bytes"]}

    # -- worker internals --
    def _steps(self) -> StepGraphs | None:
        """The captured steps of the group (None where it runs eagerly).
        Caller holds the pool's lock, so no other thread runs device work
        while a step captures (HTTP threads prefill, encode and park under
        it); the capture's ``thread_local`` mode (``graphs.py``) keeps a
        host read of another thread's pending logits outside the lock from
        invalidating it."""
        eng = self.pool.engine
        if not eng.graphs_enabled:
            return None
        if self.paged:
            return self.pool._paged_steps(self.pool.paged_pool)
        if self._dense_steps is None:
            self._dense_steps = StepGraphs(eng.llm_params, eng.llm_cfg, self._cache, eng.device,
                                           eng.graph_pool)
        return self._dense_steps

    def _n_active(self) -> int:
        return sum(lane is not None for lane in self._lanes)

    def _defer(self, item) -> None:
        self._deferred_since.setdefault(id(item[3]), time.monotonic())
        self._deferred.append(item)

    def _end(self, out, err: Exception | None = None) -> None:
        """End a request's stream (with ``err`` first, where given)."""
        if err is not None:
            out.put(err)
        out.put(self._DONE)
        self._deferred_since.pop(id(out), None)

    def _run(self) -> None:
        while True:
            # admission: block while idle, take what is queued while busy
            items = [self._q.get()] if self._n_active() == 0 and not self._deferred else []
            while True:
                try:
                    items.append(self._q.get_nowait())
                except queue.Empty:
                    break
            stop = any(it is self._STOP for it in items)
            if stop:
                rest = items[items.index(self._STOP) + 1:]
                items = items[:items.index(self._STOP)]
            new = []
            for session, limit, params, out in items:
                self._next_rid += 1
                self._outs[self._next_rid] = out
                new.append((session, limit, params, self._next_rid))
            try:
                self._cycle(new, stop)
            except Exception as e:  # the ranks diverged: every client hears of it
                print(f"[continuous] {type(e).__name__}: {e}", file=sys.stderr)
                for out in list(self._outs.values()) + [lane["out"] for lane in self._lanes
                                                        if lane is not None]:
                    out.put(e)
                    out.put(self._DONE)
                self._outs.clear()
                return
            if stop:
                for it in rest:
                    if it is not self._STOP:
                        it[3].put(self._DONE)
                while True:
                    try:
                        it = self._q.get_nowait()
                    except queue.Empty:
                        break
                    if it is not self._STOP:
                        it[3].put(self._DONE)
                return

    @replicated
    def _cycle(self, items: list, stop: bool) -> list | None:
        """One round of the worker: admit ``items`` ((session, limit,
        params, request id), in order), re-admit the deferred oldest first,
        then decode one step; with ``stop`` detach every lane and end every
        waiting stream instead.  Returns the step's token ids per slot (what
        the tp ranks agree on), None where no step ran."""
        for session, limit, params, rid in items:
            self._try_admit((session, limit, params, self._outs.pop(rid, None) or _Discard()))
        if stop:
            for i, lane in enumerate(self._lanes):
                if lane is not None:
                    self._abort_lane(i, None)
            for it in self._deferred:
                it[3].put(self._DONE)
            self._deferred = []
            self._deferred_since.clear()
            return None
        if self._deferred:
            # waiters join the moment a slot or pages free, oldest first;
            # the ones still blocked defer again
            deferred, self._deferred = self._deferred, []
            deferred.sort(key=lambda it: self._deferred_since.get(id(it[3]), 0.0))
            for it in deferred:
                self._try_admit(it)
        if self._n_active() == 0:
            # the group drained: the next one starts a fresh estimate
            self._gov = _SpecGovernor()
            self._gov_reported = 0
            return None
        try:
            return self._step()
        except Exception as e:  # a device failure: every lane ends with it
            print(f"[continuous] step failed: {type(e).__name__}: {e}", file=sys.stderr)
            for i, lane in enumerate(self._lanes):
                if lane is not None:
                    self._abort_lane(i, e)
            return None

    def _try_admit(self, item) -> None:
        """Admit, defer or refuse one request; never raises (a failure
        reaches the request's own queue: an exception here would end the
        worker and hang every client).  A fifth element (a lane dict) marks
        a preempted or shifted lane rejoining: its chat, emitted count and
        limit carry over, so EOS and limits act as if it never left."""
        session, limit, params, out = item[:4]
        resume = item[4] if len(item) > 4 else None
        st = session.state
        try:
            if params.mirostat != 0 or st.logits is None:
                self._end(out, ValueError("continuous batching needs a prepared prompt and "
                                          "device sampling (no mirostat)"))
                return
            try:
                slot = self._lanes.index(None)
            except ValueError:
                self._defer(item)
                return
            eng = self.pool.engine
            if st.n_past + self.decode_chunk > st.n_ctx:
                # no room for one chunk: under context shift slide the cache
                # down first, else the stream is empty
                if eng.context_shift:
                    with self.pool._lock:
                        st.ensure_device()
                        eng.ctx_shift(st, self.decode_chunk)
                if st.n_past + self.decode_chunk > st.n_ctx:
                    self._end(out)
                    return
            with self.pool._lock:
                if self.paged:
                    ppool = self.pool._live_paged_pool()
                    # one growth page per active lane stays free, so that a
                    # join does not starve the running lanes at once
                    if ppool is None or (ppool.free_pages
                                         < ppool.pages_for(st.n_past) + self._n_active()):
                        self._defer(item)
                        return
                    pages = (ppool.admit_host(st.parked, st.n_past) if st.parked is not None
                             else ppool.admit(st.cache, st.n_past))
                    try:
                        self._join_lane(slot, st)
                    except Exception:
                        ppool.free(pages)  # the slot never activated: nothing else frees them
                        raise
                    self._pages[slot] = pages
                    self._table[slot] = ppool.table_row(pages)
                    self._table_dev = None
                    st.parked = None
                else:
                    st.ensure_device()
                    self._join_lane(slot, st)
                st.cache = None  # the slot or the pages are the live copy now
            self._deferred_since.pop(id(out), None)
            self._pos[slot] = st.n_past
            self._ban[slot] = st.spec_ban
            lane = {"session": session, "limit": limit, "out": out, "chat": "", "emitted": 0,
                    "ends": st.n_past, "params": params}
            if resume is not None:
                lane.update(chat=resume["chat"], emitted=resume["emitted"],
                            limit=resume["limit"])
            elif self._n_active():
                self.joins += 1
            self._join_seq += 1
            lane["seq"] = self._join_seq
            self._lanes[slot] = lane
        except Exception as e:
            self._end(out, e)

    def _join_lane(self, slot: int, st: DecodeState) -> None:
        """Copy a joining state's pending logits into its slot's row and, in
        dense mode, its cache into the slot, in place and as bits: the
        session's cache and the stacked one share the engine's cache type
        and ``session_ctx``, so nothing is cast.  Caller holds the lock."""
        if not self.paged:
            for kv in ("k", "v"):
                src, dst = st.cache[kv], self._cache[kv]
                if src.dtype != dst.dtype or src.shape[2:] != dst.shape[2:]:
                    raise ValueError(f"session cache {src.dtype} {tuple(src.shape)} does not fit "
                                     f"a slot of {dst.dtype} {tuple(dst.shape)}")
                llama_mod._bits(dst)[:, slot].copy_(llama_mod._bits(src)[:, 0])
        self._logits[slot].copy_(st.logits)
        if self._hist is not None:
            self._hist[slot].copy_(_lane_hist([st], self._hist.shape[1], self._hist.device)[0])

    def _leave(self, slot: int, lane: dict, with_logits: bool) -> bool:
        """Give a lane's cache back to its session (a clone of its slot, or
        its pages gathered), rolling back overshoot, and free the slot's
        pages.  On failure the session resets (its cache lived only in the
        group).  Returns whether the detach worked."""
        st = lane["session"].state
        logits_row = self._logits[slot].clone() if with_logits else None
        with self.pool._lock:
            try:
                if self.paged:
                    ppool = self.pool.paged_pool
                    pages, self._pages[slot] = self._pages[slot], []
                    self._table[slot] = ppool.trash_page
                    self._table_dev = None
                    if ppool.broken:
                        ppool.free(pages)
                        raise RuntimeError("paged pool retired mid-flight")
                    cache = ppool.evict(pages, self.pool.session_ctx)
                else:
                    cache = {kv: self._cache[kv][:, slot:slot + 1].clone() for kv in ("k", "v")}
                _detach_lane_state(st, lane["ends"], self._pos[slot], cache, logits_row)
                # the lane's ban survives where its pending logits do
                st.spec_ban = (self._ban[slot] if with_logits and lane["ends"] == self._pos[slot]
                               else -1)
                return True
            except Exception:
                self.pool._reset_lane_session(st)
                return False
            finally:
                self._lanes[slot] = None
                self._pos[slot] = 0
                self._ban[slot] = -1

    def _abort_lane(self, slot: int, err: Exception | None) -> None:
        """Detach a lane at shutdown or after a failed step, leaving its
        session coherent (``len(tokens) == n_past``), and end its stream."""
        lane = self._lanes[slot]
        self._leave(slot, lane, with_logits=False)
        self._end(lane["out"], err)

    def _finalize(self, slot: int, resume: bool = False) -> bool:
        """Detach a lane that finished (or, with ``resume``, one that leaves
        to rejoin later: its stream stays open).  Returns False where the
        detach failed and the session had to reset; the client then hears
        so."""
        lane = self._lanes[slot]
        ok = self._leave(slot, lane, with_logits=True)
        if not resume:
            self._end(lane["out"], None if ok else RuntimeError(
                "lane detach failed; session state reset"))
        return ok

    def _preempt_one(self) -> bool:
        """Preempt the youngest lane to fund the others: it detaches whole
        and waits as a deferred resume item.  False when fewer than two
        lanes are active."""
        act = [i for i, lane in enumerate(self._lanes) if lane is not None]
        if len(act) <= 1:
            return False
        victim = max(act, key=lambda i: self._lanes[i]["seq"])
        lane = self._lanes[victim]
        self.preemptions += 1
        if self._finalize(victim, resume=True):
            self._defer((lane["session"], lane["limit"], lane["params"], lane["out"], lane))
        else:
            self._end(lane["out"], RuntimeError("paged lane preemption failed; session reset"))
        return True

    def _spec_plan(self, max_pos: int) -> tuple[bool, int, int]:
        """(speculate, positions the step may advance, verify passes): the
        window group's plan (``SessionPool._spec_plan``) under this group's
        governor."""
        return self.pool._spec_plan({"gov": self._gov}, self.decode_chunk, max_pos,
                                    self.pool.session_ctx)

    def _step(self) -> list | None:
        eng = self.pool.engine
        chunk = self.decode_chunk
        # a lane without room for a chunk leaves before the dispatch; under
        # context shift an unfinished one detaches, shifts and rejoins
        for i, lane in enumerate(self._lanes):
            if lane is None or self._pos[i] + chunk <= self.pool.session_ctx:
                continue
            if not (eng.context_shift and lane["emitted"] < lane["limit"]):
                self._finalize(i)
            elif not self._finalize(i, resume=True):
                self._end(lane["out"], RuntimeError("context-shift detach failed; session reset"))
            else:
                with self.pool._lock:
                    dropped = eng.ctx_shift(lane["session"].state, chunk)
                if dropped > 0:
                    self._defer((lane["session"], lane["limit"], lane["params"], lane["out"],
                                 lane))
                else:  # nothing shiftable: the keep prefix fills the context
                    self._end(lane["out"])
        if self._n_active() == 0:
            return None
        # a lane near the context end demotes the step to a plain chunk, and
        # so does the governor; speculation resumes after
        spec, span, n_passes = self._spec_plan(
            max(p for p, lane in zip(self._pos, self._lanes) if lane is not None))
        if self.paged:
            # every lane gets pages one step ahead; a dry pool preempts the
            # youngest lane and tries again; a lone lane it cannot grow ends
            while True:
                try:
                    with self.pool._lock:
                        ppool = self.pool.paged_pool
                        for i, lane in enumerate(self._lanes):
                            if lane is None:
                                continue
                            grown = ppool.extend(self._pages[i], self._pos[i] + span)
                            if len(grown) != len(self._pages[i]):
                                self._pages[i] = grown
                                self._table[i] = ppool.table_row(grown)
                                self._table_dev = None
                    break
                except PoolExhausted:
                    if not self._preempt_one():
                        self._finalize(next(i for i, lane in enumerate(self._lanes)
                                            if lane is not None))
                        return None
        act = [i for i, lane in enumerate(self._lanes) if lane is not None]
        rows = lane_rows([lane["params"] if lane is not None else IDLE for lane in self._lanes],
                         eng.llm_cfg.n_vocab, eng.device)
        gens = [lane["session"].state.generator if lane is not None else self._idle_gens[i]
                for i, lane in enumerate(self._lanes)]
        group = {"rows": rows, "hist": self._hist, "gov": self._gov,
                 "ban": list(self._ban) if rows.traced is not None else None}
        done = [lane is None for lane in self._lanes]
        with self.pool._lock:
            if self.paged:
                ppool = self.pool.paged_pool
                if self._table_dev is None:
                    self._table_dev = torch.tensor(self._table, dtype=torch.int32).to(eng.device)
                try:
                    lane_tokens, self._logits = self.pool._group_step(
                        group, {"k": ppool.k, "v": ppool.v}, self._logits, self._pos, gens,
                        chunk, n_passes if spec else 0, done, self._table_dev, self._steps())
                except Exception:
                    ppool.broken = True  # the pool's contents are unknown now
                    raise
            else:
                lane_tokens, self._logits = self.pool._group_step(
                    group, self._cache, self._logits, self._pos, gens, chunk,
                    n_passes if spec else 0, done, None, self._steps())
        self._hist = group["hist"]
        # a step other than a sampled speculative one leaves no ban
        self._ban = group["ban"] if spec and group["ban"] is not None else [-1] * self.B
        if self._gov.demotions > self._gov_reported:
            self.pool._bump("spec_demotions", self._gov.demotions - self._gov_reported)
            self._gov_reported = self._gov.demotions
        self._pos = [p + len(t) for p, t in zip(self._pos, lane_tokens)]
        tokenizer = eng.tokenizer
        bump = lambda: self.pool._bump("tokens_generated")  # noqa: E731
        for i in act:
            lane = self._lanes[i]
            deliver, finished = _consume_lane_tokens(lane, lane_tokens[i], tokenizer, bump)
            for token in deliver:
                lane["out"].put(token)
            if finished:
                self._finalize(i)
        # idle slots decode at position 0 of their own slot (or the trash page)
        self._pos = [p if lane is not None else 0 for p, lane in zip(self._pos, self._lanes)]
        return [list(map(int, lane_tokens[i])) for i in act]
