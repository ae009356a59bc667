"""Concurrent chat sessions over one loaded model (the serving layer).

Counterpart of ``minigpt4_tpu/engine/sessions.py`` for window-batched
serving.  The reference holds one global cursor (minigpt4.cpp:2521); here
the model weights are loaded once and each :class:`ChatSession` owns a
:class:`~.engine.DecodeState` (KV cache of ``session_ctx`` positions,
cursor, pending logits, sampling generator) on which the engine's
operations act.

  * A lock serializes device work (prefill, decode chunks, group joins and
    detaches); host work (tokenizing, detokenizing, EOS scans) interleaves.
  * :meth:`SessionPool.generate_batch_stream` decodes several prepared
    sessions together: every decode step reads the weights once for all
    lanes.  With a page pool (``paged_pool_pages``) each lane's consumed
    prefix is copied into 128-position pages of one shared pool
    (``engine/paged.py``) and decoded through the paged flash-decode kernel;
    otherwise, or when the pool cannot take the whole group, the lanes'
    caches stack into one dense group cache.  On a CUDA engine at tp = 1 a
    paged group's decode chunks replay captured CUDA graphs over the pool
    (``engine/graphs.py``): per lane count and chunk length, one for
    all-greedy groups and one for every other mix of configs (the traced
    thresholds of ``device_sampling.lane_rows``), and one more where a lane
    carries a logit bias.  :meth:`SessionPool.warmup` captures the first
    two ahead of time; the dense group and single sessions run eagerly.

With a tensor-parallel engine (``tp=N``, one process per rank, every rank
running the same calls) the lane caches and the page pool hold the rank's
heads (``parallel/spmd.py``); lanes, page tables and cursors are the same
on every rank.

With an engine of ``context_shift=True`` a session's prefill and its own
decode shift its context where the JAX ``SessionPool`` does (the engine's
operations on the session's state, and before each mirostat token); a
batched group leaves out a session without room for a chunk, as JAX's.

Not ported yet (ROADMAP): continuous batching, speculative decoding and its
governor, the radix prefix cache, parking idle sessions in host memory.
Lane caches and the page pool hold the engine's cache type
(``MiniGPT4Engine.cache_dtype``).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque

import numpy as np
import torch

from ..models import llama as llama_mod
from .device_sampling import lane_rows
from .engine import EOS_SUFFIX, EOS_TOKEN_SUFFIX, DecodeState, MiniGPT4Engine
from .graphs import StepGraphs
from .paged import PagedKVPool, PoolExhausted
from .sampling import Sampler, SamplingParams


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
    def n_past(self) -> int:
        return self.state.n_past

    @property
    def last_logits(self) -> np.ndarray | None:
        """Host copy of the pending logits."""
        lg = self.state.logits
        return None if lg is None else lg.float().cpu().numpy()

    def encode_image(self, pixels: np.ndarray) -> np.ndarray:
        emb = self._pool.encode_image(pixels)
        self.embedding = emb
        return emb

    def upload_image(self, pixels: np.ndarray) -> None:
        self.reset()
        self._pool.system_prompt(self)
        self.encode_image(pixels)
        self.is_image_chat = True

    def ask(self, question: str) -> None:
        if self.is_image_chat and self.embedding is not None:
            self._pool.begin_chat_image(self, self.embedding, question)
            self.is_image_chat = False
        else:
            self._pool.begin_chat(self, question)

    def generate(self, limit: int = 256, params: SamplingParams | None = None):
        yield from self._pool.generate(self, limit, params or SamplingParams())

    def reset(self) -> None:
        self.state.reset()
        self.is_image_chat = False
        self.embedding = None

    def close(self) -> None:
        self._pool._release(self)


def _consume_lane_tokens(lane: dict, token_ids, tokenizer, bump):
    """Advance one lane's host bookkeeping over freshly evaluated token ids.

    Mutates ``lane`` (keys: session, limit, chat, emitted, ends) and the
    session's token history; returns ``(deliver, finished)``: the tokens to
    send to the client and whether the lane hit EOS or its limit (the
    reference's EOS rules, minigpt4.cpp:2764-2782)."""
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


def _detach_lane_state(st: DecodeState, ends: int, pos_now: int, cache: dict,
                       logits_row: torch.Tensor) -> None:
    """Return a lane's state to its session, rolling back overshoot: cursor
    and token history truncate to the consumed prefix; a rolled-back lane's
    pending logits belong to the overshoot and are dropped (the next
    prefill installs fresh ones)."""
    st.cache = cache
    st.n_past = ends
    del st.tokens[ends:]
    st.logits = logits_row if ends == pos_now else None


class SessionPool:
    """One loaded engine and the decode states of its sessions."""

    def __init__(self, model_path, llm_path, session_ctx: int = 512, seed: int = 1337,
                 paged_pool_pages: int | None = None, **engine_kwargs):
        self.engine = MiniGPT4Engine(model_path, llm_path, seed=seed, **engine_kwargs)
        self.session_ctx = session_ctx
        self.seed = seed
        self._lock = threading.Lock()
        self._metrics_lock = threading.Lock()  # counters move across streams
        self._rate_events: deque[tuple[float, int]] = deque(maxlen=4096)
        self._next_id = 0
        self._sessions: dict[int, ChatSession] = {}
        self.metrics = {"sessions_created": 0, "images_encoded": 0,
                        "tokens_prefilled": 0, "tokens_generated": 0}
        self._session_cfg = dataclasses.replace(self.engine.cache_cfg, n_ctx=session_ctx)
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
    def encode_image(self, pixels: np.ndarray) -> np.ndarray:
        with self._lock:
            self.metrics["images_encoded"] += 1
            return self.engine.encode_image(pixels)

    def _prefill(self, s: ChatSession, op, *args) -> None:
        """Run the engine operation ``op(*args, st=s.state)`` under the lock
        and count the positions it fed."""
        with self._lock:
            if s.state.cache is None:
                raise ValueError("session cache is not resident (riding a batched decode?)")
            n0 = s.state.n_past
            op(*args, st=s.state)
            self._bump("tokens_prefilled", s.state.n_past - n0)

    def _add_tokens(self, s: ChatSession, tokens: list[int]) -> None:
        self._prefill(s, self.engine.add_tokens, tokens)

    def _add_strings(self, s: ChatSession, text: str) -> None:
        self._prefill(s, self.engine.add_strings, text)

    # -- chat protocol (the engine's templates) --
    def system_prompt(self, s: ChatSession) -> None:
        self._prefill(s, self.engine.system_prompt)

    def begin_chat_image(self, s: ChatSession, embedding: np.ndarray, q: str) -> None:
        self._prefill(s, self.engine.begin_chat_image, embedding, q)

    def begin_chat(self, s: ChatSession, q: str) -> None:
        self._prefill(s, self.engine.begin_chat, q)

    def generate(self, s: ChatSession, limit: int, params: SamplingParams):
        """One session's stream: device-sampled chunks through the engine,
        or, for mirostat, the session's host sampler one token at a time."""
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

        Yields, once per decode chunk, a list of (session index, token) in
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

    def _decode(self, cache, logits, pos, rows, batch, decode_chunk, page_table=None,
                steps: StepGraphs | None = None):
        """One decode chunk of the group, replaying ``steps``' graph where
        given; returns (token ids per lane, the final logits).  Caller holds
        the lock."""
        gens = [s.state.generator for s in batch]
        with torch.no_grad():
            if steps is not None:
                tokens, logits = steps.decode_chunk(logits, pos, decode_chunk, gens, rows,
                                                    page_table)
            else:
                tokens, logits = llama_mod.decode_loop(
                    self.engine.llm_params, cache, logits, pos, decode_chunk, gens, rows,
                    self.engine.llm_cfg, page_table=page_table, tp=self.engine.tp_group)
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
        without a logit bias.  The lanes' tables hold only the pool's trash
        page, so no page a lane owns is written.  Returns the seconds, the
        graphs of the paged group and the bytes of the engine's graph memory
        pool.  Refused where the group runs eagerly (no page pool, a CPU
        engine, tp > 1)."""
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
            torch.cuda.synchronize(eng.device)
        return {"warmup_s": time.perf_counter() - t0, "graphs": len(steps.graphs),
                "keys": list(steps.graphs), "pool_bytes": eng.graph_stats()["pool_bytes"]}

    def _dense_batch_stream(self, act, batch, limits_all, rows, decode_chunk):
        """The group's lane caches stacked on the batch axis."""
        n = len(batch)
        n_ctx = self.session_ctx
        with self._lock:
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
        try:
            while not all(done):
                max_pos = max(pos_host[i] for i in range(n) if not done[i])
                if max_pos + decode_chunk > n_ctx:
                    break  # an active lane is out of context: stop the group
                # a finished lane past the cache end writes onto its last
                # position (models/llama.forward): stop before that position
                # could hold the lane's history
                if any(done[i] and pos_host[i] + decode_chunk > n_ctx
                       and lanes[i]["ends"] > n_ctx - decode_chunk for i in range(n)):
                    break
                with self._lock:
                    lane_tokens, logits = self._decode(cache, logits, pos_host, rows, batch,
                                                       decode_chunk)
                pos_host = [p + decode_chunk for p in pos_host]
                yield self._deliver(act, lanes, lane_tokens, done, bump)
        finally:
            with self._lock:
                err = None
                for i, s in enumerate(batch):
                    try:
                        _detach_lane_state(s.state, lanes[i]["ends"], pos_host[i],
                                           {kv: cache[kv][:, i:i + 1].clone()
                                            for kv in ("k", "v")}, logits[i])
                    except Exception as e:
                        self._reset_lane_session(s.state)
                        err = err or e
                if err is not None:
                    raise err

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
        """Copy every lane's consumed prefix into pool pages, all or nothing.
        Returns (page ids per lane, the admitting pool), or None when the pool
        cannot take the whole group now (the group then decodes densely).
        Lanes drop their dense caches only after every lane was copied; a
        failure frees the group's pages and leaves every lane as it was."""
        with self._lock:
            pool = self._live_paged_pool()
            if pool is None:
                return None
            if sum(pool.pages_for(s.n_past) for s in batch) > pool.free_pages:
                return None
            lane_pages: list[list[int]] = []
            try:
                for s in batch:
                    lane_pages.append(pool.admit(s.state.cache, s.n_past))
            except Exception:
                for pages in lane_pages:
                    pool.free(pages)
                return None
            for s in batch:
                s.state.cache = None  # the pool copy is the live one
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
            logits = torch.stack([s.state.logits for s in batch])
        table = np.stack([pool.table_row(p) for p in lane_pages])
        table_dev = None  # uploaded once, and again after a lane grew
        lanes = self._lanes(act, batch, limits_all)
        pos_host = [s.n_past for s in batch]
        done = [False] * n
        bump = lambda: self._bump("tokens_generated")  # noqa: E731
        try:
            while not all(done):
                max_pos = max(pos_host[i] for i in range(n) if not done[i])
                if max_pos + decode_chunk > n_ctx:
                    break
                with self._lock:
                    try:
                        for i in range(n):
                            if not done[i]:
                                grown = pool.extend(lane_pages[i], pos_host[i] + decode_chunk)
                                if len(grown) != len(lane_pages[i]):
                                    lane_pages[i] = grown
                                    table[i] = pool.table_row(grown)
                                    table_dev = None
                    except PoolExhausted:
                        break  # pool dry: the lanes detach and resume later
                    if table_dev is None:
                        table_dev = torch.tensor(table, dtype=torch.int32).to(self.engine.device)
                    try:
                        lane_tokens, logits = self._decode(
                            {"k": pool.k, "v": pool.v}, logits, pos_host, rows, batch,
                            decode_chunk, table_dev, self._paged_steps(pool))
                    except Exception:
                        pool.broken = True  # the pool's contents are unknown now
                        raise
                pos_host = [p + decode_chunk for p in pos_host]
                yield self._deliver(act, lanes, lane_tokens, done, bump)
        finally:
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
