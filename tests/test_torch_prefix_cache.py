"""The port's radix prefix cache (``SessionPool._radix_fast_forward``,
``capture_prefix``, ``prefix_cache_stats``) against the JAX package's on
the CPU: the cases of tests/test_sessions.py (an installed system prompt is
bit-identical to its prefill, generation through the cache equals the
uncached one, the image upload flow hits), plus an OpenAI-style replay, the
byte budget and prefix pruning, and installs that keep the state's cache
tensors.  The port serves only exact hits (JAX also serves partial and
extension hits, which feed other chunks than the uncached path): its ids,
states, entries and captures equal JAX's, and its hits and prefilled tokens
are its own; a stateless request gives the same ids before and after a
longer conversation of the same opening.
"""

import numpy as np
import pytest
import torch

from fixtures import build_gq_models
from minigpt4_tpu.engine.sampling import SamplingParams as JaxParams
from minigpt4_tpu.engine.sessions import SessionPool as JaxSessionPool
from minigpt4_tpu_torch.engine import SamplingParams
from minigpt4_tpu_torch.engine.sessions import SessionPool
from minigpt4_tpu_torch.models import llama as tllama

# one intra-op thread: the suite runs several pytest-xdist workers on the same cores, where
# torch's OpenMP pools spin against each other and run ~17x slower
torch.set_num_threads(1)

GREEDY = SamplingParams(temp=0.0)
POOL_KW = dict(session_ctx=256, n_ctx=256, n_batch=32)
COUNTERS = ("prefix_cache_hits", "prefix_cache_misses", "tokens_prefilled")


@pytest.fixture(scope="module")
def gq_files(tmp_path_factory):
    return build_gq_models(tmp_path_factory.mktemp("torch_prefix"))


def _pools(gq_files, ctx=256, **kw):
    geometry = dict(POOL_KW, session_ctx=ctx, n_ctx=ctx)
    return (SessionPool(*gq_files, device="cpu", **geometry, **kw),
            JaxSessionPool(*gq_files, quant_mode="gq", **geometry, **kw))


def _counters(pool):
    return {k: pool.metrics[k] for k in COUNTERS}


@pytest.mark.parametrize("cache_dtype", ["f32", "bf16", "f8"])
def test_exact_hit_installs_the_bits_and_logits_of_the_prefill(gq_files, cache_dtype):
    """The second session's system prompt installs the first one's rows and
    pending logits: bit-equal to the prefill it replaces, copied into the
    session's own cache tensors, with no position prefilled."""
    pool = SessionPool(*gq_files, device="cpu", cache_dtype=cache_dtype, **POOL_KW)
    try:
        a, b = pool.new_session(), pool.new_session()
        pool.system_prompt(a)  # a miss: computed and captured
        before = pool.metrics["tokens_prefilled"]
        ptrs = {kv: t.data_ptr() for kv, t in b.state.cache.items()}
        pool.system_prompt(b)  # an exact hit
        assert pool.metrics["tokens_prefilled"] == before
        assert (pool.metrics["prefix_cache_hits"], pool.metrics["prefix_cache_misses"]) == (1, 1)
        n = a.n_past
        assert n > 0 and b.n_past == n and b.state.n_keep == n
        assert a.state.tokens == b.state.tokens
        assert {kv: t.data_ptr() for kv, t in b.state.cache.items()} == ptrs
        for kv in ("k", "v"):
            assert b.state.cache[kv].dtype == pool.engine.cache_dtype
            assert torch.equal(tllama._bits(a.state.cache[kv][:, :, :, :n]),
                               tllama._bits(b.state.cache[kv][:, :, :, :n]))
        assert torch.equal(a.state.logits, b.state.logits)
        assert b.state.logits is not pool._prefix_cache[tuple(a.state.tokens)]["logits"]
        a.close()
        b.close()
    finally:
        pool.close()


def _chat(pool, params, q="hello", limit=8):
    s = pool.new_session()
    pool.system_prompt(s)
    pool.begin_chat(s, q)
    toks = list(s.generate(limit=limit, params=params))
    state = (s.n_past, list(s.state.tokens))
    s.close()
    return toks, state


def test_generation_through_the_cache_equals_uncached_and_jax(gq_files):
    """A chat whose system prompt rides the cache gives the ids and state of
    a pool without the cache and of JAX's pool, with JAX's counters.  (On
    "hello there" the port's greedy ids leave JAX's at the 6th token, a
    near-tie: top-2 margin 4.6e-4 against a port-JAX logit gap of 3.3e-4 of
    max|logit|, inside ROADMAP Queue 3's bf16 bounds; the port's cached and
    uncached chats agree there too.)"""
    pool, jpool = _pools(gq_files)
    off = SessionPool(*gq_files, device="cpu", prefix_cache=False, **POOL_KW)
    try:
        assert pool.prefix_cache and not off.prefix_cache
        runs = [_chat(pool, GREEDY) for _ in range(2)]
        jruns = [_chat(jpool, JaxParams(temp=0.0)) for _ in range(2)]
        assert runs[0] == runs[1] == _chat(off, GREEDY) == jruns[0] == jruns[1]
        assert _counters(pool) == _counters(jpool)
        assert pool.metrics["prefix_cache_hits"] == 1
        assert off.metrics["prefix_cache_hits"] == off.metrics["prefix_cache_misses"] == 0
        assert off.prefix_cache_stats() == {"entries": 0, "bytes": 0}
        assert pool.prefix_cache_stats() == jpool.prefix_cache_stats()
        assert _chat(pool, GREEDY, "hello there") == _chat(off, GREEDY, "hello there")
    finally:
        for p in (pool, jpool, off):
            p.close()


def _replay(pool, turns, reply_of):
    """The OpenAI route's stateless replay: a fresh session feeds the system
    prompt and every turn so far (the port: the turns' template pieces at
    once, as ``serve.py`` does; JAX: piece by piece, as its route does),
    captures the transcript, then decodes."""
    s = pool.new_session()
    pool.system_prompt(s)
    if isinstance(pool, SessionPool):
        pieces = []
        for i, q in enumerate(turns):
            if i:
                pieces.append(("text", reply_of[i - 1] + "###"))
            pieces += pool.engine.chat_pieces(q)
        pool.feed(s, pieces)
    else:
        for i, q in enumerate(turns):
            if i:
                pool._add_strings(s, reply_of[i - 1] + "###")
            pool.begin_chat(s, q)
    pool.capture_prefix(s)
    reply = "".join(s.generate(limit=6, params=reply_of["params"]))
    state = (s.n_past, list(s.state.tokens))
    s.close()
    return reply, state


def test_openai_replay_prefills_only_the_new_turn_like_jax(gq_files):
    """Two requests of one conversation, each replaying the whole
    transcript: the second one installs its transcript up to its new turn
    (an exact hit of the first one's capture) and prefills only the rest;
    the replies and states equal JAX's and the uncached pool's, and the
    captures, entries and stats JAX's."""
    pool, jpool = _pools(gq_files, ctx=512)
    off = SessionPool(*gq_files, device="cpu", prefix_cache=False,
                      **dict(POOL_KW, session_ctx=512, n_ctx=512))
    try:
        turns = ["hello", "and then?"]
        out = {}
        for name, p, params in (("port", pool, GREEDY), ("jax", jpool, JaxParams(temp=0.0)),
                                ("off", off, GREEDY)):
            replies = {"params": params}
            rows = []
            for k in range(1, len(turns) + 1):
                before = p.metrics["tokens_prefilled"]
                replies[k - 1], state = _replay(p, turns[:k], replies)
                rows.append((replies[k - 1], state, p.metrics["tokens_prefilled"] - before))
            out[name] = rows
        assert [r[:2] for r in out["port"]] == [r[:2] for r in out["off"]]
        assert [r[:2] for r in out["port"]] == [r[:2] for r in out["jax"]]
        # the first request prefills its whole transcript; the second only
        # what follows the first one's: the reply, "###" and the new turn
        assert out["port"][0][2] == out["off"][0][2]
        first = out["port"][0][1][0]
        assert out["port"][1][2] == out["port"][1][1][0] - first < out["off"][1][2]
        # system prompts: a miss, then an exact hit kept through the pruning
        # of its entry; the second transcript: one exact hit
        assert pool.metrics["prefix_cache_hits"] == 2
        assert pool.metrics["prefix_cache_misses"] == jpool.metrics["prefix_cache_misses"] == 3
        assert pool.prefix_cache_stats() == jpool.prefix_cache_stats()
        assert list(pool._prefix_cache) == list(jpool._prefix_cache)
    finally:
        for p in (pool, jpool, off):
            p.close()


def test_stateless_request_is_unchanged_by_a_longer_conversation(gq_files):
    """A stateless request ("hello there") gives the same ids and state
    before and after a longer conversation that opens with it has been
    captured (which prunes the request's own entry), and so does a request
    whose question is a token prefix of it ("hello"): every install is an
    exact hit, bit-equal to the prefill the uncached pool runs."""
    pool = SessionPool(*gq_files, device="cpu", **dict(POOL_KW, session_ctx=512, n_ctx=512))
    off = SessionPool(*gq_files, device="cpu", prefix_cache=False,
                      **dict(POOL_KW, session_ctx=512, n_ctx=512))
    try:
        want = {}
        for q in ("hello there", "hello"):
            replies = {"params": GREEDY}
            want[q] = _replay(off, [q], replies)
        replies = {"params": GREEDY}
        first = _replay(pool, ["hello there"], replies)
        assert first == want["hello there"]
        replies[0] = first[0]
        _replay(pool, ["hello there", "and then?"], replies)
        assert len(pool._prefix_cache) == 1  # the shorter transcripts were pruned
        hits = pool.metrics["prefix_cache_hits"]
        assert _replay(pool, ["hello there"], {"params": GREEDY}) == want["hello there"]
        assert pool.metrics["prefix_cache_hits"] == hits + 2  # system prompt, transcript
        assert _replay(pool, ["hello"], {"params": GREEDY}) == want["hello"]
    finally:
        pool.close()
        off.close()


def test_evicted_transcript_hands_on_the_system_prompt(gq_files):
    """A transcript's capture prunes the system prompt's entry and keeps its
    pending logits; when the budget evicts that transcript, the logits pass
    to another transcript that holds the same rows, so the next session's
    system prompt is still an exact hit, bit-equal to its prefill."""
    pool = SessionPool(*gq_files, device="cpu", prefix_cache_mb=0, **POOL_KW)
    try:
        ref = pool.new_session()
        pool.system_prompt(ref)  # a miss: the system prompt's entry
        for q in ("one", "two"):
            s = pool.new_session()
            pool.system_prompt(s)
            pool.begin_chat(s, q)
            assert pool.capture_prefix(s)
            s.close()
        assert len(pool._prefix_cache) == 1  # "one" evicted, "two" holds the prompt
        hits = pool.metrics["prefix_cache_hits"]
        s = pool.new_session()
        pool.system_prompt(s)
        assert pool.metrics["prefix_cache_hits"] == hits + 1
        n = ref.n_past
        assert s.state.tokens == ref.state.tokens and torch.equal(s.state.logits, ref.state.logits)
        for kv in ("k", "v"):
            assert torch.equal(tllama._bits(s.state.cache[kv][:, :, :, :n]),
                               tllama._bits(ref.state.cache[kv][:, :, :, :n]))
        s.close()
        ref.close()
    finally:
        pool.close()


def test_byte_budget_evicts_the_least_recently_used_like_jax(gq_files):
    """With a budget smaller than two entries the cache keeps the newest one;
    a key covered by a longer entry is not stored again; the entries, bytes
    and captures equal JAX's over the same sequence, and the port's one hit
    is the exact one (the repeated turn)."""
    pool, jpool = _pools(gq_files, prefix_cache_mb=0)
    try:
        fed = []
        for p in (pool, jpool):
            for q in ("one", "two", "three"):
                s = p.new_session()
                p.begin_chat(s, q)
                assert p.capture_prefix(s)
                fed.append(s.n_past)
                s.close()
            s = p.new_session()
            p.begin_chat(s, "three")  # an exact hit of the newest entry
            assert p.capture_prefix(s)  # already stored: touched, not stored again
            s.close()
        assert pool.prefix_cache_stats()["entries"] == 1
        assert pool.prefix_cache_stats() == jpool.prefix_cache_stats()
        assert list(pool._prefix_cache) == list(jpool._prefix_cache)
        assert fed[:3] == fed[3:]
        assert pool.metrics["prefix_cache_misses"] == jpool.metrics["prefix_cache_misses"] == 3
        assert pool.metrics["prefix_cache_hits"] == 1
        assert pool.metrics["tokens_prefilled"] == sum(fed[:3])
    finally:
        pool.close()
        jpool.close()


def test_image_rows_are_never_matched_or_captured(gq_files):
    """upload_image (reset, system prompt, encode) hits the cache from the
    second session on; a state with embedding rows is never captured, and
    the image chat still decodes as on a pool without the cache."""
    pool = SessionPool(*gq_files, device="cpu", **POOL_KW)
    off = SessionPool(*gq_files, device="cpu", prefix_cache=False, **POOL_KW)
    try:
        size = pool.engine.vision_cfg.vit.image_size
        img = np.random.default_rng(7).normal(0, 1, (3, size, size)).astype(np.float32)
        texts = []
        for p in (pool, pool, off):
            s = p.new_session()
            s.upload_image(img)
            s.ask("what is it?")
            assert not p.capture_prefix(s)
            texts.append(("".join(s.generate(limit=4, params=GREEDY)), s.n_past))
            s.close()
        assert texts[0] == texts[1] == texts[2]
        assert pool.metrics["prefix_cache_hits"] == 1
        assert pool.prefix_cache_stats()["entries"] == 1  # the system prompt only
    finally:
        pool.close()
        off.close()
