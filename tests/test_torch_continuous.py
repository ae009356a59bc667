"""The port's ContinuousBatcher against the JAX package's on the CPU (the
cases of tests/test_sessions.py::TestContinuousBatching but the
speculative ones, tests/test_paged.py's continuous cases,
tests/test_ctx_shift.py::test_continuous_batcher_shifts and
tests/test_dyn_sampling.py::test_continuous_mixed_configs_concurrent): the
same requests through both batchers give the same greedy ids, cursors and
token histories, dense and paged, with a mid-flight join, deferral at
capacity, mixed configs, a preemption that resumes and a context shift
inside a lane; plus the port's own checks (joins keep the group's cache
addresses and bits, no fallback on a failed join, the two captured keys).
"""

import queue
import types

import pytest
import torch

from fixtures import build_gq_models
from minigpt4_tpu.engine.sampling import SamplingParams as JaxParams
from minigpt4_tpu.engine.sessions import ContinuousBatcher as JaxBatcher
from minigpt4_tpu.engine.sessions import SessionPool as JaxSessionPool
from minigpt4_tpu_torch.engine import SamplingParams
from minigpt4_tpu_torch.engine.device_sampling import DeviceSamplingConfig
from minigpt4_tpu_torch.engine.paged import PAGE
from minigpt4_tpu_torch.engine.sessions import ContinuousBatcher, SessionPool
from minigpt4_tpu_torch.models import llama as tllama
from test_torch_graphs import fake_cuda  # noqa: F401  (the stand-in CUDA graph API)

# one intra-op thread: the suite runs several pytest-xdist workers on the same cores, where
# torch's OpenMP pools spin against each other and run ~17x slower
torch.set_num_threads(1)

GREEDY = SamplingParams(temp=0.0)
POOL_KW = dict(session_ctx=256, n_ctx=256, n_batch=32)
LONG, SHORT = "tell me a long story about llamas", "hi"


@pytest.fixture(scope="module")
def gq_files(tmp_path_factory):
    return build_gq_models(tmp_path_factory.mktemp("torch_continuous"))


@pytest.fixture(scope="module")
def pool(gq_files):
    p = SessionPool(*gq_files, paged_pool_pages=8, device="cpu", **POOL_KW)
    yield p
    p.close()


@pytest.fixture(scope="module")
def jpool(gq_files):
    p = JaxSessionPool(*gq_files, paged_pool_pages=8, quant_mode="gq", **POOL_KW)
    yield p
    p.close()


def _prep(pool, q, system=True):
    s = pool.new_session()
    if system:
        pool.system_prompt(s)
    pool.begin_chat(s, q)
    return s


def _drain(cb, out, timeout=300):
    toks = []
    while True:
        t = out.get(timeout=timeout)
        if t is cb._DONE:
            return "".join(toks)
        if isinstance(t, Exception):
            raise t
        toks.append(t)


def _state(s):
    return s.n_past, list(s.state.tokens)


def _run(pool, cls, params, requests, staggered=False, system=True, **cb_kw):
    """Submit ``requests`` ((prompt, limit, params), ...) to a fresh batcher of
    ``cls`` over ``pool``; with ``staggered`` the second request is
    submitted after the first one's first token.  Returns the texts, the
    sessions' states and the batcher."""
    cb = cls(pool, **cb_kw)
    try:
        sessions = [_prep(pool, q, system) for q, _, _ in requests]
        outs = [cb.submit(sessions[0], requests[0][1], requests[0][2])]
        first = ""
        if staggered:
            first = outs[0].get(timeout=300)  # the first lane decodes now
            assert isinstance(first, str)
        outs += [cb.submit(s, lim, p) for s, (_, lim, p) in zip(sessions[1:], requests[1:])]
        texts = [_drain(cb, o) for o in outs]
        texts[0] = first + texts[0]
    finally:
        cb.close()
    states = [_state(s) for s in sessions]
    for s in sessions:
        s.close()
    return texts, states, cb


def _pair(pool, jpool, requests, port_kw=None, **kw):
    got = _run(pool, ContinuousBatcher, SamplingParams,
               [(q, n, SamplingParams(**p)) for q, n, p in requests], **kw, **(port_kw or {}))
    want = _run(jpool, JaxBatcher, JaxParams, [(q, n, JaxParams(**p)) for q, n, p in requests],
                **kw)
    return got, want


@pytest.mark.parametrize("paged", [False, True])
def test_mid_flight_join_matches_jax(pool, jpool, paged):
    """A request that joins a running group gets JAX's greedy ids, cursor and
    history, and so does the one it joined; both equal each session's own
    stream."""
    requests = [(LONG, 24, dict(temp=0.0)), (SHORT, 10, dict(temp=0.0))]
    (got, gstates, cb), (want, wstates, _) = _pair(
        pool, jpool, requests, port_kw=dict(paged=paged), staggered=True, max_batch=2,
        decode_chunk=2)
    assert got == want and gstates == wstates
    assert cb.paged == paged and cb.joins == 1
    alone = []
    for q, n, _ in requests:
        s = _prep(pool, q)
        alone.append("".join(s.generate(limit=n, params=GREEDY)))
        s.close()
    assert got == alone
    assert pool.paged_pool.free_pages == pool.paged_pool.n_pages


def test_paged_continuous_matches_dense_and_jax(pool, jpool):
    """The paged batcher (lanes in pool pages, no stacked cache) gives the
    dense batcher's ids and states, and JAX's paged batcher's; every page
    returns to the pool."""
    requests = [("one two", 8, dict(temp=0.0)), ("three four", 8, dict(temp=0.0))]
    (got, gstates, cb), (want, wstates, jcb) = _pair(pool, jpool, requests, max_batch=4,
                                                     decode_chunk=4)
    assert cb.paged and cb._cache is None and jcb.paged
    dense, dstates, dcb = _run(pool, ContinuousBatcher, SamplingParams,
                               [(q, n, GREEDY) for q, n, _ in requests], max_batch=4,
                               decode_chunk=4, paged=False)
    assert not dcb.paged
    assert got == dense == want and gstates == dstates == wstates
    assert pool.paged_pool.free_pages == pool.paged_pool.n_pages


def test_overcapacity_and_mixed_configs_defer(pool, jpool):
    """Requests beyond max_batch=2, one of them sampled, wait for a slot and
    complete; the greedy ones give JAX's ids and states."""
    requests = [("one", 6, dict(temp=0.0)), ("two", 6, dict(temp=0.0)),
                ("three", 6, dict(temp=0.0)), ("four", 6, dict(temp=0.8, top_k=20))]
    (got, gstates, _), (want, wstates, _) = _pair(pool, jpool, requests, max_batch=2,
                                                  decode_chunk=2)
    assert got[:3] == want[:3] and gstates[:3] == wstates[:3]
    assert isinstance(got[3], str) and gstates[3][0] == len(gstates[3][1])


def test_mixed_configs_share_the_group(pool, jpool):
    """A greedy and a sampled request decode in one group (no deferral by
    config): the greedy stream keeps JAX's ids; the sampled lane draws from
    its session's generator, as a lone session does."""
    requests = [("tell me a story", 8, dict(temp=0.0)), (SHORT, 8, dict(temp=0.9, top_k=30))]
    (got, gstates, _), (want, wstates, _) = _pair(pool, jpool, requests, max_batch=2,
                                                  decode_chunk=2)
    assert got[0] == want[0] and gstates[0] == wstates[0]
    assert isinstance(got[1], str) and gstates[1][0] == len(gstates[1][1])


def test_preemption_resumes(gq_files):
    """Two generations that cross the 128-position page edge in a pool of 3
    pages: the youngest lane is preempted at the wall and resumes; both
    streams, cursors and histories equal JAX's in a roomy pool (no
    preemption), and every page comes back."""
    prompts, limit = ("one two", "three four"), 140

    def run(cls, pool_cls, params, n_pages, **kw):
        p = pool_cls(*gq_files, paged_pool_pages=n_pages, **POOL_KW, **kw)
        try:
            texts, states, cb = _run(p, cls, params, [(q, limit, params(temp=0.0))
                                                      for q in prompts],
                                     system=False, max_batch=4, decode_chunk=8)
            assert p.paged_pool.free_pages == p.paged_pool.n_pages
            return texts, states, cb.preemptions
        finally:
            p.close()

    want = run(JaxBatcher, JaxSessionPool, JaxParams, 8, quant_mode="gq")
    got = run(ContinuousBatcher, SessionPool, SamplingParams, 3, device="cpu")
    assert want[2] == 0 and got[2] >= 1
    assert max(n for n, _ in got[1]) > PAGE
    assert got[:2] == want[:2]


@pytest.mark.parametrize("paged", [False, True])
def test_batcher_shifts_like_jax(gq_files, paged):
    """Under context_shift a lane that reaches the context end detaches,
    shifts its cache and rejoins: the stream goes on past the boundary with
    JAX's ids, cursor and history (keep prefix intact)."""
    ctx = 256 if paged else 200

    def run(pool_cls, cls, params, **kw):
        p = pool_cls(*gq_files, session_ctx=ctx, n_ctx=256, n_batch=32, context_shift=True,
                     paged_pool_pages=8 if paged else None, **kw)
        try:
            cb = cls(p, max_batch=2, decode_chunk=8)
            try:
                s = _prep(p, "tell me more")
                keep, kept = s.state.n_keep, list(s.state.tokens[:s.state.n_keep])
                n0 = s.n_past
                text = _drain(cb, cb.submit(s, ctx - n0 + 40, params(temp=0.0)))
            finally:
                cb.close()
            assert s.state.tokens[:keep] == kept and len(s.state.tokens) == s.n_past
            return text, _state(s), n0
        finally:
            p.close()

    got = run(SessionPool, ContinuousBatcher, SamplingParams, device="cpu")
    want = run(JaxSessionPool, JaxBatcher, JaxParams, quant_mode="gq")
    assert got == want
    text, (n_past, _), n0 = got
    assert n_past <= ctx and len(text) > ctx - n0  # decoded past the first boundary


def test_parked_session_joins_from_host(pool):
    """A parked session joins the paged batcher through admit_host (never
    ensure_device) and the dense one through ensure_device, with the text of
    a session that never parked."""
    s = _prep(pool, "one two", system=False)
    want = "".join(s.generate(limit=6, params=GREEDY))
    s.close()
    for paged in (True, False):
        s = _prep(pool, "one two", system=False)
        s.park()
        calls = []
        orig = s.state.ensure_device
        s.state.ensure_device = lambda: (calls.append(1), orig())[1]
        cb = ContinuousBatcher(pool, max_batch=2, decode_chunk=4, paged=paged)
        try:
            assert _drain(cb, cb.submit(s, 6, GREEDY)) == want
        finally:
            cb.close()
        assert (calls == []) == paged
        assert s.state.parked is None and s.state.cache is not None
        s.close()


def test_failed_join_frees_pages_and_reaches_the_client(pool):
    """A join that fails after the pool admitted the lane frees its pages and
    sends the error to the request's queue; the worker serves the next
    request (no fallback to another path)."""
    cb = ContinuousBatcher(pool, max_batch=2, decode_chunk=4)
    try:
        s = _prep(pool, "one two", system=False)
        orig = cb._join_lane

        def fail(*a):
            raise RuntimeError("injected join failure")

        cb._join_lane = fail
        out = cb.submit(s, 4, GREEDY)
        assert isinstance(out.get(timeout=120), RuntimeError)
        assert out.get(timeout=120) is cb._DONE
        assert pool.paged_pool.free_pages == pool.paged_pool.n_pages
        assert s.state.cache is not None and s.state.logits is not None  # nothing moved
        cb._join_lane = orig
        assert _drain(cb, cb.submit(s, 4, GREEDY))
        s.close()
    finally:
        cb.close()


def test_bad_request_and_refusals(pool):
    """An unprepared session and a mirostat request get a ValueError on their
    own queues and the worker goes on.  A batcher over tp ranks is served
    (tests/test_torch_serve_tp.py): a follower's batcher has no thread and
    runs rank 0's rounds (``_cycle``) as they come, with the ids of the
    threaded batcher."""
    cb = ContinuousBatcher(pool, max_batch=2, decode_chunk=2)
    try:
        bad = pool.new_session()
        out = cb.submit(bad, 4, GREEDY)
        assert isinstance(out.get(timeout=60), ValueError) and out.get(timeout=60) is cb._DONE
        good = _prep(pool, "hello", system=False)
        out = cb.submit(good, 4, SamplingParams(mirostat=2))
        assert isinstance(out.get(timeout=60), ValueError) and out.get(timeout=60) is cb._DONE
        assert _drain(cb, cb.submit(good, 4, GREEDY))
        bad.close()
        good.close()
    finally:
        cb.close()
    want = _drain(cb := ContinuousBatcher(pool, max_batch=2, decode_chunk=2),
                  cb.submit(s := _prep(pool, "hello", system=False), 6, GREEDY))
    cb.close()
    s.close()
    follower = types.SimpleNamespace(leader=False, leading=lambda: False)
    pool._ctl = follower
    try:
        cb = ContinuousBatcher(pool, max_batch=2, decode_chunk=2)
        assert cb._thread is None
        s = _prep(pool, "hello", system=False)
        steps = [cb._cycle([(s, 6, GREEDY, 1)], False)]
        while cb._n_active():
            steps.append(cb._cycle([], False))
        ids = [t for step in steps for t in step[0]]
        assert "".join(pool.engine.tokenizer.id_to_str(t) for t in ids).startswith(want)
        assert cb._cycle([], True) is None and len(s.state.tokens) == s.n_past
        s.close()
    finally:
        pool._ctl = None


def test_close_releases_waiting_clients(pool):
    """close() ends every stream, active or waiting for a slot, leaves the
    sessions coherent and refuses later submits."""
    cb = ContinuousBatcher(pool, max_batch=1, decode_chunk=2)
    s1, s2 = _prep(pool, "one", system=False), _prep(pool, "two", system=False)
    out1 = cb.submit(s1, 500, GREEDY)
    assert isinstance(out1.get(timeout=120), str)
    out2 = cb.submit(s2, 4, GREEDY)
    cb.close()
    for out in (out1, out2):
        while (t := out.get(timeout=60)) is not cb._DONE:
            assert isinstance(t, str)
    assert not cb._thread.is_alive()
    for s in (s1, s2):
        assert len(s.state.tokens) == s.n_past and s.state.cache is not None
    late = cb.submit(s1, 2, GREEDY)
    assert isinstance(late.get(timeout=10), RuntimeError)
    s1.close()
    s2.close()


@pytest.mark.parametrize("cache_dtype", ["f32", "bf16", "f8"])
def test_dense_join_and_leave_keep_bits_and_addresses(gq_files, cache_dtype):
    """A dense join copies the session's cache into its slot as bits (no
    cast) and a leave gives back bit-equal rows; the stacked cache keeps its
    addresses, and a session cache of another type is refused."""
    p = SessionPool(*gq_files, device="cpu", cache_dtype=cache_dtype, **POOL_KW)
    cb = ContinuousBatcher(p, max_batch=3, decode_chunk=4)
    try:
        s = _prep(p, "one two three", system=False)
        st = s.state
        rows = {kv: tllama._bits(t).clone() for kv, t in st.cache.items()}
        logits = st.logits.clone()
        ptrs = {kv: t.data_ptr() for kv, t in cb._cache.items()}
        with p._lock:
            cb._join_lane(2, st)
        st.cache = None
        lane = {"session": s, "ends": st.n_past, "out": queue.Queue()}
        cb._lanes[2], cb._pos[2] = lane, st.n_past
        assert cb._leave(2, lane, with_logits=True)
        assert {kv: t.data_ptr() for kv, t in cb._cache.items()} == ptrs
        for kv in ("k", "v"):
            assert st.cache[kv].dtype == p.engine.cache_dtype
            assert torch.equal(tllama._bits(st.cache[kv]), rows[kv])
        assert torch.equal(st.logits, logits) and cb._lanes[2] is None
        other = {kv: torch.zeros(t.shape, dtype=torch.float16) for kv, t in st.cache.items()}
        with pytest.raises(ValueError, match="does not fit"):
            cb._join_lane(0, types.SimpleNamespace(cache=other, logits=logits))
        s.close()
    finally:
        cb.close()
        p.close()


@pytest.mark.parametrize("paged", [False, True])
def test_warmup_captures_two_keys_that_every_step_replays(gq_files, fake_cuda, paged):
    """With the stand-in graphs (a replay runs nothing): warmup captures the
    batcher's all-greedy and traced chunks at max_batch lanes, two graphs,
    and greedy, sampled and biased-free mixed requests then replay them
    without another capture."""
    p = SessionPool(*gq_files, paged_pool_pages=8 if paged else None, device="cpu", **POOL_KW)
    try:
        requests = [("one two", 6, GREEDY), ("three", 6, SamplingParams(temp=0.7)),
                    ("four five", 6, GREEDY)]

        def streams():
            subs = [(_prep(p, q, system=False), n, params) for q, n, params in requests]
            outs = [cb.submit(s, n, params) for s, n, params in subs]
            for out in outs:
                _drain(cb, out)
            for s, _, _ in subs:
                assert len(s.state.tokens) == s.n_past
                s.close()

        p.engine.graphs_enabled = True
        cb = ContinuousBatcher(p, max_batch=4, decode_chunk=4)
        try:
            with pytest.raises(RuntimeError):
                ContinuousBatcher.warmup(types.SimpleNamespace(
                    pool=types.SimpleNamespace(engine=types.SimpleNamespace(
                        graphs_enabled=False, device="cpu"))))
            stats = cb.warmup()
            greedy = (DeviceSamplingConfig(temp=0.0),) * 4
            w = p.paged_pool.maxp + 1 if paged else None
            assert set(stats["keys"]) == {("decode", 4, 4, greedy, False, w),
                                          ("decode", 4, 4, "traced", False, w)}
            assert stats["graphs"] == len(fake_cuda) == 2
            streams()
            # the batcher captured nothing more (the sessions' own prefill
            # steps capture the engine's session graphs)
            steps = cb._steps()
            assert set(steps.graphs) == set(stats["keys"])
            assert all(g.graph.replays >= 1 for g in steps.graphs.values())
        finally:
            cb.close()
    finally:
        p.engine.graphs_enabled = False
        p.close()
