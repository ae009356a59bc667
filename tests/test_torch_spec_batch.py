"""Batched speculation in the port's serving layer: the window batcher's
dense and paged groups and the continuous batcher with ``speculative_k``
against the same groups without it, and the speculation governor against
the JAX package's on the same observations, all on the gq fixture on the
CPU.

Greedy ids must be equal.  A batched verify of B lanes at width k has
B·k > 8 rows, which take the bf16 prefill matmul where a plain step takes
the decode path (as in the JAX package): the ids agree away from near ties,
which the fixture prompts' continuations are (their equality is what is
asserted).
"""

import pytest
import torch

from fixtures import build_gq_models
from minigpt4_tpu.engine.sessions import _SpecGovernor as JaxGovernor
from minigpt4_tpu_torch.engine import SamplingParams
from minigpt4_tpu_torch.engine import sessions as S
from minigpt4_tpu_torch.engine.sessions import ContinuousBatcher, SessionPool, _SpecGovernor

# one intra-op thread: the suite runs several pytest-xdist workers on the same cores, where
# torch's OpenMP pools spin against each other and run ~17x slower
torch.set_num_threads(1)

GREEDY = SamplingParams(temp=0.0)
PROMPTS = ["one two three", "four five", "six seven eight nine"]
POOL_KW = dict(session_ctx=256, n_ctx=256, n_batch=32, device="cpu")


@pytest.fixture(scope="module")
def gq_files(tmp_path_factory):
    return build_gq_models(tmp_path_factory.mktemp("torch_spec_batch"))


@pytest.fixture(scope="module")
def pools(gq_files):
    """(plain, speculative k = 4) pools, each with an 8-page pool."""
    plain = SessionPool(*gq_files, paged_pool_pages=8, **POOL_KW)
    spec = SessionPool(*gq_files, paged_pool_pages=8, speculative_k=4, **POOL_KW)
    yield plain, spec
    plain.close()
    spec.close()


def _batch(pool, params, paged, limit=20):
    sessions = []
    for q in PROMPTS:
        s = pool.new_session()
        pool.begin_chat(s, q)
        sessions.append(s)
    out = pool.generate_batch(sessions, limit=limit, params=params, decode_chunk=8, paged=paged)
    state = [(s.n_past, list(s.state.tokens), s.state.spec_ban) for s in sessions]
    for s in sessions:
        s.close()
    return out, state


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_greedy_batch_with_speculation_equals_plain(pools, paged):
    """Three greedy lanes: the speculative group's text and the sessions'
    histories after it are the plain group's; the page pool drains."""
    plain, spec = pools
    want = _batch(plain, GREEDY, paged)
    got = _batch(spec, GREEDY, paged)
    assert got == want
    assert spec.paged_pool.free_pages == spec.paged_pool.n_pages


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_mixed_batch_greedy_lanes_equal_plain(pools, paged):
    """A group of two greedy lanes and a sampled one runs speculative
    sampling: the greedy lanes' text is the plain greedy group's, and every
    session comes back coherent (one id per position, a ban only where its
    pending logits survived)."""
    plain, spec = pools
    want, _ = _batch(plain, GREEDY, paged)
    params = [GREEDY, SamplingParams(temp=0.9), GREEDY]
    got, state = _batch(spec, params, paged)
    assert [got[0], got[2]] == [want[0], want[2]]
    for n_past, tokens, ban in state:
        assert len(tokens) == n_past and ban >= -1


def test_governor_demotes_and_stays_exact(gq_files, monkeypatch):
    """With the break-even above any acceptance every probe demotes: the
    group decodes plain chunks between probes, counts its demotions, and
    its text is the plain group's."""
    plain = SessionPool(*gq_files, **POOL_KW)
    spec = SessionPool(*gq_files, speculative_k=4, **POOL_KW)
    try:
        monkeypatch.setattr(S._SpecGovernor, "threshold", lambda self, lanes: 1e9)
        got = _batch(spec, GREEDY, False, limit=40)
        assert spec.metrics["spec_demotions"] >= 1
        assert got == _batch(plain, GREEDY, False, limit=40)
    finally:
        plain.close()
        spec.close()


OBSERVATIONS = [  # (tokens, passes, lanes) of successive speculative steps
    (8, 2, 4), (64, 2, 8), (128, 2, 8), (20, 4, 5), (9, 2, 1), (256, 4, 8), (16, 2, 8),
    (3, 2, 1), (40, 8, 2), (100, 4, 3), (12, 2, 8), (70, 2, 8), (5, 4, 2)] + [(8, 2, 8)] * 5


@pytest.mark.parametrize("cooldown", [3, 8])
def test_governor_decides_as_jax(cooldown):
    """The same observations and queries give the same thresholds, pass
    counts, speculate-or-not answers and demotions as JAX's governor."""
    ours, theirs = _SpecGovernor(cooldown=cooldown), JaxGovernor(cooldown=cooldown)
    for lanes in range(1, 9):
        assert ours.threshold(lanes) == theirs.threshold(lanes)
    for tokens, passes, lanes in OBSERVATIONS:
        for k in (2, 4, 8, 16):
            assert ours.passes_for(16, k) == theirs.passes_for(16, k)
        ours.observe(tokens, passes, lanes)
        theirs.observe(tokens, passes, lanes)
        assert (ours.ewma, ours.cool, ours.demotions) == (theirs.ewma, theirs.cool,
                                                          theirs.demotions)
        for _ in range(cooldown + 1):
            assert ours.want_spec() == theirs.want_spec()
    assert ours.demotions >= 2


def _drain(q):
    out = []
    while True:
        item = q.get(timeout=300)
        if item is ContinuousBatcher._DONE:
            return "".join(out)
        if isinstance(item, Exception):
            raise item
        out.append(item)


def _continuous(pool, params, paged):
    sessions = []
    for q in PROMPTS:
        s = pool.new_session()
        pool.begin_chat(s, q)
        sessions.append(s)
    cb = ContinuousBatcher(pool, max_batch=4, decode_chunk=8, paged=paged)
    try:
        outs = [cb.submit(s, 20, p) for s, p in zip(sessions, params)]
        texts = [_drain(q) for q in outs]
    finally:
        cb.close()
    state = [(s.n_past, list(s.state.tokens)) for s in sessions]
    for s in sessions:
        s.close()
    return texts, state


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_continuous_batcher_with_speculation_equals_plain(pools, paged):
    """Three greedy requests through a 4-lane batcher (one idle slot): the
    speculative batcher's text and histories are the plain one's."""
    plain, spec = pools
    assert _continuous(spec, [GREEDY] * 3, paged) == _continuous(plain, [GREEDY] * 3, paged)


def test_continuous_batcher_counts_demotions_and_mixes(gq_files, monkeypatch):
    """A governor that demotes every probe: the batcher counts the
    demotions in the pool's metrics and its greedy text is unchanged; a
    group with a sampled lane keeps its greedy lanes' text."""
    plain = SessionPool(*gq_files, **POOL_KW)
    spec = SessionPool(*gq_files, speculative_k=4, **POOL_KW)
    try:
        want, _ = _continuous(plain, [GREEDY] * 3, False)
        monkeypatch.setattr(S._SpecGovernor, "threshold", lambda self, lanes: 1e9)
        got, _ = _continuous(spec, [GREEDY] * 3, False)
        assert got == want and spec.metrics["spec_demotions"] >= 1
        monkeypatch.undo()
        mixed, state = _continuous(spec, [GREEDY, SamplingParams(temp=0.9), GREEDY], False)
        assert [mixed[0], mixed[2]] == [want[0], want[2]]
        assert all(len(tokens) == n for n, tokens in state)
    finally:
        plain.close()
        spec.close()

