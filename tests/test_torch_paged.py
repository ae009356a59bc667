"""Port parity for paged batched decoding: the plain paged attention against
JAX's paged flash kernel (interpret mode), the port's SessionPool batches
against JAX's SessionPool on the gq fixture, and the page pool's accounting
(the cases of tests/test_paged.py that the port serves), all on the CPU.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fixtures import build_gq_models
from minigpt4_tpu.engine.sampling import SamplingParams as JaxParams
from minigpt4_tpu.engine.sessions import SessionPool as JaxSessionPool
from minigpt4_tpu.ops.flash_decode import paged_flash_decode_attention as jax_paged
from minigpt4_tpu_torch.engine import SamplingParams
from minigpt4_tpu_torch.engine import device_sampling as tds
from minigpt4_tpu_torch.engine.paged import PAGE, PagedKVPool
from minigpt4_tpu_torch.engine.sessions import SessionPool
from minigpt4_tpu_torch.models import llama as tllama
from minigpt4_tpu_torch.ops import flash_decode as tfd

# one intra-op thread: the suite runs several pytest-xdist workers on the same cores, where
# torch's OpenMP pools spin against each other and run ~17x slower
torch.set_num_threads(1)

GREEDY = SamplingParams(temp=0.0)
PROMPTS = ["one two", "three four five", "six"]
POOL_KW = dict(session_ctx=256, n_ctx=256, n_batch=32)


@pytest.fixture(scope="module")
def gq_files(tmp_path_factory):
    return build_gq_models(tmp_path_factory.mktemp("torch_paged"))


@pytest.fixture(scope="module")
def pool(gq_files):
    p = SessionPool(*gq_files, paged_pool_pages=8, device="cpu", **POOL_KW)
    yield p
    p.close()


def _prepared(pool, prompts):
    sessions = []
    for q in prompts:
        s = pool.new_session()
        pool.begin_chat(s, q)
        sessions.append(s)
    return sessions


def _batch(pool, prompts, limit, decode_chunk=4, paged=True):
    sessions = _prepared(pool, prompts)
    out = pool.generate_batch(sessions, limit=limit, params=GREEDY, decode_chunk=decode_chunk,
                              paged=paged)
    return out, sessions, [(s.n_past, list(s.state.tokens)) for s in sessions]


def _paged_inputs(s, seed=0):
    """Pools of 2 layers over 3 lanes of 4 + 1 table slots, pages shuffled,
    the last pool page the trash page; lane 2 sits past its 512-position
    capacity and reads the trash slot."""
    rng = np.random.default_rng(seed)
    l, b, h, dh, maxp = 2, 3, 2, 64, 4
    n_pages = b * maxp
    pk, pv = (rng.normal(size=(l, n_pages + 1, h, PAGE, dh)).astype(np.float32) for _ in "kv")
    table = np.full((b, maxp + 1), n_pages, np.int32)
    table[:, :maxp] = rng.permutation(n_pages).reshape(b, maxp)
    q = rng.normal(size=(b, h, s, dh)).astype(np.float32)
    pos = np.array([47, 300 - s, 560], np.int32)
    return q, pk, pv, table, pos


@pytest.mark.parametrize("s", [1, 8])
def test_paged_attention_ref_matches_jax_paged_kernel(s):
    q, pk, pv, table, pos = _paged_inputs(s)
    for li in range(2):
        want = np.asarray(jax_paged(jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv), li,
                                    jnp.asarray(pos), jnp.asarray(table), 0.125))
        got = tfd.paged_flash_decode_attention(
            torch.from_numpy(q), torch.from_numpy(pk), torch.from_numpy(pv), li,
            torch.from_numpy(pos), torch.from_numpy(table), 0.125).numpy()
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_paged_forward_writes_through_the_table_and_refuses_spans():
    """One decode step over the pools equals the step over the dense caches
    the pools hold; the overshooting lane writes only the trash page.  (The
    name is older than speculative decoding: spans of S > 1 rows from
    per-row cursors are served now, and equal the dense group's.)"""
    cfg = tllama.LlamaConfig(n_vocab=64, n_embd=128, n_head=2, n_layer=2, n_rot=64, n_ff=128,
                             n_ctx=512)
    rng = np.random.default_rng(3)

    def w(*shape):
        return torch.from_numpy(rng.normal(0, 0.08, shape).astype(np.float32))

    layers = {n: {"w": w(2, *shape)} for n, shape in (
        ("wqkv", (128, 384)), ("wo", (128, 128)), ("w13", (128, 256)), ("w2", (128, 128)))}
    layers["attention_norm"] = torch.ones(2, 128)
    layers["ffn_norm"] = torch.ones(2, 128)
    params = {"tok_embeddings": w(64, 128), "norm": torch.ones(128),
              "output": {"w": w(128, 64)}, "layers": layers}
    _, pk, pv, table, _ = _paged_inputs(1)
    pos = [47, 299, 700]
    pools = {"k": torch.from_numpy(pk).clone(), "v": torch.from_numpy(pv).clone()}
    dense = {kv: pools[kv][:, torch.from_numpy(table).long()].permute(0, 1, 3, 2, 4, 5)
             .reshape(2, 3, 2, 5 * PAGE, 64).clone() for kv in "kv"}
    emb = tllama.embed_tokens(params, torch.tensor([[1], [2], [3]]))
    got = tllama.forward(params, pools, emb, pos, cfg, page_table=torch.from_numpy(table))
    want = tllama.forward(params, dense, emb, pos, cfg)
    torch.testing.assert_close(got[:2], want[:2], rtol=0, atol=0)
    # each lane wrote one position: lanes 0 and 1 in their own pages, the
    # overshooting lane 2 in the trash page through the table's last slot
    for kv, orig in (("k", pk), ("v", pv)):
        changed = (pools[kv] != torch.from_numpy(orig)).any(dim=(0, 2, 4)).nonzero().tolist()
        assert changed == sorted([[int(table[0, 0]), 47], [int(table[1, 2]), 299 % PAGE],
                                  [12, 700 % PAGE]])
        for b, p in enumerate(pos[:2]):
            torch.testing.assert_close(pools[kv][:, table[b, p // PAGE], :, p % PAGE],
                                       dense[kv][:, b, :, p], rtol=0, atol=0)
    # spans of S > 1 rows from per-row cursors (speculative verifies) are
    # served, paged and dense alike: lane 1's 2 rows at 299, 300 and the
    # dense group's rows agree bit for bit
    span = emb.repeat(1, 2, 1)
    got = tllama.forward(params, pools, span, pos, cfg, page_table=torch.from_numpy(table),
                         all_logits=True)
    want = tllama.forward(params, dense, span, pos, cfg, all_logits=True)
    torch.testing.assert_close(got[:2], want[:2], rtol=0, atol=0)
    for kv in ("k", "v"):
        for j in range(2):
            p = pos[1] + j
            torch.testing.assert_close(pools[kv][:, table[1, p // PAGE], :, p % PAGE],
                                       dense[kv][:, 1, :, p], rtol=0, atol=0)


def test_paged_batch_matches_jax_session_pool(pool, gq_files):
    """Greedy paged batches give JAX's SessionPool text on the same files and
    prompts, the port's dense group's text and state, and each session's own
    generate; every page returns to the pool."""
    got, _, gstate = _batch(pool, PROMPTS, limit=12)
    assert pool.paged_pool.free_pages == 8
    dense, _, dstate = _batch(pool, PROMPTS, limit=12, paged=False)
    assert got == dense and gstate == dstate
    alone = ["".join(s.generate(limit=12, params=GREEDY)) for s in _prepared(pool, PROMPTS)]
    assert got == alone
    jpool = JaxSessionPool(*gq_files, paged_pool_pages=8, quant_mode="gq", **POOL_KW)
    try:
        jsessions = []
        for q in PROMPTS:
            s = jpool.new_session()
            jpool.begin_chat(s, q)
            jsessions.append(s)
        want = jpool.generate_batch(jsessions, limit=12, params=JaxParams(temp=0.0),
                                    decode_chunk=4)
        assert got == want
        assert gstate == [(s.n_past, list(s.state.tokens)) for s in jsessions]
    finally:
        jpool.close()


def test_paged_detached_sessions_continue_like_dense(pool):
    """Sessions detached from a paged group continue as from a dense group:
    the gather back into private caches kept their history."""
    _, ps, _ = _batch(pool, PROMPTS[:2], limit=6)
    _, ds, _ = _batch(pool, PROMPTS[:2], limit=6, paged=False)
    for g, d in zip(ps, ds):
        pool.begin_chat(g, "and?")
        pool.begin_chat(d, "and?")
        assert "".join(g.generate(limit=4, params=GREEDY)) == \
            "".join(d.generate(limit=4, params=GREEDY))


def test_paged_uneven_finish(pool):
    """A lane at its limit early overshoots into the trash page while the
    other keeps decoding: the same text and cursors as the dense group."""
    prompts = ["alpha beta", "gamma"]
    gs, ds = _prepared(pool, prompts), _prepared(pool, prompts)
    got = pool.generate_batch(gs, limit=[3, 24], params=GREEDY, decode_chunk=4)
    want = pool.generate_batch(ds, limit=[3, 24], params=GREEDY, decode_chunk=4, paged=False)
    assert got == want
    assert [s.n_past for s in gs] == [s.n_past for s in ds]
    assert pool.paged_pool.free_pages == 8


def test_paged_growth_across_page_boundary(pool):
    """A lane starting below one page grows across the 128-position edge."""
    prompt = "grow " * 20
    (g,) = _prepared(pool, [prompt])
    assert 100 < g.n_past < PAGE
    got = pool.generate_batch([g], limit=40, params=GREEDY, decode_chunk=8)
    assert g.n_past > PAGE
    assert pool.paged_pool.free_pages == 8
    (d,) = _prepared(pool, [prompt])
    assert got == pool.generate_batch([d], limit=40, params=GREEDY, decode_chunk=8, paged=False)


def test_paged_exhaustion_falls_back_dense(gq_files, pool):
    """A group the pool cannot take whole decodes densely, with the same
    text, and the pool is left untouched."""
    small = SessionPool(*gq_files, paged_pool_pages=1, device="cpu", **POOL_KW)
    try:
        got, _, _ = _batch(small, ["one two", "three"], limit=6)
        assert small.paged_pool.free_pages == 1
    finally:
        small.close()
    want, _, _ = _batch(pool, ["one two", "three"], limit=6, paged=False)
    assert got == want


def test_paged_mid_group_dry_pool_detaches_cleanly(gq_files):
    """Two lanes of one page each in a 2-page pool: the first growth finds
    the pool dry, the group stops, the sessions detach whole and go on."""
    dry = SessionPool(*gq_files, paged_pool_pages=2, device="cpu", **POOL_KW)
    try:
        sessions = _prepared(dry, ["one two", "three"])
        out = dry.generate_batch(sessions, limit=200, params=GREEDY, decode_chunk=8)
        assert all(s.n_past <= PAGE for s in sessions)
        assert dry.paged_pool.free_pages == 2
        for s, text in zip(sessions, out):
            assert len(text) > 0
            assert s.state.cache is not None and len(s.state.tokens) == s.n_past
            dry.begin_chat(s, "more")
            assert isinstance("".join(s.generate(limit=2, params=GREEDY)), str)
    finally:
        dry.close()


def test_pool_accounting_and_double_free():
    """free() refuses pages that are not allocated; pages come back to the
    start of the count; a lane past its capacity is refused; the table row
    ends in the trash slot."""
    cfg = tllama.LlamaConfig(n_vocab=8, n_embd=16, n_head=2, n_layer=1, n_rot=8, n_ff=32)
    p = PagedKVPool(cfg, n_pages=4, capacity=256, device="cpu")
    pages = p.alloc(2)
    assert (p.free_pages, p.allocated_pages) == (2, 2)
    assert p.table_row(pages).tolist() == pages + [4]
    p.free(pages)
    with pytest.raises(ValueError, match="double free"):
        p.free(pages)
    with pytest.raises(ValueError, match="double free"):
        p.free([99])
    assert p.free_pages == 4
    with pytest.raises(ValueError, match="capacity"):
        p.extend([], 257)
    assert p.pages_for(0) == 1 and p.pages_for(128) == 1 and p.pages_for(129) == 2


def test_admit_then_evict_round_trips_the_lane():
    cfg = tllama.LlamaConfig(n_vocab=8, n_embd=16, n_head=2, n_layer=2, n_rot=8, n_ff=32,
                             n_ctx=256)
    p = PagedKVPool(cfg, n_pages=4, capacity=256, dtype=torch.float32, device="cpu")
    gen = torch.Generator().manual_seed(0)
    lane = {kv: torch.randn((2, 1, 2, 256, 8), generator=gen) for kv in "kv"}
    pages = p.admit(lane, 130)
    assert len(pages) == 2 and p.free_pages == 2
    back = p.evict(pages, 256)
    assert p.free_pages == 4
    for kv in "kv":
        assert torch.equal(back[kv][:, :, :, :256], lane[kv])


def test_sample_rows_per_lane_configs():
    """A mixed group: temp-0 and top_k = 1 lanes take the argmax of their
    biased logits, sampled lanes draw inside their own chain with their own
    generator, and each lane's bias plane applies to that lane only."""
    v = 50
    logits = torch.from_numpy(np.random.default_rng(4).normal(0, 2, (4, v)).astype(np.float32))
    params = [SamplingParams(temp=0.0), SamplingParams(temp=0.9, top_k=1),
              SamplingParams(temp=0.0, logit_bias={7: 100.0}),
              SamplingParams(temp=0.8, top_k=5, logit_bias={int(logits[3].argmin()): 100.0})]
    rows = tds.lane_rows(params, v, "cpu")
    assert rows.bias is not None and rows.bias[2, 7] == 100.0 and rows.bias[0].abs().sum() == 0
    gens = [torch.Generator().manual_seed(i) for i in range(4)]
    for _ in range(10):
        tok = tds.sample_rows(logits, gens, rows).tolist()
        assert tok[0] == int(logits[0].argmax())
        assert tok[1] == int(logits[1].argmax())
        assert tok[2] == 7
        order, scaled = tds.chain_sorted(logits[3], rows.configs[3], rows.bias[3])
        assert tok[3] in set(order[torch.isfinite(scaled)].tolist())
    gen_a, gen_b = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    a = [tds.sample_rows(logits, [gen_a] * 4, rows)[3] for _ in range(5)]
    b = [tds.sample_token(logits[3], gen_b, rows.configs[3], rows.bias[3]) for _ in range(5)]
    assert a == b  # a sampled lane draws as the single-session sampler does
