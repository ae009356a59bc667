"""Port parity for greedy speculative decoding: the batched n-gram draft
against JAX's ``_ngram_draft`` integer for integer, the verify span (S = 8
rows from per-row cursors, dense and paged, across a page edge) against the
same rows fed one position at a time, and ``speculative_decode_loop``
against JAX's on the gq fixture (JAX's Pallas kernels in interpret mode)
and against the port's own plain greedy decode.

Tolerances.  Logits within 5e-3 of max|logit|, the bound of
tests/test_torch_llama.py.  A one-lane verify span's layer-0 cache rows are
its inputs' projections and equal the one-position path's bit for bit;
deeper rows go through attention over S = 8 rows instead of 1, whose plain
version sums over another key count, so they agree to 1e-3 of max|row|.  A
two-lane span has M = 16 rows, which take the bf16 prefill matmul (as
JAX's batched verify does), so it is held to 1e-2 of max|logit|.  The greedy prompt's compared span has a
smallest top-2 logit margin of 0.0175 (max|logit| 11.8), three times the
port's final-logit gap to JAX (5.6e-3); the test holds it at >= 0.015.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fixtures import build_gq_models
from minigpt4_tpu.formats import LlamaFileReader
from minigpt4_tpu.models import llama as jllama
from minigpt4_tpu_torch import interop
from minigpt4_tpu_torch.engine.device_sampling import lane_rows
from minigpt4_tpu_torch.engine.sampling import SamplingParams
from minigpt4_tpu_torch.models import llama as tllama
from minigpt4_tpu_torch.ops.flash_decode import PAGE

# one intra-op thread: the suite runs several pytest-xdist workers on the same cores, where
# torch's OpenMP pools spin against each other and run ~17x slower
torch.set_num_threads(1)

N_CTX = 256
GREEDY_ROWS = lane_rows([SamplingParams(temp=0.0)], 1, "cpu")
# the greedy prompt: 8 seeded ids (numpy seed 0, ids 3..199 after BOS) and
# the fixture model's first 30 greedy ids after them, which repeat n-grams,
# so that drafts get accepted
PROMPT = [1, 170, 128, 103, 56, 63, 11, 17, 13, 176, 83, 83, 83, 144, 107, 192, 192, 192, 192,
          192, 196, 62, 83, 235, 83, 12, 178, 259, 114, 192, 166, 25, 0, 260, 28, 57, 53, 13]
MIN_MARGIN = 0.015  # smallest top-2 gap allowed along the compared span


@pytest.fixture(scope="module")
def loaded(tmp_path_factory):
    _, llm = build_gq_models(tmp_path_factory.mktemp("torch_spec"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MINIGPT4_TPU_GQ_PACK", "0")  # interop maps unpacked codes
        with LlamaFileReader(llm) as r:
            jparams, jcfg = jllama.load_params(r, jnp.float32, n_ctx=N_CTX, quant_mode="gq")
    tparams = interop.llama_params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    tcfg = tllama.LlamaConfig(n_vocab=jcfg.n_vocab, n_embd=jcfg.n_embd, n_head=jcfg.n_head,
                              n_layer=jcfg.n_layer, n_rot=jcfg.n_rot, n_ff=jcfg.n_ff,
                              n_ctx=N_CTX)
    return jparams, jcfg, tparams, tcfg


def _close(got, want, tol=5e-3):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


# -- the n-gram draft --------------------------------------------------------

NGRAM_CASES = {
    # (history, pos, t0, k_draft, context, expected draft)
    "4gram_beats_later_trigram": ([2, 5, 7, 9, 11, 12, 4, 5, 7, 9, 20, 21, 0, 2, 5, 7], 16, 9, 2,
                                  40, [11, 12]),
    "trigram_beats_later_bigram": ([1, 7, 9, 2, 3, 5, 7, 9, 4, 6, 8, 5, 7], 13, 9, 3, 32,
                                   [4, 6, 8]),
    "bigram": ([1, 7, 9, 2, 3, 0, 0, 7], 8, 9, 2, 32, [2, 3]),
    "most_recent_bigram": ([7, 9, 1, 7, 9, 2, 3, 7], 8, 9, 2, 32, [2, 3]),
    "no_match": ([1, 2, 3], 3, 99, 4, 16, None),
    "period_1": ([5, 5, 5, 5, 5], 5, 5, 4, 32, [5, 5, 5, 5]),
    "sentinel_fill": ([1, 7, 9, -1, -1, 3, 7], 7, 9, 4, 32, [9, 9, 3, 7]),
    "clip_at_context_end": ([0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 30, 21, 22, 30], 16, 21, 4,
                            16, [30, 21, 22, 30]),
}


def _jax_draft(hist, pos, t0, k, c):
    return np.asarray(jllama._ngram_draft(jnp.asarray(hist, jnp.int32), jnp.int32(pos),
                                          jnp.int32(t0), k, c)).tolist()


@pytest.mark.parametrize("case", list(NGRAM_CASES))
def test_ngram_draft_matches_jax(case):
    seq, pos, t0, k, c, want = NGRAM_CASES[case]
    hist = np.full(c, -1, np.int64)
    hist[:len(seq)] = seq
    got = tllama._ngram_draft(torch.from_numpy(hist)[None], torch.tensor([pos]),
                              torch.tensor([t0]), k)[0].tolist()
    assert got == _jax_draft(hist, pos, t0, k, c)
    if want is not None:
        assert got == want


def test_ngram_draft_batch_matches_jax_on_seeded_histories():
    """64 lanes of a 4-letter alphabet (matches of every length abound),
    cursors anywhere in a 48-position context, image rows (-1) sprinkled
    in, drafted in one batched call: each lane's draft is JAX's."""
    rng = np.random.default_rng(5)
    b, c, k = 64, 48, 7
    hist = rng.integers(0, 4, (b, c))
    hist[rng.random((b, c)) < 0.05] = -1
    pos = rng.integers(0, c + 1, b)
    for i in range(b):
        hist[i, pos[i]:] = -1
    t0 = rng.integers(0, 4, b)
    got = tllama._ngram_draft(torch.from_numpy(hist), torch.from_numpy(pos),
                              torch.from_numpy(t0), k).tolist()
    for i in range(b):
        assert got[i] == _jax_draft(hist[i], pos[i], t0[i], k, c), i


# -- verify spans --------------------------------------------------------------


def _history(tcfg, b, seed):
    """A dense f32 cache [L, B, H, C, Dh] of random history rows."""
    g = torch.Generator().manual_seed(seed)
    shape = (tcfg.n_layer, b, tcfg.n_head, tcfg.n_ctx, tcfg.head_dim)
    return {kv: torch.randn(shape, generator=g) * 0.5 for kv in "kv"}


def _to_pools(dense, table):
    """The dense lanes' rows laid into page pools through ``table``
    [B, MAXP + 1] (last slot the trash page)."""
    l, b, h, c, dh = dense["k"].shape
    n_pages = int(table.max()) + 1
    pools = {}
    for kv, t in dense.items():
        pool = torch.zeros((l, n_pages, h, PAGE, dh))
        for lane in range(b):
            for slot in range(c // PAGE):
                pool[:, table[lane, slot]] = t[:, lane, :, slot * PAGE:(slot + 1) * PAGE]
        pools[kv] = pool
    return pools


@pytest.mark.parametrize("lanes", [1, 2])
def test_verify_span_dense_paged_and_stepwise_agree(loaded, lanes):
    """An S = 8 span from per-row cursors (the lane at 124 crosses the page
    edge at 128): paged equals dense bit for bit, logits and written rows,
    and both agree with the 8 positions fed one at a time.  One lane is a
    verify of M = 8 rows, whose matmuls take the decode path as the steps
    do: logits within 5e-3 of max|logit|, layer-0 rows bit for bit, deeper
    rows within 1e-3 of max|row| (measured 2e-4: the dual-i8 split of the
    activations turns the attention's last-bit differences into quantization
    steps).  Two lanes make M = 16 rows, the bf16
    prefill matmul (as JAX's batched verify): logits within 1e-2 (measured
    6.5e-3), rows within 2e-2 of max|row|."""
    _, _, tparams, tcfg = loaded
    pos = [124, 40][:lanes]
    span = torch.tensor([[5, 9, 17, 33, 65, 129, 200, 7], [3, 3, 8, 250, 1, 77, 42, 19]])[:lanes]
    emb = tllama.embed_tokens(tparams, span)
    dense = _history(tcfg, lanes, 0)
    table = torch.tensor([[1, 2, 4], [3, 0, 4]], dtype=torch.int32)[:lanes]  # page 4: trash
    pools = _to_pools(dense, table)
    stepwise = {kv: t.clone() for kv, t in dense.items()}

    got_dense = tllama.forward(tparams, dense, emb, pos, tcfg, all_logits=True)
    got_paged = tllama.forward(tparams, pools, emb, torch.tensor(pos, dtype=torch.int32), tcfg,
                               all_logits=True, page_table=table)
    assert torch.equal(got_paged, got_dense)
    for lane, p in enumerate(pos):
        for j in range(8):
            slot, off = divmod(p + j, PAGE)
            for kv in "kv":
                assert torch.equal(pools[kv][:, table[lane, slot], :, off],
                                   dense[kv][:, lane, :, p + j])
    # lane 0's span landed on two pages: offsets 124..127 and 0..3
    assert int(table[0, 0]) != int(table[0, 1])

    want = torch.stack([tllama.forward(tparams, stepwise, emb[:, j:j + 1], [p + j for p in pos],
                                       tcfg) for j in range(8)], dim=1)
    _close(got_dense.numpy(), want.numpy(), 5e-3 if lanes == 1 else 1e-2)
    for lane, p in enumerate(pos):
        for kv in "kv":
            a, b = dense[kv][:, lane, :, p:p + 8], stepwise[kv][:, lane, :, p:p + 8]
            if lanes == 1:
                assert torch.equal(a[0], b[0])
            assert (a - b).abs().max() <= (1e-3 if lanes == 1 else 2e-2) * b.abs().max()


# -- the greedy loop -----------------------------------------------------------


def _prefill_port(tparams, tcfg, prompt, b=1):
    cache = tllama.init_cache(tcfg, b, torch.float32, "cpu")
    ids = torch.tensor([prompt] * b)
    return tllama.forward(tparams, cache, tllama.embed_tokens(tparams, ids), 0, tcfg), cache


def _emitted(tokens, counts):
    return [t for row, c in zip(tokens, counts) for t in row[:c]]


def _hist(prompt, c, b=1):
    h = torch.full((b, c), -1, dtype=torch.long)
    h[:, :len(prompt)] = torch.tensor(prompt)
    return h


def test_greedy_loop_matches_jax_and_plain_decode(loaded):
    """12 passes of k = 4 on the gq fixture: tokens and counts equal JAX's,
    final logits within 5e-3, the emitted ids are the port's plain greedy
    ids (some drafts accepted), and no step of the span is a near tie."""
    jparams, jcfg, tparams, tcfg = loaded
    n_passes, k = 12, 4
    logits, cache = _prefill_port(tparams, tcfg, PROMPT)
    toks, counts, final, hist = tllama.speculative_decode_loop(
        tparams, cache, logits, len(PROMPT), _hist(PROMPT, N_CTX), n_passes, k, tcfg)
    emitted = _emitted(toks[0].tolist(), counts[0].tolist())
    assert len(emitted) > n_passes  # drafts were accepted
    assert hist[0, :len(PROMPT) + len(emitted)].tolist()[len(PROMPT):] == emitted

    jcache = jllama.init_cache(jcfg, 1, jnp.float32)
    jl, jcache = jllama.forward(jparams, jcache, jllama.embed_tokens(
        jparams, jnp.asarray([PROMPT], jnp.int32)), jnp.int32(0), jcfg)
    jtoks, jcounts, jfinal, _, _ = jllama.speculative_decode_loop(
        jparams, jcache, jl, jnp.int32(len(PROMPT)),
        jnp.asarray(_hist(PROMPT, N_CTX).numpy(), jnp.int32), n_passes, k, jcfg)
    assert toks.tolist() == np.asarray(jtoks).tolist()
    assert counts.tolist() == np.asarray(jcounts).tolist()
    _close(final.numpy(), np.asarray(jfinal))

    # plain greedy, one step at a time, with each step's top-2 margin
    logits, cache = _prefill_port(tparams, tcfg, PROMPT)
    plain, margins = [], []
    for i in range(len(emitted)):
        top = logits[0].topk(2).values
        margins.append(float(top[0] - top[1]))
        plain.append(int(logits[0].argmax()))
        logits = tllama.forward(tparams, cache, tllama.embed_tokens(
            tparams, torch.tensor([[plain[-1]]])), len(PROMPT) + i, tcfg)
    assert emitted == plain
    assert min(margins) >= MIN_MARGIN, min(margins)


def test_dense_and_paged_batched_loops_equal_plain_decode(loaded):
    """Two lanes at cursors 16 and 120 (lane 1 crosses a page edge in its
    first passes): the paged loop's tokens, counts and final logits equal
    the dense loop's bit for bit, and each lane emits plain greedy's ids."""
    _, _, tparams, tcfg = loaded
    prompts = [PROMPT, (PROMPT * 8)[:120]]
    n_passes, k = 6, 8
    caches, logits = [], []
    for p in prompts:
        lg, c = _prefill_port(tparams, tcfg, p)
        caches.append(c)
        logits.append(lg)
    dense = {kv: torch.cat([c[kv] for c in caches], dim=1) for kv in "kv"}
    logits = torch.cat(logits)
    pos = [len(p) for p in prompts]
    hist = torch.cat([_hist(p, N_CTX) for p in prompts])
    table = torch.tensor([[0, 1, 4], [2, 3, 4]], dtype=torch.int32)
    pools = _to_pools({kv: t.clone() for kv, t in dense.items()}, table)
    want = tllama.speculative_decode_loop(tparams, dense, logits, pos, hist, n_passes, k, tcfg)
    got = tllama.speculative_decode_loop(tparams, pools, logits, pos, hist, n_passes, k, tcfg,
                                         page_table=table)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for lane, p in enumerate(prompts):
        emitted = _emitted(got[0][lane].tolist(), got[1][lane].tolist())
        lg, c = _prefill_port(tparams, tcfg, p)
        plain, _ = tllama.decode_loop(tparams, c, lg, len(p), len(emitted),
                                      [torch.Generator()], GREEDY_ROWS, tcfg)
        assert emitted == plain[0].tolist()
