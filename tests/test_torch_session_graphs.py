"""The port's captured steps beyond the engine's own state, on the CPU:
serving sessions' own steps over the engine's resident cache, the batched
verify passes and the banned chunk over a page table, and the drafter's
dispatch and catch-up.

CUDA graphs exist only on the card (``tests/test_torch_cuda.py`` holds the
captured steps to eager ones there).  Here ``torch_graph_stub.replay_cuda``
stands in for them: a capture records the step's operations and a replay
runs them again on the captured tensors, as a graph replays its kernels on
fixed addresses, so a step that depends on anything but its static inputs
and its captured buffers gives other bits.  On the 4-layer Q5_K_M fixture:

(a) Three sessions of one ``SessionPool``, their prefill pieces, chunks and
    turns interleaved: each session's tokens, pending logits and cache bits
    equal the same calls with ``graphs_enabled`` off; the pool holds the
    captured keys one session gives, and one buffer above the sessions' own.
(b) A resident session parked and put back, context-shifted, saved and
    restored, installed from and captured into the radix prefix cache: the
    bits each gives with graphs off.
(c) One session's image chat through the resident graphs against the JAX
    engine's session state: greedy ids equal, the decoded stream's logits
    within 2.5e-3 of max|logit| (the fixture's decode bound, ROADMAP Queue
    3), the image turn's within 5e-3 (its bound for chunks of more than 8
    rows, tests/test_torch_generic.py).
(d) ``SessionPool._group_step`` over a page table: greedy and sampled verify
    passes and the banned chunk replay their keys and give the eager run's
    tokens, counts, histories, bans, page bits and generator states; the
    greedy ids are those of JAX's ``paged_spec_loop``.
(e) The drafted dispatch and the catch-up on the engine's state: the eager
    run's ids and bits, and JAX's ``DraftFns.spec_loop`` ids.
(f) The new steps read no host value (the guards of
    ``tests/test_torch_graphs.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fixtures import GQ_D, build_container, build_llm
from minigpt4_tpu.engine.engine import DraftFns as JaxDraftFns
from minigpt4_tpu.engine.engine import StepFns as JaxStepFns
from minigpt4_tpu.engine.sampling import SamplingParams as JaxParams
from minigpt4_tpu.engine.sessions import SessionPool as JaxSessionPool
from minigpt4_tpu.formats import LlamaFileReader
from minigpt4_tpu.models import llama as jllama
from minigpt4_tpu_torch.engine import MiniGPT4Engine, SamplingParams
from minigpt4_tpu_torch.engine import engine as engine_mod
from minigpt4_tpu_torch.engine import graphs
from minigpt4_tpu_torch.engine.device_sampling import lane_rows
from minigpt4_tpu_torch.engine.sessions import SessionPool
from minigpt4_tpu_torch.image import preprocess
from minigpt4_tpu_torch.models import llama as tllama
from test_torch_fixtures import build_llm_q5_k_m
from torch_graph_stub import _no_host_reads, fake_cuda, replay_cuda  # noqa: F401 (fixtures)

# one intra-op thread: the suite runs several pytest-xdist workers on the same cores, where
# torch's OpenMP pools spin against each other and run ~17x slower
torch.set_num_threads(1)

CTX = 512
ENGINE_KW = dict(n_ctx=CTX, n_batch=32, device="cpu")
GREEDY = SamplingParams(temp=0.0)
SAMPLED = SamplingParams(temp=0.8, top_k=40)
# prompts of one length each, so that every session meets the same step shapes
QUESTIONS = ["what is red?", "where is it?", "tell me more"]
FOLLOW = ["and the blue", "and the gray", "and the pink"]
K = 4  # verify width
PROMPT = [1, 170, 128, 103, 56, 63, 11, 17, 13, 176, 83, 83, 83, 144, 107, 192]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_session_graphs")
    rng = np.random.default_rng(7)
    model = build_container(d / "minigpt4-gq.bin", rng, llm_d=GQ_D)
    llm = build_llm_q5_k_m(d / "vicuna-q5_k_m.bin", rng)
    drafter = build_llm(d / "draft-tiny.bin", np.random.default_rng(1234), None)
    return model, llm, drafter


@pytest.fixture(scope="module")
def engine(files):
    e = MiniGPT4Engine(*files[:2], **ENGINE_KW)
    yield e
    e.close()


@pytest.fixture
def eng(engine):
    """The module's engine, its graphs dropped and switched off afterwards."""
    yield engine
    engine.graphs_enabled = False
    engine._resident = {}
    engine._encode_graphs = None
    engine._graph_pool = None
    engine.speculative_k = 0
    engine.set_drafter()
    engine.reset()


@pytest.fixture(scope="module")
def jax_models(files):
    """JAX's (params, config) of the main model (gq, unpacked codes) and of
    the drafter file."""
    _, llm, drafter = files
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MINIGPT4_TPU_GQ_PACK", "0")
        with LlamaFileReader(llm) as r:
            main = jllama.load_params(r, jnp.float32, n_ctx=CTX, quant_mode="gq")
    with LlamaFileReader(drafter) as r:
        draft = jllama.load_params(r, jnp.float32, n_ctx=CTX)
    return main, draft


def _bits(cache: dict) -> dict:
    return {kv: tllama._bits(t).clone() for kv, t in cache.items()}


def _same_bits(a: dict, b: dict) -> bool:
    return all(torch.equal(a[kv], b[kv]) for kv in ("k", "v"))


def _snap(s) -> dict:
    st = s.state
    return {"tokens": list(st.tokens), "n_past": st.n_past, "n_keep": st.n_keep,
            "logits": None if st.logits is None else st.logits.clone(),
            "cache": None if st.cache is None else _bits(st.cache)}


def _assert_same(got: dict, want: dict) -> None:
    assert (got["tokens"], got["n_past"], got["n_keep"]) == (want["tokens"], want["n_past"],
                                                             want["n_keep"])
    assert (got["logits"] is None) == (want["logits"] is None)
    if want["logits"] is not None:
        assert torch.equal(got["logits"], want["logits"])
    assert _same_bits(got["cache"], want["cache"])


def _pool(eng, **kw) -> SessionPool:
    return SessionPool(None, None, session_ctx=CTX, engine=eng, **kw)


# ---------------------------------------------------------------------------
# (a) sessions interleaved
# ---------------------------------------------------------------------------

STEPS = [lambda pool, s, i: pool.system_prompt(s),
         lambda pool, s, i: pool.begin_chat(s, QUESTIONS[i]),
         lambda pool, s, i: "".join(pool.generate(s, 20, GREEDY)),
         lambda pool, s, i: pool.begin_chat(s, FOLLOW[i]),
         lambda pool, s, i: "".join(pool.generate(s, 12, SAMPLED))]


def _interleaved(pool, n: int) -> tuple[list, list]:
    """``n`` sessions each running STEPS on its own prompts, one step of each
    session in turn: (the sessions, the texts they generated)."""
    sessions = [pool.new_session() for _ in range(n)]
    texts = []
    for step in STEPS:
        for i, s in enumerate(sessions):
            texts.append(step(pool, s, i))
    return sessions, texts


def test_interleaved_sessions_replay_shared_graphs(eng, files, replay_cuda):
    want_s, want_t = _interleaved(_pool(eng, prefix_cache=False), 3)
    want = [_snap(s) for s in want_s]
    eng.graphs_enabled = True
    sessions, texts = _interleaved(_pool(eng, prefix_cache=False), 3)
    assert texts == want_t
    for s, w in zip(sessions, want):
        _assert_same(_snap(s), w)
    assert list(eng._resident) == [CTX]  # one resident set, no graphs of the engine's own state
    res = eng._resident[CTX]
    keys = set(res.steps.graphs)
    assert res.steps.replays > len(keys) > 0
    assert {k[0] for k in keys} >= {"prefill", "decode"}
    # device memory above the sessions' own caches: the spare buffer
    held = {id(s.state.cache["k"]) for s in sessions} | {id(res.spare["cache"]["k"])}
    assert len(held) == len(sessions) + 1
    assert sum(s.state.cache is res.bufs["cache"] for s in sessions) == 1
    # one session running the same steps twice captures the same keys
    one = MiniGPT4Engine(*files[:2], **ENGINE_KW)
    try:
        one.graphs_enabled = True
        pool = _pool(one, prefix_cache=False)
        s = pool.new_session()
        for _ in range(2):
            s.reset()
            for step in STEPS:
                step(pool, s, 0)
        assert set(one._resident[CTX].steps.graphs) == keys
    finally:
        one.close()


# ---------------------------------------------------------------------------
# (b) a resident session's life cycle
# ---------------------------------------------------------------------------

def _lifecycle(eng, ckpt) -> tuple[list, dict]:
    pool = _pool(eng)
    a, b = pool.new_session(), pool.new_session()
    out: dict = {}

    def gen(s, n=8):
        return "".join(pool.generate(s, n, GREEDY))

    pool.system_prompt(a)  # a miss: prefilled and captured
    pool.begin_chat(a, QUESTIONS[0])
    out["a1"] = gen(a)
    pool.system_prompt(b)  # a hit: installed into b's own buffer
    pool.begin_chat(b, QUESTIONS[1])
    out["a2"] = gen(a)  # a resident again
    a.park()  # a resident state parked
    out["b1"] = gen(b)
    out["a3"] = gen(a)  # a put back and made resident
    with pool._lock:
        out["dropped"] = eng.ctx_shift(a.state, 64)  # in place, on the resident buffer
    out["a4"] = gen(a)
    a.state.save(ckpt)  # a resident state saved
    out["b2"] = gen(b)
    pool.begin_chat(a, FOLLOW[0])
    out["a5"] = gen(a)
    a.state.restore(ckpt)  # restored into the resident buffer
    out["a6"] = gen(a)
    pool.begin_chat(a, FOLLOW[1])
    out["captured"] = pool.capture_prefix(a)  # a resident state into the radix cache
    c = pool.new_session()
    pool.feed(c, [("ids", list(a.state.tokens))])  # installed whole from it
    out["c1"] = gen(c)
    out["metrics"] = {k: pool.metrics[k] for k in ("prefix_cache_hits", "prefix_cache_misses")}
    return [_snap(x) for x in (a, b, c)], out


def test_resident_session_life_cycle_bits(eng, replay_cuda, tmp_path):
    want_states, want = _lifecycle(eng, tmp_path / "eager.npz")
    eng.graphs_enabled = True
    got_states, got = _lifecycle(eng, tmp_path / "graphs.npz")
    assert got == want
    assert want["dropped"] > 0 and want["captured"] and want["metrics"]["prefix_cache_hits"] == 2
    for g, w in zip(got_states, want_states):
        _assert_same(g, w)
    with np.load(tmp_path / "eager.npz") as e, np.load(tmp_path / "graphs.npz") as g:
        assert all(np.array_equal(e[f], g[f]) for f in e.files)
    assert eng._resident[CTX].steps.replays > 0


# ---------------------------------------------------------------------------
# (c) an image chat against the JAX engine's session state
# ---------------------------------------------------------------------------

def test_session_image_chat_matches_jax(eng, files, replay_cuda):
    model, llm, _ = files
    eng.graphs_enabled = True
    pool = _pool(eng)
    img = np.random.default_rng(0).integers(0, 255, (40, 50, 3), dtype=np.uint8)
    emb = eng.encode_image(preprocess(img, size=eng.vision_cfg.vit.image_size))
    q = "what is in the image?"

    def chat(s):
        pool.system_prompt(s)
        pool.begin_chat_image(s, emb, q)
        logits, n0 = s.state.logits.numpy().copy(), s.n_past
        text = "".join(pool.generate(s, 32, GREEDY))
        return logits, s.state.tokens[n0:], text, s.state.logits

    chat(pool.new_session())  # meets every key once more: captured
    r0 = eng.graph_stats()["replays"]
    logits, ids, text, final = chat(pool.new_session())
    assert eng.graph_stats()["replays"] > r0
    jpool = JaxSessionPool(model, llm, quant_mode="gq", session_ctx=CTX, n_ctx=CTX, n_batch=32)
    try:
        js = jpool.new_session()
        jpool.system_prompt(js)
        jpool.begin_chat_image(js, emb, q)
        jl, n0 = np.asarray(js.last_logits, np.float64), js.n_past
        jtext = "".join(jpool.generate(js, 32, JaxParams(temp=0.0)))
        jids, jfinal = js.state.tokens[n0:], js.last_logits
    finally:
        jpool.close()
    assert ids == jids and text == jtext and len(ids) > 0
    # the decode steps' logits to the fixture's decode bound, the image turn's
    # (the last of chunks of up to 32 rows) to its bound for chunks of more
    # than 8 rows (tests/test_torch_generic.py)
    assert final is not None and jfinal is not None
    jfinal = np.asarray(jfinal, np.float64)
    assert np.abs(final.numpy() - jfinal).max() <= 2.5e-3 * np.abs(jfinal).max()
    assert np.abs(logits - jl).max() <= 5e-3 * np.abs(jl).max()


# ---------------------------------------------------------------------------
# (d) the batched verify passes and the banned chunk over a page table
# ---------------------------------------------------------------------------

GROUP_CASES = {  # lanes' params, verify passes, residual bans
    "greedy": ([GREEDY] * 3, 2, None),
    "sampled": ([GREEDY, SAMPLED, SamplingParams(temp=1.1, top_p=0.9)], 2, None),
    "banned": ([SAMPLED, GREEDY, SamplingParams(temp=0.6)], 0, [5, -1, 7]),
}


@pytest.mark.parametrize("case", GROUP_CASES)
def test_group_step_replays_paged_keys(eng, replay_cuda, jax_models, case):
    params, n_passes, ban = GROUP_CASES[case]
    eng.speculative_k = K
    pool = _pool(eng, paged_pool_pages=8)
    sessions = []
    for q in QUESTIONS:
        s = pool.new_session()
        pool.begin_chat(s, q)
        sessions.append(s)
    pos = [s.n_past for s in sessions]
    logits0 = torch.stack([s.state.logits for s in sessions])
    lane_pages, ppool = pool._try_admit_paged(sessions)
    span = n_passes * K or 8
    lane_pages = [ppool.extend(p, n + span) for p, n in zip(lane_pages, pos)]
    table = torch.from_numpy(np.stack([ppool.table_row(p) for p in lane_pages]))
    rows = lane_rows(params, eng.llm_cfg.n_vocab, "cpu")
    k0, v0 = ppool.k.clone(), ppool.v.clone()

    def run(steps):
        ppool.k.copy_(k0)
        ppool.v.copy_(v0)
        group = pool._spec_group(sessions, rows)
        if ban is not None:
            group["ban"] = list(ban)
        gens = [torch.Generator().manual_seed(100 + i) for i in range(3)]
        toks, logits = pool._group_step(group, {"k": ppool.k, "v": ppool.v}, logits0, pos,
                                        gens, 8, n_passes, [False] * 3, table, steps)
        return (toks, logits, group["hist"], group["ban"], ppool.k.clone(), ppool.v.clone(),
                [g.get_state() for g in gens])

    want = run(None)
    eng.graphs_enabled = True
    steps = pool._paged_steps(ppool)
    for _ in range(3):  # eager first use, capture and replay, replay
        got = run(steps)
        assert got[0] == want[0] and got[3] == want[3]
        for g, w in zip(got[1:3] + got[4:6], want[1:3] + want[4:6]):
            assert torch.equal(g, w)
        assert all(torch.equal(g, w) for g, w in zip(got[6], want[6]))
    width = table.shape[1]
    key = {"greedy": ("spec", 3, n_passes, K, None, width),
           "sampled": ("spec_stoch", 3, n_passes, K, None, False, width),
           "banned": ("decode_ban", 3, 8, "traced", False, width)}[case]
    assert list(steps.graphs) == [key] and steps.graphs[key].graph.replays == 2
    if case != "greedy":
        return
    (jp, jcfg), _ = jax_models
    hist = pool._spec_group(sessions, rows)["hist"]
    pool_j = {kv: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
              for kv, t in (("k", k0), ("v", v0))}
    jt, jn, _, _, _ = JaxStepFns(jcfg).paged_spec_loop(
        jp, pool_j, jnp.asarray(table.numpy()), jnp.asarray(logits0.numpy()),
        jnp.asarray(pos, jnp.int32), jnp.asarray(hist.numpy(), jnp.int32), n_passes, K)
    jt, jn = np.asarray(jt), np.asarray(jn)
    jax_ids = [[int(t) for p in range(n_passes) for t in jt[b, p, :jn[b, p]]] for b in range(3)]
    assert want[0] == jax_ids


# ---------------------------------------------------------------------------
# (e) the drafter on the engine's state
# ---------------------------------------------------------------------------

def test_drafted_dispatch_and_catchup_replay(eng, files, replay_cuda, jax_models):
    eng.set_drafter(draft_llm_path=files[2])
    st = eng._st
    n_passes = 2

    def run():
        eng.reset()
        eng.add_tokens(PROMPT)
        dfns = eng.draft_fns_for(st.n_ctx)
        ids = [engine_mod._draft_chunk(eng, dfns, st, n_passes, K) for _ in range(3)]
        return ids, st.logits.clone(), _bits(st.cache), _bits(st.dcache), st.draft_past

    want = run()
    eng.graphs_enabled = True
    for _ in range(2):  # the first run meets each key twice: eager, then captured
        got = run()
        assert got[0] == want[0] and got[4] == want[4]
        assert torch.equal(got[1], want[1])
        assert _same_bits(got[2], want[2]) and _same_bits(got[3], want[3])
    dsteps = eng._resident["own"].dsteps
    assert set(dsteps.graphs) == {("draft", n_passes, K), ("catchup", 16, None)}
    assert dsteps.graphs[("draft", n_passes, K)].graph.replays >= 3
    assert st.dcache is eng._resident["own"].bufs["dcache"]
    # JAX's drafted dispatch from the same prompt, its drafter caught up in the
    # same 16-row bucket
    (jp, jcfg), (jd, jdcfg) = jax_models
    ids = jnp.asarray([PROMPT], jnp.int32)
    jl, jc = jllama.forward(jp, jllama.init_cache(jcfg, 1, jnp.bfloat16),
                            jllama.embed_tokens(jp, ids), jnp.int32(0), jcfg)
    fns = JaxDraftFns(jcfg, jdcfg)
    jdc = fns.catchup(jd, jllama.init_cache(jdcfg, 1, jnp.bfloat16), ids, jnp.int32(0),
                      fns.attn_bucket(len(PROMPT)))
    span = n_passes * K
    jt, jn, _, _, _ = fns.spec_loop(jp, jc, jd, jdc, jl, jnp.int32(len(PROMPT)), n_passes, K,
                                    fns.attn_bucket(len(PROMPT) + span),
                                    fns.attn_bucket(len(PROMPT) + span))
    jt, jn = np.asarray(jt)[0], np.asarray(jn)[0]
    assert want[0][0] == [int(t) for p in range(n_passes) for t in jt[p, :jn[p]]]


# ---------------------------------------------------------------------------
# (f) the new steps read no host value
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small(files):
    """The decoder on the CPU, a cache of 48 prefilled positions, and page
    pools of 6 + 1 pages holding three lanes (tables of 2 + 1 slots)."""
    with LlamaFileReader(files[1]) as r:
        params, cfg = tllama.load_params(r, torch.float32, n_ctx=CTX, device="cpu")
    cache = tllama.init_cache(cfg, 1, torch.bfloat16, "cpu")
    e = np.random.default_rng(0).normal(0, 0.2, (1, 48, cfg.n_embd)).astype(np.float32)
    tllama.forward(params, cache, torch.from_numpy(e), 0, cfg, 47, attn_len=128)
    table = torch.tensor([[4, 1, 6], [0, 5, 6], [3, 2, 6]], dtype=torch.int32)
    rng = np.random.default_rng(3)
    pools = {kv: torch.from_numpy(rng.normal(0, 1, (cfg.n_layer, 7, cfg.n_head, 128,
                                                     cfg.head_dim)).astype(np.float32)
                                  ).to(torch.bfloat16) for kv in ("k", "v")}
    return params, cfg, cache, pools, table


@pytest.mark.parametrize("step", ["decode_ban", "paged_spec", "paged_spec_stoch", "draft",
                                  "catchup"])
def test_new_steps_read_no_host_value(small, fake_cuda, step):
    params, cfg, cache, pools, table = small
    v = cfg.n_vocab
    paged = step.startswith("paged") or step == "decode_ban"
    b = 3 if paged else 1
    dfns = engine_mod.DraftFns(params, cfg, "cpu")
    steps = graphs.StepGraphs(params, cfg, pools if paged else {kv: t.clone() for kv, t in
                                                               cache.items()},
                              "cpu", "pool", draft=dfns,
                              dcache={kv: t.clone() for kv, t in cache.items()})
    pos = torch.tensor([130, 20, 255] if paged else [48], dtype=torch.int32)
    logits = torch.from_numpy(np.random.default_rng(5).normal(0, 3, (b, v)).astype(np.float32))
    gens = [torch.Generator().manual_seed(i) for i in range(b)]
    rows = lane_rows([SamplingParams(temp=0.8, top_k=40, logit_bias={7: 2.0})] * b, v, "cpu")
    hist = torch.full((b, CTX), -1, dtype=torch.long)
    hist[:, :48] = torch.arange(48) % 5
    ban = torch.tensor([7, -1, 3][:b])
    ids = torch.tensor([[5, 9, -1, -1, 12, 3, -1, 8]])
    tab = table if paged else None
    with _no_host_reads():
        if step == "decode_ban":
            out = steps.decode_chunk(logits, pos, 3, gens, rows, tab, ban=ban, capture=True)[1]
        elif step == "paged_spec":
            out = steps.spec_chunk(logits, pos, hist, 2, K, tab, capture=True)[2]
        elif step == "paged_spec_stoch":
            out = steps.spec_chunk_stoch(logits, pos, hist, ban, 2, K, gens, rows, tab,
                                         capture=True)[2]
        elif step == "draft":
            out = steps.draft_chunk(logits, pos, 2, K, capture=True)[2]
        else:
            steps.catchup(ids, pos, 128, capture=True)
            out = steps.dcache["k"]
    assert len(fake_cuda) == 1 and torch.isfinite(out.float()).all()
