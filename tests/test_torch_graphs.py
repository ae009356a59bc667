"""The port's captured steps on the CPU: device cursors, no host reads, the
graph cache's keys and launch accounting, and the warmup CLI.

CUDA graphs exist only on the card (``tests/test_torch_cuda.py`` holds
captured steps to eager ones there).  Here:

(a) ``llama.forward`` with the cursor as an i32 [B] tensor gives the int
    (or per-row list) cursor's logits and cache bit for bit: S = 1, an
    8-row bucket, a 40-row chunk (S > 32), per-row cursors for B = 3 and
    the paged pool.
(b) The steps a graph captures (decode chunk, single step, prefill) run on
    CPU tensors with ``Tensor.item``, ``Tensor.tolist``, ``Tensor.cpu``,
    ``Tensor.__bool__``, ``torch.tensor``, indexing by a 0-d tensor and the
    store of a Python number into a tensor made to raise: they read no host
    value.
(c) ``engine/graphs.py`` with a stand-in for ``torch.cuda.CUDAGraph``: a
    key's first use runs eagerly, its second captures, one capture per key,
    the keys those of the JAX jit's static arguments (one traced sampling
    key per lane count, whatever the lanes' configs), every replay adds the
    launch counts the capture saw, a replay lends the lanes' generator
    states to the graph's slots and takes them back, and
    ``SessionPool.warmup`` captures the paged group's keys for each lane
    count without writing a lane's page.
(d) The decode chunk from a device cursor against JAX's ``decode_loop`` on
    the 4-layer Q5_K_M fixture: greedy ids equal, final logits within
    2.5e-3 of max|logit| (the fixture's decode bound, ROADMAP Queue 3).
(e) The sampling chain with scalar thresholds gives the tensor-threshold
    form's bits for every chain setting, and the traced chain (thresholds
    as device tensors, every stage under a guard) gives the static chain's
    bits and draws; ``lane_rows`` takes the static form only for all-greedy
    lanes without a bias.
(f) ``python -m minigpt4_tpu_torch.warmup``: ``--help`` and its refusals.
"""

import contextlib
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fixtures import GQ_D, build_container, build_gq_models, build_llm_gq
from minigpt4_tpu.engine.device_sampling import DeviceSamplingConfig as JaxSampling
from minigpt4_tpu.formats import LlamaFileReader
from minigpt4_tpu.models import llama as jllama
from minigpt4_tpu_torch import interop
from minigpt4_tpu_torch.engine import device_sampling as tds
from minigpt4_tpu_torch.engine import graphs
from minigpt4_tpu_torch.engine import engine as engine_mod
from minigpt4_tpu_torch.engine.device_sampling import DeviceSamplingConfig, LaneRows
from minigpt4_tpu_torch.engine.sampling import SamplingParams
from minigpt4_tpu_torch.engine.sessions import SessionPool
from minigpt4_tpu_torch.models import llama as tllama
from minigpt4_tpu_torch.ops import counters
from minigpt4_tpu_torch.ops import flash_decode as tfd
from minigpt4_tpu_torch.ops import group_i8 as tgq
from minigpt4_tpu_torch.ops.flash_decode import PAGE
from test_torch_fixtures import build_llm_q5_k_m

ROOT = Path(__file__).resolve().parent.parent
N_CTX = 256
GREEDY = DeviceSamplingConfig(temp=0.0)
# every step of the chain: top-k, tail-free, typical, top-p, temperature
FULL_CHAIN = DeviceSamplingConfig(temp=0.8, top_k=40, top_p=0.9, tfs_z=0.97, typical_p=0.95)


@pytest.fixture(scope="module")
def gq(tmp_path_factory):
    """The 2-layer gq decoder (q5_k projections) on the CPU."""
    path = build_llm_gq(tmp_path_factory.mktemp("torch_graphs") / "vicuna-gq.bin",
                        np.random.default_rng(42))
    with LlamaFileReader(path) as r:
        return tllama.load_params(r, torch.float32, n_ctx=N_CTX, device="cpu")


def _emb(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(0, 0.2, (b, s, cfg.n_embd)).astype(np.float32))


def _history(params, cfg, b=1, dtype=torch.bfloat16):
    """A cache of B rows holding 48 prefilled positions."""
    cache = tllama.init_cache(cfg, b, dtype, "cpu")
    tllama.forward(params, cache, _emb(cfg, b, 48, 0), 0, cfg, 47, attn_len=128)
    return cache


def _paged(params, cfg):
    """Page pools of 6 + 1 pages holding 3 lanes' histories at 130, 20 and
    255 positions (tables of 2 + 1 slots), and their dense twin."""
    dense = tllama.init_cache(cfg, 3, torch.bfloat16, "cpu")
    rng = np.random.default_rng(3)
    for kv in ("k", "v"):
        dense[kv].copy_(torch.from_numpy(rng.normal(0, 1, dense[kv].shape).astype(np.float32)))
    table = np.array([[4, 1, 6], [0, 5, 6], [3, 2, 6]], np.int32)
    pools = {kv: torch.zeros((cfg.n_layer, 7, cfg.n_head, PAGE, cfg.head_dim),
                             dtype=torch.bfloat16) for kv in ("k", "v")}
    for b in range(3):
        for i in range(2):
            for kv in ("k", "v"):
                pools[kv][:, table[b, i]] = dense[kv][:, b, :, i * PAGE:(i + 1) * PAGE]
    return pools, torch.from_numpy(table)


def _clone(cache):
    return {kv: t.clone() for kv, t in cache.items()}


CURSOR_CASES = {
    "s1": (1, 1, 48), "s8": (1, 8, 48), "s40": (1, 40, 48),
    "rows3": (3, 1, [5, 100, 255]), "paged": (3, 1, [130, 20, 255]),
}


@pytest.mark.parametrize("case", CURSOR_CASES)
def test_device_cursor_forward_is_bit_equal(gq, case):
    params, cfg = gq
    b, s, pos = CURSOR_CASES[case]
    table = None
    if case == "paged":
        cache, table = _paged(params, cfg)
    else:
        cache = _history(params, cfg, b)
    e = _emb(cfg, b, s, 1)
    kw = dict(attn_len=128, page_table=table)
    host, dev = _clone(cache), _clone(cache)
    want = tllama.forward(params, host, e, pos, cfg, s - 1, **kw)
    pos_t = torch.tensor(pos if isinstance(pos, list) else [pos], dtype=torch.int32)
    last = torch.tensor([s - 1])
    got = tllama.forward(params, dev, e, pos_t, cfg, last, **kw)
    assert torch.equal(got, want)
    for kv in ("k", "v"):
        assert torch.equal(dev[kv], host[kv]), kv
        assert not torch.equal(dev[kv], cache[kv]), kv  # the positions were written


class _HostRead(AssertionError):
    pass


@contextlib.contextmanager
def _no_host_reads():
    """Make every way of reading a tensor on the host, or of copying host
    data into one, raise: on the card each is a copy that a capture
    refuses (a 0-d tensor used as an index is read on the host, a Python
    number stored into a tensor element is copied from it)."""
    def refuse(*a, **k):
        raise _HostRead("a captured step read a host value")

    getitem, setitem = torch.Tensor.__getitem__, torch.Tensor.__setitem__

    def host_index(index):  # a 0-d tensor index is read on the host
        parts = index if isinstance(index, tuple) else (index,)
        return any(isinstance(i, torch.Tensor) and i.dim() == 0 for i in parts)

    def load(t, index):
        if host_index(index):
            refuse()
        return getitem(t, index)

    def store(t, index, value):
        if host_index(index) or not isinstance(value, torch.Tensor):
            refuse()
        setitem(t, index, value)

    with pytest.MonkeyPatch.context() as mp:
        for name in ("item", "tolist", "cpu", "__bool__"):
            mp.setattr(torch.Tensor, name, refuse)
        mp.setattr(torch.Tensor, "__getitem__", load)
        mp.setattr(torch.Tensor, "__setitem__", store)
        mp.setattr(torch, "tensor", refuse)
        yield


class _FakeGraph:
    """Stand-in for torch.cuda.CUDAGraph: counts captures and replays; a
    replay draws once from each registered generator, as a captured draw
    advances it."""

    def __init__(self):
        self.replays = 0
        self.generators = []

    def register_generator_state(self, gen):
        self.generators.append(gen)

    def replay(self):
        self.replays += 1
        for g in self.generators:
            torch.rand(1, generator=g)


class _FakeStream:
    def __init__(self, device=None):
        pass

    def wait_stream(self, other):
        pass


@pytest.fixture
def fake_cuda(monkeypatch):
    """torch.cuda's graph API stood in for on the CPU: a capture runs its
    step eagerly inside the context and records the graph."""
    captured = []

    @contextlib.contextmanager
    def graph(g, pool=None, stream=None, capture_error_mode="global"):
        assert capture_error_mode == "thread_local" and pool == "pool"
        captured.append(g)
        yield

    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    monkeypatch.setattr(torch.cuda, "Stream", _FakeStream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _FakeStream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    monkeypatch.setattr(engine_mod, "pool_bytes", lambda pool: 0)
    return captured


def _rows(cfgs, bias=None):
    return LaneRows(tuple(cfgs), bias)


@pytest.mark.parametrize("step", ["decode_chunk", "step", "prefill", "paged_decode_chunk",
                                  "traced_decode_chunk"])
def test_captured_steps_read_no_host_value(gq, fake_cuda, step):
    params, cfg = gq
    v = cfg.n_vocab
    if step == "paged_decode_chunk":
        cache, table = _paged(params, cfg)
    else:
        cache, table = _history(params, cfg), None
    steps = graphs.StepGraphs(params, cfg, cache, "cpu", "pool")
    b = 3 if table is not None else 1
    pos = torch.tensor([130, 20, 255] if b == 3 else [48], dtype=torch.int32)
    logits = torch.from_numpy(np.random.default_rng(5).normal(0, 3, (b, v)).astype(np.float32))
    bias = torch.zeros((b, v))
    bias[:, 7] = 4.0
    gens = [torch.Generator().manual_seed(i) for i in range(b)]
    rows = _rows([FULL_CHAIN, GREEDY, FULL_CHAIN][:b], bias)
    if step == "traced_decode_chunk":
        rows = tds.lane_rows([SamplingParams(temp=0.8, tfs_z=0.97, typical_p=0.95,
                                             logit_bias={7: 4.0})], v, "cpu")
    ids = torch.zeros((b, 1), dtype=torch.long)
    with _no_host_reads():
        if step == "step":
            out = steps.step(ids, pos, capture=True)
        elif step == "prefill":
            out = steps.prefill(_emb(cfg, 1, 40, 2), pos, 33, 128, capture=True)
        else:
            out, _ = steps.decode_chunk(logits, pos, 3, gens, rows, table, capture=True)
    assert len(fake_cuda) == 1 and torch.isfinite(out.float()).all()


def test_graph_cache_keys_are_jax_static_arguments(gq, fake_cuda):
    params, cfg = gq
    v = cfg.n_vocab
    cache = _history(params, cfg)
    steps = graphs.StepGraphs(params, cfg, cache, "cpu", "pool")
    gen = torch.Generator().manual_seed(0)
    logits = torch.zeros((1, v))
    greedy = tds.lane_rows([SamplingParams(temp=0.0, top_k=7)], v, "cpu")
    # two sampling configs: one traced key
    sampled = [tds.lane_rows([SamplingParams(temp=t, top_p=q)], v, "cpu")
               for t, q in ((0.8, 0.9), (0.5, 1.0))]
    assert greedy.configs == (GREEDY,) and greedy.traced is None

    def use(p, rows_sampled):
        steps.prefill(_emb(cfg, 1, 8, 3), p, 5, 128)
        steps.prefill(_emb(cfg, 1, 40, 3), p, 39, 128)
        steps.step(torch.zeros((1, 1), dtype=torch.long), p)
        steps.decode_chunk(logits, p, 4, [gen], greedy)
        steps.decode_chunk(logits, p, 4, [gen], rows_sampled)

    use(48, sampled[0])  # first use: eager, nothing captured
    assert steps.graphs == {} and len(steps.seen) == 5 and not fake_cuda
    use(60, sampled[1])  # second use, at another cursor and config: captured
    use(72, sampled[0])  # third: replayed, never captured
    biased = tds.lane_rows([SamplingParams(temp=0.0, logit_bias={3: 1.0})], v, "cpu")
    steps.decode_chunk(logits, 80, 4, [gen], biased)
    steps.prefill(_emb(cfg, 1, 40, 3), 100, 39, 256)  # met once: eager
    assert set(steps.graphs) == {
        ("prefill", 8, None), ("prefill", 40, 128), ("step", 1),
        ("decode", 1, 4, (GREEDY,), False, None), ("decode", 1, 4, "traced", False, None)}
    assert len(fake_cuda) == len(steps.graphs) == 5
    assert {("decode", 1, 4, "traced", True, None), ("prefill", 40, 256)} <= steps.seen
    # only the traced graph holds a generator slot
    for key, g in steps.graphs.items():
        assert len(g.graph.generators) == (key[:1] == ("decode",) and key[3] == "traced")
    pools, table = _paged(params, cfg)
    paged = graphs.StepGraphs(params, cfg, pools, "cpu", "pool")
    for n_lanes in (2, 3, 2, 3, 2):  # one graph per lane count and form
        for temps in ((0.0, 0.0, 0.0), (0.0, 0.7, 0.9)):
            rows = tds.lane_rows([SamplingParams(temp=t) for t in temps[:n_lanes]], v, "cpu")
            paged.decode_chunk(torch.zeros((n_lanes, v)), [130, 20, 255][:n_lanes], 2,
                               [gen] * n_lanes, rows, table[:n_lanes])
    assert set(paged.graphs) == {("decode", n, 2, form, False, 3) for n in (2, 3)
                                 for form in ((GREEDY,) * n, "traced")}


def test_replays_add_the_captured_launch_counts(fake_cuda):
    cache = graphs.GraphCache("cpu", "pool")
    x = torch.arange(4.0)

    def step(inp, _):
        tfd.flash_decode_attention.launches += 2
        tgq.gq_decode.packed_launches["p5"] += 1
        return (inp["x"] * 2,)

    fd = ("flash_decode", "launches", None)
    p5 = ("gq_decode", "packed_launches", "p5")
    before = counters.counts()
    cache.run("k", step, {"x": x})  # first use: eager, launches (2, 1)
    out = cache.run("k", step, {"x": x})[0]
    after = counters.counts()
    # the first use (2, 1); then the eager run before the capture (2, 1),
    # the capture taken back, and the first replay (2, 1)
    assert (after[fd] - before[fd], after[p5] - before[p5]) == (6, 3)
    assert cache.graphs["k"].delta == {fd: 2, p5: 1}
    for i in range(3):
        cache.run("k", step, {"x": x + i})
    final = counters.counts()
    assert (final[fd] - after[fd], final[p5] - after[p5]) == (6, 3)
    assert len(fake_cuda) == 1 and cache.graphs["k"].graph.replays == 4
    # a call hands back copies: the static output stays the graph's
    out.fill_(-1)
    assert torch.equal(cache.graphs["k"].outputs[0], x * 2)
    # the static input holds the last feed
    assert torch.equal(cache.graphs["k"].inputs["x"], x + 2)


def test_replay_lends_the_lane_generators(fake_cuda):
    cache = graphs.GraphCache("cpu", "pool")
    lane, twin = torch.Generator().manual_seed(11), torch.Generator().manual_seed(11)

    def step(inp, gens):
        return (torch.rand(3, generator=gens[0]),)

    first = cache.run("k", step, {"x": torch.zeros(1)}, [lane])[0]  # eager, the lane draws
    assert torch.equal(first, torch.rand(3, generator=twin))
    cache.run("k", step, {"x": torch.zeros(1)}, [lane])
    # the eager run before the capture drew from the slot, the replay once
    # more: the lane moved by the replay's draw alone
    torch.rand(1, generator=twin)
    assert torch.equal(lane.get_state(), twin.get_state())
    cache.run("k", step, {"x": torch.zeros(1)}, [lane])
    torch.rand(1, generator=twin)
    assert torch.equal(lane.get_state(), twin.get_state())
    slot = cache.graphs["k"].slots[0]
    assert slot is not lane and torch.equal(slot.get_state(), lane.get_state())


def test_session_pool_warmup_captures_each_lane_count(fake_cuda, tmp_path):
    """SessionPool.warmup on the CPU with the stand-in graphs: the greedy and
    the traced decode chunk of the paged group for each lane count, captured
    at once, every write on the trash page; a group afterwards replays."""
    pool = SessionPool(*build_gq_models(tmp_path), paged_pool_pages=4, device="cpu",
                       session_ctx=256, n_ctx=256, n_batch=32)
    try:
        eng, pages = pool.engine, pool.paged_pool
        with pytest.raises(RuntimeError, match="runs eagerly"):
            pool.warmup()
        eng.graphs_enabled = True
        k0, v0 = pages.k.clone(), pages.v.clone()
        stats = pool.warmup(lanes=(1, 3), decode_chunk=4)
        w = pages.maxp + 1
        assert set(stats["keys"]) == {("decode", b, 4, form, False, w) for b in (1, 3)
                                      for form in ((GREEDY,) * b, "traced")}
        assert stats["graphs"] == len(fake_cuda) == 4 and stats["warmup_s"] > 0
        real = slice(0, pages.trash_page)
        assert torch.equal(pages.k[:, real], k0[:, real])
        assert torch.equal(pages.v[:, real], v0[:, real])
        assert not torch.equal(pages.k, k0)  # the trash page took the writes
        sessions = []
        for q in ("one two", "three four five", "six"):
            s = pool.new_session()
            pool.begin_chat(s, q)
            sessions.append(s)
        pool.generate_batch(sessions, limit=4, params=[SamplingParams(temp=0.0),
                                                       SamplingParams(temp=0.8),
                                                       SamplingParams(temp=0.5, top_k=3)],
                            decode_chunk=4)
        assert len(fake_cuda) == 4  # replayed the traced graph of 3 lanes
        assert pool._paged_graphs.graphs[("decode", 3, 4, "traced", False, w)].graph.replays >= 1
    finally:
        pool.close()


@pytest.fixture(scope="module")
def km(tmp_path_factory):
    """The 4-layer Q5_K_M fixture, loaded by both packages with JAX's weights."""
    d = tmp_path_factory.mktemp("torch_graphs_km")
    rng = np.random.default_rng(7)
    build_container(d / "minigpt4-gq.bin", rng, llm_d=GQ_D)
    llm = build_llm_q5_k_m(d / "vicuna-q5_k_m.bin", rng)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MINIGPT4_TPU_GQ_PACK", "0")  # interop maps unpacked codes
        with LlamaFileReader(llm) as r:
            jparams, jcfg = jllama.load_params(r, jnp.float32, n_ctx=N_CTX, quant_mode="gq")
            tcfg = tllama.LlamaConfig.from_hparams(r.hparams, n_ctx=N_CTX)
    tparams = interop.llama_params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    return jparams, jcfg, tparams, tcfg


def test_device_cursor_decode_chunk_matches_jax(km):
    jparams, jcfg, tparams, tcfg = km
    e = np.random.default_rng(1).normal(0, 0.2, (1, 40, tcfg.n_embd)).astype(np.float32)
    jl, jcache = jllama.forward(jparams, jllama.init_cache(jcfg, 1, jnp.bfloat16),
                                jnp.asarray(e), jnp.int32(0), jcfg, jnp.int32(39), attn_len=128)
    tcache = tllama.init_cache(tcfg, 1, torch.bfloat16, "cpu")
    tl = tllama.forward(tparams, tcache, torch.from_numpy(e), 0, tcfg, 39, attn_len=128)
    jtoks, jfinal, _ = jllama.decode_loop(jparams, jcache, jl, jnp.int32(40), 6,
                                          jax.random.PRNGKey(0), JaxSampling(temp=0.0), jcfg,
                                          attn_len=128)
    ttoks, tfinal = tllama.decode_loop(tparams, tcache, tl, torch.tensor([40], dtype=torch.int32),
                                       6, [torch.Generator()], _rows([GREEDY]), tcfg)
    assert ttoks.tolist() == np.asarray(jtoks).tolist()
    want = np.asarray(jfinal, np.float64)
    assert np.abs(tfinal.numpy() - want).max() <= 2.5e-3 * np.abs(want).max()


CHAINS = [
    dict(temp=0.8, top_k=40, top_p=1.0, tfs_z=1.0, typical_p=1.0),
    dict(temp=0.7, top_k=0, top_p=0.9, tfs_z=1.0, typical_p=1.0),
    dict(temp=1.0, top_k=0, top_p=1.0, tfs_z=0.95, typical_p=1.0),
    dict(temp=1.0, top_k=0, top_p=1.0, tfs_z=1.0, typical_p=0.9),
    dict(temp=0.8, top_k=40, top_p=0.9, tfs_z=0.97, typical_p=0.95),
    dict(temp=0.5, top_k=5, top_p=0.5, tfs_z=0.5, typical_p=0.5),
]


@pytest.mark.parametrize("cfg", CHAINS, ids=lambda c: "-".join(f"{v}" for v in c.values()))
def test_scalar_thresholds_bit_equal_to_tensor_form(cfg, monkeypatch):
    v = 1000
    rng = np.random.default_rng(2)
    logits = torch.from_numpy(rng.normal(0, 3, v).astype(np.float32))
    c = tds.DeviceSamplingConfig(**cfg)
    got = tds.chain_sorted(logits, c)
    gen = torch.Generator().manual_seed(4)
    draws = [int(tds.sample_token(logits, gen, c)) for _ in range(20)]
    searchsorted = torch.searchsorted

    def tensor_form(sorted_seq, value, **kw):
        if not isinstance(value, torch.Tensor):
            value = torch.tensor(value, device=sorted_seq.device)  # f32, as before
        return searchsorted(sorted_seq, value, **kw)

    monkeypatch.setattr(torch, "searchsorted", tensor_form)
    want = tds.chain_sorted(logits, c)
    gen = torch.Generator().manual_seed(4)
    assert draws == [int(tds.sample_token(logits, gen, c)) for _ in range(20)]
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # at a threshold that lies on an f32 cumulative sum
    seq = torch.tensor([0.25, 0.5, 0.949999988079071, 1.0])
    for t in (0.95, 0.5, 0.9):
        assert searchsorted(seq, t) == tensor_form(seq, t)


@pytest.mark.parametrize("cfg", CHAINS + [dict(temp=0.0, top_k=40, top_p=0.9, tfs_z=1.0,
                                                 typical_p=1.0)],
                         ids=lambda c: "-".join(f"{v}" for v in c.values()))
@pytest.mark.parametrize("with_bias", [False, True])
def test_traced_chain_is_the_static_chain(cfg, with_bias):
    v = 1000
    rng = np.random.default_rng(3)
    logits = torch.from_numpy(rng.normal(0, 3, v).astype(np.float32))
    bias = None
    if with_bias:
        bias = torch.zeros(v)
        bias[[5, 17, 999]] = torch.tensor([8.0, -100.0, 2.5])
    c = tds.DeviceSamplingConfig(**cfg)
    thresholds = [torch.tensor(cfg[name], dtype=torch.long if name == "top_k" else torch.float32)
                  for name in tds.TRACED]
    order, scaled = tds.chain_sorted_traced(logits, *thresholds, bias)
    if c.greedy:  # the static chain divides by a positive temperature only
        want_order, want_scaled = tds.chain_sorted(logits, dataclasses.replace(c, temp=1.0), bias)
    else:
        want_order, want_scaled = tds.chain_sorted(logits, c, bias)
    assert torch.equal(order, want_order) and torch.equal(scaled, want_scaled)
    gen_a, gen_b = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
    got = [int(tds.sample_token_traced(logits, gen_a, *thresholds, bias)) for _ in range(20)]
    want = []
    for _ in range(20):
        want.append(int(tds.sample_token(logits, gen_b, c, bias)))
        if c.greedy:
            torch.rand(v, generator=gen_b)  # the traced form draws on a greedy lane too
    assert got == want


def test_lane_rows_static_only_for_plain_greedy():
    v = 16
    plain = tds.lane_rows([SamplingParams(temp=0.0), SamplingParams(temp=-1.0, top_k=3)], v,
                          "cpu")
    assert plain.traced is None and plain.bias is None and plain.key == (GREEDY, GREEDY)
    for params in ([SamplingParams(temp=0.0), SamplingParams(temp=0.8)],
                   [SamplingParams(temp=0.0, logit_bias={2: 1.0})]):
        rows = tds.lane_rows(params, v, "cpu")
        assert rows.key == "traced"
        assert rows.traced["temp"].tolist() == pytest.approx([p.temp for p in params])
        assert rows.traced["top_k"].dtype == torch.long
    logits = torch.from_numpy(np.random.default_rng(6).normal(0, 2, (2, v)).astype(np.float32))
    rows = tds.lane_rows([SamplingParams(temp=0.0), SamplingParams(temp=0.8, top_k=1)], v, "cpu")
    gens = [torch.Generator().manual_seed(i) for i in range(2)]
    assert tds.sample_rows(logits, gens, rows).tolist() == logits.argmax(-1).tolist()


def _warmup(*args):
    return subprocess.run([sys.executable, "-m", "minigpt4_tpu_torch.warmup", *args],
                          capture_output=True, text=True, cwd=ROOT, timeout=120)


@pytest.mark.parametrize("args,rc,says", [
    (["--help"], 0, "--quant-mode"),
    (["-m", "x.bin", "-l", "y.bin", "--tp", "2"], 2, "ROADMAP Queue 1, item 11"),
    (["-m", "x.bin", "-l", "y.bin", "--speculative-k", "8"], 2, "ROADMAP Queue 1, item 14"),
], ids=["help", "tp", "speculative"])
def test_warmup_cli(args, rc, says):
    out = _warmup(*args)
    assert out.returncode == rc, out.stderr
    assert says in out.stdout + out.stderr
    if args == ["--help"]:
        for flag in ("-m", "-l", "--n-ctx", "--cache-dtype", "--tp", "--speculative-k"):
            assert flag in out.stdout
