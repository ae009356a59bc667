"""Context shift on the port against the JAX package: ``shift_kv_cache`` on
f32, bf16 and e4m3 caches against JAX's ``llama.shift_kv_cache`` (the same
input bits on both sides), the one-layer model where a shift is exact (as
tests/test_ctx_shift.py), the engine and a ``SessionPool`` chat that shift
against the JAX engine and pool (greedy ids, ``n_past`` and history across
at least two shifts), the mirostat path, ``context_shift=False`` and the
cache tensors' storage.

Tolerances: V rows and the rows that only move are bit-equal; the
re-rotated K rows are within 1e-6 of max|k| on f32 and within one unit in
the last place on bf16 and e4m3 (each side computes cos/sin of -drop times
the RoPE frequencies with its own libm).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fixtures import build_tiny_models
from minigpt4_tpu.engine import MiniGPT4Engine as JaxEngine
from minigpt4_tpu.engine import SamplingParams as JaxParams
from minigpt4_tpu.engine.sessions import SessionPool as JaxPool
from minigpt4_tpu.models import llama as jllama
from minigpt4_tpu_torch import interop
from minigpt4_tpu_torch.engine import MiniGPT4Engine, SamplingParams
from minigpt4_tpu_torch.engine.sessions import SessionPool
from minigpt4_tpu_torch.models import llama as tllama

# one intra-op thread: the suite runs several pytest-xdist workers on the same cores, where
# torch's OpenMP pools spin against each other and run ~17x slower
torch.set_num_threads(1)

L, H, C, DH = 2, 4, 64, 16
CFG_T = tllama.LlamaConfig(n_vocab=96, n_embd=H * DH, n_head=H, n_layer=L, n_rot=DH,
                           n_ff=128, n_ctx=C)
CFG_J = jllama.LlamaConfig(n_vocab=96, n_embd=H * DH, n_head=H, n_layer=L, n_rot=DH,
                           n_ff=128, n_ctx=C)
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16),
          "e4m3": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}
# (keep, drop, n_past): a plain shift, no keep prefix, drop 0, keep = n_past,
# the whole rest dropped, and a full cache (every source index clamped past C - drop)
CASES = [(5, 7, 24), (0, 10, 40), (5, 0, 24), (24, 0, 24), (9, 31, 40), (12, 26, 64)]


def _to_torch(a) -> torch.Tensor:
    """A JAX array's bits as a torch tensor of the same type."""
    a = np.asarray(a)
    if a.dtype.itemsize == 4:
        return torch.from_numpy(a.copy())
    bits = {1: np.uint8, 2: np.int16}[a.dtype.itemsize]
    t = torch.from_numpy(a.view(bits).copy())
    return t.view(torch.bfloat16 if a.dtype.itemsize == 2 else torch.float8_e4m3fn)


def _bits(t: torch.Tensor) -> np.ndarray:
    return tllama._bits(t).numpy().astype(np.int64)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("keep,drop,n_past", CASES)
def test_shift_kv_cache_matches_jax(dtype, keep, drop, n_past):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(keep * 100 + drop)
    scale = 3.0 if dtype != "e4m3" else 20.0
    k = jnp.asarray(rng.normal(0, scale, (L, 1, H, C, DH)).astype(np.float32), jdt)
    v = jnp.asarray(rng.normal(0, scale, (L, 1, H, C, DH)).astype(np.float32), jdt)
    want = jllama.shift_kv_cache({"k": k, "v": v}, jnp.int32(keep), jnp.int32(drop),
                                 jnp.int32(n_past), CFG_J)
    cache = {"k": _to_torch(k), "v": _to_torch(v)}
    ptrs = {kv: t.data_ptr() for kv, t in cache.items()}
    got = tllama.shift_kv_cache(cache, keep, drop, n_past, CFG_T)
    assert got is cache and {kv: t.data_ptr() for kv, t in cache.items()} == ptrs
    wk, wv = _to_torch(want["k"]), _to_torch(want["v"])
    assert np.array_equal(_bits(cache["v"]), _bits(wv))
    moved = np.zeros(C, bool)
    moved[keep:max(keep, n_past - drop)] = drop > 0
    gk, ek = _bits(cache["k"]), _bits(wk)
    assert np.array_equal(gk[..., ~moved, :], ek[..., ~moved, :])
    if dtype == "f32":
        d = (cache["k"] - wk).abs().max().item()
        assert d <= 1e-6 * wk.abs().max().item(), d
    else:  # same sign, at most one unit in the last place apart
        assert np.abs(gk[..., moved, :] - ek[..., moved, :]).max(initial=0) <= 1


def _dense_params(cfg, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)

    def lin(n_in, n_out, lead=(cfg.n_layer,)):
        return {"w": (rng.normal(0, 0.05, (*lead, n_in, n_out))).astype(np.float32)}

    d, ff = cfg.n_embd, cfg.n_ff
    return {"tok_embeddings": rng.normal(0, 0.3, (cfg.n_vocab, d)).astype(np.float32),
            "norm": np.ones(d, np.float32), "output": lin(d, cfg.n_vocab, lead=()),
            "layers": {"attention_norm": np.ones((cfg.n_layer, d), np.float32),
                       "ffn_norm": np.ones((cfg.n_layer, d), np.float32),
                       "wqkv": lin(d, 3 * d), "wo": lin(d, d), "w13": lin(d, 2 * ff),
                       "w2": lin(ff, d)}}


def test_shift_exact_on_one_layer_model():
    """One layer: K/V of layer 0 depend on their own token only, so a shift
    equals prefilling the surviving tokens alone, next logits included."""
    cfg = tllama.LlamaConfig(n_vocab=96, n_embd=64, n_head=4, n_layer=1, n_rot=16, n_ff=128,
                             n_ctx=64)
    params = interop.llama_params_from_numpy(_dense_params(cfg), "cpu")
    toks = np.random.default_rng(1).integers(0, cfg.n_vocab, 20)
    keep, drop, n_past = 4, 6, 20

    def prefill(ids):
        cache = tllama.init_cache(cfg, 1, torch.float32, "cpu")
        tllama.forward(params, cache, tllama.embed_tokens(params, torch.tensor(ids)[None]), 0, cfg)
        return cache

    with torch.no_grad():
        shifted = tllama.shift_kv_cache(prefill(toks), keep, drop, n_past, cfg)
        alone = prefill(np.concatenate([toks[:keep], toks[keep + drop:]]))
        live = n_past - drop
        for kv in ("k", "v"):
            torch.testing.assert_close(shifted[kv][:, :, :, :live], alone[kv][:, :, :, :live],
                                       rtol=2e-5, atol=2e-5)
        nxt = tllama.embed_tokens(params, torch.tensor([[int(toks[-1])]]))
        la = tllama.forward(params, shifted, nxt, live, cfg)
        lb = tllama.forward(params, alone, nxt, live, cfg)
    torch.testing.assert_close(la, lb, rtol=5e-5, atol=5e-5)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return build_tiny_models(tmp_path_factory.mktemp("torch_ctx_shift"))


def _count_shifts(eng) -> list:
    """Record (dropped, n_past after) of every ``eng.ctx_shift`` call."""
    shifts = []
    shift = eng.ctx_shift

    def counted(st, need=0):
        d = shift(st, need)
        shifts.append((d, st.n_past))
        return d

    eng.ctx_shift = counted
    return shifts


def _shift_chat(engine_cls, params_cls, model, llm, **kw):
    """A text chat on a 200-position context with shifting on: 80 greedy
    tokens (two shifts inside generate), a second turn whose prefill shifts,
    20 more tokens.  Returns what each step left and the shifts' sizes."""
    eng = engine_cls(model, llm, n_ctx=200, n_batch=32, context_shift=True, **kw)
    shifts = _count_shifts(eng)
    try:
        eng.system_prompt()
        eng.begin_chat("hi")
        first = list(eng.generate(limit=80, params=params_cls(temp=0.0)))
        after_first = (eng.n_past, list(eng._st.tokens))
        eng.begin_chat("and then?")
        after_prompt = (eng.n_past, list(eng._st.tokens))
        second = list(eng.generate(limit=20, params=params_cls(temp=0.0)))
        return dict(first=first, second=second, after_first=after_first,
                    after_prompt=after_prompt, end=(eng.n_past, list(eng._st.tokens)),
                    n_keep=eng._st.n_keep, shifts=shifts)
    finally:
        eng.close()


def test_engine_shift_matches_jax_engine(tiny):
    got = _shift_chat(MiniGPT4Engine, SamplingParams, *tiny, device="cpu")
    want = _shift_chat(JaxEngine, JaxParams, *tiny)
    assert len([d for d, _ in got["shifts"] if d > 0]) >= 3  # two in generate, one in prefill
    assert got == want
    assert got["end"][1][:got["n_keep"]] == want["end"][1][:want["n_keep"]]
    assert len(got["end"][1]) == got["end"][0] <= 200


def test_no_shift_raises_context_overflow(tiny):
    """Without context_shift a prefill past the context raises and generate
    stops at its end, as before."""
    eng = MiniGPT4Engine(*tiny, n_ctx=200, n_batch=32, device="cpu")
    try:
        eng.system_prompt()
        eng.begin_chat("hi")
        toks = list(eng.generate(limit=80, params=SamplingParams(temp=0.0)))
        assert eng.n_past == 200 and len(toks) < 80
        with pytest.raises(ValueError, match="context overflow"):
            eng.begin_chat("and then?")
    finally:
        eng.close()


def test_shift_keeps_the_cache_tensors(tiny):
    """The shift writes into the state's own cache tensors (captured CUDA
    graphs replay on their addresses), and leaves the keep prefix."""
    eng = MiniGPT4Engine(*tiny, n_ctx=200, n_batch=32, device="cpu", context_shift=True)
    try:
        eng.system_prompt()
        eng.begin_chat("tell me more about it")
        cache = dict(eng._st.cache)
        ptrs = {kv: t.data_ptr() for kv, t in cache.items()}
        keep_rows = {kv: t[:, :, :, :eng._st.n_keep].clone() for kv, t in cache.items()}
        n0 = eng.n_past
        dropped = eng.ctx_shift(None, 0)
        assert dropped == (n0 - eng._st.n_keep) // 2 and eng.n_past == n0 - dropped
        assert all(eng._st.cache[kv] is cache[kv] for kv in cache)
        assert {kv: t.data_ptr() for kv, t in eng._st.cache.items()} == ptrs
        for kv, rows in keep_rows.items():
            assert torch.equal(eng._st.cache[kv][:, :, :, :eng._st.n_keep], rows)
    finally:
        eng.close()


def _pool_chat(pool_cls, params_cls, model, llm, **kw):
    """An image chat of one session on a 224-position session context:
    shifts in generate, then a second turn."""
    pool = pool_cls(model, llm, session_ctx=224, n_ctx=256, n_batch=32, context_shift=True, **kw)
    shifts = _count_shifts(pool.engine)
    try:
        s = pool.new_session()
        img = np.random.default_rng(0).integers(0, 255, (40, 50, 3), dtype=np.uint8)
        s.upload_image(_pre(pool, img))
        s.ask("what is it?")
        keep = s.state.n_keep
        first = list(s.generate(limit=60, params=params_cls(temp=0.0)))
        mid = (s.n_past, list(s.state.tokens))
        s.ask("and then?")
        second = list(s.generate(limit=12, params=params_cls(temp=0.0)))
        return dict(keep=keep, first=first, mid=mid, second=second,
                    end=(s.n_past, list(s.state.tokens)), shifts=shifts)
    finally:
        pool.close()


def _pre(pool, img):
    from minigpt4_tpu_torch.image import preprocess

    return preprocess(img, size=pool.engine.vision_cfg.vit.image_size)


def test_session_pool_shift_matches_jax_pool(tiny):
    got = _pool_chat(SessionPool, SamplingParams, *tiny, device="cpu")
    want = _pool_chat(JaxPool, JaxParams, *tiny, prefix_cache=False)
    assert got["keep"] > 150 and len([d for d, _ in got["shifts"] if d > 0]) >= 2
    assert got == want


def test_mirostat_session_shifts_one_position(tiny):
    """A session's mirostat stream samples on the host one token at a time;
    with shifting it runs past its context, keeping the keep prefix."""
    pool = SessionPool(*tiny, session_ctx=200, n_ctx=256, n_batch=32, device="cpu",
                       context_shift=True)
    try:
        s = pool.new_session()
        pool.system_prompt(s)
        s.ask("hi")
        kept = list(s.state.tokens[:s.state.n_keep])
        n0 = s.n_past
        toks = list(s.generate(limit=100, params=SamplingParams(mirostat=2, temp=0.8)))
        assert toks and s.n_past <= 200 and len(s.state.tokens) == s.n_past
        assert s.state.tokens[:s.state.n_keep] == kept
        assert n0 + 100 > 200 and pool.metrics["tokens_generated"] >= len(toks)
    finally:
        pool.close()
