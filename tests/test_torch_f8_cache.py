"""Port parity for the e4m3 KV cache (``cache_dtype="f8"``): the write cast,
the flash-decode read (dense and paged), the S > 32 prefill attention, and
an engine chat in ``quant_mode="w8a8"`` over an e4m3 cache, each against the
JAX package on the same numpy inputs (Pallas in interpret mode).

Tolerances: the write cast is bit-equal (NaN for NaN).  Flash decode over
an e4m3 cache reads the same f32 values on both sides (subnormals flushed
to +-0 by the integer unpack, NaN kept), so it agrees to f32 rounding, 2e-5
as the other cache types, with NaN in the same places.  The paged plain
version is bit-equal to the dense one on the gathered cache.  The decoder
over an e4m3 cache (S = 40 prefill, then decode steps) is held to 1e-4 of
max|logit|: f32 summation order only.  The engine chat's greedy tokens are
equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fixtures import build_gq_models
from minigpt4_tpu.engine.engine import MiniGPT4Engine as JaxEngine
from minigpt4_tpu.engine.sampling import SamplingParams as JaxParams
from minigpt4_tpu.models import llama as jllama
from minigpt4_tpu.ops.flash_decode import flash_decode_attention as jax_flash
from minigpt4_tpu.ops.flash_decode import paged_flash_decode_attention as jax_paged
from minigpt4_tpu_torch import quality as tquality
from minigpt4_tpu_torch.engine import MiniGPT4Engine, SamplingParams
from minigpt4_tpu_torch.formats import LlamaFileReader
from minigpt4_tpu_torch.image import preprocess
from minigpt4_tpu_torch.models import llama as tllama
from minigpt4_tpu_torch.ops import flash_decode as tfd

F8 = torch.float8_e4m3fn


def _bits_or_nan(a: np.ndarray, b: np.ndarray) -> bool:
    """Equal e4m3 bytes, or NaN on both sides."""
    a8, b8 = a.view(np.uint8), b.view(np.uint8)
    nan_a, nan_b = (a8 & 0x7F) == 0x7F, (b8 & 0x7F) == 0x7F
    return bool(np.array_equal(nan_a, nan_b) and np.array_equal(a8[~nan_a], b8[~nan_b]))


def test_write_cast_matches_jax():
    rng = np.random.default_rng(0)
    vals = np.concatenate([
        rng.normal(0, 1, 4000), rng.normal(0, 200, 4000), rng.normal(0, 0.01, 4000),
        [448.0, 455.9, 460.0, 463.99, 464.0, 464.01, 480.0, 500.0, -500.0, 1e6,
         np.inf, -np.inf, np.nan, 0.0, -0.0, 2.0 ** -9, 2.0 ** -10, 0.75 * 2.0 ** -9]],
    ).astype(np.float32)
    want = np.asarray(jnp.asarray(vals).astype(jnp.float8_e4m3fn))
    got = tllama.to_cache(torch.from_numpy(vals), F8)
    assert got.dtype == F8
    assert _bits_or_nan(got.view(torch.uint8).numpy(), want.view(np.uint8))
    # the case torch's own cast gets wrong: 500 saturates there, NaN in JAX
    assert torch.from_numpy(vals[-11:-10]).to(F8).float().item() == 448.0
    assert np.isnan(float(got[np.where(vals == 500.0)[0][0]].float()))
    # bf16 and f32 caches cast plainly
    t = torch.from_numpy(vals[:100])
    assert torch.equal(tllama.to_cache(t, torch.bfloat16), t.to(torch.bfloat16))


def _e4m3_cache(rng, shape):
    """A random e4m3 cache with every 97th value scaled into the subnormal
    range, as a torch tensor and as the same bytes for JAX."""
    v = rng.normal(0, 1, shape).astype(np.float32)
    v.reshape(-1)[::97] *= 0.01  # mostly |v| < 2^-6: subnormal in e4m3
    t = torch.from_numpy(v).to(F8)
    return t, t.view(torch.uint8).numpy().view(jnp.float8_e4m3fn)


CASES = [(1, 0), (1, 300), (8, 130), (32, 250), (1, [5, 400]), (8, [0, 250])]


@pytest.mark.parametrize("s,pos0", CASES)
def test_flash_e4m3_matches_jax(s, pos0):
    rng = np.random.default_rng(s + int(np.sum(pos0)))
    b = 1 if isinstance(pos0, int) else len(pos0)
    l, h, c, dh = 2, 4, 512, 128
    q = rng.normal(0, 1, (b, h, s, dh)).astype(np.float32)
    tk, jk = _e4m3_cache(rng, (l, b, h, c, dh))
    tv, jv = _e4m3_cache(rng, (l, b, h, c, dh))
    # a NaN key in head 1 of lane 0 and a NaN value in head 2, at position
    # 0, which every query row sees (the JAX kernel also spreads a NaN from
    # a masked key of a block it reads; the port's versions mask it)
    for t in (tk, tv):
        t.view(torch.uint8)[1, 0, 1 if t is tk else 2, 0, 5] = 0x7F
    jk = tk.view(torch.uint8).numpy().view(jnp.float8_e4m3fn)
    jv = tv.view(torch.uint8).numpy().view(jnp.float8_e4m3fn)
    assert ((tk.view(torch.uint8) & 0x7F) < 8).any()  # subnormals (and zeros) present
    scale = 1.0 / np.sqrt(dh)
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(jk), jnp.asarray(jv), 1,
                                jnp.asarray(pos0, jnp.int32), scale))
    got = tfd.flash_decode_attention(torch.from_numpy(q), tk, tv, 1, pos0, scale).numpy()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[0, 1]).all() and np.isnan(got[0, 2]).any() and not np.isnan(got[0, 0]).any()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


# (S, pos0, lane, position): a lane's NaN past its cursor pos0 + S, inside a
# 32-key block the kernel reads: one lane; and the shorter lane of two,
# where the plain version reads the longer lane's span
NAN_PAST_CURSOR = [(1, 37, 0, 40), (8, 130, 0, 150), (1, [5, 400], 0, 9)]


@pytest.mark.parametrize("s,pos0,lane,at", NAN_PAST_CURSOR)
@pytest.mark.parametrize("kv", ["k", "v"])
def test_nan_past_the_cursor_is_not_read(s, pos0, lane, at, kv):
    """A deliberate divergence from the JAX kernel: an e4m3 NaN left past
    the cursor (a stale overflow after a rollback) does not reach the
    port's output, which equals the output without it; JAX's _kernel reads
    the whole key block and returns NaN there."""
    rng = np.random.default_rng(at)
    b = 1 if isinstance(pos0, int) else len(pos0)
    l, h, c, dh = 2, 4, 512, 128
    q = rng.normal(0, 1, (b, h, s, dh)).astype(np.float32)
    tk, _ = _e4m3_cache(rng, (l, b, h, c, dh))
    tv, _ = _e4m3_cache(rng, (l, b, h, c, dh))
    scale = 1.0 / np.sqrt(dh)
    clean = tfd.flash_decode_attention(torch.from_numpy(q), tk, tv, 1, pos0, scale)
    t = tk if kv == "k" else tv
    t.view(torch.uint8)[1, lane, 2, at, 7] = 0x7F
    got = tfd.flash_decode_attention(torch.from_numpy(q), tk, tv, 1, pos0, scale)
    assert torch.isfinite(got).all() and torch.equal(got, clean)
    jk, jv = (x.view(torch.uint8).numpy().view(jnp.float8_e4m3fn) for x in (tk, tv))
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(jk), jnp.asarray(jv), 1,
                                jnp.asarray(pos0, jnp.int32), scale))
    # the JAX kernel: a NaN key spoils every score of the planted head, a NaN
    # value its column (probability 0 times NaN); nothing else
    nan = np.zeros(want.shape, bool)
    nan[lane, 2, :, slice(None) if kv == "k" else 7] = True
    assert np.array_equal(np.isnan(want), nan)


def test_subnormals_flush_in_the_read_only():
    # exponent field 0 reads as +-0; the native cast keeps the subnormal
    t = torch.tensor([2.0 ** -9, -3 * 2.0 ** -9, 2.0 ** -6, -1.5]).to(F8)
    got = tfd.cache_f32(t)
    assert got.tolist() == [0.0, -0.0, 2.0 ** -6, -1.5]
    assert str(got[1].item()) == "-0.0" and t.float()[0].item() == 2.0 ** -9


@pytest.mark.parametrize("s", [1, 8])
def test_paged_e4m3_matches_jax_and_dense(s):
    rng = np.random.default_rng(9 + s)
    l, b, h, dh, maxp = 2, 3, 4, 64, 3
    n_pages = b * maxp
    pk, jpk = _e4m3_cache(rng, (l, n_pages + 1, h, 128, dh))
    pv, jpv = _e4m3_cache(rng, (l, n_pages + 1, h, 128, dh))
    table = np.full((b, maxp + 1), n_pages, np.int32)
    table[:, :maxp] = rng.permutation(n_pages).reshape(b, maxp)
    pos = [0, 130, 380 - s]
    q = rng.normal(0, 1, (b, h, s, dh)).astype(np.float32)
    scale = dh ** -0.5
    got = tfd.paged_flash_decode_attention(torch.from_numpy(q), pk, pv, 1, pos,
                                           torch.from_numpy(table), scale)
    want = np.asarray(jax_paged(jnp.asarray(q), jnp.asarray(jpk), jnp.asarray(jpv), 1,
                                jnp.asarray(pos, jnp.int32), jnp.asarray(table), scale))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    # the dense plain version on the gathered cache: the same bits
    tt = torch.from_numpy(table).long()
    ck, cv = (p[:, tt].permute(0, 1, 3, 2, 4, 5).reshape(l, b, h, (maxp + 1) * 128, dh)
              for p in (pk, pv))
    assert torch.equal(got, tfd.flash_decode_attention(torch.from_numpy(q), ck, cv, 1, pos, scale))


@pytest.fixture(scope="module")
def synth_f32(tmp_path_factory):
    work = tmp_path_factory.mktemp("f8")
    f32_p, q_p = work / "f32.bin", work / "q5k.bin"
    tquality.write_synth_llama(f32_p, q_p, tquality.GEOMETRIES["tiny"], seed=4)
    return f32_p


def test_decoder_over_e4m3_cache_matches_jax(synth_f32):
    """A 40-position prefill (S > 32: the masked-softmax path, P.V in bf16,
    native e4m3 read) and three decode steps (the flash path) over e4m3
    caches, on the same f32 weights."""
    with LlamaFileReader(synth_f32) as r:
        tp, tcfg = tllama.load_params(r, torch.float32, n_ctx=128, device="cpu")
    from minigpt4_tpu.formats.ggml_llama import LlamaFileReader as JReader

    with JReader(synth_f32) as r:
        jp, jcfg = jllama.load_params(r, jnp.float32, n_ctx=128)
    toks = np.random.default_rng(1).integers(3, tcfg.n_vocab, 43)
    tc = tllama.init_cache(tcfg, 1, F8, "cpu")
    jc = jllama.init_cache(jcfg, 1, jnp.float8_e4m3fn)
    for pos0, chunk in ((0, toks[:40]), (40, toks[40:41]), (41, toks[41:42]), (42, toks[42:])):
        te = tllama.embed_tokens(tp, torch.from_numpy(chunk[None]))
        got = tllama.forward(tp, tc, te, pos0, tcfg).numpy()
        jl, jc = jllama.forward(jp, jc, jllama.embed_tokens(jp, jnp.asarray(chunk[None])),
                                jnp.int32(pos0), jcfg)
        want = np.asarray(jl)
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max(), pos0
    # the caches hold the same e4m3 bytes but where an f32 rounding
    # difference crossed an e4m3 rounding edge
    for kv in ("k", "v"):
        a, b = tc[kv].view(torch.uint8).numpy(), np.asarray(jc[kv]).view(np.uint8)
        assert (a != b).mean() <= 1e-3, kv


QUESTION = "what is in the image?"
IMAGE = np.random.default_rng(0).integers(0, 255, (40, 50, 3), dtype=np.uint8)


def _chat(engine_cls, params_cls, model, llm, **kw):
    eng = engine_cls(model, llm, n_ctx=256, n_batch=32, **kw)
    try:
        emb = eng.encode_image(preprocess(IMAGE, size=eng.vision_cfg.vit.image_size))
        eng.system_prompt()
        eng.begin_chat_image(emb, QUESTION)
        return emb, list(eng.generate(limit=10, params=params_cls(temp=0.0)))
    finally:
        eng.close()


def test_w8a8_f8_chat_matches_jax_engine(tmp_path_factory):
    """The gq fixture (every decoder weight K % 256 == 0) in w8a8 over an
    e4m3 cache: the same greedy tokens as the JAX engine."""
    model, llm = build_gq_models(tmp_path_factory.mktemp("w8a8_f8"))
    emb, toks = _chat(MiniGPT4Engine, SamplingParams, model, llm, device="cpu",
                      quant_mode="w8a8", cache_dtype="f8")
    jemb, jtoks = _chat(JaxEngine, JaxParams, model, llm, quant_mode="w8a8",
                        cache_dtype=jnp.float8_e4m3fn)
    assert np.abs(emb - jemb).max() <= 1e-5 * np.abs(jemb).max()
    assert len(toks) == 10 and toks == jtoks
