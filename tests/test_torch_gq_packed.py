"""Port parity for the sub-byte packed gq codes (packings p4, p5, p6).

The port packs in K order (``ops/group_i8.py``), the JAX package chunk-locally
with K padded to whole 1024-column tiles for p5/p6 (``pad_k_chunks``); both
store the same logical codes in the same bytes per weight.  Held here, each
on weights made from a seed with numpy and quantized by the ggml codec:

* ``pack_codes`` against the JAX package's for the seven packable formats
  (same packing, logical codes equal, stored bytes equal once JAX's pad is
  stripped) and a no-op for q2_k, q3_k and q8_0;
* ``interop`` of packed JAX weights (padded or not; one, stacked, per-layer
  lists) tensor-equal to the port's own packing;
* the plain versions of a packed weight bit-equal to the unpacked weight's;
* the port's wrappers on CPU tensors against the JAX kernels on packed
  weights (Pallas in interpret mode): decode rows within 1e-5 of max|y|
  (the same dual-i8 function on both sides, f32 summation order,
  tests/test_torch_group_i8.py), 40-row prefill within 1e-4 (bf16 operands
  on both sides, summation order);
* the packing precedence (``MINIGPT4_TPU_GQ_PACK``, then the caller, then
  packed) and the engine's resolution of it against the JAX engine's
  ``resolve_llm_quant_mode``;
* a ViT whose fc2 quantizes as a gq weight (packed on both sides, the
  embedding within the decode bound above), and one image chat on the gq
  fixture through both engines with ``quant_mode="gq"``: greedy tokens
  equal, embeddings within 1e-5 of max|emb| (tests/test_torch_engine.py).

The packed card kernels are held to their unpacked twins, bit for bit, in
tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fixtures
from fixtures import build_container, build_gq_models
from minigpt4_tpu.engine import engine as jengine
from minigpt4_tpu.engine.engine import MiniGPT4Engine as JaxEngine
from minigpt4_tpu.engine.sampling import SamplingParams as JaxParams
from minigpt4_tpu.formats import ContainerReader as JContainerReader
from minigpt4_tpu.formats import LlamaFileReader as JLlamaFileReader
from minigpt4_tpu.formats import quants as nq
from minigpt4_tpu.formats.dtypes import DataType
from minigpt4_tpu.models import minigpt4 as jvision
from minigpt4_tpu.ops import group_i8 as jgq
from minigpt4_tpu_torch import interop
from minigpt4_tpu_torch.engine import MiniGPT4Engine, SamplingParams
from minigpt4_tpu_torch.formats import ContainerReader
from minigpt4_tpu_torch.image import preprocess
from minigpt4_tpu_torch.models import minigpt4 as tvision
from minigpt4_tpu_torch.models.params import load_quant_weight, resolve_gq_pack
from minigpt4_tpu_torch.ops import group_i8 as tgq

PACKABLE = [DataType.Q4_0, DataType.Q4_1, DataType.Q4_K, DataType.Q5_0, DataType.Q5_1,
            DataType.Q5_K, DataType.Q6_K]
KEPT = [DataType.Q2_K, DataType.Q3_K, DataType.Q8_0]
# K per format: 1280 (JAX pads 5 chunks of 256 to 8) for q5_k, 768 (q6_k:
# 6 chunks of 128 padded to 8; q5_1: 3 of 256 padded to 4), unpadded others
K_OF = {DataType.Q4_0: 256, DataType.Q4_1: 512, DataType.Q4_K: 768, DataType.Q5_0: 512,
        DataType.Q5_1: 768, DataType.Q5_K: 1280, DataType.Q6_K: 768, DataType.Q2_K: 256,
        DataType.Q3_K: 512, DataType.Q8_0: 256}
N = 40


def _raw(dtype, n, k, seed=0):
    vals = np.random.default_rng(seed).normal(0, 0.6, (n, k)).astype(np.float32)
    return nq.quantize(vals, dtype)


def _np(w):
    return jax.tree_util.tree_map(np.asarray, w)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-12)


def _stored_bytes(w) -> int:
    return sum(t.numel() * t.element_size() for t in (w.codes, w.hi) if t is not None)


def _equal(a: tgq.GroupQuant, b: tgq.GroupQuant) -> bool:
    ta, tb = a.tensors(), b.tensors()
    return (tgq._form(a) == tgq._form(b) and ta.keys() == tb.keys()
            and all(ta[k].dtype == tb[k].dtype and torch.equal(ta[k], tb[k]) for k in ta))


@pytest.mark.parametrize("dtype", PACKABLE + KEPT, ids=[d.name.lower() for d in PACKABLE + KEPT])
def test_pack_codes_matches_jax(dtype):
    k = K_OF[dtype]
    raw = _raw(dtype, N, k, seed=int(dtype))
    tw = tgq.from_ggml(raw, (N, k), dtype, "cpu")
    tp = tgq.pack_codes(tw)
    jp = jgq.pack_codes(jgq.from_ggml(raw, (N, k), dtype))
    assert tp.packing == jp.packing == tgq.packing_of(dtype)
    assert tgq.packable(dtype) == jgq.packable(dtype) == (dtype in PACKABLE)
    assert np.array_equal(tp.codes_int().numpy(), np.asarray(jp.codes_logical()))
    if dtype in KEPT:
        assert tp is tw  # q2_k, q3_k and q8_0 keep one byte per code
        return
    assert tp.codes.shape == (N, k // 2) and tp.codes.dtype == torch.uint8
    # the same bytes per weight as the JAX package's, its pad_k_chunks groups aside
    js = jgq._strip_k_pad(jp)
    assert _stored_bytes(tp) == sum(np.asarray(t).nbytes for t in (js.codes, js.hb) if t is not None)
    assert _stored_bytes(tp) * 8 == {"p4": 4, "p5": 5, "p6": 6}[tp.packing] * N * k
    # planes untouched
    assert all(tp.tensors()[n] is t for n, t in tw.tensors().items() if n != "codes")


# p5 padded by JAX (q5_k K 1280, q5_1 K 768), p6 padded (q6_k K 768), p4 and
# p5 unpadded (q4_k K 768, q5_0 K 1024)
INTEROP = [(DataType.Q5_K, 1280), (DataType.Q5_1, 768), (DataType.Q6_K, 768),
           (DataType.Q4_K, 768), (DataType.Q5_0, 1024)]


@pytest.mark.parametrize("dtype,k", INTEROP, ids=[f"{d.name.lower()}-K{k}" for d, k in INTEROP])
def test_interop_of_packed_jax_weights(dtype, k):
    raws = [_raw(dtype, N, k, seed=s) for s in (1, 2, 3)]
    jws = [jgq.pack_codes(jgq.from_ggml(r, (N, k), dtype)) for r in raws]
    assert (jws[0].k_pad > 0) == (k % 1024 != 0 and dtype not in (DataType.Q4_K,))
    own = [tgq.pack_codes(tgq.from_ggml(r, (N, k), dtype, "cpu")) for r in raws]
    for jw, tw in zip(jws, own):
        assert _equal(interop.group_quant_from_numpy(_np(jw), "cpu"), tw)
    # stacked: the JAX fields stacked over a leading layer axis
    fields = {f: np.stack([np.asarray(getattr(w, f)) for w in jws])
              for f in ("codes", "sc6", "mn6", "d", "dmin", "a", "b", "hb")
              if getattr(jws[0], f) is not None}
    jstack = jgq.GroupQuant(**{f: fields.get(f) for f in ("codes", "sc6", "mn6", "d", "dmin",
                                                         "a", "b")},
                            dtype=dtype, n_in=k, group_size=jws[0].group_size,
                            hb=fields.get("hb"), packing=jws[0].packing, k_pad=jws[0].k_pad)
    stacked = interop.group_quant_from_numpy(jstack, "cpu")
    assert stacked.stacked and _equal(stacked, tgq.stack(own))
    assert _equal(stacked.layer(2), own[2])
    # a per-layer list (a K_M file's mixed names) converts element by element
    got = interop._weight([_np(w) for w in jws], "cpu", torch.float32)
    assert isinstance(got, list) and all(_equal(g, t) for g, t in zip(got, own))


@pytest.mark.parametrize("dtype", PACKABLE, ids=[d.name.lower() for d in PACKABLE])
def test_plain_versions_of_packed_weights_bit_equal(dtype):
    k = K_OF[dtype]
    w = tgq.stack([tgq.from_ggml(_raw(dtype, N, k, seed=s), (N, k), dtype, "cpu")
                   for s in (4, 5)])
    wp = tgq.pack_codes(w)
    assert wp.stacked and wp.packing != "none"
    assert torch.equal(wp.dequantize(), w.dequantize())
    rng = np.random.default_rng(int(dtype))
    for m, plain in ((1, tgq.qmatmul_decode_ref), (8, tgq.qmatmul_decode_ref),
                     (40, tgq.qmatmul_prefill_ref)):
        x = torch.from_numpy(rng.normal(0, 1, (m, k)).astype(np.float32))
        assert torch.equal(plain(x, wp, 1), plain(x, w, 1))
        assert torch.equal(tgq.qmatmul_group(x, wp, 1), tgq.qmatmul_group(x, w, 1))


# the JAX kernels' bounds of tests/test_torch_group_i8.py: decode rows 1e-5
# of max|y| (the same dual-i8 function), prefill 1e-4 (summation order)
@pytest.mark.parametrize("m,tol", [(1, 1e-5), (8, 1e-5), (40, 1e-4)], ids=["m1", "m8", "m40"])
@pytest.mark.parametrize("dtype", PACKABLE, ids=[d.name.lower() for d in PACKABLE])
def test_packed_wrappers_match_jax_kernels(dtype, m, tol):
    k = K_OF[dtype]
    raw = _raw(dtype, 64, k, seed=10 * int(dtype) + m)
    x = np.random.default_rng(m).normal(0, 1, (m, k)).astype(np.float32)
    tw = tgq.pack_codes(tgq.from_ggml(raw, (64, k), dtype, "cpu"))
    got = tgq.qmatmul_group(torch.from_numpy(x), tw).numpy()
    jw = jgq.pack_codes(jgq.from_ggml(raw, (64, k), dtype))
    assert jw.packing == tw.packing != "none"
    want = np.asarray(jgq.qmatmul_group(jnp.asarray(x), jw, out_dtype=jnp.float32))
    assert _rel(got, want) <= tol


def test_load_quant_weight_pack_precedence(monkeypatch):
    """resolve_gq_pack: MINIGPT4_TPU_GQ_PACK first, then the mode (explicit
    modes pack, auto does not); load_quant_weight packs gq weights exactly
    where it is told to, whatever the environment."""
    raw = _raw(DataType.Q5_K, 8, 256)

    def packing(pack):
        return load_quant_weight(raw, (8, 256), DataType.Q5_K, "cpu", "gq", pack=pack).packing

    monkeypatch.delenv("MINIGPT4_TPU_GQ_PACK", raising=False)
    assert [resolve_gq_pack(m) for m in ("auto", "gq", "repack")] == [False, True, True]
    assert [packing(p) for p in (True, False)] == ["p5", "none"]
    for env, want in (("0", False), ("1", True)):
        monkeypatch.setenv("MINIGPT4_TPU_GQ_PACK", env)
        assert [resolve_gq_pack(m) for m in ("auto", "gq")] == [want] * 2
        assert [packing(p) for p in (True, False)] == ["p5", "none"]
    # any other mode never packs
    assert not hasattr(load_quant_weight(raw, (8, 256), DataType.Q5_K, "cpu", "repack",
                                         pack=True), "packing")


@pytest.fixture(scope="module")
def gq_files(tmp_path_factory):
    return build_gq_models(tmp_path_factory.mktemp("torch_gq_packed"))


@pytest.mark.parametrize("env", [None, "0", "1"], ids=["env-unset", "env-0", "env-1"])
@pytest.mark.parametrize("mode", ["auto", "gq"])
def test_engine_resolves_packing_as_jax(gq_files, monkeypatch, mode, env):
    """Explicit gq packs, auto does not; MINIGPT4_TPU_GQ_PACK=0 turns both
    off and =1 turns auto on: what JAX's resolve_llm_quant_mode leaves for
    group_i8.pack_enabled on a TPU-sized budget."""
    if env is None:
        monkeypatch.delenv("MINIGPT4_TPU_GQ_PACK", raising=False)
    else:
        monkeypatch.setenv("MINIGPT4_TPU_GQ_PACK", env)
    monkeypatch.setattr(jgq, "PACK_OVERRIDE", None)  # restored after the test
    model, llm = gq_files
    with JLlamaFileReader(llm) as r:
        assert jengine.resolve_llm_quant_mode(r, mode, "tpu") == "gq"
    want = jgq.pack_enabled()
    assert want == (env == "1" if env is not None else mode == "gq")
    assert resolve_gq_pack(mode) == want
    eng = MiniGPT4Engine(model, llm, n_ctx=64, n_batch=32, device="cpu", quant_mode=mode)
    try:
        assert eng.quant_mode == "gq" and eng.gq_packed == want
        layers = eng.llm_params["layers"]
        forms = {layers[n]["w"].packing for n in ("wqkv", "wo", "w13", "w2")}
        assert forms == {"p5" if want else "none"}
        assert eng.llm_params["output"]["w"].packing == ("p5" if want else "none")
    finally:
        eng.close()


def test_vision_gq_weights_follow_the_packing_rule(tmp_path, monkeypatch):
    """A container whose ViT fc2 (K = 256) quantizes to q5_1: quant_mode
    "gq" loads it as a p5 GroupQuant on both sides (JAX pads it to 1024),
    interop of the JAX tree equals the port's, the embedding is the one of
    the unpacked weights, bit for bit, and agrees with JAX's within the JAX
    decode kernel's bound (the fixture ViT has 5 tokens, so fc2 takes the
    dual-i8 decode path there: 5e-4 of max|y|)."""
    monkeypatch.setattr(fixtures, "VIT_MLP", 256)
    model = build_container(tmp_path / "minigpt4-q5_1.bin", np.random.default_rng(5),
                            quant=DataType.Q5_1)
    monkeypatch.delenv("MINIGPT4_TPU_GQ_PACK", raising=False)
    monkeypatch.setattr(jgq, "PACK_OVERRIDE", None)
    with JContainerReader(model) as r:
        jparams, jcfg = jvision.load_params(r, quant_mode="gq")
    with ContainerReader(model) as r:
        tparams, tcfg = tvision.load_params(r, torch.float32, "cpu", "gq", resolve_gq_pack("gq"))
    fc2 = tparams["visual_encoder"]["blocks"]["fc2"]["w"]
    assert isinstance(fc2, tgq.GroupQuant) and fc2.packing == "p5" and fc2.stacked
    jfc2 = jparams["visual_encoder"]["blocks"]["fc2"]["w"]
    assert jfc2.packing == "p5" and jfc2.k_pad == 768
    assert _equal(interop.group_quant_from_numpy(_np(jfc2), "cpu"), fc2)
    img = preprocess(np.random.default_rng(1).integers(0, 255, (40, 50, 3), dtype=np.uint8),
                     size=tcfg.vit.image_size)
    got = tvision.encode_image(tparams, torch.from_numpy(img[None]), tcfg)
    blocks = tparams["visual_encoder"]["blocks"]
    blocks["fc2"]["w"] = tgq.GroupQuant(**{**fc2.__dict__, "codes": fc2.codes_int().to(torch.int8),
                                           "hi": None, "packing": "none"})
    assert torch.equal(tvision.encode_image(tparams, torch.from_numpy(img[None]), tcfg), got)
    want = np.asarray(jvision.encode_image(jparams, jnp.asarray(img[None]), jcfg))
    assert np.abs(got.numpy() - want).max() <= 5e-4 * np.abs(want).max()


QUESTION = "what is in the image?"
IMAGE = np.random.default_rng(0).integers(0, 255, (40, 50, 3), dtype=np.uint8)


def _chat(engine_cls, params_cls, model, llm, **kw):
    eng = engine_cls(model, llm, n_ctx=256, n_batch=32, **kw)
    try:
        emb = eng.encode_image(preprocess(IMAGE, size=eng.vision_cfg.vit.image_size))
        eng.system_prompt()
        eng.begin_chat_image(emb, QUESTION)
        return eng, emb, list(eng.generate(limit=10, params=params_cls(temp=0.0)))
    finally:
        eng.close()


def test_packed_chat_matches_jax_engine(gq_files, monkeypatch):
    """The slice end to end: quant_mode="gq" on both engines (packed by
    default on both), the same greedy tokens."""
    monkeypatch.delenv("MINIGPT4_TPU_GQ_PACK", raising=False)
    monkeypatch.setattr(jgq, "PACK_OVERRIDE", None)
    eng, emb, toks = _chat(MiniGPT4Engine, SamplingParams, *gq_files, device="cpu",
                           quant_mode="gq")
    assert eng.gq_packed and eng.llm_params["layers"]["wqkv"]["w"].packing == "p5"
    jeng, jemb, jtoks = _chat(JaxEngine, JaxParams, *gq_files, quant_mode="gq")
    assert jeng.llm_params["layers"]["wq"]["w"].packing == "p5"
    assert np.abs(emb - jemb).max() <= 1e-5 * np.abs(jemb).max()
    assert len(toks) == 10 and toks == jtoks
