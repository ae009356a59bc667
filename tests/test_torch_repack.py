"""Port parity for the repacked fused dequant-matmul (``ops/repack.py``,
``ops/pallas_quant_matmul.py``) and the paths that load repacked weights:
quantized vision containers and the decoder in quant_mode "repack".

Inputs come from numpy with fixed seeds; the JAX side runs its Pallas kernel
in interpret mode.  Weights: every one of the ten repackable formats at an
odd N = 67, K = 1408 (the ViT-G width, 44 groups of 32) for the 32-blocks
and K = 512 for the k-quants.  Tolerances:
- the port's ``from_ggml(...).dequantize()`` and the JAX
  ``dequantize_repacked(repack(...))`` run the same f32 operations on the
  same bf16 planes: bit for bit, and ``interop.repacked_from_numpy`` of the
  JAX planes gives the port's storage bit for bit;
- ``qmatmul_repacked_ref`` and JAX's f32 ``x @ dequantize_repacked(w).T``
  multiply the same f32 weight: f32 summation order, 1e-5 of max|y|;
- the port's matmul against JAX's kernel: JAX rounds x and scale * q to
  bf16 and keeps the min term in f32 on unrounded group sums, the port's
  decode path keeps x in f32 and its prefill path rounds x and
  scale * q - min to bf16; two bf16 roundings (2^-9 each) per product,
  which JAX's own tests/test_pallas_quant_matmul.py bounds at 1.2e-2 of
  max|y| against the f32 product (measured here: up to 7.5e-3);
- the vision pipeline (2 images, M = 10 rows, both sides' bf16 paths):
  1e-3 of max|embedding| (measured: up to 8.9e-5);
- decoder logits, port against the JAX decoder, both repacked: 6e-3 of
  max|logit| (measured: up to 2.9e-3 on the 2-layer q4_0 fixture, 1.2e-3 on
  the mixed one), for the bf16 roundings above in every projection; so that
  this bound cannot hide a matmul fault, every projection of every layer is
  also fed identical 8-row inputs and held to 1e-5 of JAX's f32 product
  over its dequantized weight.
"""

import functools
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fixtures import build_llm_mixed, build_tiny_models
from minigpt4_tpu.formats import ContainerReader, LlamaFileReader
from minigpt4_tpu.formats import quants as nq
from minigpt4_tpu.formats.dtypes import DataType
from minigpt4_tpu.models import llama as jllama
from minigpt4_tpu.models import minigpt4 as jvision
from minigpt4_tpu.ops import repack as jrp
from minigpt4_tpu.ops.pallas_quant_matmul import qmatmul_repacked as jax_qmatmul
from minigpt4_tpu_torch import interop
from minigpt4_tpu_torch.engine import MiniGPT4Engine, SamplingParams
from minigpt4_tpu_torch.image import preprocess
from minigpt4_tpu_torch.library import MiniGPT4ChatBot
from minigpt4_tpu_torch.models import llama as tllama
from minigpt4_tpu_torch.models import minigpt4 as tvision
from minigpt4_tpu_torch.models.params import linear as tlinear
from minigpt4_tpu_torch.ops import pallas_quant_matmul as trq
from minigpt4_tpu_torch.ops import repack as trp

# one intra-op thread: the suite runs several pytest-xdist workers on the same cores, where
# torch's OpenMP pools spin against each other and run ~17x slower
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
FORMATS = sorted(trp.REPACKABLE)
IDS = [d.name.lower() for d in FORMATS]
JAX_KERNEL_TOL = 1.2e-2  # tests/test_pallas_quant_matmul.py BF16_TOL
N_ODD = 67


def _k(dtype) -> int:
    return 512 if dtype >= DataType.Q2_K else 1408


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


@functools.lru_cache(maxsize=None)
def _weights(dtype, seed=0):
    """(raw, JAX RepackedQuant, port RepackedQuant) of a random [67, K] weight."""
    k = _k(dtype)
    vals = np.random.default_rng(int(dtype) * 7 + seed).normal(0, 0.6, (N_ODD, k))
    raw = nq.quantize(vals.astype(np.float32), dtype)
    return raw, jrp.repack(raw, (N_ODD, k), dtype), trp.from_ggml(raw, (N_ODD, k), dtype, "cpu")


def _x(m, k, seed=0):
    return np.random.default_rng(1000 + m + seed).normal(0, 1, (m, k)).astype(np.float32)


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy()
    return np.asarray(a).view(np.int16)


# ---------------------------------------------------------------------------
# the weight form and the matmul, per format
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", FORMATS, ids=IDS)
def test_from_ggml_dequantize_bitwise_equal_to_jax(dtype):
    raw, jw, tw = _weights(dtype)
    k = _k(dtype)
    code_bits, hi_bits = trp.LAYOUT[dtype]
    assert (tw.code_bits, tw.hi_bits, tw.group_size) == (jw.code_bits, jw.hi_bits, jw.group_size)
    assert tw.n_out == jw.n_out == N_ODD and tw.n_in == k
    assert tw.codes.shape == ((N_ODD, k // 2) if code_bits == 4 else (N_ODD, k))
    assert tw.codes.dtype == (torch.uint8 if code_bits == 4 else torch.int8)
    assert tw.hi is None if not hi_bits else tw.hi.shape == (N_ODD, k * hi_bits // 32)
    for name in ("scales", "mins"):
        assert np.array_equal(_bits(getattr(tw, name)), _bits(getattr(jw, name))), name
    want = np.asarray(jrp.dequantize_repacked(jw))
    assert np.array_equal(tw.dequantize().numpy(), want)


@pytest.mark.parametrize("dtype", FORMATS, ids=IDS)
def test_interop_repacked_equals_from_ggml(dtype):
    _, jw, tw = _weights(dtype)
    got = interop.repacked_from_numpy(jax.tree_util.tree_map(np.asarray, jw), "cpu")
    assert got.form() == tw.form()
    for name, t in tw.tensors().items():
        assert got.tensors()[name].dtype == t.dtype, name
        assert torch.equal(got.tensors()[name], t), name


@pytest.mark.parametrize("dtype", FORMATS, ids=IDS)
def test_plain_version_matches_jax_f32_product(dtype):
    _, jw, tw = _weights(dtype)
    x = _x(8, _k(dtype))
    want = np.asarray(jnp.dot(jnp.asarray(x), jrp.dequantize_repacked(jw).T,
                              precision=jax.lax.Precision.HIGHEST))
    got = trq.qmatmul_repacked_ref(torch.from_numpy(x), tw).numpy()
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("m", [1, 8, 33])
@pytest.mark.parametrize("dtype", FORMATS, ids=IDS)
def test_matmul_matches_jax_kernel(dtype, m):
    _, jw, tw = _weights(dtype)
    x = _x(m, _k(dtype), seed=int(dtype))
    want = np.asarray(jax_qmatmul(jnp.asarray(x), jw, out_dtype=jnp.float32))
    got = trq.qmatmul_repacked(torch.from_numpy(x), tw).numpy()
    assert got.shape == want.shape == (m, N_ODD)
    assert _rel(got, want) <= JAX_KERNEL_TOL


@pytest.mark.parametrize("traced", [False, True], ids=["int-layer", "int32-layer"])
@pytest.mark.parametrize("m", [1, 8, 33])
def test_stacked_matches_jax_kernel(m, traced):
    # a python int takes JAX's _kernel (static layer), a jnp.int32 its
    # _kernel_stacked (scalar prefetch); the port takes one index for both
    dtype = DataType.Q5_1
    ws = [_weights(dtype, seed=s) for s in range(3)]
    jstack = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *[w[1] for w in ws])
    tstack = trp.stack([w[2] for w in ws])
    assert tstack.stacked and tstack.codes.shape == (3, N_ODD, _k(dtype) // 2)
    x = _x(m, _k(dtype), seed=7)
    for li in range(3):
        layer = jnp.int32(li) if traced else li
        want = np.asarray(jax_qmatmul(jnp.asarray(x), jstack, out_dtype=jnp.float32, layer=layer))
        got = trq.qmatmul_repacked(torch.from_numpy(x), tstack, li)
        assert _rel(got.numpy(), want) <= JAX_KERNEL_TOL
        assert torch.equal(got, trq.qmatmul_repacked(torch.from_numpy(x), ws[li][2]))
    with pytest.raises(ValueError, match="layer index"):
        trq.qmatmul_repacked(torch.from_numpy(x), tstack)


def test_concat_out_and_stack_refuse_mixed_forms():
    a, b = _weights(DataType.Q4_0)[2], _weights(DataType.Q4_1)[2]
    fused = trp.concat_out([a, a])
    x = torch.from_numpy(_x(2, a.n_in))
    assert torch.equal(tlinear(x, {"w": fused}), torch.cat([tlinear(x, {"w": a})] * 2, dim=-1))
    for op in (trp.stack, trp.concat_out):
        with pytest.raises(ValueError, match="share format"):
            op([a, b])


# ---------------------------------------------------------------------------
# quantized vision containers
# ---------------------------------------------------------------------------


def _make_gq(seed):
    vals = np.random.default_rng(seed).normal(0, 0.6, (64, 512)).astype(np.float32)
    return nq.quantize(vals, DataType.Q5_K)


@pytest.mark.parametrize("leaf", ["repacked", "gq", "dense"])
def test_vit_blocks_stack_every_weight_form(leaf):
    # quant_mode "gq" gives the ViT-G fc2 (K = 6144) a GroupQuant, "auto"
    # a RepackedQuant; the stacked block selects its layer in the kernel
    from minigpt4_tpu_torch.models.eva_vit import _stack
    from minigpt4_tpu_torch.ops import group_i8 as tgq

    raws = [_weights(DataType.Q5_K, seed=s)[0] for s in range(2)]
    shape = (N_ODD, _k(DataType.Q5_K))
    ws = {"repacked": [trp.from_ggml(r, shape, DataType.Q5_K, "cpu") for r in raws],
          "gq": [tgq.from_ggml(_make_gq(s), (64, 512), DataType.Q5_K, "cpu") for s in range(2)],
          "dense": [torch.randn(512, 64, generator=torch.Generator().manual_seed(s))
                    for s in range(2)]}[leaf]
    blocks = _stack([{"fc2": {"w": w, "b": torch.zeros(w.shape[-1] if leaf == "dense" else w.n_out)}}
                     for w in ws])
    x = torch.from_numpy(_x(3, 512))
    for li, w in enumerate(ws):
        got = tlinear(x, blocks["fc2"], li)
        assert torch.equal(got, tlinear(x, {"w": w}))



@pytest.fixture(scope="module")
def quant_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_repack")
    out = {}
    for q in (DataType.Q4_0, DataType.Q5_1, DataType.Q8_0):
        (root / q.name).mkdir()
        out[q] = build_tiny_models(root / q.name, quant=q)
    out["mixed"] = build_llm_mixed(root / "mixed.bin", np.random.default_rng(3))
    return out


QUANTS = [DataType.Q4_0, DataType.Q5_1, DataType.Q8_0]


@pytest.mark.parametrize("quant", QUANTS, ids=[q.name.lower() for q in QUANTS])
def test_quantized_vision_matches_jax(quant_files, quant):
    model, _ = quant_files[quant]
    with ContainerReader(model) as r:
        jparams, jcfg = jvision.load_params(r, quant_mode="repack")
        tparams, tcfg = tvision.load_params(r, torch.float32, "cpu", "repack")
    blocks = tparams["visual_encoder"]["blocks"]
    for name in ("qkv", "proj", "fc1", "fc2"):
        w = blocks[name]["w"]
        assert isinstance(w, trp.RepackedQuant) and w.stacked and w.dtype == quant, name
    pixels = np.random.default_rng(0).normal(0, 1, (2, 3, 28, 28)).astype(np.float32)
    want = np.asarray(jvision.encode_image(jparams, jnp.asarray(pixels), jcfg))
    got = tvision.encode_image(tparams, torch.from_numpy(pixels), tcfg).numpy()
    assert got.shape == want.shape == (2, 4, 32)
    assert _rel(got, want) <= 1e-3
    carried = interop.vision_params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    again = tvision.encode_image(carried, torch.from_numpy(pixels), tcfg).numpy()
    np.testing.assert_array_equal(again, got)


# ---------------------------------------------------------------------------
# the decoder in quant_mode "repack"
# ---------------------------------------------------------------------------

N_CTX = 256
LLMS = ["q4_0", "mixed"]


@pytest.fixture(scope="module")
def repack_llms(quant_files):
    """Per file: the JAX decoder with quant_mode="repack", the port's file
    loader with quant_mode="auto" (every quantized weight of these 32-wide
    files is below gq's K rule, so it loads repacked) and the JAX params
    carried over by interop."""
    out = {}
    for name in LLMS:
        llm = quant_files[DataType.Q4_0][1] if name == "q4_0" else quant_files["mixed"]
        with LlamaFileReader(llm) as r:
            jparams, jcfg = jllama.load_params(r, jnp.float32, n_ctx=N_CTX, quant_mode="repack")
            tfile, tcfg = tllama.load_params(r, torch.float32, n_ctx=N_CTX, device="cpu")
        carried = interop.llama_params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                                  "cpu")
        out[name] = (jparams, jcfg, carried, tfile, tcfg)
    return out


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}.")
    elif isinstance(tree, trp.RepackedQuant):
        yield prefix + "form", tree.form()
        for k, v in tree.tensors().items():
            yield prefix + k, v
    else:
        yield prefix.rstrip("."), tree


@pytest.mark.parametrize("llm", LLMS)
def test_repack_loader_bitwise_equal_to_interop(repack_llms, llm):
    _, _, carried, tfile, _ = repack_llms[llm]
    lay = tfile["layers"]
    if llm == "q4_0":
        assert {"wqkv", "wo", "w13", "w2"} <= lay.keys()
        assert all(lay[n]["w"].stacked for n in ("wqkv", "wo", "w13", "w2"))
    else:  # wv and w2 mix q8_0 and q4_0 across the layers: per-layer lists
        for name in ("wv", "w2"):
            assert [w.dtype for w in lay[name]["w"]] in ([DataType.Q8_0, DataType.Q4_0],
                                                         [DataType.Q4_0, DataType.Q8_0])
    a, b = dict(_leaves(carried)), dict(_leaves(tfile))
    assert a.keys() == b.keys()
    for name in a:
        if name.endswith("form"):
            assert a[name] == b[name], name
            continue
        assert a[name].dtype == b[name].dtype, name
        assert torch.equal(a[name], b[name]), name


def _close(got, want, tol):
    assert _rel(got, want) <= tol, (_rel(got, want), tol)


@pytest.mark.parametrize("llm", LLMS)
def test_repack_forward_matches_jax(repack_llms, llm):
    jparams, jcfg, _, tparams, tcfg = repack_llms[llm]
    rng = np.random.default_rng(2)
    jcache = jllama.init_cache(jcfg, 1, jnp.bfloat16)
    tcache = tllama.init_cache(tcfg, 1, torch.bfloat16, "cpu")
    pos = 0
    for s in (40, 8):
        e = rng.normal(0, 0.2, (1, s, tcfg.n_embd)).astype(np.float32)
        jl, jcache = jllama.forward(jparams, jcache, jnp.asarray(e), jnp.int32(pos), jcfg,
                                    jnp.int32(s - 1), attn_len=128)
        tl = tllama.forward(tparams, tcache, torch.from_numpy(e), pos, tcfg, s - 1, attn_len=128)
        _close(tl.numpy(), np.asarray(jl), 6e-3)
        pos += s
    for tok in (7, 100, 261):
        je = jllama.embed_tokens(jparams, jnp.asarray([[tok]], jnp.int32))
        jl, jcache = jllama.forward(jparams, jcache, je, jnp.int32(pos), jcfg, attn_len=128)
        te = tllama.embed_tokens(tparams, torch.tensor([[tok]]))
        tl = tllama.forward(tparams, tcache, te, pos, tcfg, attn_len=128)
        _close(tl.numpy(), np.asarray(jl), 6e-3)
        pos += 1


def _jax_f32(x: np.ndarray, w, li: int) -> np.ndarray:
    """JAX's f32 product of x with layer ``li`` of a JAX weight (list,
    stacked or not, repacked or dense [K, N])."""
    if isinstance(w, list):
        w = w[li]
    elif isinstance(w, jrp.RepackedQuant):
        if w.codes.ndim == 3:
            w = jax.tree_util.tree_map(lambda a: a[li], w)
    elif w.ndim == 3:
        w = w[li]
    if isinstance(w, jrp.RepackedQuant):
        return np.asarray(jnp.dot(jnp.asarray(x), jrp.dequantize_repacked(w).T,
                                  precision=jax.lax.Precision.HIGHEST))
    return np.asarray(jnp.dot(jnp.asarray(x), w, precision=jax.lax.Precision.HIGHEST))


# the port's projections of each file: wq|wk|wv fuse on q4_0 only (the
# mixed file's wv is repacked, its wq and wk dense)
PROJECTIONS = [("q4_0", n) for n in ("wqkv", "wo", "w13", "w2")] + [
    ("mixed", n) for n in ("wq", "wk", "wv", "wo", "w13", "w2")]


@pytest.mark.parametrize("llm,name", PROJECTIONS, ids=[f"{a}-{b}" for a, b in PROJECTIONS])
def test_repack_projections_match_jax_f32_on_identical_inputs(repack_llms, llm, name):
    jparams, _, _, tparams, tcfg = repack_llms[llm]
    jl = jparams["layers"]
    parts = [name] if name in jl else {"wqkv": ["wq", "wk", "wv"], "w13": ["w1", "w3"]}[name]
    tw = tparams["layers"][name]
    for li in range(tcfg.n_layer):
        w = tw["w"][li] if isinstance(tw["w"], list) else tw["w"]
        k = w.n_in if isinstance(w, trp.RepackedQuant) else w.shape[-2]
        x = np.random.default_rng(10 * li + k).normal(0, 1, (8, k)).astype(np.float32)
        want = np.concatenate([_jax_f32(x, jl[p]["w"], li) for p in parts], axis=-1)
        got = tlinear(torch.from_numpy(x), {"w": tw["w"]}, li).numpy()
        assert got.shape == want.shape
        assert _rel(got, want) <= 1e-5, (name, li)


# ---------------------------------------------------------------------------
# the engine and its clients
# ---------------------------------------------------------------------------

QUESTION = "what is in the image?"
IMAGE = np.random.default_rng(4).integers(0, 255, (40, 50, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def repack_chat(quant_files):
    model, llm = quant_files[DataType.Q4_0]
    eng = MiniGPT4Engine(model, llm, n_ctx=N_CTX, n_batch=32, device="cpu", quant_mode="repack")
    try:
        assert eng.quant_mode == "repack"
        emb = eng.encode_image(preprocess(IMAGE, size=eng.vision_cfg.vit.image_size))
        eng.system_prompt()
        eng.begin_chat_image(emb, QUESTION)
        return emb, list(eng.generate(limit=10, params=SamplingParams(temp=0.0)))
    finally:
        eng.close()


def _mode_chat(model, llm, mode, engine=MiniGPT4Engine, params=SamplingParams, **kw):
    eng = engine(model, llm, n_ctx=N_CTX, n_batch=32, quant_mode=mode, **kw)
    try:
        emb = eng.encode_image(preprocess(IMAGE, size=eng.vision_cfg.vit.image_size))
        eng.system_prompt()
        eng.begin_chat_image(emb, QUESTION)
        return eng, emb, list(eng.generate(limit=10, params=params(temp=0.0)))
    finally:
        eng.close()


def test_engine_quant_modes(quant_files, repack_chat):
    model, llm = quant_files[DataType.Q4_0]
    with pytest.raises(ValueError, match="unknown quant_mode"):
        MiniGPT4Engine(model, llm, device="cpu", quant_mode="q4")
    # qtensor: the packed bytes, dequantized in f32 per call, as the JAX
    # engine's qtensor mode: the same greedy tokens
    from minigpt4_tpu.engine.engine import MiniGPT4Engine as JaxEngine
    from minigpt4_tpu.engine.sampling import SamplingParams as JaxParams
    from minigpt4_tpu_torch.ops.quant_matmul import QTensor

    eng, emb, toks = _mode_chat(model, llm, "qtensor", device="cpu")
    assert isinstance(eng.vision_params["visual_encoder"]["blocks"]["fc1"]["w"], QTensor)
    assert isinstance(eng.llm_params["layers"]["wqkv"]["w"], QTensor)
    _, jemb, jtoks = _mode_chat(model, llm, "qtensor", JaxEngine, JaxParams)
    assert np.abs(emb - jemb).max() <= 1e-5 * np.abs(jemb).max()
    assert toks == jtoks and len(toks) == 10
    # w8a8: no weight of these 32-wide files has K % 256 == 0, so every one
    # takes the auto form (repacked): the repack chat
    eng, emb, toks = _mode_chat(model, llm, "w8a8", device="cpu")
    assert eng.quant_mode == "w8a8"
    assert isinstance(eng.llm_params["layers"]["wqkv"]["w"], trp.RepackedQuant)
    np.testing.assert_array_equal(emb, repack_chat[0])
    assert toks == repack_chat[1]
    # auto: the vision weights repacked, the decoder resolved to gq, which
    # falls back to repacked weights at these widths: the same chat
    eng = MiniGPT4Engine(model, llm, n_ctx=N_CTX, n_batch=32, device="cpu")
    try:
        assert eng.quant_mode == "gq"
        assert isinstance(eng.vision_params["visual_encoder"]["blocks"]["fc1"]["w"],
                          trp.RepackedQuant)
        emb = eng.encode_image(preprocess(IMAGE, size=eng.vision_cfg.vit.image_size))
        eng.system_prompt()
        eng.begin_chat_image(emb, QUESTION)
        toks = list(eng.generate(limit=10, params=SamplingParams(temp=0.0)))
    finally:
        eng.close()
    np.testing.assert_array_equal(emb, repack_chat[0])
    assert toks == repack_chat[1] and len(toks) == 10


def test_chatbot_passes_quant_mode(quant_files, repack_chat):
    model, llm = quant_files[DataType.Q4_0]
    bot = MiniGPT4ChatBot(str(model), str(llm), device="cpu", quant_mode="repack")
    try:
        assert bot.library._eng(bot.ctx).quant_mode == "repack"
        bot.upload_image(IMAGE)
        assert list(bot.generate(QUESTION, limit=10, temp=0.0)) == repack_chat[1]
    finally:
        bot.free()


_NO_JAX = """
import json, sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
sys.modules["minigpt4_tpu"] = None  # and so does any import of the JAX package
sys.path.insert(0, sys.argv[1])
import numpy as np
from minigpt4_tpu_torch.engine import MiniGPT4Engine, SamplingParams
from minigpt4_tpu_torch.image import preprocess
eng = MiniGPT4Engine(sys.argv[2], sys.argv[3], n_ctx=256, n_batch=32, device="cpu",
                     quant_mode="repack")
img = np.random.default_rng(4).integers(0, 255, (40, 50, 3), dtype=np.uint8)
emb = eng.encode_image(preprocess(img, size=eng.vision_cfg.vit.image_size))
eng.system_prompt()
eng.begin_chat_image(emb, sys.argv[4])
toks = list(eng.generate(limit=10, params=SamplingParams(temp=0.0)))
eng.close()
print(json.dumps({"tokens": toks, "jax_loaded": sys.modules["jax"] is not None,
                  "jax_package_loaded": sys.modules["minigpt4_tpu"] is not None}))
"""


def test_repack_chat_runs_without_jax(quant_files, repack_chat):
    model, llm = quant_files[DataType.Q4_0]
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX, str(ROOT), str(model), str(llm), QUESTION],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"tokens": repack_chat[1], "jax_loaded": False, "jax_package_loaded": False}


@pytest.mark.parametrize("mode,item", [("w8a8", "Queue 2 item 4"), ("qtensor", "Queue 1 item 2")])
def test_server_quant_mode_reaches_the_engine(quant_files, mode, item, capsys, monkeypatch):
    """--quant-mode reaches the engine and loads (the ROADMAP item that once
    refused it is done)."""
    from minigpt4_tpu_torch import serve

    model, llm = quant_files[DataType.Q4_0]
    started = []
    real = serve.start_server

    def start(*a, **k):
        httpd = real(*a, **k)
        httpd.serve_forever = lambda: None  # bound, not served
        started.append(httpd)
        return httpd

    monkeypatch.setattr(serve, "start_server", start)
    serve.main([str(model), str(llm), "--device", "cpu", "--port", "0", "--n-ctx", "256",
                "--quant-mode", mode])
    httpd = started[0]
    try:
        assert httpd.pool.engine.quant_mode == mode
    finally:
        httpd.server_close()
        httpd.pool.close()
    out = capsys.readouterr()
    assert "serving on" in out.out and item not in out.err
