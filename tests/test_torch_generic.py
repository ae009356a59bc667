"""Port parity for the generic-plane group-quant mode and llama.cpp's mixed
Q5_K_M layout.

Part 1, per format (q4_0, q4_1, q5_0, q5_1, q8_0 with group size 32; q2_k,
q3_k, q6_k with group size 16): the port's ``from_ggml`` and ``dequantize``
against the JAX package's, bit for bit, and both matmul paths against the
JAX kernels (Pallas in interpret mode, sub-byte packing off).  Tolerances
as in tests/test_torch_group_i8.py: the port's decode computes the JAX
kernel's dual-i8 function, so it sits within f32 rounding (1e-5) of that
function in f64 over the port's own planes and codes, and within f32
summation order (1e-5) of the JAX result; both prefill paths round x and W
to bf16 and accumulate in f32, so only the summation order differs (1e-4).

Part 2, a tiny file in the layout llama.cpp's quantizer writes for
"q5_k" (Q5_K_M), at the gq geometry (D 256, FF 768) with 4 layers: q6_k
``output``, q6_k ``wv``/``w2`` on the layers its use_more_bits rule picks
(2 and 3 of 4), q5_k everywhere else, ``tok_embeddings`` included.  The
port's loader against the JAX loader carried over by ``interop``, the
decoder's logits, the greedy chat of both engines, and the chat in a
process without JAX.

Logit tolerances.  The reasons are those of tests/test_torch_llama.py, on
twice its depth.  Each decode matmul, the JAX kernel's and the port's
alike, rounds x to two i8 planes in the A-term but sums the true x in the
B-term, so a projection fed the same 8 rows differs from JAX's only by f32
summation order (held below to 1e-5 of its max).  Those differences, and
the port's other summation orders (RMSNorm, attention, the bf16 prefill
matmul's), still flip bf16 roundings of the K/V cache entries and of the
prefill matmul's inputs, and the 40-row chunk's bf16 operands differ from
the f32 ones an 8-row chunk sees.  Measured on this fixture (CPU): the
8-row chunk differs by 8.4e-4 of max|logit| after 4 layers, the decode
steps by up to 1.2e-3, the 40-row chunk by 3.1e-3 (with an f32-x decode
the 8-row chunk grew 4.8e-4 / 1.1e-3 / 1.9e-3 after 1 / 2 / 4 layers, and
the decode steps reached 1.3e-3).  So the 8-row chunk and the decode steps
are held to 2.5e-3 (1e-3 per 2 layers, as the 2-layer fixture, plus
margin) and the 40-row chunk to 5e-3.  So that these bounds cannot hide a fault of a projection,
every projection of every layer, and the output head, is also fed
identical inputs on both sides: 8 rows within 1e-5 and 40 rows within 1e-4
of JAX.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fixtures import GQ_D, build_container
from minigpt4_tpu.engine.engine import MiniGPT4Engine as JaxEngine
from minigpt4_tpu.engine.sampling import SamplingParams as JaxParams
from minigpt4_tpu.formats import LlamaFileReader
from minigpt4_tpu.formats import quants as nq
from minigpt4_tpu.formats.dtypes import DataType
from minigpt4_tpu.models import llama as jllama
from minigpt4_tpu.models.params import linear as jparams_linear
from minigpt4_tpu.ops import group_i8 as jgq
from minigpt4_tpu_torch import interop
from minigpt4_tpu_torch.engine import MiniGPT4Engine, SamplingParams
from minigpt4_tpu_torch.image import preprocess
from minigpt4_tpu_torch.models import llama as tllama
from minigpt4_tpu_torch.models.params import linear as tparams_linear
from minigpt4_tpu_torch.ops import group_i8 as tgq
from test_torch_fixtures import KM_LAYERS, build_llm_q5_k_m
from test_torch_group_i8 import dual_i8_f64

ROOT = Path(__file__).resolve().parent.parent
GENERIC = [DataType.Q4_0, DataType.Q4_1, DataType.Q5_0, DataType.Q5_1, DataType.Q8_0,
           DataType.Q2_K, DataType.Q3_K, DataType.Q6_K]
IDS = [d.name.lower() for d in GENERIC]


@pytest.fixture(autouse=True)
def _unpacked(monkeypatch):
    monkeypatch.setenv("MINIGPT4_TPU_GQ_PACK", "0")  # interop maps unpacked codes


def _make(dtype, n, k, seed=0):
    vals = np.random.default_rng(seed).normal(0, 0.6, (n, k)).astype(np.float32)
    return nq.quantize(vals, dtype)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-12)


def _bits(a) -> np.ndarray:
    """bf16 planes of either side as their 16-bit patterns."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy()
    return np.asarray(a).view(np.int16)


# ---------------------------------------------------------------------------
# part 1: every generic format
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", GENERIC, ids=IDS)
def test_from_ggml_and_dequantize_bitwise_equal_to_jax(dtype):
    n, k = 96, 512
    raw = _make(dtype, n, k, seed=int(dtype))
    jw = jgq.from_ggml(raw, (n, k), dtype)
    tw = tgq.from_ggml(raw, (n, k), dtype, "cpu")
    assert not tw.exact and tw.group_size == jw.group_size == tgq.group_size(dtype)
    assert tw.codes.dtype == torch.int8 and tw.a.dtype == tw.b.dtype == torch.bfloat16
    assert np.array_equal(tw.codes.numpy(), np.asarray(jw.codes))
    for name in ("a", "b"):
        got, want = _bits(getattr(tw, name)), _bits(getattr(jw, name))
        assert got.shape == want.shape == (k // tw.group_size, n), name
        assert np.array_equal(got, want), name
    assert np.array_equal(tw.dequantize().numpy(), np.asarray(jw.dequantize()))


@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("dtype", GENERIC, ids=IDS)
def test_decode_matches_f64_and_jax(dtype, m):
    n, k = 128, 512
    raw = _make(dtype, n, k, seed=int(dtype) * 10 + m)
    x = np.random.default_rng(m).normal(0, 1, (m, k)).astype(np.float32)
    tw = tgq.from_ggml(raw, (n, k), dtype, "cpu")
    got = tgq.qmatmul_group(torch.from_numpy(x), tw).numpy()
    assert _rel(got, dual_i8_f64(x, tw)) <= 1e-5
    jw = jgq.from_ggml(raw, (n, k), dtype)
    jy = np.asarray(jgq.qmatmul_group(jnp.asarray(x), jw, out_dtype=jnp.float32))
    assert _rel(got, jy) <= 1e-5


@pytest.mark.parametrize("dtype", GENERIC, ids=IDS)
def test_prefill_matches_jax(dtype):
    n, k, m = 128, 512, 40
    raw = _make(dtype, n, k, seed=int(dtype) + 100)
    x = np.random.default_rng(140).normal(0, 1, (m, k)).astype(np.float32)
    tw = tgq.from_ggml(raw, (n, k), dtype, "cpu")
    got = tgq.qmatmul_group(torch.from_numpy(x), tw).numpy()
    jw = jgq.from_ggml(raw, (n, k), dtype)
    jy = np.asarray(jgq.qmatmul_group(jnp.asarray(x), jw, out_dtype=jnp.float32))
    assert _rel(got, jy) <= 1e-4


@pytest.mark.parametrize("m", [1, 16])
def test_gs16_stacked_layer_selection(m):
    n, k = 64, 256
    ws = [tgq.from_ggml(_make(DataType.Q6_K, n, k, seed=s), (n, k), DataType.Q6_K, "cpu")
          for s in (1, 2, 3)]
    stacked = tgq.stack(ws)
    assert stacked.stacked and stacked.a.shape == (3, k // 16, n)
    x = torch.from_numpy(np.random.default_rng(0).normal(0, 1, (m, k)).astype(np.float32))
    for i, wi in enumerate(ws):
        assert torch.equal(tgq.qmatmul_group(x, stacked, layer=i), tgq.qmatmul_group(x, wi))
    with pytest.raises(ValueError):
        tgq.qmatmul_group(x, stacked)
    with pytest.raises(ValueError, match="share format"):
        tgq.stack([ws[0], tgq.from_ggml(_make(DataType.Q8_0, n, k), (n, k), DataType.Q8_0, "cpu")])


# ---------------------------------------------------------------------------
# part 2: the mixed Q5_K_M layout
# ---------------------------------------------------------------------------

N_CTX = 256


@pytest.fixture(scope="module")
def km_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_q5_k_m")
    rng = np.random.default_rng(7)
    model = build_container(d / "minigpt4-gq.bin", rng, llm_d=GQ_D)
    return model, build_llm_q5_k_m(d / "vicuna-q5_k_m.bin", rng)


@pytest.fixture(scope="module")
def km_loaded(km_files):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MINIGPT4_TPU_GQ_PACK", "0")
        with LlamaFileReader(km_files[1]) as r:
            jparams, jcfg = jllama.load_params(r, jnp.float32, n_ctx=N_CTX, quant_mode="gq")
            tparams_file, tcfg = tllama.load_params(r, torch.float32, n_ctx=N_CTX, device="cpu")
    tparams = interop.llama_params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    return jparams, jcfg, tparams, tparams_file, tcfg


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}.")
    elif isinstance(tree, tgq.GroupQuant):
        yield prefix + "meta", (tree.dtype, tree.n_in, tree.group_size)
        for k, v in tree.tensors().items():
            yield prefix + k, v
    else:
        yield prefix.rstrip("."), tree


def test_mixed_file_loader_bitwise_equal_to_interop(km_loaded):
    _, _, tparams, tparams_file, _ = km_loaded
    lay = tparams_file["layers"]
    # the Q5_K_M layout: wv and w2 mix q5_k and q6_k, so wqkv cannot fuse
    # and both stay per-layer lists; wq/wk/wo and the fused w13 stack
    assert "wqkv" not in lay and {"wq", "wk", "wv", "wo", "w13", "w2"} <= lay.keys()
    for name in ("wv", "w2"):
        assert [w.dtype for w in lay[name]["w"]] == [DataType.Q5_K] * 2 + [DataType.Q6_K] * 2
        assert [w.group_size for w in lay[name]["w"]] == [32, 32, 16, 16]
    for name in ("wq", "wk", "wo", "w13"):
        assert lay[name]["w"].stacked and lay[name]["w"].exact
    out = tparams_file["output"]["w"]
    assert out.dtype == DataType.Q6_K and not out.exact
    a, b = dict(_leaves(tparams)), dict(_leaves(tparams_file))
    assert a.keys() == b.keys()
    for name in a:
        if name.endswith("meta"):
            assert a[name] == b[name], name
            continue
        assert a[name].dtype == b[name].dtype, name
        assert torch.equal(a[name], b[name]), name


def _close(got, want, tol=1e-3):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def test_mixed_forward_and_decode_match_jax(km_loaded):
    jparams, jcfg, tparams, _, tcfg = km_loaded
    rng = np.random.default_rng(1)
    jcache = jllama.init_cache(jcfg, 1, jnp.bfloat16)
    tcache = tllama.init_cache(tcfg, 1, torch.bfloat16, "cpu")
    pos = 0
    for s, tol in ((40, 5e-3), (8, 2.5e-3)):
        e = rng.normal(0, 0.2, (1, s, tcfg.n_embd)).astype(np.float32)
        jl, jcache = jllama.forward(jparams, jcache, jnp.asarray(e), jnp.int32(pos), jcfg,
                                    jnp.int32(s - 1), attn_len=128)
        tl = tllama.forward(tparams, tcache, torch.from_numpy(e), pos, tcfg, s - 1, attn_len=128)
        _close(tl.numpy(), np.asarray(jl), tol)
        pos += s
    for tok in (7, 100, 261):
        je = jllama.embed_tokens(jparams, jnp.asarray([[tok]], jnp.int32))
        jl, jcache = jllama.forward(jparams, jcache, je, jnp.int32(pos), jcfg, attn_len=128)
        te = tllama.embed_tokens(tparams, torch.tensor([[tok]]))
        tl = tllama.forward(tparams, tcache, te, pos, tcfg, attn_len=128)
        _close(tl.numpy(), np.asarray(jl), 2.5e-3)
        pos += 1


@pytest.mark.parametrize("m,tol", [(8, 1e-5), (40, 1e-4)], ids=["decode", "prefill"])
@pytest.mark.parametrize("name", ["wq", "wk", "wv", "wo", "w13", "w2", "output"])
def test_mixed_projections_match_jax_on_identical_inputs(km_loaded, name, m, tol):
    # the JAX tree keeps w1/w3 apart; the port fuses them into w13
    jparams, _, tparams, _, _ = km_loaded
    if name == "output":
        pairs = [(tparams["output"], [jparams["output"]], None)]
    else:
        parts = {"w13": ("w1", "w3")}.get(name, (name,))
        pairs = [(tparams["layers"][name], [jparams["layers"][p] for p in parts], li)
                 for li in range(KM_LAYERS)]
    for tw, jws, li in pairs:
        w = tw["w"] if li is None or not isinstance(tw["w"], list) else tw["w"][li]
        x = np.random.default_rng(m + (li or 0)).normal(0, 1, (m, w.n_in)).astype(np.float32)
        want = np.concatenate([np.asarray(jparams_linear(jnp.asarray(x), jw, li)) for jw in jws],
                              axis=-1).astype(np.float64)
        got = tparams_linear(torch.from_numpy(x), tw, li).numpy()
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= tol * np.abs(want).max(), (name, li)


QUESTION = "what is in the image?"
IMAGE = np.random.default_rng(3).integers(0, 255, (40, 50, 3), dtype=np.uint8)


def _chat(engine_cls, params_cls, model, llm, **kw):
    eng = engine_cls(model, llm, n_ctx=N_CTX, n_batch=32, **kw)
    try:
        emb = eng.encode_image(preprocess(IMAGE, size=eng.vision_cfg.vit.image_size))
        eng.system_prompt()
        eng.begin_chat_image(emb, QUESTION)
        return list(eng.generate(limit=10, params=params_cls(temp=0.0)))
    finally:
        eng.close()


@pytest.fixture(scope="module")
def km_port_chat(km_files):
    return _chat(MiniGPT4Engine, SamplingParams, *km_files, device="cpu")


def test_mixed_greedy_chat_matches_jax_engine(km_files, km_port_chat):
    jtokens = _chat(JaxEngine, JaxParams, *km_files, quant_mode="gq")
    assert len(km_port_chat) == 10
    assert km_port_chat == jtokens


_NO_JAX = """
import json, sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
sys.path.insert(0, sys.argv[1])
import numpy as np
from minigpt4_tpu_torch.engine import MiniGPT4Engine, SamplingParams
from minigpt4_tpu_torch.image import preprocess
eng = MiniGPT4Engine(sys.argv[2], sys.argv[3], n_ctx=256, n_batch=32, device="cpu")
img = np.random.default_rng(3).integers(0, 255, (40, 50, 3), dtype=np.uint8)
emb = eng.encode_image(preprocess(img, size=eng.vision_cfg.vit.image_size))
eng.system_prompt()
eng.begin_chat_image(emb, sys.argv[4])
toks = list(eng.generate(limit=10, params=SamplingParams(temp=0.0)))
print(json.dumps({"tokens": toks, "jax_loaded": sys.modules["jax"] is not None}))
"""


def test_mixed_file_runs_without_jax(km_files, km_port_chat):
    model, llm = km_files
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX, str(ROOT), str(model), str(llm), QUESTION],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"tokens": km_port_chat, "jax_loaded": False}
