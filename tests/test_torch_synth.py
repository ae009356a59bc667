"""The port's benchmark models (``minigpt4_tpu_torch/benchmark.py``) against
the JAX package's ``benchmark.py``: geometries, text, tags, synthetic
weights, and the n-gram acceptance walk.

Bounds: bit-equal wherever the weights come from NumPy (the ggml bytes of
``random_packed`` outside ``repack``, ``tok_embeddings``, the norms, the
whole qtensor tree, ``synth_vision_params``); exact for the tags, the
acceptance walk and the state the builders leave ``rng`` in.  Weights the
JAX package draws with ``jax.random`` are drawn by a ``torch.Generator``
here, so only their form, ranges and constants are compared.  Logits and
embeddings keep the existing bounds: a 40-row prefill 5e-3 of max|logit|
(``tests/test_torch_llama.py``), the encoder 1e-5 of max|emb|
(``tests/test_torch_vision.py``), teacher targets equal away from top-2
ties of 1e-4 (``tests/test_torch_draft_head.py``).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from minigpt4_tpu import benchmark as JB
from minigpt4_tpu.formats.dtypes import DataType as JDataType
from minigpt4_tpu.models import eva_vit as jvit
from minigpt4_tpu.models import llama as jllama
from minigpt4_tpu.models import minigpt4 as jvision
from minigpt4_tpu.models import qformer as jqf
from minigpt4_tpu.ops.repack import dequantize_repacked
from minigpt4_tpu.train import draft as jdraft
from minigpt4_tpu_torch import benchmark as TB
from minigpt4_tpu_torch import interop
from minigpt4_tpu_torch.formats import DataType
from minigpt4_tpu_torch.models import llama as tllama
from minigpt4_tpu_torch.models import minigpt4 as tvision
from minigpt4_tpu_torch.models.eva_vit import ViTConfig
from minigpt4_tpu_torch.models.qformer import QFormerConfig
from minigpt4_tpu_torch.ops import group_i8 as gq
from minigpt4_tpu_torch.ops import i8_matmul as i8
from minigpt4_tpu_torch.ops import repack as rp
from minigpt4_tpu_torch.ops.quant_matmul import QTensor
from minigpt4_tpu_torch.train import draft as tdraft

# one intra-op thread: the suite runs several pytest-xdist workers on the same cores, where
# torch's OpenMP pools spin against each other and run ~17x slower
torch.set_num_threads(1)

DTYPES = ["Q4_K", "Q5_K", "Q6_K", "Q4_0", "Q8_0"]
TINY = "tiny"
PREFILL_TOL = 5e-3  # of max|logit|: test_torch_llama.py's 40-row prefill bound
ENCODE_TOL = 1e-5  # of max|emb|: test_torch_vision.py
TIE = 1e-4  # of max|logit|: test_torch_draft_head.py


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _dequant_jax(w) -> np.ndarray:
    if hasattr(w, "hi_bits"):
        return np.asarray(dequantize_repacked(w, jnp.float32))
    return np.asarray(w.dequantize(jnp.float32))


def _dequant_port(w) -> np.ndarray:
    return w.dequantize().float().numpy()


def test_geometries_text_and_tokenizer_equal_jax():
    assert TB.GEOMETRIES.keys() == JB.GEOMETRIES.keys()
    for name, cfg in TB.GEOMETRIES.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(JB.GEOMETRIES[name]), name
    for d in (4096, 5120):
        assert dataclasses.asdict(TB.vit_g_config(d)) == dataclasses.asdict(JB.vit_g_config(d))
    assert TB.REALISTIC_TEXT == JB.REALISTIC_TEXT
    assert np.array_equal(TB.word_tokenize(TB.REALISTIC_TEXT), JB.word_tokenize(JB.REALISTIC_TEXT))
    assert TB.GQ_SYNTH_D == JB.GQ_SYNTH_D


@pytest.mark.parametrize("pack", [False, True])
@pytest.mark.parametrize("mode", ["gq", "w8a8", "repack", "qtensor", "auto"])
def test_teacher_tag_equals_jax(monkeypatch, mode, pack):
    monkeypatch.setenv("MINIGPT4_TPU_GQ_PACK", "1" if pack else "0")
    assert TB.synth_teacher_tag(mode, pack) == JB.synth_teacher_tag(mode)
    # the port's packing decision for an explicit gq decoder follows the variable
    assert TB.bench_pack_policy(TB.GEOMETRIES["13B"]) is pack


def test_pack_policy_packs_by_default(monkeypatch):
    monkeypatch.delenv("MINIGPT4_TPU_GQ_PACK", raising=False)
    assert TB.bench_pack_policy(TB.GEOMETRIES["13B"]) is True
    assert TB.synth_teacher_tag("gq", True) == "gq@2e-05+p5"


@pytest.mark.parametrize("mode", ["auto", "qtensor", "gq", "w8a8"])
@pytest.mark.parametrize("name", DTYPES)
def test_random_packed_dequantizes_bit_equal_to_jax(monkeypatch, name, mode):
    """Outside repack the bytes come from NumPy: the port's weight, in the
    form its loader gives the mode, dequantizes to the JAX weight's bits,
    and both builders leave the rng in one state."""
    monkeypatch.setenv("MINIGPT4_TPU_GQ_PACK", "0")
    shape = (48, 512)
    jr, tr = np.random.default_rng(3), np.random.default_rng(3)
    jw = JB.random_packed(jr, shape, JDataType[name], mode)
    tw = TB.random_packed(tr, shape, DataType[name], mode, "cpu")
    want_form = {"auto": rp.RepackedQuant, "qtensor": QTensor, "gq": gq.GroupQuant,
                 "w8a8": i8.I8SBQuant}[mode]
    assert isinstance(tw, want_form)
    got, want = _dequant_port(tw), _dequant_jax(jw)
    assert got.shape == want.shape == shape
    assert np.array_equal(got, want)
    assert tr.integers(0, 2**31) == jr.integers(0, 2**31)


@pytest.mark.parametrize("name", DTYPES)
def test_random_packed_repack_draws_on_the_device_generator(name):
    """repack: one seed from the rng (as JAX's jax.random key), the planes of
    the port's layout drawn from it: the logical shape, scales 0.002, mins
    0, codes in the format's range."""
    shape = (48, 512)
    jr, tr = np.random.default_rng(4), np.random.default_rng(4)
    jw = JB.random_packed(jr, shape, JDataType[name], "repack")
    tw = TB.random_packed(tr, shape, DataType[name], "repack", "cpu")
    assert isinstance(tw, rp.RepackedQuant) and tw.dtype == DataType[name]
    assert (tw.n_out, tw.n_in) == shape == _dequant_jax(jw).shape
    assert (tw.code_bits, tw.hi_bits) == (int(jw.code_bits), int(jw.hi_bits))
    assert tw.group_size == int(jw.group_size)
    assert torch.all(tw.scales.float() == np.float32(jnp.bfloat16(0.002)))
    assert torch.all(tw.mins == 0)
    q = tw.codes_int()
    lo, hi = (-128, 127) if tw.code_bits == 8 else (0, (1 << (4 + tw.hi_bits)) - 1)
    assert int(q.min()) == lo and int(q.max()) == hi  # every code value reachable, none past
    assert tr.integers(0, 2**31) == jr.integers(0, 2**31)


def _forms(tree) -> dict:
    """{name: (form, packing, n_out, n_in, stacked layers)} of a port decoder tree."""
    out = {}
    for name, p in [*tree["layers"].items(), ("output", tree["output"])]:
        w = p["w"] if isinstance(p, dict) else p
        if isinstance(w, torch.Tensor):
            out[name] = ("dense", tuple(w.shape))
            continue
        lead = (w.packed if isinstance(w, QTensor) else w.codes).shape[0] if w.stacked else None
        out[name] = (type(w).__name__, getattr(w, "packing", None), w.n_out, w.n_in, lead)
    return out


def _synth_pair(monkeypatch, mode, pack=False, seed=0):
    monkeypatch.setenv("MINIGPT4_TPU_GQ_PACK", "1" if pack else "0")
    cfg = TB.GEOMETRIES[TINY]
    jr, tr = np.random.default_rng(seed), np.random.default_rng(seed)
    jt = JB.synth_llama_params(JB.GEOMETRIES[TINY], JDataType.Q5_K, jr, jnp.float32,
                               quant_mode=mode)
    tt = TB.synth_llama_params(cfg, DataType.Q5_K, tr, torch.float32, quant_mode=mode,
                               device="cpu", pack=pack)
    assert tr.integers(0, 2**31) == jr.integers(0, 2**31)  # the rng left in one state
    return jt, tt, cfg


@pytest.mark.parametrize("mode,pack", [("gq", False), ("gq", True), ("w8a8", False),
                                       ("repack", False), ("qtensor", False)])
def test_synth_llama_params_tree_matches_jax(monkeypatch, mode, pack):
    """Keys, forms and logical shapes as interop gives JAX's tree; the
    embedding and the norms bit-equal."""
    jt, tt, _ = _synth_pair(monkeypatch, mode, pack)
    carried = interop.llama_params_from_numpy(_np(jt), "cpu")
    assert tt.keys() == carried.keys()
    assert tt["layers"].keys() == carried["layers"].keys()
    assert _forms(tt) == _forms(carried)
    for name in ("tok_embeddings", "norm"):
        assert tt[name].dtype == torch.float32 and torch.equal(tt[name], carried[name])
    for name in ("attention_norm", "ffn_norm"):
        assert torch.equal(tt["layers"][name], carried["layers"][name])


def test_synth_qtensor_tree_and_prefill_equal_jax(monkeypatch):
    """qtensor: every packed byte is the JAX tree's, and one 40-row prefill
    gives JAX's logits within the prefill bound."""
    jt, tt, cfg = _synth_pair(monkeypatch, "qtensor")
    carried = interop.llama_params_from_numpy(_np(jt), "cpu")
    for name in ("wqkv", "wo", "w13", "w2"):
        assert torch.equal(tt["layers"][name]["w"].packed, carried["layers"][name]["w"].packed)
    assert torch.equal(tt["output"]["w"].packed, carried["output"]["w"].packed)
    toks = np.random.default_rng(1).integers(0, cfg.n_vocab, (1, 40)).astype(np.int32)
    jcfg = JB.GEOMETRIES[TINY]
    want, _ = jllama.forward(jt, jllama.init_cache(jcfg, 1, jnp.bfloat16),
                             jllama.embed_tokens(jt, jnp.asarray(toks)), jnp.int32(0), jcfg,
                             attn_len=64)
    got = tllama.forward(tt, tllama.init_cache(cfg, 1, torch.bfloat16, "cpu"),
                         tllama.embed_tokens(tt, torch.from_numpy(toks).long()), 0, cfg,
                         attn_len=64)
    want = np.asarray(want)
    assert np.all(np.isfinite(got.numpy()))
    assert np.abs(got.numpy() - want).max() <= PREFILL_TOL * np.abs(want).max()


def test_synth_qtensor_teacher_targets_match_jax(monkeypatch):
    """The draft tool's synthetic tiny teacher in qtensor mode: the port's
    teacher_targets equal JAX's on the same weights away from top-2 ties."""
    jt, tt, cfg = _synth_pair(monkeypatch, "qtensor")
    jcfg = JB.GEOMETRIES[TINY]
    toks = np.random.default_rng(2).integers(0, min(320, cfg.n_vocab), (2, 64)).astype(np.int32)
    logits, _ = jllama.forward(jt, jllama.init_cache(jcfg, 2, jnp.float32),
                               jllama.embed_tokens(jt, jnp.asarray(toks)), jnp.int32(0), jcfg,
                               all_logits=True)
    logits = np.asarray(logits)
    top2 = np.sort(logits, axis=-1)[..., -2:]
    tie = (top2[..., 1] - top2[..., 0]) <= TIE * np.abs(logits).max()
    want = np.asarray(jdraft.teacher_targets(jt, jcfg, jnp.asarray(toks),
                                             cache_dtype=jnp.bfloat16))
    got = tdraft.teacher_targets(tt, cfg, torch.from_numpy(toks), cache_dtype=torch.bfloat16)
    assert np.array_equal(got.numpy()[~tie], want[~tie])
    assert (~tie).mean() > 0.9


@pytest.mark.parametrize("pack", [False, True])
def test_synth_gq_teacher_is_conditioned(monkeypatch, pack):
    """The conditioned q5_k teacher: codes in [0, 31], sub-scales and mins
    in [20, 60], d and dmin exact, and each stacked weight's dequantized
    mean within 5 % of its standard deviation of 0 (mean-cancelling dmin)."""
    _, tt, _ = _synth_pair(monkeypatch, "gq", pack)
    d, dmin = np.float32(TB.GQ_SYNTH_D), np.float32(TB.GQ_SYNTH_D * 15.5)
    for name in ("wqkv", "wo", "w13", "w2", "output"):
        w = tt["output"]["w"] if name == "output" else tt["layers"][name]["w"]
        assert w.exact and w.dtype == DataType.Q5_K and w.packing == ("p5" if pack else "none")
        q = w.codes_int()
        assert int(q.min()) == 0 and int(q.max()) == 31
        for plane in (w.sc6, w.mn6):
            assert plane.dtype == torch.uint8
            assert int(plane.min()) == 20 and int(plane.max()) == 60
        assert torch.all(w.d == torch.tensor(d)) and torch.all(w.dmin == torch.tensor(dmin))
        v = w.dequantize().double()
        assert abs(float(v.mean())) <= 0.05 * float(v.std()), name


def test_synth_vision_params_bit_equal_to_jax():
    """Every vision weight comes from NumPy in JAX's order: the tree equals
    interop's copy of JAX's bit for bit, and encodes within the vision bound."""
    vit = dict(image_size=28, patch_size=14, embed_dim=32, depth=2, head_dim=8, mlp_dim=64)
    qf = dict(hidden_size=16, n_heads=2, n_layers=3, encoder_width=32, query_length=4,
              intermediate_size=32)
    jcfg = jvision.VisionConfig(vit=jvit.ViTConfig(**vit), qformer=jqf.QFormerConfig(**qf),
                                llama_embed_dim=24)
    tcfg = tvision.VisionConfig(vit=ViTConfig(**vit), qformer=QFormerConfig(**qf),
                                llama_embed_dim=24)
    jr, tr = np.random.default_rng(5), np.random.default_rng(5)
    jt = JB.synth_vision_params(jcfg, jr, jnp.float32)
    tt = TB.synth_vision_params(tcfg, tr, torch.float32, "cpu")
    assert tr.integers(0, 2**31) == jr.integers(0, 2**31)
    carried = interop.vision_params_from_numpy(_np(jt), "cpu")

    def same(a, b, path=""):
        assert type(a) is type(b), path
        if isinstance(a, dict):
            assert a.keys() == b.keys(), path
            for k in a:
                same(a[k], b[k], f"{path}.{k}")
        elif isinstance(a, list):
            assert len(a) == len(b), path
            for i, (x, y) in enumerate(zip(a, b)):
                same(x, y, f"{path}[{i}]")
        else:
            assert a.dtype == b.dtype and torch.equal(a, b), path

    same(tt, carried)
    pixels = np.random.default_rng(0).normal(0, 1, (2, 3, 28, 28)).astype(np.float32)
    want = np.asarray(jvision.encode_image(jt, jnp.asarray(pixels), jcfg))
    got = tvision.encode_image(tt, torch.from_numpy(pixels), tcfg).numpy()
    assert got.shape == want.shape == (2, 4, 24)
    assert np.abs(got - want).max() <= ENCODE_TOL * np.abs(want).max()


def _streams():
    """tests/test_bench_helpers.py's three streams."""
    return {"cyclic": np.tile(np.arange(13, dtype=np.int32), 40),
            "random": np.random.default_rng(0).integers(0, 5000, 600).astype(np.int32),
            "realistic": JB.word_tokenize(JB.REALISTIC_TEXT)}


@pytest.mark.parametrize("name", ["cyclic", "random", "realistic"])
@pytest.mark.parametrize("k_spec", [4, 8])
def test_spec_acceptance_equals_jax(name, k_spec):
    stream = _streams()[name]
    got = TB.spec_acceptance_on_stream(stream, k_spec=k_spec)
    assert got == JB.spec_acceptance_on_stream(stream, k_spec=k_spec)
    if name == "cyclic":
        assert got == float(k_spec)


def test_spec_acceptance_refuses_a_short_stream():
    with pytest.raises(ValueError, match="too short"):
        TB.spec_acceptance_on_stream(np.arange(40, dtype=np.int32), k_spec=8)
