"""A tiny llama.cpp file in the Q5_K_M layout, for the port's tests.

llama.cpp's quantizer (llama_model_quantize_internal) writes a "q5_k" file
in the Q5_K_M layout: ``output`` q6_k, ``attention.wv`` and
``feed_forward.w2`` q6_k on the layers its use_more_bits rule picks, every
other 2-D weight q5_k, ``tok_embeddings`` included.  build_llm_q5_k_m writes that
layout at the gq geometry of tests/fixtures.py (D 256, FF 768) with 4
layers, so wv/w2 are q6_k on layers 2 and 3.  This module imports no JAX
and names nothing of the JAX package: tests/test_torch_generic.py (parity
with JAX) and tests/test_torch_cuda.py (on the card) both build the file
with it.  It also holds the port's file formats to the fixtures that the
JAX package's writers make.
"""

import numpy as np

from fixtures import GQ_D, GQ_FF, GQ_HEADS, VOCAB, build_gq_models
from minigpt4_tpu_torch.formats import (ContainerReader, ContainerWriter, DataType, LlamaFileReader,
                                        LlamaFileWriter, LlamaHParams, LlamaVocab)
from minigpt4_tpu_torch.formats import quants as nq

KM_LAYERS = 4


def more_bits(i: int, n_layer: int) -> bool:
    """llama.cpp's use_more_bits: the layers whose wv and w2 Q5_K_M makes q6_k."""
    return i < n_layer // 8 or i >= 7 * n_layer // 8 or (i - n_layer // 8) % 3 == 2


def build_llm_q5_k_m(path, rng: np.random.Generator):
    hp = LlamaHParams(n_vocab=VOCAB, n_embd=GQ_D, n_mult=256, n_head=GQ_HEADS,
                      n_layer=KM_LAYERS, n_rot=GQ_D // GQ_HEADS, ftype=17)  # MOSTLY_Q5_K_M
    assert hp.n_ff == GQ_FF
    toks = [b"<unk>", b"<s>", b"</s>"] + [bytes([b]) for b in range(256)]
    toks += [b" Human", b" Assistant", b"###"]
    w = LlamaFileWriter(path, hp, LlamaVocab(tokens=toks, scores=[0.0] * 259 + [1.0, 1.0, 2.0]))

    def add(name, shape, dtype=None, scale=0.05, one=False):
        arr = rng.normal(0, scale, shape).astype(np.float32) + (1.0 if one else 0.0)
        if dtype is None:
            w.add_tensor(name, shape, DataType.F32, arr.astype("<f4").view(np.uint8).reshape(-1))
        else:
            w.add_tensor(name, shape, dtype, nq.quantize(arr.reshape(-1), dtype))

    q5, q6 = DataType.Q5_K, DataType.Q6_K
    add("tok_embeddings.weight", (VOCAB, GQ_D), q5, scale=0.2)
    add("norm.weight", (GQ_D,), one=True)
    add("output.weight", (VOCAB, GQ_D), q6, scale=0.2)
    for i in range(KM_LAYERS):
        p = f"layers.{i}."
        big = q6 if more_bits(i, KM_LAYERS) else q5
        add(p + "attention_norm.weight", (GQ_D,), one=True)
        add(p + "attention.wq.weight", (GQ_D, GQ_D), q5)
        add(p + "attention.wk.weight", (GQ_D, GQ_D), q5)
        add(p + "attention.wv.weight", (GQ_D, GQ_D), big)
        add(p + "attention.wo.weight", (GQ_D, GQ_D), q5)
        add(p + "ffn_norm.weight", (GQ_D,), one=True)
        add(p + "feed_forward.w1.weight", (GQ_FF, GQ_D), q5)
        add(p + "feed_forward.w2.weight", (GQ_D, GQ_FF), big)
        add(p + "feed_forward.w3.weight", (GQ_FF, GQ_D), q5)
    w.write()
    return path


def test_more_bits_rule_matches_llama_cpp_counts():
    # q6_k wv/w2 on 20 of 40 layers (13B), 16 of 32 (7B), layers 2 and 3 of 4
    assert sum(more_bits(i, 40) for i in range(40)) == 20
    assert sum(more_bits(i, 32) for i in range(32)) == 16
    assert [i for i in range(4) if more_bits(i, 4)] == [2, 3]


def test_written_file_has_the_q5_k_m_layout(tmp_path):
    path = build_llm_q5_k_m(tmp_path / "km.bin", np.random.default_rng(0))
    with LlamaFileReader(path) as r:
        types = {name: DataType(rec.dtype) for name, rec in r.tensors.items()}
    assert types["output.weight"] == types["layers.3.attention.wv.weight"] == DataType.Q6_K
    assert types["tok_embeddings.weight"] == types["layers.1.feed_forward.w2.weight"] == DataType.Q5_K
    assert [types[f"layers.{i}.feed_forward.w2.weight"] for i in range(KM_LAYERS)] == \
        [DataType.Q5_K] * 2 + [DataType.Q6_K] * 2


def test_port_formats_rewrite_the_jax_fixtures_byte_equal(tmp_path):
    """The gq fixture pair, written by the JAX package's writers, read by the
    port's readers and written back by the port's writers: the same bytes."""
    model, llm = build_gq_models(tmp_path)
    with ContainerReader(model) as r:
        w = ContainerWriter(tmp_path / "container.bin", ftype=r.ftype, config=r.config)
        for name, sm in r.models.items():
            w.add_model(name, [(t, rec.shape, rec.dtype, np.array(r.raw(name, t)))
                               for t, rec in sm.tensors.items()])
        w.write()
        assert r.tensor_f32("llama_proj", "weight").shape == (GQ_D, r.config["Qformer"]["hidden_size"])
    assert (tmp_path / "container.bin").read_bytes() == model.read_bytes()
    with LlamaFileReader(llm) as r:
        w = LlamaFileWriter(tmp_path / "llm.bin", r.hparams, r.vocab)
        for name, rec in r.tensors.items():
            w.add_tensor(name, rec.shape, rec.dtype, np.array(r.raw(name)))
        w.write()
        assert any(rec.dtype == DataType.Q5_K for rec in r.tensors.values())
        wq = r.tensor_f32("layers.0.attention.wq.weight")
        assert wq.shape == (GQ_D, GQ_D) and np.isfinite(wq).all()
    assert (tmp_path / "llm.bin").read_bytes() == llm.read_bytes()
