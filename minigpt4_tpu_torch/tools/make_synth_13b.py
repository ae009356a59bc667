"""Write a real-geometry synthetic model-file pair (container + ggjt) to disk.

Counterpart of the JAX package's ``tools/make_synth_13b.py``, with its flags,
constants and draw order: from ``default_rng(0)`` it writes the same bytes
(``tests/test_torch_repo_tools.py`` holds both files sha256-equal at a tiny
geometry).  A Vicuna-13B-geometry ggjt-v3 q5_k file and a ViT-g / Q-Former
container on disk let the whole deploy path (engine build from the files,
encode, image prefill, first token; ``coldstart_probe``) run as a user runs
it, with no real checkpoint.

Weight values are meaningless (outputs are garbage tokens); every byte layout
is faithful: ggjt v3 header, vocabulary and tensor records, q5_k super-blocks
from the port's own quantizer (``formats/quants.py``), the container's JSON
config and per-submodel tensor tables.  Quantized tensors tile a few properly
quantized random rows: quantizing 13e9 Gaussians would take about an hour for
no measurement value.

It is host-only NumPy: ~11 GB written, ~1 B normals drawn for the ViT.

    python -m minigpt4_tpu_torch.tools.make_synth_13b --out build/synth13b [--vit-f32]

Writes <out>/minigpt4-13B.bin and <out>/vicuna-13b-q5_k.bin.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np

from ..formats import ContainerWriter, DataType, LlamaFileWriter, LlamaHParams, LlamaVocab, quants

# ViT-g / Q-Former / LLaMA-13B real geometry (models/eva_vit.py,
# models/qformer.py defaults; benchmark.GEOMETRIES["13B"])
VIT_D, VIT_DEPTH, VIT_MLP = 1408, 39, 6144
QF_HIDDEN, QF_LAYERS, QF_HEADS, QF_QUERIES = 768, 12, 12, 32
LLM_D, LLM_HEADS, LLM_LAYERS, LLM_FF, VOCAB = 5120, 40, 40, 13824, 32000


def _payload(a: np.ndarray, f16: bool):
    if f16:
        raw = np.ascontiguousarray(a, np.float32).astype("<f2")
        return a.shape, DataType.F16, raw.view(np.uint8).reshape(-1)
    raw = np.ascontiguousarray(a, np.float32).astype("<f4")
    return a.shape, DataType.F32, raw.view(np.uint8).reshape(-1)


def _q5k_rows(rng: np.random.Generator, n: int, k: int) -> np.ndarray:
    """[n, k] q5_k raw bytes: quantize 8 distinct random rows, tile to n."""
    base = min(8, n)
    rows = rng.normal(0, 0.03, (base, k)).astype(np.float32)
    raw = quants.quantize(rows.reshape(-1), DataType.Q5_K)
    block = raw.reshape(base, raw.size // base)
    return np.tile(block, (-(-n // base), 1))[:n].reshape(-1)


def build_container_13b(path: Path, rng: np.random.Generator, vit_f16: bool = True) -> Path:
    cfg = {
        "ftype": "f16" if vit_f16 else "f32",
        "vit": {"head_dim": VIT_D // 16},
        "Qformer": {
            "encoder_width": VIT_D,
            "query_length": QF_QUERIES,
            "num_hidden_layers": QF_LAYERS,
            "hidden_size": QF_HIDDEN,
            "num_attention_heads": QF_HEADS,
            "intermediate_size": QF_HIDDEN * 4,
        },
    }
    w = ContainerWriter(path, ftype=0 if vit_f16 else 1, config=cfg)

    def n(*shape, scale=0.02):
        return rng.standard_normal(shape, dtype=np.float32) * scale

    def add_t(tensors, name, arr, big=False):
        shape, dt, raw = _payload(arr, vit_f16 and big)
        tensors.append((name, shape, dt, raw))

    ve = []
    add_t(ve, "patch_embed.proj.weight", n(VIT_D, 3, 14, 14), big=True)
    add_t(ve, "patch_embed.proj.bias", n(VIT_D))
    add_t(ve, "cls_token", n(VIT_D))
    add_t(ve, "pos_embed", n(257, VIT_D), big=True)  # (224/14)^2 + 1
    for i in range(VIT_DEPTH):
        p = f"blocks.{i}."
        add_t(ve, p + "norm1.weight", 1 + n(VIT_D))
        add_t(ve, p + "norm1.bias", n(VIT_D))
        add_t(ve, p + "attn.qkv.weight", n(3 * VIT_D, VIT_D), big=True)
        add_t(ve, p + "attn.q_bias", n(VIT_D))
        add_t(ve, p + "attn.v_bias", n(VIT_D))
        add_t(ve, p + "attn.proj.weight", n(VIT_D, VIT_D), big=True)
        add_t(ve, p + "attn.proj.bias", n(VIT_D))
        add_t(ve, p + "norm2.weight", 1 + n(VIT_D))
        add_t(ve, p + "norm2.bias", n(VIT_D))
        add_t(ve, p + "mlp.fc1.weight", n(VIT_MLP, VIT_D), big=True)
        add_t(ve, p + "mlp.fc1.bias", n(VIT_MLP))
        add_t(ve, p + "mlp.fc2.weight", n(VIT_D, VIT_MLP), big=True)
        add_t(ve, p + "mlp.fc2.bias", n(VIT_D))
    w.add_model("visual_encoder", ve)

    ln = []
    add_t(ln, "weight", 1 + n(VIT_D))
    add_t(ln, "bias", n(VIT_D))
    w.add_model("ln_vision", ln)

    qt = []
    add_t(qt, "weight", n(QF_QUERIES, QF_HIDDEN))
    w.add_model("query_tokens", qt)

    qf = []
    add_t(qf, "bert.embeddings.LayerNorm.weight", 1 + n(QF_HIDDEN))
    add_t(qf, "bert.embeddings.LayerNorm.bias", n(QF_HIDDEN))
    for i in range(QF_LAYERS):
        p = f"bert.encoder.layer.{i}."
        for blk, width in [("attention.", QF_HIDDEN)] + (
                [("crossattention.", VIT_D)] if i % 2 == 0 else []):
            add_t(qf, p + blk + "self.query.weight", n(QF_HIDDEN, QF_HIDDEN), big=True)
            add_t(qf, p + blk + "self.query.bias", n(QF_HIDDEN))
            add_t(qf, p + blk + "self.key.weight", n(QF_HIDDEN, width), big=True)
            add_t(qf, p + blk + "self.key.bias", n(QF_HIDDEN))
            add_t(qf, p + blk + "self.value.weight", n(QF_HIDDEN, width), big=True)
            add_t(qf, p + blk + "self.value.bias", n(QF_HIDDEN))
            add_t(qf, p + blk + "output.dense.weight", n(QF_HIDDEN, QF_HIDDEN), big=True)
            add_t(qf, p + blk + "output.dense.bias", n(QF_HIDDEN))
            add_t(qf, p + blk + "output.LayerNorm.weight", 1 + n(QF_HIDDEN))
            add_t(qf, p + blk + "output.LayerNorm.bias", n(QF_HIDDEN))
        add_t(qf, p + "intermediate_query.dense.weight", n(QF_HIDDEN * 4, QF_HIDDEN), big=True)
        add_t(qf, p + "intermediate_query.dense.bias", n(QF_HIDDEN * 4))
        add_t(qf, p + "output_query.dense.weight", n(QF_HIDDEN, QF_HIDDEN * 4), big=True)
        add_t(qf, p + "output_query.dense.bias", n(QF_HIDDEN))
        add_t(qf, p + "output_query.LayerNorm.weight", 1 + n(QF_HIDDEN))
        add_t(qf, p + "output_query.LayerNorm.bias", n(QF_HIDDEN))
    w.add_model("Qformer", qf)

    pj = []
    add_t(pj, "weight", n(LLM_D, QF_HIDDEN), big=True)
    add_t(pj, "bias", n(LLM_D))
    w.add_model("llama_proj", pj)
    w.write()
    return path


def build_llm_13b(path: Path, rng: np.random.Generator) -> Path:
    hp = LlamaHParams(n_vocab=VOCAB, n_embd=LLM_D, n_mult=256, n_head=LLM_HEADS,
                      n_layer=LLM_LAYERS, n_rot=LLM_D // LLM_HEADS,
                      ftype=17)  # 17 = q5_k ftype tag
    assert hp.n_ff == LLM_FF, hp.n_ff
    toks = [b"<unk>", b"<s>", b"</s>"] + [bytes([b]) for b in range(256)]
    toks += [b" Human", b" Assistant", b"###"]
    toks += [f" piece{i}".encode() for i in range(VOCAB - len(toks))]
    scores = [0.0] * 259 + [1.0] * (VOCAB - 259)
    w = LlamaFileWriter(path, hp, LlamaVocab(tokens=toks, scores=scores))

    def add_q(name, n_out, n_in):
        w.add_tensor(name, (n_out, n_in), DataType.Q5_K, _q5k_rows(rng, n_out, n_in))

    emb = rng.standard_normal((VOCAB, LLM_D), dtype=np.float32) * 0.02
    w.add_tensor("tok_embeddings.weight", emb.shape, DataType.F32,
                 emb.astype("<f4").view(np.uint8).reshape(-1))
    w.add_tensor("norm.weight", (LLM_D,), DataType.F32, np.ones(LLM_D, "<f4").view(np.uint8))
    add_q("output.weight", VOCAB, LLM_D)
    one = np.ones(LLM_D, "<f4").view(np.uint8)
    for i in range(LLM_LAYERS):
        p = f"layers.{i}."
        w.add_tensor(p + "attention_norm.weight", (LLM_D,), DataType.F32, one)
        add_q(p + "attention.wq.weight", LLM_D, LLM_D)
        add_q(p + "attention.wk.weight", LLM_D, LLM_D)
        add_q(p + "attention.wv.weight", LLM_D, LLM_D)
        add_q(p + "attention.wo.weight", LLM_D, LLM_D)
        w.add_tensor(p + "ffn_norm.weight", (LLM_D,), DataType.F32, one)
        add_q(p + "feed_forward.w1.weight", LLM_FF, LLM_D)
        add_q(p + "feed_forward.w2.weight", LLM_D, LLM_FF)
        add_q(p + "feed_forward.w3.weight", LLM_FF, LLM_D)
    w.write()
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="build/synth13b")
    ap.add_argument("--vit-f32", action="store_true",
                    help="write the container float tensors as f32 (default f16)")
    ap.add_argument("--skip-container", action="store_true")
    ap.add_argument("--skip-llm", action="store_true")
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    if not args.skip_container:
        t0 = time.perf_counter()
        p = build_container_13b(out / "minigpt4-13B.bin", rng, vit_f16=not args.vit_f32)
        print(f"[synth13b] {p} ({p.stat().st_size/1e9:.2f} GB, {time.perf_counter()-t0:.0f}s)")
    if not args.skip_llm:
        t0 = time.perf_counter()
        p = build_llm_13b(out / "vicuna-13b-q5_k.bin", rng)
        print(f"[synth13b] {p} ({p.stat().st_size/1e9:.2f} GB, {time.perf_counter()-t0:.0f}s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
