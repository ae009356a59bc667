"""The benchmark's models: synthetic weights at the real geometries, and its text.

Counterpart of the first half of ``minigpt4_tpu/benchmark.py``: the
geometries (:data:`GEOMETRIES`, :func:`vit_g_config`), synthetic decoder and
vision weights (:func:`synth_llama_params`, :func:`synth_vision_params`,
:func:`random_packed`), the conditioned gq teacher's scale
(:data:`GQ_SYNTH_D`) and its provenance tag (:func:`synth_teacher_tag`,
:func:`bench_pack_policy`), and the text helpers (:data:`REALISTIC_TEXT`,
:func:`word_tokenize`, :func:`spec_acceptance_on_stream`).  Nothing here
measures anything; the timing half (``bench_decode``, ``bench_encode``,
``chip_state_probe``, ``main``) follows with the port's benchmark.

Weights are random payloads in the exact layout of the real checkpoints, so
a kernel streams the same bytes as it would for the real model.  Every
weight takes one seed from the caller's NumPy ``rng`` where the JAX package
takes one, in the JAX package's order: weights drawn from NumPy (the ggml
bytes of :func:`random_packed`, ``tok_embeddings``, every vision weight)
are the JAX package's bits for the same seed, and the ``rng`` is left in
the same state.  Weights the JAX package draws with ``jax.random`` are
drawn here on ``device`` by a ``torch.Generator`` seeded from that one
draw, so a 13B build never goes through the host.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .formats import DataType, row_bytes, traits
from .models import eva_vit, qformer
from .models import llama as llama_mod
from .models import minigpt4 as vision_mod
from .models.llama import assemble_layers
from .models.params import load_quant_weight, resolve_gq_pack, tensor
from .ops import group_i8 as gq
from .ops import i8_matmul as i8
from .ops import repack as rp

# The synthetic gq teacher's superblock scale d (sub-scales and mins in
# [20, 60], dmin = 15.5 d; see synth_llama_params).  Small values collapse
# the 40-layer map onto a few argmax tokens, large ones make every argmax
# context-unique; the default sits between, where a small drafter can
# learn the teacher (the conditioning chip_smoke.py prints is the card's).
GQ_SYNTH_D = float(os.environ.get("MINIGPT4_TPU_GQ_SYNTH_D", "2e-5"))

# byte offsets, within a ggml block, of each f16 scale field random_packed
# pins to a small constant (so no random bits make a NaN or inf scale)
_SCALE_OFFSETS = {
    DataType.Q4_0: (0,), DataType.Q4_1: (0, 2), DataType.Q5_0: (0,), DataType.Q5_1: (0, 2),
    DataType.Q8_0: (0,), DataType.Q2_K: (80, 82), DataType.Q3_K: (108,),
    DataType.Q4_K: (0, 2), DataType.Q5_K: (0, 2), DataType.Q6_K: (208,),
}
_SMALL_SCALE = 0x14  # high byte of the pinned f16 scale 0x1400 = 2^-10


def bench_pack_policy(cfg: llama_mod.LlamaConfig) -> bool:
    """Whether the benchmark's gq decoder stores its codes packed: the
    port's own decision for an explicit ``gq`` decoder
    (``params.resolve_gq_pack``), the same for every geometry on 80 GB.
    The synthetic teacher's weight stream and its tag depend on it, so the
    draft tool and the benchmark both take this bool as ``pack=``."""
    return resolve_gq_pack("gq")


def synth_teacher_tag(quant_mode: str, pack: bool) -> str:
    """The provenance tag of a draft head distilled against the synthetic
    teacher (``train/draft.py`` ``teacher_mode``): its numerics and its
    weight stream, e.g. ``gq@2e-05+p5``."""
    if quant_mode != "gq":
        return quant_mode
    return f"gq@{GQ_SYNTH_D:g}" + ("+p5" if pack else "")


def _generator(rng: np.random.Generator, device) -> torch.Generator:
    """A generator on ``device`` seeded from one draw of ``rng`` (where the
    JAX package seeds a ``jax.random`` key)."""
    return torch.Generator(device=device).manual_seed(int(rng.integers(0, 2**31)))


def _bytes(shape: tuple, gen: torch.Generator, device) -> torch.Tensor:
    """Uniform random u8 of ``shape``, drawn on ``device``."""
    return torch.randint(0, 256, shape, dtype=torch.uint8, generator=gen, device=device)


def _words(shape: tuple, gen: torch.Generator, device) -> torch.Tensor:
    """Uniform random i32 words (every bit independent) of ``shape``."""
    return _bytes((*shape[:-1], 4 * shape[-1]), gen, device).view(torch.int32)


def random_bytes(rng: np.random.Generator, shape: tuple[int, int], dtype: DataType) -> np.ndarray:
    """ggml bytes ``[N, row_bytes]`` of a random ``[N, K]`` weight, drawn
    from ``rng`` as the JAX package draws them, with every f16 scale field
    pinned to 2^-10 so that every decoded value is finite."""
    dtype = DataType(dtype)
    n_out, n_in = shape
    raw = rng.integers(0, 256, (n_out, row_bytes(dtype, n_in)), dtype=np.uint8)
    bb = traits(dtype).block_bytes
    for off in _SCALE_OFFSETS[dtype]:
        raw[:, off::bb] = 0x00
        raw[:, off + 1::bb] = _SMALL_SCALE
    return raw


def random_packed(rng: np.random.Generator, shape: tuple[int, int], dtype: DataType,
                  mode: str = "auto", device: str | torch.device = "cuda"):
    """A random ``[N, K]`` weight in the form ``mode`` gives it.

    ``"repack"``: the port's :class:`~.ops.repack.RepackedQuant` with codes
    and high bits drawn on ``device`` (one seed from ``rng``), scales 0.002
    and mins 0.  Every other mode draws the ggml bytes from ``rng``
    (:func:`random_bytes`) and loads them with ``params.load_quant_weight``,
    so the weight dequantizes to the JAX package's bits for the same seed;
    ``"auto"`` is then the loader's ``auto``, the repacked form of those
    bytes (the JAX package's ``auto`` repacks on a TPU and keeps the bytes
    elsewhere: both dequantize to the same values, the pinned scales being
    exact in bf16)."""
    dtype = DataType(dtype)
    if mode == "repack":
        return _random_repacked(rng, shape, dtype, None, device)
    return load_quant_weight(random_bytes(rng, shape, dtype).reshape(-1), shape, dtype, device,
                             mode)


def _random_repacked(rng: np.random.Generator, shape: tuple[int, int], dtype: DataType,
                     layers: int | None, device) -> rp.RepackedQuant:
    """A :class:`~.ops.repack.RepackedQuant` (stacked ``[layers, ...]`` when
    ``layers``) with random codes and high bits and constant planes, drawn
    on ``device``: the layout and bytes of a real repacked checkpoint."""
    n_out, n_in = shape
    lead = () if layers is None else (layers,)
    code_bits, hi_bits = rp.LAYOUT[dtype]
    gs = gq.group_size(dtype)
    gen = _generator(rng, device)
    if code_bits == 4:
        codes = _bytes((*lead, n_out, n_in // 2), gen, device)
    else:
        codes = _bytes((*lead, n_out, n_in), gen, device).view(torch.int8)
    hi = _words((*lead, n_out, n_in * hi_bits // 32), gen, device) if hi_bits else None
    planes = (*lead, n_out, n_in // gs)
    return rp.RepackedQuant(
        codes=codes, scales=torch.full(planes, 0.002, dtype=torch.bfloat16, device=device),
        mins=torch.zeros(planes, dtype=torch.bfloat16, device=device), hi=hi, dtype=dtype,
        n_in=n_in, group_size=gs, code_bits=code_bits, hi_bits=hi_bits)


def _synth_gq(rng: np.random.Generator, n_out: int, n_in: int, lead: tuple, pack: bool,
              device) -> gq.GroupQuant:
    """The conditioned synthetic q5_k group-quant weight: codes uniform in
    [0, 31] (p5-packed when ``pack``: nibble bytes and high-bit words are
    uniform, so the logical codes are too), sub-scales and mins uniform in
    [20, 60], d = GQ_SYNTH_D and dmin = 15.5 d.  Constant planes would give
    every weight the same positive mean, a rank-one common mode that drives
    a deep forward to one fixed point (the teacher's argmax collapses);
    E[sc6] = E[mn6] = 40 and dmin = 15.5 d cancel the mean per group in
    expectation while the varied sub-scales keep the rows distinct."""
    gen = _generator(rng, device)
    if pack:
        codes = _bytes((*lead, n_out, n_in // 2), gen, device)
        hi = _words((*lead, n_out, n_in // 32), gen, device)
    else:
        codes = torch.randint(0, 32, (*lead, n_out, n_in), dtype=torch.int8, generator=gen,
                              device=device)
        hi = None
    g, sb = n_in // 32, n_in // 256

    def sub(shape):
        return torch.randint(20, 61, shape, dtype=torch.uint8, generator=gen, device=device)

    return gq.GroupQuant(
        codes=codes, hi=hi, packing="p5" if pack else "none", dtype=DataType.Q5_K, n_in=n_in,
        group_size=32, sc6=sub((*lead, g, n_out)), mn6=sub((*lead, g, n_out)),
        d=torch.full((*lead, sb, n_out), GQ_SYNTH_D, dtype=torch.float32, device=device),
        dmin=torch.full((*lead, sb, n_out), GQ_SYNTH_D * 15.5, dtype=torch.float32,
                        device=device))


def _synth_i8(rng: np.random.Generator, n_out: int, n_in: int, lead: tuple,
              device) -> i8.I8SBQuant:
    """Random i8 codes drawn on ``device`` with constant scales 2e-4."""
    gen = _generator(rng, device)
    codes = _bytes((*lead, n_out, n_in), gen, device).view(torch.int8)
    return i8.I8SBQuant(codes, torch.full((*lead, n_out, n_in // i8.SB), 2e-4,
                                          dtype=torch.float32, device=device), n_in)


def synth_llama_params(cfg: llama_mod.LlamaConfig, qtype: DataType, rng: np.random.Generator,
                       dtype: torch.dtype = torch.float32, quant_mode: str = "auto",
                       device: str | torch.device = "cuda", pack: bool | None = None) -> dict:
    """Random decoder params of ``cfg``, in the tree ``llama.load_params``
    gives (fused ``wqkv`` / ``w13``, stacked over layers).

    * ``"gq"``: the conditioned q5_k group-quant teacher of :func:`_synth_gq`
      (``qtype`` is not read), its codes packed p5 when ``pack`` (default
      :func:`bench_pack_policy`);
    * ``"w8a8"``: :class:`~.ops.i8_matmul.I8SBQuant` with random codes and
      scales 2e-4;
    * ``"repack"``: stacked repacked planes of ``qtype`` drawn on ``device``;
    * any other mode: :func:`random_packed` per layer and projection
      (wq, wk, wv, wo, w1, w2, w3, as the JAX package draws them), loaded
      in that mode and assembled as the loader assembles a file.

    ``tok_embeddings`` (normal, std 0.02) is drawn last from ``rng`` and is
    the JAX package's for the same seed; the norms are ones in ``dtype``."""
    d, ff, v, n_l = cfg.n_embd, cfg.n_ff, cfg.n_vocab, cfg.n_layer
    qtype = DataType(qtype)
    if quant_mode in ("gq", "w8a8", "repack"):
        if quant_mode == "gq":
            pk = bench_pack_policy(cfg) if pack is None else pack

            def make(n_out, n_in, lead):
                return _synth_gq(rng, n_out, n_in, lead, pk, device)
        elif quant_mode == "w8a8":
            def make(n_out, n_in, lead):
                return _synth_i8(rng, n_out, n_in, lead, device)
        else:
            def make(n_out, n_in, lead):
                return _random_repacked(rng, (n_out, n_in), qtype, lead[0] if lead else None,
                                        device)
        layers = {}
        for name, (n_out, n_in) in (("wqkv", (3 * d, d)), ("wo", (d, d)),
                                    ("w13", (2 * ff, d)), ("w2", (d, ff))):
            layers[name] = {"w": make(n_out, n_in, (n_l,))}
        out_w = make(v, d, ())
    else:
        shapes = {"wq": (d, d), "wk": (d, d), "wv": (d, d), "wo": (d, d), "w1": (ff, d),
                  "w2": (d, ff), "w3": (ff, d)}
        per_layer = [{name: random_packed(rng, shape, qtype, quant_mode, device)
                      for name, shape in shapes.items()} for _ in range(n_l)]
        layers = assemble_layers(per_layer)
        out_w = random_packed(rng, (v, d), qtype, quant_mode, device)
    for name in ("attention_norm", "ffn_norm"):
        layers[name] = torch.ones((n_l, d), dtype=dtype, device=device)
    emb = rng.normal(0, 0.02, (v, d)).astype(np.float32)
    return {"tok_embeddings": tensor(emb, dtype, device),
            "norm": torch.ones((d,), dtype=dtype, device=device),
            "output": {"w": out_w}, "layers": layers}


def synth_vision_params(cfg: vision_mod.VisionConfig, rng: np.random.Generator,
                        dtype: torch.dtype = torch.float32,
                        device: str | torch.device = "cuda") -> dict:
    """Random vision params of ``cfg`` (dense ``[in, out]`` weights, normal
    with std 0.02, zero biases, unit norms), every draw from ``rng`` in the
    JAX package's order, so the tree is the JAX package's for the same
    seed; the ViT's blocks are stacked, the Q-Former's layers a list."""
    vit, qf = cfg.vit, cfg.qformer

    def normal(std, shape):
        return tensor(rng.normal(0, std, shape).astype(np.float32), dtype, device)

    def zeros(n):
        return torch.zeros((n,), dtype=dtype, device=device)

    def lin(k, n, bias=True):
        p = {"w": normal(0.02, (k, n))}
        if bias:
            p["b"] = zeros(n)
        return p

    def ln(n):
        return {"g": torch.ones((n,), dtype=dtype, device=device), "b": zeros(n)}

    d = vit.embed_dim
    blocks = [{"norm1": ln(d), "qkv": lin(d, 3 * d), "proj": lin(d, d), "norm2": ln(d),
               "fc1": lin(d, vit.mlp_dim), "fc2": lin(vit.mlp_dim, d)}
              for _ in range(vit.depth)]
    vparams = {
        "patch_embed": lin(3 * vit.patch_size ** 2, d),
        "cls_token": zeros(d),
        "pos_embed": normal(0.02, (vit.n_patches_side ** 2 + 1, d)),
        "blocks": eva_vit._stack(blocks),
    }
    h = qf.hidden_size

    def attn(kv_width):
        return {"query": lin(h, h), "key": lin(kv_width, h), "value": lin(kv_width, h),
                "dense": lin(h, h), "ln": ln(h)}

    qlayers = []
    for i in range(qf.n_layers):
        lp = {"self": attn(h)}
        if i % 2 == 0:
            lp["cross"] = attn(qf.encoder_width)
        lp["intermediate_query"] = lin(h, qf.intermediate_size)
        lp["output_query"] = lin(qf.intermediate_size, h)
        lp["output_ln"] = ln(h)
        qlayers.append(lp)
    qparams = {"query_tokens": normal(0.5, (qf.query_length, h)), "ln_embed": ln(h),
               "layers": qlayers}
    return {"visual_encoder": vparams, "ln_vision": ln(d), "qformer": qparams,
            "llama_proj": lin(h, cfg.llama_embed_dim)}


GEOMETRIES = {
    "7B": llama_mod.LlamaConfig(n_vocab=32000, n_embd=4096, n_head=32, n_layer=32,
                                n_rot=128, n_ff=11008, n_ctx=2048),
    "13B": llama_mod.LlamaConfig(n_vocab=32000, n_embd=5120, n_head=40, n_layer=40,
                                 n_rot=128, n_ff=13824, n_ctx=2048),
    # a CPU smoke geometry: every path in seconds, nothing performance-meaningful
    "tiny": llama_mod.LlamaConfig(n_vocab=256, n_embd=256, n_head=2, n_layer=2,
                                  n_rot=128, n_ff=512, n_ctx=1024),
}


def vit_g_config(llama_embed: int) -> vision_mod.VisionConfig:
    """MiniGPT-4's ViT-G and Q-Former in front of a decoder of width ``llama_embed``."""
    return vision_mod.VisionConfig(vit=eva_vit.ViTConfig(), qformer=qformer.QFormerConfig(),
                                   llama_embed_dim=llama_embed)


# Original assistant-style prose: ordinary non-repetitive chat text, the
# pessimistic workload for n-gram prompt-lookup drafting, and the held-out
# evaluation stream of the draft tool.
REALISTIC_TEXT = """
The picture shows a small wooden boat resting on a pebble beach at low tide.
The hull is painted in two tones, a faded blue above the waterline and a
dark red below it, and the paint is flaking near the bow. A coiled rope
lies across the front bench, and a single oar leans against the starboard
side. Behind the boat the beach rises toward a line of dune grass, and past
the grass there is a row of low cottages with slate roofs. The sky is
overcast but bright, which softens the shadows and makes the colors of the
hull stand out against the grey stones. There are no people visible in the
frame, though a set of footprints runs from the water to the dunes.
The text in the picture is painted on the bow of the boat. It reads
"Marigold" in white serif letters, followed by a smaller registration mark
that is partly worn away. The first three characters of the mark are legible
and appear to be K, 4, and 7; the rest is too faded to read with
confidence. The name is repeated on a small plaque near the stern, where it
is easier to read because the plaque is sheltered from the weather.
The color of it depends on which part you mean. The upper hull is a faded
blue, close to slate blue, while the lower hull is a dark red that shades
toward brown where the paint has thinned. The interior benches are
unpainted wood, grey from exposure. If you mean the lettering, the
lettering is white with a thin dark outline, and the plaque near the stern
has a brass border that has gone green at the corners. Overall the palette
of the image is muted: grey stones, grey sky, dune grass in pale green,
and the two tones of the hull carrying most of the saturation.
To summarize, the image is a quiet coastal scene centered on a beached
rowing boat named Marigold, with no people present, soft overcast light,
and a limited palette in which the blue and red of the hull are the
strongest colors. The most legible text is the name on the bow, and the
registration mark beginning K47 is only partly readable.
"""


def spec_acceptance_on_stream(stream: np.ndarray, k_spec: int = 8, warm: int = 64) -> float:
    """Teacher-forced n-gram drafting acceptance: the average tokens a
    verify pass would emit if the model's greedy output were ``stream``.

    The engine's draft function (``llama._ngram_draft``) runs at every
    position from ``warm`` on, batched over the positions, each row's
    history masked to the tokens evaluated so far; the passes are then
    walked on the host (a pass at position p emits 1 + the leading drafts
    that match the stream's continuation and advances past them: the
    verify rule)."""
    stream = np.asarray(stream, np.int32)
    c = len(stream)
    k_draft = k_spec - 1
    if c < warm + k_spec + 1:
        raise ValueError(f"stream of {c} tokens is too short for warm={warm}, k={k_spec}")
    pos_list = np.arange(warm, c - k_spec, dtype=np.int32)
    hist = np.where(np.arange(c)[None, :] < pos_list[:, None], stream[None, :], -1)
    drafts = llama_mod._ngram_draft(torch.from_numpy(hist), torch.from_numpy(pos_list),
                                    torch.from_numpy(stream[pos_list]), k_draft).numpy()
    passes = emitted = 0
    pos, last = int(pos_list[0]), int(pos_list[-1])
    while pos <= last:
        d = drafts[pos - warm]
        actual = stream[pos + 1:pos + k_spec]
        acc = 0
        while acc < k_draft and d[acc] == actual[acc]:
            acc += 1
        emitted += 1 + acc
        passes += 1
        pos += 1 + acc
    return emitted / max(passes, 1)


def word_tokenize(text: str) -> np.ndarray:
    """Word-level ids (a stand-in at BPE granularity; ids in first-seen order)."""
    ids: dict[str, int] = {}
    return np.asarray([ids.setdefault(w, len(ids)) for w in text.split()], np.int32)
