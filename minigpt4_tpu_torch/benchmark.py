"""The benchmark: synthetic models at the real geometries, and their timing.

Counterpart of ``minigpt4_tpu/benchmark.py``.  The models half: the
geometries (:data:`GEOMETRIES`, :func:`vit_g_config`), synthetic decoder and
vision weights (:func:`synth_llama_params`, :func:`synth_vision_params`,
:func:`random_packed`), the conditioned gq teacher's scale
(:data:`GQ_SYNTH_D`) and its provenance tag (:func:`synth_teacher_tag`,
:func:`bench_pack_policy`), and the text helpers (:data:`REALISTIC_TEXT`,
:func:`word_tokenize`, :func:`spec_acceptance_on_stream`).  The timing half:
:func:`chip_state_probe` (the card's matvec GB/s), :func:`bench_decode`
(prefill, TTFT, stepwise and fused decode, then the single-stream
speculation riders and the serving riders), :func:`bench_encode` (ViT-G and
the Q-Former) and :func:`main`, with JAX's names, arguments and result keys:

    python -m minigpt4_tpu_torch.benchmark --model 13B --quant-mode gq

Weights are random payloads in the exact layout of the real checkpoints, so
a kernel streams the same bytes as it would for the real model.  Every
weight takes one seed from the caller's NumPy ``rng`` where the JAX package
takes one, in the JAX package's order: weights drawn from NumPy (the ggml
bytes of :func:`random_packed`, ``tok_embeddings``, every vision weight)
are the JAX package's bits for the same seed, and the ``rng`` is left in
the same state.  Weights the JAX package draws with ``jax.random`` are
drawn here on ``device`` by a ``torch.Generator`` seeded from that one
draw, so a 13B build never goes through the host.

Timing follows what the port's engine runs.  What the engine captures as
CUDA graphs (``engine/graphs.py``) is timed as replays of the same
``StepGraphs`` steps: the state's prefill buckets, single step and decode
chunks, the single-stream n-gram dispatches, the paged group's chunk and
the encoder.  What the engine runs eagerly is timed eagerly: the drafted
loops (``engine._draft_chunk``), batched speculation
(``SessionPool._group_step`` with passes) and the dense batched group.
:data:`SECTION_GRAPHS` records which is which, and each run says on stderr.
Times are the host's clock around work that ends in a host fetch of the ids
(or ``torch.cuda.synchronize()``), as a user waits for it; the calibration
:func:`chip_state_probe` times CUDA graphs with CUDA events.  Two numbers
differ in meaning from the JAX package's: ``ttft_first_ms`` includes the
capture of the prefill graph (where JAX's includes its compile) and
``build_s`` includes drawing the codes on the card (JAX's, uploading them);
neither is a compile time.  Every result carries ``device``: the card's name
and power limit (``tools/_harness.card``), or "cpu" for a CPU run, which the
tests make and which measures nothing of the card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import statistics
import sys
import time
from pathlib import Path

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
from .engine.device_sampling import lane_rows
from .engine.engine import CACHE_DTYPES, _attn_bucket
from .engine.graphs import GraphCache, StepGraphs
from .engine.paged import PAGE, PagedKVPool
from .engine.sampling import SamplingParams
from .tools._harness import HBM_BPS, card

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


# ---------------------------------------------------------------------------
# the timing half
# ---------------------------------------------------------------------------

# a chip_state_probe reading above this share of the H100's 3.35 TB/s (the
# data sheet's HBM rate) is a timing fault, not a fast card
PROBE_MAX_SHARE = 1.05
# how each section of bench_decode and bench_encode runs: as replays of the
# graphs the engine captures for the same steps, or eagerly, as the engine
# runs it (on the CPU every section runs eagerly)
SECTION_GRAPHS = {"core": "captured", "spec": "captured", "stoch_spec": "captured",
                  "draft_spec": "eager", "draft_head": "eager", "batched": "eager",
                  "batched_spec": "eager", "paged": "captured", "paged_spec": "eager",
                  "encode": "captured"}
DRAFT_ARTIFACT = Path(__file__).parent / "assets" / "bench_draft_13b.npz"


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _host(t: torch.Tensor) -> np.ndarray:
    """``t`` on the host: the run's sync point (the copy waits for the work
    queued before it)."""
    return t.cpu().numpy()


def _pool(dev: torch.device):
    """A graph memory pool that every captured step of one run shares, or
    None on the CPU."""
    return torch.cuda.graph_pool_handle() if dev.type == "cuda" else None


@torch.no_grad()
def chip_state_probe(n: int = 8192, short: int = 8, long: int = 40,
                     device: str | torch.device = "cuda") -> float:
    """Effective GB/s of a chain of dependent bf16 ``[1, n] x [n, n]``
    matvecs (``torch.matmul``: a calibration, not a port of a kernel), the
    card-state reading that rides along with the benchmark's numbers: decode
    tok/s is bytes over rate, so this says what rate the card offered when
    they were taken.  Slope method: each chain, of ``short`` and of ``long``
    matvecs, is one captured CUDA graph timed by CUDA events (best of 3), so
    neither host dispatch nor launch latency enters the difference.  At the
    default n the weight is 134 MB, beyond the 50 MB L2.  On the card a
    reading above PROBE_MAX_SHARE x 3.35 TB/s raises: the timing is wrong.
    On the CPU (tests) the chains run eagerly under the host clock."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(3)
    w = (torch.randn((n, n), generator=gen, device=dev) * 0.01).to(torch.bfloat16)
    x0 = torch.ones((1, n), dtype=torch.bfloat16, device=dev)

    def chain(k: int) -> torch.Tensor:
        x = x0
        for _ in range(k):
            x = torch.matmul(x, w)
        return x

    def chain_s(k: int) -> float:
        chain(k)  # warm up (cuBLAS handles, the allocator)
        if dev.type != "cuda":
            best = math.inf
            for _ in range(5):
                t0 = time.perf_counter()
                chain(k)
                best = min(best, time.perf_counter() - t0)
            return best
        torch.cuda.synchronize(dev)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            chain(k)
        graph.replay()
        best = math.inf
        for _ in range(3):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            graph.replay()
            b.record()
            b.synchronize()
            best = min(best, a.elapsed_time(b) / 1e3)
        del graph
        return best

    dt = chain_s(long) - chain_s(short)
    gbs = float(2 * n * n * (long - short) / max(dt, 1e-9) / 1e9)
    if dev.type == "cuda" and gbs > PROBE_MAX_SHARE * HBM_BPS / 1e9:
        raise RuntimeError(f"chip_state_probe: {gbs:.1f} GB/s is above {PROBE_MAX_SHARE} x the "
                           f"card's {HBM_BPS / 1e9:.0f} GB/s: the timing is wrong")
    return gbs


def _draft_model(cfg: llama_mod.LlamaConfig, dev: torch.device) -> tuple:
    """The JAX package's synthetic ~170M bf16 drafter beside ``cfg`` (width
    1024, 8 layers of 8 heads, n_ff 2816, the main vocabulary): weights
    normal * 0.03 ([in, out] per layer), the embedding normal * 0.3, drawn
    on ``dev`` from generators seeded 7 and 8.  Returns (params, cfg)."""
    dcfg = llama_mod.LlamaConfig(n_vocab=cfg.n_vocab, n_embd=1024, n_head=8, n_layer=8,
                                 n_rot=128, n_ff=2816, n_ctx=cfg.n_ctx)
    gen = torch.Generator(device=dev).manual_seed(7)
    bf16 = torch.bfloat16

    def dlin(n_out, n_in, lead=(dcfg.n_layer,)):
        return {"w": (torch.randn((*lead, n_in, n_out), generator=gen, device=dev) * 0.03
                      ).to(bf16)}

    d, ff = dcfg.n_embd, dcfg.n_ff
    emb = torch.randn((dcfg.n_vocab, d), generator=torch.Generator(device=dev).manual_seed(8),
                      device=dev) * 0.3
    dparams = {
        "tok_embeddings": emb.to(bf16),
        "norm": torch.ones((d,), dtype=bf16, device=dev),
        "output": dlin(dcfg.n_vocab, d, lead=()),
        "layers": {
            "attention_norm": torch.ones((dcfg.n_layer, d), dtype=bf16, device=dev),
            "ffn_norm": torch.ones((dcfg.n_layer, d), dtype=bf16, device=dev),
            "wqkv": dlin(3 * d, d), "wo": dlin(d, d), "w13": dlin(2 * ff, d), "w2": dlin(d, ff),
        },
    }
    return dparams, dcfg


def _drafted_pass_s(params: dict, cache: dict, cfg: llama_mod.LlamaConfig, dparams: dict,
                    dcfg: llama_mod.LlamaConfig, logits: torch.Tensor, pos: int,
                    k_spec: int) -> tuple[float, torch.Tensor]:
    """Seconds per pass of the drafted loop (``draft_speculative_decode_loop``,
    eager as the engine's ``_draft_chunk``): one warm call, then three timed
    calls of 2 passes from cursor ``pos`` over a fresh bf16 drafter cache.
    Returns (seconds per pass, the pending logits)."""
    dcache = llama_mod.init_cache(dcfg, 1, torch.bfloat16, logits.device)

    def call(lg):
        toks, _, lg = llama_mod.draft_speculative_decode_loop(params, cache, dparams, dcache, lg,
                                                              pos, 2, k_spec, cfg, dcfg)
        _host(toks)
        return lg

    logits = call(logits)
    t0 = time.perf_counter()
    for _ in range(3):
        logits = call(logits)
    return (time.perf_counter() - t0) / 6, logits


def _accept_walk(agree: np.ndarray, k_draft: int) -> float:
    """Tokens per verify pass when drafts hold exactly where ``agree``: a
    pass emits 1 + the leading agreeing drafts and advances past them."""
    pos = passes = emitted = 0
    while pos < len(agree) - k_draft:
        a = 0
        while a < k_draft and agree[pos + a]:
            a += 1
        emitted += 1 + a
        passes += 1
        pos += 1 + a
    return emitted / max(passes, 1)


@torch.no_grad()
def bench_decode(model: str, qtype: DataType, n_decode: int, prefill_len: int,
                 dtype: torch.dtype = torch.float32, cache_dtype: torch.dtype = torch.bfloat16,
                 quant_mode: str = "auto", quick: bool = False, batch: int = 8,
                 sections: str = "all", emit=None, deadline: float | None = None,
                 device: str | torch.device = "cuda") -> dict:
    """Decode and prefill timings of the synthetic ``model`` (a key of
    :data:`GEOMETRIES`) in ``quant_mode`` (``qtype`` for the ggml forms),
    activations and embedding in ``dtype`` (the engine's f32 by default),
    KV caches in ``cache_dtype``, on ``device``.

    The core block: ``build_s``; the prefill of ``prefill_len`` random ids
    (``ttft_first_ms``, its graph captured; ``ttft_warm_ms``, replayed);
    with ``prefill_len`` < 512 a 512-row prefill (``prefill512_ms``,
    ``prefill_tok_s``); ``n_decode`` stepwise tokens (``decode_stepwise_*``:
    greedy on the device, one captured single step, one host fetch of the
    id per token: the engine's per-token path at depth 0, where JAX's ran
    ``STEP_LOOKAHEAD`` dispatches ahead); fused 16-token chunks
    (``decode_tok_s``, ``decode_ms``).

    ``sections`` picks the riders: "all"; "single" (the single-stream
    speculation riders: n-gram ``spec``, sampled ``stoch_spec``, the drafter
    ``draft_spec``, the distilled ``draft_head`` read from
    :data:`DRAFT_ARTIFACT` when its tag is this teacher's); "serving" (the
    ``batch``-lane riders: ``batched``, ``batched_spec``, ``paged``,
    ``paged_spec``).  ``quick`` returns after the core block.  A failing
    rider records ``<name>_error`` and the next one runs.

    ``emit`` is called with a copy of the result after the core block and
    after every rider, so that a run cut short keeps what it measured.
    ``deadline`` (absolute ``time.time()``): a rider whose cost estimate
    would pass it is skipped and named in ``skipped_sections``; the core
    block always runs."""
    dev = torch.device(device)
    graphs = dev.type == "cuda"
    pool_id = _pool(dev)
    cfg = GEOMETRIES[model]
    skipped: list[str] = []
    ran: dict = {}  # section -> graph replays (None where it ran eagerly)
    out: dict = {"device": card(dev)}

    def _emit():
        if emit is not None:
            try:
                emit(dict(out))
            except Exception as e:  # noqa: BLE001: a caller's printer never sinks the run
                print(f"[bench] emit failed: {type(e).__name__}: {e}", file=sys.stderr)

    def _budget(name: str, need_s: float) -> bool:
        """True when section ``name`` fits the remaining wall budget."""
        if deadline is not None and time.time() + need_s > deadline:
            skipped.append(name)
            out["skipped_sections"] = ",".join(skipped)
            print(f"[bench] section {name} skipped: ~{need_s:.0f}s needed, "
                  f"{max(0.0, deadline - time.time()):.0f}s left", file=sys.stderr)
            return False
        return True

    def steps_on(c: llama_mod.LlamaConfig, cache: dict) -> StepGraphs:
        return StepGraphs(params, c, cache, dev, pool_id, eager=not graphs)

    rng = np.random.default_rng(0)
    pack = bench_pack_policy(cfg) if quant_mode == "gq" else None
    _sync(dev)
    t0 = time.perf_counter()
    params = synth_llama_params(cfg, qtype, rng, dtype, quant_mode=quant_mode, device=dev,
                                pack=pack)
    _sync(dev)
    build_s = time.perf_counter() - t0

    steps = steps_on(cfg, llama_mod.init_cache(cfg, 1, cache_dtype, dev))

    def prefill(e: torch.Tensor, capture: bool = False) -> torch.Tensor:
        s = e.shape[1]
        return steps.prefill(e, 0, s - 1, _attn_bucket(s, cfg.n_ctx), capture=capture)

    # --- prefill / TTFT
    tokens = torch.from_numpy(rng.integers(0, cfg.n_vocab, (1, prefill_len), dtype=np.int64))
    e = llama_mod.embed_tokens(params, tokens.to(dev))
    t0 = time.perf_counter()
    logits = prefill(e, capture=True)
    _host(logits)
    ttft_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    logits = prefill(e)
    _host(logits)
    ttft_warm = time.perf_counter() - t0

    # --- a 512-row prefill (the reference's n_batch default): one bucket
    pf512 = None
    if prefill_len < 512 and cfg.n_ctx >= 1024:
        t512 = torch.from_numpy(rng.integers(0, cfg.n_vocab, (1, 512), dtype=np.int64))
        e512 = llama_mod.embed_tokens(params, t512.to(dev))
        _host(prefill(e512, capture=True))
        t0 = time.perf_counter()
        logits = prefill(e512)
        _host(logits)
        pf512 = time.perf_counter() - t0
        # back to the short prefill's state (positions past it are masked)
        logits = prefill(e)
        _host(logits)

    # --- stepwise decode: greedy on the device, the captured single step,
    # one host fetch of the id per token
    def step(lg: torch.Tensor, pos: int, capture: bool = False):
        tid = lg.argmax(dim=-1)
        return tid, steps.step(tid[:, None], pos, capture=capture)

    tid, logits = step(logits, prefill_len, capture=True)
    int(tid[0])
    pos = prefill_len + 1
    t0 = time.perf_counter()
    for i in range(n_decode):
        tid, logits = step(logits, pos + i)
        int(tid[0])  # the only per-token host transfer
    _sync(dev)
    dt = time.perf_counter() - t0

    # --- fused decode chunks (the engine's generate): sampling on the
    # device, only the ids downloaded
    chunk = 16
    greedy1 = lane_rows([SamplingParams(temp=0.0)], cfg.n_vocab, dev)

    def fused(lg: torch.Tensor, pos0: int, capture: bool = False):
        return steps.decode_chunk(lg, pos0, chunk, [None], greedy1, capture=capture)

    toks, logits = fused(logits, pos + n_decode, capture=True)
    _host(toks)
    n_fused = max(chunk, (n_decode // chunk) * chunk)
    p2 = pos + n_decode + chunk
    t0 = time.perf_counter()
    done = 0
    while done < n_fused:
        toks, logits = fused(logits, p2 + done)
        _host(toks)
        done += chunk
    dt_fused = time.perf_counter() - t0

    out.update({
        "decode_tok_s": n_fused / dt_fused,
        "decode_ms": dt_fused / n_fused * 1e3,
        "decode_stepwise_tok_s": n_decode / dt,
        "decode_stepwise_ms": dt / n_decode * 1e3,
        "ttft_warm_ms": ttft_warm * 1e3,
        "ttft_first_ms": ttft_first * 1e3,
        "build_s": build_s,
        "prefill_len": prefill_len,
    })
    if pf512 is not None:
        out["prefill512_ms"] = pf512 * 1e3
        out["prefill_tok_s"] = 512 / pf512
    ran["core"] = steps.replays
    _emit()  # the headline block is complete
    if quick:
        _report(ran, graphs)
        return out

    # --- greedy n-gram speculation (k = 8) over the model's own greedy
    # run-in: the pass cost against decode_ms, and the acceptance
    k_spec = 8
    runin = 48
    pos_ri = p2 + done
    pos_sp = pos_ri + runin
    sp_passes = min(16, (cfg.n_ctx - pos_sp - 1) // k_spec)
    if sections == "serving":
        sp_passes = 0
    elif not _budget("spec", 150):
        sp_passes = 0
    hist_d = None
    if sp_passes >= 1:
        before = steps.replays
        hist0 = np.full((1, cfg.n_ctx), -1, np.int32)
        ri_done = 0
        while ri_done < runin:
            toks, logits = fused(logits, pos_ri + ri_done)
            hist0[0, pos_ri + ri_done:pos_ri + ri_done + chunk] = _host(toks)[0]
            ri_done += chunk
        toks_sp, counts, logits, hist_d = steps.spec_chunk(
            logits, pos_sp, torch.from_numpy(hist0).to(dev), sp_passes, k_spec, capture=True)
        _host(toks_sp)
        t0 = time.perf_counter()
        n_sp_tokens = n_sp_passes = 0
        for _ in range(3):
            toks_sp, counts, logits, hist_d = steps.spec_chunk(logits, pos_sp, hist_d, sp_passes,
                                                               k_spec)
            n_sp_tokens += int(_host(counts).sum())
            n_sp_passes += sp_passes
        dt_sp = time.perf_counter() - t0
        out["spec_pass_ms"] = dt_sp / n_sp_passes * 1e3
        out["spec_k"] = k_spec
        out["spec_accept_per_pass"] = n_sp_tokens / n_sp_passes
        out["decode_tok_s_spec"] = n_sp_tokens / dt_sp
        # acceptance on non-cyclic prose (the number above is the model's
        # own stream, often cyclic on random weights)
        acc_real = spec_acceptance_on_stream(word_tokenize(REALISTIC_TEXT), k_spec=k_spec)
        out["spec_accept_realistic"] = acc_real
        out["decode_tok_s_spec_realistic"] = acc_real / (out["spec_pass_ms"] / 1e3)
        ran["spec"] = steps.replays - before
        _emit()

    # --- sampled n-gram speculation (temp 0.8, top-k 40, top-p 0.95): the
    # pass cost beside the greedy one
    def _stoch_spec_section():
        nonlocal logits
        if sp_passes < 1:
            return
        before = steps.replays
        rows = lane_rows([SamplingParams(temp=0.8, top_k=40, top_p=0.95)], cfg.n_vocab, dev)
        gens = [torch.Generator(device=dev).manual_seed(7)]
        ban = torch.full((1,), -1, dtype=torch.long, device=dev)
        ts, cs, logits, hd, ban = steps.spec_chunk_stoch(logits, pos_sp, hist_d, ban, sp_passes,
                                                         k_spec, gens, rows, capture=True)
        _host(ts)
        t0 = time.perf_counter()
        n_tok = n_pass = 0
        for _ in range(3):
            ts, cs, logits, hd, ban = steps.spec_chunk_stoch(logits, pos_sp, hd, ban, sp_passes,
                                                             k_spec, gens, rows)
            n_tok += int(_host(cs).sum())
            n_pass += sp_passes
        dt = time.perf_counter() - t0
        out["spec_stoch_pass_ms"] = dt / n_pass * 1e3
        out["spec_stoch_accept_per_pass"] = n_tok / n_pass
        ran["stoch_spec"] = steps.replays - before

    if _budget("stoch_spec", 90):
        try:
            _stoch_spec_section()
        except Exception as e:  # noqa: BLE001: a rider never sinks the others
            out["spec_stoch_error"] = f"{type(e).__name__}: {e}"
        _emit()

    # --- drafter speculation: the synthetic ~170M drafter beside the model,
    # k drafter steps and one verify per pass (eager, as the engine's
    # drafted loop).  Unrelated weights make its acceptance meaningless, so
    # the numbers are the pass cost and the rates it implies at 2 and 4
    # accepted drafts per pass.
    def _draft_spec_section():
        nonlocal logits
        if cfg.n_embd < 2048 or sections == "serving":  # the smoke geometries: skip
            return
        dparams, dcfg = _draft_model(cfg, dev)
        pass_s, logits = _drafted_pass_s(params, steps.cache, cfg, dparams, dcfg, logits,
                                         min(p2 + done, cfg.n_ctx - 2 * k_spec - 1), k_spec)
        out["draft_spec_pass_ms"] = pass_s * 1e3
        out["draft_spec_tok_s_at_accept2"] = 3.0 / pass_s
        out["draft_spec_tok_s_at_accept4"] = 5.0 / pass_s
        ran["draft_spec"] = None

    if _budget("draft_spec", 120):
        try:
            _draft_spec_section()
        except Exception as e:  # noqa: BLE001
            out["draft_spec_error"] = f"{type(e).__name__}: {e}"
        _emit()

    # --- the distilled draft head (tools/train_draft.py against this very
    # synthetic teacher): teacher-forced agreement of its next-token
    # prediction with the teacher's along REALISTIC_TEXT, walked through the
    # pass schedule, and its real drafted-loop pass cost
    def _draft_head_section():
        nonlocal logits, steps
        from .train import draft as draft_mod

        if model != "13B" or sections == "serving":
            return
        if not DRAFT_ARTIFACT.exists():
            # untracked by design; tools/train_draft.py --model 13B --out writes it
            print(f"[bench] draft-head artifact absent ({DRAFT_ARTIFACT}, untracked by design); "
                  "python -m minigpt4_tpu_torch.tools.train_draft --model 13B --out "
                  "<that path> distils it, for the draft_head_* metrics", file=sys.stderr)
            return
        tag = synth_teacher_tag(quant_mode, bool(pack))
        if tag != draft_mod.artifact_teacher_mode(DRAFT_ARTIFACT):
            print(f"[bench] draft-head artifact distilled against "
                  f"{draft_mod.artifact_teacher_mode(DRAFT_ARTIFACT)!r}, not this teacher "
                  f"({tag!r}): no draft_head_* metrics", file=sys.stderr)
            return
        art, dhc = draft_mod.load_artifact(DRAFT_ARTIFACT)
        dcfg = dhc.llama_cfg(cfg.n_vocab, cfg.n_ctx)
        dparams = draft_mod.assemble_draft(params["tok_embeddings"], art, torch.bfloat16)
        steps = None  # frees the decode state's cache and graphs
        # the stream padded to one 512-row bucket (causal attention keeps
        # the rows below its length as they are)
        stream = word_tokenize(REALISTIC_TEXT)
        n_ev, ev_pad = len(stream), 512
        toks_ev = torch.from_numpy(np.pad(stream, (0, ev_pad - n_ev))[None]).long().to(dev)
        cfg_ev = dataclasses.replace(cfg, n_ctx=ev_pad)
        tl = llama_mod.forward(params, llama_mod.init_cache(cfg_ev, 1, cache_dtype, dev),
                               llama_mod.embed_tokens(params, toks_ev), 0, cfg_ev,
                               all_logits=True)
        teacher_pred = _host(tl[0].argmax(dim=-1))[:n_ev]
        del tl
        dcfg_ev = dhc.llama_cfg(cfg.n_vocab, ev_pad)
        dl_ = llama_mod.forward(dparams, llama_mod.init_cache(dcfg_ev, 1, torch.bfloat16, dev),
                                llama_mod.embed_tokens(dparams, toks_ev), 0, dcfg_ev,
                                all_logits=True)
        draft_pred = _host(dl_[0].argmax(dim=-1))[:n_ev]
        del dl_
        agree = (draft_pred == teacher_pred)[48:-1]
        acc_pp = _accept_walk(agree, k_spec - 1)
        out["draft_head_agreement"] = float(agree.mean())
        out["draft_head_accept_realistic"] = acc_pp

        # the decode state's cache was freed for the evaluation: a fresh one
        pass_s, logits = _drafted_pass_s(params, llama_mod.init_cache(cfg, 1, cache_dtype, dev),
                                         cfg, dparams, dcfg, logits,
                                         min(cfg.n_ctx - 4 * k_spec - 1, 512), k_spec)
        out["draft_head_pass_ms"] = pass_s * 1e3
        out["decode_tok_s_draft_realistic"] = acc_pp / pass_s
        ran["draft_head"] = None

    if _budget("draft_head", 150):
        try:
            _draft_head_section()
        except Exception as e:  # noqa: BLE001
            out["draft_head_error"] = f"{type(e).__name__}: {e}"
        _emit()

    if sections == "single":
        _report(ran, graphs)
        return out

    # --- the dense batched group (eager, as the engine's dense group): B
    # sessions share every weight read, at the serving context of 512
    if not _budget("batched", 240):
        _report(ran, graphs)
        return out
    steps = None  # frees the single stream's cache and graphs
    bsz = batch
    bcfg = dataclasses.replace(cfg, n_ctx=512)
    bcache = llama_mod.init_cache(bcfg, bsz, cache_dtype, dev)
    bprefill = min(prefill_len, bcfg.n_ctx // 2)
    btokens = rng.integers(0, cfg.n_vocab, (bsz, bprefill), dtype=np.int64)
    bt = torch.from_numpy(btokens).to(dev)
    pf_chunk = 64  # bounds the prefill's attention transient at B x 64 rows
    for c0 in range(0, bprefill, pf_chunk):
        blogits = llama_mod.forward(params, bcache,
                                    llama_mod.embed_tokens(params, bt[:, c0:c0 + pf_chunk]),
                                    c0, bcfg)
    greedy_b = lane_rows([SamplingParams(temp=0.0)] * bsz, cfg.n_vocab, dev)

    def bdl(lg: torch.Tensor, pos0: int):
        return llama_mod.decode_loop(params, bcache, lg, pos0, chunk, [None] * bsz, greedy_b,
                                     bcfg)

    btoks, blogits = bdl(blogits, bprefill)
    _host(btoks)
    n_b = min(n_fused, (bcfg.n_ctx - bprefill - 2 * chunk) // chunk * chunk)
    t0 = time.perf_counter()
    done_b = 0
    while done_b < n_b:
        btoks, blogits = bdl(blogits, bprefill + chunk + done_b)
        _host(btoks)
        done_b += chunk
    dt_b = time.perf_counter() - t0
    out["decode_batch"] = bsz
    out["decode_tok_s_batched_aggregate"] = bsz * n_b / dt_b
    ran["batched"] = None
    _emit()

    # the paged section's admission source, on the host now: the group's
    # first pages of rows and its pending logits, so that the dense group can
    # be freed before the pool is allocated, whatever the section between
    # does to bcache
    src_pos = -(-bprefill // PAGE) * PAGE
    paged_src = {kv: llama_mod._bits(bcache[kv][:, :, :, :src_pos]).cpu() for kv in ("k", "v")}
    paged_logits0 = blogits.cpu()
    dense_group_mb = 2 * bcache["k"].numel() * bcache["k"].element_size() / 1e6

    # --- batched n-gram speculation (eager, as the batchers' speculative
    # steps): per-lane drafts over the shared weight read
    def _batched_spec_section():
        nonlocal blogits, btoks
        sp_k_b, sp_passes_b = 8, 2
        bpos_ri = bprefill + chunk + n_b
        if bpos_ri + runin + sp_passes_b * sp_k_b > bcfg.n_ctx:
            return  # no room left in the session context
        bhist0 = np.full((bsz, bcfg.n_ctx), -1, np.int32)
        bhist0[:, :bprefill] = btokens
        ri_done = 0
        while ri_done < runin:
            btoks, blogits = bdl(blogits, bpos_ri + ri_done)
            bhist0[:, bpos_ri + ri_done:bpos_ri + ri_done + chunk] = _host(btoks)
            ri_done += chunk
        bpos_sp = bpos_ri + runin
        bhist = torch.from_numpy(bhist0).to(dev)

        def bspec(lg, hist):
            return llama_mod.speculative_decode_loop(params, bcache, lg, bpos_sp, hist,
                                                     sp_passes_b, sp_k_b, bcfg)

        btoks_sp, _, blogits, bhist = bspec(blogits, bhist)
        _host(btoks_sp)
        t0 = time.perf_counter()
        n_tok_b = n_pass_b = 0
        for _ in range(3):
            _, bcounts, blogits, bhist = bspec(blogits, bhist)
            n_tok_b += int(_host(bcounts).sum())
            n_pass_b += sp_passes_b * bsz
        dt_bs = time.perf_counter() - t0
        out["decode_tok_s_batched_spec"] = n_tok_b / dt_bs
        out["spec_accept_per_pass_batched"] = n_tok_b / n_pass_b
        ran["batched_spec"] = None

    if _budget("batched_spec", 120):
        try:
            _batched_spec_section()
        except Exception as e:  # noqa: BLE001
            out["batched_spec_error"] = f"{type(e).__name__}: {e}"
        _emit()

    # --- the paged group (captured, as the pool's group chunks), at the
    # dense group's lane count, admitted from the host copy after the dense
    # group is freed: pool and group never share the card.  The claim is
    # bandwidth parity with the dense group while a lane's memory follows
    # its context (paged_pool_mb against dense_group_mb).
    if not _budget("paged", 180):
        _report(ran, graphs)
        return out
    try:
        bcache = blogits = btoks = None  # release the dense group before the pool
        n_pg = min(n_b, 4 * chunk)
        # +96: room for the paged speculation below (its passes run up to
        # ~3 spans past the plain run)
        used = bprefill + chunk * (n_pg // chunk + 2) + 96
        pool = PagedKVPool(bcfg, bsz * -(-used // PAGE), bcfg.n_ctx, dtype=cache_dtype,
                           device=dev)
        lane_pages = [pool.admit_host({"k": paged_src["k"][:, i:i + 1].contiguous(),
                                       "v": paged_src["v"][:, i:i + 1].contiguous(),
                                       "dtype": cache_dtype}, bprefill)
                      for i in range(bsz)]
        psteps = StepGraphs(params, bcfg, {"k": pool.k, "v": pool.v}, dev, pool_id,
                            eager=not graphs)
        phist = np.full((bsz, bcfg.n_ctx), -1, np.int32)
        phist[:, :bprefill] = btokens

        def table() -> torch.Tensor:
            return torch.from_numpy(np.stack([pool.table_row(pg) for pg in lane_pages])).to(dev)

        def pstep(plogits: torch.Tensor, ppos: np.ndarray, capture: bool = False):
            for i in range(bsz):
                lane_pages[i] = pool.extend(lane_pages[i], int(ppos[0]) + chunk)
            ptoks, plogits = psteps.decode_chunk(plogits, ppos.tolist(), chunk, [None] * bsz,
                                                 greedy_b, page_table=table(), capture=capture)
            # keep the lanes' histories for the speculation below
            phist[:, int(ppos[0]):int(ppos[0]) + chunk] = _host(ptoks)
            return plogits, ppos + chunk

        ppos = np.full((bsz,), bprefill, np.int64)
        plogits, ppos = pstep(paged_logits0.to(dev), ppos, capture=True)
        t0 = time.perf_counter()
        done_p = 0
        while done_p < n_pg:
            plogits, ppos = pstep(plogits, ppos)
            done_p += chunk
        dt_p = time.perf_counter() - t0
        out["paged_lanes"] = bsz
        out["decode_tok_s_batched_paged_aggregate"] = bsz * n_pg / dt_p
        out["paged_pool_mb"] = round(2 * pool.k.numel() * pool.k.element_size() / 1e6, 1)
        out["dense_group_mb"] = round(dense_group_mb, 1)
        ran["paged"] = psteps.replays

        # --- paged n-gram speculation (eager, as the batchers' speculative
        # steps): greedy verify passes over the same pool, whose writes split
        # where a span crosses a page edge
        def _paged_spec_section():
            nonlocal plogits
            sp_k_p, sp_passes_p = 8, 2
            span = sp_k_p * sp_passes_p
            if int(ppos[0]) + 3 * span > bcfg.n_ctx:
                return  # no context room left for the passes
            kv = {"k": pool.k, "v": pool.v}

            def sstep(plogits, hist, pos_dev, pos_max):
                for i in range(bsz):
                    lane_pages[i] = pool.extend(lane_pages[i], pos_max + span)
                _, pcnt, plogits, hist = llama_mod.speculative_decode_loop(
                    params, kv, plogits, pos_dev, hist, sp_passes_p, sp_k_p, bcfg,
                    page_table=table())
                cnt = _host(pcnt)
                step_pos = torch.from_numpy(cnt.sum(axis=1).astype(np.int32)).to(dev)
                return plogits, hist, pos_dev + step_pos, int(cnt.sum())

            hist = torch.from_numpy(phist).to(dev)
            pos_dev = torch.from_numpy(ppos.astype(np.int32)).to(dev)
            plogits, hist, pos_dev, _ = sstep(plogits, hist, pos_dev, int(ppos.max()))
            t0 = time.perf_counter()
            n_tok = n_pass = 0
            for _ in range(2):
                pos_max = int(_host(pos_dev).max())
                plogits, hist, pos_dev, emitted = sstep(plogits, hist, pos_dev, pos_max)
                n_tok += emitted
                n_pass += sp_passes_p * bsz
            dt_s = time.perf_counter() - t0
            out["decode_tok_s_paged_spec"] = n_tok / dt_s
            out["spec_accept_per_pass_paged"] = n_tok / n_pass
            ran["paged_spec"] = None

        _emit()
        if _budget("paged_spec", 90):
            try:
                _paged_spec_section()
            except Exception as e:  # noqa: BLE001
                out["paged_spec_error"] = f"{type(e).__name__}: {e}"
        del psteps, pool
    except Exception as e:  # noqa: BLE001: the paged section never sinks the run
        out["paged_error"] = f"{type(e).__name__}: {e}"
    _emit()
    _report(ran, graphs)
    return out


def _report(ran: dict, graphs: bool) -> None:
    """Which sections replayed captured graphs (and how many) and which ran
    eagerly, on stderr."""
    cap = [f"{name} ({n} replays)" for name, n in ran.items() if n is not None and graphs]
    eager = [name for name, n in ran.items() if n is None or not graphs]
    print(f"[bench] captured CUDA graphs replayed: {', '.join(cap) or 'none'}; eager: "
          f"{', '.join(eager) or 'none'}", file=sys.stderr)


@torch.no_grad()
def bench_encode(llama_embed: int = 5120, dtype: torch.dtype = torch.float32, iters: int = 10,
                 device: str | torch.device = "cuda") -> dict:
    """ViT-G + Q-Former + projection (:func:`vit_g_config`, synthetic
    weights in ``dtype``, the engine's f32 by default) through the
    encoder's captured graph, key ("encode", B), as the engine's ``_encode``
    replays it: ``encode_ms_first`` (the capture included), the median of
    ``iters`` warm calls ``encode_ms_p50`` (the [B, 32, D] download
    included), and for a batch of 8 images ``encode_batch_ms_p50`` and
    ``encode_imgs_s`` (``encode_batch_error`` if that fails)."""
    dev = torch.device(device)
    cfg = vit_g_config(llama_embed)
    rng = np.random.default_rng(0)
    params = synth_vision_params(cfg, rng, dtype, dev)
    graphs = GraphCache(dev, _pool(dev), eager=dev.type != "cuda")

    def step(inp, _):
        return (vision_mod.encode_image(params, inp["pixels"], cfg),)

    def encode(pixels: torch.Tensor, capture: bool = False) -> np.ndarray:
        return _host(graphs.run(("encode", pixels.shape[0]), step, {"pixels": pixels},
                                capture=capture)[0])

    size = cfg.vit.image_size

    def images(b: int) -> torch.Tensor:
        return torch.from_numpy(rng.normal(0, 1, (b, 3, size, size)).astype(np.float32)).to(
            dev, dtype)

    pixels = images(1)
    t0 = time.perf_counter()
    encode(pixels, capture=True)
    first = time.perf_counter() - t0
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        encode(pixels)
        times.append(time.perf_counter() - t0)
    res = {"device": card(dev), "encode_ms_p50": statistics.median(times) * 1e3,
           "encode_ms_first": first * 1e3}
    # a burst of 8 uploads in one call: the weight read amortizes as in
    # batched decode.  Guarded: the single-image p50 is never lost.
    try:
        bsz = 8
        pix_b = images(bsz)
        encode(pix_b, capture=True)
        tb = []
        for _ in range(5):
            t0 = time.perf_counter()
            encode(pix_b)
            tb.append(time.perf_counter() - t0)
        res["encode_batch"] = bsz
        res["encode_batch_ms_p50"] = statistics.median(tb) * 1e3
        res["encode_imgs_s"] = bsz / statistics.median(tb)
    except Exception as e:  # noqa: BLE001
        res["encode_batch_error"] = f"{type(e).__name__}: {e}"
    how = f"captured CUDA graphs, {graphs.replays} replays" if dev.type == "cuda" else "eager"
    print(f"[bench] encode: {how}", file=sys.stderr)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="13B", choices=list(GEOMETRIES))
    ap.add_argument("--qtype", default="q5_k")
    ap.add_argument("--n-decode", type=int, default=64)
    ap.add_argument("--prefill", type=int, default=64)
    ap.add_argument("--cache-dtype", choices=list(CACHE_DTYPES), default="bf16")
    ap.add_argument("--quant-mode", choices=["auto", "repack", "qtensor", "w8a8", "gq"],
                    default="auto", help="the engine's quant_mode for the decoder")
    ap.add_argument("--batch", type=int, default=8,
                    help="batched-serving lane count for the aggregate section")
    ap.add_argument("--skip-encode", action="store_true")
    ap.add_argument("--skip-decode", action="store_true")
    ap.add_argument("--quick", action="store_true",
                    help="the core block only (skip spec/batched/paged)")
    ap.add_argument("--sections", choices=["all", "single", "serving"], default="all",
                    help="single = single-stream spec/draft groups only; "
                    "serving = batched/paged groups only")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("benchmark: no CUDA card (torch.cuda.is_available() is false); it times the "
              "port on an NVIDIA GPU and never falls back to the CPU", file=sys.stderr)
        return 1
    from .engine.engine import disable_tf32
    from .ops import _build

    disable_tf32()
    _build.load()  # nvcc stays out of every timing
    qtype = DataType[args.qtype.upper()]
    results: dict = {}
    if not args.skip_decode:
        results.update(bench_decode(args.model, qtype, args.n_decode, args.prefill,
                                    cache_dtype=CACHE_DTYPES[args.cache_dtype],
                                    quant_mode=args.quant_mode, quick=args.quick,
                                    batch=args.batch, sections=args.sections))
    if not args.skip_encode:
        results.update(bench_encode(GEOMETRIES[args.model].n_embd))
    print(json.dumps(results, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
