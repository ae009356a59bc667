"""LLaMA/Vicuna decoder over a pre-allocated KV cache.

Counterpart of ``minigpt4_tpu/models/llama.py``.  ``forward`` runs S
positions (token or injected image embeddings) from cursor ``pos0``,
writes their K/V into the stacked cache ``[L, B, H, C, Dh]`` in place and
returns the logits of one position; a decode step is the same call with
S = 1.  Projections run through :func:`~.params.linear` (group-quant or
repacked-weight kernels for quantized weights); attention of S <= ``FLASH_DECODE_MAX_S``
rows runs the flash-decode kernel, longer prefill chunks a plain masked
softmax.  RoPE is the interleaved-pair variant (ggml_rope mode 0).

With a ``page_table`` the cache is instead the serving page pools
``[L, NP + 1, H, 128, Dh]`` of ``engine/paged.py``: decode steps (S = 1)
write through the table and attend with the paged flash-decode kernel.

The cache holds f32, bf16 or e4m3 (``torch.float8_e4m3fn``); K/V reach an
e4m3 cache through :func:`to_cache`, the JAX package's cast.

With a tensor-parallel group (``tp``, a :class:`~..parallel.TPGroup`) the
same functions run on one rank's shards (``parallel/spmd.py``), as the JAX
package's run under ``shard_map``: local head counts and widths come from
the arrays, :func:`_row_linear` sums the row-parallel outputs over the
ranks, and the vocab-parallel head is gathered.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..formats import is_quantized
from ..ops import group_i8 as gq
from ..ops import i8_matmul as i8
from ..ops import quant_matmul as qm
from ..ops import repack as rp
from ..ops.flash_decode import (PAGE, pos_vector, flash_decode_attention,
                                paged_flash_decode_attention)
from ..parallel.mesh import TPGroup, all_gather_tiled, pmax, psum
from .layers import rms_norm
from .params import QUANT_FORMS, linear, load_quant_weight, tensor

NEG_INF = float(np.finfo(np.float32).min)
RMS_EPS = 1e-6  # ggml_rms_norm eps at llama.cpp master-31cfbb1
# S at or below this uses the flash-decode kernel; above it is prefill
FLASH_DECODE_MAX_S = 32
# above this attention span the prefill path computes P.V in f32 (the JAX
# package's blockwise path); at or below it, in the cache dtype
PREFILL_FLASH_SPAN = 512

# f32 magnitudes above this round past 448, the largest finite e4m3 value:
# the JAX package's cast (ml_dtypes) makes them NaN, torch's cast saturates
E4M3_NAN_ABOVE = 464.0

# fused projections and their parts, in output order
FUSED = {"wqkv": ("wq", "wk", "wv"), "w13": ("w1", "w3")}
FILE_NAMES = {"wq": "attention.wq", "wk": "attention.wk", "wv": "attention.wv",
              "wo": "attention.wo", "w1": "feed_forward.w1", "w2": "feed_forward.w2",
              "w3": "feed_forward.w3"}


@dataclass(frozen=True)
class LlamaConfig:
    n_vocab: int
    n_embd: int
    n_head: int
    n_layer: int
    n_rot: int
    n_ff: int
    n_ctx: int = 2048
    rope_theta: float = 10000.0

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    @classmethod
    def from_hparams(cls, hp, n_ctx: int = 2048) -> "LlamaConfig":
        return cls(n_vocab=hp.n_vocab, n_embd=hp.n_embd, n_head=hp.n_head,
                   n_layer=hp.n_layer, n_rot=hp.n_rot, n_ff=hp.n_ff, n_ctx=n_ctx)


def init_cache(cfg: LlamaConfig, batch: int, dtype: torch.dtype,
               device: str | torch.device) -> dict:
    """Pre-allocated KV cache ``{"k", "v"}`` of shape [L, B, H, C, Dh] (one
    rank's heads: ``parallel.spmd.cache_cfg``)."""
    shape = (cfg.n_layer, batch, cfg.n_head, cfg.n_ctx, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def to_cache(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """K/V values -> the cache's element type, as the JAX package casts them.
    For e4m3 that is round to nearest even with magnitudes above
    ``E4M3_NAN_ABOVE``, infinities and NaN giving NaN, so an overflowing
    cache shows as NaN as it does in the JAX package (torch's own cast
    clamps to +-448).  Every cache write (dense, per-row and paged) goes
    through here."""
    if dtype == torch.float8_e4m3fn:
        t = torch.where(t.abs() <= E4M3_NAN_ABOVE, t, float("nan"))
    return t.to(dtype)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """(cos, sin) for positions [S] or [B, S] -> [1|B, 1, S, Dh/2] f32."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32, device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    if ang.dim() == 2:
        ang = ang[None]
    return torch.cos(ang)[:, None], torch.sin(ang)[:, None]


def rope_interleaved(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate consecutive pairs of x [B, H, S, Dh] (ggml_rope mode 0)."""
    b, h, s, dh = x.shape
    xp = x.reshape(b, h, s, dh // 2, 2).float()
    even, odd = xp[..., 0], xp[..., 1]
    out = torch.stack([even * cos - odd * sin, even * sin + odd * cos], dim=-1)
    return out.reshape(b, h, s, dh).to(x.dtype)


def _positions(pos: torch.Tensor, s: int) -> torch.Tensor:
    """Absolute positions [B, S] from the cursors ``pos`` (i32 [B], on the
    device), computed there."""
    return pos.long()[:, None] + torch.arange(s, device=pos.device)


def _prefill_attention(q, ck, cv, li, pos0, span, head_dim):
    """Masked softmax attention of S > FLASH_DECODE_MAX_S rows over
    ``cache[:span]``: scores and softmax in f32; P.V in the cache dtype (bf16
    for a byte-wide e4m3 cache, whose probabilities would keep 3 mantissa
    bits) for spans up to PREFILL_FLASH_SPAN, in f32 above (as the JAX
    package).  An e4m3 cache converts natively here, subnormals kept, as in
    the JAX package; only the flash kernels flush them.  ``pos0``: the
    cursors (int, one int per row, or i32 [B] on the device); ``span`` is
    static, the attention bucket (JAX's static ``attn_len``)."""
    ks = ck[li, :, :, :span]
    vs = cv[li, :, :, :span]
    b, _, s, _ = q.shape
    q_pos = _positions(pos_vector(pos0, b, q.device), s)
    key_pos = torch.arange(span, device=q.device)
    visible = (key_pos <= q_pos[..., None])[:, None]  # [B, 1, S, span]
    if span > PREFILL_FLASH_SPAN:
        sc = (q.float() * (1.0 / math.sqrt(head_dim))) @ ks.float().transpose(-1, -2)
        sc = sc.masked_fill(~visible, float("-inf"))
        return torch.softmax(sc, dim=-1) @ vs.float()
    sqrt_dh = float(np.sqrt(np.float32(head_dim), dtype=np.float32))
    sc = (q.float() @ ks.float().transpose(-1, -2)) / sqrt_dh
    sc = sc + torch.where(visible, 0.0, NEG_INF)
    probs = torch.softmax(sc, dim=-1)
    pv_dt = vs.dtype if vs.element_size() > 1 else torch.bfloat16
    return probs.to(pv_dt).float() @ vs.to(pv_dt).float()


def _amax(t: torch.Tensor) -> torch.Tensor:
    """Per-channel absolute maximum over every axis but the last, in f32."""
    return t.float().abs().reshape(-1, t.shape[-1]).amax(dim=0)


def _k_width(w, full_k: int) -> int:
    """The input width a weight contracts (a per-layer list stays whole)."""
    if isinstance(w, list):
        return full_k
    if isinstance(w, (rp.RepackedQuant, qm.QTensor)):
        return w.n_in
    if isinstance(w, i8.I8SBQuant):
        return w.codes.shape[-1]
    return w.shape[-2]


def _row_linear(x: torch.Tensor, p: dict, li, tp: TPGroup | None, full_k: int) -> torch.Tensor:
    """Row-parallel linear (the JAX package's ``_row_linear``).  ``full_k``
    is the global contraction width (n_embd for wo, n_ff for w2); it tells
    the four cases apart: a K-sharded weight contracts this rank's slice of
    the input (sliced here if the producer stayed whole) and the outputs
    are summed over the ranks; a whole weight takes the full-width input
    (gathered first if the producer was split) with no sum."""
    if tp is None:
        return linear(x, p, li)
    w = p["w"]
    kw = _k_width(w, full_k)
    if kw < full_k:  # weight K-sharded
        if x.shape[-1] == full_k:
            x = x[..., tp.rank * kw:(tp.rank + 1) * kw]
        if isinstance(w, i8.I8SBQuant):
            # the global row absmax keeps the activation grid of one device
            # (one tiny MAX over the ranks); the partials stay f32 across
            # the sum
            xf = x.float()
            sx = pmax(xf.abs().amax(dim=-1, keepdim=True), tp) / 127.0
            sx = torch.where(sx == 0, 1.0, sx)
            y = i8.qmatmul_i8sb(xf, w, li if w.stacked else None, x_scale=sx)
            y = psum(y, tp).to(x.dtype)
            b = p.get("b")
            return y if b is None else y + b.to(y.dtype)
        return psum(linear(x, p, li), tp)
    if x.shape[-1] < full_k:
        x = all_gather_tiled(x, tp)
    return linear(x, p, li)


def _layer(x, layers, li, ck, cv, pos_dev, rope, cfg, attn_len, rows,
           page_table=None, act_stats=None, tp=None):
    """One decoder layer on x [B, S, D]; writes K/V of the S positions into
    layer ``li`` of the cache in place.  ``pos_dev``: the cursors, i32 [B]
    on the device.  ``rows``: the (cache row [B, 1], position [B, S]) index
    pair of each position's write (the batch row and its position, or its
    pool page and the offset in it), so that all positions write in one
    indexed copy.  ``page_table``: the cache is the page pools (see forward).
    ``act_stats``: a dict of lists; the per-channel absolute maxima of the
    inputs of the quantizable matmuls are appended per site ("attn", "wo",
    "ffn", "w2"), the calibration capture of ``quality.py``.  ``tp``: the
    rank's tensor-parallel group (``forward``)."""
    b, s, _ = x.shape
    h = rms_norm(x, layers["attention_norm"][li], RMS_EPS)
    if act_stats is not None:
        act_stats.setdefault("attn", []).append(_amax(h))

    def heads(t):
        return t.reshape(b, s, -1, cfg.head_dim).transpose(1, 2)

    if "wqkv" in layers:
        qkv = linear(h, layers["wqkv"], li)
        xq, xk, xv = qkv.split(qkv.shape[-1] // 3, dim=-1)  # local width under tp
    else:
        xq, xk, xv = (linear(h, layers[n], li) for n in FUSED["wqkv"])
    cos, sin = rope
    q = rope_interleaved(heads(xq), cos, sin)
    k = rope_interleaved(heads(xk), cos, sin)
    v = heads(xv)

    ck[li][rows[0], :, rows[1]] = to_cache(k.transpose(1, 2), ck.dtype)
    cv[li][rows[0], :, rows[1]] = to_cache(v.transpose(1, 2), cv.dtype)

    if page_table is not None:
        ctx = paged_flash_decode_attention(q, ck, cv, li, pos_dev, page_table,
                                           1.0 / math.sqrt(cfg.head_dim))
    elif s <= FLASH_DECODE_MAX_S:
        ctx = flash_decode_attention(q, ck, cv, li, pos_dev, 1.0 / math.sqrt(cfg.head_dim))
    else:
        ctx = _prefill_attention(q, ck, cv, li, pos_dev, attn_len or cfg.n_ctx, cfg.head_dim)
    ctx = ctx.to(x.dtype).transpose(1, 2).reshape(b, s, -1)
    if act_stats is not None:
        act_stats.setdefault("wo", []).append(_amax(ctx))
    x = x + _row_linear(ctx, layers["wo"], li, tp, cfg.n_embd)

    h = rms_norm(x, layers["ffn_norm"][li], RMS_EPS)
    if act_stats is not None:
        act_stats.setdefault("ffn", []).append(_amax(h))
    if "w13" in layers:
        # halves of the fused output, as the JAX package splits it: a file's
        # n_mult may derive an n_ff other than its weights' width
        gate_in, up = linear(h, layers["w13"], li).chunk(2, dim=-1)
    else:
        gate_in, up = (linear(h, layers[n], li) for n in FUSED["w13"])
    gate = torch.nn.functional.silu(gate_in.float()).to(x.dtype)
    gu = gate * up
    if act_stats is not None:
        act_stats.setdefault("w2", []).append(_amax(gu))
    return x + _row_linear(gu, layers["w2"], li, tp, cfg.n_ff)


def forward(params: dict, cache: dict, embeds: torch.Tensor, pos0, cfg: LlamaConfig,
            last_idx=None, attn_len: int | None = None,
            page_table: torch.Tensor | None = None, act_stats: dict | None = None,
            all_logits: bool = False, tp: TPGroup | None = None) -> torch.Tensor:
    """embeds [B, S, D] -> logits [B, V] (f32) at position ``last_idx``
    (default S-1; an int, or a long [1] tensor on the device), or [B, S, V]
    at every position with ``all_logits``; the cache is updated in place.
    ``act_stats``: the calibration capture of :func:`_layer`, plus "head",
    the absolute maxima of the final norm's output over every position.

    ``pos0`` is the cursor: an int, a sequence of one int per batch row (S
    = 1 only), or an i32 [B] tensor on the device.  Positions, cache writes
    and the attention masks are computed from it on the device, so a step
    reads no host value and a captured CUDA graph replays it at any cursor
    (``engine/graphs.py``).  Bucket-padded rows past ``last_idx`` write
    cache entries beyond the real tokens; the causal mask hides them and the
    next chunk overwrites them.  ``attn_len`` bounds the span the S > 32
    prefill path reads (the engine's power-of-two bucket covering pos0 + S).

    ``page_table`` [B, MAXP + 1] i32 (on the device) switches to paged mode:
    ``cache`` holds the page pools [L, NP + 1, H, PAGE, Dh] and row b's
    position p lives at offset p % PAGE of pool page
    ``page_table[b, min(p // PAGE, MAXP)]``; a finished row overshooting
    its capacity lands in the table's last slot, the pool's trash page.
    The page of each row is looked up on the device, once per call.

    ``tp``: this rank's tensor-parallel group; ``params`` and ``cache`` are
    then its shards (``parallel/spmd.py``) and every rank returns the same
    full-vocabulary logits."""
    b, s, _ = embeds.shape
    dev = embeds.device
    if s > 1 and (page_table is not None or isinstance(pos0, (list, tuple))):
        raise NotImplementedError(
            f"forward of {s} positions from per-row cursors: spans over the page pool or "
            "a batched group (the speculative verify writes) are not ported yet "
            "(ROADMAP Queue 1, item 14)")
    pos_dev = pos_vector(pos0, b, dev)
    positions = _positions(pos_dev, s)
    if page_table is not None:
        slot = (positions // PAGE).clamp(max=page_table.shape[1] - 1)
        rows = (page_table.gather(1, slot).long(), positions % PAGE)
    else:
        # a finished row of a batched group may run past the cache end: its
        # write clamps onto the last position, past its history (the group
        # stops before that position could hold history: engine/sessions.py)
        rows = (torch.arange(b, device=dev)[:, None],
                positions.clamp(max=cache["k"].shape[3] - 1))
    rope = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    x = embeds
    for li in range(cfg.n_layer):
        x = _layer(x, params["layers"], li, cache["k"], cache["v"], pos_dev, rope, cfg,
                   attn_len, rows, page_table, act_stats, tp)
    if act_stats is not None:
        act_stats.setdefault("head", []).append(_amax(rms_norm(x, params["norm"], RMS_EPS)))
    if all_logits:
        h = x
    elif last_idx is None:
        h = x[:, -1]
    elif isinstance(last_idx, torch.Tensor):
        h = x.index_select(1, last_idx.reshape(1)).squeeze(1)
    else:
        h = x[:, last_idx]
    logits = linear(rms_norm(h, params["norm"], RMS_EPS), params["output"])
    if tp is not None and logits.shape[-1] != cfg.n_vocab:
        logits = all_gather_tiled(logits, tp)  # the vocab-parallel head
    return logits.float()


def embed_tokens(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """[B, S] int -> [B, S, D] (llama.cpp get_rows)."""
    return params["tok_embeddings"][tokens]


def decode_loop(params: dict, cache: dict, logits0: torch.Tensor, pos0, n_steps: int,
                generators: list, rows, cfg: LlamaConfig,
                page_table: torch.Tensor | None = None, tp: TPGroup | None = None):
    """Generate ``n_steps`` tokens with on-device sampling.

    Keeps the reference's sample-then-eval order: token i is sampled from
    the pending logits of the previous eval, then evaluated.  Token ids stay
    on the device until the caller reads them, so a chunk costs one host
    synchronisation.  Returns (tokens [B, n_steps], final logits [B, V]).

    ``pos0``: one cursor for every row (int), one per row ([B] ints) or an
    i32 [B] tensor on the device; step i runs at ``pos0 + i``, advanced on
    the device.  Sampling: per-lane ``rows``
    (:func:`~..engine.device_sampling.lane_rows`) with a list of B
    ``generators``.  ``page_table``: paged mode (see :func:`forward`); the
    caller provisions pages covering every active row's pos0 + n_steps.
    ``tp``: see :func:`forward`; every rank samples the same tokens (greedy
    is key-free, and a sampled row draws from generators seeded alike on
    every rank)."""
    from ..engine.device_sampling import sample_rows

    pos = pos_vector(pos0, logits0.shape[0], logits0.device)
    logits = logits0
    toks = []
    for i in range(n_steps):
        tok = sample_rows(logits, generators, rows)
        toks.append(tok)
        logits = forward(params, cache, embed_tokens(params, tok[:, None]), pos + i, cfg,
                         page_table=page_table, tp=tp)
    return torch.stack(toks, dim=1), logits


# ---------------------------------------------------------------------------
# parameter loading
# ---------------------------------------------------------------------------


def _form(w) -> tuple:
    """What must agree for weights to stack or fuse (the JAX package's
    criteria: an I8SBQuant fuses with any of the same K)."""
    if isinstance(w, gq.GroupQuant):
        return ("gq", w.dtype, w.n_in, w.packing)
    if isinstance(w, rp.RepackedQuant):
        return ("rq", *w.form())
    if isinstance(w, i8.I8SBQuant):
        return ("i8", w.n_in)
    if isinstance(w, qm.QTensor):
        return ("qt", w.dtype, w.n_in)
    return ("dense", w.dtype, tuple(w.shape))


def _stack_or_list(ws: list):
    """Per-layer weights -> one weight with a leading L axis, or the list
    itself where the layers differ in form (``linear`` indexes it)."""
    if any(_form(w) != _form(ws[0]) for w in ws):
        return list(ws)
    forms = QUANT_FORMS.get(type(ws[0]))
    return forms[0](ws) if forms else torch.stack(ws)


def _concat_out(ws: list):
    """Parts of one form fused along the output axis."""
    forms = QUANT_FORMS.get(type(ws[0]))
    return forms[1](ws) if forms else torch.cat(ws, dim=-1)


def assemble_layers(per_layer: list[dict]) -> dict:
    """Per-layer projections ``[{name: weight}]`` -> ``{name: {"w": ...}}``.

    wq|wk|wv and w1|w3 fuse along the output axis (``wqkv``, ``w13``) only
    where every layer's parts share one form (dense, gq or repacked, one
    format and code packing); otherwise all layers keep them apart.  Each name then stacks
    over layers, or stays a per-layer list where its layers differ
    (llama.cpp's K_M files make some wv/w2 q6_k; gq and repacked weights may
    mix in one list).
    Consumes ``per_layer`` name by name, so the per-layer copies are freed
    as the stacked ones are made."""
    for fused, parts in FUSED.items():
        if all(p in lp for lp in per_layer for p in parts) and all(
                len({_form(lp[p]) for p in parts}) == 1 for lp in per_layer):
            for lp in per_layer:
                lp[fused] = _concat_out([lp.pop(p) for p in parts])
    out = {}
    for name in list(per_layer[0]):
        out[name] = {"w": _stack_or_list([lp.pop(name) for lp in per_layer])}
    return out


def load_params(reader, dtype: torch.dtype = torch.float32, n_ctx: int = 2048,
                device: str | torch.device = "cuda", quant_mode: str = "auto",
                smooth: dict | None = None, pack: bool = False) -> tuple[dict, LlamaConfig]:
    """Decoder params from a LlamaFileReader, stacked over layers.

    Quantized projections are decoded on ``device`` by
    ``params.load_quant_weight``'s rules for ``quant_mode``; ``auto`` is
    ``gq`` for the decoder (group-quant where ``group_i8.supported`` accepts
    the weight, repacked otherwise), ``repack`` makes every one repacked.
    ``pack`` stores the gq codes packed (``params.resolve_gq_pack`` says
    what a mode asks for).  Dense tensors are stored [in, out] in
    ``dtype``.  Layers are assembled by :func:`assemble_layers`.

    ``smooth`` (``quant_mode="w8a8"`` only): smooth-quant migration scales of
    ``quality.compute_smooth_scales``, keys "attn" [L, D], "ffn" [L, D], "w2"
    [L, F], "head" [D].  Each site divides the producing op by s (the norm
    weight before it; w3's output rows for the w2 site) and multiplies the
    consuming weights' columns by s before the i8 requantization, as the
    JAX package's ``load_params``.  A site is skipped where a consumer is
    quantized with K % 256 != 0 (it keeps the ``auto`` form, whose codes
    are the file's and cannot absorb the scales)."""
    cfg = LlamaConfig.from_hparams(reader.hparams, n_ctx=n_ctx)
    mode = "gq" if quant_mode == "auto" else quant_mode
    sm = dict(smooth) if smooth else {}
    if sm and mode != "w8a8":
        raise ValueError("smooth scales require quant_mode='w8a8'")

    def lin(name: str, col_scale=None, row_scale=None):
        rec = reader.tensors[name]
        if is_quantized(rec.dtype):
            return load_quant_weight(reader.raw(name), rec.shape, rec.dtype, device, mode,
                                     col_scale=col_scale, row_scale=row_scale, pack=pack)
        w = np.asarray(reader.tensor_f32(name), np.float32)
        if col_scale is not None:
            w = w * np.asarray(col_scale, np.float32)[None, :]
        if row_scale is not None:
            w = w * np.asarray(row_scale, np.float32)[:, None]
        return tensor(w.T, dtype, device)

    def absorbs(*names: str) -> bool:
        return not any(is_quantized(reader.tensors[n].dtype) and reader.tensors[n].shape[1] % i8.SB
                       for n in names)

    def site(key: str, li, *names: str):
        if key not in sm or not absorbs(*names):
            return None
        v = np.asarray(sm[key], np.float32)
        return v[li] if li is not None else v

    def norm(name: str, div):
        w = np.asarray(reader.tensor_f32(name), np.float32)
        return tensor(w / div if div is not None else w, dtype, device)

    s_head = site("head", None, "output.weight")
    params = {
        "tok_embeddings": tensor(reader.tensor_f32("tok_embeddings.weight"), dtype, device),
        "norm": norm("norm.weight", s_head),
        "output": {"w": lin("output.weight", col_scale=s_head)},
    }
    per_layer, norms = [], {"attention_norm": [], "ffn_norm": []}
    for i in range(cfg.n_layer):
        f = {p: f"layers.{i}.{n}.weight" for p, n in FILE_NAMES.items()}
        s_attn = site("attn", i, f["wq"], f["wk"], f["wv"])
        s_ffn = site("ffn", i, f["w1"], f["w3"])
        s_w2 = site("w2", i, f["w2"], f["w3"])
        norms["attention_norm"].append(norm(f"layers.{i}.attention_norm.weight", s_attn))
        norms["ffn_norm"].append(norm(f"layers.{i}.ffn_norm.weight", s_ffn))
        per_layer.append({
            "wq": lin(f["wq"], col_scale=s_attn), "wk": lin(f["wk"], col_scale=s_attn),
            "wv": lin(f["wv"], col_scale=s_attn), "wo": lin(f["wo"]),
            "w1": lin(f["w1"], col_scale=s_ffn), "w2": lin(f["w2"], col_scale=s_w2),
            "w3": lin(f["w3"], col_scale=s_ffn,
                      row_scale=None if s_w2 is None else 1.0 / s_w2),
        })
    layers = assemble_layers(per_layer)
    for name, ts in norms.items():
        layers[name] = torch.stack(ts)
    params["layers"] = layers
    return params, cfg
