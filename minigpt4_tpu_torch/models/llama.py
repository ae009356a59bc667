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
``[L, NP + 1, H, 128, Dh]`` of ``engine/paged.py``: decode steps and
verify spans (S <= 32 rows from per-row cursors) write through the table
and attend with the paged flash-decode kernel.

Speculative decoding (the JAX package's loops of the same names):
:func:`speculative_decode_loop` drafts by n-gram lookup
(:func:`_ngram_draft`) and verifies k tokens in one S = k forward;
:func:`stochastic_speculative_decode_loop` is its sampled form (speculative
sampling with a point-mass draft and the residual ban);
:func:`draft_speculative_decode_loop` drafts with a second, smaller model.
Every pass keeps its values on the device, so a dispatch reads no host
value until it returns, and a captured CUDA graph replays it.

The cache holds f32, bf16 or e4m3 (``torch.float8_e4m3fn``); K/V reach an
e4m3 cache through :func:`to_cache`, the JAX package's cast.

With a tensor-parallel group (``tp``, a :class:`~..parallel.TPGroup`) the
same functions run on one rank's shards (``parallel/spmd.py``), as the JAX
package's run under ``shard_map``: local head counts and widths come from
the arrays, :func:`row_linear` sums the row-parallel outputs over the
ranks, and the vocab-parallel head is gathered.  Under autograd (the
sharded training step) those sums and the gather are the differentiable
collectives of ``parallel/mesh.py``, and the replicated input of every
split column-parallel linear passes :func:`~..parallel.mesh.copy_to_tp`, so
that its gradient sums the ranks' partial ones; outside autograd they are
the in-place all-reduces, launch for launch as before.
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
from ..parallel.mesh import TPGroup, all_gather_tiled, copy_to_tp, pmax, reduce_from_tp
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


def _bits(t: torch.Tensor) -> torch.Tensor:
    """``t`` viewed as integers of its element size: cache rows move as bits,
    so no copy or index kernel needs the float8 type."""
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32}[t.element_size()])


def shift_kv_cache(cache: dict, keep: int, drop: int, n_past: int, cfg: LlamaConfig) -> dict:
    """llama.cpp's context shift on a dense cache [L, B, H, C, Dh], as the
    JAX package's ``shift_kv_cache``: positions [keep, keep + drop) are
    dropped, [keep + drop, n_past) slide down to [keep, n_past - drop), and
    the moved K rows are re-rotated by -drop (RoPE angles are linear in the
    position, so they then hold RoPE at their new positions); V rows just
    move.  Every position p >= keep takes the row of min(p + drop, C - 1),
    the JAX package's gather, so the whole cache stays comparable.

    Writes in place into ``cache``'s own tensors (captured CUDA graphs hold
    their addresses) and returns ``cache``.  The moved K rows rotate in f32
    and go back through :func:`to_cache`.  The rotation's cos/sin (one
    position, -drop) are computed on the host: -drop times an f32 RoPE
    frequency that differs by an ulp between devices moves the angle by
    drop ulps, so host tables make a shift's bits the same on the card as on
    the CPU.  Paged lanes do not shift (they free whole pages instead)."""
    k, v = cache["k"], cache["v"]
    c = k.shape[3]
    if drop <= 0:  # every position takes its own row
        return cache
    for t in (_bits(k), _bits(v)):
        last = t[:, :, :, c - 1:].clone()
        t[:, :, :, keep:c - drop] = t[:, :, :, keep + drop:].clone()
        t[:, :, :, c - drop:] = last
    hi = n_past - drop
    if hi > keep:
        rows = k[:, :, :, keep:hi]
        n_l, b, h, n, dh = rows.shape
        cos, sin = rope_tables(torch.full((1,), -drop), dh, cfg.rope_theta)
        rot = rope_interleaved(rows.reshape(n_l * b, h, n, dh).float(), cos.to(k.device),
                               sin.to(k.device))
        _bits(rows).copy_(_bits(to_cache(rot, k.dtype)).reshape(rows.shape))
    return cache


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


def _n_out(w) -> int:
    """The output width a weight produces (a per-layer list stays whole)."""
    if isinstance(w, list):
        return -1
    return w.shape[-1] if isinstance(w, torch.Tensor) else w.n_out


def col_linear(h: torch.Tensor, p: dict, li, tp: TPGroup | None, full_n: int) -> torch.Tensor:
    """Column-parallel linear of the replicated ``h``: where the weight is
    this rank's output rows (narrower than ``full_n``), autograd sums the
    gradient of ``h`` over the ranks (:func:`~..parallel.mesh.copy_to_tp`);
    a whole weight computes the whole output on every rank and takes none."""
    if tp is not None and 0 < _n_out(p["w"]) < full_n:
        h = copy_to_tp(h, tp)
    return linear(h, p, li)


def row_linear(x: torch.Tensor, p: dict, li, tp: TPGroup | None, full_k: int) -> torch.Tensor:
    """Row-parallel linear (the JAX package's ``_row_linear``).  ``full_k``
    is the global contraction width (n_embd for wo, n_ff for w2); it tells
    the four cases apart: a K-sharded weight contracts this rank's slice of
    the input (sliced here if the producer stayed whole) and the outputs
    are summed over the ranks, and a bias ``p["b"]`` (the vision
    encoder's) is added once after the sum; a whole weight takes the
    full-width input (gathered first if the producer was split) with no
    sum."""
    if tp is None:
        return linear(x, p, li)
    w = p["w"]
    kw = _k_width(w, full_k)
    if kw < full_k:  # weight K-sharded
        if x.shape[-1] == full_k:
            # a replicated input: under autograd its gradient sums the
            # ranks' slices
            x = copy_to_tp(x, tp)[..., tp.rank * kw:(tp.rank + 1) * kw]
        if isinstance(w, i8.I8SBQuant):
            # the global row absmax keeps the activation grid of one device
            # (one tiny MAX over the ranks); the partials stay f32 across
            # the sum
            xf = x.float()
            sx = pmax(xf.abs().amax(dim=-1, keepdim=True), tp) / 127.0
            sx = torch.where(sx == 0, 1.0, sx)
            y = i8.qmatmul_i8sb(xf, w, li if w.stacked else None, x_scale=sx)
            y = reduce_from_tp(y, tp).to(x.dtype)
        else:
            y = reduce_from_tp(linear(x, {"w": w}, li), tp)
        b = p.get("b")
        if b is None:
            return y
        if li is not None and b.dim() == 2:
            b = b[li]
        return y + b.to(y.dtype)
    if x.shape[-1] < full_k:
        x = all_gather_tiled(x, tp)
    return linear(x, p, li)


def _layer(x, layers, li, ck, cv, pos_dev, rope, cfg, attn_len, rows,
           page_table=None, act_stats=None, tp=None, use_flash=True):
    """One decoder layer on x [B, S, D]; writes K/V of the S positions into
    layer ``li`` of the cache in place.  ``pos_dev``: the cursors, i32 [B]
    on the device.  ``rows``: the (cache row [B, 1], position [B, S]) index
    pair of each position's write (the batch row and its position, or its
    pool page and the offset in it), so that all positions write in one
    indexed copy.  ``page_table``: the cache is the page pools (see forward).
    ``act_stats``: a dict of lists; the per-channel absolute maxima of the
    inputs of the quantizable matmuls are appended per site ("attn", "wo",
    "ffn", "w2"), the calibration capture of ``quality.py``.  ``tp``: the
    rank's tensor-parallel group (``forward``).  ``use_flash``: see
    ``forward``.

    Under autograd (K or V requires grad, dense cache) the cache takes the
    detached rows and stays out of the graph, and the layer attends over a
    copy of its own slice [B, H, C, Dh] with the rows written into it: the
    next layer's write then bumps no tensor that this layer's backward
    saved.  The values are the same; without grad nothing is copied."""
    b, s, _ = x.shape
    h = rms_norm(x, layers["attention_norm"][li], RMS_EPS)
    if act_stats is not None:
        act_stats.setdefault("attn", []).append(_amax(h))

    def heads(t):
        return t.reshape(b, s, -1, cfg.head_dim).transpose(1, 2)

    if "wqkv" in layers:
        qkv = col_linear(h, layers["wqkv"], li, tp, 3 * cfg.n_embd)
        xq, xk, xv = qkv.split(qkv.shape[-1] // 3, dim=-1)  # local width under tp
    else:
        xq, xk, xv = (col_linear(h, layers[n], li, tp, cfg.n_embd) for n in FUSED["wqkv"])
    cos, sin = rope
    q = rope_interleaved(heads(xq), cos, sin)
    k = rope_interleaved(heads(xk), cos, sin)
    v = heads(xv)

    kc, vc = to_cache(k.transpose(1, 2), ck.dtype), to_cache(v.transpose(1, 2), cv.dtype)
    li_att = li
    if page_table is None and torch.is_grad_enabled() and (kc.requires_grad or vc.requires_grad):
        ck[li][rows[0], :, rows[1]] = kc.detach()
        cv[li][rows[0], :, rows[1]] = vc.detach()
        ck, cv, li_att = ck[li].clone()[None], cv[li].clone()[None], 0
    ck[li_att][rows[0], :, rows[1]] = kc
    cv[li_att][rows[0], :, rows[1]] = vc

    if page_table is not None:
        ctx = paged_flash_decode_attention(q, ck, cv, li, pos_dev, page_table,
                                           1.0 / math.sqrt(cfg.head_dim))
    elif s <= FLASH_DECODE_MAX_S and use_flash:
        ctx = flash_decode_attention(q, ck, cv, li_att, pos_dev, 1.0 / math.sqrt(cfg.head_dim))
    else:
        ctx = _prefill_attention(q, ck, cv, li_att, pos_dev, attn_len or cfg.n_ctx,
                                 cfg.head_dim)
    ctx = ctx.to(x.dtype).transpose(1, 2).reshape(b, s, -1)
    if act_stats is not None:
        act_stats.setdefault("wo", []).append(_amax(ctx))
    x = x + row_linear(ctx, layers["wo"], li, tp, cfg.n_embd)

    h = rms_norm(x, layers["ffn_norm"][li], RMS_EPS)
    if act_stats is not None:
        act_stats.setdefault("ffn", []).append(_amax(h))
    if "w13" in layers:
        # halves of the fused output, as the JAX package splits it: a file's
        # n_mult may derive an n_ff other than its weights' width
        gate_in, up = col_linear(h, layers["w13"], li, tp, 2 * cfg.n_ff).chunk(2, dim=-1)
    else:
        gate_in, up = (col_linear(h, layers[n], li, tp, cfg.n_ff) for n in FUSED["w13"])
    gate = torch.nn.functional.silu(gate_in.float()).to(x.dtype)
    gu = gate * up
    if act_stats is not None:
        act_stats.setdefault("w2", []).append(_amax(gu))
    return x + row_linear(gu, layers["w2"], li, tp, cfg.n_ff)


def forward(params: dict, cache: dict, embeds: torch.Tensor, pos0, cfg: LlamaConfig,
            last_idx=None, attn_len: int | None = None,
            page_table: torch.Tensor | None = None, act_stats: dict | None = None,
            all_logits: bool = False, tp: TPGroup | None = None,
            use_flash: bool = True) -> torch.Tensor:
    """embeds [B, S, D] -> logits [B, V] (f32) at position ``last_idx``
    (default S-1; an int, or a long [1] tensor on the device), or [B, S, V]
    at every position with ``all_logits``; the cache is updated in place.
    ``act_stats``: the calibration capture of :func:`_layer`, plus "head",
    the absolute maxima of the final norm's output over every position.

    ``pos0`` is the cursor: an int, a sequence of one int per batch row, or
    an i32 [B] tensor on the device.  Positions, cache writes
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
    The page of each row is looked up on the device, once per call, and
    every position is written through its own page: a span of S > 1 rows
    (a speculative verify) that crosses a page edge lands on two pages,
    where the JAX package blends two window writes.

    ``tp``: this rank's tensor-parallel group; ``params`` and ``cache`` are
    then its shards (``parallel/spmd.py``) and every rank returns the same
    full-vocabulary logits.

    ``use_flash`` (the JAX package's argument): False sends spans of S <=
    32 rows to the plain masked attention over ``attn_len or cfg.n_ctx``
    (JAX's einsum branch), as the trainers do: the flash-decode kernel has
    no backward.  Paged mode ignores it.  ``forward`` differentiates
    through dense and ``qtensor`` weights (``train/``); a kernel wrapper
    given an input that requires grad on the card raises."""
    b, s, _ = embeds.shape
    dev = embeds.device
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
                   attn_len, rows, page_table, act_stats, tp, use_flash)
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
    logits = col_linear(rms_norm(h, params["norm"], RMS_EPS), params["output"], None, tp,
                         cfg.n_vocab)
    if tp is not None and logits.shape[-1] != cfg.n_vocab:
        logits = all_gather_tiled(logits, tp)  # the vocab-parallel head
    return logits.float()


def embed_tokens(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """[B, S] int -> [B, S, D] (llama.cpp get_rows)."""
    return params["tok_embeddings"][tokens]


def decode_loop(params: dict, cache: dict, logits0: torch.Tensor, pos0, n_steps: int,
                generators: list, rows, cfg: LlamaConfig,
                page_table: torch.Tensor | None = None, tp: TPGroup | None = None,
                ban0: torch.Tensor | None = None):
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
    every rank).  ``ban0`` [B] (traced rows only): each lane's residual ban
    (-1: none), which step 0 excludes (JAX's ``decode_loop`` with ``ban0``);
    with every ban -1 the draws are those of the loop without it."""
    from ..engine.device_sampling import sample_res_rows, sample_rows

    if ban0 is not None and rows.traced is None:
        raise ValueError("ban0 requires the traced (lane_rows) config")
    pos = pos_vector(pos0, logits0.shape[0], logits0.device)
    logits = logits0
    toks = []
    for i in range(n_steps):
        tok = (sample_res_rows(logits, ban0, generators, rows) if i == 0 and ban0 is not None
               else sample_rows(logits, generators, rows))
        toks.append(tok)
        logits = forward(params, cache, embed_tokens(params, tok[:, None]), pos + i, cfg,
                         page_table=page_table, tp=tp)
    return torch.stack(toks, dim=1), logits


def _ngram_draft(hist: torch.Tensor, pos: torch.Tensor, t0: torch.Tensor,
                 k_draft: int) -> torch.Tensor:
    """Prompt-lookup drafts of a batch (JAX's ``_ngram_draft``, batched):
    for each lane, the ``k_draft`` tokens that followed the most recent
    occurrence of its current n-gram in its history.

    ``hist`` [B, C] holds the evaluated token ids (-1 for injected
    embedding rows, which match no token id), ``pos`` [B] the number of
    valid entries and ``t0`` [B] the sampled, not yet evaluated token.  A
    4-gram match beats a trigram, a trigram a bigram; among equal lengths
    the most recent wins.  A match needs a written continuation (index <=
    pos - 2), so a period-1 stream drafts its repetition.  The start is
    clipped to C - k_draft, and -1 entries of the draft are filled forward
    from ``t0``.  With no match the slice is arbitrary: verification
    rejects it.  Returns [B, k_draft] long, computed on the device."""
    b, c = hist.shape
    dev = hist.device
    hist = hist.long()
    pos = pos.long()
    t0 = t0.long()
    idx = torch.arange(c, device=dev)[None]
    rows = torch.arange(b, device=dev)

    def at(back):  # hist[pos - back], clipped at 0
        return hist[rows, (pos - back).clamp(min=0)][:, None]

    pos_c = pos[:, None]
    m2 = ((hist == t0[:, None]) & (hist.roll(1, 1) == at(1)) & (idx >= 1)
          & (idx <= pos_c - 2))
    m3 = m2 & (hist.roll(2, 1) == at(2)) & (idx >= 2) & (pos_c >= 2)
    m4 = m3 & (hist.roll(3, 1) == at(3)) & (idx >= 3) & (pos_c >= 3)
    val = torch.where(m4, 2 * c + idx, torch.where(m3, c + idx, torch.where(m2, idx, -1)))
    j = val.amax(dim=1)
    j = torch.where(j >= 2 * c, j - 2 * c, torch.where(j >= c, j - c, j))
    start = (j + 1).clamp(0, c - k_draft)
    draft = hist.gather(1, start[:, None] + torch.arange(k_draft, device=dev))
    # forward fill: each -1 takes the last written entry before it, or t0
    ar = torch.arange(k_draft, device=dev)[None]
    last = torch.where(draft >= 0, ar, -1).cummax(dim=1).values
    filled = draft.gather(1, last.clamp(min=0))
    return torch.where(last >= 0, filled, t0[:, None])


def _write_hist(hist: torch.Tensor, toks: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """``hist`` with each lane's ``toks`` [B, k] written from its cursor;
    the start clips to C - k, as JAX's ``dynamic_update_slice`` clips it
    (only a finished lane past its context end gets there)."""
    c, k = hist.shape[1], toks.shape[1]
    start = pos.long().clamp(max=c - k)[:, None] + torch.arange(k, device=hist.device)
    return hist.scatter(1, start, toks.to(hist.dtype))


def _accept(logits_all: torch.Tensor, ok: torch.Tensor):
    """(accepted drafts [B], tokens emitted [B], the pending logits after
    the last accepted token [B, V]) of a verify pass whose leading drafts
    ``ok`` [B, k-1] agree."""
    acc = ok.long().cumprod(dim=1).sum(dim=1)
    v = logits_all.shape[-1]
    new_logits = logits_all.gather(1, acc[:, None, None].expand(-1, 1, v))[:, 0]
    return acc, 1 + acc, new_logits


def speculative_decode_loop(params: dict, cache: dict, logits0: torch.Tensor, pos0,
                            hist: torch.Tensor, n_passes: int, k_spec: int, cfg: LlamaConfig,
                            page_table: torch.Tensor | None = None,
                            tp: TPGroup | None = None):
    """Greedy speculative decode (JAX's ``speculative_decode_loop``):
    ``n_passes`` verify passes, each drafting ``k_spec - 1`` tokens by
    n-gram lookup (:func:`_ngram_draft`) and verifying the block [t0,
    drafts] in one forward of S = ``k_spec`` rows, which reads the weights
    once.  A draft is accepted only where it equals the argmax of the
    model's own logits at its position, so the emitted ids are those of
    plain greedy decode.  Sample-then-eval order: t0 is the argmax of the
    pending logits.  Rejected positions leave cache and history entries
    past the advanced cursor, which the mask hides and later writes
    overwrite.

    ``pos0``: int, [B] ints or i32 [B] on the device; ``hist`` [B, C] the
    lanes' token histories (not modified); ``page_table``: paged mode, the
    caller provisions pages covering pos0 + n_passes * k_spec for active
    lanes.  Returns (tokens [B, n_passes, k_spec], counts [B, n_passes],
    final logits [B, V], hist [B, C]): lane b's pass p emitted
    ``tokens[b, p, :counts[b, p]]``."""
    pos = pos_vector(pos0, logits0.shape[0], logits0.device).long()
    logits, h = logits0, hist
    toks_all, counts = [], []
    for _ in range(n_passes):
        t0 = logits.argmax(dim=-1)
        draft = _ngram_draft(h, pos, t0, k_spec - 1)
        toks = torch.cat([t0[:, None], draft], dim=1)
        logits_all = forward(params, cache, embed_tokens(params, toks), pos, cfg,
                             all_logits=True, page_table=page_table, tp=tp)
        g = logits_all.argmax(dim=-1)
        _, count, logits = _accept(logits_all, draft == g[:, :-1])
        h = _write_hist(h, toks, pos)
        pos = pos + count
        toks_all.append(toks)
        counts.append(count)
    return torch.stack(toks_all, dim=1), torch.stack(counts, dim=1), logits, h


def stochastic_speculative_decode_loop(params: dict, cache: dict, logits0: torch.Tensor, pos0,
                                       hist: torch.Tensor, ban0: torch.Tensor, generators: list,
                                       rows, n_passes: int, k_spec: int, cfg: LlamaConfig,
                                       page_table: torch.Tensor | None = None,
                                       tp: TPGroup | None = None):
    """Sampled speculative decode (JAX's
    ``stochastic_speculative_decode_loop``): speculative sampling with the
    n-gram draft as a point-mass proposal.  Each draft d is accepted with
    probability p(d), p the lane's post-chain distribution at its position
    (:func:`~..engine.device_sampling.chain_logits_dyn`); the first
    rejected draft becomes the lane's ban, and the next sample (the next
    pass's t0, or the next dispatch's) draws from norm(p with d zeroed)
    (:func:`~..engine.device_sampling.sample_res_rows`).  The emitted
    distribution is that of plain sampling; greedy lanes (temp <= 0) verify
    by the argmax of their biased logits and emit plain greedy ids.

    ``rows``: traced lane rows (:func:`~..engine.device_sampling.lane_rows`
    of a group with a sampled or biased lane); ``generators``: one per
    lane, from which each pass draws t0 (V uniforms) and then the k - 1
    acceptance uniforms; ``ban0`` [B] the carried bans (-1: none).
    Returns (tokens [B, n_passes, k_spec], counts [B, n_passes], final
    logits [B, V], hist [B, C], ban [B])."""
    from ..engine.device_sampling import (TRACED, _greedy_pick, chain_logits_dyn,
                                          sample_res_rows)

    if rows.traced is None:
        raise ValueError("stochastic speculation takes the traced (lane_rows) config")
    b = logits0.shape[0]
    dev = logits0.device
    pos = pos_vector(pos0, b, dev).long()
    ban = pos_vector(ban0, b, dev).long()
    greedy_lane = rows.traced["temp"] <= 0.0
    # each draft position's chain runs under its lane's thresholds
    thresholds = [rows.traced[name][:, None].expand(b, k_spec - 1).reshape(-1)
                  for name in TRACED]
    bias = rows.bias
    bias_rep = (None if bias is None
                else bias[:, None].expand(b, k_spec - 1, bias.shape[-1]).reshape(-1, bias.shape[-1]))
    logits, h = logits0, hist
    toks_all, counts = [], []
    for _ in range(n_passes):
        t0 = sample_res_rows(logits, ban, generators, rows)
        draft = _ngram_draft(h, pos, t0, k_spec - 1)
        toks = torch.cat([t0[:, None], draft], dim=1)
        logits_all = forward(params, cache, embed_tokens(params, toks), pos, cfg,
                             all_logits=True, page_table=page_table, tp=tp)
        v = logits_all.shape[-1]
        z = chain_logits_dyn(logits_all[:, :-1].reshape(-1, v), *thresholds, bias_rep)
        p_d = torch.softmax(z, dim=-1).gather(1, draft.reshape(-1, 1)).reshape(b, k_spec - 1)
        u = torch.stack([torch.rand(k_spec - 1, generator=g, device=dev) for g in generators])
        g = _greedy_pick(logits_all, None if bias is None else bias[:, None, :])
        ok = torch.where(greedy_lane[:, None], draft == g[:, :-1], u < p_d)
        acc, count, logits = _accept(logits_all, ok)
        # the first rejected draft is the next sample's ban
        nxt = toks.gather(1, (acc + 1).clamp(max=k_spec - 1)[:, None])[:, 0]
        ban = torch.where(acc < k_spec - 1, nxt, -1)
        h = _write_hist(h, toks, pos)
        pos = pos + count
        toks_all.append(toks)
        counts.append(count)
    return torch.stack(toks_all, dim=1), torch.stack(counts, dim=1), logits, h, ban


def draft_speculative_decode_loop(params: dict, cache: dict, dparams: dict, dcache: dict,
                                  logits0: torch.Tensor, pos0, n_passes: int, k_spec: int,
                                  cfg: LlamaConfig, dcfg: LlamaConfig):
    """Greedy speculative decode drafted by a second, smaller model sharing
    the vocabulary (JAX's ``draft_speculative_decode_loop``, llama.cpp's
    "speculative" example).  Each pass runs ``k_spec`` greedy steps of the
    drafter from t0 (the last one only fills the draft cache, so that a
    fully accepted pass leaves it without a gap) and one S = ``k_spec``
    verify of [t0, d1 .. d(k-1)] on the main model.  The emitted ids are
    those of plain greedy decode whatever the drafter proposes.  Both
    caches are updated in place; ``dcache`` must hold the same history as
    ``cache`` up to the cursor.  Returns (tokens [B, n_passes, k_spec],
    counts [B, n_passes], final logits [B, V])."""
    pos = pos_vector(pos0, logits0.shape[0], logits0.device).long()
    logits = logits0
    toks_all, counts = [], []
    for _ in range(n_passes):
        tok = logits.argmax(dim=-1)
        seq = []
        for i in range(k_spec):
            seq.append(tok)
            dlog = forward(dparams, dcache, embed_tokens(dparams, tok[:, None]), pos + i, dcfg)
            tok = dlog.argmax(dim=-1)
        toks = torch.stack(seq, dim=1)
        logits_all = forward(params, cache, embed_tokens(params, toks), pos, cfg, all_logits=True)
        g = logits_all.argmax(dim=-1)
        _, count, logits = _accept(logits_all, toks[:, 1:] == g[:, :-1])
        pos = pos + count
        toks_all.append(toks)
        counts.append(count)
    return torch.stack(toks_all, dim=1), torch.stack(counts, dim=1), logits


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
