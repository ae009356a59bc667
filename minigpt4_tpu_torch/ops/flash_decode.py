"""Decode attention over the KV cache (S <= 32 query rows).

Counterpart of ``minigpt4_tpu/ops/flash_decode.py``, for two cache layouts:

- :func:`flash_decode_attention`: the stacked cache ``[L, B, H, C, Dh]``,
  normalized or, with ``return_stats``, as online-softmax partials
  ``(acc, m, l)`` (plain version :func:`flash_decode_stats_ref`), which
  :func:`sp_flash_decode_attention` merges across the ranks that each hold
  a slice of the cache's positions (sequence parallelism);
- :func:`paged_flash_decode_attention`: the serving page pools
  ``[L, NP + 1, H, 128, Dh]`` read through a page table ``[B, W]``
  (``engine/paged.py``).

Each runs the hand-written CUDA kernel of ``csrc/flash_decode.cu`` on CUDA
tensors and its plain PyTorch version (:func:`flash_decode_ref`,
:func:`paged_flash_decode_ref`) on CPU tensors: causal attention of q
``[B, H, S, Dh]`` over layer ``li``, from absolute position ``pos0`` (an
int, or one cursor per batch row), softmax in f32, output f32.  Only the
live keys ``[0, pos0 + S)`` are read; keys past the cache end (paged: past
128 W) are masked.  The cache is f32, bf16 or e4m3 (``torch.float8_e4m3fn``);
both versions read an e4m3 element as the JAX kernel's ``_block_f32`` does
(:func:`cache_f32`): subnormals flush to +-0 and 0x7F / 0xFF stay NaN.

The kernel cuts each lane's live keys into ``KEY_TILE``-key tiles and
splits them over ``n_splits`` blocks per (lane, head), whose partials it
merges in split order in the same launch; :func:`split_plan` is that plan
as a plain function and :func:`flash_decode_split_ref` the plain version of
the split-then-merge arithmetic.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ..parallel.mesh import TPGroup, pmax, psum

MAX_S = 32  # rows the kernel serves (models.llama.FLASH_DECODE_MAX_S)
KERNEL_HEAD_DIMS = (64, 128)
PAGE = 128  # positions per pool page, fixed in the paged kernel (csrc kPage)
KEY_TILE = 64  # keys per staged tile (csrc kTile); divides PAGE
MAX_SPLITS = 32  # key splits per (lane, head) the kernel takes (csrc kMaxSplits)
# blocks per SM the split count aims at: one lane's splits all carry keys;
# the lanes of a batch have other cursors, short lanes' blocks end early and
# the card needs more blocks in flight
WAVE_BLOCKS, RAGGED_WAVE_BLOCKS = 2, 8


# cache element types the kernel takes, by its type code (csrc kF32, kBF16, kE4M3)
CACHE_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2}


def cache_f32(t: torch.Tensor) -> torch.Tensor:
    """Cache elements -> f32 as the kernels read them: an e4m3 element whose
    exponent field is 0 (zero or subnormal) gives +-0 (the JAX kernel's
    integer unpack, ``flash_decode.py:_block_f32``), every other one its
    value, NaN included; other types convert exactly."""
    f = t.float()
    if t.dtype != torch.float8_e4m3fn:
        return f
    sub = (t.view(torch.uint8) & 0x7F) < 8
    return torch.where(sub, f * 0.0, f)


def pos_vector(pos0, b: int, device) -> torch.Tensor:
    """pos0 (int, sequence of ints, or tensor) -> i32 [B] on ``device``."""
    if isinstance(pos0, torch.Tensor):
        p = pos0.to(device=device, dtype=torch.int32).reshape(-1)
        return p.expand(b).contiguous() if p.numel() == 1 else p.contiguous()
    if isinstance(pos0, int):
        return torch.full((b,), pos0, dtype=torch.int32, device=device)
    return torch.tensor(list(pos0), dtype=torch.int32, device=device)


def n_splits(capacity: int, b: int, h: int, sms: int) -> int:
    """Key splits per (lane, head) for a launch over caches that hold
    ``capacity`` keys per lane: enough blocks to give each of the ``sms``
    SMs ``WAVE_BLOCKS`` of them (``RAGGED_WAVE_BLOCKS`` for a batch of
    several lanes), at most one per tile and at most ``MAX_SPLITS``."""
    tiles = max(1, -(-capacity // KEY_TILE))
    per_sm = WAVE_BLOCKS if b == 1 else RAGGED_WAVE_BLOCKS
    return max(1, min(tiles, MAX_SPLITS, per_sm * sms // (b * h)))


def split_bounds(live: int, splits: int) -> list[tuple[int, int]]:
    """The keys [k0, k1) of each of ``splits`` splits over a lane's ``live``
    keys, as each block of the kernel finds them: split z takes the tiles
    [z T / splits, (z + 1) T / splits) of the T live tiles (integer
    division), clipped to ``live``; a split may be empty (k0 == k1)."""
    live = max(0, live)
    tiles = -(-live // KEY_TILE)
    return [(min(z * tiles // splits * KEY_TILE, live),
             min((z + 1) * tiles // splits * KEY_TILE, live)) for z in range(splits)]


def split_plan(live: int, b: int, h: int, sms: int, capacity: int | None = None
               ) -> list[tuple[int, int]]:
    """The non-empty key ranges one (lane, head) block group works on: live
    keys ``live`` (cursor + S, clipped to the cache), batch ``b``, heads
    ``h``, ``sms`` SMs, caches of ``capacity`` keys per lane (default
    ``live``).  Every boundary but the last is a multiple of KEY_TILE, the
    ranges cover [0, live) in order, and a lane with no live key (a negative
    cursor) gets none."""
    splits = n_splits(live if capacity is None else capacity, b, h, sms)
    return [(k0, k1) for k0, k1 in split_bounds(live, splits) if k1 > k0]


def flash_decode_split_ref(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor, li: int,
                           pos0, scale: float, splits: int, return_stats: bool = False):
    """Plain version of the kernel's split-then-merge: per lane the partials
    (m, l, acc) of each split of :func:`split_bounds` over its own live keys
    (the neutral m = -inf, l = 0, acc = 0 where a split sees no visible key),
    merged in split order as

        m* = max_z m_z,  w_z = exp(m_z - m*),  l = sum_z w_z l_z,  acc = sum_z w_z acc_z

    -> acc / l [B, H, S, Dh], or ``(acc, m*, l)`` with ``return_stats``."""
    b, h, s, dh = q.shape
    sc, visible, vs = _scores(q, ck, cv, li, pos0, scale)
    pos = pos_vector(pos0, b, q.device).long()
    c = ck.shape[-2]
    key = torch.arange(sc.shape[-1], device=q.device)
    bounds = [split_bounds(min(int(p) + s, c), splits) for p in pos.tolist()]
    parts = []
    for z in range(splits):
        lo = torch.tensor([bd[z][0] for bd in bounds], device=q.device)[:, None]
        hi = torch.tensor([bd[z][1] for bd in bounds], device=q.device)[:, None]
        inside = ((key[None, :] >= lo) & (key[None, :] < hi))[:, None, None, :]  # [B, 1, 1, keys]
        vis = visible & inside
        sz = sc.masked_fill(~vis, float("-inf"))
        m = sz.amax(dim=-1) if sz.shape[-1] else sz.new_full(sz.shape[:-1], float("-inf"))
        p = torch.where(vis, torch.exp(sz - m[..., None]), 0.0)
        parts.append((p @ vs, m, p.sum(dim=-1)))
    m_st = torch.stack([m for _, m, _ in parts]).amax(dim=0)
    l_st = torch.zeros_like(m_st)
    acc_st = torch.zeros_like(q, dtype=torch.float32)
    for acc, m, l in parts:
        w = torch.where(torch.isneginf(m), 0.0, torch.exp(m - m_st))
        l_st = l_st + l * w
        acc_st = acc_st + acc * w[..., None]
    if return_stats:
        return acc_st, m_st, l_st
    return acc_st / l_st[..., None]


def flash_decode_ref(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor, li: int,
                     pos0, scale: float) -> torch.Tensor:
    """Plain version: masked f32 softmax attention over ``cache[:pos0+S]``.

    Like the kernel, a lane reads nothing past its cursor ``pos0 + S``: a
    stale NaN there (an e4m3 overflow left behind by a rollback) cannot reach
    its output.  The JAX kernel reads whole key blocks and lets such a NaN
    through; this divergence is deliberate."""
    sc, visible, vs = _scores(q, ck, cv, li, pos0, scale)
    return torch.softmax(sc.masked_fill(~visible, float("-inf")), dim=-1) @ vs


def _scores(q, ck, cv, li, pos0, scale):
    """Scaled f32 scores [B, H, S, live] over the keys [0, live) that any
    row may read (live = min(max cursor + S, C), 0 if negative), the mask
    of the visible ones [B, 1, S, live] and the values [B, H, live, Dh]; a
    lane reads nothing past its own cursor."""
    b, h, s, dh = q.shape
    c = ck.shape[-2]
    pos = pos_vector(pos0, b, q.device).long()
    live = max(0, min(int(pos.max()) + s, c))
    key_pos = torch.arange(live, device=q.device)
    read = (key_pos[None, :] < (pos[:, None] + s))[:, None, :, None]  # [B, 1, live, 1]
    ks = cache_f32(ck[li, :, :, :live]).masked_fill(~read, 0.0)
    vs = cache_f32(cv[li, :, :, :live]).masked_fill(~read, 0.0)
    sc = torch.einsum("bhsd,bhcd->bhsc", q.float() * scale, ks)
    q_pos = pos[:, None] + torch.arange(s, device=q.device)  # [B, S]
    visible = key_pos[None, None, :] <= q_pos[:, :, None]  # [B, S, live]
    return sc, visible[:, None], vs


def flash_decode_stats_ref(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor, li: int,
                           pos0, scale: float):
    """Plain version of the partials: ``(acc [B, H, S, Dh], m [B, H, S],
    l [B, H, S])``, f32, with m the maximum visible score of a row, l the
    sum of exp(score - m) over its visible keys and acc the same weights
    times V.  A row that sees no key (a cursor below -row) gets m = -inf,
    l = 0 and acc = 0."""
    sc, visible, vs = _scores(q, ck, cv, li, pos0, scale)
    sc = sc.masked_fill(~visible, float("-inf"))
    m = sc.amax(dim=-1) if sc.shape[-1] else sc.new_full(sc.shape[:-1], float("-inf"))
    p = torch.where(visible, torch.exp(sc - m[..., None]), 0.0)
    return p @ vs, m, p.sum(dim=-1)


# per device index: [SM count, counters, partials]; the buffers grow as
# launches need and are shared by every launch on the device's stream
_work: dict = {}
_held: list = []  # outgrown buffers: a captured CUDA graph may still use them


def _split_args(device, b: int, h: int, s: int, dh: int, capacity: int):
    """(splits, partials or None, counters or None) of one launch: the split
    count of :func:`n_splits` for this card, f32 scratch for the splits'
    partials and one i32 counter per (lane, head), zero between launches
    (the kernel leaves them at 0)."""
    w = _work.get(device.index)
    if w is None:
        w = _work[device.index] = [
            torch.cuda.get_device_properties(device).multi_processor_count, None, None]
    splits = n_splits(capacity, b, h, w[0])
    if splits == 1:
        return 1, None, None
    n_part = b * h * splits * s * (dh + 2)
    if w[1] is None or w[1].numel() < b * h:
        _held.append(w[1])
        w[1] = torch.zeros(max(b * h, 1024), dtype=torch.int32, device=device)
    if w[2] is None or w[2].numel() < n_part:
        _held.append(w[2])
        w[2] = torch.empty(max(n_part, 1 << 20), dtype=torch.float32, device=device)
    return splits, w[2], w[1]


def _checked(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, li: int, pos0,
             heads: tuple) -> tuple[torch.Tensor, torch.Tensor]:
    """What both kernels refuse, raised before a launch; ``heads`` is the
    cache's (H, Dh).  Returns q as contiguous, aligned f32 and the cursors as
    i32 [B]."""
    b, h, s, dh = q.shape
    _build.refuse_grad(name, q, k, v)
    if v.shape != k.shape or v.dtype != k.dtype:
        raise ValueError(f"{name}: k and v must match in shape and dtype")
    if heads != (h, dh):
        raise ValueError(f"{name}: q {tuple(q.shape)} does not match {tuple(k.shape)}")
    if not 1 <= s <= MAX_S:
        raise ValueError(f"{name} serves 1..{MAX_S} query rows, got {s}")
    if dh not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{name} kernel supports head_dim {KERNEL_HEAD_DIMS}, got {dh}")
    if k.dtype not in CACHE_TYPES:
        raise NotImplementedError(
            f"{name}: a {k.dtype} cache is not ported: the kernel takes f32, bf16 or e4m3 "
            "(the JAX package's cache types)")
    if not 0 <= li < k.shape[0]:
        raise IndexError(f"{name}: layer {li} out of range [0, {k.shape[0]})")
    for label, t in (("k", k), ("v", v)):
        if t.device != q.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {label} must be a contiguous, 16-byte aligned "
                             f"tensor on {q.device}")
    qf = q.float().contiguous()
    if qf.data_ptr() % 16:
        qf = qf.clone()
    pos = pos_vector(pos0, b, q.device)
    if pos.shape != (b,):
        raise ValueError(f"{name}: pos0 must be a scalar or [B={b}]")
    return qf, pos


def _ptr(t):
    return None if t is None else t.data_ptr()


def flash_decode_attention(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                           li: int, pos0, scale: float, return_stats: bool = False):
    """q [B, H, S, Dh] x cache [L, B, H, C, Dh] -> ctx [B, H, S, Dh] f32, or
    with ``return_stats`` the partials ``(acc, m, l)`` of
    :func:`flash_decode_stats_ref` (the cursors may then be negative).
    ``launches`` counts the normalized launches, ``stats_launches`` the
    others."""
    if q.device.type == "cpu":
        if return_stats:
            return flash_decode_stats_ref(q, ck, cv, li, pos0, scale)
        return flash_decode_ref(q, ck, cv, li, pos0, scale)
    b, h, s, dh = q.shape
    if ck.shape[1] != b:
        raise ValueError(f"flash_decode: q {tuple(q.shape)} does not match cache {tuple(ck.shape)}")
    qf, pos = _checked("flash_decode", q, ck, cv, li, pos0, (ck.shape[2], ck.shape[4]))
    out = torch.empty((b, h, s, dh), dtype=torch.float32, device=q.device)
    ml = torch.empty((2, b, h, s), dtype=torch.float32, device=q.device) if return_stats else None
    splits, work, cnt = _split_args(q.device, b, h, s, dh, ck.shape[3])
    rc = _build.load().mgt_flash_decode(
        qf.data_ptr(), ck.data_ptr(), cv.data_ptr(), pos.data_ptr(), out.data_ptr(),
        None if ml is None else ml.data_ptr(), _ptr(work), _ptr(cnt), b, h, s, ck.shape[3], dh,
        li, splits, float(scale), CACHE_TYPES[ck.dtype],
        ctypes.c_void_p(_build.stream_ptr(q.device)))
    _build.check(rc, "mgt_flash_decode")
    if ml is None:
        flash_decode_attention.launches += 1
        return out
    flash_decode_attention.stats_launches += 1
    return out, ml[0], ml[1]


flash_decode_attention.launches = 0
flash_decode_attention.stats_launches = 0


def merge_partials(parts: list, group: TPGroup | None = None) -> torch.Tensor:
    """Normalized attention [B, H, S, Dh] from online-softmax partials
    ``(acc, m, l)`` of disjoint key slices: this process's ``parts``, and
    with a ``group`` those of every rank of it (one MAX and two SUM
    all-reduces), as

        ctx = sum_i exp(m_i - m*) acc_i / sum_i exp(m_i - m*) l_i

    A slice with m = -inf (no visible key) weighs 0."""
    m_star = torch.stack([m for _, m, _ in parts]).amax(dim=0)
    if group is not None:
        m_star = pmax(m_star, group)
    acc_star = l_star = 0.0
    for acc, m, l in parts:
        w = torch.where(m == float("-inf"), 0.0, torch.exp(m - m_star))
        acc_star = acc_star + acc * w[..., None]
        l_star = l_star + l * w
    if group is not None:
        acc_star, l_star = psum(acc_star, group), psum(l_star, group)
    return acc_star / l_star[..., None]


def sp_flash_decode_attention(q: torch.Tensor, ck_local: torch.Tensor, cv_local: torch.Tensor,
                              li: int, pos0, scale: float, group: TPGroup,
                              c_offset: int) -> torch.Tensor:
    """Sequence-parallel decode attention: every rank of ``group`` holds
    the cache positions [c_offset, c_offset + C_local) of the same queries
    (``ck_local`` [L, B, H, C_local, Dh]); each runs the partials of
    :func:`flash_decode_attention` on its slice from the cursor
    ``pos0 - c_offset`` and :func:`merge_partials` combines them.  Every
    rank returns the attention over the whole cache, f32."""
    b = q.shape[0]
    pos = pos_vector(pos0, b, q.device) - int(c_offset)
    return merge_partials([flash_decode_attention(q, ck_local, cv_local, li, pos, scale,
                                                  return_stats=True)], group)


def paged_flash_decode_ref(q: torch.Tensor, pool_k: torch.Tensor, pool_v: torch.Tensor,
                           li: int, pos0, page_table: torch.Tensor, scale: float) -> torch.Tensor:
    """Plain version: gather each lane's pages into a dense ``[1, B, H,
    128 W, Dh]`` cache, then :func:`flash_decode_ref`."""
    b, h, _, dh = q.shape
    page = pool_k.shape[3]
    pt = page_table.long()
    w = pt.shape[1]

    def gather(pool):  # [NP + 1, H, PAGE, Dh] -> [1, B, H, W * PAGE, Dh]
        g = pool[li][pt]  # [B, W, H, PAGE, Dh]
        return g.permute(0, 2, 1, 3, 4).reshape(1, b, h, w * page, dh)

    return flash_decode_ref(q, gather(pool_k), gather(pool_v), 0, pos0, scale)


def paged_flash_decode_attention(q: torch.Tensor, pool_k: torch.Tensor, pool_v: torch.Tensor,
                                 li: int, pos0, page_table: torch.Tensor,
                                 scale: float) -> torch.Tensor:
    """q [B, H, S, Dh] x pools [L, NP + 1, H, 128, Dh] through ``page_table``
    [B, W] i32 (lane b's positions [128 i, 128 i + 128) in pool page
    ``page_table[b, i]``) -> ctx [B, H, S, Dh] f32."""
    if q.device.type == "cpu":
        return paged_flash_decode_ref(q, pool_k, pool_v, li, pos0, page_table, scale)
    b, h, s, dh = q.shape
    if pool_k.shape[3] != PAGE:
        raise ValueError(f"paged_flash_decode: page size {pool_k.shape[3]}, the kernel takes {PAGE}")
    qf, pos = _checked("paged_flash_decode", q, pool_k, pool_v, li, pos0,
                       (pool_k.shape[2], pool_k.shape[4]))
    pt = page_table
    if (pt.dim() != 2 or pt.shape[0] != b or pt.dtype != torch.int32
            or pt.device != q.device or not pt.is_contiguous()):
        raise ValueError(f"paged_flash_decode: page_table must be a contiguous [B={b}, W] "
                         f"int32 tensor on {q.device}, got {tuple(pt.shape)} {pt.dtype} "
                         f"on {pt.device}")
    out = torch.empty((b, h, s, dh), dtype=torch.float32, device=q.device)
    splits, work, cnt = _split_args(q.device, b, h, s, dh, pt.shape[1] * PAGE)
    rc = _build.load().mgt_flash_decode_paged(
        qf.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), pos.data_ptr(), pt.data_ptr(),
        out.data_ptr(), _ptr(work), _ptr(cnt), b, h, s, pool_k.shape[1], pt.shape[1], dh, li,
        splits, float(scale), CACHE_TYPES[pool_k.dtype],
        ctypes.c_void_p(_build.stream_ptr(q.device)))
    _build.check(rc, "mgt_flash_decode_paged")
    paged_flash_decode_attention.launches += 1
    return out


paged_flash_decode_attention.launches = 0
