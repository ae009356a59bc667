"""ggml block-quantization codecs, vectorized in NumPy.

Bit-exact decoders (and compatible encoders) for every quant format the
reference can load: q4_0..q8_1 simple 32-element blocks and the q2_k..q8_k
256-element super-block k-quants (QK_K = 256, as built by the reference with
``GGML_USE_K_QUANTS ON`` — the reference's CMakeLists.txt:317, quantizer entry
point the reference's minigpt4.cpp:2817-2982).

Layouts follow ggml at llama.cpp master-31cfbb1.  Decoders are the
load-bearing half (existing checkpoints must decode bit-exactly); encoders
produce valid blocks that round-trip through the decoders and use the same
scale-selection rules as ggml's reference (round-to-nearest) quantizers for
the simple formats.  K-quant encoders use round-to-nearest scale search rather
than ggml's iterative refinement, which yields slightly different (but format-
valid) blocks; decode compatibility is what the checkpoint contract requires.

All functions operate on the packed byte representation: ``raw`` is a 1-D
``uint8`` array whose length is a multiple of the block byte-size, and the
logical float payload is returned/accepted as 1-D ``float32``.
"""

from __future__ import annotations

import numpy as np

from .dtypes import QK, QK_K, DataType, traits

# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _as_blocks(raw: np.ndarray, block_bytes: int) -> np.ndarray:
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    if raw.ndim != 1 or raw.size % block_bytes:
        raise ValueError(f"raw size {raw.size} not a multiple of {block_bytes}")
    return raw.reshape(-1, block_bytes)


def _f16(b: np.ndarray) -> np.ndarray:
    """View pairs of bytes as little-endian float16 -> float32 [nblocks, n]."""
    return b.copy().view(np.dtype("<f2")).astype(np.float32)


def _store_f16(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x.astype(np.dtype("<f2"))).view(np.uint8)


def _nearest_int(x: np.ndarray) -> np.ndarray:
    """ggml's nearest_int: round half away from zero (C lrintf is
    round-half-to-even; ggml uses bit tricks equal to round-to-nearest-even).

    ggml's nearest_int adds a magic constant which implements round half to
    even; np.rint matches that.
    """
    return np.rint(x).astype(np.int32)


# ---------------------------------------------------------------------------
# q4_0: { fp16 d; uint8 qs[16] }  -> x[j] = (nib - 8) * d
# byte j: low nibble = elem j, high nibble = elem j+16
# ---------------------------------------------------------------------------


def dequantize_q4_0(raw: np.ndarray) -> np.ndarray:
    b = _as_blocks(raw, 18)
    d = _f16(b[:, :2])  # [nb, 1]
    qs = b[:, 2:18]
    lo = (qs & 0x0F).astype(np.int8) - 8
    hi = (qs >> 4).astype(np.int8) - 8
    out = np.concatenate([lo, hi], axis=1).astype(np.float32) * d
    return out.reshape(-1)


def quantize_q4_0(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float32).reshape(-1, QK)
    # ggml: pick the signed value with the largest magnitude, d = max / -8
    idx = np.argmax(np.abs(x), axis=1)
    maxv = x[np.arange(len(x)), idx]
    d = maxv / -8.0
    d16 = d.astype(np.float16)
    id_ = np.where(d16 != 0, 1.0 / d16.astype(np.float32), 0.0)[:, None]
    q = np.clip(_nearest_int(x * id_) + 8, 0, 15).astype(np.uint8)
    packed = q[:, :16] | (q[:, 16:] << 4)
    out = np.empty((len(x), 18), np.uint8)
    out[:, :2] = _store_f16(d16).reshape(-1, 2)
    out[:, 2:] = packed
    return out.reshape(-1)


# ---------------------------------------------------------------------------
# q4_1: { fp16 d; fp16 m; uint8 qs[16] } -> x = nib * d + m
# ---------------------------------------------------------------------------


def dequantize_q4_1(raw: np.ndarray) -> np.ndarray:
    b = _as_blocks(raw, 20)
    d = _f16(b[:, :2])
    m = _f16(b[:, 2:4])
    qs = b[:, 4:20]
    lo = (qs & 0x0F).astype(np.float32)
    hi = (qs >> 4).astype(np.float32)
    out = np.concatenate([lo, hi], axis=1) * d + m
    return out.reshape(-1)


def quantize_q4_1(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float32).reshape(-1, QK)
    mn = x.min(axis=1)
    mx = x.max(axis=1)
    d = (mx - mn) / 15.0
    d16 = d.astype(np.float16)
    m16 = mn.astype(np.float16)
    id_ = np.where(d16 != 0, 1.0 / d16.astype(np.float32), 0.0)[:, None]
    q = np.clip(_nearest_int((x - m16.astype(np.float32)[:, None]) * id_), 0, 15).astype(np.uint8)
    out = np.empty((len(x), 20), np.uint8)
    out[:, 0:2] = _store_f16(d16).reshape(-1, 2)
    out[:, 2:4] = _store_f16(m16).reshape(-1, 2)
    out[:, 4:] = q[:, :16] | (q[:, 16:] << 4)
    return out.reshape(-1)


# ---------------------------------------------------------------------------
# q5_0: { fp16 d; uint32 qh; uint8 qs[16] } -> x = ((nib | 5th-bit) - 16) * d
# ---------------------------------------------------------------------------


def _qh_bits(b: np.ndarray, off: int) -> np.ndarray:
    """Expand the packed uint32 high-bit field to [nb, 32] of {0,1}."""
    qh = b[:, off : off + 4].copy().view("<u4").astype(np.uint32)  # [nb, 1]
    shifts = np.arange(32, dtype=np.uint32)[None, :]
    return ((qh >> shifts) & 1).astype(np.uint8)


def dequantize_q5_0(raw: np.ndarray) -> np.ndarray:
    b = _as_blocks(raw, 22)
    d = _f16(b[:, :2])
    bits = _qh_bits(b, 2)
    qs = b[:, 6:22]
    lo = (qs & 0x0F) | (bits[:, :16] << 4)
    hi = (qs >> 4) | (bits[:, 16:] << 4)
    out = (np.concatenate([lo, hi], axis=1).astype(np.float32) - 16.0) * d
    return out.reshape(-1)


def quantize_q5_0(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float32).reshape(-1, QK)
    idx = np.argmax(np.abs(x), axis=1)
    maxv = x[np.arange(len(x)), idx]
    d = maxv / -16.0
    d16 = d.astype(np.float16)
    id_ = np.where(d16 != 0, 1.0 / d16.astype(np.float32), 0.0)[:, None]
    q = np.clip(_nearest_int(x * id_) + 16, 0, 31).astype(np.uint8)
    out = np.empty((len(x), 22), np.uint8)
    out[:, :2] = _store_f16(d16).reshape(-1, 2)
    bits = ((q >> 4) & 1).astype(np.uint32)
    qh = np.zeros(len(x), np.uint32)
    for j in range(32):
        qh |= bits[:, j] << np.uint32(j)
    out[:, 2:6] = qh.astype("<u4").view(np.uint8).reshape(-1, 4)
    out[:, 6:] = (q[:, :16] & 0x0F) | ((q[:, 16:] & 0x0F) << 4)
    return out.reshape(-1)


# ---------------------------------------------------------------------------
# q5_1: { fp16 d; fp16 m; uint32 qh; uint8 qs[16] } -> x = (nib|bit)*d + m
# ---------------------------------------------------------------------------


def dequantize_q5_1(raw: np.ndarray) -> np.ndarray:
    b = _as_blocks(raw, 24)
    d = _f16(b[:, :2])
    m = _f16(b[:, 2:4])
    bits = _qh_bits(b, 4)
    qs = b[:, 8:24]
    lo = (qs & 0x0F) | (bits[:, :16] << 4)
    hi = (qs >> 4) | (bits[:, 16:] << 4)
    out = np.concatenate([lo, hi], axis=1).astype(np.float32) * d + m
    return out.reshape(-1)


def quantize_q5_1(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float32).reshape(-1, QK)
    mn = x.min(axis=1)
    mx = x.max(axis=1)
    d = (mx - mn) / 31.0
    d16 = d.astype(np.float16)
    m16 = mn.astype(np.float16)
    id_ = np.where(d16 != 0, 1.0 / d16.astype(np.float32), 0.0)[:, None]
    q = np.clip(_nearest_int((x - m16.astype(np.float32)[:, None]) * id_), 0, 31).astype(np.uint8)
    out = np.empty((len(x), 24), np.uint8)
    out[:, 0:2] = _store_f16(d16).reshape(-1, 2)
    out[:, 2:4] = _store_f16(m16).reshape(-1, 2)
    bits = ((q >> 4) & 1).astype(np.uint32)
    qh = np.zeros(len(x), np.uint32)
    for j in range(32):
        qh |= bits[:, j] << np.uint32(j)
    out[:, 4:8] = qh.astype("<u4").view(np.uint8).reshape(-1, 4)
    out[:, 8:] = (q[:, :16] & 0x0F) | ((q[:, 16:] & 0x0F) << 4)
    return out.reshape(-1)


# ---------------------------------------------------------------------------
# q8_0: { fp16 d; int8 qs[32] }
# ---------------------------------------------------------------------------


def dequantize_q8_0(raw: np.ndarray) -> np.ndarray:
    b = _as_blocks(raw, 34)
    d = _f16(b[:, :2])
    qs = b[:, 2:34].view(np.int8).astype(np.float32)
    return (qs * d).reshape(-1)


def quantize_q8_0(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float32).reshape(-1, QK)
    amax = np.abs(x).max(axis=1)
    d = amax / 127.0
    d16 = d.astype(np.float16)
    id_ = np.where(d16 != 0, 1.0 / d16.astype(np.float32), 0.0)[:, None]
    q = np.clip(_nearest_int(x * id_), -128, 127).astype(np.int8)
    out = np.empty((len(x), 34), np.uint8)
    out[:, :2] = _store_f16(d16).reshape(-1, 2)
    out[:, 2:] = q.view(np.uint8)
    return out.reshape(-1)


# ---------------------------------------------------------------------------
# q8_1: { fp32 d; fp32 s; int8 qs[32] }   (s = d * sum(qs)), 40 bytes
# ---------------------------------------------------------------------------


def dequantize_q8_1(raw: np.ndarray) -> np.ndarray:
    b = _as_blocks(raw, 40)
    d = b[:, :4].copy().view("<f4")
    qs = b[:, 8:40].view(np.int8).astype(np.float32)
    return (qs * d).reshape(-1)


def quantize_q8_1(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float32).reshape(-1, QK)
    amax = np.abs(x).max(axis=1)
    d = (amax / 127.0).astype(np.float32)
    id_ = np.where(d != 0, 1.0 / d, 0.0)[:, None]
    q = np.clip(_nearest_int(x * id_), -128, 127).astype(np.int8)
    s = (d * q.sum(axis=1)).astype(np.float32)
    out = np.empty((len(x), 40), np.uint8)
    out[:, 0:4] = d.view(np.uint8).reshape(-1, 4)
    out[:, 4:8] = s.view(np.uint8).reshape(-1, 4)
    out[:, 8:] = q.view(np.uint8)
    return out.reshape(-1)


# ---------------------------------------------------------------------------
# q2_K: { uint8 scales[16]; uint8 qs[64]; fp16 d; fp16 dmin }
# 16 groups of 16; scales byte: low nibble = scale, high nibble = min.
# element (half, j, l<32): q = (qs[32*half + l] >> 2j) & 3,
# group = half*8 + 2j + (l>=16)
# ---------------------------------------------------------------------------


def _q2k_expand_qs(qs: np.ndarray) -> np.ndarray:
    """[nb, 64] packed 2-bit -> [nb, 256] ints in ggml decode order."""
    nb = qs.shape[0]
    out = np.empty((nb, 256), np.uint8)
    for half in range(2):
        chunk = qs[:, 32 * half : 32 * half + 32]
        for j in range(4):
            out[:, 128 * half + 32 * j : 128 * half + 32 * (j + 1)] = (chunk >> (2 * j)) & 3
    return out


def dequantize_q2_k(raw: np.ndarray) -> np.ndarray:
    b = _as_blocks(raw, 84)
    scales = b[:, :16]
    qs = b[:, 16:80]
    d = _f16(b[:, 80:82])
    dmin = _f16(b[:, 82:84])
    q = _q2k_expand_qs(qs).astype(np.float32)  # [nb, 256]
    sc = (scales & 0x0F).astype(np.float32)  # [nb, 16]
    mn = (scales >> 4).astype(np.float32)
    sc_full = np.repeat(sc, 16, axis=1)
    mn_full = np.repeat(mn, 16, axis=1)
    out = d * sc_full * q - dmin * mn_full
    return out.reshape(-1)


def quantize_q2_k(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float32).reshape(-1, QK_K)
    nb = len(x)
    g = x.reshape(nb, 16, 16)
    gmin = np.minimum(g.min(axis=2), 0.0)
    gmax = np.maximum(g.max(axis=2), 0.0)
    gscale = (gmax - gmin) / 3.0  # per-group scale for 2-bit
    max_scale = gscale.max(axis=1)
    max_min = (-gmin).max(axis=1)
    d = (max_scale / 15.0).astype(np.float16)
    dmin = (max_min / 15.0).astype(np.float16)
    df = d.astype(np.float32)
    dmf = dmin.astype(np.float32)
    inv_d = np.where(df > 0, 1.0 / df, 0.0)
    inv_m = np.where(dmf > 0, 1.0 / dmf, 0.0)
    Ls = np.clip(_nearest_int(gscale * inv_d[:, None]), 0, 15).astype(np.uint8)
    Lm = np.clip(_nearest_int(-gmin * inv_m[:, None]), 0, 15).astype(np.uint8)
    scales = Ls | (Lm << 4)
    eff_d = df[:, None] * Ls  # [nb,16]
    eff_m = dmf[:, None] * Lm
    inv_eff = np.where(eff_d > 0, 1.0 / eff_d, 0.0)
    q = np.clip(_nearest_int((g + eff_m[:, :, None]) * inv_eff[:, :, None]), 0, 3).astype(np.uint8)
    q = q.reshape(nb, 256)
    # pack in decode order
    qs = np.zeros((nb, 64), np.uint8)
    for half in range(2):
        for j in range(4):
            qs[:, 32 * half : 32 * half + 32] |= (
                q[:, 128 * half + 32 * j : 128 * half + 32 * (j + 1)] << (2 * j)
            )
    out = np.empty((nb, 84), np.uint8)
    out[:, :16] = scales
    out[:, 16:80] = qs
    out[:, 80:82] = _store_f16(d).reshape(-1, 2)
    out[:, 82:84] = _store_f16(dmin).reshape(-1, 2)
    return out.reshape(-1)


# ---------------------------------------------------------------------------
# q3_K: { uint8 hmask[32]; uint8 qs[64]; uint8 scales[12]; fp16 d }
# 16 groups of 16, 6-bit scales (offset by 32), elements are 2-bit quants
# plus a high bit from hmask; missing high bit subtracts 4.
# ---------------------------------------------------------------------------


def _q3k_unpack_scales(scales: np.ndarray) -> np.ndarray:
    """[nb, 12] packed -> [nb, 16] int (0..63), ggml kmask unpacking."""
    aux = scales.copy().view("<u4")  # [nb, 3]
    a0, a1, tmp = aux[:, 0], aux[:, 1], aux[:, 2]
    kmask1 = np.uint32(0x03030303)
    kmask2 = np.uint32(0x0F0F0F0F)
    n0 = (a0 & kmask2) | (((tmp >> 0) & kmask1) << 4)
    n1 = (a1 & kmask2) | (((tmp >> 2) & kmask1) << 4)
    n2 = ((a0 >> 4) & kmask2) | (((tmp >> 4) & kmask1) << 4)
    n3 = ((a1 >> 4) & kmask2) | (((tmp >> 6) & kmask1) << 4)
    packed = np.stack([n0, n1, n2, n3], axis=1).astype("<u4")  # [nb, 4]
    return packed.view(np.uint8).reshape(-1, 16).astype(np.int32)


def _q3k_pack_scales(sc: np.ndarray) -> np.ndarray:
    """[nb, 16] ints 0..63 -> [nb, 12] packed (inverse of unpack)."""
    nb = sc.shape[0]
    lo = (sc & 0x0F).astype(np.uint8).reshape(nb, 4, 4)  # words n0..n3
    hi = ((sc >> 4) & 0x03).astype(np.uint8).reshape(nb, 4, 4)
    out = np.zeros((nb, 12), np.uint8)
    # n0 occupies aux[0] low nibbles, n2 aux[0] high nibbles
    out[:, 0:4] = lo[:, 0] | (lo[:, 2] << 4)
    out[:, 4:8] = lo[:, 1] | (lo[:, 3] << 4)
    out[:, 8:12] = hi[:, 0] | (hi[:, 1] << 2) | (hi[:, 2] << 4) | (hi[:, 3] << 6)
    return out


def dequantize_q3_k(raw: np.ndarray) -> np.ndarray:
    b = _as_blocks(raw, 110)
    hmask = b[:, :32]
    qs = b[:, 32:96]
    scales = _q3k_unpack_scales(b[:, 96:108]) - 32  # [nb, 16]
    d = _f16(b[:, 108:110])
    q2 = _q3k_expand_qs(qs)  # [nb, 256] values 0..3
    hbit = _q3k_expand_hmask(hmask)  # [nb, 256] values {0,1}
    q = q2.astype(np.int32) - np.where(hbit > 0, 0, 4)
    sc_full = np.repeat(scales, 16, axis=1).astype(np.float32)
    out = d * sc_full * q.astype(np.float32)
    return out.reshape(-1)


def _q3k_expand_qs(qs: np.ndarray) -> np.ndarray:
    nb = qs.shape[0]
    out = np.empty((nb, 256), np.uint8)
    for half in range(2):
        chunk = qs[:, 32 * half : 32 * half + 32]
        for j in range(4):
            out[:, 128 * half + 32 * j : 128 * half + 32 * (j + 1)] = (chunk >> (2 * j)) & 3
    return out


def _q3k_expand_hmask(hmask: np.ndarray) -> np.ndarray:
    nb = hmask.shape[0]
    out = np.empty((nb, 256), np.uint8)
    for half in range(2):
        for j in range(4):
            bit = half * 4 + j
            out[:, 128 * half + 32 * j : 128 * half + 32 * (j + 1)] = (hmask >> bit) & 1
    return out


def quantize_q3_k(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float32).reshape(-1, QK_K)
    nb = len(x)
    g = x.reshape(nb, 16, 16)
    amax = np.abs(g).max(axis=2)  # [nb,16]
    gscale = amax / 4.0  # symmetric 3-bit: q in [-4, 3]
    max_scale = gscale.max(axis=1)
    d = np.where(max_scale > 0, max_scale / 31.0, 0).astype(np.float16)
    df = d.astype(np.float32)
    inv_d = np.where(df > 0, 1.0 / df, 0.0)
    # decode subtracts 32 from the stored 6-bit scale, so encode adds it
    sc6 = np.clip(_nearest_int(gscale * inv_d[:, None]) + 32, 0, 63).astype(np.int32)
    eff = df[:, None] * (sc6 - 32)
    inv_eff = np.where(eff != 0, 1.0 / eff, 0.0)
    q = np.clip(_nearest_int(g * inv_eff[:, :, None]), -4, 3).astype(np.int32) + 4  # 0..7
    q = q.reshape(nb, 256)
    hbit = (q >> 2).astype(np.uint8)
    q2 = (q & 3).astype(np.uint8)
    qs = np.zeros((nb, 64), np.uint8)
    hm = np.zeros((nb, 32), np.uint8)
    for half in range(2):
        for j in range(4):
            seg = slice(128 * half + 32 * j, 128 * half + 32 * (j + 1))
            qs[:, 32 * half : 32 * half + 32] |= q2[:, seg] << (2 * j)
            hm |= hbit[:, seg] << (half * 4 + j)
    out = np.empty((nb, 110), np.uint8)
    out[:, :32] = hm
    out[:, 32:96] = qs
    out[:, 96:108] = _q3k_pack_scales(sc6)
    out[:, 108:110] = _store_f16(d).reshape(-1, 2)
    return out.reshape(-1)


# ---------------------------------------------------------------------------
# q4_K / q5_K shared 6-bit scale/min packing: 12 bytes -> 8 (scale, min) pairs
# get_scale_min_k4 (k-quants at master-31cfbb1)
# ---------------------------------------------------------------------------


def _k4_unpack_scales(sb: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """[nb, 12] -> (sc [nb, 8], mn [nb, 8]) ints."""
    sb = sb.astype(np.int32)
    sc = np.empty((sb.shape[0], 8), np.int32)
    mn = np.empty((sb.shape[0], 8), np.int32)
    for j in range(4):
        sc[:, j] = sb[:, j] & 63
        mn[:, j] = sb[:, j + 4] & 63
    for j in range(4, 8):
        sc[:, j] = (sb[:, j + 4] & 0x0F) | ((sb[:, j - 4] >> 6) << 4)
        mn[:, j] = (sb[:, j + 4] >> 4) | ((sb[:, j] >> 6) << 4)
    return sc, mn


def _k4_pack_scales(sc: np.ndarray, mn: np.ndarray) -> np.ndarray:
    """(sc [nb,8], mn [nb,8]) ints 0..63 -> [nb,12] packed."""
    nb = sc.shape[0]
    out = np.zeros((nb, 12), np.uint8)
    for j in range(4):
        out[:, j] = (sc[:, j] & 63) | ((sc[:, j + 4] >> 4) << 6)
        out[:, j + 4] = (mn[:, j] & 63) | ((mn[:, j + 4] >> 4) << 6)
        out[:, j + 8] = (sc[:, j + 4] & 0x0F) | ((mn[:, j + 4] & 0x0F) << 4)
    return out


# ---------------------------------------------------------------------------
# q4_K: { fp16 d; fp16 dmin; uint8 scales[12]; uint8 qs[128] }
# 8 groups of 32; chunk j (64 elems): group 2j = low nibbles of qs[32j:32j+32],
# group 2j+1 = high nibbles.
# ---------------------------------------------------------------------------


def dequantize_q4_k(raw: np.ndarray) -> np.ndarray:
    b = _as_blocks(raw, 144)
    d = _f16(b[:, 0:2])
    dmin = _f16(b[:, 2:4])
    sc, mn = _k4_unpack_scales(b[:, 4:16])
    qs = b[:, 16:144]
    nb = len(b)
    out = np.empty((nb, 256), np.float32)
    for j in range(4):
        chunk = qs[:, 32 * j : 32 * j + 32]
        d1 = d * sc[:, 2 * j : 2 * j + 1]
        m1 = dmin * mn[:, 2 * j : 2 * j + 1]
        d2 = d * sc[:, 2 * j + 1 : 2 * j + 2]
        m2 = dmin * mn[:, 2 * j + 1 : 2 * j + 2]
        out[:, 64 * j : 64 * j + 32] = (chunk & 0x0F).astype(np.float32) * d1 - m1
        out[:, 64 * j + 32 : 64 * j + 64] = (chunk >> 4).astype(np.float32) * d2 - m2
    return out.reshape(-1)


def _k_group_scales(x: np.ndarray, nbits: int) -> tuple:
    """Shared RTN scale/min selection for q4_k/q5_k: per-32-group affine."""
    nb = len(x)
    g = x.reshape(nb, 8, 32)
    gmin = np.minimum(g.min(axis=2), 0.0)
    gmax = np.maximum(g.max(axis=2), 0.0)
    qmax = (1 << nbits) - 1
    gscale = (gmax - gmin) / qmax
    max_scale = gscale.max(axis=1)
    max_min = (-gmin).max(axis=1)
    d = (max_scale / 63.0).astype(np.float16)
    dmin = (max_min / 63.0).astype(np.float16)
    df, dmf = d.astype(np.float32), dmin.astype(np.float32)
    inv_d = np.where(df > 0, 1.0 / df, 0.0)
    inv_m = np.where(dmf > 0, 1.0 / dmf, 0.0)
    sc = np.clip(_nearest_int(gscale * inv_d[:, None]), 0, 63)
    mn = np.clip(_nearest_int(-gmin * inv_m[:, None]), 0, 63)
    eff_d = df[:, None] * sc
    eff_m = dmf[:, None] * mn
    inv_eff = np.where(eff_d > 0, 1.0 / eff_d, 0.0)
    q = np.clip(_nearest_int((g + eff_m[:, :, None]) * inv_eff[:, :, None]), 0, qmax)
    return d, dmin, sc, mn, q.reshape(nb, 256).astype(np.uint8)


def quantize_q4_k(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float32).reshape(-1, QK_K)
    nb = len(x)
    d, dmin, sc, mn, q = _k_group_scales(x, 4)
    qs = np.zeros((nb, 128), np.uint8)
    for j in range(4):
        qs[:, 32 * j : 32 * j + 32] = q[:, 64 * j : 64 * j + 32] | (
            q[:, 64 * j + 32 : 64 * j + 64] << 4
        )
    out = np.empty((nb, 144), np.uint8)
    out[:, 0:2] = _store_f16(d).reshape(-1, 2)
    out[:, 2:4] = _store_f16(dmin).reshape(-1, 2)
    out[:, 4:16] = _k4_pack_scales(sc, mn)
    out[:, 16:] = qs
    return out.reshape(-1)


# ---------------------------------------------------------------------------
# q5_K: { fp16 d; fp16 dmin; uint8 scales[12]; uint8 qh[32]; uint8 qs[128] }
# like q4_K plus a 5th bit: chunk j uses qh bits (2j) for low nibbles and
# (2j+1) for high nibbles.
# ---------------------------------------------------------------------------


def dequantize_q5_k(raw: np.ndarray) -> np.ndarray:
    b = _as_blocks(raw, 176)
    d = _f16(b[:, 0:2])
    dmin = _f16(b[:, 2:4])
    sc, mn = _k4_unpack_scales(b[:, 4:16])
    qh = b[:, 16:48]
    qs = b[:, 48:176]
    nb = len(b)
    out = np.empty((nb, 256), np.float32)
    for j in range(4):
        chunk = qs[:, 32 * j : 32 * j + 32]
        hb1 = (qh >> (2 * j)) & 1
        hb2 = (qh >> (2 * j + 1)) & 1
        q1 = (chunk & 0x0F) + (hb1 << 4)
        q2 = (chunk >> 4) + (hb2 << 4)
        d1 = d * sc[:, 2 * j : 2 * j + 1]
        m1 = dmin * mn[:, 2 * j : 2 * j + 1]
        d2 = d * sc[:, 2 * j + 1 : 2 * j + 2]
        m2 = dmin * mn[:, 2 * j + 1 : 2 * j + 2]
        out[:, 64 * j : 64 * j + 32] = q1.astype(np.float32) * d1 - m1
        out[:, 64 * j + 32 : 64 * j + 64] = q2.astype(np.float32) * d2 - m2
    return out.reshape(-1)


def quantize_q5_k(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float32).reshape(-1, QK_K)
    nb = len(x)
    d, dmin, sc, mn, q = _k_group_scales(x, 5)
    qs = np.zeros((nb, 128), np.uint8)
    qh = np.zeros((nb, 32), np.uint8)
    for j in range(4):
        q1 = q[:, 64 * j : 64 * j + 32]
        q2 = q[:, 64 * j + 32 : 64 * j + 64]
        qs[:, 32 * j : 32 * j + 32] = (q1 & 0x0F) | ((q2 & 0x0F) << 4)
        qh |= ((q1 >> 4) << (2 * j)) | ((q2 >> 4) << (2 * j + 1))
    out = np.empty((nb, 176), np.uint8)
    out[:, 0:2] = _store_f16(d).reshape(-1, 2)
    out[:, 2:4] = _store_f16(dmin).reshape(-1, 2)
    out[:, 4:16] = _k4_pack_scales(sc, mn)
    out[:, 16:48] = qh
    out[:, 48:] = qs
    return out.reshape(-1)


# ---------------------------------------------------------------------------
# q6_K: { uint8 ql[128]; uint8 qh[64]; int8 scales[16]; fp16 d }
# 16 groups of 16; per 128-half (ql 64B, qh 32B):
#   y[l]    = (ql[l]&0xF  | ((qh[l]>>0)&3)<<4) - 32, scale group is+0
#   y[l+32] = (ql[l+32]&0xF | ((qh[l]>>2)&3)<<4) - 32, group is+2
#   y[l+64] = (ql[l]>>4   | ((qh[l]>>4)&3)<<4) - 32, group is+4
#   y[l+96] = (ql[l+32]>>4 | ((qh[l]>>6)&3)<<4) - 32, group is+6  (is = l/16)
# ---------------------------------------------------------------------------


def dequantize_q6_k(raw: np.ndarray) -> np.ndarray:
    b = _as_blocks(raw, 210)
    ql = b[:, :128]
    qh = b[:, 128:192]
    scales = b[:, 192:208].view(np.int8).astype(np.float32)  # [nb, 16]
    d = _f16(b[:, 208:210])
    nb = len(b)
    q = np.empty((nb, 256), np.int32)
    for half in range(2):
        l_ = ql[:, 64 * half : 64 * half + 64]
        h_ = qh[:, 32 * half : 32 * half + 32]
        base = 128 * half
        q[:, base + 0 : base + 32] = (l_[:, :32] & 0x0F) | (((h_ >> 0) & 3) << 4)
        q[:, base + 32 : base + 64] = (l_[:, 32:] & 0x0F) | (((h_ >> 2) & 3) << 4)
        q[:, base + 64 : base + 96] = (l_[:, :32] >> 4) | (((h_ >> 4) & 3) << 4)
        q[:, base + 96 : base + 128] = (l_[:, 32:] >> 4) | (((h_ >> 6) & 3) << 4)
    q -= 32
    sc_full = np.repeat(scales, 16, axis=1)
    out = d * sc_full * q.astype(np.float32)
    return out.reshape(-1)


def quantize_q6_k(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float32).reshape(-1, QK_K)
    nb = len(x)
    g = x.reshape(nb, 16, 16)
    amax = np.abs(g).max(axis=2)
    gscale = amax / 32.0  # q in [-32, 31]
    max_scale = gscale.max(axis=1)
    d = np.where(max_scale > 0, max_scale / 127.0, 0).astype(np.float16)
    df = d.astype(np.float32)
    inv_d = np.where(df > 0, 1.0 / df, 0.0)
    sc = np.clip(_nearest_int(gscale * inv_d[:, None]), -128, 127).astype(np.int8)
    eff = df[:, None] * sc.astype(np.float32)
    inv_eff = np.where(eff != 0, 1.0 / eff, 0.0)
    q = np.clip(_nearest_int(g * inv_eff[:, :, None]), -32, 31).astype(np.int32) + 32
    q = q.reshape(nb, 256)
    ql = np.zeros((nb, 128), np.uint8)
    qh = np.zeros((nb, 64), np.uint8)
    for half in range(2):
        base = 128 * half
        q0 = q[:, base : base + 32]
        q1 = q[:, base + 32 : base + 64]
        q2 = q[:, base + 64 : base + 96]
        q3 = q[:, base + 96 : base + 128]
        ql[:, 64 * half : 64 * half + 32] = (q0 & 0x0F) | ((q2 & 0x0F) << 4)
        ql[:, 64 * half + 32 : 64 * half + 64] = (q1 & 0x0F) | ((q3 & 0x0F) << 4)
        qh[:, 32 * half : 32 * half + 32] = (
            (q0 >> 4) | ((q1 >> 4) << 2) | ((q2 >> 4) << 4) | ((q3 >> 4) << 6)
        )
    out = np.empty((nb, 210), np.uint8)
    out[:, :128] = ql
    out[:, 128:192] = qh
    out[:, 192:208] = sc.view(np.uint8)
    out[:, 208:210] = _store_f16(d).reshape(-1, 2)
    return out.reshape(-1)


# ---------------------------------------------------------------------------
# q8_K: { float d; int8 qs[256]; int16 bsums[16] }
# ---------------------------------------------------------------------------


def dequantize_q8_k(raw: np.ndarray) -> np.ndarray:
    b = _as_blocks(raw, 292)
    d = b[:, :4].copy().view("<f4")
    qs = b[:, 4:260].view(np.int8).astype(np.float32)
    return (qs * d).reshape(-1)


def quantize_q8_k(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float32).reshape(-1, QK_K)
    amax = np.abs(x).max(axis=1)
    # ggml uses d = amax/127 stored as float (inverted scale internally)
    d = np.where(amax > 0, amax / 127.0, 0.0).astype(np.float32)
    inv = np.where(d > 0, 1.0 / d, 0.0)[:, None]
    q = np.clip(_nearest_int(x * inv), -128, 127).astype(np.int8)
    bsums = q.reshape(-1, 16, 16).sum(axis=2).astype("<i2")
    out = np.empty((len(x), 292), np.uint8)
    out[:, 0:4] = d.view(np.uint8).reshape(-1, 4)
    out[:, 4:260] = q.view(np.uint8)
    out[:, 260:292] = bsums.view(np.uint8).reshape(-1, 32)
    return out.reshape(-1)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

_DEQUANT = {
    DataType.Q4_0: dequantize_q4_0,
    DataType.Q4_1: dequantize_q4_1,
    DataType.Q5_0: dequantize_q5_0,
    DataType.Q5_1: dequantize_q5_1,
    DataType.Q8_0: dequantize_q8_0,
    DataType.Q8_1: dequantize_q8_1,
    DataType.Q2_K: dequantize_q2_k,
    DataType.Q3_K: dequantize_q3_k,
    DataType.Q4_K: dequantize_q4_k,
    DataType.Q5_K: dequantize_q5_k,
    DataType.Q6_K: dequantize_q6_k,
    DataType.Q8_K: dequantize_q8_k,
}

_QUANT = {
    DataType.Q4_0: quantize_q4_0,
    DataType.Q4_1: quantize_q4_1,
    DataType.Q5_0: quantize_q5_0,
    DataType.Q5_1: quantize_q5_1,
    DataType.Q8_0: quantize_q8_0,
    DataType.Q8_1: quantize_q8_1,
    DataType.Q2_K: quantize_q2_k,
    DataType.Q3_K: quantize_q3_k,
    DataType.Q4_K: quantize_q4_k,
    DataType.Q5_K: quantize_q5_k,
    DataType.Q6_K: quantize_q6_k,
    DataType.Q8_K: quantize_q8_k,
}


def dequantize(raw: np.ndarray, dtype: DataType) -> np.ndarray:
    """Packed bytes -> float32 payload."""
    dtype = DataType(dtype)
    if dtype == DataType.F32:
        return np.ascontiguousarray(raw).view("<f4").copy()
    if dtype == DataType.F16:
        return np.ascontiguousarray(raw).view("<f2").astype(np.float32)
    if dtype == DataType.I32:
        return np.ascontiguousarray(raw).view("<i4").astype(np.float32)
    if dtype == DataType.L64:
        return np.ascontiguousarray(raw).view("<i8").astype(np.float32)
    return _DEQUANT[dtype](raw)


def quantize(x: np.ndarray, dtype: DataType) -> np.ndarray:
    """float32 payload -> packed bytes."""
    dtype = DataType(dtype)
    x = np.asarray(x, np.float32).reshape(-1)
    if dtype == DataType.F32:
        return x.astype("<f4").view(np.uint8)
    if dtype == DataType.F16:
        return x.astype("<f2").view(np.uint8)
    return _QUANT[dtype](x)


def supported_quant_types() -> list[DataType]:
    return sorted(_DEQUANT.keys())


def dequantize_rows(raw: np.ndarray, dtype: DataType, shape: tuple[int, ...]) -> np.ndarray:
    """Decode a packed 2-D tensor to float32 with the given logical shape."""
    flat = dequantize(raw, dtype)
    n = int(np.prod(shape))
    if flat.size != n:
        raise ValueError(f"decoded {flat.size} elements, expected {n} for shape {shape}")
    return flat.reshape(shape)
