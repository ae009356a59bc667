"""Group-quant weights and their matmuls ("gq").

Counterpart of ``minigpt4_tpu/ops/group_i8.py``.  A :class:`GroupQuant`
holds the raw ggml codes of a weight plus two per-group planes, so the
logical weight is

    W[n, k] = A[g, n] * q[n, k] + B[g, n],   g = k // group_size

in one of two plane modes:

* exact (q4_k/q5_k, group size 32): the integer sub-scales are kept raw,
  sc6/mn6 u8 ``[(L,) G, N]`` and superblock scales d/dmin f32
  ``[(L,) S, N]`` (S = K // 256), and ``A = d[s] * sc6[g]``,
  ``B = -dmin[s] * mn6[g]`` are rebuilt bit-exactly (an f16 scale times a
  6-bit integer is exact in f32);
* generic (q4_0, q4_1, q5_0, q5_1, q8_0 with group size 32; q2_k, q3_k,
  q6_k with group size 16): A and B are bf16 planes a/b ``[(L,) G, N]``,
  the f32 ggml scale and negated min rounded to nearest even (zero offsets
  of the unsigned formats are folded into B, q8_0 keeps signed codes).

Codes are stored in one of four ``packing`` modes:

* ``"none"``: i8 ``[(L,) N, K]``, one byte per weight;
* ``"p4"`` (q4_0, q4_1, q4_k): u8 ``[(L,) N, K/2]`` nibble pairs along K,
  byte (n, j) = q[n, 2j] | q[n, 2j+1] << 4 (0.5 B per weight);
* ``"p5"`` (q5_0, q5_1, q5_k): the nibbles plus ``hi`` i32 ``[(L,) N, K/32]``,
  bit b of word w is bit 4 of q[n, 32w + b] (0.625 B per weight);
* ``"p6"`` (q6_k): the nibbles plus ``hi`` i32 ``[(L,) N, K/16]``, bits
  2b+1:2b of word w are bits 5:4 of q[n, 16w + b] (0.75 B per weight).

This is the K-order layout of ``ops/repack.py`` (:func:`pack_nibbles` forms
both), not the JAX package's chunk-local one: it carries the same bytes per
weight, a 16-code run is one 8-byte load plus one high-bit word, and no K
needs padding (``interop.group_quant_from_numpy`` converts JAX's layout).
:func:`pack_enabled` reads the packing choice (``params.resolve_gq_pack``
settles it once per engine and the loaders take it as a bool),
:func:`pack_codes` packs; q2_k, q3_k and q8_0 stay one byte per code, as in
the JAX package.

Four hand-written CUDA kernels compute ``x @ W.T``:

* :func:`gq_decode` / :func:`gq_decode_generic` (``csrc/gq_decode.cu``,
  ``csrc/gq_decode_i8.cuh``) for at most ``GQ_MAX_M`` rows: the function of
  the JAX package's decode kernels, x split into two i8 planes
  ``x ~= s1 x1 + s2 x2`` (:func:`split_activations`), exact i32 group dot
  products of the codes with x1 and x2, and per group
  ``(c1 s1 + c2 s2) A + sgt B`` in f32 with ``sgt`` the group sums of the
  true x (:func:`group_sums`); the split runs inside the launch;
* :func:`gq_prefill` / :func:`gq_prefill_generic` (``csrc/gq_prefill.cu``)
  for more rows, with x and the dequantized W rounded to bf16 and f32
  accumulation on the tensor cores (``csrc/qmm_prefill.cuh``, its launch plan
  and workspace in :mod:`.qmm_prefill`).

Each entry takes the weight's code storage as ``hi_bits`` (-1 for i8
codes, else the packing's high bits per code): a packed code reaches the
same arithmetic as the same float, so packed and unpacked weights give the
same bits.  A wrapper counts its unpacked launches in ``launches`` and its
packed ones in ``packed_launches[packing]``.

Beside them are the plain PyTorch versions (:func:`qmatmul_decode_ref`, the
dual-i8 function step by step; :func:`qmatmul_prefill_ref`), which cover
both plane modes and every packing.  A wrapper
takes the plain version only for tensors on the CPU; for CUDA tensors it
launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
import os
from dataclasses import dataclass, fields

import numpy as np
import torch

from ..formats import DataType
from . import _build, qmm_prefill

J = 8  # groups per chunk; K must be a multiple of J * group_size
EXACT_PLANE = frozenset({DataType.Q4_K, DataType.Q5_K})
GS16 = frozenset({DataType.Q2_K, DataType.Q3_K, DataType.Q6_K})
# ggml block bytes of every format gq decodes (repack.REPACKABLE of the JAX package)
BLOCK_BYTES = {DataType.Q4_0: 18, DataType.Q4_1: 20, DataType.Q5_0: 22, DataType.Q5_1: 24,
               DataType.Q8_0: 34, DataType.Q2_K: 84, DataType.Q3_K: 110, DataType.Q4_K: 144,
               DataType.Q5_K: 176, DataType.Q6_K: 210}
REPACKABLE = frozenset(BLOCK_BYTES)
# formats whose codes fit 4 / 5 / 6 bits (the JAX package's PACK4/5/6)
PACK4 = frozenset({DataType.Q4_0, DataType.Q4_1, DataType.Q4_K})
PACK5 = frozenset({DataType.Q5_0, DataType.Q5_1, DataType.Q5_K})
PACK6 = frozenset({DataType.Q6_K})
# high-bit planes per packing: i32 words along K hold 32 // HI_BITS codes'
# high bits, so ``hi`` is [(L,) N, K * HI_BITS / 32] (the JAX package's HB_DIV)
HI_BITS = {"none": 0, "p4": 0, "p5": 1, "p6": 2}
# M <= GQ_MAX_M rides the decode kernels; larger M the prefill kernels
GQ_MAX_M = 8


def group_size(dtype: DataType) -> int:
    return 16 if DataType(dtype) in GS16 else 32


@dataclass
class GroupQuant:
    """Group-quant weight, logically ``[(L,) N, K]``; see the module docstring.
    Exact mode fills sc6/mn6/d/dmin, generic mode a/b."""

    codes: torch.Tensor  # i8 [(L,) N, K]
    dtype: DataType
    n_in: int
    group_size: int = 32
    sc6: torch.Tensor | None = None  # u8 [(L,) G, N]
    mn6: torch.Tensor | None = None  # u8 [(L,) G, N]
    d: torch.Tensor | None = None  # f32 [(L,) S, N]
    dmin: torch.Tensor | None = None  # f32 [(L,) S, N]
    a: torch.Tensor | None = None  # bf16 [(L,) G, N]
    b: torch.Tensor | None = None  # bf16 [(L,) G, N]
    hi: torch.Tensor | None = None  # i32 [(L,) N, K/32] (p5) or [(L,) N, K/16] (p6)
    packing: str = "none"  # none | p4 | p5 | p6

    @property
    def exact(self) -> bool:
        return self.sc6 is not None

    @property
    def n_out(self) -> int:
        return self.codes.shape[-2]

    @property
    def stacked(self) -> bool:
        return self.codes.dim() == 3

    def tensors(self) -> dict[str, torch.Tensor]:
        return {f.name: getattr(self, f.name) for f in fields(self)
                if isinstance(getattr(self, f.name), torch.Tensor)}

    def _replace(self, **ts) -> "GroupQuant":
        return GroupQuant(**ts, dtype=self.dtype, n_in=self.n_in, group_size=self.group_size,
                          packing=self.packing)

    def layer(self, li: int) -> "GroupQuant":
        """One layer of a stacked weight (views, no copy)."""
        return self._replace(**{k: v[li] for k, v in self.tensors().items()})

    def planes(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Per-group (A, B) ``[..., G, N]`` in f32."""
        if self.exact:
            a = torch.repeat_interleave(self.d, J, dim=-2) * self.sc6.float()
            b = -torch.repeat_interleave(self.dmin, J, dim=-2) * self.mn6.float()
            return a, b
        return self.a.float(), self.b.float()

    def codes_int(self) -> torch.Tensor:
        """The logical codes ``[(L,) N, K]`` whatever the packing (i8 stored,
        i32 reassembled from nibbles and high bits)."""
        if self.packing == "none":
            return self.codes
        return unpack_nibbles(self.codes, self.hi, HI_BITS[self.packing])

    def dequantize(self) -> torch.Tensor:
        """[..., N, K] f32: ``codes * A + B`` with the planes expanded."""
        a, b = self.planes()
        a = torch.repeat_interleave(a.transpose(-1, -2), self.group_size, dim=-1)
        b = torch.repeat_interleave(b.transpose(-1, -2), self.group_size, dim=-1)
        return self.codes_int().float() * a + b


def _form(w: GroupQuant) -> tuple:
    return (w.dtype, w.n_in, w.group_size, w.exact, w.packing)


def stack(ws: list[GroupQuant]) -> GroupQuant:
    """Per-layer weights -> one weight with a leading L axis."""
    w0 = ws[0]
    if any(_form(w) != _form(w0) for w in ws):
        raise ValueError("stacked GroupQuant layers must share format and K")
    return w0._replace(**{k: torch.stack([w.tensors()[k] for w in ws])
                          for k in w0.tensors()})


def concat_out(ws: list[GroupQuant]) -> GroupQuant:
    """Fuse weights of one input width along the output axis (wq|wk|wv):
    codes and high bits along N (dim -2), every plane along N (dim -1)."""
    w0 = ws[0]
    if any(_form(w) != _form(w0) for w in ws):
        raise ValueError("fused GroupQuant parts must share format and K")
    return w0._replace(**{k: torch.cat([w.tensors()[k] for w in ws],
                                       dim=-2 if k in ("codes", "hi") else -1)
                          for k in w0.tensors()})


def supported(dtype: DataType, k: int) -> bool:
    """The JAX rule: a REPACKABLE format whose K is a multiple of 8 groups."""
    dtype = DataType(dtype)
    return dtype in REPACKABLE and k % (J * group_size(dtype)) == 0


# ---------------------------------------------------------------------------
# sub-byte code storage
# ---------------------------------------------------------------------------


def packing_of(dtype: DataType) -> str:
    """The packing :func:`pack_codes` gives a format ("none" where it keeps
    one byte per code)."""
    d = DataType(dtype)
    return "p4" if d in PACK4 else "p5" if d in PACK5 else "p6" if d in PACK6 else "none"


def packable(dtype: DataType) -> bool:
    """Whether :func:`pack_codes` stores the format's codes in under a byte."""
    return packing_of(dtype) != "none"


def pack_enabled(pack: bool | None = None) -> bool:
    """Whether the loaders store gq codes packed, with the JAX package's
    precedence: the environment variable ``MINIGPT4_TPU_GQ_PACK`` (``"0"``
    is off, anything else on), then the caller's ``pack``, then packed."""
    v = os.environ.get("MINIGPT4_TPU_GQ_PACK")
    if v is not None:
        return v != "0"
    return True if pack is None else bool(pack)


def pack_nibbles(q: torch.Tensor, hi_bits: int) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Codes ``q [..., K]`` (0..63) -> (nibble pairs u8 ``[..., K/2]``, byte j
    = q[2j] | q[2j+1] << 4; high bits i32 ``[..., K * hi_bits / 32]`` or None),
    the K-order layout of ``ops/repack.py`` and of the packed gq codes."""
    q = q.to(torch.uint8)  # 0..63: lossless, and a quarter of i32's bytes
    lo = q & 15
    codes = (lo[..., 0::2] | (lo[..., 1::2] << 4)).contiguous()
    if not hi_bits:
        return codes, None
    per = 32 // hi_bits
    fields = ((q >> 4) & ((1 << hi_bits) - 1)).view(*q.shape[:-1], q.shape[-1] // per, per)
    words = torch.zeros(fields.shape[:-1], dtype=torch.int64, device=q.device)
    for j in range(per):  # disjoint bits: or them in one field at a time
        words |= fields[..., j].to(torch.int64) << (hi_bits * j)
    return codes, words.to(torch.int32).contiguous()  # wraps bit 31 to the sign


def unpack_nibbles(codes: torch.Tensor, hi: torch.Tensor | None, hi_bits: int) -> torch.Tensor:
    """Inverse of :func:`pack_nibbles`: the codes ``[..., K]`` as i32."""
    c = codes.to(torch.int32)
    q = torch.stack([c & 15, c >> 4], dim=-1).reshape(*c.shape[:-1], 2 * c.shape[-1])
    if hi_bits:
        per = 32 // hi_bits
        sh = torch.arange(0, 32, hi_bits, dtype=torch.int32, device=c.device)
        bits = (hi.unsqueeze(-1) >> sh) & ((1 << hi_bits) - 1)
        q = q + (bits.reshape(*hi.shape[:-1], hi.shape[-1] * per) << 4)
    return q


def pack_codes(w: GroupQuant) -> GroupQuant:
    """Sub-byte code storage: i8 codes -> the packing of :func:`packing_of`
    (see the module docstring), on the codes' device, one layer at a time so
    a stacked weight needs no full-size temporaries.  A no-op for packed
    weights and for q2_k, q3_k and q8_0, as in the JAX package; the planes
    are shared, not copied."""
    mode = packing_of(w.dtype)
    if w.packing != "none" or mode == "none":
        return w
    hb = HI_BITS[mode]
    layers = [pack_nibbles(c, hb) for c in (w.codes if w.stacked else [w.codes])]
    codes = [c for c, _ in layers]
    his = [h for _, h in layers]
    planes = {k: v for k, v in w.tensors().items() if k != "codes"}
    return GroupQuant(codes=torch.stack(codes) if w.stacked else codes[0],
                      hi=None if not hb else torch.stack(his) if w.stacked else his[0],
                      dtype=w.dtype, n_in=w.n_in, group_size=w.group_size, packing=mode,
                      **planes)


# ---------------------------------------------------------------------------
# ggml bytes -> GroupQuant, decoded with torch ops on the target device
# ---------------------------------------------------------------------------


def _f16(blk: torch.Tensor, at: int) -> torch.Tensor:
    """The f16 at byte ``at`` of every block [n, nb, bytes] -> f32 [n, nb]."""
    return blk[:, :, at:at + 2].contiguous().view(torch.float16).squeeze(-1).float()


def _unpack_k4_scales(sb: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., 12] packed bytes (i32) -> (sc, mn) [..., 8] 6-bit values."""
    sc = [sb[..., j] & 63 for j in range(4)]
    mn = [sb[..., j + 4] & 63 for j in range(4)]
    sc += [(sb[..., j + 4] & 0x0F) | ((sb[..., j - 4] >> 6) << 4) for j in range(4, 8)]
    mn += [(sb[..., j + 4] >> 4) | ((sb[..., j] >> 6) << 4) for j in range(4, 8)]
    return torch.stack(sc, dim=-1), torch.stack(mn, dim=-1)


def _unpack_q3k_scales(sb: torch.Tensor) -> torch.Tensor:
    """[n, nb, 12] packed bytes -> [n, nb, 16] 6-bit scales (ggml's kmask
    unpacking, done per byte: every mask and shift stays inside a byte)."""
    a0, a1, hi = sb[..., 0:4], sb[..., 4:8], sb[..., 8:12]
    return torch.cat([(a0 & 0x0F) | ((hi & 3) << 4), (a1 & 0x0F) | (((hi >> 2) & 3) << 4),
                      (a0 >> 4) | (((hi >> 4) & 3) << 4), (a1 >> 4) | (((hi >> 6) & 3) << 4)],
                     dim=-1)


def _expand_2bit(qs: torch.Tensor) -> torch.Tensor:
    """q2_k/q3_k low bits [n, nb, 64] -> [n, nb, 256] in ggml decode order:
    element 128 h + 32 j + l is bits 2j+1:2j of byte 32 h + l."""
    n, nb = qs.shape[:2]
    sh = torch.arange(0, 8, 2, dtype=torch.uint8, device=qs.device).view(1, 1, 1, 4, 1)
    return ((qs.view(n, nb, 2, 1, 32) >> sh) & 3).reshape(n, nb, 256)


def _decode_generic(blk: torch.Tensor, dtype: DataType):
    """Blocks [n, nb, bytes] u8 -> (q u8 or i8 [n, nb, per-block K], scales f32
    [n, G], mins f32 [n, G]) with ``w = scales * q - mins`` exactly ggml's
    decode (counterpart of repack._decode_codes_scales)."""
    n, nb = blk.shape[:2]
    if dtype in (DataType.Q4_0, DataType.Q4_1, DataType.Q5_0, DataType.Q5_1):
        off = {DataType.Q4_0: 2, DataType.Q4_1: 4, DataType.Q5_0: 6, DataType.Q5_1: 8}[dtype]
        d = _f16(blk, 0)
        qs = blk[:, :, off:off + 16]
        lo, hi = qs & 0x0F, qs >> 4
        if dtype in (DataType.Q5_0, DataType.Q5_1):
            # bit j of the little-endian u32 qh is the 5th bit of element j
            qh = blk[:, :, off - 4:off]
            sh = torch.arange(8, dtype=torch.uint8, device=blk.device).view(1, 1, 1, 8)
            bits = ((qh.unsqueeze(-1) >> sh) & 1).reshape(n, nb, 32)
            lo, hi = lo | (bits[:, :, :16] << 4), hi | (bits[:, :, 16:] << 4)
        q = torch.cat([lo, hi], dim=2)
        if dtype in (DataType.Q4_1, DataType.Q5_1):
            mins = -_f16(blk, 2)
        else:
            mins = (8.0 if dtype == DataType.Q4_0 else 16.0) * d
        return q, d, mins
    if dtype == DataType.Q8_0:
        d = _f16(blk, 0)
        # signed codes, zero mins
        return blk[:, :, 2:34].contiguous().view(torch.int8), d, torch.zeros_like(d)
    if dtype == DataType.Q2_K:
        q = _expand_2bit(blk[:, :, 16:80])
        scales = _f16(blk, 80).unsqueeze(-1) * (blk[:, :, 0:16] & 0x0F).float()
        mins = _f16(blk, 82).unsqueeze(-1) * (blk[:, :, 0:16] >> 4).float()
        return q, scales.reshape(n, -1), mins.reshape(n, -1)
    if dtype == DataType.Q3_K:
        hmask = blk[:, :, 0:32]
        sh = torch.arange(8, dtype=torch.uint8, device=blk.device).view(1, 1, 2, 4, 1)
        hbit = ((hmask.view(n, nb, 1, 1, 32) >> sh) & 1).reshape(n, nb, 256)
        q = _expand_2bit(blk[:, :, 32:96]) | (hbit << 2)  # 0..7; ggml decodes q - 4
        sc6 = _unpack_q3k_scales(blk[:, :, 96:108]).float()
        scales = _f16(blk, 108).unsqueeze(-1) * (sc6 - 32.0)
        return q, scales.reshape(n, -1), (4.0 * scales).reshape(n, -1)
    if dtype == DataType.Q6_K:
        ql = blk[:, :, 0:128].reshape(n, nb, 2, 64)
        qh = blk[:, :, 128:192].reshape(n, nb, 2, 32)
        l0, l1 = ql[..., :32], ql[..., 32:]
        q = torch.cat([(l0 & 0x0F) | ((qh & 3) << 4), (l1 & 0x0F) | (((qh >> 2) & 3) << 4),
                       (l0 >> 4) | (((qh >> 4) & 3) << 4), (l1 >> 4) | (((qh >> 6) & 3) << 4)],
                      dim=-1)  # [n, nb, 2, 128]: 0..63, ggml decodes q - 32
        sc16 = blk[:, :, 192:208].contiguous().view(torch.int8).float()
        scales = _f16(blk, 208).unsqueeze(-1) * sc16
        return q, scales.reshape(n, -1), (32.0 * scales).reshape(n, -1)
    raise ValueError(f"no gq decoding for {dtype.name}")


def _decode_k4(blk: torch.Tensor, dtype: DataType):
    """q4_k/q5_k blocks [n, nb, bytes] -> (q [n, nb, 4, 2, 32] in ggml decode
    order, d and dmin f32 [n, nb], 6-bit sub-scales sc and mins mn [n, nb, 8])
    with ``w = d * sc * q - dmin * mn`` per group of 32."""
    n, nb = blk.shape[:2]
    sc, mn = _unpack_k4_scales(blk[:, :, 4:16].to(torch.int32))
    if dtype == DataType.Q4_K:
        qs = blk[:, :, 16:144].view(n, nb, 4, 32)
        q = torch.stack([qs & 0x0F, qs >> 4], dim=3)
    else:
        qh = blk[:, :, 16:48].to(torch.int32).unsqueeze(2)  # [n, nb, 1, 32]
        qs = blk[:, :, 48:176].view(n, nb, 4, 32).to(torch.int32)
        j = torch.arange(4, device=blk.device, dtype=torch.int32).view(1, 1, 4, 1)
        q1 = (qs & 0x0F) + (((qh >> (2 * j)) & 1) << 4)
        q2 = (qs >> 4) + (((qh >> (2 * j + 1)) & 1) << 4)
        q = torch.stack([q1, q2], dim=3)
    return q, _f16(blk, 0), _f16(blk, 2), sc, mn


def blocks_on(raw, shape: tuple[int, int], dtype: DataType,
              device: str | torch.device) -> torch.Tensor:
    """ggml bytes of an ``[N, K]`` weight -> u8 blocks ``[N, K / block, bytes]``
    on ``device`` (one host copy, one upload)."""
    host = torch.from_numpy(np.array(raw, dtype=np.uint8, copy=True))
    return host.to(device).view(shape[0], -1, BLOCK_BYTES[dtype])


def from_ggml(raw, shape: tuple[int, int], dtype: DataType,
              device: str | torch.device) -> GroupQuant:
    """ggml bytes of an ``[N, K]`` weight in any :data:`REPACKABLE` format ->
    :class:`GroupQuant` (exact planes for q4_k/q5_k, bf16 planes otherwise).

    The bytes are copied to ``device`` once and decoded there with torch
    ops.  Generic planes round as the JAX package does: the f32 ggml scale,
    and the negated f32 min, to nearest-even bf16."""
    dtype = DataType(dtype)
    if dtype not in REPACKABLE:
        raise ValueError(f"from_ggml has no gq decoding for {dtype.name}")
    n, k = shape
    gs = group_size(dtype)
    if k % (J * gs):
        raise ValueError(f"{dtype.name}: K={k} is not a multiple of {J * gs}")
    blk = blocks_on(raw, shape, dtype, device)
    nb = blk.shape[1]
    if dtype not in EXACT_PLANE:
        q, scales, mins = _decode_generic(blk, dtype)
        return GroupQuant(
            codes=q.reshape(n, k).to(torch.int8).contiguous(), dtype=dtype, n_in=k,
            group_size=gs,
            a=scales.t().to(torch.bfloat16).contiguous(),
            b=(-mins).t().to(torch.bfloat16).contiguous())
    q, d, dmin, sc, mn = _decode_k4(blk, dtype)
    return GroupQuant(
        codes=q.reshape(n, k).to(torch.int8).contiguous(), dtype=dtype, n_in=k, group_size=gs,
        sc6=sc.reshape(n, nb * J).t().to(torch.uint8).contiguous(),
        mn6=mn.reshape(n, nb * J).t().to(torch.uint8).contiguous(),
        d=d.t().contiguous(),
        dmin=dmin.t().contiguous(),
    )


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _select(w: GroupQuant, layer: int | None) -> GroupQuant:
    if w.stacked:
        if layer is None:
            raise ValueError("stacked GroupQuant requires a layer index")
        return w.layer(layer)
    return w


def split_activations(x: torch.Tensor):
    """[M, K] -> (x1 i8, x2 i8, s1 f32 [M, 1], s2 f32 [M, 1]) with
    x ~= s1 x1 + s2 x2: the JAX package's ``split_activations``.  s1 is the
    row's absmax / 127 (1 for a zero row), s2 = s1 / 128; x1 and x2 round
    half to even.  Every division is IEEE-exact (a tensor divisor, never the
    reciprocal multiply PyTorch's CUDA division by a Python scalar takes)."""
    x = x.float()
    ax = x.abs().amax(dim=-1, keepdim=True)
    s1 = torch.where(ax == 0, torch.ones_like(ax), ax / torch.full_like(ax, 127.0))
    x1 = torch.clamp(torch.round(x / s1), -127, 127)
    r = x - s1 * x1
    s2 = s1 / torch.full_like(s1, 128.0)
    x2 = torch.clamp(torch.round(r / s2), -127, 127)
    return x1.to(torch.int8), x2.to(torch.int8), s1, s2


def group_sums(x: torch.Tensor, gs: int = 32) -> torch.Tensor:
    """x [M, K] -> f32 [K / gs, M], the sum of each ``gs``-wide group of the
    true x (the JAX package's ``sgt``)."""
    m, k = x.shape
    return x.float().reshape(m, k // gs, gs).sum(dim=2).t().contiguous()


def qmatmul_decode_ref(x: torch.Tensor, w: GroupQuant, layer: int | None = None) -> torch.Tensor:
    """x f32 [M, K] @ W.T -> f32 [M, N], the function of the decode kernels
    (and of the JAX package's ``_kernel_exact`` / ``_kernel_generic``): x
    split by :func:`split_activations`, per group g the exact integer dot
    products c1 = q . x1 and c2 = q . x2 (in f32: every partial sum is an
    integer below 32 * 128 * 127 < 2^24, exact even on TF32), then in f32
    ``t = c1 s1 + c2 s2`` and ``t A[g] + sgt[g] B[g]``, each product and sum
    rounded on its own; the groups of each chunk of ``J`` summed, the chunks
    added in K order, as the JAX kernel's ``_combine``."""
    w = _select(w, layer)
    x = x.float()
    m, k = x.shape
    gs, n = w.group_size, w.n_out
    g = k // gs
    x1, x2, s1, s2 = split_activations(x)
    sgt = group_sums(x, gs)  # [G, M]
    qg = w.codes_int().float().reshape(n, g, gs)
    c = torch.einsum("mgk,ngk->gmn", torch.cat([x1, x2]).float().reshape(2 * m, g, gs), qg)
    t = c[:, :m] * s1.reshape(1, m, 1) + c[:, m:] * s2.reshape(1, m, 1)
    a, b = w.planes()  # [G, N], exact in f32
    term = t * a[:, None, :] + sgt[:, :, None] * b[:, None, :]
    chunks = term.reshape(g // J, J, m, n).sum(dim=1)
    y = chunks[0]
    for chunk in chunks[1:]:
        y = y + chunk
    return y


def qmatmul_prefill_ref(x: torch.Tensor, w: GroupQuant, layer: int | None = None) -> torch.Tensor:
    """bf16(x) @ bf16(dequant(W)).T with f32 accumulation -> f32 [M, N]."""
    xb = x.float().to(torch.bfloat16).float()
    wb = _select(w, layer).dequantize().to(torch.bfloat16).float()
    return xb @ wb.t()


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(name: str, x: torch.Tensor, w: GroupQuant, layer: int | None,
            exact: bool) -> torch.Tensor:
    """Launch the entry ``mgt_<name>`` on the weight's plane mode and code
    storage; count the launch on the wrapper, by packing."""
    fn_name = f"mgt_{name}"
    _build.refuse_grad(fn_name, x)
    if w.exact != exact:
        raise ValueError(f"{fn_name} takes {'exact' if exact else 'generic'}-plane weights, "
                         f"got a {'exact' if w.exact else 'generic'} {w.dtype.name} weight")
    if x.dim() != 2 or x.shape[1] != w.n_in:
        raise ValueError(f"{fn_name}: x must be [M, {w.n_in}], got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"{fn_name}: x must be float32, got {x.dtype}")
    for t_name, t in w.tensors().items():
        if t.device != x.device:
            raise ValueError(f"{fn_name}: {t_name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{fn_name}: {t_name} must be contiguous")
    if not exact and (w.a.dtype, w.b.dtype) != (torch.bfloat16, torch.bfloat16):
        raise TypeError(f"{fn_name}: planes must be bfloat16, got {w.a.dtype}/{w.b.dtype}")
    if w.group_size not in (16, 32) or (exact and w.group_size != 32):
        raise ValueError(f"{fn_name}: group size {w.group_size} is not served")
    if w.n_in % (J * w.group_size):
        raise ValueError(f"{fn_name}: K={w.n_in} is not a multiple of {J * w.group_size}")
    hb = HI_BITS.get(w.packing)
    if hb is None or (w.packing != "none" and w.packing != packing_of(w.dtype)):
        raise ValueError(f"{fn_name}: packing {w.packing!r} does not fit {w.dtype.name}")
    k_codes = w.n_in if w.packing == "none" else w.n_in // 2
    code_dtype = torch.int8 if w.packing == "none" else torch.uint8
    if w.codes.dtype != code_dtype or w.codes.shape[-1] != k_codes:
        raise ValueError(f"{fn_name}: codes must be {code_dtype} [..., N, {k_codes}] for packing "
                         f"{w.packing!r}, got {w.codes.dtype} {tuple(w.codes.shape)}")
    if (w.hi is not None) != (hb > 0) or (hb and (
            w.hi.dtype != torch.int32 or w.hi.shape != (*w.codes.shape[:-1], w.n_in * hb // 32))):
        raise ValueError(f"{fn_name}: packing {w.packing!r} needs "
                         + (f"hi int32 [..., N, {w.n_in * hb // 32}]" if hb else "no hi"))
    if w.stacked and layer is None:
        raise ValueError("stacked GroupQuant requires a layer index")
    n_layers = w.codes.shape[0] if w.stacked else 1
    li = int(layer) if w.stacked else 0
    if not 0 <= li < n_layers:
        raise IndexError(f"{fn_name}: layer {li} out of range [0, {n_layers})")
    if w.codes.data_ptr() % 16:
        raise ValueError(f"{fn_name}: codes must be 16-byte aligned")
    if w.hi is not None and w.hi.data_ptr() % 8:
        raise ValueError(f"{fn_name}: hi must be 8-byte aligned")
    x = _aligned(x)
    m, k = x.shape
    n = w.n_out
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    fn = getattr(_build.load(), fn_name)
    stream = ctypes.c_void_p(_build.stream_ptr(x.device))
    if exact:
        planes, gs = (w.sc6, w.mn6, w.d, w.dmin), ()
    else:
        planes, gs = (w.a, w.b), (w.group_size,)
    _xb, pre = None, ()  # _xb: the bf16 x the launch reads, alive until queued
    if name.startswith("gq_prefill"):  # the workspace of csrc/qmm_prefill.cuh
        _xb, pre = qmm_prefill.launch_args(x, n)
    rc = fn(x.data_ptr(), w.codes.data_ptr(), None if w.hi is None else w.hi.data_ptr(),
            *(t.data_ptr() for t in planes), y.data_ptr(), m, n, k, *gs,
            -1 if w.packing == "none" else hb, li, *pre, stream)
    _build.check(rc, fn_name)
    wrapper = _WRAPPERS[name]
    if w.packing == "none":
        wrapper.launches += 1
    else:
        wrapper.packed_launches[w.packing] += 1
    return y


def _decode_rows(name: str, x: torch.Tensor) -> None:
    if not 1 <= x.shape[0] <= GQ_MAX_M:
        raise ValueError(f"{name} serves 1..{GQ_MAX_M} rows, got {x.shape[0]}")


def gq_decode(x: torch.Tensor, w: GroupQuant, layer: int | None = None) -> torch.Tensor:
    """x f32 [M <= 8, K] @ W.T -> f32 [M, N], the dual-i8 function of
    :func:`qmatmul_decode_ref`, exact planes, any packing
    (``csrc/gq_decode.cu``; one launch, the split of x included)."""
    if x.device.type == "cpu":
        return qmatmul_decode_ref(x, w, layer)
    _decode_rows("gq_decode", x)
    return _launch("gq_decode", x, w, layer, exact=True)


def gq_decode_generic(x: torch.Tensor, w: GroupQuant, layer: int | None = None) -> torch.Tensor:
    """x f32 [M <= 8, K] @ W.T -> f32 [M, N], the dual-i8 function of
    :func:`qmatmul_decode_ref`, bf16 planes of group size 16 or 32, any
    packing (``csrc/gq_decode.cu``, entry ``mgt_gq_decode_generic``)."""
    if x.device.type == "cpu":
        return qmatmul_decode_ref(x, w, layer)
    _decode_rows("gq_decode_generic", x)
    return _launch("gq_decode_generic", x, w, layer, exact=False)


def gq_prefill(x: torch.Tensor, w: GroupQuant, layer: int | None = None) -> torch.Tensor:
    """x f32 [M, K] @ W.T -> f32 [M, N] with bf16 operands, exact planes, any
    packing (``csrc/gq_prefill.cu``)."""
    if x.device.type == "cpu":
        return qmatmul_prefill_ref(x, w, layer)
    if x.shape[0] < 1:
        raise ValueError("gq_prefill needs at least one row")
    return _launch("gq_prefill", x, w, layer, exact=True)


def gq_prefill_generic(x: torch.Tensor, w: GroupQuant, layer: int | None = None) -> torch.Tensor:
    """x f32 [M, K] @ W.T -> f32 [M, N] with bf16 operands, bf16 planes, any
    packing (``csrc/gq_prefill.cu``, entry ``mgt_gq_prefill_generic``)."""
    if x.device.type == "cpu":
        return qmatmul_prefill_ref(x, w, layer)
    if x.shape[0] < 1:
        raise ValueError("gq_prefill_generic needs at least one row")
    return _launch("gq_prefill_generic", x, w, layer, exact=False)


_WRAPPERS = {f.__name__: f for f in (gq_decode, gq_decode_generic, gq_prefill, gq_prefill_generic)}
for _f in _WRAPPERS.values():
    _f.launches = 0
    _f.packed_launches = {"p4": 0, "p5": 0, "p6": 0}
del _f


def qmatmul_group(x: torch.Tensor, w: GroupQuant, layer: int | None = None) -> torch.Tensor:
    """x [..., K] @ W.T -> [..., N] in x's dtype: M <= GQ_MAX_M rows go to
    the decode kernel of the weight's plane mode, more to its prefill kernel."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, w.n_in).float()
    if x2.shape[0] <= GQ_MAX_M:
        fn = gq_decode if w.exact else gq_decode_generic
    else:
        fn = gq_prefill if w.exact else gq_prefill_generic
    return fn(x2, w, layer).reshape(*lead, w.n_out).to(x.dtype)
