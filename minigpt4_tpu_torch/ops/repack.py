"""Repacked quantized weights ("rq"), the form of the fused dequant-matmul.

Counterpart of ``minigpt4_tpu/ops/repack.py`` with the port's own storage,
chosen for Hopper: K stays in its natural order, so a kernel reads a row's
codes with plain vector loads.  A :class:`RepackedQuant` of a logical
``[(L,) N, K]`` weight holds

    codes   u8 [(L,) N, K/2]  two 4-bit codes per byte along K: byte (n, j) =
            q[n, 2j] | q[n, 2j+1] << 4 (q4_*, q5_*, q2_k, q3_k, q4_k, q5_k,
            q6_k), or i8 [(L,) N, K] signed codes (q8_0)
    hi      i32 [(L,) N, K/32]  bit b of word w is bit 4 of q[n, 32w + b]
            (q5_0, q5_1, q5_k), or i32 [(L,) N, K/16] with bits 5:4 of
            q[n, 16w + b] at bits 2b+1:2b (q6_k); None otherwise
    scales  bf16 [(L,) N, K/gs]  per-group multiplier
    mins    bf16 [(L,) N, K/gs]  per-group subtrahend

    w[n, k] = scales[n, k // gs] * q[n, k] - mins[n, k // gs]

with the unsigned formats' zero offsets folded into mins (q4_0: 8 d, q5_0:
16 d, q3_k: 4 scale, q6_k: 32 scale) and q8_0's mins zero, exactly as the
JAX package's ``_decode_codes_scales``; scales and mins round from f32 to
bf16 to nearest even, as its default ``plane_dtype``.  Group size 16 for
q2_k, q3_k and q6_k, 32 otherwise.  An odd N needs no padding row.  The
Mosaic layouts of the JAX package (tile-interleaved K, row-pair nibbles for
``pltpu.bitcast``, tile-major bit planes) have no job here;
``interop.repacked_from_numpy`` converts them.  The K order also makes
JAX's ``with_k_shards`` re-layout unnecessary: a contiguous, group-aligned
K range of the planes is a weight of its own (:func:`k_slice`, the K
shards of tensor parallelism).

Bytes per weight streamed by a matmul: 0.5 of nibbles, + 0.125 of q5 bits
or 0.25 of q6 bits, + 4/gs of planes: 0.625 (q4_0), 0.75 (q5_k), 1.0 (q6_k);
q8_0 1.125.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import torch

from ..formats import DataType
from . import group_i8 as gq

# static plane layout per format: (code bits, high bits); layers stack only
# within one layout (repack.py _LAYOUT of the JAX package)
LAYOUT = {
    DataType.Q4_0: (4, 0), DataType.Q4_1: (4, 0), DataType.Q2_K: (4, 0),
    DataType.Q3_K: (4, 0), DataType.Q4_K: (4, 0), DataType.Q5_0: (4, 1),
    DataType.Q5_1: (4, 1), DataType.Q5_K: (4, 1), DataType.Q6_K: (4, 2),
    DataType.Q8_0: (8, 0),
}
REPACKABLE = frozenset(LAYOUT)


@dataclass
class RepackedQuant:
    """Repacked weight, logically ``[(L,) N, K]``; see the module docstring."""

    codes: torch.Tensor  # u8 [(L,) N, K/2] or i8 [(L,) N, K]
    scales: torch.Tensor  # bf16 [(L,) N, K/gs]
    mins: torch.Tensor  # bf16 [(L,) N, K/gs]
    hi: torch.Tensor | None  # i32 [(L,) N, K/32] or [(L,) N, K/16]
    dtype: DataType
    n_in: int
    group_size: int
    code_bits: int
    hi_bits: int

    @property
    def n_out(self) -> int:
        return self.scales.shape[-2]

    @property
    def stacked(self) -> bool:
        return self.scales.dim() == 3

    def tensors(self) -> dict[str, torch.Tensor]:
        return {f.name: getattr(self, f.name) for f in fields(self)
                if isinstance(getattr(self, f.name), torch.Tensor)}

    def form(self) -> tuple:
        """What must agree for weights to stack or fuse."""
        return (self.dtype, self.n_in, self.group_size, self.code_bits, self.hi_bits)

    def _replace(self, **ts) -> "RepackedQuant":
        return RepackedQuant(**{"hi": None, **ts}, dtype=self.dtype, n_in=self.n_in,
                             group_size=self.group_size, code_bits=self.code_bits,
                             hi_bits=self.hi_bits)

    def layer(self, li: int) -> "RepackedQuant":
        """One layer of a stacked weight (views, no copy)."""
        return self._replace(**{k: v[li] for k, v in self.tensors().items()})

    def codes_int(self) -> torch.Tensor:
        """The full codes q ``[(L,) N, K]`` as i32 (0..63, or -128..127 for q8_0)."""
        if self.code_bits == 8:
            return self.codes.to(torch.int32)
        return gq.unpack_nibbles(self.codes, self.hi, self.hi_bits)

    def dequantize(self) -> torch.Tensor:
        """``[(L,) N, K]`` f32: ``scale * q - min`` with the planes expanded
        over their groups (the operations of the JAX package's
        ``dequantize_repacked``, so the two agree bit for bit)."""
        gs = self.group_size
        sc = torch.repeat_interleave(self.scales.float(), gs, dim=-1)
        mn = torch.repeat_interleave(self.mins.float(), gs, dim=-1)
        return sc * self.codes_int().float() - mn


def _check(ws: list[RepackedQuant], what: str) -> RepackedQuant:
    w0 = ws[0]
    if any(w.form() != w0.form() for w in ws):
        raise ValueError(f"{what} RepackedQuant parts must share format and K")
    return w0


def stack(ws: list[RepackedQuant]) -> RepackedQuant:
    """Per-layer weights -> one weight with a leading L axis."""
    w0 = _check(ws, "stacked")
    return w0._replace(**{k: torch.stack([w.tensors()[k] for w in ws]) for k in w0.tensors()})


def concat_out(ws: list[RepackedQuant]) -> RepackedQuant:
    """Fuse weights of one input width along the output axis (wq|wk|wv):
    every field is one row per output, so all concatenate along N."""
    w0 = _check(ws, "fused")
    return w0._replace(**{k: torch.cat([w.tensors()[k] for w in ws], dim=-2)
                          for k in w0.tensors()})


def pack(q: torch.Tensor, scales: torch.Tensor, mins: torch.Tensor,
         dtype: DataType) -> RepackedQuant:
    """Full codes ``q [N, K]`` (0..63 unsigned, or i8 for q8_0) and f32 planes
    ``[N, K/gs]`` -> the port's storage."""
    dtype = DataType(dtype)
    code_bits, hi_bits = LAYOUT[dtype]
    _, k = q.shape
    if code_bits == 8:
        codes, hi = q.to(torch.int8).contiguous(), None
    else:
        codes, hi = gq.pack_nibbles(q, hi_bits)
    return RepackedQuant(codes=codes, scales=scales.to(torch.bfloat16).contiguous(),
                         mins=mins.to(torch.bfloat16).contiguous(), hi=hi, dtype=dtype,
                         n_in=k, group_size=gq.group_size(dtype), code_bits=code_bits,
                         hi_bits=hi_bits)


def from_ggml(raw, shape: tuple[int, int], dtype: DataType,
              device: str | torch.device) -> RepackedQuant:
    """ggml bytes of an ``[N, K]`` weight in any :data:`REPACKABLE` format ->
    :class:`RepackedQuant`, decoded on ``device`` with torch ops by the
    decoders of ``group_i8`` (one upload of the bytes, no host pass over the
    weights)."""
    dtype = DataType(dtype)
    if dtype not in REPACKABLE:
        raise ValueError(f"{dtype.name} has no repacked form")
    n, k = shape
    blk = gq.blocks_on(raw, shape, dtype, device)
    if dtype in gq.EXACT_PLANE:
        q, d, dmin, sc, mn = gq._decode_k4(blk, dtype)
        scales = d.unsqueeze(-1) * sc.float()  # exact in f32: f16 times a 6-bit integer
        mins = dmin.unsqueeze(-1) * mn.float()
    else:
        q, scales, mins = gq._decode_generic(blk, dtype)
    return pack(q.reshape(n, k), scales.reshape(n, -1), mins.reshape(n, -1), dtype)


def k_slice(w: RepackedQuant, shard: int, n_shards: int) -> RepackedQuant:
    """The K range ``[shard K/S, (shard + 1) K/S)`` of ``w`` as a weight of
    its own (copies), for the row-parallel shards of tensor parallelism:
    the counterpart of the JAX package's ``with_k_shards``, which re-lays
    its tile-interleaved planes so that such a range is self-consistent.
    The K-order layout needs no re-layout, only slicing: nibbles [N, K/2],
    high-bit words [N, K/32] (5-bit) or [N, K/16] (6-bit), planes
    [N, K/gs].  The slice must hold whole groups (JAX's guard)."""
    k, gs = w.n_in, w.group_size
    if k % n_shards or (k // n_shards) % gs:
        raise ValueError(f"K={k} not shardable into {n_shards} group-aligned slices")
    if not 0 <= shard < n_shards:
        raise IndexError(f"shard {shard} out of range [0, {n_shards})")
    ks = k // n_shards
    k0 = shard * ks

    def cut(t: torch.Tensor, per: int) -> torch.Tensor:  # ``per`` codes per element of t
        if ks % per:
            raise ValueError(f"K slice {ks} does not hold whole {per}-code words")
        return t[..., k0 // per:(k0 + ks) // per].contiguous()

    hi = None if w.hi is None else cut(w.hi, 32 // w.hi_bits)
    out = w._replace(codes=cut(w.codes, 8 // w.code_bits), scales=cut(w.scales, gs),
                     mins=cut(w.mins, gs), hi=hi)
    out.n_in = ks
    return out
