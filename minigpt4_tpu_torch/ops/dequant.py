"""Dequantization of packed ggml rows with torch ops, on any device.

Counterpart of ``minigpt4_tpu/ops/dequant.py``: ``packed`` u8
``[..., row_bytes]`` -> ``[..., n]`` floats, for the formats of the JAX
package's ``DEQUANT_FNS`` (f16, f32, q4_0, q4_1, q5_0, q5_1, q8_0, q2_k,
q3_k, q4_k, q5_k, q6_k, q8_k).  The block decoders are those of
``group_i8`` (one decoder per format in the port); each weight is
``scale * q - min`` in f32, which gives the JAX formulas' bits: every
product and difference of an f16 scale with the small integer codes is
exact in f32.  Other formats (q8_1, ...) raise, as the JAX table does.

The QTensor matmul (``ops/quant_matmul.py``) and the w8a8 loader
(``ops/i8_matmul.from_ggml``) decode through :func:`dequantize`.
"""

from __future__ import annotations

import torch

from ..formats import DataType
from . import group_i8 as gq

Q8K_BLOCK = 292  # f32 d, 256 i8 codes, 16 i16 block sums
DEQUANT_FORMATS = frozenset(gq.REPACKABLE | {DataType.F16, DataType.F32, DataType.Q8_K})


def _planes_times_codes(q: torch.Tensor, scales: torch.Tensor, mins: torch.Tensor,
                        n: int, k: int) -> torch.Tensor:
    """codes [n, ...] with per-group f32 scales/mins [n, G] -> [n, k] f32."""
    gs = k // scales.shape[1]
    sc = torch.repeat_interleave(scales, gs, dim=1)
    mn = torch.repeat_interleave(mins, gs, dim=1)
    return sc * q.reshape(n, k).float() - mn


def _rows(packed: torch.Tensor, dtype: DataType) -> torch.Tensor:
    """u8 [n, row_bytes] -> f32 [n, k]."""
    n, rb = packed.shape
    if dtype == DataType.F32:
        return packed.contiguous().view(torch.float32).clone()
    if dtype == DataType.F16:
        return packed.contiguous().view(torch.float16).float()
    if dtype == DataType.Q8_K:
        blk = packed.reshape(n, -1, Q8K_BLOCK)
        d = blk[:, :, 0:4].contiguous().view(torch.float32)  # [n, nb, 1]
        q = blk[:, :, 4:260].contiguous().view(torch.int8).float()
        return (q * d).reshape(n, -1)
    blk = packed.reshape(n, -1, gq.BLOCK_BYTES[dtype])
    k = blk.shape[1] * (256 if dtype in gq.EXACT_PLANE or dtype in gq.GS16 else 32)
    if dtype in gq.EXACT_PLANE:
        q, d, dmin, sc, mn = gq._decode_k4(blk, dtype)
        scales = (d.unsqueeze(-1) * sc.float()).reshape(n, -1)
        mins = (dmin.unsqueeze(-1) * mn.float()).reshape(n, -1)
        return _planes_times_codes(q, scales, mins, n, k)
    q, scales, mins = gq._decode_generic(blk, dtype)
    return _planes_times_codes(q, scales.reshape(n, -1), mins.reshape(n, -1), n, k)


def dequantize(packed: torch.Tensor, dtype: DataType, out_dtype=torch.float32) -> torch.Tensor:
    """u8 ``[..., row_bytes]`` -> ``[..., n]`` in ``out_dtype`` (decoded in f32)."""
    dtype = DataType(dtype)
    if dtype not in DEQUANT_FORMATS:
        raise ValueError(f"no dequantization for {dtype.name} (the JAX package's DEQUANT_FNS "
                         "has none either)")
    lead = packed.shape[:-1]
    rows = _rows(packed.reshape(-1, packed.shape[-1]), dtype)
    return rows.reshape(*lead, rows.shape[-1]).to(out_dtype)
