"""Matmul over packed ggml weights (``QTensor``): dequantize, then one matmul.

Counterpart of ``minigpt4_tpu/ops/quant_matmul.py``.  The JAX package runs
this form in XLA with no Pallas kernel (its kernels take the repacked
form), so here it is plain torch: the whole weight is dequantized by
``ops/dequant.py`` in x's dtype on every call, then ``x @ W.T``.  It is the
form of ``quant_mode="qtensor"``, of the smooth-quant calibration
(``quality.compute_smooth_scales``), of the formats no kernel takes, and of
the frozen weights the trainers differentiate through (``train/``):
:func:`qmatmul` is an autograd Function that saves only the packed bytes
and dequantizes again in its backward, so a step holds no dequantized
weight (13B in f32: about 51 GB).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..formats import DataType
from ..formats.dtypes import row_bytes
from .dequant import dequantize


@dataclass
class QTensor:
    """Packed ggml-quantized weight, logically ``[(L,) n_out, n_in]``
    (``models/params.QTensor`` of the JAX package)."""

    packed: torch.Tensor  # u8 [(L,) n_out, row_bytes]
    dtype: DataType
    n_in: int

    @property
    def n_out(self) -> int:
        return self.packed.shape[-2]

    @property
    def stacked(self) -> bool:
        return self.packed.dim() == 3

    def layer(self, li: int) -> "QTensor":
        return QTensor(self.packed[li], self.dtype, self.n_in)

    def dequantize(self, out_dtype=torch.float32) -> torch.Tensor:
        """``[(L,) n_out, n_in]`` in ``out_dtype``."""
        return dequantize(self.packed, self.dtype, out_dtype)

    @staticmethod
    def from_raw(raw, shape: tuple[int, int], dtype: DataType,
                 device: str | torch.device) -> "QTensor":
        n_out, n_in = shape
        rb = row_bytes(DataType(dtype), n_in)
        host = torch.from_numpy(np.array(raw, dtype=np.uint8, copy=True).reshape(n_out, rb))
        return QTensor(host.to(device), DataType(dtype), n_in)


def stack(ws: list[QTensor]) -> QTensor:
    w0 = ws[0]
    if any((w.dtype, w.n_in) != (w0.dtype, w0.n_in) for w in ws):
        raise ValueError("stacked QTensor layers must share format and K")
    return QTensor(torch.stack([w.packed for w in ws]), w0.dtype, w0.n_in)


def concat_out(ws: list[QTensor]) -> QTensor:
    w0 = ws[0]
    if any((w.dtype, w.n_in) != (w0.dtype, w0.n_in) for w in ws):
        raise ValueError("fused QTensor parts must share format and K")
    return QTensor(torch.cat([w.packed for w in ws], dim=-2), w0.dtype, w0.n_in)


class _QMatmul(torch.autograd.Function):
    """y = x @ dequant(W).T with a frozen W: forward saves the packed bytes,
    backward gives dx = dy @ dequant(W) and W no grad."""

    @staticmethod
    def forward(ctx, x, packed, dtype):
        ctx.save_for_backward(packed)
        ctx.dtype = dtype
        return x @ dequantize(packed, dtype, x.dtype).t()

    @staticmethod
    def backward(ctx, dy):
        (packed,) = ctx.saved_tensors
        return dy @ dequantize(packed, ctx.dtype, dy.dtype), None, None


def qmatmul(x: torch.Tensor, qt: QTensor, layer: int | None = None) -> torch.Tensor:
    """x [..., K] @ W.T -> [..., N] in x's dtype, the weight dequantized in
    x's dtype (``qmatmul_xla``); differentiable in x (:class:`_QMatmul`)."""
    if qt.stacked:
        if layer is None:
            raise ValueError("stacked QTensor requires a layer index")
        qt = qt.layer(layer)
    return _QMatmul.apply(x, qt.packed, qt.dtype)
