"""Linear layers over dense or group-quant weights.

Counterpart of ``minigpt4_tpu/models/params.py``.  Weight convention as in
the JAX package: dense weights are ``[in, out]`` (``x @ w``), optionally
stacked ``[L, in, out]``; quantized weights keep ggml's ``[out, in]`` rows
as a :class:`~minigpt4_tpu_torch.ops.group_i8.GroupQuant`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..formats import DataType
from ..ops import group_i8 as gq


def linear(x: torch.Tensor, p: dict, layer: int | None = None) -> torch.Tensor:
    """Apply ``{"w": weight, "b": optional bias}``; ``layer`` selects one
    layer of stacked params, or the entry of a per-layer list (a name whose
    layers differ in format, as in llama.cpp's K_M files)."""
    w = p["w"]
    if isinstance(w, list):
        w, layer = w[layer], None
    if isinstance(w, gq.GroupQuant):
        y = gq.qmatmul_group(x, w, layer if w.stacked else None)
    else:
        if layer is not None and w.dim() == 3:
            w = w[layer]
        y = x @ w.to(x.dtype)
    b = p.get("b")
    if b is not None:
        if layer is not None and b.dim() == 2:
            b = b[layer]
        y = y + b.to(y.dtype)
    return y


def load_quant_weight(raw: np.ndarray, shape: tuple[int, int], dtype: DataType,
                      device: str | torch.device) -> gq.GroupQuant:
    """The device form of a quantized weight: every format and K that
    ``group_i8.supported`` accepts -> group-quant (exact planes for
    q4_k/q5_k, bf16 planes otherwise)."""
    dtype = DataType(dtype)
    if not gq.supported(dtype, shape[1]):
        raise NotImplementedError(
            f"{dtype.name} weight {tuple(shape)}: gq takes q4_0/q4_1/q5_0/q5_1/q8_0/q4_k/q5_k "
            "with K % 256 == 0 and q2_k/q3_k/q6_k with K % 128 == 0; other weights need "
            "the repacked fused kernel (ROADMAP Queue 2 item 3, pallas_quant_matmul)")
    return gq.from_ggml(raw, shape, dtype, device)


def dense_from_numpy(w_out_in: np.ndarray, b: np.ndarray | None, dtype: torch.dtype,
                     device: str | torch.device) -> dict:
    """torch-layout [out, in] numpy weight -> ``{"w": [in, out], "b": [out]}``."""
    p = {"w": tensor(np.asarray(w_out_in).T, dtype, device)}
    if b is not None:
        p["b"] = tensor(b, dtype, device)
    return p


def tensor(a: np.ndarray, dtype: torch.dtype, device: str | torch.device) -> torch.Tensor:
    """Host array -> device tensor (copies, so read-only mmap views are fine)."""
    return torch.from_numpy(np.array(a, np.float32, order="C")).to(device=device, dtype=dtype)
