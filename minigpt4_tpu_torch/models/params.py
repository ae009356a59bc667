"""Linear layers over dense, group-quant or repacked weights.

Counterpart of ``minigpt4_tpu/models/params.py``.  Weight convention as in
the JAX package: dense weights are ``[in, out]`` (``x @ w``), optionally
stacked ``[L, in, out]``; quantized weights keep ggml's ``[out, in]`` rows
as a :class:`~minigpt4_tpu_torch.ops.group_i8.GroupQuant` or a
:class:`~minigpt4_tpu_torch.ops.repack.RepackedQuant`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..formats import DataType
from ..ops import group_i8 as gq
from ..ops import repack as rp
from ..ops.pallas_quant_matmul import qmatmul_repacked

QUANT_MODES = ("auto", "repack", "qtensor", "w8a8", "gq")


def linear(x: torch.Tensor, p: dict, layer: int | None = None) -> torch.Tensor:
    """Apply ``{"w": weight, "b": optional bias}``; ``layer`` selects one
    layer of stacked params, or the entry of a per-layer list (a name whose
    layers differ in format, as in llama.cpp's K_M files)."""
    w = p["w"]
    if isinstance(w, list):
        w, layer = w[layer], None
    if isinstance(w, gq.GroupQuant):
        y = gq.qmatmul_group(x, w, layer if w.stacked else None)
    elif isinstance(w, rp.RepackedQuant):
        y = qmatmul_repacked(x, w, layer if w.stacked else None)
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
                      device: str | torch.device, mode: str = "auto"):
    """The device form of a quantized weight, by the JAX package's rules
    (``params.load_quant_weight``):

    * ``"gq"``: group-quant (exact planes for q4_k/q5_k, bf16 planes
      otherwise) where ``group_i8.supported`` accepts the format and K, the
      repacked form otherwise;
    * ``"repack"`` and ``"auto"``: the repacked form.  On the TPU ``auto``
      repacks; the engine resolves ``auto`` to ``gq`` for the decoder before
      it gets here, as the TPU's budget resolution does for every supported
      model on 80 GB.

    ``"qtensor"`` (raw ggml bytes with an XLA dequant) and ``"w8a8"`` raise
    ``NotImplementedError`` naming their ROADMAP items, as does a format with
    no repacked form (q8_1, ...)."""
    dtype = DataType(dtype)
    if mode not in QUANT_MODES:
        raise ValueError(f"unknown quant_mode {mode!r}: expected {' | '.join(QUANT_MODES)}")
    if mode == "qtensor":
        raise NotImplementedError(
            "quant_mode 'qtensor' (packed ggml bytes with a dequantizing fallback matmul) is "
            "not ported (ROADMAP Queue 1 item 2, ops/quant_matmul.py)")
    if mode == "w8a8":
        raise NotImplementedError(
            "quant_mode 'w8a8' (i8 weights and activations) is not ported (ROADMAP Queue 2 "
            "item 4, i8_matmul, and Queue 1 item 10)")
    if mode == "gq" and gq.supported(dtype, shape[1]):
        return gq.from_ggml(raw, shape, dtype, device)
    if dtype not in rp.REPACKABLE:
        raise NotImplementedError(
            f"{dtype.name} weight {tuple(shape)}: only q4_0/q4_1/q5_0/q5_1/q8_0/q2_k/q3_k/"
            "q4_k/q5_k/q6_k load; other formats need the packed-bytes fallback (ROADMAP "
            "Queue 1 item 2, ops/dequant.py and ops/quant_matmul.py)")
    return rp.from_ggml(raw, shape, dtype, device)


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
