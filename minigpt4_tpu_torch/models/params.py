"""Linear layers over dense, group-quant or repacked weights.

Counterpart of ``minigpt4_tpu/models/params.py``.  Weight convention as in
the JAX package: dense weights are ``[in, out]`` (``x @ w``), optionally
stacked ``[L, in, out]``; quantized weights keep ggml's ``[out, in]`` rows
as a :class:`~minigpt4_tpu_torch.ops.group_i8.GroupQuant`, a
:class:`~minigpt4_tpu_torch.ops.repack.RepackedQuant`, an
:class:`~minigpt4_tpu_torch.ops.i8_matmul.I8SBQuant` or a
:class:`~minigpt4_tpu_torch.ops.quant_matmul.QTensor` (packed bytes).
"""

from __future__ import annotations

import numpy as np
import torch

from ..formats import DataType
from ..ops import group_i8 as gq
from ..ops import i8_matmul as i8
from ..ops import repack as rp
from ..ops import quant_matmul as qm
from ..ops.pallas_quant_matmul import qmatmul_repacked

QUANT_MODES = ("auto", "repack", "qtensor", "w8a8", "gq")


def resolve_gq_pack(quant_mode: str) -> bool:
    """Whether gq codes are stored packed for the mode a user asked for, as
    the JAX engine's ``resolve_llm_quant_mode`` leaves it: unpacked for
    ``auto`` (its unpacked codes fit every supported model on 80 GB),
    packed for an explicit mode, and ``MINIGPT4_TPU_GQ_PACK`` over both
    (``group_i8.pack_enabled``).  Callers settle it once and pass the bool
    to the loaders."""
    return gq.pack_enabled(False if quant_mode == "auto" else None)


# (stack over layers, concat along the output axis) of each quantized form
QUANT_FORMS = {gq.GroupQuant: (gq.stack, gq.concat_out),
               rp.RepackedQuant: (rp.stack, rp.concat_out),
               i8.I8SBQuant: (i8.stack, i8.concat_out),
               qm.QTensor: (qm.stack, qm.concat_out)}


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
    elif isinstance(w, i8.I8SBQuant):
        y = i8.qmatmul_i8sb(x, w, layer if w.stacked else None)
    elif isinstance(w, qm.QTensor):
        y = qm.qmatmul(x, w, layer if w.stacked else None)
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
                      device: str | torch.device, mode: str = "auto", col_scale=None,
                      row_scale=None, pack: bool = False):
    """The device form of a quantized weight, by the JAX package's rules
    (``params.load_quant_weight``):

    * ``"gq"``: group-quant (exact planes for q4_k/q5_k, bf16 planes
      otherwise) where ``group_i8.supported`` accepts the format and K, the
      ``auto`` form otherwise; with ``pack`` (:func:`resolve_gq_pack`) the
      codes of the 4/5/6-bit formats are stored packed
      (``group_i8.pack_codes``);
    * ``"w8a8"``: i8 codes with 256-wide superblock scales
      (``ops/i8_matmul.py``) where K % 256 == 0, the ``auto`` form otherwise;
    * ``"qtensor"``: the packed ggml bytes, dequantized on every call
      (``ops/quant_matmul.py``);
    * ``"repack"`` and ``"auto"``: the repacked form, or the packed bytes
      for a format with no repacked form (q8_1, ...).  On the TPU ``auto``
      repacks; the engine resolves ``auto`` to ``gq`` for the decoder
      before it gets here, as the TPU's budget resolution does for every
      supported model on 80 GB.

    ``col_scale`` [K] / ``row_scale`` [N]: smooth-quant migration factors,
    folded in by the w8a8 form only; any other mode, or a K that w8a8 does
    not take, raises (the packed forms keep the file's exact bytes)."""
    dtype = DataType(dtype)
    if mode not in QUANT_MODES:
        raise ValueError(f"unknown quant_mode {mode!r}: expected {' | '.join(QUANT_MODES)}")
    smooth = col_scale is not None or row_scale is not None
    if smooth and mode != "w8a8":
        raise ValueError("smooth scales are only valid with quant_mode='w8a8'")
    if mode == "gq" and gq.supported(dtype, shape[1]):
        w = gq.from_ggml(raw, shape, dtype, device)
        return gq.pack_codes(w) if pack and gq.packable(dtype) else w
    if mode == "w8a8":
        if shape[1] % i8.SB == 0:
            return i8.from_ggml(raw, shape, dtype, device, col_scale=col_scale,
                                row_scale=row_scale)
        if smooth:
            raise ValueError(f"cannot fold smooth scales into K={shape[1]} (not a multiple of "
                             f"{i8.SB}); caller must skip this site")
    if mode != "qtensor" and dtype in rp.REPACKABLE:
        return rp.from_ggml(raw, shape, dtype, device)
    return qm.QTensor.from_raw(raw, shape, dtype, device)


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
