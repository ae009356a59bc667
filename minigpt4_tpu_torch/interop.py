"""Parameter trees of the JAX package, as NumPy arrays -> the port's trees.

Used by the parity tests so that both implementations compute with the same
weights.  ``GroupQuant`` fields map one to one, in both plane modes
(unpacked codes only: load the JAX side with sub-byte packing off), as do
``I8SBQuant`` (codes, scales) and ``QTensor`` (packed bytes); a JAX
``RepackedQuant`` (TPU layout) is converted to the port's layout by
:func:`repacked_from_numpy`; dense ``[K, N]`` weights stay ``[K, N]``;
stacked layers stay stacked and per-layer lists (K_M files) stay lists.
The JAX decoder keeps wq/wk/wv and w1/w3 apart for group-quant weights; the
layers are reassembled here by
:func:`~minigpt4_tpu_torch.models.llama.assemble_layers`, which fuses them
as the port's file loader does.
"""

from __future__ import annotations

import numpy as np
import torch

from .formats import DataType
from .models.llama import FUSED, assemble_layers
from .ops import group_i8 as gq
from .ops import i8_matmul as i8
from .ops import repack as rp
from .ops.quant_matmul import QTensor


def _t(a, device, dtype=None) -> torch.Tensor:
    a = np.array(a, order="C")
    # torch.from_numpy rejects NumPy's bfloat16 (ml_dtypes): go through its bits
    t = (torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16) if a.dtype.name == "bfloat16"
         else torch.from_numpy(a))
    return t.to(device=device, dtype=dtype) if dtype is not None else t.to(device)


def group_quant_from_numpy(w, device) -> gq.GroupQuant:
    """A JAX ``GroupQuant`` (unpacked, either plane mode) with NumPy fields."""
    if w.packing != "none" or w.k_pad or w.k_shards != 1:
        raise ValueError(f"GroupQuant packing={w.packing!r} k_pad={w.k_pad} "
                         f"k_shards={w.k_shards}: unpacked, unpadded weights only")
    meta = dict(dtype=DataType(w.dtype), n_in=int(w.n_in), group_size=int(w.group_size))
    if w.sc6 is None:
        return gq.GroupQuant(codes=_t(w.codes, device, torch.int8),
                             a=_t(w.a, device, torch.bfloat16),
                             b=_t(w.b, device, torch.bfloat16), **meta)
    return gq.GroupQuant(
        codes=_t(w.codes, device, torch.int8), sc6=_t(w.sc6, device, torch.uint8),
        mn6=_t(w.mn6, device, torch.uint8), d=_t(w.d, device, torch.float32),
        dmin=_t(w.dmin, device, torch.float32), **meta)


def repacked_from_numpy(w, device) -> rp.RepackedQuant:
    """A JAX ``RepackedQuant`` with NumPy fields, unstacked or stacked, in the
    TPU layout (K tile-interleaved: storage lane b * G + g holds element
    g * gs + b; nibbles paired across rows 2r, 2r + 1 with a zero row after
    an odd N; high bits tile-major, lane j in byte j % nb at field j // nb)
    -> the port's layout (``ops/repack.py``), with the same bf16 planes."""
    if w.k_shards != 1:
        raise ValueError(f"RepackedQuant k_shards={w.k_shards}: unsharded weights only")
    scales = _t(w.scales, device, torch.bfloat16)
    mins = _t(w.mins, device, torch.bfloat16)
    lead, n, k, gs = tuple(scales.shape[:-2]), scales.shape[-2], int(w.n_in), int(w.group_size)
    codes = np.asarray(w.codes)
    if int(w.code_bits) == 4:
        q = np.stack([codes & 15, codes >> 4], axis=-2).astype(np.int32)
        q = q.reshape(*codes.shape[:-2], 2 * codes.shape[-2], k)[..., :n, :]
    else:
        q = codes.astype(np.int32)
    if int(w.hi_bits):
        hb = int(w.hi_bits)
        hi = np.asarray(w.hi).astype(np.int32)
        q = q + (np.concatenate([(hi >> (p * hb)) & ((1 << hb) - 1) for p in range(8 // hb)],
                                axis=-1) << 4)
    g = k // gs
    q = q.reshape(*q.shape[:-1], gs, g).swapaxes(-1, -2).reshape(q.shape)  # original K order
    flat = [rp.pack(torch.from_numpy(np.ascontiguousarray(qi)).to(device), s, m, DataType(w.dtype))
            for qi, s, m in zip(q.reshape(-1, n, k), scales.reshape(-1, n, g),
                                mins.reshape(-1, n, g))]
    return rp.stack(flat) if lead else flat[0]


def i8sb_from_numpy(w, device) -> i8.I8SBQuant:
    """A JAX ``I8SBQuant`` (codes i8, scales f32), unstacked or stacked."""
    return i8.I8SBQuant(_t(w.codes, device, torch.int8), _t(w.scales, device, torch.float32),
                        int(w.n_in))


def qtensor_from_numpy(w, device) -> QTensor:
    """A JAX ``QTensor`` (packed u8 rows), unstacked or stacked."""
    return QTensor(_t(w.packed, device, torch.uint8), DataType(w.dtype), int(w.n_in))


def _weight(w, device, dtype):
    if isinstance(w, list):
        return [_weight(v, device, dtype) for v in w]
    if hasattr(w, "hi_bits"):
        return repacked_from_numpy(w, device)
    if hasattr(w, "packed"):
        return qtensor_from_numpy(w, device)
    if hasattr(w, "packing"):
        return group_quant_from_numpy(w, device)
    if hasattr(w, "codes"):
        return i8sb_from_numpy(w, device)
    return _t(w, device, dtype)


def _layer_of(w, li: int):
    if isinstance(w, list):
        return w[li]
    if isinstance(w, (gq.GroupQuant, rp.RepackedQuant, i8.I8SBQuant, QTensor)):
        return w.layer(li)
    return w[li]


def llama_params_from_numpy(tree: dict, device: str | torch.device,
                            dtype: torch.dtype = torch.float32) -> dict:
    """JAX ``llama.load_params`` output (NumPy leaves) -> port decoder params."""
    src = tree["layers"]
    n_layer = len(src["attention_norm"])
    names = [n for n in (*FUSED, "wq", "wk", "wv", "wo", "w1", "w2", "w3") if n in src]
    ws = {n: _weight(src[n]["w"], device, dtype) for n in names}
    layers = assemble_layers([{n: _layer_of(w, li) for n, w in ws.items()}
                              for li in range(n_layer)])
    for n in ("attention_norm", "ffn_norm"):
        layers[n] = _t(src[n], device, dtype)
    return {
        "tok_embeddings": _t(tree["tok_embeddings"], device, dtype),
        "norm": _t(tree["norm"], device, dtype),
        "output": {"w": _weight(tree["output"]["w"], device, dtype)},
        "layers": layers,
    }


def _vision_tree(node, device, dtype):
    if isinstance(node, dict):
        return {k: _vision_tree(v, device, dtype) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_vision_tree(v, device, dtype) for v in node]
    return _weight(node, device, dtype)


def vision_params_from_numpy(tree: dict, device: str | torch.device,
                             dtype: torch.dtype = torch.float32) -> dict:
    """JAX ``minigpt4.load_params`` output (NumPy leaves) -> port vision
    params; quantized weights convert as above."""
    return _vision_tree(tree, device, dtype)
