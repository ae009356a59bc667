"""Parameter trees of the JAX package, as NumPy arrays -> the port's trees.

Used by the parity tests so that both implementations compute with the same
weights.  ``GroupQuant`` planes map one to one, in both plane modes; its
codes map one to one where unpacked, and a packed JAX weight (chunk-local
nibbles and bit planes, K padded by ``pad_k_chunks``) is unpacked, stripped
of its pad groups and packed again in the port's K-order layout
(:func:`group_quant_from_numpy`).  ``I8SBQuant`` (codes, scales) and
``QTensor`` (packed bytes) map one to one; a JAX
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


def jax_codes_logical(w) -> np.ndarray:
    """The logical codes ``[..., N, K_stored]`` (i32) of a JAX ``GroupQuant``
    with NumPy fields, its pad columns included: NumPy's counterpart of its
    ``codes_logical``.  JAX packs chunk-locally (chunk = 8 groups, half =
    chunk / 2): nibble byte ``s*half + j`` holds codes ``s*chunk + j`` (low)
    and ``s*chunk + half + j`` (high); p5 bit-plane byte ``s*32 + j`` holds
    bit 4 of code ``s*256 + 32t + j`` at bit t, p6 byte ``s*32 + j`` bits 5:4
    of code ``s*128 + 32t + j`` at bits 2t+1:2t."""
    codes = np.asarray(w.codes)
    if w.packing == "none":
        return codes.astype(np.int32)
    chunk = gq.J * int(w.group_size)
    pk = codes.view(np.uint8)
    lead, kp = pk.shape[:-1], pk.shape[-1]
    nch = 2 * kp // chunk
    pkc = pk.reshape(*lead, nch, chunk // 2).astype(np.int32)
    cc = np.concatenate([pkc & 0xF, pkc >> 4], axis=-1)  # [..., nch, chunk]
    if w.packing in ("p5", "p6"):
        hb = 1 if w.packing == "p5" else 2
        per = 8 // hb  # fields per byte
        hbb = np.asarray(w.hb).view(np.uint8).reshape(*lead, nch, chunk // per).astype(np.int32)
        f = np.stack([(hbb >> (hb * t)) & ((1 << hb) - 1) for t in range(per)], axis=-2)
        cc = cc + (f.reshape(*lead, nch, chunk) << 4)
    return cc.reshape(*lead, 2 * kp)


def group_quant_from_numpy(w, device) -> gq.GroupQuant:
    """A JAX ``GroupQuant`` (either plane mode, unstacked or stacked) with
    NumPy fields.  Unpacked codes and the planes map one to one; packed
    codes are rebuilt by :func:`jax_codes_logical`, the ``k_pad`` zero groups
    (codes, planes) are dropped and ``group_i8.pack_codes`` packs them again
    on ``device``, so the result is the port's own packing of the weight."""
    if w.k_shards != 1:
        raise ValueError(f"GroupQuant k_shards={w.k_shards}: unsharded weights only")
    k, gs = int(w.n_in), int(w.group_size)
    meta = dict(dtype=DataType(w.dtype), n_in=k, group_size=gs)
    codes = _t(jax_codes_logical(w)[..., :k], device, torch.int8)

    def rows(p, n_rows, dtype):  # a plane [..., R, N] without its pad rows
        return _t(np.asarray(p)[..., :n_rows, :], device, dtype)

    if w.sc6 is None:
        out = gq.GroupQuant(codes=codes, a=rows(w.a, k // gs, torch.bfloat16),
                            b=rows(w.b, k // gs, torch.bfloat16), **meta)
    else:
        out = gq.GroupQuant(
            codes=codes, sc6=rows(w.sc6, k // gs, torch.uint8),
            mn6=rows(w.mn6, k // gs, torch.uint8), d=rows(w.d, k // 256, torch.float32),
            dmin=rows(w.dmin, k // 256, torch.float32), **meta)
    return out if w.packing == "none" else gq.pack_codes(out)


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


def probe_planes_from_jax(codes, sct, bt, device) -> tuple[torch.Tensor, torch.Tensor,
                                                            torch.Tensor]:
    """The JAX probe's exact-q5_k operands (``tools/qmm_group_i8.py``:
    codes i8 ``[(L,) N, K]``, bf16 scale and bias planes ``[(L,) K/32, N]``,
    NumPy arrays) -> the arguments of ``ops/probes.qmatmul_group_i8``: the
    same layouts, one to one."""
    return _t(codes, device, torch.int8), _t(sct, device), _t(bt, device)


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
