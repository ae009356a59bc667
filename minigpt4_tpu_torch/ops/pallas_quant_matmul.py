"""The fused dequantize-matmul over repacked weights ("rq").

Counterpart of ``minigpt4_tpu/ops/pallas_quant_matmul.py``: ``x @ W.T`` for
a :class:`~minigpt4_tpu_torch.ops.repack.RepackedQuant` ``W``, where

    y = (scale * q) @ x - groupsum(x) @ mins.

Two hand-written CUDA kernels (``csrc/rq_matmul.cu``) compute it:

* :func:`rq_decode` for at most ``RQ_MAX_M`` rows, with x in f32 and the
  group sums of x formed inside the kernel;
* :func:`rq_prefill` for more rows, with ``w = scale * q - min`` formed in
  f32 and rounded to bf16, x rounded to bf16, and f32 accumulation on the
  tensor cores (``csrc/qmm_prefill.cuh``, launch plan and workspace in
  :mod:`.qmm_prefill`).

Beside them are the plain PyTorch versions: :func:`qmatmul_repacked_ref`
(dequantize to f32, one f32 matmul; the decode kernel's and the reference
both kernels are held to) and :func:`qmatmul_repacked_prefill_ref` (the
prefill kernel's roundings).  A wrapper takes its plain version only for
tensors on the CPU; for CUDA tensors it launches its kernel or raises.

The JAX package falls back to a dense matmul when K is no multiple of the
group size; no ggml block format produces such a weight, so here it is a
``ValueError``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, qmm_prefill
from .repack import RepackedQuant

# M <= RQ_MAX_M rides the decode kernel; larger M the prefill kernel
RQ_MAX_M = 8


def _select(w: RepackedQuant, layer) -> RepackedQuant:
    if w.stacked:
        if layer is None:
            raise ValueError("stacked RepackedQuant requires a layer index")
        return w.layer(int(layer))
    return w


def qmatmul_repacked_ref(x: torch.Tensor, w: RepackedQuant, layer=None) -> torch.Tensor:
    """x [M, K] @ W.T -> f32 [M, N]: dequantize to f32, then one f32 matmul."""
    return x.float() @ _select(w, layer).dequantize().t()


def qmatmul_repacked_prefill_ref(x: torch.Tensor, w: RepackedQuant, layer=None) -> torch.Tensor:
    """bf16(x) @ bf16(scale * q - min).T with f32 accumulation -> f32 [M, N]."""
    xb = x.float().to(torch.bfloat16).float()
    wb = _select(w, layer).dequantize().to(torch.bfloat16).float()
    return xb @ wb.t()


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(fn_name: str, x: torch.Tensor, w: RepackedQuant, layer) -> torch.Tensor:
    _build.refuse_grad(fn_name, x)
    if x.dim() != 2 or x.shape[1] != w.n_in:
        raise ValueError(f"{fn_name}: x must be [M, {w.n_in}], got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"{fn_name}: x must be float32, got {x.dtype}")
    if x.shape[0] < 1:
        raise ValueError(f"{fn_name} needs at least one row")
    for name, t in w.tensors().items():
        if t.device != x.device:
            raise ValueError(f"{fn_name}: {name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{fn_name}: {name} must be contiguous")
    if (w.scales.dtype, w.mins.dtype) != (torch.bfloat16, torch.bfloat16):
        raise TypeError(f"{fn_name}: planes must be bfloat16, got {w.scales.dtype}/{w.mins.dtype}")
    want = {4: torch.uint8, 8: torch.int8}.get(w.code_bits)
    if w.codes.dtype != want or (w.hi is None) != (w.hi_bits == 0) or (
            w.hi is not None and w.hi.dtype != torch.int32):
        raise TypeError(f"{fn_name}: codes {w.codes.dtype} / hi planes do not match "
                        f"code_bits {w.code_bits}, hi_bits {w.hi_bits}")
    if w.n_in % w.group_size or w.n_in % 32:
        raise ValueError(f"{fn_name}: K={w.n_in} is no multiple of 32 and of the group size "
                         f"{w.group_size}; no ggml block format gives such a weight")
    if w.stacked and layer is None:
        raise ValueError("stacked RepackedQuant requires a layer index")
    n_layers = w.scales.shape[0] if w.stacked else 1
    li = int(layer) if w.stacked else 0
    if not 0 <= li < n_layers:
        raise IndexError(f"{fn_name}: layer {li} out of range [0, {n_layers})")
    if w.codes.data_ptr() % 16:
        raise ValueError(f"{fn_name}: codes must be 16-byte aligned")
    x = _aligned(x)
    m, k = x.shape
    n = w.n_out
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    fn = getattr(_build.load(), fn_name)
    stream = ctypes.c_void_p(_build.stream_ptr(x.device))
    _xb, pre = None, ()  # _xb: the bf16 x the launch reads, alive until queued
    if fn_name == "mgt_rq_prefill":  # the workspace of csrc/qmm_prefill.cuh
        _xb, pre = qmm_prefill.launch_args(x, n)
    rc = fn(x.data_ptr(), w.codes.data_ptr(), None if w.hi is None else w.hi.data_ptr(),
            w.scales.data_ptr(), w.mins.data_ptr(), y.data_ptr(), m, n, k, w.group_size,
            w.code_bits, w.hi_bits, li, *pre, stream)
    _build.check(rc, fn_name)
    return y


def rq_decode(x: torch.Tensor, w: RepackedQuant, layer=None) -> torch.Tensor:
    """x f32 [M <= 8, K] @ W.T -> f32 [M, N] (``csrc/rq_matmul.cu``, entry
    ``mgt_rq_decode``)."""
    if x.device.type == "cpu":
        return qmatmul_repacked_ref(x, w, layer)
    if not 1 <= x.shape[0] <= RQ_MAX_M:
        raise ValueError(f"rq_decode serves 1..{RQ_MAX_M} rows, got {x.shape[0]}")
    y = _launch("mgt_rq_decode", x, w, layer)
    rq_decode.launches += 1
    return y


def rq_prefill(x: torch.Tensor, w: RepackedQuant, layer=None) -> torch.Tensor:
    """x f32 [M, K] @ W.T -> f32 [M, N] with bf16 operands
    (``csrc/rq_matmul.cu``, entry ``mgt_rq_prefill``)."""
    if x.device.type == "cpu":
        return qmatmul_repacked_prefill_ref(x, w, layer)
    y = _launch("mgt_rq_prefill", x, w, layer)
    rq_prefill.launches += 1
    return y


rq_decode.launches = 0
rq_prefill.launches = 0


def qmatmul_repacked(x: torch.Tensor, w: RepackedQuant, layer=None) -> torch.Tensor:
    """x [..., K] @ W.T -> [..., N] in x's dtype: M <= RQ_MAX_M rows go to the
    decode kernel, more to the prefill kernel.  ``layer`` selects one layer
    of a stacked weight (an int, or a 0-d integer tensor)."""
    if w.stacked and layer is None:
        raise ValueError("stacked RepackedQuant requires a layer index")
    if w.n_in % w.group_size:
        raise ValueError(f"K={w.n_in} is no multiple of the group size {w.group_size}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, w.n_in).float()
    fn = rq_decode if x2.shape[0] <= RQ_MAX_M else rq_prefill
    return fn(x2, w, layer if w.stacked else None).reshape(*lead, w.n_out).to(x.dtype)
