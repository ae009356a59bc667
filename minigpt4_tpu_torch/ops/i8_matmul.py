"""W8A8 matmul ("w8a8"): i8 weight codes times i8 activations.

Counterpart of ``minigpt4_tpu/ops/i8_matmul.py`` (``quant_mode="w8a8"``).

  * Weights requantize once at load to symmetric i8 codes with one f32
    scale per 256-wide superblock (:func:`requantize_i8sb`);
    :func:`from_ggml` decodes the ggml bytes on the device and can fold
    smooth-quant migration factors in first.
  * Activations quantize per row to i8, absmax / 127
    (:func:`quantize_activations`).
  * The contraction is i8 x i8 -> an exact i32 per 256-wide chunk, and
    ``f32(chunk) * scale[n, g]`` is added to an f32 accumulator in a fixed
    order; the per-row activation scale multiplies the result.

Per-token absmax activation quantization is open to LLaMA's activation
outliers; ``quality.py`` measures that, and smooth-quant scales move the
outliers into the weights.  1 B per weight plus 1/64 B of scales; the
JAX package pairs this mode with the e4m3 KV cache (``cache_dtype="f8"``).

Two hand-written CUDA kernels (``csrc/i8_matmul.cu``): :func:`i8_decode`
for at most ``I8_MAX_M`` rows, the whole matmul from f32 x in one launch
(quantization, contraction, row scale), and :func:`i8_prefill` (s8 tensor
cores) for more, on x quantized here.  Beside them the plain versions,
:func:`qmatmul_i8sb_decode_ref` and :func:`qmatmul_i8sb_ref`.  A wrapper
takes its plain version only for tensors on the CPU; for CUDA tensors it
launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from ..formats import DataType
from . import _build
from .dequant import dequantize
from .quant_matmul import QTensor

SB = 256  # superblock width: one scale and one exact i32 chunk per 256 codes
I8_MAX_M = 8  # M <= I8_MAX_M rides the decode kernel; larger M the prefill kernel
ROW_BLOCK = 4096  # weight rows decoded and requantized at a time in from_ggml


@dataclass
class I8SBQuant:
    """Symmetric i8 weight with per-256-superblock f32 scales, logically
    ``w[n, k] = codes[n, k] * scales[n, k // 256]``."""

    codes: torch.Tensor  # i8 [(L,) N, K]
    scales: torch.Tensor  # f32 [(L,) N, K / 256]
    n_in: int

    @property
    def n_out(self) -> int:
        return self.codes.shape[-2]

    @property
    def stacked(self) -> bool:
        return self.codes.dim() == 3

    def layer(self, li: int) -> "I8SBQuant":
        return I8SBQuant(self.codes[li], self.scales[li], self.n_in)

    def dequantize(self, out_dtype=torch.float32) -> torch.Tensor:
        """``[(L,) N, K]``: codes times their superblock scale."""
        s = torch.repeat_interleave(self.scales, SB, dim=-1)
        return (self.codes.float() * s).to(out_dtype)


def stack(ws: list[I8SBQuant]) -> I8SBQuant:
    if any(w.n_in != ws[0].n_in for w in ws):
        raise ValueError("stacked I8SBQuant layers must share K")
    return I8SBQuant(torch.stack([w.codes for w in ws]), torch.stack([w.scales for w in ws]),
                     ws[0].n_in)


def concat_out(ws: list[I8SBQuant]) -> I8SBQuant:
    """Fuse weights of one input width along the output axis (the JAX
    package's fusion criterion: equal ``n_in``)."""
    if any(w.n_in != ws[0].n_in for w in ws):
        raise ValueError("fused I8SBQuant parts must share K")
    return I8SBQuant(torch.cat([w.codes for w in ws], dim=-2),
                     torch.cat([w.scales for w in ws], dim=-2), ws[0].n_in)


def requantize_i8sb(values: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 [N, K] -> (codes i8 [N, K], scales f32 [N, K / 256]); K % 256 == 0.
    The JAX package's operations: absmax / 127 (0 -> 1), round half to even,
    clip to +-127."""
    n, k = values.shape
    v = values.reshape(n, k // SB, SB)
    s = v.abs().amax(dim=2) / 127.0
    s = torch.where(s == 0, torch.ones_like(s), s)
    q = torch.round(v / s[:, :, None]).clamp(-127, 127).to(torch.int8)
    return q.reshape(n, k), s


def from_ggml(raw, shape: tuple[int, int], dtype: DataType, device: str | torch.device,
              col_scale=None, row_scale=None) -> I8SBQuant:
    """ggml bytes of an ``[N, K]`` weight -> :class:`I8SBQuant`, decoded on
    ``device`` (``ops/dequant.py``) in blocks of ``ROW_BLOCK`` rows and
    requantized there.  ``col_scale`` [K] / ``row_scale`` [N]: smooth-quant
    migration factors folded in first, ``w'[n, k] = w[n, k] * col_scale[k] *
    row_scale[n]``."""
    dtype = DataType(dtype)
    n_out, n_in = shape
    if n_in % SB:
        raise ValueError(f"K={n_in} not a multiple of the {SB} superblock")
    packed = QTensor.from_raw(raw, shape, dtype, device).packed
    cs = None if col_scale is None else torch.as_tensor(
        col_scale, dtype=torch.float32).reshape(1, n_in).to(device)
    rs = None if row_scale is None else torch.as_tensor(
        row_scale, dtype=torch.float32).reshape(n_out, 1).to(device)
    codes = torch.empty((n_out, n_in), dtype=torch.int8, device=device)
    scales = torch.empty((n_out, n_in // SB), dtype=torch.float32, device=device)
    for r0 in range(0, n_out, ROW_BLOCK):
        r1 = min(r0 + ROW_BLOCK, n_out)
        vals = dequantize(packed[r0:r1], dtype)
        if cs is not None:
            vals = vals * cs
        if rs is not None:
            vals = vals * rs[r0:r1]
        codes[r0:r1], scales[r0:r1] = requantize_i8sb(vals)
    return I8SBQuant(codes, scales, n_in)


def quantize_activations(x2: torch.Tensor, sx: torch.Tensor | None = None):
    """[M, K] floats -> (i8 codes [M, K], f32 row scales [M, 1]), absmax
    symmetric; ``sx`` overrides the row scales."""
    xf = x2.float()
    if sx is None:
        sx = xf.abs().amax(dim=-1, keepdim=True) / 127.0
        sx = torch.where(sx == 0, torch.ones_like(sx), sx)
    return torch.round(xf / sx).clamp(-127, 127).to(torch.int8), sx


# ---------------------------------------------------------------------------
# plain version and kernel wrappers
# ---------------------------------------------------------------------------


def _select(w: I8SBQuant, layer) -> I8SBQuant:
    if w.stacked:
        if layer is None:
            raise ValueError("stacked I8SBQuant requires a layer index")
        return w.layer(int(layer))
    return w


def qmatmul_i8sb_ref(x_i8: torch.Tensor, w: I8SBQuant, layer=None) -> torch.Tensor:
    """i8 [M, K] x codes -> f32 [M, N] before the row scale: per 256-wide
    chunk the exact integer product (in f64, exact for i8 x i8 x 256), times
    the chunk's scale, summed in chunk order in f32."""
    w = _select(w, layer)
    m, k = x_i8.shape
    x = x_i8.double()
    acc = torch.zeros((m, w.n_out), dtype=torch.float32, device=x_i8.device)
    for g in range(k // SB):
        c = slice(g * SB, (g + 1) * SB)
        p = (x[:, c] @ w.codes[:, c].double().t()).float()
        acc = acc + p * w.scales[:, g]
    return acc


def qmatmul_i8sb_decode_ref(x: torch.Tensor, w: I8SBQuant, layer=None,
                            x_scale=None) -> torch.Tensor:
    """f32 [M, K] -> f32 [M, N], the whole w8a8 matmul step by step:
    :func:`quantize_activations` (``x_scale`` [M, 1] overrides the row
    scales), :func:`qmatmul_i8sb_ref`, times the row scales."""
    x_i8, sx = quantize_activations(x, x_scale)
    return qmatmul_i8sb_ref(x_i8, w, layer) * sx


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(fn_name: str, x: torch.Tensor, w: I8SBQuant, layer, x_dtype: torch.dtype,
            x_scale=None) -> torch.Tensor:
    _build.refuse_grad(fn_name, x, x_scale)
    if x.dim() != 2 or x.shape[1] != w.n_in or x.dtype != x_dtype:
        raise ValueError(f"{fn_name}: x must be {x_dtype} [M, {w.n_in}], got {x.dtype} "
                         f"{tuple(x.shape)}")
    if x.shape[0] < 1:
        raise ValueError(f"{fn_name} needs at least one row")
    if w.codes.dtype != torch.int8 or w.scales.dtype != torch.float32:
        raise TypeError(f"{fn_name}: codes int8 and scales float32, got {w.codes.dtype}/"
                        f"{w.scales.dtype}")
    for name, t in (("codes", w.codes), ("scales", w.scales)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{fn_name}: {name} must be contiguous on {x.device}")
    if w.stacked and layer is None:
        raise ValueError("stacked I8SBQuant requires a layer index")
    n_layers = w.codes.shape[0] if w.stacked else 1
    li = int(layer) if w.stacked else 0
    if not 0 <= li < n_layers:
        raise IndexError(f"{fn_name}: layer {li} out of range [0, {n_layers})")
    if w.codes.data_ptr() % 16:
        raise ValueError(f"{fn_name}: codes must be 16-byte aligned")
    x = _aligned(x)
    m, k = x.shape
    scale = ()  # the decode entry's row scales, f32 [M] or null
    if fn_name == "mgt_i8_decode":
        if x_scale is not None:
            x_scale = x_scale.reshape(-1).contiguous()
            if x_scale.shape != (m,) or x_scale.dtype != torch.float32 or (
                    x_scale.device != x.device):
                raise ValueError(f"{fn_name}: x_scale must be float32 [{m}, 1] on {x.device}")
        scale = (None if x_scale is None else x_scale.data_ptr(),)
    y = torch.empty((m, w.n_out), dtype=torch.float32, device=x.device)
    rc = getattr(_build.load(), fn_name)(
        x.data_ptr(), *scale, w.codes.data_ptr(), w.scales.data_ptr(), y.data_ptr(), m,
        w.n_out, k, li, ctypes.c_void_p(_build.stream_ptr(x.device)))
    _build.check(rc, fn_name)
    return y


def i8_decode(x: torch.Tensor, w: I8SBQuant, layer=None, x_scale=None) -> torch.Tensor:
    """f32 [M <= 8, K] -> f32 [M, N]: the whole w8a8 matmul in one launch
    (``csrc/i8_matmul.cu``, entry ``mgt_i8_decode``): x quantized per row as
    :func:`quantize_activations` does it (``x_scale`` [M, 1] overrides the
    row scales), the chunked i8 contraction, the row scale."""
    if x.device.type == "cpu":
        return qmatmul_i8sb_decode_ref(x, w, layer, x_scale)
    if not 1 <= x.shape[0] <= I8_MAX_M:
        raise ValueError(f"i8_decode serves 1..{I8_MAX_M} rows, got {x.shape[0]}")
    y = _launch("mgt_i8_decode", x, w, layer, torch.float32, x_scale)
    i8_decode.launches += 1
    return y


def i8_prefill(x_i8: torch.Tensor, w: I8SBQuant, layer=None) -> torch.Tensor:
    """i8 [M, K] x codes -> f32 [M, N] before the row scale on the s8 tensor
    cores (``csrc/i8_matmul.cu``, entry ``mgt_i8_prefill``)."""
    if x_i8.device.type == "cpu":
        return qmatmul_i8sb_ref(x_i8, w, layer)
    y = _launch("mgt_i8_prefill", x_i8, w, layer, torch.int8)
    i8_prefill.launches += 1
    return y


i8_decode.launches = 0
i8_prefill.launches = 0


def qmatmul_i8sb(x: torch.Tensor, w: I8SBQuant, layer=None, x_scale=None) -> torch.Tensor:
    """x [..., K] @ w.T -> [..., N] in x's dtype: per-row i8 activation
    quantization, the chunked i8 contraction, the row scale.  ``layer`` selects one layer of a
    stacked weight; ``x_scale`` [..., 1] overrides the row scales."""
    k = w.codes.shape[-1]
    if w.stacked and layer is None:
        raise ValueError("stacked I8SBQuant requires a layer index")
    if k % SB:
        raise ValueError(f"I8SBQuant K={k} is not a multiple of {SB}")
    if x.device.type != "cpu":  # the prefill branch quantizes x before its launch
        _build.refuse_grad("qmatmul_i8sb", x, x_scale)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k).float()
    sx = None if x_scale is None else x_scale.reshape(-1, 1).float()
    layer = layer if w.stacked else None
    if x2.shape[0] <= I8_MAX_M:
        y = i8_decode(x2, w, layer, sx)
    else:
        x_i8, sx = quantize_activations(x2, sx)
        y = i8_prefill(x_i8, w, layer) * sx
    return y.reshape(*lead, w.n_out).to(x.dtype)
