"""The dequant-matmul probes' functions: plain versions and kernel wrappers.

Counterpart of the Pallas kernels in the JAX package's ``tools/`` probes,
which explored the dequant-matmul design space on the TPU.  Four
hand-written CUDA kernels answer the same questions on the H100; the
micro-benchmarks that drive them are :mod:`minigpt4_tpu_torch.tools`.

* :func:`probe_group_i8` (``csrc/probe_group_i8.cu``,
  ``tools/qmm_group_i8.py``): exact q5_k codes (i8, 0..31) times dual-i8
  activations ``x ~= s1 x1 + s2 x2``; per 32-code group the two exact i32
  dot products, then ``t = s1 c1 + s2 c2`` and ``y += t sc + sgt bt`` in f32.
  :func:`qmatmul_group_i8` splits x and forms the group sums ``sgt`` first,
  with the functions of the production decode kernels
  (``group_i8.split_activations``, ``group_i8.group_sums``).
* :func:`dequant_matvec` (``csrc/probe_qmm.cuh``, ``probe_qmm.cu``,
  ``probe_qmm_km.cu``; the unpack-chain probes ``qmm_variants``,
  ``qmm_v3``, ``qmm_r3``, ``unpack_variants``): ``y = x @ (value(code) *
  s[n, k / 32]).T`` for M <= 8, over a :class:`ProbeWeight` in one of the
  ``STORAGES`` and ``LAYOUTS``, unpacked by one of the ``STRATEGIES`` with
  copies of one of the ``WIDTHS`` (bytes per lane); f32 FMAs at M = 1,
  bf16 tensor cores with x in the three exact parts of
  :func:`split_bf16x3` at M = 2..8.  :func:`matvec_plan` is the launch's
  partition of the output and of K.
* :func:`int_dot` (``csrc/probe_int.cu``, ``tools/probe_int4.py``):
  i8 x i8 -> i32, s4 x s4 -> i32 (``mma.sync`` m16n8k64 .s4), and s4 codes
  x i8 activations with per-256 f32 scales.
* :func:`op_chain` (``csrc/probe_ops.cu``, ``tools/probe_i8ops.py`` and
  ``qmm_v3``'s op-packing probes): REPS elementwise ops per element of an
  ``[N, K]`` tensor; returns the probe's ``[8, 128 N / 256]`` block and a
  checksum per 256-row tile of every result.  :func:`op_chain_plan` is the
  launch's split of the tensor over the grid.

Int4 codes are stored two per byte along K, code 2j in the low nibble of
byte j (the port's K-order, ``ops/repack.py``); signed ones as two's
complement.  Beside each wrapper is its plain version (``*_ref``), which
follows the formula step by step in f32 or exact integers.  A wrapper
takes the plain version only for tensors on the CPU; for CUDA tensors it
launches its kernel or raises.  Each wrapper counts its launches in
``launches``.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from . import _build
from .group_i8 import group_sums, split_activations

GS = 32  # group size of q5_k, and of the probes' scales
SB = 256  # chunk of the dual-i8 kernel and of the s4 superblock scales
MAX_M = 8

# storage name -> (kernel storage code, signed nibbles)
STORAGES = {"dense": (0, False), "i8": (1, False), "u4": (2, False), "i4": (2, True),
            "q5": (3, False), "q5i4": (3, True), "q5d": (4, True)}
STRATEGIES = {"shift": 0, "magic": 1}
LAYOUTS = {"nm": 0, "km": 1}
WIDTHS = (4, 16)
KM_STORAGES = ("dense", "i8", "u4", "i4")
INT_MODES = {"i8xi8": 0, "s4xs4": 1, "s4_sb": 2}
# op name -> (kernel op code, input dtype, c1, c2): the constants of the
# chain, repeated per byte for the packed i8 / u8 forms, bf16 bits for the
# bf16 forms: 1.0, and bf16(1.0009765625) = 1.0 (the JAX probe's multiplier,
# 1 + 2^-10, is below bf16's spacing and rounds to 1)
OPS = {"i8aa": (0, torch.int8, 0x55555555, 0x01010101), "u8and": (1, torch.uint8, 0x55555555, 0),
       "i8mul": (2, torch.int8, 0, 0), "i8add": (3, torch.int8, 0, 0x01010101),
       "i32aa": (4, torch.int32, 0x55, 1), "bf16add": (5, torch.bfloat16, 0x3F803F80, 0),
       "bf16mul": (6, torch.bfloat16, 0x3F803F80, 0), "c8": (7, torch.int8, 0, 0),
       "c32": (8, torch.int32, 0, 0)}
TILE_ROWS = 256
BF16_MUL = float(torch.tensor(1.0009765625, dtype=torch.bfloat16))  # the bf16mul constant, 1.0


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _same_device(fn_name: str, ref: torch.Tensor, **ts) -> None:
    for name, t in ts.items():
        if t is not None and t.device != ref.device:
            raise ValueError(f"{fn_name}: {name} on {t.device}, x on {ref.device}")


def _call(fn_name: str, device, *args) -> None:
    fn = getattr(_build.load(), fn_name)
    rc = fn(*args, ctypes.c_void_p(_build.stream_ptr(device)))
    _build.check(rc, fn_name)


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


# ---------------------------------------------------------------------------
# nibbles
# ---------------------------------------------------------------------------


def pack_nibbles(q: torch.Tensor) -> torch.Tensor:
    """[..., 2 J] values 0..15 -> u8 [..., J], byte j = q[2j] | q[2j+1] << 4."""
    q = q.to(torch.uint8)
    return q[..., 0::2] | (q[..., 1::2] << 4)


def unpack_nibbles(b: torch.Tensor, signed: bool = False) -> torch.Tensor:
    """u8 [..., J] -> int32 [..., 2 J]: the nibbles in K order, two's
    complement where ``signed``."""
    b = b.to(torch.int32)
    q = torch.stack([b & 15, b >> 4], dim=-1).reshape(*b.shape[:-1], 2 * b.shape[-1])
    return (q ^ 8) - 8 if signed else q


# ---------------------------------------------------------------------------
# kernel A: exact q5_k codes x dual-i8 activations
# ---------------------------------------------------------------------------


def _layer(t: torch.Tensor, layer, dims: int) -> torch.Tensor:
    if t.dim() == dims + 1:
        if layer is None:
            raise ValueError("stacked probe weight requires a layer index")
        return t[int(layer)]
    return t


def group_i8_ref(x1, x2, s12, sgt, codes, sct, bt, layer=None) -> torch.Tensor:
    """The kernel's function: per group the exact integer dot products c1, c2
    (f64, exact), then in f32 ``t = s1 c1 + s2 c2`` and the sum over groups
    of ``t sc + sgt bt``, each product and sum rounded on its own."""
    q = _layer(codes, layer, 2).double()
    sc = _layer(sct, layer, 2).float()  # [G, N]
    b = _layer(bt, layer, 2).float()
    m, k = x1.shape
    n, g = q.shape[0], k // GS
    qg = q.reshape(n, g, GS)
    c1 = torch.einsum("mgk,ngk->gmn", x1.double().reshape(m, g, GS), qg).float()
    c2 = torch.einsum("mgk,ngk->gmn", x2.double().reshape(m, g, GS), qg).float()
    s1, s2 = s12[:, 0].reshape(1, m, 1), s12[:, 1].reshape(1, m, 1)
    t = c1 * s1 + c2 * s2
    term = t * sc[:, None, :] + sgt[:, :, None] * b[:, None, :]
    return term.sum(dim=0)


def probe_group_i8(x1, x2, s12, sgt, codes, sct, bt, layer=None) -> torch.Tensor:
    """x1, x2 i8 [M <= 8, K]; s12 f32 [M, 2]; sgt f32 [K/32, M]; codes i8
    [(L,) N, K]; sct, bt bf16 [(L,) K/32, N] -> f32 [M, N]
    (``csrc/probe_group_i8.cu``, entry ``mgt_probe_group_i8``)."""
    if x1.device.type == "cpu":
        return group_i8_ref(x1, x2, s12, sgt, codes, sct, bt, layer)
    fn_name = "mgt_probe_group_i8"
    m, k = x1.shape
    n, g = codes.shape[-2], k // GS
    if not 1 <= m <= MAX_M or k % SB:
        raise ValueError(f"{fn_name}: M in 1..{MAX_M} and K % {SB} == 0, got [{m}, {k}]")
    if (x1.dtype, x2.dtype, codes.dtype) != (torch.int8,) * 3 or x2.shape != x1.shape:
        raise TypeError(f"{fn_name}: x1, x2 and codes must be int8")
    if codes.shape[-1] != k or sct.shape[-2:] != (g, n) or bt.shape != sct.shape:
        raise ValueError(f"{fn_name}: codes [..., N, {k}], planes [..., {g}, N]")
    if (sct.dtype, bt.dtype) != (torch.bfloat16, torch.bfloat16):
        raise TypeError(f"{fn_name}: planes must be bfloat16")
    if tuple(s12.shape) != (m, 2) or tuple(sgt.shape) != (g, m):
        raise ValueError(f"{fn_name}: s12 [{m}, 2] and sgt [{g}, {m}]")
    stacked = codes.dim() == 3
    if stacked != (sct.dim() == 3) or (stacked and (layer is None or not
                                                    0 <= int(layer) < codes.shape[0])):
        raise ValueError(f"{fn_name}: stacked codes and planes need a layer in range")
    _same_device(fn_name, x1, x2=x2, s12=s12, sgt=sgt, codes=codes, sct=sct, bt=bt)
    for name, t in (("codes", codes), ("sct", sct), ("bt", bt)):
        if not t.is_contiguous():
            raise ValueError(f"{fn_name}: {name} must be contiguous")
    if codes.data_ptr() % 16:
        raise ValueError(f"{fn_name}: codes must be 16-byte aligned")
    x1, x2 = _aligned(x1), _aligned(x2)
    s12, sgt = s12.float().contiguous(), sgt.float().contiguous()
    y = torch.empty((m, n), dtype=torch.float32, device=x1.device)
    _call(fn_name, x1.device, x1.data_ptr(), x2.data_ptr(), s12.data_ptr(), sgt.data_ptr(),
          codes.data_ptr(), sct.data_ptr(), bt.data_ptr(), y.data_ptr(), m, n, k,
          int(layer) if stacked else 0)
    probe_group_i8.launches += 1
    return y


probe_group_i8.launches = 0


def qmatmul_group_i8(x, codes, sct, bt, layer=None) -> torch.Tensor:
    """x [M, K] float -> f32 [M, N] = x @ (sc * q + bt).T computed as the
    probe computes it: dual-i8 split of x, group sums, :func:`probe_group_i8`."""
    xf = x.float()
    x1, x2, s1, s2 = split_activations(xf)
    s12 = torch.cat([s1, s2], dim=1)
    return probe_group_i8(x1, x2, s12, group_sums(xf), codes, sct, bt, layer)


def dequant_group_i8(codes, sct, bt, layer=None) -> torch.Tensor:
    """The weight the probe's codes and planes stand for, f32 [N, K]."""
    q = _layer(codes, layer, 2).float()
    sc = _layer(sct, layer, 2).float().t().repeat_interleave(GS, dim=1)
    b = _layer(bt, layer, 2).float().t().repeat_interleave(GS, dim=1)
    return sc * q + b


# ---------------------------------------------------------------------------
# kernel B: the unpack chains' dequantize-matvec
# ---------------------------------------------------------------------------


@dataclass
class ProbeWeight:
    """A weight of the unpack-chain probes, logically ``[N, K]``:
    ``w[n, k] = value(code) * scale[n, k / 32]`` (dense: the bf16 weight).

    nm layout: ``codes`` bf16 / i8 ``[N, K]`` or u8 nibbles ``[N, K/2]``,
    ``scales`` bf16 ``[N, K/32]``; km layout: ``[K, N]``, nibble bytes
    ``[K/2, N]`` (byte (i, n) holds k = 2i, 2i+1), scales ``[K/32, N]``.
    ``hi``: u8 ``[N, K/8]`` for q5 / q5i4 (bit p of byte (n, i) is the high
    bit of k = p K/8 + i), ``[N, K/4]`` for q5d (the high bit of k =
    p K/8 + i is bit p % 4 + 1 of byte (n, (p // 4) K/8 + i))."""

    codes: torch.Tensor
    scales: torch.Tensor | None
    storage: str
    n_out: int
    n_in: int
    layout: str = "nm"
    hi: torch.Tensor | None = None

    def tensors(self) -> list[torch.Tensor]:
        return [t for t in (self.codes, self.hi, self.scales) if t is not None]

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.tensors())


def random_probe_weight(storage: str, n: int, k: int, gen: torch.Generator, device,
                        layout: str = "nm") -> ProbeWeight:
    """Codes, planes and scales from ``gen`` in the probes' ranges: dense
    N(0, 1) bf16, i8 codes -127..126, nibble and plane bytes 0..255, scales
    in [0.5, 1.5) x 2^-9."""
    if storage not in STORAGES or layout not in LAYOUTS:
        raise ValueError(f"unknown storage {storage!r} or layout {layout!r}")
    if layout == "km" and storage not in KM_STORAGES:
        raise ValueError(f"the km layout holds {KM_STORAGES}, not {storage!r}")
    nm = layout == "nm"

    def shape(rows: int, cols: int) -> tuple[int, int]:
        return (rows, cols) if nm else (cols, rows)

    if storage == "dense":
        codes = torch.randn(shape(n, k), generator=gen, device=device).to(torch.bfloat16)
        return ProbeWeight(codes, None, storage, n, k, layout)
    if storage == "i8":
        codes = torch.randint(-127, 127, shape(n, k), generator=gen, device=device,
                              dtype=torch.int8)
    else:
        codes = torch.randint(0, 256, shape(n, k // 2), generator=gen, device=device,
                              dtype=torch.uint8)
    hi = None
    if storage in ("q5", "q5i4", "q5d"):
        hi = torch.randint(0, 256, (n, k // 8 if storage != "q5d" else k // 4), generator=gen,
                           device=device, dtype=torch.uint8)
    scales = (2.0 ** -9 * (0.5 + torch.rand(shape(n, k // GS), generator=gen, device=device))
              ).to(torch.bfloat16)
    return ProbeWeight(codes, scales, storage, n, k, layout, hi)


def high_bits(w: ProbeWeight) -> torch.Tensor:
    """int32 [N, K], the high bit of each code of a q5 / q5i4 / q5d weight."""
    n, k = w.n_out, w.n_in
    nb = k // 8
    h = w.hi.to(torch.int32)
    p = torch.arange(8, device=h.device).reshape(1, 8, 1)
    if w.storage == "q5d":
        h = h.reshape(n, 2, 1, nb).expand(n, 2, 4, nb).reshape(n, 8, nb)
        bits = (h >> (p % 4 + 1)) & 1
    else:
        bits = (h.reshape(n, 1, nb) >> p) & 1
    return bits.reshape(n, k)


def code_values(w: ProbeWeight) -> torch.Tensor:
    """f32 [N, K], value(code) of every weight (the bf16 weight for dense)."""
    storage_code, signed = STORAGES[w.storage]
    c = w.codes if w.layout == "nm" else w.codes.t()
    if w.storage == "dense":
        return c.float()
    if w.storage == "i8":
        return c.float()
    if w.layout == "nm":
        q = unpack_nibbles(w.codes, signed)
    else:  # [K/2, N]: byte (i, n) holds k = 2i (low) and 2i + 1
        q = unpack_nibbles(w.codes.t(), signed)
    if storage_code >= 3:
        q = q + 16 * high_bits(w)
    return q.float()


def dequant_matvec_ref(x: torch.Tensor, w: ProbeWeight) -> torch.Tensor:
    """x [M, K] -> f32 [M, N] = x @ (value(code) * s).T: the weight formed in
    f32 (exact: an 8-bit value times a bf16 scale), one f32 matmul."""
    v = code_values(w)
    if w.scales is not None:
        s = w.scales.float() if w.layout == "nm" else w.scales.float().t()
        v = v * s.repeat_interleave(GS, dim=1)
    return x.float() @ v.t()


def split_bf16x3(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """f32 x as three bf16 parts (hi, mid, lo) whose f32 sum is x exactly,
    the tensor-core path's B operand (``probe_qmm.cuh`` split3): hi =
    RN(x), mid = RN(x - hi), lo = x - hi - mid (each difference exact in f32,
    lo at most 8 significant bits)."""
    x = x.float()
    hi = x.to(torch.bfloat16)
    r = x - hi.float()
    mid = r.to(torch.bfloat16)
    return hi, mid, (r - mid.float()).to(torch.bfloat16)


# the dequantize-matvec's tiling (probe_qmm.cuh Geo): output rows (nm) or
# columns (km) per tile, and codes of K per step
MATVEC_SMS = 132  # the H100 SXM's SMs; the launch asks the device
MATVEC_WARPS = 16  # warps per block, splitting each step's groups


def matvec_geometry(storage: str, layout: str, m: int) -> dict:
    """The launch's constants for one instance (probe_qmm.cuh ``Geo``):
    ``tile`` rows per tile, ``chunk`` rows per chunk, ``fields`` and
    ``step`` codes of each field per step, ``warp_groups`` groups per warp
    and step, ``tile_sets`` of warps splitting a chunk's tiles, and
    ``cluster``, the most blocks that split K for the same rows (km)."""
    code, _ = STORAGES[storage]
    km, fma = layout == "km", m == 1
    ks = (256 if code == 2 else 128) if km else 1024 if code == 2 else 512
    fields = 8 if code >= 3 else 1
    sets = 4 if km else 1
    return {"tile": 16 if (not fma or km) else 8, "chunk": 160 if km else 48, "fields": fields,
            "step": ks // fields, "warp_groups": ks // 32 // (MATVEC_WARPS // sets),
            "tile_sets": sets, "cluster": 8 if km else 1}


def matvec_plan(n: int, k: int, m: int, storage: str, layout: str = "nm",
                sms: int = MATVEC_SMS) -> list[dict]:
    """Per block of the persistent grid: its ``rows`` (nm; km: columns, in
    whole 16-column units, shared by the ``cluster`` blocks that split K),
    its cluster ``rank`` and its chunks, each ``(rows, steps)`` with
    ``rows`` the output rows (nm) or columns (km) ``[n0, n1)`` and
    ``steps`` the field-local ranges ``[i0, i1)`` of K that its steps copy
    (every field of a high-bit storage walks the same range; field f covers
    k = f K / 8 + i).  Within a step the warps take the groups ``[w g, (w +
    1) g)`` of the step's 32-code groups, g = ``warp_groups``.  The kernel's
    own formulas (probe_qmm.cuh qmm_body; km takes ``sms`` / 8 clusters,
    where the launch asks the device how many fit at once), for the tests."""
    geo = matvec_geometry(storage, layout, m)
    tr, ct = geo["tile"], geo["chunk"] // geo["tile"]
    nb, step = k // geo["fields"], geo["step"]
    steps_all = -(-nb // step)
    if layout == "km":  # clusters on runs of whole 16-column units
        unit, csize = 16, min(geo["cluster"], steps_all)
        clusters = min(sms // geo["cluster"], n // 16)
    else:
        unit, csize, clusters = 1, 1, min(-(-n // tr), sms)
    blocks = []
    for b in range(clusters * csize):
        cid, rk = divmod(b, csize)
        b0 = unit * (n // unit * cid // clusters)
        b1 = unit * (n // unit * (cid + 1) // clusters)
        sb, se = steps_all * rk // csize, steps_all * (rk + 1) // csize
        ntb = -(-(b1 - b0) // tr)  # tiles, the last one cut at b1
        nch = -(-ntb // ct)
        chunks = []
        for ci in range(nch):
            lo, hi = ntb * ci // nch, ntb * (ci + 1) // nch
            rows = (b0 + lo * tr, min(b0 + hi * tr, b1))
            chunks.append({"rows": rows, "steps": [(st * step, min((st + 1) * step, nb))
                                                   for st in range(sb, se)]})
        blocks.append({"rows": (b0, b1), "rank": rk, "chunks": chunks})
    return blocks


def dequant_matvec(x: torch.Tensor, w: ProbeWeight, strategy: str = "shift",
                   width: int = 16) -> torch.Tensor:
    """x f32 [M <= 8, K] @ W.T -> f32 [M, N] by the unpack ``strategy`` with
    ``width``-byte loads (``csrc/probe_qmm.cu``, entry
    ``mgt_probe_dequant_matvec``)."""
    if x.device.type == "cpu":
        return dequant_matvec_ref(x, w)
    fn_name = "mgt_probe_dequant_matvec"
    m, k = x.shape
    n = w.n_out
    if not 1 <= m <= MAX_M or k != w.n_in or x.dtype != torch.float32:
        raise ValueError(f"{fn_name}: x must be float32 [1..{MAX_M}, {w.n_in}], got {x.dtype} "
                         f"{tuple(x.shape)}")
    if strategy not in STRATEGIES or width not in WIDTHS or w.layout not in LAYOUTS:
        raise ValueError(f"{fn_name}: strategy {strategy!r}, width {width}, layout {w.layout!r}")
    if w.storage == "dense" and strategy != "shift":
        raise ValueError(f"{fn_name}: dense weights take the shift strategy only")
    if w.layout == "km" and (w.storage not in KM_STORAGES or n % 16):
        raise ValueError(f"{fn_name}: km holds {KM_STORAGES} with N % 16 == 0")
    hb = STORAGES[w.storage][0] >= 3
    if k % (SB if hb else GS):
        raise ValueError(f"{fn_name}: K={k} must be a multiple of {SB if hb else GS}")
    _same_device(fn_name, x, codes=w.codes, hi=w.hi, scales=w.scales)
    for t in w.tensors():
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{fn_name}: codes, planes and scales must be contiguous and "
                             "16-byte aligned")
    x = _aligned(x)
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    storage, signed = STORAGES[w.storage]
    _call(fn_name, x.device, x.data_ptr(), w.codes.data_ptr(), _ptr(w.hi), _ptr(w.scales),
          y.data_ptr(), m, n, k, storage, int(signed), STRATEGIES[strategy], width,
          LAYOUTS[w.layout])
    dequant_matvec.launches += 1
    return y


dequant_matvec.launches = 0


# ---------------------------------------------------------------------------
# kernel C: integer dots with i8 and int4 operands
# ---------------------------------------------------------------------------


def int_dot_ref(x: torch.Tensor, w: torch.Tensor, scales: torch.Tensor | None,
                mode: str) -> torch.Tensor:
    """The exact integer result (f64 products, exact below 2^53) as int32
    [M, N] for i8xi8 (x, w i8) and s4xs4 (x, w nibble bytes); for s4_sb (x
    i8, w nibble bytes, scales f32 [N, K/256]) the exact i32 of each
    256-wide chunk times its scale, added in chunk order in f32."""
    xv = unpack_nibbles(x, signed=True) if mode == "s4xs4" else x
    wv = unpack_nibbles(w, signed=True) if mode != "i8xi8" else w
    if mode != "s4_sb":
        return (xv.double() @ wv.double().t()).to(torch.int32)
    m, k = xv.shape
    acc = torch.zeros((m, wv.shape[0]), dtype=torch.float32, device=x.device)
    for g in range(k // SB):
        c = slice(g * SB, (g + 1) * SB)
        p = (xv[:, c].double() @ wv[:, c].double().t()).float()
        acc = acc + p * scales[:, g]
    return acc


def int_dot(x: torch.Tensor, w: torch.Tensor, scales: torch.Tensor | None,
            mode: str) -> torch.Tensor:
    """The :func:`int_dot_ref` function (``csrc/probe_int.cu``, entry
    ``mgt_probe_int_dot``); s4xs4 on ``mma.sync`` m16n8k64 .s4."""
    if x.device.type == "cpu":
        return int_dot_ref(x, w, scales, mode)
    fn_name = "mgt_probe_int_dot"
    if mode not in INT_MODES:
        raise ValueError(f"{fn_name}: mode {mode!r} not in {tuple(INT_MODES)}")
    nib_x, nib_w = mode == "s4xs4", mode != "i8xi8"
    m = x.shape[0]
    k = x.shape[1] * (2 if nib_x else 1)
    n = w.shape[0]
    if (x.dtype, w.dtype) != (torch.uint8 if nib_x else torch.int8,
                              torch.uint8 if nib_w else torch.int8):
        raise TypeError(f"{fn_name} {mode}: x {x.dtype}, w {w.dtype}")
    if w.shape[1] * (2 if nib_w else 1) != k or k % SB:
        raise ValueError(f"{fn_name}: K must agree and be a multiple of {SB}")
    if not 1 <= m <= (16 if mode == "s4xs4" else MAX_M):
        raise ValueError(f"{fn_name} {mode}: M={m} out of range")
    if mode == "s4_sb" and (scales is None or scales.dtype != torch.float32
                            or tuple(scales.shape) != (n, k // SB)):
        raise ValueError(f"{fn_name}: s4_sb needs f32 scales [{n}, {k // SB}]")
    _same_device(fn_name, x, w=w, scales=scales)
    x, w = _aligned(x), _aligned(w)
    if scales is not None:
        scales = scales.contiguous()
    y = torch.empty((m, n), dtype=torch.float32 if mode == "s4_sb" else torch.int32,
                    device=x.device)
    _call(fn_name, x.device, x.data_ptr(), w.data_ptr(),
          _ptr(scales) if mode == "s4_sb" else None, y.data_ptr(), INT_MODES[mode], m, n, k)
    int_dot.launches += 1
    return y


int_dot.launches = 0


# ---------------------------------------------------------------------------
# kernel D: elementwise op chains
# ---------------------------------------------------------------------------


def _chain(v: torch.Tensor, op: str, reps: int) -> torch.Tensor:
    if op in ("c8", "c32"):
        acc = v.to(torch.bfloat16)
        for i in range(1, reps):
            acc = acc + (v + i).to(torch.bfloat16)
        return acc
    for _ in range(reps):
        if op in ("i8aa", "i32aa"):
            v = (v & 0x55) + 1
        elif op == "u8and":
            v = v & 0x55
        elif op == "i8mul":
            v = v * 3
        elif op == "i8add":
            v = v + 1
        elif op == "bf16add":
            v = v + 1.0
        elif op == "bf16mul":
            v = v * BF16_MUL
    return v


def op_chain_ref(inp: torch.Tensor, op: str, reps: int = 8):
    """(out f32 [8, 128 T], cks int64 [T]): the chain's results at rows 256 t
    + r < 256 t + 8, columns < 128, and per 256-row tile the sum mod 2^32 of
    the result tensor's bytes read as 32-bit words."""
    res = _chain(inp, op, reps).contiguous()
    rows, cols = res.shape
    t = rows // TILE_ROWS
    out = res.reshape(t, TILE_ROWS, cols)[:, :8, :128].float().permute(1, 0, 2).reshape(8, 128 * t)
    words = res.view(torch.int32).reshape(t, -1).to(torch.int64)
    return out, words.sum(dim=1) & 0xFFFFFFFF


OP_CHUNK = 1024  # 16-byte vectors per chunk of the op-chain kernel: 4 per thread of 256


def op_chain_plan(rows: int, cols: int, esize: int, resident: int) -> list[list[tuple]]:
    """Per block of the grid: the ``(tile, first, end)`` vector ranges it
    streams, counted from the tile's start (the kernel's split,
    ``csrc/probe_ops.cu``: chunks of ``OP_CHUNK`` vectors, a whole number
    per tile, taken interleaved by a grid of at most ``resident`` blocks
    trimmed so that every block takes the same number of chunks, give or
    take one)."""
    cpt = cols * esize // 16 * TILE_ROWS // OP_CHUNK
    chunks = rows // TILE_ROWS * cpt
    rounds = -(-chunks // resident)
    grid = -(-chunks // rounds)
    return [[(ch // cpt, ch % cpt * OP_CHUNK, (ch % cpt + 1) * OP_CHUNK)
             for ch in range(b, chunks, grid)] for b in range(grid)]


def op_chain(inp: torch.Tensor, op: str, reps: int = 8, widen: bool = True):
    """The :func:`op_chain_ref` function (``csrc/probe_ops.cu``, entry
    ``mgt_probe_op_chain``); returns (out, cks) as it does.  ``widen=False``
    returns the kernel's checksum words as int32 (their bits the u32 sums),
    without the int64 widening, which costs two small elementwise kernels
    (the tools time the launch so)."""
    if inp.device.type == "cpu":
        return op_chain_ref(inp, op, reps)
    fn_name = "mgt_probe_op_chain"
    if op not in OPS:
        raise ValueError(f"{fn_name}: op {op!r} not in {tuple(OPS)}")
    code, dtype, c1, c2 = OPS[op]
    rows, cols = inp.shape
    if inp.dtype != dtype or rows % TILE_ROWS or cols % 128 or reps < 1:
        raise ValueError(f"{fn_name} {op}: {dtype} [256 t, 128 j] and reps >= 1, got "
                         f"{inp.dtype} {tuple(inp.shape)}, reps {reps}")
    inp = _aligned(inp)
    t = rows // TILE_ROWS
    out = torch.empty((8, 128 * t), dtype=torch.float32, device=inp.device)
    cks = torch.zeros(t, dtype=torch.int32, device=inp.device)
    _call(fn_name, inp.device, inp.data_ptr(), out.data_ptr(), cks.data_ptr(), code, rows, cols,
          reps, c1, c2)
    op_chain.launches += 1
    return (out, cks.to(torch.int64) & 0xFFFFFFFF) if widen else (out, cks)


op_chain.launches = 0

WRAPPERS = {"probe_group_i8": probe_group_i8, "dequant_matvec": dequant_matvec,
            "int_dot": int_dot, "op_chain": op_chain}
