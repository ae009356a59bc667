"""Port parity for the w8a8 path and the packed-bytes form: the port's
``ops/i8_matmul.py``, ``ops/dequant.py`` and ``ops/quant_matmul.py`` on the
CPU against the JAX package's (``qmatmul_i8sb`` with its Pallas kernel in
interpret mode), on the same numpy inputs.

Tolerances: the requantization and the activation quantization repeat the
JAX package's operations and are held bit-equal; the packed-bytes decode
is bit-equal to the JAX package's XLA decode for every format it covers.
``from_ggml`` decodes on the device with those decoders while the JAX
package decodes on the host with ``formats.quants``: the share of codes
that differ is measured (at most 1e-3, each by +-1, scales within 1 ulp;
the measured share is 0 for every format here).  The product: the i32 chunk
products are exact on both sides, the f32 sum over chunks runs in the same
order, so 1e-5 of max|y|.  The decode path's plain version
(``qmatmul_i8sb_decode_ref``: quantization, contraction and row scale, the
function the fused decode kernel computes in one launch) is held to JAX's
``qmatmul_i8sb`` at 1e-5 with and without a caller's row scale; the
kernel's reciprocal quotient (x * RN(1/s), the IEEE quotient near a
half-integer), emulated step by step in f32, gives ``torch.round(x / s)``
bit for bit on a seeded sweep with exact and near ties.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from minigpt4_tpu.formats import quants as nq
from minigpt4_tpu.formats.dtypes import DataType
from minigpt4_tpu.models import params as jparams
from minigpt4_tpu.ops import i8_matmul as ji8
from minigpt4_tpu_torch.models.params import linear, load_quant_weight
from minigpt4_tpu_torch.ops import i8_matmul as ti8
from minigpt4_tpu_torch.ops.quant_matmul import QTensor
from minigpt4_tpu_torch.ops.repack import RepackedQuant

# one intra-op thread: the suite runs several pytest-xdist workers on the same cores, where
# torch's OpenMP pools spin against each other and run ~17x slower
torch.set_num_threads(1)

REPACKABLE = [DataType.Q4_0, DataType.Q4_1, DataType.Q5_0, DataType.Q5_1, DataType.Q8_0,
              DataType.Q2_K, DataType.Q3_K, DataType.Q4_K, DataType.Q5_K, DataType.Q6_K]
# every format of the JAX package's DEQUANT_FNS
DEQUANT = REPACKABLE + [DataType.Q8_K, DataType.F16, DataType.F32]


def _raw(dtype, n, k, seed=0):
    vals = np.random.default_rng(seed).normal(0, 0.6, (n, k)).astype(np.float32)
    if dtype == DataType.F16:
        return vals.astype("<f2").view(np.uint8).reshape(-1)
    if dtype == DataType.F32:
        return vals.astype("<f4").view(np.uint8).reshape(-1)
    return nq.quantize(vals, dtype)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-12)


@pytest.mark.parametrize("shape,zero_block", [((16, 512), False), ((7, 768), True)])
def test_requantize_bit_equal_to_jax(shape, zero_block):
    v = np.random.default_rng(1).normal(0, 0.5, shape).astype(np.float32)
    v[:, :4] *= 50.0  # an outlier column per superblock row
    if zero_block:
        v[2, 256:512] = 0.0  # an all-zero superblock: scale 1, codes 0
    jc, js = ji8.requantize_i8sb(v)
    tc, ts = ti8.requantize_i8sb(torch.from_numpy(v))
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32
    assert np.array_equal(tc.numpy(), jc) and np.array_equal(ts.numpy(), js)


def test_quantize_activations_bit_equal_to_jax():
    x = np.random.default_rng(2).normal(0, 1, (9, 512)).astype(np.float32)
    x[3] = 0.0  # a zero row: scale 1
    x[5, 7] = 80.0  # an outlier
    jx, jsx = ji8.quantize_activations(jnp.asarray(x))
    tx, tsx = ti8.quantize_activations(torch.from_numpy(x))
    assert np.array_equal(tx.numpy(), np.asarray(jx)) and np.array_equal(tsx.numpy(),
                                                                        np.asarray(jsx))
    # an external row scale (the K-sharded path's global absmax)
    sx = np.full((9, 1), 0.05, np.float32)
    jx, _ = ji8.quantize_activations(jnp.asarray(x), jnp.asarray(sx))
    tx, _ = ti8.quantize_activations(torch.from_numpy(x), torch.from_numpy(sx))
    assert np.array_equal(tx.numpy(), np.asarray(jx))


def _code_share(tw, jw):
    """(share of codes that differ, max |code diff|, max scale diff in ulps)."""
    tc, jc = tw.codes.numpy().astype(np.int32), np.asarray(jw.codes).astype(np.int32)
    ts, js = tw.scales.numpy(), np.asarray(jw.scales)
    ulps = np.abs(ts.view(np.int32).astype(np.int64) - js.view(np.int32).astype(np.int64))
    return float((tc != jc).mean()), int(np.abs(tc - jc).max()), int(ulps.max())


@pytest.mark.parametrize("smooth", ["none", "col", "col+row"])
@pytest.mark.parametrize("dtype", REPACKABLE + [DataType.F16, DataType.F32],
                         ids=lambda d: d.name.lower())
def test_from_ggml_matches_jax(dtype, smooth):
    n, k = 40, 512
    raw = _raw(dtype, n, k, seed=int(dtype))
    rng = np.random.default_rng(5)
    cs = rng.uniform(0.2, 5.0, k).astype(np.float32) if smooth != "none" else None
    rs = rng.uniform(0.2, 5.0, n).astype(np.float32) if smooth == "col+row" else None
    jw = ji8.from_ggml(raw, (n, k), dtype, col_scale=cs, row_scale=rs)
    tw = ti8.from_ggml(raw, (n, k), dtype, "cpu", col_scale=cs, row_scale=rs)
    assert tw.codes.shape == (n, k) and tw.scales.shape == (n, k // 256) and tw.n_in == k
    share, max_diff, max_ulps = _code_share(tw, jw)
    assert share <= 1e-3 and max_diff <= 1 and max_ulps <= 1, (share, max_diff, max_ulps)
    assert share == 0.0 and max_ulps == 0  # measured: bit-equal for every format here


@pytest.mark.parametrize("stacked", [False, True], ids=["unstacked", "stacked"])
@pytest.mark.parametrize("m", [1, 8, 33])
def test_qmatmul_matches_jax(m, stacked):
    n, k, layers = 96, 768, 3
    rng = np.random.default_rng(m)
    vs = rng.normal(0, 0.5, (layers, n, k)).astype(np.float32)
    packs = [ji8.requantize_i8sb(v) for v in vs]
    x = rng.normal(0, 1, (m, k)).astype(np.float32)
    if stacked:
        jw = ji8.I8SBQuant(jnp.asarray(np.stack([c for c, _ in packs])),
                           jnp.asarray(np.stack([s for _, s in packs])), k)
        tw = ti8.I8SBQuant(torch.from_numpy(np.stack([c for c, _ in packs])),
                           torch.from_numpy(np.stack([s for _, s in packs])), k)
        layer = 1
    else:
        jw = ji8.I8SBQuant(jnp.asarray(packs[0][0]), jnp.asarray(packs[0][1]), k)
        tw = ti8.I8SBQuant(torch.from_numpy(packs[0][0]), torch.from_numpy(packs[0][1]), k)
        layer = None
    want = np.asarray(ji8.qmatmul_i8sb(jnp.asarray(x), jw, out_dtype=jnp.float32, layer=layer))
    got = ti8.qmatmul_i8sb(torch.from_numpy(x), tw, layer)
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= 1e-5
    # and through the decoder's linear
    got_lin = linear(torch.from_numpy(x), {"w": tw}, layer if stacked else None)
    assert torch.equal(got_lin, got)


@pytest.mark.parametrize("scaled", [False, True], ids=["absmax", "x_scale"])
@pytest.mark.parametrize("stacked", [False, True], ids=["unstacked", "stacked"])
@pytest.mark.parametrize("m", [1, 5, 8])
def test_decode_plain_matches_jax(m, stacked, scaled):
    n, k, layers = 96, 768, 3
    rng = np.random.default_rng(10 + m)
    vs = rng.normal(0, 0.5, (layers, n, k)).astype(np.float32)
    packs = [ji8.requantize_i8sb(v) for v in vs]
    x = rng.normal(0, 1, (m, k)).astype(np.float32)
    x[0, :3] = 0.0
    # a caller's scale: the global absmax over two ranks' halves of K, as
    # the K-sharded linear passes it, here above each row's own
    sx = (np.abs(x).max(axis=1, keepdims=True) * np.float32(1.25) / np.float32(127)
          ).astype(np.float32) if scaled else None
    pick = (lambda a: np.stack(a)) if stacked else (lambda a: a[0])
    codes, scales = pick([c for c, _ in packs]), pick([s for _, s in packs])
    jw = ji8.I8SBQuant(jnp.asarray(codes), jnp.asarray(scales), k)
    tw = ti8.I8SBQuant(torch.from_numpy(codes), torch.from_numpy(scales), k)
    layer = 2 if stacked else None
    want = np.asarray(ji8.qmatmul_i8sb(jnp.asarray(x), jw, out_dtype=jnp.float32, layer=layer,
                                       x_scale=None if sx is None else jnp.asarray(sx)))
    ts = None if sx is None else torch.from_numpy(sx)
    got = ti8.qmatmul_i8sb_decode_ref(torch.from_numpy(x), tw, layer, ts)
    assert _rel(got.numpy(), want) <= 1e-5
    # the CPU decode wrapper is this plain version, and so is the engine's entry
    assert torch.equal(ti8.i8_decode(torch.from_numpy(x), tw, layer, ts), got)
    assert torch.equal(ti8.qmatmul_i8sb(torch.from_numpy(x), tw, layer, ts), got)


TIE_BAND = np.float32(0.49993896484375)  # 0.5 - 2^-14, csrc/common.cuh kTieBand


def _rcp_quotient(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The decode kernel's codes, step by step in f32 (csrc/common.cuh
    split_level): clamp(x * RN(1/s), +-127) rounded half to even, and the
    IEEE quotient instead where that product lies within 2^-14 of a
    half-integer or RN(1/s) is not a normal float."""
    rcp = torch.ones_like(s) / s
    q = (x * rcp).clamp(-127, 127)
    r = torch.round(q)
    exact = torch.round((x / s).clamp(-127, 127))
    fast = (s >= 2.0 ** -125) & (s <= 2.0 ** 125)
    return torch.where(((q - r).abs() > TIE_BAND) | ~fast, exact, r)


@pytest.mark.parametrize("case", ["normal", "ties", "near_ties", "scales"])
def test_reciprocal_quotient_bit_equal(case):
    rng = np.random.default_rng(len(case))
    rows, k = 64, 4096
    x = rng.normal(0, 1, (rows, k)).astype(np.float32)
    s = (np.abs(x).max(axis=1, keepdims=True) / np.float32(127)).astype(np.float32)
    a = rng.integers(-127, 127, (rows, k)).astype(np.float32)
    if case == "ties":  # x / s exactly a + 1/2 (s a power of two): both parities
        s = (2.0 ** rng.integers(-20, 20, (rows, 1))).astype(np.float32)
        x = (s * (a + np.float32(0.5))).astype(np.float32)
    elif case == "near_ties":  # s = 3 2^e: x / s is a + 1/2, x * RN(1/s) only near it
        s = (3 * 2.0 ** rng.integers(-20, 20, (rows, 1))).astype(np.float32)
        x = (s * (a + np.float32(0.5))).astype(np.float32)
        x[:, ::3] = np.nextafter(x[:, ::3], np.float32(np.inf))
    elif case == "scales":  # extreme and odd row scales, quotients past +-127
        s = (np.exp(rng.uniform(-80, 80, (rows, 1))) * rng.uniform(0.5, 1.5, (rows, 1))
             ).astype(np.float32)
        x = (s * rng.uniform(-140, 140, (rows, k))).astype(np.float32)
    xt, st = torch.from_numpy(x), torch.from_numpy(s)
    want = torch.round(xt / st).clamp(-127, 127)
    got = _rcp_quotient(xt, st)
    assert torch.equal(got, want)
    if case in ("ties", "near_ties"):
        q = xt.double() / st.double()
        assert int(((q - q.floor()) == 0.5).sum()) >= rows * k // 2


def test_k_not_multiple_falls_back_and_smooth_refusals():
    # K = 1408 (the ViT-G width): w8a8 takes the auto form, repacked here
    raw = _raw(DataType.Q4_0, 8, 1408)
    w = load_quant_weight(raw, (8, 1408), DataType.Q4_0, "cpu", "w8a8")
    assert isinstance(w, RepackedQuant)
    jw = jparams.load_quant_weight(raw, (8, 1408), DataType.Q4_0, "w8a8")
    assert not isinstance(jw, ji8.I8SBQuant)  # the JAX rule falls back too
    with pytest.raises(ValueError, match="cannot fold smooth scales"):
        load_quant_weight(raw, (8, 1408), DataType.Q4_0, "cpu", "w8a8",
                          col_scale=np.ones(1408, np.float32))
    with pytest.raises(ValueError, match="only valid with quant_mode='w8a8'"):
        load_quant_weight(_raw(DataType.Q5_K, 8, 512), (8, 512), DataType.Q5_K, "cpu", "gq",
                          row_scale=np.ones(8, np.float32))
    w8 = load_quant_weight(_raw(DataType.Q5_K, 8, 512), (8, 512), DataType.Q5_K, "cpu", "w8a8")
    assert isinstance(w8, ti8.I8SBQuant)
    bad = ti8.I8SBQuant(w8.codes[:, :96].contiguous(), w8.scales[:, :1].contiguous(), 96)
    with pytest.raises(ValueError, match="not a multiple of 256"):
        ti8.qmatmul_i8sb(torch.zeros(2, 96), bad)
    with pytest.raises(ValueError, match="not a multiple of the 256 superblock"):
        ti8.from_ggml(raw, (8, 1408), DataType.Q4_0, "cpu")


@pytest.mark.parametrize("dtype", DEQUANT, ids=lambda d: d.name.lower())
def test_qtensor_dequant_bit_equal_to_jax(dtype):
    n, k = 12, 512
    raw = _raw(dtype, n, k, seed=3)
    jw = jparams.load_quant_weight(raw, (n, k), dtype, "qtensor")
    tw = load_quant_weight(raw, (n, k), dtype, "cpu", "qtensor")
    assert isinstance(tw, QTensor) and tw.n_in == k and tw.n_out == n
    assert np.array_equal(tw.packed.numpy(), np.asarray(jw.packed))
    want = np.asarray(jw.dequantize())
    got = tw.dequantize().numpy()
    assert got.dtype == np.float32 and np.array_equal(got, want)
    # the matmul dequantizes in x's dtype, then one product
    x = np.random.default_rng(4).normal(0, 1, (5, k)).astype(np.float32)
    assert np.allclose(linear(torch.from_numpy(x), {"w": tw}).numpy(), x @ want.T,
                       rtol=1e-5, atol=1e-5)


def test_qtensor_stack_and_q8_1():
    # stacked QTensors select their layer like the other forms
    raws = [_raw(DataType.Q4_1, 6, 256, seed=s) for s in (0, 1)]
    from minigpt4_tpu_torch.ops import quant_matmul as qm

    w = qm.stack([load_quant_weight(r, (6, 256), DataType.Q4_1, "cpu", "qtensor") for r in raws])
    x = torch.ones(2, 256)
    one = load_quant_weight(raws[1], (6, 256), DataType.Q4_1, "cpu", "qtensor")
    assert torch.equal(linear(x, {"w": w}, 1), linear(x, {"w": one}))
    # q8_1 has no repacked form: the packed bytes, as the JAX rule gives,
    # and neither package has a decoder for them
    raw = _raw(DataType.Q8_1, 4, 256)
    tw = load_quant_weight(raw, (4, 256), DataType.Q8_1, "cpu", "auto")
    jw = jparams.load_quant_weight(raw, (4, 256), DataType.Q8_1, "auto")
    assert isinstance(tw, QTensor) and np.array_equal(tw.packed.numpy(), np.asarray(jw.packed))
    with pytest.raises(ValueError, match="no dequantization for Q8_1"):
        tw.dequantize()
    with pytest.raises(KeyError):
        jw.dequantize()
