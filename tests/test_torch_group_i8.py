"""Port parity: minigpt4_tpu_torch.ops.group_i8 against the JAX group_i8.

Inputs come from numpy with a fixed seed; the JAX side runs its Pallas
kernels in interpret mode, as tests/test_group_i8.py does.  Tolerances:
the port's decode path computes the JAX kernel's function (x split into
two i8 planes, exact integer group dot products, the f32 combine of
_combine with the true-x group sums), so it sits within f32 summation
order (1e-5 of max|y|; measured <= 2e-7) of the JAX result and within f32
rounding (1e-5) of the same function in f64: the A term over the split's
reconstruction s1 x1 + s2 x2, the B term over the true x, as the kernel
sums it.  The split itself is the JAX package's, bit for bit.  Both
prefill paths round x and W to bf16 and accumulate in f32, so only the
summation order differs (1e-4).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from minigpt4_tpu.formats import quants as nq
from minigpt4_tpu.formats.dtypes import DataType
from minigpt4_tpu.ops import group_i8 as jgq
from minigpt4_tpu.ops import repack as jrp
from minigpt4_tpu.ops.pallas_quant_matmul import qmatmul_repacked as jax_qmatmul
from minigpt4_tpu_torch.models.params import linear, load_quant_weight
from minigpt4_tpu_torch.ops import group_i8 as tgq
from minigpt4_tpu_torch.ops.repack import RepackedQuant

# one intra-op thread: the suite runs several pytest-xdist workers on the same cores, where
# torch's OpenMP pools spin against each other and run ~17x slower
torch.set_num_threads(1)

EXACT = [DataType.Q4_K, DataType.Q5_K]


def _make(dtype, n, k, seed=0):
    vals = np.random.default_rng(seed).normal(0, 0.6, (n, k)).astype(np.float32)
    return nq.quantize(vals, dtype)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-12)


@pytest.mark.parametrize("dtype", EXACT)
def test_from_ggml_bitwise_equal_to_jax(dtype):
    n, k = 96, 768
    raw = _make(dtype, n, k)
    jw = jgq.from_ggml(raw, (n, k), dtype)
    tw = tgq.from_ggml(raw, (n, k), dtype, "cpu")
    assert tw.codes.dtype == torch.int8 and tw.sc6.dtype == torch.uint8
    for name in ("codes", "sc6", "mn6", "d", "dmin"):
        want = np.asarray(getattr(jw, name))
        got = getattr(tw, name).numpy()
        assert got.shape == want.shape, name
        assert np.array_equal(got, want.astype(got.dtype)), name
    # and the dequantized weight is the ggml codec's, bit for bit
    assert np.array_equal(tw.dequantize().numpy(), nq.dequantize_rows(raw, dtype, (n, k)))


def dual_i8_f64(x: np.ndarray, w: tgq.GroupQuant) -> np.ndarray:
    """The decode function in f64: the A term over the split's
    reconstruction s1 x1 + s2 x2, the B term over the true x (the kernel's
    sgt), with the port's planes and logical codes."""
    x1, x2, s1, s2 = tgq.split_activations(torch.from_numpy(x))
    xr = (s1.double() * x1.double() + s2.double() * x2.double()).numpy()
    a, b = (np.repeat(p.double().numpy().T, w.group_size, axis=1) for p in w.planes())
    return xr @ (a * w.codes_int().double().numpy()).T + x.astype(np.float64) @ b.T


@pytest.mark.parametrize("dtype", EXACT)
@pytest.mark.parametrize("m", [1, 3, 8])
def test_decode_matches_f64_and_jax(dtype, m):
    n, k = 384, 512
    raw = _make(dtype, n, k, seed=int(dtype) * 10 + m)
    x = np.random.default_rng(m).normal(0, 1, (m, k)).astype(np.float32)
    tw = tgq.from_ggml(raw, (n, k), dtype, "cpu")
    assert np.array_equal(tw.dequantize().numpy(), nq.dequantize_rows(raw, dtype, (n, k)))
    got = tgq.qmatmul_group(torch.from_numpy(x), tw).numpy()
    assert _rel(got, dual_i8_f64(x, tw)) <= 1e-5
    jw = jgq.from_ggml(raw, (n, k), dtype)
    jy = np.asarray(jgq.qmatmul_group(jnp.asarray(x), jw, out_dtype=jnp.float32))
    assert _rel(got, jy) <= 1e-5


@pytest.mark.parametrize("dtype", EXACT)
@pytest.mark.parametrize("m", [16, 40])
def test_prefill_matches_jax(dtype, m):
    n, k = 256, 768
    raw = _make(dtype, n, k, seed=m)
    x = np.random.default_rng(100 + m).normal(0, 1, (m, k)).astype(np.float32)
    tw = tgq.from_ggml(raw, (n, k), dtype, "cpu")
    got = tgq.qmatmul_group(torch.from_numpy(x), tw).numpy()
    jw = jgq.from_ggml(raw, (n, k), dtype)
    jy = np.asarray(jgq.qmatmul_group(jnp.asarray(x), jw, out_dtype=jnp.float32))
    assert _rel(got, jy) <= 1e-4


@pytest.mark.parametrize("m", [1, 16])
def test_stacked_layer_selection(m):
    n, k = 128, 512
    ws = [tgq.from_ggml(_make(DataType.Q5_K, n, k, seed=s), (n, k), DataType.Q5_K, "cpu")
          for s in (1, 2, 3)]
    stacked = tgq.stack(ws)
    assert stacked.stacked and stacked.codes.shape == (3, n, k)
    x = torch.from_numpy(np.random.default_rng(0).normal(0, 1, (m, k)).astype(np.float32))
    for i, wi in enumerate(ws):
        assert torch.equal(tgq.qmatmul_group(x, stacked, layer=i), tgq.qmatmul_group(x, wi))
    with pytest.raises(ValueError):
        tgq.qmatmul_group(x, stacked)


def test_concat_out_is_concatenated_outputs():
    k = 512
    ws = [tgq.from_ggml(_make(DataType.Q4_K, n, k, seed=n), (n, k), DataType.Q4_K, "cpu")
          for n in (64, 96)]
    fused = tgq.concat_out(ws)
    x = torch.from_numpy(np.random.default_rng(5).normal(0, 1, (2, 1, k)).astype(np.float32))
    want = torch.cat([linear(x, {"w": w}) for w in ws], dim=-1)
    assert torch.equal(linear(x, {"w": fused}), want)


# what gq rejects: K = 1408 (the ViT-G width) is no multiple of 8 groups of
# 32, K = 96 none of 8 groups at all, q8_1 has no gq form.  The first three
# load repacked in gq mode, as in the JAX package (bit-equal dequantized
# weight, the JAX kernel's bf16 bound of tests/test_torch_repack.py on the
# product); q8_1 has no repacked form either and keeps its packed bytes (a
# QTensor), as in the JAX package.
@pytest.mark.parametrize("dtype,k", [(DataType.Q4_0, 1408), (DataType.Q8_0, 1408),
                                     (DataType.Q5_1, 96), (DataType.Q8_1, 512)],
                         ids=["q4_0-K1408", "q8_0-K1408", "q5_1-K96", "q8_1-K512"])
def test_unported_formats_raise(dtype, k):
    assert jgq.supported(dtype, k) is False  # the JAX rule agrees
    assert not tgq.supported(dtype, k)
    raw = _make(dtype, 8, k)
    if dtype == DataType.Q8_1:
        from minigpt4_tpu.models.params import load_quant_weight as jax_load
        from minigpt4_tpu_torch.ops.quant_matmul import QTensor

        w = load_quant_weight(raw, (8, k), dtype, "cpu", "gq")
        assert isinstance(w, QTensor) and w.dtype == dtype and w.n_in == k
        assert np.array_equal(w.packed.numpy(), np.asarray(jax_load(raw, (8, k), dtype, "gq").packed))
        return
    w = load_quant_weight(raw, (8, k), dtype, "cpu", "gq")
    assert isinstance(w, RepackedQuant) and w.dtype == dtype
    jw = jrp.repack(raw, (8, k), dtype)
    assert np.array_equal(w.dequantize().numpy(), np.asarray(jrp.dequantize_repacked(jw)))
    x = np.random.default_rng(k).normal(0, 1, (3, k)).astype(np.float32)
    want = np.asarray(jax_qmatmul(jnp.asarray(x), jw, out_dtype=jnp.float32))
    assert _rel(linear(torch.from_numpy(x), {"w": w}).numpy(), want) <= 1.2e-2


def test_cpu_wrappers_count_no_launch():
    k = 256
    ws = [tgq.from_ggml(_make(dt, 64, k), (64, k), dt, "cpu")
          for dt in (DataType.Q5_K, DataType.Q6_K, DataType.Q8_0)]
    wrappers = (tgq.gq_decode, tgq.gq_prefill, tgq.gq_decode_generic, tgq.gq_prefill_generic)
    before = [f.launches for f in wrappers]
    for w in ws:
        for m in (1, 8, 9, 40):
            tgq.qmatmul_group(torch.zeros(m, k), w)
    assert [f.launches for f in wrappers] == before

