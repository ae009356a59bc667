"""The port's dual-i8 gq decode function against the JAX package's.

The decode kernels (``csrc/gq_decode_i8.cuh``) and their plain version
(``ops/group_i8.qmatmul_decode_ref``) compute what the JAX package's
``_kernel_exact`` / ``_kernel_generic`` compute around ``qmatmul_group``:
x split into two i8 planes (``split_activations``), exact integer group dot
products, the f32 ``_combine`` with the true-x group sums.  Held here on the
CPU, inputs made from a seed with numpy, the JAX kernels in interpret mode:

* the port's split is the JAX package's, bit for bit (x1, x2, s1, s2): ties
  at .5 of both quotients, zero rows, a row with one nonzero, tiny and large
  rows, the 13B width K = 13824; below an absmax of ~1.5e-36, where s2 is
  subnormal, JAX on the CPU flushes it to 0 and the port does not (the one
  difference, held as such);
* the plain decode against JAX's at 1e-5 of max|y| (the same function, f32
  summation order; measured <= 2e-7) and against the function in f64 at
  1e-5 (f32 rounding), for group sizes 16 and 32, exact and generic planes,
  signed q8_0 codes with -128 among them, M = 1..8, a stacked layer > 0;
* a packed weight (p4, p5, p6) gives its unpacked twin's bits, stacked too.

The kernels are held to this plain version on the card in
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from minigpt4_tpu.formats import quants as nq
from minigpt4_tpu.formats.dtypes import DataType
from minigpt4_tpu.ops import group_i8 as jgq
from minigpt4_tpu_torch.ops import group_i8 as tgq
from test_torch_group_i8 import dual_i8_f64


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-12)


def _split_rows(case: str, k: int, rng: np.random.Generator) -> np.ndarray:
    x = rng.normal(0, 1, (4, k)).astype(np.float32)
    if case == "ties":
        # s1 = 2^-3 exactly (absmax 127 / 8), so x = s1 (a + (2b + 1) / 256)
        # is exact; x / s1 lands on a + 1/2 in the first half of the row
        # (both parities of a) and r / s2 on b + 1/2 in the second
        s1 = np.float32(0.125)
        a = (np.arange(k) % 250 - 125).astype(np.float32)
        b = (np.arange(k) % 128 - 64).astype(np.float32)
        x[:, :k // 2] = (s1 * (a + np.float32(0.5)))[:k // 2]
        x[:, k // 2:] = (s1 * (a + (2 * b + 1) / np.float32(256)))[k // 2:]
        x[:, 0] = 127 * s1
        x[1:] *= np.float32(2.0) ** np.arange(-2, 1, dtype=np.float32)[:, None]
    elif case == "zero_rows":
        x[0] = 0.0
        x[2] = -0.0
    elif case == "one_nonzero":
        x[:] = 0.0
        x[0, 7], x[1, k - 1], x[2, 0], x[3, k // 2] = -3.5, 1e-30, 127.0, 6.0e4
    elif case == "scales":
        x[0] *= 1e-20
        x[1] *= 1e20
        x[2] *= 1e-30  # s2 ~ 2e-34, still a normal float
        x[3] = np.round(x[3] * 8) / 8  # many exact multiples of a power of two
    return x


@pytest.mark.parametrize("case", ["ties", "zero_rows", "one_nonzero", "scales", "normal"])
@pytest.mark.parametrize("k", [256, 5120, 13824])
def test_split_bit_equal_to_jax(case, k):
    x = _split_rows(case, k, np.random.default_rng(k + len(case)))
    want = [np.asarray(a) for a in jgq.split_activations(jnp.asarray(x))]
    got = [a.numpy() for a in tgq.split_activations(torch.from_numpy(x))]
    for name, g, w in zip(("x1", "x2", "s1", "s2"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert np.array_equal(g.view(np.int32) if g.dtype == np.float32 else g,
                              w.view(np.int32) if w.dtype == np.float32 else w), (case, name)
    x1, x2, s1, s2 = got
    assert np.abs(x1).max() <= 127 and np.abs(x2).max() <= 127
    if case == "ties":  # the ties did land on half-integers, and rounded to even
        q1 = x / s1
        half1 = q1 - np.floor(q1) == 0.5
        q2 = (x - s1 * x1.astype(np.float32)) / s2
        half2 = q2 - np.floor(q2) == 0.5
        assert half1.sum() >= 2 * (k // 2 - 1) and half2.sum() >= 2 * (k // 2)
        assert np.all(x1[half1].astype(np.int64) % 2 == 0)
        assert np.all(x2[half2].astype(np.int64) % 2 == 0)


def test_subnormal_second_scale_is_kept():
    """A row whose s2 = s1 / 128 falls below the smallest normal float (an
    absmax under ~1.5e-36): JAX on the CPU flushes s2 to 0 and x2 to +-127,
    the port keeps IEEE subnormals (as the card's kernel does, built without
    flush-to-zero), so its split still reconstructs the row.  The only
    inputs where the two splits differ."""
    x = (np.random.default_rng(1).normal(0, 1, (1, 256)) * 1e-35).astype(np.float32)
    jx1, jx2, js1, js2 = (np.asarray(a) for a in jgq.split_activations(jnp.asarray(x)))
    x1, x2, s1, s2 = (a.numpy() for a in tgq.split_activations(torch.from_numpy(x)))
    assert np.array_equal(x1, jx1) and np.array_equal(s1, js1)
    assert float(js2[0, 0]) == 0.0 and 0.0 < float(s2[0, 0]) < np.finfo(np.float32).tiny
    rec = s1.astype(np.float64) * x1 + s2.astype(np.float64) * x2
    assert np.abs(rec - x).max() <= 0.51 * float(s2[0, 0])


def test_group_sums_are_the_jax_sgt():
    x = np.random.default_rng(3).normal(0, 1, (5, 512)).astype(np.float32)
    for gs in (16, 32):
        want = np.asarray(jnp.asarray(x).reshape(5, 512 // gs, gs).sum(axis=2).T)
        got = tgq.group_sums(torch.from_numpy(x), gs).numpy()
        assert got.shape == want.shape == (512 // gs, 5)
        assert np.abs(got - want).max() <= 1e-6 * np.abs(x).sum(axis=1).max()


FORMATS = [DataType.Q5_K, DataType.Q4_K, DataType.Q6_K, DataType.Q3_K, DataType.Q2_K,
           DataType.Q8_0, DataType.Q4_0, DataType.Q4_1, DataType.Q5_0, DataType.Q5_1]


def _weight(dtype, n, k, seed):
    vals = np.random.default_rng(seed).normal(0, 0.6, (n, k)).astype(np.float32)
    return nq.quantize(vals, dtype)


@pytest.mark.parametrize("m", range(1, 9))
@pytest.mark.parametrize("dtype", FORMATS, ids=[d.name.lower() for d in FORMATS])
def test_decode_matches_jax_and_f64(dtype, m):
    n, k = 96, 512
    raw = _weight(dtype, n, k, seed=100 * int(dtype) + m)
    x = np.random.default_rng(m).normal(0, 1, (m, k)).astype(np.float32)
    tw = tgq.from_ggml(raw, (n, k), dtype, "cpu")
    assert tw.group_size == (16 if dtype in tgq.GS16 else 32)
    got = tgq.qmatmul_decode_ref(torch.from_numpy(x), tw).numpy()
    jw = jgq.from_ggml(raw, (n, k), dtype)
    want = np.asarray(jgq.qmatmul_group(jnp.asarray(x), jw, out_dtype=jnp.float32))
    assert _rel(got, want) <= 1e-5
    assert _rel(got, dual_i8_f64(x, tw)) <= 1e-5


@pytest.mark.parametrize("m", [1, 8])
def test_signed_q8_0_codes_with_minus_128(m):
    """q8_0 codes are signed; -128 (which the ggml quantizer never writes
    but random bytes can hold) stays -128 in the integer dot."""
    n, k = 64, 256
    raw = _weight(DataType.Q8_0, n, k, seed=m)
    blk = raw.reshape(n, k // 32, 34).copy()
    rng = np.random.default_rng(m)
    blk[:, :, 2:] = rng.integers(0, 256, blk[:, :, 2:].shape, dtype=np.uint8)
    blk[:, 0, 2:6] = 0x80  # -128 in every row
    raw = blk.reshape(-1)
    tw = tgq.from_ggml(raw, (n, k), DataType.Q8_0, "cpu")
    assert int(tw.codes.min()) == -128
    x = rng.normal(0, 1, (m, k)).astype(np.float32)
    got = tgq.qmatmul_decode_ref(torch.from_numpy(x), tw).numpy()
    jw = jgq.from_ggml(raw, (n, k), DataType.Q8_0)
    assert np.array_equal(np.asarray(jw.codes), tw.codes.numpy())
    want = np.asarray(jgq.qmatmul_group(jnp.asarray(x), jw, out_dtype=jnp.float32))
    assert _rel(got, want) <= 1e-5
    assert _rel(got, dual_i8_f64(x, tw)) <= 1e-5


@pytest.mark.parametrize("m", [1, 5, 8])
@pytest.mark.parametrize("dtype", [DataType.Q5_K, DataType.Q6_K, DataType.Q4_0],
                         ids=["q5_k", "q6_k", "q4_0"])
def test_stacked_layer_matches_jax(dtype, m):
    n, k = 64, 512
    raws = [_weight(dtype, n, k, seed=s) for s in (1, 2, 3)]
    tw = tgq.stack([tgq.from_ggml(r, (n, k), dtype, "cpu") for r in raws])
    x = np.random.default_rng(m).normal(0, 1, (m, k)).astype(np.float32)
    for layer in (1, 2):
        got = tgq.qmatmul_group(torch.from_numpy(x), tw, layer).numpy()
        assert torch.equal(torch.from_numpy(got),
                           tgq.qmatmul_decode_ref(torch.from_numpy(x), tw.layer(layer)))
        jw = jgq.from_ggml(raws[layer], (n, k), dtype)
        want = np.asarray(jgq.qmatmul_group(jnp.asarray(x), jw, out_dtype=jnp.float32))
        assert _rel(got, want) <= 1e-5


PACKED = [DataType.Q4_K, DataType.Q5_K, DataType.Q6_K, DataType.Q4_0, DataType.Q4_1,
          DataType.Q5_0, DataType.Q5_1]


@pytest.mark.parametrize("m", [1, 4, 8])
@pytest.mark.parametrize("dtype", PACKED, ids=[d.name.lower() for d in PACKED])
def test_packed_twin_bit_equal(dtype, m):
    n, k = 48, 1024
    w = tgq.stack([tgq.from_ggml(_weight(dtype, n, k, seed=s), (n, k), dtype, "cpu")
                   for s in (7, 8)])
    wp = tgq.pack_codes(w)
    assert wp.packing == tgq.packing_of(dtype) != "none"
    x = torch.from_numpy(np.random.default_rng(m).normal(0, 1, (m, k)).astype(np.float32))
    for layer in (0, 1):
        assert torch.equal(tgq.gq_decode(x, wp, layer) if wp.exact else
                           tgq.gq_decode_generic(x, wp, layer),
                           tgq.qmatmul_decode_ref(x, w, layer))
