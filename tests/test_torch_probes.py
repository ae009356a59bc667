"""Port parity for the dequant-matmul probes: the plain versions of
``minigpt4_tpu_torch/ops/probes.py`` on the CPU against the JAX package's
probes (``tools/*.py``), on the same seeded numpy inputs, and the probe
tools' CPU modes.

* Kernel A (dual-i8 exact q5_k): ``tools/qmm_group_i8.py`` is loaded by path
  and its ``qmatmul_group_i8`` runs in interpret mode at its ``check()``
  shapes.  Its activation split is held bit-equal (x1, x2) and within 1 ulp
  (s1, s2); y within 1e-5 of max|y| (f32 sums in another order); both
  within 3e-4 of the f64 dequant reference (the JAX probe's own check).
* Kernel B (dequantize-matvec): per storage and layout, the plain version
  against an f64 NumPy rewrite of the JAX variants' unpack (nibble pairs,
  q5 = nibble + 16 * bit with the hi-plane mapping of ``qmm_variants``'
  q5cur and the dual half-planes of ``qmm_v3``'s q5i8dom): 1e-5 of max|y|
  (an f32 matmul against f64).
* Kernel C (integer dots): bit-equal to NumPy's integers; the s4 chunk-
  scaled dot against ``probe_int4.py``'s ``sb_s4`` einsum in jnp on the CPU
  (its s4 operands carried as i8 values in -8..7: XLA's CPU backend refuses
  int4 dot operands), 1e-6 of max|y| (f32 sum over chunks in another order).
* Kernel D (op chains): the block and the checksums bit-equal to NumPy's
  integer chains and jnp's bf16 chains.
"""

import contextlib
import importlib.util
import io
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from minigpt4_tpu_torch import interop
from minigpt4_tpu_torch.ops import probes
from minigpt4_tpu_torch.tools import (probe_i8ops, probe_int4, qmm_group_i8, qmm_r3, qmm_v3,
                                     qmm_variants, unpack_variants)

# one intra-op thread: the suite runs several pytest-xdist workers on the same cores, where
# torch's OpenMP pools spin against each other and run ~17x slower
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _load_jax_probe():
    spec = importlib.util.spec_from_file_location("jax_qmm_group_i8",
                                                  ROOT / "tools" / "qmm_group_i8.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JAX_PROBE = _load_jax_probe()


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-30))


def _ulps(a, b) -> int:
    a, b = np.asarray(a, np.float32).view(np.int32), np.asarray(b, np.float32).view(np.int32)
    return int(np.max(np.abs(a.astype(np.int64) - b.astype(np.int64))))


# ---------------------------------------------------------------------------
# kernel A
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,k,m", [(256, 512, 1), (512, 1024, 3), (384, 768, 8)])
def test_group_i8_matches_the_jax_probe(n, k, m):
    rng = np.random.default_rng(n + m)
    g = k // 32
    codes = rng.integers(0, 32, (n, k)).astype(np.int8)
    sct = np.asarray(jnp.asarray(rng.random((g, n), np.float32) * 0.02 + 0.001, jnp.bfloat16))
    bt = np.asarray(jnp.asarray(-(rng.random((g, n), np.float32) * 0.1), jnp.bfloat16))
    x = rng.normal(0, 1, (m, k)).astype(np.float32)

    jx1, jx2, js1, js2 = (np.asarray(a) for a in JAX_PROBE.split_activations(jnp.asarray(x)))
    tx1, tx2, ts1, ts2 = (a.numpy() for a in probes.split_activations(torch.from_numpy(x)))
    assert np.array_equal(jx1, tx1) and np.array_equal(jx2, tx2)
    assert _ulps(js1, ts1) <= 1 and _ulps(js2, ts2) <= 1

    y_jax = np.asarray(JAX_PROBE.qmatmul_group_i8(jnp.asarray(x), jnp.asarray(codes),
                                                  jnp.asarray(sct), jnp.asarray(bt)))
    c, s, b = interop.probe_planes_from_jax(codes, sct, bt, "cpu")
    assert (c.dtype, s.dtype, b.dtype) == (torch.int8, torch.bfloat16, torch.bfloat16)
    y = probes.qmatmul_group_i8(torch.from_numpy(x), c, s, b).numpy()
    assert _rel(y, y_jax) <= 1e-5

    w = (s.float().t().repeat_interleave(32, 1) * c.float() + b.float().t().repeat_interleave(32, 1))
    y64 = x.astype(np.float64) @ w.double().numpy().T
    assert _rel(y, y64) <= 3e-4 and _rel(y_jax, y64) <= 3e-4


def test_group_i8_stacked_layer_is_its_slice():
    rng = np.random.default_rng(5)
    n, k, m = 128, 512, 4
    codes = torch.from_numpy(rng.integers(0, 32, (3, n, k)).astype(np.int8))
    planes = torch.from_numpy(rng.random((3, k // 32, n), np.float32) * 0.02).to(torch.bfloat16)
    x = torch.from_numpy(rng.normal(0, 1, (m, k)).astype(np.float32))
    got = probes.qmatmul_group_i8(x, codes, planes, -planes, layer=2)
    assert torch.equal(got, probes.qmatmul_group_i8(x, codes[2], planes[2], -planes[2]))


# ---------------------------------------------------------------------------
# kernel B
# ---------------------------------------------------------------------------


def _jax_formula(x: np.ndarray, w: probes.ProbeWeight) -> np.ndarray:
    """The JAX variants' dequantization in NumPy f64, field by field."""
    n, k = w.n_out, w.n_in
    if w.storage == "dense":
        vals = w.codes.float().numpy().astype(np.float64)
        return x.astype(np.float64) @ (vals if w.layout == "nm" else vals.T).T
    codes = w.codes.numpy()
    if w.layout == "km":
        codes = codes.T
    if w.storage == "i8":
        q = codes.astype(np.int64)
    else:
        lo, hi4 = codes.astype(np.int64) & 0xF, codes.astype(np.int64) >> 4
        q = np.stack([lo, hi4], axis=-1).reshape(n, k)
        if w.storage in ("i4", "q5i4", "q5d"):  # bitcast int4: two's complement
            q = np.where(q >= 8, q - 16, q)
    nb = k // 8
    if w.storage in ("q5", "q5i4"):  # qmm_variants q5cur: bit p of hi[:, i] for k = p nb + i
        hb = w.hi.numpy().astype(np.int64)
        for p in range(8):
            q[:, p * nb:(p + 1) * nb] += ((hb >> p) & 1) * 16
    if w.storage == "q5d":  # qmm_v3 q5i8dom: half-plane p // 4, bit p % 4 + 1
        hb = w.hi.numpy().astype(np.int64)
        for p in range(8):
            h0, b = (p // 4) * nb, p % 4 + 1
            t = hb[:, h0:h0 + nb] & (1 << b)
            q[:, p * nb:(p + 1) * nb] += t * 2 ** (4 - b)
    s = w.scales.float().numpy().astype(np.float64)
    s = s if w.layout == "nm" else s.T
    return x.astype(np.float64) @ (q * np.repeat(s, 32, axis=1)).T


STORAGE_CASES = [(s, "nm") for s in probes.STORAGES] + [(s, "km") for s in probes.KM_STORAGES]


@pytest.mark.parametrize("storage,layout", STORAGE_CASES,
                         ids=[f"{s}-{lay}" for s, lay in STORAGE_CASES])
def test_dequant_matvec_plain_matches_the_jax_formula(storage, layout):
    gen = torch.Generator().manual_seed(len(storage))
    w = probes.random_probe_weight(storage, 96, 512, gen, "cpu", layout)
    x = np.random.default_rng(1).normal(0, 1, (5, 512)).astype(np.float32)
    y = probes.dequant_matvec(torch.from_numpy(x), w, "magic" if storage != "dense" else "shift")
    assert y.shape == (5, 96)
    assert _rel(y.numpy(), _jax_formula(x, w)) <= 1e-5


def test_dequant_matvec_layouts_hold_the_same_weight():
    """The km layout of a weight (its transpose; nibble pairs along K) is the
    same function as nm."""
    gen = torch.Generator().manual_seed(3)
    nm = probes.random_probe_weight("i4", 64, 256, gen, "cpu")
    q = probes.unpack_nibbles(nm.codes)  # [N, K] nibbles
    pairs = q.t().reshape(128, 2, 64).permute(0, 2, 1)  # [K/2, N, 2]: k = 2i, 2i + 1
    km = probes.ProbeWeight(probes.pack_nibbles(pairs).reshape(128, 64).contiguous(),
                            nm.scales.t().contiguous(), "i4", 64, 256, "km")
    x = torch.randn(3, 256, generator=gen)
    assert torch.equal(probes.code_values(km), probes.code_values(nm))
    torch.testing.assert_close(probes.dequant_matvec(x, km), probes.dequant_matvec(x, nm),
                               rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# kernel C
# ---------------------------------------------------------------------------


def _s4_values(b: np.ndarray) -> np.ndarray:
    b = b.astype(np.int64)
    q = np.stack([b & 15, b >> 4], axis=-1).reshape(b.shape[0], -1)
    return np.where(q >= 8, q - 16, q)


@pytest.mark.parametrize("mode", list(probes.INT_MODES))
def test_int_dot_bit_equal_to_numpy(mode):
    rng = np.random.default_rng(len(mode))
    n, k, m = 40, 512, 3
    x8 = rng.integers(-127, 128, (m, k)).astype(np.int8)
    xs4 = rng.integers(0, 256, (m, k // 2)).astype(np.uint8)
    w8 = rng.integers(-127, 128, (n, k)).astype(np.int8)
    ws4 = rng.integers(0, 256, (n, k // 2)).astype(np.uint8)
    sc = (rng.random((n, k // 256), np.float32) + 0.5) * 2.0 ** -13
    if mode == "i8xi8":
        got = probes.int_dot(torch.from_numpy(x8), torch.from_numpy(w8), None, mode)
        assert np.array_equal(got.numpy(), x8.astype(np.int64) @ w8.astype(np.int64).T)
    elif mode == "s4xs4":
        got = probes.int_dot(torch.from_numpy(xs4), torch.from_numpy(ws4), None, mode)
        assert np.array_equal(got.numpy(), _s4_values(xs4) @ _s4_values(ws4).T)
    else:
        got = probes.int_dot(torch.from_numpy(x8), torch.from_numpy(ws4), torch.from_numpy(sc),
                             mode).numpy()
        wv = _s4_values(ws4)
        want = np.zeros((m, n), np.float32)
        for g in range(k // 256):
            part = (x8[:, g * 256:(g + 1) * 256].astype(np.int64)
                    @ wv[:, g * 256:(g + 1) * 256].T).astype(np.float32)
            want = want + part * sc[:, g]
        assert np.array_equal(got, want)


def test_s4_sb_matches_the_jax_probe_einsum():
    """probe_int4.py's sb_s4 with x in the int4 range, in jnp on the CPU."""
    rng = np.random.default_rng(9)
    n, k, sb = 64, 1024, 256
    x = rng.integers(-8, 8, (1, k)).astype(np.int8)
    ws4 = rng.integers(0, 256, (n, k // 2)).astype(np.uint8)
    wv = _s4_values(ws4).astype(np.int8)
    sc = np.full((n, k // sb), 2e-4, np.float32)
    xr = jnp.asarray(x).reshape(1, k // sb, sb)
    wr = jnp.asarray(wv).reshape(n, k // sb, sb)
    part = jnp.einsum("mcs,ncs->mnc", xr, wr, preferred_element_type=jnp.int32)
    want = np.asarray((part.astype(jnp.float32) * jnp.asarray(sc)[None]).sum(-1))
    got = probes.int_dot(torch.from_numpy(x), torch.from_numpy(ws4), torch.from_numpy(sc),
                         "s4_sb").numpy()
    assert _rel(got, want) <= 1e-6


# ---------------------------------------------------------------------------
# kernel D
# ---------------------------------------------------------------------------


def _np_chain(v: np.ndarray, op: str, reps: int):
    if op in ("c8", "c32"):
        acc = jnp.asarray(v).astype(jnp.bfloat16)
        for i in range(1, reps):
            acc = acc + jnp.asarray(v + v.dtype.type(i)).astype(jnp.bfloat16)
        return np.asarray(acc)
    if op in ("bf16add", "bf16mul"):
        j = jnp.asarray(v)
        for _ in range(reps):
            j = j + jnp.bfloat16(1.0) if op == "bf16add" else j * jnp.bfloat16(1.0009765625)
        return np.asarray(j)
    t = v.dtype.type
    for _ in range(reps):
        if op in ("i8aa", "i32aa"):
            v = (v & t(0x55)) + t(1)
        elif op == "u8and":
            v = v & t(0x55)
        elif op == "i8mul":
            v = v * t(3)
        elif op == "i8add":
            v = v + t(1)
    return v


@pytest.mark.parametrize("op", list(probes.OPS))
def test_op_chain_bit_equal_to_numpy_and_jnp(op):
    rng = np.random.default_rng(len(op))
    rows, cols, reps = 512, 256, 8
    dtype = probes.OPS[op][1]
    if dtype == torch.bfloat16:
        v = np.asarray(jnp.asarray(rng.normal(0, 1, (rows, cols)).astype(np.float32),
                                   jnp.bfloat16))
        inp = interop._t(v, "cpu")
    else:
        npd = {torch.int8: np.int8, torch.uint8: np.uint8, torch.int32: np.int32}[dtype]
        lo, hi = (0, 200) if dtype == torch.uint8 else (-100, 100)
        v = rng.integers(lo, hi, (rows, cols)).astype(npd)
        inp = torch.from_numpy(v)
    with np.errstate(over="ignore"):
        res = np.ascontiguousarray(_np_chain(v, op, reps))
    out, cks = probes.op_chain(inp, op, reps)
    tiles = rows // 256
    want_out = res.reshape(tiles, 256, cols)[:, :8, :128].astype(np.float32)
    want_out = want_out.transpose(1, 0, 2).reshape(8, 128 * tiles)
    words = res.view(np.int32).reshape(tiles, -1).astype(np.int64)
    assert np.array_equal(out.numpy(), want_out)
    assert np.array_equal(cks.numpy(), words.sum(axis=1) & 0xFFFFFFFF)


# ---------------------------------------------------------------------------
# the tools' CPU modes
# ---------------------------------------------------------------------------

TOOLS = [(qmm_group_i8, []), (qmm_variants, []), (unpack_variants, []), (qmm_r3, []),
         (probe_int4, []), (probe_i8ops, []), (qmm_v3, []), (qmm_v3, ["km"]), (qmm_v3, ["i8"])]
TOOL_IDS = [t.__name__.rsplit(".", 1)[-1] + "".join(f"-{a}" for a in e) for t, e in TOOLS]


@pytest.mark.parametrize("tool,entry", TOOLS, ids=TOOL_IDS)
def test_tool_checks_run_on_the_cpu(tool, entry):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        tool.main(entry + ["--device", "cpu", "--check-only"])
    assert '"check"' in out.getvalue()


@pytest.mark.parametrize("tool,entry", TOOLS, ids=TOOL_IDS)
def test_tool_timing_without_a_card_raises(tool, entry):
    with pytest.raises(RuntimeError, match="timing needs an NVIDIA GPU"):
        tool.main(entry + ["--device", "cpu"])


def test_tool_rejects_unknown_variants():
    with pytest.raises(ValueError, match="unknown variants"):
        qmm_r3.main(["--device", "cpu", "--check-only", "--only", "nosuch"])


def test_cpu_wrappers_count_no_launch():
    before = {k: f.launches for k, f in probes.WRAPPERS.items()}
    with contextlib.redirect_stdout(io.StringIO()):
        probe_int4.main(["--device", "cpu", "--check-only"])
    assert {k: f.launches for k, f in probes.WRAPPERS.items()} == before
