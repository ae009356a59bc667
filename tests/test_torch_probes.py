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


# the integer tensor-core kernels' host-side pieces (A and C): the launch's
# partition of rows and K, the MMA fragments' k order and column map, the
# s4 unpack, the bound in the kernels' units

RING_CASES = [("group_i8", None, 5120, 13824, 1), ("group_i8", None, 27648, 5120, 8),
              ("group_i8", None, 5120, 5120, 5), ("group_i8", None, 300, 768, 3),
              ("group_i8", None, 160, 13824, 8), ("int_dot", "i8xi8", 13824, 5120, 1),
              ("int_dot", "s4xs4", 13824, 5120, 16), ("int_dot", "s4_sb", 13824, 5120, 8),
              ("int_dot", "s4xs4", 160, 13824, 1), ("int_dot", "s4_sb", 160, 13824, 1),
              ("int_dot", "i8xi8", 300, 1024, 8), ("int_dot", "s4xs4", 5120, 5120, 9)]


@pytest.mark.parametrize("kernel,mode,n,k,m", RING_CASES,
                         ids=[f"{c[1] or c[0]}-{c[2]}x{c[3]}-m{c[4]}" for c in RING_CASES])
def test_ring_plan_covers_every_row_and_group_once(kernel, mode, n, k, m):
    geo = probes.ring_geometry(kernel, m, mode)
    plan = probes.ring_plan(n, k, m, kernel, mode)
    csize = plan[0]["cluster"]
    assert 1 <= csize <= probes.RING_CLUSTER and len(plan) <= probes.MATVEC_SMS
    assert csize == 1 or (geo["split"] and csize <= -(-k // geo["step"]))
    rows = np.zeros(n, np.int64)
    cover: dict = {}  # chunk rows -> 32-code groups covered, over ranks, steps and warps
    sizes = []
    for block in plan:
        b0, b1 = block["rows"]
        if block["rank"] == 0:
            sizes.append(b1 - b0)
        for ch in block["chunks"]:
            n0, n1 = ch["rows"]
            assert b0 <= n0 < n1 <= b1 and (n0 - b0) % probes.RING_TILE == 0
            assert ch["tiles"] == -(-(n1 - n0) // probes.RING_TILE) and n1 - n0 <= geo["chunk"]
            if block["rank"] == 0:
                rows[n0:n1] += 1
            assert ch["steps"], "every rank takes at least one step of every chunk"
            seen = cover.setdefault((n0, n1), np.zeros(k // 32, np.int64))
            last = -1
            for st in ch["steps"]:
                k0, k1 = st["k"]
                assert k0 > last and k1 - k0 <= geo["step"]
                assert (k1 - k0) % (256 if mode == "s4_sb" else 32) == 0
                last = k0
                for c0, c1 in st["warps"]:
                    assert k0 <= c0 <= c1 <= k1 and (c1 - c0) % 32 == 0
                    assert c1 - c0 <= 32 * geo["warp_groups"]
                    if mode == "s4_sb" and c1 > c0:  # a warp's groups in one 256-chunk
                        assert c0 // 256 == (c1 - 1) // 256
                    seen[c0 // 32:c1 // 32] += 1
    assert (rows == 1).all()
    assert all((c == 1).all() for c in cover.values())
    assert max(sizes) - min(sizes) <= 1  # rows split evenly over the clusters
    if mode == "s4_sb":  # its chunk order: K whole in one block, steps in order
        assert csize == 1
    if csize > 1:  # a cluster that splits K holds one chunk, added after the ring
        assert all(len(b["chunks"]) == 1 for b in plan)
    assert probes.ring_mmas(n, k, m, kernel, mode) >= (
        -(-n // 16) * (k // 32) * geo["halves"])


@pytest.mark.parametrize("m", [1, 3, 4, 5, 8])
def test_imma_fragments_reproduce_group_i8_partials(m):
    """The dual-i8 kernel's MMA as its lanes load it (each lane's own 8
    bytes, x1 / x2 in columns 2 j / 2 j + 1 of each n8 half) gives the exact
    c1 and c2 of every group, and the f32 terms formed from them sum to
    group_i8_ref's y bit for bit."""
    rng = np.random.default_rng(m)
    n, k = 16, 128
    codes = torch.from_numpy(rng.integers(0, 32, (n, k)).astype(np.int8))
    x = torch.from_numpy(rng.normal(0, 1, (m, k)).astype(np.float32))
    x1, x2, s1, s2 = probes.split_activations(x)
    c1 = torch.zeros((k // 32, m, n), dtype=torch.int64)
    c2 = torch.zeros_like(c1)
    for gi in range(k // 32):
        grp = slice(32 * gi, 32 * gi + 32)
        for half in range(2 if m > 4 else 1):
            d = probes.imma_dot(codes[:, grp], probes.dual_columns(x1[:, grp], x2[:, grp], half))
            for t in range(4):
                if 4 * half + t < m:
                    c1[gi, 4 * half + t] = d[:, 2 * t]
                    c2[gi, 4 * half + t] = d[:, 2 * t + 1]
    q = codes.long().reshape(n, k // 32, 32)
    assert torch.equal(c1, torch.einsum("mgk,ngk->gmn", x1.long().reshape(m, -1, 32), q))
    assert torch.equal(c2, torch.einsum("mgk,ngk->gmn", x2.long().reshape(m, -1, 32), q))
    sct = torch.from_numpy(rng.random((k // 32, n), np.float32) * 0.02).to(torch.bfloat16)
    bt = -sct
    sgt = probes.group_sums(x)
    t = c1.float() * s1.reshape(1, m, 1) + c2.float() * s2.reshape(1, m, 1)
    y = (t * sct.float()[:, None, :] + sgt[:, :, None] * bt.float()[:, None, :]).sum(dim=0)
    want = probes.group_i8_ref(x1, x2, torch.cat([s1, s2], 1), sgt, codes, sct, bt)
    assert torch.equal(y, want)


def test_s4_to_s8_matches_unpack_nibbles_over_all_bytes():
    """The kernel's unpack of a word of 8 int4 codes (even codes, odd codes
    as sign-extended bytes) holds every byte value in every position of the
    word bit-equal to unpack_nibbles(signed=True)."""
    raw = (torch.arange(256).reshape(256, 1) + torch.arange(4).reshape(1, 4)) % 256  # [256, 4]
    words = (raw << torch.tensor([0, 8, 16, 24])).sum(dim=1, keepdim=True)  # [256, 1] int64
    even, odd = probes.s4_to_s8(words)
    codes = probes.unpack_nibbles(raw.to(torch.uint8), signed=True)  # [256, 8] int32
    assert torch.equal(probes.word_bytes(even).int(), codes[:, 0::2])
    assert torch.equal(probes.word_bytes(odd).int(), codes[:, 1::2])
    # the weights' unpack: the same codes times 16
    even, odd = probes.s4_to_s8x16(words)
    assert torch.equal(probes.word_bytes(even).int(), 16 * codes[:, 0::2])
    assert torch.equal(probes.word_bytes(odd).int(), 16 * codes[:, 1::2])


def _own_bytes_s4(nib: torch.Tensor, unpack=probes.s4_to_s8) -> torch.Tensor:
    """[rows, 16] nibble bytes of a group -> [rows, 32] in the order the
    kernel's lanes hold them: lane t's word (bytes 4 t .. 4 t + 3) unpacked,
    even codes then odd ones."""
    b = nib.long()
    words = b[:, 0::4] | b[:, 1::4] << 8 | b[:, 2::4] << 16 | b[:, 3::4] << 24  # [rows, 4]
    even, odd = unpack(words)
    eb = probes.word_bytes(even).reshape(-1, 4, 4)
    ob = probes.word_bytes(odd).reshape(-1, 4, 4)
    return torch.cat([eb, ob], dim=2).reshape(-1, 32)


@pytest.mark.parametrize("mode", ["s4_sb", "s4xs4", "i8xi8"])
def test_imma_fragments_reproduce_int_dot(mode):
    """The int kernel's MMA as its lanes feed it: s4 weight rows unpacked per
    lane word to 16 x the codes, i8 x byte-permuted (__byte_perm 0x6420 /
    0x7531: x[8 t + 0, 2, 4, 6], x[8 t + 1, 3, 5, 7]) or s4 x sign-extended
    in the same order, gives one group's exact integer dot (times 16 for s4
    weights, shifted back exactly)."""
    rng = np.random.default_rng(len(mode))
    s4w = mode != "i8xi8"
    w = torch.from_numpy(rng.integers(0, 256, (16, 16)).astype(np.uint8)) if s4w else \
        torch.from_numpy(rng.integers(-128, 128, (16, 32)).astype(np.int8))
    x = torch.from_numpy(rng.integers(0, 256, (8, 16)).astype(np.uint8)) if mode == "s4xs4" else \
        torch.from_numpy(rng.integers(-128, 128, (8, 32)).astype(np.int8))
    a_rows = _own_bytes_s4(w, probes.s4_to_s8x16) if s4w else w
    if mode == "s4xs4":
        b_cols = _own_bytes_s4(x)
    elif s4w:
        perm = torch.tensor([8 * t + j for t in range(4) for j in (0, 2, 4, 6, 1, 3, 5, 7)])
        b_cols = x[:, perm]
    else:
        b_cols = x
    want = probes.int_dot_ref(x, w, None, "s4xs4" if mode == "s4xs4" else "i8xi8") \
        if mode != "s4_sb" else (x.long() @ probes.unpack_nibbles(w, signed=True).long().t())
    d = probes.imma_dot(a_rows, b_cols).t()
    assert torch.equal(d, (16 if s4w else 1) * want.long())
    assert torch.equal(d >> (4 if s4w else 0), want.long())


def test_ring_bound_counts_the_padded_mmas():
    """The tools' ops bound counts the MMAs the launch issues (2 16 8 32
    operations each, padding included) at the int8 peak; the bytes bound the
    timed shapes."""
    from minigpt4_tpu_torch.tools import _harness as h

    n, k = 27648, 5120
    for m, halves in ((1, 1), (4, 1), (5, 2), (8, 2)):
        mmas = probes.ring_mmas(n, k, m, "group_i8")
        assert mmas >= n // 16 * (k // 32) * halves and mmas % halves == 0
    ops = probes.MMA_OPS * probes.ring_mmas(n, k, 8, "group_i8")
    nbytes = n * k + n * k // 32 * 4
    assert h.bound(nbytes, ops, h.INT8_OPS) == (pytest.approx(nbytes / h.HBM_BPS * 1e3), "bytes")
    ops_s4 = probes.MMA_OPS * probes.ring_mmas(13824, 5120, 16, "int_dot", "s4xs4")
    assert ops_s4 / h.INT8_OPS < 13824 * 5120 / 2 / h.HBM_BPS


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


# the redesign's host-side pieces: the exact x split of the tensor-core path,
# the launch's partition of rows and K, the bound in the kernel's units


def _wide_rows(rng, m: int, k: int) -> np.ndarray:
    """Rows of x whose magnitudes span 2^-20 .. 2^10, with signs, zeros and
    powers of two mixed in."""
    x = rng.normal(0, 1, (m, k)) * np.exp2(rng.uniform(-20, 10, (m, k)))
    x[:, :8] = [0.0, -0.0, 1.0, -2.0 ** -20, 2.0 ** 10, 3.0, 1 + 2 ** -23, -(1 + 2 ** -9)]
    return x.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_bf16x3_parts_sum_to_x_exactly(seed):
    x = torch.from_numpy(_wide_rows(np.random.default_rng(seed), 8, 4096))
    hi, mid, lo = probes.split_bf16x3(x)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    # the kernel's order: lo + mid first, then hi, each sum exact in f32
    assert torch.equal((hi.float() + mid.float()) + lo.float(), x)
    assert torch.equal(hi.float() + (mid.float() + lo.float()), x)
    assert torch.equal(hi.float(), x.to(torch.bfloat16).float())
    # each part is the rounding of what the ones before left
    assert torch.equal(lo.float(), x - hi.float() - mid.float())


@pytest.mark.parametrize("storage", list(probes.STORAGES))
def test_code_values_are_exact_in_bf16(storage):
    """The tensor-core path feeds the codes' values as bf16: every value of
    every storage (integers -128..255, or bf16 weights) is exact there."""
    gen = torch.Generator().manual_seed(7)
    w = probes.random_probe_weight(storage, 64, 512, gen, "cpu")
    v = probes.code_values(w)
    assert torch.equal(v.to(torch.bfloat16).float(), v)


PLAN_CASES = [(5120, 13824, 1, "dense", "nm"), (5120, 13824, 8, "i4", "nm"),
              (5120, 13824, 8, "q5d", "nm"), (5120, 13824, 1, "q5", "nm"),
              (203, 2048, 3, "i8", "nm"), (7, 256, 8, "u4", "nm"), (24, 13824, 1, "i8", "nm"),
              (27648, 5120, 1, "q5i4", "nm"), (5120, 13824, 1, "i8", "km"),
              (208, 2048, 8, "i4", "km"), (32, 13824, 8, "dense", "km"), (64, 256, 1, "i8", "km")]


@pytest.mark.parametrize("n,k,m,storage,layout", PLAN_CASES,
                         ids=[f"{c[3]}-{c[4]}-{c[0]}x{c[1]}-m{c[2]}" for c in PLAN_CASES])
def test_matvec_plan_covers_every_row_and_k_once(n, k, m, storage, layout):
    geo = probes.matvec_geometry(storage, layout, m)
    plan = probes.matvec_plan(n, k, m, storage, layout)
    nb = k // geo["fields"]
    rows = np.zeros(n, np.int64)
    cover: dict = {}  # (chunk rows) -> field-local k covered, over the ranks
    sizes = []
    for block in plan:
        b0, b1 = block["rows"]
        if block["rank"] == 0:
            sizes.append(b1 - b0)
        for ch in block["chunks"]:
            n0, n1 = ch["rows"]
            assert b0 <= n0 < n1 <= b1 and n1 - n0 <= geo["chunk"]
            assert (n0 - b0) % geo["tile"] == 0 and (layout == "nm" or n0 % 16 == 0)
            if block["rank"] == 0:
                rows[n0:n1] += 1
            assert ch["steps"], "every rank takes at least one step of every chunk"
            seen = cover.setdefault((n0, n1), np.zeros(nb, np.int64))
            for i0, i1 in ch["steps"]:
                assert i1 - i0 <= geo["step"] and (i1 - i0) % 32 == 0
                seen[i0:i1] += 1
    assert (rows == 1).all()
    # each field-local k once per chunk, so every k of every field once
    assert all((c == 1).all() for c in cover.values())
    # the warps split each step's 32-code groups of every field, whole groups
    groups = geo["fields"] * (geo["step"] // 32)
    assert groups == geo["warp_groups"] * probes.MATVEC_WARPS // geo["tile_sets"]
    # the rows (km: 16-column units) split evenly over the blocks (clusters)
    assert max(sizes) - min(sizes) <= (16 if layout == "km" else 1)


@pytest.mark.parametrize("rows,cols,esize,resident", [(5120, 13824, 1, 1056), (1280, 13824, 4, 1056),
                                                      (2304, 7680, 1, 1056), (768, 384, 2, 7)])
def test_op_chain_plan_covers_every_vector_once(rows, cols, esize, resident):
    plan = probes.op_chain_plan(rows, cols, esize, resident)
    tile_vecs = cols * esize // 16 * probes.TILE_ROWS
    assert tile_vecs % probes.OP_CHUNK == 0 and len(plan) <= resident
    seen = np.zeros(rows // probes.TILE_ROWS * tile_vecs, np.int64)
    for ranges in plan:
        for t, f, e in ranges:
            assert 0 <= f < e <= tile_vecs < 2 ** 31  # 32-bit offsets within a tile
            seen[t * tile_vecs + f:t * tile_vecs + e] += 1
    assert (seen == 1).all()
    per_block = [len(r) for r in plan]
    assert max(per_block) - min(per_block) <= 1


def test_matvec_bound_counts_the_kernels_units():
    from minigpt4_tpu_torch.tools import _harness as h
    from minigpt4_tpu_torch.tools import _qmm

    n, k = 5120, 13824
    b1, by1 = _qmm.matvec_bound(1e6, 1, n, k)
    assert by1 == "operations" and b1 == pytest.approx(2 * n * k / h.F32_FLOPS * 1e3)
    b8, by8 = _qmm.matvec_bound(1e6, 8, n, k)  # three bf16 parts on the tensor cores
    assert by8 == "operations" and b8 == pytest.approx(3 * 2 * 8 * n * k / h.BF16_FLOPS * 1e3)
    nib = n * k // 2 + n * k // 16  # i4 codes and scales: the bytes bind at M = 8
    assert _qmm.matvec_bound(nib, 8, n, k) == (pytest.approx(nib / h.HBM_BPS * 1e3), "bytes")


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
