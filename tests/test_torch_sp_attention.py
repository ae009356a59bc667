"""The port's flash-decode partials (``return_stats=True``) and its
sequence-parallel attention against the JAX package's
(``tests/test_sp_attention.py``): the stats mode against JAX's
``flash_decode_attention(return_stats=True)`` in interpret mode, empty and
partly empty slices, the merge of C-slices computed in one process, and
``sp_flash_decode_attention`` over 4 gloo ranks (spawned processes) against
JAX's ``shard_map`` over 4 virtual CPU devices."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from minigpt4_tpu.ops.flash_decode import flash_decode_attention as jflash
from minigpt4_tpu.ops.flash_decode import sp_flash_decode_attention as jsp
from minigpt4_tpu_torch.ops import flash_decode as fd
from minigpt4_tpu_torch.parallel import dryrun
from torch_rank_tasks import rank_tasks

DH = 128
SCALE = 1.0 / np.sqrt(DH)
SP_POSITIONS = [0, 100, 700, 1000]


def _inputs(seed: int, b: int, h: int, s: int, c: int, cache: str = "float32"):
    """q [B, H, S, Dh] and a one-layer cache [1, B, H, C, Dh] as f32 numpy;
    a bf16 cache holds values that bf16 represents exactly."""
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (b, h, s, DH)).astype(np.float32)
    ck, cv = (rng.normal(0, 1, (1, b, h, c, DH)).astype(np.float32) for _ in range(2))
    if cache == "bfloat16":
        ck, cv = (torch.from_numpy(a).to(torch.bfloat16).float().numpy() for a in (ck, cv))
    return q, ck, cv


def _torch(a: np.ndarray, cache: str = "float32") -> torch.Tensor:
    return torch.from_numpy(a).to(getattr(torch, cache))


def _jax(a: np.ndarray, cache: str = "float32"):
    return jnp.asarray(a, jnp.bfloat16 if cache == "bfloat16" else jnp.float32)


@pytest.mark.parametrize("cache", ["float32", "bfloat16"])
@pytest.mark.parametrize("pos0", [0, 200, 511])
def test_stats_match_jax(pos0, cache):
    """(acc, m, l) of the port's plain version equal JAX's kernel's: m and l
    to f32 rounding, acc / l (the normalized output) to rtol 1e-5."""
    q, ck, cv = _inputs(pos0, 1, 2, 3, 512, cache)
    jacc, jm, jl = (np.asarray(a) for a in jflash(
        jnp.asarray(q), _jax(ck, cache), _jax(cv, cache), 0, jnp.int32(pos0), SCALE,
        return_stats=True))
    acc, m, l = (t.numpy() for t in fd.flash_decode_attention(
        _torch(q), _torch(ck, cache), _torch(cv, cache), 0, pos0, SCALE, return_stats=True))
    assert acc.shape == (1, 2, 3, DH) and m.shape == l.shape == (1, 2, 3)
    np.testing.assert_allclose(m, jm, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(l, jl, rtol=1e-5)
    np.testing.assert_allclose(acc / l[..., None], jacc / jl[..., None], rtol=1e-5, atol=1e-6)
    # and the partials normalize to the port's own normalized attention
    want = fd.flash_decode_attention(_torch(q), _torch(ck, cache), _torch(cv, cache), 0, pos0,
                                     SCALE).numpy()
    np.testing.assert_allclose(acc / l[..., None], want, rtol=1e-5, atol=1e-6)


def test_stats_empty_slice():
    """pos0 = -300: no key is visible, so the partials are zero and m is
    -inf (JAX: zero partials too, with m at the f32 minimum)."""
    q, ck, cv = _inputs(3, 1, 2, 1, 256)
    acc, m, l = fd.flash_decode_attention(_torch(q), _torch(ck), _torch(cv), 0, -300, SCALE,
                                          return_stats=True)
    assert torch.isneginf(m).all() and (l == 0).all() and (acc == 0).all()
    assert not torch.isnan(acc).any()
    jacc, _, jl = jflash(jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), 0, jnp.int32(-300),
                         SCALE, return_stats=True)
    assert float(np.asarray(jl).max()) == 0.0 and float(np.abs(np.asarray(jacc)).max()) == 0.0


def test_stats_partly_empty_rows():
    """pos0 = -2 with 4 rows: rows 0 and 1 see no key (m = -inf, l = 0,
    acc = 0), rows 2 and 3 see keys 0 and 0..1, against f64 numpy."""
    q, ck, cv = _inputs(5, 1, 2, 4, 256)
    acc, m, l = (t.numpy() for t in fd.flash_decode_attention(
        _torch(q), _torch(ck), _torch(cv), 0, -2, SCALE, return_stats=True))
    assert np.isneginf(m[..., :2]).all() and (l[..., :2] == 0).all() and (acc[..., :2, :] == 0).all()
    for r, n_keys in ((2, 1), (3, 2)):
        sc = np.einsum("bhd,bhcd->bhc", q[:, :, r].astype(np.float64) * SCALE,
                       ck[0, :, :, :n_keys].astype(np.float64))
        mm = sc.max(-1)
        p = np.exp(sc - mm[..., None])
        np.testing.assert_allclose(m[..., r], mm, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(l[..., r], p.sum(-1), rtol=1e-5)
        np.testing.assert_allclose(acc[..., r, :], np.einsum("bhc,bhcd->bhd", p, cv[0, :, :, :n_keys]),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("pos0", SP_POSITIONS)
def test_local_merge_of_four_slices(pos0):
    """The partials of 4 C-slices, merged in one process, equal the port's
    normalized attention over the whole cache and JAX's single-device
    flash (2e-5, JAX's bound for its SP merge)."""
    q, ck, cv = _inputs(21 + pos0, 1, 2, 1, 1024)
    c_local = 256
    parts = [fd.flash_decode_attention(
        _torch(q), _torch(np.ascontiguousarray(ck[:, :, :, i * c_local:(i + 1) * c_local])),
        _torch(np.ascontiguousarray(cv[:, :, :, i * c_local:(i + 1) * c_local])), 0,
        pos0 - i * c_local, SCALE, return_stats=True) for i in range(4)]
    got = fd.merge_partials(parts).numpy()
    want = fd.flash_decode_attention(_torch(q), _torch(ck), _torch(cv), 0, pos0, SCALE).numpy()
    jwant = np.asarray(jflash(jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), 0,
                              jnp.int32(pos0), SCALE))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, jwant, rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module")
def sp_case():
    """One spawn of 4 gloo ranks running sp_flash_decode_attention at every
    position of SP_POSITIONS; the inputs and every rank's outputs."""
    q, ck, cv = _inputs(21, 1, 2, 1, 1024)
    task = ("sp", "sp", dict(q=q, ck=ck, cv=cv, positions=SP_POSITIONS, scale=SCALE))
    ranks = dryrun.run_ranks(rank_tasks, 4, ([task],), device="cpu", timeout_s=180)
    return (q, ck, cv), [r["sp"] for r in ranks]


@pytest.mark.parametrize("pos0", SP_POSITIONS)
def test_sp_over_four_gloo_ranks_matches_jax_shard_map(sp_case, pos0):
    """The C-sharded cache over 4 ranks, merged with one MAX and two SUM
    all-reduces, equals JAX's shard_map SP over 4 virtual devices and the
    single-device flash (rtol and atol 2e-5, JAX's bound); every rank
    returns the same result."""
    (q, ck, cv), ranks = sp_case
    got = ranks[0][pos0]
    for other in ranks[1:]:
        np.testing.assert_array_equal(other[pos0], got)
    c_local = ck.shape[3] // 4
    mesh = Mesh(np.array(jax.devices()[:4]), ("sp",))

    def fn(q_l, ck_l, cv_l):
        idx = jax.lax.axis_index("sp")
        return jsp(q_l, ck_l, cv_l, 0, jnp.int32(pos0), SCALE, "sp", idx * c_local)

    sharded = jax.jit(jax.shard_map(
        fn, mesh=mesh,
        in_specs=(P(), P(None, None, None, "sp", None), P(None, None, None, "sp", None)),
        out_specs=P(), check_vma=False))
    want = np.asarray(sharded(jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv)))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    single = fd.flash_decode_attention(_torch(q), _torch(ck), _torch(cv), 0, pos0, SCALE).numpy()
    np.testing.assert_allclose(got, single, rtol=2e-5, atol=2e-5)
