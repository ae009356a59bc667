"""Port parity: minigpt4_tpu_torch.ops.flash_decode against the JAX
flash_decode_attention (Pallas in interpret mode), same numpy inputs.

Both compute the causal softmax in f32 over the live cache blocks, so they
agree to f32 rounding: rtol/atol 2e-5, as tests/test_flash_decode.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from minigpt4_tpu.ops.flash_decode import flash_decode_attention as jax_flash
from minigpt4_tpu_torch.ops import flash_decode as tfd

CASES = [
    # (S, pos0): decode steps, the 8-row text bucket, the 32-row image chunk
    (1, 0), (1, 300), (8, 0), (8, 130), (32, 0), (32, 250),
    # one cursor per batch row
    (1, [5, 400]), (8, [0, 250]), (32, [97, 128]),
]


def _inputs(s, pos0, cache_dtype, seed):
    rng = np.random.default_rng(seed)
    b = 1 if isinstance(pos0, int) else len(pos0)
    l, h, c, dh = 2, 4, 512, 128  # 4 blocks of 128 on the JAX side
    q = rng.normal(0, 1, (b, h, s, dh)).astype(np.float32)
    ck = rng.normal(0, 1, (l, b, h, c, dh)).astype(np.float32)
    cv = rng.normal(0, 1, (l, b, h, c, dh)).astype(np.float32)
    tk = torch.from_numpy(ck).to(cache_dtype)
    tv = torch.from_numpy(cv).to(cache_dtype)
    # both sides read the same (possibly bf16-rounded) cache values
    return q, tk, tv, tk.float().numpy(), tv.float().numpy()


@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("s,pos0", CASES)
def test_plain_matches_jax_kernel(s, pos0, cache_dtype):
    q, tk, tv, ck, cv = _inputs(s, pos0, cache_dtype, seed=s * 1000 + np.sum(pos0))
    scale = 1.0 / np.sqrt(q.shape[-1])
    jpos = jnp.asarray(pos0, jnp.int32)
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), 1, jpos, scale))
    got = tfd.flash_decode_attention(torch.from_numpy(q), tk, tv, 1, pos0, scale)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def _numpy_attention(q, k, v, pos0, scale):
    s, c = q.shape[-2], k.shape[-2]
    mask = np.arange(c)[None, :] <= (pos0 + np.arange(s))[:, None]
    sc = np.einsum("bhsd,bhcd->bhsc", q.astype(np.float64), k.astype(np.float64)) * scale
    sc = np.where(mask, sc, -np.inf)
    p = np.exp(sc - sc.max(-1, keepdims=True))
    return np.einsum("bhsc,bhcd->bhsd", p / p.sum(-1, keepdims=True), v.astype(np.float64))


@pytest.mark.parametrize("pos0,s", [(490, 8), (499, 1)])
def test_cache_tail_is_masked_not_refused(pos0, s):
    # a cache length that is no multiple of any block: keys past C are
    # masked (the JAX kernel refuses such caches)
    rng = np.random.default_rng(7)
    q = rng.normal(0, 1, (1, 2, s, 64)).astype(np.float32)
    k = rng.normal(0, 1, (1, 2, 500, 64)).astype(np.float32)
    v = rng.normal(0, 1, (1, 2, 500, 64)).astype(np.float32)
    got = tfd.flash_decode_attention(torch.from_numpy(q), torch.from_numpy(k[None]),
                                     torch.from_numpy(v[None]), 0, pos0, 0.125)
    want = _numpy_attention(q, k, v, pos0, 0.125)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)



# ---------------------------------------------------------------------------
# the kernel's key splits: the plan and the plain split-then-merge
# ---------------------------------------------------------------------------

SMS = 132  # NVIDIA H100 SXM


@pytest.mark.parametrize("b,h", [(1, 32), (1, 40), (4, 32), (8, 40)])
@pytest.mark.parametrize("live", [-5, 0, 1, 63, 64, 65, 241, 1000, 2047, 2048])
def test_split_plan_covers_the_live_keys_in_tiles(live, b, h):
    plan = tfd.split_plan(live, b, h, SMS, capacity=2048)
    if live <= 0:  # a cursor before the first key: no split reads anything
        assert plan == []
        return
    assert plan[0][0] == 0 and plan[-1][1] == live
    assert all(k0 < k1 for k0, k1 in plan)
    assert all(a[1] == b_[0] for a, b_ in zip(plan, plan[1:]))  # in order, no gap, no overlap
    assert all(k0 % tfd.KEY_TILE == 0 for k0, _ in plan)
    assert tfd.PAGE % tfd.KEY_TILE == 0  # a tile never straddles two pool pages
    assert len(plan) <= tfd.n_splits(2048, b, h, SMS) <= tfd.MAX_SPLITS


@pytest.mark.parametrize("capacity,b,h,want", [
    (2048, 1, 32, 8),    # 256 blocks on 132 SMs, two each
    (2048, 1, 40, 6),    # the 13B chat: 240 blocks
    (2048, 4, 32, 8),    # ragged lanes: up to eight blocks per SM
    (640, 8, 40, 3),     # an 8-lane serving group
    (100, 1, 4, 2),      # never more splits than tiles
    (2048, 32, 40, 1),   # 1280 (lane, head) pairs fill the card unsplit
])
def test_n_splits(capacity, b, h, want):
    ns = tfd.n_splits(capacity, b, h, SMS)
    assert ns == want
    per_sm = tfd.WAVE_BLOCKS if b == 1 else tfd.RAGGED_WAVE_BLOCKS
    assert b * h * ns <= per_sm * SMS or ns == 1


SPLIT_CASES = [(1, 300), (8, 130), (32, 250), (1, [5, 400])]


@pytest.mark.parametrize("splits", [1, 2, 16])
@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("s,pos0", SPLIT_CASES)
def test_split_merge_matches_plain_and_jax(s, pos0, cache_dtype, splits):
    q, tk, tv, ck, cv = _inputs(s, pos0, cache_dtype, seed=s * 7 + splits)
    scale = 1.0 / np.sqrt(q.shape[-1])
    got = tfd.flash_decode_split_ref(torch.from_numpy(q), tk, tv, 1, pos0, scale, splits)
    want = tfd.flash_decode_ref(torch.from_numpy(q), tk, tv, 1, pos0, scale)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5, atol=2e-5)
    jpos = jnp.asarray(pos0, jnp.int32)
    ref = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), 1, jpos, scale))
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("splits", [1, 2, 16])
@pytest.mark.parametrize("s,pos0", [(8, -3), (1, [5, -40, 400]), (8, [-300, 0, 127]),
                                    (32, 250)])
def test_split_merge_stats_match_stats_ref(s, pos0, splits):
    """The merged partials against flash_decode_stats_ref, signed cursors
    included: the same m, l and acc (f32 sums regrouped), and exactly the
    neutral m = -inf, l = 0, acc = 0 where a row sees no key."""
    q, tk, tv, _, _ = _inputs(s, pos0, torch.float32, seed=11 + splits)
    q = torch.from_numpy(q)
    acc, m, l = tfd.flash_decode_split_ref(q, tk, tv, 1, pos0, 0.0884, splits, return_stats=True)
    wacc, wm, wl = tfd.flash_decode_stats_ref(q, tk, tv, 1, pos0, 0.0884)
    empty = torch.isneginf(wm)
    assert torch.equal(torch.isneginf(m), empty)
    assert (l[empty] == 0).all() and (acc[empty] == 0).all()
    torch.testing.assert_close(m[~empty], wm[~empty], rtol=0, atol=1e-6)
    torch.testing.assert_close(l, wl, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(acc, wacc, rtol=1e-5, atol=1e-5)
