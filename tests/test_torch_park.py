"""Parking idle sessions in the port (``DecodeState.park`` /
``ensure_device``, ``PagedKVPool.admit_host``, the pool's sites) against
the JAX package's on the CPU: the cases of tests/test_sessions.py
(park and unpark, parked sessions in batched groups, an excluded session
stays parked, restore into a parked session), plus the round trip of the
cache bit for bit in every cache type and admit_host against admit.
"""

import numpy as np
import pytest
import torch

from fixtures import build_gq_models
from minigpt4_tpu.engine.sampling import SamplingParams as JaxParams
from minigpt4_tpu.engine.sessions import SessionPool as JaxSessionPool
from minigpt4_tpu_torch.engine import SamplingParams
from minigpt4_tpu_torch.engine.paged import PagedKVPool
from minigpt4_tpu_torch.engine.sessions import SessionPool
from minigpt4_tpu_torch.models import llama as tllama

# one intra-op thread: the suite runs several pytest-xdist workers on the same cores, where
# torch's OpenMP pools spin against each other and run ~17x slower
torch.set_num_threads(1)

GREEDY = SamplingParams(temp=0.0)
POOL_KW = dict(session_ctx=256, n_ctx=256, n_batch=32)


@pytest.fixture(scope="module")
def gq_files(tmp_path_factory):
    return build_gq_models(tmp_path_factory.mktemp("torch_park"))


@pytest.fixture(scope="module")
def pool(gq_files):
    p = SessionPool(*gq_files, paged_pool_pages=8, device="cpu", **POOL_KW)
    yield p
    p.close()


@pytest.fixture(scope="module")
def jpool(gq_files):
    p = JaxSessionPool(*gq_files, paged_pool_pages=8, quant_mode="gq", **POOL_KW)
    yield p
    p.close()


def _state(s):
    return s.n_past, list(s.state.tokens)


def _two_turns(pool, params, park):
    s = pool.new_session()
    pool.system_prompt(s)
    pool.begin_chat(s, "hello")
    first = "".join(s.generate(limit=4, params=params))
    if park:
        s.park()
        assert s.state.cache is None and s.state.parked is not None
    pool.begin_chat(s, "and then?")  # a parked session is put back on its device
    assert s.state.cache is not None and s.state.parked is None
    second = "".join(s.generate(limit=4, params=params))
    out = (first, second, _state(s))
    s.close()
    return out


def test_park_unpark_preserves_greedy_continuation_like_jax(pool, jpool):
    """A session parked between turns continues as a session that never
    parked, and as JAX's parked session: the same ids and history."""
    got = _two_turns(pool, GREEDY, park=True)
    assert got == _two_turns(pool, GREEDY, park=False)
    assert got == _two_turns(jpool, JaxParams(temp=0.0), park=True)


@pytest.mark.parametrize("cache_dtype", ["f32", "bf16", "f8"])
def test_park_round_trips_the_cache_bit_for_bit(gq_files, cache_dtype):
    """park keeps only rows [0, n_past) as bits in host memory and the
    pending logits on the host; ensure_device gives back those rows bit for
    bit, zeros past them, and the logits."""
    p = SessionPool(*gq_files, device="cpu", cache_dtype=cache_dtype, **POOL_KW)
    try:
        s = p.new_session()
        p.begin_chat(s, "one two three four")
        st = s.state
        n = st.n_past
        rows = {kv: tllama._bits(t[:, :, :, :n]).clone() for kv, t in st.cache.items()}
        shape, dtype, logits = st.cache["k"].shape, st.cache["k"].dtype, st.logits.clone()
        s.park()
        assert st.cache is None and st.parked["dtype"] == dtype
        for kv in ("k", "v"):
            host = st.parked[kv]
            assert host.device.type == "cpu" and host.shape[3] == n
            assert host.dtype == tllama._bits(torch.zeros(1, dtype=dtype)).dtype
        s.park()  # parked already: nothing happens
        assert st.cache is None and st.parked is not None
        with p._lock:
            st.ensure_device()
        assert st.parked is None and st.cache["k"].shape == shape
        for kv in ("k", "v"):
            assert st.cache[kv].dtype == dtype
            assert torch.equal(tllama._bits(st.cache[kv][:, :, :, :n]), rows[kv])
            assert not tllama._bits(st.cache[kv][:, :, :, n:]).any()
        assert torch.equal(st.logits, logits)
        s.close()
    finally:
        p.close()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float8_e4m3fn])
def test_admit_host_fills_the_pages_admit_fills(dtype):
    """admit_host of a lane's parked rows writes the pages admit writes from
    the lane's dense cache (zeros past the cursor), bit for bit; a parked
    copy of another cache type is refused."""
    cfg = tllama.LlamaConfig(n_vocab=8, n_embd=16, n_head=2, n_layer=2, n_rot=8, n_ff=32,
                             n_ctx=256)
    gen = torch.Generator().manual_seed(3)
    n_past = 130
    lane = {kv: torch.randn((2, 1, 2, 256, 8), generator=gen).to(dtype) for kv in "kv"}
    for t in lane.values():
        t[:, :, :, n_past:] = 0
    a = PagedKVPool(cfg, n_pages=4, capacity=256, dtype=dtype, device="cpu")
    b = PagedKVPool(cfg, n_pages=4, capacity=256, dtype=dtype, device="cpu")
    pa = a.admit(lane, n_past)
    parked = {kv: tllama._bits(t[:, :, :, :n_past]).clone() for kv, t in lane.items()}
    parked["dtype"] = dtype
    pb = b.admit_host(parked, n_past)
    assert pa == pb and a.free_pages == b.free_pages == 2
    for kv in "kv":
        assert torch.equal(tllama._bits(getattr(a, kv)), tllama._bits(getattr(b, kv)))
    back = b.evict(pb, 256)
    for kv in "kv":
        assert torch.equal(tllama._bits(back[kv]), tllama._bits(lane[kv]))
    with pytest.raises(ValueError, match="parked cache"):
        b.admit_host(dict(parked, dtype=torch.float16), n_past)
    assert b.free_pages == 4


def test_parked_sessions_join_window_groups_like_jax(pool, jpool):
    """A parked session joins a paged group from its host copy (ensure_device
    is never called) and a dense group after ensure_device; both give the
    text and state of a session that never parked, and JAX's."""
    def prepared(p, park):
        s = p.new_session()
        p.begin_chat(s, "one two")
        if park:
            s.park()
        return s

    want_s = prepared(pool, False)
    want = pool.generate_batch([want_s], limit=6, params=GREEDY, decode_chunk=2)
    for paged in (True, False):
        s = prepared(pool, True)
        calls = []
        orig = s.state.ensure_device
        s.state.ensure_device = lambda: (calls.append(1), orig())[1]
        assert pool.generate_batch([s], limit=6, params=GREEDY, decode_chunk=2,
                                   paged=paged) == want
        assert (calls == []) == paged and _state(s) == _state(want_s)
        assert s.state.parked is None and s.state.cache is not None
        s.close()
    js = prepared(jpool, True)
    assert jpool.generate_batch([js], limit=6, params=JaxParams(temp=0.0),
                                decode_chunk=2) == want
    assert _state(js) == _state(want_s)
    for x in (want_s, js):
        x.close()


@pytest.mark.parametrize("paged", [True, False])
def test_excluded_parked_session_stays_parked(pool, paged):
    """A parked session without room for a chunk is left out of the group
    and stays parked (no copy to the card for a lane that never decodes)."""
    a, b = pool.new_session(), pool.new_session()
    pool.begin_chat(a, "one two")
    pool.begin_chat(b, "three")
    a.state.n_past = pool.session_ctx - 1
    a.state.tokens = [-1] * a.state.n_past
    a.park()
    got = pool.generate_batch([a, b], limit=3, params=GREEDY, decode_chunk=2, paged=paged)
    assert a.state.parked is not None and a.state.cache is None
    assert got[0] == "" and len(got[1]) > 0
    a.close()
    b.close()


def test_save_and_restore_of_a_parked_session(pool, tmp_path):
    """save() of a parked session checkpoints its live state and restore()
    into a parked session puts it back first; the continuation is the one
    of the state that never parked."""
    a = pool.new_session()
    pool.begin_chat(a, "one two")
    ckpt, ckpt_parked = tmp_path / "st.npz", tmp_path / "parked.npz"
    a.state.save(ckpt)
    a.park()
    a.state.save(ckpt_parked)
    assert a.state.parked is None and a.state.cache is not None
    z, zp = np.load(ckpt), np.load(ckpt_parked)
    n = int(z["n_past"])
    for name in ("k", "v"):  # the rows past the cursor come back as zeros
        assert np.array_equal(z[name][:, :, :, :n], zp[name][:, :, :, :n])
    for name in ("n_past", "logits", "tokens", "n_keep"):
        assert np.array_equal(z[name], zp[name])
    want = "".join(a.generate(limit=4, params=GREEDY))
    a.park()
    a.state.restore(ckpt)
    assert a.state.parked is None and a.state.cache is not None
    assert "".join(a.generate(limit=4, params=GREEDY)) == want
    a.close()


def test_parked_session_resets_and_starts_an_image_chat(pool):
    """reset() of a parked session keeps its geometry: an image upload (reset,
    system prompt, encode) then works on it, and its chat is the one of a
    fresh session."""
    size = pool.engine.vision_cfg.vit.image_size
    img = np.random.default_rng(0).normal(0, 1, (3, size, size)).astype(np.float32)
    a = pool.new_session()
    pool.begin_chat(a, "one two")
    a.park()
    a.upload_image(img)
    a.ask("what is it?")
    b = pool.new_session()
    b.upload_image(img)
    b.ask("what is it?")
    assert _state(a) == _state(b)
    assert "".join(a.generate(limit=4, params=GREEDY)) == \
        "".join(b.generate(limit=4, params=GREEDY))
    a.close()
    b.close()


def test_riding_state_refuses_ensure_device(pool):
    """A state whose cache lives in a batched group (cache None, not parked)
    is no-op for park and refused by ensure_device."""
    s = pool.new_session()
    pool.begin_chat(s, "one")
    cache, s.state.cache = s.state.cache, None
    s.park()
    assert s.state.parked is None
    with pytest.raises(ValueError, match="not resident"):
        s.state.ensure_device()
    s.state.cache = cache
    s.close()


@pytest.mark.parametrize("shape,limit", [((4, 1, 3, 5, 8), 200), ((4, 1, 3, 5, 8), 7),
                                         ((2, 9), 5), ((1000,), 64)])
def test_staging_pieces_cover_the_rows_within_the_bound(shape, limit):
    """The staged copies' slices (``hostcopy._pieces``) of a cache's leading
    rows, a strided view as parks and installs take it, cover every element
    once, in order, each within the staging buffer's bytes wherever a single
    last-dimension row fits; host_copy gives a contiguous copy, not a
    view."""
    from minigpt4_tpu_torch.engine import hostcopy

    full = torch.arange(int(np.prod(shape)) * 2, dtype=torch.int16).reshape(
        shape[:-2] + (shape[-2] * 2, shape[-1]) if len(shape) > 1 else (shape[0] * 2,))
    src = full[..., :shape[-2], :] if len(shape) > 1 else full[:shape[0]]
    dst = torch.zeros(shape, dtype=torch.int16)
    seen = 0
    for d, s in hostcopy._pieces(dst, src, limit):
        assert d.shape == s.shape
        row = s.shape[-1] * s.element_size() if s.dim() else s.element_size()
        assert s.numel() * s.element_size() <= max(limit, row)
        d.copy_(s)
        seen += s.numel()
    assert seen == src.numel() and torch.equal(dst, src)
    out = hostcopy.host_copy(src)
    assert torch.equal(out, src) and out.is_contiguous()
    assert out.untyped_storage().data_ptr() != full.untyped_storage().data_ptr()
