"""Chat checkpoints on the port: ``save_state`` / ``restore_state`` round
trips on f32, bf16 and e4m3 caches (the cache bits, cursor and history
restored exactly, the same sampled ids after the restore), a checkpoint the
JAX engine wrote restored by the port and continued with the JAX engine's
greedy ids, the refusals (another cache shape, a speculative-sampling
exclusion) and the cache tensors' storage.
"""

import numpy as np
import pytest
import torch

from fixtures import build_tiny_models
from minigpt4_tpu.engine import MiniGPT4Engine as JaxEngine
from minigpt4_tpu.engine import SamplingParams as JaxParams
from minigpt4_tpu.engine.engine import CACHE_DTYPES as JAX_CACHE_DTYPES
from minigpt4_tpu_torch.engine import MiniGPT4Engine, SamplingParams
from minigpt4_tpu_torch.image import preprocess
from minigpt4_tpu_torch.models.llama import _bits

# one intra-op thread: the suite runs several pytest-xdist workers on the same cores, where
# torch's OpenMP pools spin against each other and run ~17x slower
torch.set_num_threads(1)

IMAGE = np.random.default_rng(0).integers(0, 255, (40, 50, 3), dtype=np.uint8)
N_CTX = 256


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return build_tiny_models(tmp_path_factory.mktemp("torch_state"))


def _image_turn(eng) -> None:
    emb = eng.encode_image(preprocess(IMAGE, size=eng.vision_cfg.vit.image_size))
    eng.system_prompt()
    eng.begin_chat_image(emb, "what is it?")


@pytest.mark.parametrize("cache_dtype", ["f32", "bf16", "f8"])
def test_round_trip_is_exact(tiny, tmp_path, cache_dtype):
    eng = MiniGPT4Engine(*tiny, n_ctx=N_CTX, n_batch=32, device="cpu", cache_dtype=cache_dtype)
    try:
        _image_turn(eng)
        st = eng._st
        saved = {kv: _bits(t).clone() for kv, t in st.cache.items()}
        n_past, tokens, n_keep, logits = st.n_past, list(st.tokens), st.n_keep, st.logits.clone()
        eng.save_state(tmp_path / "chat.npz")
        sampled = SamplingParams(temp=0.8)
        first = list(eng.generate(limit=12, params=sampled))
        eng.reset_chat()
        eng.restore_state(tmp_path / "chat.npz")
        assert (st.n_past, st.tokens, st.n_keep) == (n_past, tokens, n_keep)
        assert torch.equal(st.logits, logits)
        assert all(torch.equal(_bits(st.cache[kv]), saved[kv]) for kv in saved)
        assert list(eng.generate(limit=12, params=sampled)) == first
    finally:
        eng.close()


@pytest.mark.parametrize("cache_dtype", ["f32", "bf16", "f8"])
def test_jax_checkpoint_continues_with_jax_ids(tiny, tmp_path, cache_dtype):
    """The JAX engine saves after an image turn and decodes greedily; the
    port restores the file into an engine of the same geometry and decodes
    the same ids."""
    path = tmp_path / "jax.npz"
    jeng = JaxEngine(*tiny, n_ctx=N_CTX, n_batch=32, cache_dtype=JAX_CACHE_DTYPES[cache_dtype])
    try:
        _image_turn(jeng)
        jeng.save_state(path)
        n_past, tokens = jeng.n_past, list(jeng._st.tokens)
        want = list(jeng.generate(limit=24, params=JaxParams(temp=0.0)))
    finally:
        jeng.close()
    eng = MiniGPT4Engine(*tiny, n_ctx=N_CTX, n_batch=32, device="cpu", cache_dtype=cache_dtype)
    try:
        gen = eng._st.generator.get_state()
        eng.restore_state(path)
        assert (eng.n_past, eng._st.tokens) == (n_past, tokens)
        assert torch.equal(eng._st.generator.get_state(), gen)  # no torch generator in the file
        assert list(eng.generate(limit=24, params=SamplingParams(temp=0.0))) == want
    finally:
        eng.close()


def test_restore_refusals_change_nothing(tiny, tmp_path):
    """Another cache shape raises ValueError before anything of the state
    changes.  A pending speculative-sampling exclusion (``spec_ban`` >= 0),
    refused before speculative decoding was ported, now restores with the
    rest of the checkpoint."""
    other = MiniGPT4Engine(*tiny, n_ctx=160, n_batch=32, device="cpu")
    eng = MiniGPT4Engine(*tiny, n_ctx=N_CTX, n_batch=32, device="cpu")
    try:
        other.system_prompt()
        other.save_state(tmp_path / "short.npz")
        eng.system_prompt()
        eng.begin_chat("hi")
        eng.save_state(tmp_path / "chat.npz")
        z = dict(np.load(tmp_path / "chat.npz"))
        z["spec_ban"] = np.int64(7)
        np.savez(tmp_path / "banned.npz", **z)
        before = (eng.n_past, list(eng._st.tokens), {kv: t.clone() for kv, t in eng.cache.items()})
        with pytest.raises(ValueError, match="cache shape"):
            eng.restore_state(tmp_path / "short.npz")
        assert (eng.n_past, eng._st.tokens) == before[:2]
        assert all(torch.equal(eng.cache[kv], t) for kv, t in before[2].items())
        eng.restore_state(tmp_path / "banned.npz")
        assert (eng.n_past, eng._st.tokens, eng._st.spec_ban) == (*before[:2], 7)
        assert all(torch.equal(eng.cache[kv], t) for kv, t in before[2].items())
    finally:
        other.close()
        eng.close()


def test_restore_keeps_the_cache_tensors(tiny, tmp_path):
    """Restore copies into the state's own tensors (captured CUDA graphs
    replay on their addresses), also from a checkpoint of another cache
    type, which it converts."""
    src = MiniGPT4Engine(*tiny, n_ctx=N_CTX, n_batch=32, device="cpu", cache_dtype="f32")
    eng = MiniGPT4Engine(*tiny, n_ctx=N_CTX, n_batch=32, device="cpu", cache_dtype="bf16")
    try:
        _image_turn(src)
        src.save_state(tmp_path / "f32.npz")
        cache = dict(eng.cache)
        ptrs = {kv: t.data_ptr() for kv, t in cache.items()}
        eng.restore_state(tmp_path / "f32.npz")
        assert all(eng.cache[kv] is cache[kv] for kv in cache)
        assert {kv: t.data_ptr() for kv, t in eng.cache.items()} == ptrs
        for kv in cache:
            assert torch.equal(eng.cache[kv], src.cache[kv].to(torch.bfloat16))
    finally:
        src.close()
        eng.close()
