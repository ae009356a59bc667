"""Port parity: the PyTorch decoder against the JAX llama.forward on the
gq fixture (q5_k projections, K % 256 == 0), with the JAX parameters
carried over by minigpt4_tpu_torch.interop so both compute with the same
weights.  The JAX side runs its Pallas kernels in interpret mode.

Tolerance: logits within 1e-3 of max|logit| for the 8-row chunk and the
decode steps.  The JAX decode matmul splits activations into two i8 planes
(<= absmax * 2^-15 per element) where the port keeps f32; everything else
is f32 or the same bf16 roundings.  The 40-row chunk runs the bf16 prefill
matmul, which rounds its f32 input to bf16.  Port and JAX sum the norms
and the attention in different orders, so the inputs of w1/w3 in layer 0
differ in the last f32 bits (6682 of 10240 elements, <= 2.5e-7 relative);
2 of them then round to different bf16 values, which moves the w1/w3
output by 1e-4 of its max, and the flips compound over the layers to
1.5e-3 of max|logit|.  That step is held to 5e-3 (2.5 bf16 unit
roundoffs, 2^-9 each); so that this cannot hide a fault of the prefill
matmul, every fixture projection is also fed identical 40-row inputs on
both sides and held to 1e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fixtures import build_gq_models
from minigpt4_tpu.engine.device_sampling import DeviceSamplingConfig as JaxSampling
from minigpt4_tpu.formats import LlamaFileReader
from minigpt4_tpu.models import llama as jllama
from minigpt4_tpu.models.params import linear as jparams_linear
from minigpt4_tpu_torch import interop
from minigpt4_tpu_torch.engine.device_sampling import DeviceSamplingConfig, LaneRows
from minigpt4_tpu_torch.models import llama as tllama
from minigpt4_tpu_torch.models.params import linear as tparams_linear
from minigpt4_tpu_torch.ops.group_i8 import GroupQuant

# one intra-op thread: the suite runs several pytest-xdist workers on the same cores, where
# torch's OpenMP pools spin against each other and run ~17x slower
torch.set_num_threads(1)

N_CTX = 256


@pytest.fixture(scope="module")
def loaded(tmp_path_factory):
    _, llm = build_gq_models(tmp_path_factory.mktemp("torch_llama"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MINIGPT4_TPU_GQ_PACK", "0")  # interop maps unpacked codes
        with LlamaFileReader(llm) as r:
            jparams, jcfg = jllama.load_params(r, jnp.float32, n_ctx=N_CTX, quant_mode="gq")
            tparams_file, tcfg = tllama.load_params(r, torch.float32, n_ctx=N_CTX, device="cpu")
    tparams = interop.llama_params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    return jparams, jcfg, tparams, tparams_file, tcfg


def _close(got, want, tol=1e-3):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def test_file_loader_bitwise_equal_to_interop(loaded):
    _, _, tparams, tparams_file, _ = loaded

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, f"{prefix}{k}.")
        elif isinstance(tree, GroupQuant):
            for k, v in tree.tensors().items():
                yield prefix + k, v
        else:
            yield prefix.rstrip("."), tree

    a, b = dict(leaves(tparams)), dict(leaves(tparams_file))
    assert a.keys() == b.keys()
    assert "layers.wqkv.w.codes" in a and a["layers.wqkv.w.codes"].shape[0] == 2
    for name in a:
        assert a[name].dtype == b[name].dtype, name
        assert torch.equal(a[name], b[name]), name


def test_forward_and_decode_loop_match_jax(loaded):
    jparams, jcfg, tparams, _, tcfg = loaded
    rng = np.random.default_rng(0)
    jcache = jllama.init_cache(jcfg, 1, jnp.bfloat16)
    tcache = tllama.init_cache(tcfg, 1, torch.bfloat16, "cpu")
    pos = 0
    # a 40-row prefill (plain attention), an 8-row bucket (flash kernel)
    for s, tol in ((40, 5e-3), (8, 1e-3)):
        e = (rng.normal(0, 0.2, (1, s, tcfg.n_embd))).astype(np.float32)
        jl, jcache = jllama.forward(jparams, jcache, jnp.asarray(e), jnp.int32(pos), jcfg,
                                    jnp.int32(s - 1), attn_len=128)
        tl = tllama.forward(tparams, tcache, torch.from_numpy(e), pos, tcfg, s - 1, attn_len=128)
        _close(tl.numpy(), np.asarray(jl), tol)
        pos += s
    # single decode steps fed with token embeddings
    for tok in (7, 100, 261):
        je = jllama.embed_tokens(jparams, jnp.asarray([[tok]], jnp.int32))
        jl, jcache = jllama.forward(jparams, jcache, je, jnp.int32(pos), jcfg, attn_len=128)
        te = tllama.embed_tokens(tparams, torch.tensor([[tok]]))
        tl = tllama.forward(tparams, tcache, te, pos, tcfg, attn_len=128)
        _close(tl.numpy(), np.asarray(jl))
        pos += 1
    # the fused greedy decode loop: identical tokens
    jtoks, jfinal, _ = jllama.decode_loop(jparams, jcache, jl, jnp.int32(pos), 6,
                                          jax.random.PRNGKey(0), JaxSampling(temp=0.0), jcfg,
                                          attn_len=128)
    gen = torch.Generator().manual_seed(0)
    ttoks, tfinal = tllama.decode_loop(tparams, tcache, tl, pos, 6, [gen],
                                       LaneRows((DeviceSamplingConfig(temp=0.0),)), tcfg)
    assert ttoks.tolist() == np.asarray(jtoks).tolist()
    _close(tfinal.numpy(), np.asarray(jfinal))


@pytest.mark.parametrize("name", ["wqkv", "wo", "w13", "w2"])
@pytest.mark.parametrize("li", [0, 1])
def test_prefill_matmuls_match_jax_on_identical_inputs(loaded, name, li):
    # the 40-row forward above is held to 5e-3 for bf16 flips of unequal
    # inputs; fed the same inputs, every fixture projection's bf16 prefill
    # matmul agrees to f32 summation order (1e-4, as test_torch_group_i8)
    # (the JAX tree keeps wq/wk/wv and w1/w3 apart; the port fuses them)
    jparams, _, tparams, _, _ = loaded
    parts = {"wqkv": ("wq", "wk", "wv"), "w13": ("w1", "w3")}.get(name, (name,))
    tw = tparams["layers"][name]
    k = tw["w"].n_in
    x = np.random.default_rng(10 * li + k).normal(0, 1, (40, k)).astype(np.float32)
    want = np.concatenate([np.asarray(jparams_linear(jnp.asarray(x), jparams["layers"][p], li))
                           for p in parts], axis=-1).astype(np.float64)
    got = tparams_linear(torch.from_numpy(x), tw, li).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_rope_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (1, 2, 5, 16)).astype(np.float32)
    want = np.asarray(jllama.rope_interleaved(jnp.asarray(x), jnp.arange(5) + 37, 10000.0))
    cos, sin = tllama.rope_tables(torch.arange(5) + 37, 16, 10000.0)
    got = tllama.rope_interleaved(torch.from_numpy(x), cos, sin).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("pos0", [0, 600, [100, 900]], ids=["pos0", "pos600", "per-row"])
def test_long_prefill_attention_matches_jax_blockwise(pos0):
    # spans above PREFILL_FLASH_SPAN compute P.V in f32, as the JAX
    # package's blockwise scan does; both sum in f32, so rtol/atol 2e-5
    rng = np.random.default_rng(4)
    b = 1 if isinstance(pos0, int) else len(pos0)
    h, s, dh, span = 2, 40, 64, 1024
    assert span > tllama.PREFILL_FLASH_SPAN
    q = rng.normal(0, 1, (b, h, s, dh)).astype(np.float32)
    ck, cv = (torch.from_numpy(rng.normal(0, 1, (1, b, h, span, dh)).astype(np.float32))
              .to(torch.bfloat16) for _ in range(2))
    got = tllama._prefill_attention(torch.from_numpy(q), ck, cv, 0, pos0, span, dh)
    want = jllama._blockwise_attention(jnp.asarray(q), jnp.asarray(ck[0].float().numpy()),
                                       jnp.asarray(cv[0].float().numpy()),
                                       jnp.asarray(pos0, jnp.int32), 1.0 / np.sqrt(dh))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
