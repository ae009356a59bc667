"""Port parity for the draft head's distillation (``train/draft.py``):
``teacher_targets`` and ``make_distill_step`` against the JAX package's,
then the port's own distillation run to JAX's criteria, the artifact in
both directions and the distilled head driving the port's drafted loop.

The teacher is tests/test_draft_head.py's tiny random llama (JAX's
``jax.random`` weights, carried to the port by ``interop``); the head
starts from one JAX ``init_draft_head`` artifact carried across by
``interop.trainable_from_numpy``, so both sides step from the same bits.
Run at T = 32 (inside the flash span, which ``use_flash=False`` bypasses)
and T = 64.

Tolerances (f32): teacher ids equal wherever JAX's top-2 margin exceeds
1e-4 of max|logit| (no position here is closer; every id is equal, f32 and
bf16 caches); the first step's loss within 1e-5 relative (measured <=
1.8e-7) and the agreement equal; its gradients within 1e-4 of each leaf's
max|grad| (measured <= 7.0e-7).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from minigpt4_tpu.models import llama as jllama
from minigpt4_tpu.train import draft as jdraft
from minigpt4_tpu_torch import interop
from minigpt4_tpu_torch.models import llama as tllama
from minigpt4_tpu_torch.train import draft as tdraft

# one intra-op thread: the suite runs several pytest-xdist workers on the same cores, where
# torch's OpenMP pools spin against each other and run ~17x slower
torch.set_num_threads(1)

JCFG = jllama.LlamaConfig(n_vocab=128, n_embd=64, n_head=2, n_layer=2, n_rot=32, n_ff=128,
                          n_ctx=64)
TCFG = tllama.LlamaConfig(n_vocab=128, n_embd=64, n_head=2, n_layer=2, n_rot=32, n_ff=128,
                          n_ctx=64)
HEAD = dict(d_draft=32, n_layer=1, n_head=2, n_ff=64)
WARM = 4
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4  # of each leaf's max|grad|
TIE = 1e-4  # of max|logit|


def _teacher(key):
    """tests/test_draft_head.py's teacher."""
    ks = jax.random.split(key, 8)
    d, ff, n_l, v = JCFG.n_embd, JCFG.n_ff, JCFG.n_layer, JCFG.n_vocab

    def nrm(k, *s, sc=0.05):
        return jax.random.normal(k, s, jnp.float32) * sc

    return {
        "tok_embeddings": nrm(ks[0], v, d, sc=0.5),
        "norm": jnp.ones((d,)),
        "output": {"w": nrm(ks[1], d, v, sc=0.5)},
        "layers": {
            "attention_norm": jnp.ones((n_l, d)),
            "wqkv": {"w": nrm(ks[2], n_l, d, 3 * d)},
            "wo": {"w": nrm(ks[3], n_l, d, d)},
            "ffn_norm": jnp.ones((n_l, d)),
            "w13": {"w": nrm(ks[4], n_l, d, 2 * ff)},
            "w2": {"w": nrm(ks[5], n_l, ff, d)},
        },
    }


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup():
    jt = _teacher(jax.random.PRNGKey(0))
    tt = interop.llama_params_from_numpy(_np(jt), "cpu")
    jart = jdraft.init_draft_head(jax.random.PRNGKey(1), JCFG.n_embd,
                                  jdraft.DraftHeadConfig(**HEAD))
    return jt, tt, jart


def _toks(t: int) -> np.ndarray:
    return np.random.default_rng(0).integers(0, JCFG.n_vocab, (8, t)).astype(np.int32)


def _grab_grads():
    """An optax transformation whose state after an update is the gradient
    (and whose update is zero): JAX's step then hands its grads back."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))


@pytest.mark.parametrize("t", [32, 64])
def test_teacher_targets_match_jax(setup, t):
    """The port's greedy targets equal JAX's away from top-2 ties, on the
    f32 cache and on a bf16 one (the default)."""
    jt, tt, _ = setup
    toks = _toks(t)
    logits, _ = jllama.forward(jt, jllama.init_cache(JCFG, 8, jnp.float32),
                               jllama.embed_tokens(jt, jnp.asarray(toks)), jnp.int32(0), JCFG,
                               all_logits=True)
    top2 = np.sort(np.asarray(logits), axis=-1)[..., -2:]
    tie = (top2[..., 1] - top2[..., 0]) <= TIE * np.abs(np.asarray(logits)).max()
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(jdraft.teacher_targets(jt, JCFG, jnp.asarray(toks), cache_dtype=jdt))
        got = tdraft.teacher_targets(tt, TCFG, torch.from_numpy(toks), cache_dtype=tdt)
        assert got.dtype == torch.int32 and got.shape == (8, t)
        assert np.array_equal(got.numpy()[~tie], want[~tie]), tdt


@pytest.mark.parametrize("t", [32, 64])
def test_first_distill_step_matches_jax(setup, t):
    """One distillation step from the same artifact: loss, agreement and
    every leaf's gradient as JAX's."""
    jt, tt, jart = setup
    toks = _toks(t)
    targets = jdraft.teacher_targets(jt, JCFG, jnp.asarray(toks), cache_dtype=jnp.float32)
    dhc = jdraft.DraftHeadConfig(**HEAD)
    grab = _grab_grads()
    jstep = jdraft.make_distill_step(dhc.llama_cfg(JCFG.n_vocab, JCFG.n_ctx), grab)
    _, jgrads, jloss, jacc = jstep(jart, grab.init(jart), jt["tok_embeddings"],
                                   jnp.asarray(toks), targets, WARM)

    art = interop.trainable_from_numpy(_np(jart), "cpu")
    leaves = tdraft.art_leaves(art)
    tcfg = tdraft.DraftHeadConfig(**HEAD).llama_cfg(TCFG.n_vocab, TCFG.n_ctx)
    step = tdraft.make_distill_step(tcfg, torch.optim.SGD(leaves, lr=0.0))
    _, loss, acc = step(art, tt["tok_embeddings"], torch.from_numpy(toks),
                        torch.from_numpy(np.array(targets)), WARM)
    assert float(loss) == pytest.approx(float(jloss), rel=LOSS_RTOL)
    assert float(acc) == float(jacc)
    for got, want in zip((p.grad for p in leaves), tdraft.art_leaves(_np(jgrads))):
        scale = np.abs(want).max()
        assert np.abs(got.numpy() - want).max() <= GRAD_TOL * scale


@pytest.mark.parametrize("t", [32, 64])
def test_distill_improves_agreement_and_integrates(setup, tmp_path, t):
    """tests/test_draft_head.py on the port: 60 AdamW(3e-3, weight decay
    1e-4) steps take the loss below 0.7x its start and raise the agreement;
    the artifact goes port -> JAX and JAX -> port; the distilled head
    drives the port's drafted loop to plain greedy's ids."""
    jt, tt, jart = setup
    toks = torch.from_numpy(_toks(t))
    targets = tdraft.teacher_targets(tt, TCFG, toks, cache_dtype=torch.float32)
    dhc = tdraft.DraftHeadConfig(**HEAD)
    dcfg = dhc.llama_cfg(TCFG.n_vocab, TCFG.n_ctx)
    art = interop.trainable_from_numpy(_np(jart), "cpu")
    emb = tt["tok_embeddings"]
    step = tdraft.make_distill_step(
        dcfg, torch.optim.AdamW(tdraft.art_leaves(art), lr=3e-3, weight_decay=1e-4))
    losses, accs = [], []
    for _ in range(61):  # the first at the initial artifact, as JAX's loss0
        art, loss, acc = step(art, emb, toks, targets, WARM)
        losses.append(float(loss))
        accs.append(float(acc))
    assert losses[-1] < losses[0] * 0.7, (losses[0], losses[-1])
    assert accs[-1] > accs[0], (accs[0], accs[-1])

    # port -> JAX, and JAX -> port (float16 on disk)
    p = tmp_path / "port.npz"
    tdraft.save_artifact(p, art, dhc, teacher_mode="gq")
    jart2, jhc2 = jdraft.load_artifact(p)
    assert jhc2 == jdraft.DraftHeadConfig(**HEAD) and jdraft.artifact_teacher_mode(p) == "gq"
    for a, b in zip(tdraft.art_leaves(art), tdraft.art_leaves(_np(jart2))):
        assert np.array_equal(a.detach().numpy().astype(np.float16).astype(np.float32), b)
    q = tmp_path / "jax.npz"
    jdraft.save_artifact(q, jart2, jhc2)
    art3, hc3 = tdraft.load_artifact(q)
    assert hc3 == dhc
    for a, b in zip(tdraft.art_leaves(art3), tdraft.art_leaves(_np(jart2))):
        assert np.array_equal(a.numpy(), b)

    # the distilled head drafts for the teacher: plain greedy's ids
    dparams = tdraft.assemble_draft(emb, art3, torch.float32)
    prompt = toks[:1, :8]
    cache = tllama.init_cache(TCFG, 1, torch.float32, "cpu")
    dcache = tllama.init_cache(dcfg, 1, torch.float32, "cpu")
    logits = tllama.forward(tt, cache, tllama.embed_tokens(tt, prompt), 0, TCFG,
                            use_flash=False)
    tllama.forward(dparams, dcache, tllama.embed_tokens(dparams, prompt), 0, dcfg,
                   use_flash=False)
    ids, counts, _ = tllama.draft_speculative_decode_loop(tt, cache, dparams, dcache, logits, 8,
                                                          3, 4, TCFG, dcfg)
    got = [int(x) for row, n in zip(ids[0].tolist(), counts[0].tolist()) for x in row[:n]]
    cache = tllama.init_cache(TCFG, 1, torch.float32, "cpu")
    lg = tllama.forward(tt, cache, tllama.embed_tokens(tt, prompt), 0, TCFG)
    want = []
    for pos in range(8, 8 + len(got)):
        want.append(int(lg[0].argmax()))
        lg = tllama.forward(tt, cache, tllama.embed_tokens(tt, torch.tensor([[want[-1]]])), pos,
                            TCFG)
    assert got == want
