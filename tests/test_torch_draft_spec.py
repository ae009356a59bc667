"""Port parity for draft-model speculative decoding: the drafted verify loop
(a second model file, and a draft head) against JAX's
``draft_speculative_decode_loop`` and the port's plain greedy decode, draft
artifacts between the two packages, the engine's drafters against its plain
greedy chat, and the engine's refusals.

The main model is the gq fixture (JAX's Pallas kernels in interpret mode on
its side); the drafter file is the tiny dense fixture of the same
vocabulary; the head is JAX's ``init_draft_head`` written by JAX's
``save_artifact`` and read by the port.  Tolerance: final logits within
5e-3 of max|logit|, as tests/test_torch_llama.py.  Both drafters emit the
main model's greedy ids, so their compared spans are the same: smallest
top-2 logit margin 0.196 (max|logit| 9.5), 25 times the port's final-logit
gap to JAX there (7.8e-3); the test holds it at >= 0.05.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import fixtures as fx
from fixtures import build_gq_models, build_llm
from minigpt4_tpu.formats import LlamaFileReader
from minigpt4_tpu.models import llama as jllama
from minigpt4_tpu.train import draft as jdraft
from minigpt4_tpu_torch import interop
from minigpt4_tpu_torch.engine import MiniGPT4Engine, SamplingParams
from minigpt4_tpu_torch.engine.device_sampling import lane_rows
from minigpt4_tpu_torch.image import preprocess
from minigpt4_tpu_torch.models import llama as tllama
from minigpt4_tpu_torch.train import draft as tdraft

# one intra-op thread: the suite runs several pytest-xdist workers on the same cores, where
# torch's OpenMP pools spin against each other and run ~17x slower
torch.set_num_threads(1)

N_CTX = 256
PROMPT = [1, 170, 128, 103, 56, 63, 11, 17, 13, 176, 83, 83, 83, 144, 107, 192]
MIN_MARGIN = 0.05
HEAD_CFG = dict(d_draft=64, n_layer=1, n_head=2, n_ff=128)
GREEDY = SamplingParams(temp=0.0)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_draft")
    model, llm = build_gq_models(tmp)
    drafter = build_llm(tmp / "draft-tiny.bin", np.random.default_rng(1234), None)
    head = tmp / "head.npz"
    art = jdraft.init_draft_head(jax.random.PRNGKey(3), fx.GQ_D,
                                 jdraft.DraftHeadConfig(**HEAD_CFG))
    jdraft.save_artifact(head, art, jdraft.DraftHeadConfig(**HEAD_CFG), teacher_mode="gq")
    return model, llm, drafter, head


def _cfg(jcfg):
    return tllama.LlamaConfig(n_vocab=jcfg.n_vocab, n_embd=jcfg.n_embd, n_head=jcfg.n_head,
                              n_layer=jcfg.n_layer, n_rot=jcfg.n_rot, n_ff=jcfg.n_ff,
                              n_ctx=N_CTX)


@pytest.fixture(scope="module")
def models(files):
    """(JAX params, config) and (port params, config) of the main model and
    of both drafters, the port's read by its own loaders."""
    _, llm, drafter, head = files
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MINIGPT4_TPU_GQ_PACK", "0")  # interop maps unpacked codes
        with LlamaFileReader(llm) as r:
            jparams, jcfg = jllama.load_params(r, jnp.float32, n_ctx=N_CTX, quant_mode="gq")
    tparams = interop.llama_params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    with LlamaFileReader(drafter) as r:
        jd, jdcfg = jllama.load_params(r, jnp.float32, n_ctx=N_CTX)
        td, tdcfg = tllama.load_params(r, torch.float32, n_ctx=N_CTX, device="cpu")
    jart, jhc = jdraft.load_artifact(head)
    jh = jdraft.assemble_draft(jparams["tok_embeddings"], jart, jnp.float32)
    tart, thc = tdraft.load_artifact(head)
    th = tdraft.assemble_draft(tparams["tok_embeddings"], tart, torch.float32)
    return {"main": ((jparams, jcfg), (tparams, _cfg(jcfg))),
            "llm": ((jd, jdcfg), (td, tdcfg)),
            "head": ((jh, jhc.llama_cfg(jcfg.n_vocab, N_CTX)),
                     (th, thc.llama_cfg(jcfg.n_vocab, N_CTX)))}


def _emitted(tokens, counts):
    return [t for row, c in zip(tokens, counts) for t in row[:c]]


@pytest.mark.parametrize("drafter", ["llm", "head"])
def test_draft_loop_matches_jax_and_plain_decode(models, drafter):
    """8 passes of k = 4 from the prompt, the draft cache caught up on it:
    tokens and counts equal JAX's, final logits within 5e-3, the emitted ids
    are the port's plain greedy ids, and no step of them is a near tie."""
    (jp, jcfg), (tp, tcfg) = models["main"]
    (jd, jdcfg), (td, tdcfg) = models[drafter]
    n_passes, k = 8, 4
    ids = torch.tensor([PROMPT])

    cache = tllama.init_cache(tcfg, 1, torch.float32, "cpu")
    logits = tllama.forward(tp, cache, tllama.embed_tokens(tp, ids), 0, tcfg)
    dcache = tllama.init_cache(tdcfg, 1, torch.float32, "cpu")
    tllama.forward(td, dcache, tllama.embed_tokens(td, ids), 0, tdcfg)
    toks, counts, final = tllama.draft_speculative_decode_loop(
        tp, cache, td, dcache, logits, len(PROMPT), n_passes, k, tcfg, tdcfg)

    jids = jnp.asarray([PROMPT], jnp.int32)
    jl, jc = jllama.forward(jp, jllama.init_cache(jcfg, 1, jnp.float32),
                            jllama.embed_tokens(jp, jids), jnp.int32(0), jcfg)
    _, jdc = jllama.forward(jd, jllama.init_cache(jdcfg, 1, jnp.float32),
                            jllama.embed_tokens(jd, jids), jnp.int32(0), jdcfg)
    jt, jn, jf, _, _ = jllama.draft_speculative_decode_loop(
        jp, jc, jd, jdc, jl, jnp.int32(len(PROMPT)), n_passes, k, jcfg, jdcfg)
    assert toks.tolist() == np.asarray(jt).tolist()
    assert counts.tolist() == np.asarray(jn).tolist()
    want = np.asarray(jf, np.float64)
    assert np.abs(final.numpy() - want).max() <= 5e-3 * np.abs(want).max()

    emitted = _emitted(toks[0].tolist(), counts[0].tolist())
    cache = tllama.init_cache(tcfg, 1, torch.float32, "cpu")
    logits = tllama.forward(tp, cache, tllama.embed_tokens(tp, ids), 0, tcfg)
    plain, margins = [], []
    for i in range(len(emitted)):
        top = logits[0].topk(2).values
        margins.append(float(top[0] - top[1]))
        plain.append(int(logits[0].argmax()))
        logits = tllama.forward(tp, cache, tllama.embed_tokens(tp, torch.tensor([[plain[-1]]])),
                                len(PROMPT) + i, tcfg)
    assert emitted == plain
    assert min(margins) >= MIN_MARGIN, min(margins)


def test_self_draft_accepts_every_draft(models):
    """The main model drafting itself: every pass accepts k tokens and the
    draft cache stays without a gap over passes (the k-th draft step)."""
    _, (tp, tcfg) = models["main"]
    ids = torch.tensor([PROMPT])
    cache = tllama.init_cache(tcfg, 1, torch.float32, "cpu")
    logits = tllama.forward(tp, cache, tllama.embed_tokens(tp, ids), 0, tcfg)
    dcache = {kv: t.clone() for kv, t in cache.items()}
    toks, counts, _ = tllama.draft_speculative_decode_loop(
        tp, cache, tp, dcache, logits, len(PROMPT), 4, 4, tcfg, tcfg)
    assert counts.tolist() == [[4] * 4]
    cache = tllama.init_cache(tcfg, 1, torch.float32, "cpu")
    logits = tllama.forward(tp, cache, tllama.embed_tokens(tp, ids), 0, tcfg)
    plain, _ = tllama.decode_loop(tp, cache, logits, len(PROMPT), 16, [torch.Generator()],
                                  lane_rows([GREEDY], tcfg.n_vocab, "cpu"), tcfg)
    assert toks[0].reshape(-1).tolist() == plain[0].tolist()


def test_artifacts_read_both_ways(files, tmp_path):
    """The port reads JAX's artifact, JAX reads the port's, array for array
    (float16 on disk), the teacher mode included."""
    head = files[3]
    jart, jcfg = jdraft.load_artifact(head)
    tart, tcfg = tdraft.load_artifact(head)
    assert (tcfg.d_draft, tcfg.n_layer, tcfg.n_head, tcfg.n_ff) == (
        jcfg.d_draft, jcfg.n_layer, jcfg.n_head, jcfg.n_ff)
    assert tdraft.artifact_teacher_mode(head) == jdraft.artifact_teacher_mode(head) == "gq"

    def flat(art):
        out = {k: np.asarray(art[k]) for k in ("p_in", "p_out", "norm")}
        for name, lin in tdraft._LAYER_KEYS:
            v = art["layers"][name]
            out[name] = np.asarray(v["w"] if lin else v)
        return out

    a, b = flat(jart), flat(tart)
    assert all(np.array_equal(a[k], b[k]) for k in a)

    port_art = tdraft.init_draft_head(torch.Generator().manual_seed(0), 48,
                                      tdraft.DraftHeadConfig(**HEAD_CFG))
    tdraft.save_artifact(tmp_path / "port.npz", port_art, tdraft.DraftHeadConfig(**HEAD_CFG))
    back, back_cfg = jdraft.load_artifact(tmp_path / "port.npz")
    assert back_cfg == jdraft.DraftHeadConfig(**HEAD_CFG)
    assert jdraft.artifact_teacher_mode(tmp_path / "port.npz") == "w8a8"  # untagged default
    ref = {k: v.astype(np.float16).astype(np.float32) for k, v in flat(port_art).items()}
    got = flat(back)
    assert all(np.array_equal(got[k], ref[k]) for k in ref)
    assert abs(float(port_art["p_in"].std()) - 48 ** -0.5) < 0.02  # init_draft_head's scale


def _image_chat(model, llm, limit=24, **kw):
    eng = MiniGPT4Engine(model, llm, n_ctx=512, n_batch=32, device="cpu", **kw)
    try:
        img = np.random.default_rng(0).integers(0, 255, (40, 50, 3), dtype=np.uint8)
        emb = eng.encode_image(preprocess(img, size=eng.vision_cfg.vit.image_size))
        eng.system_prompt()
        eng.begin_chat_image(emb, "what is in the image?")
        first = list(eng.generate(limit=limit, params=GREEDY))
        eng.begin_chat("and then?")
        second = list(eng.generate(limit=limit, params=GREEDY))
        return first, second, eng.draft_k, eng._st.draft_past <= eng._st.n_past
    finally:
        eng.close()


@pytest.fixture(scope="module")
def plain_chat(files):
    return _image_chat(*files[:2])[:2]


@pytest.mark.parametrize("drafter", ["llm", "head"])
def test_engine_drafter_chat_equals_plain_greedy(files, plain_chat, drafter):
    """An image chat of two turns (the image rows feed the drafter zero
    embeddings in its catch-up) drafted by either drafter, at the default
    width 8: the plain engine's text, turn for turn."""
    model, llm, drafter_file, head = files
    want = plain_chat
    kw = {"draft_llm_path": drafter_file} if drafter == "llm" else {"draft_head_path": head}
    first, second, width, frontier_ok = _image_chat(model, llm, **kw)
    assert (first, second) == want and width == 8 and frontier_ok


def test_engine_refuses_what_jax_refuses(files, tmp_path):
    """The JAX engine's refusals: before anything loads (a width past 32,
    both drafters, a drafter under tp; n-gram speculation under tp is
    served, tests/test_torch_serve_tp.py, and these gq files stop there only
    because JAX cannot place a gq decoder), and at the drafter's
    load (a head of another width, a file of another vocabulary; the same
    code whether the constructor or ``set_drafter`` loads it), which leave
    the engine without a drafter."""
    model, llm, drafter_file, head = files
    kw = dict(n_ctx=N_CTX, n_batch=32, device="cpu")
    with pytest.raises(ValueError, match="verify-block limit"):
        MiniGPT4Engine(model, llm, speculative_k=33, **kw)
    with pytest.raises(ValueError, match="not both"):
        MiniGPT4Engine(model, llm, draft_llm_path=drafter_file, draft_head_path=head, **kw)
    with pytest.raises(ValueError, match="requires tp=1"):
        MiniGPT4Engine(model, llm, draft_head_path=head, tp=2, **kw)
    with pytest.raises(ValueError, match="requires tp=1"):
        MiniGPT4Engine(model, llm, draft_llm_path=drafter_file, tp=2, **kw)
    with pytest.raises(ValueError, match="cannot place one either"):
        MiniGPT4Engine(model, llm, speculative_k=4, tp=2, **kw)
    wide = tmp_path / "wide.npz"
    jdraft.save_artifact(wide, jdraft.init_draft_head(jax.random.PRNGKey(0), 96,
                                                      jdraft.DraftHeadConfig(**HEAD_CFG)),
                         jdraft.DraftHeadConfig(**HEAD_CFG))
    bad = tmp_path / "bad-draft.bin"
    _write_llm_of_vocab(bad, fx.VOCAB - 4)
    eng = MiniGPT4Engine(model, llm, **kw)
    try:
        with pytest.raises(ValueError, match="d_main"):
            eng.set_drafter(draft_head_path=wide)
        with pytest.raises(ValueError, match="vocab"):
            eng.set_drafter(draft_llm_path=bad)
        assert eng.draft_params is None and eng._draft_file is None
        eng.begin_chat("hi")
        with pytest.raises(ValueError, match="verify-block limit"):
            next(iter(eng.generate(limit=4, params=GREEDY, speculative_k=33)))
    finally:
        eng.close()


def _write_llm_of_vocab(path, n_vocab):
    """A tiny f32 llama file of ``n_vocab`` ids (the port's writer)."""
    from minigpt4_tpu_torch.formats.dtypes import DataType
    from minigpt4_tpu_torch.formats.ggml_llama import LlamaFileWriter, LlamaHParams, LlamaVocab

    hp = LlamaHParams(n_vocab=n_vocab, n_embd=fx.LLM_D, n_mult=fx.LLM_FF, n_head=fx.LLM_HEADS,
                      n_layer=1, n_rot=fx.LLM_D // fx.LLM_HEADS, ftype=0)
    toks = [b"<unk>", b"<s>", b"</s>"] + [bytes([b % 256]) for b in range(n_vocab - 3)]
    w = LlamaFileWriter(path, hp, LlamaVocab(tokens=toks, scores=[0.0] * n_vocab))
    rng = np.random.default_rng(5)

    def add(name, *shape):
        a = (rng.normal(0, 0.05, shape) if len(shape) == 2 else np.ones(shape)).astype("<f4")
        w.add_tensor(name, a.shape, DataType.F32, a.view(np.uint8).reshape(-1))

    add("tok_embeddings.weight", n_vocab, fx.LLM_D)
    add("norm.weight", fx.LLM_D)
    add("output.weight", n_vocab, fx.LLM_D)
    add("layers.0.attention_norm.weight", fx.LLM_D)
    for nm in ("wq", "wk", "wv", "wo"):
        add(f"layers.0.attention.{nm}.weight", fx.LLM_D, fx.LLM_D)
    add("layers.0.ffn_norm.weight", fx.LLM_D)
    add("layers.0.feed_forward.w1.weight", fx.LLM_FF, fx.LLM_D)
    add("layers.0.feed_forward.w2.weight", fx.LLM_D, fx.LLM_FF)
    add("layers.0.feed_forward.w3.weight", fx.LLM_FF, fx.LLM_D)
    w.write()


def test_checkpoint_restore_drops_the_draft_cache(files, tmp_path):
    """Restore drops the drafter's cache (it described the old history); the
    chat after it is the drafter-free engine's."""
    model, llm, drafter_file, _ = files

    def run(**kw):
        eng = MiniGPT4Engine(model, llm, n_ctx=N_CTX, n_batch=32, device="cpu", **kw)
        try:
            eng.begin_chat("checkpoint me")
            a = list(eng.generate(limit=6, params=GREEDY))
            eng.save_state(tmp_path / "st.npz")
            eng.begin_chat("diverge")
            list(eng.generate(limit=3, params=GREEDY))
            eng.restore_state(tmp_path / "st.npz")
            assert eng._st.dcache is None and eng._st.draft_past == 0
            eng.begin_chat("after restore")
            return a, list(eng.generate(limit=6, params=GREEDY))
        finally:
            eng.close()

    assert run(draft_llm_path=drafter_file) == run()
