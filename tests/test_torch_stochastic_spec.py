"""Port parity for sampled speculative decoding: the chain as a distribution
(``chain_logits_dyn``) against JAX's, the residual sample
(``sample_res_rows``) and the sampled speculative loop against the
distributions they must draw from, greedy lanes of a mixed group against
greedy decode, and the residual ban through the engine (``resolve_ban``) and
its checkpoints, JAX's included.

The draws come from per-lane ``torch.Generator`` streams, not JAX keys, so
sampled ids are compared as distributions: the total-variation distance of
an empirical histogram to the analytic one, over 16384 seeded lanes.  Its
expected value is about 0.5 sqrt(2 / (pi N)) times the sum of sqrt(p) over
the support (0.010-0.016 here); the bounds are 2.5 times that.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fixtures import build_tiny_models
from minigpt4_tpu.engine import device_sampling as jds
from minigpt4_tpu.engine.engine import MiniGPT4Engine as JaxEngine
from minigpt4_tpu_torch.engine import MiniGPT4Engine, SamplingParams
from minigpt4_tpu_torch.engine import device_sampling as tds
from minigpt4_tpu_torch.models import llama as tllama

# one intra-op thread: the suite runs several pytest-xdist workers on the same cores, where
# torch's OpenMP pools spin against each other and run ~17x slower
torch.set_num_threads(1)

N = 16384  # seeded lanes of the distribution checks


def _gens(n, seed=0):
    return [torch.Generator().manual_seed(seed * 1_000_003 + i) for i in range(n)]


def _tv(samples, p):
    emp = np.bincount(np.asarray(samples).reshape(-1), minlength=p.size) / np.asarray(samples).size
    return 0.5 * np.abs(emp - p.reshape(-1)).sum()


def _dist(logits, params):
    """The analytic post-chain distribution of ``params`` over ``logits`` [V]
    (the port's chain, held to JAX's in the test below)."""
    rows = tds.lane_rows([params], logits.shape[-1], "cpu")
    z = tds.chain_logits_dyn(torch.as_tensor(logits)[None], *(rows.traced[n] for n in tds.TRACED))
    return torch.softmax(z, dim=-1)[0].double().numpy()


CHAINS = [SamplingParams(temp=0.8, top_k=40, top_p=0.9),
          SamplingParams(temp=1.3, top_k=0, top_p=1.0),
          SamplingParams(temp=0.7, top_k=5, top_p=0.85, tfs_z=0.95),
          SamplingParams(temp=1.0, top_k=12, top_p=1.0, typical_p=0.8),
          SamplingParams(temp=0.0)]


@pytest.mark.parametrize("with_bias", [False, True])
def test_chain_logits_match_jax(with_bias):
    """Five configs (one greedy) over 3 x 5 rows of seeded logits of 262 ids,
    each row under its lane's thresholds: within 1e-6 (absolute, on the
    finite entries; the -inf entries are the same)."""
    rng = np.random.default_rng(3)
    v = 262
    logits = rng.normal(0, 2.5, (len(CHAINS) * 3, v)).astype(np.float32)
    params = CHAINS * 3
    bias = rng.normal(0, 1, (len(params), v)).astype(np.float32) if with_bias else None
    rows = tds.lane_rows(params, v, "cpu")
    got = tds.chain_logits_dyn(torch.from_numpy(logits), *(rows.traced[n] for n in tds.TRACED),
                               None if bias is None else torch.from_numpy(bias)).numpy()
    jrows = jds.lane_rows(params, n_vocab=v)
    args = [jnp.asarray(logits)] + [jrows[n] for n in ("temp", "top_k", "top_p", "tfs_z",
                                                        "typical_p")]
    if bias is not None:
        args.append(jnp.asarray(bias))
    want = np.asarray(jax.vmap(jds.chain_logits_dyn)(*args))
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    assert np.abs(got[fin] - want[fin]).max() <= 1e-6


def test_residual_sample_excludes_the_ban_and_draws_the_residual():
    """sample_res_rows over 16384 lanes of one row of logits with id 4
    banned: never 4, and the histogram is norm(p with p[4] = 0) within TV
    0.03; with no ban it is the traced sample of ``sample_rows`` draw for
    draw; a greedy lane ignores the ban."""
    rng = np.random.default_rng(8)
    v = 10
    logits = torch.from_numpy(rng.normal(0, 1.5, (v,)).astype(np.float32))
    params = SamplingParams(temp=1.0, top_k=0, top_p=1.0)
    rows = tds.lane_rows([params] * N, v, "cpu")
    got = tds.sample_res_rows(logits.expand(N, v), torch.full((N,), 4), _gens(N), rows).numpy()
    assert not (got == 4).any()
    p = _dist(logits, params)
    p[4] = 0.0
    assert _tv(got, p / p.sum()) < 0.03

    few = tds.lane_rows([params] * 64, v, "cpu")
    a = tds.sample_res_rows(logits.expand(64, v), torch.full((64,), -1), _gens(64, 1), few)
    b = tds.sample_rows(logits.expand(64, v), _gens(64, 1), few)
    assert torch.equal(a, b)
    mixed = tds.lane_rows([SamplingParams(temp=0.0), params], v, "cpu")
    top = int(logits.argmax())
    got = tds.sample_res_rows(logits.expand(2, v), torch.tensor([top, top]), _gens(2), mixed)
    assert int(got[0]) == top and int(got[1]) != top


def _zero_layer(v, w):
    """A 0-layer model: the logits after evaluating token t are sqrt(v) w[t]
    (one-hot embedding, norm, head), so every target is analytic."""
    cfg = tllama.LlamaConfig(n_vocab=v, n_embd=v, n_head=1, n_layer=0, n_rot=4, n_ff=4,
                             n_ctx=64)
    params = {"tok_embeddings": torch.eye(v), "norm": torch.ones(v),
              "output": {"w": torch.from_numpy(w)}, "layers": {}}
    return params, cfg


def test_sampled_loop_first_two_tokens_match_plain_sampling():
    """The sampled speculative loop (2 passes of k = 2) on a 0-layer model of
    12 ids, 16384 lanes after token a: the joint histogram of the first two
    emitted tokens matches plain sampling's p_a(t1) p_t1(t2) within TV 0.05.
    Every likely t1 has an n-gram draft, the second most likely token after
    it, so the accept test branches both ways (rate checked)."""
    v = 12
    rng = np.random.default_rng(1)
    w = rng.normal(0, 1.0, (v, v)).astype(np.float32)
    params, cfg = _zero_layer(v, w)
    sp = SamplingParams(temp=0.9, top_k=5, top_p=0.95)
    a = 3
    dists = np.stack([_dist(np.sqrt(v) * w[t], sp) for t in range(v)])
    # history: (a, t1, second most likely after t1) for every t1, then a
    seq = []
    for t1 in range(v):
        seq += [a, t1, int(np.argsort(-dists[t1])[1])]
    seq.append(a)
    hist = torch.full((N, cfg.n_ctx), -1, dtype=torch.long)
    hist[:, :len(seq)] = torch.tensor(seq)
    logits0 = torch.from_numpy(np.sqrt(v) * w[a]).float().expand(N, v).contiguous()
    rows = tds.lane_rows([sp] * N, v, "cpu")
    cache = tllama.init_cache(cfg, N, torch.float32, "cpu")
    toks, counts, _, _, _ = tllama.stochastic_speculative_decode_loop(
        params, cache, logits0, len(seq), hist, torch.full((N,), -1), _gens(N, 2), rows, 2, 2,
        cfg)
    t, c = toks.numpy(), counts.numpy()
    first = t[:, 0, 0]
    second = np.where(c[:, 0] >= 2, t[:, 0, 1], t[:, 1, 0])
    joint = dists[a][:, None] * dists
    assert _tv(first * v + second, joint) < 0.05
    accepted = (c[:, 0] >= 2).mean()
    assert 0.05 < accepted < 0.95, accepted


def test_greedy_lanes_of_a_mixed_group_decode_greedy():
    """A group of a greedy lane, a sampled lane and a greedy lane with a
    carried ban: the greedy lanes emit the plain greedy ids (a greedy lane
    ignores its ban), the sampled lane leaves a ban or none."""
    rng = np.random.default_rng(0)
    d, v = 128, 97
    cfg = tllama.LlamaConfig(n_vocab=v, n_embd=d, n_head=2, n_layer=2, n_rot=64, n_ff=128,
                             n_ctx=128)

    def w(*s, sd=0.08):
        return torch.from_numpy(rng.normal(0, sd, s).astype(np.float32))

    layers = {n: {"w": w(2, *shape)} for n, shape in (
        ("wqkv", (d, 3 * d)), ("wo", (d, d)), ("w13", (d, 256)), ("w2", (128, d)))}
    layers["attention_norm"] = torch.ones(2, d)
    layers["ffn_norm"] = torch.ones(2, d)
    params = {"tok_embeddings": w(v, d, sd=0.5), "norm": torch.ones(d),
              "output": {"w": w(d, v, sd=0.3)}, "layers": layers}
    prompt = [3, 11, 4, 11, 4, 11, 4, 9]

    def prefill(b):
        cache = tllama.init_cache(cfg, b, torch.float32, "cpu")
        lg = tllama.forward(params, cache, tllama.embed_tokens(params, torch.tensor([prompt] * b)),
                            0, cfg)
        return lg, cache

    lg, cache = prefill(1)
    plain, _ = tllama.decode_loop(params, cache, lg, len(prompt), 24, [torch.Generator()],
                                  tds.lane_rows([SamplingParams(temp=0.0)], v, "cpu"), cfg)
    lg, cache = prefill(3)
    hist = torch.full((3, cfg.n_ctx), -1, dtype=torch.long)
    hist[:, :len(prompt)] = torch.tensor(prompt)
    rows = tds.lane_rows([SamplingParams(temp=0.0), SamplingParams(temp=0.8),
                          SamplingParams(temp=0.0)], v, "cpu")
    toks, counts, _, _, ban = tllama.stochastic_speculative_decode_loop(
        params, cache, lg, len(prompt), hist, torch.tensor([-1, -1, int(plain[0, 0])]), _gens(3),
        rows, 24, 4, cfg)
    for lane in (0, 2):
        emitted = [t for row, c in zip(toks[lane].tolist(), counts[lane].tolist())
                   for t in row[:c]]
        assert emitted[:24] == plain[0].tolist()[:len(emitted[:24])] and len(emitted) >= 24
        assert int(ban[lane]) == -1 or int(ban[lane]) != emitted[-1]


# -- the ban through the engine and its checkpoints ---------------------------


@pytest.fixture(scope="module")
def tiny_files(tmp_path_factory):
    return build_tiny_models(tmp_path_factory.mktemp("torch_stoch_spec"))


@pytest.fixture(scope="module")
def engine(tiny_files):
    eng = MiniGPT4Engine(*tiny_files, n_ctx=256, n_batch=32, device="cpu", speculative_k=4)
    yield eng
    eng.close()


def test_resolve_ban_consumes_the_ban_before_a_plain_sample(engine):
    """A pending ban on the top id of a top_k = 2 chain: the next plain
    sample (end_chat, or generate without speculation) draws the other id,
    through resolve_ban, and clears the ban."""
    for step in ("end_chat", "generate"):
        engine.reset()
        engine.begin_chat("hello there")
        st = engine._st
        top2 = st.logits.topk(2).indices.tolist()
        st.spec_ban = top2[0]
        params = SamplingParams(temp=0.8, top_k=2, top_p=1.0)
        n0 = st.n_past
        if step == "end_chat":
            engine.end_chat(params)
        else:
            next(iter(engine.generate(limit=1, params=params, speculative_k=0)), None)
        assert st.tokens[n0] == top2[1]
        assert st.spec_ban == -1


def test_sampled_generate_carries_the_ban_across_dispatches(engine):
    """A sampled stream with speculation: dispatches hand their ban on
    (``st.spec_ban`` is -1 or an id), the history stays one id per position,
    and the same seed gives the same stream."""
    outs = []
    for _ in range(2):
        engine.reset()
        engine._st.generator.manual_seed(7)
        engine.begin_chat("tell me")
        outs.append(list(engine.generate(limit=40, params=SamplingParams(temp=0.9))))
        st = engine._st
        assert len(st.tokens) == st.n_past and st.spec_ban >= -1
    assert outs[0] == outs[1] and len(outs[0]) > 0


def test_checkpoint_round_trips_the_ban(engine, tmp_path):
    engine.reset()
    engine.begin_chat("hi")
    engine._st.spec_ban = 17
    engine.save_state(tmp_path / "ban.npz")
    assert int(np.load(tmp_path / "ban.npz")["spec_ban"]) == 17
    engine.reset()
    assert engine._st.spec_ban == -1
    engine.restore_state(tmp_path / "ban.npz")
    assert engine._st.spec_ban == 17 and engine._st.dcache is None


def test_jax_checkpoint_with_a_ban_restores(tiny_files, engine, tmp_path):
    """A JAX engine's checkpoint carrying a ban restores in the port with it,
    and the port's next sample consumes it."""
    jeng = JaxEngine(*tiny_files, n_ctx=256, n_batch=32)
    try:
        jeng.begin_chat("hi")
        jeng._st.spec_ban = int(np.argmax(jeng._st.logits))
        jeng.save_state(tmp_path / "jax.npz")
        ban = jeng._st.spec_ban
    finally:
        jeng.close()
    engine.reset()
    engine.restore_state(tmp_path / "jax.npz")
    assert engine._st.spec_ban == ban
    engine.end_chat(SamplingParams(temp=0.8, top_k=2, top_p=1.0))
    assert engine._st.spec_ban == -1 and engine._st.tokens[-1] != ban
