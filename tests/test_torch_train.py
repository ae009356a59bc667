"""Port parity for the stage-1 projection trainer (``train/projection.py``)
and the training path through the port's decoder.

Both packages start from the same files (``tests/fixtures.py``) and the same
projection bits (``interop.trainable_from_numpy``); pixels and captions come
from one NumPy seed.  The JAX side is ``minigpt4_tpu.train`` on the CPU.

Tolerances (f32): the caption loss within 1e-5 relative (measured 0 at
T = 6, 7.6e-8 at T = 40, 1.3e-7 on the qtensor decoder), the projection's
gradients within 1e-4 of max|grad| (measured <= 4.9e-7 on the dense
fixture, 1.8e-6 on the qtensor one); five Adam steps track optax's losses
within 1e-4 relative (measured <= 3.3e-7).  The qtensor Function's
gradients are bit-equal to plain autograd's (the same two matmuls).  The fixture's Q-Former has 4
queries: T = 6 gives S = 10 decoder rows, inside the flash span (S <= 32),
which ``use_flash=False`` sends to the plain attention; T = 40 gives S = 44,
past it, over an f32 cache, whose in-place writes broke backward before the
decoder attended over a copy of each layer's slice under autograd.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from fixtures import build_gq_models, build_tiny_models
from minigpt4_tpu.formats import ContainerReader, LlamaFileReader
from minigpt4_tpu.models import llama as jllama
from minigpt4_tpu.models import minigpt4 as jvision
from minigpt4_tpu.train import caption_loss as jcaption_loss
from minigpt4_tpu.train import make_train_step as jmake_train_step
from minigpt4_tpu_torch import interop
from minigpt4_tpu_torch.models import llama as tllama
from minigpt4_tpu_torch.models import minigpt4 as tvision
from minigpt4_tpu_torch.ops import quant_matmul as qm
from minigpt4_tpu_torch.train import caption_loss, make_train_step
from minigpt4_tpu_torch.train import projection

# one intra-op thread: the suite runs several pytest-xdist workers on the same cores, where
# torch's OpenMP pools spin against each other and run ~17x slower
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
N_CTX = 64
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4  # of max|grad|
STEP_RTOL = 1e-4


def _load(model, llm, quant_mode="auto", port_quant="auto"):
    """(JAX frozen, proj, cfgs), (port frozen, cfgs) of one pair of files."""
    with ContainerReader(model) as r:
        jvp, jvcfg = jvision.load_params(r, jnp.float32)
        tvp, tvcfg = tvision.load_params(r, torch.float32, "cpu")
    with LlamaFileReader(llm) as r:
        jlp, jlcfg = jllama.load_params(r, jnp.float32, n_ctx=N_CTX, quant_mode=quant_mode)
        tlp, tlcfg = tllama.load_params(r, torch.float32, n_ctx=N_CTX, device="cpu",
                                        quant_mode=port_quant)
    jfrozen = {"vision": {k: v for k, v in jvp.items() if k != "llama_proj"}, "llm": jlp}
    jproj = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float32), jvp["llama_proj"])
    tfrozen = {"vision": {k: v for k, v in tvp.items() if k != "llama_proj"}, "llm": tlp}
    return (jfrozen, jproj, jvcfg, jlcfg), (tfrozen, tvcfg, tlcfg)


def _batch(vcfg, n_vocab: int, t: int, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    vs = vcfg.vit.image_size
    return {"pixels": rng.normal(size=(2, 3, vs, vs)).astype(np.float32),
            "tokens": rng.integers(1, n_vocab, (2, t)).astype(np.int32),
            "mask": np.ones((2, t), np.float32)}


def _port_proj(jproj) -> dict:
    return interop.trainable_from_numpy(jax.tree_util.tree_map(np.asarray, jproj), "cpu")


_jax_value_and_grad = jax.jit(jax.value_and_grad(jcaption_loss), static_argnums=(5, 6))


def _jax_loss_grads(j, b):
    jfrozen, jproj, jvcfg, jlcfg = j
    loss, g = _jax_value_and_grad(jproj, jfrozen, jnp.asarray(b["pixels"]),
                                  jnp.asarray(b["tokens"]), jnp.asarray(b["mask"]), jvcfg, jlcfg)
    return float(loss), {k: np.asarray(v) for k, v in g.items()}


def _port_loss_grads(t, proj, b):
    tfrozen, tvcfg, tlcfg = t
    loss = caption_loss(proj, tfrozen, torch.from_numpy(b["pixels"]),
                        torch.from_numpy(b["tokens"]), torch.from_numpy(b["mask"]), tvcfg, tlcfg)
    grads = torch.autograd.grad(loss, [proj["w"], proj["b"]])
    return float(loss.detach()), {"w": grads[0].numpy(), "b": grads[1].numpy()}


def _close(got: dict, want: dict, tol: float = GRAD_TOL) -> None:
    for k in want:
        scale = np.abs(want[k]).max()
        assert scale > 0, k
        assert np.abs(got[k] - want[k]).max() <= tol * scale, (k, np.abs(got[k] - want[k]).max(),
                                                               scale)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    model, llm = build_tiny_models(tmp_path_factory.mktemp("torch_train"))
    return (model, llm), _load(model, llm)


@pytest.fixture(scope="module")
def gq_files(tmp_path_factory):
    return build_gq_models(tmp_path_factory.mktemp("torch_train_gq"))


@pytest.mark.parametrize("t", [6, 40])
def test_caption_loss_and_proj_grads_match_jax(tiny, t):
    """The loss and both projection gradients, with the span of n_q + T
    rows inside the flash span (T = 6, ``use_flash=False``) and past it
    with an f32 cache (T = 40)."""
    _, (j, tt) = tiny
    b = _batch(j[2], j[3].n_vocab, t)
    want_loss, want = _jax_loss_grads(j, b)
    got_loss, got = _port_loss_grads(tt, _port_proj(j[1]), b)
    assert got_loss == pytest.approx(want_loss, rel=LOSS_RTOL)
    _close(got, want)


def test_adam_steps_match_optax(tiny):
    """Five ``torch.optim.Adam(1e-2)`` steps on one fixed batch track five
    ``optax.adam(1e-2)`` steps of the JAX trainer, loss by loss; and the
    port meets JAX's own test: the loss falls by 2 % and the projection
    moves (tests/test_train.py)."""
    _, (j, tt) = tiny
    jfrozen, jproj, jvcfg, jlcfg = j
    b = _batch(jvcfg, jlcfg.n_vocab, 6)
    opt = optax.adam(1e-2)
    jstep = jmake_train_step(jvcfg, jlcfg, opt)
    st, p, want = opt.init(jproj), jproj, []
    for _ in range(5):
        p, st, loss = jstep(p, st, jfrozen, jnp.asarray(b["pixels"]), jnp.asarray(b["tokens"]),
                            jnp.asarray(b["mask"]))
        want.append(float(loss))

    tfrozen, tvcfg, tlcfg = tt
    proj = _port_proj(jproj)
    w0 = proj["w"].detach().clone()
    step = make_train_step(tvcfg, tlcfg, torch.optim.Adam(list(proj.values()), lr=1e-2))
    got = []
    for _ in range(5):
        proj, loss = step(proj, tfrozen, torch.from_numpy(b["pixels"]),
                          torch.from_numpy(b["tokens"]), torch.from_numpy(b["mask"]))
        got.append(float(loss))
    np.testing.assert_allclose(got, want, rtol=STEP_RTOL)
    assert got[-1] < got[0] * 0.98
    assert not torch.allclose(proj["w"].detach(), w0)


def test_caption_loss_respects_mask(tiny):
    """Masked-out positions contribute nothing (their ids may change, the
    loss stays), unmasking changes it, and the loss equals JAX's."""
    _, (j, tt) = tiny
    tfrozen, tvcfg, tlcfg = tt
    b = _batch(j[2], j[3].n_vocab, 6)
    mask = torch.tensor([[1, 1, 1, 0, 0, 0], [1, 1, 1, 1, 0, 0]], dtype=torch.float32)
    proj = _port_proj(j[1])
    pixels, tokens = torch.from_numpy(b["pixels"]), torch.from_numpy(b["tokens"])

    def loss(tok, m):
        with torch.no_grad():
            return float(caption_loss(proj, tfrozen, pixels, tok, m, tvcfg, tlcfg))

    l1 = loss(tokens, mask)
    mangled = tokens.clone()
    mangled[:, 4:] = 7
    assert loss(mangled, mask) == pytest.approx(l1, abs=1e-6)
    assert loss(tokens, torch.ones_like(mask)) != pytest.approx(l1, abs=1e-6)
    want = jax.jit(jcaption_loss, static_argnums=(5, 6))(
        j[1], j[0], jnp.asarray(b["pixels"]), jnp.asarray(b["tokens"]),
        jnp.asarray(mask.numpy()), j[2], j[3])
    assert l1 == pytest.approx(float(want), rel=LOSS_RTOL)


def _plain_qmatmul(x, qt, layer=None):
    """qmatmul with plain autograd: the dequantized weight is saved."""
    if qt.stacked:
        qt = qt.layer(layer)
    return x @ qt.dequantize(x.dtype).t()


def test_qtensor_grads_match_jax_and_plain_autograd(gq_files, monkeypatch):
    """On the Q5_K fixture the port's decoder as ``qtensor`` (packed bytes)
    gives JAX's ``auto`` gradients (its CPU form is the same dequantize then
    matmul), and the autograd Function gives the same gradients as plain
    autograd through the dequantized weight."""
    (j, tt) = _load(*gq_files, quant_mode="auto", port_quant="qtensor")
    assert isinstance(tt[0]["llm"]["layers"]["wqkv"]["w"], qm.QTensor)
    b = _batch(j[2], j[3].n_vocab, 6, seed=1)
    want_loss, want = _jax_loss_grads(j, b)
    got_loss, got = _port_loss_grads(tt, _port_proj(j[1]), b)
    assert got_loss == pytest.approx(want_loss, rel=LOSS_RTOL)
    _close(got, want)
    monkeypatch.setattr(qm, "qmatmul", _plain_qmatmul)
    plain_loss, plain = _port_loss_grads(tt, _port_proj(j[1]), b)
    assert plain_loss == got_loss
    assert all(np.array_equal(got[k], plain[k]) for k in plain)


def test_qmatmul_function_saves_only_the_packed_bytes():
    """The Function's forward gives plain qmatmul's bits, its backward
    dy @ dequant(W), and autograd keeps no dequantized weight."""
    from minigpt4_tpu_torch.formats import DataType
    from minigpt4_tpu_torch.formats import quants

    rng = np.random.default_rng(3)
    w = rng.normal(0, 0.05, (64, 256)).astype(np.float32)
    qt = qm.QTensor.from_raw(quants.quantize(w.reshape(-1), DataType.Q5_K), (64, 256),
                             DataType.Q5_K, "cpu")
    x = torch.from_numpy(rng.normal(size=(3, 5, 256)).astype(np.float32)).requires_grad_()
    y = qm.qmatmul(x, qt)
    assert torch.equal(y.detach(), _plain_qmatmul(x.detach(), qt))
    saved = [t for t in y.grad_fn.saved_tensors]
    assert len(saved) == 1 and saved[0].dtype == torch.uint8
    dy = torch.from_numpy(rng.normal(size=(3, 5, 64)).astype(np.float32))
    (dx,) = torch.autograd.grad(y, x, dy)
    x2 = x.detach().clone().requires_grad_()
    (dx_plain,) = torch.autograd.grad(_plain_qmatmul(x2, qt), x2, dy)
    assert torch.equal(dx, dx_plain)


@pytest.mark.parametrize("mode", ["gq", "repack", "w8a8"])
def test_trainers_refuse_kernel_forms(gq_files, mode):
    """gq, repacked and w8a8 decoders are refused before any forward with
    one error naming qtensor; so is such a llama_proj."""
    (_, tt) = _load(*gq_files, quant_mode="auto", port_quant=mode)
    tfrozen, tvcfg, tlcfg = tt
    rng = np.random.default_rng(0)
    vs = tvcfg.vit.image_size
    pixels = torch.from_numpy(rng.normal(size=(1, 3, vs, vs)).astype(np.float32))
    tokens = torch.ones((1, 4), dtype=torch.int32)
    proj = {"w": torch.zeros((tvcfg.qformer.hidden_size, tlcfg.n_embd), requires_grad=True)}
    with pytest.raises(NotImplementedError, match="qtensor"):
        caption_loss(proj, tfrozen, pixels, tokens, torch.ones((1, 4)), tvcfg, tlcfg)
    wq = tfrozen["llm"]["layers"]["wqkv"]["w"]
    with pytest.raises(NotImplementedError, match="qtensor.*item 12"):
        projection.check_trainable({"w": wq}, "llama_proj")


@pytest.mark.parametrize("mode", ["gq", "repack"])
def test_jax_cannot_differentiate_gq_or_repack_either(gq_files, mode):
    """The JAX trainer on the same fixture fails for gq (no reverse mode
    through ``pallas_call``) and repack; the port refuses both up front."""
    (j, _) = _load(*gq_files, quant_mode=mode, port_quant="qtensor")
    b = _batch(j[2], j[3].n_vocab, 4)
    with pytest.raises((NotImplementedError, ValueError)):
        _jax_loss_grads(j, b)


def test_forward_use_flash_false_takes_plain_attention(tiny, monkeypatch):
    """S <= 32 rows with ``use_flash=False`` never call flash decode and
    give JAX's ``use_flash=False`` logits; the default still calls it."""
    (_, llm), _ = tiny
    with LlamaFileReader(llm) as r:
        jp, jcfg = jllama.load_params(r, jnp.float32, n_ctx=N_CTX)
        tp, tcfg = tllama.load_params(r, torch.float32, n_ctx=N_CTX, device="cpu")
    ids = np.random.default_rng(5).integers(0, jcfg.n_vocab, (2, 10)).astype(np.int32)
    want, _ = jllama.forward(jp, jllama.init_cache(jcfg, 2, jnp.float32),
                             jllama.embed_tokens(jp, jnp.asarray(ids)), jnp.int32(0), jcfg,
                             all_logits=True, use_flash=False)
    calls = []
    flash = tllama.flash_decode_attention
    monkeypatch.setattr(tllama, "flash_decode_attention",
                        lambda *a, **k: calls.append(1) or flash(*a, **k))
    emb = tllama.embed_tokens(tp, torch.from_numpy(ids))
    got = tllama.forward(tp, tllama.init_cache(tcfg, 2, torch.float32, "cpu"), emb, 0, tcfg,
                         all_logits=True, use_flash=False)
    assert calls == []
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    tllama.forward(tp, tllama.init_cache(tcfg, 2, torch.float32, "cpu"), emb, 0, tcfg)
    assert len(calls) == tcfg.n_layer


def test_train_draft_tool_on_cpu(gq_files, tmp_path):
    """``python -m minigpt4_tpu_torch.tools.train_draft --llm-file ...
    --device cpu`` distills a head for a few steps and saves it tagged with
    its teacher; the port's engine loads it as --draft-head and its greedy
    speculative ids equal plain greedy's.  Without --llm-file the tool
    distills against the benchmark's synthetic teacher at ``--model tiny``
    and tags the artifact with ``benchmark.synth_teacher_tag``."""
    from minigpt4_tpu_torch.engine import MiniGPT4Engine, SamplingParams
    from minigpt4_tpu_torch.train import draft as tdraft

    model, llm = gq_files
    out = tmp_path / "head.npz"
    cmd = [sys.executable, "-m", "minigpt4_tpu_torch.tools.train_draft", "--llm-file", str(llm),
           "--device", "cpu", "--steps", "3", "--batch", "2", "--seq", "32",
           "--teacher-batches", "2", "--d-draft", "64", "--n-layer", "1", "--out", str(out)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=240, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "[draft-train] EVAL on REALISTIC_TEXT" in proc.stdout
    assert tdraft.artifact_teacher_mode(out) == f"real:{Path(llm).name}@gq"
    _, hc = tdraft.load_artifact(out)
    assert hc == tdraft.DraftHeadConfig(64, 1, 1, 176)

    eng = MiniGPT4Engine(model, llm, n_ctx=128, device="cpu", draft_head_path=out)
    try:
        assert eng.draft_params is not None
        greedy = SamplingParams(temp=0.0)
        eng.begin_chat("hello")
        n0 = eng.n_past
        list(eng.generate(limit=12, params=greedy, speculative_k=4))
        drafted = eng._st.tokens[n0:]
        eng.reset()
        eng.begin_chat("hello")
        list(eng.generate(limit=12, params=greedy))
        assert drafted == eng._st.tokens[n0:]
    finally:
        eng.close()

    from minigpt4_tpu_torch import benchmark as B

    synth = tmp_path / "synth.npz"
    proc = subprocess.run(cmd[:3] + ["--model", "tiny", "--steps", "3", "--teacher-batches", "1",
                                     "--device", "cpu", "--out", str(synth)],
                          capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "[draft-train] EVAL on REALISTIC_TEXT" in proc.stdout
    tag = B.synth_teacher_tag("gq", B.bench_pack_policy(B.GEOMETRIES["tiny"]))
    assert tdraft.artifact_teacher_mode(synth) == tag and tag.startswith("gq@2e-05")
