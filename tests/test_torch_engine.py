"""Port parity for the chat engine: one image chat on the gq fixture through
the PyTorch engine (device="cpu", kernels' plain versions) against the JAX
engine (quant_mode="gq", Pallas in interpret mode); the same flow, a
two-lane paged batch and a w8a8 chat over an e4m3 cache in a subprocess
where importing ``jax`` or the JAX package fails; the on-device sampling chain against the JAX chain for
fixed logits.
"""

import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fixtures import build_gq_models
from minigpt4_tpu.engine import device_sampling as jds
from minigpt4_tpu.engine.engine import MiniGPT4Engine as JaxEngine
from minigpt4_tpu.engine.sampling import Sampler as JaxSampler
from minigpt4_tpu.engine.sampling import SamplingParams as JaxParams
from minigpt4_tpu_torch.engine import MiniGPT4Engine, Sampler, SamplingParams
from minigpt4_tpu_torch.engine import device_sampling as tds
from minigpt4_tpu_torch.image import preprocess
from minigpt4_tpu_torch.library import MiniGPT4ChatBot

ROOT = Path(__file__).resolve().parent.parent
QUESTION = "what is in the image?"
IMAGE = np.random.default_rng(0).integers(0, 255, (40, 50, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def gq_files(tmp_path_factory):
    return build_gq_models(tmp_path_factory.mktemp("torch_engine"))


def _chat(engine_cls, params_cls, model, llm, **kw):
    eng = engine_cls(model, llm, n_ctx=256, n_batch=32, **kw)
    try:
        emb = eng.encode_image(preprocess(IMAGE, size=eng.vision_cfg.vit.image_size))
        eng.system_prompt()
        eng.begin_chat_image(emb, QUESTION)
        return emb, list(eng.generate(limit=10, params=params_cls(temp=0.0)))
    finally:
        eng.close()


@pytest.fixture(scope="module")
def port_chat(gq_files):
    return _chat(MiniGPT4Engine, SamplingParams, *gq_files, device="cpu")


def test_greedy_chat_matches_jax_engine(gq_files, port_chat):
    emb, tokens = port_chat
    jemb, jtokens = _chat(JaxEngine, JaxParams, *gq_files, quant_mode="gq")
    assert np.abs(emb - jemb).max() <= 1e-5 * np.abs(jemb).max()
    assert len(tokens) == 10
    assert "".join(tokens) == "".join(jtokens)


_NO_JAX = """
import json, sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
sys.modules["minigpt4_tpu"] = None  # and so does any import of the JAX package
sys.path.insert(0, sys.argv[1])
import numpy as np
from minigpt4_tpu_torch.engine import MiniGPT4Engine, SamplingParams
from minigpt4_tpu_torch.image import preprocess
eng = MiniGPT4Engine(sys.argv[2], sys.argv[3], n_ctx=256, n_batch=32, device="cpu")
img = np.random.default_rng(0).integers(0, 255, (40, 50, 3), dtype=np.uint8)
emb = eng.encode_image(preprocess(img, size=eng.vision_cfg.vit.image_size))
eng.system_prompt()
eng.begin_chat_image(emb, sys.argv[4])
toks = list(eng.generate(limit=10, params=SamplingParams(temp=0.0)))
eng.close()
from minigpt4_tpu_torch.engine.sessions import SessionPool
pool = SessionPool(sys.argv[2], sys.argv[3], session_ctx=256, n_ctx=256, n_batch=32,
                   paged_pool_pages=8, device="cpu")
lanes = []
for q in ("one two", "three four five"):
    s = pool.new_session()
    pool.begin_chat(s, q)
    lanes.append(s)
texts = pool.generate_batch(lanes, limit=8, params=SamplingParams(temp=0.0), decode_chunk=4)
w8 = MiniGPT4Engine(sys.argv[2], sys.argv[3], n_ctx=256, n_batch=32, device="cpu",
                    quant_mode="w8a8", cache_dtype="f8")
w8.begin_chat(sys.argv[4])
w8_toks = list(w8.generate(limit=6, params=SamplingParams(temp=0.0)))
w8_form = (w8.quant_mode, str(w8.cache_dtype),
           type(w8.llm_params["layers"]["wqkv"]["w"]).__name__, len(w8_toks) > 0)
w8.close()
from minigpt4_tpu_torch.parallel import dryrun, pipeline, spmd  # noqa: F401
sys.path.insert(0, sys.argv[1] + "/tests")
from torch_rank_tasks import rank_tasks
one = MiniGPT4Engine(sys.argv[2], sys.argv[3], n_ctx=256, n_batch=32, device="cpu",
                     quant_mode="repack")
tp1 = dryrun.chat_tokens(one)
one.close()
task = dict(model=sys.argv[2], llm=sys.argv[3], n_ctx=256, n_batch=32, quant_mode="repack")
ranks = dryrun.run_ranks(rank_tasks, 2, ([("chat", "chat", task), ("imports", "imports", {})],),
                         device="cpu", timeout_s=240)
print(json.dumps({"tokens": toks, "jax_loaded": sys.modules["jax"] is not None,
                  "jax_package_loaded": sys.modules["minigpt4_tpu"] is not None,
                  "paged_batch": [len(t) > 0 for t in texts],
                  "free_pages": pool.paged_pool.free_pages, "w8a8_f8": w8_form,
                  "tp2_equals_tp1": [r["chat"] == tp1 for r in ranks],
                  "rank_imports": [r["imports"] for r in ranks]}))
"""


def test_port_runs_without_jax(gq_files, port_chat):
    model, llm = gq_files
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX, str(ROOT), str(model), str(llm), QUESTION],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"tokens": port_chat[1], "jax_loaded": False, "jax_package_loaded": False,
                   "paged_batch": [True, True], "free_pages": 8,
                   "w8a8_f8": ["w8a8", "torch.float8_e4m3fn", "I8SBQuant", True],
                   "tp2_equals_tp1": [True, True], "rank_imports": [[], []]}


def test_port_sources_never_import_jax():
    """Neither JAX nor the JAX package (``minigpt4_tpu``, as opposed to
    ``minigpt4_tpu_torch``) is imported by the port or by chip_smoke.py; the
    card-side test files name nothing of the JAX package either."""
    jax_pkg = re.compile(r"^(import|from)\s+minigpt4_tpu(\.|\s|$)")
    files = sorted((ROOT / "minigpt4_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for f in files:
        for line in f.read_text().splitlines():
            s = line.strip()
            assert not (s.startswith(("import jax", "from jax"))), f"{f}: {s}"
            assert not jax_pkg.match(s), f"{f}: {s}"
    for name in ("test_torch_cuda.py", "test_torch_fixtures.py"):
        text = (ROOT / "tests" / name).read_text()
        assert re.search(r"\bminigpt4_tpu\.", text) is None, name


def test_chatbot_per_token_path_matches_chunked_generate(gq_files, port_chat):
    model, llm = gq_files
    bot = MiniGPT4ChatBot(str(model), str(llm), device="cpu")
    try:
        bot.upload_image(IMAGE)
        tokens = list(bot.generate(QUESTION, limit=10, temp=0.0))
        assert tokens == port_chat[1]
        second = list(bot.generate("and then?", limit=4, temp=0.8))
        assert 0 < len(second) <= 4
    finally:
        bot.free()


CHAINS = [
    dict(temp=0.8, top_k=40, top_p=1.0, tfs_z=1.0, typical_p=1.0),
    dict(temp=0.7, top_k=0, top_p=0.9, tfs_z=1.0, typical_p=1.0),
    dict(temp=1.0, top_k=0, top_p=1.0, tfs_z=0.95, typical_p=1.0),
    dict(temp=1.0, top_k=0, top_p=1.0, tfs_z=1.0, typical_p=0.9),
    dict(temp=0.8, top_k=40, top_p=0.9, tfs_z=0.97, typical_p=0.95),
]


@pytest.mark.parametrize("cfg", CHAINS, ids=lambda c: "-".join(f"{v}" for v in c.values()))
@pytest.mark.parametrize("with_bias", [False, True])
def test_sampling_chain_matches_jax(cfg, with_bias):
    v = 1000
    logits = np.random.default_rng(1).normal(0, 3, v).astype(np.float32)
    bias = np.zeros(v, np.float32)
    if with_bias:
        bias[[5, 17, 999]] = [8.0, -100.0, 2.5]
    order, scaled = tds.chain_sorted(torch.from_numpy(logits), tds.DeviceSamplingConfig(**cfg),
                                     torch.from_numpy(bias) if with_bias else None)
    jorder, jscaled = jds._chain_sorted(
        jnp.asarray(logits), *(jnp.asarray(cfg[k]) for k in
                               ("temp", "top_k", "top_p", "tfs_z", "typical_p")),
        jnp.asarray(bias) if with_bias else None)
    assert order.tolist() == np.asarray(jorder).tolist()
    kept, jkept = torch.isfinite(scaled).numpy(), np.isfinite(np.asarray(jscaled))
    assert np.array_equal(kept, jkept) and kept.sum() >= 1
    np.testing.assert_allclose(torch.softmax(scaled, -1).numpy(),
                               np.asarray(jnp.exp(jscaled - jscaled.max())
                                          / jnp.exp(jscaled - jscaled.max()).sum()),
                               rtol=1e-5, atol=1e-7)
    # draws land in the kept set only
    gen = torch.Generator().manual_seed(0)
    allowed = set(order[torch.isfinite(scaled)].tolist())
    draws = {int(tds.sample_token(torch.from_numpy(logits), gen, tds.DeviceSamplingConfig(**cfg),
                                  torch.from_numpy(bias) if with_bias else None))
             for _ in range(50)}
    assert draws <= allowed


def test_greedy_sample_is_argmax_of_biased_logits():
    logits = torch.tensor([0.0, 3.0, 1.0, 3.0])
    cfg = tds.DeviceSamplingConfig(temp=0.0)
    assert int(tds.sample_token(logits, torch.Generator(), cfg)) == 1
    bias = tds.logit_bias_tensor({2: 5.0}, 4, "cpu")
    assert int(tds.sample_token(logits, torch.Generator(), cfg, bias)) == 2


@pytest.mark.parametrize("params", [dict(temp=0.8), dict(temp=0.8, mirostat=2),
                                    dict(temp=0.0, logit_bias={3: 10.0})])
def test_host_sampler_is_the_jax_sampler(params):
    logits = np.random.default_rng(2).normal(0, 2, 300).astype(np.float32)
    a, b = Sampler(7), JaxSampler(7)
    got = [a.sample(logits, SamplingParams(**params)) for _ in range(20)]
    want = [b.sample(logits, JaxParams(**params)) for _ in range(20)]
    assert got == want
