"""Serving and speculation over 2 tensor-parallel CPU ranks against the
port at tp = 1 and the JAX package at tp = 2.

One spawn (``dryrun.run_ranks``, rank functions in ``torch_tp_tasks``) runs
``serve.start_server(tp=2)`` three times, each rank taking its role from
the group: a window server over the page pool and a continuous server,
each sent its chats at once, and a window server whose rank 1 fails on one
prompt; then n-gram speculation at
tp = 2.  One more test starts ``python -m minigpt4_tpu_torch.serve ... --tp
2``, which spawns its other rank itself.

The prompts are tie-free on the fixture (f32): greedy ids are compared as
texts, exactly.  The speculative loop on a prompt whose continuation
repeats its n-grams (``torch_tp_tasks.SPEC_PROMPT``) accepts drafts, and
its tokens and counts equal JAX's ``speculative_decode_loop`` (the loop
JAX's engine at tp = 2 runs under ``shard_map``).
"""

import json
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fixtures import build_tiny_models
from minigpt4_tpu.engine.sampling import SamplingParams as JaxParams
from minigpt4_tpu.engine.sessions import SessionPool as JaxPool
from minigpt4_tpu.formats import LlamaFileReader as JaxReader
from minigpt4_tpu.models import llama as jllama
from minigpt4_tpu_torch import serve
from minigpt4_tpu_torch.engine.engine import MiniGPT4Engine
from minigpt4_tpu_torch.engine.sampling import SamplingParams
from minigpt4_tpu_torch.parallel import dryrun
from torch_rank_tasks import rank_tasks
from torch_tp_tasks import SPEC_PROMPT, chat_requests

# one intra-op thread: the suite runs several pytest-xdist workers on the same cores, where
# torch's OpenMP pools spin against each other and run ~17x slower
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PROMPTS = ["one two", "three four five", "six"]
LIMIT = 12
WINDOW = dict(batch_window_s=0.05, paged_pages=8)
CONTINUOUS = dict(continuous=True, max_batch=4, paged_pages=8)
K, PASSES, SPEC_LIMIT = 4, 12, 24


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    model, llm = build_tiny_models(tmp_path_factory.mktemp("torch_serve_tp"))
    return str(model), str(llm)


@pytest.fixture(scope="module")
def ranks(files):
    model, llm = files
    kw = dict(model=model, llm=llm, prompts=PROMPTS, limit=LIMIT)
    # the failing server last: a rank that failed leaves the group unusable
    tasks = [("spec", "fn", dict(fn="spec_run", model=model, llm=llm, k=K, n_passes=PASSES,
                                 limit=SPEC_LIMIT)),
             ("window", "fn", dict(fn="serve_run", server=WINDOW, together=True, **kw)),
             ("continuous", "fn", dict(fn="serve_run", server=CONTINUOUS, together=True, **kw)),
             ("fail", "fn", dict(fn="serve_run", server=WINDOW, fail_on="three four",
                                 **kw))]
    return dryrun.run_ranks(rank_tasks, 2, (tasks,), device="cpu", timeout_s=300)


def _texts(run: dict) -> list:
    assert all(code == 200 for code, _ in run["responses"]), run["responses"]
    return [body["text"] for _, body in run["responses"]]


@pytest.fixture(scope="module")
def tp1_texts(files):
    """The same requests to the port's window server at tp = 1."""
    import threading

    httpd = serve.start_server(*files, port=0, device="cpu", session_ctx=256, n_ctx=256,
                               n_batch=32, **WINDOW)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        res = chat_requests(f"http://127.0.0.1:{httpd.server_address[1]}", PROMPTS, LIMIT)
    finally:
        httpd.shutdown()
        httpd.server_close()
        httpd.pool.close()
    return _texts({"responses": res})


@pytest.fixture(scope="module")
def jax_texts(files):
    """JAX's SessionPool(tp=2) on the same prompts (``__graft_entry__``'s
    paged x tp pattern): one session per prompt, greedy."""
    pool = JaxPool(*files, session_ctx=256, n_ctx=256, n_batch=32, tp=2, paged_pool_pages=8)
    try:
        out = []
        for q in PROMPTS:
            s = pool.new_session()
            pool.begin_chat(s, q)
            out.append(pool.generate_batch([s], limit=LIMIT, params=JaxParams(temp=0.0))[0])
            s.close()
    finally:
        pool.close()
    return out


@pytest.mark.parametrize("mode", ["window", "continuous"])
def test_tp_server_gives_tp1_and_jax_ids(ranks, tp1_texts, jax_texts, mode):
    """The three chats, sent at once and held until all have prefilled,
    decode together (a window group or a continuous step of two lanes or
    more) and give the ids of sessions that decode alone."""
    got = _texts(ranks[0][mode])
    assert got == tp1_texts
    assert got == jax_texts
    assert max(ranks[0][mode]["lanes"]) >= 2, ranks[0][mode]["lanes"]
    assert ranks[0][mode]["broken"] is None
    assert ranks[1][mode] == {"follower": "stopped"}


def test_follower_failure_fails_the_request(ranks):
    """Rank 1 alone raises on the second prompt: that request fails with
    both ranks' outcomes named, the first one stands, every later request
    fails at once, and the follower's loop ends with the divergence."""
    run = ranks[0]["fail"]
    (c0, b0), (c1, b1), (c2, b2) = run["responses"]
    assert c0 == 200 and b0["text"]
    assert c1 == 500 and "rank 1: error RuntimeError: planted follower failure" in b1["error"]
    assert c2 == 500 and "diverged earlier" in b2["error"]  # its session was refused
    assert "planted follower failure" in run["broken"]
    assert ranks[1]["fail"]["follower"].startswith("ReplicaDiverged")


@pytest.fixture(scope="module")
def jax_spec(files):
    model, llm = files
    with JaxReader(llm) as r:
        jparams, jcfg = jllama.load_params(r, jnp.float32, n_ctx=256)
    cache = jllama.init_cache(jcfg, 1, jnp.float32)
    logits, cache = jllama.forward(jparams, cache, jllama.embed_tokens(
        jparams, jnp.asarray([SPEC_PROMPT], jnp.int32)), jnp.int32(0), jcfg)
    hist = np.full((1, 256), -1, np.int32)
    hist[0, :len(SPEC_PROMPT)] = SPEC_PROMPT
    toks, counts, _, _, _ = jllama.speculative_decode_loop(
        jparams, cache, logits, jnp.int32(len(SPEC_PROMPT)), jnp.asarray(hist), PASSES, K, jcfg)
    return {"loop": (np.asarray(toks)[0].tolist(), np.asarray(counts)[0].tolist())}


def test_speculative_loop_under_tp(ranks, jax_spec):
    """The greedy verify loop over the ranks: JAX's tokens and counts
    (drafts accepted), and the emitted ids are plain greedy decode's at
    tp = 2."""
    for r in ranks:
        toks, counts = r["spec"]["loop"]
        assert (toks, counts) == jax_spec["loop"]
        emitted = [t for row, c in zip(toks, counts) for t in row[:c]]
        assert len(emitted) > PASSES  # drafts held
        assert emitted == r["spec"]["plain_loop"][:len(emitted)]


def test_speculative_engine_under_tp(ranks, files):
    """``MiniGPT4Engine(tp=2, speculative_k=4)``: greedy ids equal plain
    decoding at tp = 2; the sampled stream is the same on both ranks and
    equals the port's at tp = 1 from the same seed."""
    eng = MiniGPT4Engine(*files, n_ctx=256, n_batch=32, device="cpu", speculative_k=K)
    try:
        eng._st.generator.manual_seed(7)
        eng.system_prompt()
        eng.begin_chat("what is this?")
        sampled1 = list(eng.generate(limit=SPEC_LIMIT, params=SamplingParams(temp=0.8, top_k=40)))
    finally:
        eng.close()
    for r in ranks:
        assert r["spec"]["spec_greedy"] == r["spec"]["plain_greedy"]
        assert r["spec"]["spec_sampled"] == sampled1
    assert ranks[0]["spec"]["spec_sampled"] == ranks[1]["spec"]["spec_sampled"]


def test_serve_cli_spawns_its_ranks(files, tp1_texts):
    """``python -m minigpt4_tpu_torch.serve ... --tp 2 --continuous`` spawns
    rank 1, serves a chat equal to tp = 1's, and stops its rank when
    terminated."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "minigpt4_tpu_torch.serve", *files, "--device", "cpu", "--port",
         "0", "--n-ctx", "256", "--session-ctx", "256", "--tp", "2",
         "--continuous", "--max-batch", "4", "--paged-pages", "8"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = ""
        deadline = time.monotonic() + 120
        while "serving on" not in line and time.monotonic() < deadline:
            line = proc.stdout.readline()
            assert line or proc.poll() is None, proc.stderr.read()
        base = line.split("serving on ")[1].strip()
        res = chat_requests(base, PROMPTS[:1], LIMIT)
        with urllib.request.urlopen(base + "/v1/health", timeout=30) as f:
            health = json.loads(f.read())
    finally:
        proc.terminate()
        out, err = proc.communicate(timeout=90)
    assert res[0][0] == 200, res
    assert res[0][1]["text"] == tp1_texts[0]
    assert health["ok"] and health["prefix_cache"] == {"entries": 0, "bytes": 0}
    assert proc.returncode == 0, err
    assert "rank 1 of 2" in err and "failed" not in err
