"""Rank functions of the port's tests of tensor parallelism's second slice:
the sharded vision encoder, the sharded training step, serving over tp
ranks and speculation under tp.  Run through ``torch_rank_tasks.rank_tasks``
(kind "fn"); like the port, this module imports neither JAX nor the JAX
package.
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import torch

from minigpt4_tpu_torch import debug, serve
from minigpt4_tpu_torch.engine.device_sampling import lane_rows
from minigpt4_tpu_torch.engine.engine import MiniGPT4Engine
from minigpt4_tpu_torch.engine.sampling import SamplingParams
from minigpt4_tpu_torch.engine.sessions import SessionPool
from minigpt4_tpu_torch.formats import ContainerReader, LlamaFileReader
from minigpt4_tpu_torch.models import llama as llama_mod
from minigpt4_tpu_torch.models import minigpt4 as vision_mod
from minigpt4_tpu_torch.ops import counters
from minigpt4_tpu_torch.parallel import sharding, spmd
from minigpt4_tpu_torch.parallel.controller import replicated
from minigpt4_tpu_torch.parallel.mesh import make_mesh
from minigpt4_tpu_torch.train.projection import make_train_step

# the f32 fixture's greedy prompt for speculation: 8 seeded ids (numpy seed
# 0, ids 3..199 after BOS) and the model's first 30 greedy ids after them,
# whose continuation repeats n-grams of the prompt, so that drafts hold
SPEC_PROMPT = [1, 170, 128, 103, 56, 63, 11, 17, 215, 202, 35, 216, 79, 100, 35, 216, 64, 71,
               25, 162, 10, 237, 193, 95, 97, 235, 192, 72, 9, 218, 149, 7, 186, 235, 232, 195,
               17, 215]


def load(model: str, llm: str, device, n_ctx: int = 256) -> tuple:
    """(vision params, vision config, decoder params, decoder config), f32."""
    with ContainerReader(model) as r:
        vp, vcfg = vision_mod.load_params(r, torch.float32, device)
    with LlamaFileReader(llm) as r:
        lp, lcfg = llama_mod.load_params(r, torch.float32, n_ctx=n_ctx, device=device)
    return vp, vcfg, lp, lcfg


def sharded_encoder(g, model: str, pixels: np.ndarray) -> dict:
    """The sharded encoder (``sharding.shard_vision_params``) on ``pixels``:
    its embedding, its stage dumps (``debug.dump_vision_stages``), the
    placement, and the embedding of a deliberately wrong shard of qkv (its
    rows cut without the per-rank interleave, so rank 0 holds all of q)."""
    with ContainerReader(model) as r:
        vp, vcfg = vision_mod.load_params(r, torch.float32, g.device)
    x = torch.from_numpy(pixels).to(g.device)
    shards = sharding.shard_vision_params(vp, vcfg, g)
    with torch.no_grad():
        counters.reset()
        emb = vision_mod.encode_image(shards, x, vcfg, g).cpu().numpy()
        launches = counters.counts()
        whole = vision_mod.encode_image(vp, x, vcfg).cpu().numpy()
        blocks = vp["visual_encoder"]["blocks"]
        wrong_qkv = dict(blocks["qkv"], w=spmd.shard_weight(blocks["qkv"]["w"], "col", g.rank,
                                                           g.size))
        n = blocks["qkv"]["b"].shape[-1] // g.size
        wrong_qkv["b"] = blocks["qkv"]["b"][:, g.rank * n:(g.rank + 1) * n]
        wrong = dict(shards["visual_encoder"],
                     blocks=dict(shards["visual_encoder"]["blocks"], qkv=wrong_qkv))
        wrong = dict(shards, visual_encoder=wrong)
        emb_wrong = vision_mod.encode_image(wrong, x, vcfg, g).cpu().numpy()
    return {"emb": emb, "emb_wrong": emb_wrong, "whole": whole, "launches": launches,
            "stages_wrong": debug.dump_vision_stages(wrong, x, vcfg, g),
            "stages": debug.dump_vision_stages(shards, x, vcfg, g),
            "kinds": sharding.vit_placement(vp["visual_encoder"], vcfg.vit, g.size),
            "local_qkv": llama_mod._n_out(shards["visual_encoder"]["blocks"]["qkv"]["w"])}


def train_step_tp(g, model: str, llm: str, pixels: np.ndarray, tokens: np.ndarray,
                  mask: np.ndarray, device: str = "cpu") -> dict:
    """:func:`train_step` over all of this group's ranks as tp."""
    return train_step(make_mesh(1, g.size, device), model, llm, pixels, tokens, mask)


def train_step(mesh, model: str, llm: str, pixels: np.ndarray, tokens: np.ndarray,
               mask: np.ndarray, lr: float = 1e-3, no_copy: bool = False) -> dict:
    """One Adam step of ``llama_proj`` over ``mesh`` (this rank's view of a
    (dp, tp) layout), through the sharded encoder and decoder: the loss, the
    gradient of ``llama_proj`` and the updated projection.  ``no_copy``
    runs it with ``copy_to_tp`` replaced by the identity (the decoder's
    column-parallel inputs then keep their partial gradients).  Also the
    kernel launches of the step (none: the trainers run plain torch)."""
    vp, vcfg, lp, lcfg = load(model, llm, mesh.device, n_ctx=64)
    vision, llm_p = sharding.shard_params(vp, vcfg, lp, mesh.tp_group)
    proj = {k: v.detach().clone().requires_grad_(True) for k, v in vp["llama_proj"].items()}
    frozen = {"vision": {k: v for k, v in vision.items() if k != "llama_proj"}, "llm": llm_p}
    step = make_train_step(vcfg, lcfg, torch.optim.Adam(list(proj.values()), lr=lr), mesh)
    saved = llama_mod.copy_to_tp
    if no_copy:
        llama_mod.copy_to_tp = lambda x, group: x
    counters.reset()
    try:
        proj, loss = step(proj, frozen, *(torch.from_numpy(a).to(mesh.device)
                                          for a in (pixels, tokens, mask)))
    finally:
        llama_mod.copy_to_tp = saved
    return {"loss": float(loss), "launches": counters.counts(),
            "grad": {k: v.grad.cpu().numpy().copy() for k, v in proj.items()},
            "proj": {k: v.detach().cpu().numpy().copy() for k, v in proj.items()}}


def sharding_cases(g, model: str, llm: str, pixels: np.ndarray, batch: dict) -> dict:
    """Every case of ``tests/test_torch_sharding.py`` on a world of 4 ranks
    laid out as a (dp, tp) = (2, 2) mesh: the sharded encoder over this
    rank's tp pair, the tp = 2 training step on the pair (with and without
    ``copy_to_tp``), the dp = 2 x tp = 2 step over the whole mesh, and the
    dry run's steps 1 and 2 on the pair."""
    from minigpt4_tpu_torch.parallel import dryrun
    from minigpt4_tpu_torch.parallel.mesh import Mesh

    mesh = make_mesh(2, 2, "cpu")
    pair = Mesh(dp=1, tp=2, dp_rank=0, tp_group=mesh.tp_group, dp_group=None)
    files = {"llm_model": model, "llm": llm}
    sharded, whole = dryrun.sharded_chat_tokens(mesh.tp_group, files)
    return {"encoder": sharded_encoder(mesh.tp_group, model, pixels),
            "train": train_step(pair, model, llm, **batch),
            "train no copy": train_step(pair, model, llm, no_copy=True, **batch),
            "dp2 tp2": train_step(mesh, model, llm, **batch),
            "dryrun": {"train": dryrun.sharded_train_step(pair, files, 2), "sharded": sharded,
                       "whole": whole}}


# -- serving over the ranks ---------------------------------------------------

def _post(base: str, path: str, body: dict | None = None, timeout: float = 60.0):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data, method="POST",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as f:
            return f.status, json.loads(f.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def chat_requests(base: str, prompts: list, limit: int) -> list:
    """One greedy chat per prompt, each on a new session: (status, body)."""
    out = []
    for q in prompts:
        code, made = _post(base, "/v1/sessions")
        if code != 200:
            out.append((code, made))
            continue
        out.append(_post(base, f"/v1/sessions/{made['session_id']}/chat",
                         {"message": q, "limit": limit, "temp": 0.0}))
    return out


def _fail_on(message: str):
    """A follower's ``SessionPool.feed`` that raises after feeding the
    pieces of ``message`` (a planted failure of one rank alone, past the
    operation's collectives)."""
    feed = SessionPool.feed

    def failing(self, s, pieces):
        feed(self, s, pieces)
        if any(kind == "text" and message in x for kind, x in pieces):
            raise RuntimeError("planted follower failure")

    return failing


def _held_together(httpd, n: int, continuous: bool) -> list:
    """Hold the next ``n`` requests at rank 0's batcher until all ``n`` have
    prefilled (their prefills run one after another under the controller's
    order), so that they decode together.  Returns the list that fills with
    the lanes of each window group, or the active lanes of each continuous
    step."""
    lanes, batcher = [], httpd.batcher
    submit, together = batcher.submit, threading.Barrier(n, timeout=60)

    def held_submit(*a, **k):
        together.wait()
        return submit(*a, **k)

    batcher.submit = held_submit
    if continuous:
        step = batcher._step
        batcher._step = lambda: (lanes.append(batcher._n_active()), step())[1]
    else:
        stream = httpd.pool.generate_batch_stream
        httpd.pool.generate_batch_stream = lambda sessions, *a, **k: (
            lanes.append(len(sessions)), stream(sessions, *a, **k))[1]
    return lanes


def serve_run(g, model: str, llm: str, server: dict, prompts: list, limit: int,
              fail_on: str | None = None, together: bool = False) -> dict:
    """``serve.start_server(tp=g.size)`` on this group: rank 0 serves and
    sends the chats of ``prompts`` (then closes the server), the other
    ranks follow.  ``fail_on``: a prompt whose feed raises on rank 1
    alone.  ``together``: the chats are sent at once and held at the
    batcher until all have prefilled (:func:`_held_together`).  Rank 0
    returns the responses (and the lanes that decoded together); a follower
    what its loop ended with."""
    saved = SessionPool.feed
    if fail_on is not None and g.rank == 1:
        SessionPool.feed = replicated(_fail_on(fail_on))
    try:
        httpd = serve.start_server(model, llm, port=0, device="cpu", session_ctx=256, n_ctx=256,
                                   n_batch=32, tp=g.size, tp_timeout_s=60, **server)
    except Exception as e:  # a follower whose loop ended on a divergence
        return {"follower": f"{type(e).__name__}: {e}"}
    finally:
        SessionPool.feed = saved
    if httpd is None:
        return {"follower": "stopped"}
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    lanes = None
    try:
        if together:
            lanes = _held_together(httpd, len(prompts), server.get("continuous", False))
            res = [None] * len(prompts)
            clients = [threading.Thread(target=lambda i=i: res.__setitem__(
                i, chat_requests(base, prompts[i:i + 1], limit)[0])) for i in range(len(prompts))]
            for c in clients:
                c.start()
            for c in clients:
                c.join()
        else:
            res = chat_requests(base, prompts, limit)
        broken = httpd.ranks.ctl.broken
    finally:
        httpd.shutdown()
        httpd.server_close()
    return {"responses": res, "broken": broken, "lanes": lanes}


# -- speculation under tp -----------------------------------------------------

def spec_run(g, model: str, llm: str, k: int, n_passes: int, limit: int) -> dict:
    """n-gram speculation over the ranks: the greedy loop on SPEC_PROMPT
    (tokens, counts) and plain greedy ids after it; the engine's greedy chat
    with and without ``speculative_k``; a seeded sampled chat with it."""
    vp, vcfg, lp, lcfg = load(model, llm, g.device)
    shards = spmd.shard_llama_params(lp, g)
    ccfg = spmd.cache_cfg(lcfg, g.size)
    out = {}
    with torch.no_grad():
        def prefill():
            cache = llama_mod.init_cache(ccfg, 1, torch.float32, g.device)
            e = llama_mod.embed_tokens(shards, torch.tensor([SPEC_PROMPT]))
            return cache, llama_mod.forward(shards, cache, e, 0, lcfg, tp=g)

        cache, logits = prefill()
        hist = torch.full((1, lcfg.n_ctx), -1, dtype=torch.long)
        hist[0, :len(SPEC_PROMPT)] = torch.tensor(SPEC_PROMPT)
        toks, counts, _, _ = llama_mod.speculative_decode_loop(
            shards, cache, logits, len(SPEC_PROMPT), hist, n_passes, k, lcfg, tp=g)
        out["loop"] = (toks[0].tolist(), counts[0].tolist())
        cache, logits = prefill()
        ids, _ = llama_mod.decode_loop(shards, cache, logits, len(SPEC_PROMPT), n_passes * k,
                                       [torch.Generator()],
                                       lane_rows([SamplingParams(temp=0.0)], lcfg.n_vocab, "cpu"),
                                       lcfg, tp=g)
        out["plain_loop"] = ids[0].tolist()
    for name, spec in (("plain", 0), ("spec", k)):
        eng = MiniGPT4Engine(model, llm, n_ctx=256, n_batch=32, device="cpu", tp=g.size,
                             speculative_k=spec)
        try:
            eng.system_prompt()
            eng.begin_chat("what is this?")
            out[f"{name}_greedy"] = list(eng.generate(limit=limit, params=SamplingParams(
                temp=0.0)))
            if spec:
                eng.reset()
                eng._st.generator.manual_seed(7)
                eng.system_prompt()
                eng.begin_chat("what is this?")
                out["spec_sampled"] = list(eng.generate(limit=limit, params=SamplingParams(
                    temp=0.8, top_k=40)))
        finally:
            eng.close()
    return out
