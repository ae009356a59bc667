"""Rank functions of the port's multi-rank tests, run through
``minigpt4_tpu_torch.parallel.dryrun.run_ranks``.

The spawned ranks import this module by name (the test process's
``sys.path`` reaches them), never a test module or ``conftest.py``: like
the port, it imports neither JAX nor the JAX package.
"""

import sys

import numpy as np
import torch

from minigpt4_tpu_torch.engine.engine import MiniGPT4Engine
from minigpt4_tpu_torch.engine.sampling import SamplingParams
from minigpt4_tpu_torch.engine.sessions import SessionPool
from minigpt4_tpu_torch.formats import LlamaFileReader
from minigpt4_tpu_torch.models import llama as llama_mod
from minigpt4_tpu_torch.ops import i8_matmul as i8
from minigpt4_tpu_torch.ops.flash_decode import sp_flash_decode_attention
from minigpt4_tpu_torch.parallel.dryrun import QUESTION, chat_tokens
from minigpt4_tpu_torch.parallel.spmd import cache_cfg, shard_llama_params, shard_weight


def greedy() -> SamplingParams:
    return SamplingParams(temp=0.0)


def stepwise_tokens(eng, n: int = 6) -> list[str]:
    """The prompt of ``dryrun.chat_tokens``, then ``n`` single end_chat steps
    (raw tokens)."""
    eng.system_prompt()
    eng.begin_chat(QUESTION)
    return [eng.end_chat(greedy()) for _ in range(n)]


def pool_run(pool, prompts=("one two", "three four five", "six"), limit: int = 12,
             decode_chunk: int = 4) -> dict:
    """One session's image chat, then a batched group of ``prompts``
    (paged when the pool has pages): texts, cursors and token histories."""
    s = pool.new_session()
    s.upload_image(np.zeros((3, 28, 28), np.float32))
    s.ask("what?")
    single = list(s.generate(limit=5, params=greedy()))
    s.close()
    sessions = []
    for q in prompts:
        s = pool.new_session()
        pool.begin_chat(s, q)
        sessions.append(s)
    texts = pool.generate_batch(sessions, limit=limit, params=greedy(),
                                decode_chunk=decode_chunk)
    states = [(s.n_past, list(s.state.tokens)) for s in sessions]
    for s in sessions:
        s.close()
    free = None if pool.paged_pool is None else pool.paged_pool.free_pages
    return {"single": single, "texts": texts, "states": states, "free_pages": free}


def rank_tasks(g, tasks: list) -> dict:
    """Run ``tasks``, a list of (label, kind, kwargs), on this rank; returns
    {label: result}.  Kinds: "chat" and "stepwise" (an engine of
    ``kwargs``), "pool" (a SessionPool of ``kwargs``), "refusal" (the
    engine's error message), "row_linear" and "sp" (see their functions),
    "imports" (the modules of JAX or of the JAX package this rank has
    loaded: none, since the port imports neither), "depth_gaps" (see
    :func:`depth_gaps`)."""
    out = {}
    for label, kind, kw in tasks:
        kw = dict(kw)
        if kind in ("chat", "stepwise", "refusal"):
            model, llm = kw.pop("model"), kw.pop("llm")
            try:
                eng = MiniGPT4Engine(model, llm, tp=g.size, device=g.device.type, **kw)
            except ValueError as e:
                if kind != "refusal":
                    raise
                out[label] = str(e)
                continue
            try:
                if kind == "refusal":
                    raise AssertionError(f"{label}: the engine was not refused")
                out[label] = chat_tokens(eng) if kind == "chat" else stepwise_tokens(eng)
            finally:
                eng.close()
        elif kind == "pool":
            model, llm = kw.pop("model"), kw.pop("llm")
            pool = SessionPool(model, llm, tp=g.size, device=g.device.type, **kw)
            try:
                out[label] = pool_run(pool)
            finally:
                pool.close()
        elif kind == "row_linear":
            out[label] = row_linear_cases(g, **kw)
        elif kind == "sp":
            out[label] = sp_attention(g, **kw)
        elif kind == "depth_gaps":
            out[label] = depth_gaps(g, **kw)
        elif kind == "imports":
            out[label] = sorted(m for m in sys.modules
                                if m.split(".")[0] in ("jax", "jaxlib", "minigpt4_tpu"))
        else:
            raise ValueError(f"unknown task kind {kind!r}")
    return out


def row_linear_cases(g, x: np.ndarray, w: np.ndarray, x8: np.ndarray, w8: np.ndarray) -> dict:
    """``models.llama._row_linear`` in its four cases on dense x [.., K] and
    w [K, N] (K-sharded weight with a split or a whole input; whole weight
    with a split or a whole input), and a K-sharded I8SBQuant of w8 [N, K8]
    on x8 (the global row absmax).  Returns this rank's outputs."""
    dev = g.device
    k, k8 = w.shape[0], w8.shape[1]
    kw, kw8 = k // g.size, k8 // g.size
    xs, ws = torch.from_numpy(x).to(dev), torch.from_numpy(w).to(dev)
    sl = slice(g.rank * kw, (g.rank + 1) * kw)
    out = {
        "k_sharded_split_input": llama_mod._row_linear(xs[..., sl], {"w": ws[sl]}, None, g, k),
        "k_sharded_whole_input": llama_mod._row_linear(xs, {"w": ws[sl]}, None, g, k),
        "whole_split_input": llama_mod._row_linear(xs[..., sl], {"w": ws}, None, g, k),
        "whole_whole_input": llama_mod._row_linear(xs, {"w": ws}, None, g, k),
    }
    codes, scales = i8.requantize_i8sb(torch.from_numpy(w8).to(dev))
    q8 = shard_weight(i8.I8SBQuant(codes, scales, k8), "row", g.rank, g.size)
    x8t = torch.from_numpy(x8).to(dev)
    out["i8_k_sharded"] = llama_mod._row_linear(x8t[..., g.rank * kw8:(g.rank + 1) * kw8], {"w": q8},
                                      None, g, k8)
    return {name: t.cpu().numpy() for name, t in out.items()}


def sp_attention(g, q: np.ndarray, ck: np.ndarray, cv: np.ndarray, positions: list,
                 scale: float, cache_dtype: str = "float32") -> dict:
    """``sp_flash_decode_attention`` of q over the cache [L, B, H, C, Dh],
    whose positions split evenly over the ranks; {pos0: output}."""
    c_local = ck.shape[3] // g.size
    sl = slice(g.rank * c_local, (g.rank + 1) * c_local)
    dt = getattr(torch, cache_dtype)
    kl, vl = (torch.from_numpy(np.ascontiguousarray(a[:, :, :, sl])).to(g.device, dt)
              for a in (ck, cv))
    qt = torch.from_numpy(q).to(g.device)
    return {p: sp_flash_decode_attention(qt, kl, vl, 0, p, scale, g, g.rank * c_local)
            .cpu().numpy() for p in positions}


def depth_gaps(g, files: list, tokens: list, swap_k: bool = False) -> list:
    """max |dlogit| / max |logit| of the prefill of ``tokens`` through each
    file of ``files`` (quant_mode="repack"), this rank's shards against the
    whole decoder in this process.  ``swap_k``: the row-parallel weights
    (wo, w2) take the other rank's K slice, a fault of the split."""
    toks = torch.tensor([tokens], device=g.device)
    gaps = []
    for path in files:
        with LlamaFileReader(path) as r:
            params, cfg = llama_mod.load_params(r, torch.float32, n_ctx=len(tokens),
                                                device=g.device, quant_mode="repack")
        sharded = shard_llama_params(params, g)
        if swap_k:
            layers = dict(sharded["layers"])
            for name in ("wo", "w2"):
                w = shard_weight(params["layers"][name]["w"], "row", g.size - 1 - g.rank, g.size)
                layers[name] = {**layers[name], "w": w}
            sharded = {**sharded, "layers": layers}
        logits = []
        with torch.no_grad():
            for p, c, tp in ((params, cfg, None), (sharded, cache_cfg(cfg, g.size), g)):
                cache = llama_mod.init_cache(c, 1, torch.float32, g.device)
                logits.append(llama_mod.forward(p, cache, llama_mod.embed_tokens(p, toks), 0,
                                                cfg, tp=tp))
        want, got = logits
        gaps.append(float((got - want).abs().max() / want.abs().max()))
    return gaps
