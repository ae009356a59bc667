"""Paged-serving capacity probe: how many 13B lanes decode past 8, and at what
aggregate rate.

Counterpart of the JAX package's ``tools/probe_paged_capacity.py``, with its
flags plus ``--device``.  A dense batched group reserves ``session_ctx``
positions per lane; the page pool charges a lane only for the pages it
holds.  For each lane count this probe builds a ``PagedKVPool`` sized for a
short conversation's working set (``--pages-per-lane``; zero contents: decode
cost does not depend on KV values) and times the paged decode loop the
serving paths dispatch (``llama.decode_loop(page_table=...)``).  Past 8 lanes
a step's decode rows exceed 8, so w8a8 matmuls take ``i8_prefill`` and the
paged flash-decode kernel runs at B = lanes.

Each step runs as the engine runs it: the plain group chunk and the
speculative verify passes through captured CUDA graphs (``engine/graphs.py``
``StepGraphs.decode_chunk`` and ``spec_chunk`` over the page table, as the
pool's group steps; eagerly on the CPU).  ``captured`` says which.

``--spec-k K`` measures paged speculative serving instead: a greedy run-in of
32 tokens through the paged decode loop (the model's own continuation seeds
the n-gram histories, and a same-session run of it first gives
``plain_step_ms``), landing the cursors K before a page edge so that every
verify span crosses pages, then ``--steps`` dispatches of two greedy verify
passes of width K at fixed cursors: ``spec_pass_ms`` (the hardware cost) and
``accept_per_pass`` (synthetic greedy streams go cyclic and draft well: the
aggregate is this workload's optimistic end).

    python -m minigpt4_tpu_torch.tools.probe_paged_capacity --model 13B --lanes 8,12,16
    python -m minigpt4_tpu_torch.tools.probe_paged_capacity --model tiny --lanes 2,3 \\
        --quant-mode auto --device cpu

One JSON line per lane count: ``pool_mb``, ``dense_reservation_mb`` (what the
same lanes would reserve dense), and ``aggregate_tok_s`` / ``per_lane_tok_s``
or ``plain_step_ms`` / ``spec_pass_ms`` / ``accept_per_pass``; a lane count
that fails prints ``{"lanes": n, "error": ...}`` and the next one runs.
Activations are the engine's f32.  :func:`run` takes a decoder its caller
already built.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

SESSION_CTX = 512  # the serving context the pool's lanes are sized for
PASSES = 2  # verify passes per speculative dispatch
RUNIN = 32  # greedy tokens that seed the n-gram histories


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="13B")
    ap.add_argument("--lanes", default="8,12,16")
    ap.add_argument("--pages-per-lane", type=int, default=2)
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--quant-mode", default="w8a8")
    ap.add_argument("--cache-dtype", choices=["bf16", "f8"], default="f8")
    ap.add_argument("--spec-k", type=int, default=0, metavar="K",
                    help="measure paged speculative serving instead: greedy verify passes of "
                         "width K over the pool, with the cursors K positions before a page "
                         "edge so that verify spans cross pages every step")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def _lane(params: dict, bcfg, lanes: int, args: argparse.Namespace, dev: torch.device,
          graph_pool) -> dict:
    from ..engine.device_sampling import lane_rows
    from ..engine.engine import CACHE_DTYPES
    from ..engine.graphs import StepGraphs
    from ..engine.paged import PAGE, PagedKVPool
    from ..engine.sampling import SamplingParams

    cache_dtype = CACHE_DTYPES[args.cache_dtype]
    ppl, spec_k = args.pages_per_lane, args.spec_k
    if spec_k:
        # cursors K before a page edge after the run-in: verify spans straddle pages
        start_pos = ppl * PAGE - spec_k - RUNIN
        ppl_alloc = ppl + -(-(PASSES * spec_k + RUNIN) // PAGE)
    else:
        start_pos = (ppl - 1) * PAGE  # cursors mid-way into the last held page
        ppl_alloc = ppl
    pool = PagedKVPool(bcfg, lanes * ppl_alloc, bcfg.n_ctx, dtype=cache_dtype, device=dev)
    pt = torch.from_numpy(np.stack([pool.table_row(pool.alloc(ppl_alloc))
                                    for _ in range(lanes)])).to(dev)
    kv = {"k": pool.k, "v": pool.v}
    logits = torch.zeros((lanes, bcfg.n_vocab), dtype=torch.float32, device=dev)
    pos = torch.full((lanes,), start_pos, dtype=torch.int32, device=dev)
    greedy = lane_rows([SamplingParams(temp=0.0)] * lanes, bcfg.n_vocab, dev)
    steps = StepGraphs(params, bcfg, kv, dev, graph_pool, eager=dev.type != "cuda")
    dense_mb = (2 * lanes * bcfg.n_layer * bcfg.n_head * bcfg.n_ctx * bcfg.head_dim
                * pool.k.element_size() / 1e6)
    line = {"lanes": lanes, "pool_mb": 2 * pool.k.numel() * pool.k.element_size() / 1e6,
            "dense_reservation_mb": dense_mb}

    def chunk(lg, n):
        return steps.decode_chunk(lg, pos, n, [None] * lanes, greedy, page_table=pt,
                                  capture=True)

    if spec_k:
        toks, _ = chunk(logits, RUNIN)  # first use: the capture
        toks.cpu()
        # a same-session plain baseline (its writes are overwritten by the
        # real run-in below): the spec pass's per-token comparison point
        t0 = time.perf_counter()
        toks, _ = chunk(logits, RUNIN)
        toks.cpu()
        line["plain_step_ms"] = (time.perf_counter() - t0) / RUNIN * 1e3
        # the real run-in: seeds the n-gram histories and the KV state
        toks, logits = chunk(logits, RUNIN)
        hist = torch.full((lanes, bcfg.n_ctx), -1, dtype=torch.int32, device=dev)
        hist[:, start_pos:start_pos + RUNIN] = toks.to(torch.int32)
        pos = pos + RUNIN

        def spec(lg, h):
            return steps.spec_chunk(lg, pos, h, PASSES, spec_k, pt, capture=True)

        toks, cnt, logits, hist = spec(logits, hist)
        toks.cpu()
        t0 = time.perf_counter()
        n_tok = n_pass = 0
        for _ in range(args.steps):
            # fixed cursors (state reuse): timing only
            toks, cnt, logits, hist = spec(logits, hist)
            n_tok += int(cnt.sum().cpu())
            n_pass += PASSES * lanes
        dt = time.perf_counter() - t0
        line.update({"spec_k": spec_k, "aggregate_tok_s_measured": n_tok / dt,
                     "accept_per_pass": n_tok / n_pass,
                     "spec_pass_ms": dt / (args.steps * PASSES) * 1e3,
                     "captured": steps.replays > 0})
    else:
        toks, logits = chunk(logits, args.chunk)
        toks.cpu()
        t0 = time.perf_counter()
        n = 0
        for _ in range(args.steps):
            toks, logits = chunk(logits, args.chunk)
            toks.cpu()
            n += args.chunk
        dt = time.perf_counter() - t0
        line.update({"aggregate_tok_s": lanes * n / dt, "per_lane_tok_s": n / dt,
                     "captured": steps.replays > 0})
    return line


def run(params: dict, cfg, args: argparse.Namespace) -> list[dict]:
    """One line per lane count of ``args.lanes`` for the decoder ``params``
    of ``cfg`` already on ``args.device`` (its cache sized for
    SESSION_CTX); a failing lane count gives an ``error`` line.  Returns the
    printed lines."""
    from ._harness import card

    dev = torch.device(args.device)
    bcfg = dataclasses.replace(cfg, n_ctx=SESSION_CTX)
    graph_pool = torch.cuda.graph_pool_handle() if dev.type == "cuda" else None
    lines = []
    for lanes in (int(x) for x in args.lanes.split(",")):
        try:
            with torch.no_grad():
                line = dict(_lane(params, bcfg, lanes, args, dev, graph_pool), device=card(dev))
        except Exception as e:  # noqa: BLE001: a lane count that fails is reported, as in JAX
            line = {"lanes": lanes, "error": f"{type(e).__name__}: {e}"}
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


def main(argv=None) -> int:
    from ._harness import synth_decoder

    args = parse_args(argv)
    run(*synth_decoder(args.model, args.quant_mode, args.device), args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
