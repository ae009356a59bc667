"""Decompose the paged speculative verify-pass cost (one session, B lanes).

Counterpart of the JAX package's ``tools/probe_paged_spec_cost.py``, plus
``--device`` and ``--model`` (JAX's 13B by default).  It times, interleaved in one
process, the least of REPS runs of each arm:

  A. dense plain chunk      (``decode_loop`` over a stacked cache)
  B. dense spec pass k = 8  (``speculative_decode_loop``; and the 8-pass
                            dispatch, which shows what of a pass is the
                            dispatch's own cost spread over 2 passes)
  C. paged plain chunk      (``decode_loop`` over a page pool)
  D. paged spec pass k = 8  (spans cross a page edge: each span's rows land
                            on two pages)
  E. paged spec pass k = 8, aligned (cursors at a page start: no span
                            crosses)

D - E isolates what crossing costs; D - C against B - A the paged overhead of
speculation.  8 lanes, k = 8, an e4m3 cache, w8a8 weights with the engine's
f32 activations, cyclic histories (a period of 8 ids: drafts hold).  The dense
group is freed before the pool is allocated.

Each arm runs as the engine runs it: the paged plain chunk and the paged
verify passes through captured CUDA graphs (the pool's group steps, keys
("decode", ...) and ("spec", ...) with the table's width; D and E replay one
graph, the cursors being its inputs), the dense group's chunk and verify
passes eagerly (the window batcher's dense group runs eagerly); the
``*_eager_ms`` keys are C, D and E run eagerly too, the like-for-like points
against the captured ones, and ``captured`` lists the arms timed as graph
replays (none on the CPU).

    python -m minigpt4_tpu_torch.tools.probe_paged_spec_cost
    python -m minigpt4_tpu_torch.tools.probe_paged_spec_cost --model tiny --device cpu

One JSON line: ``dense_plain_ms``, ``dense_spec_ms``, ``dense_spec8_ms``,
``paged_plain_ms``, ``paged_spec_cross_ms``, ``paged_spec_aligned_ms`` (per
token of a chunk, per verify pass), ``paged_plain_eager_ms``,
``paged_spec_cross_eager_ms``, ``paged_spec_aligned_eager_ms``, ``captured``,
``device``.  :func:`run` takes a decoder its caller already built.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

LANES = 8
K = 8
PASSES = 2
CHUNK = 16
REPS = 3
SESSION_CTX = 512


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="13B")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def run(params: dict, cfg, args: argparse.Namespace) -> dict:
    """Every arm on the decoder ``params`` of ``cfg`` already on
    ``args.device``.  An arm that fails is reported on stderr and left out
    of the result (as in JAX).  Returns the printed dict."""
    from ..engine.device_sampling import lane_rows
    from ..engine.graphs import StepGraphs
    from ..engine.paged import PAGE, PagedKVPool
    from ..engine.sampling import SamplingParams
    from ..models import llama as llama_mod
    from ._harness import card

    dev = torch.device(args.device)
    graphs = dev.type == "cuda"
    bcfg = dataclasses.replace(cfg, n_ctx=SESSION_CTX)
    cache_dtype = torch.float8_e4m3fn
    greedy = lane_rows([SamplingParams(temp=0.0)] * LANES, bcfg.n_vocab, dev)
    gens = [None] * LANES
    logits0 = torch.zeros((LANES, bcfg.n_vocab), dtype=torch.float32, device=dev)
    hist0 = np.full((LANES, bcfg.n_ctx), -1, np.int32)
    hist0[:, :256] = np.tile(np.arange(8, dtype=np.int32), (LANES, 32))
    hist0 = torch.from_numpy(hist0).to(dev)
    pos_cross = torch.full((LANES,), PAGE - K, dtype=torch.int32, device=dev)  # spans straddle
    pos_align = torch.full((LANES,), PAGE, dtype=torch.int32, device=dev)  # inside page 1
    out: dict = {}
    captured: list[str] = []

    def measure(work):
        """First call of each closure (its warm-up or capture), then REPS
        interleaved timed calls each; the least per token or pass."""
        live = {}
        for name, fn in work:
            try:
                fn()
                live[name] = fn
            except Exception as e:  # noqa: BLE001: as the JAX tool, an arm that fails is skipped
                print(f"# {name}: {type(e).__name__}: {e}"[:300], file=sys.stderr)
        acc = {name: [] for name in live}
        for _ in range(REPS):
            for name, fn in live.items():
                t0 = time.perf_counter()
                fn()
                acc[name].append(time.perf_counter() - t0)
        for name, ts in acc.items():
            per = 8 if name.endswith("8") else PASSES if "spec" in name else CHUNK
            out[name + "_ms"] = min(ts) / per * 1e3

    with torch.no_grad():
        # --- phase 1: the dense group (freed before the pool allocates)
        dc = llama_mod.init_cache(bcfg, LANES, cache_dtype, dev)

        def dense_plain():
            t, _ = llama_mod.decode_loop(params, dc, logits0, pos_cross, CHUNK, gens, greedy,
                                         bcfg)
            t.cpu()

        def spec(cache, pos, n_passes, table=None):
            t, _, _, _ = llama_mod.speculative_decode_loop(params, cache, logits0, pos, hist0,
                                                           n_passes, K, bcfg, page_table=table)
            t.cpu()

        measure([("dense_plain", dense_plain),
                 ("dense_spec", lambda: spec(dc, pos_cross, PASSES)),
                 ("dense_spec8", lambda: spec(dc, pos_cross, 8))])
        del dc

        # --- phase 2: the page pool (3 pages a lane: room for crossing spans)
        pool = PagedKVPool(bcfg, LANES * 3, bcfg.n_ctx, dtype=cache_dtype, device=dev)
        pt = torch.from_numpy(np.stack([pool.table_row(pool.alloc(3))
                                        for _ in range(LANES)])).to(dev)
        kv = {"k": pool.k, "v": pool.v}
        steps = StepGraphs(params, bcfg, kv, dev,
                           torch.cuda.graph_pool_handle() if graphs else None, eager=not graphs)

        def paged_plain():
            t, _ = steps.decode_chunk(logits0, pos_cross, CHUNK, gens, greedy, page_table=pt,
                                      capture=True)
            t.cpu()

        def paged_plain_eager():
            t, _ = llama_mod.decode_loop(params, kv, logits0, pos_cross, CHUNK, gens, greedy,
                                         bcfg, page_table=pt)
            t.cpu()

        def paged_spec(pos):
            t, _, _, _ = steps.spec_chunk(logits0, pos, hist0, PASSES, K, pt, capture=True)
            t.cpu()

        measure([("paged_plain", paged_plain),
                 ("paged_plain_eager", paged_plain_eager),
                 ("paged_spec_cross", lambda: paged_spec(pos_cross)),
                 ("paged_spec_aligned", lambda: paged_spec(pos_align)),
                 ("paged_spec_cross_eager", lambda: spec(kv, pos_cross, PASSES, pt)),
                 ("paged_spec_aligned_eager", lambda: spec(kv, pos_align, PASSES, pt))])
        if steps.replays:
            captured += ["paged_plain", "paged_spec_cross", "paged_spec_aligned"]
        del steps, pool, kv
    out.update(captured=captured, device=card(dev))
    print(json.dumps(out), flush=True)
    return out


def main(argv=None) -> int:
    from ._harness import synth_decoder

    args = parse_args(argv)
    run(*synth_decoder(args.model, "w8a8", args.device), args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
