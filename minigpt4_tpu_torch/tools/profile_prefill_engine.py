"""Decompose the 13B 512-token prefill step: matmul tiles against the attention span.

Counterpart of the JAX package's ``tools/profile_prefill_engine.py``, plus
``--device`` and the flags below.  It times ``llama.forward`` at M = 512 rows
over an e4m3 cache on the 13B gq decoder as ``benchmark.bench_pack_policy``
packs it, on two axes:

  * the attention span: ``attn_len`` None (S = 512 > 32 rows take the plain
    masked attention over the whole n_ctx = 2048, materializing [1, 40, 512,
    2048] f32 scores a layer) or 512 (the bucket the engine passes);
  * the matmul tile.  JAX's axis is ``group_i8.PREFILL_TN``, the weight
    rows a TPU grid step covers, which it rebinds for the run.  The port's
    counterpart is the prefill kernel's token tile (``ops/qmm_prefill.py``
    ``TOKEN_TILES``, read by ``token_tile``): it is rebound to one tile for
    each arm, over the tiles the kernel has instances for, and restored
    afterwards.  Both trade how often an operand is re-read (a TPU weight
    tile re-reads x; a token tile dequantizes the weight once per tile)
    against padding a ragged M.

Each arm runs as the engine runs its prefill buckets: one captured CUDA graph
(``engine/graphs.py`` ``StepGraphs.prefill``) replayed, eagerly on the CPU.
The time of a call is the marginal between a short and a long chain
(``--chains``, 4 and 12 calls as JAX), the least of ``--reps``.  One JSON line
per arm: ``tn`` (the token tile), ``attn_len``, ``prefill512_ms``,
``prefill_tok_s``, plus ``captured`` and ``device``.

    python -m minigpt4_tpu_torch.tools.profile_prefill_engine
    python -m minigpt4_tpu_torch.tools.profile_prefill_engine --model tiny --device cpu

:func:`run` takes a decoder its caller already built.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

M = 512  # prefill rows (the reference's n_batch)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="13B", help="benchmark.GEOMETRIES key")
    ap.add_argument("--chains", default="4,12",
                    help="short,long chain lengths whose marginal times a call")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def run(params: dict, cfg, args: argparse.Namespace) -> list[dict]:
    """Time every (tile, attn_len) arm on the gq decoder ``params`` of
    ``cfg`` already on ``args.device``; the prompt's M ids are drawn from
    ``default_rng(0)``.  Returns the printed lines; the token tiles are as
    they were when it returns."""
    from ..engine.graphs import StepGraphs
    from ..models import llama as llama_mod
    from ..ops import qmm_prefill
    from ._harness import card

    dev = torch.device(args.device)
    graphs = dev.type == "cuda"
    short, long = (int(n) for n in args.chains.split(","))
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.n_vocab, (1, M), dtype=np.int64)).to(dev)
    with torch.no_grad():
        e = llama_mod.embed_tokens(params, tokens)
    pool = torch.cuda.graph_pool_handle() if graphs else None

    def chain(steps, span, n: int) -> None:
        logits = None
        for _ in range(n):
            logits = steps.prefill(e, 0, M - 1, span)
        logits.cpu()  # the chain's one host sync

    saved = qmm_prefill.TOKEN_TILES
    lines = []
    try:
        for tn in saved:
            qmm_prefill.TOKEN_TILES = (tn,)  # read at each launch by token_tile
            for attn_len in (None, 512):
                cache = llama_mod.init_cache(cfg, 1, torch.float8_e4m3fn, dev)
                steps = StepGraphs(params, cfg, cache, dev, pool, eager=not graphs)
                with torch.no_grad():
                    steps.prefill(e, 0, M - 1, attn_len, capture=True).cpu()
                    best = float("inf")
                    for _ in range(args.reps):
                        t0 = time.perf_counter()
                        chain(steps, attn_len, short)
                        t1 = time.perf_counter()
                        chain(steps, attn_len, long)
                        t2 = time.perf_counter()
                        best = min(best, ((t2 - t1) - (t1 - t0)) / (long - short))
                line = {"tn": tn, "attn_len": attn_len, "prefill512_ms": best * 1e3,
                        "prefill_tok_s": M / best, "captured": graphs and steps.replays > 0,
                        "device": card(dev)}
                print(json.dumps(line), flush=True)
                lines.append(line)
                del steps, cache
    finally:
        qmm_prefill.TOKEN_TILES = saved
    return lines


def main(argv=None) -> int:
    from ._harness import synth_decoder

    args = parse_args(argv)
    params, cfg = synth_decoder(args.model, "gq", args.device)
    print(json.dumps({"built": True, "backend": torch.device(args.device).type}), flush=True)
    run(params, cfg, args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
