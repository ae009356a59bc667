"""Cold-start / warm-start TTFT probe through the real deploy path.

Counterpart of the JAX package's ``tools/coldstart_probe.py``, with its flags
plus ``--device``.  Drives ``MiniGPT4Engine`` from model files on disk
(``make_synth_13b`` writes a byte-faithful 13B pair; ``chip_smoke.py`` writes
one under ``build/smoke_models/``) and reports:

  * build_s       engine construction (mmap load, upload to the card, gq /
                  repacked forms built there)
  * encode_ms     the first image encode (ViT -> Q-Former -> projection)
  * ttft_ms       ``begin_chat_image`` + the first greedily sampled token
  * decode_tok_s  the engine's per-token rate over ``--n-decode`` strict
                  ``add_tokens`` / ``sample_token`` steps (the C ABI's path)

The card is synchronised before every clock read.  The engine runs each step
as it always does: a step's first use eagerly, its second use captured into
a CUDA graph, later uses replayed (``engine/graphs.py``), so ``ttft_ms`` pays
the first-use runs a fresh process pays.

"Cold" here means a fresh process with an empty ``build/kernels/``, the one
thing that persists across processes (``minigpt4_tpu_torch/warmup.py``): its
first kernel call then runs nvcc over ``csrc/``, inside whichever figure
makes that call.  The JAX tool's compile-cache variable has no counterpart
(the port's kernels are built once, by nvcc, not compiled per shape):

    # cold: no kernel library yet
    rm -rf build/kernels
    python -m minigpt4_tpu_torch.tools.coldstart_probe \\
        -m build/synth13b/minigpt4-13B.bin -l build/synth13b/vicuna-13b-q5_k.bin
    # warm: the library a previous run (or chip_smoke.py) built
    python -m minigpt4_tpu_torch.tools.coldstart_probe -m ... -l ...

Output: a ``[launches]`` line with the kernel wrappers' launch counts of this
process as a JSON object (``ops/counters.named``), then one JSON line last.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("-l", "--llm_model", required=True)
    ap.add_argument("--n-ctx", type=int, default=2048)
    ap.add_argument("--n-decode", type=int, default=32)
    ap.add_argument("--quant-mode", default="auto")
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from ..engine.engine import MiniGPT4Engine
    from ..engine.sampling import SamplingParams
    from ..ops import counters
    from ._harness import card

    dev = torch.device(args.device)

    def clock() -> float:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    t0 = clock()
    eng = MiniGPT4Engine(args.model, args.llm_model, n_ctx=args.n_ctx,
                         quant_mode=args.quant_mode, device=dev)
    build_s = clock() - t0

    rng = np.random.default_rng(0)
    pixels = rng.normal(0, 1, (1, 3, args.image_size, args.image_size)).astype(np.float32)
    t0 = clock()
    emb = eng.encode_image(pixels)
    encode_ms = (clock() - t0) * 1e3

    greedy = SamplingParams(temp=0.0)
    t0 = clock()
    eng.begin_chat_image(emb, "describe this image")
    tid = eng.sample_token(greedy)
    ttft_ms = (clock() - t0) * 1e3

    t0 = clock()
    n = 0
    for _ in range(args.n_decode):
        eng.add_tokens([tid])
        tid = eng.sample_token(greedy)
        n += 1
    dt = clock() - t0
    eng.close()
    print("[launches] " + json.dumps(counters.named()), flush=True)
    print(json.dumps({"build_s": build_s, "encode_ms": encode_ms, "ttft_ms": ttft_ms,
                      "decode_tok_s": n / dt, "n_decode": n, "device": card(dev)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
