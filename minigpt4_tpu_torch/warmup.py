"""Deploy-time warmup CLI: build the CUDA kernels, and measure the graph
captures of an engine of the given flags.

Counterpart of ``minigpt4_tpu/warmup.py``.  What persists across processes
is the kernel library: nvcc runs once per source tree, and the library is
kept under ``build/kernels/`` and reused while the sources are unchanged,
so a chat or server started afterwards loads it instead of compiling it.
Captured CUDA graphs do not persist (unlike the JAX package's compile
cache, they live in the process that captured them).  So the CLI loads the
engine, runs :meth:`MiniGPT4Engine.warmup` (the prefill buckets 8, 32, 128
and 512, the decode chunks 1 and 16, the encoder) and prints its seconds,
the graphs it captured and the memory their pool holds: what a chat
process of the same flags spends when it calls ``MiniGPT4Engine.warmup()``.
(A server captures what it replays, the paged group's decode chunks, at
its start: ``serve.start_server`` calls ``SessionPool.warmup``.)

    python -m minigpt4_tpu_torch.warmup -m minigpt4-13B.bin -l vicuna-13b-q5_k.bin \\
        [--n-ctx 2048] [--quant-mode auto] [--cache-dtype auto]

The flags are the engine knobs that change what is captured.  ``--tp``
above 1 is refused (graphs cannot hold the ranks' gloo all-reduces: that
path runs eagerly, ROADMAP Queue 1 item 11), and so is ``--speculative-k``
(ROADMAP Queue 1, item 14).
"""

from __future__ import annotations

import argparse
import time

QUANT_MODES = ("auto", "repack", "qtensor", "w8a8", "gq")
CACHE_DTYPES = ("auto", "bf16", "f32", "f8")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-m", "--model", required=True, help="minigpt4 container")
    ap.add_argument("-l", "--llm_model", required=True, help="vicuna ggml file")
    ap.add_argument("--n-ctx", type=int, default=2048)
    ap.add_argument("--quant-mode", default="auto", choices=QUANT_MODES)
    ap.add_argument("--cache-dtype", default="auto", choices=CACHE_DTYPES)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--speculative-k", type=int, default=0)
    args = ap.parse_args(argv)
    if args.tp != 1:
        ap.error(f"--tp {args.tp}: a tensor-parallel engine runs eagerly (its gloo all-reduces "
                 "cannot be captured in a CUDA graph), so there is nothing to warm up; "
                 "not ported yet (ROADMAP Queue 1, item 11)")
    if args.speculative_k:
        ap.error("--speculative-k: speculative decoding is not ported yet "
                 "(ROADMAP Queue 1, item 14)")

    from .engine.engine import MiniGPT4Engine

    t0 = time.perf_counter()
    eng = MiniGPT4Engine(args.model, args.llm_model, n_ctx=args.n_ctx,
                         quant_mode=args.quant_mode,
                         cache_dtype=None if args.cache_dtype == "auto" else args.cache_dtype)
    t_load = time.perf_counter() - t0
    try:
        stats = eng.warmup()
    finally:
        eng.close()
    from .ops import _build

    nvcc = ("not run (sources unchanged)" if _build.build_seconds is None
            else f"nvcc {_build.build_seconds:.1f} s")
    print(f"[warmup] load {t_load:.1f} s; kernels {stats['build_s']:.1f} s ({nvcc}), library "
          f"{_build.BUILD_DIR / _build.LIB_NAME}; warmup {stats['warmup_s']:.1f} s; "
          f"{stats['graphs']} graphs captured, their memory pool holds "
          f"{stats['pool_bytes'] / 1e9:.3f} GB")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
