"""Deploy-time warmup CLI: build the CUDA kernels, and measure the graph
captures of an engine of the given flags.

Counterpart of ``minigpt4_tpu/warmup.py``.  What persists across processes
is the kernel library: nvcc runs once per source tree, and the library is
kept under ``build/kernels/`` and reused while the sources are unchanged,
so a chat or server started afterwards loads it instead of compiling it.
Captured CUDA graphs do not persist (unlike the JAX package's compile
cache, they live in the process that captured them).  So the CLI loads the
engine, runs :meth:`MiniGPT4Engine.warmup` (the prefill buckets 8, 32, 128
and 512, the decode chunks 1 and 16, with ``--speculative-k`` the n-gram
speculative dispatch, greedy and sampled, and the encoder) and prints its seconds,
the graphs it captured and the memory their pool holds: what a chat
process of the same flags spends when it calls ``MiniGPT4Engine.warmup()``.
(A server captures what it replays, the paged group's decode chunks, at
its start: ``serve.start_server`` calls ``SessionPool.warmup``.)

    python -m minigpt4_tpu_torch.warmup -m minigpt4-13B.bin -l vicuna-13b-q5_k.bin \\
        [--n-ctx 2048] [--quant-mode auto] [--cache-dtype auto]

The flags are the engine knobs that change what is captured.  ``--tp N``
runs N ranks (spawned processes on the card's devices, a ``file://``
rendezvous), each building the kernels and running each of those steps
once eagerly on its shards: a tensor-parallel engine captures no graph
(gloo's all-reduces cannot be captured), so it reports 0 graphs and the
step keys it ran.  ``--draft-llm`` and ``--draft-head`` load the drafter,
whose dispatches run eagerly.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

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
    ap.add_argument("--speculative-k", type=int, default=0,
                    help="capture the speculative dispatch of this verify width (0 = off)")
    ap.add_argument("--draft-llm", default=None, metavar="PATH")
    ap.add_argument("--draft-head", default=None, metavar="PATH")
    args = ap.parse_args(argv)
    engine_kw = dict(n_ctx=args.n_ctx, quant_mode=args.quant_mode,
                     cache_dtype=None if args.cache_dtype == "auto" else args.cache_dtype,
                     speculative_k=args.speculative_k, draft_llm_path=args.draft_llm,
                     draft_head_path=args.draft_head)
    if args.tp == 1:
        line = warm(None, args.model, args.llm_model, engine_kw)
    else:
        from .parallel.dryrun import run_ranks

        for f in (args.model, args.llm_model):
            if not Path(f).is_file():  # before any rank starts
                raise FileNotFoundError(f)
        line = run_ranks(warm, args.tp, (args.model, args.llm_model, engine_kw),
                         timeout_s=1800)[0]
    print(line)
    return 0


def warm(g, model: str, llm: str, engine_kw: dict) -> str:
    """Load the engine (over ``g``'s ranks where given), warm it up and
    describe it in one line."""
    from .engine.engine import MiniGPT4Engine
    from .ops import _build

    t0 = time.perf_counter()
    eng = MiniGPT4Engine(model, llm, tp=g.size if g else 1, **engine_kw)
    t_load = time.perf_counter() - t0
    try:
        stats = eng.warmup()
    finally:
        eng.close()
    nvcc = ("not run (sources unchanged)" if _build.build_seconds is None
            else f"nvcc {_build.build_seconds:.1f} s")
    what = (f"{stats['graphs']} graphs captured, their memory pool holds "
            f"{stats['pool_bytes'] / 1e9:.3f} GB")
    if g is not None:
        what = (f"tp={g.size}: {stats['graphs']} graphs captured (a tensor-parallel engine runs "
                f"eagerly: gloo's all-reduces cannot be captured), {len(stats['eager_keys'])} "
                "step keys run once eagerly")
    return (f"[warmup] load {t_load:.1f} s; kernels {stats['build_s']:.1f} s ({nvcc}), library "
            f"{_build.BUILD_DIR / _build.LIB_NAME}; warmup {stats['warmup_s']:.1f} s; {what}")


if __name__ == "__main__":
    raise SystemExit(main())
