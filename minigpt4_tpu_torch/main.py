"""CLI chat on the PyTorch port, the examples/main.cpp equivalent (the JAX
package's is ``examples/main.py``, with the same flags): load the models,
load and preprocess an image, encode it, then the system prompt and a
streamed answer to each prompt, every sampling knob a flag.

    python -m minigpt4_tpu_torch.main -m minigpt4-13B.bin -l vicuna-13b-q5_k.bin \\
        -i image.png -p "what is in the picture?" [--device cuda] [--ctx-shift]

The engine runs on ``--device`` (default cuda) and never falls back to the
CPU on its own.  ``--speculative-k K`` decodes by speculation (greedy output
is token-identical, sampled output runs speculative sampling);
``--draft-llm`` or ``--draft-head`` drafts greedy decode with a smaller model.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import time

from .engine import MiniGPT4Engine, SamplingParams
from .image import load_image, preprocess
from .utils import Verbosity


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="minigpt4_tpu_torch chat CLI")
    p.add_argument("-m", "--model", required=True, help="minigpt4 container path")
    p.add_argument("-l", "--llm_model", required=True, help="vicuna ggml path")
    p.add_argument("-i", "--image", required=True, help="image path")
    p.add_argument("-p", "--prompts", nargs="+",
                   default=["what is the text in the picture?", "what is the color of it?"])
    p.add_argument("--verbosity", type=int, default=int(Verbosity.INFO))
    p.add_argument("--seed", type=int, default=1337)
    p.add_argument("--n_ctx", type=int, default=2048)
    p.add_argument("--n_batch", type=int, default=512)
    p.add_argument("--limit", type=int, default=256)
    # the 14 sampling knobs (examples/main.cpp:31-147)
    p.add_argument("--temp", type=float, default=0.8)
    p.add_argument("--top_k", type=int, default=40)
    p.add_argument("--top_p", type=float, default=0.9)
    p.add_argument("--tfs_z", type=float, default=1.0)
    p.add_argument("--typical_p", type=float, default=1.0)
    p.add_argument("--repeat_last_n", type=int, default=64)
    p.add_argument("--repeat_penalty", type=float, default=1.1)
    p.add_argument("--alpha_presence", type=float, default=1.0)
    p.add_argument("--alpha_frequency", type=float, default=1.0)
    p.add_argument("--mirostat", type=int, default=0)
    p.add_argument("--mirostat_tau", type=float, default=5.0)
    p.add_argument("--mirostat_eta", type=float, default=1.0)
    p.add_argument("--penalize_nl", type=int, default=1)
    p.add_argument("--device", default="cuda",
                   help="torch device of the engine (cuda, cuda:N, or cpu when asked for)")
    p.add_argument("--cache-dtype", choices=["auto", "bf16", "f32", "f8"], default="auto",
                   help="KV cache element type (f8 = e4m3); auto = bf16")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel ranks for the decoder, one process each (torchrun)")
    p.add_argument("--smooth-scales", default=None,
                   help="w8a8 smooth-quant scales (python -m minigpt4_tpu_torch.quality "
                   "--save-scales)")
    p.add_argument("--ctx-shift", action="store_true",
                   help="when the chat fills n_ctx, drop the oldest turns after the system "
                   "prompt and image and slide the KV cache instead of stopping")
    p.add_argument("--tokens-out", default=None, metavar="PATH",
                   help="also write the generated pieces one per line here")
    p.add_argument("--warmup", action="store_true",
                   help="capture the engine's CUDA graphs before the session")
    p.add_argument("--speculative-k", type=int, default=0,
                   help="speculative decoding verify width (0 = off): greedy output is "
                   "token-identical; sampled output runs speculative sampling")
    p.add_argument("--draft-llm", default=None, metavar="PATH",
                   help="smaller ggml llama sharing the tokenizer: draft-model speculative "
                   "decoding for greedy generation (token-identical)")
    p.add_argument("--draft-head", default=None, metavar="PATH",
                   help="draft-head artifact (train/draft.py): tiny drafter over the main "
                   "model's embedding for greedy generation (token-identical)")
    return p.parse_args(argv)


def main(argv: list[str] | None = None) -> int:
    args = parse_args(argv)
    t_start = time.perf_counter()
    eng = MiniGPT4Engine(
        args.model, args.llm_model, verbosity=args.verbosity, seed=args.seed,
        n_ctx=args.n_ctx, n_batch=args.n_batch, device=args.device,
        cache_dtype=None if args.cache_dtype == "auto" else args.cache_dtype,
        smooth_scales=args.smooth_scales, context_shift=args.ctx_shift, tp=args.tp,
        speculative_k=args.speculative_k, draft_llm_path=args.draft_llm,
        draft_head_path=args.draft_head)
    try:
        if args.warmup:
            eng.warmup()
        sp = SamplingParams(
            temp=args.temp, top_k=args.top_k, top_p=args.top_p, tfs_z=args.tfs_z,
            typical_p=args.typical_p, repeat_last_n=args.repeat_last_n,
            repeat_penalty=args.repeat_penalty, alpha_presence=args.alpha_presence,
            alpha_frequency=args.alpha_frequency, mirostat=args.mirostat,
            mirostat_tau=args.mirostat_tau, mirostat_eta=args.mirostat_eta,
            penalize_nl=bool(args.penalize_nl))
        emb = eng.encode_image(preprocess(load_image(args.image),
                                          size=eng.vision_cfg.vit.image_size))
        eng.system_prompt()
        out = open(args.tokens_out, "w") if args.tokens_out else contextlib.nullcontext()
        with out as tok_f:
            for i, prompt in enumerate(args.prompts):
                print(f"\n> {prompt}")
                if i == 0:
                    eng.begin_chat_image(emb, prompt)
                else:
                    eng.begin_chat(prompt)
                for tok in eng.generate(limit=args.limit, params=sp):
                    print(tok, end="", flush=True)
                    if tok_f:
                        tok_f.write(tok.replace("\n", "\\n") + "\n")
                print()
                if tok_f:
                    tok_f.write("### end of turn\n")
    finally:
        eng.close()
    print(f"\n[session: {(time.perf_counter() - t_start) * 1e3:.0f} ms]", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
