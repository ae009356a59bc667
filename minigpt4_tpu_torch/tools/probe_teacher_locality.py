"""Probe: how learnable is the benchmark teacher's next-token function?

Counterpart of the JAX package's ``tools/probe_teacher_locality.py``, with
its flags plus ``--device``.  Before a draft head is distilled against the
synthetic 13B teacher (``benchmark.synth_llama_params``), measure how far
its teacher-forced greedy prediction on prose depends on the recent tokens
alone: a drafter's achievable agreement is the locality of that map.

For every third position p past a warm-up of 32 in the word-tokenized
``benchmark.REALISTIC_TEXT``, compare the argmax of the logits at p - 1 of
one full-stream forward (``all_logits``) with the argmax after only the
window ``stream[p - w:p]``, for each w of ``--windows``: one batched forward
of every position's window (about 115 lanes of S = w rows: flash decode
over that many lanes, prefill-kernel matmuls at M = lanes x w).  The cache
is e4m3 at 13B and bf16 otherwise.  A window's batch holds only its w
positions (the JAX tool allocates each lane the whole n_ctx, which at 13B
would be ~96 GB); the flash kernel reads a lane's live keys only, so the
logits do not depend on it.  Activations are the engine's f32.

    python -m minigpt4_tpu_torch.tools.probe_teacher_locality --model 13B
    python -m minigpt4_tpu_torch.tools.probe_teacher_locality --model tiny --device cpu

Prints one ``[locality]`` line per window (with the distinct predictions of
the windows and of the full context: a teacher whose short contexts all
map to a few ids shows there), then one JSON line: ``model``,
``positions``, ``w<w>`` (the agreement per window), ``device``.  :func:`run`
takes a teacher its caller already built.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np
import torch

WARM = 32  # positions skipped before agreement counts
EVERY = 3  # every third position: cheap


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="13B")
    ap.add_argument("--quant-mode", default="gq")
    ap.add_argument("--windows", default="1,2,4,8,16")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


@torch.no_grad()
def run(params: dict, cfg, args: argparse.Namespace) -> dict:
    """The agreement per window of the teacher ``params`` of ``cfg`` already
    on ``args.device`` (``args.model`` names the geometry: 13B takes the
    e4m3 cache).  Returns the JSON line's dict."""
    from .. import benchmark as B
    from ..models import llama as llama_mod
    from ..ops.flash_decode import KEY_TILE
    from ._harness import card

    dev = torch.device(args.device)
    stream = B.word_tokenize(B.REALISTIC_TEXT)
    positions = np.arange(WARM, len(stream) - 1, EVERY)
    cache_dt = torch.float8_e4m3fn if args.model == "13B" else torch.bfloat16

    # the full-context predictions: one forward of the whole stream
    cache = llama_mod.init_cache(cfg, 1, cache_dt, dev)
    emb = llama_mod.embed_tokens(params, torch.from_numpy(stream[None]).long().to(dev))
    logits_all = llama_mod.forward(params, cache, emb, 0, cfg, all_logits=True)
    full_pred = logits_all[0].argmax(dim=-1).cpu().numpy()  # [T] the next token's
    del cache, emb, logits_all
    n_full = len(np.unique(full_pred[positions - 1]))

    res = {}
    for w in (int(x) for x in args.windows.split(",")):
        toks = torch.from_numpy(np.stack([stream[p - w:p] for p in positions])).long().to(dev)
        wcfg = dataclasses.replace(cfg, n_ctx=-(-w // KEY_TILE) * KEY_TILE)
        cache = llama_mod.init_cache(wcfg, len(positions), cache_dt, dev)
        lw = llama_mod.forward(params, cache, llama_mod.embed_tokens(params, toks), 0, wcfg)
        preds = lw.argmax(dim=-1).cpu().numpy()
        del cache, lw
        agree = float(np.mean(preds == full_pred[positions - 1]))
        res[f"w{w}"] = agree
        print(f"[locality] window {w}: agreement {agree:.3f} ({len(np.unique(preds))} distinct "
              f"predictions; the full context's {n_full})", flush=True)
    out = {"model": args.model, "positions": len(positions), **res, "device": card(dev)}
    print(json.dumps(out), flush=True)
    return out


def main(argv=None) -> int:
    from ._harness import synth_decoder

    args = parse_args(argv)
    run(*synth_decoder(args.model, args.quant_mode, args.device), args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
