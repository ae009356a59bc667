"""Distill a draft head against a llama.cpp file, then score it.

Counterpart of the JAX package's ``tools/train_bench_draft.py`` in its
``--llm-file`` mode, with its flags and prints, plus ``--device``.  The
teacher is the file's decoder in ``--quant-mode`` (default ``gq``, the
engine's resolution of ``auto``) with the engine's f32 activations, so the
targets are the argmax an engine of that mode computes; its greedy targets
over mixed streams (held-out prose, uniform ids, zipf ids) are computed
first, then the teacher is freed but for its embedding, and the head
(``train/draft.py``) is distilled with AdamW (weight decay 1e-4) under a
linear warmup from 0 and a cosine decay to 0 (optax's
``warmup_cosine_decay_schedule(0, lr, warmup, steps)``; step 0 runs at lr 0).

The evaluation is teacher-forced acceptance on prose the head never saw
(``REALISTIC_TEXT``): at each position past a warm-up, whether the head's
next-token prediction equals the teacher's, walked as the verify rule walks
it (:func:`pass_walk`, k = 8).  The artifact is tagged
``real:<file>@<mode>``; the engine loads it with ``--draft-head``.

    python -m minigpt4_tpu_torch.tools.train_draft --llm-file vicuna.bin \\
        --steps 1200 --out draft_head.npz [--device cpu]

The JAX tool's synthetic-teacher mode (no ``--llm-file``) needs the
benchmark's geometries and synthetic weights, which the port does not have
yet (ROADMAP Queue 1, item 6); without ``--llm-file`` this tool exits 2.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

# Held-out prose (same assistant-describes-an-image register as the eval
# stream, different content and words).
TRAIN_TEXT_A = """
The photograph shows a narrow market street in the early morning, before
the stalls have opened. Wooden crates are stacked against the shutters of
a bakery, and a bicycle with a wicker basket leans on a lamp post near the
curb. The pavement is wet, which suggests it rained during the night, and
the reflections of the shop signs run in long streaks of red and green
across the stones. A cat sits on the lowest step of the bakery entrance,
looking toward the far end of the street where a delivery van is parked
with its rear doors open. There are no customers yet, though a single
figure in an apron is visible inside the bakery window, arranging loaves
on a tray. The light is low and warm, coming from the east, and the upper
floors of the buildings remain in shadow. The sign above the bakery reads
"Fournier et Fils" in gold letters on a dark blue board, and a smaller
card in the window lists the day's bread in handwritten script. If you
mean the awning, the awning is striped in cream and faded rose, and one
of its corners has come loose from the frame. To summarize, the scene is
a quiet street at dawn, centered on the bakery, with the wet pavement
carrying most of the color and the gold lettering of the sign providing
the strongest contrast.
"""
TRAIN_TEXT_B = """
This image is a diagram of a small sailing dinghy viewed from the side,
with each part labeled by a thin line and a number. The hull is drawn in
simple outline and shaded light grey below the waterline. The mast rises
from the center of the boat and carries a single triangular sail, which
is labeled with the number three. The rudder and tiller are at the stern,
labeled five and six, and the centerboard is shown as a dashed shape
beneath the hull, labeled four. The numbers correspond to a legend in the
lower right corner of the diagram, printed in a small sans serif face.
The legend reads: one, hull; two, mast; three, mainsail; four,
centerboard; five, rudder; six, tiller; seven, bow; eight, stern. The
only color in the drawing is a red arrow indicating the direction of the
wind, which points from the upper left toward the sail. The background is
plain white, and a scale bar in the lower left indicates one meter. The
title of it is printed along the top edge and reads "Parts of a Sailing
Dinghy", followed by a small registration mark ending in the letters QS.
"""
# The evaluation stream: ordinary, non-repetitive assistant prose (the JAX
# package's ``benchmark.REALISTIC_TEXT``, copied).
REALISTIC_TEXT = """
The picture shows a small wooden boat resting on a pebble beach at low tide.
The hull is painted in two tones, a faded blue above the waterline and a
dark red below it, and the paint is flaking near the bow. A coiled rope
lies across the front bench, and a single oar leans against the starboard
side. Behind the boat the beach rises toward a line of dune grass, and past
the grass there is a row of low cottages with slate roofs. The sky is
overcast but bright, which softens the shadows and makes the colors of the
hull stand out against the grey stones. There are no people visible in the
frame, though a set of footprints runs from the water to the dunes.
The text in the picture is painted on the bow of the boat. It reads
"Marigold" in white serif letters, followed by a smaller registration mark
that is partly worn away. The first three characters of the mark are legible
and appear to be K, 4, and 7; the rest is too faded to read with
confidence. The name is repeated on a small plaque near the stern, where it
is easier to read because the plaque is sheltered from the weather.
The color of it depends on which part you mean. The upper hull is a faded
blue, close to slate blue, while the lower hull is a dark red that shades
toward brown where the paint has thinned. The interior benches are
unpainted wood, grey from exposure. If you mean the lettering, the
lettering is white with a thin dark outline, and the plaque near the stern
has a brass border that has gone green at the corners. Overall the palette
of the image is muted: grey stones, grey sky, dune grass in pale green,
and the two tones of the hull carrying most of the saturation.
To summarize, the image is a quiet coastal scene centered on a beached
rowing boat named Marigold, with no people present, soft overcast light,
and a limited palette in which the blue and red of the hull are the
strongest colors. The most legible text is the name on the bow, and the
registration mark beginning K47 is only partly readable.
"""
EVAL_PAD = 512  # the eval stream's length, padded (causal: padding is inert)
EVAL_WARM = 48  # positions skipped before agreement counts
K_SPEC = 8


def make_streams(rng, n_tokens: int, vmax: int, word_streams):
    """Mixed training material: prose ids, uniform ids, zipf ids."""
    out = list(word_streams)
    out.append(rng.integers(0, vmax, n_tokens).astype(np.int32))
    z = rng.zipf(1.5, n_tokens)
    out.append(np.clip(z, 0, vmax - 1).astype(np.int32))
    return out


def pass_walk(agree: np.ndarray, k_spec: int) -> float:
    """Tokens per pass from a per-position agreement sequence (the verify
    rule: 1 emitted + consecutive agreements, advance past them)."""
    k_draft = k_spec - 1
    pos, passes, emitted = 0, 0, 0
    n = len(agree)
    while pos < n - k_draft:
        acc = 0
        while acc < k_draft and agree[pos + acc]:
            acc += 1
        emitted += 1 + acc
        passes += 1
        pos += 1 + acc
    return emitted / max(passes, 1)


def warmup_cosine(warmup: int, steps: int):
    """The multiplier of the peak lr at step i, for ``LambdaLR``: optax's
    ``warmup_cosine_decay_schedule(0, peak, warmup, steps)`` over peak."""
    def factor(i: int) -> float:
        if i < warmup:
            return i / warmup
        t = min(i - warmup, steps - warmup) / max(steps - warmup, 1)
        return 0.5 * (1.0 + np.cos(np.pi * t))
    return factor


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=1200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--model", default="13B",
                    help="the synthetic teacher's geometry (needs ROADMAP item 6)")
    # the teacher's numerics must match the engine that will draft with the
    # head (argmax agreement is numerics-sensitive)
    ap.add_argument("--quant-mode", default="gq")
    ap.add_argument("--d-draft", type=int, default=512)
    ap.add_argument("--n-layer", type=int, default=2)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--out", default="build/draft_head.npz")
    ap.add_argument("--teacher-batches", type=int, default=24)
    ap.add_argument("--llm-file", default=None,
                    help="llama.cpp checkpoint to distill against, with its own tokenizer")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if not args.llm_file:
        print("train_draft: the synthetic-teacher mode (no --llm-file) needs the benchmark's "
              "geometries and synthetic weights, not ported yet (ROADMAP Queue 1, item 6); "
              "pass --llm-file", file=sys.stderr)
        return 2

    from ..engine.engine import COMPUTE_DTYPE
    from ..formats import LlamaFileReader
    from ..models import llama as llama_mod
    from ..models.params import resolve_gq_pack
    from ..tokenizer import LlamaTokenizer
    from ..train import draft as D

    dev = torch.device(args.device)
    t0 = time.perf_counter()
    with LlamaFileReader(args.llm_file) as r:
        params, cfg = llama_mod.load_params(r, COMPUTE_DTYPE, n_ctx=EVAL_PAD, device=dev,
                                            quant_mode=args.quant_mode,
                                            pack=resolve_gq_pack(args.quant_mode))
        bpe = LlamaTokenizer(r.vocab.tokens, r.vocab.scores)

    def tok_fn(text):
        return np.asarray(bpe.tokenize(text, add_bos=False), np.int32)

    print(f"[draft-train] teacher built in {time.perf_counter()-t0:.1f}s", flush=True)
    cache_dt = torch.float8_e4m3fn if cfg.n_embd >= 5120 else torch.bfloat16

    # ---- training corpus + teacher targets --------------------------------
    rng = np.random.default_rng(42)
    vmax = cfg.n_vocab
    streams = make_streams(rng, 4096, vmax,
                           [tok_fn(TRAIN_TEXT_A) % vmax, tok_fn(TRAIN_TEXT_B) % vmax])
    flat = np.concatenate(streams)

    def sample_batch():
        rows = []
        for _ in range(args.batch):
            if rng.random() < 0.5:
                i = rng.integers(0, len(flat) - args.seq)
                rows.append(flat[i:i + args.seq])
            else:
                rows.append(rng.integers(0, vmax, args.seq).astype(np.int32))
        return np.stack(rows)

    def tgt_fn(toks: np.ndarray) -> torch.Tensor:
        return D.teacher_targets(params, cfg, torch.from_numpy(toks).to(dev), cache_dtype=cache_dt)

    data = []
    t0 = time.perf_counter()
    for i in range(args.teacher_batches):
        toks = sample_batch()
        data.append((torch.from_numpy(toks).to(dev), tgt_fn(toks)))
        if i == 0:
            print(f"[draft-train] first teacher batch {time.perf_counter()-t0:.1f}s", flush=True)
    print(f"[draft-train] {args.teacher_batches} teacher batches "
          f"({args.teacher_batches*args.batch*args.seq} positions) in "
          f"{time.perf_counter()-t0:.1f}s", flush=True)

    # eval-stream targets now, then free the teacher but for its embedding
    stream = (tok_fn(REALISTIC_TEXT) % vmax)[:EVAL_PAD - 1]
    n_ev = len(stream)
    toks_eval = np.pad(stream, (0, EVAL_PAD - n_ev))[None]
    teacher_pred = tgt_fn(toks_eval)[0, :n_ev].cpu().numpy()
    emb32 = params["tok_embeddings"].float()
    del params

    # ---- distill -----------------------------------------------------------
    dhc = D.DraftHeadConfig(d_draft=args.d_draft, n_layer=args.n_layer,
                            n_head=args.d_draft // 64, n_ff=args.d_draft * 11 // 4)
    dcfg = dhc.llama_cfg(cfg.n_vocab, args.seq)
    art = D.init_draft_head(torch.Generator(device=dev).manual_seed(1), cfg.n_embd, dhc)
    leaves = [t.requires_grad_() for t in D.art_leaves(art)]
    warmup = min(50, max(1, args.steps // 4))  # short dry-runs need < 50
    opt = torch.optim.AdamW(leaves, lr=args.lr, weight_decay=1e-4)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, warmup_cosine(warmup, args.steps))
    step = D.make_distill_step(dcfg, opt)
    t0 = time.perf_counter()
    for i in range(args.steps):
        toks, tgts = data[i % len(data)]
        art, loss, acc = step(art, emb32, toks, tgts, 8)
        sched.step()
        if i % 100 == 0 or i == args.steps - 1:
            print(f"[draft-train] step {i}: loss {float(loss):.3f} "
                  f"agree {float(acc):.3f} ({time.perf_counter()-t0:.0f}s)", flush=True)

    # ---- eval: teacher-forced acceptance on held-out prose ------------------
    dcfg_eval = dhc.llama_cfg(cfg.n_vocab, EVAL_PAD)
    with torch.no_grad():
        dparams = D.assemble_draft(emb32, art, torch.float32)
        dcache = llama_mod.init_cache(dcfg_eval, 1, torch.float32, dev)
        demb = llama_mod.embed_tokens(dparams, torch.from_numpy(toks_eval).to(dev))
        dlogits = llama_mod.forward(dparams, dcache, demb, 0, dcfg_eval, all_logits=True,
                                    use_flash=False)
    draft_pred = dlogits[0].argmax(dim=-1)[:n_ev].cpu().numpy()
    agree = (draft_pred == teacher_pred)[EVAL_WARM:-1]
    acc_pp = pass_walk(agree, k_spec=K_SPEC)
    print(f"[draft-train] EVAL on REALISTIC_TEXT: per-position agreement "
          f"{agree.mean():.3f}, teacher-forced acceptance {acc_pp:.2f}/pass "
          f"(k={K_SPEC}; n-gram floor is ~1.04)", flush=True)

    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    tag = f"real:{Path(args.llm_file).name}@{args.quant_mode}"
    D.save_artifact(args.out, art, dhc, teacher_mode=tag)
    print(f"[draft-train] saved {args.out} (teacher {tag})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
