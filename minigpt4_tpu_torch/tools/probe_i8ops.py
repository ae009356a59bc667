"""What sub-word arithmetic costs on the H100: chains of elementwise ops
over a [5120, 13824] tensor, the Hopper counterpart of the JAX package's
``tools/probe_i8ops.py``.

Each case applies REPS ops to every element (``ops/probes.op_chain``,
``csrc/probe_ops.cu``): the i8 / u8 forms on 4 packed bytes per 32-bit
word (lop3, ``__vadd4``, a multiply by shifts and masks), i32 on one
element per word, bf16 on two (``__hadd2``, ``__hmul2``); each 256-row
tile writes the probe's [8, 128] block and a checksum of every result.  At
REPS = 8 the chains hide under the device-memory bound; ``--reps 8,64``
(the default) times both, and the summary line of each case gives the
slope, the device time of one op on one element.

Usage:  python -m minigpt4_tpu_torch.tools.probe_i8ops [i8aa,i32aa] [--reps 8,64]
Checks only:  python -m minigpt4_tpu_torch.tools.probe_i8ops --device cpu --check-only
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from ..ops import probes
from . import _harness as h

TOOL = "probe_i8ops"
CASES = {"i8aa": "i8 and+add chain", "u8and": "u8 and chain", "i8mul": "i8 mul chain",
         "i8add": "i8 add chain", "i32aa": "i32 and+add chain", "bf16add": "bf16 add chain",
         "bf16mul": "bf16 mul chain", "c8": "i8->bf16 cast x8", "c32": "i32->bf16 cast x8"}
CHECK_SHAPE = (512, 256)


def make_input(op: str, rows: int, cols: int, gen: torch.Generator, device) -> torch.Tensor:
    """The JAX probe's inputs: i8 and i32 in -100..99, u8 in 0..199, bf16 N(0, 1)."""
    dtype = probes.OPS[op][1]
    if dtype == torch.bfloat16:
        return torch.randn((rows, cols), generator=gen, device=device).to(torch.bfloat16)
    lo, hi = (0, 200) if dtype == torch.uint8 else (-100, 100)
    return torch.randint(lo, hi, (rows, cols), generator=gen, device=device, dtype=dtype)


def run_case(tool: str, op: str, rows: int, cols: int, reps: int, gen, device, timed: bool,
             tpu_variant: str | None = None) -> dict:
    """The chain against its plain version (bit-equal block and checksums),
    then, if ``timed``, its time, plain time and bound."""
    inp = make_input(op, rows, cols, gen, device)
    out, cks = probes.op_chain(inp, op, reps)
    ref_out, ref_cks = probes.op_chain_ref(inp, op, reps)
    equal = bool(torch.equal(out, ref_out) and torch.equal(cks, ref_cks))
    res = {"max_abs_err": float((out - ref_out).abs().max()), "bit_equal": equal}
    if not equal:
        raise AssertionError(f"op_chain {op} reps={reps} [{rows}, {cols}]: not bit-equal to "
                             f"its plain version (block max |d| {res['max_abs_err']}, checksums "
                             f"{cks[:4].tolist()} against {ref_cks[:4].tolist()})")
    if not timed:
        return res
    rot = h.rotation((inp,), h.nbytes(inp))
    k_ms = h.time_ms(lambda t: probes.op_chain(t, op, reps, widen=False), lambda i: rot[i],
                     len(rot))
    p_ms = h.time_ms(lambda t: probes.op_chain_ref(t, op, reps), lambda i: rot[i], len(rot),
                     replays=1)
    n_bytes = h.nbytes(inp, out) + 4 * cks.numel()
    elems = rows * cols
    b_ms, b_by = h.bound(n_bytes, float(elems) * reps, h.F32_FLOPS)
    return h.record(tool, f"{op} reps={reps}", device, m=0, elems=elems, n_bytes=n_bytes,
                    ms=k_ms, bound_ms=b_ms, bound_by=b_by, tpu_variant=tpu_variant or op,
                    kernel="op_chain",
                    op=op, reps=reps, shape=f"{rows}x{cols}", gop_s=elems * reps / k_ms / 1e6,
                    plain_ms=p_ms, library_ms=None, **res)


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    h.add_flags(ap)
    ap.add_argument("only", nargs="?", default=None,
                    help=f"cases, comma-separated, of {','.join(CASES)}")
    ap.add_argument("--n", type=int, default=5120)
    ap.add_argument("--k", type=int, default=13824)
    ap.add_argument("--reps", default="8,64", help="chain lengths, comma-separated")
    args = ap.parse_args(argv)
    device = h.setup(args)
    only = h.name_set(args.only)
    cases = [c for c in CASES if only is None or c in only]
    reps = h.int_list(args.reps)
    gen = h.generator(device, args.seed)
    for op in cases:
        for r in sorted(set(reps) | {8}):
            res = run_case(TOOL, op, *CHECK_SHAPE, r, gen, device, False)
            print(json.dumps({"tool": TOOL, "check": f"{op} reps={r} {CHECK_SHAPE}", **res,
                              "card": h.card(device)}), flush=True)
    if args.check_only:
        return []
    out = []
    for op in cases:
        recs = [run_case(TOOL, op, args.n, args.k, r, gen, device, True)
                for r in reps]
        out += recs
        if len(recs) > 1:
            a, b = recs[0], recs[-1]
            ps = (b["ms"] - a["ms"]) * 1e9 / ((b["reps"] - a["reps"]) * args.n * args.k)
            print(json.dumps({"tool": TOOL, "case": op, "what": CASES[op],
                              "ps_per_op_element": ps, "reps": [a["reps"], b["reps"]],
                              "card": h.card(device)}), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
