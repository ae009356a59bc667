"""Can the H100 consume int4 weight codes natively?  The Hopper counterpart
of the JAX package's ``tools/probe_int4.py``, at its shape (the 13B w2 as
n = 13824, k = 5120, M = 1).

Arms (``ops/probes.int_dot``, ``csrc/probe_int.cu``):

  i8xi8  i8 x i8 -> i32 with ``__dp4a`` (the w8a8 traffic reference);
  s4xs4  s4 x s4 -> i32 with ``mma.sync.aligned.m16n8k64...s4.s4.s32``
         (half the weight bytes);
  s4_sb  s4 codes x i8 activations, the exact i32 of each 256-wide chunk
         times an f32 scale, summed in f32: what a w4a8 path needs.

The JAX probe's arm D asked whether Mosaic accepts an int4 operand at all;
here the question is what ptxas makes of the s4 ``mma.sync`` for sm_90a,
and the tool answers it from the built library's SASS (``cuobjdump``): the
line ``{"mma_s4_sm90a": ...}`` lists the tensor-core instructions of the s4
kernel.  Timing and the SASS need an NVIDIA GPU and the CUDA toolkit.

Usage:  python -m minigpt4_tpu_torch.tools.probe_int4 [--m 1] [--only s4xs4]
Checks only:  python -m minigpt4_tpu_torch.tools.probe_int4 --device cpu --check-only
"""

from __future__ import annotations

import argparse
import json
import re
import sys

import torch

from ..ops import probes
from . import _harness as h

TOOL = "probe_int4"
MODES = tuple(probes.INT_MODES)
CHECK = ((256, 512, 1), (200, 1024, 8), (64, 512, 16))  # (n, k, m); M = 16 only for s4xs4
TOL = 1e-4  # s4_sb: f32 products and sums (the integer modes must be bit-equal)


def operands(mode: str, n: int, k: int, m: int, gen: torch.Generator, device):
    """(x, w, scales): i8 in -127..126, int4 nibble bytes uniform, scales in
    [0.5, 1.5) x 2^-13."""
    def i8(rows: int) -> torch.Tensor:
        return torch.randint(-127, 127, (rows, k), generator=gen, device=device, dtype=torch.int8)

    def s4(rows: int) -> torch.Tensor:
        return torch.randint(0, 256, (rows, k // 2), generator=gen, device=device,
                             dtype=torch.uint8)

    if mode == "i8xi8":
        return i8(m), i8(n), None
    if mode == "s4xs4":
        return s4(m), s4(n), None
    scales = 2.0 ** -13 * (0.5 + torch.rand((n, k // probes.SB), generator=gen, device=device))
    return i8(m), s4(n), scales


def run_mode(mode: str, n: int, k: int, m: int, gen, device, timed: bool) -> dict:
    x, w, scales = operands(mode, n, k, m, gen, device)
    got, want = probes.int_dot(x, w, scales, mode), probes.int_dot_ref(x, w, scales, mode)
    res = {"max_abs_err": float((got.double() - want.double()).abs().max()),
           "bit_equal": bool(torch.equal(got, want))}
    if mode == "s4_sb":
        res["max_rel_err"], res["tol"] = h.rel_err(got, want), TOL
        h.hold(f"int_dot {mode} M={m}", res["max_rel_err"], TOL)
    elif not res["bit_equal"]:
        raise AssertionError(f"int_dot {mode} M={m}: not bit-equal to the exact integers "
                             f"(max |d| {res['max_abs_err']})")
    else:
        res["max_rel_err"], res["tol"] = 0.0, 0.0
    if not timed:
        return res
    rot = h.rotation((w, scales), h.nbytes(w, scales))
    res["ms"] = h.time_ms(lambda wv, sv: probes.int_dot(x, wv, sv, mode), lambda i: rot[i],
                          len(rot))
    res["plain_ms"] = h.time_ms(lambda wv, sv: probes.int_dot_ref(x, wv, sv, mode),
                                lambda i: rot[i], len(rot), replays=1)
    res["library_ms"] = None
    if mode == "i8xi8" and m > 16:  # torch._int_mm refuses M <= 16
        mats = [wv.t() for wv, _ in rot]
        res["library_ms"] = h.time_ms(lambda wt: torch._int_mm(x, wt), lambda i: (mats[i],),
                                      len(mats))
    res["bytes"] = h.nbytes(x, w, scales) + 4 * m * n
    res["bound_ms"], res["bound_by"] = h.bound(res["bytes"], 2.0 * m * n * k, h.INT8_OPS)
    return res


def sass_s4() -> dict:
    """The tensor-core instructions ptxas emitted for the s4 kernel, read
    from the built library with cuobjdump: {opcode: count}."""
    return {op: n for op, n in h.sass_opcodes("s4_mma_kernel").items()
            if re.match(r"[IH]MMA", op)}


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    h.add_flags(ap)
    ap.add_argument("--n", type=int, default=13824)
    ap.add_argument("--k", type=int, default=5120)
    ap.add_argument("--m", default="1", help="row counts, comma-separated (default 1)")
    ap.add_argument("--only", default=None, help=f"modes, comma-separated, of {','.join(MODES)}")
    ap.add_argument("--no-sass", action="store_true",
                    help="skip reading the s4 kernel's SASS (cuobjdump over the whole library)")
    args = ap.parse_args(argv)
    device = h.setup(args)
    only = h.name_set(args.only)
    modes = [md for md in MODES if only is None or md in only]
    gen = h.generator(device, args.seed)
    out = []
    for n, k, m in CHECK:
        for mode in modes:
            if m > probes.MAX_M and mode != "s4xs4":
                continue
            res = run_mode(mode, n, k, m, gen, device, False)
            print(json.dumps({"tool": TOOL, "check": f"{mode} n={n} k={k} m={m}", **res,
                              "card": h.card(device)}), flush=True)
    if args.check_only:
        return out
    for m in h.int_list(args.m):
        for mode in modes:
            res = run_mode(mode, args.n, args.k, m, gen, device, True)
            out.append(h.record(TOOL, mode, device, m=m, elems=args.n * args.k,
                                n_bytes=res.pop("bytes"), ms=res.pop("ms"),
                                bound_ms=res.pop("bound_ms"), bound_by=res.pop("bound_by"),
                                tpu_variant=mode, kernel="int_dot", shape=f"{args.n}x{args.k} M={m}",
                                **res))
    if args.no_sass:
        return out
    sass = sass_s4()
    print(json.dumps({"tool": TOOL, "mma_s4_sm90a": "accepted by ptxas" if sass else "absent",
                      "s4_kernel_tensor_ops": sass, "card": h.card(device)}), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
