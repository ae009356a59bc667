"""Can the H100 consume int4 weight codes natively?  The Hopper counterpart
of the JAX package's ``tools/probe_int4.py``, at its shape (the 13B w2 as
n = 13824, k = 5120, M = 1).

Arms (``ops/probes.int_dot``, ``csrc/probe_int.cu``), every one on
``mma.sync`` m16n8k32 s8 (IMMA.16832.S8.S8) over a streaming ring:

  i8xi8  i8 x i8 -> i32 (the w8a8 traffic reference);
  s4xs4  s4 x s4 -> i32, both operands unpacked to s8 in registers (the
         weight's as 16 times its codes) (half the weight bytes);
  s4_sb  s4 codes x i8 activations, the exact i32 of each 256-wide chunk
         times an f32 scale, summed in f32 in chunk order: what a w4a8 path
         needs.

The JAX probe's arm D asked whether Mosaic accepts an int4 operand at all.
Here the question was what ptxas makes of an s4 ``mma.sync`` for sm_90a;
the first form of this kernel issued ``mma.sync ... m16n8k64 .s4.s4``
and its SASS answered it: the card has no int4 tensor-core instruction, and
ptxas lowers each to two IMMA.16832.S8.S8 after its own unpack.  So the
kernel now unpacks the codes itself, and the line
``{"mma_s4_sm90a": ..., "s4_kernel_tensor_ops": ...}`` lists the
tensor-core opcodes of its s4xs4 instances (``cuobjdump``).  The library
yardstick for i8xi8 is ``torch._int_mm``, which refuses M <= 16: below
that it runs on x padded with zero rows to the smallest M it takes
(``library_m``).  Timing and the SASS need an NVIDIA GPU and the CUDA
toolkit.

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
    res["library_ms"] = res["library_m"] = None
    if mode == "i8xi8":
        res["library_m"], res["library_ms"] = library_int_mm(x, [wv for wv, _ in rot])
    res["bytes"] = h.nbytes(x, w, scales) + 4 * m * n
    ops = float(probes.MMA_OPS * probes.ring_mmas(n, k, m, "int_dot", mode))
    res["bound_ms"], res["bound_by"] = h.bound(res["bytes"], ops, h.INT8_OPS)
    res["ops_bound_ms"] = ops / h.INT8_OPS * 1e3
    return res


def library_int_mm(x: torch.Tensor, ws: list) -> tuple[int, float]:
    """(rows, ms) of ``torch._int_mm`` on x over the weight copies ``ws``;
    x padded with zero rows to the smallest row count it accepts (more than
    16) where it has fewer.  Timed only: the port never calls it."""
    mats = [wv.t() for wv in ws]
    for rows in range(max(x.shape[0], 17), 65):
        xp = torch.zeros((rows, x.shape[1]), dtype=x.dtype, device=x.device)
        xp[:x.shape[0]] = x
        try:
            torch._int_mm(xp, mats[0])
        except RuntimeError:
            continue
        return rows, h.time_ms(lambda wt: torch._int_mm(xp, wt), lambda i: (mats[i],), len(mats))
    raise RuntimeError("torch._int_mm accepted no row count up to 64")


S4_KERNEL = "int_dot_kernelILi1E"  # the mangled name of int_dot_kernel<1 (s4xs4), MT>


def sass_s4() -> dict:
    """The tensor-core instructions ptxas emitted for the s4xs4 instances
    of the int kernel, read from the built library with cuobjdump:
    {opcode: count}."""
    return {op: n for op, n in h.sass_opcodes(S4_KERNEL).items() if re.match(r"[IH]MMA", op)}


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
    print(json.dumps({"tool": TOOL, "mma_s4_sm90a": ", ".join(sorted(sass)) or "absent",
                      "s4_kernel_tensor_ops": sass, "card": h.card(device)}), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
