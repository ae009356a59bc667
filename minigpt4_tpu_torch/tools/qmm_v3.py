"""Round-3 unpack chains, K-major layouts and sub-word op packing: the
Hopper counterpart of the JAX package's ``tools/qmm_v3.py``.

Three entry points, as in the JAX file, each keeping its variant names:

  (default)  nibi4 nibi4i8 nibi4g nibg q5i4 q5u8or q5u8i i8mix2 i8g: the
             chains of ``main`` on the probe kernel
             (``ops/probes.dequant_matvec``);
  km         densekm densenm i8km i8kmns nibkm: K-major ``[K, N]`` weights
             (lanes along N) against N-major ``[N, K]`` (lanes along K);
  i8         q5i8dom q5i8dom2 (q5 over the dual half-planes ``[N, K/4]``)
             and opsi8 / opsi32, the op-packing chains (8 x and + add over
             [N, K] i8 and [N/4, K] i32, ``ops/probes.op_chain``).

The TPU's chunk = G variants (the scale repeat elided) map to the same
Hopper arm as their chunked twins: the probe kernel scales once per
32-code run in every variant.  opsi8 / opsi32 write the op-chain kernel's
block and checksums where the TPU kernels wrote row sums.

Usage (timing, on an NVIDIA GPU):
    python -m minigpt4_tpu_torch.tools.qmm_v3 [km|i8] [--tm 8] [--only ...] [--width 4,16]
Checks only:  python -m minigpt4_tpu_torch.tools.qmm_v3 [km|i8] --device cpu --check-only
"""

from __future__ import annotations

import argparse
import sys

from . import _harness as h
from ._qmm import Arm, run
from .probe_i8ops import run_case

TOOL = "qmm_v3"
_G = "chunk = G lanes (the scale repeat elided): the kernel scales once per 32-code run anyway"
MAIN = {
    "nibi4": Arm("matvec", "i4", "magic", note="int4 -> bf16 in one cast: the f16 build"),
    "nibi4i8": Arm("matvec", "i4", note="int4 -> i8 -> bf16: sign-extend, one integer convert"),
    "nibi4g": Arm("matvec", "i4", "magic", note=_G + "; as nibi4"),
    "nibg": Arm("matvec", "u4", note=_G + "; u4 -> i8 -> bf16 as mask/shift"),
    "q5i4": Arm("matvec", "q5i4"),
    "q5u8or": Arm("matvec", "q5", "magic", note="u8 or-merge, one cast: the hi bit or-ed into "
                  "the f16 mantissa"),
    "q5u8i": Arm("matvec", "q5i4", "magic", note="i8 or-merge over signed nibbles, one cast"),
    "i8mix2": Arm("matvec", "i8", "magic", note="bf16 x i8 dot with the planes loaded: the "
                  "nearest is the i8 codes' f16 build"),
    "i8g": Arm("matvec", "i8", note=_G),
}
KM = {
    "densekm": Arm("matvec", "dense", layout="km"),
    "densenm": Arm("matvec", "dense"),
    "i8km": Arm("matvec", "i8", layout="km"),
    "i8kmns": Arm("matvec", "i8", layout="km", note="without the scale: the kernel scales each "
                  "value once either way, so this is i8km"),
    "nibkm": Arm("matvec", "i4", layout="km", note="int4 -> i8 -> bf16, K-major nibble pairs"),
}
I8 = {
    "q5i8dom": Arm("matvec", "q5d", note="i8-domain merge: integer add of the positioned bit, "
                   "one convert"),
    "q5i8dom2": Arm("matvec", "q5d", "magic", note="u8 and + bitcast merge: the positioned bit "
                    "or-ed into the f16 mantissa"),
}
OPS = {"opsi8": ("i8aa", 1), "opsi32": ("i32aa", 4)}  # (op, row divisor)
OPS_REPS = 8


def main(argv: list[str] | None = None) -> list[dict]:
    argv = list(sys.argv[1:] if argv is None else argv)
    entry = argv.pop(0) if argv and argv[0] in ("km", "i8") else "main"
    if entry == "km":
        return run(TOOL + " km", KM, argv, __doc__, "8")
    if entry == "main":
        return run(TOOL, MAIN, argv, __doc__, "8")
    # "i8": the dual-plane matvecs through the shared runner, then the op chains
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None)
    known, rest = ap.parse_known_args(argv)
    only = h.name_set(known.only)
    out = []
    matvec = [name for name in I8 if only is None or name in only]
    if matvec:
        out += run(TOOL + " i8", I8, rest + ["--only", ",".join(matvec)], __doc__, "8")
    ops = [name for name in OPS if only is None or name in only]
    if ops:
        ap = argparse.ArgumentParser()
        h.add_flags(ap)
        ap.add_argument("--n", type=int, default=5120)
        ap.add_argument("--k", type=int, default=13824)
        args, _ = ap.parse_known_args(rest)
        device = h.setup(args)
        gen = h.generator(device, args.seed)
        for name in ops:
            op, div = OPS[name]
            run_case(TOOL + " i8", op, 256, 256, OPS_REPS, gen, device, False)
            if not args.check_only:
                out.append(run_case(TOOL + " i8", op, args.n // div, args.k, OPS_REPS, gen,
                                    device, True, tpu_variant=name))
    return out


if __name__ == "__main__":
    main()
