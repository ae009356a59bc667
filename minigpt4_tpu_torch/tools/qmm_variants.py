"""Unpack-chain variants of the dequantize-matvec at the 13B w2 shape: the
Hopper counterpart of the JAX package's ``tools/qmm_variants.py``.

Every TPU variant keeps its name and maps to the nearest configuration of
the probe kernel (``ops/probes.dequant_matvec``, ``csrc/probe_qmm.cu``):
code storage, unpack strategy (``shift``: mask and shift, one
int-to-float convert per code; ``magic``: two f16 per 32-bit word by
exponent bias), load width and layout; ``VARIANTS`` says why where a TPU
variant differs only in TPU operations.  The K-order nibbles of the port
stand for the TPU's row-pair nibbles (not ported).  ``i8dot`` maps to the
integer dot of ``probe_int4`` (i8 x i8 -> i32).

Usage (timing, on an NVIDIA GPU):
    python -m minigpt4_tpu_torch.tools.qmm_variants [--tm 8] [--only i8,nib] [--width 4,16]
Checks only (``--device cpu``: the plain version against the f64 formula):
    python -m minigpt4_tpu_torch.tools.qmm_variants --device cpu --check-only
"""

from __future__ import annotations

import sys

from ._qmm import Arm, run

TOOL = "qmm_variants"
_SAME_I8 = "the scale applies once per 32-code run on Hopper, so this is the i8 arm"
VARIANTS = {
    "dense": Arm("matvec", "dense"),
    "i8": Arm("matvec", "i8"),
    "i8nomul": Arm("matvec", "i8", note=_SAME_I8 + " (no per-code scale multiply either way)"),
    "nib": Arm("matvec", "u4", note="u4 -> i8 -> bf16 casts: one integer convert per code"),
    "nibdirect": Arm("matvec", "u4", "magic", note="u4 -> bf16 in one step: the f16 "
                     "exponent-bias build"),
    "q5cur": Arm("matvec", "q5"),
    "q5cmp": Arm("matvec", "q5", note="and + compare + select of the hi bit: integer bit "
                 "extraction, as shift"),
    "q5two": Arm("matvec", "q5", note="select(q + 16, q): integer bit extraction, as shift"),
    "i8dot": Arm("int", "i8xi8", note="the raw i8 x i8 -> i32 dot, __dp4a"),
    "i8mixed": Arm("matvec", "i8", "magic", note="bf16 x i8 dot without a convert: the "
                   "nearest is the i8 codes' f16 build"),
    "i8swap": Arm("matvec", "i8", note="weights as the MXU's left operand: an operand role "
                  "Hopper's CUDA cores do not have; " + _SAME_I8),
    "i8acc2": Arm("matvec", "i8", note="two MXU accumulators: every lane keeps 4 x M "
                  "accumulators anyway; " + _SAME_I8),
    "i8whole": Arm("matvec", "i8", note="one whole-K dot: the kernel walks K in one loop; "
                   + _SAME_I8),
    "q5and": Arm("matvec", "q5", "magic", note="and + constant multiply instead of a shift: "
                 "the hi bit lands in the mantissa by and/or, as magic"),
    "q5hoist": Arm("matvec", "q5", note="the i32 widen hoisted: the plane bytes sit in "
                   "registers once per run on Hopper"),
    "q5i16": Arm("matvec", "q5", note="i16 shifts: Hopper shifts 32-bit words"),
    "q5nib": Arm("matvec", "q5d", note="hi plane as 4 fields per nibble (2 bits per code of "
                 "plane): the dual half-plane layout, 2 bits per code, signed nibbles"),
}


def main(argv: list[str] | None = None) -> list[dict]:
    return run(TOOL, VARIANTS, argv, __doc__, "8")


if __name__ == "__main__":
    main(sys.argv[1:])
