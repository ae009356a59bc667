"""Nibble-unpack strategies of the dequantize-matvec at the 13B w2 shape:
the Hopper counterpart of the JAX package's ``tools/unpack_variants.py``.

The JAX file found every nibble strategy as slow as byte codes on the TPU;
here the question is whether any unpack chain or load width lets the
nibbles' fewer bytes pay.  Its variants map to the probe kernel
(``ops/probes.dequant_matvec``): ``q8`` to i8 codes, ``bitcast`` to the
nibbles' f16 build (one step from the packed byte), ``i32pair`` to mask and
shift, and ``twodot`` (two half-tile dots over a row-pair split) to mask
and shift as well: the row-pair layout is TPU-only, the port's nibbles are
K-order.  The TPU tiling knobs (TN, CL) have no counterpart.

Usage (timing, on an NVIDIA GPU):
    python -m minigpt4_tpu_torch.tools.unpack_variants [q8 bitcast ...] [--m 8] [--width 4,16]
Checks only:  python -m minigpt4_tpu_torch.tools.unpack_variants --device cpu --check-only
"""

from __future__ import annotations

import sys

from ._qmm import Arm, run

TOOL = "unpack_variants"
VARIANTS = {
    "q8": Arm("matvec", "i8"),
    "bitcast": Arm("matvec", "u4", "magic", note="bitcast u4 then one cast: the f16 build "
                   "from the packed byte"),
    "i32pair": Arm("matvec", "u4", note="i32 mask/shift of each nibble"),
    "twodot": Arm("matvec", "u4", note="two half-tile dots over the row-pair split: the "
                  "split is TPU layout; the unpack is i32pair's mask/shift"),
}


def main(argv: list[str] | None = None) -> list[dict]:
    """Positional variant names select (as the JAX file's arguments)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    names = []
    while argv and not argv[0].startswith("-"):
        names.append(argv.pop(0))
    if names:
        argv = ["--only", ",".join(names), *argv]
    return run(TOOL, VARIANTS, argv, __doc__, "8")


if __name__ == "__main__":
    main()
