"""Same-call shootout at the 13B w2 shape (N = 5120, K = 13824): the port's
production repacked kernels against the candidate unpack chains, the Hopper
counterpart of the JAX package's ``tools/qmm_r3.py``.

``prodq5`` / ``prodq4`` are ``rq_decode`` (``csrc/rq_matmul.cu``) on
repacked random q5_k / q4_k bytes; ``densenm`` the probe kernel on bf16
weights; ``xladense`` one ``torch.matmul`` on bf16 (the library yardstick,
as XLA's dense matvec was the JAX file's); the rest the probe kernel
(``ops/probes.dequant_matvec``) on the named storage.  Every arm runs at
each M of ``--m`` (the JAX file ran its candidates at TM = 8 and the
production kernels at ``--m``).

Usage (timing, on an NVIDIA GPU):
    python -m minigpt4_tpu_torch.tools.qmm_r3 [--m 1] [--only prodq5,nibi4]
Checks only:  python -m minigpt4_tpu_torch.tools.qmm_r3 --device cpu --check-only
"""

from __future__ import annotations

import sys

from ._qmm import Arm, run

TOOL = "qmm_r3"
VARIANTS = {
    "prodq5": Arm("prod", "q5_k"),
    "prodq4": Arm("prod", "q4_k"),
    "densenm": Arm("matvec", "dense"),
    "xladense": Arm("library", "matmul"),
    "nibi4": Arm("matvec", "i4", "magic", note="int4 -> bf16 in one cast: the f16 build of "
                 "signed nibbles"),
    "q5i4": Arm("matvec", "q5i4"),
    "q5u8or": Arm("matvec", "q5", "magic", note="or-merge of the hi bit, one cast: the hi bit "
                  "or-ed into the f16 mantissa"),
    "q5i8dom": Arm("matvec", "q5d", note="integer-domain merge over the dual half-planes"),
    "i8g": Arm("matvec", "i8", note="chunk = G lanes: the scale applies once per 32-code run "
               "on Hopper"),
}


def main(argv: list[str] | None = None) -> list[dict]:
    return run(TOOL, VARIANTS, argv, __doc__, "1")


if __name__ == "__main__":
    main(sys.argv[1:])
