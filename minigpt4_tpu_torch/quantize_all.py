"""Quantize a container into every quant type (reference quantize_all.py:
emits all types except F32/I32/L64).

The port's own copy of ``minigpt4_tpu/quantize_all.py`` over the port's
``quantize.quantize_model`` (byte-equal files under the same names).

CLI:  python -m minigpt4_tpu_torch.quantize_all model-f16.bin outdir/
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from .formats import DataType
from .quantize import quantize_model

SKIP = {DataType.F32, DataType.I32, DataType.L64, DataType.F16, DataType.Q8_K, DataType.Q8_1}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("in_path")
    ap.add_argument("out_dir")
    args = ap.parse_args(argv)
    in_path = Path(args.in_path)
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    stem = in_path.stem
    for base in ("f16", "f32"):
        if stem.endswith(f"-{base}"):
            stem = stem[: -len(base) - 1]
    rc = 0
    for t in DataType:
        if t in SKIP:
            continue
        out = out_dir / f"{stem}-{t.name.lower()}.bin"
        print(f"quantizing -> {out}")
        rc |= quantize_model(str(in_path), str(out), t)
    return rc


if __name__ == "__main__":
    sys.exit(main())
