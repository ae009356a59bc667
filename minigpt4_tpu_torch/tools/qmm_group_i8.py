"""Exact-q5_k matmul with i8 codes on the integer units, against the port's
production decode kernels: the Hopper counterpart of the JAX package's
``tools/qmm_group_i8.py``.

The codes are the raw 5-bit q (0..31) as i8 [N, K]; the per-32-group
scale and bias planes bf16 [G, N]; the activations a dual-i8 split
``x ~= s1 x1 + s2 x2`` (s2 = s1 / 128), so each group's two dot products
are exact i32 (``ops/probes.probe_group_i8``, ``csrc/probe_group_i8.cu``:
the group dots on the s8 tensor cores, the weight streamed through a
shared-memory ring).  Its bound is the larger of the bytes and the MMAs the
launch issues, padding included, at the int8 peak (``ops_bound_ms``).
The question it answered on the H100: should a ``__dp4a`` kernel replace
the f32-FMA gq decode kernel, above all at M = 8?  The production decode
kernels now compute this function (``csrc/gq_decode_i8.cuh``), and the
probe is their yardstick.  Arms, at the five 13B decode shapes
(``SHAPES``) and each M of ``--m``:

  gi8   the probe kernel, on x split beforehand (the split is not timed);
  gq    the port's gq decode kernel (``gq_decode_generic``) on the same
        codes and bf16 planes: the dual-i8 production kernel, the split of
        x inside its launch and timed;
  q5k   ``rq_decode`` on repacked random q5_k bytes (the production
        kernel of repacked weights);
  q6k   the same on q6_k bytes (the Q5_K_M file's output, wv and w2);
  w8a8  the whole M <= 8 w8a8 matmul, ``qmatmul_i8sb`` from f32 x (the
        activation quantization, the i8 contraction over per-256 scales and
        the row scale) on i8 codes.

Every arm calls only entry points whose signature has not changed since
the arms were written, so the tool also times an older tree's kernels
when copied into it.

Usage (timing, on an NVIDIA GPU):
    python -m minigpt4_tpu_torch.tools.qmm_group_i8 [--m 1,8] [--only gi8,gq]
Checks only (the kernel against the f64 dequant reference at check()'s
shapes; with ``--device cpu`` the plain version):
    python -m minigpt4_tpu_torch.tools.qmm_group_i8 --device cpu --check-only
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from ..formats import DataType
from ..ops import group_i8 as gq
from ..ops import i8_matmul as i8
from ..ops import pallas_quant_matmul as rq
from ..ops import probes
from ..ops import repack as rp
from . import _harness as h
from ._qmm import kquant_bytes

TOOL = "qmm_group_i8"
GS = probes.GS
SHAPES = {  # 13B decode matmuls (fused, as models/llama.py issues them)
    "w2": (5120, 13824),
    "w13": (27648, 5120),
    "wqkv": (15360, 5120),
    "wo": (5120, 5120),
    "output": (32000, 5120),
}
ARMS = ("gi8", "gq", "q5k", "q6k", "w8a8")
CHECK_SHAPES = ((256, 512, 1), (512, 1024, 3), (384, 768, 8))
CHECK_TOL = 3e-4  # against the f64 dequant reference (the JAX probe's check)
PLAIN_TOL = 1e-4  # the kernel against its plain version: f32 sums in another order
GQ_TOL, RQ_TOL, I8_TOL = 1e-5, 1e-5, 1e-5  # the production kernels' own tolerances


def make_planes(gen: torch.Generator, n: int, k: int, device, stacked_l: int | None = None):
    """Random exact-q5_k-style planes: q in [0, 31], scales, biases (-mins),
    as the JAX probe draws them."""
    lead = () if stacked_l is None else (stacked_l,)
    g = k // GS
    codes = torch.randint(0, 32, (*lead, n, k), generator=gen, device=device, dtype=torch.int8)
    sct = (torch.rand((*lead, g, n), generator=gen, device=device) * 0.02 + 0.001).to(
        torch.bfloat16)
    mnt = (torch.rand((*lead, g, n), generator=gen, device=device) * 0.1).to(torch.bfloat16)
    return codes, sct, -mnt


def dequant_ref_f64(x: torch.Tensor, codes, sct, bt, layer=None) -> torch.Tensor:
    """x @ (sc q + bt).T in f64 (the claim under test is the kernel's own
    arithmetic, as in the JAX probe's check)."""
    return x.double() @ probes.dequant_group_i8(codes, sct, bt, layer).double().t()


def check(device: torch.device, seed: int) -> list[dict]:
    """The kernel (the plain version on the CPU) against the f64 dequant
    reference at the JAX probe's check shapes, and on a stacked weight."""
    gen = h.generator(device, seed)
    out = []
    for n, k, m in CHECK_SHAPES + ((384, 768, 8),):
        stacked = len(out) == len(CHECK_SHAPES)
        codes, sct, bt = make_planes(gen, n, k, device, 3 if stacked else None)
        layer = 2 if stacked else None
        x = torch.randn((m, k), generator=gen, device=device)
        y = probes.qmatmul_group_i8(x, codes, sct, bt, layer)
        err = h.rel_err(y, dequant_ref_f64(x, codes, sct, bt, layer))
        h.hold(f"{TOOL} check n={n} k={k} m={m}", err, CHECK_TOL)
        rec = {"tool": TOOL, "check": f"n={n} k={k} m={m}{' stacked' if stacked else ''}",
               "rel_err_f64": err, "tol": CHECK_TOL, "card": h.card(device)}
        if device.type == "cuda":
            x1, x2, s1, s2 = probes.split_activations(x)
            plain = probes.group_i8_ref(x1, x2, torch.cat([s1, s2], 1), probes.group_sums(x),
                                        codes, sct, bt, layer)
            rec["rel_err_plain"] = h.rel_err(y, plain)
            h.hold(f"{TOOL} check n={n} k={k} m={m} against the plain version",
                   rec["rel_err_plain"], PLAIN_TOL)
        print(json.dumps(rec), flush=True)
        out.append(rec)
    return out


def _arm(name: str, n: int, k: int, m: int, device, gen, planes, x, seed: int):
    """(kernel, plain version, argument tuples over the weight copies, bytes moved,
    tolerance, operations, their peak rate) of one arm"""
    codes, sct, bt = planes
    if name == "gi8":
        x1, x2, s1, s2 = probes.split_activations(x)
        s12, sgt = torch.cat([s1, s2], 1), probes.group_sums(x)
        rot = h.rotation((codes, sct, bt), h.nbytes(codes, sct, bt))
        args = [(x1, x2, s12, sgt, *r) for r in rot]
        return (probes.probe_group_i8, probes.group_i8_ref, args,
                h.nbytes(codes, sct, bt, x1, x2, s12, sgt), PLAIN_TOL,
                float(probes.MMA_OPS * probes.ring_mmas(n, k, m, "group_i8")), h.INT8_OPS)
    if name == "gq":
        rot = h.rotation((codes, sct, bt), h.nbytes(codes, sct, bt))
        ws = [gq.GroupQuant(codes=c, dtype=DataType.Q5_1, n_in=k, group_size=GS, a=a, b=b)
              for c, a, b in rot]
        return (gq.gq_decode_generic, gq.qmatmul_decode_ref, [(x, w) for w in ws],
                h.nbytes(codes, sct, bt, x), GQ_TOL, 2.0 * m * n * k, h.F32_FLOPS)
    if name in ("q5k", "q6k"):
        dtype = DataType.Q5_K if name == "q5k" else DataType.Q6_K
        w = rp.from_ggml(kquant_bytes(n, k, dtype, seed), (n, k), dtype, device)
        ts = tuple(w.tensors().values())
        ws = [w._replace(**dict(zip(w.tensors(), r))) for r in h.rotation(ts, h.nbytes(*ts))]
        return (rq.rq_decode, rq.qmatmul_repacked_ref, [(x, v) for v in ws],
                h.nbytes(*ts, x), RQ_TOL, 2.0 * m * n * k, h.F32_FLOPS)
    # w8a8
    ci = torch.randint(-127, 127, (n, k), generator=gen, device=device, dtype=torch.int8)
    sc = torch.full((n, k // i8.SB), 2e-4, device=device)
    ws = [i8.I8SBQuant(c, s, k) for c, s in h.rotation((ci, sc), h.nbytes(ci, sc))]
    return (i8.qmatmul_i8sb, _w8a8_plain, [(x, v) for v in ws],
            h.nbytes(ci, sc, x), I8_TOL, 2.0 * m * n * k, h.INT8_OPS)


def _w8a8_plain(x: torch.Tensor, w) -> torch.Tensor:
    """The w8a8 matmul of f32 x, step by step: the activation quantization,
    the chunked i8 contraction, the row scale."""
    x_i8, sx = i8.quantize_activations(x)
    return i8.qmatmul_i8sb_ref(x_i8, w) * sx


def bench(device: torch.device, seed: int, ms: list[int], arms) -> list[dict]:
    gen = h.generator(device, seed)
    out = []
    for shape in SHAPES:
        n, k = SHAPES[shape]
        planes = make_planes(gen, n, k, device)
        for m in ms:
            x = torch.randn((m, k), generator=gen, device=device)
            for name in arms:
                kern, plain, args, n_bytes, tol, ops, peak = _arm(name, n, k, m, device, gen,
                                                                  planes, x, seed)
                got, want = kern(*args[0]), plain(*args[0])
                err = h.rel_err(got, want)
                h.hold(f"{TOOL} {shape} {name} M={m}", err, tol)
                extra = {}
                if name == "gi8":
                    extra["ops_bound_ms"] = ops / peak * 1e3
                    extra["rel_err_f64"] = h.rel_err(got, dequant_ref_f64(x, *planes))
                    h.hold(f"{TOOL} {shape} gi8 M={m} against the f64 dequant",
                           extra["rel_err_f64"], CHECK_TOL)
                k_ms = h.time_ms(kern, lambda i: args[i], len(args))
                p_ms = h.time_ms(plain, lambda i: args[i], len(args), replays=1)
                b_ms, b_by = h.bound(n_bytes + 4 * m * n, ops, peak)
                out.append(h.record(
                    TOOL, f"{shape} {name}", device, m=m, elems=n * k, n_bytes=n_bytes + 4 * m * n,
                    ms=k_ms, bound_ms=b_ms, bound_by=b_by, kernel=kern.__name__,
                    tpu_variant=name, shape=f"{shape} {n}x{k} M={m}", plain_ms=p_ms,
                    library_ms=None, max_rel_err=err,
                    max_abs_err=float((got - want).abs().max()), tol=tol, **extra))
                del args, got, want
            del x
        del planes
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    h.add_flags(ap)
    ap.add_argument("--m", default="1,8", help="row counts, comma-separated (default 1,8)")
    ap.add_argument("--only", default=None, help=f"arms, comma-separated, of {','.join(ARMS)}")
    args = ap.parse_args(argv)
    device = h.setup(args)
    recs = check(device, args.seed)
    if args.check_only:
        return recs
    only = h.name_set(args.only)
    arms = [a for a in ARMS if only is None or a in only]
    return recs + bench(device, args.seed, h.int_list(args.m), arms)


if __name__ == "__main__":
    main(sys.argv[1:])
