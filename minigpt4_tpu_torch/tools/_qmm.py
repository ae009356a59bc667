"""The runner the unpack-chain tools share (``qmm_variants``, ``qmm_v3``,
``qmm_r3``, ``unpack_variants``).

Each tool keeps its JAX file's variant names and maps every variant to an
:class:`Arm`: a configuration of the probe dequantize-matvec
(``ops/probes.dequant_matvec``: storage, unpack strategy, layout; every
``--width``), or the integer dot (``int``), a production kernel
(``prod``: ``rq_decode`` on repacked q5_k / q4_k) or the library matmul
(``library``).  The map is printed first, one JSON line per variant, with
the reason where a TPU variant differs from its Hopper arm only in TPU
operations.  Then every arm is checked at a small shape against the f64
formula of the JAX files (the plain version on the CPU, the kernel and the
plain version on the card), and, unless ``--check-only``, checked and timed
at ``--n`` x ``--k`` for each M of ``--m`` and each width; an arm that
several variants share is timed once.
"""

from __future__ import annotations

import argparse
import json
from dataclasses import dataclass

import numpy as np
import torch

from ..formats import DataType
from ..ops import pallas_quant_matmul as rq
from ..ops import probes
from ..ops import repack as rp
from . import _harness as h

CHECK_N, CHECK_K, CHECK_MS = 256, 1024, (1, 3, 8)
TOL = 1e-4  # f32 results: the kernel against its plain version and the f64 formula
RQ_TOL = 1e-4


@dataclass(frozen=True)
class Arm:
    kind: str  # "matvec", "int", "prod" or "library"
    what: str  # the storage, int mode, production format or library call
    strategy: str = "shift"
    layout: str = "nm"
    note: str = ""  # where the TPU variant differs only in TPU operations

    def describe(self) -> dict:
        if self.kind == "matvec":
            return {"kernel": "dequant_matvec", "storage": self.what, "strategy": self.strategy,
                    "layout": self.layout}
        return {"kernel": {"int": "int_dot", "prod": "rq_decode",
                           "library": "torch.matmul bf16"}[self.kind], "mode": self.what}


def add_flags(ap: argparse.ArgumentParser, m_default: str) -> None:
    h.add_flags(ap)
    ap.add_argument("--k", type=int, default=13824)
    ap.add_argument("--n", type=int, default=5120)
    ap.add_argument("--m", "--tm", dest="m", default=m_default,
                    help=f"row counts, comma-separated (default {m_default})")
    ap.add_argument("--only", default=None, help="variant names, comma-separated")
    ap.add_argument("--width", default="4,16",
                    help="bytes per lane and load of the matvec arms (default 4,16)")


# ---------------------------------------------------------------------------
# the f64 formula of the JAX files
# ---------------------------------------------------------------------------


def formula_f64(x: np.ndarray, w: probes.ProbeWeight) -> np.ndarray:
    """y = x @ (value * s).T in f64 with NumPy, from the JAX variants' own
    definitions: nibble k = 2j low, 2j + 1 high (the K-order layout), i4 =
    (nibble ^ 8) - 8; q5 adds 16 * bit, the bit of field p (k = p nb + i,
    nb = K / 8) at bit p of hi[n, i] (qmm_variants q5cur), or, for the dual
    half-planes, bit p % 4 + 1 of hi[n, (p // 4) nb + i] (qmm_v3 q5i8dom)."""
    n, k = w.n_out, w.n_in
    c = w.codes.cpu()
    if w.storage == "dense":
        vals = c.float().numpy().astype(np.float64)
        return x.astype(np.float64) @ (vals if w.layout == "nm" else vals.T).T
    if w.storage == "i8":
        q = c.numpy().astype(np.int64)
        q = q if w.layout == "nm" else q.T
    else:
        b = c.numpy().astype(np.int64)
        if w.layout == "km":  # [K/2, N]: byte (i, n) holds k = 2i, 2i + 1
            b = b.T
        q = np.empty((n, k), np.int64)
        q[:, 0::2], q[:, 1::2] = b & 15, b >> 4
        if probes.STORAGES[w.storage][1]:
            q = (q ^ 8) - 8
    if w.storage in ("q5", "q5i4", "q5d"):
        hi = w.hi.cpu().numpy().astype(np.int64)
        nb = k // 8
        for p in range(8):
            if w.storage == "q5d":
                bit = (hi[:, (p // 4) * nb:(p // 4 + 1) * nb] >> (p % 4 + 1)) & 1
            else:
                bit = (hi >> p) & 1
            q[:, p * nb:(p + 1) * nb] += 16 * bit
    s = w.scales.cpu().float().numpy().astype(np.float64)
    s = s if w.layout == "nm" else s.T
    return x.astype(np.float64) @ (q * np.repeat(s, probes.GS, axis=1)).T


# ---------------------------------------------------------------------------
# arms
# ---------------------------------------------------------------------------


def kquant_bytes(n: int, k: int, dtype: DataType, seed: int) -> np.ndarray:
    """Random q5_k (176-byte), q4_k (144-byte) or q6_k (210-byte) blocks with
    finite f16 d = dmin = 0.01 (the JAX shootout's bytes; q6_k has d alone,
    its last two bytes)."""
    nb = n * k // 256
    size = {DataType.Q5_K: 176, DataType.Q4_K: 144, DataType.Q6_K: 210}[dtype]
    raw = np.random.default_rng(seed).integers(0, 256, (nb, size), dtype=np.uint8)
    d = np.frombuffer(np.full(nb, 0.01, np.float16).tobytes(), np.uint8).reshape(nb, 2)
    if dtype == DataType.Q6_K:
        raw[:, 208:210] = d
    else:
        raw[:, 0:2] = raw[:, 2:4] = d
    return raw.reshape(-1)


def _matvec_case(arm: Arm, width: int, w: probes.ProbeWeight, x: torch.Tensor, rot: list,
                 device, timed: bool) -> dict:
    m, k = x.shape
    n = w.n_out
    got = probes.dequant_matvec(x, w, arm.strategy, width)
    want = probes.dequant_matvec_ref(x, w)
    res = {"max_rel_err": h.rel_err(got, want), "max_abs_err": float((got - want).abs().max()),
           "tol": TOL}
    label = f"dequant_matvec {w.storage} {arm.strategy} {arm.layout} w{width} M={m}"
    h.hold(label, res["max_rel_err"], TOL)
    if not timed:  # the small check shape: also the f64 formula of the JAX files
        f64 = torch.from_numpy(formula_f64(x.cpu().numpy(), w))
        res["rel_err_f64"] = h.rel_err(got.cpu(), f64)
        h.hold(label + " against the f64 formula", res["rel_err_f64"], TOL)
        return res
    ws = [probes.ProbeWeight(c, s, w.storage, n, k, w.layout, hi) for c, hi, s in rot]
    res["ms"] = h.time_ms(lambda v: probes.dequant_matvec(x, v, arm.strategy, width),
                          lambda i: (ws[i],), len(ws))
    res["plain_ms"] = h.time_ms(lambda v: probes.dequant_matvec_ref(x, v), lambda i: (ws[i],),
                                len(ws), replays=1)
    res["library_ms"] = None
    if w.storage == "dense":  # one PyTorch call computes the same function
        xb = x.to(torch.bfloat16)
        mats = [v.codes if v.layout == "km" else v.codes.t() for v in ws]
        res["library_ms"] = h.time_ms(lambda wt: torch.matmul(xb, wt), lambda i: (mats[i],),
                                      len(mats))
    n_bytes = w.nbytes + 4 * m * (k + n)
    res["bytes"] = n_bytes
    res["bound_ms"], res["bound_by"] = matvec_bound(n_bytes, m, n, k)
    res["bound_f32_ms"] = h.bound(n_bytes, 2.0 * m * n * k, h.F32_FLOPS)[0]
    return res


def matvec_bound(n_bytes: float, m: int, n: int, k: int) -> tuple[float, str]:
    """The dequantize-matvec's bound in the units it computes with: at M = 1
    2 M N K f32 FMAs; at M = 2..8 the tensor-core products, three bf16 parts
    of x (``probes.split_bf16x3``), 3 x 2 M N K at the bf16 peak."""
    if m == 1:
        return h.bound(n_bytes, 2.0 * m * n * k, h.F32_FLOPS)
    return h.bound(n_bytes, 3 * 2.0 * m * n * k, h.BF16_FLOPS)


def _prod_case(fmt: str, n: int, k: int, x: torch.Tensor, seed: int, device,
               timed: bool) -> dict:
    dtype = DataType[fmt.upper()]
    wq = rp.from_ggml(kquant_bytes(n, k, dtype, seed), (n, k), dtype, device)
    got, want = rq.rq_decode(x, wq), rq.qmatmul_repacked_ref(x, wq)
    res = {"max_rel_err": h.rel_err(got, want), "max_abs_err": float((got - want).abs().max()),
           "tol": RQ_TOL}
    h.hold(f"rq_decode {fmt} M={x.shape[0]}", res["max_rel_err"], RQ_TOL)
    if not timed:
        return res
    ts = tuple(wq.tensors().values())
    ws = [wq._replace(**dict(zip(wq.tensors(), r))) for r in h.rotation(ts, h.nbytes(*ts))]
    res["ms"] = h.time_ms(rq.rq_decode, lambda i: (x, ws[i]), len(ws))
    res["plain_ms"] = h.time_ms(rq.qmatmul_repacked_ref, lambda i: (x, ws[i]), len(ws),
                                replays=1)
    res["library_ms"] = None
    m = x.shape[0]
    res["bytes"] = h.nbytes(*ts) + 4 * m * (k + n)
    res["bound_ms"], res["bound_by"] = h.bound(res["bytes"], 2.0 * m * n * k, h.F32_FLOPS)
    return res


def _library_case(n: int, k: int, x: torch.Tensor, gen, device) -> dict:
    w = torch.randn((n, k), generator=gen, device=device).to(torch.bfloat16)
    mats = [t[0].t() for t in h.rotation((w,), h.nbytes(w))]
    xb = x.to(torch.bfloat16)
    m = x.shape[0]
    ms = h.time_ms(lambda wt: torch.matmul(xb, wt), lambda i: (mats[i],), len(mats))
    n_bytes = h.nbytes(w, xb) + 2 * m * n
    b_ms, b_by = h.bound(n_bytes, 2.0 * m * n * k, h.BF16_FLOPS)
    return {"ms": ms, "plain_ms": None, "library_ms": ms, "bytes": n_bytes, "bound_ms": b_ms,
            "bound_by": b_by, "max_rel_err": None, "max_abs_err": None, "tol": None}


def run(tool: str, variants: dict[str, Arm], argv: list[str] | None, doc: str,
        m_default: str) -> list[dict]:
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    add_flags(ap, m_default)
    args = ap.parse_args(argv)
    device = h.setup(args)
    only = h.name_set(args.only)
    unknown = sorted((only or set()) - set(variants))
    if unknown:
        raise ValueError(f"{tool}: unknown variants {unknown}; known: {sorted(variants)}")
    wanted = {name: arm for name, arm in variants.items() if only is None or name in only}
    widths = h.int_list(args.width)
    for name, arm in wanted.items():
        print(json.dumps({"tool": tool, "tpu_variant": name, "hopper": arm.describe(),
                          "widths": widths if arm.kind == "matvec" else None,
                          "note": arm.note}), flush=True)
    gen = h.generator(device, args.seed)
    out = []
    shapes = [(CHECK_N, CHECK_K, list(CHECK_MS), False)]
    if not args.check_only:
        shapes.append((args.n, args.k, h.int_list(args.m), True))
    for n, k, ms, timed in shapes:
        weights: dict = {}
        for m in ms:
            x = torch.randn((m, k), generator=gen, device=device)
            done: dict = {}
            for name, arm in wanted.items():
                for width in widths if arm.kind == "matvec" else [None]:
                    key = (arm.kind, arm.what, arm.strategy, arm.layout, width)
                    if key not in done:
                        done[key] = _case(arm, width, n, k, x, weights, gen, device, args,
                                          timed)
                    res = done[key]
                    if res is None or not timed:
                        continue
                    out.append(h.record(
                        tool, f"{name} w{width}" if width else name, device, m=m, elems=n * k,
                        n_bytes=res["bytes"], ms=res["ms"], bound_ms=res["bound_ms"],
                        bound_by=res["bound_by"], tpu_variant=name, hopper=arm.describe(),
                        kernel=arm.describe()["kernel"],
                        width=width, shape=f"{n}x{k} M={m}",
                        **{kk: res[kk] for kk in ("plain_ms", "library_ms", "max_rel_err",
                                                  "max_abs_err", "rel_err_f64", "tol",
                                                  "bound_f32_ms")
                           if kk in res}))
            if not timed:
                print(json.dumps({"tool": tool, "check": f"{n}x{k} M={m}", "arms": len(done),
                                  "tol": TOL, "card": h.card(device)}), flush=True)
        del weights
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def _case(arm: Arm, width, n: int, k: int, x: torch.Tensor, weights: dict, gen, device, args,
          timed: bool):
    if arm.kind == "matvec":
        key = (arm.what, arm.layout)
        if key not in weights:
            w = probes.random_probe_weight(arm.what, n, k, gen, device, arm.layout)
            rot = (h.rotation((w.codes, w.hi, w.scales), w.nbytes) if timed
                   else [(w.codes, w.hi, w.scales)])
            weights[key] = (w, rot)
        w, rot = weights[key]
        return _matvec_case(arm, width, w, x, rot, device, timed)
    if arm.kind == "int":
        from .probe_int4 import run_mode

        return run_mode(arm.what, n, k, x.shape[0], gen, device, timed)
    if arm.kind == "prod":
        return _prod_case(arm.what, n, k, x, args.seed, device, timed)
    if not timed:  # the library call is a yardstick, nothing to check
        return None
    return _library_case(n, k, x, gen, device)
