"""The kernel gate: every matmul kernel of the port at every real weight shape.

Counterpart of ``minigpt4_tpu/kernel_gate.py``.  The unit tests run the
kernels at fixture shapes; a failure that only a real shape reaches (more
dynamic shared memory than a launch may take, a grid limit, a template
instance or K split that no small N or K selects) would otherwise surface
inside a 40-layer chat.  The gate launches each matmul entry at every weight
shape of Vicuna-7B and -13B as the port's loader lays them out (fused
``wqkv`` 3d x d, ``wo``, fused ``w13`` 2ff x d, ``w2``, ``output``), for
q4_k, q5_k, q6_k, q4_0, q8_0 and q5_1, M = 1, 8, 9 and 512 (both sides of
the decode / prefill switch at 8 rows), stacked (layer 1 of 2) and flat:

* the gq entries (``ops/group_i8.py``): ``gq_decode`` / ``gq_prefill`` on
  the exact q4_k / q5_k planes, ``gq_decode_generic`` /
  ``gq_prefill_generic`` on the others, each on i8 codes and on the packed
  codes of the format (p4, p5, p6);
* ``rq_decode`` / ``rq_prefill`` (``ops/pallas_quant_matmul.py``) on the
  repacked form of the same bytes;
* ``i8_decode`` / ``i8_prefill`` (``ops/i8_matmul.py``) once per shape.

Each case is held to the f64 product of its weight dequantized (for the i8
entries, of x quantized as the kernel quantizes it): max |y - ref| /
max(1, max |ref|) within 1e-3 for the gq decode and i8 entries and 2e-2 for
the prefill and ``rq`` entries (bf16 operands).  :func:`run_tp_gate` checks
the K shards of tensor parallelism (13B w2 and wo at tp = 2 and 4, cut by
``repack.k_slice``): the sum of the shard outputs against the whole
weight's reference.  gq has no tp case: the port refuses a gq decoder
under tp.  The gate builds nothing with JAX's Mosaic, so JAX's compile-time
budget (``--compile-budget``) has no counterpart, and the timed ratios
against recorded floors (``--floors``) belong to the benchmark.

    python -m minigpt4_tpu_torch.kernel_gate            # full sweep
    python -m minigpt4_tpu_torch.kernel_gate --fast     # the worst-K shapes
    python -m minigpt4_tpu_torch.kernel_gate --qtypes q4_k,q5_k --tp

Without a card the command exits 1: the gate launches kernels, and the
plain versions a CPU tensor would take are no gate.  Tests reach
:func:`run_gate` with an injected ``launch`` at small shapes.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

from .benchmark import random_bytes, random_packed
from .formats import DataType
from .ops import group_i8 as gq
from .ops import i8_matmul as i8
from .ops import pallas_quant_matmul as pqm
from .ops import repack as rp

# (N, K) of each weight as the port's loader holds it
SHAPES_13B = {"wqkv": (15360, 5120), "wo": (5120, 5120), "w13": (27648, 5120),
              "w2": (5120, 13824), "output": (32000, 5120)}
SHAPES_7B = {"wqkv": (12288, 4096), "wo": (4096, 4096), "w13": (22016, 4096),
             "w2": (4096, 11008), "output": (32000, 4096)}
# the largest K (w2) and the widest input-K weight of the layers (w13)
FAST_SHAPES = {"13B w2": (5120, 13824), "13B w13": (27648, 5120)}
QTYPES = (DataType.Q4_K, DataType.Q5_K, DataType.Q6_K, DataType.Q4_0, DataType.Q8_0,
          DataType.Q5_1)
MS = (1, 8, 9, 512)
TP_SHAPES = {"w2": (5120, 13824), "wo": (5120, 5120)}
TP_SIZES = (2, 4)
TP_MS = (1, 512)
DECODE_TOL = 1e-3  # dual-i8 gq decode and the exact i8 x i8 chunks, f32 sums
PREFILL_TOL = 2e-2  # bf16 operands (prefill), and the rq entries

# each entry's wrapper (on CPU tensors a wrapper computes its plain version)
ENTRIES = {"gq_decode": gq.gq_decode, "gq_decode_generic": gq.gq_decode_generic,
           "gq_prefill": gq.gq_prefill, "gq_prefill_generic": gq.gq_prefill_generic,
           "rq_decode": pqm.rq_decode, "rq_prefill": pqm.rq_prefill,
           "i8_decode": i8.i8_decode, "i8_prefill": i8.i8_prefill}


def kernel_launch(entry: str, x: torch.Tensor, w, layer: int | None) -> torch.Tensor:
    """Call ``entry``'s wrapper (the packing suffix of a gq entry name is the
    weight's own)."""
    return ENTRIES[entry.split("[")[0]](x, w, layer)


@dataclass(frozen=True)
class Case:
    """One launch: ``form`` is ``gq`` (i8 codes), ``gq p4|p5|p6``, ``rq``
    or ``i8`` (``qtype`` None)."""

    shape: str
    n: int
    k: int
    qtype: DataType | None
    form: str
    m: int
    stacked: bool

    @property
    def entry(self) -> str:
        if self.form == "i8":
            return "i8_decode" if self.m <= i8.I8_MAX_M else "i8_prefill"
        if self.form == "rq":
            return "rq_decode" if self.m <= pqm.RQ_MAX_M else "rq_prefill"
        name = "gq_decode" if self.m <= gq.GQ_MAX_M else "gq_prefill"
        if self.qtype not in gq.EXACT_PLANE:
            name += "_generic"
        packing = self.form.split()[1] if " " in self.form else None
        return f"{name}[{packing}]" if packing else name

    @property
    def tol(self) -> float:
        return DECODE_TOL if self.entry.startswith(("gq_decode", "i8")) else PREFILL_TOL

    @property
    def tag(self) -> str:
        qt = "" if self.qtype is None else f" {self.qtype.name.lower()}"
        return (f"{self.shape} ({self.n}x{self.k}){qt} {self.form} M={self.m} "
                f"{'stacked' if self.stacked else 'flat'} {self.entry}")


def gate_cases(fast: bool = False, qtypes=None, shapes: dict | None = None) -> list[Case]:
    """The sweep: every shape x quant type x weight form x M x stacked/flat,
    then the i8 entries per shape (only without a ``qtypes`` filter, which
    splits a long sweep over processes)."""
    if shapes is None:
        shapes = FAST_SHAPES if fast else {
            **{f"13B {n}": s for n, s in SHAPES_13B.items()},
            **{f"7B {n}": s for n, s in SHAPES_7B.items()}}
    cases = []
    for name, (n, k) in shapes.items():
        for qt in (qtypes or QTYPES):
            qt = DataType(qt)
            forms = []
            if gq.supported(qt, k):
                forms.append("gq")
                if gq.packable(qt):
                    forms.append(f"gq {gq.packing_of(qt)}")
            forms.append("rq")
            cases += [Case(name, n, k, qt, f, m, st) for f in forms for m in MS
                      for st in (True, False)]
    if qtypes is None:
        cases += [Case(name, n, k, None, "i8", m, st) for name, (n, k) in shapes.items()
                  for m in MS for st in (True, False)]
    return cases


def _two_layers(w, stack):
    """``w`` as layer 1 of a stacked pair whose layer 0 holds the same codes
    rolled by one row (a launch that reads the wrong layer gives other rows)."""
    other = {"codes": w.codes.roll(1, -2)}
    if getattr(w, "hi", None) is not None:
        other["hi"] = w.hi.roll(1, -2)
    return stack([dataclasses.replace(w, **other), w])


def _weights(shape: tuple[int, int], qtype: DataType | None, device) -> dict:
    """{form: (flat weight, stacked pair)} of one shape and quant type: the
    gq and rq forms of one draw of ggml bytes, or an i8 weight with codes in
    [-127, 127] and scales in [1e-4, 3e-4]."""
    n, k = shape
    if qtype is None:
        gen = torch.Generator(device=device).manual_seed(0)
        w = i8.I8SBQuant(
            torch.randint(-127, 128, (n, k), dtype=torch.int8, generator=gen, device=device),
            1e-4 + 2e-4 * torch.rand((n, k // i8.SB), generator=gen, device=device), k)
        return {"i8": (w, _two_layers(w, i8.stack))}
    raw = random_bytes(np.random.default_rng(0), shape, qtype).reshape(-1)
    out = {}
    if gq.supported(qtype, k):
        w = gq.from_ggml(raw, shape, qtype, device)
        out["gq"] = (w, _two_layers(w, gq.stack))
        if gq.packable(qtype):
            wp = gq.pack_codes(w)
            out[f"gq {wp.packing}"] = (wp, _two_layers(wp, gq.stack))
    w = rp.from_ggml(raw, shape, qtype, device)
    out["rq"] = (w, _two_layers(w, rp.stack))
    return out


def rel_err(y: torch.Tensor, ref: torch.Tensor) -> float:
    """max |y - ref| / max(1, max |ref|), in f64."""
    return float((y.double() - ref).abs().max()) / max(1.0, float(ref.abs().max()))


def _emit(out, line: str) -> None:
    if out is not None:
        print(line, file=out, flush=True)


def _check(case: Case, w, x: torch.Tensor, ref: torch.Tensor, launch, report, out) -> bool:
    layer = 1 if case.stacked else None
    try:
        if case.entry == "i8_prefill":
            x_i8, sx = i8.quantize_activations(x)
            y = launch(case.entry, x_i8, w, layer) * sx
        else:
            y = launch(case.entry, x, w, layer)
        if tuple(y.shape) != (case.m, case.n):
            raise ValueError(f"output shape {tuple(y.shape)}, want {(case.m, case.n)}")
        err = rel_err(y, ref)
        ok = err <= case.tol
        note = f"rel err {err:.3e} (tol {case.tol:g})"
    except Exception as e:  # a refused or failed launch fails its case, named
        err, ok, note = float("nan"), False, f"{type(e).__name__}: {e}"
    _emit(out, f"[kernel-gate] {'PASS' if ok else 'FAIL'} {case.tag}: {note}")
    if report is not None:
        report.append({"tag": case.tag, "entry": case.entry, "rel_err": err, "tol": case.tol,
                       "ok": ok})
    return ok


def _resolve(device: str, launch):
    if launch is None:
        if torch.device(device).type != "cuda":
            raise ValueError("the gate launches kernels: pass a CUDA device, or inject launch= "
                             "(a wrapper given CPU tensors runs its plain version)")
        return kernel_launch
    return launch


def run_gate(fast: bool = False, qtypes=None, device: str = "cuda", *, launch=None,
             shapes: dict | None = None, report: list | None = None, out=sys.stderr) -> bool:
    """Run the sweep of :func:`gate_cases`; one PASS / FAIL line per case
    goes to ``out`` (None: silent) and, with ``report``, one dict per case
    (tag, entry, rel_err, tol, ok) into it.  Returns False if any case
    failed.  ``launch(entry, x, w, layer) -> y`` replaces the kernels
    (tests inject :func:`kernel_launch` on CPU tensors, which the wrappers
    serve with their plain versions, or a faulty launch, at small
    ``shapes``)."""
    launch = _resolve(device, launch)
    cases = gate_cases(fast, qtypes, shapes)
    groups: dict = {}
    for c in cases:
        groups.setdefault((c.shape, c.n, c.k, c.qtype), []).append(c)
    ok = True
    gen = torch.Generator(device=device).manual_seed(1)
    for (_, n, k, qt), group in groups.items():
        forms = _weights((n, k), qt, device)
        xs = {m: torch.randn((m, k), generator=gen, device=device) for m in {c.m for c in group}}
        for form, (w, pair) in forms.items():
            w64 = w.dequantize().double()
            for m, x in xs.items():
                if form == "i8":
                    x_i8, sx = i8.quantize_activations(x)
                    ref = (x_i8.double() * sx.double()) @ w64.t()
                else:
                    ref = x.double() @ w64.t()
                for c in group:
                    if c.form == form and c.m == m:
                        ok = _check(c, pair if c.stacked else w, x, ref, launch, report,
                                    out) and ok
            del w64
        del forms
    return ok


def run_tp_gate(device: str = "cuda", *, launch=None, shapes: dict | None = None,
                report: list | None = None, out=sys.stderr) -> bool:
    """The row-parallel K shards of 13B w2 and wo (q5_k, repacked, random
    codes) at tp = 2 and 4, as ``repack.k_slice`` cuts them for the tp
    path, at M = 1 and 512: the sum of the shards' outputs against the
    whole weight's f64 reference (2e-2).  The gq lines say n/a: the port
    refuses a gq decoder under tp."""
    launch = _resolve(device, launch)
    ok = True
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=device).manual_seed(1)
    for name, (n, k) in (shapes or TP_SHAPES).items():
        w = random_packed(rng, (n, k), DataType.Q5_K, "repack", device)
        w64 = w.dequantize().double()
        for tp in TP_SIZES:
            shards = [rp.k_slice(w, i, tp) for i in range(tp)]
            ks = k // tp
            for m in TP_MS:
                entry = "rq_decode" if m <= pqm.RQ_MAX_M else "rq_prefill"
                tag = f"13B {name} ({n}x{k}) q5_k rq tp={tp} M={m} {entry}"
                x = torch.randn((m, k), generator=gen, device=device)
                try:
                    y = sum(launch(entry, x[:, i * ks:(i + 1) * ks].contiguous(), s, None)
                            for i, s in enumerate(shards))
                    err = rel_err(y, x.double() @ w64.t())
                    good = err <= PREFILL_TOL
                    note = f"rel err {err:.3e} (tol {PREFILL_TOL:g})"
                except Exception as e:
                    err, good, note = float("nan"), False, f"{type(e).__name__}: {e}"
                ok = ok and good
                _emit(out, f"[kernel-gate:tp] {'PASS' if good else 'FAIL'} {tag}: {note}")
                if report is not None:
                    report.append({"tag": tag, "entry": entry, "rel_err": err,
                                   "tol": PREFILL_TOL, "ok": good})
            _emit(out, f"[kernel-gate:tp] n/a 13B {name} gq tp={tp}: the port refuses a gq "
                       "decoder under tp, so no gq weight is cut into K shards")
        del w64
    return ok


def summary(report: list) -> dict:
    """Per entry: {"cases": n, "failed": f, "max_rel_err": e}."""
    out: dict = {}
    for r in report:
        s = out.setdefault(r["entry"], {"cases": 0, "failed": 0, "max_rel_err": 0.0})
        s["cases"] += 1
        s["failed"] += 0 if r["ok"] else 1
        if r["rel_err"] == r["rel_err"]:  # not NaN
            s["max_rel_err"] = max(s["max_rel_err"], r["rel_err"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fast", action="store_true", help="the worst-K shapes only")
    ap.add_argument("--qtypes", default=None,
                    help="comma list (e.g. q4_k,q5_k) to split a long sweep; drops the i8 cases")
    ap.add_argument("--tp", action="store_true",
                    help="also the K shards of 13B w2 and wo at tp = 2 and 4")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_gate: no CUDA card (torch.cuda.is_available() is false); the gate "
              "launches the port's kernels and runs nothing without one", file=sys.stderr)
        return 1
    qtypes = None
    if args.qtypes:
        qtypes = [DataType[q.strip().upper()] for q in args.qtypes.split(",")]
    from .ops import _build

    _build.load()
    t0 = time.perf_counter()
    report: list = []
    ok = run_gate(fast=args.fast, qtypes=qtypes, report=report)
    if args.tp:
        ok = run_tp_gate(report=report) and ok
    for entry, s in sorted(summary(report).items()):
        print(f"[kernel-gate] {entry}: {s['cases']} cases, {s['failed']} failed, "
              f"max rel err {s['max_rel_err']:.3e}")
    print(f"[kernel-gate] {len(report)} cases, {sum(not r['ok'] for r in report)} failed, "
          f"{time.perf_counter() - t0:.1f} s  [{torch.cuda.get_device_name(0)}]")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
