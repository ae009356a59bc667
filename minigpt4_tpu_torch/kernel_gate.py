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
budget (``--compile-budget``) has no counterpart.

:func:`run_floors` (``--floors check|record``) holds each decode kernel's
speed to a recorded floor: at four 13B shapes (:data:`FLOOR_SHAPES`) the
ratio of a dense bf16 ``torch.matmul`` at M = 1 to the kernel
(``rq_decode`` on the repacked form, ``gq_decode``, ``i8_decode``), both
timed back to back on one card, must stay at least :data:`FLOOR_MARGIN`
times the ratio recorded in ``kernel_floors.json`` beside this module.
The absolute times move with the card's state and power limit; the ratio
is what a layout or launch regression breaks.  ``record`` writes the file
with the card's name and power limit.

    python -m minigpt4_tpu_torch.kernel_gate            # full sweep
    python -m minigpt4_tpu_torch.kernel_gate --fast     # the worst-K shapes
    python -m minigpt4_tpu_torch.kernel_gate --qtypes q4_k,q5_k --tp
    python -m minigpt4_tpu_torch.kernel_gate --floors check --floors-only

Without a card the command exits 1: the gate launches kernels, and the
plain versions a CPU tensor would take are no gate.  Tests reach
:func:`run_gate` with an injected ``launch`` at small shapes, and
:func:`run_floors` with an injected ``perf_pair``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from .benchmark import random_bytes, random_packed
from .formats import DataType
from .ops import group_i8 as gq
from .ops import i8_matmul as i8
from .ops import pallas_quant_matmul as pqm
from .ops import repack as rp
from .tools import _harness

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


FLOORS_PATH = Path(__file__).resolve().parent / "kernel_floors.json"
FLOOR_SHAPES = {  # name: (kernel arm, K, N), decode at M = 1
    "q5k_w2": ("q5k", 13824, 5120),
    "gq_w2": ("gq", 13824, 5120),
    "i8_w2": ("i8", 13824, 5120),
    "gq_wo": ("gq", 5120, 5120),
}
FLOOR_MARGIN = 0.70  # run-to-run noise allowance of the ratio


def _clone(w):
    """A copy of the weight dataclass ``w`` with every tensor cloned."""
    return dataclasses.replace(w, **{f.name: getattr(w, f.name).clone()
                                     for f in dataclasses.fields(w)
                                     if isinstance(getattr(w, f.name), torch.Tensor)})


def _weight_bytes(w) -> int:
    return _harness.nbytes(*(getattr(w, f.name) for f in dataclasses.fields(w)
                             if isinstance(getattr(w, f.name), torch.Tensor)))


def _chain_ms(fn, args: list) -> float:
    """Device ms per call of ``fn(*args[i])``: one CUDA graph of
    ``_harness.LAUNCHES`` calls rotating through ``args`` (copies of the
    weight whose rotation spans twice the 50 MB L2, so every call reads its
    weight from device memory, as a decode step does), replayed between
    CUDA events (``_harness.time_ms``)."""
    return _harness.time_ms(fn, lambda i: args[i], len(args))


def _perf_pair(kind: str, k: int, n: int, device: str = "cuda") -> tuple[float, float]:
    """(kernel ms, dense ms) of one M = 1 decode shape [N, K] on the card,
    timed in turns kernel, dense, kernel, dense (the smaller of each pair):
    ``q5k`` ``rq_decode`` on random repacked q5_k planes, ``gq``
    ``gq_decode`` on the q5_k group-quant form (i8 codes) of random ggml
    bytes, ``i8`` ``i8_decode`` on random codes in [-127, 126] with scales
    2e-4, each from an f32 x; the dense arm ``torch.matmul`` of the bf16 x
    and a bf16 [K, N] weight."""
    dev = torch.device(device)
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((1, k), generator=gen, device=dev)
    if kind == "q5k":
        w, kfn = random_packed(rng, (n, k), DataType.Q5_K, "repack", dev), pqm.rq_decode
    elif kind == "gq":
        raw = random_bytes(rng, (n, k), DataType.Q5_K).reshape(-1)
        w, kfn = gq.from_ggml(raw, (n, k), DataType.Q5_K, dev), gq.gq_decode
    elif kind == "i8":
        codes = torch.randint(-127, 127, (n, k), dtype=torch.int8, generator=gen, device=dev)
        w = i8.I8SBQuant(codes, torch.full((n, k // i8.SB), 2e-4, device=dev), k)
        kfn = i8.i8_decode
    else:
        raise ValueError(kind)
    dense = (torch.randn((k, n), generator=gen, device=dev) * 0.01).to(torch.bfloat16)
    ws = [w] + [_clone(w) for _ in range(_harness.copies_for(_weight_bytes(w)) - 1)]
    ds = [dense] + [dense.clone() for _ in range(_harness.copies_for(_harness.nbytes(dense)) - 1)]
    k_args = [(x, wi) for wi in ws]
    d_args = [(x.to(torch.bfloat16), di) for di in ds]
    kms = dms = float("inf")
    for _ in range(2):
        kms = min(kms, _chain_ms(kfn, k_args))
        dms = min(dms, _chain_ms(torch.matmul, d_args))
    return kms, dms


def run_floors(mode: str = "check", verbose: bool = True, device: str = "cuda", *,
               perf_pair=None, path: str | Path | None = None, report: list | None = None,
               out=sys.stderr) -> bool:
    """Each decode kernel against a dense bf16 matvec of its shape, timed
    back to back (:func:`_perf_pair`): the ratio dense ms / kernel ms (> 1:
    the kernel beats dense, reading fewer bytes) must stay at least
    FLOOR_MARGIN x the ratio recorded in ``path`` (default
    :data:`FLOORS_PATH`); a shape with no recorded ratio passes.
    ``mode="record"`` writes the measured ratios, their times and the card
    to ``path`` instead (commit it deliberately).  One line per shape goes
    to ``out`` (FAIL lines always, the others when ``verbose``) and, with
    ``report``, one dict per shape into it.  Returns False if any shape
    failed or fell under its floor.  Without a card it raises: the floors
    time kernels, and a CPU run would pass silently.  Tests inject
    ``perf_pair(kind, k, n) -> (kernel_ms, dense_ms)``."""
    dev = torch.device(device)
    if perf_pair is None:
        if dev.type != "cuda" or not torch.cuda.is_available():
            raise RuntimeError("run_floors times the port's kernels on an NVIDIA GPU; there is "
                               "no card here (or the device is not cuda)")

        def perf_pair(kind, k, n):
            return _perf_pair(kind, k, n, device)
    path = Path(path or FLOORS_PATH)
    recorded = json.loads(path.read_text()).get("ratios", {}) if path.exists() else {}
    ratios, times = {}, {}
    ok = True
    for name, (kind, k, n) in FLOOR_SHAPES.items():
        try:
            kms, dms = perf_pair(kind, k, n)
        except Exception as e:  # a failed launch fails its shape, named
            ok = False
            _emit(out, f"[kernel-floors] FAIL {name}: {type(e).__name__}: {e}")
            continue
        ratio = dms / kms
        ratios[name] = round(ratio, 3)
        times[name] = {"kernel_ms": round(kms, 5), "dense_ms": round(dms, 5)}
        floor = recorded.get(name)
        good = mode != "check" or floor is None or ratio >= floor * FLOOR_MARGIN
        ok = ok and good
        if report is not None:
            report.append({"name": name, "kernel_ms": kms, "dense_ms": dms, "ratio": ratio,
                           "recorded": floor, "ok": good})
        base = f"recorded {floor:.3f}" if floor is not None else "no baseline"
        line = (f"{name}: ratio {ratio:.3f} ({base}, floor {FLOOR_MARGIN} x) kernel "
                f"{kms:.4f} ms dense {dms:.4f} ms")
        if not good:
            _emit(out, f"[kernel-floors] FAIL {line}")
        elif verbose:
            _emit(out, f"[kernel-floors] {line}")
    if mode == "record" and ratios:
        path.write_text(json.dumps(
            {"margin": FLOOR_MARGIN, "ratios": ratios, "ms": times,
             "card": _harness.card(dev),
             "note": "dense_ms / kernel_ms at M = 1, timed back to back on the card named in "
                     "card (name, power limit); re-record deliberately with "
                     "python -m minigpt4_tpu_torch.kernel_gate --floors record --floors-only"},
            indent=1) + "\n")
        _emit(out, f"[kernel-floors] recorded -> {path}")
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
    ap.add_argument("--floors", choices=["check", "record"], default=None,
                    help="also the decode kernels' speed floors against kernel_floors.json "
                    "(record: measure and write them)")
    ap.add_argument("--floors-only", action="store_true",
                    help="skip the sweep (floors / tp only)")
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
    ok = True
    if not args.floors_only:
        ok = run_gate(fast=args.fast, qtypes=qtypes, report=report)
    if args.tp:
        ok = run_tp_gate(report=report) and ok
    for entry, s in sorted(summary(report).items()):
        print(f"[kernel-gate] {entry}: {s['cases']} cases, {s['failed']} failed, "
              f"max rel err {s['max_rel_err']:.3e}")
    if report:
        print(f"[kernel-gate] {len(report)} cases, {sum(not r['ok'] for r in report)} failed, "
              f"{time.perf_counter() - t0:.1f} s  [{torch.cuda.get_device_name(0)}]")
    if args.floors:
        floors: list = []
        ok = run_floors(args.floors, report=floors) and ok
        print(f"[kernel-floors] {args.floors}: {sum(not r['ok'] for r in floors)} of "
              f"{len(floors)} shapes under their floors  [{_harness.card(torch.device('cuda'))}]")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
