"""What the probe tools share: flags, timing on the card, bounds and one
JSON line per case.

The single counterpart of the ``timed`` function that the JAX probes
repeat.  A kernel is timed as a CUDA graph of ``LAUNCHES`` (20) launches that
rotate through enough copies of the weight to exceed the
H100's 50 MB L2 (a w2 nibble weight alone, 35.4 MB, or q5 codes with their
plane, 44.2 MB, would sit in L2 and report L2 speed, not device-memory
speed); the graph is replayed ``REPLAYS`` times between CUDA events and the
median per launch is the time.  The graph keeps the wrappers' host work
(argument checks, ctypes) out of the times, which for these 10-200 us
kernels it would otherwise dominate.  Plain versions are timed the same
way.  Timing needs an NVIDIA GPU: on the CPU it raises; ``--check-only``
runs the checks alone, on the plain versions when ``--device cpu``.

Each case prints one JSON line: the tool, the case and the TPU variant it
stands for, M, the time, Ge/s (weights per second, the JAX probes' unit),
GB/s, the bound (the larger of the bytes at 3.35 TB/s and the operations at
the peak of their type, NVIDIA's H100 SXM data sheet) and the share of the
bound reached, the plain and library times where measured, the error
against the plain version, and the card.
"""

from __future__ import annotations

import argparse
import collections
import functools
import json
import math
import re
import shutil
import statistics
import subprocess
from pathlib import Path

import torch

L2_BYTES = 50e6
# NVIDIA's H100 SXM data sheet: HBM rate, f32 on the CUDA cores (also the
# rate counted for elementwise integer work), dense bf16 and int8 tensor cores
HBM_BPS, F32_FLOPS, BF16_FLOPS, INT8_OPS = 3.35e12, 67e12, 989e12, 1979e12
LAUNCHES = 20
REPLAYS = 5
_card: dict = {}


def add_flags(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu (checks only)")
    ap.add_argument("--check-only", action="store_true",
                    help="run the correctness checks, time nothing")
    ap.add_argument("--seed", type=int, default=0)


def int_list(s: str) -> list[int]:
    return [int(v) for v in s.split(",") if v]


def name_set(s: str | None) -> set[str] | None:
    return set(s.split(",")) if s else None


def setup(args) -> torch.device:
    """The device of ``--device``; timing (no ``--check-only``) needs a card."""
    device = torch.device(args.device)
    if not args.check_only:
        require_card(device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


def require_card(device: torch.device) -> None:
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("timing needs an NVIDIA GPU (torch.cuda); on the CPU only "
                           "--check-only runs, on the plain versions")


def generator(device: torch.device, seed: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def card(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi prints them, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    if "line" not in _card:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True)
        _card["line"] = out.stdout.strip().splitlines()[0]
    return _card["line"]


def copies_for(nbytes: int) -> int:
    """Copies of a weight of ``nbytes`` whose rotation spans at least twice
    the L2, so no launch finds its weight there."""
    return max(2, math.ceil(2 * L2_BYTES / max(nbytes, 1)))


def rotation(tensors, nbytes: int) -> list:
    """``tensors`` (a tuple of tensors or None) and clones of them, as many
    as :func:`copies_for` asks."""
    out = [tensors]
    for _ in range(copies_for(nbytes) - 1):
        out.append(tuple(None if t is None else t.clone() for t in tensors))
    return out


def time_ms(fn, args_for, n_args: int, replays: int = REPLAYS) -> float:
    """Median ms per launch of ``fn(*args_for(i % n_args))``: a CUDA graph of
    LAUNCHES calls, replayed ``replays`` times between CUDA events."""
    for i in range(n_args):  # warm up: builds, allocator, every copy once
        fn(*args_for(i))
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(LAUNCHES):
            fn(*args_for(i % n_args))
    graph.replay()
    torch.cuda.synchronize()
    per = []
    for _ in range(replays):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        per.append(a.elapsed_time(b) / LAUNCHES)
    del graph
    return statistics.median(per)


def bound(n_bytes: float, ops: float, peak: float) -> tuple[float, str]:
    """(least ms, "bytes" or "operations")."""
    t_bytes, t_ops = n_bytes / HBM_BPS, ops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))


def hold(label: str, err: float, tol: float) -> None:
    if not err <= tol:
        raise AssertionError(f"{label}: error {err:.3e} above {tol:g}")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def record(tool: str, case: str, device: torch.device, *, m: int, elems: float,
           n_bytes: float, ms: float | None, bound_ms: float, bound_by: str, **extra) -> dict:
    """One case: print it as a JSON line and return it."""
    rec = {"tool": tool, "case": case, "m": m, "ms": ms,
           "ge_s": None if ms is None else elems / ms / 1e6,
           "gb_s": None if ms is None else n_bytes / ms / 1e6,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "share_of_bound": None if ms is None else bound_ms / ms, **extra,
           "card": card(device)}
    print(json.dumps(rec), flush=True)
    return rec


@functools.lru_cache(maxsize=2)
def _sass(lib: str, stamp: float) -> str:
    """``cuobjdump -sass`` of the library at ``lib``, once per build
    (``stamp``, its modification time)."""
    from ..ops import _build

    tool = shutil.which("cuobjdump") or str(Path(_build._nvcc()).parent / "cuobjdump")
    return subprocess.run([tool, "-sass", lib], capture_output=True, text=True, timeout=600,
                          check=True).stdout


def sass_functions(kernel: str) -> dict:
    """{function: {opcode: count}} over the SASS of the built library's
    functions whose (mangled) name holds ``kernel``, one entry per template
    instance (``cuobjdump -sass``; needs the CUDA toolkit)."""
    from ..ops import _build

    lib = _build.build()
    out = _sass(str(lib), lib.stat().st_mtime)
    funcs: dict = {}
    ops = None
    for line in out.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            ops = funcs.setdefault(name, collections.Counter()) if kernel in name else None
        elif ops is not None:
            hit = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
            if hit:
                ops[hit.group(1)] += 1
    return {name: dict(c) for name, c in funcs.items()}


def sass_opcodes(kernel: str) -> dict:
    """{opcode: count} over the SASS of the built library's functions whose
    name holds ``kernel`` (``cuobjdump -sass``; needs the CUDA toolkit)."""
    total: collections.Counter = collections.Counter()
    for ops in sass_functions(kernel).values():
        total.update(ops)
    return dict(total)
