"""Profiling: device traces, device memory and decode statistics.

Counterpart of ``minigpt4_tpu/profiling.py`` on ``torch.profiler`` and the
CUDA caching allocator.  The reference's observability is RAII phase timers
printed at INFO (minigpt4.cpp:287-312) plus memory high-water marks; here
:func:`trace` writes a Chrome trace of host and device activity,
:func:`device_memory_stats` reads the allocator's counters of one device (a
rank's own under tensor parallelism), :class:`DecodeStats` times a token
stream, and :func:`profile_window` summarises one profiled call (device busy
time, idle share, the kernels with the most time, the host time inside
collectives on the calling thread); :func:`collective_seconds` counts the
tp all-reduces of every thread.

Usage::

    from minigpt4_tpu_torch.profiling import DecodeStats, trace

    with trace("build/trace"):
        engine.encode_image(px)

    stats = DecodeStats()
    for tok in engine.generate(params=sp):
        stats.tick()
    print(stats.summary())
"""

from __future__ import annotations

import math
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch


@contextmanager
def trace(log_dir: str):
    """Capture a trace of the block (host activity, and the card's where
    there is one) into ``log_dir/trace.json``, which chrome://tracing and
    Perfetto open."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / "trace.json"))


def device_memory_stats(device: str | torch.device | None = None) -> dict:
    """Bytes in use, their peak and the device's total for one CUDA device
    (this process's current one by default: a rank's own), from the
    caching allocator; {} without a card (JAX's returns {} where the
    backend reports nothing)."""
    if not torch.cuda.is_available():
        return {}
    dev = torch.device("cuda", torch.cuda.current_device()) if device is None else torch.device(device)
    if dev.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(dev)
    return {
        "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
        "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
        "bytes_limit": torch.cuda.get_device_properties(dev).total_memory,
    }


def collective_seconds() -> tuple[float, int]:
    """Host seconds this process has spent in tensor-parallel all-reduces so
    far, over every thread, and their number (``parallel/mesh.py``); the
    difference across a window is its collectives' time where the profiler
    sees only the calling thread (a server's request threads)."""
    from .parallel.mesh import COLLECTIVES

    return COLLECTIVES["s"], COLLECTIVES["calls"]


class DecodeStats:
    """Streaming decode throughput: call :meth:`tick` per token."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.times: list[float] = []

    def tick(self) -> None:
        self.times.append(time.perf_counter())

    def summary(self) -> dict:
        if not self.times:
            return {"tokens": 0}
        total = self.times[-1] - self.t0
        gaps = np.diff([self.t0] + self.times)
        return {
            "tokens": len(self.times),
            "tok_s": len(self.times) / total if total > 0 else float("inf"),
            "ttft_ms": (self.times[0] - self.t0) * 1e3,
            "p50_ms": float(np.median(gaps) * 1e3),
            "p99_ms": float(np.percentile(gaps, 99) * 1e3),
        }


def _short(name: str) -> str:
    name = name.replace("void ", "").replace("(anonymous namespace)::", "")
    return name.split("(")[0][:60]


def _union_ms(events) -> float:
    """The time covered by the union of the events' intervals, ms."""
    busy, end = 0.0, -math.inf
    for e in sorted(events, key=lambda e: e.time_range.start):
        s, f = e.time_range.start, e.time_range.end
        if f > end:
            busy += f - max(s, end)
            end = f
    return busy / 1e3


def profile_window(fn, sync) -> dict:
    """One call of ``fn`` under torch.profiler (host and device activity):
    wall ms, device busy ms (the union of the device activity intervals),
    the idle share, the number of device activities, the three names with
    the most device time, the device time of the flash decode kernels, of
    the quantized prefill kernels (qmm_prefill_kernel and its x pre-pass)
    and of the M <= 8 decode matmuls (gq, rq, i8), and the host time inside
    collectives (the union of the intervals of the host activities named
    all_reduce / allreduce, 0 outside tensor parallelism).  The profiler
    slows the host, so the idle share is an upper estimate."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        raise AssertionError("the profiler saw no device activity")
    per_name: dict[str, float] = {}
    for e in dev:
        n = _short(e.name)
        per_name[n] = per_name.get(n, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    busy_ms = _union_ms(dev)
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:3]
    coll = _union_ms(e for e in prof.events() if e.device_type == DeviceType.CPU
                     and ("allreduce" in e.name.lower() or "all_reduce" in e.name.lower()))
    flash = sum(ms for n, ms in per_name.items() if "flash_decode_kernel" in n)
    prefill = sum(ms for n, ms in per_name.items()
                  if "qmm_prefill_kernel" in n or "prefill_x_kernel" in n)
    decode = {f"{k}_decode_ms": sum(ms for n, ms in per_name.items() if f"{k}_decode" in n)
              for k in ("gq", "rq", "i8")}
    return dict(wall_ms=wall_ms, busy_ms=busy_ms, idle=1 - busy_ms / wall_ms, device_ops=len(dev),
                top=[(n, round(ms, 3)) for n, ms in top], collective_ms=coll,
                flash_ms=flash, prefill_ms=prefill, **decode)
