"""Build the port's CUDA kernels with nvcc and bind them through ctypes.

Each ``csrc/*.cu`` file compiles in its own nvcc process, all started
together, and one more nvcc call links the objects into
``build/kernels/libminigpt4_tpu_torch_kernels.so`` at the root of the
checkout, for ``sm_90a`` (Hopper).  The build is keyed by a SHA-256 of the
sources: an unchanged tree reuses the library, a changed one rebuilds it.
Nothing here runs at import time, so a machine without nvcc (the CPU test
runs) never needs it; the first CUDA launch calls :func:`load`.

The C entry points take ``void*`` pointers, ``int`` sizes and the CUDA
stream, launch on that stream without synchronising, allocate nothing and
return ``cudaGetLastError()``; :func:`check` turns a nonzero code into an
exception.  The ptxas register/shared-memory report of the last build is
kept in ``build/kernels/nvcc.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
LIB_NAME = "libminigpt4_tpu_torch_kernels.so"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# argument types of every entry point (ctypes would cut 64-bit pointers
# passed without them)
SIGNATURES = {
    "mgt_gq_decode": (_P,) * 8 + (_I,) * 5 + (_P,),
    "mgt_gq_prefill": (_P,) * 8 + (_I,) * 5 + (_P,),
    "mgt_gq_decode_generic": (_P,) * 6 + (_I,) * 6 + (_P,),
    "mgt_gq_prefill_generic": (_P,) * 6 + (_I,) * 6 + (_P,),
    "mgt_flash_decode": (_P,) * 6 + (_I,) * 6 + (_F, _I, _P),
    "mgt_flash_decode_paged": (_P,) * 6 + (_I,) * 7 + (_F, _I, _P),
    "mgt_rq_decode": (_P,) * 6 + (_I,) * 7 + (_P,),
    "mgt_rq_prefill": (_P,) * 6 + (_I,) * 7 + (_P,),
    "mgt_i8_decode": (_P,) * 4 + (_I,) * 4 + (_P,),
    "mgt_i8_prefill": (_P,) * 4 + (_I,) * 4 + (_P,),
    "mgt_probe_group_i8": (_P,) * 8 + (_I,) * 4 + (_P,),
    "mgt_probe_dequant_matvec": (_P,) * 5 + (_I,) * 8 + (_P,),
    "mgt_probe_int_dot": (_P,) * 4 + (_I,) * 4 + (_P,),
    "mgt_probe_op_chain": (_P,) * 3 + (_I,) * 6 + (_P,),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None  # nvcc wall time of this process's build


def source_hash(sources: list[Path] | None = None) -> str:
    """SHA-256 of ``sources`` (default: every ``csrc/*.cu``) and of the
    shared headers they may include."""
    h = hashlib.sha256()
    srcs = CSRC.glob("*.cu") if sources is None else sources
    for p in sorted(srcs) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME/bin: "
                       "the CUDA kernels cannot be built")


def build(sources: list[Path] | None = None, lib_name: str = LIB_NAME) -> Path:
    """Compile ``sources`` (default: the port's kernels, every
    ``csrc/*.cu``) into ``build/kernels/<lib_name>`` unless a library of the
    same sources exists; the shared headers of ``csrc/`` are on the include
    path.  Returns the library's path."""
    global build_seconds
    srcs = sorted(CSRC.glob("*.cu")) if sources is None else sorted(Path(p) for p in sources)
    digest = source_hash(srcs)
    lib = BUILD_DIR / lib_name
    stamp = BUILD_DIR / f"{lib_name}.sha256"
    if lib.exists() and stamp.exists() and stamp.read_text() == digest:
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    tmp = BUILD_DIR / f"{lib_name}.{tag}"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for src in srcs:
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for cmd, _, proc in jobs:
        out = proc.communicate()[0]
        log.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(out)
    objs = [str(obj) for _, obj, _ in jobs]
    if not failed:
        cmd = [nvcc, *ARCH, "-shared", "-o", str(tmp), *objs]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout)
        if proc.returncode != 0:
            failed.append(proc.stdout)
    build_seconds = time.perf_counter() - t0
    log_name = "nvcc.log" if lib_name == LIB_NAME else f"{lib_name}.nvcc.log"
    (BUILD_DIR / log_name).write_text("\n".join(log))
    for obj in objs:
        Path(obj).unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("nvcc failed:\n" + "\n".join(f[-6000:] for f in failed))
    os.replace(tmp, lib)  # atomic: a concurrent loader sees old or new
    stamp.write_text(digest)
    return lib


def load() -> ctypes.CDLL:
    """The kernel library, built on first use; raises if the build fails."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.mgt_error_string.argtypes = (ctypes.c_int,)
            lib.mgt_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def check(rc: int, kernel: str) -> None:
    if rc != 0:
        msg = load().mgt_error_string(rc).decode()
        raise RuntimeError(f"{kernel}: launch failed with CUDA error {rc} ({msg})")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
