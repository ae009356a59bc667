"""Build the port's C ABI library with g++ alone, and C clients against it.

``libminigpt4_torch.so`` (``minigpt4_capi.cpp`` + ``minigpt4.h``) embeds
CPython, so it compiles against the running interpreter's headers and links
its shared libpython.  The flags come from ``sysconfig`` (``INCLUDEPY``,
``LIBDIR``, ``LDLIBRARY``, ``Py_ENABLE_SHARED``), not from cmake or
python3-config, which a machine may lack.  The library goes to
``build/capi_torch/`` at the root of the checkout and is rebuilt when its
sources or flags change (SHA-256 stamp).  An interpreter without a shared
libpython cannot host it: the build then fails and says so.

A C program that loads the library starts its own interpreter, which must
find the port and the packages the running interpreter sees (torch, numpy):
:func:`client_env` gives it that ``PYTHONPATH`` and the library path.

    python -m minigpt4_tpu_torch.c_api._build             # the library
    python -m minigpt4_tpu_torch.c_api._build main.c out  # and a C client
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sys
import sysconfig
from pathlib import Path

C_API = Path(__file__).resolve().parent
ROOT = C_API.parents[1]
BUILD_DIR = ROOT / "build" / "capi_torch"
LIB_NAME = "libminigpt4_torch.so"
SOURCES = (C_API / "minigpt4_capi.cpp", C_API / "minigpt4.h")


def python_link_flags() -> list[str]:
    """g++ flags that compile against this interpreter and link its shared
    libpython; raises RuntimeError where there is none."""
    cfg = sysconfig.get_config_vars()
    ldlib = cfg.get("LDLIBRARY") or ""
    if not cfg.get("Py_ENABLE_SHARED") or not ldlib.endswith(".so"):
        raise RuntimeError(
            f"{sys.executable} has no shared libpython (Py_ENABLE_SHARED="
            f"{cfg.get('Py_ENABLE_SHARED')}, LDLIBRARY={ldlib!r}): the C ABI library embeds "
            "the interpreter and needs one")
    libdir = cfg["LIBDIR"]
    return [f"-I{cfg['INCLUDEPY']}", f"-L{libdir}", f"-Wl,-rpath,{libdir}",
            f"-l{ldlib[3:-3]}"]


def build() -> Path:
    """``build/capi_torch/libminigpt4_torch.so``, compiled unless a library
    of the same sources and flags exists.  Returns its path."""
    cmd = ["g++", "-std=c++17", "-O2", "-fPIC", "-shared", f"-I{C_API}", str(SOURCES[0]),
           *python_link_flags()]
    h = hashlib.sha256(" ".join(cmd).encode())
    for p in SOURCES:
        h.update(p.read_bytes())
    lib, stamp = BUILD_DIR / LIB_NAME, BUILD_DIR / f"{LIB_NAME}.sha256"
    if lib.exists() and stamp.exists() and stamp.read_text() == h.hexdigest():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{LIB_NAME}.{os.getpid()}.tmp"
    proc = subprocess.run([*cmd, "-o", str(tmp)], capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed building {LIB_NAME}:\n{proc.stderr[-6000:]}")
    os.replace(tmp, lib)  # a concurrent loader sees the old or the new library
    stamp.write_text(h.hexdigest())
    return lib


def compile_client(source: str | Path, out: str | Path) -> Path:
    """Compile and link the C program ``source`` against the library (its
    header is this directory's ``minigpt4.h``); the program finds the
    library through its run path."""
    lib = build()
    cmd = ["gcc", str(source), f"-I{C_API}", f"-L{lib.parent}", "-lminigpt4_torch",
           f"-Wl,-rpath,{lib.parent}", "-o", str(out)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"gcc failed building {source}:\n{proc.stderr[-6000:]}")
    return Path(out)


def client_env(env: dict | None = None) -> dict:
    """``env`` (default: this process's) with what a C program's embedded
    interpreter needs: the checkout and this interpreter's package
    directories on ``PYTHONPATH``, the library's directory on
    ``LD_LIBRARY_PATH``."""
    env = dict(os.environ if env is None else env)
    paths = sysconfig.get_paths()
    entries = [str(ROOT), paths["purelib"], paths["platlib"]]
    if env.get("PYTHONPATH"):
        entries.append(env["PYTHONPATH"])
    env["PYTHONPATH"] = os.pathsep.join(dict.fromkeys(entries))
    env["LD_LIBRARY_PATH"] = os.pathsep.join(
        p for p in (str(BUILD_DIR), env.get("LD_LIBRARY_PATH")) if p)
    return env


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    print(build())
    if len(argv) == 2:
        print(compile_client(*argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
