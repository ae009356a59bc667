"""The launch counters of the kernel wrappers, in one registry.

Each wrapper that launches a kernel counts its launches in Python, where it
launches and nowhere else: ``launches`` on every wrapper, ``stats_launches``
on flash decode (its (m, l) form), ``packed_launches`` by packing on the gq
wrappers.  A captured CUDA graph runs no Python, so ``engine/graphs.py``
records a capture's deltas here and adds them on every replay;
``chip_smoke.py`` reads and resets the same counters.  A counted wrapper is
listed in :func:`wrappers` and nowhere else.
"""

from __future__ import annotations

from . import flash_decode as fd
from . import group_i8 as gq
from . import i8_matmul as i8
from . import pallas_quant_matmul as rq
from . import probes


def wrappers() -> dict:
    """{name: wrapper} of every counted kernel wrapper: the model's and the
    tools' probes."""
    return {"gq_decode": gq.gq_decode, "gq_prefill": gq.gq_prefill,
            "gq_decode_generic": gq.gq_decode_generic,
            "gq_prefill_generic": gq.gq_prefill_generic,
            "flash_decode": fd.flash_decode_attention,
            "paged_flash_decode": fd.paged_flash_decode_attention,
            "rq_decode": rq.rq_decode, "rq_prefill": rq.rq_prefill,
            "i8_decode": i8.i8_decode, "i8_prefill": i8.i8_prefill, **probes.WRAPPERS}


def counts() -> dict:
    """Every counter: {(wrapper name, attribute, packing or None): n}."""
    out = {}
    for name, f in wrappers().items():
        out[(name, "launches", None)] = f.launches
        if hasattr(f, "stats_launches"):
            out[(name, "stats_launches", None)] = f.stats_launches
        for packing, n in getattr(f, "packed_launches", {}).items():
            out[(name, "packed_launches", packing)] = n
    return out


def named() -> dict:
    """Every counter by one name: the wrapper's for ``launches``,
    ``<wrapper>[stats]`` for flash decode's (m, l) form and
    ``<wrapper>[<packing>]`` for a gq wrapper's packed launches (the names
    of ``chip_smoke.py``'s kernels line)."""
    out = {}
    for (name, attr, packing), n in counts().items():
        if attr == "launches":
            out[name] = n
        elif attr == "stats_launches":
            out[f"{name}[stats]"] = n
        else:
            out[f"{name}[{packing}]"] = n
    return out


def add(delta: dict, sign: int = 1) -> None:
    """Add ``sign`` times ``delta`` (keys of :func:`counts`) to the counters."""
    fs = wrappers()
    for (name, attr, packing), n in delta.items():
        f = fs[name]
        if packing is None:
            setattr(f, attr, getattr(f, attr) + sign * n)
        else:
            getattr(f, attr)[packing] += sign * n


def reset() -> None:
    """Set every counter to 0."""
    add({k: n for k, n in counts().items() if n}, -1)
