"""Paged KV cache pool for batched serving.

Counterpart of ``minigpt4_tpu/engine/paged.py``.  Lanes of a batched decode
group own 128-position pages of one shared pool, for the positions they
have consumed, instead of a full ``session_ctx`` reservation each.

Layout: pools ``k``/``v`` are [L, NP + 1, H, PAGE, Dh]; a lane's logical
positions [p * PAGE, (p + 1) * PAGE) live in pool page ``table[p]``.  The
paged flash-decode kernel (``ops/flash_decode.paged_flash_decode_attention``)
reads keys through the table and single-token decode writes go through the
same table (``models/llama._layer``).

The last pool page (``trash_page``) is a shared write sink that is never
allocated: table slots a lane does not own point there, so a finished lane
decoding past its useful length (batched groups let it overshoot and roll
back) writes into a page nothing trusts instead of a neighbour's history.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.llama import _bits
from .hostcopy import copy_from_host_

PAGE = 128  # positions per page == the paged kernel's page (csrc kPage)


class PoolExhausted(RuntimeError):
    """No free pages left: callers stop or shrink the group, or retry later."""


class PagedKVPool:
    """Shared KV page pool and free-list allocator.

    ``n_pages`` counts usable pages (one trash page is added on top).
    ``capacity`` is the per-lane logical limit (table width x PAGE, not
    counting the trash slot); it equals the owner's ``session_ctx``.  Under
    tensor parallelism ``cfg`` is ``parallel.spmd.cache_cfg``'s: a rank's
    pools hold its heads; the page ids are the same on every rank."""

    def __init__(self, cfg, n_pages: int, capacity: int, dtype: torch.dtype = torch.bfloat16,
                 device: str | torch.device = "cuda"):
        if capacity % PAGE:
            raise ValueError(f"capacity {capacity} must be a multiple of {PAGE}")
        self.cfg = cfg
        self.capacity = capacity
        self.maxp = capacity // PAGE
        self.n_pages = n_pages
        shape = (cfg.n_layer, n_pages + 1, cfg.n_head, PAGE, cfg.head_dim)
        self.k = torch.zeros(shape, dtype=dtype, device=device)
        self.v = torch.zeros(shape, dtype=dtype, device=device)
        self.trash_page = n_pages  # reserved write sink (never allocated)
        self._free = list(range(n_pages))
        self._allocated: set[int] = set()
        # a failed copy into or out of the pool leaves its contents unknown;
        # the owner then retires the pool and serves dense groups until every
        # page has drained out of it (engine/sessions.py)
        self.broken = False

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def allocated_pages(self) -> int:
        return len(self._allocated)

    def pages_for(self, n_positions: int) -> int:
        """Pages needed to cover ``n_positions`` consumed positions."""
        return max(1, -(-n_positions // PAGE))

    def alloc(self, n: int) -> list[int]:
        if n > len(self._free):
            raise PoolExhausted(f"need {n} pages, {len(self._free)} free (of {self.n_pages})")
        got, self._free = self._free[:n], self._free[n:]
        self._allocated.update(got)
        return got

    def free(self, pages: list[int]) -> None:
        """Return pages to the free list.  Pages not currently allocated are
        rejected: a double free would hand one page to two lanes, whose
        decode writes would silently clobber each other's history."""
        for p in pages:
            if p not in self._allocated:
                raise ValueError(f"page {p} is not allocated (double free?)")
        for p in pages:
            self._allocated.discard(p)
        self._free.extend(pages)

    def _ids(self, pages: list[int]) -> torch.Tensor:
        return torch.tensor(pages, dtype=torch.long).to(self.k.device)

    def admit(self, dense_cache: dict, n_past: int) -> list[int]:
        """Copy a lane's dense cache [L, 1, H, C, Dh], trimmed to its first
        ``n_past`` positions rounded up to whole pages, into freshly
        allocated pages (one indexed copy per pool); returns the page ids.
        The caller drops its dense cache afterwards: the pool copy is the
        live one until :meth:`evict`."""
        n = self.pages_for(n_past)
        pages = self.alloc(n)
        try:
            ids = self._ids(pages)
            for pool, lane in ((self.k, dense_cache["k"]), (self.v, dense_cache["v"])):
                l, _, h, _, dh = lane.shape
                blocks = lane[:, 0, :, :n * PAGE].reshape(l, h, n, PAGE, dh).transpose(1, 2)
                pool[:, ids] = blocks.to(pool.dtype)
        except Exception:
            self.broken = True
            self.free(pages)
            raise
        return pages

    def admit_host(self, parked: dict, n_past: int) -> list[int]:
        """Copy a parked lane (``DecodeState.parked``: the bits of rows [0,
        n_past) in host memory) into freshly allocated pages; returns the
        page ids.  Only the parked rows cross to the device; the rest of the
        last page is zeros, as :meth:`admit` leaves it from a dense cache
        past its cursor.  The caller drops the parked copy afterwards."""
        if parked["dtype"] != self.k.dtype:
            raise ValueError(f"parked cache {parked['dtype']} != pool {self.k.dtype}")
        n = self.pages_for(n_past)
        pages = self.alloc(n)
        try:
            ids = self._ids(pages)
            for pool, rows in ((self.k, parked["k"]), (self.v, parked["v"])):
                l, _, h, m, dh = rows.shape
                lane = torch.zeros((l, h, n * PAGE, dh), dtype=rows.dtype, device=pool.device)
                copy_from_host_(lane[:, :, :m], rows[:, 0])
                _bits(pool)[:, ids] = lane.reshape(l, h, n, PAGE, dh).transpose(1, 2)
        except Exception:
            self.broken = True
            self.free(pages)
            raise
        return pages

    def extend(self, pages: list[int], needed_positions: int) -> list[int]:
        """Grow a lane's page list to cover ``needed_positions``; returns the
        (possibly unchanged) list.  Raises :class:`PoolExhausted` when the
        pool is dry: the caller stops the group and detaches."""
        want = self.pages_for(needed_positions)
        if want > self.maxp:
            raise ValueError(f"lane needs {want} pages > per-lane capacity {self.maxp}")
        if want > len(pages):
            pages = pages + self.alloc(want - len(pages))
        return pages

    def table_row(self, pages: list[int]) -> np.ndarray:
        """[MAXP + 1] i32 table row: the lane's pages, then trash slots.

        The trailing slot is load-bearing: a finished lane overshooting its
        capacity indexes the table at ``pos // PAGE >= MAXP``, which the
        decode write clamps to the last slot, always the trash page, even
        for a lane that holds all MAXP real pages."""
        row = np.full((self.maxp + 1,), self.trash_page, np.int32)
        row[: len(pages)] = pages
        return row

    def evict(self, pages: list[int], n_ctx: int) -> dict:
        """Gather a lane's pages back into a dense [L, 1, H, n_ctx, Dh] cache
        and free the pages (detach path).  The pages are freed even when the
        gather fails; ``free``'s allocated-set check keeps a repeated call
        from freeing them twice."""
        try:
            ids = self._ids(pages)
            out = {}
            for kv, pool in (("k", self.k), ("v", self.v)):
                l, _, h, page, dh = pool.shape
                dense = torch.zeros((l, 1, h, n_ctx, dh), dtype=pool.dtype, device=pool.device)
                n = len(pages)
                dense[:, 0, :, :n * page] = pool[:, ids].transpose(1, 2).reshape(l, h, n * page, dh)
                out[kv] = dense
        finally:
            self.free(pages)
        return out
