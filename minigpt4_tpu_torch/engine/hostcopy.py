"""Copies of KV rows between the card and pageable host memory.

Parked sessions (``DecodeState.park``) and the radix prefix cache's entries
(``SessionPool.capture_prefix``) keep their rows in ordinary, pageable host
memory, as the JAX package keeps them in numpy: many idle sessions may hold
gigabytes the OS must stay free to swap.  The link runs at its full rate
only from page-locked memory, so every such copy goes through one staging
area of two page-locked buffers of ``STAGE_BYTES`` each, reused by every copy
of the process: the card fills one buffer while the host empties the other.
Page-locked memory stays bounded at 2 x ``STAGE_BYTES``.
"""

from __future__ import annotations

import threading

import torch

STAGE_BYTES = 32 << 20


def _pieces(dst: torch.Tensor, src: torch.Tensor, limit: int):
    """(dst, src) slice pairs along the leading dimensions, each of at most
    ``limit`` bytes (a single element's row may exceed it only where the
    last dimension alone does)."""
    nbytes = src.numel() * src.element_size()
    if src.dim() == 0 or nbytes <= limit:
        yield dst, src
        return
    row = nbytes // src.shape[0]
    if row > limit and src.dim() > 1:
        for i in range(src.shape[0]):
            yield from _pieces(dst[i], src[i], limit)
        return
    per = max(1, limit // row)
    for i in range(0, src.shape[0], per):
        yield dst[i:i + per], src[i:i + per]


class _Stage:
    """The two page-locked buffers and the copies through them."""

    def __init__(self, nbytes: int):
        self.nbytes = nbytes
        self._lock = threading.Lock()
        self._bufs: list[torch.Tensor] | None = None
        self._read: list[torch.cuda.Event | None] = [None, None]  # H2D reading a buffer

    def _view(self, b: int, like: torch.Tensor) -> torch.Tensor:
        n = like.numel() * like.element_size()
        return self._bufs[b][:n].view(like.dtype).view(like.shape)

    def copy_(self, dst: torch.Tensor, src: torch.Tensor) -> None:
        """``dst.copy_(src)`` where one side is on the card and the other in
        host memory; returns once ``dst`` holds the rows."""
        if src.numel() == 0:
            return
        with self._lock:
            if self._bufs is None:
                self._bufs = [torch.empty(self.nbytes, dtype=torch.uint8, pin_memory=True)
                              for _ in range(2)]
            card = src.device if src.is_cuda else dst.device
            stream = torch.cuda.current_stream(card)
            pending = None  # D2H: (host slice, filled buffer, its event)
            for j, (d, s) in enumerate(_pieces(dst, src, self.nbytes)):
                b = j % 2
                if self._read[b] is not None:
                    self._read[b].synchronize()
                    self._read[b] = None
                buf = self._view(b, s)
                ev = torch.cuda.Event()
                if src.is_cuda:
                    buf.copy_(s, non_blocking=True)
                    ev.record(stream)
                    if pending is not None:  # empty the other buffer meanwhile
                        pending[2].synchronize()
                        pending[0].copy_(pending[1])
                    pending = (d, buf, ev)
                else:
                    buf.copy_(s)
                    d.copy_(buf, non_blocking=True)
                    ev.record(stream)
                    self._read[b] = ev
            if pending is not None:
                pending[2].synchronize()
                pending[0].copy_(pending[1])
            for b, ev in enumerate(self._read):
                if ev is not None:
                    ev.synchronize()
                    self._read[b] = None


_STAGE = _Stage(STAGE_BYTES)


def host_copy(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` in pageable host memory (from the card
    through the staging buffers); never a view of ``t``, also where ``t`` is
    on the CPU."""
    out = torch.empty(t.shape, dtype=t.dtype)
    if t.is_cuda:
        _STAGE.copy_(out, t)
    else:
        out.copy_(t)
    return out


def copy_from_host_(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.copy_(src)`` for ``src`` in host memory, through the staging
    buffers where ``dst`` is on the card; ``dst`` may be a strided view (a
    cache's leading rows)."""
    if dst.is_cuda:
        _STAGE.copy_(dst, src)
    else:
        dst.copy_(src)
