"""Tensor-parallel process groups and the collectives of the port.

Counterpart of ``minigpt4_tpu/parallel/mesh.py``.  The JAX package runs one
controller over a (dp, tp) device mesh and writes its collectives inside
``shard_map``; the port runs one process per rank, every rank the same
program on its own shards, with the collectives inline where the JAX
package has them.  ``dp`` stays 1 (the engine refuses anything else, as
the JAX engine does), so a group is the tp axis alone.

Every collective is an ``all_reduce`` (SUM or MAX): JAX's tiled
``all_gather`` is a SUM of a zero-filled full-width buffer in which each
rank writes its own slice (exact: every element is one rank's value plus
zeros).  That keeps one code path on the three transports the port meets:
NCCL where each rank has its own card, gloo on CPU tensors, and gloo where
ranks share one card (NCCL refuses two ranks on one GPU; gloo takes CUDA
tensors for ``all_reduce`` and ``broadcast`` only, staging them through the
host).  :func:`init_tp` chooses the transport from the ranks' devices and
prints it; it never changes a rank's device.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass
from datetime import timedelta

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class TPGroup:
    """One rank's view of its tensor-parallel group."""

    rank: int
    size: int
    group: object  # the torch.distributed process group
    device: torch.device  # this rank's device
    backend: str  # "nccl" or "gloo"


def rank_device(rank: int, device: str | torch.device) -> torch.device:
    """Rank r's device: ``cuda:{r % device_count}`` for "cuda", the CPU
    only where the caller names it."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"tensor parallelism runs on cuda or cpu, not {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError("tensor parallelism on cuda: torch.cuda.is_available() is false "
                           "(pass device='cpu' to run the ranks on the CPU)")
    return torch.device("cuda", rank % torch.cuda.device_count())


def backend_for(tp: int, device: str | torch.device) -> str:
    """gloo on the CPU and where ranks share a card, NCCL where each rank
    has a card of its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= tp:
        return "nccl"
    return "gloo"


def init_tp(tp: int, device: str | torch.device = "cuda", init_method: str | None = None,
            rank: int | None = None, timeout_s: float = 300.0) -> TPGroup:
    """This process's rank of a ``tp``-rank group.

    Takes the default process group where the caller has made one;
    otherwise creates it from ``init_method`` and ``rank`` (for example
    ``file://`` or ``tcp://localhost:<port>`` rendezvous), or from the
    ``torchrun`` environment (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
    ``WORLD_SIZE``), printing the transport it chose.  The group's size
    must be ``tp``.  ``timeout_s`` bounds every collective, so a rank whose
    peer died fails instead of waiting forever."""
    if tp < 1:
        raise ValueError(f"tp={tp}: needs at least one rank")
    if not dist.is_initialized():
        if rank is None:
            rank = int(os.environ.get("RANK", "0"))
        backend = backend_for(tp, device)
        dev = rank_device(rank, device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=init_method or "env://", world_size=tp,
                                rank=rank, timeout=timedelta(seconds=timeout_s))
        print(f"[tp] rank {rank} of {tp}: backend {backend}, device {dev}", file=sys.stderr,
              flush=True)
    if dist.get_world_size() != tp:
        raise ValueError(f"tp={tp} but the process group has {dist.get_world_size()} ranks")
    rank = dist.get_rank()
    return TPGroup(rank=rank, size=tp, group=dist.group.WORLD, device=rank_device(rank, device),
                   backend=str(dist.get_backend()))


def psum(t: torch.Tensor, g: TPGroup) -> torch.Tensor:
    """Sum of ``t`` over the ranks (``t`` is reduced in place and returned)."""
    t = t.contiguous()
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=g.group)
    return t


def pmax(t: torch.Tensor, g: TPGroup) -> torch.Tensor:
    """Elementwise maximum of ``t`` over the ranks (in place, returned)."""
    t = t.contiguous()
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=g.group)
    return t


def all_gather_tiled(x: torch.Tensor, g: TPGroup) -> torch.Tensor:
    """JAX's ``all_gather(x, axis=-1, tiled=True)``: the ranks' x [..., n]
    side by side in rank order, [..., n * size], on every rank."""
    n = x.shape[-1]
    full = torch.zeros((*x.shape[:-1], n * g.size), dtype=x.dtype, device=x.device)
    full[..., g.rank * n:(g.rank + 1) * n] = x
    return psum(full, g)
