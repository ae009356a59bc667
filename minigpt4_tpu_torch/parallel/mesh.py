"""Tensor-parallel process groups and the collectives of the port.

Counterpart of ``minigpt4_tpu/parallel/mesh.py``.  The JAX package runs one
controller over a (dp, tp) device mesh and writes its collectives inside
``shard_map``; the port runs one process per rank, every rank the same
program on its own shards, with the collectives inline where the JAX
package has them.  The engine runs at ``dp`` = 1 (it refuses anything
else, as the JAX engine does), so its group is the tp axis alone;
:func:`make_mesh` lays a world of dp x tp ranks out as JAX's ``make_mesh``
does, for the training step (``train/projection.py``).

Every collective is an ``all_reduce`` (SUM or MAX): JAX's tiled
``all_gather`` is a SUM of a zero-filled full-width buffer in which each
rank writes its own slice (exact: every element is one rank's value plus
zeros).  That keeps one code path on the three transports the port meets:
NCCL where each rank has its own card, gloo on CPU tensors, and gloo where
ranks share one card (NCCL refuses two ranks on one GPU; gloo takes CUDA
tensors for ``all_reduce`` and ``broadcast`` only, staging them through the
host).  :func:`init_tp` chooses the transport from the ranks' devices and
prints it; it never changes a rank's device.

The in-place collectives are not differentiable.  Under autograd the
decoder and the vision encoder use Megatron's pair instead
(:func:`copy_to_tp`, :func:`reduce_from_tp`): identity one way and a sum
over the ranks the other, so that the gradient of a replicated input of a
column-parallel linear is the sum of the ranks' partial gradients.
"""

from __future__ import annotations

import os
import sys
import time
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


@dataclass(frozen=True)
class Mesh:
    """One rank's view of a (dp, tp) layout of dp x tp ranks: rank r sits at
    (r // tp, r % tp), as JAX's ``make_mesh`` reshapes its devices."""

    dp: int
    tp: int
    dp_rank: int
    tp_group: TPGroup  # this rank's tp ranks (the same dp index)
    dp_group: object  # this rank's dp ranks (the same tp index), a process group

    @property
    def device(self) -> torch.device:
        return self.tp_group.device


def make_mesh(dp: int, tp: int, device: str | torch.device = "cuda",
              init_method: str | None = None, rank: int | None = None,
              timeout_s: float = 300.0) -> Mesh:
    """This rank's (dp, tp) mesh over a world of dp * tp ranks (the default
    group, made as :func:`init_tp` makes it where there is none).  Every rank
    makes every group (``dist.new_group`` is collective), in one order."""
    if dp < 1 or tp < 1:
        raise ValueError(f"dp={dp}, tp={tp}: needs at least one rank on each axis")
    world = init_tp(dp * tp, device, init_method=init_method, rank=rank, timeout_s=timeout_s)
    timeout = timedelta(seconds=timeout_s)
    tp_groups = [dist.new_group(list(range(i * tp, (i + 1) * tp)), timeout=timeout)
                 for i in range(dp)]
    dp_groups = [dist.new_group(list(range(j, dp * tp, tp)), timeout=timeout)
                 for j in range(tp)]
    r = world.rank
    tg = TPGroup(rank=r % tp, size=tp, group=tp_groups[r // tp], device=world.device,
                 backend=world.backend)
    return Mesh(dp=dp, tp=tp, dp_rank=r // tp, tp_group=tg, dp_group=dp_groups[r % tp])


# host seconds inside this process's tp all-reduces and their number, over
# all threads (``profiling.collective_seconds`` reads them); a gloo
# all-reduce returns when it is done, an NCCL one when it is queued
COLLECTIVES = {"s": 0.0, "calls": 0}


def _all_reduce(t: torch.Tensor, op, g: TPGroup) -> torch.Tensor:
    t = t.contiguous()
    t0 = time.perf_counter()
    dist.all_reduce(t, op=op, group=g.group)
    COLLECTIVES["s"] += time.perf_counter() - t0
    COLLECTIVES["calls"] += 1
    return t


def psum(t: torch.Tensor, g: TPGroup) -> torch.Tensor:
    """Sum of ``t`` over the ranks (``t`` is reduced in place and returned)."""
    return _all_reduce(t, dist.ReduceOp.SUM, g)


def pmax(t: torch.Tensor, g: TPGroup) -> torch.Tensor:
    """Elementwise maximum of ``t`` over the ranks (in place, returned)."""
    return _all_reduce(t, dist.ReduceOp.MAX, g)


def all_gather_tiled(x: torch.Tensor, g: TPGroup) -> torch.Tensor:
    """JAX's ``all_gather(x, axis=-1, tiled=True)``: the ranks' x [..., n]
    side by side in rank order, [..., n * size], on every rank.  Under
    autograd (:func:`reduce_from_tp` of the zero-padded slice) each rank's
    gradient is its own slice of the whole one."""
    n = x.shape[-1]
    if _differentiable(x):
        pad = (g.rank * n, (g.size - 1 - g.rank) * n)
        return reduce_from_tp(torch.nn.functional.pad(x, pad), g)
    full = torch.zeros((*x.shape[:-1], n * g.size), dtype=x.dtype, device=x.device)
    full[..., g.rank * n:(g.rank + 1) * n] = x
    return psum(full, g)


class _CopyToTP(torch.autograd.Function):
    """Identity forward; the gradient summed over the ranks backward."""

    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return psum(grad.clone(), ctx.g), None


class _ReduceFromTP(torch.autograd.Function):
    """Sum over the ranks forward; the gradient as it is backward (every
    rank holds the whole gradient of a replicated output)."""

    @staticmethod
    def forward(ctx, x, g):
        return psum(x.clone(), g)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _differentiable(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


def copy_to_tp(x: torch.Tensor, g: TPGroup | None) -> torch.Tensor:
    """Megatron's ``f``: the replicated input of a column-parallel linear.
    Identity; under autograd its gradient is summed over the ranks (each
    rank's columns give a partial gradient).  Outside autograd it returns
    ``x`` itself."""
    if g is None or not _differentiable(x):
        return x
    return _CopyToTP.apply(x, g)


def reduce_from_tp(x: torch.Tensor, g: TPGroup) -> torch.Tensor:
    """Megatron's ``g``: the sum of ``x`` over the ranks (a row-parallel
    output, or the zero-filled buffer of a tiled gather).  Outside autograd
    it is :func:`psum` in place; under autograd a new tensor whose gradient
    passes through unchanged."""
    if not _differentiable(x):
        return psum(x, g)
    return _ReduceFromTP.apply(x, g)

