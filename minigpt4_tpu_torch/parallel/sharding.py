"""Placement of the vision pipeline over a tensor-parallel group.

Counterpart of ``minigpt4_tpu/parallel/sharding.py``.  The JAX package
computes NamedSharding pytrees and lets XLA's auto-SPMD partitioner insert
the collectives; the port cuts this rank's shards itself and the model adds
the collectives (``models/eva_vit.block_forward`` with ``tp=``), as
``parallel/spmd.py`` does for the decoder.  Explicit shards and not DTensor:
DTensor redistributes through ``all_gather`` / ``reduce_scatter``, which
gloo lacks on CUDA tensors, and two ranks on one card run over gloo.

The rules, weight by weight (JAX's ``vit_param_shardings`` and
``_linear_sharding``):

  ViT blocks   qkv, fc1   column-parallel (this rank's output rows and bias;
                          the fused qkv interleaved first, so that a rank
                          holds [q | k | v] of its own heads)
               proj, fc2  row-parallel (this rank's K range; the bias is
                          added once, after the sum)
               norms      replicated
  patch embedding, cls token, position embedding   replicated
  ln_vision, Q-Former, llama_proj                  replicated

A weight stays whole on every rank where the rule cannot cut it: a
dimension that does not divide by tp (a fused qkv also needs whole heads
per rank in each part), a per-layer list of mixed formats, a repacked
weight in a row slot (JAX: no partitioning rule for the kernel there), a
packed-bytes ``QTensor`` whose K / tp is not a whole number of quant
blocks, and the forms JAX's rule has no case for (group-quant, w8a8).

The decoder's rules are ``spmd.placement`` / ``spmd.shard_llama_params``;
:func:`shard_params` applies both.
"""

from __future__ import annotations

import torch

from ..formats.dtypes import traits
from ..ops import quant_matmul as qm
from ..ops import repack as rp
from . import spmd
from .mesh import TPGroup

VIT_COL = ("qkv", "fc1")
VIT_ROW = ("proj", "fc2")


def vit_linear_kind(w, kind: str, tp: int, parts: int = 1, head_dim: int = 0) -> str:
    """Where a ViT weight of a ``kind`` slot ("col" or "row") goes under
    ``tp`` ranks: "col", "row" or "rep" (JAX's ``_linear_sharding``).
    ``parts`` / ``head_dim``: a fused projection splits only where each of
    its parts holds whole heads on every rank."""
    if tp == 1 or isinstance(w, list):
        return "rep"
    if isinstance(w, rp.RepackedQuant):
        n, k, ok_row = w.n_out, w.n_in, False
    elif isinstance(w, qm.QTensor):
        n, k = w.n_out, w.n_in
        ok_row = (w.packed.shape[-1] % tp == 0 and k % tp == 0
                  and (k // tp) % traits(w.dtype).block_elems == 0)
    elif isinstance(w, torch.Tensor):
        n, k = w.shape[-1], w.shape[-2]
        ok_row = k % tp == 0
    else:
        return "rep"  # group-quant, w8a8: no case in JAX's rule
    if kind == "row":
        return "row" if ok_row else "rep"
    if n % tp:
        return "rep"
    if parts > 1:
        per = n // parts
        if per % tp or (head_dim and (per // tp) % head_dim):
            return "rep"
    return "col"


def vit_placement(vit_params: dict, cfg, tp: int) -> dict:
    """{name: "col" | "row" | "rep"} for the four projections of the
    stacked ViT blocks."""
    blocks = vit_params["blocks"]
    out = {n: vit_linear_kind(blocks[n]["w"], "col", tp, 3 if n == "qkv" else 1,
                              cfg.head_dim if n == "qkv" else 0) for n in VIT_COL}
    out.update({n: vit_linear_kind(blocks[n]["w"], "row", tp) for n in VIT_ROW})
    return out


def _take_k_packed(w: qm.QTensor, rank: int, tp: int) -> qm.QTensor:
    """This rank's K range of a packed-bytes weight: its share of each
    row's blocks (whole blocks, :func:`vit_linear_kind`)."""
    rb = w.packed.shape[-1] // tp
    return qm.QTensor(w.packed[..., rank * rb:(rank + 1) * rb].contiguous(), w.dtype,
                      w.n_in // tp)


def _shard_linear(p: dict, kind: str, rank: int, tp: int, parts: int) -> dict:
    """A linear's {"w", "b"} cut for ``kind``: a column shard takes its
    bias rows (interleaved as the weight's), a row shard keeps the whole
    bias (added after the sum)."""
    if kind == "rep":
        return p
    w = p["w"]
    if kind == "row" and isinstance(w, qm.QTensor):
        return {**p, "w": _take_k_packed(w, rank, tp)}
    out = {**p, "w": spmd.shard_weight(w, kind, rank, tp, parts)}
    if kind == "col" and "b" in p:
        b = p["b"]  # [(L,) N]
        rows = spmd.fused_row_perm(b.shape[-1], parts, tp)
        n = b.shape[-1] // tp
        idx = torch.as_tensor(rows[rank * n:(rank + 1) * n], dtype=torch.long, device=b.device)
        out["b"] = b.index_select(b.dim() - 1, idx)
    return out


def shard_vit_params(vit_params: dict, cfg, group: TPGroup) -> dict:
    """This rank's ViT params (JAX's ``vit_param_shardings``): the four
    projections cut by :func:`vit_placement`, everything else shared with
    ``vit_params``."""
    kinds = vit_placement(vit_params, cfg, group.size)
    blocks = dict(vit_params["blocks"])
    for name, kind in kinds.items():
        blocks[name] = _shard_linear(blocks[name], kind, group.rank, group.size,
                                     3 if name == "qkv" else 1)
    return {**vit_params, "blocks": blocks}


def shard_vision_params(params: dict, cfg, group: TPGroup) -> dict:
    """This rank's vision params (JAX's ``vision_param_shardings``): the
    ViT's blocks split, ``ln_vision``, the Q-Former and ``llama_proj``
    replicated.  ``cfg`` is the ``VisionConfig``."""
    return {**params, "visual_encoder": shard_vit_params(params["visual_encoder"], cfg.vit,
                                                         group)}


def shard_params(vision_params: dict, vision_cfg, llm_params: dict,
                 group: TPGroup) -> tuple[dict, dict]:
    """Both halves of the model on this rank: (vision shards, decoder
    shards), the decoder by ``spmd.shard_llama_params``."""
    return (shard_vision_params(vision_params, vision_cfg, group),
            spmd.shard_llama_params(llm_params, group))
