"""Placement of the decoder over a tensor-parallel group.

Counterpart of ``minigpt4_tpu/parallel/spmd.py``, with the JAX package's
decisions, weight by weight (``llama_param_specs``):

  wqkv / w13 / wq wk wv w1 w3   column-parallel (this rank's output rows;
                                 fused ones interleaved first so a rank
                                 holds its own [q | k | v] or [gate | up])
  wo / w2                       row-parallel (this rank's K range, the
                                 output summed over the ranks after)
  output                        vocab-parallel (this rank's vocabulary
                                 rows, gathered after)
  KV cache and page pools       heads over the ranks
  norms, embeddings             replicated

A weight the rule cannot split evenly stays whole on every rank
(replicated), as a per-layer list of mixed formats does.  Where the JAX
package computes a PartitionSpec and lets ``shard_map`` cut the arrays,
:func:`shard_llama_params` cuts this rank's shards itself; the model
(``models/llama.py``) finds the local widths from the arrays, and its
``_row_linear`` adds the collectives.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import group_i8 as gq
from ..ops import i8_matmul as i8
from ..ops import quant_matmul as qm
from ..ops import repack as rp
from .mesh import TPGroup

ROW_PARALLEL = ("wo", "w2")
COL_PARALLEL = ("wqkv", "wq", "wk", "wv", "w13", "w1", "w3")
FUSED_PARTS = {"wqkv": 3, "w13": 2}
ATTENTION = ("wqkv", "wq", "wk", "wv")


def _n_out(w) -> int:
    return w.n_out if isinstance(w, (rp.RepackedQuant, qm.QTensor, i8.I8SBQuant)) else w.shape[-1]


def fused_col_ok(w, parts: int, tp: int) -> bool:
    """JAX's ``_fused_col_ok``: a fused projection is column-sharded only
    where each part divides over tp into an even number of rows."""
    n = _n_out(w)
    if n % parts:
        return False
    per = n // parts
    return per % tp == 0 and (per // tp) % 2 == 0


def linear_kind(w, kind: str, tp: int) -> str:
    """Where weight ``w`` of a ``kind`` ("col", "row" or "rep") slot goes
    under ``tp`` ranks: "col", "row" or "rep", by JAX's ``_linear_specs``.
    A GroupQuant has no placement (the JAX package cannot place one)."""
    if isinstance(w, list):
        return "rep"  # mixed per-layer formats
    if isinstance(w, gq.GroupQuant):
        raise ValueError("a group-quant (gq) weight cannot be placed over tensor-parallel ranks: "
                         "the JAX package cannot place one either")
    if isinstance(w, rp.RepackedQuant):
        if kind == "col" and w.n_out % (2 * tp) == 0:
            return "col"
        if kind == "row" and w.n_in % (tp * w.group_size) == 0:
            return "row"  # JAX: k-sharded by with_k_shards, then a tp axis on K
        return "rep"
    if isinstance(w, i8.I8SBQuant):
        if kind == "col" and w.n_out % tp == 0:
            return "col"
        if kind == "row" and w.codes.shape[-1] % (tp * i8.SB) == 0:
            return "row"
        return "rep"
    if isinstance(w, qm.QTensor):
        return "col" if kind == "col" and w.n_out % tp == 0 else "rep"
    if kind == "col" and w.shape[-1] % tp == 0:
        return "col"
    if kind == "row" and w.shape[-2] % tp == 0:
        return "row"
    return "rep"


def placement(params: dict, tp: int) -> dict:
    """{name: "col" | "row" | "rep"} for every projection of the decoder's
    layers and for "output" (JAX's ``llama_param_specs``)."""
    out = {}
    for name, val in params["layers"].items():
        if name in COL_PARALLEL:
            w = val["w"]
            fused_rep = (name in FUSED_PARTS and not isinstance(w, list)
                         and not fused_col_ok(w, FUSED_PARTS[name], tp))
            out[name] = "rep" if fused_rep else linear_kind(w, "col", tp)
        elif name in ROW_PARALLEL:
            out[name] = linear_kind(val["w"], "row", tp)
    out["output"] = linear_kind(params["output"]["w"], "col", tp)
    return out


def fused_row_perm(n: int, parts: int, tp: int) -> np.ndarray:
    """JAX's ``_interleave_fused_rows`` order: output rows [part0 | part1 |
    ...] -> [part0_s0, part1_s0, ..., part0_s1, ...], so that rank s's
    contiguous block of n / tp rows is its [q_s | k_s | v_s] (or
    [gate_s | up_s]).  perm[target_row] = source_row."""
    part = n // parts
    sl = part // tp
    return np.concatenate([np.arange(pi * part + s * sl, pi * part + (s + 1) * sl)
                           for s in range(tp) for pi in range(parts)])


def _take_rows(w, rows: np.ndarray):
    """Output rows ``rows`` of a weight of any form (copies)."""
    def take(t: torch.Tensor, dim: int = -2) -> torch.Tensor:
        return t.index_select(dim, torch.as_tensor(rows, dtype=torch.long, device=t.device))

    if isinstance(w, rp.RepackedQuant):
        return w._replace(**{k: take(t) for k, t in w.tensors().items()})
    if isinstance(w, i8.I8SBQuant):
        return i8.I8SBQuant(take(w.codes), take(w.scales), w.n_in)
    if isinstance(w, qm.QTensor):
        return qm.QTensor(take(w.packed), w.dtype, w.n_in)
    return take(w, -1)  # dense [(L,) K, N]


def _take_k(w, rank: int, tp: int):
    """This rank's contiguous K range of a weight of any form (copies)."""
    if isinstance(w, rp.RepackedQuant):
        return rp.k_slice(w, rank, tp)
    if isinstance(w, i8.I8SBQuant):
        k = w.codes.shape[-1] // tp
        return i8.I8SBQuant(w.codes[..., rank * k:(rank + 1) * k].contiguous(),
                            w.scales[..., rank * k // i8.SB:(rank + 1) * k // i8.SB].contiguous(),
                            k)
    k = w.shape[-2] // tp  # dense [(L,) K, N]
    return w[..., rank * k:(rank + 1) * k, :].contiguous()


def shard_weight(w, kind: str, rank: int, tp: int, parts: int = 1):
    """Rank ``rank``'s shard of a weight placed as ``kind`` ("rep" returns
    ``w`` itself); ``parts`` > 1 interleaves a fused projection's rows."""
    if kind == "rep":
        return w
    if kind == "row":
        return _take_k(w, rank, tp)
    n = _n_out(w)
    perm = fused_row_perm(n, parts, tp) if parts > 1 else np.arange(n)
    return _take_rows(w, perm[rank * n // tp:(rank + 1) * n // tp])


def check_placeable(params: dict, tp: int) -> dict:
    """The placement of ``params`` over ``tp`` ranks, or ValueError where an
    attention projection would stay whole (its heads would not match the
    rank's cache heads; the JAX package fails there too)."""
    kinds = placement(params, tp)
    whole = [n for n in ATTENTION if kinds.get(n) == "rep"]
    if whole:
        raise ValueError(
            f"tp={tp}: the attention projections {whole} cannot be split by heads (a per-layer "
            "list of mixed formats, or rows that do not divide), so their heads would not match "
            "the rank's KV-cache heads; the JAX package cannot run this placement either. "
            "Files whose wq/wk/wv share one format per name split (dense, repack, w8a8, qtensor)")
    return kinds


def shard_llama_params(params: dict, group: TPGroup) -> dict:
    """This rank's decoder params: the projections cut by
    :func:`placement`, everything else shared with ``params``."""
    tp, rank = group.size, group.rank
    kinds = check_placeable(params, tp)
    layers = dict(params["layers"])
    for name, kind in kinds.items():
        if name == "output":
            continue
        layers[name] = {**layers[name], "w": shard_weight(layers[name]["w"], kind, rank, tp,
                                                          FUSED_PARTS.get(name, 1))}
    out = {**params, "layers": layers}
    out["output"] = {**params["output"],
                     "w": shard_weight(params["output"]["w"], kinds["output"], rank, tp)}
    return out


def cache_cfg(cfg, tp: int):
    """The config that sizes one rank's KV cache (``llama.init_cache``) and
    page pools (``PagedKVPool``): n_head / tp heads of the same head dim
    (JAX's ``cache_specs`` / ``pool_specs``).  Only for sizing caches: the
    model runs on the full config."""
    if tp == 1:
        return cfg
    return dataclasses.replace(cfg, n_embd=cfg.n_embd // tp, n_head=cfg.n_head // tp)
