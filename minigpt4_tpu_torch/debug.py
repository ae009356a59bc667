"""Debug-by-dump tooling: per-stage intermediate capture for parity work.

Counterpart of ``minigpt4_tpu/debug.py``.  The reference's correctness
workflow was manual tensor diffing via a ``DUMP_TENSOR`` macro that computes
one intermediate, writes every value to ``out.txt`` and exits
(minigpt4.cpp:520-549).  Here every stage of the vision pipeline is
captured in one pass as named arrays, with the JAX package's stage names and
npz layout, so that a dump of the port and one of the JAX package (or of a
sharded encoder and a whole one) compare stage by stage and the first
diverging stage bisects a parity failure in one run.

Usage::

    from minigpt4_tpu_torch.debug import compare_dumps, dump_vision_stages, save_dump
    stages = dump_vision_stages(engine.vision_params, pixels, engine.vision_cfg)
    save_dump(stages, "dump_torch.npz")
    report = compare_dumps("dump_torch.npz", "dump_jax.npz")
"""

from __future__ import annotations

import numpy as np
import torch

from .models import eva_vit, qformer
from .models.layers import layer_norm
from .models.minigpt4 import LN_VISION_EPS, VisionConfig
from .models.params import linear
from .parallel.mesh import TPGroup


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def dump_vision_stages(params: dict, pixels: torch.Tensor, cfg: VisionConfig,
                       tp: TPGroup | None = None) -> dict[str, np.ndarray]:
    """Run encode_image stage by stage, returning named intermediates:
    patch_embed, embeddings (+cls +pos), vit_block_{i}, ln_vision,
    qformer_embed, qformer_layer_{i}, llama_proj.  ``pixels`` is a tensor
    on the params' device (or an array, moved there).  ``tp``: this rank's
    group, ``params`` then its shards (``parallel/sharding.py``); every
    stage is whole on every rank."""
    vit = params["visual_encoder"]
    if not isinstance(pixels, torch.Tensor):
        pixels = torch.as_tensor(np.asarray(pixels, np.float32),
                                 device=vit["pos_embed"].device)
    out: dict[str, np.ndarray] = {}
    with torch.no_grad():
        out["patch_embed"] = _np(eva_vit.patch_embed(pixels, vit["patch_embed"], cfg.vit))
        x = eva_vit.embeddings(vit, pixels, cfg.vit)
        out["embeddings"] = _np(x)
        for i in range(cfg.vit.depth):
            x = eva_vit.block_forward(x, vit["blocks"], cfg.vit, i, tp)
            out[f"vit_block_{i}"] = _np(x)
        x = layer_norm(x, params["ln_vision"], LN_VISION_EPS)
        out["ln_vision"] = _np(x)
        qf = params["qformer"]
        q = qf["query_tokens"].to(x.dtype)
        h = layer_norm(q.expand(x.shape[0], *q.shape), qf["ln_embed"], qformer.LN_EPS)
        out["qformer_embed"] = _np(h)
        for i, lp in enumerate(qf["layers"]):
            h = qformer.layer_forward(h, lp, cfg.qformer, x)
            out[f"qformer_layer_{i}"] = _np(h)
        out["llama_proj"] = _np(linear(h, params["llama_proj"]))
    return out


def save_dump(stages: dict[str, np.ndarray], path: str) -> None:
    np.savez_compressed(path, **stages)


def compare_dumps(path_a: str, path_b: str, rtol: float = 1e-4, atol: float = 1e-5) -> list[dict]:
    """Per-stage divergence report (in pipeline order): status "ok",
    "DIVERGED", "shape" or "missing-in-b", with the largest absolute
    difference and its share of max |b|."""
    a = np.load(path_a)
    b = np.load(path_b)
    report = []
    for name in a.files:
        if name not in b.files:
            report.append({"stage": name, "status": "missing-in-b"})
            continue
        x, y = a[name], b[name]
        if x.shape != y.shape:
            report.append({"stage": name, "status": "shape", "a": x.shape, "b": y.shape})
            continue
        diff = np.abs(x.astype(np.float64) - y.astype(np.float64))
        scale = np.abs(y).max() + 1e-12
        ok = np.allclose(x, y, rtol=rtol, atol=atol)
        report.append({"stage": name, "status": "ok" if ok else "DIVERGED",
                       "max_abs": float(diff.max()), "max_rel": float(diff.max() / scale)})
    return report


def first_divergence(report: list[dict]) -> dict | None:
    """The first stage of ``report`` that is not "ok", or None."""
    for r in report:
        if r["status"] != "ok":
            return r
    return None
