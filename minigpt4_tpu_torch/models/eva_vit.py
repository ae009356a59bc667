"""EVA-CLIP ViT-G visual encoder, counterpart of ``minigpt4_tpu/models/eva_vit.py``.

14x14 patch embedding as one matmul (not a convolution, so no cuDNN and no
TF32 path), a learned cls token and position embedding, then pre-LN blocks
with a fused QKV projection whose bias is (q_bias, 0, v_bias), exact-GELU
MLP, LayerNorm eps 1e-6.  Blocks are stacked [L, ...] and indexed per layer;
a quantized container's weights stack as one quantized weight (group-quant,
repacked, w8a8 or packed bytes) whose layer index reaches the kernel (the
JAX package's static-layer path).  Over a tensor-parallel group the blocks
run on one rank's shards (``parallel/sharding.py``; ``tp=``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..formats import is_quantized
from ..parallel.mesh import TPGroup
from .layers import gelu, layer_norm, merge_heads, mha, split_heads
from .llama import col_linear, row_linear
from .params import QUANT_FORMS, dense_from_numpy, linear, load_quant_weight, tensor

LN_EPS = 1e-6


@dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 14
    embed_dim: int = 1408
    depth: int = 39
    head_dim: int = 88
    mlp_dim: int = 6144

    @property
    def n_heads(self) -> int:
        return self.embed_dim // self.head_dim

    @property
    def n_patches_side(self) -> int:
        return self.image_size // self.patch_size


def patch_embed(pixels: torch.Tensor, p: dict, cfg: ViTConfig) -> torch.Tensor:
    """pixels [B, 3, H, W] -> [B, n_patches, D]."""
    b = pixels.shape[0]
    s, ps = cfg.n_patches_side, cfg.patch_size
    x = pixels.reshape(b, 3, s, ps, s, ps).permute(0, 2, 4, 1, 3, 5)
    return linear(x.reshape(b, s * s, 3 * ps * ps), p)


def block_forward(x: torch.Tensor, bp: dict, cfg: ViTConfig, li: int,
                  tp: TPGroup | None = None) -> torch.Tensor:
    """Pre-LN block ``li`` of the stacked blocks on x [B, S, D].

    ``tp``: this rank's tensor-parallel group, ``bp`` then holds its shards
    (``parallel/sharding.py``): a split qkv gives this rank's heads, which
    it attends over alone; a split proj / fc2 contracts this rank's K slice
    and the outputs are summed over the ranks (the bias once, after); a
    weight that stayed whole takes the whole input, gathered where its
    producer was split (``models.llama.row_linear``)."""

    def ln(p):
        return {"g": p["g"][li], "b": p["b"][li]}

    d = cfg.embed_dim
    h = layer_norm(x, ln(bp["norm1"]), LN_EPS)
    q, k, v = col_linear(h, bp["qkv"], li, tp, 3 * d).chunk(3, dim=-1)
    n_heads = q.shape[-1] // cfg.head_dim  # this rank's heads under tp
    attn = mha(split_heads(q, n_heads), split_heads(k, n_heads), split_heads(v, n_heads),
               scale=1.0 / float(np.sqrt(cfg.head_dim)))
    x = x + row_linear(merge_heads(attn), bp["proj"], li, tp, d)
    h = layer_norm(x, ln(bp["norm2"]), LN_EPS)
    hidden = gelu(col_linear(h, bp["fc1"], li, tp, cfg.mlp_dim))
    return x + row_linear(hidden, bp["fc2"], li, tp, cfg.mlp_dim)


def forward(params: dict, pixels: torch.Tensor, cfg: ViTConfig,
            tp: TPGroup | None = None) -> torch.Tensor:
    """[B, 3, 224, 224] f32 -> [B, 257, D] (pre-ln_vision hidden states);
    ``tp``: see :func:`block_forward`."""
    x = embeddings(params, pixels, cfg)
    for li in range(cfg.depth):
        x = block_forward(x, params["blocks"], cfg, li, tp)
    return x


def embeddings(params: dict, pixels: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    """The patch embedding with the cls token and position embedding: the
    input of block 0, [B, 257, D]."""
    x = patch_embed(pixels, params["patch_embed"], cfg)
    cls = params["cls_token"].to(x.dtype).expand(x.shape[0], 1, cfg.embed_dim)
    return torch.cat([cls, x], dim=1) + params["pos_embed"].to(x.dtype)


def _stack(trees: list[dict]) -> dict:
    """List of identical {name: leaf | {name: leaf}} -> stacked [L, ...];
    a leaf is a tensor or a quantized weight (``params.QUANT_FORMS``)."""

    def leaf(vs):
        if isinstance(vs[0], dict):
            return _stack(vs)
        forms = QUANT_FORMS.get(type(vs[0]))
        return forms[0](vs) if forms else torch.stack(vs)

    return {k: leaf([t[k] for t in trees]) for k in trees[0]}


def _ln(t, prefix: str, dtype, device) -> dict:
    return {"g": tensor(t(prefix + ".weight"), dtype, device),
            "b": tensor(t(prefix + ".bias"), dtype, device)}


def load_linear(reader, model: str, wname: str, bias, dtype, device,
                quant_mode: str = "auto", pack: bool = False) -> dict:
    """Dense or quantized linear from the container (torch layout [out, in]);
    a quantized weight loads by ``params.load_quant_weight``'s rules for
    ``quant_mode`` (``auto``: repacked, as on the TPU) and ``pack``."""
    rec = reader.models[model].tensors[wname]
    if is_quantized(rec.dtype):
        p = {"w": load_quant_weight(reader.raw(model, wname), rec.shape, rec.dtype, device,
                                    quant_mode, pack=pack)}
        if bias is not None:
            p["b"] = tensor(bias, dtype, device)
        return p
    return dense_from_numpy(reader.tensor_f32(model, wname), bias, dtype, device)


def load_params(reader, dtype: torch.dtype = torch.float32,
                device: str | torch.device = "cuda",
                quant_mode: str = "auto", pack: bool = False) -> tuple[dict, ViTConfig]:
    """ViT params from a ContainerReader's ``visual_encoder`` sub-model;
    quantized weights load as :func:`load_linear` loads them."""
    names = reader.models["visual_encoder"].tensors.keys()
    depth = 1 + max(int(n.split(".")[1]) for n in names if n.startswith("blocks."))

    def t(name):
        return reader.tensor_f32("visual_encoder", name)

    pe_w = t("patch_embed.proj.weight")  # [D, 3, ps, ps]
    d_model, ps = pe_w.shape[0], pe_w.shape[-1]
    pos = t("pos_embed").reshape(-1, d_model)
    head_dim = reader.config.get("vit", {}).get(
        "head_dim", 88 if d_model % 88 == 0 else d_model // 4)
    cfg = ViTConfig(
        image_size=ps * int(np.sqrt(pos.shape[0] - 1)), patch_size=ps,
        embed_dim=d_model, depth=depth, head_dim=head_dim,
        mlp_dim=t("blocks.0.mlp.fc1.bias").shape[0],
    )
    params: dict = {
        "patch_embed": dense_from_numpy(pe_w.reshape(d_model, -1), t("patch_embed.proj.bias"),
                                        dtype, device),
        "cls_token": tensor(t("cls_token").reshape(-1), dtype, device),
        "pos_embed": tensor(pos, dtype, device),
    }
    blocks = []
    for i in range(depth):
        pfx = f"blocks.{i}."
        q_bias = t(pfx + "attn.q_bias").reshape(-1)
        qkv_bias = np.concatenate([q_bias, np.zeros_like(q_bias), t(pfx + "attn.v_bias").reshape(-1)])

        def lin(name, bias):
            return load_linear(reader, "visual_encoder", pfx + name, bias, dtype, device,
                               quant_mode, pack)

        blocks.append({
            "norm1": _ln(t, pfx + "norm1", dtype, device),
            "qkv": lin("attn.qkv.weight", qkv_bias),
            "proj": lin("attn.proj.weight", t(pfx + "attn.proj.bias")),
            "norm2": _ln(t, pfx + "norm2", dtype, device),
            "fc1": lin("mlp.fc1.weight", t(pfx + "mlp.fc1.bias")),
            "fc2": lin("mlp.fc2.weight", t(pfx + "mlp.fc2.bias")),
        })
    params["blocks"] = _stack(blocks)
    return params, cfg
