"""MiniGPT-4 vision pipeline: ViT-G -> ln_vision -> Q-Former -> llama_proj.

Counterpart of ``minigpt4_tpu/models/minigpt4.py``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import eva_vit, qformer
from .layers import layer_norm
from .params import linear, tensor

LN_VISION_EPS = 1e-5  # LAVIS Blip2Base.LayerNorm default


@dataclass(frozen=True)
class VisionConfig:
    vit: eva_vit.ViTConfig
    qformer: qformer.QFormerConfig
    llama_embed_dim: int  # 4096 (7B) or 5120 (13B)


def encode_image(params: dict, pixels: torch.Tensor, cfg: VisionConfig) -> torch.Tensor:
    """pixels [B, 3, 224, 224] (preprocessed f32 CHW) -> [B, 32, n_embd]."""
    x = eva_vit.forward(params["visual_encoder"], pixels, cfg.vit)
    x = layer_norm(x, params["ln_vision"], LN_VISION_EPS)
    x = qformer.forward(params["qformer"], x, cfg.qformer)
    return linear(x, params["llama_proj"])


def load_params(reader, dtype: torch.dtype = torch.float32,
                device: str | torch.device = "cuda",
                quant_mode: str = "auto", pack: bool = False) -> tuple[dict, VisionConfig]:
    """The whole vision pipeline from a ContainerReader; quantized weights
    load by ``quant_mode`` (``auto``: repacked, as on the TPU) and, as gq
    weights, store their codes packed with ``pack``."""
    vit_params, vit_cfg = eva_vit.load_params(reader, dtype, device, quant_mode, pack)
    qf_params, qf_cfg = qformer.load_params(reader, dtype, device, quant_mode, pack)
    params = {
        "visual_encoder": vit_params,
        "ln_vision": {"g": tensor(reader.tensor_f32("ln_vision", "weight"), dtype, device),
                      "b": tensor(reader.tensor_f32("ln_vision", "bias"), dtype, device)},
        "qformer": qf_params,
        "llama_proj": eva_vit.load_linear(reader, "llama_proj", "weight",
                                          reader.tensor_f32("llama_proj", "bias"), dtype, device,
                                          quant_mode, pack),
    }
    n_embd = reader.models["llama_proj"].tensors["weight"].shape[0]
    return params, VisionConfig(vit=vit_cfg, qformer=qf_cfg, llama_embed_dim=n_embd)
