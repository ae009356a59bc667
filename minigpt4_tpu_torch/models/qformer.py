"""BLIP-2 Q-Former, counterpart of ``minigpt4_tpu/models/qformer.py``.

The 32 learned query tokens, LayerNormed, run through BERT layers:
self-attention, cross-attention to the ViT states on the layers that have
it (every second in BLIP-2), and the query FFN (intermediate_query -> GELU
-> output_query).  No text input, so no attention masks.  LayerNorm eps
1e-12.  The layers differ in structure, so they stay a list.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .eva_vit import _ln, load_linear
from .layers import gelu, layer_norm, merge_heads, mha, split_heads
from .params import linear, tensor

LN_EPS = 1e-12


@dataclass(frozen=True)
class QFormerConfig:
    hidden_size: int = 768
    n_heads: int = 12
    n_layers: int = 12
    encoder_width: int = 1408
    query_length: int = 32
    intermediate_size: int = 3072

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.n_heads

    @classmethod
    def from_container_config(cls, config: dict) -> "QFormerConfig":
        q = config.get("Qformer", {})
        return cls(
            hidden_size=q.get("hidden_size", 768),
            n_heads=q.get("num_attention_heads", 12),
            n_layers=q.get("num_hidden_layers", 12),
            encoder_width=q.get("encoder_width", 1408),
            query_length=q.get("query_length", 32),
            intermediate_size=q.get("intermediate_size", 3072),
        )


def attention(x: torch.Tensor, p: dict, cfg: QFormerConfig,
              kv_states: torch.Tensor | None = None) -> torch.Tensor:
    """Projections + MHA + dense + residual + LN; ``kv_states`` switches to
    cross-attention over the image encoder states."""
    src = kv_states if kv_states is not None else x
    q = split_heads(linear(x, p["query"]), cfg.n_heads)
    k = split_heads(linear(src, p["key"]), cfg.n_heads)
    v = split_heads(linear(src, p["value"]), cfg.n_heads)
    ctx = merge_heads(mha(q, k, v, scale=1.0 / float(np.sqrt(cfg.head_dim))))
    return layer_norm(linear(ctx, p["dense"]) + x, p["ln"], LN_EPS)


def layer_forward(x: torch.Tensor, lp: dict, cfg: QFormerConfig,
                  image_states: torch.Tensor) -> torch.Tensor:
    x = attention(x, lp["self"], cfg)
    if "cross" in lp:
        x = attention(x, lp["cross"], cfg, kv_states=image_states)
    h = linear(gelu(linear(x, lp["intermediate_query"])), lp["output_query"])
    return layer_norm(h + x, lp["output_ln"], LN_EPS)


def forward(params: dict, image_states: torch.Tensor, cfg: QFormerConfig) -> torch.Tensor:
    """image_states [B, 257, encoder_width] -> [B, query_length, hidden]."""
    q = params["query_tokens"].to(image_states.dtype)
    x = q.expand(image_states.shape[0], *q.shape)
    x = layer_norm(x, params["ln_embed"], LN_EPS)
    for lp in params["layers"]:
        x = layer_forward(x, lp, cfg, image_states)
    return x


def load_params(reader, dtype: torch.dtype = torch.float32,
                device: str | torch.device = "cuda",
                quant_mode: str = "auto", pack: bool = False) -> tuple[dict, QFormerConfig]:
    """Q-Former params from the container's ``Qformer`` + ``query_tokens``;
    quantized weights load as ``eva_vit.load_linear`` loads them."""
    cfg = QFormerConfig.from_container_config(reader.config)

    def t(name):
        return reader.tensor_f32("Qformer", name)

    names = set(reader.models["Qformer"].tensors.keys())
    n_layers = 1 + max(int(n.split(".")[3]) for n in names if n.startswith("bert.encoder.layer."))
    params: dict = {
        "query_tokens": tensor(
            reader.tensor_f32("query_tokens", "weight").reshape(-1, cfg.hidden_size), dtype, device),
        "ln_embed": _ln(t, "bert.embeddings.LayerNorm", dtype, device),
    }

    def lin(name):
        return load_linear(reader, "Qformer", name + ".weight", t(name + ".bias"), dtype, device,
                           quant_mode, pack)

    def attn_params(pfx: str) -> dict:
        return {
            "query": lin(pfx + "self.query"),
            "key": lin(pfx + "self.key"),
            "value": lin(pfx + "self.value"),
            "dense": lin(pfx + "output.dense"),
            "ln": _ln(t, pfx + "output.LayerNorm", dtype, device),
        }

    layers = []
    for i in range(n_layers):
        pfx = f"bert.encoder.layer.{i}."
        lp = {"self": attn_params(pfx + "attention.")}
        if pfx + "crossattention.self.query.weight" in names:
            lp["cross"] = attn_params(pfx + "crossattention.")
        lp["intermediate_query"] = lin(pfx + "intermediate_query.dense")
        lp["output_query"] = lin(pfx + "output_query.dense")
        lp["output_ln"] = _ln(t, pfx + "output_query.LayerNorm", dtype, device)
        layers.append(lp)
    params["layers"] = layers
    return params, cfg
