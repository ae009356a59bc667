"""Checkpoint converter: PyTorch MiniGPT-4 weights -> minigpt4 container.

The port's own copy of ``minigpt4_tpu/convert.py`` over the port's
``formats`` (same CLI, byte-equal output), the equivalent of the reference
converter (the reference's ``minigpt4/convert.py``).
The reference reconstructs the model by importing the MiniGPT-4 repo and
downloading EVA/Q-Former weights, then serializes five state dicts; this
converter takes the already-assembled weights — a checkpoint file (.pth /
.bin / .safetensors) whose keys carry the standard MiniGPT-4 prefixes:

    visual_encoder.*   ln_vision.*   query_tokens   Qformer.*   llama_proj.*

dtype policy (convert.py:104-121):
  * ftype f16: any ``*weight`` tensor with >= 2 dims inside an eligible
    sub-model is written f16 (query_tokens / ln_vision excluded);
  * ``patch_embed.proj.weight`` is always f16 (the reference forces this
    because ggml lacked f32 conv2d; we keep it for byte-compatible output);
  * everything else f32.  All tensors are squeezed like the reference.

CLI:  python -m minigpt4_tpu_torch.convert checkpoint.pth -o minigpt4-7B-f16.bin --ftype f16
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

from .formats import ContainerWriter, DataType

PREFIXES = ("visual_encoder.", "ln_vision.", "query_tokens", "Qformer.", "llama_proj.")

DEFAULT_QFORMER_CONFIG = {
    # BertConfig fields the engine consults (minigpt4.cpp:2146, 2227, 2293)
    "encoder_width": 1408,
    "query_length": 32,
    "num_hidden_layers": 12,
    "hidden_size": 768,
    "num_attention_heads": 12,
    "intermediate_size": 3072,
    "vocab_size": 30523,
    "layer_norm_eps": 1e-12,
    "add_cross_attention": True,
    "cross_attention_freq": 2,
}


def load_state_dict(path: str | Path) -> dict[str, np.ndarray]:
    path = Path(path)
    if path.suffix == ".safetensors":
        from safetensors.numpy import load_file

        return dict(load_file(str(path)))
    import torch

    obj = torch.load(str(path), map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "model" in obj and isinstance(obj["model"], dict):
        obj = obj["model"]  # MiniGPT-4 stage checkpoints wrap in {'model': ...}
    return {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v) for k, v in obj.items()}


def split_submodels(sd: dict[str, np.ndarray]) -> dict[str, dict[str, np.ndarray]]:
    out: dict[str, dict[str, np.ndarray]] = {
        "visual_encoder": {},
        "ln_vision": {},
        "query_tokens": {},
        "Qformer": {},
        "llama_proj": {},
    }
    for k, v in sd.items():
        if k.startswith("visual_encoder."):
            out["visual_encoder"][k[len("visual_encoder.") :]] = v
        elif k.startswith("ln_vision."):
            out["ln_vision"][k[len("ln_vision.") :]] = v
        elif k == "query_tokens" or k.startswith("query_tokens."):
            out["query_tokens"]["weight"] = v
        elif k.startswith("Qformer."):
            out["Qformer"][k[len("Qformer.") :]] = v
        elif k.startswith("llama_proj."):
            out["llama_proj"][k[len("llama_proj.") :]] = v
    return out


def _strip_qformer_key(k: str) -> bool:
    """The reference drops the Q-Former's text-generation branches before
    serializing (the reference's convert.py:219-224): cls head,
    word/position embeddings, and each layer's text-FFN ``output``/
    ``intermediate`` (the image branch keeps ``output_query``/
    ``intermediate_query``)."""
    import re

    if k.startswith("cls."):
        return True
    if k.startswith("bert.embeddings.word_embeddings") or k.startswith(
        "bert.embeddings.position_embeddings"
    ):
        return True
    # ".output." / ".intermediate." FFN segments only — attention has its own
    # "attention.output.dense" which the reference KEEPS
    if re.search(r"bert\.encoder\.layer\.\d+\.(output|intermediate)\.", k):
        return True
    return False


_VIT_JUNK_PREFIXES = ("head.", "fc_norm.", "norm.", "mask_token", "lm_head.")


def assemble_from_pretrained(
    projection_ckpt: str | Path,
    vit_ckpt: str | Path,
    qformer_ckpt: str | Path,
) -> dict[str, np.ndarray]:
    """Assemble a full MiniGPT-4 state dict from a *projection-only* stage
    checkpoint plus the standard pretrained sources, mirroring the
    reference's model construction (the reference's convert.py:182-243):
    EVA ViT-G weights (`eva_clip_g` / `eva_vit_g.pth`), the BLIP-2 pretrained
    checkpoint (Q-Former + query_tokens + ln_vision), and the stage
    checkpoint's ``llama_proj`` (``load_projection``, reference :240-243).

    This environment has no network access, so the pretrained sources are
    local files rather than download URLs; the key handling is identical.
    """
    merged: dict[str, np.ndarray] = {}

    vit = load_state_dict(vit_ckpt)
    for k, v in vit.items():
        k = k.removeprefix("module.").removeprefix("visual_encoder.")
        if k.startswith(_VIT_JUNK_PREFIXES):
            continue  # classification head etc. — not part of the encoder
        merged[f"visual_encoder.{k}"] = v

    qf = load_state_dict(qformer_ckpt)
    for k, v in qf.items():
        if k == "query_tokens" or k.startswith("query_tokens."):
            merged["query_tokens"] = v
        elif k.startswith("ln_vision."):
            merged[k] = v
        elif k.startswith("Qformer."):
            if _strip_qformer_key(k[len("Qformer.") :]):
                continue
            merged[k] = v
        # anything else (visual_encoder dup, t5 branches) is ignored

    proj = load_state_dict(projection_ckpt)
    for name in ("llama_proj.weight", "llama_proj.bias"):
        if name not in proj:
            raise ValueError(
                f"projection checkpoint lacks {name} — not a MiniGPT-4 stage "
                "checkpoint (reference load_projection, convert.py:240-243)"
            )
        merged[name] = proj[name]
    return merged


def convert(
    checkpoint: str | Path,
    out_path: str | Path,
    ftype: str = "f16",
    qformer_config: dict | None = None,
    vit_ckpt: str | Path | None = None,
    qformer_ckpt: str | Path | None = None,
) -> Path:
    if vit_ckpt is not None or qformer_ckpt is not None:
        if not (vit_ckpt and qformer_ckpt):
            raise ValueError("assembly needs BOTH --vit and --qformer checkpoints")
        sd = assemble_from_pretrained(checkpoint, vit_ckpt, qformer_ckpt)
    else:
        sd = load_state_dict(checkpoint)
    models = split_submodels(sd)
    missing = [m for m, t in models.items() if not t]
    if missing:
        hint = (
            " (a projection-only stage checkpoint: pass --vit and --qformer "
            "pretrained checkpoints to assemble the full model, like the "
            "reference converter does)"
            if any(k.startswith("llama_proj.") for k in sd)
            else f"; expected keys with prefixes {PREFIXES}"
        )
        raise ValueError(f"checkpoint lacks sub-models {missing}{hint}")

    qcfg = dict(DEFAULT_QFORMER_CONFIG)
    # derive what we can from the weights themselves
    qt = models["query_tokens"]["weight"]
    qt = np.squeeze(qt)
    qcfg["query_length"] = qt.shape[0]
    qcfg["hidden_size"] = qt.shape[1]
    layer_ids = [
        int(k.split(".")[3])
        for k in models["Qformer"]
        if k.startswith("bert.encoder.layer.")
    ]
    if layer_ids:
        qcfg["num_hidden_layers"] = max(layer_ids) + 1
    if "patch_embed.proj.weight" in models["visual_encoder"]:
        qcfg["encoder_width"] = models["visual_encoder"]["patch_embed.proj.weight"].shape[0]
    if qformer_config:
        qcfg.update(qformer_config)

    config = {"ftype": ftype, "Qformer": qcfg}
    writer = ContainerWriter(out_path, ftype=0 if ftype == "f16" else 1, config=config)

    for model_name, tensors in models.items():
        recs = []
        for layer_name, arr in tensors.items():
            arr = np.squeeze(np.asarray(arr))
            to_f16 = False
            if ftype == "f16":
                if model_name not in ("query_tokens", "ln_vision"):
                    if layer_name.endswith("weight") and arr.ndim >= 2:
                        to_f16 = True
            if layer_name == "patch_embed.proj.weight":
                to_f16 = True  # forced f16 like the reference (convert.py:113-117)
            if to_f16:
                a = arr.astype("<f2")
                recs.append((layer_name, a.shape, DataType.F16, a.view(np.uint8).reshape(-1)))
            elif arr.dtype == np.int32:
                a = arr.astype("<i4")
                recs.append((layer_name, a.shape, DataType.I32, a.view(np.uint8).reshape(-1)))
            elif arr.dtype == np.int64:
                a = arr.astype("<i8")
                recs.append((layer_name, a.shape, DataType.L64, a.view(np.uint8).reshape(-1)))
            else:
                a = arr.astype("<f4")
                recs.append((layer_name, a.shape, DataType.F32, a.view(np.uint8).reshape(-1)))
        writer.add_model(model_name, recs)
    writer.write()
    return Path(out_path)


def main(argv=None):
    ap = argparse.ArgumentParser(description="Convert MiniGPT-4 torch weights to container")
    ap.add_argument(
        "checkpoint",
        help=".pth/.bin/.safetensors: either an assembled MiniGPT-4 state dict, "
        "or a projection-only stage checkpoint (with --vit/--qformer)",
    )
    ap.add_argument("-o", "--out", default=None)
    ap.add_argument("--ftype", default="f16", choices=["f16", "f32"])
    ap.add_argument(
        "--vit", default=None,
        help="EVA ViT-G pretrained state dict (eva_vit_g.pth) for assembly "
        "from a projection-only stage checkpoint",
    )
    ap.add_argument(
        "--qformer", default=None,
        help="BLIP-2 pretrained checkpoint (Q-Former + query_tokens + "
        "ln_vision, e.g. blip2_pretrained_flant5xxl.pth) for assembly",
    )
    args = ap.parse_args(argv)
    out = args.out or f"minigpt4-{args.ftype}.bin"
    path = convert(args.checkpoint, out, args.ftype, vit_ckpt=args.vit, qformer_ckpt=args.qformer)
    print(f"wrote {path}")


if __name__ == "__main__":
    sys.exit(main())
