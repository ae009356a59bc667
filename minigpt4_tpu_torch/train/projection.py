"""Stage-1 projection training: fit ``llama_proj`` on image-caption pairs.

Counterpart of ``minigpt4_tpu/train/projection.py``.  MiniGPT-4's first
training stage freezes the ViT, the Q-Former and the decoder and trains only
the linear projection: vision encode -> soft-prompt injection -> decoder
cross-entropy -> grads -> optimizer update.

In PyTorch's idiom the projection is ``{"w": [768, n_embd], "b": [n_embd]}``
of leaf tensors that require grad, the optimizer is a ``torch.optim``
optimizer over them, and the frozen decoder is differentiated through in x
only.  Its frozen weights must be dense or ``qtensor`` (packed bytes, whose
matmul is the autograd Function of ``ops/quant_matmul.py``): the gq,
repacked and w8a8 forms run hand-written kernels on the card, which have no
backward, so :func:`check_trainable` refuses them on every device (the JAX
package cannot differentiate its gq or repacked forms either; its w8a8 form
runs XLA on the CPU, where the gradient flows only through the absmax of
``round``).  A quantized container's ViT
and Q-Former may keep their kernels: nothing upstream of ``llama_proj``
requires grad.
"""

from __future__ import annotations

import dataclasses

import torch

from ..models import llama as llama_mod
from ..models import minigpt4 as vision_mod
from ..ops import group_i8 as gq
from ..ops import i8_matmul as i8
from ..ops import repack as rp

# frozen weight forms whose forward on the card is a kernel with no backward
KERNEL_FORMS = (gq.GroupQuant, rp.RepackedQuant, i8.I8SBQuant)


def check_trainable(tree, where: str) -> None:
    """Raise before any forward if ``tree`` (a parameter tree) holds a weight
    in a form of :data:`KERNEL_FORMS`."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            check_trainable(v, f"{where}.{k}")
    elif isinstance(tree, list):  # a name whose layers differ in format
        for i, v in enumerate(tree):
            check_trainable(v, f"{where}[{i}]")
    elif isinstance(tree, KERNEL_FORMS):
        raise NotImplementedError(
            f"{where} is a {type(tree).__name__}: its matmul runs a kernel with no backward on "
            "the card, so training cannot differentiate through it; load the decoder and "
            "llama_proj with quant_mode='qtensor' (packed bytes) or dense (ROADMAP Queue 1, "
            "item 12)")


def caption_loss(proj_params: dict, frozen: dict, pixels: torch.Tensor,
                 caption_tokens: torch.Tensor, caption_mask: torch.Tensor, vision_cfg,
                 llm_cfg) -> torch.Tensor:
    """Masked mean cross-entropy of the caption tokens given the image soft
    prompt, a scalar tensor.

    frozen: {"vision": vision params without llama_proj, "llm": decoder
    params}; pixels [B, 3, H, W]; caption_tokens [B, T] (BOS first);
    caption_mask [B, T].  The decoder runs over a cache of n_q + T positions
    in the token embeddings' dtype with the plain attention
    (``use_flash=False``), all positions' logits; position n_q - 1 + t
    predicts caption token t."""
    check_trainable(proj_params, "llama_proj")
    check_trainable(frozen["llm"], "llm")
    vision_params = dict(frozen["vision"])
    vision_params["llama_proj"] = proj_params
    img_embeds = vision_mod.encode_image(vision_params, pixels, vision_cfg)  # [B, Q, D]

    tok_embeds = llama_mod.embed_tokens(frozen["llm"], caption_tokens)  # [B, T, D]
    seq = torch.cat([img_embeds.to(tok_embeds.dtype), tok_embeds], dim=1)

    b, n_q = img_embeds.shape[:2]
    t = caption_tokens.shape[1]
    cfg_t = dataclasses.replace(llm_cfg, n_ctx=n_q + t)
    cache = llama_mod.init_cache(cfg_t, b, tok_embeds.dtype, tok_embeds.device)
    logits = llama_mod.forward(frozen["llm"], cache, seq, 0, cfg_t, all_logits=True,
                               use_flash=False)  # [B, n_q + T, V]

    pred = logits[:, n_q - 1:n_q + t - 1]  # [B, T, V]
    logp = torch.log_softmax(pred, dim=-1)
    nll = -logp.gather(-1, caption_tokens.long()[..., None])[..., 0]
    mask = caption_mask.float()
    return (nll * mask).sum() / mask.sum().clamp(min=1.0)


def make_train_step(vision_cfg, llm_cfg, optimizer: torch.optim.Optimizer):
    """Returns step(proj_params, frozen, pixels, tokens, mask) ->
    (proj_params, loss): one gradient of :func:`caption_loss` and one update
    by ``optimizer``, whose parameters are the leaves of ``proj_params``
    (created over them by the caller, each requiring grad).  The optimizer's
    state lives in the ``torch.optim`` object, where the JAX package threads
    ``opt_state`` through the step; the leaves are updated in place and the
    same dict is returned.  ``loss`` is detached."""

    def step(proj_params, frozen, pixels, tokens, mask):
        optimizer.zero_grad(set_to_none=True)
        loss = caption_loss(proj_params, frozen, pixels, tokens, mask, vision_cfg, llm_cfg)
        loss.backward()
        optimizer.step()
        return proj_params, loss.detach()

    return step
