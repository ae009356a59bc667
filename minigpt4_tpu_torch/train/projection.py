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

Over a (dp, tp) mesh (``parallel.mesh.make_mesh``; JAX's step jitted over
its mesh) the frozen halves are this rank's shards
(``parallel/sharding.shard_params``: the ViT's blocks and the decoder split
over tp, the rest and ``llama_proj`` replicated), the batch is split over
dp, and the gradient of ``llama_proj`` is summed over dp by one all-reduce
that also carries the loss.  tp needs no gradient reduce: the decoder's
``copy_to_tp`` has already summed the ranks' partial gradients of its
replicated inputs.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..models import llama as llama_mod
from ..models import minigpt4 as vision_mod
from ..ops import group_i8 as gq
from ..ops import i8_matmul as i8
from ..ops import repack as rp
from ..parallel import spmd
from ..parallel.mesh import Mesh, TPGroup

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
                 llm_cfg, tp: TPGroup | None = None) -> torch.Tensor:
    """Masked mean cross-entropy of the caption tokens given the image soft
    prompt, a scalar tensor (:func:`caption_nll` over the mask's count).

    frozen: {"vision": vision params without llama_proj, "llm": decoder
    params}; pixels [B, 3, H, W]; caption_tokens [B, T] (BOS first);
    caption_mask [B, T].  The decoder runs over a cache of n_q + T positions
    in the token embeddings' dtype with the plain attention
    (``use_flash=False``), all positions' logits; position n_q - 1 + t
    predicts caption token t.  ``tp``: this rank's tensor-parallel group,
    ``frozen`` then holds its shards; every rank returns the same loss."""
    nll = caption_nll(proj_params, frozen, pixels, caption_tokens, caption_mask, vision_cfg,
                      llm_cfg, tp)
    return nll / caption_mask.float().sum().clamp(min=1.0)


def caption_nll(proj_params: dict, frozen: dict, pixels: torch.Tensor,
                caption_tokens: torch.Tensor, caption_mask: torch.Tensor, vision_cfg,
                llm_cfg, tp: TPGroup | None = None) -> torch.Tensor:
    """The masked sum of the caption tokens' cross-entropy (the numerator
    of :func:`caption_loss`, whose arguments it takes)."""
    check_trainable(proj_params, "llama_proj")
    check_trainable(frozen["llm"], "llm")
    vision_params = dict(frozen["vision"])
    vision_params["llama_proj"] = proj_params
    img_embeds = vision_mod.encode_image(vision_params, pixels, vision_cfg, tp)  # [B, Q, D]

    tok_embeds = llama_mod.embed_tokens(frozen["llm"], caption_tokens)  # [B, T, D]
    seq = torch.cat([img_embeds.to(tok_embeds.dtype), tok_embeds], dim=1)

    b, n_q = img_embeds.shape[:2]
    t = caption_tokens.shape[1]
    cfg_t = dataclasses.replace(llm_cfg, n_ctx=n_q + t)
    cache = llama_mod.init_cache(spmd.cache_cfg(cfg_t, tp.size if tp else 1), b,
                                 tok_embeds.dtype, tok_embeds.device)
    logits = llama_mod.forward(frozen["llm"], cache, seq, 0, cfg_t, all_logits=True,
                               tp=tp, use_flash=False)  # [B, n_q + T, V]

    pred = logits[:, n_q - 1:n_q + t - 1]  # [B, T, V]
    logp = torch.log_softmax(pred, dim=-1)
    nll = -logp.gather(-1, caption_tokens.long()[..., None])[..., 0]
    return (nll * caption_mask.float()).sum()


def make_train_step(vision_cfg, llm_cfg, optimizer: torch.optim.Optimizer,
                    mesh: Mesh | None = None):
    """Returns step(proj_params, frozen, pixels, tokens, mask) ->
    (proj_params, loss): one gradient of :func:`caption_loss` and one update
    by ``optimizer``, whose parameters are the leaves of ``proj_params``
    (created over them by the caller, each requiring grad).  The optimizer's
    state lives in the ``torch.optim`` object, where the JAX package threads
    ``opt_state`` through the step; the leaves are updated in place and the
    same dict is returned.  ``loss`` is detached.

    ``mesh``: this rank's (dp, tp) mesh.  ``frozen`` holds this rank's
    shards, the step takes the whole batch (B divisible by dp) and runs its
    dp rank's rows; the loss is the masked mean over the whole batch, as on
    one device: each rank's masked sum over the whole batch's count, its
    gradient and the loss summed over dp in one all-reduce.  Every rank
    returns the same loss and holds the same ``llama_proj`` after it."""
    tp = mesh.tp_group if mesh is not None else None

    def step(proj_params, frozen, pixels, tokens, mask):
        optimizer.zero_grad(set_to_none=True)
        if mesh is None or mesh.dp == 1:
            loss = caption_loss(proj_params, frozen, pixels, tokens, mask, vision_cfg, llm_cfg,
                                tp)
            loss.backward()
        else:
            b = pixels.shape[0]
            if b % mesh.dp:
                raise ValueError(f"batch {b} does not split over dp={mesh.dp}")
            rows = slice(mesh.dp_rank * b // mesh.dp, (mesh.dp_rank + 1) * b // mesh.dp)
            loss = caption_nll(proj_params, frozen, pixels[rows], tokens[rows], mask[rows],
                               vision_cfg, llm_cfg, tp) / mask.float().sum().clamp(min=1.0)
            loss.backward()
            loss = _sum_over_dp(proj_params, loss.detach(), mesh)
        optimizer.step()
        return proj_params, loss.detach()

    return step


def _sum_over_dp(proj_params: dict, loss: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum the leaves' gradients and ``loss`` over the dp ranks in one
    all-reduce of one flat f32 buffer; returns the summed loss."""
    leaves = [proj_params[k] for k in sorted(proj_params)]
    flat = torch.cat([t.grad.reshape(-1).float() for t in leaves] + [loss.reshape(1).float()])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.dp_group)
    at = 0
    for t in leaves:
        t.grad.copy_(flat[at:at + t.numel()].view_as(t.grad))
        at += t.numel()
    return flat[at]
