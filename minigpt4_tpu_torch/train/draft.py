"""The draft head: a tiny decoder over the main model's frozen embedding,
the drafter of draft-model speculation, and its distillation (counterpart
of ``minigpt4_tpu/train/draft.py``).

The head is a 1-2 layer llama whose token embedding is the main model's
embedding projected through ``p_in`` [d_main, d_draft] and whose output
head is ``p_out`` [d_draft, d_main] composed with the same embedding, so an
artifact holds only the projections and the small layers, and the
vocabulary is the main model's by construction.  :func:`assemble_draft`
turns an artifact into a standard llama parameter tree, which the engine's
draft machinery (``engine.DraftFns``, ``llama.draft_speculative_decode_loop``)
runs like a second model file.

Artifacts are npz files with the JAX package's keys and types (float16
arrays, ``cfg`` as i32 [d_draft, n_layer, n_head, n_ff], an optional
``teacher_mode`` string), so each side reads what the other writes.

Distillation (:func:`make_distill_step`) is cross-entropy of the head's
next-token prediction, teacher-forced, against the teacher's greedy choice
(:func:`teacher_targets`), the event a speculative verify accepts on.  The
artifact's leaves (:func:`art_leaves`) are the parameters of a
``torch.optim`` optimizer; ``minigpt4_tpu_torch.tools.train_draft`` runs
it against a llama.cpp file.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from ..models import llama as llama_mod

# the artifact's per-layer arrays: (npz key, key in art["layers"], linear or not)
_LAYER_KEYS = (("attention_norm", False), ("wqkv", True), ("wo", True),
               ("ffn_norm", False), ("w13", True), ("w2", True))


@dataclass(frozen=True)
class DraftHeadConfig:
    d_draft: int = 512
    n_layer: int = 2
    n_head: int = 8
    n_ff: int = 1408

    def llama_cfg(self, n_vocab: int, n_ctx: int) -> llama_mod.LlamaConfig:
        return llama_mod.LlamaConfig(n_vocab=n_vocab, n_embd=self.d_draft, n_head=self.n_head,
                                     n_layer=self.n_layer, n_rot=self.d_draft // self.n_head,
                                     n_ff=self.n_ff, n_ctx=n_ctx)


def init_draft_head(generator: torch.Generator, d_main: int, cfg: DraftHeadConfig) -> dict:
    """A fresh artifact (f32 on the generator's device), scaled as the JAX
    package's ``init_draft_head``: normal projections of std d^-1/2, layer
    weights of std 0.02 (0.02 / sqrt(2 L) for wo and w2), unit norms."""
    d, ff, n_l = cfg.d_draft, cfg.n_ff, cfg.n_layer
    dev = generator.device

    def nrm(*shape, s):
        return torch.randn(shape, generator=generator, device=dev) * s

    out_s = 0.02 / (2 * n_l) ** 0.5
    return {
        "p_in": nrm(d_main, d, s=d_main ** -0.5),
        "p_out": nrm(d, d_main, s=d ** -0.5),
        "layers": {
            "attention_norm": torch.ones((n_l, d), device=dev),
            "wqkv": {"w": nrm(n_l, d, 3 * d, s=0.02)},
            "wo": {"w": nrm(n_l, d, d, s=out_s)},
            "ffn_norm": torch.ones((n_l, d), device=dev),
            "w13": {"w": nrm(n_l, d, 2 * ff, s=0.02)},
            "w2": {"w": nrm(n_l, ff, d, s=out_s)},
        },
        "norm": torch.ones((d,), device=dev),
    }


def assemble_draft(main_emb: torch.Tensor, art: dict, dtype: torch.dtype = torch.bfloat16) -> dict:
    """Artifact + the main model's [V, d_main] embedding -> a llama parameter
    tree on the embedding's device: token embedding emb @ p_in [V, d_draft]
    and output head p_out @ emb^T [d_draft, V], computed once in f32."""
    dev = main_emb.device
    emb = main_emb.float()
    p_in, p_out = art["p_in"].to(dev, torch.float32), art["p_out"].to(dev, torch.float32)
    layers = {}
    for name, lin in _LAYER_KEYS:
        t = art["layers"][name]["w"] if lin else art["layers"][name]
        t = t.to(dev, dtype)
        layers[name] = {"w": t} if lin else t
    return {"tok_embeddings": (emb @ p_in).to(dtype),
            "norm": art["norm"].to(dev, dtype),
            "output": {"w": (p_out @ emb.T).to(dtype)},
            "layers": layers}


def art_leaves(art: dict) -> list[torch.Tensor]:
    """The artifact's tensors in a fixed order (p_in, p_out, norm, then the
    layers' in ``_LAYER_KEYS`` order): the parameters of the optimizer of
    :func:`make_distill_step`."""
    layers = art["layers"]
    return [art["p_in"], art["p_out"], art["norm"]] + [
        layers[name]["w"] if lin else layers[name] for name, lin in _LAYER_KEYS]


def make_distill_step(dcfg: llama_mod.LlamaConfig, opt: torch.optim.Optimizer):
    """Returns step(art, main_emb, tokens, targets, warm) -> (art, loss,
    agreement): one distillation step of ``opt``, an optimizer over
    :func:`art_leaves` (each requiring grad; updated in place, the same
    dict returned; the optimizer's state lives in it, where the JAX package
    threads ``opt_state``).

    The loss is the mean cross-entropy of the head's logits [B, T, V]
    (assembled in f32 over the frozen [V, d_main] ``main_emb`` inside the
    loss, an f32 cache of ``dcfg.n_ctx``, the plain attention) against the
    teacher's greedy ``targets`` [B, T] at positions t >= ``warm``; the
    agreement is the share of those positions whose argmax is the target.
    Both come back detached."""

    def loss_fn(art, main_emb, tokens, targets, warm):
        dparams = assemble_draft(main_emb, art, dtype=torch.float32)
        b, t = tokens.shape
        cache = llama_mod.init_cache(dcfg, b, torch.float32, main_emb.device)
        emb = llama_mod.embed_tokens(dparams, tokens)
        logits = llama_mod.forward(dparams, cache, emb, 0, dcfg, all_logits=True,
                                   use_flash=False)  # [B, T, V]
        lp = torch.log_softmax(logits.float(), dim=-1)
        ce = -lp.gather(-1, targets.long()[..., None])[..., 0]
        mask = (torch.arange(t, device=ce.device)[None, :] >= warm).float().expand(ce.shape)
        acc = (logits.argmax(dim=-1) == targets).float()
        return (ce * mask).sum() / mask.sum(), (acc * mask).sum() / mask.sum()

    def step(art, main_emb, tokens, targets, warm):
        opt.zero_grad(set_to_none=True)
        loss, acc = loss_fn(art, main_emb, tokens, targets, warm)
        loss.backward()
        opt.step()
        return art, loss.detach(), acc.detach()

    return step


def teacher_targets(params: dict, cfg: llama_mod.LlamaConfig, tokens: torch.Tensor,
                    cache_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The teacher's greedy targets i32 [B, T] for a token batch on its
    device: its argmax at every position, teacher-forced, under
    ``torch.no_grad()``, so any weight form serves (gq runs its prefill
    kernels).  The scratch cache holds min(n_ctx, T) positions, not
    ``cfg.n_ctx``: the forward never reads past T."""
    b, t = tokens.shape
    cfg = dataclasses.replace(cfg, n_ctx=min(cfg.n_ctx, t))
    with torch.no_grad():
        cache = llama_mod.init_cache(cfg, b, cache_dtype, tokens.device)
        emb = llama_mod.embed_tokens(params, tokens)
        logits = llama_mod.forward(params, cache, emb, 0, cfg, all_logits=True)
    return logits.argmax(dim=-1).int()


def _np16(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().float().cpu().numpy()
    return np.asarray(t, np.float16)


def save_artifact(path: str | Path, art: dict, cfg: DraftHeadConfig,
                  teacher_mode: str = "") -> None:
    """Write ``art`` as the JAX package's ``save_artifact`` does (float16
    arrays, compressed npz); ``teacher_mode`` records the quant mode the
    head was distilled against."""
    flat = {"p_in": _np16(art["p_in"]), "p_out": _np16(art["p_out"]), "norm": _np16(art["norm"])}
    for name, lin in _LAYER_KEYS:
        flat[name] = _np16(art["layers"][name]["w"] if lin else art["layers"][name])
    flat["cfg"] = np.asarray([cfg.d_draft, cfg.n_layer, cfg.n_head, cfg.n_ff], np.int32)
    if teacher_mode:
        flat["teacher_mode"] = np.asarray(teacher_mode)
    np.savez_compressed(str(path), **flat)


def artifact_teacher_mode(path: str | Path, default: str = "w8a8") -> str:
    """The quant-mode tag recorded at save time (``default`` for an
    artifact without one)."""
    with np.load(str(path)) as z:
        return str(z["teacher_mode"]) if "teacher_mode" in z else default


def load_artifact(path: str | Path) -> tuple[dict, DraftHeadConfig]:
    """An artifact of either package -> (art with f32 CPU tensors, config)."""
    with np.load(str(path)) as z:
        cfg = DraftHeadConfig(*[int(v) for v in z["cfg"]])

        def f32(key):
            return torch.from_numpy(np.asarray(z[key], np.float32))

        layers = {name: {"w": f32(name)} if lin else f32(name) for name, lin in _LAYER_KEYS}
        art = {"p_in": f32("p_in"), "p_out": f32("p_out"), "norm": f32("norm"), "layers": layers}
    return art, cfg
