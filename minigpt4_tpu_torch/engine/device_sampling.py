"""On-device sampling: the llama.cpp chain as logits -> token on the card.

Counterpart of ``minigpt4_tpu/engine/device_sampling.py``: greedy, or the
top-k -> tail-free -> typical -> top-p -> temperature chain with the host
sampler's truncation semantics (engine/sampling.py), over one descending
sort of the logits.  An optional per-id ``bias`` (the OpenAI logit_bias
knob) is added before the chain.  Draws come from an explicit
``torch.Generator`` (Gumbel-max over the chain's scaled logits), so the
token ids never leave the device until the caller reads them.

A batched group samples each lane under its own config
(:func:`lane_rows`, :func:`sample_rows`), with one generator per lane.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class DeviceSamplingConfig:
    temp: float = 0.8
    top_k: int = 40
    top_p: float = 0.9
    tfs_z: float = 1.0
    typical_p: float = 1.0

    @property
    def greedy(self) -> bool:
        return self.temp <= 0


def chain_sorted(logits: torch.Tensor, cfg: DeviceSamplingConfig,
                 bias: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """logits [V] -> (order, scaled): the descending (stable) sort
    permutation and the temperature-scaled logits in sorted order with the
    chain's truncated positions at -inf.  softmax(scaled) is the sampling
    distribution; order[0] is the greedy pick."""
    if bias is not None:
        logits = logits + bias
    v = logits.shape[-1]
    ar = torch.arange(v, device=logits.device)
    order = torch.argsort(-logits, stable=True)
    sl = logits[order]
    probs = torch.softmax(sl.float(), dim=-1)
    keep = ar < (cfg.top_k if cfg.top_k > 0 else v)

    if cfg.tfs_z < 1.0:
        fd = torch.diff(probs, n=2).abs()
        s = fd.sum()
        fd = torch.where(s > 0, fd / s, torch.full_like(fd, 1.0 / (v - 2)))
        n_keep = torch.searchsorted(torch.cumsum(fd, 0), torch.tensor(cfg.tfs_z, device=fd.device)) + 1
        keep &= ar < n_keep.clamp(min=1)

    if cfg.typical_p < 1.0:
        surprise = -torch.log(probs + 1e-12)
        entropy = (probs * surprise).sum()
        t_order = torch.argsort((surprise - entropy).abs(), stable=True)
        t_cum = torch.cumsum(probs[t_order], 0)
        t_keep_n = (torch.searchsorted(t_cum, torch.tensor(cfg.typical_p, device=t_cum.device)) + 1).clamp(min=1)
        t_rank = torch.argsort(t_order, stable=True)
        keep &= t_rank < t_keep_n

    if cfg.top_p < 1.0:
        kp = torch.where(keep, probs, 0.0)
        kp = kp / kp.sum().clamp(min=1e-12)
        n_keep = torch.searchsorted(torch.cumsum(kp, 0), torch.tensor(cfg.top_p, device=kp.device)) + 1
        keep &= ar < n_keep.clamp(min=1)

    keep[0] = True  # min_keep = 1
    scaled = torch.where(keep, sl / cfg.temp, float("-inf"))
    return order, scaled


def sample_token(logits: torch.Tensor, generator: torch.Generator,
                 cfg: DeviceSamplingConfig, bias: torch.Tensor | None = None) -> torch.Tensor:
    """logits [V] f32 -> token id (int64 0-d tensor on the logits' device)."""
    if cfg.greedy:
        return torch.argmax(logits if bias is None else logits + bias)
    order, scaled = chain_sorted(logits, cfg, bias)
    u = torch.rand(scaled.shape, generator=generator, device=scaled.device)
    gumbel = -torch.log(-torch.log(u.clamp(min=1e-20)))
    return order[torch.argmax(scaled + gumbel)]


def logit_bias_tensor(logit_bias: dict | None, n_vocab: int,
                      device: str | torch.device) -> torch.Tensor | None:
    """{token_id: offset} -> dense [V] f32 bias, or None when empty."""
    if not logit_bias:
        return None
    bias = torch.zeros(n_vocab, dtype=torch.float32)
    for tid, b in logit_bias.items():
        if 0 <= int(tid) < n_vocab:
            bias[int(tid)] = float(b)
    return bias.to(device)


@dataclass(frozen=True)
class LaneRows:
    """Per-lane sampling configs of a batched group, and the lanes' logit
    biases as one dense [B, V] f32 plane (None when no lane has one)."""

    configs: tuple[DeviceSamplingConfig, ...]
    bias: torch.Tensor | None = None


def lane_rows(params_list, n_vocab: int, device: str | torch.device) -> LaneRows:
    """Per-lane rows from anything with temp/top_k/top_p/tfs_z/typical_p and
    an optional ``logit_bias`` {token_id: offset} (SamplingParams)."""
    configs = tuple(DeviceSamplingConfig(temp=p.temp, top_k=p.top_k, top_p=p.top_p,
                                         tfs_z=p.tfs_z, typical_p=p.typical_p)
                    for p in params_list)
    bias = None
    if any(getattr(p, "logit_bias", None) for p in params_list):
        bias = torch.zeros((len(configs), n_vocab), dtype=torch.float32)
        for i, p in enumerate(params_list):
            for tid, off in (getattr(p, "logit_bias", None) or {}).items():
                if 0 <= int(tid) < n_vocab:
                    bias[i, int(tid)] = float(off)
        bias = bias.to(device)
    return LaneRows(configs, bias)


def sample_rows(logits: torch.Tensor, generators: list, rows: LaneRows) -> torch.Tensor:
    """logits [B, V] f32 -> token ids [B] (int64 on the logits' device), each
    lane under its own config and bias plane, sampled lanes drawing from
    their own generator.  Greedy lanes take the argmax of their biased
    logits, all in one reduction."""
    biased = logits if rows.bias is None else logits + rows.bias
    tok = torch.argmax(biased, dim=-1)
    for i, cfg in enumerate(rows.configs):
        if not cfg.greedy:
            tok[i] = sample_token(logits[i], generators[i], cfg,
                                  None if rows.bias is None else rows.bias[i])
    return tok
