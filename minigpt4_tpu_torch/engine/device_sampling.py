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
As in the JAX package, a group whose lanes are all greedy without a bias
takes the static form (a bare argmax); any other group carries its lanes'
thresholds as device tensors and runs every stage of the chain under
``where`` guards (:func:`chain_sorted_traced`), so one captured decode
chunk serves every mix of configs at a lane count.
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
    distribution; order[0] is the greedy pick.  The thresholds enter as
    scalars (cast to the cumulative sums' f32, as a tensor of them would
    be), so the chain copies nothing from the host and a CUDA graph can
    capture it; the config is static, a key of the graph."""
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
        n_keep = torch.searchsorted(torch.cumsum(fd, 0), cfg.tfs_z) + 1
        keep &= ar < n_keep.clamp(min=1)

    if cfg.typical_p < 1.0:
        surprise = -torch.log(probs + 1e-12)
        entropy = (probs * surprise).sum()
        t_order = torch.argsort((surprise - entropy).abs(), stable=True)
        t_cum = torch.cumsum(probs[t_order], 0)
        t_keep_n = (torch.searchsorted(t_cum, cfg.typical_p) + 1).clamp(min=1)
        t_rank = torch.argsort(t_order, stable=True)
        keep &= t_rank < t_keep_n

    if cfg.top_p < 1.0:
        kp = torch.where(keep, probs, 0.0)
        kp = kp / kp.sum().clamp(min=1e-12)
        n_keep = torch.searchsorted(torch.cumsum(kp, 0), cfg.top_p) + 1
        keep &= ar < n_keep.clamp(min=1)

    keep |= ar == 0  # min_keep = 1 (no host value written into the device tensor)
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
    # a 1-element index, not a 0-d one (which indexes through a host read)
    return order.index_select(0, torch.argmax(scaled + gumbel).reshape(1))[0]


def chain_sorted_traced(logits: torch.Tensor, temp: torch.Tensor, top_k: torch.Tensor,
                        top_p: torch.Tensor, tfs_z: torch.Tensor, typical_p: torch.Tensor,
                        bias: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`chain_sorted` with every threshold a 0-d device tensor (JAX's
    ``_chain_sorted``): every stage runs, and a disabled one (top_k <= 0,
    tfs_z, typical_p or top_p >= 1) keeps every position; temp <= 0 scales
    by 1 (the caller takes the argmax then).  For equal thresholds it keeps
    the positions :func:`chain_sorted` keeps."""
    if bias is not None:
        logits = logits + bias
    v = logits.shape[-1]
    ar = torch.arange(v, device=logits.device)
    order = torch.argsort(-logits, stable=True)
    sl = logits[order]
    probs = torch.softmax(sl.float(), dim=-1)
    keep = ar < torch.where(top_k > 0, top_k, v)

    fd = torch.diff(probs, n=2).abs()
    s = fd.sum()
    fd = torch.where(s > 0, fd / s, torch.full_like(fd, 1.0 / (v - 2)))
    n_keep = (torch.searchsorted(torch.cumsum(fd, 0), tfs_z.reshape(1)) + 1).clamp(min=1)
    keep &= ar < torch.where(tfs_z < 1.0, n_keep, v)

    surprise = -torch.log(probs + 1e-12)
    entropy = (probs * surprise).sum()
    t_order = torch.argsort((surprise - entropy).abs(), stable=True)
    t_cum = torch.cumsum(probs[t_order], 0)
    t_keep_n = (torch.searchsorted(t_cum, typical_p.reshape(1)) + 1).clamp(min=1)
    t_rank = torch.argsort(t_order, stable=True)
    keep &= t_rank < torch.where(typical_p < 1.0, t_keep_n, v)

    kp = torch.where(keep, probs, 0.0)
    kp = kp / kp.sum().clamp(min=1e-12)
    n_keep = (torch.searchsorted(torch.cumsum(kp, 0), top_p.reshape(1)) + 1).clamp(min=1)
    keep &= ar < torch.where(top_p < 1.0, n_keep, v)

    keep |= ar == 0  # min_keep = 1
    scaled = torch.where(keep, sl / torch.where(temp > 0, temp, 1.0), float("-inf"))
    return order, scaled


def sample_token_traced(logits: torch.Tensor, generator: torch.Generator, temp, top_k, top_p,
                        tfs_z, typical_p, bias: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`sample_token` with the thresholds as 0-d device tensors: it
    always draws from ``generator``, and a lane with temp <= 0 takes the
    argmax of its biased logits instead of the draw (JAX's
    ``sample_token_dyn``)."""
    order, scaled = chain_sorted_traced(logits, temp, top_k, top_p, tfs_z, typical_p, bias)
    u = torch.rand(scaled.shape, generator=generator, device=scaled.device)
    gumbel = -torch.log(-torch.log(u.clamp(min=1e-20)))
    drawn = order.index_select(0, torch.argmax(scaled + gumbel).reshape(1))[0]
    return torch.where(temp <= 0, order[0], drawn)


TRACED = ("temp", "top_k", "top_p", "tfs_z", "typical_p")  # the thresholds of traced rows


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
    """Per-lane sampling configs of a batched group, the lanes' logit biases
    as one dense [B, V] f32 plane (None when no lane has one), and, for the
    traced form, the configs' thresholds as [B] device tensors
    ({name in TRACED: tensor}; None for the static form)."""

    configs: tuple[DeviceSamplingConfig, ...]
    bias: torch.Tensor | None = None
    traced: dict | None = None

    @property
    def key(self):
        """What a captured step freezes of these rows: the configs of the
        static form, or "traced" (the thresholds are inputs)."""
        return "traced" if self.traced is not None else self.configs


def lane_rows(params_list, n_vocab: int, device: str | torch.device) -> LaneRows:
    """Per-lane rows from anything with temp/top_k/top_p/tfs_z/typical_p and
    an optional ``logit_bias`` {token_id: offset} (SamplingParams): the
    static form, every lane ``DeviceSamplingConfig(temp=0.0)``, where every
    lane is greedy without a bias, else the traced form (JAX's
    ``generate`` and ``SessionPool.generate_batch_stream`` choose so)."""
    if all(p.temp <= 0 and not getattr(p, "logit_bias", None) for p in params_list):
        return LaneRows((DeviceSamplingConfig(temp=0.0),) * len(params_list))
    configs = tuple(DeviceSamplingConfig(temp=p.temp, top_k=p.top_k, top_p=p.top_p,
                                         tfs_z=p.tfs_z, typical_p=p.typical_p)
                    for p in params_list)
    traced = {name: torch.tensor([getattr(c, name) for c in configs],
                                 dtype=torch.long if name == "top_k" else torch.float32,
                                 device=device) for name in TRACED}
    bias = None
    if any(getattr(p, "logit_bias", None) for p in params_list):
        bias = torch.zeros((len(configs), n_vocab), dtype=torch.float32)
        for i, p in enumerate(params_list):
            for tid, off in (getattr(p, "logit_bias", None) or {}).items():
                if 0 <= int(tid) < n_vocab:
                    bias[i, int(tid)] = float(off)
        bias = bias.to(device)
    return LaneRows(configs, bias, traced)


def sample_rows(logits: torch.Tensor, generators: list, rows: LaneRows) -> torch.Tensor:
    """logits [B, V] f32 -> token ids [B] (int64 on the logits' device), each
    lane under its own config and bias plane, sampled lanes drawing from
    their own generator.  Greedy lanes take the argmax of their biased
    logits, all in one reduction.  Traced rows run the traced chain on every
    lane, each drawing from its own generator (the thresholds are device
    values, so which lanes are greedy is not known here)."""
    if rows.traced is not None:
        t = rows.traced
        return torch.stack([
            sample_token_traced(logits[i], generators[i], *(t[name][i] for name in TRACED),
                                None if rows.bias is None else rows.bias[i])
            for i in range(logits.shape[0])])
    biased = logits if rows.bias is None else logits + rows.bias
    tok = torch.argmax(biased, dim=-1)
    for i, cfg in enumerate(rows.configs):
        if not cfg.greedy:
            tok[i] = sample_token(logits[i], generators[i], cfg,
                                  None if rows.bias is None else rows.bias[i])
    return tok
