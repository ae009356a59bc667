"""Quantization-quality harness: logit KL / top-1 / perplexity across the
engine's weight forms and KV cache types, plus smooth-quant calibration.

Counterpart of ``minigpt4_tpu/quality.py`` on PyTorch:

  * a synthetic LLaMA pair (f32 and quantized ggml files of the same
    weights) with persistent residual-stream channel outliers injected
    (scaled embedding columns and wo/w2 output rows), the failure mode that
    per-token i8 activation quantization has to survive;
  * teacher-forced full-sequence logits for each path through the real
    file -> ``load_params`` pipeline;
  * metrics: mean / p95 KL(ref || path), top-1 agreement, teacher-forced
    perplexity delta;
  * smooth-quant calibration (Xiao et al. 2022): per-channel activation
    absmax from ``llama.forward``'s ``act_stats`` capture combined with
    per-channel weight absmax into migration scales
    ``s_j = act_max_j ** alpha / w_max_j ** (1 - alpha)``, which
    ``llama.load_params`` folds into (norm, weight) pairs.

Run ``python -m minigpt4_tpu_torch.quality`` (``--device cpu`` without a
card) for the table, the two gates and a last JSON line.  The five rows:
``q5k`` (the exact path, ``quant_mode_exact``), ``gq`` (``quant_mode="gq"``,
packed by ``params.resolve_gq_pack``),
``w8a8``, ``w8a8_smooth`` and ``f8_cache`` (the exact path over an e4m3
cache).  Scales are saved as npz, which both packages read.
"""

from __future__ import annotations

import argparse
import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from .formats import DataType, LlamaFileReader, LlamaFileWriter, LlamaHParams, LlamaVocab
from .formats import is_quantized, quants
from .models import llama as llama_mod
from .models.params import resolve_gq_pack
from .ops.quant_matmul import QTensor


# ---------------------------------------------------------------------------
# synthetic outlier-bearing model
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Geometry:
    n_vocab: int
    n_embd: int
    n_head: int
    n_layer: int
    n_ff: int


GEOMETRIES = {
    # tiny: CPU test geometry (q5_k and i8 need K % 256 == 0)
    "tiny": Geometry(n_vocab=512, n_embd=256, n_head=4, n_layer=2, n_ff=512),
    "small": Geometry(n_vocab=2048, n_embd=512, n_head=8, n_layer=4, n_ff=1280),
    "medium": Geometry(n_vocab=32000, n_embd=2048, n_head=16, n_layer=16, n_ff=5632),
}


def write_synth_llama(path_f32: Path, path_quant: Path, geom: Geometry,
                      quant: DataType = DataType.Q5_K, seed: int = 0,
                      outlier_frac: float = 0.01, outlier_amp: float = 30.0,
                      residual_init: bool = False) -> np.ndarray:
    """Write the same synthetic weights as an f32 ggml file and a quantized
    one (the JAX package's files, byte for byte), with persistent channel
    outliers in the residual stream.  ``residual_init``: 1/sqrt(2L) scaling
    of the residual-writing projections (wo, w2).  Returns the outlier dims."""
    rng = np.random.default_rng(seed)
    d, ff, v = geom.n_embd, geom.n_ff, geom.n_vocab
    res_scale = 1.0 / np.sqrt(2 * geom.n_layer) if residual_init else 1.0
    n_out = max(1, int(round(d * outlier_frac)))
    out_dims = rng.choice(d, n_out, replace=False)

    hp = LlamaHParams(n_vocab=v, n_embd=d, n_mult=ff, n_head=geom.n_head,
                      n_layer=geom.n_layer, n_rot=d // geom.n_head, ftype=0)
    toks = [b"<unk>", b"<s>", b"</s>"] + [b"tok%d" % i for i in range(v - 3)]
    vocab = LlamaVocab(tokens=toks, scores=[0.0] * v)
    w32 = LlamaFileWriter(path_f32, hp, vocab)
    wq = LlamaFileWriter(path_quant, hp, vocab)

    def n(*shape, scale=0.05):
        return rng.normal(0, scale, shape).astype(np.float32)

    def add(name, arr, q=False):
        a = np.ascontiguousarray(arr, np.float32).astype("<f4")
        w32.add_tensor(name, a.shape, DataType.F32, a.view(np.uint8).reshape(-1))
        if q and arr.size % 256 == 0:
            wq.add_tensor(name, arr.shape, quant, quants.quantize(arr.reshape(-1), quant))
        else:
            wq.add_tensor(name, a.shape, DataType.F32, a.view(np.uint8).reshape(-1))

    emb = n(v, d, scale=0.2)
    emb[:, out_dims] *= outlier_amp
    add("tok_embeddings.weight", emb)
    add("norm.weight", 1 + n(d))
    add("output.weight", n(v, d, scale=0.2), q=True)
    for i in range(geom.n_layer):
        p = f"layers.{i}."
        add(p + "attention_norm.weight", 1 + n(d))
        add(p + "attention.wq.weight", n(d, d), q=True)
        add(p + "attention.wk.weight", n(d, d), q=True)
        add(p + "attention.wv.weight", n(d, d), q=True)
        wo = n(d, d) * res_scale
        wo[out_dims, :] *= outlier_amp  # output rows feed the residual
        add(p + "attention.wo.weight", wo, q=True)
        add(p + "ffn_norm.weight", 1 + n(d))
        add(p + "feed_forward.w1.weight", n(ff, d), q=True)
        w2 = n(d, ff) * res_scale
        w2[out_dims, :] *= outlier_amp
        add(p + "feed_forward.w2.weight", w2, q=True)
        add(p + "feed_forward.w3.weight", n(ff, d), q=True)
    w32.write()
    wq.write()
    return out_dims


# ---------------------------------------------------------------------------
# teacher-forced evaluation
# ---------------------------------------------------------------------------


def teacher_forced_logits(params, cfg, tokens: np.ndarray,
                          cache_dtype: torch.dtype = torch.float32) -> np.ndarray:
    """[S] token ids -> [S, V] f32 logits (full-sequence forced forward) on
    the device of ``params``."""
    device = params["tok_embeddings"].device
    t = torch.from_numpy(np.asarray(tokens, np.int64))[None].to(device)
    cache = llama_mod.init_cache(cfg, 1, cache_dtype, device)
    with torch.no_grad():
        logits = llama_mod.forward(params, cache, llama_mod.embed_tokens(params, t), 0, cfg,
                                   all_logits=True)
    return logits[0].float().cpu().numpy()


def _log_softmax(x: np.ndarray) -> np.ndarray:
    m = x.max(axis=-1, keepdims=True)
    s = x - m
    return s - np.log(np.exp(s).sum(axis=-1, keepdims=True))


def logit_metrics(ref: np.ndarray, other: np.ndarray, tokens: np.ndarray) -> dict:
    """Per-position KL(ref || other), top-1 agreement, forced-NLL delta."""
    lp_ref = _log_softmax(ref)
    lp_oth = _log_softmax(other)
    p_ref = np.exp(lp_ref)
    kl = (p_ref * (lp_ref - lp_oth)).sum(axis=-1)
    top1 = float((ref.argmax(-1) == other.argmax(-1)).mean())
    nxt = np.asarray(tokens[1:], np.int64)
    idx = np.arange(len(nxt))
    nll_ref = float(-lp_ref[:-1][idx, nxt].mean())
    nll_oth = float(-lp_oth[:-1][idx, nxt].mean())
    return {
        "kl_mean": float(kl.mean()),
        "kl_p95": float(np.percentile(kl, 95)),
        "top1": top1,
        "nll_ref": nll_ref,
        "nll": nll_oth,
        "d_ppl_pct": float((np.exp(nll_oth - nll_ref) - 1.0) * 100.0),
    }


# ---------------------------------------------------------------------------
# smooth-quant calibration
# ---------------------------------------------------------------------------


def collect_activation_stats(params, cfg, token_seqs: list[np.ndarray]) -> dict:
    """Per-channel activation absmax at each quantizable matmul's input
    ("attn"/"ffn"/"w2"/"wo" [L, K]; "head" [K]), maxed over the calibration
    sequences (``llama.forward``'s ``act_stats`` capture)."""
    device = params["tok_embeddings"].device
    agg: dict[str, np.ndarray] = {}
    for seq in token_seqs:
        cache = llama_mod.init_cache(cfg, 1, torch.float32, device)
        t = torch.from_numpy(np.asarray(seq, np.int64))[None].to(device)
        st: dict = {}
        with torch.no_grad():
            llama_mod.forward(params, cache, llama_mod.embed_tokens(params, t), 0, cfg,
                              act_stats=st)
        for site, per_layer in st.items():
            arr = torch.stack(per_layer).cpu().numpy()
            if site == "head":
                arr = arr[0]
            prev = agg.get(site)
            agg[site] = arr if prev is None else np.maximum(prev, arr)
    return agg


def _weight_f32(reader: LlamaFileReader, name: str, device) -> torch.Tensor:
    """A file tensor as f32 [N, K] on ``device``; quantized ones decoded there."""
    rec = reader.tensors[name]
    if is_quantized(rec.dtype):
        return QTensor.from_raw(reader.raw(name), rec.shape, rec.dtype, device).dequantize()
    return torch.from_numpy(np.asarray(reader.tensor_f32(name), np.float32)).to(device)


def weight_col_absmax(reader: LlamaFileReader, cfg, device: str | torch.device = "cuda") -> dict:
    """Per-input-channel weight absmax for each smoothable site, maxed over
    the site's consumers (attn: wq/wk/wv; ffn: w1/w3; w2: w2; head: output);
    each weight decoded on ``device``."""

    def colmax(*names):
        m = None
        for nm in names:
            w = _weight_f32(reader, nm, device).abs().amax(dim=0)
            m = w if m is None else torch.maximum(m, w)
        return m.cpu().numpy()

    out = {"head": colmax("output.weight")}
    attn, ffn, w2 = [], [], []
    for i in range(cfg.n_layer):
        p = f"layers.{i}."
        attn.append(colmax(*(p + f"attention.w{x}.weight" for x in "qkv")))
        ffn.append(colmax(p + "feed_forward.w1.weight", p + "feed_forward.w3.weight"))
        w2.append(colmax(p + "feed_forward.w2.weight"))
    out["attn"] = np.stack(attn)
    out["ffn"] = np.stack(ffn)
    out["w2"] = np.stack(w2)
    return out


def smooth_scales(act_stats: dict, w_stats: dict, alpha: float = 0.5) -> dict:
    """SmoothQuant migration scales per site: s = act^alpha / w^(1-alpha),
    guarded to stay strictly positive and bounded.  Sites: attn/ffn/w2/head
    (wo has no affine producer to fold the reciprocal into: it keeps
    dynamic per-token quantization)."""
    out = {}
    for site in ("attn", "ffn", "w2", "head"):
        if site not in act_stats or site not in w_stats:
            continue
        a = np.asarray(act_stats[site], np.float32)
        w = np.asarray(w_stats[site], np.float32)
        s = np.power(np.maximum(a, 1e-8), alpha) / np.power(np.maximum(w, 1e-8), 1.0 - alpha)
        s = np.where((a <= 1e-8) | (w <= 1e-8), 1.0, s)
        out[site] = np.clip(s, 1e-3, 1e5).astype(np.float32)
    return out


def compute_smooth_scales(llm_path: str | Path, calib_seqs: list[np.ndarray],
                          alpha: float = 0.5, n_ctx: int | None = None,
                          device: str | torch.device = "cuda") -> dict:
    """One-call calibration on ``device``: load the (quantized) file in
    ``qtensor`` mode (packed bytes, dequantized per call), capture activation
    stats on the calibration sequences, combine with the weight column
    maxima.  The params are freed before this returns."""
    with LlamaFileReader(llm_path) as reader:
        ctx = n_ctx or max(len(s) for s in calib_seqs)
        params, cfg = llama_mod.load_params(reader, torch.float32, n_ctx=ctx, device=device,
                                            quant_mode="qtensor")
        act = collect_activation_stats(params, cfg, calib_seqs)
        del params
        wmax = weight_col_absmax(reader, cfg, device)
    return smooth_scales(act, wmax, alpha)


def save_smooth_scales(path: str | Path, scales: dict) -> None:
    np.savez(path, **scales)


def load_smooth_scales(path: str | Path) -> dict:
    z = np.load(path)
    return {k: z[k] for k in z.files}


# ---------------------------------------------------------------------------
# the comparison harness
# ---------------------------------------------------------------------------

PATHS = ("q5k", "gq", "w8a8", "w8a8_smooth", "f8_cache")


def evaluate_paths(f32_path: Path, quant_path: Path, seq_len: int = 128, calib_len: int = 64,
                   n_calib: int = 2, alpha: float = 0.5, seed: int = 7,
                   paths: tuple[str, ...] = PATHS, quant_mode_exact: str = "auto",
                   artifacts: dict | None = None,
                   device: str | torch.device = "cuda") -> dict:
    """{path name: metrics} against the f32 dense reference, every path
    through the file -> load_params pipeline on ``device``.  The ``gq`` row
    loads as an explicit ``quant_mode="gq"`` does and records the code
    storage it measured, ``"packed"``, as the JAX package's row does; every
    row stores gq codes as an engine of its mode would
    (``params.resolve_gq_pack``)."""
    rng = np.random.default_rng(seed)
    n_ctx = max(seq_len, 8)
    with LlamaFileReader(f32_path) as r32:
        ref_params, cfg = llama_mod.load_params(r32, torch.float32, n_ctx=n_ctx, device=device)
    v = cfg.n_vocab
    tokens = rng.integers(3, v, seq_len).astype(np.int32)
    calib = [rng.integers(3, v, calib_len).astype(np.int32) for _ in range(n_calib)]
    ref_logits = teacher_forced_logits(ref_params, cfg, tokens)
    del ref_params

    def run(mode, smooth=None, cache_dtype=torch.float32):
        with LlamaFileReader(quant_path) as r:
            p, c = llama_mod.load_params(r, torch.float32, n_ctx=n_ctx, device=device,
                                         quant_mode=mode, smooth=smooth,
                                         pack=resolve_gq_pack(mode))
        lg = teacher_forced_logits(p, c, tokens, cache_dtype=cache_dtype)
        del p
        return logit_metrics(ref_logits, lg, tokens)

    results: dict[str, dict] = {}
    if "q5k" in paths:
        results["q5k"] = run(quant_mode_exact)
    if "gq" in paths:
        results["gq"] = dict(run("gq"), packed=resolve_gq_pack("gq"))
    if "w8a8" in paths:
        results["w8a8"] = run("w8a8")
    if "w8a8_smooth" in paths:
        sm = compute_smooth_scales(quant_path, calib, alpha=alpha, n_ctx=max(calib_len, 8),
                                   device=device)
        if artifacts is not None:
            artifacts["smooth_scales"] = sm
        results["w8a8_smooth"] = run("w8a8", smooth=sm)
    if "f8_cache" in paths:
        results["f8_cache"] = run(quant_mode_exact, cache_dtype=torch.float8_e4m3fn)
    return results


def _fmt_table(results: dict) -> str:
    cols = ["path", "kl_mean", "kl_p95", "top1", "d_ppl_pct"]
    lines = ["  ".join(f"{c:>12}" for c in cols)]
    for name, m in results.items():
        lines.append("  ".join([f"{name:>12}"] + [f"{m[c]:12.5f}" for c in cols[1:]]))
    return "\n".join(lines)


def gates(results: dict) -> tuple[bool | None, bool | None]:
    """(w8a8_smooth, gq) default-eligible against the exact path's budget:
    mean KL at most 1.5x the exact path's, top-1 at most 0.02 below it."""

    def ok(name):
        if "q5k" not in results or name not in results:
            return None
        return bool(results[name]["kl_mean"] <= 1.5 * results["q5k"]["kl_mean"]
                    and results[name]["top1"] >= results["q5k"]["top1"] - 0.02)

    return ok("w8a8_smooth"), ok("gq")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--geometry", default="small", choices=sorted(GEOMETRIES))
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--calib-len", type=int, default=64)
    ap.add_argument("--alpha", type=float, default=0.5)
    ap.add_argument("--outlier-amp", type=float, default=30.0)
    ap.add_argument("--outlier-frac", type=float, default=0.01)
    ap.add_argument("--residual-init", action="store_true",
                    help="GPT-style 1/sqrt(2L) residual-projection scaling")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--workdir", default=None, help="where to write the synthetic model pair")
    ap.add_argument("--model-f32", default=None, help="existing f32/f16 ggml llama file")
    ap.add_argument("--model-quant", default=None, help="existing quantized ggml llama file")
    ap.add_argument("--save-scales", default=None,
                    help="also write the calibrated smooth scales npz here")
    ap.add_argument("--device", default="cuda", help="torch device (cuda, cpu)")
    args = ap.parse_args(argv)

    if args.model_f32 and args.model_quant:
        f32_p, q_p = Path(args.model_f32), Path(args.model_quant)
    else:
        import tempfile

        work = Path(args.workdir) if args.workdir else Path(
            tempfile.mkdtemp(prefix="minigpt4_quality_"))
        work.mkdir(parents=True, exist_ok=True)
        f32_p, q_p = work / "synth_f32.bin", work / "synth_q5k.bin"
        if not (f32_p.exists() and q_p.exists()):
            write_synth_llama(f32_p, q_p, GEOMETRIES[args.geometry], seed=args.seed,
                              outlier_frac=args.outlier_frac, outlier_amp=args.outlier_amp,
                              residual_init=args.residual_init)
        print(f"[quality] synthetic pair at {work} (outlier amp {args.outlier_amp}, "
              f"frac {args.outlier_frac})")

    artifacts: dict = {}
    results = evaluate_paths(f32_p, q_p, seq_len=args.seq_len, calib_len=args.calib_len,
                             alpha=args.alpha, seed=args.seed, artifacts=artifacts,
                             device=args.device)
    if args.save_scales:
        save_smooth_scales(args.save_scales, artifacts["smooth_scales"])
        print(f"[quality] smooth scales -> {args.save_scales}")
    print(_fmt_table(results))
    gate, gq_ok = gates(results)
    print(f"[quality] w8a8_smooth default-eligible vs q5_k budget: {gate}")
    print(f"[quality] gq default-eligible vs q5_k budget: {gq_ok}")
    print(json.dumps({"quality": {k: {m: v[m] for m in ("kl_mean", "top1", "d_ppl_pct")}
                                  for k, v in results.items()},
                      "w8a8_smooth_ok": gate, "gq_ok": gq_ok}))
    return results


if __name__ == "__main__":
    main()
