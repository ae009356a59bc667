"""Multi-rank dry run of the port's parallel paths, and the rank runner.

Counterpart of ``__graft_entry__.dryrun_multichip`` (steps 3 to 6):

    python -m minigpt4_tpu_torch.parallel.dryrun --nproc N [--device cpu]

spawns N ranks (one process each, a ``file://`` rendezvous in a temporary
directory, gloo on the CPU and where ranks share a card, NCCL where each
has its own) on small synthetic files it writes first, and prints one
``[dryrun] ... ok`` line per step:

  3. the sharded quantized decoder (q4_0 file, ``quant_mode="repack"``):
     prefill logits and 4 greedy tokens of the fused decode loop against
     the unsharded decoder;
  4. sequence-parallel decode attention: the cache's positions split over
     the ranks, the flash partials merged, against the kernel on the whole
     cache;
  5. the two-stage pipeline (rank 0, both stages on its device) against
     the sequential engine;
  6. ``MiniGPT4Engine(tp=N)``: greedy tokens of a chat equal to tp=1.

Steps 1 (the sharded training step) and 2 (auto-SPMD placement) are not
ported.  :func:`run_ranks` runs any module-level function on N ranks with
a deadline.
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from ..formats import ContainerWriter, DataType, LlamaFileWriter, LlamaHParams, LlamaVocab
from ..formats import quants

# ---------------------------------------------------------------------------
# running a function on N ranks
# ---------------------------------------------------------------------------


def _rank_main(fn, rank: int, nproc: int, device: str, init_method: str, out_dir: str,
               args: tuple, collective_timeout_s: float) -> None:
    import torch.distributed as dist

    from .mesh import init_tp

    torch.set_num_threads(1)
    try:
        g = init_tp(nproc, device, init_method=init_method, rank=rank,
                    timeout_s=collective_timeout_s)
        result = ("ok", fn(g, *args))
    except BaseException:  # reported to the parent, which raises it
        result = ("error", traceback.format_exc())
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(result, f)
    if dist.is_initialized():
        dist.destroy_process_group()


def run_ranks(fn, nproc: int, args: tuple = (), device: str = "cuda",
              timeout_s: float = 120.0) -> list:
    """``fn(group, *args)`` on ``nproc`` spawned ranks of one group; returns
    each rank's result, in rank order.  Every rank is joined by a deadline
    ``timeout_s`` after the start and killed past it (TimeoutError); an
    exception in a rank is raised here with its traceback.  ``fn`` and
    ``args`` must pickle (a module-level function)."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="mgt_ranks_") as d:
        init = Path(d, "rendezvous").as_uri()
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, nproc, device, init, d, args, timeout_s))
                 for r in range(nproc)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        late = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(10)
        if late:
            raise TimeoutError(f"ranks {late} of {nproc} still running after {timeout_s} s")
        results, errors = [], []
        for r, p in enumerate(procs):
            path = Path(d, f"rank{r}.pkl")
            if not path.exists():
                errors.append(f"rank {r} exited with code {p.exitcode} and no result")
                continue
            with open(path, "rb") as f:  # written by this function's own ranks
                status, value = pickle.load(f)
            if status == "ok":
                results.append(value)
            else:
                errors.append(f"rank {r}:\n{value}")
        if errors:
            raise RuntimeError("\n".join(errors))
        return results


# ---------------------------------------------------------------------------
# small synthetic model files
# ---------------------------------------------------------------------------

VIT_D, VIT_DEPTH, VIT_HEADS, VIT_MLP = 32, 2, 4, 64
QF_HIDDEN, QF_LAYERS, QF_HEADS, QF_QUERIES = 16, 2, 2, 4
VOCAB_PIECES = [b" Human", b" Assistant", b"###"]


def write_container(path, rng: np.random.Generator, llm_d: int, quant: DataType | None = None):
    """A tiny minigpt4 container (ViT 28 px / patch 14, d 32, 2 blocks; a
    2-layer Q-Former of hidden 16 with 4 queries; a projection to
    ``llm_d``), f32, with ``quant`` in the 2-D projection weights whose
    size divides by 256."""
    cfg = {"ftype": "f32", "vit": {"head_dim": VIT_D // VIT_HEADS},
           "Qformer": {"encoder_width": VIT_D, "query_length": QF_QUERIES,
                       "num_hidden_layers": QF_LAYERS, "hidden_size": QF_HIDDEN,
                       "num_attention_heads": QF_HEADS, "intermediate_size": QF_HIDDEN * 2}}
    w = ContainerWriter(path, ftype=1, config=cfg)

    def n(*shape, scale=0.05):
        return rng.normal(0, scale, shape).astype(np.float32)

    def add(lst, name, arr, q=False):
        if q and quant is not None and arr.ndim == 2 and arr.size % 256 == 0:
            lst.append((name, arr.shape, quant, quants.quantize(arr.reshape(-1), quant)))
        else:
            a = np.ascontiguousarray(arr, np.float32).astype("<f4")
            lst.append((name, a.shape, DataType.F32, a.view(np.uint8).reshape(-1)))

    ve = []
    add(ve, "patch_embed.proj.weight", n(VIT_D, 3, 14, 14))
    add(ve, "patch_embed.proj.bias", n(VIT_D))
    add(ve, "cls_token", n(VIT_D))
    add(ve, "pos_embed", n(5, VIT_D))
    for i in range(VIT_DEPTH):
        p = f"blocks.{i}."
        add(ve, p + "norm1.weight", 1 + n(VIT_D))
        add(ve, p + "norm1.bias", n(VIT_D))
        add(ve, p + "attn.qkv.weight", n(3 * VIT_D, VIT_D), q=True)
        add(ve, p + "attn.q_bias", n(VIT_D))
        add(ve, p + "attn.v_bias", n(VIT_D))
        add(ve, p + "attn.proj.weight", n(VIT_D, VIT_D), q=True)
        add(ve, p + "attn.proj.bias", n(VIT_D))
        add(ve, p + "norm2.weight", 1 + n(VIT_D))
        add(ve, p + "norm2.bias", n(VIT_D))
        add(ve, p + "mlp.fc1.weight", n(VIT_MLP, VIT_D), q=True)
        add(ve, p + "mlp.fc1.bias", n(VIT_MLP))
        add(ve, p + "mlp.fc2.weight", n(VIT_D, VIT_MLP), q=True)
        add(ve, p + "mlp.fc2.bias", n(VIT_D))
    w.add_model("visual_encoder", ve)
    lv = []
    add(lv, "weight", 1 + n(VIT_D))
    add(lv, "bias", n(VIT_D))
    w.add_model("ln_vision", lv)
    qt = []
    add(qt, "weight", n(QF_QUERIES, QF_HIDDEN))
    w.add_model("query_tokens", qt)
    qf = []
    add(qf, "bert.embeddings.LayerNorm.weight", 1 + n(QF_HIDDEN))
    add(qf, "bert.embeddings.LayerNorm.bias", n(QF_HIDDEN))
    for i in range(QF_LAYERS):
        p = f"bert.encoder.layer.{i}."
        for blk, width in [("attention.", QF_HIDDEN)] + (
                [("crossattention.", VIT_D)] if i % 2 == 0 else []):
            add(qf, p + blk + "self.query.weight", n(QF_HIDDEN, QF_HIDDEN))
            add(qf, p + blk + "self.query.bias", n(QF_HIDDEN))
            add(qf, p + blk + "self.key.weight", n(QF_HIDDEN, width))
            add(qf, p + blk + "self.key.bias", n(QF_HIDDEN))
            add(qf, p + blk + "self.value.weight", n(QF_HIDDEN, width))
            add(qf, p + blk + "self.value.bias", n(QF_HIDDEN))
            add(qf, p + blk + "output.dense.weight", n(QF_HIDDEN, QF_HIDDEN))
            add(qf, p + blk + "output.dense.bias", n(QF_HIDDEN))
            add(qf, p + blk + "output.LayerNorm.weight", 1 + n(QF_HIDDEN))
            add(qf, p + blk + "output.LayerNorm.bias", n(QF_HIDDEN))
        add(qf, p + "intermediate_query.dense.weight", n(QF_HIDDEN * 2, QF_HIDDEN))
        add(qf, p + "intermediate_query.dense.bias", n(QF_HIDDEN * 2))
        add(qf, p + "output_query.dense.weight", n(QF_HIDDEN, QF_HIDDEN * 2))
        add(qf, p + "output_query.dense.bias", n(QF_HIDDEN))
        add(qf, p + "output_query.LayerNorm.weight", 1 + n(QF_HIDDEN))
        add(qf, p + "output_query.LayerNorm.bias", n(QF_HIDDEN))
    w.add_model("Qformer", qf)
    pj = []
    add(pj, "weight", n(llm_d, QF_HIDDEN))
    add(pj, "bias", n(llm_d))
    w.add_model("llama_proj", pj)
    w.write()
    return path


def write_llm(path, rng: np.random.Generator, d: int, n_head: int, n_mult: int,
              n_layer: int = 2, quant: DataType | None = None):
    """A ggjt-v3 LLaMA of width ``d``, ``n_head`` heads and ``n_layer``
    layers, a vocabulary of the 3 specials, the 256 byte tokens and 3
    pieces; f32, with ``quant`` in the output and projection weights whose
    size divides by 256."""
    hp = LlamaHParams(n_vocab=262, n_embd=d, n_mult=n_mult, n_head=n_head, n_layer=n_layer,
                      n_rot=d // n_head, ftype=0)
    ff = hp.n_ff
    toks = [b"<unk>", b"<s>", b"</s>"] + [bytes([b]) for b in range(256)] + VOCAB_PIECES
    w = LlamaFileWriter(path, hp, LlamaVocab(tokens=toks, scores=[0.0] * 259 + [1.0, 1.0, 2.0]))

    def n(*shape, scale=0.05):
        return rng.normal(0, scale, shape).astype(np.float32)

    def add(name, arr, q=False):
        if q and quant is not None and arr.size % 256 == 0:
            w.add_tensor(name, arr.shape, quant, quants.quantize(arr.reshape(-1), quant))
        else:
            a = np.ascontiguousarray(arr, np.float32).astype("<f4")
            w.add_tensor(name, a.shape, DataType.F32, a.view(np.uint8).reshape(-1))

    add("tok_embeddings.weight", n(hp.n_vocab, d, scale=0.2))
    add("norm.weight", 1 + n(d))
    add("output.weight", n(hp.n_vocab, d, scale=0.2), q=True)
    for i in range(n_layer):
        p = f"layers.{i}."
        add(p + "attention_norm.weight", 1 + n(d))
        for t in ("wq", "wk", "wv", "wo"):
            add(p + f"attention.{t}.weight", n(d, d), q=True)
        add(p + "ffn_norm.weight", 1 + n(d))
        add(p + "feed_forward.w1.weight", n(ff, d), q=True)
        add(p + "feed_forward.w2.weight", n(d, ff), q=True)
        add(p + "feed_forward.w3.weight", n(ff, d), q=True)
    w.write()
    return path


def write_models(out_dir, quant: DataType | None = None, seed: int = 42, d: int = 256,
                 n_head: int = 4, n_mult: int = 256) -> tuple[Path, Path]:
    """(container, LLM) pair written into ``out_dir``.  The defaults (width
    256, 4 heads of 64) suit the card's kernels too; ``d=32, n_mult=128``
    writes the bytes of the JAX package's ``tests/fixtures.py`` pair."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    tag = quant.name.lower() if quant is not None else "f32"
    model = write_container(out / f"minigpt4-{tag}-d{d}.bin", rng, d, quant)
    llm = write_llm(out / f"llama-{tag}-d{d}-h{n_head}.bin", rng, d, n_head, n_mult, quant=quant)
    return model, llm


# ---------------------------------------------------------------------------
# rank functions
# ---------------------------------------------------------------------------

QUESTION = "what is this?"


def _greedy():
    from ..engine.sampling import SamplingParams

    return SamplingParams(temp=0.0)


def chat_tokens(eng, limit: int = 10) -> list[str]:
    """The chat of the JAX package's tp tests: system prompt, one question,
    greedy generate."""
    eng.system_prompt()
    eng.begin_chat(QUESTION)
    return list(eng.generate(limit=limit, params=_greedy()))


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------


def dryrun_rank(g, files: dict) -> dict:
    """Steps 3 to 6 on this rank; rank 0 prints a line per step."""
    from ..engine.device_sampling import lane_rows
    from ..engine.engine import MiniGPT4Engine
    from ..formats import LlamaFileReader
    from ..models import llama as llama_mod
    from ..ops.flash_decode import flash_decode_attention, sp_flash_decode_attention
    from .pipeline import TwoStagePipeline
    from .spmd import cache_cfg, shard_llama_params

    def say(msg):
        if g.rank == 0:
            print(f"[dryrun] {msg}", flush=True)

    dev = g.device
    # 3: the sharded quantized decoder against the unsharded one
    with LlamaFileReader(files["q_llm"]) as r:
        params, cfg = llama_mod.load_params(r, torch.float32, n_ctx=64, device=dev,
                                            quant_mode="repack")
    sharded = shard_llama_params(params, g)
    kinds = {n: type(v["w"]).__name__ for n, v in sharded["layers"].items() if isinstance(v, dict)}
    toks = torch.tensor([[1, 7, 9, 4, 11, 2]], device=dev)
    with torch.no_grad():
        caches = [llama_mod.init_cache(c, 1, torch.float32, dev)
                  for c in (cfg, cache_cfg(cfg, g.size))]
        runs = []
        for p, cache, tp in ((params, caches[0], None), (sharded, caches[1], g)):
            logits = llama_mod.forward(p, cache, llama_mod.embed_tokens(p, toks), 0, cfg, tp=tp)
            gen = torch.Generator(device=dev)
            rows = lane_rows([_greedy()], cfg.n_vocab, dev)
            ids, _ = llama_mod.decode_loop(p, cache, logits, toks.shape[1], 4, [gen], rows, cfg,
                                           tp=tp)
            runs.append((logits.cpu().numpy(), ids.cpu().tolist()))
    np.testing.assert_allclose(runs[1][0], runs[0][0], rtol=5e-3, atol=5e-4)
    if runs[1][1] != runs[0][1]:
        raise AssertionError(f"sharded decode tokens {runs[1][1]} != {runs[0][1]}")
    say(f"sharded quantized tp ok over {g.size} ranks ({kinds}), tokens {runs[1][1][0]}")

    # 4: sequence-parallel attention against the kernel on the whole cache
    rng = np.random.default_rng(0)
    b, h, c, dh, pos0, scale = 1, 2, 256 * g.size, 128, 100, 0.09
    q = torch.from_numpy(rng.normal(0, 1, (b, h, 1, dh)).astype(np.float32)).to(dev)
    ckv = torch.from_numpy(rng.normal(0, 1, (1, b, h, c, dh)).astype(np.float32)).to(dev)
    want = flash_decode_attention(q, ckv, ckv, 0, pos0, scale)
    c_local = c // g.size
    part = ckv[:, :, :, g.rank * c_local:(g.rank + 1) * c_local].contiguous()
    got = sp_flash_decode_attention(q, part, part, 0, pos0, scale, g, g.rank * c_local)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=2e-5, atol=2e-5)
    say(f"sequence-parallel flash attention ok over {g.size} ranks")

    # 5: the pipeline on rank 0, both stages on its device
    if g.rank == 0:
        imgs = [np.random.default_rng(s).normal(0, 1, (3, 28, 28)).astype(np.float32)
                for s in range(2)]
        ref = MiniGPT4Engine(files["llm_model"], files["llm"], n_ctx=256, n_batch=32,
                             device=dev)
        want_txt = []
        for im in imgs:
            ref.reset_chat()
            ref.system_prompt()
            ref.begin_chat_image(ref.encode_image(im), "what?")
            want_txt.append("".join(ref.generate(limit=4, params=_greedy())))
        ref.close()
        peng = MiniGPT4Engine(files["llm_model"], files["llm"], n_ctx=256, n_batch=32,
                              device=dev)
        pipe = TwoStagePipeline(peng, dev, dev)
        for i, im in enumerate(imgs):
            pipe.submit(i, im)
        outs = list(pipe.results("what?", limit=4))
        peng.close()
        if outs != list(enumerate(want_txt)):
            raise AssertionError(f"pipeline {outs} != sequential {want_txt}")
        say(f"two-stage pipeline ok ({len(outs)} requests)")

    # 6: the engine at tp=N against tp=1
    one = MiniGPT4Engine(files["llm_model"], files["llm"], n_ctx=256, n_batch=16, device=dev)
    want_toks = chat_tokens(one)
    one.close()
    eng = MiniGPT4Engine(files["llm_model"], files["llm"], n_ctx=256, n_batch=16,
                         device=dev.type, tp=g.size)
    got_toks = chat_tokens(eng)
    eng.close()
    if got_toks != want_toks:
        raise AssertionError(f"tp={g.size} tokens {got_toks} != tp=1 {want_toks}")
    say(f"engine tp={g.size} greedy tokens equal to tp=1 ({len(got_toks)} tokens), "
        f"backend {g.backend}")
    return {"tokens": got_toks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nproc", type=int, default=2, help="ranks (default 2)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the ranks' device (cuda: rank r on cuda:r %% device_count)")
    ap.add_argument("--timeout", type=float, default=600.0, help="deadline of the ranks, s")
    a = ap.parse_args(argv)
    if a.device == "cuda" and not torch.cuda.is_available():
        print("dryrun: torch.cuda.is_available() is false; pass --device cpu", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="mgt_dryrun_") as d:
        model, llm = write_models(d)
        _, q_llm = write_models(Path(d, "q4_0"), quant=DataType.Q4_0)
        files = {"llm_model": str(model), "llm": str(llm), "q_llm": str(q_llm)}
        run_ranks(dryrun_rank, a.nproc, (files,), device=a.device, timeout_s=a.timeout)
    print(f"[dryrun] all steps ok on {a.nproc} ranks ({a.device}) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    sys.exit(main())
