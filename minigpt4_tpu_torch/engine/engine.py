"""MiniGPT4Engine on PyTorch: the chat operations of the reference's
``MiniGPT4`` class (minigpt4.cpp:1740-2522), counterpart of
``minigpt4_tpu/engine/engine.py`` for the one-image chat path.

Owns the vision and decoder params on ``device``, the KV cache, the decode
cursor, the tokenizer and the samplers:

    encode_image        pixels -> [32, n_embd] image embedding
    add_strings/tokens  prefill (always add_bos=true, like the reference)
    add_embedding       inject embedding rows as pseudo-tokens
    system_prompt, begin_chat_image, begin_chat, end_chat, generate, reset

Prefill chunks are padded to power-of-two buckets (8 .. n_batch), capped
at the remaining context; padded rows write cache entries past the real
tokens, which the causal mask hides and the next chunk overwrites.  Decode
samples on the device in the reference's sample-then-eval order;
``generate`` decodes chunks of tokens with one host synchronisation per
chunk and rolls the cursor back over what it decoded past EOS or the limit.

Every operation acts on a :class:`DecodeState`: the engine's own by
default, or one passed as ``st``.  The serving sessions
(``engine/sessions.py``) each own a state with a cache of ``session_ctx``
positions (:meth:`MiniGPT4Engine.new_state`) and share the loaded model.

On a CUDA engine at tp = 1 the steps of the engine's own state (prefill
chunks, the single-token step, decode chunks) and the image encoder replay
captured CUDA graphs (``engine/graphs.py``), captured lazily on the second
use of each key or ahead of time by :meth:`MiniGPT4Engine.warmup`.  They run
eagerly on a CPU engine, under tp > 1 (gloo's all-reduces cannot be
captured) and on states made by ``new_state``; ``graphs_enabled`` (True
exactly where graphs run) set to False runs the same steps eagerly.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from pathlib import Path

import numpy as np
import torch

from .. import utils
from ..formats import ContainerReader, LlamaFileReader, is_quantized
from ..tokenizer import LlamaTokenizer
from ..models import llama as llama_mod
from ..models import minigpt4 as vision_mod
from ..models.params import QUANT_MODES, resolve_gq_pack
from ..ops import group_i8 as gq
from ..parallel import spmd
from ..parallel.mesh import init_tp
from .device_sampling import DeviceSamplingConfig, lane_rows, logit_bias_tensor, sample_token
from .graphs import GraphCache, StepGraphs, pool_bytes
from .sampling import Sampler, SamplingParams

SYSTEM_PROMPT = (
    "Give the following image: <Img>ImageContent</Img>. "
    "You will be able to see the image once I provide it to you. "
    "Please answer my questions.###"
)
EOS_TOKEN_SUFFIX = "##"
EOS_SUFFIX = "###"
DECODE_CHUNK = 16  # tokens decoded on the device per host synchronisation
COMPUTE_DTYPE = torch.float32  # activations and dense weights (engine.py:1039)
# KV cache element types by their CLI names (the JAX engine's CACHE_DTYPES):
# e4m3 halves the cache's memory and its decode-attention traffic
CACHE_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "f8": torch.float8_e4m3fn}


def _bucket(n: int, cap: int) -> int:
    b = 8
    while b < n:
        b *= 2
    return min(b, cap)


def _attn_bucket(needed: int, n_ctx: int) -> int:
    """Power-of-two attention span covering ``needed`` positions."""
    b = 128
    while b < needed:
        b *= 2
    return min(b, n_ctx)


def disable_tf32() -> None:
    """f32 matmuls and convolutions in full f32 (TF32 keeps ~3 digits)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class DecodeState:
    """One decode cursor: KV cache, n_past, pending logits (on the device),
    the sampling generator, the evaluated token ids and the keep marker.
    ``n_ctx`` is the cache's length: the state's context limit."""

    def __init__(self, cache: dict, generator: torch.Generator):
        self.cache = cache
        self.n_ctx = cache["k"].shape[3]
        self.generator = generator
        self.n_past = 0
        self.logits: torch.Tensor | None = None  # [V] f32 on the device
        self.tokens: list[int] = []  # one per cache position, -1 for embeddings
        self.n_keep = 0  # system prompt + image prefix

    def reset(self) -> None:
        self.n_past = 0
        self.logits = None
        self.tokens = []
        self.n_keep = 0


class MiniGPT4Engine:
    def __init__(
        self,
        model_path: str | Path,
        llm_path: str | Path,
        verbosity: int = utils.Verbosity.SILENT,
        seed: int = 1337,
        n_ctx: int = 2048,
        n_batch: int = 512,
        device: str | torch.device = "cuda",
        quant_mode: str = "auto",
        cache_dtype: str | torch.dtype | None = None,
        smooth_scales: str | Path | dict | None = None,
        tp: int = 1,
        dp: int = 1,
    ):
        """Load both model files onto ``device``.

        ``quant_mode`` picks the form of quantized weights, with the JAX
        engine's values (``auto | repack | qtensor | w8a8 | gq``).  The vision
        weights load with it as given: ``auto`` and ``repack`` make them
        repacked (the fused dequant-matmul, as on the TPU).  For the decoder
        ``auto`` resolves to ``gq``, the form the TPU's budget resolution
        picks for every supported model when it fits, which 80 GB always
        allows: group-quant (exact planes for q4_k/q5_k, bf16 planes for
        q4_0, q4_1, q5_0, q5_1, q8_0, q2_k, q3_k and q6_k, so llama.cpp's
        mixed K_M files load as they are) where ``group_i8.supported``
        accepts a weight, repacked otherwise; ``repack`` makes every decoder
        weight repacked.  ``w8a8`` makes every weight with K % 256 == 0 i8
        codes with superblock scales (``ops/i8_matmul.py``) and the others
        the ``auto`` form; ``qtensor`` keeps the packed ggml bytes and
        dequantizes them on every call.  The resolved decoder mode is
        ``self.quant_mode``.

        ``cache_dtype``: the KV cache's element type, a name of
        ``CACHE_DTYPES`` ("f32", "bf16", "f8" for e4m3) or a torch dtype;
        ``None`` is bf16, what the JAX engine's ``pick_cache_dtype`` picks
        for every supported model on an 80 GB card (it takes e4m3 only where
        the i8 weights and a bf16 cache would not fit a 16 GB chip).
        ``self.cache_dtype`` is the resolved type.

        ``smooth_scales``: smooth-quant migration scales (an npz path of
        ``quality.save_smooth_scales`` or a dict) folded into the decoder's
        w8a8 weights.  With ``auto`` they resolve the decoder to ``w8a8``;
        any other decoder mode ignores them, with a log line, as the JAX
        engine does.

        gq code storage (``ops/group_i8.py``), resolved as the JAX engine's
        ``resolve_llm_quant_mode`` resolves it: ``auto`` stores one byte per
        code (its unpacked codes fit every supported model on 80 GB), an
        explicit ``gq`` packs the 4/5/6-bit formats (0.5, 0.625 or 0.75 B per
        code) in the decoder and the vision weights alike, and the
        environment variable ``MINIGPT4_TPU_GQ_PACK`` ("0" off, else on)
        overrides both.  ``self.gq_packed`` says whether the gq weights are
        packed.

        ``tp``: tensor-parallel ranks.  With tp > 1 this process is one rank
        of a group (``parallel.mesh.init_tp``: the caller's default process
        group, or one made from the ``torchrun`` environment), every rank
        builds the same engine, and the decoder is placed as the JAX
        engine's ``MiniGPT4Engine(tp=N)`` places it (``parallel/spmd.py``:
        column-parallel qkv/w13, K-sharded wo/w2, a vocab-parallel head, KV
        heads over the ranks); the vision weights stay whole on every rank.
        ``device="cuda"`` puts rank r on ``cuda:{r % device_count}``.
        Greedy output equals tp=1.  Refused: a decoder with any group-quant
        weight (``gq``, which ``auto`` resolves to for every weight
        ``group_i8.supported`` takes; the JAX package cannot place one
        either), n_head not divisible by tp, and attention projections that
        would stay whole.  ``self.tp_group`` is the rank's group (None at
        tp=1).  ``dp`` must be 1, as in the JAX engine: the chat surface
        prefills at batch 1."""
        if dp != 1:
            raise ValueError(
                f"dp={dp}: the engine's chat and serving surface prefills at batch 1 and cannot "
                "shard it over a dp axis; use tp for a model over several ranks, or batch "
                "sessions (SessionPool.generate_batch)")
        if tp < 1:
            raise ValueError(f"tp={tp}: needs at least one rank")
        if quant_mode not in QUANT_MODES:
            raise ValueError(f"unknown quant_mode {quant_mode!r}: expected "
                             f"{' | '.join(QUANT_MODES)}")
        cache_dtype = CACHE_DTYPES.get(cache_dtype, cache_dtype) or torch.bfloat16
        if cache_dtype not in CACHE_DTYPES.values():
            raise ValueError(f"unknown cache_dtype {cache_dtype!r}: expected "
                             f"{' | '.join(CACHE_DTYPES)}")
        utils.set_verbosity(verbosity)
        disable_tf32()
        # the decoder's mode: auto is gq, or w8a8 where calibration scales
        # are given (a deliberate w8a8 opt-in)
        self.quant_mode = quant_mode
        if quant_mode == "auto":
            self.quant_mode = "w8a8" if smooth_scales else "gq"
        if tp > 1:  # refused before any weight loads or any rank joins
            with LlamaFileReader(llm_path) as reader:
                check_tp(reader, self.quant_mode, tp)
        self.tp = tp
        self.tp_group = init_tp(tp, device) if tp > 1 else None
        self.device = self.tp_group.device if self.tp_group else torch.device(device)
        self.n_batch = n_batch
        self.cache_dtype = cache_dtype
        pack = resolve_gq_pack(quant_mode)
        with utils.phase_timer("Load minigpt4 model"):
            self._container = ContainerReader(model_path)
            self.vision_params, self.vision_cfg = vision_mod.load_params(
                self._container, COMPUTE_DTYPE, self.device, quant_mode, pack)
        if isinstance(smooth_scales, (str, Path)):
            from ..quality import load_smooth_scales

            smooth_scales = load_smooth_scales(smooth_scales)
        with utils.phase_timer("LLM model init"):
            self._llm_file = LlamaFileReader(llm_path)
            if self.quant_mode != quant_mode:
                why = "smooth_scales given" if smooth_scales else "decoder"
                utils.log_info(f"quant_mode auto -> {self.quant_mode} ({why})")
            if smooth_scales and self.quant_mode != "w8a8":
                utils.log_info("smooth_scales ignored (decoder not on w8a8)")
                smooth_scales = None
            self.gq_packed = self.quant_mode == "gq" and pack
            if self.quant_mode == "gq":
                utils.log_info(f"quant_mode {quant_mode}: gq codes "
                               f"{'packed' if self.gq_packed else 'unpacked'}")
            self.llm_params, self.llm_cfg = llama_mod.load_params(
                self._llm_file, COMPUTE_DTYPE, n_ctx=n_ctx, device=self.device,
                quant_mode=self.quant_mode, smooth=smooth_scales, pack=pack)
            if self.tp_group is not None:
                self.llm_params = spmd.shard_llama_params(self.llm_params, self.tp_group)
            self.tokenizer = LlamaTokenizer(self._llm_file.vocab.tokens,
                                            self._llm_file.vocab.scores)
        if self.vision_cfg.llama_embed_dim != self.llm_cfg.n_embd:
            raise ValueError(
                f"model mismatch: llama_proj -> {self.vision_cfg.llama_embed_dim}, "
                f"LLM n_embd = {self.llm_cfg.n_embd}")
        self.cache_cfg = spmd.cache_cfg(self.llm_cfg, tp)  # sizes this rank's caches
        self._st = self.new_state(self.llm_cfg.n_ctx, seed)
        self.sampler = Sampler(seed)
        # captured CUDA graphs: on a CUDA engine at tp = 1, captured lazily
        self.graphs_enabled = self.device.type == "cuda" and self.tp_group is None
        self._graph_pool = None
        self._step_graphs: StepGraphs | None = None
        self._encode_graphs: GraphCache | None = None

    def new_state(self, n_ctx: int, seed: int) -> DecodeState:
        """A fresh decode state with a cache of ``n_ctx`` positions and its
        own sampling generator seeded with ``seed``."""
        if not 0 < n_ctx <= self.llm_cfg.n_ctx:
            raise ValueError(f"state context {n_ctx} outside (0, {self.llm_cfg.n_ctx}]")
        generator = torch.Generator(device=self.device)
        generator.manual_seed(seed)
        cfg = dataclasses.replace(self.cache_cfg, n_ctx=n_ctx)
        return DecodeState(llama_mod.init_cache(cfg, 1, self.cache_dtype, self.device),
                           generator)

    def _state(self, st: DecodeState | None) -> DecodeState:
        return self._st if st is None else st

    @property
    def n_past(self) -> int:
        return self._st.n_past

    @property
    def cache(self) -> dict:
        return self._st.cache

    # ------------------------------------------------------------------
    # captured steps
    # ------------------------------------------------------------------

    @property
    def graph_pool(self):
        """The memory pool all captured graphs of this engine share (the
        session pool's paged group too); made on first use."""
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        return self._graph_pool

    def _steps(self, st: DecodeState) -> StepGraphs | None:
        """The captured steps of ``st``'s cache, or None where ``st`` runs
        eagerly: a state of ``new_state`` (serving sessions), tp > 1 and a
        CPU engine."""
        if st is not self._st or not self.graphs_enabled:
            return None
        if self._step_graphs is None:
            self._step_graphs = StepGraphs(self.llm_params, self.llm_cfg, st.cache, self.device,
                                           self.graph_pool)
        return self._step_graphs

    def _encode(self, x: torch.Tensor, capture: bool = False) -> torch.Tensor:
        """pixels [B, 3, S, S] on the device -> [B, 32, n_embd], through the
        encoder's graph of batch B on a graph engine."""
        if not self.graphs_enabled:
            return vision_mod.encode_image(self.vision_params, x, self.vision_cfg)
        if self._encode_graphs is None:
            self._encode_graphs = GraphCache(self.device, self.graph_pool)

        def step(inp, _):
            return (vision_mod.encode_image(self.vision_params, inp["pixels"], self.vision_cfg),)

        return self._encode_graphs.run(("encode", x.shape[0]), step, {"pixels": x},
                                       capture=capture)[0]

    def graph_stats(self) -> dict:
        """Graphs captured for this engine (its own state's steps and the
        encoder) and the bytes the shared memory pool holds (every graph of
        the engine's, the session pool's included); zeros before the first
        capture."""
        caches = [c for c in (self._step_graphs, self._encode_graphs) if c is not None]
        return {"graphs": sum(len(c.graphs) for c in caches),
                "keys": [k for c in caches for k in c.graphs],
                "pool_bytes": 0 if self._graph_pool is None else pool_bytes(self._graph_pool)}

    def warmup(self, prefill_buckets: tuple[int, ...] = (8, 32, 128, 512),
               decode_chunks: tuple[int, ...] = (1, DECODE_CHUNK)) -> dict:
        """Capture ahead of time what a chat replays, as the JAX engine's
        ``warmup`` (engine.py:1295-1346) precompiles it: build the kernel
        library, then capture the prefill buckets (each at the span
        ``_attn_bucket`` gives it), the decode chunks (1: the single-token
        step of ``add_tokens`` / ``end_chat``; more: ``decode_chunk`` for
        greedy and for sampling, whose traced thresholds serve every
        config) and the encoder at batch 1.  Captures run on the engine's own cache at positions past
        its cursor (or, where those run out, at positions whose contents are
        restored afterwards), and the state's generator is restored, so
        neither the conversation nor its random stream changes.  Returns
        :meth:`graph_stats` with the seconds of the build (``build_s``) and
        of the captures (``warmup_s``).  Refused on an engine that runs
        eagerly (CPU, tp > 1)."""
        if not self.graphs_enabled:
            raise RuntimeError("warmup captures CUDA graphs: this engine runs eagerly "
                               f"(device {self.device}, tp={self.tp})")
        from ..ops import _build

        t0 = time.perf_counter()
        _build.load()
        t_build = time.perf_counter() - t0
        st = self._st
        steps = self._steps(st)
        d, v = self.llm_cfg.n_embd, self.llm_cfg.n_vocab
        emb_dtype = self.llm_params["tok_embeddings"].dtype
        gen_state = st.generator.get_state()
        with utils.phase_timer("Warmup"), torch.no_grad():
            for b in prefill_buckets:
                if b > st.n_ctx:
                    continue
                with _spare_positions(st, b) as p:
                    steps.prefill(torch.zeros((1, b, d), dtype=emb_dtype, device=self.device),
                                  p, b - 1, _attn_bucket(b, st.n_ctx), capture=True)
            for n in decode_chunks:
                if n > st.n_ctx:
                    continue
                with _spare_positions(st, n) as p:
                    if n == 1:
                        steps.step(torch.zeros((1, 1), dtype=torch.long, device=self.device), p,
                                   capture=True)
                        continue
                    logits = torch.zeros((1, v), dtype=torch.float32, device=self.device)
                    for params in (SamplingParams(temp=0.0), SamplingParams()):
                        steps.decode_chunk(logits, p, n, [st.generator],
                                           lane_rows([params], v, self.device), capture=True)
            size = self.vision_cfg.vit.image_size
            self._encode(torch.zeros((1, 3, size, size), dtype=COMPUTE_DTYPE,
                                     device=self.device), capture=True)
            torch.cuda.synchronize(self.device)
        st.generator.set_state(gen_state)
        return dict(self.graph_stats(), build_s=t_build,
                    warmup_s=time.perf_counter() - t0 - t_build)

    # ------------------------------------------------------------------
    # vision
    # ------------------------------------------------------------------

    def encode_image(self, pixels: np.ndarray) -> np.ndarray:
        """Preprocessed pixels [3, 224, 224] (or [B, 3, 224, 224]) f32 ->
        [32, n_embd] float32 (the C ABI embedding payload)."""
        pixels = np.asarray(pixels, np.float32)
        if pixels.ndim == 3:
            pixels = pixels[None]
        expect = self.vision_cfg.vit.image_size
        if pixels.shape[1:] != (3, expect, expect):
            raise utils.MiniGPT4TypedError(
                utils.MiniGPT4Error.IMAGE_NOT_224_224_3,
                f"expected [B, 3, {expect}, {expect}], got {pixels.shape}")
        with utils.phase_timer("Encoding image"), torch.no_grad():
            x = torch.from_numpy(pixels).to(self.device, COMPUTE_DTYPE)
            emb = self._encode(x).float().cpu().numpy()
        return emb[0] if emb.shape[0] == 1 else emb

    # ------------------------------------------------------------------
    # decoder feeding
    # ------------------------------------------------------------------

    def _forward(self, st: DecodeState, embeds: torch.Tensor, last_idx: int) -> torch.Tensor:
        """One prefill chunk [1, S, D] from the cursor: the logits at row
        ``last_idx`` (the chunk's graph of key (S, span) on a graph engine)."""
        span = _attn_bucket(st.n_past + embeds.shape[1], st.n_ctx)
        steps = self._steps(st)
        with torch.no_grad():
            if steps is not None:
                return steps.prefill(embeds, st.n_past, last_idx, span)
            return llama_mod.forward(self.llm_params, st.cache, embeds, st.n_past, self.llm_cfg,
                                     last_idx, attn_len=span, tp=self.tp_group)

    def _prefill_embeds(self, st: DecodeState, embeds: torch.Tensor,
                        token_ids: list[int] | None = None) -> None:
        """Feed [1, S, D] embeddings in n_batch chunks, each padded to a
        power-of-two bucket capped at the remaining context."""
        s_total = embeds.shape[1]
        if st.n_past + s_total > st.n_ctx:
            raise ValueError(f"context overflow: n_past {st.n_past} + {s_total} > {st.n_ctx}")
        st.tokens.extend(token_ids if token_ids is not None else [-1] * s_total)
        for off in range(0, s_total, self.n_batch):
            chunk = embeds[:, off:off + self.n_batch]
            s = chunk.shape[1]
            b = min(_bucket(s, self.n_batch), st.n_ctx - st.n_past)
            if b != s:
                pad = torch.zeros((chunk.shape[0], b - s, chunk.shape[2]),
                                  dtype=chunk.dtype, device=chunk.device)
                chunk = torch.cat([chunk, pad], dim=1)
            logits = self._forward(st, chunk, last_idx=s - 1)
            st.n_past += s
        st.logits = logits[0]

    def add_tokens(self, tokens: list[int], st: DecodeState | None = None) -> None:
        """llama_eval in n_batch chunks (add_tokens, minigpt4.cpp:2365-2382)."""
        if not tokens:
            return
        st = self._state(st)
        ids = torch.tensor([tokens], dtype=torch.long).to(self.device)
        if len(tokens) == 1 and st.n_past + 1 <= st.n_ctx:
            # decode step: one position, no bucket padding (JAX's decode_step)
            steps = self._steps(st)
            with torch.no_grad():
                if steps is not None:
                    st.logits = steps.step(ids, st.n_past)[0]
                else:
                    st.logits = llama_mod.forward(
                        self.llm_params, st.cache, llama_mod.embed_tokens(self.llm_params, ids),
                        st.n_past, self.llm_cfg, tp=self.tp_group)[0]
            st.n_past += 1
            st.tokens.append(int(tokens[0]))
            return
        embeds = llama_mod.embed_tokens(self.llm_params, ids)
        self._prefill_embeds(st, embeds, token_ids=[int(t) for t in tokens])

    def add_strings(self, s: str, st: DecodeState | None = None) -> None:
        """Tokenize (always with BOS, like the reference) and feed."""
        self.add_tokens(self.tokenizer.tokenize(s, add_bos=True), st)

    def add_embedding(self, embedding: np.ndarray, st: DecodeState | None = None) -> None:
        """Inject raw embedding rows as pseudo-tokens (llama_eval_embd)."""
        emb = np.asarray(embedding, np.float32).reshape(1, -1, self.llm_cfg.n_embd)
        dtype = self.llm_params["tok_embeddings"].dtype
        self._prefill_embeds(self._state(st), torch.from_numpy(emb).to(self.device, dtype))

    # ------------------------------------------------------------------
    # chat state machine (minigpt4.cpp:2671-2782)
    # ------------------------------------------------------------------

    def system_prompt(self, st: DecodeState | None = None) -> None:
        st = self._state(st)
        self.add_strings(SYSTEM_PROMPT, st)
        st.n_keep = st.n_past

    def begin_chat_image(self, embedding: np.ndarray, question: str,
                         st: DecodeState | None = None) -> None:
        st = self._state(st)
        n_img = self.vision_cfg.qformer.query_length
        emb = np.asarray(embedding, np.float32).reshape(-1)
        expect = n_img * self.llm_cfg.n_embd
        if emb.size != expect:
            raise utils.MiniGPT4TypedError(
                utils.MiniGPT4Error.LLAMA_PROJECTION_EMBEDDING_INVALID_SIZE,
                f"image embedding size {emb.size} != {expect}")
        self.add_strings("Human: <Img>", st)
        self.add_embedding(emb, st)
        self.add_strings("</Img> ", st)
        st.n_keep = st.n_past
        self.add_strings(question, st)
        self.add_strings("### Assistant:", st)

    def begin_chat(self, question: str, st: DecodeState | None = None) -> None:
        st = self._state(st)
        self.add_strings("Human: ", st)
        self.add_strings(question, st)
        self.add_strings("### Assistant:", st)

    def sample_token(self, params: SamplingParams | None = None) -> int:
        """Host sample from the pending logits (the mirostat path)."""
        if self._st.logits is None:
            raise RuntimeError("nothing evaluated yet")
        return self.sampler.sample(self._st.logits.float().cpu().numpy(),
                                   params or SamplingParams())

    def end_chat(self, params: SamplingParams | None = None) -> str:
        """One decode step: sample from the previous logits, return the
        token's text, evaluate the token (minigpt4.cpp:2704-2716)."""
        params = params or SamplingParams()
        st = self._st
        if st.logits is None:
            raise RuntimeError("nothing evaluated yet")
        if params.mirostat != 0:
            tid = self.sample_token(params)
        else:
            with torch.no_grad():
                tid = int(sample_token(st.logits, st.generator, _device_config(params),
                                       logit_bias_tensor(params.logit_bias,
                                                         self.llm_cfg.n_vocab, self.device)))
        self.add_tokens([tid])
        return self.id_to_token(tid)

    def decode_chunk(self, n: int, params: SamplingParams,
                     st: DecodeState | None = None) -> list[int]:
        """Sample and evaluate ``n`` tokens on the device; one host sync."""
        st = self._state(st)
        rows = lane_rows([params], self.llm_cfg.n_vocab, self.device)
        steps = self._steps(st)
        with torch.no_grad():
            if steps is not None:
                tokens, logits = steps.decode_chunk(st.logits[None], st.n_past, n,
                                                    [st.generator], rows)
            else:
                tokens, logits = llama_mod.decode_loop(
                    self.llm_params, st.cache, st.logits[None], st.n_past, n,
                    [st.generator], rows, self.llm_cfg, tp=self.tp_group)
        ids = tokens[0].tolist()
        st.n_past += n
        st.tokens.extend(ids)
        st.logits = logits[0]
        return ids

    def generate(self, limit: int = 1024, params: SamplingParams | None = None,
                 st: DecodeState | None = None, lock=None):
        """Stream tokens with the reference's EOS logic
        (MiniGPT4ChatBot.generate, minigpt4_library.py:609-657): chunks of
        DECODE_CHUNK tokens decoded on the device, yielded one by one.
        Mirostat samples on the host, one token at a time (the engine's own
        state only: a session samples mirostat with its own sampler).
        ``lock``, where given, is held around each chunk's device work."""
        params = params or SamplingParams()
        if params.mirostat != 0:
            if st is not None:
                raise ValueError("mirostat samples on the engine's own state only")
            yield from self._generate_mirostat(limit, params)
            return
        st = self._state(st)
        if st.logits is None:
            return
        lock = lock if lock is not None else contextlib.nullcontext()
        chat = ""
        emitted = 0
        while emitted < limit:
            n = min(DECODE_CHUNK, st.n_ctx - st.n_past)
            if n <= 0:
                return
            with lock:
                token_ids = self.decode_chunk(n, params, st)
            for j, tid in enumerate(token_ids):
                token = self.id_to_token(tid)
                chat += token
                emitted += 1
                stop = emitted >= limit
                if token == EOS_TOKEN_SUFFIX:
                    if stop:
                        rollback(st, len(token_ids) - j - 1)
                        return
                    continue
                if chat.endswith(EOS_SUFFIX):
                    rollback(st, len(token_ids) - j - 1)
                    return
                yield token
                if stop:
                    rollback(st, len(token_ids) - j - 1)
                    return

    def _generate_mirostat(self, limit: int, params: SamplingParams):
        chat = ""
        for _ in range(limit):
            token = self.end_chat(params)
            chat += token
            if self.contains_eos_token(token):
                continue
            if self.is_eos(chat):
                break
            yield token

    def id_to_token(self, token_id: int) -> str:
        return self.tokenizer.id_to_str(token_id)

    def reset(self) -> None:
        """n_past = 0; masking makes the old cache rows unreachable."""
        self._st.reset()

    def reset_chat(self) -> None:
        self.reset()

    @staticmethod
    def contains_eos_token(s: str) -> bool:
        return s == EOS_TOKEN_SUFFIX

    @staticmethod
    def is_eos(s: str) -> bool:
        return s.endswith(EOS_SUFFIX)

    def close(self) -> None:
        self._container.close()
        self._llm_file.close()


def check_tp(reader: LlamaFileReader, decoder_mode: str, tp: int) -> None:
    """Refuse a decoder that cannot run over ``tp`` ranks: n_head not
    divisible by tp, or any weight that ``decoder_mode`` (the resolved
    mode) would load as group-quant."""
    hp = reader.hparams
    if hp.n_head % tp:
        raise ValueError(f"tp={tp}: n_head={hp.n_head} does not divide over the ranks")
    if decoder_mode != "gq":
        return
    held = [n for n, r in reader.tensors.items()
            if n != "tok_embeddings.weight" and len(r.shape) == 2
            and is_quantized(r.dtype) and gq.supported(r.dtype, r.shape[1])]
    if held:
        raise ValueError(
            f"tp={tp}: the decoder would hold {len(held)} weights as group-quant (gq), e.g. "
            f"{held[0]} (quant_mode 'auto' resolves to gq), and a gq weight cannot be placed "
            "over tensor-parallel ranks (the JAX package cannot place one either); use "
            "quant_mode='repack', 'w8a8' or 'qtensor', or a dense file")


@contextlib.contextmanager
def _spare_positions(st: DecodeState, n: int):
    """A cursor p whose n positions [p, p + n) a warm-up may write: the
    state's cursor where n positions remain past it, else the last n, whose
    contents are restored afterwards."""
    p = min(st.n_past, st.n_ctx - n)
    saved = None
    if p < st.n_past:
        saved = {kv: t[:, :, :, p:p + n].clone() for kv, t in st.cache.items()}
    try:
        yield p
    finally:
        for kv, t in (saved or {}).items():
            st.cache[kv][:, :, :, p:p + n] = t


def rollback(st: DecodeState, n: int) -> None:
    """Rewind ``n`` evaluations decoded past a stop; the pending logits
    belong to the rolled-back continuation and are dropped."""
    if n > 0:
        st.n_past -= n
        del st.tokens[st.n_past:]
        st.logits = None


def _device_config(params: SamplingParams) -> DeviceSamplingConfig:
    return DeviceSamplingConfig(temp=params.temp, top_k=params.top_k, top_p=params.top_p,
                                tfs_z=params.tfs_z, typical_p=params.typical_p)
