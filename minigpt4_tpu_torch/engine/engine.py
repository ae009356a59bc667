"""MiniGPT4Engine on PyTorch: the chat operations of the reference's
``MiniGPT4`` class (minigpt4.cpp:1740-2522), counterpart of
``minigpt4_tpu/engine/engine.py`` for the one-image chat path.

Owns the vision and decoder params on ``device``, the KV cache, the decode
cursor, the tokenizer and the samplers:

    encode_image        pixels -> [32, n_embd] image embedding
    add_strings/tokens  prefill (always add_bos=true, like the reference)
    add_embedding       inject embedding rows as pseudo-tokens
    system_prompt, begin_chat_image, begin_chat, end_chat, generate, reset
    ctx_shift           drop the oldest turns past the keep prefix
    save_state, restore_state   checkpoint the chat to an npz file

With ``speculative_k`` (or a drafter) ``generate`` decodes by speculation:
n-gram or drafter-proposed tokens verified k at a time, greedy streams
giving plain greedy's ids, sampled ones speculative sampling's draws
(``decode_chunk_spec``, ``decode_chunk_spec_stoch``, ``_draft_chunk``; the
residual ban in ``DecodeState.spec_ban``, consumed by ``resolve_ban``).

Prefill chunks are padded to power-of-two buckets (8 .. n_batch), capped
at the remaining context; padded rows write cache entries past the real
tokens, which the causal mask hides and the next chunk overwrites.  Decode
samples on the device in the reference's sample-then-eval order;
``generate`` decodes chunks of tokens with one host synchronisation per
chunk and rolls the cursor back over what it decoded past EOS or the limit.
With ``context_shift`` a chat that fills its context drops its oldest
turns after the system prompt and image (``ctx_shift``) instead of
stopping, at the JAX engine's points.

Every operation acts on a :class:`DecodeState`: the engine's own by
default, or one passed as ``st``.  The serving sessions
(``engine/sessions.py``) each own a state with a cache of ``session_ctx``
positions (:meth:`MiniGPT4Engine.new_state`) and share the loaded model.

On a CUDA engine at tp = 1 every step that the JAX engine compiles replays
a captured CUDA graph (``engine/graphs.py``), captured lazily on the second
use of each key or ahead of time by :meth:`MiniGPT4Engine.warmup`: prefill
chunks, the single-token step, decode chunks, the n-gram dispatches (greedy
and sampled), the residual ban's step, the drafter's catch-up and drafted
dispatch, and the image encoder.  The engine's own state replays graphs over
its own cache.  The states of ``new_state`` (serving sessions) share one set
of graphs per context length, captured over a resident cache of that
geometry (:class:`_Resident`): before a step the state's buffer is copied
whole into the resident one and the previous owner's rows go back to a
buffer of their own, so captured results are the eager ones bit for bit and
the number of graphs does not grow with the number of sessions.  Steps run
eagerly on a CPU engine and under tp > 1 (gloo's all-reduces cannot be
captured); mirostat samples on the host; ``graphs_enabled`` (True exactly
where graphs run) set to False runs the same steps eagerly.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
import weakref
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
from .device_sampling import (DeviceSamplingConfig, lane_rows, logit_bias_tensor, sample_res_rows,
                              sample_token)
from .graphs import GraphCache, StepGraphs, pool_bytes
from .hostcopy import copy_from_host_, host_copy
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
    ``n_ctx`` is the cache's length: the state's context limit.

    A serving session's state can be parked (:meth:`park`): its cache then
    lives in host memory, trimmed to the consumed prefix, until
    :meth:`ensure_device` puts it back.  ``cache`` is None while the state is
    parked or rides a batched group (whose cache is then the live copy).  On
    a graph engine a session's ``cache`` (and ``dcache``) may be the engine's
    resident buffer of its geometry (:class:`_Resident`); every operation
    here reads and writes whatever buffer ``cache`` is, and one that sets it
    to None or replaces it ends the residency."""

    def __init__(self, cache: dict, generator: torch.Generator):
        self.cache = cache
        self.n_ctx = cache["k"].shape[3]
        self.generator = generator
        self.n_past = 0
        self.logits: torch.Tensor | None = None  # [V] f32 (on the host while parked)
        self.tokens: list[int] = []  # one per cache position, -1 for embeddings
        self.n_keep = 0  # system prompt + image prefix
        # the host copy of the cache while parked: {"shape", "dtype", "device",
        # "k", "v"}, k / v the bits (llama._bits) of rows [0, n_past)
        self.parked: dict | None = None
        # draft-model speculation: the drafter's cache and how far it has
        # evaluated ``tokens``; built and caught up by ``_draft_catchup``
        self.dcache: dict | None = None
        self.draft_past = 0
        # stochastic speculation's residual ban: the token id the next sample
        # from the pending logits must exclude (-1: none)
        self.spec_ban = -1

    def reset(self) -> None:
        self.n_past = 0
        self.logits = None
        self.tokens = []
        self.n_keep = 0
        self.dcache = None
        self.draft_past = 0
        self.spec_ban = -1
        if self.parked is not None:  # nothing of the old rows is needed
            self.parked = dict(self.parked, k=self.parked["k"][:, :, :, :0],
                               v=self.parked["v"][:, :, :, :0])

    def park(self) -> None:
        """Move the cache to host memory, trimmed to the consumed prefix, and
        the pending logits with it (the JAX engine's ``DecodeState.park``):
        the session holds no device memory between turns.  The rows move as
        their bits (``llama._bits``), so an e4m3 cache moves as bytes, into
        pageable host memory (``engine/hostcopy.py``).  A
        no-op while the cache is not resident (parked already, or riding a
        batched group)."""
        if self.cache is None or self.parked is not None:
            return
        k = self.cache["k"]
        n = min(self.n_past, k.shape[3])
        host = {kv: host_copy(llama_mod._bits(self.cache[kv][:, :, :, :n])) for kv in ("k", "v")}
        self.parked = dict(host, shape=tuple(k.shape), dtype=k.dtype, device=k.device)
        if self.logits is not None:
            self.logits = self.logits.cpu()
        self.cache = None
        # the draft cache is rebuilt from ``tokens`` rather than parked
        self.dcache = None
        self.draft_past = 0

    def ensure_device(self) -> None:
        """Put a parked cache back on its device: a zero cache of the state's
        geometry with the parked rows copied in (positions past ``n_past``
        are masked), and the pending logits beside it.  Raises ValueError
        when the state has no cache at all (it rides a batched group, whose
        cache is the live copy)."""
        if self.parked is not None:
            p, self.parked = self.parked, None
            n = p["k"].shape[3]
            cache = {}
            for kv in ("k", "v"):
                cache[kv] = torch.zeros(p["shape"], dtype=p["dtype"], device=p["device"])
                copy_from_host_(llama_mod._bits(cache[kv])[:, :, :, :n], p[kv])
            self.cache = cache
            if self.logits is not None:
                self.logits = self.logits.to(p["device"])
            return
        if self.cache is None:
            raise ValueError("session cache is not resident (riding a batched decode?)")

    def save(self, path) -> None:
        """Checkpoint the state to the npz file ``path`` with the JAX
        engine's fields (``DecodeState.save``): the whole cache as bits
        (``k``, ``v``) and its type under the JAX name (``kv_dtype``),
        ``n_past``, ``has_logits``, ``logits``, ``tokens``, ``n_keep`` and
        ``spec_ban``, plus the generator's state (``torch_generator``, with its device
        type in ``torch_generator_device``).  Stored uncompressed: a
        cache's random bits do not compress.  A parked state is put back on
        its device first, as the JAX engine's is."""
        self.ensure_device()
        with open(path, "wb") as f:
            np.savez(f, k=_host_bits(self.cache["k"]), v=_host_bits(self.cache["v"]),
                     kv_dtype=np.bytes_(JAX_DTYPE_NAMES[self.cache["k"].dtype]),
                     n_past=np.int64(self.n_past), has_logits=np.bool_(self.logits is not None),
                     logits=(self.logits.float().cpu().numpy() if self.logits is not None
                             else np.zeros(1, np.float32)),
                     tokens=np.asarray(self.tokens, np.int64), n_keep=np.int64(self.n_keep),
                     spec_ban=np.int64(self.spec_ban),
                     torch_generator=self.generator.get_state().numpy(),
                     torch_generator_device=np.bytes_(self.generator.device.type))

    def restore(self, path) -> None:
        """Restore a checkpoint of :meth:`save` or of the JAX engine's
        ``DecodeState.save``, copying the cache into this state's own
        tensors (captured CUDA graphs hold their addresses; a checkpoint of
        another cache type is converted).  A checkpoint without a generator
        of this state's device type (every JAX one) leaves the state's
        generator as it is.  The residual ban (``spec_ban``) is restored and
        the draft cache dropped (it described the old history).  Raises
        ValueError, changing nothing, on a cache shape other than this
        state's or an unknown cache type.  A parked state is put back on its
        device first (JAX ``DecodeState.restore``), so nothing stale of the
        parked copy comes back later."""
        self.ensure_device()
        z = np.load(path)
        arrays = {kv: z[kv] for kv in ("k", "v")}  # an npz member reads on each access
        for kv, a in arrays.items():
            if tuple(a.shape) != tuple(self.cache[kv].shape):
                raise ValueError(f"checkpoint cache shape {a.shape} != "
                                 f"state {tuple(self.cache[kv].shape)}")
        name = z["kv_dtype"].item().decode()
        if name not in TORCH_DTYPES:
            raise ValueError(f"checkpoint cache type {name!r}: expected "
                             f"{' | '.join(TORCH_DTYPES)}")
        for kv, a in arrays.items():
            dst = self.cache[kv]
            bits = a.view(_INT_NP[a.dtype.itemsize])
            src = torch.from_numpy(bits).view(TORCH_DTYPES[name]).to(dst.device)
            if src.dtype == dst.dtype:
                llama_mod._bits(dst).copy_(llama_mod._bits(src))
            else:
                dst.copy_(llama_mod.to_cache(src.float(), dst.dtype))
        self.n_past = int(z["n_past"])
        self.logits = (torch.from_numpy(z["logits"]).to(self.cache["k"].device, torch.float32)
                       if bool(z["has_logits"]) else None)
        self.tokens = ([int(t) for t in z["tokens"]] if "tokens" in z.files
                       else [-1] * self.n_past)
        self.n_keep = int(z["n_keep"]) if "n_keep" in z.files else 0
        self.spec_ban = int(z["spec_ban"]) if "spec_ban" in z.files else -1
        self.dcache = None
        self.draft_past = 0
        if ("torch_generator" in z.files
                and z["torch_generator_device"].item().decode() == self.generator.device.type):
            self.generator.set_state(torch.from_numpy(z["torch_generator"].copy()))


# KV cache types by the names the JAX package's checkpoints give them
JAX_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                   torch.float8_e4m3fn: "float8_e4m3fn"}
TORCH_DTYPES = {v: k for k, v in JAX_DTYPE_NAMES.items()}
# the numpy types that carry a cache's bits, by element size: the JAX
# package stores bf16 as uint16 and e4m3 as uint8; torch takes them as
# signed integers of the same size
_BITS_NP = {1: np.uint8, 2: np.uint16, 4: np.float32}
_INT_NP = {1: np.uint8, 2: np.int16, 4: np.int32}


def _host_bits(t: torch.Tensor) -> np.ndarray:
    """A cache tensor's bits on the host, as the JAX package's checkpoints
    hold them: f32 as float32, bf16 as uint16, e4m3 as uint8."""
    return llama_mod._bits(t).cpu().numpy().view(_BITS_NP[t.element_size()])


def _copy_buffers(dst: dict, src: dict) -> None:
    """Copy a whole cache ``{"k", "v"}`` as bits (no cast, every position)."""
    for kv in ("k", "v"):
        llama_mod._bits(dst[kv]).copy_(llama_mod._bits(src[kv]))


class _Resident:
    """The resident buffers of one state geometry, over which one set of
    captured graphs runs: ``bufs["cache"]``, the session cache every
    captured step of that geometry reads and writes, and, with a drafter,
    ``bufs["dcache"]``, the drafter's cache beside it; ``steps`` and
    ``dsteps`` are their graphs (``dsteps`` with the drafter).

    :meth:`take` makes a state's buffer the resident one: the previous
    owner's rows go back to a buffer of its own (the spare: the buffer the
    state before it gave up), the state's buffer is copied in whole and
    becomes the spare.  Whole buffers, not rows [0, n_past): rows past the
    cursor stay the state's own, which the plain S > 32 prefill path
    multiplies by masked weights (an e4m3 row can be NaN), so a captured step
    gives the eager step's bits.  Device memory above the states' own caches
    is one buffer per attribute.  Ownership is by identity (``owner.cache is
    resident``): a path that sets a state's buffer to None or replaces it
    (park, a batched group, a detach) ends the residency, and the next taker
    needs no copy out.  Callers hold the lock around the step."""

    def __init__(self):
        self.bufs: dict = {}  # "cache" / "dcache" -> the resident buffer
        self.spare: dict = {}  # a free buffer of that geometry, per attribute
        self.owner: dict = {}  # the state whose attribute is the resident buffer (a weakref)
        self.steps: StepGraphs | None = None
        self.dsteps: StepGraphs | None = None

    def take(self, st: DecodeState, attr: str, new) -> dict:
        """Make ``getattr(st, attr)`` the resident buffer (made by ``new()``
        on first use) and return it.  A state without a buffer (a draft cache
        dropped by ``reset`` or ``park``) takes the resident one as it is;
        its caller restarts the rows it reads (``draft_past = 0``)."""
        res = self.bufs.get(attr)
        if res is None:
            res = self.bufs[attr] = new()
        cur = getattr(st, attr)
        if cur is res:
            return res
        ref = self.owner.get(attr)
        prev = ref() if ref is not None else None
        if prev is not None and getattr(prev, attr) is res:
            back = self.spare.pop(attr, None) or {kv: torch.empty_like(t) for kv, t in res.items()}
            _copy_buffers(back, res)
            setattr(prev, attr, back)
        if cur is not None:
            _copy_buffers(res, cur)
            self.spare[attr] = cur
        setattr(st, attr, res)
        self.owner[attr] = weakref.ref(st)
        return res

    def drop_draft(self) -> None:
        """Forget the drafter's buffer and graphs (a new drafter)."""
        for d in (self.bufs, self.spare, self.owner):
            d.pop("dcache", None)
        self.dsteps = None


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
        context_shift: bool = False,
        speculative_k: int = 0,
        draft_llm_path: str | Path | None = None,
        draft_head_path: str | Path | None = None,
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
        prefills at batch 1.

        ``context_shift``: where a prefill or a decode chunk would overflow
        a state's context, drop its oldest tokens after the keep prefix
        (:meth:`ctx_shift`) instead of raising ``context overflow`` (prefill)
        or stopping (``generate``), as the JAX engine's ``context_shift``.

        ``speculative_k``: the verify width of speculative decoding in
        ``generate`` (0 or 1: off; at most ``FLASH_DECODE_MAX_S``, 32): greedy
        streams draft by n-gram lookup and verify k tokens per pass, with the
        ids of plain greedy decode; sampled streams run speculative sampling,
        whose draws have plain sampling's distribution.  ``draft_llm_path``
        (a smaller llama file of the same vocabulary) or ``draft_head_path``
        (an artifact of ``train/draft.py``) drafts greedy streams instead,
        ``self.draft_k`` = ``speculative_k`` or 8 tokens per pass.  Refused:
        both drafters at once, a drafter of another vocabulary or width, and
        either under tp > 1 (JAX's errors).  Under tp > 1 the n-gram loops
        run eagerly on every rank, each rank's generator seeded alike, so
        every rank draws the same ids from the gathered logits."""
        if speculative_k > llama_mod.FLASH_DECODE_MAX_S:
            raise ValueError(
                f"speculative_k={speculative_k} exceeds the flash-decode "
                f"verify-block limit ({llama_mod.FLASH_DECODE_MAX_S})")
        _check_drafter(draft_llm_path, draft_head_path, tp)
        self.speculative_k = speculative_k
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
        self.quant_mode = resolve_decoder_mode(quant_mode, smooth_scales)
        if tp > 1:  # refused before any weight loads or any rank joins
            with LlamaFileReader(llm_path) as reader:
                check_tp(reader, self.quant_mode, tp)
        self.tp = tp
        self.tp_group = init_tp(tp, device) if tp > 1 else None
        self.device = self.tp_group.device if self.tp_group else torch.device(device)
        self.n_batch = n_batch
        self.cache_dtype = cache_dtype
        self.context_shift = context_shift
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
        # the resident buffers and their graphs: "own" for the engine's own
        # state (its cache is resident for good), n_ctx for session states
        self._resident: dict = {}
        self._encode_graphs: GraphCache | None = None
        self._draft_file = None
        self.set_drafter(draft_llm_path, draft_head_path)

    def set_drafter(self, draft_llm_path=None, draft_head_path=None) -> None:
        """Load the drafter of draft-model speculation (the JAX engine's
        ``__init__`` arguments of the same names), replacing any earlier
        one; with neither path, drop it.  Sets ``draft_params`` /
        ``draft_cfg`` (None without a drafter) and ``draft_k``.  A drafter
        file loads in the engine's quant_mode (``auto``: gq where it
        applies); a draft head is assembled over the engine's embedding.
        The states' draft caches are dropped, and the captured drafter steps
        with them."""
        _check_drafter(draft_llm_path, draft_head_path, self.tp)
        for res in self._resident.values():
            res.drop_draft()
        if self._draft_file is not None:
            self._draft_file.close()
        self.draft_params = None
        self.draft_cfg = None
        self._draft_file = None
        self._draft_fns_by_ctx: dict[int, DraftFns] = {}
        self.draft_k = 0
        self._st.dcache, self._st.draft_past = None, 0
        n_ctx = self.llm_cfg.n_ctx
        if draft_head_path is not None:
            from ..train import draft as draft_head_mod

            with utils.phase_timer("Draft head init"):
                art, dhc = draft_head_mod.load_artifact(draft_head_path)
                emb = self.llm_params["tok_embeddings"]
                if art["p_in"].shape[0] != self.llm_cfg.n_embd:
                    raise ValueError(f"draft head d_main {art['p_in'].shape[0]} != model "
                                     f"n_embd {self.llm_cfg.n_embd}")
                self.draft_cfg = dhc.llama_cfg(self.llm_cfg.n_vocab, n_ctx)
                self.draft_params = draft_head_mod.assemble_draft(emb, art, emb.dtype)
        if draft_llm_path is not None:
            with utils.phase_timer("Draft LLM init"):
                self._draft_file = LlamaFileReader(draft_llm_path)
                try:
                    self.draft_params, self.draft_cfg = llama_mod.load_params(
                        self._draft_file, COMPUTE_DTYPE, n_ctx=n_ctx, device=self.device,
                        quant_mode=self.quant_mode, pack=self.gq_packed)
                    if self.draft_cfg.n_vocab != self.llm_cfg.n_vocab:
                        raise ValueError(
                            f"draft model vocab ({self.draft_cfg.n_vocab}) != main model vocab "
                            f"({self.llm_cfg.n_vocab}): the drafter must share the tokenizer")
                except Exception:
                    self._draft_file.close()
                    self._draft_file = None
                    self.draft_params = self.draft_cfg = None
                    raise
        if self.draft_params is not None:
            # an explicit speculative_k, else 8 (the width that an S <= 8
            # verify serves at the cost of one decode step)
            self.draft_k = self.speculative_k if self.speculative_k > 1 else 8

    def draft_fns_for(self, n_ctx: int) -> "DraftFns | None":
        """The drafter's functions for states of ``n_ctx`` positions (JAX's
        ``draft_fns_for``), memoized; None without a drafter."""
        if self.draft_params is None:
            return None
        fns = self._draft_fns_by_ctx.get(n_ctx)
        if fns is None:
            fns = self._draft_fns_by_ctx[n_ctx] = DraftFns(
                self.draft_params, dataclasses.replace(self.draft_cfg, n_ctx=n_ctx), self.device)
        return fns

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

    @n_past.setter
    def n_past(self, v: int) -> None:
        """Move the engine's cursor (a rewind): the drafter's frontier follows
        it down."""
        self._st.n_past = v
        self._st.draft_past = min(self._st.draft_past, v)

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

    def _resident_of(self, st: DecodeState) -> _Resident:
        """The resident set ``st``'s steps run on, with ``st``'s cache made
        resident in it (a parked state is put back on its device first): the
        engine's own state's, whose cache it is for good, or the one shared
        by every session state of ``st.n_ctx`` positions.  Caller holds the
        lock around the step."""
        st.ensure_device()
        key = "own" if st is self._st else st.n_ctx
        res = self._resident.get(key)
        if res is None:
            res = self._resident[key] = _Resident()
            if key == "own":
                res.bufs["cache"] = st.cache
                res.owner["cache"] = weakref.ref(st)
        res.take(st, "cache", lambda: {kv: torch.zeros_like(t) for kv, t in st.cache.items()})
        return res

    def _steps(self, st: DecodeState) -> StepGraphs | None:
        """The captured steps that run ``st``'s next step, with ``st``
        resident in their cache (:meth:`_resident_of`), or None where it
        runs eagerly: tp > 1 and a CPU engine (``graphs_enabled`` off)."""
        if not self.graphs_enabled:
            return None
        res = self._resident_of(st)
        if res.steps is None:
            res.steps = StepGraphs(self.llm_params, self.llm_cfg, res.bufs["cache"], self.device,
                                   self.graph_pool)
        return res.steps

    def _draft_steps(self, st: DecodeState, dfns: "DraftFns") -> StepGraphs | None:
        """The captured drafter steps for ``st`` (its cache and its draft
        cache made resident; a state without a draft cache takes the
        resident one and catches up from position 0), or None where they
        run eagerly."""
        if not self.graphs_enabled:
            return None
        res = self._resident_of(st)
        if st.dcache is None:
            st.draft_past = 0
        dcache = res.take(st, "dcache", dfns.new_cache)
        if res.dsteps is None:
            res.dsteps = StepGraphs(self.llm_params, self.llm_cfg, res.bufs["cache"], self.device,
                                    self.graph_pool, draft=dfns, dcache=dcache)
        return res.dsteps

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
        """Graphs captured for this engine (its own state's steps, the
        session states' shared steps, the drafter's and the encoder's),
        their replays so far, and the bytes the shared memory pool holds
        (every graph of the engine's, the session pool's included); zeros
        before the first capture."""
        caches = [c for res in self._resident.values() for c in (res.steps, res.dsteps)
                  if c is not None]
        caches += [self._encode_graphs] if self._encode_graphs is not None else []
        return {"graphs": sum(len(c.graphs) for c in caches),
                "keys": [k for c in caches for k in c.graphs],
                "replays": sum(c.replays for c in caches),
                "pool_bytes": 0 if self._graph_pool is None else pool_bytes(self._graph_pool)}

    def warmup(self, prefill_buckets: tuple[int, ...] = (8, 32, 128, 512),
               decode_chunks: tuple[int, ...] = (1, DECODE_CHUNK)) -> dict:
        """Capture ahead of time what a chat replays, as the JAX engine's
        ``warmup`` (engine.py:1295-1346) precompiles it: build the kernel
        library, then capture the prefill buckets (each at the span
        ``_attn_bucket`` gives it), the decode chunks (1: the single-token
        step of ``add_tokens`` / ``end_chat``; more: ``decode_chunk`` for
        greedy and for sampling, whose traced thresholds serve every
        config), with ``speculative_k`` > 1 the n-gram speculative dispatch
        of ``_spec_passes`` passes, greedy and sampled (the JAX engine's
        warmup compiles its greedy one), with a drafter its catch-up buckets
        (8 .. 64 rows; the 64-row one at every attention span up to the
        context) and the drafted dispatch of ``_spec_passes`` passes of
        ``draft_k``, and the encoder at batch 1.  Captures run on the
        engine's own cache at positions past its cursor (or, where those run
        out, at positions whose contents are restored afterwards; the
        drafter's frontier steps back below what a capture wrote), and the
        state's generator is restored, so neither the conversation nor its
        random stream changes.  Returns
        :meth:`graph_stats` with the seconds of the build (``build_s``) and
        of the captures (``warmup_s``).  On a CUDA engine over tp > 1 ranks
        (every rank calls it) each of those steps runs once eagerly instead,
        on the rank's shards: gloo's all-reduces cannot be captured, so the
        result reports 0 graphs, and ``eager_keys`` the steps run.  Refused
        on a CPU engine."""
        if self.device.type != "cuda":
            raise RuntimeError("warmup builds the kernels and captures CUDA graphs: this engine "
                               f"runs on {self.device}")
        from ..ops import _build

        t0 = time.perf_counter()
        _build.load()
        t_build = time.perf_counter() - t0
        st = self._st
        steps = (self._steps(st) if self.graphs_enabled else
                 StepGraphs(self.llm_params, self.llm_cfg, st.cache, self.device, None,
                            tp=self.tp_group))
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
            k = self.speculative_k
            passes = _spec_passes(DECODE_CHUNK, k) if k > 1 else 0
            if k > 1 and passes * k <= st.n_ctx:
                with _spare_positions(st, passes * k) as p:
                    logits = torch.zeros((1, v), dtype=torch.float32, device=self.device)
                    hist = torch.full((1, st.n_ctx), -1, dtype=torch.long, device=self.device)
                    steps.spec_chunk(logits, p, hist, passes, k, capture=True)
                    ban = torch.full((1,), -1, dtype=torch.long, device=self.device)
                    steps.spec_chunk_stoch(logits, p, hist, ban, passes, k, [st.generator],
                                           lane_rows([SamplingParams()], v, self.device),
                                           capture=True)
            dfns = self.draft_fns_for(st.n_ctx) if self.graphs_enabled else None
            if dfns is not None:
                self._warmup_drafter(st, dfns)
            size = self.vision_cfg.vit.image_size
            self._encode(torch.zeros((1, 3, size, size), dtype=COMPUTE_DTYPE,
                                     device=self.device), capture=True)
            torch.cuda.synchronize(self.device)
        st.generator.set_state(gen_state)
        return dict(self.graph_stats(), build_s=t_build,
                    warmup_s=time.perf_counter() - t0 - t_build,
                    eager_keys=[] if self.graphs_enabled else sorted(map(str, steps.seen)))

    def _warmup_drafter(self, st: DecodeState, dfns: "DraftFns", chunk: int = 64) -> None:
        """Capture the drafter's catch-up buckets and its drafted dispatch
        on ``st`` (the warm-up's positions; the drafter's frontier steps back
        below every row a capture wrote, so the next catch-up computes them
        again)."""
        steps = self._draft_steps(st, dfns)
        b = 8
        while b <= min(chunk, st.n_ctx):
            p = min(st.draft_past, st.n_ctx - b)
            spans = [None]
            if b > llama_mod.FLASH_DECODE_MAX_S:  # every span a catch-up of b rows reads
                spans = sorted({_attn_bucket(q, st.n_ctx) for q in range(b, st.n_ctx + 1)})
            for span in spans:
                steps.catchup(torch.full((1, b), -1, dtype=torch.long, device=self.device), p,
                              span, capture=True)
            st.draft_past = min(st.draft_past, p)
            b *= 2
        k = self.draft_k
        passes = _spec_passes(DECODE_CHUNK, k)
        if passes * k <= st.n_ctx:
            with _spare_positions(st, passes * k) as p:
                logits = torch.zeros((1, self.llm_cfg.n_vocab), dtype=torch.float32,
                                     device=self.device)
                steps.draft_chunk(logits, p, passes, k, capture=True)
                st.draft_past = min(st.draft_past, p)

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

    def ctx_shift(self, st: DecodeState | None = None, need: int = 0) -> int:
        """llama.cpp's context shift on ``st`` (the JAX engine's
        ``ctx_shift``): free room for ``need`` more positions by dropping the
        oldest tokens after the keep prefix ([0, n_keep): system prompt and
        image) and sliding the cache down with K re-rotated
        (:func:`llama.shift_kv_cache`, in place).  Drops at least half of
        the rest so that shifts stay rare.  Returns the positions dropped (0:
        nothing to drop, or the state rides a batched group)."""
        st = self._state(st)
        if st.cache is None:
            return 0
        keep = min(st.n_keep, st.n_past)
        drop = min(max(need - (st.n_ctx - st.n_past), (st.n_past - keep) // 2),
                   st.n_past - keep)
        if drop <= 0:
            return 0
        with torch.no_grad():
            llama_mod.shift_kv_cache(st.cache, keep, drop, st.n_past, self.llm_cfg)
        del st.tokens[keep:keep + drop]
        st.n_past -= drop
        # the drafter's rows past keep describe the old positions
        st.draft_past = min(st.draft_past, keep)
        return drop

    def _maybe_shift(self, st: DecodeState, need: int) -> None:
        if self.context_shift and st.n_past + need > st.n_ctx:
            self.ctx_shift(st, need)

    def _prefill_embeds(self, st: DecodeState, embeds: torch.Tensor,
                        token_ids: list[int] | None = None) -> None:
        """Feed [1, S, D] embeddings in n_batch chunks, each padded to a
        power-of-two bucket capped at the remaining context."""
        s_total = embeds.shape[1]
        self._maybe_shift(st, s_total)
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
        st.spec_ban = -1  # fresh pending logits: a carried ban is dead

    def add_tokens(self, tokens: list[int], st: DecodeState | None = None) -> None:
        """llama_eval in n_batch chunks (add_tokens, minigpt4.cpp:2365-2382)."""
        if not tokens:
            return
        st = self._state(st)
        self._maybe_shift(st, len(tokens))
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
            st.spec_ban = -1
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

    # The templates as ordered pieces, fed one after another: ("text", str),
    # tokenized with BOS; ("rows", flat f32 embedding rows); ("keep", None),
    # where the context shift's keep prefix ends.  The serving pool feeds
    # the same pieces through its prefix cache.
    @staticmethod
    def system_pieces() -> list[tuple]:
        return [("text", SYSTEM_PROMPT), ("keep", None)]

    def chat_pieces(self, question: str, embedding: np.ndarray | None = None) -> list[tuple]:
        """One user turn; with ``embedding``, the image turn, whose prefix
        survives every shift.  Raises the reference's typed error on an
        embedding of the wrong size, before anything is fed."""
        if embedding is None:
            return [("text", "Human: "), ("text", question), ("text", "### Assistant:")]
        return [("text", "Human: <Img>"), ("rows", self.image_rows(embedding)),
                ("text", "</Img> "), ("keep", None), ("text", question),
                ("text", "### Assistant:")]

    def _feed(self, pieces: list[tuple], st: DecodeState | None) -> None:
        st = self._state(st)
        for kind, x in pieces:
            if kind == "text":
                self.add_strings(x, st)
            elif kind == "rows":
                self.add_embedding(x, st)
            else:
                st.n_keep = st.n_past

    def system_prompt(self, st: DecodeState | None = None) -> None:
        self._feed(self.system_pieces(), st)

    def begin_chat_image(self, embedding: np.ndarray, question: str,
                         st: DecodeState | None = None) -> None:
        self._feed(self.chat_pieces(question, embedding), st)

    def image_rows(self, embedding: np.ndarray) -> np.ndarray:
        """An image embedding as the flat f32 rows that ``begin_chat_image``
        feeds; raises the reference's typed error on a wrong size."""
        emb = np.asarray(embedding, np.float32).reshape(-1)
        expect = self.vision_cfg.qformer.query_length * self.llm_cfg.n_embd
        if emb.size != expect:
            raise utils.MiniGPT4TypedError(
                utils.MiniGPT4Error.LLAMA_PROJECTION_EMBEDDING_INVALID_SIZE,
                f"image embedding size {emb.size} != {expect}")
        return emb

    def begin_chat(self, question: str, st: DecodeState | None = None) -> None:
        self._feed(self.chat_pieces(question), st)

    def sample_token(self, params: SamplingParams | None = None) -> int:
        """Host sample from the pending logits (the mirostat path).  A carried
        residual ban is dropped: mirostat's truncation defines its own
        distribution, to which the device chain's residual does not apply
        (the JAX engine's ``end_chat``)."""
        if self._st.logits is None:
            raise RuntimeError("nothing evaluated yet")
        self._st.spec_ban = -1
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
        elif st.spec_ban >= 0:
            # a stochastic-speculative dispatch left a residual ban on these
            # logits: the next sample excludes the rejected draft
            self._maybe_shift(st, 1)
            if st.n_past + 1 > st.n_ctx:
                raise ValueError(f"context overflow: n_past {st.n_past} + 1 > {st.n_ctx}")
            tid = self.resolve_ban(st, lane_rows([params], self.llm_cfg.n_vocab,
                                                 self.device))[0]
            return self.id_to_token(tid)
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
        st.spec_ban = -1
        return ids

    def _emit(self, st: DecodeState, tokens: torch.Tensor, counts: torch.Tensor,
              logits: torch.Tensor) -> list[int]:
        """Book the tokens a speculative dispatch emitted (pass p: its first
        counts[p] tokens) into ``st``; one host read."""
        toks, cnts = tokens[0].tolist(), counts[0].tolist()
        ids = [t for row, c in zip(toks, cnts) for t in row[:c]]
        st.n_past += len(ids)
        st.tokens.extend(ids)
        st.logits = logits[0]
        return ids

    def decode_chunk_spec(self, st: DecodeState, n_passes: int, k: int) -> list[int]:
        """Greedy speculative decode (JAX ``StepFns.decode_chunk_spec``):
        ``n_passes`` verify passes of width ``k`` in one dispatch
        (:func:`llama.speculative_decode_loop`), a captured graph on a graph
        engine's own state; emits n_passes .. n_passes * k tokens, those of
        plain greedy decode.  The caller keeps n_past + n_passes * k within
        the context."""
        steps = self._steps(st)
        hist = _lane_hist([st], st.n_ctx, self.device)
        with torch.no_grad():
            if steps is not None:
                out = steps.spec_chunk(st.logits[None], st.n_past, hist, n_passes, k)
            else:
                out = llama_mod.speculative_decode_loop(
                    self.llm_params, st.cache, st.logits[None], st.n_past, hist, n_passes, k,
                    self.llm_cfg, tp=self.tp_group)
        ids = self._emit(st, *out[:3])
        st.spec_ban = -1
        return ids

    def decode_chunk_spec_stoch(self, st: DecodeState, n_passes: int, k: int, rows) -> list[int]:
        """Sampled speculative decode (JAX ``StepFns.decode_chunk_spec_stoch``)
        under the traced ``rows`` (:func:`llama.stochastic_speculative_decode_loop`),
        drawing from the state's generator; the residual ban carries to the
        next dispatch in ``st.spec_ban``."""
        steps = self._steps(st)
        ban = torch.full((1,), st.spec_ban, dtype=torch.long).to(self.device)
        hist = _lane_hist([st], st.n_ctx, self.device)
        with torch.no_grad():
            if steps is not None:
                out = steps.spec_chunk_stoch(st.logits[None], st.n_past, hist, ban, n_passes, k,
                                             [st.generator], rows)
            else:
                out = llama_mod.stochastic_speculative_decode_loop(
                    self.llm_params, st.cache, st.logits[None], st.n_past, hist, ban,
                    [st.generator], rows, n_passes, k, self.llm_cfg, tp=self.tp_group)
        ids = self._emit(st, *out[:3])
        st.spec_ban = int(out[4][0])
        return ids

    def resolve_ban(self, st: DecodeState, rows) -> list[int]:
        """Consume a carried residual ban before a plain path samples from the
        same pending logits (JAX ``StepFns.resolve_ban``): one token drawn
        with the rejected draft excluded, then evaluated."""
        ban = torch.full((1,), st.spec_ban, dtype=torch.long).to(self.device)
        with torch.no_grad():
            tid = sample_res_rows(st.logits[None], ban, [st.generator], rows)
            steps = self._steps(st)
            if steps is not None:
                logits = steps.step(tid[:, None], st.n_past)
            else:
                logits = llama_mod.forward(
                    self.llm_params, st.cache, llama_mod.embed_tokens(self.llm_params, tid[:, None]),
                    st.n_past, self.llm_cfg, tp=self.tp_group)
        t = int(tid[0])
        st.n_past += 1
        st.tokens.append(t)
        st.logits = logits[0]
        st.spec_ban = -1
        return [t]

    def generate(self, limit: int = 1024, params: SamplingParams | None = None,
                 st: DecodeState | None = None, lock=None, speculative_k: int | None = None):
        """Stream tokens with the reference's EOS logic
        (MiniGPT4ChatBot.generate, minigpt4_library.py:609-657): chunks of
        DECODE_CHUNK tokens decoded on the device, yielded one by one.
        With ``context_shift`` a chunk that would pass the context first
        shifts it (JAX's ``generate_stream``): every chunk is then a full one,
        and a tail chunk is left only where the keep prefix holds nearly all
        of the context.  Mirostat samples on the host, one token at a time
        (the engine's own state only: a session samples mirostat with its own
        sampler), shifting one position at a time.
        ``lock``, where given, is held around each chunk's device work.

        ``speculative_k`` (default: the engine's) > 1 decodes by speculation,
        as JAX's ``generate_stream``: a greedy stream verifies n-gram drafts
        (or, with a drafter, the drafter's) by argmax and yields plain greedy
        decode's ids; a sampled stream runs speculative sampling.  The passes
        per dispatch follow the observed tokens per pass, so that a dispatch
        emits about DECODE_CHUNK tokens; where no k-wide pass fits the
        context a plain chunk decodes the tail, a carried ban first consumed
        by :meth:`resolve_ban`."""
        params = params or SamplingParams()
        k = self.speculative_k if speculative_k is None else speculative_k
        if k > llama_mod.FLASH_DECODE_MAX_S:
            raise ValueError(f"speculative_k={k} exceeds the flash-decode verify-block limit "
                             f"({llama_mod.FLASH_DECODE_MAX_S})")
        if params.mirostat != 0:
            if st is not None:
                raise ValueError("mirostat samples on the engine's own state only")
            yield from self._generate_mirostat(limit, params)
            return
        st = self._state(st)
        if st.logits is None:
            return
        lock = lock if lock is not None else contextlib.nullcontext()
        greedy = params.temp <= 0 and not params.logit_bias
        rows = lane_rows([params], self.llm_cfg.n_vocab, self.device)
        dfns = self.draft_fns_for(st.n_ctx)
        use_draft = dfns is not None and greedy
        use_spec = k > 1 and greedy and not use_draft
        use_spec_stoch = k > 1 and not greedy and dfns is None
        width = self.draft_k if use_draft else k
        gov = _SpecGovernor(break_even=0.0)  # the observed tokens per pass; never demotes
        chat = ""
        emitted = 0
        while emitted < limit:
            if self.context_shift and st.n_past + DECODE_CHUNK > st.n_ctx:
                with lock:
                    self.ctx_shift(st, DECODE_CHUNK)
            token_ids = None
            if use_draft or use_spec or use_spec_stoch:
                passes = _fit_passes(gov.passes_for(DECODE_CHUNK, width,
                                                    _spec_passes(DECODE_CHUNK, width)),
                                     st.n_past, width, st.n_ctx, floor=1)
                if passes:
                    with lock:
                        if use_draft:
                            token_ids = _draft_chunk(self, dfns, st, passes, width)
                        elif use_spec:
                            token_ids = self.decode_chunk_spec(st, passes, width)
                        else:
                            token_ids = self.decode_chunk_spec_stoch(st, passes, width, rows)
                    gov.observe(len(token_ids), passes, 1)
            if token_ids is None:
                if st.spec_ban >= 0:
                    if st.n_past + 1 > st.n_ctx:
                        return
                    with lock:
                        token_ids = self.resolve_ban(st, rows)
                else:
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

    def save_state(self, path) -> None:
        """Checkpoint the engine's chat (cache, cursor, pending logits,
        history, generator) to ``path``: :meth:`DecodeState.save`."""
        self._st.save(path)

    def restore_state(self, path) -> None:
        """Resume a chat from a checkpoint of :meth:`save_state` or of the
        JAX engine's ``save_state``: :meth:`DecodeState.restore`, into the
        cache tensors that the captured steps replay on."""
        self._st.restore(path)

    @staticmethod
    def contains_eos_token(s: str) -> bool:
        return s == EOS_TOKEN_SUFFIX

    @staticmethod
    def is_eos(s: str) -> bool:
        return s.endswith(EOS_SUFFIX)

    def close(self) -> None:
        self._container.close()
        self._llm_file.close()
        if self._draft_file is not None:
            self._draft_file.close()


def _check_drafter(draft_llm_path, draft_head_path, tp: int) -> None:
    """The JAX engine's refusals of a drafter: both kinds at once, or one
    under tp > 1."""
    if draft_head_path is not None and draft_llm_path is not None:
        raise ValueError("pass draft_llm_path OR draft_head_path, not both")
    if tp > 1 and draft_head_path is not None:
        raise ValueError("draft_head_path requires tp=1")
    if tp > 1 and draft_llm_path is not None:
        raise ValueError("draft_llm_path requires tp=1 (the drafter is small enough to "
                         "replicate; sharding it buys nothing)")


def resolve_decoder_mode(quant_mode: str, smooth_scales=None) -> str:
    """The decoder's weight form for an engine's ``quant_mode``: ``auto`` is
    gq, or w8a8 where calibration scales are given (a deliberate w8a8
    opt-in)."""
    if quant_mode == "auto":
        return "w8a8" if smooth_scales else "gq"
    return quant_mode


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
    belong to the rolled-back continuation and are dropped, with their ban,
    and the drafter's frontier follows the cursor down."""
    if n > 0:
        st.n_past -= n
        del st.tokens[st.n_past:]
        st.logits = None
        st.spec_ban = -1
        st.draft_past = min(st.draft_past, st.n_past)


class DraftFns:
    """The drafter of draft-model speculation over states of ``dcfg.n_ctx``
    positions (JAX's ``DraftFns``): its params and config, its cache
    (:meth:`new_cache`, bf16 as JAX's) and the catch-up prefill.  The
    drafted dispatch itself is :func:`llama.draft_speculative_decode_loop`.
    On a graph engine both replay captured graphs over the state's resident
    caches (``StepGraphs.draft_chunk`` / ``catchup``, keys ("draft",
    passes, k) and ("catchup", bucket, span))."""

    def __init__(self, dparams: dict, dcfg, device):
        self.dparams, self.dcfg, self.device = dparams, dcfg, device

    def new_cache(self) -> dict:
        return llama_mod.init_cache(self.dcfg, 1, torch.bfloat16, self.device)

    def attn_bucket(self, needed: int) -> int:
        return _attn_bucket(needed, self.dcfg.n_ctx)

    def catchup(self, dcache: dict, ids: torch.Tensor, pos0, attn_len: int | None) -> None:
        """Prefill the token ids ``ids`` [1, S] long (on the device) into the
        draft cache from the cursor ``pos0`` (logits discarded); -1 entries
        (injected embedding rows, whose width the drafter does not take)
        feed zero embeddings.  Reads no host value."""
        emb = llama_mod.embed_tokens(self.dparams, ids.clamp(min=0))
        emb = torch.where((ids < 0)[..., None], 0.0, emb).to(emb.dtype)
        llama_mod.forward(self.dparams, dcache, emb, pos0, self.dcfg, attn_len=attn_len)


def _spec_passes(decode_chunk: int, k: int) -> int:
    """Verify passes per speculative dispatch: at least 2 (a pass may emit
    one token), at least ``decode_chunk`` positions of width."""
    return max(1, max(decode_chunk, 2 * k) // k)


class _SpecGovernor:
    """Adaptive speculation (the JAX package's ``_SpecGovernor``, with its
    constants, so that both make the same decisions on the same
    observations).  A batched verify pass costs more than a plain step, the
    more so the more lanes it carries, so a group whose tokens per
    lane-pass stay low loses throughput by speculating.  The governor keeps
    an EWMA of tokens per lane-pass, from which it scales the passes per
    dispatch; below the lane-scaled break-even the group decodes plain
    chunks for ``cooldown`` steps, then probes again with one speculative
    step.  The ids are the same either way; only the throughput moves.  A
    single stream (``MiniGPT4Engine.generate``) keeps only the EWMA: its
    break-even is 0, so it never demotes."""

    def __init__(self, cooldown: int = 8, break_even: float | None = None):
        self.cooldown = cooldown
        self.break_even = break_even  # None: the lane-scaled formula
        self.ewma: float | None = None
        self.cool = 0
        self.demotions = 0

    def threshold(self, lanes: int) -> float:
        """Break-even tokens per lane-pass: a pass premium taken as linear in
        the lane count, floored just above 1 (one or two lanes practically
        never demote) and capped at 1.5."""
        if self.break_even is not None:
            return self.break_even
        return min(1.5, 1.0 + 0.054 * lanes)

    def want_spec(self) -> bool:
        if self.cool > 0:
            self.cool -= 1
            return False
        return True

    def passes_for(self, decode_chunk: int, k: int, start: int = 2) -> int:
        """Verify passes per dispatch: ``start`` doubled up to 16 until, at
        the observed acceptance, a dispatch emits about ``decode_chunk``
        tokens and its fixed cost amortizes as a plain chunk's does.  A
        group starts from 2, a single stream from :func:`_spec_passes`, as
        in JAX."""
        est = self.ewma if self.ewma is not None else float(k)
        want = decode_chunk / max(est, 1.0)
        p = start
        while p < min(want, 16):
            p *= 2
        return p

    def observe(self, tokens: int, passes: int, lanes: int) -> None:
        r = tokens / max(passes * lanes, 1)
        self.ewma = r if self.ewma is None else 0.5 * self.ewma + 0.5 * r
        if self.ewma < self.threshold(lanes):
            self.cool = self.cooldown
            self.demotions += 1
            self.ewma = None  # a fresh estimate at the next probe


def _fit_passes(n_passes: int, pos: int, k: int, n_ctx: int, floor: int) -> int:
    """``n_passes`` halved toward ``floor`` until the passes' k-wide spans
    from ``pos`` fit the context; 0 where even ``floor`` passes do not."""
    while n_passes > floor and pos + n_passes * k > n_ctx:
        n_passes = max(floor, n_passes // 2)
    return n_passes if pos + n_passes * k <= n_ctx else 0


def _lane_hist(states: list, n_ctx: int, device) -> torch.Tensor:
    """The lanes' token histories [B, n_ctx] long on ``device``, -1 past
    each lane's cursor: what the n-gram drafts read."""
    hist = torch.full((len(states), n_ctx), -1, dtype=torch.long)
    for i, st in enumerate(states):
        hist[i, :st.n_past] = torch.tensor(st.tokens[:st.n_past], dtype=torch.long)
    return hist.to(device)


def _draft_catchup(dfns: DraftFns, st: DecodeState, chunk: int = 64,
                   steps: StepGraphs | None = None) -> None:
    """Bring the draft cache's frontier up to the cursor by prefilling
    ``st.tokens[draft_past:n_past]`` through the drafter (JAX's
    ``_draft_catchup``), in chunks padded to power-of-two buckets; near the
    context end the exact remainder, since a padded write there would clamp
    onto history.  ``steps``: the drafter's captured steps over the state's
    resident caches (``MiniGPT4Engine._draft_steps``), else eager."""
    if st.dcache is None:
        st.dcache = dfns.new_cache()
        st.draft_past = 0
    while st.draft_past < st.n_past:
        span = st.tokens[st.draft_past:min(st.draft_past + chunk, st.n_past)]
        b = _bucket(len(span), chunk)
        if st.draft_past + b > dfns.dcfg.n_ctx:
            b = len(span)
        ids = torch.tensor([span + [-1] * (b - len(span))], dtype=torch.long).to(dfns.device)
        attn = dfns.attn_bucket(st.draft_past + b)
        with torch.no_grad():
            if steps is not None:
                steps.catchup(ids, st.draft_past, attn)
            else:
                dfns.catchup(st.dcache, ids, st.draft_past, attn)
        st.draft_past += len(span)


def _draft_chunk(eng: "MiniGPT4Engine", dfns: DraftFns, st: DecodeState, n_passes: int,
                 k: int) -> list[int]:
    """One draft-model speculative dispatch (JAX's ``_draft_chunk``): the
    catch-up, then ``n_passes`` drafted verify passes, booked as
    :meth:`MiniGPT4Engine.decode_chunk_spec` books them; captured graphs on
    a graph engine.  Positions past the new cursor hold rejected drafts: the
    frontier stops at the cursor."""
    steps = eng._draft_steps(st, dfns)
    _draft_catchup(dfns, st, steps=steps)
    with torch.no_grad():
        if steps is not None:
            out = steps.draft_chunk(st.logits[None], st.n_past, n_passes, k)
        else:
            out = llama_mod.draft_speculative_decode_loop(
                eng.llm_params, st.cache, dfns.dparams, st.dcache, st.logits[None], st.n_past,
                n_passes, k, eng.llm_cfg, dfns.dcfg)
    ids = eng._emit(st, *out)
    st.draft_past = st.n_past
    st.spec_ban = -1
    return ids


def _device_config(params: SamplingParams) -> DeviceSamplingConfig:
    return DeviceSamplingConfig(temp=params.temp, top_k=params.top_k, top_p=params.top_p,
                                tfs_z=params.tfs_z, typical_p=params.typical_p)
