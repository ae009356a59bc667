"""Python client API on the PyTorch engine: ``MiniGPT4ChatBot`` with the
reference chatbot's methods (minigpt4_library.py:568-689), and the
``MiniGPT4SharedLibrary`` methods it calls.  Counterpart of
``minigpt4_tpu/library.py`` for the chat path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from .engine import MiniGPT4Engine, SamplingParams
from . import utils
from .image import preprocess

Verbosity = utils.Verbosity


@dataclass
class MiniGPT4Embedding:
    """POD mirror of struct MiniGPT4Embedding (minigpt4.h:74-78)."""

    data: np.ndarray
    elements: int


class MiniGPT4SharedLibrary:
    """The ctypes wrapper's method names and call conventions
    (minigpt4_library.py:74-523), backed by engines held in this object."""

    def __init__(self, device: str = "cuda", quant_mode: str = "auto",
                 cache_dtype: str | None = None, smooth_scales=None):
        # the reference's signatures have no engine options: the device, the
        # quantized-weight form, the KV cache type and the smooth-quant scales
        # (MiniGPT4Engine's quant_mode, cache_dtype and smooth_scales; the JAX
        # C ABI host reads them from MINIGPT4_TPU_* variables) are set per
        # library object
        self.device = device
        self.quant_mode = quant_mode
        self.cache_dtype = cache_dtype
        self.smooth_scales = smooth_scales
        self._ctxs: dict[int, MiniGPT4Engine] = {}
        self._next = 1

    def minigpt4_model_load(self, path: str, llm_model: str, verbosity: int = 0,
                            seed: int = 1337, n_ctx: int = 2048, n_batch: int = 512) -> int:
        eng = MiniGPT4Engine(path, llm_model, verbosity, seed, n_ctx, n_batch, device=self.device,
                             quant_mode=self.quant_mode, cache_dtype=self.cache_dtype,
                             smooth_scales=self.smooth_scales)
        handle = self._next
        self._next += 1
        self._ctxs[handle] = eng
        return handle

    def _eng(self, ctx: int) -> MiniGPT4Engine:
        return self._ctxs[ctx]

    def minigpt4_begin_chat_image(self, ctx: int, embedding: MiniGPT4Embedding, s: str,
                                  n_threads: int = 0) -> None:
        self._eng(ctx).begin_chat_image(embedding.data, s)

    def minigpt4_system_prompt(self, ctx: int, n_threads: int = 0) -> None:
        self._eng(ctx).system_prompt()

    def minigpt4_begin_chat(self, ctx: int, s: str, n_threads: int = 0) -> None:
        self._eng(ctx).begin_chat(s)

    def minigpt4_end_chat(self, ctx: int, n_threads: int = 0, **knobs) -> str:
        return self._eng(ctx).end_chat(SamplingParams(**knobs))

    def minigpt4_reset_chat(self, ctx: int) -> None:
        self._eng(ctx).reset_chat()

    def minigpt4_contains_eos_token(self, s: str) -> bool:
        return MiniGPT4Engine.contains_eos_token(s)

    def minigpt4_is_eos(self, s: str) -> bool:
        return MiniGPT4Engine.is_eos(s)

    def minigpt4_free(self, ctx: int) -> None:
        self._ctxs.pop(ctx).close()

    def minigpt4_free_embedding(self, embedding: MiniGPT4Embedding) -> None:
        embedding.data = None


class MiniGPT4ChatBot:
    """Drop-in chatbot session (minigpt4_library.py:568-689) on ``device``."""

    def __init__(self, model_path: str, llm_model_path: str,
                 verbosity: Verbosity = Verbosity.SILENT, n_threads: int = 0,
                 device: str = "cuda", quant_mode: str = "auto", cache_dtype: str | None = None,
                 smooth_scales=None):
        self.library = MiniGPT4SharedLibrary(device, quant_mode, cache_dtype, smooth_scales)
        self.ctx = self.library.minigpt4_model_load(model_path, llm_model_path, int(verbosity))
        self.n_threads = n_threads
        self.embedding: Optional[MiniGPT4Embedding] = None
        self.is_image_chat = False

    def free(self):
        if self.ctx:
            self.library.minigpt4_free(self.ctx)
            self.ctx = None

    def generate(
        self, message: str, limit: int = 1024, temp: float = 0.8, top_k: int = 40,
        top_p: float = 0.9, tfs_z: float = 1.0, typical_p: float = 1.0,
        repeat_last_n: int = 64, repeat_penalty: float = 1.1,
        alpha_presence: float = 1.0, alpha_frequency: float = 1.0, mirostat: int = 0,
        mirostat_tau: float = 5.0, mirostat_eta: float = 1.0, penalize_nl: int = 1,
    ):
        knobs = dict(
            temp=temp, top_k=top_k, top_p=top_p, tfs_z=tfs_z, typical_p=typical_p,
            repeat_last_n=repeat_last_n, repeat_penalty=repeat_penalty,
            alpha_presence=alpha_presence, alpha_frequency=alpha_frequency,
            mirostat=mirostat, mirostat_tau=mirostat_tau, mirostat_eta=mirostat_eta,
            penalize_nl=bool(penalize_nl),
        )
        if self.is_image_chat:
            self.is_image_chat = False
            self.library.minigpt4_begin_chat_image(self.ctx, self.embedding, message, self.n_threads)
        else:
            self.library.minigpt4_begin_chat(self.ctx, message, self.n_threads)
        chat = ""
        for _ in range(limit):
            token = self.library.minigpt4_end_chat(self.ctx, self.n_threads, **knobs)
            chat += token
            if self.library.minigpt4_contains_eos_token(token):
                continue
            if self.library.minigpt4_is_eos(chat):
                break
            yield token

    def reset_chat(self):
        self.is_image_chat = False
        if self.embedding:
            self.library.minigpt4_free_embedding(self.embedding)
            self.embedding = None
        self.library.minigpt4_reset_chat(self.ctx)
        self.library.minigpt4_system_prompt(self.ctx, self.n_threads)

    def upload_image(self, image) -> None:
        """image: PIL.Image or [H, W, 3] uint8 array."""
        self.reset_chat()
        arr = np.asarray(image.convert("RGB") if hasattr(image, "convert") else image)
        eng = self.library._eng(self.ctx)
        pre = preprocess(arr, size=eng.vision_cfg.vit.image_size)
        emb = eng.encode_image(pre)
        self.embedding = MiniGPT4Embedding(emb.reshape(-1), emb.size)
        self.is_image_chat = True
