"""Python host for the C ABI library: one ``Host`` per MiniGPT4Context.

The marshalling layer between ``libminigpt4_torch.so``'s embedded
interpreter and the port's engine (counterpart of
``minigpt4_tpu/c_api/capi_host.py``): bytes in; bytes, strings and ints out;
no array object crosses the C boundary.  It keeps the per-call semantics of
the reference's C++ MiniGPT4 class (sample-then-eval, the n_past cursor,
the chat templates).

The 18 functions of the reference ABI have fixed signatures, so the engine
options beyond them are environment variables, read when a model loads:

    MINIGPT4_TPU_DEVICE         cuda (default) | cpu | cuda:N; the engine
                                never falls back to the CPU on its own
    MINIGPT4_TPU_CACHE_DTYPE    f32 | bf16 | f8
    MINIGPT4_TPU_QUANT_MODE     auto | repack | qtensor | w8a8 | gq
    MINIGPT4_TPU_SMOOTH_SCALES  smooth-quant scales (quality.py --save-scales)
    MINIGPT4_TPU_WARMUP         set: capture the engine's CUDA graphs at load
                                (MiniGPT4Engine.warmup)
    MINIGPT4_TPU_SPECULATIVE_K  speculative verify width (0 = off), an integer
"""

from __future__ import annotations

import os

import numpy as np

from .. import image as image_mod
from ..engine import MiniGPT4Engine, SamplingParams
from ..engine.engine import CACHE_DTYPES
from ..models.params import QUANT_MODES


def engine_options() -> dict:
    """The engine keywords the environment asks for (see the module
    docstring); raises ValueError on a value the port cannot serve."""
    kw = {"device": os.environ.get("MINIGPT4_TPU_DEVICE") or "cuda"}
    cd = os.environ.get("MINIGPT4_TPU_CACHE_DTYPE")
    if cd:
        if cd not in CACHE_DTYPES:
            raise ValueError(f"MINIGPT4_TPU_CACHE_DTYPE={cd!r}: expected "
                             f"{' | '.join(CACHE_DTYPES)}")
        kw["cache_dtype"] = cd
    qm = os.environ.get("MINIGPT4_TPU_QUANT_MODE")
    if qm:
        if qm not in QUANT_MODES:
            raise ValueError(f"MINIGPT4_TPU_QUANT_MODE={qm!r}: expected "
                             f"{' | '.join(QUANT_MODES)}")
        kw["quant_mode"] = qm
    sm = os.environ.get("MINIGPT4_TPU_SMOOTH_SCALES")
    if sm:
        if not os.path.exists(sm):
            raise FileNotFoundError(f"MINIGPT4_TPU_SMOOTH_SCALES={sm!r} does not exist")
        kw["smooth_scales"] = sm
    sk = os.environ.get("MINIGPT4_TPU_SPECULATIVE_K")
    if sk:
        try:
            kw["speculative_k"] = int(sk)
        except ValueError:
            raise ValueError(f"MINIGPT4_TPU_SPECULATIVE_K={sk!r}: expected an integer") from None
    return kw


class Host:
    def __init__(self, path: str, llm_model: str, verbosity: int, seed: int,
                 n_ctx: int, n_batch: int):
        self.engine = MiniGPT4Engine(path, llm_model, verbosity=verbosity, seed=seed,
                                     n_ctx=n_ctx, n_batch=n_batch, **engine_options())
        if os.environ.get("MINIGPT4_TPU_WARMUP"):
            self.engine.warmup()

    # -- images --
    def image_load_from_file(self, path: str):
        arr = image_mod.load_image(path)
        h, w, c = arr.shape
        return (arr.tobytes(), w, h, c)

    def preprocess_image(self, data: bytes, width: int, height: int):
        arr = np.frombuffer(data, np.uint8).reshape(height, width, 3)
        size = self.engine.vision_cfg.vit.image_size
        out = image_mod.preprocess(arr, size=size)
        return (out.astype("<f4").tobytes(), size)

    def encode_image(self, data: bytes, width: int, height: int):
        arr = np.frombuffer(data, "<f4").reshape(3, height, width).copy()  # writable
        return np.asarray(self.engine.encode_image(arr), "<f4").tobytes()

    # -- chat --
    def begin_chat_image(self, embedding: bytes, s: str) -> int:
        self.engine.begin_chat_image(np.frombuffer(embedding, "<f4").copy(), s)
        return 0

    def begin_chat(self, s: str) -> int:
        self.engine.begin_chat(s)
        return 0

    def system_prompt(self) -> int:
        self.engine.system_prompt()
        return 0

    def end_chat(self, temp, top_k, top_p, tfs_z, typical_p, repeat_last_n,
                 repeat_penalty, alpha_presence, alpha_frequency, mirostat,
                 mirostat_tau, mirostat_eta, penalize_nl) -> str:
        params = SamplingParams(
            temp=temp, top_k=int(top_k), top_p=top_p, tfs_z=tfs_z, typical_p=typical_p,
            repeat_last_n=int(repeat_last_n), repeat_penalty=repeat_penalty,
            alpha_presence=alpha_presence, alpha_frequency=alpha_frequency,
            mirostat=int(mirostat), mirostat_tau=mirostat_tau, mirostat_eta=mirostat_eta,
            penalize_nl=bool(penalize_nl),
        )
        return self.engine.end_chat(params)

    def reset_chat(self) -> int:
        self.engine.reset_chat()
        return 0

    def close(self) -> None:
        self.engine.close()
