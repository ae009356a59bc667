"""Two-stage pipeline: the vision encoder and the decoder on two devices,
overlapped by asynchronous launches.

Counterpart of ``minigpt4_tpu/parallel/pipeline.py``.  The vision stack and
the decoder are separate computations with one [B, 32, n_embd] activation
crossing between them, so stage parallelism is placement: the vision
weights live on the vision device, the decoder's weights and KV cache on
the decoder device; :meth:`TwoStagePipeline.submit` queues an encode and
the copy of its embedding to the decoder device without waiting (CUDA
launches return at once), and :meth:`TwoStagePipeline.results` decodes the
requests in order while later encodes run.  Both stages may name one
device (one card runs them in turn).
"""

from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch

from ..models import minigpt4 as vision_mod


def to_device(tree, device: torch.device):
    """A parameter tree (dicts, lists, tensors and the quantized weight
    dataclasses) with every tensor on ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, device) for v in tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: to_device(getattr(tree, f.name), device) for f in dataclasses.fields(tree)
            if isinstance(getattr(tree, f.name), torch.Tensor)})
    return tree


class TwoStagePipeline:
    """Overlapped image encode / caption decode on two devices.

    ``submit(tag, pixels)`` queues an encode on the vision device and
    returns; ``results(question, ...)`` yields (tag, text) in submission
    order.  Without devices named, the vision stage takes cuda:0 and the
    decoder cuda:1."""

    def __init__(self, engine, vision_device=None, llm_device=None):
        if engine.tp != 1:
            raise ValueError("the two-stage pipeline runs a tp=1 engine")
        if vision_device is None or llm_device is None:
            if torch.cuda.device_count() < 2:
                raise ValueError("pipeline parallelism needs two devices, or both named "
                                 "(vision_device, llm_device; they may be the same)")
            vision_device = vision_device or "cuda:0"
            llm_device = llm_device or "cuda:1"
        self.engine = engine
        self.vision_device = torch.device(vision_device)
        self.llm_device = torch.device(llm_device)
        engine.vision_params = to_device(engine.vision_params, self.vision_device)
        engine.llm_params = to_device(engine.llm_params, self.llm_device)
        self.vision_params, self.llm_params = engine.vision_params, engine.llm_params
        if engine.device != self.llm_device:
            st = engine._st
            st.cache = to_device(st.cache, self.llm_device)
            st.logits = None if st.logits is None else st.logits.to(self.llm_device)
            gen = torch.Generator(device=self.llm_device)
            gen.manual_seed(st.generator.initial_seed())
            st.generator = gen
            engine.device = self.llm_device
        self._queue: deque = deque()

    def submit(self, tag, pixels: np.ndarray) -> None:
        """Queue the encode on the vision device and the embedding's copy to
        the decoder device; does not wait for either."""
        pixels = np.asarray(pixels, np.float32)
        if pixels.ndim == 3:
            pixels = pixels[None]
        x = torch.from_numpy(pixels).to(self.vision_device)
        with torch.no_grad():
            emb = vision_mod.encode_image(self.vision_params, x, self.engine.vision_cfg)
        self._queue.append((tag, emb.to(self.llm_device, non_blocking=True)))

    def results(self, question: str, limit: int = 64, params=None):
        """Yield (tag, generated text) in submission order: the chat of
        ``begin_chat_image`` on each embedding, kept on the decoder device."""
        from ..engine.sampling import SamplingParams

        eng = self.engine
        dtype = eng.llm_params["tok_embeddings"].dtype
        while self._queue:
            tag, emb = self._queue.popleft()
            eng.reset_chat()
            eng.system_prompt()
            eng.add_strings("Human: <Img>")
            eng._prefill_embeds(eng._st, emb.reshape(1, -1, eng.llm_cfg.n_embd).to(dtype))
            eng.add_strings("</Img> ")
            eng._st.n_keep = eng.n_past
            eng.add_strings(question)
            eng.add_strings("### Assistant:")
            text = "".join(eng.generate(limit=limit, params=params or SamplingParams(temp=0.0)))
            yield tag, text
