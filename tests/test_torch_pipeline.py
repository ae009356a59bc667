"""The port's two-stage pipeline (``minigpt4_tpu_torch.parallel.pipeline``)
against the sequential engine, as ``tests/test_pipeline.py`` holds the JAX
package's: both stages on the CPU here (on a card both may be cuda:0)."""

import numpy as np
import pytest

from fixtures import build_tiny_models
from minigpt4_tpu.engine import MiniGPT4Engine as JaxEngine
from minigpt4_tpu.engine import SamplingParams as JaxParams
from minigpt4_tpu_torch.engine import MiniGPT4Engine, SamplingParams
from minigpt4_tpu_torch.parallel.pipeline import TwoStagePipeline

QUESTION = "what is this?"
IMAGES = [np.random.default_rng(s).normal(0, 1, (3, 28, 28)).astype(np.float32)
          for s in range(3)]


def _sequential(eng, params):
    out = []
    for im in IMAGES:
        eng.reset_chat()
        eng.system_prompt()
        eng.begin_chat_image(eng.encode_image(im), QUESTION)
        out.append("".join(eng.generate(limit=6, params=params)))
    eng.close()
    return out


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    return build_tiny_models(tmp_path_factory.mktemp("torch_pipeline"))


def test_pipeline_matches_sequential(models):
    want = _sequential(MiniGPT4Engine(*models, n_ctx=256, n_batch=32, device="cpu"),
                       SamplingParams(temp=0.0))
    eng = MiniGPT4Engine(*models, n_ctx=256, n_batch=32, device="cpu")
    pipe = TwoStagePipeline(eng, "cpu", "cpu")
    for i, im in enumerate(IMAGES):
        pipe.submit(i, im)  # every encode queued before any decode
    got = list(pipe.results(QUESTION, limit=6))
    eng.close()
    assert [t for t, _ in got] == [0, 1, 2]
    assert [txt for _, txt in got] == want
    # the JAX package's sequential engine gives the same texts
    assert want == _sequential(JaxEngine(*models, n_ctx=256, n_batch=32), JaxParams(temp=0.0))
    # stage placement: each stage's weights on its device
    assert pipe.vision_device.type == pipe.llm_device.type == "cpu"
    assert pipe.llm_params["tok_embeddings"].device == pipe.llm_device


def test_pipeline_needs_two_devices_or_named_ones(models):
    """Without devices named, a machine with fewer than two cards is refused
    (here: none), as the JAX pipeline refuses one device."""
    eng = MiniGPT4Engine(*models, n_ctx=256, n_batch=32, device="cpu")
    try:
        with pytest.raises(ValueError, match="two devices"):
            TwoStagePipeline(eng)
    finally:
        eng.close()
