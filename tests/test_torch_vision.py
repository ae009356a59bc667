"""Port parity for the vision pipeline (ViT -> ln_vision -> Q-Former ->
llama_proj): against the JAX encode_image on the tiny fixture container,
and stage by stage against the committed torch goldens
(tests/goldens/vision_goldens.npz) at test_goldens.py's rtol/atol 2e-3.

Port and JAX are both f32 end to end (matmuls, LayerNorm statistics,
softmax, exact GELU), so they agree to f32 summation-order noise: 1e-5 of
the output's max magnitude.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fixtures import build_tiny_models
from minigpt4_tpu.formats import ContainerReader, ContainerWriter, DataType
from minigpt4_tpu.models import minigpt4 as jvision
from minigpt4_tpu_torch import interop
from minigpt4_tpu_torch.models import eva_vit, qformer
from minigpt4_tpu_torch.models import minigpt4 as tvision
from minigpt4_tpu_torch.models.layers import layer_norm

# one intra-op thread: the suite runs several pytest-xdist workers on the same cores, where
# torch's OpenMP pools spin against each other and run ~17x slower
torch.set_num_threads(1)

GOLDENS = Path(__file__).parent / "goldens" / "vision_goldens.npz"


@pytest.fixture(scope="module")
def tiny_container(tmp_path_factory):
    model, _ = build_tiny_models(tmp_path_factory.mktemp("torch_vision"))
    return model


def test_encode_image_matches_jax(tiny_container):
    with ContainerReader(tiny_container) as r:
        jparams, jcfg = jvision.load_params(r)
        tparams, tcfg = tvision.load_params(r, torch.float32, "cpu")
    pixels = np.random.default_rng(0).normal(0, 1, (2, 3, 28, 28)).astype(np.float32)
    want = np.asarray(jvision.encode_image(jparams, jnp.asarray(pixels), jcfg))
    got = tvision.encode_image(tparams, torch.from_numpy(pixels), tcfg).numpy()
    assert got.shape == want.shape == (2, 4, 32)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    # the interop copy of the JAX params computes the same thing
    carried = interop.vision_params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                               "cpu")
    again = tvision.encode_image(carried, torch.from_numpy(pixels), tcfg).numpy()
    np.testing.assert_array_equal(again, got)


def _golden_container(g, path):
    cfg = json.loads(bytes(g["cfg/json"]).decode())
    cfg["ftype"] = "f32"
    w = ContainerWriter(path, ftype=1, config=cfg)
    models = {m: [] for m in ("visual_encoder", "ln_vision", "query_tokens", "Qformer",
                              "llama_proj")}
    for key in g.files:
        if key.startswith("w/"):
            _, model, name = key.split("/", 2)
            a = np.ascontiguousarray(g[key]).astype("<f4")
            models[model].append((name, a.shape, DataType.F32, a.view(np.uint8).reshape(-1)))
    for model, tensors in models.items():
        w.add_model(model, tensors)
    w.write()
    return path


@pytest.fixture(scope="module")
def golden_stages(tmp_path_factory):
    """Every stage of the port's encode on the goldens' weights and pixels."""
    g = np.load(GOLDENS)
    path = _golden_container(g, tmp_path_factory.mktemp("torch_goldens") / "g.bin")
    with ContainerReader(path) as r:
        p, cfg = tvision.load_params(r, torch.float32, "cpu")
    vp, vcfg = p["visual_encoder"], cfg.vit
    stages = {}
    x = eva_vit.patch_embed(torch.from_numpy(g["in/pixels"]), vp["patch_embed"], vcfg)
    stages["patch_embed"] = x
    cls = vp["cls_token"].expand(x.shape[0], 1, vcfg.embed_dim)
    x = torch.cat([cls, x], dim=1) + vp["pos_embed"]
    stages["embeddings"] = x
    for li in range(vcfg.depth):
        x = eva_vit.block_forward(x, vp["blocks"], vcfg, li)
        stages[f"vit_block_{li}"] = x
    x = layer_norm(x, p["ln_vision"], tvision.LN_VISION_EPS)
    stages["ln_vision"] = x
    qp = p["qformer"]
    q = layer_norm(qp["query_tokens"].expand(x.shape[0], *qp["query_tokens"].shape),
                   qp["ln_embed"], qformer.LN_EPS)
    stages["qformer_embed"] = q
    for li, lp in enumerate(qp["layers"]):
        q = qformer.layer_forward(q, lp, cfg.qformer, x)
        stages[f"qformer_layer_{li}"] = q
    stages["llama_proj"] = tvision.encode_image(p, torch.from_numpy(g["in/pixels"]), cfg)
    return g, stages


STAGES = ["patch_embed", "embeddings", "vit_block_0", "vit_block_1", "vit_block_2",
          "ln_vision", "qformer_embed", "qformer_layer_0", "qformer_layer_1", "llama_proj"]


@pytest.mark.parametrize("stage", STAGES)
def test_stage_matches_torch_golden(golden_stages, stage):
    g, stages = golden_stages
    np.testing.assert_allclose(stages[stage].numpy(), g[f"g/{stage}"], rtol=2e-3, atol=2e-3)
