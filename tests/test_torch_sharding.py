"""The port's sharded vision encoder (``parallel/sharding.py``), its sharded
training step at tp = 2 and over a (dp, tp) = (2, 2) mesh, and ``debug.py``
against the JAX package.

Every case runs in one spawn of 4 CPU ranks (``dryrun.run_ranks`` over
gloo; ``torch_tp_tasks.sharding_cases``) laid out as a (2, 2) mesh: the
tp = 2 cases run on each rank's tp pair, the dp = 2 x tp = 2 step over all
four, each dp rank taking one of the batch's two captions.  The JAX side is
``minigpt4_tpu.models.minigpt4.encode_image`` and ``debug.dump_vision_stages``
on the same fixture (``tests/fixtures.py``, the fixture of
``tests/test_sharding.py``), and ``minigpt4_tpu.train.caption_loss`` with
``jax.grad``.

Tolerances (f32).  The sharded embedding within 1e-5 of max|emb| of JAX's
(the whole port is within that of JAX, ``tests/test_torch_engine.py``; the
split only reorders f32 sums) and within 1e-6 of the port's own whole
encoder; stage dumps compared by ``debug.compare_dumps`` at its defaults
(rtol 1e-4, atol 1e-5).  A qkv shard cut without the per-rank interleave
moves the embedding by more than 100 times that bound (4.7e-3 of max|emb|
measured), and its dump diverges from block 0 on.  The training step: the
loss within 1e-5 relative and the projection's gradient within 1e-4 of
max|grad| of JAX's (the bounds of ``tests/test_torch_train.py``) and of the
port at tp = 1; the step without ``copy_to_tp`` misses the other rank's
partial gradients and is off by more than 1e-2 of max|grad|.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fixtures import build_tiny_models
from minigpt4_tpu import debug as jdebug
from minigpt4_tpu.engine.engine import MiniGPT4Engine as JaxEngine
from minigpt4_tpu.models import minigpt4 as jvision
from minigpt4_tpu.train import caption_loss as jcaption_loss
from minigpt4_tpu_torch import debug
from minigpt4_tpu_torch.formats import ContainerReader
from minigpt4_tpu_torch.models import minigpt4 as tvision
from minigpt4_tpu_torch.parallel import dryrun
from torch_rank_tasks import rank_tasks
from torch_tp_tasks import load

# one intra-op thread: the suite runs several pytest-xdist workers on the same cores, where
# torch's OpenMP pools spin against each other and run ~17x slower
torch.set_num_threads(1)

EMB_TOL = 1e-5  # of max|emb|, against JAX
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4  # of max|grad|
WRONG = 1e-2  # a wrong split moves the result by more than this share


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    model, llm = build_tiny_models(tmp_path_factory.mktemp("torch_sharding"))
    return str(model), str(llm)


@pytest.fixture(scope="module")
def pixels():
    return np.random.default_rng(0).normal(0, 1, (2, 3, 28, 28)).astype(np.float32)


def train_batch():
    rng = np.random.default_rng(3)
    tokens = np.concatenate([np.ones((2, 1), np.int64), rng.integers(3, 262, (2, 5))], axis=1)
    mask = np.ones((2, 6), np.float32)
    mask[1, -2:] = 0
    return dict(pixels=rng.normal(0, 1, (2, 3, 28, 28)).astype(np.float32), tokens=tokens,
                mask=mask)


@pytest.fixture(scope="module")
def ranks(files, pixels):
    """Every case in one spawn of 4 ranks; each rank's results."""
    model, llm = files
    task = ("cases", "fn", dict(fn="sharding_cases", model=model, llm=llm, pixels=pixels,
                                batch=train_batch()))
    return [r["cases"] for r in dryrun.run_ranks(rank_tasks, 4, ([task],), device="cpu",
                                                  timeout_s=240)]


@pytest.fixture(scope="module")
def jax_side(files, pixels):
    model, llm = files
    eng = JaxEngine(model, llm, n_ctx=64, n_batch=32)
    try:
        emb = np.asarray(jvision.encode_image(eng.vision_params, jnp.asarray(pixels),
                                              eng.vision_cfg))
        stages = jdebug.dump_vision_stages(eng.vision_params, jnp.asarray(pixels),
                                           eng.vision_cfg)
        b = train_batch()
        frozen = {"vision": {k: v for k, v in eng.vision_params.items() if k != "llama_proj"},
                  "llm": eng.llm_params}
        proj = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float32),
                                      eng.vision_params["llama_proj"])
        loss, grads = jax.value_and_grad(jcaption_loss)(
            proj, frozen, jnp.asarray(b["pixels"]), jnp.asarray(b["tokens"], jnp.int32),
            jnp.asarray(b["mask"]), eng.vision_cfg, eng.llm_cfg)
    finally:
        eng.close()
    return {"emb": emb, "stages": stages, "loss": float(loss),
            "grad": {k: np.asarray(v) for k, v in grads.items()}}


@pytest.fixture(scope="module")
def port_tp1(files, pixels):
    """The port's whole encoder, its stage dumps and its training step at
    tp = 1."""
    model, llm = files
    with ContainerReader(model) as r:
        vp, vcfg = tvision.load_params(r, torch.float32, "cpu")
    with torch.no_grad():
        emb = tvision.encode_image(vp, torch.from_numpy(pixels), vcfg).numpy()
    return {"emb": emb, "stages": debug.dump_vision_stages(vp, pixels, vcfg),
            "train": _one_rank_step(model, llm)}


def _one_rank_step(model, llm) -> dict:
    from minigpt4_tpu_torch.train.projection import make_train_step

    vp, vcfg, lp, lcfg = load(model, llm, "cpu", n_ctx=64)
    proj = {k: v.detach().clone().requires_grad_(True) for k, v in vp["llama_proj"].items()}
    frozen = {"vision": {k: v for k, v in vp.items() if k != "llama_proj"}, "llm": lp}
    b = train_batch()
    step = make_train_step(vcfg, lcfg, torch.optim.Adam(list(proj.values()), lr=1e-3))
    proj, loss = step(proj, frozen, *(torch.from_numpy(b[k]) for k in ("pixels", "tokens",
                                                                         "mask")))
    return {"loss": float(loss), "grad": {k: v.grad.numpy() for k, v in proj.items()},
            "proj": {k: v.detach().numpy() for k, v in proj.items()}}


def _rel(got, want) -> float:
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(want).max())


def test_vision_placement(ranks):
    """JAX's rules at tp = 2 on the fixture (d 32, 4 heads of 8, mlp 64):
    qkv and fc1 column-parallel, proj and fc2 row-parallel; a rank holds
    its [q | k | v] of 16 rows each, 48 of the fused 96."""
    for r in ranks:
        assert r["encoder"]["kinds"] == {"qkv": "col", "fc1": "col", "proj": "row",
                                         "fc2": "row"}
        assert r["encoder"]["local_qkv"] == 48


def test_sharded_encoder_matches_jax_and_whole(ranks, jax_side, port_tp1):
    for r in ranks:
        assert _rel(r["encoder"]["emb"], jax_side["emb"]) <= EMB_TOL
        assert _rel(r["encoder"]["emb"], port_tp1["emb"]) <= 1e-6
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["encoder"]["emb"], ranks[0]["encoder"]["emb"])


def test_stage_dumps_compare_with_jax(ranks, jax_side, tmp_path):
    """debug.compare_dumps of the sharded port's and JAX's stage dumps: the
    same stage names, in order, and no divergence."""
    port, jax_path = tmp_path / "port.npz", tmp_path / "jax.npz"
    debug.save_dump(ranks[0]["encoder"]["stages"], str(port))
    jdebug.save_dump(jax_side["stages"], str(jax_path))
    report = debug.compare_dumps(str(port), str(jax_path))
    assert [r["stage"] for r in report] == list(jax_side["stages"])
    assert debug.first_divergence(report) is None, report
    assert jdebug.first_divergence(jdebug.compare_dumps(str(jax_path), str(port))) is None


def test_wrong_qkv_interleave_is_caught(ranks, jax_side, tmp_path):
    """Rows cut without the interleave give rank 0 all of q: the embedding
    leaves the bound, and ``first_divergence`` names the first block."""
    for r in ranks:
        assert _rel(r["encoder"]["emb_wrong"], jax_side["emb"]) > 100 * EMB_TOL
    wrong, jax_path = tmp_path / "wrong.npz", tmp_path / "jax.npz"
    debug.save_dump(ranks[0]["encoder"]["stages_wrong"], str(wrong))
    jdebug.save_dump(jax_side["stages"], str(jax_path))
    first = debug.first_divergence(debug.compare_dumps(str(wrong), str(jax_path)))
    assert first["stage"] == "vit_block_0" and first["max_rel"] > WRONG, first


def test_sharded_train_step_matches_jax_and_tp1(ranks, jax_side, port_tp1):
    one = port_tp1["train"]
    for r in ranks:
        got = r["train"]
        assert abs(got["loss"] - jax_side["loss"]) <= LOSS_RTOL * abs(jax_side["loss"])
        assert abs(got["loss"] - one["loss"]) <= LOSS_RTOL * abs(one["loss"])
        for k, want in jax_side["grad"].items():
            assert _rel(got["grad"][k], want) <= GRAD_TOL, k
            assert _rel(got["grad"][k], one["grad"][k]) <= GRAD_TOL, k
            np.testing.assert_allclose(got["proj"][k], one["proj"][k], rtol=1e-5, atol=1e-7)
    for r in ranks[1:]:
        for k in ("w", "b"):
            np.testing.assert_array_equal(r["train"]["grad"][k], ranks[0]["train"]["grad"][k])


def test_without_copy_to_tp_the_gradient_is_wrong(ranks, port_tp1):
    """The loss does not see the missing backward sum; the gradient does."""
    one = port_tp1["train"]
    for r in ranks:
        got = r["train no copy"]
        assert abs(got["loss"] - one["loss"]) <= LOSS_RTOL * abs(one["loss"])
        assert _rel(got["grad"]["w"], one["grad"]["w"]) > WRONG


def test_dp2_tp2_step_matches_jax_and_tp1(ranks, jax_side, port_tp1):
    """The (dp, tp) = (2, 2) step: the loss and gradient of the whole batch
    (each dp rank's masked sum over the batch's count, summed over dp),
    JAX's and tp = 1's; every rank holds the same bits after it."""
    one = port_tp1["train"]
    for r in ranks:
        got = r["dp2 tp2"]
        assert abs(got["loss"] - jax_side["loss"]) <= LOSS_RTOL * abs(jax_side["loss"])
        assert abs(got["loss"] - one["loss"]) <= LOSS_RTOL * abs(one["loss"])
        for k, want in jax_side["grad"].items():
            assert _rel(got["grad"][k], want) <= GRAD_TOL, k
            assert _rel(got["grad"][k], one["grad"][k]) <= GRAD_TOL, k
            np.testing.assert_allclose(got["proj"][k], one["proj"][k], rtol=1e-5, atol=1e-7)
            np.testing.assert_array_equal(got["proj"][k], ranks[0]["dp2 tp2"]["proj"][k])


def test_whole_port_stage_dumps_match_jax(port_tp1, jax_side, tmp_path):
    """``debug.dump_vision_stages`` of the whole port: JAX's stage names in
    JAX's order, no divergence at ``compare_dumps``' defaults, and the same
    report from either package's ``compare_dumps``."""
    port, jax_path = tmp_path / "port.npz", tmp_path / "jax.npz"
    debug.save_dump(port_tp1["stages"], str(port))
    jdebug.save_dump(jax_side["stages"], str(jax_path))
    assert list(port_tp1["stages"]) == list(jax_side["stages"])
    report = debug.compare_dumps(str(port), str(jax_path))
    assert debug.first_divergence(report) is None, report
    assert report == [{**r, "max_abs": pytest.approx(r["max_abs"]),
                       "max_rel": pytest.approx(r["max_rel"])}
                      for r in jdebug.compare_dumps(str(port), str(jax_path))]


def test_dryrun_steps_on_cpu_ranks(ranks):
    """The dry run's steps 1 and 2 on the fixture pair: the train step's
    loss and projection against one rank's, the sharded chat's tokens
    against the whole model's."""
    for r in ranks:
        step = r["dryrun"]["train"]
        assert abs(step["mesh"]["loss"] - step["one"]["loss"]) <= LOSS_RTOL * step["one"]["loss"]
        assert r["dryrun"]["sharded"] == r["dryrun"]["whole"]
        assert len(r["dryrun"]["sharded"]) == 4
