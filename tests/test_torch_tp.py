"""The port's tensor parallelism against the JAX package's
(``tests/test_engine_tp.py``, ``tests/test_sharding.py``): placement
decisions weight by weight, the fused-row interleave, K slices of
repacked weights, ``_row_linear``'s four cases and the global-absmax i8
case over 2 gloo ranks, ``MiniGPT4Engine(tp=2)`` and ``(tp=4)`` chats
(greedy tokens equal to the port at tp=1 and to JAX's engine at tp=N),
``SessionPool(tp=2)`` and the refusals.  The ranks are spawned processes
(``minigpt4_tpu_torch.parallel.dryrun.run_ranks``, one spawn per group
size, each with its own deadline) running ``torch_rank_tasks``; they
import only the port."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as P

from fixtures import build_tiny_models
from minigpt4_tpu.engine.engine import MiniGPT4Engine as JaxEngine
from minigpt4_tpu.engine.sampling import SamplingParams as JaxParams
from minigpt4_tpu.formats import DataType as JaxDataType
from minigpt4_tpu.formats import LlamaFileReader as JaxReader
from minigpt4_tpu.models import llama as jllama
from minigpt4_tpu.parallel import spmd as jspmd
from minigpt4_tpu_torch.engine import MiniGPT4Engine
from minigpt4_tpu_torch.engine.sessions import SessionPool
from minigpt4_tpu_torch.formats import DataType, LlamaFileReader
from minigpt4_tpu_torch.formats import quants as nq
from minigpt4_tpu_torch.models import llama as tllama
from minigpt4_tpu_torch.ops import i8_matmul as i8
from minigpt4_tpu_torch.ops import repack as rp
from minigpt4_tpu_torch.ops.pallas_quant_matmul import qmatmul_repacked
from minigpt4_tpu_torch.parallel import dryrun, spmd
from test_torch_fixtures import build_llm_q5_k_m
from torch_rank_tasks import pool_run, rank_tasks, stepwise_tokens

ENGINE = dict(n_ctx=256, n_batch=16)
DEPTHS = (1, 4)  # layers of the q5_k files of the depth-gap cases


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The JAX package's tiny f32 and Q5_0 fixtures, its gq-geometry
    container, the 4-layer Q5_K_M file, and a q8_0 file whose w2 has K =
    1024 (so w8a8 K-shards it over 2 ranks)."""
    d = tmp_path_factory.mktemp("torch_tp")
    for sub in ("f32", "q5_0"):
        (d / sub).mkdir()
    f32 = build_tiny_models(d / "f32")
    q5 = build_tiny_models(d / "q5_0", quant=JaxDataType.Q5_0)
    km_model, _ = dryrun.write_models(d / "km", d=256)
    km = (km_model, build_llm_q5_k_m(d / "km" / "vicuna-q5_k_m.bin", np.random.default_rng(7)))
    w8 = dryrun.write_models(d / "w8", quant=DataType.Q8_0, d=256, n_mult=512)
    (d / "depth").mkdir()
    depth = [str(dryrun.write_llm(d / "depth" / f"q5_k-L{n}.bin", np.random.default_rng(5), 256,
                                  4, 256, n_layer=n, quant=DataType.Q5_K)) for n in DEPTHS]
    return {"f32": tuple(map(str, f32)), "q5_0": tuple(map(str, q5)), "depth": depth,
            "km": tuple(map(str, km)), "w8": tuple(map(str, w8))}


def _chat(eng, limit=10):
    eng.system_prompt()
    eng.begin_chat("what is this?")
    return list(eng.generate(limit=limit, params=JaxParams(temp=0.0)))


# the engine cases: (fixture, quant_mode)
CASES = {"f32": ("f32", "auto"), "q5_0_repack": ("q5_0", "repack"), "w8a8": ("w8", "w8a8")}


def _task(label, kind, name, **kw):
    model, llm = kw.pop("files")[name]
    return (label, kind, dict(model=model, llm=llm, **ENGINE, **kw))


@pytest.fixture(scope="module")
def row_inputs():
    rng = np.random.default_rng(11)
    return dict(x=rng.normal(0, 1, (1, 3, 64)).astype(np.float32),
                w=rng.normal(0, 1, (64, 16)).astype(np.float32),
                x8=rng.normal(0, 1, (1, 3, 512)).astype(np.float32),
                w8=rng.normal(0, 0.05, (24, 512)).astype(np.float32))


@pytest.fixture(scope="module")
def ranks2(files, row_inputs):
    """Every 2-rank case in one spawn: each rank's results."""
    tasks = [_task(f"chat {k}", "chat", f, files=files, quant_mode=m) for k, (f, m) in CASES.items()]
    tasks.append(_task("stepwise", "stepwise", "f32", files=files))
    model, llm = files["f32"]
    tasks.append(("pool", "pool", dict(model=model, llm=llm, session_ctx=256, paged_pool_pages=8,
                                       **ENGINE)))
    tasks.append(_task("km repack", "refusal", "km", files=files, quant_mode="repack"))
    tasks.append(("row", "row_linear", row_inputs))
    prompt = [1] + [int(t) for t in np.random.default_rng(6).integers(3, 262, 47)]
    tasks.append(("depth", "depth_gaps", dict(files=files["depth"], tokens=prompt)))
    tasks.append(("depth swapped", "depth_gaps", dict(files=files["depth"][:1], tokens=prompt,
                                                      swap_k=True)))
    return dryrun.run_ranks(rank_tasks, 2, (tasks,), device="cpu", timeout_s=300)


@pytest.fixture(scope="module")
def ranks4(files):
    tasks = [_task(f"chat {k}", "chat", f, files=files, quant_mode=m)
             for k, (f, m) in CASES.items() if k != "w8a8"]
    return dryrun.run_ranks(rank_tasks, 4, (tasks,), device="cpu", timeout_s=300)


@pytest.fixture(scope="module")
def port_tp1(files):
    """The port at tp=1, in this process: the chats of CASES, the stepwise
    end_chat tokens and the pool run."""
    out = {}
    for k, (f, m) in CASES.items():
        eng = MiniGPT4Engine(*files[f], device="cpu", quant_mode=m, **ENGINE)
        out[f"chat {k}"] = _chat(eng)
        eng.close()
    eng = MiniGPT4Engine(*files["f32"], device="cpu", **ENGINE)
    out["stepwise"] = stepwise_tokens(eng)
    eng.close()
    pool = SessionPool(*files["f32"], session_ctx=256, paged_pool_pages=8, device="cpu", **ENGINE)
    out["pool"] = pool_run(pool)
    pool.close()
    return out


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------


def _jax_kind(spec, w) -> str:
    """"col" | "row" | "rep" from a JAX PartitionSpec (tree)."""
    if isinstance(spec, list):
        return "rep"
    axes = tuple(jax.tree_util.tree_leaves(spec, is_leaf=lambda x: isinstance(x, P))[0])
    if "tp" not in axes:
        return "rep"
    dense = isinstance(w, jnp.ndarray)
    if axes[-1] == "tp":
        return "col" if dense else "row"
    return "row" if dense else "col"


def _jax_kinds(jparams, tp: int) -> dict:
    p = jspmd.kshard_llama_params(jspmd.interleave_fused_params(jparams, tp), tp)
    specs = jspmd.llama_param_specs(p, tp)
    kinds = {n: _jax_kind(s["w"], p["layers"][n]["w"])
             for n, s in specs["layers"].items() if isinstance(s, dict)}
    kinds["output"] = _jax_kind(specs["output"]["w"], p["output"]["w"])
    return kinds


PLACEMENT_CASES = [("f32", "auto"), ("q5_0", "repack"), ("q5_0", "qtensor"), ("w8", "w8a8"),
                   ("w8", "repack"), ("km", "repack")]


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name,mode", PLACEMENT_CASES)
def test_placement_decisions_match_jax(files, name, mode, tp):
    """Column, row or whole for every projection and the head: the port's
    decision equals the axes of JAX's llama_param_specs on the same file
    and mode (after its interleave and K-shard re-layout)."""
    llm = files[name][1]
    with JaxReader(llm) as r:
        jparams, _ = jllama.load_params(r, jnp.float32, n_ctx=64, quant_mode=mode)
    with LlamaFileReader(llm) as r:
        tparams, _ = tllama.load_params(r, torch.float32, n_ctx=64, device="cpu", quant_mode=mode)
    want = _jax_kinds(jparams, tp)
    got = spmd.placement(tparams, tp)
    assert got == {k: want[k] for k in got}
    assert set(got) == set(want)


@pytest.mark.parametrize("n,parts,tp", [(96, 3, 2), (96, 3, 4), (256, 2, 2), (768, 3, 4)])
def test_fused_row_interleave_matches_jax(n, parts, tp):
    """fused_row_perm is JAX's _interleave_fused_rows order."""
    w = jnp.asarray(np.arange(n, dtype=np.float32)[None, :])
    want = np.asarray(jspmd._interleave_fused_rows({"w": w}, parts, tp)["w"])[0].astype(np.int64)
    np.testing.assert_array_equal(spmd.fused_row_perm(n, parts, tp), want)
    assert spmd.fused_col_ok(torch.zeros(4, n), parts, tp) == jspmd._fused_col_ok(w, parts, tp)


# ---------------------------------------------------------------------------
# K slices of repacked weights
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("dtype", [DataType.Q4_0, DataType.Q5_K, DataType.Q6_K, DataType.Q8_0])
def test_k_slices_of_a_repacked_weight(dtype, tp):
    """k_slice s of a repacked weight dequantizes to K range s of the whole
    (bit-equal), and the products of the slices on their x slices sum to
    the whole product (f32 sums in another order)."""
    n, k = 24, 1024
    rng = np.random.default_rng(int(dtype) + tp)
    raw = nq.quantize(rng.normal(0, 0.05, n * k).astype(np.float32), dtype)
    w = rp.from_ggml(raw, (n, k), dtype, "cpu")
    x = torch.from_numpy(rng.normal(0, 1, (3, k)).astype(np.float32))
    full = w.dequantize()
    ks = k // tp
    y = 0
    for s in range(tp):
        part = rp.k_slice(w, s, tp)
        assert part.n_in == ks
        torch.testing.assert_close(part.dequantize(), full[:, s * ks:(s + 1) * ks], rtol=0, atol=0)
        y = y + qmatmul_repacked(x[:, s * ks:(s + 1) * ks], part)
    want = qmatmul_repacked(x, w)
    torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))


def test_k_slice_refuses_a_split_group():
    raw = nq.quantize(np.random.default_rng(0).normal(0, 1, 8 * 96).astype(np.float32),
                      DataType.Q4_0)
    w = rp.from_ggml(raw, (8, 96), DataType.Q4_0, "cpu")
    with pytest.raises(ValueError, match="group-aligned"):
        rp.k_slice(w, 0, 2)  # 48 is not a multiple of the group size 32


# ---------------------------------------------------------------------------
# _row_linear over 2 gloo ranks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["k_sharded_split_input", "k_sharded_whole_input",
                                  "whole_split_input", "whole_whole_input"])
def test_row_linear_cases(ranks2, row_inputs, case):
    """A K-sharded weight sums its rank's partial products once; a whole
    weight takes the gathered or whole input and is not summed (no double
    reduce): every case equals x @ w on every rank."""
    want = row_inputs["x"] @ row_inputs["w"]
    for r in ranks2:
        np.testing.assert_allclose(r["row"][case], want, rtol=1e-5, atol=1e-5)


def test_row_linear_i8_global_absmax(ranks2, row_inputs):
    """A K-sharded I8SBQuant quantizes its input slice on the global row
    absmax, so the sum over the ranks equals the unsharded w8a8 matmul
    (JAX's tolerance, tests/test_sharding.py)."""
    codes, scales = i8.requantize_i8sb(torch.from_numpy(row_inputs["w8"]))
    w = i8.I8SBQuant(codes, scales, 512)
    want = i8.qmatmul_i8sb(torch.from_numpy(row_inputs["x8"]), w).numpy()
    for r in ranks2:
        np.testing.assert_allclose(r["row"]["i8_k_sharded"], want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the engine and the pool
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_tokens(files):
    """JAX's MiniGPT4Engine(tp=N) greedy tokens per (case, tp), for the
    f32 and Q5_0 fixtures (the w8a8 case is held to the port at tp=1)."""
    out = {}
    for case, tp in (("f32", 2), ("f32", 4), ("q5_0_repack", 2), ("q5_0_repack", 4)):
        f, mode = CASES[case]
        eng = JaxEngine(*files[f], tp=tp, quant_mode=mode, **ENGINE)
        out[case, tp] = _chat(eng)
        eng.close()
    return out


@pytest.mark.parametrize("tp,case", [(2, "f32"), (2, "q5_0_repack"), (2, "w8a8"), (4, "f32"),
                                     (4, "q5_0_repack")])
def test_engine_tp_greedy_equals_tp1_and_jax(ranks2, ranks4, port_tp1, jax_tokens, tp, case):
    ranks = ranks2 if tp == 2 else ranks4
    got = [r[f"chat {case}"] for r in ranks]
    assert all(g == got[0] for g in got)  # every rank decodes the same tokens
    assert len(got[0]) == 10
    assert got[0] == port_tp1[f"chat {case}"]
    if case != "w8a8":
        assert got[0] == jax_tokens[case, tp]


def test_w8a8_case_really_k_shards_an_i8_weight(files):
    """The w8a8 case's w2 (K = 1024) is K-sharded over 2 ranks, not whole."""
    with LlamaFileReader(files["w8"][1]) as r:
        params, _ = tllama.load_params(r, torch.float32, n_ctx=64, device="cpu",
                                       quant_mode="w8a8")
    assert isinstance(params["layers"]["w2"]["w"], i8.I8SBQuant)
    assert spmd.placement(params, 2)["w2"] == "row"


def test_tp_stepwise_end_chat(ranks2, port_tp1, jax_tokens):
    """Single end_chat steps under tp=2 give tp=1's raw tokens; as in the
    JAX test, their text starts the filtered greedy stream."""
    for r in ranks2:
        assert r["stepwise"] == port_tp1["stepwise"]
    got = "".join(t for t in ranks2[0]["stepwise"] if t)[:4]
    assert "".join(jax_tokens["f32", 2]).startswith(got)


def test_session_pool_under_tp(ranks2, port_tp1):
    """SessionPool(tp=2): an image session's chat, and a paged group of
    three lanes (texts, cursors, token histories) as at tp=1; every page
    returns to the pool."""
    want = port_tp1["pool"]
    for r in ranks2:
        assert r["pool"] == want
    assert want["free_pages"] == 8 and len(want["single"]) >= 1


def test_tp_logit_gap_grows_from_f32_order_at_one_layer(ranks2):
    """Prefill logits of a q5_k decoder (repack) over 2 ranks against the
    whole decoder: at one layer the ranks' wo / w2 sums differ only in f32
    order (1e-7 measured), deeper the differences flip bf16 roundings of
    the matmul inputs and grow; both ranks see the same logits."""
    gaps = ranks2[0]["depth"]
    assert ranks2[1]["depth"] == gaps
    assert gaps[0] <= 1e-6, gaps
    assert gaps[1] > gaps[0], gaps


def test_a_wrong_k_slice_fails_the_one_layer_gap(ranks2):
    """wo / w2 on the other rank's K slice (a fault of the split) moves the
    one-layer logits by a share of their size, far past f32 order."""
    for r in ranks2:
        assert r["depth swapped"][0] >= 1e-2, r["depth swapped"]


def test_mixed_file_refused_under_tp_as_jax_fails(files, ranks2):
    """The 4-layer Q5_K_M file: wv and w2 are per-layer lists of mixed
    formats, which stay whole, while wq and wk split.  The JAX engine fails
    at the first cache write (heads of the whole wv against the rank's
    cache heads); the port refuses at load, naming the projection."""
    with pytest.raises(TypeError, match="dynamic_update_slice"):
        JaxEngine(*files["km"], tp=2, quant_mode="repack", **ENGINE).system_prompt()
    for r in ranks2:
        assert "['wv']" in r["km repack"] and "JAX package" in r["km repack"]


@pytest.mark.parametrize("mode", ["auto", "gq"])
def test_gq_refused_under_tp(files, mode):
    """A decoder that would hold gq weights is refused before it loads (the
    JAX package cannot place a GroupQuant: AttributeError on its shape)."""
    with pytest.raises(ValueError, match="group-quant"):
        MiniGPT4Engine(*files["km"], tp=2, device="cpu", quant_mode=mode)


def test_jax_cannot_place_gq_either(files):
    with pytest.raises(AttributeError, match="shape"):
        JaxEngine(*files["km"], tp=2, quant_mode="gq", **ENGINE)


def test_dp_refused():
    with pytest.raises(ValueError, match="dp=2"):
        MiniGPT4Engine("x", "y", dp=2)


def test_heads_not_divisible_refused(files):
    with pytest.raises(ValueError, match="n_head=4"):
        MiniGPT4Engine(*files["f32"], tp=3, device="cpu")


def test_dryrun_writer_is_the_jax_fixture(files, tmp_path):
    """dryrun.write_models at the fixtures' geometry writes the bytes of the
    JAX package's tests/fixtures.py pair (seed 42), f32 and Q5_0."""
    from pathlib import Path

    for name, quant in (("f32", None), ("q5_0", DataType.Q5_0)):
        got = dryrun.write_models(tmp_path / name, quant=quant, d=32, n_mult=128)
        for g, w in zip(got, files[name]):
            assert Path(g).read_bytes() == Path(w).read_bytes()
