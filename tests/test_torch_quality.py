"""Port parity for the quality harness and smooth-quant (``quality.py``), the
port on the CPU against the JAX package at the ``tiny`` geometry.

Tolerances: the synthetic files are byte-equal.  Activation statistics and
smooth scales are maxima of f32 activations that both sides compute with
f32 matmuls summed in different orders: 1e-5 relative (measured 3.2e-6 at
most).  Teacher-forced w8a8 logits with the same scales: 1e-5 of
max|logit| (measured 2.2e-7 without and with smooth scales): every weight
code is bit-equal, and f32 summation order rarely moves an activation
across a rounding edge of its i8 grid.  The evaluate_paths metrics with
the same scales, equal top-1 and, for the q5k, w8a8 and f8_cache rows,
1e-5 on mean KL, 1e-6 relative on NLL and 1e-3 percentage points of
perplexity (measured 7.6e-7, 1.1e-7 and 2.1e-4 at most).  For
w8a8_smooth: 1e-3 on mean KL, 1e-3 relative on NLL and 1 percentage point
of perplexity (measured 2.5e-4, 5.8e-4 and 0.63): one activation of
position 29 lands on the other side of an i8 rounding edge with f32
summation order, and positions 29-31 of the 32 move by 1e-2 of
max|logit| while the others agree to 1e-6.  Scales that
differ in the last bits (each package calibrating its own) move weight
codes across rounding edges: 1.6e-2 of max|logit| within the JAX package
alone, 1.1e-3 on the w8a8_smooth mean KL here (ROADMAP Queue 3), so that
row is compared on the JAX package's scales.
"""

import filecmp

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minigpt4_tpu import quality as jq
from minigpt4_tpu.formats.ggml_llama import LlamaFileReader as JReader
from minigpt4_tpu.models import llama as jllama
from minigpt4_tpu.ops import group_i8 as jgq
from minigpt4_tpu_torch import quality as tq
from minigpt4_tpu_torch.formats import LlamaFileReader
from minigpt4_tpu_torch.models import llama as tllama

GEOM = tq.GEOMETRIES["tiny"]


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    work = tmp_path_factory.mktemp("quality")
    j = (work / "j_f32.bin", work / "j_q5k.bin")
    t = (work / "t_f32.bin", work / "t_q5k.bin")
    jdims = jq.write_synth_llama(*j, jq.GEOMETRIES["tiny"], seed=3)
    tdims = tq.write_synth_llama(*t, GEOM, seed=3)
    return j, t, jdims, tdims


def test_synth_files_byte_equal_to_jax(pairs):
    j, t, jdims, tdims = pairs
    assert np.array_equal(jdims, tdims)
    assert tq.GEOMETRIES == {k: tq.Geometry(**vars(v)) for k, v in jq.GEOMETRIES.items()}
    for a, b in zip(j, t):
        assert filecmp.cmp(a, b, shallow=False), (a, b)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-30)


CALIB = [np.arange(3, 27, dtype=np.int32), np.arange(100, 116, dtype=np.int32)]


def test_activation_stats_match_jax(pairs):
    (jf, _), (tf, _), _, _ = pairs
    with JReader(jf) as r:
        jp, jcfg = jllama.load_params(r, jnp.float32, n_ctx=32)
    with LlamaFileReader(tf) as r:
        tp, tcfg = tllama.load_params(r, torch.float32, n_ctx=32, device="cpu")
    want = jq.collect_activation_stats(jp, jcfg, CALIB)
    got = tq.collect_activation_stats(tp, tcfg, CALIB)
    assert set(got) == set(want) == {"attn", "wo", "ffn", "w2", "head"}
    for site in want:
        assert got[site].shape == want[site].shape, site
        assert _rel(got[site], want[site]) <= 1e-5, site


@pytest.fixture(scope="module")
def scales(pairs):
    (_, jq_p), (_, tq_p), _, _ = pairs
    return (jq.compute_smooth_scales(jq_p, CALIB, n_ctx=32),
            tq.compute_smooth_scales(tq_p, CALIB, n_ctx=32, device="cpu"))


def test_smooth_scales_match_jax(pairs, scales):
    (_, jq_p), _, _, _ = pairs
    want, got = scales
    assert set(got) == set(want) == {"attn", "ffn", "w2", "head"}
    for site in want:
        assert got[site].dtype == np.float32 and _rel(got[site], want[site]) <= 1e-5, site
    with LlamaFileReader(jq_p) as r:
        cfg = tllama.LlamaConfig.from_hparams(r.hparams)
        wmax = tq.weight_col_absmax(r, cfg, "cpu")
    with JReader(jq_p) as r:
        jwmax = jq.weight_col_absmax(r, cfg)
    for site in jwmax:
        assert np.array_equal(wmax[site], jwmax[site]), site


def test_scales_files_load_in_either_package(tmp_path, scales):
    want, got = scales
    tq.save_smooth_scales(tmp_path / "t.npz", got)
    jq.save_smooth_scales(tmp_path / "j.npz", want)
    for site, v in jq.load_smooth_scales(tmp_path / "t.npz").items():
        assert np.array_equal(v, got[site])
    for site, v in tq.load_smooth_scales(tmp_path / "j.npz").items():
        assert np.array_equal(v, want[site])


@pytest.mark.parametrize("smooth", [False, True], ids=["plain", "smooth"])
def test_w8a8_teacher_forced_logits_match_jax(pairs, scales, smooth):
    (_, jq_p), _, _, _ = pairs
    sm = scales[0] if smooth else None
    tokens = np.random.default_rng(2).integers(3, GEOM.n_vocab, 48).astype(np.int32)
    with JReader(jq_p) as r:
        jp, jcfg = jllama.load_params(r, jnp.float32, n_ctx=48, quant_mode="w8a8", smooth=sm)
    with LlamaFileReader(jq_p) as r:
        tp, tcfg = tllama.load_params(r, torch.float32, n_ctx=48, device="cpu",
                                      quant_mode="w8a8", smooth=sm)
    want = jq.teacher_forced_logits(jp, jcfg, tokens)
    got = tq.teacher_forced_logits(tp, tcfg, tokens)
    assert got.shape == want.shape == (48, GEOM.n_vocab)
    assert _rel(got, want) <= 1e-5


def test_smooth_fold_is_a_no_op_on_dense_weights(pairs, scales):
    (_, _), (tf, _), _, _ = pairs
    tokens = np.random.default_rng(0).integers(3, GEOM.n_vocab, 24).astype(np.int32)
    with LlamaFileReader(tf) as r:
        plain, cfg = tllama.load_params(r, torch.float32, n_ctx=32, device="cpu")
        folded, _ = tllama.load_params(r, torch.float32, n_ctx=32, device="cpu",
                                       quant_mode="w8a8", smooth=scales[1])
        with pytest.raises(ValueError, match="w8a8"):
            tllama.load_params(r, torch.float32, n_ctx=32, device="cpu",
                               smooth={"head": np.ones(GEOM.n_embd, np.float32)})
    np.testing.assert_allclose(tq.teacher_forced_logits(plain, cfg, tokens),
                               tq.teacher_forced_logits(folded, cfg, tokens),
                               rtol=2e-3, atol=2e-3)


ROWS = ("q5k", "w8a8", "w8a8_smooth", "f8_cache")


def test_evaluate_paths_match_jax(pairs, monkeypatch):
    (jf, jq_p), _, _, _ = pairs
    kw = dict(seq_len=32, calib_len=24, n_calib=1, paths=ROWS, quant_mode_exact="qtensor")
    art: dict = {}
    want = jq.evaluate_paths(jf, jq_p, artifacts=art, **kw)
    # the w8a8_smooth row on the JAX package's scales (see the docstring);
    # the port's own calibration is held to them in test_smooth_scales_match_jax
    monkeypatch.setattr(tq, "compute_smooth_scales", lambda *a, **k: art["smooth_scales"])
    got = tq.evaluate_paths(jf, jq_p, device="cpu", **kw)
    assert list(got) == list(want) == list(ROWS)
    for row in ROWS:
        kl, nll, ppl = (1e-3, 1e-3, 1.0) if row == "w8a8_smooth" else (1e-5, 1e-6, 1e-3)
        assert abs(got[row]["kl_mean"] - want[row]["kl_mean"]) <= kl, row
        assert abs(got[row]["nll"] - want[row]["nll"]) <= nll * want[row]["nll"], row
        assert abs(got[row]["d_ppl_pct"] - want[row]["d_ppl_pct"]) <= ppl, row
        assert got[row]["top1"] == want[row]["top1"], row


def test_main_prints_five_rows_and_gates(tmp_path, capsys):
    import json

    res = tq.main(["--geometry", "tiny", "--device", "cpu", "--seq-len", "32",
                   "--calib-len", "16", "--workdir", str(tmp_path),
                   "--save-scales", str(tmp_path / "s.npz")])
    # the gq row records its code storage as the JAX row does, under the
    # same environment (MINIGPT4_TPU_GQ_PACK, else packed)
    assert list(res) == list(tq.PATHS) and res["gq"]["packed"] is jgq.pack_enabled()
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(last["quality"]) == set(tq.PATHS)
    assert all(np.isfinite(v["kl_mean"]) for v in last["quality"].values())
    assert isinstance(last["w8a8_smooth_ok"], bool) and isinstance(last["gq_ok"], bool)
    assert set(tq.load_smooth_scales(tmp_path / "s.npz")) == {"attn", "ffn", "w2", "head"}
