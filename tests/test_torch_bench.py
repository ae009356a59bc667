"""The port's benchmark timing half (``minigpt4_tpu_torch/benchmark.py``:
``bench_decode``, ``bench_encode``, ``chip_state_probe``, ``main``) and the
kernel gate's floors (``kernel_gate.run_floors``) against the JAX package, on
the CPU.

Times on the CPU measure nothing of the card; these tests hold what does not
depend on the clock: the result keys, the counts and sizes, and the greedy
speculative acceptances, which follow from the synthetic model alone.  At the
JAX test's smoke geometry (``tests/test_bench_helpers.py``) the port draws the
same ggml bytes, embedding and prompts from the same seed as the JAX
package, so its greedy streams, and with them the n-gram acceptances of the
single-stream, batched and paged speculation, equal JAX's (6.333, 4.583,
1.875; 1.041 on the prose).  The sampled acceptance draws from other
generators and is not compared.
"""

import io
import json
import math
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from minigpt4_tpu import benchmark as JB
from minigpt4_tpu.formats.dtypes import DataType as JDataType
from minigpt4_tpu.models import eva_vit as jvit
from minigpt4_tpu.models import minigpt4 as jvision
from minigpt4_tpu.models import qformer as jqf
from minigpt4_tpu.models.llama import LlamaConfig as JLlamaConfig
from minigpt4_tpu_torch import benchmark as TB
from minigpt4_tpu_torch import kernel_gate as kg
from minigpt4_tpu_torch.formats import DataType
from minigpt4_tpu_torch.models import eva_vit as tvit
from minigpt4_tpu_torch.models import minigpt4 as tvision
from minigpt4_tpu_torch.models import qformer as tqf
from minigpt4_tpu_torch.models.llama import LlamaConfig

torch.set_num_threads(1)

# the JAX test's smoke geometry: every section of the harness in seconds
SMOKE = dict(n_vocab=512, n_embd=256, n_head=4, n_layer=2, n_rot=64, n_ff=512, n_ctx=128)
RUN = dict(n_decode=8, prefill_len=8, batch=2)
# the counts and sizes a run fixes, whatever the clock says
EQUAL_KEYS = ("spec_k", "decode_batch", "paged_lanes", "prefill_len", "paged_pool_mb",
              "dense_group_mb")
GREEDY_ACCEPTANCE = ("spec_accept_per_pass", "spec_accept_per_pass_batched",
                     "spec_accept_per_pass_paged", "spec_accept_realistic")


def _smoke(monkeypatch) -> None:
    monkeypatch.setitem(JB.GEOMETRIES, "emit_smoke", JLlamaConfig(**SMOKE))
    monkeypatch.setitem(TB.GEOMETRIES, "emit_smoke", LlamaConfig(**SMOKE))


@pytest.fixture(scope="module")
def runs():
    """(JAX result, port result) of one all-sections bench_decode at the
    smoke geometry, Q5_K weights, f32 weights and caches, two lanes."""
    with pytest.MonkeyPatch.context() as mp:
        _smoke(mp)
        jax_out = JB.bench_decode("emit_smoke", JDataType.Q5_K, dtype=jnp.float32,
                                  cache_dtype=jnp.float32, **RUN)
        port_out = TB.bench_decode("emit_smoke", DataType.Q5_K, dtype=torch.float32,
                                   cache_dtype=torch.float32, device="cpu", **RUN)
    return jax_out, port_out


def _rates(out: dict) -> dict:
    return {k: v for k, v in out.items()
            if ("tok_s" in k or k.endswith(("_ms", "imgs_s"))) and not isinstance(v, str)}


def test_bench_decode_has_jax_keys(runs):
    jax_out, port_out = runs
    # every port result also names its device, which the JAX package's lacks
    assert set(port_out) - {"device"} == set(jax_out)
    assert port_out["device"] == "cpu"
    assert not [k for k in port_out if k.endswith("_error")]
    assert "skipped_sections" not in port_out


@pytest.mark.parametrize("key", EQUAL_KEYS)
def test_bench_decode_counts_and_sizes_equal_jax(runs, key):
    jax_out, port_out = runs
    assert port_out[key] == jax_out[key]


@pytest.mark.parametrize("key", GREEDY_ACCEPTANCE)
def test_greedy_acceptance_equals_jax(runs, key):
    jax_out, port_out = runs
    assert port_out[key] == pytest.approx(jax_out[key], rel=1e-12, abs=0)


def test_bench_decode_rates_finite_and_positive(runs):
    _, port_out = runs
    rates = _rates(port_out)
    assert {"decode_tok_s", "decode_stepwise_tok_s", "ttft_first_ms", "spec_pass_ms",
            "spec_stoch_pass_ms", "decode_tok_s_batched_aggregate",
            "decode_tok_s_batched_paged_aggregate", "decode_tok_s_paged_spec"} <= set(rates)
    bad = {k: v for k, v in rates.items() if not (math.isfinite(v) and v > 0)}
    assert not bad


def test_bench_decode_emits_after_core_and_skips_as_jax(monkeypatch):
    """The twin of the JAX package's deadline test: with an exhausted
    deadline the core block runs and emits, and every rider is skipped and
    named, as JAX names them."""
    _smoke(monkeypatch)
    jax_snaps, port_snaps = [], []
    jax_out = JB.bench_decode("emit_smoke", JDataType.Q5_K, n_decode=8, prefill_len=8,
                              dtype=jnp.float32, cache_dtype=jnp.float32,
                              emit=jax_snaps.append, deadline=time.time())
    port_out = TB.bench_decode("emit_smoke", DataType.Q5_K, n_decode=8, prefill_len=8,
                               dtype=torch.float32, cache_dtype=torch.float32,
                               emit=port_snaps.append, deadline=time.time(), device="cpu")
    assert port_snaps and "decode_tok_s" in port_snaps[0]
    assert port_out["decode_tok_s"] > 0 and port_out["decode_stepwise_tok_s"] > 0
    assert port_out["skipped_sections"] == jax_out["skipped_sections"]
    assert "spec" in port_out["skipped_sections"].split(",")
    assert "decode_tok_s_spec" not in port_out
    assert "decode_tok_s_batched_aggregate" not in port_out


def test_bench_decode_quick_returns_the_core_block(monkeypatch):
    _smoke(monkeypatch)
    out = TB.bench_decode("emit_smoke", DataType.Q5_K, n_decode=8, prefill_len=8,
                          dtype=torch.float32, cache_dtype=torch.float32, quick=True,
                          device="cpu")
    assert "decode_tok_s" in out and "spec_pass_ms" not in out and "skipped_sections" not in out


def test_bench_encode_has_jax_keys(monkeypatch):
    """bench_encode with vit_g_config cut to a tiny ViT in both packages."""
    vit = dict(image_size=224, patch_size=14, embed_dim=32, depth=1, head_dim=16, mlp_dim=64)
    qf = dict(hidden_size=32, n_heads=2, n_layers=2, encoder_width=32, query_length=4,
              intermediate_size=64)
    monkeypatch.setattr(JB, "vit_g_config", lambda e: jvision.VisionConfig(
        vit=jvit.ViTConfig(**vit), qformer=jqf.QFormerConfig(**qf), llama_embed_dim=e))
    monkeypatch.setattr(TB, "vit_g_config", lambda e: tvision.VisionConfig(
        vit=tvit.ViTConfig(**vit), qformer=tqf.QFormerConfig(**qf), llama_embed_dim=e))
    jax_out = JB.bench_encode(64, iters=2)
    port_out = TB.bench_encode(64, iters=2, device="cpu")
    assert set(port_out) - {"device"} == set(jax_out)
    assert port_out["device"] == "cpu"
    assert port_out["encode_batch"] == jax_out["encode_batch"] == 8
    assert all(math.isfinite(v) and v > 0 for v in _rates(port_out).values())


def test_chip_state_probe_on_cpu():
    gbs = TB.chip_state_probe(n=256, device="cpu")
    assert math.isfinite(gbs) and gbs > 0


def test_benchmark_cli_refuses_without_a_card(capsys):
    assert TB.main(["--model", "tiny", "--quick"]) == 1
    assert "never falls back to the CPU" in capsys.readouterr().err


def _perf_pair(ratios: dict):
    """An injected perf_pair giving each floor shape (1 ms, ratio ms)."""
    by_shape = {shape: ratios[name] for name, shape in kg.FLOOR_SHAPES.items()}
    return lambda kind, k, n: (1.0, by_shape[(kind, k, n)])


RECORDED = {"q5k_w2": 0.9, "gq_w2": 1.2, "i8_w2": 1.5, "gq_wo": 1.1}


def test_floors_record_writes_the_ports_file(tmp_path):
    path = tmp_path / "kernel_floors.json"
    report = []
    assert kg.run_floors("record", device="cpu", perf_pair=_perf_pair(RECORDED), path=path,
                         report=report, out=None)
    data = json.loads(path.read_text())
    assert data["ratios"] == RECORDED
    assert data["margin"] == kg.FLOOR_MARGIN == 0.70
    assert data["card"] == "cpu"
    assert [r["name"] for r in report] == list(kg.FLOOR_SHAPES)


@pytest.mark.parametrize("share,ok", [(1.0, True), (0.75, True), (0.65, False)])
def test_floors_check_against_the_margin(tmp_path, share, ok):
    path = tmp_path / "kernel_floors.json"
    kg.run_floors("record", device="cpu", perf_pair=_perf_pair(RECORDED), path=path, out=None)
    now = dict(RECORDED, gq_wo=RECORDED["gq_wo"] * share)
    out = io.StringIO()
    assert kg.run_floors("check", device="cpu", perf_pair=_perf_pair(now), path=path,
                         out=out) is ok
    assert ("FAIL gq_wo" in out.getvalue()) is not ok


def test_floors_fail_a_shape_that_raises(tmp_path):
    def pair(kind, k, n):
        if kind == "i8":
            raise RuntimeError("launch refused")
        return 1.0, 1.0

    out = io.StringIO()
    assert not kg.run_floors("check", device="cpu", perf_pair=pair,
                             path=tmp_path / "none.json", out=out)
    assert "FAIL i8_w2: RuntimeError: launch refused" in out.getvalue()


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_floors_without_a_card_raise(device):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the floors would run")
    with pytest.raises(RuntimeError, match="NVIDIA GPU"):
        kg.run_floors("check", device=device)


def test_kernel_gate_floors_cli_refuses_without_a_card():
    assert kg.main(["--floors", "check", "--floors-only"]) == 1


def test_recorded_floors_name_the_card():
    """The committed floors were recorded on a card, which they name."""
    data = json.loads(kg.FLOORS_PATH.read_text())
    assert set(data["ratios"]) == set(kg.FLOOR_SHAPES)
    assert data["card"] != "cpu" and "W" in data["card"]
    assert all(r > 0 for r in data["ratios"].values())
