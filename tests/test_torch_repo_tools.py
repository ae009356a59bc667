"""The port's copies of the repo-level tools (``minigpt4_tpu_torch/tools/``:
``make_synth_13b``, ``coldstart_probe``, ``profile_prefill_engine``,
``probe_teacher_locality``, ``probe_paged_capacity``,
``probe_paged_spec_cost``) against the JAX package's scripts in ``tools/``,
on the CPU.

The JAX scripts are loaded by path and run as their ``main()`` runs them,
at the ``"tiny"`` geometry that both ``benchmark.GEOMETRIES`` hold; where a
script hard-codes ``13B`` that entry is the tiny one for the test
(monkeypatched, as ``tests/test_torch_bench.py`` patches its smoke
geometry), and the spec-cost probe's lane and pass counts are cut on both
sides.  The synthetic weights come from the same NumPy draws on both sides
(``quant_mode="auto"``: ggml bytes from ``default_rng(0)``).  The JAX
scripts compute in bf16 where the port computes in the engine's f32; at
tiny bf16 flips one position of 115 in the locality probe (0.9826 against
0.9913 at windows 1, 2 and 8), so the JAX scripts run here with f32
activations, where every agreement and acceptance is equal.

Times on the CPU measure nothing of the card: the timing tools are held to
JAX's keys, their counts and sizes, and finite positive numbers.
"""

import contextlib
import hashlib
import importlib.util
import io
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fixtures import build_tiny_models
from minigpt4_tpu import benchmark as JB
from minigpt4_tpu_torch.ops import qmm_prefill
from minigpt4_tpu_torch.tools import (coldstart_probe, make_synth_13b, probe_paged_capacity,
                                      probe_paged_spec_cost, probe_teacher_locality,
                                      profile_prefill_engine)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TOOLS = ("make_synth_13b", "coldstart_probe", "profile_prefill_engine", "probe_teacher_locality",
         "probe_paged_capacity", "probe_paged_spec_cost")
# make_synth_13b's geometry cut to test size (q5_k rows of 256 and 768; the
# vocabulary keeps its 262 fixed pieces)
SYNTH_TINY = dict(VIT_D=32, VIT_DEPTH=2, VIT_MLP=64, QF_HIDDEN=32, QF_LAYERS=2, QF_HEADS=2,
                  QF_QUERIES=4, LLM_D=256, LLM_HEADS=2, LLM_LAYERS=2, LLM_FF=768, VOCAB=300)
# the spec-cost probe's constants at test size, on both sides
SPEC_COST_TINY = dict(LANES=2, K=4, REPS=1, CHUNK=4)
LANES = (2, 3)
WINDOWS = (1, 8)


def _jax_tool(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_tools_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _f32(synth):
    """JAX's synth_llama_params with the engine's f32 activations (the
    scripts pass bf16 or leave JAX's bf16 default)."""
    def f(cfg, qtype, rng, dtype=None, quant_mode="auto"):
        return synth(cfg, qtype, rng, jnp.float32, quant_mode=quant_mode)
    return f


def _json_lines(text: str) -> list[dict]:
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


def run_jax(name: str, argv: list, consts: dict | None = None) -> list[dict]:
    """The JAX script's ``main()`` at the tiny geometry: its JSON lines."""
    mod = _jax_tool(name)
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", [name, *argv])
        mp.setitem(JB.GEOMETRIES, "13B", JB.GEOMETRIES["tiny"])
        mp.setattr(JB, "synth_llama_params", _f32(JB.synth_llama_params))
        for k, v in (consts or {}).items():
            mp.setattr(mod, k, v)
        with contextlib.redirect_stdout(out):
            mod.main()
    return _json_lines(out.getvalue())


def run_port(mod, argv: list, consts: dict | None = None) -> tuple[list[dict], str]:
    """The port's ``main(argv)``: its JSON lines and its whole stdout."""
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        for k, v in (consts or {}).items():
            mp.setattr(mod, k, v)
        with contextlib.redirect_stdout(out):
            assert mod.main(argv) == 0
    return _json_lines(out.getvalue()), out.getvalue()


def _finite_positive(d: dict, skip=("device", "captured")) -> dict:
    return {k: v for k, v in d.items()
            if k not in skip and not (isinstance(v, (int, float)) and math.isfinite(v) and v > 0)}


# ---------------------------------------------------------------------------
# make_synth_13b: the same bytes from the same seed
# ---------------------------------------------------------------------------

def _sha(path: Path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


@pytest.mark.parametrize("flags", [[], ["--vit-f32"]], ids=["f16", "f32"])
def test_make_synth_13b_files_equal_jax(tmp_path, monkeypatch, flags):
    jax_mod = _jax_tool("make_synth_13b")
    for k, v in SYNTH_TINY.items():
        monkeypatch.setattr(jax_mod, k, v)
        monkeypatch.setattr(make_synth_13b, k, v)
    monkeypatch.setattr(sys, "argv", ["make_synth_13b", "--out", str(tmp_path / "jax"), *flags])
    jax_mod.main()
    make_synth_13b.main(["--out", str(tmp_path / "port"), *flags])
    for name in ("minigpt4-13B.bin", "vicuna-13b-q5_k.bin"):
        assert _sha(tmp_path / "port" / name) == _sha(tmp_path / "jax" / name), name


def test_make_synth_13b_skip_flags_write_one_file(tmp_path, monkeypatch):
    for k, v in SYNTH_TINY.items():
        monkeypatch.setattr(make_synth_13b, k, v)
    make_synth_13b.main(["--out", str(tmp_path / "a"), "--skip-llm"])
    make_synth_13b.main(["--out", str(tmp_path / "b"), "--skip-container"])
    assert [p.name for p in (tmp_path / "a").iterdir()] == ["minigpt4-13B.bin"]
    assert [p.name for p in (tmp_path / "b").iterdir()] == ["vicuna-13b-q5_k.bin"]


# ---------------------------------------------------------------------------
# coldstart_probe: the deploy path on the tiny fixture pair
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def coldstart(tmp_path_factory):
    model, llm = build_tiny_models(tmp_path_factory.mktemp("coldstart"))
    argv = ["-m", str(model), "-l", str(llm), "--image-size", "28", "--n-decode", "4"]
    jax_line = run_jax("coldstart_probe", argv)[-1]
    lines, text = run_port(coldstart_probe, argv + ["--device", "cpu"])
    return jax_line, lines[-1], text


def test_coldstart_probe_has_jax_keys_and_device(coldstart):
    jax_line, port_line, _ = coldstart
    assert set(port_line) == set(jax_line) | {"device"}
    assert port_line["device"] == "cpu"
    assert port_line["n_decode"] == jax_line["n_decode"] == 4


def test_coldstart_probe_numbers_finite_and_positive(coldstart):
    _, port_line, _ = coldstart
    assert not _finite_positive(port_line)


def test_coldstart_probe_prints_launch_counts_before_the_result(coldstart):
    _, _, text = coldstart
    lines = text.strip().splitlines()
    assert lines[-2].startswith("[launches] ")
    counts = json.loads(lines[-2][len("[launches] "):])
    # named as chip_smoke.py names them; on CPU tensors no kernel launches
    assert {"gq_decode", "gq_prefill", "flash_decode", "gq_prefill[p5]",
            "flash_decode[stats]"} <= set(counts)
    assert not any(counts.values())


# ---------------------------------------------------------------------------
# probe_paged_capacity: pool sizes and acceptance equal to JAX's
# ---------------------------------------------------------------------------

CAPACITY_ARGV = ["--model", "tiny", "--lanes", ",".join(map(str, LANES)), "--quant-mode", "auto",
                 "--chunk", "4", "--steps", "1"]


@pytest.fixture(scope="module")
def capacity():
    out = {}
    for arm, extra in (("plain", []), ("spec", ["--spec-k", "8"])):
        jax_lines = run_jax("probe_paged_capacity", CAPACITY_ARGV + extra)
        port_lines, _ = run_port(probe_paged_capacity, CAPACITY_ARGV + extra + ["--device", "cpu"])
        out[arm] = (jax_lines, port_lines)
    return out


@pytest.mark.parametrize("arm", ["plain", "spec"])
def test_paged_capacity_one_line_per_lane_count_with_jax_keys(capacity, arm):
    jax_lines, port_lines = capacity[arm]
    assert [line["lanes"] for line in port_lines] == [line["lanes"] for line in jax_lines] == list(
        LANES)
    for j, p in zip(jax_lines, port_lines):
        assert "error" not in p and "error" not in j
        assert set(p) == set(j) | {"device", "captured"}
        assert p["captured"] is False  # eager on the CPU
        assert not _finite_positive(p)


CAPACITY_KEYS = [("plain", "pool_mb"), ("plain", "dense_reservation_mb"), ("spec", "pool_mb"),
                 ("spec", "dense_reservation_mb"), ("spec", "accept_per_pass")]


@pytest.mark.parametrize("arm,key", CAPACITY_KEYS)
@pytest.mark.parametrize("lane_i", range(len(LANES)))
def test_paged_capacity_sizes_and_acceptance_equal_jax(capacity, arm, key, lane_i):
    jax_line, port_line = capacity[arm][0][lane_i], capacity[arm][1][lane_i]
    digits = 2 if key == "accept_per_pass" else 1  # the JAX script's rounding
    assert round(port_line[key], digits) == jax_line[key]


# ---------------------------------------------------------------------------
# probe_teacher_locality: the agreement per window equal to JAX's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def locality():
    argv = ["--model", "tiny", "--quant-mode", "auto", "--windows", ",".join(map(str, WINDOWS))]
    jax_line = run_jax("probe_teacher_locality", argv)[-1]
    lines, text = run_port(probe_teacher_locality, argv + ["--device", "cpu"])
    return jax_line, lines[-1], text


@pytest.mark.parametrize("w", WINDOWS)
def test_teacher_locality_agreement_equals_jax(locality, w):
    jax_line, port_line, text = locality
    assert round(port_line[f"w{w}"], 4) == jax_line[f"w{w}"]
    assert f"[locality] window {w}: agreement" in text


def test_teacher_locality_has_jax_keys(locality):
    jax_line, port_line, _ = locality
    assert set(port_line) == set(jax_line) | {"device"}
    assert port_line["positions"] == jax_line["positions"] == 115
    assert port_line["model"] == "tiny"


# ---------------------------------------------------------------------------
# probe_paged_spec_cost and profile_prefill_engine: JAX's keys
# ---------------------------------------------------------------------------

def test_paged_spec_cost_has_jax_keys():
    jax_line = run_jax("probe_paged_spec_cost", [], SPEC_COST_TINY)[-1]
    lines, _ = run_port(probe_paged_spec_cost, ["--model", "tiny", "--device", "cpu"],
                        SPEC_COST_TINY)
    port_line = lines[-1]
    assert set(port_line) == set(jax_line) | {"paged_plain_eager_ms", "paged_spec_cross_eager_ms",
                                              "paged_spec_aligned_eager_ms", "captured", "device"}
    assert port_line["captured"] == []  # eager on the CPU
    assert not _finite_positive(port_line)


@pytest.fixture(scope="module")
def prefill_profile():
    mod = _jax_tool("profile_prefill_engine")
    chain = mod.chain
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(JB.GEOMETRIES, "13B", JB.GEOMETRIES["tiny"])
        # JAX's chains of 4 and 12 calls cut to 1: the test reads keys, not times
        mp.setattr(mod, "chain", lambda fwd, p, c, e, n: chain(fwd, p, c, e, 1))
        with contextlib.redirect_stdout(out):
            mod.main()
    jax_lines = _json_lines(out.getvalue())
    tiles = qmm_prefill.TOKEN_TILES
    port_lines, _ = run_port(profile_prefill_engine, ["--model", "tiny", "--device", "cpu",
                                                      "--chains", "1,2", "--reps", "1"])
    return jax_lines, port_lines, tiles


def test_profile_prefill_engine_has_jax_keys(prefill_profile):
    jax_lines, port_lines, _ = prefill_profile
    assert port_lines[0] == {"built": True, "backend": "cpu"}
    assert set(jax_lines[0]) == set(port_lines[0])
    for line in port_lines[1:]:
        assert set(line) == set(jax_lines[1]) | {"captured", "device"}


def test_profile_prefill_engine_arms_cover_tiles_and_spans(prefill_profile):
    _, port_lines, tiles = prefill_profile
    arms = [(line["tn"], line["attn_len"]) for line in port_lines[1:]]
    assert arms == [(tn, al) for tn in tiles for al in (None, 512)]


def test_profile_prefill_engine_restores_the_token_tile(prefill_profile, monkeypatch):
    _, _, tiles = prefill_profile
    assert qmm_prefill.TOKEN_TILES == tiles
    seen = []

    def failing_prefill(self, *a, **k):
        seen.append(qmm_prefill.TOKEN_TILES)
        raise RuntimeError("planted")

    from minigpt4_tpu_torch import benchmark as TB
    from minigpt4_tpu_torch.engine import graphs
    from minigpt4_tpu_torch.formats import DataType

    monkeypatch.setattr(graphs.StepGraphs, "prefill", failing_prefill)
    cfg = TB.GEOMETRIES["tiny"]
    params = TB.synth_llama_params(cfg, DataType.Q5_K, np.random.default_rng(0), quant_mode="gq",
                                   device="cpu")
    args = profile_prefill_engine.parse_args(["--device", "cpu"])
    with pytest.raises(RuntimeError, match="planted"):
        profile_prefill_engine.run(params, cfg, args)
    assert seen == [tiles[:1]]  # the first arm ran on the first tile alone
    assert qmm_prefill.TOKEN_TILES == tiles


# ---------------------------------------------------------------------------
# the modules run where JAX, the JAX package and tools/ cannot be imported
# ---------------------------------------------------------------------------

_HELP_NO_JAX = """
import contextlib, io, json, runpy, sys
sys.modules["jax"] = None
sys.modules["minigpt4_tpu"] = None
sys.modules["tools"] = None  # the repo-level scripts
sys.path.insert(0, sys.argv[1])
codes = {}
for name in sys.argv[2:]:
    sys.argv = [name, "--help"]
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            runpy.run_module("minigpt4_tpu_torch.tools." + name, run_name="__main__")
    except SystemExit as e:
        codes[name] = e.code
print(json.dumps({"codes": codes, "jax_loaded": sys.modules["jax"] is not None,
                  "jax_package_loaded": sys.modules["minigpt4_tpu"] is not None}))
"""


def test_tools_run_help_without_jax():
    proc = subprocess.run([sys.executable, "-c", _HELP_NO_JAX, str(ROOT), *TOOLS],
                          capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"codes": {name: 0 for name in TOOLS}, "jax_loaded": False,
                   "jax_package_loaded": False}


@pytest.mark.parametrize("name", TOOLS)
def test_tool_sources_import_no_jax_and_no_repo_tools(name):
    text = (ROOT / "minigpt4_tpu_torch" / "tools" / f"{name}.py").read_text()
    for line in text.splitlines():
        s = line.strip()
        assert not s.startswith(("import jax", "from jax", "import minigpt4_tpu ",
                                 "from minigpt4_tpu ", "from minigpt4_tpu.", "import tools",
                                 "from tools")), s
