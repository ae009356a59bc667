"""The port's kernel gate (``minigpt4_tpu_torch/kernel_gate.py``) on the CPU:
its sweep against the JAX gate's shapes and quant types, its routing of
each case to an entry, and its harness with injected launches at small
shapes (the plain versions pass; a launch 1 % off or one that raises fails
its cases by name); the injected launch is the wrappers' own, which run
their plain versions on CPU tensors.  The CLI without a card exits 1.  On the card,
``tests/test_torch_cuda.py`` runs the fast sweep through the kernels.
"""

import io
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from minigpt4_tpu import kernel_gate as jgate
from minigpt4_tpu_torch import kernel_gate as kg
from minigpt4_tpu_torch.formats import DataType

# one intra-op thread: the suite runs several pytest-xdist workers on the same cores, where
# torch's OpenMP pools spin against each other and run ~17x slower
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
SMALL = {"t wo": (48, 256), "t w2": (32, 512)}  # (N, K): K of one and two q-k superblocks


def test_sweep_covers_the_jax_gate():
    """Every (K, N) of the JAX gate's 7B / 13B shapes appears with its K and
    an N it divides (the port fuses wq|wk|wv and w1|w3), in every JAX quant
    type, on both sides of the decode / prefill switch, stacked and flat."""
    cases = kg.gate_cases()
    jax_qtypes = {"q4_k", "q5_k", "q6_k", "q4_0", "q8_0"}
    assert jax_qtypes <= {c.qtype.name.lower() for c in cases if c.qtype is not None}
    for k, n in [*jgate.SHAPES_13B.values(), *jgate.SHAPES_7B.values()]:
        for qt in jax_qtypes:
            hit = [c for c in cases if c.k == k and c.n % n == 0 and c.qtype is not None
                   and c.qtype.name.lower() == qt]
            assert {c.m for c in hit} == set(kg.MS) and {c.stacked for c in hit} == {True, False}
            assert {c.form.split()[0] for c in hit} == {"gq", "rq"}, (k, n, qt)
    assert {(c.k, c.n) for c in cases if c.form == "i8"} == {
        (k, n) for n, k in [*kg.SHAPES_13B.values(), *kg.SHAPES_7B.values()]}
    fast = kg.gate_cases(fast=True)
    assert {(c.k, c.n) for c in fast} == {(k, n) for n, k in kg.FAST_SHAPES.values()}
    for k, n in jgate.FAST_SHAPES.values():
        assert any(c.k == k and c.n % n == 0 for c in fast), (k, n)
    # a --qtypes split drops the qtype-free i8 cases, as the JAX gate does
    assert not [c for c in kg.gate_cases(qtypes=[DataType.Q5_K]) if c.form == "i8"]


@pytest.mark.parametrize("form,qtype,m,entry", [
    ("gq", DataType.Q5_K, 8, "gq_decode"), ("gq", DataType.Q5_K, 9, "gq_prefill"),
    ("gq p5", DataType.Q5_K, 1, "gq_decode[p5]"), ("gq p4", DataType.Q4_K, 512, "gq_prefill[p4]"),
    ("gq", DataType.Q8_0, 1, "gq_decode_generic"), ("gq p6", DataType.Q6_K, 8,
                                                    "gq_decode_generic[p6]"),
    ("gq p4", DataType.Q4_0, 9, "gq_prefill_generic[p4]"), ("rq", DataType.Q6_K, 8, "rq_decode"),
    ("rq", DataType.Q4_0, 9, "rq_prefill"), ("i8", None, 8, "i8_decode"),
    ("i8", None, 9, "i8_prefill")])
def test_cases_route_to_the_serving_entry(form, qtype, m, entry):
    c = kg.Case("13B w2", 5120, 13824, qtype, form, m, True)
    assert c.entry == entry
    assert c.tol == (kg.DECODE_TOL if entry.startswith(("gq_decode", "i8")) else kg.PREFILL_TOL)
    assert entry in c.tag and "stacked" in c.tag


@pytest.mark.parametrize("qtype", list(kg.QTYPES))
def test_gate_passes_with_the_plain_versions(qtype):
    report, out = [], io.StringIO()
    assert kg.run_gate(qtypes=[qtype], device="cpu", launch=kg.kernel_launch, shapes=SMALL,
                       report=report, out=out)
    want = [c.tag for c in kg.gate_cases(qtypes=[qtype], shapes=SMALL)]
    assert [r["tag"] for r in report] != [] and sorted(r["tag"] for r in report) == sorted(want)
    assert all(r["ok"] and r["rel_err"] <= r["tol"] for r in report)
    assert out.getvalue().count("[kernel-gate] PASS") == len(want)


def test_gate_i8_cases_pass_with_the_plain_versions():
    report = []
    assert kg.run_gate(device="cpu", launch=kg.kernel_launch, shapes=SMALL, report=report,
                       out=None)
    i8 = kg.summary([r for r in report if r["entry"].startswith("i8")])
    assert {e: s["cases"] for e, s in i8.items()} == {"i8_decode": 8, "i8_prefill": 8}
    assert max(s["max_rel_err"] for s in i8.values()) <= 1e-6


def test_a_launch_one_percent_off_fails_its_cases_by_name():
    def off(entry, x, w, layer):
        y = kg.kernel_launch(entry, x, w, layer)
        return 1.01 * y if entry == "gq_decode" else y

    report, out = [], io.StringIO()
    assert not kg.run_gate(qtypes=[DataType.Q5_K], device="cpu", launch=off, shapes=SMALL,
                           report=report, out=out)
    failed = [r for r in report if not r["ok"]]
    assert failed and all(r["entry"] == "gq_decode" for r in failed)
    assert len(failed) == sum(r["entry"] == "gq_decode" for r in report)
    for r in failed:
        assert f"[kernel-gate] FAIL {r['tag']}: rel err" in out.getvalue()
    assert kg.summary(report)["gq_decode"]["failed"] == len(failed)


def test_a_raising_launch_fails_its_case_and_the_sweep_goes_on():
    def refuse(entry, x, w, layer):
        if entry == "rq_prefill" and layer == 1:
            raise RuntimeError("mgt_rq_prefill: too much shared memory")
        return kg.kernel_launch(entry, x, w, layer)

    report, out = [], io.StringIO()
    assert not kg.run_gate(qtypes=[DataType.Q6_K], device="cpu", launch=refuse, shapes=SMALL,
                           report=report, out=out)
    failed = [r["tag"] for r in report if not r["ok"]]
    assert failed and all("rq_prefill" in t and "stacked" in t for t in failed)
    assert "RuntimeError: mgt_rq_prefill: too much shared memory" in out.getvalue()
    assert len(report) == len(kg.gate_cases(qtypes=[DataType.Q6_K], shapes=SMALL))


def test_tp_gate_sums_the_k_shards():
    report, out = [], io.StringIO()
    assert kg.run_tp_gate(device="cpu", launch=kg.kernel_launch,
                          shapes={"w2": (32, 1024), "wo": (48, 512)}, report=report, out=out)
    assert len(report) == 2 * len(kg.TP_SIZES) * len(kg.TP_MS)
    assert {r["entry"] for r in report} == {"rq_decode", "rq_prefill"}
    assert out.getvalue().count("n/a") == 2 * len(kg.TP_SIZES)
    # shard outputs 10 % short fail every case
    report = []
    assert not kg.run_tp_gate(device="cpu", launch=lambda e, x, w, l: 0.9 * kg.kernel_launch(
        e, x, w, l), shapes={"wo": (48, 512)}, report=report, out=None)
    assert not any(r["ok"] for r in report)


def test_gate_refuses_to_run_the_cpu_as_its_device():
    with pytest.raises(ValueError, match="CUDA"):
        kg.run_gate(device="cpu", shapes=SMALL)


def test_cli_without_a_card_exits_1():
    proc = subprocess.run([sys.executable, "-m", "minigpt4_tpu_torch.kernel_gate", "--fast"],
                          capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert proc.returncode == 1
    assert "no CUDA card" in proc.stderr and "PASS" not in proc.stdout
