"""The port's ``debug.py`` and ``profiling.py`` on their own, against the
JAX package's modules of the same names.

``debug.compare_dumps`` flags a planted divergence, a shape change and a
missing stage as JAX's does (the port's dumps against JAX's:
``tests/test_torch_sharding.py``).
``profiling``: ``DecodeStats`` gives JAX's summary keys, ``trace`` writes a
Chrome trace, and without a card ``device_memory_stats`` is {} (JAX's
answer where the backend reports nothing) and ``profile_window`` raises
(it times device activity, which a CPU run has none of).
"""

import json
import time

import numpy as np
import pytest
import torch

from fixtures import build_tiny_models
from minigpt4_tpu import debug as jdebug
from minigpt4_tpu import profiling as jprofiling
from minigpt4_tpu_torch import debug, profiling
from minigpt4_tpu_torch.formats import ContainerReader
from minigpt4_tpu_torch.models import minigpt4 as tvision

# one intra-op thread: the suite runs several pytest-xdist workers on the same cores, where
# torch's OpenMP pools spin against each other and run ~17x slower
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    """A stage dump of the whole port on the fixture pair."""
    d = tmp_path_factory.mktemp("torch_tools")
    model, _ = build_tiny_models(d)
    pixels = np.random.default_rng(1).normal(0, 1, (1, 3, 28, 28)).astype(np.float32)
    with ContainerReader(str(model)) as r:
        vp, vcfg = tvision.load_params(r, torch.float32, "cpu")
    return d, debug.dump_vision_stages(vp, pixels, vcfg), None


def test_compare_dumps_reports_as_jax_does(dumps):
    d, got, _ = dumps
    bad = dict(got)
    bad["ln_vision"] = bad["ln_vision"] + 0.1
    bad["llama_proj"] = bad["llama_proj"][..., :-1]
    del bad["qformer_embed"]
    debug.save_dump(got, str(d / "a.npz"))
    debug.save_dump(bad, str(d / "b.npz"))
    report = debug.compare_dumps(str(d / "a.npz"), str(d / "b.npz"))
    jreport = jdebug.compare_dumps(str(d / "a.npz"), str(d / "b.npz"))
    assert [(r["stage"], r["status"]) for r in report] == [(r["stage"], r["status"])
                                                           for r in jreport]
    first = debug.first_divergence(report)
    assert first["stage"] == "ln_vision" and first["status"] == "DIVERGED"
    assert {r["stage"]: r["status"] for r in report}["qformer_embed"] == "missing-in-b"
    assert {r["stage"]: r["status"] for r in report}["llama_proj"] == "shape"


def test_decode_stats_summary_has_jax_keys():
    ours, theirs = profiling.DecodeStats(), jprofiling.DecodeStats()
    assert ours.summary() == theirs.summary() == {"tokens": 0}
    for _ in range(5):
        time.sleep(0.001)
        ours.tick()
        theirs.tick()
    s = ours.summary()
    assert set(s) == set(theirs.summary())
    assert s["tokens"] == 5 and s["tok_s"] > 0 and s["p99_ms"] >= s["p50_ms"] > 0


def test_trace_and_memory_without_a_card(tmp_path):
    with profiling.trace(str(tmp_path / "t")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof is not None
    events = json.loads((tmp_path / "t" / "trace.json").read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    assert profiling.device_memory_stats() == {}
    seconds, calls = profiling.collective_seconds()  # the tp all-reduces of this process
    assert isinstance(seconds, float) and seconds >= 0.0 and calls >= 0
    with pytest.raises(AssertionError, match="no device activity"):
        profiling.profile_window(lambda: torch.ones(4) + 1, lambda: None)
