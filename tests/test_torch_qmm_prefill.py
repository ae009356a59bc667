"""The launch plan of the quantized prefill kernel (ops/qmm_prefill.py).

The kernel (csrc/qmm_prefill.cuh) sums K in segments taken from K alone and
adds the segments' sums in segment order, whether one block runs a tile's
segments or each runs in a block of its own; that is what makes a weight's
column halves give the whole-width launch's bits (tp's column shards).  These
tests hold the plan to that on the CPU; the kernel itself is held to its plain
version on the card (tests/test_torch_cuda.py).
"""

import re
from pathlib import Path

import pytest
import torch

from minigpt4_tpu_torch.ops import qmm_prefill as qp

# one intra-op thread: the suite runs several pytest-xdist workers on the same cores, where
# torch's OpenMP pools spin against each other and run ~17x slower
torch.set_num_threads(1)

CUH = Path(qp.__file__).resolve().parent.parent / "csrc" / "qmm_prefill.cuh"

# K of the models the port serves: Q-Former 768 / 3072, ViT-G 1408 / 6144,
# Vicuna-7B 4096 / 11008, Vicuna-13B 5120 / 13824; 96 and 1280 of the card tests
KS = [96, 768, 1280, 1408, 3072, 4096, 5120, 6144, 11008, 13824]


@pytest.mark.parametrize("k", KS)
def test_segments_cover_k_in_order(k):
    segs = qp.segments(k)
    assert segs[0][0] == 0 and segs[-1][1] == k
    for (a0, a1), (b0, b1) in zip(segs, segs[1:]):
        assert a1 == b0
    lens = [b - a for a, b in segs]
    assert all(0 < n <= qp.SEG_STEPS * qp.BK for n in lens)
    assert all(a % qp.BK == 0 for a, _ in segs)
    # balanced: every segment but the last has the same number of steps
    assert len({n for n in lens[:-1]}) <= 1 and lens[-1] <= lens[0]


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("m", [9, 32, 256, 512])
def test_split_keeps_the_segments(k, m):
    """Whatever the split, the segments (and so the bits) stay those of K:
    a split runs one block per segment, an unsplit launch adds the same
    segments in the same order.  A column half may split where the whole
    width does not."""
    n_seg = len(qp.segments(k))
    for n in (48, 1408, 5120, 13824, 27648, 32000):
        bt, splits = qp.plan(m, n, k, 132)
        assert bt == qp.token_tile(m)
        assert splits in (1, n_seg)
        if splits > 1:
            assert qp.workspace_floats(m, n, bt, splits) == (
                -(-n // qp.BN) * -(-m // bt) * splits * qp.BN * bt)
        else:
            assert qp.workspace_floats(m, n, bt, splits) == 0


@pytest.mark.parametrize("m,n,k,split", [
    (256, 5120, 5120, True),      # 13B attention projections: 40 tiles on 132 SMs
    (32, 5120, 13824, True),      # 13B w2 at the image chunk
    (257, 1408, 6144, True),      # ViT-G fc2: 33 tiles
    (256, 27648, 5120, False),    # 13B w13: 216 tiles
    (512, 5120, 13824, False),    # 80 tiles x 7 segments: beyond MAX_SPLIT_WAVES
    (32, 3072, 768, False),       # Q-Former: one segment
])
def test_split_only_where_the_grid_is_short(m, n, k, split):
    assert (qp.plan(m, n, k, 132)[1] > 1) == split


@pytest.mark.parametrize("m,bt", [(1, 64), (9, 64), (32, 64), (64, 64), (65, 128), (100, 128),
                                  (128, 128), (129, 256), (200, 256), (256, 256), (257, 128),
                                  (384, 128), (512, 256), (1000, 256)])
def test_token_tile(m, bt):
    assert qp.token_tile(m) == bt
    cost = lambda t: -(-m // t) * (qp.DEQUANT_ROWS + t)  # noqa: E731
    assert cost(bt) == min(cost(t) for t in qp.TOKEN_TILES)


def test_plan_matches_the_kernel_constants():
    """The wrapper sizes the workspace and the kernel cuts K with the same
    constants (the kernel recomputes the segments from K)."""
    src = CUH.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kPfBN") == qp.BN
    assert const("kPfBK") == qp.BK
    assert const("kPfSegSteps") == qp.SEG_STEPS
    for bt in qp.TOKEN_TILES:
        assert f"case {bt}: return launch_prefill<P, C, {bt}>" in src
