"""Launch plan and workspace of the quantized prefill kernel.

``csrc/qmm_prefill.cuh`` serves the gq prefill entries (:mod:`.group_i8`)
and the repacked one (:mod:`.pallas_quant_matmul`).  A block computes 128
weight rows (``BN``) against a token tile of ``bt`` activation rows, walking
K in 64-wide steps (``BK``).  This module decides, per launch:

* the token tile, by :func:`token_tile` from M alone: each weight element is
  dequantized once per token tile, so larger tiles dequantize less but pad a
  ragged M with more rows of tensor-core work;
* the K segments, by :func:`segments` from K alone: a segment's sum starts
  from zero and y is the segments' sums added in segment order, whether one
  block runs all segments of a tile or each segment runs in a block of its
  own (split K);
* the split, by :func:`plan`: one block per (tile, segment) when the tiles
  alone would leave SMs idle, else one block per tile.  The split changes no
  bit of y (the segments and their order stay), so a weight's column halves,
  which may split where the whole width does not, give the whole width's bits.

:func:`launch_args` allocates the bf16 copy of x the kernel's TMA reads and
hands out the per-device workspace of split launches: f32 segment sums and
one i32 counter per tile, zero between launches (the kernel's last block of
a tile resets it).  The workspace grows as launches need and is shared by
every launch on the device's stream.
"""

from __future__ import annotations

import torch

BN = 128  # weight rows per block (two consumer warpgroups of 64)
BK = 64  # K per step
SEG_STEPS = 32  # steps per K segment (qmm_prefill.cuh kPfSegSteps)
TOKEN_TILES = (256, 128, 64)  # wgmma N: activation rows per block, largest first
# a tile's dequantization costs about as much as this many token rows of
# tensor-core work (token_tile's cost model)
DEQUANT_ROWS = 64
# split K only while the split grid stays within this many waves of blocks
MAX_SPLIT_WAVES = 4


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def token_tile(m: int) -> int:
    """The token tile for M rows: least ``tiles * (DEQUANT_ROWS + bt)``,
    the larger tile on a tie."""
    return min(TOKEN_TILES, key=lambda bt: _cdiv(m, bt) * (DEQUANT_ROWS + bt))


def segments(k: int) -> list[tuple[int, int]]:
    """The K segments ``[(k0, k1), ...]``, in summation order: at most
    SEG_STEPS steps of BK each, balanced; they cover [0, K)."""
    steps = _cdiv(k, BK)
    seg_len = _cdiv(steps, _cdiv(steps, SEG_STEPS))
    return [(s * BK, min((s + seg_len) * BK, k)) for s in range(0, steps, seg_len)]


def plan(m: int, n: int, k: int, sms: int) -> tuple[int, int]:
    """(token tile, splits) of a launch on a card with ``sms`` SMs; splits
    is 1 or the number of K segments."""
    bt = token_tile(m)
    tiles = _cdiv(n, BN) * _cdiv(m, bt)
    n_seg = len(segments(k))
    if n_seg > 1 and tiles < sms and tiles * n_seg <= MAX_SPLIT_WAVES * sms:
        return bt, n_seg
    return bt, 1


def workspace_floats(m: int, n: int, bt: int, splits: int) -> int:
    """f32 segment sums a split launch writes: every (tile, segment) block's
    BN x bt tile; none unsplit."""
    return 0 if splits == 1 else _cdiv(n, BN) * _cdiv(m, bt) * splits * BN * bt


# per device index: [SM count, counters, segment sums]
_work: dict = {}
_held: list = []  # outgrown buffers: a captured CUDA graph may still use them


def launch_args(x: torch.Tensor, n: int) -> tuple[torch.Tensor, tuple]:
    """(xb, args) of a launch on x f32 [M, K] (CUDA) against N weight rows:
    xb is the bf16 [M, K64] buffer the kernel fills and reads (to be kept
    alive until the launch is queued), args the entry's trailing arguments
    (xb pointer, workspace and counter pointers or None, token tile, splits)."""
    m, k = x.shape
    device = x.device
    w = _work.get(device.index)
    if w is None:
        w = _work[device.index] = [
            torch.cuda.get_device_properties(device).multi_processor_count, None, None]
    bt, splits = plan(m, n, k, w[0])
    xb = torch.empty((m, _cdiv(k, BK) * BK), dtype=torch.bfloat16, device=device)
    if splits == 1:
        return xb, (xb.data_ptr(), None, None, bt, 1)
    tiles = _cdiv(n, BN) * _cdiv(m, bt)
    need = workspace_floats(m, n, bt, splits)
    if w[1] is None or w[1].numel() < tiles:
        _held.append(w[1])
        w[1] = torch.zeros(max(tiles, 1024), dtype=torch.int32, device=device)
    if w[2] is None or w[2].numel() < need:
        _held.append(w[2])
        w[2] = torch.empty(max(need, 1 << 22), dtype=torch.float32, device=device)
    return xb, (xb.data_ptr(), w[2].data_ptr(), w[1].data_ptr(), bt, splits)
