"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one.  The file
imports no JAX, so it runs on a machine that has only PyTorch and the CUDA
toolkit; tests/conftest.py imports JAX, so run it there without the
conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances: gq_decode and gq_decode_generic compute their plain version's
dual-i8 function (the split of x bit-equal, exact integer group dots, the
same f32 roundings of each group's term) and sum the groups in another
order (1e-5 of max|y|); two launches give the same bits, and a packed
weight its unpacked twin's; gq_prefill and
gq_prefill_generic round x and W to bf16 like their plain version and sum
K segments on the tensor cores (1e-4; two launches give the same bits,
split K or not); flash decode, dense and paged,
is f32 online softmax against f32 softmax (1e-5 absolute on unit inputs),
and the paged kernel gives the dense kernel's bits on the gathered cache.
rq_decode keeps x in f32 and forms the plain version's weights bit for bit
(1e-5, summation order); rq_prefill
rounds x and w = scale * q - min to bf16 like qmatmul_repacked_prefill_ref
(1e-4, summation order) and sits within 1e-2 of the f32 plain version
(two bf16 roundings of 2^-9 each per product; tests/test_pallas_quant_matmul.py
holds the TPU kernel to 1.2e-2 of the same f32 product).  i8_decode and
i8_prefill form each 256-wide chunk's product as an exact i32 like
qmatmul_i8sb_ref and sum the scaled chunks in a fixed order (1e-5 and 1e-4
of max|y|: only the f32 summation order differs); i8_decode quantizes x
inside its launch, bit-equal to quantize_activations (seen through an
identity weight, where y is code times row scale), and applies the row
scale.  The bits of a column of either decode kernel do not depend on N
or the grid, and a w8a8 matmul of at most 8 rows is one device kernel.  The e4m3 cache
reads as the same values in the kernels and in cache_f32 (1e-5
absolute, as the other cache types).  A packed gq weight (p4, p5, p6) gives
its unpacked twin's bits in every entry (max |d| = 0): the code reaches the
same arithmetic as the same float.  A NaN past a lane's cursor is never read.
The stats mode of flash decode (the partials of sequence parallelism) is
held to its plain version like the normalized mode (1e-5), with exact
zero partials where a row sees no key.  Flash decode split over several
blocks (C = 2048) is held to the same bounds, and to the plain
split-then-merge at the same split count.  The probe kernels (ops/probes.py):
the dual-i8 q5_k matmul and every storage / strategy / width / layout of the
dequantize-matvec are f32 sums in another order than their plain versions
(1e-4 of max|y|; at M = 2..8 on the tensor cores with x split into three
exact bf16 parts, each row within 1e-4 of its own max against the f64
formula, and two launches give the same bits); the integer dots, the s4
chunk-scaled dot (products and sums rounded apart in chunk order, as the
plain version) and the op chains give their plain versions' bits.  A column-parallel slice (half the output
rows) of a 13B weight gives the whole-width launch's bits in those rows.
"""

import json

import numpy as np
import pytest
import torch

from fixtures import GQ_D, build_container, build_gq_models, build_llm_gq
from minigpt4_tpu_torch.engine import MiniGPT4Engine, SamplingParams
from minigpt4_tpu_torch.engine.device_sampling import DeviceSamplingConfig
from minigpt4_tpu_torch.engine.sessions import SessionPool
from minigpt4_tpu_torch.formats import DataType, quants
from minigpt4_tpu_torch.image import preprocess
from minigpt4_tpu_torch.models.llama import _bits
from minigpt4_tpu_torch.ops import _build, counters
from minigpt4_tpu_torch.ops import flash_decode as tfd
from minigpt4_tpu_torch.ops import group_i8 as tgq
from minigpt4_tpu_torch.ops import i8_matmul as ti8
from minigpt4_tpu_torch.ops import pallas_quant_matmul as trq
from minigpt4_tpu_torch.ops import probes as tpb
from minigpt4_tpu_torch.ops import repack as trp
from test_torch_fixtures import build_llm_q5_k_m

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-12))


def _q5k(n, k, seed):
    vals = np.random.default_rng(seed).normal(0, 0.6, (n, k)).astype(np.float32)
    return quants.quantize(vals, DataType.Q5_K)


@pytest.mark.parametrize("m", [1, 3, 8, 16, 40])
def test_group_quant_kernels_match_plain(cuda_device, m):
    n, k = 300, 768  # ragged N for both kernels' column tiles
    w = tgq.stack([tgq.from_ggml(_q5k(n, k, s), (n, k), DataType.Q5_K, cuda_device)
                   for s in (1, 2)])
    x = torch.from_numpy(np.random.default_rng(m).normal(0, 1, (m, k)).astype(np.float32))
    x = x.to(cuda_device)
    kern, plain = ((tgq.gq_decode, tgq.qmatmul_decode_ref) if m <= tgq.GQ_MAX_M
                   else (tgq.gq_prefill, tgq.qmatmul_prefill_ref))
    before = kern.launches
    got = kern(x, w, 1)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    assert _rel(got, plain(x, w, 1)) <= (1e-5 if m <= tgq.GQ_MAX_M else 1e-4)


def _generic(dtype, n, k, seeds, device):
    return tgq.stack([tgq.from_ggml(quants.quantize(
        np.random.default_rng(s).normal(0, 0.6, (n, k)).astype(np.float32), dtype),
        (n, k), dtype, device) for s in seeds])


# q6_k: group size 16, codes 0..63; q8_0: group size 32, signed codes
@pytest.mark.parametrize("dtype", [DataType.Q6_K, DataType.Q8_0], ids=["q6_k", "q8_0"])
@pytest.mark.parametrize("m", [1, 8, 40])
def test_generic_group_quant_kernels_match_plain(cuda_device, dtype, m):
    n, k = 300, 768  # ragged N for both kernels' column tiles
    w = _generic(dtype, n, k, (1, 2), cuda_device)
    assert w.group_size == (16 if dtype == DataType.Q6_K else 32)
    x = torch.from_numpy(np.random.default_rng(m).normal(0, 1, (m, k)).astype(np.float32))
    x = x.to(cuda_device)
    kern, plain = ((tgq.gq_decode_generic, tgq.qmatmul_decode_ref) if m <= tgq.GQ_MAX_M
                   else (tgq.gq_prefill_generic, tgq.qmatmul_prefill_ref))
    before = kern.launches
    got = kern(x, w, 1)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    assert _rel(got, plain(x, w, 1)) <= (1e-5 if m <= tgq.GQ_MAX_M else 1e-4)


def test_refused_launches_raise(cuda_device):
    w = _generic(DataType.Q6_K, 64, 256, (0,), cuda_device)
    x9 = torch.zeros((9, 256), device=cuda_device)
    with pytest.raises(ValueError, match="1..8 rows"):
        tgq.gq_decode_generic(x9, w, 0)
    with pytest.raises(ValueError, match="takes exact-plane weights"):
        tgq.gq_decode(x9[:1], w, 0)  # the exact entry refuses bf16 planes
    # K = 96 is no multiple of 8 groups of 16
    bad = tgq.GroupQuant(codes=w.codes[:, :, :96].contiguous(), dtype=w.dtype, n_in=96,
                         group_size=16, a=w.a[:, :6].contiguous(), b=w.b[:, :6].contiguous())
    with pytest.raises(ValueError, match="multiple of 128"):
        tgq.gq_prefill_generic(torch.zeros((40, 96), device=cuda_device), bad, 0)
    # the C entries refuse what the wrappers would: M = 9, group size 24
    lib, y = _build.load(), torch.empty((9, 64), device=cuda_device)
    stream = _build.stream_ptr(cuda_device)
    for m, gs in ((9, 16), (1, 24)):
        rc = lib.mgt_gq_decode_generic(x9.data_ptr(), w.codes.data_ptr(), None, w.a.data_ptr(),
                                       w.b.data_ptr(), y.data_ptr(), m, 64, 256, gs, -1, 0,
                                       stream)
        with pytest.raises(RuntimeError, match="launch failed"):
            _build.check(rc, "mgt_gq_decode_generic")


FLASH_CASES = [(1, 0), (1, 300), (8, 130), (32, 0), (32, 250), (1, [5, 400]), (32, [97, 128])]


CACHE_TYPES = [torch.float32, torch.bfloat16, torch.float8_e4m3fn]
CACHE_IDS = ["f32", "bf16", "e4m3"]


@pytest.mark.parametrize("cache_dtype", CACHE_TYPES, ids=CACHE_IDS)
@pytest.mark.parametrize("s,pos0", FLASH_CASES)
def test_flash_decode_kernel_matches_plain(cuda_device, s, pos0, cache_dtype):
    rng = np.random.default_rng(3)
    b = 1 if isinstance(pos0, int) else len(pos0)
    l, h, c, dh = 2, 4, 500, 128  # C is no multiple of the kernel's key block

    def rand(*shape):
        return torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to(cuda_device)

    q = rand(b, h, s, dh)
    ck, cv = rand(l, b, h, c, dh).to(cache_dtype), rand(l, b, h, c, dh).to(cache_dtype)
    before = tfd.flash_decode_attention.launches
    got = tfd.flash_decode_attention(q, ck, cv, 1, pos0, 0.0884)
    torch.cuda.synchronize()
    assert tfd.flash_decode_attention.launches == before + 1
    want = tfd.flash_decode_ref(q, ck, cv, 1, pos0, 0.0884)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


STATS_CASES = [(1, 0), (1, 300), (8, 130), (32, 250), (8, -3), (1, [5, -40, 400]),
               (8, [-300, 0, 127])]


@pytest.mark.parametrize("cache_dtype", CACHE_TYPES, ids=CACHE_IDS)
@pytest.mark.parametrize("s,pos0", STATS_CASES)
def test_flash_decode_stats_match_plain(cuda_device, s, pos0, cache_dtype):
    """The stats launch (the partials of sequence parallelism) against
    flash_decode_stats_ref, signed cursors included: m to 1e-5 absolute, l
    and acc to 1e-5 of their largest value (f32 sums in another order); a
    row that sees no key gets exactly m = -inf, l = 0, acc = 0; and the
    normalized launch gives acc / l of the stats launch bit for bit (the
    same accumulator, the same division)."""
    rng = np.random.default_rng(7)
    b = 1 if isinstance(pos0, int) else len(pos0)
    l_, h, c, dh = 2, 4, 500, 128

    def rand(*shape):
        return torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to(cuda_device)

    q = rand(b, h, s, dh)
    ck, cv = rand(l_, b, h, c, dh).to(cache_dtype), rand(l_, b, h, c, dh).to(cache_dtype)
    before = (tfd.flash_decode_attention.launches, tfd.flash_decode_attention.stats_launches)
    acc, m, l = tfd.flash_decode_attention(q, ck, cv, 1, pos0, 0.0884, return_stats=True)
    torch.cuda.synchronize()
    assert (tfd.flash_decode_attention.launches,
            tfd.flash_decode_attention.stats_launches) == (before[0], before[1] + 1)
    wacc, wm, wl = tfd.flash_decode_stats_ref(q, ck, cv, 1, pos0, 0.0884)
    empty = torch.isneginf(wm)
    assert torch.equal(torch.isneginf(m), empty)
    assert (l[empty] == 0).all() and (acc[empty] == 0).all()
    torch.testing.assert_close(m[~empty], wm[~empty], rtol=0, atol=1e-5)
    assert _rel(l, wl) <= 1e-5 and _rel(acc, wacc) <= 1e-5
    if not empty.any():
        norm = tfd.flash_decode_attention(q, ck, cv, 1, pos0, 0.0884)
        assert torch.equal(norm, acc / l[..., None])


def test_flash_decode_stats_negative_cursor_reads_nothing(cuda_device):
    """A slice that starts after every visible key (pos0 = -600 on 512
    positions, a NaN planted at key 0): zero partials, m = -inf, no NaN."""
    ck, cv = (torch.randn((1, 2, 4, 512, 128), device=cuda_device) for _ in range(2))
    ck[0, :, :, 0] = float("nan")
    q = torch.randn((2, 4, 8, 128), device=cuda_device)
    acc, m, l = tfd.flash_decode_attention(q, ck, cv, 0, -600, 0.0884, return_stats=True)
    torch.cuda.synchronize()
    assert torch.isneginf(m).all() and (l == 0).all() and (acc == 0).all()


# C = 2048 positions, so every lane's live keys reach several splits
# (n_splits: 32 at B = 1, 16 at B = 4 for 4 heads on 132 SMs)
SPLIT_FLASH_CASES = [(1, s, p) for s in (1, 8, 32) for p in (1000, 2015)]
SPLIT_FLASH_CASES += [(4, s, [0, 127, 1000, 2015]) for s in (1, 8, 32)]


def _split_cache(device, b, s, dh, cache_dtype, seed, c=2048):
    rng = np.random.default_rng(seed)

    def rand(*shape):
        return torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to(device)

    return rand(b, 4, s, dh), rand(2, b, 4, c, dh).to(cache_dtype), rand(2, b, 4, c, dh).to(cache_dtype)


@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("cache_dtype", CACHE_TYPES, ids=CACHE_IDS)
@pytest.mark.parametrize("b,s,pos0", SPLIT_FLASH_CASES)
def test_flash_decode_splits_match_plain(cuda_device, b, s, pos0, cache_dtype, dh):
    """The kernel with its keys split over several blocks (merged in split
    order in the same launch) against flash_decode_ref and the plain
    split-then-merge at the same split count: 1e-5 absolute."""
    q, ck, cv = _split_cache(cuda_device, b, s, dh, cache_dtype, seed=s + dh)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    splits = tfd.n_splits(ck.shape[3], b, 4, sms)
    assert splits > 1
    before = tfd.flash_decode_attention.launches
    got = tfd.flash_decode_attention(q, ck, cv, 1, pos0, dh ** -0.5)
    torch.cuda.synchronize()
    assert tfd.flash_decode_attention.launches == before + 1
    torch.testing.assert_close(got, tfd.flash_decode_ref(q, ck, cv, 1, pos0, dh ** -0.5),
                               rtol=0, atol=1e-5)
    torch.testing.assert_close(got, tfd.flash_decode_split_ref(q, ck, cv, 1, pos0, dh ** -0.5,
                                                               splits), rtol=0, atol=1e-5)
    # the counters are left at 0: a second launch gives the same bits
    again = tfd.flash_decode_attention(q, ck, cv, 1, pos0, dh ** -0.5)
    torch.cuda.synchronize()
    assert torch.equal(got, again)


@pytest.mark.parametrize("cache_dtype", CACHE_TYPES, ids=CACHE_IDS)
@pytest.mark.parametrize("s,pos0", [(1, -5), (8, -3), (8, [-300, 100, 1500, 2015]),
                                    (32, [-40, 0, 700, 2015])])
def test_flash_decode_stats_with_splits(cuda_device, s, pos0, cache_dtype):
    """Stats mode over several splits with negative cursors: m to 1e-5, l
    and acc to 1e-5 of their maximum, the neutral partial where a row sees no
    key, and the normalized launch = acc / l bit for bit."""
    b = 1 if isinstance(pos0, int) else len(pos0)
    q, ck, cv = _split_cache(cuda_device, b, s, 128, cache_dtype, seed=41 + s)
    acc, m, l = tfd.flash_decode_attention(q, ck, cv, 1, pos0, 0.0884, return_stats=True)
    torch.cuda.synchronize()
    wacc, wm, wl = tfd.flash_decode_stats_ref(q, ck, cv, 1, pos0, 0.0884)
    empty = torch.isneginf(wm)
    assert torch.equal(torch.isneginf(m), empty)
    assert (l[empty] == 0).all() and (acc[empty] == 0).all()
    if (~empty).any():
        torch.testing.assert_close(m[~empty], wm[~empty], rtol=0, atol=1e-5)
        assert _rel(l, wl) <= 1e-5 and _rel(acc, wacc) <= 1e-5
    if not empty.any():
        norm = tfd.flash_decode_attention(q, ck, cv, 1, pos0, 0.0884)
        assert torch.equal(norm, acc / l[..., None])


@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("s", [1, 8, 32])
@pytest.mark.parametrize("cache_dtype", CACHE_TYPES, ids=CACHE_IDS)
def test_paged_flash_decode_splits_bit_equal_to_dense(cuda_device, dh, s, cache_dtype):
    """Paged pools of 4 lanes x 16 pages + a trash page, table width 17
    (2176 keys a lane, 16 splits): lane 3's cursor lies past its 16 pages, so
    it reads the trash slot.  Against the plain version (1e-5) and the dense
    kernel on the gathered cache (bits)."""
    rng = np.random.default_rng(s + dh)
    b, h, maxp = 4, 4, 16
    n_pages = b * maxp
    pk, pv = (torch.from_numpy(rng.normal(0, 1, (2, n_pages + 1, h, 128, dh)).astype(np.float32))
              .to(cuda_device, cache_dtype) for _ in range(2))
    table = np.full((b, maxp + 1), n_pages, np.int32)
    table[:, :maxp] = rng.permutation(n_pages).reshape(b, maxp)
    table = torch.from_numpy(table).to(cuda_device)
    q = torch.from_numpy(rng.normal(0, 1, (b, h, s, dh)).astype(np.float32)).to(cuda_device)
    pos = torch.tensor([0, 1000, 2015, 2100], dtype=torch.int32, device=cuda_device)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert tfd.n_splits((maxp + 1) * 128, b, h, sms) > 1
    scale = dh ** -0.5
    before = tfd.paged_flash_decode_attention.launches
    got = tfd.paged_flash_decode_attention(q, pk, pv, 1, pos, table, scale)
    torch.cuda.synchronize()
    assert tfd.paged_flash_decode_attention.launches == before + 1
    torch.testing.assert_close(got, tfd.paged_flash_decode_ref(q, pk, pv, 1, pos, table, scale),
                               rtol=0, atol=1e-5)
    w = table.shape[1]
    ck, cv = (p[:, table.long()].permute(0, 1, 3, 2, 4, 5).reshape(2, b, h, w * 128, dh)
              .contiguous() for p in (pk, pv))
    dense = tfd.flash_decode_attention(q, ck, cv, 1, pos, scale)
    torch.cuda.synchronize()
    assert torch.equal(got, dense)


def test_flash_stats_cpu_wrapper_counts_no_launch():
    """On CPU tensors the stats mode runs its plain version and counts no
    launch."""
    f = tfd.flash_decode_attention
    before = (f.launches, f.stats_launches)
    q, ck = torch.zeros(1, 2, 1, 64), torch.zeros(1, 1, 2, 64, 64)
    acc, m, l = f(q, ck, ck, 0, -5, 0.125, return_stats=True)
    assert (f.launches, f.stats_launches) == before
    assert torch.isneginf(m).all() and (l == 0).all() and (acc == 0).all()


# a kernel and its launcher for the launch-refusal check: the launcher
# returns cudaGetLastError() as every entry of the port's library does
REFUSAL_CU = r"""
#include <cuda_runtime.h>
__global__ void touch(int* out) { out[threadIdx.x] = 1; }
extern "C" int launch_touch(int threads, int shared_bytes, int* out) {
  touch<<<1, threads, shared_bytes>>>(out);
  return static_cast<int>(cudaGetLastError());
}
"""


def test_refused_launch_configuration_raises(cuda_device, tmp_path):
    """A launch the card refuses (2048 threads per block, or dynamic shared
    memory past the 227 KB a block may opt into) never runs and reports no
    fault at synchronize(); its error surfaces only through
    cudaGetLastError(), which the entries return and _build.check raises.
    The counterpart of the JAX package's deliberately illegal block
    (tests/test_blockspec_legality.py)."""
    import ctypes

    src = tmp_path / "refusal_check.cu"
    src.write_text(REFUSAL_CU)
    lib = ctypes.CDLL(str(_build.build([src], "librefusal_check.so")))
    lib.launch_touch.argtypes = (ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
    lib.launch_touch.restype = ctypes.c_int
    out = torch.zeros(2048, dtype=torch.int32, device=cuda_device)
    for threads, shared in ((2048, 0), (32, 300 * 1024)):
        rc = lib.launch_touch(threads, shared, out.data_ptr())
        torch.cuda.synchronize()  # nothing to report: the launch never ran
        with pytest.raises(RuntimeError, match="launch failed with CUDA error"):
            _build.check(rc, "launch_touch")
    assert int(out.sum()) == 0
    assert lib.launch_touch(256, 0, out.data_ptr()) == 0  # the error did not stick
    torch.cuda.synchronize()
    assert int(out.sum()) == 256


def test_engine_on_card_matches_plain_versions(cuda_device, tmp_path):
    """One image chat on the gq fixture: the card (kernels) and the CPU
    (plain versions) give the same greedy tokens, and all three kernels ran."""
    model, llm = build_gq_models(tmp_path)
    img = np.random.default_rng(0).integers(0, 255, (40, 50, 3), dtype=np.uint8)
    runs = {}
    for device in ("cpu", "cuda"):
        before = (tgq.gq_decode.launches, tgq.gq_prefill.launches,
                  tfd.flash_decode_attention.launches)
        eng = MiniGPT4Engine(model, llm, n_ctx=256, n_batch=32, device=device)
        try:
            emb = eng.encode_image(preprocess(img, size=eng.vision_cfg.vit.image_size))
            eng.system_prompt()
            eng.begin_chat_image(emb, "what is in the image?")
            runs[device] = (emb, list(eng.generate(limit=10, params=SamplingParams(temp=0.0))))
        finally:
            eng.close()
        after = (tgq.gq_decode.launches, tgq.gq_prefill.launches,
                 tfd.flash_decode_attention.launches)
        grew = [a > b for a, b in zip(after, before)]
        assert grew == ([False] * 3 if device == "cpu" else [True] * 3), (device, before, after)
    (ce, ct), (ge, gt) = runs["cpu"], runs["cuda"]
    assert np.abs(ge - ce).max() <= 1e-4 * np.abs(ce).max()
    assert gt == ct


def test_mixed_engine_on_card_matches_plain_versions(cuda_device, tmp_path):
    """The Q5_K_M fixture (q6_k output, wv and w2 on layers 2-3): the card and
    the CPU give the same greedy tokens, and all five kernels ran."""
    rng = np.random.default_rng(7)
    model = build_container(tmp_path / "minigpt4-gq.bin", rng, llm_d=GQ_D)
    llm = build_llm_q5_k_m(tmp_path / "vicuna-q5_k_m.bin", rng)
    img = np.random.default_rng(3).integers(0, 255, (40, 50, 3), dtype=np.uint8)
    kernels = (tgq.gq_decode, tgq.gq_prefill, tgq.gq_decode_generic, tgq.gq_prefill_generic,
               tfd.flash_decode_attention)
    runs = {}
    for device in ("cpu", "cuda"):
        before = [f.launches for f in kernels]
        eng = MiniGPT4Engine(model, llm, n_ctx=256, n_batch=32, device=device)
        try:
            emb = eng.encode_image(preprocess(img, size=eng.vision_cfg.vit.image_size))
            eng.system_prompt()
            eng.begin_chat_image(emb, "what is in the image?")
            runs[device] = list(eng.generate(limit=10, params=SamplingParams(temp=0.0)))
        finally:
            eng.close()
        grew = [f.launches > b for f, b in zip(kernels, before)]
        assert grew == [device == "cuda"] * 5, (device, before)
    assert runs["cuda"] == runs["cpu"]


def _paged_case(device, dh, dtype, s, seed=5):
    """Pools of 2 layers, 4 lanes of 4 + 1 table slots over 16 shuffled pages
    and the trash page; lane 3 sits past its 512-position capacity, so it
    reads the trash slot."""
    rng = np.random.default_rng(seed)
    l, b, h, maxp = 2, 4, 4, 4
    n_pages = b * maxp
    pool = [torch.from_numpy(rng.normal(0, 1, (l, n_pages + 1, h, 128, dh)).astype(np.float32))
            .to(device, dtype) for _ in range(2)]
    table = np.full((b, maxp + 1), n_pages, np.int32)
    table[:, :maxp] = rng.permutation(n_pages).reshape(b, maxp)
    q = torch.from_numpy(rng.normal(0, 1, (b, h, s, dh)).astype(np.float32)).to(device)
    pos = torch.tensor([0, 130, 511 - s, 600], dtype=torch.int32, device=device)
    return q, pool, torch.from_numpy(table).to(device), pos


@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("s", [1, 8])
@pytest.mark.parametrize("cache_dtype", CACHE_TYPES, ids=CACHE_IDS)
def test_paged_flash_decode_kernel_matches_plain_and_dense(cuda_device, dh, s, cache_dtype):
    q, (pk, pv), table, pos = _paged_case(cuda_device, dh, cache_dtype, s)
    scale = dh ** -0.5
    before = tfd.paged_flash_decode_attention.launches
    got = tfd.paged_flash_decode_attention(q, pk, pv, 1, pos, table, scale)
    torch.cuda.synchronize()
    assert tfd.paged_flash_decode_attention.launches == before + 1
    want = tfd.paged_flash_decode_ref(q, pk, pv, 1, pos, table, scale)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    # the dense kernel on the gathered [L, B, H, 128 W, Dh] cache: same bits
    b, w = table.shape
    ck, cv = (p[:, table.long()].permute(0, 1, 3, 2, 4, 5).reshape(2, b, 4, w * 128, dh)
              .contiguous() for p in (pk, pv))
    dense = tfd.flash_decode_attention(q, ck, cv, 1, pos, scale)
    torch.cuda.synchronize()
    assert torch.equal(got, dense)


def test_paged_flash_decode_refusals_raise(cuda_device):
    q, (pk, pv), table, pos = _paged_case(cuda_device, 64, torch.bfloat16, 1)
    run = tfd.paged_flash_decode_attention
    with pytest.raises(ValueError, match="page size"):
        half = pk[:, :, :, :64].contiguous()
        run(q, half, half, 0, pos, table, 0.125)
    q33 = torch.zeros((4, 4, 33, 64), device=cuda_device)
    with pytest.raises(ValueError, match="1..32 query rows"):
        run(q33, pk, pv, 0, pos, table, 0.125)
    for bad in (table.long(), table.t().contiguous().t(), table.cpu(), table[:2]):
        with pytest.raises(ValueError, match="page_table"):
            run(q, pk, pv, 0, pos, bad, 0.125)
    q96 = torch.zeros((4, 4, 1, 96), device=cuda_device)
    p96 = torch.zeros((2, 17, 4, 128, 96), device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        run(q96, p96, p96, 0, pos, table, 0.125)
    with pytest.raises(NotImplementedError, match="not ported"):
        run(q, pk.half(), pv.half(), 0, pos, table, 0.125)


def test_paged_batch_on_card_matches_plain_versions(cuda_device, tmp_path):
    """A two-lane paged generate_batch on the gq fixture: the card and the
    CPU give the same greedy text, and the paged kernel ran on the card."""
    model, llm = build_gq_models(tmp_path)
    texts = {}
    for device in ("cpu", "cuda"):
        before = tfd.paged_flash_decode_attention.launches
        pool = SessionPool(model, llm, session_ctx=256, n_ctx=256, n_batch=32,
                           paged_pool_pages=8, device=device)
        try:
            sessions = []
            for q in ("one two", "three four five"):
                s = pool.new_session()
                pool.begin_chat(s, q)
                sessions.append(s)
            texts[device] = pool.generate_batch(sessions, limit=12,
                                                params=SamplingParams(temp=0.0), decode_chunk=4)
            assert pool.paged_pool.free_pages == 8
        finally:
            pool.close()
        grew = tfd.paged_flash_decode_attention.launches > before
        assert grew == (device == "cuda")
    assert texts["cuda"] == texts["cpu"]


RQ_FORMATS = sorted(trp.REPACKABLE)


def _rq(dtype, n, k, seeds, device):
    return trp.stack([trp.from_ggml(quants.quantize(
        np.random.default_rng(s).normal(0, 0.6, (n, k)).astype(np.float32), dtype),
        (n, k), dtype, device) for s in seeds])


# every layout at M = 1..8 (rq_decode) and 40 (rq_prefill); K = 1408 (ViT-G
# width, 44 groups of 32, a ragged last 128-code block) for the 32-blocks,
# 768 for the k-quants; N = 301 is odd and ragged for both column tiles, N =
# 24 fills three strips of the decode kernel; K = 1440 (% 64 == 32) a tail
# (k-quant weights hold whole 256-code superblocks, so the 32-blocks only)
# (the prefill kernel's tail is test_repacked_kernels_short_k)
def _rq_cases():
    for dtype in RQ_FORMATS:
        k = 768 if dtype >= DataType.Q2_K else 1408
        for m in (1, 2, 3, 4, 5, 6, 7, 8, 40):
            yield dtype, m, 301, k, "ragged"
            yield dtype, m, 24, k, "small_n"
            if dtype < DataType.Q2_K and m <= 8:
                yield dtype, m, 301, 1440, "tail"


RQ_CASES = list(_rq_cases())


@pytest.mark.parametrize("dtype,m,n,k", [c[:4] for c in RQ_CASES],
                         ids=[f"{d.name.lower()}-m{m}-{s}" for d, m, _, _, s in RQ_CASES])
def test_repacked_kernels_match_plain(cuda_device, dtype, m, n, k):
    w = _rq(dtype, n, k, (1, 2), cuda_device)
    x = torch.from_numpy(np.random.default_rng(m).normal(0, 1, (m, k)).astype(np.float32))
    x = x.to(cuda_device)
    decode = m <= trq.RQ_MAX_M
    kern = trq.rq_decode if decode else trq.rq_prefill
    before = kern.launches
    got = kern(x, w, 1)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    f32 = trq.qmatmul_repacked_ref(x, w, 1)
    if decode:
        assert _rel(got, f32) <= 1e-5
    else:
        assert _rel(got, trq.qmatmul_repacked_prefill_ref(x, w, 1)) <= 1e-4
        assert _rel(got, f32) <= 1e-2


@pytest.mark.parametrize("dtype", [DataType.Q4_0, DataType.Q5_1], ids=["q4_0", "q5_1"])
@pytest.mark.parametrize("m", [3, 40])
def test_repacked_kernels_short_k(cuda_device, dtype, m):
    # K = 96: three groups, a 32-wide tail in the prefill kernel's 64-wide K tile
    w = _rq(dtype, 37, 96, (3,), cuda_device)
    x = torch.from_numpy(np.random.default_rng(m).normal(0, 1, (m, 96)).astype(np.float32))
    got = trq.qmatmul_repacked(x.to(cuda_device), w, 0)
    plain = trq.qmatmul_repacked_ref if m <= trq.RQ_MAX_M else trq.qmatmul_repacked_prefill_ref
    assert _rel(got, plain(x.to(cuda_device), w, 0)) <= 1e-4


def test_repacked_refused_launches_raise(cuda_device):
    w = _rq(DataType.Q5_1, 64, 256, (0,), cuda_device)
    x9 = torch.zeros((9, 256), device=cuda_device)
    with pytest.raises(ValueError, match="1..8 rows"):
        trq.rq_decode(x9, w, 0)
    with pytest.raises(IndexError, match="out of range"):
        trq.rq_decode(x9[:1], w, 1)
    with pytest.raises(ValueError, match="layer index"):
        trq.rq_prefill(x9, w)
    # the C entries refuse what the wrappers would: M = 9, group size 24,
    # K = 48, a missing high-bit plane, a negative layer
    lib, y = _build.load(), torch.empty((9, 64), device=cuda_device)
    stream = _build.stream_ptr(cuda_device)
    ptrs = (w.codes.data_ptr(), w.hi.data_ptr(), w.scales.data_ptr(), w.mins.data_ptr())
    xb = torch.empty((9, 256), dtype=torch.bfloat16, device=cuda_device)
    for entry, m, k, gs, hi, layer in (("mgt_rq_decode", 9, 256, 32, ptrs[1], 0),
                                       ("mgt_rq_decode", 1, 256, 24, ptrs[1], 0),
                                       ("mgt_rq_prefill", 9, 48, 16, ptrs[1], 0),
                                       ("mgt_rq_prefill", 9, 256, 32, None, 0),
                                       ("mgt_rq_decode", 1, 256, 32, ptrs[1], -1)):
        # the prefill entry's bf16 x buffer, workspace, counters, token tile, splits
        pre = (xb.data_ptr(), None, None, 64, 1) if entry == "mgt_rq_prefill" else ()
        rc = getattr(lib, entry)(x9.data_ptr(), ptrs[0], hi, ptrs[2], ptrs[3], y.data_ptr(),
                                 m, 64, k, gs, 4, 1, layer, *pre, stream)
        with pytest.raises(RuntimeError, match="launch failed"):
            _build.check(rc, entry)


def test_repacked_cpu_wrappers_count_no_launch():
    w = _rq(DataType.Q6_K, 32, 256, (0,), "cpu")
    before = (trq.rq_decode.launches, trq.rq_prefill.launches)
    for m in (1, 8, 9, 40):
        trq.qmatmul_repacked(torch.zeros(m, 256), w, 0)
    assert (trq.rq_decode.launches, trq.rq_prefill.launches) == before


@pytest.mark.parametrize("files", ["q4_0", "gq-q5_k"])
def test_repack_engine_on_card_matches_plain_versions(cuda_device, tmp_path, files):
    """One image chat with quant_mode="repack" (a q4_0 container with a q4_0
    decoder of the gq geometry, whose 64-wide heads the flash kernel takes,
    or the gq fixture's q5_k decoder): the card and the CPU give the same
    greedy tokens; on the card both rq kernels ran and no gq kernel did."""
    if files == "q4_0":
        rng = np.random.default_rng(11)
        model = build_container(tmp_path / "minigpt4-q4_0.bin", rng, quant=DataType.Q4_0,
                                llm_d=GQ_D)
        llm = build_llm_gq(tmp_path / "vicuna-q4_0.bin", rng, quant=DataType.Q4_0)
    else:
        model, llm = build_gq_models(tmp_path)
    img = np.random.default_rng(0).integers(0, 255, (40, 50, 3), dtype=np.uint8)
    rq_kernels = (trq.rq_decode, trq.rq_prefill)
    gq_kernels = (tgq.gq_decode, tgq.gq_prefill, tgq.gq_decode_generic, tgq.gq_prefill_generic)
    runs = {}
    for device in ("cpu", "cuda"):
        before = [f.launches for f in rq_kernels + gq_kernels]
        eng = MiniGPT4Engine(model, llm, n_ctx=256, n_batch=32, device=device,
                             quant_mode="repack")
        try:
            emb = eng.encode_image(preprocess(img, size=eng.vision_cfg.vit.image_size))
            eng.system_prompt()
            eng.begin_chat_image(emb, "what is in the image?")
            runs[device] = (emb, list(eng.generate(limit=10, params=SamplingParams(temp=0.0))))
        finally:
            eng.close()
        grew = [f.launches > b for f, b in zip(rq_kernels + gq_kernels, before)]
        assert grew == [device == "cuda"] * 2 + [False] * 4, (device, grew)
    (ce, ct), (ge, gt) = runs["cpu"], runs["cuda"]
    assert np.abs(ge - ce).max() <= 1e-4 * np.abs(ce).max()
    assert gt == ct


def _i8(n, k, layers, device, seed=0):
    rng = np.random.default_rng(seed)
    ws = [ti8.requantize_i8sb(torch.from_numpy(rng.normal(0, 0.6, (n, k)).astype(np.float32))
                              .to(device)) for _ in range(layers)]
    if layers == 1:
        return ti8.I8SBQuant(ws[0][0], ws[0][1], k)
    return ti8.stack([ti8.I8SBQuant(c, sc, k) for c, sc in ws])


# N = 300 is ragged for both column tiles; K = 768 is three chunks; the
# decode entry from f32 x with its own row scales or the caller's
@pytest.mark.parametrize("scaled", [False, True], ids=["absmax", "x_scale"])
@pytest.mark.parametrize("stacked", [False, True], ids=["unstacked", "stacked"])
@pytest.mark.parametrize("m", [1, 2, 3, 4, 5, 6, 7, 8, 9, 33, 257])
def test_i8_kernels_match_plain(cuda_device, m, stacked, scaled):
    n, k = 300, 768
    w = _i8(n, k, 3 if stacked else 1, cuda_device)
    layer = 2 if stacked else None
    x = torch.from_numpy(np.random.default_rng(m).normal(0, 1, (m, k)).astype(np.float32))
    xs = None
    if scaled:  # a global scale above each row's own, as tensor parallelism passes it
        xs = (x.abs().amax(dim=-1, keepdim=True) * 1.5 / 127).to(cuda_device)
    x = x.to(cuda_device)
    decode = m <= ti8.I8_MAX_M
    kern = ti8.i8_decode if decode else ti8.i8_prefill
    before = kern.launches
    if decode:
        got = kern(x, w, layer, xs)
        want = ti8.qmatmul_i8sb_decode_ref(x, w, layer, xs)
    else:
        x_i8, sx = ti8.quantize_activations(x, xs)
        got = kern(x_i8, w, layer) * sx
        want = ti8.qmatmul_i8sb_ref(x_i8, w, layer) * sx
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    assert _rel(got, want) <= (1e-5 if decode else 1e-4)
    # the engine's entry on the card against the CPU
    y = ti8.qmatmul_i8sb(x, w, layer, xs)
    w_cpu = ti8.I8SBQuant(w.codes.cpu(), w.scales.cpu(), k)
    assert _rel(y, ti8.qmatmul_i8sb(x.cpu(), w_cpu, layer, None if xs is None else xs.cpu())
                ) <= 1e-4


def _i8_rows(m: int, k: int, scaled: bool):
    """Rows whose quotients x / s land on every kind of value: a zero row,
    exact half-integers of both parities (s = 1/8: absmax 127 / 8) at three
    scales, +-127.5 where the caller's scale allows them, a lone tiny value,
    huge values, normal rows; and the caller's scales (or None)."""
    rng = np.random.default_rng(k + m)
    x = rng.normal(0, 1, (8, k)).astype(np.float32)
    a = (np.arange(k) % 254 - 127).astype(np.float32)
    ties = np.float32(0.125) * (a + np.float32(0.5))  # a + 1/2 for a in -127..126
    x[0] = 0.0
    x[1] = ties
    x[1, 0] = 127 * 0.125
    x[2] = x[1] * np.float32(0.25)
    x[3] = -x[1] * np.float32(4.0)
    x[4] = 0.0
    x[4, 5] = 1e-30
    x[5] *= np.float32(1e30)
    sx = np.maximum(np.abs(x).max(axis=1, keepdims=True) / np.float32(127), np.float32(0))
    sx[sx == 0] = 1
    if scaled:  # +-127.5 and beyond, which only a caller's scale allows
        x[6, :4] = [127.5 * 0.125, -127.5 * 0.125, 200 * 0.125, -126.5 * 0.125]
        sx[6] = 0.125
    return x[:m], (sx[:m].astype(np.float32) if scaled else None)


@pytest.mark.parametrize("scaled", [False, True], ids=["absmax", "x_scale"])
@pytest.mark.parametrize("m", [1, 2, 3, 4, 5, 6, 7, 8])
def test_i8_decode_codes_bit_equal(cuda_device, m, scaled):
    """The codes and row scales the decode kernel forms in its launch are
    quantize_activations', bit for bit: through an identity weight (one
    code 1 per row, scale 1) every y is code * s exactly, so y equals the
    plain version's bits; ties at .5 round to even, +-127.5 clamp to
    +-127."""
    k = 768
    codes = torch.eye(k, dtype=torch.int8, device=cuda_device)
    w = ti8.I8SBQuant(codes, torch.ones((k, k // 256), device=cuda_device), k)
    xn, sn = _i8_rows(m, k, scaled)
    x = torch.from_numpy(xn).to(cuda_device)
    xs = None if sn is None else torch.from_numpy(sn).to(cuda_device)
    got = ti8.i8_decode(x, w, None, xs)
    want = ti8.qmatmul_i8sb_decode_ref(x, w, None, xs)
    codes_ref, s_ref = ti8.quantize_activations(x, xs)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got, codes_ref.float() * s_ref)
    cpu = ti8.qmatmul_i8sb_decode_ref(x.cpu(), ti8.I8SBQuant(codes.cpu(), w.scales.cpu(), k),
                                      None, None if xs is None else xs.cpu())
    assert torch.equal(got.cpu(), cpu)
    if m >= 2:  # the ties did round to even
        q = x[1].double() / s_ref[1].double()
        half = (q - q.floor()) == 0.5
        assert int(half.sum()) >= k - 2
        assert bool((codes_ref[1][half].long() % 2 == 0).all())


def test_w8a8_decode_is_one_device_kernel(cuda_device):
    """A w8a8 matmul of at most 8 rows (qmatmul_i8sb, the engine's entry) is
    one device kernel under torch.profiler: the quantization of x and the
    row scale run inside i8_decode's launch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    w = _i8(300, 768, 2, cuda_device)
    for m in (1, 8):
        x = torch.randn((1, m, 768), device=cuda_device)
        ti8.qmatmul_i8sb(x, w, 1)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            ti8.qmatmul_i8sb(x, w, 1)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        assert len(names) == 1 and "i8_decode_kernel" in names[0], (m, names)


I8_PREFILL_SHAPES = [(300, 256), (300, 768), (1408, 5120), (27648, 5120)]


@pytest.mark.parametrize("stacked", [False, True], ids=["unstacked", "stacked"])
@pytest.mark.parametrize("n,k", I8_PREFILL_SHAPES)
@pytest.mark.parametrize("m", [9, 32, 64, 65, 257, 512])
def test_i8_prefill_shapes_match_plain(cuda_device, m, n, k, stacked):
    """The wgmma kernel at ragged M (a 128-row tile's second warpgroup empty
    or partly filled) and N (300), the ViT-G and 13B widths: 1e-4 of
    max|y| against qmatmul_i8sb_ref (exact i32 chunks, scaled in chunk
    order)."""
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(m * 7 + n + k)
    layers = 3 if stacked else 1
    codes = torch.randint(-127, 128, (layers, n, k), generator=gen, device=cuda_device,
                          dtype=torch.int8)
    scales = 2.0 ** -13 * (0.5 + torch.rand((layers, n, k // 256), generator=gen,
                                            device=cuda_device))
    w = (ti8.I8SBQuant(codes, scales, k) if stacked
         else ti8.I8SBQuant(codes[0], scales[0], k))
    layer = 2 if stacked else None
    x_i8 = torch.randint(-127, 128, (m, k), generator=gen, device=cuda_device, dtype=torch.int8)
    before = ti8.i8_prefill.launches
    got = ti8.i8_prefill(x_i8, w, layer)
    torch.cuda.synchronize()
    assert ti8.i8_prefill.launches == before + 1
    assert _rel(got, ti8.qmatmul_i8sb_ref(x_i8, w, layer)) <= 1e-4


def test_i8_refused_launches_raise(cuda_device):
    w = _i8(64, 256, 2, cuda_device)
    x9 = torch.zeros((9, 256), dtype=torch.int8, device=cuda_device)
    f9 = torch.zeros((9, 256), device=cuda_device)
    with pytest.raises(ValueError, match="1..8 rows"):
        ti8.i8_decode(f9, w, 0)
    with pytest.raises(ValueError, match="float32"):
        ti8.i8_decode(x9[:1], w, 0)
    with pytest.raises(ValueError, match="x_scale"):
        ti8.i8_decode(f9[:2], w, 0, torch.ones((3, 1), device=cuda_device))
    with pytest.raises(IndexError, match="out of range"):
        ti8.i8_prefill(x9, w, 2)
    with pytest.raises(ValueError, match="layer index"):
        ti8.i8_prefill(x9, w)
    # K = 96 is no multiple of 256: both C entries refuse it
    bad = ti8.I8SBQuant(w.codes[:, :, :96].contiguous(), w.scales[:, :, :1].contiguous(), 96)
    for kern, x in ((ti8.i8_decode, f9[:1, :96]), (ti8.i8_prefill, x9[:, :96])):
        with pytest.raises(RuntimeError, match="launch failed"):
            kern(x.contiguous(), bad, 0)


def test_i8_cpu_wrappers_count_no_launch():
    w = _i8(32, 256, 1, "cpu")
    before = (ti8.i8_decode.launches, ti8.i8_prefill.launches)
    for m in (1, 8, 9, 40):
        ti8.qmatmul_i8sb(torch.ones(m, 256), w)
    assert (ti8.i8_decode.launches, ti8.i8_prefill.launches) == before


def test_w8a8_f8_engine_on_card_matches_plain_versions(cuda_device, tmp_path):
    """One image chat on the gq fixture with quant_mode="w8a8" (every
    decoder weight has K % 256 == 0) over an e4m3 cache: the card and the
    CPU give the same greedy tokens; on the card both i8 kernels and the
    flash kernel ran and no gq kernel did."""
    model, llm = build_gq_models(tmp_path)
    img = np.random.default_rng(0).integers(0, 255, (40, 50, 3), dtype=np.uint8)
    kernels = (ti8.i8_decode, ti8.i8_prefill, tfd.flash_decode_attention, tgq.gq_decode,
               tgq.gq_prefill, tgq.gq_decode_generic, tgq.gq_prefill_generic)
    runs = {}
    for device in ("cpu", "cuda"):
        before = [f.launches for f in kernels]
        eng = MiniGPT4Engine(model, llm, n_ctx=256, n_batch=32, device=device,
                             quant_mode="w8a8", cache_dtype="f8")
        try:
            assert eng.cache_dtype == torch.float8_e4m3fn
            emb = eng.encode_image(preprocess(img, size=eng.vision_cfg.vit.image_size))
            eng.system_prompt()
            eng.begin_chat_image(emb, "what is in the image?")
            runs[device] = (emb, list(eng.generate(limit=10, params=SamplingParams(temp=0.0))))
        finally:
            eng.close()
        grew = [f.launches > b for f, b in zip(kernels, before)]
        assert grew == [device == "cuda"] * 3 + [False] * 4, (device, grew)
    (ce, ct), (ge, gt) = runs["cpu"], runs["cuda"]
    assert np.abs(ge - ce).max() <= 1e-4 * np.abs(ce).max()
    assert gt == ct


PACKED = [DataType.Q4_0, DataType.Q4_1, DataType.Q4_K, DataType.Q5_0, DataType.Q5_1,
          DataType.Q5_K, DataType.Q6_K]


def _gq(dtype, n, k, seeds, device):
    ws = [tgq.from_ggml(quants.quantize(
        np.random.default_rng(s).normal(0, 0.6, (n, k)).astype(np.float32), dtype),
        (n, k), dtype, device) for s in seeds]
    return ws[0] if len(ws) == 1 else tgq.stack(ws)


# The decode kernel (csrc/gq_decode_i8.cuh) behind both entries, every
# plane source and packing: (format, N, K), N = 48 and 4240 ragged for
# every strip width, K = 13824 two K tiles at M = 8, K = 1280 / 768 short
DECODE_CASES = [(DataType.Q5_K, 4240, 13824), (DataType.Q5_K, 48, 1280),
                (DataType.Q4_K, 48, 768), (DataType.Q6_K, 4240, 13824),
                (DataType.Q6_K, 48, 768), (DataType.Q8_0, 4240, 5120),
                (DataType.Q4_0, 48, 768), (DataType.Q5_1, 48, 1280), (DataType.Q4_1, 4240, 768)]


@pytest.mark.parametrize("dtype,n,k", DECODE_CASES,
                         ids=[f"{d.name.lower()}-{n}x{k}" for d, n, k in DECODE_CASES])
def test_decode_kernel_matches_plain(cuda_device, dtype, n, k):
    """Both decode entries at M = 1..8 on the last of two stacked layers:
    within 1e-5 of max|y| of the plain version, the same bits from a second
    launch and from the packed twin (where the format packs)."""
    w = _gq(dtype, n, k, (1, 2), cuda_device)
    if dtype == DataType.Q8_0:  # signed codes, -128 among them
        gen = torch.Generator(device=cuda_device).manual_seed(5)
        w = w._replace(**{**w.tensors(), "codes": torch.randint(
            -128, 128, w.codes.shape, generator=gen, device=cuda_device, dtype=torch.int8)})
        assert int(w.codes.min()) == -128
    kern = tgq.gq_decode if w.exact else tgq.gq_decode_generic
    wp = tgq.pack_codes(w)
    for m in range(1, 9):
        x = torch.from_numpy(np.random.default_rng(m).normal(0, 1, (m, k)).astype(np.float32))
        x = x.to(cuda_device)
        before = kern.launches
        got = kern(x, w, 1)
        torch.cuda.synchronize()
        assert kern.launches == before + 1
        assert _rel(got, tgq.qmatmul_decode_ref(x, w, 1)) <= 1e-5, m
        assert torch.equal(kern(x, w, 1), got), m
        if wp.packing != "none":
            assert torch.equal(kern(x, wp, 1), got), m


# every packable format; K = 1280 (5 x 256, no power of two) for the 5-bit
# formats, 768 otherwise; N = 300 is ragged for both column tiles
@pytest.mark.parametrize("dtype", PACKED, ids=[d.name.lower() for d in PACKED])
@pytest.mark.parametrize("m", [1, 5, 8, 40])
@pytest.mark.parametrize("stacked", [False, True], ids=["unstacked", "stacked"])
def test_packed_kernels_bit_equal_to_unpacked(cuda_device, dtype, m, stacked):
    k = 1280 if dtype in tgq.PACK5 else 768
    w = _gq(dtype, 300, k, (1, 2) if stacked else (3,), cuda_device)
    wp = tgq.pack_codes(w)
    assert wp.packing == tgq.packing_of(dtype) != "none"
    layer = 1 if stacked else None
    x = torch.from_numpy(np.random.default_rng(m).normal(0, 1, (m, k)).astype(np.float32))
    x = x.to(cuda_device)
    decode = m <= tgq.GQ_MAX_M
    kern = ((tgq.gq_decode if w.exact else tgq.gq_decode_generic) if decode
            else (tgq.gq_prefill if w.exact else tgq.gq_prefill_generic))
    plain = tgq.qmatmul_decode_ref if decode else tgq.qmatmul_prefill_ref
    before = (kern.launches, dict(kern.packed_launches))
    got = kern(x, wp, layer)
    torch.cuda.synchronize()
    assert kern.launches == before[0]
    assert kern.packed_launches == {**before[1], wp.packing: before[1][wp.packing] + 1}
    assert torch.equal(got, kern(x, w, layer))
    assert _rel(got, plain(x, wp, layer)) <= (1e-5 if decode else 1e-4)


def test_packed_refused_launches_raise(cuda_device):
    w6 = tgq.pack_codes(_gq(DataType.Q6_K, 64, 256, (0,), cuda_device))
    w5 = tgq.pack_codes(_gq(DataType.Q5_K, 64, 256, (0, 1), cuda_device))
    x = torch.zeros((1, 256), device=cuda_device)
    # the wrappers: a packing that does not fit the format, codes of the
    # wrong width, a missing high-bit plane, a layer out of range
    for bad in (tgq.GroupQuant(**{**w6.__dict__, "packing": "p5"}),
                tgq.GroupQuant(**{**w6.__dict__, "codes": w6.codes.view(torch.int8)}),
                tgq.GroupQuant(**{**w6.__dict__, "hi": None})):
        with pytest.raises(ValueError, match="packing|codes|hi"):
            tgq.gq_decode_generic(x, bad)
    with pytest.raises(IndexError, match="out of range"):
        tgq.gq_prefill(torch.zeros((9, 256), device=cuda_device), w5, 2)
    with pytest.raises(ValueError, match="takes exact-plane weights"):
        tgq.gq_decode(x, w6)
    # the C entries refuse layouts outside the packable formats: 2 high bits
    # at group size 32, 1 (or none) at group size 16, a null high-bit plane,
    # a high-bit plane beside i8 codes (hi_bits -1), a negative layer
    lib, y = _build.load(), torch.empty((1, 64), device=cuda_device)
    stream = _build.stream_ptr(cuda_device)
    l5 = w5.layer(0)
    ptr5 = (l5.codes.data_ptr(), l5.hi.data_ptr(), l5.sc6.data_ptr(), l5.mn6.data_ptr(),
            l5.d.data_ptr(), l5.dmin.data_ptr())
    for hb, hi, layer in ((2, ptr5[1], 0), (1, None, 0), (1, ptr5[1], -1), (-1, ptr5[1], 0)):
        rc = lib.mgt_gq_decode(x.data_ptr(), ptr5[0], hi, *ptr5[2:], y.data_ptr(), 1, 64, 256,
                               hb, layer, stream)
        with pytest.raises(RuntimeError, match="launch failed"):
            _build.check(rc, "mgt_gq_decode")
    xb = torch.empty((1, 256), dtype=torch.bfloat16, device=cuda_device)
    for hb in (0, 1, 3):
        rc = lib.mgt_gq_prefill_generic(
            x.data_ptr(), w6.codes.data_ptr(), w6.hi.data_ptr(), w6.a.data_ptr(),
            w6.b.data_ptr(), y.data_ptr(), 1, 64, 256, 16, hb, 0, xb.data_ptr(), None, None, 64,
            1, stream)
        with pytest.raises(RuntimeError, match="launch failed"):
            _build.check(rc, "mgt_gq_prefill_generic")


def test_packed_cpu_wrappers_count_no_launch():
    ws = [tgq.pack_codes(_gq(dt, 32, 256, (0,), "cpu"))
          for dt in (DataType.Q4_K, DataType.Q5_1, DataType.Q6_K)]
    wrappers = (tgq.gq_decode, tgq.gq_prefill, tgq.gq_decode_generic, tgq.gq_prefill_generic)
    before = [(f.launches, dict(f.packed_launches)) for f in wrappers]
    for w in ws:
        for m in (1, 8, 9, 40):
            tgq.qmatmul_group(torch.zeros(m, 256), w)
    assert [(f.launches, f.packed_launches) for f in wrappers] == before


@pytest.mark.parametrize("s,pos0", [(1, 37), (8, 130), (1, [5, 400])])
def test_flash_decode_never_reads_past_the_cursor(cuda_device, s, pos0):
    """A NaN (e4m3 0x7F) in lane 0 past its cursor, inside a 32-key block the
    kernel reads, in K and in V: the output is the one without it, bit for
    bit (the JAX kernel returns NaN there; tests/test_torch_f8_cache.py)."""
    rng = np.random.default_rng(s)
    b = 1 if isinstance(pos0, int) else len(pos0)
    ck, cv = (torch.from_numpy(rng.normal(0, 1, (2, b, 4, 512, 128)).astype(np.float32))
              .to(cuda_device, torch.float8_e4m3fn) for _ in range(2))
    q = torch.from_numpy(rng.normal(0, 1, (b, 4, s, 128)).astype(np.float32)).to(cuda_device)
    clean = tfd.flash_decode_attention(q, ck, cv, 1, pos0, 0.0884)
    at = (pos0 if isinstance(pos0, int) else pos0[0]) + s + 3
    for t in (ck, cv):
        t.view(torch.uint8)[1, 0, 2, at, 7] = 0x7F
    got = tfd.flash_decode_attention(q, ck, cv, 1, pos0, 0.0884)
    torch.cuda.synchronize()
    assert torch.isfinite(clean).all() and torch.equal(got, clean)
    torch.testing.assert_close(got, tfd.flash_decode_ref(q, ck, cv, 1, pos0, 0.0884),
                               rtol=0, atol=1e-5)


def test_packed_engine_on_card_matches_plain_versions(cuda_device, tmp_path):
    """One image chat on the Q5_K_M fixture with quant_mode="gq" (packed: p5
    q5_k, p6 q6_k): the card and the CPU give the same greedy tokens, and
    the unpacked chat's; on the card the packed p5 and p6 entries ran and no
    unpacked gq entry did."""
    rng = np.random.default_rng(7)
    model = build_container(tmp_path / "minigpt4-gq.bin", rng, llm_d=GQ_D)
    llm = build_llm_q5_k_m(tmp_path / "vicuna-q5_k_m.bin", rng)
    img = np.random.default_rng(3).integers(0, 255, (40, 50, 3), dtype=np.uint8)
    kernels = (tgq.gq_decode, tgq.gq_prefill, tgq.gq_decode_generic, tgq.gq_prefill_generic)
    runs = {}
    for device, mode in (("cpu", "gq"), ("cuda", "gq"), ("cuda", "auto")):
        before = [(f.launches, dict(f.packed_launches)) for f in kernels]
        eng = MiniGPT4Engine(model, llm, n_ctx=256, n_batch=32, device=device, quant_mode=mode)
        try:
            assert eng.gq_packed == (mode == "gq")
            emb = eng.encode_image(preprocess(img, size=eng.vision_cfg.vit.image_size))
            eng.system_prompt()
            eng.begin_chat_image(emb, "what is in the image?")
            runs[device, mode] = list(eng.generate(limit=10, params=SamplingParams(temp=0.0)))
        finally:
            eng.close()
        unpacked = [f.launches - b[0] for f, b in zip(kernels, before)]
        packed = {(f.__name__, p): f.packed_launches[p] - b[1][p]
                  for f, b in zip(kernels, before) for p in ("p4", "p5", "p6")}
        if device == "cpu":
            assert unpacked == [0] * 4 and not any(packed.values())
        elif mode == "gq":
            ran = {key for key, v in packed.items() if v}
            assert unpacked == [0] * 4 and ran == {
                ("gq_decode", "p5"), ("gq_prefill", "p5"), ("gq_decode_generic", "p6"),
                ("gq_prefill_generic", "p6")}, (unpacked, packed)
        else:
            assert all(unpacked) and not any(packed.values())
    assert runs["cuda", "gq"] == runs["cpu", "gq"] == runs["cuda", "auto"]


# ---------------------------------------------------------------------------
# the probe kernels (ops/probes.py, minigpt4_tpu_torch/tools/)
# ---------------------------------------------------------------------------

PROBE_TOL = 1e-4


def _probe_gen(device, seed):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def _group_i8_case(device, n, k, m, seed, lead=()):
    gen = _probe_gen(device, seed)
    codes = torch.randint(0, 32, (*lead, n, k), generator=gen, device=device, dtype=torch.int8)
    sct = (torch.rand((*lead, k // 32, n), generator=gen, device=device) * 0.02
           + 0.001).to(torch.bfloat16)
    bt = -(torch.rand((*lead, k // 32, n), generator=gen, device=device) * 0.1).to(
        torch.bfloat16)
    return codes, sct, bt, torch.randn((m, k), generator=gen, device=device)


def _check_group_i8(got, x, codes, sct, bt, layer=None):
    x1, x2, s1, s2 = tpb.split_activations(x)
    want = tpb.group_i8_ref(x1, x2, torch.cat([s1, s2], 1), tpb.group_sums(x), codes, sct, bt,
                            layer)
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert _rel(got, want) <= PROBE_TOL
    f64 = x.double() @ tpb.dequant_group_i8(codes, sct, bt, layer).double().t()
    assert _rel(got, f64) <= 3e-4


@pytest.mark.parametrize("stacked", [False, True], ids=["unstacked", "stacked"])
@pytest.mark.parametrize("m", range(1, 9))
def test_probe_group_i8_matches_plain(cuda_device, m, stacked):
    """The dual-i8 exact-q5_k kernel (s8 tensor cores, one MMA half at M <=
    4, two above) against its plain version (1e-4) and the f64 dequant
    reference (3e-4, the JAX probe's check), ragged N, stacked codes and
    planes at layer 1."""
    codes, sct, bt, x = _group_i8_case(cuda_device, 300, 768, m, m, (2,) if stacked else ())
    layer = 1 if stacked else None
    before = tpb.probe_group_i8.launches
    got = tpb.qmatmul_group_i8(x, codes, sct, bt, layer)
    assert tpb.probe_group_i8.launches == before + 1
    _check_group_i8(got, x, codes, sct, bt, layer)


@pytest.mark.parametrize("m", [1, 5, 8])
@pytest.mark.parametrize("n,k", [(160, 13824), (7, 1024), (1000, 2304), (5120, 256)])
def test_probe_group_i8_ragged_and_split_k(cuda_device, n, k, m):
    """Small N with a long K (a cluster of blocks splits K, rank 0 adds the
    ranks' sums), N below one tile, N whose planes start off 16-byte
    boundaries, and K of one half step."""
    codes, sct, bt, x = _group_i8_case(cuda_device, n, k, m, n + m)
    _check_group_i8(tpb.qmatmul_group_i8(x, codes, sct, bt), x, codes, sct, bt)


@pytest.mark.parametrize("m", [1, 4, 8])
@pytest.mark.parametrize("n,k", [(160, 13824), (5120, 5120)])
def test_probe_group_i8_launches_bit_equal(cuda_device, n, k, m):
    """Sums in a fixed order, no atomics: two launches give the same bits."""
    codes, sct, bt, x = _group_i8_case(cuda_device, n, k, m, 3)
    assert torch.equal(tpb.qmatmul_group_i8(x, codes, sct, bt),
                       tpb.qmatmul_group_i8(x, codes, sct, bt))


MATVEC_CASES = [(s, st, w, "nm") for s in tpb.STORAGES for st in tpb.STRATEGIES
                for w in tpb.WIDTHS if not (s == "dense" and st == "magic")]
MATVEC_CASES += [(s, st, w, "km") for s in tpb.KM_STORAGES for st in tpb.STRATEGIES
                 for w in tpb.WIDTHS if not (s == "dense" and st == "magic")]


@pytest.mark.parametrize("m", [1, 3, 8])
@pytest.mark.parametrize("storage,strategy,width,layout", MATVEC_CASES,
                         ids=["-".join(map(str, c)) for c in MATVEC_CASES])
def test_probe_dequant_matvec_matches_plain(cuda_device, storage, strategy, width, layout, m):
    """Every storage, unpack strategy, load width and layout of the
    dequantize-matvec against its plain version, N ragged against the
    blocks' columns (nm 32, km 32 V)."""
    gen = _probe_gen(cuda_device, m)
    n = 200 if layout == "nm" else 208
    w = tpb.random_probe_weight(storage, n, 2048, gen, cuda_device, layout)
    x = torch.randn((m, 2048), generator=gen, device=cuda_device)
    got = tpb.dequant_matvec(x, w, strategy, width)
    assert got.shape == (m, n) and torch.isfinite(got).all()
    assert _rel(got, tpb.dequant_matvec_ref(x, w)) <= PROBE_TOL


INT_CASES = [(mode, m) for mode in tpb.INT_MODES
             for m in range(1, (16 if mode == "s4xs4" else tpb.MAX_M) + 1)]


def _int_case(device, mode, n, k, m, seed):
    gen = _probe_gen(device, seed)
    i8 = lambda rows: torch.randint(-128, 128, (rows, k), generator=gen, device=device,
                                    dtype=torch.int8)
    s4 = lambda rows: torch.randint(0, 256, (rows, k // 2), generator=gen, device=device,
                                    dtype=torch.uint8)
    x = s4(m) if mode == "s4xs4" else i8(m)
    w = i8(n) if mode == "i8xi8" else s4(n)
    sc = (torch.rand((n, k // 256), generator=gen, device=device) + 0.5) * 2.0 ** -13
    return x, w, sc if mode == "s4_sb" else None


@pytest.mark.parametrize("mode,m", INT_CASES, ids=[f"{a}-m{b}" for a, b in INT_CASES])
def test_probe_int_dot_bit_equal(cuda_device, mode, m):
    """Every mode on the s8 tensor cores: i8 x i8 and s4 x s4 give the exact
    integers, the s4 chunk-scaled dot its plain version's bits (ragged N),
    at every M (s4 x s4 to 16: two n8 halves above 8)."""
    x, w, sc = _int_case(cuda_device, mode, 300, 1024, m, m)
    got, want = tpb.int_dot(x, w, sc, mode), tpb.int_dot_ref(x, w, sc, mode)
    assert got.dtype == want.dtype and torch.equal(got, want)


INT_SHAPE_CASES = [(mode, m, n, k) for mode in tpb.INT_MODES
                   for m in ((1, 8, 16) if mode == "s4xs4" else (1, 8))
                   for n, k in ((160, 13824), (7, 512), (1000, 2304))]


@pytest.mark.parametrize("mode,m,n,k", INT_SHAPE_CASES,
                         ids=[f"{c[0]}-m{c[1]}-{c[2]}x{c[3]}" for c in INT_SHAPE_CASES])
def test_probe_int_dot_ragged_and_split_k(cuda_device, mode, m, n, k):
    """Small N with a long K (the integer modes split K over a cluster; the
    chunk-scaled mode keeps K in one block, in chunk order), N below one
    tile, N whose scale rows start off 16-byte boundaries: bit-equal, and
    two launches give the same bits."""
    x, w, sc = _int_case(cuda_device, mode, n, k, m, n + m)
    got = tpb.int_dot(x, w, sc, mode)
    assert torch.equal(got, tpb.int_dot_ref(x, w, sc, mode))
    assert torch.equal(got, tpb.int_dot(x, w, sc, mode))


@pytest.mark.parametrize("reps", [1, 8])
@pytest.mark.parametrize("op", list(tpb.OPS))
def test_probe_op_chain_bit_equal(cuda_device, op, reps):
    """Each op chain's [8, 128 T] block and per-tile checksums equal its plain
    version's, bit for bit."""
    gen = _probe_gen(cuda_device, reps)
    dtype = tpb.OPS[op][1]
    shape = (768, 384)
    if dtype == torch.bfloat16:
        inp = torch.randn(shape, generator=gen, device=cuda_device).to(dtype)
    else:
        lo, hi = (0, 200) if dtype == torch.uint8 else (-100, 100)
        inp = torch.randint(lo, hi, shape, generator=gen, device=cuda_device, dtype=dtype)
    out, cks = tpb.op_chain(inp, op, reps)
    ref_out, ref_cks = tpb.op_chain_ref(inp, op, reps)
    assert torch.equal(out, ref_out) and torch.equal(cks, ref_cks)


def _formula_f64(x: torch.Tensor, w) -> torch.Tensor:
    """y = x @ (value * s).T in f64 on the CPU (code_values and the scales
    are exact in f64)."""
    v = tpb.code_values(w).cpu().double()
    if w.scales is not None:
        s = w.scales.cpu().double() if w.layout == "nm" else w.scales.cpu().double().t()
        v = v * s.repeat_interleave(tpb.GS, dim=1)
    return x.cpu().double() @ v.t()


def _matvec_cases(storages_nm, storages_km):
    return ([(s, "nm") for s in storages_nm] + [(s, "km") for s in storages_km])


ALL_LAYOUTS = _matvec_cases(list(tpb.STORAGES), list(tpb.KM_STORAGES))
ALL_IDS = [f"{s}-{lay}" for s, lay in ALL_LAYOUTS]


def _strategy(storage):
    return "shift" if storage == "dense" else "magic"


@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("storage,layout,n", [("i4", "nm", 1), ("i4", "nm", 7), ("q5d", "nm", 203),
                                              ("i8", "nm", 4101), ("dense", "nm", 5003),
                                              ("i4", "km", 16), ("i8", "km", 208),
                                              ("dense", "km", 4112)],
                         ids=lambda v: str(v))
def test_probe_dequant_matvec_ragged_grid(cuda_device, storage, layout, n, m):
    """N not a multiple of a tile (8 or 16 rows), a chunk (32 or 64) or the
    grid: every row is written once and holds the plain version's value."""
    gen = _probe_gen(cuda_device, n + m)
    w = tpb.random_probe_weight(storage, n, 2048, gen, cuda_device, layout)
    x = torch.randn((m, 2048), generator=gen, device=cuda_device)
    for width in tpb.WIDTHS:
        got = tpb.dequant_matvec(x, w, _strategy(storage), width)
        assert got.shape == (m, n) and torch.isfinite(got).all()
        assert _rel(got, tpb.dequant_matvec_ref(x, w)) <= PROBE_TOL


@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("storage,layout", _matvec_cases(["dense", "i8", "q5", "q5d"],
                                                         ["i8", "i4"]),
                         ids=lambda v: str(v))
def test_probe_dequant_matvec_small_n_full_k(cuda_device, storage, layout, m):
    """A few rows with the whole 13B w2 K (13824): few blocks, each block's
    warps splitting K and adding their parts in warp order."""
    gen = _probe_gen(cuda_device, m)
    n, k = (24, 13824) if layout == "nm" else (32, 13824)
    w = tpb.random_probe_weight(storage, n, k, gen, cuda_device, layout)
    x = torch.randn((m, k), generator=gen, device=cuda_device)
    got = tpb.dequant_matvec(x, w, _strategy(storage), 16)
    assert _rel(got, tpb.dequant_matvec_ref(x, w)) <= PROBE_TOL
    assert _rel(got, _formula_f64(x, w)) <= PROBE_TOL


@pytest.mark.parametrize("storage,layout", ALL_LAYOUTS, ids=ALL_IDS)
def test_probe_dequant_matvec_tensor_core_rows(cuda_device, storage, layout):
    """M = 2..7 run the M = 8 (tensor-core) instances with the unused x rows
    never read into y: each against its plain version, both strategies."""
    gen = _probe_gen(cuda_device, 11)
    w = tpb.random_probe_weight(storage, 304, 1024, gen, cuda_device, layout)
    for m in range(2, 8):
        x = torch.randn((m, 1024), generator=gen, device=cuda_device)
        for strategy in (["shift"] if storage == "dense" else list(tpb.STRATEGIES)):
            got = tpb.dequant_matvec(x, w, strategy, 16)
            assert got.shape == (m, 304)
            assert _rel(got, tpb.dequant_matvec_ref(x, w)) <= PROBE_TOL, (m, strategy)


@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("storage,layout", ALL_LAYOUTS, ids=ALL_IDS)
def test_probe_dequant_matvec_wide_x_rows(cuda_device, storage, layout, m):
    """Rows of x from 2^-20 to 2^10 (row m scaled by 2^(30 m / (M - 1) - 20)):
    each row within 1e-4 of its own max against the f64 formula, so the
    three-part split of x loses nothing on the tensor cores."""
    gen = _probe_gen(cuda_device, 5)
    k = 2048
    w = tpb.random_probe_weight(storage, 160, k, gen, cuda_device, layout)
    x = torch.randn((m, k), generator=gen, device=cuda_device)
    x = x * torch.exp2(torch.linspace(-20, 10, m, device=cuda_device))[:, None]
    got = tpb.dequant_matvec(x, w, _strategy(storage), 16).cpu().double()
    want = _formula_f64(x, w)
    for row in range(m):
        err = (got[row] - want[row]).abs().max() / want[row].abs().max()
        assert err <= PROBE_TOL, (row, float(err))


@pytest.mark.parametrize("m", [1, 5, 8])
@pytest.mark.parametrize("storage,layout", ALL_LAYOUTS, ids=ALL_IDS)
def test_probe_dequant_matvec_launches_bit_equal(cuda_device, storage, layout, m):
    """Two launches on the same inputs give the same bits: the K slices are
    added in a fixed order in both layouts (no atomics)."""
    gen = _probe_gen(cuda_device, 3)
    n, k = (5120, 2048) if layout == "nm" else (5120, 2048)
    w = tpb.random_probe_weight(storage, n, k, gen, cuda_device, layout)
    x = torch.randn((m, k), generator=gen, device=cuda_device)
    for width in tpb.WIDTHS:
        a = tpb.dequant_matvec(x, w, _strategy(storage), width)
        b = tpb.dequant_matvec(x, w, _strategy(storage), width)
        assert torch.equal(a, b)


def _op_input(op, shape, gen, device):
    dtype = tpb.OPS[op][1]
    if dtype == torch.bfloat16:
        return torch.randn(shape, generator=gen, device=device).to(dtype)
    lo, hi = (0, 200) if dtype == torch.uint8 else (-100, 100)
    return torch.randint(lo, hi, shape, generator=gen, device=device, dtype=dtype)


@pytest.mark.parametrize("reps", [1, 64])
@pytest.mark.parametrize("op", list(tpb.OPS))
def test_probe_op_chain_uneven_grid_bit_equal(cuda_device, op, reps):
    """REPS 1 and 64 over 9 tiles of 7680 columns: the persistent grid's
    ranges end inside tiles, so tiles take checksum parts from several
    blocks; the block and the checksums equal the plain version's bits."""
    gen = _probe_gen(cuda_device, reps)
    inp = _op_input(op, (2304, 7680), gen, cuda_device)
    out, cks = tpb.op_chain(inp, op, reps)
    ref_out, ref_cks = tpb.op_chain_ref(inp, op, reps)
    assert torch.equal(out, ref_out) and torch.equal(cks, ref_cks)
    out2, cks2 = tpb.op_chain(inp, op, reps, widen=False)
    assert torch.equal(out2, out) and torch.equal(cks2.to(torch.int64) & 0xFFFFFFFF, cks)


@pytest.mark.parametrize("op,c1,c2", [("i8aa", 0xD5D5D5D5, 0x81818181),
                                      ("i8aa", 0x55555555, 0x81818181),
                                      ("i8add", 0, 0x81818181), ("i8add", 0, 0x01010101)])
def test_probe_op_chain_byte_adds_any_constants(cuda_device, op, c1, c2):
    """The packed-byte adds wrap each byte for any constants: the general
    form (a constant with a top bit set) and the shorter one (none set)
    against a per-byte reference."""
    gen = _probe_gen(cuda_device, c2 & 0xFF)
    inp = _op_input(op, (512, 384), gen, cuda_device)
    code = tpb.OPS[op][0]
    out = torch.empty((8, 256), dtype=torch.float32, device=cuda_device)
    cks = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    as_int = lambda u: u - (1 << 32) if u >= 1 << 31 else u
    tpb._call("mgt_probe_op_chain", cuda_device, inp.data_ptr(), out.data_ptr(), cks.data_ptr(),
              code, 512, 384, 5, as_int(c1), as_int(c2))
    v = inp.to(torch.int32)
    for _ in range(5):
        v = ((v & (c1 & 0xFF)) if op == "i8aa" else v) + (c2 & 0xFF)
        v = ((v + 128) & 0xFF) - 128  # wrap to i8
    res = v.to(torch.int8).contiguous()
    want_out = res.reshape(2, 256, 384)[:, :8, :128].float().permute(1, 0, 2).reshape(8, 256)
    words = res.view(torch.int32).reshape(2, -1).to(torch.int64)
    assert torch.equal(out, want_out)
    assert torch.equal(cks.to(torch.int64) & 0xFFFFFFFF, words.sum(dim=1) & 0xFFFFFFFF)


def test_probe_refused_launches_raise(cuda_device):
    gen = _probe_gen(cuda_device, 0)
    w = tpb.random_probe_weight("dense", 64, 256, gen, cuda_device)
    x = torch.randn((1, 256), device=cuda_device)
    with pytest.raises(ValueError, match="shift strategy only"):
        tpb.dequant_matvec(x, w, "magic")
    with pytest.raises(ValueError, match="rows|1..8"):
        tpb.dequant_matvec(torch.randn((9, 256), device=cuda_device), w)
    with pytest.raises(ValueError, match="km layout holds"):
        tpb.random_probe_weight("q5", 64, 256, gen, cuda_device, "km")
    s4 = torch.zeros((17, 128), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError, match="out of range"):
        tpb.int_dot(s4, s4, None, "s4xs4")
    i8 = torch.zeros((9, 256), dtype=torch.int8, device=cuda_device)
    with pytest.raises(ValueError, match="out of range"):
        tpb.int_dot(i8, i8, None, "i8xi8")
    long_k = torch.zeros((1, tpb.S4_MAX_K // 2), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError, match="not below"):
        tpb.int_dot(long_k, long_k, None, "s4xs4")
    codes = torch.zeros((64, 256), dtype=torch.int8, device=cuda_device)
    planes = torch.ones((8, 64), dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="M in 1..8"):
        tpb.qmatmul_group_i8(torch.randn((9, 256), device=cuda_device), codes, planes, planes)
    with pytest.raises(ValueError, match="K % 256"):
        tpb.qmatmul_group_i8(torch.randn((1, 224), device=cuda_device), codes[:, :224],
                             planes[:7], planes[:7])
    with pytest.raises(ValueError, match="256 t"):
        tpb.op_chain(torch.zeros((100, 128), dtype=torch.int8, device=cuda_device), "i8aa")


def test_probe_cpu_wrappers_count_no_launch():
    """On CPU tensors the probe wrappers run their plain versions and count
    nothing."""
    before = {k: f.launches for k, f in tpb.WRAPPERS.items()}
    gen = _probe_gen("cpu", 0)
    w = tpb.random_probe_weight("q5d", 32, 256, gen, "cpu")
    x = torch.randn((2, 256))
    torch.testing.assert_close(tpb.dequant_matvec(x, w, "magic", 4),
                               tpb.dequant_matvec_ref(x, w), rtol=0, atol=0)
    codes = torch.randint(0, 32, (32, 256), dtype=torch.int8)
    planes = torch.ones((8, 32), dtype=torch.bfloat16)
    tpb.qmatmul_group_i8(x, codes, planes, planes)
    tpb.int_dot(torch.zeros((1, 256), dtype=torch.int8), torch.zeros((4, 256), dtype=torch.int8),
                None, "i8xi8")
    tpb.op_chain(torch.zeros((256, 128), dtype=torch.int32), "i32aa")
    assert {k: f.launches for k, f in tpb.WRAPPERS.items()} == before


def _q5k_13b_bytes(n, k, seed):
    nb = n * k // 256
    raw = np.random.default_rng(seed).integers(0, 256, (nb, 176), dtype=np.uint8)
    raw[:, 0:4] = np.frombuffer(np.full(2 * nb, 2.0 ** -15, np.float16).tobytes(),
                                np.uint8).reshape(nb, 4)
    return raw.reshape(-1)


def _q6k_13b_bytes(n, k, seed):
    nb = n * k // 256
    raw = np.random.default_rng(seed).integers(0, 256, (nb, 210), dtype=np.uint8)
    raw[:, 208:210] = np.frombuffer(np.full(nb, 2.0 ** -15, np.float16).tobytes(),
                                    np.uint8).reshape(nb, 2)
    return raw.reshape(-1)


@pytest.mark.parametrize("kernel", ["gq_decode", "rq_decode", "rq_prefill", "gq_prefill",
                                    "gq_prefill_generic"])
def test_half_rows_bit_equal_to_whole_width(cuda_device, kernel):
    """tp's column split on the card: each kernel on rows [r0, r0 + N/2) of a
    13B w13 weight (27648 x 5120; q5_k, q6_k for the generic planes) gives
    the whole-width launch's bits in those rows, for both halves and every
    row count of its path (the prefill kernel's K segments come from K
    alone, whether the launch splits them or not)."""
    n, k = 27648, 5120
    h = n // 2
    prefill_ms = (32, 256, 512)
    if kernel.startswith("gq"):
        generic = kernel == "gq_prefill_generic"
        dtype = DataType.Q6_K if generic else DataType.Q5_K
        raw = (_q6k_13b_bytes if generic else _q5k_13b_bytes)(n, k, 11)
        w = tgq.from_ggml(raw, (n, k), dtype, cuda_device)
        fn, ms = {"gq_decode": (tgq.gq_decode, (1, 8)), "gq_prefill": (tgq.gq_prefill, prefill_ms),
                  "gq_prefill_generic": (tgq.gq_prefill_generic, prefill_ms)}[kernel]
        planes = ("a", "b") if generic else ("sc6", "mn6", "d", "dmin")

        def half(r0):
            ts = {"codes": w.codes[r0:r0 + h]}
            ts.update({name: getattr(w, name)[:, r0:r0 + h] for name in planes})
            return w._replace(**{key: v.contiguous() for key, v in ts.items()})
    else:
        w = trp.from_ggml(_q5k_13b_bytes(n, k, 11), (n, k), DataType.Q5_K, cuda_device)
        fn, ms = (trq.rq_decode, (1, 8)) if kernel == "rq_decode" else (trq.rq_prefill, prefill_ms)

        def half(r0):
            return w._replace(**{key: v[r0:r0 + h].contiguous()
                                 for key, v in w.tensors().items()})
    for m in ms:
        x = torch.from_numpy(np.random.default_rng(m).normal(0, 1, (m, k)).astype(np.float32))
        x = x.to(cuda_device)
        whole = fn(x, w)
        for r0 in (0, h):
            assert torch.equal(fn(x, half(r0)), whole[:, r0:r0 + h]), (kernel, m, r0)


@pytest.mark.parametrize("kernel", ["rq_decode", "i8_decode"])
@pytest.mark.parametrize("k", [5120, 13824])
def test_decode_column_bits_do_not_depend_on_n(cuda_device, kernel, k):
    """A column of either decode kernel has the same bits whether the launch
    covers 24, 1000, 1019 or all 5120 rows of the weight (grids of 2 to 132
    blocks; the 1019 rows start off a strip boundary, so each row meets
    another lane and block), for M = 1..8 and K = 5120 and 13824 (whose
    f32 x the rq kernel tiles from M = 5 on)."""
    n = 5120
    if kernel == "rq_decode":
        w = trp.from_ggml(_q5k_13b_bytes(n, k, 5), (n, k), DataType.Q5_K, cuda_device)
        fn = trq.rq_decode

        def cut(r0, r1):
            return w._replace(**{key: v[r0:r1].contiguous() for key, v in w.tensors().items()})
    else:
        gen = torch.Generator(device=cuda_device)
        gen.manual_seed(k)
        w = ti8.I8SBQuant(torch.randint(-127, 128, (n, k), generator=gen, device=cuda_device,
                                        dtype=torch.int8),
                          2.0 ** -13 * (0.5 + torch.rand((n, k // 256), generator=gen,
                                                         device=cuda_device)), k)
        fn = ti8.i8_decode

        def cut(r0, r1):
            return ti8.I8SBQuant(w.codes[r0:r1].contiguous(), w.scales[r0:r1].contiguous(), k)
    for m in range(1, 9):
        x = torch.from_numpy(np.random.default_rng(m).normal(0, 1, (m, k)).astype(np.float32))
        x = x.to(cuda_device)
        whole = fn(x, w)
        for r0, r1 in ((0, 24), (1000, 2000), (4101, 5120)):
            assert torch.equal(fn(x, cut(r0, r1)), whole[:, r0:r1]), (kernel, m, r0)


# The prefill kernel (csrc/qmm_prefill.cuh) behind every entry, plane source
# and code storage: (entry, format, packed, N, K), N ragged for the 128-row
# weight tile, K = 96 a half step of tail; the last of two stacked layers.
PREFILL_CASES = [
    ("gq_prefill", DataType.Q5_K, False, 4224, 1280), ("gq_prefill", DataType.Q5_K, True, 48, 1280),
    ("gq_prefill", DataType.Q4_K, True, 1408, 768),
    ("gq_prefill_generic", DataType.Q6_K, False, 48, 768),
    ("gq_prefill_generic", DataType.Q6_K, True, 4224, 768),
    ("gq_prefill_generic", DataType.Q8_0, False, 1408, 768),
    ("gq_prefill_generic", DataType.Q4_0, True, 48, 768),
    ("gq_prefill_generic", DataType.Q5_1, True, 1408, 1280),
    ("gq_prefill_generic", DataType.Q2_K, False, 4224, 768),
    ("rq_prefill", DataType.Q5_K, False, 1408, 768), ("rq_prefill", DataType.Q6_K, False, 48, 768),
    ("rq_prefill", DataType.Q8_0, False, 4224, 1408), ("rq_prefill", DataType.Q4_0, False, 48, 96),
    ("rq_prefill", DataType.Q5_1, False, 1408, 96), ("rq_prefill", DataType.Q3_K, False, 48, 768),
]
PREFILL_MS = [9, 32, 100, 128, 129, 257, 512]
_prefill_weights: dict = {}


def _prefill_weight(case, device):
    if case not in _prefill_weights:
        entry, dtype, packed, n, k = case
        raws = [quants.quantize(np.random.default_rng(s).normal(0, 0.6, (n, k)).astype(np.float32),
                                dtype) for s in (1, 2)]
        if entry == "rq_prefill":
            w = trp.stack([trp.from_ggml(r, (n, k), dtype, device) for r in raws])
        else:
            w = tgq.stack([tgq.from_ggml(r, (n, k), dtype, device) for r in raws])
            w = tgq.pack_codes(w) if packed else w
        _prefill_weights.clear()  # one case at a time on the card
        _prefill_weights[case] = w
    return _prefill_weights[case]


@pytest.mark.parametrize("m", PREFILL_MS)
@pytest.mark.parametrize("case", PREFILL_CASES,
                         ids=[f"{c[0]}-{c[1].name.lower()}{'-packed' if c[2] else ''}-n{c[3]}-k{c[4]}"
                              for c in PREFILL_CASES])
def test_prefill_kernel_matches_plain(cuda_device, case, m):
    """Each prefill entry against its plain version (1e-4 of max|y|: bf16
    operands as the plain version, f32 sums in another order), and two
    launches give the same bits (split K merges in a fixed order)."""
    entry, dtype, packed, n, k = case
    w = _prefill_weight(case, cuda_device)
    x = torch.from_numpy(np.random.default_rng(m).normal(0, 1, (m, k)).astype(np.float32))
    x = x.to(cuda_device)
    if entry == "rq_prefill":
        kern, plain = trq.rq_prefill, trq.qmatmul_repacked_prefill_ref
        count = lambda: kern.launches  # noqa: E731
    else:
        kern = tgq.gq_prefill if entry == "gq_prefill" else tgq.gq_prefill_generic
        plain = tgq.qmatmul_prefill_ref
        count = lambda: kern.packed_launches[w.packing] if packed else kern.launches  # noqa: E731
    before = count()
    got = kern(x, w, 1)
    again = kern(x, w, 1)
    torch.cuda.synchronize()
    assert count() == before + 2
    assert torch.equal(got, again)
    assert _rel(got, plain(x, w, 1)) <= 1e-4
    if entry == "rq_prefill":
        assert _rel(got, trq.qmatmul_repacked_ref(x, w, 1)) <= 1e-2


# ---------------------------------------------------------------------------
# captured CUDA graphs (engine/graphs.py) against the same steps run eagerly
# ---------------------------------------------------------------------------

GRAPH_TOL = 1e-5  # same kernels in the same order: expected bit-equal


def _graph_chat(eng, emb, graphs: bool, before=None):
    """From the state ``before`` (cache, logits, cursor, tokens) or a fresh
    image turn: two greedy 16-token chunks (on a fresh engine the first runs
    eagerly and the second captures its graph at the next cursor; later
    calls replay), a sampled 8-token chunk from a generator seeded 5, and
    one single-token step; with ``graphs`` False the same steps run
    eagerly.  Returns ids, the final logits, the cache up to the cursor and
    the launch counts of the second greedy chunk."""
    eng.graphs_enabled = graphs
    st = eng._st
    if before is None:
        eng.reset()
        eng.system_prompt()
        eng.begin_chat_image(emb, "what is in the image?")
    else:
        for kv in ("k", "v"):
            st.cache[kv].copy_(before["cache"][kv])
        st.n_past, st.tokens, st.logits = before["n_past"], list(before["tokens"]), \
            before["logits"].clone()
    prefill = st.logits.clone()
    ids = eng.decode_chunk(16, SamplingParams(temp=0.0))
    c0 = counters.counts()
    ids += eng.decode_chunk(16, SamplingParams(temp=0.0))
    torch.cuda.synchronize()
    delta = {k: n - c0[k] for k, n in counters.counts().items() if n != c0[k]}
    st.generator.manual_seed(5)
    ids += eng.decode_chunk(8, SamplingParams(temp=0.8))
    eng.add_tokens([ids[-1]])
    torch.cuda.synchronize()
    return dict(ids=ids, prefill=prefill, logits=st.logits.clone(), n_past=st.n_past,
                cache={kv: t[:, :, :, :st.n_past].clone() for kv, t in st.cache.items()},
                delta=delta)


def test_captured_chat_equals_eager(cuda_device, tmp_path):
    """The gq fixture's image chat with its steps replayed from graphs and
    run eagerly: equal greedy and sampled ids, prefill and final logits and
    cache contents (within GRAPH_TOL of max|logit|; the same kernels run in
    the same order), the same launch counts for a replayed chunk as for an
    eager one, and an encoder replay equal to the eager encoder.  The first
    captured chat meets each key once (eager) or twice (captured); the
    second replays every step."""
    model, llm = build_gq_models(tmp_path)
    img = np.random.default_rng(0).integers(0, 255, (40, 50, 3), dtype=np.uint8)
    eng = MiniGPT4Engine(model, llm, n_ctx=256, n_batch=32, device=cuda_device)
    try:
        pixels = preprocess(img, size=eng.vision_cfg.vit.image_size)
        eng.graphs_enabled = False
        emb_eager = eng.encode_image(pixels)
        eng.graphs_enabled = True
        emb = eng.encode_image(pixels)  # the key's first use: eager
        assert np.array_equal(emb, eng.encode_image(pixels))  # captured
        assert np.array_equal(emb, eng.encode_image(pixels))  # a replay
        assert np.abs(emb - emb_eager).max() <= GRAPH_TOL * np.abs(emb_eager).max()
        got = _graph_chat(eng, emb, True)
        want = _graph_chat(eng, emb, False)
        # from the same cache contents, eager against a replay of each graph
        st = eng._st
        eng.graphs_enabled = True
        eng.reset()
        eng.system_prompt()
        eng.begin_chat_image(emb, "what is in the image?")
        before = dict(cache={kv: t.clone() for kv, t in st.cache.items()}, n_past=st.n_past,
                      tokens=list(st.tokens), logits=st.logits.clone())
        replayed = _graph_chat(eng, emb, True, before)
        eager = _graph_chat(eng, emb, False, before)
        stats = eng.graph_stats()
    finally:
        eng.close()
    for a, b in ((got, want), (replayed, eager), (got, replayed)):
        assert a["ids"] == b["ids"] and a["n_past"] == b["n_past"]
        for key in ("prefill", "logits"):
            assert _rel(a[key], b[key]) <= GRAPH_TOL, key
        for kv in ("k", "v"):
            assert torch.equal(a["cache"][kv], b["cache"][kv]), kv
    assert replayed["delta"] == eager["delta"] and replayed["delta"]
    assert stats["graphs"] >= 5 and stats["pool_bytes"] > 0
    assert ("decode", 1, 16, (DeviceSamplingConfig(temp=0.0),), False, None) in stats["keys"]
    assert ("decode", 1, 8, "traced", False, None) in stats["keys"]


def test_warmup_captures_without_touching_the_chat(cuda_device, tmp_path):
    """warmup() mid-chat: the graphs of the prefill buckets, the decode
    chunks 1 and 16 and the encoder are captured; the conversation's cache,
    cursor and random stream are as they were (the last positions' contents
    restored where the buckets ran past the free ones)."""
    model, llm = build_gq_models(tmp_path)
    eng = MiniGPT4Engine(model, llm, n_ctx=256, n_batch=32, device=cuda_device)
    try:
        eng.system_prompt()
        st = eng._st
        cache = {kv: t.clone() for kv, t in st.cache.items()}
        gen = st.generator.get_state()
        n_past, logits = st.n_past, st.logits.clone()
        stats = eng.warmup(prefill_buckets=(8, 32, 128, 512))
        assert st.n_past == n_past and torch.equal(st.logits, logits)
        assert torch.equal(st.generator.get_state(), gen)
        for kv in ("k", "v"):
            assert torch.equal(st.cache[kv][:, :, :, :n_past], cache[kv][:, :, :, :n_past])
        keys = set(stats["keys"])
        assert {("prefill", 8, None), ("prefill", 32, None), ("prefill", 128, 128),
                ("step", 1), ("encode", 1)} <= keys, keys
        # 512 > n_ctx: skipped; the greedy and the default sampled chunk of 16
        assert ("prefill", 512, 512) not in keys and stats["pool_bytes"] > 0
        assert sum(k[:3] == ("decode", 1, 16) for k in keys) == 2
        assert ("decode", 1, 16, "traced", False, None) in keys
    finally:
        eng.close()


def test_captured_paged_group_equals_eager(cuda_device, tmp_path):
    """A three-lane paged group (one lane sampling) replayed from graphs and
    run eagerly from copies of the same sessions: equal ids and logits, and
    the paged kernel's counter advancing on every replay by what an eager
    run launches (the group runs captured twice: the first runs its key
    eagerly, then captures it, and those eager runs launch too)."""
    model, llm = build_gq_models(tmp_path)
    pool = SessionPool(model, llm, session_ctx=256, n_ctx=256, n_batch=32,
                       paged_pool_pages=12, device=cuda_device)
    params = [SamplingParams(temp=0.0), SamplingParams(temp=0.8), SamplingParams(temp=0.0)]
    try:
        runs = {}
        for graphs in (True, True, False):
            pool.engine.graphs_enabled = graphs
            sessions = []
            for i, q in enumerate(("one two", "three four five", "six")):
                s = pool.new_session()
                pool.begin_chat(s, q)
                s.state.generator.manual_seed(100 + i)
                sessions.append(s)
            before = tfd.paged_flash_decode_attention.launches
            pool.generate_batch(sessions, limit=40, params=params, decode_chunk=8)
            torch.cuda.synchronize()
            runs[graphs] = ([s.state.tokens for s in sessions],
                            [s.state.logits for s in sessions],
                            tfd.paged_flash_decode_attention.launches - before)
            assert pool.paged_pool.free_pages == 12
        assert runs[True][0] == runs[False][0]
        for a, b in zip(runs[True][1], runs[False][1]):
            assert (a is None) == (b is None)
            if a is not None:
                assert _rel(a, b) <= GRAPH_TOL
        assert runs[True][2] == runs[False][2] > 0
        keys = set(pool._paged_graphs.graphs)
        assert ("decode", 3, 8, "traced", False, pool.paged_pool.maxp + 1) in keys, keys
    finally:
        pool.close()


def test_session_pool_warmup_then_groups_replay(cuda_device, tmp_path):
    """SessionPool.warmup captures the paged group's greedy and traced
    chunks for each lane count without writing a lane's page; a greedy and
    a mixed group afterwards replay those graphs (no new capture) and equal
    the eager groups."""
    model, llm = build_gq_models(tmp_path)
    pool = SessionPool(model, llm, session_ctx=256, n_ctx=256, n_batch=32,
                       paged_pool_pages=12, device=cuda_device)
    pages = pool.paged_pool
    try:
        k0, v0 = pages.k.clone(), pages.v.clone()
        stats = pool.warmup(lanes=(1, 2, 3), decode_chunk=8)
        real = slice(0, pages.trash_page)
        assert torch.equal(pages.k[:, real], k0[:, real])
        assert torch.equal(pages.v[:, real], v0[:, real])
        assert stats["graphs"] == 6 and stats["pool_bytes"] > 0
        for params in ([SamplingParams(temp=0.0)] * 2,
                       [SamplingParams(temp=0.0), SamplingParams(temp=0.7, top_k=5)]):
            runs = {}
            for graphs in (True, False):
                pool.engine.graphs_enabled = graphs
                sessions = []
                for i, q in enumerate(("one two", "three four five")):
                    s = pool.new_session()
                    pool.begin_chat(s, q)
                    s.state.generator.manual_seed(200 + i)
                    sessions.append(s)
                pool.generate_batch(sessions, limit=16, params=params, decode_chunk=8)
                runs[graphs] = [s.state.tokens for s in sessions]
            assert runs[True] == runs[False]
        assert len(pool._paged_graphs.graphs) == 6
        assert not pool._paged_graphs.seen
    finally:
        pool.close()


@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.bfloat16, torch.float8_e4m3fn])
def test_shift_on_card_matches_cpu(cuda_device, cache_dtype):
    """llama.shift_kv_cache on the card against its CPU run on the same bits:
    bit-equal (the rotation's cos/sin come from the host, the products and
    sums are the same f32 operations), the cache tensors written in place."""
    from minigpt4_tpu_torch.models import llama as tllama

    cfg = tllama.LlamaConfig(n_vocab=64, n_embd=128, n_head=4, n_layer=2, n_rot=32, n_ff=256,
                             n_ctx=96)
    gen = torch.Generator().manual_seed(0)
    cpu = {kv: tllama.to_cache(torch.randn((2, 1, 4, 96, 32), generator=gen) * 8, cache_dtype)
           for kv in ("k", "v")}
    card = {kv: t.to(cuda_device) for kv, t in cpu.items()}
    ptrs = {kv: t.data_ptr() for kv, t in card.items()}
    keep, drop, n_past = 11, 30, 90
    tllama.shift_kv_cache(cpu, keep, drop, n_past, cfg)
    assert tllama.shift_kv_cache(card, keep, drop, n_past, cfg) is card
    assert {kv: t.data_ptr() for kv, t in card.items()} == ptrs
    got = {kv: tllama._bits(t).cpu().long() for kv, t in card.items()}
    want = {kv: tllama._bits(t).long() for kv, t in cpu.items()}
    assert torch.equal(got["v"], want["v"]) and torch.equal(got["k"], want["k"])


def _shift_run(eng, ckpt, graphs: bool) -> dict:
    """From the checkpoint: 120 greedy ids through generate (the context
    shifts inside it) with graphs on or off; ids, shifts, the final logits
    and the cache up to the cursor."""
    eng.graphs_enabled = graphs
    eng.restore_state(ckpt)
    st, shifts, ids = eng._st, [], []
    shift, chunk = eng.ctx_shift, eng.decode_chunk

    def counted(s=None, need=0):
        d = shift(s, need)
        shifts.append((d, eng._state(s).n_past))
        return d

    def recorded(n, params, s=None):
        out = chunk(n, params, s)
        ids.extend(out)
        return out

    eng.ctx_shift, eng.decode_chunk = counted, recorded
    try:
        for _ in eng.generate(limit=120, params=SamplingParams(temp=0.0)):
            pass
    finally:
        del eng.ctx_shift, eng.decode_chunk
        eng.graphs_enabled = True
    torch.cuda.synchronize()
    return dict(ids=ids, shifts=shifts, n_past=st.n_past, tokens=list(st.tokens),
                logits=None if st.logits is None else st.logits.clone(),
                cache={kv: t[:, :, :, :st.n_past].clone() for kv, t in st.cache.items()})


def test_captured_equals_eager_after_shift_and_restore(cuda_device, tmp_path):
    """The gq fixture on the card with context_shift and n_ctx 224: from a
    saved image turn, a captured and an eager run through generate give
    bit-equal ids, shifts, cache and logits; a restore then a captured run
    again gives the same, from graph replays, and the cache tensors keep
    their storage throughout."""
    model, llm = build_gq_models(tmp_path)
    img = np.random.default_rng(0).integers(0, 255, (40, 50, 3), dtype=np.uint8)
    eng = MiniGPT4Engine(model, llm, n_ctx=224, n_batch=32, device=cuda_device,
                         context_shift=True)
    try:
        emb = eng.encode_image(preprocess(img, size=eng.vision_cfg.vit.image_size))
        eng.system_prompt()
        eng.begin_chat_image(emb, "what is in the image?")
        ckpt = tmp_path / "chat.npz"
        eng.save_state(ckpt)
        ptrs = {kv: t.data_ptr() for kv, t in eng.cache.items()}
        captured = _shift_run(eng, ckpt, True)
        eager = _shift_run(eng, ckpt, False)
        r0 = eng.graph_stats()["replays"]
        replayed = _shift_run(eng, ckpt, True)
        replays = eng.graph_stats()["replays"] - r0
        assert {kv: t.data_ptr() for kv, t in eng.cache.items()} == ptrs
    finally:
        eng.close()
    assert any(d for d, _ in captured["shifts"]) and replays > 0
    for other in (eager, replayed):
        for key in ("ids", "shifts", "n_past", "tokens"):
            assert captured[key] == other[key], key
        assert (captured["logits"] is None) == (other["logits"] is None)
        if captured["logits"] is not None:
            assert torch.equal(captured["logits"], other["logits"])
        for kv in ("k", "v"):
            assert torch.equal(captured["cache"][kv], other["cache"][kv]), kv


def test_capi_through_ctypes_runs_on_the_card(cuda_device, tmp_path, monkeypatch):
    """The C ABI library through ctypes with no MINIGPT4_TPU_DEVICE: the
    engine it loads is on the card (its kernels launch) and streams the
    tokens of an engine made here on the card."""
    import ctypes

    from minigpt4_tpu_torch.c_api import _build as capi_build

    monkeypatch.delenv("MINIGPT4_TPU_DEVICE", raising=False)
    model, llm = build_gq_models(tmp_path)
    lib = ctypes.CDLL(str(capi_build.build()))
    p, f, i32 = ctypes.c_void_p, ctypes.c_float, ctypes.c_int32
    lib.minigpt4_model_load.restype = p
    lib.minigpt4_model_load.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_bool]
    lib.minigpt4_begin_chat.argtypes = [p, ctypes.c_char_p, ctypes.c_size_t]
    lib.minigpt4_system_prompt.argtypes = [p, ctypes.c_size_t]
    lib.minigpt4_end_chat.argtypes = [p, ctypes.POINTER(ctypes.c_char_p), ctypes.c_size_t, f, i32,
                                      f, f, f, i32, f, f, f, ctypes.c_int, f, f, ctypes.c_int]
    lib.minigpt4_free.argtypes = [p]
    ctx = lib.minigpt4_model_load(str(model).encode(), str(llm).encode(), 0, 1337, 256, 32, False)
    assert ctx
    try:
        c0 = counters.counts()
        assert lib.minigpt4_system_prompt(ctx, 0) == 0
        assert lib.minigpt4_begin_chat(ctx, b"hello there", 0) == 0
        token, got = ctypes.c_char_p(), []
        for _ in range(8):
            assert lib.minigpt4_end_chat(ctx, ctypes.byref(token), 0, 0.0, 40, 0.9, 1.0, 1.0, 64,
                                         1.1, 1.0, 1.0, 0, 5.0, 1.0, 1) == 0
            got.append(token.value.decode("utf-8"))
        delta = {k: n - c0[k] for k, n in counters.counts().items()}
    finally:
        lib.minigpt4_free(ctx)
    for kernel in ("gq_decode", "gq_prefill", "flash_decode"):
        assert delta[(kernel, "launches", None)] > 0, kernel
    eng = MiniGPT4Engine(model, llm, n_ctx=256, n_batch=32, device=cuda_device)
    try:
        eng.system_prompt()
        eng.begin_chat("hello there")
        want = [eng.end_chat(SamplingParams(temp=0.0)) for _ in range(8)]
    finally:
        eng.close()
    assert got == want


def _continuous_run(pool, paged: bool, graphs: bool, warm: bool = False):
    """Three requests (one sampling, generators seeded alike) through a
    ContinuousBatcher of 4 lanes, the third joining while the others decode;
    returns each session's ids and final logits, the batcher's graph keys
    and the paged kernel's launches."""
    from minigpt4_tpu_torch.engine.sessions import ContinuousBatcher

    pool.engine.graphs_enabled = graphs
    cb = ContinuousBatcher(pool, max_batch=4, decode_chunk=8, paged=paged)
    try:
        stats = cb.warmup() if warm else None
        params = [SamplingParams(temp=0.0), SamplingParams(temp=0.8), SamplingParams(temp=0.0)]
        sessions = []
        for i, q in enumerate(("one two", "three four five", "six")):
            s = pool.new_session()
            pool.begin_chat(s, q)
            s.state.generator.manual_seed(300 + i)
            sessions.append(s)
        before = tfd.paged_flash_decode_attention.launches
        outs = [cb.submit(s, 24, p) for s, p in zip(sessions[:2], params)]
        assert isinstance(outs[0].get(timeout=300), str)  # the group decodes
        outs.append(cb.submit(sessions[2], 24, params[2]))
        for out in outs:
            while (t := out.get(timeout=300)) is not cb._DONE:
                assert not isinstance(t, Exception), t
        torch.cuda.synchronize()
        steps = cb._steps()
        return dict(ids=[list(s.state.tokens) for s in sessions],
                    logits=[s.state.logits for s in sessions],
                    keys=set(steps.graphs) if steps is not None else set(),
                    paged_launches=tfd.paged_flash_decode_attention.launches - before,
                    stats=stats)
    finally:
        cb.close()
        pool.engine.graphs_enabled = True


@pytest.mark.parametrize("paged", [True, False])
def test_captured_continuous_chunk_equals_eager(cuda_device, tmp_path, paged):
    """The continuous batcher's captured chunks (warmed up: two graphs at
    four lanes) give the eager batcher's ids for the same requests, greedy
    and sampled, a mid-flight join included, and final logits within
    GRAPH_TOL; the paged kernel runs in paged mode only."""
    model, llm = build_gq_models(tmp_path)
    pool = SessionPool(model, llm, session_ctx=256, n_ctx=256, n_batch=32,
                       paged_pool_pages=12, device=cuda_device)
    try:
        cap = _continuous_run(pool, paged, graphs=True, warm=True)
        eager = _continuous_run(pool, paged, graphs=False)
        assert cap["stats"]["graphs"] == 2 and len(cap["keys"]) == 2
        assert cap["ids"] == eager["ids"]
        for a, b in zip(cap["logits"], eager["logits"]):
            assert (a is None) == (b is None)
            if a is not None:
                assert _rel(a, b) <= GRAPH_TOL
        assert (cap["paged_launches"] > 0) == paged and (eager["paged_launches"] > 0) == paged
        assert pool.paged_pool.free_pages == 12
    finally:
        pool.close()


@pytest.mark.parametrize("paged", [True, False])
def test_continuous_server_start_captures_two_graphs(cuda_device, tmp_path, paged):
    """A continuous server of max_batch 4 captures exactly its two group
    chunks as it starts (paged over the pool, or dense over its stacked
    cache), and answers a chat."""
    import json
    import threading
    import urllib.request

    from minigpt4_tpu_torch import serve

    model, llm = build_gq_models(tmp_path)
    httpd = serve.start_server(model, llm, port=0, session_ctx=256, n_ctx=256, n_batch=32,
                               continuous=True, max_batch=4, park_idle=True,
                               paged_pages=12 if paged else None, device="cuda")
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        assert httpd.warmup["graphs"] == 2 and httpd.batcher.paged == paged
        with urllib.request.urlopen(urllib.request.Request(
                base + "/v1/sessions", data=b"", method="POST"), timeout=60) as r:
            sid = json.loads(r.read())["session_id"]
        with urllib.request.urlopen(urllib.request.Request(
                f"{base}/v1/sessions/{sid}/chat", method="POST", data=json.dumps(
                    {"message": "hi", "limit": 8, "temp": 0.0}).encode()), timeout=300) as r:
            assert isinstance(json.loads(r.read())["text"], str)
        assert len(httpd.batcher._steps().graphs) == 2
        assert httpd.pool._sessions[sid].state.parked is not None
    finally:
        httpd.shutdown()
        httpd.server_close()
        httpd.pool.close()


@pytest.mark.parametrize("stage_bytes", [4096, 32 << 20])
def test_staged_host_copies_bit_equal(cuda_device, monkeypatch, stage_bytes):
    """Cache rows to pageable host memory and back through the page-locked
    staging buffers (``engine/hostcopy.py``), in many pieces and in one:
    bit-equal both ways into strided views, the host copy not page-locked."""
    from minigpt4_tpu_torch.engine import hostcopy

    monkeypatch.setattr(hostcopy, "_STAGE", hostcopy._Stage(stage_bytes))
    g = torch.Generator(device="cpu").manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16, torch.float8_e4m3fn):
        cache = torch.randn((3, 1, 4, 64, 16), generator=g).to(dtype).to(cuda_device)
        rows = _bits(cache[:, :, :, :37])
        host = hostcopy.host_copy(rows)
        assert host.device.type == "cpu" and not host.is_pinned()
        assert torch.equal(host, rows.cpu())
        back = torch.zeros_like(cache)
        hostcopy.copy_from_host_(_bits(back)[:, :, :, :37], host)
        assert torch.equal(_bits(back)[:, :, :, :37], rows)
        assert not _bits(back)[:, :, :, 37:].any()
        logits = torch.randn(1000, generator=g).to(cuda_device)
        assert torch.equal(hostcopy.host_copy(logits), logits.cpu())


@pytest.mark.parametrize("cache_dtype", ["f32", "bf16", "f8"])
def test_park_and_prefix_hit_on_card_bit_equal(cuda_device, tmp_path, cache_dtype):
    """On the card: a radix hit installs the rows and logits of the system
    prompt's prefill bit for bit into the session's own cache tensors; a
    park moves rows [0, n_past) to host memory and ensure_device
    brings them back bit for bit; admit_host fills the pages admit fills."""
    model, llm = build_gq_models(tmp_path)
    pool = SessionPool(model, llm, session_ctx=256, n_ctx=256, n_batch=32, paged_pool_pages=8,
                       device=cuda_device, cache_dtype=cache_dtype)
    bits = _bits
    try:
        a, b = pool.new_session(), pool.new_session()
        pool.system_prompt(a)
        ptr = b.state.cache["k"].data_ptr()
        pool.system_prompt(b)
        n = a.n_past
        assert pool.metrics["prefix_cache_hits"] == 1 and b.state.cache["k"].data_ptr() == ptr
        for kv in ("k", "v"):
            assert torch.equal(bits(a.state.cache[kv][:, :, :, :n]),
                               bits(b.state.cache[kv][:, :, :, :n]))
        assert torch.equal(a.state.logits, b.state.logits)
        rows = {kv: bits(t[:, :, :, :n]).clone() for kv, t in a.state.cache.items()}
        a.park()
        assert a.state.parked["k"].device.type == "cpu" and a.state.parked["k"].shape[3] == n
        pages = pool.paged_pool.admit_host(a.state.parked, n)
        twin = pool.paged_pool.admit(b.state.cache, n)
        for kv in ("k", "v"):
            t = bits(getattr(pool.paged_pool, kv))
            assert torch.equal(t[:, pages], t[:, twin])
        pool.paged_pool.free(pages + twin)
        with pool._lock:
            a.state.ensure_device()
        for kv in ("k", "v"):
            assert torch.equal(bits(a.state.cache[kv][:, :, :, :n]), rows[kv])
        assert a.state.logits.is_cuda and torch.equal(a.state.logits, b.state.logits)
    finally:
        pool.close()


def _gq_decoder(llm, device):
    from minigpt4_tpu_torch.formats import LlamaFileReader
    from minigpt4_tpu_torch.models import llama as tllama

    with LlamaFileReader(llm) as r:
        return tllama.load_params(r, torch.float32, n_ctx=256, device=device)


@pytest.mark.parametrize("lanes", [1, 2])
@pytest.mark.parametrize("k", [2, 4, 8])
def test_verify_span_on_card_matches_plain(cuda_device, tmp_path, k, lanes):
    """An S = k speculative verify span from per-row cursors (lane 0 at
    124 crosses a page edge for k > 4) over a cache of random history,
    kernel by kernel at the span's shapes on the gq fixture: the fixture's
    fused wqkv through gq decode at M = lanes * k <= 8 (1e-5 of max|y|) or
    gq prefill above it (1e-4), dense and paged flash decode at S = k
    against their plain versions (1e-5 absolute), the paged kernel with the
    dense kernel's bits.  Then the whole forward of the span: paged equal
    to dense bit for bit on the card, and within 1e-2 of max|logit| of the
    CPU's plain forward (the composed path: 1.0e-3 to 3.1e-3 on an H100 80GB
    HBM3 at 700 W, over f32 and bf16 caches alike), with the flash kernels
    launched once per layer and no launch on the CPU."""
    from minigpt4_tpu_torch.models import llama as tllama

    _, llm = build_gq_models(tmp_path)
    pos = [124, 40][:lanes]
    ids = torch.from_numpy(np.random.default_rng(k).integers(3, 250, (lanes, k)))
    out = {}
    for device in ("cpu", cuda_device):
        params, cfg = _gq_decoder(llm, device)
        g = torch.Generator().manual_seed(0)
        shape = (cfg.n_layer, lanes, cfg.n_head, cfg.n_ctx, cfg.head_dim)
        dense = {kv: (torch.randn(shape, generator=g) * 0.5).to(device) for kv in "kv"}
        table = torch.tensor([[1, 2, 4], [3, 0, 4]], dtype=torch.int32)[:lanes].to(device)
        pools = {kv: torch.zeros((cfg.n_layer, 5, cfg.n_head, 128, cfg.head_dim), device=device)
                 for kv in "kv"}
        for kv in "kv":
            for lane in range(lanes):
                for slot in range(2):
                    pools[kv][:, table[lane, slot]] = dense[kv][:, lane, :,
                                                                slot * 128:(slot + 1) * 128]
        out[str(device)] = (params, cfg, dense, pools, table)
    params, cfg, dense, pools, table = out[str(cuda_device)]
    # the kernels at the span's shapes
    x = torch.from_numpy(np.random.default_rng(k + 10 * lanes).normal(
        0, 1, (lanes * k, cfg.n_embd)).astype(np.float32)).to(cuda_device)
    w = params["layers"]["wqkv"]["w"]
    m_small = lanes * k <= tgq.GQ_MAX_M
    kern, plain = ((tgq.gq_decode, tgq.qmatmul_decode_ref) if m_small
                   else (tgq.gq_prefill, tgq.qmatmul_prefill_ref))
    assert _rel(kern(x, w, 1), plain(x, w, 1)) <= (1e-5 if m_small else 1e-4)
    q = torch.from_numpy(np.random.default_rng(k).normal(
        0, 1, (lanes, cfg.n_head, k, cfg.head_dim)).astype(np.float32)).to(cuda_device)
    cur = torch.tensor(pos, dtype=torch.int32, device=cuda_device)
    scale = cfg.head_dim ** -0.5
    got = tfd.flash_decode_attention(q, dense["k"], dense["v"], 1, cur, scale)
    torch.testing.assert_close(got, tfd.flash_decode_ref(q, dense["k"], dense["v"], 1, cur, scale),
                               rtol=0, atol=1e-5)
    paged = tfd.paged_flash_decode_attention(q, pools["k"], pools["v"], 1, cur, table, scale)
    torch.testing.assert_close(paged, tfd.paged_flash_decode_ref(
        q, pools["k"], pools["v"], 1, cur, table, scale), rtol=0, atol=1e-5)
    assert torch.equal(paged, got)
    # the whole span, dense and paged, on both devices
    logits = {}
    for device in ("cpu", cuda_device):
        params, cfg, dense, pools, table = out[str(device)]
        emb = tllama.embed_tokens(params, ids.to(device))
        before = counters.counts()
        a = tllama.forward(params, dense, emb, pos, cfg, all_logits=True)
        b = tllama.forward(params, pools, emb, torch.tensor(pos, dtype=torch.int32, device=device),
                           cfg, all_logits=True, page_table=table)
        delta = {key[0]: n - before.get(key, 0) for key, n in counters.counts().items()
                 if key[1] == "launches" and n != before.get(key, 0)}
        assert torch.equal(a, b)
        logits[str(device)] = (a, delta)
    (cg, cd), (gg, gd) = logits["cpu"], logits[str(cuda_device)]
    assert cd == {}
    assert gd["flash_decode"] == gd["paged_flash_decode"] == cfg.n_layer
    assert gd["gq_decode" if m_small else "gq_prefill"] > 0
    assert _rel(gg, cg) <= 1e-2


def test_speculative_engine_on_card_equals_plain_greedy(cuda_device, tmp_path, monkeypatch):
    """The gq fixture's image chat on the card with speculative_k = 8: the
    n-gram dispatch replays a captured graph from its second use (its key in
    graph_stats), and the captured, eager and plain chats give the same
    greedy ids.  A sampled stream (temp 0.8, top-k 40) gives the same ids
    captured as eager from the same generator state, and its spec_stoch
    graph replays.  With the model's own file as its drafter the drafts
    hold (more than 2 tokens per pass) and the ids are plain greedy's."""
    import minigpt4_tpu_torch.engine.engine as engine_mod

    model, llm = build_gq_models(tmp_path)
    img = np.random.default_rng(0).integers(0, 255, (40, 50, 3), dtype=np.uint8)
    greedy, sampled = SamplingParams(temp=0.0), SamplingParams(temp=0.8, top_k=40)
    runs, stoch = {}, {}
    dispatches = []  # (verify passes, tokens emitted) of each drafted dispatch
    real_draft = engine_mod._draft_chunk

    def rec(e, dfns, st, n_passes, k):
        ids = real_draft(e, dfns, st, n_passes, k)
        dispatches.append((n_passes, len(ids)))
        return ids

    monkeypatch.setattr(engine_mod, "_draft_chunk", rec)
    eng = MiniGPT4Engine(model, llm, n_ctx=256, n_batch=32, device=cuda_device, speculative_k=8)
    try:
        emb = eng.encode_image(preprocess(img, size=eng.vision_cfg.vit.image_size))

        def turn(graphs: bool) -> None:
            eng.graphs_enabled = graphs
            eng.reset()
            eng.system_prompt()
            eng.begin_chat_image(emb, "what is in the image?")

        for name, k, graphs in (("plain", 0, True), ("eager", 8, False), ("captured", 8, True),
                                ("replayed", 8, True)):
            turn(graphs)
            runs[name] = list(eng.generate(limit=48, params=greedy, speculative_k=k))
        for name, graphs in (("eager", False), ("captured", True), ("replayed", True)):
            turn(graphs)
            eng._st.generator.manual_seed(7)
            replays = eng.graph_stats()["replays"]
            ids = list(eng.generate(limit=32, params=sampled))
            stoch[name] = (ids, eng.graph_stats()["replays"] - replays)
        stats = eng.graph_stats()
        eng.set_drafter(draft_llm_path=llm)
        turn(True)
        drafted = list(eng.generate(limit=48, params=greedy))
    finally:
        eng.close()
    assert runs["eager"] == runs["plain"] == runs["captured"] == runs["replayed"]
    assert any(key[0] == "spec" and key[3] == 8 for key in stats["keys"])
    assert stoch["eager"][0] and all(isinstance(t, str) for t in stoch["eager"][0])
    assert stoch["captured"][0] == stoch["eager"][0] == stoch["replayed"][0]
    assert any(key[0] == "spec_stoch" and key[3] == 8 for key in stats["keys"])
    assert stoch["replayed"][1] > 0  # every graph replayed is a spec_stoch one
    assert drafted == runs["plain"]
    assert sum(n for _, n in dispatches) > 2 * sum(p for p, _ in dispatches)


def test_speculative_batch_on_card_equals_plain(cuda_device, tmp_path):
    """Three greedy sessions decoded as a paged group and by the continuous
    batcher with speculative_k = 4 on the card: the plain group's text."""
    from minigpt4_tpu_torch.engine.sessions import ContinuousBatcher

    model, llm = build_gq_models(tmp_path)
    texts = {}
    for k in (0, 4):
        pool = SessionPool(model, llm, session_ctx=256, n_ctx=256, n_batch=32,
                           paged_pool_pages=8, device=cuda_device, speculative_k=k)
        try:
            ss = []
            for q in ("one two three", "four five", "six seven eight nine"):
                s = pool.new_session()
                pool.begin_chat(s, q)
                ss.append(s)
            group = pool.generate_batch(ss, limit=24, params=SamplingParams(temp=0.0),
                                        decode_chunk=8)
            for s, q in zip(ss, ("again", "more", "and")):
                pool.begin_chat(s, q)
            cb = ContinuousBatcher(pool, max_batch=4, decode_chunk=8)
            try:
                outs = [cb.submit(s, 24, SamplingParams(temp=0.0)) for s in ss]
                cont = []
                for q in outs:
                    toks = []
                    while (item := q.get(timeout=300)) is not ContinuousBatcher._DONE:
                        assert not isinstance(item, Exception), item
                        toks.append(item)
                    cont.append("".join(toks))
            finally:
                cb.close()
            texts[k] = (group, cont)
        finally:
            pool.close()
    assert texts[4] == texts[0]


def _train_files(tmp_path, kind: str):
    """The tiny dense fixture (``kind`` "tiny") or the Q5_K one ("gq")."""
    from fixtures import build_tiny_models

    return (build_tiny_models if kind == "tiny" else build_gq_models)(tmp_path)


def _train_models(files, device, quant_mode: str = "auto"):
    """(frozen, proj, vision cfg, llm cfg) of ``files`` on ``device``, the
    decoder in ``quant_mode``; proj is the container's llama_proj as leaves
    that require grad."""
    from minigpt4_tpu_torch.formats import ContainerReader, LlamaFileReader
    from minigpt4_tpu_torch.models import llama as tllama
    from minigpt4_tpu_torch.models import minigpt4 as tvision

    model, llm = files
    with ContainerReader(model) as r:
        vp, vcfg = tvision.load_params(r, torch.float32, device)
    with LlamaFileReader(llm) as r:
        lp, lcfg = tllama.load_params(r, torch.float32, n_ctx=64, device=device,
                                      quant_mode=quant_mode)
    proj = {k: v.detach().clone().requires_grad_() for k, v in vp.pop("llama_proj").items()}
    return {"vision": vp, "llm": lp}, proj, vcfg, lcfg


def _caption_grads(frozen, proj, vcfg, lcfg, t: int, device):
    from minigpt4_tpu_torch.train import caption_loss

    rng = np.random.default_rng(t)
    vs = vcfg.vit.image_size
    pixels = torch.from_numpy(rng.normal(size=(2, 3, vs, vs)).astype(np.float32)).to(device)
    tokens = torch.from_numpy(rng.integers(1, lcfg.n_vocab, (2, t))).to(device)
    mask = torch.ones((2, t), device=device)
    loss = caption_loss(proj, frozen, pixels, tokens, mask, vcfg, lcfg)
    return loss.detach().cpu(), [g.cpu() for g in torch.autograd.grad(loss, list(proj.values()))]


@pytest.mark.parametrize("kind,mode,t", [("tiny", "auto", 6), ("tiny", "auto", 40),
                                         ("gq", "qtensor", 6), ("gq", "qtensor", 40)])
def test_caption_loss_grads_on_card_equal_cpu(cuda_device, tmp_path, kind, mode, t):
    """The projection's gradients on the card, through the plain attention
    of S <= 32 rows (T = 6) and the prefill attention over an f32 cache (T =
    40), dense and qtensor decoders, equal the CPU's within 1e-5 of
    max|grad| (f32 sums in other orders), the loss within 1e-5 relative;
    no kernel launches on the way."""
    files, out = _train_files(tmp_path, kind), {}
    for device in ("cpu", cuda_device):
        models = _train_models(files, device, mode)
        counters.reset()
        out[str(device)] = _caption_grads(*models, t, device)
        assert all(n == 0 for n in counters.counts().values()), counters.counts()
    (l_cpu, g_cpu), (l_card, g_card) = out["cpu"], out[str(cuda_device)]
    assert abs(float(l_card) - float(l_cpu)) <= 1e-5 * abs(float(l_cpu))
    for a, b in zip(g_card, g_cpu):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


def test_forward_without_flash_launches_no_kernel(cuda_device, tmp_path):
    """``forward(use_flash=False)`` at S = 10 launches no flash kernel and
    gives the flash path's logits within 1e-5 of max|logit|; the default
    launches it once per layer; and a flash launch on a q that requires grad
    raises instead of cutting the graph (the Q5_K fixture as qtensor: head
    dim 64, which the flash kernel serves, and no matmul kernel)."""
    from minigpt4_tpu_torch.models import llama as tllama

    frozen, _, _, cfg = _train_models(_train_files(tmp_path, "gq"), cuda_device, "qtensor")
    p = frozen["llm"]
    ids = torch.from_numpy(np.random.default_rng(1).integers(3, 250, (2, 10))).to(cuda_device)
    emb = tllama.embed_tokens(p, ids)
    counters.reset()
    plain = tllama.forward(p, tllama.init_cache(cfg, 2, torch.float32, cuda_device), emb, 0, cfg,
                           all_logits=True, use_flash=False)
    assert tfd.flash_decode_attention.launches == 0
    flash = tllama.forward(p, tllama.init_cache(cfg, 2, torch.float32, cuda_device), emb, 0, cfg,
                           all_logits=True)
    assert tfd.flash_decode_attention.launches == cfg.n_layer
    assert float((plain - flash).abs().max()) <= 1e-5 * float(flash.abs().max())
    with pytest.raises(RuntimeError, match="no backward"):
        tllama.forward(p, tllama.init_cache(cfg, 2, torch.float32, cuda_device),
                       emb.detach().requires_grad_(), 0, cfg)


@pytest.mark.parametrize("mode", ["gq", "repack", "w8a8"])
def test_trainer_refuses_kernel_weights_on_card(cuda_device, tmp_path, mode):
    """A gq, repacked or w8a8 decoder on the card is refused before any
    forward, naming qtensor; its kernels raise on an input that requires
    grad rather than leave the graph."""
    from minigpt4_tpu_torch.models.params import linear

    frozen, proj, vcfg, lcfg = _train_models(_train_files(tmp_path, "gq"), cuda_device, mode)
    counters.reset()
    with pytest.raises(NotImplementedError, match="qtensor"):
        _caption_grads(frozen, proj, vcfg, lcfg, 6, cuda_device)
    assert all(n == 0 for n in counters.counts().values())
    x = torch.randn((3, lcfg.n_embd), device=cuda_device, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        linear(x, frozen["llm"]["layers"]["wqkv"], 0)
    with torch.no_grad():
        assert linear(x, frozen["llm"]["layers"]["wqkv"], 0).shape == (3, 3 * lcfg.n_embd)


# -- tensor parallelism over 2 ranks on the card (gloo, cuda:0) ----------------

def test_sharded_encoder_on_card_equals_whole(cuda_device, tmp_path):
    """The ViT split over 2 ranks on cuda:0 (``parallel/sharding.py``) on a
    q4_0 container: qkv and fc1 column-parallel as repacked weights at the
    local shapes (their kernels launch), proj and fc2 whole (a repacked row
    slot stays whole); the embedding equals the whole encoder's on the card
    within 1e-5 of max|emb| (a column shard gives the whole launch's bits in
    its rows; the f32 attention and sums are the same), on both ranks."""
    from minigpt4_tpu_torch.parallel import dryrun
    from torch_rank_tasks import rank_tasks

    model, _ = dryrun.write_models(tmp_path, quant=DataType.Q4_0, d=256)
    pixels = np.random.default_rng(2).normal(0, 1, (2, 3, 28, 28)).astype(np.float32)
    task = ("enc", "fn", dict(fn="sharded_encoder", model=str(model), pixels=pixels))
    ranks = dryrun.run_ranks(rank_tasks, 2, ([task],), device="cuda", timeout_s=300)
    for r in ranks:
        e = r["enc"]
        assert e["kinds"] == {"qkv": "col", "fc1": "col", "proj": "rep", "fc2": "rep"}
        assert _rel(torch.from_numpy(e["emb"]), torch.from_numpy(e["whole"])) <= 1e-5
        assert sum(e["launches"][(k, "launches", None)] for k in ("rq_decode", "rq_prefill")) > 0
    np.testing.assert_array_equal(ranks[0]["enc"]["emb"], ranks[1]["enc"]["emb"])


def test_sharded_train_step_on_card_equals_cpu(cuda_device, tmp_path):
    """One Adam step of ``llama_proj`` over tp = 2 ranks on cuda:0 through
    the sharded encoder and decoder (the f32 fixture): the loss within 1e-5
    relative and the gradient within 1e-4 of max|grad| of the CPU's at
    tp = 1, and no kernel launched (the trainers run plain torch)."""
    from fixtures import build_tiny_models
    from minigpt4_tpu_torch.parallel import dryrun
    from minigpt4_tpu_torch.train.projection import make_train_step
    from torch_rank_tasks import rank_tasks
    from torch_tp_tasks import load

    model, llm = map(str, build_tiny_models(tmp_path))
    rng = np.random.default_rng(3)
    batch = dict(pixels=rng.normal(0, 1, (2, 3, 28, 28)).astype(np.float32),
                 tokens=np.concatenate([np.ones((2, 1), np.int64),
                                        rng.integers(3, 262, (2, 5))], axis=1),
                 mask=np.ones((2, 6), np.float32))
    task = ("step", "fn", dict(fn="train_step_tp", model=model, llm=llm, device="cuda", **batch))
    ranks = dryrun.run_ranks(rank_tasks, 2, ([task],), device="cuda", timeout_s=300)
    vp, vcfg, lp, lcfg = load(model, llm, "cpu", n_ctx=64)
    proj = {k: v.detach().clone().requires_grad_(True) for k, v in vp["llama_proj"].items()}
    frozen = {"vision": {k: v for k, v in vp.items() if k != "llama_proj"}, "llm": lp}
    step = make_train_step(vcfg, lcfg, torch.optim.Adam(list(proj.values()), lr=1e-3))
    _, loss = step(proj, frozen, *(torch.from_numpy(batch[k]) for k in ("pixels", "tokens",
                                                                         "mask")))
    for r in ranks:
        got = r["step"]
        assert abs(got["loss"] - float(loss)) <= 1e-5 * abs(float(loss))
        for k, v in proj.items():
            assert _rel(torch.from_numpy(got["grad"][k]), v.grad) <= 1e-4, k
        assert all(n == 0 for n in got["launches"].values()), got["launches"]


def test_kernel_gate_fast_sweep_passes(cuda_device):
    """minigpt4_tpu_torch.kernel_gate --fast through the kernels: every
    case of the worst-K 13B shapes (w2, w13) within its bound, and the K
    shards of tensor parallelism."""
    from minigpt4_tpu_torch import kernel_gate as kg

    report = []
    assert kg.run_gate(fast=True, report=report, out=None), [
        r["tag"] for r in report if not r["ok"]]
    assert len(report) == len(kg.gate_cases(fast=True))
    tp = []
    assert kg.run_tp_gate(report=tp, out=None), [r["tag"] for r in tp if not r["ok"]]


def _tree_to(tree, device):
    """A decoder tree with every tensor (and every quantized weight's) on ``device``."""
    import dataclasses

    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return dataclasses.replace(tree, **{k: v.to(device) for k, v in tree.tensors().items()})


@pytest.mark.parametrize("pack", [False, True])
def test_synthetic_gq_teacher_on_card(cuda_device, pack):
    """benchmark.synth_llama_params at the tiny geometry in gq mode: built on
    the card it equals the CPU build of the same seed in everything drawn
    from NumPy (the embedding, the rng's state) and in every form and
    constant; a 16-row prefill and a decode step on the card (gq_prefill,
    gq_decode, flash decode) are within 1e-3 of max|logit| of the CPU's
    plain versions on the card's weights."""
    from minigpt4_tpu_torch import benchmark as B
    from minigpt4_tpu_torch.models import llama as tllama

    cfg = B.GEOMETRIES["tiny"]
    trees, rngs = {}, {}
    for dev in ("cpu", "cuda"):
        rngs[dev] = np.random.default_rng(0)
        trees[dev] = B.synth_llama_params(cfg, DataType.Q5_K, rngs[dev], quant_mode="gq",
                                          device=dev, pack=pack)
    assert rngs["cpu"].integers(0, 2**31) == rngs["cuda"].integers(0, 2**31)
    cpu, card = trees["cpu"], trees["cuda"]
    assert torch.equal(card["tok_embeddings"].cpu(), cpu["tok_embeddings"])
    for name in ("wqkv", "wo", "w13", "w2"):
        a, b = card["layers"][name]["w"], cpu["layers"][name]["w"]
        assert a.packing == b.packing == ("p5" if pack else "none")
        assert {k: (v.shape, v.dtype) for k, v in a.tensors().items()} == {
            k: (v.shape, v.dtype) for k, v in b.tensors().items()}
        assert torch.equal(a.d.cpu(), b.d) and torch.equal(a.dmin.cpu(), b.dmin)
    plain = _tree_to(card, "cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.n_vocab, (1, 17)))
    out = {}
    before = (tgq.gq_decode.launches + sum(tgq.gq_decode.packed_launches.values()),
              tgq.gq_prefill.launches + sum(tgq.gq_prefill.packed_launches.values()),
              tfd.flash_decode_attention.launches)
    for dev, params in (("cpu", plain), ("cuda", card)):
        cache = tllama.init_cache(cfg, 1, torch.bfloat16, dev)
        t = toks.to(dev)
        pre = tllama.forward(params, cache, tllama.embed_tokens(params, t[:, :16]), 0, cfg)
        step = tllama.forward(params, cache, tllama.embed_tokens(params, t[:, 16:]), 16, cfg)
        out[dev] = (pre.cpu(), step.cpu())
    after = (tgq.gq_decode.launches + sum(tgq.gq_decode.packed_launches.values()),
             tgq.gq_prefill.launches + sum(tgq.gq_prefill.packed_launches.values()),
             tfd.flash_decode_attention.launches)
    assert all(a > b for a, b in zip(after, before)), (before, after)
    for got, want in zip(out["cuda"], out["cpu"]):
        assert torch.isfinite(got).all()
        assert (got - want).abs().max() <= 1e-3 * want.abs().max()


def test_bench_decode_on_card_has_the_cpu_keys(cuda_device, monkeypatch):
    """benchmark.bench_decode, every section, at the JAX test's smoke
    geometry on the card (its steps replayed as CUDA graphs where the engine
    captures them): the keys of the same run on the CPU, no section error,
    every rate finite and positive, and the card named."""
    from minigpt4_tpu_torch import benchmark as B
    from minigpt4_tpu_torch.models.llama import LlamaConfig

    monkeypatch.setitem(B.GEOMETRIES, "emit_smoke", LlamaConfig(
        n_vocab=512, n_embd=256, n_head=4, n_layer=2, n_rot=64, n_ff=512, n_ctx=128))
    run = dict(n_decode=8, prefill_len=8, dtype=torch.float32, cache_dtype=torch.float32,
               batch=2)
    cpu = B.bench_decode("emit_smoke", DataType.Q5_K, device="cpu", **run)
    card = B.bench_decode("emit_smoke", DataType.Q5_K, device="cuda", **run)
    assert set(card) == set(cpu)
    assert not [k for k in card if k.endswith("_error")]
    assert card["device"] != "cpu"
    rates = {k: v for k, v in card.items() if "tok_s" in k or k.endswith("_ms")}
    assert rates and all(np.isfinite(v) and v > 0 for v in rates.values())


def test_kernel_floors_hold_on_card(cuda_device):
    """kernel_gate.run_floors("check") against the committed
    kernel_floors.json: every decode kernel within FLOOR_MARGIN of its
    recorded ratio to a dense bf16 matvec."""
    from minigpt4_tpu_torch import kernel_gate as kg

    report = []
    assert kg.FLOORS_PATH.exists()
    assert kg.run_floors("check", report=report, out=None), report
    assert [r["name"] for r in report] == list(kg.FLOOR_SHAPES)


def test_synth_vision_params_drawn_on_card(cuda_device):
    """benchmark.synth_vision_params on the card draws its normals there from
    one draw of rng: the CPU tree's structure, shapes and constants, on the
    card, std 0.02 (0.5 for the query tokens), and the rng one draw on."""
    from minigpt4_tpu_torch import benchmark as B
    from minigpt4_tpu_torch.models import minigpt4 as tvision
    from minigpt4_tpu_torch.models.eva_vit import ViTConfig
    from minigpt4_tpu_torch.models.qformer import QFormerConfig

    cfg = tvision.VisionConfig(
        vit=ViTConfig(image_size=28, patch_size=14, embed_dim=64, depth=2, head_dim=16,
                      mlp_dim=128),
        qformer=QFormerConfig(hidden_size=32, n_heads=2, n_layers=2, encoder_width=64,
                              query_length=4, intermediate_size=64), llama_embed_dim=48)
    r_cpu, r_card = np.random.default_rng(3), np.random.default_rng(3)
    cpu = B.synth_vision_params(cfg, r_cpu, torch.float32, "cpu")
    card = B.synth_vision_params(cfg, r_card, torch.float32, "cuda")
    r_ref = np.random.default_rng(3)
    r_ref.integers(0, 2**31)
    assert r_card.integers(0, 2**31) == r_ref.integers(0, 2**31)

    def leaves(tree, path=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, f"{path}.{k}")
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                yield from leaves(v, f"{path}[{i}]")
        else:
            yield path, tree

    a, b = dict(leaves(card)), dict(leaves(cpu))
    assert a.keys() == b.keys()
    for path, t in a.items():
        assert t.device.type == "cuda" and (t.shape, t.dtype) == (b[path].shape, b[path].dtype)
        if path.endswith((".b", "cls_token")) or path.endswith(".g"):
            assert torch.equal(t.cpu(), b[path]), path  # zeros and ones, not drawn
        elif t.numel() >= 1024:
            std = 0.5 if "query_tokens" in path else 0.02
            assert abs(float(t.std()) / std - 1) < 0.1, path


def _tiny_tool_args(mod, argv):
    return mod.parse_args(argv + ["--device", "cuda"])


def test_paged_capacity_probe_on_card(cuda_device):
    """tools/probe_paged_capacity.run at the tiny geometry in w8a8 over e4m3
    pools, 2 and 12 lanes and the speculative arm at 2: no error line, the
    plain chunks and the verify passes replayed from captured graphs,
    i8_decode, i8_prefill (12 decode rows) and the paged flash kernel
    launched."""
    from minigpt4_tpu_torch import benchmark as B
    from minigpt4_tpu_torch.tools import probe_paged_capacity as cap

    cfg = B.GEOMETRIES["tiny"]
    params = B.synth_llama_params(cfg, DataType.Q5_K, np.random.default_rng(0),
                                  quant_mode="w8a8", device="cuda")
    counters.reset()
    plain = cap.run(params, cfg, _tiny_tool_args(cap, ["--lanes", "2,12", "--steps", "1"]))
    spec = cap.run(params, cfg, _tiny_tool_args(cap, ["--lanes", "2", "--spec-k", "8",
                                                      "--steps", "1"]))
    assert [ln["lanes"] for ln in plain] == [2, 12] and [ln["lanes"] for ln in spec] == [2]
    assert not [ln for ln in plain + spec if "error" in ln]
    assert all(ln["captured"] for ln in plain + spec)
    assert 1 <= spec[0]["accept_per_pass"] <= 8
    assert ti8.i8_decode.launches and ti8.i8_prefill.launches
    assert tfd.paged_flash_decode_attention.launches


def test_paged_spec_cost_probe_on_card(cuda_device):
    """tools/probe_paged_spec_cost.run at the tiny geometry in w8a8: every
    arm timed (the paged ones captured and eager), the paged plain chunk and
    verify passes captured, both flash kernels launched."""
    from minigpt4_tpu_torch import benchmark as B
    from minigpt4_tpu_torch.tools import probe_paged_spec_cost as cost

    cfg = B.GEOMETRIES["tiny"]
    params = B.synth_llama_params(cfg, DataType.Q5_K, np.random.default_rng(0),
                                  quant_mode="w8a8", device="cuda")
    counters.reset()
    out = cost.run(params, cfg, _tiny_tool_args(cost, []))
    ms = [k for k in out if k.endswith("_ms")]
    assert len(ms) == 9 and all(np.isfinite(out[k]) and out[k] > 0 for k in ms)
    assert out["captured"] == ["paged_plain", "paged_spec_cross", "paged_spec_aligned"]
    assert tfd.flash_decode_attention.launches and tfd.paged_flash_decode_attention.launches


def test_prefill_profile_and_locality_on_card(cuda_device):
    """tools/profile_prefill_engine.run and probe_teacher_locality.run on the
    tiny gq teacher: six captured arms, the token tiles restored; agreements
    in [0, 1] within 2 positions of the CPU's plain versions; the gq
    prefill entry and flash decode launched."""
    from minigpt4_tpu_torch import benchmark as B
    from minigpt4_tpu_torch.ops import qmm_prefill
    from minigpt4_tpu_torch.tools import probe_teacher_locality as loc
    from minigpt4_tpu_torch.tools import profile_prefill_engine as pf

    cfg = B.GEOMETRIES["tiny"]
    tiles = qmm_prefill.TOKEN_TILES
    params = B.synth_llama_params(cfg, DataType.Q5_K, np.random.default_rng(0),
                                  quant_mode="gq", device="cuda", pack=False)
    counters.reset()
    arms = pf.run(params, cfg, _tiny_tool_args(pf, ["--chains", "1,2", "--reps", "1"]))
    assert qmm_prefill.TOKEN_TILES == tiles
    assert [(a["tn"], a["attn_len"]) for a in arms] == [(t, al) for t in tiles
                                                       for al in (None, 512)]
    assert all(a["captured"] and np.isfinite(a["prefill512_ms"]) for a in arms)
    largs = ["--model", "tiny", "--windows", "1,8"]
    card = loc.run(params, cfg, _tiny_tool_args(loc, largs))
    assert tgq.gq_prefill.launches and tfd.flash_decode_attention.launches
    cpu = loc.run(_tree_to(params, "cpu"), cfg, loc.parse_args(largs + ["--device", "cpu"]))
    for w in ("w1", "w8"):
        assert 0 <= card[w] <= 1 and abs(card[w] - cpu[w]) * card["positions"] <= 2


def test_coldstart_probe_on_card(cuda_device, tmp_path, capsys):
    """tools/coldstart_probe.main on the tiny gq fixture pair on the card:
    JAX's keys and the device, every number finite and positive, and its
    launch line shows the gq entries and flash decode."""
    from minigpt4_tpu_torch.tools import coldstart_probe

    model, llm = build_gq_models(tmp_path)
    assert coldstart_probe.main(["-m", str(model), "-l", str(llm), "--image-size", "28",
                                 "--n-decode", "8", "--n-ctx", "256"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    counts = json.loads(lines[-2][len("[launches] "):])
    out = json.loads(lines[-1])
    assert set(out) == {"build_s", "encode_ms", "ttft_ms", "decode_tok_s", "n_decode", "device"}
    assert all(np.isfinite(out[k]) and out[k] > 0 for k in out if k != "device")
    assert counts["gq_decode"] > 0 and counts["gq_prefill"] > 0 and counts["flash_decode"] > 0


# ---------------------------------------------------------------------------
# the captured steps of serving sessions, batched verify passes, the banned
# chunk and the drafter, against the same steps run eagerly (bit for bit)
# ---------------------------------------------------------------------------

def _state_bits(st) -> tuple:
    return (list(st.tokens), st.n_past, None if st.logits is None else st.logits.clone(),
            {kv: _bits(t).clone() for kv, t in st.cache.items()})


def _same_state(a: tuple, b: tuple) -> None:
    assert a[:2] == b[:2]
    assert (a[2] is None) == (b[2] is None)
    if a[2] is not None:
        assert torch.equal(a[2], b[2])
    assert all(torch.equal(a[3][kv], b[3][kv]) for kv in ("k", "v"))


def _two_sessions(pool, graphs: bool) -> tuple:
    """Two sessions' prompts, chunks and turns, one step of each in turn
    (the second samples from a generator seeded alike every run): texts and
    states."""
    pool.engine.graphs_enabled = graphs
    ss = [pool.new_session() for _ in range(2)]
    for i, s in enumerate(ss):
        s.state.generator.manual_seed(400 + i)
    texts = []
    steps = [lambda s, i: pool.system_prompt(s),
             lambda s, i: pool.begin_chat(s, ("what is red?", "where is it?")[i]),
             lambda s, i: "".join(pool.generate(s, 20, SamplingParams(temp=0.0))),
             lambda s, i: pool.begin_chat(s, ("and the blue", "and the pink")[i]),
             lambda s, i: "".join(pool.generate(s, 12, SamplingParams(temp=0.8, top_k=40)))]
    for step in steps:
        for i, s in enumerate(ss):
            texts.append(step(s, i))
    torch.cuda.synchronize()
    out = texts, [_state_bits(s.state) for s in ss]
    for s in ss:
        s.close()
    return out


def test_interleaved_sessions_captured_equal_eager(cuda_device, tmp_path):
    """Two sessions interleaved on the card replay the engine's session
    graphs over its resident cache: their texts, tokens, pending logits and
    cache bits equal the eager run's, captured (first run) and replayed
    (second run, no new graph)."""
    model, llm = build_gq_models(tmp_path)
    pool = SessionPool(model, llm, session_ctx=512, n_ctx=512, n_batch=32, device=cuda_device,
                       prefix_cache=False)
    try:
        eager = _two_sessions(pool, False)
        first = _two_sessions(pool, True)
        res = pool.engine._resident[512]
        n_graphs, r0 = len(res.steps.graphs), res.steps.replays
        replayed = _two_sessions(pool, True)
        assert len(res.steps.graphs) == n_graphs > 0 and res.steps.replays > r0
        for got in (first, replayed):
            assert got[0] == eager[0]
            for a, b in zip(got[1], eager[1]):
                _same_state(a, b)
    finally:
        pool.close()


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
@pytest.mark.parametrize("case", ["greedy", "sampled", "banned"])
def test_group_verify_and_banned_chunk_captured_equal_eager(cuda_device, tmp_path, paged, case):
    """SessionPool._group_step over three lanes, through a page table (the
    window group and the paged batcher) or a stacked cache (the dense
    batcher): greedy and sampled verify passes and the banned chunk, run
    eagerly and from their graph (first use eager, then captured and
    replayed, then replayed), from the same cache bits and generator states:
    tokens, logits, histories, bans, cache bits and generator states equal."""
    from minigpt4_tpu_torch.engine.device_sampling import lane_rows
    from minigpt4_tpu_torch.engine.graphs import StepGraphs

    model, llm = build_gq_models(tmp_path)
    pool = SessionPool(model, llm, session_ctx=256, n_ctx=256, n_batch=32,
                       paged_pool_pages=12, device=cuda_device, speculative_k=4)
    eng = pool.engine
    params = {"greedy": [SamplingParams(temp=0.0)] * 3,
              "sampled": [SamplingParams(temp=0.0), SamplingParams(temp=0.8),
                          SamplingParams(temp=1.1, top_p=0.9)],
              "banned": [SamplingParams(temp=0.8), SamplingParams(temp=0.0),
                         SamplingParams(temp=0.6)]}[case]
    n_passes = 0 if case == "banned" else 2
    try:
        sessions = []
        for q in ("one two", "three four five", "six"):
            s = pool.new_session()
            pool.begin_chat(s, q)
            sessions.append(s)
        pos = [s.n_past for s in sessions]
        logits0 = torch.stack([s.state.logits for s in sessions])
        table = None
        if paged:
            lane_pages, ppool = pool._try_admit_paged(sessions)
            lane_pages = [ppool.extend(p, n + 8) for p, n in zip(lane_pages, pos)]
            table = torch.from_numpy(np.stack([ppool.table_row(p) for p in lane_pages])
                                     ).to(cuda_device)
            cache = {"k": ppool.k, "v": ppool.v}
            steps = pool._paged_steps(ppool)
        else:
            cache = {kv: torch.cat([s.state.cache[kv] for s in sessions], dim=1)
                     for kv in ("k", "v")}
            steps = StepGraphs(eng.llm_params, eng.llm_cfg, cache, eng.device, eng.graph_pool)
        rows = lane_rows(params, eng.llm_cfg.n_vocab, cuda_device)
        c0 = {kv: t.clone() for kv, t in cache.items()}

        def run(graph_steps):
            for kv in ("k", "v"):
                cache[kv].copy_(c0[kv])
            group = pool._spec_group(sessions, rows)
            if case == "banned":
                group["ban"] = [5, -1, 7]
            gens = [torch.Generator(device=cuda_device).manual_seed(500 + i) for i in range(3)]
            toks, logits = pool._group_step(group, cache, logits0, pos, gens, 8, n_passes,
                                            [False] * 3, table, graph_steps)
            torch.cuda.synchronize()
            return (toks, logits.clone(), group["hist"].clone(), group["ban"],
                    {kv: _bits(t).clone() for kv, t in cache.items()},
                    [g.get_state() for g in gens])

        want = run(None)
        for _ in range(3):
            got = run(steps)
            assert got[0] == want[0] and got[3] == want[3]
            assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
            assert all(torch.equal(got[4][kv], want[4][kv]) for kv in ("k", "v"))
            assert all(torch.equal(a, b) for a, b in zip(got[5], want[5]))
        width = None if table is None else table.shape[1]
        key = {"greedy": ("spec", 3, 2, 4, None, width),
               "sampled": ("spec_stoch", 3, 2, 4, None, False, width),
               "banned": ("decode_ban", 3, 8, "traced", False, width)}[case]
        assert key in steps.graphs and steps.replays >= 2
    finally:
        pool.close()


def _drafted_run(eng, prompt: list[int], graphs: bool) -> tuple:
    """The engine's state from ``prompt``: three drafted dispatches of 2
    passes of width 4 (the catch-up before the first): their ids, the final
    logits and both caches' bits."""
    import minigpt4_tpu_torch.engine.engine as engine_mod

    eng.graphs_enabled = graphs
    eng.reset()
    eng.add_tokens(prompt)
    st = eng._st
    dfns = eng.draft_fns_for(st.n_ctx)
    ids = [engine_mod._draft_chunk(eng, dfns, st, 2, 4) for _ in range(3)]
    torch.cuda.synchronize()
    return (ids, st.logits.clone(), {kv: _bits(t).clone() for kv, t in st.cache.items()},
            {kv: _bits(t).clone() for kv, t in st.dcache.items()})


def test_warmup_with_drafter_captures_drafted_steps(cuda_device, tmp_path):
    """MiniGPT4Engine.warmup with a drafter captures the drafted dispatch of
    _spec_passes(16, 8) passes and the catch-up buckets (8, 16, 32 rows and
    64 at every span); the conversation is untouched; drafted dispatches and
    their catch-ups then give the eager run's ids and both caches' bits,
    from graphs (the ("draft", 2, 4) key meets its capture in the first
    captured run)."""
    from minigpt4_tpu_torch.engine.engine import _spec_passes

    model, llm = build_gq_models(tmp_path)
    eng = MiniGPT4Engine(model, llm, n_ctx=256, n_batch=32, device=cuda_device,
                         draft_llm_path=llm)
    prompt = [1, 170, 128, 103, 56, 63, 11, 17, 13, 176, 83, 83, 83, 144, 107, 192, 40]
    try:
        eng.add_tokens(prompt)
        n = eng.n_past
        before = _state_bits(eng._st)
        stats = eng.warmup(prefill_buckets=(8,), decode_chunks=(1,))
        after = _state_bits(eng._st)  # the rows past the cursor took the captures' writes
        _same_state(after[:3] + ({kv: t[:, :, :, :n] for kv, t in after[3].items()},),
                    before[:3] + ({kv: t[:, :, :, :n] for kv, t in before[3].items()},))
        keys = set(eng._resident["own"].dsteps.graphs)
        passes = _spec_passes(16, eng.draft_k)
        assert ("draft", passes, eng.draft_k) in keys
        assert {("catchup", b, None) for b in (8, 16, 32)} <= keys
        assert {("catchup", 64, s) for s in (128, 256)} <= keys
        assert stats["graphs"] >= len(keys)
        eager = _drafted_run(eng, prompt, False)
        dsteps = eng._resident["own"].dsteps
        r0 = dsteps.replays
        n = eng.n_past
        for _ in range(2):
            got = _drafted_run(eng, prompt, True)
            assert got[0] == eager[0] and torch.equal(got[1], eager[1])
            # the drafter's rows up to its frontier (the cursor); past it the
            # resident draft cache holds what the warmup's captures wrote
            # where the eager run's fresh cache holds zeros, rows no read reaches
            assert all(torch.equal(got[2][kv], eager[2][kv]) for kv in ("k", "v"))
            assert all(torch.equal(got[3][kv][:, :, :, :n], eager[3][kv][:, :, :, :n])
                       for kv in ("k", "v"))
        assert dsteps.replays > r0 and ("draft", 2, 4) in dsteps.graphs
    finally:
        eng.close()


def test_session_pool_warmup_captures_verify_dispatch(cuda_device, tmp_path):
    """SessionPool.warmup with speculative_k = 4 also captures the greedy
    verify dispatch of a group's first speculative step at each lane count;
    a speculative paged group afterwards replays it (no new capture of that
    key) and gives the eager group's ids."""
    from minigpt4_tpu_torch.engine.sessions import _SpecGovernor

    model, llm = build_gq_models(tmp_path)
    pool = SessionPool(model, llm, session_ctx=256, n_ctx=256, n_batch=32,
                       paged_pool_pages=12, device=cuda_device, speculative_k=4)
    try:
        stats = pool.warmup(lanes=(1, 2), decode_chunk=8)
        w = pool.paged_pool.maxp + 1
        passes = _SpecGovernor().passes_for(8, 4)
        spec_keys = {("spec", b, passes, 4, None, w) for b in (1, 2)}
        assert spec_keys <= set(stats["keys"]) and stats["graphs"] == 6
        class Counted:  # a graph that counts its replays
            def __init__(self, graph):
                self.graph, self.n = graph, 0

            def replay(self):
                self.n += 1
                self.graph.replay()

        key = ("spec", 2, passes, 4, None, w)
        captured = pool._paged_graphs.graphs[key]
        captured.graph = Counted(captured.graph)
        runs = {}
        for graphs in (True, False):
            pool.engine.graphs_enabled = graphs
            sessions = []
            for q in ("one two one two one two", "three four three four"):
                s = pool.new_session()
                pool.begin_chat(s, q)
                sessions.append(s)
            pool.generate_batch(sessions, limit=24, params=SamplingParams(temp=0.0),
                                decode_chunk=8)
            runs[graphs] = [list(s.state.tokens) for s in sessions]
            for s in sessions:
                s.close()
        assert runs[True] == runs[False]
        assert pool._paged_graphs.graphs[key] is captured and captured.graph.n >= 1
    finally:
        pool.close()
