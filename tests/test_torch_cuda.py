"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one.  The file
imports no JAX, so it runs on a machine that has only PyTorch and the CUDA
toolkit; tests/conftest.py imports JAX, so run it there without the
conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances: gq_decode and gq_decode_generic keep x in f32 like their
plain version (1e-5 of max|y|, f32 summation order); gq_prefill and
gq_prefill_generic round x and W to bf16 like their plain version and sum
64-wide K tiles on the tensor cores (1e-4); flash decode, dense and paged,
is f32 online softmax against f32 softmax (1e-5 absolute on unit inputs),
and the paged kernel gives the dense kernel's bits on the gathered cache.
rq_decode keeps x in f32 like qmatmul_repacked_ref (1e-5); rq_prefill
rounds x and w = scale * q - min to bf16 like qmatmul_repacked_prefill_ref
(1e-4, summation order) and sits within 1e-2 of the f32 plain version
(two bf16 roundings of 2^-9 each per product; tests/test_pallas_quant_matmul.py
holds the TPU kernel to 1.2e-2 of the same f32 product).  i8_decode and
i8_prefill form each 256-wide chunk's product as an exact i32 like
qmatmul_i8sb_ref and sum the scaled chunks in chunk order (1e-5 and 1e-4
of max|y|: only the f32 multiply-add rounding can differ).  The e4m3 cache
reads through the same unpack in the kernels and in cache_f32 (1e-5
absolute, as the other cache types).  A packed gq weight (p4, p5, p6) gives
its unpacked twin's bits in every entry (max |d| = 0): the code reaches the
same arithmetic as the same float.  A NaN past a lane's cursor is never read.
The stats mode of flash decode (the partials of sequence parallelism) is
held to its plain version like the normalized mode (1e-5), with exact
zero partials where a row sees no key.  The probe kernels (ops/probes.py):
the dual-i8 q5_k matmul and every storage / strategy / width / layout of the
dequantize-matvec are f32 sums in another order than their plain versions
(1e-4 of max|y|); the integer dots, the s4 chunk-scaled dot (products and
sums rounded apart in chunk order, as the plain version) and the op chains
give their plain versions' bits.  A column-parallel slice (half the output
rows) of a 13B weight gives the whole-width launch's bits in those rows.
"""

import numpy as np
import pytest
import torch

from fixtures import GQ_D, build_container, build_gq_models, build_llm_gq
from minigpt4_tpu_torch.engine import MiniGPT4Engine, SamplingParams
from minigpt4_tpu_torch.engine.sessions import SessionPool
from minigpt4_tpu_torch.formats import DataType, quants
from minigpt4_tpu_torch.image import preprocess
from minigpt4_tpu_torch.ops import _build
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


# every layout; K = 1408 (ViT-G width, 44 groups of 32) for the 32-blocks,
# 768 for the k-quants; N = 301 is odd and ragged for both column tiles
@pytest.mark.parametrize("dtype", RQ_FORMATS, ids=[d.name.lower() for d in RQ_FORMATS])
@pytest.mark.parametrize("m", [1, 5, 8, 40])
def test_repacked_kernels_match_plain(cuda_device, dtype, m):
    k = 768 if dtype >= DataType.Q2_K else 1408
    w = _rq(dtype, 301, k, (1, 2), cuda_device)
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
    for entry, m, k, gs, hi, layer in (("mgt_rq_decode", 9, 256, 32, ptrs[1], 0),
                                       ("mgt_rq_decode", 1, 256, 24, ptrs[1], 0),
                                       ("mgt_rq_prefill", 9, 48, 16, ptrs[1], 0),
                                       ("mgt_rq_prefill", 9, 256, 32, None, 0),
                                       ("mgt_rq_decode", 1, 256, 32, ptrs[1], -1)):
        rc = getattr(lib, entry)(x9.data_ptr(), ptrs[0], hi, ptrs[2], ptrs[3], y.data_ptr(),
                                 m, 64, k, gs, 4, 1, layer, stream)
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


# N = 300 is ragged for both column tiles; K = 768 is three chunks
@pytest.mark.parametrize("stacked", [False, True], ids=["unstacked", "stacked"])
@pytest.mark.parametrize("m", [1, 8, 9, 33, 257])
def test_i8_kernels_match_plain(cuda_device, m, stacked):
    n, k = 300, 768
    w = _i8(n, k, 3 if stacked else 1, cuda_device)
    layer = 2 if stacked else None
    x = torch.from_numpy(np.random.default_rng(m).normal(0, 1, (m, k)).astype(np.float32))
    x_i8, _ = ti8.quantize_activations(x.to(cuda_device))
    kern = ti8.i8_decode if m <= ti8.I8_MAX_M else ti8.i8_prefill
    before = kern.launches
    got = kern(x_i8, w, layer)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    want = ti8.qmatmul_i8sb_ref(x_i8, w, layer)
    assert _rel(got, want) <= (1e-5 if m <= ti8.I8_MAX_M else 1e-4)
    # the engine's entry: the same product times the row scales
    y = ti8.qmatmul_i8sb(x.to(cuda_device), w, layer)
    assert _rel(y, ti8.qmatmul_i8sb(x, ti8.I8SBQuant(w.codes.cpu(), w.scales.cpu(), k),
                                    layer)) <= 1e-4


def test_i8_refused_launches_raise(cuda_device):
    w = _i8(64, 256, 2, cuda_device)
    x9 = torch.zeros((9, 256), dtype=torch.int8, device=cuda_device)
    with pytest.raises(ValueError, match="1..8 rows"):
        ti8.i8_decode(x9, w, 0)
    with pytest.raises(IndexError, match="out of range"):
        ti8.i8_prefill(x9, w, 2)
    with pytest.raises(ValueError, match="layer index"):
        ti8.i8_prefill(x9, w)
    # K = 96 is no multiple of 256: both C entries refuse it
    bad = ti8.I8SBQuant(w.codes[:, :, :96].contiguous(), w.scales[:, :, :1].contiguous(), 96)
    for kern, x in ((ti8.i8_decode, x9[:1, :96]), (ti8.i8_prefill, x9[:, :96])):
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
    for hb in (0, 1, 3):
        rc = lib.mgt_gq_prefill_generic(
            x.data_ptr(), w6.codes.data_ptr(), w6.hi.data_ptr(), w6.a.data_ptr(),
            w6.b.data_ptr(), y.data_ptr(), 1, 64, 256, 16, hb, 0, stream)
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


@pytest.mark.parametrize("stacked", [False, True], ids=["unstacked", "stacked"])
@pytest.mark.parametrize("m", [1, 3, 8])
def test_probe_group_i8_matches_plain(cuda_device, m, stacked):
    """The dual-i8 exact-q5_k kernel against its plain version (1e-4) and the
    f64 dequant reference (3e-4, the JAX probe's check), ragged N, stacked
    codes and planes at layer 1."""
    gen = _probe_gen(cuda_device, m)
    n, k, lead = 300, 768, ((2,) if stacked else ())
    codes = torch.randint(0, 32, (*lead, n, k), generator=gen, device=cuda_device,
                          dtype=torch.int8)
    sct = (torch.rand((*lead, k // 32, n), generator=gen, device=cuda_device) * 0.02
           + 0.001).to(torch.bfloat16)
    bt = -(torch.rand((*lead, k // 32, n), generator=gen, device=cuda_device) * 0.1).to(
        torch.bfloat16)
    x = torch.randn((m, k), generator=gen, device=cuda_device)
    layer = 1 if stacked else None
    before = tpb.probe_group_i8.launches
    got = tpb.qmatmul_group_i8(x, codes, sct, bt, layer)
    assert tpb.probe_group_i8.launches == before + 1
    x1, x2, s1, s2 = tpb.split_activations(x)
    want = tpb.group_i8_ref(x1, x2, torch.cat([s1, s2], 1), tpb.group_sums(x), codes, sct, bt,
                            layer)
    assert _rel(got, want) <= PROBE_TOL
    f64 = x.double() @ tpb.dequant_group_i8(codes, sct, bt, layer).double().t()
    assert _rel(got, f64) <= 3e-4


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


INT_CASES = [("i8xi8", 1), ("i8xi8", 8), ("s4xs4", 1), ("s4xs4", 8), ("s4xs4", 16),
             ("s4_sb", 1), ("s4_sb", 5), ("s4_sb", 8)]


@pytest.mark.parametrize("mode,m", INT_CASES, ids=[f"{a}-m{b}" for a, b in INT_CASES])
def test_probe_int_dot_bit_equal(cuda_device, mode, m):
    """i8 x i8 and s4 x s4 (mma.sync m16n8k64) give the exact integers; the
    s4 chunk-scaled dot gives its plain version's bits (ragged N)."""
    gen = _probe_gen(cuda_device, m)
    n, k = 300, 1024
    i8 = lambda rows: torch.randint(-127, 128, (rows, k), generator=gen, device=cuda_device,
                                    dtype=torch.int8)
    s4 = lambda rows: torch.randint(0, 256, (rows, k // 2), generator=gen, device=cuda_device,
                                    dtype=torch.uint8)
    x = s4(m) if mode == "s4xs4" else i8(m)
    w = i8(n) if mode == "i8xi8" else s4(n)
    sc = (torch.rand((n, k // 256), generator=gen, device=cuda_device) + 0.5) * 2.0 ** -13
    sc = sc if mode == "s4_sb" else None
    got, want = tpb.int_dot(x, w, sc, mode), tpb.int_dot_ref(x, w, sc, mode)
    assert got.dtype == want.dtype and torch.equal(got, want)


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


@pytest.mark.parametrize("kernel", ["gq_decode", "rq_decode", "rq_prefill"])
def test_half_rows_bit_equal_to_whole_width(cuda_device, kernel):
    """tp's column split on the card: each kernel on rows [r0, r0 + N/2) of a
    13B w13 weight (27648 x 5120, q5_k) gives the whole-width launch's bits
    in those rows, for both halves and every row count of its path."""
    n, k = 27648, 5120
    raw = _q5k_13b_bytes(n, k, 11)
    h = n // 2
    if kernel == "gq_decode":
        w = tgq.from_ggml(raw, (n, k), DataType.Q5_K, cuda_device)
        fn, ms = tgq.gq_decode, (1, 8)

        def half(r0):
            ts = {"codes": w.codes[r0:r0 + h]}
            ts.update({name: getattr(w, name)[:, r0:r0 + h] for name in ("sc6", "mn6", "d",
                                                                        "dmin")})
            return w._replace(**{key: v.contiguous() for key, v in ts.items()})
    else:
        w = trp.from_ggml(raw, (n, k), DataType.Q5_K, cuda_device)
        fn, ms = (trq.rq_decode, (1, 8)) if kernel == "rq_decode" else (trq.rq_prefill, (32, 512))

        def half(r0):
            return w._replace(**{key: v[r0:r0 + h].contiguous()
                                 for key, v in w.tensors().items()})
    for m in ms:
        x = torch.from_numpy(np.random.default_rng(m).normal(0, 1, (m, k)).astype(np.float32))
        x = x.to(cuda_device)
        whole = fn(x, w)
        for r0 in (0, h):
            assert torch.equal(fn(x, half(r0)), whole[:, r0:r0 + h]), (kernel, m, r0)
