// Shared helpers for the port's hand-written Hopper kernels.
//
// Every entry point has a plain C signature (pointers as void*, sizes as int,
// the CUDA stream last), launches on that stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() so a refused launch reaches the
// Python wrapper (minigpt4_tpu_torch/ops/_build.py binds them with ctypes).
#pragma once

#include <cstdint>
#include <mutex>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define MGT_API extern "C" __attribute__((visibility("default")))

namespace mgt {

constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

// The i32 dot product of 16 signed bytes with 16 signed bytes (__dp4a).
__device__ __forceinline__ int dot16(const int4& a, const int4& b) {
  int s = __dp4a(a.x, b.x, 0);
  s = __dp4a(a.y, b.y, s);
  s = __dp4a(a.z, b.z, s);
  return __dp4a(a.w, b.w, s);
}

// The sum over the 16 lanes of a half-warp (xor offsets below 16 stay inside it).
__device__ __forceinline__ int half_warp_sum(int v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

// Round-to-nearest-even quotients of activations by a row scale, without
// a division per element (gq_decode_i8.cuh's split, i8_matmul.cu's
// quantization): clamp(rint(v / s), +-127) as a float, taken as v * RN(1/s)
// (within 2.5 ulps of the rounded quotient) and, only where that lies
// within 2^-14 of a half-integer (where rint could differ), by __fdiv_rn.
// t holds the result + kRoundMagic, whose low byte is its i8 two's complement.
constexpr float kRoundMagic = 12582912.f;  // 1.5 * 2^23: q + kRoundMagic rounds q to an integer
constexpr float kTieBand = 0.49993896484375f;  // 0.5 - 2^-14

__device__ __forceinline__ float split_level(float v, float s, float rcp, bool fast, float& t) {
  float q = fast ? __fmul_rn(v, rcp) : __fdiv_rn(v, s);
  q = fminf(fmaxf(q, -127.f), 127.f);
  t = __fadd_rn(q, kRoundMagic);
  float r = __fsub_rn(t, kRoundMagic);
  if (fast && fabsf(__fsub_rn(q, r)) > kTieBand) {  // near a half-integer: the exact quotient
    q = fminf(fmaxf(__fdiv_rn(v, s), -127.f), 127.f);
    t = __fadd_rn(q, kRoundMagic);
    r = __fsub_rn(t, kRoundMagic);
  }
  return r;
}

// the low bytes of four words, in order, as one word
__device__ __forceinline__ int pack_low_bytes(float a, float b, float c, float d) {
  const uint32_t ab = __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x0040);
  const uint32_t cd = __byte_perm(__float_as_uint(c), __float_as_uint(d), 0x0040);
  return static_cast<int>(__byte_perm(ab, cd, 0x5410));
}

// an exact i32 |v| < 2^22 as float without I2F: the float of bits
// (v + 0x4B400000) is 1.5 * 2^23 + v
__device__ __forceinline__ float small_int_to_float(int v) {
  return __fsub_rn(__int_as_float(v + 0x4B400000), kRoundMagic);
}

// Codes of a quantized weight: the layer selected by pointer offset; the
// kernels read them with their own loads (gq_decode_i8.cuh, rq_decode.cuh,
// qmm_prefill.cuh's StepCodes).
//
// One signed byte per weight, [L, N, K]: the gq codes, and the q8_0 codes of
// a repacked weight (rq_matmul.cu).
struct I8Codes {
  const int8_t* codes;

  __device__ __forceinline__ void select_layer(size_t li, int N, int K) {
    codes += li * N * K;
  }
};

// Nibble codes with HB high-bit planes (0, 1 or 2 bits), K in its natural
// order: the repacked weights of rq_matmul.cu and the packed gq codes
// (group_i8 packings p4, p5, p6) share this layout.
//   codes  u8 [L, N, K/2], byte (n, j) = q[n, 2j] | q[n, 2j+1] << 4;
//   hi     i32 [L, N, K/32] for HB = 1 (bit b of word w is bit 4 of
//          q[n, 32 w + b]), [L, N, K/16] for HB = 2 (bits 2b+1:2b of word w
//          are bits 5:4 of q[n, 16 w + b]); unused for HB = 0.
template <int HB>
struct NibbleCodes {
  const uint8_t* codes;
  const uint32_t* hi;

  __device__ __forceinline__ void select_layer(size_t li, int N, int K) {
    codes += li * N * (K / 2);
    if constexpr (HB > 0) hi += li * N * (K / (32 / HB));
  }
};

// Calls run(source) with the code source of a gq weight's storage and returns
// its code: hi_bits -1 for one signed byte per code (I8Codes, packing
// "none"), else nibbles with hi_bits high bits (NibbleCodes): 0 (p4) or 1
// (p5) at group size 32, 2 (p6) at group size 16, the packable formats of
// ops/group_i8.py.  cudaErrorInvalidValue for any other layout, a null code
// pointer, a high-bit pointer that does not match hi_bits, or a negative
// layer.
template <int GS, class Run>
int with_gq_codes(const void* codes, const void* hi, int hi_bits, int layer, Run run) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (layer < 0 || codes == nullptr || (hi_bits > 0) != (hi != nullptr)) return invalid;
  if (hi_bits == -1) return run(I8Codes{static_cast<const int8_t*>(codes)});
  const auto* c8 = static_cast<const uint8_t*>(codes);
  const auto* h = static_cast<const uint32_t*>(hi);
  if constexpr (GS == 32) {
    if (hi_bits == 0) return run(NibbleCodes<0>{c8, h});
    if (hi_bits == 1) return run(NibbleCodes<1>{c8, h});
  } else {
    if (hi_bits == 2) return run(NibbleCodes<2>{c8, h});
  }
  return invalid;
}

// The 4-byte word holding the element at p, copied to shared memory by
// cp.async (zeros when !ok); element_shift(p) is its bit offset in the word.
__device__ __forceinline__ void cp_async_word(uint32_t* dst, const void* p, bool ok) {
  const auto word = reinterpret_cast<uintptr_t>(p) & ~static_cast<uintptr_t>(3);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(word), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ int element_shift(const void* p) {
  return 8 * static_cast<int>(reinterpret_cast<uintptr_t>(p) & 3);
}
__device__ __forceinline__ float bf16_word_half(uint32_t w, const void* p) {
  return __uint_as_float(((w >> element_shift(p)) & 0xffffu) << 16);
}

// Per-group planes of a group-quant weight, W[n, k] = A[g, n] * q[n, k] + B[g, n]
// with g = k / kGS.  fetch(g, n, N) returns (A, B) in f32 (the decode kernel,
// gq_decode_i8.cuh, reads them so).  The prefill kernel stages a 64-wide K step's planes of 128 rows (n0 ..)
// by cp.async, per (group gl of the step, row r) the words that hold its
// elements ([64 / kGS][128][kWords]; stage(), all threads), and forms (A, B)
// from them with staged_ab(): the same floats fetch() gives, zeros past N.
//
// Exact q4_k/q5_k planes (group_i8._kernel_exact): u8 sub-scales sc6/mn6
// [L, K/32, N] and f32 superblock scales d/dmin [L, K/256, N];
// A = d * sc6 and B = -dmin * mn6 are exact in f32.
struct ExactPlanes {
  static constexpr int kGS = 32;
  const uint8_t* sc6;
  const uint8_t* mn6;
  const float* d;
  const float* dmin;

  __device__ __forceinline__ void select_layer(size_t li, int N, int K) {
    const size_t g = static_cast<size_t>(K / kGS) * N, s = static_cast<size_t>(K / 256) * N;
    sc6 += li * g;
    mn6 += li * g;
    d += li * s;
    dmin += li * s;
  }
  __device__ __forceinline__ float2 fetch(int g, int n, int N) const {
    const size_t gi = static_cast<size_t>(g) * N + n, si = static_cast<size_t>(g / 8) * N + n;
    return make_float2(d[si] * static_cast<float>(sc6[gi]), -dmin[si] * static_cast<float>(mn6[gi]));
  }
  static constexpr int kWords = 4;
  __device__ __forceinline__ void stage(uint32_t* dst, int step, int n0, int N, int tid,
                                        int nth) const {
    for (int c = tid; c < 2 * 128; c += nth) {
      const int g = 2 * step + c / 128, n = n0 + c % 128;
      const bool ok = n < N;
      const size_t gi = ok ? static_cast<size_t>(g) * N + n : 0;
      const size_t si = ok ? static_cast<size_t>(g / 8) * N + n : 0;
      cp_async_word(dst + 4 * c, sc6 + gi, ok);
      cp_async_word(dst + 4 * c + 1, mn6 + gi, ok);
      cp_async_word(dst + 4 * c + 2, d + si, ok);
      cp_async_word(dst + 4 * c + 3, dmin + si, ok);
    }
  }
  __device__ __forceinline__ float2 staged_ab(const uint32_t* st, int step, int gl, int r, int n0,
                                              int N) const {
    const uint32_t* w = st + 4 * (gl * 128 + r);
    const size_t gi = static_cast<size_t>(2 * step + gl) * N + n0 + r;
    const float sc = static_cast<float>((w[0] >> element_shift(sc6 + gi)) & 0xffu);
    const float mn = static_cast<float>((w[1] >> element_shift(mn6 + gi)) & 0xffu);
    return make_float2(__uint_as_float(w[2]) * sc, -__uint_as_float(w[3]) * mn);
  }
};

// Generic planes (group_i8._kernel_generic): bf16 A and B [L, K/GS, N].
template <int GS>
struct GenericPlanes {
  static constexpr int kGS = GS;
  const __nv_bfloat16* a;
  const __nv_bfloat16* b;

  __device__ __forceinline__ void select_layer(size_t li, int N, int K) {
    const size_t g = static_cast<size_t>(K / kGS) * N;
    a += li * g;
    b += li * g;
  }
  __device__ __forceinline__ float2 fetch(int g, int n, int N) const {
    const size_t gi = static_cast<size_t>(g) * N + n;
    return make_float2(__bfloat162float(a[gi]), __bfloat162float(b[gi]));
  }
  static constexpr int kWords = 2;
  __device__ __forceinline__ void stage(uint32_t* dst, int step, int n0, int N, int tid,
                                        int nth) const {
    for (int c = tid; c < 64 / GS * 128; c += nth) {
      const int g = step * (64 / GS) + c / 128, n = n0 + c % 128;
      const bool ok = n < N;
      const size_t gi = ok ? static_cast<size_t>(g) * N + n : 0;
      cp_async_word(dst + 2 * c, a + gi, ok);
      cp_async_word(dst + 2 * c + 1, b + gi, ok);
    }
  }
  __device__ __forceinline__ float2 staged_ab(const uint32_t* st, int step, int gl, int r, int n0,
                                              int N) const {
    const uint32_t* w = st + 2 * (gl * 128 + r);
    const size_t gi = static_cast<size_t>(step * (64 / GS) + gl) * N + n0 + r;
    return make_float2(bf16_word_half(w[0], a + gi), bf16_word_half(w[1], b + gi));
  }
};

inline int device_sms() {
  static int cache[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  int& c = cache[dev & 63];
  if (c == 0) cudaDeviceGetAttribute(&c, cudaDevAttrMultiProcessorCount, dev);
  return c > 0 ? c : 1;
}

// Blocks of `threads` threads with `smem` bytes of dynamic shared memory
// that fit on one SM at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor,
// cached per kernel and configuration); 0 where none fits.
template <class Kernel>
int blocks_per_sm(Kernel kern, int threads, int smem) {
  struct Key {
    const void* kern;
    int threads, smem, occ;
  };
  static std::mutex mu;
  static Key keys[256];
  static int n_keys = 0;
  const void* k = reinterpret_cast<const void*>(kern);
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n_keys; ++i)
    if (keys[i].kern == k && keys[i].threads == threads && keys[i].smem == smem) return keys[i].occ;
  int occ = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern, threads, smem) != cudaSuccess)
    return 0;
  if (n_keys < 256) keys[n_keys++] = Key{k, threads, smem, occ};
  return occ;
}

// ---------------------------------------------------------------------------
// Hopper: TMA, mbarriers and warpgroup MMA (i8_matmul.cu, qmm_prefill.cuh)
// ---------------------------------------------------------------------------

constexpr int kMaxSmem = 232448;  // the H100's per-block shared-memory limit

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, found once at run time (no link against
// libcuda)
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                                : nullptr;
  }();
  return fn;
}

// a [rows, cols] matrix of elem_bytes-wide elements (cols contiguous) in
// boxes of box_rows x box_cols elements, 128-byte swizzle (box_cols *
// elem_bytes must be 128) or none; rows and columns past the end read as zeros
inline int make_tma_2d(CUtensorMap* map, const void* base, CUtensorMapDataType type,
                       int elem_bytes, int rows, int cols, int box_cols, int box_rows,
                       CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem_bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = enc(map, type, 2, const_cast<void*>(base), dims, strides, box, elem,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void prefetch_tensormap(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// TMA: the box at (col, row) of map into dst, completing bytes on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int col, int row,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col), "r"(row)
      : "memory");
}

// shared-memory matrix descriptor of a K-major tile with 128-byte swizzle:
// rows of 128 bytes, 8-row groups 1024 bytes apart; +2 moves the start 32
// bytes along K
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFFu) >> 4) | (1ull << 16) | (static_cast<uint64_t>(1024 >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving accesses of a wgmma fragment across this point
template <int R>
__device__ __forceinline__ void fence_fragment(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_fragment(uint32_t (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

}  // namespace mgt
