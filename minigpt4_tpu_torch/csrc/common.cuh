// Shared helpers for the port's hand-written Hopper kernels.
//
// Every entry point has a plain C signature (pointers as void*, sizes as int,
// the CUDA stream last), launches on that stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() so a refused launch reaches the
// Python wrapper (minigpt4_tpu_torch/ops/_build.py binds them with ctypes).
#pragma once

#include <cstdint>
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

// The i-th signed byte of a 32-bit word, as float (codes are stored as i8).
__device__ __forceinline__ float byte_as_float(int word, int i) {
  return static_cast<float>(static_cast<signed char>((word >> (8 * i)) & 0xff));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // exact for values read from bf16 planes
}

// Codes of a quantized weight, read in runs of 16 consecutive codes of one
// row that start at a multiple of 16 (qmm_decode.cuh, qmm_prefill.cuh).
// load(n, k, K) returns the run at row n, column k; value(run, j) is its j-th
// code as float; a value-initialised Run holds zeros.
//
// One signed byte per weight, [L, N, K]: the gq codes, and the q8_0 codes of
// a repacked weight (rq_matmul.cu).  A run is one 16-byte load.
struct I8Codes {
  using Run = int4;
  const int8_t* codes;

  __device__ __forceinline__ void select_layer(size_t li, int N, int K) {
    codes += li * N * K;
  }
  __device__ __forceinline__ Run load(int n, int k, int K) const {
    return __ldg(reinterpret_cast<const int4*>(codes + static_cast<size_t>(n) * K + k));
  }
  __device__ __forceinline__ static float value(const Run& r, int j) {
    const int w[4] = {r.x, r.y, r.z, r.w};
    return byte_as_float(w[j / 4], j % 4);
  }
};

// Nibble codes with HB high-bit planes (0, 1 or 2 bits), K in its natural
// order: the repacked weights of rq_matmul.cu and the packed gq codes
// (group_i8 packings p4, p5, p6) share this layout.
//   codes  u8 [L, N, K/2], byte (n, j) = q[n, 2j] | q[n, 2j+1] << 4;
//   hi     i32 [L, N, K/32] for HB = 1 (bit b of word w is bit 4 of
//          q[n, 32 w + b]), [L, N, K/16] for HB = 2 (bits 2b+1:2b of word w
//          are bits 5:4 of q[n, 16 w + b]); unused for HB = 0.
// A run is one 8-byte load of nibbles and 16 or 32 bits of one high-bit word;
// value() gives the unsigned code as float, the same float an i8 code of
// I8Codes gives, so both sources feed the kernels identical operands.
template <int HB>
struct NibbleCodes {
  struct Run {
    uint2 lo;     // 16 nibbles: code j at bits 4j of lo.x (j < 8) or lo.y
    uint32_t hi;  // the run's high bits, HB per code from bit 0
  };
  const uint8_t* codes;
  const uint32_t* hi;

  __device__ __forceinline__ void select_layer(size_t li, int N, int K) {
    codes += li * N * (K / 2);
    if constexpr (HB > 0) hi += li * N * (K / (32 / HB));
  }
  __device__ __forceinline__ Run load(int n, int k, int K) const {
    const size_t e = static_cast<size_t>(n) * K + k;  // element index, a multiple of 16
    Run r;
    r.lo = __ldg(reinterpret_cast<const uint2*>(codes + e / 2));
    r.hi = 0;
    if constexpr (HB == 1) r.hi = __ldg(hi + e / 32) >> (e & 16);
    if constexpr (HB == 2) r.hi = __ldg(hi + e / 16);
    return r;
  }
  __device__ __forceinline__ static float value(const Run& r, int j) {
    const uint32_t w = j < 8 ? r.lo.x : r.lo.y;
    uint32_t q = (w >> (4 * (j % 8))) & 15u;
    if constexpr (HB > 0) q |= ((r.hi >> (HB * j)) & ((1u << HB) - 1u)) << 4;
    return static_cast<float>(q);
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

// Per-group planes of a group-quant weight, W[n, k] = A[g, n] * q[n, k] + B[g, n]
// with g = k / kGS.  fetch(g, n, N) returns (A, B) in f32; T is the type a
// kernel keeps staged planes in (f32 for exact planes, bf16 for generic ones,
// so neither loses a bit).  kRowMajor says whether a plane is stored [N, G]
// (true) or [G, N]; the decode kernel stages it in the order of its rows.
//
// Exact q4_k/q5_k planes (group_i8._kernel_exact): u8 sub-scales sc6/mn6
// [L, K/32, N] and f32 superblock scales d/dmin [L, K/256, N];
// A = d * sc6 and B = -dmin * mn6 are exact in f32.
struct ExactPlanes {
  using T = float;
  static constexpr int kGS = 32;
  static constexpr bool kRowMajor = false;
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
};

// Generic planes (group_i8._kernel_generic): bf16 A and B [L, K/GS, N].
template <int GS>
struct GenericPlanes {
  using T = __nv_bfloat16;
  static constexpr int kGS = GS;
  static constexpr bool kRowMajor = false;
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
};

}  // namespace mgt
