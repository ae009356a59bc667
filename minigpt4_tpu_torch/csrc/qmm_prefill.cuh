// The quantized matmul for M > 8 activation rows, shared by the gq entries
// (gq_prefill.cu) and the repacked-weight entry (rq_matmul.cu); templated on
// the plane source P and the code source C as qmm_decode.cuh is.
//
// Roundings of the TPU prefill kernels: each weight is dequantized in f32
// and rounded to bf16, bf16(f32(q) * A + B) (for a repacked weight
// bf16(scale * q - min): the offset is folded into the weight before the
// rounding, so the large scale * q and min of q5_k/q6_k never cancel in bf16),
// the activation is rounded to bf16, and the products accumulate in f32.
//
// What bounds it on the H100: at the 512-row bucket the work is
// compute-bound (about 2 * 512 flops per code byte, above the card's
// ~295 bf16 flops per byte of bandwidth); at the 32-row image chunk it is
// bound by the code stream, like the decode kernel.
//
// Design: a plain tiled tensor-core kernel.  A block computes a 64 x 64
// output tile and walks K inside the block in steps of 64 (two or four
// groups): it dequantizes the [64 n x 64 k] weight tile into shared memory
// as bf16 (one 16-code run per thread-quarter-row, each run inside one
// group), rounds the matching [64 m x 64 k] x tile to bf16, and runs bf16
// WMMA (mma.sync) with f32 accumulators, four warps each owning a 32 x 32
// sub-tile.  Nothing is carried between blocks, so no accumulation across
// the grid is needed.  Ragged M and N are masked on load and on the final
// store, and a K tail of 32 (K % 64 == 32) is zero-filled.  Later work:
// wgmma, TMA and a multi-stage shared-memory ring.
#pragma once

#include <mma.h>

#include "common.cuh"

namespace mgt {
namespace {

constexpr int kPrefillBM = 64;
constexpr int kPrefillBN = 64;
constexpr int kPrefillBK = 64;
constexpr int kPrefillThreads = 128;

template <class P, class C>
__global__ void __launch_bounds__(kPrefillThreads)
qmm_prefill_kernel(const float* __restrict__ x, C codes, P planes, float* __restrict__ y, int M,
                   int N, int K, int layer) {
  using namespace nvcuda;
  constexpr int kBM = kPrefillBM, kBN = kPrefillBN, kBK = kPrefillBK;
  __shared__ __align__(128) __nv_bfloat16 xs[kBM * kBK];  // [m][k]
  __shared__ __align__(128) __nv_bfloat16 ws[kBN * kBK];  // [n][k]: column-major B
  __shared__ __align__(128) float cs[kBM * kBN];          // epilogue staging

  const size_t li = static_cast<size_t>(layer);
  codes.select_layer(li, N, K);
  planes.select_layer(li, N, K);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int wm = (warp / 2) * 32;
  const int wn = (warp % 2) * 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // x tile: 64 rows x 64 columns of f32, rounded to bf16
    for (int i = tid; i < kBM * kBK / 4; i += kPrefillThreads) {
      const int r = i / (kBK / 4), c4 = i % (kBK / 4);
      const int m = m0 + r;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m < M && k0 + 4 * c4 < K)
        v = __ldg(reinterpret_cast<const float4*>(x + static_cast<size_t>(m) * K + k0) + c4);
      __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(xs + r * kBK + 4 * c4);
      dst[0] = __floats2bfloat162_rn(v.x, v.y);
      dst[1] = __floats2bfloat162_rn(v.z, v.w);
    }
    // weight tile: 64 rows x 64 codes; each thread dequantizes 2 x 16 codes
    // of one row, each 16-code run inside one group
    for (int i = tid; i < kBN * (kBK / 16); i += kPrefillThreads) {
      const int r = i / (kBK / 16), part = i % (kBK / 16);
      const int n = n0 + r;
      const int k = k0 + 16 * part;
      __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(ws + r * kBK + 16 * part);
      if (n < N && k < K) {
        const float2 ab = planes.fetch(k / P::kGS, n, N);
        const float a = ab.x, b = ab.y;
        const typename C::Run q = codes.load(n, k, K);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float lo = fmaf(C::value(q, 2 * j), a, b);
          const float hi = fmaf(C::value(q, 2 * j + 1), a, b);
          dst[j] = __floats2bfloat162_rn(lo, hi);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) dst[j] = __floats2bfloat162_rn(0.f, 0.f);
      }
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bf[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(af[i], xs + (wm + 16 * i) * kBK + kk, kBK);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(bf[j], ws + (wn + 16 * j) * kBK + kk, kBK);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(cs + (wm + 16 * i) * kBN + wn + 16 * j, acc[i][j], kBN,
                              wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < kBM * kBN; i += kPrefillThreads) {
    const int r = i / kBN, c = i % kBN;
    const int m = m0 + r, n = n0 + c;
    if (m < M && n < N) y[static_cast<size_t>(m) * N + n] = cs[i];
  }
}

// x f32 [M, K], y f32 [M, N]; K % 32 == 0, 16-byte aligned x.
template <class P, class C>
int qmm_prefill(const void* x, const C& codes, const P& planes, void* y, int M, int N, int K,
                int layer, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 32 || K % P::kGS)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + kPrefillBN - 1) / kPrefillBN, (M + kPrefillBM - 1) / kPrefillBM);
  qmm_prefill_kernel<P, C><<<grid, kPrefillThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), codes, planes, static_cast<float*>(y), M, N, K, layer);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace mgt
