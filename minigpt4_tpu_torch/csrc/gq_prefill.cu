// gq_prefill: group-quant matmul for M > 8 activation rows.
//
// Replaces minigpt4_tpu/ops/group_i8.py:_kernel_prefill (reached through
// _run_prefill and qmatmul_group for M > GQ_MAX_M) in both plane modes:
// exact q4_k/q5_k planes (entry mgt_gq_prefill) and generic bf16 planes of
// group size 16 or 32 (entry mgt_gq_prefill_generic).  It serves every
// prefill chunk of more than 8 rows, up to the engine's 512-row bucket.
//
// Same W as gq_decode, with the prefill kernel's roundings: each weight is
// dequantized in f32 and rounded to bf16, bf16(f32(q) * A + B), the
// activation is rounded to bf16, and the products accumulate in f32.
//
// What bounds it on the H100: at the 512-row bucket the work is
// compute-bound (about 2 * 512 flops per code byte, above the card's
// ~295 bf16 flops per byte of bandwidth); at the 32-row image chunk it is
// bound by the code stream, like gq_decode.
//
// Design: a plain tiled tensor-core kernel.  A block computes a 64 x 64
// output tile and walks K inside the block in steps of 64 (two or four
// groups): it dequantizes the [64 n x 64 k] weight tile into shared memory
// as bf16 (one 16-byte code load per thread-half-row, each 16-code run
// inside one group; A and B from the planes of common.cuh, exact f32 or
// bf16 as stored; q * A is exact in f32 for both), rounds the matching
// [64 m x 64 k] x tile to bf16, and runs bf16 WMMA (mma.sync) with f32
// accumulators, four warps each owning a 32 x 32 sub-tile.  Nothing is
// carried between blocks, so no accumulation across the grid is needed.
// Ragged M and N are masked on load and on the final store.  Later work:
// wgmma, TMA and a multi-stage shared-memory ring.
#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 64;
constexpr int kThreads = 128;

template <class P>
__global__ void __launch_bounds__(kThreads)
gq_prefill_kernel(const float* __restrict__ x, const int8_t* __restrict__ codes, P planes,
                  float* __restrict__ y, int M, int N, int K, int layer) {
  __shared__ __align__(128) __nv_bfloat16 xs[kBM * kBK];  // [m][k]
  __shared__ __align__(128) __nv_bfloat16 ws[kBN * kBK];  // [n][k]: column-major B
  __shared__ __align__(128) float cs[kBM * kBN];          // epilogue staging

  const size_t li = static_cast<size_t>(layer);
  codes += li * N * K;
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
    for (int i = tid; i < kBM * kBK / 4; i += kThreads) {
      const int r = i / (kBK / 4), c4 = i % (kBK / 4);
      const int m = m0 + r;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m < M) v = __ldg(reinterpret_cast<const float4*>(x + static_cast<size_t>(m) * K + k0) + c4);
      __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(xs + r * kBK + 4 * c4);
      dst[0] = __floats2bfloat162_rn(v.x, v.y);
      dst[1] = __floats2bfloat162_rn(v.z, v.w);
    }
    // weight tile: 64 rows x 64 codes; each thread dequantizes 2 x 16 codes
    // of one row, each 16-code run inside one group
    for (int i = tid; i < kBN * (kBK / 16); i += kThreads) {
      const int r = i / (kBK / 16), part = i % (kBK / 16);
      const int n = n0 + r;
      const int k = k0 + 16 * part;
      __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(ws + r * kBK + 16 * part);
      if (n < N) {
        const float2 ab = planes.fetch(k / P::kGS, n, N);
        const float a = ab.x, b = ab.y;
        const int4 q = __ldg(reinterpret_cast<const int4*>(codes + static_cast<size_t>(n) * K + k));
        const int w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float lo = fmaf(mgt::byte_as_float(w[j / 2], 2 * (j % 2)), a, b);
          const float hi = fmaf(mgt::byte_as_float(w[j / 2], 2 * (j % 2) + 1), a, b);
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
  for (int i = tid; i < kBM * kBN; i += kThreads) {
    const int r = i / kBN, c = i % kBN;
    const int m = m0 + r, n = n0 + c;
    if (m < M && n < N) y[static_cast<size_t>(m) * N + n] = cs[i];
  }
}

template <class P>
int prefill(const void* x, const void* codes, const P& planes, void* y, int M, int N, int K,
            int layer, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % (8 * P::kGS)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  gq_prefill_kernel<P><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(codes), planes,
      static_cast<float*>(y), M, N, K, layer);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x f32 [M, K]; codes i8 [L, N, K]; sc6/mn6 u8 [L, K/32, N]; d/dmin f32
// [L, K/256, N]; y f32 [M, N].  Requires K % 256 == 0 and 16-byte aligned x
// and codes.
MGT_API int mgt_gq_prefill(const void* x, const void* codes, const void* sc6,
                           const void* mn6, const void* d, const void* dmin,
                           void* y, int M, int N, int K, int layer, void* stream) {
  const mgt::ExactPlanes planes{static_cast<const uint8_t*>(sc6), static_cast<const uint8_t*>(mn6),
                                static_cast<const float*>(d), static_cast<const float*>(dmin)};
  return prefill(x, codes, planes, y, M, N, K, layer, stream);
}

// x f32 [M, K]; codes i8 [L, N, K]; a/b bf16 [L, K/gs, N]; y f32 [M, N].
// Requires gs 16 or 32, K % (8 * gs) == 0 and 16-byte aligned x and codes.
MGT_API int mgt_gq_prefill_generic(const void* x, const void* codes, const void* a,
                                   const void* b, void* y, int M, int N, int K, int gs,
                                   int layer, void* stream) {
  const auto* pa = static_cast<const __nv_bfloat16*>(a);
  const auto* pb = static_cast<const __nv_bfloat16*>(b);
  if (gs == 16) return prefill(x, codes, mgt::GenericPlanes<16>{pa, pb}, y, M, N, K, layer, stream);
  if (gs == 32) return prefill(x, codes, mgt::GenericPlanes<32>{pa, pb}, y, M, N, K, layer, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
