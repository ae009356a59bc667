// The quantized matmul for M <= 8 activation rows of the repacked-weight
// entry (rq_matmul.cu), x kept in f32 (the gq decode entries run
// gq_decode_i8.cuh).
//
//   y[m, n] = sum_g A[g, n] * sum_{k in g} q[n, k] x[m, k] + B[g, n] * sum_{k in g} x[m, k]
//
// templated on where the planes A and B come from (P: rq_matmul.cu's
// scale/min rows, staged as their type T in the order kRowMajor gives) and
// where the codes q come from (C: common.cuh's i8 codes or nibbles with
// high-bit planes).
//
// What bounds it on the H100: device-memory bandwidth on the code stream
// (1 B per weight for i8 codes, 0.5-0.75 B for nibbles with their high bits)
// plus the planes, read once per call; at M = 8 the FP32 FMA issue rate and
// shared-memory reads of x come close to that bound as well.
//
// Design.  A block owns a strip of BN = 32 output columns (8 warps x 4
// columns).  Lanes stream each column's codes along K in runs of 16; a run
// always lies inside one group (16 divides GS), so a lane forms sum_k q*x and
// sum_k x over its 16 columns and applies that group's A and B once (the
// algebra of group_i8._combine, and of pallas_quant_matmul's hoisted offset
// term, without the TPU's bf16 or dual-i8 activation rounding: x stays f32).
// The planes of the K tile are staged in shared memory with the tile of x
// (bf16: at M = 8 and GS = 16 the stage is 32 KB of x plus 2 x 4 KB of
// planes), read once per block in the order they are stored.  Each lane keeps 4 x M partial sums in registers across all of
// K; one warp reduction per output at the end, no atomics, so results are
// deterministic.  The stacked-layer index selects the [L, ...] slice by
// pointer offset.  K needs only to be a multiple of 32 (the tile tail is
// shorter); the entries state what else they require.
#pragma once

#include "common.cuh"

namespace mgt {
namespace {

constexpr int kDecodeWarps = 8;
constexpr int kDecodeCols = 4;  // output columns per warp
constexpr int kDecodeBN = kDecodeWarps * kDecodeCols;
constexpr int kDecodeKT = 1024;  // K tile staged in shared memory

template <int M, class P, class C>
__global__ void __launch_bounds__(kDecodeWarps * 32)
qmm_decode_kernel(const float* __restrict__ x, C codes, P planes, float* __restrict__ y, int N,
                  int K, int layer) {
  constexpr int GS = P::kGS;
  constexpr int kGT = kDecodeKT / GS;
  constexpr int kBN = kDecodeBN;
  using T = typename P::T;
  __shared__ __align__(16) float xs[M][kDecodeKT];
  __shared__ T as[kGT][kBN];
  __shared__ T bs[kGT][kBN];

  const size_t li = static_cast<size_t>(layer);
  codes.select_layer(li, N, K);
  planes.select_layer(li, N, K);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n0 = blockIdx.x * kBN;
  const int c0 = warp * kDecodeCols;  // first column of this warp inside the strip

  float acc[kDecodeCols][M];
#pragma unroll
  for (int c = 0; c < kDecodeCols; ++c)
#pragma unroll
    for (int m = 0; m < M; ++m) acc[c][m] = 0.f;

  for (int kt = 0; kt < K; kt += kDecodeKT) {
    const int len = min(kDecodeKT, K - kt);  // a multiple of 32 and of GS
    __syncthreads();                         // the previous tile is consumed
    const int len4 = len / 4;
    for (int i = threadIdx.x; i < M * len4; i += blockDim.x) {
      const int m = i / len4, c = i % len4;
      reinterpret_cast<float4*>(xs[m])[c] =
          __ldg(reinterpret_cast<const float4*>(x + static_cast<size_t>(m) * K + kt) + c);
    }
    const int glen = len / GS;
    for (int i = threadIdx.x; i < glen * kBN; i += blockDim.x) {
      // consecutive threads walk the plane's stored rows
      const int g = P::kRowMajor ? i % glen : i / kBN;
      const int c = P::kRowMajor ? i / glen : i % kBN;
      const int n = n0 + c;
      const float2 ab = n < N ? planes.fetch(kt / GS + g, n, N) : make_float2(0.f, 0.f);
      as[g][c] = from_f32<T>(ab.x);
      bs[g][c] = from_f32<T>(ab.y);
    }
    __syncthreads();

    for (int kk = lane * 16; kk < len; kk += 32 * 16) {
      const int g = kk / GS;
      typename C::Run q[kDecodeCols];
      float a[kDecodeCols], b[kDecodeCols];
#pragma unroll
      for (int c = 0; c < kDecodeCols; ++c) {
        const int n = n0 + c0 + c;
        q[c] = typename C::Run{};
        if (n < N) q[c] = codes.load(n, kt + kk, K);
        a[c] = to_f32(as[g][c0 + c]);
        b[c] = to_f32(bs[g][c0 + c]);
      }
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const float4* xp = reinterpret_cast<const float4*>(&xs[m][kk]);
        float xv[16];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 t = xp[j];
          xv[4 * j] = t.x;
          xv[4 * j + 1] = t.y;
          xv[4 * j + 2] = t.z;
          xv[4 * j + 3] = t.w;
        }
        float sx = 0.f;
#pragma unroll
        for (int j = 0; j < 16; ++j) sx += xv[j];
#pragma unroll
        for (int c = 0; c < kDecodeCols; ++c) {
          float p = 0.f;
#pragma unroll
          for (int j = 0; j < 16; ++j) p = fmaf(C::value(q[c], j), xv[j], p);
          acc[c][m] = fmaf(a[c], p, fmaf(b[c], sx, acc[c][m]));
        }
      }
    }
  }

#pragma unroll
  for (int c = 0; c < kDecodeCols; ++c) {
    const int n = n0 + c0 + c;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const float v = warp_sum(acc[c][m]);
      if (lane == 0 && n < N) y[static_cast<size_t>(m) * N + n] = v;
    }
  }
}

template <int M, class P, class C>
void launch_decode(const void* x, const C& codes, const P& planes, void* y, int N, int K,
                   int layer, cudaStream_t stream) {
  const dim3 grid((N + kDecodeBN - 1) / kDecodeBN);
  qmm_decode_kernel<M, P, C><<<grid, kDecodeWarps * 32, 0, stream>>>(
      static_cast<const float*>(x), codes, planes, static_cast<float*>(y), N, K, layer);
}

// x f32 [M, K], y f32 [M, N]; 1 <= M <= 8, K % 32 == 0, 16-byte aligned x.
template <class P, class C>
int qmm_decode(const void* x, const C& codes, const P& planes, void* y, int M, int N, int K,
               int layer, void* stream) {
  if (N <= 0 || K <= 0 || K % 32 || K % P::kGS) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (M) {
    case 1: launch_decode<1>(x, codes, planes, y, N, K, layer, s); break;
    case 2: launch_decode<2>(x, codes, planes, y, N, K, layer, s); break;
    case 3: launch_decode<3>(x, codes, planes, y, N, K, layer, s); break;
    case 4: launch_decode<4>(x, codes, planes, y, N, K, layer, s); break;
    case 5: launch_decode<5>(x, codes, planes, y, N, K, layer, s); break;
    case 6: launch_decode<6>(x, codes, planes, y, N, K, layer, s); break;
    case 7: launch_decode<7>(x, codes, planes, y, N, K, layer, s); break;
    case 8: launch_decode<8>(x, codes, planes, y, N, K, layer, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace mgt
