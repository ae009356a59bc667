// gq_decode: group-quant matmul for M <= 8 activation rows.
//
// Replaces minigpt4_tpu/ops/group_i8.py:_kernel_exact (entry mgt_gq_decode)
// and _kernel_generic (entry mgt_gq_decode_generic), both reached through
// _run and qmatmul_group for M <= GQ_MAX_M: every decode-step matmul and
// every prefill bucket of at most 8 rows.
//
//   y[m, n] = sum_g A[g, n] * sum_{k in g} q[n, k] x[m, k] + B[g, n] * sum_{k in g} x[m, k]
//
// with the planes of common.cuh: exact q4_k/q5_k (group 32, A and B rebuilt
// in f32 from u8 sub-scales and f32 superblock scales) or generic (group 16
// or 32, bf16 A and B read as stored).
//
// What bounds it on the H100: device-memory bandwidth on the code stream,
// 1 B per weight plus the planes (~0.094 B per weight exact, 4/GS B per
// weight generic: 0.25 at GS 16), read once per call; at M = 8 the FP32 FMA
// issue rate and shared-memory reads of x come close to that bound as well.
//
// Design.  A block owns a strip of BN = 32 output columns (8 warps x 4
// columns).  Lanes stream each column's i8 codes along K with 16-byte loads;
// 16 codes always lie inside one group (16 divides GS), so a lane forms
// sum_k q*x and sum_k x over its 16 columns and applies that group's A and B
// once (the algebra of group_i8._combine, without the TPU's dual-i8
// activation split: x stays f32).  The planes of the K tile are staged in
// shared memory with the tile of x (f32 for exact planes, bf16 for generic
// ones: at M = 8 and GS = 16 the stage is 32 KB of x plus 2 x 4 KB of
// planes), so they are read once per block with coalesced loads.  Each lane
// keeps 4 x M partial sums in registers across all of K; one warp reduction
// per output at the end, no atomics, so results are deterministic.  The
// stacked-layer index selects the [L, ...] slice by pointer offset.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kCols = 4;        // output columns per warp
constexpr int kBN = kWarps * kCols;
constexpr int kKT = 1024;       // K tile staged in shared memory

template <int M, class P>
__global__ void __launch_bounds__(kWarps * 32)
gq_decode_kernel(const float* __restrict__ x, const int8_t* __restrict__ codes, P planes,
                 float* __restrict__ y, int N, int K, int layer) {
  constexpr int GS = P::kGS;
  constexpr int kGT = kKT / GS;
  using T = typename P::T;
  __shared__ __align__(16) float xs[M][kKT];
  __shared__ T as[kGT][kBN];
  __shared__ T bs[kGT][kBN];

  const size_t li = static_cast<size_t>(layer);
  codes += li * N * K;
  planes.select_layer(li, N, K);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n0 = blockIdx.x * kBN;
  const int c0 = warp * kCols;  // first column of this warp inside the strip

  float acc[kCols][M];
#pragma unroll
  for (int c = 0; c < kCols; ++c)
#pragma unroll
    for (int m = 0; m < M; ++m) acc[c][m] = 0.f;

  for (int kt = 0; kt < K; kt += kKT) {
    const int len = min(kKT, K - kt);  // a multiple of 8 * GS
    __syncthreads();                   // the previous tile is consumed
    const int len4 = len / 4;
    for (int i = threadIdx.x; i < M * len4; i += blockDim.x) {
      const int m = i / len4, c = i % len4;
      reinterpret_cast<float4*>(xs[m])[c] =
          __ldg(reinterpret_cast<const float4*>(x + static_cast<size_t>(m) * K + kt) + c);
    }
    const int glen = len / GS;
    for (int i = threadIdx.x; i < glen * kBN; i += blockDim.x) {
      const int g = i / kBN, c = i % kBN, n = n0 + c;
      const float2 ab = n < N ? planes.fetch(kt / GS + g, n, N) : make_float2(0.f, 0.f);
      as[g][c] = mgt::from_f32<T>(ab.x);
      bs[g][c] = mgt::from_f32<T>(ab.y);
    }
    __syncthreads();

    for (int kk = lane * 16; kk < len; kk += 32 * 16) {
      const int g = kk / GS;
      int4 q[kCols];
      float a[kCols], b[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int n = n0 + c0 + c;
        q[c] = make_int4(0, 0, 0, 0);
        if (n < N)
          q[c] = __ldg(reinterpret_cast<const int4*>(codes + static_cast<size_t>(n) * K + kt + kk));
        a[c] = mgt::to_f32(as[g][c0 + c]);
        b[c] = mgt::to_f32(bs[g][c0 + c]);
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
        for (int c = 0; c < kCols; ++c) {
          const int w[4] = {q[c].x, q[c].y, q[c].z, q[c].w};
          float p = 0.f;
#pragma unroll
          for (int j = 0; j < 16; ++j) p = fmaf(mgt::byte_as_float(w[j / 4], j % 4), xv[j], p);
          acc[c][m] = fmaf(a[c], p, fmaf(b[c], sx, acc[c][m]));
        }
      }
    }
  }

#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int n = n0 + c0 + c;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const float v = mgt::warp_sum(acc[c][m]);
      if (lane == 0 && n < N) y[static_cast<size_t>(m) * N + n] = v;
    }
  }
}

template <int M, class P>
void launch(const void* x, const void* codes, const P& planes, void* y, int N, int K, int layer,
            cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN);
  gq_decode_kernel<M, P><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(codes), planes,
      static_cast<float*>(y), N, K, layer);
}

template <class P>
int decode(const void* x, const void* codes, const P& planes, void* y, int M, int N, int K,
           int layer, void* stream) {
  if (N <= 0 || K <= 0 || K % (8 * P::kGS)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (M) {
    case 1: launch<1>(x, codes, planes, y, N, K, layer, s); break;
    case 2: launch<2>(x, codes, planes, y, N, K, layer, s); break;
    case 3: launch<3>(x, codes, planes, y, N, K, layer, s); break;
    case 4: launch<4>(x, codes, planes, y, N, K, layer, s); break;
    case 5: launch<5>(x, codes, planes, y, N, K, layer, s); break;
    case 6: launch<6>(x, codes, planes, y, N, K, layer, s); break;
    case 7: launch<7>(x, codes, planes, y, N, K, layer, s); break;
    case 8: launch<8>(x, codes, planes, y, N, K, layer, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x f32 [M, K]; codes i8 [L, N, K]; sc6/mn6 u8 [L, K/32, N]; d/dmin f32
// [L, K/256, N] (L = 1 for an unstacked weight); y f32 [M, N].
// Requires 1 <= M <= 8, K % 256 == 0 and 16-byte aligned x and codes.
MGT_API int mgt_gq_decode(const void* x, const void* codes, const void* sc6,
                          const void* mn6, const void* d, const void* dmin,
                          void* y, int M, int N, int K, int layer, void* stream) {
  const mgt::ExactPlanes planes{static_cast<const uint8_t*>(sc6), static_cast<const uint8_t*>(mn6),
                                static_cast<const float*>(d), static_cast<const float*>(dmin)};
  return decode(x, codes, planes, y, M, N, K, layer, stream);
}

// x f32 [M, K]; codes i8 [L, N, K]; a/b bf16 [L, K/gs, N]; y f32 [M, N].
// Requires 1 <= M <= 8, gs 16 or 32, K % (8 * gs) == 0 and 16-byte aligned
// x and codes.
MGT_API int mgt_gq_decode_generic(const void* x, const void* codes, const void* a,
                                  const void* b, void* y, int M, int N, int K, int gs,
                                  int layer, void* stream) {
  const auto* pa = static_cast<const __nv_bfloat16*>(a);
  const auto* pb = static_cast<const __nv_bfloat16*>(b);
  if (gs == 16) return decode(x, codes, mgt::GenericPlanes<16>{pa, pb}, y, M, N, K, layer, stream);
  if (gs == 32) return decode(x, codes, mgt::GenericPlanes<32>{pa, pb}, y, M, N, K, layer, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

MGT_API const char* mgt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
