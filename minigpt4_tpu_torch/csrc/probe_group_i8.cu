// probe_group_i8: the exact-q5_k matmul with i8 codes and dual-i8
// activations, on the integer units.
//
// Replaces tools/qmm_group_i8.py:_kernel (:75), reached through _run (:99)
// and its pl.pallas_call (:115).  Both compute, per output (m, n),
//
//   y[m, n] = sum_g sc[g, n] * (s1[m] * c1[g, m, n] + s2[m] * c2[g, m, n])
//                 + sgt[g, m] * bt[g, n]
//   c1[g, m, n] = sum_{k in g} q[n, k] * x1[m, k],  c2 likewise over x2,
//
// over groups g of 32 codes: q the 5-bit codes 0..31 stored as i8 [L, N, K],
// x ~= s1 * x1 + s2 * x2 the dual-i8 split of each activation row
// (ops/probes.split_activations), sc / bt the bf16 per-group scale and bias
// planes [L, G, N], and sgt [G, M] the f32 group sums of x.  c1 and c2 are
// exact i32; the combination runs in f32 as t = s1 * c1 + s2 * c2, then
// acc += t * sc + sgt * bt, each product and sum rounded on its own (no
// fused multiply-add), as the TPU kernel and the plain version write it.
// The TPU kernel masks 16 M activation rows to single groups so one MXU
// dot yields the per-group partials; nothing of that carries over here.
//
// What bounds it on the H100: device-memory bandwidth on the code stream,
// 1 B per weight plus 1/8 B of planes; two __dp4a chains per 16 codes and
// row (4 multiply-adds each) stay below the integer issue rate.
//
// Design (that of csrc/i8_matmul.cu's decode kernel).  A block owns 32
// output columns (8 warps x 2 halves x 2 columns); a half-warp walks its
// columns along K in 256-code chunks, one 16-byte load of codes per lane.
// Lanes 2j and 2j+1 hold group j of the chunk: each forms its 16-code dot
// products over x1 and over x2 with __dp4a, one shuffle adds the pair (an
// exact i32), and the even lane adds the group's f32 term to its
// accumulator.  A shuffle tree over the even lanes gives y.  x1, x2 (M x K
// bytes each), s12 and sgt are read through the read-only cache.  No shared
// memory, no atomics; results are deterministic.
#include "common.cuh"

namespace {

constexpr int kGS = 32;   // group size of q5_k
constexpr int kSB = 256;  // codes per half-warp step (16 lanes x 16 bytes)
constexpr int kWarps = 8;
constexpr int kColsPerHalf = 2;
constexpr int kBN = kWarps * 2 * kColsPerHalf;  // 32 columns per block

using mgt::dot16;

template <int M>
__global__ void __launch_bounds__(kWarps * 32)
probe_group_i8_kernel(const int8_t* __restrict__ x1, const int8_t* __restrict__ x2,
                      const float* __restrict__ s12, const float* __restrict__ sgt,
                      const int8_t* __restrict__ codes, const __nv_bfloat16* __restrict__ sct,
                      const __nv_bfloat16* __restrict__ bt, float* __restrict__ y, int N, int K,
                      int layer) {
  const int G = K / kGS;
  const size_t li = static_cast<size_t>(layer);
  codes += li * N * K;
  sct += li * G * N;
  bt += li * G * N;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int half = lane / 16, hl = lane % 16;
  const int n0 = blockIdx.x * kBN + (warp * 2 + half) * kColsPerHalf;
  const bool even = (hl & 1) == 0;

  float s1[M], s2[M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    s1[m] = __ldg(s12 + 2 * m);
    s2[m] = __ldg(s12 + 2 * m + 1);
  }
  float acc[kColsPerHalf][M];
#pragma unroll
  for (int c = 0; c < kColsPerHalf; ++c)
#pragma unroll
    for (int m = 0; m < M; ++m) acc[c][m] = 0.f;

#pragma unroll 2
  for (int k0 = hl * 16; k0 < K; k0 += kSB) {
    const int g = k0 / kGS;
    int4 w[kColsPerHalf];
    float sc[kColsPerHalf], b[kColsPerHalf];
#pragma unroll
    for (int c = 0; c < kColsPerHalf; ++c) {
      const int n = n0 + c;
      w[c] = make_int4(0, 0, 0, 0);
      sc[c] = b[c] = 0.f;
      if (n < N) {
        w[c] = __ldg(reinterpret_cast<const int4*>(codes + static_cast<size_t>(n) * K + k0));
        sc[c] = __bfloat162float(sct[static_cast<size_t>(g) * N + n]);
        b[c] = __bfloat162float(bt[static_cast<size_t>(g) * N + n]);
      }
    }
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int4 xa = __ldg(reinterpret_cast<const int4*>(x1 + static_cast<size_t>(m) * K + k0));
      const int4 xb = __ldg(reinterpret_cast<const int4*>(x2 + static_cast<size_t>(m) * K + k0));
      const float sg = __ldg(sgt + static_cast<size_t>(g) * M + m);
#pragma unroll
      for (int c = 0; c < kColsPerHalf; ++c) {
        int c1 = dot16(xa, w[c]);
        int c2 = dot16(xb, w[c]);
        c1 += __shfl_xor_sync(mgt::kFullMask, c1, 1);  // the group's two halves: exact
        c2 += __shfl_xor_sync(mgt::kFullMask, c2, 1);
        const float t = __fadd_rn(__fmul_rn(static_cast<float>(c1), s1[m]),
                                  __fmul_rn(static_cast<float>(c2), s2[m]));
        const float term = __fadd_rn(__fmul_rn(t, sc[c]), __fmul_rn(sg, b[c]));
        if (even) acc[c][m] = __fadd_rn(acc[c][m], term);
      }
    }
  }

#pragma unroll
  for (int c = 0; c < kColsPerHalf; ++c) {
    const int n = n0 + c;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      float v = acc[c][m];  // odd lanes hold 0
#pragma unroll
      for (int o = 8; o > 1; o >>= 1) v += __shfl_xor_sync(mgt::kFullMask, v, o);
      if (hl == 0 && n < N) y[static_cast<size_t>(m) * N + n] = v;
    }
  }
}

template <int M>
void launch(const void* x1, const void* x2, const void* s12, const void* sgt, const void* codes,
            const void* sct, const void* bt, void* y, int N, int K, int layer, cudaStream_t s) {
  const dim3 grid((N + kBN - 1) / kBN);
  probe_group_i8_kernel<M><<<grid, kWarps * 32, 0, s>>>(
      static_cast<const int8_t*>(x1), static_cast<const int8_t*>(x2),
      static_cast<const float*>(s12), static_cast<const float*>(sgt),
      static_cast<const int8_t*>(codes), static_cast<const __nv_bfloat16*>(sct),
      static_cast<const __nv_bfloat16*>(bt), static_cast<float*>(y), N, K, layer);
}

}  // namespace

// x1, x2 i8 [M, K]; s12 f32 [M, 2] (s1, s2 per row); sgt f32 [G, M]; codes
// i8 [L, N, K]; sct, bt bf16 [L, G, N]; y f32 [M, N].  1 <= M <= 8,
// K % 256 == 0, 16-byte aligned x1, x2 and codes; layer selects the slice.
MGT_API int mgt_probe_group_i8(const void* x1, const void* x2, const void* s12, const void* sgt,
                               const void* codes, const void* sct, const void* bt, void* y, int M,
                               int N, int K, int layer, void* stream) {
  if (N <= 0 || K <= 0 || K % kSB || layer < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (M) {
    case 1: launch<1>(x1, x2, s12, sgt, codes, sct, bt, y, N, K, layer, s); break;
    case 2: launch<2>(x1, x2, s12, sgt, codes, sct, bt, y, N, K, layer, s); break;
    case 3: launch<3>(x1, x2, s12, sgt, codes, sct, bt, y, N, K, layer, s); break;
    case 4: launch<4>(x1, x2, s12, sgt, codes, sct, bt, y, N, K, layer, s); break;
    case 5: launch<5>(x1, x2, s12, sgt, codes, sct, bt, y, N, K, layer, s); break;
    case 6: launch<6>(x1, x2, s12, sgt, codes, sct, bt, y, N, K, layer, s); break;
    case 7: launch<7>(x1, x2, s12, sgt, codes, sct, bt, y, N, K, layer, s); break;
    case 8: launch<8>(x1, x2, s12, sgt, codes, sct, bt, y, N, K, layer, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
