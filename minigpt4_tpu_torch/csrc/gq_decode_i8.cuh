// The gq matmul for M <= 8 activation rows on the integer units, with the
// dual-i8 split of the activations inside the launch (gq_decode.cu's
// entries).
//
// Replaces minigpt4_tpu/ops/group_i8.py:_kernel_exact (:522) and
// _kernel_generic (:550), reached through _run and qmatmul_group for
// M <= GQ_MAX_M, together with what qmatmul_group does around them:
// split_activations (:408), the true-x group sums sgt (:1002) and the
// per-group _combine (:435).  The function, for each row m and column n:
//
//   s1 = absmax(x[m]) / 127 (1 for a zero row);  x1 = clamp(rint(x / s1), +-127)
//   r = x - s1 x1;  s2 = s1 / 128;  x2 = clamp(rint(r / s2), +-127)
//   per group g: c1 = sum q x1, c2 = sum q x2 (exact i32);  sgt = sum x (f32)
//   y += (c1 s1 + c2 s2) A[g, n] + sgt B[g, n]
//
// with every product and sum of the last line rounded on its own (no fused
// multiply-add), as the TPU kernel and the plain version
// (ops/group_i8.qmatmul_decode_ref) write it.  A and B are the planes of
// common.cuh: exact q4_k/q5_k (A = d sc6, B = -dmin mn6, exact in f32) or
// generic bf16 (group 16 or 32).
//
// What bounds it on the H100: the code stream from device memory (1 B per
// weight for i8 codes, 0.5-0.75 B packed) plus the planes.  It reaches
// 33-62 % of that bound at M = 1 and 22-41 % at M = 8 (13B shapes,
// PERF.md): a warp's 16-byte code loads touch 32 rows (a lane a column), so
// the SM's memory pipe serves 32 lines per load beside the reads of x1 and
// x2 from shared memory (64 B per row, 32 codes and column), and the
// integer units (2 M __dp4a per 4 codes) come next.
//
// Design.
// * One launch.  Each block takes the absmax of every row of x over K (from
//   L2), then quantizes x a K tile at a time into shared memory: x1 and x2
//   bytes and the f32 group sums.  Blocks are persistent (a grid of at most
//   what fits on the card at once), so the split is paid once per block
//   and not once per strip of columns.
// * A block is 16 warps, one per K slice of the tile; lane l owns columns
//   l + 32 j (j < CPL) of a strip of 32 CPL columns.  CPL = 2 from M = 3
//   on: each x word read from shared memory (one address per warp: a
//   broadcast) then serves two columns (faster at every 13B shape, N =
//   5120 too); 1 at M = 1 and 2.  A thread streams its rows' codes 32 at a
//   time (two 16-byte loads of i8 codes; one of nibbles plus the high-bit
//   words), 2-3 units in flight, forms 8 words of 4 signed code bytes in K
//   order, and runs two __dp4a chains per group and row against x1 and
//   x2.  Packed codes become the same bytes (nibbles paired by
//   __byte_perm, high bits moved to bits 4-5 of each byte by carry-free
//   multiplies), so a packed weight gives its unpacked twin's bits.
// * The slices' partial sums meet in shared memory and are added in slice
//   order.  Every output is summed in one order that depends on M, K and
//   the group size alone: no atomics, the same bits from every launch, from
//   any CPL and grid, and for any N (a column slice of a weight gives the
//   whole width's bits).
// * The split's divisions give the IEEE quotient's rint: x / s1 is taken as
//   x * RN(1/s1), within 2.5 ulps of the rounded quotient, and only where
//   that lies within 2^-14 of a half-integer (where rint could differ) is
//   the quotient taken again by __fdiv_rn.
#pragma once

#include <algorithm>

#include "common.cuh"

namespace mgt {
namespace {

constexpr int kI8Slices = 16;                  // K slices per column: a warp each
constexpr int kI8Unit = 32;                    // codes a thread takes per step
constexpr int kI8Threads = 32 * kI8Slices;     // threads per block
constexpr int kI8MaxCpl = 2;                   // columns per lane: 2 from M = 3 rows on
constexpr int kRowFields = 8;                  // s1, s2, RN(1/s1), RN(1/s2), fast

// 32 codes of row n from column k (k % 32 == 0) as 8 words of 4 signed
// bytes in K order.
__device__ __forceinline__ void load_words(const I8Codes& c, int n, int k, int K, int (&w)[8]) {
  const int4* p = reinterpret_cast<const int4*>(c.codes + static_cast<size_t>(n) * K + k);
  const int4 a = __ldg(p), b = __ldg(p + 1);
  w[0] = a.x, w[1] = a.y, w[2] = a.z, w[3] = a.w;
  w[4] = b.x, w[5] = b.y, w[6] = b.z, w[7] = b.w;
}

template <int HB>
__device__ __forceinline__ void load_words(const NibbleCodes<HB>& c, int n, int k, int K,
                                           int (&w)[8]) {
  const size_t e = static_cast<size_t>(n) * K + k;  // a multiple of 32
  const uint4 nb = __ldg(reinterpret_cast<const uint4*>(c.codes + e / 2));
  uint32_t h0 = 0, h1 = 0;
  if constexpr (HB == 1) h0 = __ldg(c.hi + e / 32);
  if constexpr (HB == 2) {
    const uint2 h = __ldg(reinterpret_cast<const uint2*>(c.hi + e / 16));
    h0 = h.x, h1 = h.y;
  }
  const uint32_t v[4] = {nb.x, nb.y, nb.z, nb.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // byte b of v[i] holds codes 8i + 2b (low nibble) and 8i + 2b + 1
    const uint32_t lo = v[i] & 0x0F0F0F0Fu, hi = (v[i] >> 4) & 0x0F0F0F0Fu;
    uint32_t w0 = __byte_perm(lo, hi, 0x5140), w1 = __byte_perm(lo, hi, 0x7362);
    if constexpr (HB == 1) {
      // bit j of h0 is bit 4 of code j: 4 bits to bit 4 of 4 bytes
      w0 |= (((h0 >> (8 * i)) & 0xFu) * 0x02040810u) & 0x10101010u;
      w1 |= (((h0 >> (8 * i + 4)) & 0xFu) * 0x02040810u) & 0x10101010u;
    }
    if constexpr (HB == 2) {
      // bits 2j+1:2j of the pair (h0, h1) are bits 5:4 of code j
      const uint32_t h = i < 2 ? h0 : h1;
      const uint32_t p0 = (h >> (16 * (i & 1))) & 0xFFu, p1 = (h >> (16 * (i & 1) + 8)) & 0xFFu;
      w0 |= (((p0 & 0x33u) * 0x00010010u) & 0x00300030u) |
            (((p0 & 0xCCu) * 0x00400400u) & 0x30003000u);
      w1 |= (((p1 & 0x33u) * 0x00010010u) & 0x00300030u) |
            (((p1 & 0xCCu) * 0x00400400u) & 0x30003000u);
    }
    w[2 * i] = static_cast<int>(w0);
    w[2 * i + 1] = static_cast<int>(w1);
  }
}

// absmax of each row of x over K, then rowp[m] = (s1, s2, RN(1/s1), RN(1/s2),
// fast); all threads, ends with a barrier
template <int M>
__device__ void row_scales(const float* __restrict__ x, int K, float* rowp, float* scratch) {
  const int nt = blockDim.x, tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float mx[M];
#pragma unroll
  for (int m = 0; m < M; ++m) mx[m] = 0.f;
  for (int c = tid; c < K / 4; c += nt) {
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(x + static_cast<size_t>(m) * K) + c);
      mx[m] = fmaxf(mx[m], fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w))));
    }
  }
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const float v = warp_max(mx[m]);
    if (lane == 0) scratch[warp * M + m] = v;
  }
  __syncthreads();
  if (tid < M) {
    float ax = 0.f;
    for (int w = 0; w < nt / 32; ++w) ax = fmaxf(ax, scratch[w * M + tid]);
    const float s1 = ax == 0.f ? 1.f : __fdiv_rn(ax, 127.f);
    const float s2 = __fdiv_rn(s1, 128.f);
    float* r = rowp + tid * kRowFields;
    r[0] = s1;
    r[1] = s2;
    r[2] = __frcp_rn(s1);
    r[3] = __frcp_rn(s2);
    r[4] = s1 >= 0x1p-118f ? 1.f : 0.f;  // RN(1/s2) normal: the product path holds
  }
  __syncthreads();
}

// x[:, kt:kt+len] -> xs [M][UT][64 B] (x1 bytes then x2 bytes of each 32
// codes) and sg [M][KT/GS] (the f32 sum of each group, in K order); all
// threads
template <int M, int GS>
__device__ void split_tile(const float* __restrict__ x, int K, int kt, int len, int UT,
                           unsigned char* xs, float* sg, const float* rowp) {
  const int gt = len / GS, g_stride = UT * kI8Unit / GS;
  for (int i = threadIdx.x; i < M * gt; i += blockDim.x) {
    const int m = i / gt, g = i - m * gt;
    const float* r = rowp + m * kRowFields;
    const float s1 = r[0], s2 = r[1], y1 = r[2], y2 = r[3];
    const bool fast = r[4] != 0.f;
    const float4* xp =
        reinterpret_cast<const float4*>(x + static_cast<size_t>(m) * K + kt + g * GS);
    float sum = 0.f;
    int w1[GS / 4], w2[GS / 4];
#pragma unroll
    for (int c = 0; c < GS / 4; ++c) {
      const float4 v4 = __ldg(xp + c);
      const float v[4] = {v4.x, v4.y, v4.z, v4.w};
      float t1[4], t2[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sum = __fadd_rn(sum, v[j]);
        const float q1 = split_level(v[j], s1, y1, fast, t1[j]);
        split_level(__fsub_rn(v[j], __fmul_rn(s1, q1)), s2, y2, fast, t2[j]);
      }
      w1[c] = pack_low_bytes(t1[0], t1[1], t1[2], t1[3]);
      w2[c] = pack_low_bytes(t2[0], t2[1], t2[2], t2[3]);
    }
    sg[m * g_stride + g] = sum;
    unsigned char* base = xs + (static_cast<size_t>(m) * UT + g * GS / kI8Unit) * 64 +
                          (GS == 16 ? 16 * (g & 1) : 0);
    int4* d = reinterpret_cast<int4*>(base);
    d[0] = make_int4(w1[0], w1[1], w1[2], w1[3]);
    d[2] = make_int4(w2[0], w2[1], w2[2], w2[3]);
    if constexpr (GS == 32) {
      d[1] = make_int4(w1[4], w1[5], w1[6], w1[7]);
      d[3] = make_int4(w2[4], w2[5], w2[6], w2[7]);
    }
  }
}

// sum of 16 products of signed bytes, added to acc
__device__ __forceinline__ int dot16_acc(const int4& a, int w0, int w1, int w2, int w3, int acc) {
  acc = __dp4a(a.x, w0, acc);
  acc = __dp4a(a.y, w1, acc);
  acc = __dp4a(a.z, w2, acc);
  return __dp4a(a.w, w3, acc);
}

// (c1 s1 + c2 s2) A + sgt B, each product and sum rounded on its own
__device__ __forceinline__ float gq_term(int c1, int c2, float s1, float s2, float2 ab, float sg) {
  const float t = __fadd_rn(__fmul_rn(__int2float_rn(c1), s1), __fmul_rn(__int2float_rn(c2), s2));
  return __fadd_rn(__fmul_rn(t, ab.x), __fmul_rn(sg, ab.y));
}

// The codes and planes of one 32-code unit of CPL columns (n, n + 32, ...)
template <class P, class C, int CPL>
struct UnitLoad {
  static constexpr int kGroups = kI8Unit / P::kGS;
  int w[CPL][8];
  float2 ab[CPL][kGroups];

  __device__ __forceinline__ void load(const C& codes, const P& planes, int n, int N, int K,
                                       int k) {
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int nj = n + 32 * j;
      if (nj < N) {
        load_words(codes, nj, k, K, w[j]);
#pragma unroll
        for (int g = 0; g < kGroups; ++g) ab[j][g] = planes.fetch(k / P::kGS + g, nj, N);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) w[j][i] = 0;
#pragma unroll
        for (int g = 0; g < kGroups; ++g) ab[j][g] = make_float2(0.f, 0.f);
      }
    }
  }
};

// one unit's terms added to acc: x1 and x2 of each row read once from
// shared memory and used for the CPL columns
template <int M, int GS, int CPL, class U>
__device__ __forceinline__ void unit_terms(const U& cur, const unsigned char* xs, const float* sg,
                                           int ut, int gk, int u, const float (&s1)[M],
                                           const float (&s2)[M], float (&acc)[CPL][M]) {
  constexpr int kGroups = kI8Unit / GS;
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int4* xp = reinterpret_cast<const int4*>(xs + (static_cast<size_t>(m) * ut + u) * 64);
    const int4 a0 = xp[0], a1 = xp[1], b0 = xp[2], b1 = xp[3];
    const float* sgm = sg + m * gk + u * kGroups;
    const float g0 = sgm[0], g1 = GS == 16 ? sgm[1] : 0.f;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int(&w)[8] = cur.w[j];
      if constexpr (GS == 32) {
        const int c1 = dot16_acc(a1, w[4], w[5], w[6], w[7],
                                 dot16_acc(a0, w[0], w[1], w[2], w[3], 0));
        const int c2 = dot16_acc(b1, w[4], w[5], w[6], w[7],
                                 dot16_acc(b0, w[0], w[1], w[2], w[3], 0));
        acc[j][m] = __fadd_rn(acc[j][m], gq_term(c1, c2, s1[m], s2[m], cur.ab[j][0], g0));
      } else {
        const int c1a = dot16_acc(a0, w[0], w[1], w[2], w[3], 0);
        const int c2a = dot16_acc(b0, w[0], w[1], w[2], w[3], 0);
        const int c1b = dot16_acc(a1, w[4], w[5], w[6], w[7], 0);
        const int c2b = dot16_acc(b1, w[4], w[5], w[6], w[7], 0);
        acc[j][m] = __fadd_rn(acc[j][m], gq_term(c1a, c2a, s1[m], s2[m], cur.ab[j][0], g0));
        acc[j][m] = __fadd_rn(acc[j][m], gq_term(c1b, c2b, s1[m], s2[m], cur.ab[j][1], g1));
      }
    }
  }
}

// units a thread keeps in flight: deeper where the rows are few and the
// kernel waits on device memory
template <int M>
constexpr int kDepth = M <= 2 ? 3 : 2;

// x f32 [M, K] @ W.T -> y f32 [M, N]; a block is kI8Slices warps, a lane
// owns columns lane + 32 j (j < CPL) of the strip; dynamic shared memory as
// gq_decode_i8_smem computes it for the tile width KT
template <int M, int CPL, class P, class C>
__global__ void __launch_bounds__(kI8Threads, 1)
gq_decode_i8_kernel(const float* __restrict__ x, C codes, P planes, float* __restrict__ y, int N,
                    int K, int KT, int layer) {
  constexpr int GS = P::kGS;
  constexpr int SW = 32 * CPL;  // strip width
  constexpr int D = kDepth<M>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ut = KT / kI8Unit, gk = KT / GS;
  unsigned char* xs = smem;
  float* sg = reinterpret_cast<float*>(smem + static_cast<size_t>(M) * ut * 64);
  float* red = sg + M * gk;                // [kI8Slices][M][SW]
  float* rowp = red + kI8Slices * M * SW;  // [M][kRowFields]
  float* scratch = rowp + M * kRowFields;  // [kI8Slices][M]

  const size_t li = static_cast<size_t>(layer);
  codes.select_layer(li, N, K);
  planes.select_layer(li, N, K);
  const int tid = threadIdx.x, lane = tid % 32, slice = tid / 32;
  const int n_strips = (N + SW - 1) / SW;

  row_scales<M>(x, K, rowp, scratch);
  float s1[M], s2[M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    s1[m] = rowp[m * kRowFields];
    s2[m] = rowp[m * kRowFields + 1];
  }

  for (int kt = 0; kt < K; kt += KT) {
    const int len = min(KT, K - kt), units = len / kI8Unit;
    __syncthreads();  // the previous tile is consumed
    split_tile<M, GS>(x, K, kt, len, ut, xs, sg, rowp);
    __syncthreads();
    const int u0 = slice * units / kI8Slices, u1 = (slice + 1) * units / kI8Slices;
    for (int s = blockIdx.x; s < n_strips; s += gridDim.x) {
      const int n = s * SW + lane;
      float acc[CPL][M];
#pragma unroll
      for (int j = 0; j < CPL; ++j)
#pragma unroll
        for (int m = 0; m < M; ++m) acc[j][m] = 0.f;
      if (n < N) {
        // a ring of D units in flight: unit u + d sits in buf[d]
        UnitLoad<P, C, CPL> buf[D];
#pragma unroll
        for (int d = 0; d < D; ++d)
          if (u0 + d < u1) buf[d].load(codes, planes, n, N, K, kt + (u0 + d) * kI8Unit);
        for (int u = u0; u < u1; u += D) {
#pragma unroll
          for (int d = 0; d < D; ++d) {
            if (u + d < u1) {
              unit_terms<M, GS, CPL>(buf[d], xs, sg, ut, gk, u + d, s1, s2, acc);
              if (u + d + D < u1) buf[d].load(codes, planes, n, N, K, kt + (u + d + D) * kI8Unit);
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < CPL; ++j)
#pragma unroll
        for (int m = 0; m < M; ++m) red[(slice * M + m) * SW + 32 * j + lane] = acc[j][m];
      __syncthreads();
      for (int i = tid; i < M * SW; i += kI8Threads) {
        const int m = i / SW, c = i % SW, nn = s * SW + c;
        if (nn < N) {
          float v = red[m * SW + c];
#pragma unroll
          for (int sl = 1; sl < kI8Slices; ++sl) v = __fadd_rn(v, red[(sl * M + m) * SW + c]);
          float* yp = y + static_cast<size_t>(m) * N + nn;
          *yp = kt == 0 ? v : __fadd_rn(*yp, v);  // K tiles in order, by the same thread
        }
      }
      __syncthreads();  // red is free for the next strip
    }
  }
}

// codes per K tile: the largest split of K into equal tiles (of whole
// 32-code units) whose x1, x2 and group sums fit in shared memory beside
// the widest strip's partial sums; depends on M, K and GS alone, so the
// summation order does too
inline int gq_decode_i8_tile(int M, int K, int GS) {
  const int per_unit = M * (64 + 4 * (kI8Unit / GS));
  const int fixed = kI8Slices * M * 32 * kI8MaxCpl * 4 + M * kRowFields * 4 + kI8Slices * M * 4;
  const int max_units = (kMaxSmem - fixed) / per_unit;
  const int units = K / kI8Unit;
  const int tiles = (units + max_units - 1) / max_units;
  return (units + tiles - 1) / tiles * kI8Unit;
}

inline int gq_decode_i8_smem(int M, int KT, int GS, int cpl) {
  return M * (KT / kI8Unit) * 64 + 4 * M * (KT / GS) + 4 * kI8Slices * M * 32 * cpl +
         4 * M * kRowFields + 4 * kI8Slices * M;
}

template <int M, int CPL, class P, class C>
int gq_decode_i8_run(const void* x, const C& codes, const P& planes, void* y, int N, int K,
                     int layer, cudaStream_t stream) {
  constexpr int GS = P::kGS;
  auto* kern = gq_decode_i8_kernel<M, CPL, P, C>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int kt = gq_decode_i8_tile(M, K, GS);
  const int smem = gq_decode_i8_smem(M, kt, GS, CPL);
  const int occ = blocks_per_sm(kern, kI8Threads, smem);
  if (occ < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int n_strips = (N + 32 * CPL - 1) / (32 * CPL);
  const dim3 grid(std::min(n_strips, occ * device_sms()));
  kern<<<grid, kI8Threads, smem, stream>>>(static_cast<const float*>(x), codes, planes,
                                           static_cast<float*>(y), N, K, kt, layer);
  return static_cast<int>(cudaGetLastError());
}

// x f32 [M, K], y f32 [M, N]; 1 <= M <= 8, K % 32 == 0 and K % GS == 0,
// 16-byte aligned x and codes (8-byte aligned high bits)
template <class P, class C>
int gq_decode_i8(const void* x, const C& codes, const P& planes, void* y, int M, int N, int K,
                 int layer, void* stream) {
  if (N <= 0 || K <= 0 || K % kI8Unit || K % P::kGS) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (M) {
    case 1: return gq_decode_i8_run<1, 1>(x, codes, planes, y, N, K, layer, s);
    case 2: return gq_decode_i8_run<2, 1>(x, codes, planes, y, N, K, layer, s);
    case 3: return gq_decode_i8_run<3, 2>(x, codes, planes, y, N, K, layer, s);
    case 4: return gq_decode_i8_run<4, 2>(x, codes, planes, y, N, K, layer, s);
    case 5: return gq_decode_i8_run<5, 2>(x, codes, planes, y, N, K, layer, s);
    case 6: return gq_decode_i8_run<6, 2>(x, codes, planes, y, N, K, layer, s);
    case 7: return gq_decode_i8_run<7, 2>(x, codes, planes, y, N, K, layer, s);
    case 8: return gq_decode_i8_run<8, 2>(x, codes, planes, y, N, K, layer, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace mgt
