// The quantized matmul for M <= 8 activation rows over repacked weights
// (rq_matmul.cu's mgt_rq_decode), x kept in f32:
//
//   y[m, n] = sum_k w[n, k] x[m, k],  w[n, k] = A[g, n] q[n, k] + B[g, n]
//
// with A = scale and B = -min of q's group g, and w formed as
// fmaf(A, q, B): A q is exact in f32 (a bf16 scale times a code of at most
// 8 bits), so w is the plain version's RN(scale q - min) bit for bit
// (ops/pallas_quant_matmul.qmatmul_repacked_ref), and only the f32
// summation order differs from it.
//
// What bounds it on the H100.  At M = 1 the weight stream from device
// memory (0.75 B per q5_k weight with its high bits and planes, 1.0 per
// q6_k).  At M = 8 the bound counts 2 M N K f32 operations at 67 TFLOP/s;
// every code costs M + 1 FMAs (its dequantization, then one per row of x)
// and about 3.5 integer and float operations to unpack, and the reads of
// x from shared memory (one float per C rows' FMAs) come first.  The kernel
// it replaces (qmm_decode.cuh) ran at 6-15 % of that bound (13B shapes,
// NVIDIA H100 80GB HBM3, 700 W): every block re-read all of x for its 32
// columns, each 1024-wide K tile drained the loads in flight before the
// next, and every code went through an int-to-float convert once per row
// of x.
//
// Design.
// * Persistent blocks (at most what fits on the card at once) stage x once
//   into shared memory, in float4 pieces swizzled so that the four lanes of
//   a quad read four banks groups (one wavefront per load).  Where M K f32
//   does not fit (M >= 5 at K = 13824), K is cut into equal tiles that do,
//   and the block walks its columns once per tile.
// * A block is nw warps, one per K slice: warp p takes the 128-code blocks
//   J = p, p + nw, ... of each row.  A warp is 8 quads; a quad owns C rows
//   and its lane l takes the 32-code unit 4 J + l of each: one 16-byte load
//   of nibbles (two of i8 codes), its high-bit words and the bf16 planes of
//   its groups.  A quad reads 64 contiguous bytes of each row per load.  C
//   (1 at M <= 2, else 2) is how many rows each x value read from shared
//   memory feeds: at M = 8 those reads (32 floats a clock per SM against
//   128 FMAs) set the pace; C = 4 would halve them but spills registers.
// * Loads run D tasks ahead in a register ring (rq_decode_run) over the
//   block's whole sequence of (strip, K block) tasks, so a
//   strip boundary does not drain them; the first D go out before x is
//   staged.  The loads are unconditional (a task past the end reads a
//   clamped address), which keeps the ring out of local memory, and task
//   positions advance by counters (no integer division, whose reciprocal
//   would cost an I2F).
// * Each code is unpacked once for all M rows and without I2F: its byte is
//   placed under the exponent of 2^23 (__byte_perm) and 2^23 subtracted
//   (exact for any 8-bit value), then dequantized by one FMA.  The q5 high
//   bits reach bit 4 of each byte by a carry-free multiply, q6's bits 4-5 by
//   two.
// * Sums: each lane adds its units in K order; the quad's four lanes are
//   added as ((l0 + l1) + (l2 + l3)), the nw slices in slice order in
//   shared memory, the K tiles in tile order.  nw and the tiles depend on M
//   and K alone, so every column's bits depend on M, K and the layout, never
//   on N, the grid or which block computes it.
#pragma once

#include <algorithm>

#include "common.cuh"

namespace mgt {
namespace {

constexpr int kRqUnit = 32;                  // codes of one row a lane loads at a time
constexpr int kRqQuads = 8;                  // quads per warp, each on its own rows
constexpr int kRqMaxWarps = 12;  // 384 threads: up to 168 registers a thread
constexpr float kTwo23 = 8388608.f;          // 2^23

// The raw words of one 32-code unit of one row: i8 codes (8 words) or
// nibbles (c[0..3]) with their high-bit words, and the bf16 bits of the
// unit's scale and min planes (one group in the low half at group size 32,
// two at 16).
struct RqUnit {
  uint32_t c[8];
  uint32_t h[2];
  uint2 ab;
};

__device__ __forceinline__ void load_codes(const I8Codes& s, int n, int k, int K, RqUnit& u) {
  const int4* p = reinterpret_cast<const int4*>(s.codes + static_cast<size_t>(n) * K + k);
  const int4 a = __ldg(p), b = __ldg(p + 1);
  u.c[0] = a.x, u.c[1] = a.y, u.c[2] = a.z, u.c[3] = a.w;
  u.c[4] = b.x, u.c[5] = b.y, u.c[6] = b.z, u.c[7] = b.w;
}

template <int HB>
__device__ __forceinline__ void load_codes(const NibbleCodes<HB>& s, int n, int k, int K,
                                           RqUnit& u) {
  const size_t e = static_cast<size_t>(n) * K + k;  // a multiple of 32
  const uint4 a = __ldg(reinterpret_cast<const uint4*>(s.codes + e / 2));
  u.c[0] = a.x, u.c[1] = a.y, u.c[2] = a.z, u.c[3] = a.w;
  if constexpr (HB == 1) u.h[0] = __ldg(s.hi + e / 32);
  if constexpr (HB == 2) {
    const uint2 h = __ldg(reinterpret_cast<const uint2*>(s.hi + e / 16));
    u.h[0] = h.x, u.h[1] = h.y;
  }
}

// Codes 8i .. 8i+7 of a unit as the bytes of two words.  kInterleaved:
// code 8i + 2b is byte b of lo and 8i + 2b + 1 byte b of hi (nibbles);
// otherwise codes 8i .. 8i+3 are lo's bytes, the next four hi's (i8).  A
// byte is the code plus kOffset - 2^23 (i8 codes are offset by 128).
template <class Codes>
struct RqBytes;

template <>
struct RqBytes<I8Codes> {
  static constexpr bool kInterleaved = false;
  static constexpr float kOffset = kTwo23 + 128.f;
  __device__ __forceinline__ static void word(const RqUnit& u, int i, uint32_t& lo, uint32_t& hi) {
    lo = u.c[2 * i] ^ 0x80808080u;
    hi = u.c[2 * i + 1] ^ 0x80808080u;
  }
};

template <int HB>
struct RqBytes<NibbleCodes<HB>> {
  static constexpr bool kInterleaved = true;
  static constexpr float kOffset = kTwo23;
  __device__ __forceinline__ static void word(const RqUnit& u, int i, uint32_t& lo, uint32_t& hi) {
    const uint32_t v = u.c[i];
    lo = v & 0x0F0F0F0Fu;
    hi = (v >> 4) & 0x0F0F0F0Fu;
    if constexpr (HB == 1) {
      // bit j of h[0] is bit 4 of code j: the even bits of the word's 8 to
      // bit 4 of lo's bytes, the odd ones of hi's (terms of the multiply
      // meet only below the kept bits)
      const uint32_t h = u.h[0] >> (8 * i);
      lo |= ((h & 0x55u) * 0x00410410u) & 0x10101010u;
      hi |= (((h >> 1) & 0x55u) * 0x00410410u) & 0x10101010u;
    }
    if constexpr (HB == 2) {
      // bits 2j+1:2j of the 16 bits of codes 8i .. 8i+7 are bits 5:4 of
      // code 8i + j: pairs 0 and 8 of the even codes by one multiply, 4
      // and 12 by another, the odd codes' pairs likewise after a shift
      const uint32_t p = (u.h[i >> 1] >> (16 * (i & 1))) & 0xFFFFu;
      lo |= (((p & 0x0303u) * 0x00001010u) & 0x00300030u) |
            (((p & 0x3030u) * 0x00010100u) & 0x30003000u);
      const uint32_t o = p >> 2;
      hi |= (((o & 0x0303u) * 0x00001010u) & 0x00300030u) |
            (((o & 0x3030u) * 0x00010100u) & 0x30003000u);
    }
  }
};

// code e (0..7) of a word pair as an exact float: the byte under the
// exponent of 2^23, then the offset subtracted
template <class Codes>
__device__ __forceinline__ float code_value(uint32_t lo, uint32_t hi, int e) {
  using B = RqBytes<Codes>;
  const uint32_t src = B::kInterleaved ? ((e & 1) ? hi : lo) : (e < 4 ? lo : hi);
  const int byte = B::kInterleaved ? e >> 1 : e & 3;
  return __fsub_rn(__uint_as_float(__byte_perm(src, 0x4B000000u, 0x7440 | byte)), B::kOffset);
}

// position of float4 piece j of unit u in the swizzled x tile
__device__ __forceinline__ int x_piece(int u, int j) { return 8 * u + (j ^ (u & 7)); }

// one unit of C rows against the M staged rows of x
template <int M, int C, int GS, class Codes>
__device__ __forceinline__ void rq_unit_terms(const RqUnit (&r)[C], const float4* __restrict__ xs,
                                              int kt4, int unit, float (&acc)[C][M]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t lo[C], hi[C];
#pragma unroll
    for (int c = 0; c < C; ++c) RqBytes<Codes>::word(r[c], i, lo[c], hi[c]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = 2 * i + h;  // the unit's codes 4j .. 4j+3
      const int g = 4 * j / GS;
      float w[C][4];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float a = __uint_as_float(g == 0 ? r[c].ab.x << 16 : r[c].ab.x & 0xFFFF0000u);
        const float b = -__uint_as_float(g == 0 ? r[c].ab.y << 16 : r[c].ab.y & 0xFFFF0000u);
#pragma unroll
        for (int e = 0; e < 4; ++e) w[c][e] = fmaf(a, code_value<Codes>(lo[c], hi[c], 4 * h + e), b);
      }
      const int p = x_piece(unit, j);
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const float4 xv = xs[m * kt4 + p];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          float s = fmaf(w[c][0], xv.x, acc[c][m]);
          s = fmaf(w[c][1], xv.y, s);
          s = fmaf(w[c][2], xv.z, s);
          acc[c][m] = fmaf(w[c][3], xv.w, s);
        }
      }
    }
  }
}

// The C rows' units of a task (strip s, K block J of the tile at kt).
// Branch-free: a row past N reads row N - 1 and a unit past the tile its
// last unit; such a unit is skipped and such a row never written.
template <int C, class P, class Codes>
__device__ __forceinline__ void rq_load(RqUnit (&r)[C], const Codes& codes, const P& planes,
                                        int s, int J, int quad, int q, int N, int K, int kt,
                                        int units) {
  const int unit = min(4 * J + q, units - 1);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int n = min((s * kRqQuads + quad) * C + c, N - 1);
    load_codes(codes, n, kt + kRqUnit * unit, K, r[c]);
    r[c].ab = planes.unit_bits(n, kt / kRqUnit + unit);
  }
}

// the next task: the warp's next K block of the strip, or the next strip
__device__ __forceinline__ void rq_next(int& s, int& j, int nj) {
  if (++j == nj) {
    j = 0;
    s += gridDim.x;
  }
}

// x f32 [M, K] @ W.T -> y f32 [M, N]; blockDim.x = 32 nw; dynamic shared
// memory as rq_decode_plan computes it for the tile width KT
template <int M, int C, int D, class P, class Codes>
__global__ void __launch_bounds__(kRqMaxWarps * 32)
rq_decode_kernel(const float* __restrict__ x, Codes codes, P planes, float* __restrict__ y, int N,
                 int K, int KT, int layer) {
  constexpr int SW = kRqQuads * C;  // rows of a strip
  extern __shared__ __align__(16) unsigned char rq_smem[];
  const int nw = blockDim.x / 32, kt4 = KT / 4;
  float4* xs = reinterpret_cast<float4*>(rq_smem);            // [M][KT / 4], swizzled
  float* red = reinterpret_cast<float*>(xs + M * kt4);        // [2][nw][SW][M]

  const size_t li = static_cast<size_t>(layer);
  codes.select_layer(li, N, K);
  planes.select_layer(li, N, K);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, quad = lane / 4, q = lane % 4;
  const int n_strips = (N + SW - 1) / SW;
  int my_strips = 0;
  for (int s = blockIdx.x; s < n_strips; s += gridDim.x) ++my_strips;
  int buf = 0;

  for (int kt = 0; kt < K; kt += KT) {
    const int len = min(KT, K - kt), units = len / kRqUnit, jt = (units + 3) / 4;
    int nj = 0;  // K blocks per warp and strip: ceil(jt / nw)
    for (int j = 0; j < jt; j += nw) ++nj;
    const int T = my_strips * nj;
    // the first D tasks' loads go out before x is staged
    RqUnit ring[D][C];
    int ls = blockIdx.x, lj = 0;  // the task the next load is for
#pragma unroll
    for (int d = 0; d < D; ++d) {  // unconditional: a task past T reads a clamped address
      rq_load(ring[d], codes, planes, ls, warp + lj * nw, quad, q, N, K, kt, units);
      rq_next(ls, lj, nj);
    }
    __syncthreads();  // the previous tile is consumed
    const int len4 = len / 4;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const float4* xm = reinterpret_cast<const float4*>(x + static_cast<size_t>(m) * K + kt);
      for (int c = tid; c < len4; c += blockDim.x)
        xs[m * kt4 + x_piece(c / 8, c % 8)] = __ldg(xm + c);
    }
    __syncthreads();

    float acc[C][M];
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int m = 0; m < M; ++m) acc[c][m] = 0.f;
    int cs = blockIdx.x, cj = 0;  // the task being consumed
    for (int t0 = 0; t0 < T; t0 += D) {
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const int t = t0 + d;
        if (t < T) {
          const int J = warp + cj * nw, unit = 4 * J + q;
          if (J < jt && unit < units) rq_unit_terms<M, C, P::kGS, Codes>(ring[d], xs, kt4, unit, acc);
          rq_load(ring[d], codes, planes, ls, warp + lj * nw, quad, q, N, K, kt, units);
          rq_next(ls, lj, nj);
          if (cj == nj - 1) {  // the strip's last K block: sum the slices, write y
            float* rb = red + buf * nw * SW * M;
#pragma unroll
            for (int c = 0; c < C; ++c)
#pragma unroll
              for (int m = 0; m < M; ++m) {
                float v = acc[c][m];
                v += __shfl_xor_sync(kFullMask, v, 1);
                v += __shfl_xor_sync(kFullMask, v, 2);
                if (q == 0) rb[(warp * SW + quad * C + c) * M + m] = v;
                acc[c][m] = 0.f;
              }
            __syncthreads();
            for (int i = tid; i < SW * M; i += blockDim.x) {
              const int r = i / M, m = i - r * M, n = cs * SW + r;
              if (n < N) {
                float v = rb[r * M + m];
                for (int w = 1; w < nw; ++w) v = __fadd_rn(v, rb[(w * SW + r) * M + m]);
                float* yp = y + static_cast<size_t>(m) * N + n;
                *yp = kt == 0 ? v : __fadd_rn(*yp, v);  // K tiles in order, by the same thread
              }
            }
            buf ^= 1;  // the other half of red takes the next strip's slices
          }
          rq_next(cs, cj, nj);
        }
      }
    }
  }
}

// slices (warps) for `steps` K blocks: the largest divisor in [8, 12], else
// all of them up to 12
inline int rq_decode_warps(int steps) {
  for (int w = kRqMaxWarps; w >= 8; --w)
    if (steps % w == 0) return w;
  return std::max(1, std::min(steps, kRqMaxWarps));
}

struct RqDecodePlan {
  int kt, nw, smem;
};

// the fewest equal K tiles whose x and slice sums fit in shared memory; a
// function of M and K alone (C follows M), so the summation order is too
inline RqDecodePlan rq_decode_plan(int M, int C, int K) {
  const int units = K / kRqUnit;
  for (int tiles = 1;; ++tiles) {
    const int kt = (units + tiles - 1) / tiles * kRqUnit;
    const int nw = rq_decode_warps((kt / kRqUnit + 3) / 4);
    const int smem = M * kt * 4 + 2 * nw * kRqQuads * C * M * 4;
    if (smem <= kMaxSmem) return {kt, nw, smem};
  }
}

// rows per lane C: 2 from M = 3 on (each x value read from shared memory
// feeds both), else 1; tasks in flight D: deeper where the rows are few
// (4 at M = 1, 3 at M = 2, else 2; more spills registers)
template <int M, class P, class Codes>
int rq_decode_run(const void* x, const Codes& codes, const P& planes, void* y, int N, int K,
                  int layer, cudaStream_t stream) {
  constexpr int C = M >= 3 ? 2 : 1;
  constexpr int D = M == 1 ? 4 : M == 2 ? 3 : 2;
  auto* kern = rq_decode_kernel<M, C, D, P, Codes>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const RqDecodePlan plan = rq_decode_plan(M, C, K);
  const int threads = 32 * plan.nw;
  const int occ = blocks_per_sm(kern, threads, plan.smem);
  if (occ < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int n_strips = (N + kRqQuads * C - 1) / (kRqQuads * C);
  const dim3 grid(std::min(n_strips, occ * device_sms()));
  kern<<<grid, threads, plan.smem, stream>>>(static_cast<const float*>(x), codes, planes,
                                             static_cast<float*>(y), N, K, plan.kt, layer);
  return static_cast<int>(cudaGetLastError());
}

// x f32 [M, K], y f32 [M, N]; 1 <= M <= 8, K % 32 == 0 and K % GS == 0,
// 16-byte aligned x and codes (8-byte aligned q6 high bits)
template <class P, class Codes>
int rq_decode(const void* x, const Codes& codes, const P& planes, void* y, int M, int N, int K,
              int layer, void* stream) {
  if (N <= 0 || K <= 0 || K % kRqUnit || K % P::kGS) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (M) {
    case 1: return rq_decode_run<1>(x, codes, planes, y, N, K, layer, s);
    case 2: return rq_decode_run<2>(x, codes, planes, y, N, K, layer, s);
    case 3: return rq_decode_run<3>(x, codes, planes, y, N, K, layer, s);
    case 4: return rq_decode_run<4>(x, codes, planes, y, N, K, layer, s);
    case 5: return rq_decode_run<5>(x, codes, planes, y, N, K, layer, s);
    case 6: return rq_decode_run<6>(x, codes, planes, y, N, K, layer, s);
    case 7: return rq_decode_run<7>(x, codes, planes, y, N, K, layer, s);
    case 8: return rq_decode_run<8>(x, codes, planes, y, N, K, layer, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace mgt
