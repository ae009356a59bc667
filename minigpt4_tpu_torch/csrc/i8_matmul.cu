// i8_matmul: the w8a8 matmul, i8 activations times i8 weight codes.
//
// Replaces minigpt4_tpu/ops/i8_matmul.py:_kernel, reached through _run and
// qmatmul_i8sb with a static layer index or an unstacked weight (:208) and
// with a traced layer index by scalar prefetch (:193); here the layer index
// is one argument and selects the [L, ...] slice by pointer offset, so one
// entry covers both.  Both TPU paths compute, per output (m, n),
//
//   y[m, n] = sum_g f32(sum_{k in chunk g} x[m, k] * codes[n, k]) * scale[n, g]
//
// over 256-wide chunks g: the chunk's product is an exact i32, and the f32
// sum runs in chunk order.  The per-row activation scale multiplies y in the
// wrapper (ops/i8_matmul.py), as in the JAX package.  Both entries require
// K % 256 == 0 and refuse other K with cudaErrorInvalidValue.
//
// What bounds it on the H100.  mgt_i8_decode (M <= 8): device-memory
// bandwidth on the code stream, 1 B per weight plus 4 B of scale per 256
// weights; the i32 dot products (__dp4a, 4 multiply-adds per instruction)
// stay far below the instruction rate.  mgt_i8_prefill (M > 8): at the 512-row
// bucket and the 257-row ViT chunk the s8 tensor-core rate (2 M N K
// operations); at the 32-row Q-Former chunk the code stream again.
//
// mgt_i8_decode.  A block owns 32 output columns (8 warps x 4); each half of
// a warp owns 2 columns and walks their rows chunk by chunk in order.  A
// 256-code chunk of one row is 16 lanes x 16 bytes, one coalesced 256-byte
// read; each lane forms its 16-byte dot products with __dp4a, the half-warp
// adds the 16 partial i32 with shuffles (integer adds, so the chunk total is
// exact in any order), and every lane of the half then adds f32(total) *
// scale[n, g] to its f32 accumulator: the chunk order of the TPU kernel.
// x (at most 8 x K bytes) is read through the read-only cache.  No shared
// memory, no atomics; results are deterministic.
//
// mgt_i8_prefill.  A block computes a 64 x 64 output tile with four warps of
// 32 x 32.  Per 256-wide chunk it stages the 64 x 256 tiles of x and of the
// codes in shared memory (rows padded to 272 bytes, so the fragment reads of
// eight rows fall in distinct banks) and runs eight k-steps of
// mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 (inline PTX).  That
// instruction's accumulator layout is documented (PTX ISA, "Matrix Fragments
// for mma.m16n8k32"): thread (group g = lane / 4, t = lane % 4) holds rows g
// and g + 8, columns 2t and 2t + 1 of each 16 x 8 tile.  So after the
// chunk's eight k-steps each thread knows the column of each of its exact
// i32 values, multiplies by that column's chunk scale in registers, adds to
// its f32 accumulators and clears the i32 fragment.  WMMA's s8 accumulator
// fragments have an unspecified element layout: applying per-column scales
// after every chunk would need a round trip through shared memory each
// time, which is why this kernel uses mma.sync directly.  Later work: wgmma,
// TMA and a multi-stage shared-memory ring.
#include "common.cuh"

namespace {

constexpr int kSB = 256;  // superblock: one scale, one exact i32 chunk

// ---------------------------------------------------------------------------
// decode: M <= 8
// ---------------------------------------------------------------------------

constexpr int kDecWarps = 8;
constexpr int kDecColsPerHalf = 2;
constexpr int kDecBN = kDecWarps * 2 * kDecColsPerHalf;  // 32 columns per block

using mgt::dot16;
using mgt::half_warp_sum;

template <int M>
__global__ void __launch_bounds__(kDecWarps * 32)
i8_decode_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ codes,
                 const float* __restrict__ scales, float* __restrict__ y, int N, int K,
                 int layer) {
  const int G = K / kSB;
  codes += static_cast<size_t>(layer) * N * K;
  scales += static_cast<size_t>(layer) * N * G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int half = lane / 16, hl = lane % 16;
  const int n0 = blockIdx.x * kDecBN + (warp * 2 + half) * kDecColsPerHalf;

  float acc[kDecColsPerHalf][M];
#pragma unroll
  for (int c = 0; c < kDecColsPerHalf; ++c)
#pragma unroll
    for (int m = 0; m < M; ++m) acc[c][m] = 0.f;

#pragma unroll 4
  for (int g = 0; g < G; ++g) {
    const size_t k0 = static_cast<size_t>(g) * kSB + hl * 16;
    int4 w[kDecColsPerHalf];
    float s[kDecColsPerHalf];
#pragma unroll
    for (int c = 0; c < kDecColsPerHalf; ++c) {
      const int n = n0 + c;
      w[c] = make_int4(0, 0, 0, 0);
      s[c] = 0.f;
      if (n < N) {
        w[c] = __ldg(reinterpret_cast<const int4*>(codes + static_cast<size_t>(n) * K + k0));
        s[c] = __ldg(scales + static_cast<size_t>(n) * G + g);
      }
    }
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int4 xv = __ldg(reinterpret_cast<const int4*>(x + static_cast<size_t>(m) * K + k0));
#pragma unroll
      for (int c = 0; c < kDecColsPerHalf; ++c) {
        const int total = half_warp_sum(dot16(xv, w[c]));
        acc[c][m] += static_cast<float>(total) * s[c];
      }
    }
  }

  if (hl == 0) {
#pragma unroll
    for (int c = 0; c < kDecColsPerHalf; ++c) {
      const int n = n0 + c;
      if (n >= N) continue;
#pragma unroll
      for (int m = 0; m < M; ++m) y[static_cast<size_t>(m) * N + n] = acc[c][m];
    }
  }
}

template <int M>
void launch_decode(const void* x, const void* codes, const void* scales, void* y, int N, int K,
                   int layer, cudaStream_t stream) {
  const dim3 grid((N + kDecBN - 1) / kDecBN);
  i8_decode_kernel<M><<<grid, kDecWarps * 32, 0, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(codes),
      static_cast<const float*>(scales), static_cast<float*>(y), N, K, layer);
}

// ---------------------------------------------------------------------------
// prefill: M > 8, s8 tensor cores
// ---------------------------------------------------------------------------

constexpr int kPreBM = 64;
constexpr int kPreBN = 64;
constexpr int kPreThreads = 128;
constexpr int kRow = kSB + 16;  // padded shared-memory row, bytes

__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ unsigned lds32(const int8_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

__global__ void __launch_bounds__(kPreThreads)
i8_prefill_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ codes,
                  const float* __restrict__ scales, float* __restrict__ y, int M, int N, int K,
                  int layer) {
  __shared__ __align__(16) int8_t xs[kPreBM * kRow];  // [m][k]
  __shared__ __align__(16) int8_t ws[kPreBN * kRow];  // [n][k]: column-major B
  const int G = K / kSB;
  codes += static_cast<size_t>(layer) * N * K;
  scales += static_cast<size_t>(layer) * N * G;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = lane / 4, t4 = lane % 4;
  const int m0 = blockIdx.y * kPreBM, n0 = blockIdx.x * kPreBN;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;

  float acc[2][4][4];
  int part[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  for (int g = 0; g < G; ++g) {
    const size_t k0 = static_cast<size_t>(g) * kSB;
    // 64 rows x 256 bytes of each operand, 16 bytes per thread and pass
    for (int i = tid; i < kPreBM * (kSB / 16); i += kPreThreads) {
      const int r = i / (kSB / 16), c16 = i % (kSB / 16);
      const int m = m0 + r, n = n0 + r;
      int4 xv = make_int4(0, 0, 0, 0), wv = make_int4(0, 0, 0, 0);
      if (m < M) xv = __ldg(reinterpret_cast<const int4*>(x + static_cast<size_t>(m) * K + k0) + c16);
      if (n < N) wv = __ldg(reinterpret_cast<const int4*>(codes + static_cast<size_t>(n) * K + k0) + c16);
      *reinterpret_cast<int4*>(xs + r * kRow + 16 * c16) = xv;
      *reinterpret_cast<int4*>(ws + r * kRow + 16 * c16) = wv;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) part[i][j][r] = 0;

#pragma unroll
    for (int kk = 0; kk < kSB; kk += 32) {
      unsigned a[2][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int8_t* row = xs + (wm + 16 * i + grp) * kRow + kk + 4 * t4;
        a[i][0] = lds32(row);
        a[i][1] = lds32(row + 8 * kRow);
        a[i][2] = lds32(row + 16);
        a[i][3] = lds32(row + 8 * kRow + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* col = ws + (wn + 8 * j + grp) * kRow + kk + 4 * t4;
        b[j][0] = lds32(col);
        b[j][1] = lds32(col + 16);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(part[i][j], a[i], b[j]);
    }

    // the chunk's exact i32 values times their column's scale, in chunk order
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + wn + 8 * j + 2 * t4;
      const float s0 = n < N ? __ldg(scales + static_cast<size_t>(n) * G + g) : 0.f;
      const float s1 = n + 1 < N ? __ldg(scales + static_cast<size_t>(n + 1) * G + g) : 0.f;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        acc[i][j][0] += static_cast<float>(part[i][j][0]) * s0;
        acc[i][j][1] += static_cast<float>(part[i][j][1]) * s1;
        acc[i][j][2] += static_cast<float>(part[i][j][2]) * s0;
        acc[i][j][3] += static_cast<float>(part[i][j][3]) * s1;
      }
    }
    __syncthreads();  // the tiles are consumed
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int m = m0 + wm + 16 * i + grp + (r >= 2 ? 8 : 0);
        const int n = n0 + wn + 8 * j + 2 * t4 + (r & 1);
        if (m < M && n < N) y[static_cast<size_t>(m) * N + n] = acc[i][j][r];
      }
}

int check_args(int M, int N, int K, int layer) {
  if (M < 1 || N < 1 || K < kSB || K % kSB || layer < 0) return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace

// x i8 [M, K]; codes i8 [L, N, K]; scales f32 [L, N, K/256] (L = 1 for an
// unstacked weight); y f32 [M, N], before the activation row scale.
// Requires 1 <= M <= 8, K % 256 == 0 and 16-byte aligned x and codes.
MGT_API int mgt_i8_decode(const void* x, const void* codes, const void* scales, void* y, int M,
                          int N, int K, int layer, void* stream) {
  if (const int rc = check_args(M, N, K, layer)) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (M) {
    case 1: launch_decode<1>(x, codes, scales, y, N, K, layer, s); break;
    case 2: launch_decode<2>(x, codes, scales, y, N, K, layer, s); break;
    case 3: launch_decode<3>(x, codes, scales, y, N, K, layer, s); break;
    case 4: launch_decode<4>(x, codes, scales, y, N, K, layer, s); break;
    case 5: launch_decode<5>(x, codes, scales, y, N, K, layer, s); break;
    case 6: launch_decode<6>(x, codes, scales, y, N, K, layer, s); break;
    case 7: launch_decode<7>(x, codes, scales, y, N, K, layer, s); break;
    case 8: launch_decode<8>(x, codes, scales, y, N, K, layer, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The same for any M >= 1 (the wrappers send M > 8 here) on the s8 tensor
// cores.  Requires K % 256 == 0 and 16-byte aligned x and codes.
MGT_API int mgt_i8_prefill(const void* x, const void* codes, const void* scales, void* y, int M,
                           int N, int K, int layer, void* stream) {
  if (const int rc = check_args(M, N, K, layer)) return rc;
  const dim3 grid((N + kPreBN - 1) / kPreBN, (M + kPreBM - 1) / kPreBM);
  i8_prefill_kernel<<<grid, kPreThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(codes),
      static_cast<const float*>(scales), static_cast<float*>(y), M, N, K, layer);
  return static_cast<int>(cudaGetLastError());
}
