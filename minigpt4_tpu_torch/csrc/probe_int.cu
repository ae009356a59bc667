// probe_int: integer dot products with i8 and int4 operands, the questions
// of tools/probe_int4.py.
//
// Replaces tools/probe_int4.py:103, the Pallas kernel with an int4 operand
// (arm D), and answers its XLA arms A-C with kernels of the same function.
// One entry, three modes, each y[m, n] over K:
//
//   0 i8xi8  y = sum_k x[m, k] * w[n, k]             x, w i8   -> i32
//   1 s4xs4  y = sum_k x[m, k] * w[n, k]             x, w s4   -> i32
//   2 s4_sb  y = sum_g f32(sum_{k in g} x[m, k] * w[n, k]) * scale[n, g]
//            (g: 256-wide chunks, summed in chunk order)  x i8, w s4 -> f32
//
// int4 codes are stored two per byte along K, code 2j in the low nibble of
// byte j, as two's complement (-8..7).
//
// What bounds them on the H100: device-memory bandwidth on w (1 B per
// weight for i8, 0.5 B for s4).  ptxas (CUDA 12.9) takes
// mma.sync.aligned.m16n8k64.row.col.s32.s4.s4.s32 for sm_90a, so mode 1 uses
// it; the card has no int4 tensor-core instruction, and ptxas lowers each
// one to two IMMA.16832.S8.S8 after unpacking (tools/probe_int4.py reads the
// SASS of the built library and prints it).
//
// Modes 0 and 2 follow csrc/i8_matmul.cu's decode kernel: a half-warp per
// 2 columns, 256 codes per step (16 lanes x 16 i8 bytes, or x 8 bytes of
// nibbles), __dp4a, the exact i32 of the step summed over the half-warp.
// Mode 2 unpacks 8 nibbles of a word into two words of sign-extended bytes
// (even and odd codes; the activation bytes are permuted to match with
// __byte_perm), and adds f32(chunk) * scale in chunk order, product and sum
// rounded apart, as the plain version does.  Mode 1: a warp owns 8 columns
// and runs one m16n8k64 per 64 codes, rows m >= M of the A fragment zero (at
// M = 1 fifteen of its sixteen rows are padding).
#include "common.cuh"

namespace {

constexpr int kSB = 256;
constexpr int kWarps = 8;
constexpr int kColsPerHalf = 2;
constexpr int kBN = kWarps * 2 * kColsPerHalf;  // 32 columns per block

using mgt::dot16;
using mgt::half_warp_sum;

// bytes 0, 2 and 4, 6 of the 8-byte (a, b) ... the even bytes of a:b, and the odd ones
__device__ __forceinline__ int even_bytes(int a, int b) { return __byte_perm(a, b, 0x6420); }
__device__ __forceinline__ int odd_bytes(int a, int b) { return __byte_perm(a, b, 0x7531); }

// 8 int4 codes of a word -> the even codes (0, 2, 4, 6) and the odd codes as
// sign-extended bytes
__device__ __forceinline__ void s4_to_s8(unsigned w, int& even, int& odd) {
  even = static_cast<int>(__vsub4((w & 0x0f0f0f0fu) ^ 0x08080808u, 0x08080808u));
  odd = static_cast<int>(__vsub4(((w >> 4) & 0x0f0f0f0fu) ^ 0x08080808u, 0x08080808u));
}

// the dot of 16 int4 codes (uint2) with 16 i8 activations (int4)
__device__ __forceinline__ int dot16_s4(const uint2& w, const int4& x) {
  int e0, o0, e1, o1;
  s4_to_s8(w.x, e0, o0);
  s4_to_s8(w.y, e1, o1);
  int s = __dp4a(e0, even_bytes(x.x, x.y), 0);
  s = __dp4a(o0, odd_bytes(x.x, x.y), s);
  s = __dp4a(e1, even_bytes(x.z, x.w), s);
  return __dp4a(o1, odd_bytes(x.z, x.w), s);
}

template <int M, int MODE>
__global__ void __launch_bounds__(kWarps * 32)
half_warp_kernel(const int8_t* __restrict__ x, const uint8_t* __restrict__ w,
                 const float* __restrict__ scales, void* __restrict__ y, int N, int K) {
  constexpr int kWB = MODE == 0 ? 16 : 8;  // weight bytes per lane and step
  const int G = K / kSB;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int half = lane / 16, hl = lane % 16;
  const int n0 = blockIdx.x * kBN + (warp * 2 + half) * kColsPerHalf;
  const size_t row = static_cast<size_t>(K) * kWB / 16;  // weight bytes per row

  int iacc[kColsPerHalf][M];
  float facc[kColsPerHalf][M];
#pragma unroll
  for (int c = 0; c < kColsPerHalf; ++c)
#pragma unroll
    for (int m = 0; m < M; ++m) {
      iacc[c][m] = 0;
      facc[c][m] = 0.f;
    }

#pragma unroll 2
  for (int g = 0; g < G; ++g) {
    const int k0 = g * kSB + hl * 16;
    int4 wi[kColsPerHalf];
    uint2 wn[kColsPerHalf];
    float s[kColsPerHalf];
#pragma unroll
    for (int c = 0; c < kColsPerHalf; ++c) {
      const int n = n0 + c;
      wi[c] = make_int4(0, 0, 0, 0);
      wn[c] = make_uint2(0, 0);
      s[c] = 0.f;
      if (n < N) {
        const uint8_t* p = w + static_cast<size_t>(n) * row + static_cast<size_t>(k0) * kWB / 16;
        if constexpr (MODE == 0) {
          wi[c] = __ldg(reinterpret_cast<const int4*>(p));
        } else {
          wn[c] = __ldg(reinterpret_cast<const uint2*>(p));
          s[c] = __ldg(scales + static_cast<size_t>(n) * G + g);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int4 xv = __ldg(reinterpret_cast<const int4*>(x + static_cast<size_t>(m) * K + k0));
#pragma unroll
      for (int c = 0; c < kColsPerHalf; ++c) {
        if constexpr (MODE == 0) {
          iacc[c][m] += half_warp_sum(dot16(xv, wi[c]));
        } else {
          const int total = half_warp_sum(dot16_s4(wn[c], xv));
          facc[c][m] = __fadd_rn(facc[c][m], __fmul_rn(static_cast<float>(total), s[c]));
        }
      }
    }
  }

  if (hl == 0) {
#pragma unroll
    for (int c = 0; c < kColsPerHalf; ++c) {
      const int n = n0 + c;
      if (n >= N) continue;
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const size_t o = static_cast<size_t>(m) * N + n;
        if constexpr (MODE == 0) static_cast<int*>(y)[o] = iacc[c][m];
        else static_cast<float*>(y)[o] = facc[c][m];
      }
    }
  }
}

__device__ __forceinline__ void mma_s4(int (&d)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k64.row.col.s32.s4.s4.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// mode 1.  Fragments of m16n8k64 (PTX ISA, "Matrix Fragments for
// mma.m16n8k64"): lane (g = lane / 4, t = lane % 4) holds A rows g and g + 8
// at codes 8t..8t+7 (a0, a1) and 32+8t.. (a2, a3), B column g at codes
// 8t..8t+7 and 32+8t.., and D rows g, g + 8 at columns 2t, 2t + 1; a 32-bit
// word of K-order nibbles is exactly 8 consecutive codes.
__global__ void __launch_bounds__(kWarps * 32)
s4_mma_kernel(const unsigned* __restrict__ x, const unsigned* __restrict__ w, int* __restrict__ y,
              int M, int N, int K) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int n0 = (blockIdx.x * kWarps + warp) * 8;
  if (n0 >= N) return;  // the whole warp
  const int n = n0 + g;
  const size_t kw = static_cast<size_t>(K) / 8;  // words per row
  const unsigned* xr0 = x + static_cast<size_t>(g) * kw;
  const unsigned* xr1 = x + static_cast<size_t>(g + 8) * kw;
  const unsigned* wr = w + static_cast<size_t>(n) * kw;
  const bool r0 = g < M, r1 = g + 8 < M, col = n < N;
  int d[4] = {0, 0, 0, 0};
#pragma unroll 4
  for (size_t k = 0; k < kw; k += 8) {
    const unsigned a[4] = {r0 ? __ldg(xr0 + k + t) : 0u, r1 ? __ldg(xr1 + k + t) : 0u,
                           r0 ? __ldg(xr0 + k + 4 + t) : 0u, r1 ? __ldg(xr1 + k + 4 + t) : 0u};
    const unsigned b[2] = {col ? __ldg(wr + k + t) : 0u, col ? __ldg(wr + k + 4 + t) : 0u};
    mma_s4(d, a, b);
  }
  const int c = n0 + 2 * t;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = g + (i / 2) * 8, cc = c + (i % 2);
    if (m < M && cc < N) y[static_cast<size_t>(m) * N + cc] = d[i];
  }
}

template <int MODE>
int launch_half_warp(const void* x, const void* w, const void* scales, void* y, int M, int N,
                     int K, cudaStream_t s) {
  const dim3 grid((N + kBN - 1) / kBN), block(kWarps * 32);
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* wp = static_cast<const uint8_t*>(w);
  const auto* sp = static_cast<const float*>(scales);
  switch (M) {
    case 1: half_warp_kernel<1, MODE><<<grid, block, 0, s>>>(xp, wp, sp, y, N, K); break;
    case 2: half_warp_kernel<2, MODE><<<grid, block, 0, s>>>(xp, wp, sp, y, N, K); break;
    case 3: half_warp_kernel<3, MODE><<<grid, block, 0, s>>>(xp, wp, sp, y, N, K); break;
    case 4: half_warp_kernel<4, MODE><<<grid, block, 0, s>>>(xp, wp, sp, y, N, K); break;
    case 5: half_warp_kernel<5, MODE><<<grid, block, 0, s>>>(xp, wp, sp, y, N, K); break;
    case 6: half_warp_kernel<6, MODE><<<grid, block, 0, s>>>(xp, wp, sp, y, N, K); break;
    case 7: half_warp_kernel<7, MODE><<<grid, block, 0, s>>>(xp, wp, sp, y, N, K); break;
    case 8: half_warp_kernel<8, MODE><<<grid, block, 0, s>>>(xp, wp, sp, y, N, K); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: i8 [M, K] (modes 0, 2) or s4 nibbles [M, K/2] (mode 1); w: i8 [N, K]
// (mode 0) or s4 nibbles [N, K/2]; scales f32 [N, K/256] (mode 2, else
// unused); y: i32 [M, N] (modes 0, 1) or f32.  K % 256 == 0; 1 <= M <= 8
// (modes 0, 2) or 16 (mode 1); 16-byte aligned operands.
MGT_API int mgt_probe_int_dot(const void* x, const void* w, const void* scales, void* y, int mode,
                              int M, int N, int K, void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (N <= 0 || K <= 0 || K % kSB || M < 1) return invalid;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: return launch_half_warp<0>(x, w, nullptr, y, M, N, K, s);
    case 1: {
      if (M > 16) return invalid;
      const int blocks = (N + kWarps * 8 - 1) / (kWarps * 8);
      s4_mma_kernel<<<blocks, kWarps * 32, 0, s>>>(static_cast<const unsigned*>(x),
                                                  static_cast<const unsigned*>(w),
                                                  static_cast<int*>(y), M, N, K);
      return static_cast<int>(cudaGetLastError());
    }
    case 2:
      if (scales == nullptr) return invalid;
      return launch_half_warp<2>(x, w, scales, y, M, N, K, s);
    default: return invalid;
  }
}
