// The dequantize-matvec of the unpack-chain probes (probe_qmm.cu,
// probe_qmm_km.cu): y[m, n] = sum_k x[m, k] * value(code[n, k]) * s[n, k / 32]
// in f32 for M <= 8, templated on how the codes are stored, how they are
// unpacked, how wide each lane's loads are and how the weight is laid out.
//
// Code storage (S) and value(code):
//   kDense  bf16 weights, value = the weight, no scale;
//   kI8     i8 codes, value = code (-128..127);
//   kNib    K-order nibbles, byte (n, j) = q[n, 2j] | q[n, 2j+1] << 4:
//           unsigned (value = q, 0..15) or signed (SIGNED; i4 stored ^ 0x8,
//           value = (q ^ 8) - 8, -8..7);
//   kQ5     nibbles + one high-bit plane hi u8 [N, K/8]: with nb = K / 8,
//           bit p of byte (n, i) is the high bit of code k = p * nb + i;
//           value = nibble value + 16 * bit;
//   kQ5D    nibbles + dual high-bit half-planes hi u8 [N, K/4]: the high bit
//           of code k = p * nb + i is bit p % 4 + 1 of byte (n, (p / 4) * nb
//           + i); value = nibble value + 16 * bit.
// Scales s are bf16 [N, K/32] in the nm layout and [K/32, N] in km.
//
// Unpack strategy (STRAT):
//   kShift  mask and shift each code to an integer, then one int-to-float
//           convert per code;
//   kMagic  build two f16 values 1024 + code per 32-bit word with one
//           __byte_perm (bytes) or mask-and-or (nibbles, high bits merged
//           into bit 4 of the mantissa), subtract the bias 1024 (1032 for
//           signed nibbles, 1152 for i8 codes xor 0x80) in f16, where every
//           value up to 2047 is exact, and widen to f32.
// Load width (W): 4 or 16 bytes of codes per lane and load.
// Layout: nm, w [N, K] with lanes along K (probe_qmm.cu); km, w [K, N] with
// lanes along N (probe_qmm_km.cu, dense, i8 and nibble storage; km nibbles
// pair two k of one column in a byte: byte (i, n) = q[n, 2i] | q[n, 2i+1] << 4).
#pragma once

#include <cuda_fp16.h>

#include "common.cuh"

namespace mgt {
namespace probe {

enum Storage : int { kDense = 0, kI8 = 1, kNib = 2, kQ5 = 3, kQ5D = 4 };
enum Strategy : int { kShift = 0, kMagic = 1 };

__host__ __device__ constexpr bool has_hi(int s) { return s == kQ5 || s == kQ5D; }
__host__ __device__ constexpr int codes_per_word(int s) { return s == kDense ? 2 : s == kI8 ? 4 : 8; }

__device__ __forceinline__ float2 magic_f32(uint32_t bits, uint32_t bias) {
  const __half2 h = __hsub2(*reinterpret_cast<const __half2*>(&bits),
                            *reinterpret_cast<const __half2*>(&bias));
  return __half22float2(h);
}

// The codes_per_word(S) values of one 32-bit word of codes, in the word's
// order.  For high-bit storage, h0 / h1 hold the high bits of codes 0-3 / 4-7
// at bit 0 of their bytes.
template <int S, bool SIGNED, int STRAT>
__device__ __forceinline__ void unpack(uint32_t w, uint32_t h0, uint32_t h1,
                                       float (&v)[codes_per_word(S)]) {
  if constexpr (S == kDense) {
    v[0] = __uint_as_float(w << 16);
    v[1] = __uint_as_float(w & 0xffff0000u);
  } else if constexpr (S == kI8) {
    if constexpr (STRAT == kShift) {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = static_cast<float>(static_cast<int>(w << (24 - 8 * j)) >> 24);
    } else {
      const uint32_t u = w ^ 0x80808080u;  // code + 128, 0..255
      const float2 a = magic_f32(__byte_perm(u, 0x64646464u, 0x4240), 0x64806480u);
      const float2 b = magic_f32(__byte_perm(u, 0x64646464u, 0x4341), 0x64806480u);
      v[0] = a.x;
      v[2] = a.y;
      v[1] = b.x;
      v[3] = b.y;
    }
  } else {
    constexpr bool HI = has_hi(S);
    if constexpr (STRAT == kShift) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        int q = SIGNED ? static_cast<int>(w << (28 - 4 * j)) >> 28 : static_cast<int>((w >> (4 * j)) & 15u);
        if constexpr (HI) q += static_cast<int>(((j < 4 ? h0 : h1) >> (8 * (j % 4))) & 1u) << 4;
        v[j] = static_cast<float>(q);
      }
    } else {
      const uint32_t ws = SIGNED ? w ^ 0x88888888u : w;
      const uint32_t bias = SIGNED ? 0x64086408u : 0x64006400u;  // 1032 or 1024
      uint32_t p01 = 0, p23 = 0;
      if constexpr (HI) {
        p01 = __byte_perm(h0, h1, 0x5410);  // bits of codes 0, 1, 4, 5 at bits 0, 8, 16, 24
        p23 = __byte_perm(h0, h1, 0x7632);  // codes 2, 3, 6, 7
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t t = ((ws >> (4 * i)) & 0x000f000fu) | 0x64006400u;  // codes i and i + 4
        if constexpr (HI) {
          const uint32_t p = i < 2 ? p01 : p23;
          t |= (i % 2 == 0 ? p << 4 : p >> 4) & 0x00100010u;
        }
        const float2 f = magic_f32(t, bias);
        v[i] = f.x;
        v[i + 4] = f.y;
      }
    }
  }
}

// 4 or 16 bytes at p as 32-bit words
template <int W>
__device__ __forceinline__ void load_words(const uint8_t* p, uint32_t (&out)[W / 4]) {
  if constexpr (W == 16) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  } else {
    out[0] = __ldg(reinterpret_cast<const uint32_t*>(p));
  }
}

int launch_km(const void* x, const void* codes, const void* scales, void* y, int M, int N, int K,
              int storage, bool is_signed, int strategy, int width, cudaStream_t stream);

}  // namespace probe
}  // namespace mgt
