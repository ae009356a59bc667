// probe_ops: chains of elementwise integer and bf16 operations, the cost of
// sub-word arithmetic.
//
// Replaces tools/probe_i8ops.py:50 (probe: a chain of REPS ops over
// [TN, K] tiles of an [N, K] tensor, each 256-row tile writing an [8, 128]
// block) and the op-packing kernels of tools/qmm_v3.py:416 (main3's opsi8,
// opsi32).  Per element, REPS times:
//
//   0 i8aa   v = (v & c1) + c2   i8, wrapping      5 bf16add v = v + c1  bf16
//   1 u8and  v = v & c1          u8                6 bf16mul v = v * c1  bf16
//   2 i8mul  v = v * 3           i8, wrapping      7 c8   acc = sum_i bf16(v + i)  i8 -> bf16
//   3 i8add  v = v + c2          i8, wrapping      8 c32  acc = sum_i bf16(v + i)  i32 -> bf16
//   4 i32aa  v = (v & c1) + c2   i32
//
// (c8 and c32: i = 0..REPS-1, the integer add wrapping, the bf16 sum in
// order.)  The i8 / u8 forms work on 4 packed bytes per 32-bit word: and is
// one lop3 for 4 bytes, add __vadd4, and the multiply by 3, which has no
// byte-SIMD instruction, is v + ((v << 1) & 0xfefefefe) by __vadd4; bf16 on
// 2 per word (__hadd2, __hmul2); i32 on one element per word.  The
// constants come in as arguments and each step's result passes an empty asm,
// so the compiler folds no chain into fewer operations.
//
// Output: out f32 [8, 128 * T] for T = rows / 256 tiles, out[r, 128 t + c]
// the result at (256 t + r, c) for r < 8, c < 128, as the TPU probe writes;
// and, so that no result is dead code, cks u32 [T]: the sum, mod 2^32, of
// every result of tile t read as 32-bit words (the result tensor's bytes in
// order, 4 i8 or 2 bf16 per word).  The plain version computes both.
//
// What bounds it on the H100: device-memory bandwidth on the input at
// REPS = 8 (one pass over 70.8 MB of i8 or 283 MB of i32 at the probe's
// [5120, 13824]); with more REPS the integer and half-precision issue
// rates, which is what the tool's REPS sweep separates.
//
// Design: a block per (tile, slice of the tile's bytes), 256 threads, 16
// bytes per thread and step, grid-stride over the slice; the checksum is
// added over a warp by shuffles and into cks[t] by one atomicAdd per warp
// (integer, so the order does not change the result).
#include <algorithm>

#include "common.cuh"

namespace {

enum Op : int { kI8AA = 0, kU8And, kI8Mul, kI8Add, kI32AA, kBF16Add, kBF16Mul, kC8, kC32 };

constexpr int kThreads = 256;
constexpr int kTileRows = 256;

__device__ __forceinline__ void opaque(uint32_t& v) { asm volatile("" : "+r"(v)); }

__device__ __forceinline__ uint32_t bf2_bits(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}
__device__ __forceinline__ __nv_bfloat162 bits_bf2(uint32_t u) {
  return *reinterpret_cast<__nv_bfloat162*>(&u);
}

// the chain on one 32-bit word of input; results into r[0..kOut)
template <int OP>
struct Chain {
  static constexpr int kOut = OP == kC8 ? 2 : 1;  // result words per input word (c32: half)
  __device__ __forceinline__ static void run(uint32_t v, int reps, uint32_t c1, uint32_t c2,
                                             uint32_t* r) {
    if constexpr (OP == kC8) {
      __nv_bfloat162 lo = __floats2bfloat162_rn(0.f, 0.f), hi = lo;
      for (int i = 0; i < reps; ++i) {
        uint32_t u = __vadd4(v, 0x01010101u * static_cast<uint32_t>(i));
        opaque(u);
        const __nv_bfloat162 a = __floats2bfloat162_rn(
            static_cast<float>(static_cast<int8_t>(u)), static_cast<float>(static_cast<int8_t>(u >> 8)));
        const __nv_bfloat162 b = __floats2bfloat162_rn(
            static_cast<float>(static_cast<int8_t>(u >> 16)),
            static_cast<float>(static_cast<int8_t>(u >> 24)));
        lo = i == 0 ? a : __hadd2(lo, a);
        hi = i == 0 ? b : __hadd2(hi, b);
      }
      r[0] = bf2_bits(lo);
      r[1] = bf2_bits(hi);
    } else if constexpr (OP == kC32) {
      __nv_bfloat16 acc = __float2bfloat16(0.f);
      for (int i = 0; i < reps; ++i) {
        uint32_t u = v + static_cast<uint32_t>(i);
        opaque(u);
        const __nv_bfloat16 a = __int2bfloat16_rn(static_cast<int>(u));
        acc = i == 0 ? a : __hadd(acc, a);
      }
      r[0] = *reinterpret_cast<uint16_t*>(&acc);
    } else {
      for (int i = 0; i < reps; ++i) {
        if constexpr (OP == kI8AA) v = __vadd4(v & c1, c2);
        if constexpr (OP == kU8And) v = v & c1;
        if constexpr (OP == kI8Mul) v = __vadd4(v, (v << 1) & 0xfefefefeu);
        if constexpr (OP == kI8Add) v = __vadd4(v, c2);
        if constexpr (OP == kI32AA) v = (v & c1) + c2;
        if constexpr (OP == kBF16Add) v = bf2_bits(__hadd2(bits_bf2(v), bits_bf2(c1)));
        if constexpr (OP == kBF16Mul) v = bf2_bits(__hmul2(bits_bf2(v), bits_bf2(c1)));
        opaque(v);
      }
      r[0] = v;
    }
  }
};

// the result element j of a word's results, as float
template <int OP>
__device__ __forceinline__ float element(const uint32_t* r, int j) {
  if constexpr (OP == kI8AA || OP == kI8Mul || OP == kI8Add)
    return static_cast<float>(static_cast<int8_t>(r[0] >> (8 * j)));
  if constexpr (OP == kU8And) return static_cast<float>((r[0] >> (8 * j)) & 0xffu);
  if constexpr (OP == kI32AA) return static_cast<float>(static_cast<int>(r[0]));
  if constexpr (OP == kBF16Add || OP == kBF16Mul)
    return __uint_as_float((j == 0 ? r[0] << 16 : r[0] & 0xffff0000u));
  if constexpr (OP == kC8) return __uint_as_float(j % 2 == 0 ? r[j / 2] << 16 : r[j / 2] & 0xffff0000u);
  return __uint_as_float(r[0] << 16);  // c32
}

template <int OP>
__global__ void __launch_bounds__(kThreads)
op_chain_kernel(const uint4* __restrict__ in, float* __restrict__ out, unsigned* __restrict__ cks,
                int cols, int esize, int reps, uint32_t c1, uint32_t c2) {
  constexpr int kEPW = (OP == kI32AA || OP == kC32) ? 1 : (OP == kBF16Add || OP == kBF16Mul) ? 2 : 4;
  const int t = blockIdx.x;
  const size_t row_vecs = static_cast<size_t>(cols) * esize / 16;  // 16-byte vectors per row
  const size_t tile_vecs = row_vecs * kTileRows;
  const uint4* base = in + static_cast<size_t>(t) * tile_vecs;
  const int out_w = 128 * gridDim.x;
  uint32_t sum = 0;
  for (size_t i = static_cast<size_t>(blockIdx.y) * kThreads + threadIdx.x; i < tile_vecs;
       i += static_cast<size_t>(gridDim.y) * kThreads) {
    const uint4 v = __ldg(base + i);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    const int row = static_cast<int>(i / row_vecs);
    const int col0 = static_cast<int>(i % row_vecs) * 16 / esize;
    const bool emit = row < 8 && col0 < 128;
    uint32_t c32_pair = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t r[Chain<OP>::kOut];
      Chain<OP>::run(w[q], reps, c1, c2, r);
      if constexpr (OP == kC32) {
        // two bf16 results make one 32-bit word of the result tensor
        if (q % 2 == 0) c32_pair = r[0];
        else sum += c32_pair | (r[0] << 16);
      } else {
#pragma unroll
        for (int j = 0; j < Chain<OP>::kOut; ++j) sum += r[j];
      }
      if (emit) {
#pragma unroll
        for (int j = 0; j < kEPW; ++j)
          out[static_cast<size_t>(row) * out_w + 128 * t + col0 + q * kEPW + j] = element<OP>(r, j);
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(mgt::kFullMask, sum, o);
  if (threadIdx.x % 32 == 0) atomicAdd(cks + t, sum);
}

template <int OP>
int launch(const void* in, void* out, void* cks, int rows, int cols, int esize, int reps,
           uint32_t c1, uint32_t c2, cudaStream_t s) {
  const int tiles = rows / kTileRows;
  const size_t tile_vecs = static_cast<size_t>(cols) * esize / 16 * kTileRows;
  // about four blocks per SM over the whole tensor, each at least one step
  const size_t want = (4 * 132 + tiles - 1) / tiles;
  const int slices = static_cast<int>(std::max<size_t>(1, std::min(want, tile_vecs / kThreads)));
  op_chain_kernel<OP><<<dim3(tiles, slices), kThreads, 0, s>>>(
      static_cast<const uint4*>(in), static_cast<float*>(out), static_cast<unsigned*>(cks), cols,
      esize, reps, c1, c2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// in: [rows, cols] of the op's input type (i8 / u8 for ops 0-3 and 7, i32
// for 4 and 8, bf16 for 5 and 6), 16-byte aligned; out f32 [8, 128 * rows /
// 256]; cks u32 [rows / 256], zeroed by the caller.  rows % 256 == 0,
// cols % 128 == 0, reps >= 1.
MGT_API int mgt_probe_op_chain(const void* in, void* out, void* cks, int op, int rows, int cols,
                               int reps, int c1, int c2, void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (rows <= 0 || rows % kTileRows || cols <= 0 || cols % 128 || reps < 1) return invalid;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t a = static_cast<uint32_t>(c1), b = static_cast<uint32_t>(c2);
  switch (op) {
    case kI8AA: return launch<kI8AA>(in, out, cks, rows, cols, 1, reps, a, b, s);
    case kU8And: return launch<kU8And>(in, out, cks, rows, cols, 1, reps, a, b, s);
    case kI8Mul: return launch<kI8Mul>(in, out, cks, rows, cols, 1, reps, a, b, s);
    case kI8Add: return launch<kI8Add>(in, out, cks, rows, cols, 1, reps, a, b, s);
    case kI32AA: return launch<kI32AA>(in, out, cks, rows, cols, 4, reps, a, b, s);
    case kBF16Add: return launch<kBF16Add>(in, out, cks, rows, cols, 2, reps, a, b, s);
    case kBF16Mul: return launch<kBF16Mul>(in, out, cks, rows, cols, 2, reps, a, b, s);
    case kC8: return launch<kC8>(in, out, cks, rows, cols, 1, reps, a, b, s);
    case kC32: return launch<kC32>(in, out, cks, rows, cols, 4, reps, a, b, s);
    default: return invalid;
  }
}
