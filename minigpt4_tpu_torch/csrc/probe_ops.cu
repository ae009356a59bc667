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
// one lop3 for 4 bytes, add the SWAR add4 below (the c8 increment
// __vadd4), and the multiply by 3, which has no byte-SIMD instruction, is
// v + ((v << 1) & 0xfefefefe) by add4; bf16 on 2 per word (__hadd2,
// __hmul2); i32 on one element per word.  The
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
// rates (the H100's 64 integer lanes per SM, half its f32 lanes), which is
// what the tool's REPS sweep separates.
//
// Design: the streaming loop carries no row or column arithmetic.  The
// tensor's 16-byte vectors are cut into chunks of 1024 (4 per thread of a
// 256-thread block; a tile holds a whole number of them, as cols % 128 ==
// 0), and a persistent grid (the blocks that fit on every SM, trimmed so
// that each takes the same number of chunks, give or take one) walks them
// interleaved: block b takes chunks b, b + grid, ..., so the grid sweeps the
// tensor front to back.  A thread issues its four loads of the next chunk,
// at 32-bit offsets from the chunk, before it runs the chains of the
// present one, so loads stay in flight while the chains run; it adds its
// results' words to a 32-bit sum, and each warp adds its sum into the
// block's word for the chunk's tile in shared memory; at the end the block
// adds each of those words into cks[t] (integer atomicAdds, so the order
// does not change the result, and one global atomic per block and tile).
// The [8, 128] out block of tile t is a stage of its own after the stream:
// the first warp of block t (t + grid, ...) reads the block's vectors again
// and writes their chains' elements.  The packed-byte adds are the SWAR
// form a + b = ((a & 0x7f..) + (b & 0x7f..)) ^ ((a ^ b) & 0x80..); where
// the constants' byte MSBs are clear (the probe's i8aa, i8add), the launch
// picks the form with fewer operations that gives the same bytes: (v & c1)
// + c2 has no carry out of a byte when neither c1 nor c2 has a top bit,
// and v + c2 then needs only v's own top bits back.  Those adds, and
// i32aa's, are issued as integer multiply-adds with a unit multiplier that
// comes in as an argument (IMAD, on the FMA pipe), so a rep's and and add
// use both of the SM's integer pipes instead of queueing on the ALU pipe.
#include <algorithm>

#include "common.cuh"

namespace {

enum Op : int { kI8AA = 0, kU8And, kI8Mul, kI8Add, kI32AA, kBF16Add, kBF16Mul, kC8, kC32 };

constexpr int kThreads = 256;
constexpr int kTileRows = 256;
constexpr int kInFlight = 4;  // 16-byte loads per thread
constexpr int kChunk = kInFlight * kThreads;  // vectors per chunk
constexpr int kMaxTileSums = 12288;  // tiles of one launch: 48 KB of shared memory
constexpr uint32_t kLo7 = 0x7f7f7f7fu, kHi1 = 0x80808080u;

__device__ __forceinline__ void opaque(uint32_t& v) { asm volatile("" : "+r"(v)); }

// a 16-byte load through the read-only path, as volatile asm: it stays
// ahead of the chains' empty asm barriers, so the next chunk's loads are in
// flight while this one's chains run (the compiler may not sink them)
__device__ __forceinline__ uint4 load_ahead(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ uint32_t bf2_bits(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}
__device__ __forceinline__ __nv_bfloat162 bits_bf2(uint32_t u) {
  return *reinterpret_cast<__nv_bfloat162*>(&u);
}
// bytewise a + b, each byte wrapping
__device__ __forceinline__ uint32_t add4(uint32_t a, uint32_t b) {
  return ((a & kLo7) + (b & kLo7)) ^ ((a ^ b) & kHi1);
}

// one step of a single-word chain (ops 0-6) on v
template <int OP, bool FAST>
__device__ __forceinline__ uint32_t step(uint32_t v, uint32_t c1, uint32_t c2, uint32_t one) {
  if constexpr (OP == kI8AA) return FAST ? (v & c1) * one + c2 : add4(v & c1, c2);
  if constexpr (OP == kU8And) return v & c1;
  if constexpr (OP == kI8Mul) return add4(v, (v << 1) & 0xfefefefeu);
  if constexpr (OP == kI8Add) return FAST ? ((v & kLo7) * one + c2) ^ (v & kHi1) : add4(v, c2);
  if constexpr (OP == kI32AA) return (v & c1) * one + c2;
  if constexpr (OP == kBF16Add) return bf2_bits(__hadd2(bits_bf2(v), bits_bf2(c1)));
  return bf2_bits(__hmul2(bits_bf2(v), bits_bf2(c1)));  // kBF16Mul
}

// the chain on one 32-bit word of input; results into r[0..kOut).  FAST:
// the constants' byte MSBs are clear (i8aa: c1 and c2; i8add: c2)
template <int OP, bool FAST>
struct Chain {
  static constexpr int kOut = OP == kC8 ? 2 : 1;  // result words per input word (c32: half)
  __device__ __forceinline__ static void run(uint32_t v, int reps, uint32_t c1, uint32_t c2,
                                             uint32_t one, uint32_t* r) {
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
        v = step<OP, FAST>(v, c1, c2, one);
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

// the checksum words of the chains of a thread's kInFlight vectors; the
// single-word chains (ops 0-6) of all 4 kInFlight words run step by step
// together, each step of each word behind its own empty asm, so the steps
// of one word stay in order and unfolded while the words' chains interleave
template <int OP, bool FAST>
__device__ __forceinline__ uint32_t chunk_sum(const uint4 (&x)[kInFlight], int reps, uint32_t c1,
                                              uint32_t c2, uint32_t one) {
  uint32_t w[4 * kInFlight];
#pragma unroll
  for (int u = 0; u < kInFlight; ++u) {
    w[4 * u] = x[u].x;
    w[4 * u + 1] = x[u].y;
    w[4 * u + 2] = x[u].z;
    w[4 * u + 3] = x[u].w;
  }
  uint32_t sum = 0;
  if constexpr (OP == kC8 || OP == kC32) {
    uint32_t pair = 0;
#pragma unroll
    for (int q = 0; q < 4 * kInFlight; ++q) {
      uint32_t r[Chain<OP, FAST>::kOut];
      Chain<OP, FAST>::run(w[q], reps, c1, c2, one, r);
      if constexpr (OP == kC32) {  // two bf16 results make one 32-bit word of the result tensor
        if (q % 2 == 0) pair = r[0];
        else sum += pair | (r[0] << 16);
      } else {
        sum += r[0] + r[1];
      }
    }
  } else {
    for (int i = 0; i < reps; ++i) {
#pragma unroll
      for (int q = 0; q < 4 * kInFlight; ++q) w[q] = step<OP, FAST>(w[q], c1, c2, one);
#pragma unroll
      for (int q = 0; q < 4 * kInFlight; ++q) opaque(w[q]);
    }
#pragma unroll
    for (int q = 0; q < 4 * kInFlight; ++q) sum += w[q];
  }
  return sum;
}

template <int OP, bool FAST>
__global__ void __launch_bounds__(kThreads)
op_chain_kernel(const uint4* __restrict__ in, float* __restrict__ out, unsigned* __restrict__ cks,
                int tiles, int tile_vecs, int row_vecs, int esize, int reps, uint32_t c1,
                uint32_t c2, uint32_t one) {
  constexpr int kEPW = (OP == kI32AA || OP == kC32) ? 1 : (OP == kBF16Add || OP == kBF16Mul) ? 2 : 4;
  extern __shared__ unsigned tile_sum[];  // [tiles]
  for (int t = threadIdx.x; t < tiles; t += kThreads) tile_sum[t] = 0;
  __syncthreads();
  const int cpt = tile_vecs / kChunk;  // chunks per tile
  const int chunks = tiles * cpt;
  // the out blocks: rows 0-7, columns 0-127 of tile t (t = blockIdx.x, +
  // gridDim.x, ...), by the block's first warp after its stream
  auto emit = [&]() {
    const int vpr = 8 * esize;  // 16-byte vectors of 128 elements
    const int out_w = 128 * tiles;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      for (int i = threadIdx.x; i < 8 * vpr; i += 32) {
        const int row = i / vpr, col0 = i % vpr * 16 / esize;
        const uint4 x = __ldg(in + static_cast<size_t>(t) * tile_vecs +
                              static_cast<size_t>(row) * row_vecs + i % vpr);
        const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          uint32_t r[Chain<OP, FAST>::kOut];
          Chain<OP, FAST>::run(w[q], reps, c1, c2, one, r);
#pragma unroll
          for (int j = 0; j < kEPW; ++j)
            out[static_cast<size_t>(row) * out_w + 128 * t + col0 + q * kEPW + j] =
                element<OP>(r, j);
        }
      }
    }
  };
  // the stream: chunks blockIdx.x, + gridDim.x, ...; the next chunk's loads
  // are in flight while this one's chains run
  auto load = [&](int ch, uint4 (&x)[kInFlight]) {
    const uint4* p = in + static_cast<size_t>(ch) * kChunk + threadIdx.x;
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) x[u] = load_ahead(p + u * kThreads);
  };
  uint4 next[kInFlight];
  int ch = blockIdx.x;
  if (ch < chunks) load(ch, next);
  while (ch < chunks) {
    uint4 x[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) x[u] = next[u];
    const int after = ch + gridDim.x;
    if (after < chunks) load(after, next);
    uint32_t sum = chunk_sum<OP, FAST>(x, reps, c1, c2, one);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(mgt::kFullMask, sum, o);
    if (threadIdx.x % 32 == 0) atomicAdd(tile_sum + ch / cpt, sum);
    ch = after;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < tiles; t += kThreads)
    if (tile_sum[t]) atomicAdd(cks + t, tile_sum[t]);
  if (threadIdx.x < 32) emit();
}

template <int OP, bool FAST = false>
int launch(const void* in, void* out, void* cks, int rows, int cols, int esize, int reps,
           uint32_t c1, uint32_t c2, cudaStream_t s) {
  auto* kern = op_chain_kernel<OP, FAST>;
  const int tiles = rows / kTileRows;
  const int row_vecs = cols * esize / 16;
  const int tile_vecs = row_vecs * kTileRows;
  const int chunks = tiles * (tile_vecs / kChunk);
  const int smem = 4 * tiles;  // the block's checksum word per tile
  if (smem > kMaxTileSums * 4) return static_cast<int>(cudaErrorInvalidValue);
  // every SM's worth of resident blocks, trimmed to an even share of chunks
  const int most = std::max(1, mgt::blocks_per_sm(kern, kThreads, smem)) * mgt::device_sms();
  const int rounds = (chunks + most - 1) / most;
  const int grid = (chunks + rounds - 1) / rounds;
  kern<<<grid, kThreads, smem, s>>>(static_cast<const uint4*>(in), static_cast<float*>(out),
                                 static_cast<unsigned*>(cks), tiles, tile_vecs, row_vecs, esize,
                                 reps, c1, c2, 1u);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// in: [rows, cols] of the op's input type (i8 / u8 for ops 0-3 and 7, i32
// for 4 and 8, bf16 for 5 and 6), 16-byte aligned; out f32 [8, 128 * rows /
// 256]; cks u32 [rows / 256], zeroed by the caller.  rows % 256 == 0,
// rows <= 256 * 12288, cols % 128 == 0, reps >= 1.
MGT_API int mgt_probe_op_chain(const void* in, void* out, void* cks, int op, int rows, int cols,
                               int reps, int c1, int c2, void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (rows <= 0 || rows % kTileRows || cols <= 0 || cols % 128 || reps < 1) return invalid;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t a = static_cast<uint32_t>(c1), b = static_cast<uint32_t>(c2);
  const bool msb_a = (a & kHi1) != 0, msb_b = (b & kHi1) != 0;
  switch (op) {
    case kI8AA:
      return msb_a || msb_b ? launch<kI8AA>(in, out, cks, rows, cols, 1, reps, a, b, s)
                            : launch<kI8AA, true>(in, out, cks, rows, cols, 1, reps, a, b, s);
    case kU8And: return launch<kU8And>(in, out, cks, rows, cols, 1, reps, a, b, s);
    case kI8Mul: return launch<kI8Mul>(in, out, cks, rows, cols, 1, reps, a, b, s);
    case kI8Add:
      return msb_b ? launch<kI8Add>(in, out, cks, rows, cols, 1, reps, a, b, s)
                   : launch<kI8Add, true>(in, out, cks, rows, cols, 1, reps, a, b, s);
    case kI32AA: return launch<kI32AA>(in, out, cks, rows, cols, 4, reps, a, b, s);
    case kBF16Add: return launch<kBF16Add>(in, out, cks, rows, cols, 2, reps, a, b, s);
    case kBF16Mul: return launch<kBF16Mul>(in, out, cks, rows, cols, 2, reps, a, b, s);
    case kC8: return launch<kC8>(in, out, cks, rows, cols, 1, reps, a, b, s);
    case kC32: return launch<kC32>(in, out, cks, rows, cols, 4, reps, a, b, s);
    default: return invalid;
  }
}
