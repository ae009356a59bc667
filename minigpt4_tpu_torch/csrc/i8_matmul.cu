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
// operations at 1979 TOP/s); at the 32-row Q-Former chunk the code stream.
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
// mgt_i8_prefill. Warpgroup MMA over a TMA ring. A block of three warpgroups
// computes a 128 x 128 output tile. One producer thread (the third
// warpgroup, its registers given up with setmaxnreg) loads 128-byte K slices
// of the x tile [128 rows] and of the code tile [128 columns] with TMA
// (cp.async.bulk.tensor, 128-byte swizzle, out-of-bounds rows zero-filled,
// so ragged M and N need no masking on the way in) into a ring of 4 stages
// of 32 KB, each guarded by a full and an empty mbarrier. Two consumer
// warpgroups each own 64 rows of the tile: per 256-wide chunk (two stages) a
// consumer issues eight wgmma.mma_async.m64n128k32.s32.s8.s8 from the staged
// tiles (both operands K-major, as integer wgmma requires and as x [M, K]
// and codes [N, K] are stored), waits for them, releases the two stages, and
// folds the chunk's exact i32 fragment into its f32 accumulator in
// registers: the PTX ISA's m64nNk32 accumulator layout gives each thread
// rows 16 w + g and g + 8, columns 8 j + 2 t and 8 j + 2 t + 1, so each
// value meets its column's chunk scale (staged once per tile in shared
// memory) there. The i32 -> f32 conversion is exact and runs at the FMA
// rate: |chunk| <= 256 * 128 * 128 = 2^22, so the float of bits (v +
// 0x4B400000) minus 1.5 * 2^23 is v. The next chunk's wgmma starts with its
// accumulate flag off, which clears the fragment. While one consumer scales,
// the other's wgmmas keep the tensor cores busy and the producer keeps the
// ring full. A consumer whose 64 rows all lie past M issues no wgmma (the
// 32-row Q-Former chunk). Tiles are ordered row tile
// fastest, so the blocks that share a code tile run together and read it
// from device memory once. The TMA descriptors are encoded on the host per
// launch by libcuda's cuTensorMapEncodeTiled, found at run time through
// cudaGetDriverEntryPoint (no link against libcuda). Later work: a persistent grid (the 13B w13 at M
// = 512 is 6.5 waves of 132 tiles), a TMA store of the output, smaller tiles
// where a grid leaves SMs idle (ViT-G fc2: 33 tiles), and a chunk's wgmmas
// overlapping the previous chunk's scaling in the same warpgroup: two s32
// fragments used in turn need 192 registers with the f32 accumulator, but
// ptxas holds a 384-thread block to 168, spills and serializes the wgmmas
// (measured slower), so that needs a narrower tile or a persistent layout.

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
// prefill: M > 8, warpgroup MMA over a TMA ring
// ---------------------------------------------------------------------------

constexpr int kBM = 128;                       // tile rows (two consumers of 64)
constexpr int kBN = 128;                       // tile columns
constexpr int kBK = 128;                       // K bytes per stage: one 128-byte swizzle row
constexpr int kStages = 4;
constexpr int kStageBytes = (kBM + kBN) * kBK;  // 32 KB
constexpr int kConsumers = 2;
constexpr int kPreThreads = (kConsumers + 1) * 128;
static_assert(kSB == 2 * kBK, "a chunk is two stages");

using mgt::fence_fragment;
using mgt::kMaxSmem;
using mgt::mbar_arrive;
using mgt::mbar_expect_tx;
using mgt::mbar_init;
using mgt::mbar_wait;
using mgt::smem_desc;
using mgt::smem_u32;
using mgt::tma_load;

// a [rows, K] i8 matrix (K contiguous) in boxes of 128 rows x 128 bytes
int make_map(CUtensorMap* map, const void* base, int rows, int K) {
  return mgt::make_tma_2d(map, base, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, rows, K, kBK, 128);
}

// D[64 x 128] (+)= A[64 x 32] B[32 x 128], s8 x s8 -> s32; accumulate = 0 clears D
__device__ __forceinline__ void wgmma_s8(uint32_t (&d)[64], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// an exact i32 with |v| <= 2^22 as f32, on the FMA pipe
__device__ __forceinline__ float small_i2f(uint32_t v) {
  return __uint_as_float(v + 0x4B400000u) - 12582912.0f;
}

__global__ void __launch_bounds__(kPreThreads, 1)
i8_prefill_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
                  const float* __restrict__ scales, float* __restrict__ y, int M, int N, int K) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int G = K / kSB, n_steps = K / kBK;
  unsigned char* a_s = smem;                             // [kStages][kBM][kBK]
  unsigned char* b_s = smem + kStages * kBM * kBK;       // [kStages][kBN][kBK]
  float* sc_s = reinterpret_cast<float*>(smem + kStages * kStageBytes);  // [G][kBN]
  uint64_t* full = reinterpret_cast<uint64_t*>(sc_s + G * kBN);
  uint64_t* empty = full + kStages;

  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int tid = threadIdx.x, wg = tid / 128;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == kConsumers * 128) {
      for (int it = 0; it < n_steps; ++it) {
        const int s = it % kStages;
        mbar_wait(empty + s, ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(full + s, kStageBytes);
        tma_load(a_s + s * kBM * kBK, &xmap, it * kBK, m0, full + s);
        tma_load(b_s + s * kBN * kBK, &wmap, it * kBK, n0, full + s);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    // the tile's chunk scales, [G][kBN], 0 past N
    for (int i = tid; i < G * kBN; i += kConsumers * 128) {
      const int g = i / kBN, c = i % kBN;
      sc_s[i] = n0 + c < N ? scales[static_cast<size_t>(n0 + c) * G + g] : 0.f;
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers * 128) : "memory");

    const bool rows_live = m0 + 64 * wg < M;
    const int warp = (tid % 128) / 32, lane = tid % 32, grp = lane / 4, t4 = lane % 4;
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    if (!rows_live) {
      // no row of this warpgroup lies below M: release the stages unread
      for (int it = 0; it < n_steps; ++it) {
        mbar_wait(full + it % kStages, (it / kStages) & 1);
        mbar_arrive(empty + it % kStages);
      }
      return;
    }
    uint32_t d[64];  // the chunk's s32 fragment
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0u;
    for (int g = 0; g < G; ++g) {
      const int s0 = (2 * g) % kStages, s1 = (2 * g + 1) % kStages;
      mbar_wait(full + s0, ((2 * g) / kStages) & 1);
      mbar_wait(full + s1, ((2 * g + 1) / kStages) & 1);
      mgt::wgmma_fence();
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int s = half ? s1 : s0;
        const uint64_t da = smem_desc(a_s + s * kBM * kBK + wg * 64 * kBK);
        const uint64_t db = smem_desc(b_s + s * kBN * kBK);
#pragma unroll
        for (int kk = 0; kk < kBK / 32; ++kk)  // +32 bytes along K: +2 in the address field
          wgmma_s8(d, da + 2 * kk, db + 2 * kk, half | kk);
      }
      mgt::wgmma_commit();
      mgt::wgmma_wait_all();
      fence_fragment(d);
      mbar_arrive(empty + s0);
      mbar_arrive(empty + s1);
      // the chunk's exact i32 values times their column's scale, in chunk order
      const float* sg = sc_s + g * kBN;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float2 s2 = *reinterpret_cast<const float2*>(sg + 8 * j + 2 * t4);
        acc[4 * j] = fmaf(small_i2f(d[4 * j]), s2.x, acc[4 * j]);
        acc[4 * j + 1] = fmaf(small_i2f(d[4 * j + 1]), s2.y, acc[4 * j + 1]);
        acc[4 * j + 2] = fmaf(small_i2f(d[4 * j + 2]), s2.x, acc[4 * j + 2]);
        acc[4 * j + 3] = fmaf(small_i2f(d[4 * j + 3]), s2.y, acc[4 * j + 3]);
      }
    }
    {
      const int r0 = m0 + 64 * wg + 16 * warp + grp;
      const bool pairs = (N & 1) == 0;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int n = n0 + 8 * j + 2 * t4;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int m = r0 + 8 * hr;
          if (m >= M || n >= N) continue;
          float* dst = y + static_cast<size_t>(m) * N + n;
          if (pairs) {
            *reinterpret_cast<float2*>(dst) = make_float2(acc[4 * j + 2 * hr], acc[4 * j + 2 * hr + 1]);
          } else {
            dst[0] = acc[4 * j + 2 * hr];
            if (n + 1 < N) dst[1] = acc[4 * j + 2 * hr + 1];
          }
        }
      }
    }
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
// cores (wgmma).  Requires K % 256 == 0, K <= 49920 (the tile's chunk
// scales in shared memory) and 16-byte aligned x and codes.
MGT_API int mgt_i8_prefill(const void* x, const void* codes, const void* scales, void* y, int M,
                           int N, int K, int layer, void* stream) {
  if (const int rc = check_args(M, N, K, layer)) return rc;
  const int G = K / kSB;
  const int smem = 1024 + kStages * kStageBytes + G * kBN * 4 + 2 * kStages * 8;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap xmap, wmap;
  const int8_t* w = static_cast<const int8_t*>(codes) + static_cast<size_t>(layer) * N * K;
  if (const int rc = make_map(&xmap, x, M, K)) return rc;
  if (const int rc = make_map(&wmap, w, N, K)) return rc;
  // once, for the largest ring and scale tile any K may need
  static const cudaError_t attr = cudaFuncSetAttribute(
      i8_prefill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  i8_prefill_kernel<<<grid, kPreThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      xmap, wmap, static_cast<const float*>(scales) + static_cast<size_t>(layer) * N * G,
      static_cast<float*>(y), M, N, K);
  return static_cast<int>(cudaGetLastError());
}
