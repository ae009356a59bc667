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
// sum runs in a fixed order.  The activations x are i8 codes of f32 rows,
// x_i8 = clamp(rint(x / s), +-127) with s = absmax / 127 per row (or the
// caller's scale), and y is multiplied by s: mgt_i8_decode does all of that
// in its one launch from f32 x; for mgt_i8_prefill the wrapper quantizes x
// and scales y (ops/i8_matmul.py), as in the JAX package.  Both entries
// require K % 256 == 0 and refuse other K with cudaErrorInvalidValue.
//
// What bounds it on the H100.  mgt_i8_decode (M <= 8): the code stream from
// device memory, 1 B per weight plus 4 B of scale per 256 weights; at M = 8
// the integer dot products (2 M N K operations, __dp4a at a quarter of the
// f32 rate) come within a factor of two of it.  The kernel it replaces ran
// at 53-86 % of the byte bound at M = 1 but at 22-50 % at M = 8 (13B
// shapes, NVIDIA H100 80GB HBM3, 700 W), and its caller spent about ten
// torch launches quantizing x around it.
// mgt_i8_prefill (M > 8): at the 512-row bucket and the 257-row ViT chunk
// the s8 tensor-core rate (2 M N K operations at 1979 TOP/s); at the 32-row
// Q-Former chunk the code stream.
//
// mgt_i8_decode.  One launch from f32 x to the scaled f32 y.
// * Persistent blocks (at most what fits on the card at once) take each
//   row's absmax over K (skipped where the caller gives the scales), then
//   quantize x into shared memory, M K bytes (at most 110 KB at M = 8, K =
//   13824): x * RN(1/s), and __fdiv_rn only near a half-integer
//   (common.cuh's split_level), so the codes are bit-equal to
//   quantize_activations.
// * A block is nw warps, one per K slice (chunks g = p, p + nw, ...); a warp
//   is 8 quads, a quad owns C rows (C = 2 from M = 3 on) and its lane l reads
//   bytes 64 j + 16 l (j < 4) of each 256-code chunk: 64 contiguous bytes of
//   a row per load, x read from shared memory at four addresses per warp.
//   Loads run D chunks ahead in a register ring over the block's whole
//   sequence of (strip, chunk) tasks.
// * The quad's four partial i32 per (row, x row) are added by shuffles once
//   per chunk: a butterfly where a lane holds at most 4 values, else a
//   reduce-scatter that leaves each lane a quarter of them, finished.  Each
//   finished total is exact, becomes a float without I2F (common.cuh's
//   small_int_to_float) and is multiplied by its chunk scale and added
//   (two roundings, as the plain version).
// * The nw slices' sums meet in shared memory in slice order; y = sum * s,
//   one f32 multiply.  nw depends on K alone, so a column's bits depend on
//   M and K, never on N, the grid or the block that computes it.
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

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kSB = 256;  // superblock: one scale, one exact i32 chunk

// ---------------------------------------------------------------------------
// decode: M <= 8
// ---------------------------------------------------------------------------

constexpr int kDecQuads = 8;      // quads per warp, each on its own rows
constexpr int kDecMaxWarps = 12;  // 384 threads: up to 168 registers a thread

using mgt::kMaxSmem;

// one 256-code chunk of one row as a lane reads it: bytes 64 j + 16 l of the
// chunk, and the chunk's scale
struct I8Unit {
  int4 w[4];
  float sc;
};

// absmax / 127 (0 -> 1) of each row of x, or x_scale[m]; rowq[m] = (s,
// RN(1/s), whether the product path holds), then x quantized into xs [M][K];
// all threads, ends with a barrier
template <int M>
__device__ void quantize_rows(const float* __restrict__ x, const float* __restrict__ x_scale,
                              int K, int8_t* xs, float* rowq, float* scratch) {
  const int nt = blockDim.x, tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (x_scale == nullptr) {
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
      const float v = mgt::warp_max(mx[m]);
      if (lane == 0) scratch[warp * M + m] = v;
    }
    __syncthreads();
  }
  if (tid < M) {
    float s;
    if (x_scale != nullptr) {
      s = x_scale[tid];
    } else {
      float ax = 0.f;
      for (int w = 0; w < nt / 32; ++w) ax = fmaxf(ax, scratch[w * M + tid]);
      s = ax == 0.f ? 1.f : __fdiv_rn(ax, 127.f);
    }
    rowq[3 * tid] = s;
    rowq[3 * tid + 1] = __frcp_rn(s);
    rowq[3 * tid + 2] = s >= 0x1p-125f && s <= 0x1p125f ? 1.f : 0.f;  // RN(1/s) normal
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const float s = rowq[3 * m], rcp = rowq[3 * m + 1];
    const bool fast = rowq[3 * m + 2] != 0.f;
    for (int c = tid; c < K / 16; c += nt) {
      const float4* xp = reinterpret_cast<const float4*>(x + static_cast<size_t>(m) * K) + 4 * c;
      int w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 v = __ldg(xp + j);
        float t[4];
        mgt::split_level(v.x, s, rcp, fast, t[0]);
        mgt::split_level(v.y, s, rcp, fast, t[1]);
        mgt::split_level(v.z, s, rcp, fast, t[2]);
        mgt::split_level(v.w, s, rcp, fast, t[3]);
        w[j] = mgt::pack_low_bytes(t[0], t[1], t[2], t[3]);
      }
      *reinterpret_cast<int4*>(xs + static_cast<size_t>(m) * K + 16 * c) =
          make_int4(w[0], w[1], w[2], w[3]);
    }
  }
  __syncthreads();
}

// The C rows' chunk g of a task on strip s.  Branch-free: a row past N
// reads row N - 1 and a chunk past K the last chunk; such a chunk is
// skipped and such a row never written.
template <int C>
__device__ __forceinline__ void i8_load(I8Unit (&r)[C], const int8_t* __restrict__ codes,
                                        const float* __restrict__ scales, int s, int g, int quad,
                                        int q, int N, int K, int G) {
  g = min(g, G - 1);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int n = min((s * kDecQuads + quad) * C + c, N - 1);
    const int4* p =
        reinterpret_cast<const int4*>(codes + static_cast<size_t>(n) * K + kSB * g + 16 * q);
#pragma unroll
    for (int j = 0; j < 4; ++j) r[c].w[j] = __ldg(p + 4 * j);
    r[c].sc = __ldg(scales + static_cast<size_t>(n) * G + g);
  }
}

// the next task: the warp's next chunk of the strip, or the next strip
__device__ __forceinline__ void i8_next(int& s, int& j, int nj) {
  if (++j == nj) {
    j = 0;
    s += gridDim.x;
  }
}

// f32 x [M, K] @ (codes * scales).T * s -> y f32 [M, N]; blockDim.x = 32 nw;
// dynamic shared memory as i8_decode_smem computes it
template <int M, int C, int D>
__global__ void __launch_bounds__(kDecMaxWarps * 32)
i8_decode_kernel(const float* __restrict__ x, const float* __restrict__ x_scale,
                 const int8_t* __restrict__ codes, const float* __restrict__ scales,
                 float* __restrict__ y, int N, int K, int layer) {
  constexpr int SW = kDecQuads * C;              // rows of a strip
  constexpr int V = C * M;                       // a lane's partial i32 per chunk
  constexpr bool kScatter = V > 4;               // reduce-scatter, else a butterfly
  constexpr int VP = kScatter ? (V + 3) / 4 * 4 : V;
  constexpr int VL = kScatter ? VP / 4 : V;      // finished totals a lane keeps
  extern __shared__ __align__(16) unsigned char i8_smem[];
  const int nw = blockDim.x / 32, G = K / kSB;
  int8_t* xs = reinterpret_cast<int8_t*>(i8_smem);           // [M][K]
  float* red = reinterpret_cast<float*>(i8_smem + M * K);    // [2][nw][SW][M]
  float* rowq = red + 2 * nw * SW * M;                       // [M][3]
  float* scratch = rowq + 3 * M;                             // [nw][M]
  codes += static_cast<size_t>(layer) * N * K;
  scales += static_cast<size_t>(layer) * N * G;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, quad = lane / 4, q = lane % 4;

  const int n_strips = (N + SW - 1) / SW;
  int my_strips = 0, nj = 0;  // nj: chunks per warp and strip, ceil(G / nw)
  for (int st = blockIdx.x; st < n_strips; st += gridDim.x) ++my_strips;
  for (int g = 0; g < G; g += nw) ++nj;
  const int T = my_strips * nj;
  // the first D tasks' loads go out before x is quantized
  I8Unit ring[D][C];
  int ls = blockIdx.x, lj = 0;  // the task the next load is for
#pragma unroll
  for (int d = 0; d < D; ++d) {  // unconditional: a task past T reads a clamped address
    i8_load(ring[d], codes, scales, ls, warp + lj * nw, quad, q, N, K, G);
    i8_next(ls, lj, nj);
  }
  quantize_rows<M>(x, x_scale, K, xs, rowq, scratch);

  // the first value this lane keeps after the reduce-scatter
  const int v0 = kScatter ? ((q & 2) ? VP / 2 : 0) + ((q & 1) ? VP / 4 : 0) : 0;
  float acc[VL];
#pragma unroll
  for (int i = 0; i < VL; ++i) acc[i] = 0.f;
  int buf = 0;
  int cs = blockIdx.x, cj = 0;  // the task being consumed
  for (int t0 = 0; t0 < T; t0 += D) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const int t = t0 + d;
      if (t < T) {
        const int g = warp + cj * nw;
        if (g < G) {  // warp-uniform
          const I8Unit(&r)[C] = ring[d];
          int v[VP];
#pragma unroll
          for (int i = 0; i < VP; ++i) v[i] = 0;
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int m = 0; m < M; ++m) {
              const int4 xv =
                  *reinterpret_cast<const int4*>(xs + m * K + kSB * g + 64 * j + 16 * q);
#pragma unroll
              for (int c = 0; c < C; ++c) {
                int& a = v[c * M + m];
                a = __dp4a(xv.x, r[c].w[j].x, a);
                a = __dp4a(xv.y, r[c].w[j].y, a);
                a = __dp4a(xv.z, r[c].w[j].z, a);
                a = __dp4a(xv.w, r[c].w[j].w, a);
              }
            }
          if constexpr (kScatter) {
            // lanes q and q ^ 2 keep halves, then q and q ^ 1 quarters
            int h[VP / 2], f[VP / 4];
#pragma unroll
            for (int i = 0; i < VP / 2; ++i) {
              const int keep = (q & 2) ? v[VP / 2 + i] : v[i];
              const int send = (q & 2) ? v[i] : v[VP / 2 + i];
              h[i] = keep + __shfl_xor_sync(mgt::kFullMask, send, 2);
            }
#pragma unroll
            for (int i = 0; i < VP / 4; ++i) {
              const int keep = (q & 1) ? h[VP / 4 + i] : h[i];
              const int send = (q & 1) ? h[i] : h[VP / 4 + i];
              f[i] = keep + __shfl_xor_sync(mgt::kFullMask, send, 1);
            }
#pragma unroll
            for (int i = 0; i < VL; ++i) {
              const float sc = (C == 1 || v0 + i < M) ? r[0].sc : r[C - 1].sc;
              acc[i] = __fadd_rn(acc[i], __fmul_rn(mgt::small_int_to_float(f[i]), sc));
            }
          } else {
#pragma unroll
            for (int i = 0; i < V; ++i) {
              int a = v[i];
              a += __shfl_xor_sync(mgt::kFullMask, a, 1);
              a += __shfl_xor_sync(mgt::kFullMask, a, 2);
              acc[i] = __fadd_rn(acc[i], __fmul_rn(mgt::small_int_to_float(a), r[i / M].sc));
            }
          }
        }
        i8_load(ring[d], codes, scales, ls, warp + lj * nw, quad, q, N, K, G);
        i8_next(ls, lj, nj);
        if (cj == nj - 1) {  // the strip's last chunk: sum the slices, scale, write y
          float* rb = red + buf * nw * SW * M;
#pragma unroll
          for (int i = 0; i < VL; ++i) {
            const int vi = v0 + i;
            if ((kScatter || q == 0) && vi < V)
              rb[(warp * SW + quad * C + vi / M) * M + vi % M] = acc[i];
            acc[i] = 0.f;
          }
          __syncthreads();
          for (int i = tid; i < SW * M; i += blockDim.x) {
            const int r = i / M, m = i - r * M, n = cs * SW + r;
            if (n < N) {
              float v = rb[r * M + m];
              for (int w = 1; w < nw; ++w) v = __fadd_rn(v, rb[(w * SW + r) * M + m]);
              y[static_cast<size_t>(m) * N + n] = __fmul_rn(v, rowq[3 * m]);
            }
          }
          buf ^= 1;  // the other half of red takes the next strip's slices
        }
        i8_next(cs, cj, nj);
      }
    }
  }
}

inline int i8_decode_smem(int M, int C, int K, int nw) {
  return M * K + 4 * (2 * nw * kDecQuads * C * M + 3 * M + nw * M);
}

// slices (warps) for G chunks: the largest divisor in [8, 12], else all of
// them up to 12; a function of K alone
inline int i8_decode_warps(int G) {
  for (int w = kDecMaxWarps; w >= 8; --w)
    if (G % w == 0) return w;
  return std::max(1, std::min(G, kDecMaxWarps));
}

// rows per lane C: 2 from M = 3 on, else 1; tasks in flight D: 4 where the
// rows are few; the bits depend on neither
template <int M>
int i8_decode_run(const void* x, const void* x_scale, const void* codes, const void* scales,
                  void* y, int N, int K, int layer, cudaStream_t stream) {
  constexpr int C = M >= 3 ? 2 : 1;
  constexpr int D = C * M <= 2 ? 4 : 2;
  auto* kern = i8_decode_kernel<M, C, D>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int nw = i8_decode_warps(K / kSB);
  const int smem = i8_decode_smem(M, C, K, nw);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const int occ = mgt::blocks_per_sm(kern, 32 * nw, smem);
  if (occ < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int n_strips = (N + kDecQuads * C - 1) / (kDecQuads * C);
  const dim3 grid(std::min(n_strips, occ * mgt::device_sms()));
  kern<<<grid, 32 * nw, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(x_scale),
      static_cast<const int8_t*>(codes), static_cast<const float*>(scales),
      static_cast<float*>(y), N, K, layer);
  return static_cast<int>(cudaGetLastError());
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

// x f32 [M, K]; x_scale f32 [M] or null (absmax / 127 per row, 0 -> 1);
// codes i8 [L, N, K]; scales f32 [L, N, K/256] (L = 1 for an unstacked
// weight); y f32 [M, N], the row scale applied.  Requires 1 <= M <= 8, K %
// 256 == 0, the M K bytes of x codes and the slice sums within shared
// memory (i8_decode_smem; K up to about 27000 at M = 8) and 16-byte aligned
// x and codes.
MGT_API int mgt_i8_decode(const void* x, const void* x_scale, const void* codes,
                          const void* scales, void* y, int M, int N, int K, int layer,
                          void* stream) {
  if (const int rc = check_args(M, N, K, layer)) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (M) {
    case 1: return i8_decode_run<1>(x, x_scale, codes, scales, y, N, K, layer, s);
    case 2: return i8_decode_run<2>(x, x_scale, codes, scales, y, N, K, layer, s);
    case 3: return i8_decode_run<3>(x, x_scale, codes, scales, y, N, K, layer, s);
    case 4: return i8_decode_run<4>(x, x_scale, codes, scales, y, N, K, layer, s);
    case 5: return i8_decode_run<5>(x, x_scale, codes, scales, y, N, K, layer, s);
    case 6: return i8_decode_run<6>(x, x_scale, codes, scales, y, N, K, layer, s);
    case 7: return i8_decode_run<7>(x, x_scale, codes, scales, y, N, K, layer, s);
    case 8: return i8_decode_run<8>(x, x_scale, codes, scales, y, N, K, layer, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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
