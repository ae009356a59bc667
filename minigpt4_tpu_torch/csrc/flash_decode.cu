// flash_decode: causal attention of S <= 32 query rows over the live part of
// one layer of a KV cache, online softmax in f32.  Two row sources:
//
//  - DenseKV, the stacked cache [L, B, H, C, Dh].  Replaces
//    minigpt4_tpu/ops/flash_decode.py:_kernel with paged=False and
//    stats=False (reached through _run and flash_decode_attention): every
//    decode step, and every prefill chunk of 32 rows or fewer (the 8-row
//    text buckets and the 32-row image embedding).  With an `ml` output it
//    also replaces the same _kernel with stats=True (reached through
//    _run(stats=True), flash_decode_attention(return_stats=True) and
//    sp_flash_decode_attention): `out` then gets the unnormalized
//    accumulator, rescaled to the running maximum m*, and ml[0] / ml[1] get
//    m* and the softmax denominator l of each row, the partials that
//    sequence-parallel attention merges across ranks.  The cursor may be
//    negative there (this rank's slice of the cache starts after the last
//    visible key); a row that sees no key gets m = -inf, l = 0, acc = 0.
//  - PagedKV, the serving page pools [L, NP + 1, H, 128, Dh] read through a
//    page table [B, W] (i32; lane b's keys [128 i, 128 i + 128) live in pool
//    page pt[b, i]).  Replaces the same _kernel with paged=True (reached
//    through _run_paged and paged_flash_decode_attention): every decode step
//    of a batched serving group over the page pool.  A lane reads at most
//    min(pos0 + S, 128 W) keys, so a finished lane decoding past its
//    capacity reads the table's trailing slot, which the pool points at its
//    trash page; no lane ever reads another lane's pages.
//
// Cache element types: f32, bf16 and e4m3 (float8_e4m3fn, one byte).  An
// e4m3 element is read as minigpt4_tpu/ops/flash_decode.py:_block_f32 (the
// e4m3 path of the same _kernel) reads it: exponent field 0 (zero and
// subnormals) gives +-0, 0x7F / 0xFF stay NaN, every other value is exact.
// The card's e4m3 -> f16 convert is exact but keeps subnormals, so its
// result is flushed where the exponent field is 0 (e4m3x2_to_f16x2).
//
// What bounds it on the H100.  At S = 1 and 8 device-memory bandwidth on the
// live K and V rows (2 (pos0 + S) Dh cache elements per (b, h), 1, 2 or 4
// bytes each); at S = 32 the f32 arithmetic, 4 S Dh operations per live key
// and head on the CUDA cores (the card tests hold the kernel to 1e-5 of its
// f32 plain version, which bf16 tensor-core products of an f32 q would not
// meet).  Both need the whole card busy, and a decode step has few heads.
//
// Design.  The grid is (H, B, splits): the live keys [0, min(pos0 + S, C))
// of each (b, h) are cut into 64-key tiles, and split z of `splits` takes
// the tiles [z T / splits, (z + 1) T / splits) of the T live tiles.  The
// wrapper picks `splits` from the keys a lane can hold, B, H and the SM
// count (ops/flash_decode.py:n_splits), so a decode step at B = 1 fills the
// card; each block finds its own range from the cursor on the device, so the
// host never reads the cursors.  64 divides the 128-key page, so a tile
// never straddles two pages and its rows are one contiguous [64, Dh] run in
// both layouts: DenseKV and PagedKV see identical splits and tiles, and the
// paged kernel does the dense kernel's arithmetic in the dense kernel's
// order (bit-equal results on the gathered cache).
//
// A block (256 threads) stages each K and V tile into shared memory with
// 16-byte cp.async copies, two tiles in flight (double buffer); a row at or
// past the lane's live end is zero-filled by the copy (source size 0), so no
// key past the cursor is ever read and a stale NaN there cannot reach the
// output.  f32 and bf16 tiles are used where they land; e4m3 tiles land raw
// and one pass unpacks each byte once to f16 (exact, NaN stays NaN; at S = 1,
// where each element has one reader, the reader unpacks it).  Every
// query row of the block is served from each staged tile: the scaled q
// (f32) sits in shared memory, Q.K^T is register-tiled (a thread owns up to
// 4 rows x 4 keys over a slice of Dh, the slices summed with shuffles), one
// warp per row updates the online softmax (running m, l and the rescale
// alpha) and writes the probabilities back, and P.V is register-tiled
// again (a thread owns up to 4 rows x 4 output columns, over all 64 keys or
// a part of them summed in a fixed order).  Tile rows are padded to spread
// shared-memory banks.  All arithmetic is f32 on the CUDA cores.
//
// The splits merge in the same launch: each block writes its partial (m, l
// and the unnormalized accumulator of every row) to a work buffer and
// counts itself in with an atomic on a per-(b, h) counter; the block that
// arrives last resets the counter to 0, merges the partials in split order
// (m* = max m_z, weights exp(m_z - m*), no float atomics, so the result does
// not depend on which block finishes last) and writes the output: acc / l,
// or with `ml` the merged accumulator, m* and l.  A split with no visible
// key for a row gives the neutral partial m = -inf, l = 0, acc = 0.  With
// one split the block writes the output itself.  Later work: the tensor
// cores for S = 32 (a split-bf16 q meeting 1e-5), TMA for the tiles.
#include <cuda_fp16.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;       // keys per staged tile
constexpr int kMaxRows = 32;    // FLASH_DECODE_MAX_S
constexpr int kPage = 128;      // positions per pool page (engine/paged.py PAGE)
constexpr int kMaxSplits = 32;  // ops/flash_decode.py MAX_SPLITS
static_assert(kPage % kTile == 0, "a key tile must not straddle two pages");

// Where the 64-key tile starting at `key0` of lane b, head h begins, as an
// element offset into the k (or v) tensor; the tile's rows follow at DH
// elements each.
struct DenseKV {
  int layer, B, H, C, dh;
  __device__ __forceinline__ size_t block(int b, int h, int key0) const {
    return ((static_cast<size_t>(layer) * B + b) * H + h) * static_cast<size_t>(C) * dh +
           static_cast<size_t>(key0) * dh;
  }
};

struct PagedKV {
  const int* __restrict__ pt;  // [B, W] pool page ids
  int layer, np1, H, W, dh;
  __device__ __forceinline__ size_t block(int b, int h, int key0) const {
    const int page = __ldg(pt + static_cast<size_t>(b) * W + key0 / kPage);
    return ((static_cast<size_t>(layer) * np1 + page) * H + h) * static_cast<size_t>(kPage) * dh +
           static_cast<size_t>(key0 % kPage) * dh;
  }
};

// One byte of an e4m3 cache.
struct E4M3 {
  uint8_t bits;
};

// _block_f32's unpack for two bytes (the low and high byte of b) to two
// f16: the card's e4m3 -> f16 convert, exact for every e4m3 value, NaN
// stays NaN; then exponent field 0 (zero and subnormals, |v| < 2^-6, f16
// bits below 0x2400) flushed to +-0 as _block_f32 does (the card's convert
// keeps subnormals).  t marks the kept lanes with 0x8000, t | (t - (t >> 15))
// widens that to 0xFFFF.
__device__ __forceinline__ uint32_t e4m3x2_to_f16x2(uint32_t b) {
  uint32_t h;
  asm("cvt.rn.f16x2.e4m3x2 %0, %1;" : "=r"(h) : "h"(static_cast<unsigned short>(b)));
  const uint32_t t = ((h & 0x7FFF7FFFu) + 0x5C005C00u) & 0x80008000u;
  return h & (t | (t - (t >> 15)) | 0x80008000u);
}

// four e4m3 bytes (in memory order) -> their four f16 values (uint2, in order)
__device__ __forceinline__ uint2 e4m3x4_to_f16x4(uint32_t w) {
  return make_uint2(e4m3x2_to_f16x2(w & 0xFFFFu), e4m3x2_to_f16x2(w >> 16));
}

// The element type a staged tile is read in: an e4m3 tile unpacks once to
// f16 where several threads read each element (S > 1); at S = 1 each
// element has one reader, which unpacks it as it reads it.
template <typename T, int SB> struct TileOf { using type = T; };
template <int SB> struct TileOf<E4M3, SB> {
  using type = typename std::conditional<(SB > 1), __half, E4M3>::type;
};

// four consecutive tile elements as f32
__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 c = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, c.x, c.y);
}

__device__ __forceinline__ float4 ld4(const __half* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&u.x));
  const float2 c = __half22float2(*reinterpret_cast<const __half2*>(&u.y));
  return make_float4(a.x, a.y, c.x, c.y);
}
__device__ __forceinline__ float4 ld4(const E4M3* p) {
  const uint2 u = e4m3x4_to_f16x4(*reinterpret_cast<const uint32_t*>(p));
  return ld4(reinterpret_cast<const __half*>(&u));
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with valid = false nothing is read and the 16
// bytes are zero-filled
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The thread layout of a row bucket SB (1, 8 or 32 query rows) and head
// width DH.
template <int SB, int DH>
struct Cfg {
  static constexpr int NQ = DH / 4;  // 4-element quads of a row
  // Q.K^T: thread = dp + DP (kq + 16 rs); keys kq + 16 j (j < 4), rows
  // rs + RS i (i < R), quads dp + DP u
  static constexpr int DP = SB == 1 ? 16 : 2;
  static constexpr int RS = kThreads / (16 * DP);
  static constexpr int R = SB / RS;
  // P.V: thread = dq + NQ (rs2 + RS2 kp); rows rs2 + RS2 i (i < R2), output
  // quad dq, keys [kp KN, kp KN + KN)
  static constexpr int NT2 = kThreads / NQ;
  static constexpr int RS2 = SB < NT2 ? SB : NT2;
  static constexpr int KP = NT2 / RS2;
  static constexpr int R2 = SB / RS2;
  static constexpr int KN = kTile / KP;
  static_assert(R >= 1 && R2 >= 1 && KN % 4 == 0 && (NQ % DP) == 0, "thread layout");
  static constexpr int QS = DH + 4;     // q row stride, floats
  static constexpr int PS = kTile + 4;  // probability row stride, floats
};

// Shared-memory layout (bytes) of one instance.
template <typename T, int DH, int SB>
struct Layout {
  using E = typename TileOf<T, SB>::type;
  using C = Cfg<SB, DH>;
  static constexpr bool kRaw = !std::is_same<T, E>::value;  // staged raw, unpacked by a pass
  static constexpr int KS = DH + 16 / static_cast<int>(sizeof(E));  // tile row stride, elements
  static constexpr int kTileBytes = kTile * KS * sizeof(E);         // one K or V tile
  static constexpr int kRawBytes = kTile * DH;                      // one raw e4m3 tile
  static constexpr int q_off = 0;
  static constexpr int p_off = q_off + SB * C::QS * 4;
  static constexpr int m_off = p_off + SB * C::PS * 4;
  static constexpr int l_off = m_off + SB * 4;
  static constexpr int a_off = l_off + SB * 4;
  static constexpr int w_off = a_off + SB * 4;
  static constexpr int flag_off = w_off + kMaxSplits * SB * 4;
  static constexpr int ring_off = (flag_off + 16 + 127) / 128 * 128;
  // ring: 2 stages x (K, V); e4m3: raw stages, then one unpacked (K, V)
  static constexpr int raw_off = ring_off;
  static constexpr int tile_off = kRaw ? ring_off + 4 * kRawBytes : ring_off;
  static constexpr int bytes = tile_off + (kRaw ? 2 : 4) * kTileBytes;
  static_assert(C::KP * SB * DH * 4 <= bytes - ring_off, "P.V reduction buffer");
};

template <typename T, int DH, int SB, typename KV>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const float* __restrict__ q, const T* __restrict__ ck,
                    const T* __restrict__ cv, const int* __restrict__ pos,
                    float* __restrict__ out, float* __restrict__ ml, float* __restrict__ part,
                    int* __restrict__ cnt, int H, int S, int C, int ns, float scale, KV kv) {
  using Cf = Cfg<SB, DH>;
  using L = Layout<T, DH, SB>;
  using E = typename L::E;
  constexpr int NQ = Cf::NQ, KS = L::KS;
  extern __shared__ __align__(128) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + L::q_off);
  float* ps = reinterpret_cast<float*>(smem + L::p_off);
  float* m_s = reinterpret_cast<float*>(smem + L::m_off);
  float* l_s = reinterpret_cast<float*>(smem + L::l_off);
  float* a_s = reinterpret_cast<float*>(smem + L::a_off);
  float* w_s = reinterpret_cast<float*>(smem + L::w_off);
  int* flag = reinterpret_cast<int*>(smem + L::flag_off);

  const int h = blockIdx.x, b = blockIdx.y, z = blockIdx.z;
  const int B = gridDim.y;
  const int tid = threadIdx.x;
  const int p0 = pos[b];
  const int live = max(0, min(p0 + S, C));
  const int n_tiles = (live + kTile - 1) / kTile;
  const int t0 = z * n_tiles / ns, t1 = (z + 1) * n_tiles / ns;
  const size_t bh = static_cast<size_t>(b) * H + h;

  const float* qb = q + bh * S * DH;
  for (int i = tid; i < SB * DH; i += kThreads) {
    const int r = i / DH;
    qs[r * Cf::QS + i % DH] = r < S ? qb[i] * scale : 0.f;
  }
  if (tid < SB) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  // K / V tile of stage st (as staged by cp.async: raw bytes for e4m3)
  auto k_tile = [&](int st) { return smem + L::tile_off + (2 * st) * L::kTileBytes; };
  auto v_tile = [&](int st) { return smem + L::tile_off + (2 * st + 1) * L::kTileBytes; };
  auto issue = [&](int t, int st) {
    const int key0 = t * kTile;
    const size_t off = kv.block(b, h, key0);
    const T* kb = ck + off;
    const T* vb = cv + off;
    constexpr int kPer = 16 / static_cast<int>(sizeof(T));  // elements per 16-byte chunk
    constexpr int kChunks = DH / kPer;                      // chunks per row
    unsigned char* kd = L::kRaw ? smem + L::raw_off + (2 * st) * L::kRawBytes : k_tile(st);
    unsigned char* vd = L::kRaw ? smem + L::raw_off + (2 * st + 1) * L::kRawBytes : v_tile(st);
    constexpr int kRow = L::kRaw ? DH : KS * static_cast<int>(sizeof(E));  // staged row, bytes
    for (int i = tid; i < kTile * kChunks; i += kThreads) {
      const int row = i / kChunks, c = i % kChunks;
      const bool valid = key0 + row < live;
      const size_t src = static_cast<size_t>(valid ? row : 0) * DH + c * kPer;
      cp_async16(smem_u32(kd + row * kRow + c * 16), kb + src, valid);
      cp_async16(smem_u32(vd + row * kRow + c * 16), vb + src, valid);
    }
    cp_commit();
  };

  float acc[Cf::R2][4];
#pragma unroll
  for (int i = 0; i < Cf::R2; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  const int dp = tid % Cf::DP, kq = (tid / Cf::DP) % 16, rs = tid / (Cf::DP * 16);
  const int dq = tid % NQ, rs2 = (tid / NQ) % Cf::RS2, kp = tid / NQ / Cf::RS2;
  const int warp = tid / 32, lane = tid % 32;

  if (t0 < t1) issue(t0, 0);
  __syncthreads();  // q, m, l in place
  for (int t = t0; t < t1; ++t) {
    const int st = (t - t0) & 1;
    if (t + 1 < t1) {
      issue(t + 1, st ^ 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const E* kt;
    const E* vt;
    if constexpr (L::kRaw) {
      // unpack the raw tiles once: 16 bytes -> 16 f16
      const unsigned char* raw = smem + L::raw_off + (2 * st) * L::kRawBytes;
      constexpr int kChunks = DH / 16;
      for (int i = tid; i < 2 * kTile * kChunks; i += kThreads) {
        const int which = i / (kTile * kChunks), r = (i / kChunks) % kTile, c = i % kChunks;
        const uint4 u =
            *reinterpret_cast<const uint4*>(raw + which * L::kRawBytes + r * DH + c * 16);
        const uint2 o0 = e4m3x4_to_f16x4(u.x), o1 = e4m3x4_to_f16x4(u.y);
        const uint2 o2 = e4m3x4_to_f16x4(u.z), o3 = e4m3x4_to_f16x4(u.w);
        uint4* dst = reinterpret_cast<uint4*>(k_tile(0) + which * L::kTileBytes +
                                              (r * KS + c * 16) * sizeof(E));
        dst[0] = make_uint4(o0.x, o0.y, o1.x, o1.y);
        dst[1] = make_uint4(o2.x, o2.y, o3.x, o3.y);
      }
      __syncthreads();
      kt = reinterpret_cast<const E*>(k_tile(0));
      vt = reinterpret_cast<const E*>(v_tile(0));
    } else {
      kt = reinterpret_cast<const E*>(k_tile(st));
      vt = reinterpret_cast<const E*>(v_tile(st));
    }

    // scores: R rows x 4 keys per thread over its quads of Dh
    {
      float sc[Cf::R][4];
#pragma unroll
      for (int i = 0; i < Cf::R; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll
      for (int u = 0; u < NQ / Cf::DP; ++u) {
        const int d = (dp + Cf::DP * u) * 4;
        float4 kf[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) kf[j] = ld4(kt + (kq + 16 * j) * KS + d);
#pragma unroll
        for (int i = 0; i < Cf::R; ++i) {
          const float4 qv = *reinterpret_cast<const float4*>(qs + (rs + Cf::RS * i) * Cf::QS + d);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            sc[i][j] = fmaf(qv.x, kf[j].x, sc[i][j]);
            sc[i][j] = fmaf(qv.y, kf[j].y, sc[i][j]);
            sc[i][j] = fmaf(qv.z, kf[j].z, sc[i][j]);
            sc[i][j] = fmaf(qv.w, kf[j].w, sc[i][j]);
          }
        }
      }
#pragma unroll
      for (int o = Cf::DP / 2; o > 0; o >>= 1)
#pragma unroll
        for (int i = 0; i < Cf::R; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[i][j] += __shfl_xor_sync(mgt::kFullMask, sc[i][j], o);
      if (dp == 0) {
#pragma unroll
        for (int i = 0; i < Cf::R; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int row = rs + Cf::RS * i, key = t * kTile + kq + 16 * j;
            const bool visible = row < S && key < live && key <= p0 + row;
            ps[row * Cf::PS + kq + 16 * j] = visible ? sc[i][j] : -INFINITY;
          }
      }
    }
    __syncthreads();

    // online softmax, one warp per row: m, l, alpha and the probabilities
    for (int row = warp; row < SB; row += kThreads / 32) {
      float* pr = ps + row * Cf::PS;
      const float s0 = pr[lane], s1 = pr[lane + 32];
      const float m_old = m_s[row];
      const float m_new = fmaxf(m_old, mgt::warp_max(fmaxf(s0, s1)));
      const float e0 = s0 == -INFINITY ? 0.f : expf(s0 - m_new);
      const float e1 = s1 == -INFINITY ? 0.f : expf(s1 - m_new);
      const float alpha = m_old == -INFINITY ? 0.f : expf(m_old - m_new);
      const float sum = mgt::warp_sum(e0 + e1);
      pr[lane] = e0;
      pr[lane + 32] = e1;
      __syncwarp();
      if (lane == 0) {
        m_s[row] = m_new;
        l_s[row] = l_s[row] * alpha + sum;
        a_s[row] = alpha;
      }
    }
    __syncthreads();

    // P.V: R2 rows x one output quad per thread over its keys
#pragma unroll
    for (int i = 0; i < Cf::R2; ++i) {
      const float a = a_s[rs2 + Cf::RS2 * i];
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] *= a;
    }
#pragma unroll 4
    for (int j0 = kp * Cf::KN; j0 < kp * Cf::KN + Cf::KN; j0 += 4) {
      float4 pv[Cf::R2];
#pragma unroll
      for (int i = 0; i < Cf::R2; ++i)
        pv[i] = *reinterpret_cast<const float4*>(ps + (rs2 + Cf::RS2 * i) * Cf::PS + j0);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float4 v = ld4(vt + (j0 + jj) * KS + dq * 4);
#pragma unroll
        for (int i = 0; i < Cf::R2; ++i) {
          const float p = comp(pv[i], jj);
          acc[i][0] = fmaf(p, v.x, acc[i][0]);
          acc[i][1] = fmaf(p, v.y, acc[i][1]);
          acc[i][2] = fmaf(p, v.z, acc[i][2]);
          acc[i][3] = fmaf(p, v.w, acc[i][3]);
        }
      }
    }
    __syncthreads();  // the stage and the probabilities are consumed
  }

  // key parts of P.V summed in part order (the ring is free now)
  if constexpr (Cf::KP > 1) {
    float* red = reinterpret_cast<float*>(smem + L::ring_off);
#pragma unroll
    for (int i = 0; i < Cf::R2; ++i)
      *reinterpret_cast<float4*>(red + (kp * SB + rs2 + Cf::RS2 * i) * DH + dq * 4) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    __syncthreads();
    if (kp == 0) {
#pragma unroll
      for (int i = 0; i < Cf::R2; ++i)
        for (int k2 = 1; k2 < Cf::KP; ++k2) {
          const float4 o =
              *reinterpret_cast<const float4*>(red + (k2 * SB + rs2 + Cf::RS2 * i) * DH + dq * 4);
          acc[i][0] += o.x;
          acc[i][1] += o.y;
          acc[i][2] += o.z;
          acc[i][3] += o.w;
        }
    }
  }

  float* ml_l = ml == nullptr ? nullptr : ml + static_cast<size_t>(B) * H * S;
  if (ns == 1) {
    if (kp == 0) {
      float* ob = out + bh * S * DH;
#pragma unroll
      for (int i = 0; i < Cf::R2; ++i) {
        const int row = rs2 + Cf::RS2 * i;
        if (row >= S) continue;
        float4 o = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        if (ml == nullptr) {
          const float l = l_s[row];
          o = make_float4(o.x / l, o.y / l, o.z / l, o.w / l);
        }
        *reinterpret_cast<float4*>(ob + row * DH + dq * 4) = o;
      }
    }
    if (ml != nullptr && tid < S) {
      ml[bh * S + tid] = m_s[tid];
      ml_l[bh * S + tid] = l_s[tid];
    }
    return;
  }

  // this split's partial: acc [S, DH] and (m, l) [2, S]
  const size_t n_part = static_cast<size_t>(B) * H * ns;
  float* pacc = part + (bh * ns + z) * S * DH;
  float* pml = part + n_part * S * DH + (bh * ns + z) * 2 * S;
  if (tid < S) {
    pml[tid] = m_s[tid];
    pml[S + tid] = l_s[tid];
  }
  if (kp == 0 && t0 < t1) {
#pragma unroll
    for (int i = 0; i < Cf::R2; ++i) {
      const int row = rs2 + Cf::RS2 * i;
      if (row < S)
        *reinterpret_cast<float4*>(pacc + row * DH + dq * 4) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int last = atomicAdd(cnt + bh, 1) == ns - 1;
    if (last) cnt[bh] = 0;  // every split has counted in: ready for the next launch
    *flag = last;
  }
  __syncthreads();
  if (!*flag) return;
  __threadfence();

  // the last block merges the partials in split order
  const float* mlb = part + n_part * S * DH + bh * ns * 2 * S;
  if (tid < S) {
    float mstar = -INFINITY;
    for (int z2 = 0; z2 < ns; ++z2) mstar = fmaxf(mstar, __ldcg(mlb + z2 * 2 * S + tid));
    float lsum = 0.f;
    for (int z2 = 0; z2 < ns; ++z2) {
      const float m = __ldcg(mlb + z2 * 2 * S + tid);
      float w = 0.f;
      if (m != -INFINITY) {
        w = expf(m - mstar);
        lsum += __ldcg(mlb + z2 * 2 * S + S + tid) * w;
      }
      w_s[z2 * SB + tid] = w;
    }
    m_s[tid] = mstar;
    l_s[tid] = lsum;
  }
  __syncthreads();
  const float* accb = part + bh * ns * S * DH;
  float* ob = out + bh * S * DH;
  for (int i = tid; i < S * NQ; i += kThreads) {
    const int row = i / NQ, d = (i % NQ) * 4;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int z2 = 0; z2 < ns; ++z2) {
      const float w = w_s[z2 * SB + row];
      if (w == 0.f) continue;  // no visible key in that split (or a weight below f32)
      const float4 v = __ldcg(reinterpret_cast<const float4*>(accb + (z2 * S + row) * DH + d));
      a.x = fmaf(w, v.x, a.x);
      a.y = fmaf(w, v.y, a.y);
      a.z = fmaf(w, v.z, a.z);
      a.w = fmaf(w, v.w, a.w);
    }
    if (ml == nullptr) {
      const float l = l_s[row];
      a = make_float4(a.x / l, a.y / l, a.z / l, a.w / l);
    }
    *reinterpret_cast<float4*>(ob + row * DH + d) = a;
  }
  if (ml != nullptr && tid < S) {
    ml[bh * S + tid] = m_s[tid];
    ml_l[bh * S + tid] = l_s[tid];
  }
}

template <typename T, int DH, int SB, typename KV>
int launch(const void* q, const void* ck, const void* cv, const void* pos, void* out, void* ml,
           void* work, void* cnt, int B, int H, int S, int C, int ns, float scale, KV kv,
           cudaStream_t stream) {
  constexpr int bytes = Layout<T, DH, SB>::bytes;
  auto kern = flash_decode_kernel<T, DH, SB, KV>;
  // once per instance (a launch captured into a CUDA graph needs no host call)
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kern<<<dim3(H, B, ns), kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const T*>(ck), static_cast<const T*>(cv),
      static_cast<const int*>(pos), static_cast<float*>(out), static_cast<float*>(ml),
      static_cast<float*>(work), static_cast<int*>(cnt), H, S, C, ns, scale, kv);
  return static_cast<int>(cudaGetLastError());
}

// cache element type codes of the entries
constexpr int kF32 = 0, kBF16 = 1, kE4M3 = 2;

template <typename T, int DH, typename KV>
int launch_rows(const void* q, const void* ck, const void* cv, const void* pos, void* out,
                void* ml, void* work, void* cnt, int B, int H, int S, int C, int ns, float scale,
                KV kv, cudaStream_t s) {
  if (S == 1) return launch<T, DH, 1>(q, ck, cv, pos, out, ml, work, cnt, B, H, S, C, ns, scale, kv, s);
  if (S <= 8) return launch<T, DH, 8>(q, ck, cv, pos, out, ml, work, cnt, B, H, S, C, ns, scale, kv, s);
  return launch<T, DH, 32>(q, ck, cv, pos, out, ml, work, cnt, B, H, S, C, ns, scale, kv, s);
}

template <typename T, typename KV>
int launch_dh(const void* q, const void* ck, const void* cv, const void* pos, void* out, void* ml,
              void* work, void* cnt, int B, int H, int S, int C, int Dh, int ns, float scale,
              KV kv, cudaStream_t s) {
  if (Dh == 128)
    return launch_rows<T, 128>(q, ck, cv, pos, out, ml, work, cnt, B, H, S, C, ns, scale, kv, s);
  if (Dh == 64)
    return launch_rows<T, 64>(q, ck, cv, pos, out, ml, work, cnt, B, H, S, C, ns, scale, kv, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename KV>
int dispatch(const void* q, const void* ck, const void* cv, const void* pos, void* out, void* ml,
             void* work, void* cnt, int B, int H, int S, int C, int Dh, int ns, float scale,
             int cache_type, KV kv, cudaStream_t s) {
  if (ns < 1 || ns > kMaxSplits || (ns > 1 && (work == nullptr || cnt == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (cache_type) {
    case kF32:
      return launch_dh<float>(q, ck, cv, pos, out, ml, work, cnt, B, H, S, C, Dh, ns, scale, kv, s);
    case kBF16:
      return launch_dh<__nv_bfloat16>(q, ck, cv, pos, out, ml, work, cnt, B, H, S, C, Dh, ns,
                                      scale, kv, s);
    case kE4M3:
      return launch_dh<E4M3>(q, ck, cv, pos, out, ml, work, cnt, B, H, S, C, Dh, ns, scale, kv, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q f32 [B, H, S, Dh]; ck/cv [L, B, H, C, Dh] f32 (cache_type 0), bf16 (1)
// or e4m3 (2); pos i32 [B] (negative allowed); out f32 [B, H, S, Dh]; ml
// null (out normalized) or f32 [2, B, H, S] (out the unnormalized
// accumulator, ml[0] its m*, ml[1] its l).  splits: key splits per (b, h),
// 1..32; with more than one, work is f32 [B H splits S (Dh + 2)] scratch and
// cnt i32 [B H] counters that are 0 before the launch and 0 again after it.
// Requires 1 <= S <= 32, Dh in {64, 128} and 16-byte aligned q and caches.
MGT_API int mgt_flash_decode(const void* q, const void* ck, const void* cv, const void* pos,
                             void* out, void* ml, void* work, void* cnt, int B, int H, int S,
                             int C, int Dh, int layer, int splits, float scale, int cache_type,
                             void* stream) {
  if (S < 1 || S > kMaxRows || B < 1 || H < 1 || C < 1) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(q, ck, cv, pos, out, ml, work, cnt, B, H, S, C, Dh, splits, scale, cache_type,
                  DenseKV{layer, B, H, C, Dh}, static_cast<cudaStream_t>(stream));
}

// q f32 [B, H, S, Dh]; pk/pv page pools [L, NP1, H, 128, Dh] of the
// element type cache_type (as above); pos i32 [B]; pt i32 [B, W] page ids
// in [0, NP1); out f32 [B, H, S, Dh]; splits, work and cnt as above.
// Requires 1 <= S <= 32, Dh in {64, 128} and 16-byte aligned q and pools.
MGT_API int mgt_flash_decode_paged(const void* q, const void* pk, const void* pv,
                                   const void* pos, const void* pt, void* out, void* work,
                                   void* cnt, int B, int H, int S, int NP1, int W, int Dh,
                                   int layer, int splits, float scale, int cache_type,
                                   void* stream) {
  if (S < 1 || S > kMaxRows || B < 1 || H < 1 || NP1 < 1 || W < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(q, pk, pv, pos, out, nullptr, work, cnt, B, H, S, W * kPage, Dh, splits, scale,
                  cache_type, PagedKV{static_cast<const int*>(pt), layer, NP1, H, W, Dh},
                  static_cast<cudaStream_t>(stream));
}
