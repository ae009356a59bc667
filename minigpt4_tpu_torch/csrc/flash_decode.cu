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
//    accumulator, rescaled to the block's running maximum m*, and ml[0] /
//    ml[1] get m* and the softmax denominator l of each row, the partials
//    that sequence-parallel attention merges across ranks.  The cursor may
//    be negative there (this rank's slice of the cache starts after the last
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
// e4m3 element is unpacked to f32 by an integer exponent rebias, the function
// of minigpt4_tpu/ops/flash_decode.py:_block_f32 (the e4m3 path of the same
// _kernel): exponent field 0 (zero and subnormals) gives +-0, 0x7F / 0xFF
// stay NaN, every other value is exact.  The card's native f8 -> f32
// conversion keeps subnormals, so it does not compute that function and is
// not used.
//
// What bounds it on the H100: device-memory bandwidth on the live K and V
// rows (2 * (pos0 + S) * Dh cache elements per (b, h), 1, 2 or 4 bytes
// each); the arithmetic, 4 * S * Dh flops per key, stays far below the
// card's ratio.
//
// Design.  One block per (h, b), eight warps.  The block reads its own
// cursor pos[b] and loops only over the keys [0, min(pos0 + S, C)): keys
// past the cache end are masked, not refused.  Query rows are scaled by
// `scale` in f32 and kept in shared memory.  Warps split the work two ways:
// rows in groups of RPW, and the live keys in 32-key blocks taken
// round-robin by the warps that share a row group, so that a single decode
// row still keeps all eight warps streaming the cache.  Per 32-key block a
// lane owns one key for the scores (q . k over Dh, causal mask
// key <= pos0 + row) and a Dh/32 slice of the output for P.V, with the
// online-softmax rescale in f32.  Warps that split the keys merge their
// (m, l, acc) partials through shared memory in a fixed order, so results
// are deterministic.  The output is acc / l in f32.  The row source only
// says where a 32-key block starts: 32 divides the 128-key page, so a block
// never straddles two pages and its rows are contiguous in both layouts, and
// the paged kernel does the dense kernel's arithmetic in the dense kernel's
// order (bit-equal results on the gathered cache).  One table read per
// 32-key block.  Later work: split the keys across blocks as well (one block
// per (b, h) leaves most SMs idle at batch 1) and stage K/V (or whole pages)
// through shared memory with TMA.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kKeys = 32;      // keys per warp step: one per lane
constexpr int kMaxRows = 32;   // FLASH_DECODE_MAX_S
constexpr int kPage = 128;     // positions per pool page (engine/paged.py PAGE)
static_assert(kPage % kKeys == 0, "a key block must not straddle two pages");

// Where the 32-key block starting at `key0` of lane b, head h begins, as an
// element offset into the k (or v) tensor; the block's rows follow at DH
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

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* o) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float* o) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

// One byte of an e4m3 cache.
struct E4M3 {
  uint8_t bits;
};

// _block_f32's unpack: sign, exponent rebias 7 -> 127, the 3 mantissa bits
// on top of the f32 mantissa; exponent field 0 -> +-0, 0x7F -> NaN.
__device__ __forceinline__ float e4m3_to_f32(uint32_t b) {
  const uint32_t em = b & 0x7Fu, sign = (b & 0x80u) << 24;
  if (em < 8u) return __uint_as_float(sign);
  if (em == 0x7Fu) return __uint_as_float(sign | 0x7FC00000u);
  return __uint_as_float(sign | ((em + (120u << 3)) << 20));
}

__device__ __forceinline__ void load8(const E4M3* p, float* o) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[i] = e4m3_to_f32((u.x >> (8 * i)) & 0xFFu);
    o[4 + i] = e4m3_to_f32((u.y >> (8 * i)) & 0xFFu);
  }
}

__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(E4M3 v) { return e4m3_to_f32(v.bits); }

// C: the keys a lane can hold (the dense cache length, or 128 W paged).
template <typename T, int DH, int RPW, typename KV>
__global__ void __launch_bounds__(kWarps * 32)
flash_decode_kernel(const float* __restrict__ q, const T* __restrict__ ck,
                    const T* __restrict__ cv, const int* __restrict__ pos,
                    float* __restrict__ out, float* __restrict__ ml, int H, int S, int C,
                    float scale, KV kv) {
  constexpr int kSlice = DH / 32;  // output elements per lane
  __shared__ __align__(16) float qs[kMaxRows][DH];  // scaled q; later the merge buffer
  __shared__ float ms[kWarps][RPW];
  __shared__ float ls[kWarps][RPW];

  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int p0 = pos[b];
  const int live = min(p0 + S, C);
  const int nblk = live > 0 ? (live + kKeys - 1) / kKeys : 0;
  const int n_rg = (S + RPW - 1) / RPW;  // row groups
  const int n_ks = kWarps / n_rg;        // warps sharing one row group
  const int rg = warp % n_rg, ks = warp / n_rg;
  const bool active = ks < n_ks;
  const int r0 = rg * RPW;

  const float* qb = q + static_cast<size_t>(b * H + h) * S * DH;
  for (int i = threadIdx.x; i < kMaxRows * DH; i += blockDim.x) {
    const int r = i / DH;
    qs[r][i % DH] = r < S ? qb[i] * scale : 0.f;
  }
  __syncthreads();

  float m[RPW], l[RPW], acc[RPW][kSlice];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < kSlice; ++e) acc[r][e] = 0.f;
  }

  if (active) {
    for (int blk = ks; blk < nblk; blk += n_ks) {
      const size_t off = kv.block(b, h, blk * kKeys);
      const T* kb = ck + off;  // key rows blk * 32 .. blk * 32 + 31
      const T* vb = cv + off;
      const int key = blk * kKeys + lane;
      float sc[RPW];
#pragma unroll
      for (int r = 0; r < RPW; ++r) sc[r] = 0.f;
      if (key < live) {
        const T* krow = kb + static_cast<size_t>(lane) * DH;
#pragma unroll 4
        for (int d0 = 0; d0 < DH; d0 += 8) {
          float kf[8];
          load8(krow + d0, kf);
#pragma unroll
          for (int r = 0; r < RPW; ++r) {
            const float4 qa = *reinterpret_cast<const float4*>(&qs[r0 + r][d0]);
            const float4 qc = *reinterpret_cast<const float4*>(&qs[r0 + r][d0 + 4]);
            sc[r] += qa.x * kf[0] + qa.y * kf[1] + qa.z * kf[2] + qa.w * kf[3] +
                     qc.x * kf[4] + qc.y * kf[5] + qc.z * kf[6] + qc.w * kf[7];
          }
        }
      }
      float pr[RPW];
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const bool visible = key < live && key <= p0 + r0 + r;
        const float s = visible ? sc[r] : -INFINITY;
        const float m_new = fmaxf(m[r], mgt::warp_max(s));
        const float p = visible ? expf(s - m_new) : 0.f;
        const float alpha = m[r] == -INFINITY ? 0.f : expf(m[r] - m_new);
        l[r] = l[r] * alpha + mgt::warp_sum(p);
        m[r] = m_new;
#pragma unroll
        for (int e = 0; e < kSlice; ++e) acc[r][e] *= alpha;
        pr[r] = p;
      }
      const int nk = min(kKeys, live - blk * kKeys);
      for (int j = 0; j < nk; ++j) {
        const T* vrow = vb + static_cast<size_t>(j) * DH + lane * kSlice;
        float vv[kSlice];
#pragma unroll
        for (int e = 0; e < kSlice; ++e) vv[e] = to_float(vrow[e]);
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
          const float pj = __shfl_sync(mgt::kFullMask, pr[r], j);
#pragma unroll
          for (int e = 0; e < kSlice; ++e) acc[r][e] = fmaf(pj, vv[e], acc[r][e]);
        }
      }
    }
  }

  // merge the key-split partials of each row group, in warp order
  __syncthreads();  // every warp is done with qs
  if (active && lane == 0) {
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      ms[warp][r] = m[r];
      ls[warp][r] = l[r];
    }
  }
  __syncthreads();
  float total[RPW], mrow[RPW];
  if (active) {
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      float mstar = -INFINITY;
      for (int k2 = 0; k2 < n_ks; ++k2) mstar = fmaxf(mstar, ms[rg + k2 * n_rg][r]);
      float lsum = 0.f;
      for (int k2 = 0; k2 < n_ks; ++k2) {
        const float mw = ms[rg + k2 * n_rg][r];
        if (mw != -INFINITY) lsum += ls[rg + k2 * n_rg][r] * expf(mw - mstar);
      }
      total[r] = lsum;
      mrow[r] = mstar;
      const float f = m[r] == -INFINITY ? 0.f : expf(m[r] - mstar);
#pragma unroll
      for (int e = 0; e < kSlice; ++e) acc[r][e] *= f;
    }
  }
  float* buf = &qs[0][0];  // [n_rg * RPW][DH] fits in kMaxRows * DH
  for (int k2 = 0; k2 < n_ks; ++k2) {
    if (active && ks == k2) {
#pragma unroll
      for (int r = 0; r < RPW; ++r)
#pragma unroll
        for (int e = 0; e < kSlice; ++e) {
          float* dst = buf + (r0 + r) * DH + lane * kSlice + e;
          *dst = k2 == 0 ? acc[r][e] : *dst + acc[r][e];
        }
    }
    __syncthreads();
  }
  if (active && ks == 0) {
    float* ob = out + static_cast<size_t>(b * H + h) * S * DH;
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      if (r0 + r >= S) continue;
      if (ml == nullptr) {
#pragma unroll
        for (int e = 0; e < kSlice; ++e) {
          const int i = (r0 + r) * DH + lane * kSlice + e;
          ob[i] = buf[i] / total[r];
        }
        continue;
      }
      // partials: the accumulator as it stands, m* and l beside it
#pragma unroll
      for (int e = 0; e < kSlice; ++e) {
        const int i = (r0 + r) * DH + lane * kSlice + e;
        ob[i] = buf[i];
      }
      if (lane == 0) {
        const size_t j = static_cast<size_t>(b * H + h) * S + r0 + r;
        ml[j] = mrow[r];
        ml[static_cast<size_t>(gridDim.y) * H * S + j] = total[r];
      }
    }
  }
}

template <typename T, int DH, typename KV>
void launch(const void* q, const void* ck, const void* cv, const void* pos, void* out,
            void* ml, int B, int H, int S, int C, float scale, KV kv, cudaStream_t stream) {
  const dim3 grid(H, B);
  if (S == 1) {
    flash_decode_kernel<T, DH, 1, KV><<<grid, kWarps * 32, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const T*>(ck), static_cast<const T*>(cv),
        static_cast<const int*>(pos), static_cast<float*>(out), static_cast<float*>(ml), H, S,
        C, scale, kv);
  } else {
    flash_decode_kernel<T, DH, 8, KV><<<grid, kWarps * 32, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const T*>(ck), static_cast<const T*>(cv),
        static_cast<const int*>(pos), static_cast<float*>(out), static_cast<float*>(ml), H, S,
        C, scale, kv);
  }
}

// cache element type codes of the entries
constexpr int kF32 = 0, kBF16 = 1, kE4M3 = 2;

template <typename T, typename KV>
int launch_dh(const void* q, const void* ck, const void* cv, const void* pos, void* out,
              void* ml, int B, int H, int S, int C, int Dh, float scale, KV kv, cudaStream_t s) {
  if (Dh == 128)
    launch<T, 128>(q, ck, cv, pos, out, ml, B, H, S, C, scale, kv, s);
  else if (Dh == 64)
    launch<T, 64>(q, ck, cv, pos, out, ml, B, H, S, C, scale, kv, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

template <typename KV>
int dispatch(const void* q, const void* ck, const void* cv, const void* pos, void* out,
             void* ml, int B, int H, int S, int C, int Dh, float scale, int cache_type, KV kv,
             cudaStream_t s) {
  switch (cache_type) {
    case kF32: return launch_dh<float>(q, ck, cv, pos, out, ml, B, H, S, C, Dh, scale, kv, s);
    case kBF16:
      return launch_dh<__nv_bfloat16>(q, ck, cv, pos, out, ml, B, H, S, C, Dh, scale, kv, s);
    case kE4M3: return launch_dh<E4M3>(q, ck, cv, pos, out, ml, B, H, S, C, Dh, scale, kv, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q f32 [B, H, S, Dh]; ck/cv [L, B, H, C, Dh] f32 (cache_type 0), bf16 (1)
// or e4m3 (2); pos i32 [B] (negative allowed); out f32 [B, H, S, Dh]; ml
// null (out normalized) or f32 [2, B, H, S] (out the unnormalized
// accumulator, ml[0] its m*, ml[1] its l).  Requires 1 <= S <= 32, Dh in
// {64, 128} and 16-byte aligned q and caches.
MGT_API int mgt_flash_decode(const void* q, const void* ck, const void* cv,
                             const void* pos, void* out, void* ml, int B, int H, int S,
                             int C, int Dh, int layer, float scale,
                             int cache_type, void* stream) {
  if (S < 1 || S > kMaxRows || B < 1 || H < 1 || C < 1) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(q, ck, cv, pos, out, ml, B, H, S, C, Dh, scale, cache_type,
                  DenseKV{layer, B, H, C, Dh}, static_cast<cudaStream_t>(stream));
}

// q f32 [B, H, S, Dh]; pk/pv page pools [L, NP1, H, 128, Dh] of the
// element type cache_type (as above); pos i32 [B]; pt i32 [B, W] page ids in [0, NP1);
// out f32 [B, H, S, Dh].  Requires 1 <= S <= 32, Dh in {64, 128} and
// 16-byte aligned q and pools.
MGT_API int mgt_flash_decode_paged(const void* q, const void* pk, const void* pv,
                                   const void* pos, const void* pt, void* out, int B,
                                   int H, int S, int NP1, int W, int Dh, int layer,
                                   float scale, int cache_type, void* stream) {
  if (S < 1 || S > kMaxRows || B < 1 || H < 1 || NP1 < 1 || W < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(q, pk, pv, pos, out, nullptr, B, H, S, W * kPage, Dh, scale, cache_type,
                  PagedKV{static_cast<const int*>(pt), layer, NP1, H, W, Dh},
                  static_cast<cudaStream_t>(stream));
}
