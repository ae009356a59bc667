// probe_group_i8: the exact-q5_k matmul with i8 codes and dual-i8
// activations, on the integer tensor cores.
//
// Replaces tools/qmm_group_i8.py:_kernel (:75), reached through _run (:99)
// and its pl.pallas_call (:115).  Both compute, per output (m, n),
//
//   y[m, n] = sum_g sc[g, n] * (s1[m] * c1[g, m, n] + s2[m] * c2[g, m, n])
//                 + sgt[g, m] * bt[g, n]
//   c1[g, m, n] = sum_{k in g} q[n, k] * x1[m, k],  c2 likewise over x2,
//
// over groups g of 32 codes: q the 5-bit codes 0..31 stored as i8 [L, N, K],
// x ~= s1 * x1 + s2 * x2 the dual-i8 split of each activation row
// (ops/probes.split_activations), sc / bt the bf16 per-group scale and bias
// planes [L, G, N], and sgt [G, M] the f32 group sums of x.  c1 and c2 are
// exact i32; the combination runs in f32 as t = s1 * c1 + s2 * c2, then
// acc += t * sc + sgt * bt, each product and sum rounded on its own (no
// fused multiply-add), as the TPU kernel and the plain version write it.
// The TPU kernel masks 16 M activation rows to single groups so one MXU
// dot yields the per-group partials; nothing of that carries over here.
//
// What bounds it on the H100: device-memory bandwidth on the code stream,
// 1 B per weight plus 1/8 B of planes.  The group dots run on the s8 tensor
// cores (2 16 8 32 operations an MMA, padding included, at 1979 TOP/s: about
// 1 us at the 13B w13 shape against ~47 us of bytes); the f32 combination
// is 4 products and 3 sums per group, output row and activation row, and
// with the copies it is what keeps the kernel from the bytes' time.
//
// Design (the hopper-kernels guide, sections 1 and 4; the ring, the walk
// and the MMA are probe_ring.cuh's):
// * A persistent grid of one block per SM (its shared memory allows no
//   second), the output rows split evenly between the clusters and walked
//   in chunks of up to 4 tiles of 16 rows.  Where N has fewer tiles than
//   the card has SMs, a cluster of up to 8 blocks splits K (one chunk a
//   cluster), and rank 0 adds the ranks' sums in rank order through
//   distributed shared memory.
// * A ring of 4-5 slots in shared memory, each one step of 512 codes of K:
//   the codes of the chunk's rows, the step's 16 groups of both planes for
//   those rows, its group sums sgt and both activation planes x1, x2, all
//   copied by cp.async (16 bytes a lane).  At M <= 4, 4 producer warps copy
//   and 8 consumer warps compute (full / empty mbarriers a slot); at M =
//   5..8, 16 warps do both, one barrier a step.
// * A consumer warp takes two groups of each step (one at M = 5..8), for
//   every tile of the chunk: one mma.sync m16n8k32 s8 (IMMA.16832.S8.S8) per
//   tile at M <= 4, two at M = 5..8.  A = the tile's codes (16 rows by the
//   group's 32 codes), lane t's k slots its own 8 contiguous bytes; B = x
//   transposed in the same k order, x1's row m in column 2 m and x2's in 2 m
//   + 1 (of the MMA's half m / 4), so that the D fragment hands each lane (g,
//   t) c1 and c2 of output rows g, g + 8 and activation row t (+ 4) with no
//   shuffle.
// * The lanes that hold D form the group's f32 term for the rows and
//   activation rows that exist, with the rounded operations above, and add
//   it to their own sums; no lane computes a term it throws away.
// * At a chunk's end the warps' sums go through shared memory (the slot just
//   computed) and are added in warp order: a fixed order, no atomics, the
//   same bits on every launch.
#include "probe_ring.cuh"

namespace {

using namespace mgt;
using namespace mgt::probe;

constexpr int kGS = 32;   // group size of q5_k
constexpr int kSB = 256;  // K % kSB == 0

struct GArgs {
  const int8_t* x1;
  const int8_t* x2;
  const float* s12;
  const float* sgt;
  const int8_t* codes;
  const __nv_bfloat16* sct;
  const __nv_bfloat16* bt;
  float* y;
  int M, N, K, layer;
};

// The tiling of MH halves of the MMA's n8 side (ops/probes.ring_geometry
// mirrors it).  At M <= 4 (one half) the block splits its roles: 4
// producer warps copy, 8 consumer warps compute two groups of each step,
// and the copies stream while the consumers compute.  At M = 5..8 the f32
// combination of two halves is twice the work, and 16 warps that each copy
// and compute one group of a step (one ring for both roles) measured faster.
template <int MH>
struct Geo {
  static constexpr int NPW = MH == 1 ? 4 : 0;          // producer warps
  static constexpr int NCW = MH == 1 ? 8 : 16;         // consumer warps
  static constexpr int NT = 32 * (NPW + NCW), NC = 32 * NCW;
  static constexpr int NP = NPW ? 32 * NPW : NT;       // the threads that copy
  static constexpr int CR = 64, CT = CR / kTile;       // rows, tiles per chunk
  static constexpr int KS = 512, GPS = KS / kGS;       // codes, groups per step
  static constexpr int GW = GPS / NCW;                 // groups per consumer warp and step
  static constexpr int MT = 4 * MH;                    // activation rows, at most
  // codes [CR][CSTR]: 32 bytes of padding a row, so a quad's 8-byte reads
  // of rows g .. g + 3 fall on four sets of banks
  static constexpr int CSTR = KS + 32;
  // planes [2][GPS] runs of CR bf16 (each at its source's 16-byte offset)
  static constexpr int PSTR = 16 * run_pieces(CR * 2);
  static constexpr int OFF_P = CR * CSTR;
  // sgt: the step's GPS x M floats as one run
  static constexpr int OFF_G = OFF_P + 2 * GPS * PSTR;
  // x: row 2 m + p holds plane p (x1, x2) of activation row m
  static constexpr int OFF_X = OFF_G + 16 * run_pieces(GPS * MT * 4);
  static constexpr int XSTR = KS + 32;
  static constexpr int SLOT = OFF_X + 2 * MT * XSTR;
  static constexpr int RED = NCW * CR * MT * 4;  // the warps' sums of a chunk, in its slot
  static constexpr int PART = CR * MT * 4;       // a cluster rank's sums, after the ring
  static constexpr int FREE = kMaxSmem - PART - 16 * 5;
  static constexpr int D = FREE / SLOT < 5 ? FREE / SLOT : 5;  // ring slots
  static constexpr int OFF_BAR = D * SLOT + PART;              // D full, D empty mbarriers
  static constexpr int SMEM = OFF_BAR + 16 * D;
  static_assert(GW * NCW == GPS, "whole groups a consumer warp");
  static_assert(D >= 3 && RED <= SLOT && SLOT % 16 == 0, "a ring of three slots or more");
};

__device__ __forceinline__ float bf16_at(const uint8_t* p) {
  return __uint_as_float(static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(p)) << 16);
}

// MH halves of the MMA's n8 side: 4 activation rows each
template <int MH>
__global__ void __launch_bounds__(Geo<MH>::NT, 1) probe_group_i8_kernel(const GArgs a) {
  using G = Geo<MH>;
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const bool producer = warp < G::NPW;
  const int cw = warp - G::NPW, ct = tid - 32 * G::NPW;  // consumer warp, thread
  const int M = a.M, N = a.N, K = a.K;
  const size_t li = static_cast<size_t>(a.layer);
  const int8_t* codes = a.codes + li * N * K;
  const __nv_bfloat16* sct = a.sct + li * (K / kGS) * N;
  const __nv_bfloat16* bt = a.bt + li * (K / kGS) * N;
  auto cluster = cooperative_groups::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rk = static_cast<int>(cluster.block_rank());
  const Walk<G::KS, G::CT, G::D> w(N, K, csize, rk, blockIdx.x / csize, gridDim.x / csize);
  if (w.ntb <= 0) return;  // a whole cluster at once: its rows are its ranks'
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + G::OFF_BAR);
  if (G::NPW > 0 && tid == 0) init_ring_barriers(full, full + G::D, G::D, G::NP, G::NCW);
  __syncthreads();
  float* part = reinterpret_cast<float*>(smem + G::D * G::SLOT);  // the same place in every rank

  // the scales of this lane's activation rows t, t + 4
  float s1[MH], s2[MH];
#pragma unroll
  for (int mh = 0; mh < MH; ++mh) {
    const int m = mh * 4 + t;
    s1[mh] = m < M ? __ldg(a.s12 + 2 * m) : 0.f;
    s2[mh] = m < M ? __ldg(a.s12 + 2 * m + 1) : 0.f;
  }
  float acc[G::CT][2][MH];  // tile, row g / g + 8, activation row t / t + 4
#pragma unroll
  for (int ti = 0; ti < G::CT; ++ti)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int mh = 0; mh < MH; ++mh) acc[ti][r][mh] = 0.f;

  // a step's copies, by the copying threads
  auto issue = [&](const Pos& p) {
    constexpr int NP = G::NP;
    uint8_t* base = smem + p.sl * G::SLOT;
    constexpr int CP = G::KS / 16;  // 16-byte pieces of a row's step
    for (int i = tid; i < p.nrows * CP; i += NP) {
      const int row = i / CP, q = i % CP;
      if (16 * q < p.len)
        cp_async<16>(base + row * G::CSTR + 16 * q,
                     codes + static_cast<size_t>(p.n0 + row) * K + p.k0 + 16 * q);
    }
    const int ng = p.len / kGS, g0 = p.k0 / kGS;
    constexpr int PP = run_pieces(G::CR * 2);
    for (int i = tid; i < 2 * G::GPS * PP; i += NP) {
      const int run = i / PP, q = i % PP, gl = run % G::GPS;
      if (gl < ng)
        cp_async_piece(base + G::OFF_P + run * G::PSTR,
                       (run < G::GPS ? sct : bt) + static_cast<size_t>(g0 + gl) * N + p.n0,
                       2 * p.nrows, q);
    }
    constexpr int GP = run_pieces(G::GPS * G::MT * 4);
    for (int i = tid; i < GP; i += NP)
      cp_async_piece(base + G::OFF_G, a.sgt + static_cast<size_t>(g0) * M, ng * M * 4, i);
    for (int i = tid; i < 2 * M * CP; i += NP) {
      const int r = i / CP, q = i % CP;
      if (16 * q < p.len)
        cp_async<16>(base + G::OFF_X + r * G::XSTR + 16 * q,
                     (r % 2 ? a.x2 : a.x1) + static_cast<size_t>(r / 2) * K + p.k0 + 16 * q);
    }
  };

  // a step's groups cw GW .. cw GW + GW - 1, by consumer warp cw
  auto compute = [&](const Pos& p) {
    const uint8_t* base = smem + p.sl * G::SLOT;
    const int g0 = p.k0 / kGS;
    const float* sgs = reinterpret_cast<const float*>(
        base + G::OFF_G + run_offset(a.sgt + static_cast<size_t>(g0) * M));
#pragma unroll
    for (int gi = 0; gi < G::GW; ++gi) {
      const int gl = cw * G::GW + gi;
      if (kGS * gl >= p.len) continue;
      uint32_t b[MH][2];  // column g of each half: plane g % 2 of activation row 4 mh + g / 2
      float sg[MH];
#pragma unroll
      for (int mh = 0; mh < MH; ++mh) {
        const int m = mh * 4 + g / 2;
        const int xr = m < M ? 2 * m + g % 2 : g % 2;  // rows past M: any staged row, unused
        const uint2 v =
            *reinterpret_cast<const uint2*>(base + G::OFF_X + xr * G::XSTR + kGS * gl + 8 * t);
        b[mh][0] = v.x;
        b[mh][1] = v.y;
        const int mt = mh * 4 + t;
        sg[mh] = mt < M ? sgs[gl * M + mt] : 0.f;
      }
      const size_t pe = static_cast<size_t>(g0 + gl) * N + p.n0;
      const uint8_t* scp = base + G::OFF_P + gl * G::PSTR + run_offset(sct + pe);
      const uint8_t* btp = base + G::OFF_P + (G::GPS + gl) * G::PSTR + run_offset(bt + pe);
#pragma unroll
      for (int ti = 0; ti < G::CT; ++ti) {
        if (ti >= p.nt) continue;
        const int r0 = ti * kTile + g;
        const uint2 a0 =
            *reinterpret_cast<const uint2*>(base + r0 * G::CSTR + kGS * gl + 8 * t);
        const uint2 a1 =
            *reinterpret_cast<const uint2*>(base + (r0 + 8) * G::CSTR + kGS * gl + 8 * t);
        int d[MH][4];
#pragma unroll
        for (int mh = 0; mh < MH; ++mh) {
          d[mh][0] = d[mh][1] = d[mh][2] = d[mh][3] = 0;
          mma_s8(d[mh], a0.x, a1.x, a0.y, a1.y, b[mh][0], b[mh][1]);
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int lr = r0 + 8 * r;
          if (lr >= p.nrows) continue;
          const float sc = bf16_at(scp + 2 * lr), bb = bf16_at(btp + 2 * lr);
#pragma unroll
          for (int mh = 0; mh < MH; ++mh) {
            if (mh * 4 + t >= M) continue;
            // D: (row, column 2 t) = c1, (row, 2 t + 1) = c2 of activation row 4 mh + t
            const float tt = __fadd_rn(__fmul_rn(static_cast<float>(d[mh][2 * r]), s1[mh]),
                                       __fmul_rn(static_cast<float>(d[mh][2 * r + 1]), s2[mh]));
            const float term = __fadd_rn(__fmul_rn(tt, sc), __fmul_rn(sg[mh], bb));
            acc[ti][r][mh] = __fadd_rn(acc[ti][r][mh], term);
          }
        }
      }
    }
  };

  // the chunk's sums, by the consumers: the warps' parts through the slot
  // just computed (which the producers refill only after every consumer
  // warp's arrival that follows this), added in warp order; in a cluster
  // (one chunk a cluster) each rank's sums go to its part, which rank 0 adds
  // after the ring
  int last_n0 = 0, last_rows = 0;
  auto finish = [&](const Pos& p) {
    float* red = reinterpret_cast<float*>(smem + p.sl * G::SLOT);
    consumer_sync(G::NC);  // every consumer warp is done reading the slot
#pragma unroll
    for (int ti = 0; ti < G::CT; ++ti)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int mh = 0; mh < MH; ++mh) {
          const int lr = ti * kTile + g + 8 * r, m = mh * 4 + t;
          if (ti < p.nt && lr < p.nrows && m < M)
            red[(cw * G::CR + lr) * G::MT + m] = acc[ti][r][mh];
          acc[ti][r][mh] = 0.f;
        }
    consumer_sync(G::NC);
    for (int i = ct; i < G::CR * G::MT; i += G::NC) {
      const int lr = i / G::MT, m = i % G::MT;
      if (lr < p.nrows && m < M) {
        float v = 0.f;
#pragma unroll
        for (int q = 0; q < G::NCW; ++q) v += red[(q * G::CR + lr) * G::MT + m];
        if (csize > 1) part[i] = v;
        else a.y[static_cast<size_t>(m) * N + p.n0 + lr] = v;
      }
    }
    last_n0 = p.n0;
    last_rows = p.nrows;
  };

  auto step = [&](const Pos& p) {
    compute(p);
    if (p.st == w.spc - 1) finish(p);
  };
  if constexpr (G::NPW > 0)
    run_ring_split<G::D>(producer, w.steps(), w.first(), [&](Pos& p) { w.advance(p); }, issue,
                         step, full, full + G::D);
  else
    run_ring<G::D>(w.steps(), w.first(), [&](Pos& p) { w.advance(p); }, issue, step);

  if (csize > 1) {  // every thread of every rank
    __syncthreads();
    cluster.sync();  // every rank's sums are in its shared memory
    if (rk == 0 && !producer) {
      for (int i = ct; i < G::CR * G::MT; i += G::NC) {
        const int lr = i / G::MT, m = i % G::MT;
        if (lr < last_rows && m < M) {
          float v = part[i];
          for (int q = 1; q < csize; ++q) v += cluster.map_shared_rank(part, q)[i];
          a.y[static_cast<size_t>(m) * N + last_n0 + lr] = v;
        }
      }
    }
    cluster.sync();  // rank 0 has read them
  }
}

template <int MH>
int launch(const GArgs& a, cudaStream_t s) {
  using G = Geo<MH>;
  auto* kern = probe_group_i8_kernel<MH>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  return launch_walk(kern, G::NT, G::SMEM, a.N, a.K, G::KS, G::CT, true, s, a);
}

}  // namespace

// x1, x2 i8 [M, K]; s12 f32 [M, 2] (s1, s2 per row); sgt f32 [G, M]; codes
// i8 [L, N, K]; sct, bt bf16 [L, G, N]; y f32 [M, N], every element written
// (the same bits on every launch).  1 <= M <= 8, K % 256 == 0; x1, x2,
// codes, sgt, sct and bt 16-byte aligned; layer selects the slice.
MGT_API int mgt_probe_group_i8(const void* x1, const void* x2, const void* s12, const void* sgt,
                               const void* codes, const void* sct, const void* bt, void* y, int M,
                               int N, int K, int layer, void* stream) {
  if (M < 1 || M > 8 || N <= 0 || K <= 0 || K % kSB || layer < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const GArgs a{static_cast<const int8_t*>(x1),    static_cast<const int8_t*>(x2),
                static_cast<const float*>(s12),    static_cast<const float*>(sgt),
                static_cast<const int8_t*>(codes), static_cast<const __nv_bfloat16*>(sct),
                static_cast<const __nv_bfloat16*>(bt), static_cast<float*>(y),
                M, N, K, layer};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return M <= 4 ? launch<1>(a, s) : launch<2>(a, s);
}
