// probe_int: integer dot products with i8 and int4 operands, the questions
// of tools/probe_int4.py, on the s8 tensor cores.
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
// weight for i8, 0.5 B for s4).  The card has no int4 tensor-core
// instruction: ptxas (CUDA 12.9) takes mma.sync ... m16n8k64 .s4.s4 for
// sm_90a but lowers each to two IMMA.16832.S8.S8 after its own unpack
// (this kernel's first form read that from its SASS).  So every mode
// runs IMMA.16832.S8.S8 (mma.sync m16n8k32 s8) on codes it unpacks itself:
// 2 16 8 32 operations an MMA, padding included, at 1979 TOP/s, ~1-2 us at
// the 13824 x 5120 shape against 10.6 us (s4) or 21.1 us (i8) of bytes.
//
// Design (that of probe_group_i8.cu, on probe_ring.cuh's ring and walk):
// * A persistent grid of one block per SM, 4 producer warps that copy and 8
//   consumer warps that compute (full / empty mbarriers a ring slot), the
//   output rows split evenly and walked in chunks of 4 tiles of 16 rows (2
//   at M = 9..16).  In the integer modes a cluster of up to 8 blocks splits
//   K where N has fewer tiles than the card has SMs (exact i32 sums, added
//   by rank 0 in rank order); s4_sb keeps K whole in a block, as its chunk
//   order asks.
// * A ring of 4-5 slots, each one step of 512 weight bytes a row (512 i8
//   codes, 1024 s4 codes): the chunk's rows, the step's x (and in s4_sb
//   each row's chunk scales), copied by cp.async 16 bytes a lane.
// * Consumer warp w takes the step's 32-code groups 2 w, 2 w + 1 (i8) or 4
//   w .. 4 w + 3 (s4), for every tile of the chunk.  A = 16 rows of w by a
//   group, B = x transposed (column m = activation row m; at M = 9..16 two
//   n8 halves).  Lane t's k slots are its own 8 codes of the group: 8
//   contiguous i8 bytes, or one 32-bit word of nibbles split into the even
//   codes (A register 0) and the odd ones (register 2) as 16 times their
//   value (s4_to_s8x16, two operations; the sums are shifted back exactly);
//   B takes x in the same order (i8 x byte-permuted by __byte_perm, s4 x
//   sign-extended by s4_to_s8).
// * i8xi8 and s4xs4 accumulate each lane's D over the chunk's steps; at the
//   chunk's end the warps' sums go through shared memory and are added in
//   warp order (exact).  s4_sb: each warp's step holds half a 256-chunk's
//   part; the parts go through shared memory (two buffers, by the step's
//   parity, so one barrier a step) and one pass, a thread per (row,
//   activation row), adds each chunk's exact i32, scales it and adds it to
//   its f32 sum in chunk order, product and sum rounded apart, as the plain
//   version does.  It has an instance for M <= 4, whose smaller parts and x
//   leave room for a fifth slot.  No atomics anywhere.
#include "probe_ring.cuh"

namespace {

using namespace mgt;
using namespace mgt::probe;

enum Mode : int { kI8xI8 = 0, kS4xS4 = 1, kS4SB = 2 };
constexpr int kChunk = 256;  // the s4_sb scale chunk; K % kChunk == 0

struct IArgs {
  const uint8_t* x;
  const uint8_t* w;
  const float* scales;
  void* y;
  int M, N, K;
};

// the tiling of one mode and activation-row tile MT (ops/probes.ring_geometry mirrors it)
template <int MODE, int MT>
struct Geo {
  static constexpr bool S4W = MODE != kI8xI8, S4X = MODE == kS4xS4;
  static constexpr int NPW = 4, NCW = 8;                // producer, consumer warps
  static constexpr int NT = 32 * (NPW + NCW), NC = 32 * NCW, MH = (MT + 7) / 8;
  static constexpr int CR = MT == 16 ? 32 : 64, CT = CR / kTile;  // rows, tiles per chunk
  static constexpr int RB = 512;                                  // weight bytes per row and step
  static constexpr int KS = S4W ? 2 * RB : RB;                    // codes of K per step
  static constexpr int GW = KS / 32 / NCW;                        // groups per consumer warp and step
  // padding so a quad's reads of rows g .. g + 3 (8 bytes) or g .. g + 7 (4
  // bytes) fall on separate banks
  static constexpr int CSTR = RB + (S4W ? 16 : 32);
  static constexpr int XB = S4X ? KS / 2 : KS;  // x bytes per row and step
  static constexpr int XSTR = XB + (S4X ? 16 : 32);
  static constexpr int CPS = KS / kChunk;       // scale chunks per step
  static constexpr int SSTR = 16 * run_pieces(CPS * 4);
  static constexpr int PPT = (CR * MT + NC - 1) / NC;  // s4_sb: (row, activation row) sums a thread
  static constexpr int OFF_X = CR * CSTR;
  static constexpr int OFF_S = OFF_X + MT * XSTR;
  static constexpr int SLOT = OFF_S + (MODE == kS4SB ? CR * SSTR : 0);
  // the consumer warps' i32 parts, after the ring: s4_sb's of a step, in two
  // buffers by the step's parity; the others' of a chunk
  static constexpr int RED = (MODE == kS4SB ? 2 : 1) * NCW * CR * MT * 4;
  static constexpr int PART = CR * MT * 4;       // a cluster rank's sums
  static constexpr int FREE = kMaxSmem - RED - PART - 16 * 5;
  static constexpr int D = FREE / SLOT < 5 ? FREE / SLOT : 5;  // ring slots
  static constexpr int OFF_BAR = D * SLOT + RED + PART;       // D full, D empty mbarriers
  static constexpr int SMEM = OFF_BAR + 16 * D;
  static_assert(GW >= 1 && KS % (32 * NCW) == 0, "whole groups a consumer warp");
  static_assert(MODE != kS4SB || (kChunk / 32) % GW == 0, "a warp's groups in one chunk");
  static_assert(D >= 3 && SLOT % 16 == 0, "a ring of three slots or more");
};

// 8 int4 codes of a word (code j in nibble j) -> the even codes (0, 2, 4,
// 6) and the odd ones as sign-extended bytes: per byte n ^ 8 in 0..15, plus
// 0x78 (no carry out of the byte), top bit flipped = n - 16 [n >= 8]
// (ops/probes.s4_to_s8 mirrors it)
__device__ __forceinline__ void s4_to_s8(uint32_t w, uint32_t& even, uint32_t& odd) {
  even = (((w & 0x0f0f0f0fu) ^ 0x08080808u) + 0x78787878u) ^ 0x80808080u;
  odd = ((((w >> 4) & 0x0f0f0f0fu) ^ 0x08080808u) + 0x78787878u) ^ 0x80808080u;
}
// the same codes as 16 x their value: each nibble moved to the top half of
// its byte, which read as s8 is 16 times the code (two operations, where
// s4_to_s8 takes seven); the MMA's sums are then 16 times the dot product,
// exact while they stay below 2^31 (ops/probes.s4_to_s8x16 mirrors it)
__device__ __forceinline__ void s4_to_s8x16(uint32_t w, uint32_t& even, uint32_t& odd) {
  even = (w << 4) & 0xf0f0f0f0u;
  odd = w & 0xf0f0f0f0u;
}

template <int MODE, int MT>
__global__ void __launch_bounds__(384, 1) int_dot_kernel(const IArgs a) {
  using G = Geo<MODE, MT>;
  static_assert(G::NT == 384, "the launch bounds' block");
  constexpr int MH = G::MH;
  constexpr int SH = G::S4W ? 4 : 0;  // the s4 weight codes enter the MMA as 16 x their value
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const bool producer = warp < G::NPW;
  const int cw = warp - G::NPW, ct = tid - 32 * G::NPW;  // consumer warp, thread
  const int M = a.M, N = a.N, K = a.K, nchunks = K / kChunk;
  const size_t wrow = G::S4W ? K / 2 : K, xrow = G::S4X ? K / 2 : K;  // bytes per row
  auto cluster = cooperative_groups::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rk = static_cast<int>(cluster.block_rank());
  const Walk<G::KS, G::CT, G::D> w(N, K, csize, rk, blockIdx.x / csize, gridDim.x / csize);
  if (w.ntb <= 0) return;  // a whole cluster at once
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + G::OFF_BAR);
  if (tid == 0) init_ring_barriers(full, full + G::D, G::D, 32 * G::NPW, G::NCW);
  __syncthreads();

  int* red = reinterpret_cast<int*>(smem + G::D * G::SLOT);
  int* part = red + G::RED / 4;  // the same place in every rank
  int acc[G::CT][MH][4];         // i8xi8, s4xs4: the lane's D over the chunk
#pragma unroll
  for (int ti = 0; ti < G::CT; ++ti)
#pragma unroll
    for (int mh = 0; mh < MH; ++mh)
      acc[ti][mh][0] = acc[ti][mh][1] = acc[ti][mh][2] = acc[ti][mh][3] = 0;
  float pacc[G::PPT];  // s4_sb: this thread's (row, activation row) sums i = ct + NC j, in chunk order
#pragma unroll
  for (int j = 0; j < G::PPT; ++j) pacc[j] = 0.f;
  int par = 0;  // s4_sb: the parity of the step, which picks its buffer of parts

  // a step's copies, by the producer threads
  auto issue = [&](const Pos& p) {
    constexpr int NP = 32 * G::NPW;
    uint8_t* base = smem + p.sl * G::SLOT;
    constexpr int CP = G::RB / 16;
    const int lenb = G::S4W ? p.len / 2 : p.len;
    const size_t kb = G::S4W ? p.k0 / 2 : p.k0;
    for (int i = tid; i < p.nrows * CP; i += NP) {
      const int row = i / CP, q = i % CP;
      if (16 * q < lenb)
        cp_async<16>(base + row * G::CSTR + 16 * q,
                     a.w + static_cast<size_t>(p.n0 + row) * wrow + kb + 16 * q);
    }
    constexpr int XP = G::XB / 16;
    const int xlen = G::S4X ? p.len / 2 : p.len;
    const size_t xk = G::S4X ? p.k0 / 2 : p.k0;
    for (int i = tid; i < M * XP; i += NP) {
      const int m = i / XP, q = i % XP;
      if (16 * q < xlen)
        cp_async<16>(base + G::OFF_X + m * G::XSTR + 16 * q,
                     a.x + static_cast<size_t>(m) * xrow + xk + 16 * q);
    }
    if constexpr (MODE == kS4SB) {
      constexpr int SP = G::SSTR / 16;
      for (int i = tid; i < p.nrows * SP; i += NP) {
        const int row = i / SP, q = i % SP;
        cp_async_piece(base + G::OFF_S + row * G::SSTR,
                       a.scales + static_cast<size_t>(p.n0 + row) * nchunks + p.k0 / kChunk,
                       p.len / kChunk * 4, q);
      }
    }
  };

  // a step's groups cw GW .. cw GW + GW - 1, by consumer warp cw
  auto compute = [&](const Pos& p) {
    const uint8_t* base = smem + p.sl * G::SLOT;
    int dp[G::CT][4];  // s4_sb: the warp's part of its chunk in this step
#pragma unroll
    for (int ti = 0; ti < G::CT; ++ti) dp[ti][0] = dp[ti][1] = dp[ti][2] = dp[ti][3] = 0;
#pragma unroll
    for (int gi = 0; gi < G::GW; ++gi) {
      const int gl = cw * G::GW + gi;
      if (32 * gl >= p.len) continue;
      uint32_t b[MH][2];  // column g of each half: activation row 8 mh + g
#pragma unroll
      for (int mh = 0; mh < MH; ++mh) {
        const int m = mh * 8 + g;
        const uint8_t* xr = base + G::OFF_X + (m < M ? m : 0) * G::XSTR;  // past M: unused
        if constexpr (G::S4X) {
          s4_to_s8(*reinterpret_cast<const uint32_t*>(xr + 16 * gl + 4 * t), b[mh][0], b[mh][1]);
        } else {
          const uint2 v = *reinterpret_cast<const uint2*>(xr + 32 * gl + 8 * t);
          b[mh][0] = G::S4W ? __byte_perm(v.x, v.y, 0x6420) : v.x;  // codes 0, 2, 4, 6
          b[mh][1] = G::S4W ? __byte_perm(v.x, v.y, 0x7531) : v.y;  // 1, 3, 5, 7
        }
      }
#pragma unroll
      for (int ti = 0; ti < G::CT; ++ti) {
        if (ti >= p.nt) continue;
        const int r0 = ti * kTile + g;
        uint32_t a0, a1, a2, a3;
        if constexpr (G::S4W) {
          s4_to_s8x16(*reinterpret_cast<const uint32_t*>(base + r0 * G::CSTR + 16 * gl + 4 * t),
                      a0, a2);
          s4_to_s8x16(
              *reinterpret_cast<const uint32_t*>(base + (r0 + 8) * G::CSTR + 16 * gl + 4 * t), a1,
              a3);
        } else {
          const uint2 v0 = *reinterpret_cast<const uint2*>(base + r0 * G::CSTR + 32 * gl + 8 * t);
          const uint2 v1 =
              *reinterpret_cast<const uint2*>(base + (r0 + 8) * G::CSTR + 32 * gl + 8 * t);
          a0 = v0.x, a2 = v0.y, a1 = v1.x, a3 = v1.y;
        }
#pragma unroll
        for (int mh = 0; mh < MH; ++mh) {
          if constexpr (MODE == kS4SB) mma_s8(dp[ti], a0, a1, a2, a3, b[mh][0], b[mh][1]);
          else mma_s8(acc[ti][mh], a0, a1, a2, a3, b[mh][0], b[mh][1]);
        }
      }
    }
    if constexpr (MODE == kS4SB) {
      // D: rows g, g + 8 at activation rows 2 t, 2 t + 1; a warp writing the
      // next step's parts into the other buffer waits for no one, and one
      // writing the step after that has passed the next step's barrier, which
      // every warp reaches only after this step's pass
      int* rd = red + par * (G::NCW * G::CR * MT);
      par ^= 1;
#pragma unroll
      for (int ti = 0; ti < G::CT; ++ti)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int lr = ti * kTile + g + 8 * (i / 2), m = 2 * t + i % 2;
          if (ti < p.nt && lr < p.nrows && m < M && 32 * cw * G::GW < p.len)
            rd[(cw * G::CR + lr) * MT + m] = dp[ti][i] >> SH;
        }
      consumer_sync(G::NC);  // every consumer warp's part of the step is in rd
      constexpr int WPC = kChunk / 32 / G::GW;  // warps of a chunk
#pragma unroll
      for (int j = 0; j < G::PPT; ++j) {
        const int i = ct + G::NC * j, plr = i / MT, pm = i % MT;
        if (plr >= p.nrows || pm >= M) continue;
        const float* sc = reinterpret_cast<const float*>(
            base + G::OFF_S + plr * G::SSTR +
            run_offset(a.scales + static_cast<size_t>(p.n0 + plr) * nchunks + p.k0 / kChunk));
#pragma unroll
        for (int c = 0; c < G::CPS; ++c) {
          if (kChunk * c >= p.len) continue;
          int s = 0;
#pragma unroll
          for (int q = 0; q < WPC; ++q) s += rd[((c * WPC + q) * G::CR + plr) * MT + pm];
          pacc[j] = __fadd_rn(pacc[j], __fmul_rn(static_cast<float>(s), sc[c]));
        }
      }
    }
  };

  // the chunk's sums, by the consumers
  int last_n0 = 0, last_rows = 0;
  auto finish = [&](const Pos& p) {
    if constexpr (MODE == kS4SB) {
#pragma unroll
      for (int j = 0; j < G::PPT; ++j) {
        const int i = ct + G::NC * j, plr = i / MT, pm = i % MT;
        if (plr < p.nrows && pm < M)
          static_cast<float*>(a.y)[static_cast<size_t>(pm) * N + p.n0 + plr] = pacc[j];
        pacc[j] = 0.f;
      }
    } else {
      // the warps' sums through shared memory, added in warp order; in a
      // cluster (one chunk a cluster) each rank's sums go to its part, which
      // rank 0 adds after the ring
#pragma unroll
      for (int ti = 0; ti < G::CT; ++ti)
#pragma unroll
        for (int mh = 0; mh < MH; ++mh)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int lr = ti * kTile + g + 8 * (i / 2), m = mh * 8 + 2 * t + i % 2;
            if (ti < p.nt && lr < p.nrows && m < M)
              red[(cw * G::CR + lr) * MT + m] = acc[ti][mh][i] >> SH;
            acc[ti][mh][i] = 0;
          }
      consumer_sync(G::NC);
      for (int i = ct; i < G::CR * MT; i += G::NC) {
        const int lr = i / MT, m = i % MT;
        if (lr < p.nrows && m < M) {
          int v = 0;
#pragma unroll
          for (int q = 0; q < G::NCW; ++q) v += red[(q * G::CR + lr) * MT + m];
          if (csize > 1) part[i] = v;
          else static_cast<int*>(a.y)[static_cast<size_t>(m) * N + p.n0 + lr] = v;
        }
      }
      consumer_sync(G::NC);  // red is read before any warp writes the next chunk's sums
      last_n0 = p.n0;
      last_rows = p.nrows;
    }
  };

  run_ring_split<G::D>(
      producer, w.steps(), w.first(), [&](Pos& p) { w.advance(p); }, issue,
      [&](const Pos& p) {
        compute(p);
        if (p.st == w.spc - 1) finish(p);
      },
      full, full + G::D);

  if (csize > 1) {  // the integer modes only; every thread of every rank
    __syncthreads();
    cluster.sync();  // every rank's sums are in its shared memory
    if (rk == 0 && !producer) {
      for (int i = ct; i < G::CR * MT; i += G::NC) {
        const int lr = i / MT, m = i % MT;
        if (lr < last_rows && m < M) {
          int v = part[i];
          for (int q = 1; q < csize; ++q) v += cluster.map_shared_rank(part, q)[i];
          static_cast<int*>(a.y)[static_cast<size_t>(m) * N + last_n0 + lr] = v;
        }
      }
    }
    cluster.sync();  // rank 0 has read them
  }
}

template <int MODE, int MT>
int launch(const IArgs& a, cudaStream_t s) {
  using G = Geo<MODE, MT>;
  auto* kern = int_dot_kernel<MODE, MT>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  return launch_walk(kern, G::NT, G::SMEM, a.N, a.K, G::KS, G::CT, MODE != kS4SB, s, a);
}

}  // namespace

// x: i8 [M, K] (modes 0, 2) or s4 nibbles [M, K/2] (mode 1); w: i8 [N, K]
// (mode 0) or s4 nibbles [N, K/2]; scales f32 [N, K/256] (mode 2, else
// unused); y: i32 [M, N] (modes 0, 1) or f32, every element written.
// K % 256 == 0 (and below 2^21 in mode 1); 1 <= M <= 8 (modes 0, 2) or 16
// (mode 1); 16-byte aligned operands.
MGT_API int mgt_probe_int_dot(const void* x, const void* w, const void* scales, void* y, int mode,
                              int M, int N, int K, void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (N <= 0 || K <= 0 || K % kChunk || M < 1) return invalid;
  const IArgs a{static_cast<const uint8_t*>(x), static_cast<const uint8_t*>(w),
                static_cast<const float*>(scales), y, M, N, K};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kI8xI8: return M <= 8 ? launch<kI8xI8, 8>(a, s) : invalid;
    case kS4xS4:  // 16 x the sums below 2^31: |x w| <= 64 a product
      if (M > 16 || K >= (1 << 21)) return invalid;
      return M <= 8 ? launch<kS4xS4, 8>(a, s) : launch<kS4xS4, 16>(a, s);
    case kS4SB:
      if (M > 8 || scales == nullptr) return invalid;
      return M <= 4 ? launch<kS4SB, 4>(a, s) : launch<kS4SB, 8>(a, s);
    default: return invalid;
  }
}
