// The dequantize-matvec of the unpack-chain probes (probe_qmm.cu holds the
// N-major instances and the entry, probe_qmm_km.cu the K-major ones):
// y[m, n] = sum_k x[m, k] * value(code[n, k]) * s[n, k / 32] in f32 for
// M <= 8, templated on how the codes are stored, how they are unpacked, how
// wide each lane's copies are and how the weight is laid out.
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
//   kMagic  place each code (nibbles with their high bit merged into bit 4)
//           in the mantissa of a half-precision number whose exponent makes
//           its unit 1 and subtract the bias, two codes per 32-bit word:
//           f16 1024 + code (i8 codes xor 0x80 against 1152) on the f32
//           path; on the tensor-core path bf16 128 + code against 128 (136
//           for signed nibbles), and i8 codes as their low 7 bits over 128
//           plus -256 or -128 by their top bit.  Every value is exact.
// Width (W): the bytes of codes (and high-bit planes) that one lane copies
// per instruction from device memory into the block's shared-memory ring
// (cp.async of 4 or 16 bytes); the unpack reads the ring.
// Layout: nm, w [N, K]; km, w [K, N] (dense, i8 and nibble storage; km
// nibbles pair two k of one column in a byte: byte (i, n) = q[n, 2i] |
// q[n, 2i+1] << 4).
//
// What bounds it on the H100: the bytes (2 B per weight dense, 1 i8, 0.5
// nibbles, 0.625 q5, 0.75 q5 dual, 1/16 B of scales) at 3.35 TB/s.  The
// products: 2 M N K at M = 1 on the f32 FMA units (67 TFLOP/s), and for
// M = 2..8 three times 2 M N K on the bf16 tensor cores (989 TFLOP/s), x
// being split into three bf16 parts; both sit below the bytes at the 13B
// w2 shape.  The unpack instructions come on top, which is what the probe
// measures.
//
// Design (the hopper-kernels guide, sections 1 and 4):
// * A persistent grid: one block of 16 warps (NT) per SM (its shared
//   memory allows no second), the output rows (nm) or 16-column units (km)
//   split evenly between the blocks, a block walking its rows in tiles of
//   TR (8 for the nm f32 path, else 16; the last one cut at the block's
//   end), CR rows to a chunk.
// * A ring of D slots in shared memory, each one step: the codes, planes,
//   scales and x of a chunk's rows and KS codes of K, copied by cp.async W
//   bytes a lane (x 16); D - 1 steps stay in flight across each step's one
//   barrier (the copies and schedule of probe_ring.cuh, which the integer
//   probes share).
// * Within a step the warps split K by 32-code groups (km: four group
//   slots by four tile sets); a thread (r, c) = (lane / 4, lane % 4) takes
//   8 codes of each group of its rows (nm: k = 32 j + 8 c + q; km at
//   M = 2..8: k = 32 j + c + 4 q, nibble rows 16 j + c + 4 q', so that the
//   four c read four banks; km at M = 1: lane (cq, kp) = (lane % 4,
//   lane / 4) takes columns 4 cq .. 4 cq + 3 of the k rows 32 j + kp + 8 q,
//   one 4- or 8-byte read per row).  For the high-bit storages a step walks
//   the field-local index i of all 8 fields at once (L = KS / 8 each), so
//   one plane run serves the 8 fields' code runs.
// * K-major weights: a cluster of up to 8 blocks (CMAX, as many as K has
//   steps) shares a run of 160-column chunks and splits K; each rank sums
//   its part, and rank 0 adds the ranks' sums in rank order through
//   distributed shared memory.
// * M = 1 (qmm_fma_kernel): the thread's codes unpacked to f32, 8 FMAs with
//   x per group, the group's sum scaled once.
// * M = 2..8 (qmm_tc_kernel): mma.sync m16n8k16 bf16 -> f32 with the weight
//   as A (16 output rows by 16 k) and x transposed as B (its n8 side the M
//   <= 8 rows).  The A fragment's k slots are the thread's own 8 codes of a
//   group in the order its unpack yields them (pair_order); B holds x at
//   the same k, split into three bf16 parts hi + mid + lo whose f32 sum is x
//   exactly (split3).  Six MMAs per group and 16 rows (2 k16 halves x 3
//   parts) into a zeroed partial, which is scaled once per group and row.
// * Reduction in a fixed order: at the end of a chunk each warp's sums go
//   to shared memory (the ring slot just computed) and are added over the
//   warps in warp order, so every launch gives the same bits; no atomics.
#pragma once

#include <cuda_fp16.h>

#include "probe_ring.cuh"

namespace mgt {
namespace probe {

enum Storage : int { kDense = 0, kI8 = 1, kNib = 2, kQ5 = 3, kQ5D = 4 };
enum Strategy : int { kShift = 0, kMagic = 1 };
enum Layout : int { kNM = 0, kKM = 1 };


__host__ __device__ constexpr bool has_hi(int s) { return s == kQ5 || s == kQ5D; }
__host__ __device__ constexpr int codes_per_word(int s) { return s == kDense ? 2 : s == kI8 ? 4 : 8; }
// 32-bit words holding a thread's 8 codes of a group
__host__ __device__ constexpr int words8(int s) { return s == kDense ? 4 : s == kI8 ? 2 : 1; }

// The tiling of one instance (both the kernel and its launch read it).
template <int LAY, int MT, int S>
struct Geo {
  static constexpr bool KM = LAY == kKM;
  static constexpr int F = has_hi(S) ? 8 : 1;                   // fields
  static constexpr int P = S == kQ5 ? 1 : S == kQ5D ? 2 : 0;    // plane runs per field-local index
  static constexpr int BPC2 = S == kDense ? 4 : S == kI8 ? 2 : 1;  // bytes per 2 codes
  static constexpr int NT = 512;                                // threads per block: 16 warps
  static constexpr int NW = NT / 32;
  static constexpr int TR = (MT == 8 || KM) ? 16 : 8;           // rows (nm) / columns (km) per tile
  // rows per chunk: nm 48; km 160 columns, so that each k row gives a
  // chunk 160 (i8, nibble pairs) or 320 (dense) contiguous bytes
  static constexpr int CR = KM ? 160 : 48;
  static constexpr int CT = CR / TR;                            // tiles per chunk
  // codes of K per step and row: nm 1 KB of a dense row, 512 B of i8 or
  // nibbles, 256 B for the high-bit storages (their planes come on top);
  // km 128 k rows (256 for nibbles) of the chunk's columns
  static constexpr int KS = KM ? (S == kNib ? 256 : 128) : S == kNib ? 1024 : 512;
  static constexpr int L = KS / F;        // field-local codes per step
  static constexpr int GPF = L / 32;      // groups per field and step
  // the warps: NW / WT group slots, each taking GW groups of a step, by
  // WT tile sets (km: tiles wt, wt + WT, ... of the chunk; nm: all)
  static constexpr int WT = KM ? 4 : 1;
  static constexpr int GW = KS / 32 / (NW / WT);
  static constexpr int TPW = (CT + WT - 1) / WT;  // tiles per warp
  // sums per thread and tile: M = 8 the MMA's 4; M = 1 one row (nm), or 4
  // adjacent columns (km, where a thread takes 4 columns by 8 k phases)
  static constexpr int NA = MT == 8 || KM ? 4 : 1;
  static constexpr int CMAX = KM ? 8 : 1;  // blocks of a cluster, splitting K
  // codes: nm [CR rows][F][L codes], rows padded by one group's bytes; km
  // [KS k rows (KS / 2 byte rows for nibbles)][CR columns], padded by 16 B
  // (an odd multiple of 16, so the four c of a quad read four banks)
  static constexpr int KROWS = S == kNib ? KS / 2 : KS;
  static constexpr int KRB = CR * (S == kDense ? 2 : 1);       // km bytes per k row
  static constexpr int CSTR = KM ? KRB + (KRB / 16 % 2 ? 32 : 16) : KS * BPC2 / 2 + 16 * BPC2;
  static constexpr int CBYTES = (KM ? KROWS : CR) * CSTR;
  static constexpr int PSTR = P * L + 32;                       // planes [CR rows][P][L bytes]
  static constexpr int PBYTES = P ? CR * PSTR : 0;
  static constexpr int SW = L / 64 + 2;                         // nm scale words per (row, field)
  static constexpr int SBYTES = S == kDense ? 0 : KM ? (KS / 32) * CR * 2 : CR * F * SW * 4;
  static constexpr int XSTR = KS + 4;                           // x [MT][KS] floats per step
  static constexpr int OFF_P = align16(CBYTES);
  static constexpr int OFF_S = OFF_P + align16(PBYTES);
  static constexpr int OFF_X = OFF_S + align16(SBYTES);
  static constexpr int SLOT = OFF_X + MT * XSTR * 4;
  // the group slots' sums of a chunk (in the slot just computed) and, in
  // a cluster, the block's sums (after the ring, where its rank 0 reads them)
  static constexpr int RED = NW / WT * CR * MT * 4;
  static constexpr int PART = KM ? CR * MT * 4 : 0;
  static constexpr int D = (kMaxSmem - PART) / SLOT < 5 ? (kMaxSmem - PART) / SLOT : 5;  // ring slots
  static constexpr int SMEM = D * SLOT + PART;
  static_assert(GW >= 1 && KS % (32 * NW / WT) == 0 && L % 32 == 0,
                "every warp takes whole groups of one field");
  static_assert(D >= 3 && RED <= SLOT, "a ring of three slots or more, the sums fit in one");
};

// ---------------------------------------------------------------------------
// unpacking
// ---------------------------------------------------------------------------

__device__ __forceinline__ float2 magic_f32(uint32_t bits, uint32_t bias) {
  const __half2 h = __hsub2(*reinterpret_cast<const __half2*>(&bits),
                            *reinterpret_cast<const __half2*>(&bias));
  return __half22float2(h);
}

// The codes_per_word(S) values of one 32-bit word of codes as f32, in the
// word's order.  For high-bit storage, h0 / h1 hold the high bits of codes
// 0-3 / 4-7 at bit 0 of their bytes.
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

__device__ __forceinline__ uint32_t pack_bf2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ uint32_t bf2_add(uint32_t a, uint32_t b) {
  const __nv_bfloat162 r = __hadd2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                   *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&r);
}
__device__ __forceinline__ uint32_t bf2_sub(uint32_t a, uint32_t b) {
  const __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                   *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&r);
}
// two codes + 128 (0..255) at bits 0-7 and 16-23 of p, the other bits zero:
// bf16 128 + their low 7 bits, plus -256 (top bit clear) or -128 (set)
__device__ __forceinline__ uint32_t magic_bf16_u8(uint32_t p) {
  return bf2_add((p & 0x007f007fu) | 0x43004300u, (p & 0x00800080u) ^ 0xC380C380u);
}

// Value v (pair v / 2, half v % 2) of unpack_bf16 is code pair_order(v) of
// the thread's 8.
template <int S, int STRAT>
__host__ __device__ constexpr int pair_order(int v) {
  return STRAT != kMagic || S == kDense ? v
         : S == kI8                     ? v / 4 * 4 + v % 4 / 2 + 2 * (v % 2)  // 0 2 1 3 4 6 5 7
                                        : v / 2 + 4 * (v % 2);                 // 0 4 1 5 2 6 3 7
}

// A thread's 8 codes of a group (words8(S) words, codes in word order) as
// four bf16x2 pairs in pair_order; h0 / h1 as in unpack.
template <int S, bool SIGNED, int STRAT>
__device__ __forceinline__ void unpack_bf16(const uint32_t (&w)[words8(S)], uint32_t h0,
                                            uint32_t h1, uint32_t (&a)[4]) {
  if constexpr (S == kDense) {
#pragma unroll
    for (int p = 0; p < 4; ++p) a[p] = w[p];
  } else if constexpr (S == kI8) {
    if constexpr (STRAT == kShift) {
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const uint32_t x = w[p / 2];
        const int j = 2 * (p % 2);
        a[p] = pack_bf2(static_cast<float>(static_cast<int>(x << (24 - 8 * j)) >> 24),
                        static_cast<float>(static_cast<int>(x << (16 - 8 * j)) >> 24));
      }
    } else {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const uint32_t u = w[i] ^ 0x80808080u;
        a[2 * i] = magic_bf16_u8(__byte_perm(u, 0u, 0x4240));      // codes 0, 2
        a[2 * i + 1] = magic_bf16_u8(__byte_perm(u, 0u, 0x4341));  // codes 1, 3
      }
    }
  } else {
    constexpr bool HI = has_hi(S);
    if constexpr (STRAT == kShift) {
      float v[8];
      unpack<S, SIGNED, kShift>(w[0], h0, h1, v);
#pragma unroll
      for (int p = 0; p < 4; ++p) a[p] = pack_bf2(v[2 * p], v[2 * p + 1]);
    } else {
      const uint32_t ws = SIGNED ? w[0] ^ 0x88888888u : w[0];
      const uint32_t bias = SIGNED ? 0x43084308u : 0x43004300u;  // 136 or 128
      uint32_t p01 = 0, p23 = 0;
      if constexpr (HI) {
        p01 = __byte_perm(h0, h1, 0x5410);
        p23 = __byte_perm(h0, h1, 0x7632);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t t = ((ws >> (4 * i)) & 0x000f000fu) | 0x43004300u;  // codes i and i + 4
        if constexpr (HI) {
          const uint32_t p = i < 2 ? p01 : p23;
          t |= (i % 2 == 0 ? p << 4 : p >> 4) & 0x00100010u;
        }
        a[i] = bf2_sub(t, bias);
      }
    }
  }
}

// (a, b) as three bf16x2 parts whose f32 sum is (a, b) exactly: hi = RN(x),
// mid = RN(x - hi), lo = x - hi - mid (each difference exact in f32, and lo
// holds at most 8 significant bits, so it is exact in bf16)
__device__ __forceinline__ void split3(float a, float b, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  hi = pack_bf2(a, b);
  const float ra = __fsub_rn(a, __uint_as_float(hi << 16));
  const float rb = __fsub_rn(b, __uint_as_float(hi & 0xffff0000u));
  mid = pack_bf2(ra, rb);
  lo = pack_bf2(__fsub_rn(ra, __uint_as_float(mid << 16)),
                __fsub_rn(rb, __uint_as_float(mid & 0xffff0000u)));
}

// d += A (16 x 16, row-major) B (16 x 8, col-major), bf16 in, f32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// the offset in its group of a thread's code q (of 8), thread c of a quad
template <int LAY, int S>
__device__ __forceinline__ int kpos(int c, int q) {
  if constexpr (LAY == kNM) return 8 * c + q;
  else if constexpr (S == kNib) return 2 * c + 8 * (q / 2) + q % 2;  // byte rows c + 4 q'
  else return c + 4 * q;
}

struct Args {
  const float* x;
  const uint8_t* codes;
  const uint8_t* hi;
  const uint8_t* sc;
  float* y;
  int M, N, K;
};

// ---------------------------------------------------------------------------
// the kernel body
// ---------------------------------------------------------------------------

template <int LAY, int MT, int S, bool SIGNED, int STRAT, int W>
__device__ __forceinline__ void qmm_body(const Args& a) {
  using G = Geo<LAY, MT, S>;
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, r = lane / 4, c = lane % 4;
  const int M = a.M, N = a.N, K = a.K;
  const int nb = K / G::F;
  // the cluster (km; one block in nm) shares rows, its ranks split K: rank
  // rk takes the field-local steps [sb, sb + spc) of every chunk
  int csize = 1, rk = 0;
  if constexpr (G::KM) {
    csize = static_cast<int>(cooperative_groups::this_cluster().num_blocks());
    rk = static_cast<int>(cooperative_groups::this_cluster().block_rank());
  }
  const int steps_all = (nb + G::L - 1) / G::L;
  const int sb = steps_all * rk / csize;
  const int spc = steps_all * (rk + 1) / csize - sb;  // steps per chunk, at least 1
  // the cluster's rows [b0, b1): rows (nm) or 16-column units (km) split evenly
  constexpr int U = G::KM ? 16 : 1;
  const int units = N / U, cid = blockIdx.x / csize, ncl = gridDim.x / csize;
  const int b0 = U * static_cast<int>(static_cast<long long>(units) * cid / ncl);
  const int b1 = U * static_cast<int>(static_cast<long long>(units) * (cid + 1) / ncl);
  const int ntb = (b1 - b0 + G::TR - 1) / G::TR;  // tiles, the last one cut at b1
  if (ntb <= 0) return;  // a whole cluster at once: its rows are its ranks'
  const int nch = (ntb + G::CT - 1) / G::CT;
  const int steps = nch * spc;
  constexpr int slot = G::SLOT;
  const int g32 = K / 32;
  const int gs = warp / G::WT, wt = warp % G::WT;  // the warp's group slot and tile set

  // a position in the block's steps: chunk ci (tiles [lo, hi), rows n0 ..
  // n0 + nrows) and its step st (field-local codes i0 .. i0 + len), slot
  // sl of the ring; advanced one step at a time, no division per step
  struct Pos {
    int ci, st, sl, n0, nrows, nt, i0, len;
  };
  auto set_chunk = [&](Pos& p) {
    const int lo = ntb * p.ci / nch, hi = ntb * (p.ci + 1) / nch;
    p.n0 = b0 + lo * G::TR;
    p.nrows = min((hi - lo) * G::TR, b1 - p.n0);
    p.nt = hi - lo;
  };
  auto advance = [&](Pos& p) {
    p.sl = p.sl + 1 == G::D ? 0 : p.sl + 1;
    if (++p.st == spc) {
      p.st = 0;
      if (++p.ci < nch) set_chunk(p);
    }
    p.i0 = (sb + p.st) * G::L;
    p.len = min(G::L, nb - p.i0);
  };
  // the first step (run_ring walks the next step to issue and to compute from it)
  Pos pi{0, 0, 0, 0, 0, 0, sb * G::L, min(G::L, nb - sb * G::L)};
  set_chunk(pi);

  auto issue = [&](const Pos& ps) {
    uint8_t* base = smem + ps.sl * slot;
    const int n0 = ps.n0, nrows = ps.nrows, i0 = ps.i0, len = ps.len;
    if constexpr (!G::KM) {
      constexpr int FB = G::L * G::BPC2 / 2;  // code bytes per field and step
      constexpr int CPF = FB / W;
      const size_t row_bytes = static_cast<size_t>(K) * G::BPC2 / 2;
      const int lenb = len * G::BPC2 / 2;
      for (int i = tid; i < G::CR * G::F * CPF; i += G::NT) {
        const int row = i / (G::F * CPF), f = i / CPF % G::F, q = i % CPF;
        if (row < nrows && q * W < lenb)
          cp_async<W>(base + row * G::CSTR + f * FB + q * W,
                      a.codes + static_cast<size_t>(n0 + row) * row_bytes +
                          static_cast<size_t>(f * nb + i0) * G::BPC2 / 2 + q * W);
      }
      if constexpr (G::P > 0) {
        constexpr int CPR = G::L / W;
        const size_t hb = static_cast<size_t>(nb) * G::P;  // plane bytes per row
        for (int i = tid; i < G::CR * G::P * CPR; i += G::NT) {
          const int row = i / (G::P * CPR), p = i / CPR % G::P, q = i % CPR;
          if (row < nrows && q * W < len)
            cp_async<W>(base + G::OFF_P + row * G::PSTR + p * G::L + q * W,
                        a.hi + static_cast<size_t>(n0 + row) * hb + static_cast<size_t>(p) * nb +
                            i0 + q * W);
        }
      }
      if constexpr (S != kDense) {
        // the 4-byte words holding s[n, g], s[n, g + 1] ... of each (row, field)
        const int cnt = len / 32;
        for (int i = tid; i < G::CR * G::F * G::SW; i += G::NT) {
          const int row = i / (G::F * G::SW), f = i / G::SW % G::F, wq = i % G::SW;
          if (row >= nrows) continue;
          const size_t e0 = static_cast<size_t>(n0 + row) * g32 + (f * nb + i0) / 32;
          const int par = static_cast<int>(e0 & 1);
          if (2 * wq < par + cnt)
            cp_async<4>(base + G::OFF_S + ((row * G::F + f) * G::SW + wq) * 4,
                        a.sc + (e0 - par) * 2 + 4 * wq);
        }
      }
    } else {
      constexpr int CB = S == kDense ? 2 : 1;  // bytes per column and byte row
      const int rows = S == kNib ? len / 2 : len;
      const int r0 = S == kNib ? i0 / 2 : i0;
      const int cpr = G::CR * CB / W, valid = nrows * CB;
      for (int i = tid; i < G::KROWS * cpr; i += G::NT) {
        const int kr = i / cpr, q = i % cpr;
        if (kr < rows && q * W < valid)
          cp_async<W>(base + kr * G::CSTR + q * W,
                      a.codes + (static_cast<size_t>(r0 + kr) * N + n0) * CB + q * W);
      }
      if constexpr (S != kDense) {
        constexpr int CPG = G::CR * 2 / 16;  // 16-byte copies per group row
        for (int i = tid; i < G::KS / 32 * CPG; i += G::NT) {
          const int gl = i / CPG, q = i % CPG;
          if (32 * gl < len && q * 8 < nrows)
            cp_async<16>(base + G::OFF_S + gl * G::CR * 2 + q * 16,
                         a.sc + (static_cast<size_t>(i0 / 32 + gl) * N + n0) * 2 + q * 16);
        }
      }
    }
    {
      constexpr int CX = G::L / 4;  // 16-byte copies of x per (row, field)
      for (int i = tid; i < MT * G::F * CX; i += G::NT) {
        const int m = i / (G::F * CX), f = i / CX % G::F, q = i % CX;
        if (m < M && 4 * q < len)
          cp_async<16>(base + G::OFF_X + (m * G::XSTR + f * G::L + 4 * q) * 4,
                       a.x + static_cast<size_t>(m) * K + f * nb + i0 + 4 * q);
      }
    }
  };

  // the thread's 8 codes of group (f, j) of local row (nm) or column (km) lr
  auto fetch = [&](const uint8_t* base, int lr, int f, int o, uint32_t (&w)[words8(S)]) {
    if constexpr (!G::KM) {
      const uint8_t* p = base + lr * G::CSTR + (f * G::L + o + 8 * c) * G::BPC2 / 2;
      if constexpr (S == kDense) {
        const uint4 v = *reinterpret_cast<const uint4*>(p);
        w[0] = v.x;
        w[1] = v.y;
        w[2] = v.z;
        w[3] = v.w;
      } else if constexpr (S == kI8) {
        const uint2 v = *reinterpret_cast<const uint2*>(p);
        w[0] = v.x;
        w[1] = v.y;
      } else {
        w[0] = *reinterpret_cast<const uint32_t*>(p);
      }
    } else if constexpr (S == kDense) {
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const uint8_t* q0 = base + (o + kpos<LAY, S>(c, 2 * p)) * G::CSTR + 2 * lr;
        const uint8_t* q1 = base + (o + kpos<LAY, S>(c, 2 * p + 1)) * G::CSTR + 2 * lr;
        w[p] = static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(q0)) |
               static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(q1)) << 16;
      }
    } else {
      constexpr int NB = S == kNib ? 4 : 8;  // bytes of the thread's 8 codes
#pragma unroll
      for (int i = 0; i < words8(S); ++i) {
        uint32_t v = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int q = S == kNib ? 2 * b : 4 * i + b;
          const int row = S == kNib ? (o + kpos<LAY, S>(c, q)) / 2 : o + kpos<LAY, S>(c, q);
          v |= static_cast<uint32_t>(base[row * G::CSTR + lr]) << (8 * b);
        }
        w[i] = v;
      }
      static_assert(NB == 4 * words8(S), "whole words of codes");
    }
  };
  // the high bits of those codes at bit 0 of their bytes (nm, q5 / q5d)
  auto planes = [&](const uint8_t* base, int lr, int f, int o, uint32_t& h0, uint32_t& h1) {
    if constexpr (G::P > 0) {
      const uint2 v = *reinterpret_cast<const uint2*>(
          base + G::OFF_P + lr * G::PSTR + (S == kQ5D ? f / 4 : 0) * G::L + o + 8 * c);
      const int bsh = S == kQ5 ? f : (f & 3) + 1;
      h0 = (v.x >> bsh) & 0x01010101u;
      h1 = (v.y >> bsh) & 0x01010101u;
    } else {
      h0 = h1 = 0;
    }
  };
  // x of the thread's 8 codes of a group whose x starts at xr, in code order
  auto load_x8 = [&](const float* xr, float (&xv)[8]) {
    if constexpr (!G::KM) {
      const float4 u = *reinterpret_cast<const float4*>(xr + 8 * c);
      const float4 v = *reinterpret_cast<const float4*>(xr + 8 * c + 4);
      xv[0] = u.x, xv[1] = u.y, xv[2] = u.z, xv[3] = u.w;
      xv[4] = v.x, xv[5] = v.y, xv[6] = v.z, xv[7] = v.w;
    } else {
#pragma unroll
      for (int q = 0; q < 8; ++q) xv[q] = xr[kpos<LAY, S>(c, q)];
    }
  };
  auto scale = [&](const uint8_t* base, int n0, int i0, int lr, int f, int j) -> float {
    if constexpr (S == kDense) {
      return 1.f;
    } else if constexpr (G::KM) {
      return __uint_as_float(static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(
                                 base + G::OFF_S + (j * G::CR + lr) * 2))
                             << 16);
    } else {
      const int par = ((n0 + lr) * (g32 & 1) + (f * nb + i0) / 32) & 1;
      return __uint_as_float(static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(
                                 base + G::OFF_S + (lr * G::F + f) * G::SW * 4 + 2 * (par + j)))
                             << 16);
    }
  };

  float acc[G::TPW][G::NA];  // the warp's tiles wt, wt + WT, ...
#pragma unroll
  for (int t = 0; t < G::TPW; ++t)
#pragma unroll
    for (int i = 0; i < G::NA; ++i) acc[t][i] = 0.f;

  auto compute = [&](const Pos& ps) {
    const uint8_t* base = smem + ps.sl * slot;
    const int n0 = ps.n0, nt = ps.nt, i0 = ps.i0, len = ps.len;
#pragma unroll
    for (int gi = 0; gi < G::GW; ++gi) {
      const int u = gs * G::GW + gi, f = u / G::GPF, j = u % G::GPF, o = 32 * j;
      if (o >= len) continue;
      const float* xr = reinterpret_cast<const float*>(base + G::OFF_X) + f * G::L + o;
      if constexpr (MT == 1 && G::KM) {
        // lane (cq, kp): columns 4 cq .. 4 cq + 3 of a tile, k phase kp: k
        // rows o + kp + 8 q (nibble byte rows o / 2 + kp + 8 q'), so one
        // 4- or 8-byte read takes 4 columns' codes of a k row
        const int cq = lane & 3, kp = lane >> 2;
        constexpr int NQ = S == kNib ? 2 : 4;  // (byte) rows per group
        float xv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          xv[q] = S == kNib ? xr[2 * (kp + 8 * (q / 2)) + q % 2] : xr[kp + 8 * q];
#pragma unroll
        for (int tl = 0; tl < G::TPW; ++tl) {
          const int t = wt + tl * G::WT;
          if (t >= nt) continue;
          const int col0 = t * 16 + 4 * cq;
          float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int q = 0; q < NQ; ++q) {
            const int row = (S == kNib ? o / 2 : o) + kp + 8 * q;
            if constexpr (S == kDense) {
              const uint2 wv = *reinterpret_cast<const uint2*>(base + row * G::CSTR + 2 * col0);
              float v0[2], v1[2];
              unpack<S, SIGNED, STRAT>(wv.x, 0u, 0u, v0);
              unpack<S, SIGNED, STRAT>(wv.y, 0u, 0u, v1);
              part[0] = fmaf(v0[0], xv[q], part[0]);
              part[1] = fmaf(v0[1], xv[q], part[1]);
              part[2] = fmaf(v1[0], xv[q], part[2]);
              part[3] = fmaf(v1[1], xv[q], part[3]);
            } else {
              const uint32_t wv = *reinterpret_cast<const uint32_t*>(base + row * G::CSTR + col0);
              float v[codes_per_word(S)];
              unpack<S, SIGNED, STRAT>(wv, 0u, 0u, v);
#pragma unroll
              for (int cc = 0; cc < 4; ++cc) {
                if constexpr (S == kNib) {  // byte cc: column cc at k = 2 row, 2 row + 1
                  part[cc] = fmaf(v[2 * cc], xv[2 * q], part[cc]);
                  part[cc] = fmaf(v[2 * cc + 1], xv[2 * q + 1], part[cc]);
                } else {
                  part[cc] = fmaf(v[cc], xv[q], part[cc]);
                }
              }
            }
          }
          if constexpr (S == kDense) {
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) acc[tl][cc] += part[cc];
          } else {
            const uint2 sw = *reinterpret_cast<const uint2*>(base + G::OFF_S + (j * G::CR + col0) * 2);
            const float sc4[4] = {__uint_as_float(sw.x << 16), __uint_as_float(sw.x & 0xffff0000u),
                                  __uint_as_float(sw.y << 16), __uint_as_float(sw.y & 0xffff0000u)};
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) acc[tl][cc] = fmaf(sc4[cc], part[cc], acc[tl][cc]);
          }
        }
      } else if constexpr (MT == 1) {
        float xv[8];
        load_x8(xr, xv);
#pragma unroll
        for (int tl = 0; tl < G::TPW; ++tl) {
          const int t = wt + tl * G::WT;
          if (t >= nt) continue;
#pragma unroll
          for (int i = 0; i < G::NA; ++i) {
            const int lr = t * G::TR + r + 8 * i;
            uint32_t w[words8(S)], h0, h1;
            fetch(base, lr, f, o, w);
            planes(base, lr, f, o, h0, h1);
            float part = 0.f;
#pragma unroll
            for (int wi = 0; wi < words8(S); ++wi) {
              float v[codes_per_word(S)];
              unpack<S, SIGNED, STRAT>(w[wi], h0, h1, v);
#pragma unroll
              for (int q = 0; q < codes_per_word(S); ++q)
                part = fmaf(v[q], xv[wi * codes_per_word(S) + q], part);
            }
            acc[tl][i] = S == kDense ? acc[tl][i] + part
                                     : fmaf(scale(base, n0, i0, lr, f, j), part, acc[tl][i]);
          }
        }
      } else {
        // B: x[m = r][the thread's codes in pair order], three bf16 parts
        float xv[8];
        load_x8(xr + r * G::XSTR, xv);
        uint32_t b[3][4];
#pragma unroll
        for (int p = 0; p < 4; ++p)
          split3(xv[pair_order<S, STRAT>(2 * p)], xv[pair_order<S, STRAT>(2 * p + 1)], b[0][p],
                 b[1][p], b[2][p]);
#pragma unroll
        for (int tl = 0; tl < G::TPW; ++tl) {
          const int t = wt + tl * G::WT;
          if (t >= nt) continue;
          uint32_t a0[4], a1[4];
          {
            uint32_t w[words8(S)], h0, h1;
            fetch(base, t * 16 + r, f, o, w);
            planes(base, t * 16 + r, f, o, h0, h1);
            unpack_bf16<S, SIGNED, STRAT>(w, h0, h1, a0);
            fetch(base, t * 16 + r + 8, f, o, w);
            planes(base, t * 16 + r + 8, f, o, h0, h1);
            unpack_bf16<S, SIGNED, STRAT>(w, h0, h1, a1);
          }
          float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int part = 2; part >= 0; --part)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              mma_bf16(d, a0[2 * h], a1[2 * h], a0[2 * h + 1], a1[2 * h + 1], b[part][2 * h],
                       b[part][2 * h + 1]);
          if constexpr (S == kDense) {
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[tl][i] += d[i];
          } else {
            const float s0 = scale(base, n0, i0, t * 16 + r, f, j);
            const float s1 = scale(base, n0, i0, t * 16 + r + 8, f, j);
            acc[tl][0] = fmaf(s0, d[0], acc[tl][0]);
            acc[tl][1] = fmaf(s0, d[1], acc[tl][1]);
            acc[tl][2] = fmaf(s1, d[2], acc[tl][2]);
            acc[tl][3] = fmaf(s1, d[3], acc[tl][3]);
          }
        }
      }
    }
  };

  // the chunk's sums: the warps' parts through the slot just computed (the
  // next refill of which waits for the loop's barrier), added over the
  // group slots in order; in a cluster, rank 0 then adds the ranks' sums in
  // rank order through distributed shared memory
  auto finish = [&](const Pos& ps) {
    const int n0 = ps.n0, nrows = ps.nrows;
    float* red = reinterpret_cast<float*>(smem + ps.sl * slot);
    float* part = reinterpret_cast<float*>(smem + G::D * slot);  // the same place in every rank
    __syncthreads();  // every warp is done reading the slot
#pragma unroll
    for (int tl = 0; tl < G::TPW; ++tl) {
      const int t = wt + tl * G::WT;
      if (t < G::CT) {
        if constexpr (MT == 1 && G::KM) {  // the 8 k phases: lanes cq + 4 kp
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float v = acc[tl][i];
            v += __shfl_xor_sync(kFullMask, v, 4);
            v += __shfl_xor_sync(kFullMask, v, 8);
            v += __shfl_xor_sync(kFullMask, v, 16);
            if (lane < 4) red[gs * G::CR + t * 16 + 4 * lane + i] = v;
          }
        } else if constexpr (MT == 1) {
#pragma unroll
          for (int i = 0; i < G::NA; ++i) {
            float v = acc[tl][i];
            v += __shfl_xor_sync(kFullMask, v, 1);
            v += __shfl_xor_sync(kFullMask, v, 2);
            if (c == 0) red[gs * G::CR + t * G::TR + r + 8 * i] = v;
          }
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            red[(gs * G::CR + t * 16 + r + 8 * (i / 2)) * 8 + 2 * c + i % 2] = acc[tl][i];
        }
      }
#pragma unroll
      for (int i = 0; i < G::NA; ++i) acc[tl][i] = 0.f;
    }
    __syncthreads();
    for (int i = tid; i < G::CR * MT; i += G::NT) {
      const int lr = i / MT, m = i % MT;
      if (lr < nrows && m < M) {
        float v = 0.f;
#pragma unroll
        for (int g = 0; g < G::NW / G::WT; ++g) v += red[(g * G::CR + lr) * MT + m];
        if (G::KM && csize > 1) part[i] = v;
        else a.y[static_cast<size_t>(m) * N + n0 + lr] = v;
      }
    }
    if constexpr (G::KM) {
      if (csize > 1) {
        auto cluster = cooperative_groups::this_cluster();
        cluster.sync();  // every rank's sums are in its shared memory
        if (rk == 0) {
          for (int i = tid; i < G::CR * MT; i += G::NT) {
            const int lr = i / MT, m = i % MT;
            if (lr < nrows && m < M) {
              float v = part[i];
              for (int q = 1; q < csize; ++q) v += cluster.map_shared_rank(part, q)[i];
              a.y[static_cast<size_t>(m) * N + n0 + lr] = v;
            }
          }
        }
        cluster.sync();  // rank 0 has read them; the slots may be refilled
      }
    }
  };

  run_ring<G::D>(steps, pi, advance, issue, [&](const Pos& ps) {
    compute(ps);
    if (ps.st == spc - 1) finish(ps);
  });
}

// the M = 1 instances (f32 FMAs) and the M = 2..8 ones (tensor cores)
template <int LAY, int S, bool SIGNED, int STRAT, int W>
__global__ void __launch_bounds__(Geo<LAY, 1, S>::NT, 1)
    qmm_fma_kernel(const Args a) {
  qmm_body<LAY, 1, S, SIGNED, STRAT, W>(a);
}
template <int LAY, int S, bool SIGNED, int STRAT, int W>
__global__ void __launch_bounds__(Geo<LAY, 8, S>::NT, 1)
    qmm_tc_kernel(const Args a) {
  qmm_body<LAY, 8, S, SIGNED, STRAT, W>(a);
}

template <int LAY, int MT, int S, bool SIGNED, int STRAT, int W>
int launch_one(const Args& a, cudaStream_t stream) {
  using G = Geo<LAY, MT, S>;
  auto* kern = [] {
    if constexpr (MT == 1) return qmm_fma_kernel<LAY, S, SIGNED, STRAT, W>;
    else return qmm_tc_kernel<LAY, S, SIGNED, STRAT, W>;
  }();
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute cl[1];
  cfg.blockDim = dim3(G::NT);
  cfg.dynamicSmemBytes = G::SMEM;
  cfg.stream = stream;
  int grid = std::min((a.N + G::TR - 1) / G::TR, device_sms());
  if constexpr (G::KM) {
    // clusters of up to CMAX blocks (no more than K has steps), as many as
    // fit at once, each on its own run of 16-column units
    const int steps_all = (a.K + G::L - 1) / G::L;
    const int csize = std::min(G::CMAX, steps_all);
    cl[0].id = cudaLaunchAttributeClusterDimension;
    cl[0].val.clusterDim.x = csize;
    cl[0].val.clusterDim.y = 1;
    cl[0].val.clusterDim.z = 1;
    cfg.attrs = cl;
    cfg.numAttrs = 1;
    cfg.gridDim = dim3(csize);
    int fit = 0;
    const cudaError_t e = cudaOccupancyMaxActiveClusters(&fit, kern, &cfg);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (fit < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    grid = csize * std::min(fit, a.N / 16);
  }
  cfg.gridDim = dim3(grid);
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, a);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

template <int LAY, int S, bool SIGNED, int STRAT>
int by_width(int width, const Args& a, cudaStream_t s) {
  if (width == 4)
    return a.M == 1 ? launch_one<LAY, 1, S, SIGNED, STRAT, 4>(a, s)
                    : launch_one<LAY, 8, S, SIGNED, STRAT, 4>(a, s);
  if (width == 16)
    return a.M == 1 ? launch_one<LAY, 1, S, SIGNED, STRAT, 16>(a, s)
                    : launch_one<LAY, 8, S, SIGNED, STRAT, 16>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int LAY, int S, bool SIGNED>
int by_strategy(int strategy, int width, const Args& a, cudaStream_t s) {
  if (strategy == kShift) return by_width<LAY, S, SIGNED, kShift>(width, a, s);
  if constexpr (S != kDense) {  // dense weights need no unpack: shift only
    if (strategy == kMagic) return by_width<LAY, S, SIGNED, kMagic>(width, a, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int launch_km(const Args& a, int storage, bool is_signed, int strategy, int width,
              cudaStream_t stream);

}  // namespace probe
}  // namespace mgt
