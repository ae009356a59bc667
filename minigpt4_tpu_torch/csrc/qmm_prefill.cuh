// The quantized matmul for M > 8 activation rows, shared by the gq entries
// (gq_prefill.cu) and the repacked-weight entry (rq_matmul.cu); templated on
// the plane source P and the code source C (common.cuh).
//
// Replaces minigpt4_tpu/ops/group_i8.py:_kernel_prefill (through _run_prefill
// and its pallas_calls, both plane modes, every packing of the codes) and
// minigpt4_tpu/ops/pallas_quant_matmul.py:_kernel / _kernel_stacked for M > 8.
//
// Roundings of the TPU prefill kernels: each weight is dequantized in f32
// and rounded to bf16, bf16(f32(q) * A + B) (for a repacked weight
// bf16(scale * q - min): the offset is folded into the weight before the
// rounding, so the large scale * q and min of q5_k/q6_k never cancel in bf16),
// the activation is rounded to bf16, and the products accumulate in f32.
//
// What bounds it on the H100: at the 256- and 512-row buckets the bf16
// tensor-core rate (2 M N K operations at 989 TFLOP/s); at the 32-row image
// chunk the code stream (1 B per unpacked code, 0.5-0.75 B packed, plus the
// planes).  The kernel it replaces (64 x 64 tiles, one shared-memory stage,
// mma.sync) was bound by neither: each 64-row tile dequantized the whole
// weight again and nothing overlapped the loads, the dequantization and the
// MMAs.
//
// Design: warpgroup MMA with the weight in registers.  y^T = W x^T: a
// block's two warpgroups each own 64 weight rows (kPfBN = 128 per block) and
// issue wgmma.mma_async.m64nBTk16.f32.bf16.bf16 with the A operand (the
// dequantized weight) in registers and the B operand (BT = 64, 128 or 256
// activation rows, the token tile) in shared memory.  So each weight element
// is dequantized exactly once per token tile, a token tile holds a whole
// bucket up to 256 rows, and no dequantized tile goes through shared memory.
//
// K order.  A thread's A fragment of a k16 step holds columns 2t, 2t+1,
// 2t+8, 2t+9 (t = lane % 4) of two rows; over the four k16 steps of a 64-wide
// step that is 16 columns per row.  The kernel gives thread t the 16
// consecutive codes 16t .. 16t+15 of the step instead (one 16- or 8-byte
// read, inside one group of 16 or 32, so one (A, B) pair per row and step),
// and permutes x the same way: logical column 16s + 8h + 2t + i of a 64-wide
// step holds x's column 16t + 4s + 2h + i.  The sum over K is the same sum,
// in the order the tensor cores take it.  A pre-pass kernel
// (prefill_x_kernel) rounds x to bf16 in that order into a workspace the
// wrapper provides ([M, K64] bf16, K64 = K rounded up to 64, zero-padded).
//
// Pipeline.  A ring of ST stages (5 at the 256-row tile, 8 at the 128-row
// one, 5-6 at the 64-row one, which runs two blocks per SM: the small chunks
// are bound by each step's latency, so more warps in flight pay) holds per
// 64-wide K step the token tile of x (TMA, 128-byte swizzle, rows past M
// zero-filled), the 128 rows' code bytes (TMA, zero-filled past N and K) and
// the rows' high-bit words and plane words (4- and 8-byte cp.async, zeros
// past N and K), signalled on the stage's full mbarrier (one expect_tx from
// each warpgroup's first thread, which issues one of the two TMAs, and every
// thread's cp.async arrival).  Every thread issues its share of the loads ST
// - 2 steps ahead, once all threads have handed back the stage's previous
// step.  The block is exactly two warpgroups, so ptxas may give a thread up
// to 255 registers: a third, producer warp makes the block three warpgroups
// for the register file and caps it at 168, where the 256-row tile's 128
// accumulators spill.  Each thread reads its two rows' codes from the stage,
// builds the codes' floats by magic number (a byte or nibble or'ed into
// 2^23; no int-to-float converts), forms bf16(fma(q, A, B)) in pairs
// (cvt.rn.bf16x2.f32), issues the step's four wgmmas, waits for them and
// hands the stage back.  While one warpgroup waits, the other dequantizes,
// so the tensor cores alternate between the two.  (Dequantizing the next
// step while the warpgroup's own wgmmas still ran gave wrong, run-to-run
// different sums, even with the fragments in flight kept live.)
//
// K segments and split K.  K is cut into segments of at most kPfSegSteps
// 64-wide steps (balanced, from K alone).  A segment's sum starts from zero
// in the wgmma accumulators, and y is the segments' sums added in segment
// order.  A launch runs either one block per tile, which stores its first
// segment's sum into y and adds each later one with red.add (no load), or one
// block per (tile, segment) when the grid would leave SMs idle (splits =
// number of segments): each block writes its segment's sum to the workspace
// and the last block of a tile, found by a counter it resets, adds them in
// segment order with red.add's arithmetic (add.rn.ftz.f32).  Both give the
// same bits, and the segmentation depends on K only, so a weight's column
// halves give the whole-width launch's bits; results are deterministic.
// Ragged M and N are masked on the final store; K % 64 == 32 leaves a
// zero-filled half step.
#pragma once

#include "common.cuh"

namespace mgt {
namespace {

constexpr int kPfBN = 128;        // weight rows per block: two consumer warpgroups
constexpr int kPfBK = 64;         // K per step: one 128-byte swizzle row of bf16
constexpr int kPfThreads = 256;  // two warpgroups, each 64 weight rows
constexpr int kPfSegSteps = 32;   // steps per K segment (ops/qmm_prefill.py SEG_STEPS)
constexpr int kPfMaxStages = 8;
constexpr int kSmPerSm = 233472;  // shared memory per SM (1 KB of it reserved per block)

// D[64 x BT] (+)= A[64 x 16] B[16 x BT], bf16 x bf16 -> f32, A in registers,
// B K-major in shared memory; accumulate = 0 clears D
template <int BT>
__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[BT / 2], const uint32_t* a, uint64_t db,
                                              int accumulate);

template <>
__device__ __forceinline__ void wgmma_bf16_rs<64>(float (&d)[32], const uint32_t* a, uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_bf16_rs<128>(float (&d)[64], const uint32_t* a, uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_bf16_rs<256>(float (&d)[128], const uint32_t* a, uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// The staging of a code source: per row and 64-wide step kRowBytes code
// bytes (one TMA box of all 128 rows) and 2 high-bit copies of 4 * kHB bytes
// (each covering 32 codes, by cp.async); unpack() turns thread t4's 16 codes
// of a staged row into the bits of floats 2^23 + u (u = the code, or the
// code + 128 for signed codes), so float(bits) - kOffset is the code exactly.
template <class C>
struct StepCodes;

template <>
struct StepCodes<I8Codes> {
  static constexpr int kRowBytes = 64;
  static constexpr int kHB = 0;
  static constexpr float kOffset = 8388736.0f;  // 2^23 + 128
  // the code bytes of layer li, [N rows][K * kRowBytes / 64 bytes]
  static const void* layer_bytes(const I8Codes& c, size_t li, int N, int K) {
    return c.codes + li * N * K;
  }
  __device__ __forceinline__ static void unpack(const uint8_t* s, const uint32_t*, int t4,
                                                uint32_t (&m)[16]) {
    const uint4 v = *reinterpret_cast<const uint4*>(s + 16 * t4);
    const uint32_t w[4] = {v.x ^ 0x80808080u, v.y ^ 0x80808080u, v.z ^ 0x80808080u,
                           v.w ^ 0x80808080u};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) m[4 * i + j] = __byte_perm(w[i], 0x4B000000u, 0x7440u + j);
  }
};

template <int HB>
struct StepCodes<NibbleCodes<HB>> {
  static constexpr int kRowBytes = 32;
  static constexpr int kHB = HB;
  static constexpr float kOffset = 8388608.0f;  // 2^23
  static const void* layer_bytes(const NibbleCodes<HB>& c, size_t li, int N, int K) {
    return c.codes + li * N * (K / 2);
  }
  __device__ __forceinline__ static const uint32_t* hi_row(const NibbleCodes<HB>& c, int n,
                                                           int K) {
    return c.hi + static_cast<size_t>(n) * (K / 32 * HB);
  }
  // s: the row's 32 staged bytes; h: its 2 * HB staged high-bit words
  __device__ __forceinline__ static void unpack(const uint8_t* s, const uint32_t* h, int t4,
                                                uint32_t (&m)[16]) {
    const uint2 lo = *reinterpret_cast<const uint2*>(s + 8 * t4);
    uint32_t hb = 0;
    if constexpr (HB == 1) hb = h[t4 / 2] >> (16 * (t4 & 1));
    if constexpr (HB == 2) hb = h[t4];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      uint32_t q = ((j < 8 ? lo.x : lo.y) >> (4 * (j % 8))) & 15u;
      if constexpr (HB > 0) q |= ((hb >> (HB * j)) & ((1u << HB) - 1u)) << 4;
      m[j] = 0x4B000000u | q;
    }
  }
};

__device__ __forceinline__ float add_ftz(float a, float b) {
  float r;
  asm("add.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int B>
__device__ __forceinline__ void cp_async_small(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_u32(dst)), "l"(src),
               "n"(B), "r"(bytes)
               : "memory");
}
// arrive on bar when this thread's earlier cp.asyncs have landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// The shared-memory layout of a launch: a ring of ST stages, each a token
// tile of x (BT rows of 128 bytes), the 128 rows' code bytes and high-bit
// words and the planes' words (common.cuh: [64 / GS][128][P::kWords]); then
// the full and empty barriers and the merge flag.
template <class P, class C, int BT>
struct PrefillSmem {
  using SC = StepCodes<C>;
  static constexpr int kBlocksPerSm = BT == 64 ? 2 : 1;
  static constexpr int kGroups = kPfBK / P::kGS;  // groups per step
  static constexpr int kX = BT * 128;
  static constexpr int kCodes = kPfBN * SC::kRowBytes;
  static constexpr int kHi = kPfBN * 8 * SC::kHB;
  static constexpr int kPlanes = kGroups * kPfBN * P::kWords * 4;
  static constexpr int kStage = kX + kCodes + kHi + kPlanes;
  static constexpr int kBudget = kSmPerSm / kBlocksPerSm - 1024 - 2048;
  static constexpr int ST = kBudget / kStage < kPfMaxStages ? kBudget / kStage : kPfMaxStages;
  static constexpr int kBytes = 1024 + ST * kStage + 16 * ST + 16;
  static_assert(ST >= 3, "the ring needs three stages");
};

// x f32 [M, K] -> xb bf16 [M, K64] in the kernel's K order (see the header),
// zeros past K; one thread per (row, 64-wide step, t)
__global__ void prefill_x_kernel(const float* __restrict__ x, __nv_bfloat16* __restrict__ xb,
                                 int M, int K, int K64) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M * (K64 / 16)) return;
  const int m = i / (K64 / 16), k16 = i % (K64 / 16), t = k16 % 4;
  const int kp = 16 * k16;  // physical columns kp .. kp + 15: 16t + 64 * step
  float v[16];
#pragma unroll
  for (int j = 0; j < 16; j += 4) {
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
    if (kp < K)
      f = __ldg(reinterpret_cast<const float4*>(x + static_cast<size_t>(m) * K + kp + j));
    v[j] = f.x;
    v[j + 1] = f.y;
    v[j + 2] = f.z;
    v[j + 3] = f.w;
  }
  __nv_bfloat16* row = xb + static_cast<size_t>(m) * K64 + (kp - 16 * t);
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<__nv_bfloat162*>(row + 16 * s + 8 * h + 2 * t) =
          __floats2bfloat162_rn(v[4 * s + 2 * h], v[4 * s + 2 * h + 1]);
}

template <class P, class C, int BT>
__global__ void __launch_bounds__(kPfThreads, PrefillSmem<P, C, BT>::kBlocksPerSm)
qmm_prefill_kernel(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap cmap, C codes, P planes,
                   float* __restrict__ y, float* __restrict__ ws, int* __restrict__ cnt, int M,
                   int N, int K, int layer, int seg_len, int splits) {
  using SC = StepCodes<C>;
  using L = PrefillSmem<P, C, BT>;
  constexpr int ST = L::ST;
  constexpr int kAcc = BT / 2;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* xs = smem;                                         // [ST][BT][128 B], swizzled
  uint8_t* cs = smem + ST * L::kX;                                  // [ST][kPfBN][kRowBytes]
  uint32_t* hs = reinterpret_cast<uint32_t*>(cs + ST * L::kCodes);  // [ST][kPfBN][2 HB]
  constexpr int kPlaneWords = L::kPlanes / 4;
  // [ST][kGroups][kPfBN][P::kWords]
  uint32_t* ps = reinterpret_cast<uint32_t*>(cs + ST * (L::kCodes + L::kHi));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + ST * L::kStage);
  uint64_t* empty = full + ST;
  int* flag = reinterpret_cast<int*>(empty + ST);

  const size_t li = static_cast<size_t>(layer);
  codes.select_layer(li, N, K);
  planes.select_layer(li, N, K);
  const int m0 = blockIdx.x * BT, n0 = blockIdx.y * kPfBN;
  const int steps = (K + kPfBK - 1) / kPfBK;
  const int n_seg = (steps + seg_len - 1) / seg_len;
  // this block's segments: all of them, or the one of its split
  const int seg_lo = splits > 1 ? blockIdx.z : 0, seg_hi = splits > 1 ? seg_lo + 1 : n_seg;
  const int step0 = seg_lo * seg_len, step_end = min(seg_hi * seg_len, steps);
  const int n_it = step_end - step0;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + s, kPfThreads + 2);  // every thread's cp.asyncs and two expect_tx
      mbar_init(empty + s, kPfThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    prefetch_tensormap(&xmap);
    prefetch_tensormap(&cmap);
  }
  __syncthreads();

  // Step p of this block into stage p % ST, once every thread has handed
  // back the stage's previous step: the x tile by TMA from thread 0, the
  // code bytes by TMA from thread 128, the high-bit words and plane words by
  // cp.async (all threads).
  const auto produce = [&](int p) {
    const int s = p % ST, k0 = (step0 + p) * kPfBK;
    mbar_wait(empty + s, ((p / ST) & 1) ^ 1);
    if (tid == 0) {
      mbar_expect_tx(full + s, L::kX);
      tma_load(xs + s * L::kX, &xmap, k0, m0, full + s);
    } else if (tid == 128) {
      mbar_expect_tx(full + s, L::kCodes);
      tma_load(cs + s * L::kCodes, &cmap, k0 / (kPfBK / SC::kRowBytes), n0, full + s);
    }
    if constexpr (SC::kHB > 0) {
      constexpr int HB = SC::kHB;
      uint32_t* hst = hs + s * (L::kHi / 4);
      const uint32_t* hi0 = SC::hi_row(codes, 0, K);
      for (int c = tid; c < kPfBN * 2; c += kPfThreads) {
        const int r = c / 2, part = c % 2;
        const int n = n0 + r, k = k0 + 32 * part;
        const bool ok = n < N && k < K;
        const uint32_t* src = ok ? SC::hi_row(codes, n, K) + k / 32 * HB : hi0;
        cp_async_small<4 * HB>(hst + r * 2 * HB + part * HB, src, ok ? 4 * HB : 0);
      }
    }
    planes.stage(ps + s * kPlaneWords, step0 + p, n0, N, tid, kPfThreads);
    cp_async_arrive(full + s);
  };
  // kAhead steps in flight: a thread fills stage (it + kAhead) % ST while
  // the other warpgroup may still be one step behind on the stage before
  constexpr int kAhead = ST - 2;
  for (int p = 0; p < kAhead && p < n_it; ++p) produce(p);

  // thread (wg, warp, grp, t4) owns weight rows ra and ra + 8 and the codes
  // 16 t4 .. 16 t4 + 15 of each step (group 16 t4 / GS of the step)
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int grp = lane / 4, t4 = lane % 4;
  const int ra = 64 * wg + 16 * warp + grp;
  const int na = n0 + ra, nb = na + 8;
  const int gl = 16 * t4 / P::kGS;
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  int it = 0;
  for (int seg = seg_lo; seg < seg_hi; ++seg) {
    const int sb = seg * seg_len, se = min(sb + seg_len, steps);
    for (int step = sb; step < se; ++step, ++it) {
      const int s = it % ST;
      if (it + kAhead < n_it) produce(it + kAhead);
      mbar_wait(full + s, (it / ST) & 1);
      uint32_t ma[16], mb[16];
      const uint8_t* cst = cs + s * L::kCodes;
      const uint32_t* hst = hs + s * (L::kHi / 4);
      SC::unpack(cst + ra * SC::kRowBytes, hst + ra * 2 * SC::kHB, t4, ma);
      SC::unpack(cst + (ra + 8) * SC::kRowBytes, hst + (ra + 8) * 2 * SC::kHB, t4, mb);
      const uint32_t* pst = ps + s * kPlaneWords;
      const float2 wa = planes.staged_ab(pst, step, gl, ra, n0, N);
      const float2 wb = planes.staged_ab(pst, step, gl, ra + 8, n0, N);
      const auto w = [](uint32_t bits, float2 ab) {
        return fmaf(__uint_as_float(bits) - SC::kOffset, ab.x, ab.y);
      };
      uint32_t a[16];  // the A fragments of the four k16 steps
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        a[4 * q] = bf16x2_bits(w(ma[4 * q], wa), w(ma[4 * q + 1], wa));
        a[4 * q + 1] = bf16x2_bits(w(mb[4 * q], wb), w(mb[4 * q + 1], wb));
        a[4 * q + 2] = bf16x2_bits(w(ma[4 * q + 2], wa), w(ma[4 * q + 3], wa));
        a[4 * q + 3] = bf16x2_bits(w(mb[4 * q + 2], wb), w(mb[4 * q + 3], wb));
      }
      wgmma_fence();
      const uint64_t db = smem_desc(xs + s * L::kX);
#pragma unroll
      for (int q = 0; q < 4; ++q)  // +32 bytes along K: +2 in the address field
        wgmma_bf16_rs<BT>(acc, a + 4 * q, db + 2 * q, step > sb || q > 0);
      wgmma_commit();
      // wait in this warpgroup (the other one's dequantization overlaps),
      // then hand the stage back
      wgmma_wait_all();
      fence_fragment(acc);
      mbar_arrive(empty + s);
    }

    // y gets the segments' sums in segment order: unsplit, the first is
    // stored and the others added by red.add (no load); split, each block
    // writes its segment's sum to the workspace (fragment order, coalesced)
    // and the tile's last block adds them with red.add's arithmetic
    // (add.rn.ftz.f32), each segment's values all in flight at once
    bool add = seg > 0;
    if (splits > 1) {
      const int tile = blockIdx.y * gridDim.x + blockIdx.x;
      float* pt = ws + static_cast<size_t>(tile) * splits * kAcc * kPfThreads + tid;
#pragma unroll
      for (int idx = 0; idx < kAcc; ++idx) pt[(seg * kAcc + idx) * kPfThreads] = acc[idx];
      __threadfence();
      __syncthreads();
      if (tid == 0) {
        const int last = atomicAdd(cnt + tile, 1) == splits - 1;
        if (last) cnt[tile] = 0;  // every segment has counted in: ready for the next launch
        *flag = last;
      }
      __syncthreads();
      if (!*flag) return;
      __threadfence();
#pragma unroll
      for (int idx = 0; idx < kAcc; ++idx) acc[idx] = __ldcg(pt + idx * kPfThreads);
      for (int z = 1; z < splits; ++z) {
        const float* pz = pt + z * kAcc * kPfThreads;
#pragma unroll
        for (int idx = 0; idx < kAcc; ++idx)
          acc[idx] = add_ftz(acc[idx], __ldcg(pz + idx * kPfThreads));
      }
      add = false;
    }
    // acc[4 j + 2 h + i]: weight row (h ? nb : na), token m0 + 8 j + 2 t4 + i.
    // y and the row are opaque here, so the unrolled stores' addresses are
    // formed here and not hoisted out of the segment loop into registers
    float* yv = y;
    int mv = m0 + 2 * t4;
    asm volatile("" : "+l"(yv), "+r"(mv));
#pragma unroll
    for (int idx = 0; idx < kAcc; ++idx) {
      const int m = mv + 8 * (idx / 4) + (idx & 1);
      const int n = (idx & 2) ? nb : na;
      if (m < M && n < N) {
        float* dst = yv + static_cast<size_t>(m) * N + n;
        if (add) {
          atomicAdd(dst, acc[idx]);  // red.add
        } else {
          *dst = acc[idx];
        }
      }
    }
  }
}

// Steps per K segment for a K of `steps` 64-wide steps: segments of at most
// kPfSegSteps steps, balanced (ops/qmm_prefill.py:segments)
inline int prefill_seg_len(int steps) {
  const int n_seg = (steps + kPfSegSteps - 1) / kPfSegSteps;
  return (steps + n_seg - 1) / n_seg;
}

// What the wrapper provides beside the operands: xb bf16 [M, K64], 16-byte
// aligned; for splits > 1, ws f32 [tiles * splits * 128 * bt] and cnt i32
// [tiles], zero (the kernel leaves it zero); bt the token tile (64, 128 or
// 256); splits 1 or the number of K segments.
struct PrefillArgs {
  void* xb;
  void* ws;
  void* cnt;
  int bt;
  int splits;
};

template <class P, class C, int BT>
int launch_prefill(const void* x, const C& codes, const P& planes, void* y, int M, int N, int K,
                   int layer, const PrefillArgs& pa, int seg_len, cudaStream_t stream) {
  const int K64 = (K + kPfBK - 1) / kPfBK * kPfBK;
  const int threads = 256, items = M * (K64 / 16);
  prefill_x_kernel<<<(items + threads - 1) / threads, threads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<__nv_bfloat16*>(pa.xb), M, K, K64);
  if (const cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  CUtensorMap xmap;
  if (const int rc = make_tma_2d(&xmap, pa.xb, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, M, K64,
                                 kPfBK, BT))
    return rc;
  using SC = StepCodes<C>;
  CUtensorMap cmap;
  if (const int rc = make_tma_2d(&cmap, SC::layer_bytes(codes, layer, N, K),
                                 CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, N, K * SC::kRowBytes / kPfBK,
                                 SC::kRowBytes, kPfBN, CU_TENSOR_MAP_SWIZZLE_NONE))
    return rc;
  using L = PrefillSmem<P, C, BT>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      qmm_prefill_kernel<P, C, BT>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((M + BT - 1) / BT, (N + kPfBN - 1) / kPfBN, pa.splits);
  qmm_prefill_kernel<P, C, BT><<<grid, kPfThreads, L::kBytes, stream>>>(
      xmap, cmap, codes, planes, static_cast<float*>(y), static_cast<float*>(pa.ws),
      static_cast<int*>(pa.cnt), M, N, K, layer, seg_len, pa.splits);
  return static_cast<int>(cudaGetLastError());
}

// x f32 [M, K], y f32 [M, N]; K % 32 == 0, 16-byte aligned x.
template <class P, class C>
int qmm_prefill(const void* x, const C& codes, const P& planes, void* y, int M, int N, int K,
                int layer, const PrefillArgs& pa, void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (M <= 0 || N <= 0 || K <= 0 || K % 32 || K % P::kGS || layer < 0 || pa.xb == nullptr)
    return invalid;
  const int steps = (K + kPfBK - 1) / kPfBK, seg_len = prefill_seg_len(steps);
  const int n_seg = (steps + seg_len - 1) / seg_len;
  if (pa.splits != 1 && (pa.splits != n_seg || pa.ws == nullptr || pa.cnt == nullptr))
    return invalid;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (pa.bt) {
    case 64: return launch_prefill<P, C, 64>(x, codes, planes, y, M, N, K, layer, pa, seg_len, s);
    case 128: return launch_prefill<P, C, 128>(x, codes, planes, y, M, N, K, layer, pa, seg_len, s);
    case 256: return launch_prefill<P, C, 256>(x, codes, planes, y, M, N, K, layer, pa, seg_len, s);
    default: return invalid;
  }
}

}  // namespace
}  // namespace mgt
