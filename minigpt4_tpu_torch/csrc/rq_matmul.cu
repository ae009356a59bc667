// rq_matmul: the fused dequantize-matmul over repacked quantized weights.
//
// Replaces minigpt4_tpu/ops/pallas_quant_matmul.py:_kernel (a static layer
// index or an unstacked weight) and _kernel_stacked (a traced layer index by
// scalar prefetch), reached through _run and qmatmul_repacked: every
// quantized ViT-G / Q-Former weight of a quantized container, and the
// decoder's weights in quant_mode "repack" or where gq refuses them.  Both
// TPU kernels compute
//
//   y = (scale * q) @ x - groupsum(x) @ mins
//
// over the planes of ops/repack.py; here the layer index is one argument
// and selects the [L, ...] slice by pointer offset, so one entry covers
// both.  Entry mgt_rq_decode (M <= 8) is rq_decode.cuh's kernel, x kept in
// f32 and w = scale * q - min formed per code in f32 by one FMA, the plain
// version's weight bit for bit; entry mgt_rq_prefill (M > 8) is
// qmm_prefill.cuh's, which forms the same w and rounds it to bf16 for the
// tensor cores, so the large scale * q and min of q5_k (min ~ 16 scale) and
// q6_k (min = 32 scale) cancel before any rounding.
//
// The storage is the port's own (ops/repack.py), K in its natural order:
//   codes  u8 [L, N, K/2] nibble pairs along K, byte (n, j) = q[n, 2j] |
//          q[n, 2j+1] << 4 (4-bit formats), or i8 [L, N, K] (q8_0);
//   hi     the high code bits packed along K in 32-bit words: [L, N, K/32]
//          for q5_* (bit b of word w is bit 4 of q[n, 32 w + b]) or
//          [L, N, K/16] for q6_k (bits 2b+1:2b of word w are bits 5:4 of
//          q[n, 16 w + b]);
//   scales, mins  bf16 [L, N, K/gs], w = scale * q - min.
// So a 32-code unit is one 16-byte load of nibbles and one or two high-bit
// words.
//
// What bounds it on the H100.  The decode entry: at M = 1 the weight stream
// (0.5 B per weight of nibbles, + 0.125 of q5 bits or 0.25 of q6 bits, +
// 4/gs B of planes: 0.75 B per q5_k weight, 1.0 per q6_k weight; q8_0
// 1.125); at M = 8 the f32 FMA rate (M + 1 FMAs per code, 2 M N K at 67
// TFLOP/s in the bound), which the unpack (about 3.5 operations per code,
// no int-to-float convert) shares; rq_decode.cuh says how its design keeps
// the loads in flight and stages x once per block.  The prefill entry: at
// the 32-row image chunk the weight stream; at the 257-row ViT chunk and
// the 512-row bucket the bf16 tensor-core rate.
#include <type_traits>

#include "qmm_prefill.cuh"
#include "rq_decode.cuh"

namespace {

using mgt::NibbleCodes;

// Planes of a repacked weight: bf16 scales and mins [L, N, G], G = K / GS,
// stored row-major per output row; A = scale, B = -min.
template <int GS>
struct RowPlanes {
  static constexpr int kGS = GS;
  const __nv_bfloat16* scales;
  const __nv_bfloat16* mins;
  int G;

  __device__ __forceinline__ void select_layer(size_t li, int N, int K) {
    scales += li * N * G;
    mins += li * N * G;
  }
  // the decode kernel's planes of the 32-code unit u of row n: the bf16 bits
  // of the scales in .x and of the mins in .y, one group in the low half
  // (GS 32) or two (GS 16; G is even, so the pair is 4-byte aligned)
  __device__ __forceinline__ uint2 unit_bits(int n, int u) const {
    const size_t gi = static_cast<size_t>(n) * G + u * (32 / GS);
    if constexpr (GS == 32)
      return make_uint2(__ldg(reinterpret_cast<const unsigned short*>(scales + gi)),
                        __ldg(reinterpret_cast<const unsigned short*>(mins + gi)));
    return make_uint2(__ldg(reinterpret_cast<const unsigned int*>(scales + gi)),
                      __ldg(reinterpret_cast<const unsigned int*>(mins + gi)));
  }
  static constexpr int kWords = 2;
  // a K tail (K % 64 == 32) leaves the step's last groups past K: zeros
  __device__ __forceinline__ void stage(uint32_t* dst, int step, int n0, int N, int tid,
                                        int nth) const {
    for (int c = tid; c < 64 / GS * 128; c += nth) {
      const int g = step * (64 / GS) + c / 128, n = n0 + c % 128;
      const bool ok = n < N && g < G;
      const size_t gi = ok ? static_cast<size_t>(n) * G + g : 0;
      mgt::cp_async_word(dst + 2 * c, scales + gi, ok);
      mgt::cp_async_word(dst + 2 * c + 1, mins + gi, ok);
    }
  }
  __device__ __forceinline__ float2 staged_ab(const uint32_t* st, int step, int gl, int r, int n0,
                                              int N) const {
    const uint32_t* w = st + 2 * (gl * 128 + r);
    const size_t gi = static_cast<size_t>(n0 + r) * G + step * (64 / GS) + gl;
    return make_float2(mgt::bf16_word_half(w[0], scales + gi),
                       -mgt::bf16_word_half(w[1], mins + gi));
  }
};

// pre: the prefill kernel's workspace (mgt_rq_prefill), null for the decode kernel
template <int GS, class C>
int run(const mgt::PrefillArgs* pre, const void* x, const C& codes, const void* scales,
        const void* mins, void* y, int M, int N, int K, int layer, void* stream) {
  const RowPlanes<GS> planes{static_cast<const __nv_bfloat16*>(scales),
                             static_cast<const __nv_bfloat16*>(mins), K / GS};
  return pre ? mgt::qmm_prefill(x, codes, planes, y, M, N, K, layer, *pre, stream)
             : mgt::rq_decode(x, codes, planes, y, M, N, K, layer, stream);
}

// The layouts of ops/repack.py's _LAYOUT: q8_0 (8, 0, 32); q4_0, q4_1, q4_k
// (4, 0, 32); q2_k, q3_k (4, 0, 16); q5_0, q5_1, q5_k (4, 1, 32); q6_k (4, 2, 16).
int dispatch(const mgt::PrefillArgs* pre, const void* x, const void* codes, const void* hi,
             const void* scales, const void* mins, void* y, int M, int N, int K, int gs,
             int code_bits, int hi_bits, int layer, void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (K <= 0 || K % 32 || layer < 0 || (hi_bits != 0) != (hi != nullptr)) return invalid;
  const auto* c8 = static_cast<const uint8_t*>(codes);
  const auto* h = static_cast<const uint32_t*>(hi);
  const auto args = [&](auto gs_tag, const auto& c) {
    return run<decltype(gs_tag)::value>(pre, x, c, scales, mins, y, M, N, K, layer, stream);
  };
  using G16 = std::integral_constant<int, 16>;
  using G32 = std::integral_constant<int, 32>;
  if (code_bits == 8 && hi_bits == 0 && gs == 32)
    return args(G32{}, mgt::I8Codes{static_cast<const int8_t*>(codes)});
  if (code_bits == 4 && hi_bits == 0 && gs == 32) return args(G32{}, NibbleCodes<0>{c8, h});
  if (code_bits == 4 && hi_bits == 0 && gs == 16) return args(G16{}, NibbleCodes<0>{c8, h});
  if (code_bits == 4 && hi_bits == 1 && gs == 32) return args(G32{}, NibbleCodes<1>{c8, h});
  if (code_bits == 4 && hi_bits == 2 && gs == 16) return args(G16{}, NibbleCodes<2>{c8, h});
  return invalid;
}

}  // namespace

// x f32 [M, K]; codes u8 [L, N, K/2] (code_bits 4) or i8 [L, N, K]
// (code_bits 8); hi i32 [L, N, K/32] (hi_bits 1), [L, N, K/16] (hi_bits 2)
// or null (hi_bits 0); scales/mins bf16 [L, N, K/gs]; y f32 [M, N]; L = 1
// for an unstacked weight.  Requires 1 <= M <= 8, K % 32 == 0, a layout of
// dispatch() above and 16-byte aligned x and codes.
MGT_API int mgt_rq_decode(const void* x, const void* codes, const void* hi, const void* scales,
                          const void* mins, void* y, int M, int N, int K, int gs, int code_bits,
                          int hi_bits, int layer, void* stream) {
  return dispatch(nullptr, x, codes, hi, scales, mins, y, M, N, K, gs, code_bits, hi_bits, layer,
                  stream);
}

// The same for M >= 1 rows (the wrappers send M > 8 here) on the tensor
// cores (bf16 wgmma); xb, ws, cnt, bt and splits are qmm_prefill.cuh's
// mgt::PrefillArgs.
MGT_API int mgt_rq_prefill(const void* x, const void* codes, const void* hi, const void* scales,
                           const void* mins, void* y, int M, int N, int K, int gs, int code_bits,
                           int hi_bits, int layer, void* xb, void* ws, void* cnt, int bt,
                           int splits, void* stream) {
  const mgt::PrefillArgs pa{xb, ws, cnt, bt, splits};
  return dispatch(&pa, x, codes, hi, scales, mins, y, M, N, K, gs, code_bits, hi_bits, layer,
                  stream);
}
