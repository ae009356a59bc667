// gq_prefill: group-quant matmul for M > 8 activation rows.
//
// Replaces minigpt4_tpu/ops/group_i8.py:_kernel_prefill (reached through
// _run_prefill and qmatmul_group for M > GQ_MAX_M) in both plane modes:
// exact q4_k/q5_k planes (entry mgt_gq_prefill) and generic bf16 planes of
// group size 16 or 32 (entry mgt_gq_prefill_generic), in every packing of
// the codes (the TPU kernel's _prefill_chunk_codes).  It serves every
// prefill chunk of more than 8 rows, up to the engine's 512-row bucket.
//
// The kernel is qmm_prefill.cuh's over the code source of the weight's
// packing (with_gq_codes, as in gq_decode.cu), with the prefill kernel's
// roundings: each weight is dequantized in f32 and rounded to bf16,
// bf16(f32(q) * A + B) (q * A is exact in f32 for both plane modes), the
// activation is rounded to bf16, and the products accumulate in f32 on the
// tensor cores (bf16 wgmma).  qmm_prefill.cuh says what bounds it and how it
// is laid out; xb, ws, cnt, bt and splits are its mgt::PrefillArgs.
#include "qmm_prefill.cuh"

// The layouts and requirements of mgt_gq_decode (gq_decode.cu), for M >= 1.
MGT_API int mgt_gq_prefill(const void* x, const void* codes, const void* hi, const void* sc6,
                           const void* mn6, const void* d, const void* dmin, void* y, int M,
                           int N, int K, int hi_bits, int layer, void* xb, void* ws, void* cnt,
                           int bt, int splits, void* stream) {
  const mgt::PrefillArgs args{xb, ws, cnt, bt, splits};
  if (K % 256) return static_cast<int>(cudaErrorInvalidValue);
  const mgt::ExactPlanes planes{static_cast<const uint8_t*>(sc6), static_cast<const uint8_t*>(mn6),
                                static_cast<const float*>(d), static_cast<const float*>(dmin)};
  return mgt::with_gq_codes<32>(codes, hi, hi_bits, layer, [&](const auto& c) {
    return mgt::qmm_prefill(x, c, planes, y, M, N, K, layer, args, stream);
  });
}

// The layouts and requirements of mgt_gq_decode_generic, for M >= 1.
MGT_API int mgt_gq_prefill_generic(const void* x, const void* codes, const void* hi,
                                   const void* a, const void* b, void* y, int M, int N, int K,
                                   int gs, int hi_bits, int layer, void* xb, void* ws, void* cnt,
                                   int bt, int splits, void* stream) {
  const mgt::PrefillArgs args{xb, ws, cnt, bt, splits};
  const auto* pa = static_cast<const __nv_bfloat16*>(a);
  const auto* pb = static_cast<const __nv_bfloat16*>(b);
  if ((gs != 16 && gs != 32) || K % (8 * gs)) return static_cast<int>(cudaErrorInvalidValue);
  if (gs == 16) {
    const mgt::GenericPlanes<16> planes{pa, pb};
    return mgt::with_gq_codes<16>(codes, hi, hi_bits, layer, [&](const auto& c) {
      return mgt::qmm_prefill(x, c, planes, y, M, N, K, layer, args, stream);
    });
  }
  const mgt::GenericPlanes<32> planes{pa, pb};
  return mgt::with_gq_codes<32>(codes, hi, hi_bits, layer, [&](const auto& c) {
    return mgt::qmm_prefill(x, c, planes, y, M, N, K, layer, args, stream);
  });
}
