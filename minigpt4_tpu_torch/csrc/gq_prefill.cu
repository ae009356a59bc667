// gq_prefill: group-quant matmul for M > 8 activation rows.
//
// Replaces minigpt4_tpu/ops/group_i8.py:_kernel_prefill (reached through
// _run_prefill and qmatmul_group for M > GQ_MAX_M) in both plane modes:
// exact q4_k/q5_k planes (entry mgt_gq_prefill) and generic bf16 planes of
// group size 16 or 32 (entry mgt_gq_prefill_generic).  It serves every
// prefill chunk of more than 8 rows, up to the engine's 512-row bucket.
//
// The kernel is qmm_prefill.cuh's over i8 codes, with the prefill kernel's
// roundings: each weight is dequantized in f32 and rounded to bf16,
// bf16(f32(q) * A + B) (q * A is exact in f32 for both plane modes), the
// activation is rounded to bf16, and the products accumulate in f32 on the
// tensor cores.  qmm_prefill.cuh says what bounds it and how it is laid out.
#include "qmm_prefill.cuh"

// x f32 [M, K]; codes i8 [L, N, K]; sc6/mn6 u8 [L, K/32, N]; d/dmin f32
// [L, K/256, N]; y f32 [M, N].  Requires K % 256 == 0 and 16-byte aligned x
// and codes.
MGT_API int mgt_gq_prefill(const void* x, const void* codes, const void* sc6,
                           const void* mn6, const void* d, const void* dmin,
                           void* y, int M, int N, int K, int layer, void* stream) {
  if (K % 256) return static_cast<int>(cudaErrorInvalidValue);
  const mgt::ExactPlanes planes{static_cast<const uint8_t*>(sc6), static_cast<const uint8_t*>(mn6),
                                static_cast<const float*>(d), static_cast<const float*>(dmin)};
  const mgt::I8Codes c{static_cast<const int8_t*>(codes)};
  return mgt::qmm_prefill(x, c, planes, y, M, N, K, layer, stream);
}

// x f32 [M, K]; codes i8 [L, N, K]; a/b bf16 [L, K/gs, N]; y f32 [M, N].
// Requires gs 16 or 32, K % (8 * gs) == 0 and 16-byte aligned x and codes.
MGT_API int mgt_gq_prefill_generic(const void* x, const void* codes, const void* a,
                                   const void* b, void* y, int M, int N, int K, int gs,
                                   int layer, void* stream) {
  const auto* pa = static_cast<const __nv_bfloat16*>(a);
  const auto* pb = static_cast<const __nv_bfloat16*>(b);
  const mgt::I8Codes c{static_cast<const int8_t*>(codes)};
  if ((gs != 16 && gs != 32) || K % (8 * gs)) return static_cast<int>(cudaErrorInvalidValue);
  if (gs == 16) return mgt::qmm_prefill(x, c, mgt::GenericPlanes<16>{pa, pb}, y, M, N, K, layer, stream);
  return mgt::qmm_prefill(x, c, mgt::GenericPlanes<32>{pa, pb}, y, M, N, K, layer, stream);
}
