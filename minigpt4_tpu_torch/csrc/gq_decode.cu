// gq_decode: group-quant matmul for M <= 8 activation rows.
//
// Replaces minigpt4_tpu/ops/group_i8.py:_kernel_exact (entry mgt_gq_decode)
// and _kernel_generic (entry mgt_gq_decode_generic), both reached through
// _run and qmatmul_group for M <= GQ_MAX_M: every decode-step matmul and
// every prefill bucket of at most 8 rows.
//
// The kernel is qmm_decode.cuh's, over i8 codes (one byte per weight) and
// the planes of common.cuh: exact q4_k/q5_k (group 32, A and B rebuilt in f32
// from u8 sub-scales and f32 superblock scales) or generic (group 16 or 32,
// bf16 A and B read as stored).  qmm_decode.cuh says what bounds it and how
// it is laid out.
#include "qmm_decode.cuh"

// x f32 [M, K]; codes i8 [L, N, K]; sc6/mn6 u8 [L, K/32, N]; d/dmin f32
// [L, K/256, N] (L = 1 for an unstacked weight); y f32 [M, N].
// Requires 1 <= M <= 8, K % 256 == 0 and 16-byte aligned x and codes.
MGT_API int mgt_gq_decode(const void* x, const void* codes, const void* sc6,
                          const void* mn6, const void* d, const void* dmin,
                          void* y, int M, int N, int K, int layer, void* stream) {
  if (K % 256) return static_cast<int>(cudaErrorInvalidValue);
  const mgt::ExactPlanes planes{static_cast<const uint8_t*>(sc6), static_cast<const uint8_t*>(mn6),
                                static_cast<const float*>(d), static_cast<const float*>(dmin)};
  const mgt::I8Codes c{static_cast<const int8_t*>(codes)};
  return mgt::qmm_decode(x, c, planes, y, M, N, K, layer, stream);
}

// x f32 [M, K]; codes i8 [L, N, K]; a/b bf16 [L, K/gs, N]; y f32 [M, N].
// Requires 1 <= M <= 8, gs 16 or 32, K % (8 * gs) == 0 and 16-byte aligned
// x and codes.
MGT_API int mgt_gq_decode_generic(const void* x, const void* codes, const void* a,
                                  const void* b, void* y, int M, int N, int K, int gs,
                                  int layer, void* stream) {
  const auto* pa = static_cast<const __nv_bfloat16*>(a);
  const auto* pb = static_cast<const __nv_bfloat16*>(b);
  const mgt::I8Codes c{static_cast<const int8_t*>(codes)};
  if ((gs != 16 && gs != 32) || K % (8 * gs)) return static_cast<int>(cudaErrorInvalidValue);
  if (gs == 16) return mgt::qmm_decode(x, c, mgt::GenericPlanes<16>{pa, pb}, y, M, N, K, layer, stream);
  return mgt::qmm_decode(x, c, mgt::GenericPlanes<32>{pa, pb}, y, M, N, K, layer, stream);
}

MGT_API const char* mgt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
