// gq_decode: group-quant matmul for M <= 8 activation rows.
//
// Replaces minigpt4_tpu/ops/group_i8.py:_kernel_exact (entry mgt_gq_decode)
// and _kernel_generic (entry mgt_gq_decode_generic), both reached through
// _run and qmatmul_group for M <= GQ_MAX_M: every decode-step matmul and
// every prefill bucket of at most 8 rows, in every packing of the codes
// (the TPU kernels' _prep_codes, _unpack_nibbles, _unpack_hibits and
// _unpack_hi2bits).
//
// The kernel is gq_decode_i8.cuh's: the function of the TPU kernels, with
// the activations split into two i8 planes inside the launch and exact i32
// group dot products on __dp4a, over the planes of common.cuh, exact
// q4_k/q5_k (group 32, A and B rebuilt in f32 from u8 sub-scales and f32
// superblock scales) or generic (group 16 or 32, bf16 A and B read as
// stored), and over the code source of the weight's packing
// (with_gq_codes): i8 codes, one byte per weight, or the K-order nibbles
// and high bits of p4/p5/p6.  A code reaches the integer dot as the same
// byte either way and the kernel sums in a fixed order, so packed and
// unpacked codes of one weight give the same bits.  gq_decode_i8.cuh says
// what bounds it and how it is laid out.
#include "gq_decode_i8.cuh"

// x f32 [M, K]; codes i8 [L, N, K] (hi_bits -1) or u8 [L, N, K/2] nibble
// pairs along K; hi i32 [L, N, K/32] (hi_bits 1, p5) or null (hi_bits -1 or
// 0); sc6/mn6 u8 [L, K/32, N]; d/dmin f32 [L, K/256, N] (L = 1 for an
// unstacked weight); y f32 [M, N].  Requires 1 <= M <= 8, K % 256 == 0,
// 16-byte aligned x and codes and 8-byte aligned high bits.
MGT_API int mgt_gq_decode(const void* x, const void* codes, const void* hi, const void* sc6,
                          const void* mn6, const void* d, const void* dmin, void* y, int M,
                          int N, int K, int hi_bits, int layer, void* stream) {
  if (K % 256) return static_cast<int>(cudaErrorInvalidValue);
  const mgt::ExactPlanes planes{static_cast<const uint8_t*>(sc6), static_cast<const uint8_t*>(mn6),
                                static_cast<const float*>(d), static_cast<const float*>(dmin)};
  return mgt::with_gq_codes<32>(codes, hi, hi_bits, layer, [&](const auto& c) {
    return mgt::gq_decode_i8(x, c, planes, y, M, N, K, layer, stream);
  });
}

// The same over generic planes a/b bf16 [L, K/gs, N]: gs 32 with hi_bits -1,
// 0 (q4_0, q4_1) or 1 (q5_0, q5_1); gs 16 with hi_bits -1 or 2 (q6_k, hi i32
// [L, N, K/16]).  Requires K % (8 * gs) == 0.
MGT_API int mgt_gq_decode_generic(const void* x, const void* codes, const void* hi,
                                  const void* a, const void* b, void* y, int M, int N, int K,
                                  int gs, int hi_bits, int layer, void* stream) {
  const auto* pa = static_cast<const __nv_bfloat16*>(a);
  const auto* pb = static_cast<const __nv_bfloat16*>(b);
  if ((gs != 16 && gs != 32) || K % (8 * gs)) return static_cast<int>(cudaErrorInvalidValue);
  if (gs == 16) {
    const mgt::GenericPlanes<16> planes{pa, pb};
    return mgt::with_gq_codes<16>(codes, hi, hi_bits, layer, [&](const auto& c) {
      return mgt::gq_decode_i8(x, c, planes, y, M, N, K, layer, stream);
    });
  }
  const mgt::GenericPlanes<32> planes{pa, pb};
  return mgt::with_gq_codes<32>(codes, hi, hi_bits, layer, [&](const auto& c) {
    return mgt::gq_decode_i8(x, c, planes, y, M, N, K, layer, stream);
  });
}

MGT_API const char* mgt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
