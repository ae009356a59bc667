// probe_qmm: the dequantize-matvec of the unpack-chain probes, N-major
// weights, and the entry of both layouts.
//
// Replaces the Pallas kernels of the dequant-matmul probes: every variant of
// tools/qmm_variants.py (run_variant's pl.pallas_call, :48),
// tools/qmm_v3.py (main :93, main2's K-major layouts :270, main3's q5
// dual-plane merges :416), tools/qmm_r3.py (:89) and
// tools/unpack_variants.py (:82).  All of them compute
//
//   y[m, n] = sum_k x[m, k] * value(code[n, k]) * s[n, k / 32]
//
// with f32 accumulation at the 13B w2 shape (N = 5120, K = 13824) and
// differ in how the codes are stored and unpacked.  The TPU variants'
// tiling (TN, CL), the row-pair nibble layout, pltpu.repeat of the scales
// and the MXU operand roles have no counterpart here;
// minigpt4_tpu_torch/tools/ maps each TPU variant to the nearest (storage,
// strategy, width, layout) of this kernel.  probe_qmm.cuh holds the
// storages, strategies and widths, what bounds the kernel on the H100 and
// its design (a persistent grid over a cp.async ring; f32 FMAs at M = 1,
// bf16 mma.sync with x split into three exact parts at M = 2..8; sums
// reduced in a fixed order); this file instantiates it for w [N, K].
#include "probe_qmm.cuh"

namespace mgt {
namespace probe {
namespace {

int launch_nm_any(const Args& a, int storage, bool sg, int strategy, int width, cudaStream_t s) {
  switch (storage) {
    case kDense: return by_strategy<kNM, kDense, false>(strategy, width, a, s);
    case kI8: return by_strategy<kNM, kI8, false>(strategy, width, a, s);
    case kNib:
      return sg ? by_strategy<kNM, kNib, true>(strategy, width, a, s)
                : by_strategy<kNM, kNib, false>(strategy, width, a, s);
    case kQ5:
      return sg ? by_strategy<kNM, kQ5, true>(strategy, width, a, s)
                : by_strategy<kNM, kQ5, false>(strategy, width, a, s);
    case kQ5D: return by_strategy<kNM, kQ5D, true>(strategy, width, a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace probe
}  // namespace mgt

// x f32 [M, K] (16-byte aligned); codes and hi as probe_qmm.cuh describes
// (hi null unless storage is 3 or 4); scales bf16 [N, K/32] (layout 0, nm)
// or [K/32, N] (layout 1, km), unused for dense; y f32 [M, N], every
// element written (no atomics, the same bits on every launch).  storage 0-4
// (dense, i8, nibbles, q5, q5 dual), is_signed for nibble storages (q5 dual
// takes only signed), strategy 0 shift / 1 magic (dense: shift), width 4 or
// 16, layout 0 nm / 1 km (dense, i8 and nibbles).  1 <= M <= 8; K % 32 == 0,
// K % 256 for the high-bit storages; km needs N % 16 == 0.
MGT_API int mgt_probe_dequant_matvec(const void* x, const void* codes, const void* hi,
                                     const void* scales, void* y, int M, int N, int K,
                                     int storage, int is_signed, int strategy, int width,
                                     int layout, void* stream) {
  using namespace mgt::probe;
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (M < 1 || M > 8 || N <= 0 || K <= 0 || K % 32) return invalid;
  if (has_hi(storage) != (hi != nullptr) || (has_hi(storage) && K % 256)) return invalid;
  if (storage != kDense && scales == nullptr) return invalid;
  if (storage == kQ5D && !is_signed) return invalid;
  if ((storage == kDense || storage == kI8) && is_signed) return invalid;
  const Args a{static_cast<const float*>(x), static_cast<const uint8_t*>(codes),
               static_cast<const uint8_t*>(hi), static_cast<const uint8_t*>(scales),
               static_cast<float*>(y), M, N, K};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (layout == 0) return launch_nm_any(a, storage, is_signed != 0, strategy, width, s);
  if (layout == 1) {
    if (has_hi(storage) || N % 16) return invalid;
    return launch_km(a, storage, is_signed != 0, strategy, width, s);
  }
  return invalid;
}
