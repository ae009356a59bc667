// probe_qmm_km: the dequantize-matvec of the unpack-chain probes over
// K-major weights (w [K, N], nibble bytes [K/2, N]), the counterpart of the
// K-major layouts of tools/qmm_v3.py main2 (:270: densekm, i8km, i8kmns,
// nibkm).  The entry is in probe_qmm.cu; probe_qmm.cuh holds the storages,
// strategies and widths, what bounds the kernel and its design, which is
// the N-major one's with the tiles along N: a cluster of up to 8 blocks
// shares a run of 16-column units and splits K, each chunk copying 160
// contiguous columns of every k row, and rank 0 adds the ranks' sums in
// rank order through distributed shared memory, so no slice of K reaches
// y through atomics.
#include "probe_qmm.cuh"

namespace mgt {
namespace probe {

int launch_km(const Args& a, int storage, bool sg, int strategy, int width, cudaStream_t s) {
  switch (storage) {
    case kDense: return by_strategy<kKM, kDense, false>(strategy, width, a, s);
    case kI8: return by_strategy<kKM, kI8, false>(strategy, width, a, s);
    case kNib:
      return sg ? by_strategy<kKM, kNib, true>(strategy, width, a, s)
                : by_strategy<kKM, kNib, false>(strategy, width, a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace probe
}  // namespace mgt
