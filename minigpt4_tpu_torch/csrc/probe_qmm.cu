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
// differ in how the codes are stored and unpacked; probe_qmm.cuh defines
// the storages, the unpack strategies and the load widths.  The TPU
// variants' tiling (TN, CL), the row-pair nibble layout, pltpu.repeat of the
// scales and the MXU operand roles have no counterpart here;
// minigpt4_tpu_torch/tools/ maps each TPU variant to the nearest
// (storage, strategy, width, layout) of this kernel.
//
// What bounds it on the H100: device-memory bandwidth on the codes (2 B per
// weight dense, 1 i8, 0.5 nibbles, 0.625 q5, 0.75 q5 dual) plus 1/16 B of
// scales at M = 1; at M = 8 the 2 M N K f32 multiply-adds come close to the
// byte bound for nibbles (16.9 us against 10.6-14.5 us at the w2 shape), and
// the unpack instructions add to them, which is what the probe measures.
//
// nm design (the first repacked decode kernel's).  A block owns 32 output columns (8 warps x
// 4); the x of a K tile of 1024 is staged in shared memory (f32, 32 KB at
// M = 8).  For the high-bit storages the tile walks the field-local index i
// (128 per tile) of all 8 fields at once, so a lane that reads a run of
// plane bytes serves the code runs of the fields that share them; the
// staged x is x[m, p * nb + i].  A lane's work item is a run of W bytes of
// codes of one field (2 to 32 codes), for each of the warp's 4 columns: it
// loads the runs (and the run's plane bytes), unpacks one 32-bit word of
// each column at a time, multiplies with the staged x of the M rows, and
// scales the run's sum once (a run never crosses a 32-code group).  One
// warp reduction per output at the end; no atomics, deterministic.
#include "probe_qmm.cuh"

namespace mgt {
namespace probe {
namespace {

constexpr int kWarps = 8;
constexpr int kCols = 4;
constexpr int kBN = kWarps * kCols;
constexpr int kKT = 1024;  // staged x floats per row and tile

template <int MT, int S, bool SIGNED, int STRAT, int W>
__global__ void __launch_bounds__(kWarps * 32)
qmm_nm_kernel(const float* __restrict__ x, const uint8_t* __restrict__ codes,
              const uint8_t* __restrict__ hi, const __nv_bfloat16* __restrict__ sc,
              float* __restrict__ y, int M, int N, int K) {
  constexpr bool HI = has_hi(S);
  constexpr int F = HI ? 8 : 1;  // fields
  constexpr int T = kKT / F;     // field-local positions per tile
  constexpr int CPW = codes_per_word(S);
  constexpr int WPR = W / 4;      // words per run
  constexpr int R = CPW * WPR;    // codes per run
  constexpr int PW = HI ? R / 4 : 1;  // plane words per run (one plane byte per code)
  __shared__ __align__(16) float xs[MT][kKT];

  const int nb = K / F;
  const int G = K / 32;
  const size_t row_bytes = S == kDense ? 2 * static_cast<size_t>(K)
                           : S == kI8  ? static_cast<size_t>(K)
                                       : static_cast<size_t>(K) / 2;
  const size_t hi_bytes = S == kQ5 ? K / 8 : K / 4;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n0 = blockIdx.x * kBN + warp * kCols;

  float acc[kCols][MT];
#pragma unroll
  for (int c = 0; c < kCols; ++c)
#pragma unroll
    for (int m = 0; m < MT; ++m) acc[c][m] = 0.f;

  for (int it = 0; it < nb; it += T) {
    const int len = min(T, nb - it);  // a multiple of 32
    __syncthreads();                  // the previous tile is consumed
    const int len4 = len / 4;
    for (int i = threadIdx.x; i < MT * F * len4; i += blockDim.x) {
      const int m = i / (F * len4), r = i % (F * len4), f = r / len4, j4 = r % len4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m < M)
        v = __ldg(reinterpret_cast<const float4*>(x + static_cast<size_t>(m) * K +
                                                  static_cast<size_t>(f) * nb + it) + j4);
      reinterpret_cast<float4*>(&xs[m][f * T])[j4] = v;
    }
    __syncthreads();

    const int runs = len / R;  // per field
    for (int item = lane; item < F * runs; item += 32) {
      const int f = item / runs, j0 = (item % runs) * R;
      const int k = f * nb + it + j0;
      uint32_t cw[kCols][WPR];
      uint32_t pw[kCols][PW];
      float s[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int n = n0 + c;
#pragma unroll
        for (int i = 0; i < WPR; ++i) cw[c][i] = 0;
#pragma unroll
        for (int i = 0; i < PW; ++i) pw[c][i] = 0;
        s[c] = 0.f;
        if (n < N) {
          const size_t kb = S == kDense ? 2 * static_cast<size_t>(k)
                            : S == kI8  ? static_cast<size_t>(k)
                                        : static_cast<size_t>(k) / 2;
          load_words<W>(codes + static_cast<size_t>(n) * row_bytes + kb, cw[c]);
          if constexpr (HI) {
            const uint8_t* hp = hi + static_cast<size_t>(n) * hi_bytes + it + j0 +
                                (S == kQ5D ? static_cast<size_t>(f / 4) * nb : 0);
#pragma unroll
            for (int i = 0; i < PW; i += WPR) {
              uint32_t words[WPR];
              load_words<W>(hp + 4 * i, words);
#pragma unroll
              for (int j = 0; j < WPR; ++j) pw[c][i + j] = words[j];
            }
          }
          if constexpr (S != kDense)
            s[c] = __bfloat162float(sc[static_cast<size_t>(n) * G + k / 32]);
        }
      }
      const int bsh = S == kQ5 ? f : (f & 3) + 1;  // the field's bit in a plane byte
      float part[kCols][MT];
#pragma unroll
      for (int c = 0; c < kCols; ++c)
#pragma unroll
        for (int m = 0; m < MT; ++m) part[c][m] = 0.f;
#pragma unroll
      for (int wi = 0; wi < WPR; ++wi) {
        float v[kCols][CPW];
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          uint32_t h0 = 0, h1 = 0;
          if constexpr (HI) {
            h0 = (pw[c][2 * wi] >> bsh) & 0x01010101u;
            h1 = (pw[c][2 * wi + 1] >> bsh) & 0x01010101u;
          }
          unpack<S, SIGNED, STRAT>(cw[c][wi], h0, h1, v[c]);
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float* xp = &xs[m][f * T + j0 + wi * CPW];
          float xv[CPW];
#pragma unroll
          for (int j = 0; j < CPW; j += 2) {
            const float2 t = *reinterpret_cast<const float2*>(xp + j);
            xv[j] = t.x;
            xv[j + 1] = t.y;
          }
#pragma unroll
          for (int c = 0; c < kCols; ++c)
#pragma unroll
            for (int j = 0; j < CPW; ++j) part[c][m] = fmaf(v[c][j], xv[j], part[c][m]);
        }
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c)
#pragma unroll
        for (int m = 0; m < MT; ++m)
          acc[c][m] = S == kDense ? acc[c][m] + part[c][m] : fmaf(s[c], part[c][m], acc[c][m]);
    }
  }

#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int n = n0 + c;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const float v = warp_sum(acc[c][m]);
      if (lane == 0 && n < N && m < M) y[static_cast<size_t>(m) * N + n] = v;
    }
  }
}

template <int S, bool SIGNED, int STRAT, int W>
int launch_nm(const void* x, const void* codes, const void* hi, const void* scales, void* y,
              int M, int N, int K, cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN), block(kWarps * 32);
  const auto* xp = static_cast<const float*>(x);
  const auto* cp = static_cast<const uint8_t*>(codes);
  const auto* hp = static_cast<const uint8_t*>(hi);
  const auto* sp = static_cast<const __nv_bfloat16*>(scales);
  auto* yp = static_cast<float*>(y);
  if (M == 1) qmm_nm_kernel<1, S, SIGNED, STRAT, W><<<grid, block, 0, stream>>>(xp, cp, hp, sp, yp, M, N, K);
  else qmm_nm_kernel<8, S, SIGNED, STRAT, W><<<grid, block, 0, stream>>>(xp, cp, hp, sp, yp, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

template <int S, bool SIGNED, int STRAT>
int by_width(int width, const void* x, const void* codes, const void* hi, const void* scales,
             void* y, int M, int N, int K, cudaStream_t stream) {
  if (width == 4) return launch_nm<S, SIGNED, STRAT, 4>(x, codes, hi, scales, y, M, N, K, stream);
  if (width == 16) return launch_nm<S, SIGNED, STRAT, 16>(x, codes, hi, scales, y, M, N, K, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int S, bool SIGNED>
int by_strategy(int strategy, int width, const void* x, const void* codes, const void* hi,
                const void* scales, void* y, int M, int N, int K, cudaStream_t stream) {
  if (strategy == kShift)
    return by_width<S, SIGNED, kShift>(width, x, codes, hi, scales, y, M, N, K, stream);
  if constexpr (S != kDense) {  // dense weights need no unpack: shift only
    if (strategy == kMagic)
      return by_width<S, SIGNED, kMagic>(width, x, codes, hi, scales, y, M, N, K, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int launch_nm_any(const void* x, const void* codes, const void* hi, const void* scales, void* y,
                  int M, int N, int K, int storage, bool sg, int strategy, int width,
                  cudaStream_t s) {
  switch (storage) {
    case kDense: return by_strategy<kDense, false>(strategy, width, x, codes, hi, scales, y, M, N, K, s);
    case kI8: return by_strategy<kI8, false>(strategy, width, x, codes, hi, scales, y, M, N, K, s);
    case kNib:
      return sg ? by_strategy<kNib, true>(strategy, width, x, codes, hi, scales, y, M, N, K, s)
                : by_strategy<kNib, false>(strategy, width, x, codes, hi, scales, y, M, N, K, s);
    case kQ5:
      return sg ? by_strategy<kQ5, true>(strategy, width, x, codes, hi, scales, y, M, N, K, s)
                : by_strategy<kQ5, false>(strategy, width, x, codes, hi, scales, y, M, N, K, s);
    case kQ5D:
      return by_strategy<kQ5D, true>(strategy, width, x, codes, hi, scales, y, M, N, K, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace probe
}  // namespace mgt

// x f32 [M, K] (16-byte aligned); codes and hi as probe_qmm.cuh describes
// (hi null unless storage is 3 or 4); scales bf16 [N, K/32] (layout 0, nm)
// or [K/32, N] (layout 1, km), unused for dense; y f32 [M, N], zeroed by the
// caller for km (its blocks add partial sums with atomics).  storage 0-4
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (layout == 0)
    return launch_nm_any(x, codes, hi, scales, y, M, N, K, storage, is_signed != 0, strategy,
                         width, s);
  if (layout == 1) {
    if (has_hi(storage) || N % 16) return invalid;
    return launch_km(x, codes, scales, y, M, N, K, storage, is_signed != 0, strategy, width, s);
  }
  return invalid;
}
