// probe_qmm_km: the dequantize-matvec of the unpack-chain probes over
// K-major weights (w [K, N], lanes along N), the counterpart of the
// K-major layouts of tools/qmm_v3.py main2 (:270: densekm, i8km, i8kmns,
// nibkm).  The entry is in probe_qmm.cu; probe_qmm.cuh defines the
// storages, strategies and widths.
//
// What bounds it on the H100: as the nm layout, the code bytes at M = 1 and
// the f32 multiply-adds at M = 8; here also the partial sums, since a column
// is owned by one lane, which must see all of K.
//
// Design.  A lane owns V adjacent columns (the columns of one W-byte load:
// W / 2 bf16, W i8 codes, or W nibble pairs, which are V columns at two k),
// a warp 32 V columns, and the 8 warps of a block split the block's slice of
// K by 32-code groups.  The grid's second dimension splits K into slices, so
// that about 4 blocks per SM are in flight at the 13B w2 shape.  Per group a
// lane loads the V scales, per k its code vector, unpacks it, scales each
// value once and multiplies with the M values x[m, k] (read through the
// read-only cache; every lane reads the same word).  At the end the warps
// add their partial sums in shared memory (atomics), and the block adds its
// sums to y with one global atomicAdd per output: the order of those f32
// additions varies from run to run (results within f32 rounding).
#include <algorithm>

#include "probe_qmm.cuh"

namespace mgt {
namespace probe {
namespace {

constexpr int kWarps = 8;

template <int MT, int S, bool SIGNED, int STRAT, int W>
__global__ void __launch_bounds__(kWarps * 32)
qmm_km_kernel(const float* __restrict__ x, const uint8_t* __restrict__ codes,
              const __nv_bfloat16* __restrict__ sc, float* __restrict__ y, int M, int N, int K) {
  constexpr int CPW = codes_per_word(S);
  constexpr int WPL = W / 4;                     // words per load
  constexpr int KPR = S == kNib ? 2 : 1;         // k per code row
  constexpr int V = WPL * CPW / KPR;             // columns per lane
  constexpr int BC = 32 * V;                     // columns per block
  __shared__ float red[MT][BC];

  for (int i = threadIdx.x; i < MT * BC; i += blockDim.x) red[i / BC][i % BC] = 0.f;
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col0 = blockIdx.x * BC + lane * V;
  const size_t row_bytes = (S == kDense ? 2 : 1) * static_cast<size_t>(N);
  const int G = K / 32;
  const int g0 = static_cast<int>(static_cast<long long>(G) * blockIdx.y / gridDim.y);
  const int g1 = static_cast<int>(static_cast<long long>(G) * (blockIdx.y + 1) / gridDim.y);

  float acc[V][MT];
#pragma unroll
  for (int v = 0; v < V; ++v)
#pragma unroll
    for (int m = 0; m < MT; ++m) acc[v][m] = 0.f;

  if (col0 < N) {
    for (int g = g0 + warp; g < g1; g += kWarps) {
      float s[V];
      if constexpr (S == kDense) {
#pragma unroll
        for (int v = 0; v < V; ++v) s[v] = 1.f;
      } else {
        // V bf16 scales, 2 V bytes, in loads of the lane's width
        const uint8_t* sp = reinterpret_cast<const uint8_t*>(sc + static_cast<size_t>(g) * N + col0);
#pragma unroll
        for (int i = 0; i < V / 2; i += WPL) {
          uint32_t words[WPL];
          load_words<W>(sp + 4 * i, words);
#pragma unroll
          for (int j = 0; j < WPL; ++j) {
            s[2 * (i + j)] = __uint_as_float(words[j] << 16);
            s[2 * (i + j) + 1] = __uint_as_float(words[j] & 0xffff0000u);
          }
        }
      }
#pragma unroll 2
      for (int kr = 0; kr < 32 / KPR; ++kr) {
        const size_t row = static_cast<size_t>(g) * (32 / KPR) + kr;
        uint32_t cw[WPL];
        load_words<W>(codes + row * row_bytes + static_cast<size_t>(col0) * (S == kDense ? 2 : 1), cw);
        float val[WPL * CPW];
#pragma unroll
        for (int i = 0; i < WPL; ++i) {
          float part[CPW];
          unpack<S, SIGNED, STRAT>(cw[i], 0u, 0u, part);
#pragma unroll
          for (int j = 0; j < CPW; ++j) val[i * CPW + j] = part[j];
        }
#pragma unroll
        for (int kk = 0; kk < KPR; ++kk) {
          const size_t k = row * KPR + kk;
          float xk[MT];
#pragma unroll
          for (int m = 0; m < MT; ++m) xk[m] = m < M ? __ldg(x + static_cast<size_t>(m) * K + k) : 0.f;
#pragma unroll
          for (int v = 0; v < V; ++v) {
            // nibble pairs: value 2 v + kk is column v at k; else value v
            const float w = val[KPR * v + kk] * s[v];
#pragma unroll
            for (int m = 0; m < MT; ++m) acc[v][m] = fmaf(w, xk[m], acc[v][m]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int v = 0; v < V; ++v)
#pragma unroll
    for (int m = 0; m < MT; ++m)
      if (m < M) atomicAdd(&red[m][lane * V + v], acc[v][m]);
  __syncthreads();
  for (int i = threadIdx.x; i < MT * BC; i += blockDim.x) {
    const int m = i / BC, c = blockIdx.x * BC + i % BC;
    if (m < M && c < N) atomicAdd(y + static_cast<size_t>(m) * N + c, red[m][i % BC]);
  }
}

template <int S, bool SIGNED, int STRAT, int W>
int launch(const void* x, const void* codes, const void* scales, void* y, int M, int N, int K,
           cudaStream_t stream) {
  constexpr int V = (W / 4) * codes_per_word(S) / (S == kNib ? 2 : 1);
  const int col_blocks = (N + 32 * V - 1) / (32 * V);
  const int groups = K / 32;
  // about 4 blocks per SM of the H100's 132, each slice at least 8 groups
  const int slices = std::max(1, std::min((4 * 132 + col_blocks - 1) / col_blocks, groups / kWarps));
  const dim3 grid(col_blocks, slices), block(kWarps * 32);
  const auto* xp = static_cast<const float*>(x);
  const auto* cp = static_cast<const uint8_t*>(codes);
  const auto* sp = static_cast<const __nv_bfloat16*>(scales);
  auto* yp = static_cast<float*>(y);
  if (M == 1) qmm_km_kernel<1, S, SIGNED, STRAT, W><<<grid, block, 0, stream>>>(xp, cp, sp, yp, M, N, K);
  else qmm_km_kernel<8, S, SIGNED, STRAT, W><<<grid, block, 0, stream>>>(xp, cp, sp, yp, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

template <int S, bool SIGNED, int STRAT>
int by_width(int width, const void* x, const void* codes, const void* scales, void* y, int M,
             int N, int K, cudaStream_t s) {
  if (width == 4) return launch<S, SIGNED, STRAT, 4>(x, codes, scales, y, M, N, K, s);
  if (width == 16) return launch<S, SIGNED, STRAT, 16>(x, codes, scales, y, M, N, K, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int S, bool SIGNED>
int by_strategy(int strategy, int width, const void* x, const void* codes, const void* scales,
                void* y, int M, int N, int K, cudaStream_t s) {
  if (strategy == kShift) return by_width<S, SIGNED, kShift>(width, x, codes, scales, y, M, N, K, s);
  if constexpr (S != kDense) {
    if (strategy == kMagic)
      return by_width<S, SIGNED, kMagic>(width, x, codes, scales, y, M, N, K, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

int launch_km(const void* x, const void* codes, const void* scales, void* y, int M, int N, int K,
              int storage, bool sg, int strategy, int width, cudaStream_t s) {
  switch (storage) {
    case kDense: return by_strategy<kDense, false>(strategy, width, x, codes, scales, y, M, N, K, s);
    case kI8: return by_strategy<kI8, false>(strategy, width, x, codes, scales, y, M, N, K, s);
    case kNib:
      return sg ? by_strategy<kNib, true>(strategy, width, x, codes, scales, y, M, N, K, s)
                : by_strategy<kNib, false>(strategy, width, x, codes, scales, y, M, N, K, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace probe
}  // namespace mgt
