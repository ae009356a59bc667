// What the streaming probe kernels share (probe_qmm.cuh, probe_group_i8.cu,
// probe_int.cu): cp.async copies into a ring of shared-memory slots, the
// ring's schedule, a block's walk over the rows and K of an [N, K] weight
// with its persistent, optionally K-splitting cluster launch, and the s8
// tensor-core MMA with its fragment layout.
//
// What the ring is bound by on the H100 (measured; PERF.md, section 6): with
// one ring for both roles (run_ring), a kernel takes about its bytes' time
// plus its compute's, as a thread that computes issues no copies and the
// loads in flight drain; split roles (run_ring_split) overlap the two.
// Measured no faster on these kernels: TMA bulk copies of a row's 512
// bytes (slower), full / empty mbarriers with both roles in every
// warp, more slots than a 64-row chunk gives, chunks taken round-robin over
// the rows, and 384-byte steps.
//
// mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 (IMMA.16832.S8.S8 on
// sm_90a; PTX ISA, "Matrix Fragments for mma.m16n8k32"): lane (g, t) =
// (lane / 4, lane % 4) holds of A (16 x 32, row-major) rows g (registers 0
// and 2) and g + 8 (1 and 3) at k = 4 t .. 4 t + 3 (registers 0, 1) and 16 +
// 4 t .. (2, 3), four bytes a register in k order; of B (32 x 8, k-major)
// column g at k = 4 t .. 4 t + 3 (register 0) and 16 + 4 t .. (1); of D rows
// g (registers 0, 1) and g + 8 (2, 3) at columns 2 t, 2 t + 1.  The k order
// within one MMA is free as long as A and B take the same one, so the
// kernels give lane t the k slots of its own 8 contiguous bytes 8 t .. 8 t +
// 7 of a 32-code group: register 0 the first four, register 2 (A) / 1 (B)
// the last four (ops/probes.imma_dot mirrors it).
#pragma once

#include <algorithm>
#include <mutex>

#include <cooperative_groups.h>

#include "common.cuh"

namespace mgt {
namespace probe {

__host__ __device__ constexpr int align16(int b) { return (b + 15) / 16 * 16; }

// ---------------------------------------------------------------------------
// copies
// ---------------------------------------------------------------------------

// cp.async of B bytes (4: through L1; 16: L2 only)
template <int B>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  static_assert(B == 4 || B == 16, "cp.async of 4 or 16 bytes");
  if constexpr (B == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Where a run of bytes at src lands in its 16-byte pieces: src's offset in
// its aligned 16 bytes.
__device__ __forceinline__ int run_offset(const void* src) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
}
// Piece i of the copy of the len bytes at src into dst (16-byte aligned):
// the 16 bytes at (src rounded down to 16) + 16 i, of which only those
// before src + len are read (the rest of the piece is zero-filled); the run
// lands at dst + run_offset(src).  A piece past the run's end issues
// nothing.  The bytes before src in the first piece are read, so src's
// tensor must start 16-byte aligned.
__device__ __forceinline__ void cp_async_piece(uint8_t* dst, const void* src, int len, int i) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const int end = static_cast<int>(a & 15) + len;
  if (16 * i < end)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst + 16 * i)),
                 "l"((a & ~static_cast<uintptr_t>(15)) + 16 * i), "r"(min(16, end - 16 * i))
                 : "memory");
}
// the most pieces a run of len bytes takes
__host__ __device__ constexpr int run_pieces(int len) { return (len + 15 + 15) / 16; }

// an arrival on bar once this thread's earlier cp.async copies have landed
// (the barrier's expected count includes it)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// ---------------------------------------------------------------------------
// the ring
// ---------------------------------------------------------------------------

// The ring's schedule over a block's `steps` steps: D slots, D - 1 steps in
// flight.  issue(p) starts the copies of the step at position p into its
// slot, compute(p) consumes it, advance(p) moves a position one step (and
// one slot) on.  Every thread waits for its own copies of step s
// (cp.async.wait_group) and then for everyone's (the barrier), which also
// frees slot (s - 1) % D for step s + D - 1.
template <int D, class Pos, class Advance, class Issue, class Compute>
__device__ __forceinline__ void run_ring(int steps, Pos pi, Advance&& advance, Issue&& issue,
                                         Compute&& compute) {
  Pos pc = pi;
#pragma unroll 1
  for (int s = 0; s < D - 1; ++s) {
    if (s < steps) {
      issue(pi);
      advance(pi);
    }
    cp_async_commit();
  }
#pragma unroll 1
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<D - 2>();  // step s has landed (this thread's copies)
    __syncthreads();         // ... and everyone's; slot (s - 1) % D is free
    if (s + D - 1 < steps) {
      issue(pi);
      advance(pi);
    }
    cp_async_commit();
    compute(pc);
    advance(pc);
  }
}

// The ring with its roles split (probe_group_i8.cu, probe_int.cu): producer
// warps only copy, consumer warps only compute.  A step's slot has a full
// mbarrier (one arrival a producer thread, made by cp_async_arrive as that
// thread's copies land) and an empty one (one arrival a consumer warp, once
// it has consumed the step).  A producer refills a slot once its previous
// step is consumed; a consumer computes a step once all of it has landed.
// So the copies keep streaming while the consumers compute: with one ring
// for both roles, every thread that stops to compute stops issuing, and the
// loads in flight drain (measured; PERF.md, section 6).  Positions
// carry the parity of their slot's uses (p.ph), the phase each barrier
// completes.
template <int D, class Pos, class Advance, class Issue, class Compute>
__device__ __forceinline__ void run_ring_split(bool producer, int steps, Pos p, Advance&& advance,
                                               Issue&& issue, Compute&& compute, uint64_t* full,
                                               uint64_t* empty) {
  if (producer) {
#pragma unroll 1
    for (int s = 0; s < steps; ++s) {
      if (s >= D) mbar_wait(empty + p.sl, p.ph ^ 1);  // step s - D consumed
      issue(p);
      cp_async_arrive(full + p.sl);
      advance(p);
    }
    cp_async_wait<0>();  // nothing in flight when the producer leaves
  } else {
    const bool lead = threadIdx.x % 32 == 0;
#pragma unroll 1
    for (int s = 0; s < steps; ++s) {
      mbar_wait(full + p.sl, p.ph);  // step s landed, every producer's copies
      compute(p);
      __syncwarp();
      if (lead) mbar_arrive(empty + p.sl);
      advance(p);
    }
  }
}

// D full and D empty mbarriers (counts n_full and n_empty), by one thread
// before the block's first barrier
__device__ __forceinline__ void init_ring_barriers(uint64_t* full, uint64_t* empty, int d,
                                                   int n_full, int n_empty) {
  for (int i = 0; i < d; ++i) {
    mbar_init(full + i, n_full);
    mbar_init(empty + i, n_empty);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// a barrier of the consumer warps alone (named barrier 1; nthreads of them)
__device__ __forceinline__ void consumer_sync(int nthreads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(nthreads) : "memory");
}

// ---------------------------------------------------------------------------
// a block's walk over an [N, K] weight (probe_group_i8.cu, probe_int.cu)
// ---------------------------------------------------------------------------

constexpr int kTile = 16;  // output rows per MMA tile: the m16 side
constexpr int kMaxCluster = 8;

// A position in a block's steps: chunk ci (tiles [lo, hi) of the block's,
// rows n0 .. n0 + nrows, nt tiles) and its step st (codes k0 .. k0 + len
// of K), slot sl of the ring and the parity ph of the slot's uses so far.
struct Pos {
  int ci, st, sl, ph, n0, nrows, nt, k0, len;
};

// The rows [b0, b1) of cluster cid of ncl (N split evenly by rows), walked
// in chunks of at most CT tiles of 16 rows (the last tile cut at b1; chunk
// ci takes the tiles [ntb ci / nch, ntb (ci + 1) / nch)), each chunk in the
// steps [sb, sb + spc) of KS codes of K that are rank rk's of the cluster's
// csize (an even share of K's steps, at least one).  Positions advance one
// step at a time, with no division per step (ops/probes.ring_plan mirrors
// it).
template <int KS, int CT, int D>
struct Walk {
  int K, b0, b1, ntb, nch, sb, spc;
  __device__ Walk(int N, int K_, int csize, int rk, int cid, int ncl) : K(K_) {
    const int steps_all = (K + KS - 1) / KS;
    sb = steps_all * rk / csize;
    spc = steps_all * (rk + 1) / csize - sb;
    b0 = static_cast<int>(static_cast<long long>(N) * cid / ncl);
    b1 = static_cast<int>(static_cast<long long>(N) * (cid + 1) / ncl);
    ntb = (b1 - b0 + kTile - 1) / kTile;
    nch = (ntb + CT - 1) / CT;
  }
  __device__ int steps() const { return nch * spc; }
  __device__ void set_chunk(Pos& p) const {
    const int lo = ntb * p.ci / nch, hi = ntb * (p.ci + 1) / nch;
    p.n0 = b0 + lo * kTile;
    p.nrows = min((hi - lo) * kTile, b1 - p.n0);
    p.nt = hi - lo;
  }
  __device__ void set_step(Pos& p) const {
    p.k0 = (sb + p.st) * KS;
    p.len = min(KS, K - p.k0);
  }
  __device__ Pos first() const {
    Pos p{0, 0, 0, 0, 0, 0, 0, 0, 0};
    set_chunk(p);
    set_step(p);
    return p;
  }
  __device__ void advance(Pos& p) const {
    if (++p.sl == D) {
      p.sl = 0;
      p.ph ^= 1;
    }
    if (++p.st == spc) {
      p.st = 0;
      if (++p.ci < nch) set_chunk(p);
    }
    set_step(p);
  }
};

// Clusters of `cfg`'s size that fit on the device at once (cached per
// kernel, cluster size and shared memory); 0 where none fits.
template <class Kernel>
int clusters_fit(Kernel kern, const cudaLaunchConfig_t& cfg, int csize) {
  struct Key {
    const void* kern;
    int csize, smem, fit;
  };
  static std::mutex mu;
  static Key keys[64];
  static int n_keys = 0;
  const void* k = reinterpret_cast<const void*>(kern);
  const int smem = static_cast<int>(cfg.dynamicSmemBytes);
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n_keys; ++i)
    if (keys[i].kern == k && keys[i].csize == csize && keys[i].smem == smem) return keys[i].fit;
  int fit = 0;
  if (cudaOccupancyMaxActiveClusters(&fit, kern, &cfg) != cudaSuccess) return 0;
  if (n_keys < 64) keys[n_keys++] = Key{k, csize, smem, fit};
  return fit;
}

// Launches kern(args) as a persistent grid over an [N, K] weight of KS-code
// steps: blocks of nt threads with smem bytes of dynamic shared memory (the
// caller has allowed that much), in clusters of csize blocks that split K
// where N has fewer 16-row tiles than the device has SMs (split; csize at
// most kMaxCluster and K's step count), as many clusters as fit at once and
// as N has tiles.  A cluster that splits K holds one chunk of at most ct
// tiles, whose sums its ranks add once, after the ring: where the clusters
// that fit could not give every cluster one chunk, K stays whole.  Returns
// a CUDA error code.
template <class Kernel, class Args>
int launch_walk(Kernel kern, int nt, int smem, int N, int K, int ks, int ct, bool split,
                cudaStream_t stream, const Args& args) {
  const int tiles = (N + kTile - 1) / kTile, sms = device_sms();
  const int steps_all = (K + ks - 1) / ks;
  int csize = split ? std::max(1, std::min({kMaxCluster, steps_all, sms / tiles})) : 1;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute cl[1];
  cl[0].id = cudaLaunchAttributeClusterDimension;
  cl[0].val.clusterDim.y = 1;
  cl[0].val.clusterDim.z = 1;
  cfg.attrs = cl;
  cfg.numAttrs = 1;
  cfg.blockDim = dim3(nt);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  int fit = 0;
  for (;;) {
    cl[0].val.clusterDim.x = csize;
    cfg.gridDim = dim3(csize);
    fit = clusters_fit(kern, cfg, csize);
    if (csize == 1 || fit * ct >= tiles) break;
    csize = 1;
  }
  if (fit < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  cfg.gridDim = dim3(csize * std::min(fit, tiles));
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, args);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// ---------------------------------------------------------------------------
// the s8 tensor-core MMA
// ---------------------------------------------------------------------------

// d += A (16 x 32) B (32 x 8), s8 in, exact s32 sums; a0 / a2 rows g, a1 /
// a3 rows g + 8 (see the top of this file)
__device__ __forceinline__ void mma_s8(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

}  // namespace probe
}  // namespace mgt
