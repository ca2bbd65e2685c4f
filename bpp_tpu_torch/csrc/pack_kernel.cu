// Per-locus Felsenstein pruning log-likelihood for 4-state data, in float
// or (for --x64) double: both builds are instantiations of one template.
//
// Replaces the TPU kernel K1: bpp_tpu/core/pallas_pack.py
// `_make_kernel` (launched by `site_logl_packed`).  It computes what K1
// computes, not K1's layout: the 8-lane segments, 256-lane tiles,
// sublane rolls and one-hot level-slot select chains existed for the
// TPU's vector registers and are gone.
//
// What bounds it on an H100: bytes (each real tip partial once: ~6 MB at
// 1000 loci of 16 tips and ~21 real patterns, a few microseconds), and in
// practice latency: the whole pass is one wave of about 1000 warps, each a
// chain of table, schedule and tip reads and T-1 dependent levels.
//
// Design, with the device code of contract.cuh (shared with K2):
//   * one warp per unit = (locus, chunk of up to 32 real patterns); the
//     warp computes its locus's branch lengths, expm1 factors and CLV
//     slot plan into shared memory, keeps its patterns' CLVs there
//     (SHARED store; a device scratch for trees whose CLVs do not fit in
//     227 KB), reads each tip once two levels ahead of its use, and walks
//     the tree;
//   * a block is 2, 4 or 8 warps and owns a run of whole loci (a table
//     from core/units.py: units u0..u1 of loci l0..l1), so several small
//     loci share a block and a locus never spans two; a locus with more
//     units than the block has warps is walked in rounds;
//   * the per-locus sum stays flat, ordered and in double, without
//     floating-point atomics: a lane's weight x value is reduced over the
//     warp by a fixed shuffle tree, the unit's partial goes to shared
//     memory, and the thread that owns a locus adds its units' partials
//     in unit order, round after round.  The result does not depend on
//     the block size or the CLV store, and a chain is reproducible run to
//     run.
//
// Shared memory per block: warps x the per-warp bytes listed in
// contract.cuh, plus 256 B of partials; at T = 16 and 64 threads, the
// wrapper's block size, about 9 KB (C = 1), 35 KB (C = 4) and 70 KB (C = 8).
//
// The double build (--x64) has a kernel of its own, pack_logl_kernel_f64:
// the same blocks, rounds and flat ordered sum with contract.cuh's
// DoubleBuildWalk (DoubleWalk up to 3 categories, UnitWalk's above);
// PERF.md §6 has the measurements it was designed from.
//
// Chains (chains = K): a launch takes K chains' trees and parameters at
// once, a grid row (blockIdx.y) a chain over the one block table, and
// writes out [K, L]; the tips, weights and tables are read by every row
// (contract.cuh TreeArgs).  Nothing of a locus's arithmetic depends on K,
// so chain k's row equals a one-chain launch on chain k's tensors bit for
// bit.
//
// C interface (built with nvcc into a shared library, loaded by ctypes
// from bpp_tpu_torch/core/pack.py): bpp_pack_logl (dbl = 1: the double
// build; K chains of L loci) returns the value of cudaGetLastError() right after the launch.  bpp_pack_empty launches a
// kernel that does nothing, for timing the launch floor beside K1.

#include "contract.cuh"

namespace {

using namespace bpp;

constexpr int kMaxWarps = 32;

__device__ __forceinline__ double warp_sum(double v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

template <typename R, int FAM, int C, bool SHARED>
__global__ void pack_logl_kernel(TreeArgs<R> a, const R* weights, int W,
                                 const int4* blocks, const int* locus_unit0,
                                 R* out) {
  extern __shared__ __align__(16) unsigned char block_state[];
  __shared__ double part[kMaxWarps];
  const int lane = threadIdx.x & (kLanes - 1);
  const int warp = threadIdx.x / kLanes;
  const int warps = blockDim.x / kLanes;
  const int4 blk = blocks[blockIdx.x];     // units u0..u1 of loci l0..l1
  const int u1 = blk.y;
  const long long stride =
      warp_layout(a.T, C, Coefs<FAM, R>::K, SHARED, sizeof(R)).bytes;

  // the locus this thread sums: its units are ulo..uhi
  const int l = blk.z + threadIdx.x;
  const bool owner = l < blk.w;
  const int ulo = owner ? locus_unit0[l] : 0;
  const int uhi = owner ? locus_unit0[l + 1] : 0;
  double acc = 0.0;

  for (int base = blk.x; base < u1; base += warps) {
    const int u = base + warp;
    if (u < u1) {
      const int4 unit = a.units[u];
      // asked for before the walk, so that it does not wait after it
      const int s = unit.y + lane;
      const R w = (lane < unit.z && s < W)
                      ? weights[static_cast<int64_t>(unit.x) * W + s]
                      : R(0);
      const R site = UnitWalk<R, FAM, C, SHARED>::run(
          a, block_state + warp * stride, u, unit, lane);
      const double p =
          warp_sum(static_cast<double>(w) * static_cast<double>(site));
      if (lane == 0) part[warp] = p;
    }
    __syncthreads();
    const int lo = ulo > base ? ulo : base;
    const int hi = uhi < base + warps ? uhi : base + warps;
    for (int v = lo; v < hi; ++v) acc += part[v - base];
    __syncthreads();
  }
  if (owner) out[chain_row(a, l)] = static_cast<R>(acc);
}

// The double build: the same blocks, rounds and sums, with
// DoubleBuildWalk (contract.cuh).
template <int FAM, int C, bool SHARED>
__global__ void pack_logl_kernel_f64(TreeArgs<double> a,
                                     const double* weights, int W,
                                     const int4* blocks,
                                     const int* locus_unit0, double* out) {
  extern __shared__ __align__(16) unsigned char block_state[];
  __shared__ double part[kMaxWarps];
  const int lane = threadIdx.x & (kLanes - 1);
  const int warp = threadIdx.x / kLanes;
  const int warps = blockDim.x / kLanes;
  const int4 blk = blocks[blockIdx.x];     // units u0..u1 of loci l0..l1
  const int u1 = blk.y;
  const long long stride =
      warp_layout(a.T, C, Coefs<FAM, double>::K, SHARED, 8).bytes;
  const int l = blk.z + threadIdx.x;
  const bool owner = l < blk.w;
  const int ulo = owner ? locus_unit0[l] : 0;
  const int uhi = owner ? locus_unit0[l + 1] : 0;
  double acc = 0.0;
  for (int base = blk.x; base < u1; base += warps) {
    const int u = base + warp;
    if (u < u1) {
      const int4 unit = a.units[u];
      const int s = unit.y + lane;
      const double w = (lane < unit.z && s < W)
                           ? weights[static_cast<int64_t>(unit.x) * W + s]
                           : 0.0;
      const double site = DoubleBuildWalk<FAM, C, SHARED>::run(
          a, block_state + warp * stride, u, unit, lane);
      const double p = warp_sum(w * site);
      if (lane == 0) part[warp] = p;
    }
    __syncthreads();
    const int lo = ulo > base ? ulo : base;
    const int hi = uhi < base + warps ? uhi : base + warps;
    for (int v = lo; v < hi; ++v) acc += part[v - base];
    __syncthreads();
  }
  if (owner) out[chain_row(a, l)] = acc;
}

__global__ void empty_kernel() {}

template <typename R, int FAM, int C, bool SHARED>
struct Launch {
  static int run(const TreeArgs<R>& a, const R* weights, int W,
                 const int4* blocks, const int* locus_unit0, R* out, int B,
                 int K, int threads, long long shared_bytes,
                 cudaStream_t st) {
    static long long allowed = 48 * 1024;
    const int rc = allow_shared(pack_logl_kernel<R, FAM, C, SHARED>,
                                shared_bytes, &allowed);
    if (rc != 0) return rc;
    pack_logl_kernel<R, FAM, C, SHARED>
        <<<dim3(B, K), threads, shared_bytes, st>>>(
        a, weights, W, blocks, locus_unit0, out);
    return 0;
  }
};

template <int FAM, int C, bool SHARED>
struct Launch<double, FAM, C, SHARED> {
  static int run(const TreeArgs<double>& a, const double* weights, int W,
                 const int4* blocks, const int* locus_unit0, double* out,
                 int B, int K, int threads, long long shared_bytes,
                 cudaStream_t st) {
    static long long allowed = 48 * 1024;
    const int rc = allow_shared(pack_logl_kernel_f64<FAM, C, SHARED>,
                                shared_bytes, &allowed);
    if (rc != 0) return rc;
    pack_logl_kernel_f64<FAM, C, SHARED>
        <<<dim3(B, K), threads, shared_bytes, st>>>(
        a, weights, W, blocks, locus_unit0, out);
    return 0;
  }
};

template <typename R, int FAM, int C, bool SHARED>
struct Occupancy {
  static int run(int threads, long long shared_bytes) {
    return occupancy(pack_logl_kernel<R, FAM, C, SHARED>, threads,
                     shared_bytes);
  }
};

template <int FAM, int C, bool SHARED>
struct Occupancy<double, FAM, C, SHARED> {
  static int run(int threads, long long shared_bytes) {
    return occupancy(pack_logl_kernel_f64<FAM, C, SHARED>, threads,
                     shared_bytes);
  }
};

template <typename R>
int pack_logl(const void* tips, const void* age, const void* blen,
              const void* mu, const void* rates, const void* freqs,
              const void* eigw, const void* eigT, const void* eigTi,
              const void* order, const void* left, const void* right,
              const void* n_seq, const void* units, void* scratch,
              const void* weights, const void* blocks,
              const void* locus_unit0, void* out, int T, int S, int U, int W,
              int B, int C, int fam, int shared, int threads, int K, int L,
              cudaStream_t stream) {
  const TreeArgs<R> a = tree_args<R>(tips, age, blen, mu, rates, freqs, eigw,
                                     eigT, eigTi, order, left, right, n_seq,
                                     units, scratch, T, S, U, L);
  const long long bytes =
      block_shared_bytes(T, C, fam, shared != 0, threads, sizeof(R));
  if (threads < kLanes || threads % kLanes ||
      threads > kMaxWarps * kLanes ||
      bytes + kMaxWarps * 8 > kMaxBlockShared || K < 1 || K > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const int rc = dispatch<Launch, R>(
      fam, C, shared != 0, a, static_cast<const R*>(weights), W,
      static_cast<const int4*>(blocks), static_cast<const int*>(locus_unit0),
      static_cast<R*>(out), B, K, threads, bytes, stream);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int bpp_pack_max_cats() { return bpp::kMaxCats; }

// Shared memory one warp needs for this tree size under either store, in
// float (dbl = 0) or double.
extern "C" long long bpp_pack_warp_bytes(int T, int C, int fam, int shared,
                                         int dbl) {
  return bpp::block_shared_bytes(T, C, fam, shared != 0, bpp::kLanes,
                                 dbl ? 8 : 4);
}

// Blocks of `threads` one SM holds of the build's kernel for this family,
// category count and store, with `bytes` of dynamic shared memory (the
// launch plan's); -1 on an error.
extern "C" int bpp_pack_occupancy(int C, int fam, int shared, int threads,
                                  int dbl, long long bytes) {
  return dbl ? bpp::dispatch<Occupancy, double>(fam, C, shared != 0,
                                                threads, bytes)
             : bpp::dispatch<Occupancy, float>(fam, C, shared != 0, threads,
                                               bytes);
}

extern "C" int bpp_pack_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bpp_pack_logl(
    const void* tips, const void* age, const void* blen, const void* mu,
    const void* rates, const void* freqs, const void* eigw, const void* eigT,
    const void* eigTi, const void* order, const void* left,
    const void* right, const void* n_seq, const void* units, void* scratch,
    const void* weights, const void* blocks, const void* locus_unit0,
    void* out, int T, int S, int U, int W, int B, int C, int fam, int shared,
    int threads, int dbl, int K, int L, void* stream) {
  if (B <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dbl ? pack_logl<double>(tips, age, blen, mu, rates, freqs, eigw,
                                 eigT, eigTi, order, left, right, n_seq,
                                 units, scratch, weights, blocks,
                                 locus_unit0, out, T, S, U, W, B, C, fam,
                                 shared, threads, K, L, st)
             : pack_logl<float>(tips, age, blen, mu, rates, freqs, eigw,
                                eigT, eigTi, order, left, right, n_seq,
                                units, scratch, weights, blocks, locus_unit0,
                                out, T, S, U, W, B, C, fam, shared, threads,
                                K, L, st);
}
