// Per-pattern Felsenstein pruning log-likelihoods [L, S] for 4-state data,
// in float or (for --x64) double, instantiations of one template: the
// likelihood pass of batches that carry a diploid resolution
// map, whose phase resolutions are averaged per weight pattern outside
// the kernel (core/felsenstein.py `reduce_root`).
//
// Replaces the TPU kernel K2: bpp_tpu/core/pallas_fels.py `_make_kernel`
// (launched by `site_logl_pallas`).  It computes what K2 computes, not
// K2's layout: there each grid cell was one (locus, 128-pattern tile)
// holding the whole CLV table in the core's fast memory, with A-major
// tips padded to 128 lanes and the exponential factors precomputed by a
// separate elementwise pass.
//
// What bounds it on an H100: bytes.  A pass must read each real tip
// partial once (16 B per tip and pattern: ~20 MB at 1000 loci of 16 tips
// and ~79 real patterns) and write 4 B per column of [L, S]; the
// operations take less time than that.  What it costs beyond the bound is
// latency (T-1 dependent levels per pattern) and, with 4 or more rate
// categories, instruction throughput at the few warps an SM then holds.
//
// Design, with the device code of contract.cuh (shared with K1):
//   * one warp per unit = (locus, chunk of up to 32 real patterns), from
//     the unit table of core/units.py; a block is 2, 4 or 8 consecutive
//     units, so no lane is launched on the padded part of the pattern
//     axis;
//   * the warp computes its locus's branch lengths, expm1 factors and CLV
//     slot plan into shared memory, keeps its patterns' CLVs in shared
//     memory (SHARED store) or in a device scratch (for trees whose CLVs
//     do not fit in 227 KB), reads each tip once two levels ahead of its
//     use, and walks the tree;
//   * lanes of real patterns write their value; the last unit of a locus
//     also writes exactly 0 to every column s >= n_pat[l], so the whole
//     [L, S] output is written by the kernel (every locus has at least
//     one unit, with no real pattern when n_pat[l] = 0).
//
// Shared memory per block: warps x the per-warp bytes listed in
// contract.cuh; at T = 16 and 64 threads, the wrapper's block size, about
// 9 KB (C = 1), 35 KB (C = 4, HKY: six blocks an SM) and 70 KB (C = 8:
// three).
//
// The double build (--x64) has a kernel of its own,
// fels_site_logl_kernel_f64: the same grid and layout with contract.cuh's
// DoubleBuildWalk (DoubleWalk up to 3 categories, UnitWalk's above);
// PERF.md §6 has the measurements it was designed from.
//
// Chains (chains = K): a launch takes K chains' trees and parameters at
// once, a grid row (blockIdx.y) a chain, and writes out [K, L, S]; the
// tips and the unit table are read by every row (contract.cuh TreeArgs).
// Chain k's rows equal a one-chain launch on chain k's tensors bit for
// bit.
//
// C interface (built with nvcc into a shared library, loaded by ctypes
// from bpp_tpu_torch/core/fels.py): bpp_fels_site_logl (dbl = 1: the
// double build; K chains of L loci) returns the value of cudaGetLastError() right after the
// launch.

#include "contract.cuh"

namespace {

using namespace bpp;

template <typename R, int FAM, int C, bool SHARED>
__global__ void fels_site_logl_kernel(TreeArgs<R> a, R* out) {
  extern __shared__ __align__(16) unsigned char block_state[];
  const int lane = threadIdx.x & (kLanes - 1);
  const int warp = threadIdx.x / kLanes;
  const int u = blockIdx.x * (blockDim.x / kLanes) + warp;
  if (u >= a.U) return;
  const int4 unit = a.units[u];
  const long long stride =
      warp_layout(a.T, C, Coefs<FAM, R>::K, SHARED, sizeof(R)).bytes;
  const R v = UnitWalk<R, FAM, C, SHARED>::run(
      a, block_state + warp * stride, u, unit, lane);
  R* row = out + chain_row(a, unit.x) * a.S;
  if (lane < unit.z) row[unit.y + lane] = v;
  if (unit.w)
    for (int s = unit.y + unit.z + lane; s < a.S; s += kLanes) row[s] = R(0);
}

// The double build: the same grid, with DoubleBuildWalk (contract.cuh).
template <int FAM, int C, bool SHARED>
__global__ void fels_site_logl_kernel_f64(TreeArgs<double> a, double* out) {
  extern __shared__ __align__(16) unsigned char block_state[];
  const int lane = threadIdx.x & (kLanes - 1);
  const int warp = threadIdx.x / kLanes;
  const int u = blockIdx.x * (blockDim.x / kLanes) + warp;
  if (u >= a.U) return;
  const int4 unit = a.units[u];
  const long long stride =
      warp_layout(a.T, C, Coefs<FAM, double>::K, SHARED, 8).bytes;
  const double v = DoubleBuildWalk<FAM, C, SHARED>::run(
      a, block_state + warp * stride, u, unit, lane);
  double* row = out + chain_row(a, unit.x) * a.S;
  if (lane < unit.z) row[unit.y + lane] = v;
  if (unit.w)
    for (int s = unit.y + unit.z + lane; s < a.S; s += kLanes) row[s] = 0.0;
}

template <typename R, int FAM, int C, bool SHARED>
struct Launch {
  static int run(const TreeArgs<R>& a, R* out, int K, int threads,
                 long long shared_bytes, cudaStream_t st) {
    static long long allowed = 48 * 1024;
    const int rc = allow_shared(fels_site_logl_kernel<R, FAM, C, SHARED>,
                                shared_bytes, &allowed);
    if (rc != 0) return rc;
    const int warps = threads / kLanes;
    fels_site_logl_kernel<R, FAM, C, SHARED>
        <<<dim3((a.U + warps - 1) / warps, K), threads, shared_bytes, st>>>(
            a, out);
    return 0;
  }
};

template <int FAM, int C, bool SHARED>
struct Launch<double, FAM, C, SHARED> {
  static int run(const TreeArgs<double>& a, double* out, int K,
                 int threads, long long shared_bytes, cudaStream_t st) {
    static long long allowed = 48 * 1024;
    const int rc = allow_shared(fels_site_logl_kernel_f64<FAM, C, SHARED>,
                                shared_bytes, &allowed);
    if (rc != 0) return rc;
    const int warps = threads / kLanes;
    fels_site_logl_kernel_f64<FAM, C, SHARED>
        <<<dim3((a.U + warps - 1) / warps, K), threads, shared_bytes, st>>>(
            a, out);
    return 0;
  }
};

template <typename R, int FAM, int C, bool SHARED>
struct Occupancy {
  static int run(int threads, long long shared_bytes) {
    return occupancy(fels_site_logl_kernel<R, FAM, C, SHARED>, threads,
                     shared_bytes);
  }
};

template <int FAM, int C, bool SHARED>
struct Occupancy<double, FAM, C, SHARED> {
  static int run(int threads, long long shared_bytes) {
    return occupancy(fels_site_logl_kernel_f64<FAM, C, SHARED>, threads,
                     shared_bytes);
  }
};

template <typename R>
int fels_site_logl(const void* tips, const void* age, const void* blen,
                   const void* mu, const void* rates, const void* freqs,
                   const void* eigw, const void* eigT, const void* eigTi,
                   const void* order, const void* left, const void* right,
                   const void* n_seq, const void* units, void* scratch,
                   void* out, int T, int S, int U, int C, int fam, int shared,
                   int threads, int K, int L, cudaStream_t stream) {
  const TreeArgs<R> a = tree_args<R>(tips, age, blen, mu, rates, freqs, eigw,
                                     eigT, eigTi, order, left, right, n_seq,
                                     units, scratch, T, S, U, L);
  const long long bytes =
      block_shared_bytes(T, C, fam, shared != 0, threads, sizeof(R));
  if (threads < kLanes || threads % kLanes || bytes > kMaxBlockShared ||
      K < 1 || K > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const int rc = dispatch<Launch, R>(fam, C, shared != 0, a,
                                     static_cast<R*>(out), K, threads,
                                     bytes, stream);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int bpp_fels_max_cats() { return bpp::kMaxCats; }

// Shared memory one warp needs for this tree size under either store, in
// float (dbl = 0) or double.
extern "C" long long bpp_fels_warp_bytes(int T, int C, int fam, int shared,
                                         int dbl) {
  return bpp::block_shared_bytes(T, C, fam, shared != 0, bpp::kLanes,
                                 dbl ? 8 : 4);
}

// Blocks of `threads` one SM holds of the build's kernel for this family,
// category count and store, with `bytes` of dynamic shared memory (the
// launch plan's); -1 on an error.
extern "C" int bpp_fels_occupancy(int C, int fam, int shared, int threads,
                                  int dbl, long long bytes) {
  return dbl ? bpp::dispatch<Occupancy, double>(fam, C, shared != 0,
                                                threads, bytes)
             : bpp::dispatch<Occupancy, float>(fam, C, shared != 0, threads,
                                               bytes);
}

extern "C" int bpp_fels_site_logl(
    const void* tips, const void* age, const void* blen, const void* mu,
    const void* rates, const void* freqs, const void* eigw, const void* eigT,
    const void* eigTi, const void* order, const void* left,
    const void* right, const void* n_seq, const void* units, void* scratch,
    void* out, int T, int S, int U, int C, int fam, int shared, int threads,
    int dbl, int K, int L, void* stream) {
  if (U <= 0 || S <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dbl ? fels_site_logl<double>(tips, age, blen, mu, rates, freqs,
                                      eigw, eigT, eigTi, order, left, right,
                                      n_seq, units, scratch, out, T, S, U, C,
                                      fam, shared, threads, K, L, st)
             : fels_site_logl<float>(tips, age, blen, mu, rates, freqs, eigw,
                                     eigT, eigTi, order, left, right, n_seq,
                                     units, scratch, out, T, S, U, C, fam,
                                     shared, threads, K, L, st);
}
