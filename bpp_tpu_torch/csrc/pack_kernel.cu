// Per-locus Felsenstein pruning log-likelihood for 4-state data (f32).
//
// Replaces the TPU kernel K1: bpp_tpu/core/pallas_pack.py
// `_make_kernel` (launched by `site_logl_packed`).  It computes what K1
// computes, not K1's layout: the 8-lane segments, 256-lane tiles,
// sublane rolls and one-hot level-slot select chains existed for the
// TPU's vector registers and are gone.
//
// Design (first, simple version):
//   * one block per locus, one thread per site pattern (a thread loops
//     over patterns when a locus has more than the block holds);
//   * a thread walks its pattern up the locus's gene tree with
//     `Locus::site_logl` of contract.cuh, which this kernel shares with
//     the per-pattern kernel K2 (fels_kernel.cu): children by node id,
//     CLVs as float4 in a global scratch, P(t)·x by model family from
//     expm1 factors, a rescale at every level;
//   * the site value is weighted by the pattern count and summed per
//     locus in the same block by a fixed-order tree reduction (in
//     double): a flat per-locus sum, no floating-point atomics, so a
//     chain is reproducible.
//
// What bounds it on an H100: at the bench shapes (1000 loci, 16 tips,
// 32 patterns) one pass moves ~9 MB (the tip partials dominate) and does
// a few MFLOP, so the byte bound is a few microseconds.  The kernel is
// bound by latency instead: each thread runs 15 dependent levels, each
// waiting on two child reads from L2 (the 16 MB scratch stays in the
// 50 MB L2), and 1000 one-warp blocks fill a small share of the card's
// warp slots.  Packing several loci per block and keeping the CLVs in
// shared memory or registers is later work.
//
// C interface (built with nvcc into a shared library, loaded by ctypes
// from bpp_tpu_torch/core/pack.py): bpp_pack_logl returns the value of
// cudaGetLastError() right after the launch.

#include "contract.cuh"

namespace {

using namespace bpp;

__device__ __forceinline__ double warp_sum(double v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

template <int FAM, int C>
__global__ void pack_logl_kernel(TreeArgs a, const float* weights, int W,
                                 float* out) {
  const int64_t l = blockIdx.x;
  Locus<FAM, C> loc;
  loc.load(a, l);

  double acc = 0.0;
  for (int s = threadIdx.x; s < a.S; s += blockDim.x) {
    const float site = loc.site_logl(s);
    const float w = s < W ? weights[l * W + s] : 0.0f;
    acc += static_cast<double>(w) * static_cast<double>(site);
  }

  // fixed-order block reduction: warp shuffles, then one warp over the
  // per-warp partials
  __shared__ double part[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  acc = warp_sum(acc);
  if (lane == 0) part[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    const int nw = (blockDim.x + 31) >> 5;
    double v = lane < nw ? part[lane] : 0.0;
    v = warp_sum(v);
    if (lane == 0) out[l] = static_cast<float>(v);
  }
}

template <int FAM, int C>
struct Launch {
  static void run(const TreeArgs& a, const float* weights, int W, float* out,
                  int L, int threads, cudaStream_t st) {
    pack_logl_kernel<FAM, C><<<L, threads, 0, st>>>(a, weights, W, out);
  }
};

}  // namespace

extern "C" int bpp_pack_max_cats() { return bpp::kMaxCats; }

extern "C" int bpp_pack_logl(
    const void* tips, const void* efac, const void* coefs, const void* eigT,
    const void* eigTi, const void* freqs, const void* weights,
    const void* order, const void* left, const void* right,
    const void* n_seq, void* scratch, void* out, int L, int T, int S, int W,
    int C, int fam, void* stream) {
  if (L <= 0) return 0;
  const TreeArgs a = tree_args(tips, efac, coefs, eigT, eigTi, freqs, order,
                               left, right, n_seq, scratch, T, S);
  int threads = ((S + 31) / 32) * 32;
  if (threads > 256) threads = 256;
  if (threads < 32) threads = 32;
  const int rc = dispatch<Launch>(
      fam, C, a, static_cast<const float*>(weights), W,
      static_cast<float*>(out), L, threads,
      static_cast<cudaStream_t>(stream));
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
