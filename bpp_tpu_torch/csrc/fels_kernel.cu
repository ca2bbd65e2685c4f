// Per-pattern Felsenstein pruning log-likelihoods [L, S] for 4-state data
// (f32): the likelihood pass of batches that carry a diploid resolution
// map, whose phase resolutions are averaged per weight pattern outside
// the kernel (core/felsenstein.py `reduce_root`).
//
// Replaces the TPU kernel K2: bpp_tpu/core/pallas_fels.py `_make_kernel`
// (launched by `site_logl_pallas`).  It computes what K2 computes, not
// K2's layout: there each grid cell was one (locus, 128-pattern tile)
// holding the whole CLV table in the core's fast memory, with A-major
// tips padded to 128 lanes; here there are no tiles and no padding of
// the pattern axis.
//
// Design (first, simple version):
//   * one thread per (locus, pattern); a block is 128 neighbouring
//     patterns of one locus, the grid is L * ceil(S / 128) blocks;
//   * a thread walks its pattern up the locus's gene tree with
//     `Locus::site_logl` of contract.cuh, shared with kernel K1
//     (pack_kernel.cu): children by node id, CLVs as float4 in a global
//     scratch [L, T-1, C, S], P(t)·x by model family from expm1 factors,
//     a rescale at every level, levels k >= n_seq - 1 skipped, a
//     one-sequence locus rooted at tip 0;
//   * patterns s >= n_pat[l] write exactly 0 and do no work; a block
//     whose 128 patterns all lie past n_pat[l] returns after its store.
//
// What bounds it on an H100: a pass reads the tip partials once (16 B
// per tip and pattern) and writes 4 B per pattern, a few tens of MB at
// 1000 loci of 16 tips and some hundreds of patterns, so the byte bound
// is tens of microseconds and the operation bound is below it.  This
// version also writes and re-reads every inner CLV through the scratch
// (16 B x C per inner node and pattern, several times the tips), so its
// own traffic, not the function's, sets its time.  Keeping the CLVs of a
// pattern in registers or shared memory is later work.
//
// C interface (built with nvcc into a shared library, loaded by ctypes
// from bpp_tpu_torch/core/fels.py): bpp_fels_site_logl returns the value
// of cudaGetLastError() right after the launch.

#include "contract.cuh"

namespace {

using namespace bpp;

constexpr int kThreads = 128;

template <int FAM, int C>
__global__ void fels_site_logl_kernel(TreeArgs a, const int64_t* n_pat,
                                      float* out) {
  const int tiles = (a.S + kThreads - 1) / kThreads;
  const int64_t l = blockIdx.x / tiles;
  const int s = (blockIdx.x % tiles) * kThreads + threadIdx.x;
  if (s >= a.S) return;
  float* dst = out + l * a.S + s;
  if (s >= n_pat[l]) {
    *dst = 0.0f;
    return;
  }
  Locus<FAM, C> loc;
  loc.load(a, l);
  *dst = loc.site_logl(s);
}

template <int FAM, int C>
struct Launch {
  static void run(const TreeArgs& a, const int64_t* n_pat, float* out, int L,
                  cudaStream_t st) {
    const int tiles = (a.S + kThreads - 1) / kThreads;
    fels_site_logl_kernel<FAM, C><<<L * tiles, kThreads, 0, st>>>(a, n_pat,
                                                                 out);
  }
};

}  // namespace

extern "C" int bpp_fels_max_cats() { return bpp::kMaxCats; }

extern "C" int bpp_fels_site_logl(
    const void* tips, const void* efac, const void* coefs, const void* eigT,
    const void* eigTi, const void* freqs, const void* order,
    const void* left, const void* right, const void* n_seq,
    const void* n_pat, void* scratch, void* out, int L, int T, int S, int C,
    int fam, void* stream) {
  if (L <= 0 || S <= 0) return 0;
  const TreeArgs a = tree_args(tips, efac, coefs, eigT, eigTi, freqs, order,
                               left, right, n_seq, scratch, T, S);
  const int rc = dispatch<Launch>(
      fam, C, a, static_cast<const int64_t*>(n_pat),
      static_cast<float*>(out), L, static_cast<cudaStream_t>(stream));
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
