// The two serial accept chains over loci, in double, on the card: K3
// `notheta_chain` (integrated thetas) and K4 `gammadir_chain` (the
// Gamma-Dirichlet locus rates mu_i and variances nu_i).
//
// They replace no Pallas kernel.  Each replaces a scan over loci of
// bpp_tpu's jitted step: K3 bpp_tpu/mcmc/notheta.py `scan_accept` (:49-89,
// the scan at :86), whose carry is the per-population sums K_h / C_h; K4
// bpp_tpu/mcmc/clock_moves.py's scans at :212 and :296, whose carry is the
// running sum of mu_i (nu_i).  The port ran both on the host (one copy of
// the chain's inputs to the host and one of the mask back a call), which
// kept every schedule with such a chain off the captured step.
//
// What bounds them on an H100: neither bytes nor operations.  Each locus's
// decision depends on the carry the previous one left, so a chain is L
// dependent steps; a call reads (4H + 4) x 8 bytes a locus (K3) or 48 (K4)
// and writes one byte a locus, a few microseconds of HBM time at 1000
// loci.  One step's latency sets the time: K3 a few lgamma/log evaluations
// (only for the populations the locus changes), a shuffle reduction over
// the warp and a broadcast; K4 one log and a few flops on one lane.
//
// Design: one warp.  The warp stages tiles of whole loci into shared
// memory with coalesced loads, so the serial walk reads shared memory only.
//   * K3: lane h owns populations h, h + 32, ... (K_h, C_h and the cached
//     term lgamma(a + K_h) - (a + K_h) log(b + C_h) in shared memory).  At
//     a proposing locus each lane evaluates the term of each of its
//     populations whose row changed, the warp sums the differences (lane
//     0's sum is broadcast, so every lane takes the same decision), and on
//     accept each lane updates its populations.
//   * K4: the lanes sum mu_i (nu_i) over the proposing loci and count them,
//     then for each tile compute every locus's own part of ln acceptance
//     (the log ratio and the locus-factorizing terms) in parallel; lane 0
//     walks the tile carrying the running sum.
// The plain versions are notheta.accept_chain and
// clock_moves._gammadir_chain (float64 on the host); the results differ
// from them only where a margin is within the ulps by which the card's
// lgamma/log differ from the host's.

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;
constexpr unsigned kFull = 0xffffffffu;
// shared memory a tile of loci may take (the staged rows): below the 48 KB
// that needs no opt-in
constexpr int kTileBytes = 40 * 1024;

__device__ __forceinline__ double notheta_term(double a, double b, double k,
                                               double c) {
  return lgamma(a + k) - (a + k) * log(b + c);
}

__device__ __forceinline__ double warp_sum(double x) {
  for (int off = kLanes / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(kFull, x, off);
  // lanes may differ in the last bits: take lane 0's
  return __shfl_sync(kFull, x, 0);
}

// cols [L, 4H + 4]: per locus co[H], cn[H], to[H], tn[H], dother, dh, logu,
// mask (> 0.5: the locus proposes); sums [2H]: K0, C0.  accept [L] bytes.
__global__ void notheta_chain_kernel(const double* __restrict__ cols,
                                     const double* __restrict__ sums, int L,
                                     int H, double a, double b, int tile,
                                     unsigned char* __restrict__ accept) {
  extern __shared__ double sm[];
  double* K = sm;
  double* C = K + H;
  double* g = C + H;
  double* Kn = g + H;
  double* Cn = Kn + H;
  double* gn = Cn + H;
  double* chg = gn + H;
  double* rows = chg + H;
  const int lane = threadIdx.x;
  const int W = 4 * H + 4;
  for (int h = lane; h < H; h += kLanes) {
    K[h] = sums[h];
    C[h] = sums[H + h];
    g[h] = notheta_term(a, b, K[h], C[h]);
  }
  __syncwarp();
  for (int i0 = 0; i0 < L; i0 += tile) {
    const int n = min(tile, L - i0);
    const double* src = cols + static_cast<size_t>(i0) * W;
    for (int j = lane; j < n * W; j += kLanes) rows[j] = src[j];
    __syncwarp();
    for (int r = 0; r < n; ++r) {
      const double* row = rows + r * W;
      if (!(row[4 * H + 3] > 0.5)) {
        if (lane == 0) accept[i0 + r] = 0;
        continue;
      }
      double part = 0.0;
      for (int h = lane; h < H; h += kLanes) {
        const double dk = row[H + h] - row[h];
        const double dc = row[3 * H + h] - row[2 * H + h];
        chg[h] = 0.0;
        if (dk != 0.0 || dc != 0.0) {
          const double k = K[h] + dk, c = C[h] + dc;
          const double x = notheta_term(a, b, k, c);
          part += x - g[h];
          Kn[h] = k;
          Cn[h] = c;
          gn[h] = x;
          chg[h] = 1.0;
        }
      }
      const double dlg = warp_sum(part);
      const double rhs = row[4 * H] + row[4 * H + 1];
      const bool acc = row[4 * H + 2] < rhs + dlg;
      if (acc) {
        for (int h = lane; h < H; h += kLanes) {
          if (chg[h] != 0.0) {
            K[h] = Kn[h];
            C[h] = Cn[h];
            g[h] = gn[h];
          }
        }
      }
      if (lane == 0) accept[i0 + r] = acc ? 1 : 0;
    }
    __syncwarp();
  }
}

// terms [L, 6]: per locus old value, new value, log proposal ratio,
// locus-factorizing density delta, uniform draw, mask (> 0.5: proposes).
// accept [L] bytes.
__global__ void gammadir_chain_kernel(const double* __restrict__ terms, int L,
                                      double a_bar, double b_bar, double a_i,
                                      int tile,
                                      unsigned char* __restrict__ accept) {
  extern __shared__ double sm[];
  double* mo = sm;
  double* mn = mo + tile;
  double* lratio = mn + tile;
  double* logu = lratio + tile;
  double* mask = logu + tile;
  const int lane = threadIdx.x;
  double sum = 0.0, count = 0.0;
  for (int i = lane; i < L; i += kLanes) {
    if (terms[6 * i + 5] > 0.5) {
      sum += terms[6 * i];
      count += 1.0;
    }
  }
  double sum_mu = warp_sum(sum);
  const double nl = warp_sum(count);
  const double terma = a_i * nl, termb = b_bar / nl;
  for (int i0 = 0; i0 < L; i0 += tile) {
    const int n = min(tile, L - i0);
    for (int j = lane; j < n; j += kLanes) {
      const double* t = terms + 6 * static_cast<size_t>(i0 + j);
      mo[j] = t[0];
      mn[j] = t[1];
      lratio[j] = (a_i - 1.0) * log(t[1] / t[0]) + t[2] + t[3];
      logu[j] = log(t[4]);
      mask[j] = t[5];
    }
    __syncwarp();
    if (lane == 0) {
      for (int j = 0; j < n; ++j) {
        bool acc = false;
        if (mask[j] > 0.5) {
          const double sum_new = sum_mu + mn[j] - mo[j];
          const double lnacc = (a_bar - terma) * log(sum_new / sum_mu)
                               - termb * (sum_new - sum_mu) + lratio[j];
          acc = logu[j] < lnacc;
          if (acc) sum_mu = sum_new;
        }
        accept[i0 + j] = acc ? 1 : 0;
      }
    }
    __syncwarp();
  }
}

}  // namespace

// Loci a K3 tile holds for H populations; 0 when the state alone does not
// fit the shared budget.
extern "C" int bpp_notheta_tile(int H) {
  const long long state = 7LL * H * 8;
  const long long row = (4LL * H + 4) * 8;
  const long long left = kTileBytes - state;
  if (left < row) return 0;
  return static_cast<int>(left / row < 256 ? left / row : 256);
}

extern "C" int bpp_notheta_chain(const void* cols, const void* sums, int L,
                                 int H, double a, double b, void* accept,
                                 void* stream) {
  if (L <= 0) return 0;
  const int tile = bpp_notheta_tile(H);
  if (tile <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = (7 * static_cast<size_t>(H)
                        + static_cast<size_t>(tile) * (4 * H + 4)) * 8;
  notheta_chain_kernel<<<1, kLanes, bytes,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(cols), static_cast<const double*>(sums), L,
      H, a, b, tile, static_cast<unsigned char*>(accept));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bpp_gammadir_chain(const void* terms, int L, double a_bar,
                                  double b_bar, double a_i, void* accept,
                                  void* stream) {
  if (L <= 0) return 0;
  const int tile = kTileBytes / (5 * 8);
  gammadir_chain_kernel<<<1, kLanes, static_cast<size_t>(tile) * 5 * 8,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(terms), L, a_bar, b_bar, a_i, tile,
      static_cast<unsigned char*>(accept));
  return static_cast<int>(cudaGetLastError());
}
