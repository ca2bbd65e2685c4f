// The two serial accept chains over loci, in double, on the card: K3
// `notheta_chain` (integrated thetas) and K4 `gammadir_chain` (the
// Gamma-Dirichlet locus rates mu_i and variances nu_i).
//
// They replace no Pallas kernel.  Each replaces a scan over loci of
// bpp_tpu's jitted step: K3 bpp_tpu/mcmc/notheta.py `scan_accept` (:49-89,
// the scan at :86), whose carry is the per-population sums K_h / C_h; K4
// bpp_tpu/mcmc/clock_moves.py's scans at :212 and :296, whose carry is the
// running sum of mu_i (nu_i).  The plain versions are notheta.accept_chain
// and clock_moves._gammadir_chain (float64 on the host).
//
// What bounds them on an H100: neither bytes nor operations.  A call reads
// (4H + 4) x 8 bytes a locus (K3) or 48 (K4) and writes one byte a locus,
// a few microseconds of HBM time at 1000 loci; each locus's decision
// depends on the carry the decisions before it left, so the time is the
// latency of the dependent evaluations: K3 lgamma(a + K) - (a + K)
// log(b + C) of each population the locus changes, before and after it
// (a double log takes ~270 cycles, lgamma ~350), and a compare; K4 a
// division, a log and a compare.  Walking one locus at a time with one
// warp, one such evaluation, a shuffle reduction and a shared-memory round
// trip took ~1 us a locus.
//
// Design: one block of 8 warps a chain.  Under chains = K one launch
// takes the K chains' rows stacked, a block a chain (blockIdx.x); a block
// reads and writes only its own chain's rows, so each chain's decisions
// are those of a one-chain launch on its rows, bit for bit, and the K
// walks run side by side on K SMs.
//   * Staging, off the chain.  The walker warps walk tile k of the loci
//     from shared memory while the other warps stage tile k + 1 (double
//     buffering): per locus everything that does not depend on the carry,
//     i.e. K3's count and waiting-sum differences dk/dc [H], the list of
//     the populations it changes in ascending h, log u and rhs = dother +
//     dh; K4's old and new value, log u and the locus's own part of ln
//     acceptance.  Loci that do not propose get 0, and K3's loci that
//     propose but change no population are decided there (log u < rhs);
//     the rest are compacted, in order, into the tile's chain.
//   * Lookahead, on the chain.  A round resolves the next D loci of the
//     chain at once.  Node j of a heap of 2^D - 1 evaluates, at depth m
//     (node 2^m - 1 + p), locus i + m under the carry left by the
//     accept/reject pattern p of loci i .. i+m-1 (bit m-1-l of p: locus
//     i + l accepted), built by the same additions in the same order as
//     the one-locus-a-step walk, so its decision is the walk's if that is
//     the real pattern.  One ballot gathers the decisions and the real
//     path is followed through them (node 2 idx + 1 + accepted); the carry
//     advances along it.  A round costs about one evaluation, so the chain
//     pays ~1/D of an evaluation a locus.
//   * D = 5 (kDepth), the deepest round whose heap (31 nodes) fits one
//     warp: one ballot holds a round's decisions, and the carry moves by
//     a shuffle.
//   * K4: one warp walks, its thread j node j, and loads its next round's
//     inputs before the current round's decisions are gathered; seven
//     stage.
//   * K3: a node's work is one difference of terms per population its
//     locus changes, so a round's work items (node, population) go one a
//     thread to six item warps; the decider warp (a thread a node) sums
//     each node's differences in ascending h, as the plain version does,
//     decides, follows the real path and advances the carry, while the
//     item threads load the next round's inputs but the carry; one warp
//     stages.  An item evaluates its population's term after and before the
//     locus side by side (the same function of the same K, C as the walk's
//     cached term, so the same bits); lgamma(a + K) comes from a table of
//     K0 +- M counts built when the launch starts (the entry for K is
//     lgamma(a + K) itself, so the same bits), and a K outside it is
//     evaluated out of line, so the two terms' table reads and logs run
//     side by side without a branch.
//   * The arithmetic is written with _rn intrinsics, so no multiply-add is
//     contracted where the host rounds twice.  The kernels and the plain
//     versions then differ only by the ulps of the card's lgamma/log
//     against the host's: a decision whose margin is within them may
//     differ, and the chains part there.
// K4's first pass sums mu_i (nu_i) over the proposing loci across the
// block, in another order than numpy's: its last bits may differ.
// Shared memory (K3): ~(18H + 22) bytes a locus of a tile, two tiles of up
// to 256 loci, the carry, the round's differences 8H (2^D - 1) and the
// table (up to a quarter of the block's); where H populations leave no
// room the depth is lowered (below 5 from 735 populations), and from
// 3,054 populations not even D = 1 fits and the launch is refused
// (bpp_notheta_depth returns 0).

#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kLanes = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * kLanes;
// the loci a round resolves (K3 fewer where H populations leave too little
// shared memory: k3_layout)
constexpr int kDepth = 5;
// the dynamic shared memory a block may take on an H100
constexpr int kSharedMax = 232448;
constexpr int kSharedDefault = 48 * 1024;
constexpr int kK3MaxTile = 256;
// K3's table of lgamma(a + k) holds K0 +- this many counts a population
constexpr int kTableHalf = 128;
// K3: 7 warps walk (deciders, then items), 1 stages the next tile
constexpr int kK3Walkers = kThreads - kLanes;
constexpr int kK4Tile = 512;
constexpr int kHeader = 256;

__host__ __device__ constexpr int heap_nodes(int depth) {
  return (1 << depth) - 1;
}

// a round's nodes are one warp's threads
static_assert(kDepth >= 1 && heap_nodes(kDepth) <= kLanes, "depth");

__host__ __device__ constexpr size_t align16(size_t n) {
  return (n + 15) & ~static_cast<size_t>(15);
}

// scalars the threads exchange: tile counts and K4's first pass's per-warp
// partial sums
struct Header {
  int count[2];
  double part[kWarps];
  double nprop[kWarps];
};
static_assert(sizeof(Header) <= kHeader, "header");

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// barrier 0: the block; 1: K4's staging warps; 2: K3's walker warps

__device__ __forceinline__ double warp_sum(double x) {
  for (int off = kLanes / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(kFull, x, off);
  // lanes may differ in the last bits: take lane 0's
  return __shfl_sync(kFull, x, 0);
}

// The real path through a round's heap of decisions (bit j of `ballot`
// node j's): bit l of the result is locus i + l's decision; *last the node
// of the deepest accepted one (-1: none accepted).
__device__ __forceinline__ unsigned follow(unsigned ballot, int depth,
                                           int* last) {
  unsigned bits = 0;
  int idx = 0;
  *last = -1;
  for (int l = 0; l < depth; ++l) {
    const int x = (ballot >> idx) & 1;
    bits |= static_cast<unsigned>(x) << l;
    if (x) *last = idx;
    idx = 2 * idx + 1 + x;
  }
  return bits;
}

// ---------------------------------------------------------------- K3 ----

// One tile of staged K3 loci (R of them).
struct K3Tile {
  double* dk;              // [R][H] count differences
  double* dc;              // [R][H] scaled waiting-sum differences
  double* lhs;             // [R] log u
  double* rhs;             // [R] dother + dh
  int* nchg;               // [R] populations changed; -1: off the chain
  unsigned short* hidx;    // [R][H] the changed populations, ascending
  unsigned short* order;   // the chain: tile positions in locus order
  int* count;              // its length
};

__host__ __device__ inline size_t k3_tile_bytes(int R, int H) {
  return align16(static_cast<size_t>(R) * (16 * static_cast<size_t>(H) + 16))
         + align16(static_cast<size_t>(R) * 4)
         + align16(static_cast<size_t>(R) * 2 * H)
         + align16(static_cast<size_t>(R) * 2);
}

// A K3 launch's shared memory: the header; the carry K, C [H] and the
// table's first counts kbase [H]; the round's differences of terms
// [nodes][H]; the table lgamma(a + kbase_h + i) [H][2M + 1]; two tiles of
// R loci.
struct K3Layout {
  int depth, R, M;
};

__host__ __device__ inline size_t k3_fixed_bytes(int H, int depth, int M) {
  return kHeader + align16(24 * static_cast<size_t>(H))
         + align16(8 * static_cast<size_t>(H) * heap_nodes(depth))
         + align16(8 * static_cast<size_t>(H) * (2 * M + 1));
}

__host__ __device__ inline size_t k3_shared_bytes(const K3Layout& k, int H) {
  return k3_fixed_bytes(H, k.depth, k.M) + 2 * k3_tile_bytes(k.R, H);
}

// The deepest layout up to kDepth that fits: a table of up to +-kTableHalf
// counts around K0 in at most a quarter of the shared memory (none where
// it would not leave a tile of one locus), tiles of up to kK3MaxTile loci.
// depth 0: nothing fits.
K3Layout k3_layout(int H) {
  for (int d = kDepth; d >= 1; --d) {
    const size_t quarter = kSharedMax / 4 / (8 * static_cast<size_t>(H));
    int M = static_cast<int>(std::min<size_t>(
        kTableHalf, quarter > 0 ? (quarter - 1) / 2 : 0));
    for (;; M = 0) {
      K3Layout k{d, 1, M};
      if (k3_shared_bytes(k, H) <= static_cast<size_t>(kSharedMax)) {
        k.R = static_cast<int>(std::min<size_t>(
            kK3MaxTile, (kSharedMax - k3_fixed_bytes(H, d, M))
                            / (2 * (18 * static_cast<size_t>(H) + 22))));
        while (k3_shared_bytes(k, H) > static_cast<size_t>(kSharedMax)) --k.R;
        return k;
      }
      if (M == 0) break;
    }
  }
  return K3Layout{0, 0, 0};
}

__device__ K3Tile k3_tile_at(unsigned char* p, int R, int H, int* count) {
  K3Tile t;
  t.dk = reinterpret_cast<double*>(p);
  t.dc = t.dk + static_cast<size_t>(R) * H;
  t.lhs = t.dc + static_cast<size_t>(R) * H;
  t.rhs = t.lhs + R;
  p += align16(static_cast<size_t>(R) * (16 * static_cast<size_t>(H) + 16));
  t.nchg = reinterpret_cast<int*>(p);
  p += align16(static_cast<size_t>(R) * 4);
  t.hidx = reinterpret_cast<unsigned short*>(p);
  p += align16(static_cast<size_t>(R) * 2 * H);
  t.order = reinterpret_cast<unsigned short*>(p);
  t.count = count;
  return t;
}

// Stage loci i0 .. i0+n-1 (one a thread): differences, changed lists,
// log u and rhs; decide the loci off the chain.
__device__ void k3_stage(const double* __restrict__ cols, int H, int i0,
                         int n, K3Tile t, int tid, int threads,
                         unsigned char* __restrict__ accept) {
  const int W = 4 * H + 4;
  for (int r = tid; r < n; r += threads) {
    const double* row = cols + static_cast<size_t>(i0 + r) * W;
    double* dk = t.dk + static_cast<size_t>(r) * H;
    double* dc = t.dc + static_cast<size_t>(r) * H;
    unsigned short* hidx = t.hidx + static_cast<size_t>(r) * H;
    int cnt = 0;
    for (int h = 0; h < H; ++h) {
      const double k = __dsub_rn(row[H + h], row[h]);
      const double c = __dsub_rn(row[3 * H + h], row[2 * H + h]);
      dk[h] = k;
      dc[h] = c;
      if (k != 0.0 || c != 0.0) hidx[cnt++] = static_cast<unsigned short>(h);
    }
    const double lhs = row[4 * H + 2];
    const double rhs = __dadd_rn(row[4 * H], row[4 * H + 1]);
    const bool prop = row[4 * H + 3] > 0.5;
    t.lhs[r] = lhs;
    t.rhs[r] = rhs;
    t.nchg[r] = prop && cnt > 0 ? cnt : -1;
    // a proposing locus that changes no population adds 0 to ln acceptance
    if (!(prop && cnt > 0)) accept[i0 + r] = prop && lhs < rhs ? 1 : 0;
  }
}

// The chain of a staged tile: its loci on the chain, in order (one warp).
__device__ void k3_order(K3Tile t, int n) {
  const int lane = threadIdx.x & (kLanes - 1);
  int c = 0;
  for (int r0 = 0; r0 < n; r0 += kLanes) {
    const int r = r0 + lane;
    const bool on = r < n && t.nchg[r] >= 0;
    const unsigned bal = __ballot_sync(kFull, on);
    if (on)
      t.order[c + __popc(bal & ((1u << lane) - 1u))] =
          static_cast<unsigned short>(r);
    c += __popc(bal);
  }
  if (lane == 0) *t.count = c;
}

// lgamma(a + k) for a k outside the table: out of line, so that the
// compiler cannot evaluate it beside every table read
__device__ __noinline__ double lgamma_call(double ak) { return lgamma(ak); }

// lgamma(a + k) of population h from the table: the entry is lgamma(a +
// (kbase + i)), and *hit says kbase + i == k (the same bits)
__device__ __forceinline__ double lgamma_table(const double* table,
                                               const double* kbase, int span,
                                               int h, double k, bool* hit) {
  const double off = fmin(fmax(__dsub_rn(k, kbase[h]), 0.0), span - 1.0);
  const int i = static_cast<int>(off);
  *hit = __dadd_rn(kbase[h], static_cast<double>(i)) == k;
  return table[static_cast<size_t>(h) * span + i];
}

// The difference of population h's term lgamma(a + k) - (a + k) log(b + c)
// after its locus (kn, cn) minus before (k, c): both evaluated side by
// side, lgamma from the table where it holds k, else evaluated.
__device__ __forceinline__ double notheta_diff(const double* table,
                                               const double* kbase, int span,
                                               int h, double a, double b,
                                               double k, double c, double kn,
                                               double cn) {
  bool hn, ho;
  double lgn = lgamma_table(table, kbase, span, h, kn, &hn);
  double lgo = lgamma_table(table, kbase, span, h, k, &ho);
  const double akn = __dadd_rn(a, kn), ako = __dadd_rn(a, k);
  const double ln = log(__dadd_rn(b, cn)), lo = log(__dadd_rn(b, c));
  if (!(hn && ho)) {
    if (!hn) lgn = lgamma_call(akn);
    if (!ho) lgo = lgamma_call(ako);
  }
  return __dsub_rn(__dsub_rn(lgn, __dmul_rn(akn, ln)),
                   __dsub_rn(lgo, __dmul_rn(ako, lo)));
}

// The next D loci of a tile's chain: tile positions, changed counts and
// the first item of each depth (depth m holds 2^m nc[m] items).
template <int D>
struct K3Round {
  int slot[D], nc[D], base[D + 1];
};

template <int D>
__device__ __forceinline__ K3Round<D> k3_round(const K3Tile& t, int q0,
                                               int n) {
  K3Round<D> r;
  r.base[0] = 0;
#pragma unroll
  for (int m = 0; m < D; ++m) {
    r.slot[m] = q0 + m < n ? t.order[q0 + m] : 0;
    r.nc[m] = q0 + m < n ? t.nchg[r.slot[m]] : 0;
    r.base[m + 1] = r.base[m] + (r.nc[m] << m);
  }
  return r;
}

// Work item `it` of a round: node j's c-th changed population h, with what
// the carry does not change: the differences of the loci its pattern
// accepts before its own (zeros elsewhere: adding 0 is exact) and its
// own locus's.
template <int D>
struct K3Item {
  int j, c, h;
  double adk[D > 1 ? D - 1 : 1], adc[D > 1 ? D - 1 : 1], odk, odc;
};

template <int D>
__device__ __forceinline__ K3Item<D> k3_item(const K3Tile& t,
                                             const K3Round<D>& r, int it,
                                             int H) {
  int m = 0, b0 = 0, ncm = r.nc[0], s = r.slot[0];
#pragma unroll
  for (int d = 1; d < D; ++d) {
    if (it >= r.base[d]) {
      m = d;
      b0 = r.base[d];
      ncm = r.nc[d];
      s = r.slot[d];
    }
  }
  K3Item<D> x;
  // it - b0 = p nc + c; p < 2^m <= 64 and nc <= H: the float quotient's
  // floor is exact
  const int p = static_cast<int>(
      __fdiv_rz(static_cast<float>(it - b0) + 0.5f, static_cast<float>(ncm)));
  x.c = it - b0 - p * ncm;
  x.j = (1 << m) - 1 + p;
  x.h = t.hidx[static_cast<size_t>(s) * H + x.c];
#pragma unroll
  for (int l = 0; l < D - 1; ++l) {
    const bool on = l < m && ((p >> (m - 1 - l)) & 1);
    const size_t at = static_cast<size_t>(r.slot[l]) * H + x.h;
    x.adk[l] = on ? t.dk[at] : 0.0;
    x.adc[l] = on ? t.dc[at] : 0.0;
  }
  x.odk = t.dk[static_cast<size_t>(s) * H + x.h];
  x.odc = t.dc[static_cast<size_t>(s) * H + x.h];
  return x;
}

// An item's difference of terms, lgamma(a + k) - (a + k) log(b + c) after
// its locus minus before, under its pattern's carry: the accepted loci's
// differences added to the carry in order.
template <int D>
__device__ __forceinline__ double k3_diff(const K3Item<D>& x, const double* Ks,
                                          const double* Cs,
                                          const double* kbase,
                                          const double* table, int span,
                                          double a, double b) {
  double k = Ks[x.h], c = Cs[x.h];
#pragma unroll
  for (int l = 0; l < D - 1; ++l) {
    k = __dadd_rn(k, x.adk[l]);
    c = __dadd_rn(c, x.adc[l]);
  }
  return notheta_diff(table, kbase, span, x.h, a, b, k, c,
                      __dadd_rn(k, x.odk), __dadd_rn(c, x.odc));
}

// Walk a staged tile's chain, D loci a round (walker threads only).  A
// round's work items are (node, changed population): item p nc + c of
// depth m is node 2^m - 1 + p's difference of terms for the c-th
// population locus i + m changes, under its pattern's carry, one thread an
// item (threads past the decider warp).  The decider warp (a thread a
// node) then sums each node's differences in ascending h, decides, follows
// the real path and advances the carry.  While they do, the item threads
// load what the next round's items need but the carry.
template <int D>
__device__ void k3_walk(K3Tile t, int i0, double* Ks, double* Cs,
                        const double* kbase, const double* table, int span,
                        double* diffs, int H, double a, double b,
                        unsigned char* __restrict__ accept) {
  constexpr int kDeciders = kLanes;
  constexpr int kItems = kK3Walkers - kDeciders;
  const int tid = threadIdx.x;
  const int n = *t.count;
  K3Round<D> r = k3_round<D>(t, 0, n);
  K3Item<D> first;
  if (tid >= kDeciders && tid - kDeciders < r.base[D])
    first = k3_item<D>(t, r, tid - kDeciders, H);
  for (int q0 = 0; q0 < n; q0 += D) {
    const int dr = min(D, n - q0);
    if (tid >= kDeciders) {
      int it = tid - kDeciders;
      if (it < r.base[D])
        diffs[static_cast<size_t>(first.j) * H + first.c] =
            k3_diff<D>(first, Ks, Cs, kbase, table, span, a, b);
      for (it += kItems; it < r.base[D]; it += kItems) {
        const K3Item<D> x = k3_item<D>(t, r, it, H);
        diffs[static_cast<size_t>(x.j) * H + x.c] =
            k3_diff<D>(x, Ks, Cs, kbase, table, span, a, b);
      }
    }
    named_sync(2, kK3Walkers);
    const K3Round<D> next = k3_round<D>(t, q0 + D, n);
    if (tid < kDeciders) {
      bool acc = false;
      if (tid < heap_nodes(dr)) {
        const int m = 31 - __clz(tid + 1);
        int s = r.slot[0], ncm = r.nc[0];
#pragma unroll
        for (int d = 1; d < D; ++d) {
          if (m == d) {
            s = r.slot[d];
            ncm = r.nc[d];
          }
        }
        const double* v = diffs + static_cast<size_t>(tid) * H;
        double dlg = 0.0;
#pragma unroll 4
        for (int c = 0; c < ncm; ++c) dlg = __dadd_rn(dlg, v[c]);
        acc = t.lhs[s] < __dadd_rn(t.rhs[s], dlg);
      }
      int last;
      const unsigned bits = follow(__ballot_sync(kFull, acc), dr, &last);
      if (tid < dr) accept[i0 + t.order[q0 + tid]] = (bits >> tid) & 1;
      if (bits) {
        // the carry advances along the real path, one population a thread
        for (int h = tid; h < H; h += kDeciders) {
          double k = Ks[h], cc = Cs[h];
#pragma unroll
          for (int l = 0; l < D; ++l) {
            if ((bits >> l) & 1) {
              const size_t at = static_cast<size_t>(r.slot[l]) * H + h;
              k = __dadd_rn(k, t.dk[at]);
              cc = __dadd_rn(cc, t.dc[at]);
            }
          }
          Ks[h] = k;
          Cs[h] = cc;
        }
      }
    } else if (tid - kDeciders < next.base[D]) {
      first = k3_item<D>(t, next, tid - kDeciders, H);
    }
    r = next;
    named_sync(2, kK3Walkers);
  }
}

// cols [K, L, 4H + 4]: per locus co[H], cn[H], to[H], tn[H], dother, dh,
// logu, mask (> 0.5: the locus proposes); sums [K, 2H]: K0, C0.  accept
// [K, L] bytes.  A block a chain; R loci a tile, a table of K0 +- M counts.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    notheta_chain_kernel(const double* __restrict__ cols,
                         const double* __restrict__ sums, int L, int H,
                         double a, double b, int R, int M,
                         unsigned char* __restrict__ accept) {
  // a block a chain: chain blockIdx.x's rows alone, so that its walk is
  // a one-chain launch's on them
  cols += static_cast<size_t>(blockIdx.x) * L * (4 * H + 4);
  sums += static_cast<size_t>(blockIdx.x) * 2 * H;
  accept += static_cast<size_t>(blockIdx.x) * L;
  extern __shared__ __align__(16) unsigned char smem[];
  Header* hd = reinterpret_cast<Header*>(smem);
  double* Ks = reinterpret_cast<double*>(smem + kHeader);
  double* Cs = Ks + H;
  double* kbase = Cs + H;
  double* diffs = reinterpret_cast<double*>(
      smem + kHeader + align16(24 * static_cast<size_t>(H)));
  double* table = diffs + static_cast<size_t>(H) * heap_nodes(D);
  const int span = 2 * M + 1;
  unsigned char* p = smem + k3_fixed_bytes(H, D, M);
  const K3Tile t0 = k3_tile_at(p, R, H, &hd->count[0]);
  const K3Tile t1 = k3_tile_at(p + k3_tile_bytes(R, H), R, H, &hd->count[1]);
  const int tid = threadIdx.x;
  for (int h = tid; h < H; h += kThreads) {
    Ks[h] = sums[h];
    Cs[h] = sums[H + h];
    kbase[h] = __dsub_rn(sums[h], static_cast<double>(M));
  }
  const int T = (L + R - 1) / R;
  // the first tile and the table: every warp
  k3_stage(cols, H, 0, min(R, L), t0, tid, kThreads, accept);
  for (int e = tid; e < H * span; e += kThreads) {
    const int h = e / span;
    const double k = __dadd_rn(__dsub_rn(sums[h], static_cast<double>(M)),
                               static_cast<double>(e - h * span));
    table[e] = lgamma(__dadd_rn(a, k));
  }
  __syncthreads();
  if (tid < kLanes) k3_order(t0, min(R, L));
  __syncthreads();
  for (int k = 0; k < T; ++k) {
    if (tid < kK3Walkers) {
      k3_walk<D>((k & 1) ? t1 : t0, k * R, Ks, Cs, kbase, table, span, diffs,
                 H, a, b, accept);
    } else if (k + 1 < T) {
      const K3Tile next = (k & 1) ? t0 : t1;
      const int i0 = (k + 1) * R, n = min(R, L - i0);
      k3_stage(cols, H, i0, n, next, tid - kK3Walkers, kLanes, accept);
      __syncwarp();
      k3_order(next, n);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------- K4 ----

struct K4Tile {
  double* mo;              // [R] old value
  double* mn;              // [R] new value
  double* lr;              // [R] the locus's own part of ln acceptance
  double* lu;              // [R] log u
  unsigned char* on;       // [R] proposes
  unsigned short* order;   // the chain
  int* count;
};

__host__ __device__ constexpr size_t k4_tile_bytes() {
  return align16(static_cast<size_t>(kK4Tile) * 32)
         + align16(static_cast<size_t>(kK4Tile))
         + align16(static_cast<size_t>(kK4Tile) * 2);
}

constexpr size_t kK4Shared = kHeader + 2 * k4_tile_bytes();
static_assert(kK4Shared <= kSharedDefault, "K4 shared memory");

__device__ K4Tile k4_tile(unsigned char* p, int* count) {
  K4Tile t;
  t.mo = reinterpret_cast<double*>(p);
  t.mn = t.mo + kK4Tile;
  t.lr = t.mn + kK4Tile;
  t.lu = t.lr + kK4Tile;
  p += align16(static_cast<size_t>(kK4Tile) * 32);
  t.on = p;
  p += align16(static_cast<size_t>(kK4Tile));
  t.order = reinterpret_cast<unsigned short*>(p);
  t.count = count;
  return t;
}

__device__ void k4_stage(const double* __restrict__ terms, int i0, int n,
                         K4Tile t, double a_i, int tid, int threads,
                         unsigned char* __restrict__ accept) {
  for (int r = tid; r < n; r += threads) {
    const double* x = terms + 6 * static_cast<size_t>(i0 + r);
    const bool prop = x[5] > 0.5;
    t.mo[r] = x[0];
    t.mn[r] = x[1];
    // (a_i - 1) log(new / old) + log proposal ratio + density delta
    t.lr[r] = __dadd_rn(
        __dadd_rn(__dmul_rn(a_i - 1.0, log(__ddiv_rn(x[1], x[0]))), x[2]),
        x[3]);
    t.lu[r] = log(x[4]);
    t.on[r] = prop ? 1 : 0;
    if (!prop) accept[i0 + r] = 0;
  }
}

__device__ void k4_order(K4Tile t, int n) {
  const int lane = threadIdx.x & (kLanes - 1);
  int c = 0;
  for (int r0 = 0; r0 < n; r0 += kLanes) {
    const int r = r0 + lane;
    const bool on = r < n && t.on[r];
    const unsigned bal = __ballot_sync(kFull, on);
    if (on)
      t.order[c + __popc(bal & ((1u << lane) - 1u))] =
          static_cast<unsigned short>(r);
    c += __popc(bal);
  }
  if (lane == 0) *t.count = c;
}

// Walk a staged tile's chain, kDepth loci a round (the first warp);
// returns the carry.  Each node's inputs of the next round are loaded
// before the current round's decisions are gathered.
__device__ double k4_walk(K4Tile t, int i0, double sum_mu, double A,
                          double termb, unsigned char* __restrict__ accept) {
  constexpr int D = kDepth;
  const int j = threadIdx.x;
  const int m = 31 - __clz(j + 1);
  const int path = j + 1 - (1 << m);
  const int n = *t.count;
  // the new and old values of the loci this node's pattern accepts
  // before its own (zeros elsewhere: (s + 0) - 0 is s), its own locus's
  double amn[D > 1 ? D - 1 : 1], amo[D > 1 ? D - 1 : 1];
  double mn, mo, lr, lu;
  auto load = [&](int q0) {
#pragma unroll
    for (int l = 0; l < D - 1; ++l) {
      const bool on = l < m && ((path >> (m - 1 - l)) & 1) && q0 + l < n;
      const int r = on ? t.order[q0 + l] : 0;
      amn[l] = on ? t.mn[r] : 0.0;
      amo[l] = on ? t.mo[r] : 0.0;
    }
    const int r = m < D && q0 + m < n ? t.order[q0 + m] : 0;
    mn = t.mn[r];
    mo = t.mo[r];
    lr = t.lr[r];
    lu = t.lu[r];
  };
  load(0);
  for (int q0 = 0; q0 < n; q0 += D) {
    const int dr = min(D, n - q0);
    // the carry of this pattern: (sum + new) - old, accepted loci in
    // order (clock_moves.py:190's association)
    double s = sum_mu;
#pragma unroll
    for (int l = 0; l < D - 1; ++l)
      s = __dsub_rn(__dadd_rn(s, amn[l]), amo[l]);
    const double sn = __dsub_rn(__dadd_rn(s, mn), mo);
    bool acc = false;
    if (j < heap_nodes(dr)) {
      const double lnacc = __dadd_rn(
          __dsub_rn(__dmul_rn(A, log(__ddiv_rn(sn, s))),
                    __dmul_rn(termb, __dsub_rn(sn, s))),
          lr);
      acc = lu < lnacc;
    }
    const int at = j < dr ? i0 + t.order[q0 + j] : 0;
    load(q0 + D);
    int last;
    const unsigned bits = follow(__ballot_sync(kFull, acc), dr, &last);
    if (j < dr) accept[at] = (bits >> j) & 1;
    // the carry is the sum the deepest accepted locus's node computed
    if (last >= 0) sum_mu = __shfl_sync(kFull, sn, last);
  }
  return sum_mu;
}

// terms [K, L, 6]: per locus old value, new value, log proposal ratio,
// locus-factorizing density delta, uniform draw, mask (> 0.5: proposes).
// accept [K, L] bytes.  A block a chain; its first warp walks, the others
// stage.
__global__ void __launch_bounds__(kThreads, 1)
    gammadir_chain_kernel(const double* __restrict__ terms, int L,
                          double a_bar, double b_bar, double a_i,
                          unsigned char* __restrict__ accept) {
  // a block a chain, as K3's
  terms += static_cast<size_t>(blockIdx.x) * 6 * L;
  accept += static_cast<size_t>(blockIdx.x) * L;
  constexpr int kStagers = kThreads - kLanes;
  extern __shared__ __align__(16) unsigned char smem[];
  Header* hd = reinterpret_cast<Header*>(smem);
  const K4Tile t0 = k4_tile(smem + kHeader, &hd->count[0]);
  const K4Tile t1 = k4_tile(smem + kHeader + k4_tile_bytes(), &hd->count[1]);
  const int tid = threadIdx.x, warp = tid / kLanes;
  // the first pass: the sum over the proposing loci and their count
  double sum = 0.0, count = 0.0;
  for (int i = tid; i < L; i += kThreads) {
    if (terms[6 * static_cast<size_t>(i) + 5] > 0.5) {
      sum += terms[6 * static_cast<size_t>(i)];
      count += 1.0;
    }
  }
  sum = warp_sum(sum);
  count = warp_sum(count);
  if ((tid & (kLanes - 1)) == 0) {
    hd->part[warp] = sum;
    hd->nprop[warp] = count;
  }
  const int T = (L + kK4Tile - 1) / kK4Tile;
  k4_stage(terms, 0, min(kK4Tile, L), t0, a_i, tid, kThreads, accept);
  __syncthreads();
  double sum_mu = 0.0, nl = 0.0;
  for (int w = 0; w < kWarps; ++w) {
    sum_mu += hd->part[w];
    nl += hd->nprop[w];
  }
  const double A = a_bar - a_i * nl, termb = b_bar / nl;
  if (tid < kLanes) k4_order(t0, min(kK4Tile, L));
  __syncthreads();
  for (int k = 0; k < T; ++k) {
    if (tid < kLanes) {
      sum_mu = k4_walk((k & 1) ? t1 : t0, k * kK4Tile, sum_mu, A, termb,
                       accept);
    } else if (k + 1 < T) {
      const K4Tile next = (k & 1) ? t0 : t1;
      const int i0 = (k + 1) * kK4Tile, n = min(kK4Tile, L - i0);
      k4_stage(terms, i0, n, next, a_i, tid - kLanes, kStagers, accept);
      named_sync(1, kStagers);
      if (warp == 1) k4_order(next, n);
    }
    __syncthreads();
  }
}

template <int D>
int launch_notheta(const void* cols, const void* sums, int K, int L, int H,
                   double a, double b, const K3Layout& k, void* accept,
                   cudaStream_t stream) {
  const size_t bytes = k3_shared_bytes(k, H);
  if (bytes > static_cast<size_t>(kSharedDefault)) {
    const cudaError_t e = cudaFuncSetAttribute(
        notheta_chain_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  notheta_chain_kernel<D><<<K, kThreads, bytes, stream>>>(
      static_cast<const double*>(cols), static_cast<const double*>(sums), L,
      H, a, b, k.R, k.M, static_cast<unsigned char*>(accept));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace


// The loci a K3 launch over H populations resolves a round: kDepth (K4's),
// or the deepest below it whose round's terms and a tile of one locus fit
// the shared memory; 0 when none does (the launch is refused).
extern "C" int bpp_notheta_depth(int H) {
  return H > 0 ? k3_layout(H).depth : 0;
}

// K chains' accept chains, one launch of K blocks (K = 1: one chain).
extern "C" int bpp_notheta_chain(const void* cols, const void* sums, int K,
                                 int L, int H, double a, double b,
                                 void* accept, void* stream) {
  if (L <= 0 || K <= 0) return 0;
  if (H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const K3Layout k = k3_layout(H);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (k.depth) {
    case 1: return launch_notheta<1>(cols, sums, K, L, H, a, b, k, accept, st);
    case 2: return launch_notheta<2>(cols, sums, K, L, H, a, b, k, accept, st);
    case 3: return launch_notheta<3>(cols, sums, K, L, H, a, b, k, accept, st);
    case 4: return launch_notheta<4>(cols, sums, K, L, H, a, b, k, accept, st);
    case 5: return launch_notheta<5>(cols, sums, K, L, H, a, b, k, accept, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int bpp_gammadir_chain(const void* terms, int K, int L,
                                  double a_bar, double b_bar, double a_i,
                                  void* accept, void* stream) {
  if (L <= 0 || K <= 0) return 0;
  gammadir_chain_kernel<<<K, kThreads, kK4Shared,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(terms), L, a_bar, b_bar, a_i,
      static_cast<unsigned char*>(accept));
  return static_cast<int>(cudaGetLastError());
}
