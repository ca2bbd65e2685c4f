// Device code shared by the two pruning kernels (pack_kernel.cu, K1, and
// fels_kernel.cu, K2): the per-family contraction P(t)·x, the per-locus
// prologue (branch lengths, exponential factors, CLV slot plan) and the
// walk of up to 32 site patterns of one locus up its gene tree by one warp.
//
// Replaces the pruning core of the TPU kernels in
// bpp_tpu/core/pallas_pack.py and bpp_tpu/core/pallas_fels.py.  The
// function needs few bytes (each tip partial once, a few indices and
// parameters per locus, one value per pattern or locus out) and fewer
// operations still, so on an H100 its bound is bytes; what it costs
// beyond that is latency: a pattern's walk is T-1 dependent levels.  The
// design keeps what a walk re-reads on the SM, and leaves the SM room for
// many warps to hide the waits that remain:
//
//   * Unit of work: one warp on one (locus, chunk of up to 32 real
//     patterns), from a table built once per run (core/units.py).  No
//     warp is launched on padding.
//   * Prologue, per (warp, locus), into shared memory: one level per
//     lane reads the schedule (order, left, right) and the ages and forms
//     max(age[node] - age[child], 0) * mu for both children (the parent of
//     a scheduled child is that level's node; with `blen` given it is read
//     instead of ages and mu); the lanes assign CLV slots; all lanes compute
//     expm1(lambda_f * t * rate_c) per (level, child, category, factor),
//     which core/efactors.py states in PyTorch.  Factors stay m = e - 1
//     and P(t)·x is written as x + (terms in m): the literal 1 - e keeps
//     few digits in float32 on branches of ~1e-5 (0.024 lnL on one locus
//     of 1000).
//   * CLV slots: an inner CLV is dead once its parent has consumed it.
//     A node writes into the slot of its left inner child, else of its
//     right inner child, else into a slot of its own; so the nodes that
//     share a slot form a chain up the tree, a chain starts at a node
//     with two tips below it, and there are at most floor(T/2) chains.  A
//     level reads both children for every category before it writes, so
//     writing over a child is safe.  Which chain a node is on is found
//     for all nodes at once by pointer jumping, not by a walk in schedule
//     order.  core/units.py `slot_plan` is the same plan in numpy, tested
//     on the CPU.
//   * Scalar type, a template parameter R: float, or double for --x64
//     (Real<R> below; the float build is the code this file held before
//     the parameter, with the same intrinsics and constants).  A 4-vector
//     of R is float4, or V4d, 32 bytes read as two 16-byte words.  Up
//     to 3 categories the double build walks with DoubleWalk (below):
//     UnitWalk's prologue and unit of work, and a level that rescales
//     only near the bottom of double's range and keeps in registers what
//     the next level reads.
//   * CLV store, a template parameter: SHARED keeps the slots
//     [slot][category][32] as 4-vectors in the warp's shared memory (a warp
//     reads 32 consecutive 16-byte words: no bank conflicts); the other
//     store keeps the same slots in a device scratch
//     [unit][slot][category][32], for trees whose slots do not fit in a
//     block's 227 KB.  The wrapper chooses from T and C.
//   * Tips are read once each, from device memory, two levels before the
//     level that consumes them, into registers.  Staging all of a
//     pattern's tips in shared memory first (one wait instead of several)
//     was tried and dropped: it was no faster where a pass is one wave of
//     warps and slower where it is several, because the staged tips take
//     the shared memory that more resident warps would use.
//   * Every level is rescaled by the per-pattern max over categories and
//     states (floored at 1e-30), with one reciprocal per level; the scale
//     factors are multiplied up and their log is taken only when the
//     product nears the bottom of float32's range, and at the root.  Levels k >= n_seq - 1 are never entered; a
//     one-sequence locus is rooted at tip 0.  The value is
//     log(sum_c sum_a pi_a clv / C) + sum log scale.
//
// Shared memory per warp with the SHARED store, in bytes, with b =
// sizeof(R) (4, or 8 in double):
//   128 b C floor(T/2) (CLVs) + 2 b (T-1) C K (factors) + 2 b (T-1)
//   (branch lengths) + b C (rates) + 10 (T-1) (plan), rounded up to 16.
// The figures below are float's; double's CLVs and factors take twice
// as much (C = 4: 35 KB a warp, three 64-thread blocks an SM).
// At T = 16 (K = 1 JC69, 3 TN93 class, 4 GTR) a warp / a 64-thread block,
// the wrappers' block size:
//   C = 1:  4,496 ..  4,864 B /  8.8 ..  9.5 KB (23-25 blocks an SM)
//   C = 4: 17,152 .. 18,592 B / 33.5 .. 36.3 KB (6 blocks an SM)
//   C = 8: 34,032 .. 36,912 B / 66.5 .. 72.1 KB (3 blocks an SM)
// Small blocks pack an SM's 227 KB best: at C = 8 a 128-thread block takes
// 133 .. 144 KB and an SM holds one (4 warps, not 6).
// The other store needs only the factors, lengths and plan: 0.4 .. 4 KB.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace bpp {

constexpr int kLanes = 32;
constexpr int kMaxCats = 8;
// dynamic shared memory one block may ask for on sm_90
constexpr int kMaxBlockShared = 232448;

enum { FAM_JC69 = 0, FAM_TN93 = 1, FAM_GTR = 2 };

// A 4-vector of doubles: 32 bytes, read and written as two 16-byte words.
struct __align__(16) V4d {
  double x, y, z, w;
};

// The scalar type's vector, intrinsics and constants: the floor of a
// level's rescale (kTiny) and the product of scale factors below which
// their log is taken (kFlush) are float's in both builds.
template <typename R> struct Real;

template <> struct Real<float> {
  using V4 = float4;
  static constexpr float kTiny = 1e-30f;
  static constexpr float kFlush = 1e-25f;
  static __device__ __forceinline__ float4 make(float x, float y, float z,
                                                float w) {
    return make_float4(x, y, z, w);
  }
  static __device__ __forceinline__ float expm1_(float x) {
    return expm1f(x);
  }
  static __device__ __forceinline__ float log_(float x) { return logf(x); }
  static __device__ __forceinline__ float max_(float a, float b) {
    return fmaxf(a, b);
  }
  static __device__ __forceinline__ float rcp(float x) {
    return __frcp_rn(x);
  }
};

template <> struct Real<double> {
  using V4 = V4d;
  static constexpr double kTiny = 1e-30;
  static constexpr double kFlush = 1e-25;
  static __device__ __forceinline__ V4d make(double x, double y, double z,
                                             double w) {
    V4d v;
    v.x = x; v.y = y; v.z = z; v.w = w;
    return v;
  }
  static __device__ __forceinline__ double expm1_(double x) {
    return expm1(x);
  }
  static __device__ __forceinline__ double log_(double x) { return log(x); }
  static __device__ __forceinline__ double max_(double a, double b) {
    return fmax(a, b);
  }
  static __device__ __forceinline__ double rcp(double x) {
    return __drcp_rn(x);
  }
};

// What both kernels take (tensors of the whole batch, on the card).  A
// launch covers K chains (chains = K), one a grid row (blockIdx.y): the
// tensors marked [K, L, ...] hold every chain's rows, chain after chain,
// and chain k reads its rows k L .. k L + L - 1 (chain_row); the tips,
// n_seq and the unit table are the batch's, one copy that every chain
// reads.  K = 1 is the one-chain launch, with the same arithmetic.
template <typename R>
struct TreeArgs {
  using V4 = typename Real<R>::V4;
  const V4* tips;          // [L, T, S] 4-vectors
  const R* age;            // [K, L, N]
  const R* blen;           // [K, L, N] or null: branch lengths, mu included
  const R* mu;             // [K, L]
  const R* rates;          // [K, L, C + 2]: category rates, kappa1, kappa2
  const R* freqs;          // [K, L, 4]
  const R* eigw;           // [K, L, 4] (GTR)
  const R* eigT;           // [K, L, 16] (GTR)
  const R* eigTi;          // [K, L, 16] (GTR)
  const int64_t* order;    // [K, L, T-1]
  const int64_t* left;     // [K, L, N]
  const int64_t* right;    // [K, L, N]
  const int64_t* n_seq;    // [L]
  const int4* units;       // [U]: locus, first pattern, real patterns, last
  V4* scratch;             // [K, U, T/2, C, 32] 4-vectors (global store) or
                           // null
  int T, S, U, L;
};

// The row of locus l of this block's chain (blockIdx.y) in a [K, L, ...]
// tensor, and of unit u in the [K, U, ...] scratch.
template <typename R>
__device__ __forceinline__ int64_t chain_row(const TreeArgs<R>& a,
                                             int64_t l) {
  return static_cast<int64_t>(blockIdx.y) * a.L + l;
}
template <typename R>
__device__ __forceinline__ int64_t chain_unit(const TreeArgs<R>& a, int u) {
  return static_cast<int64_t>(blockIdx.y) * a.U + u;
}

template <int FAM, typename R> struct Coefs;

template <typename R> struct Coefs<FAM_JC69, R> {
  using V4 = typename Real<R>::V4;
  static constexpr int K = 1;
  __device__ void load(const TreeArgs<R>&, int64_t, int) {}
  __device__ void prepare() {}
  __device__ void factors(R t, R* e) const {
    e[0] = Real<R>::expm1_(R(-4) / R(3) * t);
  }
  // y = e x + (1-e)/4 Σx, as x + m (x - Σx/4) with m = e - 1
  __device__ V4 apply(V4 x, const R* e) const {
    const R m = e[0];
    const R q = R(0.25) * ((x.x + x.y) + (x.z + x.w));
    return Real<R>::make(x.x + m * (x.x - q), x.y + m * (x.y - q),
                         x.z + m * (x.z - q), x.w + m * (x.w - q));
  }
};

template <typename R> struct Coefs<FAM_TN93, R> {
  using V4 = typename Real<R>::V4;
  static constexpr int K = 3;
  R pa, pc, pg, pt, k1, k2, rR, rY, cA, cG, cC, cT, m, b3, b4;
  // load() only asks device memory for the parameters; prepare() uses
  // them, and so waits for them
  __device__ void load(const TreeArgs<R>& a, int64_t l, int C) {
    const R* f = a.freqs + l * 4;
    pa = f[0]; pc = f[1]; pg = f[2]; pt = f[3];
    k1 = a.rates[l * (C + 2) + C];
    k2 = a.rates[l * (C + 2) + C + 1];
  }
  __device__ void prepare() {
    const R Rr = pa + pg, Y = pc + pt;
    m = R(2) * (pa * pg * k1 + pc * pt * k2 + Rr * Y);
    b3 = Rr * k1 + Y;
    b4 = Y * k2 + Rr;
    rR = (R(1) - Rr) / Rr; rY = (R(1) - Y) / Y;
    cA = pg / Rr; cG = pa / Rr; cC = pt / Y; cT = pc / Y;
  }
  // e2 (any substitution), e3 (purine), e4 (pyrimidine), each minus 1
  __device__ void factors(R t, R* e) const {
    const R ts = t / m;
    e[0] = Real<R>::expm1_(-ts);
    e[1] = Real<R>::expm1_(-b3 * ts);
    e[2] = Real<R>::expm1_(-b4 * ts);
  }
  // pallas_fels's UR + cA e3 (xA - xG) etc., with every e = 1 + m so
  // that the t = 0 identity cancels algebraically: y = x + corrections
  __device__ V4 apply(V4 x, const R* e) const {
    const R m2 = e[0], m3 = e[1], m4 = e[2];
    const R WR = pa * x.x + pg * x.z;
    const R WY = pc * x.y + pt * x.w;
    const R uR = m2 * (rR * WR - WY);
    const R uY = m2 * (rY * WY - WR);
    const R dRG = m3 * (x.x - x.z);
    const R dCT = m4 * (x.y - x.w);
    return Real<R>::make(x.x + (uR + cA * dRG), x.y + (uY + cC * dCT),
                         x.z + (uR - cG * dRG), x.w + (uY - cT * dCT));
  }
};

template <typename R> struct Coefs<FAM_GTR, R> {
  using V4 = typename Real<R>::V4;
  static constexpr int K = 4;
  R w[4], T[16], Ti[16];
  __device__ void load(const TreeArgs<R>& a, int64_t l, int) {
    for (int i = 0; i < 4; ++i) w[i] = a.eigw[l * 4 + i];
    for (int i = 0; i < 16; ++i) {
      T[i] = a.eigT[l * 16 + i];
      Ti[i] = a.eigTi[l * 16 + i];
    }
  }
  __device__ void prepare() {}
  __device__ void factors(R t, R* e) const {
    for (int f = 0; f < 4; ++f) e[f] = Real<R>::expm1_(w[f] * t);
  }
  __device__ V4 apply(V4 x, const R* e) const {
    R z[4];
    for (int k = 0; k < 4; ++k)
      z[k] = e[k] * (Ti[k * 4 + 0] * x.x + Ti[k * 4 + 1] * x.y +
                     Ti[k * 4 + 2] * x.z + Ti[k * 4 + 3] * x.w);
    R y[4];
    for (int i = 0; i < 4; ++i)
      y[i] = T[i * 4 + 0] * z[0] + T[i * 4 + 1] * z[1] +
             T[i * 4 + 2] * z[2] + T[i * 4 + 3] * z[3];
    return Real<R>::make(x.x + y[0], x.y + y[1], x.z + y[2], x.w + y[3]);
  }
};

__host__ __device__ inline int family_factors(int fam) {
  return fam == FAM_JC69 ? 1 : (fam == FAM_TN93 ? 3 : 4);
}

template <typename R>
__device__ __forceinline__ typename Real<R>::V4 mul4(typename Real<R>::V4 a,
                                                     typename Real<R>::V4 b) {
  return Real<R>::make(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}

template <typename R>
__device__ __forceinline__ typename Real<R>::V4 scale4(
    typename Real<R>::V4 a, R r) {
  return Real<R>::make(a.x * r, a.y * r, a.z * r, a.w * r);
}

template <typename R>
__device__ __forceinline__ R max4(typename Real<R>::V4 a) {
  return Real<R>::max_(Real<R>::max_(a.x, a.y), Real<R>::max_(a.z, a.w));
}

// Byte offsets of one warp's state in its block's dynamic shared memory;
// rb is sizeof(R).
struct WarpLayout {
  int clv;      // V4   [slots][C][32]     (SHARED store only)
  int fac;      // R    [T-1][2][C][K]     expm1 factors, by level, child
  int blen;     // R    [T-1][2]           mu-scaled branch lengths
  int rate;     // R    [C]                the locus's category rates
  int plan;     // short  srcL, srcR, dst, down, chain [T-1]
  int slots;    // CLV slots a pattern needs: floor(T/2)
  long long bytes;
};

__host__ __device__ inline WarpLayout warp_layout(int T, int C, int K,
                                                  bool shared, int rb) {
  WarpLayout w;
  const long long nlev = T - 1;
  w.slots = T / 2;
  long long off = 0;
  w.clv = static_cast<int>(off);
  if (shared) off += 4LL * rb * kLanes * C * w.slots;
  w.fac = static_cast<int>(off);
  off += 1LL * rb * 2 * nlev * C * K;
  w.blen = static_cast<int>(off);
  off += 1LL * rb * 2 * nlev;
  w.rate = static_cast<int>(off);
  off += 1LL * rb * C;
  w.plan = static_cast<int>(off);
  off += 2LL * 5 * nlev;
  w.bytes = (off + 15) & ~15LL;
  return w;
}

// One warp's walk of one unit.  Every lane of the warp calls run(); lanes
// past the unit's real patterns take part in the prologue and skip the
// walk.  `region` is the warp's slice of the block's dynamic shared
// memory, free for reuse once every lane has returned.
template <typename R, int FAM, int C, bool SHARED>
struct UnitWalk {
  using Rt = Real<R>;
  using V4 = typename Rt::V4;
  static constexpr int K = Coefs<FAM, R>::K;

  static __device__ R run(const TreeArgs<R>& a, unsigned char* region,
                          int u, int4 unit, int lane) {
    const int T = a.T, S = a.S, N = 2 * T - 1;
    const int64_t l = unit.x;
    const int64_t cl = chain_row(a, l);       // l in the chain's rows
    const bool active = lane < unit.z;
    const WarpLayout w = warp_layout(T, C, K, SHARED, sizeof(R));
    R* fac = reinterpret_cast<R*>(region + w.fac);
    R* bl = reinterpret_cast<R*>(region + w.blen);
    R* rate = reinterpret_cast<R*>(region + w.rate);
    short* srcL = reinterpret_cast<short*>(region + w.plan);
    short* srcR = srcL + (T - 1);
    short* dst = srcR + (T - 1);
    short* down = dst + (T - 1);
    short* chain = down + (T - 1);

    // this lane's column of the tips, and of the CLV slots
    const V4* tp = a.tips + (l * T) * S + (unit.y + lane);
    V4* cv;
    if constexpr (SHARED)
      cv = reinterpret_cast<V4*>(region + w.clv) + lane;
    else
      cv = a.scratch + chain_unit(a, u) * w.slots * C * kLanes + lane;

    // prologue 1: the schedule and both children's branch lengths, one
    // level per lane (the parent of a scheduled child is the level's
    // node).  Everything the locus needs from device memory is asked for
    // here, in as few dependent rounds as the indices allow; the levels
    // past n_seq - 1 are read too (they are padding, never walked, and
    // may hold anything), so that the schedule's reads do not wait for
    // n_seq.  The clamps are for those padding levels: whatever node one
    // names, and whatever that node's child entries hold, every index stays
    // inside the arrays and the warp's region.  The real levels need none:
    // the schedule names each inner node once, children before parents,
    // and 0 <= n_seq <= T (the batch's tip capacity is its largest locus).
    const int nlev = static_cast<int>(a.n_seq[l]) - 1;
    const R mu = a.blen != nullptr ? R(1) : a.mu[cl];
    const R* len = (a.blen != nullptr ? a.blen : a.age) + cl * N;
    const R* fq = a.freqs + cl * 4;
    const R f0 = fq[0], f1 = fq[1], f2 = fq[2], f3 = fq[3];
    Coefs<FAM, R> cf;
    cf.load(a, cl, C);
    const R my_rate = lane < C ? a.rates[cl * (C + 2) + lane] : R(0);
    const int64_t* order = a.order + cl * (T - 1);
    const int64_t* left = a.left + cl * N;
    const int64_t* right = a.right + cl * N;
    for (int k = lane; k < T - 1; k += kLanes) {
      int node = static_cast<int>(order[k]);
      node = node < T ? T : (node >= N ? N - 1 : node);
      int lc = static_cast<int>(left[node]);
      int rc = static_cast<int>(right[node]);
      lc = lc < 0 ? 0 : (lc >= N ? N - 1 : lc);
      rc = rc < 0 ? 0 : (rc >= N ? N - 1 : rc);
      R tl = len[lc], tr = len[rc];
      if (a.blen == nullptr) {
        const R an = len[node];
        tl = Rt::max_(an - tl, R(0)) * mu;
        tr = Rt::max_(an - tr, R(0)) * mu;
      }
      srcL[k] = static_cast<short>(lc);
      srcR[k] = static_cast<short>(rc);
      dst[k] = static_cast<short>(node);
      // down the chain: the left inner child, else the right, else itself
      // (a padding level that names a real node writes what its level does)
      down[node - T] =
          static_cast<short>((lc >= T ? lc : (rc >= T ? rc : node)) - T);
      chain[k] = 0;
      bl[2 * k] = tl;
      bl[2 * k + 1] = tr;
    }
    if (lane < C) rate[lane] = my_rate;
    cf.prepare();
    __syncwarp();

    // prologue 2: node ids become CLV slots (a child source >= 0 is a tip,
    // < 0 is slot -1 - source).  Every inner node points down its chain
    // (prologue 1); the chains' bottoms, which have two tips below them,
    // are numbered in schedule order; pointer jumping takes every node to
    // its bottom in log2 rounds; a node's slot is its bottom's number.
    int n_chains = 0;
    for (int base = 0; base < nlev; base += kLanes) {
      const int k = base + lane;
      const bool bottom = k < nlev && srcL[k] < T && srcR[k] < T;
      const unsigned mask = __ballot_sync(0xffffffffu, bottom);
      if (bottom) {
        // a tree of n_seq tips has at most floor(n_seq / 2) bottoms
        chain[dst[k] - T] = static_cast<short>(
            n_chains + __popc(mask & ((1u << lane) - 1u)));
      }
      n_chains += __popc(mask);
    }
    for (int span = 1; span < nlev; span <<= 1) {
      for (int base = 0; base < T - 1; base += kLanes) {
        const int j = base + lane;
        const int v = j < T - 1 ? down[inner(down[j], T)] : 0;
        __syncwarp();
        if (j < T - 1) down[j] = static_cast<short>(v);
        __syncwarp();
      }
    }
    __syncwarp();
    for (int k = lane; k < nlev; k += kLanes) {
      const int lc = srcL[k], rc = srcR[k];
      if (lc >= T)
        srcL[k] = static_cast<short>(-1 - chain[inner(down[lc - T], T)]);
      if (rc >= T)
        srcR[k] = static_cast<short>(-1 - chain[inner(down[rc - T], T)]);
      dst[k] = chain[inner(down[dst[k] - T], T)];
    }
    // the K factors of one (level, child, category) per lane and round:
    // K independent expm1 chains, stored once all are there
    for (int p = lane; p < 2 * nlev * C; p += kLanes) {
      R e[K];
      cf.factors(bl[p / C] * rate[p % C], e);
      for (int f = 0; f < K; ++f) fac[p * K + f] = e[f];
    }
    __syncwarp();

    R value = R(0);
    if (active) {
      // A level's plan entry and tip children are read two levels before
      // it is walked, so that a tip's fetch from device memory overlaps
      // two levels and the plan is never waited for.
      const V4 tip0 = tp[0];
      V4 a0 = tip0, b0 = tip0, a1 = tip0, b1 = tip0;
      int sl0 = 0, sr0 = 0, sl1 = 0, sr1 = 0;
      if (0 < nlev) {
        sl0 = srcL[0];
        sr0 = srcR[0];
        fetch_tips(tp, S, sl0, sr0, &a0, &b0);
      }
      if (1 < nlev) {
        sl1 = srcL[1];
        sr1 = srcR[1];
        fetch_tips(tp, S, sl1, sr1, &a1, &b1);
      }
      V4 y[C];
      for (int c = 0; c < C; ++c) y[c] = tip0;   // single-sequence locus
      // the scale factors are multiplied up and their log is taken when
      // the product nears the bottom of float32's range, and at the root
      R logscale = R(0), scale = R(1);
      for (int k = 0; k < nlev; ++k) {
        const int sl = sl0, sr = sr0;
        const V4 ta = a0, tb = b0;
        sl0 = sl1;
        sr0 = sr1;
        a0 = a1;
        b0 = b1;
        if (k + 2 < nlev) {
          sl1 = srcL[k + 2];
          sr1 = srcR[k + 2];
          fetch_tips(tp, S, sl1, sr1, &a1, &b1);
        }
        const int d = dst[k];
        const R* eL = fac + 2 * k * C * K;
        const R* eR = eL + C * K;
        R m = R(0);
        for (int c = 0; c < C; ++c) {
          const V4 xl = sl >= 0 ? ta : cv[((-1 - sl) * C + c) * kLanes];
          const V4 xr = sr >= 0 ? tb : cv[((-1 - sr) * C + c) * kLanes];
          y[c] = mul4<R>(cf.apply(xl, eL + c * K), cf.apply(xr, eR + c * K));
          m = Rt::max_(m, max4<R>(y[c]));
        }
        m = Rt::max_(m, Rt::kTiny);
        const R inv = Rt::rcp(m);   // one reciprocal a level, not 4 C
        for (int c = 0; c < C; ++c) y[c] = scale4<R>(y[c], inv);
        if (k + 1 < nlev)
          for (int c = 0; c < C; ++c) cv[(d * C + c) * kLanes] = y[c];
        const R sm = scale * m;
        if (sm < Rt::kFlush) {
          logscale += Rt::log_(scale) + Rt::log_(m);
          scale = R(1);
        } else {
          scale = sm;
        }
      }
      R lik = R(0);
      for (int c = 0; c < C; ++c)
        lik += (R(1) / C) * (f0 * y[c].x + f1 * y[c].y + f2 * y[c].z +
                             f3 * y[c].w);
      value = Rt::log_(Rt::max_(lik, Rt::kTiny)) +
              (logscale + Rt::log_(scale));
    }
    return value;
  }

  // an index into the T - 1 inner nodes, clamped: an inner node that no
  // level names (a locus of fewer than T tips) has no `down` entry written
  static __device__ __forceinline__ int inner(int j, int T) {
    return j < 0 ? 0 : (j > T - 2 ? T - 2 : j);
  }

  // the tip children of one level (a source >= 0) from this lane's column
  static __device__ __forceinline__ void fetch_tips(const V4* tp, int S,
                                                    int sl, int sr,
                                                    V4* xa, V4* xb) {
    if (sl >= 0) *xa = tp[static_cast<int64_t>(sl) * S];
    if (sr >= 0) *xb = tp[static_cast<int64_t>(sr) * S];
  }
};

// The largest high word (sign, exponent, top of the mantissa) of a
// 4-vector of doubles: for values >= 0 it orders them as the values do, to
// the mantissa's top 20 bits, on the integer units.
__device__ __forceinline__ int max_hi4(V4d v) {
  return max(max(__double2hiint(v.x), __double2hiint(v.y)),
             max(__double2hiint(v.z), __double2hiint(v.w)));
}

// The double build's walk of one unit at up to kDoubleWalkMaxCats
// categories, designed for the H100's float64 (PERF.md §6).  It
// computes what UnitWalk computes, with the same prologue, layout and unit
// of work (one warp, up to 32 patterns, C categories a lane); what differs
// is the end of each level, where the float64 build of UnitWalk waited:
//   * No rescale in the common case: a level's CLVs are multiplied by a
//     power of two, 2^-e, only when their largest value (found on the
//     integer units from the values' high words) falls below 2^-512, and
//     e is added to an integer exponent; the root adds e * log(2) once.
//     Scaling by a power of two is exact, so the values are those of an
//     unscaled walk; after a rescale the largest is in [1, 2), and no level
//     can take it from there below double's normal range.  (UnitWalk ends
//     every level with a reciprocal, 4 C multiplies and a running log, all
//     in float64, on the path to the next level.)
//   * A level whose output the next level reads keeps it in registers and
//     does not store it (a CLV is read once, by its parent); the next level
//     takes that child from registers.
//   * A level reads and computes all its categories before it stores any,
//     so that a category's store never stands between the next one's loads
//     (under the device scratch, each would be a round trip).
template <int FAM, int C, bool SHARED>
struct DoubleWalk {
  static constexpr int K = Coefs<FAM, double>::K;
  // the high word of 2^-512: a level rescales when its largest value's is
  // lower
  static constexpr int kLowHi = (1023 - 512) << 20;
  // a source no level has (tips are >= 0, slots < 0)
  static constexpr int kNone = 1 << 30;

  static __device__ double run(const TreeArgs<double>& a,
                               unsigned char* region, int u, int4 unit,
                               int lane) {
    const int T = a.T, S = a.S, N = 2 * T - 1;
    const int64_t l = unit.x;
    const int64_t cl = chain_row(a, l);       // l in the chain's rows
    const bool active = lane < unit.z;
    const WarpLayout w = warp_layout(T, C, K, SHARED, sizeof(double));
    double* fac = reinterpret_cast<double*>(region + w.fac);
    double* bl = reinterpret_cast<double*>(region + w.blen);
    double* rate = reinterpret_cast<double*>(region + w.rate);
    short* srcL = reinterpret_cast<short*>(region + w.plan);
    short* srcR = srcL + (T - 1);
    short* dst = srcR + (T - 1);
    short* down = dst + (T - 1);
    short* chain = down + (T - 1);

    const V4d* tp = a.tips + (l * T) * S + (unit.y + lane);
    V4d* cv;
    if constexpr (SHARED)
      cv = reinterpret_cast<V4d*>(region + w.clv) + lane;
    else
      cv = a.scratch + chain_unit(a, u) * w.slots * C * kLanes + lane;

    // prologue 1 and 2: UnitWalk's
    const int nlev = static_cast<int>(a.n_seq[l]) - 1;
    const double mu = a.blen != nullptr ? 1.0 : a.mu[cl];
    const double* len = (a.blen != nullptr ? a.blen : a.age) + cl * N;
    const double* fq = a.freqs + cl * 4;
    const double f0 = fq[0], f1 = fq[1], f2 = fq[2], f3 = fq[3];
    Coefs<FAM, double> cf;
    cf.load(a, cl, C);
    const double my_rate = lane < C ? a.rates[cl * (C + 2) + lane] : 0.0;
    const int64_t* order = a.order + cl * (T - 1);
    const int64_t* left = a.left + cl * N;
    const int64_t* right = a.right + cl * N;
    for (int k = lane; k < T - 1; k += kLanes) {
      int node = static_cast<int>(order[k]);
      node = node < T ? T : (node >= N ? N - 1 : node);
      int lc = static_cast<int>(left[node]);
      int rc = static_cast<int>(right[node]);
      lc = lc < 0 ? 0 : (lc >= N ? N - 1 : lc);
      rc = rc < 0 ? 0 : (rc >= N ? N - 1 : rc);
      double tl = len[lc], tr = len[rc];
      if (a.blen == nullptr) {
        const double an = len[node];
        tl = fmax(an - tl, 0.0) * mu;
        tr = fmax(an - tr, 0.0) * mu;
      }
      srcL[k] = static_cast<short>(lc);
      srcR[k] = static_cast<short>(rc);
      dst[k] = static_cast<short>(node);
      down[node - T] =
          static_cast<short>((lc >= T ? lc : (rc >= T ? rc : node)) - T);
      chain[k] = 0;
      bl[2 * k] = tl;
      bl[2 * k + 1] = tr;
    }
    if (lane < C) rate[lane] = my_rate;
    cf.prepare();
    __syncwarp();
    int n_chains = 0;
    for (int base = 0; base < nlev; base += kLanes) {
      const int k = base + lane;
      const bool bottom = k < nlev && srcL[k] < T && srcR[k] < T;
      const unsigned mask = __ballot_sync(0xffffffffu, bottom);
      if (bottom) {
        chain[dst[k] - T] = static_cast<short>(
            n_chains + __popc(mask & ((1u << lane) - 1u)));
      }
      n_chains += __popc(mask);
    }
    for (int span = 1; span < nlev; span <<= 1) {
      for (int base = 0; base < T - 1; base += kLanes) {
        const int j = base + lane;
        const int v = j < T - 1 ? down[inner(down[j], T)] : 0;
        __syncwarp();
        if (j < T - 1) down[j] = static_cast<short>(v);
        __syncwarp();
      }
    }
    __syncwarp();
    for (int k = lane; k < nlev; k += kLanes) {
      const int lc = srcL[k], rc = srcR[k];
      if (lc >= T)
        srcL[k] = static_cast<short>(-1 - chain[inner(down[lc - T], T)]);
      if (rc >= T)
        srcR[k] = static_cast<short>(-1 - chain[inner(down[rc - T], T)]);
      dst[k] = chain[inner(down[dst[k] - T], T)];
    }
    for (int p = lane; p < 2 * nlev * C; p += kLanes) {
      double e[K];
      cf.factors(bl[p / C] * rate[p % C], e);
      for (int f = 0; f < K; ++f) fac[p * K + f] = e[f];
    }
    __syncwarp();

    double value = 0.0;
    if (active) {
      // tips are read one level before the level that takes them (two,
      // as UnitWalk does, measured slower here)
      const V4d tip0 = tp[0];
      V4d a0 = tip0, b0 = tip0;
      int sl0 = 0, sr0 = 0;
      if (0 < nlev) {
        sl0 = srcL[0];
        sr0 = srcR[0];
        fetch_tips(tp, S, sl0, sr0, &a0, &b0);
      }
      V4d y[C];
      for (int c = 0; c < C; ++c) y[c] = tip0;   // single-sequence locus
      int expo = 0;        // the CLVs are the walk's values times 2^expo
      int held = kNone;    // the source whose CLVs y holds, unstored
      for (int k = 0; k < nlev; ++k) {
        const int sl = sl0, sr = sr0;
        const V4d ta = a0, tb = b0;
        if (k + 1 < nlev) {
          sl0 = srcL[k + 1];
          sr0 = srcR[k + 1];
          fetch_tips(tp, S, sl0, sr0, &a0, &b0);
        }
        const int d = dst[k];
        const bool last = k + 1 == nlev;
        // the next level reads this one's output: keep it in y
        const bool hold = !last && (sl0 == -1 - d || sr0 == -1 - d);
        const bool fromL = sl == held, fromR = sr == held;
        const double* eL = fac + 2 * k * C * K;
        const double* eR = eL + C * K;
        int hi = 0;
        for (int c = 0; c < C; ++c) {
          const V4d xl = fromL ? y[c]
                               : (sl >= 0 ? ta
                                          : cv[((-1 - sl) * C + c) * kLanes]);
          const V4d xr = fromR ? y[c]
                               : (sr >= 0 ? tb
                                          : cv[((-1 - sr) * C + c) * kLanes]);
          y[c] = mul4<double>(cf.apply(xl, eL + c * K),
                              cf.apply(xr, eR + c * K));
          hi = max(hi, max_hi4(y[c]));
        }
        if (!last) {
          if (hi < kLowHi && hi > 0) {
            // the largest value's binary exponent (-1023 if subnormal),
            // and 2^-e, exact
            const int e = (hi >> 20) - 1023;
            const double s = __hiloint2double((1023 - e) << 20, 0);
            expo += e;
            for (int c = 0; c < C; ++c) y[c] = scale4<double>(y[c], s);
          }
          if (!hold)
            for (int c = 0; c < C; ++c) cv[(d * C + c) * kLanes] = y[c];
        }
        held = hold ? -1 - d : kNone;
      }
      double lik = 0.0;
      for (int c = 0; c < C; ++c)
        lik += (1.0 / C) * (f0 * y[c].x + f1 * y[c].y + f2 * y[c].z +
                            f3 * y[c].w);
      value = log(fmax(lik, kMinNormal)) + expo * kLn2;
    }
    return value;
  }

  static constexpr double kMinNormal = 2.2250738585072014e-308;
  static constexpr double kLn2 = 0.69314718055994530942;

  static __device__ __forceinline__ int inner(int j, int T) {
    return j < 0 ? 0 : (j > T - 2 ? T - 2 : j);
  }

  static __device__ __forceinline__ void fetch_tips(const V4d* tp, int S,
                                                    int sl, int sr,
                                                    V4d* xa, V4d* xb) {
    if (sl >= 0) *xa = tp[static_cast<int64_t>(sl) * S];
    if (sr >= 0) *xb = tp[static_cast<int64_t>(sr) * S];
  }
};

// The double build's walk: DoubleWalk up to kDoubleWalkMaxCats categories,
// UnitWalk's above, where DoubleWalk measured slower on either store
// (NVIDIA H100 80GB HBM3, 700 W; PERF.md §6).
constexpr int kDoubleWalkMaxCats = 3;

template <int FAM, int C, bool SHARED>
using DoubleBuildWalk =
    std::conditional_t<(C <= kDoubleWalkMaxCats), DoubleWalk<FAM, C, SHARED>,
                       UnitWalk<double, FAM, C, SHARED>>;

// Run `Launch<R, FAM, C, SHARED>::run(args...)` (an int: 0 or a
// cudaError) for the runtime family, category count and CLV store; -1 for
// a combination the kernels do not take.
template <template <typename, int, int, bool> class Launch, typename R,
          int FAM, bool SHARED, typename... A>
int dispatch_cats(int C, A&&... args) {
  switch (C) {
    case 1: return Launch<R, FAM, 1, SHARED>::run(args...);
    case 2: return Launch<R, FAM, 2, SHARED>::run(args...);
    case 3: return Launch<R, FAM, 3, SHARED>::run(args...);
    case 4: return Launch<R, FAM, 4, SHARED>::run(args...);
    case 5: return Launch<R, FAM, 5, SHARED>::run(args...);
    case 6: return Launch<R, FAM, 6, SHARED>::run(args...);
    case 7: return Launch<R, FAM, 7, SHARED>::run(args...);
    case 8: return Launch<R, FAM, 8, SHARED>::run(args...);
    default: return -1;
  }
}

template <template <typename, int, int, bool> class Launch, typename R,
          bool SHARED, typename... A>
int dispatch_family(int fam, int C, A&&... args) {
  switch (fam) {
    case FAM_JC69:
      return dispatch_cats<Launch, R, FAM_JC69, SHARED>(C, args...);
    case FAM_TN93:
      return dispatch_cats<Launch, R, FAM_TN93, SHARED>(C, args...);
    case FAM_GTR:
      return dispatch_cats<Launch, R, FAM_GTR, SHARED>(C, args...);
    default: return -1;
  }
}

template <template <typename, int, int, bool> class Launch, typename R,
          typename... A>
int dispatch(int fam, int C, bool shared, A&&... args) {
  return shared ? dispatch_family<Launch, R, true>(fam, C, args...)
                : dispatch_family<Launch, R, false>(fam, C, args...);
}

// Dynamic shared memory of a block of `threads` for this tree size, with
// values of rb bytes.
inline long long block_shared_bytes(int T, int C, int fam, bool shared,
                                    int threads, int rb) {
  return warp_layout(T, C, family_factors(fam), shared, rb).bytes *
         (threads / kLanes);
}

// Raise a kernel's dynamic shared memory limit to `bytes` where that is
// above `*allowed` (48 KB until raised); 0 or the cudaError.
template <typename Kernel>
int allow_shared(Kernel kernel, long long bytes, long long* allowed) {
  if (bytes <= *allowed) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) {
    cudaGetLastError();   // reported here, not by the next launch
    return static_cast<int>(e);
  }
  *allowed = bytes;
  return 0;
}

// Blocks of `threads` one SM holds of `kernel` with `bytes` of dynamic
// shared memory (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or -1 on
// an error.  The kernel's limit is raised to `bytes` where it is lower (a
// launch raises it to what it asks for itself: allow_shared).
template <typename Kernel>
int occupancy(Kernel kernel, int threads, long long bytes) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e == cudaSuccess && bytes > attr.maxDynamicSharedSizeBytes)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kernel, threads, static_cast<size_t>(bytes));
  if (e != cudaSuccess) {
    cudaGetLastError();
    return -1;
  }
  return blocks;
}

template <typename R>
TreeArgs<R> tree_args(const void* tips, const void* age, const void* blen,
                      const void* mu, const void* rates, const void* freqs,
                      const void* eigw, const void* eigT, const void* eigTi,
                      const void* order, const void* left, const void* right,
                      const void* n_seq, const void* units, void* scratch,
                      int T, int S, int U, int L) {
  using V4 = typename Real<R>::V4;
  TreeArgs<R> a;
  a.tips = static_cast<const V4*>(tips);
  a.age = static_cast<const R*>(age);
  a.blen = static_cast<const R*>(blen);
  a.mu = static_cast<const R*>(mu);
  a.rates = static_cast<const R*>(rates);
  a.freqs = static_cast<const R*>(freqs);
  a.eigw = static_cast<const R*>(eigw);
  a.eigT = static_cast<const R*>(eigT);
  a.eigTi = static_cast<const R*>(eigTi);
  a.order = static_cast<const int64_t*>(order);
  a.left = static_cast<const int64_t*>(left);
  a.right = static_cast<const int64_t*>(right);
  a.n_seq = static_cast<const int64_t*>(n_seq);
  a.units = static_cast<const int4*>(units);
  a.scratch = static_cast<V4*>(scratch);
  a.T = T;
  a.S = S;
  a.U = U;
  a.L = L;
  return a;
}

}  // namespace bpp
