// Device code shared by the two pruning kernels (pack_kernel.cu, K1, and
// fels_kernel.cu, K2): the per-family contraction P(t)·x and the walk of
// one site pattern up its locus's gene tree.
//
// P(t)·x is applied by model family with the algebra of
// bpp_tpu/core/pallas_fels.py (JC69 `e·x + ¼(1−e)Σx`; TN93 class
// eigen-factors; GTR `x + T(em ⊙ T⁻¹x)`), but every factor arrives as
// m = e − 1 = expm1(λt) from one elementwise pass in PyTorch
// (core/efactors.py), so that P(t)·x = x + (terms in m).  The literal
// `1 − e` keeps few digits in f32 on branches of ~1e-5; at 1000 loci that
// cost 0.024 lnL on one locus against the f64 plain version.
//
// site_logl() is one thread's work for one (locus, pattern): it walks the
// locus's age-sorted inner nodes k < n_seq − 1, reading each node's two
// children by node id (tips from the [T, S] float4 partials, inner nodes
// from a global CLV scratch [T−1, C, S] float4, so neighbouring threads
// touch neighbouring 16-byte words), rescales every level by the per-site
// max over categories and states (floored at 1e-30, the log scale
// accumulates), and returns log(Σ_c Σ_a π_a clv / C) + Σ log scale at the
// root.  A locus with one sequence is rooted at tip 0.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace bpp {

constexpr float kTiny = 1e-30f;

enum { FAM_JC69 = 0, FAM_TN93 = 1, FAM_GTR = 2 };

template <int FAM> struct Coefs;

template <> struct Coefs<FAM_JC69> {
  static constexpr int K = 1;
  __device__ void load(const float*, const float*, const float*, int64_t) {}
  // y = e x + (1-e)/4 Σx, as x + m (x - Σx/4) with m = e - 1
  __device__ float4 apply(float4 x, const float* e) const {
    const float m = e[0];
    const float q = 0.25f * ((x.x + x.y) + (x.z + x.w));
    return make_float4(x.x + m * (x.x - q), x.y + m * (x.y - q),
                       x.z + m * (x.z - q), x.w + m * (x.w - q));
  }
};

template <> struct Coefs<FAM_TN93> {
  static constexpr int K = 3;
  float pa, pc, pg, pt, rR, rY, cA, cG, cC, cT;
  __device__ void load(const float* coefs, const float*, const float*,
                       int64_t l) {
    const float* c = coefs + l * 10;
    pa = c[0]; pc = c[1]; pg = c[2]; pt = c[3]; rR = c[4]; rY = c[5];
    cA = c[6]; cG = c[7]; cC = c[8]; cT = c[9];
  }
  // pallas_fels's UR + cA e3 (xA - xG) etc., with every e = 1 + m so
  // that the t = 0 identity cancels algebraically: y = x + corrections
  __device__ float4 apply(float4 x, const float* e) const {
    const float m2 = e[0], m3 = e[1], m4 = e[2];
    const float WR = pa * x.x + pg * x.z;
    const float WY = pc * x.y + pt * x.w;
    const float uR = m2 * (rR * WR - WY);
    const float uY = m2 * (rY * WY - WR);
    const float dRG = m3 * (x.x - x.z);
    const float dCT = m4 * (x.y - x.w);
    return make_float4(x.x + (uR + cA * dRG), x.y + (uY + cC * dCT),
                       x.z + (uR - cG * dRG), x.w + (uY - cT * dCT));
  }
};

template <> struct Coefs<FAM_GTR> {
  static constexpr int K = 4;
  float T[16], Ti[16];
  __device__ void load(const float*, const float* eigT, const float* eigTi,
                       int64_t l) {
    for (int i = 0; i < 16; ++i) {
      T[i] = eigT[l * 16 + i];
      Ti[i] = eigTi[l * 16 + i];
    }
  }
  __device__ float4 apply(float4 x, const float* e) const {
    float z[4];
    for (int k = 0; k < 4; ++k)
      z[k] = e[k] * (Ti[k * 4 + 0] * x.x + Ti[k * 4 + 1] * x.y +
                     Ti[k * 4 + 2] * x.z + Ti[k * 4 + 3] * x.w);
    float y[4];
    for (int i = 0; i < 4; ++i)
      y[i] = T[i * 4 + 0] * z[0] + T[i * 4 + 1] * z[1] +
             T[i * 4 + 2] * z[2] + T[i * 4 + 3] * z[3];
    return make_float4(x.x + y[0], x.y + y[1], x.z + y[2], x.w + y[3]);
  }
};

__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}

__device__ __forceinline__ float4 div4(float4 a, float m) {
  return make_float4(a.x / m, a.y / m, a.z / m, a.w / m);
}

__device__ __forceinline__ float max4(float4 a) {
  return fmaxf(fmaxf(a.x, a.y), fmaxf(a.z, a.w));
}

// What both kernels take (tensors of the whole batch, on the card).
struct TreeArgs {
  const float4* tips;      // [L, T, S] float4
  const float* efac;       // [L, N, C, K]
  const float* coefs;      // [L, 10] (TN93 class)
  const float* eigT;       // [L, 16] (GTR)
  const float* eigTi;      // [L, 16] (GTR)
  const float* freqs;      // [L, 4]
  const int64_t* order;    // [L, T-1]
  const int64_t* left;     // [L, N]
  const int64_t* right;    // [L, N]
  const int64_t* n_seq;    // [L]
  float4* scratch;         // [L, T-1, C, S] float4
  int T, S;
};

// One locus's slices of TreeArgs, with its contraction coefficients.
template <int FAM, int C>
struct Locus {
  Coefs<FAM> cf;
  const float4* tips;
  float4* scr;
  const int64_t* order;
  const int64_t* left;
  const int64_t* right;
  const float* efac;
  float f0, f1, f2, f3;
  int T, S, nlev;

  __device__ void load(const TreeArgs& a, int64_t l) {
    constexpr int K = Coefs<FAM>::K;
    T = a.T;
    S = a.S;
    const int N = 2 * T - 1;
    const int64_t ns = a.n_seq[l];
    nlev = ns >= 2 ? static_cast<int>(ns - 1) : 0;
    cf.load(a.coefs, a.eigT, a.eigTi, l);
    f0 = a.freqs[l * 4 + 0];
    f1 = a.freqs[l * 4 + 1];
    f2 = a.freqs[l * 4 + 2];
    f3 = a.freqs[l * 4 + 3];
    tips = a.tips + l * T * S;
    scr = a.scratch + l * (T - 1) * C * S;
    order = a.order + l * (T - 1);
    left = a.left + l * N;
    right = a.right + l * N;
    efac = a.efac + l * N * C * K;
  }

  // log-likelihood of pattern s
  __device__ float site_logl(int s) const {
    constexpr int K = Coefs<FAM>::K;
    float logscale = 0.0f;
    float4 root[C];
    const float4 tip0 = tips[s];
    for (int c = 0; c < C; ++c) root[c] = tip0;   // single-sequence locus
    for (int k = 0; k < nlev; ++k) {
      const int64_t node = order[k];
      const int64_t lc = left[node];
      const int64_t rc = right[node];
      float4 y[C];
      float m = 0.0f;
      for (int c = 0; c < C; ++c) {
        const float4 xl = lc < T ? tips[lc * S + s]
                                 : scr[((lc - T) * C + c) * S + s];
        const float4 xr = rc < T ? tips[rc * S + s]
                                 : scr[((rc - T) * C + c) * S + s];
        y[c] = mul4(cf.apply(xl, efac + (lc * C + c) * K),
                    cf.apply(xr, efac + (rc * C + c) * K));
        m = fmaxf(m, max4(y[c]));
      }
      m = fmaxf(m, kTiny);
      for (int c = 0; c < C; ++c) {
        y[c] = div4(y[c], m);
        scr[((node - T) * C + c) * S + s] = y[c];
        root[c] = y[c];
      }
      logscale += logf(m);
    }
    float lik = 0.0f;
    for (int c = 0; c < C; ++c)
      lik += (1.0f / C) * (f0 * root[c].x + f1 * root[c].y +
                           f2 * root[c].z + f3 * root[c].w);
    return logf(fmaxf(lik, kTiny)) + logscale;
  }
};

// Run `Launch<FAM, C>::run(args...)` for the runtime family and category
// count; -1 for a combination the kernels do not take.
constexpr int kMaxCats = 8;

template <template <int, int> class Launch, int FAM, typename... A>
int dispatch_cats(int C, A&&... args) {
  switch (C) {
    case 1: Launch<FAM, 1>::run(args...); break;
    case 2: Launch<FAM, 2>::run(args...); break;
    case 3: Launch<FAM, 3>::run(args...); break;
    case 4: Launch<FAM, 4>::run(args...); break;
    case 5: Launch<FAM, 5>::run(args...); break;
    case 6: Launch<FAM, 6>::run(args...); break;
    case 7: Launch<FAM, 7>::run(args...); break;
    case 8: Launch<FAM, 8>::run(args...); break;
    default: return -1;
  }
  return 0;
}

template <template <int, int> class Launch, typename... A>
int dispatch(int fam, int C, A&&... args) {
  switch (fam) {
    case FAM_JC69: return dispatch_cats<Launch, FAM_JC69>(C, args...);
    case FAM_TN93: return dispatch_cats<Launch, FAM_TN93>(C, args...);
    case FAM_GTR: return dispatch_cats<Launch, FAM_GTR>(C, args...);
    default: return -1;
  }
}

inline TreeArgs tree_args(const void* tips, const void* efac,
                          const void* coefs, const void* eigT,
                          const void* eigTi, const void* freqs,
                          const void* order, const void* left,
                          const void* right, const void* n_seq,
                          void* scratch, int T, int S) {
  TreeArgs a;
  a.tips = static_cast<const float4*>(tips);
  a.efac = static_cast<const float*>(efac);
  a.coefs = static_cast<const float*>(coefs);
  a.eigT = static_cast<const float*>(eigT);
  a.eigTi = static_cast<const float*>(eigTi);
  a.freqs = static_cast<const float*>(freqs);
  a.order = static_cast<const int64_t*>(order);
  a.left = static_cast<const int64_t*>(left);
  a.right = static_cast<const int64_t*>(right);
  a.n_seq = static_cast<const int64_t*>(n_seq);
  a.scratch = static_cast<float4*>(scratch);
  a.T = T;
  a.S = S;
  return a;
}

}  // namespace bpp
