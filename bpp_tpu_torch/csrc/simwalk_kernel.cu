// K5 `simspr_walk`: the walk of MSC-M's simulation-based SPR on the card,
// in float or (for --x64) double, one thread a locus.
//
// It replaces no Pallas kernel.  It replaces the while loop of
// bpp_tpu/mcmc/mig_moves.py:765 (`spr_sim_move`'s walk, `sim_body` at
// :709): the pruned lineage of every locus walks up the rest of its gene
// tree under the structured coalescent until it coalesces, fails (more
// migration events than the slots hold) or runs out of steps.  The port
// ran it as blocks of torch ops with a host read ("is any lineage still
// walking?") a block, which kept MSC-M off the captured step.
//
// What bounds it on an H100: the longest walk.  A thread takes its
// locus's steps one after another, and a step reads every sub-edge of the
// locus (E of them) to count the lineages in the walker's population and
// find the next boundary; the launch lasts as long as its slowest locus
// (at most `S` steps).  Bytes are small: the [L, E] sub-edge arrays once
// each (from L1/L2 after the first step), the uniforms the steps take.
//
// Design: 128 threads a block, one locus a thread.  The species tables
// (the ancestor-or-self table `pptable` [H, H] in place of bpp_tpu's
// per-sub-edge ancestor rows [L, E, H], tau, the parents' taus, theta,
// parent) and the route tables (source, target, the source's lifetime)
// sit in shared memory.  The draws are made before the launch, one block
// of uniforms [3, S, L] from the chain's generator (step s of locus l
// reads u[0..2][s][l], coalesced across a warp), so the kernel draws
// nothing and the plain version (mig_moves.simspr_walk_ref) reads the same
// numbers: the waiting time is -log1p(-u0) / rate, the event kind compares
// u1 x rate with the migration rate, the donor route is the first whose
// cumulative rate exceeds u2 x the total.  A thread whose lineage is done
// or failed leaves the loop: a step after that changes nothing.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;

template <typename T>
__global__ void simwalk_kernel(
    const T* __restrict__ t_lo, const T* __restrict__ t_hi,
    const int64_t* __restrict__ pop_lo, const bool* __restrict__ live_e,
    const bool* __restrict__ pptable, const T* __restrict__ tau,
    const T* __restrict__ partau_f, const T* __restrict__ theta,
    const int64_t* __restrict__ parent, const int64_t* __restrict__ si,
    const int64_t* __restrict__ ti, const T* __restrict__ d_lo,
    const T* __restrict__ d_hi, const T* __restrict__ route_M,
    const T* __restrict__ heredity, const T* __restrict__ t0,
    const int64_t* __restrict__ p0, const bool* __restrict__ is_valid,
    const T* __restrict__ unif, T* __restrict__ t_out,
    int64_t* __restrict__ p_out, bool* __restrict__ done_out,
    bool* __restrict__ fail_out, T* __restrict__ nt,
    int64_t* __restrict__ ns, int64_t* __restrict__ nd,
    int64_t* __restrict__ nn_out, int L, int E, int H, int K, int ME, int S,
    T big, T tiny, T cum_floor) {
  extern __shared__ unsigned char smem[];
  // layout: int64 arrays first (8-byte aligned), then T, then bytes
  int64_t* s_parent = reinterpret_cast<int64_t*>(smem);
  int64_t* s_si = s_parent + H;
  int64_t* s_ti = s_si + K;
  T* s_tau = reinterpret_cast<T*>(s_ti + K);
  T* s_partau = s_tau + H;
  T* s_theta = s_partau + H;
  T* s_dlo = s_theta + H;
  T* s_dhi = s_dlo + K;
  unsigned char* s_pp = reinterpret_cast<unsigned char*>(s_dhi + K);
  for (int j = threadIdx.x; j < H; j += blockDim.x) {
    s_tau[j] = tau[j];
    s_partau[j] = partau_f[j];
    s_theta[j] = theta[j];
    s_parent[j] = parent[j];
  }
  for (int j = threadIdx.x; j < K; j += blockDim.x) {
    s_dlo[j] = d_lo[j];
    s_dhi[j] = d_hi[j];
    s_si[j] = si[j];
    s_ti[j] = ti[j];
  }
  for (int j = threadIdx.x; j < H * H; j += blockDim.x)
    s_pp[j] = pptable[j] ? 1 : 0;
  __syncthreads();

  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  const T inf = static_cast<T>(INFINITY);
  T t = t0[l];
  int64_t p = p0[l];
  bool done = false, fail = false;
  int64_t nn = 0;
  const bool valid = is_valid[l];
  const T h = heredity[l];
  const T* lo_e = t_lo + static_cast<size_t>(l) * E;
  const T* hi_e = t_hi + static_cast<size_t>(l) * E;
  const int64_t* pop_e = pop_lo + static_cast<size_t>(l) * E;
  const bool* live = live_e + static_cast<size_t>(l) * E;
  const T* rM = route_M + static_cast<size_t>(l) * K;
  for (int s = 0; s < S; ++s) {
    if (done || fail || !valid) break;
    // lineages of the rest of the tree in p at t, and the next boundary
    const T tau_p = s_tau[p], end_p = s_partau[p];
    int64_t n = 0;
    T nb = big;
    for (int e = 0; e < E; ++e) {
      if (!live[e]) continue;
      int64_t q = pop_e[e];
      if (q < 0) q += H;
      if (!s_pp[q * H + p]) continue;
      const T lo = lo_e[e] > tau_p ? lo_e[e] : tau_p;
      const T hi = hi_e[e] < end_p ? hi_e[e] : end_p;
      if (lo <= t && t < hi) ++n;
      if (lo > t && lo < nb) nb = lo;
      if (hi > t && hi < nb) nb = hi;
    }
    if (end_p < nb) nb = end_p;
    T mrs = 0;
    for (int k = 0; k < K; ++k) {
      if (s_ti[k] != p) continue;
      const T a = s_dlo[k], b = s_dhi[k];
      if (a > t && a < nb) nb = a;
      if (b > t && b < nb) nb = b;
      if (a <= t && t < b) mrs += rM[k];
    }
    T th = s_theta[p] * h;
    if (th < tiny) th = tiny;
    const T crate = static_cast<T>(2) * static_cast<T>(n) / th;
    const T rate = crate + mrs;
    const size_t at = static_cast<size_t>(s) * L + l;
    const T u0 = unif[at];
    const T u1 = unif[static_cast<size_t>(S) * L + at];
    const T u2 = unif[2 * static_cast<size_t>(S) * L + at];
    const T delta = rate > 0 ? -log1p(-u0) / rate : inf;
    const T t_ev = t + delta;
    const bool hit = t_ev < nb;
    const T u = u1 * rate;
    const bool is_coal = hit && u >= mrs;
    const bool is_mig = hit && u < mrs;
    // the donor route: the first whose cumulative rate exceeds r (mrs is
    // the last cumulative rate: both sums run in route order)
    const T r = u2 * (mrs > cum_floor ? mrs : cum_floor);
    int64_t dpick = s_si[0];
    T cum = 0;
    for (int k = 0; k < K; ++k) {
      const bool ok = s_ti[k] == p && s_dlo[k] <= t && t < s_dhi[k];
      cum += ok ? rM[k] : static_cast<T>(0);
      if (cum > r) {
        dpick = s_si[k];
        break;
      }
    }
    if (is_mig) {
      if (nn < ME) {
        const size_t slot = static_cast<size_t>(l) * ME + nn;
        nt[slot] = t_ev;
        ns[slot] = p;
        nd[slot] = dpick;
        ++nn;
      } else {
        fail = true;
      }
    }
    int64_t p_next = is_mig ? dpick : p;
    if (!hit && nb >= end_p) p_next = s_parent[p] < 0 ? 0 : s_parent[p];
    t = hit ? t_ev : nb;
    p = p_next;
    if (is_coal) done = true;
  }
  t_out[l] = t;
  p_out[l] = p;
  done_out[l] = done;
  fail_out[l] = fail;
  nn_out[l] = nn;
}

template <typename T>
size_t shared_bytes(int H, int K) {
  return (3 * static_cast<size_t>(H) + 2 * K) * sizeof(T)
         + (static_cast<size_t>(H) + 2 * K) * sizeof(int64_t)
         + static_cast<size_t>(H) * H;
}

template <typename T>
int simwalk(const void* t_lo, const void* t_hi, const void* pop_lo,
            const void* live_e, const void* pptable, const void* tau,
            const void* partau_f, const void* theta, const void* parent,
            const void* si, const void* ti, const void* d_lo,
            const void* d_hi, const void* route_M, const void* heredity,
            const void* t0, const void* p0, const void* is_valid,
            const void* unif, void* t, void* p, void* done, void* fail,
            void* nt, void* ns, void* nd, void* nn, int L, int E, int H,
            int K, int ME, int S, double big, double tiny,
            cudaStream_t stream) {
  const size_t bytes = shared_bytes<T>(H, K);
  if (bytes > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (L + kThreads - 1) / kThreads;
  simwalk_kernel<T><<<blocks, kThreads, bytes, stream>>>(
      static_cast<const T*>(t_lo), static_cast<const T*>(t_hi),
      static_cast<const int64_t*>(pop_lo), static_cast<const bool*>(live_e),
      static_cast<const bool*>(pptable), static_cast<const T*>(tau),
      static_cast<const T*>(partau_f), static_cast<const T*>(theta),
      static_cast<const int64_t*>(parent), static_cast<const int64_t*>(si),
      static_cast<const int64_t*>(ti), static_cast<const T*>(d_lo),
      static_cast<const T*>(d_hi), static_cast<const T*>(route_M),
      static_cast<const T*>(heredity), static_cast<const T*>(t0),
      static_cast<const int64_t*>(p0), static_cast<const bool*>(is_valid),
      static_cast<const T*>(unif), static_cast<T*>(t),
      static_cast<int64_t*>(p), static_cast<bool*>(done),
      static_cast<bool*>(fail), static_cast<T*>(nt),
      static_cast<int64_t*>(ns), static_cast<int64_t*>(nd),
      static_cast<int64_t*>(nn), L, E, H, K, ME, S, static_cast<T>(big),
      static_cast<T>(tiny), static_cast<T>(1e-300));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int bpp_simwalk_threads() { return kThreads; }

extern "C" int bpp_simwalk(
    const void* t_lo, const void* t_hi, const void* pop_lo,
    const void* live_e, const void* pptable, const void* tau,
    const void* partau_f, const void* theta, const void* parent,
    const void* si, const void* ti, const void* d_lo, const void* d_hi,
    const void* route_M, const void* heredity, const void* t0,
    const void* p0, const void* is_valid, const void* unif, void* t,
    void* p, void* done, void* fail, void* nt, void* ns, void* nd, void* nn,
    int L, int E, int H, int K, int ME, int S, double big, double tiny,
    int dbl, void* stream) {
  if (L <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dbl ? simwalk<double>(t_lo, t_hi, pop_lo, live_e, pptable, tau,
                               partau_f, theta, parent, si, ti, d_lo, d_hi,
                               route_M, heredity, t0, p0, is_valid, unif, t,
                               p, done, fail, nt, ns, nd, nn, L, E, H, K, ME,
                               S, big, tiny, st)
             : simwalk<float>(t_lo, t_hi, pop_lo, live_e, pptable, tau,
                              partau_f, theta, parent, si, ti, d_lo, d_hi,
                              route_M, heredity, t0, p0, is_valid, unif, t, p,
                              done, fail, nt, ns, nd, nn, L, E, H, K, ME, S,
                              big, tiny, st);
}
