// K5 `simspr_walk`: the walk of MSC-M's simulation-based SPR on the card,
// in float or (for --x64) double, one warp a locus.
//
// It replaces no Pallas kernel.  It replaces the while loop of
// bpp_tpu/mcmc/mig_moves.py:765 (`spr_sim_move`'s walk, `sim_body` at
// :709): the pruned lineage of every locus walks up the rest of its gene
// tree under the structured coalescent until it coalesces, fails (more
// migration events than the slots hold) or runs out of steps.  The port
// ran it as blocks of torch ops with a host read ("is any lineage still
// walking?") a block, which kept MSC-M off the captured step.
//
// What bounds it on an H100: the longest walk's chain of dependent steps.
// A step needs the lineages of the rest of the tree alive in the walker's
// population at its time and the next boundary above it, over all E
// sub-edges of its locus (E = N + ME: 63 at 16 tips), and its result (the
// new time and population) is the next step's input.  Bytes are small
// (the [L, E] sub-edges once, three uniforms a step) and so is the work;
// the launch lasts as long as its slowest locus's walk (at most `S`
// steps, ~150 at 16 tips), each step a latency chain.  A thread a locus
// (the first design) spent ~63 serial sub-edge tests on strided loads a
// step and filled 8 of 132 SMs at 1000 loci.
//
// Design: kLanes lanes a locus (a warp), kWarps warps a block, so 1000
// loci are 250 blocks.  The lanes stride over the locus's sub-edges: a
// locus's row is contiguous, so the loads coalesce, and they are made once,
// before the walk, into registers (kEdgeRegs a lane; sub-edges past
// kEdgeRegs x kLanes are read from device memory each step), with the
// sub-edge's population as a 32-bit index that is -1 where the sub-edge is
// not live.  A step then tests its lane's sub-edges, and two butterfly
// reductions across the lanes (__shfl_xor_sync) give the lineage count
// (a sum of integers) and the next boundary (a minimum): neither depends
// on the order of its terms, so every decision and time is bit-identical
// to the one-thread walk's.  The routes are spread over the lanes too: a
// lane tests its routes (do they lead into the walker's population, are
// their sources alive), puts their boundaries into the minimum and writes
// their rates into the locus's row in shared memory; the route sums (the
// migration rate and the donor's cumulative rate) then run serially over
// that row in route order, alike on every lane, so their rounding is the
// one-thread walk's (a route that does not count adds an exact 0, as
// there).  Spread, the route tests leave a geneflow step's 22 candidate
// routes off its chain of dependent loads; a step of 2 routes pays two
// warp syncs for it.  Lane 0 writes the event slots and the outputs.  The
// species tables (the ancestor-or-self table `pptable` [H, H] in place of
// bpp_tpu's per-sub-edge ancestor rows [L, E, H], tau, the parents' taus,
// theta, parent) and the route tables (source, target, the source's
// lifetime) sit in shared memory, with 32-bit indices.  The draws are made before the launch, one block of
// uniforms [3, S, L] from the chain's generator (step s of locus l reads
// u[0..2][s][l]), so the kernel draws nothing and the plain version
// (mig_moves.simspr_walk_ref) reads the same numbers: the waiting time is
// -log1p(-u0) / rate, the event kind compares u1 x rate with the migration
// rate, the donor route is the first whose cumulative rate exceeds u2 x
// the total.  A locus whose lineage is done or failed takes no more steps;
// a warp leaves the loop when none of its loci walks.
//
// Under chains = C (the batched step of C chains, C = 1 for one chain) one
// launch takes the C chains' inputs stacked on a leading chain axis: the
// grid's y index is the chain, and block (x, c) fills its shared tables
// from chain c's species rows and walks chain c's loci x, reading and
// writing only chain c's rows.  Its warps read what they read in a
// one-chain launch on those rows, so each (chain, locus) comes out bit-equal
// to it.  The route table (source, target) does not change over a run and
// is one copy for every chain.  (In this file K counts the routes, so the
// chains are C.)

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// lanes a locus (8, 16 or 32: a divisor of the warp) and warps a block,
// chosen by measurement (chain_variants.py); kLoci loci a block
constexpr int kLanes = 32;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kLoci = kThreads / kLanes;
// sub-edges a lane keeps in registers: 64 a locus, so E = 63 (16 tips)
// never reads device memory after the prologue
constexpr int kEdgeRegs = 64 / kLanes;
constexpr unsigned kFull = 0xffffffffu;

// the population index of a sub-edge (negative indices count from the
// end, as torch indexing does), -1 where the sub-edge is not live
__device__ __forceinline__ int edge_pop(int64_t q, bool live, int H) {
  if (!live) return -1;
  return static_cast<int>(q < 0 ? q + H : q);
}

// one sub-edge's share of a step: whether its lineage is in p at t, and
// the boundaries it puts above t
template <typename T>
__device__ __forceinline__ void scan_edge(int q, T lo_e, T hi_e, int p, int H,
                                          const unsigned char* pp, T tau_p,
                                          T end_p, T t, int& n, T& nb) {
  if (q < 0 || !pp[q * H + p]) return;
  const T lo = lo_e > tau_p ? lo_e : tau_p;
  const T hi = hi_e < end_p ? hi_e : end_p;
  if (lo <= t && t < hi) ++n;
  if (lo > t && lo < nb) nb = lo;
  if (hi > t && hi < nb) nb = hi;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) simwalk_kernel(
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
  // chain c = blockIdx.y: its rows alone, as a one-chain launch reads them
  {
    const size_t c = blockIdx.y;
    const size_t le = c * L * E, lk = c * L * K, lm = c * L * ME;
    t_lo += le;
    t_hi += le;
    pop_lo += le;
    live_e += le;
    pptable += c * H * H;
    tau += c * H;
    partau_f += c * H;
    theta += c * H;
    parent += c * H;
    d_lo += c * K;
    d_hi += c * K;
    route_M += lk;
    heredity += c * L;
    t0 += c * L;
    p0 += c * L;
    is_valid += c * L;
    unif += c * 3 * S * L;
    t_out += c * L;
    p_out += c * L;
    done_out += c * L;
    fail_out += c * L;
    nn_out += c * L;
    nt += lm;
    ns += lm;
    nd += lm;
  }
  extern __shared__ __align__(16) unsigned char smem[];
  // layout: T arrays first, then 32-bit indices, then bytes
  T* s_tau = reinterpret_cast<T*>(smem);
  T* s_partau = s_tau + H;
  T* s_theta = s_partau + H;
  T* s_dlo = s_theta + H;
  T* s_dhi = s_dlo + K;
  T* s_w = s_dhi + K;
  int* s_parent = reinterpret_cast<int*>(s_w + kLoci * K);
  int* s_si = s_parent + H;
  int* s_ti = s_si + K;
  unsigned char* s_pp = reinterpret_cast<unsigned char*>(s_ti + K);
  for (int j = threadIdx.x; j < H; j += blockDim.x) {
    s_tau[j] = tau[j];
    s_partau[j] = partau_f[j];
    s_theta[j] = theta[j];
    s_parent[j] = static_cast<int>(parent[j]);
  }
  for (int j = threadIdx.x; j < K; j += blockDim.x) {
    s_dlo[j] = d_lo[j];
    s_dhi[j] = d_hi[j];
    s_si[j] = static_cast<int>(si[j]);
    s_ti[j] = static_cast<int>(ti[j]);
  }
  for (int j = threadIdx.x; j < H * H; j += blockDim.x)
    s_pp[j] = pptable[j] ? 1 : 0;
  __syncthreads();

  // every lane stays to the end: the reductions take the whole warp
  const int lane = threadIdx.x % kLanes;
  const int l = (blockIdx.x * kThreads + threadIdx.x) / kLanes;
  const bool real = l < L;
  const size_t row = static_cast<size_t>(real ? l : 0) * E;
  T r_lo[kEdgeRegs], r_hi[kEdgeRegs];
  int r_q[kEdgeRegs];
#pragma unroll
  for (int j = 0; j < kEdgeRegs; ++j) {
    const int e = j * kLanes + lane;
    const bool have = real && e < E;
    r_lo[j] = have ? t_lo[row + e] : static_cast<T>(0);
    r_hi[j] = have ? t_hi[row + e] : static_cast<T>(0);
    r_q[j] = have ? edge_pop(pop_lo[row + e], live_e[row + e], H) : -1;
  }
  const T inf = static_cast<T>(INFINITY);
  T t = real ? t0[l] : static_cast<T>(0);
  int p = real ? static_cast<int>(p0[l]) : 0;
  bool done = false, fail = false;
  int nn = 0;
  const bool valid = real && is_valid[l];
  const T h = real ? heredity[l] : static_cast<T>(1);
  const T* rM = route_M + static_cast<size_t>(real ? l : 0) * K;
  // this locus's row of route rates into p at t: each written by the lane
  // its route falls to, summed in route order by every lane
  T* w = s_w + (threadIdx.x / kLanes) * K;
  for (int s = 0; s < S; ++s) {
    const bool act = valid && !done && !fail;
    if (!__any_sync(kFull, act)) break;
    // lineages of the rest of the tree in p at t, and the next boundary:
    // this lane's sub-edges and routes, then the sum and the minimum over
    // the lanes
    int n = 0;
    T nb = big;
    T tau_p = 0, end_p = 0;
    if (act) {
      tau_p = s_tau[p];
      end_p = s_partau[p];
#pragma unroll
      for (int j = 0; j < kEdgeRegs; ++j)
        scan_edge(r_q[j], r_lo[j], r_hi[j], p, H, s_pp, tau_p, end_p, t, n,
                  nb);
      for (int e = kEdgeRegs * kLanes + lane; e < E; e += kLanes)
        scan_edge(edge_pop(pop_lo[row + e], live_e[row + e], H),
                  t_lo[row + e], t_hi[row + e], p, H, s_pp, tau_p, end_p, t,
                  n, nb);
      for (int k = lane; k < K; k += kLanes) {
        T wk = 0;
        if (s_ti[k] == p) {
          const T a = s_dlo[k], b = s_dhi[k];
          if (a > t && a < nb) nb = a;
          if (b > t && b < nb) nb = b;
          if (a <= t && t < b) wk = rM[k];
        }
        w[k] = wk;
      }
    }
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1) {
      n += __shfl_xor_sync(kFull, n, off);
      const T o = __shfl_xor_sync(kFull, nb, off);
      if (o < nb) nb = o;
    }
    __syncwarp(kFull);
    if (act) {
      if (end_p < nb) nb = end_p;
      T mrs = 0;
      for (int k = 0; k < K; ++k) mrs += w[k];
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
      int dpick = K > 0 ? s_si[0] : 0;
      T cum = 0;
      for (int k = 0; k < K; ++k) {
        cum += w[k];
        if (cum > r) {
          dpick = s_si[k];
          break;
        }
      }
      if (is_mig) {
        if (nn < ME) {
          if (lane == 0) {
            const size_t slot = static_cast<size_t>(l) * ME + nn;
            nt[slot] = t_ev;
            ns[slot] = p;
            nd[slot] = dpick;
          }
          ++nn;
        } else {
          fail = true;
        }
      }
      int p_next = is_mig ? dpick : p;
      if (!hit && nb >= end_p) p_next = s_parent[p] < 0 ? 0 : s_parent[p];
      t = hit ? t_ev : nb;
      p = p_next;
      if (is_coal) done = true;
    }
    __syncwarp(kFull);
  }
  if (real && lane == 0) {
    t_out[l] = t;
    p_out[l] = p;
    done_out[l] = done;
    fail_out[l] = fail;
    nn_out[l] = nn;
  }
}

template <typename T>
size_t shared_bytes(int H, int K) {
  return (3 * static_cast<size_t>(H) + (2 + kLoci) * static_cast<size_t>(K))
             * sizeof(T)
         + (static_cast<size_t>(H) + 2 * K) * sizeof(int)
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
            void* nt, void* ns, void* nd, void* nn, int C, int L, int E,
            int H, int K, int ME, int S, double big, double tiny,
            cudaStream_t stream) {
  const size_t bytes = shared_bytes<T>(H, K);
  if (bytes > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (C > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t lanes = static_cast<int64_t>(L) * kLanes;
  const int blocks = static_cast<int>((lanes + kThreads - 1) / kThreads);
  // a grid row a chain
  simwalk_kernel<T><<<dim3(blocks, C), kThreads, bytes, stream>>>(
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

// C chains' walks, one launch (C = 1: one chain); each array holds the
// chains' rows stacked, but si and ti, the run's route table.
extern "C" int bpp_simwalk(
    const void* t_lo, const void* t_hi, const void* pop_lo,
    const void* live_e, const void* pptable, const void* tau,
    const void* partau_f, const void* theta, const void* parent,
    const void* si, const void* ti, const void* d_lo, const void* d_hi,
    const void* route_M, const void* heredity, const void* t0,
    const void* p0, const void* is_valid, const void* unif, void* t,
    void* p, void* done, void* fail, void* nt, void* ns, void* nd, void* nn,
    int C, int L, int E, int H, int K, int ME, int S, double big,
    double tiny, int dbl, void* stream) {
  if (L <= 0 || C <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dbl ? simwalk<double>(t_lo, t_hi, pop_lo, live_e, pptable, tau,
                               partau_f, theta, parent, si, ti, d_lo, d_hi,
                               route_M, heredity, t0, p0, is_valid, unif, t,
                               p, done, fail, nt, ns, nd, nn, C, L, E, H, K,
                               ME, S, big, tiny, st)
             : simwalk<float>(t_lo, t_hi, pop_lo, live_e, pptable, tau,
                              partau_f, theta, parent, si, ti, d_lo, d_hi,
                              route_M, heredity, t0, p0, is_valid, unif, t, p,
                              done, fail, nt, ns, nd, nn, C, L, E, H, K, ME,
                              S, big, tiny, st);
}
