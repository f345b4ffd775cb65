// route_score.cu -- one arrival wave of the LMetric router on a Hopper card.
//
// Replaces the TPU kernel src/repro/kernels/route_score.py::_route_kernel
// (pl.pallas_call at :234) and the jitted lax.fori_loop that shares its
// step body (_run_wave / _wave_step / _pick, :90-212) for the jsq, linear
// and filter kinds.  One launch routes a wave of k requests over n
// instances as a *sequential argmin with feedback*: request j is scored
// against the indicators as requests 0..j-1 of the same wave left them.
// For each j, in order:
//
//   hits   = min(max(depth[j,i], cred[j,i]) * block_size, plen[j])
//   score  = the kind's float64 expression, in the host's exact order of
//            operations (build with -fmad=false: a fused multiply-add
//            would round lam*x + c*y once instead of twice)
//   sel    = the (tie mod count)-th instance, in ascending index order,
//            among the allowed ones with score <= min + eps
//            (eps 1e-9; ptoken: eps 0 and tie 0, i.e. first exact min)
//   feedback: qbs[sel] += 1, qpt[sel] += plen - hit (kinds reading qpt),
//            tt[sel] += plen (kinds reading tt), and the intra-wave KV$
//            credit cred[j', sel] = max(cred[j', sel], lcp[j', j]).
//
// What bounds it.  The function reads, once, the columns its kind scores
// with (lmetric ptoken x bs: 3*n int64), depth (k*n int64, not for jsq),
// the strict lower triangle of lcp, plen and the tie counter, and writes
// sel/hit: 8,799,496 B for lmetric at k=64, n=16384, 2.63 us at
// 3.35 TB/s (chip_smoke.py's wave_bound gives it for every kind).  But
// the k steps are sequential -- step j+1 scores against step j's
// feedback -- so each step is a chain of dependent reductions over the n
// instances that no bandwidth shortens.  On this card the floor per step
// is latency, not bytes: at small n a warp's chain of dependent
// reductions, ballots and FP64 conversions; at large n that chain plus
// block barriers and one round trip through distributed shared memory
// between the SMs of a cluster.  The first kernel (one CTA of 1024
// threads for every wave, scores and tie scans through L2, ~10 block
// barriers a step) took 14.6 us a step at n=16384 and 4.9 us at n=16;
// this one takes ~3 and ~0.6 (PERF.md §6).  An earlier version of
// this design waited at barrier.cluster twice a step and was slower
// than counting the exchanged bytes on mbarriers, as now (PERF.md).
//
// Design: two regimes (kernels/route_score.py::launch_plan picks one).
//
// route_warp (n <= 32: the simulator's and the PD pool's waves).  One
// warp, no block barrier, no global scratch.  Lane i holds instance i's
// working columns in registers; aux (k x (k+2)) and depth (k x n) are
// staged in shared memory once by cp.async where they fit.  Each
// selection folds its credit into the staged depth rows of the later
// requests (max(depth, lcp)), so a step reads one word for its hits.
// The min is two redux.sync over an order-preserving 64-bit key of the
// double, the tie set one __ballot_sync, its rank-r member the lane
// whose popcount of lower ties equals r (lane L keeps tie mod (L+1) as
// the counter steps); the hit comes from the selected lane by
// __shfl_sync, and that lane applies the feedback.
//
// route_cluster (n > 32).  A thread-block cluster of C <= 8 CTAs (the
// portable size; C = 1 up to 1024 instances), launched with
// cudaLaunchKernelEx.  CTA c owns instances [c*P, min((c+1)*P, n)), so
// ascending index order is (CTA, local index) order; inside a CTA thread
// t owns local instances t, t+NT, ... (coalesced loads).
//   State on chip: each thread keeps up to IPT (1, 2 or 4 at 512
//   threads; 8 or 16 at 256) instances' working columns and scores in
//   registers for the whole wave, their credit rows in shared memory;
//   instances beyond IPT*NT per CTA keep them in global scratch (same
//   code, read by the same CTA).
//   Depth rows: row j+1 of the register-held instances is streamed into
//   a two-stage shared-memory ring by cp.async while step j runs.
//   Exchange: each CTA stores its values into a slot of every CTA with
//   st.async, which completes bytes on the receiver's mbarrier; slots
//   and mbarriers alternate by step parity, so that a fast CTA never
//   overwrites a slot a slow one still reads.  Per step:
//     round 1 (linear, filter only): max/min of bs and max of hits;
//     the main round: each CTA's least score and its count of ties at
//       its own least + eps.  Where every CTA's least either equals the
//       global least or lies above it by more than eps, those counts
//       are the counts at the global threshold (0 for the latter); a
//       near-tie across CTAs makes every CTA recount at the global
//       threshold in a second round.  ptoken (eps 0, tie 0) sends its
//       least (score, index) pair and needs no count.
//     Every CTA forms the same prefix over the C counts; only the CTA
//     holding the rank-r tie finds it, from the tie masks of its count
//     pass (warp 0; ascending local order is (row, warp, lane)), writes
//     sel[j] and hit[j], and owes the feedback to the instance's thread
//     for the next step.  Only an instance's owner needs its feedback.
//   Credit: each CTA lists the steps that selected its own instances;
//   while the exchange is in flight its warp 0 rebuilds the next step's
//   credit row (double-buffered) from that list, and the owner adds the
//   new selection.
// A cluster that cannot be scheduled makes the launch fail
// (cudaOccupancyMaxActiveClusters, asked once per configuration), and
// the error is returned to the wrapper, which raises; there is no
// fallback.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <mutex>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr long long I64_MAX = 0x7fffffffffffffffLL;
constexpr long long I64_MIN = -I64_MAX - 1;
constexpr int CLUSTER_MAX = 8;      // portable cluster size
constexpr int MAX_NT = 512;         // threads of a CTA
constexpr int MAX_NW = MAX_NT / 32;
constexpr int WARP_SMEM = 48 * 1024;      // the warp path's staging
constexpr int AUX_SMEM = 64 * 1024;       // aux staged up to this size
constexpr int OWN_SMEM = 16 * 1024;       // own-selection list likewise
constexpr int SMEM_MAX = 227 * 1024;      // a CTA's shared memory

enum Kind { JSQ = 0, LINEAR = 1, FILTER = 2, LMETRIC = 3, PTOKEN = 4 };

struct Args {
  const long long* rbs;      // (n,) device mirror, read only
  const long long* qbs_in;   // (n,)
  const long long* qpt_in;   // (n,)
  const long long* tt_in;    // (n,)
  const long long* depth;    // (k, n) pre-wave index depths; null for jsq
  const long long* aux;      // (k, k+2): lcp | plen | tie
  long long* wb;             // (n,) scratch of off-chip instances: b
  long long* wqp;            //      qpt
  long long* wtk;            //      tt
  long long* crow;           // (2, n) credit rows, by step parity
  double* sc;                //      score of the current step
  int* own;                  // (C, k, 2) int32 own-selection lists (the
                             // warp path: (k,) lanes chosen), where they
                             // do not fit in shared memory
  long long* sel;            // (k,) out: chosen instance
  long long* hit;            // (k,) out: hit tokens at the chosen instance
  int k;
  int n;
  int part;                  // instances per CTA (cluster path)
  int reg_cap;               // instances per CTA held on chip
  long long block_size;
  double lam;                // linear
  long long bs_range;        // filter
  int aux_smem;              // aux staged in shared memory
  int depth_smem;            // depth staged in shared memory (warp path)
  int own_smem;              // own-selection list in shared memory
};

template <int KIND, bool KVP, bool LT>
struct Traits {
  static constexpr bool HITS = KIND != JSQ;
  static constexpr bool QPT = KIND == PTOKEN || (KIND == LMETRIC && KVP);
  static constexpr bool TT = KIND == LMETRIC && LT;
  // b holds qbs for jsq and rbs + qbs for the kinds scoring the batch
  static constexpr bool B = KIND == JSQ || KIND == LINEAR ||
                            KIND == FILTER || (KIND == LMETRIC && !LT);
  static constexpr bool ROUND1 = KIND == LINEAR || KIND == FILTER;
  static constexpr double EPS = KIND == PTOKEN ? 0.0 : 1e-9;
};

// One instance's working columns.
struct St {
  long long b;    // jsq: qbs; batch-scoring kinds: rbs + qbs
  long long r;    // jsq: rbs
  long long qp;   // qpt
  long long tk;   // tt
};

// The step's cluster-wide values the scores need besides the instance.
struct Step {
  long long plen;
  long long max_bs;     // linear
  long long max_hits;   // filter
  bool imbalanced;      // filter
};

__device__ __forceinline__ double inf() {
  return __longlong_as_double(0x7ff0000000000000LL);
}

template <int KIND, bool KVP, bool LT>
__device__ __forceinline__ St load_cols(const Args& a, long long g) {
  using Tr = Traits<KIND, KVP, LT>;
  St s{0, 0, 0, 0};
  if constexpr (KIND == JSQ) {
    s.b = a.qbs_in[g];
    s.r = a.rbs[g];
  } else if constexpr (Tr::B) {
    s.b = a.rbs[g] + a.qbs_in[g];
  }
  if constexpr (Tr::QPT) s.qp = a.qpt_in[g];
  if constexpr (Tr::TT) s.tk = a.tt_in[g];
  return s;
}

template <int KIND, bool KVP, bool LT>
__device__ __forceinline__ void feedback(St& s, long long plen,
                                         long long h) {
  using Tr = Traits<KIND, KVP, LT>;
  if constexpr (Tr::B) s.b += 1;
  if constexpr (Tr::QPT) s.qp += plen - h;
  if constexpr (Tr::TT) s.tk += plen;
}

__device__ __forceinline__ long long hits_of(long long d, long long c,
                                             long long block_size,
                                             long long plen) {
  const long long h = (d > c ? d : c) * block_size;
  return h < plen ? h : plen;
}

// The kind's float64 score, in the host's order of operations; +inf
// marks an instance filter does not allow.
template <int KIND, bool KVP, bool LT>
__device__ __forceinline__ double score_of(const St& s, long long h,
                                           const Step& st, double lam) {
  if constexpr (KIND == JSQ) {
    return 4.0 * (double)s.b + (double)s.r;
  } else if constexpr (KIND == LINEAR) {
    const double L = (double)(st.plen > 1 ? st.plen : 1);
    return lam * (1.0 - (double)h / L)
         + (1.0 - lam) * ((double)s.b / (double)st.max_bs);
  } else if constexpr (KIND == FILTER) {
    return (st.imbalanced || h >= st.max_hits) ? (double)s.b : inf();
  } else if constexpr (KIND == LMETRIC) {
    double x;
    if constexpr (KVP) {
      x = (double)(s.qp + (st.plen - h)) + 1.0;
    } else {
      const double L = (double)(st.plen > 1 ? st.plen : 1);
      x = 1.0 - (double)h / L + 1e-3;
    }
    const double y = LT ? (double)s.tk + 1.0 : (double)s.b + 1.0;
    return x * y;
  } else {
    return (double)(s.qp + (st.plen - h));
  }
}

__device__ __forceinline__ long long tie_rank(long long tie,
                                              long long total) {
  if (total <= 0) return 0;
  if (tie >= 0 && tie <= 0x7fffffffLL && total <= 0x7fffffffLL)
    return static_cast<unsigned>(tie) % static_cast<unsigned>(total);
  long long r = tie % total;           // 64-bit division, rarely taken
  return r < 0 ? r + total : r;
}

// Order-preserving 64-bit keys: key(x) < key(y) iff x < y, for doubles
// (NaN aside; -0.0 keys below +0.0, and every use compares the value back
// as a double) and for signed int64.  Warps reduce keys with redux.sync
// on their halves.
__device__ __forceinline__ unsigned long long dkey(double x) {
  const long long b = __double_as_longlong(x);
  return static_cast<unsigned long long>(b < 0 ? ~b : b ^ I64_MIN);
}
__device__ __forceinline__ double dval(unsigned long long k) {
  const long long b = static_cast<long long>(k);
  return __longlong_as_double(b < 0 ? b ^ I64_MIN : ~b);
}
__device__ __forceinline__ unsigned long long ikey(long long x) {
  return static_cast<unsigned long long>(x ^ I64_MIN);
}
__device__ __forceinline__ long long ival(unsigned long long k) {
  return static_cast<long long>(k) ^ I64_MIN;
}
__device__ __forceinline__ unsigned long long warp_min(unsigned long long k) {
  const unsigned hi = __reduce_min_sync(FULL, static_cast<unsigned>(k >> 32));
  const unsigned lo = __reduce_min_sync(
      FULL, static_cast<unsigned>(k >> 32) == hi ? static_cast<unsigned>(k)
                                                 : 0xffffffffu);
  return (static_cast<unsigned long long>(hi) << 32) | lo;
}
__device__ __forceinline__ unsigned long long warp_max(unsigned long long k) {
  const unsigned hi = __reduce_max_sync(FULL, static_cast<unsigned>(k >> 32));
  const unsigned lo = __reduce_max_sync(
      FULL, static_cast<unsigned>(k >> 32) == hi ? static_cast<unsigned>(k)
                                                 : 0u);
  return (static_cast<unsigned long long>(hi) << 32) | lo;
}
__device__ __forceinline__ unsigned long long umin(unsigned long long a,
                                                  unsigned long long b) {
  return b < a ? b : a;
}
__device__ __forceinline__ unsigned long long umax(unsigned long long a,
                                                  unsigned long long b) {
  return b > a ? b : a;
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_prev() {   // all but the newest
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// the warp path: n <= 32, lane i = instance i
// ---------------------------------------------------------------------------
template <int KIND, bool KVP, bool LT>
__global__ void __launch_bounds__(32) route_warp(Args a) {
  using Tr = Traits<KIND, KVP, LT>;
  // lmetric's load term y = (double)load + 1 changes only with feedback
  constexpr bool CACHE_Y = KIND == LMETRIC;
  extern __shared__ long long smem[];
  const int lane = threadIdx.x, n = a.n, k = a.k;
  const long long ak = (long long)k + 2;
  long long* s_aux = smem;
  long long* s_dep = s_aux + (a.aux_smem ? k * ak : 0);
  int* s_own = reinterpret_cast<int*>(
      s_dep + (Tr::HITS && a.depth_smem ? (long long)k * n : 0));
  const long long* A = a.aux_smem ? s_aux : a.aux;
  // E: depth in shared memory, into which every selection folds its
  // credit for the later rows, so that row j holds max(depth, cred)
  const bool fold = Tr::HITS && a.depth_smem;
  const long long* D = fold ? s_dep : a.depth;
  // without E, lane i's credit is the max of lcp[j, jj] over the steps jj
  // that chose it: bit jj of `chosen` for jj < 64, H[jj] (the lane chosen
  // at jj; every lane writes the same value and reads back only its own
  // writes) beyond
  int* H = a.own_smem ? s_own : a.own;
  if (a.aux_smem)
    for (long long i = lane; i < k * ak; i += 32) cp_async8(s_aux + i, a.aux + i);
  if (fold)
    for (long long i = lane; i < (long long)k * n; i += 32)
      cp_async8(s_dep + i, a.depth + i);
  cp_commit();
  cp_wait_all();
  __syncwarp();

  const bool mine = lane < n;
  St s = mine ? load_cols<KIND, KVP, LT>(a, lane) : St{0, 0, 0, 0};
  double y = 0.0;
  if constexpr (CACHE_Y) y = LT ? (double)s.tk + 1.0 : (double)s.b + 1.0;
  unsigned long long chosen = 0;
  unsigned rm = 0;             // tie mod (lane + 1)
  long long prev_tie = 0;
  for (int j = 0; j < k; ++j) {
    const long long* arow = A + j * ak;
    Step st{arow[k], 1, 0, false};
    long long h = 0;
    if constexpr (Tr::HITS) {
      long long dc = mine ? D[(long long)j * n + lane] : 0;
      if (!fold) {
        for (unsigned long long m = chosen; m; m &= m - 1) {
          const long long v = arow[__ffsll(static_cast<long long>(m)) - 1];
          dc = v > dc ? v : dc;
        }
        for (int jj = 64; jj < j; ++jj) {
          if (H[jj] == lane) {
            const long long v = arow[jj];
            dc = v > dc ? v : dc;
          }
        }
      }
      h = hits_of(dc, 0, a.block_size, st.plen);
    }
    if constexpr (KIND != PTOKEN) {
      // (tie mod (lane + 1)), stepped on while the counter counts up by one
      const long long tie = arow[k + 1];
      if (j == 0 || tie != prev_tie + 1) {
        rm = static_cast<unsigned>(tie_rank(tie, lane + 1));
      } else {
        rm = rm + 1 == static_cast<unsigned>(lane + 1) ? 0u : rm + 1;
      }
      prev_tie = tie;
    }
    if constexpr (Tr::ROUND1) {
      const unsigned long long mx = warp_max(ikey(mine ? s.b : I64_MIN));
      const unsigned long long mn = warp_min(ikey(mine ? s.b : I64_MAX));
      const unsigned long long mh = warp_max(ikey(mine ? h : I64_MIN));
      st.max_bs = ival(mx) > 1 ? ival(mx) : 1;
      st.imbalanced = (ival(mx) - ival(mn)) > a.bs_range;
      st.max_hits = ival(mh);
    }
    double sc;
    if constexpr (CACHE_Y) {
      double x;
      if constexpr (KVP) {
        x = (double)(s.qp + (st.plen - h)) + 1.0;
      } else {
        const double L = (double)(st.plen > 1 ? st.plen : 1);
        x = 1.0 - (double)h / L + 1e-3;
      }
      sc = mine ? x * y : inf();
    } else {
      sc = mine ? score_of<KIND, KVP, LT>(s, h, st, a.lam) : inf();
    }
    const double thr = dval(warp_min(dkey(sc))) + Tr::EPS;
    const unsigned ties = __ballot_sync(FULL, mine && sc <= thr);
    const unsigned r =
        KIND == PTOKEN ? 0u : __shfl_sync(FULL, rm, __popc(ties) - 1);
    // the tie whose count of lower ties is r
    const bool is_r = ((ties >> lane) & 1u) &&
                      static_cast<unsigned>(__popc(ties & ((1u << lane) - 1u)))
                          == r;
    const int s_lane = __ffs(__ballot_sync(FULL, is_r)) - 1;
    const long long hs = __shfl_sync(FULL, h, s_lane);
    if (lane == s_lane) {
      feedback<KIND, KVP, LT>(s, st.plen, hs);
      if constexpr (CACHE_Y) y = LT ? (double)s.tk + 1.0 : (double)s.b + 1.0;
      if (j < 64) chosen |= 1ull << j;
    }
    if (lane == 0) {
      a.sel[j] = s_lane;
      a.hit[j] = Tr::HITS ? hs : 0;
    }
    if constexpr (Tr::HITS) {
      if (fold) {
        // request j's chain is now at s_lane: later rows credit it
        for (int jr = j + 1 + lane; jr < k; jr += 32) {
          long long* e = s_dep + (long long)jr * n + s_lane;
          const long long v = A[jr * ak + j];
          if (v > *e) *e = v;
        }
        __syncwarp();
      } else if (j >= 64) {
        H[j] = s_lane;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the cluster path: n > 32
// ---------------------------------------------------------------------------
struct R1 {           // round 1: max bs, min bs, max hits (as keys)
  unsigned long long mx, mn, mh;
};

// st.async of 8 bytes into `slot` of CTA `rank` (the same shared-memory
// offset there), completing 8 bytes of transactions on that CTA's `bar`.
__device__ __forceinline__ void send8(const void* slot, const void* bar,
                                      unsigned rank, unsigned long long v) {
  asm volatile(
      "{\n.reg .b32 ra, rb;\n"
      "mapa.shared::cluster.u32 ra, %0, %2;\n"
      "mapa.shared::cluster.u32 rb, %1, %2;\n"
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [ra], %3, "
      "[rb];\n}\n" ::"r"(hopper::smem_u32(slot)),
      "r"(hopper::smem_u32(bar)), "r"(rank), "l"(v)
      : "memory");
}
// Spin until the phase of parity `parity` of the local mbarrier `bar` has
// completed.
__device__ __forceinline__ void wait_cluster(const void* bar,
                                             unsigned parity) {
  const unsigned b = hopper::smem_u32(bar);
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(b), "r"(parity)
        : "memory");
  }
}

// Warp 0 rebuilds the credit row of step j+1 from this CTA's own list
// (step jj, local instance i) as it stands before step j's selection:
// clear the entries (the row held step j-1's credit), then max in
// lcp[j+1, jj].  Instances below rc are on chip (cn), the rest in global
// scratch (gn).
__device__ __forceinline__ void rebuild_credit(const int* own, int n_own,
                                               const long long* next,
                                               long long* cn, long long* gn,
                                               int rc, int lane) {
  for (int e = lane; e < n_own; e += 32) {
    const int i = own[2 * e + 1];
    if (i < rc) cn[i] = 0;
    else gn[i] = 0;
  }
  __syncwarp();
  for (int e = lane; e < n_own; e += 32) {
    const int i = own[2 * e + 1];
    const long long v = next[own[2 * e]];
    if (i < rc) atomicMax(cn + i, v);
    else atomicMax(gn + i, v);
  }
  __syncwarp();
}

// A CTA of up to 512 threads holds up to 4 instances a thread in its 128
// registers a thread; 8 or 16 need the 255 registers of 256 threads.
template <int KIND, bool KVP, bool LT, int IPT>
__global__ void __launch_bounds__((IPT <= 4 ? 512 : 256), 1)
    route_cluster(Args a) {
  using Tr = Traits<KIND, KVP, LT>;
  cg::cluster_group cl = cg::this_cluster();
  const int C = static_cast<int>(cl.num_blocks());
  const int rank = static_cast<int>(cl.block_rank());
  const int t = threadIdx.x, NT = blockDim.x;
  const int lane = t & 31, warp = t >> 5, nw = NT >> 5;
  const int n = a.n, k = a.k, P = a.part, RC = a.reg_cap;
  const long long lo = (long long)rank * P;
  const int cnt = (int)(n - lo < P ? (n - lo > 0 ? n - lo : 0) : P);
  const long long ak = (long long)k + 2;

  // dynamic shared memory: depth ring [2][RC] and credit rows [2][RC],
  // both by step parity; aux; the own-selection list
  extern __shared__ long long smem[];
  long long* ring = smem;
  long long* cred = ring + (Tr::HITS ? 2 * RC : 0);
  long long* s_aux = cred + (Tr::HITS ? 2 * RC : 0);
  int* s_own = reinterpret_cast<int*>(s_aux + (a.aux_smem ? k * ak : 0));
  const long long* A = a.aux_smem ? s_aux : a.aux;
  int* own = a.own_smem ? s_own : a.own + 2LL * rank * k;

  // tie masks, flat: [q * nw + warp] of the register rows, or of a tile
  // of 32 off-chip rows; local index = 32 * (flat index) + lane
  __shared__ unsigned masks[32 * MAX_NW];
  __shared__ unsigned long long part_k[MAX_NW];   // warp min keys
  __shared__ unsigned part_i[MAX_NW];             // ptoken: first index
  __shared__ int part_c[2][MAX_NW][2];            // tie counts, two passes
  __shared__ R1 part_r[MAX_NW];
  // exchange slots [parity][source CTA], filled by st.async, and the
  // mbarriers [parity] that count their bytes
  __shared__ unsigned long long x_key[2][CLUSTER_MAX];   // least score key
  __shared__ long long x_val[2][CLUSTER_MAX];    // tie count / ptoken index
  __shared__ long long x_cnt[2][CLUSTER_MAX];    // recount at the global min
  __shared__ unsigned long long x_r1[2][CLUSTER_MAX][3];
  __shared__ __align__(8) unsigned long long bar_x[2], bar_y[2], bar_r1[2];
  // feedback owed to a register-held instance, applied by its thread at
  // the next step: step, thread, row, plen, hit
  __shared__ long long pend[5];
  __shared__ int s_loc_found;
  __shared__ long long s_tile;

  // ---- stage the wave ---------------------------------------------------
  St st_r[IPT];
  double sc_r[IPT];
#pragma unroll
  for (int q = 0; q < IPT; ++q) {
    const int i = q * NT + t;
    st_r[q] = i < cnt && i < RC ? load_cols<KIND, KVP, LT>(a, lo + i)
                                : St{0, 0, 0, 0};
    sc_r[q] = inf();
  }
  for (int i = RC + t; i < cnt; i += NT) {       // off-chip instances
    const St s = load_cols<KIND, KVP, LT>(a, lo + i);
    a.wb[lo + i] = s.b;
    if constexpr (Tr::QPT) a.wqp[lo + i] = s.qp;
    if constexpr (Tr::TT) a.wtk[lo + i] = s.tk;
    if constexpr (Tr::HITS) a.crow[lo + i] = a.crow[n + lo + i] = 0;
  }
  if constexpr (Tr::HITS) {
    for (int i = t; i < 2 * RC; i += NT) cred[i] = 0;
  }
  if (a.aux_smem)
    for (long long i = t; i < k * ak; i += NT) cp_async8(s_aux + i, a.aux + i);
  if (t == 0) {
    pend[0] = -1;
    for (int p = 0; p < 2; ++p) {
      hopper::mbar_init(hopper::smem_u32(&bar_x[p]), 1);
      hopper::mbar_init(hopper::smem_u32(&bar_y[p]), 1);
      hopper::mbar_init(hopper::smem_u32(&bar_r1[p]), 1);
    }
    hopper::mbar_init_fence();
  }
  cp_commit();
  int n_own = 0;                     // entries of this CTA's own list
  if constexpr (Tr::HITS) {          // depth row 0 into ring[0]
#pragma unroll
    for (int q = 0; q < IPT; ++q) {
      const int i = q * NT + t;
      if (i < cnt && i < RC) cp_async8(ring + i, a.depth + lo + i);
    }
  }
  cp_commit();
  cp_wait_prev();                    // aux
  unsigned y_bits = 0;               // bar_y[p]'s phase parity in bit p
  cl.sync();      // every CTA runs, with its barriers set, before any send

  for (int j = 0; j < k; ++j) {
    const int par = j & 1;
    const unsigned phase = (j >> 1) & 1;  // of bar_x and bar_r1[par]
    if (t == 0) {
      hopper::mbar_expect_tx(hopper::smem_u32(&bar_x[par]), 16u * C);
      if constexpr (Tr::ROUND1)
        hopper::mbar_expect_tx(hopper::smem_u32(&bar_r1[par]), 24u * C);
    }
    const long long* arow = A + j * ak;
    Step st{arow[k], 1, 0, false};
    const long long tie = KIND == PTOKEN ? 0 : arow[k + 1];
    const long long* ring_j = ring + par * RC;
    // credit of row j (read), and of row j+1 (rebuilt by warp 0 while the
    // exchange is in flight, completed by the owner)
    const long long* cred_j = cred + par * RC;
    long long* cred_n = cred + (par ^ 1) * RC;
    const long long* crow_j = a.crow + (long long)par * n + lo;
    long long* crow_n = a.crow + (long long)(par ^ 1) * n + lo;
    if constexpr (Tr::HITS) {
      // stream row j+1 into the other stage while this step runs
      if (j + 1 < k) {
        long long* dst = ring + (par ^ 1) * RC;
        const long long* src = a.depth + (long long)(j + 1) * n + lo;
#pragma unroll
        for (int q = 0; q < IPT; ++q) {
          const int i = q * NT + t;
          if (i < cnt && i < RC) cp_async8(dst + i, src + i);
        }
      }
      cp_commit();
      cp_wait_prev();               // row j has landed (own copies)
    }
    // feedback of the previous step to an instance this thread holds
    if (j > 0 && pend[0] == j - 1 && pend[1] == t) {
      const int pq = (int)pend[2];
#pragma unroll
      for (int q = 0; q < IPT; ++q)
        if (q == pq) feedback<KIND, KVP, LT>(st_r[q], pend[3], pend[4]);
    }

    // ---- hits, round 1 and scores --------------------------------------
    long long h_r[IPT];
#pragma unroll
    for (int q = 0; q < IPT; ++q) {
      const int i = q * NT + t;
      h_r[q] = 0;
      if constexpr (Tr::HITS)
        if (i < cnt && i < RC)
          h_r[q] = hits_of(ring_j[i], cred_j[i], a.block_size, st.plen);
    }
    if constexpr (Tr::ROUND1) {
      R1 v{0, ~0ull, 0};
#pragma unroll
      for (int q = 0; q < IPT; ++q) {
        const int i = q * NT + t;
        if (i < cnt && i < RC) {
          v.mx = umax(v.mx, ikey(st_r[q].b));
          v.mn = umin(v.mn, ikey(st_r[q].b));
          v.mh = umax(v.mh, ikey(h_r[q]));
        }
      }
      for (int i = RC + t; i < cnt; i += NT) {
        const long long b = a.wb[lo + i];
        const long long h = hits_of(a.depth[(long long)j * n + lo + i],
                                    crow_j[i], a.block_size, st.plen);
        v.mx = umax(v.mx, ikey(b));
        v.mn = umin(v.mn, ikey(b));
        v.mh = umax(v.mh, ikey(h));
      }
      v = R1{warp_max(v.mx), warp_min(v.mn), warp_max(v.mh)};
      if (lane == 0) part_r[warp] = v;
      __syncthreads();
      if (warp == 0) {
        R1 w = lane < nw ? part_r[lane] : R1{0, ~0ull, 0};
        w = R1{warp_max(w.mx), warp_min(w.mn), warp_max(w.mh)};
        if (lane < C) {
          send8(&x_r1[par][rank][0], &bar_r1[par], lane, w.mx);
          send8(&x_r1[par][rank][1], &bar_r1[par], lane, w.mn);
          send8(&x_r1[par][rank][2], &bar_r1[par], lane, w.mh);
        }
      }
      wait_cluster(&bar_r1[par], phase);
      // lane c reads CTA c's values; every warp alike
      R1 g = lane < C ? R1{x_r1[par][lane][0], x_r1[par][lane][1],
                           x_r1[par][lane][2]}
                      : R1{0, ~0ull, 0};
      g = R1{warp_max(g.mx), warp_min(g.mn), warp_max(g.mh)};
      st.max_bs = ival(g.mx) > 1 ? ival(g.mx) : 1;
      st.imbalanced = (ival(g.mx) - ival(g.mn)) > a.bs_range;
      st.max_hits = ival(g.mh);
    }
    unsigned long long kloc = ~0ull;   // least score key of this thread
    int iloc = 0x7fffffff;             // ptoken: its first local index
#pragma unroll
    for (int q = 0; q < IPT; ++q) {
      const int i = q * NT + t;
      if (i < cnt && i < RC) {
        const double s = score_of<KIND, KVP, LT>(st_r[q], h_r[q], st, a.lam);
        sc_r[q] = s;
        const unsigned long long key = dkey(s);
        if (key < kloc) {            // ascending i: the first least score
          kloc = key;
          iloc = i;
        }
      }
    }
    for (int i = RC + t; i < cnt; i += NT) {
      St s{a.wb[lo + i], 0, 0, 0};
      if constexpr (KIND == JSQ) s.r = a.rbs[lo + i];
      if constexpr (Tr::QPT) s.qp = a.wqp[lo + i];
      if constexpr (Tr::TT) s.tk = a.wtk[lo + i];
      long long h = 0;
      if constexpr (Tr::HITS)
        h = hits_of(a.depth[(long long)j * n + lo + i], crow_j[i],
                    a.block_size, st.plen);
      const double sc = score_of<KIND, KVP, LT>(s, h, st, a.lam);
      a.sc[lo + i] = sc;
      const unsigned long long key = dkey(sc);
      if (key < kloc) {
        kloc = key;
        iloc = i;
      }
    }

    // ---- this CTA's least score (ptoken: and its first index) -----------
    {
      const unsigned long long wk = warp_min(kloc);
      if (lane == 0) part_k[warp] = wk;
      if constexpr (KIND == PTOKEN) {
        const unsigned wi = __reduce_min_sync(
            FULL, kloc == wk ? static_cast<unsigned>(iloc) : 0xffffffffu);
        if (lane == 0) part_i[warp] = wi;
      }
    }
    __syncthreads();
    const unsigned long long pk = lane < nw ? part_k[lane] : ~0ull;
    const unsigned long long ck = warp_min(pk);     // every warp alike

    long long r_loc = -1;   // rank of the chosen tie in this CTA, or -1
    int sl = -1;            // warp 0 of the owner: the chosen local index
    if constexpr (KIND == PTOKEN) {
      // one round: the least (score, index) pair
      const unsigned ci = __reduce_min_sync(
          FULL, lane < nw && pk == ck ? part_i[lane] : 0xffffffffu);
      if (warp == 0) {
        if (lane < C) {
          send8(&x_key[par][rank], &bar_x[par], lane, ck);
          send8(&x_val[par][rank], &bar_x[par], lane,
                static_cast<unsigned long long>(lo + ci));
        }
        if (Tr::HITS && j + 1 < k)
          rebuild_credit(own, n_own, A + (j + 1) * ak, cred_n, crow_n, RC,
                         lane);
      }
      wait_cluster(&bar_x[par], phase);
      const unsigned long long xk = lane < C ? x_key[par][lane] : ~0ull;
      const unsigned long long gk = warp_min(xk);
      // the first CTA holding it
      const int gc = __ffs(__ballot_sync(FULL, lane < C && xk == gk)) - 1;
      if (gc == rank) {
        r_loc = 0;
        sl = (int)(x_val[par][gc] - lo);
      }
    } else {
      // ---- ties at this CTA's own least score + eps ------------------------
      // Each CTA sends (least key, tie count at its least + eps) in one
      // round.  That count is the count at the global least + eps for the
      // CTAs whose least equals the global one, and 0 for those whose
      // least is above it by more than eps; a CTA in between (a near-tie
      // across CTAs) makes every CTA recount at the global threshold in a
      // second round.
      double thr = dval(ck) + Tr::EPS;
      bool slow = false;
      int treg = 0;
      long long cnt_c = 0;             // lane c: CTA c's count at the global
                                       // least + eps
      for (int pass = 0; pass < 2; ++pass) {
        int creg = 0;                    // this warp's register-row ties
#pragma unroll
        for (int q = 0; q < IPT; ++q) {
          const int i = q * NT + t;
          const unsigned m =
              __ballot_sync(FULL, i < cnt && i < RC && sc_r[q] <= thr);
          if (lane == 0) masks[q * nw + warp] = m;
          creg += __popc(m);
        }
        int coff = 0;
        for (int i = RC + t; i < cnt; i += NT) coff += a.sc[lo + i] <= thr;
        coff = __reduce_add_sync(FULL, coff);
        if (lane == 0) {
          part_c[pass][warp][0] = creg;
          part_c[pass][warp][1] = coff;
        }
        __syncthreads();
        treg = __reduce_add_sync(FULL, lane < nw ? part_c[pass][lane][0] : 0);
        const int toff =
            __reduce_add_sync(FULL, lane < nw ? part_c[pass][lane][1] : 0);
        const unsigned long long tc =
            static_cast<unsigned long long>(treg + toff);
        if (pass == 1) {
          if (warp == 0 && lane < C)
            send8(&x_cnt[par][rank], &bar_y[par], lane, tc);
          wait_cluster(&bar_y[par], (y_bits >> par) & 1u);
          y_bits ^= 1u << par;
          cnt_c = lane < C ? x_cnt[par][lane] : 0;
          break;
        }
        if (warp == 0) {
          if (lane < C) {
            send8(&x_key[par][rank], &bar_x[par], lane, ck);
            send8(&x_val[par][rank], &bar_x[par], lane, tc);
          }
          if (Tr::HITS && j + 1 < k)
            rebuild_credit(own, n_own, A + (j + 1) * ak, cred_n, crow_n, RC,
                           lane);
        }
        wait_cluster(&bar_x[par], phase);
        // lane c reads CTA c's (key, count); every warp alike
        const unsigned long long xk = lane < C ? x_key[par][lane] : ~0ull;
        const long long xv = lane < C ? x_val[par][lane] : 0;
        const unsigned long long gk = warp_min(xk);
        const double thr_g = dval(gk) + Tr::EPS;
        slow = __any_sync(FULL, lane < C && xk != gk && dval(xk) <= thr_g);
        cnt_c = xk == gk ? xv : 0;
        if (!slow) break;                 // uniform across the cluster
        thr = thr_g;
        if (t == 0)
          hopper::mbar_expect_tx(hopper::smem_u32(&bar_y[par]), 8u * C);
      }
      // the owner: the CTA whose running count passes r (counts < 2^31)
      int inc = static_cast<int>(cnt_c);
      for (int o = 1; o < CLUSTER_MAX; o <<= 1) {
        const int y = __shfl_up_sync(FULL, inc, o);
        if (lane >= o) inc += y;
      }
      const long long total = __shfl_sync(FULL, inc, C - 1);
      const long long r = tie_rank(tie, total);
      const int below = inc - static_cast<int>(cnt_c);
      const int owner = __ffs(__ballot_sync(
          FULL, lane < C && r >= below && r < inc)) - 1;
      const int base = __shfl_sync(FULL, below, owner);
      if (owner == rank) r_loc = r - base;
      if (r_loc >= 0 && r_loc < treg) {
        // among the register rows: warp 0 scans the masks in ascending
        // local order, (row, warp, lane); lane l takes a run of `per`
        if (warp == 0) {
          const int F = IPT * nw, per = (F + 31) / 32, f0 = lane * per;
          int c = 0;
          for (int u = 0; u < per; ++u)
            if (f0 + u < F) c += __popc(masks[f0 + u]);
          int inc = c;
          for (int o = 1; o < 32; o <<= 1) {
            const int y = __shfl_up_sync(FULL, inc, o);
            if (lane >= o) inc += y;
          }
          int found = -1;
          if (r_loc >= inc - c && r_loc < inc) {
            long long left = r_loc - (inc - c);
            for (int u = 0; u < per; ++u) {
              unsigned m = masks[f0 + u];
              const int pc = __popc(m);
              if (left < pc) {
                for (; left > 0; --left) m &= m - 1;   // drop lower ties
                found = 32 * (f0 + u) + __ffs(m) - 1;
                break;
              }
              left -= pc;
            }
          }
          const unsigned who = __ballot_sync(FULL, found >= 0);
          sl = __shfl_sync(FULL, found, __ffs(who) - 1);
        }
      } else if (r_loc >= 0) {
        // among the off-chip rows: tiles of 32 rows, ballots into masks
        long long want = r_loc - treg;
        const int rows = (cnt + NT - 1) / NT;
        for (int row0 = IPT; row0 < rows; row0 += 32) {
          for (int q = row0; q < row0 + 32 && q < rows; ++q) {
            const int i = q * NT + t;
            const unsigned m =
                __ballot_sync(FULL, i < cnt && a.sc[lo + i] <= thr);
            if (lane == 0) masks[(q - row0) * nw + warp] = m;
          }
          __syncthreads();
          if (warp == 0) {
            // lane l scans row row0 + l
            const bool live = row0 + lane < rows;
            int rc = 0;
            if (live)
              for (int w = 0; w < nw; ++w) rc += __popc(masks[lane * nw + w]);
            int inc = rc;
            for (int o = 1; o < 32; o <<= 1) {
              const int y = __shfl_up_sync(FULL, inc, o);
              if (lane >= o) inc += y;
            }
            if (live && want >= inc - rc && want < inc) {
              long long left = want - (inc - rc);
              for (int w = 0; w < nw; ++w) {
                unsigned m = masks[lane * nw + w];
                const int pc = __popc(m);
                if (left < pc) {
                  for (; left > 0; --left) m &= m - 1;
                  s_loc_found = (row0 + lane) * NT + w * 32 + __ffs(m) - 1;
                  break;
                }
                left -= pc;
              }
            }
            const int tile_total = __shfl_sync(FULL, inc, 31);
            if (lane == 0) s_tile = tile_total;
          }
          __syncthreads();
          const long long tile_total = s_tile;
          if (want < tile_total) break;
          want -= tile_total;
        }
        sl = s_loc_found;
      }
    }

    // ---- the owner: outputs and feedback ---------------------------------
    if (r_loc >= 0) {
      ++n_own;
      if (t == 0) {
        long long h = 0;
        if constexpr (Tr::HITS) {
          const bool on = sl < RC;
          const long long d =
              on ? ring_j[sl] : a.depth[(long long)j * n + lo + sl];
          h = hits_of(d, on ? cred_j[sl] : crow_j[sl], a.block_size,
                      st.plen);
        }
        a.sel[j] = lo + sl;
        a.hit[j] = h;
        if (sl < RC) {
          pend[1] = sl % NT;
          pend[2] = sl / NT;
          pend[3] = st.plen;
          pend[4] = h;
          pend[0] = j;
        } else {
          if constexpr (Tr::B) a.wb[lo + sl] += 1;
          if constexpr (Tr::QPT) a.wqp[lo + sl] += st.plen - h;
          if constexpr (Tr::TT) a.wtk[lo + sl] += st.plen;
        }
        if constexpr (Tr::HITS) {
          own[2 * (n_own - 1)] = j;
          own[2 * (n_own - 1) + 1] = sl;
          // request j's chain is now at sl: row j+1's credit there
          if (j + 1 < k) {
            const long long v = A[(j + 1) * ak + j];
            if (sl < RC) atomicMax(cred_n + sl, v);
            else atomicMax(crow_n + sl, v);
          }
        }
      }
    }
    __syncthreads();
  }
  cl.sync();      // no CTA leaves while another may still store into it
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
struct Plan {
  const void* fn;
  int cluster, threads;
  size_t smem;
  int ok;         // 1: schedulable, 0: not
};

// cudaOccupancyMaxActiveClusters per (kernel, cluster, threads, smem),
// asked once
cudaError_t schedulable(const void* fn, const cudaLaunchConfig_t& cfg,
                        int cluster, int* ok) {
  static std::mutex mu;
  static Plan seen[256];
  static int n_seen = 0;
  std::lock_guard<std::mutex> g(mu);
  for (int i = 0; i < n_seen; ++i) {
    const Plan& p = seen[i];
    if (p.fn == fn && p.cluster == cluster && p.threads == (int)cfg.blockDim.x
        && p.smem == cfg.dynamicSmemBytes) {
      *ok = p.ok;
      return cudaSuccess;
    }
  }
  int count = 0;
  const cudaError_t e = cudaOccupancyMaxActiveClusters(&count, fn, &cfg);
  if (e != cudaSuccess) return e;
  *ok = count > 0;
  if (n_seen < 256)
    seen[n_seen++] = Plan{fn, cluster, (int)cfg.blockDim.x,
                          cfg.dynamicSmemBytes, *ok};
  return cudaSuccess;
}

template <int KIND, bool KVP, bool LT>
cudaError_t launch_warp(Args a, cudaStream_t stream) {
  using Tr = Traits<KIND, KVP, LT>;
  const long long k = a.k, n = a.n;
  const long long own_b = 4 * k;
  const long long aux_b = 8 * k * (k + 2);
  const long long dep_b = Tr::HITS ? 8 * k * n : 0;
  long long room = WARP_SMEM;
  a.own_smem = own_b <= OWN_SMEM;
  if (a.own_smem) room -= (own_b + 7) / 8 * 8;
  a.aux_smem = aux_b <= room;
  if (a.aux_smem) room -= aux_b;
  a.depth_smem = Tr::HITS && dep_b <= room;
  const size_t smem = (a.aux_smem ? aux_b : 0) + (a.depth_smem ? dep_b : 0)
                      + (a.own_smem ? own_b : 0);
  route_warp<KIND, KVP, LT><<<1, 32, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int KIND, bool KVP, bool LT, int IPT>
cudaError_t launch_cluster(Args a, int cluster, int threads,
                           cudaStream_t stream) {
  using Tr = Traits<KIND, KVP, LT>;
  const long long k = a.k;
  a.reg_cap = a.part < IPT * threads ? a.part : IPT * threads;
  const long long fixed = Tr::HITS ? 4LL * 8 * a.reg_cap : 0;
  const long long aux_b = 8 * k * (k + 2);
  const long long own_b = 8 * k;
  long long room = SMEM_MAX - 8 * 1024 - fixed;   // static smem and slack
  a.aux_smem = aux_b <= AUX_SMEM && aux_b <= room;
  if (a.aux_smem) room -= aux_b;
  a.own_smem = own_b <= OWN_SMEM && own_b <= room;
  a.depth_smem = 0;
  const size_t smem = fixed + (a.aux_smem ? aux_b : 0)
                      + (a.own_smem ? own_b : 0);
  auto kernel = route_cluster<KIND, KVP, LT, IPT>;
  static size_t allowed = 48 * 1024;     // this instantiation's limit
  cudaError_t e = cudaSuccess;
  if (smem > allowed) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    allowed = smem;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int ok = 0;
  e = schedulable(reinterpret_cast<const void*>(kernel), cfg, cluster, &ok);
  if (e != cudaSuccess) return e;
  if (!ok) return cudaErrorLaunchOutOfResources;
  e = cudaLaunchKernelEx(&cfg, kernel, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int KIND, bool KVP, bool LT>
cudaError_t launch(const Args& a, int cluster, int threads,
                   cudaStream_t stream) {
  if (a.n <= 32) return launch_warp<KIND, KVP, LT>(a, stream);
  const int per = (a.part + threads - 1) / threads;   // instances a thread
  if (per <= 1) return launch_cluster<KIND, KVP, LT, 1>(a, cluster, threads,
                                                        stream);
  if (per <= 2) return launch_cluster<KIND, KVP, LT, 2>(a, cluster, threads,
                                                        stream);
  if (per <= 4) return launch_cluster<KIND, KVP, LT, 4>(a, cluster, threads,
                                                        stream);
  if (per <= 8) return launch_cluster<KIND, KVP, LT, 8>(a, cluster, threads,
                                                        stream);
  return launch_cluster<KIND, KVP, LT, 16>(a, cluster, threads, stream);
}

}  // namespace

// kind: 0 jsq, 1 linear, 2 filter, 3 lmetric, 4 ptoken.  kv_ptoken and
// load_tokens select lmetric's ablations.  work points at 6*n + cluster*k
// int64 of scratch.  cluster and threads are the launch plan
// (kernels/route_score.py::launch_plan): n <= 32 runs the warp kernel
// (cluster 1, threads 32); else a cluster of `cluster` CTAs of `threads`
// threads.  Returns the cudaError_t of the launch (0 on success; a plan
// outside those bounds is cudaErrorInvalidValue, a cluster that cannot be
// scheduled cudaErrorLaunchOutOfResources); the kernel itself runs
// asynchronously on stream.
extern "C" int route_score_launch(
    int kind, int kv_ptoken, int load_tokens,
    const long long* rbs, const long long* qbs_in, const long long* qpt_in,
    const long long* tt_in, const long long* depth, const long long* aux,
    long long* work, long long* sel, long long* hit, int k, int n,
    long long block_size, double lam, long long bs_range, int cluster,
    int threads, void* stream) {
  if (n <= 32 ? (cluster != 1 || threads != 32)
              : (cluster < 1 || cluster > CLUSTER_MAX || threads < 32 ||
                 threads > MAX_NT || threads % 32 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const int part = (int)(((long long)n + cluster - 1) / cluster);
  if (n > 32 && (part + threads - 1) / threads > 4 && threads > 256)
    return static_cast<int>(cudaErrorInvalidValue);   // registers
  Args a{rbs, qbs_in, qpt_in, tt_in, depth, aux,
         work, work + n, work + 2LL * n, work + 3LL * n,
         reinterpret_cast<double*>(work + 5LL * n),
         reinterpret_cast<int*>(work + 6LL * n),
         sel, hit, k, n, part, 0, block_size, lam, bs_range, 0, 0, 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (kind) {
    case JSQ: e = launch<JSQ, false, false>(a, cluster, threads, s); break;
    case LINEAR:
      e = launch<LINEAR, false, false>(a, cluster, threads, s);
      break;
    case FILTER:
      e = launch<FILTER, false, false>(a, cluster, threads, s);
      break;
    case PTOKEN:
      e = launch<PTOKEN, false, false>(a, cluster, threads, s);
      break;
    case LMETRIC:
      if (kv_ptoken) {
        e = load_tokens ? launch<LMETRIC, true, true>(a, cluster, threads, s)
                        : launch<LMETRIC, true, false>(a, cluster, threads,
                                                       s);
      } else {
        e = load_tokens ? launch<LMETRIC, false, true>(a, cluster, threads,
                                                       s)
                        : launch<LMETRIC, false, false>(a, cluster, threads,
                                                        s);
      }
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(e);
}
