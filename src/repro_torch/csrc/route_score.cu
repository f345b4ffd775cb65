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
// Design.  One CTA of 1024 threads; thread t owns instances t, t+1024, ...
// so every pass over the instances reads neighbouring addresses across a
// warp.  Block reductions give min(score) and, for filter/linear,
// max/min(bs) and max(hits).  Each step's scores go to an n-long scratch
// row (+inf where filter disallows an instance), which the tie passes
// read back.  The rank-r tie in ascending index order is found from warp
// ballots: instance i = row*1024 + warp*32 + lane, so ascending order is
// (row, warp, lane) order; per tile of 32 rows the warps publish their
// ballot masks, and one warp scans the tile's popcounts.  (Atomics or a
// plain min-reduction would pick another instance among exact ties.)
// The fed-back columns (qbs, qpt, tt) are working copies in global
// scratch; the device mirror they start from is never written.
// The credit matrix is not stored: row j's credit depends only on the
// earlier (sel[j'], lcp[j, j']) pairs, so each step scatters those j pairs
// into one n-long scratch row with atomicMax, reads it, and zeroes the
// same j entries again -- the value cred[j, :] would hold, at O(j) work
// per step instead of an O(k*n) matrix in device memory.
//
// Bound on this card.  The function must read, once, the columns its kind
// scores with (lmetric ptoken x bs: rbs, qbs, qpt; 3*n int64), depth (k*n
// int64, not for jsq), the strict lower triangle of lcp (k*(k-1)/2), plen
// (k) and the tie counter, and write sel/hit (2*k int64): for lmetric at
// k=64, n=16384 that is 8,799,496 B, 2.63 us at 3.35 TB/s (chip_smoke.py's
// wave_bound gives it for every kind); its float64 work (a few operations
// per instance and step) is far smaller, so it is bound by bytes.  This
// first kernel does not reach
// that bound: the loop over j is sequential inside one SM, every step
// re-reads three or four n-long columns, one depth row and the score row
// (from L1/L2 after the first step), and each step pays about ten
// block-wide barriers.  A cluster/DSMEM design spread across SMs is later
// work.
#include <cuda_runtime.h>

namespace {

constexpr int NT = 1024;            // threads of the one CTA
constexpr int NW = NT / 32;         // warps
constexpr unsigned FULL = 0xffffffffu;
constexpr long long I64_MAX = 0x7fffffffffffffffLL;
constexpr long long I64_MIN = -I64_MAX - 1;

enum Kind { JSQ = 0, LINEAR = 1, FILTER = 2, LMETRIC = 3, PTOKEN = 4 };

struct Args {
  const long long* rbs;      // (n,) device mirror, read only
  const long long* qbs_in;   // (n,)
  const long long* qpt_in;   // (n,)
  const long long* tt_in;    // (n,)
  const long long* depth;    // (k, n) pre-wave index depths; null for jsq
  const long long* aux;      // (k, k+2): lcp | plen | tie
  long long* qbs;            // (n,) working copies of the fed-back columns
  long long* qpt;
  long long* tt;
  long long* crow;           // (n,) credit row of the current step
  double* sc;                // (n,) scores of the current step
  long long* sel;            // (k,) out: chosen instance
  long long* hit;            // (k,) out: hit tokens at the chosen instance
  int k;
  int n;
  long long block_size;
  double lam;                // linear
  long long bs_range;        // filter
};

struct MaxI {
  __device__ long long operator()(long long a, long long b) const {
    return a > b ? a : b;
  }
};
struct MinI {
  __device__ long long operator()(long long a, long long b) const {
    return a < b ? a : b;
  }
};
struct SumI {
  __device__ long long operator()(long long a, long long b) const {
    return a + b;
  }
};
struct MinD {
  __device__ double operator()(double a, double b) const {
    return b < a ? b : a;
  }
};

// Reduction over all NT threads; every thread gets the result.  The
// operations are exact integer sums or min/max, so the tree order does
// not change the result.
template <typename T, typename Op>
__device__ T block_reduce(T v, T* sh, Op op) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(FULL, v, o));
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  v = sh[lane];
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(FULL, v, o));
  __syncthreads();                  // sh may be reused right away
  return v;
}

template <int KIND, bool KV_PTOKEN, bool LOAD_TOKENS>
__global__ void __launch_bounds__(NT) route_wave(Args a) {
  constexpr bool HITS = KIND != JSQ;
  constexpr bool QPT = KIND == PTOKEN || (KIND == LMETRIC && KV_PTOKEN);
  constexpr bool TT = KIND == LMETRIC && LOAD_TOKENS;
  constexpr double EPS = KIND == PTOKEN ? 0.0 : 1e-9;
  const double INF = __longlong_as_double(0x7ff0000000000000LL);
  __shared__ long long sh_i[NW];
  __shared__ double sh_d[NW];
  __shared__ unsigned sh_mask[32][NW + 1];   // +1: conflict-free columns
  __shared__ long long s_sel, s_hit, s_tile;

  const int n = a.n, k = a.k, t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;

  for (int i = t; i < n; i += NT) {
    a.qbs[i] = a.qbs_in[i];
    if constexpr (QPT) a.qpt[i] = a.qpt_in[i];
    if constexpr (TT) a.tt[i] = a.tt_in[i];
    if constexpr (HITS) a.crow[i] = 0;
  }
  __syncthreads();

  const long long ak = (long long)k + 2;
  for (int j = 0; j < k; ++j) {
    const long long* arow = a.aux + j * ak;
    const long long plen = arow[k];
    const long long tie = KIND == PTOKEN ? 0 : arow[k + 1];
    const long long* drow = HITS ? a.depth + (long long)j * n : nullptr;

    if constexpr (HITS) {
      // every earlier request jj of the wave inserts its chain at sel[jj],
      // so that instance holds lcp[j, jj] blocks of this prompt
      for (int jj = t; jj < j; jj += NT)
        atomicMax(reinterpret_cast<unsigned long long*>(a.crow + a.sel[jj]),
                  static_cast<unsigned long long>(arow[jj]));
      __syncthreads();
    }

    auto hits_at = [&](long long i) -> long long {
      const long long d = drow[i], c = a.crow[i];
      const long long h = (d > c ? d : c) * a.block_size;
      return h < plen ? h : plen;
    };

    long long max_bs = 1, max_hits = 0;
    bool imbalanced = false;
    if constexpr (KIND == LINEAR || KIND == FILTER) {
      long long mx = I64_MIN, mn = I64_MAX, mh = I64_MIN;
      for (int i = t; i < n; i += NT) {
        const long long bs = a.rbs[i] + a.qbs[i];
        mx = bs > mx ? bs : mx;
        mn = bs < mn ? bs : mn;
        if constexpr (KIND == FILTER) {
          const long long h = hits_at(i);
          mh = h > mh ? h : mh;
        }
      }
      mx = block_reduce(mx, sh_i, MaxI());
      max_bs = mx > 1 ? mx : 1;
      if constexpr (KIND == FILTER) {
        mn = block_reduce(mn, sh_i, MinI());
        max_hits = block_reduce(mh, sh_i, MaxI());
        imbalanced = (mx - mn) > a.bs_range;
      }
    }

    // scores of this step; +inf marks an instance filter does not allow
    double local = INF;
    for (int i = t; i < n; i += NT) {
      const long long bs = a.rbs[i] + a.qbs[i];
      const long long h = HITS ? hits_at(i) : 0;
      double s;
      if constexpr (KIND == JSQ) {
        s = 4.0 * (double)a.qbs[i] + (double)a.rbs[i];
      } else if constexpr (KIND == LINEAR) {
        const double L = (double)(plen > 1 ? plen : 1);
        s = a.lam * (1.0 - (double)h / L)
          + (1.0 - a.lam) * ((double)bs / (double)max_bs);
      } else if constexpr (KIND == FILTER) {
        s = (imbalanced || h >= max_hits) ? (double)bs : INF;
      } else if constexpr (KIND == LMETRIC) {
        double x;
        if constexpr (KV_PTOKEN) {
          x = (double)(a.qpt[i] + (plen - h)) + 1.0;
        } else {
          const double L = (double)(plen > 1 ? plen : 1);
          x = 1.0 - (double)h / L + 1e-3;
        }
        const double y = LOAD_TOKENS ? (double)a.tt[i] + 1.0
                                     : (double)bs + 1.0;
        s = x * y;
      } else {
        s = (double)(a.qpt[i] + (plen - h));
      }
      a.sc[i] = s;
      local = s < local ? s : local;
    }
    const double thr = block_reduce(local, sh_d, MinD()) + EPS;

    long long cnt = 0;
    for (int i = t; i < n; i += NT) cnt += a.sc[i] <= thr ? 1 : 0;
    const long long total = block_reduce(cnt, sh_i, SumI());
    long long r = tie % total;
    if (r < 0) r += total;

    // find the r-th tie (0-based) in ascending index order, 32 rows of
    // 1024 instances at a time
    for (long long row0 = 0; row0 * NT < n; row0 += 32) {
      for (int q = 0; q < 32; ++q) {
        const long long i = (row0 + q) * NT + t;
        const bool tie_i = i < n && a.sc[i] <= thr;
        const unsigned m = __ballot_sync(FULL, tie_i);
        if (lane == 0) sh_mask[q][warp] = m;
      }
      __syncthreads();
      if (warp == 0) {
        // lane l scans row row0 + l
        int rc = 0;
        for (int w = 0; w < NW; ++w) rc += __popc(sh_mask[lane][w]);
        int inc = rc;
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(FULL, inc, o);
          if (lane >= o) inc += y;
        }
        const int tile_total = __shfl_sync(FULL, inc, 31);
        if (r >= inc - rc && r < inc) {      // the winner lies in my row
          long long want = r - (inc - rc);
          for (int w = 0; w < NW; ++w) {
            unsigned m = sh_mask[lane][w];
            const int pc = __popc(m);
            if (want < pc) {
              for (; want > 0; --want) m &= m - 1;   // drop lower ties
              const long long i = (row0 + lane) * NT + w * 32 + __ffs(m) - 1;
              s_sel = i;
              s_hit = HITS ? hits_at(i) : 0;
              break;
            }
            want -= pc;
          }
        }
        if (lane == 0) s_tile = tile_total;
      }
      __syncthreads();
      const long long tile_total = s_tile;
      if (r < tile_total) break;            // uniform across the block
      r -= tile_total;
    }

    const long long s = s_sel;
    if (t == 0) {
      a.qbs[s] += 1;
      if constexpr (QPT) a.qpt[s] += plen - s_hit;
      if constexpr (TT) a.tt[s] += plen;
      a.sel[j] = s;
      a.hit[j] = HITS ? s_hit : 0;
    }
    if constexpr (HITS) {
      for (int jj = t; jj < j; jj += NT) a.crow[a.sel[jj]] = 0;
    }
    __syncthreads();
  }
}

template <int KIND, bool KV_PTOKEN, bool LOAD_TOKENS>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  route_wave<KIND, KV_PTOKEN, LOAD_TOKENS><<<1, NT, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// kind: 0 jsq, 1 linear, 2 filter, 3 lmetric, 4 ptoken.  kv_ptoken and
// load_tokens select lmetric's ablations.  work points at 5*n int64 of
// scratch.  Returns the cudaError_t of the launch (0 on success); the
// kernel itself runs asynchronously on stream.
extern "C" int route_score_launch(
    int kind, int kv_ptoken, int load_tokens,
    const long long* rbs, const long long* qbs_in, const long long* qpt_in,
    const long long* tt_in, const long long* depth, const long long* aux,
    long long* work, long long* sel, long long* hit, int k, int n,
    long long block_size, double lam, long long bs_range, void* stream) {
  const Args a{rbs, qbs_in, qpt_in, tt_in, depth, aux,
               work, work + n, work + 2LL * n, work + 3LL * n,
               reinterpret_cast<double*>(work + 4LL * n),
               sel, hit, k, n, block_size, lam, bs_range};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (kind) {
    case JSQ: e = launch<JSQ, false, false>(a, s); break;
    case LINEAR: e = launch<LINEAR, false, false>(a, s); break;
    case FILTER: e = launch<FILTER, false, false>(a, s); break;
    case PTOKEN: e = launch<PTOKEN, false, false>(a, s); break;
    case LMETRIC:
      if (kv_ptoken) {
        e = load_tokens ? launch<LMETRIC, true, true>(a, s)
                        : launch<LMETRIC, true, false>(a, s);
      } else {
        e = load_tokens ? launch<LMETRIC, false, true>(a, s)
                        : launch<LMETRIC, false, false>(a, s);
      }
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(e);
}
