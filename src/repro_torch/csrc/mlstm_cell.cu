// One stabilised chunkwise-parallel mLSTM step for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/mlstm_cell.py::_kernel
// (wrapper mlstm_chunk).  Per (batch, head), over a chunk of L positions
// with head dim hd, from the carried state (C0 (hd, hd), n0 (hd), m0):
//
//   b_t      = cumsum(flog)_t
//   D[t, s]  = b_t - b_s + i_s  (s <= t), -1e30 above the diagonal
//   m_t      = max(b_t + m0, max_s D[t, s])
//   S[t, s]  = (q_t . k_s) * exp(D[t, s] - m_t)
//   h_t      = (S v + (q_t C0) exp(b_t + m0 - m_t))_t / max(|den_t|, exp(-m_t)),
//   den_t    = sum_s S[t, s] + (q_t . n0) exp(b_t + m0 - m_t)
//   m_new    = max(b_L + m0, max_s (b_L - b_s + i_s)),  w_src_s = exp(b_L - b_s + i_s - m_new)
//   C        = C0 exp(b_L + m0 - m_new) + sum_s w_src_s k_s^T v_s,  n likewise
//
// The TPU kernel keeps one (b, h) cell in VMEM, the (hd, hd) f32 memory
// included: 1 MiB at xLSTM-350M's hd = 512, which one SM's 227 KB of
// shared memory cannot hold.  So the cell runs as four launches on one
// stream, each split so that many blocks run at once:
//   1. gates: one block per (b, h) computes b, m_t, exp(b_t + m0 - m_t),
//      w_src, exp(b_L + m0 - m_new) and m_new (O(L^2) scalar work);
//   2. scores: S in 64 x 64 tiles, written once to an f32 scratch
//      (L x L per (b, h), 256 KB at L = 256), so that the value-dim tiles
//      of step 3 do not each recompute it;
//   3. out: h in (64 rows x 64 value columns) tiles: S v and q C0 over
//      the tile's columns of v and C0, and den_t from S's row and q . n0;
//   4. state: C in 64 x 64 tiles of (k w_src)^T v, n by the first column
//      of tiles.
// Products run as f32 FMA on the CUDA cores (bf16 q/k/v are widened on
// load), so the kernel holds the f32 plain version to rounding.  The
// -1e30 mask and the max(|den|, exp(-m_t)) clamp are the TPU kernel's;
// every row, padded ones (ilog = -1e30) included, computes the same
// function as the plain version.
//
// Bound: at the engine's shapes (B = 1, H = 4, L = 256, hd = 512) the four
// products are 1.61 GFLOP (q k^T and S v 0.27 G each, q C0 and (k w)^T v
// 0.54 G each) against ~12.6 MB of C in and out and q/k/v/h, so the f32
// CUDA-core rate (67 TFLOP/s) bounds it at 24 us.  This first version
// uses 64 x 64 shared-memory tiles with 4 x 4 outputs per thread, no
// tensor cores; wgmma on a bf16 hi/lo split is the next step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float NEG = -1e30f;
constexpr int NT = 256;            // threads per block
constexpr int TM = 64, TN = 64;    // output tile
constexpr int TK = 16;             // depth per shared-memory step
constexpr int LDS = TM + 4;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const bf16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(bf16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// acc[i][j] += sum_k A(ty + 16 i, k) * B(k, tx + 16 j) over k < K, for the
// thread (ty, tx) = (tid / 16, tid % 16) of a 64 x 64 tile.  la(r, k) and
// lb(k, c) return the operands (0 outside the matrix); *_KFAST says that
// consecutive k are consecutive in memory, which picks the load order
// that keeps a warp's loads coalesced.
template <bool A_KFAST, bool B_KFAST, class LA, class LB>
__device__ __forceinline__ void gemm_tile(float (&acc)[4][4], int K, LA la,
                                          LB lb, float* As, float* Bs) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  for (int k0 = 0; k0 < K; k0 += TK) {
#pragma unroll
    for (int p = 0; p < TM * TK / NT; ++p) {
      const int idx = threadIdx.x + p * NT;
      int r, kk;
      if (A_KFAST) { r = idx / TK; kk = idx % TK; }
      else { r = idx % TM; kk = idx / TM; }
      As[kk * LDS + r] = k0 + kk < K ? la(r, k0 + kk) : 0.f;
      int c;
      if (B_KFAST) { c = idx / TK; kk = idx % TK; }
      else { c = idx % TN; kk = idx / TN; }
      Bs[kk * LDS + c] = k0 + kk < K ? lb(k0 + kk, c) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[kk * LDS + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk * LDS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// scratch rows per (b, h): [0, L) b_t, [L, 2L) m_t, [2L, 3L) w_inter_t,
// [3L, 4L) w_src_s, [4L] w_old
__device__ __forceinline__ float* rows_of(float* rows, int bh, int L) {
  return rows + (long long)bh * (4 * L + 1);
}

__global__ void __launch_bounds__(NT)
    gates_kernel(const float* __restrict__ ilog,
                 const float* __restrict__ flog, const float* __restrict__ m0,
                 float* __restrict__ rows, float* __restrict__ m_out, int L,
                 int H) {
  extern __shared__ float sh[];
  float* sb = sh;          // b_t
  float* si = sh + L;      // i_t
  __shared__ float red[NT];
  const int bh = blockIdx.x, b = bh / H, hh = bh % H;
  for (int t = threadIdx.x; t < L; t += NT) {
    si[t] = ilog[((long long)b * L + t) * H + hh];
    sb[t] = flog[((long long)b * L + t) * H + hh];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float acc = 0.f;
    for (int t = 0; t < L; ++t) {
      acc += sb[t];
      sb[t] = acc;
    }
  }
  __syncthreads();
  const float mm0 = m0[bh];
  const float bL = sb[L - 1];
  float* R = rows_of(rows, bh, L);
  float src_max = -INFINITY;
  for (int t = threadIdx.x; t < L; t += NT) {
    const float bt = sb[t];
    float mx = t < L - 1 ? NEG : -INFINITY;
    for (int s = 0; s <= t; ++s) mx = fmaxf(mx, (bt - sb[s]) + si[s]);
    const float inter = bt + mm0;
    const float mt = fmaxf(inter, mx);
    R[t] = bt;
    R[L + t] = mt;
    R[2 * L + t] = expf(inter - mt);
    src_max = fmaxf(src_max, (bL - bt) + si[t]);
  }
  red[threadIdx.x] = src_max;
  __syncthreads();
  for (int w = NT / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w)
      red[threadIdx.x] = fmaxf(red[threadIdx.x], red[threadIdx.x + w]);
    __syncthreads();
  }
  const float m_new = fmaxf(bL + mm0, red[0]);
  for (int s = threadIdx.x; s < L; s += NT)
    R[3 * L + s] = expf((bL - sb[s]) + si[s] - m_new);
  if (threadIdx.x == 0) {
    R[4 * L] = expf(bL + mm0 - m_new);
    m_out[bh] = m_new;
  }
}

// S[t][s] for one 64 x 64 tile of (t, s)
template <typename T>
__global__ void __launch_bounds__(NT)
    scores_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const float* __restrict__ ilog,
                  const float* __restrict__ rows, float* __restrict__ S,
                  int L, int H, int hd) {
  __shared__ float As[TK * LDS], Bs[TK * LDS];
  const int bh = blockIdx.z, b = bh / H, hh = bh % H;
  const int t0 = blockIdx.x * TM, s0 = blockIdx.y * TN;
  const long long rs = (long long)H * hd;   // position stride of q/k/v
  const T* qb = q + ((long long)b * L * H + hh) * hd;
  const T* kb = k + ((long long)b * L * H + hh) * hd;
  float acc[4][4] = {};
  gemm_tile<true, true>(
      acc, hd,
      [&](int r, int d) {
        return t0 + r < L ? ld(qb + (t0 + r) * rs + d) : 0.f;
      },
      [&](int d, int c) {
        return s0 + c < L ? ld(kb + (s0 + c) * rs + d) : 0.f;
      },
      As, Bs);
  const float* R = rows_of(const_cast<float*>(rows), bh, L);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty + 16 * i;
    if (t >= L) continue;
    const float bt = R[t], mt = R[L + t];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int s = s0 + tx + 16 * j;
      if (s >= L) continue;
      const float dm =
          s <= t ? (bt - R[s]) + ilog[((long long)b * L + s) * H + hh] : NEG;
      S[((long long)bh * L + t) * L + s] = acc[i][j] * expf(dm - mt);
    }
  }
}

// h for one tile of 64 positions x 64 value columns
template <typename T>
__global__ void __launch_bounds__(NT)
    out_kernel(const T* __restrict__ q, const T* __restrict__ v,
               const float* __restrict__ C0, const float* __restrict__ n0,
               const float* __restrict__ rows, const float* __restrict__ S,
               T* __restrict__ h, int L, int H, int hd) {
  __shared__ float As[TK * LDS], Bs[TK * LDS];
  __shared__ float den[TM];
  const int bh = blockIdx.z, b = bh / H, hh = bh % H;
  const int t0 = blockIdx.x * TM, e0 = blockIdx.y * TN;
  const long long rs = (long long)H * hd;
  const T* qb = q + ((long long)b * L * H + hh) * hd;
  const T* vb = v + ((long long)b * L * H + hh) * hd;
  const float* Sb = S + (long long)bh * L * L;
  const float* Cb = C0 + (long long)bh * hd * hd;
  const float* nb = n0 + (long long)bh * hd;
  const float* R = rows_of(const_cast<float*>(rows), bh, L);

  // den_t: 4 threads per row, each over a strided quarter
  {
    const int r = threadIdx.x / 4, part = threadIdx.x % 4;
    const int t = t0 + r;
    float ssum = 0.f, qn = 0.f;
    if (t < L) {
      for (int s = part; s < L; s += 4) ssum += Sb[(long long)t * L + s];
      for (int d = part; d < hd; d += 4) qn += ld(qb + t * rs + d) * nb[d];
    }
    ssum += __shfl_xor_sync(0xffffffffu, ssum, 1);
    ssum += __shfl_xor_sync(0xffffffffu, ssum, 2);
    qn += __shfl_xor_sync(0xffffffffu, qn, 1);
    qn += __shfl_xor_sync(0xffffffffu, qn, 2);
    if (part == 0 && t < L) den[r] = ssum + qn * R[2 * L + t];
  }

  float sv[4][4] = {}, qc[4][4] = {};
  gemm_tile<true, false>(
      sv, L,
      [&](int r, int s) {
        return t0 + r < L ? Sb[(long long)(t0 + r) * L + s] : 0.f;
      },
      [&](int s, int c) {
        return e0 + c < hd ? ld(vb + s * rs + e0 + c) : 0.f;
      },
      As, Bs);
  gemm_tile<true, false>(
      qc, hd,
      [&](int r, int d) {
        return t0 + r < L ? ld(qb + (t0 + r) * rs + d) : 0.f;
      },
      [&](int d, int c) {
        return e0 + c < hd ? Cb[(long long)d * hd + e0 + c] : 0.f;
      },
      As, Bs);
  // den[] was written before the GEMMs' first __syncthreads
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, t = t0 + r;
    if (t >= L) continue;
    const float wi = R[2 * L + t], mt = R[L + t];
    const float dn = fmaxf(fabsf(den[r]), expf(-mt));
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = e0 + tx + 16 * j;
      if (e >= hd) continue;
      st(h + ((long long)(b * L + t) * H + hh) * hd + e,
         (sv[i][j] + qc[i][j] * wi) / dn);
    }
  }
}

// C (and n) for one 64 x 64 tile of (d, e)
template <typename T>
__global__ void __launch_bounds__(NT)
    state_kernel(const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ C0, const float* __restrict__ n0,
                 const float* __restrict__ rows, float* __restrict__ C,
                 float* __restrict__ n, int L, int H, int hd) {
  __shared__ float As[TK * LDS], Bs[TK * LDS];
  const int bh = blockIdx.z, b = bh / H, hh = bh % H;
  const int d0 = blockIdx.x * TM, e0 = blockIdx.y * TN;
  const long long rs = (long long)H * hd;
  const T* kb = k + ((long long)b * L * H + hh) * hd;
  const T* vb = v + ((long long)b * L * H + hh) * hd;
  const float* R = rows_of(const_cast<float*>(rows), bh, L);
  const float* wsrc = R + 3 * L;
  const float w_old = R[4 * L];
  float acc[4][4] = {};
  gemm_tile<false, false>(
      acc, L,
      [&](int r, int s) {
        return d0 + r < hd ? ld(kb + s * rs + d0 + r) * wsrc[s] : 0.f;
      },
      [&](int s, int c) {
        return e0 + c < hd ? ld(vb + s * rs + e0 + c) : 0.f;
      },
      As, Bs);
  const float* Cb = C0 + (long long)bh * hd * hd;
  float* Co = C + (long long)bh * hd * hd;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int d = d0 + ty + 16 * i;
    if (d >= hd) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = e0 + tx + 16 * j;
      if (e >= hd) continue;
      const long long o = (long long)d * hd + e;
      Co[o] = Cb[o] * w_old + acc[i][j];
    }
  }
  if (blockIdx.y == 0) {
    // n_d: 4 threads per row d of the tile
    const int r = threadIdx.x / 4, part = threadIdx.x % 4;
    const int d = d0 + r;
    float sum = 0.f;
    if (d < hd)
      for (int s = part; s < L; s += 4) sum += ld(kb + s * rs + d) * wsrc[s];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if (part == 0 && d < hd)
      n[(long long)bh * hd + d] = n0[(long long)bh * hd + d] * w_old + sum;
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const float* ilog,
           const float* flog, const float* C0, const float* n0,
           const float* m0, void* h, float* C, float* n, float* m,
           float* rows, float* S, int B, int L, int H, int hd,
           cudaStream_t stream) {
  const int BH = B * H;
  const size_t gates_smem = size_t(2) * L * sizeof(float);
  if (gates_smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        gates_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)gates_smem);
    if (err != cudaSuccess) return (int)err;
  }
  gates_kernel<<<BH, NT, gates_smem, stream>>>(ilog, flog, m0, rows, m, L,
                                               H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int lt = (L + TM - 1) / TM, dt = (hd + TN - 1) / TN;
  scores_kernel<T><<<dim3(lt, lt, BH), NT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), ilog, rows, S, L,
      H, hd);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  out_kernel<T><<<dim3(lt, dt, BH), NT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(v), C0, n0, rows, S,
      static_cast<T*>(h), L, H, hd);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  state_kernel<T><<<dim3(dt, dt, BH), NT, 0, stream>>>(
      static_cast<const T*>(k), static_cast<const T*>(v), C0, n0, rows, C, n,
      L, H, hd);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (q, k, v and h).  q/k/v/h: contiguous
// (B, L, H, hd); ilog/flog: contiguous (B, L, H) f32; C0/C: (B, H, hd, hd)
// f32; n0/n: (B, H, hd) f32; m0/m: (B, H) f32; rows: B*H*(4L+1) f32 and
// S: B*H*L*L f32 of scratch.  Returns a cudaError_t (0 on success); -1
// for an unsupported dtype.
extern "C" int mlstm_cell_launch(int dtype, const void* q, const void* k,
                                 const void* v, const float* ilog,
                                 const float* flog, const float* C0,
                                 const float* n0, const float* m0, void* h,
                                 float* C, float* n, float* m, float* rows,
                                 float* S, int B, int L, int H, int hd,
                                 cudaStream_t stream) {
  if (B == 0 || H == 0 || L == 0) return 0;
  if (dtype == 0)
    return launch<float>(q, k, v, ilog, flog, C0, n0, m0, h, C, n, m, rows,
                         S, B, L, H, hd, stream);
  if (dtype == 1)
    return launch<bf16>(q, k, v, ilog, flog, C0, n0, m0, h, C, n, m, rows,
                        S, B, L, H, hd, stream);
  return -1;
}
