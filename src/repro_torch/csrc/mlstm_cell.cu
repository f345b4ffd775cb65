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
// shared memory cannot hold.  So the cell is cut into blocks of one grid.
//
// Bound: at the engine's shapes (B = 1, H = 4, L = 256, hd = 512) the call
// moves 12.6 MB (q, k, v and h in bf16, C in and out in f32) and does four
// products.  On the tensor cores q k^T (bf16 x bf16) takes one pass; S v,
// q C0 and (k w)^T v have an f32 operand (S, C0, k * w_src), which is
// split into bf16 hi + lo, so they take two passes each: 2.55 G
// operations, 2.58 us at 989 TFLOP/s, under the bytes' 3.76 us at 3.35
// TB/s.  So bytes bound it, once the products run on the tensor cores.
//
// bf16 q/k/v (the serving path): cell_wgmma, one launch, one warpgroup
// per block, products by wgmma (hopper.cuh) with f32 accumulators, and no
// (L, L) scratch in device memory.  The grid holds two kinds of block:
//   * output blocks, one per (64-row slab of positions, 128 value
//     columns): O = q C0 (C0's columns split into hi + lo, two passes over
//     q from shared memory), scaled by exp(b_t + m0 - m_t) per row; then
//     for each 64-key tile up to the slab's diagonal, S = q k^T by wgmma
//     (both K-major), decayed and masked in registers, its row sums added
//     to den, split into hi + lo bf16 register fragments, O += S v (v from
//     shared memory, MN-major); h = O / max(|den|, exp(-m_t)), den_t
//     taking q_t . n0 from the CUDA cores.  Each block recomputes its
//     slab's q k^T instead of reading S back.
//   * state blocks, one per (64 rows of C, 128 columns): k w_src in f32
//     for 64 positions at a time, split into hi + lo and stored as the
//     MN-major A operand (the transpose bit), v as the MN-major B
//     operand; C = C0 w_old + the sum; the first column of blocks also
//     sums n on the CUDA cores, and one block writes m_new.
// Every block computes the gates it needs itself: b by a block-wide
// inclusive scan, m_t from a prefix max of i_s - b_s (m_t = max(b_t + m0,
// b_t + max_{s<=t}(i_s - b_s))), m_new by a max over the chunk.  A
// rounding of m_t moves num and den alike, so h does not feel it.
// The bf16 tiles (q's slab, k and v tiles) arrive by TMA into the
// 128-byte-swizzled layout (4-D tensor maps over (hd, H, L, B), encoded
// per call by libcuda's cuTensorMapEncodeTiled found with dlopen/dlsym),
// counted on an mbarrier each, issued one tile ahead: q with the first k
// and v tiles at the start, k(t+1) once q k(t)^T is done, v(t+1) once
// S v(t) is.  Issued by 128 threads as 16-byte cp.async copies instead,
// the same tiles queued behind each other and the shared-memory loads of
// the decay, at ~3 us a tile (61 against 45 us a call, H100).  C0 goes
// through registers (it is split on the way), the next 64-row chunk's
// loads in flight while the current chunk's products run.  A head dim
// that is not a multiple of 64 (or of 8, or an unaligned tensor) takes
// plain loads instead of tensor maps.  Padded rows (ilog = -1e30), a
// fresh state (m0 = -1e30) and the -1e30 mask above the diagonal compute
// what the plain version computes; rows past L and columns past hd are
// zero in shared memory and masked on store.
//
// float32 q/k/v (xLSTM-350M's f32 logit check and the tests): the first
// version, kept as it was and selected by dtype: four launches on one
// stream (gates; S in 64 x 64 tiles to an f32 (L, L) scratch; h; C and
// n), f32 FMA on the CUDA cores in 64 x 64 shared-memory tiles, which
// holds the f32 plain version to 1e-4.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// float32: the first version, four launches on the CUDA cores
// ---------------------------------------------------------------------------

constexpr float NEG = -1e30f;
constexpr int NT = 256;            // threads per block
constexpr int TM = 64, TN = 64;    // output tile
constexpr int TK = 16;             // depth per shared-memory step
constexpr int LDS = TM + 4;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ void st(float* p, float x) { *p = x; }

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

// ---------------------------------------------------------------------------
// bf16: one launch, wgmma
// ---------------------------------------------------------------------------

namespace wg {

constexpr int THREADS = 128;     // one warpgroup
constexpr int BM = 64;           // positions per slab, rows of C per block
constexpr int BK = 64;           // keys per tile
constexpr int EN = 128;          // value columns per block
constexpr int MAX_HD = 512;
constexpr int BOX = 64 * 128;    // bytes of one 64-row SW128 box
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const bf16 *q, *k, *v;
  const float *ilog, *flog, *C0, *n0, *m0;
  bf16* h;
  float *C, *n, *m;
  int B, L, H, hd, vec, tma;
};

// byte offset of the 16-byte chunk `ch` (columns 8ch .. 8ch+7) of row r
// in a tile of `rows` rows stored as SW128 boxes of 64 columns
__device__ __forceinline__ uint32_t sw(int r, int ch, int rows) {
  return (ch >> 3) * rows * 128 + r * 128 + (((ch & 7) ^ (r & 7)) << 4);
}

// K-major operand (rows x K, K contiguous): k-step kk reads 16 columns,
// 32 bytes into each swizzled row of box kk / 4
__device__ __forceinline__ uint64_t kmajor(uint32_t base, int kk, int rows) {
  return hopper::sw128_desc(base + (kk >> 2) * rows * 128 + (kk & 3) * 32,
                            16, 1024);
}

// MN-major operand (K rows x MN, MN contiguous: the transpose bit): k-step
// kk reads 16 rows (2048 bytes); its 64-column boxes lie rows * 128 bytes
// apart (leading offset), its 8-row groups 1024 bytes (stride offset)
__device__ __forceinline__ uint64_t mnmajor(uint32_t base, int kk,
                                            int rows) {
  return hopper::sw128_desc(base + kk * 2048, rows * 128, 1024);
}

__device__ __forceinline__ uint32_t pack(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float residual(float x) {
  return x - __bfloat162float(__float2bfloat16_rn(x));
}

// 8 bf16 of a row from column col, zeros at and past ncol (vec: 16-byte
// loads are aligned)
__device__ __forceinline__ uint4 ld8(const bf16* row, int col, int ncol,
                                     bool vec) {
  if (vec && col + 8 <= ncol)
    return *reinterpret_cast<const uint4*>(row + col);
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t lo =
        col + 2 * j < ncol ? __bfloat16_as_ushort(row[col + 2 * j]) : 0u;
    const uint32_t hi = col + 2 * j + 1 < ncol
                            ? __bfloat16_as_ushort(row[col + 2 * j + 1])
                            : 0u;
    w[j] = lo | (hi << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// 8 floats of a row from column col, zeros at and past ncol
__device__ __forceinline__ void ld8f(const float* row, int col, int ncol,
                                     bool vec, float (&x)[8]) {
  if (vec && col + 8 <= ncol) {
    const float4 a = reinterpret_cast<const float4*>(row + col)[0];
    const float4 b = reinterpret_cast<const float4*>(row + col)[1];
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
    return;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) x[j] = col + j < ncol ? row[col + j] : 0.f;
}

__device__ __forceinline__ void unpack8(uint4 raw, float (&x)[8]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    x[2 * j] = __uint_as_float(w[j] << 16);
    x[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}

// x = hi + lo, each rounded to bf16
__device__ __forceinline__ void split8(const float (&x)[8], uint4& hi,
                                       uint4& lo) {
  hi = make_uint4(pack(x[0], x[1]), pack(x[2], x[3]), pack(x[4], x[5]),
                  pack(x[6], x[7]));
  lo = make_uint4(pack(residual(x[0]), residual(x[1])),
                  pack(residual(x[2]), residual(x[3])),
                  pack(residual(x[4]), residual(x[5])),
                  pack(residual(x[6]), residual(x[7])));
}

// inclusive scan (sum, or max) of x[0 .. n) in shared memory by the
// block: each thread scans a contiguous run, the runs' totals are scanned
// across the warps; red holds 4 floats.  All threads call it.
template <bool MAX>
__device__ void block_scan(float* x, int n, float* red) {
  auto op = [](float a, float b) { return MAX ? fmaxf(a, b) : a + b; };
  const float id = MAX ? -INFINITY : 0.f;
  const int per = (n + THREADS - 1) / THREADS;
  const int lo = threadIdx.x * per, hi = min(n, lo + per);
  float acc = id;
  for (int i = lo; i < hi; ++i) {
    acc = op(acc, x[i]);
    x[i] = acc;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float inc = acc;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(FULL, inc, o);
    if (lane >= o) inc = op(inc, y);
  }
  if (lane == 31) red[warp] = inc;
  __syncthreads();
  float off = id;
  for (int w = 0; w < warp; ++w) off = op(off, red[w]);
  float excl = __shfl_up_sync(FULL, inc, 1);
  if (lane == 0) excl = id;
  off = op(off, excl);
  if (threadIdx.x > 0)
    for (int i = lo; i < hi; ++i) x[i] = op(off, x[i]);
  __syncthreads();
}

// max of f(i) over i < n, by the block; all threads call it
template <class F>
__device__ float block_max(int n, F f, float* red) {
  float mx = -INFINITY;
  for (int i = threadIdx.x; i < n; i += THREADS) mx = fmaxf(mx, f(i));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = mx;
  __syncthreads();
  mx = fmaxf(fmaxf(red[0], red[1]), fmaxf(red[2], red[3]));
  __syncthreads();
  return mx;
}

// rows x (chunks x 8) bf16 of a matrix with row stride `stride` elements,
// from (row0, col0), into the SW128 tile at dst by plain loads and stores
// (the path without tensor maps); zeros at and past row nrow and column
// ncol
template <int ROWS, int CHUNKS>
__device__ __forceinline__ void load_tile(unsigned char* dst, const bf16* src,
                                          long long stride, int row0,
                                          int nrow, int col0, int ncol,
                                          bool vec) {
#pragma unroll 4
  for (int idx = threadIdx.x; idx < ROWS * CHUNKS; idx += THREADS) {
    const int r = idx / CHUNKS, ch = idx % CHUNKS;
    const int row = row0 + r, col = col0 + ch * 8;
    *reinterpret_cast<uint4*>(dst + sw(r, ch, ROWS)) =
        row < nrow ? ld8(src + row * stride, col, ncol, vec)
                   : make_uint4(0u, 0u, 0u, 0u);
  }
}

// `nbox` 64-column boxes of 64 rows of a (hd, H, L, B) bf16 tensor map,
// from column col0 and row row0 of head hh, batch b, into the SW128 tile
// at dst (boxes BOX bytes apart), counted on `bar`; one thread issues
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int nbox, int col0,
                                         int hh, int row0, int b) {
  hopper::mbar_expect_tx(bar, nbox * BOX);
  for (int j = 0; j < nbox; ++j)
    hopper::tma_load_4d(dst + j * BOX, map, bar, col0 + 64 * j, hh, row0, b);
}

// C0 rows dc*64 .. dc*64+63, columns e0 .. e0+EN-1 (f32): this thread's 8
// chunks of 8, loaded together
__device__ __forceinline__ void load_c0(float (&x)[8][8], const float* Cb,
                                        int hd, int dc, int e0, bool vec) {
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const int idx = threadIdx.x + p * THREADS;
    const int r = idx / (EN / 8), ch = idx % (EN / 8);
    const int d = dc * 64 + r;
    ld8f(Cb + (long long)(d < hd ? d : 0) * hd, e0 + ch * 8, d < hd ? hd : 0,
         vec, x[p]);
  }
}

// k rows s0 .. s0+63, columns d0 .. d0+63 (bf16): this thread's 4 chunks
__device__ __forceinline__ void load_k(uint4 (&kr)[4], const bf16* kb,
                                       long long rs, int L, int hd, int s0,
                                       int d0, bool vec) {
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int idx = threadIdx.x + p * THREADS;
    const int s = s0 + idx / 8, col = d0 + (idx % 8) * 8;
    kr[p] = s < L ? ld8(kb + s * rs, col, hd, vec)
                  : make_uint4(0u, 0u, 0u, 0u);
  }
}

// Shared memory, in bytes from the 1024-aligned base.  Output blocks:
// q's slab (NB boxes), a k tile (NB), a v tile (2), C0's hi and lo (2
// each); state blocks use the first 6 boxes: k w_src's hi and lo, two v
// tiles.  Then the gate rows.
template <int NB>
struct Smem {
  static constexpr int Q = 0, K = NB * BOX, V = 2 * NB * BOX;
  static constexpr int CH = V + 2 * BOX, CL = CH + 2 * BOX;
  static constexpr int F = CL + 2 * BOX;
  static constexpr int KH = 0, KL = BOX, V0 = 2 * BOX;
};
static_assert(Smem<1>::F >= 6 * BOX, "state blocks' boxes");

inline int smem_bytes(int nb, int L) {
  return (2 * nb + 6) * BOX + (8 + 3 * L + 3 * BM + 8 + MAX_HD) * 4 + 1024;
}

// q, k and v as (hd, H, L, B) tensor maps (A.tma), boxes of 64 columns x
// 1 head x 64 rows x 1 sequence, 128-byte swizzle; rows past L and
// columns past hd arrive as zeros
template <int NB>
__global__ void __launch_bounds__(THREADS, 1)
    cell_wgmma(const Args A, const __grid_constant__ CUtensorMap qmap,
               const __grid_constant__ CUtensorMap kmap,
               const __grid_constant__ CUtensorMap vmap) {
  using SM = Smem<NB>;
  extern __shared__ __align__(128) unsigned char wg_smem[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(wg_smem) + 1023) & ~uintptr_t(1023));
  const int L = A.L, H = A.H, hd = A.hd;
  const bool vec = A.vec != 0, tma = A.tma != 0;
  const int n_slab = (L + BM - 1) / BM, n_et = (hd + EN - 1) / EN;
  const int BH = A.B * H;
  const int n_out = BH * n_slab * n_et;
  const int tid = threadIdx.x;

  // output blocks first, the slabs that see the most keys first; then
  // the state blocks
  int blk = blockIdx.x, bh, slab = 0, dt = 0, et;
  const bool is_out = blk < n_out;
  if (is_out) {
    slab = n_slab - 1 - blk / (BH * n_et);
    blk %= BH * n_et;
    bh = blk / n_et;
    et = blk % n_et;
  } else {
    blk -= n_out;
    bh = blk / (NB * n_et);
    blk %= NB * n_et;
    dt = blk / n_et;
    et = blk % n_et;
  }
  const int b = bh / H, hh = bh % H;
  const int e0 = et * EN;
  const long long rs = (long long)H * hd;        // position stride
  const long long head = ((long long)b * L * H + hh) * hd;
  const bf16* qb = A.q + head;
  const bf16* kb = A.k + head;
  const bf16* vb = A.v + head;
  const float* Cb = A.C0 + (long long)bh * hd * hd;
  const float* nb = A.n0 + (long long)bh * hd;
  const uint32_t s0_base = hopper::smem_u32(sm);

  // mbarriers of the tensor-map copies: q, k, v (output blocks); the two
  // v buffers (state blocks)
  const uint32_t bar = s0_base + SM::F;
  float* gb = reinterpret_cast<float*>(sm + SM::F) + 8;
  float* gi = gb + L;
  float* gx = gi + L;
  float* rowM = gx + L;
  float* rowW = rowM + BM;
  float* rowQN = rowW + BM;
  float* red = rowQN + BM;
  float* n0s = red + 8;                // n0, output blocks

  const int r0 = slab * BM;
  // the tiles: by tensor map (one thread issues, an mbarrier counts the
  // bytes) or by plain loads, which have landed at the next barrier
  auto fetch_k = [&](int s0) {
    if (!tma)
      load_tile<BK, NB * 8>(sm + SM::K, kb, rs, s0, L, 0, hd, vec);
    else if (tid == 0)
      tma_tile(s0_base + SM::K, &kmap, bar + 8, NB, 0, hh, s0, b);
  };
  auto fetch_v = [&](int off, uint32_t bar_v, int s0) {
    if (!tma)
      load_tile<BK, EN / 8>(sm + off, vb, rs, s0, L, e0, hd, vec);
    else if (tid == 0)
      tma_tile(s0_base + off, &vmap, bar_v, 2, e0, hh, s0, b);
  };
  auto wait_tma = [&](uint32_t bar_x, int parity) {
    if (tma) hopper::mbar_wait(bar_x, parity);
  };
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) hopper::mbar_init(bar + 8 * i, 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();
  // copies in flight from the start: q's slab and the first k and v tiles
  // (the first v tile of a state block); the gates and n0
  if (is_out) {
    if (!tma)
      load_tile<BM, NB * 8>(sm + SM::Q, qb, rs, r0, L, 0, hd, vec);
    else if (tid == 0)
      tma_tile(s0_base + SM::Q, &qmap, bar, NB, 0, hh, r0, b);
    fetch_k(0);
    fetch_v(SM::V, bar + 16, 0);
    for (int d = tid; d < hd; d += THREADS)
      hopper::cp_async4(hopper::smem_u32(n0s + d), nb + d);
  } else {
    fetch_v(SM::V0, bar, 0);
  }
  for (int t = tid; t < L; t += THREADS) {
    const long long o = ((long long)b * L + t) * H + hh;
    hopper::cp_async4(hopper::smem_u32(gb + t), A.flog + o);
    hopper::cp_async4(hopper::smem_u32(gi + t), A.ilog + o);
  }
  hopper::cp_async_commit();
  hopper::cp_async_wait<0>();
  __syncthreads();

  // ---- gates: b by a scan, i ----
  const float mm0 = A.m0[bh];
  block_scan<false>(gb, L, red);

  const int warp = tid >> 5, lane = tid & 31, c = lane & 3;
  const int rl[2] = {warp * 16 + (lane >> 2), warp * 16 + (lane >> 2) + 8};

  if (is_out) {
    // ---------------- output block: h for 64 rows x 128 columns -------
    for (int s = tid; s < L; s += THREADS) gx[s] = gi[s] - gb[s];
    __syncthreads();
    block_scan<true>(gx, L, red);      // max_{s<=t} (i_s - b_s)
    if (tid < BM) {
      const int t = r0 + tid;
      float mt = 0.f, wi = 0.f;
      if (t < L) {
        const float bt = gb[t], inter = bt + mm0;
        mt = fmaxf(inter, bt + gx[t]);
        if (t < L - 1) mt = fmaxf(mt, NEG);   // the mask, as the plain max
        wi = expf(inter - mt);
      }
      rowM[tid] = mt;
      rowW[tid] = wi;
    }
    float x[8][8];
    load_c0(x, Cb, hd, 0, e0, vec);
    wait_tma(bar, 0);                  // q
    hopper::fence_proxy_async();
    __syncthreads();
    // q_t . n0 on the CUDA cores, two threads per row, from shared memory
    // (n0 past hd is never read: q is 0 there)
    {
      const int r = tid >> 1;
      float acc = 0.f;
#pragma unroll 4
      for (int ch = tid & 1; ch < NB * 8; ch += 2) {
        float qv[8];
        unpack8(*reinterpret_cast<const uint4*>(sm + SM::Q + sw(r, ch, BM)),
                qv);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (ch * 8 + j < hd) acc += qv[j] * n0s[ch * 8 + j];
      }
      acc += __shfl_xor_sync(FULL, acc, 1);
      if ((tid & 1) == 0) rowQN[r] = acc;
    }

    // O = q C0, C0's 64-row chunks split into hi + lo (MN-major B); the
    // next chunk's loads are in flight while the products run
    float o[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = 0.f;
#pragma unroll 1
    for (int dc = 0; dc < NB; ++dc) {
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        const int idx = tid + p * THREADS;
        const int r = idx / (EN / 8), ch = idx % (EN / 8);
        uint4 hi, lo;
        split8(x[p], hi, lo);
        *reinterpret_cast<uint4*>(sm + SM::CH + sw(r, ch, 64)) = hi;
        *reinterpret_cast<uint4*>(sm + SM::CL + sw(r, ch, 64)) = lo;
      }
      hopper::fence_proxy_async();
      __syncthreads();
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hopper::wgmma_ss_n128<0, 1>(o, kmajor(s0_base + SM::Q, dc * 4 + kk, BM),
                                    mnmajor(s0_base + SM::CH, kk, 64), 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hopper::wgmma_ss_n128<0, 1>(o, kmajor(s0_base + SM::Q, dc * 4 + kk, BM),
                                    mnmajor(s0_base + SM::CL, kk, 64), 1);
      hopper::wgmma_commit();
      if (dc + 1 < NB) load_c0(x, Cb, hd, dc + 1, e0, vec);
      hopper::wgmma_wait_all();
      hopper::fence_regs(o);
      __syncthreads();
    }
    float mt[2], wi[2], bt[2];
    int t_[2];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      t_[h2] = r0 + rl[h2];
      mt[h2] = rowM[rl[h2]];
      wi[h2] = rowW[rl[h2]];
      bt[h2] = t_[h2] < L ? gb[t_[h2]] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] *= wi[(i >> 1) & 1];

    // O += S v over the key tiles up to the diagonal.  Copies in flight:
    // k(kt) and v(kt) on entry; k(kt+1) is issued once q k(kt)^T is done,
    // v(kt+1) once S v(kt) is
    float den[2] = {0.f, 0.f};
#pragma unroll 1
    for (int kt = 0; kt <= slab; ++kt) {
      const int s0 = kt * BK;
      wait_tma(bar + 8, kt & 1);       // k(kt)
      hopper::fence_proxy_async();
      __syncthreads();
      float sc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = 0.f;
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4 * NB; ++kk)
        hopper::wgmma_ss_n64(sc, kmajor(s0_base + SM::Q, kk, BM),
                             kmajor(s0_base + SM::K, kk, BK), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::fence_regs(sc);
      __syncthreads();
      if (kt < slab) fetch_k(s0 + BK);
      // decay and mask: S[t, s] = (q_t . k_s) exp(D[t, s] - m_t)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int h2 = (i >> 1) & 1;
        const int t = t_[h2];
        const int s = s0 + 8 * (i >> 2) + 2 * c + (i & 1);
        float val = 0.f;
        if (t < L && s < L) {
          const float dm = s <= t ? (bt[h2] - gb[s]) + gi[s] : NEG;
          val = sc[i] * expf(dm - mt[h2]);
        }
        sc[i] = val;
        den[h2] += val;
      }
      // S as hi + lo bf16 A fragments: keys 16j .. 16j+15 are k-step j
      uint32_t ph[4][4], pl[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x0 = sc[8 * j + 2 * e], x1 = sc[8 * j + 2 * e + 1];
          ph[j][e] = pack(x0, x1);
          pl[j][e] = pack(residual(x0), residual(x1));
        }
      wait_tma(bar + 16, kt & 1);      // v(kt)
      hopper::fence_proxy_async();
      __syncthreads();
      hopper::wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j)
        hopper::wgmma_rs_n128_t(o, ph[j], mnmajor(s0_base + SM::V, j, BK));
#pragma unroll
      for (int j = 0; j < 4; ++j)
        hopper::wgmma_rs_n128_t(o, pl[j], mnmajor(s0_base + SM::V, j, BK));
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::fence_regs(o);
      __syncthreads();
      if (kt < slab) fetch_v(SM::V, bar + 16, s0 + BK);
    }
    // h = O / max(|den|, exp(-m_t))
    bf16* hb = A.h + head;
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      den[h2] += __shfl_xor_sync(FULL, den[h2], 1);
      den[h2] += __shfl_xor_sync(FULL, den[h2], 2);
    }
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int t = t_[h2];
      if (t >= L) continue;
      const float dsum = den[h2] + rowQN[rl[h2]] * wi[h2];
      const float dn = fmaxf(fabsf(dsum), expf(-mt[h2]));
      bf16* dst = hb + t * rs;
#pragma unroll
      for (int j = 0; j < EN / 8; ++j) {
        const int e = e0 + 8 * j + 2 * c;
        const float x0 = o[4 * j + 2 * h2] / dn;
        const float x1 = o[4 * j + 2 * h2 + 1] / dn;
        if (e + 1 < hd && hd % 2 == 0) {
          *reinterpret_cast<__nv_bfloat162*>(dst + e) =
              __floats2bfloat162_rn(x0, x1);
        } else {
          if (e < hd) dst[e] = __float2bfloat16_rn(x0);
          if (e + 1 < hd) dst[e + 1] = __float2bfloat16_rn(x1);
        }
      }
    }
    return;
  }

  // ---------------- state block: C for 64 rows x 128 columns ----------
  const float bL = gb[L - 1];
  const float src_max =
      block_max(L, [&](int s) { return (bL - gb[s]) + gi[s]; }, red);
  const float m_new = fmaxf(bL + mm0, src_max);
  const float w_old = expf(bL + mm0 - m_new);
  for (int s = tid; s < L; s += THREADS)
    gx[s] = expf((bL - gb[s]) + gi[s] - m_new);          // w_src
  const int d0 = dt * 64;
  uint4 kr[4];
  load_k(kr, kb, rs, L, hd, 0, d0, vec);
  __syncthreads();

  float acc[64], nacc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  const int n_chunks = (L + BK - 1) / BK;
#pragma unroll 1
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int s0 = ci * BK;
    // (k w_src)[s][d0 ..] in f32, as hi + lo: the MN-major A operand
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int idx = tid + p * THREADS;
      const int r = idx / 8, ch = idx % 8;
      float xk[8];
      unpack8(kr[p], xk);
      const float w = s0 + r < L ? gx[s0 + r] : 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        xk[j] *= w;
        nacc[j] += xk[j];        // n: this thread's rows, columns 8 ch ..
      }
      uint4 hi, lo;
      split8(xk, hi, lo);
      *reinterpret_cast<uint4*>(sm + SM::KH + sw(r, ch, BK)) = hi;
      *reinterpret_cast<uint4*>(sm + SM::KL + sw(r, ch, BK)) = lo;
    }
    // v tiles alternate between two buffers, each with its mbarrier
    const int vo = SM::V0 + (ci & 1) * 2 * BOX;
    if (ci + 1 < n_chunks)
      fetch_v(SM::V0 + ((ci + 1) & 1) * 2 * BOX, bar + 8 * ((ci + 1) & 1),
              s0 + BK);
    wait_tma(bar + 8 * (ci & 1), (ci >> 1) & 1);           // v(ci)
    hopper::fence_proxy_async();
    __syncthreads();
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hopper::wgmma_ss_n128<1, 1>(acc, mnmajor(s0_base + SM::KH, kk, BK),
                                  mnmajor(s0_base + vo, kk, BK), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hopper::wgmma_ss_n128<1, 1>(acc, mnmajor(s0_base + SM::KL, kk, BK),
                                  mnmajor(s0_base + vo, kk, BK), 1);
    hopper::wgmma_commit();
    if (ci + 1 < n_chunks) load_k(kr, kb, rs, L, hd, s0 + BK, d0, vec);
    hopper::wgmma_wait_all();
    hopper::fence_regs(acc);
    __syncthreads();
  }
  // C = C0 w_old + (k w_src)^T v
  float* Co = A.C + (long long)bh * hd * hd;
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int d = d0 + rl[h2];
    if (d >= hd) continue;
#pragma unroll
    for (int j = 0; j < EN / 8; ++j) {
      const int e = e0 + 8 * j + 2 * c;
      const long long o = (long long)d * hd + e;
      if (e + 1 < hd && hd % 2 == 0) {
        const float2 c0 = *reinterpret_cast<const float2*>(Cb + o);
        *reinterpret_cast<float2*>(Co + o) =
            make_float2(c0.x * w_old + acc[4 * j + 2 * h2],
                        c0.y * w_old + acc[4 * j + 2 * h2 + 1]);
      } else {
        if (e < hd) Co[o] = Cb[o] * w_old + acc[4 * j + 2 * h2];
        if (e + 1 < hd)
          Co[o + 1] = Cb[o + 1] * w_old + acc[4 * j + 2 * h2 + 1];
      }
    }
  }
  if (et == 0) {
    // n_d = n0_d w_old + sum_s k[s, d] w_src_s: the 16 threads of each
    // 8 columns add their rows' sums in order, through shared memory
    float* part = reinterpret_cast<float*>(sm + SM::KH);     // [16][64]
#pragma unroll
    for (int j = 0; j < 8; ++j) part[(tid >> 3) * 64 + (tid & 7) * 8 + j] =
        nacc[j];
    __syncthreads();
    if (tid < 64) {
      const int d = d0 + tid;
      float sum = 0.f;
      for (int i = 0; i < 16; ++i) sum += part[i * 64 + tid];
      if (d < hd) A.n[(long long)bh * hd + d] = nb[d] * w_old + sum;
    }
    if (dt == 0 && tid == 0) A.m[bh] = m_new;
  }
}

using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

// libcuda's encoder, from the libcuda.so.1 already loaded in the
// process; nullptr if there is none
EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!h) h = dlopen("libcuda.so.1", RTLD_NOW);
    return h ? reinterpret_cast<EncodeTiled>(
                   dlsym(h, "cuTensorMapEncodeTiled"))
             : nullptr;
  }();
  return fn;
}

// (hd, H, L, B) bf16, contiguous; boxes of 64 columns x 1 head x 64 rows x
// 1 sequence, 128-byte swizzle
int encode(EncodeTiled enc, CUtensorMap* map, const void* base,
           const Args& a) {
  cuuint64_t dims[4] = {(cuuint64_t)a.hd, (cuuint64_t)a.H, (cuuint64_t)a.L,
                        (cuuint64_t)a.B};
  cuuint64_t strides[3] = {(cuuint64_t)a.hd * 2, (cuuint64_t)a.H * a.hd * 2,
                           (cuuint64_t)a.L * a.H * a.hd * 2};
  cuuint32_t box[4] = {64, 1, 64, 1};
  cuuint32_t es[4] = {1, 1, 1, 1};
  CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                   const_cast<void*>(base), dims, strides, box, es,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -3;
}

template <int NB>
int launch_nb(const Args& a, cudaStream_t stream) {
  CUtensorMap maps[3] = {};
  if (a.tma) {
    EncodeTiled enc = encoder();
    if (enc == nullptr) return -2;
    const void* src[3] = {a.q, a.k, a.v};
    for (int i = 0; i < 3; ++i) {
      const int rc = encode(enc, &maps[i], src[i], a);
      if (rc != 0) return rc;
    }
  }
  const int smem = smem_bytes(NB, a.L);
  const cudaError_t attr = cudaFuncSetAttribute(
      cell_wgmma<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  const int n_slab = (a.L + BM - 1) / BM, n_et = (a.hd + EN - 1) / EN;
  const int blocks = a.B * a.H * (n_slab + NB) * n_et;
  cell_wgmma<NB><<<blocks, THREADS, smem, stream>>>(a, maps[0], maps[1],
                                                    maps[2]);
  return (int)cudaGetLastError();
}

int launch(Args a, cudaStream_t stream) {
  // tensor maps need 16-byte aligned rows; a head dim that is a multiple
  // of 64 fills every box
  a.tma = a.vec && a.hd % 64 == 0;
  switch ((a.hd + 63) / 64) {
    case 1: return launch_nb<1>(a, stream);
    case 2: return launch_nb<2>(a, stream);
    case 3: return launch_nb<3>(a, stream);
    case 4: return launch_nb<4>(a, stream);
    case 5: return launch_nb<5>(a, stream);
    case 6: return launch_nb<6>(a, stream);
    case 7: return launch_nb<7>(a, stream);
    case 8: return launch_nb<8>(a, stream);
    default: return -1;
  }
}

}  // namespace wg

}  // namespace

// dtype: 0 float32, 1 bfloat16 (q, k, v and h).  q/k/v/h: contiguous
// (B, L, H, hd); ilog/flog: contiguous (B, L, H) f32; C0/C: (B, H, hd, hd)
// f32; n0/n: (B, H, hd) f32; m0/m: (B, H) f32.  float32 takes rows:
// B*H*(4L+1) f32 and S: B*H*L*L f32 of scratch; bfloat16 none (pass null)
// and hd <= 512, with vec = 1 when hd % 8 == 0 and every pointer is
// 16-byte aligned.  Returns a cudaError_t (0 on success); -1 for an
// unsupported dtype or head dim.
extern "C" int mlstm_cell_launch(int dtype, const void* q, const void* k,
                                 const void* v, const float* ilog,
                                 const float* flog, const float* C0,
                                 const float* n0, const float* m0, void* h,
                                 float* C, float* n, float* m, float* rows,
                                 float* S, int B, int L, int H, int hd,
                                 int vec, cudaStream_t stream) {
  if (B == 0 || H == 0 || L == 0) return 0;
  if (dtype == 0)
    return launch<float>(q, k, v, ilog, flog, C0, n0, m0, h, C, n, m, rows,
                         S, B, L, H, hd, stream);
  if (dtype == 1) {
    const wg::Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                     static_cast<const bf16*>(v), ilog, flog, C0, n0, m0,
                     static_cast<bf16*>(h), C, n, m, B, L, H, hd, vec, 0};
    return wg::launch(a, stream);
  }
  return -1;
}
