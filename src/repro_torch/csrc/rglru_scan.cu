// RG-LRU linear recurrence h_t = a_t * h_{t-1} + x_t for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rglru_scan.py::_kernel
// (wrapper rglru_scan).  On the TPU the grid is (B, channel blocks,
// sequence blocks) with the sequence innermost and the f32 carry in VMEM
// scratch between grid steps.  Hopper runs blocks in parallel, so the
// sequence is split inside a block instead: a sequence-parallel scan in
// one launch.
//
// Bound: bytes.  Each call reads a and x once and writes h once (3 x
// B*S*D f32) and does 2 operations per element; a 512-token chunk at
// D = 4096 is 25.2 MB, 7.52 us at 3.35 TB/s.  One thread per channel
// running all S dependent steps (the first version) gave 32 blocks of 128
// threads at the engine's B = 1: latency, not bandwidth, set its pace.
//
// Design.  A block owns CT channels of one sequence and the whole
// sequence, split into P segments of `seg` positions (256 threads = CT/VEC
// channel groups x P segments; the pure function
// kernels/rglru_scan.py::segment_plan picks CT, P and seg so that the
// blocks fill the card).  Each thread
//   1. loads its segment's a and x once into registers (VEC = 4: one
//      16-byte load of 4 channels per position; VEC = 1 for a D that is
//      not a multiple of 4 or an unaligned tensor),
//   2. scans the segment from 0, keeping (prod a, h_local),
//   3. after one barrier, the carries are chained through shared memory in
//      segment order (one thread per channel, P steps),
//   4. rescans its segment from its true carry-in out of registers and
//      writes h.
// Inside a segment h therefore follows the sequential recurrence exactly;
// only the carry-in is composed from segment products.  No second read of
// a or x, no scratch in device memory.  A sequence longer than P * SEGMAX
// runs as successive windows, each carried in from the last h of the
// one before.  Channels past D are masked; h_last is h at the true last
// position, written by the thread that wrote that h.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int SEGMAX = 16;    // positions a thread holds in registers

template <int VEC>
struct Vec;
template <>
struct Vec<4> {
  using T = float4;
  __device__ static T one() { return make_float4(1.f, 1.f, 1.f, 1.f); }
  __device__ static T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ static float get(const T& v, int j) {
    return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
  }
  __device__ static void set(T& v, int j, float x) {
    if (j == 0) v.x = x; else if (j == 1) v.y = x; else if (j == 2) v.z = x;
    else v.w = x;
  }
};
template <>
struct Vec<1> {
  using T = float;
  __device__ static T one() { return 1.f; }
  __device__ static T zero() { return 0.f; }
  __device__ static float get(const T& v, int) { return v; }
  __device__ static void set(T& v, int, float x) { v = x; }
};

template <int VEC>
__global__ void __launch_bounds__(THREADS)
    rglru_kernel(const float* __restrict__ a, const float* __restrict__ x,
                 const float* __restrict__ h0, float* __restrict__ h,
                 float* __restrict__ h_last, int S, int D, int groups,
                 int P, int seg) {
  using V = Vec<VEC>;
  using T = typename V::T;
  // sa[p][c]: segment p's product of a, then its carry-in; sh[p][c]: its
  // local h.  c runs over the block's CT = groups * VEC channels.
  extern __shared__ float smem[];
  const int CT = groups * VEC;
  float* sa = smem;
  float* sh = smem + P * CT;
  float* carry = smem + 2 * P * CT;      // CT: h before the window

  const int tid = threadIdx.x;
  const int grp = tid % groups, p = tid / groups;
  const int b = blockIdx.y;
  const int d = (blockIdx.x * groups + grp) * VEC;
  const bool active = p < P && d < D;    // VEC = 4 implies D % 4 == 0
  const long long base = (long long)b * S * D + d;

  if (tid < CT) {
    const int dc = blockIdx.x * CT + tid;
    carry[tid] = dc < D ? h0[(long long)b * D + dc] : 0.f;
  }
  for (int w0 = 0; w0 < S; w0 += P * seg) {
    const int t0 = w0 + p * seg;
    const int n = active ? max(0, min(seg, S - t0)) : 0;
    T av[SEGMAX], xv[SEGMAX];
#pragma unroll
    for (int u = 0; u < SEGMAX; ++u) {
      if (u < n) {
        const long long o = base + (long long)(t0 + u) * D;
        av[u] = *reinterpret_cast<const T*>(a + o);
        xv[u] = *reinterpret_cast<const T*>(x + o);
      } else {
        av[u] = V::one();
        xv[u] = V::zero();
      }
    }
    // 2. the segment from 0: (prod a, h_local) per channel
    T pa = V::one(), hl = V::zero();
#pragma unroll
    for (int u = 0; u < SEGMAX; ++u) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        V::set(hl, j, V::get(av[u], j) * V::get(hl, j) + V::get(xv[u], j));
        V::set(pa, j, V::get(pa, j) * V::get(av[u], j));
      }
    }
    if (p < P) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        sa[p * CT + grp * VEC + j] = V::get(pa, j);
        sh[p * CT + grp * VEC + j] = V::get(hl, j);
      }
    }
    __syncthreads();
    // 3. the carries in segment order; sa[q][c] becomes q's carry-in
    if (tid < CT) {
      float cin = carry[tid];
      for (int q = 0; q < P; ++q) {
        const float A = sa[q * CT + tid], Hq = sh[q * CT + tid];
        sa[q * CT + tid] = cin;
        cin = A * cin + Hq;
      }
    }
    __syncthreads();
    // 4. rescan from the true carry-in
    T hh;
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      V::set(hh, j, p < P ? sa[p * CT + grp * VEC + j] : 0.f);
#pragma unroll
    for (int u = 0; u < SEGMAX; ++u) {
      if (u < n) {
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          V::set(hh, j, V::get(av[u], j) * V::get(hh, j) + V::get(xv[u], j));
        *reinterpret_cast<T*>(h + base + (long long)(t0 + u) * D) = hh;
      }
    }
    // the window's last h carries into the next window; the sequence's
    // last is h_last
    const int w_end = min(S, w0 + P * seg);
    if (n > 0 && t0 + n == w_end) {
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        carry[grp * VEC + j] = V::get(hh, j);
      if (w_end == S)
        *reinterpret_cast<T*>(h_last + (long long)b * D + d) = hh;
    }
    __syncthreads();
  }
  if (S == 0 && tid < CT) {
    const int dc = blockIdx.x * CT + tid;
    if (dc < D) h_last[(long long)b * D + dc] = carry[tid];
  }
}

}  // namespace

// a, x, h: contiguous (B, S, D) float32; h0, h_last: contiguous (B, D)
// float32.  vec: 4 (D % 4 == 0 and every pointer 16-byte aligned) or 1;
// groups * P == 256 threads, CT = groups * vec channels per block, seg <=
// 16 positions per segment (kernels/rglru_scan.py::segment_plan).
// Returns a cudaError_t (0 on success); -1 for a plan it does not take.
extern "C" int rglru_scan_launch(const float* a, const float* x,
                                 const float* h0, float* h, float* h_last,
                                 int B, int S, int D, int vec, int groups,
                                 int P, int seg, cudaStream_t stream) {
  if (B == 0 || D == 0) return 0;
  if ((vec != 1 && vec != 4) || groups * P != THREADS || seg < 1 ||
      seg > SEGMAX || (vec == 4 && D % 4 != 0))
    return -1;
  const int CT = groups * vec;
  dim3 grid((D + CT - 1) / CT, B);
  const size_t smem = (size_t(2) * P * CT + CT) * sizeof(float);
  if (smem > 48 * 1024) return -1;
  if (vec == 4)
    rglru_kernel<4><<<grid, THREADS, smem, stream>>>(a, x, h0, h, h_last, S,
                                                     D, groups, P, seg);
  else
    rglru_kernel<1><<<grid, THREADS, smem, stream>>>(a, x, h0, h, h_last, S,
                                                     D, groups, P, seg);
  return (int)cudaGetLastError();
}
