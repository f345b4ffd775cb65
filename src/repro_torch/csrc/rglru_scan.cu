// RG-LRU linear recurrence h_t = a_t * h_{t-1} + x_t for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rglru_scan.py::_kernel
// (wrapper rglru_scan).  On the TPU the grid is (B, channel blocks,
// sequence blocks) with the sequence innermost and the f32 carry in VMEM
// scratch between grid steps.  Here one thread owns one (batch, channel)
// and loops over the whole sequence with the carry in a register, so
// nothing carries between blocks; neighbouring threads hold neighbouring
// channels, so every load and store of a step is coalesced.  The loop
// reads UNROLL steps of a and x ahead of the dependent multiply-adds to
// keep loads in flight.  Bounds checks stand in for the TPU wrapper's
// padding (a = 1, x = 0): h_last is h at the true last position for any
// S and D.
//
// Bound: bytes.  Each call reads a and x and writes h (3 x B*S*D f32) and
// does 2 operations per element; a 512-token chunk at D = 4096 is 25.2 MB,
// 7.5 us at 3.35 TB/s.  This first version runs B*D threads (4096 at the
// engine's B = 1, on 16 of 132 SMs) and is bound by the latency of the
// sequential loop; splitting the sequence across blocks (a two-pass scan
// of (prod a, h) pairs) is the next step.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int UNROLL = 16;

__global__ void __launch_bounds__(THREADS)
    rglru_kernel(const float* __restrict__ a, const float* __restrict__ x,
                 const float* __restrict__ h0, float* __restrict__ h,
                 float* __restrict__ h_last, int B, int S, int D) {
  const int d = blockIdx.x * THREADS + threadIdx.x;
  const int b = blockIdx.y;
  if (d >= D) return;
  const long long base = (long long)b * S * D + d;
  float carry = h0[(long long)b * D + d];
  int t = 0;
  for (; t + UNROLL <= S; t += UNROLL) {
    float av[UNROLL], xv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      av[u] = a[base + (long long)(t + u) * D];
      xv[u] = x[base + (long long)(t + u) * D];
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      carry = av[u] * carry + xv[u];
      h[base + (long long)(t + u) * D] = carry;
    }
  }
  for (; t < S; ++t) {
    carry = a[base + (long long)t * D] * carry + x[base + (long long)t * D];
    h[base + (long long)t * D] = carry;
  }
  h_last[(long long)b * D + d] = carry;
}

}  // namespace

// a, x, h: contiguous (B, S, D) float32; h0, h_last: contiguous (B, D)
// float32.  Returns a cudaError_t (0 on success).
extern "C" int rglru_scan_launch(const float* a, const float* x,
                                 const float* h0, float* h, float* h_last,
                                 int B, int S, int D, cudaStream_t stream) {
  if (B == 0 || D == 0) return 0;
  dim3 grid((D + THREADS - 1) / THREADS, B);
  rglru_kernel<<<grid, THREADS, 0, stream>>>(a, x, h0, h, h_last, B, S, D);
  return (int)cudaGetLastError();
}
