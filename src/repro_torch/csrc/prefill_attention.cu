// Chunked-prefill causal flash attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/prefill_attention.py::_kernel
// (wrapper flash_prefill).  The queries are only the chunk's new tokens,
// at absolute positions kv_offset[b] + i; the keys are the cached prefix
// plus the chunk.  GQA groups are folded into the rows: for one
// (batch, kv head) the Sq*G query rows are r = i*G + g, so a tile of 64
// rows holds whole and partial positions alike and G = 7 needs no
// padding inside a tile (only the last tile is ragged, and masked).
//
// Grid (row tiles, KV, B), 4 warps of 16 rows each.  The TPU grid's
// sequential KV dimension is a loop inside the block over 64-key tiles,
// double-buffered in shared memory (cp.async for bf16).  A key tile that
// no row of the block can reach (causally, or outside the window) is not
// visited: the loop runs from the tile holding the earliest key in the
// window of the block's first row to the block's last row's position.
// Masks are on absolute positions: kpos <= qpos, kpos < Sk and, with a
// window, qpos - kpos < window.
//
// Bound: at the engine's shapes (a 512-token chunk of Qwen2-7B over a
// 1-3k cached prefix) the causal QK and PV products are ~10-25 GFLOP per
// layer against ~10 MB of K/V, so the tensor cores bound it.  This first
// version uses mma.sync m16n8k16 (not wgmma/TMA): f32 accumulation and
// softmax in registers, P rounded to bf16 for the PV product.  Tiles run
// heaviest first (later rows see more keys).
//
// Head dim 256 (RecurrentGemma's local attention) takes 32-key tiles: a
// warp's 16 rows then hold 128 f32 output accumulators and 64 registers
// of Q fragments per lane (128 for the f32 split), and the f32 split's
// two 64-key buffers of K and V would need 270 KB of shared memory, above
// the 227 KB a block can have (135 KB at 32 keys).  ptxas -v: the bf16
// kernel uses 255 registers without spilling; the f32 one spills 796
// bytes (it runs only in the checks).
#include <cuda_runtime.h>

#include "attention_tile.cuh"

namespace {

using attn::bf16;
using attn::Elem;

constexpr int NW = 4;        // warps per block
constexpr int ROWS = 16 * NW;

// keys per tile
template <int HD>
__host__ __device__ constexpr int key_tile() {
  return HD > 128 ? 32 : 64;
}

template <int HD, typename T>
constexpr size_t smem_bytes() {
  // 2 buffers x (K, V) x (hi, lo for f32) x BK x (HD + 8)
  return size_t(2) * 2 * (Elem<T>::SPLIT ? 2 : 1) * key_tile<HD>() *
         (HD + 8) * sizeof(bf16);
}

template <int HD, typename T>
__global__ void __launch_bounds__(NW * 32)
    prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ kv_offset,
                   T* __restrict__ out, int Sq, int Sk, int H, int KV,
                   long long kv_bstride, int window, float scale) {
  constexpr bool SPLIT = Elem<T>::SPLIT;
  constexpr int BK = key_tile<HD>();
  constexpr int LD = HD + 8;
  constexpr int PLANE = BK * LD;                    // one [BK][LD] tile
  constexpr int NPL = SPLIT ? 2 : 1;                // hi (+ lo)
  constexpr int STAGE = 2 * NPL * PLANE;            // K and V of one buffer
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sm = reinterpret_cast<bf16*>(smem_raw);

  const int G = H / KV;
  const int R = Sq * G;
  const int n_tiles = (R + ROWS - 1) / ROWS;
  const int tile = n_tiles - 1 - blockIdx.x;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int r0 = tile * ROWS;
  const int off = kv_offset[b];

  int row[2], qpos[2];
  const T* qrow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = r0 + warp * 16 + g + 8 * h;
    qpos[h] = off + row[h] / G;
    qrow[h] = row[h] < R
                  ? q + ((long long)(b * Sq + row[h] / G) * H + kvh * G +
                         row[h] % G) * HD
                  : nullptr;
  }
  uint32_t qa[HD / 16][4], ql[HD / 16][4];
  attn::load_q<HD, T>(qrow[0], qrow[1], qa, ql);

  // keys this block can reach
  const int q_lo = off + r0 / G;
  const int q_hi = off + min(r0 + ROWS - 1, R - 1) / G;
  const int k_end = min(Sk, q_hi + 1);
  const int k_begin = window > 0 ? max(0, q_lo - window + 1) : 0;
  const int kb0 = k_begin / BK * BK;
  const int n_kb = k_end > kb0 ? (k_end - kb0 + BK - 1) / BK : 0;

  const T* kbase = k + b * kv_bstride;
  const T* vbase = v + b * kv_bstride;
  auto load_tile = [&](int kb, int buf) {
    bf16* st = sm + buf * STAGE;
    for (int idx = threadIdx.x; idx < 2 * BK * (HD / 8); idx += NW * 32) {
      const int which = idx / (BK * (HD / 8));      // 0: K, 1: V
      const int rem = idx % (BK * (HD / 8));
      const int key = rem / (HD / 8), ch = rem % (HD / 8);
      const bool ok = kb + key < Sk;
      const T* src = (which ? vbase : kbase) +
                     ((long long)(ok ? kb + key : 0) * KV + kvh) * HD +
                     ch * 8;
      bf16* hi = st + which * NPL * PLANE + key * LD + ch * 8;
      Elem<T>::copy8(hi, hi + PLANE, src, ok);
    }
  };

  attn::RowState<HD> state;
  state.init();
  if (n_kb > 0) {
    load_tile(kb0, 0);
    attn::cp_async_commit();
  }
  for (int t = 0; t < n_kb; ++t) {
    const int kb = kb0 + t * BK;
    if (t + 1 < n_kb) {
      load_tile(kb + BK, (t + 1) & 1);
      attn::cp_async_commit();
      attn::cp_async_wait<1>();
    } else {
      attn::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* st = sm + (t & 1) * STAGE;
    auto mask = [&](int h, int key) {
      const int kpos = kb + key;
      return kpos <= qpos[h] && kpos < Sk &&
             (window <= 0 || qpos[h] - kpos < window);
    };
    attn::tile_update<HD, BK, SPLIT>(qa, ql, st, st + PLANE,
                                     st + NPL * PLANE,
                                     st + NPL * PLANE + PLANE, scale, mask,
                                     state);
    __syncthreads();
  }

  state.reduce_l();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] >= R) continue;
    const float inv = 1.f / fmaxf(state.l[h], 1e-30f);
    T* dst = out + ((long long)(b * Sq + row[h] / G) * H + kvh * G +
                    row[h] % G) * HD + 2 * c;
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt)
      Elem<T>::store2(dst + nt * 8, state.o[nt][2 * h] * inv,
                      state.o[nt][2 * h + 1] * inv);
  }
}

template <int HD, typename T>
int launch(const void* q, const void* k, const void* v, const int* kv_offset,
           void* out, int B, int Sq, int Sk, int H, int KV,
           long long kv_bstride, int window, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<HD, T>();
  cudaError_t err = cudaFuncSetAttribute(
      prefill_kernel<HD, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int R = Sq * (H / KV);
  dim3 grid((R + ROWS - 1) / ROWS, KV, B);
  prefill_kernel<HD, T><<<grid, NW * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_offset, static_cast<T*>(out), Sq, Sk, H,
      KV, kv_bstride, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  q/out: contiguous (B, Sq, H, hd);
// k/v: (B, Sk, KV, hd) with the last three dims contiguous and batch
// stride kv_bstride (elements).  window <= 0: no window.  Returns a
// cudaError_t (0 on success); -1 for an unsupported dtype or head dim.
extern "C" int prefill_attention_launch(int dtype, int hd, const void* q,
                                        const void* k, const void* v,
                                        const int* kv_offset, void* out,
                                        int B, int Sq, int Sk, int H, int KV,
                                        long long kv_bstride, int window,
                                        float scale, cudaStream_t stream) {
  if (B == 0 || Sq == 0) return 0;
  if (dtype == 1 && hd == 256)
    return launch<256, bf16>(q, k, v, kv_offset, out, B, Sq, Sk, H, KV,
                             kv_bstride, window, scale, stream);
  if (dtype == 0 && hd == 256)
    return launch<256, float>(q, k, v, kv_offset, out, B, Sq, Sk, H, KV,
                              kv_bstride, window, scale, stream);
  if (dtype == 1 && hd == 128)
    return launch<128, bf16>(q, k, v, kv_offset, out, B, Sq, Sk, H, KV,
                             kv_bstride, window, scale, stream);
  if (dtype == 1 && hd == 64)
    return launch<64, bf16>(q, k, v, kv_offset, out, B, Sq, Sk, H, KV,
                            kv_bstride, window, scale, stream);
  if (dtype == 0 && hd == 128)
    return launch<128, float>(q, k, v, kv_offset, out, B, Sq, Sk, H, KV,
                              kv_bstride, window, scale, stream);
  if (dtype == 0 && hd == 64)
    return launch<64, float>(q, k, v, kv_offset, out, B, Sq, Sk, H, KV,
                             kv_bstride, window, scale, stream);
  return -1;
}
