// Chunked-prefill causal flash attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/prefill_attention.py::_kernel
// (wrapper flash_prefill).  The queries are only the chunk's new tokens,
// at absolute positions kv_offset[b] + i; the keys are the cached prefix
// plus the chunk.  GQA groups are folded into the rows: for one
// (batch, kv head) the Sq*G query rows are r = i*G + g, so a tile of 64
// rows holds whole and partial positions alike and G = 7 needs no
// padding inside a tile (only the last tile is ragged, and masked).
// Masks are on absolute positions: kpos <= qpos, kpos < Sk and, with a
// window, qpos - kpos < window.  A key tile that no row of the block can
// reach (causally, or outside the window) is not visited: the loop runs
// from the tile holding the earliest key in the window of the block's
// first row to the block's last row's position.  Row tiles run heaviest
// first (later rows see more keys).
//
// Bound: at the engine's shapes (a 512-token chunk over a 1-3k cached
// prefix) the causal QK and PV products are ~10-25 GFLOP per layer
// against ~10 MB of K/V, so the tensor cores bound it, and Hopper reaches
// their rate only through wgmma.
//
// bf16 (the serving path): prefill_wgmma, FlashAttention-3 style.  One
// block is one consumer warpgroup (warps 0-3, 64 folded rows) and one
// producer warp (warp 4).  The producer's lane 0 keeps 64-key K and V
// tiles in flight by TMA (4-D tensor maps over (hd, KV, Sk, B), so a
// batch-strided cache slice needs no copy; rows past Sk arrive as zeros)
// in a ring of 2 stages with a full and an empty mbarrier per stage.  The
// consumers load Q once with plain 16-byte loads into the same swizzled
// layout (64 folded rows are not a rectangular box when G = 7), then per
// key tile: S = Q K^T by wgmma m64n64k16 from shared memory (both
// K-major), mask and online softmax in registers (exp2 of log2e-scaled
// scores), P rounded to bf16 in registers as the A operand of O += P V by
// wgmma m64n{hd}k16 with V from shared memory as stored ([key][hd],
// MN-major: the transpose bit), then release the stage.  Starting the next
// tile's S before this tile's softmax (FlashAttention-3's intra-warpgroup
// overlap, with a second S and P in registers and K and V in rings of
// their own) measured slower on the H100 (41.5 against 33.8 us at hd 128,
// 56.1 against 40.5 at hd 256), so the loop stays sequential within the
// warpgroup; two blocks per SM at hd 128 overlap each other's softmax
// and products.
// Tiles are 128-byte-swizzled boxes of 64 columns (2 or 4 per row at hd
// 128 or 256), the layout the TMA writes and the wgmma descriptors read.
// The output accumulator is hd/2 f32 registers per thread (128 at hd
// 256); no setmaxnreg is needed with 160 threads per block.  Blocks are
// plain, not persistent: 224 blocks of 64 rows at Qwen2-7B's chunk (two
// fit on an SM at hd 128), 128 at RecurrentGemma-9B's (one per SM at hd
// 256, whose 160 KB of shared memory leave room for no second).
// The tensor maps are encoded on the host for each call by libcuda's
// cuTensorMapEncodeTiled, found with dlopen/dlsym in the libcuda.so.1
// that the process has loaded (no link flag), and passed as
// __grid_constant__ parameters.
//
// float32 (the checks only): prefill_kernel, the first version kept as it
// was, selected by dtype.  mma.sync m16n8k16 with each f32 operand split
// into bf16 hi + lo (attention_tile.cuh), 4 warps of 16 rows,
// double-buffered cp.async tiles of 64 keys (32 at head dim 256, where
// two 64-key split buffers would need 270 KB of shared memory).  ptxas
// -v: it spills 796 bytes at head dim 256.
#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#include "attention_tile.cuh"
#include "hopper.cuh"

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
                   long long kv_bstride, int window, float scale,
                   float cap) {
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
                                     st + NPL * PLANE + PLANE, scale, cap,
                                     mask, state);
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
           long long kv_bstride, int window, float scale, float cap,
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
      KV, kv_bstride, window, scale, cap);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: warp-specialised wgmma + TMA
// ---------------------------------------------------------------------------

namespace wg {

constexpr int BM = 64;          // folded query rows per block
constexpr int BK = 64;          // keys per tile
constexpr int NST = 2;          // stages of the K/V ring
constexpr int CONSUMERS = 128;  // one warpgroup
constexpr int THREADS = CONSUMERS + 32;

template <int HD>
struct Layout {
  static constexpr int BOXES = HD / 64;          // 64-column SW128 boxes
  static constexpr int Q_BYTES = BM * HD * 2;
  static constexpr int KV_BYTES = BK * HD * 2;   // K or V of one stage
  static constexpr int STAGE = 2 * KV_BYTES;
  static constexpr int BARS = Q_BYTES + NST * STAGE;
  // + the barriers (full and empty per stage), + slack to align the base
  // to 1024 bytes
  static constexpr int SMEM = BARS + 2 * NST * 8 + 1024;
};

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// O += P V over one 16-key step: the N = HD product
template <int HD>
__device__ __forceinline__ void pv_step(float (&o)[HD / 2],
                                        const uint32_t (&a)[4], uint64_t b) {
  if constexpr (HD == 64)
    hopper::wgmma_rs_n64_t(o, a, b);
  else if constexpr (HD == 128)
    hopper::wgmma_rs_n128_t(o, a, b);
  else
    hopper::wgmma_rs_n256_t(o, a, b);
}

template <int HD>
__global__ void __launch_bounds__(THREADS, HD <= 128 ? 2 : 1)
    prefill_wgmma(const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap,
                  const bf16* __restrict__ q,
                  const int* __restrict__ kv_offset, bf16* __restrict__ out,
                  int Sq, int Sk, int H, int KV, int window,
                  float scale_log2, float cap_log2) {
  using L = Layout<HD>;
  extern __shared__ __align__(128) unsigned char wg_smem[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(wg_smem) + 1023) & ~uintptr_t(1023));
  const uint32_t s_q = hopper::smem_u32(sm);
  const uint32_t s_kv = s_q + L::Q_BYTES;
  // mbarriers of each stage: full (the TMA's bytes have landed) and
  // empty (the consumers are done with it)
  const uint32_t s_bar = s_q + L::BARS;
  auto full = [&](int s) { return s_bar + 8 * s; };
  auto empty = [&](int s) { return s_bar + 8 * (NST + s); };

  const int G = H / KV;
  const int R = Sq * G;
  const int n_tiles = (R + BM - 1) / BM;
  const int tile = n_tiles - 1 - blockIdx.x;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int r0 = tile * BM;
  const int off = kv_offset[b];

  // keys this block can reach
  const int q_lo = off + r0 / G;
  const int q_hi = off + min(r0 + BM - 1, R - 1) / G;
  const int k_end = min(Sk, q_hi + 1);
  const int k_begin = window > 0 ? max(0, q_lo - window + 1) : 0;
  const int kb0 = k_begin / BK * BK;
  const int n_kb = k_end > kb0 ? (k_end - kb0 + BK - 1) / BK : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NST; ++s) {
      hopper::mbar_init(full(s), 1);
      hopper::mbar_init(empty(s), CONSUMERS);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // ---- producer: lane 0 of warp 4 ----
    if (threadIdx.x == CONSUMERS) {
      for (int t = 0; t < n_kb; ++t) {
        const int s = t % NST;
        const uint32_t ks = s_kv + s * L::STAGE, vs = ks + L::KV_BYTES;
        const int kb = kb0 + t * BK;
        hopper::mbar_wait(empty(s), ((t / NST) & 1) ^ 1);
        hopper::mbar_expect_tx(full(s), L::STAGE);
#pragma unroll
        for (int j = 0; j < L::BOXES; ++j) {
          hopper::tma_load_4d(ks + j * BK * 128, &kmap, full(s), j * 64, kvh,
                              kb, b);
          hopper::tma_load_4d(vs + j * BK * 128, &vmap, full(s), j * 64, kvh,
                              kb, b);
        }
      }
    }
    return;
  }

  // ---- consumers: one warpgroup, 64 folded rows ----
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;

  // Q into the SW128 layout (box j holds columns 64j .. 64j+63)
  for (int idx = tid; idx < BM * (HD / 8); idx += CONSUMERS) {
    const int r = idx / (HD / 8), ch = idx % (HD / 8);
    const int row = r0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < R)
      val = *reinterpret_cast<const uint4*>(
          q + ((long long)(b * Sq + row / G) * H + kvh * G + row % G) * HD +
          ch * 8);
    *reinterpret_cast<uint4*>(sm + (ch >> 3) * BM * 128 + r * 128 +
                              (((ch & 7) ^ (r & 7)) << 4)) = val;
  }
  hopper::fence_proxy_async();
  hopper::named_bar_sync(1, CONSUMERS);

  int row[2], qpos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = r0 + warp * 16 + g + 8 * h;
    qpos[h] = off + row[h] / G;
  }
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m[2] = {attn::NEG_INF, attn::NEG_INF}, l[2] = {0.f, 0.f};

  // S = Q K_t^T into s, started (not committed, not awaited): k-step kk
  // reads 16 columns of box kk/4 (32 bytes into each swizzled 128-byte
  // row)
  auto start_qk = [&](int t, float (&s)[BK / 2]) {
    const uint32_t ks = s_kv + (t % NST) * L::STAGE;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t inbox = (kk & 3) * 32;
      hopper::wgmma_ss_n64(
          s,
          hopper::sw128_desc(s_q + (kk >> 2) * BM * 128 + inbox, 16, 1024),
          hopper::sw128_desc(ks + (kk >> 2) * BK * 128 + inbox, 16, 1024),
          kk > 0);
    }
  };
  // O += P V_t, started: the S accumulators of keys 16kt .. 16kt+15 are
  // the A fragment of k-step kt; V's descriptor steps 16 rows (2048
  // bytes), its 64-column boxes lie BK*128 bytes apart (leading offset)
  // and its 8-row groups 1024 bytes apart (stride offset)
  auto start_pv = [&](int t, const uint32_t (&p)[BK / 16][4]) {
    const uint32_t vs = s_kv + (t % NST) * L::STAGE + L::KV_BYTES;
#pragma unroll
    for (int kt = 0; kt < BK / 16; ++kt)
      pv_step<HD>(o, p[kt],
                  hopper::sw128_desc(vs + kt * 16 * 128, BK * 128, 1024));
  };
  // mask (only where some row of the tile may not see some key), scale
  // into the log2 domain, online softmax: s becomes P, l and m advance,
  // corr is what O must be scaled by before P V_t is added
  auto softmax = [&](int t, float (&s)[BK / 2], float (&corr)[2]) {
    const int kb = kb0 + t * BK;
    const bool whole = kb + BK - 1 <= q_lo && kb + BK <= Sk &&
                       (window <= 0 || q_hi - kb < window);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int h = (i >> 1) & 1;
      float x = s[i] * scale_log2;
      // soft cap in the log2 domain: cap_log2 = cap * log2(e)
      if (cap_log2 > 0.f) x = cap_log2 * tanhf(x / cap_log2);
      if (!whole) {
        const int kpos = kb + 8 * (i >> 2) + 2 * c + (i & 1);
        if (!(kpos <= qpos[h] && kpos < Sk &&
              (window <= 0 || qpos[h] - kpos < window)))
          x = attn::NEG_INF;
      }
      s[i] = x;
      mx[h] = fmaxf(mx[h], x);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      corr[h] = exp2_approx(m[h] - mx[h]);
      m[h] = mx[h];
      l[h] *= corr[h];
    }
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int h = (i >> 1) & 1;
      const float p = exp2_approx(s[i] - mx[h]);
      s[i] = p;
      l[h] += p;
    }
  };
  auto pack = [&](const float (&s)[BK / 2], uint32_t (&p)[BK / 16][4]) {
#pragma unroll
    for (int kt = 0; kt < BK / 16; ++kt) {
      p[kt][0] = attn::pack_bf16(s[8 * kt + 0], s[8 * kt + 1]);
      p[kt][1] = attn::pack_bf16(s[8 * kt + 2], s[8 * kt + 3]);
      p[kt][2] = attn::pack_bf16(s[8 * kt + 4], s[8 * kt + 5]);
      p[kt][3] = attn::pack_bf16(s[8 * kt + 6], s[8 * kt + 7]);
    }
  };
  auto rescale = [&](const float (&corr)[2]) {
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] *= corr[(i >> 1) & 1];
  };

  float sc[BK / 2];
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
  float corr[2];
  uint32_t pf[BK / 16][4];
  auto phase = [](int t) { return uint32_t((t / NST) & 1); };
  for (int t = 0; t < n_kb; ++t) {
    hopper::mbar_wait(full(t % NST), phase(t));
    hopper::wgmma_fence();
    start_qk(t, sc);
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_regs(sc);
    softmax(t, sc, corr);
    rescale(corr);
    pack(sc, pf);
    hopper::wgmma_fence();
    start_pv(t, pf);
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_regs(o);
    hopper::mbar_arrive(empty(t % NST));
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] >= R) continue;
    const float inv = 1.f / fmaxf(l[h], 1e-30f);
    bf16* dst = out + ((long long)(b * Sq + row[h] / G) * H + kvh * G +
                       row[h] % G) * HD + 2 * c;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      Elem<bf16>::store2(dst + 8 * j, o[4 * j + 2 * h] * inv,
                         o[4 * j + 2 * h + 1] * inv);
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

// (hd, KV, Sk, B) bf16 with strides (hd, KV*hd, bstride) elements; boxes
// of 64 columns x 1 head x BK keys x 1 sequence, 128-byte swizzle; rows
// past Sk read as zeros
int encode_kv(EncodeTiled enc, CUtensorMap* map, const void* base, int hd,
              int KV, int Sk, int B, long long bstride) {
  cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)KV, (cuuint64_t)Sk,
                        (cuuint64_t)B};
  cuuint64_t strides[3] = {(cuuint64_t)hd * 2, (cuuint64_t)KV * hd * 2,
                           (cuuint64_t)bstride * 2};
  cuuint32_t box[4] = {64, 1, BK, 1};
  cuuint32_t es[4] = {1, 1, 1, 1};
  CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                   const_cast<void*>(base), dims, strides, box, es,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -3;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const int* kv_offset,
           void* out, int B, int Sq, int Sk, int H, int KV,
           long long kv_bstride, int window, float scale, float cap,
           cudaStream_t stream) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return -2;
  CUtensorMap kmap, vmap;
  int rc = encode_kv(enc, &kmap, k, HD, KV, Sk, B, kv_bstride);
  if (rc == 0) rc = encode_kv(enc, &vmap, v, HD, KV, Sk, B, kv_bstride);
  if (rc != 0) return rc;
  auto kernel = prefill_wgmma<HD>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Layout<HD>::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const int R = Sq * (H / KV);
  dim3 grid((R + BM - 1) / BM, KV, B);
  kernel<<<grid, THREADS, Layout<HD>::SMEM, stream>>>(
      kmap, vmap, static_cast<const bf16*>(q), kv_offset,
      static_cast<bf16*>(out), Sq, Sk, H, KV, window,
      scale * 1.4426950408889634f, cap * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace wg

}  // namespace

// dtype: 0 float32, 1 bfloat16.  q/out: contiguous (B, Sq, H, hd);
// k/v: (B, Sk, KV, hd) with the last three dims contiguous and batch
// stride kv_bstride (elements; for bf16 a multiple of 8, and 16-byte
// aligned k/v: the TMA's rule).  window <= 0: no window.  soft_cap > 0:
// scores become soft_cap * tanh(score / soft_cap) before the mask and
// the softmax; 0: none.  Returns a
// cudaError_t (0 on success); -1 for an unsupported dtype or head dim, -2
// if libcuda's cuTensorMapEncodeTiled cannot be found, -3 if it refuses
// the tensor map.
extern "C" int prefill_attention_launch(int dtype, int hd, const void* q,
                                        const void* k, const void* v,
                                        const int* kv_offset, void* out,
                                        int B, int Sq, int Sk, int H, int KV,
                                        long long kv_bstride, int window,
                                        float scale, float soft_cap,
                                        cudaStream_t stream) {
  if (B == 0 || Sq == 0) return 0;
  if (dtype == 1 && hd == 256)
    return wg::launch<256>(q, k, v, kv_offset, out, B, Sq, Sk, H, KV,
                           kv_bstride, window, scale, soft_cap, stream);
  if (dtype == 0 && hd == 256)
    return launch<256, float>(q, k, v, kv_offset, out, B, Sq, Sk, H, KV,
                              kv_bstride, window, scale, soft_cap, stream);
  if (dtype == 1 && hd == 128)
    return wg::launch<128>(q, k, v, kv_offset, out, B, Sq, Sk, H, KV,
                           kv_bstride, window, scale, soft_cap, stream);
  if (dtype == 1 && hd == 64)
    return wg::launch<64>(q, k, v, kv_offset, out, B, Sq, Sk, H, KV,
                          kv_bstride, window, scale, soft_cap, stream);
  if (dtype == 0 && hd == 128)
    return launch<128, float>(q, k, v, kv_offset, out, B, Sq, Sk, H, KV,
                              kv_bstride, window, scale, soft_cap, stream);
  if (dtype == 0 && hd == 64)
    return launch<64, float>(q, k, v, kv_offset, out, B, Sq, Sk, H, KV,
                             kv_bstride, window, scale, soft_cap, stream);
  return -1;
}
