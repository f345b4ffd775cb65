// Single-token GQA decode attention over a block-table-paged KV cache,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py::_kernel
// (wrapper paged_attention).  On the TPU the block table drives the K/V
// BlockSpec index maps and the grid's sequential page dimension carries
// the online softmax.  Here one block owns (batch b, kv head, 16 query
// rows of the group) and loads its own block-table entries: its 4 warps
// split the context into 16-key tiles (warp w takes tiles w, w+4, ...),
// each warp gathering its tile's keys from their pages into its own
// double-buffered shared-memory slice with cp.async, and folding it into
// a private online-softmax state with mma.sync m16n8k16.  The warps'
// states are merged through shared memory at the end (max, rescaled sums).
// Key tiles are independent of the page size, so any page size works;
// only keys below context_lens[b] are visited, which is the TPU kernel's
// page skip.  With context_lens[b] == 0 no key is visited and the output
// is 0, as the TPU kernel's is.
//
// Bound: the K/V bytes of the context (G = 7 rows reuse each key), so
// HBM bandwidth bounds it.  This first version runs B x KV x ceil(G/16)
// blocks (32 at the engine's B = 8, Qwen2-7B), one per SM; splitting the
// context across blocks (split-K) is the next step.
#include <cuda_runtime.h>

#include "attention_tile.cuh"

namespace {

using attn::bf16;
using attn::Elem;

constexpr int NK = 16;   // keys per tile
constexpr int NW = 4;    // warps per block

template <int HD, typename T>
constexpr size_t tile_bytes() {
  // NW warps x 2 buffers x (K, V) x (hi, lo for f32) x NK x (HD + 8)
  return size_t(NW) * 2 * 2 * (Elem<T>::SPLIT ? 2 : 1) * NK * (HD + 8) *
         sizeof(bf16);
}

template <int HD>
constexpr size_t merge_bytes() {
  // per warp and lane: m[2], l[2], o[HD/8][4]
  return size_t(NW) * 32 * (4 + HD / 2) * sizeof(float);
}

template <int HD, typename T>
constexpr size_t smem_bytes() {
  return tile_bytes<HD, T>() > merge_bytes<HD>() ? tile_bytes<HD, T>()
                                                 : merge_bytes<HD>();
}

template <int HD, typename T>
__global__ void __launch_bounds__(NW * 32)
    paged_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                 const T* __restrict__ v_pages,
                 const int* __restrict__ block_tables,
                 const int* __restrict__ context_lens, T* __restrict__ out,
                 int H, int KV, int page, int pages_per_seq, float scale) {
  constexpr bool SPLIT = Elem<T>::SPLIT;
  constexpr int LD = HD + 8;
  constexpr int PLANE = NK * LD;
  constexpr int NPL = SPLIT ? 2 : 1;
  constexpr int STAGE = 2 * NPL * PLANE;           // K and V of one buffer
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sm = reinterpret_cast<bf16*>(smem_raw);

  const int G = H / KV;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;

  int grow[2];          // row within the group, or >= G for padding
  const T* qrow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    grow[h] = blockIdx.x * 16 + g + 8 * h;
    qrow[h] = grow[h] < G
                  ? q + ((long long)b * H + kvh * G + grow[h]) * HD
                  : nullptr;
  }
  uint32_t qa[HD / 16][4], ql[HD / 16][4];
  attn::load_q<HD, T>(qrow[0], qrow[1], qa, ql);

  const int ctx = max(0, min(context_lens[b], pages_per_seq * page));
  const int n_t = (ctx + NK - 1) / NK;
  const int* table = block_tables + (long long)b * pages_per_seq;
  bf16* mine = sm + warp * 2 * STAGE;

  auto load_tile = [&](int t, int buf) {
    bf16* st = mine + buf * STAGE;
#pragma unroll
    for (int idx = lane; idx < 2 * NK * (HD / 8); idx += 32) {
      const int which = idx / (NK * (HD / 8));
      const int rem = idx % (NK * (HD / 8));
      const int key = rem / (HD / 8), ch = rem % (HD / 8);
      const int kk = t * NK + key;
      const bool ok = kk < ctx;
      const long long slot =
          ok ? (long long)table[kk / page] * page + kk % page : 0;
      const T* src = (which ? v_pages : k_pages) + (slot * KV + kvh) * HD +
                     ch * 8;
      bf16* hi = st + which * NPL * PLANE + key * LD + ch * 8;
      Elem<T>::copy8(hi, hi + PLANE, src, ok);
    }
  };

  attn::RowState<HD> state;
  state.init();
  if (warp < n_t) {
    load_tile(warp, 0);
    attn::cp_async_commit();
  }
  for (int i = 0, t = warp; t < n_t; ++i, t += NW) {
    if (t + NW < n_t) {
      load_tile(t + NW, (i + 1) & 1);
      attn::cp_async_commit();
      attn::cp_async_wait<1>();
    } else {
      attn::cp_async_wait<0>();
    }
    __syncwarp();
    const bf16* st = mine + (i & 1) * STAGE;
    auto mask = [&](int, int key) { return t * NK + key < ctx; };
    attn::tile_update<HD, NK, SPLIT>(qa, ql, st, st + PLANE,
                                     st + NPL * PLANE,
                                     st + NPL * PLANE + PLANE, scale, mask,
                                     state);
    __syncwarp();
  }
  state.reduce_l();

  // merge the warps' states: O = sum_w o_w e^{m_w - M} / sum_w l_w e^{m_w - M}
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem_raw);
  constexpr int PER = 4 + HD / 2;        // floats per (warp, lane)
  float* mine_red = red + (warp * 32 + lane) * PER;
  mine_red[0] = state.m[0];
  mine_red[1] = state.m[1];
  mine_red[2] = state.l[0];
  mine_red[3] = state.l[1];
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) mine_red[4 + nt * 4 + e] = state.o[nt][e];
  __syncthreads();
  if (warp != 0) return;

  float M[2] = {attn::NEG_INF, attn::NEG_INF};
  for (int w = 0; w < NW; ++w) {
    const float* r = red + (w * 32 + lane) * PER;
    M[0] = fmaxf(M[0], r[0]);
    M[1] = fmaxf(M[1], r[1]);
  }
  float L[2] = {0.f, 0.f};
  float O[HD / 8][4];
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) O[nt][e] = 0.f;
  for (int w = 0; w < NW; ++w) {
    const float* r = red + (w * 32 + lane) * PER;
    const float f0 = __expf(r[0] - M[0]), f1 = __expf(r[1] - M[1]);
    L[0] += r[2] * f0;
    L[1] += r[3] * f1;
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        O[nt][e] += r[4 + nt * 4 + e] * ((e >> 1) ? f1 : f0);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (grow[h] >= G) continue;
    const float inv = 1.f / fmaxf(L[h], 1e-30f);
    T* dst = out + ((long long)b * H + kvh * G + grow[h]) * HD + 2 * c;
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt)
      Elem<T>::store2(dst + nt * 8, O[nt][2 * h] * inv,
                      O[nt][2 * h + 1] * inv);
  }
}

template <int HD, typename T>
int launch(const void* q, const void* kp, const void* vp, const int* bt,
           const int* ctx, void* out, int B, int H, int KV, int page,
           int pages_per_seq, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<HD, T>();
  cudaError_t err = cudaFuncSetAttribute(
      paged_kernel<HD, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int G = H / KV;
  dim3 grid((G + 15) / 16, KV, B);
  paged_kernel<HD, T><<<grid, NW * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), bt, ctx, static_cast<T*>(out), H, KV, page,
      pages_per_seq, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  q/out: contiguous (B, H, hd);
// k_pages/v_pages: contiguous (n_pages, page, KV, hd); block_tables:
// contiguous (B, pages_per_seq) int32; context_lens: (B,) int32.
// Returns a cudaError_t (0 on success); -1 for an unsupported dtype or
// head dim.
extern "C" int paged_attention_launch(int dtype, int hd, const void* q,
                                      const void* k_pages,
                                      const void* v_pages,
                                      const int* block_tables,
                                      const int* context_lens, void* out,
                                      int B, int H, int KV, int page,
                                      int pages_per_seq, float scale,
                                      cudaStream_t stream) {
  if (B == 0) return 0;
  if (dtype == 1 && hd == 128)
    return launch<128, bf16>(q, k_pages, v_pages, block_tables,
                             context_lens, out, B, H, KV, page,
                             pages_per_seq, scale, stream);
  if (dtype == 1 && hd == 64)
    return launch<64, bf16>(q, k_pages, v_pages, block_tables, context_lens,
                            out, B, H, KV, page, pages_per_seq, scale,
                            stream);
  if (dtype == 0 && hd == 128)
    return launch<128, float>(q, k_pages, v_pages, block_tables,
                              context_lens, out, B, H, KV, page,
                              pages_per_seq, scale, stream);
  if (dtype == 0 && hd == 64)
    return launch<64, float>(q, k_pages, v_pages, block_tables,
                             context_lens, out, B, H, KV, page,
                             pages_per_seq, scale, stream);
  return -1;
}
