// Single-token GQA decode attention over a block-table-paged KV cache,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py::_kernel
// (wrapper paged_attention).  On the TPU the block table drives the K/V
// BlockSpec index maps and the grid's sequential page dimension carries
// the online softmax.  Here the context of each (batch b, kv head, 16
// query rows of the group) is split across `splits` blocks (split-K):
// grid (splits, row tiles x KV, B).
//
// Bound: the K/V bytes of the context (G = 7 or 16 rows reuse each key),
// so HBM bandwidth bounds it, and the design is about keeping all 132 SMs
// streaming: one block per (sequence, kv head) gave 8 blocks at
// RecurrentGemma-9B's decode (B = 8, KV = 1) and 32 at Qwen2-7B's.  The
// wrapper picks `splits` from the table's capacity (pages_per_seq *
// page: the largest context, known without reading context_lens), the
// SM count and a minimum of MIN_TILES 16-key tiles per split, aiming at
// about two blocks per SM: 32 splits x 8 = 256 blocks at hd 256, 8 x 32 =
// 256 at hd 128.  Each block divides its own sequence's context evenly: with
// n_t = ceil(ctx / 16) tiles, split s takes tiles [s*per, (s+1)*per),
// per = max(MIN_TILES, ceil(n_t / splits)), so split boundaries fall on
// 16-key tiles (the page boundaries at the engine's page of 16) and the
// blocks of a shorter context carry fewer keys, not fewer blocks.  Any
// page size works: a tile gathers its keys through the block table.
//
// Inside a block, as in the first version: 4 warps take the split's
// tiles in turn (warp w takes w, w+4, ...), each gathering its tile's
// keys into its own shared-memory slice with cp.async (double-buffered;
// one buffer at hd 256, where a split's warps get one tile each and two
// buffers would halve the blocks an SM holds), folding it into a private
// online-softmax state with mma.sync m16n8k16 (bytes, not tensor-core
// rate, bound it; the 16-row group tile suits mma.sync).  The warps'
// states are merged through shared memory in warp order, each warp
// merging a quarter of the columns.  Loads stay cp.async, not TMA: with
// two blocks per SM, 4 warps x one or two 8-16 KB tiles each keep
// 64-128 KB in flight per SM, above HBM's rate x latency (~25 KB per SM
// at 3.35 TB/s and ~1 us), and the gather stays per key, through the
// block table, with the +8 row pad of attention_tile.cuh.
//
// Across blocks: each block writes its partial (m, l, o) in f32 (o not
// normalised; rows past G are not written) to a scratch the wrapper
// allocates, then __threadfence() and one atomicAdd on a counter.  The
// splits are merged in groups of MERGE_GROUP = 8: the block that
// completes its group's counter merges the group's partials in split
// order, O = sum_s o_s e^{m_s - M}, L = sum_s l_s e^{m_s - M}.  With one
// group that is the output, O / max(L, 1e-30); with more (32 splits at
// hd 256), it writes the group's partial, and the block that completes
// the groups' counter merges those in group order.  The second level
// shortens the serial tail: one block reading all 32 partials (512 KB at
// hd 256) took longer than 8 blocks reading 8 each, then one reading 4.
// The block completing a counter resets it to 0 (the wrapper zeroes the
// counters once).  One launch, no float atomics: the same bits run to
// run.  A split with no keys writes m = -1e30, l = 0 and no o; a merge
// gives it weight 0 and selects its (unwritten) o away, so a zero context
// gives 0 (the TPU kernel's l clamp at 1e-30).  With splits = 1 the block
// writes its output directly.
//
// Register use: ptxas -v prints it for every instantiation (chip_smoke.py
// phase 1): the bf16 kernel at head dim 256 uses 245 registers without
// spilling (the first version 254); the f32 one, for the checks only,
// spills 228 bytes (the first version 284).
#include <cuda_runtime.h>

#include "attention_tile.cuh"

namespace {

using attn::bf16;
using attn::Elem;

constexpr int NK = 16;          // keys per tile
constexpr int NW = 4;           // warps per block
constexpr int MIN_TILES = 4;    // tiles per split, at least (one per warp)
constexpr int MAX_SPLITS = 64;  // the merge keeps per-split weights in smem
constexpr int MERGE_GROUP = 8;  // splits merged by the last block of a group
// per (b, kv head, row tile): one counter per group, one for the groups
constexpr int COUNTERS_PER_TILE = 16;
static_assert(MAX_SPLITS / MERGE_GROUP < COUNTERS_PER_TILE, "counters");

// tile buffers per warp: two (loads overlap the previous tile's math);
// one at head dim 256
template <int HD>
__host__ __device__ constexpr int n_buf() {
  return HD > 128 ? 1 : 2;
}

template <int HD, typename T>
constexpr size_t tile_bytes() {
  // NW warps x buffers x (K, V) x (hi, lo for f32) x NK x (HD + 8)
  return size_t(NW) * n_buf<HD>() * 2 * (Elem<T>::SPLIT ? 2 : 1) * NK *
         (HD + 8) * sizeof(bf16);
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

// floats of one split's partial: o[16][HD], m[16], l[16]
template <int HD>
__host__ __device__ constexpr int part_floats() {
  return 16 * (HD + 2);
}

template <int HD, typename T>
__global__ void __launch_bounds__(NW * 32)
    paged_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                 const T* __restrict__ v_pages,
                 const int* __restrict__ block_tables,
                 const int* __restrict__ context_lens, T* __restrict__ out,
                 float* __restrict__ part, int* __restrict__ counters,
                 int H, int KV, int page, int pages_per_seq, float scale,
                 float cap, int splits) {
  constexpr bool SPLIT = Elem<T>::SPLIT;
  constexpr int LD = HD + 8;
  constexpr int PLANE = NK * LD;
  constexpr int NPL = SPLIT ? 2 : 1;
  constexpr int STAGE = 2 * NPL * PLANE;           // K and V of one buffer
  constexpr int NBUF = n_buf<HD>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sm = reinterpret_cast<bf16*>(smem_raw);

  const int G = H / KV;
  const int split = blockIdx.x;
  const int kvh = blockIdx.y % KV, rt = blockIdx.y / KV, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;

  int grow[2];          // row within the group, or >= G for padding
  const T* qrow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    grow[h] = rt * 16 + g + 8 * h;
    qrow[h] = grow[h] < G
                  ? q + ((long long)b * H + kvh * G + grow[h]) * HD
                  : nullptr;
  }
  // this split's tiles of the context
  const int ctx = max(0, min(context_lens[b], pages_per_seq * page));
  const int n_ctx = (ctx + NK - 1) / NK;
  const int per = max(MIN_TILES, (n_ctx + splits - 1) / splits);
  const int t_begin = min(n_ctx, split * per);
  const int t_end = min(n_ctx, t_begin + per);

  uint32_t qa[HD / 16][4], ql[HD / 16][4];
  if (t_begin < t_end) attn::load_q<HD, T>(qrow[0], qrow[1], qa, ql);
  const int* table = block_tables + (long long)b * pages_per_seq;
  bf16* mine = sm + warp * NBUF * STAGE;

  // a tile's 16 keys through the block table: each lane copies 8
  // elements of a K row and the same 8 of its V row
  auto load_tile = [&](int t, int buf) {
    bf16* st = mine + buf * STAGE;
#pragma unroll
    for (int idx = lane; idx < NK * (HD / 8); idx += 32) {
      const int key = idx / (HD / 8), ch = idx % (HD / 8);
      const int kk = t * NK + key;
      const bool ok = kk < ctx;
      const long long slot =
          ok ? (long long)table[kk / page] * page + kk % page : 0;
      const long long off = (slot * KV + kvh) * HD + ch * 8;
      bf16* hi = st + key * LD + ch * 8;
      Elem<T>::copy8(hi, hi + PLANE, k_pages + off, ok);
      Elem<T>::copy8(hi + NPL * PLANE, hi + NPL * PLANE + PLANE,
                     v_pages + off, ok);
    }
  };

  attn::RowState<HD> state;
  state.init();
  const int t0 = t_begin + warp;
  if (NBUF == 2 && t0 < t_end) {
    load_tile(t0, 0);
    attn::cp_async_commit();
  }
  for (int i = 0, t = t0; t < t_end; ++i, t += NW) {
    if (NBUF == 1) {
      load_tile(t, 0);
      attn::cp_async_commit();
      attn::cp_async_wait<0>();
    } else if (t + NW < t_end) {
      load_tile(t + NW, (i + 1) & 1);
      attn::cp_async_commit();
      attn::cp_async_wait<1>();
    } else {
      attn::cp_async_wait<0>();
    }
    __syncwarp();
    const bf16* st = mine + (NBUF == 1 ? 0 : (i & 1)) * STAGE;
    auto mask = [&](int, int key) { return t * NK + key < ctx; };
    attn::tile_update<HD, NK, SPLIT>(qa, ql, st, st + PLANE,
                                     st + NPL * PLANE,
                                     st + NPL * PLANE + PLANE, scale, cap,
                                     mask, state);
    __syncwarp();
  }
  state.reduce_l();

  // merge the warps' states in warp order, O = sum_w o_w e^{m_w - M},
  // L = sum_w l_w e^{m_w - M}: warp w merges output columns
  // [w * HD/4, (w+1) * HD/4)
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem_raw);
  constexpr int PER = 4 + HD / 2;        // floats per (warp, lane)
  constexpr int NT_W = HD / 8 / NW;      // 8-column tiles a warp merges
  {
    float* mine_red = red + (warp * 32 + lane) * PER;
    mine_red[0] = state.m[0];
    mine_red[1] = state.m[1];
    mine_red[2] = state.l[0];
    mine_red[3] = state.l[1];
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt)
      *reinterpret_cast<float4*>(mine_red + 4 + nt * 4) = make_float4(
          state.o[nt][0], state.o[nt][1], state.o[nt][2], state.o[nt][3]);
  }
  __syncthreads();
  float M[2] = {attn::NEG_INF, attn::NEG_INF};
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    const float* r = red + (w * 32 + lane) * PER;
    M[0] = fmaxf(M[0], r[0]);
    M[1] = fmaxf(M[1], r[1]);
  }
  float L[2] = {0.f, 0.f};
  float O[NT_W][4];
#pragma unroll
  for (int j = 0; j < NT_W; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) O[j][e] = 0.f;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    const float* r = red + (w * 32 + lane) * PER;
    const float f0 = __expf(r[0] - M[0]), f1 = __expf(r[1] - M[1]);
    L[0] += r[2] * f0;
    L[1] += r[3] * f1;
#pragma unroll
    for (int j = 0; j < NT_W; ++j) {
      const float4 v =
          *reinterpret_cast<const float4*>(r + 4 + (warp * NT_W + j) * 4);
      O[j][0] += v.x * f0;
      O[j][1] += v.y * f0;
      O[j][2] += v.z * f1;
      O[j][3] += v.w * f1;
    }
  }
  const int col0 = warp * NT_W * 8 + 2 * c;   // this lane's first column
  if (splits == 1) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (grow[h] >= G) continue;
      const float inv = 1.f / fmaxf(L[h], 1e-30f);
      T* dst = out + ((long long)b * H + kvh * G + grow[h]) * HD + col0;
#pragma unroll
      for (int j = 0; j < NT_W; ++j)
        Elem<T>::store2(dst + j * 8, O[j][2 * h] * inv,
                        O[j][2 * h + 1] * inv);
    }
    return;
  }

  // this split's partial: rows of the group only, o only if it has keys
  const int tile_id = (b * KV + kvh) * (gridDim.y / KV) + rt;
  {
    float* p = part + ((long long)tile_id * splits + split) *
                          part_floats<HD>();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = g + 8 * h;
      if (grow[h] >= G) continue;
      if (warp == 0 && c == 0) {
        p[16 * HD + r] = M[h];
        p[16 * HD + 16 + r] = L[h];
      }
      if (t_begin < t_end) {
#pragma unroll
        for (int j = 0; j < NT_W; ++j)
          *reinterpret_cast<float2*>(p + r * HD + col0 + j * 8) =
              make_float2(O[j][2 * h], O[j][2 * h + 1]);
      }
    }
  }
  __threadfence();
  __syncthreads();

  // Merge n partials at src (in order) into the output rows of this tile,
  // or, with dst, into one partial at dst.  Thread t takes row t % 16 of
  // partials t/16, t/16 + 8, ... for the maxima and weights (the 8 partial
  // sums of l are added in a fixed order), then HD/32 items of 4 columns
  // over every partial, so that many loads are in flight.  A keyless
  // partial's o may never have been written: it is selected away, not
  // multiplied by its weight 0.
  const int rows = min(16, G - rt * 16);
  auto merge = [&](const float* src, int n, float* dst) {
    float* wgt = red;                      // [MAX_SPLITS][16] weights
    float* red_m = wgt + MAX_SPLITS * 16;  // [8][16]
    float* red_l = red_m + 8 * 16;         // [8][16]
    float* row_m = red_l + 8 * 16;         // [16]
    float* inv_l = row_m + 16;             // [16]
    const int mr = threadIdx.x & 15, ms = threadIdx.x >> 4;
    const float* ml = src + 16 * HD;       // m at [s][r], l at [s][16 + r]
    float mx = attn::NEG_INF;
    if (mr < rows)
      for (int s = ms; s < n; s += 8)
        mx = fmaxf(mx, __ldcg(ml + s * part_floats<HD>() + mr));
    red_m[ms * 16 + mr] = mx;
    __syncthreads();
    if (threadIdx.x < 16) {
      float m = attn::NEG_INF;
#pragma unroll
      for (int i = 0; i < 8; ++i) m = fmaxf(m, red_m[i * 16 + threadIdx.x]);
      row_m[threadIdx.x] = m;
    }
    __syncthreads();
    float lsum = 0.f;
    if (mr < rows) {
      const float m = row_m[mr];
      for (int s = ms; s < n; s += 8) {
        const float* q = ml + s * part_floats<HD>();
        const float l = __ldcg(q + 16 + mr);
        const float w = l > 0.f ? __expf(__ldcg(q + mr) - m) : 0.f;
        wgt[s * 16 + mr] = w;
        lsum += l * w;
      }
    }
    red_l[ms * 16 + mr] = lsum;
    __syncthreads();
    if (threadIdx.x < 16) {
      float l = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) l += red_l[i * 16 + threadIdx.x];
      inv_l[threadIdx.x] = l;
      if (dst && threadIdx.x < rows) {
        dst[16 * HD + threadIdx.x] = row_m[threadIdx.x];
        dst[16 * HD + 16 + threadIdx.x] = l;
      }
    }
    __syncthreads();
    constexpr int IPT = HD / 32;
    const int items = rows * HD / 4;
    for (int base = threadIdx.x; base < items; base += NW * 32 * IPT) {
      float4 acc[IPT];
      int ir[IPT], id[IPT];
#pragma unroll
      for (int j = 0; j < IPT; ++j) {
        const int idx = min(base + j * NW * 32, items - 1);
        ir[j] = idx / (HD / 4);
        id[j] = (idx % (HD / 4)) * 4;
        acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll 4
      for (int s = 0; s < n; ++s) {
        const float* ps = src + s * part_floats<HD>();
#pragma unroll
        for (int j = 0; j < IPT; ++j) {
          const float w = wgt[s * 16 + ir[j]];
          const float4 o = __ldcg(
              reinterpret_cast<const float4*>(ps + ir[j] * HD + id[j]));
          acc[j].x += w != 0.f ? o.x * w : 0.f;
          acc[j].y += w != 0.f ? o.y * w : 0.f;
          acc[j].z += w != 0.f ? o.z * w : 0.f;
          acc[j].w += w != 0.f ? o.w * w : 0.f;
        }
      }
#pragma unroll
      for (int j = 0; j < IPT; ++j) {
        if (base + j * NW * 32 >= items) continue;
        if (dst) {
          *reinterpret_cast<float4*>(dst + ir[j] * HD + id[j]) = acc[j];
          continue;
        }
        const float inv = 1.f / fmaxf(inv_l[ir[j]], 1e-30f);
        T* o = out + ((long long)b * H + kvh * G + rt * 16 + ir[j]) * HD +
               id[j];
        Elem<T>::store2(o, acc[j].x * inv, acc[j].y * inv);
        Elem<T>::store2(o + 2, acc[j].z * inv, acc[j].w * inv);
      }
    }
  };
  // count this block in; true in the block that completes `*counter`
  // at `n` (it resets the counter for the next launch)
  __shared__ int last;
  auto arrive = [&](int* counter, int n) {
    if (threadIdx.x == 0) {
      last = atomicAdd(counter, 1) == n - 1;
      if (last) *counter = 0;
    }
    __syncthreads();
    const bool mine = last;
    if (mine) __threadfence();
    return mine;
  };

  // the last block of each group of MERGE_GROUP splits merges the group
  // (in split order); with more than one group, the last of those merges
  // the groups' partials (in group order), which the wrapper's scratch
  // holds after the splits' partials
  int* cnt = counters + tile_id * COUNTERS_PER_TILE;
  const int n_groups = (splits + MERGE_GROUP - 1) / MERGE_GROUP;
  const int grp = split / MERGE_GROUP;
  const int g_lo = grp * MERGE_GROUP;
  if (!arrive(cnt + grp, min(MERGE_GROUP, splits - g_lo))) return;
  const float* p0 = part + (long long)tile_id * splits * part_floats<HD>();
  if (n_groups == 1) {
    merge(p0, splits, nullptr);
    return;
  }
  float* gp = part + ((long long)gridDim.y * gridDim.z * splits +
                      (long long)tile_id * n_groups) * part_floats<HD>();
  merge(p0 + g_lo * part_floats<HD>(), min(MERGE_GROUP, splits - g_lo),
        gp + grp * part_floats<HD>());
  __threadfence();
  __syncthreads();
  if (!arrive(cnt + COUNTERS_PER_TILE - 1, n_groups)) return;
  merge(gp, n_groups, nullptr);
}

template <int HD, typename T>
int launch(const void* q, const void* kp, const void* vp, const int* bt,
           const int* ctx, void* out, float* part, int* counters, int B,
           int H, int KV, int page, int pages_per_seq, float scale,
           float cap, int splits, cudaStream_t stream) {
  const size_t smem = smem_bytes<HD, T>();
  cudaError_t err = cudaFuncSetAttribute(
      paged_kernel<HD, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int G = H / KV;
  dim3 grid(splits, (G + 15) / 16 * KV, B);
  paged_kernel<HD, T><<<grid, NW * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), bt, ctx, static_cast<T*>(out), part,
      counters, H, KV, page, pages_per_seq, scale, cap, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  q/out: contiguous (B, H, hd);
// k_pages/v_pages: contiguous (n_pages, page, KV, hd); block_tables:
// contiguous (B, pages_per_seq) int32; context_lens: (B,) int32.
// splits: blocks per (sequence, kv head, 16-row tile), 1 .. 64; with
// splits > 1, part holds tiles * (splits + ceil(splits / 8)) * 16 *
// (hd + 2) floats of scratch (tiles = B * KV * ceil(G/16)) and counters
// tiles * 16 ints, zero before the first launch (each launch leaves them
// zero); launches that share them must be ordered on one stream.
// soft_cap > 0: scores become soft_cap * tanh(score / soft_cap) before
// the softmax; 0: none.  Returns a cudaError_t (0 on
// success); -1 for an unsupported dtype, head dim or split count.
extern "C" int paged_attention_launch(int dtype, int hd, const void* q,
                                      const void* k_pages,
                                      const void* v_pages,
                                      const int* block_tables,
                                      const int* context_lens, void* out,
                                      float* part, int* counters, int B,
                                      int H, int KV, int page,
                                      int pages_per_seq, float scale,
                                      float soft_cap, int splits,
                                      cudaStream_t stream) {
  if (B == 0) return 0;
  if (splits < 1 || splits > MAX_SPLITS) return -1;
#define PAGED_LAUNCH(HD, T)                                                  \
  return launch<HD, T>(q, k_pages, v_pages, block_tables, context_lens, out, \
                       part, counters, B, H, KV, page, pages_per_seq, scale, \
                       soft_cap, splits, stream)
  if (dtype == 1 && hd == 256) PAGED_LAUNCH(256, bf16);
  if (dtype == 1 && hd == 128) PAGED_LAUNCH(128, bf16);
  if (dtype == 1 && hd == 64) PAGED_LAUNCH(64, bf16);
  if (dtype == 0 && hd == 256) PAGED_LAUNCH(256, float);
  if (dtype == 0 && hd == 128) PAGED_LAUNCH(128, float);
  if (dtype == 0 && hd == 64) PAGED_LAUNCH(64, float);
#undef PAGED_LAUNCH
  return -1;
}
