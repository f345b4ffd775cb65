// Shared building blocks of the two attention kernels
// (prefill_attention.cu, paged_attention.cu): one warp owns 16 query rows
// and folds a tile of NK keys into its online-softmax state with
// mma.sync m16n8k16 (bf16 in, f32 accumulate).
//
// Global tensors are bf16 or f32.  A bf16 tensor goes to the tensor
// cores as it is.  An f32 tensor is split into two bf16 halves,
// x = hi + lo with hi = bf16(x), and each product is taken as
// hi*hi + hi*lo + lo*hi: about 16 mantissa bits, enough to hold the f32
// plain version to ~1e-5 at the model's widths.  The f32 path exists for
// the checks; the model runs in bf16.
//
// Shared-memory tiles are row-major [key][HD + 8] bf16: the 8-element
// pad makes the 32-bit fragment loads and the ldmatrix row addresses
// fall on distinct banks.
#pragma once

#include <cuda_bf16.h>
#include <cstdint>

namespace attn {

using bf16 = __nv_bfloat16;

constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ uint32_t pack_bf16(float lo_elem, float hi_elem) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo_elem, hi_elem);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float bf16_residual(float x) {
  return x - __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += a * b for one m16n8k16 tile; a: 16x16 row-major, b: 16x8 col-major
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four transposed 8x8 bf16 matrices from shared memory; lane l gives the
// address of row (l % 8) of matrix (l / 8)
__device__ __forceinline__ void ldsm_x4_t(uint32_t& r0, uint32_t& r1,
                                          uint32_t& r2, uint32_t& r3,
                                          const bf16* p) {
  unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(a));
}

// 16-byte asynchronous global -> shared copy; ok == false fills zeros
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool ok) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = ok ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// How a global element type reaches the tensor cores.
template <typename T>
struct Elem;

template <>
struct Elem<bf16> {
  static constexpr bool SPLIT = false;
  // 8 elements (16 bytes) into the hi tile, asynchronously
  __device__ static void copy8(bf16* hi, bf16*, const bf16* src, bool ok) {
    cp_async16(hi, src, ok);
  }
  // 2 consecutive elements as one packed register
  __device__ static void pair(const bf16* src, bool ok, uint32_t& hi,
                              uint32_t& lo) {
    hi = ok ? *reinterpret_cast<const uint32_t*>(src) : 0u;
    lo = 0u;
  }
  __device__ static void store2(bf16* dst, float x, float y) {
    *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x, y);
  }
};

template <>
struct Elem<float> {
  static constexpr bool SPLIT = true;
  __device__ static void copy8(bf16* hi, bf16* lo, const float* src,
                               bool ok) {
    float x[8];
    if (ok) {
      float4 a = *reinterpret_cast<const float4*>(src);
      float4 b = *reinterpret_cast<const float4*>(src + 4);
      x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
      x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] = 0.f;
    }
    uint4 h, l;
    h.x = pack_bf16(x[0], x[1]); h.y = pack_bf16(x[2], x[3]);
    h.z = pack_bf16(x[4], x[5]); h.w = pack_bf16(x[6], x[7]);
    l.x = pack_bf16(bf16_residual(x[0]), bf16_residual(x[1]));
    l.y = pack_bf16(bf16_residual(x[2]), bf16_residual(x[3]));
    l.z = pack_bf16(bf16_residual(x[4]), bf16_residual(x[5]));
    l.w = pack_bf16(bf16_residual(x[6]), bf16_residual(x[7]));
    *reinterpret_cast<uint4*>(hi) = h;
    *reinterpret_cast<uint4*>(lo) = l;
  }
  __device__ static void pair(const float* src, bool ok, uint32_t& hi,
                              uint32_t& lo) {
    float x = 0.f, y = 0.f;
    if (ok) {
      float2 v = *reinterpret_cast<const float2*>(src);
      x = v.x;
      y = v.y;
    }
    hi = pack_bf16(x, y);
    lo = pack_bf16(bf16_residual(x), bf16_residual(y));
  }
  __device__ static void store2(float* dst, float x, float y) {
    *reinterpret_cast<float2*>(dst) = make_float2(x, y);
  }
};

// Per-thread online-softmax state of one warp's 16 rows.  Thread
// (g = lane / 4, c = lane % 4) holds rows g and g + 8 ("halves" 0 and 1)
// and, of each 8-wide output column tile nt, columns nt*8 + 2c and +1.
template <int HD>
struct RowState {
  float o[HD / 8][4];
  float m[2];
  float l[2];  // this thread's partial row sums; quad-reduced at the end

  __device__ void init() {
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
    m[0] = m[1] = NEG_INF;
    l[0] = l[1] = 0.f;
  }

  // full row sums in every thread of the quad
  __device__ void reduce_l() {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    }
  }
};

// Q rows of one warp as A fragments: qa[kt] covers head dims
// kt*16 .. kt*16+15.  row_ptr(h) is the address of the thread's row of
// half h (rows g, g+8), or nullptr for a padding row.
template <int HD, typename T>
__device__ __forceinline__ void load_q(const T* row0, const T* row1,
                                       uint32_t (&qa)[HD / 16][4],
                                       uint32_t (&ql)[HD / 16][4]) {
  const int c = threadIdx.x & 3;
#pragma unroll
  for (int kt = 0; kt < HD / 16; ++kt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      // a0: (row g, k 2c), a1: (row g+8, k 2c), a2: (row g, k 2c+8), a3
      const T* row = (e & 1) ? row1 : row0;
      const int col = kt * 16 + 2 * c + (e >> 1) * 8;
      Elem<T>::pair(row ? row + col : nullptr, row != nullptr, qa[kt][e],
                    ql[kt][e]);
    }
}

// Fold one tile of NK keys (shared memory, [NK][HD+8] bf16, hi and, for
// SPLIT, lo) into the warp's state.  mask(h, key) says whether the
// thread's row of half h sees key `key` (0 .. NK-1) of the tile.  Scores
// are scaled after the QK product; masked scores are NEG_INF, as in the
// TPU kernels.
template <int HD, int NK, bool SPLIT, class Mask>
__device__ __forceinline__ void tile_update(
    const uint32_t (&qa)[HD / 16][4], const uint32_t (&ql)[HD / 16][4],
    const bf16* Kh, const bf16* Kl, const bf16* Vh, const bf16* Vl,
    float scale, Mask mask, RowState<HD>& st) {
  constexpr int LD = HD + 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;

  float s[NK / 8][4];
#pragma unroll
  for (int nt = 0; nt < NK / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;

  // S = Q K^T: B fragment (k = head dim, n = key) is K[key][dim] read as
  // 32-bit pairs along the head dim
#pragma unroll
  for (int kt = 0; kt < HD / 16; ++kt)
#pragma unroll
    for (int nt = 0; nt < NK / 8; ++nt) {
      const int off = (nt * 8 + g) * LD + kt * 16 + 2 * c;
      const uint32_t b0 = lds32(Kh + off), b1 = lds32(Kh + off + 8);
      mma(s[nt], qa[kt], b0, b1);
      if constexpr (SPLIT) {
        mma(s[nt], qa[kt], lds32(Kl + off), lds32(Kl + off + 8));
        mma(s[nt], ql[kt], b0, b1);
      }
    }

  // scale, mask, running max (C fragment: e>>1 is the row half, column
  // nt*8 + 2c + (e&1))
  float mx[2] = {st.m[0], st.m[1]};
#pragma unroll
  for (int nt = 0; nt < NK / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[nt][e] * scale;
      if (!mask(e >> 1, nt * 8 + 2 * c + (e & 1))) x = NEG_INF;
      s[nt][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  float corr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    corr[h] = __expf(st.m[h] - mx[h]);
    st.m[h] = mx[h];
    st.l[h] *= corr[h];
  }
#pragma unroll
  for (int nt = 0; nt < NK / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = __expf(s[nt][e] - mx[e >> 1]);
      s[nt][e] = p;
      st.l[e >> 1] += p;
    }
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) st.o[nt][e] *= corr[e >> 1];

  // O += P V: the C fragments of key tiles 2kt and 2kt+1 are the A
  // fragment of k-step kt; V's B fragments come transposed by ldmatrix
#pragma unroll
  for (int kt = 0; kt < NK / 16; ++kt) {
    uint32_t a[4], al[4];
    a[0] = pack_bf16(s[2 * kt][0], s[2 * kt][1]);
    a[1] = pack_bf16(s[2 * kt][2], s[2 * kt][3]);
    a[2] = pack_bf16(s[2 * kt + 1][0], s[2 * kt + 1][1]);
    a[3] = pack_bf16(s[2 * kt + 1][2], s[2 * kt + 1][3]);
    if constexpr (SPLIT) {
      al[0] = pack_bf16(bf16_residual(s[2 * kt][0]),
                        bf16_residual(s[2 * kt][1]));
      al[1] = pack_bf16(bf16_residual(s[2 * kt][2]),
                        bf16_residual(s[2 * kt][3]));
      al[2] = pack_bf16(bf16_residual(s[2 * kt + 1][0]),
                        bf16_residual(s[2 * kt + 1][1]));
      al[3] = pack_bf16(bf16_residual(s[2 * kt + 1][2]),
                        bf16_residual(s[2 * kt + 1][3]));
    }
    const int vrow = kt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int n2 = 0; n2 < HD / 16; ++n2) {
      const int off = vrow * LD + n2 * 16 + (lane >> 4) * 8;
      uint32_t b0, b1, b2, b3;
      ldsm_x4_t(b0, b1, b2, b3, Vh + off);
      mma(st.o[2 * n2], a, b0, b1);
      mma(st.o[2 * n2 + 1], a, b2, b3);
      if constexpr (SPLIT) {
        uint32_t c0, c1, c2, c3;
        ldsm_x4_t(c0, c1, c2, c3, Vl + off);
        mma(st.o[2 * n2], a, c0, c1);
        mma(st.o[2 * n2 + 1], a, c2, c3);
        mma(st.o[2 * n2], al, b0, b1);
        mma(st.o[2 * n2 + 1], al, b2, b3);
      }
    }
  }
}

}  // namespace attn
