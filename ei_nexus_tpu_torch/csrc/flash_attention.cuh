// Flash-style row-softmax attention core of the float32 instances of
// q-blocked attention (kernel E, csrc/qblock_attention.cu) and
// segment-masked flash attention (kernel G, csrc/flash_segment.cu), on the
// CUDA cores; no path of configs/ runs them in float32 (the comparisons
// and the card tests do). The float32 instances of A, B, D and F run the
// 3xTF32 tensor-core pieces of flash_tf32.cuh, and the bfloat16 instances
// of all six the TMA + wgmma loop of flash_sm90.cuh.
//
// One block computes ROWS query rows of one (batch, head) problem. The
// query tile stays on chip; key/value tiles of BK rows stream through
// shared memory; the softmax is online in float32 (running row max m and
// row sum l, the output rescaled by exp(m_old - m_new) per tile), so the
// (N, M) similarity never reaches device memory. 256 threads in a 16x16
// grid, each owning a 4x4 sub-tile of S and of O, on the CUDA cores, 64
// query rows at a time (ROWS = 128 runs two row groups in turn). It
// rounds where the bf16 loop does, through the storage type T: rotated
// q/k and the probabilities P in T, S and O in float32.
//
// Masks: a float32 key-side bias row added after the scale (D, E),
// or, with SEG (G), jax's TPU flash-attention rule: -0.7 * FLT_MAX added
// after the scale wherever the query's int32 segment id differs from the
// key's. Keys past the end of the problem get -inf either way.
//
// Inputs are read through element strides, so strided views (the (B, N, h,
// hd, 3) split of SelfBlock's Wqkv output, the (B, N, h, d) head split of
// CrossBlock's projections) need no copy; the output is written through
// strides as well.
#pragma once

#include <float.h>
#include <stdint.h>

#include "common.cuh"

namespace ei {

constexpr int kHD = 64;        // head dim (the only one compiled)
constexpr int kBQ = 64;        // query rows per row group
constexpr int kBK = 64;        // keys per streamed tile
constexpr int kThreads = 256;  // 16 x 16, each a 4 x 4 sub-tile
constexpr int kPad = 68;       // padded row length of V and P tiles (floats)

// Shared memory: Q^T and K^T tiles (d-major), V and P tiles (row-major,
// padded so that the float4 row accesses of 8 neighbouring threads hit
// distinct banks).
constexpr int kSmemFloats = kHD * kBQ + kHD * kBK + kBK * kPad + kBQ * kPad;

// Query rows, threads and dynamic shared memory of one block (storage
// type T), ROWS covered in row groups of kBQ.
template <typename T, int ROWS = kBQ> struct Tiles {
  static_assert(ROWS % kBQ == 0, "rows come in groups of kBQ");
  static constexpr int rows = ROWS;
  static constexpr int threads = kThreads;
  static constexpr size_t smem = kSmemFloats * sizeof(float);
};

struct Operand {
  const void* ptr;
  long long sb, sh, sn, sd;  // element strides of (B, h, N, d)
};

struct Output {
  void* ptr;
  long long sb, sh, sn, sd;
};

struct Problem {
  Operand q, k, v;
  const void* cos;     // (B, N, kHD) rotary tables, head-shared (ROT only)
  const void* sin;
  const float* bias;   // (B, nk) additive key-side bias (0 or -1e9)
  Output o;
  int nq, nk;
  float scale;         // applied to the float32 product, before the bias
  int heads = 0;
  const int* q_seg = nullptr;   // SEG only: (B, nq) and (B, nk) int32
  const int* kv_seg = nullptr;  // segment ids, contiguous
};

// The scaled score of query row `n` against key `c` with its mask: the
// key-side bias, or with SEG the segment rule; -inf past the last key.
// No FMA contraction, so the rounding is that of the plain versions.
template <bool SEG>
__device__ __forceinline__ float masked_score(const Problem& p, int b,
                                              int q_id, int c, float s) {
  if (c >= p.nk) return -INFINITY;
  const long long kc = (long long)b * p.nk + c;
  const float add = SEG ? (q_id == p.kv_seg[kc] ? 0.f : kMaskValue)
                        : p.bias[kc];
  return __fadd_rn(__fmul_rn(s, p.scale), add);
}

// A query row's segment id (SEG only; 0 past the last row, never read).
template <bool SEG>
__device__ __forceinline__ int query_segment(const Problem& p, int b, int n) {
  return SEG && n < p.nq ? p.q_seg[(long long)b * p.nq + n] : 0;
}

// exp(m_old - m_new), 0 while m_old is still -inf (the first tile), as jax's
// flash kernel's alpha; and 1/l with 1 for an empty row (its l_inv_safe).
__device__ __forceinline__ float rescale(float m_old, float m_new) {
  return m_old == -INFINITY ? 0.f : expf(m_old - m_new);
}
__device__ __forceinline__ float inv_safe(float l) {
  return l == 0.f ? 1.f : 1.f / l;
}

// Four consecutive d lanes [d0, d0 + 4) of row n of operand `a`, as
// floats; zeros past n_rows. With ROT the rotary encoding
// t*cos + rotate_half(t)*sin is applied, each product and the sum rounded
// through T as the plain PyTorch version rounds them; rotate_half pairs
// adjacent lanes: out[2m] = -t[2m+1], out[2m+1] = t[2m].
template <typename T, bool ROT>
__device__ __forceinline__ void fetch4(const Problem& p, const Operand& a,
                                       int b, int h, int n, int n_rows,
                                       int d0, float (&t)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) t[j] = 0.f;
  if (n >= n_rows) return;
  const T* row = static_cast<const T*>(a.ptr) + b * a.sb + h * a.sh
                 + n * a.sn;
#pragma unroll
  for (int j = 0; j < 4; ++j) t[j] = to_f(row[(d0 + j) * a.sd]);
  if (ROT) {
    const long long off = ((long long)b * n_rows + n) * kHD + d0;
    const T* c = static_cast<const T*>(p.cos) + off;
    const T* s = static_cast<const T*>(p.sin) + off;
    const float rh[4] = {-t[1], t[0], -t[3], t[2]};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      t[j] = round_t<T>(round_t<T>(t[j] * to_f(c[j])) +
                        round_t<T>(rh[j] * to_f(s[j])));
  }
}

// float32 instance: rows [r0, r0 + rows) into shared memory, transposed
// (d-major, row length ld) or row-major. Consecutive threads take
// consecutive rows, so the transposed stores are conflict-free.
template <typename T, bool ROT, bool TRANSPOSED>
__device__ __forceinline__ void load_tile(const Problem& p, const Operand& a,
                                          int b, int h, int r0, int n_rows,
                                          int rows, float* dst, int ld) {
  for (int e = threadIdx.x; e < rows * (kHD / 4); e += kThreads) {
    const int r = e % rows;
    const int d0 = (e / rows) * 4;
    float t[4];
    fetch4<T, ROT>(p, a, b, h, r0 + r, n_rows, d0, t);
    if (TRANSPOSED) {
#pragma unroll
      for (int j = 0; j < 4; ++j) dst[(d0 + j) * ld + r] = t[j];
    } else {
      *reinterpret_cast<float4*>(&dst[r * ld + d0]) =
          make_float4(t[0], t[1], t[2], t[3]);
    }
  }
}

template <typename T, bool ROT, bool SEG>
__device__ void flash_block_fma(const Problem& p, int b, int h, int q0,
                                float* smem) {
  float* Qs = smem;             // [kHD][kBQ]
  float* Ks = Qs + kHD * kBQ;   // [kHD][kBK]
  float* Vs = Ks + kHD * kBK;   // [kBK][kPad]
  float* Ps = Vs + kBK * kPad;  // [kBQ][kPad]
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  load_tile<T, ROT, true>(p, p.q, b, h, q0, p.nq, kBQ, Qs, kBQ);

  float m[4], l[4], o[4][4];
  int qs[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
    qs[i] = query_segment<SEG>(p, b, q0 + ty * 4 + i);
#pragma unroll
    for (int j = 0; j < 4; ++j) o[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < p.nk; k0 += kBK) {
    __syncthreads();  // the previous tile's K, V and P are consumed
    load_tile<T, ROT, true>(p, p.k, b, h, k0, p.nk, kBK, Ks, kBK);
    load_tile<T, false, false>(p, p.v, b, h, k0, p.nk, kBK, Vs, kPad);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < kHD; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&Qs[d * kBQ + ty * 4]);
      const float4 c = *reinterpret_cast<const float4*>(&Ks[d * kBK + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        s[i][j] = masked_score<SEG>(p, b, qs[i], k0 + tx * 4 + j, s[i][j]);

    // online softmax; a row's 64 columns live in the 16 lanes of one
    // half-warp, so shuffles over lane offsets 8..1 reduce a row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = rescale(m[i], m_new);
      float pe[4], rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        pe[j] = expf(s[i][j] - m_new);
        rs += pe[j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j) o[i][j] *= alpha;
      // P enters the PV product in the value type, as in the TPU kernel
      *reinterpret_cast<float4*>(&Ps[(ty * 4 + i) * kPad + tx * 4]) =
          make_float4(round_t<T>(pe[0]), round_t<T>(pe[1]),
                      round_t<T>(pe[2]), round_t<T>(pe[3]));
    }
    __syncthreads();

#pragma unroll 2
    for (int c = 0; c < kBK; c += 4) {
      float pv[4][4], vv[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 t =
            *reinterpret_cast<const float4*>(&Ps[(ty * 4 + i) * kPad + c]);
        pv[i][0] = t.x; pv[i][1] = t.y; pv[i][2] = t.z; pv[i][3] = t.w;
      }
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float4 t =
            *reinterpret_cast<const float4*>(&Vs[(c + cc) * kPad + tx * 4]);
        vv[cc][0] = t.x; vv[cc][1] = t.y; vv[cc][2] = t.z; vv[cc][3] = t.w;
      }
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            o[i][j] = fmaf(pv[i][cc], vv[cc][j], o[i][j]);
    }
  }

  T* out = static_cast<T*>(p.o.ptr) + b * p.o.sb + h * p.o.sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = q0 + ty * 4 + i;
    if (n >= p.nq) continue;
    const float inv = inv_safe(l[i]);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[n * p.o.sn + (tx * 4 + j) * p.o.sd] = from_f<T>(o[i][j] * inv);
  }
}

// The flash loop of storage type T over query rows [q0, q0 + ROWS); `smem`
// is the block's dynamic shared memory (Tiles<T, ROWS>::smem bytes), the
// block Tiles<T, ROWS>::threads wide. SEG selects the segment-id mask.
template <typename T, bool ROT, int ROWS = kBQ, bool SEG = false>
__device__ __forceinline__ void flash_block(const Problem& p, int b, int h,
                                            int q0, void* smem) {
#pragma unroll 1
  for (int r = 0; r < ROWS; r += kBQ) {
    if (r > 0) __syncthreads();  // the previous group's tiles are consumed
    flash_block_fma<T, ROT, SEG>(p, b, h, q0 + r, static_cast<float*>(smem));
  }
}

// Fill an Operand / Output from a stride array laid out (b, h, n, d).
inline Operand make_operand(const void* ptr, const long long* st) {
  return Operand{ptr, st[0], st[1], st[2], st[3]};
}
inline Output make_output(void* ptr, const long long* st) {
  return Output{ptr, st[0], st[1], st[2], st[3]};
}

}  // namespace ei
