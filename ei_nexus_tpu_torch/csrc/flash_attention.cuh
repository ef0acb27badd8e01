// Flash-style row-softmax attention core shared by the self-attention
// (kernel A, csrc/self_attention.cu), bidirectional cross-attention
// (kernel B, csrc/cross_attention.cu), differentiable attention forward
// (kernel D, csrc/attention_fwd.cu), q-blocked attention (kernel E,
// csrc/qblock_attention.cu) and segment-masked flash attention (kernel G,
// csrc/flash_segment.cu) kernels; the backward (kernel F,
// csrc/attention_bwd.cu) reuses its tensor-core fragments.
//
// One block computes ROWS query rows of one (batch, head) problem. The
// query tile stays on chip; key/value tiles of BK rows stream through
// shared memory; the softmax is online in float32 (running row max m and
// row sum l, the output rescaled by exp(m_old - m_new) per tile), so the
// (N, M) similarity never reaches device memory. Two instances:
//  - bfloat16 (the main path): ROWS query rows per block (128 unless the
//    kernel asks for another multiple of 16), one warp per 16 rows,
//    multiplying on the tensor cores with mma.sync m16n8k16 (bf16
//    operands from shared memory, V's fragments through ldmatrix.trans,
//    float32 accumulators); the probabilities go from the S accumulators
//    straight into the A operand of the PV product;
//  - float32 (tests and the comparison phases): 256 threads in a 16x16
//    grid, each owning a 4x4 sub-tile of S and of O, on the CUDA cores,
//    64 query rows at a time (ROWS = 128 runs two row groups in turn).
// Both round at the same points: rotated q/k and the probabilities P in
// the storage type, S and O in float32.
//
// Masks: a float32 key-side bias row added after the scale (A, B, D, E),
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

#include <type_traits>

#include "common.cuh"

namespace ei {

constexpr int kHD = 64;        // head dim (the only one compiled)
constexpr int kBQ = 64;        // float32: query rows per row group
constexpr int kBK = 64;        // keys per streamed tile
constexpr int kThreads = 256;  // float32: 16 x 16, each a 4 x 4 sub-tile
constexpr int kPad = 68;       // padded row length of V and P tiles (floats)
constexpr int kMmaRows = 128;     // bfloat16: default query rows per block,
constexpr int kMmaThreads = 256;  // 8 warps x 16 rows
constexpr int kLd = 72;        // padded bf16 row: 36 words, so the 32-bit
                               // fragment loads of a warp hit 32 banks and
                               // ldmatrix's 8 row reads hit 8 bank groups
// jax's TPU flash attention's DEFAULT_MASK_VALUE, rounded to float32 as a
// Python float is: finite, so a fully masked row stays finite (uniform)
constexpr float kMaskValue = -0.7 * (double)FLT_MAX;

// Shared memory: Q^T and K^T tiles (d-major), V and P tiles (row-major,
// padded so that the float4 row accesses of 8 neighbouring threads hit
// distinct banks).
constexpr int kSmemFloats = kHD * kBQ + kHD * kBK + kBK * kPad + kBQ * kPad;

// Query rows of one block by storage type, unless a kernel asks for more.
template <typename T> constexpr int kDefaultRows = kBQ;
template <> constexpr int kDefaultRows<__nv_bfloat16> = kMmaRows;

// Query rows, threads and dynamic shared memory of one block, by storage
// type and row count. The float32 instance covers ROWS in row groups of
// kBQ; the bfloat16 instance keeps its Q, K and V tiles row-major in bf16
// and runs one warp per 16 rows.
template <typename T, int ROWS = kDefaultRows<T>> struct Tiles {
  static_assert(ROWS % kBQ == 0, "float32 rows come in groups of kBQ");
  static constexpr int rows = ROWS;
  static constexpr int threads = kThreads;
  static constexpr size_t smem = kSmemFloats * sizeof(float);
};
template <int ROWS> struct Tiles<__nv_bfloat16, ROWS> {
  static_assert(ROWS % 16 == 0 && ROWS <= 128, "16 rows a warp, 8 warps");
  static constexpr int rows = ROWS;
  static constexpr int threads = 2 * ROWS;
  static constexpr size_t smem =
      (ROWS + 2 * kBK) * kLd * sizeof(__nv_bfloat16);
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
  float* lse = nullptr;  // optional (B, heads, nq) float32 row log-sum-exp
                         // m + log(l) of the scaled, biased scores
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

// Two consecutive bf16 of shared memory as one 32-bit register, the lower
// index in the low half.
__device__ __forceinline__ uint32_t lds_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Round two floats to bf16 (nearest even) and pack them, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// B fragments of two 8x8 bf16 matrices stored row-major (rows = k) at
// rows row0..row0+15 of `tile`, columns col..col+7, transposed on the way
// (ldmatrix .trans): b0 holds (k 2t..2t+1, n g), b1 (k 8+2t.., n g).
__device__ __forceinline__ void ldsm_x2_trans(const __nv_bfloat16* tile,
                                              int row0, int col,
                                              uint32_t& b0, uint32_t& b1) {
  const int lane = threadIdx.x % 32;
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(
      tile + (row0 + (lane % 16)) * kLd + col));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(b0), "=r"(b1)
      : "r"(addr));
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

// bfloat16 instance: rows [r0, r0 + rows) into row-major bf16 shared
// memory (row length kLd), by a block of THREADS threads. Consecutive
// threads take consecutive d lanes of a row, so a warp reads two rows'
// worth of neighbouring addresses.
template <bool ROT, int THREADS = kMmaThreads>
__device__ __forceinline__ void load_rows_bf16(const Problem& p,
                                               const Operand& a, int b,
                                               int h, int r0, int n_rows,
                                               int rows, __nv_bfloat16* dst) {
  for (int e = threadIdx.x; e < rows * (kHD / 4); e += THREADS) {
    const int r = e / (kHD / 4);
    const int d0 = (e % (kHD / 4)) * 4;
    float t[4];
    fetch4<__nv_bfloat16, ROT>(p, a, b, h, r0 + r, n_rows, d0, t);
    const uint2 packed = make_uint2(pack_bf16(t[0], t[1]),
                                    pack_bf16(t[2], t[3]));
    *reinterpret_cast<uint2*>(&dst[r * kLd + d0]) = packed;
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
    if (p.lse != nullptr && tx == 0)
      p.lse[((long long)b * p.heads + h) * p.nq + n] = m[i] + logf(l[i]);
    const float inv = inv_safe(l[i]);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[n * p.o.sn + (tx * 4 + j) * p.o.sd] = from_f<T>(o[i][j] * inv);
  }
}

// D += A B on the tensor cores: A 16x16 bf16 (row), B 16x8 bf16 (col),
// D 16x8 float32. Fragments as in the PTX ISA for m16n8k16 (g = lane / 4,
// t = lane % 4): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
// a3 (g+8, 2t+8..); b0 (k 2t..2t+1, n g), b1 (k 2t+8.., n g);
// d0,d1 (g, 2t..2t+1), d2,d3 (g+8, 2t..2t+1).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <bool ROT, int ROWS, bool SEG>
__device__ void flash_block_mma(const Problem& p, int b, int h, int q0,
                                __nv_bfloat16* smem) {
  using T = __nv_bfloat16;
  constexpr int kThr = Tiles<T, ROWS>::threads;
  T* Qs = smem;                 // [ROWS][kLd]
  T* Ks = Qs + ROWS * kLd;      // [kBK][kLd]
  T* Vs = Ks + kBK * kLd;       // [kBK][kLd]
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int w0 = (threadIdx.x / 32) * 16;  // the warp's first row in the tile
  const int qs[2] = {query_segment<SEG>(p, b, q0 + w0 + g),
                     query_segment<SEG>(p, b, q0 + w0 + g + 8)};

  load_rows_bf16<ROT, kThr>(p, p.q, b, h, q0, p.nq, ROWS, Qs);
  __syncthreads();
  uint32_t qa[4][4];  // Q as A fragments, one per 16-wide d chunk
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const T* q = &Qs[(w0 + g) * kLd + kk * 16 + 2 * t];
    qa[kk][0] = lds_pair(q);
    qa[kk][1] = lds_pair(q + 8 * kLd);
    qa[kk][2] = lds_pair(q + 8);
    qa[kk][3] = lds_pair(q + 8 * kLd + 8);
  }

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, o[8][4];
#pragma unroll
  for (int jd = 0; jd < 8; ++jd)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[jd][e] = 0.f;

  for (int k0 = 0; k0 < p.nk; k0 += kBK) {
    __syncthreads();  // every warp is done with the previous K and V
    load_rows_bf16<ROT, kThr>(p, p.k, b, h, k0, p.nk, kBK, Ks);
    load_rows_bf16<false, kThr>(p, p.v, b, h, k0, p.nk, kBK, Vs);
    __syncthreads();

    // S = Q K^T for the warp's 16 rows x 64 keys: 8 n-tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const T* k = &Ks[(j * 8 + g) * kLd + kk * 16 + 2 * t];
        mma_bf16(s[j], qa[kk], lds_pair(k), lds_pair(k + 8));
      }
    }

    // rows g (s[j][0..1]) and g+8 (s[j][2..3]) against keys j*8 + 2t + e
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = k0 + j * 8 + 2 * t + e;
        s[j][e] = masked_score<SEG>(p, b, qs[0], c, s[j][e]);
        s[j][2 + e] = masked_score<SEG>(p, b, qs[1], c, s[j][2 + e]);
      }

    // online softmax for rows g (hr=0) and g+8 (hr=1); a row's 64 columns
    // live in the 4 lanes of one quad, reduced by shuffles over offsets 1, 2
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * hr], s[j][2 * hr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hr], mx);
      const float alpha = rescale(m[hr], m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float pe = expf(s[j][2 * hr + e] - m_new);
          s[j][2 * hr + e] = pe;
          rs += pe;
        }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      l[hr] = l[hr] * alpha + rs;
      m[hr] = m_new;
#pragma unroll
      for (int jd = 0; jd < 8; ++jd) {
        o[jd][2 * hr] *= alpha;
        o[jd][2 * hr + 1] *= alpha;
      }
    }

    // O += P V: the S accumulators of n-tiles 2c and 2c+1 are the A
    // fragment of keys 16c..16c+15, rounded to bf16 (the value type)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * c][0], s[2 * c][1]),
          pack_bf16(s[2 * c][2], s[2 * c][3]),
          pack_bf16(s[2 * c + 1][0], s[2 * c + 1][1]),
          pack_bf16(s[2 * c + 1][2], s[2 * c + 1][3])};
#pragma unroll
      for (int jd = 0; jd < 8; ++jd) {
        uint32_t b0, b1;
        ldsm_x2_trans(Vs, c * 16, jd * 8, b0, b1);
        mma_bf16(o[jd], pa, b0, b1);
      }
    }
  }

  T* out = static_cast<T*>(p.o.ptr) + b * p.o.sb + h * p.o.sh;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int n = q0 + w0 + g + 8 * hr;
    if (n >= p.nq) continue;
    if (p.lse != nullptr && t == 0)
      p.lse[((long long)b * p.heads + h) * p.nq + n] = m[hr] + logf(l[hr]);
    const float inv = inv_safe(l[hr]);
#pragma unroll
    for (int jd = 0; jd < 8; ++jd)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        out[n * p.o.sn + (jd * 8 + 2 * t + e) * p.o.sd] =
            from_f<T>(o[jd][2 * hr + e] * inv);
  }
}

// The flash loop of storage type T over query rows [q0, q0 + ROWS); `smem`
// is the block's dynamic shared memory (Tiles<T, ROWS>::smem bytes), the
// block Tiles<T, ROWS>::threads wide. SEG selects the segment-id mask.
template <typename T, bool ROT, int ROWS = kDefaultRows<T>, bool SEG = false>
__device__ __forceinline__ void flash_block(const Problem& p, int b, int h,
                                            int q0, void* smem) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    flash_block_mma<ROT, ROWS, SEG>(p, b, h, q0,
                                    static_cast<__nv_bfloat16*>(smem));
  } else {
#pragma unroll 1
    for (int r = 0; r < ROWS; r += kBQ) {
      if (r > 0) __syncthreads();  // the previous group's tiles are consumed
      flash_block_fma<T, ROT, SEG>(p, b, h, q0 + r,
                                   static_cast<float*>(smem));
    }
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
