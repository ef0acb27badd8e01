// Hopper (sm_90a) 3xTF32 machinery of the float32 row-softmax attention
// with a key-side bias, on the tensor cores: the loop of the float32
// instances of kernel A (csrc/self_attention.cu), kernel B
// (csrc/cross_attention.cu, both directions in one launch), kernel D
// (csrc/attention_fwd.cu, with each row's statistics for F), kernel E
// (csrc/qblock_attention.cu, N queries against M keys) and kernel G
// (csrc/flash_segment.cu, segment ids in place of the bias), the pack
// pass, and the pieces of kernel F's float32 blocks (csrc/attention_bwd.cu:
// the split products, the A fragments, the tensor maps).
//
// What the loop computes is what `self_attention_plain`,
// `cross_attention_bidir_plain`, `qblock_attention_plain` and
// `fused_attention_plain` define (ops/attention_kernels.py) in float32: q
// and k rotated (A; E's self-attention calls) as t*cos + rotate_half(t)*sin
// with each product and the sum rounded to float32; S = Q K^T to float32
// accuracy, then x scale, then + the float32 key bias, rounded apart; an
// online float32 softmax; O = P V to float32 accuracy, divided by the row
// sum at the end. The loop's argument type picks two compile-time
// additions: with StatsArgs (D) it also writes each row's max m and sum l
// of exp(s - m), m in natural units with s - m formed first, so a fully
// masked row gets m = -1e9 and l = M; with SegArgs (G) it adds jax's
// segment rule in place of the bias, what `flash_attention_plain`
// (ops/flash_kernel.py) defines: kMaskValue (-0.7 FLT_MAX) after the scale
// where the query's and the key's int32 ids differ, 0 where they agree.
//
// What bounds it: float32 products need not run on the CUDA cores (67
// TFLOP/s). Each operand x is split into two TF32 values, hi = tf32(x) and
// lo = tf32(x - hi), so that x = hi + lo to 2^-22 |x|, and a product is
// taken as hi*hi + hi*lo + lo*hi: three TF32 wgmma products (495 TFLOP/s
// dense, ~165 TFLOP/s for the three) whose dropped lo*lo term and TF32
// inputs leave ~2^-21 relative per product, far inside the float32
// tolerance of 1e-4 x max(1, max|ref|). At the flagship shapes (B=8, h=4,
// N=M=1024, d=64) A, D, E and G are 8.6 GFLOP of float32 products, 25.8
// GFLOP of TF32 (~0.052 ms at 495 TFLOP/s); B computes S once a direction,
// 17.2 and 51.5 GFLOP (~0.104 ms).
//
// Design:
//  - a pack pass (attention_pack_tf32_kernel), once per token: it reads
//    each operand through its element strides (any strides: SelfBlock's
//    stride-3 Wqkv views, CrossBlock's head views), applies the rotary to
//    q and k where asked, splits every value into hi and lo (tf32_round:
//    cvt.rna.tf32.f32's rounding, to nearest with ties away from zero, the
//    13 low bits cleared) and writes contiguous planes: row planes (B, h,
//    2, rows, 64) (hi, lo) and transposed planes (B, h, 2, 64, rows
//    rounded up to 64), each 8-row group in the permuted order below,
//    zeros past the last row. TF32 wgmma reads both shared-memory operands
//    K-major only, so a product that sums over tokens (P V; F's P^T dO,
//    dS^T Q and dS K) takes the transposed plane of its B operand;
//  - the loop (attention_block) is warp specialised as the bf16 loop of
//    flash_sm90.cuh: one producer warp keeps TMA loads (128-byte swizzle:
//    a 64-float row is two 32-float atoms, so a 64 x 64 plane is two boxes
//    8 KB apart) of the K and V^T hi/lo planes of each 64-key tile
//    kStages tiles ahead and writes the tile's 64 key-bias floats beside
//    them (-inf past the last key; G: the 64 int32 key ids, 0 past the
//    last key, never read there); each consumer warpgroup owns 64 query
//    rows and computes S = Qlo Khi^T + Qhi Klo^T + Qhi Khi^T with
//    wgmma.m64n64k8.f32.tf32.tf32 (both operands from shared memory, the
//    descriptor stepping 32 bytes a k8 slice inside an atom), the score
//    s = fl(fl(S x scale) + bias) (G: + 0 or kMaskValue, each consumer
//    warp holding its two rows' query ids in registers, and -inf for keys
//    past the last by their index), the online softmax in registers (exp
//    as exp2 of the difference scaled by log2(e), as the bf16 loop takes
//    it, faster than expf), and O += Plo Vhi + Phi Vlo + Phi Vhi with P
//    split in registers as the A operand. F forms every score with these
//    products in this order (k8 slices in order), so D's m and l fit its P;
//  - fragment layouts: a k8 accumulator holds columns (2t, 2t + 1) of
//    each 8-column group in lane t of a quad, the TF32 A fragment wants
//    columns (t, t + 4). The pack pass writes each 8-row group of a
//    transposed plane in the order (0, 2, 4, 6, 1, 3, 5, 7), so that A
//    column t is row 2t and column t + 4 row 2t + 1: permuting the
//    contracted index of both operands alike leaves the product unchanged,
//    and S, the bias and the mask keep the natural key order;
//  - budgets: a 64 x 64 float32 plane is 16 KB; a stage (K hi/lo, V^T
//    hi/lo) 64 KB and Q hi/lo 32 KB, so two stages and the block's one
//    consumer warpgroup take 160 KB: one block an SM (three stages, 224
//    KB, are no faster; tools/time_tf32_variants.py times them). The
//    consumers hold O and S (32 floats each) and P's hi/lo fragments
//    (32 + 32) in the 255 registers a thread of a 160-thread block may
//    have, so no setmaxnreg is needed. 64 query rows a block spread the eval entries' B = 1 over
//    64 (A) and 128 (B) SMs; two consumer warpgroups sharing each tile
//    (128 rows) spilled under ptxas's register cap for their block and
//    spread B = 1 over half as many SMs;
//  - query rows and keys past the ends are zero-filled by TMA (V^T's by
//    the pack pass); keys past nk get -inf through the bias tile (G: by
//    their index), rows past nq are not written. A fully masked batch row
//    has every s = -1e9 (|S x scale| < 32 rounds away), so P is uniform,
//    as in the plain version; in G every s = kMaskValue, so m is that
//    value, exp(s - m) = 1 for each key and the row is the mean of V, as
//    jax's kernel gives. exp_diff forms s - m before it scales by log2(e):
//    a masked score against a finite max then overflows to -inf and gives
//    0, and a first tile wholly masked before valid keys gives alpha = 0,
//    where s log2(e) - m log2(e) would be -inf - (-inf) = NaN on a fully
//    masked row.
#pragma once

#include <type_traits>

#include "flash_sm90.cuh"

namespace ei {
namespace tf32 {

using sm90::fence_acc;
using sm90::exp_diff;
using sm90::mbar_arrive;
using sm90::mbar_arrive_tx;
using sm90::mbar_init;
using sm90::mbar_wait;
using sm90::smem_desc;
using sm90::wgmma_commit;
using sm90::wgmma_fence;
using sm90::wgmma_wait;

constexpr int kD = 64;           // head dim
constexpr int kBK = 64;          // keys a tile
constexpr int kStages = 2;       // K/V^T tiles in flight
constexpr int kAtom = 64 * 32;   // floats of one 64-row x 128-byte atom
constexpr int kPlane = 2 * kAtom;            // a 64 x 64 float plane
constexpr int kPlaneBytes = kPlane * 4;      // 16 KB

constexpr int kThreads = 160;  // a consumer warpgroup, a producer warp

struct Shared {
  float q[2][kPlane];            // [hi, lo], 1024-byte aligned
  float k[kStages][2][kPlane];
  float v[kStages][2][kPlane];   // V^T: 64 d rows x 64 keys (permuted)
  float bias[kStages][kBK];
  uint64_t full[kStages], empty[kStages], qbar;
};
// dynamic shared memory of one block: the tiles plus room to align them
constexpr size_t kSmemBytes = sizeof(Shared) + 1024;

struct Args {
  const float* bias;  // (B, nk) float32, contiguous (SegArgs: unused)
  float* out;         // (B, h, nq, 64) through os (b, h, n); d unit
  long long os[3];
  int nq, nk;
  float scale;
};

// Kernel D: also each query row's statistics of the scaled, biased scores
// s for kernel F, the row max m and the row sum l of exp(s - m), rows past
// nq not written.
struct StatsArgs : Args {
  float* row_max;  // (B, heads, nq) float32, contiguous
  float* row_sum;
  int heads;
};

// Kernel G: jax's segment rule in place of the bias: kMaskValue added
// after the scale wherever the ids differ.
struct SegArgs : Args {
  const int* q_seg;   // (B, nq) int32, contiguous
  const int* kv_seg;  // (B, nk) int32, contiguous
};

// cvt.rna.tf32.f32's rounding of x: to 10 fraction bits, to nearest with
// ties away from zero, the 13 low bits cleared (what the tensor cores read
// of a TF32 operand), as integer operations so the bits are defined.
__device__ __forceinline__ float tf32_round(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
}

// One 32-float x 64-row box of a 5-D (inner, outer, plane, h, B) tensor map.
__device__ __forceinline__ void tma_load5(float* dst, const CUtensorMap& map,
                                          int inner, int outer, int plane,
                                          int h, int b, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n" ::"r"(
          sm90::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(inner), "r"(outer),
      "r"(plane), "r"(h), "r"(b), "r"(sm90::smem_u32(bar))
      : "memory");
}

// A 64 x 64 plane: its two atoms, inner coordinates inner0 and inner0 + 32.
__device__ __forceinline__ void load_plane(float* dst, const CUtensorMap& map,
                                           int inner0, int outer0, int plane,
                                           int h, int b, uint64_t* bar) {
  tma_load5(dst, map, inner0, outer0, plane, h, b, bar);
  tma_load5(dst + kAtom, map, inner0 + 32, outer0, plane, h, b, bar);
}

// The descriptor of k8 slice kk (0..7) of a plane whose descriptor is d:
// slices 0-3 in the first atom, 4-7 in the second, 32 bytes apart.
__device__ __forceinline__ uint64_t slice(uint64_t d, int kk) {
  return d + (kk >> 2) * (kAtom * 4 >> 4) + (kk & 3) * (32 >> 4);
}

#define EI_TF32_ACC(d)                                                     \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),         \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),     \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),     \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),     \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),     \
      "+f"(d[31])
#define EI_TF32_D                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "  \
  "%28, %29, %30, %31}"

// D (64 x 64 f32) (+)= A B^T over one k8 slice: A (64 rows) and B (64 rows)
// K-major in shared memory; scale_d 0 overwrites D.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " EI_TF32_D
      ", %32, %33, p, 1, 1;\n}\n"
      : EI_TF32_ACC(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64 f32) += A B over one k8 slice: A (64 x 8 TF32) from registers,
// lane (g, t) of warp w holding rows 16w + g (+ 8) at columns t, t + 4;
// B K-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " EI_TF32_D
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : EI_TF32_ACC(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef EI_TF32_ACC
#undef EI_TF32_D

// S = Q K^T to float32 accuracy: the two small products first.
__device__ __forceinline__ void product_qk(float (&s)[32], uint64_t qh,
                                           uint64_t ql, uint64_t kh,
                                           uint64_t kl) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) wgmma_ss(s, slice(ql, kk), slice(kh, kk), kk);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) wgmma_ss(s, slice(qh, kk), slice(kl, kk), 1);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) wgmma_ss(s, slice(qh, kk), slice(kh, kk), 1);
}

// S^T = K Q^T with the terms of product_qk(S, Q, K) in their order (Qlo
// Khi^T, Qhi Klo^T, Qhi Khi^T, k8 slices in order), K as the A operand:
// each TF32 product is exact in float32 and a slice sums the same
// products, so S^T[j][i] is meant to be S[i][j] bit for bit (the card
// tests hold F's P from D's statistics on the one-hot rows, where it
// matters).
__device__ __forceinline__ void product_st(float (&s)[32], uint64_t kh,
                                           uint64_t kl, uint64_t qh,
                                           uint64_t ql) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) wgmma_ss(s, slice(kh, kk), slice(ql, kk), kk);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) wgmma_ss(s, slice(kl, kk), slice(qh, kk), 1);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) wgmma_ss(s, slice(kh, kk), slice(qh, kk), 1);
}

// The hi and lo A fragments of an accumulator x (x[4j + e]: row g + 8
// (e >> 1) of the warp's 16, column 8j + 2t + (e & 1)), split in
// registers: A column t of group c is x's column 8c + 2t, column t + 4 its
// column 8c + 2t + 1, the order of the transposed planes.
__device__ __forceinline__ void split_a(const float (&x)[32],
                                        uint32_t (&hi)[8][4],
                                        uint32_t (&lo)[8][4]) {
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float v[4] = {x[4 * c], x[4 * c + 2], x[4 * c + 1], x[4 * c + 3]};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float h = tf32_round(v[e]);
      hi[c][e] = __float_as_uint(h);
      lo[c][e] = __float_as_uint(tf32_round(v[e] - h));
    }
  }
}

// A 64 x 64 accumulator times mul[row g (0) or g + 8 (1)] at rows r0 + 16 w
// + g (+ 8) of `out` for the block's w-th consumer warp (rows past n_rows
// not written); `out` through element strides os (b, h, n), d unit.
__device__ __forceinline__ void store_tile(const float (&x)[32],
                                           const float (&mul)[2], float* out,
                                           const long long (&os)[3], int b,
                                           int h, int r0, int n_rows) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int n = r0 + 16 * warp + g + 8 * hr;
    if (n >= n_rows) continue;
    float* row = out + b * os[0] + h * os[1] + n * os[2];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float2*>(row + 8 * j + 2 * t) = make_float2(
          x[4 * j + 2 * hr] * mul[hr], x[4 * j + 2 * hr + 1] * mul[hr]);
  }
}

// O += P V to float32 accuracy, P's hi and lo fragments of the 8 key
// groups against V^T's hi and lo planes (F: any A fragments against a
// transposed plane).
__device__ __forceinline__ void product_pv(float (&o)[32],
                                           const uint32_t (&ph)[8][4],
                                           const uint32_t (&pl)[8][4],
                                           uint64_t vh, uint64_t vl) {
#pragma unroll
  for (int c = 0; c < 8; ++c) wgmma_rs(o, pl[c], slice(vh, c));
#pragma unroll
  for (int c = 0; c < 8; ++c) wgmma_rs(o, ph[c], slice(vl, c));
#pragma unroll
  for (int c = 0; c < 8; ++c) wgmma_rs(o, ph[c], slice(vh, c));
}

// The loop over the query rows [q0, q0 + 64) of problem (b, h): tq, tk are
// 5-D (64, rows, 2, h, B) maps of the Q and K planes, tv the
// (keys, 64, 2, h, B) map of the V^T planes, all with 32 x 64 boxes; A is
// Args, StatsArgs or SegArgs.
template <typename A>
__device__ __forceinline__ void attention_block(const CUtensorMap& tq,
                                                const CUtensorMap& tk,
                                                const CUtensorMap& tv,
                                                const A& a, int q0, int h,
                                                int b) {
  constexpr bool kStats = std::is_same<A, StatsArgs>::value;
  constexpr bool kSeg = std::is_same<A, SegArgs>::value;
  auto& S = sm90::shared_as<Shared>();
  const int ntiles = (a.nk + kBK - 1) / kBK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&S.full[s], 32);        // the producer warp's lanes
      mbar_init(&S.empty[s], 4);        // one lane of each consumer warp
    }
    mbar_init(&S.qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {
    // ---- producer: Q once, then the K and V^T planes of each tile and
    // its key bias (G: its key ids)
    if (lane == 0) {
      mbar_arrive_tx(&S.qbar, 2 * kPlaneBytes);
      for (int p = 0; p < 2; ++p)
        load_plane(S.q[p], tq, 0, q0, p, h, b, &S.qbar);
    }
    for (int it = 0; it < ntiles; ++it) {
      const int st = it % kStages;
      mbar_wait(&S.empty[st], ((it / kStages) & 1) ^ 1);
      const int c = it * kBK + 2 * lane;
      if constexpr (kSeg) {
        // the key ids as float bit patterns; the consumers mask keys past
        // nk by their index, so any id value stays usable
        const int* ids = a.kv_seg + (long long)b * a.nk;
        S.bias[st][2 * lane] = __int_as_float(c < a.nk ? ids[c] : 0);
        S.bias[st][2 * lane + 1] =
            __int_as_float(c + 1 < a.nk ? ids[c + 1] : 0);
      } else {
        const float* bias = a.bias + (long long)b * a.nk;
        S.bias[st][2 * lane] = c < a.nk ? bias[c] : -INFINITY;
        S.bias[st][2 * lane + 1] = c + 1 < a.nk ? bias[c + 1] : -INFINITY;
      }
      if (lane == 0) {
        mbar_arrive_tx(&S.full[st], 4 * kPlaneBytes);
        for (int p = 0; p < 2; ++p) {
          load_plane(S.k[st][p], tk, 0, it * kBK, p, h, b, &S.full[st]);
          load_plane(S.v[st][p], tv, it * kBK, 0, p, h, b, &S.full[st]);
        }
      } else {
        mbar_arrive(&S.full[st]);
      }
    }
  } else {
    // ---- consumers: warp w owns rows q0 + 16 w .. + 15
    [[maybe_unused]] const int g = lane / 4;
    const int t = lane % 4;
    const uint64_t qh = smem_desc(S.q[0]);
    const uint64_t ql = smem_desc(S.q[1]);
    float o[32], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    // G: the ids of the warp's rows g and g + 8 (0 past nq, never stored)
    [[maybe_unused]] int qid[2] = {0, 0};
    if constexpr (kSeg) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int n = q0 + 16 * warp + g + 8 * hr;
        if (n < a.nq) qid[hr] = a.q_seg[(long long)b * a.nq + n];
      }
    }
    mbar_wait(&S.qbar, 0);

    for (int it = 0; it < ntiles; ++it) {
      const int st = it % kStages;
      mbar_wait(&S.full[st], (it / kStages) & 1);
      float s[32];
      wgmma_fence();
      product_qk(s, qh, ql, smem_desc(S.k[st][0]), smem_desc(S.k[st][1]));
      wgmma_commit();
      wgmma_wait();
      fence_acc(s);

      // s[4j + e]: row g (e < 2) or g + 8, key 8j + 2t + (e & 1)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 bb =
            *reinterpret_cast<const float2*>(&S.bias[st][8 * j + 2 * t]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float add = (e & 1) ? bb.y : bb.x;
          if constexpr (kSeg)
            add = __float_as_int(add) == qid[e >> 1] ? 0.f : kMaskValue;
          s[4 * j + e] = __fadd_rn(__fmul_rn(s[4 * j + e], a.scale), add);
        }
      }
      if constexpr (kSeg) {
        // keys past nk (in the last tile only): -inf
        const int valid = a.nk - it * kBK;
        if (valid < kBK) {
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (8 * j + 2 * t + (e & 1) >= valid) s[4 * j + e] = -INFINITY;
        }
      }

      // online softmax of rows g (hr 0) and g + 8 (hr 1); a row's keys
      // live in the four lanes of a quad
      float alpha[2];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          mx = fmaxf(mx, fmaxf(s[4 * j + 2 * hr], s[4 * j + 2 * hr + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[hr], mx);
        alpha[hr] = exp_diff(m[hr], m_new);  // 0 at first
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = exp_diff(s[4 * j + 2 * hr + e], m_new);
            s[4 * j + 2 * hr + e] = p;
            rs += p;
          }
        rs += __shfl_xor_sync(0xffffffffu, rs, 1);
        rs += __shfl_xor_sync(0xffffffffu, rs, 2);
        l[hr] = l[hr] * alpha[hr] + rs;
        m[hr] = m_new;
      }

      // P split as the A operand of key group c: A column t is key
      // 8c + 2t, column t + 4 key 8c + 2t + 1: V^T's permuted order
      uint32_t ph[8][4], pl[8][4];
      split_a(s, ph, pl);
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] *= alpha[(i >> 1) & 1];

      fence_acc(o);
      wgmma_fence();
      product_pv(o, ph, pl, smem_desc(S.v[st][0]), smem_desc(S.v[st][1]));
      wgmma_commit();
      wgmma_wait();
      fence_acc(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(&S.empty[st]);
    }

    // O / l, float32, rows past nq not written
    const float inv[2] = {l[0] == 0.f ? 1.f : 1.f / l[0],
                          l[1] == 0.f ? 1.f : 1.f / l[1]};
    store_tile(o, inv, a.out, a.os, b, h, q0, a.nq);
    if constexpr (kStats) {
      // m and l are whole-row values in every lane of the row's quad
      if (t == 0) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int n = q0 + 16 * warp + g + 8 * hr;
          if (n >= a.nq) continue;
          const long long r = ((long long)b * a.heads + h) * a.nq + n;
          a.row_max[r] = m[hr];
          a.row_sum[r] = l[hr];
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The pack pass
// ---------------------------------------------------------------------------

// One operand to pack: row (b, h, n) holds its 64 values at src + b*sb +
// h*sh + n*sn + d*sd (elements). Rows: into the (B, h, 2, rows, 64) hi/lo
// planes at dst, rotated with the (B, rows, 64) tables when rot;
// transpose: into the (B, h, 2, 64, keys) transposed planes (V^T; F's Q^T,
// K^T and dO^T), keys = rows rounded up to 64, each 8-row group in the
// order 0, 2, 4, 6, 1, 3, 5, 7, zeros past the last row.
struct PackJob {
  const float* src;
  long long sb, sh, sn, sd;
  int rows, transpose, rot;
  float* dst;
};

constexpr int kMaxJobs = 8;  // F's q, k, v, dO rows; q, k, dO transposed
constexpr int kPackThreads = 256;

struct PackArgs {
  PackJob job[kMaxJobs];
  int H;
  const float* cos;  // (B, rows, 64) contiguous (rot only)
  const float* sin;
};

// Keys rounded up to whole 64-key tiles: V^T's row length.
__host__ __device__ inline int padded_keys(int rows) {
  return (rows + kBK - 1) / kBK * kBK;
}

// Block (x, y, z): rows 64x..64x + 63 of problem y = b H + h of job z.
__global__ void __launch_bounds__(kPackThreads)
    attention_pack_tf32_kernel(const PackArgs a) {
  __shared__ float tile[64][65];
  const PackJob& j = a.job[blockIdx.z];
  const int r0 = blockIdx.x * 64;
  if (r0 >= j.rows) return;
  const int bh = blockIdx.y, h = bh % a.H, b = bh / a.H;
  const float* src = j.src + b * j.sb + h * j.sh;
  const int lane64 = threadIdx.x % 64;
  if (!j.transpose) {
    // thread (r, d): 64 d lanes a row, so a warp holds one row and the
    // rotary's partner lane d ^ 1 is a shuffle away
    const int d = lane64;
    float* hi = j.dst + (long long)bh * 2 * j.rows * kD;
    float* lo = hi + (long long)j.rows * kD;
    for (int r = threadIdx.x / 64; r < 64; r += kPackThreads / 64) {
      const int n = r0 + r;
      if (n >= j.rows) break;  // warp-uniform
      float x = src[n * j.sn + d * j.sd];
      if (j.rot) {
        // rotate_half: (-t[2m+1], t[2m]); t*cos + rotate_half(t)*sin with
        // each product and the sum rounded to float32
        const float partner = __shfl_xor_sync(0xffffffffu, x, 1);
        const long long off = ((long long)b * j.rows + n) * kD + d;
        x = __fadd_rn(__fmul_rn(x, a.cos[off]),
                      __fmul_rn((d & 1) ? partner : -partner, a.sin[off]));
      }
      const float xh = tf32_round(x);
      hi[(long long)n * kD + d] = xh;
      lo[(long long)n * kD + d] = tf32_round(x - xh);
    }
  } else {
    for (int r = threadIdx.x / 64; r < 64; r += kPackThreads / 64) {
      const int n = r0 + r;
      tile[r][lane64] = n < j.rows ? src[n * j.sn + lane64 * j.sd] : 0.f;
    }
    __syncthreads();
    // thread (position, d): position p of the tile holds key
    // 8 (p / 8) + 2 (p % 4) + (p % 8) / 4
    const int keys = padded_keys(j.rows);
    const int p = lane64;
    const int key = (p & ~7) | (2 * (p & 3) + ((p >> 2) & 1));
    float* hi = j.dst + (long long)bh * 2 * kD * keys;
    float* lo = hi + (long long)kD * keys;
    for (int d = threadIdx.x / 64; d < kD; d += kPackThreads / 64) {
      const float x = tile[key][d];
      const float xh = tf32_round(x);
      hi[(long long)d * keys + r0 + p] = xh;
      lo[(long long)d * keys + r0 + p] = tf32_round(x - xh);
    }
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// 5-D (inner, outer, 2, H, B) map of contiguous float32 planes, 32 x 64
// boxes, 128-byte swizzle: Q and K planes (inner 64 d, outer rows), V^T
// planes (inner the padded keys, outer 64 d).
inline int encode_planes(CUtensorMap* map, const float* ptr, int inner,
                         int outer, int H, int B) {
  auto encode = sm90::tensor_map_encoder();
  if (encode == nullptr) return sm90::kErrNoEncoder;
  sm90::bind_context();
  const cuuint64_t row = (cuuint64_t)inner * 4;
  cuuint64_t dims[5] = {(cuuint64_t)inner, (cuuint64_t)outer, 2,
                        (cuuint64_t)H, (cuuint64_t)B};
  cuuint64_t strides[4] = {row, row * outer, row * outer * 2,
                           row * outer * 2 * H};
  cuuint32_t box[5] = {32, 64, 1, 1, 1};
  cuuint32_t estr[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 5, const_cast<float*>(ptr), dims,
      strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : sm90::kErrTensorMap;
}

// The maps of one problem's planes: rows planes (B, H, 2, rows, 64) and
// the V^T planes of `keys` keys.
inline int row_map(CUtensorMap* map, const float* planes, int rows, int H,
                   int B) {
  return encode_planes(map, planes, kD, rows, H, B);
}
inline int value_map(CUtensorMap* map, const float* planes, int keys, int H,
                     int B) {
  return encode_planes(map, planes, padded_keys(keys), kD, H, B);
}

// Once per kernel: its dynamic shared memory limit. The result is kept.
inline int configure(const void* kernel) {
  static const void* seen = nullptr;
  static int status = 0;
  if (seen != kernel) {
    status = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
    seen = kernel;
  }
  return status;
}

// The loop's arguments of the bias kernels (A, D, E; G's with a null
// bias): the (B, M) float32 key bias, the float32 output through
// `out_strides` (b, h, n; d unit).
inline Args bias_args(const float* bias, void* out,
                      const long long* out_strides, int N, int M,
                      float scale) {
  return Args{bias, static_cast<float*>(out),
              {out_strides[0], out_strides[1], out_strides[2]}, N, M,
              scale};
}

// One launch of a loop kernel (A, D, E or G) over the planes the pack
// pass wrote: q_planes (B, H, 2, a.nq, 64), k_planes (B, H, 2, a.nk, 64),
// v_planes (B, H, 2, 64, a.nk rounded up to 64); grid
// ((a.nq + 63) / 64, H, B). Returns 0, a CUDA error code or one of
// ei::sm90's kErr* codes.
template <typename Kernel, typename A>
int attention(Kernel kernel, const float* q_planes, const float* k_planes,
              const float* v_planes, const A& a, int B, int H,
              cudaStream_t stream) {
  CUtensorMap maps[3];
  int err = row_map(&maps[0], q_planes, a.nq, H, B);
  if (err == 0) err = row_map(&maps[1], k_planes, a.nk, H, B);
  if (err == 0) err = value_map(&maps[2], v_planes, a.nk, H, B);
  if (err == 0) err = configure(reinterpret_cast<const void*>(kernel));
  if (err != 0) return err;
  const dim3 grid((a.nq + 63) / 64, H, B);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(maps[0], maps[1], maps[2],
                                                 a);
  return (int)cudaGetLastError();
}

}  // namespace tf32
}  // namespace ei

// The float32 pack pass: njobs (1..8) operands, 9 long longs each: source
// pointer, element strides b, h, n, d, rows, transpose (0: split row
// planes, 1: split transposed planes), rot (rotate through the (B, rows, 64)
// float32 tables cos, sin), destination pointer (the wrapper's planes).
// Returns the CUDA error code of the launch (0 on success).
extern "C" int ei_attention_pack_tf32(const long long* jobs, int njobs,
                                      const void* cos, const void* sin,
                                      int B, int H, void* stream) {
  using namespace ei::tf32;
  if (njobs < 1 || njobs > kMaxJobs) return (int)cudaErrorInvalidValue;
  PackArgs pk{};
  int max_rows = 0;
  for (int i = 0; i < njobs; ++i) {
    const long long* v = jobs + 9 * i;
    pk.job[i] = PackJob{reinterpret_cast<const float*>(v[0]), v[1], v[2],
                        v[3], v[4], (int)v[5], (int)v[6], (int)v[7],
                        reinterpret_cast<float*>(v[8])};
    max_rows = pk.job[i].rows > max_rows ? pk.job[i].rows : max_rows;
  }
  pk.H = H;
  pk.cos = static_cast<const float*>(cos);
  pk.sin = static_cast<const float*>(sin);
  const dim3 grid((max_rows + 63) / 64, B * H, njobs);
  attention_pack_tf32_kernel<<<grid, kPackThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(pk);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of one block of the float32 loop, for the build
// report.
extern "C" long long ei_tf32_smem_bytes() {
  return (long long)ei::tf32::kSmemBytes;
}
