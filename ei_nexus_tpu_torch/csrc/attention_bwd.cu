// Kernel F: the backward of kernel D, dQ, dK and dV of row-softmax
// attention with a key-side bias and any softmax scale.
//
// Replaces: ei_nexus_tpu/ops/pallas_attention.py `_attention_bwd_kernel`
// (reached through `_attention_bwd_call` from the custom VJP of
// `fused_attention_vjp`), the TPU kernel that recomputes, for one whole
// (batch, head) problem in VMEM,
//   S = scale QK^T + bias,  P = softmax_row(S),
//   dP = dO V^T,  c = rowsum(dP o P),  dS = P o (dP - c),
//   dQ = scale dS K,  dV = P^T dO,  dK = scale dS^T Q,
// rounding dS and P^T to the operand type before their products. Like the
// TPU kernel it takes (q, k, v, bias, dO) and the forward's row statistics,
// not the forward's output.
//
// What bounds it on an H100: at the flagship shapes (B=8, h=4, N=M=1024,
// d=64) the five products are 21.5 GFLOP against ~34 MB of inputs and
// outputs (bf16), so it is compute-bound in either type: ~22 us at 989
// TFLOP/s in bf16, ~0.13 ms at the 3xTF32 rate (495 / 3 TFLOP/s) in
// float32.
//
// Design. Hopper blocks run in no order, so nothing carries from one block
// to the next, and the TPU kernel's per-problem sums become blocks that
// each own their outputs (no atomics, so the sums are the same from run to
// run). c = rowsum(dP o P) is the TPU kernel's, from these same P and dP;
// FlashAttention-2's rowsum(dO o O) would read O rounded to bf16, and where
// a row's value rows nearly coincide (or its softmax is one-hot) dP - c
// cancels below that rounding, which then rules dQ and dK. Every dK/dV
// block needs the c of all queries before its first tile, so S and dP are
// computed three times (nine products instead of five), the price of
// independent blocks. P is rebuilt from the row max m and the row sum l
// that kernel D saves, with s - m formed before anything else, so a fully
// masked row (every score -1e9) gets P = 1/M as the plain version does.
//  - bfloat16 (the main path of the bf16 configs), in two launches:
//    - the c pass: blocks own 64 queries and loop over 64-key tiles: S = Q
//      K^T and dP = dO V^T, P = exp(S - m) / l from the forward's row
//      statistics (the TPU's pass-1 m and Z), c += P o dP in float32,
//      summed over the row's threads and written once a row;
//    - the main launch, two kinds of block: dK/dV blocks own 64 keys and
//      loop over 64-query tiles: S^T = K Q^T and dP^T = V dO^T, P^T =
//      exp(S^T - m) / l (not a softmax of S^T), dV += P^T dO, dK += dS^T
//      Q; dQ blocks own 64 queries and loop over 64-key tiles: S, P, dP,
//      dS as above, dQ += dS K.
//    The Hopper machinery of flash_sm90.cuh: a block is one consumer
//    warpgroup on wgmma and a producer warpgroup that gives its registers
//    back; the producer loads the block's two resident tiles once (K, V or
//    Q, dO) and streams the other two by TMA in a 3-stage ring, writing
//    each tile's per-row floats beside it: the streamed queries' m, 1/l
//    and c (past the last query m = +inf, 1/l = 0, so P = 0), or the
//    streamed keys' bias (-inf past the last key). S^T, dP^T, S and dP are
//    wgmma_ss products (both operands K-major from shared memory); P^T and
//    dS^T (or dS) are formed in the accumulators, rounded to bf16 where the
//    plain version rounds them, and enter dV += P^T dO, dK += dS^T Q and
//    dQ += dS K as the register A operand, the streamed tile serving as the
//    transposed (MN-major) B operand, as V does in the forward loop. The c
//    pass is a dQ block without the dQ product. Operands the TMA cannot
//    read in place (the stride-3 v of SelfBlock's Wqkv split) are packed
//    first, once for both launches; the rotated q and k and dO are read in
//    place. D's row max and sum fit P here: S comes from the same wgmma
//    products as in D's loop, so sum_j P_ij is 1 to l's rounding.
//  - float32 (the float32 configs: the `train_matcher` entry's LightGlue,
//    whose configs set no dtype), on the tensor cores with the 3xTF32
//    pieces of flash_tf32.cuh, in the same three kinds of block:
//    - a pack pass (flash_tf32.cuh's, one launch, 7 jobs): q, k, v and dO
//      split into TF32 hi/lo row planes, and q, k and dO into transposed
//      planes, each 8-token group permuted as the A fragments take it
//      (TF32 wgmma reads both shared-memory operands K-major only, so each
//      product over tokens needs its B operand transposed: dV += P^T dO
//      takes dO^T, dK += dS^T Q takes Q^T, dQ += dS K takes K^T);
//    - the c pass: blocks of 64 queries (Q and dO resident) over 64-key
//      tiles (K and V streamed): S and dP as three split products each,
//      S in D's order (product_qk), so D's m and l fit P; c += P o dP in
//      float32, a tile's part summed over the row's quad, the tiles'
//      parts compensated (Kahan): where dP - c cancels, the error of c is
//      what rules dS;
//    - the main launch: dK/dV blocks own 64 keys (K, V resident) over
//      64-query tiles: S^T = K Q^T with D's terms in D's order
//      (product_st) and dP^T = V dO^T, P^T and dS^T = P^T o (dP^T - c) in
//      float32, split in registers as the A operand of dV += P^T dO and
//      dK += dS^T Q; dQ blocks own 64 queries over 64-key tiles: S, dP,
//      dS split in registers, dQ += dS K. A streamed tile comes in two
//      steps through two 64 KB slots: the row planes of the first two
//      products (with the tile's per-row floats: the queries' m, 1/l and
//      c, or the keys' bias), then the transposed planes of the last two,
//      so each step's load overlaps the other's products; the resident
//      planes take 64 KB, 192 KB in all, one block an SM.
//    Nine split products, as bf16; no atomics, so the bits repeat. Past
//    the last key a score is -inf, past the last query m = +inf and
//    1/l = 0, so P = 0; TMA and the pack pass zero-fill rows past the end.
#include "flash_sm90.cuh"
#include "flash_tf32.cuh"

namespace ei {

// ---------------------------------------------------------------------------
// float32 instance: the 3xTF32 blocks
// ---------------------------------------------------------------------------

namespace tf32 {

// Resident planes (the first two products' A operands: K, V or Q, dO) and
// two slots of streamed planes (a tile's first step: the row planes of
// the first two products' B operands; its second step: the transposed
// planes of the last products' B operands), all 1024-byte aligned.
struct BwdShared {
  float res[2][2][kPlane];      // [operand][hi, lo]
  float str[2][2][2][kPlane];   // [slot][operand][hi, lo]
  // a first step's per-row floats: dK/dV the streamed queries' m, 1/l and
  // c; dQ and c pass the streamed keys' bias in [0]
  float row[2][3][kBK];
  uint64_t full[2], empty[2], resbar;
};
constexpr size_t kBwdSmemBytes = sizeof(BwdShared) + 1024;

struct BwdArgs {
  const float* bias;  // (B, nk) float32
  const float* m;     // (B, H, nq) float32 row max
  const float* l;     // (B, H, nq) float32 row sum of exp(s - m)
  float* c;           // (B, H, nq) float32 rowsum(dP o P): the c pass
                      // writes it, the main launch reads it
  float* out[3];      // dq (B, H, nq, 64), dk, dv (B, H, nk, 64)
  long long os[3][3]; // their (b, h, n) element strides; d unit
  int H, nq, nk, nkb; // nkb: the dK/dV blocks of a (b, h) problem
  int x0;             // block x0 + blockIdx.x is the block's index
  float scale;
};

// The planes' tensor maps: row planes (64, rows, 2, H, B) of q, k, v, dO;
// transposed planes (rows rounded up to 64, 64, 2, H, B) of q, k, dO.
struct BwdMaps {
  CUtensorMap q, k, v, dout, qt, kt, dot;
};

// The scaled, biased score and P = exp(s - m) x (1/l) (0 past the last
// query, where m = +inf and 1/l = 0).
__device__ __forceinline__ float prob(float s, float scale, float bias,
                                      float m, float il) {
  return __fmul_rn(exp_diff(__fadd_rn(__fmul_rn(s, scale), bias), m), il);
}

// dK/dV block: the warpgroup owns keys k0 .. k0 + 63 (K, V resident) and
// loops over the ntiles 64-query tiles: step 1 (slot 0) Q, dO and the
// queries' m, 1/l, c; step 2 (slot 1) Q^T, dO^T.
__device__ __forceinline__ void bwd_keys(BwdShared& S, const BwdArgs& a,
                                         int k0, int h, int b, int ntiles) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  float bias[2];  // of the thread's keys, rows g and g + 8 of the warp
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int key = k0 + 16 * warp + g + 8 * hr;
    bias[hr] = key < a.nk ? a.bias[(long long)b * a.nk + key] : -INFINITY;
  }
  const uint64_t kh = smem_desc(S.res[0][0]), kl = smem_desc(S.res[0][1]);
  const uint64_t vh = smem_desc(S.res[1][0]), vl = smem_desc(S.res[1][1]);
  float dk[32], dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
  mbar_wait(&S.resbar, 0);

  for (int it = 0; it < ntiles; ++it) {
    mbar_wait(&S.full[0], it & 1);
    float s[32], dp[32];  // S^T = K Q^T, dP^T = V dO^T: keys x queries
    wgmma_fence();
    product_st(s, kh, kl, smem_desc(S.str[0][0][0]),
               smem_desc(S.str[0][0][1]));
    product_st(dp, vh, vl, smem_desc(S.str[0][1][0]),
               smem_desc(S.str[0][1][1]));
    wgmma_commit();
    wgmma_wait();
    fence_acc(s);
    fence_acc(dp);

    // s[4j + e]: key row g + 8 (e >> 1), query 8j + 2t + (e & 1)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + 2 * t;
      const float2 mm = *reinterpret_cast<const float2*>(&S.row[0][0][col]);
      const float2 ll = *reinterpret_cast<const float2*>(&S.row[0][1][col]);
      const float2 cc = *reinterpret_cast<const float2*>(&S.row[0][2][col]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = prob(s[4 * j + e], a.scale, bias[e >> 1],
                             (e & 1) ? mm.y : mm.x, (e & 1) ? ll.y : ll.x);
        s[4 * j + e] = p;  // P^T
        dp[4 * j + e] =
            __fmul_rn(p, __fsub_rn(dp[4 * j + e], (e & 1) ? cc.y : cc.x));
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&S.empty[0]);
    uint32_t ph[8][4], pl[8][4], dh[8][4], dl[8][4];  // P^T, dS^T split
    split_a(s, ph, pl);
    split_a(dp, dh, dl);

    mbar_wait(&S.full[1], it & 1);
    fence_acc(dv);
    fence_acc(dk);
    wgmma_fence();
    // dV += P^T dO (B: dO^T), dK += dS^T Q (B: Q^T)
    product_pv(dv, ph, pl, smem_desc(S.str[1][1][0]),
               smem_desc(S.str[1][1][1]));
    product_pv(dk, dh, dl, smem_desc(S.str[1][0][0]),
               smem_desc(S.str[1][0][1]));
    wgmma_commit();
    wgmma_wait();
    fence_acc(dv);
    fence_acc(dk);
    __syncwarp();
    if (lane == 0) mbar_arrive(&S.empty[1]);
  }
  store_tile(dv, {1.f, 1.f}, a.out[2], a.os[2], b, h, k0, a.nk);
  store_tile(dk, {a.scale, a.scale}, a.out[1], a.os[1], b, h, k0, a.nk);
}

// dQ block (kC false): the warpgroup owns queries q0 .. q0 + 63 (Q, dO
// resident) and loops over the ntiles 64-key tiles: step 1 (slot 0) K, V
// and the keys' bias; step 2 (slot 1) K^T. The c pass (kC true) is the
// same block without step 2: K, V tiles alternate between the slots, and
// it sums P o dP over each row's keys and writes the row's c.
template <bool kC>
__device__ __forceinline__ void bwd_queries(BwdShared& S, const BwdArgs& a,
                                            int q0, int h, int b,
                                            int ntiles) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  // the statistics of the thread's queries, rows g and g + 8 of the warp;
  // past the last query P = 0. The c pass sums into c, lost carrying the
  // compensation
  float m[2], il[2], c[2], lost[2] = {0.f, 0.f};
  const long long row0 = ((long long)b * a.H + h) * a.nq;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int n = q0 + 16 * warp + g + 8 * hr;
    const bool in = n < a.nq;
    m[hr] = in ? a.m[row0 + n] : INFINITY;
    il[hr] = in ? 1.f / a.l[row0 + n] : 0.f;
    c[hr] = in && !kC ? a.c[row0 + n] : 0.f;
  }
  const uint64_t qh = smem_desc(S.res[0][0]), ql = smem_desc(S.res[0][1]);
  const uint64_t oh = smem_desc(S.res[1][0]), ol = smem_desc(S.res[1][1]);
  [[maybe_unused]] float dq[32];
  if constexpr (!kC) {
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[i] = 0.f;
  }
  mbar_wait(&S.resbar, 0);

  for (int it = 0; it < ntiles; ++it) {
    const int u = kC ? it : 2 * it, st = u % 2;
    mbar_wait(&S.full[st], (u / 2) & 1);
    float s[32], dp[32];  // S = Q K^T (D's order), dP = dO V^T
    wgmma_fence();
    product_qk(s, qh, ql, smem_desc(S.str[st][0][0]),
               smem_desc(S.str[st][0][1]));
    product_qk(dp, oh, ol, smem_desc(S.str[st][1][0]),
               smem_desc(S.str[st][1][1]));
    wgmma_commit();
    wgmma_wait();
    fence_acc(s);
    fence_acc(dp);

    // s[4j + e]: query row g + 8 (e >> 1), key 8j + 2t + (e & 1)
    [[maybe_unused]] float part[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 bb =
          *reinterpret_cast<const float2*>(&S.row[st][0][8 * j + 2 * t]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hr = e >> 1;
        const float p = prob(s[4 * j + e], a.scale, (e & 1) ? bb.y : bb.x,
                             m[hr], il[hr]);
        if constexpr (kC)
          part[hr] = fmaf(p, dp[4 * j + e], part[hr]);
        else
          s[4 * j + e] = __fmul_rn(p, __fsub_rn(dp[4 * j + e], c[hr]));  // dS
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&S.empty[st]);
    if constexpr (kC) {
      // the tile's part of a row over its quad (every lane the same sum),
      // added to c compensated
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float x = part[hr];
        x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 1));
        x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 2));
        const float y = __fsub_rn(x, lost[hr]);
        const float sum = __fadd_rn(c[hr], y);
        lost[hr] = __fsub_rn(__fsub_rn(sum, c[hr]), y);
        c[hr] = sum;
      }
    } else {
      uint32_t dh[8][4], dl[8][4];  // dS split
      split_a(s, dh, dl);
      mbar_wait(&S.full[1], it & 1);
      fence_acc(dq);
      wgmma_fence();
      // dQ += dS K (B: K^T)
      product_pv(dq, dh, dl, smem_desc(S.str[1][0][0]),
                 smem_desc(S.str[1][0][1]));
      wgmma_commit();
      wgmma_wait();
      fence_acc(dq);
      __syncwarp();
      if (lane == 0) mbar_arrive(&S.empty[1]);
    }
  }
  if constexpr (kC) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int n = q0 + 16 * warp + g + 8 * hr;
      if (t == 0 && n < a.nq) a.c[row0 + n] = c[hr];
    }
  } else {
    store_tile(dq, {a.scale, a.scale}, a.out[0], a.os[0], b, h, q0, a.nq);
  }
}

// Block x = a.x0 + blockIdx.x of problem (blockIdx.z, blockIdx.y): in the
// main launch (kC false) a dK/dV block if x < a.nkb, otherwise a dQ block;
// in the c pass (kC true, a.x0 = a.nkb) a c block.
template <bool kC>
__device__ __forceinline__ void bwd_block(const BwdMaps& t,
                                          const BwdArgs& a) {
  auto& S = sm90::shared_as<BwdShared>();
  const int x = a.x0 + (int)blockIdx.x;
  const bool keys = !kC && x < a.nkb;
  const int r0 = 64 * (keys ? x : x - a.nkb);
  const int h = blockIdx.y, b = blockIdx.z;
  const int ntiles = ((keys ? a.nq : a.nk) + kBK - 1) / kBK;
  const int nsteps = kC ? 1 : 2;  // loads a tile
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(&S.full[s], 32);  // the producer warp's lanes
      mbar_init(&S.empty[s], 4);  // one lane of each consumer warp
    }
    mbar_init(&S.resbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {
    // ---- producer: the resident planes once, then each tile's steps
    // through the two slots, the per-row floats with the first
    if (lane == 0) {
      mbar_arrive_tx(&S.resbar, 4 * kPlaneBytes);
      for (int p = 0; p < 2; ++p) {
        load_plane(S.res[0][p], keys ? t.k : t.q, 0, r0, p, h, b, &S.resbar);
        load_plane(S.res[1][p], keys ? t.v : t.dout, 0, r0, p, h, b,
                   &S.resbar);
      }
    }
    const long long row0 = ((long long)b * a.H + h) * a.nq;
    const float* bias = a.bias + (long long)b * a.nk;
    for (int it = 0; it < ntiles; ++it) {
      for (int step = 0; step < nsteps; ++step) {
        const int u = it * nsteps + step, st = u % 2;
        mbar_wait(&S.empty[st], ((u / 2) & 1) ^ 1);
        if (step == 0) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 2 * lane + e, n = it * kBK + i;
            if (keys) {
              const bool in = n < a.nq;
              S.row[st][0][i] = in ? a.m[row0 + n] : INFINITY;
              S.row[st][1][i] = in ? 1.f / a.l[row0 + n] : 0.f;
              S.row[st][2][i] = in ? a.c[row0 + n] : 0.f;
            } else {
              S.row[st][0][i] = n < a.nk ? bias[n] : -INFINITY;
            }
          }
        }
        if (lane == 0) {
          // step 1: the row planes of Q, dO (dK/dV) or K, V; step 2: the
          // transposed planes of Q, dO (dK/dV) or K alone
          const int nops = step == 1 && !keys ? 1 : 2;
          mbar_arrive_tx(&S.full[st], 2 * nops * kPlaneBytes);
          for (int p = 0; p < 2; ++p) {
            if (step == 0) {
              load_plane(S.str[st][0][p], keys ? t.q : t.k, 0, it * kBK, p,
                         h, b, &S.full[st]);
              load_plane(S.str[st][1][p], keys ? t.dout : t.v, 0, it * kBK,
                         p, h, b, &S.full[st]);
            } else {
              load_plane(S.str[st][0][p], keys ? t.qt : t.kt, it * kBK, 0, p,
                         h, b, &S.full[st]);
              if (keys)
                load_plane(S.str[st][1][p], t.dot, it * kBK, 0, p, h, b,
                           &S.full[st]);
            }
          }
        } else {
          mbar_arrive(&S.full[st]);
        }
      }
    }
  } else if (keys) {
    bwd_keys(S, a, r0, h, b, ntiles);
  } else {
    bwd_queries<kC>(S, a, r0, h, b, ntiles);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    attention_bwd_tf32_kernel(const __grid_constant__ BwdMaps t,
                              const BwdArgs a) {
  bwd_block<false>(t, a);
}

__global__ void __launch_bounds__(kThreads, 1)
    attention_bwd_rowsum_tf32_kernel(const __grid_constant__ BwdMaps t,
                                     const BwdArgs a) {
  bwd_block<true>(t, a);
}

}  // namespace tf32

// ---------------------------------------------------------------------------
// bfloat16 instance: the Hopper loop
// ---------------------------------------------------------------------------

namespace sm90 {

// One consumer warpgroup a block, two blocks an SM: 128 entry registers a
// thread (__launch_bounds__), and the consumers take 232 = 2 x 128 - 24
// after the producer warpgroup gives its own back, room for dK and dV
// (64 floats) beside a whole 64-query tile's S^T and dP^T (64 floats).
struct BwdConfig {
  static constexpr int nwg = 1, threads = 256, min_blocks = 2,
                       consumer_regs = 232;
};
// The c pass's blocks are dQ blocks without the dQ product, at the same
// counts; a type of its own, as `configure` keeps one kernel's result a
// type.
struct BwdRowsumConfig : BwdConfig {};

struct BwdShared {
  __nv_bfloat16 res[2][64 * kD];       // resident: K, V or Q, dO (1024-
  __nv_bfloat16 a[kStages][64 * kD];   // byte aligned tiles); streamed:
  __nv_bfloat16 b[kStages][64 * kD];   // Q, dO (dK/dV) or K, V (dQ)
  // dK/dV: the streamed queries' m, 1/l and c; dQ and c pass: the keys'
  // bias in [0]
  float row[kStages][3][64];
  uint64_t full[kStages], empty[kStages], resbar;
};
constexpr size_t kBwdSmem = sizeof(BwdShared) + 1024;

struct BwdArgs {
  const float* bias;  // (B, nk) float32
  const float* m;     // (B, H, nq) float32 row max
  const float* l;     // (B, H, nq) float32 row sum of exp(s - m)
  float* c;           // (B, H, nq) float32 rowsum(dP o P): the c pass
                      // writes it, the main launch reads it
  __nv_bfloat16* out[3];  // dq (B, H, nq, 64), dk, dv (B, H, nk, 64)
  long long os[3][3];     // their (b, h, n) element strides; d unit
  int H, nq, nk, nkb;     // nkb: the dK/dV blocks of a (b, h) problem
  int x0;                 // block x0 + blockIdx.x is the block's index
  float scale;
};

// dK/dV block: the warpgroup owns keys k0 .. k0 + 63 (K, V resident) and
// loops over the ntiles streamed 64-query tiles of Q and dO.
__device__ __forceinline__ void bwd_keys(BwdShared& S, const BwdArgs& a,
                                         int k0, int h, int b, int ntiles) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  float bias[2];  // of the thread's keys, rows g and g + 8 of the warp
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int key = k0 + 16 * warp + g + 8 * hr;
    bias[hr] = key < a.nk ? a.bias[(long long)b * a.nk + key] : -INFINITY;
  }
  const uint64_t dk_t = smem_desc(S.res[0]), dv_t = smem_desc(S.res[1]);
  float dk[32], dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
  mbar_wait(&S.resbar, 0);

  for (int it = 0; it < ntiles; ++it) {
    const int st = it % kStages;
    mbar_wait(&S.full[st], (it / kStages) & 1);
    const uint64_t dq_t = smem_desc(S.a[st]), ddo_t = smem_desc(S.b[st]);
    float s[32], dp[32];  // S^T = K Q^T, dP^T = V dO^T: keys x queries
    wgmma_fence();
    product_ss(s, dk_t, dq_t);
    product_ss(dp, dv_t, ddo_t);
    wgmma_commit();
    wgmma_wait();
    fence_acc(s);
    fence_acc(dp);

    // s[4j + e]: key row g + 8 (e >> 1), query 8j + 2t + (e & 1)
    const float* m = S.row[st][0];
    const float* il = S.row[st][1];
    const float* cr = S.row[st][2];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + 2 * t;
      const float2 mm = *reinterpret_cast<const float2*>(m + col);
      const float2 ll = *reinterpret_cast<const float2*>(il + col);
      const float2 cc = *reinterpret_cast<const float2*>(cr + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = __fadd_rn(__fmul_rn(s[4 * j + e], a.scale),
                                  bias[e >> 1]);
        const float p = __fmul_rn(exp_diff(x, (e & 1) ? mm.y : mm.x),
                                  (e & 1) ? ll.y : ll.x);
        s[4 * j + e] = p;  // P^T
        dp[4 * j + e] =
            __fmul_rn(p, __fsub_rn(dp[4 * j + e], (e & 1) ? cc.y : cc.x));
      }
    }
    uint32_t pa[4][4], da[4][4];  // P^T and dS^T in bf16
    a_operand(s, pa);
    a_operand(dp, da);

    fence_acc(dv);
    fence_acc(dk);
    wgmma_fence();
    product_rs(dv, pa, ddo_t);  // dV += P^T dO
    product_rs(dk, da, dq_t);   // dK += dS^T Q
    wgmma_commit();
    wgmma_wait();
    fence_acc(dv);
    fence_acc(dk);
    __syncwarp();
    if (lane == 0) mbar_arrive(&S.empty[st]);
  }
  store_tile(dv, {1.f, 1.f}, a.out[2], a.os[2], b, h, k0, a.nk);
  store_tile(dk, {a.scale, a.scale}, a.out[1], a.os[1], b, h, k0, a.nk);
}

// dQ block (kC false): the warpgroup owns queries q0 .. q0 + 63 (Q, dO
// resident) and loops over the ntiles streamed 64-key tiles of K and V.
// The c pass (kC true) is the same block without the dQ product: it sums
// P o dP over each row's keys in float32 and writes the row's c.
template <bool kC>
__device__ __forceinline__ void bwd_queries(BwdShared& S, const BwdArgs& a,
                                            int q0, int h, int b,
                                            int ntiles) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  // the statistics of the thread's queries, rows g and g + 8 of the warp;
  // past the last query P = 0. The c pass starts c at 0 and sums the
  // thread's part of the row into it
  float m[2], il[2], c[2];
  const long long row0 = ((long long)b * a.H + h) * a.nq;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int n = q0 + 16 * warp + g + 8 * hr;
    const bool in = n < a.nq;
    m[hr] = in ? a.m[row0 + n] : INFINITY;
    il[hr] = in ? 1.f / a.l[row0 + n] : 0.f;
    c[hr] = in && !kC ? a.c[row0 + n] : 0.f;
  }
  const uint64_t dq_t = smem_desc(S.res[0]), ddo_t = smem_desc(S.res[1]);
  float dq[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[i] = 0.f;
  mbar_wait(&S.resbar, 0);

  for (int it = 0; it < ntiles; ++it) {
    const int st = it % kStages;
    mbar_wait(&S.full[st], (it / kStages) & 1);
    const uint64_t dk_t = smem_desc(S.a[st]), dv_t = smem_desc(S.b[st]);
    float s[32], dp[32];  // S = Q K^T, dP = dO V^T: queries x keys
    wgmma_fence();
    product_ss(s, dq_t, dk_t);
    product_ss(dp, ddo_t, dv_t);
    wgmma_commit();
    wgmma_wait();
    fence_acc(s);
    fence_acc(dp);

    // s[4j + e]: query row g + 8 (e >> 1), key 8j + 2t + (e & 1)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 bb =
          *reinterpret_cast<const float2*>(&S.row[st][0][8 * j + 2 * t]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hr = e >> 1;
        const float x = __fadd_rn(__fmul_rn(s[4 * j + e], a.scale),
                                  (e & 1) ? bb.y : bb.x);
        const float p = __fmul_rn(exp_diff(x, m[hr]), il[hr]);
        if constexpr (kC)
          c[hr] = fmaf(p, dp[4 * j + e], c[hr]);
        else
          s[4 * j + e] = __fmul_rn(p, __fsub_rn(dp[4 * j + e], c[hr]));  // dS
      }
    }
    if constexpr (!kC) {
      uint32_t da[4][4];
      a_operand(s, da);

      fence_acc(dq);
      wgmma_fence();
      product_rs(dq, da, dk_t);  // dQ += dS K
      wgmma_commit();
      wgmma_wait();
      fence_acc(dq);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&S.empty[st]);
  }
  if constexpr (kC) {
    // a row's keys live in the four lanes of a quad
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      c[hr] += __shfl_xor_sync(0xffffffffu, c[hr], 1);
      c[hr] += __shfl_xor_sync(0xffffffffu, c[hr], 2);
      const int n = q0 + 16 * warp + g + 8 * hr;
      if (t == 0 && n < a.nq) a.c[row0 + n] = c[hr];
    }
  } else {
    store_tile(dq, {a.scale, a.scale}, a.out[0], a.os[0], b, h, q0, a.nq);
  }
}

// Block x = a.x0 + blockIdx.x of problem (blockIdx.z, blockIdx.y): in the
// main launch (kC false) a dK/dV block if x < a.nkb, otherwise a dQ block;
// in the c pass (kC true, a.x0 = a.nkb) a c block. tq, tdo: (64, nq, H, B)
// maps; tk, tv: (64, nk, H, B).
template <bool kC>
__device__ __forceinline__ void bwd_block(const CUtensorMap& tq,
                                          const CUtensorMap& tk,
                                          const CUtensorMap& tv,
                                          const CUtensorMap& tdo,
                                          const BwdArgs& a) {
  auto& S = shared_as<BwdShared>();
  const int x = a.x0 + (int)blockIdx.x;
  const bool keys = !kC && x < a.nkb;
  const int r0 = 64 * (keys ? x : x - a.nkb);
  const int h = blockIdx.y, b = blockIdx.z;
  const int ntiles = ((keys ? a.nq : a.nk) + 63) / 64;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&S.full[s], 32);  // the producer warp's lanes
      mbar_init(&S.empty[s], 4);  // one lane of each consumer warp
    }
    mbar_init(&S.resbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4) {
    // ---- producer: the resident tiles once, then the ring of streamed
    // tiles with their per-row floats; the warpgroup gives its registers
    // back, and its first warp works
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kProducerRegs));
    if (warp != 4) return;
    const CUtensorMap& res0 = keys ? tk : tq;
    const CUtensorMap& res1 = keys ? tv : tdo;
    const CUtensorMap& str0 = keys ? tq : tk;
    const CUtensorMap& str1 = keys ? tdo : tv;
    if (lane == 0) {
      mbar_arrive_tx(&S.resbar, 2 * kTileBytes);
      tma_load(S.res[0], res0, r0, h, b, &S.resbar);
      tma_load(S.res[1], res1, r0, h, b, &S.resbar);
    }
    const long long row0 = ((long long)b * a.H + h) * a.nq;
    const float* bias = a.bias + (long long)b * a.nk;
    for (int it = 0; it < ntiles; ++it) {
      const int st = it % kStages;
      mbar_wait(&S.empty[st], ((it / kStages) & 1) ^ 1);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 2 * lane + e, n = it * 64 + i;
        if (keys) {
          const bool in = n < a.nq;
          S.row[st][0][i] = in ? a.m[row0 + n] : INFINITY;
          S.row[st][1][i] = in ? 1.f / a.l[row0 + n] : 0.f;
          S.row[st][2][i] = in ? a.c[row0 + n] : 0.f;
        } else {
          S.row[st][0][i] = n < a.nk ? bias[n] : -INFINITY;
        }
      }
      if (lane == 0) {
        mbar_arrive_tx(&S.full[st], 2 * kTileBytes);
        tma_load(S.a[st], str0, it * 64, h, b, &S.full[st]);
        tma_load(S.b[st], str1, it * 64, h, b, &S.full[st]);
      } else {
        mbar_arrive(&S.full[st]);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        BwdConfig::consumer_regs));
    if (keys)
      bwd_keys(S, a, r0, h, b, ntiles);
    else
      bwd_queries<kC>(S, a, r0, h, b, ntiles);
  }
}

__global__ void __launch_bounds__(BwdConfig::threads, BwdConfig::min_blocks)
    attention_bwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tdo,
                              const BwdArgs a) {
  bwd_block<false>(tq, tk, tv, tdo, a);
}

__global__ void __launch_bounds__(BwdConfig::threads, BwdConfig::min_blocks)
    attention_bwd_rowsum_kernel(const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv,
                                const __grid_constant__ CUtensorMap tdo,
                                const BwdArgs a) {
  bwd_block<true>(tq, tk, tv, tdo, a);
}

}  // namespace sm90
}  // namespace ei

// float32: the c pass and the 3xTF32 loop over the planes the pack pass
// (ei_attention_pack_tf32) wrote: `planes` holds 7 pointers, the row
// planes of q (B, H, 2, N, 64), k, v (B, H, 2, M, 64) and dO
// (B, H, 2, N, 64), then the transposed planes of q (B, H, 2, 64, N
// rounded up to 64), k (.., M rounded up) and dO (.., N rounded up);
// bias: (B, M) float32 contiguous; stats: (2, B, H, N) float32 contiguous
// (row max, row sum); c: (B, H, N) float32 scratch; dq: (B, H, N, 64),
// dk, dv: (B, H, M, 64) float32 through `out_strides` (9: dq, dk, dv, each
// (b, h, n); d unit); blocks: the block kinds of the main launch (bit 0
// the dK/dV blocks, bit 1 the dQ blocks; 3 for the gradients, one alone
// to time it; the c pass runs always). Returns 0, a CUDA error code or
// one of ei::sm90's kErr* codes.
extern "C" int ei_attention_bwd_tf32(const long long* planes,
                                     const float* bias, const float* stats,
                                     float* c, void* dq, void* dk, void* dv,
                                     const long long* out_strides, int B,
                                     int H, int N, int M, float scale,
                                     int blocks, void* stream) {
  using namespace ei::tf32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  BwdArgs a{};
  a.nkb = (M + kBK - 1) / kBK;
  const int nqb = (N + kBK - 1) / kBK;
  const int nx = ((blocks & 1) ? a.nkb : 0) + ((blocks & 2) ? nqb : 0);
  if (nx == 0) return (int)cudaErrorInvalidValue;
  const float* p[7];
  for (int i = 0; i < 7; ++i) p[i] = reinterpret_cast<const float*>(planes[i]);
  BwdMaps t;
  int err = row_map(&t.q, p[0], N, H, B);
  if (err == 0) err = row_map(&t.k, p[1], M, H, B);
  if (err == 0) err = row_map(&t.v, p[2], M, H, B);
  if (err == 0) err = row_map(&t.dout, p[3], N, H, B);
  if (err == 0) err = value_map(&t.qt, p[4], N, H, B);
  if (err == 0) err = value_map(&t.kt, p[5], M, H, B);
  if (err == 0) err = value_map(&t.dot, p[6], N, H, B);
  if (err != 0) return err;
  // once a process: the two kernels' dynamic shared memory limit
  static const int rowsum_status = (int)cudaFuncSetAttribute(
      reinterpret_cast<const void*>(attention_bwd_rowsum_tf32_kernel),
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kBwdSmemBytes);
  static const int loop_status = (int)cudaFuncSetAttribute(
      reinterpret_cast<const void*>(attention_bwd_tf32_kernel),
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kBwdSmemBytes);
  if (rowsum_status != 0) return rowsum_status;
  if (loop_status != 0) return loop_status;
  a.bias = bias;
  a.m = stats;
  a.l = stats + (long long)B * H * N;
  a.c = c;
  void* outs[3] = {dq, dk, dv};
  for (int i = 0; i < 3; ++i) {
    a.out[i] = static_cast<float*>(outs[i]);
    for (int j = 0; j < 3; ++j) a.os[i][j] = out_strides[3 * i + j];
  }
  a.H = H;
  a.nq = N;
  a.nk = M;
  a.scale = scale;
  // the c pass: one block a 64-query tile, block x = nkb + blockIdx.x
  a.x0 = a.nkb;
  attention_bwd_rowsum_tf32_kernel<<<dim3(nqb, H, B), kThreads,
                                     kBwdSmemBytes, s>>>(t, a);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  a.x0 = (blocks & 1) ? 0 : a.nkb;
  attention_bwd_tf32_kernel<<<dim3(nx, H, B), kThreads, kBwdSmemBytes, s>>>(
      t, a);
  return (int)cudaGetLastError();
}

// bfloat16: the pack pass (where the operand plan asks for it), the c pass
// and the Hopper loop. ops: q, k, v, dO as 4 x 8 long longs
// (ei::sm90::read_operand); bias: (B, M) float32 contiguous; stats:
// (2, B, H, N) float32 contiguous (row max, row sum); c: (B, H, N) float32
// scratch; dq: (B, H, N, 64), dk, dv: (B, H, M, 64) bf16 through
// `out_strides` (9: dq, dk, dv, each (b, h, n); d unit); blocks: the block
// kinds of the main launch to run (bit 0 the dK/dV blocks, bit 1 the dQ
// blocks; 3 for the gradients, one alone to time it; the c pass runs
// always). Returns 0, a CUDA error code or one of ei::sm90's kErr* codes.
extern "C" int ei_attention_bwd_sm90(const long long* ops, const float* bias,
                                     const float* stats, float* c, void* dq,
                                     void* dk, void* dv,
                                     const long long* out_strides, int B,
                                     int H, int N, int M, float scale,
                                     int blocks, void* stream) {
  using namespace ei::sm90;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  BwdArgs a{};
  a.nkb = (M + 63) / 64;
  const int nqb = (N + 63) / 64;
  const int nx = ((blocks & 1) ? a.nkb : 0) + ((blocks & 2) ? nqb : 0);
  if (nx == 0) return (int)cudaErrorInvalidValue;

  Operand90 op[4];
  const int rows[4] = {N, M, M, N};
  int err = pack_operands(op, ops, rows, 4, 0, nullptr, nullptr, B, H, s);
  if (err != 0) return err;
  CUtensorMap maps[4];
  for (int i = 0; i < 4; ++i) {
    err = operand_map(&maps[i], op[i], rows[i], H, B);
    if (err != 0) return err;
  }
  err = configure<BwdRowsumConfig>(
      reinterpret_cast<const void*>(attention_bwd_rowsum_kernel), kBwdSmem);
  if (err != 0) return err;
  err = configure<BwdConfig>(
      reinterpret_cast<const void*>(attention_bwd_sm90_kernel), kBwdSmem);
  if (err != 0) return err;
  a.bias = bias;
  a.m = stats;
  a.l = stats + (long long)B * H * N;
  a.c = c;
  void* outs[3] = {dq, dk, dv};
  for (int i = 0; i < 3; ++i) {
    a.out[i] = static_cast<__nv_bfloat16*>(outs[i]);
    for (int j = 0; j < 3; ++j) a.os[i][j] = out_strides[3 * i + j];
  }
  a.H = H;
  a.nq = N;
  a.nk = M;
  a.scale = scale;
  // the c pass: one block a 64-query tile, block x = nkb + blockIdx.x
  a.x0 = a.nkb;
  attention_bwd_rowsum_kernel<<<dim3(nqb, H, B), BwdConfig::threads,
                                kBwdSmem, s>>>(maps[0], maps[1], maps[2],
                                               maps[3], a);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  a.x0 = (blocks & 1) ? 0 : a.nkb;
  attention_bwd_sm90_kernel<<<dim3(nx, H, B), BwdConfig::threads, kBwdSmem,
                              s>>>(maps[0], maps[1], maps[2], maps[3], a);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of one block of the bf16 backward, for the build
// report.
extern "C" long long ei_bwd_sm90_smem_bytes() {
  return (long long)ei::sm90::kBwdSmem;
}

// Dynamic shared memory of one block of the float32 backward, for the
// build report.
extern "C" long long ei_bwd_tf32_smem_bytes() {
  return (long long)ei::tf32::kBwdSmemBytes;
}
