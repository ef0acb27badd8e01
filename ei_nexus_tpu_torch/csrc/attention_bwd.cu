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
// d=64, bf16) the five products are 21.5 GFLOP against ~34 MB of inputs and
// outputs, so it is compute-bound (~22 us at 989 TFLOP/s).
//
// Design. Hopper blocks run in no order, so nothing carries from one block
// to the next, and the TPU kernel's per-problem sums become blocks that
// each own their outputs (no atomics, so the sums are the same from run to
// run), in two launches:
//  - the c pass: blocks own 64 queries and loop over 64-key tiles: S = Q
//    K^T and dP = dO V^T, P = exp(S - m) / l from the forward's row
//    statistics (the TPU's pass-1 m and Z), c += P o dP in float32, summed
//    over the row's threads and written once a row. c is the TPU kernel's
//    rowsum(dP o P) from these same P and dP; FlashAttention-2's
//    rowsum(dO o O) would read O rounded to bf16, and where a row's value
//    rows nearly coincide (or its softmax is one-hot) dP - c cancels below
//    that rounding, which then rules dQ and dK;
//  - the main launch, two kinds of block: dK/dV blocks own 64 keys and
//    loop over 64-query tiles: S^T = K Q^T and dP^T = V dO^T, P^T =
//    exp(S^T - m) / l (not a softmax of S^T), dV += P^T dO, dK += dS^T Q;
//    dQ blocks own 64 queries and loop over 64-key tiles: S, P, dP, dS as
//    above, dQ += dS K.
// So S and dP are computed three times (nine products instead of five),
// the price of independent blocks: every dK/dV block needs the c of all
// queries before its first tile. (The other order, dQ blocks taking c in a
// first sweep of their keys and the dK/dV blocks in a launch of their
// own, costs the same products and serialises the two block kinds.) P is
// rebuilt from the row max m and the row sum l that kernel D saves, with
// s - m formed before anything else, so a fully masked row (every score
// -1e9) gets P = 1/M as the plain version does.
//  - bfloat16 (the main path): the Hopper machinery of flash_sm90.cuh. A
//    block is one consumer warpgroup on wgmma and a producer warpgroup
//    that gives its registers back; the producer loads the block's two
//    resident tiles once (K, V or Q, dO) and streams the other two by TMA
//    in a 3-stage ring, writing each tile's per-row floats beside it: the
//    streamed queries' m, 1/l and c (past the last query m = +inf, 1/l =
//    0, so P = 0), or the streamed keys' bias (-inf past the last key).
//    S^T, dP^T, S and dP are wgmma_ss products (both operands K-major from
//    shared memory); P^T and dS^T (or dS) are formed in the accumulators,
//    rounded to bf16 where the plain version rounds them, and enter
//    dV += P^T dO, dK += dS^T Q and dQ += dS K as the register A operand,
//    the streamed tile serving as the transposed (MN-major) B operand, as V
//    does in the forward loop. The c pass is a dQ block without the dQ
//    product. Operands the TMA cannot read in place (the stride-3 v of
//    SelfBlock's Wqkv split) are packed first, once for both launches; the
//    rotated q and k and dO are read in place.
//    D's row max and sum fit P here: S comes from the same wgmma
//    products as in D's loop, so sum_j P_ij is 1 to l's rounding.
//  - float32 (comparisons): one warp per row on the CUDA cores, each score
//    summed in kernel D's order, c in a first sweep of each query row's
//    keys (its own launch), then dQ rows sweeping them again and dK/dV
//    rows sweeping the queries.
#include "flash_attention.cuh"
#include "flash_sm90.cuh"

namespace ei {

struct BwdProblem {
  Operand q, k, v, dout;  // (B, h, N|M, d) through strides
  const float* bias;      // (B, nk) additive key-side bias
  const float* m;         // (B, heads, nq) forward row max
  const float* l;         // (B, heads, nq) forward row sum of exp(s - m)
  float* c;               // (B, heads, nq) scratch: rowsum(dP o P)
  Output dq, dk, dv;
  int heads, nq, nk;
  float scale;
};

template <typename T>
__device__ __forceinline__ const T* row_ptr(const Operand& a, int b, int h,
                                            int n) {
  return static_cast<const T*>(a.ptr) + b * a.sb + h * a.sh + n * a.sn;
}

template <typename T>
__device__ __forceinline__ T* out_row(const Output& a, int b, int h, int n) {
  return static_cast<T*>(a.ptr) + b * a.sb + h * a.sh + n * a.sn;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// The warp lane's d of the float32 rows: lane (i = 0) and lane + 32 (i = 1).
__device__ __forceinline__ int lane_d(int i) {
  return threadIdx.x % 32 + 32 * i;
}

// ---------------------------------------------------------------------------
// float32 instance: one warp per row, lane l holding d = l, l + 32
// ---------------------------------------------------------------------------

// The score q . k of two rows summed as kernel D's float32 loop sums it
// (fused multiply-adds over d = 0 .. 63 in order; every lane alike), so
// that D's row max and row sum fit these scores bit for bit: in another
// order the scores move by ~1e-5 and sum_j P_ij leaves 1 by as much, which
// c = rowsum(dP o P) carries into dP - c, more than dP - c itself where a
// softmax row is one-hot.
__device__ __forceinline__ float score(const float* q, long long qd,
                                       const float* k, long long kd) {
  float s = 0.f;
#pragma unroll 8
  for (int d = 0; d < 64; ++d) s = fmaf(q[d * qd], k[d * kd], s);
  return s;
}

// P and dP of query row q (b, h) at key j (the lanes' dO values g0, g1; the
// row's statistics m, l); the key's lane values back in k0, k1.
__device__ __forceinline__ float2 p_dp(const BwdProblem& p, int b, int h,
                                       int j, const float* q, float g0,
                                       float g1, float m, float l, float& k0,
                                       float& k1) {
  const float* k = row_ptr<float>(p.k, b, h, j);
  const float* v = row_ptr<float>(p.v, b, h, j);
  k0 = k[lane_d(0) * p.k.sd];
  k1 = k[lane_d(1) * p.k.sd];
  const float s = score(q, p.q.sd, k, p.k.sd);
  const float dp = warp_sum(g0 * v[lane_d(0) * p.v.sd] +
                            g1 * v[lane_d(1) * p.v.sd]);
  const float x =
      __fadd_rn(__fmul_rn(s, p.scale), p.bias[(long long)b * p.nk + j]);
  return make_float2(__fdiv_rn(expf(__fsub_rn(x, m)), l), dp);
}

// The c pass: c[b, h, i] = sum_j P_ij dP_ij in float32, one warp a query
// row sweeping its keys. The sum is compensated (Kahan): dP - c cancels on
// the inputs where c matters, and a running sum over M keys would carry
// ~sqrt(M) roundings into it.
__global__ void __launch_bounds__(256) bwd_rowsum_kernel(const BwdProblem p,
                                                         int B) {
  const long long w = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  if (w >= (long long)B * p.heads * p.nq) return;
  const int i = (int)(w % p.nq);
  const int h = (int)((w / p.nq) % p.heads);
  const int b = (int)(w / ((long long)p.nq * p.heads));
  const float* q = row_ptr<float>(p.q, b, h, i);
  const float* g = row_ptr<float>(p.dout, b, h, i);
  const float g0 = g[lane_d(0) * p.dout.sd], g1 = g[lane_d(1) * p.dout.sd];
  const float m = p.m[w], l = p.l[w];
  float c = 0.f, lost = 0.f, k0, k1;
  for (int j = 0; j < p.nk; ++j) {
    const float2 pd = p_dp(p, b, h, j, q, g0, g1, m, l, k0, k1);
    const float y = __fsub_rn(__fmul_rn(pd.x, pd.y), lost);
    const float t = __fadd_rn(c, y);
    lost = __fsub_rn(__fsub_rn(t, c), y);
    c = t;
  }
  if (threadIdx.x % 32 == 0) p.c[w] = c;
}

// dQ rows (a second sweep of the keys), then dK and dV rows (a sweep of
// the queries), reading the c pass's c.
__global__ void __launch_bounds__(256) bwd_rows_kernel(const BwdProblem p,
                                                       int B) {
  using T = float;
  long long w = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int d0 = lane_d(0), d1 = lane_d(1);
  const long long q_rows = (long long)B * p.heads * p.nq;
  const long long k_rows = (long long)B * p.heads * p.nk;
  if (w < q_rows) {
    // dQ row i: loop over the keys
    const int i = (int)(w % p.nq);
    const int h = (int)((w / p.nq) % p.heads);
    const int b = (int)(w / ((long long)p.nq * p.heads));
    const T* q = row_ptr<T>(p.q, b, h, i);
    const T* g = row_ptr<T>(p.dout, b, h, i);
    const float g0 = g[d0 * p.dout.sd], g1 = g[d1 * p.dout.sd];
    const float m = p.m[w], l = p.l[w], c = p.c[w];
    float a0 = 0.f, a1 = 0.f, k0, k1;
    for (int j = 0; j < p.nk; ++j) {
      const float2 pd = p_dp(p, b, h, j, q, g0, g1, m, l, k0, k1);
      const float ds = __fmul_rn(pd.x, __fsub_rn(pd.y, c));
      a0 = fmaf(ds, k0, a0);
      a1 = fmaf(ds, k1, a1);
    }
    T* out = out_row<T>(p.dq, b, h, i);
    out[d0 * p.dq.sd] = a0 * p.scale;
    out[d1 * p.dq.sd] = a1 * p.scale;
    return;
  }
  w -= q_rows;
  if (w >= k_rows) return;
  // dK and dV row j: loop over the queries
  const int j = (int)(w % p.nk);
  const int h = (int)((w / p.nk) % p.heads);
  const int b = (int)(w / ((long long)p.nk * p.heads));
  const T* k = row_ptr<T>(p.k, b, h, j);
  const T* v = row_ptr<T>(p.v, b, h, j);
  const float v0 = v[d0 * p.v.sd], v1 = v[d1 * p.v.sd];
  const float bias = p.bias[(long long)b * p.nk + j];
  const long long r0 = ((long long)b * p.heads + h) * p.nq;
  float dv0 = 0.f, dv1 = 0.f, dk0 = 0.f, dk1 = 0.f;
  for (int i = 0; i < p.nq; ++i) {
    const T* q = row_ptr<T>(p.q, b, h, i);
    const T* g = row_ptr<T>(p.dout, b, h, i);
    const float q0 = q[d0 * p.q.sd], q1 = q[d1 * p.q.sd];
    const float g0 = g[d0 * p.dout.sd], g1 = g[d1 * p.dout.sd];
    const float s = score(q, p.q.sd, k, p.k.sd);
    const float dp = warp_sum(v0 * g0 + v1 * g1);
    const float x = __fadd_rn(__fmul_rn(s, p.scale), bias);
    const float pr = __fdiv_rn(expf(__fsub_rn(x, p.m[r0 + i])), p.l[r0 + i]);
    dv0 = fmaf(pr, g0, dv0);
    dv1 = fmaf(pr, g1, dv1);
    const float ds = __fmul_rn(pr, __fsub_rn(dp, p.c[r0 + i]));
    dk0 = fmaf(ds, q0, dk0);
    dk1 = fmaf(ds, q1, dk1);
  }
  T* dvo = out_row<T>(p.dv, b, h, j);
  T* dko = out_row<T>(p.dk, b, h, j);
  dvo[d0 * p.dv.sd] = dv0;
  dvo[d1 * p.dv.sd] = dv1;
  dko[d0 * p.dk.sd] = dk0 * p.scale;
  dko[d1 * p.dk.sd] = dk1 * p.scale;
}

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

// float32: q, dout: (B, H, N, 64); k, v: (B, H, M, 64), through
// `in_strides` (16 element strides: q, k, v, dout, each (b, h, n, d));
// bias: (B, M) float32 contiguous; stats: (2, B, H, N) float32 contiguous,
// kernel D's row max then row sum; c: (B, H, N) float32 scratch; dq:
// (B, H, N, 64), dk, dv: (B, H, M, 64) through `out_strides` (12: dq, dk,
// dv). Returns the CUDA error code of the launches (0 on success); bfloat16
// takes ei_attention_bwd_sm90.
extern "C" int ei_attention_bwd(int dtype, const void* q, const void* k,
                                const void* v, const void* dout,
                                const long long* in_strides,
                                const float* bias, const float* stats,
                                float* c, void* dq, void* dk, void* dv,
                                const long long* out_strides, int B, int H,
                                int N, int M, float scale, void* stream) {
  if (dtype != ei::kFloat32) return (int)cudaErrorInvalidValue;
  ei::BwdProblem p;
  p.q = ei::make_operand(q, in_strides);
  p.k = ei::make_operand(k, in_strides + 4);
  p.v = ei::make_operand(v, in_strides + 8);
  p.dout = ei::make_operand(dout, in_strides + 12);
  p.bias = bias;
  p.m = stats;
  p.l = stats + (long long)B * H * N;
  p.c = c;
  p.dq = ei::make_output(dq, out_strides);
  p.dk = ei::make_output(dk, out_strides + 4);
  p.dv = ei::make_output(dv, out_strides + 8);
  p.heads = H;
  p.nq = N;
  p.nk = M;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = (long long)B * H * N;
  ei::bwd_rowsum_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, s>>>(p, B);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const long long all = (long long)B * H * (N + M);
  ei::bwd_rows_kernel<<<(unsigned)((all + 7) / 8), 256, 0, s>>>(p, B);
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
