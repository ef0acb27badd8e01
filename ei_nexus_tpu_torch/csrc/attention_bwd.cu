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
// TFLOP/s in bf16, ~0.32 ms at float32's 67 TFLOP/s on the CUDA cores.
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
//    whose configs set no dtype, and the float32 evaluation entries), on
//    the CUDA cores with the operand tiles of kernel D's float32 loop
//    (flash_attention.cuh): 64-row tiles d-major in shared memory, read
//    through their strides as D reads them. Each score is D's float:
//    fused multiply-adds over d = 0 .. 63 in order, then x scale and
//    + bias rounded apart (D's row max and sum fit P only to ~1e-5 in
//    another order, and c = rowsum(dP o P) carries that into dP - c, more
//    than dP - c itself where a softmax row is one-hot). dP is summed the
//    same way on both sides, so both launches form the same P, dP and dS
//    of a (query, key) pair, bit for bit. Blocks of 256 threads; two
//    launches:
//    - query blocks: 64 queries, Q^T and dO^T resident, D's 16 x 16 grid
//      of 4 x 4 sub-tiles, every thread forming S, P and dP of its own
//      (the exponentials spread over the whole block). A first sweep of
//      the 64-key tiles (K^T, V^T streamed) sums c: P o dP over the
//      thread's keys, then over the row's 16 threads (a half-warp), then
//      across tiles compensated (Kahan), and writes c. A second sweep
//      forms them again, dS = P o (dP - c) as dS^T in a padded tile, and
//      dQ^T += K^T dS^T. Both sweeps' tiles come in one stream, each
//      fetched into registers while the block works on the one before;
//    - key blocks: 64 keys, K^T and V^T resident, sweeping 64-query tiles
//      (Q^T, dO^T and the queries' m, 1/l and c streamed) in two halves
//      of 128 threads, each forming one 64 x 64 product at a time in
//      4 x 8 sub-tiles (three 16-byte shared loads a d for 32 fused
//      multiply-adds, where 4 x 4 takes two for 16): one half S^T and P,
//      then dV^T += dO^T P; the other dP^T and dS, then dK^T += Q^T dS.
//    Five products in the first launch, four in the second. Past the last
//    key a score is -inf, past the last query m = +inf and 1/l = 0, so
//    P = 0.
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
__device__ __forceinline__ T* out_row(const Output& a, int b, int h, int n) {
  return static_cast<T*>(a.ptr) + b * a.sb + h * a.sh + n * a.sn;
}

// ---------------------------------------------------------------------------
// float32 instance: kernel D's tiles on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kTileF = kHD * kBQ;  // floats of a d-major 64-row tile
// dynamic shared memory (floats): query blocks Q^T, dO^T, K^T, V^T and the
// padded dS^T; key blocks K^T, V^T, Q^T, dO^T, the padded P and dS and the
// streamed queries' m, 1/l and c
constexpr int kBwdQueryFloats = 4 * kTileF + kBK * kPad;
constexpr int kBwdKeyFloats = 4 * kTileF + 2 * kBQ * kPad + 3 * kBQ;
static_assert(kBQ == kBK, "the float32 backward's tiles are square");
static_assert(kBQ * kHD == 16 * kThreads, "a tile is 4 pieces a thread");
constexpr int kHalf = kThreads / 2;  // a half-block (key blocks)

// A thread's share of rows [r0, r0 + 64) of operand `a` (load_tile's:
// piece e = threadIdx.x + 256 u is row e % 64, d = 4 (e / 64) .. + 3;
// zeros past n_rows) fetched into registers, so that the next tile's
// loads are in flight while the block works on this one ...
__device__ __forceinline__ void fetch_rows(const Operand& a, int b, int h,
                                           int r0, int n_rows,
                                           float (&t)[4][4]) {
  const Problem none{};  // no rotary: fetch4 reads only `a`
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int e = threadIdx.x + u * kThreads;
    fetch4<float, false>(none, a, b, h, r0 + e % kBQ, n_rows,
                         (e / kBQ) * 4, t[u]);
  }
}
// ... and stored d-major (dst[d * 64 + r]), as kernel D keeps its Q^T
// and K^T tiles.
__device__ __forceinline__ void put_rows(const float (&t)[4][4],
                                         float* dst) {
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int e = threadIdx.x + u * kThreads;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      dst[((e / kBQ) * 4 + j) * kBQ + e % kBQ] = t[u][j];
  }
}
__device__ __forceinline__ void load_rows(const Operand& a, int b, int h,
                                          int r0, int n_rows, float* dst) {
  float t[4][4];
  fetch_rows(a, b, h, r0, n_rows, t);
  put_rows(t, dst);
}

// A thread (ry, rx) of a grid of 16 x 64 / NC owns rows 4 ry .. 4 ry + 3
// and the NC columns col<NC>(rx, j) of a 64 x 64 product: 4 rx + j, and
// with NC = 8 also 32 + 4 rx + j - 4, so that the eight threads of a
// quarter-warp always read 128 contiguous bytes of a column tile.
template <int NC>
__device__ __forceinline__ int col(int rx, int j) {
  return (j / 4) * 32 + 4 * rx + j % 4;
}

// x[i][j] = sum over d of A[d][4 ry + i] B[d][col(rx, j)] for two d-major
// tiles, fused multiply-adds over d = 0 .. 63 in order: kernel D's loop,
// so a score is D's float whichever side owns it (fmaf(q, k, s) and
// fmaf(k, q, s) round the same product).
template <int NC>
__device__ __forceinline__ void tile_dot(const float* A, const float* Bm,
                                         int ry, int rx,
                                         float (&x)[4][NC]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) x[i][j] = 0.f;
#pragma unroll (32 / NC)
  for (int d = 0; d < kHD; ++d) {
    const float4 a = *reinterpret_cast<const float4*>(&A[d * kBQ + ry * 4]);
    const float av[4] = {a.x, a.y, a.z, a.w};
    float cv[NC];
#pragma unroll
    for (int g = 0; g < NC / 4; ++g) {
      const float4 c =
          *reinterpret_cast<const float4*>(&Bm[d * kBQ + g * 32 + rx * 4]);
      cv[4 * g] = c.x; cv[4 * g + 1] = c.y;
      cv[4 * g + 2] = c.z; cv[4 * g + 3] = c.w;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NC; ++j) x[i][j] = fmaf(av[i], cv[j], x[i][j]);
  }
}

// T[col(rx, j)][4 ry + i] = x[i][j]: a product into a padded tile,
// transposed (tile_acc reads it by rows; read_t gives a thread its own
// elements back).
template <int NC>
__device__ __forceinline__ void store_t(float* T, const float (&x)[4][NC],
                                        int ry, int rx) {
#pragma unroll
  for (int j = 0; j < NC; ++j)
    *reinterpret_cast<float4*>(&T[col<NC>(rx, j) * kPad + ry * 4]) =
        make_float4(x[0][j], x[1][j], x[2][j], x[3][j]);
}
template <int NC>
__device__ __forceinline__ float4 read_t(const float* T, int ry, int rx,
                                         int j) {
  return *reinterpret_cast<const float4*>(
      &T[col<NC>(rx, j) * kPad + ry * 4]);
}

// acc[i][j] += sum over r of A[4 ry + i][r] T[r][col(rx, j)], A d-major
// (A[d * 64 + r], so output row 4 ry + i is a d) and T padded.
template <int NC>
__device__ __forceinline__ void tile_acc(const float* A, const float* T,
                                         int ry, int rx,
                                         float (&acc)[4][NC]) {
#pragma unroll 2
  for (int r = 0; r < kBQ; r += 4) {
    float av[4][4], tv[4][NC];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 t =
          *reinterpret_cast<const float4*>(&A[(ry * 4 + i) * kBQ + r]);
      av[i][0] = t.x; av[i][1] = t.y; av[i][2] = t.z; av[i][3] = t.w;
    }
#pragma unroll
    for (int rr = 0; rr < 4; ++rr)
#pragma unroll
      for (int g = 0; g < NC / 4; ++g) {
        const float4 t = *reinterpret_cast<const float4*>(
            &T[(r + rr) * kPad + g * 32 + rx * 4]);
        tv[rr][4 * g] = t.x; tv[rr][4 * g + 1] = t.y;
        tv[rr][4 * g + 2] = t.z; tv[rr][4 * g + 3] = t.w;
      }
#pragma unroll
    for (int rr = 0; rr < 4; ++rr)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j)
          acc[i][j] = fmaf(av[i][rr], tv[rr][j], acc[i][j]);
  }
}

// The scaled, biased score as masked_score forms it (no contraction; -inf
// past the last key), and P = exp(s - m) / l from D's row statistics,
// taken as exp(s - m) x (1/l) with 1/l rounded once a row (P = 0 past the
// last query, where m = +inf).
__device__ __forceinline__ float biased(float s, float scale, float bias,
                                        bool in) {
  return in ? __fadd_rn(__fmul_rn(s, scale), bias) : -INFINITY;
}
__device__ __forceinline__ float prob(float x, float m, float il) {
  return __fmul_rn(expf(__fsub_rn(x, m)), il);
}

// The 128 threads of half-block `half` wait for each other alone.
__device__ __forceinline__ void half_sync(int half) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + half), "n"(kHalf) : "memory");
}

// Query block x of problem (blockIdx.z, blockIdx.y): c, then dQ; every
// thread forms S, P and dP of its 4 x 4 sub-tile (the exponentials shared
// by the whole block).
__global__ void __launch_bounds__(kThreads, 2)
    attention_bwd_f32_queries_kernel(const BwdProblem p) {
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);
  float* Gt = Qt + kTileF;  // dO^T
  float* Kt = Gt + kTileF;
  float* Vt = Kt + kTileF;
  float* Dt = Vt + kTileF;  // dS^T: [key][query]
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  load_rows(p.q, b, h, q0, p.nq, Qt);
  load_rows(p.dout, b, h, q0, p.nq, Gt);
  const long long row0 = ((long long)b * p.heads + h) * p.nq;
  const float* bias_row = p.bias + (long long)b * p.nk;
  float m[4], il[4], c[4], lost[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = q0 + ty * 4 + i;
    m[i] = n < p.nq ? p.m[row0 + n] : INFINITY;
    il[i] = n < p.nq ? __frcp_rn(p.l[row0 + n]) : 0.f;
    c[i] = lost[i] = 0.f;
  }
  float s[4][4], dp[4][4], bias[4], dq[4][4];
  bool in[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dq[i][j] = 0.f;

  // sweep 1 (it < nt): c = sum over the keys of P o dP; sweep 2: dS =
  // P o (dP - c), dQ^T += K^T dS^T. Both sweeps' K and V tiles in one
  // stream, each fetched while the block works on the one before
  const int nt = (p.nk + kBK - 1) / kBK;
  float kr[4][4], vr[4][4];
  fetch_rows(p.k, b, h, 0, p.nk, kr);
  fetch_rows(p.v, b, h, 0, p.nk, vr);
  for (int it = 0; it < 2 * nt; ++it) {
    const int k0 = (it % nt) * kBK;
    __syncthreads();  // the previous tile's K^T, V^T and dS^T are consumed
    put_rows(kr, Kt);
    put_rows(vr, Vt);
    __syncthreads();
    if (it + 1 < 2 * nt) {
      fetch_rows(p.k, b, h, ((it + 1) % nt) * kBK, p.nk, kr);
      fetch_rows(p.v, b, h, ((it + 1) % nt) * kBK, p.nk, vr);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      in[j] = k0 + tx * 4 + j < p.nk;
      bias[j] = in[j] ? bias_row[k0 + tx * 4 + j] : 0.f;
    }
    tile_dot<4>(Qt, Kt, ty, tx, s);   // S: query 4 ty + i, key 4 tx + j
    tile_dot<4>(Gt, Vt, ty, tx, dp);  // dP
    if (it < nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float part = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          part = fmaf(prob(biased(s[i][j], p.scale, bias[j], in[j]), m[i],
                           il[i]),
                      dp[i][j], part);
        // a row's 64 keys live in the 16 lanes of one half-warp; the
        // butterfly leaves every lane the same sum
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, off));
        const float y = __fsub_rn(part, lost[i]);
        const float t = __fadd_rn(c[i], y);
        lost[i] = __fsub_rn(__fsub_rn(t, c[i]), y);
        c[i] = t;
      }
      if (it == nt - 1 && tx == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (q0 + ty * 4 + i < p.nq) p.c[row0 + q0 + ty * 4 + i] = c[i];
      }
      continue;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        s[i][j] = __fmul_rn(
            prob(biased(s[i][j], p.scale, bias[j], in[j]), m[i], il[i]),
            __fsub_rn(dp[i][j], c[i]));
    store_t<4>(Dt, s, ty, tx);
    __syncthreads();
    tile_acc<4>(Kt, Dt, ty, tx, dq);
  }
  // dq[i][j]: d = 4 ty + i of query q0 + 4 tx + j
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = q0 + tx * 4 + j;
    if (n >= p.nq) continue;
    float* out = out_row<float>(p.dq, b, h, n);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      out[(ty * 4 + i) * p.dq.sd] = dq[i][j] * p.scale;
  }
}

// Key block x of problem (blockIdx.z, blockIdx.y): dK and dV, reading the
// query blocks' c. Half 0 forms S^T and P, then dV; half 1 dP^T, dS,
// then dK.
__global__ void __launch_bounds__(kThreads, 2)
    attention_bwd_f32_keys_kernel(const BwdProblem p) {
  extern __shared__ float4 smem4[];
  float* Kt = reinterpret_cast<float*>(smem4);
  float* Vt = Kt + kTileF;
  float* Qt = Vt + kTileF;
  float* Gt = Qt + kTileF;      // dO^T
  float* Pq = Gt + kTileF;      // P: [query][key]
  float* Dq = Pq + kBQ * kPad;  // dS: [query][key]
  float* rm = Dq + kBQ * kPad;  // the streamed queries' m, 1/l and c
  float* rl = rm + kBQ;
  float* rc = rl + kBQ;
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * kBK;
  const int half = threadIdx.x / kHalf;
  const int ry = threadIdx.x % kHalf / 8, rx = threadIdx.x % 8;
  load_rows(p.k, b, h, k0, p.nk, Kt);
  load_rows(p.v, b, h, k0, p.nk, Vt);
  const long long row0 = ((long long)b * p.heads + h) * p.nq;
  float bias[4];  // of the thread's keys 4 ry + i
  bool in[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    in[i] = k0 + ry * 4 + i < p.nk;
    bias[i] = in[i] ? p.bias[(long long)b * p.nk + k0 + ry * 4 + i] : 0.f;
  }
  // half 0: dV^T, half 1: dK^T; d = 4 ry + i, key col<8>(rx, j)
  float acc[4][8], x[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int q0 = 0; q0 < p.nq; q0 += kBQ) {
    __syncthreads();  // the previous tile's Q^T, dO^T, P and dS consumed
    load_rows(p.q, b, h, q0, p.nq, Qt);
    load_rows(p.dout, b, h, q0, p.nq, Gt);
    if (threadIdx.x < kBQ) {
      const int n = q0 + threadIdx.x;
      rm[threadIdx.x] = n < p.nq ? p.m[row0 + n] : INFINITY;
      rl[threadIdx.x] = n < p.nq ? __frcp_rn(p.l[row0 + n]) : 0.f;
      rc[threadIdx.x] = n < p.nq ? p.c[row0 + n] : 0.f;
    }
    __syncthreads();
    if (half == 0) {
      // S^T: key 4 ry + i, query col<8>(rx, j)
      tile_dot<8>(Kt, Qt, ry, rx, x);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float mq = rm[col<8>(rx, j)], lq = rl[col<8>(rx, j)];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          x[i][j] = prob(biased(x[i][j], p.scale, bias[i], in[i]), mq, lq);
      }
      store_t<8>(Pq, x, ry, rx);  // P[query][key]
    } else {
      tile_dot<8>(Vt, Gt, ry, rx, x);  // dP^T
    }
    __syncthreads();
    if (half == 0) {
      // dV^T[d][key] += dO^T[d][q] P[q][key]
      tile_acc<8>(Gt, Pq, ry, rx, acc);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 t = read_t<8>(Pq, ry, rx, j);  // P^T[key][q]
        const float pv[4] = {t.x, t.y, t.z, t.w};
        const float cq = rc[col<8>(rx, j)];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          x[i][j] = __fmul_rn(pv[i], __fsub_rn(x[i][j], cq));
      }
      store_t<8>(Dq, x, ry, rx);  // dS[query][key]
      half_sync(1);
      // dK^T[d][key] += Q^T[d][q] dS[q][key]
      tile_acc<8>(Qt, Dq, ry, rx, acc);
    }
  }
  // acc[i][j]: d = 4 ry + i of key k0 + col<8>(rx, j); half 0 dV, half 1 dK
  const Output& o = half == 0 ? p.dv : p.dk;
  const float scale = half == 0 ? 1.f : p.scale;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = k0 + col<8>(rx, j);
    if (n >= p.nk) continue;
    float* out = out_row<float>(o, b, h, n);
#pragma unroll
    for (int i = 0; i < 4; ++i) out[(ry * 4 + i) * o.sd] = acc[i][j] * scale;
  }
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
  // the query blocks (c, dQ), then the key blocks (dK, dV), which read c
  const size_t q_smem = ei::kBwdQueryFloats * sizeof(float);
  const size_t k_smem = ei::kBwdKeyFloats * sizeof(float);
  int err = (int)cudaFuncSetAttribute(
      ei::attention_bwd_f32_queries_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)q_smem);
  if (err != 0) return err;
  err = (int)cudaFuncSetAttribute(ei::attention_bwd_f32_keys_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)k_smem);
  if (err != 0) return err;
  ei::attention_bwd_f32_queries_kernel<<<
      dim3((N + ei::kBQ - 1) / ei::kBQ, H, B), ei::kThreads, q_smem, s>>>(p);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  ei::attention_bwd_f32_keys_kernel<<<
      dim3((M + ei::kBK - 1) / ei::kBK, H, B), ei::kThreads, k_smem, s>>>(p);
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
