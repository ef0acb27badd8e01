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
// rounding dS and P^T to the operand type before their products.
//
// What bounds it on an H100: at the flagship shapes (B=8, h=4, N=M=1024,
// d=64, bf16) the five products are 21.5 GFLOP against ~34 MB of inputs and
// outputs, so it is compute-bound (~22 us at 989 TFLOP/s).
//
// Design. Hopper blocks run in no order, so nothing carries from one block
// to the next, and the TPU kernel's per-problem sums become two kinds of
// block in one launch, each owning its outputs (no atomics, so the sums
// are the same from run to run):
//  - dK/dV blocks own 128 keys (8 warps x 16) and loop over 64-query tiles:
//    S^T = K Q^T and dP^T = V dO^T on the tensor cores, P^T = exp(S^T -
//    lse) from the forward's row log-sum-exp (the TPU's pass-1 row
//    statistics, not a softmax of S^T), dV += P^T dO, dK += dS^T Q;
//  - dQ blocks own 128 queries and loop over 64-key tiles: S, P, dP, dS as
//    above, dQ += dS K.
// So S and dP are computed twice (seven products instead of five), the
// price of independent blocks. c is rowsum(dO o O) (FlashAttention-2),
// equal to rowsum(dP o P) up to the rounding of O to the operand type; a
// small first launch computes it once per row. The bf16 instance runs its
// products with mma.sync m16n8k16 (bf16 operands from shared memory,
// float32 accumulators), reusing kernel A's fragments; the float32 instance
// (comparisons) is one warp per output row on the CUDA cores.
#include "flash_attention.cuh"

namespace ei {

constexpr int kBwdQT = 64;  // bf16: query tile of the dK/dV loop
constexpr int kBwdKT = 64;  // bf16: key tile of the dQ loop

struct BwdProblem {
  Operand q, k, v, o, dout;  // (B, h, N|M, d) through strides
  const float* bias;         // (B, nk) additive key-side bias
  const float* lse;          // (B, heads, nq) forward row log-sum-exp
  float* c;                  // (B, heads, nq) scratch: rowsum(dO o O)
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

// c[b, h, n] = sum_d dO[n, d] O[n, d] in float32, one warp a row.
template <typename T>
__global__ void __launch_bounds__(256) row_dot_kernel(const BwdProblem p,
                                                      long long rows) {
  const long long w = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  if (w >= rows) return;
  const int lane = threadIdx.x % 32;
  const int n = (int)(w % p.nq);
  const int h = (int)((w / p.nq) % p.heads);
  const int b = (int)(w / ((long long)p.nq * p.heads));
  const T* o = row_ptr<T>(p.o, b, h, n);
  const T* g = row_ptr<T>(p.dout, b, h, n);
  float s = to_f(g[lane * p.dout.sd]) * to_f(o[lane * p.o.sd]) +
            to_f(g[(lane + 32) * p.dout.sd]) * to_f(o[(lane + 32) * p.o.sd]);
  s = warp_sum(s);
  if (lane == 0) p.c[w] = s;
}

// ---------------------------------------------------------------------------
// float32 instance: one warp per output row, lane l holding d = l, l + 32
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(256) bwd_rows_kernel(const BwdProblem p,
                                                       int B) {
  long long w = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int d0 = lane, d1 = lane + 32;
  const long long q_rows = (long long)B * p.heads * p.nq;
  const long long k_rows = (long long)B * p.heads * p.nk;
  if (w < q_rows) {
    // dQ row i: loop over the keys
    const int i = (int)(w % p.nq);
    const int h = (int)((w / p.nq) % p.heads);
    const int b = (int)(w / ((long long)p.nq * p.heads));
    const T* q = row_ptr<T>(p.q, b, h, i);
    const T* g = row_ptr<T>(p.dout, b, h, i);
    const float q0 = to_f(q[d0 * p.q.sd]), q1 = to_f(q[d1 * p.q.sd]);
    const float g0 = to_f(g[d0 * p.dout.sd]), g1 = to_f(g[d1 * p.dout.sd]);
    const long long r = ((long long)b * p.heads + h) * p.nq + i;
    const float lse = p.lse[r], c = p.c[r];
    float a0 = 0.f, a1 = 0.f;
    for (int j = 0; j < p.nk; ++j) {
      const T* k = row_ptr<T>(p.k, b, h, j);
      const T* v = row_ptr<T>(p.v, b, h, j);
      const float k0 = to_f(k[d0 * p.k.sd]), k1 = to_f(k[d1 * p.k.sd]);
      const float s = warp_sum(q0 * k0 + q1 * k1);
      const float dp = warp_sum(g0 * to_f(v[d0 * p.v.sd]) +
                                g1 * to_f(v[d1 * p.v.sd]));
      const float pr = expf(__fadd_rn(__fmul_rn(s, p.scale),
                                      p.bias[(long long)b * p.nk + j]) - lse);
      const float ds = round_t<T>(__fmul_rn(pr, __fsub_rn(dp, c)));
      a0 = fmaf(ds, k0, a0);
      a1 = fmaf(ds, k1, a1);
    }
    T* out = out_row<T>(p.dq, b, h, i);
    out[d0 * p.dq.sd] = from_f<T>(a0 * p.scale);
    out[d1 * p.dq.sd] = from_f<T>(a1 * p.scale);
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
  const float k0 = to_f(k[d0 * p.k.sd]), k1 = to_f(k[d1 * p.k.sd]);
  const float v0 = to_f(v[d0 * p.v.sd]), v1 = to_f(v[d1 * p.v.sd]);
  const float bias = p.bias[(long long)b * p.nk + j];
  const float* lse = p.lse + ((long long)b * p.heads + h) * p.nq;
  const float* cr = p.c + ((long long)b * p.heads + h) * p.nq;
  float dv0 = 0.f, dv1 = 0.f, dk0 = 0.f, dk1 = 0.f;
  for (int i = 0; i < p.nq; ++i) {
    const T* q = row_ptr<T>(p.q, b, h, i);
    const T* g = row_ptr<T>(p.dout, b, h, i);
    const float q0 = to_f(q[d0 * p.q.sd]), q1 = to_f(q[d1 * p.q.sd]);
    const float g0 = to_f(g[d0 * p.dout.sd]), g1 = to_f(g[d1 * p.dout.sd]);
    const float s = warp_sum(k0 * q0 + k1 * q1);
    const float dp = warp_sum(v0 * g0 + v1 * g1);
    const float pr =
        expf(__fadd_rn(__fmul_rn(s, p.scale), bias) - lse[i]);
    const float pt = round_t<T>(pr);
    dv0 = fmaf(pt, g0, dv0);
    dv1 = fmaf(pt, g1, dv1);
    const float ds = round_t<T>(__fmul_rn(pr, __fsub_rn(dp, cr[i])));
    dk0 = fmaf(ds, q0, dk0);
    dk1 = fmaf(ds, q1, dk1);
  }
  T* dvo = out_row<T>(p.dv, b, h, j);
  T* dko = out_row<T>(p.dk, b, h, j);
  dvo[d0 * p.dv.sd] = from_f<T>(dv0);
  dvo[d1 * p.dv.sd] = from_f<T>(dv1);
  dko[d0 * p.dk.sd] = from_f<T>(dk0 * p.scale);
  dko[d1 * p.dk.sd] = from_f<T>(dk1 * p.scale);
}

// ---------------------------------------------------------------------------
// bfloat16 instance: tensor cores
// ---------------------------------------------------------------------------

constexpr size_t kBwdSmem =
    (2 * kMmaRows + 2 * kBwdQT) * kLd * sizeof(__nv_bfloat16) +
    2 * kBwdQT * sizeof(float);

__device__ __forceinline__ void load_rows(const Operand& a, int b, int h,
                                          int r0, int n_rows, int rows,
                                          __nv_bfloat16* dst) {
  load_rows_bf16<false>(Problem{}, a, b, h, r0, n_rows, rows, dst);
}

// A fragments of the warp's 16 rows of a row-major bf16 tile, one per
// 16-wide d chunk (as kernel A loads Q).
__device__ __forceinline__ void a_frags(const __nv_bfloat16* tile, int w0,
                                        uint32_t (&a)[4][4]) {
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const __nv_bfloat16* r = &tile[(w0 + g) * kLd + kk * 16 + 2 * t];
    a[kk][0] = lds_pair(r);
    a[kk][1] = lds_pair(r + 8 * kLd);
    a[kk][2] = lds_pair(r + 8);
    a[kk][3] = lds_pair(r + 8 * kLd + 8);
  }
}

// acc[j] += A (16 x 64) B^T for the 64 rows of `tile` as 8 n-tiles of 8
// (rows = n, d = k), as kernel A computes S = Q K^T.
__device__ __forceinline__ void mma_nt(float (&acc)[8][4],
                                       const uint32_t (&a)[4][4],
                                       const __nv_bfloat16* tile) {
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const __nv_bfloat16* r = &tile[(j * 8 + g) * kLd + kk * 16 + 2 * t];
      mma_bf16(acc[j], a[kk], lds_pair(r), lds_pair(r + 8));
    }
  }
}

// acc (16 x 64 d) += X (16 x 64, float32 accumulators rounded to bf16 as
// the A operand) times the row-major tile (64 rows = k, 64 d = n).
__device__ __forceinline__ void mma_acc_tile(float (&acc)[8][4],
                                             const float (&x)[8][4],
                                             const __nv_bfloat16* tile) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const uint32_t xa[4] = {
        pack_bf16(x[2 * c][0], x[2 * c][1]),
        pack_bf16(x[2 * c][2], x[2 * c][3]),
        pack_bf16(x[2 * c + 1][0], x[2 * c + 1][1]),
        pack_bf16(x[2 * c + 1][2], x[2 * c + 1][3])};
#pragma unroll
    for (int jd = 0; jd < 8; ++jd) {
      uint32_t b0, b1;
      ldsm_x2_trans(tile, c * 16, jd * 8, b0, b1);
      mma_bf16(acc[jd], xa, b0, b1);
    }
  }
}

// Write the warp's 16 rows x 64 d of `acc` * mul to rows r0.. of `o`.
__device__ __forceinline__ void store_rows(const Output& o, int b, int h,
                                           int r0, int n_rows,
                                           const float (&acc)[8][4],
                                           float mul) {
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int n = r0 + g + 8 * hr;
    if (n >= n_rows) continue;
    __nv_bfloat16* out = out_row<__nv_bfloat16>(o, b, h, n);
#pragma unroll
    for (int jd = 0; jd < 8; ++jd)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        out[(jd * 8 + 2 * t + e) * o.sd] =
            __float2bfloat16_rn(acc[jd][2 * hr + e] * mul);
  }
}

__device__ void dkdv_block(const BwdProblem& p, int b, int h, int k0,
                           __nv_bfloat16* smem) {
  using T = __nv_bfloat16;
  T* Ks = smem;                   // [kMmaRows][kLd]
  T* Vs = Ks + kMmaRows * kLd;    // [kMmaRows][kLd]
  T* Qs = Vs + kMmaRows * kLd;    // [kBwdQT][kLd]
  T* Gs = Qs + kBwdQT * kLd;      // [kBwdQT][kLd]  dO
  float* lse_s = reinterpret_cast<float*>(Gs + kBwdQT * kLd);
  float* c_s = lse_s + kBwdQT;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int w0 = (threadIdx.x / 32) * 16;

  load_rows(p.k, b, h, k0, p.nk, kMmaRows, Ks);
  load_rows(p.v, b, h, k0, p.nk, kMmaRows, Vs);
  __syncthreads();
  uint32_t ka[4][4], va[4][4];
  a_frags(Ks, w0, ka);
  a_frags(Vs, w0, va);
  float bias[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int key = k0 + w0 + g + 8 * hr;
    bias[hr] = key < p.nk ? p.bias[(long long)b * p.nk + key] : 0.f;
  }
  const long long row0 = ((long long)b * p.heads + h) * p.nq;
  float dv[8][4], dk[8][4];
#pragma unroll
  for (int jd = 0; jd < 8; ++jd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dv[jd][e] = dk[jd][e] = 0.f;

  for (int q0 = 0; q0 < p.nq; q0 += kBwdQT) {
    __syncthreads();  // every warp is done with the previous Q and dO
    load_rows(p.q, b, h, q0, p.nq, kBwdQT, Qs);
    load_rows(p.dout, b, h, q0, p.nq, kBwdQT, Gs);
    if (threadIdx.x < kBwdQT) {
      const int n = q0 + threadIdx.x;
      // queries past nq: P = exp(-inf) = 0, and their dO rows are zeros
      lse_s[threadIdx.x] = n < p.nq ? p.lse[row0 + n] : INFINITY;
      c_s[threadIdx.x] = n < p.nq ? p.c[row0 + n] : 0.f;
    }
    __syncthreads();

    float s[8][4], dp[8][4];  // S^T, dP^T: the warp's 16 keys x 64 queries
    mma_nt(s, ka, Qs);
    mma_nt(dp, va, Gs);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t + (e & 1);
        const float pr = expf(__fadd_rn(__fmul_rn(s[j][e], p.scale),
                                        bias[e >> 1]) - lse_s[col]);
        s[j][e] = pr;                                        // P^T
        dp[j][e] = __fmul_rn(pr, __fsub_rn(dp[j][e], c_s[col]));  // dS^T
      }
    mma_acc_tile(dv, s, Gs);   // dV += P^T dO
    mma_acc_tile(dk, dp, Qs);  // dK += dS^T Q
  }
  store_rows(p.dv, b, h, k0 + w0, p.nk, dv, 1.f);
  store_rows(p.dk, b, h, k0 + w0, p.nk, dk, p.scale);
}

__device__ void dq_block(const BwdProblem& p, int b, int h, int q0,
                         __nv_bfloat16* smem) {
  using T = __nv_bfloat16;
  T* Qs = smem;                   // [kMmaRows][kLd]
  T* Gs = Qs + kMmaRows * kLd;    // [kMmaRows][kLd]  dO
  T* Ks = Gs + kMmaRows * kLd;    // [kBwdKT][kLd]
  T* Vs = Ks + kBwdKT * kLd;      // [kBwdKT][kLd]
  float* bias_s = reinterpret_cast<float*>(Vs + kBwdKT * kLd);
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int w0 = (threadIdx.x / 32) * 16;

  load_rows(p.q, b, h, q0, p.nq, kMmaRows, Qs);
  load_rows(p.dout, b, h, q0, p.nq, kMmaRows, Gs);
  __syncthreads();
  uint32_t qa[4][4], ga[4][4];
  a_frags(Qs, w0, qa);
  a_frags(Gs, w0, ga);
  const long long row0 = ((long long)b * p.heads + h) * p.nq;
  float lse[2], c[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int n = q0 + w0 + g + 8 * hr;
    lse[hr] = n < p.nq ? p.lse[row0 + n] : INFINITY;
    c[hr] = n < p.nq ? p.c[row0 + n] : 0.f;
  }
  float dq[8][4];
#pragma unroll
  for (int jd = 0; jd < 8; ++jd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[jd][e] = 0.f;

  for (int k0 = 0; k0 < p.nk; k0 += kBwdKT) {
    __syncthreads();  // every warp is done with the previous K and V
    load_rows(p.k, b, h, k0, p.nk, kBwdKT, Ks);
    load_rows(p.v, b, h, k0, p.nk, kBwdKT, Vs);
    if (threadIdx.x < kBwdKT) {
      const int key = k0 + threadIdx.x;
      // keys past nk: P = 0, and their V rows are zeros
      bias_s[threadIdx.x] =
          key < p.nk ? p.bias[(long long)b * p.nk + key] : -INFINITY;
    }
    __syncthreads();

    float s[8][4], dp[8][4];  // S, dP: the warp's 16 queries x 64 keys
    mma_nt(s, qa, Ks);
    mma_nt(dp, ga, Vs);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t + (e & 1);
        const float pr = expf(__fadd_rn(__fmul_rn(s[j][e], p.scale),
                                        bias_s[col]) - lse[e >> 1]);
        s[j][e] = __fmul_rn(pr, __fsub_rn(dp[j][e], c[e >> 1]));  // dS
      }
    mma_acc_tile(dq, s, Ks);  // dQ += dS K
  }
  store_rows(p.dq, b, h, q0 + w0, p.nq, dq, p.scale);
}

// blockIdx.x < n_kblocks: a dK/dV block; otherwise a dQ block.
__global__ void __launch_bounds__(kMmaThreads)
    bwd_mma_kernel(const BwdProblem p, int n_kblocks) {
  extern __shared__ float4 smem4[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem4);
  if ((int)blockIdx.x < n_kblocks)
    dkdv_block(p, blockIdx.z, blockIdx.y, blockIdx.x * kMmaRows, smem);
  else
    dq_block(p, blockIdx.z, blockIdx.y, (blockIdx.x - n_kblocks) * kMmaRows,
             smem);
}

template <typename T>
static int launch(const BwdProblem& p, int B, cudaStream_t stream) {
  const long long rows = (long long)B * p.heads * p.nq;
  row_dot_kernel<T><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(p, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if constexpr (std::is_same<T, float>::value) {
    const long long all = (long long)B * p.heads * (p.nq + p.nk);
    bwd_rows_kernel<T><<<(unsigned)((all + 7) / 8), 256, 0, stream>>>(p, B);
    return (int)cudaGetLastError();
  }
  err = cudaFuncSetAttribute(bwd_mma_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kBwdSmem);
  if (err != cudaSuccess) return (int)err;
  const int nkb = (p.nk + kMmaRows - 1) / kMmaRows;
  const int nqb = (p.nq + kMmaRows - 1) / kMmaRows;
  const dim3 grid(nkb + nqb, p.heads, B);
  bwd_mma_kernel<<<grid, kMmaThreads, kBwdSmem, stream>>>(p, nkb);
  return (int)cudaGetLastError();
}

}  // namespace ei

// q, o, dout: (B, H, N, 64); k, v: (B, H, M, 64), through `in_strides` (20
// element strides: q, k, v, o, dout, each (b, h, n, d)); bias: (B, M)
// float32 contiguous; lse, c: (B, H, N) float32 contiguous (c is scratch);
// dq: (B, H, N, 64), dk, dv: (B, H, M, 64) through `out_strides` (12: dq,
// dk, dv). Returns the CUDA error code of the launches (0 on success).
extern "C" int ei_attention_bwd(int dtype, const void* q, const void* k,
                                const void* v, const void* o,
                                const void* dout, const long long* in_strides,
                                const float* bias, const float* lse, float* c,
                                void* dq, void* dk, void* dv,
                                const long long* out_strides, int B, int H,
                                int N, int M, float scale, void* stream) {
  ei::BwdProblem p;
  p.q = ei::make_operand(q, in_strides);
  p.k = ei::make_operand(k, in_strides + 4);
  p.v = ei::make_operand(v, in_strides + 8);
  p.o = ei::make_operand(o, in_strides + 12);
  p.dout = ei::make_operand(dout, in_strides + 16);
  p.bias = bias;
  p.lse = lse;
  p.c = c;
  p.dq = ei::make_output(dq, out_strides);
  p.dk = ei::make_output(dk, out_strides + 4);
  p.dv = ei::make_output(dv, out_strides + 8);
  p.heads = H;
  p.nq = N;
  p.nk = M;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ei::kFloat32) return ei::launch<float>(p, B, s);
  if (dtype == ei::kBFloat16) return ei::launch<__nv_bfloat16>(p, B, s);
  return (int)cudaErrorInvalidValue;
}
