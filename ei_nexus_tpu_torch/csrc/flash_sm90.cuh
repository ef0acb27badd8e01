// Hopper (sm_90a) flash loop of the bf16 row-softmax attention with a
// key-side mask: the bf16 instances of kernel A (csrc/self_attention.cu),
// kernel B (csrc/cross_attention.cu, both directions in one launch),
// kernel D (csrc/attention_fwd.cu, with each row's statistics for F),
// kernel E (csrc/qblock_attention.cu) and kernel G (csrc/flash_segment.cu,
// segment ids in place of the bias); kernel F's bf16 backward
// (csrc/attention_bwd.cu) is built from the same pieces (TMA ring,
// producer warpgroup, wgmma forms, pack pass, guard). The float32
// instances of A, B, D, E, F and G run the 3xTF32 pieces of
// flash_tf32.cuh.
//
// What it computes is what `qblock_attention_plain` defines
// (ops/attention_kernels.py): rotated q and k rounded to bf16 as
// round(round(t*cos) + round(rotate_half(t)*sin)); S = Q K^T in float32,
// then x scale, then + the float32 key bias (no contraction); an online
// float32 softmax; P rounded to bf16 before the PV product; O in float32,
// written to bf16. The loop's argument type picks two compile-time
// additions: StatsArgs (D) also writes each row's max m and sum l of
// exp(s - m); SegArgs (G) adds jax's segment rule, kMaskValue where the
// query's and the key's int32 ids differ, in place of the bias.
//
// What bounds it: at the flagship shapes (B=8, h=4, N=M=1024, d=64) one
// call does 8.6 GFLOP of products against ~19 MB of inputs and outputs, so
// the tensor cores (~8.7 us at 989 TFLOP/s), not memory.
//
// Design:
//  - a pack pass (attention_pack_kernel), once per token and not once per
//    (token, query tile): operands the loop cannot read through TMA (the
//    stride-3 q/k/v views of SelfBlock's Wqkv output, whose k and v start 2
//    and 4 bytes into their 384-byte head slab), and every operand the
//    rotary touches, are written as contiguous (B, h, rows, 64) bf16
//    scratch. A thread takes 8 d lanes of one row with 16-byte loads from
//    the 16-byte-aligned slab, and one job packs every view of a slab, so
//    the q, k and v of one Wqkv row cost one read of it;
//  - the loop (attention_block) is warp specialised: one producer warp (of
//    a warpgroup that gives its registers back) keeps TMA loads
//    (cp.async.bulk.tensor, 128-byte swizzle, completion on an mbarrier)
//    of the 64-key K and V tiles kStages tiles ahead of the consumers and
//    writes each tile's 64 key-bias floats (or G's key ids) beside them
//    (-inf past the last key); each consumer warpgroup owns 64 query rows, computes S = Q K^T
//    with wgmma m64n64k16 or m64n32k16 (Q and K from shared memory, both
//    K-major; see Config), the online softmax in registers, and O += P V
//    with P taken from the S accumulators as the register A operand and V
//    as the transposed (MN-major) B operand. setmaxnreg moves registers from the
//    producer to the consumers. Q is loaded once per block.
//  - Query rows and keys past the ends are zero-filled by TMA; keys past
//    nk get -inf through the bias tile (G: by their index), rows past nq
//    are not written.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <float.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace ei {
namespace sm90 {

constexpr int kD = 64;         // head dim: one 128-byte row of bf16
constexpr int kBK = 64;        // keys per tile
constexpr int kStages = 3;     // K/V tiles in flight
constexpr int kTileBytes = kBK * kD * 2;
constexpr int kProducerRegs = 24;

// Per consumer-warpgroup count: threads (NWG consumer warpgroups and a
// producer warpgroup, of which one warp works), blocks per SM, the
// registers the consumers take (setmaxnreg.inc) after the producer
// warpgroup gives its own back, and the steps a 64-key tile is taken in.
// setmaxnreg.inc waits until the block's pool holds what it asks: with an
// entry count of R registers a thread (__launch_bounds__ allows 80 at these
// sizes; ptxas of CUDA 12.9 takes all 80), the producers free 128 (R - 24)
// and the consumers take 128 NWG (consumer_regs - R); `configure` refuses
// to launch a build where that does not balance. Two blocks of 384 threads
// leave the consumers 104 registers: too few for a whole tile's S (32
// floats) beside O (ptxas spills and serialises the wgmma), so they take a
// tile in two steps of 32 keys (S in 16 floats).
template <int NWG> struct Config;
template <> struct Config<1> {
  static constexpr int nwg = 1, threads = 256, min_blocks = 3,
                       consumer_regs = 128, ksplit = 1;
};
template <> struct Config<2> {
  static constexpr int nwg = 2, threads = 384, min_blocks = 2,
                       consumer_regs = 104, ksplit = 2;
};

template <int NWG> struct Shared {
  __nv_bfloat16 q[NWG][64 * kD];       // 1024-byte aligned tiles
  __nv_bfloat16 k[kStages][kBK * kD];
  __nv_bfloat16 v[kStages][kBK * kD];
  float bias[kStages][kBK];
  uint64_t full[kStages], empty[kStages], qbar;
};
// dynamic shared memory of one block: the tiles plus room to align them
template <int NWG> constexpr size_t smem_bytes() {
  return sizeof(Shared<NWG>) + 1024;
}

struct Args {
  const float* bias;   // (B, nk) float32, contiguous
  __nv_bfloat16* out;  // (B, h, nq, 64) through os (b, h, n); d unit
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

// Kernel G: jax's segment rule in place of the bias (Args::bias unused):
// kMaskValue added after the scale wherever the ids differ.
struct SegArgs : Args {
  const int* q_seg;   // (B, nq) int32, contiguous
  const int* kv_seg;  // (B, nk) int32, contiguous
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase with the given parity has completed. A
// wait of more than ~10 s (2^34 cycles) is a fault in the pipeline: trap,
// so that the launch fails instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > (1ll << 34)) {
      __trap();
    }
  }
}

// One (64 rows x 64 d) box of a 4-D (d, rows, h, B) tensor map.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap& map,
                                         int row, int h, int b,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(0), "r"(row), "r"(h),
      "r"(b), "r"(smem_u32(bar))
      : "memory");
}

// wgmma shared-memory descriptor of a tile of 128-byte rows in TMA's
// 128-byte swizzle: 8-row groups 1024 bytes apart (SBO), LBO unused.
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint32_t a = smem_u32(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving accumulator accesses across the wgmma.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define EI_ACC32(d)                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),         \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),     \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),     \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),     \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),     \
      "+f"(d[31])
#define EI_D32                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "  \
  "%28, %29, %30, %31}"

#define EI_ACC16(d)                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),         \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define EI_D16                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15}"

// D (64 x N f32) (+)= A B^T: A (64x16) and B (N x 16) K-major in shared
// memory, N = 64 or 32 keys; scale_d 0 overwrites D.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " EI_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : EI_ACC32(d)
      : "l"(da), "l"(db), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " EI_D16
      ", %16, %17, p, 1, 1, 0, 0;\n}\n"
      : EI_ACC16(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64x64 f32) += A B: A (64x16 bf16) from registers in the m16n8k16
// fragment layout per warp, B (16 keys x 64 d) MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " EI_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : EI_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef EI_ACC32
#undef EI_D32
#undef EI_ACC16
#undef EI_D16

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D (64 x N) = A B^T over d = 64 in four k16 steps (32 bytes along the
// row): A (64 rows) and B (N rows) K-major tiles in shared memory.
template <int N>
__device__ __forceinline__ void product_ss(float (&d)[N], uint64_t da,
                                           uint64_t db) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_ss(d, da + 2 * kk, db + 2 * kk, kk);
}

// D (64 x 64) += A B over 16 C rows of B: A from registers (a_operand), B
// the tile's rows taken as its K dimension (MN-major), 16 rows of 128 bytes
// a step.
template <int C>
__device__ __forceinline__ void product_rs(float (&d)[32],
                                           const uint32_t (&a)[C][4],
                                           uint64_t db) {
#pragma unroll
  for (int c = 0; c < C; ++c) wgmma_rs(d, a[c], db + c * (2048 >> 4));
}

// The register A operand of an accumulator x (64 x N/2 per warpgroup: x[4j
// + e] holds row g + 8 (e >> 1) of the warp's 16, column 8j + 2t + (e & 1))
// rounded to bf16: columns 16c .. 16c + 15 are n-blocks 2c and 2c + 1.
template <int N>
__device__ __forceinline__ void a_operand(const float (&x)[N],
                                          uint32_t (&pa)[N / 8][4]) {
#pragma unroll
  for (int c = 0; c < N / 8; ++c) {
    pa[c][0] = pack2(x[8 * c + 0], x[8 * c + 1]);
    pa[c][1] = pack2(x[8 * c + 2], x[8 * c + 3]);
    pa[c][2] = pack2(x[8 * c + 4], x[8 * c + 5]);
    pa[c][3] = pack2(x[8 * c + 6], x[8 * c + 7]);
  }
}

// exp(x - m) as exp2, the difference taken first: a fully masked row's
// scores are all -1e9, where x * log2(e) - m * log2(e) would lose the
// difference to rounding.
__device__ __forceinline__ float exp_diff(float x, float m) {
  return exp2f(__fmul_rn(x - m, 1.4426950408889634f));
}

// A 64 x 64 accumulator times mul[row g (0) or g + 8 (1)] to bf16 at rows
// r0 + 16 w + g (+ 8) of `out` for the block's w-th consumer warp (rows
// past n_rows not written); `out` through element strides os (b, h, n), d
// unit.
__device__ __forceinline__ void store_tile(const float (&x)[32],
                                           const float (&mul)[2],
                                           __nv_bfloat16* out,
                                           const long long (&os)[3], int b,
                                           int h, int r0, int n_rows) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int n = r0 + 16 * warp + g + 8 * hr;
    if (n >= n_rows) continue;
    __nv_bfloat16* row = out + b * os[0] + h * os[1] + n * os[2];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<uint32_t*>(row + 8 * j + 2 * t) =
          pack2(x[4 * j + 2 * hr] * mul[hr], x[4 * j + 2 * hr + 1] * mul[hr]);
  }
}

// The block's dynamic shared memory as T, aligned to 1024 bytes (the
// 128-byte swizzle's period).
template <typename T> __device__ __forceinline__ T& shared_as() {
  extern __shared__ uint8_t smem_raw[];
  return *reinterpret_cast<T*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
}

// The loop over the query rows [q0, q0 + 64 NWG) of problem (b, h): tq, tk,
// tv are 4-D (64, rows, h, B) bf16 tensor maps with 64x64 boxes; A is Args,
// StatsArgs or SegArgs.
template <int NWG, typename A>
__device__ __forceinline__ void attention_block(const CUtensorMap& tq,
                                                const CUtensorMap& tk,
                                                const CUtensorMap& tv,
                                                const A& a, int q0, int h,
                                                int b) {
  constexpr bool kStats = std::is_same<A, StatsArgs>::value;
  constexpr bool kSeg = std::is_same<A, SegArgs>::value;
  auto& S = shared_as<Shared<NWG>>();
  const int ntiles = (a.nk + kBK - 1) / kBK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&S.full[s], 32);          // the producer warp's lanes
      mbar_init(&S.empty[s], 4 * NWG);    // one lane of each consumer warp
    }
    mbar_init(&S.qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * NWG) {
    // ---- producer: TMA loads of K and V, the key-bias row (or the key
    // ids) beside them; the warpgroup gives its registers back, and its
    // first warp works
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kProducerRegs));
    if (warp != 4 * NWG) return;
    if (lane == 0) {
      // Q once; a 64-row box wholly past the last query is not loaded
      const int boxes = min(NWG, (a.nq - q0 + 63) / 64);
      mbar_arrive_tx(&S.qbar, boxes * 64 * kD * 2);
      for (int w = 0; w < boxes; ++w)
        tma_load(S.q[w], tq, q0 + 64 * w, h, b, &S.qbar);
    }
    const float* bias = a.bias + (long long)b * a.nk;
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
        S.bias[st][2 * lane] = c < a.nk ? bias[c] : -INFINITY;
        S.bias[st][2 * lane + 1] = c + 1 < a.nk ? bias[c + 1] : -INFINITY;
      }
      if (lane == 0) {
        mbar_arrive_tx(&S.full[st], 2 * kTileBytes);
        tma_load(S.k[st], tk, it * kBK, h, b, &S.full[st]);
        tma_load(S.v[st], tv, it * kBK, h, b, &S.full[st]);
      } else {
        mbar_arrive(&S.full[st]);
      }
    }
  } else {
    // ---- consumers: warpgroup warp / 4 owns 64 rows from q0 + 64 (warp / 4)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        Config<NWG>::consumer_regs));
    [[maybe_unused]] const int g = lane / 4;
    const int t = lane % 4;
    const uint64_t dq = smem_desc(S.q[warp / 4]);
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

    // a tile's keys in Config<NWG>::ksplit steps of KW: 32 keys a step
    // keep S to 16 registers where the consumers have few
    constexpr int KW = kBK / Config<NWG>::ksplit, NB = KW / 8;
    for (int it = 0; it < ntiles; ++it) {
      const int st = it % kStages;
      mbar_wait(&S.full[st], (it / kStages) & 1);
#pragma unroll
      for (int k0 = 0; k0 < kBK; k0 += KW) {
        // S = Q K^T
        float s[4 * NB];
        wgmma_fence();
        product_ss(s, dq, smem_desc(S.k[st] + k0 * kD));
        wgmma_commit();
        wgmma_wait();
        fence_acc(s);

        // s[4j + e]: row g (e < 2) or g + 8, key k0 + 8j + 2t + (e & 1)
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          const float2 bb = *reinterpret_cast<const float2*>(
              &S.bias[st][k0 + 8 * j + 2 * t]);
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
          const int valid = a.nk - it * kBK - k0;
          if (valid < KW) {
#pragma unroll
            for (int j = 0; j < NB; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                if (8 * j + 2 * t + (e & 1) >= valid)
                  s[4 * j + e] = -INFINITY;
          }
        }

        // online softmax of rows g (hr 0) and g + 8 (hr 1); a row's keys
        // live in the four lanes of a quad
        float alpha[2];
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          float mx = -INFINITY;
#pragma unroll
          for (int j = 0; j < NB; ++j)
            mx = fmaxf(mx, fmaxf(s[4 * j + 2 * hr], s[4 * j + 2 * hr + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m[hr], mx);
          alpha[hr] = exp_diff(m[hr], m_new);  // 0 at first
          float rs = 0.f;
#pragma unroll
          for (int j = 0; j < NB; ++j)
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

        // P in bf16 as the A operand
        uint32_t pa[NB / 2][4];
        a_operand(s, pa);
#pragma unroll
        for (int i = 0; i < 32; ++i) o[i] *= alpha[(i >> 1) & 1];

        // O += P V
        fence_acc(o);
        wgmma_fence();
        product_rs(o, pa, smem_desc(S.v[st] + k0 * kD));
        wgmma_commit();
        wgmma_wait();
        fence_acc(o);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&S.empty[st]);
    }

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

// One slab to pack from: row (b, h, n) of the operand at phase p holds its
// 64 values at slab + b*sb + h*sh + n*sn + sd*d + p (elements), the slab
// 16-byte aligned; sd is 1 (then p = 0) or 3. The operands of one slab
// (SelfBlock's q, k, v at phases 0, 1, 2) are packed by one job, so the
// slab is read once: `phases` and `rot` are bit masks over p (rot: apply
// the rotary with the (B, rows, 64) tables), dst[p] each operand's
// (B, h, rows, 64) contiguous scratch.
struct PackJob {
  const __nv_bfloat16* slab;
  long long sb, sh, sn;
  int sd, rows, phases, rot;
  __nv_bfloat16* dst[3];
};

constexpr int kMaxOperands = 4;  // F's q, k, v, dO

struct PackArgs {
  PackJob job[kMaxOperands];
  int B, H;
  const __nv_bfloat16* cos;  // (B, rows, 64) contiguous, 16-byte aligned
  const __nv_bfloat16* sin;
};

constexpr int kPackThreads = 256;

// round(round(t*cos) + round(rotate_half(t)*sin)) over d lanes 8c..8c+7,
// each product and the sum rounded to bf16 as the plain version's eager
// bf16 ops round them (no FMA contraction).
__device__ __forceinline__ void rotate8(float (&t)[8], const uint4& cw,
                                        const uint4& sw) {
  const __nv_bfloat16* cv = reinterpret_cast<const __nv_bfloat16*>(&cw);
  const __nv_bfloat16* sv = reinterpret_cast<const __nv_bfloat16*>(&sw);
  float r[8];
#pragma unroll
  for (int i = 0; i < 8; i += 2) {  // rotate_half: (-t[2m+1], t[2m])
    r[i] = -t[i + 1];
    r[i + 1] = t[i];
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
    t[i] = round_t<__nv_bfloat16>(
        __fadd_rn(round_t<__nv_bfloat16>(__fmul_rn(t[i], to_f(cv[i]))),
                  round_t<__nv_bfloat16>(__fmul_rn(r[i], to_f(sv[i])))));
}

// Thread (row, c) writes d lanes 8c..8c+7 of one row of every operand of
// job blockIdx.y, from one read of that part of the row's slab.
__global__ void __launch_bounds__(kPackThreads)
    attention_pack_kernel(const PackArgs a) {
  const PackJob& j = a.job[blockIdx.y];
  const long long idx = (long long)blockIdx.x * kPackThreads + threadIdx.x;
  const long long row = idx >> 3;
  const int c = idx & 7;
  if (row >= (long long)a.B * a.H * j.rows) return;
  const int n = row % j.rows;
  const long long bh = row / j.rows;
  const int h = bh % a.H, b = bh / a.H;
  const __nv_bfloat16* src = j.slab + b * j.sb + h * j.sh + n * j.sn;
  uint4 w[3];
  if (j.sd == 3) {
#pragma unroll
    for (int i = 0; i < 3; ++i)
      w[i] = reinterpret_cast<const uint4*>(src + 24 * c)[i];
  } else {
    w[0] = *reinterpret_cast<const uint4*>(src + 8 * c);
  }
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(w);
  uint4 cw, sw;
  if (j.rot) {
    const long long off = ((long long)b * j.rows + n) * kD + 8 * c;
    cw = *reinterpret_cast<const uint4*>(a.cos + off);
    sw = *reinterpret_cast<const uint4*>(a.sin + off);
  }
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    if (!((j.phases >> p) & 1)) continue;
    float t[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) t[i] = to_f(j.sd == 3 ? e[3 * i + p] : e[i]);
    if ((j.rot >> p) & 1) rotate8(t, cw, sw);
    *reinterpret_cast<uint4*>(j.dst[p] + row * kD + 8 * c) =
        make_uint4(pack2(t[0], t[1]), pack2(t[2], t[3]), pack2(t[4], t[5]),
                   pack2(t[6], t[7]));
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// Error codes of the entry points besides CUDA's (ops/cuda_build.py names
// them): a tensor map the CUDA driver refused, a register count that would
// leave setmaxnreg waiting, a CUDA driver without cuTensorMapEncodeTiled.
constexpr int kErrTensorMap = -1;
constexpr int kErrRegisters = -2;
constexpr int kErrNoEncoder = -3;

// One operand as the wrapper describes it, 8 long longs: pointer (the slab
// for a packed operand), element strides b, h, n of its rows, d stride,
// pack (0: read directly, 1: pack), phase, scratch pointer.
struct Operand90 {
  const __nv_bfloat16* ptr;
  long long sb, sh, sn;
  int sd, pack, phase;
  __nv_bfloat16* scratch;
};

inline Operand90 read_operand(const long long* v) {
  return Operand90{reinterpret_cast<const __nv_bfloat16*>(v[0]), v[1], v[2],
                   v[3], (int)v[4], (int)v[5], (int)v[6],
                   reinterpret_cast<__nv_bfloat16*>(v[7])};
}

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// libraries need no -lcuda.
inline PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// cuTensorMapEncodeTiled works in the calling thread's current context, which
// a thread that has made no runtime call yet does not have: autograd's
// device thread running a backward whose first node is kernel F. So the
// first encode of each thread has the runtime bind its primary context
// (cudaFree of nullptr frees nothing).
inline void bind_context() {
  static thread_local bool bound = false;
  if (!bound) {
    cudaFree(nullptr);
    bound = true;
  }
}

// 4-D (d, rows, h, B) map of bf16 rows, 64x64 boxes, 128-byte swizzle;
// element strides of rows, heads and batches.
inline int encode_map(CUtensorMap* map, const void* ptr, int rows, int H,
                      int B, long long sn, long long sh, long long sb) {
  auto encode = tensor_map_encoder();
  if (encode == nullptr) return kErrNoEncoder;
  bind_context();
  cuuint64_t dims[4] = {(cuuint64_t)kD, (cuuint64_t)rows, (cuuint64_t)H,
                        (cuuint64_t)B};
  cuuint64_t strides[3] = {(cuuint64_t)sn * 2, (cuuint64_t)sh * 2,
                           (cuuint64_t)sb * 2};
  cuuint32_t box[4] = {(cuuint32_t)kD, 64, 1, 1};
  cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrTensorMap;
}

// Once per kernel: its dynamic shared memory limit, and a check that
// setmaxnreg.inc will find the registers it asks for (it waits until the
// block's pool holds them): refuse a build whose entry register count
// would leave it waiting for ever. Cfg gives the block's threads, its
// consumer warpgroups (nwg; the rest of the block is the producer
// warpgroup) and the consumers' count. The result is kept.
template <typename Cfg>
int configure(const void* kernel, size_t smem) {
  static const void* seen = nullptr;
  static int status = 0;
  if (seen == kernel) return status;
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return (int)err;
  if (fa.numRegs > Cfg::consumer_regs ||
      (Cfg::threads - 128 * Cfg::nwg) * (fa.numRegs - kProducerRegs) <
          Cfg::nwg * 128 * (Cfg::consumer_regs - fa.numRegs)) {
    status = kErrRegisters;
  } else {
    status = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  seen = kernel;
  return status;
}

// The pack pass over the n operands (`ops`, 8 long longs each as
// read_operand reads them) that ask for it, in one launch: one job per
// slab, the operands of one slab at free phases sharing it. rows[i] is
// operand i's row count; bit i of rot applies the rotary (the (B, rows, 64)
// tables cos, sin) to operand i. Fills op[0..n).
inline int pack_operands(Operand90* op, const long long* ops,
                         const int* rows, int n, int rot, const void* cos,
                         const void* sin, int B, int H, cudaStream_t stream) {
  PackArgs pk{};
  int njobs = 0, max_rows = 0;
  for (int i = 0; i < n; ++i) {
    op[i] = read_operand(ops + 8 * i);
    const Operand90& o = op[i];
    if (!o.pack) continue;
    // the job of the same slab, if one has this phase free, else a new one
    int jb = 0;
    while (jb < njobs &&
           !(pk.job[jb].slab == o.ptr && pk.job[jb].sb == o.sb &&
             pk.job[jb].sh == o.sh && pk.job[jb].sn == o.sn &&
             pk.job[jb].sd == o.sd && pk.job[jb].rows == rows[i] &&
             !((pk.job[jb].phases >> o.phase) & 1)))
      ++jb;
    if (jb == njobs)
      pk.job[njobs++] = PackJob{o.ptr, o.sb, o.sh, o.sn, o.sd, rows[i], 0, 0,
                                {nullptr, nullptr, nullptr}};
    pk.job[jb].phases |= 1 << o.phase;
    pk.job[jb].rot |= ((rot >> i) & 1) << o.phase;
    pk.job[jb].dst[o.phase] = o.scratch;
    max_rows = rows[i] > max_rows ? rows[i] : max_rows;
  }
  if (njobs == 0) return 0;
  pk.B = B;
  pk.H = H;
  pk.cos = static_cast<const __nv_bfloat16*>(cos);
  pk.sin = static_cast<const __nv_bfloat16*>(sin);
  const long long threads = (long long)B * H * max_rows * 8;
  const dim3 grid((unsigned)((threads + kPackThreads - 1) / kPackThreads),
                  njobs);
  attention_pack_kernel<<<grid, kPackThreads, 0, stream>>>(pk);
  return (int)cudaGetLastError();
}

// Operand o's tensor map: its packed (B, H, rows, 64) scratch, or the
// operand read in place through its strides.
inline int operand_map(CUtensorMap* map, const Operand90& o, int rows, int H,
                       int B) {
  const long long rs = (long long)rows * kD;
  return o.pack ? encode_map(map, o.scratch, rows, H, B, kD, rs, H * rs)
                : encode_map(map, o.ptr, rows, H, B, o.sn, o.sh, o.sb);
}

// The pack pass, then the loop: q (B, H, a.nq, 64), k and v
// (B, H, a.nk, 64) as `ops` (3 x 8, read_operand) describes them; rot
// packs q and k through the (B, a.nq, 64) tables. The kernel's grid is
// (a.nq / 64 NWG, H, B); it takes the three maps and `a` (Args, StatsArgs
// or SegArgs).
template <int NWG, typename Kernel, typename A>
int attention(Kernel kernel, const long long* ops, bool rot,
              const void* cos, const void* sin, const A& a, int B, int H,
              cudaStream_t stream) {
  const int N = a.nq, M = a.nk;
  Operand90 op[3];
  const int rows[3] = {N, M, M};
  int err = pack_operands(op, ops, rows, 3, rot ? 3 : 0, cos, sin, B, H,
                          stream);
  if (err != 0) return err;
  CUtensorMap maps[3];
  for (int i = 0; i < 3; ++i) {
    err = operand_map(&maps[i], op[i], rows[i], H, B);
    if (err != 0) return err;
  }
  err = configure<Config<NWG>>(reinterpret_cast<const void*>(kernel),
                               smem_bytes<NWG>());
  if (err != 0) return err;
  const dim3 grid((N + 64 * NWG - 1) / (64 * NWG), H, B);
  kernel<<<grid, Config<NWG>::threads, smem_bytes<NWG>(), stream>>>(
      maps[0], maps[1], maps[2], a);
  return (int)cudaGetLastError();
}

// The loop's arguments of the bias kernels (A, E): the (B, M) float32 key
// bias, the bf16 output through `out_strides` (b, h, n; d unit).
inline Args bias_args(const float* bias, void* out,
                      const long long* out_strides, int N, int M,
                      float scale) {
  return Args{bias, static_cast<__nv_bfloat16*>(out),
              {out_strides[0], out_strides[1], out_strides[2]}, N, M,
              scale};
}

}  // namespace sm90
}  // namespace ei

// Dynamic shared memory of one block of the loop with `nwg` consumer
// warpgroups (1 or 2), for the build report.
extern "C" long long ei_sm90_smem_bytes(int nwg) {
  return nwg == 1 ? (long long)ei::sm90::smem_bytes<1>()
                  : (long long)ei::sm90::smem_bytes<2>();
}
