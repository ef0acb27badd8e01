// Kernel L: LightGlue's float32 linear layers, y = x W^T + b (+ r), on the
// tensor cores in 3xTF32.
//
// Replaces no TPU kernel: the JAX package leaves nn.Dense to XLA's dot. On
// the H100 a float32 F.linear with TF32 off is cuBLAS's SGEMM on the CUDA
// cores (67 TFLOP/s at most), the largest single cost of the float32 eval
// forward; this kernel takes those products to the tensor cores at float32
// accuracy, as the attention loops of flash_tf32.cuh do.
//
// What it computes is what `linear_tf32_plain` defines
// (ops/linear_kernel.py): x (M, K) and W (N, K) each split as hi = tf32(v),
// lo = tf32(v - hi) (flash_tf32.cuh's tf32_round), the product taken as
// x_lo W_hi^T + x_hi W_lo^T + x_hi W_hi^T in float32 (~2^-21 relative per
// product, the lo*lo term dropped), then fl(y + b), then fl(r + that) where
// a residual r is given. x may come as two tensors, the consecutive parts
// of K (the FFN's [x, message]), the first a whole number of 32-column
// chunks.
//
// What bounds it: at LightGlue's shapes (M = 16384 tokens of a 16-pair
// batch; K, N of 256, 512, 768) a call is 2MNK = 2.1-8.6 GFLOP of float32
// products, three TF32 products each, at 495 TFLOP/s dense (165 TFLOP/s for
// the three), against 4 (MK + MN) + 8 NK bytes: (16384, 256 -> 768) takes
// 39 us of products and 20 us of bytes at 3.35 TB/s, and the products bound
// every shape. A flagship batch (9 layers, 164 calls) is 739 GFLOP of
// float32 products: 4.5 ms at the bound.
//
// Design:
//  - W's planes are split once, outside (`weight_planes`, kept beside the
//    parameter): (2, N, Kp) hi/lo, Kp = K rounded up to 32, each 16-column
//    group in the order the x fragments take (below), zeros past K;
//  - x is split in registers, never in device memory: a producer thread
//    keeps TMA loads (128-byte swizzle) of a 128 x 32 tile of x and the two
//    128 x 32 tiles of W's planes kStages chunks ahead; each of two consumer
//    warpgroups owns 64 rows of the 128 x 128 output tile, loads its x
//    fragments from the swizzled tile with 16-byte shared loads, splits them
//    and runs wgmma.m64n128k8 with A from registers (x_lo W_hi, x_hi W_lo,
//    x_hi W_hi over a chunk's four k8 slices: the small products first, as
//    product_qk); two register sets, so the split of chunk c + 1 overlaps
//    the products of chunk c, and a chunk's stage is freed when its
//    products are done. The producer is a warpgroup that gives its
//    registers to the consumers (setmaxnreg: 232 a consumer thread), since
//    a 384-thread block's entry count, 168, holds the accumulators and
//    both register sets but not the epilogue;
//  - persistent: one block an SM walks the output tiles (n fastest, so the
//    blocks in flight share x's rows in L2); the producer runs on into the
//    next tile while the consumers finish the last (K is 256 or 512: a
//    tile's main loop is only 8 or 16 chunks, so the epilogue matters);
//  - the epilogue: each warpgroup writes acc + bias (+ residual) a 64 x 32
//    slab at a time into one of its two swizzled slab buffers in shared
//    memory and its leader stores the slab by TMA, which clips rows past M
//    and columns past N; the warpgroup goes on while the stores drain.
//    Stores from the registers (a warp's row-quads 32 bytes apart) held
//    every block on the same bursts of writes at the end of each tile:
//    10-23% of a call at these shapes. The epilogue's reads start early:
//    the lane's bias columns load into registers as the tile's products
//    begin, its residual rows are prefetched to L2 then and read into
//    registers two slabs ahead, all of a slab's at once (read one by one
//    between the shared-memory writes, they cost more than the residual
//    add they replace);
//  - shared memory: four stages of x and W's planes (48 KB each) and the
//    two warpgroups' two slab buffers (8 KB each), 225 KB: one block an
//    SM;
//  - fragment order: lane (g, t) loads columns 4t .. 4t + 3 of a 16-column
//    group in one 16-byte load; k8 slice 2p of group p takes columns 4t and
//    4t + 1 as its A columns t and t + 4, slice 2p + 1 columns 4t + 2 and
//    4t + 3. W's planes hold their columns in that order
//    (`linear_k_order`), so the product is unchanged. Lane g of a warp
//    reads tile row row_of(g) (0, 4, 1, 5, 2, 6, 3, 7; + 8), so the two rows
//    a quarter-warp loads sit in disjoint halves of the swizzled banks, and
//    the epilogue stores accumulator row g to that row;
//  - rows past M and columns past K are zero-filled by TMA.
#include "flash_tf32.cuh"

namespace ei {
namespace tf32 {
namespace lin {

using sm90::smem_u32;

constexpr int kBM = 128;         // output rows a tile: two warpgroups of 64
constexpr int kBN = 128;         // output columns a tile
constexpr int kBK = 32;          // a chunk of K: one 128-byte swizzle atom
constexpr int kStages = 4;       // chunks in flight
constexpr int kConsumers = 2;    // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);  // and a producer warpgroup
// registers a consumer thread takes (setmaxnreg.inc) once the producer
// warpgroup has given its own back down to sm90::kProducerRegs
constexpr int kConsumerRegs = 232;
constexpr int kTile = kBM * kBK;                  // floats of a 128 x 32 tile
constexpr int kStageBytes = 3 * kTile * 4;        // x, W hi, W lo
constexpr int kSlab = 64 * kBK;  // a warpgroup's 64 rows of 32 output columns
constexpr int kSlabs = kBN / kBK;   // slabs of an output tile's columns
constexpr int kOutBufs = 2;      // slab buffers a warpgroup

struct Shared {
  float x[kStages][kTile];       // 1024-byte aligned tiles
  float w[kStages][2][kTile];    // W's hi and lo planes
  float out[kConsumers][kOutBufs][kSlab];   // each warpgroup's output rows
  uint64_t full[kStages], empty[kStages];
};
// dynamic shared memory of one block: the tiles plus room to align them
constexpr size_t kSmemBytes = sizeof(Shared) + 1024;

struct Args {
  const float* bias;      // (N,) float32, or null
  const float* residual;  // (M, N) float32 through ldr, or null
  long long ldr;
  int M, N;
  int chunks;             // 32-column chunks of K a tile
  int split;              // chunks read from the first part of x
  int tiles_n, tiles;
};

// One 32-float x 128-row box of a 2-D (columns, rows) tensor map.
__device__ __forceinline__ void tma_load2(float* dst, const CUtensorMap& map,
                                          int col, int row, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(col), "r"(row),
      "r"(smem_u32(bar))
      : "memory");
}

// One 32-float x 128-row box of plane `plane` of a 3-D (columns, rows,
// plane) tensor map.
__device__ __forceinline__ void tma_load3(float* dst, const CUtensorMap& map,
                                          int col, int row, int plane,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(col), "r"(row), "r"(plane),
      "r"(smem_u32(bar))
      : "memory");
}

// One 32-float x 64-row box of a 2-D (columns, rows) tensor map from
// shared memory to global memory, in the thread's bulk group.
__device__ __forceinline__ void tma_store2(const CUtensorMap& map,
                                           const float* src, int col,
                                           int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, "
      "%2}], [%3];\n" ::"l"(reinterpret_cast<uint64_t>(&map)),
      "r"(col), "r"(row), "r"(smem_u32(src))
      : "memory");
}

// This warpgroup's 128 threads meet at named barrier 1 + wg.
__device__ __forceinline__ void group_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// Row i, columns c and c + 1 (c even) of a 64 x 32 float slab in TMA's
// 128-byte swizzle.
__device__ __forceinline__ void put2(float* slab, int i, int c, float2 v) {
  *reinterpret_cast<float2*>(reinterpret_cast<char*>(slab) + i * 128 +
                             (((c >> 2) ^ (i & 7)) << 4) + (c & 3) * 4) = v;
}

// Wait until at most N of the thread's committed bulk groups are still
// reading shared memory.
template <int N> __device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Wait until at most N committed wgmma groups are pending.
template <int N> __device__ __forceinline__ void wgmma_wait_n() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

#define EI_L8(d, i)                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),             \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// D (64 x 128 f32) += A B over one k8 slice: A (64 x 8 TF32) from
// registers, lane (g, t) of warp w holding rows 16w + g (+ 8) at columns
// t, t + 4 (a[0] = (g, t), a[1] = (g + 8, t), a[2] = (g, t + 4), a[3] =
// (g + 8, t + 4)); B (128 rows x 8) K-major in shared memory.
__device__ __forceinline__ void wgmma_rs128(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, "
      "1;\n}\n"
      : EI_L8(d, 0), EI_L8(d, 8), EI_L8(d, 16), EI_L8(d, 24), EI_L8(d, 32),
        EI_L8(d, 40), EI_L8(d, 48), EI_L8(d, 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef EI_L8

// The tile row that fragment row g (0..7) of a warp reads.
__device__ __forceinline__ int row_of(int g) {
  return (g >> 1) | ((g & 1) << 2);
}

// 16 bytes at columns 4c .. 4c + 3 of row r of a 128 x 32 float tile in
// TMA's 128-byte swizzle (16-byte unit c of a row stored at c ^ (r % 8)).
__device__ __forceinline__ float4 load16(const float* tile, int r, int c) {
  return *reinterpret_cast<const float4*>(
      reinterpret_cast<const char*>(tile) + r * 128 + ((c ^ (r & 7)) << 4));
}

// The hi and lo A fragments of one k8 slice from its values (row g, col
// t), (row g + 8, col t), (row g, col t + 4), (row g + 8, col t + 4).
__device__ __forceinline__ void split_frag(float v0, float v1, float v2,
                                           float v3, uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
  const float v[4] = {v0, v1, v2, v3};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float h = tf32_round(v[e]);
    hi[e] = __float_as_uint(h);
    lo[e] = __float_as_uint(tf32_round(v[e] - h));
  }
}

// Chunk `it` (over all the block's tiles) of a consumer warpgroup: wait for
// its stage, split the lane's x values of rows r and r + 8 into register
// set SET, issue the chunk's twelve products and commit them.
template <int SET>
__device__ __forceinline__ void chunk(Shared& S, float (&acc)[64],
                                      uint32_t (&fh)[2][4][4],
                                      uint32_t (&fl)[2][4][4], int it,
                                      int r, int t) {
  const int st = it % kStages;
  sm90::mbar_wait(&S.full[st], (it / kStages) & 1);
  const float* xs = S.x[st];
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const float4 a = load16(xs, r, 4 * p + t);
    const float4 b = load16(xs, r + 8, 4 * p + t);
    split_frag(a.x, b.x, a.y, b.y, fh[SET][2 * p], fl[SET][2 * p]);
    split_frag(a.z, b.z, a.w, b.w, fh[SET][2 * p + 1], fl[SET][2 * p + 1]);
  }
  sm90::wgmma_fence();
  const uint64_t wh = sm90::smem_desc(S.w[st][0]);
  const uint64_t wl = sm90::smem_desc(S.w[st][1]);
  // k8 slice kk: 32 bytes into the 128-byte rows
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs128(acc, fl[SET][kk], wh + 2 * kk);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs128(acc, fh[SET][kk], wl + 2 * kk);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs128(acc, fh[SET][kk], wh + 2 * kk);
  sm90::wgmma_commit();
}

// Free chunk `it`'s stage: one arrival a consumer warp.
__device__ __forceinline__ void release(Shared& S, int it) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) sm90::mbar_arrive(&S.empty[it % kStages]);
}

// The lane's residual values of one 32-column slab from column n0: rows
// m and m + 8, columns n0 + 8jj + 2t and the next (zeros past M and N).
__device__ __forceinline__ void load_residual(const Args& a,
                                              float2 (&dst)[2][kBK / 8],
                                              int m, int n0, int t) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr)
#pragma unroll
    for (int jj = 0; jj < kBK / 8; ++jj) {
      const int row = m + 8 * hr, n = n0 + 8 * jj + 2 * t;
      dst[hr][jj] = row < a.M && n < a.N
                        ? *reinterpret_cast<const float2*>(
                              a.residual + row * a.ldr + n)
                        : make_float2(0.f, 0.f);
    }
}

// tx0, tx1: 2-D (columns, rows) maps of x's two parts (tx1 = tx0 where x
// is one tensor), tw: the 3-D (Kp, N, 2) map of W's planes, all with
// 32 x 128 boxes; ty: the 2-D map of y, 32 x 64 boxes.
__global__ void __launch_bounds__(kThreads, 1)
    linear_tf32_kernel(const __grid_constant__ CUtensorMap tx0,
                       const __grid_constant__ CUtensorMap tx1,
                       const __grid_constant__ CUtensorMap tw,
                       const __grid_constant__ CUtensorMap ty,
                       const Args a) {
  auto& S = sm90::shared_as<Shared>();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&S.full[s], 1);                 // the producer
      sm90::mbar_init(&S.empty[s], 4 * kConsumers);   // each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * kConsumers) {
    // ---- producer: x's and W's planes' tiles of every chunk of every
    // tile of the block; the warpgroup gives its registers back, and one
    // thread works
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        sm90::kProducerRegs));
    if (warp == 4 * kConsumers && lane == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
        const int m0 = tile / a.tiles_n * kBM, n0 = tile % a.tiles_n * kBN;
        for (int c = 0; c < a.chunks; ++c, ++it) {
          const int st = it % kStages;
          sm90::mbar_wait(&S.empty[st], ((it / kStages) & 1) ^ 1);
          sm90::mbar_arrive_tx(&S.full[st], kStageBytes);
          if (c < a.split)
            tma_load2(S.x[st], tx0, c * kBK, m0, &S.full[st]);
          else
            tma_load2(S.x[st], tx1, (c - a.split) * kBK, m0, &S.full[st]);
          for (int p = 0; p < 2; ++p)
            tma_load3(S.w[st][p], tw, c * kBK, n0, p, &S.full[st]);
        }
      }
    }
    return;
  }

  // ---- consumers: warp w of warpgroup wg owns tile rows 64 wg + 16 w +
  // row_of(g) (+ 8)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int g = lane / 4, t = lane % 4, wg = warp / 4;
  const bool leader = threadIdx.x % 128 == 0;
  const int i0 = 16 * (warp % 4) + row_of(g);   // row in wg's 64
  const int r = 64 * wg + i0;
  uint32_t fh[2][4][4], fl[2][4][4];
  float acc[64];
  int it = 0;
  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
    const int m0 = tile / a.tiles_n * kBM, n0 = tile % a.tiles_n * kBN;
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    // the epilogue's reads start now and land during the products: the
    // lane's bias columns into registers, its residual rows toward L2
    float2 bias[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int n = n0 + 8 * j + 2 * t;
      bias[j] = a.bias != nullptr && n < a.N
                    ? *reinterpret_cast<const float2*>(a.bias + n)
                    : make_float2(0.f, 0.f);
    }
    if (a.residual != nullptr && n0 + kBK * t < a.N) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        if (m0 + r + 8 * hr < a.M)
          asm volatile("prefetch.global.L2 [%0];\n" ::"l"(
              a.residual + (m0 + r + 8 * hr) * a.ldr + n0 + kBK * t));
    }
    for (int c = 0; c < a.chunks; ++c, ++it) {
      if (c & 1)
        chunk<1>(S, acc, fh, fl, it, r, t);
      else
        chunk<0>(S, acc, fh, fl, it, r, t);
      wgmma_wait_n<1>();   // chunk c - 1's products are done
      if (c > 0) release(S, it - 1);
    }
    wgmma_wait_n<0>();
    release(S, it - 1);
    sm90::fence_acc(acc);

    // the epilogue, a 32-column slab at a time: y = acc + bias (+
    // residual) into one of the warpgroup's two swizzled slab buffers once
    // its previous store has read it, then its leader's TMA store (rows
    // past M and columns past N clipped), one bulk group a slab. The
    // lane's residual values are read two slabs ahead, all of a slab's at
    // once. acc[4j + e]: row g + 8 (e >> 1) of the warp's, column 8j + 2t
    // + (e & 1)
    float2 res[2][2][kBK / 8];
    if (a.residual != nullptr) {
      load_residual(a, res[0], m0 + r, n0, t);
      load_residual(a, res[1], m0 + r, n0 + kBK, t);
    }
#pragma unroll
    for (int sl = 0; sl < kSlabs; ++sl) {
      float* slab = S.out[wg][sl % kOutBufs];
      if (leader) bulk_wait_read<kOutBufs - 1>();
      group_sync(wg);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
#pragma unroll
        for (int jj = 0; jj < kBK / 8; ++jj) {
          const int j = kBK / 8 * sl + jj;
          float2 v = make_float2(acc[4 * j + 2 * hr],
                                 acc[4 * j + 2 * hr + 1]);
          if (a.bias != nullptr)
            v = make_float2(__fadd_rn(v.x, bias[j].x),
                            __fadd_rn(v.y, bias[j].y));
          if (a.residual != nullptr)
            v = make_float2(__fadd_rn(res[sl % 2][hr][jj].x, v.x),
                            __fadd_rn(res[sl % 2][hr][jj].y, v.y));
          put2(slab, i0 + 8 * hr, 8 * jj + 2 * t, v);
        }
      }
      if (a.residual != nullptr && sl + 2 < kSlabs)
        load_residual(a, res[sl % 2], m0 + r, n0 + kBK * (sl + 2), t);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      group_sync(wg);
      if (leader) {
        tma_store2(ty, slab, n0 + kBK * sl, m0 + 64 * wg);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    }
  }
  // the last stores have read their slabs before the block's shared
  // memory goes
  if (leader) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// 2-D map of a row-major float32 matrix of `rows` x `cols` with a row
// stride of `ld` elements: 32 x `box_rows` boxes, 128-byte swizzle.
inline int matrix_map(CUtensorMap* map, const float* ptr, int cols, int rows,
                      long long ld, int box_rows = kBM) {
  auto encode = sm90::tensor_map_encoder();
  if (encode == nullptr) return sm90::kErrNoEncoder;
  sm90::bind_context();
  cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  cuuint64_t strides[1] = {(cuuint64_t)ld * 4};
  cuuint32_t box[2] = {kBK, (cuuint32_t)box_rows};
  cuuint32_t estr[2] = {1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(ptr), dims,
      strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : sm90::kErrTensorMap;
}

// 3-D (kp, n, 2) map of W's contiguous hi/lo planes: 32 x 128 boxes,
// 128-byte swizzle.
inline int planes_map(CUtensorMap* map, const float* ptr, int kp, int n) {
  auto encode = sm90::tensor_map_encoder();
  if (encode == nullptr) return sm90::kErrNoEncoder;
  sm90::bind_context();
  const cuuint64_t row = (cuuint64_t)kp * 4;
  cuuint64_t dims[3] = {(cuuint64_t)kp, (cuuint64_t)n, 2};
  cuuint64_t strides[2] = {row, row * n};
  cuuint32_t box[3] = {kBK, kBN, 1};
  cuuint32_t estr[3] = {1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(ptr), dims,
      strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : sm90::kErrTensorMap;
}

constexpr int kMaxDevices = 16;

// Once a device: a check that setmaxnreg.inc will find the registers it
// asks for (it waits until the block's pool holds them: the producer
// warpgroup frees 128 (R - kProducerRegs) of an entry count R, the
// consumers take 256 (kConsumerRegs - R)), the kernel's dynamic shared
// memory limit and the device's SM count (the persistent grid). Returns
// 0, a CUDA error code or sm90::kErrRegisters. Static: the function-local
// statics of an inline function are one object across every library a
// process loads, and each library's kernel needs its own attribute.
static int device_setup(int* sms) {
  static int status[kMaxDevices] = {}, count[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < kMaxDevices && count[dev] > 0) {
    *sms = count[dev];
    return status[dev];
  }
  cudaFuncAttributes fa;
  int st = (int)cudaFuncGetAttributes(&fa, linear_tf32_kernel);
  if (st == 0 && (fa.numRegs > kConsumerRegs ||
                  128 * (fa.numRegs - sm90::kProducerRegs) <
                      128 * kConsumers * (kConsumerRegs - fa.numRegs)))
    return sm90::kErrRegisters;
  if (st == 0)
    st = (int)cudaFuncSetAttribute(
        linear_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kSmemBytes);
  int n = 0;
  if (st == 0)
    st = (int)cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount,
                                     dev);
  if (st == 0 && dev < kMaxDevices) {
    count[dev] = n;
    status[dev] = st;
  }
  *sms = n;
  return st;
}

}  // namespace lin
}  // namespace tf32
}  // namespace ei

// y = x W^T + b (+ residual) in 3xTF32. x: its first k0 columns from x0
// (row stride ld0 elements), the next k1 from x1 (row stride ld1; k1 = 0
// where x is one tensor, else k0 a multiple of 32), each (M, k) float32,
// 16-byte aligned, strides multiples of 4; w_planes: (2, N, Kp) float32
// contiguous, Kp = k0 + k1 rounded up to 32 (`weight_planes`); bias: (N,)
// float32 or null; residual: (M, N) float32 through ldr, or null; out:
// (M, N) float32 through ldo, 16-byte aligned, ldo a multiple of 4; N even.
// Returns 0, a CUDA error code or one of ei::sm90's kErr* codes.
extern "C" int ei_linear_tf32(const float* x0, long long ld0, int k0,
                              const float* x1, long long ld1, int k1,
                              const float* w_planes, const float* bias,
                              const float* residual, long long ldr,
                              float* out, long long ldo, int M, int N,
                              void* stream) {
  using namespace ei::tf32::lin;
  if (M <= 0 || N <= 0 || N % 2 || k0 <= 0 || k1 < 0 || (k1 > 0 && k0 % kBK))
    return (int)cudaErrorInvalidValue;
  const int chunks = (k0 + k1 + kBK - 1) / kBK;
  CUtensorMap maps[4];
  int err = matrix_map(&maps[0], x0, k0, M, ld0);
  if (err == 0)
    err = k1 > 0 ? matrix_map(&maps[1], x1, k1, M, ld1)
                 : matrix_map(&maps[1], x0, k0, M, ld0);
  if (err == 0) err = planes_map(&maps[2], w_planes, chunks * kBK, N);
  if (err == 0) err = matrix_map(&maps[3], out, N, M, ldo, 64);
  int sms = 0;
  if (err == 0) err = device_setup(&sms);
  if (err != 0) return err;
  const int tiles_n = (N + kBN - 1) / kBN;
  const int tiles = (M + kBM - 1) / kBM * tiles_n;
  const Args a{bias, residual, ldr, M, N, chunks,
               k1 > 0 ? k0 / kBK : chunks, tiles_n, tiles};
  const int grid = tiles < sms ? tiles : sms;
  ei::tf32::lin::linear_tf32_kernel<<<grid, kThreads, kSmemBytes,
                                 static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], a);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of one block of kernel L, for the build report.
extern "C" long long ei_linear_tf32_smem_bytes() {
  return (long long)ei::tf32::lin::kSmemBytes;
}
