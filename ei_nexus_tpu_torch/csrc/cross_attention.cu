// Kernel B: LightGlue's shared-QK bidirectional cross-attention.
//
// Replaces: ei_nexus_tpu/ops/pallas_attention.py `_cross_kernel` (reached
// through `cross_attention_bidir`), the TPU kernel that computes both
// directions of one batch element in VMEM:
//   m0 = softmax_row(qk0 qk1^T + bias1) v1
//   m1 = softmax_row(qk1 qk0^T + bias0) v0
// with qk pre-scaled by d^-0.25 on both sides (softmax scale 1) and
// key-side masks only.
//
// What bounds it on an H100: at the flagship shapes (B=8, h=4, N=M=1024,
// d=64, bf16), counting the shared similarity once, one call does 12.9
// GFLOP against 25.2 MB, so it is compute-bound (bound ~13 us at 989
// TFLOP/s).
//
// Design: ONE launch serves both directions. The grid's z axis runs over
// (batch, direction), and each block runs one direction's flash loop over
// 64 query rows, recomputing its similarity tile from the small operands as
// the TPU kernel recomputes the transposed similarity (`_cross_kernel`'s
// second product): sharing one QK^T tile between the directions would need
// a column softmax across blocks. The shorter side's surplus blocks exit
// whole, before any barrier is set up.
//  - bfloat16 (the main path): the Hopper loop of flash_sm90.cuh with one
//    consumer warpgroup (the fastest tile of kernel E), K and V tiles by
//    TMA from four tensor maps picked per direction, (qk0 -> qk1, v1,
//    bias1) and (qk1 -> qk0, v0, bias0); CrossBlock's head views are read
//    in place, anything the operand plan refuses TMA is packed first.
//  - float32 (the float32 configs): the 3xTF32 Hopper loop of
//    flash_tf32.cuh, 64 query rows a block in one consumer warpgroup, after
//    a pack pass that splits qk0, qk1, v0 and v1 into
//    TF32 hi/lo planes (v transposed) once per token; the Q planes of one
//    direction are the K planes of the other, so each side is packed once,
//    and four tensor maps are picked per direction as in bf16.
#include "flash_sm90.cuh"
#include "flash_tf32.cuh"

namespace ei {

struct CrossTf32Args {
  tf32::Args dir[2];  // direction 0: side-0 queries; 1: side-1 queries
};

// float32: block (x, y, z): query rows 64x.. of direction z & 1, head y,
// batch z / 2; tp0, tp1 the sides' row planes, tv0, tv1 their V^T planes.
__global__ void __launch_bounds__(tf32::kThreads, 1)
    cross_attention_tf32_kernel(const __grid_constant__ CUtensorMap tp0,
                                const __grid_constant__ CUtensorMap tp1,
                                const __grid_constant__ CUtensorMap tv0,
                                const __grid_constant__ CUtensorMap tv1,
                                const CrossTf32Args ca) {
  const bool d1 = blockIdx.z & 1;
  const tf32::Args a = d1 ? ca.dir[1] : ca.dir[0];
  const int q0 = blockIdx.x * 64;
  if (q0 >= a.nq) return;  // the shorter side's surplus blocks
  tf32::attention_block(d1 ? tp1 : tp0, d1 ? tp0 : tp1, d1 ? tv0 : tv1, a,
                        q0, blockIdx.y, blockIdx.z >> 1);
}

namespace sm90 {

struct CrossArgs {
  Args dir[2];  // direction 0: side-0 queries; 1: side-1 queries
};

// Block (x, y, z): query rows 64x.. of direction z & 1, head y, batch z / 2.
__global__ void __launch_bounds__(Config<1>::threads, Config<1>::min_blocks)
    cross_attention_sm90_kernel(const __grid_constant__ CUtensorMap tqk0,
                                const __grid_constant__ CUtensorMap tqk1,
                                const __grid_constant__ CUtensorMap tv0,
                                const __grid_constant__ CUtensorMap tv1,
                                const CrossArgs ca) {
  const bool d1 = blockIdx.z & 1;
  const Args a = d1 ? ca.dir[1] : ca.dir[0];
  const int q0 = blockIdx.x * 64;
  if (q0 >= a.nq) return;  // the shorter side's surplus blocks
  attention_block<1>(d1 ? tqk1 : tqk0, d1 ? tqk0 : tqk1, d1 ? tv0 : tv1, a,
                     q0, blockIdx.y, blockIdx.z >> 1);
}

}  // namespace sm90
}  // namespace ei

// float32: the loop of both directions over the planes the pack pass
// (ei_attention_pack_tf32) wrote: p0 (B, H, 2, N, 64) and p1
// (B, H, 2, M, 64) the split qk0 and qk1, vt0 (B, H, 2, 64, N rounded up
// to 64) and vt1 (B, H, 2, 64, M rounded up) the transposed, split v0 and
// v1; bias0: (B, N), bias1: (B, M) float32 contiguous; out0: (B, H, N, 64),
// out1: (B, H, M, 64) float32 through `out_strides` (6: out0, out1, each
// (b, h, n); d unit). Returns 0, a CUDA error code or one of ei::sm90's
// kErr* codes.
extern "C" int ei_cross_attention_tf32(const float* p0, const float* p1,
                                       const float* vt0, const float* vt1,
                                       const float* bias0,
                                       const float* bias1, void* out0,
                                       void* out1,
                                       const long long* out_strides, int B,
                                       int H, int N, int M,
                                       void* stream) {
  using namespace ei::tf32;
  CUtensorMap maps[4];
  int err = row_map(&maps[0], p0, N, H, B);
  if (err == 0) err = row_map(&maps[1], p1, M, H, B);
  if (err == 0) err = value_map(&maps[2], vt0, N, H, B);
  if (err == 0) err = value_map(&maps[3], vt1, M, H, B);
  if (err != 0) return err;
  const long long* os = out_strides;
  const ei::CrossTf32Args ca{{Args{bias1, static_cast<float*>(out0),
                                   {os[0], os[1], os[2]}, N, M, 1.f},
                              Args{bias0, static_cast<float*>(out1),
                                   {os[3], os[4], os[5]}, M, N, 1.f}}};
  err = configure(
      reinterpret_cast<const void*>(ei::cross_attention_tf32_kernel));
  if (err != 0) return err;
  const dim3 grid(((N > M ? N : M) + 63) / 64, H, 2 * B);
  ei::cross_attention_tf32_kernel<<<grid, kThreads, kSmemBytes,
                                    static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], ca);
  return (int)cudaGetLastError();
}

// bfloat16: the pack pass (where the operand plan asks for it) and one
// launch of the Hopper loop for both directions. ops: qk0, qk1, v0, v1 as
// 4 x 8 long longs (ei::sm90::read_operand); bias0: (B, N), bias1: (B, M)
// float32 contiguous; out0: (B, H, N, 64), out1: (B, H, M, 64) bf16
// through `out_strides` (6: out0, out1, each (b, h, n); d unit). Returns
// 0, a CUDA error code or one of ei::sm90's kErr* codes.
extern "C" int ei_cross_attention_sm90(const long long* ops,
                                       const float* bias0,
                                       const float* bias1, void* out0,
                                       void* out1,
                                       const long long* out_strides, int B,
                                       int H, int N, int M, void* stream) {
  using namespace ei::sm90;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Operand90 op[4];
  const int rows[4] = {N, M, N, M};
  int err = pack_operands(op, ops, rows, 4, 0, nullptr, nullptr, B, H, s);
  if (err != 0) return err;
  CUtensorMap maps[4];
  for (int i = 0; i < 4; ++i) {
    err = operand_map(&maps[i], op[i], rows[i], H, B);
    if (err != 0) return err;
  }
  err = configure<Config<1>>(
      reinterpret_cast<const void*>(cross_attention_sm90_kernel),
      smem_bytes<1>());
  if (err != 0) return err;
  const long long* os = out_strides;
  const CrossArgs ca{{Args{bias1, static_cast<__nv_bfloat16*>(out0),
                           {os[0], os[1], os[2]}, N, M, 1.f},
                      Args{bias0, static_cast<__nv_bfloat16*>(out1),
                           {os[3], os[4], os[5]}, M, N, 1.f}}};
  const dim3 grid(((N > M ? N : M) + 63) / 64, H, 2 * B);
  cross_attention_sm90_kernel<<<grid, Config<1>::threads, smem_bytes<1>(),
                                s>>>(maps[0], maps[1], maps[2], maps[3], ca);
  return (int)cudaGetLastError();
}
