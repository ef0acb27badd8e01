// Kernel A: LightGlue self-attention with the rotary encoding fused in.
//
// Replaces: ei_nexus_tpu/ops/pallas_attention.py `_whole_rot_kernel`
// (reached through `self_attention(..., rot=)`), the TPU kernel that keeps
// one whole (batch, head) problem in VMEM.
//
// What bounds it on an H100: at the flagship shapes (B=8, h=4, N=1024,
// d=64, bf16) one call does 8.6 GFLOP of products against 18.9 MB of
// inputs and outputs, i.e. ~450 FLOP per byte, above the card's ~295
// FLOP/byte ridge, so it is compute-bound (bound ~8.7 us at 989 TFLOP/s).
//
// Design, float32 (the float32 configs): the 3xTF32 Hopper loop of
// flash_tf32.cuh, 64 query rows a consumer warpgroup on wgmma, after a
// pack pass that rotates q and k, splits q, k and v into TF32 hi/lo planes
// and transposes v, once per token (any strides, the stride-3 views of the
// Wqkv output included). The 4 MB float32 similarity of a problem does
// not fit a block's 227 KB of shared memory, so the TPU's whole-problem
// design becomes a flash loop in both types; the rotary is a pair swap of
// adjacent lanes (the TPU kernel's +-1 permutation matmul was a Mosaic
// workaround).
//
// Design, bfloat16 (the main path): the Hopper loop of flash_sm90.cuh, 128
// query rows per block in two consumer warpgroups on wgmma, K and V tiles
// brought by TMA from a producer warp; a pack pass first writes the
// rotated q and k and the de-interleaved v (the stride-3 views of the Wqkv
// output) as contiguous scratch, once per token.
#include "flash_sm90.cuh"
#include "flash_tf32.cuh"

namespace ei {

// float32: rows 64x.. of head y, batch z.
__global__ void __launch_bounds__(tf32::kThreads, 1)
    self_attention_tf32_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const tf32::Args a) {
  tf32::attention_block(tq, tk, tv, a, blockIdx.x * 64, blockIdx.y,
                        blockIdx.z);
}

__global__ void __launch_bounds__(sm90::Config<2>::threads,
                                  sm90::Config<2>::min_blocks)
    self_attention_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const sm90::Args a) {
  sm90::attention_block<2>(tq, tk, tv, a, blockIdx.x * 128, blockIdx.y,
                           blockIdx.z);
}

}  // namespace ei

// float32: the loop over the planes the pack pass (ei_attention_pack_tf32)
// wrote: q_planes, k_planes (B, H, 2, N, 64) rotated and split, v_planes
// (B, H, 2, 64, N rounded up to 64) transposed and split; bias: (B, N)
// float32 contiguous; out: (B, H, N, 64) float32 through `out_strides`
// (b, h, n; d unit). Returns 0, a CUDA error code or one of ei::sm90's
// kErr* codes.
extern "C" int ei_self_attention_tf32(const float* q_planes,
                                      const float* k_planes,
                                      const float* v_planes,
                                      const float* bias, void* out,
                                      const long long* out_strides, int B,
                                      int H, int N, float scale,
                                      void* stream) {
  return ei::tf32::attention(
      ei::self_attention_tf32_kernel, q_planes, k_planes, v_planes,
      ei::tf32::bias_args(bias, out, out_strides, N, N, scale), B, H,
      static_cast<cudaStream_t>(stream));
}

// bfloat16: the pack pass and the Hopper loop. ops: q, k, v as 3 x 8 long
// longs (ei::sm90::read_operand; the wrapper's operand plan); cos, sin:
// (B, N, 64) bf16 contiguous; bias: (B, N) float32 contiguous; out:
// (B, H, N, 64) bf16 through `out_strides` (b, h, n; d unit). Returns 0,
// a CUDA error code or one of ei::sm90's kErr* codes.
extern "C" int ei_self_attention_sm90(const long long* ops, const void* cos,
                                      const void* sin, const float* bias,
                                      void* out,
                                      const long long* out_strides, int B,
                                      int H, int N, float scale,
                                      void* stream) {
  return ei::sm90::attention<2>(
      ei::self_attention_sm90_kernel, ops, true, cos, sin,
      ei::sm90::bias_args(bias, out, out_strides, N, N, scale), B, H,
      static_cast<cudaStream_t>(stream));
}
