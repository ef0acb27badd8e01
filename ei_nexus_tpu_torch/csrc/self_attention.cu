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
// Design, float32 (the float32 configs): the 4 MB float32 similarity of a
// problem does not fit a block's 227 KB of shared memory, so the TPU's
// whole-problem design becomes the flash loop of flash_attention.cuh: 64
// query rows per block, 64-key tiles streamed, online float32 softmax on
// the CUDA cores, the rotary applied while a q or k tile is loaded (a pair
// swap of adjacent lanes; the TPU kernel's +-1 permutation matmul was a
// Mosaic workaround), q/k/v read in place through strides.
//
// Design, bfloat16 (the main path): the Hopper loop of flash_sm90.cuh, 128
// query rows per block in two consumer warpgroups on wgmma, K and V tiles
// brought by TMA from a producer warp; a pack pass first writes the
// rotated q and k and the de-interleaved v (the stride-3 views of the Wqkv
// output) as contiguous scratch, once per token.
//
// ROT is a compile-time flag so that the rotary-free variant (TPU kernel
// `_generic_fwd_kernel`) is the same code with ROT=false.
#include "flash_attention.cuh"
#include "flash_sm90.cuh"

namespace ei {

template <typename T, bool ROT>
__global__ void __launch_bounds__(kThreads)
    self_attention_kernel(const Problem p) {
  extern __shared__ float4 smem4[];
  flash_block<T, ROT>(p, blockIdx.z, blockIdx.y,
                      blockIdx.x * Tiles<T>::rows, smem4);
}

static int launch(const Problem& p, int B, int H, cudaStream_t stream) {
  auto kernel = self_attention_kernel<float, true>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Tiles<float>::smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.nq + Tiles<float>::rows - 1) / Tiles<float>::rows, H, B);
  kernel<<<grid, Tiles<float>::threads, Tiles<float>::smem, stream>>>(p);
  return (int)cudaGetLastError();
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

// float32: q, k, v: (B, H, N, 64) through `qkv_strides` (12 element
// strides: q, k, v, each (b, h, n, d)); cos, sin: (B, N, 64) contiguous;
// bias: (B, N) float32 contiguous; out: (B, H, N, 64) through
// `out_strides` (4). Returns the CUDA error code of the launch (0 on
// success); bfloat16 takes ei_self_attention_sm90.
extern "C" int ei_self_attention_rot(int dtype, const void* q, const void* k,
                                     const void* v,
                                     const long long* qkv_strides,
                                     const void* cos, const void* sin,
                                     const float* bias, void* out,
                                     const long long* out_strides, int B,
                                     int H, int N, float scale,
                                     void* stream) {
  if (dtype != ei::kFloat32) return (int)cudaErrorInvalidValue;
  ei::Problem p;
  p.q = ei::make_operand(q, qkv_strides);
  p.k = ei::make_operand(k, qkv_strides + 4);
  p.v = ei::make_operand(v, qkv_strides + 8);
  p.cos = cos;
  p.sin = sin;
  p.bias = bias;
  p.o = ei::make_output(out, out_strides);
  p.nq = N;
  p.nk = N;
  p.scale = scale;
  return ei::launch(p, B, H, static_cast<cudaStream_t>(stream));
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
