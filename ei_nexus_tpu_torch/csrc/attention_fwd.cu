// Kernel D: the forward of the differentiable fused attention, row-softmax
// attention with any softmax scale and a key-side bias, N queries against
// M keys.
//
// Replaces: ei_nexus_tpu/ops/pallas_attention.py `_generic_fwd_kernel`
// (reached through `_whole_attention` and the custom VJP
// `fused_attention_vjp`), the TPU kernel that keeps one whole (batch, head)
// problem in VMEM. LightGlue's training step calls it 4 times a layer: two
// self-attentions (scale d^-0.5, rotary applied outside) and the two
// directions of the cross-attention (scale 1, pre-scaled operands).
//
// What bounds it on an H100: at the flagship shapes (B=8, h=4, N=M=1024,
// d=64, bf16) one call does 8.6 GFLOP of products (QK^T and PV) against
// ~17 MB of inputs and outputs, so it is compute-bound (~8.7 us at 989
// TFLOP/s).
//
// Design: the ROT=false instance of kernel A's flash loop
// (flash_attention.cuh): 128 (bf16, tensor cores, mma.sync) or 64 (float32,
// CUDA cores) query rows per block, 64-key tiles streamed, online float32
// softmax, the scale a runtime argument, q/k/v read through strides. For
// the backward it also writes each row's float32 log-sum-exp m + log(l),
// so kernel F recomputes P = exp(S - lse) without the TPU backward's first
// pass over the keys for m and Z.
#include "flash_attention.cuh"

namespace ei {

template <typename T>
__global__ void __launch_bounds__(kThreads)
    attention_fwd_kernel(const Problem p) {
  extern __shared__ float4 smem4[];
  flash_block<T, false>(p, blockIdx.z, blockIdx.y,
                        blockIdx.x * Tiles<T>::rows, smem4);
}

template <typename T>
static int launch(const Problem& p, int B, cudaStream_t stream) {
  auto kernel = attention_fwd_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Tiles<T>::smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.nq + Tiles<T>::rows - 1) / Tiles<T>::rows, p.heads, B);
  kernel<<<grid, Tiles<T>::threads, Tiles<T>::smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace ei

// q: (B, H, N, 64); k, v: (B, H, M, 64), through `qkv_strides` (12 element
// strides: q, k, v, each (b, h, n, d)); bias: (B, M) float32 contiguous;
// out: (B, H, N, 64) through `out_strides` (4); lse: (B, H, N) float32
// contiguous. Returns the CUDA error code of the launch (0 on success).
extern "C" int ei_attention_fwd(int dtype, const void* q, const void* k,
                                const void* v, const long long* qkv_strides,
                                const float* bias, void* out,
                                const long long* out_strides, float* lse,
                                int B, int H, int N, int M, float scale,
                                void* stream) {
  ei::Problem p;
  p.q = ei::make_operand(q, qkv_strides);
  p.k = ei::make_operand(k, qkv_strides + 4);
  p.v = ei::make_operand(v, qkv_strides + 8);
  p.cos = nullptr;
  p.sin = nullptr;
  p.bias = bias;
  p.o = ei::make_output(out, out_strides);
  p.nq = N;
  p.nk = M;
  p.scale = scale;
  p.lse = lse;
  p.heads = H;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ei::kFloat32) return ei::launch<float>(p, B, s);
  if (dtype == ei::kBFloat16) return ei::launch<__nv_bfloat16>(p, B, s);
  return (int)cudaErrorInvalidValue;
}
