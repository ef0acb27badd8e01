// Kernel G: flash attention with segment-id masking, jax's TPU flash
// attention forward as LightGlue's "flash" setting calls it.
//
// Replaces: the library kernel jax.experimental.pallas.ops.tpu
// .flash_attention (`_flash_attention_kernel_single_batch`, launched by
// `_flash_attention_impl`), reached through `_flash_attention` in
// ei_nexus_tpu/models/lightglue.py from SelfBlock (scale d^-0.5, rotary
// applied before) and CrossBlock (two single-direction passes, scale 1).
// Its function, which differs from kernels A, B, D and E:
//   s = (q k^T) * sm_scale,  then  s += (qseg == kvseg ? 0 : -0.7 FLT_MAX)
// with int32 segment ids per query (B, N) and per key (B, M) compared for
// equality (LightGlue: every query 1, valid keys 1, invalid keys 2), an
// online float32 softmax whose probabilities P = exp(s - m) enter the PV
// product rounded to the value type before they are normalised. The mask
// value is finite, so a fully masked row is a uniform average of V, not
// NaN, and an all-masked first tile cannot poison the running max
// (exp(m_old - m_new) is 0 while m_old is -inf).
//
// What bounds it on an H100: at the flagship shapes (B=8, h=4, N=M=1024,
// d=64, bf16) one call does 8.6 GFLOP of products against ~17 MB of
// inputs and outputs (q, k, v, the output, two int32 id rows), so it is
// compute-bound (~8.7 us at 989 TFLOP/s); at N=M=2048, the token count the
// JAX package keeps this kernel for, 4x the operations for 2x the bytes.
//
// Design: the SEG instance of the flash loop of flash_attention.cuh (128
// query rows a block in bf16 on the tensor cores with mma.sync, 64 in
// float32 on the CUDA cores; 64-key tiles streamed), which reads each
// key's id beside its tile and compares it with the row's id held in a
// register. Unlike the library kernel it keeps the accumulator
// unnormalised and divides once at the end, and its key tiles are 64
// wide, not 128: equal up to float32 rounding. It has no N*M limit, and
// ragged N and M (not multiples of the tile) are masked in the kernel.
// q, k and v are read through strides; the output is written through
// strides. wgmma and TMA come later.
#include "flash_attention.cuh"

namespace ei {

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_segment_kernel(const Problem p) {
  extern __shared__ float4 smem4[];
  flash_block<T, false, Tiles<T>::rows, true>(
      p, blockIdx.z, blockIdx.y, blockIdx.x * Tiles<T>::rows, smem4);
}

template <typename T>
static int launch(const Problem& p, int B, cudaStream_t stream) {
  auto kernel = flash_segment_kernel<T>;
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
// strides: q, k, v, each (b, h, n, d)); q_seg: (B, N) and kv_seg: (B, M)
// int32 contiguous; out: (B, H, N, 64) through `out_strides` (4). Returns
// the CUDA error code of the launch (0 on success).
extern "C" int ei_flash_segment(int dtype, const void* q, const void* k,
                                const void* v, const long long* qkv_strides,
                                const int* q_seg, const int* kv_seg,
                                void* out, const long long* out_strides,
                                int B, int H, int N, int M, float sm_scale,
                                void* stream) {
  ei::Problem p;
  p.q = ei::make_operand(q, qkv_strides);
  p.k = ei::make_operand(k, qkv_strides + 4);
  p.v = ei::make_operand(v, qkv_strides + 8);
  p.cos = nullptr;
  p.sin = nullptr;
  p.bias = nullptr;
  p.q_seg = q_seg;
  p.kv_seg = kv_seg;
  p.o = ei::make_output(out, out_strides);
  p.nq = N;
  p.nk = M;
  p.scale = sm_scale;
  p.heads = H;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ei::kFloat32) return ei::launch<float>(p, B, s);
  if (dtype == ei::kBFloat16) return ei::launch<__nv_bfloat16>(p, B, s);
  return (int)cudaErrorInvalidValue;
}
