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
// Design. Unlike the library kernel it keeps the accumulator unnormalised
// and divides once at the end, and its key tiles are 64 wide, not 128:
// equal up to float32 rounding. It has no N*M limit, and ragged N and M
// (not multiples of the tile) are masked in the kernel.
//  - bfloat16 (the main path): the Hopper loop of flash_sm90.cuh in its
//    segment mode (SegArgs), 64 kNwg query rows a block: the producer warp
//    writes each tile's 64 int32 key ids beside the K and V tiles it
//    brings by TMA, each consumer warp holds its two rows' query ids in
//    registers and adds kMaskValue after the scale where they differ; keys
//    past M get -inf by their index. The rotated q and k and the cross
//    directions' head views are read in place; the self-attention's
//    stride-3 v is packed first into contiguous scratch;
//  - float32 (the float32 configs): the SEG instance of the CUDA-core flash
//    loop of flash_attention.cuh, which reads each key's id beside its
//    tile; q, k and v are read through strides.
#include "flash_attention.cuh"
#include "flash_sm90.cuh"

namespace ei {

// consumer warpgroups of the bf16 loop: 128 query rows a block, as A
constexpr int kNwg = 2;

__global__ void __launch_bounds__(kThreads)
    flash_segment_kernel(const Problem p) {
  extern __shared__ float4 smem4[];
  flash_block<float, false, Tiles<float>::rows, true>(
      p, blockIdx.z, blockIdx.y, blockIdx.x * Tiles<float>::rows, smem4);
}

static int launch(const Problem& p, int B, cudaStream_t stream) {
  using Tl = Tiles<float>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_segment_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Tl::smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.nq + Tl::rows - 1) / Tl::rows, p.heads, B);
  flash_segment_kernel<<<grid, Tl::threads, Tl::smem, stream>>>(p);
  return (int)cudaGetLastError();
}

__global__ void __launch_bounds__(sm90::Config<kNwg>::threads,
                                  sm90::Config<kNwg>::min_blocks)
    flash_segment_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const sm90::SegArgs a) {
  sm90::attention_block<kNwg>(tq, tk, tv, a, blockIdx.x * 64 * kNwg,
                              blockIdx.y, blockIdx.z);
}

}  // namespace ei

// float32: q: (B, H, N, 64); k, v: (B, H, M, 64), through `qkv_strides`
// (12 element strides: q, k, v, each (b, h, n, d)); q_seg: (B, N) and
// kv_seg: (B, M) int32 contiguous; out: (B, H, N, 64) through
// `out_strides` (4). Returns the CUDA error code of the launch (0 on
// success); bfloat16 takes ei_flash_segment_sm90.
extern "C" int ei_flash_segment(int dtype, const void* q, const void* k,
                                const void* v, const long long* qkv_strides,
                                const int* q_seg, const int* kv_seg,
                                void* out, const long long* out_strides,
                                int B, int H, int N, int M, float sm_scale,
                                void* stream) {
  if (dtype != ei::kFloat32) return (int)cudaErrorInvalidValue;
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
  return ei::launch(p, B, static_cast<cudaStream_t>(stream));
}

// bfloat16: the pack pass (where the operand plan asks for it) and the
// Hopper loop in its segment mode. ops: q, k, v as 3 x 8 long longs
// (ei::sm90::read_operand; the wrapper's operand plan); q_seg: (B, N) and
// kv_seg: (B, M) int32 contiguous; out: (B, H, N, 64) bf16 through
// `out_strides` (b, h, n; d unit). Returns 0, a CUDA error code or one of
// ei::sm90's kErr* codes.
extern "C" int ei_flash_segment_sm90(const long long* ops, const int* q_seg,
                                     const int* kv_seg, void* out,
                                     const long long* out_strides, int B,
                                     int H, int N, int M, float sm_scale,
                                     void* stream) {
  ei::sm90::SegArgs a{};
  static_cast<ei::sm90::Args&>(a) =
      ei::sm90::bias_args(nullptr, out, out_strides, N, M, sm_scale);
  a.q_seg = q_seg;
  a.kv_seg = kv_seg;
  return ei::sm90::attention<ei::kNwg>(ei::flash_segment_sm90_kernel, ops,
                                       false, nullptr, nullptr, a, B, H,
                                       static_cast<cudaStream_t>(stream));
}
