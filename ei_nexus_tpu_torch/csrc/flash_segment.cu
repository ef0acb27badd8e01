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
// d=64) one call does 8.6 GFLOP of products against ~17 MB of inputs and
// outputs (bf16: q, k, v, the output, two int32 id rows; about twice that
// in float32), so it is compute-bound in either type: ~8.7 us at 989
// TFLOP/s in bf16, ~52 us at the 3xTF32 rate (495 / 3 TFLOP/s) in
// float32; at N=M=2048, the token count the JAX package keeps this kernel
// for, 4x the operations for 2x the bytes.
//
// Design. Unlike the library kernel it keeps the accumulator unnormalised
// and divides once at the end, and its key tiles are 64 wide, not 128:
// equal up to float32 rounding. It has no N*M limit, and ragged N and M
// (not multiples of the tile) are masked in the kernel. Both types run a
// Hopper loop of A in its segment mode (SegArgs): the producer warp writes
// each tile's 64 int32 key ids beside the K and V tiles it brings by TMA,
// each consumer warp holds its two rows' query ids in registers and adds
// kMaskValue after the scale where they differ; keys past M get -inf by
// their index. The rule is the general one (any ids, not LightGlue's all-1
// queries).
//  - bfloat16 (the main path): the loop of flash_sm90.cuh, 64 kNwg query
//    rows a block. The rotated q and k and the cross directions' head
//    views are read in place; the self-attention's stride-3 v is packed
//    first into contiguous scratch;
//  - float32 (the float32 configs): the pack pass of flash_tf32.cuh (q and
//    k split into TF32 hi/lo row planes, v into permuted V^T planes, any
//    strides, no rotary: LightGlue rotates q and k before the call), then
//    the 3xTF32 loop, 64 query rows a block in one consumer warpgroup.
#include "flash_sm90.cuh"
#include "flash_tf32.cuh"

namespace ei {

// consumer warpgroups of the bf16 loop: 128 query rows a block, as A
constexpr int kNwg = 2;

// float32: rows 64x.. of head y, batch z.
__global__ void __launch_bounds__(tf32::kThreads, 1)
    flash_segment_tf32_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const tf32::SegArgs a) {
  tf32::attention_block(tq, tk, tv, a, blockIdx.x * 64, blockIdx.y,
                        blockIdx.z);
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

// float32: the loop over the planes the pack pass (ei_attention_pack_tf32)
// wrote: q_planes (B, H, 2, N, 64), k_planes (B, H, 2, M, 64) split,
// v_planes (B, H, 2, 64, M rounded up to 64) transposed and split; q_seg:
// (B, N) and kv_seg: (B, M) int32 contiguous; out: (B, H, N, 64) float32
// through `out_strides` (b, h, n; d unit). Returns 0, a CUDA error code or
// one of ei::sm90's kErr* codes.
extern "C" int ei_flash_segment_tf32(const float* q_planes,
                                     const float* k_planes,
                                     const float* v_planes, const int* q_seg,
                                     const int* kv_seg, void* out,
                                     const long long* out_strides, int B,
                                     int H, int N, int M, float sm_scale,
                                     void* stream) {
  ei::tf32::SegArgs a{};
  static_cast<ei::tf32::Args&>(a) =
      ei::tf32::bias_args(nullptr, out, out_strides, N, M, sm_scale);
  a.q_seg = q_seg;
  a.kv_seg = kv_seg;
  return ei::tf32::attention(ei::flash_segment_tf32_kernel, q_planes,
                             k_planes, v_planes, a, B, H,
                             static_cast<cudaStream_t>(stream));
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
