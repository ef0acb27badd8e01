// Kernel E: q-blocked row-softmax attention, with or without the rotary
// encoding fused in, N queries against M keys, any softmax scale and a
// key-side bias.
//
// Replaces: ei_nexus_tpu/ops/pallas_attention.py `_qblock_kernel` and
// `_qblock_rot_kernel` (reached through `_qblock_attention` from
// `self_attention` and `cross_attention_bidir` when block_q > 0 divides the
// token counts), the TPU kernels gridded (B, h, N / block_q) that hold a
// (block_q, d) query block against the whole (M, d) key and value rows in
// VMEM. LightGlue's q-blocked forward calls it 4 times a layer: two
// self-attentions (rotary fused, scale d^-0.5) and the two directions of
// the cross-attention (rotary-free, scale 1, pre-scaled operands).
//
// What bounds it on an H100: at the flagship shapes (B=8, h=4, N=M=1024,
// d=64) one call does 8.6 GFLOP of products against ~17-19 MB of inputs
// and outputs (bf16; twice that in float32), so it is compute-bound in
// either type: ~8.7 us at 989 TFLOP/s in bf16, ~52 us at the 3xTF32 rate
// (495 / 3 TFLOP/s) in float32.
//
// Design: a Hopper block already owns a query tile, so the TPU's q block
// becomes a flash loop with its query tile set to block_q, not a copy of
// the whole-row VMEM block: the block's block_q rows stay on chip while
// 64-key tiles of K and V stream through shared memory with an online
// float32 softmax. The grid is (N / block_q, h, B), E's (B, h, N / bq) in
// the card's order; rows and keys past the ends are masked, so N and M
// need not be multiples of block_q.
//  - bfloat16 (the main path): the Hopper loop of flash_sm90.cuh, one
//    consumer warpgroup on wgmma per 64 rows (block_q 64: one, 128: two),
//    K and V tiles brought by TMA from a producer warp. Operands TMA can
//    read (the rot-free cross directions' head views) are read in place;
//    the rotary calls' q and k, and stride-3 views, are packed first into
//    contiguous scratch, once per token.
//  - float32 (the float32 configs): the pack pass of flash_tf32.cuh (the
//    rotary calls' q and k rotated, the rot-free directions' not; q and k
//    split into TF32 hi/lo row planes, v into permuted V^T planes, any
//    strides), then the 3xTF32 loop of A over N queries and M keys, 64
//    query rows a block in one consumer warpgroup, grid ((N + 63) / 64,
//    h, B) for block_q 64 and 128 alike: E's output does not depend on
//    block_q (each query row's softmax is its own, whichever block holds
//    it), and two consumer warpgroups sharing a tile spilled on this loop
//    (flash_tf32.cuh, "budgets").
#include "flash_sm90.cuh"
#include "flash_tf32.cuh"

namespace ei {

// float32: rows 64x.. of head y, batch z.
__global__ void __launch_bounds__(tf32::kThreads, 1)
    qblock_attention_tf32_kernel(const __grid_constant__ CUtensorMap tq,
                                 const __grid_constant__ CUtensorMap tk,
                                 const __grid_constant__ CUtensorMap tv,
                                 const tf32::Args a) {
  tf32::attention_block(tq, tk, tv, a, blockIdx.x * 64, blockIdx.y,
                        blockIdx.z);
}

template <int NWG>
__global__ void __launch_bounds__(sm90::Config<NWG>::threads,
                                  sm90::Config<NWG>::min_blocks)
    qblock_attention_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                                 const __grid_constant__ CUtensorMap tk,
                                 const __grid_constant__ CUtensorMap tv,
                                 const sm90::Args a) {
  sm90::attention_block<NWG>(tq, tk, tv, a, blockIdx.x * 64 * NWG,
                             blockIdx.y, blockIdx.z);
}

}  // namespace ei

// float32: the loop over the planes the pack pass (ei_attention_pack_tf32)
// wrote: q_planes (B, H, 2, N, 64), k_planes (B, H, 2, M, 64) split (and
// rotated for the rotary calls), v_planes (B, H, 2, 64, M rounded up to
// 64) transposed and split; bias: (B, M) float32 contiguous; out:
// (B, H, N, 64) float32 through `out_strides` (b, h, n; d unit). block_q
// 64 and 128 both launch this loop (the wrapper refuses other values).
// Returns 0, a CUDA error code or one of ei::sm90's kErr* codes.
extern "C" int ei_qblock_attention_tf32(const float* q_planes,
                                        const float* k_planes,
                                        const float* v_planes,
                                        const float* bias, void* out,
                                        const long long* out_strides, int B,
                                        int H, int N, int M, float scale,
                                        void* stream) {
  return ei::tf32::attention(
      ei::qblock_attention_tf32_kernel, q_planes, k_planes, v_planes,
      ei::tf32::bias_args(bias, out, out_strides, N, M, scale), B, H,
      static_cast<cudaStream_t>(stream));
}

// bfloat16: the pack pass (where the operand plan asks for it) and the
// Hopper loop. ops: q, k, v as 3 x 8 long longs (ei::sm90::read_operand);
// cos, sin: (B, N, 64) bf16 contiguous, read only when `rot` is 1 (then
// N == M); bias: (B, M) float32 contiguous; out: (B, H, N, 64) bf16
// through `out_strides` (b, h, n; d unit); block_q: 64 or 128. Returns 0,
// a CUDA error code or one of ei::sm90's kErr* codes.
extern "C" int ei_qblock_attention_sm90(int block_q, int rot,
                                        const long long* ops,
                                        const void* cos, const void* sin,
                                        const float* bias, void* out,
                                        const long long* out_strides, int B,
                                        int H, int N, int M, float scale,
                                        void* stream) {
  if (rot && N != M) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const ei::sm90::Args a =
      ei::sm90::bias_args(bias, out, out_strides, N, M, scale);
  if (block_q == 64)
    return ei::sm90::attention<1>(ei::qblock_attention_sm90_kernel<1>, ops,
                                  rot != 0, cos, sin, a, B, H, s);
  if (block_q == 128)
    return ei::sm90::attention<2>(ei::qblock_attention_sm90_kernel<2>, ops,
                                  rot != 0, cos, sin, a, B, H, s);
  return (int)cudaErrorInvalidValue;
}
