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
// d=64) one call does 8.6 GFLOP of products (QK^T and PV) against ~17 MB
// of inputs and outputs (bf16; ~34 MB in float32), so it is compute-bound
// in either type: ~8.7 us at 989 TFLOP/s in bf16, ~52 us at the 3xTF32
// rate (495 / 3 TFLOP/s) in float32.
//
// Design. For the backward it writes each row's float32 statistics, the
// row max m and the row sum l of exp(s - m), so kernel F rebuilds
// P = exp(s - m) / l as the plain version does, without the TPU backward's
// first pass over the keys for m and Z. (A log-sum-exp m + log(l) would not
// do: a fully masked row's scores and m are all -1e9, where a float32 ulp
// is 64, so log(l) rounds away and exp(s - lse) gives P = 1 for every key,
// not 1/M.) The loop keeps m in natural units and forms exp(s - m) with
// the difference taken first, so such a row gets m = -1e9 and l = M.
//  - bfloat16 (the main path): the Hopper loop of flash_sm90.cuh with its
//    statistics epilogue (StatsArgs), 64 kNwg query rows a block, K and V
//    tiles by TMA from a producer warp, S = QK^T and O += PV on wgmma, the
//    scale a runtime argument, keys past M at -inf through the bias tile.
//    Operands TMA can read (the rotated q and k, the cross directions'
//    head views) are read in place; the self-attention's stride-3 v is
//    packed first into contiguous scratch, which the wrapper hands on to
//    kernel F, so F packs nothing;
//  - float32 (the float32 configs, such as the `train_matcher` entry's
//    LightGlue): the pack pass of flash_tf32.cuh (q and k split into TF32
//    hi/lo row planes, v into permuted V^T planes, through any strides,
//    no rotary), then the 3xTF32 Hopper loop of A with the statistics
//    epilogue (StatsArgs), the scale a runtime argument, 64 query rows a
//    block in one consumer warpgroup. Its score order, S = Qlo Khi^T +
//    Qhi Klo^T + Qhi Khi^T over k8 slices in order, then fl(fl(S x scale)
//    + bias), is the one kernel F's float32 blocks form, so that D's m and
//    l fit F's P.
#include "flash_sm90.cuh"
#include "flash_tf32.cuh"

namespace ei {

// consumer warpgroups of the bf16 loop: 128 query rows a block, as A
constexpr int kNwg = 2;

// float32: rows 64x.. of head y, batch z.
__global__ void __launch_bounds__(tf32::kThreads, 1)
    attention_fwd_tf32_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const tf32::StatsArgs a) {
  tf32::attention_block(tq, tk, tv, a, blockIdx.x * 64, blockIdx.y,
                        blockIdx.z);
}

__global__ void __launch_bounds__(sm90::Config<kNwg>::threads,
                                  sm90::Config<kNwg>::min_blocks)
    attention_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const sm90::StatsArgs a) {
  sm90::attention_block<kNwg>(tq, tk, tv, a, blockIdx.x * 64 * kNwg,
                              blockIdx.y, blockIdx.z);
}

}  // namespace ei

// float32: the loop over the planes the pack pass (ei_attention_pack_tf32)
// wrote: q_planes (B, H, 2, N, 64), k_planes (B, H, 2, M, 64) split,
// v_planes (B, H, 2, 64, M rounded up to 64) transposed and split; bias:
// (B, M) float32 contiguous; out: (B, H, N, 64) float32 through
// `out_strides` (b, h, n; d unit); stats: (2, B, H, N) float32
// contiguous, the row max m then the row sum l. Returns 0, a CUDA error
// code or one of ei::sm90's kErr* codes.
extern "C" int ei_attention_fwd_tf32(const float* q_planes,
                                     const float* k_planes,
                                     const float* v_planes, const float* bias,
                                     void* out, const long long* out_strides,
                                     float* stats, int B, int H, int N, int M,
                                     float scale, void* stream) {
  ei::tf32::StatsArgs a{};
  static_cast<ei::tf32::Args&>(a) =
      ei::tf32::bias_args(bias, out, out_strides, N, M, scale);
  a.row_max = stats;
  a.row_sum = stats + (long long)B * H * N;
  a.heads = H;
  return ei::tf32::attention(ei::attention_fwd_tf32_kernel, q_planes,
                             k_planes, v_planes, a, B, H,
                             static_cast<cudaStream_t>(stream));
}

// bfloat16: the pack pass (where the operand plan asks for it) and the
// Hopper loop with the statistics epilogue. ops: q, k, v as 3 x 8 long
// longs (ei::sm90::read_operand; the wrapper's operand plan); bias: (B, M)
// float32 contiguous; out: (B, H, N, 64) bf16 through `out_strides`
// (b, h, n; d unit); stats: (2, B, H, N) float32 contiguous, the row max m
// then the row sum l. Returns 0, a CUDA error code or one of ei::sm90's
// kErr* codes.
extern "C" int ei_attention_fwd_sm90(const long long* ops, const float* bias,
                                     void* out, const long long* out_strides,
                                     float* stats, int B, int H, int N,
                                     int M, float scale, void* stream) {
  ei::sm90::StatsArgs a{};
  static_cast<ei::sm90::Args&>(a) =
      ei::sm90::bias_args(bias, out, out_strides, N, M, scale);
  a.row_max = stats;
  a.row_sum = stats + (long long)B * H * N;
  a.heads = H;
  return ei::sm90::attention<ei::kNwg>(ei::attention_fwd_sm90_kernel, ops,
                                       false, nullptr, nullptr, a, B, H,
                                       static_cast<cudaStream_t>(stream));
}
