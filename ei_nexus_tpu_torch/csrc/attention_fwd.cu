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
//    LightGlue): the CUDA-core flash loop of flash_attention.cuh, 64 query
//    rows a block, q/k/v read through strides; kernel F's float32
//    instance forms every score on the same tiles in the same order.
#include "flash_attention.cuh"
#include "flash_sm90.cuh"

namespace ei {

// consumer warpgroups of the bf16 loop: 128 query rows a block, as A
constexpr int kNwg = 2;

__global__ void __launch_bounds__(kThreads)
    attention_fwd_kernel(const Problem p) {
  extern __shared__ float4 smem4[];
  flash_block<float, false>(p, blockIdx.z, blockIdx.y,
                            blockIdx.x * Tiles<float>::rows, smem4);
}

static int launch(const Problem& p, int B, cudaStream_t stream) {
  using Tl = Tiles<float>;
  cudaError_t err = cudaFuncSetAttribute(
      attention_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Tl::smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.nq + Tl::rows - 1) / Tl::rows, p.heads, B);
  attention_fwd_kernel<<<grid, Tl::threads, Tl::smem, stream>>>(p);
  return (int)cudaGetLastError();
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

// float32: q: (B, H, N, 64); k, v: (B, H, M, 64), through `qkv_strides`
// (12 element strides: q, k, v, each (b, h, n, d)); bias: (B, M) float32
// contiguous; out: (B, H, N, 64) through `out_strides` (4); stats:
// (2, B, H, N) float32 contiguous, the row max m then the row sum l.
// Returns the CUDA error code of the launch (0 on success); bfloat16 takes
// ei_attention_fwd_sm90.
extern "C" int ei_attention_fwd(int dtype, const void* q, const void* k,
                                const void* v, const long long* qkv_strides,
                                const float* bias, void* out,
                                const long long* out_strides, float* stats,
                                int B, int H, int N, int M, float scale,
                                void* stream) {
  if (dtype != ei::kFloat32) return (int)cudaErrorInvalidValue;
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
  p.row_max = stats;
  p.row_sum = stats + (long long)B * H * N;
  p.heads = H;
  return ei::launch(p, B, static_cast<cudaStream_t>(stream));
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
