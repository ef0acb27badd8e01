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
// d=64, bf16) one call does 8.6 GFLOP of products against ~17-19 MB of
// inputs and outputs, so it is compute-bound (~8.7 us at 989 TFLOP/s).
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
//  - float32 (the float32 configs): flash_attention.cuh's CUDA-core loop, 64
//    rows a row group, two groups for block_q 128.
#include "flash_attention.cuh"
#include "flash_sm90.cuh"

namespace ei {

template <typename T, bool ROT, int BQ>
__global__ void __launch_bounds__(kThreads)
    qblock_attention_kernel(const Problem p) {
  extern __shared__ float4 smem4[];
  flash_block<T, ROT, BQ>(p, blockIdx.z, blockIdx.y, blockIdx.x * BQ, smem4);
}

template <bool ROT, int BQ>
static int launch(const Problem& p, int B, cudaStream_t stream) {
  using Tl = Tiles<float, BQ>;
  auto kernel = qblock_attention_kernel<float, ROT, BQ>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Tl::smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.nq + BQ - 1) / BQ, p.heads, B);
  kernel<<<grid, Tl::threads, Tl::smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int BQ>
static int launch_rot(const Problem& p, bool rot, int B, cudaStream_t s) {
  return rot ? launch<true, BQ>(p, B, s) : launch<false, BQ>(p, B, s);
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

// float32: q: (B, H, N, 64); k, v: (B, H, M, 64), through `qkv_strides`
// (12 element strides: q, k, v, each (b, h, n, d)); cos, sin: (B, N, 64)
// contiguous, read only when `rot` is 1 (then N == M); bias: (B, M)
// float32 contiguous; out: (B, H, N, 64) through `out_strides` (4);
// block_q: 64 or 128. Returns the CUDA error code of the launch (0 on
// success); bfloat16 takes ei_qblock_attention_sm90.
extern "C" int ei_qblock_attention(int dtype, int block_q, int rot,
                                   const void* q, const void* k,
                                   const void* v,
                                   const long long* qkv_strides,
                                   const void* cos, const void* sin,
                                   const float* bias, void* out,
                                   const long long* out_strides, int B,
                                   int H, int N, int M, float scale,
                                   void* stream) {
  ei::Problem p;
  p.q = ei::make_operand(q, qkv_strides);
  p.k = ei::make_operand(k, qkv_strides + 4);
  p.v = ei::make_operand(v, qkv_strides + 8);
  p.cos = cos;
  p.sin = sin;
  p.bias = bias;
  p.o = ei::make_output(out, out_strides);
  p.nq = N;
  p.nk = M;
  p.scale = scale;
  p.heads = H;
  if (dtype != ei::kFloat32 || (rot && N != M))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (block_q == 64) return ei::launch_rot<64>(p, rot != 0, B, s);
  if (block_q == 128) return ei::launch_rot<128>(p, rot != 0, B, s);
  return (int)cudaErrorInvalidValue;
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
