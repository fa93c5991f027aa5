// Attention subblock forward (#8): out = bf16(ctx . Wo + bo), ctx the
// per-head masked attention of bf16(x . Wqkv + bqkv), in one call of three
// kernels (attn_subblock.cuh has the design, sm90_gemm.cuh the GEMMs).
//
// Replaces the Pallas TPU kernel `_subblock_kernel` (iisan_tpu/ops/
// fused_attn_subblock.py:107), which holds a block of Bb sequences, both
// weight matrices and the whole qkv projection in VMEM.  Its cast chain,
// kept here:
//   qkv = bf16(x . Wqkv (fp32 sums) + bqkv (fp32))
//   s   = (q_h . k_h^T) * (1/sqrt(64)) [+ key bias]   fp32; p = bf16(softmax(s))
//   p   = bf16(p * keep / (1 - rate))   (train mode, Philox masks)
//   ctx = bf16(p . v_h);  out = bf16(ctx . Wo (fp32 sums) + bo (fp32))
//
// What bounds it on the H100: at the ViT step (B = 704, T = 197, D = 768)
// its 739 GFLOP (qkv 491, output 164, attention 84) take 0.75 ms on the
// bf16 tensor cores and its 0.43 GB of inputs and output 0.13 ms:
// operations.  The scratch q, k, v and ctx (0.85 GB written, read once)
// add 0.5 ms of traffic; the attention core is #5's (PERF.md's kernel
// table splits the op's device time by kernel).
//
// This file also defines the kernels and `run`, which #9's entry point
// (attn_subblock_v2_fwd.cu) calls with its head-group size.

#include "attn_subblock.cuh"

namespace iisan {
namespace subblock {

using namespace mha;

static __global__ void __launch_bounds__(sm90::kThreads, 1)
    subblock_qkv_gemm_kernel(const __grid_constant__ CUtensorMap amap,
                             const __grid_constant__ CUtensorMap wmap,
                             const __grid_constant__ CUtensorMap omap,
                             const float* __restrict__ bias, int M, int N, int K, int kg, int ldo) {
  sm90::gemm_block<sm90::Bf16, 192, sm90::kStages, false>(&amap, &wmap, &omap, sm90::Bf16{bias},
                                                          M, N, K, kg, ldo);
}

template <int BN, bool kGrouped>
static __global__ void __launch_bounds__(sm90::kThreads, 1)
    subblock_out_gemm_kernel(const __grid_constant__ CUtensorMap amap,
                             const __grid_constant__ CUtensorMap wmap,
                             const __grid_constant__ CUtensorMap omap,
                             const float* __restrict__ bias, int M, int N, int K, int kg, int ldo) {
  sm90::gemm_block<sm90::Bf16, BN, sm90::kStages, kGrouped>(&amap, &wmap, &omap, sm90::Bf16{bias},
                                                            M, N, K, kg, ldo);
}

// #5's two block designs under the subblock's own names (its launch
// counters and the profiler's kernel families keep the two ops apart).
template <int NC, bool kDrop>
static __global__ void __launch_bounds__(kFwdThreads, 2)
    subblock_attn_resident_kernel(const __grid_constant__ CUtensorMap qm,
                                  const __grid_constant__ CUtensorMap km,
                                  const __grid_constant__ CUtensorMap vm,
                                  const __grid_constant__ CUtensorMap om,
                                  const float* __restrict__ bias, Dims d, Dropout drop) {
  fwd_resident_block<NC, kDrop>(&qm, &km, &vm, &om, bias, d, drop);
}

template <bool kDrop>
static __global__ void __launch_bounds__(kFwdThreads, 3)
    subblock_attn_streamed_kernel(const __grid_constant__ CUtensorMap qm,
                                  const __grid_constant__ CUtensorMap km,
                                  const __grid_constant__ CUtensorMap vm,
                                  const __grid_constant__ CUtensorMap om,
                                  const float* __restrict__ bias, Dims d, Dropout drop) {
  fwd_streamed_block<kDrop>(&qm, &km, &vm, &om, bias, d, drop);
}

static const FwdKernels kAttnKernels = {
    {{subblock_attn_resident_kernel<1, false>, subblock_attn_resident_kernel<1, true>},
     {subblock_attn_resident_kernel<2, false>, subblock_attn_resident_kernel<2, true>},
     {subblock_attn_resident_kernel<3, false>, subblock_attn_resident_kernel<3, true>},
     {subblock_attn_resident_kernel<4, false>, subblock_attn_resident_kernel<4, true>},
     {subblock_attn_resident_kernel<5, false>, subblock_attn_resident_kernel<5, true>}},
    {subblock_attn_streamed_kernel<false>, subblock_attn_streamed_kernel<true>}};

// q | k | v (3, M, D) = bf16(x . wqkv + bqkv), column n of the product at
// plane n / D, column n % D.
static cudaError_t project_qkv(const void* x, const void* wqkv, const void* bqkv, void* qkv,
                               int M, int D, cudaStream_t stream) {
  return sm90::launch_gemm<192>(subblock_qkv_gemm_kernel, x, wqkv, static_cast<const float*>(bqkv),
                                qkv, M, 3 * D, D, D, D, stream);
}

cudaError_t run(const void* x, const void* wqkv, const void* bqkv, const void* wo, const void* bo,
                const void* bias, void* qkv, void* ctx, void* out, int B, int Tn, int D, int H,
                int kg, int seed, float rate, float scale, int layer, cudaStream_t stream) {
  const int M = B * Tn;
  cudaError_t err = project_qkv(x, wqkv, bqkv, qkv, M, D, stream);
  if (err != cudaSuccess) return err;
  const Dims d{Tn, D, H, static_cast<float>(1.0 / sqrt(static_cast<double>(kDk))),
               static_cast<unsigned>(layer * H)};
  const bf16* q = static_cast<const bf16*>(qkv);
  const size_t plane = static_cast<size_t>(M) * D;
  err = launch_fwd_tc(kAttnKernels, q, q + plane, q + 2 * plane, bias, ctx, B, d,
                      make_dropout(seed, rate, scale), stream);
  if (err != cudaSuccess) return err;
  const float* bop = static_cast<const float*>(bo);
  if (D % 128 != 0)
    return sm90::launch_gemm<64>(subblock_out_gemm_kernel<64, false>, ctx, wo, bop, out, M, D, D, D,
                                 D, stream);
  if (kg < D)
    return sm90::launch_gemm<128>(subblock_out_gemm_kernel<128, true>, ctx, wo, bop, out, M, D, D,
                                  kg, D, stream);
  return sm90::launch_gemm<128>(subblock_out_gemm_kernel<128, false>, ctx, wo, bop, out, M, D, D,
                                D, D, stream);
}

}  // namespace subblock
}  // namespace iisan

// x (B, T, D) bf16; wqkv (D, 3D) bf16, the [q | k | v] kernels side by side
// in their (in, out) layout; bqkv (3D) fp32; wo (D, D) bf16 (in, out); bo
// (D) fp32; bias (B, T) fp32 or null; scratch qkv (3, B, T, D) and ctx (B,
// T, D) bf16; out (B, T, D) bf16.  Dropout is on when rate > 0 (Philox key
// `seed`, keep factor `scale`, sites layer * H + head).  Returns the first
// CUDA error of the three launches (0 on success).
extern "C" int iisan_attn_subblock_fwd(const void* x, const void* wqkv, const void* bqkv,
                                       const void* wo, const void* bo, const void* bias,
                                       void* qkv, void* ctx, void* out, int B, int T, int D,
                                       int H, int seed, float rate, float scale, int layer,
                                       void* stream) {
  namespace sb = iisan::subblock;
  if (!sb::supported(B, T, D, H, D)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(sb::run(x, wqkv, bqkv, wo, bo, bias, qkv, ctx, out, B, T, D, H, D, seed,
                                  rate, scale, layer, static_cast<cudaStream_t>(stream)));
}

// The projection GEMM alone: qkv (3, M, D) bf16 = bf16(x (M, D) . wqkv (D,
// 3D) + bqkv (3D, fp32)), plane n / D for column n.
extern "C" int iisan_subblock_qkv_gemm(const void* x, const void* wqkv, const void* bqkv,
                                       void* qkv, int M, int D, void* stream) {
  if (M < 1 || D < 64 || D % 64 != 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(iisan::subblock::project_qkv(x, wqkv, bqkv, qkv, M, D,
                                                       static_cast<cudaStream_t>(stream)));
}
