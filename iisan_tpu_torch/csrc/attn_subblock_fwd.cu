// Attention subblock forward (#8): out = bf16(ctx . Wo + bo), ctx the
// per-head masked attention of bf16(x . Wqkv + bqkv), in one call of two
// kernels (attn_subblock.cuh has the design).
//
// Replaces the Pallas TPU kernel `_subblock_kernel` (iisan_tpu/ops/
// fused_attn_subblock.py), which holds a block of Bb sequences, both weight
// matrices and the whole qkv projection in VMEM.  Its cast chain, kept here:
//   qkv = bf16(x . Wqkv (fp32 sums) + bqkv (fp32))
//   s   = (q_h . k_h^T) * (1/sqrt(64)) [+ key bias]   fp32; p = bf16(softmax(s))
//   p   = bf16(p * keep / (1 - rate))   (train mode, Philox masks)
//   ctx = bf16(p . v_h);  out = bf16(ctx . Wo (fp32 sums) + bo (fp32))
//
// What bounds it on the H100: at the ViT step (B = 704, T = 197, D = 768)
// its 739 GFLOP (qkv 491, output 164, attention 84) take 0.75 ms on the bf16
// tensor cores and its 0.43 GB 0.13 ms: operations.  Both projections run on
// the tensor cores (mma.sync); the attention core runs fp32 FMAs from shared
// memory as mha_fwd.cu does, and x is read three times per head, once for
// each of q, k and v (from L2).

#include "attn_subblock.cuh"

// x (B, T, D) bf16; wqkv_t (3D, D) bf16, Wqkv's transpose ([q | k | v] rows);
// bqkv (3D) fp32; wo_t (D, D) bf16, Wo's transpose; bo (D) fp32; bias (B, T)
// fp32 or null; ctx (B, T, D) bf16 scratch; out (B, T, D) bf16.  Dropout is
// on when rate > 0 (Philox key `seed`, keep factor `scale`, sites layer * H
// + head).  Returns the first CUDA error of the two launches (0 on success).
extern "C" int iisan_attn_subblock_fwd(const void* x, const void* wqkv_t, const void* bqkv,
                                       const void* wo_t, const void* bo, const void* bias,
                                       void* ctx, void* out, int B, int T, int D, int H,
                                       int seed, float rate, float scale, int layer,
                                       void* stream) {
  namespace sb = iisan::subblock;
  if (!sb::supported(B, T, D, H, 0)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(sb::launch<__nv_bfloat16>(
      x, wqkv_t, bqkv, wo_t, bo, bias, ctx, out, B, T, D, H, 0, D, seed, rate, scale, layer,
      static_cast<cudaStream_t>(stream)));
}
