// Attention subblock forward, head-group layout (#9): the qkv projection and
// attention of #8 from group_weights' grouped weights, and an fp32 output
// accumulated over head groups in order (attn_subblock.cuh has the design):
//   out = ((bo + ctx_0 . Wo_0) + ctx_1 . Wo_1) + ...   fp32, groups of G heads
//
// Replaces the Pallas TPU kernel `_subblock_v2_kernel` (iisan_tpu/ops/
// fused_attn_subblock.py), whose grid walks (sequence block, head group) and
// accumulates each group's contribution into a resident fp32 output block.
// Its function differs from #8's and is kept: the biases arrive rounded to
// bf16 (the wrapper rounds them, as `fused_attn_subblock_v2` does), each
// group's output contribution is its own fp32 sum, and the result is fp32
// (the wrapper rounds it to bf16).  Blocks here cannot carry a sum from one
// grid step to the next, so the output kernel takes the group loop inside
// the block: its K loop runs over Wo's rows group by group and folds each
// group's fp32 sum into the total before the next one starts.
//
// What bounds it on the H100: the same 739 GFLOP as #8 at the ViT step,
// 0.75 ms on the bf16 tensor cores; its output is fp32 (0.42 GB instead of
// 0.21), still below the operations' time.

#include "attn_subblock.cuh"

// As iisan_attn_subblock_fwd, with wg_t (3D, D) bf16 the grouped projection
// weight's rows (per group of G heads, each head's q, k, v rows side by
// side), bg (3D) fp32 in the same order, bo (D) fp32, out (B, T, D) fp32.
extern "C" int iisan_attn_subblock_v2_fwd(const void* x, const void* wg_t, const void* bg,
                                          const void* wo_t, const void* bo, const void* bias,
                                          void* ctx, void* out, int B, int T, int D, int H,
                                          int G, int seed, float rate, float scale, int layer,
                                          void* stream) {
  namespace sb = iisan::subblock;
  if (G < 1 || !sb::supported(B, T, D, H, G)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(sb::launch<float>(x, wg_t, bg, wo_t, bo, bias, ctx, out, B, T, D, H,
                                            G, G * iisan::mha::kDk, seed, rate, scale, layer,
                                            static_cast<cudaStream_t>(stream)));
}
