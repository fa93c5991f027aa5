// Attention subblock forward, head-group layout (#9): the qkv projection and
// attention of #8, and the output accumulated over head groups of G heads
// in order, in fp32, rounded once:
//   out = bf16(((bo + ctx_0 . Wo_0) + ctx_1 . Wo_1) + ...)
//
// Replaces the Pallas TPU kernel `_subblock_v2_kernel` (iisan_tpu/ops/
// fused_attn_subblock.py:293), whose grid walks (sequence block, head
// group) and accumulates each group's contribution into a resident fp32
// output block.  Its function differs from #8's and is kept: the biases
// arrive rounded to bf16 (the wrapper rounds them, as
// `fused_attn_subblock_v2` does), and each group's output contribution is
// its own fp32 sum.  Its q, k, v are #8's values (the grouping only says
// which columns belong together), so the three kernels are #8's
// (attn_subblock.cuh): the output GEMM's epilogue closes a group every
// G * 64 rows of Wo (a fresh fp32 accumulator each) and adds the groups in
// order onto bo, then rounds once to bf16, the JAX op's return type.
//
// What bounds it on the H100: #8's 739 GFLOP at the ViT step, 0.75 ms on
// the bf16 tensor cores (operations).

#include "attn_subblock.cuh"

// As iisan_attn_subblock_fwd, with G heads a group (H a multiple of G) and
// bqkv, bo already rounded to bf16 (held in fp32).
extern "C" int iisan_attn_subblock_v2_fwd(const void* x, const void* wqkv, const void* bqkv,
                                          const void* wo, const void* bo, const void* bias,
                                          void* qkv, void* ctx, void* out, int B, int T, int D,
                                          int H, int G, int seed, float rate, float scale,
                                          int layer, void* stream) {
  namespace sb = iisan::subblock;
  const int kg = G * iisan::mha::kDk;
  if (G < 1 || H % G != 0 || !sb::supported(B, T, D, H, kg))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(sb::run(x, wqkv, bqkv, wo, bo, bias, qkv, ctx, out, B, T, D, H, kg, seed,
                                  rate, scale, layer, static_cast<cudaStream_t>(stream)));
}
