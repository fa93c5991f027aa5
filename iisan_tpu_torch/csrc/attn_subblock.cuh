// The attention subblocks (#8 attn_subblock_fwd.cu, #9 attn_subblock_v2_fwd.cu):
// qkv projection + per-head attention + output projection of one BERT or
// ViT layer, in bf16, as three kernels in fixed order on the stream:
//
// 1. `subblock_qkv_gemm_kernel`: x (B T, D) . Wqkv (D, 3D) on wgmma
//    (sm90_gemm.cuh: TMA, an mbarrier ring, a producer warp and two
//    consumer warpgroups on 128 x 192 tiles), with the epilogue
//        q|k|v = bf16(x . Wqkv + bqkv)   (fp32 sum, fp32 bias, one rounding)
//    routing each column of [q | k | v] to its own (B, T, D) bf16 tensor,
//    the layout #5's loaders read.  #9's values are #8's: its wrapper
//    hands in the biases rounded to bf16 first.
// 2. `subblock_attn_resident_kernel` (T <= 320) or
//    `subblock_attn_streamed_kernel`: #5's tensor-core core (mha.cuh's
//    fwd_resident_block / fwd_streamed_block) on those tensors, dropout at
//    sites layer * H + h, writing ctx (B, T, D) bf16.
// 3. `subblock_out_gemm_kernel`: out = bf16(((bo + c_0) + c_1) + ...) on
//    the same wgmma mainloop, c_g the fp32 sum over group g's kg rows of
//    Wo: kg = D is #8's ctx . Wo + bo, kg = 4 heads' rows #9's head-group
//    accumulation.  Both ops write bf16; no fp32 tensor or cast pass.
//
// Weights are read in their JAX (in, out) layout, so no call transposes or
// regroups them.  The q, k, v and ctx scratch (4 B T D bf16) comes from the
// wrapper; the kernels allocate nothing.
//
// Why three kernels: a ViT image's x is 302 KB and its q, k, v 0.9 MB in
// bf16, beyond an SM's 227 KB, so a block per (head, sequence) that
// projects its own head (the earlier design) streams x 3 H times per
// sequence; the GEMMs here read x and ctx once from device memory each
// (L2 serves the 12 column tiles of a row tile) and write q, k, v once.
#pragma once

#include "mha.cuh"
#include "sm90_gemm.cuh"

namespace iisan {
namespace subblock {

// The geometry the kernels take (the wrappers check it first and raise):
// #5's (head width 64, 1 to 46,340 keys, B and H grid dimensions); B T
// rows below 2^31 (a TMA coordinate is a signed 32-bit int); D = 64 H, a
// whole number of the GEMMs' 64-deep K slices and 64-column boxes with
// 16-byte rows, as TMA needs; an output group kg of whole K slices that
// divides D, and for kg < D, D a multiple of 128 (the grouped output
// tile).
inline bool supported(int B, int Tn, int D, int H, int kg) {
  return mha::supported(B, Tn, D, H) && static_cast<long long>(B) * Tn < (1ll << 31) &&
         kg >= sm90::kBK && kg % sm90::kBK == 0 && D % kg == 0 && (kg == D || D % 128 == 0);
}

// The three kernels on `stream` (attn_subblock_fwd.cu): x (B, T, D) bf16,
// wqkv (D, 3D) and wo (D, D) bf16, bqkv (3D) and bo (D) fp32, bias (B, T)
// fp32 or null; scratch qkv (3, B, T, D) and ctx (B, T, D) bf16; out (B,
// T, D) bf16.  Returns the first CUDA error (0 on success).
cudaError_t run(const void* x, const void* wqkv, const void* bqkv, const void* wo, const void* bo,
                const void* bias, void* qkv, void* ctx, void* out, int B, int Tn, int D, int H,
                int kg, int seed, float rate, float scale, int layer, cudaStream_t stream);

}  // namespace subblock
}  // namespace iisan
