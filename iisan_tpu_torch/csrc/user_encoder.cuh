// Definitions both user-encoder routes share: the dimensions, where a
// kernel's areas live, the dropout sites and the packed parameter order,
// and the LayerNorm and bias gradients of the bf16 route's sweep.  The
// routes' bodies are user_encoder_tc.cuh (bf16, mma.sync) and
// user_encoder_f32.cuh (fp32, three-pass TF32 on wgmma).
//
// The function: positional add, input LayerNorm (+ dropout), then per block
// bias-free Q/K/V/O attention with an fp32 softmax over the additive mask
// (+ dropout of the probabilities and of the projected output), post-LN,
// ReLU FFN (+ dropout of its output), post-LN.  The mask is additive
// 0 / -1e9, so a query row whose keys are all masked gets the uniform
// softmax, never NaN.  Dropout bits come from Philox (philox.cuh),
// addressed by (seed, sequence, site, element).
#pragma once

#include "common.cuh"
#include "philox.cuh"

namespace iisan {

constexpr float kEps = 1e-6f;

struct EncoderDims {
  int L, D, H, F, n_layers, n_position;
};

// Where a kernel's areas live: all in shared memory; the layer slots in a
// global scratch (the bf16 route); all but the staged weights there.
enum Placement { kResident = 0, kSlotsGlobal = 1, kSpilled = 2 };

// Dropout site numbers of one sequence (ops/philox.encoder_sites).
__device__ __forceinline__ unsigned site_probs(int layer, int h, int H) {
  return 1u + layer * (H + 2) + h;
}
__device__ __forceinline__ unsigned site_attn_out(int layer, int H) {
  return 1u + layer * (H + 2) + H;
}
__device__ __forceinline__ unsigned site_ffn_out(int layer, int H) {
  return 2u + layer * (H + 2) + H;
}

// Packed parameters of one block, in the order of flatten_encoder_params.
struct BlockParams {
  const float *wq, *wk, *wv, *wo, *ln1_s, *ln1_b, *w1, *b1, *w2, *b2, *ln2_s, *ln2_b;
  __device__ BlockParams(const float* p, int D, int F)
      : wq(p), wk(wq + D * D), wv(wk + D * D), wo(wv + D * D), ln1_s(wo + D * D),
        ln1_b(ln1_s + D), w1(ln1_b + D), b1(w1 + D * F), w2(b1 + F), b2(w2 + F * D),
        ln2_s(b2 + D), ln2_b(ln2_s + D) {}
  __device__ static int size(int D, int F) { return 4 * D * D + 2 * D * F + F + 5 * D; }
};

// out[j] = sum_l G[l, j] (a bias gradient), G (L, N) in shared or device memory.
__device__ inline void col_sum(const float* G, float* __restrict__ out, int L, int N) {
  for (int j = threadIdx.x; j < N; j += blockDim.x) {
    float acc = 0.f;
    for (int l = 0; l < L; ++l) acc += G[l * N + j];
    out[j] = acc;
  }
}

// LayerNorm backward (`_layernorm_bwd`): gx = rstd * (gy*s - mean(gy*s) -
// xhat * mean(gy*s*xhat)) per row; the scale and bias gradients, column
// sums of gy*xhat and gy, go to gscale / gbias (global).
__device__ inline void layer_norm_bwd(const float* gy, const float* xhat, const float* rstd,
                                      const float* scale, float* gx, float* __restrict__ gscale,
                                      float* __restrict__ gbias, int L, int D) {
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float s = 0.f, t = 0.f;
    for (int l = 0; l < L; ++l) {
      const float v = gy[l * D + d];
      s = fmaf(v, xhat[l * D + d], s);
      t += v;
    }
    gscale[d] = s;
    gbias[d] = t;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_warps = blockDim.x / 32;
  for (int l = warp; l < L; l += n_warps) {
    float s1 = 0.f, s2 = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float gh = gy[l * D + d] * scale[d];
      s1 += gh;
      s2 = fmaf(gh, xhat[l * D + d], s2);
    }
    const float m1 = warp_sum(s1) / D, m2 = warp_sum(s2) / D;
    for (int d = lane; d < D; d += 32) {
      const float gh = gy[l * D + d] * scale[d];
      gx[l * D + d] = rstd[l] * (gh - m1 - xhat[l * D + d] * m2);
    }
  }
}

}  // namespace iisan
