// SAN adapter cascade forward, step-streamed: one branch, bf16, any width D.
//
//   f = a[i] * tap_i + b[i] * c                         (fp32; c is fp32)
//   z = round(f) @ wd[i] + bd[i]                        (fp32 sum)
//   c = (round(act(z)) @ wu[i] + bu[i]) + f             (fp32, never rounded)
//
// for i = 0..K-1, from c = c0; the output is round(c) after the last step.
// (a, b) = (sigmoid(g/0.1), 1 - sigmoid) is the gated cascade, (1, 1) the
// additive one.
//
// Replaces the Pallas TPU kernel `_cascade_kernel_streamed` (via
// `_fused_cascade_streamed_impl` / `fused_cascade`) in
// iisan_tpu/ops/fused_san.py, whose cast chain it follows: the carry stays
// fp32 across the steps (the TPU kernel's persistent VMEM scratch), f is
// rounded only as the down projection's operand, and `up + bu + f` is not
// rounded.  The JAX package dispatches to it where the all-weights-resident
// kernel does not fit (IISAN-Versa's Llama-3-70B states: K=7, D=8192).
//
// What bounds it on the H100.  By its shapes, bytes: a table chunk (N=8192,
// K=7, D=8192, R=64) moves 1.22 GB at least (0.365 ms) for 120 GFLOP
// (0.122 ms on the tensor cores); a training step (N=704) 0.12 GB (0.035
// ms) for 10 GFLOP.  At the step, filling the card with only 11 row tiles
// and the latency of each step's chain are what matter.  It runs the
// Hopper body of san_cascade.cuh under its `Streamed` chain: both products
// on wgmma, D split across a cluster of 16 blocks (512 columns each, 176
// blocks at the step), z reduced in rank order through distributed shared
// memory, the taps through TMA, and the fp32 carry slice (133 KB at
// D=8192) in shared memory.  Where the slice cannot fit (D past 8,192 at
// R = 64), the carry lives in an (N, D) fp32 scratch that the wrapper
// allocates, touched only by the slice's block.

#include "san_cascade.cuh"

// coef_a, coef_b (K,) fp32; taps (N, K, D), bd (K, R), bu (K, D), c0 and
// out (N, D) bf16; wd (K, D, R8) and wu (K, R, D8) bf16 with R8, D8 = R, D
// rounded up to 8 (zero padded), 16-byte aligned; carry an (N, D) fp32
// scratch the kernel uses unless carry_in_smem (the carry in shared memory);
// the plan's cluster, d_slice, r_chunk and stages (ops/fused_san.py
// cascade_plan).  Returns the CUDA error of the launch (0 on success).
extern "C" int iisan_san_cascade_streamed_fwd(const void* coef_a, const void* coef_b,
                                              const void* taps, const void* wd, const void* bd,
                                              const void* wu, const void* bu, const void* c0,
                                              void* carry, void* out, int N, int K, int D, int R,
                                              int gelu, int cluster, int d_slice, int r_chunk,
                                              int stages, int carry_in_smem, void* stream) {
  typedef __nv_bfloat16 bf16;
  iisan::cascade::Params p = {};
  p.coef_a = static_cast<const float*>(coef_a);
  p.coef_b = static_cast<const float*>(coef_b);
  p.taps = static_cast<const bf16*>(taps);
  p.bd = static_cast<const bf16*>(bd);
  p.bu = static_cast<const bf16*>(bu);
  p.c0 = static_cast<const bf16*>(c0);
  p.carry = carry;
  p.out = static_cast<bf16*>(out);
  p.N = N;
  p.K = K;
  p.D = D;
  p.R = R;
  p.gelu = gelu;
  return static_cast<int>(iisan::cascade::launch<iisan::cascade::Streamed>(
      p, wd, wu, 1, cluster, d_slice, r_chunk, stages, carry_in_smem,
      static_cast<cudaStream_t>(stream)));
}
