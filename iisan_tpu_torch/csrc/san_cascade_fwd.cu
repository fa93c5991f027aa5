// SAN adapter cascade forward, coefficient form, S branches in one launch:
//
//   f_i = round_T(a[s,i] * tap_i + b[s,i] * c)
//   z   = f_i @ wd[s,i] + bd[s,i]                      (fp32 accumulation)
//   c   = round_T(round_T(act(z)) @ wu[s,i] + bu[s,i] + f_i)
//
// for i = 0..K-1, from c = c0[s].  (a, b) = (sigmoid(g/0.1), 1 - sigmoid)
// is the gated cascade, (1, 1) the additive one.
//
// Replaces the Pallas TPU kernel `_cascade_kernel` (via
// `_fused_cascade_fwd_impl` / `fused_cascade`) in iisan_tpu/ops/fused_san.py,
// whose cast chain it follows: the fused tap is rounded to T, z is fp32 plus
// bias before the activation and is rounded to T after it, and `up + f` adds
// in fp32 before the carry is rounded once per step.
//
// What bounds it on the H100: at the cached step (S=1, N=704, D=768, K=7,
// R=64: 1.4 MB of taps, 0.6 GFLOP) nothing but latency, since the whole
// call is a chain of 7 small steps; at an item-table chunk (S=3, N=8192),
// bytes (0.34 GB, 0.103 ms).  bf16 runs the Hopper body of san_cascade.cuh
// under its `Resident` chain: both products on wgmma, D split across a
// thread-block cluster (12 blocks of 64 columns at the step, 132 blocks)
// with a fixed-order reduction of z in distributed shared memory, the
// taps through TMA, the bf16 carry in shared memory (see there).
//
// fp32 stays on the CUDA cores: fp32 on the tensor cores would be TF32, not
// the reference's full-precision products.  One block of 256 threads per
// (branch, 16-row tile), scalar fp32 FMAs: each thread keeps 16
// accumulators, one per row, so every weight it loads feeds 16 FMAs; the
// down product's columns of R are taken 256 at a time (any R).  The tile's
// carry (then f, in place: the old carry is dead once f is formed) stays
// in shared memory where 16 x D fp32 fits beside the activations, and
// otherwise in `out` itself, which the tile's block alone touches.

#include "san_cascade.cuh"

namespace iisan {
namespace {

constexpr int kThreads = 256;
constexpr int kTile = 16;  // rows per block

template <int kGelu>
__device__ __forceinline__ float act_f32(float z) {
  if (kGelu) return 0.5f * z * erfcf(-z * 0.70710678118654752f);
  return fmaxf(z, 0.f);
}

// Shared memory: activations (kTile, R), the down product's partial sums
// (at most kThreads x kTile) and, when kSmemCarry, the carry (kTile, D).
size_t f32_smem_bytes(int D, int R, bool smem_carry) {
  return sizeof(float) *
         (static_cast<size_t>(kTile) * R + kThreads * kTile + (smem_carry ? kTile * D : 0));
}

template <int kGelu, bool kSmemCarry>
__global__ void __launch_bounds__(kThreads)
    san_cascade_f32_kernel(const float* __restrict__ coef_a, const float* __restrict__ coef_b,
                           const float* __restrict__ taps, const float* __restrict__ wd,
                           const float* __restrict__ bd, const float* __restrict__ wu,
                           const float* __restrict__ bu, const float* __restrict__ c0,
                           float* out, int N, int K, int D, int R) {
  extern __shared__ __align__(16) float f32_smem[];
  float* as = f32_smem;                 // (kTile, R)
  float* part = as + kTile * R;         // (G, kTile, Rj)
  const int tid = threadIdx.x;
  const int s = blockIdx.y;
  const int n0 = blockIdx.x * kTile;
  const int rows = min(kTile, N - n0);
  const size_t row0 = static_cast<size_t>(s) * N + n0;
  // the carry, then f: (kTile, D) in shared memory or the tile's rows of out
  float* cs = kSmemCarry ? part + kThreads * kTile : out + row0 * D;
  const float* tap_s = taps + row0 * K * D;
  const float* wd_s = wd + static_cast<size_t>(s) * K * D * R;
  const float* bd_s = bd + static_cast<size_t>(s) * K * R;
  const float* wu_s = wu + static_cast<size_t>(s) * K * R * D;
  const float* bu_s = bu + static_cast<size_t>(s) * K * D;

  for (int i = 0; i < K; ++i) {
    const float a = coef_a[s * K + i], b = coef_b[s * K + i];
    for (int idx = tid; idx < rows * D; idx += kThreads) {
      const int r = idx / D, d = idx - r * D;
      const float t = tap_s[(static_cast<size_t>(r) * K + i) * D + d];
      const float c = i == 0 ? c0[row0 * D + idx] : cs[idx];
      // _rn intrinsics keep the two products and the sum separately rounded,
      // as the reference computes them (no FMA contraction).
      cs[idx] = __fadd_rn(__fmul_rn(a, t), __fmul_rn(b, c));
    }
    __syncthreads();

    // Down projection, R in groups of at most 256 columns: thread (g, j)
    // sums d = g, g + G, ... for all rows.
    for (int j0 = 0; j0 < R; j0 += kThreads) {
      const int Rj = min(kThreads, R - j0), G = kThreads / Rj;
      if (tid < G * Rj) {
        const int j = tid % Rj, g = tid / Rj;
        float acc[kTile];
#pragma unroll
        for (int r = 0; r < kTile; ++r) acc[r] = 0.f;
        const float* w = wd_s + static_cast<size_t>(i) * D * R + j0 + j;
        for (int d = g; d < D; d += G) {
          const float wv = w[static_cast<size_t>(d) * R];
#pragma unroll
          for (int r = 0; r < kTile; ++r)
            if (r < rows) acc[r] = fmaf(cs[r * D + d], wv, acc[r]);
        }
#pragma unroll
        for (int r = 0; r < kTile; ++r) part[(g * kTile + r) * Rj + j] = acc[r];
      }
      __syncthreads();
      for (int idx = tid; idx < kTile * Rj; idx += kThreads) {
        const int r = idx / Rj, j = idx - r * Rj;
        float z = 0.f;
        for (int g = 0; g < G; ++g) z += part[(g * kTile + r) * Rj + j];
        z += bd_s[i * R + j0 + j];
        as[r * R + j0 + j] = act_f32<kGelu>(z);
      }
      __syncthreads();
    }

    // Up projection plus the residual: thread owns columns d, all rows.
    for (int d = tid; d < D; d += kThreads) {
      float acc[kTile];
#pragma unroll
      for (int r = 0; r < kTile; ++r) acc[r] = 0.f;
      const float* w = wu_s + static_cast<size_t>(i) * R * D + d;
      for (int j = 0; j < R; ++j) {
        const float wv = w[static_cast<size_t>(j) * D];
#pragma unroll
        for (int r = 0; r < kTile; ++r) acc[r] = fmaf(as[r * R + j], wv, acc[r]);
      }
      const float bias = bu_s[i * D + d];
#pragma unroll
      for (int r = 0; r < kTile; ++r)
        if (r < rows) cs[r * D + d] = (acc[r] + bias) + cs[r * D + d];
    }
    __syncthreads();
  }

  if (kSmemCarry)
    for (int idx = tid; idx < rows * D; idx += kThreads) out[row0 * D + idx] = cs[idx];
}

template <int kGelu, bool kSmemCarry>
cudaError_t launch_f32(const void* coef_a, const void* coef_b, const void* taps, const void* wd,
                       const void* bd, const void* wu, const void* bu, const void* c0, void* out,
                       int S, int N, int K, int D, int R, cudaStream_t stream) {
  const size_t smem = f32_smem_bytes(D, R, kSmemCarry);
  if (smem > 232448) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(san_cascade_f32_kernel<kGelu, kSmemCarry>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kTile - 1) / kTile, S);
  san_cascade_f32_kernel<kGelu, kSmemCarry><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(coef_a), static_cast<const float*>(coef_b),
      static_cast<const float*>(taps), static_cast<const float*>(wd),
      static_cast<const float*>(bd), static_cast<const float*>(wu),
      static_cast<const float*>(bu), static_cast<const float*>(c0), static_cast<float*>(out), N,
      K, D, R);
  return cudaGetLastError();
}

}  // namespace
}  // namespace iisan

// coef_a, coef_b (S, K) fp32; taps (S, N, K, D); bd (S, K, R); bu (S, K, D);
// c0 and out (S, N, D); all but the coefficients in T (bf16 when is_bf16,
// else fp32).  bf16: wd (S, K, D, R8) and wu (S, K, R, D8) with R8, D8 = R,
// D rounded up to 8 (zero padded), 16-byte aligned, and the plan's cluster,
// d_slice, r_chunk and stages (ops/fused_san.py cascade_plan).  fp32: wd
// (S, K, D, R), wu (S, K, R, D).  carry_in_smem: the carry lives in shared
// memory (else in `out`).
// Returns the CUDA error of the launch (0 on success).
extern "C" int iisan_san_cascade_fwd(const void* coef_a, const void* coef_b, const void* taps,
                                     const void* wd, const void* bd, const void* wu,
                                     const void* bu, const void* c0, void* out, int S, int N,
                                     int K, int D, int R, int gelu, int is_bf16, int cluster,
                                     int d_slice, int r_chunk, int stages, int carry_in_smem,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_bf16) {
    typedef __nv_bfloat16 bf16;
    iisan::cascade::Params p = {};
    p.coef_a = static_cast<const float*>(coef_a);
    p.coef_b = static_cast<const float*>(coef_b);
    p.taps = static_cast<const bf16*>(taps);
    p.bd = static_cast<const bf16*>(bd);
    p.bu = static_cast<const bf16*>(bu);
    p.c0 = static_cast<const bf16*>(c0);
    p.carry = out;
    p.out = static_cast<bf16*>(out);
    p.N = N;
    p.K = K;
    p.D = D;
    p.R = R;
    p.gelu = gelu;
    err = iisan::cascade::launch<iisan::cascade::Resident>(p, wd, wu, S, cluster, d_slice,
                                                           r_chunk, stages, carry_in_smem, st);
  } else if (carry_in_smem) {
    err = gelu ? iisan::launch_f32<1, true>(coef_a, coef_b, taps, wd, bd, wu, bu, c0, out, S, N,
                                            K, D, R, st)
               : iisan::launch_f32<0, true>(coef_a, coef_b, taps, wd, bd, wu, bu, c0, out, S, N,
                                            K, D, R, st);
  } else {
    err = gelu ? iisan::launch_f32<1, false>(coef_a, coef_b, taps, wd, bd, wu, bu, c0, out, S,
                                             N, K, D, R, st)
               : iisan::launch_f32<0, false>(coef_a, coef_b, taps, wd, bd, wu, bu, c0, out, S,
                                             N, K, D, R, st);
  }
  return static_cast<int>(err);
}

// Message for a CUDA error code returned by the entry points above.
extern "C" const char* iisan_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
