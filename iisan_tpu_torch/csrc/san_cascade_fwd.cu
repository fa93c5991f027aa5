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
// What bounds it on the H100: arithmetic.  Each tap row of D values feeds
// 2*D*R multiply-adds (about 128 FLOP per tap byte at D=768, R=64 in bf16),
// far above the card's balance point, and this first version runs them as
// scalar fp32 FMAs, not on the tensor cores.  The design keeps everything
// else off the critical path: one block per (branch, 16-row tile); the
// carry and the fused tap of the tile stay in shared memory (as T, which is
// exact, since both are T-valued) across all K steps; each tap row is read
// from device memory once; the K steps' weights (1.4 MB per branch in bf16)
// are read through L2, which holds them for every block.  Each thread keeps
// 16 accumulators, one per row of the tile, so every weight it loads feeds
// 16 FMAs.  Moving both products to wgmma is the next step.

#include "common.cuh"

namespace iisan {
namespace {

constexpr int kThreads = 256;
constexpr int kTile = 16;  // rows per block

template <int kGelu>
__device__ __forceinline__ float activation(float z) {
  if (kGelu) return 0.5f * z * erfcf(-z * 0.70710678118654752f);
  return fmaxf(z, 0.f);
}

// Shared memory: carry and fused tap (kTile, D) as T, activations (kTile, R)
// fp32, and G = kThreads / R partial sums of the down projection.
template <typename T>
size_t cascade_smem_bytes(int D, int R) {
  const size_t G = kThreads / R;
  return 2 * sizeof(T) * kTile * D + sizeof(float) * kTile * R * (1 + G);
}

template <typename T, int kGelu>
__global__ void __launch_bounds__(kThreads)
    san_cascade_fwd_kernel(const float* __restrict__ coef_a, const float* __restrict__ coef_b,
                           const T* __restrict__ taps, const T* __restrict__ wd,
                           const T* __restrict__ bd, const T* __restrict__ wu,
                           const T* __restrict__ bu, const T* __restrict__ c0,
                           T* __restrict__ out, int N, int K, int D, int R) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* cs = reinterpret_cast<T*>(smem_raw);  // (kTile, D) carry
  T* fs = cs + kTile * D;                  // (kTile, D) fused tap
  float* as = reinterpret_cast<float*>(fs + kTile * D);  // (kTile, R)
  float* part = as + kTile * R;            // (G, kTile, R)

  const int tid = threadIdx.x;
  const int s = blockIdx.y;
  const int n0 = blockIdx.x * kTile;
  const int rows = min(kTile, N - n0);
  const int G = kThreads / R;

  const size_t row0 = static_cast<size_t>(s) * N + n0;
  const T* tap_s = taps + row0 * K * D;
  const T* wd_s = wd + static_cast<size_t>(s) * K * D * R;
  const T* bd_s = bd + static_cast<size_t>(s) * K * R;
  const T* wu_s = wu + static_cast<size_t>(s) * K * R * D;
  const T* bu_s = bu + static_cast<size_t>(s) * K * D;

  for (int idx = tid; idx < kTile * D; idx += kThreads)
    cs[idx] = idx / D < rows ? c0[row0 * D + idx] : from_f32<T>(0.f);

  for (int i = 0; i < K; ++i) {
    const float a = coef_a[s * K + i], b = coef_b[s * K + i];
    for (int idx = tid; idx < kTile * D; idx += kThreads) {
      const int r = idx / D, d = idx - r * D;
      const float t = r < rows ? to_f32(tap_s[(static_cast<size_t>(r) * K + i) * D + d]) : 0.f;
      // _rn intrinsics keep the two products and the sum separately rounded,
      // as the reference computes them (no FMA contraction).
      fs[idx] = from_f32<T>(__fadd_rn(__fmul_rn(a, t), __fmul_rn(b, to_f32(cs[idx]))));
    }
    __syncthreads();

    // Down projection: thread (g, j) sums d = g, g+G, ... for all kTile rows.
    {
      const int j = tid % R, g = tid / R;
      float acc[kTile];
#pragma unroll
      for (int r = 0; r < kTile; ++r) acc[r] = 0.f;
      const T* w = wd_s + static_cast<size_t>(i) * D * R + j;
      for (int d = g; d < D; d += G) {
        const float wv = to_f32(w[static_cast<size_t>(d) * R]);
#pragma unroll
        for (int r = 0; r < kTile; ++r) acc[r] = fmaf(to_f32(fs[r * D + d]), wv, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < kTile; ++r) part[(g * kTile + r) * R + j] = acc[r];
    }
    __syncthreads();
    for (int idx = tid; idx < kTile * R; idx += kThreads) {
      const int r = idx / R, j = idx - r * R;
      float z = 0.f;
      for (int g = 0; g < G; ++g) z += part[(g * kTile + r) * R + j];
      z += to_f32(bd_s[i * R + j]);
      as[idx] = round_to<T>(activation<kGelu>(z));
    }
    __syncthreads();

    // Up projection plus the residual: thread owns columns d, all rows.
    for (int d = tid; d < D; d += kThreads) {
      float acc[kTile];
#pragma unroll
      for (int r = 0; r < kTile; ++r) acc[r] = 0.f;
      const T* w = wu_s + static_cast<size_t>(i) * R * D + d;
      for (int j = 0; j < R; ++j) {
        const float wv = to_f32(w[static_cast<size_t>(j) * D]);
#pragma unroll
        for (int r = 0; r < kTile; ++r) acc[r] = fmaf(as[r * R + j], wv, acc[r]);
      }
      const float bias = to_f32(bu_s[i * D + d]);
#pragma unroll
      for (int r = 0; r < kTile; ++r)
        cs[r * D + d] = from_f32<T>((acc[r] + bias) + to_f32(fs[r * D + d]));
    }
    __syncthreads();
  }

  for (int idx = tid; idx < rows * D; idx += kThreads) out[row0 * D + idx] = cs[idx];
}

template <typename T, int kGelu>
cudaError_t launch(const void* coef_a, const void* coef_b, const void* taps, const void* wd,
                   const void* bd, const void* wu, const void* bu, const void* c0, void* out,
                   int S, int N, int K, int D, int R, cudaStream_t stream) {
  const size_t smem = cascade_smem_bytes<T>(D, R);
  cudaError_t err = allow_smem(san_cascade_fwd_kernel<T, kGelu>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kTile - 1) / kTile, S);
  san_cascade_fwd_kernel<T, kGelu><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(coef_a), static_cast<const float*>(coef_b),
      static_cast<const T*>(taps), static_cast<const T*>(wd), static_cast<const T*>(bd),
      static_cast<const T*>(wu), static_cast<const T*>(bu), static_cast<const T*>(c0),
      static_cast<T*>(out), N, K, D, R);
  return cudaGetLastError();
}

}  // namespace
}  // namespace iisan

// coef_a, coef_b (S, K) fp32; taps (S, N, K, D); wd (S, K, D, R); bd (S, K, R);
// wu (S, K, R, D); bu (S, K, D); c0 and out (S, N, D); all but the
// coefficients in T (bf16 when is_bf16, else fp32).  R must divide 256.
// Returns the CUDA error of the launch (0 on success).
extern "C" int iisan_san_cascade_fwd(const void* coef_a, const void* coef_b, const void* taps,
                                     const void* wd, const void* bd, const void* wu,
                                     const void* bu, const void* c0, void* out, int S, int N,
                                     int K, int D, int R, int gelu, int is_bf16,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_bf16) {
    err = gelu ? iisan::launch<__nv_bfloat16, 1>(coef_a, coef_b, taps, wd, bd, wu, bu, c0, out,
                                                 S, N, K, D, R, st)
               : iisan::launch<__nv_bfloat16, 0>(coef_a, coef_b, taps, wd, bd, wu, bu, c0, out,
                                                 S, N, K, D, R, st);
  } else {
    err = gelu ? iisan::launch<float, 1>(coef_a, coef_b, taps, wd, bd, wu, bu, c0, out, S, N,
                                         K, D, R, st)
               : iisan::launch<float, 0>(coef_a, coef_b, taps, wd, bd, wu, bu, c0, out, S, N,
                                         K, D, R, st);
  }
  return static_cast<int>(err);
}

// Message for a CUDA error code returned by the entry points above.
extern "C" const char* iisan_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
