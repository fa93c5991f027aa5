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
// (0.122 ms on the tensor cores).  This first version runs the products as
// scalar fp32 FMAs on the CUDA cores, and what holds it back is latency:
// too few warps to cover the device-memory and L2 loads.
//
// Design: one block per 16-row tile runs all K steps, the TPU grid's (row
// tile, step) order with the step innermost.  A tile's fp32 carry at
// D=8192 is 512 KB, more than a block's shared memory, so it lives in an
// (N, D) fp32 scratch in device memory that only its block touches (no
// grid-wide sync).  Each step makes two passes over D:
//   1. D in chunks of 512 columns: the block forms round(f) for the chunk
//      into shared memory from the tap and the carry; thread (g, j) then
//      sums four neighbouring columns at a time into z[r][j] for all 16
//      rows (one 8-byte shared load feeds 4 FMAs).  The 256/R partial sums
//      are reduced, bd added, the activation applied and rounded.
//   2. Thread owns columns d: up[r] = act[r] @ wu[:, d] (a 16-byte load of
//      four activations feeds 4 FMAs), then f is recomputed from the tap
//      and the old carry, and c = (up + bu) + f is written back in place
//      by the same thread that read it (no race).
// Shared memory holds only the f chunk, the partial sums and the
// activations (at most 48 KB), so any D works.  Against the latency: two
// blocks an SM (registers capped at 128), the 32 loads that fill one column
// of the tile issued together, and each group of four weights loaded while
// the previous one is used (2.2x faster at N=8192 than one block an SM
// without them).  The known cost of this simple design is traffic: every
// step reads the taps and the carry twice and writes the carry once, and
// every block reads the step's weights (2 MB at D=8192, R=64) through L2.
// Moving both products to wgmma and holding a tile's carry in a cluster's
// distributed shared memory are the next steps.

#include "common.cuh"

namespace iisan {
namespace {

constexpr int kThreads = 256;
constexpr int kTile = 16;    // rows per block
constexpr int kChunk = 512;  // columns of f staged per pass-1 chunk

using bf16 = __nv_bfloat16;

template <int kGelu>
__device__ __forceinline__ float activation(float z) {
  if (kGelu) return 0.5f * z * erfcf(-z * 0.70710678118654752f);
  return fmaxf(z, 0.f);
}

// Shared memory: the f chunk (kTile, kChunk) bf16, the down projection's
// partial sums (256/R, kTile, R) fp32 and the activations (kTile, R) fp32.
size_t streamed_smem_bytes(int R) {
  return sizeof(bf16) * kTile * kChunk + sizeof(float) * kTile * (kThreads + R);
}

template <int kGelu>
__global__ void __launch_bounds__(kThreads, 2)
    san_cascade_streamed_fwd_kernel(const float* __restrict__ coef_a,
                                    const float* __restrict__ coef_b,
                                    const bf16* __restrict__ taps, const bf16* __restrict__ wd,
                                    const bf16* __restrict__ bd, const bf16* __restrict__ wu,
                                    const bf16* __restrict__ bu, const bf16* __restrict__ c0,
                                    float* carry,  // read and written: no __restrict__
                                    bf16* __restrict__ out, int N, int K, int D, int R) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* fs = reinterpret_cast<bf16*>(smem_raw);                 // (kTile, kChunk)
  float* part = reinterpret_cast<float*>(fs + kTile * kChunk);  // (G, kTile, R)
  float* as = part + kTile * kThreads;                          // (kTile, R)

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kTile;
  const int rows = min(kTile, N - n0);
  const int G = kThreads / R;
  const int j = tid % R, g = tid / R;
  const size_t KD = static_cast<size_t>(K) * D;
  const int r_vec = R % 4 == 0 ? R : 0;  // activations read four at a time

  for (int i = 0; i < K; ++i) {
    const float a = coef_a[i], b = coef_b[i];
    // The fused tap of row r, column d, in fp32.  _rn intrinsics keep the
    // two products and the sum separately rounded, as the reference
    // computes them (no FMA contraction).
    auto fused = [&](int r, int d) -> float {
      const size_t row = static_cast<size_t>(n0 + r);
      const float t = __bfloat162float(taps[row * KD + static_cast<size_t>(i) * D + d]);
      const float c = i == 0 ? __bfloat162float(c0[row * D + d]) : carry[row * D + d];
      return __fadd_rn(__fmul_rn(a, t), __fmul_rn(b, c));
    };

    // Pass 1: the down projection, D in chunks.
    float acc[kTile];
#pragma unroll
    for (int r = 0; r < kTile; ++r) acc[r] = 0.f;
    const bf16* w = wd + static_cast<size_t>(i) * D * R + j;
    for (int d0 = 0; d0 < D; d0 += kChunk) {
      // each thread forms columns tid and tid + 256 of all 16 rows; a
      // column's 32 loads (tap and carry) are independent, issued together
#pragma unroll
      for (int h = 0; h < kChunk / kThreads; ++h) {
        const int dd = tid + h * kThreads, d = d0 + dd;
        float v[kTile];
#pragma unroll
        for (int r = 0; r < kTile; ++r) v[r] = r < rows && d < D ? fused(r, d) : 0.f;
#pragma unroll
        for (int r = 0; r < kTile; ++r) fs[r * kChunk + dd] = __float2bfloat16_rn(v[r]);
      }
      __syncthreads();
      const int dn = min(kChunk, D - d0);
      // the next four weights are loaded while the current four are used
      auto load_wd = [&](int dd, float* wv) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          wv[q] = dd + q < dn ? __bfloat162float(w[static_cast<size_t>(d0 + dd + q) * R]) : 0.f;
      };
      float wv[4], wn[4];
      load_wd(4 * g, wv);
      for (int dd = 4 * g; dd < dn; dd += 4 * G) {
        load_wd(dd + 4 * G, wn);
#pragma unroll
        for (int r = 0; r < kTile; ++r) {
          const uint2 pk = *reinterpret_cast<const uint2*>(fs + r * kChunk + dd);
          const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&pk.x));
          const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&pk.y));
          acc[r] = fmaf(lo.x, wv[0], acc[r]);
          acc[r] = fmaf(lo.y, wv[1], acc[r]);
          acc[r] = fmaf(hi.x, wv[2], acc[r]);
          acc[r] = fmaf(hi.y, wv[3], acc[r]);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) wv[q] = wn[q];
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < kTile; ++r) part[(g * kTile + r) * R + j] = acc[r];
    __syncthreads();
    for (int idx = tid; idx < kTile * R; idx += kThreads) {
      const int r = idx / R, jj = idx - r * R;
      float z = 0.f;
      for (int gg = 0; gg < G; ++gg) z += part[(gg * kTile + r) * R + jj];
      z += __bfloat162float(bd[i * R + jj]);
      as[idx] = round_to<bf16>(activation<kGelu>(z));
    }
    __syncthreads();

    // Pass 2: the up projection and the residual, written in place.
    const bool last = i == K - 1;
    for (int d = tid; d < D; d += kThreads) {
      float up[kTile];
#pragma unroll
      for (int r = 0; r < kTile; ++r) up[r] = 0.f;
      const bf16* u = wu + static_cast<size_t>(i) * R * D + d;
      auto load_wu = [&](int jj, float* wv) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          wv[q] = jj + q < r_vec ? __bfloat162float(u[static_cast<size_t>(jj + q) * D]) : 0.f;
      };
      float wv[4], wn[4];
      load_wu(0, wv);
      int jj = 0;
      for (; jj < r_vec; jj += 4) {
        load_wu(jj + 4, wn);
#pragma unroll
        for (int r = 0; r < kTile; ++r) {
          const float4 av = *reinterpret_cast<const float4*>(as + r * R + jj);
          up[r] = fmaf(av.x, wv[0], up[r]);
          up[r] = fmaf(av.y, wv[1], up[r]);
          up[r] = fmaf(av.z, wv[2], up[r]);
          up[r] = fmaf(av.w, wv[3], up[r]);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) wv[q] = wn[q];
      }
      for (; jj < R; ++jj) {
        const float wv = __bfloat162float(u[static_cast<size_t>(jj) * D]);
#pragma unroll
        for (int r = 0; r < kTile; ++r) up[r] = fmaf(as[r * R + jj], wv, up[r]);
      }
      const float bias = __bfloat162float(bu[static_cast<size_t>(i) * D + d]);
#pragma unroll
      for (int r = 0; r < kTile; ++r) {
        if (r < rows) {
          const float c = (up[r] + bias) + fused(r, d);
          const size_t at = static_cast<size_t>(n0 + r) * D + d;
          if (last)
            out[at] = __float2bfloat16_rn(c);
          else
            carry[at] = c;
        }
      }
    }
    __syncthreads();  // the next step's pass 1 reads carries of other threads
  }
}

template <int kGelu>
cudaError_t launch(const void* coef_a, const void* coef_b, const void* taps, const void* wd,
                   const void* bd, const void* wu, const void* bu, const void* c0, void* carry,
                   void* out, int N, int K, int D, int R, cudaStream_t stream) {
  const size_t smem = streamed_smem_bytes(R);
  cudaError_t err = allow_smem(san_cascade_streamed_fwd_kernel<kGelu>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kTile - 1) / kTile);
  san_cascade_streamed_fwd_kernel<kGelu><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(coef_a), static_cast<const float*>(coef_b),
      static_cast<const bf16*>(taps), static_cast<const bf16*>(wd), static_cast<const bf16*>(bd),
      static_cast<const bf16*>(wu), static_cast<const bf16*>(bu), static_cast<const bf16*>(c0),
      static_cast<float*>(carry), static_cast<bf16*>(out), N, K, D, R);
  return cudaGetLastError();
}

}  // namespace
}  // namespace iisan

// coef_a, coef_b (K,) fp32; taps (N, K, D), wd (K, D, R), bd (K, R),
// wu (K, R, D), bu (K, D), c0 and out (N, D) bf16; carry an (N, D) fp32
// scratch the kernel overwrites.  R must divide 256.  Returns the CUDA error
// of the launch (0 on success).
extern "C" int iisan_san_cascade_streamed_fwd(const void* coef_a, const void* coef_b,
                                              const void* taps, const void* wd, const void* bd,
                                              const void* wu, const void* bu, const void* c0,
                                              void* carry, void* out, int N, int K, int D, int R,
                                              int gelu, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = gelu ? iisan::launch<1>(coef_a, coef_b, taps, wd, bd, wu, bu, c0, carry, out,
                                            N, K, D, R, st)
                         : iisan::launch<0>(coef_a, coef_b, taps, wd, bd, wu, bu, c0, carry, out,
                                            N, K, D, R, st);
  return static_cast<int>(err);
}
