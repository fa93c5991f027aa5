// W8A8 linear: y = T_out(float(quant_rows(x) . W) * (sx * kscale) + bias),
// in two kernels on the stream:
//
// 1. `w8a8_quant_rows_kernel`: one to eight warps a row (by K), 16-byte
//    loads, the row held in registers up to 8,192 bf16 values (read twice
//    beyond), writes xq (M, Kp) int8, Kp = K rounded up to 16 with zero
//    columns, and sx (M) fp32.
// 2. `w8a8_gemm_kernel`: sm90_gemm.cuh's persistent, warp-specialised
//    mainloop on int8 (kind `S8`): TMA loads of 128 x 128-byte slices of xq
//    and 256 x 128-byte slices of the weight's (N, Kp) transpose, both
//    K-major, a 3-deep mbarrier ring, two consumer warpgroups on wgmma
//    m64n256k32 (s32 sums), the dequantisation in the epilogue; a bf16
//    result is rounded into a swizzled shared tile and stored with TMA, an
//    fp32 one from registers.
//
// Replaces the Pallas TPU kernel `_w8a8_kernel` (iisan_tpu/ops/
// int8_pallas.py:96), which quantises a block of rows once into VMEM
// scratch and streams the weight columns past it.  Here the row scale
// needs a whole row before any of it is quantised, and a 128-row tile at K
// = 3,072 is 384 KB of int8, past an SM's 227 KB: so the rows are
// quantised in a pass of their own (2 bytes read and 1 written an element
// in bf16), and the GEMM reads int8 only.
//
// The cast chain is ops/int8_linear.int8_matmul's, step for step:
//   sx = absmax / 127 (IEEE division); inv = sx > 0 ? 1 / sx : 0;
//   xq = clip(rint(x * inv), -127, 127);  acc = xq . W  (int32, exact);
//   y  = float(acc) * (sx * kscale)  [+ bias],  then the output type;
// with __fdiv_rn / __fmul_rn / __fadd_rn, so nvcc contracts nothing into an
// FMA, and the int32 sum is exact in any order (|acc| <= K 127^2 < 2^31
// for K up to 133,136, the largest multiple of 16 below 2^31 / 127^2, the
// wrapper's K_MAX): the kernels are bit-equal to the plain version on the
// card.  Zero columns past K (in xq, in the weight, and TMA's fill past
// Kp) add nothing to the sums.
//
// What bounds it on the H100: at ViT's intermediate layer (M = 138,688, K
// = 768, N = 3,072) 654 G int8 operations take 0.33 ms at 1,979 TOPS and
// the call's 1.07 GB (x read once, y written once) 0.32 ms at 3.35 TB/s.
// The quantise pass adds 0.32 GB of traffic (0.1 ms): xq written and read
// again.

#include <cstdint>
#include <cstring>

#include "common.cuh"
#include "sm90_gemm.cuh"

namespace iisan {
namespace {

constexpr int kQuantWarps = 8;  // warps of a quantise block

// v[i] = x[i], i < V: one 16-byte load where V elements are 16 bytes.
template <typename TX, int V>
__device__ __forceinline__ void load_row(const TX* p, float (&v)[V]) {
  if constexpr (V * sizeof(TX) == 16) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const TX* t = reinterpret_cast<const TX*>(&u);
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = to_f32(t[i]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = to_f32(p[i]);
  }
}

// q[0..V) to p, one store of V bytes (p is V-aligned).
template <int V>
__device__ __forceinline__ void store_q(int8_t* p, const int8_t (&q)[V]) {
  if constexpr (V == 8) {
    uint2 u;
    memcpy(&u, q, 8);
    *reinterpret_cast<uint2*>(p) = u;
  } else if constexpr (V == 4) {
    unsigned u;
    memcpy(&u, q, 4);
    *reinterpret_cast<unsigned*>(p) = u;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = q[i];
  }
}

// One value quantised: clip(rint(v * inv), -127, 127).
__device__ __forceinline__ int8_t quant1(float v, float inv) {
  const float t = rintf(__fmul_rn(v, inv));
  return static_cast<int8_t>(static_cast<int>(fminf(fmaxf(t, -127.f), 127.f)));
}

// WPR warps a row (kQuantWarps / WPR rows a block), V elements a thread and
// step: 16 bytes of x where K is a multiple of V and x 16-byte aligned,
// else 1.  V divides 16, so the chunks tile [0, Kp) and each lies wholly
// below K or wholly in the zero pad.  CH > 0: the row (K <= 32 WPR V CH, so
// Kp is too) is held in registers between the absmax and the
// quantisation, chunk c of a thread t at elements (32 WPR c + t) V; CH = 0
// reads it twice.
template <typename TX, int V, int CH, int WPR>
__global__ void __launch_bounds__(kQuantWarps * 32)
    w8a8_quant_rows_kernel(const TX* __restrict__ x, int8_t* __restrict__ xq,
                           float* __restrict__ sx, int M, int K, int Kp) {
  constexpr int kRowThreads = 32 * WPR, kStep = kRowThreads * V;
  __shared__ float warp_amax[kQuantWarps];
  const int t = threadIdx.x % kRowThreads;
  const int r = blockIdx.x * (kQuantWarps / WPR) + threadIdx.x / kRowThreads;
  const bool live = r < M;  // every thread stays for the block's barrier
  const TX* xr = x + static_cast<size_t>(live ? r : 0) * K;
  int8_t* qr = xq + static_cast<size_t>(live ? r : 0) * Kp;
  // The row's absmax, from each thread's partial one.
  auto row_max = [&](float amax) {
    amax = warp_max(amax);
    if constexpr (WPR > 1) {
      if (threadIdx.x % 32 == 0) warp_amax[threadIdx.x / 32] = amax;
      __syncthreads();
      const float* w = warp_amax + threadIdx.x / kRowThreads * WPR;
#pragma unroll
      for (int i = 0; i < WPR; ++i) amax = fmaxf(amax, w[i]);
    }
    return amax;
  };
  float amax = 0.f;
  if constexpr (CH > 0) {
    static_assert(V * sizeof(TX) == 16, "rows in registers are read 16 bytes at a time");
    uint4 raw[CH];
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int k = c * kStep + t * V;
      raw[c] = live && k < K ? __ldg(reinterpret_cast<const uint4*>(xr + k)) : make_uint4(0, 0, 0, 0);
      const TX* v = reinterpret_cast<const TX*>(&raw[c]);
#pragma unroll
      for (int i = 0; i < V; ++i) amax = fmaxf(amax, fabsf(to_f32(v[i])));
    }
    amax = row_max(amax);
    const float s = __fdiv_rn(amax, 127.f);
    const float inv = s > 0.f ? __fdiv_rn(1.f, s) : 0.f;
    if (!live) return;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int k = c * kStep + t * V;
      if (k >= Kp) break;
      const TX* v = reinterpret_cast<const TX*>(&raw[c]);
      int8_t q[V];
#pragma unroll
      for (int i = 0; i < V; ++i) q[i] = k < K ? quant1(to_f32(v[i]), inv) : 0;
      store_q<V>(qr + k, q);
    }
    if (t == 0) sx[r] = s;
  } else {
    for (int k = t * V; live && k < K; k += kStep) {
      float v[V];
      load_row<TX, V>(xr + k, v);
#pragma unroll
      for (int i = 0; i < V; ++i) amax = fmaxf(amax, fabsf(v[i]));
    }
    amax = row_max(amax);
    const float s = __fdiv_rn(amax, 127.f);
    const float inv = s > 0.f ? __fdiv_rn(1.f, s) : 0.f;
    if (!live) return;
    for (int k = t * V; k < Kp; k += kStep) {
      int8_t q[V];
      if (k < K) {
        float v[V];
        load_row<TX, V>(xr + k, v);
#pragma unroll
        for (int i = 0; i < V; ++i) q[i] = quant1(v[i], inv);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) q[i] = 0;
      }
      store_q<V>(qr + k, q);
    }
    if (t == 0) sx[r] = s;
  }
}

template <typename TX, int V, int CH, int WPR>
void launch_quant(const TX* x, int8_t* xq, float* sx, int M, int K, int Kp, cudaStream_t stream) {
  constexpr int kRows = kQuantWarps / WPR;
  w8a8_quant_rows_kernel<TX, V, CH, WPR>
      <<<(M + kRows - 1) / kRows, kQuantWarps * 32, 0, stream>>>(x, xq, sx, M, K, Kp);
}

// A row of up to 4 chunks of 16 bytes a thread stays in registers: a warp
// a row up to 32 V 4 values (1,024 bf16), 4 warps up to 4,096, 8 up to
// 8,192.  Longer rows are read twice by 8 warps; rows that are not 16-byte
// aligned, element by element by one.
template <typename TX>
cudaError_t quant_rows(const void* x, void* xq, void* sx, int M, int K, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(TX);
  const int Kp = (K + 15) / 16 * 16;
  const TX* xp = static_cast<const TX*>(x);
  int8_t* q = static_cast<int8_t*>(xq);
  float* s = static_cast<float*>(sx);
  if (K % V != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0)
    launch_quant<TX, 1, 0, 1>(xp, q, s, M, K, Kp, stream);
  else if (K <= 32 * V * 4)
    launch_quant<TX, V, 4, 1>(xp, q, s, M, K, Kp, stream);
  else if (K <= 128 * V * 4)
    launch_quant<TX, V, 4, 4>(xp, q, s, M, K, Kp, stream);
  else if (K <= 256 * V * 4)
    launch_quant<TX, V, 4, 8>(xp, q, s, M, K, Kp, stream);
  else
    launch_quant<TX, V, 0, 8>(xp, q, s, M, K, Kp, stream);
  return cudaGetLastError();
}

// The tile: 128 x 256 with a 3-deep ring, 3 x 48 KB of stages and two 64 x
// 256 bf16 output tiles in 227 KB.  A consumer holds two stages (the one it
// multiplies and the one whose wgmmas may still run).  On the H100 at 700
// W, 128 x 128 tiles with 5 stages and 128 x 256 with 4 stages (two output
// boxes staged at a time) were not faster from one run to the next at the
// tower shapes (scripts/torch_w8a8_bench.py; PERF.md).
constexpr int kBN = 256, kStages = 3;

template <typename TO>
__global__ void __launch_bounds__(sm90::kThreads, 1)
    w8a8_gemm_kernel(const __grid_constant__ CUtensorMap amap,
                     const __grid_constant__ CUtensorMap wmap,
                     const __grid_constant__ CUtensorMap omap, const sm90::S8<TO> kind, int M,
                     int N, int Kp) {
  sm90::gemm_block<sm90::S8<TO>, kBN, kStages, false>(&amap, &wmap, &omap, kind, M, N, Kp, Kp, N);
}

template <typename TO>
cudaError_t gemm(const void* xq, const float* sx, const void* wt, const float* kscale,
                 const float* bias, void* out, int M, int N, int Kp, int ld, cudaStream_t stream) {
  using namespace sm90;
  CUtensorMap amap, wmap, omap;
  memset(&omap, 0, sizeof(omap));  // an fp32 result is not stored with TMA
  cudaError_t err = encode_2d(&amap, xq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, Kp, M, 128, kBM);
  if (err != cudaSuccess) return err;
  err = encode_2d(&wmap, wt, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, Kp, N, 128, kBN);
  if (err != cudaSuccess) return err;
  if (S8<TO>::kTmaStore) {
    err = encode_out(&omap, out, N, M, 1, ld);
    if (err != cudaSuccess) return err;
  }
  const size_t bytes = GemmLayout<kBN, kStages>::bytes;
  err = cudaFuncSetAttribute(w8a8_gemm_kernel<TO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const int tiles = (M + kBM - 1) / kBM * ((N + kBN - 1) / kBN);
  const int grid = tiles < sm_count() ? tiles : sm_count();
  const S8<TO> kind{sx, kscale, bias, static_cast<TO*>(out), ld};
  w8a8_gemm_kernel<TO><<<grid, kThreads, bytes, stream>>>(amap, wmap, omap, kind, M, N, Kp);
  return cudaGetLastError();
}

}  // namespace
}  // namespace iisan

// x (M, K) fp32 or bf16 (x_bf16), rows K elements apart -> xq (M, Kp) int8,
// Kp = K rounded up to 16, zeros past K; sx (M) fp32.  Returns the CUDA
// error of the launch (0 on success).
extern "C" int iisan_w8a8_quant_rows(const void* x, void* xq, void* sx, int M, int K, int x_bf16,
                                     void* stream) {
  if (M < 1 || K < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) return static_cast<int>(iisan::quant_rows<__nv_bfloat16>(x, xq, sx, M, K, s));
  return static_cast<int>(iisan::quant_rows<float>(x, xq, sx, M, K, s));
}

// out (M, N) = dequant(xq (M, Kp) . wt (N, Kp)^T), rows `ld` elements
// apart: bf16 (out_bf16; ld a multiple of 8) or fp32; sx (M), kscale (N)
// and bias (N, or null) fp32.  Kp a multiple of 16 up to 133,136 (K_MAX),
// every matrix 16-byte aligned.  Returns the CUDA error of the launch (0 on
// success).
extern "C" int iisan_w8a8_gemm(const void* xq, const void* sx, const void* wt, const void* kscale,
                               const void* bias, void* out, int M, int N, int Kp, int ld,
                               int out_bf16, void* stream) {
  if (M < 1 || N < 1 || Kp < 16 || Kp % 16 || Kp > 133136 || ld < N || (out_bf16 && ld % 8))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* sxp = static_cast<const float*>(sx);
  const float* ks = static_cast<const float*>(kscale);
  const float* b = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      out_bf16 ? iisan::gemm<__nv_bfloat16>(xq, sxp, wt, ks, b, out, M, N, Kp, ld, s)
               : iisan::gemm<float>(xq, sxp, wt, ks, b, out, M, N, Kp, ld, s);
  return static_cast<int>(err);
}
