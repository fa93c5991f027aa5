// W8A8 linear: y = T_out(float(quant_rows(x) . W) * (sx * kscale) + bias).
//
// Replaces the Pallas TPU kernel `_w8a8_kernel` (iisan_tpu/ops/int8_pallas.py),
// which quantises a block of activation rows once into VMEM scratch (per-row
// absmax, rint, clip) and streams the int8 weight columns past it.  Here a
// block owns 64 rows (32 where 64 rows at full K would not fit shared
// memory: K above 3,072, up to 6,272, such as BERT-large's 4,096-wide FFN
// output): it quantises them once into shared memory (int8, the row scales
// beside them), then walks over all N columns in 128-wide tiles,
// streaming the weight's (N, K) transpose through a 3-stage cp.async ring in
// 64-deep slices, and multiplies on the int8 tensor cores (mma.sync
// m16n8k32, int32 sums).  Each tile is dequantised on the way out.
//
// The cast chain is ops/int8_linear.int8_matmul's, step for step:
//   sx = absmax / 127 (IEEE division); inv = sx > 0 ? 1 / sx : 0;
//   xq = clip(rint(x * inv), -127, 127);  acc = xq . W  (int32, exact);
//   y  = float(acc) * (sx * kscale)  [+ bias],  then the output type;
// with __fdiv_rn / __fmul_rn / __fadd_rn, so nvcc contracts nothing into an
// FMA, and the int32 sum is exact in any order: the kernel is bit-equal to
// the plain version on the card.
//
// What bounds it on the H100: at ViT's intermediate layer (M = 138,688, K =
// 768, N = 3,072) 654 G int8 operations take 0.33 ms at 1,979 TOPS and its
// 1.07 GB 0.32 ms at 3.35 TB/s.  This first version reads the weight once
// per 64 rows (from L2), quantises on the CUDA cores, and issues mma.sync
// from 32-bit shared loads; wgmma and TMA are later work.

#include <cstdint>

#include "common.cuh"
#include "mma.cuh"

namespace iisan {
namespace {

constexpr int kBN = 128;                // output columns of a tile
constexpr int kBK = 64;                 // depth of a weight slice
constexpr int kStages = 3;              // weight slices in flight
constexpr int kThreads = 256;           // 8 warps: 2 (rows) x 4 (columns), 16 MI x 32 each
constexpr int kWarps = kThreads / 32;
constexpr int kWStride = kBK + 16;      // bytes per weight-slice row (bank spread)
constexpr int kSmemLimit = 232448;

// Shared memory of a block that owns bm rows.
__host__ __device__ inline size_t smem_bytes(int bm, int K) {
  return static_cast<size_t>(bm) * (K + 16) + static_cast<size_t>(kStages) * kBN * kWStride +
         bm * 4;
}

// MI m16 tiles a warp: a block owns kBM = 32 MI rows.
template <typename TX, typename TO, int MI>
__global__ void __launch_bounds__(kThreads)
    w8a8_linear_kernel(const TX* __restrict__ x, const int8_t* __restrict__ wt,
                       const float* __restrict__ kscale, const float* __restrict__ bias,
                       TO* __restrict__ out, int M, int K, int N) {
  constexpr int kBM = 32 * MI;
  extern __shared__ __align__(16) unsigned char smem[];
  const int xs = K + 16;  // row stride of the quantised rows (bank spread)
  int8_t* Xq = reinterpret_cast<int8_t*>(smem);
  int8_t* Ws = reinterpret_cast<int8_t*>(smem + static_cast<size_t>(kBM) * xs);
  float* Sx = reinterpret_cast<float*>(smem + static_cast<size_t>(kBM) * xs +
                                       static_cast<size_t>(kStages) * kBN * kWStride);
  const int m0 = blockIdx.x * kBM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / 4, wn = warp % 4;

  const int n_k = K / kBK, total = (N / kBN) * n_k;  // (column tile, slice) steps
  auto load_slice = [&](int it) {
    const int nt = it / n_k, kt = it % n_k;
    const int8_t* src = wt + static_cast<size_t>(nt) * kBN * K + kt * kBK;
    int8_t* dst = Ws + (it % kStages) * kBN * kWStride;
    for (int c = threadIdx.x; c < kBN * (kBK / 16); c += kThreads) {
      const int r = c / (kBK / 16), col = (c % (kBK / 16)) * 16;
      cp_async16(dst + r * kWStride + col, src + static_cast<size_t>(r) * K + col);
    }
  };
  // The first slices fly while the rows are quantised.
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < total) load_slice(s);
    cp_async_commit();
  }

  // Quantise the block's rows, one warp a row; rows past M repeat row M - 1
  // and are never stored.
  for (int r = warp; r < kBM; r += kWarps) {
    const TX* xr = x + static_cast<size_t>(min(m0 + r, M - 1)) * K;
    float amax = 0.f;
    for (int k = lane; k < K; k += 32) amax = fmaxf(amax, fabsf(to_f32(xr[k])));
    amax = warp_max(amax);
    const float sx = __fdiv_rn(amax, 127.f);
    const float inv = sx > 0.f ? __fdiv_rn(1.f, sx) : 0.f;
    int8_t* q = Xq + r * xs;
    for (int k = lane; k < K; k += 32) {
      const float v = rintf(__fmul_rn(to_f32(xr[k]), inv));
      q[k] = static_cast<int8_t>(static_cast<int>(fminf(fmaxf(v, -127.f), 127.f)));
    }
    if (lane == 0) Sx[r] = sx;
  }

  int acc[MI][4][4];
  for (int it = 0; it < total; ++it) {
    const int nt = it / n_k, kt = it % n_k;
    if (kt == 0) {
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;
    }
    cp_async_wait<kStages - 2>();
    __syncthreads();  // slice `it` landed; slice it - 1's stage is free
    if (it + kStages - 1 < total) load_slice(it + kStages - 1);
    cp_async_commit();
    const int8_t* W = Ws + (it % kStages) * kBN * kWStride;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      unsigned a[MI][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const int8_t* p = Xq + (wm * 16 * MI + mi * 16 + g) * xs + kt * kBK + kk + 4 * t;
        a[mi][0] = lds32(p);
        a[mi][1] = lds32(p + 8 * xs);
        a[mi][2] = lds32(p + 16);
        a[mi][3] = lds32(p + 8 * xs + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* p = W + (wn * 32 + ni * 8 + g) * kWStride + kk + 4 * t;
        b[ni][0] = lds32(p);
        b[ni][1] = lds32(p + 16);
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);
    }
    if (kt == n_k - 1) {
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = nt * kBN + wn * 32 + ni * 8 + 2 * t;
        const float k0 = kscale[col], k1 = kscale[col + 1];
        const float b0 = bias ? bias[col] : 0.f, b1 = bias ? bias[col + 1] : 0.f;
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = wm * 16 * MI + mi * 16 + g + 8 * half;
            if (m0 + r >= M) continue;
            const float sx = Sx[r];
            float y0 = __fmul_rn(__int2float_rn(acc[mi][ni][2 * half]), __fmul_rn(sx, k0));
            float y1 = __fmul_rn(__int2float_rn(acc[mi][ni][2 * half + 1]), __fmul_rn(sx, k1));
            if (bias) {
              y0 = __fadd_rn(y0, b0);
              y1 = __fadd_rn(y1, b1);
            }
            store2(out + static_cast<size_t>(m0 + r) * N + col, y0, y1);
          }
      }
    }
  }
  cp_async_wait<0>();
}

template <typename TX, typename TO, int MI>
cudaError_t launch_mi(const void* x, const void* wt, const void* kscale, const void* bias,
                      void* out, int M, int K, int N, cudaStream_t stream) {
  constexpr int kBM = 32 * MI;
  const size_t bytes = smem_bytes(kBM, K);
  cudaError_t err = allow_smem(w8a8_linear_kernel<TX, TO, MI>, bytes);
  if (err != cudaSuccess) return err;
  w8a8_linear_kernel<TX, TO, MI><<<(M + kBM - 1) / kBM, kThreads, bytes, stream>>>(
      static_cast<const TX*>(x), static_cast<const int8_t*>(wt),
      static_cast<const float*>(kscale), static_cast<const float*>(bias), static_cast<TO*>(out),
      M, K, N);
  return cudaGetLastError();
}

// 64 rows a block where they fit, else 32.
template <typename TX, typename TO>
cudaError_t launch(const void* x, const void* wt, const void* kscale, const void* bias, void* out,
                   int M, int K, int N, cudaStream_t stream) {
  if (smem_bytes(64, K) <= kSmemLimit)
    return launch_mi<TX, TO, 2>(x, wt, kscale, bias, out, M, K, N, stream);
  return launch_mi<TX, TO, 1>(x, wt, kscale, bias, out, M, K, N, stream);
}

}  // namespace
}  // namespace iisan

// x (M, K) fp32 or bf16 (x_bf16); wt (N, K) int8, the weight's transpose;
// kscale (N) fp32; bias (N) fp32 or null; out (M, N) fp32 or bf16 (out_bf16).
// K a multiple of 64 with 32 rows' worth in shared memory (K <= 6,272), N a
// multiple of 128.  Returns the CUDA error of the launch (0 on success).
extern "C" int iisan_w8a8_linear(const void* x, const void* wt, const void* kscale,
                                 const void* bias, void* out, int M, int K, int N, int x_bf16,
                                 int out_bf16, void* stream) {
  using iisan::kBK;
  using iisan::kBN;
  if (M < 1 || K < kBK || N < kBN || K % kBK || N % kBN ||
      iisan::smem_bytes(32, K) > iisan::kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  typedef __nv_bfloat16 bf16;
  cudaError_t err;
  if (x_bf16)
    err = out_bf16 ? iisan::launch<bf16, bf16>(x, wt, kscale, bias, out, M, K, N, s)
                   : iisan::launch<bf16, float>(x, wt, kscale, bias, out, M, K, N, s);
  else
    err = out_bf16 ? iisan::launch<float, bf16>(x, wt, kscale, bias, out, M, K, N, s)
                   : iisan::launch<float, float>(x, wt, kscale, bias, out, M, K, N, s);
  return static_cast<int>(err);
}
