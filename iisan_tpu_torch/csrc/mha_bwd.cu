// Encoder self-attention backward: recomputes the forward's probabilities
// (and its dropout masks) from (q, k, v, bias, seed) and returns gq, gk, gv,
// heads unsplit, by the cast chain of the Pallas kernel (mha.cuh):
//
//   gPd = g . v_h^T          gV = pd^T . g          (fp32 sums of T operands)
//   gP  = gPd * keep         gS = T(p * (gP - sum_j gP p) / sqrt(dk))
//   gQ  = gS . k_h           gK = gS^T . q_h
//
// Replaces the Pallas TPU kernel `_mha_bwd_kernel` (iisan_tpu/ops/
// fused_attention.py).  The TPU kernel replays its on-chip generator's draw
// schedule; here the masks are Philox at the forward's (seed, image, site,
// element) addresses, recomputed where they are needed.
//
// Design: one block per (image, head).  K_h and V_h stay in shared memory
// with fp32 gK and gV sums (about 209 KB at T=197 in bf16, one block an
// SM); query tiles of 32 rows stream through, and each writes its gQ rows.
// The block sums gK and gV over its own tiles in a fixed order: no atomics,
// so results repeat bit for bit from run to run.
//
// What bounds it on the H100: its bytes (q, k, v, g read, gq, gk, gv written:
// 7 x B x T x D x 2 bytes) and its five products, 10 B H T^2 dk FLOP; at
// the FFT geometry (88 images, T=197, D=768) that is 186 MB (0.056 ms at
// 3.35 TB/s) and 26 GFLOP (0.027 ms on the bf16 tensor cores).  This first
// version runs its five products as fp32 FMAs on the CUDA cores, so the FMA
// rate bounds it.

#include "mha.cuh"

namespace iisan {
namespace {

using namespace mha;

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
    mha_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const float* __restrict__ bias, const T* __restrict__ g,
                   T* __restrict__ gq, T* __restrict__ gk, T* __restrict__ gv, Dims d,
                   Dropout drop) {
  constexpr int ST = tile_stride(sizeof(T));
  constexpr int R = kBwdTile / kWarps;
  extern __shared__ __align__(16) unsigned char smem[];
  const int Tn = d.T, h = blockIdx.x, b = blockIdx.y;
  const BwdLayout lay(Tn, sizeof(T));
  T* Ks = reinterpret_cast<T*>(smem + lay.k);
  T* Vs = reinterpret_cast<T*>(smem + lay.v);
  float* gKs = reinterpret_cast<float*>(smem + lay.gk);
  float* gVs = reinterpret_cast<float*>(smem + lay.gv);
  T* Qs = reinterpret_cast<T*>(smem + lay.q);
  T* Gs = reinterpret_cast<T*>(smem + lay.g);
  float* P = reinterpret_cast<float*>(smem + lay.p);
  float* S2 = reinterpret_cast<float*>(smem + lay.s2);
  float* bias_s = reinterpret_cast<float*>(smem + lay.bias);
  const size_t row0 = static_cast<size_t>(b) * Tn;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const unsigned site = d.site0 + h;

  load_head_rows(Ks, k, row0, Tn, d.D, h);
  load_head_rows(Vs, v, row0, Tn, d.D, h);
  for (int j = threadIdx.x; j < Tn; j += blockDim.x) bias_s[j] = bias ? bias[row0 + j] : 0.f;
  for (int idx = threadIdx.x; idx < Tn * kAccStride; idx += blockDim.x) {
    gKs[idx] = 0.f;
    gVs[idx] = 0.f;
  }

  for (int i0 = 0; i0 < Tn; i0 += kBwdTile) {
    const int rows = min(kBwdTile, Tn - i0);
    load_head_rows(Qs, q, row0 + i0, rows, d.D, h);
    load_head_rows(Gs, g, row0 + i0, rows, d.D, h);
    __syncthreads();

    // p (fp32) and pd, rows warp + 8 r
    row_dot_tile<T, R, NC>(Qs, Ks, bias_s, P, rows, Tn, d.inv_sqrt_dk, warp, lane);
    __syncwarp();
    for (int r = 0; r < R; ++r) {
      const int i = warp + kWarps * r;
      if (i >= rows) break;
      float* row = P + i * Tn;
      softmax_row(row, Tn, lane);
      for (int j = lane; j < Tn; j += 32)
        S2[i * Tn + j] =
            dropped<T>(row[j], drop, site, b, static_cast<unsigned>((i0 + i) * Tn + j));
    }
    __syncthreads();

    // gV[j] += sum_i pd[i][j] g[i]: keys over warps, columns over lanes
    for (int j = warp; j < Tn; j += kWarps) {
      float a0 = 0.f, a1 = 0.f;
      for (int i = 0; i < rows; ++i) {
        const float p = S2[i * Tn + j];
        a0 = fmaf(p, to_f32(Gs[i * ST + lane]), a0);
        a1 = fmaf(p, to_f32(Gs[i * ST + lane + 32]), a1);
      }
      gVs[j * kAccStride + lane] += a0;
      gVs[j * kAccStride + lane + 32] += a1;
    }
    __syncthreads();

    // gP = (g . v^T) * keep, then gS, rows warp + 8 r
    row_dot_tile<T, R, NC>(Gs, Vs, nullptr, S2, rows, Tn, 1.0f, warp, lane);
    __syncwarp();
    for (int r = 0; r < R; ++r) {
      const int i = warp + kWarps * r;
      if (i >= rows) break;
      float* gp = S2 + i * Tn;
      const float* p = P + i * Tn;
      float part = 0.f;
      for (int j = lane; j < Tn; j += 32) {
        float x = gp[j];
        if (drop.on) x *= drop.keep(site, b, static_cast<unsigned>((i0 + i) * Tn + j));
        gp[j] = x;
        part += x * p[j];
      }
      const float rsum = warp_sum(part);
      for (int j = lane; j < Tn; j += 32)
        gp[j] = round_to<T>(__fmul_rn(__fmul_rn(p[j], __fsub_rn(gp[j], rsum)), d.inv_sqrt_dk));
    }
    __syncthreads();

    // gQ rows = gS . k_h (rows over warps), written out
    for (int r = 0; r < R; ++r) {
      const int i = warp + kWarps * r;
      if (i >= rows) break;
      float a0 = 0.f, a1 = 0.f;
      for (int j = 0; j < Tn; ++j) {
        const float s = S2[i * Tn + j];
        a0 = fmaf(s, to_f32(Ks[j * ST + lane]), a0);
        a1 = fmaf(s, to_f32(Ks[j * ST + lane + 32]), a1);
      }
      T* o = gq + (row0 + i0 + i) * d.D + h * kDk;
      o[lane] = from_f32<T>(a0);
      o[lane + 32] = from_f32<T>(a1);
    }
    // gK[j] += sum_i gS[i][j] q[i] (keys over warps)
    for (int j = warp; j < Tn; j += kWarps) {
      float a0 = 0.f, a1 = 0.f;
      for (int i = 0; i < rows; ++i) {
        const float s = S2[i * Tn + j];
        a0 = fmaf(s, to_f32(Qs[i * ST + lane]), a0);
        a1 = fmaf(s, to_f32(Qs[i * ST + lane + 32]), a1);
      }
      gKs[j * kAccStride + lane] += a0;
      gKs[j * kAccStride + lane + 32] += a1;
    }
    __syncthreads();
  }

  for (int idx = threadIdx.x; idx < Tn * kDk; idx += blockDim.x) {
    const int j = idx / kDk, c = idx % kDk;
    const size_t o = (row0 + j) * d.D + h * kDk + c;
    gk[o] = from_f32<T>(gKs[j * kAccStride + c]);
    gv[o] = from_f32<T>(gVs[j * kAccStride + c]);
  }
}

template <typename T, int NC>
cudaError_t launch_nc(const void* q, const void* k, const void* v, const void* bias,
                      const void* g, void* gq, void* gk, void* gv, int B, const Dims& d,
                      const Dropout& drop, cudaStream_t stream) {
  const BwdLayout lay(d.T, sizeof(T));
  cudaError_t err = allow_smem(mha_bwd_kernel<T, NC>, lay.bytes);
  if (err != cudaSuccess) return err;
  mha_bwd_kernel<T, NC><<<dim3(d.H, B), kThreads, lay.bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(bias), static_cast<const T*>(g), static_cast<T*>(gq),
      static_cast<T*>(gk), static_cast<T*>(gv), d, drop);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias, const void* g,
                   void* gq, void* gk, void* gv, int B, const Dims& d, const Dropout& drop,
                   cudaStream_t s) {
  switch ((d.T + 31) / 32) {
    case 1: return launch_nc<T, 1>(q, k, v, bias, g, gq, gk, gv, B, d, drop, s);
    case 2: return launch_nc<T, 2>(q, k, v, bias, g, gq, gk, gv, B, d, drop, s);
    case 3: return launch_nc<T, 3>(q, k, v, bias, g, gq, gk, gv, B, d, drop, s);
    case 4: return launch_nc<T, 4>(q, k, v, bias, g, gq, gk, gv, B, d, drop, s);
    case 5: return launch_nc<T, 5>(q, k, v, bias, g, gq, gk, gv, B, d, drop, s);
    case 6: return launch_nc<T, 6>(q, k, v, bias, g, gq, gk, gv, B, d, drop, s);
    case 7: return launch_nc<T, 7>(q, k, v, bias, g, gq, gk, gv, B, d, drop, s);
    case 8: return launch_nc<T, 8>(q, k, v, bias, g, gq, gk, gv, B, d, drop, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace iisan

// q, k, v, g, gq, gk, gv (B, T, D) T; bias (B, T) fp32 or null; the dropout
// arguments are the forward's.  Returns the CUDA error of the launch (0 on
// success); a block's shared memory must fit (the wrapper checks first).
extern "C" int iisan_mha_bwd(const void* q, const void* k, const void* v, const void* bias,
                             const void* g, void* gq, void* gk, void* gv, int B, int T, int D,
                             int H, int is_bf16, int seed, float rate, float scale, int layer,
                             void* stream) {
  if (!iisan::mha::supported(B, T, D, H)) return static_cast<int>(cudaErrorInvalidValue);
  const iisan::mha::Dims d{T, D, H, iisan::mha::kBwdTile,
                           static_cast<float>(1.0 / sqrt(static_cast<double>(iisan::mha::kDk))),
                           static_cast<unsigned>(layer * H)};
  const iisan::Dropout drop = iisan::make_dropout(seed, rate, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? iisan::launch<__nv_bfloat16>(q, k, v, bias, g, gq, gk, gv, B, d, drop, s)
              : iisan::launch<float>(q, k, v, bias, g, gq, gk, gv, B, d, drop, s);
  return static_cast<int>(err);
}
