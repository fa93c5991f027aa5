// Encoder self-attention forward, heads unsplit in and out, with the
// optional (B, T) key bias and train-mode attention dropout (mha.cuh has
// the cast chain).
//
// Replaces the Pallas TPU kernel `_mha_kernel` (iisan_tpu/ops/
// fused_attention.py), which keeps one head's (T, T) scores in VMEM.  Here a
// block is one (image, head, query tile): K_h, V_h, the tile's Q rows and its
// fp32 scores sit in shared memory (about 97 KB in bf16 at T=197, so two
// blocks an SM), and the scores never reach device memory.  Dropout bits come
// from Philox (philox.cuh) at (seed, image, site = layer * H + head, element
// = query * T + key) instead of the TPU's own generator, so the backward and
// the plain PyTorch version regenerate the same masks.
//
// What bounds it on the H100: its bytes (q, k, v read once and o written
// once: 852 MB at the ViT step, B=704, T=197, D=768) take 0.25 ms at 3.35
// TB/s; its 84 GFLOP would take 0.085 ms on the bf16 tensor cores.  This
// first version runs the two products as fp32 FMAs on the CUDA cores from
// shared memory (each lane holds an 8 x 8 register tile of scores), so
// today the FMA rate bounds it; tensor cores are later work.

#include "mha.cuh"

namespace iisan {
namespace {

using namespace mha;

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
    mha_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const float* __restrict__ bias, T* __restrict__ out, Dims d, Dropout drop) {
  constexpr int R = kFwdRowsPerWarp;
  extern __shared__ __align__(16) unsigned char smem[];
  const int Tn = d.T, h = blockIdx.y, b = blockIdx.z;
  const int i0 = blockIdx.x * d.tile, rows = min(d.tile, Tn - i0);
  const FwdLayout lay(Tn, d.tile, sizeof(T));
  T* Ks = reinterpret_cast<T*>(smem + lay.k);
  T* Vs = reinterpret_cast<T*>(smem + lay.v);
  T* Qs = reinterpret_cast<T*>(smem + lay.q);
  float* S = reinterpret_cast<float*>(smem + lay.s);
  float* bias_s = reinterpret_cast<float*>(smem + lay.bias);
  const size_t row0 = static_cast<size_t>(b) * Tn;

  load_head_rows(Ks, k, row0, Tn, d.D, h);
  load_head_rows(Vs, v, row0, Tn, d.D, h);
  load_head_rows(Qs, q, row0 + i0, rows, d.D, h);
  for (int j = threadIdx.x; j < Tn; j += blockDim.x) bias_s[j] = bias ? bias[row0 + j] : 0.f;
  __syncthreads();

  // Each warp owns rows warp + 8 r of the tile from here on.
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  row_dot_tile<T, R, NC>(Qs, Ks, bias_s, S, rows, Tn, d.inv_sqrt_dk, warp, lane);
  __syncwarp();
  softmax_pv_tile<T, R>(S, Vs, out + (row0 + i0) * d.D + h * kDk, rows, Tn, d.D, i0, drop,
                        d.site0 + h, b, warp, lane);
}

template <typename T, int NC>
cudaError_t launch_nc(const void* q, const void* k, const void* v, const void* bias, void* out,
                      int B, const Dims& d, const Dropout& drop, cudaStream_t stream) {
  const FwdLayout lay(d.T, d.tile, sizeof(T));
  cudaError_t err = allow_smem(mha_fwd_kernel<T, NC>, lay.bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((d.T + d.tile - 1) / d.tile, d.H, B);
  mha_fwd_kernel<T, NC><<<grid, kThreads, lay.bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(bias), static_cast<T*>(out), d, drop);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias, void* out,
                   int B, const Dims& d, const Dropout& drop, cudaStream_t s) {
  switch ((d.T + 31) / 32) {
    case 1: return launch_nc<T, 1>(q, k, v, bias, out, B, d, drop, s);
    case 2: return launch_nc<T, 2>(q, k, v, bias, out, B, d, drop, s);
    case 3: return launch_nc<T, 3>(q, k, v, bias, out, B, d, drop, s);
    case 4: return launch_nc<T, 4>(q, k, v, bias, out, B, d, drop, s);
    case 5: return launch_nc<T, 5>(q, k, v, bias, out, B, d, drop, s);
    case 6: return launch_nc<T, 6>(q, k, v, bias, out, B, d, drop, s);
    case 7: return launch_nc<T, 7>(q, k, v, bias, out, B, d, drop, s);
    case 8: return launch_nc<T, 8>(q, k, v, bias, out, B, d, drop, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace iisan

// q, k, v, out (B, T, D) T; bias (B, T) fp32 or null.  T is bf16 when
// is_bf16, else fp32.  Dropout is on when rate > 0: Philox key `seed`, keep
// factor `scale` (1/(1-rate) in fp32), sites layer * H + head.  Returns the
// CUDA error of the launch (0 on success).
extern "C" int iisan_mha_fwd(const void* q, const void* k, const void* v, const void* bias,
                             void* out, int B, int T, int D, int H, int is_bf16, int seed,
                             float rate, float scale, int layer, void* stream) {
  if (!iisan::mha::supported(B, T, D, H)) return static_cast<int>(cudaErrorInvalidValue);
  const iisan::mha::Dims d{T, D, H, iisan::mha::fwd_tile(T),
                           static_cast<float>(1.0 / sqrt(static_cast<double>(iisan::mha::kDk))),
                           static_cast<unsigned>(layer * H)};
  const iisan::Dropout drop = iisan::make_dropout(seed, rate, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? iisan::launch<__nv_bfloat16>(q, k, v, bias, out, B, d, drop, s)
              : iisan::launch<float>(q, k, v, bias, out, B, d, drop, s);
  return static_cast<int>(err);
}
