// Encoder self-attention forward, heads unsplit in and out, with the
// optional (B, T) key bias and train-mode attention dropout (mha.cuh has
// the cast chain).
//
// Replaces the Pallas TPU kernel `_mha_kernel` (iisan_tpu/ops/
// fused_attention.py:73), which keeps one head's (T, T) scores in VMEM.
// Dropout bits come from Philox (philox.cuh) at (seed, image, site = layer
// * H + head, element = query * T + key) instead of the TPU's own
// generator, so the backward, the mask replay and the plain PyTorch
// version regenerate the same masks.
//
// What bounds it on the H100: its bytes.  q, k, v read once and o written
// once are 852 MB at the ViT step (B=704, T=197, D=768), 0.25 ms at 3.35
// TB/s; its 84 GFLOP would take 0.085 ms on the bf16 tensor cores.  The
// first version ran both products as fp32 FMAs on the CUDA cores, with a
// lane's 8 x 8 register tile of scores that also capped T at 256 keys.
//
// Design (bf16), on the tensor cores: a warp owns a 16-row m-tile; both
// products run on mma.sync m16n8k16 (bf16 operands, fp32 sums), Q.K^T with
// the m-tile's Q fragments held in registers and pd.V with pd taken
// straight from the score accumulators.  p is normalised before it is
// rounded (the cast chain above), so each m-tile makes two passes over the
// 64-key tiles: K alone for the rows' max and sum, then K and V to
// recompute the scores and form the output.  The scores never reach
// device memory.  Two ways to feed the keys, by T:
// - T <= 320 (BERT's 30 and ViT's 197 / 257 tokens): a block per (head,
//   image) loads K_h and V_h once into shared memory (93 KB at T = 197,
//   two blocks an SM), and its 8 warps walk the m-tiles with no block
//   barrier after the load (`attend_resident`, the core of #8 and #9).
//   It measured faster than the streamed design at BERT's and ViT's
//   shapes, run for run on one card.
// - any T: a block per (64-row query tile, head, image), 4 warps; K_h and
//   V_h stream through shared memory in 64-key tiles (cp.async, two
//   buffers), with two block barriers a tile; 46 KB, four blocks an SM.
//   (128-row tiles of 8 warps, and skipping the last tile's padded key
//   groups, both measured slower.)
//
// fp32 (tests, the fp32 compute dtype): the same two passes on the CUDA
// cores (mha.cuh's rows kernels), 32-row query tiles against 32-key tiles;
// no TF32, which keeps about three digits.

#include "mha.cuh"

namespace iisan {
namespace {

using namespace mha;

// The streamed design (see the top; mha.cuh's fwd_streamed_block).
__global__ void __launch_bounds__(kTcThreads)
    mha_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const float* __restrict__ bias,
                      bf16* __restrict__ out, Dims d, Dropout drop) {
  extern __shared__ __align__(16) unsigned char smem[];
  fwd_streamed_block(q, k, v, bias, out, d, drop, smem);
}

// The resident design (see the top; mha.cuh's fwd_resident_block): K_h and
// V_h of one (image, head) beside each warp's 16 Q rows.
__global__ void __launch_bounds__(kResWarps * 32, 2)
    mha_fwd_resident_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, const float* __restrict__ bias,
                            bf16* __restrict__ out, Dims d, Dropout drop) {
  extern __shared__ __align__(16) unsigned char smem[];
  fwd_resident_block(q, k, v, bias, out, d, drop, smem);
}

// The fp32 forward on the CUDA cores: a block is one (32-row query tile,
// head, image); warp w owns rows 4w..4w+3, a lane one key of a 32-key tile.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    mha_fwd_rows_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const float* __restrict__ bias,
                        T* __restrict__ out, Dims d, Dropout drop) {
  __shared__ float Qs[kRowTile * kFStr], Ks[kRowTile * kFStr], Vs[kRowTile * kFStr];
  __shared__ float Bt[kRowTile];
  const int Tn = d.T, i0 = blockIdx.x * kRowTile, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t row0 = static_cast<size_t>(b) * Tn;
  const bool has_bias = bias != nullptr;
  const unsigned site = d.site0 + h;
  load_rows_f32(Qs, q, row0 + i0, min(kRowTile, Tn - i0), d.D, h);

  float s[kRowsPerWarp], m[kRowsPerWarp], l[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = -FLT_MAX;
    l[r] = 0.f;
  }
  for (int j0 = 0; j0 < Tn; j0 += kRowTile) {
    __syncthreads();
    load_rows_f32(Ks, k, row0 + j0, min(kRowTile, Tn - j0), d.D, h);
    load_bias(Bt, bias, row0, j0, Tn);
    __syncthreads();
    row_scores(s, Qs, Ks, Bt, has_bias, j0, Tn, d.inv_sqrt_dk, warp, lane);
    row_stats(m, l, s);
  }

  float o[kRowsPerWarp][2] = {};
  for (int j0 = 0; j0 < Tn; j0 += kRowTile) {
    __syncthreads();
    load_rows_f32(Ks, k, row0 + j0, min(kRowTile, Tn - j0), d.D, h);
    load_rows_f32(Vs, v, row0 + j0, min(kRowTile, Tn - j0), d.D, h);
    load_bias(Bt, bias, row0, j0, Tn);
    __syncthreads();
    row_scores(s, Qs, Ks, Bt, has_bias, j0, Tn, d.inv_sqrt_dk, warp, lane);
    const int j = j0 + lane;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int i = i0 + kRowsPerWarp * warp + r;
      s[r] = j < Tn ? dropped<T>(__fdiv_rn(expf(s[r] - m[r]), l[r]), drop, site, b,
                                 static_cast<unsigned>(i * Tn + j))
                    : 0.f;
    }
    for (int key = 0; key < kRowTile; ++key) {
      const float v0 = Vs[key * kFStr + lane], v1 = Vs[key * kFStr + lane + 32];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float p = __shfl_sync(0xffffffffu, s[r], key);
        o[r][0] = fmaf(p, v0, o[r][0]);
        o[r][1] = fmaf(p, v1, o[r][1]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int i = i0 + kRowsPerWarp * warp + r;
    if (i >= Tn) break;
    T* orow = out + (row0 + i) * d.D + h * kDk;
    orow[lane] = from_f32<T>(o[r][0]);
    orow[lane + 32] = from_f32<T>(o[r][1]);
  }
}

cudaError_t launch_tc(const void* q, const void* k, const void* v, const void* bias, void* out,
                      int B, const Dims& d, const Dropout& drop, cudaStream_t stream) {
  return launch_fwd_tc(mha_fwd_resident_kernel, mha_fwd_tc_kernel, q, k, v, bias, out, B, d, drop,
                       stream);
}

template <typename T>
cudaError_t launch_rows(const void* q, const void* k, const void* v, const void* bias, void* out,
                        int B, const Dims& d, const Dropout& drop, cudaStream_t stream) {
  const dim3 grid((d.T + kRowTile - 1) / kRowTile, d.H, B);
  mha_fwd_rows_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(bias), static_cast<T*>(out), d, drop);
  return cudaGetLastError();
}

}  // namespace
}  // namespace iisan

// q, k, v, out (B, T, D) T; bias (B, T) fp32 or null.  T is bf16 when
// is_bf16 (tensor cores), else fp32 (CUDA cores).  Dropout is on when rate >
// 0: Philox key `seed`, keep factor `scale` (1/(1-rate) in fp32), sites
// layer * H + head.  Returns the CUDA error of the launch (0 on success).
extern "C" int iisan_mha_fwd(const void* q, const void* k, const void* v, const void* bias,
                             void* out, int B, int T, int D, int H, int is_bf16, int seed,
                             float rate, float scale, int layer, void* stream) {
  if (!iisan::mha::supported(B, T, D, H)) return static_cast<int>(cudaErrorInvalidValue);
  const iisan::mha::Dims d{T, D, H,
                           static_cast<float>(1.0 / sqrt(static_cast<double>(iisan::mha::kDk))),
                           static_cast<unsigned>(layer * H)};
  const iisan::Dropout drop = iisan::make_dropout(seed, rate, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_bf16 ? iisan::launch_tc(q, k, v, bias, out, B, d, drop, s)
                                  : iisan::launch_rows<float>(q, k, v, bias, out, B, d, drop, s);
  return static_cast<int>(err);
}
