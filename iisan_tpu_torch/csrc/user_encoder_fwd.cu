// Fused SASRec user-encoder forward, bf16 route: one launch for the whole
// post-LN encoder, eval or train mode, on the tensor-core body of
// user_encoder_tc.cuh (the main path).  The fp32 route is
// user_encoder_f32.cu.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` / `_encoder_fwd_body` in
// iisan_tpu/ops/fused_user_encoder.py.  Train mode draws its dropout bits
// from Philox (philox.cuh) instead of the TPU's own generator; the plain
// PyTorch version regenerates the same masks.
//
// What bounds it on the H100: neither the card's bytes nor its FLOPs.  At
// the serving geometry (L=10, D=64, H=2, F=256, 2 blocks) a sequence is 640
// activations and about 1 M multiply-adds, and the unfused module path is
// some forty small launches per call.  One launch removes those; what is
// left is the latency of a chain of small products on one SM, since a
// block runs one sequence.  A clock64() split of the CUDA-core design it
// replaced, at eval B=1 (PERF.md), put 54% of a sequence's 66 us in its
// fp32 FMA chains, 16% in staging fp32 weights and 11% in its LayerNorms.
// This route therefore runs every product on mma.sync, streams the weights
// through a cp.async ring a few chunks ahead of their use (across the ends
// of products), and keeps its areas and ring to 106 KB (two blocks an SM);
// a long sequence (L = 50) moves its layer slot, and at larger sizes its
// head area too, to a per-sequence global scratch (TcLayout's placement).

#include <algorithm>

#include "user_encoder_tc.cuh"

namespace iisan {
namespace {

template <int kPlace>
__global__ void __launch_bounds__(tc::kThreads, 2)
    user_encoder_fwd_tc_kernel(const __nv_bfloat16* __restrict__ x,
                               const float* __restrict__ mask, const float* __restrict__ params,
                               const __nv_bfloat16* __restrict__ image,
                               __nv_bfloat16* __restrict__ out, char* __restrict__ scratch,
                               long long per_seq, EncoderDims dims, float inv_sqrt_dk,
                               Dropout drop) {
  extern __shared__ __align__(16) char smem_tc[];
  const tc::TcLayout lay(dims, false);
  const int LD = dims.L * dims.D;
  const size_t b = blockIdx.x;
  const tc::TcAreas ar(static_cast<Placement>(kPlace), lay, 1, smem_tc, scratch, b, per_seq);
  ar.zero();
  __syncthreads();
  tc::forward_tc<false>(x + b * LD, mask + b * dims.L * dims.L, params, image, dims, lay,
                        inv_sqrt_dk, drop, static_cast<unsigned>(b), ar, 0, out + b * LD);
}

template <int kPlace>
cudaError_t launch_tc_at(const void* x, const void* mask, const void* params, const void* image,
                         void* out, char* scratch, int B, const EncoderDims& dims,
                         const Dropout& drop, cudaStream_t stream) {
  const tc::TcLayout lay(dims, false);
  const Placement pl = static_cast<Placement>(kPlace);
  const size_t smem = tc::tc_smem_bytes(lay, pl, 1);
  const long long per_seq = tc::tc_scratch_bytes(lay, pl, 1);
  cudaError_t err = allow_smem(user_encoder_fwd_tc_kernel<kPlace>, smem);
  if (err != cudaSuccess) return err;
  const float inv_sqrt_dk = static_cast<float>(1.0 / sqrt(static_cast<double>(dims.D / dims.H)));
  user_encoder_fwd_tc_kernel<kPlace><<<B, tc::kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(mask),
      static_cast<const float*>(params), static_cast<const __nv_bfloat16*>(image),
      static_cast<__nv_bfloat16*>(out), scratch, per_seq, dims, inv_sqrt_dk, drop);
  return cudaGetLastError();
}

cudaError_t launch_tc(const void* x, const void* mask, const void* params, const void* image,
                      void* out, char* scratch, long long scratch_bytes, int B,
                      const EncoderDims& dims, const Dropout& drop, cudaStream_t s) {
  const tc::TcLayout lay(dims, false);
  const Placement pl = tc::tc_place(lay, 1);
  if (image == nullptr || scratch_bytes < B * tc::tc_scratch_bytes(lay, pl, 1))
    return cudaErrorInvalidValue;
  switch (pl) {
    case kResident:
      return launch_tc_at<kResident>(x, mask, params, image, out, scratch, B, dims, drop, s);
    case kSlotsGlobal:
      return launch_tc_at<kSlotsGlobal>(x, mask, params, image, out, scratch, B, dims, drop, s);
    default: return launch_tc_at<kSpilled>(x, mask, params, image, out, scratch, B, dims, drop, s);
  }
}

// The bf16 weight image of the packed fp32 parameters (tc::WImage's
// layout), each entry rounded once: a grid of (element blocks, layers).
__global__ void __launch_bounds__(256)
    user_encoder_weights_kernel(const float* __restrict__ params, __nv_bfloat16* __restrict__ image,
                                EncoderDims d) {
  const tc::WImage im(d.D, d.F);
  const int D = d.D, F = d.F;
  const BlockParams w(params + static_cast<size_t>(d.n_position) * D + 2 * D +
                          static_cast<size_t>(blockIdx.y) * BlockParams::size(D, F),
                      D, F);
  __nv_bfloat16* out = image + blockIdx.y * im.layer;
  for (long long e = blockIdx.x * blockDim.x + threadIdx.x; e < im.layer;
       e += static_cast<long long>(gridDim.x) * blockDim.x) {
    float v = 0.f;
    if (e < im.o) {
      const int r = static_cast<int>(e / im.ldqkv), c = static_cast<int>(e % im.ldqkv);
      if (c < 3 * D) {
        const int m = c / D;
        v = __ldg((m == 0 ? w.wq : m == 1 ? w.wk : w.wv) + r * D + (c - m * D));
      }
    } else if (e < im.w1) {
      const int r = static_cast<int>((e - im.o) / im.ldo);
      const int c = static_cast<int>((e - im.o) % im.ldo);
      if (c < D) v = __ldg(w.wo + r * D + c);
    } else if (e < im.w2) {
      const int r = static_cast<int>((e - im.w1) / im.ld1);
      const int c = static_cast<int>((e - im.w1) % im.ld1);
      if (c < F) v = __ldg(w.w1 + static_cast<size_t>(r) * F + c);
    } else {
      const int r = static_cast<int>((e - im.w2) / im.ld2);
      const int c = static_cast<int>((e - im.w2) % im.ld2);
      if (c < D) v = __ldg(w.w2 + r * D + c);
    }
    out[e] = __float2bfloat16_rn(v);
  }
}

}  // namespace
}  // namespace iisan

// params: the packed fp32 parameter vector; image: image_elems bf16
// (checked), which receives its bf16 weight image (tc::WImage), the
// operand the bf16 kernels stream.  Returns the CUDA error of the launch.
extern "C" int iisan_user_encoder_weights(const void* params, void* image, long long image_elems,
                                          int D, int F, int n_layers, int n_position,
                                          void* stream) {
  const iisan::tc::WImage im(D, F);
  if (im.layer * n_layers > image_elems) return static_cast<int>(cudaErrorInvalidValue);
  const iisan::EncoderDims dims{0, D, 1, F, n_layers, n_position};
  const dim3 grid(static_cast<unsigned>(std::min<long long>((im.layer + 255) / 256, 1024)),
                  n_layers);
  iisan::user_encoder_weights_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(params), static_cast<__nv_bfloat16*>(image), dims);
  return static_cast<int>(cudaGetLastError());
}

// x (B, L, D) bf16; mask (B, L, L) fp32; params: the packed fp32 parameter
// vector; image: its bf16 weight image (iisan_user_encoder_weights); out
// (B, L, D) bf16; scratch: scratch_bytes of device memory, B times the
// per-sequence scratch where the working set does not fit shared memory
// (checked), else null.  Dropout is on when rate > 0: Philox key `seed`,
// keep factor `scale` (1/(1-rate) in fp32).  Returns the CUDA error of the
// launch (0 on success).
extern "C" int iisan_user_encoder_fwd(const void* x, const void* mask, const void* params,
                                      const void* image, void* out, void* scratch,
                                      long long scratch_bytes, int B, int L, int D, int H, int F,
                                      int n_layers, int n_position, int seed, float rate,
                                      float scale, void* stream) {
  const iisan::EncoderDims dims{L, D, H, F, n_layers, n_position};
  const iisan::Dropout drop = iisan::make_dropout(seed, rate, scale);
  return static_cast<int>(iisan::launch_tc(x, mask, params, image, out,
                                           static_cast<char*>(scratch), scratch_bytes, B, dims,
                                           drop, static_cast<cudaStream_t>(stream)));
}
