// Fused SASRec user-encoder forward, one launch for the whole post-LN
// encoder, eval or train mode (see user_encoder.cuh for the body and its
// cast chain).
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
// block of 256 threads runs one sequence.  So every activation stays in
// shared memory for the whole encoder; each weight matrix, which every
// output row reads, is staged in shared memory once per block instead of
// being read from L2 once per row (see linear()); and the weights arrive
// pre-rounded to T, so the inner loops convert nothing.  Batch 1 is a
// single block; batch 256 is about two blocks per SM.  A long sequence
// (L = 50, SASRec's length on the Amazon datasets) does not fit: its layer
// slot (174 KB at D = 64) goes to a per-sequence global scratch, and at
// larger sizes the head area too (user_encoder.cuh's Placement); the
// staged weights stay in shared memory.

#include "user_encoder.cuh"

namespace iisan {
namespace {

template <typename T, int kPlace>
__global__ void __launch_bounds__(kThreads)
    user_encoder_fwd_kernel(const T* __restrict__ x, const float* __restrict__ mask,
                            const float* __restrict__ params, T* __restrict__ out,
                            float* __restrict__ scratch, long long per_seq, EncoderDims dims,
                            float inv_sqrt_dk, Dropout drop) {
  extern __shared__ __align__(16) float smem[];
  const EncoderLayout lay(dims);
  const int LD = dims.L * dims.D;
  const size_t b = blockIdx.x;
  const EncoderAreas ar(static_cast<Placement>(kPlace), lay, 1, smem, scratch, b, per_seq);
  float* y = ar.slots;  // one slot for every layer
  encoder_forward<T>(x + b * LD, mask + b * dims.L * dims.L, params, dims, lay, inv_sqrt_dk,
                     drop, static_cast<unsigned>(b), ar, 0, y);
  T* ob = out + b * LD;
  for (int i = threadIdx.x; i < LD; i += blockDim.x) ob[i] = from_f32<T>(y[i]);
}

template <typename T, int kPlace>
cudaError_t launch_at(const void* x, const void* mask, const void* params, void* out,
                      float* scratch, int B, const EncoderDims& dims, const Dropout& drop,
                      cudaStream_t stream) {
  const EncoderLayout lay(dims);
  const Placement pl = static_cast<Placement>(kPlace);
  const size_t smem = sizeof(float) * smem_floats(lay, pl, 1, 0);
  const long long per_seq = scratch_floats(lay, pl, 1, 0);
  if (per_seq > 0 && scratch == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(user_encoder_fwd_kernel<T, kPlace>, smem);
  if (err != cudaSuccess) return err;
  const float inv_sqrt_dk = static_cast<float>(1.0 / sqrt(static_cast<double>(dims.D / dims.H)));
  user_encoder_fwd_kernel<T, kPlace><<<B, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(mask),
      static_cast<const float*>(params), static_cast<T*>(out), scratch, per_seq, dims,
      inv_sqrt_dk, drop);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* mask, const void* params, void* out,
                   float* scratch, int B, const EncoderDims& dims, const Dropout& drop,
                   cudaStream_t s) {
  switch (place(EncoderLayout(dims), 1, 0)) {
    case kResident: return launch_at<T, kResident>(x, mask, params, out, scratch, B, dims, drop, s);
    case kSlotsGlobal:
      return launch_at<T, kSlotsGlobal>(x, mask, params, out, scratch, B, dims, drop, s);
    default: return launch_at<T, kSpilled>(x, mask, params, out, scratch, B, dims, drop, s);
  }
}

}  // namespace
}  // namespace iisan

// x (B, L, D) T; mask (B, L, L) fp32; params: the packed fp32 parameter
// vector; out (B, L, D) T; scratch: fp32 (B, scratch_floats) where the
// working set does not fit shared memory, else null.  T is bf16 when
// is_bf16, else fp32.  Dropout is on when rate > 0: Philox key `seed`,
// keep factor `scale` (1/(1-rate) in fp32).  Returns the CUDA error of the
// launch (0 on success).
extern "C" int iisan_user_encoder_fwd(const void* x, const void* mask, const void* params,
                                      void* out, void* scratch, int B, int L, int D, int H,
                                      int F, int n_layers, int n_position, int is_bf16,
                                      int seed, float rate, float scale, void* stream) {
  const iisan::EncoderDims dims{L, D, H, F, n_layers, n_position};
  const iisan::Dropout drop = iisan::make_dropout(seed, rate, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scratch);
  const cudaError_t err =
      is_bf16 ? iisan::launch<__nv_bfloat16>(x, mask, params, out, sc, B, dims, drop, s)
              : iisan::launch<float>(x, mask, params, out, sc, B, dims, drop, s);
  return static_cast<int>(err);
}
