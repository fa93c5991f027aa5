// The scaled attention-dropout keep masks that mha_fwd.cu and mha_bwd.cu
// draw, written out as a (B, H, T, T) fp32 tensor: the oracle that proves
// both kernels against an explicit-mask plain version.
//
// Replaces the Pallas TPU kernel `_mask_replay_kernel` (iisan_tpu/ops/
// fused_attention.py), which replays the TPU generator's draw schedule.
// Here an element is Philox at (seed, image, site = layer * H + head,
// element = query * T + key), the same function philox.cuh gives the
// compute kernels, so the masks are equal bit for bit by construction.
//
// What bounds it on the H100: writing B H T^2 x 4 bytes (30 MB at the BERT
// step, B=704, T=30, H=12: 9 us at 3.35 TB/s); each element costs ten
// Philox rounds of integer work, which the card hides behind the stores.
// One thread per element.

#include "philox.cuh"

namespace iisan {
namespace {

__global__ void mha_mask_replay_kernel(float* __restrict__ out, long long n, int H, int Tn,
                                       unsigned site0, Dropout drop) {
  const long long tt = static_cast<long long>(Tn) * Tn;
  for (long long idx = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; idx < n;
       idx += static_cast<long long>(gridDim.x) * blockDim.x) {
    const unsigned e = static_cast<unsigned>(idx % tt);
    const long long bh = idx / tt;
    const unsigned h = static_cast<unsigned>(bh % H), b = static_cast<unsigned>(bh / H);
    out[idx] = drop.keep(site0 + h, b, e);
  }
}

}  // namespace
}  // namespace iisan

// out (B, H, T, T) fp32.  Returns the CUDA error of the launch.
extern "C" int iisan_mha_mask_replay(void* out, int B, int T, int H, int seed, float rate,
                                     float scale, int layer, void* stream) {
  if (B < 1 || T < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(B) * H * T * T;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  const iisan::Dropout drop{true, static_cast<unsigned>(seed), rate, scale};
  iisan::mha_mask_replay_kernel<<<static_cast<unsigned>(blocks < 65535 * 16 ? blocks : 65535 * 16),
                                  threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), n, H, T, static_cast<unsigned>(layer * H), drop);
  return static_cast<int>(cudaGetLastError());
}
