// Test entry point: the port's Philox dropout bits (philox.cuh) beside
// curand_kernel.h's Philox4_32_10 at the same address, for the check that
// the two generators agree (tests/test_torch_kernels_cuda.py).  Not on any
// training or serving path.

#include <curand_kernel.h>

#include "philox.cuh"

namespace iisan {
namespace {

// Element (b, e) of `site`: ours[b*n + e] from philox_bits, theirs[b*n + e]
// from curand_init(seed, b, (site << 34) + e) and one curand().
__global__ void philox_check_kernel(unsigned seed, unsigned site, int B, int n,
                                    unsigned* __restrict__ ours,
                                    unsigned* __restrict__ theirs) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(B) * n) return;
  const unsigned b = static_cast<unsigned>(i / n), e = static_cast<unsigned>(i % n);
  ours[i] = philox_bits(seed, site, b, e);
  curandStatePhilox4_32_10_t state;
  curand_init(seed, b, (static_cast<unsigned long long>(site) << 34) + e, &state);
  theirs[i] = curand(&state);
}

}  // namespace
}  // namespace iisan

// ours, theirs: (B, n) uint32 (int32 storage).  Returns the CUDA error of
// the launch (0 on success).
extern "C" int iisan_philox_check(int seed, int site, int B, int n, void* ours,
                                  void* theirs, void* stream) {
  const long long total = static_cast<long long>(B) * n;
  const int blocks = static_cast<int>((total + 255) / 256);
  if (blocks > 0)
    iisan::philox_check_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<unsigned>(seed), static_cast<unsigned>(site), B, n,
        static_cast<unsigned*>(ours), static_cast<unsigned*>(theirs));
  return static_cast<int>(cudaGetLastError());
}
