// Philox4x32-10 dropout bits on the card, the twin of ops/philox.py.
//
// A dropout bit is addressed by (seed, sequence b, site, element e): lane
// e % 4 of Philox under key (seed, 0) with counter (e / 4, site, b, 0), i.e.
// curand_init(seed, b, (site << 34) + e) then one curand() in
// curand_kernel.h's terms.  Masks so depend neither on the block layout
// nor on the device, and the plain PyTorch versions regenerate them bit
// for bit.  The kernels recompute a bit wherever they need it instead of
// storing masks.
#pragma once

#include <cuda_runtime.h>

namespace iisan {

__device__ __forceinline__ uint4 philox_round(uint4 c, uint2 k) {
  const unsigned lo0 = 0xD2511F53u * c.x, hi0 = __umulhi(0xD2511F53u, c.x);
  const unsigned lo1 = 0xCD9E8D57u * c.z, hi1 = __umulhi(0xCD9E8D57u, c.z);
  return make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
}

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += 0x9E3779B9u;
      k.y += 0xBB67AE85u;
    }
    c = philox_round(c, k);
  }
  return c;
}

// The four words of counter c: the bits of elements 4c .. 4c+3.
__device__ __forceinline__ uint4 philox_bits4(unsigned seed, unsigned site, unsigned b,
                                              unsigned c) {
  return philox4x32_10(make_uint4(c, site, b, 0u), make_uint2(seed, 0u));
}

__device__ __forceinline__ unsigned philox_bits(unsigned seed, unsigned site, unsigned b,
                                                unsigned e) {
  const uint4 r = philox_bits4(seed, site, b, e >> 2);
  switch (e & 3u) {
    case 0: return r.x;
    case 1: return r.y;
    case 2: return r.z;
    default: return r.w;
  }
}

// The scaled keep factor of one element: `scale` (= 1/(1-rate), rounded to
// fp32 by the caller) where (bits >> 8) / 2^24 >= rate, else 0.  Both
// sides of the comparison are exact in fp32.
__device__ __forceinline__ float keep_of_bits(unsigned bits, float rate, float scale) {
  const float u = static_cast<float>(bits >> 8) * (1.0f / 16777216.0f);
  return u >= rate ? scale : 0.0f;
}

__device__ __forceinline__ float dropout_keep(unsigned seed, unsigned site, unsigned b,
                                              unsigned e, float rate, float scale) {
  return keep_of_bits(philox_bits(seed, site, b, e), rate, scale);
}

// Dropout of one encoder call: off when `on` is false.
struct Dropout {
  bool on;
  unsigned seed;
  float rate, scale;
  __device__ __forceinline__ float keep(unsigned site, unsigned b, unsigned e) const {
    return dropout_keep(seed, site, b, e, rate, scale);
  }
  __device__ __forceinline__ uint4 bits4(unsigned site, unsigned b, unsigned c) const {
    return philox_bits4(seed, site, b, c);
  }
  __device__ __forceinline__ float keep_bits(unsigned bits) const {
    return keep_of_bits(bits, rate, scale);
  }
};

inline Dropout make_dropout(int seed, float rate, float scale) {
  return Dropout{rate > 0.f, static_cast<unsigned>(seed), rate, scale};
}

}  // namespace iisan
