// The scaled attention-dropout keep masks that mha_fwd.cu and mha_bwd.cu
// draw, written out as a (B, H, T, T) fp32 tensor: the oracle that proves
// both kernels against an explicit-mask plain version.
//
// Replaces the Pallas TPU kernel `_mask_replay_kernel` (iisan_tpu/ops/
// fused_attention.py), which replays the TPU generator's draw schedule.
// Here element e = query * T + key of plane (b, h) is lane e % 4 of Philox
// at (seed, counter e / 4, site = layer * H + h, row b), the function
// philox.cuh gives the compute kernels, so the masks are equal bit for bit
// by construction.
//
// What bounds it on the H100: writing B H T^2 x 4 bytes (30.4 MB at the
// BERT step, B=704, T=30, H=12: 9.1 us at 3.35 TB/s; 163.9 MB at the FFT
// step's ViT attention, B=88, T=197: 48.9 us).  The integer work has to
// stay under that: one Philox4x32-10 per four elements (about 40 IMADs),
// and the keep test as one integer compare against a threshold the host
// derives from the rate ((bits >> 8) / 2^24 >= rate exactly when bits >=
// ceil(rate 2^24) << 8), so no int-to-float conversion per element.
//
// Design.  A thread takes Philox counter c of one head's planes: it makes
// the four words of elements 4c .. 4c+3 with one call, for each of the
// rows it walks.  Grid x runs over (head, 256-counter chunk of the plane),
// decoded once with a 32-bit divide; grid y over rows, a thread walking
// every gridDim.y-th row from its own: ceil(B / 4) blocks in y, at most
// 65,535, so a thread takes four rows (the BERT step's call is 2,112
// blocks, two waves of the 1,056 the card holds at once) and any B is
// covered.  One row a thread (a block a row) wrote slower at both shapes.
// Offsets inside a plane are 32-bit (T <= 46,340, so T^2 < 2^31, #5's
// limit); the plane's base is one 64-bit multiply-add per row and no
// 64-bit divide is done anywhere.
// Stores: where T^2 % 4 == 0 and the output is 16-byte aligned, every
// plane starts 16-byte aligned and each thread writes its four values as
// one float4.  Otherwise (T = 197 and 257 are 1 mod 4, or a misaligned
// view) a warp stages its 32 counters' 128 values in shared memory (512
// bytes a warp) and writes them back as four stores of 32 consecutive
// floats, each clipped at T^2 so that the last counter's spare words never
// reach the next plane.  The staging costs one 16-byte shared store and
// four shared loads a thread; a warp-shuffle transpose would cost sixteen
// shuffles, and four scalar stores a thread, each warp instruction then
// spread over 512 bytes, wrote slower.  Plain stores: streaming ones
// (`__stcs`) wrote slower at ViT and no faster at BERT
// (scripts/torch_mask_replay_bench.py; PERF.md).

#include <climits>
#include <cstdint>

#include "philox.cuh"

namespace iisan {
namespace {

constexpr int kReplayThreads = 256;  // counters a block: 1,024 elements of a plane
constexpr int kReplayRows = 4;       // rows a thread walks

template <bool kVec4>
__global__ void __launch_bounds__(kReplayThreads)
    mha_mask_replay_kernel(float* __restrict__ out, int B, int H, unsigned tt, unsigned chunks,
                           unsigned seed, unsigned site0, unsigned threshold, float scale) {
  const unsigned h = blockIdx.x / chunks;
  const unsigned c = (blockIdx.x - h * chunks) * kReplayThreads + threadIdx.x;
  const unsigned counters = (tt + 3) / 4;
  if (kVec4 ? c >= counters : (c & ~31u) >= counters) return;  // the staged path exits by warps
  for (unsigned b = blockIdx.y; b < static_cast<unsigned>(B); b += gridDim.y) {
    float* plane = out + (static_cast<long long>(b) * H + h) * tt;
    const uint4 r = philox_bits4(seed, site0 + h, b, c);
    const float4 v = make_float4(r.x >= threshold ? scale : 0.f, r.y >= threshold ? scale : 0.f,
                                 r.z >= threshold ? scale : 0.f, r.w >= threshold ? scale : 0.f);
    if constexpr (kVec4) {
      reinterpret_cast<float4*>(plane)[c] = v;
    } else {
      __shared__ float4 stage[kReplayThreads];
      const unsigned lane = threadIdx.x & 31u;
      stage[threadIdx.x] = v;
      __syncwarp();
      const float* words = reinterpret_cast<const float*>(stage + (threadIdx.x & ~31u));
      const unsigned e0 = (c & ~31u) * 4 + lane;
#pragma unroll
      for (unsigned k = 0; k < 4; ++k)
        if (e0 + 32 * k < tt) plane[e0 + 32 * k] = words[32 * k + lane];
      __syncwarp();  // the next row's words overwrite the stage
    }
  }
}

}  // namespace
}  // namespace iisan

// out (B, H, T, T) fp32; site0 = layer * H; an element is kept where its
// Philox word is >= threshold (ops/philox.keep_threshold).  Returns the
// CUDA error of the launch.
extern "C" int iisan_mha_mask_replay(void* out, int B, int T, int H, int seed,
                                     unsigned threshold, float scale, unsigned site0,
                                     void* stream) {
  if (B < 1 || T < 1 || T > 46340 || H < 1 || seed < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned tt = static_cast<unsigned>(T) * T;
  const unsigned chunks = ((tt + 3) / 4 + iisan::kReplayThreads - 1) / iisan::kReplayThreads;
  if (static_cast<long long>(chunks) * H > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int rows = (B + iisan::kReplayRows - 1) / iisan::kReplayRows;
  const dim3 grid(chunks * H, rows < 65535 ? rows : 65535);
  const auto s = static_cast<cudaStream_t>(stream);
  if (tt % 4 == 0 && reinterpret_cast<std::uintptr_t>(out) % 16 == 0)
    iisan::mha_mask_replay_kernel<true><<<grid, iisan::kReplayThreads, 0, s>>>(
        static_cast<float*>(out), B, H, tt, chunks, static_cast<unsigned>(seed), site0,
        threshold, scale);
  else
    iisan::mha_mask_replay_kernel<false><<<grid, iisan::kReplayThreads, 0, s>>>(
        static_cast<float*>(out), B, H, tt, chunks, static_cast<unsigned>(seed), site0,
        threshold, scale);
  return static_cast<int>(cudaGetLastError());
}
