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
// TB/s; its 84 GFLOP would take 0.085 ms on the bf16 tensor cores.  Past
// the bytes, the per-element work sets the pace: 328 M probabilities at
// that step, each an exp, a division and a rounding (and, in train mode,
// its share of a Philox call), on the CUDA cores.
//
// Design (bf16), on Hopper's own path (mha.cuh has the code, which the
// subblocks' attention step runs too):
// - T <= 320 (BERT's 30 and ViT's 197 / 257 tokens): a block per (head,
//   image), one warpgroup of 128 threads.  One thread loads K_h and V_h
//   whole and the first two 64-row Q tiles by TMA (3-D tensor maps over
//   (D, T, B): 64 x 64 boxes of one head, 128-byte swizzled, zeros past
//   T), each on its own mbarrier, so the first tile's S starts when K has
//   landed while V is still arriving.  Per query tile: S = Q . K^T on wgmma
//   m64n64k16 chunks of 64 keys (Q and K K-major from shared memory), kept
//   in registers (32 a thread a chunk); the rows' max and sum from them by
//   quad shuffles; exp once an element; p by a division whose reciprocal is
//   taken once a row (`div_rn`: the IEEE quotient for normal numbers);
//   pd rounded and, in train mode, dropped; pd packed straight from the
//   accumulator layout into wgmma's register A operand for O = pd . V (V
//   MN-major from shared memory, k16 steps past T skipped); O staged
//   swizzled and stored by TMA, clipped at T.  The tile after next loads
//   into the Q buffer the tile has just read.  8-key groups wholly past T
//   skip the elementwise work, and so do warps whose 16 rows lie past T
//   (they feed zeros to the product).  Registers hold S whole (NC = T / 64
//   rounded up chunks, NC a template parameter: 160 values at 320 keys),
//   so a block is one warpgroup and two blocks share an SM (90 KB of shared
//   memory at T = 197); while one block waits on its loads or products,
//   the other's elementwise work runs.  Both products commit a group per
//   64-key chunk: a chunk's scores are scaled and maxed while the next
//   chunk's S runs, and a chunk's pd . V runs while the next chunk's pd is
//   formed (two fragment buffers, so 257-320 keys fit without spills).
//   BERT's 30 keys take this design too: it measured faster there than the
//   mma.sync design it replaced, so no dispatch by T keeps that one.
// - T > 320 (up to 46,340): a block per (64-row query tile, head, image),
//   one warpgroup; 64-key K tiles (pass 1) and K and V tiles (pass 2)
//   stream through a 3-deep TMA ring, one thread refilling each stage
//   once a block barrier says every warp's products have read it.  p is
//   normalised before it is rounded, so pass 1 takes the rows' max and sum
//   (online, rescaled) and pass 2 recomputes S and forms O, both products
//   on wgmma as above; 65 KB, three blocks an SM.  (A producer warp
//   beside the warpgroup put the wgmmas in a branch of the block's
//   threads, and ptxas serialised them.)
// - Dropout (train mode): a row's 64-key chunk holds 16 or 17 Philox groups
//   of four elements; each lane of a quad draws every fourth group once
//   (philox_bits4), packs their keep bits into one word and the quad passes
//   the words round (`row_keep`), so a call serves four elements.  Masks
//   are the same bits as ops/philox.py, the backward's and #7's.
// - An image's output depends on its own rows only: a block reads one
//   (image, head) and the boxes never cross an image's edge.
//
// Why one pass: two passes at every T on mma.sync (the rows' statistics,
// then the scores again, pd and O), with expf twice and an IEEE division
// an element over keys padded to 64-key tiles, took 2.00-2.01 ms of
// device time at the ViT step against SDPA's 0.43-0.44
// (scripts/torch_mha_fwd_bench.py on an H100 at 700 W; PERF.md's kernel
// table has this design's times at each shape).  Replacing expf by the
// approximate __expf moved the ViT step by 3% only (PERF.md): the pace is
// set by the block's chain of loads, products, waits and barriers at two
// blocks an SM, not by the exp.
//
// fp32 (tests, the fp32 compute dtype): the same two passes on the CUDA
// cores (mha.cuh's rows kernels), 32-row query tiles against 32-key tiles;
// no TF32, which keeps about three digits.

#include "mha.cuh"

namespace iisan {
namespace {

using namespace mha;

// The two bf16 designs (see the top; mha.cuh's fwd_resident_block and
// fwd_streamed_block), for NC key chunks and eval / train mode.
template <int NC, bool kDrop>
__global__ void __launch_bounds__(kFwdThreads, 2)
    mha_fwd_resident_kernel(const __grid_constant__ CUtensorMap qm,
                            const __grid_constant__ CUtensorMap km,
                            const __grid_constant__ CUtensorMap vm,
                            const __grid_constant__ CUtensorMap om,
                            const float* __restrict__ bias, Dims d, Dropout drop) {
  fwd_resident_block<NC, kDrop>(&qm, &km, &vm, &om, bias, d, drop);
}

template <bool kDrop>
__global__ void __launch_bounds__(kFwdThreads, 3)
    mha_fwd_streamed_kernel(const __grid_constant__ CUtensorMap qm,
                            const __grid_constant__ CUtensorMap km,
                            const __grid_constant__ CUtensorMap vm,
                            const __grid_constant__ CUtensorMap om,
                            const float* __restrict__ bias, Dims d, Dropout drop) {
  fwd_streamed_block<kDrop>(&qm, &km, &vm, &om, bias, d, drop);
}

const FwdKernels kFwdKernels = {
    {{mha_fwd_resident_kernel<1, false>, mha_fwd_resident_kernel<1, true>},
     {mha_fwd_resident_kernel<2, false>, mha_fwd_resident_kernel<2, true>},
     {mha_fwd_resident_kernel<3, false>, mha_fwd_resident_kernel<3, true>},
     {mha_fwd_resident_kernel<4, false>, mha_fwd_resident_kernel<4, true>},
     {mha_fwd_resident_kernel<5, false>, mha_fwd_resident_kernel<5, true>}},
    {mha_fwd_streamed_kernel<false>, mha_fwd_streamed_kernel<true>}};

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
// is_bf16 (tensor cores; q, k, v and out 16-byte aligned), else fp32 (CUDA
// cores).  Dropout is on when rate >
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
  const cudaError_t err = is_bf16 ? iisan::mha::launch_fwd_tc(iisan::kFwdKernels, q, k, v, bias, out, B, d, drop, s)
                                  : iisan::launch_rows<float>(q, k, v, bias, out, B, d, drop, s);
  return static_cast<int>(err);
}
