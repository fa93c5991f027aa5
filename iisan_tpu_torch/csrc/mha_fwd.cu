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
// fp32 (the fp32 compute dtype: any --use_scale but "half"), on the tensor
// cores in three TF32 passes (mha.cuh's fp32 section has the arithmetic).
// What bounds it: its operations, 84 GFLOP at the ViT step run three times
// on TF32's 495 TFLOP/s (0.509 ms), and equally its bytes (1.70 GB, 0.509
// ms); on the CUDA cores' 67 TFLOP/s the function alone would take 1.253
// ms.  In fp32 T(p) is p, so nothing forces the rows' statistics before
// pd: the design is one streaming pass over keys at every T from 1 to
// 46,340, with no resident limit.
// - A block per (64-row query tile, head, image), one warpgroup.  TMA loads
//   the Q tile (two 32-column boxes), split once into hi and lo in place,
//   and each 64-key K and V tile into a stage of its own.  K is split into
//   two working tiles (K-major, as S = Q . K^T reads them) and its stage
//   takes the next tile at once; while S's 24 wgmmas (8 k8 steps x 3
//   passes) run, the threads read V's columns into registers and its stage
//   takes the next tile.  The scores update the rows' running max and sum
//   (expf once an element; the O accumulator and the sum rescaled by
//   exp(old max - new max)), the keep bits are drawn as in bf16
//   (`row_keep`), and e x keep goes from the accumulator to the register A
//   operand of O += P . V (hi and lo fragments; 24 wgmmas, fewer where a
//   tile's last 8-key steps lie past T), whose B, V transposed (V's rows
//   become the product's K), goes into the working tiles once S has read
//   them.  O / sum is stored from the registers, rows past T skipped.
// - 96 KB of shared memory (Q, the two stages, the working tiles), two
//   blocks an SM; ptxas's registers are in build.log.  This replaced a
//   CUDA-core two-pass kernel: at the ViT step 10.59-10.67 -> 2.09 ms
//   of device time, against SDPA fp32's 4.34-4.37
//   (scripts/torch_mha_fwd_bench.py on an H100 at 700 W).
// - An image's output depends on its own rows only, as in bf16.

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

// The fp32 forward (see the top).  Shared memory from the 1024-aligned
// base: Q hi, Q lo, the TMA stages of a K and a V tile, two working tiles
// (the K tile's hi and lo, then V^T's), the tile's key biases, the
// barriers (Q, K, V).
struct F32FwdLayout {
  static constexpr int qh = 0, ql = kF32Tile, kraw = 2 * kF32Tile, vraw = 3 * kF32Tile;
  static constexpr int wh = 4 * kF32Tile, wl = 5 * kF32Tile, bias = 6 * kF32Tile;
  static constexpr int bars = bias + kFwdTile * 4;
  static constexpr size_t bytes = bars + 3 * sizeof(uint64_t) + 1024;  // + alignment
};

template <bool kDrop>
__global__ void __launch_bounds__(kF32Threads, 2)
    mha_fwd_tf32_kernel(const __grid_constant__ CUtensorMap qm,
                        const __grid_constant__ CUtensorMap km,
                        const __grid_constant__ CUtensorMap vm, const float* __restrict__ bias,
                        float* __restrict__ out, Dims d, Dropout drop) {
  typedef F32FwdLayout L;
  extern __shared__ __align__(1024) unsigned char f32_smem[];
  unsigned char* base = align1024(f32_smem);
  float* Bs = reinterpret_cast<float*>(base + L::bias);
  uint64_t* bar = reinterpret_cast<uint64_t*>(base + L::bars);  // Q, K, V
  const int Tn = d.T, i0 = blockIdx.x * kFwdTile, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, t = lane & 3, c0 = h * kDk;
  const int n_kt = (Tn + kFwdTile - 1) / kFwdTile;
  const unsigned site = d.site0 + h;
  const uint32_t qh = sm90::smem_u32(base + L::qh), ql = sm90::smem_u32(base + L::ql);
  const uint32_t wh = sm90::smem_u32(base + L::wh), wl = sm90::smem_u32(base + L::wl);
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) sm90::mbar_init(&bar[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    sm90::mbar_expect_tx(&bar[0], kF32Tile);
    load_f32_tile(base + L::qh, &qm, &bar[0], c0, i0, b);
    sm90::mbar_expect_tx(&bar[1], kF32Tile);
    load_f32_tile(base + L::kraw, &km, &bar[1], c0, 0, b);
    sm90::mbar_expect_tx(&bar[2], kF32Tile);
    load_f32_tile(base + L::vraw, &vm, &bar[2], c0, 0, b);
  }
  __syncthreads();
  sm90::mbar_wait(&bar[0], 0);
  split_tile(base + L::qh, base + L::qh, base + L::ql);
  const float* brow = bias != nullptr ? bias + static_cast<size_t>(b) * Tn : nullptr;
  const int r0 = i0 + 16 * warp + lane / 4;  // this thread's rows r0 and r0 + 8
  float m[2] = {-FLT_MAX, -FLT_MAX}, l[2] = {0.f, 0.f}, o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
#pragma unroll 1
  for (int kt = 0; kt < n_kt; ++kt) {
    const int j0 = kt * kFwdTile;
    const unsigned par = kt & 1;
    const bool next = kt + 1 < n_kt;
    if (brow != nullptr && tid < kFwdTile) Bs[tid] = j0 + tid < Tn ? brow[j0 + tid] : 0.f;
    sm90::mbar_wait(&bar[1], par);
    split_tile(base + L::kraw, base + L::wh, base + L::wl);
    sm90::fence_async_shared();
    __syncthreads();  // K (and Q) split, K's stage read, the biases staged
    if (tid == 0 && next) {
      sm90::mbar_expect_tx(&bar[1], kF32Tile);
      load_f32_tile(base + L::kraw, &km, &bar[1], c0, j0 + kFwdTile, b);
    }
    float s[32];
    sm90::fence_acc(s);
    sm90::wgmma_fence();
    mma3_ss(s, qh, ql, wh, wl, 0);
    sm90::wgmma_commit();
    // V's columns into registers while S runs; V's stage then takes the
    // next tile.
    sm90::mbar_wait(&bar[2], par);
    float vv[8][4];
    gather_cols(vv, base + L::vraw);
    sm90::fence_async_shared();  // the reads before the stage's next TMA write
    __syncthreads();
    if (tid == 0 && next) {
      sm90::mbar_expect_tx(&bar[2], kF32Tile);
      load_f32_tile(base + L::vraw, &vm, &bar[2], c0, j0 + kFwdTile, b);
    }
    sm90::wgmma_wait<0>();
    sm90::fence_acc(s);
    // The rows' running max and sum; e x keep into fragments.
    float tm[2] = {-FLT_MAX, -FLT_MAX}, corr[2];
    block_scores(s, tm, brow != nullptr ? Bs : nullptr, j0, Tn, d.inv_sqrt_dk, t);
    quad_max(tm);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float mn = fmaxf(m[half], tm[half]);
      corr[half] = expf(m[half] - mn);
      m[half] = mn;
      l[half] *= corr[half];
    }
    RowKeep keep[2];
    if (kDrop) {
#pragma unroll
      for (int half = 0; half < 2; ++half)
        keep[half] = row_keep(drop, site, b, r0 + 8 * half, j0, Tn, lane);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e4 = 0; e4 < 4; ++e4) {
        const int i = 4 * j + e4, half = e4 >> 1;
        o[i] *= corr[half];
        const float e = expf(s[i] - m[half]);
        l[half] += e;
        s[i] = !kDrop ? e : keep[half].keeps(j, e4 & 1) ? e * drop.scale : 0.f;
      }
    Frags f;
    make_frags(f, s);
    __syncthreads();  // every warp's S has read the working tiles
    scatter_split(base + L::wh, base + L::wl, vv);
    sm90::fence_async_shared();
    __syncthreads();  // V^T written
    // O += (e x keep) . V in three passes, its fragments from registers.
    sm90::fence_acc(o);
    sm90::wgmma_fence();
    mma3_rs(o, f, wh, wl, live_steps(j0, Tn));
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_acc(o);
    fence_frags(f);
    __syncthreads();  // every warp's O product has read V^T, the biases used
  }
  finish_sums(l);
  const float rl[2] = {__frcp_rn(l[0]), __frcp_rn(l[1])};
  store_f32(out + (static_cast<size_t>(b) * Tn + i0) * d.D + c0, o, rl, i0, Tn, d.D, warp, lane);
}

// One launch of the fp32 design; q, k and v start on 16-byte boundaries
// (TMA), which the wrapper checks.
cudaError_t launch_tf32(const void* q, const void* k, const void* v, const void* bias, void* out,
                        int B, const Dims& d, const Dropout& drop, cudaStream_t stream) {
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const cudaError_t err = sm90::encode_planes_f32(&maps[i], ptrs[i], d.D, d.T, B);
    if (err != cudaSuccess) return err;
  }
  const auto kernel = drop.on ? mha_fwd_tf32_kernel<true> : mha_fwd_tf32_kernel<false>;
  const cudaError_t err = allow_smem(kernel, F32FwdLayout::bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((d.T + kFwdTile - 1) / kFwdTile, d.H, B);
  kernel<<<grid, kF32Threads, F32FwdLayout::bytes, stream>>>(
      maps[0], maps[1], maps[2], static_cast<const float*>(bias), static_cast<float*>(out), d,
      drop);
  return cudaGetLastError();
}

}  // namespace
}  // namespace iisan

// q, k, v, out (B, T, D) T; bias (B, T) fp32 or null.  T is bf16 when
// is_bf16, else fp32; either way on the tensor cores, with q, k, v (and,
// in bf16, out) 16-byte aligned.  Dropout is on when rate > 0: Philox key
// `seed`, keep factor `scale` (1/(1-rate) in fp32), sites layer * H + head.
// Returns the CUDA error of the launch (0 on success).
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
                                  : iisan::launch_tf32(q, k, v, bias, out, B, d, drop, s);
  return static_cast<int>(err);
}
