// Encoder self-attention backward: recomputes the forward's probabilities
// (and its dropout masks) from (q, k, v, bias, seed) and returns gq, gk, gv,
// heads unsplit, by the cast chain of the Pallas kernel (mha.cuh):
//
//   gPd = g . v_h^T          gV = pd^T . g          (fp32 sums of T operands)
//   gP  = gPd * keep         gS = T(p * (gP - sum_j gP p) / sqrt(dk))
//   gQ  = gS . k_h           gK = gS^T . q_h
//
// The row term sum_j gP_ij p_ij is `_softmax_bwd`'s, over fp32 p, and not
// FlashAttention's rowsum(dO * O), which would take the rounded, dropped pd
// (the two agree up to that rounding only).  So every key of a query row
// has to be seen before any gS of that row is formed.
//
// Replaces the Pallas TPU kernel `_mha_bwd_kernel` (iisan_tpu/ops/
// fused_attention.py:106).  The TPU kernel replays its on-chip generator's
// draw schedule; here the masks are Philox at the forward's (seed, image,
// site, element) addresses, recomputed where they are needed.  No atomics
// anywhere, so results repeat bit for bit from run to run.
//
// What bounds it on the H100: its bytes (q, k, v, g read, gq, gk, gv written:
// 7 x B x T x D x 2 bytes) and its five products, 10 B H T^2 dk FLOP; at
// the FFT geometry (88 images, T=197, D=768) that is 186 MB (0.056 ms at
// 3.35 TB/s) and 26 GFLOP (0.027 ms on the bf16 tensor cores).  Past those,
// the per-element work: 41 M elements there, each an exp, a division, two
// roundings and, in train mode, a quarter of a Philox call.
//
// Design (bf16, T <= 512 = kClusterMaxKeys): one launch, a thread-block
// cluster of C = T / 64 rounded up blocks (1-8, sizes the H100 schedules
// without opting into non-portable clusters) per (head, image); block r
// owns keys 64 r .. 64 r + 63 and is one warpgroup (128 threads).  512 keys
// is the whole range where the TPU kernel runs at ViT width
// (`_pick_batch_block` in the JAX package takes no more at D = 768 in bf16);
// the layout below does not depend on C, only the exchanges read C
// partials.
// - TMA (the forward's 3-D maps over (D, T, B), 64 x 64 boxes, 128-byte
//   swizzle; rows past T read as zeros and no box reaches the next image)
//   loads K_r and V_r once, each on its own mbarrier, and the 64-row query
//   tiles of Q and g through a two-stage ring; one thread refills a stage
//   once the block's products have read it.
// - Per query tile (all C blocks walk the same C tiles in order):
//   S = Q . K_r^T and gPd = g . V_r^T on wgmma m64n64k16 (query-major, so
//   the accumulators have the forward's layout and mha.cuh's row_keep
//   serves as it is).  Keys past T are -inf scores, selected and not
//   branched around, so every element takes the same instructions and a
//   thread's 32 stay independent work.  The rows' statistics over all keys
//   come from three exchanges through distributed shared memory, each a
//   cluster barrier: the partial maxes over the
//   block's keys (then e = exp(s - max) once an element, with the same max
//   as the forward's), the partial sums of e (then p = e / sum, the
//   division's reciprocal taken once a row, `div_rn`), and the partial row
//   terms sum gP p.  Every block combines the C partials in rank order
//   0, 1, ..., C - 1 as a running sum (or max), so every block holds the
//   same bits.  Keep bits are
//   drawn once per group of four elements (`row_keep`) while the first
//   barrier is pending; pd is formed while the third is.
// - pd and gS are rounded to bf16 into two swizzled 64 x 64 tiles in shared
//   memory, which feed the three other products on wgmma: gV += pd^T . g
//   and gK += gS^T . Q (the tiles read MN-major as A, wgmma's transpose bit
//   for 16-bit types; g and Q MN-major as B) stay in registers across the
//   query tiles; the gQ partial gS . K_r (the gS tile K-major as A, K_r
//   MN-major as B) goes to an fp32 tile in shared memory.  After the next
//   tile's first barrier, block r sums its 1 / C share of that tile's gQ
//   across the cluster in rank order and writes it in bf16 (while the next
//   tile's second barrier is pending).  gK and gV leave through a swizzled
//   staging tile by TMA, clipped at T.
// - So each (query tile, key tile) costs five products, one exp, one
//   division and a quarter of a Philox call an element (train mode), and
//   nothing goes through device memory between them: no scratch, no
//   atomics, and two launches on the same inputs are bit-equal.
// - 86 KB of shared memory a block at every C, two blocks an SM; a thread
//   holds four 64 x 64 fp32 tiles (S, gPd, gK, gV; the gQ partial, a fifth,
//   lives while S and gPd are rounded into the tiles).  ptxas: 232-241
//   registers a thread at two to eight key blocks, 122-123 at one, no
//   spills (build.log has every instance's).  BERT's 30
//   tokens (one block) ran faster here than on the mma.sync pair that
//   took every T before this design.
// - An H100 holds 264, 132, 79, 62, 47, 39, 32 and 30 clusters of one to
//   eight blocks at once (cudaOccupancyMaxActiveClusters), so from three
//   blocks on 6-15% of its 264 block slots stay idle (15% at seven), where
//   a GPC's SMs do not divide into whole clusters.  The wrapper asks
//   `iisan_mha_bwd_active_clusters` once an instance and raises where a
//   cluster of C blocks cannot be scheduled: no other design runs in its
//   place.
// The forward forms the rows' sums in another order, so a probability may
// round to the other bf16 neighbour here only (within the bf16 tolerance).
//
// On an H100 the block's chain of loads, products, exchanges and barriers
// sets the pace at two blocks an SM, and the elementwise steps take most
// of a tile's cycles (PERF.md).  A cluster's C blocks each walk C query
// tiles, so a call's block-tiles grow as C^2.  Tried in development and
// not kept:
// branching around 8-key groups past T, as the forward does (slower than
// the selects above at 197 and 257 tokens); three blocks an SM (168
// registers, the gQ partial in the pd / gS tiles: spills, slower); two
// warpgroups a block, each on half the keys and head columns (64-byte-
// swizzled half boxes, m64n32 products: not faster); the rows' max and sum
// in one exchange, each block's sum rescaled by exp(its max - the
// cluster's) (faster by a few percent, but p would no longer be exp(s -
// max) / sum as the forward and the plain version form it).
//
// T > 512 (up to 46,340 keys): the split design, two kernels on wgmma with
// TMA, joined by an fp32 (B, H, T, 3) scratch of each query row's (max,
// sum, row term).  The TPU kernel runs here too at narrower heads:
// `_pick_batch_block` takes up to 961, 903, 849, 709 and 512 keys at D =
// 64, 128, 192, 384 and 768 in bf16 (ViT-tiny's 192 wide at 384 pixels,
// 577 tokens, among them), past the 8 blocks of 64 keys a portable
// cluster holds.
// - Query-tile kernel: a block per (64-row query tile, head, image), one
//   warpgroup.  Q and g load once by TMA; 64-key K and V tiles stream
//   through a three-stage TMA ring, twice.  Pass 0: S = Q . K^T and gPd =
//   g . V^T on wgmma (query-major, so `row_keep` serves as it is), then the
//   rows' running max, sum and row term sum_j gP e (both sums rescaled by
//   exp(old max - new max) as the max grows, as the fp32 query-tile kernel
//   does; term / sum at the end is sum_j gP p over fp32 p).  Pass 1: both
//   products again, p = exp(s - max) / sum, gS = T(p (gP - term) /
//   sqrt(dk)) in registers as the A operand of gQ += gS . K (K MN-major as
//   B, as the forward's pd . V).  Five products a (query tile, key tile).
//   Writes gQ by TMA and the scratch.
// - Key-tile kernel: a block per (64-key tile, head, image), one
//   warpgroup: the cluster design's block at one block a cluster, its
//   three exchanges replaced by a read of the scratch.  K_r and V_r
//   resident; each query tile's Q, g and 64 rows of statistics through a
//   two-stage ring (TMA boxes and a bulk copy on one mbarrier a stage); S
//   and gPd recomputed, pd and gS rounded into swizzled tiles, then gV +=
//   pd^T . g and gK += gS^T . Q with both tiles read MN-major as A.  Four
//   products a tile: nine in all, where the function has five.
// - Keys past T are -inf scores, selected and not branched around; the
//   dropout element stays query * T + key.  No atomics: both kernels sum
//   in a fixed order, so two launches are bit-equal.
// - This replaced a pair on mma.sync m16n8k16 with cp.async staging (three
//   passes over the keys for dq, ten products a tile pair); PERF.md has
//   both designs' times.

// fp32 (the fp32 compute dtype: any --use_scale but "half"), every T from
// 1 to 46,340: the same split, each product in three TF32 passes on wgmma
// m64n64k8 (mha.cuh's fp32 section), so the function stays the plain fp32
// one within 1e-4.  What bounds it: its five products, 26 GFLOP at the FFT
// geometry (88 x 197), three times over on TF32's 495 TFLOP/s (0.159 ms;
// 0.392 ms on the CUDA cores' 67 TFLOP/s), against 0.111 ms of bytes.
// - Both kernels are blocks of two warpgroups that share every tile they
//   stream: with one warpgroup (64 rows) a block, and one block an SM for
//   its 160-192 KB of shared memory, each tile's load, split, products and
//   elementwise steps ran in series and measured slower.  Holding an A
//   fragment across iterations so that a product runs on beside the next
//   split measured slower still (ptxas then serialises the wgmmas).
// - Query-tile kernel: a block per (128-row query tile, head, image),
//   warpgroup w on rows 64 w .. 64 w + 63.  Each warpgroup's Q and g (TMA,
//   two 32-column boxes a tile) are split in place into hi and lo once;
//   64-key K and V tiles stream through one TMA stage each, twice, split in
//   place by the block's threads and refilled once every product has read
//   them.  Pass 0: S = Q . K^T and gPd = g . V^T (A and B K-major in shared
//   memory), the rows' running max, sum and row term sum_j gP e (sum and
//   term rescaled by exp(old max - new max) as the max grows; term / sum
//   at the end is sum_j gP p over fp32 p).  Pass 1: both products again, p
//   = exp(s - max) / sum, gS = p (gP - term) / sqrt(dk), and gQ += gS . K
//   with gS from the accumulators as the register A operand and K^T
//   transposed by the threads while S and gPd run.  Writes gQ and the
//   (B, H, T, 3) scratch of each row's (max, sum, term).  224 KB of shared
//   memory, one block an SM.
// - Key-tile kernel: a block per (128-key tile, head, image), warpgroup w
//   on keys 64 w .. 64 w + 63, its K and V split once and resident as the
//   A operands of S^T = K . Q^T and gPd^T = V . g^T; the query tiles walked
//   in order, Q and g by TMA into stages of their own (the next tile loads
//   while one is worked on), split, then transposed in place once those
//   products have read them; p from the scratch's statistics, pd = p keep,
//   gS, then gV += pd^T . g and gK += gS^T . Q with pd^T and gS^T as
//   register A operands.  The dropout element stays query * T + key (a
//   Philox call an element here: the accumulator's rows are keys).  226 KB,
//   one block an SM.
// - No atomics: both kernels sum in a fixed order, so two launches are
//   bit-equal.  This replaced a CUDA-core pair (32-row tiles, scalar
//   FMA loops): at 88 x 197 4.07-4.12 -> 1.25 ms of device time, against
//   SDPA fp32's backward at 1.34-1.37 (scripts/torch_mha_bwd_bench.py on
//   an H100 at 700 W; PERF.md has every case).

#include "mha.cuh"

namespace iisan {
namespace {

using namespace mha;

// ---------------------------------------------------------------------
// bf16, T <= kClusterMaxKeys: the cluster design (see the top)
// ---------------------------------------------------------------------

constexpr int kClusterMaxKeys = 512;  // 8 blocks of 64 keys: the portable cluster size
constexpr int kMaxCluster = kClusterMaxKeys / kFwdTile;
constexpr int kBwdThreads = 128;     // a block: one warpgroup
constexpr int kGqStr = kDk + 8;      // fp32 row stride of the gQ partial (spreads rows over banks)

// Shared memory from the 1024-aligned base: K_r, V_r, the ring's two Q and
// two g boxes, the pd and gS tiles (then the gK and gV staging tiles), the
// gQ partial, the three exchanged row statistics, the key biases, the
// barriers (K, V, ring stage 0, 1).
struct ClusterLayout {
  static constexpr int k = 0, v = kFwdBox, q = 2 * kFwdBox, g = 4 * kFwdBox;
  static constexpr int pd = 6 * kFwdBox, gs = 7 * kFwdBox, gq = 8 * kFwdBox;
  static constexpr int stats = gq + kFwdTile * kGqStr * 4;  // max, sum, term: 64 rows each
  static constexpr int bias = stats + 3 * kFwdTile * 4;
  static constexpr int bars = bias + kFwdTile * 4;
  static constexpr size_t bytes = bars + 4 * sizeof(uint64_t) + 1024;  // + alignment
};

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// The address of the same shared-memory location in block `rank` of the
// cluster.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ float ld_cluster(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ float4 ld_cluster4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// The rows (g, g + 8) of this warp's 16: their values of one exchanged
// statistic (64 floats at `stat` in every block), combined over the NC
// ranks in rank order by max or sum, a running one (one partial loaded a
// step, so the registers do not grow with NC).
template <int NC, bool kMax>
__device__ __forceinline__ void combine_rows(float (&out)[2], uint32_t stat, int warp, int lane) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const uint32_t row = stat + (16 * warp + lane / 4 + 8 * half) * 4;
    float v = ld_cluster(map_rank(row, 0));
#pragma unroll
    for (int r = 1; r < NC; ++r) {
      const float x = ld_cluster(map_rank(row, r));
      v = kMax ? fmaxf(v, x) : v + x;
    }
    out[half] = v;
  }
}

// This lane's shares of the rows (g, g + 8) summed across the quad and
// written by its first lane to `stat` (64 floats).
__device__ __forceinline__ void put_rows(float* stat, const float (&v)[2], int warp, int lane) {
  if (lane % 4 == 0) {
    stat[16 * warp + lane / 4] = v[0];
    stat[16 * warp + lane / 4 + 8] = v[1];
  }
}

// Block `rank`'s share of query tile mt's gQ: the 64 x 64 tile in 4-float
// units, 1 / NC of them a block, each summed over the NC blocks' partials
// in rank order (a running sum) and written in bf16 (rows past T skipped).
template <int NC>
__device__ __forceinline__ void reduce_gq(uint32_t part, bf16* __restrict__ gq, int mt, int rank,
                                          int b, int h, const Dims& d) {
  constexpr int kUnits = kFwdTile * kDk / 4, kPer = (kUnits + NC - 1) / NC;
  const int u1 = min(kUnits, (rank + 1) * kPer);
  for (int u = rank * kPer + static_cast<int>(threadIdx.x); u < u1; u += kBwdThreads) {
    const int row = u / (kDk / 4), c4 = u % (kDk / 4), i = mt * kFwdTile + row;
    if (i >= d.T) break;  // units run row by row
    const uint32_t at = part + (row * kGqStr + 4 * c4) * 4;
    float4 v = ld_cluster4(map_rank(at, 0));
#pragma unroll
    for (int r = 1; r < NC; ++r) {  // a running sum: one partial in registers at a time
      const float4 x = ld_cluster4(map_rank(at, r));
      v.x += x.x;
      v.y += x.y;
      v.z += x.z;
      v.w += x.w;
    }
    *reinterpret_cast<uint2*>(gq + (static_cast<size_t>(b) * d.T + i) * d.D + h * kDk + 4 * c4) =
        make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
  }
}

// The bf16 pair (a, b) at row r, columns 8 j + 2t, +1 of a swizzled 64 x
// 64 tile (the layout of the TMA boxes and of stage_o).
__device__ __forceinline__ void put_pair(unsigned char* tile, int r, int j, int t, float a,
                                         float b) {
  *reinterpret_cast<__nv_bfloat162*>(tile + r * 128 + ((j ^ (r & 7)) * 16) + t * 4) =
      __floats2bfloat162_rn(a, b);
}

// One block of the cluster design: NC key chunks (the cluster's size and
// the number of query tiles), eval or train mode.
template <int NC, bool kDrop>
__global__ void __launch_bounds__(kBwdThreads, 2)
    mha_bwd_cluster_kernel(const __grid_constant__ CUtensorMap qm,
                           const __grid_constant__ CUtensorMap km,
                           const __grid_constant__ CUtensorMap vm,
                           const __grid_constant__ CUtensorMap gm,
                           const __grid_constant__ CUtensorMap gkm,
                           const __grid_constant__ CUtensorMap gvm,
                           const float* __restrict__ bias, bf16* __restrict__ gq, Dims d,
                           Dropout drop) {
  typedef ClusterLayout L;
  extern __shared__ __align__(1024) unsigned char bwd_smem[];
  unsigned char* base = align1024(bwd_smem);
  unsigned char* Pt = base + L::pd;
  unsigned char* St = base + L::gs;
  float* part = reinterpret_cast<float*>(base + L::gq);
  float* stats = reinterpret_cast<float*>(base + L::stats);  // max, sum, term
  float* Bs = reinterpret_cast<float*>(base + L::bias);
  uint64_t* bar = reinterpret_cast<uint64_t*>(base + L::bars);  // K, V, ring stage 0, 1
  const int rank = blockIdx.x, h = blockIdx.y, b = blockIdx.z, Tn = d.T;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, t = lane & 3;
  const int j0 = rank * kFwdTile;  // the block's first key
  const unsigned site = d.site0 + h;
  const uint32_t ka = sm90::smem_u32(base + L::k), va = sm90::smem_u32(base + L::v);
  const uint32_t pa = sm90::smem_u32(Pt), sa = sm90::smem_u32(St);
  const uint32_t stat_max = sm90::smem_u32(stats), stat_sum = stat_max + kFwdTile * 4,
                 stat_term = stat_sum + kFwdTile * 4, part_a = sm90::smem_u32(part);
  if (tid == 0) {
    for (int i = 0; i < 4; ++i) sm90::mbar_init(&bar[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (bias != nullptr)
    for (int j = tid; j < kFwdTile; j += kBwdThreads)
      Bs[j] = j0 + j < Tn ? bias[static_cast<size_t>(b) * Tn + j0 + j] : 0.f;
  __syncthreads();
  auto load_tile = [&](int mt) {  // thread 0: query tile mt's Q and g into ring stage mt & 1
    const int st = mt & 1;
    sm90::mbar_expect_tx(&bar[2 + st], 2 * kFwdBox);
    sm90::tma_load_3d(base + L::q + st * kFwdBox, &qm, &bar[2 + st], h * kDk, mt * kFwdTile, b);
    sm90::tma_load_3d(base + L::g + st * kFwdBox, &gm, &bar[2 + st], h * kDk, mt * kFwdTile, b);
  };
  if (tid == 0) {
    sm90::mbar_expect_tx(&bar[0], kFwdBox);
    sm90::tma_load_3d(base + L::k, &km, &bar[0], h * kDk, j0, b);
    sm90::mbar_expect_tx(&bar[1], kFwdBox);
    sm90::tma_load_3d(base + L::v, &vm, &bar[1], h * kDk, j0, b);
    for (int mt = 0; mt < 2 && mt < NC; ++mt) load_tile(mt);
  }
  const float* bias_s = bias != nullptr ? Bs : nullptr;
  float gk[32], gv[32];
#pragma unroll 1
  for (int mt = 0; mt < NC; ++mt) {
    const int st = mt & 1;
    const uint32_t qa = sm90::smem_u32(base + L::q + st * kFwdBox);
    const uint32_t ga = sm90::smem_u32(base + L::g + st * kFwdBox);
    sm90::mbar_wait(&bar[2 + st], (mt >> 1) & 1);
    if (mt == 0) {
      sm90::mbar_wait(&bar[0], 0);
      sm90::mbar_wait(&bar[1], 0);
    }
    // S = Q . K_r^T and gPd = g . V_r^T, a commit group each.
    float s[32], x[32];
    sm90::fence_acc(s);
    sm90::fence_acc(x);
    sm90::wgmma_fence();
    qk_chunk(s, qa, ka);
    sm90::wgmma_commit();
    qk_chunk(x, ga, va);
    sm90::wgmma_commit();
    const int r0 = mt * kFwdTile + 16 * warp;  // the warp's first query row
    const bool live = r0 < Tn;  // a warp whose 16 rows lie past T feeds zeros to the products
    sm90::wgmma_wait<1>();
    sm90::fence_acc(s);
    // Exchange 1: the rows' maxes over the block's keys.
    float m[2] = {-FLT_MAX, -FLT_MAX};
    if (live) {
      block_scores(s, m, bias_s, j0, Tn, d.inv_sqrt_dk, t);
      quad_max(m);
    }
    put_rows(stats, m, warp, lane);
    cluster_arrive();
    RowKeep keep[2];
    if (kDrop && live) {
#pragma unroll
      for (int half = 0; half < 2; ++half)
        keep[half] = row_keep(drop, site, b, r0 + lane / 4 + 8 * half, j0, Tn, lane);
    }
    sm90::wgmma_wait<0>();
    sm90::fence_acc(x);
    cluster_wait();
    combine_rows<NC, true>(m, stat_max, warp, lane);
    // Exchange 2: the rows' sums of e = exp(s - max).
    float l[2] = {0.f, 0.f};
    if (live) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        s[i] = expf(s[i] - m[(i >> 1) & 1]);
        l[(i >> 1) & 1] += s[i];
      }
      finish_sums(l);
    }
    put_rows(stats + kFwdTile, l, warp, lane);
    cluster_arrive();
    if (mt > 0) reduce_gq<NC>(part_a, gq, mt - 1, rank, b, h, d);
    cluster_wait();
    combine_rows<NC, false>(l, stat_sum, warp, lane);
    // Exchange 3: the rows' terms sum_j gP p.  s becomes p, x becomes gP.
    float term[2] = {0.f, 0.f};
    if (live) {
      const float rl[2] = {__frcp_rn(l[0]), __frcp_rn(l[1])};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e4 = 0; e4 < 4; ++e4) {
          const int half = e4 >> 1;
          const float p = div_rn(s[4 * j + e4], l[half], rl[half]);
          float gp = x[4 * j + e4];
          if (kDrop) gp *= keep[half].keeps(j, e4 & 1) ? drop.scale : 0.f;
          s[4 * j + e4] = p;
          x[4 * j + e4] = gp;
          term[half] += gp * p;
        }
      }
      finish_sums(term);
    }
    put_rows(stats + 2 * kFwdTile, term, warp, lane);
    cluster_arrive();
    // pd = T(p), dropped in train mode, into its tile while the barrier is
    // pending; 0 past T and in warps past T.
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float pd[2] = {0.f, 0.f};
        if (live) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            pd[e] = round_to<bf16>(s[4 * j + 2 * half + e]);
            if (kDrop) pd[e] = keep[half].keeps(j, e) ? round_to<bf16>(pd[e] * drop.scale) : 0.f;
          }
        }
        put_pair(Pt, 16 * warp + lane / 4 + 8 * half, j, t, pd[0], pd[1]);
      }
    cluster_wait();
    combine_rows<NC, false>(term, stat_term, warp, lane);
    // gS = T(p (gP - term) / sqrt(dk)) into its tile.
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float gs[2] = {0.f, 0.f};
        if (live) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * half + e;
            gs[e] = round_to<bf16>(
                __fmul_rn(__fmul_rn(s[i], __fsub_rn(x[i], term[half])), d.inv_sqrt_dk));
          }
        }
        put_pair(St, 16 * warp + lane / 4 + 8 * half, j, t, gs[0], gs[1]);
      }
    sm90::fence_async_shared();
    __syncthreads();  // both tiles written
    // gV += pd^T . g and gK += gS^T . Q over the tile's query rows (k16
    // steps past T skipped; the first call's first step starts the sums),
    // and the gQ partial gS . K_r over the block's keys.
    float gqp[32];
    sm90::fence_acc(gk);
    sm90::fence_acc(gv);
    sm90::fence_acc(gqp);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (mt * kFwdTile + 16 * kk >= Tn) break;
      const int acc = mt > 0 || kk > 0;
      wgmma_ss<1, 1>(gv, sm90::desc_w(pa + kk * 2048), sm90::desc_w(ga + kk * 2048), acc);
      wgmma_ss<1, 1>(gk, sm90::desc_w(sa + kk * 2048), sm90::desc_w(qa + kk * 2048), acc);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (j0 + 16 * kk >= Tn) break;
      wgmma_ss<0, 1>(gqp, sm90::desc_a(sa + kk * 32), sm90::desc_w(ka + kk * 2048), kk > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_acc(gk);
    sm90::fence_acc(gv);
    sm90::fence_acc(gqp);
    __syncthreads();  // every warp's products have read ring stage st and the tiles
    if (tid == 0 && mt + 2 < NC) load_tile(mt + 2);
    // The gQ partial, fp32, for the cluster's sum after the next barrier.
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = 16 * warp + lane / 4 + 8 * half;
        *reinterpret_cast<float2*>(part + r * kGqStr + 8 * j + 2 * t) =
            make_float2(gqp[4 * j + 2 * half], gqp[4 * j + 2 * half + 1]);
      }
  }
  cluster_arrive();  // the last tile's gQ partials are written
  cluster_wait();
  reduce_gq<NC>(part_a, gq, NC - 1, rank, b, h, d);
  // gK and gV of the block's keys through the (free) pd and gS tiles.
  stage_o(Pt, gk, warp, lane);
  stage_o(St, gv, warp, lane);
  sm90::fence_async_shared();
  __syncthreads();
  if (tid == 0) {
    sm90::tma_store_3d(&gkm, Pt, h * kDk, j0, b);
    sm90::tma_store_3d(&gvm, St, h * kDk, j0, b);
    sm90::bulk_commit();
  }
  cluster_arrive();  // no block leaves while another reads its gQ partial
  cluster_wait();
  if (tid == 0) sm90::bulk_wait();
}

typedef void (*ClusterKernel)(const CUtensorMap, const CUtensorMap, const CUtensorMap,
                              const CUtensorMap, const CUtensorMap, const CUtensorMap,
                              const float*, bf16*, Dims, Dropout);

// [NC - 1][train]
const ClusterKernel kClusterKernels[kMaxCluster][2] = {
    {mha_bwd_cluster_kernel<1, false>, mha_bwd_cluster_kernel<1, true>},
    {mha_bwd_cluster_kernel<2, false>, mha_bwd_cluster_kernel<2, true>},
    {mha_bwd_cluster_kernel<3, false>, mha_bwd_cluster_kernel<3, true>},
    {mha_bwd_cluster_kernel<4, false>, mha_bwd_cluster_kernel<4, true>},
    {mha_bwd_cluster_kernel<5, false>, mha_bwd_cluster_kernel<5, true>},
    {mha_bwd_cluster_kernel<6, false>, mha_bwd_cluster_kernel<6, true>},
    {mha_bwd_cluster_kernel<7, false>, mha_bwd_cluster_kernel<7, true>},
    {mha_bwd_cluster_kernel<8, false>, mha_bwd_cluster_kernel<8, true>}};

// The launch configuration of the instance for nc key blocks: grid (nc, H,
// B), clusters of nc blocks along x (sizes up to 8 are portable); sets the
// instance's shared-memory limit first.
cudaError_t cluster_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr, int nc, bool train,
                           int H, int B, cudaStream_t stream, ClusterKernel* kernel) {
  *kernel = kClusterKernels[nc - 1][train ? 1 : 0];
  const cudaError_t err = allow_smem(*kernel, ClusterLayout::bytes);
  if (err != cudaSuccess) return err;
  cfg = {};
  cfg.gridDim = dim3(nc, H, B);
  cfg.blockDim = dim3(kBwdThreads, 1, 1);
  cfg.dynamicSmemBytes = ClusterLayout::bytes;
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = nc;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

// One launch.  q, k, v, g, gk and gv start on 16-byte boundaries (TMA),
// which the wrapper checks.
cudaError_t launch_cluster(const void* q, const void* k, const void* v, const void* bias,
                           const void* g, void* gq, void* gk, void* gv, int B, const Dims& d,
                           const Dropout& drop, cudaStream_t stream) {
  CUtensorMap maps[6];
  const void* ptrs[6] = {q, k, v, g, gk, gv};
  for (int i = 0; i < 6; ++i) {
    const cudaError_t err = sm90::encode_planes(&maps[i], ptrs[i], d.D, d.T, B);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  ClusterKernel kernel;
  cudaError_t err = cluster_config(cfg, attr, (d.T + kFwdTile - 1) / kFwdTile, drop.on, d.H, B,
                                   stream, &kernel);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, kernel, maps[0], maps[1], maps[2], maps[3], maps[4], maps[5],
                           static_cast<const float*>(bias), static_cast<bf16*>(gq), d, drop);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// ---------------------------------------------------------------------
// bf16, T > kClusterMaxKeys: the split design (see the top)
// ---------------------------------------------------------------------

constexpr int kSplitStages = 3;  // the query-tile kernel's ring of K and V tiles
// A query tile's 64 rows of (max, sum, term) in the fp32 scratch, copied
// from the 16-byte boundary at or before its first row: 768 bytes and up to
// 12 before them, rounded up to 16.  The scratch holds kStatTail floats
// past its last row, so the last tile's copy stays inside it.
constexpr int kStatBytes = 784;
constexpr int kStatTail = kStatBytes / 4;

// The query-tile kernel's shared memory from the 1024-aligned base: its Q
// and g boxes (Q's becomes gQ's staging tile at the end), the ring's
// stages (a K box and a V box each), the barriers (Q and g, the stages).
struct SplitDqLayout {
  static constexpr int q = 0, g = kFwdBox, ring = 2 * kFwdBox;
  static constexpr int bars = ring + 2 * kSplitStages * kFwdBox;
  static constexpr size_t bytes = bars + (1 + kSplitStages) * sizeof(uint64_t) + 1024;
};

// This lane's key biases of a 64-key tile from the image's bias row brow
// in device memory (null: none), 0 past T: bv[2 j + e] is key j0 + 8 j + 2t
// + e's.  The query-tile kernel reads them while the tile's products run.
__device__ __forceinline__ void lane_biases(float (&bv)[16], const float* brow, int j0, int Tn,
                                            int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = j0 + 8 * j + 2 * t + e;
      bv[2 * j + e] = brow != nullptr && col < Tn ? brow[col] : 0.f;
    }
}

// mha.cuh's block_scores with the biases in registers (lane_biases').
__device__ __forceinline__ void lane_scores(float (&s)[32], float (&m)[2], const float (&bv)[16],
                                            bool biased, int j0, int Tn, float scale, int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = j0 + 8 * j + 2 * t + e;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float v = __fmul_rn(s[4 * j + 2 * half + e], scale);
        if (biased) v = __fadd_rn(v, bv[2 * j + e]);
        v = col < Tn ? v : -INFINITY;
        s[4 * j + 2 * half + e] = v;
        m[half] = fmaxf(m[half], v);
      }
    }
}

// The A fragments of gS = T(p (gP - term) / sqrt(dk)) over one 64-key tile
// (the layout of probs_frags) from its scores s (scaled, -inf past T) and
// gPd x: p = exp(s - max) / sum (rl = 1 / sum rounded), gP = gPd * keep.
// 0 past T, where p is 0.
template <bool kDrop>
__device__ __forceinline__ void grad_frags(unsigned (&a)[4][4], const float (&s)[32],
                                           const float (&x)[32], const float (&m)[2],
                                           const float (&l)[2], const float (&rl)[2],
                                           const float (&term)[2], const RowKeep (&keep)[2],
                                           float scale, float inv_sqrt_dk) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int j = 2 * kk + jj;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float gs[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * half + e;
          const float p = div_rn(expf(s[i] - m[half]), l[half], rl[half]);
          float gp = x[i];
          if (kDrop) gp *= keep[half].keeps(j, e) ? scale : 0.f;
          gs[e] = __fmul_rn(__fmul_rn(p, __fsub_rn(gp, term[half])), inv_sqrt_dk);
        }
        a[kk][2 * jj + half] = pack_bf16(gs[0], gs[1]);
      }
    }
}

// A block per (64-row query tile, head, image), one warpgroup.  Q and g
// come once by TMA; item it of the ring is key tile it % n_kt of pass it /
// n_kt (a K and a V box), and thread 0 refills a stage with the item
// kSplitStages on once every warp's products have read it.  Pass 0: S = Q
// . K^T and gPd = g . V^T on wgmma, the stage released, then the rows'
// running max, sum of e = exp(s - max) and term sum_j gP e, both sums
// rescaled by exp(old max - new max) as the max grows (term / sum at the
// end is sum_j gP p over fp32 p).  Pass 1: both products again, gS in
// registers as the A operand of gQ += gS . K (K MN-major), the stage
// released after it.  Writes gQ (through Q's box, by TMA, clipped at T)
// and each row's (max, sum, term) to stats.  A warp whose 16 rows lie past
// T feeds zeros to gQ's product.
template <bool kDrop>
__global__ void __launch_bounds__(kBwdThreads, 2)
    mha_bwd_dq_split_kernel(const __grid_constant__ CUtensorMap qm,
                            const __grid_constant__ CUtensorMap km,
                            const __grid_constant__ CUtensorMap vm,
                            const __grid_constant__ CUtensorMap gm,
                            const __grid_constant__ CUtensorMap gqm,
                            const float* __restrict__ bias, float* __restrict__ stats, Dims d,
                            Dropout drop) {
  typedef SplitDqLayout L;
  extern __shared__ __align__(1024) unsigned char bwd_smem[];
  unsigned char* base = align1024(bwd_smem);
  unsigned char* ring = base + L::ring;
  uint64_t* bar_qg = reinterpret_cast<uint64_t*>(base + L::bars);
  uint64_t* full = bar_qg + 1;
  const int Tn = d.T, i0 = blockIdx.x * kFwdTile, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, t = lane & 3;
  const int n_kt = (Tn + kFwdTile - 1) / kFwdTile, items = 2 * n_kt;
  const unsigned site = d.site0 + h;
  auto load = [&](int it) {  // thread 0: ring item it into its stage
    const int st = it % kSplitStages, j0 = (it % n_kt) * kFwdTile;
    unsigned char* dst = ring + st * 2 * kFwdBox;
    sm90::mbar_expect_tx(&full[st], 2 * kFwdBox);
    sm90::tma_load_3d(dst, &km, &full[st], h * kDk, j0, b);
    sm90::tma_load_3d(dst + kFwdBox, &vm, &full[st], h * kDk, j0, b);
  };
  if (tid == 0) {
    sm90::mbar_init(bar_qg, 1);
    for (int st = 0; st < kSplitStages; ++st) sm90::mbar_init(&full[st], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    sm90::mbar_expect_tx(bar_qg, 2 * kFwdBox);
    sm90::tma_load_3d(base + L::q, &qm, bar_qg, h * kDk, i0, b);
    sm90::tma_load_3d(base + L::g, &gm, bar_qg, h * kDk, i0, b);
    for (int it = 0; it < kSplitStages && it < items; ++it) load(it);
  }
  __syncthreads();
  auto release = [&](int it) {  // item it's products are done
    __syncthreads();
    if (tid == 0 && it + kSplitStages < items) load(it + kSplitStages);
  };
  const int r0 = i0 + 16 * warp;  // the warp's first query row
  const bool live = r0 < Tn;
  const float* brow = bias != nullptr ? bias + static_cast<size_t>(b) * Tn : nullptr;
  const uint32_t qa = sm90::smem_u32(base + L::q), ga = sm90::smem_u32(base + L::g);
  float m[2] = {-FLT_MAX, -FLT_MAX}, l[2] = {0.f, 0.f}, term[2] = {0.f, 0.f}, rl[2] = {1.f, 1.f};
  float acc[32];
  sm90::fence_acc(acc);
  sm90::mbar_wait(bar_qg, 0);
#pragma unroll 1
  for (int it = 0; it < items; ++it) {
    const int j0 = (it % n_kt) * kFwdTile, st = it % kSplitStages;
    sm90::mbar_wait(&full[st], (it / kSplitStages) & 1);
    const uint32_t ka = sm90::smem_u32(ring + st * 2 * kFwdBox), va = ka + kFwdBox;
    float s[32], x[32];
    sm90::fence_acc(s);
    sm90::fence_acc(x);
    sm90::wgmma_fence();
    qk_chunk(s, qa, ka);
    sm90::wgmma_commit();
    qk_chunk(x, ga, va);
    sm90::wgmma_commit();
    float bv[16];
    lane_biases(bv, brow, j0, Tn, t);
    RowKeep keep[2];
    if (kDrop && live) {
#pragma unroll
      for (int half = 0; half < 2; ++half)
        keep[half] = row_keep(drop, site, b, r0 + lane / 4 + 8 * half, j0, Tn, lane);
    }
    sm90::wgmma_wait<0>();
    sm90::fence_acc(s);
    sm90::fence_acc(x);
    float tm[2] = {-FLT_MAX, -FLT_MAX};
    if (live) lane_scores(s, tm, bv, brow != nullptr, j0, Tn, d.inv_sqrt_dk, t);
    if (it < n_kt) {
      release(it);
      if (!live) continue;
      quad_max(tm);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float mn = fmaxf(m[half], tm[half]), corr = expf(m[half] - mn);
        m[half] = mn;
        l[half] *= corr;
        term[half] *= corr;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e4 = 0; e4 < 4; ++e4) {
          const int i = 4 * j + e4, half = e4 >> 1;
          const float e = expf(s[i] - m[half]);
          float gp = x[i];
          if (kDrop) gp *= keep[half].keeps(j, e4 & 1) ? drop.scale : 0.f;
          l[half] += e;
          term[half] += gp * e;
        }
      if (it == n_kt - 1) {  // the rows' sums and terms from the quad's shares
        finish_sums(l);
        finish_sums(term);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          rl[half] = __frcp_rn(l[half]);
          term[half] = div_rn(term[half], l[half], rl[half]);
        }
      }
    } else {
      unsigned a[4][4];
      if (live)
        grad_frags<kDrop>(a, s, x, m, l, rl, term, keep, drop.scale, d.inv_sqrt_dk);
      else
        zero_frags(a);
      pv_chunk(acc, a, ka, j0, Tn);  // gQ += gS . K: the first key tile starts the sum
      sm90::wgmma_wait<0>();
      sm90::fence_acc(acc);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fence_frag(a[kk]);
      release(it);
    }
  }
  // gQ through Q's box (every product has read it), then the statistics.
  stage_o(base + L::q, acc, warp, lane);
  sm90::fence_async_shared();
  __syncthreads();
  if (tid == 0) {
    sm90::tma_store_3d(&gqm, base + L::q, h * kDk, i0, b);
    sm90::bulk_commit();
  }
  if (live && t == 0) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + lane / 4 + 8 * half;
      if (r >= Tn) continue;
      float* row = stats + ((static_cast<size_t>(b) * d.H + h) * Tn + r) * 3;
      row[0] = m[half];
      row[1] = l[half];
      row[2] = term[half];
    }
  }
  if (tid == 0) sm90::bulk_wait();
}

// The key-tile kernel's shared memory from the 1024-aligned base: K_r, V_r,
// the ring's two Q and two g boxes, the pd and gS tiles (then the gK and
// gV staging tiles), the ring's two stages of statistics, the key biases,
// the barriers (K, V, ring stage 0, 1).
struct SplitDkvLayout {
  static constexpr int k = 0, v = kFwdBox, q = 2 * kFwdBox, g = 4 * kFwdBox;
  static constexpr int pd = 6 * kFwdBox, gs = 7 * kFwdBox, stats = 8 * kFwdBox;
  static constexpr int bias = stats + 2 * kStatBytes;
  static constexpr int bars = bias + kFwdTile * 4;
  static constexpr size_t bytes = bars + 4 * sizeof(uint64_t) + 1024;  // + alignment
};

// A block per (64-key tile, head, image), one warpgroup: the cluster
// design's block at one block a cluster, its three exchanges replaced by
// a read of the statistics the query-tile kernel wrote.  K_r and V_r load
// once; each query tile's Q, g and 64 rows of statistics come through a
// two-stage ring (one mbarrier a stage), refilled once the block's
// products and its threads have read the stage.  Per query tile: S and
// gPd on wgmma, p = exp(s - max) / sum, pd and gS rounded into the
// swizzled tiles, then gV += pd^T . g and gK += gS^T . Q (both tiles read
// MN-major as A).  A query row past T takes max +inf, sum 1 and term 0 in
// place of the scratch's bytes, so its p, pd and gS are 0.  gK and gV
// leave by TMA, clipped at T.
template <bool kDrop>
__global__ void __launch_bounds__(kBwdThreads, 2)
    mha_bwd_dkv_split_kernel(const __grid_constant__ CUtensorMap qm,
                             const __grid_constant__ CUtensorMap km,
                             const __grid_constant__ CUtensorMap vm,
                             const __grid_constant__ CUtensorMap gm,
                             const __grid_constant__ CUtensorMap gkm,
                             const __grid_constant__ CUtensorMap gvm,
                             const float* __restrict__ bias, const float* __restrict__ stats,
                             Dims d, Dropout drop) {
  typedef SplitDkvLayout L;
  extern __shared__ __align__(1024) unsigned char bwd_smem[];
  unsigned char* base = align1024(bwd_smem);
  unsigned char* Pt = base + L::pd;
  unsigned char* St = base + L::gs;
  float* Bs = reinterpret_cast<float*>(base + L::bias);
  uint64_t* bar = reinterpret_cast<uint64_t*>(base + L::bars);  // K, V, ring stage 0, 1
  const int Tn = d.T, j0 = blockIdx.x * kFwdTile, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, t = lane & 3;
  const int n_qt = (Tn + kFwdTile - 1) / kFwdTile;
  const unsigned site = d.site0 + h;
  const size_t plane = (static_cast<size_t>(b) * d.H + h) * Tn;  // the (image, head)'s first row
  const uint32_t ka = sm90::smem_u32(base + L::k), va = sm90::smem_u32(base + L::v);
  const uint32_t pa = sm90::smem_u32(Pt), sa = sm90::smem_u32(St);
  if (tid == 0) {
    for (int i = 0; i < 4; ++i) sm90::mbar_init(&bar[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int j = tid; j < kFwdTile; j += kBwdThreads)
    Bs[j] = bias != nullptr && j0 + j < Tn ? bias[static_cast<size_t>(b) * Tn + j0 + j] : 0.f;
  __syncthreads();
  // Query tile mt's statistics start (plane + 64 mt) * 3 floats into the
  // scratch (16-byte aligned): the copy starts that many floats mod 4
  // before them.
  auto stat_skip = [&](int mt) { return static_cast<int>(((plane + mt * kFwdTile) * 3) & 3); };
  auto load_tile = [&](int mt) {  // thread 0: query tile mt into ring stage mt & 1
    const int st = mt & 1;
    const float* src = stats + (plane + mt * kFwdTile) * 3 - stat_skip(mt);
    sm90::mbar_expect_tx(&bar[2 + st], 2 * kFwdBox + kStatBytes);
    sm90::tma_load_3d(base + L::q + st * kFwdBox, &qm, &bar[2 + st], h * kDk, mt * kFwdTile, b);
    sm90::tma_load_3d(base + L::g + st * kFwdBox, &gm, &bar[2 + st], h * kDk, mt * kFwdTile, b);
    sm90::bulk_load(base + L::stats + st * kStatBytes, src, kStatBytes, &bar[2 + st]);
  };
  if (tid == 0) {
    sm90::mbar_expect_tx(&bar[0], kFwdBox);
    sm90::tma_load_3d(base + L::k, &km, &bar[0], h * kDk, j0, b);
    sm90::mbar_expect_tx(&bar[1], kFwdBox);
    sm90::tma_load_3d(base + L::v, &vm, &bar[1], h * kDk, j0, b);
    for (int mt = 0; mt < 2 && mt < n_qt; ++mt) load_tile(mt);
  }
  const float* bias_s = bias != nullptr ? Bs : nullptr;
  float gk[32], gv[32];
#pragma unroll 1
  for (int mt = 0; mt < n_qt; ++mt) {
    const int st = mt & 1;
    const uint32_t qa = sm90::smem_u32(base + L::q + st * kFwdBox);
    const uint32_t ga = sm90::smem_u32(base + L::g + st * kFwdBox);
    sm90::mbar_wait(&bar[2 + st], (mt >> 1) & 1);
    if (mt == 0) {
      sm90::mbar_wait(&bar[0], 0);
      sm90::mbar_wait(&bar[1], 0);
    }
    // S = Q . K_r^T and gPd = g . V_r^T, a commit group each.
    float s[32], x[32];
    sm90::fence_acc(s);
    sm90::fence_acc(x);
    sm90::wgmma_fence();
    qk_chunk(s, qa, ka);
    sm90::wgmma_commit();
    qk_chunk(x, ga, va);
    sm90::wgmma_commit();
    const int r0 = mt * kFwdTile + 16 * warp;  // the warp's first query row
    const bool live = r0 < Tn;  // a warp whose 16 rows lie past T feeds zeros to the products
    // This thread's rows' (max, sum, term), and 1 / sum rounded.
    const float* sv =
        reinterpret_cast<const float*>(base + L::stats + st * kStatBytes) + stat_skip(mt);
    float m[2], l[2], rl[2], term[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = 16 * warp + lane / 4 + 8 * half;
      const bool in = mt * kFwdTile + row < Tn;
      m[half] = in ? sv[3 * row] : INFINITY;
      l[half] = in ? sv[3 * row + 1] : 1.f;
      term[half] = in ? sv[3 * row + 2] : 0.f;
      rl[half] = __frcp_rn(l[half]);
    }
    RowKeep keep[2];
    if (kDrop && live) {
#pragma unroll
      for (int half = 0; half < 2; ++half)
        keep[half] = row_keep(drop, site, b, r0 + lane / 4 + 8 * half, j0, Tn, lane);
    }
    sm90::wgmma_wait<0>();
    sm90::fence_acc(s);
    sm90::fence_acc(x);
    // pd = T(p), dropped in train mode, and gS = T(p (gP - term) / sqrt(dk))
    // into their tiles; 0 past T and in warps past T.
    if (live) {
      float unused[2] = {-FLT_MAX, -FLT_MAX};
      block_scores(s, unused, bias_s, j0, Tn, d.inv_sqrt_dk, t);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float pd[2] = {0.f, 0.f}, gs[2] = {0.f, 0.f};
        if (live) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * half + e;
            const float p = div_rn(expf(s[i] - m[half]), l[half], rl[half]);
            float gp = x[i];
            pd[e] = round_to<bf16>(p);
            if (kDrop) {
              const bool kept = keep[half].keeps(j, e);
              pd[e] = kept ? round_to<bf16>(pd[e] * drop.scale) : 0.f;
              gp *= kept ? drop.scale : 0.f;
            }
            gs[e] = round_to<bf16>(__fmul_rn(__fmul_rn(p, __fsub_rn(gp, term[half])),
                                             d.inv_sqrt_dk));
          }
        }
        const int r = 16 * warp + lane / 4 + 8 * half;
        put_pair(Pt, r, j, t, pd[0], pd[1]);
        put_pair(St, r, j, t, gs[0], gs[1]);
      }
    sm90::fence_async_shared();
    __syncthreads();  // both tiles written
    // gV += pd^T . g and gK += gS^T . Q over the tile's query rows (k16
    // steps past T skipped; the first tile's first step starts the sums).
    sm90::fence_acc(gk);
    sm90::fence_acc(gv);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (mt * kFwdTile + 16 * kk >= Tn) break;
      const int acc = mt > 0 || kk > 0;
      wgmma_ss<1, 1>(gv, sm90::desc_w(pa + kk * 2048), sm90::desc_w(ga + kk * 2048), acc);
      wgmma_ss<1, 1>(gk, sm90::desc_w(sa + kk * 2048), sm90::desc_w(qa + kk * 2048), acc);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_acc(gk);
    sm90::fence_acc(gv);
    // The statistics were read by generic loads, which the refill (the
    // async proxy) must follow.
    sm90::fence_async_shared();
    __syncthreads();  // every warp's products have read ring stage st and the tiles
    if (tid == 0 && mt + 2 < n_qt) load_tile(mt + 2);
  }
  // gK and gV of the block's keys through the (free) pd and gS tiles.
  stage_o(Pt, gk, warp, lane);
  stage_o(St, gv, warp, lane);
  sm90::fence_async_shared();
  __syncthreads();
  if (tid == 0) {
    sm90::tma_store_3d(&gkm, Pt, h * kDk, j0, b);
    sm90::tma_store_3d(&gvm, St, h * kDk, j0, b);
    sm90::bulk_commit();
    sm90::bulk_wait();
  }
}

// The two launches of the split design: grid (T / 64 rounded up, H, B)
// each.  q, k, v, g, gq, gk and gv start on 16-byte boundaries (TMA), which
// the wrapper checks; stats is a 16-byte aligned (B, H, T, 3) fp32 scratch
// followed by kStatTail floats.
cudaError_t launch_split(const void* q, const void* k, const void* v, const void* bias,
                         const void* g, void* gq, void* gk, void* gv, float* stats, int B,
                         const Dims& d, const Dropout& drop, cudaStream_t stream) {
  if (reinterpret_cast<uintptr_t>(stats) % 16 != 0) return cudaErrorInvalidValue;
  CUtensorMap maps[7];
  const void* ptrs[7] = {q, k, v, g, gq, gk, gv};
  for (int i = 0; i < 7; ++i) {
    const cudaError_t err = sm90::encode_planes(&maps[i], ptrs[i], d.D, d.T, B);
    if (err != cudaSuccess) return err;
  }
  const float* bs = static_cast<const float*>(bias);
  const dim3 grid((d.T + kFwdTile - 1) / kFwdTile, d.H, B);
  const auto dq = drop.on ? mha_bwd_dq_split_kernel<true> : mha_bwd_dq_split_kernel<false>;
  cudaError_t err = allow_smem(dq, SplitDqLayout::bytes);
  if (err != cudaSuccess) return err;
  dq<<<grid, kBwdThreads, SplitDqLayout::bytes, stream>>>(maps[0], maps[1], maps[2], maps[3],
                                                          maps[4], bs, stats, d, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const auto dkv = drop.on ? mha_bwd_dkv_split_kernel<true> : mha_bwd_dkv_split_kernel<false>;
  err = allow_smem(dkv, SplitDkvLayout::bytes);
  if (err != cudaSuccess) return err;
  dkv<<<grid, kBwdThreads, SplitDkvLayout::bytes, stream>>>(maps[0], maps[1], maps[2], maps[3],
                                                            maps[5], maps[6], bs, stats, d, drop);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------
// fp32: the query-tile and key-tile pair in three TF32 passes (see the
// top; mha.cuh has the arithmetic)
// ---------------------------------------------------------------------

// Both fp32 kernels are blocks of two warpgroups.
constexpr int kBwdF32Threads = 2 * kF32Threads;

// The query-tile kernel: 128 query rows a block, sharing each key tile.
// Shared memory from the 1024-aligned base: each warpgroup's Q and g (hi,
// lo), the key tile's K and V (hi over the raw TMA tile, lo), K^T (hi,
// lo), the key biases, the barriers (Q and g, K, V).

struct F32DqLayout {
  static constexpr int q = 0, g = 4 * kF32Tile;  // warpgroup w's hi, lo: + 2 w tiles
  static constexpr int kh = 8 * kF32Tile, kl = 9 * kF32Tile, vh = 10 * kF32Tile, vl = 11 * kF32Tile;
  static constexpr int kth = 12 * kF32Tile, ktl = 13 * kF32Tile, bias = 14 * kF32Tile;
  static constexpr int bars = bias + kFwdTile * 4;
  static constexpr size_t bytes = bars + 3 * sizeof(uint64_t) + 1024;  // + alignment
};

// A block per (128-row query tile, head, image), warpgroup w on rows 64 w
// .. 64 w + 63.  Item it of its walk is key tile it % n_kt of pass it /
// n_kt, the tile split once for both warpgroups: pass 0 takes S = Q . K^T
// and gPd = g . V^T for the rows' running max, sum and row term (both sums
// rescaled by exp(old max - new max) as the max grows); pass 1 takes them
// again, p = exp(s - max) / sum, gS = p (gP - term) / sqrt(dk), and gQ +=
// gS . K (gS from registers, K^T transposed by the block's threads while S
// and gPd run).  Writes gQ and each row's (max, sum, term) to stats.  A
// warpgroup whose 64 rows lie past T issues no products.
template <bool kDrop>
__global__ void __launch_bounds__(kBwdF32Threads, 1)
    mha_bwd_dq_tf32_kernel(const __grid_constant__ CUtensorMap qm,
                           const __grid_constant__ CUtensorMap km,
                           const __grid_constant__ CUtensorMap vm,
                           const __grid_constant__ CUtensorMap gm,
                           const float* __restrict__ bias, float* __restrict__ gq,
                           float* __restrict__ stats, Dims d, Dropout drop) {
  typedef F32DqLayout L;
  extern __shared__ __align__(1024) unsigned char f32_smem[];
  unsigned char* base = align1024(f32_smem);
  float* Bs = reinterpret_cast<float*>(base + L::bias);
  uint64_t* bar = reinterpret_cast<uint64_t*>(base + L::bars);  // Q and g, K, V
  const int Tn = d.T, h = blockIdx.y, b = blockIdx.z, c0 = h * kDk;
  const int tid = threadIdx.x, wg = tid / kF32Threads, warp = (tid / 32) & 3, lane = tid % 32;
  const int t = lane & 3, i0 = blockIdx.x * 2 * kFwdTile + wg * kFwdTile;  // the warpgroup's rows
  const bool live = i0 < Tn;
  const int n_kt = (Tn + kFwdTile - 1) / kFwdTile, items = 2 * n_kt;
  const unsigned site = d.site0 + h;
  unsigned char* Qw = base + L::q + 2 * wg * kF32Tile;
  unsigned char* Gw = base + L::g + 2 * wg * kF32Tile;
  const uint32_t qh = sm90::smem_u32(Qw), ql = qh + kF32Tile;
  const uint32_t gh = sm90::smem_u32(Gw), gl = gh + kF32Tile;
  const uint32_t kh = sm90::smem_u32(base + L::kh), kl = sm90::smem_u32(base + L::kl);
  const uint32_t vh = sm90::smem_u32(base + L::vh), vl = sm90::smem_u32(base + L::vl);
  const uint32_t kth = sm90::smem_u32(base + L::kth), ktl = sm90::smem_u32(base + L::ktl);
  auto load_keys = [&](int kt) {  // thread 0: key tile kt's K and V
    sm90::mbar_expect_tx(&bar[1], kF32Tile);
    load_f32_tile(base + L::kh, &km, &bar[1], c0, kt * kFwdTile, b);
    sm90::mbar_expect_tx(&bar[2], kF32Tile);
    load_f32_tile(base + L::vh, &vm, &bar[2], c0, kt * kFwdTile, b);
  };
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) sm90::mbar_init(&bar[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    sm90::mbar_expect_tx(&bar[0], 4 * kF32Tile);
    for (int w = 0; w < 2; ++w) {
      const int row = blockIdx.x * 2 * kFwdTile + w * kFwdTile;
      load_f32_tile(base + L::q + 2 * w * kF32Tile, &qm, &bar[0], c0, row, b);
      load_f32_tile(base + L::g + 2 * w * kF32Tile, &gm, &bar[0], c0, row, b);
    }
    load_keys(0);
  }
  __syncthreads();
  sm90::mbar_wait(&bar[0], 0);
  split_tile(Qw, Qw, Qw + kF32Tile);
  split_tile(Gw, Gw, Gw + kF32Tile);
  const float* brow = bias != nullptr ? bias + static_cast<size_t>(b) * Tn : nullptr;
  const int r0 = i0 + 16 * warp + lane / 4;  // this thread's rows r0 and r0 + 8
  RowKeep keep[2];
  float m[2] = {-FLT_MAX, -FLT_MAX}, l[2] = {0.f, 0.f}, term[2] = {0.f, 0.f}, rl[2] = {1.f, 1.f};
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
#pragma unroll 1
  for (int it = 0; it < items; ++it) {
    const int kt = it % n_kt, j0 = kt * kFwdTile;
    const bool grads = it >= n_kt;
    const unsigned par = it & 1;
    if (brow != nullptr && tid < kFwdTile) Bs[tid] = j0 + tid < Tn ? brow[j0 + tid] : 0.f;
    sm90::mbar_wait(&bar[1], par);
    sm90::mbar_wait(&bar[2], par);
    split_tile<kBwdF32Threads>(base + L::kh, base + L::kh, base + L::kl);
    split_tile<kBwdF32Threads>(base + L::vh, base + L::vh, base + L::vl);
    sm90::fence_async_shared();
    __syncthreads();  // K and V (and Q and g) split, the biases staged
    float s[32], x[32];
    if (live) {
      sm90::fence_acc(s);
      sm90::fence_acc(x);
      sm90::wgmma_fence();
      mma3_ss(s, qh, ql, kh, kl, 0);
      mma3_ss(x, gh, gl, vh, vl, 0);
      sm90::wgmma_commit();
    }
    if (grads)
      transpose_pair<kBwdF32Threads>(base + L::kth, base + L::ktl, base + L::kh, base + L::kl);
    if (kDrop && live) {
#pragma unroll
      for (int half = 0; half < 2; ++half)
        keep[half] = row_keep(drop, site, b, r0 + 8 * half, j0, Tn, lane);
    }
    if (live) {
      sm90::wgmma_wait<0>();
      sm90::fence_acc(s);
      sm90::fence_acc(x);
    }
    sm90::fence_async_shared();
    __syncthreads();  // every warpgroup's products have read K and V; K^T written
    if (tid == 0 && it + 1 < items) load_keys((it + 1) % n_kt);
    if (live) {
      float tm[2] = {-FLT_MAX, -FLT_MAX};
      block_scores(s, tm, brow != nullptr ? Bs : nullptr, j0, Tn, d.inv_sqrt_dk, t);
      if (!grads) {
        quad_max(tm);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float mn = fmaxf(m[half], tm[half]), corr = expf(m[half] - mn);
          m[half] = mn;
          l[half] *= corr;
          term[half] *= corr;
        }
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e4 = 0; e4 < 4; ++e4) {
            const int i = 4 * j + e4, half = e4 >> 1;
            const float e = expf(s[i] - m[half]);
            float gp = x[i];
            if (kDrop) gp *= keep[half].keeps(j, e4 & 1) ? drop.scale : 0.f;
            l[half] += e;
            term[half] += gp * e;
          }
        if (it == n_kt - 1) {  // the rows' sums and terms from the quad's shares
          finish_sums(l);
          finish_sums(term);
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            rl[half] = __frcp_rn(l[half]);
            term[half] = div_rn(term[half], l[half], rl[half]);
          }
        }
      } else {
        // gS into S's registers, then gQ += gS . K.
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e4 = 0; e4 < 4; ++e4) {
            const int i = 4 * j + e4, half = e4 >> 1;
            const float p = div_rn(expf(s[i] - m[half]), l[half], rl[half]);
            float gp = x[i];
            if (kDrop) gp *= keep[half].keeps(j, e4 & 1) ? drop.scale : 0.f;
            s[i] = __fmul_rn(__fmul_rn(p, __fsub_rn(gp, term[half])), d.inv_sqrt_dk);
          }
        Frags f;
        make_frags(f, s);
        sm90::fence_acc(acc);
        sm90::wgmma_fence();
        mma3_rs(acc, f, kth, ktl, live_steps(j0, Tn));
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_acc(acc);
        fence_frags(f);
      }
    }
    __syncthreads();  // K^T and the biases read before the next item writes them
  }
  if (!live) return;
  const float one[2] = {1.f, 1.f};
  store_f32(gq + (static_cast<size_t>(b) * Tn + i0) * d.D + c0, acc, one, i0, Tn, d.D, warp,
            lane);
  if (t == 0) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + 8 * half;
      if (r >= Tn) continue;
      float* st = stats + ((static_cast<size_t>(b) * d.H + h) * Tn + r) * 3;
      st[0] = m[half];
      st[1] = l[half];
      st[2] = term[half];
    }
  }
}

// The key-tile kernel: 128 keys a block, sharing each query tile.  Shared
// memory from the 1024-aligned base: each warpgroup's K and V (hi, lo;
// resident), the TMA stages of the query tile's Q and g, its Q and g split
// (hi, lo), which become Q^T and g^T once S^T and gPd^T have read them,
// the tile's statistics (max, sum, 1 / sum, term a row), the block's key
// biases, the barriers (K and V, Q and g).

struct F32DkvLayout {
  static constexpr int k = 0, v = 4 * kF32Tile;  // warpgroup w's hi, lo: + 2 w tiles
  static constexpr int qraw = 8 * kF32Tile, graw = 9 * kF32Tile;
  static constexpr int qh = 10 * kF32Tile, ql = 11 * kF32Tile, gh = 12 * kF32Tile,
                       gl = 13 * kF32Tile;
  static constexpr int st = 14 * kF32Tile, bias = st + kFwdTile * 16;
  static constexpr int bars = bias + 2 * kFwdTile * 4;
  static constexpr size_t bytes = bars + 2 * sizeof(uint64_t) + 1024;  // + alignment
};

// In place: the split tile pair (hi, lo) at t becomes its transposed copy
// (the block's threads each hold their chunks in registers across a block
// barrier).
__device__ __forceinline__ void transpose_in_place(unsigned char* t) {
  float v[4][4], w[4][4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    gather_chunk<kBwdF32Threads>(v[k], t, k);
    gather_chunk<kBwdF32Threads>(w[k], t + kF32Tile, k);
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    scatter_chunk<kBwdF32Threads>(t, v[k], k);
    scatter_chunk<kBwdF32Threads>(t + kF32Tile, w[k], k);
  }
}

// A block per (128-key tile, head, image), warpgroup w on keys 64 w .. 64
// w + 63, walking the query tiles in order: S^T = K . Q^T and gPd^T = V .
// g^T (the warpgroup's keys as the 64 rows, so K and V are A operands split
// once), p from the rows' statistics, pd = p keep and gS as in the
// query-tile kernel, then gV += pd^T . g and gK += gS^T . Q, pd^T and gS^T
// from registers, Q^T and g^T transposed in place by the block's threads.
// The next tile's Q and g load while a tile is worked on.  The dropout
// element stays query * T + key.  A warpgroup whose keys lie past T issues
// no products.
template <bool kDrop>
__global__ void __launch_bounds__(kBwdF32Threads, 1)
    mha_bwd_dkv_tf32_kernel(const __grid_constant__ CUtensorMap qm,
                            const __grid_constant__ CUtensorMap km,
                            const __grid_constant__ CUtensorMap vm,
                            const __grid_constant__ CUtensorMap gm,
                            const float* __restrict__ bias, const float* __restrict__ stats,
                            float* __restrict__ gk, float* __restrict__ gv, Dims d,
                            Dropout drop) {
  typedef F32DkvLayout L;
  extern __shared__ __align__(1024) unsigned char f32_smem[];
  unsigned char* base = align1024(f32_smem);
  float* St = reinterpret_cast<float*>(base + L::st);
  float* Bs = reinterpret_cast<float*>(base + L::bias);
  uint64_t* bar = reinterpret_cast<uint64_t*>(base + L::bars);  // K and V, Q and g
  const int Tn = d.T, h = blockIdx.y, b = blockIdx.z, c0 = h * kDk;
  const int tid = threadIdx.x, wg = tid / kF32Threads, warp = (tid / 32) & 3, lane = tid % 32;
  const int t = lane & 3, j0 = blockIdx.x * 2 * kFwdTile + wg * kFwdTile;  // the warpgroup's keys
  const bool live = j0 < Tn;
  const int n_qt = (Tn + kFwdTile - 1) / kFwdTile;
  const unsigned site = d.site0 + h;
  unsigned char* Kw = base + L::k + 2 * wg * kF32Tile;
  unsigned char* Vw = base + L::v + 2 * wg * kF32Tile;
  const uint32_t kh = sm90::smem_u32(Kw), kl = kh + kF32Tile;
  const uint32_t vh = sm90::smem_u32(Vw), vl = vh + kF32Tile;
  const uint32_t qh = sm90::smem_u32(base + L::qh), ql = sm90::smem_u32(base + L::ql);
  const uint32_t gh = sm90::smem_u32(base + L::gh), gl = sm90::smem_u32(base + L::gl);
  auto load_queries = [&](int qt) {  // thread 0: query tile qt's Q and g
    sm90::mbar_expect_tx(&bar[1], 2 * kF32Tile);
    load_f32_tile(base + L::qraw, &qm, &bar[1], c0, qt * kFwdTile, b);
    load_f32_tile(base + L::graw, &gm, &bar[1], c0, qt * kFwdTile, b);
  };
  if (tid == 0) {
    for (int i = 0; i < 2; ++i) sm90::mbar_init(&bar[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    sm90::mbar_expect_tx(&bar[0], 4 * kF32Tile);
    for (int w = 0; w < 2; ++w) {
      const int row = blockIdx.x * 2 * kFwdTile + w * kFwdTile;
      load_f32_tile(base + L::k + 2 * w * kF32Tile, &km, &bar[0], c0, row, b);
      load_f32_tile(base + L::v + 2 * w * kF32Tile, &vm, &bar[0], c0, row, b);
    }
    load_queries(0);
  }
  if (tid < 2 * kFwdTile) {
    const int key = blockIdx.x * 2 * kFwdTile + tid;
    Bs[tid] = bias != nullptr && key < Tn ? bias[static_cast<size_t>(b) * Tn + key] : 0.f;
  }
  __syncthreads();
  sm90::mbar_wait(&bar[0], 0);
  split_tile(Kw, Kw, Kw + kF32Tile);
  split_tile(Vw, Vw, Vw + kF32Tile);
  const int kr = 16 * warp + lane / 4;  // this thread's keys j0 + kr and j0 + kr + 8
  const float kb[2] = {Bs[wg * kFwdTile + kr], Bs[wg * kFwdTile + kr + 8]};
  const float* st_h = stats + (static_cast<size_t>(b) * d.H + h) * Tn * 3;
  float ak[32], av[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) ak[i] = av[i] = 0.f;
#pragma unroll 1
  for (int qt = 0; qt < n_qt; ++qt) {
    const int i0 = qt * kFwdTile;
    if (tid < kFwdTile) {  // rows past T: finite values, their p is 0
      const int i = i0 + tid;
      float4 val = make_float4(0.f, 1.f, 1.f, 0.f);
      if (i < Tn) {
        const float* src = st_h + static_cast<size_t>(i) * 3;
        val = make_float4(src[0], src[1], __frcp_rn(src[1]), src[2]);
      }
      reinterpret_cast<float4*>(St)[tid] = val;
    }
    sm90::mbar_wait(&bar[1], qt & 1);
    split_tile<kBwdF32Threads>(base + L::qraw, base + L::qh, base + L::ql);
    split_tile<kBwdF32Threads>(base + L::graw, base + L::gh, base + L::gl);
    sm90::fence_async_shared();
    __syncthreads();  // Q and g (and K and V) split, their stages read, the statistics staged
    if (tid == 0 && qt + 1 < n_qt) load_queries(qt + 1);
    float s[32], x[32];
    if (live) {
      sm90::fence_acc(s);
      sm90::fence_acc(x);
      sm90::wgmma_fence();
      mma3_ss(s, kh, kl, qh, ql, 0);
      mma3_ss(x, vh, vl, gh, gl, 0);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_acc(s);
      sm90::fence_acc(x);
    }
    __syncthreads();  // every warpgroup's products have read Q and g
    transpose_in_place(base + L::qh);
    transpose_in_place(base + L::gh);
    sm90::fence_async_shared();
    if (live) {
      // pd^T into S^T's registers, gS^T into gPd^T's: element 4 j + e4 is
      // key j0 + kr + 8 (e4 / 2), query i0 + 8 j + 2t + e4 % 2.
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e4 = 0; e4 < 4; ++e4) {
          const int i = 4 * j + e4, half = e4 >> 1, c = 8 * j + 2 * t + (e4 & 1);
          const int key = j0 + kr + 8 * half, query = i0 + c;
          const float4 sc = reinterpret_cast<const float4*>(St)[c];  // max, sum, 1 / sum, term
          float val = __fmul_rn(s[i], d.inv_sqrt_dk);
          if (bias != nullptr) val = __fadd_rn(val, kb[half]);
          const float p = key < Tn && query < Tn ? div_rn(expf(val - sc.x), sc.y, sc.z) : 0.f;
          float gp = x[i], pd = p;
          if (kDrop && p != 0.f) {
            const float keep = drop.keep(site, b, static_cast<unsigned>(query) * Tn + key);
            pd = p * keep;
            gp *= keep;
          }
          s[i] = pd;
          x[i] = __fmul_rn(__fmul_rn(p, __fsub_rn(gp, sc.w)), d.inv_sqrt_dk);
        }
    }
    __syncthreads();  // Q^T and g^T written
    if (live) {
      Frags f;
      make_frags(f, s);
      sm90::fence_acc(av);
      sm90::wgmma_fence();
      mma3_rs(av, f, gh, gl, live_steps(i0, Tn));
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_acc(av);
      fence_frags(f);
      make_frags(f, x);
      sm90::fence_acc(ak);
      sm90::wgmma_fence();
      mma3_rs(ak, f, qh, ql, live_steps(i0, Tn));
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_acc(ak);
      fence_frags(f);
    }
    __syncthreads();  // every warpgroup's products have read Q^T and g^T, the statistics used
  }
  if (!live) return;
  const float one[2] = {1.f, 1.f};
  const size_t o = (static_cast<size_t>(b) * Tn + j0) * d.D + c0;
  store_f32(gk + o, ak, one, j0, Tn, d.D, warp, lane);
  store_f32(gv + o, av, one, j0, Tn, d.D, warp, lane);
}

// The two launches of the fp32 design; q, k, v and g start on 16-byte
// boundaries (TMA), which the wrapper checks.
template <bool kDrop>
cudaError_t launch_tf32(const void* q, const void* k, const void* v, const void* bias,
                        const void* g, void* gq, void* gk, void* gv, float* stats, int B,
                        const Dims& d, const Dropout& drop, cudaStream_t stream) {
  CUtensorMap maps[4];
  const void* ptrs[4] = {q, k, v, g};
  for (int i = 0; i < 4; ++i) {
    const cudaError_t err = sm90::encode_planes_f32(&maps[i], ptrs[i], d.D, d.T, B);
    if (err != cudaSuccess) return err;
  }
  const float* bs = static_cast<const float*>(bias);
  const dim3 grid((d.T + 2 * kFwdTile - 1) / (2 * kFwdTile), d.H, B);  // 128 rows or keys
  cudaError_t err = allow_smem(mha_bwd_dq_tf32_kernel<kDrop>, F32DqLayout::bytes);
  if (err != cudaSuccess) return err;
  mha_bwd_dq_tf32_kernel<kDrop><<<grid, kBwdF32Threads, F32DqLayout::bytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], bs, static_cast<float*>(gq), stats, d, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = allow_smem(mha_bwd_dkv_tf32_kernel<kDrop>, F32DkvLayout::bytes);
  if (err != cudaSuccess) return err;
  mha_bwd_dkv_tf32_kernel<kDrop><<<grid, kBwdF32Threads, F32DkvLayout::bytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], bs, stats, static_cast<float*>(gk),
      static_cast<float*>(gv), d, drop);
  return cudaGetLastError();
}

}  // namespace
}  // namespace iisan

// The design iisan_mha_bwd runs at T keys: 0 the fp32 pair in three TF32
// passes, 1 the bf16 cluster (up to kClusterMaxKeys keys), 2 the bf16
// split (beyond).
// The wrapper asks here which buffers and alignment a call needs.
extern "C" int iisan_mha_bwd_design(int T, int is_bf16) {
  return !is_bf16 ? 0 : T <= iisan::kClusterMaxKeys ? 1 : 2;
}

// Floats the scratch of the bf16 split design holds past its (B, H, T, 3)
// rows.
extern "C" int iisan_mha_bwd_stats_tail() { return iisan::kStatTail; }

// How many clusters of the cluster design's instance for nc key blocks
// (eval, or train when `train`) the current card can hold at once
// (cudaOccupancyMaxActiveClusters), into *clusters; 0 means the instance
// cannot be launched there.  Returns the CUDA error (0 on success).
extern "C" int iisan_mha_bwd_active_clusters(int nc, int train, int* clusters) {
  if (nc < 1 || nc > iisan::kMaxCluster || clusters == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  iisan::ClusterKernel kernel;
  cudaError_t err = iisan::cluster_config(cfg, attr, nc, train != 0, 1, 1, nullptr, &kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(clusters, reinterpret_cast<const void*>(kernel), &cfg);
  return static_cast<int>(err);
}

// q, k, v, g, gq, gk, gv (B, T, D) T; bias (B, T) fp32 or null; the dropout
// arguments are the forward's.  T is bf16 when is_bf16 (the cluster
// design or the split design, which read q, k, v and g and write gq, gk
// and gv by TMA: 16-byte boundaries), else fp32 (the TF32 pair, whose q,
// k, v and g start on 16-byte boundaries).  stats: an fp32 (B, H, T, 3)
// scratch for each query row's (max, sum, row term), for the two-kernel
// designs (the split design's on a 16-byte boundary and followed by
// iisan_mha_bwd_stats_tail() floats, which its copies may read); the
// cluster design takes null.  Returns the CUDA error of the launches (0 on
// success).
extern "C" int iisan_mha_bwd(const void* q, const void* k, const void* v, const void* bias,
                             const void* g, void* gq, void* gk, void* gv, void* stats, int B,
                             int T, int D, int H, int is_bf16, int seed, float rate, float scale,
                             int layer, void* stream) {
  const bool cluster = iisan_mha_bwd_design(T, is_bf16) == 1;
  if (!iisan::mha::supported(B, T, D, H) || (!cluster && stats == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const iisan::mha::Dims d{T, D, H,
                           static_cast<float>(1.0 / sqrt(static_cast<double>(iisan::mha::kDk))),
                           static_cast<unsigned>(layer * H)};
  const iisan::Dropout drop = iisan::make_dropout(seed, rate, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* st = static_cast<float*>(stats);
  const auto tf32 = drop.on ? iisan::launch_tf32<true> : iisan::launch_tf32<false>;
  const cudaError_t err =
      !is_bf16  ? tf32(q, k, v, bias, g, gq, gk, gv, st, B, d, drop, s)
      : cluster ? iisan::launch_cluster(q, k, v, bias, g, gq, gk, gv, B, d, drop, s)
                : iisan::launch_split(q, k, v, bias, g, gq, gk, gv, st, B, d, drop, s);
  return static_cast<int>(err);
}
