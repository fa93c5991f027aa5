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
//   tokens (one block) run faster than on the mma.sync pair this design
//   replaced, so no dispatch by T keeps that pair below 512 keys.
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
// T > 512 (streamed, up to 46,340 keys): two kernels on mma.sync m16n8k16
// with cp.async staging, joined by an fp32 (B, H, T, 3) scratch of each
// query row's (max, sum, row term).  This range is the port's own: the TPU
// kernel does not run past 512 keys at ViT width (the JAX towers take the
// XLA path there).
// - dq: a block per (64-row query tile, head, image), a warp a 16-row
//   m-tile with its Q and g rows as A fragments, three passes over 64-key
//   tiles of K and V (two buffers): the rows' max and sum; S again and gP
//   = g . V^T, the keep factors, the row term summed across the quad; S
//   and gP again and gS, taken as the A fragment of gS . K.  It writes gQ
//   and the statistics.
// - dkv: a block per (64-key tile, head, image), a warp per 16 keys with
//   their K and V rows as A fragments.  It walks the query tiles in order
//   (Q, g and the statistics staged by cp.async, two buffers), 16 queries
//   at a time: S^T = K . Q^T, p from the statistics, pd, gP^T = (V . g^T) *
//   keep and gS, then gV += pd^T . g and gK += gS^T . Q; the sums stay in
//   registers.  The dropout element stays query * T + key.
// That split computes ten products where the function has five; it is
// kept past 512 keys, beyond the portable cluster size of 8 blocks.
//
// fp32 (tests, the fp32 compute dtype): the same split on the CUDA cores
// (mha.cuh's rows kernels), 32-row query tiles against 32-key tiles; no
// TF32, which keeps about three digits.

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

// The block's S tile in place: fp32(q . k) * scale [+ the key bias], -inf
// at keys past T, and this lane's share of the rows' (g, g + 8) max.  Every
// element takes the same instructions (a key past T is selected away, not
// branched around), so the 32 values of a thread stay independent work;
// every step below reads -inf past T as exp 0, p 0, pd 0 and gS 0.
__device__ __forceinline__ void block_scores(float (&s)[32], float (&m)[2], const float* bias,
                                             int j0, int Tn, float scale, int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = j0 + 8 * j + 2 * t + e;
      const float bv = bias != nullptr ? bias[col - j0] : 0.f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float v = __fmul_rn(s[4 * j + 2 * half + e], scale);
        if (bias != nullptr) v = __fadd_rn(v, bv);
        v = col < Tn ? v : -INFINITY;
        s[4 * j + 2 * half + e] = v;
        m[half] = fmaxf(m[half], v);
      }
    }
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
// bf16, T > kClusterMaxKeys: the streamed split on mma.sync (see the top)
// ---------------------------------------------------------------------

// One m-tile of the query side: 16 query rows (the first is i0) with their
// Q and g rows as A fragments, the rows' statistics and their gQ sums.
// kDrop: train mode (eval builds carry no Philox code).
template <bool kDrop>
struct DqTile {
  unsigned qf[kDk / 16][4], gf[kDk / 16][4];
  float m[2], l[2], term[2], acc[kDk / 8][4];
  int i0;

  __device__ void reset(int first_row) {
    i0 = first_row;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      m[half] = -FLT_MAX;
      l[half] = 0.f;
      term[half] = 0.f;
    }
  }

  // Pass 1, one 64-key tile: the rows' running max and sum.
  __device__ void stats_tile(const bf16* ks, const float* bias_t, int j0, const Dims& d,
                             int lane) {
    stats_pass_tile(m, l, qf, ks, bias_t, j0, d, lane);
  }

  __device__ void finish_stats() { finish_sums(l); }

  // 16 keys (K and V rows at ks / vs, the first is key j0): p (fp32) and
  // gP = (g . v^T) * keep, both 0 past T.
  __device__ void probs_grads(float (&p)[2][4], float (&gp)[2][4], const bf16* ks, const bf16* vs,
                              const float* bias_c, int j0, const Dims& d, const Dropout& drop,
                              unsigned site, unsigned b, int lane) const {
    const int g = lane / 4, t = lane % 4;
    score_tile(p, qf, ks, bias_c, j0, d.T, d.inv_sqrt_dk, lane);
    dot_rows(gp, gf, vs, lane);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + nt * 8 + 2 * t + (e & 1);
        const unsigned i = i0 + g + 8 * (e >> 1);
        if (j < d.T) {
          p[nt][e] = __fdiv_rn(expf(p[nt][e] - m[e >> 1]), l[e >> 1]);
          if (kDrop) gp[nt][e] *= drop.keep(site, b, i * d.T + j);
        } else {
          p[nt][e] = 0.f;
          gp[nt][e] = 0.f;
        }
      }
  }

  // Pass 2, one 64-key tile: this lane's share of the rows' sum_j gP p.
  __device__ void term_tile(const bf16* ks, const bf16* vs, const float* bias_t, int j0,
                            const Dims& d, const Dropout& drop, unsigned site, unsigned b,
                            int lane) {
#pragma unroll
    for (int c = 0; c < kKeyTile / 16; ++c) {
      if (j0 + c * 16 >= d.T) break;  // chunks wholly past T add nothing
      float p[2][4], gp[2][4];
      probs_grads(p, gp, ks + c * 16 * kStr, vs + c * 16 * kStr,
                  bias_t != nullptr ? bias_t + c * 16 : nullptr, j0 + c * 16, d, drop, site, b,
                  lane);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) term[e >> 1] += gp[nt][e] * p[nt][e];
    }
  }

  // The rows' terms from the quad's shares; clears the gQ sums.
  __device__ void finish_term() {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      term[half] += __shfl_xor_sync(0xffffffffu, term[half], 1);
      term[half] += __shfl_xor_sync(0xffffffffu, term[half], 2);
    }
#pragma unroll
    for (int nt = 0; nt < kDk / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  }

  // Pass 3, one 64-key tile: gS = T(p (gP - term) / sqrt(dk)), then gQ +=
  // gS . K with gS's C fragments as the A fragments.
  __device__ void grad_tile(const bf16* ks, const bf16* vs, const float* bias_t, int j0,
                            const Dims& d, const Dropout& drop, unsigned site, unsigned b,
                            int lane) {
#pragma unroll
    for (int c = 0; c < kKeyTile / 16; ++c) {
      if (j0 + c * 16 >= d.T) break;  // chunks wholly past T add nothing
      float p[2][4], gp[2][4];
      probs_grads(p, gp, ks + c * 16 * kStr, vs + c * 16 * kStr,
                  bias_t != nullptr ? bias_t + c * 16 : nullptr, j0 + c * 16, d, drop, site, b,
                  lane);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[nt][e] = round_to<bf16>(
              __fmul_rn(__fmul_rn(p[nt][e], __fsub_rn(gp[nt][e], term[e >> 1])), d.inv_sqrt_dk));
      unsigned a[4];
      pack_a(a, p[0], p[1]);
      pv_step(acc, a, ks + c * 16 * kStr, lane);
    }
  }

  // gQ's first `rows` rows (row stride D) and their (max, sum, term) at st.
  __device__ void finish(bf16* gq, float* st, int rows, int D, int lane) const {
    store_o(gq, acc, rows, D, lane);
    if (lane % 4 != 0) return;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = lane / 4 + 8 * half;
      if (r >= rows) continue;
      st[r * 3] = m[half];
      st[r * 3 + 1] = l[half];
      st[r * 3 + 2] = term[half];
    }
  }
};

// dq with keys streamed (any T): a block per (64-row query tile, head,
// image), K and V through two 64-key buffers in each of the three passes.
struct DqLayout {
  static constexpr size_t tile = static_cast<size_t>(kKeyTile) * kStr * sizeof(bf16);
  static constexpr size_t q = 0, g = static_cast<size_t>(kQTile) * kStr * sizeof(bf16);
  static constexpr size_t k = 2 * g, v = k + 2 * tile, bias = v + 2 * tile;
  static constexpr size_t bytes = bias + 2 * kKeyTile * sizeof(float);
};

template <bool kDrop>
__global__ void __launch_bounds__(kTcThreads, 4)
    mha_bwd_dq_streamed_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                               const bf16* __restrict__ v, const float* __restrict__ bias,
                               const bf16* __restrict__ g, bf16* __restrict__ gq,
                               float* __restrict__ stats, Dims d, Dropout drop) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + DqLayout::q);
  bf16* Gs = reinterpret_cast<bf16*>(smem + DqLayout::g);
  bf16* Ks[2] = {reinterpret_cast<bf16*>(smem + DqLayout::k),
                 reinterpret_cast<bf16*>(smem + DqLayout::k + DqLayout::tile)};
  bf16* Vs[2] = {reinterpret_cast<bf16*>(smem + DqLayout::v),
                 reinterpret_cast<bf16*>(smem + DqLayout::v + DqLayout::tile)};
  float* Bs = reinterpret_cast<float*>(smem + DqLayout::bias);
  const int Tn = d.T, i0 = blockIdx.x * kQTile, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_kt = (Tn + kKeyTile - 1) / kKeyTile;
  const size_t row0 = static_cast<size_t>(b) * Tn;
  const int r0 = i0 + 16 * warp;  // the warp's first query row
  const bool active = r0 < Tn;
  const unsigned site = d.site0 + h;

  auto stage = [&](int kt, bool with_v) {
    const int j0 = kt * kKeyTile, n = min(kKeyTile, Tn - j0);
    stage_rows(Ks[kt & 1], k, row0 + j0, n, kKeyTile, d.D, h);
    if (with_v) stage_rows(Vs[kt & 1], v, row0 + j0, n, kKeyTile, d.D, h);
    if (bias != nullptr)
      for (int j = threadIdx.x; j < kKeyTile; j += blockDim.x)
        Bs[(kt & 1) * kKeyTile + j] = j < n ? bias[row0 + j0 + j] : 0.f;
  };
  const float* no_bias = nullptr;
  auto bias_of = [&](int kt) { return bias != nullptr ? Bs + (kt & 1) * kKeyTile : no_bias; };
  // body(kt) for every key tile, with K (and V) of tile kt landed.
  auto over_tiles = [&](bool with_v, auto&& body) {
    stage(0, with_v);
    cp_async_commit();
    for (int kt = 0; kt < n_kt; ++kt) {
      if (kt + 1 < n_kt) stage(kt + 1, with_v);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();  // tile kt landed
      if (active) body(kt);
      __syncthreads();  // tile kt's buffers are free
    }
  };

  stage_rows(Qs, q, row0 + i0, min(kQTile, Tn - i0), kQTile, d.D, h);
  stage_rows(Gs, g, row0 + i0, min(kQTile, Tn - i0), kQTile, d.D, h);
  DqTile<kDrop> w;
  w.reset(r0);
  over_tiles(false, [&](int kt) {
    if (kt == 0) {  // Q and g landed with the first tile
      load_q_frags(w.qf, Qs + 16 * warp * kStr, lane);
      load_q_frags(w.gf, Gs + 16 * warp * kStr, lane);
    }
    w.stats_tile(Ks[kt & 1], bias_of(kt), kt * kKeyTile, d, lane);
  });
  w.finish_stats();
  over_tiles(true, [&](int kt) {
    w.term_tile(Ks[kt & 1], Vs[kt & 1], bias_of(kt), kt * kKeyTile, d, drop, site, b, lane);
  });
  w.finish_term();
  over_tiles(true, [&](int kt) {
    w.grad_tile(Ks[kt & 1], Vs[kt & 1], bias_of(kt), kt * kKeyTile, d, drop, site, b, lane);
  });
  cp_async_wait<0>();
  if (active)
    w.finish(gq + (row0 + r0) * d.D + h * kDk,
             stats + ((static_cast<size_t>(b) * d.H + h) * Tn + r0) * 3, min(16, Tn - r0), d.D,
             lane);
}

// dkv: two buffers of a query tile's Q and g rows and statistics; the
// block's K and V rows pass through buffer 1 before the walk starts.
struct DkvLayout {
  static constexpr size_t tile = static_cast<size_t>(kQTile) * kStr * sizeof(bf16);
  static constexpr size_t q = 0, g = 2 * tile, st = 4 * tile;
  static constexpr size_t bytes = st + 2 * kQTile * 3 * sizeof(float);
};

template <bool kDrop>
__global__ void __launch_bounds__(kTcThreads, 3)
    mha_bwd_dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const float* __restrict__ bias,
                          const bf16* __restrict__ g, const float* __restrict__ stats,
                          bf16* __restrict__ gk, bf16* __restrict__ gv, Dims d, Dropout drop) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs[2] = {reinterpret_cast<bf16*>(smem + DkvLayout::q),
                 reinterpret_cast<bf16*>(smem + DkvLayout::q + DkvLayout::tile)};
  bf16* Gs[2] = {reinterpret_cast<bf16*>(smem + DkvLayout::g),
                 reinterpret_cast<bf16*>(smem + DkvLayout::g + DkvLayout::tile)};
  float* St[2] = {reinterpret_cast<float*>(smem + DkvLayout::st),
                  reinterpret_cast<float*>(smem + DkvLayout::st) + kQTile * 3};
  const int Tn = d.T, j0 = blockIdx.x * kKeyTile, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gr = lane / 4, t = lane % 4;
  const int jw = j0 + 16 * warp;  // the warp's first key
  const bool active = jw < Tn;
  const size_t row0 = static_cast<size_t>(b) * Tn;
  const unsigned site = d.site0 + h;
  const float* st_h = stats + (static_cast<size_t>(b) * d.H + h) * Tn * 3;
  const int n_qt = (Tn + kQTile - 1) / kQTile;

  auto stage = [&](int qt) {
    const int i0 = qt * kQTile, n = min(kQTile, Tn - i0), buf = qt & 1;
    stage_rows(Qs[buf], q, row0 + i0, n, kQTile, d.D, h);
    stage_rows(Gs[buf], g, row0 + i0, n, kQTile, d.D, h);
    for (int idx = threadIdx.x; idx < kQTile * 3; idx += blockDim.x) {
      if (idx < n * 3)
        cp_async4(St[buf] + idx, st_h + static_cast<size_t>(i0) * 3 + idx);
      else
        St[buf][idx] = 0.f;  // rows past T: never read
    }
  };

  const int n_keys = min(kKeyTile, Tn - j0);
  stage_rows(Qs[1], k, row0 + j0, n_keys, kKeyTile, d.D, h);
  stage_rows(Gs[1], v, row0 + j0, n_keys, kKeyTile, d.D, h);
  stage(0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  unsigned kf[kDk / 16][4], vf[kDk / 16][4];
  float kb[2] = {0.f, 0.f};  // the biases of keys jw + gr and jw + gr + 8
  if (active) {
    load_q_frags(kf, Qs[1] + 16 * warp * kStr, lane);
    load_q_frags(vf, Gs[1] + 16 * warp * kStr, lane);
    if (bias != nullptr) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = jw + gr + 8 * half;
        kb[half] = j < Tn ? bias[row0 + j] : 0.f;
      }
    }
  }
  __syncthreads();  // buffer 1 is free

  float ak[kDk / 8][4], av[kDk / 8][4];
#pragma unroll
  for (int nt = 0; nt < kDk / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) ak[nt][e] = av[nt][e] = 0.f;
  for (int qt = 0; qt < n_qt; ++qt) {
    if (qt + 1 < n_qt) stage(qt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // query tile qt landed
    const int buf = qt & 1;
    if (active) {
#pragma unroll
      for (int c = 0; c < kQTile / 16; ++c) {
        const bf16* qc = Qs[buf] + c * 16 * kStr;
        const bf16* gc = Gs[buf] + c * 16 * kStr;
        const float* sc = St[buf] + c * 16 * 3;
        const int ic = qt * kQTile + c * 16;  // the chunk's first query
        if (ic >= Tn) break;                   // chunks wholly past T add nothing
        // element (nt, e): key jw + gr + 8 (e / 2), query ic + 8 nt + 2t + e % 2
        float s[2][4], x[2][4];
        dot_rows(s, kf, qc, lane);
        dot_rows(x, vf, gc, lane);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int il = nt * 8 + 2 * t + (e & 1), i = ic + il, j = jw + gr + 8 * (e >> 1);
            float pd = 0.f, gs = 0.f;
            if (i < Tn && j < Tn) {
              float sv = __fmul_rn(s[nt][e], d.inv_sqrt_dk);
              if (bias != nullptr) sv = __fadd_rn(sv, kb[e >> 1]);
              const float* st = sc + il * 3;
              const float p = __fdiv_rn(expf(sv - st[0]), st[1]);
              float gp = x[nt][e];
              pd = round_to<bf16>(p);
              if (kDrop) {
                const float keep = drop.keep(site, b, static_cast<unsigned>(i) * Tn + j);
                pd = round_to<bf16>(pd * keep);
                gp *= keep;
              }
              gs = round_to<bf16>(__fmul_rn(__fmul_rn(p, __fsub_rn(gp, st[2])), d.inv_sqrt_dk));
            }
            s[nt][e] = pd;
            x[nt][e] = gs;
          }
        unsigned a[4];
        pack_a(a, s[0], s[1]);
        pv_step(av, a, gc, lane);
        pack_a(a, x[0], x[1]);
        pv_step(ak, a, qc, lane);
      }
    }
    __syncthreads();  // query tile qt's buffers are free
  }
  cp_async_wait<0>();
  if (active) {
    const size_t o = (row0 + jw) * d.D + h * kDk;
    store_o(gk + o, ak, min(16, Tn - jw), d.D, lane);
    store_o(gv + o, av, min(16, Tn - jw), d.D, lane);
  }
}

template <bool kDrop>
cudaError_t launch_streamed(const void* q, const void* k, const void* v, const void* bias,
                            const void* g, void* gq, void* gk, void* gv, float* stats, int B,
                            const Dims& d, const Dropout& drop, cudaStream_t stream) {
  const bf16 *Q = static_cast<const bf16*>(q), *K = static_cast<const bf16*>(k),
             *V = static_cast<const bf16*>(v), *G = static_cast<const bf16*>(g);
  const float* bs = static_cast<const float*>(bias);
  cudaError_t err = allow_smem(mha_bwd_dq_streamed_kernel<kDrop>, DqLayout::bytes);
  if (err != cudaSuccess) return err;
  mha_bwd_dq_streamed_kernel<kDrop><<<dim3((d.T + kQTile - 1) / kQTile, d.H, B), kTcThreads,
                                      DqLayout::bytes, stream>>>(Q, K, V, bs, G,
                                                                 static_cast<bf16*>(gq), stats,
                                                                 d, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = allow_smem(mha_bwd_dkv_tc_kernel<kDrop>, DkvLayout::bytes);
  if (err != cudaSuccess) return err;
  const int kv_warps = min(kTcWarps, (d.T + 15) / 16);
  mha_bwd_dkv_tc_kernel<kDrop><<<dim3((d.T + kKeyTile - 1) / kKeyTile, d.H, B), kv_warps * 32,
                                  DkvLayout::bytes, stream>>>(Q, K, V, bs, G, stats,
                                                              static_cast<bf16*>(gk),
                                                              static_cast<bf16*>(gv), d, drop);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------
// fp32 backward on the CUDA cores
// ---------------------------------------------------------------------

// First kernel: a block per (32-row query tile, head, image).  Pass 1: the
// rows' max and sum; pass 2: the row term sum_j gP p (fp32 p); pass 3: gS
// and gQ = gS . k_h.  Writes gq's rows and, per row, (max, sum, term) to
// stats[((b * H + h) * T + i) * 3 + 0..2].
template <typename T>
__global__ void __launch_bounds__(kThreads)
    mha_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const float* __restrict__ bias, const T* __restrict__ g,
                      T* __restrict__ gq, float* __restrict__ stats, Dims d, Dropout drop) {
  __shared__ float Qs[kRowTile * kFStr], Gs[kRowTile * kFStr];
  __shared__ float Ks[kRowTile * kFStr], Vs[kRowTile * kFStr], Bt[kRowTile];
  const int Tn = d.T, i0 = blockIdx.x * kRowTile, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t row0 = static_cast<size_t>(b) * Tn;
  const bool has_bias = bias != nullptr;
  const unsigned site = d.site0 + h;
  load_rows_f32(Qs, q, row0 + i0, min(kRowTile, Tn - i0), d.D, h);
  load_rows_f32(Gs, g, row0 + i0, min(kRowTile, Tn - i0), d.D, h);
  auto load_keys = [&](int j0, bool with_v) {
    __syncthreads();  // the previous tile is used
    load_rows_f32(Ks, k, row0 + j0, min(kRowTile, Tn - j0), d.D, h);
    if (with_v) load_rows_f32(Vs, v, row0 + j0, min(kRowTile, Tn - j0), d.D, h);
    load_bias(Bt, bias, row0, j0, Tn);
    __syncthreads();
  };

  float s[kRowsPerWarp], m[kRowsPerWarp], l[kRowsPerWarp], gp[kRowsPerWarp];
  float term[kRowsPerWarp] = {};
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = -FLT_MAX;
    l[r] = 0.f;
  }
  for (int j0 = 0; j0 < Tn; j0 += kRowTile) {
    load_keys(j0, false);
    row_scores(s, Qs, Ks, Bt, has_bias, j0, Tn, d.inv_sqrt_dk, warp, lane);
    row_stats(m, l, s);
  }
  // p and gP = (g . v^T) * keep of element (i, j); p = 0 past T.
  auto probs_and_grads = [&](int j0) {
    row_scores(s, Qs, Ks, Bt, has_bias, j0, Tn, d.inv_sqrt_dk, warp, lane);
    row_dots(gp, Gs, Vs, warp, lane);
    const int j = j0 + lane;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int i = i0 + kRowsPerWarp * warp + r;
      s[r] = j < Tn ? __fdiv_rn(expf(s[r] - m[r]), l[r]) : 0.f;
      if (drop.on) gp[r] *= drop.keep(site, b, static_cast<unsigned>(i * Tn + j));
    }
  };
  for (int j0 = 0; j0 < Tn; j0 += kRowTile) {
    load_keys(j0, true);
    probs_and_grads(j0);
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) term[r] += gp[r] * s[r];
  }
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) term[r] = warp_sum(term[r]);

  float acc[kRowsPerWarp][2] = {};
  for (int j0 = 0; j0 < Tn; j0 += kRowTile) {
    load_keys(j0, true);
    probs_and_grads(j0);
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
      s[r] = round_to<T>(__fmul_rn(__fmul_rn(s[r], __fsub_rn(gp[r], term[r])), d.inv_sqrt_dk));
    for (int key = 0; key < kRowTile; ++key) {
      const float k0 = Ks[key * kFStr + lane], k1 = Ks[key * kFStr + lane + 32];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float gs = __shfl_sync(0xffffffffu, s[r], key);
        acc[r][0] = fmaf(gs, k0, acc[r][0]);
        acc[r][1] = fmaf(gs, k1, acc[r][1]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int i = i0 + kRowsPerWarp * warp + r;
    if (i >= Tn) break;
    T* o = gq + (row0 + i) * d.D + h * kDk;
    o[lane] = from_f32<T>(acc[r][0]);
    o[lane + 32] = from_f32<T>(acc[r][1]);
    if (lane < 3) {
      const float st[3] = {m[r], l[r], term[r]};
      stats[((static_cast<size_t>(b) * d.H + h) * Tn + i) * 3 + lane] = st[lane];
    }
  }
}

// Second kernel: a block per (32-key tile, head, image).
// It walks every query tile in order, recomputes p, pd and gS of the (32 x
// 32) tile from the rows' statistics, and sums gV = pd^T g and gK = gS^T q
// for its keys: warp w owns keys 4w..4w+3, a lane two of their columns.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    mha_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const float* __restrict__ bias,
                       const T* __restrict__ g, const float* __restrict__ stats,
                       T* __restrict__ gk, T* __restrict__ gv, Dims d, Dropout drop) {
  constexpr int PS = kRowTile + 1;
  __shared__ float Ks[kRowTile * kFStr], Vs[kRowTile * kFStr];
  __shared__ float Qs[kRowTile * kFStr], Gs[kRowTile * kFStr];
  __shared__ float Pd[kRowTile * PS], GS[kRowTile * PS], St[kRowTile * 3], Bt[kRowTile];
  const int Tn = d.T, j0 = blockIdx.x * kRowTile, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t row0 = static_cast<size_t>(b) * Tn;
  const bool has_bias = bias != nullptr;
  const unsigned site = d.site0 + h;
  const float* st_h = stats + (static_cast<size_t>(b) * d.H + h) * Tn * 3;
  load_rows_f32(Ks, k, row0 + j0, min(kRowTile, Tn - j0), d.D, h);
  load_rows_f32(Vs, v, row0 + j0, min(kRowTile, Tn - j0), d.D, h);
  load_bias(Bt, bias, row0, j0, Tn);

  float agk[kRowsPerWarp][2] = {}, agv[kRowsPerWarp][2] = {};
  for (int i0 = 0; i0 < Tn; i0 += kRowTile) {
    const int n = min(kRowTile, Tn - i0);
    __syncthreads();  // the previous query tile is used
    load_rows_f32(Qs, q, row0 + i0, n, d.D, h);
    load_rows_f32(Gs, g, row0 + i0, n, d.D, h);
    for (int idx = threadIdx.x; idx < kRowTile * 3; idx += blockDim.x)
      St[idx] = idx < n * 3 ? st_h[static_cast<size_t>(i0) * 3 + idx] : 1.f;
    __syncthreads();
    // the tile's elements: warp w's query rows 4w..4w+3, key j0 + lane
    float s[kRowsPerWarp], gp[kRowsPerWarp];
    row_scores(s, Qs, Ks, Bt, has_bias, j0, Tn, d.inv_sqrt_dk, warp, lane);
    row_dots(gp, Gs, Vs, warp, lane);
    const int j = j0 + lane;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int il = kRowsPerWarp * warp + r, i = i0 + il;
      float pd = 0.f, gs = 0.f;
      if (il < n && j < Tn) {
        const unsigned e = static_cast<unsigned>(i * Tn + j);
        const float p = __fdiv_rn(expf(s[r] - St[il * 3]), St[il * 3 + 1]);
        pd = dropped<T>(p, drop, site, b, e);
        const float x = drop.on ? gp[r] * drop.keep(site, b, e) : gp[r];
        gs = round_to<T>(__fmul_rn(__fmul_rn(p, __fsub_rn(x, St[il * 3 + 2])), d.inv_sqrt_dk));
      }
      Pd[il * PS + lane] = pd;
      GS[il * PS + lane] = gs;
    }
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      const float g0 = Gs[i * kFStr + lane], g1 = Gs[i * kFStr + lane + 32];
      const float q0 = Qs[i * kFStr + lane], q1 = Qs[i * kFStr + lane + 32];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int jl = kRowsPerWarp * warp + r;
        const float pd = Pd[i * PS + jl], gs = GS[i * PS + jl];
        agv[r][0] = fmaf(pd, g0, agv[r][0]);
        agv[r][1] = fmaf(pd, g1, agv[r][1]);
        agk[r][0] = fmaf(gs, q0, agk[r][0]);
        agk[r][1] = fmaf(gs, q1, agk[r][1]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int jj = j0 + kRowsPerWarp * warp + r;
    if (jj >= Tn) break;
    const size_t o = (row0 + jj) * d.D + h * kDk;
    gk[o + lane] = from_f32<T>(agk[r][0]);
    gk[o + lane + 32] = from_f32<T>(agk[r][1]);
    gv[o + lane] = from_f32<T>(agv[r][0]);
    gv[o + lane + 32] = from_f32<T>(agv[r][1]);
  }
}

template <typename T>
cudaError_t launch_rows(const void* q, const void* k, const void* v, const void* bias,
                       const void* g, void* gq, void* gk, void* gv, float* stats, int B,
                       const Dims& d, const Dropout& drop, cudaStream_t stream) {
  const dim3 grid((d.T + kRowTile - 1) / kRowTile, d.H, B);
  mha_bwd_dq_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(bias), static_cast<const T*>(g), static_cast<T*>(gq), stats, d,
      drop);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mha_bwd_dkv_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(bias), static_cast<const T*>(g), stats, static_cast<T*>(gk),
      static_cast<T*>(gv), d, drop);
  return cudaGetLastError();
}

}  // namespace
}  // namespace iisan

// The design iisan_mha_bwd runs at T keys: 0 the fp32 rows (CUDA cores), 1
// the bf16 cluster (up to kClusterMaxKeys keys), 2 the bf16 streamed split.
// The wrapper asks here which buffers and alignment a call needs.
extern "C" int iisan_mha_bwd_design(int T, int is_bf16) {
  return !is_bf16 ? 0 : T <= iisan::kClusterMaxKeys ? 1 : 2;
}

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
// arguments are the forward's.  T is bf16 when is_bf16 (tensor cores: the
// cluster design, whose q, k, v, g, gk and gv start on 16-byte boundaries,
// or the streamed split), else fp32 (CUDA cores).  stats: an fp32 (B, H,
// T, 3) scratch for each query row's (max, sum, row term), for the
// two-kernel designs (the streamed split and fp32); the cluster design
// takes null.  Returns the CUDA error of the launches (0 on success).
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
  const cudaError_t err =
      !is_bf16  ? iisan::launch_rows<float>(q, k, v, bias, g, gq, gk, gv, st, B, d, drop, s)
      : cluster ? iisan::launch_cluster(q, k, v, bias, g, gq, gk, gv, B, d, drop, s)
      : drop.on ? iisan::launch_streamed<true>(q, k, v, bias, g, gq, gk, gv, st, B, d, drop, s)
                : iisan::launch_streamed<false>(q, k, v, bias, g, gq, gk, gv, st, B, d, drop, s);
  return static_cast<int>(err);
}
