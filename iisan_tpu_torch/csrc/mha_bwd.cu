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
// (the two agree up to that rounding only).
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
// 3.35 TB/s) and 26 GFLOP (0.027 ms on the bf16 tensor cores).  The design
// below recomputes the scores and gP on both sides of the split, so it runs
// ten products (52 GFLOP there), every one on mma.sync m16n8k16 with fp32
// sums; the scores never reach device memory.
//
// Design (bf16): two kernels on the forward's tensor-core core (mha.cuh),
// joined by an fp32 (B, H, T, 3) scratch of each query row's (max, sum, row
// term):
// - dq: a warp owns a 16-row m-tile, its Q and g rows as A fragments in
//   registers, and makes three passes over the 64-key tiles: the rows' max
//   and sum (as the forward); S again and gP = g . V^T (V rows are B
//   fragments as K rows are for S), the keep factors, the row term summed
//   across the quad; S and gP again and gS, formed in the C layout and
//   taken as the A fragment of gS . K (K's B fragments through
//   ldmatrix.trans, as V's for pd . V).  It writes gQ and the statistics.
//   Up to 320 keys a block per (head, image) holds K_h and V_h whole and
//   its 8 warps walk the m-tiles with no barrier after the load, as the
//   forward does; beyond, a block per 64-row query tile streams K and V in
//   64-key tiles (cp.async, two buffers).
// - dkv: a block per (64-key tile, head, image), a warp per 16 keys with
//   their K and V rows as A fragments.  It walks the query tiles in order
//   (Q, g and the statistics staged by cp.async, two buffers), 16 queries
//   at a time: S^T = K . Q^T, p from the statistics, pd, gP^T = (V . g^T) *
//   keep and gS, then gV += pd^T . g and gK += gS^T . Q with g and Q as B
//   fragments through ldmatrix.trans; the sums stay in registers.  The
//   dropout element stays query * T + key.
// The two sides recompute S in other orders, so a probability may round to
// the other bf16 neighbour on one side only (within the bf16 tolerance).
//
// fp32 (tests, the fp32 compute dtype): the same split on the CUDA cores
// (mha.cuh's rows kernels), 32-row query tiles against 32-key tiles; no
// TF32, which keeps about three digits.

#include "mha.cuh"

namespace iisan {
namespace {

using namespace mha;

// ---------------------------------------------------------------------
// Tensor-core backward (bf16)
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

// dq with keys resident (T <= kResMaxKeys): a block per (head, image), a
// warp per m-tile in turn, each warp's Q and then g rows through its own
// 16-row buffer.
template <bool kDrop>
__global__ void __launch_bounds__(kResWarps * 32, 2)
    mha_bwd_dq_resident_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                               const bf16* __restrict__ v, const float* __restrict__ bias,
                               const bf16* __restrict__ g, bf16* __restrict__ gq,
                               float* __restrict__ stats, Dims d, Dropout drop) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Tn = d.T, h = blockIdx.x, b = blockIdx.y, kp = padded_keys(Tn);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, n_warps = blockDim.x / 32;
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + kp * kStr;
  bf16* Rw = Vs + kp * kStr + warp * 16 * kStr;
  float* Bs = reinterpret_cast<float*>(Vs + (kp + 16 * n_warps) * kStr);
  const size_t row0 = static_cast<size_t>(b) * Tn;
  const unsigned site = d.site0 + h;
  float* st_h = stats + (static_cast<size_t>(b) * d.H + h) * Tn * 3;
  stage_rows(Ks, k, row0, Tn, kp, d.D, h);
  stage_rows(Vs, v, row0, Tn, kp, d.D, h);
  if (bias != nullptr)
    for (int j = threadIdx.x; j < kp; j += blockDim.x) Bs[j] = j < Tn ? bias[row0 + j] : 0.f;
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const float* no_bias = nullptr;
  auto bias_of = [&](int kt) { return bias != nullptr ? Bs + kt * kKeyTile : no_bias; };
  const int n_kt = kp / kKeyTile;
  for (int mt = warp; mt * 16 < Tn; mt += n_warps) {
    const int i0 = mt * 16, rows = min(16, Tn - i0);
    DqTile<kDrop> w;
    stage_warp_rows(Rw, q, row0 + i0, rows, d.D, h, lane);
    cp_async_commit();
    cp_async_wait<0>();
    __syncwarp();
    load_q_frags(w.qf, Rw, lane);
    __syncwarp();
    stage_warp_rows(Rw, g, row0 + i0, rows, d.D, h, lane);
    cp_async_commit();
    cp_async_wait<0>();
    __syncwarp();
    load_q_frags(w.gf, Rw, lane);
    __syncwarp();  // the rows are read before the next m-tile's land
    w.reset(i0);
    for (int kt = 0; kt < n_kt; ++kt)
      w.stats_tile(Ks + kt * kKeyTile * kStr, bias_of(kt), kt * kKeyTile, d, lane);
    w.finish_stats();
    for (int kt = 0; kt < n_kt; ++kt)
      w.term_tile(Ks + kt * kKeyTile * kStr, Vs + kt * kKeyTile * kStr, bias_of(kt),
                  kt * kKeyTile, d, drop, site, b, lane);
    w.finish_term();
    for (int kt = 0; kt < n_kt; ++kt)
      w.grad_tile(Ks + kt * kKeyTile * kStr, Vs + kt * kKeyTile * kStr, bias_of(kt),
                  kt * kKeyTile, d, drop, site, b, lane);
    w.finish(gq + (row0 + i0) * d.D + h * kDk, st_h + static_cast<size_t>(i0) * 3, rows, d.D,
             lane);
  }
}

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
cudaError_t launch_tc(const void* q, const void* k, const void* v, const void* bias,
                      const void* g, void* gq, void* gk, void* gv, float* stats, int B,
                      const Dims& d, const Dropout& drop, cudaStream_t stream) {
  const bf16 *Q = static_cast<const bf16*>(q), *K = static_cast<const bf16*>(k),
             *V = static_cast<const bf16*>(v), *G = static_cast<const bf16*>(g);
  const float* bs = static_cast<const float*>(bias);
  cudaError_t err;
  if (d.T <= kResMaxKeys) {
    const int n_warps = resident_warps(d.T);
    err = allow_smem(mha_bwd_dq_resident_kernel<kDrop>, resident_bytes(kResMaxKeys, kResWarps));
    if (err != cudaSuccess) return err;
    mha_bwd_dq_resident_kernel<kDrop><<<dim3(d.H, B), n_warps * 32, resident_bytes(d.T, n_warps),
                                 stream>>>(Q, K, V, bs, G, static_cast<bf16*>(gq), stats, d,
                                           drop);
  } else {
    err = allow_smem(mha_bwd_dq_streamed_kernel<kDrop>, DqLayout::bytes);
    if (err != cudaSuccess) return err;
    mha_bwd_dq_streamed_kernel<kDrop><<<dim3((d.T + kQTile - 1) / kQTile, d.H, B), kTcThreads,
                                 DqLayout::bytes, stream>>>(Q, K, V, bs, G,
                                                            static_cast<bf16*>(gq), stats, d,
                                                            drop);
  }
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

// q, k, v, g, gq, gk, gv (B, T, D) T; bias (B, T) fp32 or null; the dropout
// arguments are the forward's.  stats: an fp32 (B, H, T, 3) scratch for
// each query row's (max, sum, row term).  T is bf16 when is_bf16 (tensor
// cores), else fp32 (CUDA cores).  Returns the CUDA error of the launches
// (0 on success).
extern "C" int iisan_mha_bwd(const void* q, const void* k, const void* v, const void* bias,
                             const void* g, void* gq, void* gk, void* gv, void* stats, int B,
                             int T, int D, int H, int is_bf16, int seed, float rate, float scale,
                             int layer, void* stream) {
  if (!iisan::mha::supported(B, T, D, H) || stats == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const iisan::mha::Dims d{T, D, H,
                           static_cast<float>(1.0 / sqrt(static_cast<double>(iisan::mha::kDk))),
                           static_cast<unsigned>(layer * H)};
  const iisan::Dropout drop = iisan::make_dropout(seed, rate, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* st = static_cast<float*>(stats);
  const cudaError_t err =
      !is_bf16  ? iisan::launch_rows<float>(q, k, v, bias, g, gq, gk, gv, st, B, d, drop, s)
      : drop.on ? iisan::launch_tc<true>(q, k, v, bias, g, gq, gk, gv, st, B, d, drop, s)
                : iisan::launch_tc<false>(q, k, v, bias, g, gq, gk, gv, st, B, d, drop, s);
  return static_cast<int>(err);
}
