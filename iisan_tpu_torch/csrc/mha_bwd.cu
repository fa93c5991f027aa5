// Encoder self-attention backward: recomputes the forward's probabilities
// (and its dropout masks) from (q, k, v, bias, seed) and returns gq, gk, gv,
// heads unsplit, by the cast chain of the Pallas kernel (mha.cuh):
//
//   gPd = g . v_h^T          gV = pd^T . g          (fp32 sums of T operands)
//   gP  = gPd * keep         gS = T(p * (gP - sum_j gP p) / sqrt(dk))
//   gQ  = gS . k_h           gK = gS^T . q_h
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
// 3.35 TB/s) and 26 GFLOP (0.027 ms on the bf16 tensor cores).  Both
// designs below run their products as fp32 FMAs on the CUDA cores, so the
// FMA rate bounds them; tensor cores are later work.
//
// Two designs, picked by shape:
// - resident (where its block fits shared memory: bf16 up to 214 keys,
//   fp32 up to 165): one block per (image, head).  K_h and V_h stay in
//   shared memory with fp32 gK and gV sums (about 209 KB at T=197 in bf16,
//   one block an SM); query tiles of 32 rows stream through, and each
//   writes its gQ rows.  The block sums gK and gV over its tiles in order.
// - tiled (any T): keys in 32-key tiles, in two kernels.  `mha_bwd_dq`, a
//   block per (32-row query tile, head, image), makes three passes over the
//   key tiles: each row's max and sum, then its row term sum_j gP_ij p_ij
//   (exactly as `_softmax_bwd` states it, from fp32 p, not FlashAttention's
//   rowsum(dO * O), which would take the rounded, dropped pd), then gS and
//   gQ; it writes the rows' (max, sum, term) to an fp32 scratch.
//   `mha_bwd_dkv`, a block per (32-key tile, head, image), then walks every
//   query tile, recomputes p, pd and gS from those statistics, and sums gK
//   and gV for its keys in query order.

#include "mha.cuh"

namespace iisan {
namespace {

using namespace mha;

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
    mha_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const float* __restrict__ bias, const T* __restrict__ g,
                   T* __restrict__ gq, T* __restrict__ gk, T* __restrict__ gv, Dims d,
                   Dropout drop) {
  constexpr int ST = tile_stride(sizeof(T));
  constexpr int R = kBwdTile / kWarps;
  extern __shared__ __align__(16) unsigned char smem[];
  const int Tn = d.T, h = blockIdx.x, b = blockIdx.y;
  const BwdLayout lay(Tn, sizeof(T));
  T* Ks = reinterpret_cast<T*>(smem + lay.k);
  T* Vs = reinterpret_cast<T*>(smem + lay.v);
  float* gKs = reinterpret_cast<float*>(smem + lay.gk);
  float* gVs = reinterpret_cast<float*>(smem + lay.gv);
  T* Qs = reinterpret_cast<T*>(smem + lay.q);
  T* Gs = reinterpret_cast<T*>(smem + lay.g);
  float* P = reinterpret_cast<float*>(smem + lay.p);
  float* S2 = reinterpret_cast<float*>(smem + lay.s2);
  float* bias_s = reinterpret_cast<float*>(smem + lay.bias);
  const size_t row0 = static_cast<size_t>(b) * Tn;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const unsigned site = d.site0 + h;

  load_head_rows(Ks, k, row0, Tn, d.D, h);
  load_head_rows(Vs, v, row0, Tn, d.D, h);
  for (int j = threadIdx.x; j < Tn; j += blockDim.x) bias_s[j] = bias ? bias[row0 + j] : 0.f;
  for (int idx = threadIdx.x; idx < Tn * kAccStride; idx += blockDim.x) {
    gKs[idx] = 0.f;
    gVs[idx] = 0.f;
  }

  for (int i0 = 0; i0 < Tn; i0 += kBwdTile) {
    const int rows = min(kBwdTile, Tn - i0);
    load_head_rows(Qs, q, row0 + i0, rows, d.D, h);
    load_head_rows(Gs, g, row0 + i0, rows, d.D, h);
    __syncthreads();

    // p (fp32) and pd, rows warp + 8 r
    row_dot_tile<T, R, NC>(Qs, Ks, bias_s, P, rows, Tn, d.inv_sqrt_dk, warp, lane);
    __syncwarp();
    for (int r = 0; r < R; ++r) {
      const int i = warp + kWarps * r;
      if (i >= rows) break;
      float* row = P + i * Tn;
      softmax_row(row, Tn, lane);
      for (int j = lane; j < Tn; j += 32)
        S2[i * Tn + j] =
            dropped<T>(row[j], drop, site, b, static_cast<unsigned>((i0 + i) * Tn + j));
    }
    __syncthreads();

    // gV[j] += sum_i pd[i][j] g[i]: keys over warps, columns over lanes
    for (int j = warp; j < Tn; j += kWarps) {
      float a0 = 0.f, a1 = 0.f;
      for (int i = 0; i < rows; ++i) {
        const float p = S2[i * Tn + j];
        a0 = fmaf(p, to_f32(Gs[i * ST + lane]), a0);
        a1 = fmaf(p, to_f32(Gs[i * ST + lane + 32]), a1);
      }
      gVs[j * kAccStride + lane] += a0;
      gVs[j * kAccStride + lane + 32] += a1;
    }
    __syncthreads();

    // gP = (g . v^T) * keep, then gS, rows warp + 8 r
    row_dot_tile<T, R, NC>(Gs, Vs, nullptr, S2, rows, Tn, 1.0f, warp, lane);
    __syncwarp();
    for (int r = 0; r < R; ++r) {
      const int i = warp + kWarps * r;
      if (i >= rows) break;
      float* gp = S2 + i * Tn;
      const float* p = P + i * Tn;
      float part = 0.f;
      for (int j = lane; j < Tn; j += 32) {
        float x = gp[j];
        if (drop.on) x *= drop.keep(site, b, static_cast<unsigned>((i0 + i) * Tn + j));
        gp[j] = x;
        part += x * p[j];
      }
      const float rsum = warp_sum(part);
      for (int j = lane; j < Tn; j += 32)
        gp[j] = round_to<T>(__fmul_rn(__fmul_rn(p[j], __fsub_rn(gp[j], rsum)), d.inv_sqrt_dk));
    }
    __syncthreads();

    // gQ rows = gS . k_h (rows over warps), written out
    for (int r = 0; r < R; ++r) {
      const int i = warp + kWarps * r;
      if (i >= rows) break;
      float a0 = 0.f, a1 = 0.f;
      for (int j = 0; j < Tn; ++j) {
        const float s = S2[i * Tn + j];
        a0 = fmaf(s, to_f32(Ks[j * ST + lane]), a0);
        a1 = fmaf(s, to_f32(Ks[j * ST + lane + 32]), a1);
      }
      T* o = gq + (row0 + i0 + i) * d.D + h * kDk;
      o[lane] = from_f32<T>(a0);
      o[lane + 32] = from_f32<T>(a1);
    }
    // gK[j] += sum_i gS[i][j] q[i] (keys over warps)
    for (int j = warp; j < Tn; j += kWarps) {
      float a0 = 0.f, a1 = 0.f;
      for (int i = 0; i < rows; ++i) {
        const float s = S2[i * Tn + j];
        a0 = fmaf(s, to_f32(Qs[i * ST + lane]), a0);
        a1 = fmaf(s, to_f32(Qs[i * ST + lane + 32]), a1);
      }
      gKs[j * kAccStride + lane] += a0;
      gKs[j * kAccStride + lane + 32] += a1;
    }
    __syncthreads();
  }

  for (int idx = threadIdx.x; idx < Tn * kDk; idx += blockDim.x) {
    const int j = idx / kDk, c = idx % kDk;
    const size_t o = (row0 + j) * d.D + h * kDk + c;
    gk[o] = from_f32<T>(gKs[j * kAccStride + c]);
    gv[o] = from_f32<T>(gVs[j * kAccStride + c]);
  }
}

// Tiled backward, first kernel: a block per (32-row query tile, head,
// image).  Pass 1: the rows' max and sum; pass 2: the row term sum_j gP p
// (fp32 p); pass 3: gS and gQ = gS . k_h.  Writes gq's rows and, per row,
// (max, sum, term) to stats[((b * H + h) * T + i) * 3 + 0..2].
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

// Tiled backward, second kernel: a block per (32-key tile, head, image).
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

template <typename T, int NC>
cudaError_t launch_nc(const void* q, const void* k, const void* v, const void* bias,
                      const void* g, void* gq, void* gk, void* gv, int B, const Dims& d,
                      const Dropout& drop, cudaStream_t stream) {
  const BwdLayout lay(d.T, sizeof(T));
  cudaError_t err = allow_smem(mha_bwd_kernel<T, NC>, lay.bytes);
  if (err != cudaSuccess) return err;
  mha_bwd_kernel<T, NC><<<dim3(d.H, B), kThreads, lay.bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(bias), static_cast<const T*>(g), static_cast<T*>(gq),
      static_cast<T*>(gk), static_cast<T*>(gv), d, drop);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_tiled(const void* q, const void* k, const void* v, const void* bias,
                         const void* g, void* gq, void* gk, void* gv, float* stats, int B,
                         const Dims& d, const Dropout& drop, cudaStream_t stream) {
  if (stats == nullptr) return cudaErrorInvalidValue;
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

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias, const void* g,
                   void* gq, void* gk, void* gv, float* stats, int B, const Dims& d,
                   const Dropout& drop, cudaStream_t s) {
  if (!bwd_resident(d.T, sizeof(T)))
    return launch_tiled<T>(q, k, v, bias, g, gq, gk, gv, stats, B, d, drop, s);
  switch ((d.T + 31) / 32) {
    case 1: return launch_nc<T, 1>(q, k, v, bias, g, gq, gk, gv, B, d, drop, s);
    case 2: return launch_nc<T, 2>(q, k, v, bias, g, gq, gk, gv, B, d, drop, s);
    case 3: return launch_nc<T, 3>(q, k, v, bias, g, gq, gk, gv, B, d, drop, s);
    case 4: return launch_nc<T, 4>(q, k, v, bias, g, gq, gk, gv, B, d, drop, s);
    case 5: return launch_nc<T, 5>(q, k, v, bias, g, gq, gk, gv, B, d, drop, s);
    case 6: return launch_nc<T, 6>(q, k, v, bias, g, gq, gk, gv, B, d, drop, s);
    case 7: return launch_nc<T, 7>(q, k, v, bias, g, gq, gk, gv, B, d, drop, s);
    default: return launch_nc<T, 8>(q, k, v, bias, g, gq, gk, gv, B, d, drop, s);
  }
}

}  // namespace
}  // namespace iisan

// q, k, v, g, gq, gk, gv (B, T, D) T; bias (B, T) fp32 or null; the dropout
// arguments are the forward's.  stats: an fp32 (B, H, T, 3) scratch that
// the tiled design needs (null where the resident block fits, see
// bwd_resident).  Returns the CUDA error of the launches (0 on success).
extern "C" int iisan_mha_bwd(const void* q, const void* k, const void* v, const void* bias,
                             const void* g, void* gq, void* gk, void* gv, void* stats, int B,
                             int T, int D, int H, int is_bf16, int seed, float rate, float scale,
                             int layer, void* stream) {
  if (!iisan::mha::supported(B, T, D, H)) return static_cast<int>(cudaErrorInvalidValue);
  const iisan::mha::Dims d{T, D, H,
                           static_cast<float>(1.0 / sqrt(static_cast<double>(iisan::mha::kDk))),
                           static_cast<unsigned>(layer * H)};
  const iisan::Dropout drop = iisan::make_dropout(seed, rate, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* st = static_cast<float*>(stats);
  const cudaError_t err =
      is_bf16 ? iisan::launch<__nv_bfloat16>(q, k, v, bias, g, gq, gk, gv, st, B, d, drop, s)
              : iisan::launch<float>(q, k, v, bias, g, gq, gk, gv, st, B, d, drop, s);
  return static_cast<int>(err);
}
