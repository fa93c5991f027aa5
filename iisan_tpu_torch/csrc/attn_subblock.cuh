// Shared pieces of the attention-subblock kernels (attn_subblock_fwd.cu,
// attn_subblock_v2_fwd.cu): qkv projection + per-head attention + output
// projection of one BERT or ViT layer, in bf16, as two kernels in fixed
// order.
//
// 1. `subblock_attn_kernel`, a block per (head h, sequence b): projects the
//    head's q, k and v from x (T, D) into shared memory on the bf16 tensor
//    cores (mma.sync m16n8k16, fp32 sums), streaming x and the head's 64
//    weight rows in 32-deep slices through a 2-stage cp.async ring:
//        q_h = bf16(x . Wq_h + bq_h)   (fp32 sum, fp32 bias, one rounding)
//    then runs mha.cuh's attention core on them (fp32 scores, softmax,
//    Philox dropout at site layer * H + h, fp32 sums with V) and writes its
//    head's context columns to a (B, T, D) bf16 scratch.  A ViT image's x is
//    302 KB in bf16, more than a block's 227 KB, which is why a block holds
//    one head's q, k, v (3 x 26 KB at T = 197) and not the sequence.
// 2. `subblock_out_kernel`: out = ctx . Wo + bo on the tensor cores, 128 x
//    128 tiles, with the sum over D cut into groups of `kg` rows of Wo: each
//    group's sum is fp32, and the groups are added in order onto bo:
//        tot = (bo + c_0) + c_1 + ...
//    One group (kg = D) is #8's `ctx . Wo + bo`; kg = 4 heads' rows is #9's
//    head-group accumulation.
//
// Weights arrive transposed, (out, in) row-major, so that a B fragment is a
// 32-bit load of two neighbouring k.  `group` names the row order of the
// projection weight: 0 for [q | k | v] blocks of D rows (wqkv^T, #8), G > 0
// for #9's head groups (group_weights' wg^T: per group, each head's q, k,
// v rows side by side).
#pragma once

#include "mha.cuh"
#include "mma.cuh"

namespace iisan {
namespace subblock {

using namespace mha;
typedef __nv_bfloat16 bf16;

constexpr int kBK = 32;                       // projection slice depth
constexpr int kSt = kBK + 8;                  // staging row stride (elements): 80 bytes
constexpr int kMaxMTiles = kMaxKeys / 16;     // 16-row tiles of a sequence
constexpr int kJ = kMaxMTiles * 4 / kWarps;   // (row tile, 16 columns) tasks a warp
constexpr int kOBM = 128, kOBN = 128;         // output-projection tile
constexpr int kOSt = kBK + 8;

__host__ __device__ inline int padded_rows(int Tn) { return (Tn + 15) / 16 * 16; }

// Block of subblock_attn_kernel: K_h, V_h, Q_h (all T rows), the key bias,
// then a work area that holds the projection's staging ring and, after it,
// one query tile's fp32 scores.
struct AttnLayout {
  size_t k, v, q, bias, work, bytes;
  __host__ __device__ AttnLayout(int Tn) {
    const size_t kv = align16(static_cast<size_t>(Tn) * tile_stride(2) * 2);
    const size_t staging = 2 * static_cast<size_t>(padded_rows(Tn) + kDk) * kSt * 2;
    const size_t scores = align16(static_cast<size_t>(fwd_tile(Tn)) * Tn * 4);
    k = 0;
    v = kv;
    q = 2 * kv;
    bias = 3 * kv;
    work = bias + align16(static_cast<size_t>(Tn) * 4);
    bytes = work + (staging > scores ? staging : scores);
  }
};

__host__ __device__ inline size_t out_smem_bytes() {
  return 2 * static_cast<size_t>(kOBM + kOBN) * kOSt * 2;
}

// First row of the projection weight holding part p (0 q, 1 k, 2 v) of head h.
__host__ __device__ inline int proj_row(int h, int p, int D, int group) {
  if (group == 0) return p * D + h * kDk;
  return (h / group) * (3 * group * kDk) + (h % group) * 3 * kDk + p * kDk;
}

// The geometry the kernels take (the wrappers check it first and raise).
inline bool supported(int B, int Tn, int D, int H, int group) {
  return B >= 1 && H >= 1 && Tn >= 1 && Tn <= kMaxKeys && D == H * kDk && D % kOBN == 0 &&
         (group == 0 || (H % group == 0)) &&
         AttnLayout(Tn).bytes <= 232448;
}

// Stage slice k0 of x's rows [0, mp) of one sequence (rows past T repeat row
// T - 1; their sums are never stored) and of the 64 weight rows from wrow.
__device__ inline void stage_slice(bf16* xs, bf16* ws, const bf16* x, const bf16* wt, int Tn,
                                   int mp, int D, size_t xrow0, int wrow, int k0) {
  for (int c = threadIdx.x; c < (mp + kDk) * (kBK / 8); c += blockDim.x) {
    const int r = c / (kBK / 8), piece = (c % (kBK / 8)) * 8;
    if (r < mp) {
      const size_t row = xrow0 + static_cast<size_t>(min(r, Tn - 1));
      cp_async16(xs + r * kSt + piece, x + row * D + k0 + piece);
    } else {
      const int n = r - mp;
      cp_async16(ws + n * kSt + piece, wt + static_cast<size_t>(wrow + n) * D + k0 + piece);
    }
  }
}

// dst[i][c] = bf16(sum_d x[i][d] wt[wrow + c][d] + bproj[wrow + c]) for i < T,
// c < 64: one head's q, k or v, fp32 sums on the tensor cores.  A warp takes
// the (16-row tile, 16-column group) tasks warp, warp + 8, ...; the call
// ends with every thread past its last read of the staging ring.
__device__ inline void project_head(bf16* dst, bf16* stage, const bf16* x, const bf16* wt,
                                    const float* bproj, int Tn, int D, size_t xrow0, int wrow,
                                    int warp, int lane) {
  constexpr int ST = tile_stride(2);
  const int mp = padded_rows(Tn), n_mt = mp / 16;
  const int g = lane / 4, t = lane % 4, ng = warp % 4;
  bf16* xs[2] = {stage, stage + (mp + kDk) * kSt};
  bf16* ws[2] = {xs[0] + mp * kSt, xs[1] + mp * kSt};
  float acc[kJ][2][4];
#pragma unroll
  for (int j = 0; j < kJ; ++j)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][ni][e] = 0.f;
  const int n_slices = D / kBK;
  stage_slice(xs[0], ws[0], x, wt, Tn, mp, D, xrow0, wrow, 0);
  cp_async_commit();
  for (int kc = 0; kc < n_slices; ++kc) {
    if (kc + 1 < n_slices)
      stage_slice(xs[(kc + 1) & 1], ws[(kc + 1) & 1], x, wt, Tn, mp, D, xrow0, wrow,
                  (kc + 1) * kBK);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* X = xs[kc & 1];
    const bf16* W = ws[kc & 1];
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 16) {
      unsigned b[2][2];
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) {
        const bf16* p = W + (ng * 16 + ni * 8 + g) * kSt + ks + 2 * t;
        b[ni][0] = lds32(p);
        b[ni][1] = lds32(p + 8);
      }
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const int mt = warp / 4 + 2 * j;
        if (mt < n_mt) {
          const bf16* p = X + (mt * 16 + g) * kSt + ks + 2 * t;
          const unsigned a[4] = {lds32(p), lds32(p + 8 * kSt), lds32(p + 8),
                                 lds32(p + 8 * kSt + 8)};
          mma_bf16(acc[j][0], a, b[0]);
          mma_bf16(acc[j][1], a, b[1]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    const int mt = warp / 4 + 2 * j;
    if (mt >= n_mt) continue;
#pragma unroll
    for (int ni = 0; ni < 2; ++ni) {
      const int c = ng * 16 + ni * 8 + 2 * t;
      const float b0 = bproj[wrow + c], b1 = bproj[wrow + c + 1];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = mt * 16 + g + 8 * half;
        if (r < Tn) {
          dst[r * ST + c] = __float2bfloat16_rn(__fadd_rn(acc[j][ni][2 * half], b0));
          dst[r * ST + c + 1] = __float2bfloat16_rn(__fadd_rn(acc[j][ni][2 * half + 1], b1));
        }
      }
    }
  }
}

template <int NC>
__global__ void __launch_bounds__(kThreads)
    subblock_attn_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wt,
                         const float* __restrict__ bproj, const float* __restrict__ bias,
                         bf16* __restrict__ ctx, Dims d, int group, Dropout drop) {
  constexpr int ST = tile_stride(2);
  extern __shared__ __align__(16) unsigned char smem[];
  const int Tn = d.T, h = blockIdx.x, b = blockIdx.y;
  const AttnLayout lay(Tn);
  bf16* Ks = reinterpret_cast<bf16*>(smem + lay.k);
  bf16* Vs = reinterpret_cast<bf16*>(smem + lay.v);
  bf16* Qs = reinterpret_cast<bf16*>(smem + lay.q);
  float* bias_s = reinterpret_cast<float*>(smem + lay.bias);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t row0 = static_cast<size_t>(b) * Tn;
  for (int j = threadIdx.x; j < Tn; j += blockDim.x) bias_s[j] = bias ? bias[row0 + j] : 0.f;

  bf16* parts[3] = {Qs, Ks, Vs};
  for (int p = 0; p < 3; ++p)
    project_head(parts[p], reinterpret_cast<bf16*>(smem + lay.work), x, wt, bproj, Tn, d.D,
                 row0, proj_row(h, p, d.D, group), warp, lane);
  __syncthreads();  // q, k, v and the bias in place; the staging ring is free

  // Each warp owns rows warp + 8 r of a query tile from here on.
  float* S = reinterpret_cast<float*>(smem + lay.work);
  for (int i0 = 0; i0 < Tn; i0 += d.tile) {
    const int rows = min(d.tile, Tn - i0);
    row_dot_tile<bf16, kFwdRowsPerWarp, NC>(Qs + i0 * ST, Ks, bias_s, S, rows, Tn,
                                            d.inv_sqrt_dk, warp, lane);
    __syncwarp();
    softmax_pv_tile<bf16, kFwdRowsPerWarp>(S, Vs, ctx + (row0 + i0) * d.D + h * kDk, rows, Tn,
                                           d.D, i0, drop, d.site0 + h, b, warp, lane);
    __syncwarp();
  }
}

// out[m][n] = TO(tot): tot = (bo[n] + c_0) + c_1 + ..., c_i = sum over rows
// [i kg, (i + 1) kg) of ctx[m][k] Wo[k][n] in fp32; wot is Wo^T (N, K).
template <typename TO>
__global__ void __launch_bounds__(kThreads)
    subblock_out_kernel(const bf16* __restrict__ a, const bf16* __restrict__ wot,
                        const float* __restrict__ bo, TO* __restrict__ out, int M, int K, int N,
                        int kg) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* as[2];
  bf16* bs[2];
  for (int s = 0; s < 2; ++s) {
    as[s] = reinterpret_cast<bf16*>(smem) + s * (kOBM + kOBN) * kOSt;
    bs[s] = as[s] + kOBM * kOSt;
  }
  const int n0 = blockIdx.x * kOBN, m0 = blockIdx.y * kOBM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, wm = warp / 4, wn = warp % 4;

  auto stage = [&](int s, int k0) {
    for (int c = threadIdx.x; c < (kOBM + kOBN) * (kBK / 8); c += blockDim.x) {
      const int r = c / (kBK / 8), piece = (c % (kBK / 8)) * 8;
      if (r < kOBM) {
        const size_t row = static_cast<size_t>(min(m0 + r, M - 1));
        cp_async16(as[s] + r * kOSt + piece, a + row * K + k0 + piece);
      } else {
        const int n = r - kOBM;
        cp_async16(bs[s] + n * kOSt + piece, wot + static_cast<size_t>(n0 + n) * K + k0 + piece);
      }
    }
  };

  float acc[4][4][4], tot[4][4][4], bov[4][2];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int col = n0 + wn * 32 + ni * 8 + 2 * t;
    bov[ni][0] = bo[col];
    bov[ni][1] = bo[col + 1];
  }
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = tot[mi][ni][e] = 0.f;

  const int n_slices = K / kBK, per_group = kg / kBK;
  stage(0, 0);
  cp_async_commit();
  for (int kc = 0; kc < n_slices; ++kc) {
    if (kc + 1 < n_slices) stage((kc + 1) & 1, (kc + 1) * kBK);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* A = as[kc & 1];
    const bf16* B = bs[kc & 1];
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 16) {
      unsigned af[4][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const bf16* p = A + (wm * 64 + mi * 16 + g) * kOSt + ks + 2 * t;
        af[mi][0] = lds32(p);
        af[mi][1] = lds32(p + 8 * kOSt);
        af[mi][2] = lds32(p + 8);
        af[mi][3] = lds32(p + 8 * kOSt + 8);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const bf16* p = B + (wn * 32 + ni * 8 + g) * kOSt + ks + 2 * t;
        bf[ni][0] = lds32(p);
        bf[ni][1] = lds32(p + 8);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], af[mi], bf[ni]);
    }
    __syncthreads();
    if ((kc + 1) % per_group == 0) {  // a group's sum is complete
      const bool first = kc + 1 == per_group;
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            tot[mi][ni][e] = __fadd_rn(first ? bov[ni][e & 1] : tot[mi][ni][e], acc[mi][ni][e]);
            acc[mi][ni][e] = 0.f;
          }
    }
  }
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = m0 + wm * 64 + mi * 16 + g + 8 * half;
      if (r >= M) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = n0 + wn * 32 + ni * 8 + 2 * t;
        store2(out + static_cast<size_t>(r) * N + col, tot[mi][ni][2 * half],
               tot[mi][ni][2 * half + 1]);
      }
    }
}

template <int NC>
cudaError_t launch_attn_nc(const void* x, const void* wt, const void* bproj, const void* bias,
                           void* ctx, int B, const Dims& d, int group, const Dropout& drop,
                           cudaStream_t stream) {
  const AttnLayout lay(d.T);
  cudaError_t err = allow_smem(subblock_attn_kernel<NC>, lay.bytes);
  if (err != cudaSuccess) return err;
  subblock_attn_kernel<NC><<<dim3(d.H, B), kThreads, lay.bytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wt), static_cast<const float*>(bproj),
      static_cast<const float*>(bias), static_cast<bf16*>(ctx), d, group, drop);
  return cudaGetLastError();
}

// Both kernels on `stream`: x (B, T, D) bf16 -> ctx scratch (B, T, D) bf16
// -> out (B, T, D) in TO.  Returns the first CUDA error (0 on success).
template <typename TO>
cudaError_t launch(const void* x, const void* wt, const void* bproj, const void* wot,
                   const void* bo, const void* bias, void* ctx, void* out, int B, int Tn, int D,
                   int H, int group, int kg, int seed, float rate, float scale, int layer,
                   cudaStream_t stream) {
  const Dims d{Tn, D, H, fwd_tile(Tn),
               static_cast<float>(1.0 / sqrt(static_cast<double>(kDk))),
               static_cast<unsigned>(layer * H)};
  const Dropout drop = make_dropout(seed, rate, scale);
  cudaError_t err;
  switch ((Tn + 31) / 32) {
    case 1: err = launch_attn_nc<1>(x, wt, bproj, bias, ctx, B, d, group, drop, stream); break;
    case 2: err = launch_attn_nc<2>(x, wt, bproj, bias, ctx, B, d, group, drop, stream); break;
    case 3: err = launch_attn_nc<3>(x, wt, bproj, bias, ctx, B, d, group, drop, stream); break;
    case 4: err = launch_attn_nc<4>(x, wt, bproj, bias, ctx, B, d, group, drop, stream); break;
    case 5: err = launch_attn_nc<5>(x, wt, bproj, bias, ctx, B, d, group, drop, stream); break;
    case 6: err = launch_attn_nc<6>(x, wt, bproj, bias, ctx, B, d, group, drop, stream); break;
    case 7: err = launch_attn_nc<7>(x, wt, bproj, bias, ctx, B, d, group, drop, stream); break;
    case 8: err = launch_attn_nc<8>(x, wt, bproj, bias, ctx, B, d, group, drop, stream); break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  const int M = B * Tn;
  const size_t bytes = out_smem_bytes();
  err = allow_smem(subblock_out_kernel<TO>, bytes);
  if (err != cudaSuccess) return err;
  subblock_out_kernel<TO><<<dim3(D / kOBN, (M + kOBM - 1) / kOBM), kThreads, bytes, stream>>>(
      static_cast<const bf16*>(ctx), static_cast<const bf16*>(wot),
      static_cast<const float*>(bo), static_cast<TO*>(out), M, D, D, kg);
  return cudaGetLastError();
}

}  // namespace subblock
}  // namespace iisan
