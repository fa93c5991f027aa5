// Fused SASRec user-encoder backward, bf16 route, on the tensor cores: a
// per-sequence sweep and a weight-gradient pass.
//
// Replaces the Pallas TPU kernel `_bwd_kernel` (with `_attn_bwd` and
// `_layernorm_bwd`) in iisan_tpu/ops/fused_user_encoder.py.  Like it, the
// only residuals are (x, mask, seed).  The fp32 route is
// user_encoder_f32.cu.
//
// 1. user_encoder_bwd_tc_kernel, a block a sequence: reruns the forward
//    with user_encoder_tc.cuh's code, keeping each layer's operands and
//    LayerNorm statistics (a slot a layer), then sweeps back with
//    `_bwd_kernel`'s cast chain.  The input-gradient products (through
//    w2, w1, wo and wq|wk|wv: T-rounded operands, fp32 sums) run on the
//    tensor cores, streaming each matrix through the ring as the forward
//    does and reading it transposed through ldmatrix.  The attention
//    backward takes fp32 operands in the cast chain (g_o, and the score
//    gradient), so it stays an fp32 product on the CUDA cores.  Dropout
//    keep factors are drawn again, four elements a Philox call.  Instead
//    of a weight gradient, the sweep writes the T-rounded operands of each
//    weight-gradient product to device memory in bf16, which is exact:
//    rows of x, ctx, x1 and hf, and of gq|gk|gv, g_o2, g_hpre and g_h2.
//    The LayerNorm and bias gradients, sums over the sequence's rows, go to
//    a short partial row a sequence, and the input gradient in fp32 to a
//    row for the position table.
// 2. user_encoder_wgrad_kernel forms every dW = A^T . G over all B*L rows
//    on the tensor cores, a 64 x 64 tile a block, the rows in a fixed
//    order through a three-stage cp.async ring; its other blocks sum the
//    partial and position rows over the batch in order.  Every gradient is
//    written once, so the result repeats bit for bit.
//
// This replaced the CUDA-core kernel's (B, P) gradient scratch (25.7 MB at
// B = 64) and its grad_reduce pass: at the training geometry (B = 64,
// L = 10, D = 64, F = 256, 2 layers) the device buffer is 3.1 MB.  What
// bounds it on the H100: as the forward, the latency of a sequence's chain
// on one SM; the weight-gradient products leave that chain.

#include "user_encoder_tc.cuh"

namespace iisan {
namespace tc {
namespace {

// The backward's device buffer (ops/fused_user_encoder.py's `_tc_work`
// repeats this arithmetic): per layer the bf16 rows of the weight-gradient
// operands, each array (B*L, r8(width)) with zero pads; then the fp32
// partial rows (B, Q); the fp32 input gradient (B, L, D); the areas'
// scratch (B, per_seq bytes).
struct TcWork {
  int wD, wF, w3D, Q;
  long long xin, ctx, x1, hf, gqkv, go2, ghpre, gh2, layer;  // bf16 elements
  long long rows, part, gx32, scratch, total;                // bytes
  __host__ __device__ TcWork(int B, const EncoderDims& d, long long per_seq)
      : wD(r8(d.D)), wF(r8(d.F)), w3D(r8(3 * d.D)), Q(small_params(d)) {
    const long long BL = static_cast<long long>(B) * d.L;
    xin = 0;
    ctx = xin + BL * wD;
    x1 = ctx + BL * wD;
    hf = x1 + BL * wD;
    gqkv = hf + BL * wF;
    go2 = gqkv + BL * w3D;
    ghpre = go2 + BL * wD;
    gh2 = ghpre + BL * wF;
    layer = gh2 + BL * wD;
    long long at = 0;
    rows = take(at, 2 * layer * d.n_layers);
    part = take(at, 4LL * B * Q);
    gx32 = take(at, 4LL * BL * d.D);
    scratch = take(at, B * per_seq);
    total = at;
  }
};

// L rows of an operand (row stride s) into rows b*L .. of a (B*L, w8)
// array, 16 bytes a copy (the operand's pad columns are zeros).
__device__ void copy_rows(const bf16* src, int s, bf16* dst, int w8, size_t b, int L) {
  const int per = w8 / 8;
  uint4* d = reinterpret_cast<uint4*>(dst + b * L * w8);
  for (int i = threadIdx.x; i < L * per; i += blockDim.x) {
    const int l = i / per, q = i - l * per;
    d[i] = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(l) * s + q * 8);
  }
}

template <int kPlace>
__global__ void __launch_bounds__(kThreads, 1)
    user_encoder_bwd_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ mask,
                               const float* __restrict__ params, const bf16* __restrict__ image,
                               const bf16* __restrict__ gout,
                               bf16* __restrict__ gx, char* __restrict__ work, long long per_seq,
                               EncoderDims dims, float inv_sqrt_dk, Dropout drop, int B) {
  extern __shared__ __align__(16) char smem_tc[];
  const TcLayout lay(dims, true);
  const TcWork wk(B, dims, per_seq);
  const int L = dims.L, D = dims.D, H = dims.H, F = dims.F, dk = lay.dk;
  const int LD = L * D, Lp = lay.Lp, sD = lay.sD, sF = lay.sF, sL = lay.sL, sdk = lay.sdk;
  const int s3D = lay.s3D;
  const size_t b = blockIdx.x;
  const unsigned bu = static_cast<unsigned>(b);
  const TcAreas ar(static_cast<Placement>(kPlace), lay, dims.n_layers, smem_tc,
                   work + wk.scratch, b, per_seq);
  ar.zero();
  __syncthreads();
  forward_tc<true>(x + b * LD, mask + b * L * L, params, image, dims, lay, inv_sqrt_dk, drop,
                   bu, ar, lay.slot, nullptr);

  float* g = reinterpret_cast<float*>(ar.work + lay.g);
  float* ga = reinterpret_cast<float*>(ar.work + lay.ga);
  float* gh = reinterpret_cast<float*>(ar.work + lay.gh);
  float* gc = reinterpret_cast<float*>(ar.work + lay.gc);
  bf16* gbb = reinterpret_cast<bf16*>(ar.work + lay.gbb);
  float* gh32 = reinterpret_cast<float*>(ar.work + lay.gh32);
  bf16* ghb = reinterpret_cast<bf16*>(ar.work + lay.ghb);
  float* gsc = reinterpret_cast<float*>(ar.work + lay.gsc);
  bf16* gqkv = reinterpret_cast<bf16*>(ar.work + lay.gqkv);
  for (int i = threadIdx.x; i < LD; i += blockDim.x) g[i] = bf(gout[b * LD + i]);
  __syncthreads();

  float* part = reinterpret_cast<float*>(work + wk.part) + b * wk.Q;
  bf16* rows = reinterpret_cast<bf16*>(work + wk.rows);
  // the small parameters, which the recompute copied to the head
  const float* sp = reinterpret_cast<const float*>(ar.head + lay.sp);
  const float pscale = drop.on ? drop.scale : 1.f;
  Stream ring(image, dims, true, ar.ring);

  for (int layer = dims.n_layers - 1; layer >= 0; --layer) {
    const int step = dims.n_layers - 1 - layer;
    const float* ln1_s = sp + 2 * D + layer * (5 * D + F);
    const float* ln2_s = ln1_s + 3 * D + F;
    const Slot s(ar.slots + layer * lay.slot, lay, true);
    // This layer's partial row: ln1 scale, ln1 bias, b1, b2, ln2 scale,
    // ln2 bias (the packed order of the entries that are not matrices).
    float* pl = part + 2 * D + layer * (5 * D + F);
    bf16* rl = rows + layer * wk.layer;
    copy_rows(s.xin, sD, rl + wk.xin, wk.wD, b, L);
    copy_rows(s.ctx, sD, rl + wk.ctx, wk.wD, b, L);
    copy_rows(s.x1, sD, rl + wk.x1, wk.wD, b, L);
    copy_rows(s.hf, sF, rl + wk.hf, wk.wF, b, L);

    // x_out = LN2(x1 + dropout(hf @ w2 + b2))
    layer_norm_bwd(g, s.xhat2, s.rstd2, ln2_s, ga, pl + 3 * D + F, pl + 4 * D + F, L, D);
    __syncthreads();
    keep_each(drop, site_ffn_out(layer, H), bu, LD, [&](int e, float kp) { gh[e] = ga[e] * kp; });
    __syncthreads();
    col_sum(gh, pl + 2 * D + F, L, D);
    for (int e = threadIdx.x; e < LD; e += blockDim.x) {
      const int l = e / D, d = e - l * D;
      gbb[l * sD + d] = __float2bfloat16_rn(gh[e]);
    }
    __syncthreads();
    copy_rows(gbb, sD, rl + wk.gh2, wk.wD, b, L);
    gemm(gbb, sD, L, ring, ring.prod(step, 0), [&](int r, int f, float v0, float v1) {
      for (int e = 0; e < 2 && f + e < F; ++e)
        gh32[r * F + f + e] = bf(s.hf[r * sF + f + e]) > 0.f ? (e ? v1 : v0) : 0.f;
    });
    __syncthreads();
    col_sum(gh32, pl + 2 * D, L, F);
    for (int e = threadIdx.x; e < L * F; e += blockDim.x) {
      const int l = e / F, f = e - l * F;
      ghb[l * sF + f] = __float2bfloat16_rn(gh32[e]);
    }
    __syncthreads();
    copy_rows(ghb, sF, rl + wk.ghpre, wk.wF, b, L);
    gemm(ghb, sF, L, ring, ring.prod(step, 1), [&](int r, int d, float v0, float v1) {
      gc[r * D + d] = ga[r * D + d] + v0;
      if (d + 1 < D) gc[r * D + d + 1] = ga[r * D + d + 1] + v1;
    });
    __syncthreads();

    // x1 = LN1(x_in + dropout(ctx @ wo))
    layer_norm_bwd(gc, s.xhat1, s.rstd1, ln1_s, ga, pl, pl + D, L, D);
    __syncthreads();
    keep_each(drop, site_attn_out(layer, H), bu, LD, [&](int e, float kp) {
      const int l = e / D, d = e - l * D;
      gbb[l * sD + d] = __float2bfloat16_rn(ga[e] * kp);
    });
    __syncthreads();
    copy_rows(gbb, sD, rl + wk.go2, wk.wD, b, L);
    gemm(gbb, sD, L, ring, ring.prod(step, 2), [&](int r, int d, float v0, float v1) {
      gh[r * D + d] = v0;  // g_o, fp32
      if (d + 1 < D) gh[r * D + d + 1] = v1;
    });
    __syncthreads();

    // Attention (`_attn_bwd`), all heads at once, fp32 on the CUDA cores.
    // gsc = dL/dp through the dropout.
    for (int idx = threadIdx.x; idx < H * L * L; idx += blockDim.x) {
      const int h = idx / (L * L), r = idx - h * L * L;
      const int l = r / L, m = r - l * L;
      const float* gr = gh + l * D + h * dk;
      const bf16* vc = s.vT + h * lay.dkp * sL + m;
      float acc = 0.f;
      for (int c = 0; c < dk; ++c) acc = fmaf(gr[c], bf(vc[c * sL]), acc);
      gsc[idx] = acc;
    }
    __syncthreads();
    if (drop.on) {
      for (int h = 0; h < H; ++h)
        keep_each(drop, site_probs(layer, h, H), bu, L * L,
                  [&](int e, float kp) { gsc[h * L * L + e] *= kp; });
      __syncthreads();
    }
    for (int idx = threadIdx.x; idx < LD; idx += blockDim.x) {
      const int m = idx / D, c = idx - m * D, h = c / dk;
      float acc = 0.f;
      for (int l = 0; l < L; ++l)
        acc = fmaf(bf(s.P[(h * Lp + l) * sL + m]) * pscale, gh[l * D + c], acc);
      gqkv[m * s3D + 2 * D + c] = __float2bfloat16_rn(acc);
    }
    for (int row = threadIdx.x / 32; row < H * L; row += kWarps) {
      const int lane = threadIdx.x % 32;
      float* gr = gsc + row * L;
      const float* pr = s.praw + row * L;
      float dot = 0.f;
      for (int m = lane; m < L; m += 32) dot = fmaf(gr[m], pr[m], dot);
      dot = warp_sum(dot);
      for (int m = lane; m < L; m += 32) gr[m] = pr[m] * (gr[m] - dot) * inv_sqrt_dk;
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < LD; idx += blockDim.x) {
      const int r = idx / D, cc = idx - r * D, h = cc / dk, c = cc - h * dk;
      float aq = 0.f, ak = 0.f;
      for (int j = 0; j < L; ++j) {
        aq = fmaf(gsc[(h * L + r) * L + j], bf(s.kh[(h * Lp + j) * sdk + c]), aq);
        ak = fmaf(gsc[(h * L + j) * L + r], bf(s.qh[(h * Lp + j) * sdk + c]), ak);
      }
      gqkv[r * s3D + cc] = __float2bfloat16_rn(aq);
      gqkv[r * s3D + D + cc] = __float2bfloat16_rn(ak);
    }
    __syncthreads();
    copy_rows(gqkv, s3D, rl + wk.gqkv, wk.w3D, b, L);
    // g = grad of x_in: wq, wk, wv side by side, one product over 3D.
    gemm(gqkv, s3D, L, ring, ring.prod(step, 3), [&](int r, int d, float v0, float v1) {
      g[r * D + d] = ga[r * D + d] + v0;
      if (d + 1 < D) g[r * D + d + 1] = ga[r * D + d + 1] + v1;
    });
    __syncthreads();
  }

  // Input dropout, input LayerNorm, the fp32 input gradient row.
  if (drop.on) {
    keep_each(drop, 0u, bu, LD, [&](int e, float kp) { g[e] *= kp; });
    __syncthreads();
  }
  layer_norm_bwd(g, reinterpret_cast<float*>(ar.head + lay.xhat0),
                 reinterpret_cast<float*>(ar.head + lay.rstd0), sp, ga, part, part + D, L, D);
  __syncthreads();
  float* gx32 = reinterpret_cast<float*>(work + wk.gx32) + b * LD;
  for (int i = threadIdx.x; i < LD; i += blockDim.x) {
    gx32[i] = ga[i];
    gx[b * LD + i] = __float2bfloat16_rn(ga[i]);
  }
}

// The weight-gradient pass.
constexpr int kWgThreads = 128;            // 4 warps: 16 rows of a tile's k each
constexpr int kWgTile = 64;                // dW tile: 64 k x 64 n
constexpr int kWgRows = 64;                // B*L rows a stage
constexpr int kWgStages = 3;
constexpr int kWgLd = kWgTile + 8;         // bf16 row stride of a staged tile
constexpr int kWgStageElems = 2 * kWgRows * kWgLd;  // A and G
constexpr int kWgSmem = kWgStages * kWgStageElems * 2;
constexpr int kWgSumThreads = 128;         // columns a partial-sum block takes

__host__ __device__ inline int wg_tiles_per_layer(const EncoderDims& d) {
  const int tD = (d.D + kWgTile - 1) / kWgTile, tF = (d.F + kWgTile - 1) / kWgTile;
  const int t3D = (3 * d.D + kWgTile - 1) / kWgTile;
  return tD * t3D + tD * tD + 2 * tD * tF;
}

// Blocks 0 .. n_tiles-1: one 64 x 64 tile of one layer's dW = A^T . G over
// all B*L rows in order (A, G the bf16 rows of the sweep); the rest: a
// column of the sums over the batch (partial rows, then position rows;
// position rows past L are zero).
__global__ void __launch_bounds__(kWgThreads)
    user_encoder_wgrad_kernel(const char* __restrict__ work, float* __restrict__ gparams,
                              EncoderDims dims, int B, int n_tiles) {
  extern __shared__ __align__(16) char smem_wg[];
  const TcWork wk(B, dims, 0);
  const int D = dims.D, F = dims.F, L = dims.L;
  const int bsize = BlockParams::size(D, F);
  float* blocks0 = gparams + static_cast<size_t>(dims.n_position) * D + 2 * D;
  if (static_cast<int>(blockIdx.x) >= n_tiles) {
    const int idx = (blockIdx.x - n_tiles) * kWgSumThreads + threadIdx.x;
    if (idx < wk.Q) {
      const float* part = reinterpret_cast<const float*>(work + wk.part) + idx;
      float acc = 0.f;
      for (int b = 0; b < B; ++b) acc += part[static_cast<size_t>(b) * wk.Q];
      gparams[small_param_index(idx, dims)] = acc;
    } else if (idx < wk.Q + dims.n_position * D) {
      const int i = idx - wk.Q;
      float acc = 0.f;
      if (i < L * D) {
        const float* gx32 = reinterpret_cast<const float*>(work + wk.gx32) + i;
        for (int b = 0; b < B; ++b) acc += gx32[static_cast<size_t>(b) * L * D];
      }
      gparams[i] = acc;
    }
    return;
  }

  const int tD = (D + kWgTile - 1) / kWgTile, tF = (F + kWgTile - 1) / kWgTile;
  const int t3D = (3 * D + kWgTile - 1) / kWgTile;
  const int per_layer = wg_tiles_per_layer(dims);
  const int layer = blockIdx.x / per_layer;
  int r = blockIdx.x - layer * per_layer;
  const bf16* rl = reinterpret_cast<const bf16*>(work + wk.rows) + layer * wk.layer;
  float* blk = blocks0 + static_cast<size_t>(layer) * bsize;
  const bf16 *A, *G;
  int wa, wg, Kw, Ng, Nm, tn;
  float* out;
  if (r < tD * t3D) {  // wq | wk | wv
    A = rl + wk.xin, wa = wk.wD, G = rl + wk.gqkv, wg = wk.w3D;
    Kw = D, Ng = 3 * D, Nm = D, tn = t3D, out = blk;
  } else if ((r -= tD * t3D) < tD * tD) {  // wo
    A = rl + wk.ctx, wa = wk.wD, G = rl + wk.go2, wg = wk.wD;
    Kw = D, Ng = D, Nm = D, tn = tD, out = blk + 3 * D * D;
  } else if ((r -= tD * tD) < tD * tF) {  // w1
    A = rl + wk.x1, wa = wk.wD, G = rl + wk.ghpre, wg = wk.wF;
    Kw = D, Ng = F, Nm = F, tn = tF, out = blk + 4 * D * D + 2 * D;
  } else {  // w2
    r -= tD * tF;
    A = rl + wk.hf, wa = wk.wF, G = rl + wk.gh2, wg = wk.wD;
    Kw = F, Ng = D, Nm = D, tn = tD, out = blk + 4 * D * D + 2 * D + D * F + F;
  }
  const int k0 = (r / tn) * kWgTile, n0 = (r % tn) * kWgTile;
  const int R = B * L, n_steps = (R + kWgRows - 1) / kWgRows;
  bf16* st = reinterpret_cast<bf16*>(smem_wg);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3, mi = lane >> 3, rr = lane & 7;

  auto load = [&](int step) {
    bf16* sa = st + (step % kWgStages) * kWgStageElems;
    bf16* sg = sa + kWgRows * kWgLd;
    const int r0 = step * kWgRows;
    for (int c = threadIdx.x; c < 2 * kWgRows * 8; c += kWgThreads) {
      const bool is_g = c >= kWgRows * 8;
      const int cc = is_g ? c - kWgRows * 8 : c;
      const int row = cc / 8, q = cc % 8;
      const int col = (is_g ? n0 : k0) + 8 * q, width = is_g ? wg : wa;
      const bf16* base = is_g ? G : A;
      const bool ok = r0 + row < R && col < width;
      cp_async16_zfill((is_g ? sg : sa) + row * kWgLd + 8 * q,
                       ok ? base + static_cast<size_t>(r0 + row) * width + col : base,
                       ok ? 16 : 0);
    }
  };

  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int s = 0; s < kWgStages - 1; ++s) {
    if (s < n_steps) load(s);
    cp_async_commit();
  }
  for (int step = 0; step < n_steps; ++step) {
    cp_async_wait<kWgStages - 2>();
    __syncthreads();
    if (step + kWgStages - 1 < n_steps) load(step + kWgStages - 1);
    cp_async_commit();
    const bf16* sa = st + (step % kWgStages) * kWgStageElems;
    const bf16* sg = sa + kWgRows * kWgLd;
#pragma unroll
    for (int ks = 0; ks < kWgRows / 16; ++ks) {
      unsigned a[4];
      ldsm_x4_trans(a, sa + (ks * 16 + rr + (mi >> 1) * 8) * kWgLd + warp * 16 + (mi & 1) * 8);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        unsigned q[4];
        ldsm_x4_trans(q, sg + (ks * 16 + rr + (mi & 1) * 8) * kWgLd + np * 16 + (mi >> 1) * 8);
        const unsigned b0[2] = {q[0], q[1]}, b1[2] = {q[2], q[3]};
        mma_bf16(acc[2 * np], a, b0);
        mma_bf16(acc[2 * np + 1], a, b1);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = k0 + warp * 16 + g + (e >> 1) * 8;
      const int n = n0 + j * 8 + 2 * t + (e & 1);
      if (k < Kw && n < Ng) {
        const int m = n / Nm;
        out[static_cast<size_t>(m) * Kw * Nm + static_cast<size_t>(k) * Nm + (n - m * Nm)] =
            acc[j][e];
      }
    }
}

template <int kPlace>
cudaError_t launch_sweep(const void* x, const void* mask, const void* params, const void* image,
                         const void* gout, void* gx, char* work, int B,
                         const EncoderDims& dims, const Dropout& drop, cudaStream_t stream) {
  const TcLayout lay(dims, true);
  const Placement pl = static_cast<Placement>(kPlace);
  const size_t smem = tc_smem_bytes(lay, pl, dims.n_layers);
  const long long per_seq = tc_scratch_bytes(lay, pl, dims.n_layers);
  cudaError_t err = allow_smem(user_encoder_bwd_tc_kernel<kPlace>, smem);
  if (err != cudaSuccess) return err;
  const float inv_sqrt_dk = static_cast<float>(1.0 / sqrt(static_cast<double>(dims.D / dims.H)));
  user_encoder_bwd_tc_kernel<kPlace><<<B, kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(mask),
      static_cast<const float*>(params), static_cast<const bf16*>(image),
      static_cast<const bf16*>(gout), static_cast<bf16*>(gx),
      work, per_seq, dims, inv_sqrt_dk, drop, B);
  return cudaGetLastError();
}

}  // namespace
}  // namespace tc
}  // namespace iisan

// The sweep: x, gout, gx (B, L, D) bf16; mask (B, L, L) fp32; params: the
// packed fp32 parameter vector and image its bf16 weight image
// (iisan_user_encoder_weights); work: the device buffer of TcWork's layout,
// work_bytes long (checked).  Dropout as iisan_user_encoder_fwd.  Returns
// the CUDA error of the launch (0 on success).
extern "C" int iisan_user_encoder_bwd_tc(const void* x, const void* mask, const void* params,
                                         const void* image, const void* gout, void* gx,
                                         void* work,
                                         long long work_bytes, int B, int L, int D, int H, int F,
                                         int n_layers, int n_position, int seed, float rate,
                                         float scale, void* stream) {
  using namespace iisan;
  using namespace iisan::tc;
  const EncoderDims dims{L, D, H, F, n_layers, n_position};
  const Dropout drop = make_dropout(seed, rate, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const TcLayout lay(dims, true);
  const Placement pl = tc_place(lay, n_layers);
  if (TcWork(B, dims, tc_scratch_bytes(lay, pl, n_layers)).total > work_bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  char* w = static_cast<char*>(work);
  cudaError_t err;
  switch (pl) {
    case kResident:
      err = launch_sweep<kResident>(x, mask, params, image, gout, gx, w, B, dims, drop, s);
      break;
    case kSlotsGlobal:
      err = launch_sweep<kSlotsGlobal>(x, mask, params, image, gout, gx, w, B, dims, drop, s);
      break;
    default: err = launch_sweep<kSpilled>(x, mask, params, image, gout, gx, w, B, dims, drop, s);
  }
  return static_cast<int>(err);
}

// The weight-gradient pass over the sweep's work buffer: writes every
// entry of gparams (P floats, the packed order).  Returns the CUDA error of
// the launch (0 on success).
extern "C" int iisan_user_encoder_wgrad(const void* work, long long work_bytes, void* gparams,
                                        int B, int L, int D, int H, int F, int n_layers,
                                        int n_position, void* stream) {
  using namespace iisan;
  using namespace iisan::tc;
  const EncoderDims dims{L, D, H, F, n_layers, n_position};
  const TcWork wk(B, dims, 0);
  if (wk.scratch > work_bytes) return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = n_layers * wg_tiles_per_layer(dims);
  const int n_sums = (wk.Q + n_position * D + kWgSumThreads - 1) / kWgSumThreads;
  cudaError_t err = allow_smem(user_encoder_wgrad_kernel, kWgSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  user_encoder_wgrad_kernel<<<n_tiles + n_sums, kWgThreads, kWgSmem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char*>(work), static_cast<float*>(gparams), dims, B, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 route's layout at these shapes, the one source of its offsets
// for code that reads the device buffers (ops/fused_user_encoder.py's
// `encoder_plan`, `tc_image_elems` and `tc_work_layout` repeat it, and are
// held to it).  out receives, as long longs: the forward's placement,
// shared-memory bytes and per-sequence scratch bytes; the backward's the
// same three; the weight image's bf16 entries; TcWork's bf16 element
// offsets xin, ctx, x1, hf, gqkv, go2, ghpre, gh2 and layer; its byte
// offsets part, gx32, scratch and total.  Returns the count of values, or
// -1 when n is smaller.
extern "C" int iisan_user_encoder_tc_layout(int B, int L, int D, int H, int F, int n_layers,
                                            int n_position, long long* out, int n) {
  using namespace iisan;
  using namespace iisan::tc;
  constexpr int kCount = 20;
  if (n < kCount) return -1;
  const EncoderDims dims{L, D, H, F, n_layers, n_position};
  const TcLayout fl(dims, false), bl(dims, true);
  const Placement fp = tc_place(fl, 1), bp = tc_place(bl, n_layers);
  const long long per_seq = tc_scratch_bytes(bl, bp, n_layers);
  const TcWork wk(B, dims, per_seq);
  const long long v[kCount] = {fp, tc_smem_bytes(fl, fp, 1), tc_scratch_bytes(fl, fp, 1),
                               bp, tc_smem_bytes(bl, bp, n_layers), per_seq,
                               WImage(D, F).layer * n_layers,
                               wk.xin, wk.ctx, wk.x1, wk.hf, wk.gqkv, wk.go2, wk.ghpre, wk.gh2,
                               wk.layer, wk.part, wk.gx32, wk.scratch, wk.total};
  for (int i = 0; i < kCount; ++i) out[i] = v[i];
  return kCount;
}
