// Fused SASRec user encoder, fp32 route, on Hopper's tensor cores: the
// weight image, the forward (#1), and the backward (#2) as a sweep and a
// weight-gradient pass.  user_encoder_f32.cuh has the tile body and its
// reasoning.
//
// Replaces the Pallas TPU kernels `_fwd_kernel` (`_encoder_fwd_body`,
// `_attn_fwd`) and `_bwd_kernel` (`_attn_bwd`, `_layernorm_bwd`) in
// iisan_tpu/ops/fused_user_encoder.py at fp32.  Like them the backward's
// only residuals are (x, mask, seed): it reruns the forward, with the same
// code and Philox bits, then sweeps back.
//
// What bounds it on the H100: neither bytes nor FLOPs (at B = 64, L = 10,
// D = 64, F = 256, two blocks the forward is about 128 MFLOP and 0.7 MB)
// but the latency of a tile's chain of some forty dependent phases.  Past
// one tile an SM, a tile of several sequences cuts the blocks (two
// sequences a tile at B = 256 on 132 SMs, 128 blocks, not 256) and the
// weights' reads from L2 with them; the products run on wgmma; the
// weights land a stage ahead of their use.
//
// 1. user_encoder_f32_weights_kernel: the packed fp32 parameters into the
//    image of swizzled fp32 64 x 64 tiles that the blocks stream
//    (F32Image).
// 2. user_encoder_fwd_f32_kernel: a block a tile, every area in shared
//    memory where the tile plan puts it there.
// 3. user_encoder_bwd_f32_kernel, the sweep: a block a tile reruns the
//    forward, keeping each layer's values in the device buffer (F32Work:
//    rows of the whole batch), then back-propagates with `_bwd_kernel`'s
//    chain.  The input-gradient products run on wgmma through the image's
//    backward part (W's tiles); the attention backward and the LayerNorm,
//    bias and softmax gradients are fp32 on the CUDA cores.  The
//    weight-gradient operands are fp32 rows of the buffer: x, ctx, x1 and
//    hf from the forward, and gq|gk|gv, g_o2, g_hpre and g_h2, which
//    overwrite q|k|v, LN1's and LN2's xhat once the sweep has read them.
//    The LayerNorm and bias gradients, sums over the tile's rows in order,
//    go to a partial row a tile, with the tile's position gradient.
// 4. user_encoder_wgrad_f32_kernel: every dW = A^T . G over all B*L rows
//    in three TF32 passes, a 64 x 64 tile a block, the rows in order; its
//    other blocks sum the partial rows over the tiles in order.  Every
//    gradient is written once, so the result repeats bit for bit, and no
//    (B, P) scratch is needed: 6.0 MB of buffer at the training geometry.

#include <algorithm>

#include "user_encoder_f32.cuh"
#include "user_encoder_tc.cuh"

namespace iisan {
namespace f32 {
namespace {

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

__device__ __forceinline__ Tile block_tile(int G, int B, int L) {
  const int b0 = blockIdx.x * G, n = min(G, B - b0);
  return Tile{b0, n, n * L};
}

// The backward's device buffer (ops/fused_user_encoder.py's
// `f32_work_layout` repeats this arithmetic), byte offsets: per layer fp32
// rows (B*L, width) of x (xin), ctx, x1, hf, q|k|v (then gq|gk|gv), LN1's
// xhat (then g_o2), LN2's xhat (then g_h2), g_hpre (ghp), the
// probabilities (H L a row) and the two rstds; then the input LayerNorm's
// xhat and rstd, the partial rows (a tile's: the small parameters'
// gradients in the packed order, then its position rows), the tiles'
// scratch.
struct F32Work {
  int nblk, Q, Qp;
  long long xin, ctx, x1, hf, qkv, xh1, xh2, ghp, p, rs, layer;
  long long xh0, rs0, part, scratch, total;
  __host__ __device__ F32Work(int B, const EncoderDims& d, int G_, long long per_tile)
      : nblk((B + G_ - 1) / G_), Q(2 * d.D + d.n_layers * (5 * d.D + d.F)),
        Qp(Q + d.L * d.D) {
    const long long R4 = 4LL * B * d.L;
    long long at = 0;
    xin = take(at, R4 * d.D);
    ctx = take(at, R4 * d.D);
    x1 = take(at, R4 * d.D);
    hf = take(at, R4 * d.F);
    qkv = take(at, R4 * 3 * d.D);
    xh1 = take(at, R4 * d.D);
    xh2 = take(at, R4 * d.D);
    ghp = take(at, R4 * d.F);
    p = take(at, R4 * d.H * d.L);
    rs = take(at, R4 * 2);
    layer = at;
    at = layer * d.n_layers;
    xh0 = take(at, R4 * d.D);
    rs0 = take(at, R4);
    part = take(at, 4LL * nblk * Qp);
    scratch = take(at, nblk * per_tile);
    total = at;
  }
};

// ---------------------------------------------------------------------
// 1. The weight image.
// ---------------------------------------------------------------------

__global__ void __launch_bounds__(256)
    user_encoder_f32_weights_kernel(const float* __restrict__ params, float* __restrict__ image,
                                    EncoderDims d, long long n) {
  const F32Image im(d.D, d.F);
  const int D = d.D, F = d.F;
  const long long per_part = im.layer * d.n_layers;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; e < n;
       e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long tile = e >> 12;
    const int w = static_cast<int>(e & 4095), byte = 4 * w;
    const int row = (byte & 8191) >> 7, ch = (byte >> 4) & 7;
    const int col = (byte >> 13) * 32 + ((ch ^ (row & 7)) << 2) + (w & 3);
    const bool bwd = tile >= per_part;
    const long long lt0 = bwd ? tile - per_part : tile;
    const int layer = static_cast<int>(lt0 / im.layer);
    long long lt = lt0 - layer * im.layer;
    int m = 3;
    while (m > 0 && lt < im.first(m)) --m;
    lt -= im.first(m);
    int K, N;
    im.shape(m, K, N);
    const int red = bwd ? nt64(N) : nt64(K);
    const int o = static_cast<int>(lt / red), r = static_cast<int>(lt - static_cast<long long>(o) * red);
    const int k = bwd ? 64 * o + row : 64 * r + col, nn = bwd ? 64 * r + col : 64 * o + row;
    float v = 0.f;
    if (k < K && nn < N) {
      const BlockParams wp(params + static_cast<size_t>(d.n_position) * D + 2 * D +
                               static_cast<size_t>(layer) * BlockParams::size(D, F),
                           D, F);
      const float* src;
      if (m == 0) {
        const int q = nn / D;
        src = (q == 0 ? wp.wq : q == 1 ? wp.wk : wp.wv) + static_cast<size_t>(k) * D + (nn - q * D);
      } else if (m == 1) {
        src = wp.wo + static_cast<size_t>(k) * D + nn;
      } else if (m == 2) {
        src = wp.w1 + static_cast<size_t>(k) * F + nn;
      } else {
        src = wp.w2 + static_cast<size_t>(k) * D + nn;
      }
      v = __ldg(src);
    }
    image[e] = v;
  }
}

// ---------------------------------------------------------------------
// 2. The forward.
// ---------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads, 1)
    user_encoder_fwd_f32_kernel(const float* __restrict__ x, const float* __restrict__ mask,
                                const float* __restrict__ params, const float* __restrict__ image,
                                float* __restrict__ out, float* __restrict__ scratch, TilePlan plan,
                                EncoderDims d, int B, float inv_sqrt_dk, Dropout drop) {
  extern __shared__ __align__(16) unsigned char smem_f32[];
  unsigned char* base = align1024(smem_f32);
  const int L = d.L, D = d.D;
  const Tile tl = block_tile(plan.G, B, L);
  Ring ring(base, image, d, 4 * d.n_layers, cdiv(tl.M, 64));
  if (threadIdx.x == 0) ring.start();
  float* ab = plan.place == kResident
                  ? reinterpret_cast<float*>(base + kRingBytes - 1024)
                  : scratch + static_cast<size_t>(blockIdx.x) * (plan.scratch / 4);
  const TileAreas ta(ab, plan.G, d, false);
  const long long Ma = static_cast<long long>(plan.G) * L;
  LayerAreas a;
  a.xin = ta.a;
  a.x1 = ta.b;
  a.qkv = ta.c;
  a.ctx = ta.c + Ma * ta.s3D;
  a.hf = ta.c;
  a.ldx = a.ldc = a.ld1 = ta.sD;
  a.ldq = ta.s3D;
  a.ldh = lds(d.F);
  a.xh1 = a.xh2 = a.p = a.rs = a.qkv_stash = nullptr;
  __syncthreads();  // the ring's barriers
  const size_t r0 = static_cast<size_t>(tl.b0) * L;
  forward(x + r0 * D, mask + r0 * L, params, d, tl, inv_sqrt_dk, drop, ring, ta.res, ta.sD, ta.S,
          [&](int) { return a; }, out + r0 * D, nullptr, nullptr);
}

// ---------------------------------------------------------------------
// 3. The sweep.
// ---------------------------------------------------------------------

// out[j] = sum over rows r < M of f(r, j), for every j < N: NP threads a
// column (adjacent lanes, NP a power of two up to 32, as many as the
// block's threads allow), each summing the rows p, p + NP, ... in order,
// joined by a fixed shuffle tree, so the result repeats run to run.
template <typename Fn>
__device__ inline void col_reduce(int M, int N, Fn f, float* __restrict__ out) {
  int NP = 1;
  while (NP < 32 && 2 * NP * N <= kThreads) NP *= 2;
  const int lane = threadIdx.x & 31;
  for (int base = threadIdx.x & ~31; base < N * NP; base += kThreads) {
    const int idx = base + lane, j = idx / NP, pp = idx - j * NP;
    float s = 0.f;
    if (j < N) {
#pragma unroll 4
      for (int r = pp; r < M; r += NP) s += f(r, j);
    }
    for (int off = NP >> 1; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (j < N && pp == 0) out[j] = s;
  }
}

// out[j] = sum over rows r < M of src[r, j] (row stride ld).
__device__ inline void col_sum(const float* src, int ld, int M, int N, float* __restrict__ out) {
  col_reduce(M, N, [&](int r, int j) { return src[static_cast<size_t>(r) * ld + j]; }, out);
}

// LayerNorm backward (`_layernorm_bwd`) of the M rows gy (row stride ldy):
// gx = rstd (gy s - mean(gy s) - xhat mean(gy s xhat)) (row stride ldg);
// the scale and bias gradients, sums over the rows (col_reduce), to gscale
// and gbias.  xhat row stride D, rstd a value every rs_step floats.
__device__ inline void ln_bwd(const float* gy, int ldy, const float* xhat, const float* rstd,
                              int rs_step, const float* __restrict__ scale, float* gx, int ldg,
                              float* __restrict__ gscale, float* __restrict__ gbias, int M,
                              int D) {
  col_reduce(M, D, [&](int r, int c) {
    return gy[static_cast<size_t>(r) * ldy + c] * xhat[static_cast<size_t>(r) * D + c];
  }, gscale);
  col_sum(gy, ldy, M, D, gbias);
  const int gs = D <= 256 ? 16 : 32, rpw = 32 / gs;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, li = lane % gs;
  for (int base = warp * rpw; base < M; base += (kThreads / 32) * rpw) {
    const int r = base + lane / gs;
    const bool ok = r < M;
    const float* y = gy + static_cast<size_t>(ok ? r : 0) * ldy;
    const float* xh = xhat + static_cast<size_t>(ok ? r : 0) * D;
    float s1 = 0.f, s2 = 0.f;
    for (int c = li; ok && c < D; c += gs) {
      const float gh = y[c] * __ldg(scale + c);
      s1 += gh;
      s2 = fmaf(gh, xh[c], s2);
    }
    const float m1 = group_sum(s1, gs) / D, m2 = group_sum(s2, gs) / D;
    if (!ok) continue;
    const float rs = rstd[static_cast<size_t>(r) * rs_step];
    for (int c = li; c < D; c += gs)
      gx[static_cast<size_t>(r) * ldg + c] = rs * (y[c] * __ldg(scale + c) - m1 - xh[c] * m2);
  }
}

// The attention backward (`_attn_bwd`) of one layer on the CUDA cores:
// from g_o (row stride ldo) and the layer's stashed q|k|v and
// probabilities, gq, gk and gv side by side into gt (row stride ldt).  The
// stash's rows come to shared memory first: q|k into qk (row stride
// lds(2D)), v into gq's columns of gt until gq is formed.  S takes the
// score gradients, KP the dropped probabilities, then the probabilities.
// Ends with a barrier.
__device__ inline void attention_bwd(const LayerAreas& a, const float* go, int ldo, float* gt,
                                     int ldt, float* qk, float* S, float* KP, int layer,
                                     const Tile& tl, const EncoderDims& d, float inv_sqrt_dk,
                                     const Dropout& drop) {
  const int L = d.L, D = d.D, H = d.H, dk = D / H, LL = L * L, HL = H * L, ldk = lds(2 * D);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, n_warps = kThreads / 32;
  for (int r = warp; r < tl.M; r += n_warps) {
    const float* src = a.qkv_stash + static_cast<size_t>(r) * 3 * D;
    for (int c = lane; c < 2 * D; c += 32) qk[static_cast<size_t>(r) * ldk + c] = src[c];
    for (int c = lane; c < D; c += 32) gt[static_cast<size_t>(r) * ldt + c] = src[2 * D + c];
  }
  __syncthreads();
  // dL/dp through the dropout (a warp a (sequence, head), lanes over
  // (query, key)); KP becomes pd, the probabilities P.V used
  for (int pair = warp; pair < tl.n * H; pair += n_warps) {
    const int j = pair / H, h = pair - j * H;
    const unsigned site = site_probs(layer, h, H), b = static_cast<unsigned>(tl.b0 + j);
    for (int lm = lane; lm < LL; lm += 32) {
      const int l = lm / L, m = lm - l * L;
      const float* gr = go + static_cast<size_t>(j * L + l) * ldo + h * dk;
      const float* vr = gt + static_cast<size_t>(j * L + m) * ldt + h * dk;
      const float acc = blocked_sum(dk, [&](int c, float s) { return fmaf(gr[c], vr[c], s); });
      const size_t idx = static_cast<size_t>(pair) * LL + lm;
      const float kp = drop.on ? drop.keep(site, b, static_cast<unsigned>(lm)) : 1.f;
      S[idx] = acc * kp;
      KP[idx] = a.p[static_cast<size_t>(j * L + l) * HL + h * L + m] * kp;
    }
  }
  __syncthreads();
  // gv = pd^T . g_o (a warp a key row, lanes over columns)
  for (int r = warp; r < tl.M; r += n_warps) {
    const int j = r / L, m = r - j * L;
    for (int c = lane; c < D; c += 32) {
      const float* pd = KP + static_cast<size_t>(j * H + c / dk) * LL + m;
      gt[static_cast<size_t>(r) * ldt + 2 * D + c] = blocked_sum(L, [&](int l, float s) {
        return fmaf(pd[l * L], go[static_cast<size_t>(j * L + l) * ldo + c], s);
      });
    }
  }
  __syncthreads();
  for (int pair = warp; pair < tl.n * H; pair += n_warps) {
    const int j = pair / H, h = pair - j * H;
    for (int lm = lane; lm < LL; lm += 32) {
      const int l = lm / L;
      KP[static_cast<size_t>(pair) * LL + lm] =
          a.p[static_cast<size_t>(j * L + l) * HL + h * L + (lm - l * L)];
    }
  }
  __syncthreads();
  // the score gradient: p (gp - sum(gp p)) / sqrt(dk), a thread a row
  for (int row = threadIdx.x; row < tl.n * H * L; row += kThreads) {
    float* gr = S + static_cast<size_t>(row) * L;
    const float* pr = KP + static_cast<size_t>(row) * L;
    const float dot = blocked_sum(L, [&](int m, float s) { return fmaf(gr[m], pr[m], s); });
    for (int m = 0; m < L; ++m) gr[m] = pr[m] * (gr[m] - dot) * inv_sqrt_dk;
  }
  __syncthreads();
  for (int r = warp; r < tl.M; r += n_warps) {
    const int j = r / L, i = r - j * L;
    for (int c = lane; c < D; c += 32) {
      const float* gs = S + static_cast<size_t>((j * H + c / dk) * L) * L;
      const float* q = qk + static_cast<size_t>(j * L) * ldk + c;
      // sum_m gs[i, m] k[m], and sum_l gs[l, i] q[l]
      gt[static_cast<size_t>(r) * ldt + c] = blocked_sum(L, [&](int m, float s) {
        return fmaf(gs[i * L + m], q[static_cast<size_t>(m) * ldk + D], s);
      });
      gt[static_cast<size_t>(r) * ldt + D + c] = blocked_sum(L, [&](int m, float s) {
        return fmaf(gs[m * L + i], q[static_cast<size_t>(m) * ldk], s);
      });
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 1)
    user_encoder_bwd_f32_kernel(const float* __restrict__ x, const float* __restrict__ mask,
                                const float* __restrict__ params, const float* __restrict__ image,
                                const float* __restrict__ gout, float* __restrict__ gx,
                                char* __restrict__ work, TilePlan plan, EncoderDims d, int B,
                                float inv_sqrt_dk, Dropout drop) {
  extern __shared__ __align__(16) unsigned char smem_f32[];
  unsigned char* base = align1024(smem_f32);
  const int L = d.L, D = d.D, H = d.H, F = d.F, NL = d.n_layers;
  const Tile tl = block_tile(plan.G, B, L);
  const int M = tl.M;
  const F32Work wk(B, d, plan.G, plan.scratch);
  Ring ring(base, image, d, 8 * NL, cdiv(M, 64));
  if (threadIdx.x == 0) ring.start();
  float* ab = plan.place == kResident
                  ? reinterpret_cast<float*>(base + kRingBytes - 1024)
                  : reinterpret_cast<float*>(work + wk.scratch +
                                             static_cast<size_t>(blockIdx.x) * plan.scratch);
  const TileAreas ta(ab, plan.G, d, true);
  const size_t r0 = static_cast<size_t>(tl.b0) * L;
  auto arr = [&](int layer, long long off, int w) {
    return reinterpret_cast<float*>(work + layer * wk.layer + off) + r0 * w;
  };
  auto areas = [&](int layer) {
    LayerAreas a;
    a.xin = arr(layer, wk.xin, D);
    a.qkv = ta.d4;  // the tile's copy, for the attention; the stash beside it
    a.qkv_stash = arr(layer, wk.qkv, 3 * D);
    a.ctx = arr(layer, wk.ctx, D);
    a.x1 = arr(layer, wk.x1, D);
    a.hf = arr(layer, wk.hf, F);
    a.ldx = a.ldc = a.ld1 = D;
    a.ldq = ta.s3D;
    a.ldh = F;
    a.xh1 = arr(layer, wk.xh1, D);
    a.xh2 = arr(layer, wk.xh2, D);
    a.p = arr(layer, wk.p, H * L);
    a.rs = arr(layer, wk.rs, 2);
    return a;
  };
  float* xh0 = reinterpret_cast<float*>(work + wk.xh0) + r0 * D;
  float* rs0 = reinterpret_cast<float*>(work + wk.rs0) + r0;
  __syncthreads();  // the ring's barriers
  forward(x + r0 * D, mask + r0 * L, params, d, tl, inv_sqrt_dk, drop, ring, ta.res, ta.sD, ta.S,
          areas, nullptr, xh0, rs0);

  const int sD = ta.sD, s3D = ta.s3D;
  float *g = ta.a, *ga = ta.b, *go = ta.c, *gt = ta.d4, *gc = ta.res;
  for (int r = threadIdx.x >> 5; r < M; r += kThreads / 32)
    for (int c = threadIdx.x & 31; c < D; c += 32)
      g[static_cast<size_t>(r) * sD + c] = gout[(r0 + r) * D + c];
  __syncthreads();
  float* part = reinterpret_cast<float*>(work + wk.part) + static_cast<size_t>(blockIdx.x) * wk.Qp;
  const float* ln0 = params + static_cast<size_t>(d.n_position) * D;
  const float* blocks = ln0 + 2 * D;

  for (int layer = NL - 1; layer >= 0; --layer) {
    const LayerAreas a = areas(layer);
    const BlockParams w(blocks + static_cast<size_t>(layer) * BlockParams::size(D, F), D, F);
    // This layer's partial row: ln1 scale, ln1 bias, b1, b2, ln2 scale, ln2 bias.
    float* pl = part + 2 * D + layer * (5 * D + F);
    float* ghp = arr(layer, wk.ghp, F);

    // x_out = LN2(x1 + dropout(hf . w2 + b2)); g_h2 over LN2's xhat
    ln_bwd(g, sD, a.xh2, a.rs + 1, 2, w.ln2_s, ga, sD, pl + 3 * D + F, pl + 4 * D + F, M, D);
    __syncthreads();
    keep_rows(drop, site_ffn_out(layer, H), tl, L, D, [&](int r, int c, float kp) {
      a.xh2[static_cast<size_t>(r) * D + c] = ga[static_cast<size_t>(r) * sD + c] * kp;
    });
    __syncthreads();
    col_sum(a.xh2, D, M, D, pl + 2 * D + F);
    product(ring, a.xh2, D, M, [&](int r, int c, float v0, float v1) {
      const size_t o = static_cast<size_t>(r) * F + c;
      ghp[o] = a.hf[o] > 0.f ? v0 : 0.f;
      if (c + 1 < F) ghp[o + 1] = a.hf[o + 1] > 0.f ? v1 : 0.f;
    });
    __syncthreads();
    col_sum(ghp, F, M, F, pl + 2 * D);
    product(ring, ghp, F, M, [&](int r, int c, float v0, float v1) {
      const size_t o = static_cast<size_t>(r) * sD + c;
      gc[o] = ga[o] + v0;
      if (c + 1 < D) gc[o + 1] = ga[o + 1] + v1;
    });
    __syncthreads();

    // x1 = LN1(x_in + dropout(ctx . wo)); g_o2 over LN1's xhat
    ln_bwd(gc, sD, a.xh1, a.rs, 2, w.ln1_s, ga, sD, pl, pl + D, M, D);
    __syncthreads();
    keep_rows(drop, site_attn_out(layer, H), tl, L, D, [&](int r, int c, float kp) {
      a.xh1[static_cast<size_t>(r) * D + c] = ga[static_cast<size_t>(r) * sD + c] * kp;
    });
    __syncthreads();
    product(ring, a.xh1, D, M, [&](int r, int c, float v0, float v1) {
      const size_t o = static_cast<size_t>(r) * sD + c;
      go[o] = v0;
      if (c + 1 < D) go[o + 1] = v1;
    });
    __syncthreads();

    // q|k staged over the tile's res and g, both free until g's product
    attention_bwd(a, go, sD, gt, s3D, ta.res, ta.S, ta.KP, layer, tl, d, inv_sqrt_dk, drop);
    for (int r = threadIdx.x >> 5; r < M; r += kThreads / 32)
      for (int c = threadIdx.x & 31; c < 3 * D; c += 32)
        a.qkv_stash[static_cast<size_t>(r) * 3 * D + c] = gt[static_cast<size_t>(r) * s3D + c];
    // g = grad of x_in: wq, wk, wv side by side, one product over 3D
    product(ring, gt, s3D, M, [&](int r, int c, float v0, float v1) {
      const size_t o = static_cast<size_t>(r) * sD + c;
      g[o] = ga[o] + v0;
      if (c + 1 < D) g[o + 1] = ga[o + 1] + v1;
    });
    __syncthreads();
  }

  // Input dropout, input LayerNorm, gx and the tile's position rows.
  if (drop.on) {
    keep_rows(drop, 0u, tl, L, D, [&](int r, int c, float kp) {
      g[static_cast<size_t>(r) * sD + c] *= kp;
    });
    __syncthreads();
  }
  ln_bwd(g, sD, xh0, rs0, 1, ln0, ga, sD, part, part + D, M, D);
  __syncthreads();
  for (int r = threadIdx.x >> 5; r < M; r += kThreads / 32)
    for (int c = threadIdx.x & 31; c < D; c += 32)
      gx[(r0 + r) * D + c] = ga[static_cast<size_t>(r) * sD + c];
  for (int i = threadIdx.x; i < L * D; i += kThreads) {
    const int l = i / D, c = i - l * D;
    float acc = 0.f;
    for (int j = 0; j < tl.n; ++j) acc += ga[static_cast<size_t>(j * L + l) * sD + c];
    part[wk.Q + i] = acc;
  }
}

// ---------------------------------------------------------------------
// 4. The weight-gradient pass.
// ---------------------------------------------------------------------

constexpr int kWgThreads = 128;  // one warpgroup: a 64 x 64 dW tile
constexpr int kWgSmem = 1024 + 4 * kF32Tile;
constexpr int kWgSumThreads = 128;

__host__ __device__ inline int wg_tiles_per_layer(const EncoderDims& d) {
  const int tD = nt64(d.D), tF = nt64(d.F), t3D = nt64(3 * d.D);
  return tD * t3D + tD * tD + 2 * tD * tF;
}

// One operand chunk, rows r0 .. r0 + 63 of the fp32 rows src (row stride
// w; R rows), columns c0 .. c0 + 63 (below n), a thread's 32 values in
// registers (load_t, all loads in flight at once), then split and
// transposed into the K-major tiles hi and lo (element (column, row) at
// f32_offset; store_t).
constexpr int kWgPer = 64 * 64 / kWgThreads;  // a thread's values of a 64 x 64 chunk

__device__ __forceinline__ void load_t(float (&v)[kWgPer], const float* src, int w, int R, int r0,
                                       int c0, int n) {
#pragma unroll
  for (int k = 0; k < kWgPer; ++k) {
    const int i = threadIdx.x + k * kWgThreads, row = r0 + (i >> 6), col = c0 + (i & 63);
    v[k] = row < R && col < n ? src[static_cast<size_t>(row) * w + col] : 0.f;
  }
}

__device__ __forceinline__ void store_t(unsigned char* hi, unsigned char* lo,
                                        const float (&v)[kWgPer]) {
#pragma unroll
  for (int k = 0; k < kWgPer; ++k) {
    const int i = threadIdx.x + k * kWgThreads, o = f32_offset(i & 63, i >> 6);
    const float h = tf32_round(v[k]);
    *reinterpret_cast<float*>(hi + o) = h;
    *reinterpret_cast<float*>(lo + o) = tf32_round(v[k] - h);
  }
}

__global__ void __launch_bounds__(kWgThreads, 1)
    user_encoder_wgrad_f32_kernel(const char* __restrict__ work, float* __restrict__ gparams,
                                  EncoderDims d, int B, int G, int n_tiles) {
  extern __shared__ __align__(16) unsigned char smem_wg[];
  const F32Work wk(B, d, G, 0);
  const int D = d.D, F = d.F, L = d.L, R = B * L;
  if (static_cast<int>(blockIdx.x) >= n_tiles) {
    const int idx = (blockIdx.x - n_tiles) * kWgSumThreads + threadIdx.x;
    const float* part = reinterpret_cast<const float*>(work + wk.part);
    if (idx < wk.Q) {
      float acc = 0.f;
      for (int b = 0; b < wk.nblk; ++b) acc += part[static_cast<size_t>(b) * wk.Qp + idx];
      gparams[tc::small_param_index(idx, d)] = acc;
    } else if (idx < wk.Q + d.n_position * D) {
      const int i = idx - wk.Q;
      float acc = 0.f;
      if (i < L * D)
        for (int b = 0; b < wk.nblk; ++b) acc += part[static_cast<size_t>(b) * wk.Qp + wk.Q + i];
      gparams[i] = acc;
    }
    return;
  }
  const int tD = nt64(D), tF = nt64(F), t3D = nt64(3 * D);
  const int per_layer = wg_tiles_per_layer(d);
  const int layer = blockIdx.x / per_layer;
  int r = blockIdx.x - layer * per_layer;
  const char* wl = work + layer * wk.layer;
  float* blk = gparams + static_cast<size_t>(d.n_position) * D + 2 * D +
               static_cast<size_t>(layer) * BlockParams::size(D, F);
  long long ao, go;
  int wa, wg, Kw, Ng, Nm, tn;
  float* out;
  if (r < tD * t3D) {  // wq | wk | wv
    ao = wk.xin, wa = D, go = wk.qkv, wg = 3 * D, Kw = D, Ng = 3 * D, Nm = D, tn = t3D, out = blk;
  } else if ((r -= tD * t3D) < tD * tD) {  // wo
    ao = wk.ctx, wa = D, go = wk.xh1, wg = D, Kw = D, Ng = D, Nm = D, tn = tD;
    out = blk + 3 * static_cast<size_t>(D) * D;
  } else if ((r -= tD * tD) < tD * tF) {  // w1
    ao = wk.x1, wa = D, go = wk.ghp, wg = F, Kw = D, Ng = F, Nm = F, tn = tF;
    out = blk + 4 * static_cast<size_t>(D) * D + 2 * D;
  } else {  // w2
    r -= tD * tF;
    ao = wk.hf, wa = F, go = wk.xh2, wg = D, Kw = F, Ng = D, Nm = D, tn = tD;
    out = blk + 4 * static_cast<size_t>(D) * D + 2 * D + static_cast<size_t>(D) * F + F;
  }
  const float* A = reinterpret_cast<const float*>(wl + ao);
  const float* Gm = reinterpret_cast<const float*>(wl + go);
  const int k0 = (r / tn) * 64, n0 = (r % tn) * 64;
  unsigned char* base = align1024(smem_wg);
  unsigned char *ah = base, *al = base + kF32Tile, *gh = base + 2 * kF32Tile,
                *gl = base + 3 * kF32Tile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  float sum[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) sum[i] = 0.f;
  // The next chunk's rows load into registers while this chunk's products run.
  float va[kWgPer], vg[kWgPer];
  load_t(va, A, wa, R, 0, k0, Kw);
  load_t(vg, Gm, wg, R, 0, n0, Ng);
#pragma unroll 1
  for (int c0 = 0; c0 < R; c0 += 64) {
    store_t(ah, al, va);
    store_t(gh, gl, vg);
    sm90::fence_async_shared();
    __syncthreads();
    float acc[32];
    sm90::fence_acc(acc);
    sm90::wgmma_fence();
    mma3_ss(acc, sm90::smem_u32(ah), sm90::smem_u32(al), sm90::smem_u32(gh), sm90::smem_u32(gl), 0);
    sm90::wgmma_commit();
    if (c0 + 64 < R) {
      load_t(va, A, wa, R, c0 + 64, k0, Kw);
      load_t(vg, Gm, wg, R, c0 + 64, n0, Ng);
    }
    sm90::wgmma_wait<0>();
    sm90::fence_acc(acc);
#pragma unroll
    for (int i = 0; i < 32; ++i) sum[i] += acc[i];  // chunk sums in fp32, as the products'
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = k0 + 16 * warp + g + 8 * (e >> 1), n = n0 + 8 * j + 2 * t + (e & 1);
      if (k < Kw && n < Ng) {
        const int m = n / Nm;
        out[static_cast<size_t>(m) * Kw * Nm + static_cast<size_t>(k) * Nm + (n - m * Nm)] =
            sum[4 * j + e];
      }
    }
}

float inv_sqrt_dk(const EncoderDims& d) {
  return static_cast<float>(1.0 / sqrt(static_cast<double>(d.D / d.H)));
}

}  // namespace
}  // namespace f32
}  // namespace iisan

// params: the packed fp32 parameter vector; image: image_floats fp32
// (checked), which receives the weight image (F32Image): its forward part,
// and with bwd its backward part after it.  Returns the CUDA error of the
// launch.
extern "C" int iisan_user_encoder_f32_weights(const void* params, void* image,
                                              long long image_floats, int D, int F, int n_layers,
                                              int n_position, int bwd, void* stream) {
  using namespace iisan;
  using namespace iisan::f32;
  const F32Image im(D, F);
  const long long n = im.floats(n_layers, bwd != 0);
  if (n > image_floats) return static_cast<int>(cudaErrorInvalidValue);
  const EncoderDims dims{0, D, 1, F, n_layers, n_position};
  const unsigned grid = static_cast<unsigned>(std::min<long long>((n + 255) / 256, 8192));
  user_encoder_f32_weights_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(params), static_cast<float*>(image), dims, n);
  return static_cast<int>(cudaGetLastError());
}

// x, out (B, L, D) fp32; mask (B, L, L) fp32; params: the packed fp32
// parameter vector; image: its weight image, at least the forward part
// (image_floats, checked); scratch: scratch_bytes of device memory, the
// tiles' scratch where their areas do not fit shared memory (checked),
// else null.  Dropout is on when rate > 0: Philox key `seed`, keep factor
// `scale` (1/(1-rate) in fp32).  n_sm: the SMs the tiles are planned for
// (tile_plan; the caller passes the card's count).  Returns the CUDA error
// of the launch.
extern "C" int iisan_user_encoder_f32_fwd(const void* x, const void* mask, const void* params,
                                          const void* image, long long image_floats, void* out,
                                          void* scratch, long long scratch_bytes, int B, int L,
                                          int D, int H, int F, int n_layers, int n_position,
                                          int seed, float rate, float scale, int n_sm,
                                          void* stream) {
  using namespace iisan;
  using namespace iisan::f32;
  const EncoderDims dims{L, D, H, F, n_layers, n_position};
  if (n_sm < 1) return static_cast<int>(cudaErrorInvalidValue);
  const TilePlan plan = tile_plan(dims, false, B, n_sm);
  const int nblk = (B + plan.G - 1) / plan.G;
  if (F32Image(D, F).floats(n_layers, false) > image_floats ||
      scratch_bytes < nblk * plan.scratch || (plan.scratch > 0 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = allow_smem(user_encoder_fwd_f32_kernel, plan.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  user_encoder_fwd_f32_kernel<<<nblk, kThreads, plan.smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(mask),
      static_cast<const float*>(params), static_cast<const float*>(image),
      static_cast<float*>(out), static_cast<float*>(scratch), plan, dims, B, inv_sqrt_dk(dims),
      make_dropout(seed, rate, scale));
  return static_cast<int>(cudaGetLastError());
}

// The sweep: x, gout, gx (B, L, D) fp32; mask (B, L, L) fp32; params the
// packed fp32 parameter vector and image its full weight image
// (image_floats, checked); work: the device buffer of F32Work's layout,
// work_bytes long (checked).  Dropout and n_sm as
// iisan_user_encoder_f32_fwd.  Returns the CUDA error of the launch.
extern "C" int iisan_user_encoder_f32_bwd(const void* x, const void* mask, const void* params,
                                          const void* image, long long image_floats,
                                          const void* gout, void* gx, void* work,
                                          long long work_bytes, int B, int L, int D, int H, int F,
                                          int n_layers, int n_position, int seed, float rate,
                                          float scale, int n_sm, void* stream) {
  using namespace iisan;
  using namespace iisan::f32;
  const EncoderDims dims{L, D, H, F, n_layers, n_position};
  if (n_sm < 1) return static_cast<int>(cudaErrorInvalidValue);
  const TilePlan plan = tile_plan(dims, true, B, n_sm);
  const F32Work wk(B, dims, plan.G, plan.scratch);
  if (F32Image(D, F).floats(n_layers, true) > image_floats || wk.total > work_bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = allow_smem(user_encoder_bwd_f32_kernel, plan.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  user_encoder_bwd_f32_kernel<<<wk.nblk, kThreads, plan.smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(mask),
      static_cast<const float*>(params), static_cast<const float*>(image),
      static_cast<const float*>(gout), static_cast<float*>(gx), static_cast<char*>(work), plan,
      dims, B, inv_sqrt_dk(dims), make_dropout(seed, rate, scale));
  return static_cast<int>(cudaGetLastError());
}

// The weight-gradient pass over the sweep's buffer: writes every entry of
// gparams (P floats, the packed order); n_sm the sweep's.  Returns the
// CUDA error of the launch.
extern "C" int iisan_user_encoder_f32_wgrad(const void* work, long long work_bytes, void* gparams,
                                            int B, int L, int D, int H, int F, int n_layers,
                                            int n_position, int n_sm, void* stream) {
  using namespace iisan;
  using namespace iisan::f32;
  const EncoderDims dims{L, D, H, F, n_layers, n_position};
  if (n_sm < 1) return static_cast<int>(cudaErrorInvalidValue);
  const TilePlan plan = tile_plan(dims, true, B, n_sm);
  const F32Work wk(B, dims, plan.G, 0);
  if (wk.scratch > work_bytes) return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = n_layers * wg_tiles_per_layer(dims);
  const int n_sums = (wk.Q + n_position * D + kWgSumThreads - 1) / kWgSumThreads;
  cudaError_t err = allow_smem(user_encoder_wgrad_f32_kernel, kWgSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  user_encoder_wgrad_f32_kernel<<<n_tiles + n_sums, kWgThreads, kWgSmem,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char*>(work), static_cast<float*>(gparams), dims, B, plan.G, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

// The fp32 route's layout at these shapes, the one source of its offsets
// for code that reads the device buffers (ops/fused_user_encoder.py's
// `f32_tile_plan`, `f32_image_floats` and `f32_work_layout` repeat it, and
// are held to it), for tiles planned for n_sm SMs.  out receives, as long
// longs: the forward's sequences a tile, placement, shared-memory bytes
// and per-tile scratch bytes; the backward's the same four; the weight
// image's fp32 entries, forward part and whole; F32Work's byte offsets
// xin, ctx, x1, hf, qkv, xh1, xh2, ghp, p, rs and layer, xh0, rs0, part,
// scratch and total; its partial row's floats.  Returns the count of
// values, or -1 when n is smaller or n_sm below 1.
extern "C" int iisan_user_encoder_f32_layout(int B, int L, int D, int H, int F, int n_layers,
                                             int n_position, int n_sm, long long* out, int n) {
  using namespace iisan;
  using namespace iisan::f32;
  constexpr int kCount = 27;
  if (n < kCount || n_sm < 1) return -1;
  const EncoderDims dims{L, D, H, F, n_layers, n_position};
  const TilePlan fp = tile_plan(dims, false, B, n_sm), bp = tile_plan(dims, true, B, n_sm);
  const F32Work wk(B, dims, bp.G, bp.scratch);
  const F32Image im(D, F);
  const long long v[kCount] = {fp.G, fp.place, fp.smem, fp.scratch, bp.G, bp.place, bp.smem,
                               bp.scratch, im.floats(n_layers, false), im.floats(n_layers, true),
                               wk.xin, wk.ctx, wk.x1, wk.hf, wk.qkv, wk.xh1, wk.xh2, wk.ghp, wk.p,
                               wk.rs, wk.layer, wk.xh0, wk.rs0, wk.part, wk.scratch, wk.total,
                               wk.Qp};
  for (int i = 0; i < kCount; ++i) out[i] = v[i];
  return kCount;
}
