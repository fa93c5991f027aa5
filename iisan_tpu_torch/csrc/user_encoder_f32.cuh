// The fused SASRec user encoder's fp32 route on Hopper's tensor cores: the
// tile body shared by the forward kernel and the backward's sweep
// (user_encoder_f32.cu), the weight image and stream they read, and their
// layouts.
//
// The function and its cast chain are the JAX kernel's `_encoder_fwd_body`
// at fp32 (every rounding to the compute type is the identity): products
// of fp32 operands with fp32 sums, an fp32 softmax over the additive mask,
// fp32 LayerNorm statistics, Philox dropout drawn where it is applied (by
// (seed, sequence, site, element), the plain version's masks).
//
// Tiles.  A block takes the rows of whole sequences, up to as many as fill
// a 64-row m-tile (six at L = 10, three at L = 20, one at L = 50; a
// sequence longer than 64 rows takes several m-tiles in one block), so the
// block streams each weight once for all of them; but no more than it
// takes to give every SM a tile, since the tile's CUDA-core phases grow
// with its rows (`tile_plan`).  A sequence never splits across blocks, so
// attention, its softmax and the dropout bits stay within one block.  At
// large widths a tile takes fewer sequences where that keeps its areas in
// shared memory.
//
// Products.  Every weight product (q|k|v, output, FFN in, FFN out, and the
// backward's input-gradient products through the same matrices) runs on
// wgmma m64n64k8 .tf32 in three passes (tf32.cuh): the activations are the
// register A operand, read from their fp32 areas and split in registers;
// the weights the shared B operand.  A block is two warpgroups; a
// product's 64-column output tiles alternate between them.
//
// Weights.  A small kernel copies the packed fp32 parameters once a call
// into an image of fp32 64 x 64 tiles (F32Image), each laid out as the B
// operand lands in shared memory (K-major, 128-byte swizzle) and padded
// with zeros, so that one bulk copy brings a tile: the forward part holds
// W^T's tiles (rows the outputs, K the inputs), the backward part W's
// (rows the inputs, K the outputs, for g . W^T).  The block streams the
// tiles of its products, in the order it uses them, through a ring of
// kStages stages on mbarriers; the warpgroup that takes a chunk splits its
// tile in the stage into TF32 hi (over the tile) and lo (beside it).  A
// warpgroup that has finished with a stage issues the tile kStages further
// on into it, across the ends of products, so the first tiles of a product
// land while the attention and LayerNorms before it run.  A chunk needs no
// barrier of the block: each thread waits on the stage's mbarrier, the
// warpgroup's own barrier orders the split before its wgmmas, and they
// have read the stage once any of its threads has waited for them.
//
// Attention.  The score and P.V products are per (sequence, head), about
// 2% of the FLOPs at the main path's shape: fp32 on the CUDA cores, the
// softmax over each sequence's own L keys, so no entry crosses sequences,
// and a row whose keys are all masked gets the uniform softmax over them.
//
// Areas.  A tile's activations (fp32 rows, row strides of 4 mod 32 floats,
// so that fragment loads hit distinct banks) live in shared memory where
// they fit beside the ring (kResident) and otherwise in a per-tile scratch
// in device memory (kSpilled); every access is a plain load or store, so
// the code is the same.  The backward's sweep keeps each layer's values in
// its device buffer (F32Work), where the weight-gradient pass reads them.
#pragma once

#include <cfloat>

#include "common.cuh"
#include "philox.cuh"
#include "sm90_gemm.cuh"
#include "tf32.cuh"
#include "user_encoder.cuh"

namespace iisan {
namespace f32 {

using namespace tf32;

constexpr int kThreads = 256;      // two warpgroups
constexpr int kStages = 3;         // weight tiles in flight
constexpr int kTileFloats = 4096;     // a 64 x 64 fp32 weight tile
constexpr int kStageBytes = 2 * kF32Tile;  // the tile (then its hi half) and its lo half
constexpr int kSmemBytes = 232448;
// The ring: alignment slack, the stages, barriers.
constexpr int kRingBytes = 1024 + kStages * kStageBytes + 64;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int nt64(int n) { return cdiv(n, 64); }
// Row stride (floats) of an area n columns wide: 4 mod 32.
__host__ __device__ inline int lds(int n) { return (n + 31) / 32 * 32 + 4; }
__host__ __device__ inline long long a16(long long n) { return (n + 15) / 16 * 16; }
__host__ __device__ inline long long take(long long& at, long long bytes) {
  const long long o = at;
  at = a16(at + bytes);
  return o;
}

// The weight image: per layer the tiles of q|k|v (D x 3D), wo (D x D), w1
// (D x F) and w2 (F x D).  Matrix W (K, N) has nt64(N) x nt64(K) tiles,
// tile (o, r) at o * n_red + r: the forward part's tile (o, r) holds
// W[64 r + c][64 o + row] at (row, c), the backward part's W[64 o +
// row][64 r + c], each element at byte f32_offset(row, c) of the tile.
struct F32Image {
  int D, F, tD, t3D, tF;
  long long t1, t2, t3, layer;  // first tiles of wo, w1, w2 in a layer; tiles a layer
  __host__ __device__ F32Image(int D_, int F_)
      : D(D_), F(F_), tD(nt64(D_)), t3D(nt64(3 * D_)), tF(nt64(F_)) {
    t1 = static_cast<long long>(t3D) * tD;
    t2 = t1 + static_cast<long long>(tD) * tD;
    t3 = t2 + static_cast<long long>(tF) * tD;
    layer = t3 + static_cast<long long>(tD) * tF;
  }
  // The first tile of matrix m in a layer (scalars, not an array: no
  // local memory where m is not known at compile time).
  __host__ __device__ long long first(int m) const {
    return m == 0 ? 0 : m == 1 ? t1 : m == 2 ? t2 : t3;
  }
  // W's shape (K, N) of matrix m.
  __host__ __device__ void shape(int m, int& K, int& N) const {
    K = m == 3 ? F : D;
    N = m == 0 ? 3 * D : m == 2 ? F : D;
  }
  // fp32 entries of the forward part, and with the backward part.
  __host__ __device__ long long floats(int n_layers, bool bwd) const {
    return (bwd ? 2 : 1) * layer * n_layers * kTileFloats;
  }
};

// One product of the stream: out (M, n_out) = A (M, n_red) . B, in
// `out` 64-column output tiles and `red` 64-wide reduction chunks.
struct Prod {
  int out, red, n_out, n_red;
  long long tile0;  // its matrix's first tile in the image
};

// Product p of a sweep over the layers: 0 .. 4 n_layers - 1 the forward's
// (layer-major; q|k|v, o, FFN in, FFN out), then the backward's (layers
// n_layers - 1 .. 0; FFN out, FFN in, o, q|k|v, through W^T).
__host__ __device__ inline Prod prod_of(const F32Image& im, int n_layers, int p) {
  const bool bwd = p >= 4 * n_layers;
  const int q = bwd ? p - 4 * n_layers : p;
  const int layer = bwd ? n_layers - 1 - q / 4 : q / 4, m = bwd ? 3 - q % 4 : q % 4;
  int K, N;
  im.shape(m, K, N);
  Prod r;
  r.n_out = bwd ? K : N;
  r.n_red = bwd ? N : K;
  r.out = nt64(r.n_out);
  r.red = nt64(r.n_red);
  r.tile0 = (bwd ? im.layer * n_layers : 0) + layer * im.layer + im.first(m);
  return r;
}

// The order of a product's chunks in the stream.  Output tile units (pass
// * out + o) go to the two warpgroups in turn, and a pair's chunks
// alternate, so the warpgroups draw on the ring in turn; a product of one
// unit splits its reduction chunks between them (the first half to
// warpgroup 0), again alternating.  chunk_index gives the position of
// unit u's chunk rt, chunk_at the inverse.
__host__ __device__ inline bool k_split(int units, int red) { return units == 1 && red >= 2; }

__host__ __device__ inline int chunk_index(int units, int red, int u, int rt) {
  if (k_split(units, red)) {
    const int h = (red + 1) / 2, n1 = red - h, w = rt >= h, i = w ? rt - h : rt;
    return i < n1 ? 2 * i + w : 2 * n1 + (i - n1);
  }
  const int pair = u / 2, both = 2 * pair + 1 < units;
  return pair * 2 * red + rt * (both ? 2 : 1) + (u & 1);
}

__host__ __device__ inline void chunk_at(int units, int red, int c, int& u, int& rt) {
  if (k_split(units, red)) {
    const int h = (red + 1) / 2, n1 = red - h;
    const int w = c < 2 * n1 ? c & 1 : 0, i = c < 2 * n1 ? c >> 1 : c - n1;
    u = 0;
    rt = w ? h + i : i;
    return;
  }
  const int pair = c / (2 * red), rem = c - pair * 2 * red;
  const bool both = 2 * pair + 1 < units;
  u = 2 * pair + (both ? rem & 1 : 0);
  rt = both ? rem >> 1 : rem;
}

// The weight ring (shared memory), with the stream's counters.  Every
// consumer thread walks the same products in the same order (`next_prod`,
// `next`).  A thread that issues chunks (thread 0 of each warpgroup)
// issues them nearly in increasing order, so it finds their tiles with a
// cursor over the products (`tile_of`).
struct Ring {
  unsigned char* stages;  // kStages tile pairs, 1024-aligned
  uint64_t* full;
  const float* image;
  F32Image im;
  int n_layers, n_prods, n_pass, p, next, total;
  Prod cur;                // the issue cursor's product,
  int cur_q, cur_c0, cur_n;  // its index, first chunk and chunks

  __device__ Ring(unsigned char* base, const float* image_, const EncoderDims& d, int n_prods_,
                  int n_pass_)
      : stages(base), full(reinterpret_cast<uint64_t*>(base + kStages * kStageBytes)),
        image(image_),
        im(d.D, d.F), n_layers(d.n_layers), n_prods(n_prods_), n_pass(n_pass_), p(0), next(0) {
    total = 0;
    for (int q = 0; q < n_prods; ++q) {
      const Prod pr = prod_of(im, n_layers, q);
      total += n_pass * pr.out * pr.red;
    }
    cur = prod_of(im, n_layers, 0);
    cur_q = cur_c0 = 0;
    cur_n = n_pass * cur.out * cur.red;
  }
  __device__ unsigned char* stage(int c) const { return stages + (c % kStages) * kStageBytes; }
  // The image tile of chunk c of the stream (from the product of the last
  // chunk asked on; the first product where c lies before it).
  __device__ long long tile_of(int c) {
    if (c < cur_c0) {
      cur = prod_of(im, n_layers, 0);
      cur_q = cur_c0 = 0;
      cur_n = n_pass * cur.out * cur.red;
    }
    while (c >= cur_c0 + cur_n) {
      cur_c0 += cur_n;
      cur = prod_of(im, n_layers, ++cur_q);
      cur_n = n_pass * cur.out * cur.red;
    }
    int u, rt;
    chunk_at(n_pass * cur.out, cur.red, c - cur_c0, u, rt);
    return cur.tile0 + static_cast<long long>(u % cur.out) * cur.red + rt;
  }
  // One thread: chunk c into its stage (nothing past the stream's end).
  __device__ void issue(int c) {
    if (c >= total) return;
    uint64_t* bar = &full[c % kStages];
    sm90::mbar_expect_tx(bar, kF32Tile);
    sm90::bulk_load(stage(c), image + tile_of(c) * kTileFloats, kF32Tile, bar);
  }
  // Thread 0, before the block's first barrier: the barriers and the
  // first kStages chunks.
  __device__ void start() {
    for (int s = 0; s < kStages; ++s) sm90::mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int c = 0; c < kStages; ++c) issue(c);
  }
  __device__ Prod next_prod() { return prod_of(im, n_layers, p++); }
};

// The A fragments (hi, lo) of rows r0, r0 + 8 and reduction columns k0 ..
// k0 + 63 of the fp32 rows A (row stride lda); rows past M and columns past
// K are zeros.
__device__ __forceinline__ void load_frags(Frags& f, const float* A, int lda, int r0, int M,
                                           int k0, int K) {
  const int t = threadIdx.x & 3;
  const bool ok0 = r0 < M, ok1 = r0 + 8 < M;
  const float* a0 = A + static_cast<size_t>(ok0 ? r0 : 0) * lda;
  const float* a1 = A + static_cast<size_t>(ok1 ? r0 + 8 : 0) * lda;
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const int ka = k0 + 8 * s + t, kb = ka + 4;
    const float v[4] = {ok0 && ka < K ? a0[ka] : 0.f, ok1 && ka < K ? a1[ka] : 0.f,
                        ok0 && kb < K ? a0[kb] : 0.f, ok1 && kb < K ? a1[kb] : 0.f};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float h = tf32_round(v[r]);
      f.hi[s][r] = __float_as_uint(h);
      f.lo[s][r] = __float_as_uint(tf32_round(v[r] - h));
    }
  }
}

// d += a . b over a whole 64-wide chunk in three TF32 passes (mma3_rs
// with all eight k8 steps: the image's tiles and the fragments are zero
// past K, and straight-line wgmmas pipeline where a data-dependent count
// would serialise them).
__device__ __forceinline__ void mma3_chunk(float (&d)[32], Frags& f, uint32_t bh, uint32_t bl) {
  fence_frags(f);
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    wgmma_tf32_rs(d, f.lo[s], f32_desc(bh, s), 1);
    wgmma_tf32_rs(d, f.hi[s], f32_desc(bl, s), 1);
    wgmma_tf32_rs(d, f.hi[s], f32_desc(bh, s), 1);
  }
}

// The stream's next product over the M rows of A (fp32, row stride lda):
// epi(row, col, sum of col, sum of col + 1) for every row < M and even
// column < n_out of the output (col + 1 may be past it).  Both warpgroups
// call it; a warpgroup takes every other output tile unit, or half the
// chunks of a product of one unit, whose two sums warpgroup 0 adds (its
// own first) before the epilogue.  Per chunk: the fragments of A, the
// wait for the tile, its split into hi and lo (the warpgroup's barrier
// after it), the three passes into a fresh accumulator, then the stage's
// release, which issues the chunk kStages on.  A chunk's sum is added to
// the output's in fp32 on the CUDA cores: the tensor cores' own fp32
// accumulation drops low bits of each addend, which at K in the thousands
// moved sums past 1e-4 of the fp32 product.  Ends with no barrier: the
// caller syncs before reading the output.
template <typename Epi>
__device__ void product(Ring& ring, const float* A, int lda, int M, Epi epi) {
  const Prod pr = ring.next_prod();
  // The warpgroup index as a value the compiler knows to be warp-uniform
  // (a broadcast), so that the wgmmas below are not taken for divergent
  // code and serialised.
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0), lt = threadIdx.x & 127, warp = lt >> 5;
  const int g = (lt & 31) >> 2, t = lt & 3;
  const int units = ring.n_pass * pr.out, base = ring.next;
  const bool split = k_split(units, pr.red);
  const int h = (pr.red + 1) / 2;
  ring.next += units * pr.red;
  for (int u = split ? 0 : wg; u < units; u += 2) {
    const int pass = u / pr.out, o = u - pass * pr.out;
    const int r0 = pass * 64 + 16 * warp + g;
    float sum[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sum[i] = 0.f;
    const int rt0 = split && wg ? h : 0, rt1 = split && !wg ? h : pr.red;
    int done = -1;  // the last chunk whose stage this warpgroup has finished with
#pragma unroll 1
    for (int rt = rt0; rt < rt1; ++rt) {
      const int c = base + chunk_index(units, pr.red, u, rt), k0 = rt * 64;
      Frags f;
      load_frags(f, A, lda, r0, M, k0, pr.n_red);
      unsigned char* stage = ring.stage(c);
      const uint32_t st = sm90::smem_u32(stage);
      sm90::mbar_wait(&ring.full[c % kStages], (c / kStages) & 1);
      split_tile<128>(stage, stage, stage + kF32Tile);
      sm90::fence_async_shared();  // the split before the wgmmas read it
      sm90::warpgroup_sync(1 + wg);
      float acc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
      sm90::fence_acc(acc);
      sm90::wgmma_fence();
      mma3_chunk(acc, f, st, st + kF32Tile);
      sm90::wgmma_commit();
      // The previous chunk's refill is issued while this chunk's wgmmas run.
      if (lt == 0 && done >= 0) ring.issue(done + kStages);
      sm90::wgmma_wait<0>();
      sm90::fence_acc(acc);
#pragma unroll
      for (int i = 0; i < 32; ++i) sum[i] += acc[i];
      // Warpgroup 1's last stage of a split product carries its sums first.
      done = split && wg == 1 && rt + 1 == rt1 ? -1 : c;
    }
    if (lt == 0 && done >= 0) ring.issue(done + kStages);
    if (split) {  // warpgroup 1's sums through its last stage, thread by thread
      float* part = reinterpret_cast<float*>(ring.stage(base + chunk_index(units, pr.red, 0, pr.red - 1)));
      if (wg == 1) {
#pragma unroll
        for (int i = 0; i < 32; ++i) part[i * 128 + lt] = sum[i];
        sm90::fence_async_shared();
      }
      __syncthreads();
      if (wg == 1) return;
#pragma unroll
      for (int i = 0; i < 32; ++i) sum[i] += part[i * 128 + lt];
      sm90::fence_async_shared();  // the reads before the stage's next bulk copy
      sm90::warpgroup_sync(1);
      if (lt == 0) ring.issue(base + chunk_index(units, pr.red, 0, pr.red - 1) + kStages);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = r0 + 8 * half, col = o * 64 + 8 * j + 2 * t;
        if (row < M && col < pr.n_out) epi(row, col, sum[4 * j + 2 * half], sum[4 * j + 2 * half + 1]);
      }
  }
}

// The block's rows: sequences b0 .. b0 + n - 1, M = n L rows.
struct Tile {
  int b0, n, M;
};

// f(r, c, keep) over the tile's rows r and columns c < D of an (L, D)
// site: keep its scaled keep factor, 1 when dropout is off.  A thread
// draws one Philox counter of a sequence and uses its four words for four
// consecutive elements (philox.cuh's addressing: the plain version's
// masks).
template <typename Fn>
__device__ __forceinline__ void keep_rows(const Dropout& drop, unsigned site, const Tile& tl,
                                          int L, int D, Fn f) {
  const int n = L * D, nc = (n + 3) / 4;
  if (!drop.on) {
    for (int i = threadIdx.x; i < tl.M * D; i += kThreads) f(i / D, i % D, 1.f);
    return;
  }
  for (int i = threadIdx.x; i < tl.n * nc; i += kThreads) {
    const int j = i / nc, c = i - j * nc;
    const uint4 r = drop.bits4(site, static_cast<unsigned>(tl.b0 + j), static_cast<unsigned>(c));
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = 4 * c + u;
      if (e < n) f(j * L + e / D, e % D, drop.keep_bits(w[u]));
    }
  }
}

// sum over i < n of the terms fma(i, s) adds to s, in blocks of 32 terms
// whose sums are added in order: the rounding error of a long dot product
// (a head 4,096 wide) grows with 32 + n / 32 terms, not n.  A block's terms
// go to four sums in turn (joined in a fixed order), so that four chains
// of dependent additions run side by side.
template <typename Fma>
__device__ __forceinline__ float blocked_sum(int n, Fma fma) {
  float total = 0.f;
  for (int i0 = 0; i0 < n; i0 += 32) {
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    const int e = min(n, i0 + 32);
    int i = i0;
    for (; i + 4 <= e; i += 4) {
#pragma unroll
      for (int k = 0; k < 4; ++k) s[k] = fma(i + k, s[k]);
    }
    for (; i < e; ++i) s[0] = fma(i, s[0]);
    total += (s[0] + s[1]) + (s[2] + s[3]);
  }
  return total;
}

// LayerNorm of the M rows pre (row stride ldp): out = xhat * scale + bias
// (row stride ldo), fp32 statistics; xhat (row stride ldx) and rstd (a
// value every rs_step floats) are kept where given.  A row takes a group
// of 16 lanes (32 past D = 256), several rows a round of the eight warps.
__device__ inline void layer_norm(const float* pre, int ldp, const float* __restrict__ scale,
                                  const float* __restrict__ bias, float* out, int ldo,
                                  float* xhat, int ldx, float* rstd, int rs_step, int M, int D) {
  const int gs = D <= 256 ? 16 : 32, rpw = 32 / gs;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, li = lane % gs;
  for (int base = warp * rpw; base < M; base += (kThreads / 32) * rpw) {
    const int r = base + lane / gs;
    const bool ok = r < M;
    const float* x = pre + static_cast<size_t>(ok ? r : 0) * ldp;
    float s = 0.f;
    for (int d = li; ok && d < D; d += gs) s += x[d];
    const float mu = group_sum(s, gs) / D;
    float v = 0.f;
    for (int d = li; ok && d < D; d += gs) {
      const float c = x[d] - mu;
      v = fmaf(c, c, v);
    }
    const float rs = rsqrtf(group_sum(v, gs) / D + kEps);
    if (!ok) continue;
    if (rstd != nullptr && li == 0) rstd[static_cast<size_t>(r) * rs_step] = rs;
    for (int d = li; d < D; d += gs) {
      const float xh = (x[d] - mu) * rs;
      if (xhat != nullptr) xhat[static_cast<size_t>(r) * ldx + d] = xh;
      if (out != nullptr) out[static_cast<size_t>(r) * ldo + d] = xh * __ldg(scale + d) + __ldg(bias + d);
    }
  }
}

// One layer's values: the forward writes them, the backward reads them.
// The inference forward keeps them in the tile's areas (xhat, p and rstd
// null); the sweep in its device buffer, rows of the whole batch.
struct LayerAreas {
  float *xin, *qkv, *ctx, *x1, *hf;
  int ldx, ldq, ldc, ld1, ldh;
  float *xh1, *xh2, *p, *rs;  // the backward's stash: LayerNorm xhats, probabilities, rstds
  float* qkv_stash;           // and q|k|v (row stride 3D), beside the tile's own copy
};

// Attention of one layer on the CUDA cores (`_attn_fwd`): per (sequence,
// head) the scores q k^T / sqrt(dk) + mask into S, the softmax (kept in p
// where given, (row, h L + m) per row), the dropped-out probabilities pd,
// and ctx = pd . v.  mb: the tile's first (L, L) mask.  Ends with a
// barrier.
__device__ inline void attention(const LayerAreas& a, const float* __restrict__ mb, float* S,
                                 int layer, const Tile& tl, const EncoderDims& d,
                                 float inv_sqrt_dk, const Dropout& drop) {
  const int L = d.L, D = d.D, H = d.H, dk = D / H, LL = L * L;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, n_warps = kThreads / 32;
  // A warp a (sequence, head), its lanes over (query, key).
  for (int pair = warp; pair < tl.n * H; pair += n_warps) {
    const int j = pair / H, h = pair - j * H;
    const float* qb = a.qkv + static_cast<size_t>(j * L) * a.ldq + h * dk;
    for (int lm = lane; lm < LL; lm += 32) {
      const float mv = __ldg(mb + j * LL + lm);
      const int l = lm / L, m = lm - l * L, c0 = m % dk;
      const float* q = qb + static_cast<size_t>(l) * a.ldq;
      const float* k = qb + static_cast<size_t>(m) * a.ldq + D;
      const float acc = blocked_sum(dk, [&](int i, float s) {
        const int c = c0 + i < dk ? c0 + i : c0 + i - dk;  // keys start at distinct banks
        return fmaf(q[c], k[c], s);
      });
      S[static_cast<size_t>(pair) * LL + lm] = acc * inv_sqrt_dk + mv;
    }
  }
  __syncthreads();
  // The softmax, a group of gs lanes a (sequence, head, query) row: the
  // fewest (a power of two) that see its keys in two steps.
  int gs = 1;
  while (gs < 32 && 2 * gs < L) gs *= 2;
  const int rpw = 32 / gs, n_rows = tl.n * H * L;
  for (int base = warp * rpw; base < n_rows; base += n_warps * rpw) {
    const int row = base + lane / gs, li = lane % gs;
    const bool ok = row < n_rows;
    float* sr = S + static_cast<size_t>(ok ? row : 0) * L;
    float mx = -FLT_MAX;
    for (int m = li; ok && m < L; m += gs) mx = fmaxf(mx, sr[m]);
    mx = group_max(mx, gs);
    float sum = 0.f;
    for (int m = li; ok && m < L; m += gs) {
      const float e = expf(sr[m] - mx);
      sr[m] = e;
      sum += e;
    }
    sum = group_sum(sum, gs);
    if (!ok) continue;
    const int j = row / (H * L), hl = row - j * H * L, h = hl / L, l = hl - h * L;
    float* pk = a.p != nullptr ? a.p + static_cast<size_t>(j * L + l) * H * L + h * L : nullptr;
    const unsigned site = site_probs(layer, h, H), b = static_cast<unsigned>(tl.b0 + j);
    for (int m = li; m < L; m += gs) {
      const float p = sr[m] / sum;
      if (pk != nullptr) pk[m] = p;
      sr[m] = drop.on ? p * drop.keep(site, b, static_cast<unsigned>(l * L + m)) : p;
    }
  }
  __syncthreads();
  for (int r = warp; r < tl.M; r += n_warps) {
    const int j = r / L, l = r - j * L;
    for (int c = lane; c < D; c += 32) {
      const float* pr = S + static_cast<size_t>((j * H + c / dk) * L + l) * L;
      const float* v = a.qkv + static_cast<size_t>(j * L) * a.ldq + 2 * D + c;
      a.ctx[static_cast<size_t>(r) * a.ldc + c] = blocked_sum(
          L, [&](int m, float s) { return fmaf(pr[m], v[static_cast<size_t>(m) * a.ldq], s); });
    }
  }
  __syncthreads();
}

// The whole encoder forward of a tile (`_encoder_fwd_body`): xb, mb the
// tile's first input row and mask; layer i's values where areas(i) says;
// res (M, D) the pre-LayerNorm sums (row stride ldr) and S the scores, in
// the tile's areas; the last layer's output to out (row stride D; null:
// not written); the input LayerNorm's xhat and rstd to xh0 / rs0 where
// given.  Ends with a barrier.
template <typename AreasOf>
__device__ void forward(const float* __restrict__ xb, const float* __restrict__ mb,
                        const float* __restrict__ params, const EncoderDims& d, const Tile& tl,
                        float inv_sqrt_dk, const Dropout& drop, Ring& ring, float* res, int ldr,
                        float* S, AreasOf areas, float* out, float* xh0, float* rs0) {
  const int L = d.L, D = d.D, F = d.F, H = d.H, M = tl.M;
  const float* pos = params;
  const float* ln0 = params + static_cast<size_t>(d.n_position) * D;
  const float* blocks = ln0 + 2 * D;
  for (int r = threadIdx.x >> 5; r < M; r += kThreads / 32)
    for (int c = threadIdx.x & 31; c < D; c += 32)
      res[static_cast<size_t>(r) * ldr + c] = xb[static_cast<size_t>(r) * D + c] + __ldg(pos + (r % L) * D + c);
  __syncthreads();
  {
    const LayerAreas a = areas(0);
    layer_norm(res, ldr, ln0, ln0 + D, a.xin, a.ldx, xh0, D, rs0, 1, M, D);
    __syncthreads();
    if (drop.on) {
      keep_rows(drop, 0u, tl, L, D, [&](int r, int c, float kp) {
        a.xin[static_cast<size_t>(r) * a.ldx + c] *= kp;
      });
      __syncthreads();
    }
  }
  for (int layer = 0; layer < d.n_layers; ++layer) {
    const LayerAreas a = areas(layer);
    const BlockParams w(blocks + static_cast<size_t>(layer) * BlockParams::size(D, F), D, F);
    product(ring, a.xin, a.ldx, M, [&](int r, int c, float v0, float v1) {
      float* q = a.qkv + static_cast<size_t>(r) * a.ldq + c;
      q[0] = v0;
      if (c + 1 < 3 * D) q[1] = v1;
      if (a.qkv_stash != nullptr) {
        float* qs = a.qkv_stash + static_cast<size_t>(r) * 3 * D + c;
        qs[0] = v0;
        if (c + 1 < 3 * D) qs[1] = v1;
      }
    });
    __syncthreads();
    attention(a, mb, S, layer, tl, d, inv_sqrt_dk, drop);

    product(ring, a.ctx, a.ldc, M, [&](int r, int c, float v0, float v1) {
      res[static_cast<size_t>(r) * ldr + c] = v0;
      if (c + 1 < D) res[static_cast<size_t>(r) * ldr + c + 1] = v1;
    });
    __syncthreads();
    keep_rows(drop, site_attn_out(layer, H), tl, L, D, [&](int r, int c, float kp) {
      float& o = res[static_cast<size_t>(r) * ldr + c];
      o = o * kp + a.xin[static_cast<size_t>(r) * a.ldx + c];
    });
    __syncthreads();
    layer_norm(res, ldr, w.ln1_s, w.ln1_b, a.x1, a.ld1, a.xh1, D, a.rs, 2, M, D);
    __syncthreads();

    product(ring, a.x1, a.ld1, M, [&](int r, int c, float v0, float v1) {
      float* h = a.hf + static_cast<size_t>(r) * a.ldh + c;
      h[0] = fmaxf(v0 + __ldg(w.b1 + c), 0.f);
      if (c + 1 < F) h[1] = fmaxf(v1 + __ldg(w.b1 + c + 1), 0.f);
    });
    __syncthreads();
    product(ring, a.hf, a.ldh, M, [&](int r, int c, float v0, float v1) {
      res[static_cast<size_t>(r) * ldr + c] = v0 + __ldg(w.b2 + c);
      if (c + 1 < D) res[static_cast<size_t>(r) * ldr + c + 1] = v1 + __ldg(w.b2 + c + 1);
    });
    __syncthreads();
    keep_rows(drop, site_ffn_out(layer, H), tl, L, D, [&](int r, int c, float kp) {
      float& o = res[static_cast<size_t>(r) * ldr + c];
      o = o * kp + a.x1[static_cast<size_t>(r) * a.ld1 + c];
    });
    __syncthreads();
    const bool last = layer + 1 == d.n_layers;
    float* next = last ? out : areas(layer + 1).xin;
    const int ldn = last ? D : areas(layer + 1).ldx;
    layer_norm(res, ldr, w.ln2_s, w.ln2_b, next, ldn, a.xh2, D, a.rs == nullptr ? nullptr : a.rs + 1,
               2, M, D);
    __syncthreads();
  }
}

// Where a tile's areas live, and its bytes in shared memory (the ring
// included) and in a per-tile scratch (ops/fused_user_encoder.py's
// `f32_tile_plan` repeats this arithmetic): the forward's res, xin, x1,
// q|k|v beside ctx (the FFN's hidden rows over both), the scores; the
// sweep's res, g, ga, g_o, gq|gk|gv, the scores and the probabilities'
// keep factors.  G sequences a tile.
__host__ __device__ inline long long area_floats(int G, const EncoderDims& d, bool bwd) {
  const long long Ma = static_cast<long long>(G) * d.L, GHLL = static_cast<long long>(G) * d.H * d.L * d.L;
  const int sD = lds(d.D), s3D = lds(3 * d.D), sF = lds(d.F);
  if (bwd) return Ma * (4 * sD + s3D) + 2 * GHLL;
  return Ma * (3 * sD + (s3D + sD > sF ? s3D + sD : sF)) + GHLL;
}

struct TilePlan {
  int G;
  Placement place;
  long long smem, scratch;
};

// A tile takes as many sequences as give each of the card's n_sm SMs one
// tile, up to 64 rows of them (six at L = 10); fewer where that keeps its
// areas in shared memory, else its areas go to its scratch.  A tile's
// attention, softmax, LayerNorms and dropout run on its block's CUDA
// cores, so a tile of six sequences does six sequences' of that work on
// one SM: on the H100 at B = 64 the forward took 0.136 ms in 11 such
// blocks, against the CUDA-core design's 0.063 in 64 and this plan's
// 0.090 in 64 tiles of one; at B = 256 this plan's two sequences a tile
// took 0.094 ms, one a tile (256 blocks, two waves) 0.167.
__host__ __device__ inline TilePlan tile_plan(const EncoderDims& d, bool bwd, int B, int n_sm) {
  const int gmax = d.L <= 64 ? 64 / d.L : 1;
  const int want = min(gmax, max(1, (B + n_sm - 1) / n_sm));
  for (int g = want; g >= 1; --g) {
    const long long bytes = kRingBytes + 4 * area_floats(g, d, bwd);
    if (bytes <= kSmemBytes) return TilePlan{g, kResident, bytes, 0};
  }
  return TilePlan{want, kSpilled, kRingBytes, a16(4 * area_floats(want, d, bwd))};
}

// A tile's areas (floats from its base, in shared memory or its scratch).
struct TileAreas {
  float *res, *a, *b, *c, *d4, *S, *KP;  // fwd: res, xin, x1, U(q|k|v, ctx; hf); bwd: res, g, ga, g_o, gt
  int sD, s3D;
  __device__ TileAreas(float* base, int G, const EncoderDims& d, bool bwd)
      : sD(lds(d.D)), s3D(lds(3 * d.D)) {
    const long long Ma = static_cast<long long>(G) * d.L;
    res = base;
    a = res + Ma * sD;
    b = a + Ma * sD;
    c = b + Ma * sD;  // fwd: the union area; bwd: g_o
    if (bwd) {
      d4 = c + Ma * sD;          // gq|gk|gv
      S = d4 + Ma * s3D;
      KP = S + static_cast<long long>(G) * d.H * d.L * d.L;
    } else {
      d4 = nullptr;
      S = c + Ma * max(s3D + sD, lds(d.F));
      KP = nullptr;
    }
  }
};

}  // namespace f32
}  // namespace iisan
