// The fused SASRec user encoder's bf16 route on Hopper's tensor cores: the
// forward body shared by the forward kernel (user_encoder_fwd.cu, #1) and
// the backward kernel's recompute (user_encoder_bwd_tc.cu, #2), the
// weight-streaming product they both use, and the per-sequence layout.
//
// The function and its cast chain are the JAX kernel's (its
// `_encoder_fwd_body`): every product there takes bf16-valued operands and
// sums in fp32, which is exactly `mma.sync` m16n8k16 bf16 -> fp32.  A
// sequence's rows are 16-row m-tiles (L = 10 is one tile padded with zero
// rows), output columns are 8-column n-tiles spread over the block's eight
// warps, and every operand is padded with zeros to the tile: any D, F, L
// and head width.  The score and P.V products read q, k and v from the
// layout directly; the four weight products stream their matrices.
//
// Weights.  The packed parameters are fp32 (the training path packs them
// with one `cat`); a small kernel rounds them once a call into a bf16
// image (exact: the cast chain rounds these entries; WImage).  A sweep's
// products stream the image through a two-stage ring of chunks in shared
// memory (cp.async, at most 16,384 entries a chunk: one chunk a product at
// D = 64), a chunk ahead of its use and across the ends of products
// (Stream), so that a product's weights land while the scores, softmax
// and LayerNorms before it run.  A forward product reads its (k, n) chunk
// through ldmatrix.trans; the backward's input-gradient product, x . W^T,
// stages the same rectangles of W and reads them through plain ldmatrix:
// there is no transposed copy of any weight.
//
// Softmax: a group of lanes a (head, query row) (8 at L = 10, so that a
// layer's rows take one round), lanes over the keys, fp32 max, expf, sum
// and IEEE division, then rounded to bf16 (the plain version's chain).
// LayerNorms likewise take 8 to 32 lanes a row.  The mask, x + pos and
// every parameter that is not a matrix are copied to the areas before the
// weight stream starts, so that no load queues behind its copies.
// Dropout: one Philox4x32-10 per four consecutive elements, all four
// words used (`keep_each`; the same bits as philox_bits()).  The keep
// factor of the probabilities (1/(1-rate) or 0) is split: the dropped
// probabilities are zeroed in the bf16 operand and P.V's fp32 sum is
// multiplied by 1/(1-rate) before it is rounded, which differs from the
// plain version's order by fp32 rounding only.
//
// Layout.  A sequence's areas (TcLayout): per layer a slot with its bf16
// operands (x, q, k, v^T, p, ctx, x1, hf; rows padded to 16, bf16 row
// strides 16 + a multiple of 16 bytes, so that fragment loads and
// ldmatrix hit distinct banks) and, for the backward, its fp32 stash; a
// head with the scores and the pre-LayerNorm sums; the backward's working
// set.  They live in shared memory where they fit (kResident) and
// otherwise, as in the fp32 route, the slots (kSlotsGlobal) or all of
// them (kSpilled) move to a per-sequence scratch in device memory; every
// operand is read with plain 32-bit loads, so the code is the same.  The
// ring stays in shared memory.  Pads are zero because a block zeroes its
// areas first and nothing writes them again.
#pragma once

#include <cfloat>

#include "common.cuh"
#include "mma.cuh"
#include "philox.cuh"
#include "user_encoder.cuh"

namespace iisan {
namespace tc {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStageElems = 16384;  // bf16 weights a ring stage takes (before padding)
constexpr int kStages = 2;          // ring stages: one chunk in flight while one is used
constexpr int kMaxChunkRows = 256;  // rows of a staged rectangle
constexpr int kStageBytes = 36864;  // the largest stage: 256 rows x (64 + 8) bf16
constexpr int kRingBytes = kStages * kStageBytes;
constexpr int kPanel = 256;       // output columns of a forward product's pass
constexpr int kTransChunk = 128;  // reduction columns of a transposed product's chunk
constexpr int kRowPass = 64;      // rows of a product's pass: four m-tiles
constexpr int kSmemBytes = 232448;

__host__ __device__ inline int r16(int n) { return (n + 15) / 16 * 16; }
__host__ __device__ inline int r8(int n) { return (n + 7) / 8 * 8; }
// bf16 row stride of an operand n columns wide: rows of whole 16-byte
// units, 16 bytes apart mod 128.
__host__ __device__ inline int bstride(int n) { return r16(n) + 8; }
__host__ __device__ inline long long a16(long long n) { return (n + 15) / 16 * 16; }

__host__ __device__ inline long long take(long long& at, long long bytes) {
  const long long o = at;
  at = a16(at + bytes);
  return o;
}

// The parameters that are not matrices, in one row: the input LayerNorm's
// scale and bias, then per layer ln1 scale, ln1 bias, b1, b2, ln2 scale,
// ln2 bias (their order in the packed vector).  The kernels copy them to
// their areas first; the backward's partial rows have this layout.
__host__ __device__ inline int small_params(const EncoderDims& d) {
  return 2 * d.D + d.n_layers * (5 * d.D + d.F);
}
// The packed index of small parameter q.
__device__ inline long long small_param_index(int q, const EncoderDims& d) {
  const int D = d.D, F = d.F;
  const long long base = static_cast<long long>(d.n_position) * D;
  if (q < 2 * D) return base + q;
  const int per = 5 * D + F, i = (q - 2 * D) / per, j = (q - 2 * D) - i * per;
  const long long blk = base + 2 * D + static_cast<long long>(i) * BlockParams::size(D, F) +
                        4LL * D * D;
  return j < 2 * D       ? blk + j
         : j < 2 * D + F ? blk + 2 * D + static_cast<long long>(D) * F + (j - 2 * D)
                         : blk + 2 * D + 2LL * D * F + F + (j - 2 * D - F);
}

// Byte offsets of a sequence's areas (ops/fused_user_encoder.py's
// `_tc_layout` repeats this arithmetic).  `stash`: the backward's extras.
struct TcLayout {
  int L, D, H, F, dk, Lp, dkp, sD, sF, sdk, sL, s3D;
  long long xin, qh, kh, vT, P, ctx, x1, hf, praw, xhat1, xhat2, rstd1, rstd2, slot;
  long long S, res, mk, sp, xhat0, rstd0, head;
  long long g, ga, gh, gc, gbb, gh32, ghb, gsc, gqkv, work;
  __host__ __device__ TcLayout(const EncoderDims& d, bool stash)
      : L(d.L), D(d.D), H(d.H), F(d.F), dk(d.D / d.H), Lp(r16(d.L)), dkp(r16(d.D / d.H)),
        sD(bstride(d.D)), sF(bstride(d.F)), sdk(bstride(d.D / d.H)), sL(bstride(d.L)),
        s3D(bstride(3 * d.D)) {
    const long long LD4 = 4LL * L * D, HLL4 = 4LL * H * L * L;
    long long at = 0;
    xin = take(at, 2LL * Lp * sD);
    qh = take(at, 2LL * H * Lp * sdk);
    kh = take(at, 2LL * H * Lp * sdk);
    vT = take(at, 2LL * H * dkp * sL);
    P = take(at, 2LL * H * Lp * sL);
    ctx = take(at, 2LL * Lp * sD);
    x1 = take(at, 2LL * Lp * sD);
    hf = take(at, 2LL * Lp * sF);
    praw = xhat1 = xhat2 = rstd1 = rstd2 = 0;
    if (stash) {
      praw = take(at, HLL4);
      xhat1 = take(at, LD4);
      xhat2 = take(at, LD4);
      rstd1 = take(at, 4LL * L);
      rstd2 = take(at, 4LL * L);
    }
    slot = at;
    at = 0;
    S = take(at, HLL4);
    res = take(at, LD4);
    mk = take(at, 4LL * L * L);
    sp = take(at, 4LL * small_params(d));
    xhat0 = rstd0 = 0;
    if (stash) {
      xhat0 = take(at, LD4);
      rstd0 = take(at, 4LL * L);
    }
    head = at;
    at = 0;
    g = ga = gh = gc = gbb = gh32 = ghb = gsc = gqkv = 0;
    if (stash) {
      g = take(at, LD4);
      ga = take(at, LD4);
      gh = take(at, LD4);
      gc = take(at, LD4);
      gbb = take(at, 2LL * Lp * sD);
      gh32 = take(at, 4LL * L * F);
      ghb = take(at, 2LL * Lp * sF);
      gsc = take(at, HLL4);
      gqkv = take(at, 2LL * Lp * s3D);
    }
    work = at;
  }
};

// Where the areas go with n_slots slots, and their bytes in shared memory
// (the ring included) and in the per-sequence scratch.
__host__ __device__ inline Placement tc_place(const TcLayout& lay, int n_slots) {
  if (kRingBytes + lay.head + n_slots * lay.slot + lay.work <= kSmemBytes) return kResident;
  if (kRingBytes + lay.head + lay.work <= kSmemBytes) return kSlotsGlobal;
  return kSpilled;
}
__host__ __device__ inline long long tc_smem_bytes(const TcLayout& lay, Placement pl,
                                                   int n_slots) {
  if (pl == kResident) return kRingBytes + lay.head + n_slots * lay.slot + lay.work;
  if (pl == kSlotsGlobal) return kRingBytes + lay.head + lay.work;
  return kRingBytes;
}
__host__ __device__ inline long long tc_scratch_bytes(const TcLayout& lay, Placement pl,
                                                      int n_slots) {
  if (pl == kResident) return 0;
  if (pl == kSlotsGlobal) return n_slots * lay.slot;
  return lay.head + n_slots * lay.slot + lay.work;
}

// The areas of sequence b.  zero() clears them (a block's first step).
struct TcAreas {
  bf16* ring;
  char *head, *slots, *work;
  char *smem_end, *scratch, *scratch_end;
  __device__ TcAreas(Placement pl, const TcLayout& lay, int n_slots, char* smem,
                     char* scratch_base, size_t b, long long per_seq) {
    ring = reinterpret_cast<bf16*>(smem);
    char* s = smem + kRingBytes;
    scratch = per_seq > 0 ? scratch_base + b * static_cast<size_t>(per_seq) : nullptr;
    scratch_end = per_seq > 0 ? scratch + per_seq : nullptr;
    smem_end = smem + tc_smem_bytes(lay, pl, n_slots);
    if (pl == kResident) {
      head = s;
      slots = head + lay.head;
      work = slots + static_cast<size_t>(n_slots) * lay.slot;
    } else if (pl == kSlotsGlobal) {
      head = s;
      work = head + lay.head;
      slots = scratch;
    } else {
      head = scratch;
      slots = head + lay.head;
      work = slots + static_cast<size_t>(n_slots) * lay.slot;
    }
  }
  __device__ void zero() const {
    const uint4 z = make_uint4(0u, 0u, 0u, 0u);
    uint4* a = reinterpret_cast<uint4*>(reinterpret_cast<char*>(ring) + kRingBytes);
    for (uint4* p = a + threadIdx.x; p < reinterpret_cast<uint4*>(smem_end); p += blockDim.x)
      *p = z;
    for (uint4* p = reinterpret_cast<uint4*>(scratch) + threadIdx.x;
         p < reinterpret_cast<uint4*>(scratch_end); p += blockDim.x)
      *p = z;
  }
};

__device__ __forceinline__ float bf(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float rbf(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

// f(e, keep) for e in [0, n): keep is the scaled keep factor of element e
// of `site` (1 when dropout is off).  A thread draws one Philox counter
// and uses its four words for four consecutive elements.
template <typename Fn>
__device__ __forceinline__ void keep_each(const Dropout& d, unsigned site, unsigned b, int n,
                                          Fn f) {
  if (!d.on) {
    for (int e = threadIdx.x; e < n; e += blockDim.x) f(e, 1.f);
    return;
  }
  for (int c = threadIdx.x; 4 * c < n; c += blockDim.x) {
    const uint4 r = d.bits4(site, b, static_cast<unsigned>(c));
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (4 * c + j < n) f(4 * c + j, d.keep_bits(w[j]));
  }
}

// The bf16 weight image (user_encoder_weights_kernel writes it from the
// packed fp32 parameters, rounding each entry once): per layer the four
// matrices of its products, each row-major with rows padded with zeros to
// whole 16-byte units: q|k|v side by side (D x 3D), wo (D x D), w1
// (D x F), w2 (F x D).
struct WImage {
  int D, F, ldqkv, ldo, ld1, ld2;
  long long qkv, o, w1, w2, layer;  // bf16 elements
  __host__ __device__ WImage(int D_, int F_)
      : D(D_), F(F_), ldqkv(r8(3 * D_)), ldo(r8(D_)), ld1(r8(F_)), ld2(r8(D_)) {
    qkv = 0;
    o = qkv + static_cast<long long>(D) * ldqkv;
    w1 = o + static_cast<long long>(D) * ldo;
    w2 = w1 + static_cast<long long>(D) * ld1;
    layer = w2 + static_cast<long long>(F) * ld2;
  }
};

// A (K, N) bf16 matrix of the image, row stride ld.
struct WMat {
  const bf16* w;
  int K, N, ld;
};

// A rectangle of a WMat: rows r0 .. r0+nr, columns c0 .. c0+nc.
struct Rect {
  int r0, nr, c0, nc;
};

__host__ __device__ inline int pow2_at_least(int n) {
  int p = 16;
  while (p < n) p *= 2;
  return p;
}

// How one weight product streams its matrix: out = A . W (trans false:
// reduction over W's rows, outputs its columns) or A . W^T (trans true:
// reduction over its columns, outputs its rows), in panels of output
// columns and chunks of the reduction.  A chunk is a rectangle of W staged
// in bf16 with columns padded to colsp (a power of two) and row stride
// colsp + 8 (rows 16 bytes apart mod 128: ldmatrix hits distinct banks).
struct Prod {
  WMat wm;
  bool trans;
  int n_out, n_red, panel, chunk, colsp, n_chunks, total;
  __device__ Prod() {}
  __device__ Prod(const WMat& w, bool t) : wm(w), trans(t) {
    n_out = t ? w.K : w.N;
    n_red = t ? w.N : w.K;
    if (!t) {
      panel = min(kPanel, n_out);
      colsp = pow2_at_least(panel);
      chunk = min(kMaxChunkRows, kStageElems / colsp);
    } else {
      chunk = min(kTransChunk, n_red);
      colsp = pow2_at_least(chunk);
      panel = min(kMaxChunkRows, kStageElems / colsp);
    }
    n_chunks = (n_red + chunk - 1) / chunk;
    total = (n_out + panel - 1) / panel * n_chunks;
  }
  __device__ Rect rect(int i) const {
    const int p = i / n_chunks, c = i - p * n_chunks;
    const int o0 = p * panel, k0 = c * chunk;
    const int on = min(panel, n_out - o0), kn = min(chunk, n_red - k0);
    return trans ? Rect{o0, on, k0, kn} : Rect{k0, kn, o0, on};
  }
  // Copies chunk i into a stage with 16-byte cp.async: a thread copies one
  // 8-column group of rows tid / (colsp / 8), + 256 / (colsp / 8), ...;
  // rows to the next 16 and columns to colsp are zero-filled.  The caller
  // commits the group.
  __device__ void stage(bf16* st, int i) const {
    const Rect rc = rect(i);
    const int per = colsp >> 3, lgp = __ffs(per) - 1;
    const int c = (threadIdx.x & (per - 1)) * 8, r_step = kThreads >> lgp;
    const int rows = r16(rc.nr);
    const bool col_ok = c < rc.nc;
    const bf16* src = wm.w + static_cast<size_t>(rc.r0) * wm.ld + rc.c0 + c;
    for (int r = threadIdx.x >> lgp; r < rows; r += r_step) {
      const bool ok = col_ok && r < rc.nr;
      cp_async16_zfill(st + r * (colsp + 8) + c, ok ? src + static_cast<size_t>(r) * wm.ld : wm.w,
                       ok ? 16 : 0);
    }
  }
};

// The weight products of a sweep over the layers, in the order they run,
// as one stream of chunks through the ring: the forward's q|k|v, o, FFN in
// and out of layers 0, 1, ...; the backward's FFN out, FFN in, o and
// q|k|v (transposed) of layers n-1, ..., 0.  A chunk is copied kStages - 1
// chunks ahead of its use, across the ends of products, so that the first
// chunk of a product lands while the scores, softmax and LayerNorms before
// it run.  Every product runs n_pass times (passes of 64 rows).  The four
// products' plans are those of layer 0 with the image's layer stride
// added; the copy side walks (step, product, chunk) by counters.
struct Stream {
  const bf16* image;
  long long layer_stride;
  int n_layers, n_pass, next;
  bool bwd;
  Prod prods[4];
  int is_step, is_k, is_i, is_left, next_issue;  // the next chunk to copy
  bf16* ring;
  __device__ Stream(const bf16* image_, const EncoderDims& d, bool bwd_, bf16* ring_)
      : image(image_), n_layers(d.n_layers), n_pass((r16(d.L) + kRowPass - 1) / kRowPass),
        next(0), bwd(bwd_), next_issue(0), ring(ring_) {
    const WImage im(d.D, d.F);
    layer_stride = im.layer;
    const WMat qkv{image + im.qkv, d.D, 3 * d.D, im.ldqkv}, o{image + im.o, d.D, d.D, im.ldo};
    const WMat w1{image + im.w1, d.D, d.F, im.ld1}, w2{image + im.w2, d.F, d.D, im.ld2};
    if (!bwd) {
      prods[0] = Prod(qkv, false);
      prods[1] = Prod(o, false);
      prods[2] = Prod(w1, false);
      prods[3] = Prod(w2, false);
    } else {
      prods[0] = Prod(w2, true);
      prods[1] = Prod(w1, true);
      prods[2] = Prod(o, true);
      prods[3] = Prod(qkv, true);
    }
    is_step = is_k = is_i = 0;
    is_left = n_layers;
    for (int g = 0; g < kStages - 1; ++g) issue();
  }
  // The k-th product of the step-th layer the sweep visits.
  __device__ Prod prod(int step, int k) const {
    Prod p = prods[k];
    p.wm.w += static_cast<size_t>(bwd ? n_layers - 1 - step : step) * layer_stride;
    return p;
  }
  __device__ bf16* stage(int g) const { return ring + (g % kStages) * (kStageBytes / 2); }
  // Copies the next chunk of the stream into its stage (nothing past the
  // end) and commits a group, so that every thread commits one group a
  // chunk; the g-th call fills stage g.
  __device__ void issue() {
    const int g = next_issue++;
    if (is_left > 0) {
      const Prod pr = prod(is_step, is_k);
      pr.stage(stage(g), is_i % pr.total);
      if (++is_i == pr.total * n_pass) {
        is_i = 0;
        if (++is_k == 4) {
          is_k = 0;
          ++is_step;
          --is_left;
        }
      }
    }
    cp_async_commit();
  }
};

// out = A . W or A . W^T (the stream's next product, pr) for the `rows`
// rows of A (bf16, row stride lda, zero columns to the reduction's next 16
// and zero rows to the next 16): epi(row, col, sum of col, sum of col + 1)
// for every row < rows and even column of the output (col + 1 may be
// past it).  A pass takes up to 64 rows (kMT m-tiles, those past mt_n
// idle) and consumes the product's chunks from the stream: before each,
// a wait for its copies and a barrier, then the copy of the chunk
// kStages - 1 ahead into the stage the last one freed.  The B fragments
// come through ldmatrix (transposed for a forward product).  A panel's
// epilogue follows its last chunk with no barrier: the caller syncs
// before reading the output.
template <int kMT, typename Epi>
__device__ void gemm_pass(const bf16* A, int lda, int m0, int mt_n, int rows, Stream& ring,
                          const Prod& pr, Epi& epi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  float acc[kMT][4][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
  for (int i = 0; i < pr.total; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const bf16* st = ring.stage(ring.next);
    ring.issue();
    ++ring.next;
    const Rect rc = pr.rect(i);
    const int p = i / pr.n_chunks, c = i - p * pr.n_chunks;
    const int kbase = c * pr.chunk;
    const int kn = pr.trans ? rc.nc : rc.nr, on = pr.trans ? rc.nr : rc.nc;
    const int nt_n = r8(on) / 8, ld = pr.colsp + 8;
    const int r_lane = (lane & 7) + ((lane >> 3) & 1) * 8;  // ldmatrix x2 row of this lane
    for (int ks = 0; ks < r16(kn) / 16; ++ks) {
      unsigned a[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        if (mt < mt_n) {
          const bf16* ap =
              A + static_cast<size_t>(m0 + mt * 16 + g) * lda + kbase + ks * 16 + 2 * t;
          a[mt][0] = lds32(ap);
          a[mt][1] = lds32(ap + 8 * lda);
          a[mt][2] = lds32(ap + 8);
          a[mt][3] = lds32(ap + 8 * lda + 8);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int nt = warp + j * kWarps;
        if (nt < nt_n) {
          unsigned bfr[2];
          if (pr.trans)
            ldsm_x2(bfr, st + (nt * 8 + (lane & 7)) * ld + ks * 16 + ((lane >> 3) & 1) * 8);
          else
            ldsm_x2_trans(bfr, st + (ks * 16 + r_lane) * ld + nt * 8);
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt)
            if (mt < mt_n) mma_bf16(acc[mt][j], a[mt], bfr);
        }
      }
    }
    if (c == pr.n_chunks - 1) {
      const int o0 = p * pr.panel;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int nt = warp + j * kWarps;
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          if (nt < nt_n && mt < mt_n) {
            const int row = m0 + mt * 16 + g, col = o0 + nt * 8 + 2 * t;
            if (col < pr.n_out) {
              if (row < rows) epi(row, col, acc[mt][j][0], acc[mt][j][1]);
              if (row + 8 < rows) epi(row + 8, col, acc[mt][j][2], acc[mt][j][3]);
            }
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
        }
      }
    }
  }
}

// The stream's next product over all `rows` rows of A, in passes of 64.
template <typename Epi>
__device__ void gemm(const bf16* A, int lda, int rows, Stream& ring, const Prod& pr, Epi epi) {
  for (int m0 = 0; m0 < rows; m0 += kRowPass) {
    const int mt_n = min(4, (r16(rows) - m0) / 16);
    if (mt_n == 1)
      gemm_pass<1>(A, lda, m0, 1, rows, ring, pr, epi);
    else
      gemm_pass<4>(A, lda, m0, mt_n, rows, ring, pr, epi);
  }
}

// Per head h < H: C = A_h . B_h^T over 16 x 8 tiles, A_h (m-tiles of 16
// rows, row stride lda) at A + h * a_head, B_h stored (n, k) row by row
// (row stride ldb) at B + h * b_head, ksteps of 16: epi(h, row, col, sum)
// for every element of the mt_n x nt_n tiles.  A warp a tile.
template <typename Epi>
__device__ void head_products(const bf16* A, long long a_head, int lda, const bf16* B,
                              long long b_head, int ldb, int H, int mt_n, int nt_n, int ksteps,
                              Epi epi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int per_head = mt_n * nt_n;
  for (int it = warp; it < H * per_head; it += kWarps) {
    const int h = it / per_head, r = it - h * per_head;
    const int mt = r / nt_n, nt = r - mt * nt_n;
    const bf16* ap = A + h * a_head + static_cast<size_t>(mt * 16 + g) * lda + 2 * t;
    const bf16* bp = B + h * b_head + static_cast<size_t>(nt * 8 + g) * ldb + 2 * t;
    float c[4] = {0.f, 0.f, 0.f, 0.f};
    for (int ks = 0; ks < ksteps; ++ks) {
      const unsigned a[4] = {lds32(ap + ks * 16), lds32(ap + 8 * lda + ks * 16),
                             lds32(ap + ks * 16 + 8), lds32(ap + 8 * lda + ks * 16 + 8)};
      const unsigned b[2] = {lds32(bp + ks * 16), lds32(bp + ks * 16 + 8)};
      mma_bf16(c, a, b);
    }
    const int row = mt * 16 + g, col = nt * 8 + 2 * t;
    epi(h, row, col, c[0]);
    epi(h, row, col + 1, c[1]);
    epi(h, row + 8, col, c[2]);
    epi(h, row + 8, col + 1, c[3]);
  }
}

// LayerNorm of the fp32 rows pre (L, D): out (bf16, row stride ldo) =
// bf16(xhat * scale + bias), fp32 statistics (as layer_norm_rows); xhat
// and rstd are kept where given.  A row takes a group of 32, 16 or 8 lanes,
// so that up to 32 rows go in one round of the block's eight warps.
__device__ inline void layer_norm_tc(const float* pre, const float* scale, const float* bias,
                                     bf16* out, int ldo, float* xhat, float* rstd_out, int L,
                                     int D) {
  const int gs = L <= 8 ? 32 : L <= 16 ? 16 : 8, rpw = 32 / gs;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int li = lane % gs, sub = lane / gs;
  // A lane's first two columns' scale and bias, loaded before the
  // statistics so that their latency hides behind them.
  const float sc0 = li < D ? scale[li] : 0.f;
  const float bi0 = li < D ? bias[li] : 0.f;
  const float sc1 = li + gs < D ? scale[li + gs] : 0.f;
  const float bi1 = li + gs < D ? bias[li + gs] : 0.f;
  for (int base = warp * rpw; base < L; base += kWarps * rpw) {  // the same trips in a warp
    const int l = base + sub;
    const bool ok = l < L;
    const float* x = pre + (ok ? l : 0) * D;
    float s = 0.f;
    for (int d = li; ok && d < D; d += gs) s += x[d];
    const float mu = group_sum(s, gs) / D;
    float v = 0.f;
    for (int d = li; ok && d < D; d += gs) {
      const float c = x[d] - mu;
      v = fmaf(c, c, v);
    }
    const float rstd = rsqrtf(group_sum(v, gs) / D + kEps);
    if (!ok) continue;
    if (rstd_out != nullptr && li == 0) rstd_out[l] = rstd;
    for (int d = li; d < D; d += gs) {
      const float xh = (x[d] - mu) * rstd;
      const float sc = d == li ? sc0 : d == li + gs ? sc1 : scale[d];
      const float bi = d == li ? bi0 : d == li + gs ? bi1 : bias[d];
      if (xhat != nullptr) xhat[l * D + d] = xh;
      if (out != nullptr) out[static_cast<size_t>(l) * ldo + d] = __float2bfloat16_rn(xh * sc + bi);
    }
  }
}

// A slot's operands.
struct Slot {
  bf16 *xin, *qh, *kh, *vT, *P, *ctx, *x1, *hf;
  float *praw, *xhat1, *xhat2, *rstd1, *rstd2;
  __device__ Slot(char* s, const TcLayout& lay, bool stash)
      : xin(reinterpret_cast<bf16*>(s + lay.xin)),
        qh(reinterpret_cast<bf16*>(s + lay.qh)),
        kh(reinterpret_cast<bf16*>(s + lay.kh)),
        vT(reinterpret_cast<bf16*>(s + lay.vT)),
        P(reinterpret_cast<bf16*>(s + lay.P)),
        ctx(reinterpret_cast<bf16*>(s + lay.ctx)),
        x1(reinterpret_cast<bf16*>(s + lay.x1)),
        hf(reinterpret_cast<bf16*>(s + lay.hf)),
        praw(stash ? reinterpret_cast<float*>(s + lay.praw) : nullptr),
        xhat1(stash ? reinterpret_cast<float*>(s + lay.xhat1) : nullptr),
        xhat2(stash ? reinterpret_cast<float*>(s + lay.xhat2) : nullptr),
        rstd1(stash ? reinterpret_cast<float*>(s + lay.rstd1) : nullptr),
        rstd2(stash ? reinterpret_cast<float*>(s + lay.rstd2) : nullptr) {}
};

// The whole encoder forward of sequence b (xb, mb: its input and mask;
// params the packed fp32 vector, image its bf16 weight image).
// Layer i works in the slot at ar.slots + i * slot_stride (0: one slot for
// all layers), keeping its stash there when kStash; the last layer's
// output lands in `out` (bf16, row stride D; nullptr: not written).  Ends
// with a barrier.
template <bool kStash>
__device__ void forward_tc(const bf16* __restrict__ xb, const float* __restrict__ mb,
                           const float* __restrict__ params, const bf16* __restrict__ image,
                           const EncoderDims& dims,
                           const TcLayout& lay, float inv_sqrt_dk, const Dropout& drop,
                           unsigned b, const TcAreas& ar, long long slot_stride, bf16* out) {
  const int L = dims.L, D = dims.D, H = dims.H, F = dims.F, dk = lay.dk;
  const int Lp = lay.Lp, sD = lay.sD, sL = lay.sL, sdk = lay.sdk;
  const int LD = L * D;
  float* S = reinterpret_cast<float*>(ar.head + lay.S);
  float* res = reinterpret_cast<float*>(ar.head + lay.res);
  float* mk = reinterpret_cast<float*>(ar.head + lay.mk);
  const float* pos = params;
  float* sp = reinterpret_cast<float*>(ar.head + lay.sp);
  const int Q = small_params(dims);
  const float pscale = drop.on ? drop.scale : 1.f;

  // The mask, x + pos (in bf16 arithmetic) and every small parameter into
  // the areas before the weight stream starts: a load issued later would
  // queue behind the stream's copies.
  for (int i = threadIdx.x; i < L * L; i += blockDim.x) mk[i] = __ldg(mb + i);
  for (int i = threadIdx.x; i < LD; i += blockDim.x)
    res[i] = rbf(bf(xb[i]) + rbf(__ldg(pos + i)));
  for (int q = threadIdx.x; q < Q; q += blockDim.x)
    sp[q] = __ldg(params + small_param_index(q, dims));
  __syncthreads();
  Stream ring(image, dims, false, ar.ring);
  {
    const Slot s0(ar.slots, lay, kStash);
    layer_norm_tc(res, sp, sp + D, s0.xin, sD,
                  kStash ? reinterpret_cast<float*>(ar.head + lay.xhat0) : nullptr,
                  kStash ? reinterpret_cast<float*>(ar.head + lay.rstd0) : nullptr, L, D);
    __syncthreads();
    if (drop.on) {
      keep_each(drop, 0u, b, LD, [&](int e, float kp) {
        const int l = e / D, d = e - l * D;
        bf16& x = s0.xin[l * sD + d];
        x = __float2bfloat16_rn(bf(x) * kp);
      });
      __syncthreads();
    }
  }

  for (int layer = 0; layer < dims.n_layers; ++layer) {
    // this layer's small parameters: ln1 scale, ln1 bias, b1, b2, ln2 scale, ln2 bias
    const float* pl = sp + 2 * D + layer * (5 * D + F);
    const Slot s(ar.slots + layer * slot_stride, lay, kStash);

    // q, k, v: wq, wk, wv are consecutive in the packed vector, one
    // product; q and k land head by head, v transposed (key-contiguous,
    // the B operand of P.V).
    gemm(s.xin, sD, L, ring, ring.prod(layer, 0), [&](int r, int c, float v0, float v1) {
      int m = c / D, n = c - m * D, h = n / dk, j = n - h * dk;
      for (int e = 0; e < 2 && c + e < 3 * D; ++e) {
        if (e == 1 && ++j == dk) {  // the pair's second column opens the next head
          j = 0;
          if (++h == H) h = 0, ++m;
        }
        const bf16 o = __float2bfloat16_rn(e ? v1 : v0);
        if (m == 0)
          s.qh[(h * Lp + r) * sdk + j] = o;
        else if (m == 1)
          s.kh[(h * Lp + r) * sdk + j] = o;
        else
          s.vT[(h * lay.dkp + j) * sL + r] = o;
      }
    });
    __syncthreads();

    head_products(s.qh, static_cast<long long>(Lp) * sdk, sdk, s.kh,
                  static_cast<long long>(Lp) * sdk, sdk, H, Lp / 16, r8(L) / 8, lay.dkp / 16,
                  [&](int h, int r, int c, float v) {
                    if (r < L && c < L) S[(h * L + r) * L + c] = v * inv_sqrt_dk + mk[r * L + c];
                  });
    __syncthreads();

    // A (head, query row) takes a group of the fewest lanes (a power of
    // two) that see its keys in two steps, so that a warp takes several.
    int gs = 1;
    while (gs < 32 && 2 * gs < L) gs *= 2;
    for (int base = (threadIdx.x / 32) * (32 / gs); base < H * L; base += kWarps * (32 / gs)) {
      const int lane = threadIdx.x % 32, li = lane % gs, row = base + lane / gs;
      const bool ok = row < H * L;
      float* sr = S + (ok ? row : 0) * L;
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
      const int h = row / L, l = row - h * L;
      bf16* pr = s.P + (h * Lp + l) * sL;
      for (int m = li; m < L; m += gs) {
        const float pv = sr[m] / sum;
        if (kStash) s.praw[row * L + m] = pv;
        pr[m] = __float2bfloat16_rn(pv);
      }
    }
    __syncthreads();
    if (drop.on) {
      for (int h = 0; h < H; ++h)
        keep_each(drop, site_probs(layer, h, H), b, L * L, [&](int e, float kp) {
          if (kp == 0.f) {
            const int l = e / L, m = e - l * L;
            s.P[(h * Lp + l) * sL + m] = __float2bfloat16_rn(0.f);
          }
        });
      __syncthreads();
    }

    head_products(s.P, static_cast<long long>(Lp) * sL, sL, s.vT,
                  static_cast<long long>(lay.dkp) * sL, sL, H, Lp / 16, r8(dk) / 8, Lp / 16,
                  [&](int h, int r, int c, float v) {
                    if (r < L && c < dk)
                      s.ctx[r * sD + h * dk + c] = __float2bfloat16_rn(v * pscale);
                  });
    __syncthreads();

    gemm(s.ctx, sD, L, ring, ring.prod(layer, 1), [&](int r, int c, float v0, float v1) {
      res[r * D + c] = rbf(v0);
      if (c + 1 < D) res[r * D + c + 1] = rbf(v1);
    });
    __syncthreads();
    keep_each(drop, site_attn_out(layer, H), b, LD, [&](int e, float kp) {
      const int l = e / D, d = e - l * D;
      res[e] = rbf(res[e] * kp) + bf(s.xin[l * sD + d]);
    });
    __syncthreads();
    layer_norm_tc(res, pl, pl + D, s.x1, sD, s.xhat1, s.rstd1, L, D);
    __syncthreads();

    gemm(s.x1, sD, L, ring, ring.prod(layer, 2), [&](int r, int c, float v0, float v1) {
      for (int e = 0; e < 2 && c + e < F; ++e) {
        const float h = rbf(rbf(e ? v1 : v0) + rbf(pl[2 * D + c + e]));
        s.hf[r * lay.sF + c + e] = __float2bfloat16_rn(fmaxf(h, 0.f));
      }
    });
    __syncthreads();
    gemm(s.hf, lay.sF, L, ring, ring.prod(layer, 3), [&](int r, int c, float v0, float v1) {
      for (int e = 0; e < 2 && c + e < D; ++e)
        res[r * D + c + e] = rbf(rbf(e ? v1 : v0) + rbf(pl[2 * D + F + c + e]));
    });
    __syncthreads();
    keep_each(drop, site_ffn_out(layer, H), b, LD, [&](int e, float kp) {
      const int l = e / D, d = e - l * D;
      res[e] = rbf(res[e] * kp) + bf(s.x1[l * sD + d]);
    });
    __syncthreads();
    const bool last = layer + 1 == dims.n_layers;
    bf16* next = last ? out : Slot(ar.slots + (layer + 1) * slot_stride, lay, kStash).xin;
    layer_norm_tc(res, pl + 3 * D + F, pl + 4 * D + F, next, last ? D : sD, s.xhat2, s.rstd2, L,
                  D);
    __syncthreads();
  }
}

}  // namespace tc
}  // namespace iisan
