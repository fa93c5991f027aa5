// One Hopper body for the SAN adapter cascade kernels #3 (bf16,
// san_cascade_fwd.cu) and #4 (san_cascade_streamed_fwd.cu).  Both compute
//
//   f = a[s,i] * tap_i + b[s,i] * c
//   z = round(f) @ wd[s,i] + bd[s,i]                     (fp32 sums)
//   c = (round(act(z)) @ wu[s,i] + bu[s,i]) + f
//
// for i = 0..K-1 from c = c0[s], and differ only in the cast chain, which a
// policy type gives:
//   Resident (#3): f and the carry are rounded to bf16 every step;
//   Streamed (#4): f and the carry stay fp32 and the output is rounded
//     once, after the last step.
//
// What bounds the cascade on the H100.  Its bytes and operations are small
// at the training step (N=704 rows, K=7: 81 MB of taps and 10 GFLOP at
// D=8192, 1.4 MB at D=768), and every step is a chain: a down product
// over all of D, a reduction of z over D, an up product.  So the card is
// filled by splitting D, and the time goes to the chain's latency.  The
// design:
//
// * Tiles.  A block is one warpgroup (128 threads) and owns 64 rows (one
//   wgmma M) of one D slice, a whole number of 64-column chunks, for all K
//   steps.  D is split across a thread-block cluster: the C blocks of a
//   cluster take the C slices of one row tile, so a step's 11 row tiles
//   still fill the card (cascade_plan in ops/fused_san.py picks C <= 16,
//   the slice and where the carry lives).  S branches are the grid's y.
// * A TMA ring, S stages deep, brings the items of a fixed stream: per step
//   and chunk a down item (the chunk's 64 x 64 tap box, tap i being the
//   columns i D8... of a row, and its rows of wd) and then per chunk an
//   up item (64 rows of R of wu); thread 0 keeps S items in flight, across
//   the steps.
// * Down product.  Each chunk's f is formed from the tap and the carry with
//   separately rounded products and sum (the reference's arithmetic),
//   written 128-byte swizzled into shared memory and fed to bf16 wgmma
//   m64nRc k16 (fp32 sums) against wd, read in its (D, R) layout as
//   MN-major B; the next chunk's f is formed while a chunk multiplies.  R is
//   padded to Rc columns by TMA's zero fill (ReLU(0) = GELU(0) = 0 and bd
//   is 0 there, so the padding is exact); R above 256 is taken in passes of
//   Rc, each pass re-reading f.
// * Reduce z across the cluster.  Each block leaves its 64 x Rc fp32
//   partial in its own shared memory; after a cluster barrier, block
//   `rank` sums its share of z's 8-column units over all C partials through
//   distributed shared memory in rank order 0, 1, ..., C-1, adds bd and
//   applies the activation into its activation buffer; after a second
//   barrier every block copies the other shares.  Each unit is summed once,
//   in a fixed order, so every block gets the same bits and a call repeats
//   bit for bit.
// * Up product.  Per 64-column chunk, wgmma m64n64k16 over R (the
//   activations K-major in shared memory, wu's boxes MN-major); the
//   epilogue adds bu (loaded a chunk ahead) and f and writes the new carry.
// * The carry slice (then f, in place) stays in shared memory where it fits
//   (bf16 64 x (slice + 8) for #3, fp32 for #4: up to 133 KB at D=8192);
//   where it cannot (#4 past D = 8,192 and #3 past 16,384 at R = 64), it
//   lives in device memory (#3: `out` itself; #4: an fp32 scratch) and is
//   prefetched two chunks ahead.  One launch a call.
//
// Any D and R up to 1,472 work: ragged chunks are zero-padded on the way
// in and not stored on the way out.

#pragma once

#include <cooperative_groups.h>


#include "common.cuh"
#include "sm90_gemm.cuh"

namespace iisan {
namespace cascade {

namespace cg = cooperative_groups;
using sm90::bf16;

constexpr int kRows = 64;                // rows of a tile: wgmma's M
constexpr int kCols = 64;                // columns of a chunk: 128 bytes of bf16
constexpr int kThreads = 128;            // one warpgroup
constexpr int kBox = kRows * kCols * 2;  // one 64 x 64 bf16 box, 8 KB
constexpr int kSlots = 2;                // f chunks in shared memory
constexpr int kMaxCluster = 16;

// Shared memory, offsets from the 1024-aligned base: kSlots f chunks (the
// fp32 partial of z, 64 x (Rc + 8), takes the same bytes once the down
// product is done: the pad spreads its rows over the banks), the TMA ring
// (a stage holds a down item's tap box and its Rc / 64 boxes of wd rows,
// or one up item's wu box), the activations (r_slices boxes of 64 rows x 64 columns
// of R), the carry slice when it lives in shared memory (64 x (d_slice +
// 8) of the chain's Carry; carry_bytes 0 otherwise), the ring's barriers.
// `cascade_smem_bytes` in ops/fused_san.py computes the same `bytes`.
struct Layout {
  int stage, w, act, carry, bars, bytes;
  __host__ __device__ Layout(int rc, int stages, int r_slices, int carry_bytes) {
    const int front = kSlots * kBox > kRows * (rc + 8) * 4 ? kSlots * kBox : kRows * (rc + 8) * 4;
    stage = (1 + rc / kCols) * kBox;
    w = (front + 1023) / 1024 * 1024;
    act = w + stages * stage;
    carry = act + r_slices * kBox;
    bars = carry + (carry_bytes + 15) / 16 * 16;
    bytes = bars + stages * 8 + 1024;  // + alignment
  }
};

struct Params {
  const float* coef_a;  // (S, K)
  const float* coef_b;  // (S, K)
  const bf16* taps;     // (S, N, K, D8): rows of K * D8, D8 = D rounded up to 8
  const bf16* bd;       // (S, K, R)
  const bf16* bu;       // (S, K, D)
  const bf16* c0;       // (S, N, D)
  void* carry;          // (S, N, D) of the chain's Carry type: f and the carry
  bf16* out;            // (S, N, D)
  int N, K, D, R;
  int cpb;       // chunks of D a block (its slice), at most the plan's
  int passes;    // passes of Rc columns over R in the down product
  int r_slices;  // ceil(R / 64): the up product's depth in 64-row boxes
  int stages;    // weight ring depth
  int gelu;
  int vec;  // D % 8 == 0 and c0, carry and out 16-byte aligned
};

// #3's chain: f and the carry rounded to bf16 every step.
struct Resident {
  typedef bf16 Carry;
  static constexpr int kWords = 1;  // uint4 words of 8 carry values
  __device__ static __forceinline__ float fuse(float a, float t, float b, float c) {
    return round_to<bf16>(__fadd_rn(__fmul_rn(a, t), __fmul_rn(b, c)));
  }
  __device__ static __forceinline__ float next(float up_bias, float f) {
    return round_to<bf16>(__fadd_rn(up_bias, f));
  }
};

// #4's chain: fp32 f and carry, rounded once at the end.
struct Streamed {
  typedef float Carry;
  static constexpr int kWords = 2;
  __device__ static __forceinline__ float fuse(float a, float t, float b, float c) {
    return __fadd_rn(__fmul_rn(a, t), __fmul_rn(b, c));
  }
  __device__ static __forceinline__ float next(float up_bias, float f) {
    return __fadd_rn(up_bias, f);
  }
};

__device__ __forceinline__ float activation(float z, int gelu) {
  return gelu ? 0.5f * z * erfcf(-z * 0.70710678118654752f) : fmaxf(z, 0.f);
}

// ---- eight values at a time ------------------------------------------------

__device__ __forceinline__ void unpack(const uint4& u, float (&v)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 f = __bfloat1622float2(h[q]);
    v[2 * q] = f.x;
    v[2 * q + 1] = f.y;
  }
}

__device__ __forceinline__ uint4 pack(const float (&v)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int q = 0; q < 4; ++q) h[q] = __floats2bfloat162_rn(v[2 * q], v[2 * q + 1]);
  return u;
}

// bf16 values p[0..n), zeros past n (n <= 8); one 16-byte load when `vec`
// and n == 8.  kNc: read-only data (the non-coherent path).
template <bool kNc>
__device__ __forceinline__ uint4 load8(const bf16* p, int n, int vec) {
  if (vec && n == 8)
    return kNc ? __ldg(reinterpret_cast<const uint4*>(p)) : *reinterpret_cast<const uint4*>(p);
  uint4 u = make_uint4(0, 0, 0, 0);
  unsigned short* h = reinterpret_cast<unsigned short*>(&u);
  const unsigned short* s = reinterpret_cast<const unsigned short*>(p);
  for (int e = 0; e < n; ++e) h[e] = s[e];
  return u;
}

__device__ __forceinline__ void load8(const float* p, int n, int vec, uint4 (&w)[2]) {
  if (vec && n == 8) {
    w[0] = *reinterpret_cast<const uint4*>(p);
    w[1] = *reinterpret_cast<const uint4*>(p + 4);
    return;
  }
  float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int e = 0; e < n; ++e) v[e] = p[e];
  w[0] = make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                    __float_as_uint(v[3]));
  w[1] = make_uint4(__float_as_uint(v[4]), __float_as_uint(v[5]), __float_as_uint(v[6]),
                    __float_as_uint(v[7]));
}

__device__ __forceinline__ void store8(bf16* p, int n, int vec, const float (&v)[8]) {
  if (vec && n == 8) {
    *reinterpret_cast<uint4*>(p) = pack(v);
    return;
  }
  for (int e = 0; e < n; ++e) p[e] = __float2bfloat16_rn(v[e]);
}

__device__ __forceinline__ void store8(float* p, int n, int vec, const float (&v)[8]) {
  if (vec && n == 8) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
    return;
  }
  for (int e = 0; e < n; ++e) p[e] = v[e];
}

// The carry's 8 values from their raw words: bf16 (kWords 1 or step 0's
// c0) or fp32.
template <int kWords>
__device__ __forceinline__ void carry_values(const uint4 (&w)[kWords], bool bf16_words,
                                             float (&v)[8]) {
  if (kWords == 1 || bf16_words) {
    unpack(w[0], v);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[e] = __uint_as_float((&w[0].x)[e]);
      v[4 + e] = __uint_as_float((&w[kWords - 1].x)[e]);
    }
  }
}

// Two neighbouring values of the carry storage (the accumulator's pairs).
__device__ __forceinline__ float2 load2(const bf16* p, int n, int vec) {
  if (vec && n == 2) return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  return make_float2(n > 0 ? __bfloat162float(p[0]) : 0.f, n > 1 ? __bfloat162float(p[1]) : 0.f);
}

__device__ __forceinline__ float2 load2(const float* p, int n, int vec) {
  if (vec && n == 2) return *reinterpret_cast<const float2*>(p);
  return make_float2(n > 0 ? p[0] : 0.f, n > 1 ? p[1] : 0.f);
}

__device__ __forceinline__ void store2(bf16* p, int n, int vec, float x, float y) {
  if (vec && n == 2) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
    return;
  }
  if (n > 0) p[0] = __float2bfloat16_rn(x);
  if (n > 1) p[1] = __float2bfloat16_rn(y);
}

__device__ __forceinline__ void store2(float* p, int n, int vec, float x, float y) {
  if (vec && n == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x, y);
    return;
  }
  if (n > 0) p[0] = x;
  if (n > 1) p[1] = y;
}

// ---- the kernel ------------------------------------------------------------

// The carry slice of a block: rows m0.. of its branch, columns d_first..;
// in shared memory (kSmem: 64 x ldc, row-major) or in device memory (the
// (S, N, D) `carry` of Params).
template <class Chain, bool kSmem>
struct CarrySlice {
  typedef typename Chain::Carry Carry;
  Carry* base;  // kSmem: the shared slice; else the branch's first row of p.carry
  int ld;       // row stride in elements
  int d_first, m0;
  __device__ __forceinline__ Carry* at(int r, int d) const {
    return kSmem ? base + r * ld + (d - d_first)
                 : base + static_cast<size_t>(m0 + r) * ld + d;
  }
};

// One block: rows m0..m0+63 of branch blockIdx.y, chunks [c_first, c_first
// + nc) of D, all K steps.  A thread forms f for rows fr + 16 u (u = 0..3,
// fr = tid / 8), columns fc..fc+7 (fc = 8 (tid % 8)) of a chunk.  The
// block's state is one object whose members are always inlined, and the
// two-chunk register buffers are indexed by template constants, so that
// everything stays in registers.
template <class Chain, int Rc, bool kSmem>
struct Block {
  typedef typename Chain::Carry Carry;
  static constexpr int kW = Chain::kWords;
  static constexpr int kPld = Rc + 8;           // partial row stride, floats
  static constexpr int kUnits = kRows * Rc / 8;  // 8-column units of z

  const Params& p;
  const CUtensorMap* tapmap;
  const CUtensorMap* wdmap;
  const CUtensorMap* wumap;
  unsigned char* base;
  Layout L;
  cg::cluster_group cluster;
  int C, rank, tid, warp, lane, s, m0, nc, d_first, per_step, items, fr, fc;
  size_t plane;  // this branch's first row
  CarrySlice<Chain, kSmem> cs;
  uint64_t* full;
  float* partial;  // the f slots' bytes, once the down product is done
  int q;           // the next weight item to consume
  int i, pass;     // the step and the down product's pass
  float ca, cb;    // the step's coefficients
  // A device-memory carry's values of a chunk, two chunks ahead: c0 at
  // step 0, the carry, or f in later passes.
  uint4 car[2][4][kSmem ? 1 : kW];
  float z[Rc / 2];
  float acc[32];  // a chunk's up product
  float2 bu_next[8];

  __device__ __forceinline__ Block(const Params& p_, const CUtensorMap* tp, const CUtensorMap* wd,
                                   const CUtensorMap* wu, unsigned char* smem)
      : p(p_), tapmap(tp), wdmap(wd), wumap(wu), base(smem), L(Rc, p_.stages, p_.r_slices,
                                                    kSmem ? kRows * (p_.cpb * kCols + 8) *
                                                                static_cast<int>(sizeof(Carry))
                                                          : 0),
        cluster(cg::this_cluster()) {
    C = static_cast<int>(cluster.num_blocks());
    rank = static_cast<int>(cluster.block_rank());
    tid = threadIdx.x;
    warp = tid / 32;
    lane = tid % 32;
    s = blockIdx.y;
    m0 = blockIdx.x / C * kRows;
    const int chunks = (p.D + kCols - 1) / kCols;
    nc = min(p.cpb, chunks - rank * p.cpb);
    d_first = rank * p.cpb * kCols;
    per_step = nc * (p.passes + p.r_slices);
    items = p.K * per_step;
    fr = tid / 8;
    fc = (tid % 8) * 8;
    plane = static_cast<size_t>(s) * p.N;
    cs.base = kSmem ? reinterpret_cast<Carry*>(base + L.carry)
                    : static_cast<Carry*>(p.carry) + plane * p.D;
    cs.ld = kSmem ? p.cpb * kCols + 8 : p.D;
    cs.d_first = d_first;
    cs.m0 = m0;
    full = reinterpret_cast<uint64_t*>(base + L.bars);
    partial = reinterpret_cast<float*>(base);
    q = 0;
  }

  // Item t of the TMA stream into its stage: a step's down items (pass,
  // chunk: the chunk's tap box and wd rows), then its up items (chunk, 64
  // rows of R of wu).  Tap i of a row is the row's columns i D8 ...
  __device__ __forceinline__ void issue(int t) const {
    const int S = p.stages, st = t / per_step;
    int rem = t - st * per_step;
    uint64_t* bar = &full[t % S];
    unsigned char* dst = base + L.w + (t % S) * L.stage;
    const int sk = s * p.K + st;
    if (rem < p.passes * nc) {
      const int ps = rem / nc, c = rem - ps * nc;
      sm90::mbar_expect_tx(bar, L.stage);
      sm90::tma_load_2d(dst, tapmap, bar, st * ((p.D + 7) / 8 * 8) + d_first + c * kCols,
                        static_cast<int>(plane) + m0);
#pragma unroll
      for (int b = 0; b < Rc / kCols; ++b)
        sm90::tma_load_3d(dst + (1 + b) * kBox, wdmap, bar, ps * Rc + b * kCols,
                          d_first + c * kCols, sk);
    } else {
      rem -= p.passes * nc;
      const int c = rem / p.r_slices, sl = rem - c * p.r_slices;
      sm90::mbar_expect_tx(bar, kBox);
      sm90::tma_load_3d(dst, wumap, bar, d_first + c * kCols, sl * kCols, sk);
    }
  }

  // Waits for item q + ahead (issued: at most S - 1 ahead).
  __device__ __forceinline__ void wait_item(int ahead = 0) const {
    sm90::mbar_wait(&full[(q + ahead) % p.stages], ((q + ahead) / p.stages) & 1);
  }
  __device__ __forceinline__ unsigned char* stage(int ahead = 0) const {
    return base + L.w + ((q + ahead) % p.stages) * L.stage;
  }
  __device__ __forceinline__ uint32_t stage_addr() const { return sm90::smem_u32(stage()); }
  // Every thread is past the wgmmas of item q: its stage takes item q + S.
  __device__ __forceinline__ void release_item() {
    sm90::warpgroup_sync(1);
    if (tid == 0 && q + p.stages < items) issue(q + p.stages);
    ++q;
  }

  template <int B>
  __device__ __forceinline__ void load_raw(int c) {
    if constexpr (!kSmem) {
      const int d = d_first + c * kCols + fc, n = min(8, max(0, p.D - d));
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int row = m0 + fr + 16 * u;
        const int nn = row < p.N ? n : 0;
        if (pass == 0 && i == 0)
          car[B][u][0] = load8<true>(p.c0 + (plane + row) * p.D + d, nn, p.vec);
        else if constexpr (kW == 1)
          car[B][u][0] = load8<false>(cs.at(fr + 16 * u, d), nn, p.vec);
        else
          load8(cs.at(fr + 16 * u, d), nn, p.vec, car[B][u]);
      }
    }
  }

  // f of chunk c (item q + ahead: its tap box) into f slot B (swizzled,
  // bf16), and in pass 0 into the carry storage (in place: the old carry is
  // dead once f is formed).  Columns past D and rows past N take a zero tap.
  template <int B>
  __device__ __forceinline__ void form(int c, int ahead) {
    const int d = d_first + c * kCols + fc, n = min(8, max(0, p.D - d));
    unsigned char* a = base + B * kBox;
    const unsigned char* taps = stage(ahead);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int r = fr + 16 * u, row = m0 + r;
      float f[8], cv[8];
      if (pass == 0 && i == 0) {
        if constexpr (kSmem)
          unpack(load8<true>(p.c0 + (plane + row) * p.D + d, row < p.N ? n : 0, p.vec), cv);
        else
          unpack(car[B][u][0], cv);
      } else if constexpr (kSmem) {
        uint4 w[kW];
#pragma unroll
        for (int k = 0; k < kW; ++k) w[k] = reinterpret_cast<const uint4*>(cs.at(r, d))[k];
        carry_values<kW>(w, false, cv);
      } else {
        carry_values<kW>(car[B][u], false, cv);
      }
      if (pass == 0) {
        float tv[8];
        unpack(*reinterpret_cast<const uint4*>(taps + r * 128 + (((fc / 8) ^ (r % 8)) * 16)), tv);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          f[e] = Chain::fuse(ca, e < n && row < p.N ? tv[e] : 0.f, cb, cv[e]);
        if (kSmem)
          store8(cs.at(r, d), 8, 1, f);
        else if (row < p.N)
          store8(cs.at(r, d), n, p.vec, f);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) f[e] = cv[e];
      }
      *reinterpret_cast<uint4*>(a + r * 128 + (((fc / 8) ^ (r % 8)) * 16)) = pack(f);
    }
  }

  // Chunk c (B = c % 2, item q, its f formed): its wgmma, the next chunk's
  // f while it runs, then a device-memory carry's loads of chunk c + 3 into
  // the registers chunk c + 1 used.
  template <int B>
  __device__ __forceinline__ void down(int c) {
    wait_item();
    const uint32_t a = sm90::smem_u32(base + B * kBox), w = stage_addr() + kBox;  // past the taps
    sm90::fence_acc(z);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kCols / 16; ++kk)
      sm90::Wgmma<Rc>::mma(z, sm90::desc_a(a + kk * 32), sm90::desc_w(w + kk * 2048),
                           c == 0 && kk == 0 ? 0 : 1);
    sm90::wgmma_commit();
    if (c + 1 < nc) {
      wait_item(1);
      form<1 - B>(c + 1, 1);
      sm90::fence_async_shared();
    }
    sm90::wgmma_wait<0>();
    sm90::fence_acc(z);
    release_item();
    if (c + 3 < nc) load_raw<1 - B>(c + 3);
  }

  // z (64 x Rc) of this pass over the slice.
  __device__ __forceinline__ void down_product() {
    load_raw<0>(0);
    if (nc > 1) load_raw<1>(1);
    wait_item();
    form<0>(0, 0);
    if (nc > 2) load_raw<0>(2);
    sm90::fence_async_shared();
    sm90::warpgroup_sync(1);
    for (int c = 0; c < nc; c += 2) {
      down<0>(c);
      if (c + 1 < nc) down<1>(c + 1);
    }
  }

  __device__ __forceinline__ int act_at(int u) const {  // unit u's 16 bytes in an act buffer
    const int r = u / (Rc / 8), c8 = u % (Rc / 8), col = pass * Rc + c8 * 8;
    return L.act + col / kCols * kBox + r * 128 + (((c8 % 8) ^ (r % 8)) * 16);
  }
  __device__ __forceinline__ bool live(int u) const {
    return pass * Rc + u % (Rc / 8) * 8 < p.r_slices * kCols;
  }

  // z across the cluster.  Each block leaves its partial in its own shared
  // memory (the f slots, free now); block `rank` sums units rank, rank + C,
  // ... over all C partials in rank order (the same bits wherever a unit is
  // summed), adds bd and applies the activation into its own activation
  // buffer; then every block copies the other blocks' units from theirs.
  __device__ __forceinline__ void reduce() {
#pragma unroll
    for (int j = 0; j < Rc / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = warp * 16 + lane / 4 + 8 * h, col = 8 * j + 2 * (lane % 4);
        *reinterpret_cast<float2*>(partial + r * kPld + col) =
            make_float2(z[4 * j + 2 * h], z[4 * j + 2 * h + 1]);
      }
    cluster.sync();  // every partial is written
    for (int u = rank + C * tid; u < kUnits; u += C * kThreads) {
      if (!live(u)) continue;
      const int r = u / (Rc / 8), c8 = u % (Rc / 8);
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (int r0 = 0; r0 < C; r0 += 4) {  // four ranks' loads in flight, added in order
        float4 x[4][2];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (r0 + k < C) {
            const float* src = cluster.map_shared_rank(partial, r0 + k) + r * kPld + c8 * 8;
            x[k][0] = *reinterpret_cast<const float4*>(src);
            x[k][1] = *reinterpret_cast<const float4*>(src + 4);
          }
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (r0 + k < C) {
            v[0] += x[k][0].x; v[1] += x[k][0].y; v[2] += x[k][0].z; v[3] += x[k][0].w;
            v[4] += x[k][1].x; v[5] += x[k][1].y; v[6] += x[k][1].z; v[7] += x[k][1].w;
          }
      }
      const int col = pass * Rc + c8 * 8;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int rr = col + e;
        const float bias = rr < p.R ? __bfloat162float(p.bd[(s * p.K + i) * p.R + rr]) : 0.f;
        v[e] = activation(v[e] + bias, p.gelu);
      }
      *reinterpret_cast<uint4*>(base + act_at(u)) = pack(v);
    }
    cluster.sync();  // every unit is summed
    if (C > 1) {
      constexpr int kPer = (kUnits + kThreads - 1) / kThreads;
      uint4 got[kPer];
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int u = tid + k * kThreads;
        if (u < kUnits && u % C != rank && live(u))
          got[k] = *reinterpret_cast<const uint4*>(cluster.map_shared_rank(base, u % C) +
                                                   act_at(u));
      }
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int u = tid + k * kThreads;
        if (u < kUnits && u % C != rank && live(u))
          *reinterpret_cast<uint4*>(base + act_at(u)) = got[k];
      }
    }
    sm90::fence_async_shared();
    sm90::warpgroup_sync(1);
  }

  // bu of chunk c at the accumulator's positions into bu_next: chunk 0's
  // before the step's down product, chunk c + 1's while chunk c multiplies.
  __device__ __forceinline__ void load_bu(int c) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d = d_first + c * kCols + 8 * j + 2 * (lane % 4), n = min(2, max(0, p.D - d));
      bu_next[j] = load2(p.bu + static_cast<size_t>(s * p.K + i) * p.D + d, n, p.vec);
    }
  }

  // Slice sl of the up product of the chunk whose item is q into acc
  // (64 rows of R of the activations against the item's wu box),
  // committed, not waited for.
  __device__ __forceinline__ void issue_up(int sl) {
    wait_item();
    const uint32_t a = sm90::smem_u32(base + L.act + sl * kBox), w = stage_addr();
    sm90::fence_acc(acc);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kCols / 16; ++kk)
      sm90::Wgmma<64>::mma(acc, sm90::desc_a(a + kk * 32), sm90::desc_w(w + kk * 2048),
                           sl == 0 && kk == 0 ? 0 : 1);
    sm90::wgmma_commit();
  }

  // The new carry of chunk c (the output after the last step) from its up
  // product acc, bu and f (fv: a device-memory carry's f at the positions
  // 2 j + h, loaded earlier; f in shared memory is read here).
  __device__ __forceinline__ void epilogue(int c, const float2 (&bv)[8], const float2 (&fv)[16]) {
    const bool last = i == p.K - 1;
    const int N = p.N, D = p.D, dc = d_first + c * kCols;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d = dc + 8 * j + 2 * (lane % 4), n = min(2, max(0, D - d));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = warp * 16 + lane / 4 + 8 * h, row = m0 + r;
        const float2 f = kSmem ? load2(cs.at(r, d), 2, 1) : fv[2 * j + h];
        const float x = Chain::next(__fadd_rn(acc[4 * j + 2 * h], bv[j].x), f.x);
        const float y = Chain::next(__fadd_rn(acc[4 * j + 2 * h + 1], bv[j].y), f.y);
        if (last) {
          if (row < N) store2(p.out + (plane + row) * D + d, n, p.vec, x, y);
        } else if (kSmem) {
          store2(cs.at(r, d), 2, 1, x, y);
        } else if (row < N) {
          store2(cs.at(r, d), n, p.vec, x, y);
        }
      }
    }
  }

  // The up product per 64-column chunk and the new carry (the output after
  // the last step).
  __device__ __forceinline__ void up_product() {
    for (int c = 0; c < nc; ++c) {
      float2 bv[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) bv[j] = bu_next[j];
      if (c + 1 < nc) load_bu(c + 1);
      // f from device memory at the accumulator's positions, loaded before
      // the products (f in shared memory is read in the epilogue)
      float2 fv[16];
      if constexpr (!kSmem) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int d = d_first + c * kCols + 8 * j + 2 * (lane % 4);
          const int n = min(2, max(0, p.D - d));
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = warp * 16 + lane / 4 + 8 * h;
            fv[2 * j + h] = load2(cs.at(r, d), m0 + r < p.N ? n : 0, p.vec);
          }
        }
      }
      for (int sl = 0; sl < p.r_slices; ++sl) {
        issue_up(sl);
        sm90::wgmma_wait<0>();
        sm90::fence_acc(acc);
        release_item();
      }
      epilogue(c, bv, fv);
    }
    sm90::warpgroup_sync(1);  // the step's carry is complete before the next step reads it
  }

  __device__ __forceinline__ void run() {
    if (tid == 0) {
      for (int st = 0; st < p.stages; ++st) sm90::mbar_init(&full[st], 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      for (int t = 0; t < p.stages && t < items; ++t) issue(t);
    }
    __syncthreads();
    for (i = 0; i < p.K; ++i) {
      ca = p.coef_a[s * p.K + i];
      cb = p.coef_b[s * p.K + i];
      load_bu(0);
      for (pass = 0; pass < p.passes; ++pass) {
        down_product();
        reduce();
      }
      up_product();
    }
    cluster.sync();  // no block leaves while another may read its shared memory
  }
};

template <class Chain, int Rc, bool kSmem>
__global__ void __launch_bounds__(kThreads, 1)
    cascade_kernel(const __grid_constant__ CUtensorMap tapmap,
                   const __grid_constant__ CUtensorMap wdmap,
                   const __grid_constant__ CUtensorMap wumap, const __grid_constant__ Params p) {
  extern __shared__ __align__(1024) unsigned char cascade_smem[];
  const uint32_t raw_addr = sm90::smem_u32(cascade_smem);
  Block<Chain, Rc, kSmem> block(p, &tapmap, &wdmap, &wumap,
                                cascade_smem + (((raw_addr + 1023) & ~1023u) - raw_addr));
  block.run();
}

// Launches one call: taps (S, N, K, D8), wd (S, K, D, R8) and wu (S, K, R,
// D8) bf16 with R8 = R and D8 = D rounded up to 8 elements (zero padded),
// 16-byte aligned; grid (row tiles x cluster, S), cluster (cluster, 1, 1).
template <class Chain, int Rc, bool kSmem>
cudaError_t launch_rc(const CUtensorMap& tapmap, const CUtensorMap& wdmap, const CUtensorMap& wumap,
                      const Params& p, int S, int cluster, cudaStream_t stream) {
  auto kernel = cascade_kernel<Chain, Rc, kSmem>;
  const int carry_bytes =
      kSmem ? kRows * (p.cpb * kCols + 8) * static_cast<int>(sizeof(typename Chain::Carry)) : 0;
  const Layout L(Rc, p.stages, p.r_slices, carry_bytes);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         L.bytes);
  if (err != cudaSuccess) return err;
  if (cluster > 8) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((p.N + kRows - 1) / kRows * cluster, S, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = L.bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, tapmap, wdmap, wumap, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

inline bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

// The plan's geometry (cascade_plan in ops/fused_san.py): `cluster` blocks
// of `d_slice` columns a row tile, the down product in passes of `r_chunk`
// columns of R, `stages` weight boxes in flight, the carry slice in shared
// memory when `smem_carry`.  Refuses a plan that does not cover D and R or
// does not fit.
template <class Chain>
cudaError_t launch(Params p, const void* wd, const void* wu, int S, int cluster, int d_slice,
                   int r_chunk, int stages, int smem_carry, cudaStream_t stream) {
  const int chunks = (p.D + kCols - 1) / kCols;
  p.cpb = d_slice / kCols;
  p.r_slices = (p.R + kCols - 1) / kCols;
  p.passes = r_chunk > 0 ? (p.r_slices * kCols + r_chunk - 1) / r_chunk : 0;
  p.stages = stages;
  const int carry_bytes =
      smem_carry ? kRows * (d_slice + 8) * static_cast<int>(sizeof(typename Chain::Carry)) : 0;
  const bool ok = p.N > 0 && p.K > 0 && p.D > 0 && p.R > 0 && cluster >= 1 &&
                  cluster <= kMaxCluster && d_slice % kCols == 0 && p.cpb >= 1 &&
                  (cluster - 1) * p.cpb < chunks && cluster * p.cpb >= chunks &&
                  r_chunk % kCols == 0 && r_chunk >= kCols && r_chunk <= 256 && stages >= 2 &&
                  Layout(r_chunk, stages, p.r_slices, carry_bytes).bytes <= 232448;
  if (!ok) return cudaErrorInvalidValue;
  p.vec = p.D % 8 == 0 && aligned16(p.c0) && aligned16(p.carry) && aligned16(p.out);
  const uint64_t R8 = (p.R + 7) / 8 * 8, D8 = (p.D + 7) / 8 * 8;
  CUtensorMap tapmap, wdmap, wumap;
  cudaError_t err = sm90::encode_2d(&tapmap, p.taps, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                                    static_cast<uint64_t>(p.K) * D8,
                                    static_cast<uint64_t>(S) * p.N, kCols, kRows);
  if (err != cudaSuccess) return err;
  err = sm90::encode_planes(&wdmap, wd, R8, p.D, static_cast<uint64_t>(S) * p.K);
  if (err != cudaSuccess) return err;
  err = sm90::encode_planes(&wumap, wu, D8, p.R, static_cast<uint64_t>(S) * p.K);
  if (err != cudaSuccess) return err;
#define IISAN_CASCADE_RC(RC)                                                            \
  return smem_carry ? launch_rc<Chain, RC, true>(tapmap, wdmap, wumap, p, S, cluster, stream) \
                    : launch_rc<Chain, RC, false>(tapmap, wdmap, wumap, p, S, cluster, stream)
  switch (r_chunk) {
    case 64: IISAN_CASCADE_RC(64);
    case 128: IISAN_CASCADE_RC(128);
    case 192: IISAN_CASCADE_RC(192);
    default: IISAN_CASCADE_RC(256);
  }
#undef IISAN_CASCADE_RC
}

}  // namespace cascade
}  // namespace iisan
