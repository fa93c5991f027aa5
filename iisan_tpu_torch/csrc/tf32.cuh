// Three-pass TF32 on Hopper's tensor cores: the fp32 products of the
// attention kernels (mha.cuh, mha_fwd.cu, mha_bwd.cu) and of the fp32 user
// encoder (user_encoder_f32.cuh).  Each product a . b of fp32 operands
// runs as
//   lo_a . hi_b + hi_a . lo_b + hi_a . hi_b,   hi = tf32(x), lo = tf32(x - hi),
// on wgmma m64n64k8 .tf32 with fp32 sums; tf32() is cvt.rna (round to
// nearest, ties away from zero, to 10 mantissa bits).  x - hi is exact in
// fp32, so hi + lo holds 22 of fp32's 24 bits and the dropped lo . lo is
// about 2^-22 of a product: the plain fp32 function within 1e-4, where one
// pass (hi . hi) keeps about three digits.
//
// A shared-memory operand is a 64 x 64 K-major tile in 128-byte-swizzled
// layout: two boxes of 64 rows x 32 fp32 columns (a box row is the
// swizzle's 128 bytes), 1024-byte aligned; wgmma reads 32-bit operands
// from shared memory K-major only (no transpose bit).  A register operand
// is the m64k8 .tf32 A fragment (`Frags`).
#pragma once

#include <cstdint>

#include "sm90_gemm.cuh"

namespace iisan {
namespace tf32 {

constexpr int kF32Box = 64 * 32 * 4;  // 64 rows x 32 fp32 columns: 8 KB
constexpr int kF32Tile = 2 * kF32Box;  // a 64 x 64 fp32 tile: 16 KB

// Keeps A fragments in their registers until the wgmmas reading them are
// waited for.
__device__ __forceinline__ void fence_frag(unsigned (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// tf32_rna's value for every finite x by integer arithmetic (half an ulp
// of tf32 added to the magnitude, the low 13 bits cleared: round half away
// from zero), on the full-rate ALU where cvt.rna takes the conversion
// pipe; for operands split by the hundred in a thread.
__device__ __forceinline__ float tf32_round(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

// The raw tile at raw split into hi and lo tiles (hi may be raw itself) by
// kT threads (thread threadIdx.x % kT: a warpgroup, or a block of two).
template <int kT = 128>
__device__ __forceinline__ void split_tile(const unsigned char* raw, unsigned char* hi,
                                           unsigned char* lo) {
  const float4* x4 = reinterpret_cast<const float4*>(raw);
  float4* h4 = reinterpret_cast<float4*>(hi);
  float4* l4 = reinterpret_cast<float4*>(lo);
#pragma unroll 4
  for (int i = threadIdx.x % kT; i < kF32Tile / 16; i += kT) {
    const float4 x = x4[i];
    const float4 h = make_float4(tf32_rna(x.x), tf32_rna(x.y), tf32_rna(x.z), tf32_rna(x.w));
    h4[i] = h;
    l4[i] = make_float4(tf32_rna(x.x - h.x), tf32_rna(x.y - h.y), tf32_rna(x.z - h.z),
                        tf32_rna(x.w - h.w));
  }
}

// The transposed copy, 16 bytes at a time, by kT threads: thread tid's
// chunks k = 0 .. 1024 / kT - 1 are cc = tid / 64 + (kT / 64) k, chunk c =
// cc % 8 of box cc / 8 in row n = tid % 64 of the copy, i.e. K positions
// 4 c .. 4 c + 3 of that box: rows 32 (cc / 8) + 8 (c / 2) + c % 2 + {0,
// 2, 4, 6} of the source, column n (a warp reads one 128-byte source row a
// step, and writes four wavefronts of 16-byte chunks).
__device__ __forceinline__ int f32_offset(int row, int col) {  // byte of (row, col) in a tile
  return (col >> 5) * kF32Box + row * 128 + ((((col & 31) >> 2) ^ (row & 7)) << 4) +
         ((col & 3) << 2);
}

// Chunk k of this thread's share: its four source values, and its 16
// bytes of the copy.
template <int kT>
__device__ __forceinline__ void gather_chunk(float (&v)[4], const unsigned char* src, int k) {
  const int tid = threadIdx.x % kT, n = tid & 63, cc = (tid >> 6) + (kT >> 6) * k, c = cc & 7;
  const int r0 = 32 * (cc >> 3) + 8 * (c >> 1) + (c & 1);
#pragma unroll
  for (int u = 0; u < 4; ++u)
    v[u] = *reinterpret_cast<const float*>(src + f32_offset(r0 + 2 * u, n));
}

template <int kT>
__device__ __forceinline__ void scatter_chunk(unsigned char* dst, const float (&v)[4], int k) {
  const int tid = threadIdx.x % kT, n = tid & 63, cc = (tid >> 6) + (kT >> 6) * k, c = cc & 7;
  *reinterpret_cast<float4*>(dst + (cc >> 3) * kF32Box + n * 128 + ((c ^ (n & 7)) << 4)) =
      make_float4(v[0], v[1], v[2], v[3]);
}

// The transposed copies of a split tile's hi and lo by kT threads (four
// chunks in flight at a time).
template <int kT>
__device__ __forceinline__ void transpose_pair(unsigned char* th, unsigned char* tl,
                                               const unsigned char* hi, const unsigned char* lo) {
#pragma unroll
  for (int k0 = 0; k0 < 1024 / kT; k0 += 4) {
    float v[4][4], w[4][4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      gather_chunk<kT>(v[k], hi, k0 + k);
      gather_chunk<kT>(w[k], lo, k0 + k);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      scatter_chunk<kT>(th, v[k], k0 + k);
      scatter_chunk<kT>(tl, w[k], k0 + k);
    }
  }
}

// d (+)= a . b on a 64 x 64 x 8 tile, .tf32 operands both from shared
// memory (K-major), fp32 sums; scale_d 0 starts the sum.
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// The same with a from registers: the m64k8 .tf32 A fragment, a warp's 16
// rows, (row g, K t), (g + 8, t), (g, t + 4), (g + 8, t + 4).
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[32], const unsigned (&a)[4], uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// The descriptor of k8 step s (0-7) of a K-major tile at byte address t.
__device__ __forceinline__ uint64_t f32_desc(uint32_t t, int s) {
  return sm90::desc_a(t + (s >> 2) * kF32Box + (s & 3) * 32);
}

// Issues d (+)= a . b^T over 64 K values in three TF32 passes, a and b
// split K-major tiles (hi, lo) in shared memory; acc 0 starts the sum.
__device__ __forceinline__ void mma3_ss(float (&d)[32], uint32_t ah, uint32_t al, uint32_t bh,
                                        uint32_t bl, int acc) {
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    wgmma_tf32(d, f32_desc(al, s), f32_desc(bh, s), acc || s > 0);
    wgmma_tf32(d, f32_desc(ah, s), f32_desc(bl, s), 1);
    wgmma_tf32(d, f32_desc(ah, s), f32_desc(bh, s), 1);
  }
}

// The A fragments, hi and lo, of a 64 x 64 fp32 accumulator tile x (the
// layout of S: x[4 j + e] is row g + 8 (e / 2), column 8 j + 2t + e % 2).
struct Frags {
  unsigned hi[8][4], lo[8][4];
};

__device__ __forceinline__ void make_frags(Frags& f, const float (&x)[32]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float v = x[4 * j + ((r & 1) << 1) + (r >> 1)];  // r = 0, 1, 2, 3: e = 0, 2, 1, 3
      const float h = tf32_rna(v);
      f.hi[j][r] = __float_as_uint(h);
      f.lo[j][r] = __float_as_uint(tf32_rna(v - h));
    }
}

__device__ __forceinline__ void fence_frags(Frags& f) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    fence_frag(f.hi[j]);
    fence_frag(f.lo[j]);
  }
}

// Issues d += x . b over K values 0 .. 8 steps - 1 (8-value steps wholly
// past T add nothing and are skipped) in three TF32 passes: x's fragments
// from registers, b a transposed (K-major) split tile pair.
__device__ __forceinline__ void mma3_rs(float (&d)[32], Frags& f, uint32_t bh, uint32_t bl,
                                        int steps) {
  fence_frags(f);
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    if (s >= steps) break;
    wgmma_tf32_rs(d, f.lo[s], f32_desc(bh, s), 1);
    wgmma_tf32_rs(d, f.hi[s], f32_desc(bl, s), 1);
    wgmma_tf32_rs(d, f.hi[s], f32_desc(bh, s), 1);
  }
}

}  // namespace tf32
}  // namespace iisan
