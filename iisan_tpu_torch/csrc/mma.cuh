// Tensor-core and asynchronous-copy helpers of the attention and
// user-encoder kernels (mha.cuh, mha_bwd.cu, user_encoder_tc.cuh):
// `mma.sync` on bf16 tiles, `ldmatrix` of bf16 tiles (plain and
// transposed), `cp.async` 16-byte (and 4-byte) copies into shared memory,
// and paired stores.
//
// Fragment layouts (PTX ISA, mma.m16n8k16), with g = lane / 4 and t = lane
// % 4, for A a row-major (16, k) tile and B an (8, k) tile stored row by
// row (B's columns are rows of the weight's transpose):
//   bf16 k16: A regs (row g, k 2t..2t+1), (g+8, 2t), (g, 2t+8), (g+8, 2t+8);
//             B regs (n g, k 2t..2t+1), (g, 2t+8);
//   C (fp32): (row g, n 2t..2t+1), (g+8, 2t..2t+1).
// So every register is one aligned 32-bit load from shared memory, and the
// C tiles of n-columns 16c..16c+15 are, packed to bf16 in pairs, the A
// fragment of a product over k = those columns.  A B operand stored (k, n)
// row by row (attention's V: keys x head width) comes through
// `ldsm_x4_trans`.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace iisan {

__device__ __forceinline__ unsigned lds32(const void* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

// A 16-byte copy that reads src_bytes (0 or 16) of gmem and fills the rest
// of the 16 bytes with zeros.
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// c += a . b on a 16 x 8 x 16 bf16 tile: exact products, fp32 sums.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8 x 8 bf16 matrices, transposed: lanes 8i..8i+7 give the addresses
// of matrix i's eight 16-byte rows; lane l receives, of each matrix, the
// elements (row 2(l%4), column l/4) and (row 2(l%4)+1, column l/4).  For a
// (k, n) operand stored row by row that is the B fragment of mma.m16n8k16.
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const void* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// Two 8 x 8 bf16 matrices: lanes 8i..8i+7 give the addresses of matrix
// i's eight 16-byte rows (lanes 16-31 repeat 0-15); lane l receives, of
// each matrix, the elements (row l/4, columns 2(l%4), 2(l%4)+1).  For an
// (n, k) operand stored row by row, matrices at k and k+8 are the B
// fragment of mma.m16n8k16.
__device__ __forceinline__ void ldsm_x2(unsigned (&r)[2], const void* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(s));
}

// The same, transposed (as ldsm_x4_trans): for a (k, n) operand stored row
// by row, matrices at rows k and k+8 are the B fragment of mma.m16n8k16.
__device__ __forceinline__ void ldsm_x2_trans(unsigned (&r)[2], const void* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(s));
}

// Two fp32 values that are bf16 numbers already, packed (lo in the low half).
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// Two neighbouring outputs, rounded to T (8-byte or 4-byte aligned store).
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

}  // namespace iisan
