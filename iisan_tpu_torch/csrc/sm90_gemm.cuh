// Hopper pieces of the port's wgmma GEMMs: TMA tile loads into 128-byte-
// swizzled shared memory, mbarrier rings, and `wgmma`, in one
// warp-specialised persistent kernel body, `gemm_block`, over two operand
// kinds:
//
// * `Bf16`, the subblocks' projections (attn_subblock_fwd.cu):
//     out[m][n] = bf16(((bias[n] + c_0) + c_1) + ...),
//     c_g = sum over k in [g kg, (g + 1) kg) of a[m][k] w[k][n], fp32;
//   a (M, K) bf16 row-major (K-major for wgmma), w (K, N) bf16 row-major:
//   the JAX (in, out) layout, read as it is (MN-major B, the transposed-B
//   form wgmma takes for 16-bit types), so no weight is transposed or
//   copied per call.  One group (kg = K) is a plain product plus bias; kg =
//   4 heads' rows is #9's head-group accumulation.  The result is N / ldo
//   planes of (M, ldo), column n in plane n / ldo at column n % ldo: the
//   qkv projection routes each column of [q | k | v] to its own (M, D)
//   tensor (ldo = D), the output projection writes one (M, D) tensor.
// * `S8`, #10's product (w8a8_linear.cu):
//     out[m][n] = T(float(sum_k a[m][k] w[n][k]) * (sx[m] * kscale[n]) [+ bias[n]]),
//   a (M, K) and w (N, K) int8, both K-major (8-bit wgmma has no
//   transposed B), s32 sums, exact in any order.
//
// A K slice is 128 bytes of a row: 64 bf16 or 128 int8 values, one swizzle
// row, so both kinds share the ring's geometry.  A block is 3 warpgroups:
// warpgroup 0 gives up registers (setmaxnreg) and one of its threads keeps
// TMA loads of K slices (the 128-row slice of a and the BN-column slice of
// w) in flight through an S-deep ring guarded by "full" (TMA bytes landed)
// and "empty" (every consumer thread done) mbarriers; warpgroups 1 and 2
// take the tile's rows 0-63 and 64-127 and run wgmma m64nBN on each slice
// (four k16 bf16 or k32 int8 steps), one slice's wgmmas left in flight
// while the previous slice's stage is released.  The grid is one block an
// SM; a block walks the tiles t, t + gridDim.x, ... (n fastest), so the
// loads of its next tile overlap the epilogue of the last.  A consumer
// warpgroup rounds its 64 x BN results into a swizzled shared tile and one
// of its threads stores it with TMA, which runs on beside the next tile's
// products (an fp32 result is stored from registers instead).  Rows past M
// and columns past K come in as zeros (TMA fills them) and nothing past M
// or N is stored.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace iisan {
namespace sm90 {

typedef __nv_bfloat16 bf16;

constexpr int kBM = 128;                  // rows of a tile: two consumer warpgroups of 64
constexpr int kBK = 64;                   // bf16 K slice: 128 bytes, one swizzle row
constexpr int kBoxN = 64;                 // columns of one bf16 w box (128 bytes)
constexpr int kStages = 4;                // the subblocks' ring
constexpr int kThreads = 384;             // producer warpgroup + two consumer warpgroups
constexpr int kConsumers = 256;
constexpr int kATile = kBM * kBK * 2;     // 16 KB
constexpr int kWBox = kBK * kBoxN * 2;    // 8 KB: 64 K rows of 64 columns
constexpr int kOutBox = 64 * kBoxN * 2;   // 8 KB: 64 output rows of 64 columns

// Shared memory: S stages of (a slice, w slice: 128 bytes of K for each
// of 128 rows and BN columns), then each consumer warpgroup's output tile
// (64 rows x BN in bf16, as 64-column boxes), all 1024-aligned (the
// 128-byte swizzle repeats every 8 rows), then the barriers.
template <int BN, int S>
struct GemmLayout {
  static constexpr int stage = kATile + (BN / kBoxN) * kWBox;
  static constexpr int out_tile = (BN / kBoxN) * kOutBox;
  static constexpr size_t out = static_cast<size_t>(S) * stage;
  static constexpr size_t barriers = out + 2 * out_tile;
  static constexpr size_t bytes = barriers + 2 * S * sizeof(uint64_t) + 1024;  // + alignment
};

// ---------------------------------------------------------------------
// Host: tensor maps (libcuda's cuTensorMapEncodeTiled, fetched through the
// runtime, so the library needs no -lcuda) and the SM count.
// ---------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A row-major (outer, inner) matrix of `type` (elements of `elem` bytes)
// in boxes of (box_outer, box_inner), 128-byte swizzled (box_inner x elem
// = 128 bytes), zeros past the edges.  int8 is mapped as UINT8: a copy
// does not care about sign.
inline cudaError_t encode_2d(CUtensorMap* map, const void* ptr, CUtensorMapDataType type,
                             uint64_t elem, uint64_t inner, uint64_t outer, uint32_t box_inner,
                             uint32_t box_outer) {
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {inner * elem};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = fn(map, type, 2, const_cast<void*>(ptr), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The result's tensor map: `planes` bf16 (rows, cols) matrices one after
// another, rows `ld` elements apart (ld >= cols, a multiple of 8), in 64 x
// 64 boxes, 128-byte swizzled; rows and columns past the edges are not
// written.
inline cudaError_t encode_out(CUtensorMap* map, void* ptr, uint64_t cols, uint64_t rows,
                              uint64_t planes, uint64_t ld) {
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {cols, rows, planes};
  const cuuint64_t strides[2] = {ld * sizeof(bf16), rows * ld * sizeof(bf16)};
  const cuuint32_t box[3] = {kBoxN, 64, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, ptr, dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

// ---------------------------------------------------------------------
// Device: barriers, TMA, wgmma.
// ---------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Arrives once and adds `bytes` to the phase's expected transaction count.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Spins until the phase of parity `parity` has completed (a fresh barrier
// counts its phase before 0, parity 1, as completed).  A wait that never
// ends (a lost TMA transaction) traps after 2^24 polls, so the launch
// fails with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0, polls = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (++polls == (1u << 24)) __trap();
  } while (!done);
}

// The box at (inner, outer) of `map` into dst; completes on bar.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int inner, int outer) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(inner), "r"(outer)
      : "memory");
}

// The box of shared memory at src to (c0, c1, c2) of `map`, as one bulk
// group of this thread.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until this thread's bulk stores have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Waits until this thread's bulk stores are complete.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Makes this thread's shared-memory writes visible to the TMA engine.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier `id` (1 or 2: 0 is __syncthreads) over one warpgroup's 128 threads.
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator accesses across the
// asynchronous wgmma instructions.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int R>
__device__ __forceinline__ void fence_acc(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Shared-memory matrix descriptors, 128-byte swizzle (layout type 1):
// start address, leading and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// K-major operand: 128-byte rows of K values (64 bf16 or 128 int8), 8-row
// groups 1024 bytes apart (the leading offset is unused); a k16 bf16 or
// k32 int8 step is +32 bytes inside the row.  a of both kinds, and #10's w
// ((N, K) rows).
__device__ __forceinline__ uint64_t desc_a(uint32_t addr) { return smem_desc(addr, 16, 1024); }

// MN-major w: a box is 64 K rows of 128 bytes (64 columns); the next 64
// columns are the next box (kWBox bytes on), the next 8 K rows 1024 bytes
// on; a k16 step is +2048 bytes.
__device__ __forceinline__ uint64_t desc_w(uint32_t addr) { return smem_desc(addr, kWBox, 1024); }

// d (+)= a . w on a 64 x N x 16 tile: bf16 operands from shared memory, a
// K-major, w MN-major (imm-trans-b 1), fp32 sums; scale_d 0 starts the sum.
// d[4 j + e] is row 16 warp + lane / 4 + 8 (e / 2), column 8 j + 2 (lane %
// 4) + e % 2 of the warpgroup's 64 rows.
template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  __device__ static __forceinline__ void mma(float (&d)[32], uint64_t da, uint64_t db,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  __device__ static __forceinline__ void mma(float (&d)[64], uint64_t da, uint64_t db,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<192> {
  __device__ static __forceinline__ void mma(float (&d)[96], uint64_t da, uint64_t db,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
        "}, %96, %97, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

// d (+)= a . w on a 64 x N x 32 tile: int8 operands from shared memory,
// both K-major, s32 sums (the f32 form's fragment positions); scale_d 0
// starts the sum.  #10 uses N = 256.
template <int N>
struct WgmmaS8;

template <>
struct WgmmaS8<256> {
  __device__ static __forceinline__ void mma(int (&d)[128], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
          "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
          "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
          "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
          "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
          "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
          "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
          "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
          "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

// ---------------------------------------------------------------------
// Operand kinds of gemm_block: what a K slice of w is, how a slice is
// multiplied, and what the epilogue needs.
// ---------------------------------------------------------------------

// The subblocks' bf16 projections (see the top); out is stored with TMA.
struct Bf16 {
  typedef float Acc;
  static constexpr int kSliceK = kBK;
  static constexpr bool kDequant = false;
  static constexpr bool kTmaStore = true;
  const float* bias;  // (N) fp32

  // The slice's BN columns of w, as 64-column MN-major boxes.
  template <int BN>
  __device__ static __forceinline__ void load_w(unsigned char* dst, const CUtensorMap* wmap,
                                                uint64_t* bar, int n0, int k) {
#pragma unroll
    for (int j = 0; j < BN / kBoxN; ++j) tma_load_2d(dst + j * kWBox, wmap, bar, n0 + j * kBoxN, k * kBK);
  }

  template <int BN>
  __device__ static __forceinline__ void mma(float (&acc)[BN / 2], uint32_t a, uint32_t w, int fresh) {
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      Wgmma<BN>::mma(acc, desc_a(a + kk * 32), desc_w(w + kk * 16 * 128), kk == 0 && fresh ? 0 : 1);
  }
};

// #10's int8 product, dequantised in the epilogue.  TO = bf16 is stored
// with TMA (rows `ld` apart, a multiple of 8); TO = float from registers.
template <typename TO>
struct S8 {
  typedef int Acc;
  static constexpr int kSliceK = 128;
  static constexpr bool kDequant = true;
  static constexpr bool kTmaStore = sizeof(TO) == 2;
  const float* sx;      // (M) row scales
  const float* kscale;  // (N) column scales
  const float* bias;    // (N) or null
  TO* out;              // (M, ld), for the stores from registers
  int ld;

  // The slice's BN rows of w (N, K): one K-major box.
  template <int BN>
  __device__ static __forceinline__ void load_w(unsigned char* dst, const CUtensorMap* wmap,
                                                uint64_t* bar, int n0, int k) {
    tma_load_2d(dst, wmap, bar, k * kSliceK, n0);
  }

  template <int BN>
  __device__ static __forceinline__ void mma(int (&acc)[BN / 2], uint32_t a, uint32_t w, int fresh) {
#pragma unroll
    for (int kk = 0; kk < kSliceK / 32; ++kk)
      WgmmaS8<BN>::mma(acc, desc_a(a + kk * 32), desc_a(w + kk * 32), kk == 0 && fresh ? 0 : 1);
  }
};

// One block of the persistent GEMM (see the top), an S-deep ring.
// kGrouped (Bf16 only): kg < K, the groups' fp32 sums kept apart and added
// in order onto the bias.  K is a whole number of slices for Bf16; for S8
// the last slice's columns past K come in as zeros.
template <class Kind, int BN, int S, bool kGrouped>
__device__ __forceinline__ void gemm_block(const CUtensorMap* amap, const CUtensorMap* wmap,
                                           const CUtensorMap* omap, const Kind kind, int M, int N,
                                           int K, int kg, int ldo) {
  static_assert(!(kGrouped && Kind::kDequant), "head groups are a bf16 epilogue");
  typedef GemmLayout<BN, S> L;
  extern __shared__ __align__(1024) unsigned char gemm_smem[];
  const uint32_t raw = smem_u32(gemm_smem);
  unsigned char* base = gemm_smem + (((raw + 1023) & ~1023u) - raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::barriers);
  uint64_t* empty = full + S;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int n_tiles = (N + BN - 1) / BN, tiles = (M + kBM - 1) / kBM * n_tiles;
  const int nk = (K + Kind::kSliceK - 1) / Kind::kSliceK;
  const int wg = threadIdx.x / 128;
  if (wg == 0) {  // producer
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      int s = 0;
      unsigned phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = t / n_tiles * kBM, n0 = t % n_tiles * BN;
        for (int k = 0; k < nk; ++k) {
          mbar_wait(&empty[s], phase ^ 1);
          unsigned char* st = base + s * L::stage;
          mbar_expect_tx(&full[s], L::stage);
          tma_load_2d(st, amap, &full[s], k * Kind::kSliceK, m0);
          Kind::template load_w<BN>(st + kATile, wmap, &full[s], n0, k);
          if (++s == S) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {  // consumers: warpgroup 1 rows 0-63, warpgroup 2 rows 64-127
    setmaxnreg_inc<232>();
    const int cw = wg - 1, warp = threadIdx.x % 128 / 32, lane = threadIdx.x % 32;
    const int per_group = kGrouped ? kg / Kind::kSliceK : nk;
    typename Kind::Acc acc[BN / 2];
    float tot[kGrouped ? BN / 2 : 1];
    int s = 0;
    unsigned phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = t / n_tiles * kBM, n0 = t % n_tiles * BN;
      int pending = -1;  // the stage whose wgmmas may still be in flight
      for (int k = 0; k < nk; ++k) {
        mbar_wait(&full[s], phase);
        const uint32_t a = smem_u32(base + s * L::stage) + cw * (64 * 128);
        const uint32_t w = smem_u32(base + s * L::stage + kATile);
        const int fresh = k % per_group == 0;
        fence_acc(acc);
        wgmma_fence();
        Kind::template mma<BN>(acc, a, w, fresh);
        wgmma_commit();
        if ((k + 1) % per_group == 0) {  // a group's sum is complete
          wgmma_wait<0>();
          fence_acc(acc);
          if (pending >= 0) mbar_arrive(&empty[pending]);
          mbar_arrive(&empty[s]);
          pending = -1;
          if constexpr (kGrouped) {
            const bool first = k + 1 == per_group;
#pragma unroll
            for (int j = 0; j < BN / 8; ++j) {
              const int col = n0 + 8 * j + 2 * (lane % 4);
#pragma unroll
              for (int e = 0; e < 4; ++e)
                tot[4 * j + e] =
                    __fadd_rn(first ? kind.bias[col + (e & 1)] : tot[4 * j + e], acc[4 * j + e]);
            }
          }
        } else {
          wgmma_wait<1>();  // the previous slice's wgmmas are done
          fence_acc(acc);
          if (pending >= 0) mbar_arrive(&empty[pending]);
          pending = s;
        }
        if (++s == S) {
          s = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();  // none is pending: the last slice closed its group
      fence_acc(acc);
      // Epilogue.  Thread value 4 j + 2 half + e is row r (of the
      // warpgroup's 64), column col + e.
      float rs[2] = {0.f, 0.f};  // S8: the two rows' activation scales
      if constexpr (Kind::kDequant) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = m0 + cw * 64 + warp * 16 + lane / 4 + 8 * half;
          if (row < M) rs[half] = kind.sx[row];
        }
      }
      if constexpr (Kind::kTmaStore) {
        // bf16 values into the warpgroup's output tile (the swizzled
        // layout of the output map, so the 32 lanes' 4-byte writes hit 32
        // banks), then one thread's TMA stores, which run on while the
        // warpgroup starts its next tile.
        unsigned char* tile = base + L::out + cw * L::out_tile;
        if (threadIdx.x % 128 == 0) bulk_wait_read();  // the last tile's stores have read it
        warpgroup_sync(1 + cw);
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int col = n0 + 8 * j + 2 * (lane % 4);
          float b0 = 0.f, b1 = 0.f, k0 = 0.f, k1 = 0.f;
          if constexpr (Kind::kDequant) {
            if (col < N) {
              k0 = kind.kscale[col];
              if (kind.bias) b0 = kind.bias[col];
            }
            if (col + 1 < N) {
              k1 = kind.kscale[col + 1];
              if (kind.bias) b1 = kind.bias[col + 1];
            }
          } else if constexpr (!kGrouped) {
            b0 = kind.bias[col];
            b1 = kind.bias[col + 1];
          }
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = warp * 16 + lane / 4 + 8 * half;
            float v0, v1;
            if constexpr (Kind::kDequant) {
              v0 = __fmul_rn(__int2float_rn(acc[4 * j + 2 * half]), __fmul_rn(rs[half], k0));
              v1 = __fmul_rn(__int2float_rn(acc[4 * j + 2 * half + 1]), __fmul_rn(rs[half], k1));
              if (kind.bias) {
                v0 = __fadd_rn(v0, b0);
                v1 = __fadd_rn(v1, b1);
              }
            } else {
              v0 = kGrouped ? tot[4 * j + 2 * half] : __fadd_rn(b0, acc[4 * j + 2 * half]);
              v1 = kGrouped ? tot[4 * j + 2 * half + 1] : __fadd_rn(b1, acc[4 * j + 2 * half + 1]);
            }
            const int byte = j / 8 * kOutBox + r * 128 + ((j % 8) ^ (r % 8)) * 16 + (lane % 4) * 4;
            *reinterpret_cast<__nv_bfloat162*>(tile + byte) = __floats2bfloat162_rn(v0, v1);
          }
        }
        fence_async_shared();
        warpgroup_sync(1 + cw);
        if (threadIdx.x % 128 == 0 && m0 + cw * 64 < M) {
#pragma unroll
          for (int b = 0; b < BN / kBoxN; ++b) {
            const int col = n0 + b * kBoxN;
            if (col < N) tma_store_3d(omap, tile + b * kOutBox, col % ldo, m0 + cw * 64, col / ldo);
          }
          bulk_commit();
        }
      } else {  // S8 with an fp32 result: each value straight from its register
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int col = n0 + 8 * j + 2 * (lane % 4);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (col + e >= N) continue;
            const float ks = kind.kscale[col + e];
            const float b = kind.bias ? kind.bias[col + e] : 0.f;
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int row = m0 + cw * 64 + warp * 16 + lane / 4 + 8 * half;
              if (row >= M) continue;
              float v = __fmul_rn(__int2float_rn(acc[4 * j + 2 * half + e]), __fmul_rn(rs[half], ks));
              if (kind.bias) v = __fadd_rn(v, b);
              kind.out[static_cast<size_t>(row) * kind.ld + col + e] = v;
            }
          }
        }
      }
    }
    if (threadIdx.x % 128 == 0) bulk_wait();
  }
}

// Launches `kernel` (a __global__ whose body is gemm_block<Bf16, BN,
// kStages, kGrouped>) on a (M, K) row-major, w (K, N) row-major, into out:
// N / ldo planes of (M, ldo); N a multiple of BN, ldo of 64, K of kg and kg
// of kBK, all three matrices 16-byte aligned.
template <int BN, typename Kernel>
inline cudaError_t launch_gemm(Kernel kernel, const void* a, const void* w, const float* bias,
                               void* out, int M, int N, int K, int kg, int ldo,
                               cudaStream_t stream) {
  CUtensorMap amap, wmap, omap;
  cudaError_t err = encode_2d(&amap, a, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, sizeof(bf16), K, M, kBK, kBM);
  if (err != cudaSuccess) return err;
  err = encode_2d(&wmap, w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, sizeof(bf16), N, K, kBoxN, kBK);
  if (err != cudaSuccess) return err;
  err = encode_out(&omap, out, ldo, M, N / ldo, ldo);
  if (err != cudaSuccess) return err;
  const size_t bytes = GemmLayout<BN, kStages>::bytes;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const int tiles = (M + kBM - 1) / kBM * (N / BN);
  const int grid = tiles < sm_count() ? tiles : sm_count();
  kernel<<<grid, kThreads, bytes, stream>>>(amap, wmap, omap, bias, M, N, K, kg, ldo);
  return cudaGetLastError();
}

}  // namespace sm90
}  // namespace iisan
