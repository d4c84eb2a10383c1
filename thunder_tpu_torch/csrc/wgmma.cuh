// Hopper building blocks of the warpgroup bodies (flash_attention.cu,
// paged_verify.cu): 128-byte-swizzled shared-memory tiles filled by
// cp.async, the wgmma descriptors that read them, and the bf16 or f16
// warpgroup products with f32 accumulators in registers.  sm_90a only.
//
// A tile holds rows x W 16-bit elements (W a multiple of 64) as W/64 column
// blocks of rows x 128 bytes, one after the other.  Inside a block, the
// 16-byte chunk c of row r lies at r * 128 + ((c ^ (r % 8)) * 16): the
// layout TMA's 128-byte swizzle writes and a 128-byte-swizzle descriptor
// reads.  Tiles start on 1024-byte boundaries (the swizzle acts on address
// bits 4-9).  One tile serves both operand majors:
//   * K-major (the product's K runs along the tile's columns: Q and K in
//     Q.K^T, dO and V in dO.V^T): 8-row groups 1024 bytes apart; k-step kk
//     (16 columns) starts at column block kk / 4, byte 32 * (kk % 4).
//   * MN-major (K runs along the tile's rows, N along its columns: V in
//     P.V, K in dS.K, dO in P^T.dO, Q in dS^T.Q): k-step kk starts at row
//     16 kk; the 64-column blocks are rows * 128 bytes apart (LBO), the
//     8-row groups 1024 bytes (SBO).
//
// The accumulator of an m64nN product: thread t of the warpgroup (warp
// w = t / 32, lane l) holds, for each 8-column group j, d[4j + {0, 1}] at
// row 16 w + l / 4, columns 8 j + 2 (l % 4) + {0, 1}, and d[4j + {2, 3}]
// eight rows below.  The register A operand of an m64k16 step has the same
// (row, column) pattern over its 16 columns, two elements per register, so
// an accumulator packs straight into the A operand of the next product
// (pack_a), with no shuffle.
//
// The element type T of the products is __nv_bfloat16 (the default) or
// __half; tiles hold T.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

namespace tt {
namespace wg {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of the 16-byte chunk ch (elements 8 ch .. 8 ch + 7) of row r
// in a swizzled tile of `rows` rows.
__device__ __forceinline__ uint32_t swizzled(int rows, int r, int ch) {
  return (ch >> 3) * rows * 128 + r * 128 + (((ch & 7) ^ (r & 7)) << 4);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

// Copies rows x W 16-bit elements (row stride ld elements) from global
// memory into the swizzled tile at shared address s: 16 bytes per cp.async,
// threads tid of NT.  Commit and wait are the caller's.
template <int W, int NT, typename T>
__device__ __forceinline__ void load_tile(uint32_t s, const T* __restrict__ g, int rows,
                                          int64_t ld, int tid) {
  static_assert(sizeof(T) == 2, "tiles hold 16-bit elements");
  constexpr int kChunks = W / 8;  // 16-byte chunks per row
  for (int i = tid; i < rows * kChunks; i += NT) {
    const int r = i / kChunks, ch = i % kChunks;
    cp_async16(s + swizzled(rows, r, ch), g + r * ld + ch * 8);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Makes this thread's completed shared-memory writes visible to the async
// proxy (wgmma's operand reads); a barrier after it publishes them.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);  // 128-byte swizzle
}

// K-major operand: rows row0 .. row0 + 63 (or the N rows) of a rows-row
// tile, k-step kk.
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int rows, int row0, int kk) {
  return desc(tile + (kk >> 2) * rows * 128 + row0 * 128 + (kk & 3) * 32, 16, 1024);
}

// MN-major operand: k-step kk of a rows-row tile, all its columns.
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int rows, int kk) {
  return desc(tile + kk * 2048, rows * 128, 1024);
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins registers a product reads or writes asynchronously to this point of
// the program: after wait(), so no read of an accumulator moves above the
// wait and no register of an A operand is reused while the product runs.
template <int N> __device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N> __device__ __forceinline__ void pin(uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// lo and hi rounded to T (round to nearest even), lo in the low half
template <typename T> __device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, __half>::value) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    return pack_bf16(lo, hi);
  }
}

// k-step kk of an accumulator (16 columns: 8-column groups 2 kk, 2 kk + 1)
// as the register A operand of the next product, rounded to T.
// (call with kk a constant of an unrolled loop, so d stays in registers).
template <typename T = __nv_bfloat16, int N>
__device__ __forceinline__ void pack_a(const float (&d)[N], int kk, uint32_t (&a)[4]) {
  a[0] = pack2<T>(d[8 * kk + 0], d[8 * kk + 1]);
  a[1] = pack2<T>(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = pack2<T>(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = pack2<T>(d[8 * kk + 6], d[8 * kk + 7]);
}

// The four lanes of a quad (l / 4 alike) hold one accumulator row.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The mnemonic of a wgmma with f32 accumulators and T operands.
#define TT_WGMMA(shape, ty) "wgmma.mma_async.sync.aligned." shape ".f32." ty "." ty " "

// D (64 x 64) {=, +=} A . B, A and B K-major in shared memory
#define TT_WGMMA_SS_M64N64(ty)                                              \
  asm volatile(                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" TT_WGMMA("m64n64k16", ty) \
      "{%0, %1, %2, %3, %4, %5, %6, %7, "                                    \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                               \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                             \
      "%24, %25, %26, %27, %28, %29, %30, %31"                               \
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"                                    \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                     \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                     \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                   \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),                 \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),                 \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),                 \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),                 \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])                  \
      : "l"(da), "l"(db), "r"(scale_d))

template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss_m64n64(float (&d)[32], uint64_t da, uint64_t db,
                                                int scale_d) {
  if constexpr (std::is_same<T, __half>::value) {
    TT_WGMMA_SS_M64N64("f16");
  } else {
    TT_WGMMA_SS_M64N64("bf16");
  }
}

// D (64 x 64) {=, +=} A . B, A in registers, B MN-major in shared memory
#define TT_WGMMA_RS_M64N64(ty)                                              \
  asm volatile(                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" TT_WGMMA("m64n64k16", ty) \
      "{%0, %1, %2, %3, %4, %5, %6, %7, "                                    \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                               \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                             \
      "%24, %25, %26, %27, %28, %29, %30, %31"                               \
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                      \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                     \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                     \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                   \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),                 \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),                 \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),                 \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),                 \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])                  \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))

template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs_m64n64(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t db, int scale_d) {
  if constexpr (std::is_same<T, __half>::value) {
    TT_WGMMA_RS_M64N64("f16");
  } else {
    TT_WGMMA_RS_M64N64("bf16");
  }
}

// D (64 x 128) {=, +=} A . B, A in registers, B MN-major in shared memory
#define TT_WGMMA_RS_M64N128(ty)                                             \
  asm volatile(                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n" TT_WGMMA("m64n128k16", ty) \
      "{%0, %1, %2, %3, %4, %5, %6, %7, "                                    \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                               \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                             \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                             \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                             \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                             \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                             \
      "%56, %57, %58, %59, %60, %61, %62, %63"                               \
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                      \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                     \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                     \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                   \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),                 \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),                 \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),                 \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),                 \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),                 \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),                 \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),                 \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),                 \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),                 \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),                 \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),                 \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),                 \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                  \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))

template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs_m64n128(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t db, int scale_d) {
  if constexpr (std::is_same<T, __half>::value) {
    TT_WGMMA_RS_M64N128("f16");
  } else {
    TT_WGMMA_RS_M64N128("bf16");
  }
}

// O (64 x HS) += A . B, A in registers, B MN-major (HS 64 or 128)
template <int HS, typename T = __nv_bfloat16>
__device__ __forceinline__ void mma_rs(float (&d)[HS / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (HS == 128) {
    wgmma_rs_m64n128<T>(d, a, db, 1);
  } else {
    wgmma_rs_m64n64<T>(d, a, db, 1);
  }
}

// S (64 x 64) = A . B^T over HS, both K-major: A rows a_row0.. of an
// a_rows-row tile, B a 64-row tile.
template <int HS, typename T = __nv_bfloat16>
__device__ __forceinline__ void mma_ss(float (&s)[32], uint32_t a, int a_rows, int a_row0,
                                       uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < HS / 16; ++kk)
    wgmma_ss_m64n64<T>(s, desc_k(a, a_rows, a_row0, kk), desc_k(b, 64, 0, kk), kk > 0);
}

}  // namespace wg
}  // namespace tt
