// Tensor-core building blocks shared by the flash-attention forward
// (flash_attention.cu) and backward (flash_attention_bwd.cu) on Hopper
// (sm_90a): cp.async copies into 128-byte-swizzled shared-memory panels,
// wgmma descriptors, the two wgmma forms both kernels use (both operands in
// shared memory; A in registers with B read through the transpose bit) and
// the bf16 packing that turns an f32 accumulator into an A fragment.
//
// A tile is 64 rows x up to 128 bf16 columns, stored as panels of 64 rows x
// 64 columns (128 bytes a row), each 16-byte chunk of a row XOR-swizzled by
// the row's index within its 8-row group: the layout that TMA's
// SWIZZLE_128B writes and wgmma's 128-byte descriptors read, both K-major
// (the columns are the product's depth) and MN-major (the rows are).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PANEL = 64 * 128;  // 64 rows x 128 bytes (64 bf16)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; only `bytes` (0..16) are read, the rest
// of the 16 is zero-filled.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Byte offset of 16-byte chunk `c` (0..15) of row `r` in a [rows][128]
// tile stored as 128-byte-swizzled panels of 64 columns (the layout that
// TMA's SWIZZLE_128B writes and wgmma's 128B descriptors read).
__device__ __forceinline__ uint32_t swz(int r, int c, int panel_bytes) {
  return (c >> 3) * panel_bytes + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// Shared-memory matrix descriptor, 128-byte swizzle.
__device__ __forceinline__ uint64_t desc128(uint32_t addr, uint32_t lbo,
                                           uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Wait until at most N committed wgmma groups are still in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from reusing or moving registers that an in-flight
// wgmma reads as its A fragment.
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
// Keep the compiler from moving accumulator reads or writes across the
// asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define F8(a, i)                                                        \
  "+f"(a[i]), "+f"(a[i + 1]), "+f"(a[i + 2]), "+f"(a[i + 3]),           \
      "+f"(a[i + 4]), "+f"(a[i + 5]), "+f"(a[i + 6]), "+f"(a[i + 7])

// d (64 x 64 f32) (+)= A (64 x 16, K-major in shared memory) *
// B (16 x 64, K-major in shared memory).
__device__ __forceinline__ void wgmma_ss_64x64(float (&d)[32], uint64_t da,
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : F8(d, 0), F8(d, 8), F8(d, 16), F8(d, 24)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 128 f32) += A (64 x 16 bf16, registers) * B (16 x 128, MN-major
// in shared memory: the transpose bit set).
__device__ __forceinline__ void wgmma_rs_64x128(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : F8(d, 0), F8(d, 8), F8(d, 16), F8(d, 24), F8(d, 32), F8(d, 40),
        F8(d, 48), F8(d, 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64 f32) += A (64 x 16 bf16, registers) * B (16 x 64, MN-major in
// shared memory: the transpose bit set). The n = 64 form of the above, for
// head dims up to 64.
__device__ __forceinline__ void wgmma_rs_64x64(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : F8(d, 0), F8(d, 8), F8(d, 16), F8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// 2^x by the special-function unit (ex2.approx: relative error ~2^-22,
// 2^(-1e30) = 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

// Rows [0, 64) of a (rows, hd) operand at `src` (row stride `rs` elements)
// into a 64 x HDP swizzled tile at `dst` (HDP / 64 panels); rows >= n_rows
// and columns >= hd are zero-filled. THREADS threads, HDP / 8 of them a
// row.
template <int THREADS, int HDP = 128>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          long long rs, int n_rows, int hd,
                                          int tid) {
  static_assert(HDP == 64 || HDP == 128, "a tile is 64 or 128 columns");
  constexpr int CH = HDP / 8;  // 16-byte chunks a row
  constexpr int LOG_CH = HDP == 128 ? 4 : 3;
#pragma unroll
  for (int i = 0; i < 64 * CH / THREADS; ++i) {
    const int e = tid + i * THREADS;
    const int r = e >> LOG_CH, c = e & (CH - 1);
    const int bytes = r < n_rows ? min(16, max(0, (hd - c * 8) * 2)) : 0;
    const __nv_bfloat16* p = bytes ? src + r * rs + c * 8 : src;
    cp_async16(dst + swz(r, c, PANEL), p, bytes);
  }
}

}  // namespace
