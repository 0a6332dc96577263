// Hopper (sm_90a) building blocks shared by the port's tensor-core bodies:
// the prefill body of csrc/fused_sparse_linear_prefill.cu (fused_prefill_*,
// nm_prefill_*) and the prefill-chunk body of csrc/paged_attention_prefill.cu.
//
//   * cp.async copies into shared memory (16, 8 and 4 bytes; a false
//     predicate copies no byte and zero-fills the destination), their commit
//     groups and waits;
//   * the proxy fence that makes generic-proxy writes to shared memory
//     (cp.async, thread stores) visible to the tensor cores' async-proxy
//     reads;
//   * wgmma's fence, commit and wait, and fence_regs, which keeps the
//     compiler from moving accesses to accumulators across them;
//   * the shared-memory descriptors of a 128-byte-swizzled tile, K-major
//     (tile_desc) and MN-major (mn_desc), and swz, the element offset of
//     (row, col) in a [rows][64] bf16 tile with that swizzle;
//   * wgmma.mma_async bf16 -> f32 wrappers: A and B from shared memory, both
//     K-major (wgmma_n32, wgmma_n64), and A from registers with B MN-major
//     (wgmma_rs_tb_n64, wgmma_rs_tb_n128);
//   * for the paged attention bodies (csrc/paged_attention_prefill.cu,
//     csrc/paged_attention_decode.cu): fast_div, the host-side constants of
//     a division by a runtime divisor with one multiply-high, and ex2.
#pragma once

#include <stdint.h>

namespace hopper {

// The multiplier and shift that divide 0 <= j < 2^31 by d >= 2 with one
// multiply-high, j / d = umulhi(j, mul) >> shr (Granlund and Montgomery's
// round-up method, as CUTLASS's FastDivmod): p = 31 + ceil(log2 d), mul =
// ceil(2^p / d), shr = p - 32.  d = 1 gives 0, 0: the caller tests for it.
inline void fast_div(int d, uint32_t& mul, uint32_t& shr) {
  if (d == 1) {
    mul = 0;
    shr = 0;
    return;
  }
  int l = 0;
  while ((1u << l) < uint32_t(d)) ++l;
  mul = uint32_t(((1ull << (31 + l)) + uint64_t(d) - 1) / uint64_t(d));
  shr = uint32_t(l - 1);
}

// 2^x, flushing subnormal results to 0 (p and alpha in [0, 1])
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
               "l"(src), "r"(pred ? 8 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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

// Pins registers that an asynchronous wgmma reads or writes in place, so
// the compiler moves no access to them across the fence, commit or wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma descriptor of a K-major tile [rows][64] bf16 at `p` (1024-byte
// aligned) with the 128-byte swizzle: start address >> 4, leading offset 1
// (unused by this layout), stride 1024 B between 8-row groups, layout 1
__device__ __forceinline__ uint64_t tile_desc(const void* p) {
  const uint64_t a = static_cast<uint64_t>(__cvta_generic_to_shared(p));
  return ((a & 0x3FFFFull) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

// wgmma descriptor of an MN-major B operand [k rows][n] bf16 (n
// contiguous) stored as panels of [rows][64] with the 128-byte swizzle, the
// same bytes as tile_desc's tiles: 16-byte chunk c of k row r at c ^ (r &
// 7).  For this layout the leading offset is the stride between 64-wide
// panels along n (`panel_bytes`) and the stride offset the 1024 B between
// 8-row groups along k.
__device__ __forceinline__ uint64_t mn_desc(const void* p, int panel_bytes) {
  const uint64_t a = static_cast<uint64_t>(__cvta_generic_to_shared(p));
  return ((a & 0x3FFFFull) >> 4) |
         (static_cast<uint64_t>(panel_bytes >> 4) << 16) | (64ull << 32) |
         (1ull << 62);
}

// Element offset of (row, col) in a [rows][64] bf16 tile whose 16-byte
// chunks are swizzled by row.
__device__ __forceinline__ int swz(int row, int col) {
  return row * 64 + ((((col >> 3) ^ row) & 7) << 3) + (col & 7);
}

// d += A B^T for one k16 step: A [64 rows][16] and B [n rows][16], both
// K-major in 128-byte-swizzled shared memory (descriptors da, db); every
// call accumulates (the accumulators start at 0)
__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

// the same at n64; `accumulate` false overwrites d with the product
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da,
                                          uint64_t db,
                                          bool accumulate = true) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate ? 1 : 0));
}

// d += A B for one k16 step with A [64 rows][16] bf16 in registers, four
// bf16 pairs a thread in the layout of a wgmma accumulator (warp w of the
// group holds rows 16 w .. 16 w + 15; lane l: a[0] row l / 4, columns
// 2 (l % 4) + {0, 1}; a[1] the row 8 below; a[2], a[3] columns + 8), and B
// [16][n] MN-major in shared memory (mn_desc): the transpose-B form; every
// call accumulates
__device__ __forceinline__ void wgmma_rs_tb_n64(float (&d)[32],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_tb_n128(float (&d)[64],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "
      "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

}  // namespace hopper
