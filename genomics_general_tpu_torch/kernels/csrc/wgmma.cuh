// Hopper (sm_90a) building blocks shared by the int8 tensor-core kernels:
// K9 and K14 (pair4.cu) and K17 (ld.cu).  The one-hot decode of int8
// codes, the s8 x s8 -> s32 wgmma m64n128k32 (A from registers or from
// shared memory), its fences, the descriptor of the operand layout both
// kernels stage, and cp.async.
//
// Operand layout (no swizzle, K-major): 32 bytes of K a step; row r, byte
// k of a step's operand at (r / 8) * kSbo + (k / 16) * kLbo + (r % 8) * 16
// + k % 16, so each 8-row x 16-byte core matrix is 128 contiguous bytes.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLbo = 128;              // next core matrix along K
constexpr int kSbo = 256;              // next 8 rows
constexpr uint32_t kLowBytes = 0x01010101u;  // bit 0 of each byte

// The five 0/1 planes of 4 int8 codes (one byte each): oh[c] has byte k
// = 1 where code k is c (0..3), called byte k = 1 where code k >= 0.
// Bits 2..7 of a byte, moved to bits 1..6 and added to 0x7E, carry into
// bit 7 unless they are all 0; no byte carries into the next.
__device__ __forceinline__ void decode(uint32_t x, uint32_t (&oh)[4],
                                       uint32_t& called) {
  called = ~(x >> 7) & kLowBytes;
  const uint32_t x1 = x >> 1;             // bit 0 of each byte: code bit 1
  const uint32_t t = (x1 & 0x7E7E7E7Eu) + 0x7E7E7E7Eu;
  const uint32_t ia = ~(t >> 7) & kLowBytes;   // code in 0..3
  oh[0] = ia & ~x & ~x1;
  oh[1] = ia & x & ~x1;
  oh[2] = ia & ~x & x1;
  oh[3] = ia & x & x1;
}

// The 64 s32 sums of a thread as asm operands %0 .. %63.
#define GGT_WGMMA_D_REGS                                                   \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "      \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "      \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "      \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "      \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define GGT_WGMMA_D(d)                                                     \
  "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),              \
      "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),          \
      "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),     \
      "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),     \
      "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),     \
      "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),     \
      "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),     \
      "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),     \
      "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),     \
      "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),     \
      "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),     \
      "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),     \
      "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])

// d[64] += A (this warpgroup's 64 x 32 s8 rows, a per thread as in
// mma.m16n8k32's A fragment for its warp's 16 rows) . B^T (128 x 32 s8 at
// desc), asynchronously
__device__ __forceinline__ void wgmma(int (&d)[64], const uint32_t (&a)[4],
                                      uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {" GGT_WGMMA_D_REGS
      "}, {%64, %65, %66, %67}, %68, p;\n"
      "}\n"
      : GGT_WGMMA_D(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d[64] += A (64 x 32 s8 at adesc) . B^T (128 x 32 s8 at bdesc), both in
// shared memory, asynchronously
__device__ __forceinline__ void wgmma_ss(int (&d)[64], uint64_t adesc,
                                         uint64_t bdesc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {" GGT_WGMMA_D_REGS
      "}, %64, %65, p;\n"
      "}\n"
      : GGT_WGMMA_D(d)
      : "l"(adesc), "l"(bdesc), "r"(1));
}

#undef GGT_WGMMA_D
#undef GGT_WGMMA_D_REGS

// Keep the compiler from moving an accumulator across the wgmma fences.
__device__ __forceinline__ void fence_operands(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// The no-swizzle K-major descriptor of the operand at shared address addr.
__device__ __forceinline__ uint64_t plane_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)(kLbo >> 4) << 16) | ((uint64_t)(kSbo >> 4) << 32);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Make this thread's generic-proxy writes of shared memory (stores,
// cp.async) visible to the async proxy that wgmma reads through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

}  // namespace
