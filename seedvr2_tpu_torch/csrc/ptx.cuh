// Inline-PTX building blocks below Hopper's own (hopper.cuh): the shared
// address of a pointer, asynchronous global -> shared copies (cp.async) and
// the warp-level tensor-core product (mma.sync), whose register layouts the
// PTX ISA documents; K7's split-K regime (w8a16_linear.cuh) runs on them,
// and pack_bf16 serves every kernel that rounds accumulators to bf16.
//
// Layouts, with g = lane / 4 and t = lane % 4 (PTX ISA, "Matrix fragments
// for mma.m16n8k16"):
//   accumulator 16x8 (fp32): c0, c1 at row g, cols 2t, 2t+1; c2, c3 at row
//     g+8, the same cols;
//   bf16 A 16x16: a0 row g, cols 2t..2t+1; a1 row g+8; a2 row g, cols
//     8+2t..; a3 row g+8, cols 8+2t..; B 16x8: b0 rows 2t..2t+1, col g;
//     b1 rows 8+2t.., col g.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace seedvr2 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; zeros when !pred (src is not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// Wait until at most N of this thread's committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// c += a (16x16 bf16) * b (16x8 bf16), fp32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two fp32 values as one bf16 pair, lo in the low half (an operand's lower
// column), round to nearest even.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace seedvr2
