// The inline PTX shared by the kernels (K1, K3, K4's backward):
// tensor-core products with mma.sync and asynchronous copies to shared
// memory with cp.async. Nothing else in csrc/ holds inline assembly.
//
// Fragments of mma.sync.m16n8k8 (tf32) and m16n8k16 (bf16), lane = 4 g +
// tig (g = lane / 4, tig = lane % 4), every register 32 bits:
//   A (16 x K, row-major): a0 (row g), a1 (row g + 8), a2 (row g),
//     a3 (row g + 8); tf32: columns tig (a0, a1) and tig + 4 (a2, a3);
//     bf16: the pairs of columns 2 tig, 2 tig + 1 (a0, a1) and
//     2 tig + 8, 2 tig + 9 (a2, a3)
//   B (K x 8): b0, b1 at column g; tf32: rows tig and tig + 4; bf16: the
//     pairs of rows 2 tig, 2 tig + 1 and 2 tig + 8, 2 tig + 9
//   C (16 x 8, f32): c0, c1 at row g, columns 2 tig, 2 tig + 1; c2, c3 at
//     row g + 8, the same columns
#pragma once

#include <stdint.h>

namespace {

// tf32(v): round to nearest, ties away, to 10 mantissa bits
__device__ __forceinline__ float tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return __uint_as_float(r);
}

// The 3xTF32 split of an f32 operand v: big = v with its 13 low mantissa
// bits cleared (a tf32 value) and small = v - big (exact in f32). The tensor
// cores read a tf32 operand's top 19 bits, so small enters its products
// truncated to tf32, which costs at most 2^-10 of small (2^-20 of v): about
// f32's accuracy from small*big + big*small + big*big, at two instructions
// a value where rounding both halves (cvt.rna) takes three.
__device__ __forceinline__ void split_tf32(float v, uint32_t& big,
                                           uint32_t& small) {
  big = __float_as_uint(v) & 0xffffe000u;
  small = __float_as_uint(v - __uint_as_float(big));
}

// c += a b, one m16n8k8 tile in TF32 with f32 accumulation
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b in 3xTF32: small a x big b + big a x small b + big a x big b
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma_tf32(c, al, bh);
  mma_tf32(c, ah, bl);
  mma_tf32(c, ah, bh);
}

// c += a b, one m16n8k16 tile in bf16 with f32 accumulation
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 4-byte asynchronous copy to shared memory; zero-fills when !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

// 8-byte asynchronous copy (both addresses 8-byte aligned); zero-fills
// when !valid
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(d),
               "l"(src), "r"(valid ? 8 : 0));
}

// 16-byte asynchronous copy (both addresses 16-byte aligned); zero-fills
// when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most N of this thread's copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

}  // namespace
