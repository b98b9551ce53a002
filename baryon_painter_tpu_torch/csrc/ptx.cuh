// The inline PTX shared by the kernels: Hopper's wgmma, TMA, mbarriers and
// ldmatrix (K1, K3's GEMMs, K4's GEMMs), and loads and stores of shared
// memory by 32-bit address (K3's dw1). Nothing else in csrc/ holds inline
// assembly.
//
// A warp's part of a wgmma's A operand in registers has the layout of
// mma.sync's fragments, m16n8k8 (tf32) and m16n8k16 (bf16), lane = 4 g +
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

// ---------------------------------------------------------------------------
// Hopper (sm_90a): wgmma, TMA and mbarriers, used by K1 (csrc/res_block.cu),
// K3's GEMMs (csrc/head_stack.cu) and K4's GEMMs (csrc/conv_bn.cu).
//
// wgmma.mma_async m64n128: one warpgroup (4 warps, 128 threads) multiplies
// A (64 x k) by B (k x 128) into f32 sums held in registers, 64 a thread:
// warp w of the group holds rows 16 w .. 16 w + 15, and d[4 j + e] is row
// g + 8 (e / 2), column 8 j + 2 tig + e % 2 of its 16 rows (mma.sync's C
// fragment for each n8 tile j). A comes from registers in mma.sync's A
// fragment layout (tf32 k8 or bf16 k16, above); B from shared memory
// through a matrix descriptor. The product is asynchronous: the registers
// it reads and writes stay its own until wgmma_wait says its group is done.

// The wgmma's 64 accumulator operands %0..%63
#define BPT_WGMMA_D64_TEMPLATE \
  "{%0, %1, %2, %3, %4, %5, %6, %7, "\
  "%8, %9, %10, %11, %12, %13, %14, %15, "\
  "%16, %17, %18, %19, %20, %21, %22, %23, "\
  "%24, %25, %26, %27, %28, %29, %30, %31, "\
  "%32, %33, %34, %35, %36, %37, %38, %39, "\
  "%40, %41, %42, %43, %44, %45, %46, %47, "\
  "%48, %49, %50, %51, %52, %53, %54, %55, "\
  "%56, %57, %58, %59, %60, %61, %62, %63}, "

#define BPT_WGMMA_D64_OPERANDS(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
  "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
  "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
  "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
  "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
  "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
  "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
  "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
  "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
  "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
  "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// d += a b: m64n128k8, TF32 operands (the top 19 bits of each 32-bit
// word), f32 sums; B K-major (the only order tf32 takes)
__device__ __forceinline__ void wgmma_tf32(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      BPT_WGMMA_D64_TEMPLATE
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : BPT_WGMMA_D64_OPERANDS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d += a b: m64n128k16, bf16 operands, f32 sums; B K-major (not transposed)
__device__ __forceinline__ void wgmma_bf16(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      BPT_WGMMA_D64_TEMPLATE
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : BPT_WGMMA_D64_OPERANDS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// Shared-memory matrix descriptor of a K-major operand in the 128-byte
// swizzle (rows of 128 bytes, 8-row atoms of 1024 bytes, atom-aligned as TMA
// writes it): start address >> 4, leading offset 1 (unused by this layout),
// stride between 8-row atoms 1024 B >> 4, layout 1 = 128-byte swizzle. A
// k-step further along the row adds its byte offset >> 4 to the start.
__device__ __forceinline__ uint64_t wgmma_desc_sw128(uint32_t smem_addr) {
  return (uint64_t)((smem_addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

// Orders this thread's register writes before the wgmmas that read them
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

// Closes the wgmmas issued since the last commit into one group
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N of the warpgroup's wgmma groups are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of v across this point
// (around wgmma, which updates its accumulators asynchronously)
__device__ __forceinline__ void fence_operand(float& v) {
  asm volatile("" : "+f"(v)::"memory");
}

// Four 8 x 8 matrices of 16-bit elements (one 16-byte row each lane points
// at: lanes 0-7 matrix 0, 8-15 matrix 1, 16-23 matrix 2, 24-31 matrix 3);
// lane l receives row l / 4, elements 2 (l % 4) and 2 (l % 4) + 1 of each.
// On 32-bit data that is word l % 4 of row l / 4: the tf32 A fragment.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// ldmatrix_x4 with each 8 x 8 matrix transposed: lane l receives elements
// 2 (l % 4) and 2 (l % 4) + 1 of column l / 4 (rows 2 (l % 4), 2 (l % 4) + 1
// of the stored rows, each a lane's 16-byte row). With a stored row the 8
// channels of one pixel, that is a bf16 A fragment whose rows are channels
// and whose k is pixels (K3's dw1).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// Shared memory at a 32-bit shared-memory address (K3's dw1 keeps no 64-bit
// generic pointers live: with them its consumers spilled)
__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}
__device__ __forceinline__ uint32_t lds16(uint32_t addr) {
  uint16_t v;
  asm volatile("ld.shared.b16 %0, [%1];\n" : "=h"(v) : "r"(addr));
  return v;
}
__device__ __forceinline__ void sts32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v));
}
__device__ __forceinline__ void sts16(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b16 [%0], %1;\n" ::"r"(addr),
               "h"((uint16_t)v));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the other threads and to TMA
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Arrives and announces `bytes` of TMA transfers that complete the phase
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// Waits until the barrier's phase of parity `parity` has completed (phase
// 0 is the first; a wait on parity 1 before any completion passes). The
// loop is PTX's own, so the compiler sees no divergent path around the
// wgmmas that follow. A wait that outlasts 2^32 SM clock cycles (over 2 s)
// traps, so a launch that would never finish ends with an error instead of
// holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .u64 t0, t1;\n"
      "mov.u64 t0, %%clock64;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "mov.u64 t1, %%clock64;\n"
      "sub.u64 t1, t1, t0;\n"
      "setp.gt.u64 p, t1, 4294967296;\n"
      "@p trap;\n"
      "bra WAIT;\n"
      "DONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// TMA: one box of a 4-d tensor (coordinates innermost first, elements; out
// of bounds reads zeros) into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const void* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(dst), "l"(map), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// TMA: shared memory into one box of a 4-d tensor (out-of-bounds
// elements are not written), in this thread's bulk group
__device__ __forceinline__ void tma_store_4d(const void* map, uint32_t src,
                                             int c0, int c1, int c2,
                                             int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(map),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Closes this thread's TMA stores into a group and waits until every
// group has read its shared memory
__device__ __forceinline__ void tma_store_commit_and_wait_read() {
  asm volatile(
      "cp.async.bulk.commit_group;\n"
      "cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void tma_prefetch_map(const void* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(map) : "memory");
}

// Orders this thread's generic-proxy shared-memory accesses before later
// async-proxy ones (TMA writes, wgmma reads) of the same memory
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A warpgroup's registers a thread: down to N (returned to the block's
// pool) or up to N (taken from it, waiting until the pool has them)
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Barrier `id` (1..15; 0 is __syncthreads) over `count` threads
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}


// wgmma.mma_async m64nN (N = 8, 16, 32, 64) for K4's GEMMs, A from
// registers and B K-major from shared memory, as above, with N / 2 f32
// sums a thread (d[4 j + e]: row g + 8 (e / 2), column 8 j + 2 tig + e % 2
// of the warp's 16 rows). `accumulate` false overwrites d with a b (the
// product of one k-step summed from zero); true adds it.
template <int N>
struct Wgmma;

template <>
struct Wgmma<8> {
  __device__ __forceinline__ static void tf32(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              uint64_t desc, bool accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"((int)accumulate));
  }
  __device__ __forceinline__ static void bf16(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              uint64_t desc, bool accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"((int)accumulate));
  }
};

template <>
struct Wgmma<16> {
  __device__ __forceinline__ static void tf32(float (&d)[8],
                                              const uint32_t (&a)[4],
                                              uint64_t desc, bool accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"((int)accumulate));
  }
  __device__ __forceinline__ static void bf16(float (&d)[8],
                                              const uint32_t (&a)[4],
                                              uint64_t desc, bool accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"((int)accumulate));
  }
};

template <>
struct Wgmma<32> {
  __device__ __forceinline__ static void tf32(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t desc, bool accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"((int)accumulate));
  }
  __device__ __forceinline__ static void bf16(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t desc, bool accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"((int)accumulate));
  }
};

template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void tf32(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t desc, bool accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"((int)accumulate));
  }
  __device__ __forceinline__ static void bf16(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t desc, bool accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"((int)accumulate));
  }
};

}  // namespace
