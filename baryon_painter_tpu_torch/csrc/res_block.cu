// K1: the fused inference residual block, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `res_block_infer` of
// baryon_painter_tpu/ops/pallas_conv.py (kernel body `_res_block_kernel`):
//
//   h   = round_T(act_i(s1 * conv3x3(x, w1) + b1))
//   out = round_T(act_o(s2 * conv3x3(h, w2) + b2 + x))
//
// x and out are NHWC in x's type T (float or bfloat16), s/b the batch norm
// folded to per-channel f32 scale and bias, act a (leaky) ReLU with the
// given slope. The weights arrive in the kernel's layout, made once per
// module by the wrapper (ops/res_block.py `res_block_operands`): w^T as
// (part, C, 3 x 3, C) = (part, co, tap, ci) in T, part = conv (bf16) or
// (conv, big/small) (f32, the 3xTF32 split below done ahead). Sums are f32.
// The intermediate is rounded to T before the second conv, as the TPU
// kernel does, and never leaves shared memory; zeros outside the image are
// conv1's and conv2's padding.
//
// What bounds it: one launch does 2 * 2*N*H*W*C*C*9 operations (38.7 GFLOP
// at the painting shape (16, 64, 64, 128)) against about 2*N*H*W*C*sizeof(T)
// bytes, so the tensor cores: >= 0.234 ms in f32 as 3xTF32 (495/3 TFLOP/s),
// >= 0.039 ms in bf16 (989 TFLOP/s).
//
// Design (Hopper's warpgroup products fed by TMA). Each conv is an implicit
// GEMM, M = pixels, N = 128 output channels (C <= 128, padded to 128 by
// TMA's zero fill), K = 9 taps x the input channels, in K chunks of one tap
// x one 128-byte channel group (KW = 32 f32 or 64 bf16 channels), the tap
// slowest.
//   - Tensor cores through wgmma m64n128 (k8 tf32, k16 bf16), A from
//     registers, B (the weight chunk) from shared memory. f32 is 3xTF32:
//     A is split into big (low 13 bits cleared) and small = v - big in
//     registers, B's big and small halves come split from the host, and
//     small*big + big*small + big*big accumulate. bf16 products are exact.
//   - One block per (sample, TH x 16 output tile) of WGS consumer
//     warpgroups and one producer warpgroup, which hands its registers to
//     the consumers (setmaxnreg). conv1 runs on the (TH + 2) x 18 region
//     conv2 needs in one pass, one m64 tile per warpgroup (rows past the
//     region repeat its last pixel), so each weight chunk serves the whole
//     region and a block reads each conv's weights once (two passes over
//     conv1's region would read its weights twice); conv2's TH x 16 pixels
//     are TH / 4 m64 tiles, the other warpgroups only release the ring's
//     stages (the tensor cores are the SM's, so an idle warpgroup costs no
//     rate). f32: TH = 8, 3 warpgroups (180 of 192 rows used), 160
//     registers a consumer thread; bf16: TH = 12, 4 warpgroups (252 of
//     256), 112. In bf16 the weight stream, not the tensor cores, sets the
//     pace of the products: at 16 KB a chunk it asks about 20 bytes a clock
//     of each SM from L2, so bf16 takes the larger tile, which reads a
//     third fewer weight bytes a pixel.
//   - The producer's first thread loads the x halo tile ((TH + 4) x 20
//     pixels) with TMA, then streams the weight chunks with TMA into a ring
//     of stages (5 in bf16, 3 in f32) with a full/empty mbarrier pair each:
//     no per-thread copies, no block-wide barrier per chunk. TMA writes both
//     in the 128-byte swizzle (16-byte unit u of 128-byte row r lands at u
//     ^ (r % 8)); out-of-bounds boxes read zeros, which are conv1's padding
//     and the channels past C.
//   - A shifted by a tap starts mid swizzle atom, which a wgmma descriptor
//     cannot, so A comes from registers: each lane's ldmatrix.x4 reads its
//     pixel's 16-byte unit at the swizzled address (the XOR per pixel row),
//     one 8 x 8 matrix per 16 rows x 16 bytes; the four give the m16 x 32-
//     byte fragment (k16 bf16, k8 tf32: a 32-bit word is two b16 halves).
//     Each warpgroup keeps two commit groups in flight (2 k-steps each in
//     bf16, 1 in f32), their A fragments in two register sets.
//   - h (rounded to T; 0 outside the image and past C) is written by the
//     consumers in the same swizzled rows. bf16 keeps x, h and the ring
//     side by side (226 KB at C = 128) and reads the residual from the
//     staged x. f32 has no room for both (x 123 KB, h 92 KB at C = 128): h
//     is written over x after a barrier that ends conv1's reads (conv1 is
//     one pass, so nothing of x is read after it), and the residual is read
//     from device memory (L2) in the epilogue (219 KB with a 3-stage ring).
//     The output tile is staged in h's rows once conv2 has read them and
//     leaves by one TMA store a channel group (TMA drops what lies past the
//     image); the folded BN is read from shared memory.
//   - The tensor cores' sums truncate. f32 sums each tap's products from
//     zero in the wgmma accumulator and adds them into an f32 side sum in
//     registers (an ordinary, rounding add) at the tap's end, which waits
//     for the warpgroup's wgmmas; a plain emulation of that stays within
//     2.8e-6 of the plain version at C = 128, against 2.1e-5 for one
//     accumulator over the conv's whole K = 1152 (K1's tolerance is 1e-4;
//     tests/test_torch_res_block_gemm.py). The side sum's 64 registers are
//     why f32 takes a producer warpgroup and one k-step a commit group.
//     bf16 keeps one accumulator over K: its error is bf16's rounding of h
//     and out, and its consumers have no 64 registers to spare.
//   - The waits on mbarriers loop in PTX and the roles branch on a warp
//     index the compiler knows is warp-uniform: otherwise ptxas serializes
//     the wgmmas (C7518, which kernel_report prints).
//
// Plain C interface, no PyTorch header: built with nvcc into a shared
// library and called through ctypes (baryon_painter_tpu_torch/ops/_build.py).
// cuTensorMapEncodeTiled is reached through the runtime's driver entry
// point, so the library needs no -lcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "ptx.cuh"

namespace {

constexpr int kTW = 16;                 // output tile: TH rows x 16 columns
constexpr int kMW = kTW + 2;            // conv1 region: TH + 2 rows x 18
constexpr int kXW = kTW + 4;            // staged x: TH + 4 rows x 20
constexpr int kN = 128;                 // output channels a wgmma computes
constexpr int kRow = 128;               // bytes of a staged pixel's channel group
constexpr uint32_t kMask13 = 0xffffe000u;

// KW: input channels in a 128-byte group; STAGES: the weight ring's depth;
// PARTS: weight parts a chunk (f32: big and small); ALIAS: h over x;
// SIDE_SUM: each tap's products summed from zero on the tensor cores and
// added into an f32 sum in registers; TH:
// the output tile's rows; WGS: consumer warpgroups, one m64 tile of
// conv1's region each; PRODUCERS: the producer's threads, a warp or a
// warpgroup that hands its registers to the consumers (setmaxnreg: down to
// PRODUCER_REGS, consumers up to CONSUMER_REGS; 0: not set)
template <typename T>
struct Elt;
template <>
struct Elt<float> {
  static constexpr int KW = 32, STAGES = 3, PARTS = 2, TH = 8, WGS = 3;
  static constexpr int PRODUCERS = 128, PRODUCER_REGS = 24,
                       CONSUMER_REGS = 160;
  static constexpr bool ALIAS = true, SIDE_SUM = true;
  static constexpr CUtensorMapDataType TMA_TYPE =
      CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};
template <>
struct Elt<__nv_bfloat16> {
  static constexpr int KW = 64, STAGES = 5, PARTS = 1, TH = 12, WGS = 4;
  static constexpr int PRODUCERS = 128, PRODUCER_REGS = 24,
                       CONSUMER_REGS = 112;
  static constexpr bool ALIAS = false, SIDE_SUM = false;
  static constexpr CUtensorMapDataType TMA_TYPE =
      CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};

// The tile's regions and threads for a type
template <typename T>
struct Geo {
  static constexpr int TH = Elt<T>::TH;
  static constexpr int MPIX = (TH + 2) * kMW;       // conv1's region
  static constexpr int XH = TH + 4;
  static constexpr int XPIX = XH * kXW;             // staged x
  static constexpr int M2 = TH * kTW / 64;          // conv2's m64 tiles
  static constexpr int CONSUMERS = 128 * Elt<T>::WGS;
  static constexpr int THREADS = CONSUMERS + Elt<T>::PRODUCERS;
  static constexpr uint32_t XGROUP = XPIX * kRow;   // a channel group's bytes
  static constexpr uint32_t HGROUP = MPIX * kRow;
  static constexpr uint32_t OGROUP = TH * kTW * kRow;   // out's staging
  static_assert((MPIX + 63) / 64 == Elt<T>::WGS, "an m64 tile a warpgroup");
  static_assert(XGROUP % 1024 == 0 && OGROUP % 1024 == 0, "swizzle atoms");
};

template <typename T>
__host__ __device__ constexpr uint32_t stage_bytes() {
  return Elt<T>::PARTS * kN * kRow;
}

// Shared memory of a launch with G channel groups, offsets from a
// 1024-byte aligned base (swizzle atoms and TMA boxes start on one)
struct Layout {
  uint32_t h, ring, bars, sb, bytes;
};

template <typename T>
__host__ __device__ constexpr Layout layout(int G) {
  using E = Elt<T>;
  const uint32_t x_end = G * Geo<T>::XGROUP;
  const uint32_t h = E::ALIAS ? 0 : x_end;
  const uint32_t h_end = E::ALIAS ? x_end : x_end + G * Geo<T>::HGROUP;
  const uint32_t ring = (h_end + 1023) / 1024 * 1024;
  const uint32_t bars = ring + E::STAGES * stage_bytes<T>();
  // full[STAGES], empty[STAGES], x; then s1, b1, s2, b2 (128 f32 each);
  // and the slack to align the base
  const uint32_t sb = bars + (2 * E::STAGES + 2) * 8;
  return {h, ring, bars, sb, sb + 4 * kN * 4 + 1024};
}

// The A fragments of one commit group (KK k-steps of 32 bytes) and their
// products with the stage's weights
template <typename T>
struct Frag;

template <>
struct Frag<float> {
  static constexpr int KK = 1;   // the side sum's registers leave room for one
  uint32_t big[KK][4], small[KK][4];
  // row: this lane's pixel row; u0: the group's first 16-byte unit
  __device__ __forceinline__ void load(uint32_t row, int x7, int u0,
                                       int hi) {
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      uint32_t r[4];
      ldmatrix_x4(r, row + (((u0 + 2 * kk + hi) ^ x7) << 4));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        big[kk][e] = r[e] & kMask13;
        small[kk][e] = __float_as_uint(__uint_as_float(r[e]) -
                                       __uint_as_float(big[kk][e]));
      }
    }
  }
  // desc: the big half at this group's K offset; small = big + 128 rows
  __device__ __forceinline__ void mma(float (&acc)[64], uint64_t desc) const {
    constexpr uint64_t kSmall = (kN * kRow) >> 4;
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      wgmma_tf32(acc, small[kk], desc + 2 * kk);
      wgmma_tf32(acc, big[kk], desc + kSmall + 2 * kk);
      wgmma_tf32(acc, big[kk], desc + 2 * kk);
    }
  }
};

template <>
struct Frag<__nv_bfloat16> {
  static constexpr int KK = 2;
  uint32_t a[KK][4];
  __device__ __forceinline__ void load(uint32_t row, int x7, int u0,
                                       int hi) {
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
      ldmatrix_x4(a[kk], row + (((u0 + 2 * kk + hi) ^ x7) << 4));
  }
  __device__ __forceinline__ void mma(float (&acc)[64], uint64_t desc) const {
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) wgmma_bf16(acc, a[kk], desc + 2 * kk);
  }
};

// The ring's barriers: full[s] completes when chunk data landed, empty[s]
// when every consumer warp is done with it
struct Ring {
  uint32_t data, bars;
  int stages;
  __device__ __forceinline__ uint32_t full(int s) const { return bars + 8 * s; }
  __device__ __forceinline__ uint32_t empty(int s) const {
    return bars + 8 * (stages + s);
  }
};

// One conv as an implicit GEMM for this warpgroup's m64 tile: chunks i0 ..
// i0 + 9 G - 1 of the ring (this conv's), A from the source region `src`
// (G groups of `group` bytes, `sw` pixels a row) at pixel q0 + tap offset
// for this lane's row. An inactive warpgroup only releases the stages.
// With SIDE_SUM the accumulator is drained into an f32 sum at each tap's
// end and restarts from zero; the conv's sum is returned in acc.
template <typename T>
__device__ __forceinline__ void conv_gemm(float (&acc)[64], uint32_t src,
                                          uint32_t group, int q0, int sw,
                                          int G, const Ring& ring, int i0,
                                          bool active, int lane) {
  constexpr int S = Elt<T>::STAGES;
  constexpr int KK = Frag<T>::KK;
  constexpr int GROUPS = 4 / KK;   // commit groups a 128-byte chunk
  const int hi = lane >> 4;
  const int nchunks = 9 * G;
  float sum[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = sum[e] = 0.f;
  Frag<T> f[2];
  for (int c = 0; c < nchunks; ++c) {
    const int i = i0 + c;
    const int s = i % S;
    mbar_wait(ring.full(s), (i / S) & 1);
    if (!active) {
      __syncwarp();
      if (lane == 0) mbar_arrive(ring.empty(s));
      continue;
    }
    const int tap = c / G;
    const int q = q0 + (tap / 3) * sw + tap % 3;
    const uint32_t row = src + (c - tap * G) * group + q * kRow;
    const uint64_t desc = wgmma_desc_sw128(ring.data + s * stage_bytes<T>());
#pragma unroll
    for (int h = 0; h < GROUPS; ++h) {
      f[h & 1].load(row, q & 7, 2 * KK * h, hi);
      wgmma_fence();
      f[h & 1].mma(acc, desc + 2 * KK * h);
      wgmma_commit();
      wgmma_wait<1>();
      // the group before this one is done: at h = 0, chunk c - 1's last
      if (h == 0 && c > 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(ring.empty((i - 1) % S));
      }
    }
    if constexpr (Elt<T>::SIDE_SUM) {
      if (c - tap * G == G - 1) {   // the tap's last chunk
        wgmma_wait<0>();
#pragma unroll
        for (int e = 0; e < 64; ++e) {
          fence_operand(acc[e]);
          sum[e] += acc[e];
          acc[e] = 0.f;
          fence_operand(acc[e]);
        }
      }
    }
  }
  if (active) {
    wgmma_wait<0>();
#pragma unroll
    for (int e = 0; e < 64; ++e) {
      fence_operand(acc[e]);
      if constexpr (Elt<T>::SIDE_SUM) acc[e] = sum[e];
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(ring.empty((i0 + nchunks - 1) % S));
  }
}

__device__ __forceinline__ float leaky(float h, float slope) {
  return h >= 0.f ? h : h * slope;
}

// 2 consecutive values as f32: from device memory through the read-only
// cache (ldg2), or from shared memory (lds2); and back as T
__device__ __forceinline__ float2 ldg2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 lds2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 lds2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
// rounds to nearest even, as a cast to bfloat16 does in JAX and PyTorch
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Byte offset of channel co of pixel p in a swizzled region of G groups
template <typename T>
__device__ __forceinline__ uint32_t swizzled(int p, int co, uint32_t group) {
  const int g = co / Elt<T>::KW;
  const int b = (co - g * Elt<T>::KW) * (int)sizeof(T);
  return g * group + p * kRow + ((((b >> 4) ^ (p & 7))) << 4) + (b & 15);
}

template <typename T>
__global__ void __launch_bounds__(Geo<T>::THREADS, 1)
    res_block_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap wmap,
                     const __grid_constant__ CUtensorMap omap,
                     const T* __restrict__ x, const float* __restrict__ s1,
                     const float* __restrict__ b1,
                     const float* __restrict__ s2,
                     const float* __restrict__ b2, int H, int W, int C,
                     int G, float inner_slope, float outer_slope) {
  using E = Elt<T>;
  using Gm = Geo<T>;
  constexpr int TH = Gm::TH;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  const Layout L = layout<T>(G);
  const uint32_t xs = base;
  const uint32_t hs = base + L.h;
  const Ring ring{base + L.ring, base + L.bars, E::STAGES};
  const uint32_t xfull = base + L.bars + 16 * E::STAGES;
  const int nchunks = 9 * G;

  const int n = blockIdx.z;
  const int ty0 = blockIdx.y * TH;
  const int tx0 = blockIdx.x * kTW;
  const int lane = threadIdx.x & 31;
  // warp-uniform in the compiler's eyes (a shuffle from lane 0), so the
  // roles' branches hold no divergent path around the wgmmas
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0);

  // the folded BN in shared memory, zero past C
  float* sbs = reinterpret_cast<float*>(sm + L.sb);
  for (int i = threadIdx.x; i < 4 * kN; i += Gm::THREADS) {
    const int k = i / kN, co = i - k * kN;
    const float* src = k == 0 ? s1 : k == 1 ? b1 : k == 2 ? s2 : b2;
    sbs[i] = co < C ? src[co] : 0.f;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < E::STAGES; ++s) {
      mbar_init(ring.full(s), 1);
      mbar_init(ring.empty(s), 4 * E::WGS);
    }
    mbar_init(xfull, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= Gm::CONSUMERS / 32) {
    if constexpr (E::PRODUCER_REGS > 0) setmaxnreg_dec<E::PRODUCER_REGS>();
    // the producer: x's halo tile, then both convs' weight chunks in the
    // consumers' order (conv, tap, channel group)
    if (warp == Gm::CONSUMERS / 32 && lane == 0) {
      tma_prefetch_map(&xmap);
      tma_prefetch_map(&wmap);
      tma_prefetch_map(&omap);
      mbar_arrive_expect_tx(xfull, G * Gm::XGROUP);
      for (int g = 0; g < G; ++g)
        tma_load_4d(xs + g * Gm::XGROUP, &xmap, xfull, g * E::KW, tx0 - 2,
                    ty0 - 2, n);
      for (int i = 0; i < 2 * nchunks; ++i) {
        const int conv = i / nchunks;
        const int c = i - conv * nchunks;
        const int tap = c / G;
        const int s = i % E::STAGES;
        mbar_wait(ring.empty(s), ((i / E::STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(ring.full(s), stage_bytes<T>());
        tma_load_4d(ring.data + s * stage_bytes<T>(), &wmap, ring.full(s),
                    (c - tap * G) * E::KW, tap, 0, conv * E::PARTS);
      }
    }
    return;
  }
  if constexpr (E::CONSUMER_REGS > 0) setmaxnreg_inc<E::CONSUMER_REGS>();

  const int wg = warp >> 2;            // consumer warpgroup
  const int wrow = 16 * (warp & 3);    // the warp's rows in the m64 tile
  const int g8 = lane >> 2;
  const int tig = lane & 3;
  float acc[64];

  // 1. conv1 on the (TH + 2) x 18 region, m64 tile wg; rows past the
  //    region repeat its last pixel and are discarded
  {
    int p = 64 * wg + wrow + (lane & 15);
    if (p >= Gm::MPIX) p = Gm::MPIX - 1;
    mbar_wait(xfull, 0);
    conv_gemm<T>(acc, xs, Gm::XGROUP, (p / kMW) * kXW + p % kMW, kXW, G,
                 ring, 0, true, lane);
  }
  // h over x: every warpgroup's conv1 reads end here
  if (E::ALIAS) named_barrier(1, Gm::CONSUMERS);

  // 2. h = round_T(act_i(s1 u + b1)), 0 outside the image (conv2's
  //    padding) and past C, into the swizzled h region
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int p = 64 * wg + wrow + g8 + 8 * r;
    if (p >= Gm::MPIX) continue;
    const int gy = ty0 - 1 + p / kMW;
    const int gx = tx0 - 1 + p % kMW;
    const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
      const int co = 8 * j + 2 * tig;
      if (co >= G * E::KW) continue;
      float v0 = 0.f, v1 = 0.f;
      if (in) {   // past C the scale and bias are 0, and so is h
        const float2 s = lds2(sbs + co), b = lds2(sbs + kN + co);
        v0 = leaky(acc[4 * j + 2 * r] * s.x + b.x, inner_slope);
        v1 = leaky(acc[4 * j + 2 * r + 1] * s.y + b.y, inner_slope);
      }
      store2(reinterpret_cast<T*>(sm + L.h +
                                  swizzled<T>(p, co, Gm::HGROUP)),
             v0, v1);
    }
  }
  named_barrier(1, Gm::CONSUMERS);

  // 3. conv2 on the TH x 16 tile (m64 tiles 0 .. M2 - 1), then s2 v + b2 +
  //    x, act_o, one write of out
  const bool active = wg < Gm::M2;
  {
    const int p = 64 * (active ? wg : 0) + wrow + (lane & 15);
    conv_gemm<T>(acc, hs, Gm::HGROUP, (p / kTW) * kMW + p % kTW, kMW, G,
                 ring, nchunks, active, lane);
  }
  if (!active) return;
  // conv2's reads of h end here (its warpgroups): h becomes the output
  // tile's staging, in TMA's swizzled rows, one TMA store a channel group
  named_barrier(2, 128 * Gm::M2);
  const T* xn = x + (size_t)n * H * W * C;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int p = 64 * wg + wrow + g8 + 8 * r;
    const int gy = ty0 + p / kTW;
    const int gx = tx0 + p % kTW;
    const bool in = gy < H && gx < W;
    const size_t pix = ((size_t)gy * W + gx) * C;
    const int q = (p / kTW + 2) * kXW + p % kTW + 2;   // staged x pixel
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
      const int co = 8 * j + 2 * tig;
      if (co >= G * E::KW) continue;
      float2 res = make_float2(0.f, 0.f);
      if constexpr (E::ALIAS) {
        if (in && co < C) res = ldg2(xn + pix + co);
      } else {
        res = lds2(reinterpret_cast<const T*>(
            sm + swizzled<T>(q, co, Gm::XGROUP)));
      }
      const float2 s = lds2(sbs + 2 * kN + co),
                   b = lds2(sbs + 3 * kN + co);
      store2(reinterpret_cast<T*>(sm + L.h +
                                  swizzled<T>(p, co, Gm::OGROUP)),
             leaky(acc[4 * j + 2 * r] * s.x + b.x + res.x, outer_slope),
             leaky(acc[4 * j + 2 * r + 1] * s.y + b.y + res.y, outer_slope));
    }
  }
  fence_proxy_async();   // the staging's writes, before TMA reads them
  named_barrier(2, 128 * Gm::M2);
  if (threadIdx.x == 0) {
    for (int g = 0; g < G; ++g)
      tma_store_4d(&omap, hs + g * Gm::OGROUP, g * E::KW, tx0, ty0, n);
    tma_store_commit_and_wait_read();
  }
}

// A 4-d tensor map in the 128-byte swizzle, out-of-bounds reads zero
template <typename T>
bool encode(EncodeTiled enc, CUtensorMap* map, const void* ptr,
            const cuuint64_t (&dims)[4], const cuuint32_t (&box)[4]) {
  const cuuint64_t strides[3] = {dims[0] * sizeof(T),
                                 dims[0] * dims[1] * sizeof(T),
                                 dims[0] * dims[1] * dims[2] * sizeof(T)};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, Elt<T>::TMA_TYPE, 4, const_cast<void*>(ptr), dims,
             strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T>
cudaError_t launch(const void* x, const void* wk, const void* s1,
                   const void* b1, const void* s2, const void* b2, void* out,
                   int n, int h, int w, int c, float inner_slope,
                   float outer_slope, cudaStream_t stream) {
  using E = Elt<T>;
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  const int G = (c + E::KW - 1) / E::KW;
  const cuuint64_t C = c;
  CUtensorMap xmap, wmap, omap;
  // x (C, W, H, N) innermost first, a box of one channel group x 20 x
  // (TH + 4)
  if (!encode<T>(enc, &xmap, x, {C, (cuuint64_t)w, (cuuint64_t)h,
                                 (cuuint64_t)n},
                 {(cuuint32_t)E::KW, kXW, Geo<T>::XH, 1}))
    return cudaErrorInvalidValue;
  // weights (ci, tap, co, part), a box of one channel group x one tap x 128
  // output channels x the parts of one conv
  if (!encode<T>(enc, &wmap, wk, {C, 9, C, 2 * E::PARTS},
                 {(cuuint32_t)E::KW, 1, kN, E::PARTS}))
    return cudaErrorInvalidValue;
  // out as x, a box of one channel group x the 16 x TH tile
  if (!encode<T>(enc, &omap, out, {C, (cuuint64_t)w, (cuuint64_t)h,
                                   (cuuint64_t)n},
                 {(cuuint32_t)E::KW, kTW, E::TH, 1}))
    return cudaErrorInvalidValue;
  const Layout L = layout<T>(G);
  cudaError_t err = cudaFuncSetAttribute(
      res_block_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L.bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((w + kTW - 1) / kTW, (h + E::TH - 1) / E::TH, n);
  res_block_kernel<T><<<grid, Geo<T>::THREADS, L.bytes, stream>>>(
      xmap, wmap, omap, static_cast<const T*>(x),
      static_cast<const float*>(s1), static_cast<const float*>(b1),
      static_cast<const float*>(s2), static_cast<const float*>(b2), h, w, c,
      G, inner_slope, outer_slope);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, out (N, H, W, C) in the type `dtype` (0 = float32, 1 = bfloat16), 16-
// byte aligned; wk the weights in the kernel's layout (ops/res_block.py
// `res_block_operands`): (2, C, 9, C) w^T of conv1 and conv2 in bf16, (4, C,
// 9, C) their big and small halves in f32; s/b (C,) f32; all contiguous.
// 4 <= C <= 128 with C % 4 == 0 (f32) or C % 8 == 0 (bf16): TMA's strides
// are multiples of 16 bytes. Returns the cudaError_t of the launch (0 on
// success); the launch is asynchronous on `stream`.
int bpt_res_block_infer(const void* x, const void* wk, const void* s1,
                        const void* b1, const void* s2, const void* b2,
                        void* out, int n, int h, int w, int c,
                        float inner_slope, float outer_slope, int dtype,
                        void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || c > kN ||
      c % (dtype == 1 ? 8 : 4) != 0 || n > 65535 || (h + 7) / 8 > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(x, wk, s1, b1, s2, b2, out, n, h, w, c,
                              inner_slope, outer_slope, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, wk, s1, b1, s2, b2, out, n, h, w,
                                      c, inner_slope, outer_slope, s);
  return (int)cudaErrorInvalidValue;
}

// Shared memory per block of a launch (bytes), for the kernel report.
int bpt_res_block_smem(int c, int dtype) {
  return (int)(dtype == 0 ? layout<float>((c + 31) / 32).bytes
                          : layout<__nv_bfloat16>((c + 63) / 64).bytes);
}

const char* bpt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
