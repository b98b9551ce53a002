// K3: the decoder's two output heads, forward and backward, hand-written for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of baryon_painter_tpu/ops/pallas_head_stack.py:
// `head_stack` -> `_head_stack_core` (forward, kernel body `_fwd_kernel`) and
// `_head_stack_bwd` (backward, kernel body `_bwd_kernel`). For every sample n
// and head h (of 2), bias-free, "same" padding, PReLU(u) = u >= 0 ? u : a*u:
//
//   u1 = conv7x7(x, w1[h])   16 -> 8    a1 = PReLU(u1, alpha[h][0])
//   u2 = conv5x5(a1, w2[h])   8 -> 1    a2 = PReLU(u2, alpha[h][1])
//   y[n][h] = conv3x3(a2, w3[h])        1 -> 1
//
// x is NHWC (N, H, W, 16), w1 (2, 7, 7, 16, 8), w2 (2, 5, 5, 8) and w3
// (2, 3, 3) HWIO, alpha (2, 2), y (N, 2, H, W); all sums in f32. Each conv's
// zero padding applies to its own input, so a1 and a2 are 0 outside the
// image.
//
// Design: every pixel's 7x7 products are computed once (no halo is
// recomputed), in passes of their own, one launch each:
//   forward  1. the u1 GEMM (head_gemm_kernel<T, 0>): u1 (N, H, W, 16) f32,
//               channel 8 h + c, written once a pixel; training keeps it for
//               the backward, painting writes it into a scratch tensor
//            2. the chain (head_chain_fwd_kernel<T>): a1, conv5, a2, conv3
//               from u1 on the CUDA cores, y
//   backward 1. the chain (head_chain_bwd_kernel<T>): from the kept u1 and
//               dy, u2 (recomputed from u1 on the tile + 2), du2, du1 once a
//               pixel into a scratch tensor in x's dtype, rounded as the
//               products read it, and per-block partials of dw2, dw3 and
//               dalpha
//            2. dx (head_gemm_kernel<T, 1>): the transposed 7x7 conv of du1
//            3. dw1 (head_dw1_kernel<T>): du1^T x as partials over a split of
//               the pixels sized from the SM count
// The wrapper (ops/head_stack.py) sums every partial in a fixed order; no
// atomics are used, so every result is deterministic.
//
// What bounds them: the 7x7 products. At (24, 512, 512) (P = 6.29 M pixels)
// each GEMM does 2 P 16 784 = 158 GFLOP: 0.96 ms as 3xTF32 on the tensor
// cores (495/3 TFLOP/s), 0.16 ms in bf16 (989 TFLOP/s); the chains' 5.3
// (forward) and 15.6 GFLOP (backward) on the CUDA cores 0.08 and 0.23 ms;
// the passes move x, y, u1 (f32, 0.40 GB, written and read back), du1 and
// dx.
//
// The GEMMs (Hopper's warpgroup products fed by TMA), all with N = 16:
//   u1:  M = output pixels, N = (h, c), K = (ky, kx, ci) = 784
//   dx:  M = input pixels,  N = ci,     K = (h, ky, kx, c), each head's 392
//        padded to whole 128-byte rows (bf16 rounds each head's sum before
//        the two are added)
//   dw1: M = (ky, kx, ci) = 784 in 13 m64 tiles of 4 taps, N = (h, c),
//        K = the pixels of the block's split
//   - wgmma m64n16, k8 tf32 or k16 bf16, A from registers, B from 128-byte
//     swizzled shared memory. f32 is 3xTF32: A split in registers into big
//     = v with 13 low bits cleared and small = v - big, B split the same way
//     by the wrapper (u1, dx) or as it is staged (dw1); small*big +
//     big*small + big*big. bf16 products are exact.
//   - A block = three consumer warpgroups and a producer warpgroup that
//     gives its registers to them (setmaxnreg 56 / 152); one thread of the
//     producer keeps TMA loads in flight through a ring of full/empty
//     mbarrier pairs.
//   - u1 and dx: persistent blocks, one an SM, walk tiles of 24 (f32) or 48
//     (bf16) x 16 pixels; a warpgroup holds two (f32) or four (bf16) m64
//     tiles of 4 rows x 16 columns, so that many independent products are
//     in flight in each k-step. The whole B (16 x 784, both parts) is loaded
//     once a block; the ring carries the tile's window of x (u1) or du1
//     (dx), rows and columns - 3 .. + 3, by TMA with zeros outside the
//     image, in the 64-byte (f32) or 32-byte (bf16) swizzle that makes the
//     ldmatrix that gathers each A fragment conflict-free (16-byte chunk j
//     of pixel row p at j ^ (p / 2 % 4), resp. j ^ (p / 4 % 2)).
//   - dw1: blocks over a split of the pixels in chunks of 4 rows x one
//     128-byte K row of pixels (32 f32, 64 bf16); the ring carries the
//     chunk's du1 and its x window (rows + 6, columns + 6); the consumers
//     transpose du1 into the K-major B tiles (f32: split) and gather A from
//     x (bf16: ldmatrix.trans; f32: 32-bit loads with the rows of a tap
//     ordered (ci % 4) + 4 (row / 8) + 8 (row / 4 % 2), which keeps them
//     conflict-free). The side sums of a warpgroup's first 3 (f32) or 4
//     (bf16) tiles stay in registers, the others' in shared slots.
//   - The tensor cores' sums truncate. f32 sums each 128-byte K row's
//     products (4 k-steps) from zero and adds them into an f32 side sum in
//     registers; bf16 sums all of u1's K, a head's K of dx and a dw1 chunk's
//     row in the accumulator (49, 25 and 4 k16 steps). Each step of the
//     mainloops' runtime loops ends with every wgmma group done (a group in
//     flight across a runtime loop's back edge makes ptxas serialize the
//     wgmmas, C7514); bf16 u1 and dx unroll a head's rows in one step. A
//     bf16 A fragment is loaded into its own registers once the wgmma that
//     last read them is done: loaded ahead and copied, the copy was folded
//     into the load's registers, which the next load then rewrote under an
//     in-flight wgmma (wrong sums; made opaque, ptxas serialized, C7513).
//   - The waits on mbarriers loop in PTX and the roles branch on a warp index
//     the compiler knows is warp-uniform (else C7518).
//
// The chains run on the CUDA cores from shared memory, each thread a run of
// 4 outputs along a row with the rows of its inputs in registers (16-byte
// loads), the weights in shared memory; every staging load of a thread is
// issued before the first is used.
//
// bf16 (the JAX package's default compute dtype): x, y, dy, dx, du1 and the
// GEMMs' weights are bfloat16; u1, w2, w3 (rounded to bf16 by the wrapper),
// alpha and every weight and slope gradient stay f32. The kernels round
// where the JAX kernels round (pallas_head_stack.py _chain_fwd, _bwd_kernel):
// a1 and a2 are rounded to bf16 before the conv that reads them, y is
// stored in bf16; in the backward du2 and du1 are rounded before the
// products that read them (with a1, a2 for dw2, dw3), PReLU's masks and
// dalpha come from the f32 u1 and u2, and dx is each head's sum rounded to
// bf16, the two added and rounded again.
//
// Plain C interface, no PyTorch header: built with nvcc into a shared
// library and called through ctypes (baryon_painter_tpu_torch/ops/_build.py).
// cuTensorMapEncodeTiled is reached through the runtime's driver entry
// point, so the library needs no -lcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"
#include "ptx.cuh"

namespace {

typedef __nv_bfloat16 bf16;

template <typename T>
constexpr bool kF32 = std::is_same<T, float>::value;

constexpr int kCin = 16;   // head input channels
constexpr int kC1 = 8;     // conv7 output channels
constexpr int kHeads = 2;
constexpr int kN1 = kHeads * kC1;   // 16: both heads' conv7 channels
constexpr int kTaps = 49;
constexpr int kW1 = kTaps * kCin * kC1;   // w1 entries per head (6272)
constexpr int kW2 = 25 * kC1;             // w2 entries per head (200)

constexpr int kMaxSmem = 232448;    // bytes a block may use
constexpr int kWGS = 3;             // consumer warpgroups
constexpr int kConsumers = 128 * kWGS;
constexpr int kThreads = kConsumers + 128;   // and the producer warpgroup
// registers a producer and a consumer thread (setmaxnreg): 3 x 128 x 152 +
// 128 x 56 is the SM's 65536; dw1's producer, which walks its chunks,
// spilled at 40
constexpr int kProducerRegs = 56;
constexpr int kConsumerRegs = 152;
constexpr int kRow = 128;           // bytes of K a B row holds
constexpr int kBPart = kN1 * kRow;  // bytes of one part of a B row (2048)

// u1 and dx: a tile of gemm_tr x kTW pixels; warpgroup wg's warp w holds
// tile rows 4 wg + w + 12 m of its gemm_mt m64 tiles (bf16's products are
// short: four tiles in flight a k-step, f32's registers hold two); the
// window (gemm_tr + 6) x (kTW + 6) pixels
constexpr int kTW = 16;
constexpr int kFW = kTW + 6;
template <typename T>
__host__ __device__ constexpr int gemm_mt() {
  return std::is_same<T, float>::value ? 2 : 4;
}
template <typename T>
__host__ __device__ constexpr int gemm_tr() {
  return 4 * kWGS * gemm_mt<T>();
}

// dw1: a chunk is kRD image rows x one 128-byte K row of pixels; a
// warpgroup holds up to kDwMT of the 13 m64 row tiles, the side sums of the
// first dw_reg_tiles in registers, of the others in shared memory (all in
// registers spilled)
constexpr int kRD = 4;
constexpr int kDwTiles = 13;
constexpr int kDwMT = 5;
template <typename T>
__host__ __device__ constexpr int dw_reg_tiles() {
  return std::is_same<T, float>::value ? 3 : 4;
}

__host__ __device__ constexpr int cdiv(int v, int m) {
  return (v + m - 1) / m;
}
__host__ __device__ constexpr int rup(int v, int m) {
  return cdiv(v, m) * m;
}

// KCH: K elements a 128-byte row; PARTS: B's parts (f32: big and small); PB:
// bytes of a 16-channel pixel
template <typename T>
struct Elt;
template <>
struct Elt<float> {
  static constexpr int KCH = 32, PARTS = 2, PB = 64;
  static constexpr CUtensorMapDataType TMA = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  static constexpr CUtensorMapSwizzle SWZ = CU_TENSOR_MAP_SWIZZLE_64B;
};
template <>
struct Elt<bf16> {
  static constexpr int KCH = 64, PARTS = 1, PB = 32;
  static constexpr CUtensorMapDataType TMA =
      CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static constexpr CUtensorMapSwizzle SWZ = CU_TENSOR_MAP_SWIZZLE_32B;
};

// 128-byte K rows of B: u1 (KIND 0) K = 784; dx (KIND 1) each head's 392
template <typename T, int KIND>
__host__ __device__ constexpr int gemm_rows() {
  return KIND == 0 ? cdiv(kTaps * kCin, Elt<T>::KCH)
                   : 2 * cdiv(kTaps * kC1, Elt<T>::KCH);
}

__device__ __forceinline__ float prelu(float u, float a) {
  return u >= 0.f ? u : a * u;
}

// v rounded to T, held as f32 (the identity for f32); to nearest even, as
// a cast to bfloat16 rounds in JAX and PyTorch
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  if constexpr (kF32<T>) {
    return v;
  } else {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// acc[h] += v with h a run-time value, without indexing the register array
// dynamically (which would put it in local memory)
__device__ __forceinline__ void add_to_head(float (&acc)[kHeads], int h,
                                            float v) {
  acc[0] += h == 0 ? v : 0.f;
  acc[1] += h == 1 ? v : 0.f;
}

__device__ __forceinline__ bool inside(int gy, int gx, int H, int W) {
  return gy >= 0 && gy < H && gx >= 0 && gx < W;
}

// Byte offset of 16-byte chunk j of pixel p (the p-th 16-channel row) in a
// window TMA wrote in the swizzle of its type: f32 rows of 64 bytes, 64-byte
// swizzle, chunk j at j ^ (p / 2 % 4); bf16 rows of 32 bytes, 32-byte
// swizzle, chunk j at j ^ (p / 4 % 2) (the window starts on 1024 bytes)
template <typename T>
__device__ __forceinline__ uint32_t win_off(int p, int j) {
  if constexpr (kF32<T>) {
    return (uint32_t)(p * 64 + ((j ^ ((p >> 1) & 3)) << 4));
  } else {
    return (uint32_t)(p * 32 + ((j ^ ((p >> 2) & 1)) << 4));
  }
}

// The A fragment of one k-step: f32 split into big and small (3xTF32) from
// the words loaded a k-step ahead (raw); bf16 loaded into `a` itself once
// the wgmma that last read it is done (a copy of loaded registers may be
// folded into them, and a load ahead then rewrites registers an in-flight
// wgmma reads: ptxas serializes the wgmmas, C7513)
template <typename T>
struct AFrag;

template <>
struct AFrag<float> {
  uint32_t big[4], small[4];
  __device__ __forceinline__ void set(const uint32_t (&r)[4]) {
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(r[e]), big[e],
                                           small[e]);
  }
  // d (+)= a b in 3xTF32; desc: B's big part, its small part kBPart on
  __device__ __forceinline__ void mma(float (&d)[8], uint64_t desc,
                                      bool accumulate) const {
    constexpr uint64_t kSmall = (uint64_t)kBPart >> 4;
    Wgmma<16>::tf32(d, small, desc, accumulate);
    Wgmma<16>::tf32(d, big, desc + kSmall, true);
    Wgmma<16>::tf32(d, big, desc, true);
  }
};

template <>
struct AFrag<bf16> {
  uint32_t a[4];
  __device__ __forceinline__ void mma(float (&d)[8], uint64_t desc,
                                      bool accumulate) const {
    Wgmma<16>::bf16(d, a, desc, accumulate);
  }
};

// sum += acc, once acc's wgmma group is done (an ordinary, rounding add)
__device__ __forceinline__ void drain(float (&sum)[8], float (&acc)[8]) {
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    fence_operand(acc[e]);
    sum[e] += acc[e];
  }
}

// A of the first k-step into f[0] (fetch(0, m, dst) loads m64 tile m's
// words of k-step 0 of the row into dst)
template <typename T, int MT, class Fetch>
__device__ __forceinline__ void first_fragment(AFrag<T> (&f)[2][MT],
                                               Fetch&& fetch) {
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if constexpr (kF32<T>) {
      uint32_t raw[4];
      fetch(0, m, raw);
      f[0][m].set(raw);
    } else {
      fetch(0, m, f[0][m].a);
    }
  }
}

// The products of NR 128-byte K rows of B (4 k-steps each, ks = 4 r + kk)
// for MT m64 tiles, unrolled (no wgmma group crosses a runtime loop's back
// edge, C7514), A of k-step 0 in f[0] already. Runs of CH rows are summed
// from zero in an accumulator, acc[run % 2], and added into sum[I0 + m] one
// k-step after the run's last is done, while the next run's products go on
// (f32: CH = 1, the tensor cores' truncating sums stay short; bf16 sums the
// rows in one run). The next k-step's A (fetch(ks, m, dst); ks = 4 NR, with
// `more`, the next call's k-step 0, into f[0]) loads while this one's
// products run: f32 into raw before the wait, split after it; bf16 into
// f[(ks + 1) % 2] after the wait that frees it. Two groups in flight; all
// done at the end.
template <typename T, int MT, int NR, int CH, int I0 = 0, bool WHOLE = false,
          int S, class Desc, class Fetch>
__device__ __forceinline__ void k_rows(float (&sum)[S][8],
                                       AFrag<T> (&f)[2][MT], bool more,
                                       Desc&& desc, Fetch&& fetch) {
  constexpr int KS = 4 * NR;
  // WHOLE: the call's rows are all of sum's K; bf16 then sums them straight
  // into sum (overwritten at k-step 0)
  constexpr bool DIRECT = WHOLE && !kF32<T> && CH == NR;
  float acc[DIRECT ? 1 : 2][MT][8];
  uint32_t raw[MT][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int r = ks >> 2;
    const int c = r / CH;
    const bool first = ks % (4 * CH) == 0;
    wgmma_fence();
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if constexpr (DIRECT) {
        f[ks & 1][m].mma(sum[I0 + m], desc(r) + 2 * (ks & 3), !first);
      } else {
        f[ks & 1][m].mma(acc[c & 1][m], desc(r) + 2 * (ks & 3), !first);
      }
    }
    wgmma_commit();
    const bool next = ks + 1 < KS || more;
    if constexpr (kF32<T>) {
      if (next)
#pragma unroll
        for (int m = 0; m < MT; ++m) fetch(ks + 1, m, raw[m]);
    }
    wgmma_wait<1>();
    if constexpr (!DIRECT) {
      if (first && c > 0)
#pragma unroll
        for (int m = 0; m < MT; ++m)
          drain(sum[I0 + m], acc[(c - 1) & 1][m]);
    }
    if (next) {
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if constexpr (kF32<T>) {
          f[(ks + 1) & 1][m].set(raw[m]);
        } else {
          fetch(ks + 1, m, f[(ks + 1) & 1][m].a);
        }
      }
    }
  }
  wgmma_wait<0>();
  if constexpr (DIRECT) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int e = 0; e < 8; ++e) fence_operand(sum[I0 + m][e]);
  } else {
    constexpr int CL = (NR - 1) / CH;
#pragma unroll
    for (int m = 0; m < MT; ++m) drain(sum[I0 + m], acc[CL & 1][m]);
  }
}

// The ring's barriers: full[s] completes when a stage's data landed,
// empty[s] when every consumer warp is done with it
struct Ring {
  uint32_t bars;
  int stages;
  __device__ __forceinline__ uint32_t full(int s) const {
    return bars + 8 * s;
  }
  __device__ __forceinline__ uint32_t empty(int s) const {
    return bars + 8 * (stages + s);
  }
};

// The shared-memory address of the block's shared memory from a 1024-byte
// aligned base (swizzle atoms and TMA boxes start on one)
__device__ __forceinline__ uint32_t smem_base() {
  extern __shared__ unsigned char smem_raw[];
  return (smem_u32(smem_raw) + 1023) & ~1023u;
}

// full[s] completes on one arrival and its TMA bytes, empty[s] on one
// arrival a consumer warp
__device__ __forceinline__ void init_ring(const Ring& ring) {
  for (int s = 0; s < ring.stages; ++s) {
    mbar_init(ring.full(s), 1);
    mbar_init(ring.empty(s), kConsumers / 32);
  }
}

__device__ __forceinline__ void release(const Ring& ring, int s, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(ring.empty(s));
}

// ------------------------------------------------------------------------ //
// The pixel GEMMs: u1 (KIND 0) and dx (KIND 1)

struct GemmGeo {
  int rows;      // 128-byte K rows of B
  int wtile;     // bytes of a K row of B, all parts
  int wbytes;    // B: rows x wtile
  int winbytes;  // a window (the TMA box)
  int stage;     // a window's stride in the ring
  int stages;
  int bars;      // offset of the barriers: B's, then the ring's
  int bytes;     // shared memory asked
};

template <typename T, int KIND>
GemmGeo gemm_geo() {
  GemmGeo g{};
  g.rows = gemm_rows<T, KIND>();
  g.wtile = Elt<T>::PARTS * kBPart;
  g.wbytes = g.rows * g.wtile;
  g.winbytes = (gemm_tr<T>() + 6) * kFW * Elt<T>::PB;
  g.stage = rup(g.winbytes, 1024);
  for (g.stages = 4; g.stages >= 2; --g.stages) {
    g.bars = g.wbytes + g.stages * g.stage;
    g.bytes = g.bars + 8 * (1 + 2 * g.stages) + 1024;
    if (g.bytes <= kMaxSmem) break;
  }
  if (g.stages < 2) g.bytes = 0;
  return g;
}

// The tap and 16-byte chunk of the pixel that lane group mi (lanes 8 mi ..
// 8 mi + 7: ldmatrix's matrix mi) reads at k-step ks. A row's K is (tap,
// channel): u1 (ky, kx, ci), dx (h, ky, kx, c) per head; matrices 0, 1 hold
// the fragment's first k half (rows 0-7, 8-15), 2, 3 its second. Padded K
// (past the last tap) reads tap 48 against zero weights.
template <typename T, int KIND>
__device__ __forceinline__ void kstep_tap(int ks, int mi, int& tap,
                                          int& chunk) {
  if constexpr (KIND == 0) {
    if constexpr (kF32<T>) {   // k8: half a tap's 16 channels
      tap = ks >> 1;
      chunk = 2 * (ks & 1) + (mi >> 1);
    } else {                   // k16: a tap's 16 channels
      tap = ks;
      chunk = mi >> 1;
    }
  } else {
    constexpr int SH = 2 * gemm_rows<T, 1>();   // k-steps a head
    const int h = ks >= SH ? 1 : 0;
    const int s = ks - h * SH;
    if constexpr (kF32<T>) {   // k8: a tap's 8 (h, c)
      tap = s;
      chunk = 2 * h + (mi >> 1);
    } else {                   // k16: two taps' 8 (h, c)
      tap = 2 * s + (mi >> 1);
      chunk = h;
    }
  }
  tap = tap < kTaps - 1 ? tap : kTaps - 1;
}

// The tile t of a u1 or dx launch: 16-column tile fastest, then TR-row
// tile, then sample
template <int TR>
__device__ __forceinline__ void gemm_tile(int t, int H, int W, int& n,
                                          int& ty0, int& tx0) {
  const int tx = cdiv(W, kTW);
  const int ty = cdiv(H, TR);
  tx0 = (t % tx) * kTW;
  ty0 = ((t / tx) % ty) * TR;
  n = t / (tx * ty);
}

// u1 (KIND 0): amap the x window, out u1 (N, H, W, 16) f32. dx (KIND 1):
// amap the du1 window, out dx (N, H, W, 16) in T. wmap B (PARTS, 16, rows x
// KCH): u1 [h, c][ky, kx, ci], dx [ci][h][ky, kx, c] (per head padded).
template <typename T, int KIND>
__global__ void __launch_bounds__(kThreads, 1)
    head_gemm_kernel(const __grid_constant__ CUtensorMap amap,
                     const __grid_constant__ CUtensorMap wmap,
                     const GemmGeo g, int N, int H, int W,
                     void* __restrict__ out) {
  constexpr int ROWS = gemm_rows<T, KIND>();
  constexpr int MT = gemm_mt<T>();
  constexpr int TR = gemm_tr<T>();
  const uint32_t sm = smem_base();
  const uint32_t wbar = sm + g.bars;
  const Ring ring{wbar + 8, g.stages};
  const int lane = threadIdx.x & 31;
  const int warp = warp_id();
  const int tiles = N * cdiv(W, kTW) * cdiv(H, TR);

  if (threadIdx.x == 0) {
    mbar_init(wbar, 1);
    init_ring(ring);
    mbar_fence_init();
  }
  __syncthreads();
  if (warp >= kConsumers / 32) {
    setmaxnreg_dec<kProducerRegs>();
    if (warp == kConsumers / 32 && lane == 0) {
      tma_prefetch_map(&amap);
      tma_prefetch_map(&wmap);
      mbar_arrive_expect_tx(wbar, g.wbytes);
      for (int r = 0; r < ROWS; ++r)
        tma_load_4d(sm + r * g.wtile, &wmap, wbar, r * Elt<T>::KCH, 0,
                    0, 0);
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++it) {
        const int s = it % g.stages;
        mbar_wait(ring.empty(s), ((it / g.stages) & 1) ^ 1);
        int n, ty0, tx0;
        gemm_tile<TR>(t, H, W, n, ty0, tx0);
        mbar_arrive_expect_tx(ring.full(s), g.winbytes);
        tma_load_4d(sm + g.wbytes + s * g.stage, &amap, ring.full(s), 0,
                    tx0 - 3, ty0 - 3, n);
      }
    }
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();

  const int wg = warp >> 2;
  const int mi = lane >> 3;
  const int gl = lane >> 2;
  const int tig = lane & 3;
  // the tile row of the warp's rows of each m64 tile, and the pixel column
  // whose row address this lane gives ldmatrix
  int trow[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) trow[m] = 4 * wg + (warp & 3) + 12 * m;
  const int rho = (lane & 7) + 8 * (mi & 1);
  mbar_wait(wbar, 0);
  int it = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++it) {
    const int s = it % g.stages;
    int n, ty0, tx0;
    gemm_tile<TR>(t, H, W, n, ty0, tx0);
    // the window's pixel of the lane's row at tap (0, 0): u1 reads x at
    // (r + ky - 3, c + kx - 3), dx du1 at (r + 3 - ky, c + 3 - kx), both
    // windows from (ty0 - 3, tx0 - 3)
    int rowbase[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m)
      rowbase[m] = KIND == 0 ? trow[m] * kFW + rho
                             : (trow[m] + 6) * kFW + rho + 6;
    const uint32_t win = sm + g.wbytes + s * g.stage;
    // f32: the side sums; bf16: the accumulator itself (u1 over all of K,
    // dx over a head's K, head 0's rounded to bf16 pairs into h0 before
    // head 1's)
    float sum[MT][8];
    uint32_t h0[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int e = 0; e < 8; ++e) sum[m][e] = 0.f;
    AFrag<T> f[2][MT];
    // m64 tile m's A words of k-step ks into dst
    auto fetch = [&](int ks, int m, uint32_t (&dst)[4]) {
      int tap, chunk;
      kstep_tap<T, KIND>(ks, mi, tap, chunk);
      const int toff = (tap / 7) * kFW + tap % 7;
      ldmatrix_x4(dst, win + win_off<T>(KIND == 0 ? rowbase[m] + toff
                                                  : rowbase[m] - toff,
                                        chunk));
    };
    mbar_wait(ring.full(s), (it / g.stages) & 1);
    first_fragment<T, MT>(f, fetch);
    if constexpr (kF32<T>) {
      // a row a step, each summed from zero and drained (longer unrolled
      // runs' double-buffered side sums spilled, and ran no faster)
#pragma unroll 1
      for (int r = 0; r < ROWS; ++r)
        k_rows<T, MT, 1, 1>(
            sum, f, r + 1 < ROWS,
            [&](int) { return wgmma_desc_sw128(sm + r * g.wtile); },
            [&](int ks, int m, uint32_t (&dst)[4]) {
              fetch(4 * r + ks, m, dst);
            });
    } else {
      // a head's rows (u1: all of K) unrolled, summed straight in sum
      constexpr int RH = KIND == 0 ? ROWS : ROWS / 2;
#pragma unroll 1
      for (int r0 = 0; r0 < ROWS; r0 += RH) {
        k_rows<T, MT, RH, RH, 0, true>(
            sum, f, r0 + RH < ROWS,
            [&](int r) {
              return wgmma_desc_sw128(sm + (r0 + r) * g.wtile);
            },
            [&](int ks, int m, uint32_t (&dst)[4]) {
              fetch(4 * r0 + ks, m, dst);
            });
        if (KIND == 1 && r0 == 0)
#pragma unroll
          for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const __nv_bfloat162 b =
                  __floats2bfloat162_rn(sum[m][2 * q], sum[m][2 * q + 1]);
              h0[m][q] = *reinterpret_cast<const uint32_t*>(&b);
            }
      }
    }
    release(ring, s, lane);

    // sum[m][4 j + 2 hh + c]: pixel (tile row trow[m], column gl + 8 hh),
    // column 8 j + 2 tig + c of N
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int gy = ty0 + trow[m];
      if (gy >= H) continue;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int gx = tx0 + gl + 8 * hh;
        if (gx >= W) continue;
        const size_t pix = ((size_t)n * H + gy) * W + gx;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = 8 * j + 2 * tig;
          if constexpr (KIND == 0 || kF32<T>) {
            *reinterpret_cast<float2*>(static_cast<float*>(out) + pix * 16 +
                                       col) =
                make_float2(sum[m][4 * j + 2 * hh],
                            sum[m][4 * j + 2 * hh + 1]);
          } else {
            // each head's dx rounded to bf16, the two added and rounded
            const __nv_bfloat162 a =
                *reinterpret_cast<const __nv_bfloat162*>(&h0[m][2 * j + hh]);
            const float v0 = __low2float(a) +
                             rnd<bf16>(sum[m][4 * j + 2 * hh]);
            const float v1 = __high2float(a) +
                             rnd<bf16>(sum[m][4 * j + 2 * hh + 1]);
            *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(out) +
                                               pix * 16 + col) =
                __floats2bfloat162_rn(v0, v1);
          }
        }
      }
    }
  }
}

// ------------------------------------------------------------------------ //
// dw1: M = (tap, ci) in 13 m64 tiles of 4 taps, N = (h, c), K = pixels

struct DwGeo {
  int cw, fwx;           // a chunk's columns; the x window's width
  int rawbytes, xbytes;  // du1 and x boxes
  int stage, stages;
  int b, bars, slots, bytes;   // B tiles', barriers', the shared side
                               // sums' offsets; shared memory asked
  int segs, rbs, chunks, per, splits;   // column segments and row blocks
                                        // of an image, chunks, chunks a
                                        // split, splits
};

template <typename T>
DwGeo dw_geo(int n, int h, int w, int sms) {
  DwGeo g{};
  g.cw = Elt<T>::KCH;
  g.fwx = g.cw + 6;
  g.rawbytes = kRD * g.cw * kCin * (int)sizeof(T);
  const int slots = (kDwMT - dw_reg_tiles<T>()) * 8 * kConsumers * 4;
  g.xbytes = (kRD + 6) * g.fwx * Elt<T>::PB;
  g.stage = rup(g.rawbytes, 1024) + rup(g.xbytes, 1024);
  const int bbytes = kRD * Elt<T>::PARTS * kBPart;
  for (g.stages = 4; g.stages >= 2; --g.stages) {
    g.b = g.stages * g.stage;
    g.bars = g.b + bbytes;
    g.slots = g.bars + 16 * g.stages;
    g.bytes = g.slots + slots + 1024;
    if (g.bytes <= kMaxSmem) break;
  }
  if (g.stages < 2) g.bytes = 0;
  g.segs = cdiv(w, g.cw);
  g.rbs = cdiv(h, kRD);
  const long long chunks = (long long)n * g.rbs * g.segs;
  g.chunks = chunks > 0x7fffffffLL ? 0 : (int)chunks;
  // one split a block, one block an SM (at most one a chunk)
  g.splits = sms < g.chunks ? sms : g.chunks;
  if (g.splits < 1) g.splits = 1;
  g.per = cdiv(g.chunks, g.splits);
  g.splits = cdiv(g.chunks, g.per);
  return g;
}

// The A fragment of k-step kk of chunk row r for a tap's 16 rows from the
// x window at xwin. f32: row rho = gl (+ 8) is channel (gl % 4) + 4 (rho /
// 8) + 8 (gl / 4), column k = tig (+ 4) the chunk's pixel 8 kk + tig (+ 4);
// x at window pixel (r + ky, col + kx), its 32-bit words gathered through
// the 64-byte swizzle. bf16: ldmatrix.trans of the 8-channel chunks (mi &
// 1) of pixels 16 kk + 8 (mi / 2) + (lane & 7): rows = channels in order,
// k = pixels.
template <typename T>
__device__ __forceinline__ void dw1_fetch(uint32_t (&raw)[4], uint32_t xwin,
                                          int fwx, int r, int kk, int tap,
                                          int lane) {
  if constexpr (kF32<T>) {
    const int gl = lane >> 2, tig = lane & 3;
    const int p0 = (r + tap / 7) * fwx + 8 * kk + tig + tap % 7;
    const int ci0 = (gl & 3) + 8 * (gl >> 2);
    auto at = [&](int p, int ci) {
      return xwin + 4 * (16 * p + 4 * ((ci >> 2) ^ ((p >> 1) & 3)) +
                         (ci & 3));
    };
    raw[0] = lds32(at(p0, ci0));
    raw[1] = lds32(at(p0, ci0 + 4));
    raw[2] = lds32(at(p0 + 4, ci0));
    raw[3] = lds32(at(p0 + 4, ci0 + 4));
  } else {
    const int mi = lane >> 3;
    const int p = (r + tap / 7) * fwx + 16 * kk + 8 * (mi >> 1) +
                  (lane & 7) + tap % 7;
    ldmatrix_x4_trans(raw, xwin + win_off<bf16>(p, mi & 1));
  }
}

// The channel of row rho of a tap's 16 rows of dw1's M
template <typename T>
__device__ __forceinline__ int dw1_channel(int rho) {
  if constexpr (kF32<T>) {
    return (rho & 3) + 4 * (rho >> 3) + 8 * ((rho >> 2) & 1);
  } else {
    return rho;
  }
}

// The chunk's products for the warpgroup's m64 tiles TILE0 .. TILE0 + MT -
// 1 into sum[I0 ..]: kRD rows of K, each of four k-steps
// The warp's tap in the warpgroup's m64 tile i (tile wg + 3 i: taps 4 (wg +
// 3 i) .. + 3; tap 48 for the rows past the last)
__device__ __forceinline__ int dw1_tap(int wg, int i, int warp) {
  const int t = 4 * (wg + kWGS * i) + (warp & 3);
  return t < kTaps ? t : kTaps - 1;
}

template <typename T, int MT, int I0, int TILE0 = I0, int S>
__device__ __forceinline__ void dw1_products(float (&sum)[S][8], int wg,
                                             int warp, uint32_t xwin,
                                             int fwx, uint32_t bsm,
                                             int lane) {
  AFrag<T> f[2][MT];
  first_fragment<T, MT>(f, [&](int, int m, uint32_t (&dst)[4]) {
    dw1_fetch<T>(dst, xwin, fwx, 0, 0, dw1_tap(wg, TILE0 + m, warp), lane);
  });
  // a row a step (unrolling the chunk's rows spills)
#pragma unroll 1
  for (int r = 0; r < kRD; ++r)
    k_rows<T, MT, 1, 1, I0>(
        sum, f, r + 1 < kRD,
        [&](int) {
          return wgmma_desc_sw128(bsm + r * Elt<T>::PARTS * kBPart);
        },
        [&](int ks, int m, uint32_t (&dst)[4]) {
          dw1_fetch<T>(dst, xwin, fwx, r + (ks >> 2), ks & 3,
                       dw1_tap(wg, TILE0 + m, warp), lane);
        });
}

// xmap: the x window (swizzled), dmap: du1 (N, H, W, 16) in T. Writes the
// block's partial dw1 over its chunks, dwp[split] (2, 49, 16, 8) = [h][tap]
// [ci][c], 0 if it had none.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    head_dw1_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap dmap,
                    const DwGeo g, float* __restrict__ dwp) {
  constexpr int PARTS = Elt<T>::PARTS;
  const uint32_t sm = smem_base();
  const Ring ring{sm + g.bars, g.stages};
  const int c0 = blockIdx.x * g.per;
  const int c1 = c0 + g.per < g.chunks ? c0 + g.per : g.chunks;
  const int lane = threadIdx.x & 31;
  const int warp = warp_id();

  if (threadIdx.x == 0) {
    init_ring(ring);
    mbar_fence_init();
  }
  __syncthreads();
  if (warp >= kConsumers / 32) {
    setmaxnreg_dec<kProducerRegs>();
    if (warp == kConsumers / 32 && lane == 0) {
      tma_prefetch_map(&xmap);
      tma_prefetch_map(&dmap);
      for (int c = c0; c < c1; ++c) {
        const int i = c - c0;
        const int s = i % g.stages;
        mbar_wait(ring.empty(s), ((i / g.stages) & 1) ^ 1);
        mbar_arrive_expect_tx(ring.full(s), g.rawbytes + g.xbytes);
        const int n = c / (g.rbs * g.segs);
        const int rem = c - n * g.rbs * g.segs;
        const int y0 = (rem / g.segs) * kRD;
        const int x0 = (rem % g.segs) * g.cw;
        const uint32_t st = sm + s * g.stage;
        tma_load_4d(st, &dmap, ring.full(s), 0, x0, y0, n);
        tma_load_4d(st + rup(g.rawbytes, 1024), &xmap, ring.full(s), 0,
                    x0 - 3, y0 - 3, n);
      }
    }
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();

  // the warpgroup's m64 tiles wg, wg + 3, ... (wg 0: five, else four)
  // the warpgroup's tiles wg, wg + 3, ... (wg 0: five, else four); the
  // side sums of the first REG in registers, the others' in the thread's
  // shared slots (tile REG + j, entry e at slot + 4 kConsumers (8 j + e))
  constexpr int REG = dw_reg_tiles<T>();
  const int wg = warp >> 2;
  float sum[REG][8];
#pragma unroll
  for (int i = 0; i < REG; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) sum[i][e] = 0.f;
  const uint32_t slot = sm + g.slots + 4 * threadIdx.x;
#pragma unroll
  for (int e = 0; e < 8 * (kDwMT - REG); ++e)
    sts32(slot + 4 * kConsumers * e, 0u);
  const uint32_t bsm = sm + g.b;
  for (int c = c0; c < c1; ++c) {
    const int i = c - c0;
    const int s = i % g.stages;
    mbar_wait(ring.full(s), (i / g.stages) & 1);
    // B is free once every warpgroup's products on the last chunk are done
    named_barrier(1, kConsumers);
    // du1 (row, column, channel) into the rows' B tiles (row, part,
    // channel, 128-byte swizzled row of the columns)
    const uint32_t raw = sm + s * g.stage;
    for (int idx = threadIdx.x; idx < kRD * g.cw * kCin;
         idx += kConsumers) {
      const int ch = idx & (kCin - 1);
      const int col = (idx >> 4) % g.cw;
      const int r = idx / (kCin * g.cw);
      const int byte = col * (int)sizeof(T);
      const uint32_t tile = bsm + r * PARTS * kBPart + ch * kRow +
                            (((byte >> 4) ^ (ch & 7)) << 4) + (byte & 15);
      if constexpr (kF32<T>) {
        uint32_t big, small;
        split_tf32(__uint_as_float(lds32(raw + 4 * idx)), big, small);
        sts32(tile, big);
        sts32(tile + kBPart, small);
      } else {
        sts16(tile, lds16(raw + 2 * idx));
      }
    }
    fence_proxy_async();   // the tiles' writes, before wgmma reads them
    named_barrier(1, kConsumers);
    const uint32_t xwin = sm + s * g.stage + rup(g.rawbytes, 1024);
    // the register tiles: bf16 in pairs (two products in flight), f32 one
    // at a time (its three products a k-step; a pair's registers spilled)
    if constexpr (kF32<T>) {
      dw1_products<T, 1, 0>(sum, wg, warp, xwin, g.fwx, bsm, lane);
      dw1_products<T, 1, 1>(sum, wg, warp, xwin, g.fwx, bsm, lane);
      dw1_products<T, 1, 2>(sum, wg, warp, xwin, g.fwx, bsm, lane);
    } else {
      dw1_products<T, 2, 0>(sum, wg, warp, xwin, g.fwx, bsm, lane);
      dw1_products<T, 2, 2>(sum, wg, warp, xwin, g.fwx, bsm, lane);
    }
    // the shared-slot tiles (wg 0's fifth only in wg 0): the chunk's sum
    // added into the slots
#pragma unroll
    for (int j = 0; j < kDwMT - REG; ++j) {
      if (REG + j == kDwMT - 1 && wg != 0) break;
      float part[1][8];
#pragma unroll
      for (int e = 0; e < 8; ++e) part[0][e] = 0.f;
      if (j == 0) {
        dw1_products<T, 1, 0, REG>(part, wg, warp, xwin, g.fwx, bsm, lane);
      } else {
        dw1_products<T, 1, 0, kDwMT - 1>(part, wg, warp, xwin, g.fwx, bsm,
                                         lane);
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const uint32_t a = slot + 4 * kConsumers * (8 * j + e);
        sts32(a, __float_as_uint(__uint_as_float(lds32(a)) + part[0][e]));
      }
    }
    release(ring, s, lane);
  }

  // sum[i][4 j + 2 hh + c]: row rho = gl + 8 hh of the warp's tap, column
  // (h, c) = (j, 2 tig + c)
  const int gl = lane >> 2, tig = lane & 3;
  float* dwb = dwp + (size_t)blockIdx.x * kHeads * kW1;
#pragma unroll
  for (int i = 0; i < kDwMT; ++i) {
    const int t = 4 * (wg + kWGS * i) + (warp & 3);
    if (wg + kWGS * i >= kDwTiles || t >= kTaps) continue;
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v[e] = i < REG ? sum[i < REG ? i : 0][e]
                     : __uint_as_float(
                           lds32(slot + 4 * kConsumers * (8 * (i - REG) + e)));
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int ci = dw1_channel<T>(gl + 8 * hh);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        *reinterpret_cast<float2*>(dwb + j * kW1 + (t * kCin + ci) * kC1 +
                                   2 * tig) =
            make_float2(v[4 * j + 2 * hh], v[4 * j + 2 * hh + 1]);
    }
  }
}

// ------------------------------------------------------------------------ //
// The chains on the CUDA cores

constexpr int kChainThreads = 256;

// conv5 of 8 planar channels at a run of 4 outputs: acc[o] += sum over
// (ky, kx, c) of a[c][(ky) row][col + o + kx] w[ky][kx][c]; a points at the
// run's first input (tap (0, 0)), rows `stride` floats apart, planes
// `plane` floats apart, each row segment 16-byte aligned; ws the 200
// weights (ky, kx, c) in shared memory
__device__ __forceinline__ void conv5_run(float (&acc)[4], const float* a,
                                          int stride, int plane,
                                          const float* ws) {
#pragma unroll 1
  for (int ky = 0; ky < 5; ++ky) {
    float4 w[5][2];
#pragma unroll
    for (int kx = 0; kx < 5; ++kx) {
      w[kx][0] = *reinterpret_cast<const float4*>(ws + (ky * 5 + kx) * 8);
      w[kx][1] = *reinterpret_cast<const float4*>(ws + (ky * 5 + kx) * 8 + 4);
    }
#pragma unroll
    for (int c = 0; c < kC1; ++c) {
      const float4* seg =
          reinterpret_cast<const float4*>(a + c * plane + ky * stride);
      const float4 s0 = seg[0], s1 = seg[1];
      const float v[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
      for (int kx = 0; kx < 5; ++kx) {
        const float4& wv = w[kx][c >> 2];
        const float wc = (c & 3) == 0   ? wv.x
                         : (c & 3) == 1 ? wv.y
                         : (c & 3) == 2 ? wv.z
                                        : wv.w;
#pragma unroll
        for (int o = 0; o < 4; ++o) acc[o] = fmaf(v[o + kx], wc, acc[o]);
      }
    }
  }
}

// forward chain tile: 24 x 32 outputs; a1 on the tile + 3 (30 x 38, rows of
// 40 floats, planar), a2 on the tile + 1 (26 x 34 in rows of 36)
constexpr int kCFH = 24, kCFW = 32;
constexpr int kFA1W = 40, kFA1H = kCFH + 6;
constexpr int kFA1P = kFA1H * kFA1W + 4;   // 1204: a plane
constexpr int kFA2W = 36, kFA2H = kCFH + 2;
constexpr int kChainFwdFloats =
    kN1 * kFA1P + kHeads * kFA2H * kFA2W + kHeads * kW2 + kHeads * 9;

// u1 (N, H, W, 16) f32 -> y (N, 2, H, W) in T: a1 = PReLU(u1) rounded to
// T, 0 outside the image; a2 = PReLU(conv5(a1)) rounded, 0 outside; y =
// conv3(a2). One block a tile.
template <typename T>
__global__ void __launch_bounds__(kChainThreads)
    head_chain_fwd_kernel(const float* __restrict__ u1,
                          const float* __restrict__ w2,
                          const float* __restrict__ w3,
                          const float* __restrict__ alpha,
                          T* __restrict__ y, int H, int W) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* a1s = reinterpret_cast<float*>(smem_raw);       // [16][kFA1P]
  float* a2s = a1s + kN1 * kFA1P;                        // [2][26][36]
  float* w2s = a2s + kHeads * kFA2H * kFA2W;             // [2][200]
  float* w3s = w2s + kHeads * kW2;                       // [2][9]
  const int tid = threadIdx.x;
  const int tiles_x = cdiv(W, kCFW);
  const int tiles_y = cdiv(H, kCFH);
  const int n = blockIdx.x / (tiles_x * tiles_y);
  const int ty0 = (blockIdx.x / tiles_x) % tiles_y * kCFH;
  const int tx0 = blockIdx.x % tiles_x * kCFW;
  for (int i = tid; i < kHeads * kW2; i += kChainThreads) w2s[i] = w2[i];
  if (tid < kHeads * 9) w3s[tid] = w3[tid];
  const float al[4] = {__ldg(alpha), __ldg(alpha + 1), __ldg(alpha + 2),
                       __ldg(alpha + 3)};

  // a1 on the tile + 3, a pixel a thread (its 16 channels, 64 bytes); every
  // load of the thread's pixels issued before the first is used
  const float* u1n = u1 + (size_t)n * H * W * kN1;
  constexpr int kStageIt = cdiv(kFA1H * kFA1W, kChainThreads);
  float4 raw[kStageIt][4];
#pragma unroll
  for (int i = 0; i < kStageIt; ++i) {
    const int p = tid + i * kChainThreads;
    const int py = p / kFA1W, px = p % kFA1W;
    const int gy = ty0 - 3 + py, gx = tx0 - 3 + px;
    const bool in = p < kFA1H * kFA1W && px < kCFW + 6 &&
                    inside(gy, gx, H, W);
    const float4* s = reinterpret_cast<const float4*>(
        u1n + ((size_t)(in ? gy : 0) * W + (in ? gx : 0)) * kN1);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      raw[i][q] = in ? __ldg(s + q) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int i = 0; i < kStageIt; ++i) {
    const int p = tid + i * kChainThreads;
    if (p >= kFA1H * kFA1W) break;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float v[4] = {raw[i][q].x, raw[i][q].y, raw[i][q].z,
                          raw[i][q].w};
#pragma unroll
      for (int e = 0; e < 4; ++e)   // 0 outside the image: prelu(0) = 0
        a1s[(4 * q + e) * kFA1P + p] = rnd<T>(prelu(v[e], al[2 * (q >> 1)]));
    }
  }
  __syncthreads();

  // a2 on the tile + 1: (head, row, run of 4 columns)
  constexpr int kRuns = kFA2W / 4;
  for (int item = tid; item < kHeads * kFA2H * kRuns;
       item += kChainThreads) {
    const int h = item / (kFA2H * kRuns);
    const int py = (item / kRuns) % kFA2H;
    const int px = (item % kRuns) * 4;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    conv5_run(acc, a1s + h * kC1 * kFA1P + py * kFA1W + px, kFA1W, kFA1P,
              w2s + h * kW2);
#pragma unroll
    for (int o = 0; o < 4; ++o) {
      const bool in = inside(ty0 - 1 + py, tx0 - 1 + px + o, H, W);
      a2s[(h * kFA2H + py) * kFA2W + px + o] =
          in ? rnd<T>(prelu(acc[o], al[2 * h + 1])) : 0.f;
    }
  }
  __syncthreads();

  for (int p = tid; p < kHeads * kCFH * kCFW; p += kChainThreads) {
    const int h = p / (kCFH * kCFW);
    const int py = (p / kCFW) % kCFH;
    const int px = p % kCFW;
    const int gy = ty0 + py, gx = tx0 + px;
    if (gy >= H || gx >= W) continue;
    const float* a = a2s + (h * kFA2H + py) * kFA2W + px;
    float acc = 0.f;
#pragma unroll
    for (int ky = 0; ky < 3; ++ky)
#pragma unroll
      for (int kx = 0; kx < 3; ++kx)
        acc = fmaf(a[ky * kFA2W + kx], w3s[h * 9 + ky * 3 + kx], acc);
    T* d = y + (((size_t)n * kHeads + h) * H + gy) * W + gx;
    if constexpr (kF32<T>) {
      *d = acc;
    } else {
      *d = __float2bfloat16_rn(acc);
    }
  }
}

// backward chain tile: 16 x 32 owned pixels, one head at a time: a1 on the
// tile + 4 (24 x 40, planar), dy on the tile + 3 (22 x 38 in rows of 40),
// u2 and du2 on the tile + 2 (20 x 36)
constexpr int kCBH = 16, kCBW = 32;
constexpr int kBA1W = 40, kBA1H = kCBH + 8;
constexpr int kBA1P = kBA1H * kBA1W + 4;   // 964
constexpr int kBDYW = 40, kBDYH = kCBH + 6;
constexpr int kBU2W = 36, kBU2H = kCBH + 4;
constexpr int kChainBwdWarps = kChainThreads / 32;
constexpr int kChainBwdFloats =
    kC1 * kBA1P + kBDYH * kBDYW + 2 * kBU2H * kBU2W + kHeads * kW2 +
    kHeads * 9 + kChainBwdWarps * kHeads * kW2;
// the blocks of a backward chain launch, at most: two an SM
constexpr int kChainBwdPerSm = 2;

template <typename T>
__device__ __forceinline__ void store4(T* p, const float (&v)[4]);
template <>
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
template <>
__device__ __forceinline__ void store4(bf16* p, const float (&v)[4]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 w;
  w.x = *reinterpret_cast<uint32_t*>(&lo);
  w.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = w;
}

// u1 (N, H, W, 16) f32 as the forward kept it, dy (N, 2, H, W) in T ->
// du1 (N, H, W, 16) in T (rounded to T: the GEMMs' operand) and the
// block's partials dw2p (blocks, 2, 200), dw3p (blocks, 2, 9), dalp
// (blocks, 2, 2). Blocks walk the tiles with a grid stride.
template <typename T>
__global__ void __launch_bounds__(kChainThreads, kChainBwdPerSm)
    head_chain_bwd_kernel(const float* __restrict__ u1,
                          const T* __restrict__ dy,
                          const float* __restrict__ w2,
                          const float* __restrict__ w3,
                          const float* __restrict__ alpha,
                          T* __restrict__ du1, float* __restrict__ dw2p,
                          float* __restrict__ dw3p, float* __restrict__ dalp,
                          int N, int H, int W) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* a1s = reinterpret_cast<float*>(smem_raw);   // [8][kBA1P]
  float* dys = a1s + kC1 * kBA1P;                    // [22][40]
  float* u2s = dys + kBDYH * kBDYW;                  // [20][36]
  float* du2s = u2s + kBU2H * kBU2W;                 // [20][36]
  float* w2s = du2s + kBU2H * kBU2W;                 // [2][200]
  float* w3s = w2s + kHeads * kW2;                   // [2][9]
  float* dw2w = w3s + kHeads * 9;                    // [warp][2][25][8]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int i = tid; i < kHeads * kW2; i += kChainThreads) w2s[i] = w2[i];
  if (tid < kHeads * 9) w3s[tid] = w3[tid];
  for (int i = tid; i < kChainBwdWarps * kHeads * kW2; i += kChainThreads)
    dw2w[i] = 0.f;
  const float al[4] = {__ldg(alpha), __ldg(alpha + 1), __ldg(alpha + 2),
                       __ldg(alpha + 3)};
  // register partials: dw3[tid % 9] over tile row tid / 9, dalpha of every
  // thread's own pixels
  float dw3r[kHeads] = {0.f, 0.f};
  float dal1r[kHeads] = {0.f, 0.f};
  float dal2r[kHeads] = {0.f, 0.f};
  const int tiles_x = cdiv(W, kCBW);
  const int tiles_y = cdiv(H, kCBH);
  const int tiles = N * tiles_x * tiles_y;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int n = t / (tiles_x * tiles_y);
    const int ty0 = (t / tiles_x) % tiles_y * kCBH;
    const int tx0 = t % tiles_x * kCBW;
    const float* u1n = u1 + (size_t)n * H * W * kN1;
#pragma unroll 1
    for (int h = 0; h < kHeads; ++h) {
      const float al1 = al[2 * h], al2 = al[2 * h + 1];
      const float* w2h = w2s + h * kW2;
      float dal1 = 0.f, dal2 = 0.f;
      __syncthreads();   // the previous head's readers are done
      // a1 of the head on the tile + 4, dy on the tile + 3; every load of
      // the thread's pixels issued before the first is used
      constexpr int kA1It = cdiv(kBA1H * kBA1W, kChainThreads);
      constexpr int kDyIt = cdiv(kBDYH * kBDYW, kChainThreads);
      float4 raw[kA1It][2];
      float dyv[kDyIt];
#pragma unroll
      for (int i = 0; i < kA1It; ++i) {
        const int p = tid + i * kChainThreads;
        const int gy = ty0 - 4 + p / kBA1W, gx = tx0 - 4 + p % kBA1W;
        const bool in = p < kBA1H * kBA1W && inside(gy, gx, H, W);
        const float4* s = reinterpret_cast<const float4*>(
            u1n + ((size_t)(in ? gy : 0) * W + (in ? gx : 0)) * kN1 +
            kC1 * h);
        raw[i][0] = in ? __ldg(s) : make_float4(0.f, 0.f, 0.f, 0.f);
        raw[i][1] = in ? __ldg(s + 1) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int i = 0; i < kDyIt; ++i) {
        const int p = tid + i * kChainThreads;
        const int px = p % kBDYW;
        const int gy = ty0 - 3 + p / kBDYW, gx = tx0 - 3 + px;
        const bool in = p < kBDYH * kBDYW && px < kCBW + 6 &&
                        inside(gy, gx, H, W);
        dyv[i] = in ? to_f32(dy[(((size_t)n * kHeads + h) * H + gy) * W + gx])
                    : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kA1It; ++i) {
        const int p = tid + i * kChainThreads;
        if (p >= kBA1H * kBA1W) break;
        const float u[kC1] = {raw[i][0].x, raw[i][0].y, raw[i][0].z,
                              raw[i][0].w, raw[i][1].x, raw[i][1].y,
                              raw[i][1].z, raw[i][1].w};
#pragma unroll
        for (int c = 0; c < kC1; ++c)   // 0 outside the image
          a1s[c * kBA1P + p] = rnd<T>(prelu(u[c], al1));
      }
#pragma unroll
      for (int i = 0; i < kDyIt; ++i) {
        const int p = tid + i * kChainThreads;
        if (p < kBDYH * kBDYW) dys[p] = dyv[i];
      }
      __syncthreads();

      // u2 on the tile + 2, 0 outside the image: (row, run of 4)
      constexpr int kRuns2 = kBU2W / 4;
      for (int item = tid; item < kBU2H * kRuns2; item += kChainThreads) {
        const int py = item / kRuns2, px = (item % kRuns2) * 4;
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        conv5_run(acc, a1s + py * kBA1W + px, kBA1W, kBA1P, w2h);
#pragma unroll
        for (int o = 0; o < 4; ++o)
          u2s[py * kBU2W + px + o] =
              inside(ty0 - 2 + py, tx0 - 2 + px + o, H, W) ? acc[o] : 0.f;
      }
      __syncthreads();

      // du2 on the tile + 2 from dy through conv3 (rounded to T: dw2's and
      // conv5's adjoint's operand); dalpha2 over the owned pixels; dw3 over
      // tile row tid / 9
      for (int p = tid; p < kBU2H * kBU2W; p += kChainThreads) {
        const int py = p / kBU2W, px = p % kBU2W;
        float dv = 0.f;
#pragma unroll
        for (int ky = 0; ky < 3; ++ky)
#pragma unroll
          for (int kx = 0; kx < 3; ++kx)
            dv = fmaf(w3s[h * 9 + ky * 3 + kx],
                      dys[(py + 2 - ky) * kBDYW + px + 2 - kx], dv);
        const float u = u2s[p];
        const bool in = inside(ty0 - 2 + py, tx0 - 2 + px, H, W);
        du2s[p] = in ? rnd<T>(u >= 0.f ? dv : al2 * dv) : 0.f;
        const bool owned = py >= 2 && py < 2 + kCBH && px >= 2 &&
                           px < 2 + kCBW;
        if (in && owned && u < 0.f) dal2 = fmaf(dv, u, dal2);
      }
      if (tid < 9 * kCBH) {
        const int k = tid % 9, r = tid / 9;
        const int ky = k / 3, kx = k % 3;
        float s = 0.f;
        for (int c = 0; c < kCBW; ++c)
          s = fmaf(dys[(r + 3) * kBDYW + c + 3],
                   rnd<T>(prelu(u2s[(r + 1 + ky) * kBU2W + c + 1 + kx], al2)),
                   s);
        add_to_head(dw3r, h, s);
      }
      __syncthreads();

      // du1 at the owned pixels: (row, run of 4 columns, half of the
      // channels); dalpha1
      {
        const int r = tid >> 4;
        const int px = ((tid >> 1) & 7) * 4;
        const int c0 = (tid & 1) * 4;
        float acc[4][4];
#pragma unroll
        for (int o = 0; o < 4; ++o)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[o][c] = 0.f;
#pragma unroll 1
        for (int ky = 0; ky < 5; ++ky) {
          // du2 at (r + 4 - ky, px + o + 4 - kx): the segment px .. px + 7
          const float4* seg = reinterpret_cast<const float4*>(
              du2s + (r + 4 - ky) * kBU2W + px);
          const float4 s0 = seg[0], s1 = seg[1];
          const float v[8] = {s0.x, s0.y, s0.z, s0.w,
                              s1.x, s1.y, s1.z, s1.w};
#pragma unroll
          for (int kx = 0; kx < 5; ++kx) {
            const float4 wv = *reinterpret_cast<const float4*>(
                w2h + (ky * 5 + kx) * kC1 + c0);
            const float wc[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
            for (int o = 0; o < 4; ++o)
#pragma unroll
              for (int c = 0; c < 4; ++c)
                acc[o][c] = fmaf(v[o + 4 - kx], wc[c], acc[o][c]);
          }
        }
        const int gy = ty0 + r;
#pragma unroll
        for (int o = 0; o < 4; ++o) {
          const int gx = tx0 + px + o;
          if (!inside(gy, gx, H, W)) continue;
          const size_t pix = ((size_t)n * H + gy) * W + gx;
          const float4 uv = __ldg(reinterpret_cast<const float4*>(
              u1 + pix * kN1 + kC1 * h + c0));
          const float u[4] = {uv.x, uv.y, uv.z, uv.w};
          float d[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            d[c] = rnd<T>(u[c] >= 0.f ? acc[o][c] : al1 * acc[o][c]);
            if (u[c] < 0.f) dal1 = fmaf(acc[o][c], u[c], dal1);
          }
          store4(du1 + pix * kN1 + kC1 * h + c0, d);
        }
      }

      // dw2[ky][kx][c] over the owned pixels: channel c = tid % 8 over runs
      // of 4 pixels; the 25 sums a thread, then the warp's lanes of a
      // channel (xor 8, 16) into the warp's slot
      {
        const int c = tid & 7;
        float acc[25];
#pragma unroll
        for (int k = 0; k < 25; ++k) acc[k] = 0.f;
#pragma unroll 1
        for (int run = tid >> 3; run < kCBH * (kCBW / 4); run += 32) {
          const int r = run / (kCBW / 4);
          const int px = (run % (kCBW / 4)) * 4;
          const float2* dp = reinterpret_cast<const float2*>(
              du2s + (r + 2) * kBU2W + px + 2);
          const float2 d0 = dp[0], d1 = dp[1];
          const float d[4] = {d0.x, d0.y, d1.x, d1.y};
#pragma unroll
          for (int ky = 0; ky < 5; ++ky) {
            // a1 at (r + 2 + ky, px + 2 + o + kx): the segment px + 2 ..
            // px + 9 of the tile + 4
            const float2* ap = reinterpret_cast<const float2*>(
                a1s + c * kBA1P + (r + 2 + ky) * kBA1W + px + 2);
            const float2 e0 = ap[0], e1 = ap[1], e2 = ap[2], e3 = ap[3];
            const float a[8] = {e0.x, e0.y, e1.x, e1.y,
                                e2.x, e2.y, e3.x, e3.y};
#pragma unroll
            for (int kx = 0; kx < 5; ++kx)
#pragma unroll
              for (int o = 0; o < 4; ++o)
                acc[ky * 5 + kx] = fmaf(d[o], a[o + kx], acc[ky * 5 + kx]);
          }
        }
#pragma unroll
        for (int k = 0; k < 25; ++k) {
          float v = acc[k];
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (lane < 8) dw2w[(warp * kHeads + h) * kW2 + k * kC1 + c] += v;
        }
      }
      add_to_head(dal1r, h, dal1);
      add_to_head(dal2r, h, dal2);
    }
  }

  // the block's partials, each summed in a fixed order
  __syncthreads();
  for (int i = tid; i < kHeads * kW2; i += kChainThreads) {
    float s = 0.f;
    for (int wp = 0; wp < kChainBwdWarps; ++wp) s += dw2w[wp * kHeads * kW2 + i];
    dw2p[(size_t)blockIdx.x * kHeads * kW2 + i] = s;
  }
  float* red = a1s;   // [2][9 x 16] dw3 rows, then [4][256] dalpha
  if (tid < 9 * kCBH)
    for (int h = 0; h < kHeads; ++h) red[h * 9 * kCBH + tid] = dw3r[h];
  for (int h = 0; h < kHeads; ++h) {
    red[2 * 9 * kCBH + (h * 2 + 0) * kChainThreads + tid] = dal1r[h];
    red[2 * 9 * kCBH + (h * 2 + 1) * kChainThreads + tid] = dal2r[h];
  }
  __syncthreads();
  if (tid < kHeads * 9) {
    const int h = tid / 9, k = tid % 9;
    float s = 0.f;
    for (int r = 0; r < kCBH; ++r) s += red[h * 9 * kCBH + r * 9 + k];
    dw3p[(size_t)blockIdx.x * kHeads * 9 + tid] = s;
  } else if (tid >= 32 && tid < 32 + 2 * kHeads) {
    const int hj = tid - 32;
    float s = 0.f;
    for (int i = 0; i < kChainThreads; ++i)
      s += red[2 * 9 * kCBH + hj * kChainThreads + i];
    dalp[(size_t)blockIdx.x * kHeads * 2 + hj] = s;
  }
}

// ------------------------------------------------------------------------ //
// Launches

// A 4-d tensor map of a contiguous tensor (dims innermost first, elements),
// out-of-bounds reads zero
template <typename T>
bool encode(CUtensorMap* map, const void* ptr, const cuuint64_t (&dims)[4],
            const cuuint32_t (&box)[4], CUtensorMapSwizzle swizzle) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t strides[3] = {dims[0] * sizeof(T),
                                 dims[0] * dims[1] * sizeof(T),
                                 dims[0] * dims[1] * dims[2] * sizeof(T)};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, Elt<T>::TMA, 4, const_cast<void*>(ptr), dims, strides, box,
             unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// an (N, H, W, 16) tensor's map with the pixel GEMMs' or dw1's box
template <typename T>
bool pixel_map(CUtensorMap* map, const void* ptr, int n, int h, int w,
               int bw, int bh, bool swizzle) {
  return encode<T>(map, ptr,
                   {(cuuint64_t)kCin, (cuuint64_t)w, (cuuint64_t)h,
                    (cuuint64_t)n},
                   {(cuuint32_t)kCin, (cuuint32_t)bw, (cuuint32_t)bh, 1},
                   swizzle ? Elt<T>::SWZ : CU_TENSOR_MAP_SWIZZLE_NONE);
}

bool dims_ok(int n, int h, int w) {
  return n > 0 && h > 0 && w > 0 &&
         (long long)n * cdiv(h, gemm_tr<float>()) * cdiv(w, kTW) <=
             0x7fffffffLL &&
         (long long)n * cdiv(h, kCFH) * cdiv(w, kCFW) <= 0x7fffffffLL;
}

// blocks of a u1 or dx launch: persistent, at most one an SM
template <typename T>
int gemm_grid(int n, int h, int w) {
  const int tiles = n * cdiv(h, gemm_tr<T>()) * cdiv(w, kTW);
  return tiles < sm_count() ? tiles : sm_count();
}

// blocks of a forward chain launch: one a tile
int chain_fwd_blocks(int n, int h, int w) {
  return n * cdiv(h, kCFH) * cdiv(w, kCFW);
}

template <typename T, int KIND>
int launch_gemm(const void* a, const void* wk, void* out, int n, int h,
                int w, cudaStream_t strm) {
  if (!dims_ok(n, h, w)) return (int)cudaErrorInvalidValue;
  const GemmGeo g = gemm_geo<T, KIND>();
  CUtensorMap amap, wmap;
  if (g.bytes == 0 ||
      !pixel_map<T>(&amap, a, n, h, w, kFW, gemm_tr<T>() + 6, true) ||
      !encode<T>(&wmap, wk,
                 {(cuuint64_t)g.rows * Elt<T>::KCH, (cuuint64_t)kN1,
                  (cuuint64_t)Elt<T>::PARTS, 1},
                 {(cuuint32_t)Elt<T>::KCH, (cuuint32_t)kN1,
                  (cuuint32_t)Elt<T>::PARTS, 1},
                 CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      head_gemm_kernel<T, KIND>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      g.bytes);
  if (err != cudaSuccess) return (int)err;
  const int grid = gemm_grid<T>(n, h, w);
  head_gemm_kernel<T, KIND><<<grid, kThreads, g.bytes, strm>>>(
      amap, wmap, g, n, h, w, out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dw1(const void* x, const void* du1, void* dwp, int n, int h,
               int w, int nsplit, cudaStream_t strm) {
  if (!dims_ok(n, h, w)) return (int)cudaErrorInvalidValue;
  const DwGeo g = dw_geo<T>(n, h, w, sm_count());
  CUtensorMap xmap, dmap;
  if (g.bytes == 0 || g.chunks == 0 || g.splits != nsplit ||
      !pixel_map<T>(&xmap, x, n, h, w, g.fwx, kRD + 6, true) ||
      !pixel_map<T>(&dmap, du1, n, h, w, g.cw, kRD, false))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      head_dw1_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      g.bytes);
  if (err != cudaSuccess) return (int)err;
  head_dw1_kernel<T><<<g.splits, kThreads, g.bytes, strm>>>(
      xmap, dmap, g, static_cast<float*>(dwp));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_chain_fwd(const void* u1, const void* w2, const void* w3,
                     const void* alpha, void* y, int n, int h, int w,
                     cudaStream_t strm) {
  if (!dims_ok(n, h, w)) return (int)cudaErrorInvalidValue;
  const int bytes = kChainFwdFloats * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      head_chain_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  head_chain_fwd_kernel<T><<<chain_fwd_blocks(n, h, w), kChainThreads,
                             bytes, strm>>>(
      static_cast<const float*>(u1), static_cast<const float*>(w2),
      static_cast<const float*>(w3), static_cast<const float*>(alpha),
      static_cast<T*>(y), h, w);
  return (int)cudaGetLastError();
}

int chain_bwd_blocks(int n, int h, int w) {
  const long long tiles = (long long)n * cdiv(h, kCBH) * cdiv(w, kCBW);
  const long long most = (long long)kChainBwdPerSm * sm_count();
  return (int)(tiles < most ? tiles : most);
}

template <typename T>
int launch_chain_bwd(const void* u1, const void* dy, const void* w2,
                     const void* w3, const void* alpha, void* du1,
                     void* dw2p, void* dw3p, void* dalp, int n, int h, int w,
                     int nblocks, cudaStream_t strm) {
  if (!dims_ok(n, h, w) || nblocks != chain_bwd_blocks(n, h, w))
    return (int)cudaErrorInvalidValue;
  const int bytes = kChainBwdFloats * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      head_chain_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  head_chain_bwd_kernel<T><<<nblocks, kChainThreads, bytes, strm>>>(
      static_cast<const float*>(u1), static_cast<const T*>(dy),
      static_cast<const float*>(w2), static_cast<const float*>(w3),
      static_cast<const float*>(alpha), static_cast<T*>(du1),
      static_cast<float*>(dw2p), static_cast<float*>(dw3p),
      static_cast<float*>(dalp), n, h, w);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K3-fwd's first launch, the u1 GEMM: x (N, H, W, 16) in float32 (dtype 0)
// or bfloat16 (dtype 1), wu B (PARTS, 16, rows x KCH) = [h, c][ky, kx, ci]
// in x's dtype (f32: big and small parts), u1 (N, H, W, 16) f32. Returns
// the cudaError_t of the launch (0 on success); asynchronous on `stream`.
int bpt_head_u1_gemm(const void* x, const void* wu, void* u1, int n, int h,
                     int w, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_gemm<float, 0>(x, wu, u1, n, h, w, s);
  if (dtype == 1) return launch_gemm<bf16, 0>(x, wu, u1, n, h, w, s);
  return (int)cudaErrorInvalidValue;
}

// K3-fwd's second launch, the chain: u1 as bpt_head_u1_gemm writes it, w2
// (2, 5, 5, 8) and w3 (2, 3, 3) rounded to the dtype, alpha (2, 2), all
// f32; y (N, 2, H, W) in the dtype.
int bpt_head_chain_fwd(const void* u1, const void* w2, const void* w3,
                       const void* alpha, void* y, int n, int h, int w,
                       int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_chain_fwd<float>(u1, w2, w3, alpha, y, n, h, w, s);
  if (dtype == 1)
    return launch_chain_fwd<bf16>(u1, w2, w3, alpha, y, n, h, w, s);
  return (int)cudaErrorInvalidValue;
}

// K3-bwd's first launch, the chain: u1 (f32) as K3-fwd keeps it, dy (N, 2,
// H, W) in the dtype, w2, w3, alpha as above; writes du1 (N, H, W, 16) in
// the dtype and the f32 partials of its nblocks = bpt_head_grid(2, ...)
// blocks: dw2p (B, 2, 5, 5, 8), dw3p (B, 2, 3, 3), dalp (B, 2, 2).
int bpt_head_chain_bwd(const void* u1, const void* dy, const void* w2,
                       const void* w3, const void* alpha, void* du1,
                       void* dw2p, void* dw3p, void* dalp, int n, int h,
                       int w, int nblocks, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_chain_bwd<float>(u1, dy, w2, w3, alpha, du1, dw2p, dw3p,
                                   dalp, n, h, w, nblocks, s);
  if (dtype == 1)
    return launch_chain_bwd<bf16>(u1, dy, w2, w3, alpha, du1, dw2p, dw3p,
                                  dalp, n, h, w, nblocks, s);
  return (int)cudaErrorInvalidValue;
}

// K3-bwd's second launch, dx: du1 as bpt_head_chain_bwd writes it, wdx B
// (PARTS, 16, rows x KCH) = [ci][h][ky, kx, c] (each head's K padded to
// whole rows) in the dtype; dx (N, H, W, 16) in the dtype.
int bpt_head_dx(const void* du1, const void* wdx, void* dx, int n, int h,
                int w, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_gemm<float, 1>(du1, wdx, dx, n, h, w, s);
  if (dtype == 1) return launch_gemm<bf16, 1>(du1, wdx, dx, n, h, w, s);
  return (int)cudaErrorInvalidValue;
}

// K3-bwd's third launch, dw1: x and du1 (N, H, W, 16) in the dtype; writes
// the f32 partials dw1p (nsplit, 2, 7, 7, 16, 8), nsplit =
// bpt_head_grid(4, ...).
int bpt_head_dw1(const void* x, const void* du1, void* dw1p, int n, int h,
                 int w, int nsplit, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_dw1<float>(x, du1, dw1p, n, h, w, nsplit, s);
  if (dtype == 1) return launch_dw1<bf16>(x, du1, dw1p, n, h, w, nsplit, s);
  return (int)cudaErrorInvalidValue;
}

// Blocks of a launch of K3's pass `which` at (n, h, w), float32 (dtype 0)
// or bfloat16 (dtype 1): 0 the u1 GEMM, 1 the forward chain, 2 the backward
// chain (its partials of dw2, dw3, dalpha), 3 dx, 4 dw1 (its splits, each a
// partial of dw1); -1 for a pass, dtype or shape it does not take.
int bpt_head_grid(int which, int n, int h, int w, int dtype) {
  if (!dims_ok(n, h, w) || dtype < 0 || dtype > 1) return -1;
  const bool f = dtype == 0;
  switch (which) {
    case 0:
    case 3:
      return f ? gemm_grid<float>(n, h, w) : gemm_grid<bf16>(n, h, w);
    case 1: return chain_fwd_blocks(n, h, w);
    case 2: return chain_bwd_blocks(n, h, w);
    case 4: {
      const DwGeo g = f ? dw_geo<float>(n, h, w, sm_count())
                        : dw_geo<bf16>(n, h, w, sm_count());
      return g.bytes == 0 || g.chunks == 0 ? -1 : g.splits;
    }
    default: return -1;
  }
}

// Shared memory per block of K3's launches (bytes): which 0 the u1 GEMM, 1
// the forward chain, 2 the backward chain, 3 dx, 4 dw1; float32 (dtype 0)
// or bfloat16 (dtype 1); -1 for another.
int bpt_head_stack_smem(int which, int dtype) {
  if (dtype < 0 || dtype > 1) return -1;
  const bool f = dtype == 0;
  switch (which) {
    case 0: return f ? gemm_geo<float, 0>().bytes : gemm_geo<bf16, 0>().bytes;
    case 1: return kChainFwdFloats * (int)sizeof(float);
    case 2: return kChainBwdFloats * (int)sizeof(float);
    case 3: return f ? gemm_geo<float, 1>().bytes : gemm_geo<bf16, 1>().bytes;
    case 4:
      return f ? dw_geo<float>(1, 64, 64, 132).bytes
               : dw_geo<bf16>(1, 64, 64, 132).bytes;
    default: return -1;
  }
}

}  // extern "C"
