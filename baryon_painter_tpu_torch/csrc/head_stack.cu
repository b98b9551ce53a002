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
// x is NHWC (N, H, W, 16) f32, w1 (2, 7, 7, 16, 8), w2 (2, 5, 5, 8) and w3
// (2, 3, 3) HWIO, alpha (2, 2), y (N, 2, H, W); all sums in f32. Each conv's
// zero padding applies to its own input, so a1 and a2 are 0 outside the
// image: they are never computed from padded data.
//
// In a training step the forward keeps u1 for the backward: u1 (N, H, W, 16)
// f32, channel 8 h + c, conv7's pre-activation at every pixel of the image
// (402.7 MB at (24, 512, 512)). Painting keeps none: the launch passes no
// u1. The backward takes dy (N, 2, H, W), x and that u1 and returns dx (both
// heads summed) and per-block partial sums of dw1, dw2, dw3 and dalpha,
// which the wrapper sums in torch: every block writes its own partials and
// no atomics are used, so the result is deterministic. PReLU1's mask comes
// from the kept u1; u2 is recomputed from it.
//
// What bounds them: arithmetic. The forward does 12,962 operations per pixel
// and head (the 7x7 conv is 12,544 of them): 163 GFLOP at (24, 512, 512);
// with the 7x7 conv as 3xTF32 on the tensor cores (495/3 TFLOP/s) and the
// rest on the CUDA cores (67 TFLOP/s) >= 1.04 ms, against 0.86 GB of traffic
// (x read, y and u1 written). The backward does two 7x7 products per pixel
// and head (dx, dw1): 316 GFLOP, >= 1.91 ms as 3xTF32, and 15.6 GFLOP of
// small convs on the CUDA cores (0.23 ms).
//
// The 7x7 convs are implicit GEMMs with the two heads stacked (N = 16) on
// the tensor cores in 3xTF32 (mma.sync m16n8k8; each f32 operand split into
// a tf32 big and small = v - big, split_tf32 in ptx.cuh; small*big +
// big*small + big*big accumulated in f32):
//   u1 (forward): M = the tile + 3 (22 x 22 pixels, where conv5 reads a1),
//        N = 2 heads x 8, K = 7 x 7 x 16 = 784
//   dx:  M = the tile's 256 pixels, N = 16, K = 7 x 7 x (2 heads x 8): the
//        transposed conv of du1, the heads' sum inside the GEMM
//   dw1: du1^T x, M = 16 (h, c), N = 7 x 7 x 16, K = the tile's pixels
// The tensor cores' accumulators truncate, so each K chunk (a row of 7 taps
// for u1 and dx, a tile for dw1) sums from zero and is added in f32.
//
// Forward: a block stages wu (16 x 784, w1 as [h, c][ky, kx, ci]) once in
// shared memory and walks 16 x 16 output tiles (grid stride over (sample,
// tile row, tile)); two blocks an SM. With N = 16 each x value serves only
// 6 MMAs, so the loop is bound by loading and splitting x: per tile x on the
// tile + 6 (28 x 28) is staged in pair planes, plane (hf, t) holding
// channels 8 hf + t and 8 hf + t + 4 of a pixel side by side, so the two
// values of a thread's A fragment row (k = tig, tig + 4) are one 64-bit
// load; rows lie kFXS = 30 pixels apart, so any 4 consecutive GEMM rows
// differ mod 4 and a half-warp's 16 loads hit 32 banks. The weights are
// permuted the same way in each 8-wide k group (one 64-bit load a B
// fragment). x is split in registers as it is loaded: staged already split
// it would double the shared-memory traffic of the loop. Each warp owns 4
// m16 tiles of the 484 rows (31 hold pixels). u1 leaves the GEMM in
// registers: a kept u1 is stored for the tile's own pixels (each pixel once),
// and PReLU makes a1 (0 outside the image), written over the staged x; then
// per head on the CUDA cores conv5 (a2 on the tile + 1) and conv3. Only y
// and u1 go to device memory. The halo (22^2 / 16^2 = 1.89x the owned
// pixels) is recomputed by the neighbouring tiles.
//
// Backward: one block per run of up to 16 tiles of a tile row; two blocks
// an SM (the CUDA-core chain and dw1 are bound by latency, and a second
// block hides it). Per tile and head: the head's u1 on the tile + 7 (30 x
// 30) is staged from the kept u1 with cp.async (planar, 0 outside the
// image); on the CUDA cores u2 (tile + 5), du2 with dalpha2 and dw3, du1
// (tile + 3, planar) with dalpha1 and dw2. Then dx, whose weights (wdx, 16
// x 784, laid out by the wrapper) stream through a 4-stage cp.async ring of
// 7 chunks; then x on the tile + 3 (22 x 22, planar) is staged over the
// ring, and dw1. A block's dw1 partial lives in its slot of the partials in
// device memory (each entry read and written by one thread); dw2, dw3 and
// dalpha in registers.
//
// bf16 (the JAX package's default compute dtype): x, y, dy, dx and the 7x7
// GEMMs' weights are bfloat16; u1, w2, w3 (rounded to bf16 by the wrapper),
// alpha and every weight and slope gradient stay f32. The kernels round
// where the JAX kernels round (pallas_head_stack.py _chain_fwd, _bwd_kernel):
// a1 and a2 are rounded to bf16 before the conv that reads them, y is
// stored in bf16; in the backward du2 and du1 are rounded before the
// products that read them (with a1, a2 for dw2, dw3), PReLU's masks and
// dalpha come from the f32 u1 and u2, and dx is each head's sum rounded to
// bf16, the two added and rounded again (the heads are summed in bf16).
// The 7x7 GEMMs run in one pass of mma.sync m16n8k16 bf16 with f32
// accumulation (the products of two bf16 values are exact in f32), a k16
// step one tap's 16 channels:
//   u1: x staged as 8 planes of channel pairs (32-bit words, the pair
//       (2q, 2q + 1) in plane q, rows kFXS = 30 pixels apart), so a
//       fragment register is one load; weights [n][k] bf16, rows 396 words
//       apart (12 mod 32)
//   dx: du1 staged twice, here as 8 planes of (h, c) pairs over the tile
//       + 3; the k16 step is a tap's 16 (h, c), head 0 in the fragment's
//       registers a0, a1 and head 1 in a2, a3, so each head's sum is its own
//       MMA (the other head's registers zero) and is rounded before the
//       heads are added; the whole wdx (16 x 784 bf16) is staged once a
//       block
//   dw1: du1^T x with K = a tile row's 16 pixels per k16 step: du1's second
//       copy is 16 planar (h, c) planes, x two planar copies (one shifted by
//       a pixel), so that every pixel pair a fragment register holds starts
//       at an even element of one of them
// At (24, 512, 512) the bounds are 0.24 ms forward (the 7x7 products on
// the bf16 tensor cores, 989 TFLOP/s, 0.16 ms, plus the rest on the CUDA
// cores; 0.63 GB of x, y and the f32 u1) and 0.55 ms backward.
//
// Plain C interface, no PyTorch header: built with nvcc into a shared
// library and called through ctypes (baryon_painter_tpu_torch/ops/_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "ptx.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kCin = 16;   // head input channels
constexpr int kC1 = 8;     // conv7 output channels
constexpr int kHeads = 2;
constexpr int kN1 = kHeads * kC1;  // 16: both heads' conv7 channels
constexpr int kT = 16;     // output tile edge
constexpr int kThreads = 256;
constexpr int kW1 = 7 * 7 * kCin * kC1;   // w1 entries per head (6272)
constexpr int kW2 = 5 * 5 * kC1;          // w2 entries per head (200)
constexpr int kK1 = 7 * 7 * kCin;         // 784: K of the 7x7 GEMMs
// K chunk of the u1 and dx GEMMs: one row of 7 taps x 16 channels
constexpr int kKC = 7 * kCin;    // 112

// forward regions: x on tile + 6, a1 (the GEMM's rows) on tile + 3, a2 on
// tile + 1
constexpr int kFX = kT + 12;    // 28
constexpr int kFXS = kFX + 2;   // 30: row stride of x in a pair plane
constexpr int kFA1 = kT + 6;    // 22
constexpr int kFA2 = kT + 2;    // 18
constexpr int kFM = kFA1 * kFA1;       // 484 GEMM rows, also a1's planes
// pixels of a pair plane: 2 kFPP = 24 mod 32, so the 4 planes of tig
// start 0, 24, 16 and 8 banks apart
constexpr int kFPP = kFX * kFXS + 4;   // 844
constexpr int kFMT = 4;                // m16 tiles a warp
constexpr int kLDWF = kK1 + 8;         // 792 = 24 mod 32: the weights' rows
// bf16: words of a channel-pair plane, 840 = 8 mod 32, so the planes of
// tig = 0..3 start 0, 8, 16 and 24 banks apart
constexpr int kFPB = kFX * kFXS;       // 840
// floats of shared memory of the forward for element type T: x (over which
// a1 is written), the weights, a2
template <typename T>
__host__ __device__ constexpr int fwd_x_floats() {
  return std::is_same<T, float>::value ? 8 * kFPP * 2 : 8 * kFPB;
}
template <typename T>
__host__ __device__ constexpr int fwd_xa_floats() {  // x and a1, which is written over it
  return fwd_x_floats<T>() > kN1 * kFM ? fwd_x_floats<T>() : kN1 * kFM;
}
template <typename T>
__host__ __device__ constexpr int fwd_smem_floats() {
  return fwd_xa_floats<T>() + kN1 * kLDWF * (int)sizeof(T) / 4 +
         kHeads * kFA2 * kFA2;
}
static_assert(kN1 * kFM <= 8 * kFPP * 2, "a1 fits over the staged x");
static_assert(8 * kFMT * 16 >= kFM, "the warps' m16 tiles hold the rows");

__device__ __forceinline__ float prelu(float u, float a) {
  return u >= 0.f ? u : a * u;
}

// v rounded to T, held as f32 (the identity for f32); to nearest even, as
// a cast to bfloat16 rounds in JAX and PyTorch
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  if constexpr (std::is_same<T, float>::value) {
    return v;
  } else {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v) {
  if constexpr (std::is_same<T, float>::value) {
    return v;
  } else {
    return __float2bfloat16_rn(v);
  }
}

// a 32-bit word of shared memory holding two bf16 values
__device__ __forceinline__ uint32_t word(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

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

// Stage x[n] on the square region of edge `edge` whose corner is (y0, x0)
// into planar shared memory xs[c][plane] (plane >= edge * edge floats a
// channel, row-major edge x edge); 0 outside the image.
__device__ __forceinline__ void stage_x(const float* __restrict__ xn,
                                        float* xs, int edge, int plane,
                                        int y0, int x0, int H, int W) {
  for (int i = threadIdx.x; i < edge * edge * (kCin / 4); i += kThreads) {
    const int q = i % (kCin / 4);
    const int p = i / (kCin / 4);
    const int gy = y0 + p / edge;
    const int gx = x0 + p % edge;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (inside(gy, gx, H, W))
      v = __ldg(reinterpret_cast<const float4*>(xn + ((size_t)gy * W + gx) *
                                                         kCin) + q);
    xs[(4 * q + 0) * plane + p] = v.x;
    xs[(4 * q + 1) * plane + p] = v.y;
    xs[(4 * q + 2) * plane + p] = v.z;
    xs[(4 * q + 3) * plane + p] = v.w;
  }
}

// ------------------------------------------------------------------------ //
// K3-fwd: the 7x7 convolution as an implicit GEMM on the tensor cores

// f32: the weights once a block, k = 8 grp + r at 8 grp + 2 (r % 4) + r / 4,
// so a thread's B pair (k = tig, tig + 4) is adjacent
__device__ __forceinline__ void fwd_stage_weights(float* ws,
                                                  const float* __restrict__ wu) {
  for (int i = threadIdx.x; i < kN1 * kK1; i += kThreads) {
    const int nn = i / kK1;
    const int k = i - nn * kK1;
    const int r = k & 7;
    ws[nn * kLDWF + (k - r) + 2 * (r & 3) + (r >> 2)] = __ldg(wu + i);
  }
}

// bf16: the weights once a block as they are ([n][k], rows kLDWF apart):
// a thread's B register (k = 2 tig, 2 tig + 1) is one word
__device__ __forceinline__ void fwd_stage_weights(bf16* ws,
                                                  const bf16* __restrict__ wu) {
  constexpr int Q = kK1 / 8;  // 16-byte pieces of a row
  for (int i = threadIdx.x; i < kN1 * Q; i += kThreads) {
    const int nn = i / Q;
    const int q = i - nn * Q;
    *reinterpret_cast<uint4*>(ws + nn * kLDWF + 8 * q) =
        __ldg(reinterpret_cast<const uint4*>(wu + nn * kK1) + q);
  }
}

// f32: x on tile + 6 in pair planes (plane 4 hf + t holds channels 8 hf + t
// and 8 hf + t + 4 of a pixel side by side)
__device__ __forceinline__ void fwd_stage_x(float* smem,
                                            const float* __restrict__ xn,
                                            int ty0, int tx0, int H, int W) {
  float2* xs = reinterpret_cast<float2*>(smem);
  for (int i = threadIdx.x; i < 2 * kFX * kFX; i += kThreads) {
    const int hf = i / (kFX * kFX);
    const int pix = i - hf * kFX * kFX;
    const int ry = pix / kFX;
    const int rx = pix - ry * kFX;
    const int gy = ty0 - 6 + ry;
    const int gx = tx0 - 6 + rx;
    float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
    if (inside(gy, gx, H, W)) {
      const float4* s = reinterpret_cast<const float4*>(
          xn + ((size_t)gy * W + gx) * kCin + 8 * hf);
      lo = __ldg(s);
      hi = __ldg(s + 1);
    }
    float2* d = xs + hf * 4 * kFPP + ry * kFXS + rx;
    d[0] = make_float2(lo.x, hi.x);
    d[kFPP] = make_float2(lo.y, hi.y);
    d[2 * kFPP] = make_float2(lo.z, hi.z);
    d[3 * kFPP] = make_float2(lo.w, hi.w);
  }
}

// bf16: x on tile + 6 in 8 planes of channel pairs (plane q, a 32-bit word
// a pixel, holds channels 2 q and 2 q + 1), rows kFXS pixels apart
__device__ __forceinline__ void fwd_stage_x(float* smem,
                                            const bf16* __restrict__ xn,
                                            int ty0, int tx0, int H, int W) {
  uint32_t* xs = reinterpret_cast<uint32_t*>(smem);
  for (int pix = threadIdx.x; pix < kFX * kFX; pix += kThreads) {
    const int ry = pix / kFX;
    const int rx = pix - ry * kFX;
    const int gy = ty0 - 6 + ry;
    const int gx = tx0 - 6 + rx;
    uint4 lo = make_uint4(0u, 0u, 0u, 0u), hi = lo;
    if (inside(gy, gx, H, W)) {
      const uint4* s = reinterpret_cast<const uint4*>(
          xn + ((size_t)gy * W + gx) * kCin);
      lo = __ldg(s);
      hi = __ldg(s + 1);
    }
    uint32_t* d = xs + ry * kFXS + rx;
    d[0] = lo.x;
    d[kFPB] = lo.y;
    d[2 * kFPB] = lo.z;
    d[3 * kFPB] = lo.w;
    d[4 * kFPB] = hi.x;
    d[5 * kFPB] = hi.y;
    d[6 * kFPB] = hi.z;
    d[7 * kFPB] = hi.w;
  }
}

// u1 = conv7x7(x) on tile + 3, both heads: M = 484, N = 16, K = 784 in 7
// chunks of a tap row, each summed from zero and added in f32.
// f32: k-steps of 8, k = (kx, hf, r): tap (ky, kx), channel 8 hf + r,
// r = tig (pair .x) and tig + 4 (pair .y); 3xTF32
__device__ __forceinline__ void fwd_gemm(float (&sum)[kFMT][2][4],
                                         const float* smem, const float* ws,
                                         const int (&qrow)[kFMT][2],
                                         int live, int g, int tig) {
  const float2* xa = reinterpret_cast<const float2*>(smem) + tig * kFPP;
  const float* wa = ws + g * kLDWF + 2 * tig;
#pragma unroll 1
  for (int ky = 0; ky < 7; ++ky) {
    float part[kFMT][2][4];
#pragma unroll
    for (int i = 0; i < kFMT; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
#pragma unroll
    for (int s = 0; s < 2 * 7; ++s) {
      const float2* xk = xa + (s & 1) * 4 * kFPP + ky * kFXS + (s >> 1);
      const float* wk = wa + ky * kKC + 8 * s;
      uint32_t bh[2][2], bl[2][2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float2 b = *reinterpret_cast<const float2*>(wk + 8 * j *
                                                          kLDWF);
        split_tf32(b.x, bh[j][0], bl[j][0]);
        split_tf32(b.y, bh[j][1], bl[j][1]);
      }
#pragma unroll
      for (int i = 0; i < kFMT; ++i) {
        if (i < live) {
          const float2 r0 = xk[qrow[i][0]];
          const float2 r1 = xk[qrow[i][1]];
          uint32_t ah[4], al[4];
          split_tf32(r0.x, ah[0], al[0]);
          split_tf32(r1.x, ah[1], al[1]);
          split_tf32(r0.y, ah[2], al[2]);
          split_tf32(r1.y, ah[3], al[3]);
          mma3(part[i][0], ah, al, bh[0], bl[0]);
          mma3(part[i][1], ah, al, bh[1], bl[1]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kFMT; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sum[i][j][e] += part[i][j][e];
  }
}

// bf16: k16 steps, one a tap (ky, kx) with its 16 channels; A registers
// a0, a1 from pair plane tig (channels 2 tig, 2 tig + 1) of rows g and
// g + 8, a2, a3 from plane tig + 4; B registers one word each
__device__ __forceinline__ void fwd_gemm(float (&sum)[kFMT][2][4],
                                         const float* smem, const bf16* ws,
                                         const int (&qrow)[kFMT][2],
                                         int live, int g, int tig) {
  const uint32_t* xa = reinterpret_cast<const uint32_t*>(smem) + tig * kFPB;
  const bf16* wa = ws + g * kLDWF + 2 * tig;
#pragma unroll 1
  for (int ky = 0; ky < 7; ++ky) {
    float part[kFMT][2][4];
#pragma unroll
    for (int i = 0; i < kFMT; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
#pragma unroll
    for (int kx = 0; kx < 7; ++kx) {
      const uint32_t* xk = xa + ky * kFXS + kx;
      const bf16* wk = wa + (ky * 7 + kx) * kCin;
      uint32_t b[2][2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        b[j][0] = word(wk + 8 * j * kLDWF);
        b[j][1] = word(wk + 8 * j * kLDWF + 8);
      }
#pragma unroll
      for (int i = 0; i < kFMT; ++i) {
        if (i < live) {
          uint32_t a[4];
          a[0] = xk[qrow[i][0]];
          a[1] = xk[qrow[i][1]];
          a[2] = xk[4 * kFPB + qrow[i][0]];
          a[3] = xk[4 * kFPB + qrow[i][1]];
          mma_bf16(part[i][0], a, b[0]);
          mma_bf16(part[i][1], a, b[1]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kFMT; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sum[i][j][e] += part[i][j][e];
  }
}

// x (N, H, W, 16) in T; wu (16, 784) = w1 as [h, c][ky, kx, ci] in T; w2,
// w3, alpha f32 (w2, w3 rounded to T); y (N, 2, H, W) in T; u1 (N, H, W,
// 16) f32 or null (painting). Blocks walk the tiles with a grid stride.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    head_fwd_kernel(const T* __restrict__ x, const T* __restrict__ wu,
                    const float* __restrict__ w2, const float* __restrict__ w3,
                    const float* __restrict__ alpha, T* __restrict__ y,
                    float* __restrict__ u1, int N, int H, int W) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* xs = reinterpret_cast<float*>(smem_raw);    // x, staged by type
  float* a1s = xs;                                   // [16][484], over x
  T* ws = reinterpret_cast<T*>(xs + fwd_xa_floats<T>());  // [16][792]
  float* a2s = reinterpret_cast<float*>(ws + kN1 * kLDWF);  // [2][18][18]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int tig = lane & 3;

  fwd_stage_weights(ws, wu);

  // the warp's GEMM rows: pixel of the pair planes at tap (0, 0) of rows
  // g and g + 8 of each of its m16 tiles; tiles past the rows are skipped
  int qrow[kFMT][2];
#pragma unroll
  for (int i = 0; i < kFMT; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      int p = 16 * (warp * kFMT + i) + g + 8 * hh;
      if (p >= kFM) p = 0;  // computed, never stored
      qrow[i][hh] = (p / kFA1) * kFXS + p % kFA1;
    }
  int live = (kFM - 16 * kFMT * warp + 15) / 16;
  live = live > kFMT ? kFMT : live;

  const int tiles_x = (W + kT - 1) / kT;
  const int tiles_img = tiles_x * ((H + kT - 1) / kT);
  const int tiles = N * tiles_img;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int n = t / tiles_img;
    const int ty0 = (t - n * tiles_img) / tiles_x * kT;
    const int tx0 = (t - n * tiles_img) % tiles_x * kT;
    const T* xn = x + (size_t)n * H * W * kCin;

    // x on tile + 6; the previous tile's readers of xs (as a1s) passed the
    // barrier after conv5
    fwd_stage_x(xs, xn, ty0, tx0, H, W);
    __syncthreads();  // x (and, at the first tile, the weights) staged

    float sum[kFMT][2][4];
#pragma unroll
    for (int i = 0; i < kFMT; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sum[i][j][e] = 0.f;
    fwd_gemm(sum, xs, ws, qrow, live, g, tig);
    __syncthreads();  // every warp is done with xs: a1 goes over it

    // column n = 8 j + 2 tig + e of the C fragment is head j, channel
    // 2 tig + e; a kept u1 gets the tile's own pixels; a1 rounded to T
#pragma unroll
    for (int i = 0; i < kFMT; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int p = 16 * (warp * kFMT + i) + g + 8 * hh;
        if (p >= kFM) continue;
        const int py = p / kFA1;
        const int px = p % kFA1;
        const int gy = ty0 - 3 + py;
        const int gx = tx0 - 3 + px;
        const bool in = inside(gy, gx, H, W);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float al1 = __ldg(alpha + 2 * j);
#pragma unroll
          for (int e = 0; e < 2; ++e)
            a1s[(8 * j + 2 * tig + e) * kFM + p] =
                in ? rnd<T>(prelu(sum[i][j][2 * hh + e], al1)) : 0.f;
        }
        if (u1 != nullptr && in && py >= 3 && py < 3 + kT && px >= 3 &&
            px < 3 + kT) {
          float* d = u1 + (((size_t)n * H + gy) * W + gx) * kN1 + 2 * tig;
#pragma unroll
          for (int j = 0; j < 2; ++j)
            *reinterpret_cast<float2*>(d + 8 * j) =
                make_float2(sum[i][j][2 * hh], sum[i][j][2 * hh + 1]);
        }
      }
    __syncthreads();  // a1 staged

    // a2 on tile + 1, both heads, on the CUDA cores; rounded to T
    for (int p = tid; p < kHeads * kFA2 * kFA2; p += kThreads) {
      const int h = p / (kFA2 * kFA2);
      const int q = p - h * kFA2 * kFA2;
      const int py = q / kFA2;
      const int px = q % kFA2;
      const float* w2h = w2 + h * kW2;
      const float* a1h = a1s + h * kC1 * kFM;
      float acc = 0.f;
      for (int ky = 0; ky < 5; ++ky)
        for (int kx = 0; kx < 5; ++kx) {
          const float* wk = w2h + (ky * 5 + kx) * kC1;
          const float* ak = a1h + (py + ky) * kFA1 + px + kx;
#pragma unroll
          for (int c = 0; c < kC1; ++c) acc += ak[c * kFM] * __ldg(wk + c);
        }
      a2s[p] = inside(ty0 - 1 + py, tx0 - 1 + px, H, W)
                   ? rnd<T>(prelu(acc, __ldg(alpha + 2 * h + 1)))
                   : 0.f;
    }
    __syncthreads();  // a2 staged; a1s (xs) free for the next tile

    // y on the tile, both heads: two pixels a thread
    for (int p = tid; p < kHeads * kT * kT; p += kThreads) {
      const int h = p / (kT * kT);
      const int q = p - h * kT * kT;
      const int py = q / kT;
      const int px = q % kT;
      const float* w3h = w3 + h * 9;
      const float* a2h = a2s + h * kFA2 * kFA2;
      float acc = 0.f;
#pragma unroll
      for (int ky = 0; ky < 3; ++ky)
#pragma unroll
        for (int kx = 0; kx < 3; ++kx)
          acc += a2h[(py + ky) * kFA2 + px + kx] * __ldg(w3h + ky * 3 + kx);
      const int gy = ty0 + py;
      const int gx = tx0 + px;
      if (gy < H && gx < W)
        y[(((size_t)n * kHeads + h) * H + gy) * W + gx] = from_f32<T>(acc);
    }
    // the next tile's conv5 rewrites a2s only after three more barriers
  }
}

// ------------------------------------------------------------------------ //
// K3-bwd: dx and dw1 as implicit GEMMs on the tensor cores

// backward regions of a 16 x 16 tile: u1 on tile + 7, u2 and du2 on
// tile + 5, dy on tile + 6, x and du1 on tile + 3; u1 holds one head at a
// time. f32: x shares its shared memory with the dx GEMM's weight ring.
// bf16: the whole wdx is staged once; x goes over u1, u2, du2 and dy, which
// are free by then.
constexpr int kBX = kT + 6;    // 22
constexpr int kBU1 = kT + 14;  // 30
constexpr int kBU2 = kT + 10;  // 26
constexpr int kBDY = kT + 12;  // 28
constexpr int kBD1 = kT + 6;   // 22
// plane strides (floats) of the planar tiles: a warp's fragment loads (8
// consecutive pixels x 4 channel planes) hit 32 banks in du1 (8 mod 32),
// dw1's B loads (8 planes x 4 pixels) in x (4 mod 32); u1's planes are
// 902 = 6 mod 32 floats apart
constexpr int kPX = kBX * kBX;         // 484
constexpr int kPU1 = kBU1 * kBU1 + 2;  // 902
constexpr int kPD1 = kBD1 * kBD1 + 4;  // 488
// the dx GEMM's weights (16, 784) stream through a ring of kStages K chunks
constexpr int kLDW = kKC + 4;    // ring row stride, 20 mod 32
constexpr int kStages = 4;
constexpr int kWalk = 16;        // tiles a block walks along its tile row
constexpr int kNJ = 49 * kCin / 8;        // 98 n8 tiles of dw1^T
constexpr int kJW = (kNJ + 7) / 8;        // 13: of them a warp, at most
constexpr int kJH = (kJW + 1) / 2;        // in two halves of at most 7
constexpr int kXR = kCin * kPX > kStages * kN1 * kLDW ? kCin * kPX
                                                       : kStages * kN1 * kLDW;
constexpr int kChain = kC1 * kPU1 + 2 * kBU2 * kBU2 + kBDY * kBDY;
constexpr int kBwdSmemFloats = kXR + kChain + kN1 * kPD1;
// bf16: du1 twice, as 8 planes of (h, c) pairs (words, 488 = 8 mod 32
// apart: the dx GEMM's A loads) and as 16 planar (h, c) planes of bf16
// (488 elements, 244 = 20 mod 32 words apart: dw1's A loads), pixel
// (py, px) of the tile + 3 at py * 22 + px + 1 there, so an owned pixel
// pair from an even column starts at an even element; x as two planar
// copies (16 planes of 488 bf16 each), the second one pixel further on
// (pixel (py, px) at py * 22 + px in the first, py * 22 + px + 1 in the
// second), over the chain's tiles; wdx [16][kLDWF] bf16 once a block
constexpr int kPD1B = kBD1 * kBD1 + 4;    // 488 elements
constexpr int kBwdSmemFloatsBf16 =
    kChain + 8 * kPD1 + kN1 * kPD1B / 2 + kN1 * kLDWF / 2;
static_assert(2 * kCin * kPD1B / 2 <= kChain, "x fits over the chain");
static_assert(2 * 9 * kT + 4 * kThreads <= kChain, "the reductions fit");

template <typename T>
__host__ __device__ constexpr int bwd_smem_floats() {
  return std::is_same<T, float>::value ? kBwdSmemFloats : kBwdSmemFloatsBf16;
}

// The K loop of a GEMM whose B is a (16, 784) weight matrix `wg` streamed
// in 7 chunks of kKC through the ring; step(c, ws) multiplies chunk c
// (staged at ws, [16][kLDW]) once it has landed for every thread. Ends
// behind a barrier, so the ring and the GEMM's operands are free.
template <class Step>
__device__ __forceinline__ void weight_loop(const float* __restrict__ wg,
                                            float* ring, Step&& step) {
  constexpr int Q = kKC / 4;
  auto issue = [&](int c) {
    float* dst = ring + (c % kStages) * kN1 * kLDW;
    for (int i = threadIdx.x; i < kN1 * Q; i += kThreads) {
      const int r = i / Q;
      const int q = i - r * Q;
      cp_async16(dst + r * kLDW + 4 * q, wg + r * kK1 + c * kKC + 4 * q,
                 true);
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    issue(s);
    cp_async_commit();
  }
  for (int c = 0; c < 7; ++c) {
    cp_async_wait<kStages - 2>();  // chunk c landed
    __syncthreads();               // for every thread; step c - 1 is done
    if (c + kStages - 1 < 7) issue(c + kStages - 1);
    cp_async_commit();
    step(c, ring + (c % kStages) * kN1 * kLDW);
  }
  __syncthreads();
}

// f32: dx on the tile = the transposed 7x7 conv of du1 (both heads):
// M = 256 pixels (warp w: tile rows 2 w, 2 w + 1), N = 16, K = 784
// (ky, kx, h, c); the heads' sum falls out of the GEMM. Then x on tile + 3
// over the ring and dw1 of the tile's pixels: du1^T x, M = 16 (h, c),
// N = 784 (tap, ci), K = 256; warp w owns the n8 tiles w + 8 jj, in two
// halves of jj. The tile's product sums from zero and is added in f32 to
// the block's partial, which lives in device memory (its slot of dw1p,
// read and written by the same thread only) and not in registers.
__device__ __forceinline__ void bwd_gemms(
    const float* __restrict__ xn, const float* __restrict__ wdx,
    float* __restrict__ dx, float* dw1b, float* smem, const float* du1s,
    int n, int ty0, int tx0, int H, int W, bool first, int warp, int g,
    int tig) {
  float* xs = smem;    // [16][kPX] planar
  float* ring = smem;  // [kStages][16][kLDW], over xs
  {
    int arow[2][2];  // du1 slot of tap (0, 0) of rows g, g + 8
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        arow[i][hh] = (2 * warp + i + 6) * kBD1 + g + 8 * hh + 6;
    float sum[2][2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sum[i][j][e] = 0.f;
    weight_loop(wdx, ring, [&](int c, const float* ws) {
      float part[2][2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
#pragma unroll 2
      for (int kk = 0; kk < kKC; kk += 8) {
        // k = (kx, m): du1 at (r + 6 - c, col + 6 - kx), channel m
        const float* dk =
            du1s + ((kk & 15) + tig) * kPD1 - c * kBD1 - (kk >> 4);
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          split_tf32(dk[arow[i][0]], ah[i][0], al[i][0]);
          split_tf32(dk[arow[i][1]], ah[i][1], al[i][1]);
          split_tf32(dk[4 * kPD1 + arow[i][0]], ah[i][2], al[i][2]);
          split_tf32(dk[4 * kPD1 + arow[i][1]], ah[i][3], al[i][3]);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          uint32_t bh[2], bl[2];
          const float* wk = ws + (8 * j + g) * kLDW + kk + tig;
          split_tf32(wk[0], bh[0], bl[0]);
          split_tf32(wk[4], bh[1], bl[1]);
#pragma unroll
          for (int i = 0; i < 2; ++i) mma3(part[i][j], ah[i], al[i], bh, bl);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sum[i][j][e] += part[i][j][e];
    });
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int gy = ty0 + 2 * warp + i;
        const int gx = tx0 + g + 8 * hh;
        if (gy >= H || gx >= W) continue;
        float* d = dx + (((size_t)n * H + gy) * W + gx) * kCin;
#pragma unroll
        for (int j = 0; j < 2; ++j)
          *reinterpret_cast<float2*>(d + 8 * j + 2 * tig) =
              make_float2(sum[i][j][2 * hh], sum[i][j][2 * hh + 1]);
      }
  }

  // x on tile + 3 for dw1, over the ring (free behind dx's last barrier)
  stage_x(xn, xs, kBX, kPX, ty0 - 3, tx0 - 3, H, W);
  __syncthreads();

#pragma unroll 1
  for (int half = 0; half < 2; ++half) {
    float part[kJH][4];
#pragma unroll
    for (int jj = 0; jj < kJH; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[jj][e] = 0.f;
#pragma unroll 8
    for (int kk = 0; kk < kT * kT; kk += 8) {  // 8 pixels of a tile row
      const int r = kk / kT;
      const int col = kk % kT + tig;
      const float* dk = du1s + g * kPD1 + (r + 3) * kBD1 + col + 3;
      uint32_t ah[4], al[4];
      split_tf32(dk[0], ah[0], al[0]);
      split_tf32(dk[8 * kPD1], ah[1], al[1]);
      split_tf32(dk[4], ah[2], al[2]);
      split_tf32(dk[8 * kPD1 + 4], ah[3], al[3]);
      const float* xk = xs + r * kBX + col;
#pragma unroll
      for (int jj = 0; jj < kJH; ++jj) {
        const int J = warp + 8 * (half * kJH + jj);  // n = 8 J + g
        if (J < kNJ) {
          const int tap = J >> 1;
          const float* xp = xk + (8 * (J & 1) + g) * kPX +
                            (tap / 7) * kBX + tap % 7;
          uint32_t bh[2], bl[2];
          split_tf32(xp[0], bh[0], bl[0]);
          split_tf32(xp[4], bh[1], bl[1]);
          mma3(part[jj], ah, al, bh, bl);
        }
      }
    }
#pragma unroll
    for (int jj = 0; jj < kJH; ++jj) {
      const int J = warp + 8 * (half * kJH + jj);
      if (J >= kNJ) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = g + 8 * (e >> 1);            // (h, c)
        const int nn = 8 * J + 2 * tig + (e & 1);  // (tap, ci)
        float* d = dw1b + (m >> 3) * kW1 + nn * kC1 + (m & 7);
        *d = (first ? 0.f : *d) + part[jj][e];
      }
    }
  }
}

// bf16: the same two GEMMs on mma.sync m16n8k16. dx: k16 = a tap's 16
// (h, c), A registers from du1's pair planes (a0, a1: head 0; a2, a3: head
// 1), one MMA a head with the other head's registers zero; each head's sum
// rounded to bf16, the two added and the sum rounded (the JAX kernel sums
// the heads' dx in bf16). x then goes over the chain's tiles in its two
// planar copies, and dw1: K = 16 pixels of a tile row a k16 step.
__device__ __forceinline__ void bwd_gemms(
    const bf16* __restrict__ xn, const bf16* wds, bf16* __restrict__ dx,
    float* dw1b, float* xsm, const uint32_t* dup, const bf16* dpl, int n,
    int ty0, int tx0, int H, int W, bool first, int warp, int g, int tig) {
  {
    int arow[2][2];  // du1 pixel of tap (0, 0) of rows g, g + 8
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        arow[i][hh] = (2 * warp + i + 6) * kBD1 + g + 8 * hh + 6;
    float sum[2][2][2][4];  // [m16 tile][n8 tile][head][C fragment]
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e) sum[i][j][h][e] = 0.f;
    const uint32_t* da = dup + tig * kPD1;
    const bf16* wa = wds + g * kLDWF + 2 * tig;
#pragma unroll 1
    for (int ky = 0; ky < 7; ++ky) {
      float part[2][2][2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 4; ++e) part[i][j][h][e] = 0.f;
#pragma unroll
      for (int kx = 0; kx < 7; ++kx) {
        // du1 at (r + 6 - ky, col + 6 - kx)
        const uint32_t* dk = da - ky * kBD1 - kx;
        const bf16* wk = wa + (ky * 7 + kx) * kN1;
        uint32_t b[2][2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          b[j][0] = word(wk + 8 * j * kLDWF);
          b[j][1] = word(wk + 8 * j * kLDWF + 8);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const uint32_t a0[4] = {dk[arow[i][0]], dk[arow[i][1]], 0u, 0u};
          const uint32_t a1[4] = {0u, 0u, dk[4 * kPD1 + arow[i][0]],
                                  dk[4 * kPD1 + arow[i][1]]};
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            mma_bf16(part[i][j][0], a0, b[j]);
            mma_bf16(part[i][j][1], a1, b[j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 4; ++e) sum[i][j][h][e] += part[i][j][h][e];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int gy = ty0 + 2 * warp + i;
        const int gx = tx0 + g + 8 * hh;
        if (gy >= H || gx >= W) continue;
        bf16* d = dx + (((size_t)n * H + gy) * W + gx) * kCin;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e)
            v[e] = rnd<bf16>(sum[i][j][0][2 * hh + e]) +
                   rnd<bf16>(sum[i][j][1][2 * hh + e]);
          *reinterpret_cast<__nv_bfloat162*>(d + 8 * j + 2 * tig) =
              __floats2bfloat162_rn(v[0], v[1]);
        }
      }
  }

  // x on tile + 3 in its two planar copies, over the chain's tiles (their
  // last readers, the du1 loop and dw2, passed the barrier before dx)
  bf16* x0 = reinterpret_cast<bf16*>(xsm);
  bf16* x1 = x0 + kCin * kPD1B;
  for (int p = threadIdx.x; p < kBX * kBX; p += kThreads) {
    const int gy = ty0 - 3 + p / kBX;
    const int gx = tx0 - 3 + p % kBX;
    uint4 v[2] = {make_uint4(0u, 0u, 0u, 0u), make_uint4(0u, 0u, 0u, 0u)};
    if (inside(gy, gx, H, W)) {
      const uint4* s = reinterpret_cast<const uint4*>(
          xn + ((size_t)gy * W + gx) * kCin);
      v[0] = __ldg(s);
      v[1] = __ldg(s + 1);
    }
    const uint32_t wv[8] = {v[0].x, v[0].y, v[0].z, v[0].w,
                            v[1].x, v[1].y, v[1].z, v[1].w};
#pragma unroll
    for (int ci = 0; ci < kCin; ++ci) {
      const unsigned short c =
          (unsigned short)(wv[ci >> 1] >> (16 * (ci & 1)));
      reinterpret_cast<unsigned short*>(x0)[ci * kPD1B + p] = c;
      reinterpret_cast<unsigned short*>(x1)[ci * kPD1B + p + 1] = c;
    }
  }
  __syncthreads();

#pragma unroll 1
  for (int half = 0; half < 2; ++half) {
    float part[kJH][4];
#pragma unroll
    for (int jj = 0; jj < kJH; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[jj][e] = 0.f;
#pragma unroll 2
    for (int r = 0; r < kT; ++r) {  // k16 = the 16 pixels of tile row r
      // du1 at (r + 3, 2 tig + 3 + {0, 1, 8, 9}): element (r + 3) 22 +
      // 2 tig + 4 (+ 8) of planes g and g + 8
      const bf16* dk = dpl + g * kPD1B + (r + 3) * kBD1 + 2 * tig + 4;
      uint32_t a[4];
      a[0] = word(dk);
      a[1] = word(dk + 8 * kPD1B);
      a[2] = word(dk + 8);
      a[3] = word(dk + 8 * kPD1B + 8);
#pragma unroll
      for (int jj = 0; jj < kJH; ++jj) {
        const int J = warp + 8 * (half * kJH + jj);  // n = 8 J + g
        if (J < kNJ) {
          const int tap = J >> 1;
          const int kx = tap % 7;
          // x at (r + ky, 2 tig + kx + {0, 1}) of plane ci = 8 (J & 1) + g:
          // the copy whose element of that pair is even
          const bf16* xp = ((kx & 1) ? x1 + 1 : x0) +
                           (8 * (J & 1) + g) * kPD1B +
                           (r + tap / 7) * kBX + 2 * tig + kx;
          uint32_t b[2] = {word(xp), word(xp + 8)};
          mma_bf16(part[jj], a, b);
        }
      }
    }
#pragma unroll
    for (int jj = 0; jj < kJH; ++jj) {
      const int J = warp + 8 * (half * kJH + jj);
      if (J >= kNJ) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = g + 8 * (e >> 1);            // (h, c)
        const int nn = 8 * J + 2 * tig + (e & 1);  // (tap, ci)
        float* d = dw1b + (m >> 3) * kW1 + nn * kC1 + (m & 7);
        *d = (first ? 0.f : *d) + part[jj][e];
      }
    }
  }
}

// x (N, H, W, 16) in T; u1 (N, H, W, 16) f32 as K3-fwd keeps it; wdx
// (16, 784) = w1 as [ci][ky, kx, h, c] in T, the B operand of the dx GEMM;
// w2, w3 (rounded to T), alpha f32; dy (N, 2, H, W) and dx in T. One block
// per (run of kWalk tiles, tile row, sample).
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    head_bwd_kernel(const T* __restrict__ x, const float* __restrict__ u1,
                    const T* __restrict__ wdx,
                    const float* __restrict__ w2, const float* __restrict__ w3,
                    const float* __restrict__ alpha,
                    const T* __restrict__ dy, T* __restrict__ dx,
                    float* __restrict__ dw1p, float* __restrict__ dw2p,
                    float* __restrict__ dw3p, float* __restrict__ dalp,
                    int H, int W) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  // f32: [x or the ring][chain][du1 planar f32]; bf16: [chain, x over it]
  // [du1 pair planes][du1 planar bf16][wdx]
  float* chain = smem + (kF32 ? kXR : 0);
  float* u1s = chain;                     // [8][kPU1] one head's u1
  float* u2s = u1s + kC1 * kPU1;          // [26][26] one head's pre-act
  float* du2s = u2s + kBU2 * kBU2;        // [26][26]
  float* dys = du2s + kBU2 * kBU2;        // [28][28] one head's dy
  float* du1s = dys + kBDY * kBDY;        // f32: [16][kPD1] planar 22 x 22
  uint32_t* dup = reinterpret_cast<uint32_t*>(du1s);  // bf16: [8][kPD1]
  bf16* dpl = reinterpret_cast<bf16*>(dup + 8 * kPD1);  // bf16: [16][kPD1B]
  bf16* wds = dpl + kN1 * kPD1B;          // bf16: [16][kLDWF]

  const int n = blockIdx.z;
  const int ty0 = blockIdx.y * kT;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int tiles_x = (W + kT - 1) / kT;
  const int bx0 = blockIdx.x * kWalk;
  const int bx1 = bx0 + kWalk < tiles_x ? bx0 + kWalk : tiles_x;
  const T* xn = x + (size_t)n * H * W * kCin;
  const float* u1n = u1 + (size_t)n * H * W * kN1;
  const size_t blk =
      ((size_t)n * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;

  if constexpr (!kF32) {
    // the dx GEMM's weights, once a block (they land with the first
    // tile's u1)
    constexpr int Q = kK1 / 8;
    for (int i = tid; i < kN1 * Q; i += kThreads) {
      const int r = i / Q;
      const int q = i - r * Q;
      cp_async16(wds + r * kLDWF + 8 * q, wdx + r * kK1 + 8 * q, true);
    }
    cp_async_commit();
  }

  // register partials: dw2 entry tid (tid < 200), dw3 entry tid % 9 over
  // tile row tid / 9 (tid < 144), dalpha of every thread's own pixels
  float dw2r[kHeads] = {0.f, 0.f};
  float dw3r[kHeads] = {0.f, 0.f};
  float dal1r[kHeads] = {0.f, 0.f};
  float dal2r[kHeads] = {0.f, 0.f};

  for (int bx = bx0; bx < bx1; ++bx) {
    const int tx0 = bx * kT;
    __syncthreads();  // the previous tile's readers of xs, u1s, du1s done

    // 1. per head: its u1 staged, then on the CUDA cores u2, du2 (with
    //    dalpha2 and dw3), du1 (with dalpha1 and dw2) of the small convs
    for (int h = 0; h < kHeads; ++h) {
      const float al1 = alpha[2 * h];
      const float al2 = alpha[2 * h + 1];
      const float* u1h = u1s;
      if (h > 0) __syncthreads();  // head 0's readers of u1s are done
      // the head's u1 on tile + 7 from the forward's (planar, 0 outside the
      // image: a1 = prelu(u1) is conv5's padded input)
      for (int i = tid; i < kBU1 * kBU1 * kC1; i += kThreads) {
        const int c = i % kC1;
        const int p = i / kC1;
        const int gy = ty0 - 7 + p / kBU1;
        const int gx = tx0 - 7 + p % kBU1;
        const bool in = inside(gy, gx, H, W);
        cp_async4(u1s + c * kPU1 + p,
                  in ? u1n + ((size_t)gy * W + gx) * kN1 + kC1 * h + c : u1n,
                  in);
      }
      cp_async_commit();
      const float* w2h = w2 + h * kW2;
      const float* w3h = w3 + h * 9;
      for (int p = tid; p < kBDY * kBDY; p += kThreads) {  // dy on tile + 6
        const int gy = ty0 - 6 + p / kBDY;
        const int gx = tx0 - 6 + p % kBDY;
        dys[p] = inside(gy, gx, H, W)
                     ? to_f32(dy[(((size_t)n * kHeads + h) * H + gy) * W + gx])
                     : 0.f;
      }
      cp_async_wait<0>();
      __syncthreads();  // u1, dy; previous head done

      for (int p = tid; p < kBU2 * kBU2; p += kThreads) {  // u2 on tile + 5
        const int py = p / kBU2;
        const int px = p % kBU2;
        float acc = 0.f;
        // not unrolled: hoisting the 200 weight loads spills registers
#pragma unroll 1
        for (int ky = 0; ky < 5; ++ky)
          for (int kx = 0; kx < 5; ++kx) {
            const float* wk = w2h + (ky * 5 + kx) * kC1;
            const float* uk = u1h + (py + ky) * kBU1 + px + kx;
#pragma unroll
            for (int c = 0; c < kC1; ++c)
              acc += rnd<T>(prelu(uk[c * kPU1], al1)) * __ldg(wk + c);
          }
        u2s[p] = inside(ty0 - 5 + py, tx0 - 5 + px, H, W) ? acc : 0.f;
      }
      __syncthreads();

      // du2 on tile + 5 from dy through conv3; dalpha2 and dw3 over the
      // owned pixels; du2 is stored rounded to T (the input of dw2 and of
      // conv5's transpose)
      float dal = 0.f;
      for (int p = tid; p < kBU2 * kBU2; p += kThreads) {
        const int py = p / kBU2;
        const int px = p % kBU2;
        const int gy = ty0 - 5 + py;
        const int gx = tx0 - 5 + px;
        float da = 0.f;
#pragma unroll
        for (int ky = 0; ky < 3; ++ky)
#pragma unroll
          for (int kx = 0; kx < 3; ++kx)
            da += __ldg(w3h + ky * 3 + kx) *
                  dys[(py - ky + 2) * kBDY + px - kx + 2];
        const float u = u2s[p];
        const bool in = inside(gy, gx, H, W);
        du2s[p] = in ? rnd<T>(u >= 0.f ? da : al2 * da) : 0.f;
        const bool owned = py >= 5 && py < 5 + kT && px >= 5 && px < 5 + kT;
        if (in && owned && u < 0.f) dal += da * u;
      }
      add_to_head(dal2r, h, dal);
      if (tid < 9 * kT) {  // dw3[k] over tile row r = tid / 9
        const int k = tid % 9;
        const int r = tid / 9;
        const int ky = k / 3;
        const int kx = k % 3;
        float s = 0.f;
        for (int c = 0; c < kT; ++c) {
          const float u = u2s[(r + ky + 4) * kBU2 + c + kx + 4];
          s += dys[(r + 6) * kBDY + c + 6] * rnd<T>(prelu(u, al2));
        }
        add_to_head(dw3r, h, s);
      }
      __syncthreads();

      // du1 on tile + 3 from du2 through conv5; dalpha1 and dw2 over the
      // owned pixels; du1 stored rounded to T (the GEMMs' operand)
      dal = 0.f;
      for (int p = tid; p < kBD1 * kBD1; p += kThreads) {
        const int py = p / kBD1;
        const int px = p % kBD1;
        float da[kC1];
#pragma unroll
        for (int c = 0; c < kC1; ++c) da[c] = 0.f;
#pragma unroll 1
        for (int ky = 0; ky < 5; ++ky)
          for (int kx = 0; kx < 5; ++kx) {
            const float gv = du2s[(py - ky + 4) * kBU2 + px - kx + 4];
            const float* wk = w2h + (ky * 5 + kx) * kC1;
            const float4 wa = __ldg(reinterpret_cast<const float4*>(wk));
            const float4 wb = __ldg(reinterpret_cast<const float4*>(wk + 4));
            da[0] += gv * wa.x;
            da[1] += gv * wa.y;
            da[2] += gv * wa.z;
            da[3] += gv * wa.w;
            da[4] += gv * wb.x;
            da[5] += gv * wb.y;
            da[6] += gv * wb.z;
            da[7] += gv * wb.w;
          }
        const bool in = inside(ty0 - 3 + py, tx0 - 3 + px, H, W);
        const bool owned = py >= 3 && py < 3 + kT && px >= 3 && px < 3 + kT;
        const float* up = u1h + (py + 4) * kBU1 + px + 4;
#pragma unroll
        for (int c = 0; c < kC1; ++c) {
          const float u = up[c * kPU1];
          const float v = in ? (u >= 0.f ? da[c] : al1 * da[c]) : 0.f;
          if constexpr (kF32) {
            du1s[(h * kC1 + c) * kPD1 + p] = v;
          } else {
            const bf16 b = __float2bfloat16_rn(v);
            reinterpret_cast<bf16*>(dup)[(4 * h + c / 2) * 2 * kPD1 + 2 * p +
                                         (c & 1)] = b;
            dpl[(h * kC1 + c) * kPD1B + p + 1] = b;
          }
          if (in && owned && u < 0.f) dal += da[c] * u;
        }
      }
      add_to_head(dal1r, h, dal);
      if (tid < kW2) {  // dw2[ky][kx][c] over the tile
        const int c = tid % kC1;
        const int k = tid / kC1;
        const int ky = k / 5;
        const int kx = k % 5;
        float s = 0.f;
        for (int r = 0; r < kT; ++r)
          for (int q = 0; q < kT; ++q) {
            const float u = u1h[c * kPU1 + (r + ky + 5) * kBU1 + q + kx + 5];
            s += du2s[(r + 5) * kBU2 + q + 5] * rnd<T>(prelu(u, al1));
          }
        add_to_head(dw2r, h, s);
      }
    }

    // 2. dx on the tile (the transposed 7x7 conv of du1), 3. dw1 of the
    //    tile's pixels (du1^T x); both behind phase 1's last readers
    float* dw1b = dw1p + blk * kHeads * kW1;
    if constexpr (kF32) {
      bwd_gemms(xn, wdx, dx, dw1b, smem, du1s, n, ty0, tx0, H, W, bx == bx0,
                warp, g, tig);
    } else {
      __syncthreads();  // du1 staged; phase 1's readers of the chain done
      bwd_gemms(xn, wds, dx, dw1b, chain, dup, dpl, n, ty0, tx0, H, W,
                bx == bx0, warp, g, tig);
    }
  }

  // the block's other partials, summed in a fixed order
  if (tid < kW2)
    for (int h = 0; h < kHeads; ++h)
      dw2p[(blk * kHeads + h) * kW2 + tid] = dw2r[h];
  __syncthreads();  // every warp is done with xs (f32) or x (bf16)
  float* red = kF32 ? smem : chain;  // [2][144] dw3 rows, then [4][256]
  if (tid < 9 * kT)
    for (int h = 0; h < kHeads; ++h) red[h * 9 * kT + tid] = dw3r[h];
  for (int h = 0; h < kHeads; ++h) {
    red[2 * 9 * kT + (h * 2 + 0) * kThreads + tid] = dal1r[h];
    red[2 * 9 * kT + (h * 2 + 1) * kThreads + tid] = dal2r[h];
  }
  __syncthreads();
  if (tid < kHeads * 9) {
    const int h = tid / 9;
    const int k = tid % 9;
    float s = 0.f;
    for (int r = 0; r < kT; ++r) s += red[h * 9 * kT + r * 9 + k];
    dw3p[(blk * kHeads + h) * 9 + k] = s;
  } else if (tid >= 32 && tid < 32 + 2 * kHeads) {
    const int hj = tid - 32;
    float s = 0.f;
    for (int i = 0; i < kThreads; ++i)
      s += red[2 * 9 * kT + hj * kThreads + i];
    dalp[blk * kHeads * 2 + hj] = s;
  }
}

template <typename T>
cudaError_t launch_fwd(const void* x, const void* wu, const void* w2,
                       const void* w3, const void* alpha, void* y, void* u1,
                       int n, int h, int w, cudaStream_t stream) {
  const long long tiles =
      (long long)n * ((h + kT - 1) / kT) * ((w + kT - 1) / kT);
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int smem = fwd_smem_floats<T>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      head_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, head_fwd_kernel<T>, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long resident = (long long)sms * per_sm;
  const int grid = (int)(tiles < resident ? tiles : resident);
  head_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wu),
      static_cast<const float*>(w2), static_cast<const float*>(w3),
      static_cast<const float*>(alpha), static_cast<T*>(y),
      static_cast<float*>(u1), n, h, w);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* u1, const void* wdx,
                       const void* w2, const void* w3, const void* alpha,
                       const void* dy, void* dx, void* dw1p, void* dw2p,
                       void* dw3p, void* dalp, int n, int h, int w,
                       cudaStream_t stream) {
  const int smem = bwd_smem_floats<T>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      head_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(((w + kT - 1) / kT + kWalk - 1) / kWalk, (h + kT - 1) / kT,
                  n);
  head_bwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(u1),
      static_cast<const T*>(wdx), static_cast<const float*>(w2),
      static_cast<const float*>(w3), static_cast<const float*>(alpha),
      static_cast<const T*>(dy), static_cast<T*>(dx),
      static_cast<float*>(dw1p), static_cast<float*>(dw2p),
      static_cast<float*>(dw3p), static_cast<float*>(dalp), h, w);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (N, H, W, 16), wu (16, 784) = w1 (2, 7, 7, 16, 8) as [h, c][ky, kx, ci],
// y (N, 2, H, W), in float32 (dtype 0) or bfloat16 (dtype 1); w2 (2, 5, 5,
// 8), w3 (2, 3, 3) (rounded to the dtype), alpha (2, 2) and u1 (N, H, W, 16)
// or null (then no u1 is kept) float32; all contiguous. Returns the
// cudaError_t of the launch (0 on success); asynchronous on `stream`.
int bpt_head_stack_fwd(const void* x, const void* wu, const void* w2,
                       const void* w3, const void* alpha, void* y, void* u1,
                       int n, int h, int w, int dtype, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_fwd<float>(x, wu, w2, w3, alpha, y, u1, n, h, w, s);
  if (dtype == 1)
    return (int)launch_fwd<bf16>(x, wu, w2, w3, alpha, y, u1, n, h, w, s);
  return (int)cudaErrorInvalidValue;
}

// x (N, H, W, 16), wdx (16, 784) = w1 as [ci][ky, kx, h, c], dy (N, 2, H,
// W) and dx (N, H, W, 16) in float32 (dtype 0) or bfloat16 (dtype 1); u1
// (N, H, W, 16) as bpt_head_stack_fwd keeps it, w2, w3, alpha as above;
// writes dx and the f32 partials of the
// N * ceil(H / 16) * ceil(ceil(W / 16) / 16) blocks
// (bpt_head_stack_bwd_blocks):
// dw1p (B, 2, 7, 7, 16, 8), dw2p (B, 2, 5, 5, 8), dw3p (B, 2, 3, 3),
// dalp (B, 2, 2).
int bpt_head_stack_bwd(const void* x, const void* u1, const void* wdx,
                       const void* w2, const void* w3, const void* alpha,
                       const void* dy, void* dx, void* dw1p, void* dw2p,
                       void* dw3p, void* dalp, int n, int h, int w,
                       int dtype, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || n > 65535 || (h + kT - 1) / kT > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_bwd<float>(x, u1, wdx, w2, w3, alpha, dy, dx, dw1p,
                                  dw2p, dw3p, dalp, n, h, w, s);
  if (dtype == 1)
    return (int)launch_bwd<bf16>(x, u1, wdx, w2, w3, alpha, dy, dx, dw1p,
                                 dw2p, dw3p, dalp, n, h, w, s);
  return (int)cudaErrorInvalidValue;
}

// Blocks of a K3-bwd launch: the number of partials of each weight gradient.
int bpt_head_stack_bwd_blocks(int n, int h, int w) {
  return n * ((h + kT - 1) / kT) * (((w + kT - 1) / kT + kWalk - 1) / kWalk);
}

// Shared memory per block of the K3 launches (bytes): fwd (which 0) or bwd
// (which 1), float32 (dtype 0) or bfloat16 (dtype 1).
int bpt_head_stack_smem(int which, int dtype) {
  const int floats =
      which == 0 ? (dtype == 0 ? fwd_smem_floats<float>()
                               : fwd_smem_floats<bf16>())
                 : (dtype == 0 ? bwd_smem_floats<float>()
                               : bwd_smem_floats<bf16>());
  return floats * (int)sizeof(float);
}

}  // extern "C"
