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
// The backward takes dy (N, 2, H, W) and returns dx (both heads summed) and
// per-block partial sums of dw1, dw2, dw3 and dalpha, which the wrapper sums
// in torch: every block writes its own partials and no atomics are used, so
// the result is deterministic. Each block walks up to 16 of the 16 x 16
// output tiles of a tile row and adds to its partials only the pixels it
// owns, so no halo pixel is counted twice.
//
// What bounds them: arithmetic. The forward does 12,962 operations per pixel
// and head (the 7x7 conv is 12,544 of them): 163 GFLOP at (24, 512, 512),
// >= 2.4 ms at 67 TFLOP/s (f32 on the CUDA cores), against 0.4 GB of
// traffic. The backward does three 7x7 products per pixel and head (u1
// recomputed, dx, dw1): 473 GFLOP, >= 2.87 ms as 3xTF32 on the tensor cores
// (495/3 TFLOP/s), and 15.6 GFLOP of small convs on the CUDA cores.
//
// Forward, simple first: one block per (sample, 16 x 16 output tile); the
// input tile with its 6-pixel halo (28 x 28 x 16, 50 KB) is staged once in
// shared memory, planar per channel, and serves both heads in turn; a1 on
// the tile + 3 halo and a2 on the tile + 1 halo stay in shared memory, so
// only y goes back to device memory. The halos are recomputed by the
// neighbouring blocks (1.9x the 7x7 conv's work at this tile). FFMA on the
// CUDA cores; weights through the read-only cache.
//
// Backward: the two heads stacked, so the 7x7 convs are implicit GEMMs with
// N = 16 on the tensor cores in 3xTF32 (mma.sync m16n8k8; each f32 operand
// split into a tf32 big and small = v - big, split_tf32 in ptx.cuh;
// small*big + big*small + big*big accumulated in f32):
//   u1:  M = the tile + 7 (30 x 30 pixels), N = 2 heads x 8, K = 7 x 7 x 16
//   dx:  M = the tile's 256 pixels, N = 16, K = 7 x 7 x (2 heads x 8): the
//        transposed conv of du1, the heads' sum inside the GEMM
//   dw1: du1^T x, M = 16 (h, c), N = 7 x 7 x 16, K = the tile's pixels
// The tensor cores' accumulators truncate, so each K chunk (a row of 7 taps
// for u1 and dx, a tile for dw1) sums from zero and is added in f32. Per
// tile: x is staged on the tile + 10 (36 x 36, planar, planes padded so a
// warp's fragment loads hit 32 banks); u1 on the tile + 7 stays in shared
// memory (planar); per head on the CUDA cores u2 (tile + 5), du2 with
// dalpha2 and dw3, du1 (tile + 3, planar) with dalpha1 and dw2; then dx and
// dw1. The weights of the u1 and dx GEMMs (16 x 784 each, laid out by the
// wrapper) stream through a 4-stage cp.async ring of 7 chunks. A block's dw1
// partial lives in its slot of the partials in device memory (each entry
// read and written by one thread), which keeps 52 registers a thread free;
// dw2, dw3 and dalpha in registers. Keeping u1 from the forward (no
// recompute on the tile + 7, 3.5x the owned pixels) is later work.
//
// Plain C interface, no PyTorch header: built with nvcc into a shared
// library and called through ctypes (baryon_painter_tpu_torch/ops/_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

constexpr int kCin = 16;   // head input channels
constexpr int kC1 = 8;     // conv7 output channels
constexpr int kHeads = 2;
constexpr int kT = 16;     // output tile edge
constexpr int kThreads = 256;
constexpr int kW1 = 7 * 7 * kCin * kC1;   // w1 entries per head (6272)
constexpr int kW2 = 5 * 5 * kC1;          // w2 entries per head (200)

// forward regions: x on tile + 6, a1 on tile + 3, a2 on tile + 1
constexpr int kFX = kT + 12;   // 28
constexpr int kFA1 = kT + 6;   // 22
constexpr int kFA2 = kT + 2;   // 18
constexpr int kFwdSmemFloats =
    kCin * kFX * kFX + kC1 * kFA1 * kFA1 + kFA2 * kFA2;

__device__ __forceinline__ float prelu(float u, float a) {
  return u >= 0.f ? u : a * u;
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

// u1 = conv7x7(x) for NP pixels of a square region of edge `out_edge`
// (pixel p = threadIdx.x + j * kThreads), reading the staged x of edge
// `x_edge` (region corner 3 pixels further out). acc[j][c] for c < 8.
template <int NP>
__device__ __forceinline__ void conv7_acc(const float* xs, int x_edge,
                                          int out_edge,
                                          const float* __restrict__ w1h,
                                          float acc[NP][kC1]) {
  const int plane = x_edge * x_edge;
  const int npix = out_edge * out_edge;
  int base[NP];
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    int p = threadIdx.x + j * kThreads;
    if (p >= npix) p = 0;  // computed, never stored
    base[j] = (p / out_edge) * x_edge + p % out_edge;
#pragma unroll
    for (int c = 0; c < kC1; ++c) acc[j][c] = 0.f;
  }
  for (int ky = 0; ky < 7; ++ky) {
    for (int kx = 0; kx < 7; ++kx) {
      const float* wk = w1h + (ky * 7 + kx) * kCin * kC1;
      const int off = ky * x_edge + kx;
#pragma unroll 4
      for (int ci = 0; ci < kCin; ++ci) {
        const float4 wa = __ldg(reinterpret_cast<const float4*>(wk + ci * kC1));
        const float4 wb =
            __ldg(reinterpret_cast<const float4*>(wk + ci * kC1 + 4));
        const float* xc = xs + ci * plane + off;
#pragma unroll
        for (int j = 0; j < NP; ++j) {
          const float v = xc[base[j]];
          acc[j][0] += v * wa.x;
          acc[j][1] += v * wa.y;
          acc[j][2] += v * wa.z;
          acc[j][3] += v * wa.w;
          acc[j][4] += v * wb.x;
          acc[j][5] += v * wb.y;
          acc[j][6] += v * wb.z;
          acc[j][7] += v * wb.w;
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    head_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                    const float* __restrict__ w2, const float* __restrict__ w3,
                    const float* __restrict__ alpha, float* __restrict__ y,
                    int H, int W) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* xs = reinterpret_cast<float*>(smem_raw);  // [16][28][28]
  float* a1s = xs + kCin * kFX * kFX;         // [8][22][22]
  float* a2s = a1s + kC1 * kFA1 * kFA1;       // [18][18]
  const int n = blockIdx.z;
  const int ty0 = blockIdx.y * kT;
  const int tx0 = blockIdx.x * kT;
  const int tid = threadIdx.x;

  stage_x(x + (size_t)n * H * W * kCin, xs, kFX, kFX * kFX, ty0 - 6, tx0 - 6,
          H, W);
  __syncthreads();

  for (int h = 0; h < kHeads; ++h) {
    const float al1 = alpha[2 * h];
    const float al2 = alpha[2 * h + 1];
    {  // a1 on tile + 3: 484 pixels, 2 a thread, all 8 channels
      float acc[2][kC1];
      conv7_acc<2>(xs, kFX, kFA1, w1 + (size_t)h * kW1, acc);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int p = tid + j * kThreads;
        if (p >= kFA1 * kFA1) continue;
        const bool in =
            inside(ty0 - 3 + p / kFA1, tx0 - 3 + p % kFA1, H, W);
#pragma unroll
        for (int c = 0; c < kC1; ++c)
          a1s[c * kFA1 * kFA1 + p] = in ? prelu(acc[j][c], al1) : 0.f;
      }
    }
    __syncthreads();
    const float* w2h = w2 + h * kW2;
    for (int p = tid; p < kFA2 * kFA2; p += kThreads) {  // a2 on tile + 1
      const int py = p / kFA2;
      const int px = p % kFA2;
      float acc = 0.f;
      for (int ky = 0; ky < 5; ++ky)
        for (int kx = 0; kx < 5; ++kx) {
          const float* wk = w2h + (ky * 5 + kx) * kC1;
          const float* ak = a1s + (py + ky) * kFA1 + px + kx;
#pragma unroll
          for (int c = 0; c < kC1; ++c)
            acc += ak[c * kFA1 * kFA1] * __ldg(wk + c);
        }
      a2s[p] = inside(ty0 - 1 + py, tx0 - 1 + px, H, W) ? prelu(acc, al2)
                                                          : 0.f;
    }
    __syncthreads();
    {  // y on the tile: one pixel a thread
      const int py = tid / kT;
      const int px = tid % kT;
      const float* w3h = w3 + h * 9;
      float acc = 0.f;
#pragma unroll
      for (int ky = 0; ky < 3; ++ky)
#pragma unroll
        for (int kx = 0; kx < 3; ++kx)
          acc += a2s[(py + ky) * kFA2 + px + kx] * __ldg(w3h + ky * 3 + kx);
      const int gy = ty0 + py;
      const int gx = tx0 + px;
      if (gy < H && gx < W) y[(((size_t)n * kHeads + h) * H + gy) * W + gx] = acc;
    }
    __syncthreads();  // a1s/a2s are rewritten by the next head
  }
}

// ------------------------------------------------------------------------ //
// K3-bwd: the 7x7 convolutions as implicit GEMMs on the tensor cores

// backward regions of a 16 x 16 tile: x on tile + 10, u1 on tile + 7, u2 and
// du2 on tile + 5, dy on tile + 6, du1 on tile + 3
constexpr int kBX = kT + 20;   // 36
constexpr int kBU1 = kT + 14;  // 30
constexpr int kBU2 = kT + 10;  // 26
constexpr int kBDY = kT + 12;  // 28
constexpr int kBD1 = kT + 6;   // 22
constexpr int kN1 = kHeads * kC1;  // 16: both heads' conv7 channels
// plane strides (floats) of the planar tiles: a warp's fragment loads (8
// consecutive pixels x 4 channel planes) hit 32 banks in x (24 mod 32) and
// du1 (8 mod 32), and the u1 GEMM's stores (8 pixels x 8 planes) in u1
constexpr int kPX = kBX * kBX + 8;     // 1304
constexpr int kPU1 = kBU1 * kBU1;      // 900
constexpr int kPD1 = kBD1 * kBD1 + 4;  // 488
// K chunk of the u1 and dx GEMMs: one row of 7 taps x 16 channels; the
// weights (16, 784) stream through a ring of kStages such chunks
constexpr int kKC = 7 * kCin;    // 112
constexpr int kLDW = kKC + 4;    // ring row stride, 20 mod 32
constexpr int kStages = 4;
constexpr int kWalk = 16;        // tiles a block walks along its tile row
constexpr int kMT = 4;           // m16 tiles a warp, a u1 pass
constexpr int kNJ = 49 * kCin / 8;        // 98 n8 tiles of dw1^T
constexpr int kJW = (kNJ + 7) / 8;        // 13: of them a warp, at most
constexpr int kJH = (kJW + 1) / 2;        // in two halves of at most 7
constexpr int kBwdSmemFloats = kCin * kPX + kN1 * kPU1 + 2 * kBU2 * kBU2 +
                               kBDY * kBDY + kN1 * kPD1 +
                               kStages * kN1 * kLDW;

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
      cp_async16(dst + r * kLDW + 4 * q, wg + r * 49 * kCin + c * kKC + 4 * q,
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

// x (N, H, W, 16); wu (16, 784) = w1 as [h, c][ky, kx, ci] and wdx (16,
// 784) = w1 as [ci][ky, kx, h, c], the B operands of the u1 and dx GEMMs.
// One block per (run of kWalk tiles, tile row, sample).
__global__ void __launch_bounds__(kThreads, 1)
    head_bwd_kernel(const float* __restrict__ x, const float* __restrict__ wu,
                    const float* __restrict__ wdx,
                    const float* __restrict__ w2, const float* __restrict__ w3,
                    const float* __restrict__ alpha,
                    const float* __restrict__ dy, float* __restrict__ dx,
                    float* __restrict__ dw1p, float* __restrict__ dw2p,
                    float* __restrict__ dw3p, float* __restrict__ dalp,
                    int H, int W) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* xs = reinterpret_cast<float*>(smem_raw);  // [16][kPX] planar
  float* u1s = xs + kCin * kPX;           // [16][30 x 30] pre-activation
  float* u2s = u1s + kN1 * kPU1;          // [26][26] one head's pre-act
  float* du2s = u2s + kBU2 * kBU2;        // [26][26]
  float* dys = du2s + kBU2 * kBU2;        // [28][28] one head's dy
  float* du1s = dys + kBDY * kBDY;        // [16][kPD1] planar, 22 x 22
  float* ring = du1s + kN1 * kPD1;        // [kStages][16][kLDW]

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
  const float* xn = x + (size_t)n * H * W * kCin;
  const size_t blk =
      ((size_t)n * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;

  // register partials: dw2 entry tid (tid < 200), dw3 entry tid % 9 over
  // tile row tid / 9 (tid < 144), dalpha of every thread's own pixels
  float dw2r[kHeads] = {0.f, 0.f};
  float dw3r[kHeads] = {0.f, 0.f};
  float dal1r[kHeads] = {0.f, 0.f};
  float dal2r[kHeads] = {0.f, 0.f};

  for (int bx = bx0; bx < bx1; ++bx) {
    const int tx0 = bx * kT;
    __syncthreads();  // the previous tile's readers of xs and du1s are done
    stage_x(xn, xs, kBX, kPX, ty0 - 10, tx0 - 10, H, W);

    // 1. u1 = conv7x7(x) on tile + 7, both heads (N = 16), K = 784, in
    //    passes of 8 warps x kMT m16 tiles (57 tiles hold the 900 pixels)
    for (int pass = 0; pass * 8 * kMT * 16 < kPU1; ++pass) {
      const int t0 = pass * 8 * kMT + warp * kMT;  // the warp's first tile
      int live = (kPU1 - 16 * t0 + 15) / 16;       // tiles holding pixels
      live = live < 0 ? 0 : (live > kMT ? kMT : live);
      int arow[kMT][2];  // x slot of the first tap of rows g, g + 8
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          int p = 16 * (t0 + i) + g + 8 * hh;
          if (p >= kPU1) p = 0;  // computed, never stored
          arow[i][hh] = (p / kBU1) * kBX + p % kBU1;
        }
      float sum[kMT][2][4];
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sum[i][j][e] = 0.f;
      weight_loop(wu, ring, [&](int c, const float* ws) {
        if (live == 0) return;
        float part[kMT][2][4];
#pragma unroll
        for (int i = 0; i < kMT; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
#pragma unroll 2
        for (int kk = 0; kk < kKC; kk += 8) {
          // k = (kx, ci): tap (c, kk / 16), channels kk % 16 + tig (+ 4)
          const float* xk = xs + ((kk & 15) + tig) * kPX + c * kBX + (kk >> 4);
          uint32_t ah[kMT][4], al[kMT][4];
#pragma unroll
          for (int i = 0; i < kMT; ++i) {
            if (i < live) {
              split_tf32(xk[arow[i][0]], ah[i][0], al[i][0]);
              split_tf32(xk[arow[i][1]], ah[i][1], al[i][1]);
              split_tf32(xk[4 * kPX + arow[i][0]], ah[i][2], al[i][2]);
              split_tf32(xk[4 * kPX + arow[i][1]], ah[i][3], al[i][3]);
            }
          }
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            uint32_t bh[2], bl[2];
            const float* wk = ws + (8 * j + g) * kLDW + kk + tig;
            split_tf32(wk[0], bh[0], bl[0]);
            split_tf32(wk[4], bh[1], bl[1]);
#pragma unroll
            for (int i = 0; i < kMT; ++i)
              if (i < live) mma3(part[i][j], ah[i], al[i], bh, bl);
          }
        }
#pragma unroll
        for (int i = 0; i < kMT; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) sum[i][j][e] += part[i][j][e];
      });
      // u1 is 0 outside the image: a1 = prelu(u1) is conv5's padded input
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int p = 16 * (t0 + i) + g + 8 * hh;
          if (p >= kPU1) continue;
          const bool in =
              inside(ty0 - 7 + p / kBU1, tx0 - 7 + p % kBU1, H, W);
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              u1s[(8 * j + 2 * tig + e) * kPU1 + p] =
                  in ? sum[i][j][2 * hh + e] : 0.f;
        }
    }

    // 2. per head, on the CUDA cores: u2, du2 (with dalpha2 and dw3), du1
    //    (with dalpha1 and dw2) of the small convs
    for (int h = 0; h < kHeads; ++h) {
      const float al1 = alpha[2 * h];
      const float al2 = alpha[2 * h + 1];
      const float* u1h = u1s + h * kC1 * kPU1;
      const float* w2h = w2 + h * kW2;
      const float* w3h = w3 + h * 9;
      for (int p = tid; p < kBDY * kBDY; p += kThreads) {  // dy on tile + 6
        const int gy = ty0 - 6 + p / kBDY;
        const int gx = tx0 - 6 + p % kBDY;
        dys[p] = inside(gy, gx, H, W)
                     ? dy[(((size_t)n * kHeads + h) * H + gy) * W + gx]
                     : 0.f;
      }
      __syncthreads();  // u1 (the GEMM's stores), dy; previous head done

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
              acc += prelu(uk[c * kPU1], al1) * __ldg(wk + c);
          }
        u2s[p] = inside(ty0 - 5 + py, tx0 - 5 + px, H, W) ? acc : 0.f;
      }
      __syncthreads();

      // du2 on tile + 5 from dy through conv3; dalpha2 and dw3 over the
      // owned pixels
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
        du2s[p] = in ? (u >= 0.f ? da : al2 * da) : 0.f;
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
          s += dys[(r + 6) * kBDY + c + 6] * prelu(u, al2);
        }
        add_to_head(dw3r, h, s);
      }
      __syncthreads();

      // du1 on tile + 3 from du2 through conv5; dalpha1 and dw2 over the
      // owned pixels
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
        float* dp = du1s + h * kC1 * kPD1 + p;
#pragma unroll
        for (int c = 0; c < kC1; ++c) {
          const float u = up[c * kPU1];
          dp[c * kPD1] = in ? (u >= 0.f ? da[c] : al1 * da[c]) : 0.f;
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
            s += du2s[(r + 5) * kBU2 + q + 5] * prelu(u, al1);
          }
        add_to_head(dw2r, h, s);
      }
    }

    // 3. dx on the tile = the transposed 7x7 conv of du1 (both heads):
    //    M = 256 pixels (warp w: tile rows 2 w, 2 w + 1), N = 16, K = 784
    //    (ky, kx, h, c); the heads' sum falls out of the GEMM
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

    // 4. dw1 of the tile's pixels: du1^T x, M = 16 (h, c), N = 784 (tap,
    //    ci), K = 256; warp w owns the n8 tiles w + 8 jj, in two halves of
    //    jj. The tile's product sums from zero and is added in f32 to the
    //    block's partial, which lives in device memory (its slot of dw1p,
    //    read and written by the same thread only) and not in registers.
    float* dw1b = dw1p + blk * kHeads * kW1;
#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      float part[kJH][4];
#pragma unroll
      for (int jj = 0; jj < kJH; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[jj][e] = 0.f;
#pragma unroll 1
      for (int kk = 0; kk < kT * kT; kk += 8) {  // 8 pixels of a tile row
        const int r = kk / kT;
        const int col = kk % kT + tig;
        const float* dk = du1s + g * kPD1 + (r + 3) * kBD1 + col + 3;
        uint32_t ah[4], al[4];
        split_tf32(dk[0], ah[0], al[0]);
        split_tf32(dk[8 * kPD1], ah[1], al[1]);
        split_tf32(dk[4], ah[2], al[2]);
        split_tf32(dk[8 * kPD1 + 4], ah[3], al[3]);
        const float* xk = xs + (r + 7) * kBX + col + 7;
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
          *d = (bx == bx0 ? 0.f : *d) + part[jj][e];
        }
      }
    }
  }

  // the block's other partials, summed in a fixed order
  if (tid < kW2)
    for (int h = 0; h < kHeads; ++h)
      dw2p[(blk * kHeads + h) * kW2 + tid] = dw2r[h];
  __syncthreads();  // every warp is done with xs
  float* red = xs;  // [2][144] dw3 rows, then [4][256] dalpha
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

}  // namespace

extern "C" {

// x (N, H, W, 16), w1 (2, 7, 7, 16, 8), w2 (2, 5, 5, 8), w3 (2, 3, 3),
// alpha (2, 2), y (N, 2, H, W), all f32 and contiguous. Returns the
// cudaError_t of the launch (0 on success); asynchronous on `stream`.
int bpt_head_stack_fwd(const void* x, const void* w1, const void* w2,
                       const void* w3, const void* alpha, void* y, int n,
                       int h, int w, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0) return (int)cudaErrorInvalidValue;
  const int smem = kFwdSmemFloats * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      head_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((w + kT - 1) / kT, (h + kT - 1) / kT, n);
  head_fwd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1),
      static_cast<const float*>(w2), static_cast<const float*>(w3),
      static_cast<const float*>(alpha), static_cast<float*>(y), h, w);
  return (int)cudaGetLastError();
}

// x (N, H, W, 16), wu (16, 784) = w1 (2, 7, 7, 16, 8) as [h, c][ky, kx, ci],
// wdx (16, 784) = w1 as [ci][ky, kx, h, c], w2, w3, alpha as above, dy
// (N, 2, H, W); writes dx (N, H, W, 16) and the partials of the
// N * ceil(H / 16) * ceil(ceil(W / 16) / 16) blocks
// (bpt_head_stack_bwd_blocks):
// dw1p (B, 2, 7, 7, 16, 8), dw2p (B, 2, 5, 5, 8), dw3p (B, 2, 3, 3),
// dalp (B, 2, 2).
int bpt_head_stack_bwd(const void* x, const void* wu, const void* wdx,
                       const void* w2, const void* w3, const void* alpha,
                       const void* dy, void* dx, void* dw1p, void* dw2p,
                       void* dw3p, void* dalp, int n, int h, int w,
                       void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || n > 65535 || (h + kT - 1) / kT > 65535)
    return (int)cudaErrorInvalidValue;
  const int smem = kBwdSmemFloats * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      head_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(((w + kT - 1) / kT + kWalk - 1) / kWalk, (h + kT - 1) / kT,
                  n);
  head_bwd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(wu),
      static_cast<const float*>(wdx), static_cast<const float*>(w2),
      static_cast<const float*>(w3), static_cast<const float*>(alpha),
      static_cast<const float*>(dy), static_cast<float*>(dx),
      static_cast<float*>(dw1p), static_cast<float*>(dw2p),
      static_cast<float*>(dw3p), static_cast<float*>(dalp), h, w);
  return (int)cudaGetLastError();
}

// Blocks of a K3-bwd launch: the number of partials of each weight gradient.
int bpt_head_stack_bwd_blocks(int n, int h, int w) {
  return n * ((h + kT - 1) / kT) * (((w + kT - 1) / kT + kWalk - 1) / kWalk);
}

// Shared memory per block of the K3 launches (bytes): fwd, bwd.
int bpt_head_stack_smem(int which) {
  return (which == 0 ? kFwdSmemFloats : kBwdSmemFloats) * (int)sizeof(float);
}

}  // extern "C"
