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
// the result is deterministic. Each block owns a row of 16 x 16 output tiles
// and adds to its partials only the pixels it owns, so no halo pixel is
// counted twice.
//
// What bounds them: arithmetic. The forward does 12,962 operations per pixel
// and head (the 7x7 conv is 12,544 of them): 163 GFLOP at (24, 512, 512),
// >= 2.4 ms at 67 TFLOP/s (f32 on the CUDA cores), against 0.4 GB of
// traffic. The backward recomputes the chain and does the input and weight
// gradients of each conv, about three times that.
//
// Design, simple first. Forward: one block per (sample, 16 x 16 output tile);
// the input tile with its 6-pixel halo (28 x 28 x 16, 50 KB) is staged once
// in shared memory, planar per channel, and serves both heads in turn; a1 on
// the tile + 3 halo and a2 on the tile + 1 halo stay in shared memory, so
// only y goes back to device memory. The halos are recomputed by the
// neighbouring blocks (1.9x the 7x7 conv's work at this tile).
// Backward: one block per (sample, row of tiles), walking the row. Per tile
// it stages x on the tile + 10 halo (36 x 36 x 16, 83 KB) and dy on tile + 6;
// per head it recomputes u1 on tile + 7 and u2 on tile + 5, then
// du2 (tile + 5) -> du1 (tile + 3) -> dx (tile), with the weight gradients
// of the owned pixels accumulated across the row: dw1 in shared memory (both
// heads, 50 KB), dw2, dw3 and dalpha in registers. Weights are read through
// the read-only cache: every thread of a warp reads the same address.
// Tensor cores, a larger tile that amortises the halo, and keeping u1 from
// the forward are later work.
//
// Plain C interface, no PyTorch header: built with nvcc into a shared
// library and called through ctypes (baryon_painter_tpu_torch/ops/_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

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

// backward regions: x on tile + 10, u1 on tile + 7, u2 and du2 on tile + 5,
// dy on tile + 6, du1 on tile + 3
constexpr int kBX = kT + 20;   // 36
constexpr int kBU1 = kT + 14;  // 30
constexpr int kBU2 = kT + 10;  // 26
constexpr int kBDY = kT + 12;  // 28
constexpr int kBD1 = kT + 6;   // 22
constexpr int kBwdSmemFloats = kCin * kBX * kBX + kC1 * kBU1 * kBU1 +
                               2 * kBU2 * kBU2 + kBDY * kBDY +
                               kBD1 * kBD1 * kC1 + kHeads * kW1;

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
// into planar shared memory xs[c][edge][edge]; 0 outside the image.
__device__ __forceinline__ void stage_x(const float* __restrict__ xn,
                                        float* xs, int edge, int y0, int x0,
                                        int H, int W) {
  const int plane = edge * edge;
  for (int i = threadIdx.x; i < plane * (kCin / 4); i += kThreads) {
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
  extern __shared__ float smem[];
  float* xs = smem;                           // [16][28][28]
  float* a1s = xs + kCin * kFX * kFX;         // [8][22][22]
  float* a2s = a1s + kC1 * kFA1 * kFA1;       // [18][18]
  const int n = blockIdx.z;
  const int ty0 = blockIdx.y * kT;
  const int tx0 = blockIdx.x * kT;
  const int tid = threadIdx.x;

  stage_x(x + (size_t)n * H * W * kCin, xs, kFX, ty0 - 6, tx0 - 6, H, W);
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

__global__ void __launch_bounds__(kThreads)
    head_bwd_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                    const float* __restrict__ w1t,
                    const float* __restrict__ w2, const float* __restrict__ w3,
                    const float* __restrict__ alpha,
                    const float* __restrict__ dy, float* __restrict__ dx,
                    float* __restrict__ dw1p, float* __restrict__ dw2p,
                    float* __restrict__ dw3p, float* __restrict__ dalp,
                    int H, int W) {
  extern __shared__ float smem[];
  float* xs = smem;                              // [16][36][36]
  float* u1s = xs + kCin * kBX * kBX;            // [8][30][30] pre-act
  float* u2s = u1s + kC1 * kBU1 * kBU1;          // [26][26] pre-act
  float* du2s = u2s + kBU2 * kBU2;               // [26][26]
  float* dys = du2s + kBU2 * kBU2;               // [28][28]
  float* du1s = dys + kBDY * kBDY;               // [22*22][8] pixel-major
  float* dw1acc = du1s + kBD1 * kBD1 * kC1;      // [2][7][7][16][8]

  const int n = blockIdx.y;
  const int ty0 = blockIdx.x * kT;
  const int tid = threadIdx.x;
  const int tiles_x = (W + kT - 1) / kT;
  const float* xn = x + (size_t)n * H * W * kCin;

  for (int i = tid; i < kHeads * kW1; i += kThreads) dw1acc[i] = 0.f;
  // register partials: dw2 entry tid (tid < 200), dw3 entry tid % 9 over
  // tile row tid / 9 (tid < 144), dalpha of every thread's own pixels
  float dw2r[kHeads] = {0.f, 0.f};
  float dw3r[kHeads] = {0.f, 0.f};
  float dal1r[kHeads] = {0.f, 0.f};
  float dal2r[kHeads] = {0.f, 0.f};

  for (int bx = 0; bx < tiles_x; ++bx) {
    const int tx0 = bx * kT;
    float dxr[kCin];
#pragma unroll
    for (int c = 0; c < kCin; ++c) dxr[c] = 0.f;

    __syncthreads();  // the previous tile's readers of xs are done
    stage_x(xn, xs, kBX, ty0 - 10, tx0 - 10, H, W);

    for (int h = 0; h < kHeads; ++h) {
      const float al1 = alpha[2 * h];
      const float al2 = alpha[2 * h + 1];
      const float* w1h = w1 + (size_t)h * kW1;
      const float* w2h = w2 + h * kW2;
      const float* w3h = w3 + h * 9;
      __syncthreads();  // xs staged; the previous head's readers are done

      {  // u1 on tile + 7: 900 pixels, up to 4 a thread
        float acc[4][kC1];
        conv7_acc<4>(xs, kBX, kBU1, w1h, acc);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = tid + j * kThreads;
          if (p >= kBU1 * kBU1) continue;
          const bool in =
              inside(ty0 - 7 + p / kBU1, tx0 - 7 + p % kBU1, H, W);
#pragma unroll
          for (int c = 0; c < kC1; ++c)
            u1s[c * kBU1 * kBU1 + p] = in ? acc[j][c] : 0.f;
        }
      }
      for (int p = tid; p < kBDY * kBDY; p += kThreads) {  // dy on tile + 6
        const int gy = ty0 - 6 + p / kBDY;
        const int gx = tx0 - 6 + p % kBDY;
        dys[p] = inside(gy, gx, H, W)
                     ? dy[(((size_t)n * kHeads + h) * H + gy) * W + gx]
                     : 0.f;
      }
      __syncthreads();

      for (int p = tid; p < kBU2 * kBU2; p += kThreads) {  // u2 on tile + 5
        const int py = p / kBU2;
        const int px = p % kBU2;
        float acc = 0.f;
        for (int ky = 0; ky < 5; ++ky)
          for (int kx = 0; kx < 5; ++kx) {
            const float* wk = w2h + (ky * 5 + kx) * kC1;
            const float* uk = u1s + (py + ky) * kBU1 + px + kx;
#pragma unroll
            for (int c = 0; c < kC1; ++c)
              acc += prelu(uk[c * kBU1 * kBU1], al1) * __ldg(wk + c);
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

      // du1 on tile + 3 from du2 through conv5; dalpha1 over the owned
      // pixels; dw2 over the owned pixels
      dal = 0.f;
      for (int p = tid; p < kBD1 * kBD1; p += kThreads) {
        const int py = p / kBD1;
        const int px = p % kBD1;
        float da[kC1];
#pragma unroll
        for (int c = 0; c < kC1; ++c) da[c] = 0.f;
        for (int ky = 0; ky < 5; ++ky)
          for (int kx = 0; kx < 5; ++kx) {
            const float g = du2s[(py - ky + 4) * kBU2 + px - kx + 4];
            const float* wk = w2h + (ky * 5 + kx) * kC1;
            const float4 wa = __ldg(reinterpret_cast<const float4*>(wk));
            const float4 wb = __ldg(reinterpret_cast<const float4*>(wk + 4));
            da[0] += g * wa.x;
            da[1] += g * wa.y;
            da[2] += g * wa.z;
            da[3] += g * wa.w;
            da[4] += g * wb.x;
            da[5] += g * wb.y;
            da[6] += g * wb.z;
            da[7] += g * wb.w;
          }
        const bool in = inside(ty0 - 3 + py, tx0 - 3 + px, H, W);
        const bool owned = py >= 3 && py < 3 + kT && px >= 3 && px < 3 + kT;
        const float* up = u1s + (py + 4) * kBU1 + px + 4;
#pragma unroll
        for (int c = 0; c < kC1; ++c) {
          const float u = up[c * kBU1 * kBU1];
          du1s[p * kC1 + c] = in ? (u >= 0.f ? da[c] : al1 * da[c]) : 0.f;
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
            const float u =
                u1s[c * kBU1 * kBU1 + (r + ky + 5) * kBU1 + q + kx + 5];
            s += du2s[(r + 5) * kBU2 + q + 5] * prelu(u, al1);
          }
        add_to_head(dw2r, h, s);
      }
      __syncthreads();

      // dw1[ky][kx][ci][:] over the tile's pixels: combos (ky, kx, ci),
      // combo = ci * 49 + ky * 7 + kx, up to 4 a thread
      {
        float acc[4][kC1];
        int xoff[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          int cb = tid + j * kThreads;
          if (cb >= 49 * kCin) cb = 0;  // computed, never stored
          const int ci = cb / 49;
          const int k = cb % 49;
          xoff[j] = ci * kBX * kBX + (k / 7 + 7) * kBX + k % 7 + 7;
#pragma unroll
          for (int c = 0; c < kC1; ++c) acc[j][c] = 0.f;
        }
        for (int r = 0; r < kT; ++r)
          for (int q = 0; q < kT; ++q) {
            const float* g = du1s + ((r + 3) * kBD1 + q + 3) * kC1;
            const float4 ga = *reinterpret_cast<const float4*>(g);
            const float4 gb = *reinterpret_cast<const float4*>(g + 4);
            const int pix = r * kBX + q;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float v = xs[xoff[j] + pix];
              acc[j][0] += v * ga.x;
              acc[j][1] += v * ga.y;
              acc[j][2] += v * ga.z;
              acc[j][3] += v * ga.w;
              acc[j][4] += v * gb.x;
              acc[j][5] += v * gb.y;
              acc[j][6] += v * gb.z;
              acc[j][7] += v * gb.w;
            }
          }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int cb = tid + j * kThreads;
          if (cb >= 49 * kCin) continue;
          const int ci = cb / 49;
          const int k = cb % 49;
          float* dst = dw1acc + h * kW1 + (k * kCin + ci) * kC1;
#pragma unroll
          for (int c = 0; c < kC1; ++c) dst[c] += acc[j][c];
        }
      }

      {  // dx on the tile: one pixel a thread, 16 channels, both heads
        const int py = tid / kT;
        const int px = tid % kT;
        const float* w1th = w1t + (size_t)h * kW1;
        for (int ky = 0; ky < 7; ++ky)
          for (int kx = 0; kx < 7; ++kx) {
            const float* g = du1s + ((py - ky + 6) * kBD1 + px - kx + 6) * kC1;
            const float4 ga = *reinterpret_cast<const float4*>(g);
            const float4 gb = *reinterpret_cast<const float4*>(g + 4);
            const float gv[kC1] = {ga.x, ga.y, ga.z, ga.w,
                                   gb.x, gb.y, gb.z, gb.w};
            const float* wk = w1th + (ky * 7 + kx) * kC1 * kCin;
#pragma unroll
            for (int c = 0; c < kC1; ++c) {
#pragma unroll
              for (int q = 0; q < kCin / 4; ++q) {
                const float4 w4 = __ldg(
                    reinterpret_cast<const float4*>(wk + c * kCin) + q);
                dxr[4 * q + 0] += gv[c] * w4.x;
                dxr[4 * q + 1] += gv[c] * w4.y;
                dxr[4 * q + 2] += gv[c] * w4.z;
                dxr[4 * q + 3] += gv[c] * w4.w;
              }
            }
          }
      }
    }

    {  // write dx of the tile, both heads summed
      const int gy = ty0 + tid / kT;
      const int gx = tx0 + tid % kT;
      if (gy < H && gx < W) {
        float4* d = reinterpret_cast<float4*>(
            dx + (((size_t)n * H + gy) * W + gx) * kCin);
#pragma unroll
        for (int q = 0; q < kCin / 4; ++q)
          d[q] = make_float4(dxr[4 * q], dxr[4 * q + 1], dxr[4 * q + 2],
                             dxr[4 * q + 3]);
      }
    }
  }

  // this block's partials, summed in a fixed order
  __syncthreads();
  const size_t blk = (size_t)n * gridDim.x + blockIdx.x;
  for (int i = tid; i < kHeads * kW1; i += kThreads)
    dw1p[blk * kHeads * kW1 + i] = dw1acc[i];
  if (tid < kW2)
    for (int h = 0; h < kHeads; ++h)
      dw2p[(blk * kHeads + h) * kW2 + tid] = dw2r[h];
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

// As above, plus w1t (2, 7, 7, 8, 16) (w1 with its channel axes swapped),
// dy (N, 2, H, W); writes dx (N, H, W, 16) and the partials of the
// N * ceil(H / 16) blocks: dw1p (B, 2, 7, 7, 16, 8), dw2p (B, 2, 5, 5, 8),
// dw3p (B, 2, 3, 3), dalp (B, 2, 2).
int bpt_head_stack_bwd(const void* x, const void* w1, const void* w1t,
                       const void* w2, const void* w3, const void* alpha,
                       const void* dy, void* dx, void* dw1p, void* dw2p,
                       void* dw3p, void* dalp, int n, int h, int w,
                       void* stream) {
  if (n <= 0 || h <= 0 || w <= 0) return (int)cudaErrorInvalidValue;
  const int smem = kBwdSmemFloats * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      head_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((h + kT - 1) / kT, n);
  head_bwd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1),
      static_cast<const float*>(w1t), static_cast<const float*>(w2),
      static_cast<const float*>(w3), static_cast<const float*>(alpha),
      static_cast<const float*>(dy), static_cast<float*>(dx),
      static_cast<float*>(dw1p), static_cast<float*>(dw2p),
      static_cast<float*>(dw3p), static_cast<float*>(dalp), h, w);
  return (int)cudaGetLastError();
}

}  // extern "C"
