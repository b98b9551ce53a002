// K4: train-mode conv (or transposed conv) + batch norm + ReLU, forward and
// backward, hand-written for Hopper (sm_90a).
//
// Replaces the four Pallas TPU kernels of `fused_conv_bn_relu` in
// baryon_painter_tpu/ops/pallas_conv_bn.py: `_stats_kernel` (K4-stats),
// `_fwd_kernel` (K4-fwd), `_bwd1_kernel` (K4-bwd1) and `_bwd2_kernel`
// (K4-bwd2). With u = conv(x, w) the logical convolution (no bias), batch
// statistics over (N, H, W) per output channel, a = gamma * inv and
// b = beta - mean * a (inv = rsqrt(var + eps), formed by the wrapper):
//
//   K4-stats: per-block partial sums of u and u^2 per channel
//   K4-fwd:   y = max(u * a + b, 0)
//   K4-bwd1:  per-block partial sums of dv and dv * uhat per channel, where
//             dv = dy if u * a + b > 0 else 0 and uhat = (u - mean) * inv
//   K4-bwd2:  du = a * (dv - S1/n - uhat * S2/n); dx = the adjoint conv of
//             du; per-block partial dW = sum over the block's pixels
//
// Every kernel recomputes u from x, as the TPU kernels do: u is never
// stored. The partial sums are written per block and summed by the wrapper
// in torch; no atomics are used, so every result is deterministic.
//
// Two families of convolution, NCHW f32, computed directly (no
// space-to-depth, no phase-major weights):
//   S == 1: stride-1 "same" conv, odd K, P = (K - 1) / 2, w OIHW
//           (Cout, Cin, K, K); output (N, Cout, H, W).
//   S >  1: transposed conv with K = 2S and P = S/2, w IOHW (Cin, Cout, K, K)
//           as torch's conv_transpose2d takes it; output (N, Cout, S H, S W).
//           Fine output row oy takes the two coarse rows
//           iy = (oy + P) / S - t, t = 0, 1, with kernel row
//           ky = (oy + P) % S + S t; the same for columns.
//
// What bounds them: arithmetic. Per output pixel the conv does 2 Cin K^2
// (S == 1) or 2 Cin 4 (S > 1) operations per channel; at the fiducial sites
// that is 15 to 26 GFLOP a pass against 0.1 to 0.8 GB of traffic, 20 to 200
// operations per byte, far above the card's f32 ridge (20 operations/byte at
// 67 TFLOP/s and 3.35 TB/s).
//
// Design, simple first (CUDA cores, f32):
//  - stats, fwd, bwd1: one block per (sample, 16 x 64 fine output tile,
//    16 output channels). The input footprint of the tile is staged 8 input
//    channels at a time with its halo, zero outside the image, beside the
//    weights of those channels ([ci][ky][kx][16 co], read as float4 by
//    every thread of a warp at once). Each thread owns 4 pixels x 16
//    channels in registers. stats and bwd1 reduce per block: warp shuffles,
//    then 8 warps in a fixed order.
//  - bwd2: one block per (sample, tile of the input grid) and all output
//    channels. (A) u and du on the fine region the tile's dx needs (the
//    tile's own fine pixels plus the adjoint's halo), kept in shared memory
//    for all channels, 0 outside the image; (B) the weight gradient over the
//    block's own fine pixels (each fine pixel belongs to one block), x
//    staged again per 8 input channels, 4 x 4 (co, ci) a thread per tap;
//    (C) dx of the tile from du, 16 input channels of weights at a time, 4 a
//    thread. du stays in shared memory, so it never reaches device memory.
//    The partial dW is Cout Cin K^2 floats a block (0.55 GB at the 512^2
//    up-convs at batch 24).
// Tensor cores (3xTF32 or bf16 wgmma), larger tiles and keeping u in the
// forward are later work.
//
// Plain C interface, no PyTorch header: built with nvcc into a shared
// library and called through ctypes (baryon_painter_tpu_torch/ops/_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kCob = 16;    // output channels of a forward-type block
constexpr int kCic = 8;     // input channels staged at a time
constexpr int kCic2 = 16;   // input channels of dx weights staged at a time
constexpr int kFTH = 16;    // forward-type tile: 16 x 64 fine pixels
constexpr int kFTW = 64;
constexpr int kFNpx = kFTH * kFTW / kThreads;  // 4 pixels a thread
constexpr int kMaxSmem = 232448;               // bytes a block may use

enum Mode { kStats = 0, kFwd = 1, kBwd1 = 2 };

template <int S, int K>
struct Geo {
  static_assert(S == 1 ? (K % 2 == 1) : (K == 2 * S && S % 2 == 0),
                "unsupported conv family");
  static constexpr int P = S == 1 ? (K - 1) / 2 : S / 2;
  static constexpr int TAPS = S == 1 ? K : 2;  // taps a dimension a pixel
  // largest input footprint of `rn` consecutive fine rows
  __host__ __device__ static constexpr int foot(int rn) {
    return S == 1 ? rn + K - 1 : (rn - 1) / S + 3;
  }
  // bwd2: the dx tile (on the input grid), the fine region R whose du it
  // needs, and R's footprint
  static constexpr int DTH = S == 1 ? 16 : 8 / S;
  static constexpr int DTW = S == 1 ? 32 : 32 / S;
  static constexpr int RH = S == 1 ? 16 + 2 * P : 8 + S;
  static constexpr int RW = S == 1 ? 32 + 2 * P : 32 + S;
  static constexpr int RP = RH * RW;
  static constexpr int RNPX = (RP + kThreads - 1) / kThreads;
  static constexpr int FH = S == 1 ? RH + K - 1 : DTH + 2;
  static constexpr int FW = S == 1 ? RW + K - 1 : DTW + 2;
  static constexpr int OH = S == 1 ? DTH : 8;  // owned fine pixels
  static constexpr int OW = S == 1 ? DTW : 32;
};

// Input footprint of fine rows [r0, r0 + rn): its first row and row count.
template <int S, int K>
__device__ __forceinline__ void footprint(int r0, int rn, int& org,
                                          int& size) {
  constexpr int P = Geo<S, K>::P;
  if (S == 1) {
    org = r0 - P;
    size = rn + K - 1;
  } else {  // r0 + P >= 0 for every region used here
    const int a = (r0 + P) / S;
    org = a - 1;
    size = (r0 + rn - 1 + P) / S - a + 2;
  }
}

// Local footprint coordinate of the first tap of fine row `o` of a region
// whose first row is r0, and (S > 1) its phase (o + P) % S.
template <int S, int K>
__device__ __forceinline__ void tap_origin(int o, int r0, int& l, int& r) {
  constexpr int P = Geo<S, K>::P;
  if (S == 1) {
    l = o - r0;
    r = 0;
  } else {
    l = (o + P) / S - (r0 + P) / S + 1;
    r = (o + P) % S;
  }
}

// Stage x[n][ci0 : ci0 + kCic] on the footprint (org_y, org_x, fh, fw) into
// xs[c][fhm][fwm]; 0 outside the image and for channels past cin.
__device__ __forceinline__ void stage_x(const float* __restrict__ xn,
                                        float* xs, int ci0, int cin, int H,
                                        int W, int org_y, int org_x, int fh,
                                        int fw, int fhm, int fwm) {
  const int plane = fh * fw;
  for (int i = threadIdx.x; i < kCic * plane; i += kThreads) {
    const int c = i / plane;
    const int r = i % plane;
    const int fy = r / fw;
    const int fx = r % fw;
    const int gy = org_y + fy;
    const int gx = org_x + fx;
    float v = 0.f;
    if (ci0 + c < cin && gy >= 0 && gy < H && gx >= 0 && gx < W)
      v = __ldg(xn + ((size_t)(ci0 + c) * H + gy) * W + gx);
    xs[(c * fhm + fy) * fwm + fx] = v;
  }
}

// Weight of (co, ci, ky, kx) in the family's layout.
template <int S, int K>
__device__ __forceinline__ size_t w_index(int co, int ci, int ky, int kx,
                                          int cin, int cout) {
  return S == 1 ? (((size_t)co * cin + ci) * K + ky) * K + kx
                : (((size_t)ci * cout + co) * K + ky) * K + kx;
}

// Stage the weights of input channels ci0.. and output channels co0..co0+15
// as ws[c][ky][kx][16]; 0 past cin or cout.
template <int S, int K>
__device__ __forceinline__ void stage_w(const float* __restrict__ w, float* ws,
                                        int ci0, int co0, int cin, int cout) {
  for (int i = threadIdx.x; i < kCic * K * K * kCob; i += kThreads) {
    const int col = i % kCob;
    const int kk = (i / kCob) % (K * K);
    const int c = i / (kCob * K * K);
    const int ci = ci0 + c;
    const int co = co0 + col;
    ws[i] = (ci < cin && co < cout)
                ? __ldg(w + w_index<S, K>(co, ci, kk / K, kk % K, cin, cout))
                : 0.f;
  }
}

// acc[j][0..15] += the staged chunk's part of u at each of NPX pixels, whose
// first-tap footprint coordinates are (ly, lx) and phases (ry, rx).
template <int S, int K, int NPX>
__device__ __forceinline__ void accumulate_u(const float* xs, const float* ws,
                                             int fhm, int fwm,
                                             const int (&ly)[NPX],
                                             const int (&lx)[NPX],
                                             const int (&ry)[NPX],
                                             const int (&rx)[NPX],
                                             float (&acc)[NPX][kCob]) {
  constexpr int T = Geo<S, K>::TAPS;
  for (int c = 0; c < kCic; ++c) {
    const float* xc = xs + c * fhm * fwm;
    const float* wc = ws + c * K * K * kCob;
#pragma unroll
    for (int ty = 0; ty < T; ++ty) {
#pragma unroll
      for (int tx = 0; tx < T; ++tx) {
        if (S == 1) {  // one tap for every pixel: the weights once
          const float4* w4 =
              reinterpret_cast<const float4*>(wc + (ty * K + tx) * kCob);
          float wr[kCob];
#pragma unroll
          for (int q = 0; q < kCob / 4; ++q) {
            const float4 wq = w4[q];
            wr[4 * q + 0] = wq.x;
            wr[4 * q + 1] = wq.y;
            wr[4 * q + 2] = wq.z;
            wr[4 * q + 3] = wq.w;
          }
#pragma unroll
          for (int j = 0; j < NPX; ++j) {
            const float v = xc[(ly[j] + ty) * fwm + lx[j] + tx];
#pragma unroll
            for (int o = 0; o < kCob; ++o) acc[j][o] += v * wr[o];
          }
        } else {  // the tap's kernel entry follows each pixel's phase
#pragma unroll
          for (int j = 0; j < NPX; ++j) {
            const float v = xc[(ly[j] - ty) * fwm + lx[j] - tx];
            const float4* w4 = reinterpret_cast<const float4*>(
                wc + ((ry[j] + S * ty) * K + rx[j] + S * tx) * kCob);
#pragma unroll
            for (int q = 0; q < kCob / 4; ++q) {
              const float4 wq = w4[q];
              acc[j][4 * q + 0] += v * wq.x;
              acc[j][4 * q + 1] += v * wq.y;
              acc[j][4 * q + 2] += v * wq.z;
              acc[j][4 * q + 3] += v * wq.w;
            }
          }
        }
      }
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The block's sums of s1[c] and s2[c] (per thread) into p1/p2[blk][co0 + c],
// in a fixed order: warp shuffles, then the 8 warps in turn.
__device__ __forceinline__ void block_partials(const float (&s1)[kCob],
                                               const float (&s2)[kCob],
                                               float* red, float* p1,
                                               float* p2, size_t blk, int co0,
                                               int cout) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int c = 0; c < kCob; ++c) {
    const float a = warp_sum(s1[c]);
    const float b = warp_sum(s2[c]);
    if (lane == 0) {
      red[warp * 32 + c] = a;
      red[warp * 32 + kCob + c] = b;
    }
  }
  __syncthreads();
  if (threadIdx.x < 2 * kCob) {
    float s = 0.f;
    for (int wi = 0; wi < kThreads / 32; ++wi) s += red[wi * 32 + threadIdx.x];
    const int c = threadIdx.x % kCob;
    if (co0 + c < cout)
      (threadIdx.x < kCob ? p1 : p2)[blk * cout + co0 + c] = s;
  }
}

template <int S, int K>
constexpr int fwd_smem_floats() {
  return kCic * Geo<S, K>::foot(kFTH) * Geo<S, K>::foot(kFTW) +
         kCic * K * K * kCob + kThreads;
}

// K4-stats, K4-fwd and K4-bwd1: one block per (16 x 64 fine tile, sample x
// group of 16 output channels).
template <int S, int K, int MODE>
__global__ void __launch_bounds__(kThreads)
    fwd_type_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ a, const float* __restrict__ b,
                    const float* __restrict__ mean,
                    const float* __restrict__ inv,
                    const float* __restrict__ dy, float* __restrict__ y,
                    float* __restrict__ p1, float* __restrict__ p2, int cin,
                    int H, int W, int cout) {
  constexpr int FHM = Geo<S, K>::foot(kFTH);
  constexpr int FWM = Geo<S, K>::foot(kFTW);
  extern __shared__ float smem[];
  float* xs = smem;                    // [kCic][FHM][FWM]
  float* ws = xs + kCic * FHM * FWM;   // [kCic][K][K][16]
  float* red = ws + kCic * K * K * kCob;
  const int Ho = H * S;
  const int Wo = W * S;
  const int groups = (cout + kCob - 1) / kCob;
  const int n = blockIdx.z / groups;
  const int co0 = (blockIdx.z % groups) * kCob;
  const int oy0 = blockIdx.y * kFTH;
  const int ox0 = blockIdx.x * kFTW;
  int org_y, fh, org_x, fw;
  footprint<S, K>(oy0, kFTH, org_y, fh);
  footprint<S, K>(ox0, kFTW, org_x, fw);

  int ly[kFNpx], lx[kFNpx], ry[kFNpx], rx[kFNpx], oy[kFNpx], ox[kFNpx];
#pragma unroll
  for (int j = 0; j < kFNpx; ++j) {
    const int idx = threadIdx.x + j * kThreads;
    oy[j] = oy0 + idx / kFTW;
    ox[j] = ox0 + idx % kFTW;
    tap_origin<S, K>(oy[j], oy0, ly[j], ry[j]);
    tap_origin<S, K>(ox[j], ox0, lx[j], rx[j]);
  }
  float acc[kFNpx][kCob];
#pragma unroll
  for (int j = 0; j < kFNpx; ++j)
#pragma unroll
    for (int c = 0; c < kCob; ++c) acc[j][c] = 0.f;

  const float* xn = x + (size_t)n * cin * H * W;
  for (int ci0 = 0; ci0 < cin; ci0 += kCic) {
    stage_x(xn, xs, ci0, cin, H, W, org_y, org_x, fh, fw, FHM, FWM);
    stage_w<S, K>(w, ws, ci0, co0, cin, cout);
    __syncthreads();
    accumulate_u<S, K, kFNpx>(xs, ws, FHM, FWM, ly, lx, ry, rx, acc);
    __syncthreads();
  }

  if (MODE == kFwd) {
#pragma unroll
    for (int c = 0; c < kCob; ++c) {
      const int co = co0 + c;
      if (co >= cout) break;
      const float ac = __ldg(a + co);
      const float bc = __ldg(b + co);
      float* yc = y + ((size_t)n * cout + co) * Ho * Wo;
#pragma unroll
      for (int j = 0; j < kFNpx; ++j)
        if (oy[j] < Ho && ox[j] < Wo)
          yc[(size_t)oy[j] * Wo + ox[j]] = fmaxf(acc[j][c] * ac + bc, 0.f);
    }
    return;
  }

  float s1[kCob], s2[kCob];
#pragma unroll
  for (int c = 0; c < kCob; ++c) {
    s1[c] = 0.f;
    s2[c] = 0.f;
    const int co = co0 + c;
    if (co >= cout) continue;
    if (MODE == kStats) {
#pragma unroll
      for (int j = 0; j < kFNpx; ++j)
        if (oy[j] < Ho && ox[j] < Wo) {
          s1[c] += acc[j][c];
          s2[c] += acc[j][c] * acc[j][c];
        }
    } else {  // kBwd1
      const float ac = __ldg(a + co);
      const float bc = __ldg(b + co);
      const float mc = __ldg(mean + co);
      const float ic = __ldg(inv + co);
      const float* dyc = dy + ((size_t)n * cout + co) * Ho * Wo;
#pragma unroll
      for (int j = 0; j < kFNpx; ++j)
        if (oy[j] < Ho && ox[j] < Wo) {
          const float u = acc[j][c];
          const float dv = u * ac + bc > 0.f
                               ? __ldg(dyc + (size_t)oy[j] * Wo + ox[j])
                               : 0.f;
          s1[c] += dv;
          s2[c] += dv * ((u - mc) * ic);
        }
    }
  }
  const size_t blk = (size_t)n * gridDim.x * gridDim.y +
                     (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  block_partials(s1, s2, red, p1, p2, blk, co0, cout);
}

template <int S, int K>
constexpr int bwd2_smem_floats(int cout) {
  using G = Geo<S, K>;
  const int cpad = (cout + kCob - 1) / kCob * kCob;
  const int stage = kCic * G::FH * G::FW + kCic * K * K * kCob;
  const int wdx = cout * K * K * kCic2;
  return cpad * G::RP + (stage > wdx ? stage : wdx);
}

// K4-bwd2: one block per (tile of the input grid, sample), all channels.
template <int S, int K>
__global__ void __launch_bounds__(kThreads)
    bwd2_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ a, const float* __restrict__ b,
                const float* __restrict__ mean, const float* __restrict__ inv,
                const float* __restrict__ s1n, const float* __restrict__ s2n,
                const float* __restrict__ dy, float* __restrict__ dx,
                float* __restrict__ dwp, int cin, int H, int W, int cout) {
  using G = Geo<S, K>;
  constexpr int P = G::P;
  constexpr int NPX = G::RNPX;
  extern __shared__ float smem[];
  const int cpad = (cout + kCob - 1) / kCob * kCob;
  float* dus = smem;                 // [cpad][RP]: du on the region R
  float* xs = dus + cpad * G::RP;    // [kCic][FH][FW]
  float* ws = xs + kCic * G::FH * G::FW;  // [kCic][K][K][16]
  float* wdx = xs;                   // [cout][K][K][kCic2], stage C only
  const int Ho = H * S;
  const int Wo = W * S;
  const int n = blockIdx.z;
  const int dy0 = blockIdx.y * G::DTH;  // the dx tile, on the input grid
  const int dx0 = blockIdx.x * G::DTW;
  // R's first fine row and column
  const int r0y = S == 1 ? dy0 - P : S * dy0 - P;
  const int r0x = S == 1 ? dx0 - P : S * dx0 - P;
  int org_y, fh, org_x, fw;
  footprint<S, K>(r0y, G::RH, org_y, fh);
  footprint<S, K>(r0x, G::RW, org_x, fw);
  const float* xn = x + (size_t)n * cin * H * W;

  // (A) du on R for every output channel, 16 at a time
  {
    int ly[NPX], lx[NPX], ry[NPX], rx[NPX];
#pragma unroll
    for (int j = 0; j < NPX; ++j) {
      int r = threadIdx.x + j * kThreads;
      if (r >= G::RP) r = 0;  // computed, never stored
      tap_origin<S, K>(r0y + r / G::RW, r0y, ly[j], ry[j]);
      tap_origin<S, K>(r0x + r % G::RW, r0x, lx[j], rx[j]);
    }
    for (int co0 = 0; co0 < cout; co0 += kCob) {
      float acc[NPX][kCob];
#pragma unroll
      for (int j = 0; j < NPX; ++j)
#pragma unroll
        for (int c = 0; c < kCob; ++c) acc[j][c] = 0.f;
      for (int ci0 = 0; ci0 < cin; ci0 += kCic) {
        stage_x(xn, xs, ci0, cin, H, W, org_y, org_x, fh, fw, G::FH, G::FW);
        stage_w<S, K>(w, ws, ci0, co0, cin, cout);
        __syncthreads();
        accumulate_u<S, K, NPX>(xs, ws, G::FH, G::FW, ly, lx, ry, rx, acc);
        __syncthreads();
      }
#pragma unroll
      for (int c = 0; c < kCob; ++c) {
        const int co = co0 + c;
        if (co >= cout) break;
        const float ac = __ldg(a + co);
        const float bc = __ldg(b + co);
        const float mc = __ldg(mean + co);
        const float ic = __ldg(inv + co);
        const float m1 = __ldg(s1n + co);
        const float m2 = __ldg(s2n + co);
        const float* dyc = dy + ((size_t)n * cout + co) * Ho * Wo;
#pragma unroll
        for (int j = 0; j < NPX; ++j) {
          const int r = threadIdx.x + j * kThreads;
          if (r >= G::RP) continue;
          const int oy = r0y + r / G::RW;
          const int ox = r0x + r % G::RW;
          float du = 0.f;  // the adjoint's zero padding
          if (oy >= 0 && oy < Ho && ox >= 0 && ox < Wo) {
            const float u = acc[j][c];
            const float dv = u * ac + bc > 0.f
                                 ? __ldg(dyc + (size_t)oy * Wo + ox)
                                 : 0.f;
            du = ac * (dv - m1 - (u - mc) * ic * m2);
          }
          dus[co * G::RP + r] = du;
        }
      }
    }
  }

  // (B) the block's partial dW over its own fine pixels; each thread a tap
  // and 4 x 4 (co, ci), the tap slowest so a warp shares it
  float* dwb = dwp + ((size_t)n * gridDim.x * gridDim.y +
                      (size_t)blockIdx.y * gridDim.x + blockIdx.x) *
                         cout * cin * K * K;
  const int nco4 = (cout + 3) / 4;
  constexpr int nci4 = kCic / 4;
  for (int ci0 = 0; ci0 < cin; ci0 += kCic) {
    stage_x(xn, xs, ci0, cin, H, W, org_y, org_x, fh, fw, G::FH, G::FW);
    __syncthreads();
    for (int t = threadIdx.x; t < K * K * nco4 * nci4; t += kThreads) {
      const int inner = t % (nco4 * nci4);
      const int kk = t / (nco4 * nci4);
      const int ky = kk / K;
      const int kx = kk % K;
      const int co4 = (inner % nco4) * 4;
      const int ci4 = (inner / nco4) * 4;
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;
      // owned fine pixels that meet this tap: R-local (ru, rv) and
      // footprint-local (fu, fv) of their x tap
      int ry0, rx0, fy0, fx0, step, nh, nw;
      if (S == 1) {
        ry0 = P; rx0 = P; fy0 = ky + P; fx0 = kx + P;
        step = 1; nh = G::OH; nw = G::OW;
      } else {
        const int phy = ((ky - P) % S + S) % S;
        const int phx = ((kx - P) % S + S) % S;
        ry0 = phy + P; rx0 = phx + P;
        fy0 = (phy + P - ky) / S + 1; fx0 = (phx + P - kx) / S + 1;
        step = S; nh = G::DTH; nw = G::DTW;
      }
      for (int u = 0; u < nh; ++u) {
        const float* dr = dus + (ry0 + step * u) * G::RW + rx0;
        const float* xr = xs + (fy0 + u) * G::FW + fx0;
        for (int v = 0; v < nw; ++v) {
          float d[4], xv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            d[i] = dr[(co4 + i) * G::RP + step * v];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            xv[q] = xr[(ci4 + q) * G::FH * G::FW + v];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[i][q] += d[i] * xv[q];
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int co = co4 + i;
          const int ci = ci0 + ci4 + q;
          if (co < cout && ci < cin)
            dwb[w_index<S, K>(co, ci, ky, kx, cin, cout)] = acc[i][q];
        }
    }
    __syncthreads();
  }

  // (C) dx on the tile, 16 input channels of weights at a time, each
  // thread one pixel x 4 channels
  constexpr int NDX = G::DTH * G::DTW;
  for (int ci0 = 0; ci0 < cin; ci0 += kCic2) {
    for (int i = threadIdx.x; i < cout * K * K * kCic2; i += kThreads) {
      const int c = i % kCic2;
      const int kk = (i / kCic2) % (K * K);
      const int co = i / (kCic2 * K * K);
      wdx[i] = ci0 + c < cin ? __ldg(w + w_index<S, K>(co, ci0 + c, kk / K,
                                                        kk % K, cin, cout))
                             : 0.f;
    }
    __syncthreads();
    for (int t = threadIdx.x; t < NDX * (kCic2 / 4); t += kThreads) {
      const int pix = t % NDX;
      const int cg = t / NDX;
      const int py = pix / G::DTW;
      const int px = pix % G::DTW;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int co = 0; co < cout; ++co) {
        const float* dc = dus + co * G::RP;
        const float* wc = wdx + co * K * K * kCic2 + cg * 4;
#pragma unroll
        for (int ky = 0; ky < K; ++ky)
#pragma unroll
          for (int kx = 0; kx < K; ++kx) {
            // S == 1: du at (y + P - ky); S > 1: du at (S iy - P + ky)
            const int ru = S == 1 ? py + 2 * P - ky : S * py + ky;
            const int rv = S == 1 ? px + 2 * P - kx : S * px + kx;
            const float g = dc[ru * G::RW + rv];
            const float4 w4 =
                *reinterpret_cast<const float4*>(wc + (ky * K + kx) * kCic2);
            acc[0] += g * w4.x;
            acc[1] += g * w4.y;
            acc[2] += g * w4.z;
            acc[3] += g * w4.w;
          }
      }
      const int iy = dy0 + py;
      const int ix = dx0 + px;
      if (iy < H && ix < W)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int ci = ci0 + cg * 4 + q;
          if (ci < cin) dx[(((size_t)n * cin + ci) * H + iy) * W + ix] = acc[q];
        }
    }
    __syncthreads();
  }
}

template <int V>
using IC = std::integral_constant<int, V>;

// f(IC<S>, IC<K>) for the supported (stride, kernel) pairs; -1 otherwise.
template <typename F>
int dispatch(int s, int k, F&& f) {
  if (s == 1 && k == 1) return f(IC<1>{}, IC<1>{});
  if (s == 1 && k == 3) return f(IC<1>{}, IC<3>{});
  if (s == 1 && k == 5) return f(IC<1>{}, IC<5>{});
  if (s == 1 && k == 7) return f(IC<1>{}, IC<7>{});
  if (s == 2 && k == 4) return f(IC<2>{}, IC<4>{});
  if (s == 4 && k == 8) return f(IC<4>{}, IC<8>{});
  return -1;
}

template <int S, int K, int MODE>
int launch_fwd_type(const float* x, const float* w, const float* a,
                    const float* b, const float* mean, const float* inv,
                    const float* dy, float* y, float* p1, float* p2, int n,
                    int cin, int h, int wd, int cout, cudaStream_t stream) {
  const int smem = fwd_smem_floats<S, K>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fwd_type_kernel<S, K, MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((wd * S + kFTW - 1) / kFTW, (h * S + kFTH - 1) / kFTH,
                  n * ((cout + kCob - 1) / kCob));
  fwd_type_kernel<S, K, MODE><<<grid, kThreads, smem, stream>>>(
      x, w, a, b, mean, inv, dy, y, p1, p2, cin, h, wd, cout);
  return (int)cudaGetLastError();
}

bool dims_ok(int n, int cin, int h, int w, int cout) {
  return n > 0 && cin > 0 && h > 0 && w > 0 && cout > 0 &&
         (long long)n * ((cout + kCob - 1) / kCob) <= 65535;
}

}  // namespace

extern "C" {

// Spatial blocks a sample of the stats/fwd/bwd1 launches (the rows of their
// partials per sample): (h, w) is the input, s the stride (1: "same" conv).
int bpt_conv_bn_fwd_tiles(int h, int w, int s) {
  return ((w * s + kFTW - 1) / kFTW) * ((h * s + kFTH - 1) / kFTH);
}

// Spatial blocks a sample of the bwd2 launch (its partial dW rows).
int bpt_conv_bn_bwd2_tiles(int h, int w, int k, int s) {
  return dispatch(s, k, [&](auto S_, auto K_) {
    using G = Geo<decltype(S_)::value, decltype(K_)::value>;
    return ((h + G::DTH - 1) / G::DTH) * ((w + G::DTW - 1) / G::DTW);
  });
}

// Shared memory of one bwd2 block in bytes; -1 for an unsupported (k, s).
int bpt_conv_bn_bwd2_smem(int cout, int k, int s) {
  return dispatch(s, k, [&](auto S_, auto K_) {
    return bwd2_smem_floats<decltype(S_)::value, decltype(K_)::value>(cout) *
           (int)sizeof(float);
  });
}

// x (N, Cin, H, W), w OIHW (s == 1) or IOHW (s > 1); p1, p2 (N * tiles,
// Cout) with tiles = bpt_conv_bn_fwd_tiles. All f32, contiguous. Returns the
// cudaError_t of the launch (0 on success); asynchronous on `stream`.
int bpt_conv_bn_stats(const void* x, const void* w, void* p1, void* p2, int n,
                      int cin, int h, int wd, int cout, int k, int s,
                      void* stream) {
  if (!dims_ok(n, cin, h, wd, cout)) return (int)cudaErrorInvalidValue;
  const int r = dispatch(s, k, [&](auto S_, auto K_) {
    return launch_fwd_type<decltype(S_)::value, decltype(K_)::value, kStats>(
        static_cast<const float*>(x), static_cast<const float*>(w), nullptr,
        nullptr, nullptr, nullptr, nullptr, nullptr, static_cast<float*>(p1),
        static_cast<float*>(p2), n, cin, h, wd, cout,
        static_cast<cudaStream_t>(stream));
  });
  return r < 0 ? (int)cudaErrorInvalidValue : r;
}

// As above with a, b (Cout); writes y (N, Cout, s H, s W).
int bpt_conv_bn_fwd(const void* x, const void* w, const void* a,
                    const void* b, void* y, int n, int cin, int h, int wd,
                    int cout, int k, int s, void* stream) {
  if (!dims_ok(n, cin, h, wd, cout)) return (int)cudaErrorInvalidValue;
  const int r = dispatch(s, k, [&](auto S_, auto K_) {
    return launch_fwd_type<decltype(S_)::value, decltype(K_)::value, kFwd>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(a), static_cast<const float*>(b), nullptr,
        nullptr, nullptr, static_cast<float*>(y), nullptr, nullptr, n, cin,
        h, wd, cout, static_cast<cudaStream_t>(stream));
  });
  return r < 0 ? (int)cudaErrorInvalidValue : r;
}

// As stats, with a, b, mean, inv (Cout) and dy (N, Cout, s H, s W): the
// partial sums of dv (p1) and dv * uhat (p2).
int bpt_conv_bn_bwd1(const void* x, const void* w, const void* a,
                     const void* b, const void* mean, const void* inv,
                     const void* dy, void* p1, void* p2, int n, int cin,
                     int h, int wd, int cout, int k, int s, void* stream) {
  if (!dims_ok(n, cin, h, wd, cout)) return (int)cudaErrorInvalidValue;
  const int r = dispatch(s, k, [&](auto S_, auto K_) {
    return launch_fwd_type<decltype(S_)::value, decltype(K_)::value, kBwd1>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<const float*>(mean), static_cast<const float*>(inv),
        static_cast<const float*>(dy), nullptr, static_cast<float*>(p1),
        static_cast<float*>(p2), n, cin, h, wd, cout,
        static_cast<cudaStream_t>(stream));
  });
  return r < 0 ? (int)cudaErrorInvalidValue : r;
}

// As bwd1, with s1n = S1 / count and s2n = S2 / count (Cout); writes dx
// (N, Cin, H, W) and dwp (N * tiles, w's shape) with tiles =
// bpt_conv_bn_bwd2_tiles.
int bpt_conv_bn_bwd2(const void* x, const void* w, const void* a,
                     const void* b, const void* mean, const void* inv,
                     const void* s1n, const void* s2n, const void* dy,
                     void* dx, void* dwp, int n, int cin, int h, int wd,
                     int cout, int k, int s, void* stream) {
  if (!dims_ok(n, cin, h, wd, cout)) return (int)cudaErrorInvalidValue;
  const int r = dispatch(s, k, [&](auto S_, auto K_) {
    constexpr int S = decltype(S_)::value;
    constexpr int K = decltype(K_)::value;
    using G = Geo<S, K>;
    const int smem = bwd2_smem_floats<S, K>(cout) * (int)sizeof(float);
    if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        bwd2_kernel<S, K>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((wd + G::DTW - 1) / G::DTW, (h + G::DTH - 1) / G::DTH, n);
    bwd2_kernel<S, K><<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<const float*>(mean), static_cast<const float*>(inv),
        static_cast<const float*>(s1n), static_cast<const float*>(s2n),
        static_cast<const float*>(dy), static_cast<float*>(dx),
        static_cast<float*>(dwp), cin, h, wd, cout);
    return (int)cudaGetLastError();
  });
  return r < 0 ? (int)cudaErrorInvalidValue : r;
}

}  // extern "C"
