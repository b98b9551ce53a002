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
// given slope. The weights arrive as w^T (C, 3, 3, C) = (co, ky, kx, ci) in
// T, which the wrapper makes from the HWIO kernel. Sums are f32. The
// intermediate is rounded to T before the second conv, as the TPU kernel
// does, and never leaves shared memory; zeros outside the image are
// conv2's padding.
//
// What bounds it: one launch does 2 * 2*N*H*W*C*C*9 operations (38.7 GFLOP
// at the painting shape (16, 64, 64, 128)) against about 2*N*H*W*C*sizeof(T)
// bytes, so the tensor cores: >= 0.234 ms in f32 as 3xTF32 (495/3 TFLOP/s),
// >= 0.039 ms in bf16 (989 TFLOP/s).
//
// Design: each conv is an implicit GEMM on the tensor cores, M = pixels,
// N = C output channels (at most 128, all in one block), K = 9 taps x C
// input channels, in K chunks of one tap x KC channels (KC = 64 in f32, 128
// in bf16; C is zero-padded to CP, a multiple of KC, in shared memory).
//   - f32: 3xTF32 on mma.sync.m16n8k8: each operand v is split into a
//     tf32 big and small = v - big as its fragment is loaded (split_tf32),
//     and small*big + big*small + big*big accumulate in f32.
//   - bf16: mma.sync.m16n8k16 with f32 accumulation (the products of two
//     bf16 values are exact in f32).
//   - The tensor cores' accumulators truncate, so each K chunk's product
//     sums from zero and is added into an f32 sum by an ordinary add.
//   - One block of 8 warps per (sample, 8 x 16 output tile). x is staged
//     once with its 2-pixel halo (12 x 20 pixels, pixel-major, rows padded
//     by 16 bytes so a warp's fragment loads hit 32 banks) with cp.async.
//     conv1 runs on the 10 x 18 region conv2 needs (1.41x conv1's work,
//     against 1.56x for an 8 x 8 tile) in two passes of 96 pixels; a warp
//     owns 3 m16 tiles x 32 channels a pass (2 x 4 warps). Its output h is
//     written over the staged x: pass 1's 96 pixels land on x slots that
//     pass 2 no longer reads, pass 2's after a barrier. So shared memory
//     holds one tile region (127 KB in f32 at C = 128), not x and h side
//     by side (215 KB), and the residual is read from device memory (L2)
//     in the epilogue. conv2 (128 pixels, 4 m16 tiles x 32 channels a
//     warp) then reads h and writes out.
//   - The weights stream through a cp.async ring of K chunks (C rows x KC,
//     35 KB a stage): 2 stages in f32, 3 in bf16, a chunk in flight while
//     the one before is multiplied; they are read from L2 once per pass (3
//     passes a block). The time is in this staging and its barriers more
//     than in the products (PERF.md section 6), so the chunks are large:
//     they ran faster than chunks half as large with deeper rings.
//
// Plain C interface, no PyTorch header: built with nvcc into a shared
// library and called through ctypes (baryon_painter_tpu_torch/ops/_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

constexpr int kTH = 8;                  // output tile: 8 rows x 16 columns
constexpr int kTW = 16;
constexpr int kMW = kTW + 2;            // conv1 region: 10 x 18
constexpr int kMPix = (kTH + 2) * kMW;
constexpr int kXW = kTW + 4;            // staged x: 12 x 20
constexpr int kXPix = (kTH + 4) * kXW;
constexpr int kThreads = 256;
constexpr int kCMax = 128;              // output channels (all in one block)
// m16 tiles a warp owns: conv1, a pass (2 passes x 2 x 3 x 16 >= 180
// pixels); conv2 (2 x 4 x 16 = 128 pixels)
constexpr int kMT1 = 3;
constexpr int kMT2 = 4;

// KC: input channels a K chunk; KSTEP: the mma's k; PAD: row padding in
// elements (16 bytes), so rows start 4 banks apart; STAGES: weight ring depth
template <typename T>
struct Elt;
template <>
struct Elt<float> {
  static constexpr int KC = 64, KSTEP = 8, PAD = 4, STAGES = 2;
};
template <>
struct Elt<__nv_bfloat16> {
  static constexpr int KC = 128, KSTEP = 16, PAD = 8, STAGES = 3;
};

__device__ __forceinline__ uint32_t word(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Fragments and one m16n8 product of the type: A rows at element offsets
// r0 (row g), r1 (row g + 8), B row (output channel) at element offset nb,
// both at the K offset of the k-step; tig = lane % 4.
template <typename T>
struct Mma;

template <>
struct Mma<float> {
  struct A {
    uint32_t h[4], l[4];
  };
  struct B {
    uint32_t h[2], l[2];
  };
  __device__ __forceinline__ static void load_a(A& a, const float* s, int r0,
                                                int r1, int tig) {
    split_tf32(s[r0 + tig], a.h[0], a.l[0]);
    split_tf32(s[r1 + tig], a.h[1], a.l[1]);
    split_tf32(s[r0 + tig + 4], a.h[2], a.l[2]);
    split_tf32(s[r1 + tig + 4], a.h[3], a.l[3]);
  }
  __device__ __forceinline__ static void load_b(B& b, const float* s, int nb,
                                                int tig) {
    split_tf32(s[nb + tig], b.h[0], b.l[0]);
    split_tf32(s[nb + tig + 4], b.h[1], b.l[1]);
  }
  // 3xTF32: small a x big b + big a x small b + big a x big b
  __device__ __forceinline__ static void mma(float (&c)[4], const A& a,
                                             const B& b) {
    mma_tf32(c, a.l, b.h);
    mma_tf32(c, a.h, b.l);
    mma_tf32(c, a.h, b.h);
  }
};

template <>
struct Mma<__nv_bfloat16> {
  struct A {
    uint32_t h[4];
  };
  struct B {
    uint32_t h[2];
  };
  __device__ __forceinline__ static void load_a(A& a, const __nv_bfloat16* s,
                                                int r0, int r1, int tig) {
    a.h[0] = word(s + r0 + 2 * tig);
    a.h[1] = word(s + r1 + 2 * tig);
    a.h[2] = word(s + r0 + 2 * tig + 8);
    a.h[3] = word(s + r1 + 2 * tig + 8);
  }
  __device__ __forceinline__ static void load_b(B& b, const __nv_bfloat16* s,
                                                int nb, int tig) {
    b.h[0] = word(s + nb + 2 * tig);
    b.h[1] = word(s + nb + 2 * tig + 8);
  }
  __device__ __forceinline__ static void mma(float (&c)[4], const A& a,
                                             const B& b) {
    mma_bf16(c, a.h, b.h);
  }
};

// 4 consecutive channels, asynchronously: 16 bytes of f32, 8 of bf16
__device__ __forceinline__ void copy4(float* d, const float* s, bool ok) {
  cp_async16(d, s, ok);
}
__device__ __forceinline__ void copy4(__nv_bfloat16* d,
                                      const __nv_bfloat16* s, bool ok) {
  cp_async8(d, s, ok);
}

// 2 consecutive channels of device memory as f32, and back as T
__device__ __forceinline__ float2 load2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(
      __ldg(reinterpret_cast<const __nv_bfloat162*>(p)));
}
// rounds to nearest even, as a cast to bfloat16 does in JAX and PyTorch
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ float leaky(float h, float slope) {
  return h >= 0.f ? h : h * slope;
}

// One pass of a 3x3 conv as an implicit GEMM: the pixels [p0, p0 + 2 MT
// 16) of a region of width dw and npix pixels (warp slot wm takes MT m16
// tiles of them, wn its 32 output channels), reading the shared source
// region `src` of width sw = dw + 2 (row stride ldx elements), whose pixel
// (r + ky, c + kx) is tap (ky, kx) of region pixel (r, c). The weights wt
// (C, 9, C) stream through `ring`. sum[i][j] gets the f32 C fragment of
// m16 tile i and n8 tile j. Rows past npix compute pixel p0 and are
// discarded by the caller. Ends behind a barrier: src and the ring are
// free.
template <typename T, int MT>
__device__ __forceinline__ void conv_pass(const T* src, int sw, int dw,
                                          int npix, int p0,
                                          const T* __restrict__ wt, int C,
                                          int CP, T* ring,
                                          float (&sum)[MT][4][4]) {
  using E = Elt<T>;
  using M = Mma<T>;
  constexpr int LDW = E::KC + E::PAD;
  constexpr int Q = E::KC / 4;  // 4-channel copies a weight row
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int wm = warp >> 2;
  const int wn = warp & 3;
  const int ldx = CP + E::PAD;
  const int ng = CP / E::KC;
  const int nchunks = 9 * ng;
  // n8 tiles of this warp that hold output channels (all 4 at C = 128)
  int nj = (C - 32 * wn + 7) / 8;
  nj = nj < 0 ? 0 : (nj > 4 ? 4 : nj);

  int arow[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int p = p0 + (wm * MT + i) * 16 + g + 8 * h;
      if (p >= npix) p = p0;
      arow[i][h] = ((p / dw) * sw + p % dw) * ldx;
    }
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sum[i][j][e] = 0.f;

  // chunk c = (tap, group of KC input channels) of all output channels
  auto issue = [&](int c) {
    const int tap = c / ng;
    const int ci0 = (c - tap * ng) * E::KC;
    T* dst = ring + (c % E::STAGES) * kCMax * LDW;
    for (int i = threadIdx.x; i < kCMax * Q; i += kThreads) {
      const int co = i / Q;
      const int ci = ci0 + 4 * (i - co * Q);
      const bool ok = co < C && ci < C;
      copy4(dst + co * LDW + ci - ci0,
            ok ? wt + ((size_t)co * 9 + tap) * C + ci : wt, ok);
    }
  };
#pragma unroll
  for (int s = 0; s < E::STAGES - 1; ++s) {
    if (s < nchunks) issue(s);
    cp_async_commit();
  }
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<E::STAGES - 2>();  // chunk c (and the staged x) landed
    __syncthreads();                 // for every thread; step c - 1 done
    if (c + E::STAGES - 1 < nchunks) issue(c + E::STAGES - 1);
    cp_async_commit();
    if (nj == 0) continue;
    const T* ws = ring + (c % E::STAGES) * kCMax * LDW;
    const int tap = c / ng;
    const int toff =
        ((tap / 3) * sw + tap % 3) * ldx + (c - tap * ng) * E::KC;
    float part[MT][4][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < E::KC; kk += E::KSTEP) {
      typename M::A a[MT];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        M::load_a(a[i], src, arow[i][0] + toff + kk, arow[i][1] + toff + kk,
                  tig);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j < nj) {
          typename M::B b;
          M::load_b(b, ws, (32 * wn + 8 * j + g) * LDW + kk, tig);
#pragma unroll
          for (int i = 0; i < MT; ++i) M::mma(part[i][j], a[i], b);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sum[i][j][e] += part[i][j][e];
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    res_block_kernel(const T* __restrict__ x, const T* __restrict__ w1t,
                     const float* __restrict__ s1,
                     const float* __restrict__ b1, const T* __restrict__ w2t,
                     const float* __restrict__ s2,
                     const float* __restrict__ b2, T* __restrict__ out, int H,
                     int W, int C, int CP, float inner_slope,
                     float outer_slope) {
  using E = Elt<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldx = CP + E::PAD;
  T* xs = reinterpret_cast<T*>(smem_raw);  // [kXPix][ldx]; then h [kMPix][ldx]
  T* ring = xs + kXPix * ldx;  // [STAGES][kCMax][KC + PAD]

  const int n = blockIdx.z;
  const int ty0 = blockIdx.y * kTH;
  const int tx0 = blockIdx.x * kTW;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int wm = warp >> 2;
  const int wn = warp & 3;
  const T* xn = x + (size_t)n * H * W * C;

  // 1. stage x with its 2-pixel halo; zeros outside the image are conv1's
  //    padding, and channels past C are zero
  const int q4 = CP / 4;
  for (int i = threadIdx.x; i < kXPix * q4; i += kThreads) {
    const int pix = i / q4;
    const int ci = 4 * (i - pix * q4);
    const int gy = ty0 - 2 + pix / kXW;
    const int gx = tx0 - 2 + pix % kXW;
    const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W && ci < C;
    copy4(xs + pix * ldx + ci, ok ? xn + ((size_t)gy * W + gx) * C + ci : xn,
          ok);
  }
  cp_async_commit();

  // 2. conv1 + bn1 + act_i on the 10 x 18 region in two passes, h rounded
  //    to T over the staged x. Outside the image h is 0: conv2's padding.
  for (int pass = 0; pass < 2; ++pass) {
    const int p0 = pass * 2 * kMT1 * 16;
    float sum[kMT1][4][4];
    conv_pass<T, kMT1>(xs, kXW, kMW, kMPix, p0, w1t, C, CP, ring, sum);
#pragma unroll
    for (int i = 0; i < kMT1; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = p0 + (wm * kMT1 + i) * 16 + g + 8 * h;
        if (p >= kMPix) continue;
        const int gy = ty0 - 1 + p / kMW;
        const int gx = tx0 - 1 + p % kMW;
        const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int co = 32 * wn + 8 * j + 2 * tig;
          if (co >= CP) continue;
          float v[2] = {0.f, 0.f};
          if (in && co < C) {
#pragma unroll
            for (int e = 0; e < 2; ++e)
              v[e] = leaky(sum[i][j][2 * h + e] * __ldg(s1 + co + e) +
                               __ldg(b1 + co + e),
                           inner_slope);
          }
          store2(xs + p * ldx + co, v[0], v[1]);
        }
      }
  }

  // 3. conv2 + bn2 + residual + act_o on the 8 x 16 tile, one write of out
  float sum[kMT2][4][4];
  conv_pass<T, kMT2>(xs, kMW, kTW, kTH * kTW, 0, w2t, C, CP, ring, sum);
  T* outn = out + (size_t)n * H * W * C;
#pragma unroll
  for (int i = 0; i < kMT2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = (wm * kMT2 + i) * 16 + g + 8 * h;
      const int gy = ty0 + p / kTW;
      const int gx = tx0 + p % kTW;
      if (gy >= H || gx >= W) continue;
      const size_t pix = ((size_t)gy * W + gx) * C;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int co = 32 * wn + 8 * j + 2 * tig;
        if (co >= C) continue;
        const float2 res = load2(xn + pix + co);
        const float r[2] = {res.x, res.y};
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          v[e] = leaky(sum[i][j][2 * h + e] * __ldg(s2 + co + e) +
                           __ldg(b2 + co + e) + r[e],
                       outer_slope);
        store2(outn + pix + co, v[0], v[1]);
      }
    }
}

template <typename T>
size_t smem_bytes(int c) {
  using E = Elt<T>;
  const int cp = (c + E::KC - 1) / E::KC * E::KC;
  return ((size_t)kXPix * (cp + E::PAD) +
          (size_t)E::STAGES * kCMax * (E::KC + E::PAD)) *
         sizeof(T);
}

template <typename T>
cudaError_t launch(const void* x, const void* w1t, const void* s1,
                   const void* b1, const void* w2t, const void* s2,
                   const void* b2, void* out, int n, int h, int w, int c,
                   float inner_slope, float outer_slope,
                   cudaStream_t stream) {
  const int cp = (c + Elt<T>::KC - 1) / Elt<T>::KC * Elt<T>::KC;
  const size_t smem = smem_bytes<T>(c);
  cudaError_t err = cudaFuncSetAttribute(
      res_block_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((w + kTW - 1) / kTW, (h + kTH - 1) / kTH, n);
  res_block_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1t),
      static_cast<const float*>(s1), static_cast<const float*>(b1),
      static_cast<const T*>(w2t), static_cast<const float*>(s2),
      static_cast<const float*>(b2), static_cast<T*>(out), h, w, c, cp,
      inner_slope, outer_slope);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, out (N, H, W, C) and w1t, w2t (C, 3, 3, C) in the type `dtype`
// (0 = float32, 1 = bfloat16), s/b (C,) f32, all contiguous; 4 <= C <= 128,
// C % 4 == 0. Returns the cudaError_t of the launch (0 on success); the
// launch is asynchronous on `stream`.
int bpt_res_block_infer(const void* x, const void* w1t, const void* s1,
                        const void* b1, const void* w2t, const void* s2,
                        const void* b2, void* out, int n, int h, int w, int c,
                        float inner_slope, float outer_slope, int dtype,
                        void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || c % 4 != 0 || c > kCMax ||
      n > 65535 || (h + kTH - 1) / kTH > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(x, w1t, s1, b1, w2t, s2, b2, out, n, h, w, c,
                              inner_slope, outer_slope, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, w1t, s1, b1, w2t, s2, b2, out, n,
                                      h, w, c, inner_slope, outer_slope, s);
  return (int)cudaErrorInvalidValue;
}

// Shared memory per block of a launch (bytes), for the kernel report.
int bpt_res_block_smem(int c, int dtype) {
  return (int)(dtype == 0 ? smem_bytes<float>(c)
                          : smem_bytes<__nv_bfloat16>(c));
}

const char* bpt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
