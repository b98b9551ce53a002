// K1: the fused inference residual block, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `res_block_infer` of
// baryon_painter_tpu/ops/pallas_conv.py (kernel body `_res_block_kernel`):
//
//   h   = round_T(act_i(s1 * conv3x3(x, w1) + b1))
//   out = round_T(act_o(s2 * conv3x3(h, w2) + b2 + x))
//
// x and out are NHWC, w1/w2 HWIO (3, 3, C, C) in x's type T (float or
// bfloat16), s/b the batch norm folded to per-channel f32 scale and bias,
// act a (leaky) ReLU with the given slope. Sums are f32. The intermediate is
// rounded to T before the second conv, as the TPU kernel does.
//
// What bounds it: one launch does 2 * 2*N*H*W*C*C*9 operations and moves
// about 2*N*H*W*C*sizeof(T) bytes; at the painting shape (16, 64, 64, 128) in
// f32 that is 38.7 GFLOP against 68 MB, ~570 operations per byte, so it is
// bound by arithmetic (f32 on the CUDA cores: >= 0.58 ms at 67 TFLOP/s).
//
// Design, simple first: one thread block per (sample, 8x8 output tile). The
// input tile with a 2-pixel halo (12x12xC) is staged in shared memory once,
// as f32 whatever T is, so the inner loop converts only the weights.
// conv1 is evaluated on the 10x10 region that conv2 needs (the 1-pixel halo
// is recomputed by the neighbouring blocks) and kept in shared memory, so the
// intermediate activation never goes to device memory; then conv2, the
// residual and the activation, and one write of the output tile. Each thread
// owns 4 output channels of up to PPT pixels: one weight load (16 bytes in
// f32) serves all its pixels, one shared-memory broadcast serves its 4
// channels. Weights are read through the L1/read-only path, shared by the
// block's warps. Tensor cores (wgmma), TMA and a larger tile that amortises
// the halo are later work.
//
// Plain C interface, no PyTorch header: built with nvcc into a shared
// library and called through ctypes (baryon_painter_tpu_torch/ops/_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 8;            // output tile edge
constexpr int kMid = kTile + 2;     // conv1 region edge (1-pixel halo)
constexpr int kIn = kTile + 4;      // staged input edge (2-pixel halo)
constexpr int kThreads = 256;
constexpr int kPpt1 = 13;  // conv1 pixels a thread: 8 lanes x 13 >= 100
constexpr int kPpt2 = 8;   // conv2 pixels a thread: 8 lanes x 8 = 64

struct F4 {
  float v[4];
};

// 4 consecutive channels as one raw vector: 16 bytes of f32, 8 of bf16
template <typename T>
struct Raw4;
template <>
struct Raw4<float> {
  using type = float4;
};
template <>
struct Raw4<__nv_bfloat16> {
  using type = uint2;
};

__device__ __forceinline__ F4 to_f4(float4 t) {
  return {{t.x, t.y, t.z, t.w}};
}

__device__ __forceinline__ F4 to_f4(uint2 t) {
  __nv_bfloat162 a = *reinterpret_cast<__nv_bfloat162*>(&t.x);
  __nv_bfloat162 b = *reinterpret_cast<__nv_bfloat162*>(&t.y);
  float2 fa = __bfloat1622float2(a);
  float2 fb = __bfloat1622float2(b);
  return {{fa.x, fa.y, fb.x, fb.y}};
}

template <typename T>
__device__ __forceinline__ F4 load4(const T* p) {
  return to_f4(*reinterpret_cast<const typename Raw4<T>::type*>(p));
}

template <typename T>
__device__ __forceinline__ F4 ldg4(const T* p) {
  return to_f4(__ldg(reinterpret_cast<const typename Raw4<T>::type*>(p)));
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// rounds to nearest even, as a cast to bfloat16 does in JAX and PyTorch
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 t;
  t.x = *reinterpret_cast<uint32_t*>(&a);
  t.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = t;
}

template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float leaky(float h, float slope) {
  return h >= 0.f ? h : h * slope;
}

// 3x3 conv of the f32 shared tile `src` ([row * src_edge + col][C]) for the
// output pixels p = pix0 + lane + j * lanes (j < PPT) of a dst_edge-wide
// region, output channels co..co+3. Output pixel (r, c) reads source pixels
// (r + ky, c + kx): the source carries the halo. Slots past npix compute
// pixel 0 and are discarded by the caller.
template <typename T, int PPT>
__device__ __forceinline__ void conv3x3_acc(const float* src, int src_edge,
                                            int dst_edge, int npix, int pix0,
                                            int lane, int lanes,
                                            const T* __restrict__ w, int C,
                                            int co, float (&acc)[PPT][4]) {
  int base[PPT];
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    int p = pix0 + lane + j * lanes;
    p = p < npix ? p : 0;
    base[j] = ((p / dst_edge) * src_edge + (p % dst_edge)) * C;
#pragma unroll
    for (int o = 0; o < 4; ++o) acc[j][o] = 0.f;
  }
  for (int ky = 0; ky < 3; ++ky) {
    for (int kx = 0; kx < 3; ++kx) {
      const T* wk = w + (size_t)(ky * 3 + kx) * C * C + co;
      const float* sk = src + (ky * src_edge + kx) * C;
#pragma unroll 2
      for (int ci = 0; ci < C; ci += 4) {
        F4 wv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) wv[q] = ldg4(wk + (size_t)(ci + q) * C);
#pragma unroll
        for (int j = 0; j < PPT; ++j) {
          const F4 xv = load4(sk + base[j] + ci);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
#pragma unroll
            for (int o = 0; o < 4; ++o)
              acc[j][o] = fmaf(xv.v[q], wv[q].v[o], acc[j][o]);
          }
        }
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    res_block_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                     const float* __restrict__ s1,
                     const float* __restrict__ b1, const T* __restrict__ w2,
                     const float* __restrict__ s2,
                     const float* __restrict__ b2, T* __restrict__ out, int H,
                     int W, int C, float inner_slope, float outer_slope) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* in_s = reinterpret_cast<float*>(smem_raw);  // [kIn * kIn][C]
  float* mid_s = in_s + kIn * kIn * C;               // [kMid * kMid][C]

  const int n = blockIdx.z;
  const int ty0 = blockIdx.y * kTile;
  const int tx0 = blockIdx.x * kTile;
  const int groups = C / 4;
  const int tid = threadIdx.x;
  const T* xn = x + (size_t)n * H * W * C;
  T* outn = out + (size_t)n * H * W * C;

  // 1. stage x with a 2-pixel halo; zeros outside the image are conv1's
  //    padding
  for (int i = tid; i < kIn * kIn * groups; i += kThreads) {
    const int pix = i / groups;
    const int g = i - pix * groups;
    const int gy = ty0 - 2 + pix / kIn;
    const int gx = tx0 - 2 + pix % kIn;
    F4 v = {{0.f, 0.f, 0.f, 0.f}};
    if (gy >= 0 && gy < H && gx >= 0 && gx < W)
      v = ldg4(xn + ((size_t)gy * W + gx) * C + g * 4);
    store4(in_s + pix * C + g * 4, v.v);
  }
  __syncthreads();

  // each thread: channels co..co+3 of the pixels of its lane; threads past
  // the last whole lane (C/4 not dividing kThreads) only help with staging
  const int co = (tid % groups) * 4;
  const int lane = tid / groups;
  const int lanes = kThreads / groups;
  const bool active = lane < lanes;

  // 2. conv1 + bn1 + act_i on the 10x10 region, rounded to T (kept as f32).
  //    Outside the image the intermediate is 0: conv2 pads it with zeros.
  if (active) {
    const F4 sc = ldg4(s1 + co);
    const F4 bi = ldg4(b1 + co);
    for (int pix0 = 0; pix0 < kMid * kMid; pix0 += lanes * kPpt1) {
      float acc[kPpt1][4];
      conv3x3_acc<T, kPpt1>(in_s, kIn, kMid, kMid * kMid, pix0, lane, lanes,
                            w1, C, co, acc);
#pragma unroll
      for (int j = 0; j < kPpt1; ++j) {
        const int p = pix0 + lane + j * lanes;
        if (p >= kMid * kMid) continue;
        const int gy = ty0 - 1 + p / kMid;
        const int gx = tx0 - 1 + p % kMid;
        const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
        float v[4];
#pragma unroll
        for (int o = 0; o < 4; ++o) {
          const float h = leaky(acc[j][o] * sc.v[o] + bi.v[o], inner_slope);
          v[o] = inside ? round_to<T>(h) : 0.f;
        }
        store4(mid_s + p * C + co, v);
      }
    }
  }
  __syncthreads();

  // 3. conv2 + bn2 + residual + act_o on the 8x8 tile, one write of out
  if (active) {
    const F4 sc = ldg4(s2 + co);
    const F4 bi = ldg4(b2 + co);
    for (int pix0 = 0; pix0 < kTile * kTile; pix0 += lanes * kPpt2) {
      float acc[kPpt2][4];
      conv3x3_acc<T, kPpt2>(mid_s, kMid, kTile, kTile * kTile, pix0, lane,
                            lanes, w2, C, co, acc);
#pragma unroll
      for (int j = 0; j < kPpt2; ++j) {
        const int p = pix0 + lane + j * lanes;
        if (p >= kTile * kTile) continue;
        const int r = p / kTile;
        const int c = p % kTile;
        const int gy = ty0 + r;
        const int gx = tx0 + c;
        if (gy >= H || gx >= W) continue;
        const F4 res = load4(in_s + ((r + 2) * kIn + c + 2) * C + co);
        float v[4];
#pragma unroll
        for (int o = 0; o < 4; ++o)
          v[o] = leaky(acc[j][o] * sc.v[o] + bi.v[o] + res.v[o], outer_slope);
        store4(outn + ((size_t)gy * W + gx) * C + co, v);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w1, const void* s1,
                   const void* b1, const void* w2, const void* s2,
                   const void* b2, void* out, int n, int h, int w, int c,
                   float inner_slope, float outer_slope,
                   cudaStream_t stream) {
  const size_t smem = (size_t)(kIn * kIn + kMid * kMid) * c * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      res_block_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile, n);
  res_block_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1),
      static_cast<const float*>(s1), static_cast<const float*>(b1),
      static_cast<const T*>(w2), static_cast<const float*>(s2),
      static_cast<const float*>(b2), static_cast<T*>(out), h, w, c,
      inner_slope, outer_slope);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch
// (0 on success); the launch is asynchronous on `stream`.
int bpt_res_block_infer(const void* x, const void* w1, const void* s1,
                        const void* b1, const void* w2, const void* s2,
                        const void* b2, void* out, int n, int h, int w, int c,
                        float inner_slope, float outer_slope, int dtype,
                        void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || c % 4 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(x, w1, s1, b1, w2, s2, b2, out, n, h, w, c,
                              inner_slope, outer_slope, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, w1, s1, b1, w2, s2, b2, out, n, h,
                                      w, c, inner_slope, outer_slope, s);
  return (int)cudaErrorInvalidValue;
}

const char* bpt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
