// K2: the per-sample tile gather of the device stack cache, hand-written for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `gather_tiles_pallas` of
// baryon_painter_tpu/ops/pallas_gather.py (kernel body `_gather_kernel`):
// for every sample b of a batch, copy the T x T tile of each field f at the
// 100 and the 150 Mpc/h depth out of the device-resident stacks,
//
//   out[b, 0, f] = d100[f, z, s100, tx100*T : +T, ty100*T : +T]
//   out[b, 1, f] = d150[f, z, s150, tx150*T : +T, ty150*T : +T]
//
// with (z, p100, p150, s100, tx100, ty100, s150, tx150, ty150) = digits[b]
// (int32, read on the device; the dihedral digits p100/p150 are applied
// outside, in torch). The stacks are (F, Z, S, G, G) f32 and tx indexes the
// first spatial axis. The wrapper (ops/gather.py) checks every digit's range
// on the host: unlike XLA's dynamic_slice, this copy does not clamp.
//
// What bounds it: pure data movement, 2 * B * 2 * F * T * T * 4 bytes (each
// tile read once and written once): 201 MB at the training shape (B = 24,
// F = 2, T = 512), >= 0.06 ms at 3.35 TB/s.
//
// Design: one block per (sample, depth, field, chunk of rows); each thread
// copies 16-byte float4 vectors, neighbouring threads on neighbouring
// addresses of a row, so loads and stores are fully coalesced. It requires
// T % 4 == 0, G % 4 == 0 and 16-byte aligned bases (checked by the wrapper).
//
// Plain C interface, no PyTorch header: built with nvcc into a shared
// library and called through ctypes (baryon_painter_tpu_torch/ops/_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = 32;

__global__ void __launch_bounds__(kThreads)
    gather_tiles_kernel(const float* __restrict__ d100,
                        const float* __restrict__ d150,
                        const int* __restrict__ digits,
                        float* __restrict__ out, int F, int Z, int S100,
                        int S150, int G, int T) {
  const int b = blockIdx.z;
  const int depth = blockIdx.y / F;
  const int f = blockIdx.y % F;
  const int* d = digits + (size_t)b * 9;
  const int z = d[0];
  const int s = depth ? d[6] : d[3];
  const int tx = depth ? d[7] : d[4];
  const int ty = depth ? d[8] : d[5];
  const int S = depth ? S150 : S100;
  const float* src = (depth ? d150 : d100) +
                     ((((size_t)f * Z + z) * S + s) * G + (size_t)tx * T) * G +
                     (size_t)ty * T;
  float* dst = out + (((size_t)b * 2 + depth) * F + f) * (size_t)T * T;
  const int q = T / 4;  // float4 per row
  const int r0 = blockIdx.x * kRowsPerBlock;
  const int rows = min(kRowsPerBlock, T - r0);
  for (int i = threadIdx.x; i < rows * q; i += kThreads) {
    const int r = r0 + i / q;
    const int c = i % q;
    const float4 v =
        __ldg(reinterpret_cast<const float4*>(src + (size_t)r * G) + c);
    reinterpret_cast<float4*>(dst + (size_t)r * T)[c] = v;
  }
}

}  // namespace

extern "C" {

// d100: (F, Z, S100, G, G), d150: (F, Z, S150, G, G) f32; digits (B, 9)
// int32 on the device; out (B, 2, F, T, T) f32. Returns the cudaError_t of
// the launch (0 on success); the launch is asynchronous on `stream`.
int bpt_gather_tiles(const void* d100, const void* d150, const void* digits,
                     void* out, int B, int F, int Z, int S100, int S150,
                     int G, int T, void* stream) {
  if (B <= 0 || F <= 0 || Z <= 0 || S100 <= 0 || S150 <= 0 || T <= 0 ||
      T > G || T % 4 != 0 || G % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((T + kRowsPerBlock - 1) / kRowsPerBlock, 2 * F, B);
  gather_tiles_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(d100), static_cast<const float*>(d150),
      static_cast<const int*>(digits), static_cast<float*>(out), F, Z, S100,
      S150, G, T);
  return (int)cudaGetLastError();
}

}  // extern "C"
