// Host and device helpers shared by the Hopper kernels (K1, K3, K4): the
// driver's tensor-map encoder, reached through the runtime's driver entry
// point (so the library needs no -lcuda), the card's SM count, and a warp
// index the compiler knows is warp-uniform.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

namespace {

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

int sm_count() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// warp-uniform in the compiler's eyes (a shuffle from lane 0), so the roles'
// branches hold no divergent path around the wgmmas
__device__ __forceinline__ int warp_id() {
  return __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0);
}

}  // namespace
