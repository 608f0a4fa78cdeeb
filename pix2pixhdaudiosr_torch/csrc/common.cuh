// Shared helpers for the hand-written sm_90a kernels of pix2pixhdaudiosr_torch.
//
// Every kernel is reached through a plain C function (extern "C") that takes
// raw device pointers and the CUDA stream as void*, launches, and returns
// cudaGetLastError() so the Python wrapper (ctypes) can raise on a refused
// launch. The wrappers allocate every output and workspace with torch.empty;
// no kernel allocates or synchronises.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace p2p {

__host__ __device__ __forceinline__ int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);  // round to nearest even, as torch's cast
}

// N consecutive elements moved as one 16-byte (or smaller) access.
template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

}  // namespace p2p
