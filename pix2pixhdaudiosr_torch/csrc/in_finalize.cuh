// InstanceNorm statistics from per-chunk partial sums, shared by
// instance_norm.cu (the norm and its stats-only entry) and conv3x3_in.cu
// (whose epilogue writes the partial sums of its own output).
#pragma once

#include "common.cuh"

namespace p2p {
namespace {

// partial: f32 [B, P, C, 2], the sums of x and x^2 over P chunks of the
// H*W positions of each (b, c). One thread per (b, c) adds the P partials
// in a fixed order (deterministic, no atomics) and writes
//   mean[i * stride] = E[x],  rstd[i * stride] = rsqrt(max(E[x^2] - mean^2, 0) + eps)
// for i = b * C + c: stride 2 gives one interleaved [B, C, 2] buffer,
// stride 1 two separate [B, C] arrays. With `saved` (f32 [2, B, C], what
// the InstanceNorm backward reads) also saved[i] = mean and
// saved[B * C + i] = the clamped variance.
__global__ void in_finalize_kernel(const float* __restrict__ partial,
                                   float* __restrict__ mean,
                                   float* __restrict__ rstd,
                                   float* __restrict__ saved, int stride,
                                   int B, int C, int P, int HW, float eps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * C) return;
  const int b = i / C, c = i % C;
  float s = 0.f, q = 0.f;
  for (int p = 0; p < P; ++p) {
    const float* src = partial + (((size_t)b * P + p) * C + c) * 2;
    s += src[0];
    q += src[1];
  }
  const float m = s / (float)HW;
  const float ex2 = q / (float)HW;
  const float var = fmaxf(ex2 - m * m, 0.f);
  mean[(size_t)i * stride] = m;
  rstd[(size_t)i * stride] = rsqrtf(var + eps);
  if (saved != nullptr) {
    saved[i] = m;
    saved[(size_t)B * C + i] = var;
  }
}

inline int launch_finalize(const float* partial, float* mean, float* rstd,
                           int stride, int B, int C, int P, int HW, float eps,
                           cudaStream_t stream, float* saved = nullptr) {
  constexpr int kThreads = 256;
  in_finalize_kernel<<<ceil_div(B * C, kThreads), kThreads, 0, stream>>>(
      partial, mean, rstd, saved, stride, B, C, P, HW, eps);
  return cudaGetLastError();
}

}  // namespace
}  // namespace p2p
