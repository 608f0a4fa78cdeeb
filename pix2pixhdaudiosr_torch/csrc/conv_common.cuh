// Staging helpers shared by the two routes of the 3x3 conv (conv3x3_in.cu,
// mma.sync; conv3x3_wgmma.cu, wgmma): the reflect index and the prologue
// that applies the previous InstanceNorm as an input element is staged.
#pragma once

#include "common.cuh"

namespace p2p {
namespace {

// Index i of a padded axis of length n + 2 (or of a tile's halo beyond the
// edge) -> the input index it reads, reflecting without the edge; indices
// a masked output reads past the far edge are clamped into range.
__device__ __forceinline__ int reflect_index(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * n - 2 - i;
  return min(max(i, 0), n - 1);
}

// 8 channels of one staged position: the prologue (1 in_relu, 2
// in_relu_add, 3 in_add) in f32 with one rounding per operation as the JAX
// kernel and the torch twin do (no contraction into FMA), then one round
// to bf16. m, s: this sample's mean and scale of the 8 channels.
__device__ __forceinline__ uint4 prologue8(int prologue, uint4 xv, uint4 rv,
                                           const float* m, const float* s) {
  const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&xv);
  const __nv_bfloat162* rp = reinterpret_cast<const __nv_bfloat162*>(&rv);
  uint4 out;
  __nv_bfloat162* op = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 v = __bfloat1622float2(xp[j]);
    float t0 = __fmul_rn(__fsub_rn(v.x, m[2 * j]), s[2 * j]);
    float t1 = __fmul_rn(__fsub_rn(v.y, m[2 * j + 1]), s[2 * j + 1]);
    if (prologue <= 2) {  // in_relu, in_relu_add
      t0 = fmaxf(t0, 0.f);
      t1 = fmaxf(t1, 0.f);
    }
    if (prologue >= 2) {  // in_relu_add, in_add
      const float2 r = __bfloat1622float2(rp[j]);
      t0 = __fadd_rn(t0, r.x);
      t1 = __fadd_rn(t1, r.y);
    }
    op[j] = __floats2bfloat162_rn(t0, t1);
  }
  return out;
}

}  // namespace
}  // namespace p2p
