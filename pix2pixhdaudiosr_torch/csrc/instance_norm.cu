// InstanceNorm2d(affine=False) + activation over channels_last activations,
// f32 or bf16, for sm_90a.
//
// Replaces pix2pixhdaudiosr_tpu/ops/norm_pallas.py:fused_instance_norm and
// computes what pix2pixhdaudiosr_tpu/models/layers.py:instance_norm does:
// per (sample, channel) f32 mean and E[x^2] over H*W,
// var = max(E[x^2] - mean^2, 0), y = (x - mean) * rsqrt(var + eps), then
// none / relu / leaky(0.2), written in the input dtype.
//
// What bounds it on this card: device-memory bandwidth. It does a few
// FLOPs per element, and the flagship tensors are up to 805 MB (bf16,
// batch 128, [128, 48, 512, 128]), far beyond the 50 MB L2.
//
// Design: two reads and one write of the tensor, the floor for a norm whose
// statistics span the whole H*W plane. The TPU kernel held one sample in
// VMEM; a Hopper block cannot (a full-resolution sample is 6.3 MB), and
// one block per sample would leave most of the 132 SMs idle at serving
// batch sizes. So:
//   1. in_stats: each block owns (sample b, a chunk of rows of H*W, a tile
//      of up to 256 channels). Threads walk rows with neighbouring threads
//      on neighbouring channels (NHWC: coalesced) and write f32 partial
//      sums of x and x^2 for the chunk to a workspace [B, P, C, 2].
//   2. in_finalize: one thread per (b, c) adds the P partials in a fixed
//      order (deterministic, no atomics) and writes (mean, rstd).
//   3. in_apply: an elementwise pass, 16 bytes per thread per access when
//      C allows it, normalises, applies the activation and casts.
// The chunk count P (chosen by the wrapper) keeps both regimes of the
// flagship busy: H*W = 64 with C = 1536 splits over channel tiles, and
// H*W = 65536 with C = 48 splits over row chunks.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTile = 256;  // channels per stats block

template <typename T>
__global__ void __launch_bounds__(kThreads)
    in_stats_kernel(const T* __restrict__ x, float* __restrict__ partial,
                    int HW, int C, int rows_per_chunk) {
  __shared__ float s_sum[kThreads];
  __shared__ float s_sq[kThreads];
  const int p = blockIdx.x, P = gridDim.x, b = blockIdx.z;
  const int ctw = C < kMaxTile ? C : kMaxTile;  // channel tile width
  const int rp = kThreads / ctw;                // row groups in the block
  const int tid = threadIdx.x;
  const int lc = tid % ctw, rg = tid / ctw;
  const int c = blockIdx.y * ctw + lc;
  float s = 0.f, q = 0.f;
  if (rg < rp && c < C) {
    const int r0 = p * rows_per_chunk;
    const int r1 = min(HW, r0 + rows_per_chunk);
    const T* xb = x + (size_t)b * HW * C + c;
    for (int r = r0 + rg; r < r1; r += rp) {
      const float v = p2p::to_float(xb[(size_t)r * C]);
      s += v;
      q = fmaf(v, v, q);
    }
  }
  s_sum[tid] = s;
  s_sq[tid] = q;
  __syncthreads();
  if (rg == 0 && c < C) {
    float ts = 0.f, tq = 0.f;
    for (int g = 0; g < rp; ++g) {
      ts += s_sum[g * ctw + lc];
      tq += s_sq[g * ctw + lc];
    }
    float* dst = partial + (((size_t)b * P + p) * C + c) * 2;
    dst[0] = ts;
    dst[1] = tq;
  }
}

__global__ void in_finalize_kernel(const float* __restrict__ partial,
                                   float* __restrict__ stats, int B, int C,
                                   int P, int HW, float eps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * C) return;
  const int b = i / C, c = i % C;
  float s = 0.f, q = 0.f;
  for (int p = 0; p < P; ++p) {
    const float* src = partial + (((size_t)b * P + p) * C + c) * 2;
    s += src[0];
    q += src[1];
  }
  const float mean = s / (float)HW;
  const float ex2 = q / (float)HW;
  const float var = fmaxf(ex2 - mean * mean, 0.f);
  stats[(size_t)i * 2] = mean;
  stats[(size_t)i * 2 + 1] = rsqrtf(var + eps);
}

__device__ __forceinline__ float activate(float y, int act) {
  if (act == 1) return fmaxf(y, 0.f);
  if (act == 2) return y >= 0.f ? y : 0.2f * y;
  return y;
}

// VEC consecutive elements per access: same sample, channels c..c+VEC-1
// (the wrapper picks VEC = 1 unless C % VEC == 0 and both pointers are
// 16-byte aligned).
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    in_apply_kernel(const T* __restrict__ x, T* __restrict__ y,
                    const float* __restrict__ stats, long long n_vec,
                    long long hwc, int C, int act) {
  using P = p2p::Pack<T, VEC>;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       v < n_vec; v += stride) {
    const long long i = v * VEC;
    const long long b = i / hwc;
    const int c = (int)(i % C);
    const float* st = stats + ((size_t)b * C + c) * 2;
    const P in = reinterpret_cast<const P*>(x)[v];
    P out;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float t = (p2p::to_float(in.v[j]) - st[2 * j]) * st[2 * j + 1];
      out.v[j] = p2p::from_float<T>(activate(t, act));
    }
    reinterpret_cast<P*>(y)[v] = out;
  }
}

template <typename T, int VEC>
void launch_apply(const void* x, void* y, const float* stats, long long n,
                  long long hwc, int C, int act, cudaStream_t stream) {
  const long long n_vec = n / VEC;
  long long blocks = (n_vec + kThreads - 1) / kThreads;
  if (blocks > (1 << 20)) blocks = 1 << 20;  // grid-stride beyond this
  in_apply_kernel<T, VEC><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const T*)x, (T*)y, stats, n_vec, hwc, C, act);
}

template <typename T>
int run(const void* x, void* y, float* partial, float* stats, int B, int HW,
        int C, int act, float eps, int P, cudaStream_t stream) {
  const int ctw = C < kMaxTile ? C : kMaxTile;
  const int rows_per_chunk = p2p::ceil_div(HW, P);
  dim3 grid(P, p2p::ceil_div(C, ctw), B);
  in_stats_kernel<T><<<grid, kThreads, 0, stream>>>((const T*)x, partial, HW,
                                                     C, rows_per_chunk);
  int err = cudaGetLastError();
  if (err) return err;
  in_finalize_kernel<<<p2p::ceil_div(B * C, kThreads), kThreads, 0, stream>>>(
      partial, stats, B, C, P, HW, eps);
  err = cudaGetLastError();
  if (err) return err;
  const long long n = (long long)B * HW * C;
  const long long hwc = (long long)HW * C;
  constexpr int kVec = 16 / sizeof(T);
  const bool aligned = ((uintptr_t)x % 16 == 0) && ((uintptr_t)y % 16 == 0);
  if (C % kVec == 0 && aligned)
    launch_apply<T, kVec>(x, y, stats, n, hwc, C, act, stream);
  else
    launch_apply<T, 1>(x, y, stats, n, hwc, C, act, stream);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, y: [B, H*W, C] (channels_last [B, C, H, W]); dtype 0 = f32, 1 = bf16;
// act 0 = none, 1 = relu, 2 = leaky(0.2); partial: f32 [B, P, C, 2];
// stats: f32 [B, C, 2] (mean, rstd) on return.
int p2p_instance_norm_act(const void* x, void* y, void* partial, void* stats,
                          int B, int HW, int C, int dtype, int act, float eps,
                          int P, void* stream) {
  if (B <= 0 || HW <= 0 || C <= 0) return cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    return run<__nv_bfloat16>(x, y, (float*)partial, (float*)stats, B, HW, C,
                              act, eps, P, s);
  return run<float>(x, y, (float*)partial, (float*)stats, B, HW, C, act, eps,
                    P, s);
}

}  // extern "C"
