// The gradient of InstanceNorm2d(affine=False) + activation over
// channels_last activations, f32 or bf16, for sm_90a: the backward of
// models/layers.InstanceNormAct, whose forward is instance_norm.cu.
//
// The TPU kernel it goes with is pix2pixhdaudiosr_tpu/ops/norm_pallas.py:
// fused_instance_norm (B3, the pallas_call at :49). The JAX package has no
// backward kernel: it differentiates pix2pixhdaudiosr_tpu/models/layers.py:
// instance_norm (:189-208) and the activation through XLA. Given the
// forward's saved f32 statistics of each (sample, channel) plane, mean and
// the clamped variance var (so rstd = rsqrt(var + eps), bit for bit the
// forward's), this computes, per element,
//   x^ = (x - mean) * rstd                  (the forward's own operations)
//   g  = dy * act'(x^)     relu: 1 where x^ > 0, else 0;
//                          leaky: 1 where x^ >= 0, else 0.2
//   dx = rstd * (g - mean(g) - x^ * mean(g x^)),
// the means over H*W, and no variance term (mean(g x^) = 0) where the
// variance was clamped to 0. The slope comes from the recomputed x^, whose
// sign is the sign of the forward's output y.
//
// What bounds it on this card: device-memory bandwidth. A few FLOPs an
// element against 3 planes of bytes at the least (read x and dy, write
// dx): 1.21 GB at [64, 48, 512, 128] bf16, 0.36 ms at 3.35 TB/s. The
// reductions need every element of a plane before any dx of it, so a
// plane's x and dy are either held on chip or read twice.
//
// One-pass route (p2p_instance_norm_grad_onepass, in_grad_onepass_kernel):
// the forward's cluster plan with two staged tensors. A (sample, channel
// tile) plane is split across a thread-block cluster of K <= 16 blocks
// (the planner in ops/norm.py, plan_instance_norm_grad, picks the tile, K
// and the positions per block; the plane of x and dy must fit the
// cluster's shared memory). Each block
//   1. stages its positions' tile channels of x and dy into shared memory
//      with 16-byte cp.async copies, each through its own sample and row
//      pitches (so a cropped view of x, the same-mode deconv output, and a
//      dy with padded rows are read in place);
//   2. sums g and g x^ per channel from shared memory in f32 in a fixed
//      order (thread, warp butterfly, warps in order);
//   3. adds the K blocks' partials in rank order through distributed
//      shared memory: every block holds the same bits, run after run;
//   4. writes dx from its staged slice, 16-byte vectors into a contiguous
//      channels_last tensor of the view's shape.
// One HBM read of x and dy and one write of dx: 3 planes.
//
// Two-pass route (p2p_instance_norm_grad_twopass), for planes of x and dy
// that no cluster holds (512 x 128 x 48 at a 32-byte tile: 4.2 MB against
// 16 x 227 KB) and rows that are no multiple of 16 bytes:
//   1. in_grad_partial_kernel: a block owns (sample, a chunk of H*W rows, a
//      tile of channel vectors), neighbouring threads on neighbouring
//      16-byte vectors (coalesced), and writes f32 partial sums of g and
//      g x^ to a workspace [B, P, C, 2];
//   2. in_grad_finalize_kernel: one thread per (b, c) adds the P partials
//      in a fixed order (deterministic, no atomics) and writes (mean, rstd,
//      mean(g), mean(g x^)) to [B, C, 4];
//   3. in_grad_apply_kernel: x and dy read again on the partial kernel's
//      grid, each thread's coefficients in registers, and dx written.
// 5 planes, every access coalesced, no atomics.
#include <cooperative_groups.h>
#include <stdint.h>

#include "in_cluster.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;  // two-pass blocks

// g = dy * act'(x^), as a select (a NaN dy stays where the slope is 1)
__device__ __forceinline__ float slope_times(float dy, float xh, int act) {
  if (act == 1) return xh > 0.f ? dy : 0.f;
  if (act == 2) return xh >= 0.f ? dy : 0.2f * dy;
  return dy;
}

// Bytes of shared memory a one-pass block uses (ops/norm.py
// grad_onepass_smem): the staged [positions][tile] slices of x and dy, then
// f32 [warps][2][tile] warp sums, [2][tile] block sums (read by the
// cluster) and [4][tile] mean, rstd, mean(g), mean(g x^).
inline size_t grad_onepass_smem(int positions, int tile, int elem) {
  return 2 * (size_t)positions * tile * elem +
         (size_t)(2 * p2p::kOnepassWarps + 6) * tile * sizeof(float);
}

// Grid (K * C / tile, B), cluster (K, 1, 1), as in_onepass_kernel: cluster
// blockIdx.x / K owns channels [c0, c0 + tile) of sample blockIdx.y, its
// block of rank r the positions [r * positions, (r + 1) * positions) of
// H*W, and a thread the 16-byte vector v = tid % V of each position it
// touches (V = 2^log2v vectors a position). saved: f32 [2, B, C], the
// forward's mean and clamped variance.
template <typename T>
__global__ void __launch_bounds__(p2p::kOnepassThreads)
    in_grad_onepass_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                           T* __restrict__ dx,
                           const float* __restrict__ saved, int HW, int W,
                           int C, long long x_sample, long long x_row,
                           long long dy_sample, long long dy_row, int tile,
                           int log2v, int positions, int act, float eps) {
  using p2p::kOnepassThreads;
  using p2p::kOnepassWarps;
  constexpr int VEC = 16 / sizeof(T);
  using P = p2p::Pack<T, VEC>;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned K = cluster.num_blocks();
  const unsigned rank = cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int V = 1 << log2v;
  const int v = tid & (V - 1);
  const int b = blockIdx.y;
  const int c0 = (int)(blockIdx.x / K) * tile;
  const int p0 = (int)rank * positions;
  const int np = max(0, min(positions, HW - p0));
  const int n_vec = np << log2v;
  P* sx = reinterpret_cast<P*>(smem);
  P* sdy = sx + (size_t)positions * V;
  float* ws = reinterpret_cast<float*>(sdy + (size_t)positions * V);
  float* part = ws + 2 * kOnepassWarps * tile;
  float* coef = part + 2 * tile;  // [4][tile]

  // 1. Stage the block's positions of the tile, x and dy: vector i of a
  // slice is position p0 + i / V, channels c0 + (i % V) * VEC onwards.
  const T* xb = x + (size_t)b * x_sample + c0 + v * VEC;
  const T* db = dy + (size_t)b * dy_sample + c0 + v * VEC;
  for (int i = tid; i < n_vec; i += kOnepassThreads) {
    const int p = p0 + (i >> log2v);
    const int h = p / W;
    const long long w_off = (long long)(p - h * W) * C;
    p2p::cp_async16(sx + i, xb + h * x_row + w_off);
    p2p::cp_async16(sdy + i, db + h * dy_row + w_off);
  }
  float var = 0.f;  // of channel c0 + tid, for tid < tile
  if (tid < tile) {
    const size_t i = (size_t)b * C + c0 + tid;
    var = saved[(size_t)gridDim.y * C + i];
    coef[tid] = saved[i];
    coef[tile + tid] = rsqrtf(var + eps);
  }
  p2p::cp_async_wait_all();
  __syncthreads();

  float mean[VEC], rstd[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    mean[j] = coef[v * VEC + j];
    rstd[j] = coef[tile + v * VEC + j];
  }

  // 2. The block's sums of g and g x^ per channel: each thread over the
  // positions g0, g0 + G, ... (g0 = tid / V, G = 512 / V), a butterfly over
  // the lanes of a warp that share v, then the warps in order.
  float s[VEC], q[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) s[j] = q[j] = 0.f;
  const int groups = kOnepassThreads >> log2v;
  for (int p = tid >> log2v; p < np; p += groups) {
    const P xin = sx[(p << log2v) + v];
    const P din = sdy[(p << log2v) + v];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float xh = (p2p::to_float(xin.v[j]) - mean[j]) * rstd[j];
      const float g = slope_times(p2p::to_float(din.v[j]), xh, act);
      s[j] += g;
      q[j] = fmaf(g, xh, q[j]);
    }
  }
  for (int o = 16; o >= V; o >>= 1) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      s[j] += __shfl_xor_sync(0xffffffffu, s[j], o);
      q[j] += __shfl_xor_sync(0xffffffffu, q[j], o);
    }
  }
  if (lane < V) {  // then v == lane
    float* w_sum = ws + 2 * warp * tile + v * VEC;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      w_sum[j] = s[j];
      w_sum[tile + j] = q[j];
    }
  }
  __syncthreads();
  if (tid < tile) {
    float S = 0.f, Q = 0.f;
    for (int w = 0; w < kOnepassWarps; ++w) {
      S += ws[2 * w * tile + tid];
      Q += ws[(2 * w + 1) * tile + tid];
    }
    part[tid] = S;
    part[tile + tid] = Q;
  }
  cluster.sync();  // every block's sums are in its shared memory

  // 3. The plane's means of g and g x^: the K blocks' partials in rank
  // order, read through distributed shared memory.
  if (tid < tile) {
    float S = 0.f, Q = 0.f;
    for (unsigned r = 0; r < K; ++r) {
      const float* other = cluster.map_shared_rank(part, r);
      S += other[tid];
      Q += other[tile + tid];
    }
    coef[2 * tile + tid] = S / (float)HW;
    coef[3 * tile + tid] = var > 0.f ? Q / (float)HW : 0.f;
  }
  p2p::cluster_arrive_release();  // done reading the other blocks
  __syncthreads();

  // 4. dx from the staged slices, 16 bytes a thread.
  float mg[VEC], mgx[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    mg[j] = coef[2 * tile + v * VEC + j];
    mgx[j] = coef[3 * tile + v * VEC + j];
  }
  T* dxb = dx + ((size_t)b * HW + p0) * C + c0 + v * VEC;
  for (int i = tid; i < n_vec; i += kOnepassThreads) {
    const P xin = sx[i];
    const P din = sdy[i];
    P out;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float xh = (p2p::to_float(xin.v[j]) - mean[j]) * rstd[j];
      const float g = slope_times(p2p::to_float(din.v[j]), xh, act);
      out.v[j] = p2p::from_float<T>(rstd[j] * (g - mg[j] - xh * mgx[j]));
    }
    *reinterpret_cast<P*>(dxb + (size_t)(i >> log2v) * C) = out;
  }
  p2p::cluster_wait_acquire();  // no block leaves while another reads its sums
}

template <typename T>
int onepass(const void* x, const void* dy, void* dx, const float* saved,
            int B, int H, int W, int C, long long x_sample, long long x_row,
            long long dy_sample, long long dy_row, int tile, int K,
            int positions, int act, float eps, cudaStream_t stream) {
  const int HW = H * W;
  const int log2v = p2p::tile_log2v(tile, sizeof(T));
  // a plan that ops/norm.py plan_instance_norm_grad would not make
  if (log2v < 0 || C % tile || K < 1 || K > p2p::kMaxCluster ||
      positions < 1 || (long long)K * positions < HW ||
      (long long)(K - 1) * positions >= HW)
    return cudaErrorInvalidValue;
  const size_t smem = grad_onepass_smem(positions, tile, sizeof(T));
  if (smem > (size_t)p2p::kSmemLimit) return cudaErrorInvalidValue;
  const auto kernel = in_grad_onepass_kernel<T>;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int err = p2p::cluster_config((const void*)kernel,
                                dim3(K * (C / tile), B, 1), K, smem, stream,
                                &cfg, &attr);
  if (err) return err;
  err = cudaLaunchKernelEx(&cfg, kernel, (const T*)x, (const T*)dy, (T*)dx,
                           saved, HW, W, C, x_sample, x_row, dy_sample,
                           dy_row, tile, log2v, positions, act, eps);
  if (err) return err;
  return cudaGetLastError();
}

// --------------------------------------------------------------------------
// Two-pass route. VEC consecutive channels an access (VEC = 16 / sizeof(T)
// where C, the pointers and the pitches allow it, else 1); NV = C / VEC
// vectors a position.

// Grid (P, ceil(NV / ctv), B), ctv = min(NV, kThreads) vectors a block and
// kThreads / ctv row groups: thread (lv, rg) sums vector lv of the block's
// channel tile over the rows r0 + rg, r0 + rg + groups, ... of its chunk.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    in_grad_partial_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                           const float* __restrict__ saved,
                           float* __restrict__ partial, int HW, int W, int C,
                           long long x_sample, long long x_row,
                           long long dy_sample, long long dy_row,
                           int rows_per_chunk, int act, float eps) {
  using P = p2p::Pack<T, VEC>;
  __shared__ float s_sum[VEC * kThreads];
  __shared__ float s_sq[VEC * kThreads];
  const int nv = C / VEC;
  const int ctv = nv < kThreads ? nv : kThreads;
  const int groups = kThreads / ctv;
  const int tid = threadIdx.x, lv = tid % ctv, rg = tid / ctv;
  const int p = blockIdx.x, b = blockIdx.z;
  const int cv = blockIdx.y * ctv + lv;
  const int c = cv * VEC;
  float s[VEC], q[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) s[j] = q[j] = 0.f;
  if (rg < groups && cv < nv) {
    const int B = gridDim.z;
    float mean[VEC], rstd[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const size_t i = (size_t)b * C + c + j;
      mean[j] = saved[i];
      rstd[j] = rsqrtf(saved[(size_t)B * C + i] + eps);
    }
    const T* xb = x + (size_t)b * x_sample + c;
    const T* db = dy + (size_t)b * dy_sample + c;
    const int r0 = p * rows_per_chunk;
    const int r1 = min(HW, r0 + rows_per_chunk);
    for (int r = r0 + rg; r < r1; r += groups) {
      const int h = r / W;
      const long long w_off = (long long)(r - h * W) * C;
      const P xin = *reinterpret_cast<const P*>(xb + h * x_row + w_off);
      const P din = *reinterpret_cast<const P*>(db + h * dy_row + w_off);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float xh = (p2p::to_float(xin.v[j]) - mean[j]) * rstd[j];
        const float g = slope_times(p2p::to_float(din.v[j]), xh, act);
        s[j] += g;
        q[j] = fmaf(g, xh, q[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    s_sum[j * kThreads + tid] = s[j];
    s_sq[j * kThreads + tid] = q[j];
  }
  __syncthreads();
  if (rg == 0 && cv < nv) {
    const int P_ = gridDim.x;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float ts = 0.f, tq = 0.f;
      for (int g = 0; g < groups; ++g) {
        ts += s_sum[j * kThreads + g * ctv + lv];
        tq += s_sq[j * kThreads + g * ctv + lv];
      }
      float* dst = partial + (((size_t)b * P_ + p) * C + c + j) * 2;
      dst[0] = ts;
      dst[1] = tq;
    }
  }
}

// One thread per (b, c): the P partials in order; coef[b][c] = (mean, rstd,
// mean(g), mean(g x^) or 0 where the variance was clamped).
__global__ void in_grad_finalize_kernel(const float* __restrict__ partial,
                                        const float* __restrict__ saved,
                                        float* __restrict__ coef, int B,
                                        int C, int P, int HW, float eps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * C) return;
  const int b = i / C, c = i % C;
  float s = 0.f, q = 0.f;
  for (int p = 0; p < P; ++p) {
    const float* src = partial + (((size_t)b * P + p) * C + c) * 2;
    s += src[0];
    q += src[1];
  }
  const float var = saved[(size_t)B * C + i];
  float* dst = coef + (size_t)i * 4;
  dst[0] = saved[i];
  dst[1] = rsqrtf(var + eps);
  dst[2] = s / (float)HW;
  dst[3] = var > 0.f ? q / (float)HW : 0.f;
}

// The partial kernel's grid and thread layout: thread (lv, rg) writes dx of
// vector lv of the block's channel tile at the rows r0 + rg, r0 + rg +
// groups, ... of its chunk, with its channels' coefficients in registers.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    in_grad_apply_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                         T* __restrict__ dx, const float* __restrict__ coef,
                         int HW, int W, int C, long long x_sample,
                         long long x_row, long long dy_sample,
                         long long dy_row, int rows_per_chunk, int act) {
  using P = p2p::Pack<T, VEC>;
  const int nv = C / VEC;
  const int ctv = nv < kThreads ? nv : kThreads;
  const int groups = kThreads / ctv;
  const int tid = threadIdx.x, lv = tid % ctv, rg = tid / ctv;
  const int p = blockIdx.x, b = blockIdx.z;
  const int cv = blockIdx.y * ctv + lv;
  if (rg >= groups || cv >= nv) return;
  const int c = cv * VEC;
  float k[4][VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const float* src = coef + ((size_t)b * C + c + j) * 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) k[i][j] = src[i];
  }
  const T* xb = x + (size_t)b * x_sample + c;
  const T* db = dy + (size_t)b * dy_sample + c;
  T* dxb = dx + (size_t)b * HW * C + c;
  const int r0 = p * rows_per_chunk;
  const int r1 = min(HW, r0 + rows_per_chunk);
  for (int r = r0 + rg; r < r1; r += groups) {
    const int h = r / W;
    const long long w_off = (long long)(r - h * W) * C;
    const P xin = *reinterpret_cast<const P*>(xb + h * x_row + w_off);
    const P din = *reinterpret_cast<const P*>(db + h * dy_row + w_off);
    P out;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float xh = (p2p::to_float(xin.v[j]) - k[0][j]) * k[1][j];
      const float g = slope_times(p2p::to_float(din.v[j]), xh, act);
      out.v[j] = p2p::from_float<T>(k[1][j] * (g - k[2][j] - xh * k[3][j]));
    }
    *reinterpret_cast<P*>(dxb + (size_t)r * C) = out;
  }
}

template <typename T, int VEC>
int twopass(const void* x, const void* dy, void* dx, const float* saved,
            float* partial, float* coef, int B, int H, int W, int C,
            long long x_sample, long long x_row, long long dy_sample,
            long long dy_row, int act, float eps, int P,
            cudaStream_t stream) {
  const int HW = H * W;
  const int nv = C / VEC;
  if (C % VEC || P < 1 || P > HW) return cudaErrorInvalidValue;
  const int ctv = nv < kThreads ? nv : kThreads;
  dim3 grid(P, p2p::ceil_div(nv, ctv), B);
  in_grad_partial_kernel<T, VEC><<<grid, kThreads, 0, stream>>>(
      (const T*)x, (const T*)dy, saved, partial, HW, W, C, x_sample, x_row,
      dy_sample, dy_row, p2p::ceil_div(HW, P), act, eps);
  int err = cudaGetLastError();
  if (err) return err;
  in_grad_finalize_kernel<<<p2p::ceil_div(B * C, kThreads), kThreads, 0,
                            stream>>>(partial, saved, coef, B, C, P, HW, eps);
  err = cudaGetLastError();
  if (err) return err;
  in_grad_apply_kernel<T, VEC><<<grid, kThreads, 0, stream>>>(
      (const T*)x, (const T*)dy, (T*)dx, coef, HW, W, C, x_sample, x_row,
      dy_sample, dy_row, p2p::ceil_div(HW, P), act);
  return cudaGetLastError();
}

template <typename T>
int twopass_vec(const void* x, const void* dy, void* dx, const float* saved,
                float* partial, float* coef, int B, int H, int W, int C,
                long long x_sample, long long x_row, long long dy_sample,
                long long dy_row, int act, float eps, int P, int vec,
                cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (vec == kVec)
    return twopass<T, kVec>(x, dy, dx, saved, partial, coef, B, H, W, C,
                            x_sample, x_row, dy_sample, dy_row, act, eps, P,
                            stream);
  if (vec == 1)
    return twopass<T, 1>(x, dy, dx, saved, partial, coef, B, H, W, C,
                         x_sample, x_row, dy_sample, dy_row, act, eps, P,
                         stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// The one-pass route. x, dy: [B, C, H, W] whose rows of W*C elements are
// contiguous, sample b and row h of x at x + b * x_sample + h * x_row, of
// dy likewise (elements; multiples of 16 bytes, both 16-byte aligned); dx:
// contiguous channels_last [B, C, H, W]; saved: f32 [2, B, C], the
// forward's (mean, clamped variance). dtype 0 = f32, 1 = bf16; act 0 =
// none, 1 = relu, 2 = leaky(0.2); the plan (tile channels, cluster size,
// positions per block) is ops/norm.py plan_instance_norm_grad's. Returns
// cudaErrorInvalidValue for a plan it cannot run, and
// cudaErrorInvalidConfiguration when no cluster of the plan fits the card.
int p2p_instance_norm_grad_onepass(const void* x, const void* dy, void* dx,
                                   const void* saved, int B, int H, int W,
                                   int C, long long x_sample, long long x_row,
                                   long long dy_sample, long long dy_row,
                                   int dtype, int act, float eps, int tile,
                                   int cluster, int positions, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0) return cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    return onepass<__nv_bfloat16>(x, dy, dx, (const float*)saved, B, H, W, C,
                                  x_sample, x_row, dy_sample, dy_row, tile,
                                  cluster, positions, act, eps, s);
  return onepass<float>(x, dy, dx, (const float*)saved, B, H, W, C, x_sample,
                        x_row, dy_sample, dy_row, tile, cluster, positions,
                        act, eps, s);
}

// The two-pass route: x, dy, dx, saved, dtype and act as above, but the
// pitches need only be multiples of `vec` elements (vec = 16 bytes of
// elements, or 1); partial: f32 [B, P, C, 2] and coef: f32 [B, C, 4]
// workspaces.
int p2p_instance_norm_grad_twopass(const void* x, const void* dy, void* dx,
                                   const void* saved, void* partial,
                                   void* coef, int B, int H, int W, int C,
                                   long long x_sample, long long x_row,
                                   long long dy_sample, long long dy_row,
                                   int dtype, int act, float eps, int P,
                                   int vec, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0) return cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    return twopass_vec<__nv_bfloat16>(
        x, dy, dx, (const float*)saved, (float*)partial, (float*)coef, B, H,
        W, C, x_sample, x_row, dy_sample, dy_row, act, eps, P, vec, s);
  return twopass_vec<float>(x, dy, dx, (const float*)saved, (float*)partial,
                            (float*)coef, B, H, W, C, x_sample, x_row,
                            dy_sample, dy_row, act, eps, P, vec, s);
}

}  // extern "C"
