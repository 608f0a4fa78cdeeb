// InstanceNorm2d(affine=False) + activation over channels_last activations,
// f32 or bf16, for sm_90a.
//
// Replaces pix2pixhdaudiosr_tpu/ops/norm_pallas.py:fused_instance_norm (B3,
// the pallas_call at :49) and computes what
// pix2pixhdaudiosr_tpu/models/layers.py:instance_norm does: per (sample,
// channel) f32 mean and E[x^2] over H*W, var = max(E[x^2] - mean^2, 0),
// y = (x - mean) * rsqrt(var + eps), then none / relu / leaky(0.2), written
// in the input dtype.
//
// What bounds it on this card: device-memory bandwidth. It does a few
// FLOPs per element, and the flagship tensors are up to 805 MB (bf16,
// batch 128, [128, 48, 512, 128]), far beyond the 50 MB L2. The floor is
// one read and one write of the tensor, which the TPU kernel reached by
// holding one sample in VMEM.
//
// One-pass route (p2p_instance_norm_onepass, in_onepass_kernel): the same
// traffic, with each plane held in shared memory. A (sample, channel tile)
// plane of H*W positions is split across a thread-block cluster of K <= 16
// blocks (above 8 a non-portable size, which the H100 runs; the planner in
// ops/norm.py picks the tile, K and the positions per block, ~64 KB staged
// a block and at most 128 KB, and routes a shape here only if its plane
// fits). Each block
//   1. stages its positions' tile channels into shared memory with 16-byte
//      cp.async copies, reading through the input's sample and row pitches
//      (so a view cropped in H and W, the same-mode deconv output, is read
//      in place);
//   2. sums x and x^2 per channel from shared memory in f32, in a fixed
//      order (thread, warp butterfly, warps in order);
//   3. exchanges its sums with the other blocks of the cluster through
//      distributed shared memory, each block adding the K partials in rank
//      order, so all hold the same (mean, rstd) and the result is
//      bit-identical from run to run (no atomics);
//   4. normalizes its staged slice, applies the activation and writes
//      16-byte vectors to a contiguous channels_last output.
// One launch, one HBM read and one write. Where the caller asks (a forward
// that autograd records), the rank-0 block of each cluster also writes the
// plane's f32 mean and clamped variance, which the backward
// (instance_norm_bwd.cu) reads instead of a statistics pass over x. The
// cluster index runs over the
// channel tiles fastest, so the tiles of one sample run side by side. A
// tile spans at least a 32-byte sector of each position where the row
// allows: at 512 x 128 x 48 bf16 a 16-byte tile (half a sector of each
// 96-byte row) measured 1.8x slower than a 32-byte one, so L2 does not
// serve the other half.
// A block arrives on the cluster barrier once it has read the others'
// sums, and waits on it only before it exits, so no block leaves while
// another still reads its shared memory.
//
// Two-pass route (p2p_instance_norm_act), for planes too large for a
// cluster's shared memory and rows that are no multiple of 16 bytes: two
// reads and one write of a contiguous tensor, in three launches:
//   1. in_stats: each block owns (sample b, a chunk of rows of H*W, a tile
//      of up to 256 channels). Threads walk rows with neighbouring threads
//      on neighbouring channels (NHWC: coalesced) and write f32 partial
//      sums of x and x^2 for the chunk to a workspace [B, P, C, 2].
//   2. in_finalize (in_finalize.cuh): one thread per (b, c) adds the P
//      partials in a fixed order (deterministic, no atomics) and writes
//      (mean, rstd), and where asked the saved (mean, variance).
//   3. in_apply: an elementwise pass, 16 bytes per thread per access when
//      C allows it, normalises, applies the activation and casts.
// The chunk count P (chosen by the wrapper) keeps both regimes busy: H*W =
// 64 with C = 1536 splits over channel tiles, and H*W = 65536 with C = 48
// over row chunks. p2p_instance_stats runs passes 1 and 2 alone, for a
// caller that folds the normalize into its own next pass (ops/enhancer.py:
// the fused enhancer's entry prologue).
//
// Cross-shard entries, for a frame axis split over ranks (context
// parallelism, pix2pixhdaudiosr_tpu/models/layers.py:189-208, where the
// moments of each shard are pmean'd before the normalize), one launch and
// one read of x each, x read through its sample and row pitches (a cropped
// view in place), 16-byte loads where C and the pitches allow them (else a
// scalar path in the same kernel):
//   p2p_instance_moments (B3m, in_moments_kernel) the local f32 mean and
//                        E[x^2], [2, B, C]: no clamp, no rsqrt, so the
//                        caller can sum them over the shards. Each block
//                        sums its rows, then the last block of each
//                        (sample, channel tile) to arrive adds the blocks'
//                        sums in block order, compensated: deterministic.
//   p2p_instance_apply   (B3a, in_apply_moments_kernel) from such moments
//                        summed over `count` shards: each thread makes its
//                        channels' mean and rstd (divided by count, as the
//                        pmean does), then normalizes its rows.
// What bounds them: the one read (B3m) or read and write (B3a) of x, ~12.6
// MB in bf16 for a flagship CP block [1, 48, 512, 256] (3.8 and 7.5 us at
// 3.35 TB/s), so at such sizes the launch and the cross-block step matter
// as much as bandwidth; a long file's block, [1, 48, 512, 2816], is 138 MB.
#include <cooperative_groups.h>
#include <stdint.h>

#include "in_cluster.cuh"
#include "in_finalize.cuh"

namespace cg = cooperative_groups;

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

// Pass 3 over contiguous x, y from stats [B, C, 2] (mean, rstd): 16-byte
// accesses where C and both pointers allow them.
template <typename T>
int apply_pass(const void* x, void* y, const float* stats, int B, int HW,
               int C, int act, cudaStream_t stream) {
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

// Pass 1: the partial sums [B, P, C, 2] of P row chunks.
template <typename T>
int partial_pass(const void* x, float* partial, int B, int HW, int C, int P,
                 cudaStream_t stream) {
  const int ctw = C < kMaxTile ? C : kMaxTile;
  const int rows_per_chunk = p2p::ceil_div(HW, P);
  dim3 grid(P, p2p::ceil_div(C, ctw), B);
  in_stats_kernel<T><<<grid, kThreads, 0, stream>>>((const T*)x, partial, HW,
                                                     C, rows_per_chunk);
  return cudaGetLastError();
}

// Passes 1 and 2: the statistics, written as mean[i * stride] and
// rstd[i * stride] for i = b * C + c.
template <typename T>
int stats_pass(const void* x, float* partial, float* mean, float* rstd,
               int stride, int B, int HW, int C, float eps, int P,
               cudaStream_t stream, float* saved = nullptr) {
  const int err = partial_pass<T>(x, partial, B, HW, C, P, stream);
  if (err) return err;
  return p2p::launch_finalize(partial, mean, rstd, stride, B, C, P, HW, eps,
                              stream, saved);
}

template <typename T>
int run(const void* x, void* y, float* partial, float* stats, float* saved,
        int B, int HW, int C, int act, float eps, int P, cudaStream_t stream) {
  const int err = stats_pass<T>(x, partial, stats, stats + 1, 2, B, HW, C,
                                eps, P, stream, saved);
  if (err) return err;
  return apply_pass<T>(x, y, stats, B, HW, C, act, stream);
}

// sum += v with the rounding error of the add kept in c (Neumaier's
// compensated summation); the sum is sum + c.
__device__ __forceinline__ void add_compensated(float& sum, float& c,
                                                float v) {
  const float t = sum + v;
  c += fabsf(sum) >= fabsf(v) ? (sum - t) + v : (v - t) + sum;
  sum = t;
}

// --------------------------------------------------------------------------
// Cross-shard entries: one launch each, reading x [B, C, H, W] through its
// sample and row pitches (a cropped view in place). Grid (chunks, channel
// tiles, B); a block's G * tv threads are (group g = tid / tv, vector
// v = tid % tv): thread (g, v) always reads the VEC channels
// c = t * tv * VEC + v * VEC (VEC = 16 bytes of channels on the vector path,
// 1 on the scalar one). The H*W positions are taken in windows of G * n
// (n = `loads` <= U), a block's burst: window i is block i % chunks's, so
// at any moment the chunks of a plane read neighbouring windows; in its
// burst thread (g, v) reads positions start + g, start + g + G, ..., its n
// loads issued before any is used (predicated, raw 16-byte words, unpacked
// after), and the next burst's issued before this one is used.

// A thread's 16-byte (or one-element) load: the raw word and its floats.
template <typename T, int VEC>
struct Lanes;
template <>
struct Lanes<float, 4> {
  using Raw = uint4;
  static __device__ __forceinline__ void unpack(const Raw& r, float* f) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
  static __device__ __forceinline__ Raw pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};
template <>
struct Lanes<__nv_bfloat16, 8> {
  using Raw = uint4;
  static __device__ __forceinline__ void two(unsigned w, float* f) {
    f[0] = __uint_as_float(w << 16);  // bf16 -> f32 is exact
    f[1] = __uint_as_float(w & 0xffff0000u);
  }
  static __device__ __forceinline__ unsigned two(const float* f) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(f[0], f[1]);  // as torch
    return *reinterpret_cast<const unsigned*>(&h);
  }
  static __device__ __forceinline__ void unpack(const Raw& r, float* f) {
    two(r.x, f);
    two(r.y, f + 2);
    two(r.z, f + 4);
    two(r.w, f + 6);
  }
  static __device__ __forceinline__ Raw pack(const float* f) {
    return make_uint4(two(f), two(f + 2), two(f + 4), two(f + 6));
  }
};
template <>
struct Lanes<float, 1> {
  using Raw = float;
  static __device__ __forceinline__ void unpack(Raw r, float* f) { f[0] = r; }
  static __device__ __forceinline__ Raw pack(const float* f) { return f[0]; }
};
template <>
struct Lanes<__nv_bfloat16, 1> {
  using Raw = unsigned short;
  static __device__ __forceinline__ void unpack(Raw r, float* f) {
    f[0] = __uint_as_float((unsigned)r << 16);
  }
  static __device__ __forceinline__ Raw pack(const float* f) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(f[0]));
  }
};

// The loads of thread (g, v)'s burst from window `start`: raw[u] holds
// position start + g + u G for u < n, or 0 (u >= n, or past H*W); one
// division a burst.
template <typename T, int VEC, int U>
__device__ __forceinline__ void load_burst(
    const T* xb, int start, int g, int G, int n, int HW, int W, int C,
    long long row_pitch, typename Lanes<T, VEC>::Raw (&raw)[U]) {
  using Raw = typename Lanes<T, VEC>::Raw;
  int p = start + g, h = p / W, w = p - h * W;
  const int dh = G / W, dw = G - dh * W;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    raw[u] = Raw{};
    if (u < n && p < HW)
      raw[u] = *reinterpret_cast<const Raw*>(xb + h * row_pitch +
                                             (long long)w * C);
    p += G;
    h += dh;
    w += dw;
    if (w >= W) {
      w -= W;
      ++h;
    }
  }
}

// B3m's cross-block step. The blocks of a (sample, channel tile) plane
// finish in no fixed order; every sum below is taken in a fixed one, so the
// moments are the same bits run to run. A block's sums go to
// partial[b][t][chunk][tc] (float2: x, x^2; tc = tv * VEC channels); the
// last block of each group of `group` chunks to arrive adds the group's
// partials and writes the total over the group's first slot, and the last
// group to finish adds the groups' totals (one group: it writes the
// moments itself; one chunk: the block writes them at once). Arrival
// counts: arrivals[b][t][0] for the groups, arrivals[b][t][1 + k] for group
// k's blocks, each set back to 0 by the block that read it last, so a
// launch leaves them as it found them. The counts assume launches that
// share them run one after another: the wrapper keeps them per (device,
// stream).
constexpr int kFinalUnroll = 16;  // partial sums a thread loads at once

// The old value of *count, incremented with acquire-release semantics at
// GPU scope: the block's writes (ordered before by __syncthreads) are
// visible to whoever sees the new count, and what the others wrote before
// their increments is visible to this block after it.
__device__ __forceinline__ unsigned arrive(unsigned* count) {
  unsigned old;
  asm volatile("atom.add.acq_rel.gpu.u32 %0, [%1], 1;"
               : "=r"(old)
               : "l"(count)
               : "memory");
  return old;
}

// The compensated sum, in order, of n entries of part, entry e at
// part + e * stride (float2s), for the block's tc channels: thread (c, k)
// adds slice k of S = max(1, min(threads / tc, n)), entries [k n / S,
// (k + 1) n / S), then the slices in order; the totals land in ws_s[c],
// ws_q[c] (ws_* hold S * tc floats). Ends with __syncthreads.
__device__ __forceinline__ void sum_partials(const float2* part, int n,
                                             size_t stride, int tc,
                                             float* ws_s, float* ws_q) {
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int S = max(1, min(nthreads / tc, n));
  for (int i = tid; i < tc * S; i += nthreads) {
    const int c = i % tc, k = i / tc;
    const int pa = (int)((long long)n * k / S);
    const int pb = (int)((long long)n * (k + 1) / S);
    float sum = 0.f, cs = 0.f, sq = 0.f, cq = 0.f;
    for (int p = pa; p < pb; p += kFinalUnroll) {
      float2 e[kFinalUnroll];  // the loads in flight together, then the adds
#pragma unroll
      for (int u = 0; u < kFinalUnroll; ++u)
        e[u] = p + u < pb ? __ldcg(part + (p + u) * stride + c)
                          : make_float2(0.f, 0.f);
#pragma unroll
      for (int u = 0; u < kFinalUnroll; ++u) {
        add_compensated(sum, cs, e[u].x);
        add_compensated(sq, cq, e[u].y);
      }
    }
    ws_s[i] = sum + cs;
    ws_q[i] = sq + cq;
  }
  __syncthreads();
  if (tid < tc) {
    float sum = 0.f, cs = 0.f, sq = 0.f, cq = 0.f;
    for (int k = 0; k < S; ++k) {
      add_compensated(sum, cs, ws_s[k * tc + tid]);
      add_compensated(sq, cq, ws_q[k * tc + tid]);
    }
    ws_s[tid] = sum + cs;  // slot (0, tid): read by this thread alone
    ws_q[tid] = sq + cq;
  }
  __syncthreads();
}

// B3m. Each thread adds x and x^2 of its <= 256 rows in f32, burst by
// burst, the block's groups meet in a fixed pairwise tree in shared
// memory, and the block's sums go through the cross-block step above.
template <typename T, int VEC, int U>
__global__ void __launch_bounds__(kThreads, 2)
    in_moments_kernel(const T* __restrict__ x, float* __restrict__ partial,
                      unsigned* __restrict__ arrivals,
                      float* __restrict__ moments, int HW, int W, int C,
                      long long sample_pitch, long long row_pitch, int tv,
                      int n, int group) {
  using L = Lanes<T, VEC>;
  __shared__ float ws[2 * kThreads * VEC];
  __shared__ unsigned old;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int G = nthreads / tv, g = tid / tv, v = tid - g * tv;
  const int tc = tv * VEC;
  const int b = blockIdx.z, t = blockIdx.y, chunk = blockIdx.x;
  const int chunks = gridDim.x;
  const int c0 = t * tc;
  const T* xb = x + (size_t)b * sample_pitch + c0 + v * VEC;

  float s[VEC], q[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) s[j] = q[j] = 0.f;
  // Double-buffered: the next burst's loads are in flight while this
  // burst's are summed.
  const int stride = chunks * G * n;
  typename L::Raw raw[U], next[U];
  load_burst<T, VEC, U>(xb, chunk * G * n, g, G, n, HW, W, C, row_pitch,
                        raw);
  for (int start = chunk * G * n; start < HW; start += stride) {
    load_burst<T, VEC, U>(xb, start + stride, g, G, n, HW, W, C, row_pitch,
                          next);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float f[VEC];
      L::unpack(raw[u], f);  // 0 past H*W: adds nothing
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        s[j] += f[j];
        q[j] = fmaf(f[j], f[j], q[j]);
      }
      raw[u] = next[u];
    }
  }

  // The block's groups: slot (g, channel) of ws, a pairwise tree over g.
  float* ws_s = ws;
  float* ws_q = ws + kThreads * VEC;
  const int slot = g * tc + v * VEC;
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    ws_s[slot + j] = s[j];
    ws_q[slot + j] = q[j];
  }
  int span = 1;
  while (span < G) span <<= 1;
  for (span >>= 1; span > 0; span >>= 1) {
    __syncthreads();
    if (g < span && g + span < G) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        s[j] += ws_s[slot + span * tc + j];
        q[j] += ws_q[slot + span * tc + j];
        ws_s[slot + j] = s[j];
        ws_q[slot + j] = q[j];
      }
    }
  }
  __syncthreads();
  if (chunks > 1) {
    const size_t bt = (size_t)b * gridDim.y + t;
    const int groups = (chunks + group - 1) / group;
    float2* part = reinterpret_cast<float2*>(partial) + bt * chunks * tc;
    unsigned* count = arrivals + bt * (1 + groups);
    if (g == 0) {
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        part[(size_t)chunk * tc + v * VEC + j] = make_float2(s[j], q[j]);
    }
    // First level: the group's last block adds its <= `group` partials.
    const int k = chunk / group, first = k * group;
    const int members = min(group, chunks - first);
    __syncthreads();
    if (tid == 0) old = arrive(count + 1 + k);
    __syncthreads();
    if (old != (unsigned)members - 1) return;
    if (tid == 0) count[1 + k] = 0u;
    sum_partials(part + (size_t)first * tc, members, tc, tc, ws_s, ws_q);
    if (groups > 1) {
      // Its total over the group's first slot; the last group adds the
      // totals, group k's at chunk slot k * group.
      if (tid < tc)
        part[(size_t)first * tc + tid] = make_float2(ws_s[tid], ws_q[tid]);
      __syncthreads();
      if (tid == 0) old = arrive(count);
      __syncthreads();
      if (old != (unsigned)groups - 1) return;
      if (tid == 0) count[0] = 0u;
      sum_partials(part, groups, (size_t)group * tc, tc, ws_s, ws_q);
    }
  }
  if (tid < tc) {  // ws slot (0, tid): the plane's sums for channel c0 + tid
    const size_t i = (size_t)b * C + c0 + tid;
    moments[i] = ws_s[tid] / (float)HW;
    moments[(size_t)gridDim.z * C + i] = ws_q[tid] / (float)HW;
  }
}

// B3a. Thread (g, v) first makes its VEC channels' mean and rstd from
// moments [2, B, C] summed over `count` shards: mean = m0 / count,
// var = max(m1 / count - mean^2, 0), rstd = rsqrt(var + eps) (a division,
// as the caller's mean of the shards was); then normalizes its rows burst
// by burst and writes contiguous channels_last y.
template <typename T, int VEC, int U>
__global__ void __launch_bounds__(kThreads, 5)
    in_apply_moments_kernel(const T* __restrict__ x, T* __restrict__ y,
                            const float* __restrict__ moments, int HW, int W,
                            int C, long long sample_pitch, long long row_pitch,
                            int tv, int n, int count, int act, float eps) {
  using L = Lanes<T, VEC>;
  const int tid = threadIdx.x;
  const int G = blockDim.x / tv, g = tid / tv, v = tid - g * tv;
  const int b = blockIdx.z;
  const int c = blockIdx.y * tv * VEC + v * VEC;
  float mean[VEC], rstd[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {  // every load issued before any is used
    mean[j] = __ldg(moments + (size_t)b * C + c + j);
    rstd[j] = __ldg(moments + ((size_t)gridDim.z + b) * C + c + j);
  }
  if (count > 1) {  // x / 1 is x: one shard divides nothing
    const float shards = (float)count;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      mean[j] /= shards;
      rstd[j] /= shards;
    }
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j)
    rstd[j] = rsqrtf(fmaxf(rstd[j] - mean[j] * mean[j], 0.f) + eps);
  const T* xb = x + (size_t)b * sample_pitch + c;
  T* yb = y + (size_t)b * HW * C + c;
  // Double-buffered: the next burst's loads are in flight while this
  // burst is normalized and stored.
  const int stride = gridDim.x * G * n;
  typename L::Raw raw[U], next[U];
  load_burst<T, VEC, U>(xb, blockIdx.x * G * n, g, G, n, HW, W, C,
                        row_pitch, raw);
  for (int start = blockIdx.x * G * n; start < HW; start += stride) {
    load_burst<T, VEC, U>(xb, start + stride, g, G, n, HW, W, C, row_pitch,
                          next);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = start + g + u * G;
      if (u < n && p < HW) {
        float f[VEC];
        L::unpack(raw[u], f);
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          f[j] = activate((f[j] - mean[j]) * rstd[j], act);
        *reinterpret_cast<typename L::Raw*>(yb + (size_t)p * C) = L::pack(f);
      }
      raw[u] = next[u];
    }
  }
}

// The plans ops/norm.py plan_instance_moments and plan_instance_apply make:
// grid (chunks, C / (tv * vec), B), blocks of (kThreads / tv) * tv threads,
// bursts of n <= U loads a thread; vec 1 takes the scalar path.
constexpr int kMomentsUnroll = 8, kApplyUnroll = 1;

inline bool plan_ok(int C, int vec, int tv, int chunks, int n, int U,
                    int max_vec) {
  return (vec == 1 || vec == max_vec) && tv >= 1 && tv <= kThreads &&
         tv * vec <= (kThreads / tv) * tv && C % (tv * vec) == 0 &&
         chunks >= 1 && n >= 1 && n <= U;
}

template <typename T>
int moments_launch(const void* x, float* partial, unsigned* arrivals,
                   float* moments, int B, int H, int W, int C,
                   long long sample_pitch, long long row_pitch, int vec,
                   int tv, int chunks, int n, int group,
                   cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (!plan_ok(C, vec, tv, chunks, n, kMomentsUnroll, kVec) || group < 1)
    return cudaErrorInvalidValue;
  const dim3 grid(chunks, C / (tv * vec), B);
  const int threads = (kThreads / tv) * tv;
  if (vec == kVec)
    in_moments_kernel<T, kVec, kMomentsUnroll><<<grid, threads, 0, stream>>>(
        (const T*)x, partial, arrivals, moments, H * W, W, C, sample_pitch,
        row_pitch, tv, n, group);
  else
    in_moments_kernel<T, 1, kMomentsUnroll><<<grid, threads, 0, stream>>>(
        (const T*)x, partial, arrivals, moments, H * W, W, C, sample_pitch,
        row_pitch, tv, n, group);
  return cudaGetLastError();
}

template <typename T>
int apply_launch(const void* x, void* y, const float* moments, int B, int H,
                 int W, int C, long long sample_pitch, long long row_pitch,
                 int vec, int tv, int chunks, int n, int count, int act,
                 float eps, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (!plan_ok(C, vec, tv, chunks, n, kApplyUnroll, kVec) || count < 1)
    return cudaErrorInvalidValue;
  const dim3 grid(chunks, C / (tv * vec), B);
  const int threads = (kThreads / tv) * tv;
  if (vec == kVec)
    in_apply_moments_kernel<T, kVec, kApplyUnroll>
        <<<grid, threads, 0, stream>>>((const T*)x, (T*)y, moments, H * W, W,
                                       C, sample_pitch, row_pitch, tv, n,
                                       count, act, eps);
  else
    in_apply_moments_kernel<T, 1, kApplyUnroll>
        <<<grid, threads, 0, stream>>>((const T*)x, (T*)y, moments, H * W, W,
                                       C, sample_pitch, row_pitch, tv, n,
                                       count, act, eps);
  return cudaGetLastError();
}

// --------------------------------------------------------------------------
// One-pass route: each (sample, channel tile) plane staged in the shared
// memory of a cluster of K blocks.
// Bytes of shared memory a block uses (ops/norm.py onepass_smem): the staged
// [positions][tile] slice, then f32 [warps][2][tile] warp sums, [2][tile]
// block sums (read by the cluster) and [2][tile] mean and rstd.
inline size_t onepass_smem(int positions, int tile, int elem) {
  return (size_t)positions * tile * elem +
         (size_t)(2 * p2p::kOnepassWarps + 4) * tile * sizeof(float);
}

// Grid (K * C / tile, B), cluster (K, 1, 1): cluster blockIdx.x / K owns
// channels [c0, c0 + tile) of sample blockIdx.y, and its block of rank r the
// positions [r * positions, (r + 1) * positions) of H*W. A thread owns the
// 16-byte vector v = tid % V of each position it touches (V = 2^log2v
// vectors a position; 512 % V == 0, so v is fixed for the thread). With
// `saved` (f32 [2, B, C]) rank 0 writes saved[0][b][c] = mean and
// saved[1][b][c] = the clamped variance.
template <typename T>
__global__ void __launch_bounds__(p2p::kOnepassThreads)
    in_onepass_kernel(const T* __restrict__ x, T* __restrict__ y,
                      float* __restrict__ saved, int HW, int W, int C,
                      long long sample_pitch, long long row_pitch, int tile,
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
  P* stage = reinterpret_cast<P*>(smem);
  float* ws = reinterpret_cast<float*>(smem + (size_t)positions * tile *
                                                  sizeof(T));
  float* part = ws + 2 * kOnepassWarps * tile;
  float* mr = part + 2 * tile;

  // 1. Stage the block's positions of the tile: vector i of the slice is
  // position p0 + i / V, channels c0 + (i % V) * VEC onwards.
  const T* xb = x + (size_t)b * sample_pitch + c0 + v * VEC;
  for (int i = tid; i < n_vec; i += kOnepassThreads) {
    const int p = p0 + (i >> log2v);
    const int h = p / W;
    p2p::cp_async16(stage + i,
                    xb + h * row_pitch + (long long)(p - h * W) * C);
  }
  p2p::cp_async_wait_all();
  __syncthreads();

  // 2. The block's sums of x and x^2 per channel: each thread over the
  // positions g, g + G, ... (g = tid / V, G = 512 / V), a butterfly over the
  // lanes of a warp that share v, then the warps in order.
  float s[VEC], q[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) s[j] = q[j] = 0.f;
  const int groups = kOnepassThreads >> log2v;
  for (int p = tid >> log2v; p < np; p += groups) {
    const P in = stage[(p << log2v) + v];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float f = p2p::to_float(in.v[j]);
      s[j] += f;
      q[j] = fmaf(f, f, q[j]);
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

  // 3. The plane's sums: the K blocks' partials in rank order, read through
  // distributed shared memory; the same bits in every block of the cluster.
  if (tid < tile) {
    float S = 0.f, Q = 0.f;
    for (unsigned r = 0; r < K; ++r) {
      const float* other = cluster.map_shared_rank(part, r);
      S += other[tid];
      Q += other[tile + tid];
    }
    const float m = S / (float)HW;
    const float var = fmaxf(Q / (float)HW - m * m, 0.f);
    mr[tid] = m;
    mr[tile + tid] = rsqrtf(var + eps);
    if (saved != nullptr && rank == 0) {
      const size_t i = (size_t)b * C + c0 + tid;
      saved[i] = m;
      saved[(size_t)gridDim.y * C + i] = var;
    }
  }
  p2p::cluster_arrive_release();  // done reading the other blocks
  __syncthreads();

  // 4. Normalize the staged slice and write it, 16 bytes a thread.
  float mean[VEC], rstd[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    mean[j] = mr[v * VEC + j];
    rstd[j] = mr[tile + v * VEC + j];
  }
  T* yb = y + ((size_t)b * HW + p0) * C + c0 + v * VEC;
  for (int i = tid; i < n_vec; i += kOnepassThreads) {
    const P in = stage[i];
    P out;
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      out.v[j] = p2p::from_float<T>(
          activate((p2p::to_float(in.v[j]) - mean[j]) * rstd[j], act));
    *reinterpret_cast<P*>(yb + (size_t)(i >> log2v) * C) = out;
  }
  p2p::cluster_wait_acquire();  // no block leaves while another reads its sums
}

template <typename T>
int onepass(const void* x, void* y, float* saved, int B, int H, int W, int C,
            long long sample_pitch, long long row_pitch, int tile, int K,
            int positions, int act, float eps, cudaStream_t stream) {
  const int HW = H * W;
  const int log2v = p2p::tile_log2v(tile, sizeof(T));
  // a plan that ops/norm.py plan_instance_norm would not make
  if (log2v < 0 || C % tile || K < 1 || K > p2p::kMaxCluster ||
      positions < 1 || (long long)K * positions < HW ||
      (long long)(K - 1) * positions >= HW)
    return cudaErrorInvalidValue;
  const size_t smem = onepass_smem(positions, tile, sizeof(T));
  if (smem > (size_t)p2p::kSmemLimit) return cudaErrorInvalidValue;
  const auto kernel = in_onepass_kernel<T>;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int err = p2p::cluster_config((const void*)kernel, dim3(K * (C / tile), B, 1),
                                K, smem, stream, &cfg, &attr);
  if (err) return err;
  err = cudaLaunchKernelEx(&cfg, kernel, (const T*)x, (T*)y, saved, HW, W, C,
                           sample_pitch, row_pitch, tile, log2v, positions,
                           act, eps);
  if (err) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The one-pass route. x: [B, C, H, W] whose rows of W*C elements are
// contiguous, sample b and row h at x + b * sample_pitch + h * row_pitch
// (elements; multiples of 16 bytes, x 16-byte aligned); y: contiguous
// channels_last; saved: f32 [2, B, C] (mean, clamped variance) written
// when not null. dtype and act as below; the plan (tile channels, cluster
// size, positions per block) is ops/norm.py plan_instance_norm's. Returns
// cudaErrorInvalidValue for a plan it cannot run, and
// cudaErrorInvalidConfiguration when no cluster of the plan fits the card.
int p2p_instance_norm_onepass(const void* x, void* y, void* saved, int B,
                              int H, int W, int C, long long sample_pitch,
                              long long row_pitch, int dtype, int act,
                              float eps, int tile, int cluster, int positions,
                              void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0) return cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    return onepass<__nv_bfloat16>(x, y, (float*)saved, B, H, W, C,
                                  sample_pitch, row_pitch, tile, cluster,
                                  positions, act, eps, s);
  return onepass<float>(x, y, (float*)saved, B, H, W, C, sample_pitch,
                        row_pitch, tile, cluster, positions, act, eps, s);
}

// The two-pass route. x, y: [B, H*W, C] (channels_last [B, C, H, W]);
// dtype 0 = f32, 1 = bf16; act 0 = none, 1 = relu, 2 = leaky(0.2);
// partial: f32 [B, P, C, 2]; stats: f32 [B, C, 2] (mean, rstd) on return;
// saved: f32 [2, B, C] (mean, clamped variance) written when not null.
int p2p_instance_norm_act(const void* x, void* y, void* partial, void* stats,
                          void* saved, int B, int HW, int C, int dtype,
                          int act, float eps, int P, void* stream) {
  if (B <= 0 || HW <= 0 || C <= 0) return cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    return run<__nv_bfloat16>(x, y, (float*)partial, (float*)stats,
                              (float*)saved, B, HW, C, act, eps, P, s);
  return run<float>(x, y, (float*)partial, (float*)stats, (float*)saved, B,
                    HW, C, act, eps, P, s);
}

// Passes 1 and 2 only (the fused enhancer's entry statistics): mean, rstd
// f32 [B, C] on return; the other arguments as above.
int p2p_instance_stats(const void* x, void* partial, void* mean, void* rstd,
                       int B, int HW, int C, int dtype, float eps, int P,
                       void* stream) {
  if (B <= 0 || HW <= 0 || C <= 0) return cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    return stats_pass<__nv_bfloat16>(x, (float*)partial, (float*)mean,
                                     (float*)rstd, 1, B, HW, C, eps, P, s);
  return stats_pass<float>(x, (float*)partial, (float*)mean, (float*)rstd, 1,
                           B, HW, C, eps, P, s);
}

// B3m: the local moments of x [B, C, H, W] (rows of W*C contiguous, sample
// b and row h at x + b * sample_pitch + h * row_pitch, in elements):
// moments f32 [2, B, C] = (mean, E[x^2]) on return. partial: f32
// [B, C, chunks, 2] workspace; arrivals: u32 [B, C / (tv * vec), 1 +
// ceil(chunks / group)], all 0 before the launch and after it. The plan
// (vec, tv, chunks, loads, group) is ops/norm.py plan_instance_moments's;
// vec 16 bytes needs x, the pitches and C * elem on 16 bytes.
int p2p_instance_moments(const void* x, void* partial, void* arrivals,
                         void* moments, int B, int H, int W, int C,
                         long long sample_pitch, long long row_pitch,
                         int dtype, int vec, int tv, int chunks, int loads,
                         int group, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0) return cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    return moments_launch<__nv_bfloat16>(
        x, (float*)partial, (unsigned*)arrivals, (float*)moments, B, H, W, C,
        sample_pitch, row_pitch, vec, tv, chunks, loads, group, s);
  return moments_launch<float>(x, (float*)partial, (unsigned*)arrivals,
                               (float*)moments, B, H, W, C, sample_pitch,
                               row_pitch, vec, tv, chunks, loads, group, s);
}

// B3a: y = act((x - mean) * rsqrt(max(E[x^2] - mean^2, 0) + eps)), mean and
// E[x^2] being moments f32 [2, B, C] divided by `count` (the sum of that
// many shards' moments); x as p2p_instance_moments reads it, y contiguous
// channels_last; the plan (vec, tv, chunks, loads) ops/norm.py
// plan_instance_apply's.
int p2p_instance_apply(const void* x, void* y, const void* moments, int B,
                       int H, int W, int C, long long sample_pitch,
                       long long row_pitch, int dtype, int vec, int tv,
                       int chunks, int loads, int count, int act, float eps,
                       void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0) return cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    return apply_launch<__nv_bfloat16>(x, y, (const float*)moments, B, H, W,
                                       C, sample_pitch, row_pitch, vec, tv,
                                       chunks, loads, count, act, eps, s);
  return apply_launch<float>(x, y, (const float*)moments, B, H, W, C,
                             sample_pitch, row_pitch, vec, tv, chunks, loads,
                             count, act, eps, s);
}

}  // extern "C"
