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
// dy comes in the layout autograd hands it, read in place (ops/norm.py
// dy_layout): "nhwc", rows of W*C contiguous (sample and row pitches), or
// "planar", each channel's H*W positions contiguous (sample and channel
// pitches: an NCHW tensor, as the reflect pad's backward and the
// feature-matching L1 hand it). A planar dy is read along H*W, coalesced,
// with 2- or 4-byte loads (a D plane of 129 x 33 bf16 is 8514 bytes: no
// 16-byte load or copy fits its start), and turned into the kernels'
// [positions][channels] order on the way: through shared memory on the
// one-pass route, in registers (each thread its channels' elements at one
// position) on the two-pass one. dx is always written channels_last.
//
// One-pass route (p2p_instance_norm_grad_onepass, in_grad_onepass_kernel):
// the forward's cluster plan with two staged tensors. A (sample, channel
// tile) plane is split across a thread-block cluster of K <= 16 blocks
// (the planner in ops/norm.py, plan_instance_norm_grad, picks the tile, K
// and the positions per block; the plane of x and dy must fit the
// cluster's shared memory). Each block
//   1. stages its positions' tile channels of x (and an nhwc dy) into
//      shared memory with 16-byte cp.async copies, each through its own
//      sample and row pitches (so a cropped view of x, the same-mode deconv
//      output, and a dy with padded rows are read in place); a planar dy
//      goes in by 16-byte loads along H*W where its planes sit on 16
//      bytes (stage_planar16), else by 32-bit words, a warp a (8
//      positions, 16-byte vector) unit (stage_planar); each staged vector
//      sits at staged_slot, its index XOR a few bits of its position, so
//      that the word stores and the 16-byte reads below fall in distinct
//      banks;
//   2. sums g and g x^ per channel from shared memory in f32 in a fixed
//      order (thread, warp butterfly, warps in order);
//   3. adds the K blocks' partials in rank order through distributed
//      shared memory: every block holds the same bits, run after run;
//   4. writes dx from its staged slice, 16-byte vectors into a contiguous
//      channels_last tensor of the view's shape.
// One HBM read of x and dy and one write of dx: 3 planes.
//
// Two-pass route (p2p_instance_norm_grad_twopass), for planes whose x and
// dy no cluster holds at a tile of a 32-byte sector (512 x 128 x 48: 4.2
// MB against 16 x 227 KB; there it measured faster on an H100 than the
// one-pass plan at a 16-byte tile and than three 3-plane designs, PERF.md)
// and rows that are no multiple of 16 bytes:
//   1. in_grad_partial_kernel: a block owns (sample, a chunk of H*W rows, a
//      tile of channel vectors), neighbouring threads on neighbouring
//      16-byte vectors (coalesced), and writes f32 partial sums of g and
//      g x^ to a workspace [B, P, C, 2];
//   2. in_grad_finalize_kernel: one thread per (b, c) adds the P partials
//      in a fixed order (deterministic, no atomics) and writes (mean, rstd,
//      mean(g), mean(g x^)) to [B, C, 4];
//   3. in_grad_apply_kernel: x and dy read again on the partial kernel's
//      grid, each thread's coefficients in registers, and dx written.
// 5 planes, no atomics.
#include <cooperative_groups.h>
#include <stdint.h>

#include "in_cluster.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;  // two-pass blocks
constexpr int kDyNHWC = 0;     // ops/norm.py DY_LAYOUTS
constexpr int kDyPlanar = 1;
constexpr int kDyPlanar16 = 2;  // planar, every plane and run on 16 bytes

// g = dy * act'(x^), as a select (a NaN dy stays where the slope is 1)
__device__ __forceinline__ float slope_times(float dy, float xh, int act) {
  if (act == 1) return xh > 0.f ? dy : 0.f;
  if (act == 2) return xh >= 0.f ? dy : 0.2f * dy;
  return dy;
}

// The 16-byte vector v of staged position p of a [positions][V] slice
// (V = 2^log2v) sits at this index: v XOR bits of p, so that the 8
// positions of a planar staging unit (rows of V vectors) and the 8 vectors
// a quarter warp reads both cover the 8 16-byte slots of a 128-byte bank
// line once.
__device__ __forceinline__ int staged_slot(int p, int v, int log2v) {
  const int shift = log2v < 3 ? 3 - log2v : 0;
  const int mask = (log2v < 3 ? 1 << log2v : 8) - 1;
  return (p << log2v) + (v ^ ((p >> shift) & mask));
}

// The 32-bit word of channels (c, c + 1) (bf16) or c (f32) at one position
// of a planar dy, `chan` elements between channels.
__device__ __forceinline__ uint32_t planar_word(const float* s, long long) {
  return __ldg(reinterpret_cast<const unsigned*>(s));
}
__device__ __forceinline__ uint32_t planar_word(const __nv_bfloat16* s,
                                                long long chan) {
  const unsigned short* u = reinterpret_cast<const unsigned short*>(s);
  return (uint32_t)__ldg(u) | ((uint32_t)__ldg(u + chan) << 16);
}

// Stages a planar dy's positions [0, np) of V * VEC channels into `staged`
// at staged_slot. src: the first channel's first position; chan: elements
// between channels. Warp w takes the units w, w + warps, ... of (8
// positions, one 16-byte vector), lane (pl, wl) = (lane / 4, lane % 4) the
// 32-bit word wl of position 8 * unit + pl: a load instruction reads 8
// neighbouring positions of 4 channels; a store fills 32 banks.
template <typename T>
__device__ __forceinline__ void stage_planar(const T* __restrict__ src,
                                             long long chan, int np,
                                             int log2v, void* staged,
                                             int warp, int warps, int lane) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CPW = 4 / sizeof(T);  // channels a word
  constexpr int kBatch = 8;           // loads in flight a lane
  const int V = 1 << log2v;
  const int pl = lane >> 2, wl = lane & 3;
  const int n_units = ((np + 7) >> 3) << log2v;
  uint32_t* words = reinterpret_cast<uint32_t*>(staged);
  for (int u0 = warp; u0 < n_units; u0 += kBatch * warps) {
    uint32_t w[kBatch];
    int at[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int u = u0 + k * warps;
      const int p = ((u >> log2v) << 3) + pl;
      const int v = u & (V - 1);
      at[k] = -1;
      if (u < n_units && p < np) {
        w[k] = planar_word(src + (long long)(v * VEC + wl * CPW) * chan + p,
                           chan);
        at[k] = staged_slot(p, v, log2v) * 4 + wl;
      }
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      if (at[k] >= 0) words[at[k]] = w[k];
  }
}

// As stage_planar, where the channel planes, the sample pitch, the start
// and the block's first position all sit on 16 bytes (a G plane of 256 x
// 64 bf16): lane (cl, pq) loads the 16 bytes of E = 16 / sizeof(T)
// neighbouring positions of one channel (CL = min(tile, 32) channels, 32 /
// CL runs of E positions a warp instruction) and stores them an element a
// staged row; the positions past the last whole run, one element a thread.
template <typename T>
__device__ __forceinline__ void stage_planar16(const T* __restrict__ src,
                                               long long chan, int np,
                                               int tile, int log2v,
                                               T* staged, int tid,
                                               int threads) {
  constexpr int E = 16 / sizeof(T);  // positions a load, channels a vector
  constexpr int kBatch = 4;          // loads in flight a lane
  const int lane = tid & 31, warp = tid >> 5, warps = threads >> 5;
  const int CL = tile < 32 ? tile : 32;
  const int PQ = 32 / CL;
  const int cl = lane % CL, pq = lane / CL;
  const int n_runs = np / E;
  const int n_cg = tile / CL;
  const int units = ((n_runs + PQ - 1) / PQ) * n_cg;
  for (int u0 = warp; u0 < units; u0 += kBatch * warps) {
    uint4 w[kBatch];
    int run[kBatch], ch[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int u = u0 + k * warps;
      run[k] = (u / n_cg) * PQ + pq;
      ch[k] = (u % n_cg) * CL + cl;
      if (u >= units) run[k] = n_runs;  // nothing to stage
      if (run[k] < n_runs)
        w[k] = __ldg(reinterpret_cast<const uint4*>(src + ch[k] * chan) +
                     run[k]);
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (run[k] >= n_runs) continue;
      const T* e = reinterpret_cast<const T*>(&w[k]);
#pragma unroll
      for (int i = 0; i < E; ++i)
        staged[staged_slot(run[k] * E + i, ch[k] / E, log2v) * E +
               ch[k] % E] = e[i];
    }
  }
  for (int i = tid; i < (np - n_runs * E) * tile; i += threads) {
    const int p = n_runs * E + i / tile, ch = i % tile;
    staged[staged_slot(p, ch / E, log2v) * E + ch % E] = src[ch * chan + p];
  }
}

// VEC channels of dy from c at flat position r (h = r / W): a 16-byte load
// of an nhwc dy (db: the sample's channel c), VEC loads along the channel
// planes of a planar one (db: channel c's plane, `pitch` apart).
template <typename T, int VEC>
__device__ __forceinline__ void load_dy(float (&out)[VEC],
                                        const T* __restrict__ db, int layout,
                                        long long pitch, int r, int W,
                                        int C) {
  if (layout == kDyNHWC) {
    const int h = r / W;
    const p2p::Pack<T, VEC> d = *reinterpret_cast<const p2p::Pack<T, VEC>*>(
        db + h * pitch + (long long)(r - h * W) * C);
#pragma unroll
    for (int j = 0; j < VEC; ++j) out[j] = p2p::to_float(d.v[j]);
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      out[j] = p2p::to_float(db[(long long)j * pitch + r]);
  }
}

// The sample's dy at channel c: the first element load_dy reads.
template <typename T>
__device__ __forceinline__ const T* dy_at(const T* dy, int b, int c,
                                          int layout, long long sample,
                                          long long pitch) {
  return dy + (size_t)b * sample + (layout == kDyNHWC ? c : c * pitch);
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
// forward's mean and clamped variance. dy_pitch: an nhwc dy's row pitch or
// a planar dy's channel pitch.
template <typename T>
__global__ void __launch_bounds__(p2p::kOnepassThreads)
    in_grad_onepass_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                           T* __restrict__ dx,
                           const float* __restrict__ saved, int HW, int W,
                           int C, long long x_sample, long long x_row,
                           int dy_layout, long long dy_sample,
                           long long dy_pitch, int tile, int log2v,
                           int positions, int act, float eps) {
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
  const bool nhwc = dy_layout == kDyNHWC;
  for (int i = tid; i < n_vec; i += kOnepassThreads) {
    const int pi = i >> log2v;
    const int h = (p0 + pi) / W;
    const long long w_off = (long long)(p0 + pi - h * W) * C;
    const int at = staged_slot(pi, v, log2v);
    p2p::cp_async16(sx + at, xb + h * x_row + w_off);
    if (nhwc) p2p::cp_async16(sdy + at, db + h * dy_pitch + w_off);
  }
  const T* dy_run = dy + (size_t)b * dy_sample + (long long)c0 * dy_pitch + p0;
  if (dy_layout == kDyPlanar)
    stage_planar<T>(dy_run, dy_pitch, np, log2v, sdy, warp, kOnepassWarps,
                    lane);
  else if (dy_layout == kDyPlanar16)
    stage_planar16<T>(dy_run, dy_pitch, np, tile, log2v,
                      reinterpret_cast<T*>(sdy), tid, kOnepassThreads);
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
    const int at = staged_slot(p, v, log2v);
    const P xin = sx[at];
    const P din = sdy[at];
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
    const int at = staged_slot(i >> log2v, v, log2v);
    const P xin = sx[at];
    const P din = sdy[at];
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

// kDyPlanar16 where a planar dy's planes, sample pitch, start and every
// block's first position sit on 16 bytes.
template <typename T>
int planar_alignment(int dy_layout, const void* dy, long long dy_sample,
                     long long dy_pitch, int positions) {
  if (dy_layout == kDyPlanar &&
      (((uintptr_t)dy | (unsigned long long)(dy_pitch * sizeof(T)) |
        (unsigned long long)(dy_sample * sizeof(T)) |
        (unsigned long long)(positions * sizeof(T))) % 16) == 0)
    return kDyPlanar16;
  return dy_layout;
}

template <typename T>
int onepass(const void* x, const void* dy, void* dx, const float* saved,
            int B, int H, int W, int C, long long x_sample, long long x_row,
            int dy_layout, long long dy_sample, long long dy_pitch, int tile,
            int K, int positions, int act, float eps, cudaStream_t stream) {
  const int HW = H * W;
  const int log2v = p2p::tile_log2v(tile, sizeof(T));
  // a plan that ops/norm.py plan_instance_norm_grad would not make
  if (log2v < 0 || C % tile || K < 1 || K > p2p::kMaxCluster ||
      positions < 1 || (long long)K * positions < HW ||
      (long long)(K - 1) * positions >= HW ||
      (dy_layout != kDyNHWC && dy_layout != kDyPlanar))
    return cudaErrorInvalidValue;
  const size_t smem = grad_onepass_smem(positions, tile, sizeof(T));
  if (smem > (size_t)p2p::kSmemLimit) return cudaErrorInvalidValue;
  dy_layout = planar_alignment<T>(dy_layout, dy, dy_sample, dy_pitch,
                                  positions);
  const auto kernel = in_grad_onepass_kernel<T>;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int err = p2p::cluster_config((const void*)kernel,
                                dim3(K * (C / tile), B, 1), K, smem, stream,
                                &cfg, &attr);
  if (err) return err;
  err = cudaLaunchKernelEx(&cfg, kernel, (const T*)x, (const T*)dy, (T*)dx,
                           saved, HW, W, C, x_sample, x_row, dy_layout,
                           dy_sample, dy_pitch, tile, log2v, positions, act,
                           eps);
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
                           long long x_sample, long long x_row, int dy_layout,
                           long long dy_sample, long long dy_pitch,
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
    const T* db = dy_at(dy, b, c, dy_layout, dy_sample, dy_pitch);
    const int r0 = p * rows_per_chunk;
    const int r1 = min(HW, r0 + rows_per_chunk);
    for (int r = r0 + rg; r < r1; r += groups) {
      const int h = r / W;
      const P xin = *reinterpret_cast<const P*>(
          xb + h * x_row + (long long)(r - h * W) * C);
      float d[VEC];
      load_dy<T, VEC>(d, db, dy_layout, dy_pitch, r, W, C);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float xh = (p2p::to_float(xin.v[j]) - mean[j]) * rstd[j];
        const float g = slope_times(d[j], xh, act);
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
                         long long x_row, int dy_layout, long long dy_sample,
                         long long dy_pitch, int rows_per_chunk, int act) {
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
  const T* db = dy_at(dy, b, c, dy_layout, dy_sample, dy_pitch);
  T* dxb = dx + (size_t)b * HW * C + c;
  const int r0 = p * rows_per_chunk;
  const int r1 = min(HW, r0 + rows_per_chunk);
  for (int r = r0 + rg; r < r1; r += groups) {
    const int h = r / W;
    const P xin = *reinterpret_cast<const P*>(
        xb + h * x_row + (long long)(r - h * W) * C);
    float d[VEC];
    load_dy<T, VEC>(d, db, dy_layout, dy_pitch, r, W, C);
    P out;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float xh = (p2p::to_float(xin.v[j]) - k[0][j]) * k[1][j];
      const float g = slope_times(d[j], xh, act);
      out.v[j] = p2p::from_float<T>(k[1][j] * (g - k[2][j] - xh * k[3][j]));
    }
    *reinterpret_cast<P*>(dxb + (size_t)r * C) = out;
  }
}

template <typename T, int VEC>
int twopass(const void* x, const void* dy, void* dx, const float* saved,
            float* partial, float* coef, int B, int H, int W, int C,
            long long x_sample, long long x_row, int dy_layout,
            long long dy_sample, long long dy_pitch, int act, float eps,
            int P, cudaStream_t stream) {
  const int HW = H * W;
  const int nv = C / VEC;
  if (C % VEC || P < 1 || P > HW ||
      (dy_layout != kDyNHWC && dy_layout != kDyPlanar))
    return cudaErrorInvalidValue;
  const int ctv = nv < kThreads ? nv : kThreads;
  dim3 grid(P, p2p::ceil_div(nv, ctv), B);
  in_grad_partial_kernel<T, VEC><<<grid, kThreads, 0, stream>>>(
      (const T*)x, (const T*)dy, saved, partial, HW, W, C, x_sample, x_row,
      dy_layout, dy_sample, dy_pitch, p2p::ceil_div(HW, P), act, eps);
  int err = cudaGetLastError();
  if (err) return err;
  in_grad_finalize_kernel<<<p2p::ceil_div(B * C, kThreads), kThreads, 0,
                            stream>>>(partial, saved, coef, B, C, P, HW, eps);
  err = cudaGetLastError();
  if (err) return err;
  in_grad_apply_kernel<T, VEC><<<grid, kThreads, 0, stream>>>(
      (const T*)x, (const T*)dy, (T*)dx, coef, HW, W, C, x_sample, x_row,
      dy_layout, dy_sample, dy_pitch, p2p::ceil_div(HW, P), act);
  return cudaGetLastError();
}

template <typename T>
int twopass_vec(const void* x, const void* dy, void* dx, const float* saved,
                float* partial, float* coef, int B, int H, int W, int C,
                long long x_sample, long long x_row, int dy_layout,
                long long dy_sample, long long dy_pitch, int act, float eps,
                int P, int vec, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (vec == kVec)
    return twopass<T, kVec>(x, dy, dx, saved, partial, coef, B, H, W, C,
                            x_sample, x_row, dy_layout, dy_sample, dy_pitch,
                            act, eps, P, stream);
  if (vec == 1)
    return twopass<T, 1>(x, dy, dx, saved, partial, coef, B, H, W, C,
                         x_sample, x_row, dy_layout, dy_sample, dy_pitch, act,
                         eps, P, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// The one-pass route. x: [B, C, H, W] whose rows of W*C elements are
// contiguous, sample b and row h at x + b * x_sample + h * x_row (elements;
// multiples of 16 bytes, 16-byte aligned); dy: dy_layout 0 (nhwc) as x,
// with dy_sample and its row pitch dy_pitch (16-byte multiples and start),
// or 1 (planar), sample b and channel c's H*W positions from dy +
// b * dy_sample + c * dy_pitch (any alignment); dx: contiguous
// channels_last [B, C, H, W]; saved: f32 [2, B, C], the forward's (mean,
// clamped variance). dtype 0 = f32, 1 = bf16; act 0 = none, 1 = relu, 2 =
// leaky(0.2); the plan (tile channels, cluster size, positions per block)
// is ops/norm.py plan_instance_norm_grad's. Returns cudaErrorInvalidValue
// for a plan it cannot run, and cudaErrorInvalidConfiguration when no
// cluster of the plan fits the card.
int p2p_instance_norm_grad_onepass(const void* x, const void* dy, void* dx,
                                   const void* saved, int B, int H, int W,
                                   int C, long long x_sample, long long x_row,
                                   int dy_layout, long long dy_sample,
                                   long long dy_pitch, int dtype, int act,
                                   float eps, int tile, int cluster,
                                   int positions, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0) return cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    return onepass<__nv_bfloat16>(x, dy, dx, (const float*)saved, B, H, W, C,
                                  x_sample, x_row, dy_layout, dy_sample,
                                  dy_pitch, tile, cluster, positions, act,
                                  eps, s);
  return onepass<float>(x, dy, dx, (const float*)saved, B, H, W, C, x_sample,
                        x_row, dy_layout, dy_sample, dy_pitch, tile, cluster,
                        positions, act, eps, s);
}

// The two-pass route: x, dy, dx, saved, dtype and act as above, but the
// pitches need only be multiples of `vec` elements (vec = 16 bytes of
// elements, or 1); partial: f32 [B, P, C, 2] and coef: f32 [B, C, 4]
// workspaces.
int p2p_instance_norm_grad_twopass(const void* x, const void* dy, void* dx,
                                   const void* saved, void* partial,
                                   void* coef, int B, int H, int W, int C,
                                   long long x_sample, long long x_row,
                                   int dy_layout, long long dy_sample,
                                   long long dy_pitch, int dtype, int act,
                                   float eps, int P, int vec, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0) return cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    return twopass_vec<__nv_bfloat16>(
        x, dy, dx, (const float*)saved, (float*)partial, (float*)coef, B, H,
        W, C, x_sample, x_row, dy_layout, dy_sample, dy_pitch, act, eps, P,
        vec, s);
  return twopass_vec<float>(x, dy, dx, (const float*)saved, (float*)partial,
                            (float*)coef, B, H, W, C, x_sample, x_row,
                            dy_layout, dy_sample, dy_pitch, act, eps, P, vec,
                            s);
}

}  // extern "C"
