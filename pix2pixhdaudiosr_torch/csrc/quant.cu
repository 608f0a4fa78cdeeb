// Stochastic-rounding int8 quantizer, f32 [M, N] row-major -> int8 [M, N]
// plus an f32 scale per column [1, N], for sm_90a.
//
// Replaces pix2pixhdaudiosr_tpu/ops/quant.py:stochastic_quantize_2d:
//   scale[n] = max(max_m |x[m, n]|, 1e-12) / 127
//   q[m, n]  = clip(floor(x[m, n] / scale[n] + u), -127, 127)
//   u        = (bits >> 8) * 2^-24
// The TPU kernel drew `bits` from the chip's own PRNG. Here they come from a
// counter-based hash of (seed, flat index i = m * N + n):
//   k = hash32(seed ^ 0x9E3779B9), bits = hash32(hash32(lo ^ k) ^ hi ^ k)
// with (hi, lo) the 32-bit halves of i. ops/quant.py:random_bits computes
// the same integers with torch int64 ops, so the kernel and its twin agree
// bit for bit. Every rounding is pinned (__fdiv_rn, __fadd_rn, __fmul_rn:
// IEEE round to nearest even, never contracted into an FMA), as torch's
// own f32 division and addition round.
//
// What bounds it on this card: device-memory bandwidth. It does a few
// operations per element; at [13824, 1536] (one flagship trunk conv weight
// as 2-D) it must read 85 MB and write 21 MB: ~106 MB, 0.032 ms at
// 3.35 TB/s. The TPU kernel held all of x in VMEM and read it once; a
// column's scale needs every row of it before any q of that column.
//
// Strip route (p2p_stochastic_quantize_strip, quantize_strip_kernel): one
// launch, one read of x. A thread-block cluster of K <= 16 blocks owns a
// strip of `cols` columns (16 to 128 bytes a row; 128 at the flagship
// shape, measured fastest), each block a run of its rows, which it stages
// in shared memory with 16-byte cp.async copies (the row pitch is N * 4
// bytes). Each block takes its columns' max |x| (as
// bits: non-negative floats order as their bit patterns, so the max is
// exact in any order), the cluster's blocks read each other's through
// distributed shared memory, every block computes the same scale, and then
// writes q of its rows from shared memory (rank 0 writes the scale). The
// planner in ops/quant.py (plan_quantize) picks cols and K.
//
// Three-launch route (p2p_stochastic_quantize_2d), for shapes whose strip
// no cluster holds (or a row pitch of no 16-byte multiple):
//   1. absmax: each block owns a tile of up to 256 columns and a chunk of
//      rows. Neighbouring threads read neighbouring columns (coalesced); a
//      shared-memory max over the block's row groups, then one atomicMax a
//      column on the bits of |x| (exact and order-free, as above).
//   2. scale: one thread a column.
//   3. quantize: elementwise over the flat array, 4 elements a thread
//      (16-byte loads) when the sizes and pointers allow it.
// x is read twice.
#include <cooperative_groups.h>
#include <stdint.h>

#include "in_cluster.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTile = 256;        // columns per absmax block
constexpr int kTargetBlocks = 1056;  // 8 blocks per SM on a 132-SM H100
constexpr unsigned kGolden = 0x9E3779B9u;

// lowbias32 (C. Wellons' integer hash); ops/quant.py:_hash32.
__host__ __device__ __forceinline__ unsigned hash32(unsigned x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__global__ void __launch_bounds__(kThreads)
    absmax_kernel(const float* __restrict__ x, unsigned* __restrict__ amax,
                  int M, int N, int rows_per_chunk) {
  __shared__ unsigned s_max[kThreads];
  const int ctw = N < kMaxTile ? N : kMaxTile;  // column tile width
  const int rp = kThreads / ctw;                // row groups in the block
  const int tid = threadIdx.x;
  const int lc = tid % ctw, rg = tid / ctw;
  const int c = blockIdx.x * ctw + lc;
  unsigned m = 0;
  if (rg < rp && c < N) {
    const int r0 = blockIdx.y * rows_per_chunk;
    const int r1 = min(M, r0 + rows_per_chunk);
    for (int r = r0 + rg; r < r1; r += rp)
      m = max(m, __float_as_uint(fabsf(x[(size_t)r * N + c])));
  }
  s_max[tid] = m;
  __syncthreads();
  if (rg == 0 && c < N) {
    for (int g = 1; g < rp; ++g) m = max(m, s_max[g * ctw + lc]);
    atomicMax(amax + c, m);
  }
}

__global__ void scale_kernel(const unsigned* __restrict__ amax,
                             float* __restrict__ scale, int N) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c < N) {
    const float a = __uint_as_float(amax[c]);
    // a < 1e-12 is false for NaN, which passes through as in torch.clamp_min
    scale[c] = __fdiv_rn(a < 1e-12f ? 1e-12f : a, 127.f);
  }
}

__device__ __forceinline__ signed char quantize(float v, float s,
                                                unsigned long long i,
                                                unsigned key) {
  const unsigned bits =
      hash32(hash32((unsigned)i ^ key) ^ (unsigned)(i >> 32) ^ key);
  const float u = __fmul_rn((float)(bits >> 8), 5.9604644775390625e-08f);
  const float f = floorf(__fadd_rn(__fdiv_rn(v, s), u));
  return (signed char)fminf(fmaxf(f, -127.f), 127.f);
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
    quantize_kernel(const float* __restrict__ x,
                    const float* __restrict__ scale,
                    signed char* __restrict__ q, long long n_vec, int N,
                    unsigned key) {
  using In = p2p::Pack<float, VEC>;
  using Out = p2p::Pack<signed char, VEC>;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       v < n_vec; v += stride) {
    const long long i0 = v * VEC;
    int c = (int)(i0 % N);
    const In in = reinterpret_cast<const In*>(x)[v];
    Out out;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      out.v[j] = quantize(in.v[j], scale[c], (unsigned long long)(i0 + j),
                          key);
      if (++c == N) c = 0;
    }
    reinterpret_cast<Out*>(q)[v] = out;
  }
}

template <int VEC>
void launch_quantize(const float* x, const float* scale, signed char* q,
                     long long n, int N, unsigned key, cudaStream_t stream) {
  const long long n_vec = n / VEC;
  long long blocks = (n_vec + kThreads - 1) / kThreads;
  if (blocks > (1 << 20)) blocks = 1 << 20;  // grid-stride beyond this
  quantize_kernel<VEC><<<(unsigned)blocks, kThreads, 0, stream>>>(
      x, scale, q, n_vec, N, key);
}


// Strip route. Grid (K * N / cols), cluster (K, 1, 1), kStripThreads
// threads: cluster blockIdx.x / K owns columns [n0, n0 + cols), its block
// of rank r the rows [r * rows, min(M, (r + 1) * rows)), staged [rows][cols]
// in dynamic shared memory. A thread takes column tid % cols of the rows
// tid / cols, + kStripThreads / cols, ... for the max, and 4 neighbouring
// columns of a row (one 16-byte shared read, one 4-byte store) for q.
constexpr int kStripThreads = 512;

template <int COLS>
__global__ void __launch_bounds__(kStripThreads)
    quantize_strip_kernel(const float* __restrict__ x,
                          signed char* __restrict__ q,
                          float* __restrict__ scale, int M, int N, int rows,
                          unsigned key) {
  extern __shared__ __align__(16) float sx[];  // [rows][COLS]
  __shared__ unsigned s_max[kStripThreads];
  __shared__ unsigned part[COLS];  // this block's column max, as bits
  __shared__ float s_scale[COLS];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned K = cluster.num_blocks();
  const unsigned rank = cluster.block_rank();
  const int tid = threadIdx.x;
  const int n0 = (int)(blockIdx.x / K) * COLS;
  const int m0 = (int)rank * rows;
  const int nr = max(0, min(rows, M - m0));
  constexpr int kChunks = COLS / 4;  // 16-byte copies a row

  // 1. Stage the block's rows of the strip.
  const float* src = x + (size_t)m0 * N + n0;
  for (int i = tid; i < nr * kChunks; i += kStripThreads) {
    const int r = i / kChunks, ch = i - r * kChunks;
    p2p::cp_async16(sx + r * COLS + ch * 4, src + (size_t)r * N + ch * 4);
  }
  p2p::cp_async_wait_all();
  __syncthreads();

  // 2. The block's max |x| a column, then the cluster's.
  constexpr int kGroups = kStripThreads / COLS;
  const int col = tid % COLS;
  unsigned m = 0;
  for (int r = tid / COLS; r < nr; r += kGroups)
    m = max(m, __float_as_uint(fabsf(sx[r * COLS + col])));
  s_max[tid] = m;
  __syncthreads();
  if (tid < COLS) {
    for (int g = 1; g < kGroups; ++g) m = max(m, s_max[g * COLS + tid]);
    part[tid] = m;
  }
  cluster.sync();  // every block's column max is in its shared memory
  if (tid < COLS) {
    unsigned a = 0;
    for (unsigned r = 0; r < K; ++r)
      a = max(a, cluster.map_shared_rank(part, r)[tid]);
    const float af = __uint_as_float(a);
    // af < 1e-12 is false for NaN, which passes through as in torch.clamp_min
    const float s = __fdiv_rn(af < 1e-12f ? 1e-12f : af, 127.f);
    s_scale[tid] = s;
    if (rank == 0) scale[n0 + tid] = s;
  }
  p2p::cluster_arrive_release();  // done reading the other blocks
  __syncthreads();

  // 3. q of the block's rows, 4 columns a thread.
  for (int i = tid; i < nr * kChunks; i += kStripThreads) {
    const int r = i / kChunks, c4 = (i - r * kChunks) * 4;
    const float4 v = *reinterpret_cast<const float4*>(sx + r * COLS + c4);
    const unsigned long long i0 = (unsigned long long)(m0 + r) * N + n0 + c4;
    char4 out;
    out.x = quantize(v.x, s_scale[c4], i0, key);
    out.y = quantize(v.y, s_scale[c4 + 1], i0 + 1, key);
    out.z = quantize(v.z, s_scale[c4 + 2], i0 + 2, key);
    out.w = quantize(v.w, s_scale[c4 + 3], i0 + 3, key);
    *reinterpret_cast<char4*>(q + i0) = out;
  }
  p2p::cluster_wait_acquire();  // no block leaves while another reads it
}

template <int COLS>
int launch_strip(const float* x, signed char* q, float* scale, int M, int N,
                 int K, int rows, unsigned key, cudaStream_t stream) {
  const size_t smem = (size_t)rows * COLS * sizeof(float);
  if (smem > (size_t)p2p::kSmemLimit - 8192) return cudaErrorInvalidValue;
  const auto kernel = quantize_strip_kernel<COLS>;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int err = p2p::cluster_config((const void*)kernel, dim3(K * (N / COLS)),
                                K, smem, stream, &cfg, &attr, kStripThreads);
  if (err) return err;
  err = cudaLaunchKernelEx(&cfg, kernel, x, q, scale, M, N, rows, key);
  if (err) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The three-launch route. x: f32 [M, N] row-major; q: int8 [M, N]; scale:
// f32 [N]; amax: [N] 32-bit words set to 0 by the caller (the column
// absmax bits on return).
int p2p_stochastic_quantize_2d(const void* x, void* q, void* scale, void* amax,
                               int M, int N, unsigned seed, void* stream) {
  if (M <= 0 || N <= 0) return cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const int ctw = N < kMaxTile ? N : kMaxTile;
  const int rp = kThreads / ctw;
  const int col_tiles = p2p::ceil_div(N, ctw);
  const int max_chunks = p2p::ceil_div(M, rp);  // >= rp rows a chunk
  int chunks = p2p::ceil_div(kTargetBlocks, col_tiles);
  if (chunks > max_chunks) chunks = max_chunks;
  if (chunks > 65535) chunks = 65535;  // grid.y limit
  const int rows = p2p::ceil_div(M, chunks);
  const dim3 grid(col_tiles, p2p::ceil_div(M, rows));
  absmax_kernel<<<grid, kThreads, 0, s>>>((const float*)x, (unsigned*)amax, M,
                                          N, rows);
  int err = cudaGetLastError();
  if (err) return err;
  scale_kernel<<<p2p::ceil_div(N, kThreads), kThreads, 0, s>>>(
      (const unsigned*)amax, (float*)scale, N);
  err = cudaGetLastError();
  if (err) return err;
  const unsigned key = hash32(seed ^ kGolden);
  const long long n = (long long)M * N;
  const bool aligned =
      ((uintptr_t)x % 16 == 0) && ((uintptr_t)q % 4 == 0);
  if (n % 4 == 0 && aligned)
    launch_quantize<4>((const float*)x, (const float*)scale, (signed char*)q,
                       n, N, key, s);
  else
    launch_quantize<1>((const float*)x, (const float*)scale, (signed char*)q,
                       n, N, key, s);
  return cudaGetLastError();
}


// The strip route: x f32 [M, N] row-major, 16-byte aligned, N a multiple
// of 4; q int8 [M, N] (4-byte aligned); scale f32 [N]. cols (4, 8, 16 or
// 32) divides N; K blocks a cluster, `rows` rows a block (K * rows >= M >
// (K - 1) * rows): ops/quant.py plan_quantize's plan. Returns
// cudaErrorInvalidValue for a plan it cannot run, and
// cudaErrorInvalidConfiguration when no cluster of the plan fits the card.
int p2p_stochastic_quantize_strip(const void* x, void* q, void* scale, int M,
                                  int N, unsigned seed, int cols, int K,
                                  int rows, void* stream) {
  if (M <= 0 || N <= 0) return cudaGetLastError();
  if (cols < 4 || N % cols || K < 1 || K > p2p::kMaxCluster || rows < 1 ||
      (long long)K * rows < M || (long long)(K - 1) * rows >= M ||
      (uintptr_t)x % 16 || (uintptr_t)q % 4)
    return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned key = hash32(seed ^ kGolden);
  const float* xf = (const float*)x;
  signed char* qc = (signed char*)q;
  float* sc = (float*)scale;
  switch (cols) {
    case 4: return launch_strip<4>(xf, qc, sc, M, N, K, rows, key, s);
    case 8: return launch_strip<8>(xf, qc, sc, M, N, K, rows, key, s);
    case 16: return launch_strip<16>(xf, qc, sc, M, N, K, rows, key, s);
    case 32: return launch_strip<32>(xf, qc, sc, M, N, K, rows, key, s);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
