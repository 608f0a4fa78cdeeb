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
// as 2-D) it reads 85 MB twice and writes 21 MB: ~190 MB, ~0.06 ms at
// 3.35 TB/s.
//
// Design: three launches on the wrapper's stream.
//   1. absmax: each block owns a tile of up to 256 columns and a chunk of
//      rows. Neighbouring threads read neighbouring columns (coalesced); a
//      shared-memory max over the block's row groups, then one atomicMax a
//      column on the bits of |x|. Non-negative floats order as their bit
//      patterns, so the max is exact and the same in any order
//      (deterministic). The TPU kernel held the whole array in VMEM; one
//      block per column tile would leave most of the 132 SMs idle at
//      N = 1536, hence the row chunks (about 8 blocks an SM).
//   2. scale: one thread a column.
//   3. quantize: elementwise over the flat array, 4 elements a thread
//      (16-byte loads) when the sizes and pointers allow it.
#include <stdint.h>

#include "common.cuh"

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

}  // namespace

extern "C" {

// x: f32 [M, N] row-major; q: int8 [M, N]; scale: f32 [N]; amax: [N] 32-bit
// words set to 0 by the caller (the column absmax bits on return).
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

}  // extern "C"
