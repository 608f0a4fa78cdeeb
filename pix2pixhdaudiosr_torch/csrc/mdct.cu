// MDCT2 / IMDCT2 lapped transforms, f32, for sm_90a.
//
// Replaces pix2pixhdaudiosr_tpu/ops/dct_pallas.py:fused_mdct2 (p2p_mdct2_f32)
// and pix2pixhdaudiosr_tpu/ops/dct_pallas.py:fused_imdct2 (p2p_imdct2_f32).
//
// Forward:  out[b, t, f] = sum_k x_pad[b, t*hop + k] * basis[k, f]
//           (basis [win, n_fft] = window * DCT-II / n_fft, ops/mdct.py)
// Inverse:  out[b, n] = sum_{t : 0 <= n - t*hop < win} sum_f
//                           spec[b, t, f] * basis[f, n - t*hop]
//           (basis [n_fft, win] = DCT-III * window / 2), un-cropped
//           [B, (T-1)*hop + win]; the centre crop and out_length fit stay
//           in torch, as in the JAX package.
//
// What bounds them on this card: arithmetic. At the flagship size (batch
// 128, T = 128, win = n_fft = 512) each is 8.6 GFLOP against ~17 MB in and
// ~34 MB out, far above the f32 ridge point, and the JAX package asks for
// full f32 (Precision.HIGHEST), so TF32 and bf16 tensor cores are out.
//
// Design: both are one register-tiled f32 FFMA GEMM (tile_gemm below) whose
// operands are gathered on the fly, so neither the [B*T, win] frame matrix
// of the forward nor the [B*T, win] frames of the inverse ever reach device
// memory. The forward reads frame t of sample b as the strided window
// x_pad[b, t*hop : t*hop + win] (an implicit im2col that holds for any hop,
// so unlike the TPU kernel win % hop != 0 is covered). The inverse makes
// the overlap-add part of the reduction: an output tile [b0, b0+BM) x
// [n0, n0+BN) sums over exactly the frames whose windows meet [n0, n0+BN),
// with the basis read as zero outside a frame's window. Accumulation is
// plain f32 FFMA; tiles stage through shared memory, 4x4 outputs a thread.
#include "common.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4;
constexpr int NTX = BN / TN;            // threads along n
constexpr int NTY = BM / TM;            // threads along m
constexpr int NTHREADS = NTX * NTY;     // 256

// acc[i][j] += sum_{k < K} A(ty + i*NTY, k) * B(k, tx + j*NTX), where A and
// B are functors that return 0 outside their valid range.
template <class LoadA, class LoadB>
__device__ __forceinline__ void tile_gemm(int K, const LoadA& load_a,
                                          const LoadB& load_b,
                                          float (&acc)[TM][TN]) {
  __shared__ float As[BK][BM + 4];  // +4: fewer bank conflicts on the store
  __shared__ float Bs[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % NTX, ty = tid / NTX;
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int e = tid; e < BM * BK; e += NTHREADS) {
      const int m = e / BK, k = e % BK;
      As[k][m] = (k0 + k < K) ? load_a(m, k0 + k) : 0.f;
    }
#pragma unroll
    for (int e = tid; e < BK * BN; e += NTHREADS) {
      const int k = e / BN, n = e % BN;
      Bs[k][n] = (k0 + k < K) ? load_b(k0 + k, n) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[k][ty + i * NTY];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[k][tx + j * NTX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// grid (ceil(n_fft/BN), ceil(T/BM), B)
__global__ void __launch_bounds__(NTHREADS)
    mdct2_kernel(const float* __restrict__ x, const float* __restrict__ basis,
                 float* __restrict__ out, int L, int T, int win, int hop,
                 int n_fft) {
  const int b = blockIdx.z;
  const int t0 = blockIdx.y * BM;
  const int f0 = blockIdx.x * BN;
  const float* xb = x + (size_t)b * L;
  auto load_a = [&](int i, int k) -> float {
    const int t = t0 + i;
    return t < T ? __ldg(xb + (size_t)t * hop + k) : 0.f;
  };
  auto load_b = [&](int k, int j) -> float {
    const int f = f0 + j;
    return f < n_fft ? __ldg(basis + (size_t)k * n_fft + f) : 0.f;
  };
  float acc[TM][TN] = {};
  tile_gemm(win, load_a, load_b, acc);
  const int tx = threadIdx.x % NTX, ty = threadIdx.x / NTX;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int t = t0 + ty + i * NTY;
    if (t >= T) continue;
    float* row = out + ((size_t)b * T + t) * n_fft;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int f = f0 + tx + j * NTX;
      if (f < n_fft) row[f] = acc[i][j];
    }
  }
}

// grid (ceil(out_len/BN), ceil(B/BM))
__global__ void __launch_bounds__(NTHREADS)
    imdct2_kernel(const float* __restrict__ spec,
                  const float* __restrict__ basis, float* __restrict__ out,
                  int B, int T, int n_fft, int win, int hop, int out_len) {
  const int b0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  // frames whose window [t*hop, t*hop + win) meets [n0, n0 + BN)
  const int lo = n0 - win + 1;
  const int t_lo = lo <= 0 ? 0 : p2p::ceil_div(lo, hop);
  const int t_hi = min(T - 1, (n0 + BN - 1) / hop);
  const int K = t_hi >= t_lo ? (t_hi - t_lo + 1) * n_fft : 0;
  auto load_a = [&](int i, int kk) -> float {
    const int b = b0 + i;
    const int t = t_lo + kk / n_fft, f = kk % n_fft;
    return b < B ? __ldg(spec + ((size_t)b * T + t) * n_fft + f) : 0.f;
  };
  auto load_b = [&](int kk, int j) -> float {
    const int t = t_lo + kk / n_fft, f = kk % n_fft;
    const int d = n0 + j - t * hop;  // offset inside frame t's window
    return (n0 + j < out_len && d >= 0 && d < win)
               ? __ldg(basis + (size_t)f * win + d)
               : 0.f;
  };
  float acc[TM][TN] = {};
  tile_gemm(K, load_a, load_b, acc);
  const int tx = threadIdx.x % NTX, ty = threadIdx.x / NTX;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int b = b0 + ty + i * NTY;
    if (b >= B) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + j * NTX;
      if (n < out_len) out[(size_t)b * out_len + n] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

// x: [B, L] padded signal; basis: [win, n_fft]; out: [B, T, n_fft],
// T = (L - win) / hop + 1.
int p2p_mdct2_f32(const void* x, const void* basis, void* out, int B, int L,
                  int T, int win, int hop, int n_fft, void* stream) {
  if (B <= 0 || T <= 0) return cudaGetLastError();
  dim3 grid(p2p::ceil_div(n_fft, BN), p2p::ceil_div(T, BM), B);
  mdct2_kernel<<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)basis, (float*)out, L, T, win, hop,
      n_fft);
  return cudaGetLastError();
}

// spec: [B, T, n_fft]; basis: [n_fft, win]; out: [B, (T-1)*hop + win].
int p2p_imdct2_f32(const void* spec, const void* basis, void* out, int B,
                   int T, int n_fft, int win, int hop, void* stream) {
  const int out_len = (T - 1) * hop + win;
  if (B <= 0 || T <= 0) return cudaGetLastError();
  dim3 grid(p2p::ceil_div(out_len, BN), p2p::ceil_div(B, BM));
  imdct2_kernel<<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(
      (const float*)spec, (const float*)basis, (float*)out, B, T, n_fft, win,
      hop, out_len);
  return cudaGetLastError();
}

const char* p2p_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
