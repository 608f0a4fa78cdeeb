// MDCT2 / IMDCT2 lapped transforms, f32, for sm_90a.
//
// Replaces pix2pixhdaudiosr_tpu/ops/dct_pallas.py:fused_mdct2 (B1, the
// pallas_call at :85) and :fused_imdct2 (B2, :134).
//
// Forward:  out[b, t, f] = sum_k x_pad[b, t*hop + k] * basis[k, f]
//           (basis [win, n_fft] = window * DCT-II / n_fft, ops/mdct.py)
// Inverse:  out[b, n] = sum_{t : 0 <= n - t*hop < win} sum_f
//                           spec[b, t, f] * basis[f, n - t*hop]
//           (basis [n_fft, win] = DCT-III * window / 2), un-cropped
//           [B, (T-1)*hop + win]; the centre crop and out_length fit stay
//           in torch, as in the JAX package.
//
// What bounds them on this card. At the flagship size (batch 128, T = 128,
// win = n_fft = 512) each is 2 * 16384 * 512 * 512 = 8.59 GFLOP against
// ~17 MB in and ~34 MB out (0.015 ms of bytes at 3.35 TB/s): arithmetic
// bounds them. The JAX package asks for full f32 (Precision.HIGHEST), so a
// plain TF32 product (10-bit mantissa) is out. On FFMA the floor is
// 8.59 G / 67 T = 0.128 ms. 3xTF32 keeps ~f32 accuracy on the tensor
// cores: each operand is split as a = hi + lo with hi = tf32(a) rounded to
// nearest and lo the tf32 part of a - hi, and a*b ~ lo*hi + hi*lo + hi*hi
// (the dropped lo*lo is ~2^-22 of the product). Its floor is
// 3 * 8.59 G / 495 T = 0.052 ms, the bound these kernels are held to.
//
// Design (the tensor-core route, p2p_{mdct2,imdct2}_tc): both transforms are
// one GEMM, out[M, N] = A[M, K] @ Bt[N, K]^T, whose A rows are gathered
// straight from the signal or the spectrogram, so no frame matrix reaches
// device memory.
//   forward  M = B*T rows, row (b, t) = x_pad[b, t*hop : t*hop + win] (an
//            implicit im2col); N = n_fft; K = win.
//   inverse  the overlap-add is a K-reduction over rows of hop samples:
//            out[b, j*hop : (j+1)*hop] = sum_{i<m} spec[b, j-i, :] @
//            basis[:, i*hop : (i+1)*hop], m = win/hop, frames outside
//            [0, T) read as zero. M = B*(T+m-1) rows flattened across
//            samples, N = hop, K = m*n_fft; the [B*(T+m-1), hop] result is
//            the un-cropped signal itself. No atomics.
// Block tile 128x128, two consumer warpgroups of 64 rows, each issuing
// wgmma.m64n128k8.f32.tf32.tf32 with A from registers and B from shared
// memory. tf32 wgmma reads shared operands K-major only, so the basis is
// stored transposed: the wrappers split it once into K-major hi and lo planes
// (ops/mdct_kernels.py, tf32_split, both rounded as cvt.rna rounds), and
// each A fragment is split in registers after it is read from shared memory
// (tf32_split below). A k-step of 8 issues lo*hi, hi*lo, then hi*hi. Each
// stage's three-product sum runs in its own accumulator and is added to the
// running f32 sum with an FADD, so no tensor-core accumulation spans more
// than 32 of K. Operands arrive through a 4-slot ring of 16-byte cp.async
// copies (zero-fill for rows, columns and frames out of range) into
// 128-byte-swizzled [128][32] f32 tiles: 48 KB a stage (A, B hi, B lo),
// 193 KB in all. Step k issues stage k's wgmmas, then the copies of stage
// k+2, then, once stage k+1 has landed, splits its A fragments while the
// wgmmas run. Every thread both copies and consumes, so one block barrier
// a step publishes the copies (cp.async.wait_group, then bar.sync) where a
// producer warp would need mbarriers. Four slots, not three: step k
// refills the slot of stage k-2, which both warpgroups have retired, while
// the other warpgroup's wgmmas may still read stage k-1's.
// Route: win % hop == 0, hop % 4 == 0 and n_fft % 4 == 0 (16-byte copies;
// the TPU kernels' own condition is win % hop == 0). Other codecs take the
// FFMA route below (p2p_{mdct2,imdct2}_f32): one register-tiled f32 GEMM
// with gathered operands that takes any hop.
#include <cstddef>
#include <cstdint>

#include "common.cuh"

namespace {

// --------------------------------------------------------------------------
// Tensor-core route: 3xTF32 wgmma fed by a cp.async ring.
namespace tc {

constexpr int BM = 128, BN = 128, BK = 32, STAGES = 4, NTHREADS = 256;
constexpr int TILE = BM * BK * 4;            // one [128][32] f32 tile, bytes
static_assert(BN == BM, "the A tile and the B planes share one tile shape");
constexpr int STAGE = 3 * TILE;              // A, B hi, B lo
constexpr int SMEM = STAGES * STAGE + 1024;  // + room to align to 1024 B

// Byte offset of element (r, k) in a [128][32] f32 tile with the 128-byte
// swizzle wgmma expects: 16-byte chunk k/4 of row r sits at chunk
// (k/4) ^ (r % 8). Also makes the A-fragment reads bank-conflict free.
__device__ __forceinline__ uint32_t swz(int r, int k) {
  return r * 128 + ((((k >> 2) ^ r) & 7) << 4) + ((k & 3) << 2);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy; zero-fills the destination when !valid (src is not read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
// Makes this thread's completed generic-proxy (cp.async) writes visible to
// the async proxy that wgmma reads shared memory through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pin a register across the asynchronous wgmma region (cf. CUTLASS's
// warpgroup_fence_operand): the compiler may not move its uses across.
__device__ __forceinline__ void pin(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
__device__ __forceinline__ void pin(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}

// The 3xTF32 split of an A element: hi = cvt.rna.tf32.f32(a) for every
// finite a (round to nearest, ties away from zero, to 10 mantissa bits) in
// two integer ops, where the cvt issues at a quarter of their rate; lo =
// a - hi, exact in f32, goes to the tensor cores unrounded. They read the
// top 19 bits of a tf32 operand, so lo is truncated there: its error is
// below 2^-10 |lo| <= 2^-21 |a|. A NaN whose mantissa carries into the sign
// bit (CUDA's canonical 0x7FFFFFFF) gives hi = -0, but lo = a - hi is NaN
// and carries it into the sum. Rounding lo by the same two ops would lose
// that NaN, and guarding both against it costs 20-25% of the kernel
// (tools/mdct_tc_ablation.py, variants rounded_lo and guarded).
__device__ __forceinline__ void tf32_split(float a, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(a) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(__fsub_rn(a, __uint_as_float(hi)));
}

// Shared-memory matrix descriptor of a K-major [rows][32] f32 tile with the
// 128-byte swizzle: start address >> 4, leading offset 1 (unused when the
// K extent fits one swizzle row), stride offset 1024 B (8 rows of 128 B)
// >> 4, layout type 1 (128B swizzle) in bits 62-63.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// d[64x128] (+)= a[64x8] (tf32, registers) * b[8x128] (tf32, shared
// memory, K-major). Accumulator layout: thread (warp w, lane l) holds rows
// 16w + l/4 (+8) and columns 8j + 2(l%4) (+1), d[4j..4j+3].
__device__ __forceinline__ void wgmma_tf32(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// A rows of the forward: row m = (b, t) is frame t of sample b, contiguous
// in K from x_pad[b, t*hop].
struct FwdRows {
  const float* x;
  int L, T, hop;
  struct Row {
    const float* p;
  };
  struct Col {
    int k;
  };
  __device__ Row row(int m) const {
    const int b = m / T, t = m - b * T;
    return {x + static_cast<size_t>(b) * L + static_cast<size_t>(t) * hop};
  }
  __device__ Col col(int k) const { return {k}; }
  __device__ const float* src(const Row& r, const Col& c, bool& ok) const {
    return r.p + c.k;
  }
};

// A rows of the inverse: row r = (b, j) holds, at K index i*n_fft + f,
// spec[b, j - i, f], zero where frame j - i lies outside [0, T).
struct InvRows {
  const float* x;  // spec [B, T, n_fft]
  int T, J, n_fft;
  struct Row {
    const float* p;  // spec + (b*T + j)*n_fft, dereferenced only in range
    int j;
  };
  struct Col {
    int k, i;
  };
  __device__ Row row(int r) const {
    const int b = r / J, j = r - b * J;
    return {x + (static_cast<ptrdiff_t>(b) * T + j) * n_fft, j};
  }
  __device__ Col col(int k) const { return {k, k / n_fft}; }
  __device__ const float* src(const Row& r, const Col& c, bool& ok) const {
    const int t = r.j - c.i;
    ok = ok && t >= 0 && t < T;
    // (b*T + j - i)*n_fft + (k - i*n_fft)
    return r.p + c.k - 2 * static_cast<ptrdiff_t>(c.i) * n_fft;
  }
};

// out[M, N] = A[M, K] @ Bt[N, K]^T in 3xTF32, with Bt given as its tf32 hi
// and lo planes [N, K]. One 128x128 output tile a block; blockIdx.x =
// m_tile * n_tiles + n_tile, so the blocks sharing an A tile run together.
template <class Rows>
__global__ void __launch_bounds__(NTHREADS, 1)
    gemm_3xtf32_kernel(Rows rows, const float* __restrict__ b_hi,
                       const float* __restrict__ b_lo, float* __restrict__ out,
                       int M, int N, int K, int n_tiles) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sbase = (raw + 1023) & ~1023u;  // the swizzle needs 1024 B
  const unsigned char* sgen = smem_raw + (sbase - raw);

  const int tid = threadIdx.x;
  const int m0 = (blockIdx.x / n_tiles) * BM;
  const int n0 = (blockIdx.x % n_tiles) * BN;
  const int KT = (K + BK - 1) / BK;

  // Copies: thread tid moves 16-byte chunk c of rows rc + 32j (j < 4) of
  // each of the stage's three tiles.
  const int c = tid & 7, rc = tid >> 3;
  typename Rows::Row arow[4];
  bool a_ok[4], b_ok[4];
  int b_off[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int m = m0 + rc + 32 * j, n = n0 + rc + 32 * j;
    a_ok[j] = m < M;
    arow[j] = rows.row(a_ok[j] ? m : 0);
    b_ok[j] = n < N;
    b_off[j] = (b_ok[j] ? n : 0) * K;
  }
  auto load_stage = [&](int kt) {
    const uint32_t s = sbase + (kt % STAGES) * STAGE;
    const int k = kt * BK + 4 * c;
    const bool k_ok = k < K;
    const typename Rows::Col col = rows.col(k);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t o = swz(rc + 32 * j, 4 * c);
      bool ok = a_ok[j] && k_ok;
      const float* src = rows.src(arow[j], col, ok);
      cp_async16(s + o, ok ? src : rows.x, ok);
      const bool okb = b_ok[j] && k_ok;
      const int boff = okb ? b_off[j] + k : 0;
      cp_async16(s + TILE + o, b_hi + boff, okb);
      cp_async16(s + 2 * TILE + o, b_lo + boff, okb);
    }
  };

  // Consumers: warpgroup wg computes tile rows [64 wg, 64 wg + 64); this
  // thread's A fragment rows are ra and ra + 8, columns t and t + 4 of each
  // k-step (the m64nNk8 tf32 register layout).
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ra = 64 * wg + 16 * warp + g;
  // Read stage kt's A fragments from shared memory and split them.
  auto split_frags = [&](int kt, uint32_t(&hi)[4][4], uint32_t(&lo)[4][4]) {
    const unsigned char* sa = sgen + (kt % STAGES) * STAGE;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const int k = 8 * ks + t;
      const float a[4] = {
          *reinterpret_cast<const float*>(sa + swz(ra, k)),
          *reinterpret_cast<const float*>(sa + swz(ra + 8, k)),
          *reinterpret_cast<const float*>(sa + swz(ra, k + 4)),
          *reinterpret_cast<const float*>(sa + swz(ra + 8, k + 4))};
#pragma unroll
      for (int q = 0; q < 4; ++q) tf32_split(a[q], hi[ks][q], lo[ks][q]);
    }
  };
  // part: stage kt's sum on the tensor cores, which round toward zero as
  // they accumulate, so one sum over all of K drifts (tools/
  // mdct_tc_ablation.py, variant one_sum); acc: the sum of the stages, in
  // f32 FADDs.
  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;

  // One step: issue stage kt's 12 wgmmas on (hi, lo); in their shadow,
  // refill the slot of stage kt-2 with stage kt+2, wait until stage kt+1 has
  // landed and every warpgroup is past stage kt-1, and split stage kt+1 into
  // (hi_n, lo_n); then wait for stage kt and add part into acc. Copy groups
  // committed by then: stages 0 .. kt+2, so wait_group 1 leaves kt+1 landed.
  auto step = [&](int kt, uint32_t(&hi)[4][4], uint32_t(&lo)[4][4],
                  uint32_t(&hi_n)[4][4], uint32_t(&lo_n)[4][4]) {
    const uint32_t s = sbase + (kt % STAGES) * STAGE;
    const uint64_t d_hi = smem_desc(s + TILE), d_lo = smem_desc(s + 2 * TILE);
#pragma unroll
    for (int i = 0; i < 64; ++i) pin(part[i]);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {  // +32 B of K a k-step: +2 in the desc
      wgmma_tf32(part, lo[ks], d_hi + 2 * ks, ks > 0);
      wgmma_tf32(part, hi[ks], d_lo + 2 * ks, 1);
      wgmma_tf32(part, hi[ks], d_hi + 2 * ks, 1);
    }
    wgmma_commit();
    if (kt + 2 < KT) load_stage(kt + 2);
    cp_async_commit();
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();
    if (kt + 1 < KT) split_frags(kt + 1, hi_n, lo_n);
    wgmma_wait<0>();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        pin(hi[ks][q]);
        pin(lo[ks][q]);
      }
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      pin(part[i]);
      acc[i] = __fadd_rn(acc[i], part[i]);
    }
  };

  for (int s = 0; s < 2; ++s) {
    if (s < KT) load_stage(s);
    cp_async_commit();
  }
  cp_async_wait<1>();
  fence_proxy_async();
  __syncthreads();
  uint32_t hi0[4][4], lo0[4][4], hi1[4][4], lo1[4][4];
  split_frags(0, hi0, lo0);
  for (int kt = 0; kt < KT; kt += 2) {
    step(kt, hi0, lo0, hi1, lo1);
    if (kt + 1 < KT) step(kt + 1, hi1, lo1, hi0, lo0);
  }

  const int r0 = m0 + ra, r1 = r0 + 8;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int n = n0 + 8 * j + 2 * t;
    if (n >= N) continue;  // N is even: a pair is in or out together
    if (r0 < M)
      *reinterpret_cast<float2*>(out + static_cast<size_t>(r0) * N + n) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
    if (r1 < M)
      *reinterpret_cast<float2*>(out + static_cast<size_t>(r1) * N + n) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

template <class Rows>
int launch(const Rows& rows, const void* b_hi, const void* b_lo, void* out,
           int M, int N, int K, cudaStream_t stream) {
  const cudaError_t attr = cudaFuncSetAttribute(
      gemm_3xtf32_kernel<Rows>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM);
  if (attr != cudaSuccess) return attr;
  const int n_tiles = p2p::ceil_div(N, BN);
  const int blocks = p2p::ceil_div(M, BM) * n_tiles;
  gemm_3xtf32_kernel<Rows><<<blocks, NTHREADS, SMEM, stream>>>(
      rows, static_cast<const float*>(b_hi), static_cast<const float*>(b_lo),
      static_cast<float*>(out), M, N, K, n_tiles);
  return cudaGetLastError();
}

}  // namespace tc

// --------------------------------------------------------------------------
// FFMA route (any hop): one register-tiled f32 GEMM with gathered operands.
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

// Tensor-core route. x: [B, L] padded signal (16-byte aligned, L % 4 == 0);
// b_hi, b_lo: the forward basis [win, n_fft] transposed and split,
// [n_fft, win] each; out: [B, T, n_fft], T = (L - win) / hop + 1.
int p2p_mdct2_tc(const void* x, const void* b_hi, const void* b_lo, void* out,
                 int B, int L, int T, int win, int hop, int n_fft,
                 void* stream) {
  if (B <= 0 || T <= 0) return cudaGetLastError();
  const tc::FwdRows rows{static_cast<const float*>(x), L, T, hop};
  return tc::launch(rows, b_hi, b_lo, out, B * T, n_fft, win,
                    (cudaStream_t)stream);
}

// Tensor-core route. spec: [B, T, n_fft]; b_hi, b_lo: the inverse basis
// [n_fft, win] regrouped as Bt[c, i*n_fft + f] = basis[f, i*hop + c] and
// split, [hop, (win/hop)*n_fft] each; out: [B, (T-1)*hop + win].
int p2p_imdct2_tc(const void* spec, const void* b_hi, const void* b_lo,
                  void* out, int B, int T, int n_fft, int win, int hop,
                  void* stream) {
  if (B <= 0 || T <= 0) return cudaGetLastError();
  const int m = win / hop, J = T + m - 1;
  const tc::InvRows rows{static_cast<const float*>(spec), T, J, n_fft};
  return tc::launch(rows, b_hi, b_lo, out, B * J, hop, m * n_fft,
                    (cudaStream_t)stream);
}

// FFMA route. x: [B, L] padded signal; basis: [win, n_fft]; out:
// [B, T, n_fft], T = (L - win) / hop + 1.
int p2p_mdct2_f32(const void* x, const void* basis, void* out, int B, int L,
                  int T, int win, int hop, int n_fft, void* stream) {
  if (B <= 0 || T <= 0) return cudaGetLastError();
  dim3 grid(p2p::ceil_div(n_fft, BN), p2p::ceil_div(T, BM), B);
  mdct2_kernel<<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)basis, (float*)out, L, T, win, hop,
      n_fft);
  return cudaGetLastError();
}

// FFMA route. spec: [B, T, n_fft]; basis: [n_fft, win]; out:
// [B, (T-1)*hop + win].
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
