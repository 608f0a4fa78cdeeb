// 3x3 stride-1 convolution over channels_last bf16 activations on the bf16
// tensor cores (mma.sync m16n8k16, f32 accumulation), for sm_90a.
//
// Replaces pix2pixhdaudiosr_tpu/ops/enhancer_pallas.py:conv3x3_in_wcb
// (p2p_conv3x3_in) and pix2pixhdaudiosr_tpu/ops/conv_pallas.py:
// conv3x3_pallas (p2p_conv3x3_valid), one kernel for both.
//
// p2p_conv3x3_in computes what _conv_kernel (enhancer_pallas.py:72-130) does:
//   in  = bf16( [relu]((f32(x) - mean[b,c]) * scale[b,c]) [+ f32(res)] )
//         (prologue none / in_relu / in_relu_add / in_add; none: in = x)
//   y   = bf16( conv3x3(reflect_pad1(in), w) + bias )   (bias added in f32)
// and the InstanceNorm statistics of y: per (b, c) the f32 mean of f32(y)
// and rsqrt(max(E[y^2] - mean^2, 0) + eps), from the rounded y as in JAX.
// p2p_conv3x3_valid is the same kernel on an input already padded by one
// (VALID), with no prologue, bias or statistics and an optional ReLU.
//
// What bounds it on this card: tensor-core FLOPs. At the flagship enhancer
// shape (batch 128, 256 x 64 positions, 96 -> 96 channels) one conv is
// 2 * 128 * 16384 * 96 * 864 = 348 GFLOP against ~0.8 GB moved (x, res and
// y in bf16): ~430 FLOP a byte, above the ~295 FLOP/byte bf16 ridge.
//
// Design: an implicit GEMM, M = output positions of one sample, N = output
// channels, K = 9 taps x C_in, with no padded or im2col tensor in memory.
//   * Persistent blocks, one per SM (~220 KB of shared memory): each loads
//     its N-tile of all nine taps' weights ([9][BN][C_in] bf16, 166 KB at
//     C = 96) ONCE, then walks output tiles of TH x TW positions (128 at
//     most; 2 rows x 64 at the flagship). Without residency every tile would
//     re-read the 166 KB of weights, ~2.7 TB of L2 traffic per conv.
//   * The loader stages the tile's TH + 2 input rows, TW + 2 columns each,
//     reflecting H and W by index arithmetic (reflect excludes the edge, as
//     torch ReflectionPad2d), and applies the prologue once per staged
//     element, halo included, before it rounds to bf16 in shared memory.
//   * Eight warps, 4 (M) x 2 (N), each a 32 x BN/2 tile of m16n8k16 MMAs fed
//     by ldmatrix. A tap is a shift of the staged rows, so each lane points
//     its ldmatrix row at the staged position its output reads. Rows of
//     both operands are XOR-swizzled in 16-byte chunks so that ldmatrix's
//     eight rows hit eight distinct bank groups.
//   * Epilogue: y = bf16(acc + bias) stored as bf16 pairs; per-column sums
//     of f32(y) and f32(y)^2 are reduced across the warp by shuffles and
//     across the four M-warps in shared memory, in a fixed order, into a
//     [B, P, C, 2] workspace (P = tiles per sample); in_finalize.cuh turns
//     it into mean and rstd. Deterministic, no atomics.
// Nothing here overlaps staging with the MMAs of the same block. The wgmma
// route (conv3x3_wgmma.cu) does; this kernel stays the route for the shapes
// that one does not take (ops/enhancer.plan_conv).
#include <stdint.h>

#include "conv_common.cuh"
#include "in_finalize.cuh"

namespace {

using p2p::prologue8;
using p2p::reflect_index;

constexpr int kThreads = 256;          // 8 warps
constexpr int kTileM = 128;            // output positions per tile
constexpr int kMaxSmem = 232448;       // a block's shared-memory limit
constexpr int kStageBatch = 8;         // global loads in flight per thread

struct ConvArgs {
  const __nv_bfloat16* x;    // [B, Hin, Win, Ci]
  const __nv_bfloat16* res;  // [B, Hin, Win, Ci] or null
  const __nv_bfloat16* w;    // [9, Co, Ci], tap = 3 * dh + dw
  const float* bias;         // [Co] or null
  const float* mean;         // [B, Ci] (prologue) or null
  const float* scale;        // [B, Ci] (prologue) or null
  __nv_bfloat16* y;          // [B, H, W, Co]
  float* partial;            // [B, P, Co, 2] or null (no statistics)
  int B, H, W, Hin, Win, Ci, Co;
  int S;                     // 16-byte chunks per staged row: ci_pad / 8
  int th, tw, tiles_w, P;    // output tile, tiles per sample
  int prologue;              // 0 none, 1 in_relu, 2 in_relu_add, 3 in_add
  int reflect;               // 1: Hin = H, Win = W, reflect; 0: VALID
  int relu;                  // ReLU before the bf16 round (VALID entry)
  int swz_shift, swz_mask;   // chunk swizzle of a staged row
};

__host__ __device__ inline int round_up(int a, int b) {
  return (a + b - 1) / b * b;
}

__host__ inline size_t smem_bytes(int bn, int ci_pad, int th, int tw) {
  return (size_t)9 * bn * ci_pad * 2                   // weights
         + (size_t)(th + 2) * (tw + 2) * ci_pad * 2    // staged input
         + (size_t)2 * 4 * bn * sizeof(float)          // column sums
         + (size_t)2 * ci_pad * sizeof(float);         // prologue mean, scale
}

// Byte offset of 16-byte chunk `chunk` of staged row `row`. The XOR keeps
// any eight consecutive rows at one chunk in eight distinct bank groups for
// every even S (S % 8 == 0: row & 7; S % 8 == 4: (row >> 1) & 3;
// S % 4 == 2: (row >> 2) & 1), and stays inside the row.
__device__ __forceinline__ uint32_t chunk_offset(const ConvArgs& a, int row,
                                                 int chunk) {
  const int phys = chunk ^ ((row >> a.swz_shift) & a.swz_mask);
  return (uint32_t)(row * a.S + phys) * 16u;
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Element offset of staged position (sr, sc) of the tile at (b, h0, w0).
__device__ __forceinline__ size_t source_offset(const ConvArgs& a, int b,
                                                int h0, int w0, int sr,
                                                int sc) {
  int h, w;
  if (a.reflect) {
    h = reflect_index(h0 - 1 + sr, a.Hin);
    w = reflect_index(w0 - 1 + sc, a.Win);
  } else {
    h = min(h0 + sr, a.Hin - 1);
    w = min(w0 + sc, a.Win - 1);
  }
  return (((size_t)b * a.Hin + h) * a.Win + w) * a.Ci;
}

// Stage the (th + 2) x (tw + 2) input positions of the tile at (b, h0, w0),
// ci_pad channels each (zero beyond Ci), prologue applied with this
// sample's mean and scale from shared memory (ms: [2][ci_pad]). Each thread
// issues kStageBatch 16-byte loads before it uses any, so the loads'
// latency overlaps instead of adding up.
__device__ __forceinline__ void stage_tile(const ConvArgs& a, char* act,
                                           const float* ms, int b, int h0,
                                           int w0) {
  const int cols = a.tw + 2;
  const int n_chunks = (a.th + 2) * cols * a.S;
  const int ci_pad = a.S * 8;
  for (int base = threadIdx.x; base < n_chunks;
       base += kThreads * kStageBatch) {
    uint4 xv[kStageBatch], rv[kStageBatch];
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int idx = base + u * kThreads;
      xv[u] = rv[u] = make_uint4(0, 0, 0, 0);
      const int q = idx / a.S, c0 = (idx % a.S) * 8;
      if (idx < n_chunks && c0 < a.Ci) {
        const size_t off =
            source_offset(a, b, h0, w0, q / cols, q % cols) + c0;
        xv[u] = __ldg(reinterpret_cast<const uint4*>(a.x + off));
        if (a.prologue >= 2)
          rv[u] = __ldg(reinterpret_cast<const uint4*>(a.res + off));
      }
    }
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int idx = base + u * kThreads;
      const int q = idx / a.S, chunk = idx % a.S;
      if (idx >= n_chunks) continue;
      uint4 v = xv[u];
      if (a.prologue && chunk * 8 < a.Ci)
        v = prologue8(a.prologue, v, rv[u], ms + chunk * 8, ms + ci_pad + chunk * 8);
      *reinterpret_cast<uint4*>(act + chunk_offset(a, q, chunk)) = v;
    }
  }
}

// NF: n8 MMA tiles per warp; the block's N tile is BN = 16 * NF channels.
template <int NF>
__global__ void __launch_bounds__(kThreads, 1)
    conv3x3_kernel(const ConvArgs a) {
  constexpr int BN = 16 * NF;
  extern __shared__ __align__(128) char smem[];
  char* wsm = smem;                                       // [9*BN rows][S]
  char* act = smem + (size_t)9 * BN * a.S * 16;           // [(th+2)(tw+2)][S]
  float* red = reinterpret_cast<float*>(
      act + (size_t)(a.th + 2) * (a.tw + 2) * a.S * 16);  // [2][4][BN]
  float* ms = red + 8 * BN;                               // [2][ci_pad]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warp_m = warp & 3, warp_n = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int n_block = blockIdx.y * BN;

  // weights of this N tile, all nine taps, resident for the whole kernel
  for (int idx = threadIdx.x; idx < 9 * BN * a.S; idx += kThreads) {
    const int row = idx / a.S, chunk = idx % a.S;
    const int tap = row / BN, co = n_block + row % BN, c0 = chunk * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (co < a.Co && c0 < a.Ci)
      v = *reinterpret_cast<const uint4*>(
          a.w + ((size_t)tap * a.Co + co) * a.Ci + c0);
    *reinterpret_cast<uint4*>(wsm + chunk_offset(a, row, chunk)) = v;
  }
  float bias_r[NF][2];
#pragma unroll
  for (int j = 0; j < NF; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int co = n_block + warp_n * (BN / 2) + 8 * j + 2 * t + e;
      bias_r[j][e] = (a.bias != nullptr && co < a.Co) ? a.bias[co] : 0.f;
    }

  const uint32_t wsm_s = (uint32_t)__cvta_generic_to_shared(wsm);
  const uint32_t act_s = (uint32_t)__cvta_generic_to_shared(act);
  const int cols = a.tw + 2;
  const int tile_pos = a.th * a.tw;
  // staged position each lane's ldmatrix row reads at tap (0, 0), for its
  // two m16 tiles; outputs past the tile read position 0 and are dropped
  int base_q[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    int m = warp_m * 32 + 16 * i + (lane & 15);
    if (m >= tile_pos) m = 0;
    base_q[i] = (m / a.tw) * cols + m % a.tw;
  }
  const int a_koff = lane >> 4;                       // A: k chunk 0 or 1
  const int b_n = (lane & 7) + ((lane >> 4) << 3);    // B: n within 16
  const int b_koff = (lane >> 3) & 1;                 // B: k chunk 0 or 1
  const int n_kc = a.S / 2;                           // k16 steps per tap

  const int n_tiles = a.B * a.P;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int b = tile / a.P, p = tile % a.P;
    const int h0 = (p / a.tiles_w) * a.th, w0 = (p % a.tiles_w) * a.tw;
    __syncthreads();  // the previous tile's reads of act and red are done
    if (a.prologue) {
      for (int c = threadIdx.x; c < a.S * 8; c += kThreads) {
        const bool in = c < a.Ci;
        ms[c] = in ? a.mean[(size_t)b * a.Ci + c] : 0.f;
        ms[a.S * 8 + c] = in ? a.scale[(size_t)b * a.Ci + c] : 0.f;
      }
      __syncthreads();
    }
    stage_tile(a, act, ms, b, h0, w0);
    __syncthreads();

    float acc[2][NF][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NF; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int shift = (tap / 3) * cols + tap % 3;
      const int q0 = base_q[0] + shift, q1 = base_q[1] + shift;
      const int wrow0 = tap * BN + warp_n * (BN / 2) + b_n;
#pragma unroll 2
      for (int kc = 0; kc < n_kc; ++kc) {
        uint32_t af[2][4], bf[NF][2];
        ldmatrix_x4(act_s + chunk_offset(a, q0, 2 * kc + a_koff), af[0]);
        ldmatrix_x4(act_s + chunk_offset(a, q1, 2 * kc + a_koff), af[1]);
#pragma unroll
        for (int jj = 0; jj < NF / 2; ++jj) {
          uint32_t r[4];
          ldmatrix_x4(wsm_s + chunk_offset(a, wrow0 + 16 * jj, 2 * kc + b_koff),
                      r);
          bf[2 * jj][0] = r[0];
          bf[2 * jj][1] = r[1];
          bf[2 * jj + 1][0] = r[2];
          bf[2 * jj + 1][1] = r[3];
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < NF; ++j) mma_bf16(acc[i][j], af[i], bf[j]);
      }
    }

    // epilogue: bias, round, store; column sums of the rounded values
    float cs[NF][2], cq[NF][2];
#pragma unroll
    for (int j = 0; j < NF; ++j) cs[j][0] = cs[j][1] = cq[j][0] = cq[j][1] = 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int m = warp_m * 32 + 16 * i + g + 8 * hr;
        const int h = h0 + m / a.tw, w = w0 + m % a.tw;
        if (m >= tile_pos || h >= a.H || w >= a.W) continue;
        __nv_bfloat16* yrow = a.y + (((size_t)b * a.H + h) * a.W + w) * a.Co;
#pragma unroll
        for (int j = 0; j < NF; ++j) {
          const int co = n_block + warp_n * (BN / 2) + 8 * j + 2 * t;
          if (co >= a.Co) continue;
          float v0 = acc[i][j][2 * hr] + bias_r[j][0];
          float v1 = acc[i][j][2 * hr + 1] + bias_r[j][1];
          if (a.relu) {
            v0 = fmaxf(v0, 0.f);
            v1 = fmaxf(v1, 0.f);
          }
          const __nv_bfloat162 yb = __floats2bfloat162_rn(v0, v1);
          *reinterpret_cast<__nv_bfloat162*>(yrow + co) = yb;
          const float2 yf = __bfloat1622float2(yb);
          cs[j][0] += yf.x;
          cs[j][1] += yf.y;
          cq[j][0] = fmaf(yf.x, yf.x, cq[j][0]);
          cq[j][1] = fmaf(yf.y, yf.y, cq[j][1]);
        }
      }
    if (a.partial == nullptr) continue;
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float s = cs[j][e], q = cq[j][e];
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          s += __shfl_xor_sync(0xffffffffu, s, o);
          q += __shfl_xor_sync(0xffffffffu, q, o);
        }
        if (g == 0) {
          const int col = warp_n * (BN / 2) + 8 * j + 2 * t + e;
          red[warp_m * BN + col] = s;
          red[4 * BN + warp_m * BN + col] = q;
        }
      }
    __syncthreads();
    const int col = threadIdx.x;
    if (col < BN && n_block + col < a.Co) {
      float s = 0.f, q = 0.f;
#pragma unroll
      for (int wm = 0; wm < 4; ++wm) {
        s += red[wm * BN + col];
        q += red[4 * BN + wm * BN + col];
      }
      float* dst = a.partial + (((size_t)b * a.P + p) * a.Co + n_block + col) * 2;
      dst[0] = s;
      dst[1] = q;
    }
  }
}

template <int NF>
int launch_conv(const ConvArgs& a, int ci_pad, cudaStream_t stream) {
  const size_t smem = smem_bytes(16 * NF, ci_pad, a.th, a.tw);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  int err = cudaFuncSetAttribute(conv3x3_kernel<NF>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
  if (err) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev))) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)))
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, conv3x3_kernel<NF>, kThreads, smem)))
    return err;
  const int n_tiles_n = p2p::ceil_div(a.Co, 16 * NF);
  const long long tiles = (long long)a.B * a.P;
  long long gx = (long long)sms * (per_sm > 0 ? per_sm : 1) / n_tiles_n;
  gx = gx < 1 ? 1 : (gx > tiles ? tiles : gx);
  conv3x3_kernel<NF><<<dim3((unsigned)gx, n_tiles_n), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

int run(ConvArgs a, int bn, cudaStream_t stream) {
  if (a.B <= 0 || a.H <= 0 || a.W <= 0) return cudaGetLastError();
  if (a.Ci <= 0 || a.Co <= 0 || a.Ci % 8 || a.Co % 8 || a.th < 1 ||
      a.tw < 1 || a.th * a.tw > kTileM)
    return (int)cudaErrorInvalidValue;
  if (a.reflect && (a.H < 2 || a.W < 2)) return (int)cudaErrorInvalidValue;
  const int ci_pad = round_up(a.Ci, 16);
  a.S = ci_pad / 8;
  if (a.S % 8 == 0) {
    a.swz_shift = 0;
    a.swz_mask = 7;
  } else if (a.S % 4 == 0) {
    a.swz_shift = 1;
    a.swz_mask = 3;
  } else {
    a.swz_shift = 2;
    a.swz_mask = 1;
  }
  a.tiles_w = p2p::ceil_div(a.W, a.tw);
  if (a.P != p2p::ceil_div(a.H, a.th) * a.tiles_w)
    return (int)cudaErrorInvalidValue;
  switch (bn) {
    case 32: return launch_conv<2>(a, ci_pad, stream);
    case 64: return launch_conv<4>(a, ci_pad, stream);
    case 96: return launch_conv<6>(a, ci_pad, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// x, res: [B, H, W, Ci] bf16 (channels_last [B, Ci, H, W]; res may be null
// unless prologue is 2 or 3); w: [9, Co, Ci] bf16; bias: [Co] f32;
// mean, scale: [B, Ci] f32 (read when prologue != 0); y: [B, H, W, Co] bf16;
// partial: f32 [B, P, Co, 2] workspace with P = ceil(H / th) * ceil(W / tw);
// stats: f32 [2, B, Co], (mean, rstd) of y on return. prologue: 0 none,
// 1 in_relu, 2 in_relu_add, 3 in_add. th, tw, bn: the output tile and the
// channel tile (32, 64 or 96), chosen by the wrapper (ops/enhancer.py).
int p2p_conv3x3_in(const void* x, const void* res, const void* w,
                   const void* bias, const void* mean, const void* scale,
                   void* y, void* partial, void* stats, int B, int H, int W,
                   int Ci, int Co, int prologue, float eps, int th, int tw,
                   int bn, int P, void* stream) {
  if (prologue < 0 || prologue > 3 || (prologue >= 2 && res == nullptr) ||
      (prologue && (mean == nullptr || scale == nullptr)))
    return (int)cudaErrorInvalidValue;
  ConvArgs a = {};
  a.x = (const __nv_bfloat16*)x;
  a.res = (const __nv_bfloat16*)res;
  a.w = (const __nv_bfloat16*)w;
  a.bias = (const float*)bias;
  a.mean = (const float*)mean;
  a.scale = (const float*)scale;
  a.y = (__nv_bfloat16*)y;
  a.partial = (float*)partial;
  a.B = B;
  a.H = a.Hin = H;
  a.W = a.Win = W;
  a.Ci = Ci;
  a.Co = Co;
  a.th = th;
  a.tw = tw;
  a.P = P;
  a.prologue = prologue;
  a.reflect = 1;
  cudaStream_t s = (cudaStream_t)stream;
  int err = run(a, bn, s);
  if (err || B <= 0 || H <= 0 || W <= 0) return err;
  float* st = (float*)stats;
  return p2p::launch_finalize((const float*)partial, st, st + (size_t)B * Co,
                              1, B, Co, P, H * W, eps, s);
}

// x: [B, H + 2, W + 2, Ci] bf16, already padded; w: [9, Co, Ci] bf16;
// y: [B, H, W, Co] bf16 = VALID conv, then ReLU if relu != 0. th, tw, bn,
// P as above.
int p2p_conv3x3_valid(const void* x, const void* w, void* y, int B, int H,
                      int W, int Ci, int Co, int relu, int th, int tw, int bn,
                      int P, void* stream) {
  ConvArgs a = {};
  a.x = (const __nv_bfloat16*)x;
  a.w = (const __nv_bfloat16*)w;
  a.y = (__nv_bfloat16*)y;
  a.B = B;
  a.H = H;
  a.W = W;
  a.Hin = H + 2;
  a.Win = W + 2;
  a.Ci = Ci;
  a.Co = Co;
  a.th = th;
  a.tw = tw;
  a.P = P;
  a.relu = relu != 0;
  return run(a, bn, (cudaStream_t)stream);
}

}  // extern "C"
