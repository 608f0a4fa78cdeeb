// 3x3 stride-1 convolution over channels_last bf16 activations on Hopper's
// warpgroup MMA (wgmma, bf16 operands, f32 accumulation), for sm_90a: the
// wgmma route of B4 (p2p_conv3x3_in_wg) and B5 (p2p_conv3x3_valid_wg).
//
// Replaces pix2pixhdaudiosr_tpu/ops/enhancer_pallas.py:conv3x3_in_wcb and
// pix2pixhdaudiosr_tpu/ops/conv_pallas.py:conv3x3_pallas, as the mma.sync
// route (conv3x3_in.cu) does, and computes the same functions, with the
// same prologue and the same rounding (that file's header says what they
// are); only the order of the f32 sums differs. ops/enhancer.plan_conv
// picks the route: this one takes the flagship enhancer's rows, Ci = 96
// and W = 64 (one m64 tile a row), with Co % 96 == 0; the mma.sync kernel
// takes the rest.
//
// What bounds it on this card: tensor-core FLOPs. At the flagship enhancer
// shape (batch 128, 256 x 64 positions, 96 -> 96 channels) one conv is
// 348 GFLOP, 0.352 ms at 989 TFLOP/s, against ~0.8 GB moved (0.24 ms).
//
// Design: an implicit GEMM, M = the 64 positions of one output row (one
// m64 wgmma tile), N = 96 output channels, K = 9 taps x Ci; no padded or
// im2col tensor in memory.
//   * Persistent blocks, one an SM, each walking units of `strip` output
//     rows of one sample. Its N tile of all nine taps' weights (166 KB at
//     Ci = 96) is loaded once and stays resident.
//   * A ring of `slots` input rows in shared memory. Output row r reads
//     input rows r, r + 1, r + 2 (of the padded input), so each output row
//     needs one new staged row, not the two a 2-row tile of the mma.sync
//     route restages a row. A producer warpgroup stages the unit's rows in
//     order (reflecting H and W by index, the prologue applied once per
//     element, rounded once to bf16), each row's loads issued a row ahead
//     into registers; mbarriers hand each slot to the two consumer
//     warpgroups (full) and back (empty), so staging overlaps the MMAs.
//   * Both wgmma operands come from shared memory through descriptors,
//     K-major without swizzle: 8 positions (or 8 output channels) x 16
//     bytes of channels form one 128-byte core matrix. A staged row is
//     [chunk][position][16 B], so the tap shift dw is an address offset of
//     16 * dw bytes and dh picks the ring slot: no ldmatrix, no registers
//     for A. K = 96 channels is six k16 steps (kKSteps) of two core
//     matrices, with no swizzle atom to tile.
//   * The two consumer warpgroups take alternate output rows (5 slots:
//     rows r..r+3 in use, r+4 being staged). Each issues 9 x Ci/16 wgmmas
//     into one accumulator, waits, releases the rows it is done with, and
//     runs the epilogue.
//   * Epilogue: y = bf16(acc + bias) (ReLU first for the VALID entry),
//     stored 16 bytes a thread after a quad transpose; for B4 each thread
//     adds f32(y) and f32(y)^2 of its columns over its rows, a warp
//     butterfly adds its 8 row lanes, and each warp writes its sums to its
//     own row of the [B, P, Co, 2] workspace (P = strips x 8), which
//     in_finalize.cuh adds in order. Deterministic, no
//     atomics.
// Measured (tools/conv_wgmma_ablation.py, PERF.md): the wgmmas alone run
// near the bf16 peak; staging, wgmmas and epilogue each fit beside one
// other, but the three together do not, and B4's prologue makes its
// staging the slowest of the three.
#include <stdint.h>

#include "conv_common.cuh"
#include "in_finalize.cuh"

namespace {

using p2p::prologue8;
using p2p::reflect_index;

constexpr int kBN = 96;            // output channels a block (its N tile)
constexpr int kWG = 128;           // threads a warpgroup
constexpr int kThreads = 3 * kWG;  // a producer and two consumer warpgroups
constexpr int kCi = 96;            // input channels
constexpr int kW = 64;             // output positions a row: one wgmma's M
constexpr int kKSteps = kCi / 16;  // k16 steps a tap
constexpr int kMaxSmem = 232448;   // a block's shared-memory limit
constexpr int kMaxSlots = 8;
constexpr int kStageBatch = 7;     // 16-byte chunks of a row a producer thread

struct Args {
  const __nv_bfloat16* x;    // [B, Hin, Win, Ci]
  const __nv_bfloat16* res;  // [B, Hin, Win, Ci] or null
  const __nv_bfloat16* w;    // [9, Co, Ci], tap = 3 * dh + dw
  const float* bias;         // [Co] or null
  const float* mean;         // [B, Ci] (prologue) or null
  const float* scale;        // [B, Ci] (prologue) or null
  __nv_bfloat16* y;          // [B, H, W, Co]
  float* partial;            // [B, P, Co, 2] or null (no statistics)
  int B, H, W, Hin, Win, Ci, Co;
  int S;                     // 16-byte channel chunks a position: Ci / 8
  int Wp;                    // staged positions a row: W + 2
  int strip, strips;         // output rows a unit, units a sample
  int slots;                 // input rows the ring holds
  int P;                     // workspace rows a sample
  int prologue;              // 0 none, 1 in_relu, 2 in_relu_add, 3 in_add
  int reflect;               // 1: Hin = H, Win = W, reflect; 0: VALID
  int relu;                  // ReLU before the bf16 round (VALID entry)
};

// Byte offsets in a block's shared memory (ops/enhancer.wgmma_smem_bytes
// reckons the same total): the weights [9][S][kBN] x 16 B at 0, then the
// ring of slots [S][Wp] x 16 B, the bias [kBN] f32, the prologue's mean
// and scale [2][Ci] f32, and the full and empty mbarriers.
struct Layout {
  uint32_t ring, bias, ms, bars, total;
};

__host__ __device__ inline Layout layout(int S, int Wp, int slots) {
  Layout l;
  l.ring = 9u * kBN * S * 16;
  l.bias = l.ring + (uint32_t)slots * S * Wp * 16;
  l.ms = l.bias + kBN * 4;
  l.bars = l.ms + 2 * S * 8 * 4;
  l.total = l.bars + 2 * slots * 8;
  return l;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void named_bar(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Makes this thread's generic-proxy shared-memory writes visible to the
// async proxy that wgmma reads through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Arrive on `bar` if pred: the predicate stays inside the asm, so no
// branch on the lane splits the consumers' code around their wgmmas.
__device__ __forceinline__ void mbar_arrive(uint32_t bar, bool pred = true) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      ".reg .b64 state;\n"
      "setp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 state, [%0];\n"
      "}\n" ::"r"(bar),
      "r"((int)pred)
      : "memory");
}

// Spin until the phase of `bar` with this parity has completed; the loop
// is PTX's (cf. CUTLASS's ClusterBarrier::wait). More than kHangPolls
// failed polls trap: a fault in the ring's hand-off becomes a launch
// failure that the wrapper reports, not a hung card. A poll returns after
// at most a short hardware-chosen suspension, and a wait here lasts
// microseconds, so the limit is never near.
constexpr uint32_t kHangPolls = 1u << 26;
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      ".reg .u32 n;\n"
      "mov.u32 n, 0;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "add.u32 n, n, 1;\n"
      "setp.gt.u32 p, n, %2;\n"
      "@p trap;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity), "r"(kHangPolls)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Pin a register across the asynchronous wgmma region (cf. CUTLASS's
// warpgroup_fence_operand): the compiler may not move its uses across.
__device__ __forceinline__ void pin(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// Shared-memory matrix descriptor of a K-major operand without swizzle:
// start address >> 4 in bits 0-13; lbo, the bytes from one core matrix to
// the next along K, >> 4 in bits 16-29; sbo, the same along M or N, >> 4
// in bits 32-45; layout type 0 (no swizzle) in bits 62-63.
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr, uint32_t lbo,
                                                uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// d[64 x 96] (+)= A[64 x 16] * B[16 x 96], bf16 -> f32, both operands
// K-major in shared memory; scale_d == 0 overwrites d. Accumulator layout:
// thread (warp w, lane l) of the warpgroup holds rows 16w + l/4 (+8) and
// columns 8j + 2(l%4) (+1) in d[4j..4j+3].
__device__ __forceinline__ void wgmma_n96(float (&d)[48], uint64_t desc_a,
                                          uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47}, "
      "%48, %49, p, 1, 1, 0, 0;\n"
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
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// A producer thread's share of every staged row, the same for all rows:
// task k is 16-byte chunk idx = pt + k * kWG of the row, i.e. chunk c
// (8 channels) of
// staged position p. Eight consecutive threads take eight consecutive
// positions of one chunk: the shared stores are conflict-free, and the
// four chunks of a warp share the 32-byte sectors of the global row.
// Position p reads input column reflect(p - 1) (reflect) or p (VALID) and
// is stored at byte (c * Wp + p) * 16 of a slot, so that 8 consecutive
// positions of one chunk form one core matrix.
struct Tasks {
  int src[kStageBatch];  // element offset in an input row, -1: no task
  int dst[kStageBatch];  // byte offset in a ring slot
  int c8[kStageBatch];   // first channel of the chunk
};

__device__ __forceinline__ Tasks make_tasks(const Args& a, int pt) {
  Tasks t;
  const int n_tasks = a.S * ((a.Wp + 7) / 8) * 8;
#pragma unroll
  for (int k = 0; k < kStageBatch; ++k) {
    const int idx = pt + k * kWG, r = idx >> 3;
    const int c = r % a.S, p = (r / a.S) * 8 + (idx & 7);
    const int col = a.reflect ? reflect_index(p - 1, a.W) : p;
    const bool ok = idx < n_tasks && p < a.Wp;
    t.src[k] = ok ? col * a.Ci + c * 8 : -1;
    t.dst[k] = (c * a.Wp + p) * 16;
    t.c8[k] = c * 8;
  }
  return t;
}

static_assert(kCi / 8 * ((kW + 2 + 7) / 8) * 8 <= kWG * kStageBatch,
              "a staged row is more tasks than the producer holds");

// One input row as a producer thread holds it between its loads and its
// stores; r holds the residual's chunks where the prologue adds it.
template <bool kRes>
struct RowRegs {
  uint4 x[kStageBatch], r[kRes ? kStageBatch : 1];
};

// Load ring row i of unit u: input row reflect(h0 - 1 + i) or h0 + i, and
// the residual's for the prologues that add it.
template <bool kRes>
__device__ __forceinline__ void load_row(const Args& a, const Tasks& t,
                                         RowRegs<kRes>& v, int u, int i) {
  const int b = u / a.strips, h0 = (u % a.strips) * a.strip;
  const int hin = a.reflect ? reflect_index(h0 - 1 + i, a.H) : h0 + i;
  const size_t row = ((size_t)b * a.Hin + hin) * a.Win * a.Ci;
#pragma unroll
  for (int k = 0; k < kStageBatch; ++k) {
    v.x[k] = make_uint4(0, 0, 0, 0);
    if (kRes) v.r[k] = v.x[k];
    if (t.src[k] >= 0) {
      v.x[k] = __ldg(reinterpret_cast<const uint4*>(a.x + row + t.src[k]));
      if (kRes)
        v.r[k] = __ldg(reinterpret_cast<const uint4*>(a.res + row + t.src[k]));
    }
  }
}

// Store a loaded row into a ring slot, the prologue applied. ms: the
// sample's [2][Ci] mean and scale.
template <bool kRes>
__device__ __forceinline__ void store_row(const Args& a, const Tasks& t,
                                          const RowRegs<kRes>& v, char* slot,
                                          const float* ms) {
#pragma unroll
  for (int k = 0; k < kStageBatch; ++k) {
    if (t.src[k] < 0) continue;
    uint4 x = v.x[k];
    if (a.prologue) {  // the chunk's mean and scale as 16-byte reads
      const float4* m4 = reinterpret_cast<const float4*>(ms + t.c8[k]);
      const float4* s4 = reinterpret_cast<const float4*>(ms + a.Ci + t.c8[k]);
      const float4 m0 = m4[0], m1 = m4[1], s0 = s4[0], s1 = s4[1];
      const float m[8] = {m0.x, m0.y, m0.z, m0.w, m1.x, m1.y, m1.z, m1.w};
      const float sc[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
      x = prologue8(a.prologue, x, kRes ? v.r[k] : x, m, sc);
    }
    *reinterpret_cast<uint4*>(slot + t.dst[k]) = x;
  }
}

// The 9 taps x kKSteps k16 steps of one output row into acc, unrolled:
// with a loop ptxas serializes the wgmmas. rows: the shared
// addresses of the tile's first position in the ring rows it reads (dh =
// 0, 1, 2); tap (dh, dw) starts dw positions further on. wsm: the resident
// weights.
__device__ __forceinline__ void mainloop(float (&acc)[48],
                                         const uint32_t (&rows)[3],
                                         uint32_t wsm, const Args& a) {
  const uint32_t lbo_a = a.Wp * 16, lbo_b = kBN * 16;
  // Opaque to the compiler, so that it recomputes the 54 weight
  // descriptors here (a few integer adds) instead of holding them in
  // registers across the whole row loop.
  asm volatile("" : "+r"(wsm));
  wgmma_fence();
#pragma unroll
  for (int dh = 0; dh < 3; ++dh) {
#pragma unroll
    for (int dw = 0; dw < 3; ++dw) {
      const uint64_t da = desc_kmajor(rows[dh] + dw * 16, lbo_a, 128);
      const uint64_t db =
          desc_kmajor(wsm + (3 * dh + dw) * 2 * kKSteps * kBN * 16, lbo_b,
                      128);
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk)
        wgmma_n96(acc, da + ((2 * kk * lbo_a) >> 4),
                  db + ((2 * kk * lbo_b) >> 4), (dh | dw | kk) != 0);
    }
  }
  wgmma_commit();
}

// Transpose 4 x 4 words across the 4 lanes of a quad (t = lane % 4): lane
// t ends with w[i] = what lane i held in w[t], in two xor-shuffle steps.
__device__ __forceinline__ void quad_transpose(uint32_t (&w)[4], int t) {
  const bool hi = t & 2, odd = t & 1;
  uint32_t r0 = __shfl_xor_sync(0xffffffffu, hi ? w[0] : w[2], 2);
  uint32_t r1 = __shfl_xor_sync(0xffffffffu, hi ? w[1] : w[3], 2);
  if (hi) {
    w[0] = r0;
    w[1] = r1;
  } else {
    w[2] = r0;
    w[3] = r1;
  }
  r0 = __shfl_xor_sync(0xffffffffu, odd ? w[0] : w[1], 1);
  r1 = __shfl_xor_sync(0xffffffffu, odd ? w[2] : w[3], 1);
  if (odd) {
    w[0] = r0;
    w[2] = r1;
  } else {
    w[1] = r0;
    w[3] = r1;
  }
}

// bias, (ReLU,) round and store rows m and m + 8 of the tile; the column
// sums of the rounded values into cs, cq. Lane t of a quad holds columns
// 8j + 2t, +1 of each n8 block j; a quad transpose over 4 blocks gives it
// 8 consecutive columns, stored as one 16-byte write (the quad writes 64
// contiguous bytes of a row). yrow: row m's output at this warpgroup's
// first column; bias: the bias at column 2t.
template <bool kStats>
__device__ __forceinline__ void epilogue(const Args& a,
                                         const float (&acc)[48],
                                         const float* bias,
                                         __nv_bfloat16* yrow, int t,
                                         float (&cs)[24], float (&cq)[24]) {
#pragma unroll
  for (int q = 0; q < kBN / 32; ++q) {
    float2 bq[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      bq[i] = *reinterpret_cast<const float2*>(bias + 8 * (4 * q + i));
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = 4 * q + i;
        float v0 = acc[4 * j + 2 * hr] + bq[i].x;
        float v1 = acc[4 * j + 2 * hr + 1] + bq[i].y;
        if (a.relu) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        const __nv_bfloat162 yb = __floats2bfloat162_rn(v0, v1);
        w[i] = *reinterpret_cast<const uint32_t*>(&yb);
        if (kStats) {
          const float2 yf = __bfloat1622float2(yb);
          cs[2 * j] += yf.x;
          cs[2 * j + 1] += yf.y;
          cq[2 * j] = fmaf(yf.x, yf.x, cq[2 * j]);
          cq[2 * j + 1] = fmaf(yf.y, yf.y, cq[2 * j + 1]);
        }
      }
      quad_transpose(w, t);
      *reinterpret_cast<uint4*>(yrow + (size_t)8 * hr * a.Co + 32 * q +
                                8 * t) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// kStats: the InstanceNorm sums (B4). kRes: the prologue adds a residual
// (in_relu_add, in_add).
template <bool kStats, bool kRes>
__global__ void __launch_bounds__(kThreads, 1)
    conv3x3_wgmma_kernel(const Args a) {
  extern __shared__ __align__(128) char smem[];
  const Layout L = layout(a.S, a.Wp, a.slots);
  const uint32_t smem_s = smem_u32(smem);
  const uint32_t full0 = smem_s + L.bars, empty0 = full0 + 8 * a.slots;
  const uint32_t slot_bytes = a.S * a.Wp * 16;
  const int n_block = blockIdx.y * kBN;
  const int n_units = a.B * a.strips;

  if (threadIdx.x == 0) {
    for (int i = 0; i < a.slots; ++i) {
      mbar_init(full0 + 8 * i, kWG);  // every producer thread arrives
      mbar_init(empty0 + 8 * i, 8);   // every consumer warp arrives
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the warpgroup's role, as a value the compiler sees is warp-uniform:
  // otherwise the wgmmas under it count as on a divergent path, and
  // ptxas serializes them
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / kWG, 0);

  if (wg == 0) {
    // producer: the rows of this block's units in order (h0 - 1 .. h0 + n
    // of each), each row's loads issued a row before its stores (holding
    // two rows ahead spills registers and measured slower)
    float* ms = reinterpret_cast<float*>(smem + L.ms);
    const Tasks tasks = make_tasks(a, threadIdx.x);
    // ring row i of unit u, and the next
    struct Cursor {
      int u, i;
    };
    auto advance = [&](Cursor& c) {
      if (++c.i == min(a.strip, a.H - (c.u % a.strips) * a.strip) + 2) {
        c.u += gridDim.x;
        c.i = 0;
      }
    };
    Cursor st = {(int)blockIdx.x, 0}, ld = st;
    uint32_t it = 0;  // rows staged so far
    RowRegs<kRes> v0, v1;
    auto prefetch = [&](RowRegs<kRes>& v) {
      if (ld.u < n_units) load_row(a, tasks, v, ld.u, ld.i);
      advance(ld);
    };
    auto step = [&](const RowRegs<kRes>& cur, RowRegs<kRes>& nxt) {
      prefetch(nxt);
      if (st.i == 0 && a.prologue) {
        const int b = st.u / a.strips;
        named_bar(1, kWG);  // every row of the last unit is stored
        for (int c = threadIdx.x; c < a.Ci; c += kWG) {
          ms[c] = a.mean[(size_t)b * a.Ci + c];
          ms[a.Ci + c] = a.scale[(size_t)b * a.Ci + c];
        }
        named_bar(1, kWG);
      }
      const uint32_t slot = it % a.slots, use = it / a.slots;
      if (use > 0) mbar_wait(empty0 + 8 * slot, (use - 1) & 1);
      store_row(a, tasks, cur, smem + L.ring + slot * slot_bytes, ms);
      fence_proxy_async();
      mbar_arrive(full0 + 8 * slot);
      ++it;
      advance(st);
      return st.u < n_units;
    };
    if (st.u < n_units) {
      prefetch(v0);
      while (step(v0, v1) && step(v1, v0)) {
      }
    }
    return;
  }

  // consumers
  const int ct = threadIdx.x - kWG, cw = wg - 1;
  const int warp = __shfl_sync(0xffffffffu, (threadIdx.x >> 5) & 3, 0);
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // the N tile's weights, resident: 16-byte chunk c of weight row (tap, n)
  // at byte ((tap * S + c) * kBN + n) * 16, [tap][c] blocks of kBN / 8
  // core matrices
  for (int idx = ct; idx < 9 * a.S * kBN; idx += 2 * kWG) {
    const int n = idx % kBN, r = idx / kBN, c = r % a.S, tap = r / a.S;
    *reinterpret_cast<uint4*>(smem + (size_t)idx * 16) =
        __ldg(reinterpret_cast<const uint4*>(
            a.w + ((size_t)tap * a.Co + n_block + n) * a.Ci + c * 8));
  }
  float* bias_s = reinterpret_cast<float*>(smem + L.bias);
  for (int n = ct; n < kBN; n += 2 * kWG)
    bias_s[n] = a.bias != nullptr ? a.bias[n_block + n] : 0.f;
  fence_proxy_async();
  named_bar(2, 2 * kWG);

  float acc[48], cs[24], cq[24];
#pragma unroll
  for (int i = 0; i < 48; ++i) acc[i] = 0.f;
  // Rows alternate over all of the block's units: row r of the block is
  // warpgroup r % 2's.
  int rows_before = 0;  // output rows of the units before this one
  uint32_t it0 = 0;     // ring rows of the units before this one
  for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
    const int b = u / a.strips, s = u % a.strips, h0 = s * a.strip;
    const int n = min(a.strip, a.H - h0);
#pragma unroll
    for (int i = 0; i < 24; ++i) cs[i] = cq[i] = 0.f;
    // Every fill of the ring is waited for in order, also of rows this
    // warpgroup skips, so that a parity wait never sees a slot two phases
    // behind; every row is released once a warp.
    int waited = 0, released = 0;
    auto wait_through = [&](int r) {
      for (; waited <= r; ++waited) {
        const uint32_t q = it0 + waited;
        mbar_wait(full0 + 8 * (q % a.slots), (q / a.slots) & 1);
      }
    };
    auto release_below = [&](int r) {
      wait_through(r - 1);
      for (; released < r; ++released)
        mbar_arrive(empty0 + 8 * ((it0 + released) % a.slots), lane == 0);
    };
    for (int j = (cw + rows_before) & 1; j < n; j += 2) {
      wait_through(j + 2);
      uint32_t rows[3];
#pragma unroll
      for (int dh = 0; dh < 3; ++dh)
        rows[dh] = smem_s + L.ring + ((it0 + j + dh) % a.slots) * slot_bytes;
      mainloop(acc, rows, smem_s, a);
      wgmma_wait_all();
#pragma unroll
      for (int i = 0; i < 48; ++i) pin(acc[i]);
      release_below(min(j + 2, n + 2));
      const size_t pos = ((size_t)b * a.H + h0 + j) * kW + 16 * warp + g;
      epilogue<kStats>(a, acc, bias_s + 2 * t, a.y + pos * a.Co + n_block, t,
                       cs, cq);
    }
    release_below(n + 2);
    if (kStats) {
      const int p = s * 8 + 4 * cw + warp;
      float* dst =
          a.partial + (((size_t)b * a.P + p) * a.Co + n_block + 2 * t) * 2;
#pragma unroll
      for (int i = 0; i < 24; ++i) {
        float sv = cs[i], qv = cq[i];
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          sv += __shfl_xor_sync(0xffffffffu, sv, o);
          qv += __shfl_xor_sync(0xffffffffu, qv, o);
        }
        // column 8 (i / 2) + 2 t + i % 2 of the block's
        if (g == 0) {
          dst[(8 * (i / 2) + i % 2) * 2] = sv;
          dst[(8 * (i / 2) + i % 2) * 2 + 1] = qv;
        }
      }
    }
    it0 += n + 2;
    rows_before += n;
  }
}

template <bool kStats, bool kRes>
int launch(const Args& a, cudaStream_t stream) {
  const uint32_t smem = layout(a.S, a.Wp, a.slots).total;
  auto kernel = conv3x3_wgmma_kernel<kStats, kRes>;
  int err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev))) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)))
    return err;
  const long long units = (long long)a.B * a.strips;
  const int gx = (int)(units < sms ? units : sms);
  kernel<<<dim3(gx, a.Co / kBN), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

int run(Args a, cudaStream_t stream) {
  if (a.B <= 0 || a.H <= 0 || a.W <= 0) return cudaGetLastError();
  if (a.Ci != kCi || a.W != kW || a.Co <= 0 || a.Co % kBN || a.strip < 1 ||
      a.slots < 4 || a.slots > kMaxSlots)
    return (int)cudaErrorInvalidValue;
  if (a.reflect && a.H < 2) return (int)cudaErrorInvalidValue;
  a.S = a.Ci / 8;
  a.Wp = a.W + 2;
  a.strips = p2p::ceil_div(a.H, a.strip);
  if (layout(a.S, a.Wp, a.slots).total > (uint32_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  if (a.partial != nullptr && a.P != a.strips * 8)
    return (int)cudaErrorInvalidValue;
  if (a.partial == nullptr) return launch<false, false>(a, stream);
  return a.prologue >= 2 ? launch<true, true>(a, stream)
                         : launch<true, false>(a, stream);
}

}  // namespace

extern "C" {

// x, res: [B, H, W, Ci] bf16 (channels_last; res may be null unless
// prologue is 2 or 3); w: [9, Co, Ci] bf16; bias: [Co] f32; mean, scale:
// [B, Ci] f32 (read when prologue != 0); y: [B, H, W, Co] bf16; partial:
// f32 [B, P, Co, 2] workspace with P = ceil(H / strip) * 8; stats: f32
// [2, B, Co], (mean, rstd) of y on return. strip, slots: the plan
// (ops/enhancer.plan_conv).
int p2p_conv3x3_in_wg(const void* x, const void* res, const void* w,
                      const void* bias, const void* mean, const void* scale,
                      void* y, void* partial, void* stats, int B, int H,
                      int W, int Ci, int Co, int prologue, float eps,
                      int strip, int slots, int P, void* stream) {
  if (prologue < 0 || prologue > 3 || (prologue >= 2 && res == nullptr) ||
      (prologue && (mean == nullptr || scale == nullptr)) ||
      partial == nullptr)
    return (int)cudaErrorInvalidValue;
  Args a = {};
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
  a.strip = strip;
  a.slots = slots;
  a.P = P;
  a.prologue = prologue;
  a.reflect = 1;
  cudaStream_t s = (cudaStream_t)stream;
  int err = run(a, s);
  if (err || B <= 0 || H <= 0 || W <= 0) return err;
  float* st = (float*)stats;
  return p2p::launch_finalize((const float*)partial, st, st + (size_t)B * Co,
                              1, B, Co, P, H * W, eps, s);
}

// x: [B, H + 2, W + 2, Ci] bf16, already padded; w: [9, Co, Ci] bf16;
// y: [B, H, W, Co] bf16 = VALID conv, then ReLU if relu != 0.
int p2p_conv3x3_valid_wg(const void* x, const void* w, void* y, int B, int H,
                         int W, int Ci, int Co, int relu, int strip,
                         int slots, void* stream) {
  Args a = {};
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
  a.strip = strip;
  a.slots = slots;
  a.relu = relu != 0;
  return run(a, (cudaStream_t)stream);
}

}  // extern "C"
