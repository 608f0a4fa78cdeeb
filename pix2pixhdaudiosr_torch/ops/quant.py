"""Int8 quantization for serving: weight-only int8 (`--data_type 8`), the
int8 trunk (`--int8_trunk`), and the stochastic-rounding quantizer kernel
(csrc/quant.cu) with its plain twin.

Port of pix2pixhdaudiosr_tpu/ops/quant.py.

* Weights: per-output-channel symmetric int8, scale max(absmax, 1e-12)/127,
  computed in the weight's own dtype as the JAX package does (f32 for
  `--data_type 8`, which quantizes before the bf16 cast; the compute dtype
  for the int8 trunk, which quantizes the weights it is handed). JAX keeps
  the channel on the last axis of every flax kernel; here it is dim 0 of a
  Conv2d weight (OIHW) and dim 1 of a ConvTranspose2d weight
  ([ci, co, kh, kw], convert.py).
* Int8 trunk: dynamic per-tensor activation scale, the reflect-padded 3x3
  conv as one im2col product [B*H*W, 9C] @ [9C, Co] in int8 with int32
  accumulation (torch._int_mm: cuBLASLt on the card; the JAX package leaves
  these products to XLA's dot_general, outside any Pallas kernel), then
  acc * (sx * sw) + b in f32. Integer sums are exact, so the accumulator is
  the one JAX's nine shifted dots give.
* `stochastic_quantize_2d` replaces the Pallas kernel of the same name. Its
  random bits come from a counter-based hash of (seed, flat index) that the
  twin computes too, so the kernel and the twin agree bit for bit. The TPU
  kernel drew from the chip's own PRNG, which nothing else reproduces. On
  the card it takes one of two routes, chosen by the shape
  (`plan_quantize`): one launch and one read of x, a strip of columns
  staged in a thread-block cluster's shared memory, or three launches
  (absmax, scale, quantize) where no cluster holds a strip.
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from . import _cuda
from .norm import instance_norm_act

StateDict = Dict[str, torch.Tensor]
Scales = Dict[str, Optional[torch.Tensor]]  # None: the entry is not quantized


def _div127(a: torch.Tensor) -> torch.Tensor:
    """a / 127 rounded once, on every device: torch divides a CUDA tensor by
    a Python scalar as a * (1 / 127), which rounds twice, but by a tensor as
    IEEE division (the CPU, XLA and csrc/quant.cu's __fdiv_rn agree)."""
    return a / torch.full_like(a, 127.0)


# ---------------------------------------------------------------------------
# Weight quantization (pix2pixhdaudiosr_tpu/ops/quant.py:23-70)
# ---------------------------------------------------------------------------
def quantize_leaf(w: torch.Tensor, axis: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 per channel along `axis`: (q int8, scale f32), the
    scale with w's rank (size 1 off `axis`). abs, max, /127 and w/scale
    run in w's dtype."""
    dims = [d for d in range(w.dim()) if d != axis % w.dim()]
    amax = w.abs().amax(dim=dims, keepdim=True)
    scale = _div127(torch.clamp_min(amax, 1e-12))
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def dequantize_leaf(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.bfloat16) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def _channel_axis(key: str) -> int:
    """Output-channel dim of a state_dict weight: 1 for a deconv."""
    return 1 if key.endswith("ConvTranspose_0.weight") else 0


def quantize_state_dict(state: StateDict) -> Tuple[StateDict, Scales]:
    """Quantize every conv and deconv weight (ndim >= 2); biases pass
    through. Returns (state with int8 weights, scales with None for the
    entries left as they were)."""
    qstate, scales = {}, {}
    for key, t in state.items():
        if key.endswith(".weight") and t.dim() >= 2:
            qstate[key], scales[key] = quantize_leaf(t, _channel_axis(key))
        else:
            qstate[key], scales[key] = t, None
    return qstate, scales


def dequantize_state_dict(qstate: StateDict, scales: Scales,
                          dtype=torch.float32) -> StateDict:
    return {k: dequantize_leaf(q, scales[k], dtype)
            if scales[k] is not None else q for k, q in qstate.items()}


def quantized_size_bytes(qstate: StateDict) -> int:
    return sum(t.numel() * t.element_size() for t in qstate.values())


# ---------------------------------------------------------------------------
# The int8 trunk (pix2pixhdaudiosr_tpu/ops/quant.py:86-124)
# ---------------------------------------------------------------------------
def _quant_act_tensor(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8 of an activation, in f32: (q, 0-d scale)."""
    xf = x.float()
    s = _div127(torch.clamp_min(xf.abs().amax(), 1e-8))
    q = torch.clamp(torch.round(xf / s), -127, 127)
    return q.to(torch.int8), s


def quantize_conv_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """OIHW 3x3 weight [Co, Ci, 3, 3] -> (kq int8 [Co, 9 Ci], K-major with
    k = (dh * 3 + dw) * Ci + ci, and sw f32 [Co]): the operand the int8
    product takes, quantized per output channel as quantize_leaf does."""
    q, s = quantize_leaf(w, axis=0)
    co, ci = w.shape[:2]
    kq = q.permute(0, 2, 3, 1).reshape(co, 9 * ci).contiguous()
    return kq, s.reshape(co)


def _reflect_index(n: int, device) -> torch.Tensor:
    """Source rows of a reflect pad by one: [1, 0, 1, ..., n-1, n-2]."""
    i = torch.arange(-1, n + 1, device=device).abs()
    return torch.where(i > n - 1, 2 * (n - 1) - i, i)


def conv3x3_int8_acc(x: torch.Tensor, kq: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The int32 accumulator of the int8 3x3 conv: x [B, C, H, W] (any
    float dtype, any layout; H, W >= 2) is quantized per tensor, reflect
    padded by one and multiplied, as im2col [B*H*W, 9C], with kq
    [Co, 9C] (quantize_conv_weight). Returns (acc int32 [B*H*W, Co], sx).

    torch._int_mm needs K = 9C and N = Co to be multiples of 8 (so C and
    Co are) and M > 16 on the card; M is padded with zero rows up to 17,
    which adds nothing to the sums. Counted in `conv3x3_int8.launches`."""
    B, C, H, W = x.shape
    co = kq.shape[0]
    if C % 8 or co % 8 or kq.shape[1] != 9 * C:
        raise ValueError(f"conv3x3_int8: needs C and Co multiples of 8 and "
                         f"kq [Co, 9 C]; got x {tuple(x.shape)}, kq "
                         f"{tuple(kq.shape)}")
    xq, sx = _quant_act_tensor(x.permute(0, 2, 3, 1))          # NHWC int8
    xp = xq[:, _reflect_index(H, x.device)][:, :, _reflect_index(W, x.device)]
    m = B * H * W
    cols = torch.cat([xp[:, dh:dh + H, dw:dw + W] for dh in range(3)
                      for dw in range(3)], dim=-1).reshape(m, 9 * C)
    if m <= 16:
        cols = torch.cat([cols, cols.new_zeros(17 - m, 9 * C)])
    acc = torch._int_mm(cols, kq.t())[:m]
    conv3x3_int8.launches += 1
    return acc, sx


def conv3x3_int8(x: torch.Tensor, kq: torch.Tensor, sw: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Reflect-padded SAME 3x3 conv in int8: acc * (sx * sw) + b in f32,
    cast to x's dtype. x [B, C, H, W] -> [B, Co, H, W] channels_last."""
    B, _, H, W = x.shape
    acc, sx = conv3x3_int8_acc(x, kq)
    y = acc.float() * (sx * sw)[None] + b.float()[None]
    return y.to(x.dtype).reshape(B, H, W, -1).permute(0, 3, 1, 2)


conv3x3_int8.launches = 0

QuantConv = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # kq, sw, bias


def int8_resblock_stack(x: torch.Tensor,
                        blocks: Sequence[Tuple[QuantConv, QuantConv]],
                        eps: float = 1e-5) -> torch.Tensor:
    """Sequential ResnetBlocks with int8 convs. blocks:
    [((kq1, sw1, b1), (kq2, sw2, b2)), ...], each conv's weight through
    quantize_conv_weight. InstanceNorm and ReLU run on instance_norm_act
    (B3 on the card); the residual add in x's dtype."""
    cur = x
    for c1, c2 in blocks:
        h = instance_norm_act(conv3x3_int8(cur, *c1), "relu", eps)
        h = instance_norm_act(conv3x3_int8(h, *c2), "none", eps)
        cur = cur + h
    return cur


# ---------------------------------------------------------------------------
# Stochastic-rounding quantizer (pix2pixhdaudiosr_tpu/ops/quant.py:130-164)
# ---------------------------------------------------------------------------
_MASK32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32), with no int64 overflow:
    c is split into 16-bit halves."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _hash32(x: torch.Tensor) -> torch.Tensor:
    """lowbias32 (C. Wellons' integer hash) on uint32 values held in int64;
    csrc/quant.cu hash32 is the same function."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def random_bits(seed: int, index: torch.Tensor) -> torch.Tensor:
    """The 32 random bits of the flat elements `index` (int64) under
    `seed`, as int64: k = hash(seed ^ 0x9E3779B9) and
    bits = hash(hash(lo ^ k) ^ hi ^ k), (hi, lo) the index's 32-bit halves."""
    k = _hash32(torch.tensor((seed & _MASK32) ^ _GOLDEN, dtype=torch.int64,
                             device=index.device))
    return _hash32(_hash32((index & _MASK32) ^ k) ^ (index >> 32) ^ k)


def stochastic_quantize_2d_ref(x: torch.Tensor, seed: int
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Twin of `stochastic_quantize_2d`, on any device."""
    xf = x.float()
    amax = xf.abs().amax(dim=0, keepdim=True)
    scale = _div127(torch.clamp_min(amax, 1e-12))
    index = torch.arange(xf.numel(), dtype=torch.int64, device=xf.device)
    bits = random_bits(seed, index).view(xf.shape)
    u = (bits >> 8).float() * (1.0 / (1 << 24))
    q = torch.clamp(torch.floor(xf / scale + u), -127, 127)
    return q.to(torch.int8), scale


# The strip route (csrc/quant.cu quantize_strip_kernel): `STRIP_COLS`
# columns a strip (128 bytes of each row), a cluster of at most
# `STRIP_MAX_CLUSTER` blocks, each `STRIP_BLOCK_BYTES` of it or more. At
# [13824, 1536] on an H100, 32 columns in clusters of 16 took 0.078 ms,
# 16 columns 0.086, 8 columns 0.109-0.113, three launches 0.092
# (tools/quant_strip_ablation.py, PERF.md).
STRIP_COLS = 32
STRIP_BLOCK_BYTES = 32768
STRIP_MAX_CLUSTER = 16
_STRIP_SMEM = 232448 - 8192   # the block's dynamic shared memory at most


class QuantPlan(NamedTuple):
    """How `stochastic_quantize_2d` runs [M, N]. route "strip": a cluster
    of `cluster` blocks owns `cols` columns, each block `rows` rows; route
    "threepass": the other fields are 0."""
    route: str
    cols: int = 0
    cluster: int = 0
    rows: int = 0


@functools.lru_cache(maxsize=64)
def plan_quantize(M: int, N: int, aligned: bool = True,
                  cols: int = STRIP_COLS,
                  block_bytes: int = STRIP_BLOCK_BYTES,
                  max_cluster: int = STRIP_MAX_CLUSTER) -> QuantPlan:
    """The route for f32 x [M, N] (`aligned`: its start on 16 bytes): the
    strip route at `cols` columns, or fewer (a power of two of at least 4
    that divides N), whose strip, M rows of them, a cluster of at most
    `max_cluster` blocks holds, K the fewest blocks of `block_bytes` that
    do; the three-launch route where none does, or where the rows' pitch
    (N * 4 bytes) or x's start is no multiple of 16 bytes."""
    if M < 1 or N < 1 or N % 4 or not aligned:
        return QuantPlan("threepass")
    for w in (w for w in (32, 16, 8, 4) if w <= cols and N % w == 0):
        k = min(max_cluster, max(1, -(-M * w * 4 // block_bytes)))
        rows = -(-M // k)
        if rows * w * 4 <= _STRIP_SMEM:
            return QuantPlan("strip", w, -(-M // rows), rows)
    return QuantPlan("threepass")


def stochastic_quantize_2d(x: torch.Tensor, seed: int,
                           plan: QuantPlan = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[M, N] f32 -> (int8 [M, N], per-column scale f32 [1, N]):
    scale = max(absmax over rows, 1e-12) / 127 and
    q = clip(floor(x / scale + u), -127, 127), u = (bits >> 8) * 2^-24 with
    the bits of `random_bits(seed, m * N + n)`. On CUDA x is contiguous
    float32; `plan` forces a route (`plan_quantize`'s by default). Counted
    in `stochastic_quantize_2d.launches` and `.launches_by_route`."""
    if x.device.type == "cpu":
        return stochastic_quantize_2d_ref(x, seed)
    _cuda.check_cuda("stochastic_quantize_2d", x)
    if x.dim() != 2 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"stochastic_quantize_2d: x must be a contiguous "
                         f"float32 [M, N], got {x.dtype} {tuple(x.shape)} "
                         f"contiguous={x.is_contiguous()}")
    M, N = x.shape
    plan = plan or plan_quantize(M, N, x.data_ptr() % 16 == 0)
    q = torch.empty(M, N, dtype=torch.int8, device=x.device)
    scale = torch.empty(1, N, dtype=torch.float32, device=x.device)
    if plan.route == "strip":
        _cuda.launch("p2p_stochastic_quantize_strip", x.device, x.data_ptr(),
                     q.data_ptr(), scale.data_ptr(), M, N, seed & _MASK32,
                     plan.cols, plan.cluster, plan.rows)
    else:
        amax = torch.zeros(N, dtype=torch.int32, device=x.device)  # f32 bits
        _cuda.launch("p2p_stochastic_quantize_2d", x.device, x.data_ptr(),
                     q.data_ptr(), scale.data_ptr(), amax.data_ptr(), M, N,
                     seed & _MASK32)
    fn = stochastic_quantize_2d
    fn.launches += 1
    fn.launches_by_route[plan.route] = fn.launches_by_route.get(plan.route,
                                                                0) + 1
    return q, scale


stochastic_quantize_2d.launches = 0
stochastic_quantize_2d.launches_by_route = {}
