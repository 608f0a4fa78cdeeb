"""The fused enhancer resblock section: the 3x3 conv + InstanceNorm kernel
(csrc/conv3x3_in.cu) and the glue around it, each beside its plain twin.

Port of pix2pixhdaudiosr_tpu/ops/enhancer_pallas.py (`--fused_enhancer`
serving). `conv3x3_in` replaces `conv3x3_in_wcb`: a reflect-padded 3x3 conv
over a channels_last [B, C, H, W] bf16 activation, + bias, -> bf16, with an
optional prologue that applies the previous InstanceNorm (and ReLU, and a
residual add) as the input is loaded, and the InstanceNorm statistics of
its output. `fused_resblock_chain` and `fused_enhancer_section` chain it so
that no normalized activation except the residual stream is materialized.
The TPU's batch-minor [H, W, C, B] layout and its `to_wcb`/`from_wcb`
bitcasts are not ported: channels_last is physically NHWC.

A CPU tensor runs the twin; a CUDA tensor launches a kernel (counted in
`conv3x3_in.launches`) or raises. The kernel has two routes, chosen by
`plan_conv`: the wgmma kernel (csrc/conv3x3_wgmma.cu, also counted in
`conv3x3_in.launches_wgmma`) at the shapes it takes, every flagship shape
among them, and the mma.sync kernel (csrc/conv3x3_in.cu) for the rest.
Numerics follow the JAX kernel: the
prologue in f32 rounded once to bf16, f32 accumulation, bias added in f32
before the bf16 round, statistics of the rounded output,
var = max(E[y^2] - mean^2, 0). Inference only (no backward), as in JAX.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _cuda
from .norm import instance_stats

PROLOGUES = {None: 0, "in_relu": 1, "in_relu_add": 2, "in_add": 3}

_TILE_M = 128            # csrc/conv3x3_in.cu kTileM: output positions a tile
_SMEM_LIMIT = 232_448    # csrc/conv3x3_in.cu kMaxSmem
_CHANNEL_TILES = (96, 64, 32)
# csrc/conv3x3_wgmma.cu: output channels a block, the input channels and
# width it takes (the flagship enhancer's rows); the ring slots of its plan,
# the most that fit beside the weights; the H100's SMs, for plans made
# without a card
_WG_BN = 96
_WG_CI, _WG_W = 96, 64
WG_SLOTS = 5
H100_SMS = 132

Stats = Tuple[torch.Tensor, torch.Tensor]
Block = Tuple[Tuple[torch.Tensor, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


def supports(shape: Sequence[int], dtype: torch.dtype, lane: int = 128) -> bool:
    """Whether the fused chain runs on an NHWC activation of this shape: the
    JAX gate verbatim (bf16, B % 128 == 0, C % 8 == 0, H >= 2, W >= 3)."""
    if len(shape) != 4:
        return False
    b, h, w, c = shape
    return (dtype == torch.bfloat16 and b % lane == 0 and b > 0
            and c % 8 == 0 and h >= 2 and w >= 3)


def pack_weights(weight: torch.Tensor) -> torch.Tensor:
    """torch OIHW [Co, Ci, 3, 3] -> [9, Co, Ci] bf16 per-tap matrices,
    tap = 3 * dh + dw (the kernel's and JAX `_pack_weights`' layout)."""
    co, ci = weight.shape[:2]
    return weight.permute(2, 3, 0, 1).reshape(9, co, ci).to(
        torch.bfloat16).contiguous()


def unpack_weights(w: torch.Tensor) -> torch.Tensor:
    """Inverse of `pack_weights`: [9, Co, Ci] -> OIHW [Co, Ci, 3, 3]."""
    return w.reshape(3, 3, *w.shape[1:]).permute(2, 3, 0, 1)


def _mma_sync_smem(th: int, tw: int, bn: int, ci_pad: int) -> int:
    """conv3x3_in.cu smem_bytes: weights, staged tile, sums, mean/scale."""
    return (9 * bn * ci_pad * 2 + (th + 2) * (tw + 2) * ci_pad * 2
            + 8 * bn * 4 + 2 * ci_pad * 4)


def conv_tiling(H: int, W: int, Ci: int, Co: int) -> Tuple[int, int, int, int]:
    """(th, tw, bn, P) of csrc/conv3x3_in.cu for an H x W output: tiles of
    th rows x tw columns (at most 128 positions; the tile stages th + 2 rows
    of tw + 2 columns), bn output channels resident per block, P tiles per
    sample. bn is the smallest channel tile that covers Co (at most 96)
    whose nine taps of weights fit in shared memory beside the staged
    input; raises when none fits."""
    tw = min(W, _TILE_M)
    th = min(H, max(1, _TILE_M // tw))
    ci_pad = -(-Ci // 16) * 16
    cover = min((bn for bn in _CHANNEL_TILES if bn >= Co), default=96)
    for bn in _CHANNEL_TILES:
        if bn > cover:
            continue
        if _mma_sync_smem(th, tw, bn, ci_pad) <= _SMEM_LIMIT:
            return th, tw, bn, -(-H // th) * -(-W // tw)
    raise ValueError(f"conv3x3: {Ci} input channels at width {W} do not fit "
                     f"the kernel's shared memory")


class ConvPlan(NamedTuple):
    """How `conv3x3_in` and `conv3x3_valid` run a shape on the card.

    route "wgmma" (csrc/conv3x3_wgmma.cu): persistent blocks walk units of
    `strip` output rows of one sample (`strips` a sample) through a ring of
    `slots` staged input rows. route "mma_sync" (csrc/conv3x3_in.cu): tiles
    of th x tw positions and bn channels.
    smem: shared memory a block, bytes; P: rows a sample of the statistics
    workspace [B, P, Co, 2]."""
    route: str
    smem: int
    P: int
    strip: int = 0
    strips: int = 0
    slots: int = 0
    th: int = 0
    tw: int = 0
    bn: int = 0


def wgmma_smem_bytes(W: int, Ci: int, slots: int) -> int:
    """Shared memory of a wgmma-route block (conv3x3_wgmma.cu `layout`):
    the 9 taps' weights of 96 output channels, `slots` staged rows of
    W + 2 positions, the bias, the prologue's mean and scale, 2 mbarriers
    a slot."""
    return (9 * _WG_BN * Ci * 2 + slots * (W + 2) * Ci * 2 + _WG_BN * 4
            + 2 * Ci * 4 + 2 * slots * 8)


def _wgmma_refusal(W: int, Ci: int, Co: int) -> Optional[str]:
    if (Ci, W) != (_WG_CI, _WG_W):
        return (f"it takes {_WG_CI} input channels at width {_WG_W}, not "
                f"{Ci} at {W}")
    if Co % _WG_BN:
        return f"{Co} output channels are no multiple of {_WG_BN}"
    if wgmma_smem_bytes(W, Ci, WG_SLOTS) > _SMEM_LIMIT:
        return (f"{WG_SLOTS} ring slots of {W + 2} x {Ci} beside the weights "
                f"take {wgmma_smem_bytes(W, Ci, WG_SLOTS)} B of shared "
                f"memory, more than {_SMEM_LIMIT}")
    return None


def _strip_rows(B: int, H: int, sms: int) -> int:
    """Output rows a unit: the strip that minimises the rows of the busiest
    block (ceil(units / blocks) waves x (strip + 1), the +1 for the halo
    rows a unit stages before its first output row), the longest on a tie."""
    def cost(L):
        units = B * -(-H // L)
        return -(-units // min(units, sms)) * (L + 1)
    return min(range(H, 0, -1), key=cost)


def plan_conv(B: int, H: int, W: int, Ci: int, Co: int, sms: int = H100_SMS,
              route: Optional[str] = None) -> ConvPlan:
    """The plan of a 3x3 conv of [B, Ci, H, W] -> [B, Co, H, W] (the output
    shape; a VALID input is 2 larger) on a card with `sms` SMs: the wgmma
    route, with `WG_SLOTS` ring slots and strips that fill the SMs, where it
    takes the shape, else the mma.sync route (`conv_tiling`). `route`
    forces one; a forced route that does not take the shape raises
    ValueError."""
    if route not in (None, "wgmma", "mma_sync"):
        raise ValueError(f"unknown conv route {route!r}")
    if route != "mma_sync":
        why = _wgmma_refusal(W, Ci, Co)
        if why is None:
            L = _strip_rows(B, H, sms)
            strips = -(-H // L)
            return ConvPlan("wgmma", wgmma_smem_bytes(W, Ci, WG_SLOTS),
                            strips * 8, L, strips, WG_SLOTS)
        if route == "wgmma":
            raise ValueError(f"conv3x3: the wgmma route does not take "
                             f"{Ci} -> {Co} at {H}x{W}: {why}")
    th, tw, bn, P = conv_tiling(H, W, Ci, Co)
    return ConvPlan("mma_sync", _mma_sync_smem(th, tw, bn, -(-Ci // 16) * 16),
                    P, th=th, tw=tw, bn=bn)


@functools.lru_cache(maxsize=None)
def device_sms(index: int) -> int:
    """The SMs of CUDA device `index`, which the planner fills."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _device_plan(x: torch.Tensor, H: int, W: int, Ci: int,
                 Co: int) -> ConvPlan:
    return plan_conv(x.shape[0], H, W, Ci, Co, device_sms(x.device.index))


def _bcast(v: torch.Tensor) -> torch.Tensor:
    return v[:, :, None, None]


def _prologue(x: torch.Tensor, mean: Optional[torch.Tensor],
                   scale: Optional[torch.Tensor], res: Optional[torch.Tensor],
                   prologue: Optional[str]) -> torch.Tensor:
    """The conv's true input: x, or bf16([relu]((x - m) * s) [+ res])."""
    if prologue is None:
        return x
    t = (x.float() - _bcast(mean)) * _bcast(scale)
    if prologue in ("in_relu", "in_relu_add"):
        t = torch.relu(t)
    if prologue in ("in_relu_add", "in_add"):
        t = t + res.float()
    return t.to(torch.bfloat16)


def finalize_stats(s1: torch.Tensor, s2: torch.Tensor, hw: int,
                   eps: float) -> Stats:
    """Partial sums [P, B, C] of y and y^2 -> f32 per-(b, c) mean and
    rsqrt(max(E[y^2] - mean^2, 0) + eps)."""
    mean = s1.sum(0) / hw
    ex2 = s2.sum(0) / hw
    var = torch.clamp(ex2 - mean * mean, min=0.0)
    return mean, torch.rsqrt(var + eps)


def conv3x3_in_ref(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                   mean: Optional[torch.Tensor] = None,
                   scale: Optional[torch.Tensor] = None,
                   res: Optional[torch.Tensor] = None,
                   prologue: Optional[str] = None,
                   eps: float = 1e-5) -> Tuple[torch.Tensor, Stats]:
    """Twin of `conv3x3_in`: the prologue rounded to bf16, then the conv in
    f32 on those bf16 values (bf16 products are exact in f32) with the bias,
    rounded once to bf16; the statistics from the rounded output."""
    inp = _prologue(x, mean, scale, res, prologue)
    y = F.conv2d(F.pad(inp.float(), (1, 1, 1, 1), mode="reflect"),
                 unpack_weights(w).float(), bias.float())
    y = y.to(torch.bfloat16)
    yf = y.float()
    stats = finalize_stats(yf.sum((2, 3))[None], (yf * yf).sum((2, 3))[None],
                           y.shape[2] * y.shape[3], eps)
    return y, stats


def _check_activation(name: str, **tensors) -> None:
    for arg, t in tensors.items():
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name}: {arg} must be bfloat16, got {t.dtype}")
        if t.dim() != 4 or not t.is_contiguous(
                memory_format=torch.channels_last):
            raise ValueError(f"{name}: {arg} must be a channels_last "
                             f"[B, C, H, W] tensor, got shape "
                             f"{tuple(t.shape)} strides {t.stride()}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} is not 16-byte aligned")


def _check_weights(name: str, w: torch.Tensor, co: int, ci: int) -> None:
    if (w.dtype != torch.bfloat16 or not w.is_contiguous()
            or tuple(w.shape) != (9, co, ci) or w.data_ptr() % 16):
        raise ValueError(f"{name}: weights must be contiguous bfloat16 "
                         f"[9, {co}, {ci}] (pack_weights), got {w.dtype} "
                         f"{tuple(w.shape)}")
    if ci % 8 or co % 8:
        raise ValueError(f"{name}: channels must be multiples of 8, got "
                         f"{ci} -> {co}")


def conv3x3_in(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
               mean: Optional[torch.Tensor] = None,
               scale: Optional[torch.Tensor] = None,
               res: Optional[torch.Tensor] = None,
               prologue: Optional[str] = None,
               eps: float = 1e-5,
               plan: Optional[ConvPlan] = None) -> Tuple[torch.Tensor, Stats]:
    """Reflect-padded 3x3 conv of x [B, Ci, H, W] with w [9, Co, Ci]
    (`pack_weights`) and bias [Co], after the prologue (None, "in_relu",
    "in_relu_add", "in_add"; mean and scale [B, Ci] f32, res like x).
    Returns (y [B, Co, H, W] bf16 channels_last, (mean, scale) of y, each
    [B, Co] f32). On CUDA x and res are channels_last bf16; `plan`
    (`plan_conv`) overrides the route chosen for the shape."""
    if prologue not in PROLOGUES:
        raise ValueError(f"unknown prologue {prologue!r}")
    if prologue is not None and (mean is None or scale is None):
        raise ValueError(f"conv3x3_in: prologue {prologue} needs mean, scale")
    if prologue in ("in_relu_add", "in_add") and res is None:
        raise ValueError(f"conv3x3_in: prologue {prologue} needs res")
    if x.device.type == "cpu":
        return conv3x3_in_ref(x, w, bias, mean, scale, res, prologue, eps)
    with_res = prologue in ("in_relu_add", "in_add")
    vecs = [t for t in (mean, scale) if prologue is not None]
    _cuda.check_cuda("conv3x3_in", x, w, bias, *vecs,
                     *([res] if with_res else []))
    _check_activation("conv3x3_in", x=x, **({"res": res} if with_res else {}))
    B, Ci, H, W = x.shape
    Co = w.shape[1]
    _check_weights("conv3x3_in", w, Co, Ci)
    if with_res and res.shape != x.shape:
        raise ValueError(f"conv3x3_in: res {tuple(res.shape)} is not shaped "
                         f"like x {tuple(x.shape)}")
    if H < 2 or W < 2:
        raise ValueError(f"conv3x3_in: reflect padding needs H, W >= 2, got "
                         f"{H}x{W}")
    bias = bias.float().contiguous()
    if prologue is not None:
        mean, scale = (t.float().contiguous() for t in (mean, scale))
        if mean.shape != (B, Ci) or scale.shape != (B, Ci):
            raise ValueError(f"conv3x3_in: mean and scale must be [{B}, {Ci}]")
    if plan is None:
        plan = _device_plan(x, H, W, Ci, Co)
    y = torch.empty((B, Co, H, W), dtype=torch.bfloat16, device=x.device,
                    memory_format=torch.channels_last)
    partial = torch.empty(B, plan.P, Co, 2, dtype=torch.float32,
                          device=x.device)
    stats = torch.empty(2, B, Co, dtype=torch.float32, device=x.device)
    stats_in = ((mean.data_ptr(), scale.data_ptr()) if prologue is not None
                else (None, None))
    args = (x.data_ptr(), res.data_ptr() if with_res else None, w.data_ptr(),
            bias.data_ptr(), *stats_in, y.data_ptr(), partial.data_ptr(),
            stats.data_ptr(), B, H, W, Ci, Co, PROLOGUES[prologue],
            float(eps))
    if plan.route == "wgmma":
        _cuda.launch("p2p_conv3x3_in_wg", x.device, *args, plan.strip,
                     plan.slots, plan.P)
        conv3x3_in.launches_wgmma += 1
    else:
        _cuda.launch("p2p_conv3x3_in", x.device, *args, plan.th, plan.tw,
                     plan.bn, plan.P)
    conv3x3_in.launches += 1
    return y, (stats[0], stats[1])


conv3x3_in.launches = 0
conv3x3_in.launches_wgmma = 0


def conv_s2_raw(x: torch.Tensor, k: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """3x3 stride-2 zero-pad-1 conv WITHOUT InstanceNorm: the enhancer's
    down1 conv, whose normalize folds into the section's entry prologue.
    Conv in x's dtype, then the bias added in that dtype (flax numerics)."""
    y = F.conv2d(x, k.to(x.dtype), None, stride=2, padding=1)
    return y + b.to(y.dtype)[:, None, None]


def normalize(y: torch.Tensor, mean: torch.Tensor,
              scale: torch.Tensor) -> torch.Tensor:
    """f32 (y - mean) * scale per (b, c). The bf16 y is promoted element by
    element inside the subtraction: no f32 copy of y is made."""
    return (y - _bcast(mean)).mul_(_bcast(scale))


def skip_apply(base: torch.Tensor, y: torch.Tensor, mean: torch.Tensor,
               scale: torch.Tensor) -> torch.Tensor:
    """The resblock's residual: base + bf16((y - mean) * scale)."""
    return base + normalize(y, mean, scale).to(torch.bfloat16)


def _cl(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous(memory_format=torch.channels_last)


def fused_resblock_chain(x: torch.Tensor, blocks: List[Block],
                         eps: float = 1e-5) -> torch.Tensor:
    """Sequential ResnetBlocks over a [B, C, H, W] bf16 activation, convs
    and InstanceNorm statistics fused. blocks: [((k1, b1), (k2, b2)), ...],
    the OIHW weights and biases of each block's ConvIN_{0,1}.Conv_0."""
    cur = _cl(x)
    for (k1, b1), (k2, b2) in blocks:
        y1, (m1, s1) = conv3x3_in(cur, pack_weights(k1), b1, eps=eps)
        y2, (m2, s2) = conv3x3_in(y1, pack_weights(k2), b2, m1, s1,
                                  prologue="in_relu", eps=eps)
        cur = skip_apply(cur, y2, m2, s2)
    return cur


def fused_enhancer_section(down1_raw: torch.Tensor, trunk_out: torch.Tensor,
                           blocks: List[Block], eps: float = 1e-5) -> torch.Tensor:
    """`h = relu(IN(down1_raw)) + trunk_out`, then the resblock chain, with
    the entry normalize + add fused into the first conv's prologue.

    down1_raw: the enhancer's down1 conv output before InstanceNorm,
    [B, C, H, W] bf16; trunk_out: the coarse branch output to add, same
    shape. The entry tensor is still materialized once, for the first
    block's residual add, as in JAX."""
    d, o = _cl(down1_raw), _cl(trunk_out)
    m0, s0 = instance_stats(d, eps)
    cur = None
    for bi, ((k1, b1), (k2, b2)) in enumerate(blocks):
        if bi == 0:
            y1, (m1, s1) = conv3x3_in(d, pack_weights(k1), b1, m0, s0, res=o,
                                      prologue="in_relu_add", eps=eps)
            cur = normalize(d, m0, s0).relu_().to(torch.bfloat16) + o
        else:
            y1, (m1, s1) = conv3x3_in(cur, pack_weights(k1), b1, eps=eps)
        y2, (m2, s2) = conv3x3_in(y1, pack_weights(k2), b2, m1, s1,
                                  prologue="in_relu", eps=eps)
        cur = skip_apply(cur, y2, m2, s2)
    return cur
