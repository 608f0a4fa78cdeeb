"""The InstanceNorm + activation kernels (csrc/instance_norm.cu) and their
plain PyTorch twin.

`instance_norm_act` replaces pix2pixhdaudiosr_tpu/ops/norm_pallas.py:
fused_instance_norm and computes what pix2pixhdaudiosr_tpu/models/layers.py:
instance_norm does (f32 mean and E[x^2], var = max(E[x^2] - mean^2, 0),
eps 1e-5), with the activation fused. On the card it takes one of two
routes, chosen by the shape alone (`plan_instance_norm`):
  one-pass  one launch, one HBM read and one write: each (sample, channel
            tile) plane is staged in the shared memory of a thread-block
            cluster, whose blocks exchange their partial sums;
  two-pass  statistics, finalize, apply (two reads, one write), for planes
            too large for a cluster's shared memory or rows that are no
            multiple of 16 bytes.
See csrc/instance_norm.cu for what bounds it on the card and how each route
answers it. A CPU tensor runs the twin; a CUDA tensor launches a kernel
(counted in `instance_norm_act.launches`, the one-pass ones also in
`.launches_onepass`, and by (H, W, C) in `.launches_by_shape`) or raises.
`instance_norm_act_backward` is the closed form of what JAX differentiates
(plain PyTorch in f32; the JAX package has no backward kernel either), the
backward of models/layers.InstanceNormAct. `instance_stats` runs the
statistics passes alone (the fused enhancer folds the normalize into its
next conv).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch

from . import _cuda

ACTS = {"none": 0, "relu": 1, "leaky": 2}

_THREADS = 256       # csrc/instance_norm.cu kThreads
_MAX_TILE = 256      # csrc/instance_norm.cu kMaxTile
_TARGET_BLOCKS = 1056  # 8 blocks per SM on a 132-SM H100
_MAX_ROWS_PER_THREAD = 256

# The one-pass route (csrc/instance_norm.cu in_onepass_kernel). The limits
# follow tools/in_onepass_ablation.py on an H100 (PERF.md): a tile
# narrower than a 32-byte sector costs ~1.8x at 512 x 128 x 48 (the rest of
# each sector is fetched again, not served from L2), 64 KB blocks (three an
# SM) beat 128 KB blocks by 10-14%, and a plane of a few KB wants a wider
# tile so that a block has work.
ONEPASS_WARPS = 16        # kOnepassThreads / 32
SMEM_LIMIT = 232448       # dynamic shared memory a block may use on sm_90
BLOCK_BYTES = 65536       # staged plane bytes a block aims at (twice at most)
MAX_CLUSTER = 16          # above the portable 8: non-portable, measured
TILE_BYTES = 128          # widest channel tile, bytes of one position...
SMALL_PLANE = 32768       # ...unless a plane at that width is at most this
_SECTOR = 32              # bytes of a DRAM sector
_VEC = 16                 # bytes a thread copies at once


class INPlan(NamedTuple):
    """How `instance_norm_act` runs a shape. route "onepass": a cluster of
    `cluster` blocks owns `tile` channels of one sample, each block
    `positions` of its H*W positions and `smem_bytes` of shared memory;
    grid (cluster * C / tile, B). route "twopass": the other fields are 0."""
    route: str
    tile: int = 0
    cluster: int = 0
    positions: int = 0
    smem_bytes: int = 0


def onepass_smem(positions: int, tile: int, elem: int) -> int:
    """Shared memory of a one-pass block (csrc/instance_norm.cu
    onepass_smem): the staged [positions, tile] slice, then f32 scratch of
    [warps][2][tile] partial sums, [2][tile] block sums, [2][tile] mean and
    rstd."""
    return positions * tile * elem + (2 * ONEPASS_WARPS + 4) * tile * 4


@functools.lru_cache(maxsize=256)
def plan_instance_norm(B: int, H: int, W: int, C: int, dtype: torch.dtype,
                       block_bytes: int = BLOCK_BYTES,
                       max_cluster: int = MAX_CLUSTER,
                       tile_bytes: int = TILE_BYTES) -> INPlan:
    """The route and the one-pass plan for x [B, C, H, W] of `dtype`; a
    function of the shape alone. Tiles are 16 bytes times a power of two up
    to 512 that divides a position's C channels, at most `tile_bytes` wide
    (wider while the plane, H*W positions of a tile, stays within
    SMALL_PLANE). In order of preference: the widest tile of at least a
    sector whose plane `max_cluster` blocks of `block_bytes` hold; the same
    with blocks of up to twice that; a 16-byte tile so. K, the cluster
    size, is the fewest blocks of `block_bytes` that hold the plane, at
    most `max_cluster`. Rows that are no multiple of 16 bytes, and planes
    that no cluster holds, take the two-pass route."""
    elem = dtype.itemsize
    hw, row = H * W, C * dtype.itemsize
    if B < 1 or hw < 1 or row % _VEC:
        return INPlan("twopass")
    cap = tile_bytes
    while cap < 512 and hw * 2 * cap <= SMALL_PLANE:
        cap *= 2
    widths = [t for t in (512, 256, 128, 64, 32, 16)
              if t <= cap and row % t == 0]
    wide = [t for t in widths if t >= _SECTOR]
    for t, limit in ([(t, block_bytes) for t in wide]
                     + [(t, 2 * block_bytes) for t in widths]):
        if hw * t > max_cluster * limit:
            continue
        k = min(max_cluster, -(-hw * t // block_bytes))
        positions = -(-hw // k)
        k = -(-hw // positions)    # no block left without positions
        smem = onepass_smem(positions, t // elem, elem)
        if smem <= SMEM_LIMIT:
            return INPlan("onepass", t // elem, k, positions, smem)
    return INPlan("twopass")


def activate(y: torch.Tensor, act: str) -> torch.Tensor:
    """none / relu / leaky(0.2), the activations the kernel fuses."""
    if act == "relu":
        return torch.relu(y)
    if act == "leaky":
        return torch.where(y >= 0, y, 0.2 * y)
    if act == "none":
        return y
    raise ValueError(f"unknown activation {act!r}")


def instance_norm_act_ref(x: torch.Tensor, act: str = "none",
                          eps: float = 1e-5) -> torch.Tensor:
    """Twin of `instance_norm_act`. x: [B, C, H, W], any layout."""
    mean, rstd = instance_stats_ref(x, eps)
    y = (x.float() - mean[:, :, None, None]) * rstd[:, :, None, None]
    return activate(y, act).to(x.dtype)


def instance_stats_ref(x: torch.Tensor, eps: float = 1e-5):
    """Twin of `instance_stats`. x: [B, C, H, W], any layout."""
    xf = x.float()
    mean = xf.mean(dim=(2, 3))
    ex2 = (xf * xf).mean(dim=(2, 3))
    var = torch.clamp(ex2 - mean * mean, min=0.0)
    return mean, torch.rsqrt(var + eps)


def stat_chunks(B: int, HW: int, C: int) -> int:
    """Row chunks P per sample for the statistics pass: enough blocks to
    fill the card, and at most _MAX_ROWS_PER_THREAD rows summed by one
    thread (which bounds the f32 rounding of each partial sum)."""
    ctw = min(C, _MAX_TILE)
    row_groups = _THREADS // ctw
    c_tiles = -(-C // ctw)
    fill = -(-_TARGET_BLOCKS // (B * c_tiles))
    accuracy = -(-HW // (row_groups * _MAX_ROWS_PER_THREAD))
    return max(1, min(HW, max(fill, accuracy)))


def _check_dtype_batch(name: str, x: torch.Tensor) -> None:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: dtype {x.dtype} not supported "
                         f"(float32 or bfloat16)")
    if x.dim() == 4 and x.shape[0] > 65535:  # a grid row per sample
        raise ValueError(f"{name}: batch {x.shape[0]} > 65535")


def _check_input(name: str, x: torch.Tensor) -> None:
    _check_dtype_batch(name, x)
    if x.dim() != 4 or not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"{name}: expected a channels_last [B, C, H, W] "
                         f"tensor, got shape {tuple(x.shape)} strides "
                         f"{x.stride()}")


def nhwc_pitches(name: str, x: torch.Tensor) -> Tuple[int, int]:
    """(sample pitch, row pitch) in elements of x [B, C, H, W] whose rows of
    W*C elements are contiguous (channels_last, or a view of it cropped in
    H and W, as the `same`-mode deconv output is). A view that is not
    channels_last-contiguous must have sample and row pitches that are
    multiples of 16 bytes. Raises ValueError otherwise."""
    _check_dtype_batch(name, x)
    if x.dim() != 4:
        raise ValueError(f"{name}: expected a channels_last [B, C, H, W] "
                         f"tensor, got shape {tuple(x.shape)}")
    B, C, H, W = x.shape
    sb, sc, sh, sw = x.stride()
    if (C > 1 and sc != 1) or (W > 1 and sw != C):
        raise ValueError(f"{name}: expected a channels_last [B, C, H, W] "
                         f"tensor (rows of W*C contiguous), got shape "
                         f"{tuple(x.shape)} strides {x.stride()}")
    row = sh if H > 1 else W * C
    sample = sb if B > 1 else H * row
    if x.is_contiguous(memory_format=torch.channels_last):
        return H * W * C, W * C
    elem = x.element_size()
    if (sample * elem) % _VEC or (row * elem) % _VEC:
        raise ValueError(f"{name}: a strided view needs 16-byte sample and "
                         f"row pitches, got ({sample}, {row}) x {elem} bytes")
    return sample, row


def _launch_onepass(x: torch.Tensor, y: torch.Tensor, plan: INPlan,
                    pitches: Tuple[int, int], act: str, eps: float) -> None:
    B, C, H, W = x.shape
    _cuda.launch("p2p_instance_norm_onepass", x.device, x.data_ptr(),
                 y.data_ptr(), B, H, W, C, pitches[0], pitches[1],
                 int(x.dtype == torch.bfloat16), ACTS[act], float(eps),
                 plan.tile, plan.cluster, plan.positions)


def _launch_twopass(x: torch.Tensor, y: torch.Tensor, act: str,
                    eps: float) -> None:
    B, C, H, W = x.shape
    P = stat_chunks(B, H * W, C)
    partial = torch.empty(B, P, C, 2, dtype=torch.float32, device=x.device)
    stats = torch.empty(B, C, 2, dtype=torch.float32, device=x.device)
    _cuda.launch("p2p_instance_norm_act", x.device, x.data_ptr(), y.data_ptr(),
                 partial.data_ptr(), stats.data_ptr(), B, H * W, C,
                 int(x.dtype == torch.bfloat16), ACTS[act], float(eps), P)


def instance_norm_act(x: torch.Tensor, act: str = "none",
                      eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm2d(affine=False) + none/relu/leaky(0.2) over H, W.
    x: [B, C, H, W]; on CUDA float32 or bfloat16 with rows of W*C
    contiguous (`nhwc_pitches`). Returns the input dtype, channels_last."""
    if x.device.type == "cpu":
        return instance_norm_act_ref(x, act, eps)
    _cuda.check_cuda("instance_norm_act", x)
    pitches = nhwc_pitches("instance_norm_act", x)
    if act not in ACTS:
        raise ValueError(f"unknown activation {act!r}")
    B, C, H, W = x.shape
    plan = plan_instance_norm(B, H, W, C, x.dtype)
    y = torch.empty_like(x, memory_format=torch.channels_last)
    if plan.route == "onepass":
        if x.data_ptr() % _VEC:
            raise ValueError("instance_norm_act: the one-pass route needs a "
                             "16-byte aligned start")
        _launch_onepass(x, y, plan, pitches, act, eps)
        instance_norm_act.launches_onepass += 1
    else:  # the two-pass kernels read a contiguous tensor: copy a view
        _launch_twopass(x.contiguous(memory_format=torch.channels_last), y,
                        act, eps)
    instance_norm_act.launches += 1
    shapes = instance_norm_act.launches_by_shape
    shapes[(H, W, C)] = shapes.get((H, W, C), 0) + 1
    return y


instance_norm_act.launches = 0
instance_norm_act.launches_onepass = 0
instance_norm_act.launches_by_shape = {}


def instance_stats(x: torch.Tensor, eps: float = 1e-5):
    """The statistics of `instance_norm_act` without the apply pass:
    f32 (mean, rsqrt(var + eps)), each [B, C], of x [B, C, H, W]
    (pix2pixhdaudiosr_tpu/ops/enhancer_pallas.py:_instance_stats). On CUDA
    x must be channels_last float32 or bfloat16; launches counted in
    `instance_stats.launches`."""
    if x.device.type == "cpu":
        return instance_stats_ref(x, eps)
    _cuda.check_cuda("instance_stats", x)
    _check_input("instance_stats", x)
    B, C, H, W = x.shape
    P = stat_chunks(B, H * W, C)
    partial = torch.empty(B, P, C, 2, dtype=torch.float32, device=x.device)
    stats = torch.empty(2, B, C, dtype=torch.float32, device=x.device)
    _cuda.launch("p2p_instance_stats", x.device, x.data_ptr(),
                 partial.data_ptr(), stats[0].data_ptr(), stats[1].data_ptr(),
                 B, H * W, C, int(x.dtype == torch.bfloat16), float(eps), P)
    instance_stats.launches += 1
    return stats[0], stats[1]


instance_stats.launches = 0


def instance_norm_act_backward(x: torch.Tensor, y: torch.Tensor,
                               dy: torch.Tensor, act: str = "none",
                               eps: float = 1e-5) -> torch.Tensor:
    """dL/dx of y = act(instance_norm(x)) given dL/dy, in f32 from the saved
    input: x^ = (x - mean) rstd, g = dy act'(y), and
    dx = rstd (g - mean(g) - x^ mean(g x^)), the means over H, W; where
    E[x^2] - mean^2 was clamped to 0 the variance passes no gradient. The
    activation's slope is read off the forward's own output y (relu: y > 0,
    leaky: 1 where y >= 0, else 0.2), as JAX differentiates the activation
    of the rounded output. Returns x's dtype and shape."""
    xf = x.float()
    mean = xf.mean(dim=(2, 3), keepdim=True)
    var = (xf * xf).mean(dim=(2, 3), keepdim=True) - mean * mean
    rstd = torch.rsqrt(torch.clamp(var, min=0.0) + eps)
    xhat = (xf - mean) * rstd
    del xf
    g = dy.float()
    if act == "relu":
        g = g * (y > 0)
    elif act == "leaky":
        g = torch.where(y >= 0, g, 0.2 * g)
    elif act != "none":
        raise ValueError(f"unknown activation {act!r}")
    g_mean = g.mean(dim=(2, 3), keepdim=True)
    gx_mean = torch.where(var > 0, (g * xhat).mean(dim=(2, 3), keepdim=True),
                          0.0)
    return ((g - g_mean - xhat * gx_mean) * rstd).to(x.dtype)
