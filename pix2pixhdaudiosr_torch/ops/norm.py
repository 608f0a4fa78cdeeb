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
With `with_stats=True` it also returns the f32 statistics the backward
reads, [2, B, C]: the mean and the clamped variance of each plane.

`instance_norm_act_grad` is the backward of models/layers.InstanceNormAct
(csrc/instance_norm_bwd.cu; the JAX package has none, it differentiates
layers.instance_norm through XLA): dx from x, dy and the saved statistics,
on a one-pass (cluster) or a two-pass route chosen by the shape
(`plan_instance_norm_grad`), counted in
`instance_norm_act_grad.launches`, `.launches_by_route` and
`.launches_by_shape`. dy is read in the layout autograd hands it,
channels_last or NCHW (`dy_layout`); one the kernels cannot read (another
dtype than x's, or neither layout) is copied and counted in `.dy_copies`.
Its twin,
`instance_norm_act_grad_ref`, is the same formulation in plain PyTorch.
`instance_norm_act_backward` is the closed form that recomputes the
statistics and reads the slope off y: a second twin, on no path.
`instance_stats` runs the statistics passes alone (the fused enhancer folds
the normalize into its next conv).
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


def grad_onepass_smem(positions: int, tile: int, elem: int) -> int:
    """Shared memory of a one-pass backward block
    (csrc/instance_norm_bwd.cu grad_onepass_smem): the staged [positions,
    tile] slices of x and dy, then f32 scratch of [warps][2][tile] partial
    sums, [2][tile] block sums, [4][tile] mean, rstd, mean(g), mean(g x^)."""
    return 2 * positions * tile * elem + (2 * ONEPASS_WARPS + 6) * tile * 4


def _onepass_plan(hw: int, row: int, elem: int, staged: int, smem,
                  block_bytes: int, max_cluster: int, tile_bytes: int,
                  narrow: bool):
    """The one-pass plan of `plan_instance_norm` for `staged` tensors held
    at once (their plane is hw * tile * staged bytes; smem(positions, tile,
    elem) the block's shared memory), or None where no cluster holds it.
    `narrow` admits 16-byte tiles."""
    cap = tile_bytes
    while cap < 512 and hw * 2 * cap * staged <= SMALL_PLANE:
        cap *= 2
    widths = [t for t in (512, 256, 128, 64, 32, 16)
              if t <= cap and row % t == 0]
    wide = [t for t in widths if t >= _SECTOR]
    for t, limit in ([(t, block_bytes) for t in wide]
                     + [(t, 2 * block_bytes) for t in (widths if narrow
                                                        else wide)]):
        plane = hw * t * staged
        if plane > max_cluster * limit:
            continue
        k = min(max_cluster, -(-plane // block_bytes))
        positions = -(-hw // k)
        k = -(-hw // positions)    # no block left without positions
        size = smem(positions, t // elem, elem)
        if size <= SMEM_LIMIT:
            return INPlan("onepass", t // elem, k, positions, size)
    return None


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
    hw, row = H * W, C * dtype.itemsize
    if B < 1 or hw < 1 or row % _VEC:
        return INPlan("twopass")
    return _onepass_plan(hw, row, dtype.itemsize, 1, onepass_smem,
                         block_bytes, max_cluster, tile_bytes,
                         True) or INPlan("twopass")


@functools.lru_cache(maxsize=256)
def plan_instance_norm_grad(B: int, H: int, W: int, C: int,
                            dtype: torch.dtype,
                            narrow: bool = False,
                            block_bytes: int = BLOCK_BYTES,
                            max_cluster: int = MAX_CLUSTER,
                            tile_bytes: int = TILE_BYTES) -> INPlan:
    """The route of `instance_norm_act_grad` for x [B, C, H, W] of `dtype`
    (a function of the shape alone), as measured on an H100 at every
    training shape (tools/in_grad_ablation.py, PERF.md): the one-pass route
    as `plan_instance_norm` with x and dy both staged (a plane of 2 * H*W *
    tile bytes); a 16-byte tile where a position's row is one 32-byte
    sector at most (its two tiles then split each sector: Family A's 512 x
    128 x 16 bf16, 0.061 against 0.078 ms two-pass) or with `narrow`; else
    the two-pass route, which at 512 x 128 x 48 and x 64 beat that narrow
    one-pass plan and three 3-plane designs (PERF.md), and takes rows that
    are no multiple of 16 bytes."""
    hw, row = H * W, C * dtype.itemsize
    if B < 1 or hw < 1 or row % _VEC:
        return INPlan("twopass")
    return _onepass_plan(hw, row, dtype.itemsize, 2, grad_onepass_smem,
                         block_bytes, max_cluster, tile_bytes,
                         narrow or row <= _SECTOR) or INPlan("twopass")


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
                          eps: float = 1e-5, with_stats: bool = False):
    """Twin of `instance_norm_act`. x: [B, C, H, W], any layout."""
    mean, var = instance_moments_ref(x)
    rstd = torch.rsqrt(var + eps)
    y = (x.float() - mean[:, :, None, None]) * rstd[:, :, None, None]
    y = activate(y, act).to(x.dtype)
    return (y, torch.stack((mean, var))) if with_stats else y


def instance_moments_ref(x: torch.Tensor):
    """f32 (mean, max(E[x^2] - mean^2, 0)), each [B, C], of x [B, C, H, W]:
    the statistics `instance_norm_act` saves for its backward."""
    xf = x.float()
    mean = xf.mean(dim=(2, 3))
    ex2 = (xf * xf).mean(dim=(2, 3))
    return mean, torch.clamp(ex2 - mean * mean, min=0.0)


def instance_stats_ref(x: torch.Tensor, eps: float = 1e-5):
    """Twin of `instance_stats`. x: [B, C, H, W], any layout."""
    mean, var = instance_moments_ref(x)
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


def _ptr(t):
    """A tensor's data pointer for ctypes, None (NULL) for no tensor."""
    return None if t is None else t.data_ptr()


def _launch_onepass(x: torch.Tensor, y: torch.Tensor, plan: INPlan,
                    pitches: Tuple[int, int], act: str, eps: float,
                    saved=None) -> None:
    B, C, H, W = x.shape
    _cuda.launch("p2p_instance_norm_onepass", x.device, x.data_ptr(),
                 y.data_ptr(), _ptr(saved), B, H, W, C, pitches[0],
                 pitches[1], int(x.dtype == torch.bfloat16), ACTS[act],
                 float(eps), plan.tile, plan.cluster, plan.positions)


def _launch_twopass(x: torch.Tensor, y: torch.Tensor, act: str,
                    eps: float, saved=None) -> None:
    B, C, H, W = x.shape
    P = stat_chunks(B, H * W, C)
    partial = torch.empty(B, P, C, 2, dtype=torch.float32, device=x.device)
    stats = torch.empty(B, C, 2, dtype=torch.float32, device=x.device)
    _cuda.launch("p2p_instance_norm_act", x.device, x.data_ptr(), y.data_ptr(),
                 partial.data_ptr(), stats.data_ptr(), _ptr(saved), B, H * W,
                 C, int(x.dtype == torch.bfloat16), ACTS[act], float(eps), P)


def instance_norm_act(x: torch.Tensor, act: str = "none",
                      eps: float = 1e-5, with_stats: bool = False):
    """InstanceNorm2d(affine=False) + none/relu/leaky(0.2) over H, W.
    x: [B, C, H, W]; on CUDA float32 or bfloat16 with rows of W*C
    contiguous (`nhwc_pitches`). Returns y, of the input dtype and
    channels_last; with `with_stats`, (y, f32 [2, B, C] mean and clamped
    variance), what `instance_norm_act_grad` reads."""
    if x.device.type == "cpu":
        return instance_norm_act_ref(x, act, eps, with_stats)
    _cuda.check_cuda("instance_norm_act", x)
    pitches = nhwc_pitches("instance_norm_act", x)
    if act not in ACTS:
        raise ValueError(f"unknown activation {act!r}")
    B, C, H, W = x.shape
    plan = plan_instance_norm(B, H, W, C, x.dtype)
    y = torch.empty_like(x, memory_format=torch.channels_last)
    saved = (torch.empty(2, B, C, dtype=torch.float32, device=x.device)
             if with_stats else None)
    if plan.route == "onepass":
        if x.data_ptr() % _VEC:
            raise ValueError("instance_norm_act: the one-pass route needs a "
                             "16-byte aligned start")
        _launch_onepass(x, y, plan, pitches, act, eps, saved)
        instance_norm_act.launches_onepass += 1
    else:  # the two-pass kernels read a contiguous tensor: copy a view
        _launch_twopass(x.contiguous(memory_format=torch.channels_last), y,
                        act, eps, saved)
    instance_norm_act.launches += 1
    shapes = instance_norm_act.launches_by_shape
    shapes[(H, W, C)] = shapes.get((H, W, C), 0) + 1
    return (y, saved) if with_stats else y


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


def _slope_times(g: torch.Tensor, xhat: torch.Tensor, act: str):
    """g * act'(x^) as a select: relu 1 where x^ > 0, leaky 1 where
    x^ >= 0, else 0.2 (csrc/instance_norm_bwd.cu slope_times)."""
    if act == "relu":
        return torch.where(xhat > 0, g, 0.0)
    if act == "leaky":
        return torch.where(xhat >= 0, g, 0.2 * g)
    if act == "none":
        return g
    raise ValueError(f"unknown activation {act!r}")


def instance_norm_act_grad_ref(x: torch.Tensor, dy: torch.Tensor,
                               saved: torch.Tensor, act: str = "none",
                               eps: float = 1e-5) -> torch.Tensor:
    """Twin of `instance_norm_act_grad`, in its formulation: from the
    forward's saved f32 (mean, clamped var), rstd = rsqrt(var + eps),
    x^ = (x - mean) rstd, g = dy act'(x^) and
    dx = rstd (g - mean(g) - x^ mean(g x^)), the means over H, W, with no
    variance term where var was clamped to 0. x's dtype, channels_last."""
    mean, var = saved[0, :, :, None, None], saved[1, :, :, None, None]
    rstd = torch.rsqrt(var + eps)
    xhat = (x.float() - mean) * rstd
    g = _slope_times(dy.float(), xhat, act)
    g_mean = g.mean(dim=(2, 3), keepdim=True)
    gx_mean = torch.where(var > 0, (g * xhat).mean(dim=(2, 3), keepdim=True),
                          0.0)
    return (rstd * (g - g_mean - xhat * gx_mean)).to(
        x.dtype, memory_format=torch.channels_last)


def grad_chunks(B: int, HW: int, nv: int) -> int:
    """Row chunks P per sample for the backward's two-pass partial sums over
    nv vectors a position (csrc/instance_norm_bwd.cu
    in_grad_partial_kernel): enough blocks to fill the card, and at most
    _MAX_ROWS_PER_THREAD rows summed by one thread."""
    ctv = min(nv, _THREADS)
    fill = -(-_TARGET_BLOCKS // (B * -(-nv // ctv)))
    accuracy = -(-HW // (_THREADS // ctv * _MAX_ROWS_PER_THREAD))
    return max(1, min(HW, max(fill, accuracy)))


# how the backward kernels read dy (csrc/instance_norm_bwd.cu kDyNHWC,
# kDyPlanar)
DY_LAYOUTS = {"nhwc": 0, "planar": 1}


def dy_layout(x_dtype: torch.dtype, dy_dtype: torch.dtype, shape, strides,
              misalign: int, vectors: bool):
    """How `instance_norm_act_grad` reads a dy of `shape` [B, C, H, W],
    `strides` (elements) and a start `misalign` bytes past a 16-byte
    boundary: ("nhwc", sample pitch, row pitch) where rows of W*C are
    contiguous, ("planar", sample pitch, channel pitch) where each channel's
    H*W positions are (an NCHW tensor, as the reflect pad's backward and
    the feature-matching L1 hand it: read in place at any alignment), or
    None where the wrapper copies it (another dtype than x's, or neither
    layout). With `vectors` (the one-pass route copies an nhwc dy 16 bytes
    at a time) an nhwc dy needs a 16-byte start and pitches, else it is
    read as planar where its strides allow, or copied."""
    if dy_dtype != x_dtype:
        return None
    B, C, H, W = shape
    sb, sc, sh, sw = strides
    elem = dy_dtype.itemsize
    if (C == 1 or sc == 1) and (W == 1 or sw == C):
        row = sh if H > 1 else W * C
        sample = sb if B > 1 else H * row
        if not vectors or (misalign == 0 and (sample * elem) % _VEC == 0
                           and (row * elem) % _VEC == 0):
            return "nhwc", sample, row
    if (W == 1 or sw == 1) and (H == 1 or sh == W):
        chan = sc if C > 1 else H * W
        return "planar", sb if B > 1 else C * chan, chan
    return None


def _readable_dy(x: torch.Tensor, dy: torch.Tensor, vectors: bool):
    """(dy, its layout, sample pitch, row or channel pitch): dy as autograd
    hands it where `dy_layout` reads it in place, else a channels_last copy
    in x's dtype, counted in `instance_norm_act_grad.dy_copies` (and by
    (H, W, C))."""
    layout = dy_layout(x.dtype, dy.dtype, tuple(dy.shape), dy.stride(),
                       dy.data_ptr() % _VEC, vectors)
    if layout is not None:
        return (dy, *layout)
    dy = dy.to(x.dtype, memory_format=torch.channels_last)
    fn = instance_norm_act_grad
    fn.dy_copies += 1
    B, C, H, W = x.shape
    fn.dy_copies_by_shape[(H, W, C)] = fn.dy_copies_by_shape.get((H, W, C),
                                                                 0) + 1
    return (dy, "nhwc", H * W * C, W * C)


def instance_norm_act_grad(x: torch.Tensor, dy: torch.Tensor,
                           saved: torch.Tensor, act: str = "none",
                           eps: float = 1e-5,
                           plan: INPlan = None) -> torch.Tensor:
    """dL/dx of y = act(instance_norm(x)) given dL/dy and the statistics
    the forward saved (`instance_norm_act(..., with_stats=True)`: f32
    [2, B, C], mean and clamped variance). x: [B, C, H, W] as the forward
    took it (on CUDA: rows of W*C contiguous, `nhwc_pitches`; a cropped
    view is read in place); dy: x's shape, read in place channels_last or
    NCHW (`dy_layout`). Returns x's dtype and shape, channels_last. `plan`
    forces a route (`plan_instance_norm_grad`'s by default)."""
    if x.device.type == "cpu":
        return instance_norm_act_grad_ref(x, dy, saved, act, eps)
    name = "instance_norm_act_grad"
    _cuda.check_cuda(name, x, dy, saved)
    x_pitches = nhwc_pitches(name, x)
    if act not in ACTS:
        raise ValueError(f"unknown activation {act!r}")
    B, C, H, W = x.shape
    if dy.shape != x.shape:
        raise ValueError(f"{name}: dy {tuple(dy.shape)} for x {tuple(x.shape)}")
    if (saved.shape != (2, B, C) or saved.dtype != torch.float32
            or not saved.is_contiguous()):
        raise ValueError(f"{name}: saved statistics must be contiguous f32 "
                         f"[2, {B}, {C}], got {saved.dtype} "
                         f"{tuple(saved.shape)}")
    plan = plan or plan_instance_norm_grad(B, H, W, C, x.dtype)
    vectors = plan.route == "onepass"  # 16-byte copies of x and an nhwc dy
    if vectors and x.data_ptr() % _VEC:
        raise ValueError(f"{name}: the one-pass route needs a 16-byte "
                         f"aligned x")
    dy, layout, dy_sample, dy_pitch = _readable_dy(x, dy, vectors)
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device,
                     memory_format=torch.channels_last)
    head = (x.data_ptr(), dy.data_ptr(), dx.data_ptr(), saved.data_ptr())
    dims = (B, H, W, C, *x_pitches, DY_LAYOUTS[layout], dy_sample, dy_pitch,
            int(x.dtype == torch.bfloat16), ACTS[act], float(eps))
    if plan.route == "onepass":
        _cuda.launch("p2p_instance_norm_grad_onepass", x.device, *head,
                     *dims, plan.tile, plan.cluster, plan.positions)
    else:
        vec = _VEC // x.element_size()
        pitches = (*x_pitches, dy_sample, dy_pitch) if layout == "nhwc" \
            else x_pitches
        starts = (x, dy) if layout == "nhwc" else (x,)
        if (C % vec or any(p % vec for p in pitches)
                or any(t.data_ptr() % _VEC for t in starts)):
            vec = 1
        P = grad_chunks(B, H * W, C // vec)
        partial = torch.empty(B, P, C, 2, dtype=torch.float32,
                              device=x.device)
        coef = torch.empty(B, C, 4, dtype=torch.float32, device=x.device)
        _cuda.launch("p2p_instance_norm_grad_twopass", x.device, *head,
                     partial.data_ptr(), coef.data_ptr(), *dims, P, vec)
    fn = instance_norm_act_grad
    fn.launches += 1
    fn.launches_by_route[plan.route] = fn.launches_by_route.get(plan.route,
                                                                0) + 1
    fn.launches_by_shape[(H, W, C)] = fn.launches_by_shape.get((H, W, C),
                                                               0) + 1
    return dx


instance_norm_act_grad.launches = 0
instance_norm_act_grad.launches_by_route = {}
instance_norm_act_grad.launches_by_shape = {}
instance_norm_act_grad.dy_copies = 0
instance_norm_act_grad.dy_copies_by_shape = {}


def instance_norm_act_backward(x: torch.Tensor, y: torch.Tensor,
                               dy: torch.Tensor, act: str = "none",
                               eps: float = 1e-5) -> torch.Tensor:
    """The closed form (a second twin of `instance_norm_act_grad`, on no
    path): dL/dx of y = act(instance_norm(x)) given dL/dy, in f32, the
    statistics recomputed from x: x^ = (x - mean) rstd,
    g = dy act'(y), and
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
