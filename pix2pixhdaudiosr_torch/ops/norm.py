"""The InstanceNorm + activation kernel (csrc/instance_norm.cu) and its plain
PyTorch twin.

`instance_norm_act` replaces pix2pixhdaudiosr_tpu/ops/norm_pallas.py:
fused_instance_norm and computes what pix2pixhdaudiosr_tpu/models/layers.py:
instance_norm does (f32 mean and E[x^2], var = max(E[x^2] - mean^2, 0),
eps 1e-5), with the activation fused. See csrc/instance_norm.cu for what
bounds it on the card and how the design answers it. A CPU tensor runs the
twin; a CUDA tensor launches the kernel (counted in
`instance_norm_act.launches`) or raises. Inference only: the backward comes
with training. `instance_stats` runs the statistics passes alone (the fused
enhancer folds the normalize into its next conv).
"""

from __future__ import annotations

import torch

from . import _cuda

ACTS = {"none": 0, "relu": 1, "leaky": 2}

_THREADS = 256       # csrc/instance_norm.cu kThreads
_MAX_TILE = 256      # csrc/instance_norm.cu kMaxTile
_TARGET_BLOCKS = 1056  # 8 blocks per SM on a 132-SM H100
_MAX_ROWS_PER_THREAD = 256


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


def _check_input(name: str, x: torch.Tensor) -> None:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: dtype {x.dtype} not supported "
                         f"(float32 or bfloat16)")
    if x.dim() != 4 or not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"{name}: expected a channels_last [B, C, H, W] "
                         f"tensor, got shape {tuple(x.shape)} strides "
                         f"{x.stride()}")
    if x.shape[0] > 65535:  # the stats pass launches a grid z-slice a sample
        raise ValueError(f"{name}: batch {x.shape[0]} > 65535")


def instance_norm_act(x: torch.Tensor, act: str = "none",
                      eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm2d(affine=False) + none/relu/leaky(0.2) over H, W.
    x: [B, C, H, W]; on CUDA it must be channels_last (physically NHWC)
    float32 or bfloat16. Returns the input dtype and layout."""
    if x.device.type == "cpu":
        return instance_norm_act_ref(x, act, eps)
    _cuda.check_cuda("instance_norm_act", x)
    _check_input("instance_norm_act", x)
    if act not in ACTS:
        raise ValueError(f"unknown activation {act!r}")
    B, C, H, W = x.shape
    P = stat_chunks(B, H * W, C)
    y = torch.empty_like(x, memory_format=torch.channels_last)
    partial = torch.empty(B, P, C, 2, dtype=torch.float32, device=x.device)
    stats = torch.empty(B, C, 2, dtype=torch.float32, device=x.device)
    _cuda.launch("p2p_instance_norm_act", x.device, x.data_ptr(), y.data_ptr(),
                 partial.data_ptr(), stats.data_ptr(), B, H * W, C,
                 int(x.dtype == torch.bfloat16), ACTS[act], float(eps), P)
    instance_norm_act.launches += 1
    return y


instance_norm_act.launches = 0


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
