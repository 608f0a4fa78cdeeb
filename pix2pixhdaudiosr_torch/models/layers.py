"""Shared layers: affine-free InstanceNorm (+ fused activation), the exact
AvgPool of the reference pyramids, and the conv / deconv blocks.

Port of pix2pixhdaudiosr_tpu/models/layers.py:189-246, :276-455. Modules
take logical NCHW tensors; on the card they run channels_last (physically
NHWC, the JAX package's layout). Reflect padding plus conv is plain
`F.pad(mode="reflect")` + `F.conv2d` on cuDNN; the JAX package's Toeplitz
and implicit-reflect formulations exist only for the TPU and are not
ported. Submodules are named after the flax param tree (`Conv_0`,
`ConvTranspose_0`, `ConvIN_1`, ...) so that convert.py is a walk over it.

Context parallelism (the JAX package's `cp_axis` paths, :165-270 and
:329-418): a layer whose `cp` attribute holds a parallel.mesh.Group takes
a block of a spectrogram whose frame axis (dim 3) is split over the group.
Each such layer exchanges its own kernel-radius halo with its neighbours
and reproduces the global padding at the ends of the axis, so its output
is its slice of the unsharded layer's; InstanceNorm averages its moments
over the group. parallel/halo.py `set_cp` sets `cp` on a generator; with
`cp` None (the default) every layer runs exactly as without it. A
ResnetBlock whose `tp` holds a group runs tensor-parallel
(parallel/tp.py)."""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.norm import (activate, instance_apply, instance_moments,
                        instance_norm_act, instance_norm_act_grad)
from ..parallel.halo import cp_pad_w

DECONV_MODES = ("same", "torch")


class InstanceNormAct(torch.autograd.Function):
    """`instance_norm_act` with a gradient (eps 1e-5): the kernel (or, on the
    CPU, its twin) forward, which also returns the f32 mean and clamped
    variance of each plane, and `instance_norm_act_grad` (the backward
    kernel, or its twin) from x, dy and those statistics. It saves x (a
    cropped view stays a view) and the statistics, not y."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, act: str = "none") -> torch.Tensor:
        y, saved = instance_norm_act(x, act, with_stats=True)
        ctx.save_for_backward(x, saved)
        ctx.act = act
        return y

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        x, saved = ctx.saved_tensors
        return instance_norm_act_grad(x, dy, saved, ctx.act), None


def instance_norm(x: torch.Tensor, act: str = "none",
                  cp=None) -> torch.Tensor:
    """InstanceNorm2d(affine=False), eps 1e-5, then `act`, on the kernel of
    ops/norm.py (channels_last out). On the card x is channels_last or the
    same-mode deconv's crop of it, which the kernel reads in place. Where
    autograd records (grad enabled and x requires grad) it runs through
    `InstanceNormAct`; otherwise nothing is saved for a backward. With `cp`
    (a group over which the frame axis is split) the statistics span every
    shard: `cp_instance_norm`."""
    if cp is not None:
        return cp_instance_norm(x, act, cp)
    if torch.is_grad_enabled() and x.requires_grad:
        return InstanceNormAct.apply(x, act)
    return instance_norm_act(x, act)


def cp_instance_norm(x: torch.Tensor, act: str, cp) -> torch.Tensor:
    """InstanceNorm of a block of a frame axis split over `cp`
    (pix2pixhdaudiosr_tpu/models/layers.py:189-208 with cp_axis): the
    block's f32 mean and E[x^2] (B3m), their SUM over the group, then the
    normalize with `act` (B3a), which divides the sums by n (the shards
    being equal-sized: JAX's pmean) and sets var = max(E[x^2] - mean^2,
    0). Both kernels read a cropped view in place. Inference only."""
    moments = instance_moments(x)
    if cp.size > 1:
        moments = cp.all_reduce_sum(moments)
    return instance_apply(x, moments, act, count=cp.size)


def avg_pool_3s2(x: torch.Tensor, cp=None) -> torch.Tensor:
    """AvgPool2d(3, stride=2, padding=1, count_include_pad=False). Where
    autograd records through a CUDA tensor (the discriminator's pyramid
    under the G losses), the pool runs on an NCHW copy and returns
    channels_last: PyTorch's channels_last avg_pool2d backward on CUDA
    returns a wrong dx for C >= 2 (off by about max|dx| with torch
    2.11+cu128 on an H100, tests/test_torch_cuda.py), while its NCHW
    backward is right. With `cp`, x is a block of a frame axis split over
    it: `cp_avg_pool_3s2`."""
    if cp is not None:
        return cp_avg_pool_3s2(x, cp)
    if x.is_cuda and torch.is_grad_enabled() and x.requires_grad:
        return F.avg_pool2d(x.contiguous(), 3, 2, 1,
                            count_include_pad=False).contiguous(
                                memory_format=torch.channels_last)
    return F.avg_pool2d(x, 3, 2, 1, count_include_pad=False)


@functools.lru_cache(maxsize=64)
def _pool_counts(h: int, w: int, left_end: bool, right_end: bool):
    """The window counts of the pool on a block of h x w (w frames between
    neighbours' halo frames): every window is full except where it reads
    the global zero padding, the top and bottom rows, and the first column
    of the first shard (`left_end`) and the last of the last (`right_end`)
    where that reads past the last frame (pix2pixhdaudiosr_tpu/models/
    layers.py:256-270)."""
    oh, ow = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    ph = np.pad(np.ones(h, np.float32), 1)
    pw = np.ones(w + 2, np.float32)
    pw[0] = 0.0 if left_end else 1.0
    pw[-1] = 0.0 if right_end else 1.0
    hcnt = np.array([ph[2 * i: 2 * i + 3].sum() for i in range(oh)])
    wcnt = np.array([pw[2 * j: 2 * j + 3].sum() for j in range(ow)])
    return (hcnt[:, None] * wcnt[None, :]).astype(np.float32)


def cp_avg_pool_3s2(x: torch.Tensor, cp) -> torch.Tensor:
    """`avg_pool_3s2` of a block of a frame axis split over `cp`: the
    frames padded by neighbour exchange (zeros at the global ends), the
    frequency axis by zeros, the 3 x 3 windows summed and divided by
    `_pool_counts`, where only the true global boundary windows are partial
    (a pool with count_include_pad=False on the padded block would count
    the interior edges' halo frames as padding). Summed and divided in f32
    and cast once, as F.avg_pool2d does."""
    _, _, h, w = x.shape
    padded = F.pad(cp_pad_w(x, 1, cp, "zeros"), (0, 0, 1, 1))
    sums = F.avg_pool2d(padded.float(), 3, 2, 0, divisor_override=1)
    counts = torch.from_numpy(_pool_counts(h, w, cp.rank == 0,
                                           cp.rank == cp.size - 1))
    return (sums / counts.to(sums.device)).to(x.dtype)


class ConvIN(nn.Module):
    """(optional reflect pad) -> Conv -> InstanceNorm -> activation.

    With `rows`, the conv takes at most that many rows a call on the card
    (the output convs: generator.OUT_ROWS).

    With `cp` (pix2pixhdaudiosr_tpu/models/layers.py:329-360): a reflect
    pad reflects the frequency axis locally, then takes a reflect halo of
    the frames (the global ends reflect themselves); a zero-padded conv
    (the stride-2 downs, pad 1) takes a zero halo of the frames and pads
    only the frequency axis in the conv."""

    def __init__(self, in_ch: int, features: int, kernel: int, stride: int = 1,
                 pad: int = 0, reflect: int = 0, norm: bool = True,
                 act: str = "relu", rows: int = 0, device=None):
        super().__init__()
        self.reflect, self.pad, self.norm, self.act = reflect, pad, norm, act
        self.rows = rows
        self.cp = None
        self.Conv_0 = nn.Conv2d(in_ch, features, kernel, stride=stride,
                                padding=pad, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cp = self.cp
        if cp is None:
            if self.reflect:
                x = F.pad(x, (self.reflect,) * 4, mode="reflect")
            if self.rows and x.is_cuda and x.shape[0] > self.rows:
                x = torch.cat([self.Conv_0(r) for r in x.split(self.rows)])
            else:
                x = self.Conv_0(x)
        else:
            if self.reflect:
                x = F.pad(x, (0, 0, self.reflect, self.reflect),
                          mode="reflect")
                x = cp_pad_w(x, self.reflect, cp, "reflect")
            if self.pad:
                x = cp_pad_w(x, self.pad, cp, "zeros")
            conv = self.Conv_0
            x = F.conv2d(x, conv.weight, conv.bias, conv.stride,
                         (self.pad, 0))
        if self.norm:  # the activation runs inside the norm kernel
            return instance_norm(x, self.act, cp)
        return torch.tanh(x) if self.act == "tanh" else activate(x, self.act)


class ConvTransposeIN(nn.Module):
    """ConvTranspose(3, stride 2) -> InstanceNorm -> ReLU, exact 2x upsample.

    mode "same": flax nn.ConvTranspose(3, s2, "SAME"), the JAX package's
    default, = conv_transpose2d(padding=0) cropped to [:2H, :2W].
    mode "torch": torch ConvTranspose2d(3, s2, padding 1, output_padding 1)
    (the JAX package's --torch_deconv). Both take the weight
    flip_hw(k).permute(2, 3, 0, 1) of the flax kernel k (convert.py).

    With `cp` (mode "same" only, as in the JAX package,
    pix2pixhdaudiosr_tpu/models/layers.py:370-418): one input frame from
    each neighbour (zeros at the global ends), the upsample, and the crop
    [2, 2W + 2) of the frames: output frame u of the block's
    conv_transpose2d(padding=0) is global frame u - 2 + 2 o for a block
    starting at input frame o, and the zero halo adds nothing to the frames
    kept."""

    def __init__(self, in_ch: int, features: int, mode: str = "same",
                 device=None):
        super().__init__()
        if mode not in DECONV_MODES:
            raise ValueError(f"deconv mode must be one of {DECONV_MODES}")
        self.mode = mode
        self.cp = None
        self.ConvTranspose_0 = nn.ConvTranspose2d(in_ch, features, 3, stride=2,
                                                  device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.ConvTranspose_0.weight, self.ConvTranspose_0.bias
        if self.cp is not None:
            if self.mode == "torch":
                raise ValueError("the torch-mode deconv (--torch_deconv) does "
                                 "not support context parallelism")
            H, W = x.shape[-2:]
            y = F.conv_transpose2d(cp_pad_w(x, 1, self.cp, "zeros"), w, b,
                                   stride=2)[..., : 2 * H, 2: 2 * W + 2]
            return instance_norm(y, "relu", self.cp)
        if self.mode == "torch":
            y = F.conv_transpose2d(x, w, b, stride=2, padding=1,
                                   output_padding=1)
        else:
            H, W = x.shape[-2:]
            y = F.conv_transpose2d(x, w, b, stride=2)[..., : 2 * H, : 2 * W]
        return instance_norm(y, "relu")


class ResnetBlock(nn.Module):
    """Reflect-padded 3x3 conv x2 with InstanceNorm and residual add.

    With `tp` (a group; parallel/tp.py has sharded the weights): ConvIN_0
    gives this rank's C/N channels, normalized locally; ConvIN_1's conv
    sums over them (no bias), the partial sums are all-reduced, the bias is
    added, and the InstanceNorm and residual add run whole."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.tp = None
        self.ConvIN_0 = ConvIN(dim, dim, 3, reflect=1, act="relu", device=device)
        self.ConvIN_1 = ConvIN(dim, dim, 3, reflect=1, act="none", device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is None:
            return x + self.ConvIN_1(self.ConvIN_0(x))
        h = self.ConvIN_0(x)
        conv = self.ConvIN_1.Conv_0
        part = F.conv2d(F.pad(h, (1,) * 4, mode="reflect"), conv.weight)
        h = self.tp.all_reduce_sum(part) + conv.bias.view(1, -1, 1, 1)
        return x + instance_norm(h.contiguous(memory_format=torch.channels_last))
