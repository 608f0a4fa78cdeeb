"""Shared layers: affine-free InstanceNorm (+ fused activation), the exact
AvgPool of the reference pyramids, and the conv / deconv blocks.

Port of pix2pixhdaudiosr_tpu/models/layers.py:189-246, :276-455. Modules
take logical NCHW tensors; on the card they run channels_last (physically
NHWC, the JAX package's layout). Reflect padding plus conv is plain
`F.pad(mode="reflect")` + `F.conv2d` on cuDNN; the JAX package's Toeplitz
and implicit-reflect formulations exist only for the TPU and are not
ported. Submodules are named after the flax param tree (`Conv_0`,
`ConvTranspose_0`, `ConvIN_1`, ...) so that convert.py is a walk over it.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.norm import activate, instance_norm_act, instance_norm_act_backward

DECONV_MODES = ("same", "torch")


class InstanceNormAct(torch.autograd.Function):
    """`instance_norm_act` with a gradient (eps 1e-5): the kernel (or, on the
    CPU, its twin) forward, ops/norm.instance_norm_act_backward backward. It
    saves x and y, and y is the next layer's input, which autograd keeps
    anyway."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, act: str = "none") -> torch.Tensor:
        y = instance_norm_act(x, act)
        ctx.save_for_backward(x, y)
        ctx.act = act
        return y

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        x, y = ctx.saved_tensors
        return instance_norm_act_backward(x, y, dy, ctx.act), None


def instance_norm(x: torch.Tensor, act: str = "none") -> torch.Tensor:
    """InstanceNorm2d(affine=False), eps 1e-5, then `act`, on the kernel of
    ops/norm.py (channels_last out). On the card x is channels_last or the
    same-mode deconv's crop of it, which the kernel reads in place. Where
    autograd records (grad enabled and x requires grad) it runs through
    `InstanceNormAct`; otherwise nothing is saved for a backward."""
    if torch.is_grad_enabled() and x.requires_grad:
        return InstanceNormAct.apply(x, act)
    return instance_norm_act(x, act)


def avg_pool_3s2(x: torch.Tensor) -> torch.Tensor:
    """AvgPool2d(3, stride=2, padding=1, count_include_pad=False). Where
    autograd records through a CUDA tensor (the discriminator's pyramid
    under the G losses), the pool runs on an NCHW copy and returns
    channels_last: PyTorch's channels_last avg_pool2d backward on CUDA
    returns a wrong dx for C >= 2 (off by about max|dx| with torch
    2.11+cu128 on an H100, tests/test_torch_cuda.py), while its NCHW
    backward is right."""
    if x.is_cuda and torch.is_grad_enabled() and x.requires_grad:
        return F.avg_pool2d(x.contiguous(), 3, 2, 1,
                            count_include_pad=False).contiguous(
                                memory_format=torch.channels_last)
    return F.avg_pool2d(x, 3, 2, 1, count_include_pad=False)


class ConvIN(nn.Module):
    """(optional reflect pad) -> Conv -> InstanceNorm -> activation."""

    def __init__(self, in_ch: int, features: int, kernel: int, stride: int = 1,
                 pad: int = 0, reflect: int = 0, norm: bool = True,
                 act: str = "relu", device=None):
        super().__init__()
        self.reflect, self.norm, self.act = reflect, norm, act
        self.Conv_0 = nn.Conv2d(in_ch, features, kernel, stride=stride,
                                padding=pad, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.reflect:
            x = F.pad(x, (self.reflect,) * 4, mode="reflect")
        x = self.Conv_0(x)
        if self.norm:  # the activation runs inside the norm kernel
            return instance_norm(x, self.act)
        return torch.tanh(x) if self.act == "tanh" else activate(x, self.act)


class ConvTransposeIN(nn.Module):
    """ConvTranspose(3, stride 2) -> InstanceNorm -> ReLU, exact 2x upsample.

    mode "same": flax nn.ConvTranspose(3, s2, "SAME"), the JAX package's
    default, = conv_transpose2d(padding=0) cropped to [:2H, :2W].
    mode "torch": torch ConvTranspose2d(3, s2, padding 1, output_padding 1)
    (the JAX package's --torch_deconv). Both take the weight
    flip_hw(k).permute(2, 3, 0, 1) of the flax kernel k (convert.py)."""

    def __init__(self, in_ch: int, features: int, mode: str = "same",
                 device=None):
        super().__init__()
        if mode not in DECONV_MODES:
            raise ValueError(f"deconv mode must be one of {DECONV_MODES}")
        self.mode = mode
        self.ConvTranspose_0 = nn.ConvTranspose2d(in_ch, features, 3, stride=2,
                                                  device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.ConvTranspose_0.weight, self.ConvTranspose_0.bias
        if self.mode == "torch":
            y = F.conv_transpose2d(x, w, b, stride=2, padding=1,
                                   output_padding=1)
        else:
            H, W = x.shape[-2:]
            y = F.conv_transpose2d(x, w, b, stride=2)[..., : 2 * H, : 2 * W]
        return instance_norm(y, "relu")


class ResnetBlock(nn.Module):
    """Reflect-padded 3x3 conv x2 with InstanceNorm and residual add."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.ConvIN_0 = ConvIN(dim, dim, 3, reflect=1, act="relu", device=device)
        self.ConvIN_1 = ConvIN(dim, dim, 3, reflect=1, act="none", device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.ConvIN_1(self.ConvIN_0(x))
