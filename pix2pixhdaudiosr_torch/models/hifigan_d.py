"""HiFi-GAN multi-scale + multi-period time-domain discriminator.

Port of pix2pixhdaudiosr_tpu/models/hifigan_d.py: `NormConv`,
`ScaleDiscriminator`, `PeriodDiscriminator`, `_avg_pool_1d` and
`HiFiGANMultiScaleMultiPeriodDiscriminator` (3 scale discriminators over
avg-pooled waveforms, grouped 1-D convs of kernels 15/41/5/3, and period
discriminators for periods (2, 3, 5, 7, 11), (5, 1) stride-(3, 1) 2-D
convs; leaky ReLU 0.1). The raw-scale MSD is spectral-normed, the pooled
scales and every MPD weight-normed, both computed as the JAX package does
them, statelessly, on every call.

Submodules are named after the flax tree (`msd{i}`, `mpd{p}`,
`NormConv_{k}`), each NormConv holding `weight` (the flax `kernel`, in
torch's [out, in/groups, *k] layout), `bias` and, weight-normed, `g`, so
that convert.py walks it. Forward takes the waveform [B, 1, T] and returns
one feature list a sub-discriminator ([B, C, T'] or [B, C, T'/p, p];
final score last), MSDs first.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


class NormConv(nn.Module):
    """A 1-D or 2-D conv whose kernel v is normalised on every call:
    norm="weight": w = v * g / sqrt(sum over all but the output channel of
    v^2 + 1e-12); norm="spectral": w = v / sigma, sigma = v' m u for m the
    kernel as [K, out], after 3 power iterations from u = 1/sqrt(out)
    (u and v' carry no gradient); norm="none": w = v. The normalisation
    runs in f32 outside autocast; the conv in the ambient compute dtype.
    `padding` is "SAME" (XLA's: ceil(T / stride) outputs, the odd pad
    sample at the end) or a pad per spatial axis."""

    def __init__(self, in_ch: int, features: int, kernel_size: Tuple[int, ...],
                 strides: Tuple[int, ...] = None, padding="SAME",
                 groups: int = 1, norm: str = "weight", device=None):
        super().__init__()
        if norm not in ("weight", "spectral", "none"):
            raise ValueError(f"unknown norm {norm}")
        self.kernel_size = tuple(kernel_size)
        self.strides = tuple(strides or (1,) * len(self.kernel_size))
        self.padding, self.groups, self.norm = padding, groups, norm
        self.weight = nn.Parameter(torch.empty(
            features, in_ch // groups, *self.kernel_size, device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device))
        if norm == "weight":
            self.g = nn.Parameter(torch.empty(features, device=device))

    def normalized_weight(self) -> torch.Tensor:
        v = self.weight
        with torch.autocast(v.device.type, enabled=False):
            if self.norm == "weight":
                red = tuple(range(1, v.dim()))
                scale = self.g * torch.rsqrt((v * v).sum(red) + 1e-12)
                return v * scale.view(-1, *(1,) * (v.dim() - 1))
            if self.norm == "spectral":
                mt = v.reshape(v.shape[0], -1)           # m^T: [out, K]
                with torch.no_grad():
                    u = torch.full((v.shape[0],), 1.0 / math.sqrt(v.shape[0]),
                                   dtype=v.dtype, device=v.device)
                    for _ in range(3):
                        vv = u @ mt
                        vv = vv * torch.rsqrt((vv * vv).sum() + 1e-12)
                        u = mt @ vv
                        u = u * torch.rsqrt((u * u).sum() + 1e-12)
                sigma = vv @ (mt.t() @ u)
                return v / sigma
            return v

    def _same_pad(self, x: torch.Tensor) -> List[int]:
        """F.pad's list (last axis first) of XLA's SAME padding."""
        pads = []
        for size, k, s in zip(x.shape[2:], self.kernel_size, self.strides):
            total = max((-(-size // s) - 1) * s + k - size, 0)
            pads.append((total // 2, total - total // 2))
        return [p for lo_hi in reversed(pads) for p in lo_hi]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.normalized_weight()
        if self.padding == "SAME":
            x, pad = F.pad(x, self._same_pad(x)), 0
        else:
            pad = tuple(self.padding)
        conv = F.conv1d if len(self.kernel_size) == 1 else F.conv2d
        return conv(x, w, self.bias, self.strides, pad, 1, self.groups)


class ScaleDiscriminator(nn.Module):
    """One HiFi-GAN scale discriminator: 7 grouped Conv1d + leaky(0.1),
    then a 1-channel conv. Returns every layer's output, score last."""

    def __init__(self, channels: Sequence[int] = (128, 128, 256, 512, 1024, 1024, 1024),
                 kernel_sizes: Sequence[int] = (15, 41, 5, 3),
                 groups: Sequence[int] = (1, 4, 16, 16, 16, 16, 1),
                 strides: Sequence[int] = (1, 2, 2, 4, 4, 1, 1),
                 norm: str = "weight", device=None):
        super().__init__()
        ks = [kernel_sizes[0]] + [kernel_sizes[1]] * 5 + [kernel_sizes[2]]
        prev = 1
        for i, (c, k, g, s) in enumerate(zip(channels, ks, groups, strides)):
            self.add_module(f"NormConv_{i}", NormConv(
                prev, c, (k,), (s,), "SAME", g, norm, device))
            prev = c
        self.add_module(f"NormConv_{len(channels)}", NormConv(
            prev, 1, (kernel_sizes[3],), None, "SAME", 1, norm, device))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        convs = list(self.children())
        feats = []
        for conv in convs[:-1]:
            x = F.leaky_relu(conv(x), 0.1)
            feats.append(x)
        feats.append(convs[-1](x))
        return feats


class PeriodDiscriminator(nn.Module):
    """One HiFi-GAN period discriminator: the waveform [B, 1, T], reflect-
    padded at the end to a multiple of the period, seen as [B, 1, T/p, p],
    through (5, 1) stride-(3, 1) convs + leaky(0.1), a (5, 1) stride-1 conv
    + leaky(0.1) and a 1-channel (3, 1) conv."""

    def __init__(self, period: int, channels: Sequence[int] = (32, 128, 512, 1024),
                 norm: str = "weight", device=None):
        super().__init__()
        self.period = period
        prev = 1
        for i, ch in enumerate(channels):
            self.add_module(f"NormConv_{i}", NormConv(
                prev, ch, (5, 1), (3, 1), (2, 0), 1, norm, device))
            prev = ch
        n = len(channels)
        self.add_module(f"NormConv_{n}", NormConv(
            prev, 1024, (5, 1), (1, 1), (2, 0), 1, norm, device))
        self.add_module(f"NormConv_{n + 1}", NormConv(
            1024, 1, (3, 1), (1, 1), (1, 0), 1, norm, device))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        b, c, t = x.shape
        pad = (-t) % self.period
        if pad:
            x = F.pad(x, (0, pad), mode="reflect")
        h = x.reshape(b, c, -1, self.period)
        convs = list(self.children())
        feats = []
        for conv in convs[:-1]:
            h = F.leaky_relu(conv(h), 0.1)
            feats.append(h)
        feats.append(convs[-1](h))
        return feats


def avg_pool_1d(x: torch.Tensor, k: int = 4, s: int = 2) -> torch.Tensor:
    """AvgPool1d(4, 2, padding=2), the zero padding counted (a sum of k
    samples over k)."""
    return F.avg_pool1d(x, k, s, padding=k // 2, count_include_pad=True)


class HiFiGANMultiScaleMultiPeriodDiscriminator(nn.Module):
    """MSD (`n_scales` scales) + MPD (`periods`); with follow_official_norm
    the raw-scale MSD is spectral-normed, every other weight-normed."""

    def __init__(self, periods: Sequence[int] = (2, 3, 5, 7, 11),
                 n_scales: int = 3, follow_official_norm: bool = True,
                 device=None):
        super().__init__()
        self.n_scales, self.periods = n_scales, tuple(periods)
        for i in range(n_scales):
            norm = "spectral" if follow_official_norm and i == 0 else "weight"
            self.add_module(f"msd{i}", ScaleDiscriminator(norm=norm,
                                                          device=device))
        for p in self.periods:
            self.add_module(f"mpd{p}", PeriodDiscriminator(p, device=device))

    def forward(self, x: torch.Tensor) -> List[List[torch.Tensor]]:
        out, h = [], x
        for i in range(self.n_scales):
            out.append(getattr(self, f"msd{i}")(h))
            if i != self.n_scales - 1:
                h = avg_pool_1d(h)
        for p in self.periods:
            out.append(getattr(self, f"mpd{p}")(x))
        return out


def build_hifigan_discriminator(cfg, device=None
                                ) -> HiFiGANMultiScaleMultiPeriodDiscriminator:
    """The system's HiFi-GAN D from --hifigan_periods and --hifigan_scales;
    parameters unset (or unallocated on device="meta"): load a state_dict
    or call init_normal_."""
    periods = tuple(int(p) for p in str(cfg.hifigan_periods).split(",") if p)
    return HiFiGANMultiScaleMultiPeriodDiscriminator(
        periods, cfg.hifigan_scales, device=device)


@torch.no_grad()
def init_normal_(model: nn.Module, generator: torch.Generator,
                 std: float = 0.02) -> nn.Module:
    """The JAX package's init: kernels N(0, std), biases 0, and each
    weight-normed conv's g = |v| per output channel, so that its first
    function is the plain conv's."""
    for m in model.modules():
        if isinstance(m, NormConv):
            m.weight.normal_(0.0, std, generator=generator)
            m.bias.zero_()
            if m.norm == "weight":
                red = tuple(range(1, m.weight.dim()))
                m.g.copy_(m.weight.pow(2).sum(red).sqrt())
    return model
