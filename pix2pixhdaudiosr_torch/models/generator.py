"""Generators: GlobalTrunk, GlobalGenerator, LocalEnhancer.

Port of pix2pixhdaudiosr_tpu/models/generator.py:22-165 and
`build_generator` (:201-225). Module names follow the flax param tree
(`global.ConvIN_0`, `global.ResnetBlock_2.ConvIN_1`, `enh1_down1`,
`enh1_block0`, `enh1_up`, `enh1_final`, ...). Forward takes and returns
logical NCHW; the system feeds a channels_last view of its NHWC
spectrogram. Architecture oracle: LocalEnhancer G3L2 at ngf 48 with 2-channel
io has 156,050,690 parameters.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .layers import ConvIN, ConvTransposeIN, ResnetBlock, avg_pool_3s2


class GlobalTrunk(nn.Module):
    """GlobalGenerator without its final (reflect pad, 7x7 conv, tanh):
    c7s1 head, strided downs, resnet blocks, mirrored deconvs."""

    def __init__(self, input_nc: int, ngf: int = 64, n_downsampling: int = 4,
                 n_blocks: int = 9, deconv_mode: str = "same", device=None):
        super().__init__()
        self.add_module("ConvIN_0", ConvIN(input_nc, ngf, 7, reflect=3,
                                           device=device))
        for i in range(n_downsampling):
            self.add_module(f"ConvIN_{i + 1}", ConvIN(
                ngf * 2 ** i, ngf * 2 ** (i + 1), 3, stride=2, pad=1,
                device=device))
        dim = ngf * 2 ** n_downsampling
        for i in range(n_blocks):
            self.add_module(f"ResnetBlock_{i}", ResnetBlock(dim, device=device))
        for i in range(n_downsampling):
            mult = 2 ** (n_downsampling - i)
            self.add_module(f"ConvTransposeIN_{i}", ConvTransposeIN(
                ngf * mult, ngf * mult // 2, deconv_mode, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.children():
            x = layer(x)
        return x


class GlobalGenerator(nn.Module):
    """GlobalTrunk + c7s1-output_nc + tanh."""

    def __init__(self, input_nc: int, output_nc: int, ngf: int = 64,
                 n_downsampling: int = 4, n_blocks: int = 9,
                 deconv_mode: str = "same", device=None):
        super().__init__()
        self.GlobalTrunk_0 = GlobalTrunk(input_nc, ngf, n_downsampling,
                                         n_blocks, deconv_mode, device=device)
        self.ConvIN_0 = ConvIN(ngf, output_nc, 7, reflect=3, norm=False,
                               act="tanh", device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ConvIN_0(self.GlobalTrunk_0(x))


class LocalEnhancer(nn.Module):
    """Coarse global trunk at ngf*2^n_local on a downsampled pyramid plus
    per-level enhancer branches fused by addition."""

    def __init__(self, input_nc: int, output_nc: int, ngf: int = 32,
                 n_downsample_global: int = 4, n_blocks_global: int = 9,
                 n_local_enhancers: int = 1, n_blocks_local: int = 3,
                 deconv_mode: str = "same", device=None):
        super().__init__()
        self.n_local_enhancers = nle = n_local_enhancers
        self.n_blocks_local = n_blocks_local
        self.add_module("global", GlobalTrunk(
            input_nc, ngf * 2 ** nle, n_downsample_global, n_blocks_global,
            deconv_mode, device=device))
        for n in range(1, nle + 1):
            ngf_n = ngf * 2 ** (nle - n)
            self.add_module(f"enh{n}_down0", ConvIN(input_nc, ngf_n, 7,
                                                    reflect=3, device=device))
            self.add_module(f"enh{n}_down1", ConvIN(
                ngf_n, ngf_n * 2, 3, stride=2, pad=1, device=device))
            for i in range(n_blocks_local):
                self.add_module(f"enh{n}_block{i}",
                                ResnetBlock(ngf_n * 2, device=device))
            self.add_module(f"enh{n}_up", ConvTransposeIN(
                ngf_n * 2, ngf_n, deconv_mode, device=device))
            if n == nle:
                self.add_module(f"enh{n}_final", ConvIN(
                    ngf_n, output_nc, 7, reflect=3, norm=False, act="tanh",
                    device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        nle = self.n_local_enhancers
        pyramid = [x]
        for _ in range(nle):
            pyramid.append(avg_pool_3s2(pyramid[-1]))
        out = getattr(self, "global")(pyramid[-1])
        for n in range(1, nle + 1):
            h = getattr(self, f"enh{n}_down0")(pyramid[nle - n])
            h = getattr(self, f"enh{n}_down1")(h) + out
            for i in range(self.n_blocks_local):
                h = getattr(self, f"enh{n}_block{i}")(h)
            h = getattr(self, f"enh{n}_up")(h)
            if n == nle:
                h = getattr(self, f"enh{n}_final")(h)
            out = h
        return out


def build_generator(net_g: str, input_nc: int, output_nc: int, ngf: int,
                    n_downsample_global: int, n_blocks_global: int,
                    n_local_enhancers: int, n_blocks_local: int,
                    deconv_mode: str = "same", device=None) -> nn.Module:
    """define_G parity. Parameters are left as torch initialises them (or
    unallocated on device="meta"): load a state_dict or call `init_normal_`."""
    if net_g == "global":
        return GlobalGenerator(input_nc, output_nc, ngf, n_downsample_global,
                               n_blocks_global, deconv_mode, device=device)
    if net_g == "local":
        return LocalEnhancer(input_nc, output_nc, ngf, n_downsample_global,
                             n_blocks_global, n_local_enhancers,
                             n_blocks_local, deconv_mode, device=device)
    if net_g == "encoder":
        raise NotImplementedError("the feature Encoder comes with the "
                                  "optional nets (ROADMAP A9)")
    raise ValueError(f"generator not implemented: {net_g}")


@torch.no_grad()
def init_normal_(model: nn.Module, generator: torch.Generator,
                 std: float = 0.02) -> nn.Module:
    """The JAX package's init: conv and deconv weights N(0, std), biases 0
    (pix2pixhdaudiosr_tpu/models/layers.py conv_init)."""
    for name, p in model.named_parameters():
        if name.endswith("bias"):
            p.zero_()
        else:
            p.normal_(0.0, std, generator=generator)
    return model
