"""PatchGAN discriminators: NLayerDiscriminator and MultiscaleDiscriminator.

Port of pix2pixhdaudiosr_tpu/models/discriminator.py. Submodules are named
after the flax param tree (`scale1.ConvIN_0`, ..., `scale0.ConvIN_4`), so
convert.py's walk carries the weights across. Every normed layer runs
models/layers.instance_norm (kernel B3 on the card, differentiable through
models/layers.InstanceNormAct). Forward takes a logical NCHW tensor (the
system feeds a channels_last view of its NHWC pair). Param oracle: 5,531,522 at
input 4, ndf 64, 3 layers, 2 scales.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn

from .layers import ConvIN, avg_pool_3s2


class NLayerDiscriminator(nn.Module):
    """4x4 convs with zero pad 2 and leaky(0.2): stride 2 at ndf, then
    n_layers - 1 stride-2 layers doubling the width (capped at 512), one
    stride-1 layer, and a 1-channel stride-1 score conv. InstanceNorm on
    every layer but the first and the last. Returns every layer's output
    (score last) when get_interm_feat, else [score]."""

    def __init__(self, input_nc: int, ndf: int = 64, n_layers: int = 3,
                 use_sigmoid: bool = False, get_interm_feat: bool = False,
                 device=None):
        super().__init__()
        self.use_sigmoid, self.get_interm_feat = use_sigmoid, get_interm_feat
        self.ConvIN_0 = ConvIN(input_nc, ndf, 4, stride=2, pad=2, norm=False,
                               act="leaky", device=device)
        nf = ndf
        for i in range(1, n_layers):
            prev, nf = nf, min(nf * 2, 512)
            self.add_module(f"ConvIN_{i}", ConvIN(prev, nf, 4, stride=2, pad=2,
                                                  act="leaky", device=device))
        prev, nf = nf, min(nf * 2, 512)
        self.add_module(f"ConvIN_{n_layers}", ConvIN(
            prev, nf, 4, stride=1, pad=2, act="leaky", device=device))
        self.add_module(f"ConvIN_{n_layers + 1}", ConvIN(
            nf, 1, 4, stride=1, pad=2, norm=False, act="none", device=device))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats = []
        for layer in self.children():
            x = layer(x)
            feats.append(x)
        if self.use_sigmoid:
            feats[-1] = torch.sigmoid(feats[-1])
        return feats if self.get_interm_feat else [feats[-1]]


class MultiscaleDiscriminator(nn.Module):
    """num_d PatchGANs over an avg-pooled pyramid of the input. Output: one
    feature list a scale, the full-resolution scale (`scale{num_d-1}`)
    first."""

    def __init__(self, input_nc: int, ndf: int = 64, n_layers: int = 3,
                 use_sigmoid: bool = False, num_d: int = 3,
                 get_interm_feat: bool = False, device=None):
        super().__init__()
        self.num_d = num_d
        for i in range(num_d):
            self.add_module(f"scale{num_d - 1 - i}", NLayerDiscriminator(
                input_nc, ndf, n_layers, use_sigmoid, get_interm_feat,
                device=device))

    def forward(self, x: torch.Tensor) -> List[List[torch.Tensor]]:
        results = []
        for i in range(self.num_d):
            results.append(getattr(self, f"scale{self.num_d - 1 - i}")(x))
            if i != self.num_d - 1:
                x = avg_pool_3s2(x)
        return results


def build_discriminator(input_nc: int, ndf: int, n_layers_d: int,
                        use_sigmoid: bool, num_d: int, get_interm_feat: bool,
                        device=None) -> MultiscaleDiscriminator:
    """define_D parity. Parameters are left as torch initialises them (or
    unallocated on device="meta"): load a state_dict or call
    models/generator.init_normal_."""
    return MultiscaleDiscriminator(input_nc, ndf, n_layers_d, use_sigmoid,
                                   num_d, get_interm_feat, device=device)
