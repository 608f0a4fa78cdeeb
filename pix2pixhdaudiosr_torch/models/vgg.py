"""VGG19 feature extractor and the perceptual loss.

Port of pix2pixhdaudiosr_tpu/models/vgg.py (the reference's Vgg19 sliced at
relu1_1, relu2_1, relu3_1, relu4_1 and relu5_1, and its VGGLoss). The
reference disables this loss for every audio recipe, and so does the
system (system.py keeps G_VGG at zero); it is here for API completeness.
The module keeps torchvision's layout, a `features` nn.Sequential of
conv, ReLU and max-pool at torchvision's indices up to relu5_1 (index 29),
so a torchvision vgg19 state_dict loads into it as it is. The convs are
cuDNN's, as the JAX package's are XLA's: there is no Pallas site here.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

# torchvision vgg19.features conv widths per stage, up to conv5_1
_CFG = ((64, 64), (128, 128), (256, 256, 256, 256), (512, 512, 512, 512),
        (512,))
# torchvision's features index of each conv, in order (conv1_1 .. conv5_1)
CONV_INDICES = (0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25, 28)
# the features index after which each slice is taken: relu1_1, relu2_1,
# relu3_1, relu4_1, relu5_1
SLICE_ENDS = (1, 6, 11, 20, 29)
# the flax module's name of each conv, in order
CONV_NAMES = tuple(f"conv{s + 1}_{i + 1}" for s, ws in enumerate(_CFG)
                   for i in range(len(ws)))


class Vgg19Features(nn.Module):
    """Returns [relu1_1, relu2_1, relu3_1, relu4_1, relu5_1] of an NCHW
    input, as the reference's Vgg19.forward. The convs compute in `dtype`
    (autocast when it is not f32) with f32 parameters, as the flax module
    does. Its random init is flax's (lecun normal kernels: a normal
    truncated at 2 sigma, scaled to variance 1/fan_in; zero biases), drawn
    from `generator`."""

    def __init__(self, dtype: torch.dtype = torch.float32,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        layers: List[nn.Module] = []
        cin = 3
        for stage, widths in enumerate(_CFG):
            if stage > 0:
                layers.append(nn.MaxPool2d(2, 2))
            for w in widths:
                layers += [nn.Conv2d(cin, w, 3, padding=1, device="meta"),
                           nn.ReLU()]
                cin = w
        self.features = nn.Sequential(*layers).to_empty(device=device)
        assert tuple(i for i, m in enumerate(self.features)
                     if isinstance(m, nn.Conv2d)) == CONV_INDICES
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for i in CONV_INDICES:
            conv = self.features[i]
            fan_in = conv.weight[0].numel()
            # flax variance_scaling(1, fan_in, truncated_normal): the
            # truncation's stddev correction 0.8796...
            std = math.sqrt(1.0 / fan_in) / .87962566103423978
            nn.init.trunc_normal_(conv.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            conv.bias.zero_()

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        outs, h, start = [], x, 0
        ctx = (torch.autocast(x.device.type, dtype=self.dtype)
               if self.dtype != torch.float32 else torch.autocast(
                   x.device.type, enabled=False))
        with ctx:
            for end in SLICE_ENDS:
                h = self.features[start: end + 1](h)
                outs.append(h)
                start = end + 1
        return outs


class VGGLoss(nn.Module):
    """Weighted L1 over the VGG19 slices, y detached."""

    WEIGHTS = (1.0 / 32, 1.0 / 16, 1.0 / 8, 1.0 / 4, 1.0)

    def __init__(self, vgg: Vgg19Features):
        super().__init__()
        self.vgg = vgg

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        fx, fy = self.vgg(x), self.vgg(y.detach())
        loss = 0.0
        for w, a, b in zip(self.WEIGHTS, fx, fy):
            loss = loss + w * torch.mean(torch.abs(a.float() - b.float()))
        return loss


@torch.no_grad()
def load_torch_weights(model: Vgg19Features, npz_path: str) -> Vgg19Features:
    """Copy a torchvision vgg19 state_dict saved as a .npz of numpy arrays
    keyed 'features.<i>.weight' / '.bias' into `model`: the convs it holds
    (up to conv5_1), the file's later ones skipped as the JAX package's
    loader does. The layout is torchvision's, so nothing is transposed."""
    raw = np.load(npz_path)
    for i in CONV_INDICES:
        conv = model.features[i]
        for leaf in ("weight", "bias"):
            getattr(conv, leaf).copy_(torch.from_numpy(
                np.asarray(raw[f"features.{i}.{leaf}"], np.float32)))
    return model
