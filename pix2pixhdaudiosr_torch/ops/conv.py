"""VALID 3x3 stride-1 convolution of a pre-padded input: the second entry
point of csrc/conv3x3_in.cu, and its plain twin.

`conv3x3_valid` replaces pix2pixhdaudiosr_tpu/ops/conv_pallas.py:
conv3x3_pallas, which no path of the JAX package calls either: the same
kernel as `ops/enhancer.conv3x3_in` with no reflect, prologue, bias or
statistics, Ci != Co allowed, and an optional ReLU before the bf16 round.
A CPU tensor runs the twin; a CUDA tensor launches a kernel (counted in
`conv3x3_valid.launches`) or raises: the wgmma kernel (csrc/conv3x3_wgmma.cu,
also counted in `conv3x3_valid.launches_wgmma`) where `enhancer.plan_conv`
gives it the shape, else the mma.sync kernel (csrc/conv3x3_in.cu).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import _cuda
from .enhancer import (ConvPlan, _check_activation, _check_weights,
                       _device_plan, pack_weights)


def conv3x3_valid_ref(x_padded: torch.Tensor, w: torch.Tensor,
                      relu: bool = False) -> torch.Tensor:
    """Twin of `conv3x3_valid`: the conv in f32, ReLU, cast to x's dtype."""
    y = F.conv2d(x_padded.float(), w.float())
    return (torch.relu(y) if relu else y).to(x_padded.dtype)


def conv3x3_valid(x_padded: torch.Tensor, w: torch.Tensor,
                  relu: bool = False,
                  plan: Optional[ConvPlan] = None) -> torch.Tensor:
    """x_padded [B, Ci, H + 2, W + 2] (padded by one, reflect or zero: the
    caller's choice) with OIHW w [Co, Ci, 3, 3] -> [B, Co, H, W]. On CUDA
    x_padded is channels_last bfloat16 and so is the result; `plan`
    (`enhancer.plan_conv`) overrides the route chosen for the shape."""
    if x_padded.device.type == "cpu":
        return conv3x3_valid_ref(x_padded, w, relu)
    _cuda.check_cuda("conv3x3_valid", x_padded, w)
    _check_activation("conv3x3_valid", x_padded=x_padded)
    B, Ci, Hp, Wp = x_padded.shape
    if w.dim() != 4 or tuple(w.shape[1:]) != (Ci, 3, 3):
        raise ValueError(f"conv3x3_valid: weights must be [Co, {Ci}, 3, 3], "
                         f"got {tuple(w.shape)}")
    if Hp < 3 or Wp < 3:
        raise ValueError(f"conv3x3_valid: input {Hp}x{Wp} smaller than 3x3")
    Co, H, W = w.shape[0], Hp - 2, Wp - 2
    wp = pack_weights(w)
    _check_weights("conv3x3_valid", wp, Co, Ci)
    if plan is None:
        plan = _device_plan(x_padded, H, W, Ci, Co)
    y = torch.empty((B, Co, H, W), dtype=torch.bfloat16,
                    device=x_padded.device, memory_format=torch.channels_last)
    args = (x_padded.data_ptr(), wp.data_ptr(), y.data_ptr(), B, H, W, Ci, Co,
            int(relu))
    if plan.route == "wgmma":
        _cuda.launch("p2p_conv3x3_valid_wg", x_padded.device, *args,
                     plan.strip, plan.slots)
        conv3x3_valid.launches_wgmma += 1
    else:
        _cuda.launch("p2p_conv3x3_valid", x_padded.device, *args, plan.th,
                     plan.tw, plan.bn, plan.P)
    conv3x3_valid.launches += 1
    return y


conv3x3_valid.launches = 0
conv3x3_valid.launches_wgmma = 0
