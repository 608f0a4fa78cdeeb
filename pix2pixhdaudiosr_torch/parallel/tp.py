"""Megatron tensor parallelism of the generator's resblocks: the
counterpart of `shard_generator_params` and `make_tp_resblock_stack`
(pix2pixhdaudiosr_tpu/parallel/tp.py:80-152).

Every ResnetBlock (`ResnetBlock_i` of a trunk, `enhN_blockM` of the
enhancer; the regex of the JAX package's `is_block`) is split over the
channels of its inner activation. Rank r of N keeps
  ConvIN_0's weight and bias, output channels [r C/N, (r+1) C/N)
      (column-parallel), and
  ConvIN_1's weight, the same input channels (row-parallel);
ConvIN_1's bias and every other tensor are whole on every rank. In the
forward (models/layers.py ResnetBlock, its `tp` path) the InstanceNorm +
ReLU after the first conv is local (B3 on the shard's C/N channels), the
second conv's partial sums are all-reduced (SUM), its bias is added after
the reduction, and the second InstanceNorm and the residual add run whole
on every rank: one all-reduce a block. With the int8 trunk
(`--int8_trunk`, ops/quant.int8_resblock_stack) the trunk's blocks split
the same way: the second conv's activation scale and weight scales are
MAXes over the group (the whole tensor's) and its int32 accumulators are
summed over it: two all-reduces a block a forward (the weight scales'
once a weight), each block's output the
one-rank int8 block's bit for bit; each rank's channel count must then be
a multiple of 8.
"""

from __future__ import annotations

import re
from typing import List, Optional

import torch
import torch.nn as nn

from .mesh import Group

_BLOCK = re.compile(r"ResnetBlock_\d+|enh\d+_block\d+")


def is_block(name: str) -> bool:
    """A module name (its last component) that TP splits."""
    return _BLOCK.fullmatch(name) is not None


def split_dim(name: str) -> Optional[int]:
    """The dim of parameter `name` (a state_dict key of the generator,
    weights OIHW) that TP splits over the group, or None where every rank
    keeps it whole: 0 for a block's ConvIN_0 weight and bias (output
    channels), 1 for its ConvIN_1 weight (input channels)."""
    parts = name.split(".")
    for i, part in enumerate(parts[:-3]):
        if is_block(part) and parts[i + 2] == "Conv_0":
            conv, leaf = parts[i + 1], parts[-1]
            if conv == "ConvIN_0" and leaf in ("weight", "bias"):
                return 0
            if conv == "ConvIN_1" and leaf == "weight":
                return 1
    return None


def shard_generator(net: nn.Module, group: Group,
                    replicate_enhancer: bool = False) -> List[str]:
    """Keep this rank's shard of every resblock tensor that TP splits (in
    place: each becomes a new Parameter holding its slice, in the layout
    of the whole one) and set the block's `tp` to `group`; returns the
    blocks' names. With `replicate_enhancer` the enhancer's blocks stay
    whole (the fused enhancer section takes whole weights). Channels must
    divide by the group's size, and in an int8 trunk into multiples of 8
    (ValueError)."""
    r, n = group.rank, group.size
    sharded = []
    for name, block in net.named_modules():
        if not is_block(name.rsplit(".", 1)[-1]) or (
                replicate_enhancer and name.startswith("enh")):
            continue
        parent = net.get_submodule(name.rsplit(".", 1)[0]) if "." in name \
            else net
        int8 = getattr(parent, "int8_blocks", False)
        for key, p in list(block.named_parameters()):
            d = split_dim(f"{name}.{key}")
            if d is None:
                continue
            if p.shape[d] % n:
                raise ValueError(f"--tp_shards {n}: {name}.{key} has "
                                 f"{p.shape[d]} channels, not a multiple")
            if int8 and (p.shape[d] // n) % 8:
                raise ValueError(f"--tp_shards {n} with --int8_trunk: "
                                 f"{name}.{key} has {p.shape[d]} channels, "
                                 f"{p.shape[d] // n} a rank, not a multiple "
                                 f"of 8 (the int8 product's)")
            fmt = (torch.channels_last if p.dim() == 4 and p.is_contiguous(
                memory_format=torch.channels_last) else torch.contiguous_format)
            piece = p.detach().chunk(n, d)[r].clone(memory_format=fmt)
            owner = block.get_submodule(key.rsplit(".", 1)[0])
            setattr(owner, key.rsplit(".", 1)[1],
                    nn.Parameter(piece, requires_grad=p.requires_grad))
        block.tp = group
        sharded.append(name)
    return sharded
