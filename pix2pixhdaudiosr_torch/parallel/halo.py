"""Frame-axis context parallelism by halo exchange: the counterpart of
pix2pixhdaudiosr_tpu/parallel/halo.py.

The generator is fully convolutional over [freq, frames], so a long file
is one spectrogram whose frame axis is split over a group of ranks. Every
layer exchanges its own kernel-radius halo with its neighbours and
reproduces the global padding at the two ends of the axis (models/layers.py,
the `cp` paths), so each rank's block stays aligned with its slice of the
unsharded activation at every layer; InstanceNorm averages its moments over
the group (B3's moments and apply entries around an all-reduce). The
sharded forward equals the unsharded full-length one to float rounding,
with none of the seams of the reference's independent chunks.

Layout: the port's modules take NCHW, so the frame axis is dim 3 (the JAX
package's NHWC axis 2).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .mesh import Group


def halo_exchange(x: torch.Tensor, halo: int, group: Group,
                  dim: int = -1) -> torch.Tensor:
    """Pad a block of an axis split over `group` with `halo` entries from
    each neighbour along `dim` (zeros at the global ends), as
    pix2pixhdaudiosr_tpu/parallel/halo.py:halo_exchange does with
    ppermute."""
    n = x.shape[dim]
    left, right = x.narrow(dim, 0, halo), x.narrow(dim, n - halo, halo)
    from_left, from_right = group.exchange(left, right)
    if from_left is None:
        from_left = torch.zeros_like(right)
    if from_right is None:
        from_right = torch.zeros_like(left)
    return torch.cat([from_left, x, from_right], dim=dim)


def cp_pad_w(x: torch.Tensor, radius: int, group: Group,
             mode: str = "zeros") -> torch.Tensor:
    """Pad the frame axis (dim 3) of a block x [B, C, H, W] by `radius`
    with the neighbours' edge frames; at the global ends with zeros, or in
    "reflect" mode with the block's own reflection, the edge frame left out
    (torch's ReflectionPad2d). Port of pix2pixhdaudiosr_tpu/models/
    layers.py:cp_pad_w."""
    if radius == 0:
        return x
    if mode == "zeros":
        return halo_exchange(x, radius, group)
    from_left, from_right = group.exchange(x[..., :radius], x[..., -radius:])
    if from_left is None:
        from_left = x[..., 1:radius + 1].flip(-1)
    if from_right is None:
        from_right = x[..., -radius - 1:-1].flip(-1)
    return torch.cat([from_left, x, from_right], dim=-1)


def generator_receptive_halo(n_downsample_global: int, n_blocks_global: int,
                             n_local_enhancers: int = 0,
                             n_blocks_local: int = 0) -> int:
    """Upper bound on the generator's half receptive field in input frames,
    rounded up to the total stride so downsampling grids align across
    shards (copied from pix2pixhdaudiosr_tpu/parallel/halo.py:48-64)."""
    stride = 2 ** n_downsample_global
    rf = 3  # c7s1
    for i in range(n_downsample_global):
        rf += 2 ** i  # 3x3 stride-2 conv at scale 2^i
    rf += n_blocks_global * 2 * stride  # resblock 3x3 convs at the bottleneck
    for i in range(n_downsample_global):
        rf += 2 ** (n_downsample_global - 1 - i)  # transposed convs
    rf += 3
    if n_local_enhancers:
        rf = 2 * rf + 3 + 2 + n_blocks_local * 2 * 2 + 2 + 3
    total_stride = stride * (2 ** n_local_enhancers)
    return int(np.ceil(rf / total_stride) * total_stride)


def set_cp(net: torch.nn.Module, group) -> torch.nn.Module:
    """Split the frame axis of every layer of `net` over `group` (None:
    the plain forward again): sets the `cp` attribute each layer with a
    context-parallel path carries. Names and parameters stay as they are."""
    for m in net.modules():
        if hasattr(m, "cp"):
            m.cp = group
    return net


def cp_block(spec: torch.Tensor, group: Group,
             batch_group: Optional[Group] = None) -> torch.Tensor:
    """This rank's block of a global spectrogram [B, F, T, C] (NHWC): its
    T / n frames of the split over `group` and, with a `batch_group`, its
    B / dp rows of the split over that (dp x cp serving), contiguous."""
    per = spec.shape[2] // group.size
    x = spec[:, :, group.rank * per:(group.rank + 1) * per]
    if batch_group is not None:
        rows = spec.shape[0] // batch_group.size
        x = x[batch_group.rank * rows:(batch_group.rank + 1) * rows]
    return x.contiguous()


def cp_gather(block: torch.Tensor, group: Group,
              batch_group: Optional[Group] = None) -> Optional[torch.Tensor]:
    """The inverse of cp_block, on the first rank of both groups (world
    rank 0 of the serving mesh): each data row's blocks gathered on the
    row's first rank along the frames, then, with a `batch_group`, the rows
    gathered on its first rank along the batch, in (data, cp) order (each
    step Group.gather_to_first). None on every other rank."""
    parts = group.gather_to_first(block)
    if parts is None:
        return None
    row = torch.cat(parts, dim=2)
    if batch_group is None:
        return row
    rows = batch_group.gather_to_first(row)
    return None if rows is None else torch.cat(rows, dim=0)


def make_cp_generator(system, group: Group,
                      batch_group: Optional[Group] = None) -> Callable:
    """A forward of the system's generator over a block [B, F, T_local, C]
    (NHWC) of a spectrogram whose frame axis is split over `group`,
    returning the block of the output in f32; T_local must be a multiple of
    the generator's total stride. The generator is built anew with every
    layer's `cp` set and shares the system's parameters (the same tensors,
    names and dtype), as the JAX package rebuilds its module with cp_axis
    and the same param tree; the fused enhancer and the int8 trunk, which
    have no context-parallel path, are not in it.

    batch_group: the ranks over which the batch is split too (dp x cp
    serving on a 2-D mesh, parallel.mesh.make_serving_layout), the
    counterpart of the JAX package's `batch_axis`
    (pix2pixhdaudiosr_tpu/parallel/halo.py:67-99). The forward is per
    sample, so it runs as it is on a block [B / dp, F, T / cp, C]; only the
    blocks change (cp_block, cp_gather: generate.cp_forward takes the
    groups from the forward's `.group` and `.batch_group`), and every
    collective of the layers stays inside `group`, this rank's data row."""
    from ..models.generator import build_generator
    from ..system import share_parameters

    cfg = system.cfg
    net = build_generator(cfg.net_g, system.g_input_nc, cfg.output_nc,
                          cfg.ngf, cfg.n_downsample_global,
                          cfg.n_blocks_global, cfg.n_local_enhancers,
                          cfg.n_blocks_local,
                          deconv_mode="torch" if cfg.torch_deconv else "same",
                          device="meta")
    share_parameters(net, system.netG)
    set_cp(net, group).eval()

    @torch.no_grad()
    def forward(x_local: torch.Tensor) -> torch.Tensor:
        x = x_local.to(system.dtype).permute(0, 3, 1, 2)
        return net(x).permute(0, 2, 3, 1).float()

    forward.net = net
    forward.group, forward.batch_group = group, batch_group
    return forward
