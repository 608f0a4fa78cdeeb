"""Generators: GlobalTrunk, GlobalGenerator, LocalEnhancer, Encoder.

Port of pix2pixhdaudiosr_tpu/models/generator.py:22-195 and
`build_generator` (:201-225). With `fused_enh_blocks`, the LocalEnhancer's
resblocks run through ops/enhancer.py (`--fused_enhancer`); with
`int8_trunk`, the global trunk's resblocks run through ops/quant.py
(`--int8_trunk`). Either way the modules and state_dict stay the same.
Under context parallelism (a `cp` set by parallel/halo.py `set_cp`) both
take the plain path, as the JAX package's do (generator.py:44, :130).
Module names follow the flax param tree (`global.ConvIN_0`, `global.ResnetBlock_2.ConvIN_1`, `enh1_down1`,
`enh1_block0`, `enh1_up`, `enh1_final`, ...). Forward takes and returns
logical NCHW; the system feeds a channels_last view of its NHWC
spectrogram. Architecture oracle: LocalEnhancer G3L2 at ngf 48 with 2-channel
io has 156,050,690 parameters.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ..ops import enhancer, quant
from .layers import ConvIN, ConvTransposeIN, ResnetBlock, avg_pool_3s2

# The output convs (7x7 to output_nc channels) take at most OUT_ROWS rows a
# call on the card. cuDNN's deterministic engines for them need a workspace
# in proportion to the rows (48 -> 2 channels at 512 x 128 in bf16, batch
# 64, on an H100: 1.26 GiB in one call, 0.31 in blocks of 16), and
# --remat_g full runs G on those engines (system._same_convs), its
# recompute reaching this conv with every activation of G live: in blocks
# its step peaks 0.72 GiB lower (tools/remat_peak.py).
OUT_ROWS = 16


class GlobalTrunk(nn.Module):
    """GlobalGenerator without its final (reflect pad, 7x7 conv, tanh):
    c7s1 head, strided downs, resnet blocks, mirrored deconvs.

    int8_blocks: run the resblocks as ops/quant.int8_resblock_stack (int8
    convs, inference only; tensor-parallel where the blocks' `tp` is set).
    Their weights are quantized once and kept until a weight changes (a
    new tensor, dtype or device, or an in-place write such as
    load_state_dict): the result is bit-identical to quantizing on every
    call, as the JAX package does."""

    def __init__(self, input_nc: int, ngf: int = 64, n_downsampling: int = 4,
                 n_blocks: int = 9, deconv_mode: str = "same",
                 int8_blocks: bool = False, device=None):
        super().__init__()
        self.n_pre, self.n_blocks = 1 + n_downsampling, n_blocks
        self.int8_blocks = int8_blocks
        self.cp = None  # the int8 stack has no context-parallel path
        self._int8_cache = None  # (weights, their versions, quantized)
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
        layers = list(self.children())
        n_pre, n_post = self.n_pre, self.n_pre + self.n_blocks
        for layer in layers[:n_pre]:
            x = layer(x)
        if self.int8_blocks and self.cp is None and self.n_blocks > 0:
            blocks = layers[n_pre:n_post]
            x = quant.int8_resblock_stack(x, self._int8_blocks(blocks),
                                          tp=blocks[0].tp)
        else:
            for blk in layers[n_pre:n_post]:
                x = blk(x)
        for layer in layers[n_post:]:
            x = layer(x)
        return x

    @torch.no_grad()
    def _int8_blocks(self, blocks):
        """[((kq1, sw1, b1), (kq2, sw2, b2)), ...] of the resblocks. Under
        TP (the blocks' `tp`, parallel/tp.py) each ConvIN_1 weight is this
        rank's input-channel shard, quantized with the whole weight's
        scales (quantize_conv_weight's group: a MAX over the ranks), so no
        shard is quantized on its own; every rank refreshes the cache at
        the same call, its weights changing together."""
        convs = [c.Conv_0 for blk in blocks for c in (blk.ConvIN_0, blk.ConvIN_1)]
        groups = [g for blk in blocks for g in (None, blk.tp)]
        weights = [c.weight for c in convs]
        versions = [w._version for w in weights]
        cache = self._int8_cache
        # The cache keeps the storage it quantized alive, so no other tensor
        # can sit at its address: same address, dtype, device and version
        # means the same values (.to() swaps a parameter's data in place
        # and keeps its version, hence the address).
        if cache is None or versions != cache[1] or any(
                (a.data_ptr(), a.dtype, a.device) != (b.data_ptr(), b.dtype, b.device)
                for a, b in zip(weights, cache[0])):
            self._int8_cache = cache = (
                [w.detach() for w in weights], versions,
                [quant.quantize_conv_weight(w, g)
                 for w, g in zip(weights, groups)])
        q = [kq_sw + (c.bias,) for kq_sw, c in zip(cache[2], convs)]
        return list(zip(q[0::2], q[1::2]))


class GlobalGenerator(nn.Module):
    """GlobalTrunk + c7s1-output_nc + tanh."""

    def __init__(self, input_nc: int, output_nc: int, ngf: int = 64,
                 n_downsampling: int = 4, n_blocks: int = 9,
                 deconv_mode: str = "same", int8_trunk: bool = False,
                 device=None):
        super().__init__()
        self.GlobalTrunk_0 = GlobalTrunk(input_nc, ngf, n_downsampling,
                                         n_blocks, deconv_mode, int8_trunk,
                                         device=device)
        self.ConvIN_0 = ConvIN(ngf, output_nc, 7, reflect=3, norm=False,
                               act="tanh", rows=OUT_ROWS, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ConvIN_0(self.GlobalTrunk_0(x))


class LocalEnhancer(nn.Module):
    """Coarse global trunk at ngf*2^n_local on a downsampled pyramid plus
    per-level enhancer branches fused by addition. fused_enh_blocks: run
    each branch's down1 + resblocks through the fused conv + InstanceNorm
    kernel (inference only) where `enhancer.supports` admits the shape.
    int8_trunk: the global trunk's resblocks in int8 (GlobalTrunk)."""

    def __init__(self, input_nc: int, output_nc: int, ngf: int = 32,
                 n_downsample_global: int = 4, n_blocks_global: int = 9,
                 n_local_enhancers: int = 1, n_blocks_local: int = 3,
                 deconv_mode: str = "same", fused_enh_blocks: bool = False,
                 int8_trunk: bool = False, device=None):
        super().__init__()
        self.n_local_enhancers = nle = n_local_enhancers
        self.n_blocks_local = n_blocks_local
        self.fused_enh_blocks = fused_enh_blocks
        self.cp = None  # the pyramid's pool; the fused section has no cp path
        self.add_module("global", GlobalTrunk(
            input_nc, ngf * 2 ** nle, n_downsample_global, n_blocks_global,
            deconv_mode, int8_trunk, device=device))
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
                    rows=OUT_ROWS, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        nle = self.n_local_enhancers
        pyramid = [x]
        for _ in range(nle):
            pyramid.append(avg_pool_3s2(pyramid[-1], self.cp))
        out = getattr(self, "global")(pyramid[-1])
        for n in range(1, nle + 1):
            down = getattr(self, f"enh{n}_down0")(pyramid[nle - n])
            if self._fused(n, down):
                h = self._fused_section(n, down, out)
            else:
                h = getattr(self, f"enh{n}_down1")(down) + out
                for i in range(self.n_blocks_local):
                    h = getattr(self, f"enh{n}_block{i}")(h)
            h = getattr(self, f"enh{n}_up")(h)
            if n == nle:
                h = getattr(self, f"enh{n}_final")(h)
            out = h
        return out

    def _fused(self, n: int, down: torch.Tensor) -> bool:
        """The JAX gate (generator.py:130-135), on the shape down1 gives."""
        B, _, H, W = down.shape
        ch = getattr(self, f"enh{n}_down1").Conv_0.out_channels
        return (self.fused_enh_blocks and self.cp is None
                and self.n_blocks_local > 0
                and enhancer.supports((B, (H + 1) // 2, (W + 1) // 2, ch),
                                      down.dtype))

    def _fused_section(self, n: int, down: torch.Tensor,
                       out: torch.Tensor) -> torch.Tensor:
        """down1 conv without its InstanceNorm, then the fused section."""
        d1 = getattr(self, f"enh{n}_down1").Conv_0
        d_raw = enhancer.conv_s2_raw(down, d1.weight, d1.bias)
        blocks = []
        for i in range(self.n_blocks_local):
            blk = getattr(self, f"enh{n}_block{i}")
            blocks.append(tuple((c.Conv_0.weight, c.Conv_0.bias)
                                for c in (blk.ConvIN_0, blk.ConvIN_1)))
        return enhancer.fused_enhancer_section(d_raw, out, blocks)


class Encoder(nn.Module):
    """The feature encoder (netE): a 7x7 ConvIN head, n_downsampling
    stride-2 ConvIN, as many ConvTransposeIN (the JAX default "same"
    deconv), and a 7x7 conv with tanh; then, given instance ids, the
    instance-wise average pooling of the JAX module: each pixel takes the
    mean of the output over the pixels of its id, for ids in
    [0, max_ids); an id outside that range joins no region and pools to 0,
    and a region's count is floored at 1. The pooling is the JAX one-hot
    einsums, the one-hot in the output's dtype (the compute dtype under
    autocast), so its sums, counts and means round as flax's do."""

    def __init__(self, input_nc: int, output_nc: int, ngf: int = 32,
                 n_downsampling: int = 4, max_ids: int = 64, device=None):
        super().__init__()
        self.max_ids = max_ids
        self.add_module("ConvIN_0", ConvIN(input_nc, ngf, 7, reflect=3,
                                           device=device))
        for i in range(n_downsampling):
            self.add_module(f"ConvIN_{i + 1}", ConvIN(
                ngf * 2 ** i, ngf * 2 ** (i + 1), 3, stride=2, pad=1,
                device=device))
        for i in range(n_downsampling):
            mult = 2 ** (n_downsampling - i)
            self.add_module(f"ConvTransposeIN_{i}", ConvTransposeIN(
                ngf * mult, ngf * mult // 2, device=device))
        self.add_module(f"ConvIN_{n_downsampling + 1}", ConvIN(
            ngf, output_nc, 7, reflect=3, norm=False, act="tanh",
            rows=OUT_ROWS, device=device))

    def forward(self, x: torch.Tensor,
                inst: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: [B, C, H, W]; inst: [B, H, W] integer ids, or None for the
        encoder output unpooled. Returns [B, output_nc, H, W]."""
        h = x
        for layer in self.children():
            h = layer(h)
        if inst is None:
            return h
        ids = inst.to(torch.int64)
        oh = (ids[..., None] == torch.arange(
            self.max_ids, device=ids.device)).to(h.dtype)  # [B, H, W, K]
        sums = torch.einsum("bhwk,bchw->bkc", oh, h).to(h.dtype)
        # autocast sums in f32 on CUDA; flax's counts are in h's dtype
        counts = torch.clamp(oh.sum(dim=(1, 2)).to(h.dtype), min=1.0)
        means = sums / counts[..., None]                     # [B, K, C]
        return torch.einsum("bhwk,bkc->bhwc", oh, means).permute(0, 3, 1, 2)


def build_generator(net_g: str, input_nc: int, output_nc: int, ngf: int,
                    n_downsample_global: int, n_blocks_global: int,
                    n_local_enhancers: int, n_blocks_local: int,
                    deconv_mode: str = "same", fused_enh_blocks: bool = False,
                    int8_trunk: bool = False, device=None) -> nn.Module:
    """define_G parity. Parameters are left as torch initialises them (or
    unallocated on device="meta"): load a state_dict or call `init_normal_`.
    fused_enh_blocks applies to the LocalEnhancer (`--fused_enhancer`),
    int8_trunk to the global trunk of either generator (`--int8_trunk`)."""
    if net_g == "global":
        return GlobalGenerator(input_nc, output_nc, ngf, n_downsample_global,
                               n_blocks_global, deconv_mode, int8_trunk,
                               device=device)
    if net_g == "local":
        return LocalEnhancer(input_nc, output_nc, ngf, n_downsample_global,
                             n_blocks_global, n_local_enhancers,
                             n_blocks_local, deconv_mode,
                             fused_enh_blocks=fused_enh_blocks,
                             int8_trunk=int8_trunk, device=device)
    if net_g == "encoder":
        return Encoder(input_nc, output_nc, ngf, n_downsample_global,
                       device=device)
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
