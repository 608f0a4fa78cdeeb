#!/usr/bin/env python
"""Import a reference (pix2pixHD torch) checkpoint into the port: the twin
of tools/import_torch_checkpoint.py, with no JAX.

The reference saves `latest_net_G.pth` state_dicts whose keys follow its
Sequential layouts (trunk `model.<i>`, enhancer `model<n>_1` /
`model<n>_2`, resblocks `...conv_block.{1,5}`; InstanceNorm is
affine=False, so only conv weights and biases exist). The port's modules
are named after the flax tree (models/generator.py, convert.py) and
already store torch layouts: a conv stays OIHW, and the deconv weight of
`--torch_deconv` is the reference's [ci, co, kh, kw]. So the conversion
renames keys, by the JAX tool's walk, and passes every tensor through as
f32 (which the JAX tool followed by convert.jax_to_torch_generator gives
bit for bit).

CLI: write what the port's CLIs read, from a .pth file:

  python tools/import_torch_checkpoint_torch.py --pth latest_net_G.pth \\
      [--pth_d latest_net_D.pth] --name imported <the model flags>

`<checkpoints_dir>/<name>/latest_net_G.pth` is served by
`python generate_audio_torch.py --torch_deconv --load_pretrain
<checkpoints_dir>/<name> ...`; with --pth_d the directory also holds a
train state (D and two fresh Adams) that `python train_torch.py
--load_pretrain <dir> ...` warm-starts from.
"""

from __future__ import annotations

import os
import sys
from typing import Dict

import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

StateDict = Dict[str, torch.Tensor]


def _take(sd, key: str, out: StateDict, name: str) -> None:
    """The reference's `key`.weight / .bias as `name`.weight / .bias."""
    for leaf in ("weight", "bias"):
        out[f"{name}.{leaf}"] = torch.as_tensor(sd[f"{key}.{leaf}"]).float()


def _convin(sd, key: str, out: StateDict, name: str,
            deconv: bool = False) -> None:
    _take(sd, key, out, f"{name}.{'ConvTranspose_0' if deconv else 'Conv_0'}")


def _trunk(sd, prefix: str, n_down: int, n_blocks: int, out: StateDict,
           name: str) -> int:
    """`model.<i>` Sequential of the trunk (head, downs, resblocks,
    deconvs), as the JAX tool's `_trunk` walks it, into `out` under
    `name`; returns the index of the final pad."""
    _convin(sd, f"{prefix}.1", out, f"{name}ConvIN_0")
    for i in range(n_down):
        _convin(sd, f"{prefix}.{4 + 3 * i}", out, f"{name}ConvIN_{i + 1}")
    base_rb = 4 + 3 * n_down
    for i in range(n_blocks):
        for j, k in ((0, 1), (1, 5)):
            _convin(sd, f"{prefix}.{base_rb + i}.conv_block.{k}", out,
                    f"{name}ResnetBlock_{i}.ConvIN_{j}")
    base_up = base_rb + n_blocks
    for i in range(n_down):
        _convin(sd, f"{prefix}.{base_up + 3 * i}", out,
                f"{name}ConvTransposeIN_{i}", deconv=True)
    return base_up + 3 * n_down


def convert_generator_state_dict(sd, net_g: str, n_downsample_global: int,
                                 n_blocks_global: int,
                                 n_local_enhancers: int = 1,
                                 n_blocks_local: int = 3) -> StateDict:
    """Reference G state_dict -> the port's generator state_dict
    (models/generator.build_generator with deconv_mode "torch")."""
    out: StateDict = {}
    if net_g == "global":
        final_pad = _trunk(sd, "model", n_downsample_global, n_blocks_global,
                           out, "GlobalTrunk_0.")
        _convin(sd, f"model.{final_pad + 1}", out, "ConvIN_0")
        return out
    if net_g != "local":
        raise ValueError(f"unsupported netG for import: {net_g}")
    _trunk(sd, "model", n_downsample_global, n_blocks_global, out, "global.")
    nle = n_local_enhancers
    for n in range(1, nle + 1):
        _convin(sd, f"model{n}_1.1", out, f"enh{n}_down0")
        _convin(sd, f"model{n}_1.4", out, f"enh{n}_down1")
        for i in range(n_blocks_local):
            for j, k in ((0, 1), (1, 5)):
                _convin(sd, f"model{n}_2.{i}.conv_block.{k}", out,
                        f"enh{n}_block{i}.ConvIN_{j}")
        _convin(sd, f"model{n}_2.{n_blocks_local}", out, f"enh{n}_up",
                deconv=True)
        if n == nle:
            _convin(sd, f"model{n}_2.{n_blocks_local + 4}", out,
                    f"enh{n}_final")
    return out


def convert_discriminator_state_dict(sd, n_layers: int = 3, num_d: int = 2,
                                     get_interm_feat: bool = True
                                     ) -> StateDict:
    """Reference MultiscaleDiscriminator state_dict -> the port's
    (models/discriminator.py): `scale{i}_layer{j}.0` keys with
    getIntermFeat (the training default), or flat `layer{i}.<seq idx>`
    Sequentials, convs at stream index 0 then 3j-1."""
    out: StateDict = {}
    for i in range(num_d):
        for j in range(n_layers + 2):
            key = (f"scale{i}_layer{j}.0" if get_interm_feat
                   else f"layer{i}.{0 if j == 0 else 3 * j - 1}")
            _convin(sd, key, out, f"scale{i}.ConvIN_{j}")
    return out


def check_against(what: str, got: StateDict, want: StateDict) -> None:
    """Raise SystemExit naming every key missing, unexpected or of another
    shape in `got` against the port's `want`."""
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    shapes = {k: (tuple(got[k].shape), tuple(want[k].shape))
              for k in sorted(set(got) & set(want))
              if got[k].shape != want[k].shape}
    if missing or extra or shapes:
        raise SystemExit(f"converted {what} does not match the port's net: "
                         f"missing {missing}, unexpected {extra}, shapes "
                         f"(got, want) {shapes}")


def _convert(what: str, convert, sd, *args) -> StateDict:
    """`convert(sd, *args)`; a missing reference key or one the walk left
    unused raises SystemExit naming it (the model flags differ from the
    run that saved the checkpoint)."""
    try:
        out = convert(sd, *args)
    except KeyError as e:
        raise SystemExit(f"{what} checkpoint has no {e.args[0]!r}: do the "
                         f"model flags match the run that saved it?")
    used = {k.rsplit(".", 1)[0] for k in sd}
    walked = {k.rsplit(".", 1)[0] for k in out}
    if len(used) != len(walked):
        raise SystemExit(f"{what} checkpoint holds {len(used)} layers, the "
                         f"model flags {len(walked)}: do they match the run "
                         f"that saved it?")
    return out


def main(argv=None) -> str:
    import argparse

    from pix2pixhdaudiosr_torch.config import parse_config
    from pix2pixhdaudiosr_torch.models.discriminator import \
        build_discriminator
    from pix2pixhdaudiosr_torch.models.generator import build_generator
    from pix2pixhdaudiosr_torch.system import (Pix2PixHDSystem, g_input_nc,
                                               spectro_channels)
    from pix2pixhdaudiosr_torch.trainer import init_state
    from pix2pixhdaudiosr_torch.utils.checkpoint import save_train_state

    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--pth", required=True, help="latest_net_G.pth path")
    ap.add_argument("--pth_d", default=None,
                    help="optional latest_net_D.pth (to continue training)")
    args, rest = ap.parse_known_args(argv)

    cfg = parse_config(rest, is_train=True)
    if not cfg.torch_deconv:
        # the imported deconvs require torch ConvTranspose2d semantics
        # (models/layers.ConvTransposeIN mode "torch")
        cfg = cfg.replace(torch_deconv=True)
        print("note: enabling --torch_deconv (required when serving this "
              "checkpoint; pass it to generate_audio_torch/eval_matric_torch)")
    sd = torch.load(args.pth, map_location="cpu", weights_only=True)
    g = _convert("G", convert_generator_state_dict, sd, cfg.net_g,
                 cfg.n_downsample_global, cfg.n_blocks_global,
                 cfg.n_local_enhancers, cfg.n_blocks_local)
    net_g = build_generator(
        cfg.net_g, g_input_nc(cfg), cfg.output_nc, cfg.ngf,
        cfg.n_downsample_global, cfg.n_blocks_global, cfg.n_local_enhancers,
        cfg.n_blocks_local, deconv_mode="torch", device="meta")
    check_against("G", g, net_g.state_dict())
    os.makedirs(cfg.expr_dir, exist_ok=True)
    path = os.path.join(cfg.expr_dir, "latest_net_G.pth")
    if args.pth_d:
        sd_d = torch.load(args.pth_d, map_location="cpu", weights_only=True)
        c = spectro_channels(cfg)
        d = _convert("D", convert_discriminator_state_dict, sd_d,
                     cfg.n_layers_d, cfg.num_d, not cfg.no_gan_feat_loss)
        check_against("D", d, build_discriminator(
            2 * c + (0 if cfg.no_instance else 1), cfg.ndf, cfg.n_layers_d,
            use_sigmoid=cfg.no_lsgan, num_d=cfg.num_d,
            get_interm_feat=not cfg.no_gan_feat_loss,
            device="meta").state_dict())
        state = init_state(Pix2PixHDSystem(cfg, device="cpu"), cfg.seed)
        state.system.netG_train.load_state_dict(g)
        state.system.netD.load_state_dict(d)
        save_train_state(state, cfg.expr_dir, "latest")
    else:
        torch.save(g, path)
    print(f"imported {args.pth} -> {path} (load with --load_pretrain "
          f"{cfg.expr_dir})")
    return path


if __name__ == "__main__":
    main()
