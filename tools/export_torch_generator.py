#!/usr/bin/env python
"""Export a JAX (Orbax) checkpoint's generator for the PyTorch port.

Restores `<load_pretrain or checkpoints_dir/name>/<which_epoch>_state` with
the JAX package's CheckpointManager, converts its generator params with
pix2pixhdaudiosr_torch/convert.py, checks them against the port's
generator for the given model flags, and writes `<which_epoch>_net_G.pth`
beside the checkpoint (or into --out), where
`python -m pix2pixhdaudiosr_torch.generate --load_pretrain <that dir>`
finds it:

  python tools/export_torch_generator.py --name run --checkpoints_dir ck \\
      <the same model flags as training> [--out DIR]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None) -> str:
    from pix2pixhdaudiosr_tpu.config import parse_config
    from pix2pixhdaudiosr_tpu.utils.checkpoint import CheckpointManager

    from pix2pixhdaudiosr_torch.convert import jax_to_torch_generator
    from pix2pixhdaudiosr_torch.models.generator import build_generator
    from pix2pixhdaudiosr_torch.system import g_input_nc
    from pix2pixhdaudiosr_torch.utils.checkpoint import save_generator

    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--out", default=None,
                    help="directory for <which_epoch>_net_G.pth "
                         "(default: the checkpoint's own directory)")
    args, rest = ap.parse_known_args(argv)
    cfg = parse_config(rest, is_train=False, save=False)
    src = cfg.load_pretrain or cfg.expr_dir
    saved = CheckpointManager(src).restore(cfg.which_epoch)
    state_dict = jax_to_torch_generator(saved["params"]["G"])

    net = build_generator(
        cfg.net_g, g_input_nc(cfg), cfg.output_nc, cfg.ngf,
        cfg.n_downsample_global, cfg.n_blocks_global, cfg.n_local_enhancers,
        cfg.n_blocks_local,
        deconv_mode="torch" if cfg.torch_deconv else "same",
        device="meta").to_empty(device="cpu")
    net.load_state_dict(state_dict)  # strict: names and shapes must match
    path = save_generator(net, os.path.join(args.out or src,
                                            f"{cfg.which_epoch}_net_G.pth"))
    print(f"exported {src}/{cfg.which_epoch}_state -> {path}")
    return path


if __name__ == "__main__":
    main()
