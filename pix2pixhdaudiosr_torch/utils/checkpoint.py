"""Checkpoints as per-net torch state_dicts, with `latest` / epoch tags.

The reference's naming (pix2pixHD models/base_model.py): the generator of
tag `<which_epoch>` lives at `<load_pretrain or expr_dir>/<which_epoch>_net_G.pth`.
Keys follow models/generator.py (the flax tree's names); a JAX checkpoint
is converted with tools/export_torch_generator.py. A training run saves,
per tag, `<tag>_net_G.pth` (what generate loads), `<tag>_net_D.pth` and
`<tag>_optim.pth` (both Adams' state_dicts and the step count), and the
resume cursor `iter.txt` ("epoch,epoch_iter"), as
pix2pixhdaudiosr_tpu/utils/checkpoint.py:76-122 keeps its tags. Resuming
(--continue_train) comes with ROADMAP A8.
"""

from __future__ import annotations

import os

import torch
import torch.nn as nn


def generator_path(cfg) -> str:
    base = cfg.load_pretrain or cfg.expr_dir
    return os.path.join(base, f"{cfg.which_epoch}_net_G.pth")


def save_generator(net: nn.Module, path: str) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in net.state_dict().items()}, path)
    return path


def load_generator(net: nn.Module, cfg) -> nn.Module:
    """Load the generator of cfg's tag into `net` (every key must match)."""
    path = generator_path(cfg)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no generator checkpoint at {path}")
    state = torch.load(path, map_location="cpu", weights_only=True)
    net.load_state_dict(state)
    return net


def save_train_state(state, expr_dir: str, tag: str = "latest") -> str:
    """Write tag's net_G and net_D files (state_dicts on the CPU) and optim
    file (both Adams' state_dicts as they are, and the step) of a
    trainer.TrainState into expr_dir; returns the net_G path."""
    system = state.system
    save_generator(system.netD, os.path.join(expr_dir, f"{tag}_net_D.pth"))
    torch.save({"G": state.opt_g.state_dict(), "D": state.opt_d.state_dict(),
                "step": state.step},
               os.path.join(expr_dir, f"{tag}_optim.pth"))
    return save_generator(system.netG_train,
                          os.path.join(expr_dir, f"{tag}_net_G.pth"))


def save_iter(expr_dir: str, epoch: int, epoch_iter: int) -> None:
    with open(os.path.join(expr_dir, "iter.txt"), "w") as f:
        f.write(f"{epoch},{epoch_iter}\n")
