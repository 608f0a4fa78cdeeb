"""Generator checkpoints as per-net torch state_dicts.

The reference's naming (pix2pixHD models/base_model.py): the generator of
tag `<which_epoch>` lives at `<load_pretrain or expr_dir>/<which_epoch>_net_G.pth`.
Keys follow models/generator.py (the flax tree's names); a JAX checkpoint
is converted with tools/export_torch_generator.py.
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
