"""Checkpoints as per-net torch state_dicts, with `latest` / epoch tags.

The reference's naming (pix2pixHD models/base_model.py): the generator of
tag `<which_epoch>` lives at `<load_pretrain or expr_dir>/<which_epoch>_net_G.pth`.
Keys follow models/generator.py (the flax tree's names); a JAX checkpoint
is converted with tools/export_torch_generator.py. A training run saves,
per tag, `<tag>_net_G.pth` (what generate loads), `<tag>_net_D.pth`, with
the optional discriminators `<tag>_net_time_D.pth` and
`<tag>_net_hifigan_D.pth`, with the feature encoder `<tag>_net_E.pth`, and
`<tag>_optim.pth` (both Adams' state by parameter name, the G Adam's for
netE too, the D Adam's for every discriminator, their learning rates and
the step count; --adam_mu_bf16's first moments stay bf16), all on the
CPU, and the resume cursor
`iter.txt` ("epoch,epoch_iter"), as
pix2pixhdaudiosr_tpu/utils/checkpoint.py:76-122 keeps its tags.
`load_train_state` merges a tag back as that module's `merge_matching`
(:26-72) does: every saved leaf whose name exists in the target with the
same shape is taken, every other target leaf is kept, and a moment takes
the target optimizer's dtype (the JAX merge casts to the target's).
"""

from __future__ import annotations

import os
from typing import Dict, Set, Tuple

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


def _g_params(system) -> Dict[str, nn.Parameter]:
    """The G optimizer's parameters by name: netG_train's by their own
    names, netE's under "E."."""
    return {(n if key == "G" else f"{key}.{n}"): p
            for key, net in system.g_nets().items()
            for n, p in net.named_parameters()}


def _d_params(system) -> Dict[str, nn.Parameter]:
    """The D optimizer's parameters by name: netD's by their own names (as
    optim files of runs without the optional nets hold them), time_D's and
    hifigan_D's under "time_D." and "hifigan_D."."""
    return {(n if key == "D" else f"{key}.{n}"): p
            for key, net in system.d_nets().items()
            for n, p in net.named_parameters()}


def _param_names(opt: torch.optim.Optimizer, named: Dict[str, nn.Parameter]):
    """The name in `named` of each parameter `opt` steps, in its order."""
    names = {id(p): n for n, p in named.items()}
    return [names[id(p)] for group in opt.param_groups for p in group["params"]]


def _named_adam(opt: torch.optim.Optimizer, named: Dict[str, nn.Parameter]) -> Dict:
    """An Adam's per-parameter state keyed by parameter name, on the CPU."""
    sd = opt.state_dict()
    names = _param_names(opt, named)
    return {"state": {names[i]: {k: v.detach().cpu() if torch.is_tensor(v)
                                 else v for k, v in s.items()}
                      for i, s in sd["state"].items()},
            "lr": opt.param_groups[0]["lr"]}


def save_train_state(state, expr_dir: str, tag: str = "latest") -> str:
    """Write tag's net_G file, a net_<key> file for each discriminator
    (state_dicts) and optim file (both Adams' state by parameter name,
    their learning rates, and the step) of a trainer.TrainState into
    expr_dir, every tensor on the CPU; returns the net_G path."""
    system = state.system
    for key, net in (*system.d_nets().items(), ("E", system.netE)):
        if net is not None:
            save_generator(net, os.path.join(expr_dir, f"{tag}_net_{key}.pth"))
    torch.save({"G": _named_adam(state.opt_g, _g_params(system)),
                "D": _named_adam(state.opt_d, _d_params(system)),
                "step": state.step},
               os.path.join(expr_dir, f"{tag}_optim.pth"))
    return save_generator(system.netG_train,
                          os.path.join(expr_dir, f"{tag}_net_G.pth"))


def _load(path: str):
    return torch.load(path, map_location="cpu", weights_only=True)


@torch.no_grad()
def _merge_net(net: nn.Module, saved: Dict[str, torch.Tensor]) -> Set[str]:
    loaded = set()
    for name, t in net.state_dict().items():
        if name in saved and saved[name].shape == t.shape:
            t.copy_(saved[name])
            loaded.add(name)
    return loaded


def _merge_adam(opt: torch.optim.Optimizer, named: Dict[str, nn.Parameter],
                saved: Dict) -> Set[str]:
    names = _param_names(opt, named)
    params = [p for group in opt.param_groups for p in group["params"]]
    sd = opt.state_dict()
    loaded = set()
    for i, (name, p) in enumerate(zip(names, params)):
        s = saved["state"].get(name)
        if s is not None and all(v.shape == p.shape for k, v in s.items()
                                 if k != "step"):
            sd["state"][i] = s
            loaded.add(name)
    for group in sd["param_groups"]:
        group["lr"] = saved["lr"]
    opt.load_state_dict(sd)  # moves the moments to each parameter's device
    return loaded


def has(tag: str, expr_dir: str) -> bool:
    """Whether expr_dir holds tag's generator (`<tag>_net_G.pth`)."""
    return os.path.exists(os.path.join(expr_dir, f"{tag}_net_G.pth"))


def load_train_state(state, tag: str, expr_dir: str) -> Set[str]:
    """Merge tag's files in expr_dir into a trainer.TrainState in place:
    every saved tensor whose name exists in the target with the same shape
    (G's, netE's and each discriminator's weights; Adam moments, by
    parameter name), the learning rates and the step where the optim file
    exists. A missing net_<D>, net_E or optim file leaves that part as it
    is; a missing net_G raises FileNotFoundError. Returns the names loaded,
    as the JAX package's tree keys: "G.<param>", "E.<param>", "D.<param>",
    "time_D.<param>", "hifigan_D.<param>", "opt_g.<name>" (the G Adam's
    names of _g_params), "opt_d.<name>" (the D Adam's names of _d_params)
    and "step"."""
    system = state.system
    path = os.path.join(expr_dir, f"{tag}_net_G.pth")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no generator checkpoint at {path}")
    loaded = {f"G.{n}" for n in _merge_net(system.netG_train, _load(path))}
    nets = dict(system.d_nets())
    if system.netE is not None:
        nets["E"] = system.netE
    for key, net in nets.items():
        path = os.path.join(expr_dir, f"{tag}_net_{key}.pth")
        if os.path.exists(path):
            loaded |= {f"{key}.{n}" for n in _merge_net(net, _load(path))}
    path = os.path.join(expr_dir, f"{tag}_optim.pth")
    if os.path.exists(path):
        saved = _load(path)
        for key, opt, named in (
                ("G", state.opt_g, _g_params(system)),
                ("D", state.opt_d, _d_params(system))):
            loaded |= {f"opt_{key.lower()}.{n}"
                       for n in _merge_adam(opt, named, saved[key])}
        state.step = int(saved["step"])
        loaded.add("step")
    return loaded


def save_iter(expr_dir: str, epoch: int, epoch_iter: int) -> None:
    with open(os.path.join(expr_dir, "iter.txt"), "w") as f:
        f.write(f"{epoch},{epoch_iter}\n")


def load_iter(expr_dir: str) -> Tuple[int, int]:
    """The resume cursor (epoch, epoch_iter); (1, 0) on any failure."""
    try:
        with open(os.path.join(expr_dir, "iter.txt")) as f:
            a, b = f.read().strip().split(",")
        return int(a), int(b)
    except (OSError, ValueError):
        return 1, 0
