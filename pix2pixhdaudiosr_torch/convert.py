"""JAX (flax) params and optax Adam state -> this package's state_dicts.

The torch modules are named after the flax param tree (models/layers.py,
models/hifigan_d.py), so the conversion is a walk over that tree: every
`Conv_0` or `ConvTranspose_0` node holding {kernel, bias} becomes
`<path>.weight` and `<path>.bias`, and every HiFi-GAN `NormConv_<k>` node
holding {kernel, bias[, g]} `<path>.weight`, `<path>.bias` and
`<path>.g`. The walk serves the generator, the feature encoder netE
(`params["E"]`) and every discriminator alike
(`jax_to_torch_discriminator`: netD, time_D, hifigan_D), and the Adam
moments, which are trees of the params' shape (`load_adam_state`).

* Conv kernels: flax HWIO [kh, kw, ci, co] -> torch OIHW [co, ci, kh, kw];
  1-D [k, ci, co] -> [co, ci, k] (ci per group, as in torch).
* Deconv kernels: flip_hw(k) then permute(2, 3, 0, 1) -> [ci, co, kh, kw],
  the same weight for both deconv modes (models/layers.ConvTransposeIN;
  the inverse of tools/import_torch_checkpoint.py's `_deconv_w`).

A reference (pix2pixHD torch) `.pth` goes in through
tools/import_torch_checkpoint.convert_generator_state_dict, then here, and
is served with --torch_deconv.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch.nn as nn

import numpy as np
import torch


def _conv_weight(kernel: np.ndarray) -> np.ndarray:
    if kernel.ndim == 3:
        return kernel.transpose(2, 1, 0)
    return kernel.transpose(3, 2, 0, 1)


def _deconv_weight(kernel: np.ndarray) -> np.ndarray:
    return kernel[::-1, ::-1].transpose(2, 3, 0, 1)


_LEAVES = {"Conv_0": _conv_weight, "ConvTranspose_0": _deconv_weight}


def jax_to_torch_generator(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Generator param tree (nested dicts of arrays, with or without the
    top-level "params" key) -> state_dict of models/generator.py."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping, path: list) -> None:
        for key, child in node.items():
            to_weight = _LEAVES.get(key) or (
                _conv_weight if key.startswith("NormConv_") else None)
            if to_weight is not None:
                prefix = ".".join(path + [key])
                kernel = np.asarray(child["kernel"], np.float32)
                weight = np.ascontiguousarray(to_weight(kernel))
                out[prefix + ".weight"] = torch.from_numpy(weight)
                for leaf in ("bias", "g"):
                    if leaf in child:
                        out[f"{prefix}.{leaf}"] = torch.from_numpy(
                            np.array(child[leaf], np.float32))
            else:
                walk(child, path + [key])

    walk(tree, [])
    return out


jax_to_torch_discriminator = jax_to_torch_generator


def jax_layout(name: str, ndim: int) -> Tuple[int, ...]:
    """The permutation `perm` of the conversion above for the tensor
    `name` (a state_dict key) of `ndim` dims: its dim k is the flax leaf's
    dim perm[k]. Conv weights OIHW from HWIO (3, 2, 0, 1), deconv weights
    (2, 3, 0, 1), 1-D conv weights (2, 1, 0); every other leaf as it is."""
    if ndim == 4:
        parts = name.split(".")
        deconv = len(parts) > 1 and parts[-2] == "ConvTranspose_0"
        return (2, 3, 0, 1) if deconv else (3, 2, 0, 1)
    if ndim == 3:
        return (2, 1, 0)
    return tuple(range(ndim))


@torch.no_grad()
def load_adam_state(opt: torch.optim.Adam, net: nn.Module, mu: Mapping,
                    nu: Mapping, count) -> None:
    """Install an optax Adam state (moments `mu`, `nu` as param trees of
    `net`, step `count`) as `opt`'s state for the parameters of `net`. The
    two updates agree: optax's mu_hat / (sqrt(nu_hat) + eps) is torch's
    exp_avg / bias1 / (sqrt(exp_avg_sq / bias2) + eps)."""
    moments = [jax_to_torch_generator(t) for t in (mu, nu)]
    for name, p in net.named_parameters():
        opt.state[p] = {
            "step": torch.tensor(float(np.asarray(count))),
            "exp_avg": torch.empty_like(p).copy_(moments[0][name]),
            "exp_avg_sq": torch.empty_like(p).copy_(moments[1][name])}
