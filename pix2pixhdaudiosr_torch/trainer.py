"""Two-optimizer GAN training: state, optimizers and the train step.

Port of pix2pixhdaudiosr_tpu/trainer.py:35-137: Adam(lr, beta1, 0.999) for
G and for D from one forward pass (`make_train_step`), the learning rate
set on both for the linear decay (`set_learning_rate`), and the
`niter_fix_global` phase, which zeroes every non-enhancer G grad (so a
fresh Adam leaves those weights where they are) until `reset_opt_g`
starts a new G optimizer. Parameters and Adam moments are f32; the step
computes in the compute dtype (system.py). The state is mutated in place,
where the JAX step returns a new one. The fake pool
(`make_pool_steps`, utils/image_pool.py) comes with ROADMAP A8.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple, Union

import torch

from .models.generator import init_normal_
from .system import Pix2PixHDSystem


@dataclass
class TrainState:
    """The nets live in `system` (netG_train, netD); `step` counts steps."""
    system: Pix2PixHDSystem
    opt_g: torch.optim.Adam
    opt_d: torch.optim.Adam
    step: int = 0


def make_optimizer(params: Iterable[torch.nn.Parameter], cfg,
                   lr: Optional[float] = None) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=cfg.lr if lr is None else lr,
                            betas=(cfg.beta1, 0.999), eps=1e-8)


def _split_params(system: Pix2PixHDSystem) -> Tuple[List, List]:
    """The G optimizer owns G, the D optimizer every discriminator."""
    return list(system.netG_train.parameters()), list(system.netD.parameters())


def init_state(system: Pix2PixHDSystem, seed: int = 0) -> TrainState:
    """Fresh N(0, 0.02) conv weights and zero biases for G and D (the JAX
    package's init, drawn from a generator on the system's device seeded
    with `seed`), and two fresh Adams."""
    gen = torch.Generator(device=system.device).manual_seed(seed)
    init_normal_(system.netG_train, gen)
    init_normal_(system.netD, gen)
    pg, pd = _split_params(system)
    return TrainState(system, make_optimizer(pg, system.cfg),
                      make_optimizer(pd, system.cfg))


def reset_opt_g(state: TrainState, lr: float) -> TrainState:
    """A fresh Adam over every G parameter at the fix -> finetune switch."""
    pg, _ = _split_params(state.system)
    state.opt_g = make_optimizer(pg, state.system.cfg, lr)
    return state


def set_learning_rate(state: TrainState, lr: float) -> TrainState:
    """The linear-decay hook: both optimizers' learning rate."""
    for opt in (state.opt_g, state.opt_d):
        for group in opt.param_groups:
            group["lr"] = lr
    return state


@torch.no_grad()
def _mask_fixed_global(net_g: torch.nn.Module) -> None:
    """Zero (not drop: Adam steps every parameter) the grad of every G
    parameter whose top module is not an enhancer branch (`enh<n>_*`)."""
    for name, p in net_g.named_parameters():
        if not name.split(".")[0].startswith("enh"):
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            else:
                p.grad.zero_()


def make_train_step(system: Pix2PixHDSystem):
    """The train step:

        step(state, batch, rng, pooled_fake=None, fix_global=False)
            -> (losses, aux)

    batch: {"label": lr [B, S], "image": hr [B, S]} on the system's device;
    rng: the lr mask noise as a tensor, or a torch.Generator to draw it
    from. It runs system.losses_and_grads, masks the G grads in the
    fix-global phase, and steps both Adams."""
    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             rng: Union[torch.Generator, torch.Tensor, None] = None,
             pooled_fake: Optional[torch.Tensor] = None,
             fix_global: bool = False):
        if pooled_fake is not None:
            raise NotImplementedError("the fake pool is not ported yet; it "
                                      "comes with ROADMAP A8")
        gen = rng if isinstance(rng, torch.Generator) else None
        noise = None if gen is not None else rng
        losses, aux = system.losses_and_grads(batch, noise=noise,
                                              generator=gen)
        if fix_global:
            _mask_fixed_global(system.netG_train)
        state.opt_g.step()
        state.opt_d.step()
        state.step += 1
        return losses, aux

    return step
