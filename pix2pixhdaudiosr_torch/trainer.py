"""Two-optimizer GAN training: state, optimizers, the train step, the fake
pool's split steps and the eval step.

Port of pix2pixhdaudiosr_tpu/trainer.py: Adam(lr, beta1, 0.999) for G
(and the feature encoder netE where the system has one) and for D from
one forward pass (`make_train_step`, :98-137), with --adam_mu_bf16 the
optax Adam whose first moment is stored in bf16 (`AdamMuBF16`, :43-48),
the learning
rate set on both for the linear decay (`set_learning_rate`), the
`niter_fix_global` phase, which zeroes every non-enhancer G grad (so a
fresh Adam leaves those weights where they are) until `reset_opt_g`
starts a new G optimizer, the fake pool's G and D steps
(`make_pool_steps`, :140-177) and the in-training eval's inference and
inverse (`make_eval_step`, :180-191). Parameters and Adam moments are f32;
the step computes in the compute dtype (system.py). The state is mutated
in place, where the JAX step returns a new one. Under the parallel modes
(`TrainState.parallel`: parallel/dp.py, zero.py, fsdp.py) every step
brackets its work with the strategy's `begin_step` (FSDP gathers the
weights), `reduce_grads` after the backward and `end_step` after the
optimizers; without one, a step is this process's alone.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch

from .models import hifigan_d
from .models.generator import init_normal_
from .system import Pix2PixHDSystem


class AdamMuBF16(torch.optim.Optimizer):
    """optax.adam(lr, b1, b2, eps, mu_dtype=bfloat16) as the JAX package's
    --adam_mu_bf16 runs it (optax scale_by_adam + scale(-lr)): in f32,

        mu = (1 - b1) g + b1 mu_stored;  nu = (1 - b2) g^2 + b2 nu
        p += -lr (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)

    with mu_stored the bf16 first moment (the update uses the f32 mu; only
    the stored one is rounded) and nu f32; b1, b2, 1 - b1 and 1 - b2 are
    the f32 values optax's injected hyperparameters hold. State per
    parameter as torch.optim.Adam names it ("step", "exp_avg" in bf16,
    "exp_avg_sq"), so that checkpoints cross between the two; a loaded
    exp_avg is cast back to bf16 (load_state_dict casts it to the
    parameter's dtype first, exactly, from bf16). The learning rate is the
    param group's, for set_learning_rate and reset_opt_g. foreach ops."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999),
                 eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps))
        self.register_load_state_dict_post_hook(AdamMuBF16._mu_to_bf16)

    @staticmethod
    def _mu_to_bf16(opt) -> None:
        for st in opt.state.values():
            if "exp_avg" in st:
                st["exp_avg"] = st["exp_avg"].to(torch.bfloat16)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AdamMuBF16 takes no closure")
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            for p in params:
                st = self.state[p]
                if not st:
                    st["step"] = torch.tensor(0.0)
                    st["exp_avg"] = torch.zeros_like(
                        p, dtype=torch.bfloat16,
                        memory_format=torch.preserve_format)
                    st["exp_avg_sq"] = torch.zeros_like(
                        p, memory_format=torch.preserve_format)
                st["step"] += 1
            grads = [p.grad for p in params]
            states = [self.state[p] for p in params]
            b1, b2 = (np.float32(b) for b in group["betas"])
            one = np.float32(1)
            # the first moment in f32 from the stored bf16 one (each product
            # rounded, then the sum, as optax's update_moment)
            mu = torch._foreach_mul(grads, float(one - b1))
            prev = [st["exp_avg"].float() for st in states]
            torch._foreach_mul_(prev, float(b1))
            torch._foreach_add_(mu, prev)
            del prev
            sq = torch._foreach_mul(grads, grads)
            torch._foreach_mul_(sq, float(one - b2))
            nus = [st["exp_avg_sq"] for st in states]
            torch._foreach_mul_(nus, float(b2))
            torch._foreach_add_(nus, sq)
            del sq
            for st, m in zip(states, mu):
                st["exp_avg"].copy_(m)  # round to nearest even
            # per-step scalars as 0-d f32 tensors on the parameters' device
            t = int(states[0]["step"].item())
            dev = params[0].device
            bc1 = torch.tensor(one - b1 ** np.float32(t), device=dev)
            bc2 = torch.tensor(one - b2 ** np.float32(t), device=dev)
            neg_lr = torch.tensor(-np.float32(group["lr"]), device=dev)
            torch._foreach_div_(mu, bc1)                     # mu_hat
            den = torch._foreach_div(nus, bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, float(np.float32(group["eps"])))
            torch._foreach_div_(mu, den)
            del den
            torch._foreach_mul_(mu, neg_lr)
            torch._foreach_add_(params, mu)
        return None


@dataclass
class TrainState:
    """The nets live in `system` (system.g_nets(): netG_train and netE;
    system.d_nets(): netD, time_D, hifigan_D); `step` counts steps;
    `parallel`: the data-parallel strategy (parallel/dp.DataParallel or a
    refinement) that `setup` attached, None in one process."""
    system: Pix2PixHDSystem
    opt_g: torch.optim.Optimizer
    opt_d: torch.optim.Optimizer
    step: int = 0
    parallel: Optional[object] = None


def make_optimizer(params: Iterable[torch.nn.Parameter], cfg,
                   lr: Optional[float] = None) -> torch.optim.Optimizer:
    """Adam(lr, (beta1, 0.999), eps 1e-8); with cfg.adam_mu_bf16 the
    bf16-first-moment AdamMuBF16 (both optimizers, as make_optimizer of
    the JAX package builds both)."""
    cls = AdamMuBF16 if cfg.adam_mu_bf16 else torch.optim.Adam
    return cls(params, lr=cfg.lr if lr is None else lr,
               betas=(cfg.beta1, 0.999), eps=1e-8)


def _split_params(system: Pix2PixHDSystem) -> Tuple[List, List]:
    """The G optimizer owns G and netE, the D optimizer every
    discriminator (netD, then time_D and hifigan_D where the system has
    them)."""
    return ([p for net in system.g_nets().values() for p in net.parameters()],
            [p for net in system.d_nets().values() for p in net.parameters()])


def init_state(system: Pix2PixHDSystem, seed: int = 0) -> TrainState:
    """Fresh N(0, 0.02) conv weights and zero biases for G, every D and
    netE (the JAX package's init, drawn in turn from one generator on the
    system's device seeded with `seed`; each weight-normed conv of
    hifigan_D gets g = |v|), and two fresh Adams."""
    gen = torch.Generator(device=system.device).manual_seed(seed)
    init_normal_(system.netG_train, gen)
    for key, net in system.d_nets().items():
        (hifigan_d.init_normal_ if key == "hifigan_D" else init_normal_)(net, gen)
    if system.netE is not None:
        init_normal_(system.netE, gen)
    pg, pd = _split_params(system)
    return TrainState(system, make_optimizer(pg, system.cfg),
                      make_optimizer(pd, system.cfg))


def reset_opt_g(state: TrainState, lr: float) -> TrainState:
    """A fresh Adam over every G parameter at the fix -> finetune switch
    (sharded as the parallel strategy shards it)."""
    pg, _ = _split_params(state.system)
    make = state.parallel.make_optimizer if state.parallel else make_optimizer
    state.opt_g = make(pg, state.system.cfg, lr)
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
    parameter whose top module is not an enhancer branch (`enh<n>_*`).
    netE is not net_g: it keeps training, as in the JAX package."""
    for name, p in net_g.named_parameters():
        if not name.split(".")[0].startswith("enh"):
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            else:
                p.grad.zero_()


def _begin(state: TrainState) -> None:
    if state.parallel is not None:
        state.parallel.begin_step(state)


def _update(state: TrainState, fix_global: bool, *opts) -> None:
    """After the backward: the fix-global mask, the grads' reduction over
    the ranks, the optimizers' steps and the strategy's end of step."""
    if fix_global:
        _mask_fixed_global(state.system.netG_train)
    par = state.parallel
    if par is not None:
        par.reduce_grads(state)
    for opt in opts:
        opt.step()
    if par is not None:
        par.end_step(state)


def _split_rng(rng):
    """(generator, noise): a train step's mask noise is a tensor, or a
    torch.Generator to draw it from."""
    if isinstance(rng, torch.Generator):
        return rng, None
    return None, rng


def make_train_step(system: Pix2PixHDSystem):
    """The train step:

        step(state, batch, rng, pooled_fake=None, fix_global=False,
             with_visuals=False) -> (losses, aux)

    batch: {"label": lr [B, S], "image": hr [B, S]} on the system's device;
    rng: the lr mask noise as a tensor, or a torch.Generator to draw it
    from. It runs system.losses_and_grads, masks the G grads in the
    fix-global phase, and steps both Adams."""
    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             rng: Union[torch.Generator, torch.Tensor, None] = None,
             pooled_fake: Optional[torch.Tensor] = None,
             fix_global: bool = False, with_visuals: bool = False):
        gen, noise = _split_rng(rng)
        _begin(state)
        losses, aux = system.losses_and_grads(
            batch, noise=noise, generator=gen, pooled_fake=pooled_fake,
            with_visuals=with_visuals)
        _update(state, fix_global, state.opt_g, state.opt_d)
        state.step += 1
        return losses, aux

    return step


def make_pool_steps(system: Pix2PixHDSystem):
    """The fake pool's split steps (`--pool_size > 0`):

        g_step(state, batch, rng, fix_global=False, with_visuals=False)
            -> (losses, aux)      updates G; aux["fake_pair"] feeds the pool
        d_step(state, batch, rng, pooled_fake) -> losses
                                  updates D against the pooled pair

    Both must see the same mask noise: give each the same tensor, or a
    generator seeded alike. Each returns every loss, as the JAX steps do
    (d_step's G losses come from the G that g_step has just updated); each
    differentiates only the net it updates. `state.step` counts d_steps."""
    def g_step(state: TrainState, batch, rng, fix_global: bool = False,
               with_visuals: bool = False):
        gen, noise = _split_rng(rng)
        _begin(state)
        losses, aux = system.losses_and_grads(
            batch, noise=noise, generator=gen, with_visuals=with_visuals,
            grads=("G",))
        _update(state, fix_global, state.opt_g)
        return losses, aux

    def d_step(state: TrainState, batch, rng, pooled_fake: torch.Tensor):
        gen, noise = _split_rng(rng)
        _begin(state)
        losses, _ = system.losses_and_grads(
            batch, noise=noise, generator=gen, pooled_fake=pooled_fake,
            grads=("D",))
        _update(state, False, state.opt_d)
        state.step += 1
        return losses

    return g_step, d_step


def make_eval_step(system: Pix2PixHDSystem):
    """The in-training eval's inference and inverse:

        eval_step(lr_audio, rng) -> (sr_audio [B, segment_length], sr_spectro)

    rng: the mask noise or a generator, as for the train step. The
    spectrogram goes to imdct_eval as G gives it (no abs, unlike the
    generate CLI), and the waveform is scaled by sqrt(up_ratio - 1)."""
    scale = float(np.sqrt(system.cfg.up_ratio - 1).astype(np.float32))

    @torch.no_grad()
    def eval_step(lr_audio: torch.Tensor, rng=None):
        gen, noise = _split_rng(rng)
        sr_spec, lr_pha, lr_norm, _ = system.inference(lr_audio, noise, gen)
        sr_audio = system.codec.imdct_eval(sr_spec, lr_pha, lr_norm, gen)
        return scale * sr_audio, sr_spec

    return eval_step
