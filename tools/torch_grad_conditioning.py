#!/usr/bin/env python3
"""How far the PyTorch port's toy train-step grads move under rounding, on
the CPU: the measurements behind ROADMAP §C's entries on the toy
step's G-grad gap and on the time-domain D's grads.

    JAX_PLATFORMS=cpu python3 tools/torch_grad_conditioning.py perturb
    JAX_PLATFORMS=cpu python3 tools/torch_grad_conditioning.py floor
    JAX_PLATFORMS=cpu python3 tools/torch_grad_conditioning.py branches

perturb: chip_smoke's toy step (TOY_TRAIN) on the CPU, once as it is and
    once with every generator conv output times (1 + eps n), n a seeded
    standard normal, for each eps; prints G's worst grad leaf against
    1e-3 of its max (chip_smoke.grad_worst_of_bound) and how many elements
    of the feature-matching L1's |D(fake) - D(real)| changed sign.
floor: the port's losses_and_grads against the JAX package's with
    --use_match_loss --use_time_D --lambda_time 10 at each --min_value
    (the floor of the time-domain D's dB frames), from the same init,
    batch and mask noise (tests/test_torch_train_step.py's TOY); prints
    each net's worst grad leaf against 1e-3 of its max (a bias feeding an
    InstanceNorm against its net's) and the losses' largest relative error.
branches: chip_smoke phase 10's comparison of a card step with the
    independent CPU step, with a perturbed CPU step (every generator conv
    output times (1 + 1e-6 n), one seed a row) in the card's place, plain
    and with each of TOY_RECIPES' flags; prints each net's worst
    grad leaf as phase 10 reads it (G and D against 1e-3 of the leaf's max,
    the other Ds, and G with --use_time_D, against 1e-3 of their net's;
    G_leaf: G's leaves against their own) against the CPU step on its
    own branches and on the perturbed step's (chip_smoke.card_branch_in:
    InstanceNorm's activations; chip_smoke.card_floor: the time-domain D's
    dB floor), the elements whose branch differs, and
    how many seeds break phase 10's limits each way.
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]


def perturb(eps_list=(1e-6, 2e-6, 5e-6)) -> None:
    import torch
    import chip_smoke as cs
    from pix2pixhdaudiosr_torch import system as system_mod
    from pix2pixhdaudiosr_torch.config import parse_config
    from pix2pixhdaudiosr_torch.system import Pix2PixHDSystem
    from pix2pixhdaudiosr_torch.trainer import init_state, make_train_step

    cfg = parse_config(cs.TOY_TRAIN, is_train=True, save=False)
    gen = torch.Generator().manual_seed(2)
    batch = {k: torch.randn(2, cs.TOY_SEG, generator=gen) * 0.2
             for k in ("label", "image")}
    init = Pix2PixHDSystem(cfg, device="cpu")
    init_state(init, 0)
    b, f, t, c = init.spectro_shape(2)
    noise = torch.randn(b, init.codec.mask_size(f), t, c,
                        generator=torch.Generator().manual_seed(3))
    fm_loss = system_mod.feature_matching_loss

    def run(eps):
        system = Pix2PixHDSystem(cfg, device="cpu")
        state = init_state(system, 0)
        system.netG_train.load_state_dict(init.netG_train.state_dict())
        system.netD.load_state_dict(init.netD.state_dict())
        draws = torch.Generator().manual_seed(5)
        hooks = [m.register_forward_hook(lambda m, i, o: o * (
            1 + eps * torch.randn(o.shape, generator=draws)))
            for m in system.netG_train.modules()
            if eps and isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))]
        signs = []

        def spy(fake, real, *args):
            signs.extend(torch.sign(a.detach() - r) for sa, sr in zip(fake, real)
                         for a, r in zip(sa[:-1], sr[:-1]))
            return fm_loss(fake, real, *args)
        system_mod.feature_matching_loss = spy
        try:
            make_train_step(system)(state, batch, noise)
        finally:
            system_mod.feature_matching_loss = fm_loss
            for h in hooks:
                h.remove()
        return ({f"G.{n}": p.grad.clone() for n, p in
                 system.netG_train.named_parameters()}, signs)

    base, base_signs = run(0.0)
    void = cs.norm_fed_biases(init.netG_train, "G.")
    for eps in eps_list:
        grads, signs = run(eps)
        worst = cs.grad_worst_of_bound(grads, base, void)
        flips = [int((a != b).sum()) for a, b in zip(signs, base_signs)]
        print(f"eps {eps:g}: G worst of the 1e-3 leaf bound {worst[0]:.4f} "
              f"({worst[1]}); feature-matching L1 sign flips by layer {flips}")


def floor(min_values=("1e-7", "1e-4", "1e-3")) -> None:
    import jax
    import jax.numpy as jnp
    import torch
    from chip_smoke import norm_fed_biases
    from pix2pixhdaudiosr_tpu import trainer as jtrainer
    from pix2pixhdaudiosr_tpu.config import parse_config as jparse
    from pix2pixhdaudiosr_tpu.system import Pix2PixHDSystem as JSystem
    from pix2pixhdaudiosr_torch.config import parse_config
    from pix2pixhdaudiosr_torch.convert import (jax_to_torch_discriminator,
                                                jax_to_torch_generator)
    from pix2pixhdaudiosr_torch.system import Pix2PixHDSystem
    from test_torch_train_step import SEG, TOY, _leaves, _mask_noise

    rng_np = np.random.default_rng(5)
    batch = {k: (rng_np.standard_normal((2, SEG)) * 0.2).astype(np.float32)
             for k in ("label", "image")}
    rng = jax.random.PRNGKey(21)
    noise = _mask_noise(rng, (2, int(64 * (1 - 1 / 6.0)), 16, 2))
    for mv in min_values:
        flags = TOY + ["--use_match_loss", "--use_time_D", "--lambda_time",
                       "10", "--min_value", mv]
        jsys = JSystem(jparse(flags, is_train=True, save=False))
        state, _, _ = jtrainer.init_state(jsys, jax.random.PRNGKey(4), batch=2)
        losses, gg, gd, _ = jax.jit(jsys.losses_and_grads)(
            state.params, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
        want = {"G": _leaves(gg["G"]), **{k: _leaves(v) for k, v in gd.items()}}
        params = jax.device_get(state.params)
        system = Pix2PixHDSystem(parse_config(flags, is_train=True, save=False),
                                 device="cpu")
        system.netG_train.load_state_dict(jax_to_torch_generator(params["G"]))
        for key, net in system.d_nets().items():
            net.load_state_dict(jax_to_torch_discriminator(params[key]))
        got, _ = system.losses_and_grads(
            {k: torch.from_numpy(v) for k, v in batch.items()}, noise=noise)
        loss_err = max(abs(float(got[k]) - float(v)) / abs(float(v))
                       for k, v in losses.items())
        rows = []
        for key, net in (("G", system.netG_train), *system.d_nets().items()):
            ref = want[key]
            void = norm_fed_biases(net)
            net_max = max(np.abs(v).max() for v in ref.values())
            worst = max((np.abs(p.grad.numpy() - ref[n]).max() / (1e-3 * (
                net_max if n in void else np.abs(ref[n]).max())), n)
                for n, p in net.named_parameters())
            rows.append(f"{key} {worst[0]:.3f} ({worst[1]})")
        print(f"--min_value {mv}: losses' largest relative error "
              f"{loss_err:.2e}; worst of the 1e-3 leaf bound: " + ", ".join(rows))


def branches(n_seeds: int = 40, eps: float = 1e-6) -> None:
    import torch
    import chip_smoke as cs
    from pix2pixhdaudiosr_torch.config import parse_config
    from pix2pixhdaudiosr_torch.models import layers
    from pix2pixhdaudiosr_torch.ops.norm import (instance_norm_act,
                                                 instance_norm_act_grad)
    from pix2pixhdaudiosr_torch.system import Pix2PixHDSystem
    from pix2pixhdaudiosr_torch.trainer import init_state, make_train_step

    for flags in ([], *cs.TOY_RECIPES):
        cfg = parse_config(cs.TOY_TRAIN + list(flags), is_train=True,
                           save=False)
        gen = torch.Generator().manual_seed(2)
        batch = {k: torch.randn(2, cs.TOY_SEG, generator=gen) * 0.2
                 for k in ("label", "image")}
        init = Pix2PixHDSystem(cfg, device="cpu")
        init_state(init, 0)
        b, f, t, c = init.spectro_shape(2)
        noise = torch.randn(b, init.codec.mask_size(f), t, c,
                            generator=torch.Generator().manual_seed(3))
        nets = ("G", *init.d_nets())
        void = set().union(*(cs.norm_fed_biases(net, f"{key}.") for key, net
                             in (("G", init.netG_train), *init.d_nets().items())))

        def run(seed=None, in_fn=instance_norm_act,
                in_grad=instance_norm_act_grad, floors=None):
            """The step's grads; with a seed, every G conv output perturbed;
            the dB floor's branches recorded into `floors`, or taken from
            them (chip_smoke.card_floor) where `in_grad` is given."""
            system = Pix2PixHDSystem(cfg, device="cpu")
            state = init_state(system, 0)
            system.netG_train.load_state_dict(init.netG_train.state_dict())
            for key, net in system.d_nets().items():
                net.load_state_dict(init.d_nets()[key].state_dict())
            hooks = []
            if seed is not None:
                draws = torch.Generator().manual_seed(seed)
                hooks = [m.register_forward_hook(lambda m, i, o: o * (
                    1 + eps * torch.randn(o.shape, generator=draws)))
                    for m in system.netG_train.modules()
                    if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))]
            layers.instance_norm_act, layers.instance_norm_act_grad = in_fn, in_grad
            time_d_input = system.time_d_input
            if in_grad is not instance_norm_act_grad:
                system.time_d_input = cs.card_floor(floors, cfg.min_value)
            elif floors is not None:
                system.time_d_input = lambda label, test: (floors.append(tuple(
                    f.detach().abs() >= cfg.min_value for f in (label, test)))
                    or time_d_input(label, test))
            try:
                make_train_step(system)(state, batch, noise)
            finally:
                layers.instance_norm_act = instance_norm_act
                layers.instance_norm_act_grad = instance_norm_act_grad
                for h in hooks:
                    h.remove()
            return {f"{p}.{n}": w.grad.clone() for p, net in
                    {"G": system.netG_train, **system.d_nets()}.items()
                    for n, w in net.named_parameters()}

        def worst(got, want):
            """Phase 10's reading: {net: worst of its bound}."""
            out = {}
            for net in nets:
                pick = {k: v for k, v in want.items() if k.startswith(net + ".")}
                by_net = net not in ("G", "D") or (net == "G" and cfg.use_time_d)
                out[net] = cs.grad_worst_of_bound(
                    got, pick, set(pick) if by_net else void)[0]
                if net == "G" and by_net:
                    out["G_leaf"] = cs.grad_worst_of_bound(got, pick, void)[0]
            return out

        def breaks(w):
            return (w["D"] > 1 or w["G"] > cs.INDEPENDENT_G_LIMIT
                    or any(w[k] > 1 for k in nets if k not in ("G", "D")))
        if cfg.use_time_d:
            print("  (G against G's max, as phase 10 reads it with "
                  "--use_time_D; G_leaf against each leaf's)")

        own = run()
        n_own = n_aligned = 0
        print(f"flags {flags}: worst of the bound, G (limit "
              f"{cs.INDEPENDENT_G_LIMIT}), D (1), other Ds of their net's max (1)")
        for seed in range(n_seeds):
            calls, floors = [], []

            def record(x, act, **kw):
                out = instance_norm_act(x, act, **kw)
                calls.append((x.detach(), (out[0] if isinstance(out, tuple)
                                           else out).detach(), act))
                return out
            card = run(seed, record, floors=floors)
            flips = []
            aligned = run(None, *cs.card_branch_in(calls, "own", flips),
                          floors=floors)
            w_own, w_al = worst(card, own), worst(card, aligned)
            n_own += breaks(w_own)
            n_aligned += breaks(w_al)
            fmt = lambda w: " ".join(f"{k} {v:.4g}" for k, v in w.items())
            print(f"  seed {seed}: own branches {fmt(w_own)} | card's "
                  f"branches {fmt(w_al)} | activation flips {sum(flips)}")
        print(f"flags {flags}: {n_own} of {n_seeds} seeds break phase 10's "
              f"limits on the CPU step's own branches, {n_aligned} on the "
              f"perturbed step's")


if __name__ == "__main__":
    what = sys.argv[1] if len(sys.argv) > 1 else ""
    if what not in ("perturb", "floor", "branches"):
        sys.exit(__doc__)
    {"perturb": perturb, "floor": floor, "branches": branches}[what]()
