"""The PyTorch port's train step against the JAX package (CPU, f32, toy
size): losses_and_grads, one and two make_train_step steps against optax,
the fix-global grad mask, the learning-rate hooks, the options the port
refuses or newly trains, and a CPU run of the training CLI whose checkpoint the
generate CLI serves.

Toy configuration: n_fft 64 / hop 32 / win 64, 480-sample segments (16
frames), LocalEnhancer ngf 4 with 2 downsamples and 1 + 1 blocks, the
2-scale PatchGAN at ndf 4 with 3 layers, f32, batch 2. The JAX side runs
two compiles: losses_and_grads and the train step.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pix2pixhdaudiosr_tpu import trainer as jtrainer  # noqa: E402
from pix2pixhdaudiosr_tpu.config import parse_config as jparse  # noqa: E402
from pix2pixhdaudiosr_tpu.system import Pix2PixHDSystem as JSystem  # noqa: E402

from chip_smoke import norm_fed_biases  # noqa: E402
from pix2pixhdaudiosr_torch import generate, train_loop, trainer  # noqa: E402
from pix2pixhdaudiosr_torch.config import parse_config  # noqa: E402
from pix2pixhdaudiosr_torch.convert import (jax_to_torch_discriminator,  # noqa: E402
                                            jax_to_torch_generator,
                                            load_adam_state)
from pix2pixhdaudiosr_torch.data.wavio import read_wav, write_wav  # noqa: E402
from pix2pixhdaudiosr_torch.system import Pix2PixHDSystem  # noqa: E402

SEG = 480
TOY = ["--netG", "local", "--ngf", "4", "--n_downsample_global", "2",
       "--n_blocks_global", "1", "--n_local_enhancers", "1",
       "--n_blocks_local", "1", "--input_nc", "2", "--output_nc", "2",
       "--label_nc", "0", "--no_instance", "--explicit_encoding",
       "--mask_mode", "mode2", "--compute_dtype", "float32",
       "--n_fft", "64", "--hop_length", "32", "--win_length", "64",
       "--segment_length", str(SEG), "--seed", "11", "--ndf", "4",
       "--n_layers_D", "3", "--batchSize", "2"]
LR = 2e-4


def _mask_noise(rng, shape):
    """The lr mask draw of the JAX step at `rng`: k_enc = split(rng, 3)[0]
    (system.py:225), k_lr = split(k_enc)[0] (:174), then
    split(k_lr, 3)[1] (ops/encoding.py:117-118)."""
    k_enc = jax.random.split(rng, 3)[0]
    k_lr = jax.random.split(k_enc)[0]
    sub = jax.random.split(k_lr, 3)[1]
    return torch.from_numpy(np.asarray(jax.random.normal(sub, shape,
                                                         jnp.float32)))


def _leaves(tree):
    """{torch name: array} of a JAX param (or grad, or moment) tree."""
    return {k: v.numpy() for k, v in jax_to_torch_generator(tree).items()}


@pytest.fixture(scope="module")
def toy():
    """JAX system and state, a batch, the step's rng and mask noise, and
    the JAX results: losses_and_grads at the initial params, and the state
    after one and after two train steps (the second at another rng)."""
    jcfg = jparse(TOY, is_train=True, save=False)
    jsys = JSystem(jcfg)
    state, opt_g, opt_d = jtrainer.init_state(jsys, jax.random.PRNGKey(4),
                                              batch=2)
    rng_np = np.random.default_rng(5)
    batch = {k: (rng_np.standard_normal((2, SEG)) * 0.2).astype(np.float32)
             for k in ("label", "image")}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    rngs = [jax.random.PRNGKey(21), jax.random.PRNGKey(22)]
    losses, grads_g, grads_d, _ = jax.jit(jsys.losses_and_grads)(
        state.params, jbatch, rngs[0])
    step = jtrainer.make_train_step(jsys, opt_g, opt_d, donate=False)
    states = [state]
    for r in rngs:
        states.append(step(states[-1], jbatch, r, None, fix_global=False,
                           with_visuals=False)[0])
    shape = (2, int(64 * (1 - 1 / jcfg.up_ratio)), 16, 2)
    return dict(jsys=jsys, states=jax.device_get(states), batch=batch,
                noise=[_mask_noise(r, shape) for r in rngs],
                losses={k: float(v) for k, v in losses.items()},
                grads_g=_leaves(grads_g["G"]), grads_d=_leaves(grads_d["D"]))


def _port(params):
    """A CPU training system holding the JAX params `params`."""
    system = Pix2PixHDSystem(parse_config(TOY, is_train=True, save=False),
                             device="cpu")
    system.netG_train.load_state_dict(jax_to_torch_generator(params["G"]))
    system.netD.load_state_dict(jax_to_torch_discriminator(params["D"]))
    return system


def _batch(toy):
    return {k: torch.from_numpy(v) for k, v in toy["batch"].items()}


def _grads(net):
    return {n: p.grad.numpy() for n, p in net.named_parameters()}


def test_losses_and_grads_match_jax(toy):
    """Losses within rtol 1e-4; every G and D grad leaf within 1e-3 of its
    largest |grad|. A conv bias that feeds an InstanceNorm
    (chip_smoke.norm_fed_biases) has an exact grad of 0 (the norm cancels a
    per-channel shift), so its leaf is f32 rounding on both sides: those
    leaves are held to 1e-3 of the largest |grad| of their net instead."""
    system = _port(toy["states"][0].params)
    losses, aux = system.losses_and_grads(_batch(toy), noise=toy["noise"][0])
    assert list(losses) == ["G_GAN", "G_GAN_Feat", "D_real", "D_fake"]
    assert list(losses) == system.loss_names
    assert set(losses) == set(toy["losses"])
    for k, want in toy["losses"].items():
        np.testing.assert_allclose(float(losses[k]), want, rtol=1e-4)
    assert aux["fake_pair"].shape == (2, 64, 16, 4)
    for net, want in ((system.netG_train, toy["grads_g"]),
                      (system.netD, toy["grads_d"])):
        got = _grads(net)
        assert set(got) == set(want)
        net_max = max(np.abs(g).max() for g in want.values())
        void = norm_fed_biases(net)
        for name, g in want.items():
            scale = net_max if name in void else np.abs(g).max()
            assert np.abs(got[name] - g).max() <= 1e-3 * scale, name


def test_d_grads_take_nothing_from_the_g_losses(toy):
    """netD's .grad after losses_and_grads is the grad of the D losses
    alone (recomputed here by plain autograd on the same pair), and every
    conv weight of both nets has a nonzero grad: the InstanceNorm Function
    passes the gradient through."""
    system = _port(toy["states"][0].params)
    system.losses_and_grads(_batch(toy), noise=toy["noise"][0])
    got = _grads(system.netD)
    for p in system.netD.parameters():
        p.grad = None
    lr_spec = system.encode_input(_batch(toy)["label"], toy["noise"][0])[0]
    hr_spec = system.encode_target(_batch(toy)["image"])[0]
    with torch.no_grad():
        sr = system.netG_train(lr_spec.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    from pix2pixhdaudiosr_torch.losses import gan_loss
    d = (gan_loss(system.d_apply(lr_spec, sr), False)
         + gan_loss(system.d_apply(lr_spec, hr_spec), True)) * 0.5
    d.backward()
    for name, p in system.netD.named_parameters():
        np.testing.assert_allclose(got[name], p.grad.numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=name)
    for net in (system.netG_train, system.netD):
        for name, p in net.named_parameters():
            if name.endswith("weight"):
                assert np.abs(got[name] if net is system.netD
                              else p.grad.numpy()).max() > 0, name


def _check_params(system, want_params, before, grads, lr=LR):
    """Updated params against JAX's: within 1e-3 * lr where |g| > 1e-3
    max|g| of the leaf (there an Adam step moves a weight by about
    lr * sign(g)); elsewhere, where an entry's |g| is near Adam's eps and
    its step's sign follows the rounding, within 2 * lr. A bias that feeds
    an InstanceNorm (exact grad 0, test_losses_and_grads_match_jax) is
    rounding through and through: its leaf is held to 2 * lr alone."""
    want = {**_leaves(want_params["G"]), **{
        f"D.{k}": v for k, v in _leaves(want_params["D"]).items()}}
    got = {**{k: v.detach().numpy() for k, v in
              system.netG_train.state_dict().items()},
           **{f"D.{k}": v.detach().numpy() for k, v in
              system.netD.state_dict().items()}}
    assert set(got) == set(want)
    moved = 0
    void = norm_fed_biases(system.netG_train) | norm_fed_biases(
        system.netD, "D.")
    for name, w in want.items():
        g = np.abs(grads[name])
        big = (g > 1e-3 * g.max()) & (name not in void)
        diff = np.abs(got[name] - w)
        assert diff[big].max(initial=0) <= 1e-3 * lr, name
        assert diff.max() <= 2 * lr, name
        moved += int((np.abs(got[name] - before[name]) > 0.5 * lr).sum())
    assert moved > 0


def _named_grads(system):
    return {**_grads(system.netG_train),
            **{f"D.{k}": v for k, v in _grads(system.netD).items()}}


def _named_params(system):
    return {**{k: v.detach().numpy().copy() for k, v in
               system.netG_train.state_dict().items()},
            **{f"D.{k}": v.detach().numpy().copy() for k, v in
               system.netD.state_dict().items()}}


def test_one_and_two_train_steps_match_optax(toy):
    """make_train_step from the JAX init: the params after step 1 against
    optax's, then step 2 from the same state against optax's step 2 (the
    moments carried over by convert.load_adam_state, so that step 1's
    rounding does not compound). Losses within rtol 1e-4 each step."""
    s0, s1, s2 = toy["states"]
    system = _port(s0.params)
    state = trainer.TrainState(system, *[
        trainer.make_optimizer(p, system.cfg)
        for p in trainer._split_params(system)])
    step = trainer.make_train_step(system)
    before = _named_params(system)
    losses, _ = step(state, _batch(toy), toy["noise"][0])
    assert state.step == 1
    for k, want in toy["losses"].items():
        np.testing.assert_allclose(float(losses[k]), want, rtol=1e-4)
    _check_params(system, s1.params, before, _named_grads(system))

    system = _port(s1.params)
    opt_g, opt_d = [trainer.make_optimizer(p, system.cfg)
                    for p in trainer._split_params(system)]
    for opt, net, key, o in ((opt_g, system.netG_train, "G", s1.opt_g),
                             (opt_d, system.netD, "D", s1.opt_d)):
        adam = o.inner_state[0]
        load_adam_state(opt, net, adam.mu[key], adam.nu[key], adam.count)
    state = trainer.TrainState(system, opt_g, opt_d, step=1)
    before = _named_params(system)
    step = trainer.make_train_step(system)
    step(state, _batch(toy), toy["noise"][1])
    _check_params(system, s2.params, before, _named_grads(system))


def test_fix_global_masks_the_jax_key_set(toy):
    """_mask_fixed_global zeroes the grads of exactly the G leaves that the
    JAX mask zeroes (every top module but enh<n>_*), keeps the rest, and
    leaves zeros, not None, so that Adam steps them."""
    tree = jax.tree.map(lambda a: jnp.ones_like(a), {"G": toy["states"][0]
                                                     .params["G"]})
    masked = _leaves(jtrainer._mask_fixed_global(tree, 1)["G"])
    zeroed = {k for k, v in masked.items() if not v.any()}
    assert zeroed and len(zeroed) < len(masked)
    system = _port(toy["states"][0].params)
    for p in system.netG_train.parameters():
        p.grad = torch.ones_like(p)
    trainer._mask_fixed_global(system.netG_train)
    got = {n for n, p in system.netG_train.named_parameters()
           if not p.grad.any()}
    assert got == zeroed
    assert all(n.startswith("enh") for n in set(masked) - zeroed)


def test_fix_global_step_freezes_the_global_trunk(toy):
    """A fix-global step moves only enhancer weights (a fresh Adam on a
    zero grad takes a zero step)."""
    system = _port(toy["states"][0].params)
    state = trainer.TrainState(system, *[
        trainer.make_optimizer(p, system.cfg)
        for p in trainer._split_params(system)])
    before = {k: v.clone() for k, v in system.netG_train.state_dict().items()}
    trainer.make_train_step(system)(state, _batch(toy), toy["noise"][0],
                                    fix_global=True)
    moved = {name for name, v in system.netG_train.state_dict().items()
             if not torch.equal(v, before[name])}
    assert moved and all(name.startswith("enh") for name in moved)
    assert {n for n in before if n.startswith("enh") and n.endswith("weight")
            } <= moved


def test_learning_rate_hooks():
    """set_learning_rate sets both optimizers' lr; reset_opt_g replaces the
    G optimizer with a fresh Adam (no state) at the given lr, over the
    same parameters, and leaves the D optimizer alone."""
    system = Pix2PixHDSystem(parse_config(TOY, is_train=True, save=False),
                             device="cpu")
    state = trainer.init_state(system, 3)
    batch = {k: torch.randn(2, SEG, generator=torch.Generator()
                            .manual_seed(i)) * 0.2
             for i, k in enumerate(("label", "image"))}
    trainer.make_train_step(system)(state, batch, torch.Generator()
                                    .manual_seed(0))
    assert state.opt_g.param_groups[0]["betas"] == (0.5, 0.999)
    assert state.opt_g.param_groups[0]["eps"] == 1e-8
    trainer.set_learning_rate(state, 1e-5)
    assert [g["lr"] for o in (state.opt_g, state.opt_d)
            for g in o.param_groups] == [1e-5, 1e-5]
    opt_d, old_g = state.opt_d, state.opt_g
    assert len(old_g.state) > 0
    trainer.reset_opt_g(state, 7e-5)
    assert state.opt_g is not old_g and state.opt_d is opt_d
    assert len(state.opt_g.state) == 0
    assert state.opt_g.param_groups[0]["lr"] == 7e-5
    assert [id(p) for p in state.opt_g.param_groups[0]["params"]] == [
        id(p) for p in system.netG_train.parameters()]


def test_training_g_is_plain_and_shares_the_serving_weights():
    """With --fused_enhancer --int8_trunk the serving netG carries both, and
    netG_train is a plain twin holding the very same parameters."""
    cfg = parse_config(TOY + ["--fused_enhancer", "--int8_trunk"],
                       is_train=True, save=False)
    system = Pix2PixHDSystem(cfg, device="cpu")
    assert system.netG.fused_enh_blocks
    assert getattr(system.netG, "global").int8_blocks
    assert not system.netG_train.fused_enh_blocks
    assert not getattr(system.netG_train, "global").int8_blocks
    for (n1, p1), (n2, p2) in zip(system.netG.named_parameters(),
                                  system.netG_train.named_parameters()):
        assert n1 == n2 and p1 is p2
    plain = Pix2PixHDSystem(parse_config(TOY, is_train=True, save=False),
                            device="cpu")
    assert plain.netG_train is plain.netG
    serving = Pix2PixHDSystem(parse_config(TOY, is_train=False, save=False),
                              device="cpu")
    assert not hasattr(serving, "netD") and not hasattr(serving, "netG_train")


@pytest.mark.parametrize("extra", [
    ["--instance_feat"], ["--remat_g", "full"], ["--adam_mu_bf16"]])
def test_feature_and_memory_options_train(extra):
    """The options earlier slices refused now build and run a toy CPU step
    with finite losses that moves G (held to the JAX package in
    tests/test_torch_feature_encoder.py and test_torch_memory_knobs.py)."""
    cfg = parse_config(TOY + extra, is_train=True, save=False)
    system = Pix2PixHDSystem(cfg, device="cpu")
    assert (system.netE is not None) == cfg.instance_feat
    state = trainer.init_state(system, 3)
    before = [p.detach().clone() for p in system.netG_train.parameters()]
    batch = {k: torch.randn(2, SEG, generator=torch.Generator()
                            .manual_seed(i)) * 0.2
             for i, k in enumerate(("label", "image"))}
    losses, _ = trainer.make_train_step(system)(
        state, batch, torch.Generator().manual_seed(0))
    assert all(np.isfinite(float(v)) for v in losses.values())
    assert any(not torch.equal(a, b) for a, b in
               zip(before, system.netG_train.parameters()))


@pytest.mark.parametrize("extra,item", [
    (["--fsdp"], "A11"),
    (["--zero_opt_state"], "A11"),
])
def test_train_loop_refuses_unported_options(tmp_path, extra, item):
    argv = TOY + ["--name", "run", "--checkpoints_dir", str(tmp_path),
                  "--dataroot", str(tmp_path), "--device", "cpu",
                  "--validation_split", "0", "--no_html", *extra]
    with pytest.raises(SystemExit, match=item):
        train_loop.main(argv)
    assert not (tmp_path / "run" / "latest_net_G.pth").exists()


def test_train_loop_without_cuda_raises(tmp_path, monkeypatch):
    """No --device and no CUDA: SystemExit before any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        train_loop.main(TOY + ["--name", "run", "--checkpoints_dir",
                               str(tmp_path), "--dataroot", str(tmp_path),
                               "--no_html", "--validation_split", "0"])


def test_train_loop_on_cpu_then_generate_serves_it(tmp_path, capsys):
    """The training CLI on the CPU: 2 steps at batch 2 over 4 wavs (one
    epoch), printing every step and saving at the epoch's end; then the
    generate CLI on the CPU serves the latest_net_G.pth it wrote."""
    corpus = tmp_path / "wavs"
    corpus.mkdir()
    rng = np.random.default_rng(0)
    for i in range(4):
        write_wav(str(corpus / f"a{i}.wav"),
                  (rng.standard_normal(3000) * 0.2).astype(np.float32), 48000)
    argv = TOY + ["--name", "run", "--checkpoints_dir", str(tmp_path),
                  "--dataroot", str(corpus), "--no_html", "--device", "cpu",
                  "--validation_split", "0", "--niter", "1", "--niter_decay",
                  "0", "--print_freq", "2", "--save_latest_freq", "0",
                  "--save_epoch_freq", "1", "--serial_batches"]
    state = train_loop.main(argv)
    assert state.step == 2
    out = capsys.readouterr().out
    run = tmp_path / "run"
    log = (run / "loss_log.txt").read_text().splitlines()
    assert len([ln for ln in log if ln.startswith("(epoch: 1, iters: ")]) == 2
    assert "G_GAN: " in log[-1] and "D_fake: " in log[-1]
    assert "saving the model at the end of epoch 1" in out
    for tag in ("latest", "1"):
        for part in ("net_G", "net_D", "optim"):
            assert (run / f"{tag}_{part}.pth").exists()
    assert (run / "iter.txt").read_text().strip() == "2,0"
    saved = torch.load(run / "latest_net_G.pth", weights_only=True)
    for k, v in state.system.netG_train.state_dict().items():
        assert torch.equal(saved[k], v)

    wav = tmp_path / "in.wav"
    write_wav(str(wav), (rng.standard_normal(1500) * 0.2).astype(np.float32),
              48000)
    audio = generate.main(TOY + [
        "--name", "gen", "--checkpoints_dir", str(tmp_path), "--load_pretrain",
        str(run), "--dataroot", str(wav), "--no_html", "--device", "cpu"])
    assert np.isfinite(audio).all() and np.abs(audio).max() > 0
    sr, rate = read_wav(os.path.join(tmp_path, "gen", "sr_audio.wav"))
    assert rate == 48000 and sr.shape[1] >= 1500


def test_train_loop_decay_and_fix_global_switch(tmp_path, capsys):
    """2 epochs of 1 step (2 wavs at batch 2): epoch 1 in the fix-global
    phase (only enhancer weights move), then the switch to a fresh G Adam,
    and after epoch 2 (> niter 1) the linear decay takes both optimizers'
    lr from 2e-4 to 0."""
    corpus = tmp_path / "wavs"
    corpus.mkdir()
    rng = np.random.default_rng(1)
    for i in range(2):
        write_wav(str(corpus / f"a{i}.wav"),
                  (rng.standard_normal(2000) * 0.2).astype(np.float32), 48000)
    argv = TOY + ["--name", "run", "--checkpoints_dir", str(tmp_path),
                  "--dataroot", str(corpus), "--no_html", "--device", "cpu",
                  "--validation_split", "0", "--niter", "1", "--niter_decay",
                  "1", "--niter_fix_global", "1", "--print_freq", "0",
                  "--save_latest_freq", "0", "--save_epoch_freq", "0",
                  "--verbose"]
    state = train_loop.main(argv)
    out = capsys.readouterr().out
    assert state.step == 2
    assert out.count("Now also finetuning global generator") == 1
    assert "update learning rate: 0.000000" in out
    assert [g["lr"] for o in (state.opt_g, state.opt_d)
            for g in o.param_groups] == [0.0, 0.0]
    assert not list(tmp_path.glob("run/*.pth"))
