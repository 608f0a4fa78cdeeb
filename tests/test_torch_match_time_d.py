"""The match loss and the time-domain discriminator of the PyTorch port
against the JAX package (CPU, f32, toy size): the codec pieces they use
(idct_2n, to_frames, MDCT2's windowed frames), losses_and_grads and one
train step against optax with --use_match_loss --use_time_D --lambda_time
10, the loss names, and one CPU step with each flag alone.

The time-domain D reads the dB of the G output's IDCT frames, floored at
--min_value (1e-7): the gradient of 20 log10|f| is 8.7/f, so the frames
just above the floor, whose f32 value keeps few significant bits, weigh
the most in G's and time_D's grads, and two f32 implementations' grads
there part by far more than 1e-3 (tools/torch_grad_conditioning.py floor:
G 67x, time_D 19x that bound of a leaf's max; 0.95x and 0.10x with the
floor at 1e-3; the losses agree at both). So the grads are held to JAX's with --min_value
1e-3 (WELL), and at the default floor the losses and D's grads are.

Toy configuration: tests/test_torch_train_step.py's TOY (n_fft 64, 480-
sample segments, LocalEnhancer ngf 4, PatchGAN ndf 4), f32, batch 2. The
JAX side runs two compiles: losses_and_grads at each floor; the optax
step is taken eagerly from the second's grads.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from pix2pixhdaudiosr_tpu import trainer as jtrainer  # noqa: E402
from pix2pixhdaudiosr_tpu.config import parse_config as jparse  # noqa: E402
from pix2pixhdaudiosr_tpu.ops.dct import idct_2n as jidct_2n  # noqa: E402
from pix2pixhdaudiosr_tpu.ops.mdct import MDCT2 as JMDCT2  # noqa: E402
from pix2pixhdaudiosr_tpu.system import Pix2PixHDSystem as JSystem  # noqa: E402

from chip_smoke import norm_fed_biases  # noqa: E402
from pix2pixhdaudiosr_torch import trainer  # noqa: E402
from pix2pixhdaudiosr_torch.config import parse_config  # noqa: E402
from pix2pixhdaudiosr_torch.convert import (jax_to_torch_discriminator,  # noqa: E402
                                            jax_to_torch_generator)
from pix2pixhdaudiosr_torch.ops.dct import idct_2n  # noqa: E402
from pix2pixhdaudiosr_torch.ops.mdct import MDCT2  # noqa: E402
from pix2pixhdaudiosr_torch.ops.window import kbdwin  # noqa: E402
from pix2pixhdaudiosr_torch.system import Pix2PixHDSystem  # noqa: E402
from test_torch_train_step import LR, SEG, TOY, _leaves, _mask_noise  # noqa: E402

FLAGS = ["--use_match_loss", "--use_time_D", "--lambda_time", "10"]
WELL = FLAGS + ["--min_value", "1e-3"]
NETS = ("G", "D", "time_D")


def _port(argv, params):
    """A CPU training system of TOY + argv holding the JAX params."""
    system = Pix2PixHDSystem(parse_config(TOY + argv, is_train=True,
                                          save=False), device="cpu")
    system.netG_train.load_state_dict(jax_to_torch_generator(params["G"]))
    for key, net in system.d_nets().items():
        net.load_state_dict(jax_to_torch_discriminator(params[key]))
    return system


def _nets(system):
    return {"G": system.netG_train, **system.d_nets()}


def _batch(toy):
    return {k: torch.from_numpy(v) for k, v in toy["batch"].items()}


def _jax_step(flags, params, batch, rng):
    """JAX's losses_and_grads of TOY + flags: (losses, {net: {torch name:
    grad}}, the raw grad trees)."""
    jsys = JSystem(jparse(TOY + flags, is_train=True, save=False))
    losses, grads_g, grads_d, _ = jax.jit(jsys.losses_and_grads)(
        params, batch, rng)
    grads = {"G": _leaves(grads_g["G"]),
             **{k: _leaves(v) for k, v in grads_d.items()}}
    return dict(jsys=jsys, losses={k: float(v) for k, v in losses.items()},
                grads=grads, trees=(grads_g, grads_d))


@pytest.fixture(scope="module")
def toy():
    """The JAX init, a batch, the step's mask noise, JAX's losses_and_grads
    at the default floor and at WELL's, and the state after one optax step
    of WELL's grads (the JAX train step's update, trainer.py:116-124)."""
    jsys = JSystem(jparse(TOY + WELL, is_train=True, save=False))
    state, opt_g, opt_d = jtrainer.init_state(jsys, jax.random.PRNGKey(4),
                                              batch=2)
    rng_np = np.random.default_rng(5)
    batch = {k: (rng_np.standard_normal((2, SEG)) * 0.2).astype(np.float32)
             for k in ("label", "image")}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    rng = jax.random.PRNGKey(21)
    runs = {name: _jax_step(flags, state.params, jbatch, rng)
            for name, flags in (("floor", FLAGS), ("well", WELL))}
    grads_g, grads_d = runs["well"].pop("trees")
    runs["floor"].pop("trees")
    pg, pd = jtrainer._split_params(state.params)
    params = {}
    for opt, ost, p, g in ((opt_g, state.opt_g, pg, grads_g),
                           (opt_d, state.opt_d, pd, grads_d)):
        upd, _ = opt.update(g, ost, p)
        params.update(optax.apply_updates(p, upd))
    return dict(jsys=jsys, params=jax.device_get(state.params),
                params1=jax.device_get(params), batch=batch,
                noise=_mask_noise(rng, (2, int(64 * (1 - 1 / 6.0)), 16, 2)),
                **runs)


def test_codec_pieces_match_jax(toy, rng_np):
    """idct_2n, to_frames of a G-like output and MDCT2's windowed frames
    (return_ola) within atol 1e-5 of the JAX package's."""
    x = rng_np.standard_normal((2, 16, 64)).astype(np.float32)
    np.testing.assert_allclose(idct_2n(torch.from_numpy(x)).numpy(),
                               np.asarray(jidct_2n(jnp.asarray(x))), atol=1e-5)

    audio = (rng_np.standard_normal((2, SEG)) * 0.2).astype(np.float32)
    jcodec = toy["floor"]["jsys"].codec
    system = _port(FLAGS, toy["params"])
    _, _, jnorm = jcodec.to_spectro(jnp.asarray(audio), rng=None,
                                    return_frames=True)
    _, _, norm = system.codec.to_spectro(torch.from_numpy(audio),
                                         return_frames=True)
    np.testing.assert_allclose(norm["frames"].numpy(),
                               np.asarray(jnorm["frames"]), atol=1e-5)
    spec = rng_np.uniform(0, 1, (2, 64, 16, 2)).astype(np.float32)
    want = np.asarray(jcodec.to_frames(jnp.asarray(spec), jnorm))
    got = system.codec.to_frames(torch.from_numpy(spec), norm).numpy()
    assert got.shape == want.shape == (2, 16, 64)
    np.testing.assert_allclose(got, want, atol=1e-5 * max(1, np.abs(want).max()))

    kw = dict(n_fft=64, hop_length=32, win_length=64, window=kbdwin(64))
    out, frames = MDCT2(device="cpu", **kw)(torch.from_numpy(audio),
                                            return_ola=True)
    jout, jframes = JMDCT2(**kw)(jnp.asarray(audio), return_ola=True)
    np.testing.assert_allclose(frames.numpy(), np.asarray(jframes), atol=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5)


def _check_grads(system, want, nets=NETS, rel="net"):
    """Every grad leaf of `nets` within 1e-3 of its net's largest |grad|
    (rel="net"), or of its own (rel="leaf"; then a conv bias that feeds an
    InstanceNorm, whose exact grad is 0, of its net's, as in
    tests/test_torch_train_step.py)."""
    for key in nets:
        net, ref = _nets(system)[key], want[key]
        got = {n: p.grad.numpy() for n, p in net.named_parameters()}
        assert set(got) == set(ref)
        net_max = max(np.abs(g).max() for g in ref.values())
        void = set(ref) if rel == "net" else norm_fed_biases(net)
        for name, g in ref.items():
            scale = net_max if name in void else np.abs(g).max()
            assert np.abs(got[name] - g).max() <= 1e-3 * scale, (key, name)


def _check_losses(losses, want):
    assert list(losses) == ["G_GAN", "G_GAN_Feat", "G_mat", "G_GAN_t",
                            "D_real_t", "D_fake_t", "D_real", "D_fake"]
    assert set(losses) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(float(losses[k]), v, rtol=1e-4, err_msg=k)


def test_losses_and_d_grads_match_jax_at_the_floor(toy):
    """At the default --min_value: losses within rtol 1e-4 and every D grad
    leaf within 1e-3 of its own max (G's and time_D's: the module
    docstring)."""
    system = _port(FLAGS, toy["params"])
    losses, _ = system.losses_and_grads(_batch(toy), noise=toy["noise"])
    _check_losses(losses, toy["floor"]["losses"])
    _check_grads(system, toy["floor"]["grads"], ("D",), rel="leaf")


def test_losses_and_grads_match_jax(toy):
    """WELL: losses within rtol 1e-4; every G, D and time_D grad leaf within
    1e-3 of its net's max, D's also of its own."""
    system = _port(WELL, toy["params"])
    losses, _ = system.losses_and_grads(_batch(toy), noise=toy["noise"])
    _check_losses(losses, toy["well"]["losses"])
    _check_grads(system, toy["well"]["grads"])
    _check_grads(system, toy["well"]["grads"], ("D",), rel="leaf")


def test_one_train_step_matches_optax(toy):
    """make_train_step (WELL) from the JAX init against optax's update of
    JAX's grads: every updated G, D and time_D param within 1e-3 lr where
    its |g| > 1e-3 max|g| of the net (there Adam moves a weight by about lr
    sign(g)), within 2 lr elsewhere (an entry whose grad is rounding steps
    either way); losses within rtol 1e-4."""
    system = _port(WELL, toy["params"])
    state = trainer.TrainState(system, *[
        trainer.make_optimizer(p, system.cfg)
        for p in trainer._split_params(system)])
    before = {k: {n: p.detach().clone().numpy() for n, p in
                  net.named_parameters()} for k, net in _nets(system).items()}
    losses, _ = trainer.make_train_step(system)(state, _batch(toy),
                                                toy["noise"])
    _check_losses(losses, toy["well"]["losses"])
    moved = 0
    for key, net in _nets(system).items():
        want = _leaves(toy["params1"][key])
        net_max = max(np.abs(p.grad.numpy()).max() for p in net.parameters())
        for name, p in net.named_parameters():
            g = np.abs(p.grad.numpy())
            diff = np.abs(p.detach().numpy() - want[name])
            assert diff[g > 1e-3 * net_max].max(initial=0) <= 1e-3 * LR, (key, name)
            assert diff.max() <= 2 * LR, (key, name)
            moved += int((np.abs(p.detach().numpy() - before[key][name])
                          > 0.5 * LR).sum())
    assert moved > 0


@pytest.mark.parametrize("flags", [
    [], ["--use_match_loss"], ["--use_time_D"], FLAGS, ["--use_hifigan_D"],
    ["--use_time_D", "--use_hifigan_D", "--use_match_loss"],
])
def test_loss_names_match_jax(flags):
    cfg = parse_config(TOY + flags, is_train=True, save=False)
    want = JSystem(jparse(TOY + flags, is_train=True, save=False)).loss_names
    assert Pix2PixHDSystem(cfg, device="cpu").loss_names == want


@pytest.mark.parametrize("flags", [["--use_match_loss"], ["--use_time_D"]])
def test_one_flag_trains_on_the_cpu(flags):
    """A train step with one optional loss alone: every loss finite, every
    parameter of every net moved, the optional loss reported."""
    system = Pix2PixHDSystem(parse_config(TOY + flags, is_train=True,
                                          save=False), device="cpu")
    state = trainer.init_state(system, 1)
    before = {(k, n): p.detach().clone() for k, net in _nets(system).items()
              for n, p in net.named_parameters()}
    gen = torch.Generator().manual_seed(0)
    batch = {k: torch.randn(2, SEG, generator=gen) * 0.2
             for k in ("label", "image")}
    losses, _ = trainer.make_train_step(system)(state, batch, gen)
    assert all(np.isfinite(float(v)) for v in losses.values())
    assert ("G_mat" in losses) == ("--use_match_loss" in flags)
    assert ("G_GAN_t" in losses) == ("--use_time_D" in flags)
    still = [key for key, p in before.items() if torch.equal(
        p, dict(_nets(system)[key[0]].named_parameters())[key[1]].detach())]
    assert not still


def test_split_steps_differentiate_one_side(toy):
    """grads=("G",) leaves every discriminator's .grad None and G's set;
    grads=("D",) the reverse, time_D included; both return every loss, as
    JAX's pool steps do."""
    system = _port(FLAGS, toy["params"])
    for grads in (("G",), ("D",)):
        losses, _ = system.losses_and_grads(_batch(toy), noise=toy["noise"],
                                            grads=grads)
        _check_losses(losses, toy["floor"]["losses"])
        for key, net in _nets(system).items():
            has = {p.grad is not None for p in net.parameters()}
            assert has == {(key == "G") == (grads == ("G",))}, (grads, key)
