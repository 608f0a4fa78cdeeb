"""The HiFi-GAN discriminator, the codec's to_audio and the random phase
encodings of the PyTorch port against the JAX package (CPU, f32, toy
size): NormConv (weight and spectral norm, forward and grads), the MSD and
MPD feature lists, to_audio and its vjp (the IMDCT2 Function, whose CPU
backward is B1's twin on the transposed basis), the three random phase
encodings fed JAX's draws, losses_and_grads with --use_hifigan_D, the
parameter bridge (convert.py) for the HiFi-GAN and the time-domain D, and
a checkpoint round trip that resumes bit-identically.

Toy configuration: tests/test_torch_train_step.py's TOY (n_fft 64,
480-sample segments), the HiFi-GAN D at its defaults (3 scales, periods
2, 3, 5, 7, 11). The JAX side runs two compiles: the D's forward and
losses_and_grads.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pix2pixhdaudiosr_tpu import trainer as jtrainer  # noqa: E402
from pix2pixhdaudiosr_tpu.config import parse_config as jparse  # noqa: E402
from pix2pixhdaudiosr_tpu.models.hifigan_d import NormConv as JNormConv  # noqa: E402
from pix2pixhdaudiosr_tpu.ops.encoding import CodecConfig as JCodecConfig  # noqa: E402
from pix2pixhdaudiosr_tpu.ops.encoding import SpectroCodec as JCodec  # noqa: E402
from pix2pixhdaudiosr_tpu.system import Pix2PixHDSystem as JSystem  # noqa: E402

from pix2pixhdaudiosr_torch import trainer  # noqa: E402
from pix2pixhdaudiosr_torch.config import parse_config  # noqa: E402
from pix2pixhdaudiosr_torch.convert import (jax_to_torch_discriminator,  # noqa: E402
                                            jax_to_torch_generator,
                                            load_adam_state)
from pix2pixhdaudiosr_torch.models.hifigan_d import NormConv  # noqa: E402
from pix2pixhdaudiosr_torch.ops.encoding import CodecConfig, SpectroCodec  # noqa: E402
from pix2pixhdaudiosr_torch.system import Pix2PixHDSystem  # noqa: E402
from pix2pixhdaudiosr_torch.utils import checkpoint as ckpt  # noqa: E402
from test_torch_train_step import SEG, TOY, _leaves, _mask_noise  # noqa: E402

FLAGS = ["--use_hifigan_D"]
# the bridge and checkpoint tests' D: the spectral-normed raw scale, one
# weight-normed pooled scale, and a period that 480 samples do not divide
# (the reflect pad), at a third of the default D's 70.7 M parameters
SMALL = FLAGS + ["--hifigan_scales", "2", "--hifigan_periods", "2,7"]
CODEC = dict(n_fft=64, hop_length=32, win_length=64, segment_length=SEG)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.fixture(scope="module")
def toy():
    """The JAX system and init with --use_hifigan_D, a batch, the step's
    mask noise, and JAX's losses_and_grads at the init."""
    jsys = JSystem(jparse(TOY + FLAGS, is_train=True, save=False))
    state, _, _ = jtrainer.init_state(jsys, jax.random.PRNGKey(4), batch=2)
    rng_np = np.random.default_rng(5)
    batch = {k: (rng_np.standard_normal((2, SEG)) * 0.2).astype(np.float32)
             for k in ("label", "image")}
    rng = jax.random.PRNGKey(21)
    losses, grads_g, grads_d, _ = jax.jit(jsys.losses_and_grads)(
        state.params, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    return dict(jsys=jsys, state=jax.device_get(state), batch=batch,
                noise=_mask_noise(rng, (2, int(64 * (1 - 1 / 6.0)), 16, 2)),
                losses={k: float(v) for k, v in losses.items()},
                grads={"G": _leaves(grads_g["G"]),
                       **{k: _leaves(v) for k, v in grads_d.items()}})


def _port(argv, params):
    system = Pix2PixHDSystem(parse_config(TOY + argv, is_train=True,
                                          save=False), device="cpu")
    system.netG_train.load_state_dict(jax_to_torch_generator(params["G"]))
    for key, net in system.d_nets().items():
        net.load_state_dict(jax_to_torch_discriminator(params[key]))
    return system


@pytest.mark.parametrize("norm,kernel,strides,padding,groups", [
    ("weight", (5,), (2,), "SAME", 2),
    ("spectral", (7,), (4,), "SAME", 1),
    ("weight", (5, 1), (3, 1), ((2, 2), (0, 0)), 1),
    ("spectral", (3, 1), (1, 1), ((1, 1), (0, 0)), 1),
])
def test_normconv_matches_jax(rng_np, norm, kernel, strides, padding, groups):
    """Forward and the grads of sum(y * r) w.r.t. x, the kernel, the bias
    and g within 1e-5 of each one's max: stride 2 and 4 with SAME padding
    on a 37-sample input (XLA pads low = total // 2), groups 2, and the
    period D's (5, 1) and (3, 1) convs."""
    nd = len(kernel)
    shape = (2, 37, 4) if nd == 1 else (2, 19, 3, 4)
    x = rng_np.standard_normal(shape).astype(np.float32)
    jconv = JNormConv(8, kernel, strides=strides, padding=padding,
                      feature_group_count=groups, norm=norm)
    params = jax.device_get(jconv.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    p = dict(params["params"])
    p["kernel"] = rng_np.standard_normal(p["kernel"].shape).astype(np.float32)
    if "g" in p:
        p["g"] = rng_np.uniform(0.5, 2, p["g"].shape).astype(np.float32)
    p["bias"] = rng_np.standard_normal(p["bias"].shape).astype(np.float32)
    y = np.asarray(jconv.apply({"params": p}, jnp.asarray(x)))
    r = rng_np.standard_normal(y.shape).astype(np.float32)
    jg = jax.grad(lambda q, xx: jnp.sum(jconv.apply({"params": q}, xx) * r),
                  argnums=(0, 1))(p, jnp.asarray(x))

    conv = NormConv(4, 8, kernel, strides, padding if padding == "SAME" else
                    tuple(lo for lo, _ in padding), groups, norm, device="cpu")
    sd = jax_to_torch_generator({"NormConv_0": p})
    conv.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()})
    to_t = (0, 2, 1) if nd == 1 else (0, 3, 1, 2)
    xt = torch.from_numpy(x).permute(*to_t).requires_grad_(True)
    yt = conv(xt)
    back = (0, 2, 1) if nd == 1 else (0, 2, 3, 1)
    np.testing.assert_allclose(yt.permute(*back).detach().numpy(), y,
                               atol=1e-5 * np.abs(y).max())
    (yt * torch.from_numpy(r).permute(*to_t)).sum().backward()
    want = jax_to_torch_generator({"NormConv_0": jax.device_get(jg[0])})
    for name, t in conv.named_parameters():
        w = want[f"NormConv_0.{name}"].numpy()
        np.testing.assert_allclose(t.grad.numpy(), w, atol=1e-5 * np.abs(w).max(),
                                   err_msg=name)
    gx = np.asarray(jg[1])
    np.testing.assert_allclose(xt.grad.permute(*back).numpy(), gx,
                               atol=1e-5 * np.abs(gx).max())


def test_msd_mpd_features_match_jax(toy, rng_np):
    """The HiFi-GAN D at the default 3 scales and periods (2, 3, 5, 7, 11)
    on a [2, 480] waveform: every sub-discriminator's every feature within
    1e-4 of that layer's max, the MSDs' [B, C, T'] and the MPDs'
    [B, C, T'/p, p] against flax's NHC / NHWC; the parameter count equal."""
    wav = (rng_np.standard_normal((2, SEG)) * 0.3).astype(np.float32)
    jsys, params = toy["jsys"], toy["state"].params["hifigan_D"]
    want = jax.jit(jsys.hifigan_D.apply)(params, jnp.asarray(wav)[..., None])
    system = _port(FLAGS, toy["state"].params)
    net = system.hifigan_D
    assert sum(p.numel() for p in net.parameters()) == sum(
        np.size(v) for v in jax.tree.leaves(params))
    got = net(torch.from_numpy(wav)[:, None, :])
    assert len(got) == len(want) == 3 + 5
    for sub_got, sub_want in zip(got, want):
        assert len(sub_got) == len(sub_want)
        for g, w in zip(sub_got, sub_want):
            w = np.asarray(w)
            g = g.detach().numpy()
            g = np.moveaxis(g, 1, -1)
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, atol=1e-4 * np.abs(w).max())


@pytest.mark.parametrize("explicit", [True, False])
def test_to_audio_and_its_vjp_match_jax(rng_np, explicit):
    """to_audio of a G-like output and its vjp (the IMDCT2 Function, with
    B1's twin on basis^T as its CPU backward, the center crop's gradient
    padded back by autograd) within 1e-5 of each one's max; without
    explicit encoding the pseudo-phase's {0, 1} draw is JAX's."""
    kw = dict(CODEC, explicit_encoding=explicit)
    jcodec, codec = JCodec(JCodecConfig(**kw)), SpectroCodec(
        CodecConfig(**kw), device="cpu")
    audio = (rng_np.standard_normal((2, SEG)) * 0.2).astype(np.float32)
    _, jpha, jnorm = jcodec.to_spectro(jnp.asarray(audio))
    _, pha, norm = codec.to_spectro(torch.from_numpy(audio))
    c = 2 if explicit else 1
    spec = rng_np.uniform(-1, 1, (2, 64, 16, c)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    y, vjp = jax.vjp(lambda s: jcodec.to_audio(s, jnorm, pha=jpha, rng=key),
                     jnp.asarray(spec))
    ct = rng_np.standard_normal(y.shape).astype(np.float32)
    (jgrad,) = vjp(jnp.asarray(ct))
    signs = None if explicit else torch.from_numpy(np.asarray(
        jax.random.randint(key, jpha.shape, 0, 2)))
    st = torch.from_numpy(spec).requires_grad_(True)
    yt = codec.to_audio(st, norm, pha=pha, signs=signs)
    assert yt.shape == y.shape == (2, SEG)
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(y),
                               atol=1e-5 * np.abs(np.asarray(y)).max())
    (yt * torch.from_numpy(ct)).sum().backward()
    jgrad = np.asarray(jgrad)
    np.testing.assert_allclose(st.grad.numpy(), jgrad,
                               atol=1e-5 * np.abs(jgrad).max())


@pytest.mark.parametrize("mode", ["uni_dist", "norm_dist", "norm_dist2"])
def test_random_phase_encodings_match_jax(rng_np, mode):
    """to_spectro without explicit encoding, masked, with JAX's draws: the
    phase encoding's (rng, sub = split(rng); ops/encoding.py:99-110) as
    `phase_noise`, then the mask's (split(rng, 3)[1]) as `noise`. The
    spectrogram, the scaled phase and the norm within 1e-6."""
    kw = dict(CODEC, explicit_encoding=False, phase_encoding_mode=mode)
    jcodec, codec = JCodec(JCodecConfig(**kw)), SpectroCodec(
        CodecConfig(**kw), device="cpu")
    audio = (rng_np.standard_normal((2, SEG)) * 0.2).astype(np.float32)
    key = jax.random.PRNGKey(8)
    jspec, jpha, jnorm = jcodec.to_spectro(jnp.asarray(audio), rng=key,
                                           mask=True)
    rest, sub = jax.random.split(key)
    shape = jpha.shape
    draw = (jax.random.uniform(sub, shape) if mode == "uni_dist"
            else jax.random.normal(sub, shape))
    mask_sub = jax.random.split(rest, 3)[1]
    noise = jax.random.normal(mask_sub, (2, codec.mask_size(64), 16, 1))
    spec, pha, norm = codec.to_spectro(
        torch.from_numpy(audio), mask=True, noise=_t(noise),
        phase_noise=_t(draw))
    np.testing.assert_allclose(pha.numpy(), np.asarray(jpha), atol=1e-6)
    np.testing.assert_allclose(spec.numpy(), np.asarray(jspec), atol=1e-6)
    for k in ("max", "min", "mean", "std"):
        np.testing.assert_allclose(float(norm[k]), float(jnorm[k]), rtol=1e-6)
    assert np.abs(np.asarray(jpha)).max() <= 1 + 1e-6 or mode == "norm_dist2"
    assert len(np.unique(np.abs(np.asarray(jpha)).round(6))) > 2


def test_losses_and_grads_match_jax(toy):
    """--use_hifigan_D: losses within rtol 1e-4; every G, D and hifigan_D
    grad leaf within 1e-3 of its net's max."""
    system = _port(FLAGS, toy["state"].params)
    losses, _ = system.losses_and_grads(
        {k: torch.from_numpy(v) for k, v in toy["batch"].items()},
        noise=toy["noise"])
    assert list(losses) == ["G_GAN", "G_GAN_Feat", "G_GAN_t", "D_real_t",
                            "D_fake_t", "D_real", "D_fake"]
    assert set(losses) == set(toy["losses"])
    for k, want in toy["losses"].items():
        np.testing.assert_allclose(float(losses[k]), want, rtol=1e-4,
                                   atol=1e-9, err_msg=k)
    nets = {"G": system.netG_train, **system.d_nets()}
    assert set(nets) == set(toy["grads"]) == {"G", "D", "hifigan_D"}
    for key, net in nets.items():
        want = toy["grads"][key]
        got = {n: p.grad.numpy() for n, p in net.named_parameters()}
        assert set(got) == set(want)
        net_max = max(np.abs(g).max() for g in want.values())
        for name, g in want.items():
            assert np.abs(got[name] - g).max() <= 1e-3 * net_max, (key, name)


def test_convert_carries_both_new_discriminators(toy):
    """convert.py walks the time-domain D's and the HiFi-GAN D's param
    trees (NormConv leaves {kernel, bias, g}) into state_dicts that load
    strictly, with flax's kernels transposed as torch's; load_adam_state
    installs the D optimizer's moments of every discriminator."""
    jsys = JSystem(jparse(TOY + SMALL + ["--use_time_D"], is_train=True,
                          save=False))
    state, _, _ = jtrainer.init_state(jsys, jax.random.PRNGKey(6), batch=2)
    state = jax.device_get(state)
    system = _port(SMALL + ["--use_time_D"], state.params)
    k = state.params["hifigan_D"]["params"]
    w = system.hifigan_D.msd1.NormConv_2.weight.detach().numpy()
    np.testing.assert_array_equal(w, np.transpose(k["msd1"]["NormConv_2"]["kernel"],
                                                  (2, 1, 0)))
    w = system.hifigan_D.mpd7.NormConv_0.weight.detach().numpy()
    np.testing.assert_array_equal(w, np.transpose(k["mpd7"]["NormConv_0"]["kernel"],
                                                  (3, 2, 0, 1)))
    np.testing.assert_array_equal(system.hifigan_D.mpd7.NormConv_0.g.detach().numpy(),
                                  k["mpd7"]["NormConv_0"]["g"])
    assert not hasattr(system.hifigan_D.msd0.NormConv_0, "g")
    _, opt_d = [trainer.make_optimizer(p, system.cfg)
                for p in trainer._split_params(system)]
    adam = state.opt_d.inner_state[0]
    for key, net in system.d_nets().items():
        load_adam_state(opt_d, net, adam.mu[key], adam.nu[key], adam.count)
    assert len(opt_d.state) == sum(1 for net in system.d_nets().values()
                                   for _ in net.parameters())


def test_checkpoint_round_trip_resumes_bit_identically(tmp_path):
    """With both optional Ds (the HiFi-GAN one SMALL): a step,
    save_train_state (net_time_D and net_hifigan_D files, every D's Adam
    state under the optim file's D entry), load_train_state into a state
    of another seed, and a second step from each: every weight of every
    net bit-identical. The names loaded are the JAX tree's keys."""
    argv = TOY + SMALL + ["--use_time_D", "--use_match_loss"]

    def fresh(seed):
        system = Pix2PixHDSystem(parse_config(argv, is_train=True, save=False),
                                 device="cpu")
        return trainer.init_state(system, seed)

    gen = torch.Generator().manual_seed(0)
    batch = {k: torch.randn(2, SEG, generator=gen) * 0.2
             for k in ("label", "image")}
    noise = [torch.Generator().manual_seed(s) for s in (1, 2)]
    a = fresh(0)
    step = trainer.make_train_step(a.system)
    step(a, batch, noise[0])
    ckpt.save_train_state(a, str(tmp_path), "t")
    for key in ("G", "D", "time_D", "hifigan_D"):
        assert (tmp_path / f"t_net_{key}.pth").exists()
    b = fresh(9)
    loaded = ckpt.load_train_state(b, "t", str(tmp_path))
    for key, net in (("G", a.system.netG_train), *a.system.d_nets().items()):
        assert {f"{key}.{n}" for n in net.state_dict()} <= loaded
    assert any(n.startswith("opt_d.time_D.") for n in loaded)
    assert any(n.startswith("opt_d.hifigan_D.") for n in loaded)
    step(a, batch, torch.Generator().manual_seed(2))
    trainer.make_train_step(b.system)(b, batch, noise[1])
    assert a.step == b.step == 2
    for x, y in ((a.system.netG_train, b.system.netG_train),
                 *zip(a.system.d_nets().values(), b.system.d_nets().values())):
        for (n, p), (_, q) in zip(x.named_parameters(), y.named_parameters()):
            assert torch.equal(p, q), n
