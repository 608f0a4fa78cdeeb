"""The PyTorch port's feature encoder (netE) against the JAX package (CPU,
f32, toy size): the Encoder module with and without instance pooling,
losses_and_grads and one optax step with --instance_feat (G, E and D),
sample_features, the encode / precompute tools, and the feature configs
the JAX package does not run, which the port refuses.

Toy configuration: tests/test_torch_train_step.py's TOY (n_fft 64,
480-sample segments, LocalEnhancer ngf 4, PatchGAN ndf 4) with
--instance_feat --feat_num 3 --nef 4 --n_downsample_E 2, f32, batch 2.
The JAX side runs one step compile (losses_and_grads); the optax update
is taken eagerly from its grads.
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from pix2pixhdaudiosr_tpu import trainer as jtrainer  # noqa: E402
from pix2pixhdaudiosr_tpu.config import parse_config as jparse  # noqa: E402
from pix2pixhdaudiosr_tpu.models.generator import Encoder as JEncoder  # noqa: E402
from pix2pixhdaudiosr_tpu.system import Pix2PixHDSystem as JSystem  # noqa: E402

from chip_smoke import norm_fed_biases  # noqa: E402
from pix2pixhdaudiosr_torch import generate, train_loop, trainer  # noqa: E402
from pix2pixhdaudiosr_torch.config import parse_config  # noqa: E402
from pix2pixhdaudiosr_torch.convert import (jax_to_torch_discriminator,  # noqa: E402
                                            jax_to_torch_generator)
from pix2pixhdaudiosr_torch.models.generator import Encoder  # noqa: E402
from pix2pixhdaudiosr_torch.system import Pix2PixHDSystem  # noqa: E402
from test_torch_train_step import LR, SEG, TOY, _leaves, _mask_noise  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

FEAT = ["--instance_feat", "--feat_num", "3", "--nef", "4",
        "--n_downsample_E", "2"]
NETS = ("G", "E", "D")


def _port(argv, params):
    """A CPU training system of TOY + argv holding the JAX params."""
    system = Pix2PixHDSystem(parse_config(TOY + argv, is_train=True,
                                          save=False), device="cpu")
    system.netG_train.load_state_dict(jax_to_torch_generator(params["G"]))
    system.netE.load_state_dict(jax_to_torch_generator(params["E"]))
    system.netD.load_state_dict(jax_to_torch_discriminator(params["D"]))
    return system


def _nets(system):
    return {**system.g_nets(), **system.d_nets()}


@pytest.fixture(scope="module")
def toy():
    """The JAX init, a batch, the step's mask noise, JAX's losses_and_grads
    and the params after one optax step of its grads (the JAX train step's
    update, trainer.py:116-124)."""
    jsys = JSystem(jparse(TOY + FEAT, is_train=True, save=False))
    assert jsys.netE is not None
    state, opt_g, opt_d = jtrainer.init_state(jsys, jax.random.PRNGKey(4),
                                              batch=2)
    rng_np = np.random.default_rng(5)
    batch = {k: (rng_np.standard_normal((2, SEG)) * 0.2).astype(np.float32)
             for k in ("label", "image")}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    rng = jax.random.PRNGKey(21)
    losses, grads_g, grads_d, _ = jax.jit(jsys.losses_and_grads)(
        state.params, jbatch, rng)
    pg, pd = jtrainer._split_params(state.params)
    params = {}
    for opt, ost, p, g in ((opt_g, state.opt_g, pg, grads_g),
                           (opt_d, state.opt_d, pd, grads_d)):
        upd, _ = opt.update(g, ost, p)
        params.update(optax.apply_updates(p, upd))
    return dict(params=jax.device_get(state.params),
                params1=jax.device_get(params), batch=batch,
                noise=_mask_noise(rng, (2, int(64 * (1 - 1 / 6.0)), 16, 2)),
                losses={k: float(v) for k, v in losses.items()},
                grads={"G": _leaves(grads_g["G"]), "E": _leaves(grads_g["E"]),
                       "D": _leaves(grads_d["D"])})


def _batch(toy):
    return {k: torch.from_numpy(v) for k, v in toy["batch"].items()}


@pytest.mark.parametrize("ids", ["none", "small", "wide"])
def test_encoder_matches_flax(ids):
    """Encoder (nef 4, 2 downsamples, 3 outputs) on [2, 32, 16, 2] against
    flax's at atol 1e-5 in f32: unpooled (inst None), pooled over ids in
    [0, 3), and over ids in [-3, 100), where an id outside [0, 64) joins
    no region and pools to 0."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 32, 16, 2)).astype(np.float32)
    inst = None if ids == "none" else rng.integers(
        *((0, 3) if ids == "small" else (-3, 100)), (2, 32, 16, 1))
    jenc = JEncoder(2, 3, ngf=4, n_downsampling=2)
    jinst = None if inst is None else jnp.asarray(inst, jnp.int32)
    params = jenc.init(jax.random.PRNGKey(0), jnp.asarray(x), jinst)
    want = np.asarray(jenc.apply(params, jnp.asarray(x), jinst))
    enc = Encoder(2, 3, ngf=4, n_downsampling=2, device="meta").to_empty(
        device="cpu")
    enc.load_state_dict(jax_to_torch_generator(params))
    got = enc(torch.from_numpy(x).permute(0, 3, 1, 2),
              None if inst is None else torch.from_numpy(inst[..., 0]))
    got = got.permute(0, 2, 3, 1).detach().numpy()
    assert got.shape == want.shape == (2, 32, 16, 3)
    np.testing.assert_allclose(got, want, atol=1e-5)
    if ids == "wide":
        outside = (inst[..., 0] < 0) | (inst[..., 0] >= 64)
        assert outside.any() and not got[outside].any()


def _void(key, net):
    """The leaves held to 1e-3 of their net's max|g| rather than their own:
    a conv bias feeding an InstanceNorm (exact grad 0, as
    tests/test_torch_train_step.py holds them), and every bias of E. E's
    output bias sums the pooled grads over every pixel, whose terms nearly
    cancel: JAX's f32 grad there lies 1.07e-3 of the leaf's max from a
    float64 step, the port's 0.72e-3 (both within 2e-5 of E's max)."""
    if key == "E":
        return {n for n, _ in net.named_parameters() if n.endswith("bias")}
    return norm_fed_biases(net)


def _check_grads(system, want):
    """Every grad leaf of G, E and D within 1e-3 of its own max|g|, or of
    its net's for the leaves of _void."""
    for key in NETS:
        net, ref = _nets(system)[key], want[key]
        got = {n: p.grad.numpy() for n, p in net.named_parameters()}
        assert set(got) == set(ref), key
        net_max = max(np.abs(g).max() for g in ref.values())
        void = _void(key, net)
        for name, g in ref.items():
            scale = net_max if name in void else np.abs(g).max()
            assert np.abs(got[name] - g).max() <= 1e-3 * scale, (key, name)


def test_losses_and_grads_match_jax(toy):
    """--instance_feat: losses within rtol 1e-4, every G, E and D grad leaf
    within the bound of _check_grads; G takes 2 + 3 input channels and D
    2 + 2 (D sees the raw lr spectrogram)."""
    system = _port(FEAT, toy["params"])
    assert system.g_input_nc == 5
    assert system.netD.scale0.ConvIN_0.Conv_0.in_channels == 4
    losses, _ = system.losses_and_grads(_batch(toy), noise=toy["noise"])
    assert set(losses) == set(toy["losses"])
    for k, want in toy["losses"].items():
        np.testing.assert_allclose(float(losses[k]), want, rtol=1e-4,
                                   err_msg=k)
    _check_grads(system, toy["grads"])


def test_one_train_step_matches_optax(toy):
    """make_train_step against optax's update of JAX's grads: the G
    optimizer steps netE (every E weight moves), and every updated G, E
    and D param is within 1e-3 lr where its |g| > 1e-3 max|g| of its leaf
    (and the leaf is not one of _void's), within 2 lr elsewhere (as
    tests/test_torch_train_step.py)."""
    system = _port(FEAT, toy["params"])
    state = trainer.TrainState(system, *[
        trainer.make_optimizer(p, system.cfg)
        for p in trainer._split_params(system)])
    assert {id(p) for p in system.netE.parameters()} <= {
        id(p) for g in state.opt_g.param_groups for p in g["params"]}
    before = {k: {n: p.detach().clone().numpy() for n, p in
                  net.named_parameters()} for k, net in _nets(system).items()}
    trainer.make_train_step(system)(state, _batch(toy), toy["noise"])
    for key in NETS:
        net = _nets(system)[key]
        want = _leaves(toy["params1"][key])
        void = _void(key, net)
        for name, p in net.named_parameters():
            g = np.abs(toy["grads"][key][name])
            big = (g > 1e-3 * g.max()) & (name not in void)
            diff = np.abs(p.detach().numpy() - want[name])
            assert diff[big].max(initial=0) <= 1e-3 * LR, (key, name)
            assert diff.max() <= 2 * LR, (key, name)
            if key == "E" and name.endswith("weight"):
                moved = np.abs(p.detach().numpy() - before[key][name])
                assert moved.max() > 0.5 * LR, name


def test_fix_global_keeps_training_e(toy):
    """A fix-global step zeroes G's non-enhancer grads but not netE's: E
    moves, as the JAX mask leaves "E" alone."""
    system = _port(FEAT, toy["params"])
    state = trainer.TrainState(system, *[
        trainer.make_optimizer(p, system.cfg)
        for p in trainer._split_params(system)])
    before = {n: p.detach().clone() for n, p in system.netE.named_parameters()}
    trainer.make_train_step(system)(state, _batch(toy), toy["noise"],
                                    fix_global=True)
    moved = [n for n, p in system.netE.named_parameters()
             if n.endswith("weight") and not torch.equal(p, before[n])]
    assert len(moved) == len([n for n in before if n.endswith("weight")])


def test_sample_features_matches_jax(tmp_path):
    """sample_features on one clusters file and one numpy generator's draws:
    equal to the JAX package's, ids from 1000 up mapped to id // 1000, an
    id whose label has no clusters left at 0."""
    clusters = {0: np.arange(12, dtype=np.float64).reshape(4, 3) / 7,
                2: -np.arange(6, dtype=np.float64).reshape(2, 3) / 3}
    path = str(tmp_path / "features_clustered_004.npy")
    np.save(path, clusters, allow_pickle=True)
    inst = np.random.default_rng(1).choice([0, 1, 2, 2001, 2002], (2, 8, 4))
    argv = TOY + ["--instance_feat", "--feat_num", "3"]
    jsys = JSystem(jparse(argv, is_train=False, save=False))
    tsys = Pix2PixHDSystem(parse_config(argv, is_train=False, save=False),
                           device="cpu")
    want = jsys.sample_features(inst, path, np.random.default_rng(9))
    got = tsys.sample_features(inst, path, np.random.default_rng(9))
    assert got.dtype == np.float32 and got.shape == (2, 8, 4, 3)
    np.testing.assert_array_equal(got, want)
    assert not got[inst == 1].any() and got[inst == 2001].any()
    np.testing.assert_array_equal(
        tsys.sample_features(inst, path), jsys.sample_features(inst, path))


def test_inference_takes_a_feature_map(toy):
    """inference(feat_map=...) concatenates the map onto the G input, as
    the JAX package's; without one a feature config's G input is too
    narrow and both refuse."""
    params = toy["params"]
    lr = toy["batch"]["label"]
    feat = np.random.default_rng(2).uniform(-1, 1, (2, 64, 16, 3)).astype(
        np.float32)
    jsys = JSystem(jparse(TOY + FEAT, is_train=True, save=False))
    want = np.asarray(jsys.inference(params["G"], jnp.asarray(lr),
                                     jax.random.PRNGKey(21),
                                     feat_map=jnp.asarray(feat))[0])
    # the inference's lr mask draw: split(split(rng)[0], 3)[1]
    # (system.py:180, ops/encoding.py:117-118)
    sub = jax.random.split(jax.random.split(jax.random.PRNGKey(21))[0], 3)[1]
    noise = torch.from_numpy(np.asarray(jax.random.normal(
        sub, (2, int(64 * (1 - 1 / 6.0)), 16, 2), jnp.float32)))
    system = _port(FEAT, params)
    got = system.inference(torch.from_numpy(lr), noise=noise,
                           feat_map=torch.from_numpy(feat))[0].numpy()
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())
    with pytest.raises(ValueError, match="feat_map"):
        system.inference(torch.from_numpy(lr))
    with pytest.raises(Exception):
        jsys.inference(params["G"], jnp.asarray(lr), jax.random.PRNGKey(21))


def _dataset(rng, n=3):
    return [{"image": rng.uniform(0, 1, (32, 16, 2)).astype(np.float32),
             "inst": rng.integers(0, 3, (32, 16, 1)),
             "path": f"/x/item{i}.wav"} for i in range(n)]


def test_feature_tools_match_jax(tmp_path, toy):
    """tools/encode_features_torch.py and precompute_feature_maps_torch.py
    against the JAX tools on one netE and dataset: the per-instance
    features within 1e-5, the same k-means centers, and the same feature
    maps within 1e-5."""
    import encode_features as jenc
    import encode_features_torch as tenc
    import precompute_feature_maps as jpre
    import precompute_feature_maps_torch as tpre
    params = toy["params"]
    jsys = JSystem(jparse(TOY + FEAT, is_train=True, save=False))
    system = _port(FEAT, params)
    data = _dataset(np.random.default_rng(4))
    for d in ("j", "t", "jm", "tm"):
        os.makedirs(tmp_path / d)
    jout = jenc.encode_and_cluster(jsys, params["E"], data, 3, 3, 2,
                                   str(tmp_path / "j"))
    tout = tenc.encode_and_cluster(system, data, 3, 3, 2, str(tmp_path / "t"))
    jf = np.load(tmp_path / "j" / "features.npy", allow_pickle=True).item()
    tf = np.load(tmp_path / "t" / "features.npy", allow_pickle=True).item()
    assert set(jf) == set(tf) == {0, 1, 2}
    for k in jf:
        np.testing.assert_allclose(tf[k], jf[k], atol=1e-5)
    jc = np.load(jout, allow_pickle=True).item()
    tc = np.load(tout, allow_pickle=True).item()
    assert set(jc) == set(tc) and jc
    for k in jc:
        np.testing.assert_allclose(tc[k], jc[k], atol=1e-5)
    np.testing.assert_array_equal(tenc.kmeans(tf[0][:, :-1], 2),
                                  jenc.kmeans(tf[0][:, :-1], 2))
    jpre.precompute(jsys, params["E"], data, str(tmp_path / "jm"))
    tpre.precompute(system, data, str(tmp_path / "tm"))
    for i in range(len(data)):
        a = np.load(tmp_path / "jm" / f"item{i}_feat.npy")
        b = np.load(tmp_path / "tm" / f"item{i}_feat.npy")
        assert b.shape == a.shape == (32, 16, 3)
        np.testing.assert_allclose(b, a, atol=1e-5)


@pytest.mark.parametrize("extra,match", [
    (FEAT + ["--load_features"], "--load_features"),
    (["--output_nc", "1"], "--output_nc"),
])
def test_configs_the_jax_step_fails_on_are_refused(extra, match):
    """--load_features (G's feature channels have no source) and an
    --output_nc other than the spectrogram's channels (D's pairs differ in
    width): the JAX train step fails on both, so the port refuses both,
    saying so."""
    cfg = parse_config(TOY + extra, is_train=True, save=False)
    with pytest.raises(ValueError, match=f"{match}.*JAX package"):
        Pix2PixHDSystem(cfg, device="cpu")


def test_netg_encoder_trains():
    """--netG encoder (the Encoder as G, unpooled), which the JAX package
    trains: a toy CPU step gives finite losses and moves G."""
    cfg = parse_config(TOY + ["--netG", "encoder"], is_train=True, save=False)
    system = Pix2PixHDSystem(cfg, device="cpu")
    assert isinstance(system.netG_train, Encoder)
    state = trainer.init_state(system, 3)
    before = [p.detach().clone() for p in system.netG_train.parameters()]
    batch = {k: torch.randn(2, SEG, generator=torch.Generator()
                            .manual_seed(i)) * 0.2
             for i, k in enumerate(("label", "image"))}
    losses, aux = trainer.make_train_step(system)(
        state, batch, torch.Generator().manual_seed(0))
    assert all(np.isfinite(float(v)) for v in losses.values())
    assert aux["sr"].shape == (2, 64, 16, 2)
    assert any(not torch.equal(a, b) for a, b in
               zip(before, system.netG_train.parameters()))


def test_feature_config_clis_refuse_what_jax_fails_on(tmp_path):
    """generate on a feature config, and train_loop with the in-training
    eval on one, stop before any work: the JAX package's inference takes
    no feature map there and fails."""
    with pytest.raises(SystemExit, match="JAX package"):
        generate.main(TOY + FEAT + [
            "--name", "g", "--checkpoints_dir", str(tmp_path), "--dataroot",
            "missing.wav", "--device", "cpu", "--no_html"])
    corpus = tmp_path / "c"
    corpus.mkdir()
    from pix2pixhdaudiosr_torch.data.wavio import write_wav
    for i in range(4):
        write_wav(str(corpus / f"a{i}.wav"), np.zeros(2000, np.float32), 48000)
    with pytest.raises(SystemExit, match="JAX package"):
        train_loop.main(TOY + FEAT + [
            "--name", "r", "--checkpoints_dir", str(tmp_path), "--dataroot",
            str(corpus), "--device", "cpu", "--no_html",
            "--validation_split", "0.5", "--batchSize", "2"])
    assert not (tmp_path / "r" / "latest_net_G.pth").exists()
