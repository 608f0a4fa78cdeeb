"""The port's VGG19 feature extractor and loss, the UI editing model, the
inference model and the model factory against the JAX package (CPU).

VGG19 runs at [1, 3, 32, 32] with the JAX module's random init carried
over by convert.jax_to_torch_vgg (flax NHWC slices permuted to NCHW, the
weights converted once). The UI model's generator is a toy GlobalGenerator
(ngf 4, 2 downsamples, 1 block) in f32 with the JAX init carried over by
jax_to_torch_generator; the inference model runs the serving slice's toy
LocalEnhancer on the same mask noise as the JAX package's draw.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pix2pixhdaudiosr_tpu import ui_model as jui  # noqa: E402
from pix2pixhdaudiosr_tpu.config import Config as JConfig  # noqa: E402
from pix2pixhdaudiosr_tpu.config import parse_config as jparse  # noqa: E402
from pix2pixhdaudiosr_tpu.models import vgg as jvgg  # noqa: E402

from pix2pixhdaudiosr_torch import ui_model as tui  # noqa: E402
from pix2pixhdaudiosr_torch.config import Config, parse_config  # noqa: E402
from pix2pixhdaudiosr_torch.convert import (jax_to_torch_generator,  # noqa: E402
                                            jax_to_torch_vgg)
from pix2pixhdaudiosr_torch.models import vgg as tvgg  # noqa: E402
from pix2pixhdaudiosr_torch.system import Pix2PixHDSystem  # noqa: E402


# ---------------------------------------------------------------------------
# VGG19
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def vgg_pair():
    """(JAX Vgg19Features, its params, the port's module with them, x
    [1, 32, 32, 3] NHWC f32)."""
    x = np.random.default_rng(7).standard_normal((1, 32, 32, 3)).astype(
        np.float32)
    jmod = jvgg.Vgg19Features()
    params = jax.jit(jmod.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    tmod = tvgg.Vgg19Features(device="cpu")
    tmod.load_state_dict(jax_to_torch_vgg(jax.device_get(params)))
    return jmod, params, tmod, x


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _slices_close(got, want, rel=1e-4):
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        w = np.asarray(w).transpose(0, 3, 1, 2)   # NHWC -> NCHW
        assert tuple(g.shape) == w.shape
        scale = np.abs(w).max()
        assert scale > 0
        assert np.abs(g.detach().numpy() - w).max() <= rel * scale


def test_vgg19_layout_is_torchvisions():
    m = tvgg.Vgg19Features(device="cpu", generator=torch.Generator().manual_seed(0))
    assert len(m.features) == 30
    kinds = [type(layer).__name__ for layer in m.features]
    assert [i for i, k in enumerate(kinds) if k == "Conv2d"] == list(tvgg.CONV_INDICES)
    assert [i for i, k in enumerate(kinds) if k == "MaxPool2d"] == [4, 9, 18, 27]
    assert kinds[29] == "ReLU"
    outs = m(torch.zeros(1, 3, 64, 64))
    assert [tuple(o.shape) for o in outs] == [
        (1, 64, 64, 64), (1, 128, 32, 32), (1, 256, 16, 16), (1, 512, 8, 8),
        (1, 512, 4, 4)]
    # the init is drawn from the generator: the same seed, the same weights
    again = tvgg.Vgg19Features(device="cpu",
                               generator=torch.Generator().manual_seed(0))
    for a, b in zip(m.state_dict().values(), again.state_dict().values()):
        assert torch.equal(a, b)
    w = m.features[0].weight
    assert w.abs().max() <= 2 * np.sqrt(1 / 27) / .87962566103423978 + 1e-6


def test_vgg19_slices_match_jax(vgg_pair):
    jmod, params, tmod, x = vgg_pair
    want = jax.jit(jmod.apply)(params, jnp.asarray(x))
    with torch.no_grad():
        _slices_close(tmod(_nchw(x)), want)


def test_vgg_loss_matches_jax(vgg_pair):
    jmod, params, tmod, x = vgg_pair
    y = (x * 0.5 + 0.1).astype(np.float32)
    want = float(jvgg.VGGLoss(params)(jnp.asarray(x), jnp.asarray(y)))
    loss = tvgg.VGGLoss(tmod)
    xt = _nchw(x).requires_grad_(True)
    yt = _nchw(y).requires_grad_(True)
    got = loss(xt, yt)
    assert got.item() == pytest.approx(want, rel=1e-5)
    got.backward()
    assert xt.grad is not None and yt.grad is None   # y is detached
    assert loss(xt, xt).item() == pytest.approx(0.0, abs=1e-6)


def test_load_torch_weights_matches_jax(vgg_pair, tmp_path):
    """A torchvision-format .npz (conv5_2 and later included, which both
    loaders skip) loaded by both packages' load_torch_weights: equal
    features."""
    jmod, params, _, x = vgg_pair
    rng = np.random.default_rng(3)
    raw, cin = {}, 3
    conv_w = [64, 64, 128, 128, 256, 256, 256, 256, 512, 512, 512, 512,
              512, 512, 512, 512]
    idx = list(tvgg.CONV_INDICES) + [30, 32, 34]
    for i, co in zip(idx, conv_w):
        raw[f"features.{i}.weight"] = (rng.standard_normal((co, cin, 3, 3))
                                       * np.sqrt(2 / (9 * cin))).astype(np.float32)
        raw[f"features.{i}.bias"] = (rng.standard_normal(co) * 0.01).astype(
            np.float32)
        cin = co
    path = str(tmp_path / "vgg19.npz")
    np.savez(path, **raw)
    jparams = jvgg.load_torch_weights(params, path)
    tmod = tvgg.load_torch_weights(tvgg.Vgg19Features(device="cpu"), path)
    assert torch.equal(tmod.features[28].weight,
                       torch.from_numpy(raw["features.28.weight"]))
    want = jax.jit(jmod.apply)(jparams, jnp.asarray(x))
    with torch.no_grad():
        _slices_close(tmod(_nchw(x)), want)


# ---------------------------------------------------------------------------
# UI model, inference model, factory
# ---------------------------------------------------------------------------
UI_CFG = dict(net_g="global", ngf=4, n_downsample_global=2,
              n_blocks_global=1, ndf=4, n_layers_d=2, input_nc=2,
              output_nc=2, label_nc=0, explicit_encoding=True,
              compute_dtype="float32")


def _edit(ui):
    """The edit sequence of the JAX package's UI test, then more: the maps
    after each step."""
    label = np.zeros((32, 32), np.int32)
    inst = np.zeros((32, 32), np.int32)
    label[8:16, 8:16] = 5
    inst[8:16, 8:16] = 5
    label[20:26, 2:9] = 3
    inst[20:26, 2:9] = 4
    ui.load_maps(label, inst)
    steps = []

    def snap():
        v = ui.get_current_visuals()
        steps.append((v["label"], v["inst"]))
    ui.change_labels((10, 10), (0, 0))
    snap()
    ui.undo()
    snap()
    ui.add_strokes((2, 2), label_tgt=7, bw=1)
    snap()
    ui.add_strokes((31, 0), label_tgt=6, bw=2, save=False)
    snap()
    ui.add_objects((20, 20), 9, np.ones((4, 4)))
    snap()
    ui.add_objects((29, 29), 2, np.eye(5))
    snap()
    ui.change_labels((22, 4), (10, 10))
    snap()
    ui.undo()
    ui.undo()
    snap()
    ui.reset()
    snap()
    ui.undo()
    snap()
    return steps


def test_ui_edit_sequence_matches_jax():
    ui = tui.UIModel()
    ui.initialize(Config(**UI_CFG), device="cpu")
    jmodel = jui.UIModel()
    jmodel.initialize(JConfig(**UI_CFG))
    assert ui.name() == jmodel.name() == "UIModel"
    got, want = _edit(ui), _edit(jmodel)
    assert len(got) == len(want)
    for (gl, gi), (wl, wi) in zip(got, want):
        np.testing.assert_array_equal(gl, wl)
        np.testing.assert_array_equal(gi, wi)
    assert got[-1][0][10, 10] == 5 and got[-1][0][2, 2] == 0


def test_single_forward_matches_jax():
    jmodel = jui.UIModel()
    jmodel.initialize(JConfig(**UI_CFG))
    x = np.random.default_rng(5).standard_normal((2, 32, 16, 2)).astype(
        np.float32)
    params = jax.jit(jmodel.system.netG.init)(jax.random.PRNGKey(2),
                                              jnp.asarray(x))
    jmodel.params_g = params
    want = jmodel.single_forward(x)
    ui = tui.UIModel()
    ui.initialize(Config(**UI_CFG),
                  state_dict=jax_to_torch_generator(jax.device_get(params)),
                  device="cpu")
    got = ui.single_forward(x)
    assert got.dtype == np.float32 and got.shape == want.shape == (2, 32, 16, 2)
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())
    empty = tui.UIModel()
    empty.initialize(Config(**UI_CFG), device="cpu")
    with pytest.raises(RuntimeError, match="load generator params"):
        empty.single_forward(x)


def test_create_model_dispatch():
    cfg = Config(**UI_CFG)
    train = tui.create_model(cfg, device="cpu")
    assert type(train) is Pix2PixHDSystem and train.netD is not None
    infer = tui.create_model(cfg.replace(is_train=False), device="cpu")
    assert isinstance(infer, tui.InferenceModel)
    ui = tui.create_model(cfg.replace(model="ui"), device="cpu")
    assert isinstance(ui, tui.UIModel) and not ui.system.cfg.is_train
    # the JAX factory's choices, kind for kind
    jcfg = JConfig(**UI_CFG)
    assert type(jui.create_model(jcfg)).__name__ == "Pix2PixHDSystem"
    assert type(jui.create_model(jcfg.replace(is_train=False))).__name__ \
        == "InferenceModel"


# the serving slice's toy configuration (tests/test_torch_slice.py)
SEG = 480
TOY = ["--netG", "local", "--ngf", "4", "--n_downsample_global", "2",
       "--n_blocks_global", "1", "--n_local_enhancers", "1",
       "--n_blocks_local", "1", "--input_nc", "2", "--output_nc", "2",
       "--label_nc", "0", "--no_instance", "--explicit_encoding",
       "--mask_mode", "mode2", "--compute_dtype", "float32",
       "--n_fft", "64", "--hop_length", "32", "--win_length", "64",
       "--segment_length", str(SEG), "--seed", "11"]


def test_inference_model_matches_system_and_jax():
    """InferenceModel(lr) is system.inference(lr) on the same noise, and
    both are the JAX package's InferenceModel on that noise's draw."""
    jcfg = jparse(TOY, is_train=False, save=False)
    cfg = parse_config(TOY, is_train=False, save=False)
    jmodel = jui.InferenceModel(jcfg)
    params = jax.jit(jmodel.netG.init)(
        jax.random.PRNGKey(4), jnp.zeros(jmodel.spectro_shape(1), jnp.float32))
    lr = np.random.default_rng(9).standard_normal((2, SEG)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = jax.jit(jmodel.__call__)(params, jnp.asarray(lr), key)

    sd = jax_to_torch_generator(jax.device_get(params))
    model, system = tui.InferenceModel(cfg, device="cpu"), Pix2PixHDSystem(
        cfg, device="cpu")
    model.netG.load_state_dict(sd)
    system.netG.load_state_dict(sd)
    _, f, t, c = model.spectro_shape(2)
    # the JAX draw: split(key)[0] for the lr encode, then split(., 3)[1]
    _, sub, _ = jax.random.split(jax.random.split(key)[0], 3)
    noise = torch.from_numpy(np.array(jax.random.normal(
        sub, (2, model.codec.mask_size(f), t, c), jnp.float32)))
    got = model(torch.from_numpy(lr), noise=noise)
    ref = system.inference(torch.from_numpy(lr), noise=noise)
    assert len(got) == len(want) == 4
    for g, r in zip((got[0], got[1], got[3]), (ref[0], ref[1], ref[3])):
        assert torch.equal(g, r)
    assert got[2].keys() == ref[2].keys()
    for k in ref[2]:
        assert torch.equal(torch.as_tensor(got[2][k]), torch.as_tensor(ref[2][k]))
    # sr_spectro, lr_pha, lr_norm_param, lr_spectro
    for g, w in zip((got[0], got[1], got[3]), (want[0], want[1], want[3])):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4 * np.abs(w).max())
    assert want[2].get("frames") is None   # no time-domain D: no frames
    for k in got[2]:
        np.testing.assert_allclose(np.asarray(got[2][k]), np.asarray(want[2][k]),
                                   rtol=1e-5)


def test_get_edges_matches_jax():
    rng = np.random.default_rng(2)
    for shape in ((6, 6), (2, 9, 7)):
        t = rng.integers(0, 3, shape).astype(np.int32)
        got = tui.get_edges(t)
        np.testing.assert_array_equal(got, jui.get_edges(t))
        assert got.dtype == np.float32
    t = np.zeros((6, 6), np.int32)
    t[2:4, 2:4] = 7
    e = tui.get_edges(t)
    assert e[2, 2] == 1 and e[1, 2] == 1 and e[4, 3] == 1
    assert e[0, 0] == 0 and e[5, 5] == 0
