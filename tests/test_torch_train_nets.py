"""The PyTorch port's training modules against the JAX package (CPU, toy
sizes): the PatchGAN discriminators against flax, every loss against
losses.py, the InstanceNorm Function's backward against jax.grad of
layers.instance_norm + activation, the hr encode, and the training data
path (file list, split, dataset, loader). Inputs come from numpy seeds;
the JAX side is NHWC, the port's modules take NCHW views of it.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flax.linen as nn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pix2pixhdaudiosr_tpu import losses as jlosses  # noqa: E402
from pix2pixhdaudiosr_tpu.data import dataset as jdataset  # noqa: E402
from pix2pixhdaudiosr_tpu.data import filelist as jfilelist  # noqa: E402
from pix2pixhdaudiosr_tpu.models import discriminator as jdisc  # noqa: E402
from pix2pixhdaudiosr_tpu.models import layers as jlayers  # noqa: E402
from pix2pixhdaudiosr_tpu.ops.encoding import CodecConfig as JCodecConfig  # noqa: E402
from pix2pixhdaudiosr_tpu.ops.encoding import SpectroCodec as JCodec  # noqa: E402

from pix2pixhdaudiosr_torch import losses as tlosses  # noqa: E402
from pix2pixhdaudiosr_torch.convert import jax_to_torch_discriminator  # noqa: E402
from pix2pixhdaudiosr_torch.data import dataset as tdataset  # noqa: E402
from pix2pixhdaudiosr_torch.data import filelist as tfilelist  # noqa: E402
from pix2pixhdaudiosr_torch.data.wavio import write_wav  # noqa: E402
from pix2pixhdaudiosr_torch.models import layers as tlayers  # noqa: E402
from pix2pixhdaudiosr_torch.models.discriminator import build_discriminator  # noqa: E402
from pix2pixhdaudiosr_torch.ops import norm  # noqa: E402
from pix2pixhdaudiosr_torch.ops.encoding import CodecConfig, SpectroCodec  # noqa: E402


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("num_d,n_layers,sigmoid,interm", [
    (2, 3, False, True), (2, 2, True, True), (3, 3, False, False)])
def test_discriminator_matches_flax(rng_np, num_d, n_layers, sigmoid, interm):
    """Every scale's every output (or the score alone) against flax's
    MultiscaleDiscriminator on flax-initialised params, f32, ndf 8, within
    atol 1e-5 * max|out| per output."""
    x = rng_np.standard_normal((2, 64, 16, 4)).astype(np.float32)
    jd = jdisc.build_discriminator(4, 8, n_layers, sigmoid, num_d, interm)
    params = jd.init(jax.random.PRNGKey(1), jnp.asarray(x))
    want = jd.apply(params, jnp.asarray(x))
    td = build_discriminator(4, 8, n_layers, sigmoid, num_d, interm)
    td.load_state_dict(jax_to_torch_discriminator(jax.device_get(params)))
    with torch.no_grad():
        got = td(nchw(x))
    assert len(got) == len(want) == num_d
    for g_scale, w_scale in zip(got, want):
        assert len(g_scale) == len(w_scale) == (n_layers + 2 if interm else 1)
        for g, w in zip(g_scale, w_scale):
            w = np.asarray(w)
            assert nhwc(g).shape == w.shape
            np.testing.assert_allclose(nhwc(g), w,
                                       atol=1e-5 * np.abs(w).max())


def test_discriminator_param_count_and_names():
    """5,531,522 parameters at the defaults (input 4, ndf 64, 3 layers, 2
    scales; tests/test_networks.py:48-55), under flax's names."""
    d = build_discriminator(4, 64, 3, False, 2, True, device="meta")
    assert sum(p.numel() for p in d.parameters()) == 5_531_522
    names = [n for n, _ in d.named_parameters()]
    assert names[0] == "scale1.ConvIN_0.Conv_0.weight"
    assert names[-1] == "scale0.ConvIN_4.Conv_0.bias"


def _preds(rng_np, num_d=2, n_feats=4, lo=0.0, hi=1.0):
    return [[rng_np.uniform(lo, hi, (2, 5 + i, 3 + j, 1 + j)).astype(np.float32)
             for j in range(n_feats)] for i in range(num_d)]


def _t(preds):
    return [[torch.from_numpy(a) for a in s] for s in preds]


def _j(preds):
    return [[jnp.asarray(a) for a in s] for s in preds]


@pytest.mark.parametrize("lsgan", [True, False])
@pytest.mark.parametrize("real", [True, False])
def test_gan_loss_matches_jax(rng_np, lsgan, real):
    """LSGAN and BCE, real and fake targets, over 2 scales, rtol 1e-6; the
    BCE clip at 1e-7 is reached (predictions of 0 and 1)."""
    preds = _preds(rng_np, lo=-0.5, hi=1.5)
    if not lsgan:
        preds = [[np.clip(a, 0.0, 1.0) for a in s] for s in preds]
    got = float(tlosses.gan_loss(_t(preds), real, lsgan))
    want = float(jlosses.gan_loss(_j(preds), real, lsgan))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_gan_loss_takes_bf16_in_f32(rng_np):
    preds = _preds(rng_np)
    tb = [[a.to(torch.bfloat16) for a in s] for s in _t(preds)]
    jb = [[a.astype(jnp.bfloat16) for a in s] for s in _j(preds)]
    got = tlosses.gan_loss(tb, True)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(jlosses.gan_loss(jb, True)),
                               rtol=1e-6)


def test_feature_matching_and_match_loss_match_jax(rng_np):
    fake, real = _preds(rng_np), _preds(rng_np)
    got = float(tlosses.feature_matching_loss(_t(fake), _t(real), 3, 2, 10.0))
    want = float(jlosses.feature_matching_loss(_j(fake), _j(real), 3, 2, 10.0))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    frames = rng_np.standard_normal((2, 9, 64)).astype(np.float32)
    window = rng_np.uniform(0, 1, 64).astype(np.float32)
    got = float(tlosses.match_loss(torch.from_numpy(frames),
                                   torch.from_numpy(window), 64, 10.0))
    want = float(jlosses.match_loss(jnp.asarray(frames), jnp.asarray(window),
                                    64, 10.0))
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("flags", [(True, False, False, False),
                                   (False, True, True, True)])
def test_loss_filter_matches_jax(flags):
    assert tlosses.LOSS_NAMES == jlosses.LOSS_NAMES
    assert tlosses.loss_filter_flags(*flags) == jlosses.loss_filter_flags(*flags)
    losses = {n: float(i) for i, n in enumerate(tlosses.LOSS_NAMES)}
    f = tlosses.loss_filter_flags(*flags)
    assert tlosses.filter_losses(losses, f) == jlosses.filter_losses(losses, f)


def _jax_in_grad(x, w, act):
    """jax.grad of sum(w * act(layers.instance_norm(x))), x NHWC."""
    acts = {"none": lambda y: y, "relu": nn.relu,
            "leaky": lambda y: nn.leaky_relu(y, 0.2)}

    def f(x_):
        return jnp.sum(w * acts[act](jlayers.instance_norm(x_)))
    return np.asarray(jax.grad(f)(jnp.asarray(x)))


@pytest.mark.parametrize("act", ["none", "relu", "leaky"])
@pytest.mark.parametrize("crop", [False, True])
def test_in_function_backward_matches_jax(rng_np, act, crop):
    """The InstanceNorm Function's backward (through layers.instance_norm,
    f32) against jax.grad of layers.instance_norm + activation, within
    1e-5 * max|dx|, on a channels_last tensor and on the same-mode deconv's
    crop of one (the grad then has the full tensor's shape, zero outside
    the view)."""
    x = (rng_np.standard_normal((2, 16, 12, 8)) * 3 + 2).astype(np.float32)
    w = rng_np.standard_normal((2, 16, 12, 8)).astype(np.float32)
    want = _jax_in_grad(x, jnp.asarray(w), act)
    if crop:
        full = np.pad(x, ((0, 0), (0, 1), (0, 1), (0, 0)), constant_values=9.)
        xt = nchw(full).contiguous(memory_format=torch.channels_last)
        xt.requires_grad_(True)
        view = xt[..., :16, :12]
    else:
        xt = nchw(x).contiguous(memory_format=torch.channels_last)
        xt.requires_grad_(True)
        view = xt
    y = tlayers.instance_norm(view, act)
    assert type(y.grad_fn).__name__ == "InstanceNormActBackward"
    (y * nchw(w)).sum().backward()
    got = nhwc(xt.grad)
    if crop:
        assert not got[:, 16:].any() and not got[:, :, 12:].any()
        got = got[:, :16, :12]
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


def test_in_function_backward_bf16_matches_jax(rng_np):
    """bf16 in, bf16 out (dx too), statistics in f32: the Function against
    jax.grad of the bf16 instance_norm + leaky, within 2 bf16 ulps of
    max|dx| (each side rounds dx once to bf16 after an f32 computation in
    its own order)."""
    x = (rng_np.standard_normal((2, 16, 12, 8)) * 3 + 2).astype(np.float32)
    w = rng_np.standard_normal((2, 16, 12, 8)).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(_jax_in_grad(xb, jnp.asarray(w).astype(jnp.bfloat16),
                                   "leaky").astype(np.float32))
    xt = nchw(x).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last).requires_grad_(True)
    y = tlayers.instance_norm(xt, "leaky")
    assert y.dtype == torch.bfloat16
    (y * nchw(w).to(torch.bfloat16)).sum().backward()
    assert xt.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(nhwc(xt.grad.float()), want,
                               atol=2 * 2 ** -8 * np.abs(want).max())


def test_in_function_is_skipped_without_grad(monkeypatch):
    """Under no_grad, or on an input that needs no grad, instance_norm
    calls the plain wrapper once and records nothing; with grad it calls it
    once in the forward and not at all in the backward."""
    calls = []
    orig = norm.instance_norm_act

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)
    monkeypatch.setattr(norm, "instance_norm_act", spy)
    monkeypatch.setattr(tlayers, "instance_norm_act", spy)
    x = torch.randn(2, 4, 6, 5).contiguous(memory_format=torch.channels_last)
    xg = x.clone().requires_grad_(True)
    with torch.no_grad():
        assert tlayers.instance_norm(xg, "relu").grad_fn is None
    assert tlayers.instance_norm(x, "relu").grad_fn is None
    assert len(calls) == 2
    y = tlayers.instance_norm(xg, "relu")
    assert len(calls) == 3 and y.grad_fn is not None
    y.sum().backward()
    assert len(calls) == 3 and xg.grad is not None


def test_hr_encode_matches_jax(rng_np):
    """to_spectro(mask=False), the hr side of the train step's encode,
    against the JAX codec: spectrogram and sign phase, toy codec."""
    cc = dict(n_fft=64, hop_length=32, win_length=64, segment_length=480,
              explicit_encoding=True, mask_mode="mode2")
    hr = (rng_np.standard_normal((2, 480)) * 0.2).astype(np.float32)
    spec, pha, norm_p = SpectroCodec(CodecConfig(**cc), device="cpu") \
        .to_spectro(torch.from_numpy(hr), mask=False)
    jspec, jpha, jnorm = JCodec(JCodecConfig(**cc)).to_spectro(
        jnp.asarray(hr), mask=False)
    np.testing.assert_allclose(spec.numpy(), np.asarray(jspec), atol=1e-5)
    np.testing.assert_array_equal(pha.numpy(), np.asarray(jpha))
    for k in ("max", "min", "mean", "std"):
        np.testing.assert_allclose(float(norm_p[k]), float(jnorm[k]),
                                   rtol=1e-5)


@pytest.fixture
def corpus(tmp_path):
    rng = np.random.default_rng(3)
    root = tmp_path / "corpus"
    (root / "sub").mkdir(parents=True)
    for i, n in enumerate((3000, 5000, 900, 4000, 6000)):
        d = root / "sub" if i % 2 else root
        write_wav(str(d / f"f{i}.wav"),
                  (rng.standard_normal(n) * 0.2).astype(np.float32), 48000)
    (root / "notes.txt").write_text("not audio")
    (root / "broken.wav").write_bytes(b"RIFFxxxx")
    return root


def test_file_list_and_split_match_jax(corpus, tmp_path):
    files = tfilelist.discover_files(str(corpus))
    assert files == jfilelist.discover_files(str(corpus))
    assert len(files) == 6
    path = str(tmp_path / "val.json")
    split = tfilelist.train_val_split(len(files), 0.5, 7, path)
    assert split == jfilelist.train_val_split(len(files), 0.5, 7)
    assert tfilelist.train_val_split(len(files), 0.0, 1, path) == split


def test_dataset_matches_jax(corpus):
    """AudioDataset items against the JAX dataset's from the same seed (the
    same random offsets; the broken file skipped for the next), within 1e-5
    (the JAX resampler may be the native one, tests/test_native_audio.py),
    and the same items again through a cache directory."""
    files = tfilelist.discover_files(str(corpus))
    kw = dict(lr_sampling_rate=8000, hr_sampling_rate=48000,
              segment_length=2000, seed=5, files=files)
    tds = tdataset.AudioDataset(str(corpus), **kw)
    jds = jdataset.AudioDataset(str(corpus), **kw)
    broken = files.index(str(corpus / "broken.wav"))
    for i in list(range(len(files))) * 2:
        got, want = tds[i], jds[i]
        assert got["path"] == want["path"]
        assert got["path"] == files[(i + (i == broken)) % len(files)]
        for k in ("image", "label"):
            assert got[k].shape == (2000,) and got[k].dtype == np.float32
            np.testing.assert_allclose(got[k], want[k], atol=1e-5)
    cached = tdataset.AudioDataset(str(corpus), cache_dir=str(corpus / "c"),
                                   **kw)
    jcached = jdataset.AudioDataset(str(corpus), cache_dir=str(corpus / "j"),
                                    **kw)
    for i in range(len(files)):
        got, want = cached[i], jcached[i]
        for k in ("image", "label"):
            np.testing.assert_allclose(got[k], want[k], atol=1e-5)


class _Indexed:
    """A dataset whose item i is a row of i's."""

    def __getitem__(self, i):
        return {"image": np.full(3, i, np.float32),
                "label": np.full(3, -i, np.float32), "path": str(i)}


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, False)])
def test_loader_matches_jax_in_order(shuffle, drop_last):
    """The threaded Loader (4 threads) delivers the JAX Loader's batches,
    in order, for two epochs (reshuffled from seed + epoch)."""
    ds = _Indexed()
    kw = dict(batch_size=3, shuffle=shuffle, seed=9, drop_last=drop_last)
    tl = tdataset.Loader(ds, range(11), n_threads=4, **kw)
    jl = jdataset.Loader(ds, range(11), n_threads=1, **kw)
    assert len(tl) == len(jl) == (3 if drop_last else 4)
    epochs = []
    for _ in range(2):
        got, want = list(tl), list(jl)
        assert [b["path"] for b in got] == [b["path"] for b in want]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["image"], w["image"])
            np.testing.assert_array_equal(g["label"], w["label"])
        epochs.append([b["path"] for b in got])
    assert (epochs[0] != epochs[1]) == shuffle
