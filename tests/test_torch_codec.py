"""The PyTorch port's signal core and codec against the JAX package (CPU).

Inputs are made with numpy from a seed and handed to both; where the JAX
function reaches a Pallas kernel it runs in interpret mode. On the CPU the
port's kernel wrappers run their plain PyTorch twins (ops/mdct_kernels.py),
so these tests pin the twins' math; chip_smoke.py holds the CUDA kernels to
the twins on the card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from pix2pixhdaudiosr_tpu.ops import audio as jaudio  # noqa: E402
from pix2pixhdaudiosr_tpu.ops import dct as jdct  # noqa: E402
from pix2pixhdaudiosr_tpu.ops import framing as jframing  # noqa: E402
from pix2pixhdaudiosr_tpu.ops import window as jwindow  # noqa: E402
from pix2pixhdaudiosr_tpu.ops.encoding import CodecConfig as JCodecConfig  # noqa: E402
from pix2pixhdaudiosr_tpu.ops.encoding import SpectroCodec as JSpectroCodec  # noqa: E402
from pix2pixhdaudiosr_tpu.ops.mdct import IMDCT2 as JIMDCT2  # noqa: E402
from pix2pixhdaudiosr_tpu.ops.mdct import MDCT2 as JMDCT2  # noqa: E402

from pix2pixhdaudiosr_torch.ops import audio as taudio  # noqa: E402
from pix2pixhdaudiosr_torch.ops import dct as tdct  # noqa: E402
from pix2pixhdaudiosr_torch.ops import framing as tframing  # noqa: E402
from pix2pixhdaudiosr_torch.ops import mdct_kernels  # noqa: E402
from pix2pixhdaudiosr_torch.ops import window as twindow  # noqa: E402
from pix2pixhdaudiosr_torch.ops.encoding import CodecConfig, SpectroCodec  # noqa: E402
from pix2pixhdaudiosr_torch.ops.mdct import IMDCT2, MDCT2  # noqa: E402

SEG = 32512
CODECS = [(512, 256), (512, 160)]   # hop | win, and the gcd-cell case


@pytest.fixture
def interpret_pallas(monkeypatch):
    import pix2pixhdaudiosr_tpu.ops.dct_pallas as K
    orig = pl.pallas_call

    def interp_call(*a, **kw):
        kw.setdefault("interpret", True)
        return orig(*a, **kw)

    monkeypatch.setattr(K.pl, "pallas_call", interp_call)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_window_and_bases_are_the_jax_packages():
    for n in (64, 512):
        np.testing.assert_array_equal(twindow.kbdwin(n), jwindow.kbdwin(n))
        np.testing.assert_array_equal(tdct.dct2_basis(n), jdct.dct2_basis(n))
        np.testing.assert_array_equal(tdct.dct3_basis(n), jdct.dct3_basis(n))
    np.testing.assert_array_equal(twindow.resolve_window(None, 8),
                                  jwindow.resolve_window(None, 8))


@pytest.mark.parametrize("win,hop", CODECS + [(400, 256), (512, 96)])
def test_framing_matches_jax(rng_np, win, hop):
    x = rng_np.standard_normal((2, 3001)).astype(np.float32)
    jp = np.asarray(jframing.pad_signal(jnp.asarray(x), hop, True))
    tp = tframing.pad_signal(_t(x), hop, True)
    np.testing.assert_array_equal(tp.numpy(), jp)
    np.testing.assert_array_equal(tframing.frame(tp, win, hop).numpy(),
                                  np.asarray(jframing.frame(jnp.asarray(jp), win, hop)))
    frames = rng_np.standard_normal((2, 17, win)).astype(np.float32)
    ola_t = tframing.overlap_add(_t(frames), hop).numpy()
    ola_j = np.asarray(jframing.overlap_add(jnp.asarray(frames), hop))
    np.testing.assert_allclose(ola_t, ola_j, atol=1e-6)
    np.testing.assert_array_equal(tframing.center_crop(_t(ola_t), win).numpy(),
                                  np.asarray(jframing.center_crop(jnp.asarray(ola_t), win)))


@pytest.mark.parametrize("mode", ["reflect", "replicate"])
def test_pad_modes_match_jax(rng_np, mode):
    x = rng_np.standard_normal((3, 1000)).astype(np.float32)
    np.testing.assert_array_equal(
        tframing.pad_signal(_t(x), 256, True, mode).numpy(),
        np.asarray(jframing.pad_signal(jnp.asarray(x), 256, True, mode)))


@pytest.mark.parametrize("win,hop", CODECS)
def test_mdct2_imdct2_match_jax_xla(rng_np, win, hop):
    """Twins against the JAX package's XLA path: atol 1e-5."""
    w = twindow.kbdwin(win)
    seg = hop * 40
    x = (rng_np.standard_normal((2, seg)) * 0.3).astype(np.float32)
    kw = dict(n_fft=512, hop_length=hop, win_length=win, window=w, center=True)
    spec_t = MDCT2(device="cpu", **kw)(_t(x))
    spec_j = np.asarray(JMDCT2(**kw)(jnp.asarray(x)))
    np.testing.assert_allclose(spec_t.numpy(), spec_j, atol=1e-5)
    # the inverse is fed spectra at the codec's own scale: the forward's
    # output (a standard-normal spectrum would give |out| ~ 35, where f32
    # rounding alone reaches 5e-5)
    spec = spec_j
    rec_t = IMDCT2(device="cpu", out_length=seg, **kw)(_t(spec)).numpy()
    rec_j = np.asarray(JIMDCT2(out_length=seg, **kw)(jnp.asarray(spec)))
    assert rec_t.shape == rec_j.shape == (2, seg)
    np.testing.assert_allclose(rec_t, rec_j, atol=1e-5)


def test_twins_match_fused_pallas_kernels(rng_np, interpret_pallas):
    """Twins against fused_mdct2 / fused_imdct2 (interpret mode) at 512/256,
    atol 1e-5. The Pallas kernels require win % hop == 0, so 512/160 is
    held to the XLA path only (test above)."""
    from pix2pixhdaudiosr_tpu.ops.dct_pallas import fused_imdct2, fused_mdct2
    w = twindow.kbdwin(512)
    x = (rng_np.standard_normal((2, SEG)) * 0.3).astype(np.float32)
    x_pad = tframing.pad_signal(_t(x), 256, True)
    fwd = (w[:, None] * tdct.dct2_basis(512) / 512).astype(np.float32)
    got = mdct_kernels.mdct2(x_pad, _t(fwd), 256).numpy()
    want = np.asarray(fused_mdct2(jnp.asarray(x_pad.numpy()), jnp.asarray(fwd),
                                  hop=256, win=512, t_tile=128))
    np.testing.assert_allclose(got, want, atol=1e-5)
    inv = (tdct.dct3_basis(512) * w[None, :] / 2.0).astype(np.float32)
    spec = np.asarray(want)  # the forward's output, at the codec's scale
    got = mdct_kernels.imdct2(_t(spec), _t(inv), 256).numpy()
    want = np.asarray(fused_imdct2(jnp.asarray(spec), jnp.asarray(inv),
                                   hop=256, win=512))
    assert got.shape == want.shape == (2, 33024)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_twin_roundtrip_f32(rng_np):
    """MDCT2 -> IMDCT2 reconstructs at f32 with MSE < 1e-12, as the JAX
    package's production-path test does."""
    w = twindow.kbdwin(512)
    kw = dict(n_fft=512, hop_length=256, win_length=512, window=w,
              center=True, device="cpu")
    x = (rng_np.standard_normal((2, SEG)) * 0.3).astype(np.float32)
    rec = IMDCT2(out_length=SEG, **kw)(MDCT2(**kw)(_t(x))).numpy()
    assert rec.shape == (2, SEG)
    assert np.mean((rec - x) ** 2) < 1e-12


def test_wrappers_take_twins_on_cpu_and_count_no_launch(rng_np):
    x = _t(rng_np.standard_normal((1, 1024)).astype(np.float32))
    basis = _t(np.eye(512, dtype=np.float32))
    before = (mdct_kernels.mdct2.launches, mdct_kernels.imdct2.launches)
    spec = mdct_kernels.mdct2(x, basis, 256)
    mdct_kernels.imdct2(spec, basis, 256)
    assert (mdct_kernels.mdct2.launches, mdct_kernels.imdct2.launches) == before


@pytest.mark.parametrize("fn", ["mdct2", "imdct2"])
def test_wrappers_refuse_other_devices(fn):
    """Neither CPU nor CUDA: the wrapper raises (no silent twin)."""
    t = torch.empty(2, 3, 512, device="meta")
    basis = torch.empty(512, 512, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        getattr(mdct_kernels, fn)(t[:, 0] if fn == "mdct2" else t, basis, 256)


def test_db_and_spectrogram_match_jax(rng_np):
    x = np.abs(rng_np.standard_normal((2, 50))).astype(np.float32) * 1e-3
    np.testing.assert_allclose(taudio.amplitude_to_db(_t(x)).numpy(),
                               np.asarray(jaudio.amplitude_to_db(jnp.asarray(x))),
                               atol=1e-4)
    d = (rng_np.standard_normal((2, 50)) * 30).astype(np.float32)
    np.testing.assert_allclose(taudio.db_to_amplitude(_t(d)).numpy(),
                               np.asarray(jaudio.db_to_amplitude(jnp.asarray(d))),
                               rtol=1e-5)
    sig = rng_np.standard_normal((2, 4000)).astype(np.float32)
    w = twindow.kbdwin(800)
    got = taudio.spectrogram_power(_t(sig), 1024, 512, 800, w).numpy()
    want = np.asarray(jaudio.spectrogram_power(jnp.asarray(sig), 1024, 512,
                                               800, w))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


def test_resample_np_is_the_jax_packages(rng_np):
    x = rng_np.standard_normal(4801).astype(np.float32)
    for a, b in ((48000, 8000), (8000, 48000), (22050, 48000)):
        np.testing.assert_array_equal(taudio.resample_np(x, a, b),
                                      jaudio.resample_np(x, a, b))


def _jax_mask_noise(key, shape):
    """The raw normal draw JAX's to_spectro makes for the mask (encoding.py:117-118)."""
    _, sub, _ = jax.random.split(key, 3)
    return np.asarray(jax.random.normal(sub, shape, jnp.float32))


@pytest.mark.parametrize("explicit", [True, False])
def test_to_spectro_and_imdct_eval_match_jax(rng_np, explicit):
    """to_spectro (mask mode2, fed JAX's own draw) and imdct_eval: atol 1e-5."""
    kw = dict(n_fft=512, hop_length=256, win_length=512, segment_length=8 * 256,
              explicit_encoding=explicit, mask_mode="mode2")
    jc, tc = JSpectroCodec(JCodecConfig(**kw)), SpectroCodec(CodecConfig(**kw), "cpu")
    audio = (rng_np.standard_normal((3, 8 * 256)) * 0.2).astype(np.float32)
    key = jax.random.PRNGKey(5)
    js, jp, jn = jc.to_spectro(jnp.asarray(audio), rng=key, mask=True)
    c = 2 if explicit else 1
    noise = _jax_mask_noise(key, (3, tc.mask_size(512), js.shape[2], c))
    ts, tp, tn = tc.to_spectro(_t(audio), mask=True, noise=_t(noise))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    for k in ("max", "min", "mean", "std"):
        np.testing.assert_allclose(float(tn[k]), float(jn[k]), rtol=1e-5)
    if not explicit:  # the implicit inverse draws random pseudo-phase signs
        return
    sr = np.abs(rng_np.standard_normal(js.shape)).astype(np.float32) * 0.5
    want = np.asarray(jc.imdct_eval(jnp.asarray(sr), jp, jn))
    got = tc.imdct_eval(_t(sr), tp, tn).numpy()
    assert got.shape == want.shape == (3, 8 * 256)
    np.testing.assert_allclose(got, want, atol=1e-5 * max(1.0, np.abs(want).max()))


def test_to_spectro_draws_from_generator():
    tc = SpectroCodec(CodecConfig(segment_length=8 * 256), "cpu")
    audio = torch.randn(2, 8 * 256, generator=torch.Generator().manual_seed(0))
    a = tc.to_spectro(audio, mask=True, generator=torch.Generator().manual_seed(3))[0]
    b = tc.to_spectro(audio, mask=True, generator=torch.Generator().manual_seed(3))[0]
    assert torch.equal(a, b)
    top = a[:, 512 - tc.mask_size(512):]
    assert float(top.min()) == 0.0 and float(top.max()) == 1.0  # mode2 min/max
    with pytest.raises(ValueError, match="noise shape"):
        tc.to_spectro(audio, mask=True, noise=torch.zeros(2, 3, 9, 2))
