"""The port's DCT family, the MDCT4 codec, the dct_op / idct_op hooks of
MDCT2 / IMDCT2, the legacy MCLT codec and the device resampler against the
JAX package (CPU).

Inputs are made with numpy from a seed and handed to both packages. Every
float64 basis must be the JAX package's bit for bit; every f32 transform
must agree with its JAX function within 1e-5 of max|y|. On the CPU the
codec kernels' wrappers (ops/mdct_kernels.mdct2 / imdct2, which MDCT4,
IMDCT4 and the lapped spectrograms call) run their plain PyTorch twins;
chip_smoke.py holds the CUDA kernels to the twins on the card.
"""

import numpy as np
import pytest
import scipy.fft

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from pix2pixhdaudiosr_tpu.ops import audio as jaudio  # noqa: E402
from pix2pixhdaudiosr_tpu.ops import dct as jdct  # noqa: E402
from pix2pixhdaudiosr_tpu.ops import dctlib as jdctlib  # noqa: E402
from pix2pixhdaudiosr_tpu.ops import legacy as jlegacy  # noqa: E402
from pix2pixhdaudiosr_tpu.ops import mdct as jmdct  # noqa: E402

from pix2pixhdaudiosr_torch.ops import audio as taudio  # noqa: E402
from pix2pixhdaudiosr_torch.ops import dct as tdct  # noqa: E402
from pix2pixhdaudiosr_torch.ops import dctlib as tdctlib  # noqa: E402
from pix2pixhdaudiosr_torch.ops import legacy as tlegacy  # noqa: E402
from pix2pixhdaudiosr_torch.ops import mdct as tmdct  # noqa: E402
from pix2pixhdaudiosr_torch.ops import mdct_kernels  # noqa: E402
from pix2pixhdaudiosr_torch.ops.window import kbdwin  # noqa: E402

SIZES = (8, 64, 512)
REL = 1e-5  # of max|y|, f32


def _close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = np.abs(want).max()
    assert scale > 0
    err = np.abs(got - want).max()
    assert err <= rel * scale, (err, scale)


def _x(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("N", SIZES)
def test_bases_are_the_jax_packages(N):
    """Every float64 basis (and table) the port copied, bit for bit."""
    for name in ("dct2_basis", "dct3_basis", "dct4_basis", "mdct4_basis",
                 "imdct4_basis"):
        np.testing.assert_array_equal(getattr(tdct, name)(N),
                                      getattr(jdct, name)(N))
    for name in ("dst_basis", "idst_basis", "idxct_basis", "idxst_basis"):
        np.testing.assert_array_equal(getattr(tdctlib, name)(N),
                                      getattr(jdctlib, name)(N))
    tl, jl = tdctlib._lee_cos_tables(N), jdctlib._lee_cos_tables(N)
    assert tl.keys() == jl.keys()
    for k in jl:
        np.testing.assert_array_equal(tl[k], jl[k])
    np.testing.assert_array_equal(tlegacy._cmdct_basis(2 * N),
                                  jlegacy._cmdct_basis(2 * N))
    np.testing.assert_array_equal(tlegacy._icmdct_basis(N),
                                  jlegacy._icmdct_basis(N))
    np.testing.assert_array_equal(tlegacy.sine_window(N),
                                  jlegacy.sine_window(N))
    np.testing.assert_array_equal(taudio.lsd_window(N), jaudio.lsd_window(N))


@pytest.mark.parametrize("N", SIZES)
def test_1d_transforms_match_jax(rng_np, N):
    x = _x(rng_np, 3, N)
    for name in ("dct_2n", "idct_2n", "dct_n", "dct_2n_rfft", "idct_2n_rfft"):
        _close(getattr(tdct, name)(torch.from_numpy(x)),
               getattr(jdct, name)(jnp.asarray(x)))
    for name in ("dst", "idst", "idxct", "idxst", "idct_n"):
        _close(getattr(tdctlib, name)(torch.from_numpy(x)),
               getattr(jdctlib, name)(jnp.asarray(x)))
    # the scalings the codec relies on: idct_2n(dct_2n(x)) == 2 x, and the
    # basis products against scipy in float64
    x64 = x.astype(np.float64)
    _close(tdct.dct_2n(torch.from_numpy(x)), scipy.fft.dct(x64, 2) / N)
    _close(tdct.idct_2n(tdct.dct_2n(torch.from_numpy(x))), 2 * x)
    _close(tdctlib.dst(torch.from_numpy(x)), -scipy.fft.dst(x64, 2))


@pytest.mark.parametrize("shape", [(2, 8, 64), (1, 64, 8), (1, 16, 512)])
def test_2d_transforms_match_jax(rng_np, shape):
    x = _x(rng_np, *shape)
    for name in ("dct2d", "idct2d"):
        _close(getattr(tdct, name)(torch.from_numpy(x)),
               getattr(jdct, name)(jnp.asarray(x)))
    for name in ("dst2", "idcct2", "idsct2", "idcst2", "idxst_idct",
                 "idct_idxst"):
        _close(getattr(tdctlib, name)(torch.from_numpy(x)),
               getattr(jdctlib, name)(jnp.asarray(x)))
    _close(tdct.idct2d(tdct.dct2d(torch.from_numpy(x))), x, 1e-4)


@pytest.mark.parametrize("N", SIZES)
def test_lee_matches_jax_and_the_basis_product(rng_np, N):
    x = _x(rng_np, 2, N)
    y = tdctlib.dct_lee(torch.from_numpy(x))
    _close(y, jdctlib.dct_lee(jnp.asarray(x)))
    # dct_lee == dct_n * N, the basis product
    _close(y, tdctlib.dct_n(torch.from_numpy(x)) * N)
    _close(tdctlib.idct_lee(y), jdctlib.idct_lee(jnp.asarray(y.numpy())))
    _close(tdctlib.idct_lee(y), x, 1e-4)


def test_lee_refuses_other_lengths():
    with pytest.raises(ValueError, match="power-of-2"):
        tdctlib.dct_lee(torch.zeros(2, 12))
    with pytest.raises(ValueError, match="power-of-2"):
        tdctlib.idct_lee(torch.zeros(2, 24))


# the README recipe (1024/512, kbd) and the half-size codec
MDCT4_CODECS = [(1024, 512), (512, 256)]


@pytest.mark.parametrize("n_fft,hop", MDCT4_CODECS)
def test_mdct4_imdct4_match_jax_and_the_oracles(rng_np, n_fft, hop):
    win = kbdwin(n_fft)
    kw = dict(n_fft=n_fft, hop_length=hop, win_length=n_fft, window=win,
              center=True)
    seg = 16 * n_fft
    x = _x(rng_np, 2, seg) * 0.3
    fwd = tmdct.MDCT4(device="cpu", **kw)
    inv = tmdct.IMDCT4(device="cpu", out_length=seg, **kw)
    spec = fwd(torch.from_numpy(x))
    assert spec.shape == (2, seg // hop + 1, n_fft // 2)
    _close(spec, jmdct.MDCT4(**kw)(jnp.asarray(x)))
    _close(spec, jmdct.mdct4_np(x, n_fft, hop, win))
    spec_np = spec.numpy()
    rec = inv(spec)
    _close(rec, jmdct.IMDCT4(out_length=seg, **kw)(jnp.asarray(spec_np)))
    _close(rec, jmdct.imdct4_np(spec_np, n_fft, hop, win, out_length=seg))
    assert np.mean((rec.numpy() - x) ** 2) < 1e-12
    # the oracles are the JAX package's, bit for bit
    np.testing.assert_array_equal(tmdct.mdct4_np(x, n_fft, hop, win),
                                  jmdct.mdct4_np(x, n_fft, hop, win))
    np.testing.assert_array_equal(
        tmdct.imdct4_np(spec_np, n_fft, hop, win, out_length=seg),
        jmdct.imdct4_np(spec_np, n_fft, hop, win, out_length=seg))


def test_mdct4_readme_roundtrip_f64():
    """The README recipe through the port's float64 oracles: n_fft 1024,
    hop 512, kbd, centred, a 130816-sample segment -> [257, 512], and the
    reconstruction's MSE at float64 rounding."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal(130816) * 0.2
    win = kbdwin(1024)
    spec = tmdct.mdct4_np(x[None], 1024, 512, win, center=True)
    assert spec.shape == (1, 257, 512)
    rec = tmdct.imdct4_np(spec, 1024, 512, win, center=True, out_length=130816)
    assert np.mean((rec[0] - x) ** 2) < 1e-24


@pytest.mark.parametrize("n_fft,hop", MDCT4_CODECS)
def test_mdct4_takes_the_tensor_core_route(n_fft, hop):
    """The card's route of MDCT4 / IMDCT4 (and of the legacy spectrogram):
    the tensor-core kernels, with planes of the shapes their wrappers
    check, built once by the codec."""
    kw = dict(n_fft=n_fft, hop_length=hop, win_length=n_fft,
              window=kbdwin(n_fft), device="cpu")
    fwd, inv = tmdct.MDCT4(**kw), tmdct.IMDCT4(**kw)
    cols = n_fft // 2
    assert fwd.tc and inv.tc
    assert fwd.basis.shape == (n_fft, cols) and inv.basis.shape == (cols, n_fft)
    mdct_kernels._check_planes("mdct2", fwd.planes, (cols, n_fft))
    mdct_kernels._check_planes("imdct2", inv.planes,
                               (hop, n_fft // hop * cols))
    for p, q in zip(fwd.planes, mdct_kernels.mdct2_planes(fwd.basis)):
        assert torch.equal(p, q)
    basis, planes = tlegacy._spectrogram_operands(
        False, tlegacy.sine_window(2048).tobytes(), 2048, "cpu")
    mdct_kernels._check_planes("mdct2", planes, (1024, 2048))
    basis, planes = tlegacy._spectrogram_operands(
        True, tlegacy.sine_window(2048).tobytes(), 2048, "cpu")
    mdct_kernels._check_planes("imdct2", planes, (1024, 2 * 1024))


def test_mdct4_through_the_kernel_wrappers(rng_np, monkeypatch):
    """MDCT4 and IMDCT4 call mdct_kernels.mdct2 / imdct2 with their planes
    (B1 / B2 on the card), not a bare matmul."""
    calls = []
    for name in ("mdct2", "imdct2"):
        real = getattr(mdct_kernels, name)

        def spy(x, basis, hop, planes=None, _real=real, _name=name):
            calls.append((_name, tuple(basis.shape), planes is not None))
            return _real(x, basis, hop, planes)
        monkeypatch.setattr(tmdct, name, spy)
        monkeypatch.setattr(tlegacy, name, spy)
    kw = dict(n_fft=512, hop_length=256, win_length=512, window=kbdwin(512),
              device="cpu")
    x = torch.from_numpy(_x(rng_np, 1, 4096))
    tmdct.IMDCT4(**kw)(tmdct.MDCT4(**kw)(x))
    win = tlegacy.sine_window(512)
    tlegacy.imdct_spectrogram(tlegacy.mdct_spectrogram(x, win, 512), win)
    assert calls == [("mdct2", (512, 256), True), ("imdct2", (256, 512), True),
                     ("mdct2", (512, 256), True), ("imdct2", (256, 512), True)]


def test_mdct2_imdct2_custom_ops_match_jax(rng_np):
    """MDCT2(dct_op=dct_2n) and IMDCT2(idct_op=idct_2n) against the JAX
    package's custom-op path, the windowed frames of return_ola too."""
    seg = 4064
    kw = dict(n_fft=512, hop_length=256, win_length=384, window=kbdwin(384),
              center=True)
    x = _x(rng_np, 2, seg) * 0.3
    fwd = tmdct.MDCT2(dct_op=tdct.dct_2n, device="cpu", **kw)
    assert fwd.basis is None
    spec, frames = fwd(torch.from_numpy(x), return_ola=True)
    jspec, jframes = jmdct.MDCT2(dct_op=jdct.dct_2n, **kw)(
        jnp.asarray(x), return_ola=True)
    _close(spec, jspec)
    _close(frames, jframes)
    _close(spec, tmdct.MDCT2(device="cpu", **kw)(torch.from_numpy(x)))
    spec_np = spec.numpy()
    rec = tmdct.IMDCT2(idct_op=tdct.idct_2n, out_length=seg, device="cpu",
                       **kw)(spec)
    _close(rec, jmdct.IMDCT2(idct_op=jdct.idct_2n, out_length=seg, **kw)(
        jnp.asarray(spec_np)))
    _close(rec, tmdct.IMDCT2(out_length=seg, device="cpu", **kw)(spec))


@pytest.mark.parametrize("N", SIZES)
def test_legacy_one_frame_transforms_match_jax(rng_np, N):
    x = _x(rng_np, 3, 2 * N)
    X = tlegacy.cmdct(torch.from_numpy(x))
    jX = jlegacy.cmdct(jnp.asarray(x))
    assert X.dtype == torch.complex64 and X.shape == (3, N)
    _close(X.real, np.real(jX))
    _close(X.imag, np.imag(jX))
    _close(tlegacy.icmdct(X), jlegacy.icmdct(jnp.asarray(X.numpy())))
    for name in ("mdct_ortho", "mdst_ortho"):
        _close(getattr(tlegacy, name)(torch.from_numpy(x)),
               getattr(jlegacy, name)(jnp.asarray(x)))
    c = _x(rng_np, 3, N)
    for name in ("imdct_ortho", "imdst_ortho"):
        _close(getattr(tlegacy, name)(torch.from_numpy(c)),
               getattr(jlegacy, name)(jnp.asarray(c)))
    # a real input to icmdct is a complex one with a zero imaginary part
    _close(tlegacy.icmdct(torch.from_numpy(c)),
           jlegacy.icmdct(jnp.asarray(c)))


@pytest.mark.parametrize("window", ["sine", "kbd"])
@pytest.mark.parametrize("frame_length", [64, 512])
def test_legacy_spectrogram_round_trip_matches_jax(rng_np, window, frame_length):
    seg = 8 * frame_length + 100
    w = (tlegacy.sine_window(frame_length) if window == "sine"
         else kbdwin(frame_length))
    x = _x(rng_np, 2, seg) * 0.3
    spec = tlegacy.mdct_spectrogram(torch.from_numpy(x), w, frame_length)
    _close(spec, jlegacy.mdct_spectrogram(jnp.asarray(x), w, frame_length))
    spec_np = spec.numpy()
    rec = tlegacy.imdct_spectrogram(spec, w, out_length=seg)
    _close(rec, jlegacy.imdct_spectrogram(jnp.asarray(spec_np), w,
                                          out_length=seg))
    assert np.mean((rec.numpy() - x) ** 2) < 1e-10


@pytest.mark.parametrize("orig,new,length", [(48000, 8000, 9600),
                                             (8000, 48000, 1601),
                                             (48000, 16000, 4801)])
def test_resample_matches_jax_and_numpy(rng_np, orig, new, length):
    x = _x(rng_np, 2, length)
    got = taudio.resample(torch.from_numpy(x), orig, new)
    assert got.shape == (2, int(np.ceil(length * new / orig)))
    _close(got, jaudio.resample(jnp.asarray(x), orig, new))
    _close(got, taudio.resample_np(x, orig, new))
    same = torch.from_numpy(x)
    assert taudio.resample(same, orig, orig) is same
    _close(taudio.resample(torch.from_numpy(x[0]), orig, new), got[0])
