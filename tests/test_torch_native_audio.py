"""The PyTorch port's native host audio pipeline (runtime/native_audio.py,
its own g++ build of runtime/native/audio_pipeline.cpp) on the CPU: the
resampler against the port's and the JAX package's numpy resample_np at
atol 1e-5, the batch pair builder, the PCM decoder, the FLAC decoder bit
for bit against the port's Python decoder in every subframe type and
stereo mode write_flac emits (counted by route), the build's key and its
failure, and the dataset's use of it. Needs g++.
"""

import numpy as np
import pytest

from pix2pixhdaudiosr_tpu.ops.audio import resample_np as jresample_np

from pix2pixhdaudiosr_torch.data import dataset as tdataset
from pix2pixhdaudiosr_torch.data import flac
from pix2pixhdaudiosr_torch.data.wavio import write_wav
from pix2pixhdaudiosr_torch.ops.audio import resample_np
from pix2pixhdaudiosr_torch.runtime import native_audio


def _sig(n, ch=1, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 48000.0
    x = np.stack([0.4 * np.sin(2 * np.pi * (220 + 110 * c) * t)
                  + 0.02 * rng.standard_normal(n) for c in range(ch)])
    return x.astype(np.float32)


@pytest.mark.parametrize("orig,new", [(48000, 8000), (8000, 48000),
                                      (44100, 48000), (22050, 16000)])
def test_resample_matches_numpy(orig, new):
    """Native resample of 1.3 s at orig against both numpy resample_np
    (the port's and the JAX package's) at atol 1e-5, the same length."""
    x = _sig(int(1.3 * orig))[0]
    got = native_audio.resample(x, orig, new)
    assert got.dtype == np.float32
    for want in (resample_np(x, orig, new), jresample_np(x, orig, new)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-5)


def test_resample_down_up_pair_and_threads():
    """48 k -> 8 k -> 48 k against the numpy chain at atol 1e-5; with one
    OpenMP thread the output is the same bits (each sample is one dot)."""
    x = _sig(48000, seed=3)[0]
    got = native_audio.resample(native_audio.resample(x, 48000, 8000),
                                8000, 48000)
    want = resample_np(resample_np(x, 48000, 8000), 8000, 48000)
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got, jresample_np(jresample_np(
        x, 48000, 8000), 8000, 48000), atol=1e-5)
    try:
        native_audio.set_threads(1)
        one = native_audio.resample(native_audio.resample(x, 48000, 8000),
                                    8000, 48000)
    finally:
        native_audio.set_threads(0)
    np.testing.assert_array_equal(one, got)


def test_make_pair_batch_matches_numpy():
    """The batch builder (hr = orig -> 48 k, lr = orig -> 8 k -> 48 k, cut
    or zero-padded) against the numpy chain per item at atol 1e-5."""
    seg = 5000
    lens = np.array([3000, 7000], np.int64)
    wavs = np.zeros((2, 7000), np.float32)
    for i, n in enumerate(lens):
        wavs[i, :n] = _sig(int(n), seed=i)[0]
    hr, lr = native_audio.make_pair_batch(wavs, lens, 16000, 8000, 48000, seg)
    for i, n in enumerate(lens):
        x = wavs[i, :n]
        want_hr = resample_np(x, 16000, 48000)[:seg]
        want_lr = resample_np(resample_np(x, 16000, 8000), 8000, 48000)[:seg]
        np.testing.assert_allclose(hr[i, :len(want_hr)], want_hr, atol=1e-5)
        np.testing.assert_allclose(lr[i, :len(want_lr)], want_lr, atol=1e-5)
        assert not hr[i, len(want_hr):].any()


def test_pcm_decode_matches_numpy():
    """The first channel of interleaved 16-bit stereo PCM, / 32768."""
    pcm = np.random.default_rng(2).integers(-32768, 32767, (100, 2),
                                            dtype=np.int16)
    got = native_audio.decode_pcm_first_channel(pcm.tobytes(), fmt=1,
                                                bits=16, nch=2)
    np.testing.assert_array_equal(got, pcm[:, 0].astype(np.float32) / 32768)
    assert native_audio.decode_pcm_first_channel(b"\0" * 8, 2, 16, 1) is None


@pytest.mark.parametrize("kw,n,ch", [
    (dict(subframe_mode="constant"), 5000, 1),
    (dict(subframe_mode="verbatim"), 5000, 1),
    *[(dict(subframe_mode=f"fixed{k}"), 9000, 1) for k in range(5)],
    (dict(subframe_mode="lpc2"), 10000, 1),
    (dict(subframe_mode="auto"), 4096 + 777, 1),
    (dict(stereo_mode="left-side"), 9000, 2),
    (dict(stereo_mode="mid-side"), 9000, 2),
    (dict(stereo_mode="independent"), 9000, 2),
])
def test_flac_decode_bit_equal_to_python(tmp_path, kw, n, ch):
    """read_flac through the C++ decoder equals the Python decoder bit for
    bit, whole and sliced at an offset, and counts one native decode a
    call; use_native=False counts a Python one."""
    x = _sig(n, ch, seed=n)
    if kw.get("subframe_mode") == "constant":
        x = np.full((ch, n), 0.25, np.float32)
    p = str(tmp_path / "a.flac")
    flac.write_flac(p, x, 48000, **kw)
    before = dict(flac.decodes)
    py, rate = flac.read_flac(p, use_native=False)
    nat, rate2 = flac.read_flac(p)
    assert rate == rate2 == 48000 and nat.shape == (ch, n)
    np.testing.assert_array_equal(nat, py)
    a, _ = flac.read_flac(p, frame_offset=1001, num_frames=777)
    b, _ = flac.read_flac(p, frame_offset=1001, num_frames=777,
                          use_native=False)
    np.testing.assert_array_equal(a, b)
    assert flac.decodes["native"] - before["native"] == 2
    assert flac.decodes["python"] - before["python"] == 2


def test_flac_without_a_length_takes_the_python_route(tmp_path):
    """A stream whose STREAMINFO gives no total length (0, allowed by the
    format) is decoded by the Python decoder, and counted so."""
    p = tmp_path / "a.flac"
    flac.write_flac(str(p), _sig(3000), 48000)
    buf = bytearray(p.read_bytes())
    # STREAMINFO's 36-bit total-samples field: low nibble of byte 8+13, 14-17
    buf[8 + 13] &= 0xF0
    buf[8 + 14: 8 + 18] = b"\0\0\0\0"
    p.write_bytes(bytes(buf))
    before = dict(flac.decodes)
    got, _ = flac.read_flac(str(p))
    assert got.shape == (1, 3000)
    assert flac.decodes["python"] - before["python"] == 1
    assert flac.decodes["native"] == before["native"]


def test_build_is_keyed_on_the_cpu_and_raises_on_failure(tmp_path,
                                                         monkeypatch):
    """The build directory changes with the host CPU's signature; a source
    that does not compile raises RuntimeError carrying g++'s stderr, and
    available() says False, with nothing loaded."""
    key = native_audio.build_dir()
    monkeypatch.setattr(native_audio, "_cpu_signature", lambda: b"another")
    assert native_audio.build_dir() != key
    bad = tmp_path / "bad.cpp"
    bad.write_text("int broken(\n")
    monkeypatch.setattr(native_audio, "_SRC", bad)
    monkeypatch.setattr(native_audio, "_BUILD", tmp_path / "build")
    monkeypatch.setattr(native_audio, "_lib", None)
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*error"):
        native_audio.library()
    assert not native_audio.available()
    with pytest.raises(RuntimeError):
        native_audio.resample(np.ones(100, np.float32), 48000, 8000)


def test_dataset_resamples_natively(tmp_path, monkeypatch):
    """AudioDataset and AudioTestDataset resample through the native
    library (three calls an item: orig -> hr, which returns the input at
    48 kHz, orig -> lr, lr -> hr), and a FLAC item decodes natively."""
    calls = []
    real = native_audio.resample

    def counted(x, a, b):
        calls.append((a, b))
        return real(x, a, b)

    monkeypatch.setattr(native_audio, "resample", counted)
    write_wav(str(tmp_path / "a.wav"), _sig(4000, seed=1)[0], 16000)
    flac.write_flac(str(tmp_path / "b.flac"), _sig(4000, seed=2), 48000)
    ds = tdataset.AudioDataset(str(tmp_path), 8000, 48000, 2000, seed=1)
    before = flac.decodes["native"]
    items = [ds[i] for i in range(len(ds))]
    assert flac.decodes["native"] - before == 1
    assert sorted(calls) == sorted([(16000, 48000), (16000, 8000),
                                    (8000, 48000), (48000, 48000),
                                    (48000, 8000), (8000, 48000)])
    for it in items:
        assert it["image"].shape == it["label"].shape == (2000,)
    calls.clear()
    tdataset.AudioTestDataset(str(tmp_path / "a.wav"), 8000, 48000, 2000)
    assert calls == [(16000, 8000), (8000, 48000)]
