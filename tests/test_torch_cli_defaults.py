"""The port's CLIs at their default flags, against the JAX package (CPU,
toy size): FLAC input (data/flac.py, the wav/flac dispatch, a FLAC corpus
in the dataset), the HTML gallery (renders, index.html, the stop where
matplotlib or PIL is missing), the TensorBoard event records, generate's
gallery, the evaluate CLI (its arithmetic against the JAX CLI's, the 2x
and running-mean quirks) and the training CLI at its default cadence
flags.

Toy configuration: tests/test_torch_slice.py's (n_fft 64 / hop 32 / win
64, 480-sample segments, LocalEnhancer ngf 4).
"""

import csv
import os
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pix2pixhdaudiosr_tpu import trainer as jtrainer  # noqa: E402
from pix2pixhdaudiosr_tpu.config import parse_config as jparse  # noqa: E402
from pix2pixhdaudiosr_tpu.data import dataset as jdataset  # noqa: E402
from pix2pixhdaudiosr_tpu.data import flac as jflac  # noqa: E402
from pix2pixhdaudiosr_tpu.data import wavio as jwavio  # noqa: E402
from pix2pixhdaudiosr_tpu.metrics import compute_metrics as jmetrics  # noqa: E402
from pix2pixhdaudiosr_tpu.utils import spectro_img as jspectro  # noqa: E402
from pix2pixhdaudiosr_tpu.utils import tb_events as jtb  # noqa: E402
from pix2pixhdaudiosr_tpu.utils import visualizer as jvis  # noqa: E402

from pix2pixhdaudiosr_torch import evaluate, generate  # noqa: E402
from pix2pixhdaudiosr_torch.config import parse_config  # noqa: E402
from pix2pixhdaudiosr_torch.convert import jax_to_torch_generator  # noqa: E402
from pix2pixhdaudiosr_torch.data import dataset as tdataset  # noqa: E402
from pix2pixhdaudiosr_torch.data import flac as tflac  # noqa: E402
from pix2pixhdaudiosr_torch.data import wavio as twavio  # noqa: E402
from pix2pixhdaudiosr_torch.data.filelist import discover_files  # noqa: E402
from pix2pixhdaudiosr_torch.system import Pix2PixHDSystem  # noqa: E402
from pix2pixhdaudiosr_torch.trainer import make_eval_step  # noqa: E402
from pix2pixhdaudiosr_torch.utils import spectro_img as tspectro  # noqa: E402
from pix2pixhdaudiosr_torch.utils import tb_events as ttb  # noqa: E402
from pix2pixhdaudiosr_torch.utils import visualizer as tvis  # noqa: E402
from test_torch_slice import (ROOT, SEG, TOY, _jax_mask_noise,  # noqa: E402
                              _toy_params, _write_toy_pth)


def _signal(n, ch=1, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 48000.0
    x = np.stack([0.4 * np.sin(2 * np.pi * (300 + 80 * c) * t)
                  + 0.01 * rng.standard_normal(n) for c in range(ch)])
    return x.astype(np.float32)


# ---------------------------------------------------------------- FLAC
@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("ch,subframe,stereo", [
    (1, "auto", "independent"), (1, "fixed3", "independent"),
    (2, "lpc2", "mid-side"), (2, "verbatim", "left-side")])
def test_flac_decode_is_bit_identical_to_jax(tmp_path, writer, ch, subframe,
                                             stereo):
    """Files from either package's write_flac (a partial last block
    included) decode to the very samples JAX's Python decoder gives, whole
    and as a slice, with the same stream info."""
    path = str(tmp_path / "x.flac")
    write = jflac.write_flac if writer == "jax" else tflac.write_flac
    write(path, _signal(9000, ch), 44100, block_size=4096,
          subframe_mode=subframe, stereo_mode=stereo)
    got, rate = tflac.read_flac(path)
    want, jrate = jflac.read_flac(path, use_native=False)
    assert rate == jrate == 44100 and got.shape == (ch, 9000)
    np.testing.assert_array_equal(got, want)
    got, _ = tflac.read_flac(path, frame_offset=4000, num_frames=4500)
    want, _ = jflac.read_flac(path, frame_offset=4000, num_frames=4500,
                              use_native=False)
    np.testing.assert_array_equal(got, want)
    assert tflac.flac_info(path).__dict__ == jflac.flac_info(path).__dict__


def test_wavio_dispatches_flac_as_jax_does(tmp_path):
    """wav_info and read_wav on a .flac: the JAX wavio's WavInfo and
    samples (read with an offset and a count)."""
    path = str(tmp_path / "x.FLAC")
    tflac.write_flac(path, _signal(7000), 48000)
    assert twavio.wav_info(path).__dict__ == jwavio.wav_info(path).__dict__
    got, rate = twavio.read_wav(path, frame_offset=1000, num_frames=3000)
    want, _ = jflac.read_flac(path, frame_offset=1000, num_frames=3000,
                              use_native=False)
    assert rate == 48000
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="convert"):
        twavio.read_wav(str(tmp_path / "x.mp3"))


@pytest.fixture
def mixed_corpus(tmp_path):
    """A FLAC, a wav, a corrupt FLAC and another wav, each a distinct tone."""
    corpus = tmp_path / "mixed"
    corpus.mkdir()
    tflac.write_flac(str(corpus / "a.flac"), _signal(3000, seed=1)[0] * 0.5,
                     48000)
    twavio.write_wav(str(corpus / "b.wav"), _signal(3000, seed=2)[0], 48000)
    (corpus / "c.flac").write_bytes(b"not a flac stream at all" * 10)
    twavio.write_wav(str(corpus / "d.wav"), _signal(3000, seed=3)[0] * 0.3,
                     48000)
    return corpus


def test_dataset_decodes_flac_and_skips_only_a_corrupt_file(mixed_corpus):
    """Each item of a mixed corpus is its own file, the .flac ones
    included; the corrupt .flac falls through to the next file, as in the
    JAX dataset; the samples agree with the JAX dataset's within 1e-5 (its
    resampler may be the native one)."""
    files = discover_files(str(mixed_corpus))
    kw = dict(lr_sampling_rate=8000, hr_sampling_rate=48000,
              segment_length=2000, seed=5, files=files)
    tds = tdataset.AudioDataset(str(mixed_corpus), **kw)
    jds = jdataset.AudioDataset(str(mixed_corpus), **kw)
    assert [os.path.basename(f) for f in files] == ["a.flac", "b.wav",
                                                    "c.flac", "d.wav"]
    names = []
    for i in range(len(files)):
        got, want = tds[i], jds[i]
        assert got["path"] == want["path"]
        names.append(os.path.basename(got["path"]))
        for k in ("image", "label"):
            np.testing.assert_allclose(got[k], want[k], atol=1e-5)
    assert names == ["a.flac", "b.wav", "d.wav", "d.wav"]


def test_flac_corpus_through_the_resample_cache(mixed_corpus, tmp_path):
    """A FLAC file's item through the on-disk cache equals the direct one
    (files shorter than the segment: no random offset either way)."""
    files = discover_files(str(mixed_corpus))
    kw = dict(lr_sampling_rate=8000, hr_sampling_rate=48000,
              segment_length=4000, seed=5, files=files)
    direct = tdataset.AudioDataset(str(mixed_corpus), **kw)[0]
    cached = tdataset.AudioDataset(str(mixed_corpus),
                                   cache_dir=str(tmp_path / "cache"), **kw)
    for _ in range(2):
        item = cached[0]
        for k in ("image", "label"):
            np.testing.assert_allclose(item[k], direct[k], atol=1e-6)


# ---------------------------------------------------------------- gallery
@pytest.mark.parametrize("abs_", [False, True])
def test_compute_visuals_match_jax(rng_np, abs_):
    sp = rng_np.standard_normal((32, 16)).astype(np.float32)
    pha = np.sign(rng_np.standard_normal((32, 16))).astype(np.float32)
    got = tspectro.compute_visuals(sp=sp, pha=pha, abs=abs_)
    want = jspectro.compute_visuals(sp=sp, pha=pha, abs=abs_)
    for g, w in zip(got, want):
        assert g.dtype == np.uint8 and g.ndim == 3
        np.testing.assert_array_equal(g, w)


def _gallery_cfgs(tmp_path, extra=()):
    argv = TOY + ["--name", "gal", *extra]
    return (parse_config(argv + ["--checkpoints_dir", str(tmp_path / "t")],
                         is_train=True, save=False),
            jparse(argv + ["--checkpoints_dir", str(tmp_path / "j")],
                   is_train=True, save=False))


@pytest.mark.parametrize("n_images", [4, 12])
def test_index_html_matches_jax(tmp_path, n_images):
    """Two epochs of the same images give the same web/index.html text
    (one row below 10 images, two from 10 up) and the same image files."""
    tcfg, jcfg = _gallery_cfgs(tmp_path)
    rng = np.random.default_rng(n_images)
    visuals = {f"img{i}": rng.integers(0, 255, (8, 6, 3), dtype=np.uint8)
               for i in range(n_images)}
    pages = []
    for vis_cls, cfg in ((tvis.Visualizer, tcfg), (jvis.Visualizer, jcfg)):
        v = vis_cls(cfg)
        for epoch in (1, 2):
            v.display_current_results(visuals, epoch, epoch * 10)
        web = os.path.join(cfg.expr_dir, "web")
        with open(os.path.join(web, "index.html")) as f:
            pages.append((f.read(), sorted(os.listdir(os.path.join(
                web, "images")))))
    assert pages[0] == pages[1]
    assert pages[0][0].count("<table") == (2 if n_images >= 10 else 1) * 2
    assert len(pages[0][1]) == 2 * n_images


def test_save_images_matches_jax(tmp_path):
    """Visualizer.save_images onto an HTML page: the same page text and
    image files as the JAX Visualizer's."""
    from pix2pixhdaudiosr_tpu.utils.html import HTML as JHTML
    from pix2pixhdaudiosr_torch.utils.html import HTML as THTML
    tcfg, jcfg = _gallery_cfgs(tmp_path)
    rng = np.random.default_rng(3)
    visuals = {"a": rng.integers(0, 255, (8, 6, 3), dtype=np.uint8),
               "none": None,
               "b": rng.integers(0, 255, (4, 4, 3), dtype=np.uint8)}
    pages = []
    for vis_cls, html_cls, cfg in ((tvis.Visualizer, THTML, tcfg),
                                   (jvis.Visualizer, JHTML, jcfg)):
        page = html_cls(os.path.join(cfg.expr_dir, "page"), "t")
        vis_cls(cfg).save_images(page, visuals, "/x/clip_07.wav")
        with open(page.save()) as f:
            pages.append((f.read(), sorted(os.listdir(page.get_image_dir()))))
    assert pages[0] == pages[1]
    assert pages[0][1] == ["clip_07_a.jpg", "clip_07_b.jpg"]


@pytest.mark.parametrize("package", ["matplotlib", "PIL"])
def test_gallery_stops_without_its_packages(tmp_path, monkeypatch, package):
    """With matplotlib or PIL missing, a Visualizer that wants the gallery
    stops, naming the package and --no_html; with --no_html it does not."""
    monkeypatch.setitem(sys.modules, package, None)
    tcfg, _ = _gallery_cfgs(tmp_path)
    with pytest.raises(SystemExit, match=f"{package}.*--no_html"):
        tvis.Visualizer(tcfg)
    tcfg, _ = _gallery_cfgs(tmp_path, ["--no_html"])
    assert not tvis.Visualizer(tcfg).use_html


def test_event_records_match_jax(tmp_path, monkeypatch):
    """The same scalars through both EventWriters, at one wall time: the
    same bytes; through the port's Visualizer under --tf_log: the records
    JAX's reader parses back."""
    monkeypatch.setattr(time, "time", lambda: 1700000000.25)
    scalars = {"G_GAN": 1.5, "D_real": 0.25, "D_fake": 2.0}
    paths = []
    for mod, d in ((ttb, "t"), (jtb, "j")):
        w = mod.EventWriter(str(tmp_path / d))
        w.add_scalars(scalars, 7)
        w.add_scalar("lsd", 1.75, 9)
        paths.append(w.path)
    assert os.path.basename(paths[0]) == os.path.basename(paths[1])
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()
    assert ttb.read_events(paths[0]) == jtb.read_events(paths[1])
    tcfg, _ = _gallery_cfgs(tmp_path, ["--no_html", "--tf_log"])
    v = tvis.Visualizer(tcfg)
    v.plot_current_errors(scalars, 12)
    (log,) = os.listdir(os.path.join(tcfg.expr_dir, "logs"))
    got = jtb.read_events(os.path.join(tcfg.expr_dir, "logs", log))
    assert got == [(k, val, 12) for k, val in scalars.items()]


# ---------------------------------------------------------------- generate
def _wav(tmp_path, rng_np, n=1500):
    wav = tmp_path / "in.wav"
    twavio.write_wav(str(wav), (rng_np.standard_normal(n) * 0.2)
                     .astype(np.float32), 48000)
    return wav


def test_generate_without_no_html_writes_the_gallery(tmp_path, rng_np):
    """The generate CLI at its default (no --no_html) on the CPU writes
    web/index.html with the lr and sr renders under the JAX labels."""
    wav = _wav(tmp_path, rng_np)
    _write_toy_pth(str(tmp_path / "run"), TOY)
    audio = generate.main(TOY + ["--name", "run", "--checkpoints_dir",
                                 str(tmp_path), "--dataroot", str(wav),
                                 "--batchSize", "2", "--device", "cpu"])
    assert np.isfinite(audio).all()
    web = tmp_path / "run" / "web"
    labels = ("lable_spectro", "generated_spectro", "lable_hist",
              "generated_hist")
    assert sorted(os.listdir(web / "images")) == sorted(
        f"epoch001_{k}.jpg" for k in labels)
    page = (web / "index.html").read_text()
    assert all(f">{k}</p>" in page for k in labels)
    assert (tmp_path / "run" / "sr_audio.wav").exists()


def test_generate_gallery_stops_before_work_without_matplotlib(
        tmp_path, rng_np, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    wav = _wav(tmp_path, rng_np)
    _write_toy_pth(str(tmp_path / "run"), TOY)
    with pytest.raises(SystemExit, match="matplotlib.*--no_html"):
        generate.main(TOY + ["--name", "run", "--checkpoints_dir",
                             str(tmp_path), "--dataroot", str(wav),
                             "--device", "cpu"])
    assert not (tmp_path / "run" / "sr_audio.wav").exists()


# ---------------------------------------------------------------- evaluate
def _batches(rng_np, sizes):
    return [{k: (rng_np.standard_normal((b, SEG)) * 0.2).astype(np.float32)
             for k in ("label", "image")} for b in sizes]


def test_evaluate_matches_the_jax_cli_arithmetic(tmp_path, rng_np):
    """evaluate_epochs over 2 epochs of 2 batches (the last partial)
    against the JAX CLI's loop (pix2pixhdaudiosr_tpu/evaluate.py:52-77)
    with its eval_step, the same G and JAX's mask noise: every column of
    both rows within rtol 1e-4 (atol 1e-4 for the near-zero ssnr)."""
    jcfg = jparse(TOY, is_train=False, save=False)
    jsys, params = _toy_params(jcfg)
    jstep = jax.jit(jtrainer.make_eval_step(jsys))
    batches = _batches(rng_np, (2, 1))
    errs, snrs, segs, pesqs, lsds, want = [], [], [], [], [], []
    for _ in range(2):
        for j, data in enumerate(batches):
            sr, _ = jstep(params, jnp.asarray(data["label"]),
                          jax.random.PRNGKey(jcfg.seed + j))
            m, s_sr, _, ss_sr, _, pesq, lsd = jmetrics(
                data["image"], data["label"], 2 * np.asarray(sr), jcfg.n_fft,
                jcfg.hop_length, jcfg.win_length, jcfg.center)
            errs.append(m)
            snrs.append(s_sr)
            segs.append(ss_sr)
            pesqs.append(pesq)
            lsds.append(lsd)
        want.append([np.mean(v) for v in (errs, snrs, segs, pesqs, lsds)])

    system = Pix2PixHDSystem(parse_config(TOY, is_train=False, save=False),
                             device="cpu")
    system.netG.load_state_dict(jax_to_torch_generator(jax.device_get(params)))
    path = str(tmp_path / "eval.csv")
    rows = evaluate.evaluate_epochs(system, make_eval_step(system), batches,
                                    _jax_mask_noise(jcfg.seed), 2, path)
    for row, w in zip(rows, want):
        np.testing.assert_allclose(list(row.values()), w, rtol=1e-4,
                                   atol=1e-4)
    with open(path) as f:
        assert [{k: float(v) for k, v in r.items()}
                for r in csv.DictReader(f)] == rows


def test_evaluate_scores_twice_sr_and_keeps_running_means(monkeypatch):
    """The JAX CLI's quirks: compute_metrics sees 2 * sr_audio; the snr
    column is s_sr alone; row n averages every batch of epochs 1..n."""
    seen, calls = [], iter(range(1, 100))

    def fake_metrics(hr, lr, sr, *args):
        seen.append(sr.clone())
        v = float(next(calls))
        return (v, v, -100.0, v, -100.0, 0.0, v)

    monkeypatch.setattr(evaluate, "compute_metrics", fake_metrics)
    system = Pix2PixHDSystem(parse_config(TOY, is_train=False, save=False),
                             device="cpu")
    outs = []

    def eval_step(lr, noise):
        outs.append(torch.randn(lr.shape))
        return outs[-1], None

    batches = [{"label": np.zeros((2, SEG), np.float32),
                "image": np.zeros((2, SEG), np.float32)}] * 2
    rows = evaluate.evaluate_epochs(system, eval_step, batches,
                                    lambda j, shape: None, 3, os.devnull)
    assert all(torch.equal(s, 2 * o) for s, o in zip(seen, outs))
    # epoch n has scored calls 1..2n
    assert [r["snr"] for r in rows] == [1.5, 2.5, 3.5]
    assert [r["err"] for r in rows] == [r["lsd"] for r in rows]


def test_evaluate_cli_on_cpu_appends_rows(tmp_path, rng_np):
    """python -m pix2pixhdaudiosr_torch.evaluate on a FLAC + wav corpus
    with a .pth: --niter 2 appends two finite rows, and a second run two
    more under the one header."""
    corpus = tmp_path / "corpus"
    corpus.mkdir()
    for i in range(3):
        x = (rng_np.standard_normal(2000) * 0.2).astype(np.float32)
        if i % 2:
            twavio.write_wav(str(corpus / f"a{i}.wav"), x, 48000)
        else:
            tflac.write_flac(str(corpus / f"a{i}.flac"), x, 48000)
    _write_toy_pth(str(tmp_path / "trained"), TOY)
    argv = TOY + ["--name", "ev", "--checkpoints_dir", str(tmp_path),
                  "--load_pretrain", str(tmp_path / "trained"), "--dataroot",
                  str(corpus), "--batchSize", "2", "--niter", "2",
                  "--device", "cpu"]
    rows = evaluate.main(argv)
    assert len(rows) == 2
    res = subprocess.run([sys.executable, "-m",
                          "pix2pixhdaudiosr_torch.evaluate", *argv],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.count("Evaluation:") == 2
    lines = (tmp_path / "ev" / "eval.csv").read_text().splitlines()
    assert lines[0] == "err,snr,snr_seg,pesq,lsd" and len(lines) == 5
    assert all(np.isfinite([float(v) for v in ln.split(",")]).all()
               for ln in lines[1:])


# ---------------------------------------------------------------- training
def test_train_loop_at_its_default_cadence_flags(tmp_path):
    """python -m pix2pixhdaudiosr_torch.train_loop with no --no_html,
    --validation_split or --eval_freq on the CPU: 210 files (a 0.05 split
    keeps 10 for the eval), batch 200, 10 one-step epochs, so the default
    eval_freq of 2000 samples falls on the last step, as does the one
    display (--display_freq 2000); the PatchGAN at ndf 4. It writes
    loss_log.txt, one eval.csv row, web/index.html and, under --tf_log, an
    event file. One torch thread: the toy step gains nothing from more,
    and they contend with the other test workers."""
    corpus = tmp_path / "corpus"
    corpus.mkdir()
    rng = np.random.default_rng(0)
    for i in range(210):
        twavio.write_wav(str(corpus / f"a{i:03d}.wav"),
                         (rng.standard_normal(500) * 0.2).astype(np.float32),
                         48000)
    argv = TOY + ["--name", "run", "--checkpoints_dir", str(tmp_path),
                  "--dataroot", str(corpus), "--batchSize", "200", "--niter",
                  "10", "--niter_decay", "0", "--display_freq", "2000",
                  "--ndf", "4", "--tf_log", "--device", "cpu"]
    res = subprocess.run([sys.executable, "-m",
                          "pix2pixhdaudiosr_torch.train_loop", *argv],
                         cwd=ROOT, capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stderr[-3000:]
    run = tmp_path / "run"
    assert "#evaluating data = 10" in res.stdout
    log = (run / "loss_log.txt").read_text()
    assert log.count("(epoch: ") == 10   # every lcm(100, 200) samples
    rows = (run / "eval.csv").read_text().splitlines()
    assert len(rows) == 2 and np.isfinite(
        [float(v) for v in rows[1].split(",")]).all()
    assert (run / "web" / "index.html").exists()
    assert len(os.listdir(run / "web" / "images")) == 9   # one display
    (events,) = os.listdir(run / "logs")
    assert len(jtb.read_events(str(run / "logs" / events))) == 10 * 4
    assert (run / "latest_net_G.pth").exists()   # save_latest_freq 500
