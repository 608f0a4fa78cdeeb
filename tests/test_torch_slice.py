"""The PyTorch port's serving slice against the JAX package (CPU, toy size):
wav in, wav out through the chunked generate loop; the generate CLI, plain,
with --fused_enhancer and with the quantized serving flags (--data_type 8,
--int8_trunk); the jax-free import guard; the checkpoint export tool; the
metrics.

Toy configuration: n_fft 64 / hop 32 / win 64, 480-sample segments (16
frames), LocalEnhancer ngf 4 with 2 downsamples and 1 + 1 blocks, f32.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pix2pixhdaudiosr_tpu.config import parse_config as jparse  # noqa: E402
from pix2pixhdaudiosr_tpu.metrics import compute_metrics as jmetrics  # noqa: E402
from pix2pixhdaudiosr_tpu.system import Pix2PixHDSystem as JSystem  # noqa: E402

from pix2pixhdaudiosr_torch import generate  # noqa: E402
from pix2pixhdaudiosr_torch.config import parse_config  # noqa: E402
from pix2pixhdaudiosr_torch.convert import jax_to_torch_generator  # noqa: E402
from pix2pixhdaudiosr_torch.data.dataset import AudioTestDataset  # noqa: E402
from pix2pixhdaudiosr_torch.data.wavio import read_wav, write_wav  # noqa: E402
from pix2pixhdaudiosr_torch.metrics import compute_metrics  # noqa: E402
from pix2pixhdaudiosr_torch.ops import quant as tquant  # noqa: E402
from pix2pixhdaudiosr_torch.system import Pix2PixHDSystem  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEG = 480
TOY = ["--netG", "local", "--ngf", "4", "--n_downsample_global", "2",
       "--n_blocks_global", "1", "--n_local_enhancers", "1",
       "--n_blocks_local", "1", "--input_nc", "2", "--output_nc", "2",
       "--label_nc", "0", "--no_instance", "--explicit_encoding",
       "--mask_mode", "mode2", "--compute_dtype", "float32",
       "--n_fft", "64", "--hop_length", "32", "--win_length", "64",
       "--segment_length", str(SEG), "--seed", "11"]


def _toy_params(cfg):
    jsys = JSystem(cfg)
    shape = jsys.spectro_shape(1)
    params = jax.jit(jsys.netG.init)(jax.random.PRNGKey(4),
                                     jnp.zeros(shape, jnp.float32))
    return jsys, params


def _jax_mask_noise(seed):
    """The raw normal draw the JAX generate loop's batch at this seed uses:
    k_lr = split(key)[0] (system.py:174), then split(k_lr, 3)[1]
    (encoding.py:117-118)."""
    def noise(offset, shape):
        k_lr, _ = jax.random.split(jax.random.PRNGKey(seed + offset))
        _, sub, _ = jax.random.split(k_lr, 3)
        return torch.from_numpy(np.asarray(
            jax.random.normal(sub, shape, jnp.float32)))
    return noise


def test_slice_wav_to_wav_matches_jax(tmp_path, rng_np):
    """3 segments at batch 2, so the last batch is zero-padded (which shifts
    the batch-global normalization of its real row); same params, same
    noise. Bound: atol 1e-4 * max|wav|."""
    wav = tmp_path / "in.wav"
    write_wav(str(wav), (rng_np.standard_normal(1150) * 0.2).astype(np.float32),
              48000)
    argv = TOY + ["--dataroot", str(wav), "--batchSize", "2"]
    jcfg = jparse(argv, is_train=False, save=False)
    tcfg = parse_config(argv, is_train=False, save=False)
    ds = AudioTestDataset(str(wav), 8000, 48000, SEG)
    segments = ds.segments
    assert segments.shape == (3, SEG)

    jsys, params = _toy_params(jcfg)

    @jax.jit
    def infer(pg, lr_audio, rng):  # generate.py:186-191
        sr_spec, lr_pha, lr_norm, _ = jsys.inference(pg, lr_audio, rng)
        return jsys.codec.imdct_eval(jnp.abs(sr_spec), lr_pha, lr_norm, rng=rng)

    outs, bs = [], 2
    for i in range(0, len(segments), bs):  # generate.py:193-205
        batch = segments[i: i + bs]
        pad = bs - batch.shape[0]
        if pad:
            batch = np.concatenate(
                [batch, np.zeros((pad,) + batch.shape[1:], batch.dtype)])
        out = np.asarray(infer(params, jnp.asarray(batch),
                               jax.random.PRNGKey(jcfg.seed + i)))
        outs.append(out[: out.shape[0] - pad] if pad else out)
    want = np.sqrt(jcfg.up_ratio - 1) * np.concatenate(outs, 0).reshape(-1)

    system = Pix2PixHDSystem(tcfg, device="cpu")
    system.netG.load_state_dict(jax_to_torch_generator(jax.device_get(params)))
    got = generate.generate_segments(system, segments, 2,
                                     _jax_mask_noise(tcfg.seed))
    assert got.shape == want.shape == (3 * SEG,)
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())


def test_seeded_noise_is_per_segment_offset():
    cfg = parse_config(TOY, is_train=False, save=False)
    system = Pix2PixHDSystem(cfg, device="cpu")
    noise = generate.seeded_noise(system, 11)
    torch.testing.assert_close(noise(2, (1, 3)), generate.seeded_noise(
        system, 13)(0, (1, 3)))


def _write_toy_pth(expr_dir, cfg_argv):
    from pix2pixhdaudiosr_torch.utils.checkpoint import save_generator
    jcfg = jparse(cfg_argv, is_train=False, save=False)
    _, params = _toy_params(jcfg)
    system = Pix2PixHDSystem(parse_config(cfg_argv, is_train=False,
                                          save=False), device="cpu")
    system.netG.load_state_dict(jax_to_torch_generator(jax.device_get(params)))
    return save_generator(system.netG, os.path.join(expr_dir, "latest_net_G.pth"))


def test_generate_cli_on_cpu(tmp_path, rng_np):
    """python -m pix2pixhdaudiosr_torch.generate ... --device cpu on a tiny
    wav with a converted .pth: sr_audio.wav at 48 kHz, at least as long as
    the input, and metric.txt."""
    wav = tmp_path / "in.wav"
    n = 1500
    write_wav(str(wav), (rng_np.standard_normal(n) * 0.2).astype(np.float32),
              48000)
    _write_toy_pth(str(tmp_path / "run"), TOY)
    cmd = [sys.executable, "-m", "pix2pixhdaudiosr_torch.generate", *TOY,
           "--name", "run", "--checkpoints_dir", str(tmp_path), "--dataroot",
           str(wav), "--batchSize", "2", "--no_html", "--device", "cpu"]
    res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    for line in ("MSE: ", "SNR_SR: ", "SNR_LR: ", "LSD: ", "SSNR: "):
        assert line in res.stdout
    sr, rate = read_wav(str(tmp_path / "run" / "sr_audio.wav"))
    assert rate == 48000 and sr.shape[1] >= n
    assert np.abs(sr).max() > 0
    lines = (tmp_path / "run" / "metric.txt").read_text().splitlines()
    assert lines[0] == "MSE,SNR_SR,LSD"
    assert all(np.isfinite(float(v)) for v in lines[1].split(","))
    for name in ("lr_audio.wav", "hr_audio.wav"):
        assert (tmp_path / "run" / name).exists()


def test_default_device_without_cuda_raises(tmp_path, monkeypatch):
    """No --device and no CUDA: SystemExit before any work, never a silent
    CPU run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        generate.main(TOY + ["--name", "run", "--checkpoints_dir",
                             str(tmp_path), "--dataroot", "missing.wav",
                             "--no_html"])
    assert not (tmp_path / "run" / "sr_audio.wav").exists()


@pytest.mark.parametrize("extra,item", [
    (["--cp_shards", "2", "--tp_shards", "2"], "cannot be combined"),
    (["--int8_trunk", "--cp_shards", "2"], "not context-parallel-aware"),
    (["--fused_enhancer", "--cp_shards", "2"], "not context-parallel-aware"),
    (["--instance_feat"], "the JAX package's generate and evaluate fail"),
])
def test_unported_options_raise(tmp_path, extra, item):
    """What generate refuses, before any work: the parallel modes'
    combinations the JAX CLI refuses and feature configs (--int8_trunk
    with --tp_shards is served: tests/test_torch_tp.py)."""
    argv = TOY + ["--name", "run", "--checkpoints_dir", str(tmp_path),
                  "--dataroot", "missing.wav", "--device", "cpu", "--no_html",
                  *extra]
    with pytest.raises(SystemExit, match=item):
        generate.main(argv)


@pytest.mark.parametrize("extra", [["--int8_trunk"], ["--data_type", "8"]])
def test_quantized_options_accepted(extra):
    """--int8_trunk and --data_type 8 pass the unported-option gate."""
    cfg = parse_config(TOY + extra + ["--no_html"], is_train=False, save=False)
    generate.check_supported(cfg)
    assert cfg.int8_trunk or cfg.data_type == 8


def _jax_quantized_params(jcfg, params):
    """The generator params as the JAX generate CLI serves them
    (generate.py:152-166): --data_type 8 rounds them through int8 in f32,
    op by op; bf16 serving pre-casts them."""
    from pix2pixhdaudiosr_tpu.ops.quant import (dequantize_params,
                                                quantize_params)
    if jcfg.data_type == 8:
        params = dequantize_params(*quantize_params(params), jnp.float32)
    if jcfg.compute_dtype == "bfloat16":
        params = jax.tree.map(lambda a: a.astype(jnp.bfloat16), params)
    return params


@pytest.mark.parametrize("extra,dtype", [
    (["--int8_trunk"], "float32"),
    (["--data_type", "8"], "float32"),
    (["--data_type", "8", "--int8_trunk"], "float32"),
    (["--data_type", "8", "--int8_trunk"], "bfloat16"),
])
def test_quantized_inference_matches_jax(tmp_path, rng_np, capsys, extra,
                                         dtype):
    """The toy system loaded by generate.load_system with the quantized
    serving flags against the JAX system's inference on the params the JAX
    CLI serves (_jax_quantized_params), same mask noise, batch 2.
    f32: --data_type 8 alone is a plain f32 forward on bit-identical
    weights, so it keeps the plain slice's bound, 1e-4 max|want|. With
    --int8_trunk, the JAX trunk quantizes its activations inside jit after
    f32 layers that round differently from the port's at ~1e-6, and under
    jit XLA may move a weight scale by an ulp: an int8 value on a rounding
    boundary can land one step off, 1/127 of its tensor's max, so the bound
    is 1/127 max|want| (6.5e-6 measured: no step flipped). bf16: the two
    frameworks' plain bf16 layers already sit apart
    (test_fused_enhancer_inference_matches_jax: flax rounds the avg-pool
    sums and each bias add in bf16), so the bound is that plain gap plus
    the same 1/127."""
    argv = TOY + extra + ["--compute_dtype", dtype, "--load_pretrain",
                          str(tmp_path)]
    jcfg = jparse(argv, is_train=False, save=False)
    tcfg = parse_config(argv, is_train=False, save=False)
    jsys, params = _toy_params(jcfg)
    assert (jsys.netG_infer is not jsys.netG) == tcfg.int8_trunk
    lr = (rng_np.standard_normal((2, SEG)) * 0.2).astype(np.float32)
    sr_want, *_ = jax.jit(jsys.inference)(_jax_quantized_params(jcfg, params),
                                          jnp.asarray(lr),
                                          jax.random.PRNGKey(tcfg.seed))
    want = np.asarray(sr_want)

    _write_toy_pth(str(tmp_path), argv)  # the same seeded params
    system = generate.load_system(tcfg, torch.device("cpu"))
    printed = "int8 weight quantization enabled" in capsys.readouterr().out
    assert printed == (tcfg.data_type == 8)
    b, f, t, c = system.spectro_shape(2)
    noise = _jax_mask_noise(tcfg.seed)(0, (b, system.codec.mask_size(f), t, c))
    n = tquant.conv3x3_int8.launches
    sr = system.inference(torch.from_numpy(lr), noise=noise)[0].numpy()
    assert tquant.conv3x3_int8.launches - n == (2 if tcfg.int8_trunk else 0)
    scale = np.abs(want).max()
    err = np.abs(sr - want).max()
    print(f"{extra} {dtype}: max|sr - want| / max|want| = {err / scale:.2e}")
    if dtype == "float32":
        assert err <= (1 / 127 if tcfg.int8_trunk else 1e-4) * scale, \
            err / scale
    else:
        plain_want = np.asarray(jax.jit(jsys.netG.apply)(
            _jax_quantized_params(jcfg, params),
            jsys.encode_input(jnp.asarray(lr), None, jax.random.PRNGKey(
                tcfg.seed))[0].astype(jnp.bfloat16)).astype(jnp.float32))
        getattr(system.netG, "global").int8_blocks = False
        plain = system.inference(torch.from_numpy(lr), noise=noise)[0].numpy()
        plain_err = np.abs(plain - plain_want).max()
        print(f"plain bf16: max|plain - jax plain| / max|want| = "
              f"{plain_err / scale:.2e}")
        assert err <= plain_err + scale / 127, (err, plain_err, scale)


def test_generate_cli_quantized_on_cpu(tmp_path, rng_np, capsys):
    """The generate CLI with --data_type 8 --int8_trunk --device cpu prints
    the quantization line, runs the int8 trunk and writes sr_audio.wav."""
    wav = tmp_path / "in.wav"
    write_wav(str(wav), (rng_np.standard_normal(1500) * 0.2).astype(np.float32),
              48000)
    _write_toy_pth(str(tmp_path / "run"), TOY)
    n = tquant.conv3x3_int8.launches
    audio = generate.main(TOY + [
        "--data_type", "8", "--int8_trunk", "--name", "run",
        "--checkpoints_dir", str(tmp_path), "--dataroot", str(wav),
        "--batchSize", "2", "--no_html", "--device", "cpu"])
    assert "int8 weight quantization enabled" in capsys.readouterr().out
    assert tquant.conv3x3_int8.launches > n
    assert np.isfinite(audio).all() and np.abs(audio).max() > 0
    sr, rate = read_wav(str(tmp_path / "run" / "sr_audio.wav"))
    assert rate == 48000 and sr.shape[1] >= 1500


FUSED = ["--fused_enhancer", "--compute_dtype", "bfloat16"]


def _spy_fused(monkeypatch):
    """Count the generator's calls into the fused enhancer section."""
    from pix2pixhdaudiosr_torch.ops import enhancer
    calls = []
    orig = enhancer.fused_enhancer_section
    monkeypatch.setattr(enhancer, "fused_enhancer_section",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    return calls


def test_fused_enhancer_inference_matches_jax(rng_np, monkeypatch):
    """--fused_enhancer --compute_dtype bfloat16 at batch 128 (the JAX gate
    needs B % 128): the port's system.inference against JAX
    Pix2PixHDSystem.inference (its netG_infer, Pallas in interpret mode),
    same params and mask noise; the lr spectrograms (f32 encode) within
    1e-4. The plain bf16 layers of the two frameworks round at different
    places (flax sums the avg-pool taps and adds each conv bias in bf16),
    which alone moves the sr spectrogram by max|plain - jax plain| (0.11 of
    max|want| in this configuration). Bound: the fused sr spectrogram stays
    within that plus 0.05 max|want|, the JAX package's own fused-vs-plain
    bound, and within 0.05 max|want| of the port's plain path."""
    argv = TOY + FUSED
    jcfg = jparse(argv, is_train=False, save=False)
    tcfg = parse_config(argv, is_train=False, save=False)
    jsys, params = _toy_params(jcfg)
    assert jsys.netG_infer is not jsys.netG
    lr = (rng_np.standard_normal((128, SEG)) * 0.2).astype(np.float32)
    sr_want, _, _, lr_want = jax.jit(jsys.inference)(
        params, jnp.asarray(lr), jax.random.PRNGKey(tcfg.seed))

    system = Pix2PixHDSystem(tcfg, device="cpu")
    system.netG.load_state_dict(jax_to_torch_generator(jax.device_get(params)))
    system.netG.to(dtype=system.dtype, memory_format=torch.channels_last)
    b, f, t, c = system.spectro_shape(128)
    noise = _jax_mask_noise(tcfg.seed)(0, (b, system.codec.mask_size(f), t, c))
    calls = _spy_fused(monkeypatch)
    sr, _, _, lr_spec = system.inference(torch.from_numpy(lr), noise=noise)
    assert calls == [1]
    np.testing.assert_allclose(lr_spec.numpy(), np.asarray(lr_want), atol=1e-4)
    want = np.asarray(sr_want)
    assert sr.dtype == torch.float32 and sr.shape == want.shape

    system.netG.fused_enh_blocks = False
    plain, *_ = system.inference(torch.from_numpy(lr), noise=noise)
    assert calls == [1]
    plain_want = np.asarray(jsys.netG.apply(params, lr_want.astype(
        jnp.bfloat16)).astype(jnp.float32))
    scale = np.abs(want).max()
    plain_err = np.abs(plain.numpy() - plain_want).max()
    assert np.abs(sr.numpy() - want).max() <= plain_err + 0.05 * scale
    assert np.abs(sr.numpy() - plain.numpy()).max() <= 0.05 * scale


def test_generate_cli_fused_enhancer_on_cpu(tmp_path, rng_np, monkeypatch):
    """The generate CLI with --fused_enhancer on the CPU at batch 128 runs
    the fused section's twins and writes its outputs."""
    wav = tmp_path / "in.wav"
    write_wav(str(wav), (rng_np.standard_normal(1500) * 0.2).astype(np.float32),
              48000)
    _write_toy_pth(str(tmp_path / "run"), TOY)
    calls = _spy_fused(monkeypatch)
    audio = generate.main(TOY + FUSED + [
        "--name", "run", "--checkpoints_dir", str(tmp_path), "--dataroot",
        str(wav), "--batchSize", "128", "--no_html", "--device", "cpu"])
    assert calls == [1]  # one batch of 128
    assert np.isfinite(audio).all() and np.abs(audio).max() > 0
    sr, rate = read_wav(str(tmp_path / "run" / "sr_audio.wav"))
    assert rate == 48000 and sr.shape[1] >= 1500


def test_jax_free_imports():
    """In a process where jax, flax, optax and orbax cannot be imported,
    the package (every module) and chip_smoke import, the codec's training
    inverses (to_frames, to_audio and its gradient) and the HiFi-GAN D
    run, the native audio library decodes a FLAC file and resamples, the
    long tail (MDCT4 / IMDCT4, the legacy spectrogram, the Lee DCT, the
    device resampler, VGG19, the UI model) imports and runs, the feature
    tools, the port's other tools (the AOT engine, the checkpoint
    import, the corpus tools, the real-speech corpus, the reference
    outputs' scores, the VCTK preparation, the flagship soak) and the root
    CLI twins import,
    the data package exports the JAX package's data names, and no module
    of the JAX package gets loaded, by name or from a file under
    pix2pixhdaudiosr_tpu/ (a module executed by path under another name),
    and no file under it is mapped into the
    process (/proc/self/maps: its libaudio_pipeline.so); nor do matplotlib
    and PIL, which only the gallery's first render imports."""
    code = (
        "import sys, pkgutil, importlib, os\n"
        "for m in ('jax', 'flax', 'optax', 'orbax'):\n"
        "    sys.modules[m] = None\n"
        "import pix2pixhdaudiosr_torch as p\n"
        "import pix2pixhdaudiosr_torch.generate, pix2pixhdaudiosr_torch.train_loop\n"
        "import pix2pixhdaudiosr_torch.evaluate, pix2pixhdaudiosr_torch.data.flac\n"
        "import pix2pixhdaudiosr_torch.utils.visualizer, pix2pixhdaudiosr_torch.utils.image_pool\n"
        "import pix2pixhdaudiosr_torch.utils.tb_events, pix2pixhdaudiosr_torch.utils.html\n"
        "import pix2pixhdaudiosr_torch.models.hifigan_d as hd, torch\n"
        "from pix2pixhdaudiosr_torch.ops.encoding import CodecConfig, SpectroCodec\n"
        "c = SpectroCodec(CodecConfig(n_fft=64, hop_length=32, win_length=64,\n"
        "    segment_length=480), device='cpu')\n"
        "s, pha, n = c.to_spectro(torch.randn(1, 480), return_frames=True)\n"
        "x = s.requires_grad_(True)\n"
        "c.to_audio(x, n).sum().backward(); c.to_frames(x, n)\n"
        "d = hd.HiFiGANMultiScaleMultiPeriodDiscriminator(periods=(2,), n_scales=1)\n"
        "import numpy as np, tempfile\n"
        "from pix2pixhdaudiosr_torch.data import flac\n"
        "from pix2pixhdaudiosr_torch.runtime import native_audio\n"
        "f = os.path.join(tempfile.mkdtemp(), 'a.flac')\n"
        "flac.write_flac(f, np.zeros(500, np.float32), 48000)\n"
        "assert flac.read_flac(f)[0].shape == (1, 500)\n"
        "assert flac.decodes['native'] == 1\n"
        "native_audio.resample(np.ones(480, np.float32), 48000, 8000)\n"
        "import pix2pixhdaudiosr_torch.ui_model as ui\n"
        "import pix2pixhdaudiosr_torch.models.vgg as vgg\n"
        "from pix2pixhdaudiosr_torch.ops import audio, dctlib, legacy, mdct\n"
        "m4 = mdct.MDCT4(64, 32, 64, device='cpu')\n"
        "mdct.IMDCT4(64, 32, 64, device='cpu')(m4(torch.randn(1, 480)))\n"
        "w = legacy.sine_window(64)\n"
        "legacy.imdct_spectrogram(legacy.mdct_spectrogram(torch.randn(1, 480), w, 64), w)\n"
        "dctlib.idct_lee(dctlib.dct_lee(torch.randn(2, 8)))\n"
        "audio.resample(torch.randn(480), 48000, 8000)\n"
        "vgg.Vgg19Features(device='cpu')(torch.zeros(1, 3, 16, 16))\n"
        "assert ui.get_edges(np.eye(4, dtype=np.int32)).sum() > 0\n"
        "sys.path.insert(0, 'tools')\n"
        "import encode_features_torch, precompute_feature_maps_torch\n"
        "import aot_engine_torch, import_torch_checkpoint_torch\n"
        "import seg_audio_torch, split_dataset_torch\n"
        "import prep_realspeech_torch, score_reference_outputs_torch\n"
        "import fetch_vctk_torch, flagship_soak_torch\n"
        "from pix2pixhdaudiosr_torch.data import (read_wav, write_wav, wav_info,\n"
        "    discover_files, train_val_split, AudioDataset, AudioTestDataset, Loader)\n"
        "import train_torch, generate_audio_torch, eval_matric_torch\n"
        "import chip_smoke\n"
        "for info in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(info.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('pix2pixhdaudiosr_tpu', 'jax', 'flax', 'matplotlib', 'PIL') "
        "and sys.modules[m]]\n"
        "tpu = os.path.realpath('pix2pixhdaudiosr_tpu') + os.sep\n"
        "bad += [m for m, mod in list(sys.modules.items()) if mod is not None "
        "and os.path.realpath(getattr(mod, '__file__', None) or os.sep)"
        ".startswith(tpu)]\n"
        "maps = open('/proc/self/maps').read().split()\n"
        "bad += [f for f in maps if f.startswith(tpu)]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr[-3000:]


def test_export_tool_roundtrips_a_jax_checkpoint(tmp_path):
    """tools/export_torch_generator.py restores a toy Orbax checkpoint and
    writes a .pth that generate loads, carrying the JAX weights."""
    from pix2pixhdaudiosr_tpu.trainer import init_state
    from pix2pixhdaudiosr_tpu.utils.checkpoint import CheckpointManager
    from tools.export_torch_generator import main as export
    from pix2pixhdaudiosr_torch.utils.checkpoint import load_generator

    argv = TOY + ["--name", "ck", "--checkpoints_dir", str(tmp_path)]
    jcfg = jparse(argv, is_train=True, save=False)
    jsys = JSystem(jcfg)
    state = jax.jit(lambda k: init_state(jsys, k, batch=1)[0])(
        jax.random.PRNGKey(9))
    CheckpointManager(jcfg.expr_dir).save(state, "latest")
    path = export(argv)
    assert path == os.path.join(jcfg.expr_dir, "latest_net_G.pth")
    tcfg = parse_config(argv, is_train=False, save=False)
    system = Pix2PixHDSystem(tcfg, device="cpu")
    load_generator(system.netG, tcfg)
    k = np.asarray(state.params["G"]["params"]["enh1_down0"]["Conv_0"]["kernel"])
    np.testing.assert_array_equal(
        system.netG.state_dict()["enh1_down0.Conv_0.weight"].numpy(),
        k.transpose(3, 2, 0, 1))


def test_metrics_match_jax(rng_np):
    hr = rng_np.standard_normal((1, 6000)).astype(np.float32)
    lr = hr + 0.3 * rng_np.standard_normal((1, 6000)).astype(np.float32)
    sr = 0.5 * hr + 0.1 * rng_np.standard_normal((1, 6000)).astype(np.float32)
    got = compute_metrics(torch.from_numpy(hr), torch.from_numpy(lr),
                          torch.from_numpy(sr), 512, 256, 512)
    want = jmetrics(jnp.asarray(hr), jnp.asarray(lr), jnp.asarray(sr),
                    512, 256, 512)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
