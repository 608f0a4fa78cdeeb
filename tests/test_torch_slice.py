"""The PyTorch port's serving slice against the JAX package (CPU, toy size):
wav in, wav out through the chunked generate loop; the generate CLI; the
jax-free import guard; the checkpoint export tool; the metrics.

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
    (["--fused_enhancer"], "B4"),
    (["--int8_trunk"], "A10"),
    (["--data_type", "8"], "A10"),
    (["--cp_shards", "2"], "A11"),
    (["--tp_shards", "2"], "A11"),
    (["--instance_feat"], "A9"),
    ([], "A5"),            # without --no_html: the HTML gallery
])
def test_unported_options_raise(tmp_path, extra, item):
    argv = TOY + ["--name", "run", "--checkpoints_dir", str(tmp_path),
                  "--dataroot", "missing.wav", "--device", "cpu", *extra]
    if item != "A5":
        argv.append("--no_html")
    with pytest.raises(SystemExit, match=item):
        generate.main(argv)


def test_flac_input_raises(tmp_path):
    with pytest.raises(ValueError, match="A5"):
        read_wav(str(tmp_path / "x.flac"))


def test_jax_free_imports():
    """In a process where jax, flax, optax and orbax cannot be imported,
    the package (every module) and chip_smoke import, and no module of the
    JAX package gets loaded."""
    code = (
        "import sys, pkgutil, importlib\n"
        "for m in ('jax', 'flax', 'optax', 'orbax'):\n"
        "    sys.modules[m] = None\n"
        "import pix2pixhdaudiosr_torch as p\n"
        "import pix2pixhdaudiosr_torch.generate, chip_smoke\n"
        "for info in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(info.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('pix2pixhdaudiosr_tpu', 'jax', 'flax') and sys.modules[m]]\n"
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
