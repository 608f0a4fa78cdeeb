"""File-to-file chunked inference CLI.

Port of the chunked path of pix2pixhdaudiosr_tpu/generate.py:112-247: load
ONE wav, resample down and up (or only up with --is_lr_input), chop it into
segments, run batches through encode + generator + the eval IMDCT, scale by
sqrt(up_ratio - 1), score MSE/SNR/LSD/SSNR against the raw input, and write
metric.txt, the sr/lr/hr wavs and, unless --no_html, the gallery of the lr
and sr spectrograms (web/index.html) into checkpoints_dir/name/.

    python -m pix2pixhdaudiosr_torch.generate <the JAX CLI's flags> \
        [--device cuda|cpu]

The device defaults to cuda; the CPU runs only when asked for
(--device cpu), and then every kernel runs its plain PyTorch twin.
"""

from __future__ import annotations

import argparse
import os
from typing import Callable

import numpy as np
import torch

from .config import parse_config
from .data.dataset import AudioTestDataset
from .data.wavio import write_wav
from .metrics import compute_metrics, segmental_snr
from .ops.quant import dequantize_state_dict, quantize_state_dict
from .system import Pix2PixHDSystem
from .utils.checkpoint import generator_path, load_generator
from .utils.spectro_img import compute_visuals
from .utils.visualizer import Visualizer

# (condition on the config, what it asks for, the ROADMAP item that brings it)
_NOT_YET = (
    (lambda c: c.cp_shards > 1, "--cp_shards > 1", "parallel modes, ROADMAP A11"),
    (lambda c: c.tp_shards > 1, "--tp_shards > 1", "parallel modes, ROADMAP A11"),
)


def check_supported(cfg) -> None:
    for cond, what, where in _NOT_YET:
        if cond(cfg):
            raise SystemExit(f"{what} is not ported to pix2pixhdaudiosr_torch "
                             f"yet; it comes with {where}")
    if cfg.use_features:
        raise SystemExit(
            "feature configs (--instance_feat / --label_feat): generate and "
            "evaluate call inference with no feature map, so G's input lacks "
            "the feature channels; the JAX package's generate and evaluate "
            "fail on them too")


def resolve_device(name: str) -> torch.device:
    """The run's device. CUDA unless the CPU is asked for by name: a run
    never moves to the CPU on its own."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available; pass --device cpu to run "
                         "the port on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise SystemExit(f"unsupported device {name!r} (cuda or cpu)")
    return device


def seeded_noise(system: Pix2PixHDSystem, seed: int) -> Callable:
    """The mask noise of a batch that starts at segment `offset`: a
    standard-normal draw from a generator seeded with seed + offset."""
    def noise(offset: int, shape) -> torch.Tensor:
        gen = torch.Generator(device=system.device).manual_seed(seed + offset)
        return torch.randn(shape, generator=gen, device=system.device)
    return noise


@torch.no_grad()
def generate_segments(system: Pix2PixHDSystem, segments: np.ndarray,
                      batch_size: int, noise: Callable) -> np.ndarray:
    """[N, segment_length] lr segments -> the sr waveform, N*segment_length
    samples, already scaled by sqrt(up_ratio - 1).

    The last partial batch is zero-padded to batch_size, which changes the
    batch-global spectrogram normalization of its real rows, exactly as in
    the JAX package. `noise(offset, shape)` gives the raw mask draw of the
    batch starting at segment `offset`."""
    cfg = system.cfg
    b, f, t, c = system.spectro_shape(batch_size)
    shape = (b, system.codec.mask_size(f), t, c)
    outs = []
    for i in range(0, len(segments), batch_size):
        batch = segments[i: i + batch_size]
        pad = batch_size - batch.shape[0]
        if pad:
            batch = np.concatenate(
                [batch, np.zeros((pad,) + batch.shape[1:], batch.dtype)])
        lr = torch.from_numpy(np.ascontiguousarray(batch)).to(system.device)
        sr_spec, lr_pha, lr_norm, _ = system.inference(lr, noise=noise(i, shape))
        wav = system.codec.imdct_eval(torch.abs(sr_spec), lr_pha, lr_norm)
        wav = wav.cpu().numpy()
        outs.append(wav[: wav.shape[0] - pad] if pad else wav)
    return np.sqrt(cfg.up_ratio - 1) * np.concatenate(outs, 0).reshape(-1)


@torch.no_grad()
def write_gallery(system: Pix2PixHDSystem, visualizer: Visualizer,
                  lr_audio: np.ndarray, sr_audio: np.ndarray) -> None:
    """The lr input (masked, mask noise seeded with cfg.seed) and the sr
    output re-encoded whole, their channel-mean magnitudes rendered with
    abs=True, written as the gallery's epoch 1 under the JAX package's
    labels (`lable_*` included, pix2pixhdaudiosr_tpu/generate.py:223-236)."""
    dev = system.device
    gen = torch.Generator(device=dev).manual_seed(system.cfg.seed)
    wav = [torch.from_numpy(np.asarray(a, np.float32)[None]).to(dev)
           for a in (lr_audio, sr_audio)]
    specs = (system.encode_input(wav[0], generator=gen)[0],
             system.encode_target(wav[1])[0])
    mags = [(0.5 * (s[0, :, :, 0] + s[0, :, :, 1])
             if system.cfg.explicit_encoding else s[0, :, :, 0]).cpu().numpy()
            for s in specs]
    lr_img, lr_hist, _ = compute_visuals(sp=mags[0], abs=True)
    sr_img, sr_hist, _ = compute_visuals(sp=mags[1], abs=True)
    visualizer.display_current_results(
        {"lable_spectro": lr_img, "generated_spectro": sr_img,
         "lable_hist": lr_hist, "generated_hist": sr_hist}, 1, 1)


def load_system(cfg, device: torch.device) -> Pix2PixHDSystem:
    """Build the system and load the generator of cfg's checkpoint tag; the
    weights are cast once to the compute dtype (the JAX package pre-casts
    its param tree the same way for bf16 serving). --data_type 8 first
    rounds every conv and deconv weight through int8 in f32, as the JAX
    CLI does (pix2pixhdaudiosr_tpu/generate.py:152-158)."""
    system = Pix2PixHDSystem(cfg, device=device)
    load_generator(system.netG, cfg)
    if cfg.data_type == 8:
        qstate, scales = quantize_state_dict(system.netG.state_dict())
        system.netG.load_state_dict(dequantize_state_dict(qstate, scales))
        print("int8 weight quantization enabled")
    system.netG.to(dtype=system.dtype, memory_format=torch.channels_last)
    system.netG.eval()
    return system


def main(argv=None) -> np.ndarray:
    """Run the CLI; returns the sr waveform it wrote."""
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default="cuda")
    args, rest = pre.parse_known_args(argv)
    cfg = parse_config(rest, is_train=False)
    check_supported(cfg)
    device = resolve_device(args.device)
    if device.type == "cuda":
        # f32 convs and matmuls at full precision (the JAX package asks for
        # Precision.HIGHEST); cuDNN picks its fastest algorithm per shape
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.benchmark = True
    # the gallery is on unless --no_html; stops here if its packages are
    # missing
    visualizer = Visualizer(cfg.replace(is_train=True))

    ds = AudioTestDataset(cfg.dataroot, cfg.lr_sampling_rate,
                          cfg.hr_sampling_rate, cfg.segment_length,
                          is_lr_input=cfg.is_lr_input)
    print("Audio length:", ds.audio_len)
    print("#audio segments = %d" % len(ds))

    system = load_system(cfg, device)
    print(f"generator {generator_path(cfg)} on {device} "
          f"({cfg.compute_dtype})")
    audio = generate_segments(system, ds.segments, max(1, cfg.batch_size),
                              seeded_noise(system, cfg.seed))
    audio = audio[: ds.segments.size]

    n = ds.audio_len
    mse, snr_sr, snr_lr, *_, lsd = compute_metrics(
        torch.from_numpy(ds.raw_audio[None, :n]),
        torch.from_numpy(ds.lr_audio[None, :n]),
        torch.from_numpy(audio[None, :n]), cfg.n_fft, cfg.hop_length,
        cfg.win_length, cfg.center)
    print("MSE: %.4f" % mse)
    print("SNR_SR: %.4f" % snr_sr)
    print("SNR_LR: %.4f" % snr_lr)
    print("LSD: %.4f" % lsd)
    print("SSNR: %.4f" % segmental_snr(ds.raw_audio[:n], audio[:n]))

    if visualizer.use_html:
        write_gallery(system, visualizer, ds.lr_audio, audio)

    with open(os.path.join(cfg.expr_dir, "metric.txt"), "w") as f:
        f.write("MSE,SNR_SR,LSD\n")
        f.write("%f,%f,%f" % (mse, snr_sr, lsd))
    write_wav(os.path.join(cfg.expr_dir, "sr_audio.wav"), audio,
              cfg.hr_sampling_rate)
    write_wav(os.path.join(cfg.expr_dir, "lr_audio.wav"), ds.lr_audio,
              cfg.hr_sampling_rate)
    write_wav(os.path.join(cfg.expr_dir, "hr_audio.wav"), ds.raw_audio,
              ds.in_sampling_rate)
    print("wrote outputs to", cfg.expr_dir)
    return audio


if __name__ == "__main__":
    main()
