"""File-to-file inference CLI.

Port of pix2pixhdaudiosr_tpu/generate.py:112-247: load ONE wav, resample
down and up (or only up with --is_lr_input), chop it into segments, run
batches through encode + generator + the eval IMDCT, scale by
sqrt(up_ratio - 1), score MSE/SNR/LSD/SSNR against the raw input, and write
metric.txt, the sr/lr/hr wavs and, unless --no_html, the gallery of the lr
and sr spectrograms (web/index.html) into checkpoints_dir/name/.

    python -m pix2pixhdaudiosr_torch.generate <the JAX CLI's flags> \
        [--device cuda|cuda:i|cpu]
    torchrun --nproc_per_node N -m pix2pixhdaudiosr_torch.generate ... \
        --cp_shards N | --tp_shards N

Its stages run in profiler spans (`generate.read`: read and resample;
`.load`; `.serve`: encode + G + decode; `.metrics`; `.write`), which a
torch.profiler trace around main (utils/profiling.trace) times.

The parallel modes (parallel/): --cp_shards N serves the whole file as one
spectrogram, its frames split over min(N, ranks) ranks (`cp_generate`,
:28-108 of the JAX CLI), with no segment seams; in one process that is
one seamless full-length forward. --tp_shards N splits the resblocks'
channels over min(N, ranks) ranks (parallel/tp.py, :167-176), the int8
trunk's (--int8_trunk) too. Rank 0 writes the outputs. The device
defaults to cuda; the CPU runs only when asked for (--device cpu), and
then every kernel runs its plain PyTorch twin.
"""

from __future__ import annotations

import argparse
import copy
import os
from typing import Callable, Optional

import numpy as np
import torch
from torch.profiler import record_function

from .config import parse_config
from .data.dataset import AudioTestDataset
from .data.wavio import write_wav
from .metrics import compute_metrics, segmental_snr
from .ops.quant import dequantize_state_dict, quantize_state_dict
from .parallel import mesh
from .parallel.halo import cp_block, cp_gather, make_cp_generator
from .parallel.tp import shard_generator
from .system import Pix2PixHDSystem, generator_stride, make_codec
from .utils.checkpoint import generator_path, load_generator
from .utils.spectro_img import compute_visuals, require_gallery_packages
from .utils.visualizer import Visualizer


def check_supported(cfg) -> None:
    """Refuse what the JAX CLI refuses, in its words
    (pix2pixhdaudiosr_tpu/generate.py:78-83, :120-132), and nothing else:
    --tp_shards with --cp_shards; --int8_trunk or --fused_enhancer with
    --cp_shards; feature configs (with --cp_shards, cp_generate's
    message). --int8_trunk with --tp_shards is served (parallel/tp.py)."""
    if cfg.tp_shards > 1 and cfg.cp_shards > 1:
        raise SystemExit("--tp_shards and --cp_shards cannot be combined in "
                         "generate; pick one parallelism for inference")
    if (cfg.int8_trunk or cfg.fused_enhancer) and cfg.cp_shards > 1:
        raise SystemExit("--int8_trunk/--fused_enhancer cannot be combined "
                         "with --cp_shards in generate; these serving "
                         "kernels are not context-parallel-aware")
    if cfg.use_features:
        if cfg.cp_shards > 1:
            raise SystemExit("--cp_shards does not support feature-encoder "
                             "configs (--instance_feat/--label_feat/"
                             "--use_encoded_image); use the chunked path")
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


def plan_cp_padding(length: int, hop: int, win: int, center: bool,
                    shards: int, stride: int):
    """The cp_generate padding contract, as a pure function (copied from
    pix2pixhdaudiosr_tpu/generate.py:28-65): pad a `length`-sample file to
    `need` samples so its frame count `t_frames` divides shards x stride
    under the reference codec pad rule. Returns (need, t_frames).

    `frames_for(seg)` depends on seg only through ceil(seg/hop) =: K:
        frames = K + floor((2*start - win) / hop) + 1,  start = hop|0.
    So for any target t_frames a hop-aligned preimage exists:
        need = (t_frames - 1 - floor((2*start - win) / hop)) * hop,
    including win % hop != 0 configs (e.g. 512/160)."""
    frames = Pix2PixHDSystem.frames_for(length, hop, win, center)
    start = hop if center else 0
    # the decode side reconstructs (t-1)*hop + win samples, center-cropped by
    # 2*(win//2) when centered; for hop | win that equals `need` exactly, but
    # non-dividing codecs come up short (the codec's end-pad rounds past the
    # last frame), so t must also be large enough for the reconstruction to
    # cover the original file
    recon_0 = win - 2 * (win // 2) if center else win     # recon at t = 1
    t_min = max(frames, -(-(length - recon_0) // hop) + 1)
    q = shards * stride                 # per-shard frames must cover stride
    t_frames = -(-t_min // q) * q
    need = (t_frames - 1 - (2 * start - win) // hop) * hop
    if (need < length
            or Pix2PixHDSystem.frames_for(need, hop, win, center) != t_frames):
        # fail loud, not wrong-length: reachable only if frames_for's pad
        # rule ever diverges from the closed form above
        raise RuntimeError(
            f"cp padding plan violated its contract for win={win} hop={hop} "
            f"center={center} length={length} (need={need}, "
            f"t_frames={t_frames}); file a bug — the chunked path "
            f"(--cp_shards 1) still works")
    return need, t_frames


def full_length_system(system: Pix2PixHDSystem, need: int) -> Pix2PixHDSystem:
    """The system with segment_length `need` (its codec's inverse is not
    cropped to a training segment), sharing system's generator."""
    full = copy.copy(system)
    full.cfg = system.cfg.replace(segment_length=need)
    full.codec = make_codec(full.cfg, system.device)
    return full


def cp_forward(forward: Callable, spec: torch.Tensor) -> Optional[
        torch.Tensor]:
    """The generator over spec [B, F, T, C], its frames split over the
    forward's group (and with a batch group, its batch over that: dp x
    cp): this rank's block through `forward` (make_cp_generator), the
    blocks gathered on rank 0 in (data, cp) order (halo.cp_block,
    halo.cp_gather). Returns the sr spectrogram (f32 [B, F, T, C]) on rank
    0, None on the others."""
    groups = forward.group, forward.batch_group
    return cp_gather(forward(cp_block(spec, *groups)), *groups)


@torch.no_grad()
def cp_generate(system: Pix2PixHDSystem, lr_audio: np.ndarray, cfg, group,
                noise: Optional[Callable] = None) -> Optional[np.ndarray]:
    """--cp_shards N: one seamless full-length forward, the frame axis split
    over `group` (pix2pixhdaudiosr_tpu/generate.py:68-108). The file is
    padded (plan_cp_padding) so that its frame count divides shards x the
    generator's stride; rank 0 encodes it whole, so the spectrogram's
    min/max normalization and the mode-2 noise (`noise(0, shape)`, by
    default seeded with cfg.seed) span the whole file, and broadcasts the
    spectrogram; each rank runs its block of frames through the CP
    generator; rank 0 gathers the blocks, decodes the whole file and
    returns it scaled by sqrt(up_ratio - 1). Other ranks return None."""
    hop, win, center = cfg.hop_length, cfg.win_length, cfg.center
    length = int(np.asarray(lr_audio).shape[-1])
    need, t_frames = plan_cp_padding(length, hop, win, center, group.size,
                                     generator_stride(cfg))
    full = full_length_system(system, need)
    dev = system.device
    _, f, _, c = full.spectro_shape(1)
    lr_spec = torch.empty(1, f, t_frames, c, device=dev)
    if group.rank == 0:
        lr_full = np.zeros(need, np.float32)  # need >= length by contract
        lr_full[:length] = np.asarray(lr_audio, np.float32)
        noise = noise or seeded_noise(full, cfg.seed)
        lr_spec, lr_pha, lr_norm = full.encode_input(
            torch.from_numpy(lr_full[None]).to(dev),
            noise=noise(0, (1, full.codec.mask_size(f), t_frames, c)))
        lr_spec = lr_spec.contiguous()
        print(f"context-parallel inference: {t_frames} frames over "
              f"{group.size} shards")
    group.broadcast(lr_spec)
    sr_spec = cp_forward(make_cp_generator(full, group), lr_spec)
    if sr_spec is None:
        return None
    wav = full.codec.imdct_eval(torch.abs(sr_spec), lr_pha, lr_norm)
    return np.sqrt(cfg.up_ratio - 1) * wav.cpu().numpy().reshape(-1)


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


def main(argv=None) -> Optional[np.ndarray]:
    """Run the CLI; returns the sr waveform it wrote (None on a rank other
    than 0 and on a rank outside the parallel group)."""
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default="cuda")
    args, rest = pre.parse_known_args(argv)
    cfg = parse_config(rest, is_train=False, save=mesh.env_rank() == 0)
    check_supported(cfg)
    world = mesh.initialize(resolve_device(args.device))
    device = world.device
    if device.type == "cuda":
        # f32 convs and matmuls at full precision (the JAX package asks for
        # Precision.HIGHEST); cuDNN picks its fastest algorithm per shape
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.benchmark = True
    # the gallery is on unless --no_html; stops here, on every rank, if its
    # packages are missing
    visualizer = None
    if world.rank == 0:
        visualizer = Visualizer(cfg.replace(is_train=True))
    elif not cfg.no_html:
        require_gallery_packages()

    with record_function("generate.read"):
        ds = AudioTestDataset(cfg.dataroot, cfg.lr_sampling_rate,
                              cfg.hr_sampling_rate, cfg.segment_length,
                              is_lr_input=cfg.is_lr_input)
    print("Audio length:", ds.audio_len)
    print("#audio segments = %d" % len(ds))

    shards = max(cfg.cp_shards, cfg.tp_shards)
    group = mesh.make_group(world, shards)
    if not group.member or (shards == 1 and world.rank > 0):
        print(f"rank {world.rank}: outside the {group.size}-rank group, idle")
        return None
    with record_function("generate.load"):
        system = load_system(cfg, device)
    print(f"generator {generator_path(cfg)} on {device} "
          f"({cfg.compute_dtype})")
    if cfg.tp_shards > 1:
        # Megatron TP of the resblocks; with --fused_enhancer the
        # enhancer's blocks stay whole for the fused kernel, as GSPMD
        # gathers a pallas_call's operands in the JAX package
        if group.size > 1:
            shard_generator(system.netG, group,
                            replicate_enhancer=cfg.fused_enhancer)
        print(f"tensor-parallel inference over {group.size} shards")
    with record_function("generate.serve"):
        if cfg.cp_shards > 1:
            audio = cp_generate(system, ds.lr_audio, cfg, group)
        else:
            audio = generate_segments(system, ds.segments,
                                      max(1, cfg.batch_size),
                                      seeded_noise(system, cfg.seed))
    if world.rank != 0:
        return None
    audio = audio[: ds.segments.size]

    n = ds.audio_len
    with record_function("generate.metrics"):
        mse, snr_sr, snr_lr, *_, lsd = compute_metrics(
            torch.from_numpy(ds.raw_audio[None, :n]),
            torch.from_numpy(ds.lr_audio[None, :n]),
            torch.from_numpy(audio[None, :n]), cfg.n_fft, cfg.hop_length,
            cfg.win_length, cfg.center)
        ssnr = segmental_snr(ds.raw_audio[:n], audio[:n])
    print("MSE: %.4f" % mse)
    print("SNR_SR: %.4f" % snr_sr)
    print("SNR_LR: %.4f" % snr_lr)
    print("LSD: %.4f" % lsd)
    print("SSNR: %.4f" % ssnr)

    if visualizer.use_html:
        write_gallery(system, visualizer, ds.lr_audio, audio)

    with record_function("generate.write"):
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
    mesh.shutdown()
