#!/usr/bin/env python3
"""Smoke test of the PyTorch port (pix2pixhdaudiosr_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1):
  1. print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from pix2pixhdaudiosr_torch/csrc with nvcc;
  3. hold each kernel against its plain PyTorch twin at the flagship shapes
     (MDCT2/IMDCT2 at atol 1e-5 in f32; InstanceNorm at every flagship
     (H, W, C), within one bf16 ulp (+1e-6 near zero) in bf16 and at atol
     1e-5 in f32; the fused conv3x3_in at [128, 96, 256, 64] bf16 for each
     prologue, y within one bf16 ulp (+1e-6 max(1, max|y|) near zero) and
     its mean and scale within 1e-4 of the channel's magnitude;
     conv3x3_valid at [64, 96, 258, 66] with and without ReLU, within one
     bf16 ulp (+ the same floor)), and time both with CUDA events;
  4. write a 5 s synthetic 48 kHz wav;
  5. build the flagship generator (LocalEnhancer G3L2, ngf 48, 156,050,690
     parameters) with seeded N(0, 0.02) weights, saved and loaded as .pth;
  6. run the port's generate CLI on it (bf16, batch 16), then again with
     --fused_enhancer at batch 128 (the JAX gate needs B % 128), every
     kernel launch counter set to 0 just before each run;
  7. check their outputs (finite, right lengths, 48 kHz) and that every
     kernel of each run was launched during it; hold the CUDA serve path
     against the same path on the CPU in f32 on one segment, stage by
     stage; hold the fused G output against the unfused one on the card
     (bf16, one batch of 128, max|diff| <= 0.05 max|unfused|);
  8. time the batch-128 serve forward (encode + G + decode) in bf16, plain
     and --fused_enhancer in turns (plain, fused, fused, plain), and trace
     one forward of each with torch.profiler (device time by kernel).
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Without CUDA, or without the package beside
it, the script exits non-zero and prints no result. f32 comparisons run
with TF32 off (torch.backends.cuda.matmul.allow_tf32 and
torch.backends.cudnn.allow_tf32 both False).
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "_smoke_run")           # listed in .gitignore

SEG = 32512
# __graft_entry__._flagship_cfg as generate flags
FLAGSHIP = ["--netG", "local", "--ngf", "48", "--n_blocks_global", "3",
            "--n_blocks_local", "2", "--n_downsample_global", "4",
            "--n_local_enhancers", "1", "--input_nc", "2", "--output_nc", "2",
            "--label_nc", "0", "--no_instance", "--explicit_encoding",
            "--mask_mode", "mode2", "--compute_dtype", "bfloat16"]
# every distinct (H, W, C) an InstanceNorm of the flagship generator sees
IN_SHAPES = [(512, 128, 48), (256, 64, 96), (128, 32, 192), (64, 16, 384),
             (32, 8, 768), (16, 4, 1536)]
KERNELS = {
    "mdct2": ("pix2pixhdaudiosr_torch/csrc/mdct.cu",
              "pix2pixhdaudiosr_tpu/ops/dct_pallas.py:85"),
    "imdct2": ("pix2pixhdaudiosr_torch/csrc/mdct.cu",
               "pix2pixhdaudiosr_tpu/ops/dct_pallas.py:134"),
    "instance_norm_act": ("pix2pixhdaudiosr_torch/csrc/instance_norm.cu",
                          "pix2pixhdaudiosr_tpu/ops/norm_pallas.py:49"),
    "conv3x3_in": ("pix2pixhdaudiosr_torch/csrc/conv3x3_in.cu",
                   "pix2pixhdaudiosr_tpu/ops/enhancer_pallas.py:182"),
    "conv3x3_valid": ("pix2pixhdaudiosr_torch/csrc/conv3x3_in.cu",
                      "pix2pixhdaudiosr_tpu/ops/conv_pallas.py:78"),
}
# the flagship enhancer resblock activation [B, C, H, W]
ENH_SHAPE = (128, 96, 256, 64)
FUSED = ["--fused_enhancer", "--batchSize", "128"]


class SmokeFailure(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() in ms over `iters` launches (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bf16_ulp(v):
    """One bf16 ulp at each |v| (2^(exponent - 7)), as f32."""
    import torch
    a = v.float().abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def ulp_excess(got, want, floor: float = 1e-6) -> float:
    """max(|got - want| - floor - one bf16 ulp of the larger): <= 0 when
    every element agrees within one ulp. The floor covers values near zero,
    where the ulp is smaller than the f32 sums' own rounding."""
    import torch
    return ((got.float() - want.float()).abs() - floor
            - torch.maximum(bf16_ulp(got), bf16_ulp(want))).max().item()


def conv_floor(want) -> float:
    """The near-zero floor of a conv check: 1e-6 max(1, max|want|), since
    the f32 accumulation's rounding scales with the partial sums' size."""
    return 1e-6 * max(1.0, want.float().abs().max().item())


# ---------------------------------------------------------------------------
def phase_kernels(dev, batch: int = 128, in_batch: int = 16):
    """Each kernel against its twin; returns {name: record} and details."""
    import torch
    from pix2pixhdaudiosr_torch.ops import mdct_kernels as mk
    from pix2pixhdaudiosr_torch.ops.framing import pad_signal
    from pix2pixhdaudiosr_torch.ops.mdct import IMDCT2, MDCT2
    from pix2pixhdaudiosr_torch.ops.norm import (instance_norm_act,
                                                 instance_norm_act_ref)
    from pix2pixhdaudiosr_torch.ops.window import kbdwin

    gen = torch.Generator(device=dev).manual_seed(0)
    rec, detail = {}, {}
    for win, hop in ((512, 256), (512, 160)):
        w = kbdwin(win)
        fwd = MDCT2(n_fft=512, hop_length=hop, win_length=win, window=w,
                    device=dev)
        inv = IMDCT2(n_fft=512, hop_length=hop, win_length=win, window=w,
                     device=dev)
        b = batch if hop == 256 else 8
        x = torch.randn(b, SEG, generator=gen, device=dev) * 0.3
        x_pad = pad_signal(x, hop, True).contiguous()
        spec = mk.mdct2(x_pad, fwd.basis, hop)
        err_f = (spec - mk.mdct2_ref(x_pad, fwd.basis, hop)).abs().max().item()
        wav = mk.imdct2(spec, inv.basis, hop)
        err_i = (wav - mk.imdct2_ref(spec, inv.basis, hop)).abs().max().item()
        torch.cuda.synchronize()
        print(f"[kernels] {win}/{hop} B={b}: mdct2 max|err| {err_f:.3e}, "
              f"imdct2 max|err| {err_i:.3e}")
        check(err_f <= 1e-5, f"mdct2 {win}/{hop} disagrees: {err_f}")
        check(err_i <= 1e-5, f"imdct2 {win}/{hop} disagrees: {err_i}")
        if hop == 256:
            rec["mdct2"] = dict(max_abs_err=err_f, ms=cuda_ms(
                lambda: mk.mdct2(x_pad, fwd.basis, hop)), plain_ms=cuda_ms(
                lambda: mk.mdct2_ref(x_pad, fwd.basis, hop)))
            rec["imdct2"] = dict(max_abs_err=err_i, ms=cuda_ms(
                lambda: mk.imdct2(spec, inv.basis, hop)), plain_ms=cuda_ms(
                lambda: mk.imdct2_ref(spec, inv.basis, hop)))
            for k in ("mdct2", "imdct2"):
                detail[k] = dict(rec[k], shape=f"B={b} 512/256 f32")

    worst = 0.0
    for H, W, C in IN_SHAPES:
        x = (torch.randn(in_batch, C, H, W, generator=gen, device=dev) * 2 + 0.5
             ).contiguous(memory_format=torch.channels_last)
        for act in ("relu", "none"):
            got = instance_norm_act(x, act)
            err32 = (got - instance_norm_act_ref(x, act)).abs().max().item()
            xb = x.to(torch.bfloat16)
            gb, wb = instance_norm_act(xb, act), instance_norm_act_ref(xb, act)
            over = ulp_excess(gb, wb)
            check(got.is_contiguous(memory_format=torch.channels_last),
                  "instance_norm_act lost channels_last")
            check(err32 <= 1e-5, f"IN f32 {(H, W, C)} {act}: {err32}")
            check(over <= 0, f"IN bf16 {(H, W, C)} {act}: beyond 1 ulp by {over}")
            worst = max(worst, err32)
        print(f"[kernels] IN B={in_batch} (H,W,C)={(H, W, C)}: f32 within "
              f"1e-5, bf16 within 1 ulp")
        xb = torch.randn(batch, C, H, W, generator=gen, device=dev,
                         dtype=torch.bfloat16).contiguous(
                             memory_format=torch.channels_last)
        detail[f"instance_norm_act {H}x{W}x{C}"] = dict(
            shape=f"B={batch} bf16 relu", ms=cuda_ms(
                lambda: instance_norm_act(xb, "relu"), iters=10),
            plain_ms=cuda_ms(lambda: instance_norm_act_ref(xb, "relu"),
                             iters=10))
        del xb
    big = detail[f"instance_norm_act {IN_SHAPES[0][0]}x{IN_SHAPES[0][1]}x"
                 f"{IN_SHAPES[0][2]}"]
    rec["instance_norm_act"] = dict(max_abs_err=worst, ms=big["ms"],
                                    plain_ms=big["plain_ms"])
    return rec, detail


def phase_conv_kernels(dev):
    """conv3x3_in (every prologue), conv3x3_valid (ReLU off and on) and the
    stats-only InstanceNorm entry against their twins at the flagship
    enhancer shape, bf16; returns {name: record} and details."""
    import torch
    import torch.nn.functional as F
    from pix2pixhdaudiosr_torch.ops import enhancer as te
    from pix2pixhdaudiosr_torch.ops.conv import conv3x3_valid, conv3x3_valid_ref
    from pix2pixhdaudiosr_torch.ops.norm import instance_stats, instance_stats_ref

    B, C, H, W = ENH_SHAPE
    gen = torch.Generator(device=dev).manual_seed(5)

    def act(shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)

    x, res = act(ENH_SHAPE), act(ENH_SHAPE)
    w = te.pack_weights(torch.randn(C, C, 3, 3, generator=gen, device=dev) * .05)
    bias = torch.randn(C, generator=gen, device=dev) * .1
    mean = torch.randn(B, C, generator=gen, device=dev) * .3
    scale = torch.rand(B, C, generator=gen, device=dev) * 1.5 + .5
    rec, detail, worst = {}, {}, 0.0
    for prologue in te.PROLOGUES:
        args = (x, w, bias, mean, scale, res, prologue)
        y, (m, s) = te.conv3x3_in(*args)
        y_ref, (m_ref, s_ref) = te.conv3x3_in_ref(*args)
        torch.cuda.synchronize()
        over = ulp_excess(y, y_ref, conv_floor(y_ref))
        # a one-ulp flip of y moves the mean by ulp / (H * W) however small
        # the mean is, so mean is held against |mean| + std
        m_rel = ((m - m_ref).abs() / (m_ref.abs() + 1 / s_ref)).max().item()
        s_rel = ((s - s_ref).abs() / s_ref).max().item()
        err = (y.float() - y_ref.float()).abs().max().item()
        print(f"[kernels] conv3x3_in {prologue}: max|err| {err:.3e}, beyond "
              f"1 ulp by {over:.3e}; mean rel {m_rel:.2e}, scale rel {s_rel:.2e}")
        check(over <= 0, f"conv3x3_in {prologue}: beyond 1 ulp by {over}")
        check(m_rel <= 1e-4 and s_rel <= 1e-4,
              f"conv3x3_in {prologue} stats: mean {m_rel}, scale {s_rel}")
        worst = max(worst, err)
        detail[f"conv3x3_in {prologue}"] = dict(
            shape=f"{list(ENH_SHAPE)} bf16", max_abs_err=err, mean_rel=m_rel,
            scale_rel=s_rel, ms=cuda_ms(lambda: te.conv3x3_in(*args)),
            plain_ms=cuda_ms(lambda: te.conv3x3_in_ref(*args), iters=5))
        del y, y_ref
    main = detail["conv3x3_in in_relu"]
    rec["conv3x3_in"] = dict(max_abs_err=worst, ms=main["ms"],
                             plain_ms=main["plain_ms"])
    # for scale, not a check: cuDNN's bf16 conv alone, on an already padded
    # channels_last input (no pad, bias, prologue or statistics), with the
    # algorithm search on as generate serves
    xp = F.pad(x, (1, 1, 1, 1), mode="reflect").contiguous(
        memory_format=torch.channels_last)
    wc = te.unpack_weights(w).contiguous(memory_format=torch.channels_last)
    searched = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    main["cudnn_bf16_conv_ms"] = cuda_ms(lambda: F.conv2d(xp, wc))
    torch.backends.cudnn.benchmark = searched
    del xp

    xp = act((64, C, H + 2, W + 2))
    wk = te.unpack_weights(w).contiguous()
    worst = 0.0
    for relu in (False, True):
        y = conv3x3_valid(xp, wk, relu)
        y_ref = conv3x3_valid_ref(xp, wk, relu)
        torch.cuda.synchronize()
        over = ulp_excess(y, y_ref, conv_floor(y_ref))
        err = (y.float() - y_ref.float()).abs().max().item()
        print(f"[kernels] conv3x3_valid relu={relu}: max|err| {err:.3e}")
        check(over <= 0, f"conv3x3_valid relu={relu}: beyond 1 ulp by {over}")
        worst = max(worst, err)
        detail[f"conv3x3_valid relu={relu}"] = dict(
            shape=f"[64, {C}, {H + 2}, {W + 2}] bf16", max_abs_err=err,
            ms=cuda_ms(lambda: conv3x3_valid(xp, wk, relu)),
            plain_ms=cuda_ms(lambda: conv3x3_valid_ref(xp, wk, relu), iters=5))
    rec["conv3x3_valid"] = dict(max_abs_err=worst,
                                ms=detail["conv3x3_valid relu=False"]["ms"],
                                plain_ms=detail["conv3x3_valid relu=False"]["plain_ms"])

    m, s = instance_stats(x)
    m_ref, s_ref = instance_stats_ref(x)
    err = max((m - m_ref).abs().max().item(), ((s - s_ref) / s_ref).abs().max().item())
    check(err <= 1e-5, f"instance_stats disagrees with its twin: {err}")
    detail["instance_stats"] = dict(
        shape=f"{list(ENH_SHAPE)} bf16", max_err=err,
        ms=cuda_ms(lambda: instance_stats(x)),
        plain_ms=cuda_ms(lambda: instance_stats_ref(x), iters=5))
    print(f"[kernels] instance_stats: max err {err:.2e}")
    return rec, detail


def write_synthetic_wav(path: str, seconds: float = 5.0, rate: int = 48000):
    import numpy as np
    from pix2pixhdaudiosr_torch.data.wavio import write_wav
    rng = np.random.default_rng(0)
    t = np.arange(int(seconds * rate)) / rate
    x = sum(0.2 / k * np.sin(2 * np.pi * 220 * k * t) for k in range(1, 9))
    x = x * (0.6 + 0.4 * np.sin(2 * np.pi * 3 * t)) + 0.01 * rng.standard_normal(t.size)
    write_wav(path, x.astype(np.float32), rate)
    return t.size


def flagship_generator_pth(expr_dir: str, seed: int = 0) -> str:
    """Flagship G with N(0, 0.02) weights from `seed`, saved as
    <expr_dir>/latest_net_G.pth."""
    import torch
    from pix2pixhdaudiosr_torch.models.generator import (build_generator,
                                                         init_normal_)
    from pix2pixhdaudiosr_torch.utils.checkpoint import save_generator
    net = build_generator("local", 2, 2, 48, 4, 3, 1, 2, device="meta")
    net = net.to_empty(device="cpu")
    n = sum(p.numel() for p in net.parameters())
    check(n == 156_050_690, f"flagship G has {n} parameters")
    init_normal_(net, torch.Generator().manual_seed(seed))
    return save_generator(net, os.path.join(expr_dir, "latest_net_G.pth"))


def phase_generate(dev, counters, wav: str, n_in: int, extra=()) -> dict:
    import numpy as np
    from pix2pixhdaudiosr_torch import generate
    from pix2pixhdaudiosr_torch.data.wavio import read_wav

    argv = ["--name", "smoke", "--checkpoints_dir", WORK, "--dataroot", wav,
            "--load_pretrain", os.path.join(WORK, "smoke"), "--batchSize",
            "16", "--no_html", "--device", dev, *FLAGSHIP, *extra]
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    audio = generate.main(argv)
    seconds = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    print(f"[generate{' ' + ' '.join(extra) if extra else ''}] "
          f"{seconds:.1f} s, launches {launches}")
    for k, n in launches.items():
        check(n > 0, f"kernel {k} was not launched by the generate run")
    check(bool(np.isfinite(audio).all()), "generate produced non-finite audio")
    check(float(np.abs(audio).max()) > 0, "generate produced silence")
    sr, rate = read_wav(os.path.join(WORK, "smoke", "sr_audio.wav"))
    check(rate == 48000, f"sr_audio.wav at {rate} Hz")
    check(sr.shape[1] >= n_in, f"sr_audio.wav has {sr.shape[1]} < {n_in}")
    with open(os.path.join(WORK, "smoke", "metric.txt")) as f:
        vals = [float(v) for v in f.read().split("\n")[1].split(",")]
    check(all(np.isfinite(vals)), f"metric.txt not finite: {vals}")
    return dict(launches=launches, seconds=seconds, metric=vals)


def phase_reference(dev) -> dict:
    """The CUDA serve path against the same path on the CPU (kernel twins),
    f32, one segment, same weights and noise, stage by stage:
      encode  lr spectrogram, atol 1e-3: values in [0, 1], but the dB
              encode turns the MDCT's ~1e-9 absolute rounding on
              coefficients just above the 1e-7 floor into ~0.1 dB, ~6e-4
              of the batch's ~150 dB range;
      G       sr spectrogram, atol 1e-3 (f32 rounding through 32 conv/IN
              layers, each IN dividing by a per-channel std);
      decode  imdct_eval of the CPU's sr spectrogram on both devices,
              atol 1e-4 * max|wav| (the dB decode's 10^(x/20) gain over the
              batch's ~150 dB range).
    The decode is fed one spectrogram because its pseudo-phase
    sign(ch0 - ch1) flips on bins where the two channels agree to within
    the G stage's rounding; each flip is a legitimate +-2*mag step."""
    import torch
    from pix2pixhdaudiosr_torch.config import parse_config
    from pix2pixhdaudiosr_torch.generate import load_system

    cfg = parse_config(["--name", "smoke", "--checkpoints_dir", WORK,
                        "--load_pretrain", os.path.join(WORK, "smoke"),
                        *FLAGSHIP, "--compute_dtype", "float32"],
                       is_train=False, save=False)
    lr = torch.randn(1, SEG, generator=torch.Generator().manual_seed(1)) * 0.1
    noise = torch.randn(1, 426, 128, 2, generator=torch.Generator()
                        .manual_seed(7))
    res = {}
    for d in ("cpu", dev):
        system = load_system(cfg, torch.device(d))
        with torch.no_grad():
            sr, pha, norm, lr_spec = system.inference(lr.to(d), noise.to(d))
        res[d] = (system, sr, pha, norm, lr_spec)
    cpu, gpu = res["cpu"], res[dev]
    err = {"encode": (gpu[4].cpu() - cpu[4]).abs().max().item(),
           "G": (gpu[1].cpu() - cpu[1]).abs().max().item()}
    wavs = [s.codec.imdct_eval(cpu[1].abs().to(s.device), cpu[2].to(s.device),
                               {k: v.to(s.device) for k, v in cpu[3].items()}
                               ).cpu() for s in (cpu[0], gpu[0])]
    err["decode"] = (wavs[1] - wavs[0]).abs().max().item()
    bound = {"encode": 1e-3, "G": 1e-3,
             "decode": 1e-4 * wavs[0].abs().max().item()}
    print(f"[reference] CUDA vs CPU, f32, one segment: max|err| {err} "
          f"(bounds {bound})")
    for k in err:
        check(err[k] <= bound[k], f"CUDA {k} disagrees with the CPU: "
              f"{err[k]} > {bound[k]}")
    check(bool(torch.isfinite(gpu[1]).all()), "CUDA G output not finite")
    return err


def fused_system(dev, batch: int = 128):
    """The flagship system in bf16 with --fused_enhancer (its netG toggles
    the fused section through `fused_enh_blocks`), and a seeded batch."""
    import torch
    from pix2pixhdaudiosr_torch.config import parse_config
    from pix2pixhdaudiosr_torch.generate import load_system

    cfg = parse_config(["--name", "smoke", "--checkpoints_dir", WORK,
                        "--load_pretrain", os.path.join(WORK, "smoke"),
                        *FLAGSHIP, "--fused_enhancer"], is_train=False,
                       save=False)
    system = load_system(cfg, torch.device(dev))
    gen = torch.Generator(device=dev).manual_seed(3)
    lr = torch.randn(batch, SEG, generator=gen, device=dev) * 0.1
    b, f, t, c = system.spectro_shape(batch)
    noise = torch.randn(b, system.codec.mask_size(f), t, c, generator=gen,
                        device=dev)
    return system, lr, noise


def phase_fused_vs_plain(system, lr, noise) -> dict:
    """Fused against unfused G output on the card: bf16, one batch, the
    same weights and noise; bound max|diff| <= 0.05 max|unfused| (the JAX
    package's own bound, tests/test_enhancer_pallas.py:110)."""
    import torch
    from pix2pixhdaudiosr_torch.ops import enhancer

    out = {}
    for fused in (False, True):
        system.netG.fused_enh_blocks = fused
        n = enhancer.conv3x3_in.launches
        with torch.no_grad():
            out[fused] = system.inference(lr, noise=noise)[0]
        check((enhancer.conv3x3_in.launches > n) == fused,
              f"fused={fused}: conv3x3_in launched {enhancer.conv3x3_in.launches - n}x")
    scale = out[False].abs().max().item()
    err = (out[True] - out[False]).abs().max().item()
    res = dict(max_abs_diff=err, max_abs_unfused=scale, ratio=err / scale,
               bound=0.05)
    print("[fused vs plain] " + json.dumps(res))
    check(bool(torch.isfinite(out[True]).all()), "fused G output not finite")
    check(err <= 0.05 * scale, f"fused G output off the unfused: {err} > "
          f"0.05 * {scale}")
    return res


def phase_serve_timing(system, lr, noise) -> dict:
    """ms/batch, frames/s and peak GiB of the serve forward, plain and
    fused in turns (plain, fused, fused, plain), 5 forwards after 2 warm-ups
    each; then one traced forward of each."""
    import torch
    t = system.n_frames

    def serve():
        with torch.no_grad():
            sr, pha, norm, _ = system.inference(lr, noise=noise)
            return system.codec.imdct_eval(torch.abs(sr), pha, norm)

    runs = {False: [], True: []}
    for fused in (False, True, True, False):
        system.netG.fused_enh_blocks = fused
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(serve, iters=5, warmup=2)
        runs[fused].append((ms, torch.cuda.max_memory_allocated() / 2**30))
    res = {}
    for fused, name in ((False, "plain"), (True, "fused_enhancer")):
        ms = sum(r[0] for r in runs[fused]) / 2
        res[name] = dict(batch=lr.shape[0], ms_per_batch=ms,
                         ms_runs=[r[0] for r in runs[fused]],
                         frames_per_s=lr.shape[0] * t / (ms / 1e3),
                         peak_gib=max(r[1] for r in runs[fused]))
        print(f"[serve {name}] " + json.dumps(res[name]))
    for fused, name in ((False, "plain"), (True, "fused_enhancer")):
        system.netG.fused_enh_blocks = fused
        res[name]["profile"] = profile_serve(serve)
        print(f"[profile {name}] " + json.dumps(res[name]["profile"]))
    return res


def profile_serve(serve, top: int = 16) -> dict:
    """One traced serve forward: the device total of its kernels against
    the forward's host wall time, and the `top` kernels by device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        serve()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # kernel rows only: an operator's row repeats its kernels' device time
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    return dict(host_wall_ms=wall, device_ms=sum(
        e.self_device_time_total for e in kernels) / 1e3, top=[
        [e.key[:80], e.self_device_time_total / 1e3, e.count]
        for e in kernels[:top]])


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    smi = nvidia_smi()
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = "cuda"
    try:
        t0 = time.perf_counter()
        from pix2pixhdaudiosr_torch.ops import _cuda
        from pix2pixhdaudiosr_torch.ops.conv import conv3x3_valid
        from pix2pixhdaudiosr_torch.ops.enhancer import conv3x3_in
        from pix2pixhdaudiosr_torch.ops.mdct_kernels import imdct2, mdct2
        from pix2pixhdaudiosr_torch.ops.norm import (instance_norm_act,
                                                     instance_stats)
        lib = _cuda.build()
        _cuda.library()
        print(f"[build] {lib} in {time.perf_counter() - t0:.1f} s")
        print(open(lib.parent / "build.log").read()[-3000:])

        rec, detail = phase_kernels(dev)
        rec_conv, detail_conv = phase_conv_kernels(dev)
        rec.update(rec_conv)
        detail.update(detail_conv)
        valid_launches = conv3x3_valid.launches  # no path calls B5
        shutil.rmtree(WORK, ignore_errors=True)
        os.makedirs(os.path.join(WORK, "smoke"))
        wav = os.path.join(WORK, "input_48k.wav")
        n_in = write_synthetic_wav(wav)
        flagship_generator_pth(os.path.join(WORK, "smoke"))
        counters = {"mdct2": mdct2, "imdct2": imdct2,
                    "instance_norm_act": instance_norm_act}
        gen_res = phase_generate(dev, counters, wav, n_in)
        gen_fused = phase_generate(dev, dict(
            counters, conv3x3_in=conv3x3_in, instance_stats=instance_stats),
            wav, n_in, FUSED)
        ref_err = phase_reference(dev)
        system, lr, noise = fused_system(dev)
        fused_err = phase_fused_vs_plain(system, lr, noise)
        serve = phase_serve_timing(system, lr, noise)
    except (SmokeFailure, ImportError, RuntimeError, ValueError) as e:
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(WORK, ignore_errors=True)

    launches = dict(gen_res["launches"],
                    conv3x3_in=gen_fused["launches"]["conv3x3_in"],
                    conv3x3_valid=valid_launches)
    kernels = [dict(name=k, route="cuda", source=KERNELS[k][0],
                    replaces=KERNELS[k][1], launches=launches[k],
                    max_abs_err=rec[k]["max_abs_err"], ms=rec[k]["ms"],
                    plain_ms=rec[k]["plain_ms"]) for k in KERNELS]
    print("[detail] " + json.dumps(dict(
        card=smi, torch=torch.__version__, cuda=torch.version.cuda,
        kernel_detail=detail, generate=gen_res, generate_fused=gen_fused,
        reference_max_abs_err=ref_err, fused_vs_plain=fused_err,
        serve=serve)))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
