#!/usr/bin/env python3
"""Smoke test of the PyTorch port (pix2pixhdaudiosr_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1):
  1. print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from pix2pixhdaudiosr_torch/csrc with nvcc;
  3. hold each kernel against its plain PyTorch twin at the flagship shapes
     (MDCT2/IMDCT2 at atol 1e-5 in f32; InstanceNorm at every flagship
     (H, W, C), within one bf16 ulp (+1e-6 near zero) in bf16 and at atol
     1e-5 in f32), and time both with CUDA events;
  4. write a 5 s synthetic 48 kHz wav;
  5. build the flagship generator (LocalEnhancer G3L2, ngf 48, 156,050,690
     parameters) with seeded N(0, 0.02) weights, saved and loaded as .pth;
  6. run the port's generate CLI on it (bf16, batch 16) with every kernel
     launch counter set to 0 just before;
  7. check its outputs (finite, right lengths, 48 kHz) and that every kernel
     was launched during that run; then hold the CUDA serve path against
     the same path on the CPU in f32 on one segment, stage by stage;
  8. time the batch-128 serve forward (encode + G + decode) in bf16.
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
}


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
            # one bf16 ulp, plus 1e-6 where the output is near zero: there
            # the f32 statistics' own rounding (~1e-7 relative, summation
            # order differs from the twin's) is larger than the ulp
            over = ((gb.float() - wb.float()).abs() - 1e-6
                    - torch.maximum(bf16_ulp(gb), bf16_ulp(wb))).max().item()
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


def phase_generate(dev, counters, wav: str, n_in: int) -> dict:
    import numpy as np
    from pix2pixhdaudiosr_torch import generate
    from pix2pixhdaudiosr_torch.data.wavio import read_wav

    argv = ["--name", "smoke", "--checkpoints_dir", WORK, "--dataroot", wav,
            "--load_pretrain", os.path.join(WORK, "smoke"), "--batchSize",
            "16", "--no_html", "--device", dev, *FLAGSHIP]
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    audio = generate.main(argv)
    seconds = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    print(f"[generate] {seconds:.1f} s, launches {launches}")
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


def phase_serve_timing(dev, batch: int = 128) -> dict:
    import torch
    from pix2pixhdaudiosr_torch.config import parse_config
    from pix2pixhdaudiosr_torch.generate import load_system

    cfg = parse_config(["--name", "smoke", "--checkpoints_dir", WORK,
                        "--load_pretrain", os.path.join(WORK, "smoke"),
                        *FLAGSHIP], is_train=False, save=False)
    system = load_system(cfg, torch.device(dev))
    gen = torch.Generator(device=dev).manual_seed(3)
    lr = torch.randn(batch, SEG, generator=gen, device=dev) * 0.1
    b, f, t, c = system.spectro_shape(batch)
    noise = torch.randn(b, system.codec.mask_size(f), t, c, generator=gen,
                        device=dev)

    def serve():
        with torch.no_grad():
            sr, pha, norm, _ = system.inference(lr, noise=noise)
            return system.codec.imdct_eval(torch.abs(sr), pha, norm)

    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(serve, iters=5, warmup=2)
    peak = torch.cuda.max_memory_allocated() / 2**30
    res = dict(batch=batch, ms_per_batch=ms,
               frames_per_s=batch * t / (ms / 1e3), peak_gib=peak)
    print("[serve] " + json.dumps(res))
    return res


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
        from pix2pixhdaudiosr_torch.ops.mdct_kernels import imdct2, mdct2
        from pix2pixhdaudiosr_torch.ops.norm import instance_norm_act
        lib = _cuda.build()
        _cuda.library()
        print(f"[build] {lib} in {time.perf_counter() - t0:.1f} s")
        print(open(lib.parent / "build.log").read()[-3000:])

        rec, detail = phase_kernels(dev)
        shutil.rmtree(WORK, ignore_errors=True)
        os.makedirs(os.path.join(WORK, "smoke"))
        wav = os.path.join(WORK, "input_48k.wav")
        n_in = write_synthetic_wav(wav)
        flagship_generator_pth(os.path.join(WORK, "smoke"))
        counters = {"mdct2": mdct2, "imdct2": imdct2,
                    "instance_norm_act": instance_norm_act}
        gen_res = phase_generate(dev, counters, wav, n_in)
        ref_err = phase_reference(dev)
        serve = phase_serve_timing(dev)
    except (SmokeFailure, ImportError, RuntimeError, ValueError) as e:
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(WORK, ignore_errors=True)

    kernels = [dict(name=k, route="cuda", source=KERNELS[k][0],
                    replaces=KERNELS[k][1], launches=gen_res["launches"][k],
                    max_abs_err=rec[k]["max_abs_err"], ms=rec[k]["ms"],
                    plain_ms=rec[k]["plain_ms"]) for k in KERNELS]
    print("[detail] " + json.dumps(dict(
        card=smi, torch=torch.__version__, cuda=torch.version.cuda,
        kernel_detail=detail, generate=gen_res,
        reference_max_abs_err=ref_err, serve=serve)))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
