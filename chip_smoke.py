#!/usr/bin/env python3
"""Smoke test of the PyTorch port (pix2pixhdaudiosr_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1):
  1. print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from pix2pixhdaudiosr_torch/csrc with nvcc;
  3. hold each kernel against its plain PyTorch twin at the flagship shapes
     (MDCT2/IMDCT2 at atol 1e-5 in f32, on the tensor-core route at batch
     128 and 1 (512/256) and on the FFMA route at 512/160; InstanceNorm at
     every flagship (H, W, C), within one bf16 ulp (+1e-6 near zero) in
     bf16 and at atol 1e-5 in f32, every call on the one-pass route and two
     runs bit-identical, and on a same-mode deconv crop read in place
     (timed per shape beside the two-pass kernels); the fused conv3x3_in at
     [128, 96, 256, 64] bf16 for each prologue on both routes (wgmma, the
     planner's choice, and mma.sync), y within one bf16 ulp (+1e-6
     max(1, max|y|) near zero), its mean and scale within 1e-4 of the
     channel's magnitude and bit-identical over two runs, each call
     counted on its route;
     conv3x3_valid at [64, 96, 258, 66] with and without ReLU on both
     routes, within one bf16 ulp (+ the same floor), both routes timed
     beside F.conv2d (B5) and cuDNN's bare conv (B4), with each entry's
     bound and share of it; the stochastic quantizer at [13824, 1536]
     (a flagship trunk conv weight as 2-D) and [1000, 136], q and scale
     bit-identical and q * scale within one step of x), and time both with
     CUDA events, beside one PyTorch call computing the same function where
     there is one (library_ms) and the kernel's bound (bound_ms: bytes over
     HBM bandwidth or operations over their peak rate, the larger); then
     the int8 trunk conv at [128, 1536, 16, 4] bf16: its int32 accumulator
     on the card equal to the CPU's;
  4. write a 5 s synthetic 48 kHz wav;
  5. build the flagship generator (LocalEnhancer G3L2, ngf 48, 156,050,690
     parameters) with seeded N(0, 0.02) weights, saved and loaded as .pth;
  6. run the port's generate CLI on it (bf16, batch 16), then with
     --fused_enhancer at batch 128 (the JAX gate needs B % 128), then with
     --data_type 8 --int8_trunk at batch 16, every kernel launch counter
     set to 0 just before each run;
  7. check their outputs (finite, right lengths, 48 kHz), that every
     kernel of each run was launched during it, that every MDCT2/IMDCT2
     launch took the tensor-core route (the `launches_tc` counters), that
     every InstanceNorm launch took the one-pass route (`launches_onepass`),
     that every conv3x3_in launch took the wgmma route (`launches_wgmma`),
     and that the quantized run printed "int8 weight quantization enabled";
     hold the CUDA serve path against the same path on the CPU in f32 on
     one segment, stage by stage; hold the fused G output against the
     unfused one on the card (bf16, one batch of 128, max|diff| <= 0.05
     max|unfused|), and the --int8_trunk and --data_type 8 G outputs
     against the plain one (correlation >= 0.99);
  8. time the batch-128 serve forward (encode + G + decode) in bf16, plain,
     --fused_enhancer and --int8_trunk in turns (plain, fused, int8, int8,
     fused, plain), and plain and int8 at batch 1 (plain, int8, int8,
     plain); trace one forward of each path with torch.profiler (device
     time by kernel) and count each kernel's launches in one forward, every
     InstanceNorm launch on the one-pass route (plain 22, fused 17, int8
     22) and the fused forward's 4 conv3x3_in launches on the wgmma route;
     print B3's time against its bound a shape, with its calls in a
     plain forward, and the flagship's int8 size against f32 and bf16.
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Without CUDA, or without the package beside
it, the script exits non-zero and prints no result. f32 comparisons run
with TF32 off (torch.backends.cuda.matmul.allow_tf32 and
torch.backends.cudnn.allow_tf32 both False).
"""

from __future__ import annotations

import contextlib
import io
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
    "conv3x3_in": ("pix2pixhdaudiosr_torch/csrc/conv3x3_wgmma.cu",
                   "pix2pixhdaudiosr_tpu/ops/enhancer_pallas.py:182"),
    "conv3x3_valid": ("pix2pixhdaudiosr_torch/csrc/conv3x3_wgmma.cu",
                      "pix2pixhdaudiosr_tpu/ops/conv_pallas.py:78"),
    "stochastic_quantize_2d": ("pix2pixhdaudiosr_torch/csrc/quant.cu",
                               "pix2pixhdaudiosr_tpu/ops/quant.py:152"),
}
# the flagship enhancer resblock activation [B, C, H, W]
ENH_SHAPE = (128, 96, 256, 64)
FUSED = ["--fused_enhancer", "--batchSize", "128"]
QUANT = ["--data_type", "8", "--int8_trunk"]
# the flagship trunk resblock activation [B, C, H, W], and one trunk conv
# weight [Co, Ci, 3, 3] seen as the flax kernel's 2-D view [9 Ci, Co]
TRUNK_SHAPE = (128, 1536, 16, 4)
TRUNK_W2D = (9 * 1536, 1536)
# NVIDIA's published H100 SXM rates (dense) that a kernel's bound is reckoned
# at: HBM bytes/s; TF32, bf16 tensor-core and f32 FFMA FLOP/s; int32 ops/s
# outside the tensor cores (half the f32 issue rate)
HBM_BPS = 3.35e12
TF32_FLOPS, BF16_FLOPS, F32_FLOPS, INT32_OPS = 495e12, 989e12, 67e12, 33.5e12


# InstanceNorm launches in one batch-128 serve forward of each path
IN_LAUNCHES = {"plain": 22, "fused_enhancer": 17, "int8_trunk": 22}


class SmokeFailure(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def reset_counts(fn) -> None:
    """Set every launch count of a kernel wrapper to 0."""
    fn.launches = 0
    for attr in ("launches_tc", "launches_onepass", "launches_wgmma"):
        if hasattr(fn, attr):
            setattr(fn, attr, 0)
    if hasattr(fn, "launches_by_shape"):
        fn.launches_by_shape.clear()


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


def device_ms(fn, iters: int = 20, tries: int = 5) -> float:
    """Mean device time of the kernels fn() launches, in ms, from
    torch.profiler: unlike cuda_ms, it leaves out the host time between
    launches, which is most of a call where the kernel is short. The
    first traced run is a warm-up, and a trace that comes back without
    kernels (a process's first often does, a later one now and then) is
    taken again, up to `tries` times."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(tries + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA)
        if attempt > 0 and total > 0:
            return total / 1e3 / iters
    raise SmokeFailure(f"{tries} profiler traces came back without kernels")


def bound(n_bytes: float, ops: float, rate: float) -> dict:
    """The least time the card could take for a kernel's work: the larger
    of its bytes (each input read once, each output written once) over HBM
    bandwidth and its operations over their peak rate."""
    by_bytes, by_ops = n_bytes / HBM_BPS * 1e3, ops / rate * 1e3
    return dict(bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations")


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
    import torch.nn.functional as F
    from pix2pixhdaudiosr_torch.ops import mdct_kernels as mk
    from pix2pixhdaudiosr_torch.ops.framing import pad_signal
    from pix2pixhdaudiosr_torch.ops.mdct import IMDCT2, MDCT2
    from pix2pixhdaudiosr_torch.ops.window import kbdwin

    gen = torch.Generator(device=dev).manual_seed(0)
    rec, detail = {}, {}
    # the flagship codec on the tensor-core route at batch 128 and 1, and
    # 512/160 (win % hop != 0) on the FFMA route
    for win, hop, b in ((512, 256, batch), (512, 256, 1), (512, 160, 8)):
        w = kbdwin(win)
        fwd = MDCT2(n_fft=512, hop_length=hop, win_length=win, window=w,
                    device=dev)
        inv = IMDCT2(n_fft=512, hop_length=hop, win_length=win, window=w,
                     device=dev)
        x = torch.randn(b, SEG, generator=gen, device=dev) * 0.3
        x_pad = pad_signal(x, hop, True).contiguous()
        n_tc = mk.mdct2.launches_tc, mk.imdct2.launches_tc
        spec = mk.mdct2(x_pad, fwd.basis, hop, fwd.planes)
        wav = mk.imdct2(spec, inv.basis, hop, inv.planes)
        tc = (mk.mdct2.launches_tc - n_tc[0], mk.imdct2.launches_tc - n_tc[1])
        err_f = (spec - mk.mdct2_ref(x_pad, fwd.basis, hop)).abs().max().item()
        err_i = (wav - mk.imdct2_ref(spec, inv.basis, hop)).abs().max().item()
        torch.cuda.synchronize()
        route = "tensor-core" if fwd.tc else "FFMA"
        print(f"[kernels] {win}/{hop} B={b} ({route} route): mdct2 max|err| "
              f"{err_f:.3e}, imdct2 max|err| {err_i:.3e}")
        check(tc == ((1, 1) if fwd.tc else (0, 0)), f"{win}/{hop}: "
              f"tensor-core launches {tc}, expected the {route} route")
        check(err_f <= 1e-5, f"mdct2 {win}/{hop} B={b} disagrees: {err_f}")
        check(err_i <= 1e-5, f"imdct2 {win}/{hop} B={b} disagrees: {err_i}")
        T, flop = spec.shape[1], 2 * spec.numel() * win
        basis_bytes = 4 * win * 512 * (2 if fwd.tc else 1)
        for name, err, run, plain, lib, io_bytes in (
                ("mdct2", err_f,
                 lambda: mk.mdct2(x_pad, fwd.basis, hop, fwd.planes),
                 lambda: mk.mdct2_ref(x_pad, fwd.basis, hop),
                 lambda: torch.matmul(x_pad.unfold(-1, win, hop), fwd.basis),
                 4 * (x_pad.numel() + spec.numel())),
                ("imdct2", err_i,
                 lambda: mk.imdct2(spec, inv.basis, hop, inv.planes),
                 lambda: mk.imdct2_ref(spec, inv.basis, hop),
                 lambda: F.fold((spec @ inv.basis).transpose(1, 2),
                                (1, wav.shape[1]), (1, win), stride=(1, hop)),
                 4 * (spec.numel() + wav.numel()))):
            r = dict(shape=f"B={b} T={T} {win}/{hop} f32", route=route,
                     max_abs_err=err, ms=cuda_ms(run), plain_ms=cuda_ms(plain),
                     library_ms=cuda_ms(lib), device_ms=device_ms(run),
                     plain_device_ms=device_ms(plain),
                     library_device_ms=device_ms(lib),
                     **bound(io_bytes + basis_bytes, 3 * flop, TF32_FLOPS))
            print(f"[kernels] {name} {r['shape']}: " + json.dumps(r))
            detail[f"{name} {win}/{hop} B={b}"] = r
            if (hop, b) == (256, batch):
                rec[name] = r

    rec["instance_norm_act"], in_detail = phase_instance_norm(
        dev, gen, batch, in_batch)
    detail.update(in_detail)
    return rec, detail


def phase_instance_norm(dev, gen, batch: int, in_batch: int):
    """B3 at every flagship (H, W, C): against its twin at batch `in_batch`
    in f32 (atol 1e-5) and bf16 (one ulp), ReLU and none, every call on the
    one-pass route and two runs bit-identical; then a same-mode deconv crop
    read in place. Timed at batch `batch` in bf16 beside the two-pass
    kernels, the twin, F.instance_norm and the bound. Returns the record
    of the largest shape and one row a shape."""
    import torch
    import torch.nn.functional as F
    from pix2pixhdaudiosr_torch.ops import norm

    fn, worst, rows = norm.instance_norm_act, 0.0, {}
    for H, W, C in IN_SHAPES:
        x = (torch.randn(in_batch, C, H, W, generator=gen, device=dev) * 2 + 0.5
             ).contiguous(memory_format=torch.channels_last)
        xb = x.to(torch.bfloat16)
        n1 = fn.launches_onepass
        for act in ("relu", "none"):
            got = fn(x, act)
            err32 = (got - norm.instance_norm_act_ref(x, act)).abs().max().item()
            gb = fn(xb, act)
            over = ulp_excess(gb, norm.instance_norm_act_ref(xb, act))
            check(got.is_contiguous(memory_format=torch.channels_last),
                  "instance_norm_act lost channels_last")
            check(err32 <= 1e-5, f"IN f32 {(H, W, C)} {act}: {err32}")
            check(over <= 0, f"IN bf16 {(H, W, C)} {act}: beyond 1 ulp by {over}")
            check(torch.equal(fn(xb, act), gb),
                  f"IN bf16 {(H, W, C)} {act}: two runs differ")
            worst = max(worst, err32)
        check(fn.launches_onepass - n1 == 6,
              f"IN {(H, W, C)}: {6 - fn.launches_onepass + n1} of 6 calls "
              f"took the two-pass route")
        print(f"[kernels] IN B={in_batch} (H,W,C)={(H, W, C)}: f32 within "
              f"1e-5, bf16 within 1 ulp, one-pass, bit-identical")
        del x, xb, got, gb
        xb = torch.randn(batch, C, H, W, generator=gen, device=dev,
                         dtype=torch.bfloat16).contiguous(
                             memory_format=torch.channels_last)
        plan = norm.plan_instance_norm(batch, H, W, C, xb.dtype)

        def two_pass():
            norm._launch_twopass(xb, torch.empty_like(xb), "none", 1e-5)
        # act "none" is the function F.instance_norm computes; one read and
        # one write of x, ~8 f32 operations an element
        row = dict(shape=f"B={batch} bf16", route=plan.route,
                   plan=plan._asdict(),
                   ms=cuda_ms(lambda: fn(xb, "none"), iters=10),
                   device_ms=device_ms(lambda: fn(xb, "none"), iters=10),
                   relu_ms=cuda_ms(lambda: fn(xb, "relu"), iters=10),
                   two_pass_ms=cuda_ms(two_pass, iters=10),
                   two_pass_device_ms=device_ms(two_pass, iters=10),
                   plain_ms=cuda_ms(lambda: norm.instance_norm_act_ref(
                       xb, "none"), iters=5),
                   library_ms=cuda_ms(lambda: F.instance_norm(xb), iters=10),
                   **bound(2 * 2 * xb.numel(), 8 * xb.numel(), F32_FLOPS))
        rows[(H, W, C)] = row
        print(f"[kernels] instance_norm_act {H}x{W}x{C}: " + json.dumps(row))
        del xb

    # the enhancer's deconv output [B, 48, 513, 129] cropped to 512 x 128
    for dtype in (torch.float32, torch.bfloat16):
        full = (torch.randn(in_batch, 48, 513, 129, generator=gen, device=dev)
                ).to(dtype).contiguous(memory_format=torch.channels_last)
        crop = full[..., :512, :128]
        n1 = fn.launches_onepass
        got = fn(crop, "relu")
        want = norm.instance_norm_act_ref(crop, "relu")
        err = (got.float() - want.float()).abs().max().item()
        ok = (err <= 1e-5 if dtype == torch.float32
              else ulp_excess(got, want) <= 0)
        same = torch.equal(fn(crop.contiguous(
            memory_format=torch.channels_last), "relu"), got)
        print(f"[kernels] IN cropped view {list(crop.shape)} strides "
              f"{crop.stride()} {dtype}: max|err| {err:.3e}, equal to its "
              f"contiguous copy: {same}")
        check(fn.launches_onepass - n1 == 2, "IN cropped view: two-pass route")
        check(ok, f"IN cropped view {dtype}: {err}")
        check(same, f"IN cropped view {dtype}: differs from its copy")
        del full, crop, got, want
    big = rows[IN_SHAPES[0]]
    return dict(big, max_abs_err=worst), {
        f"instance_norm_act {H}x{W}x{C}": r for (H, W, C), r in rows.items()}


def phase_conv_kernels(dev):
    """conv3x3_in (every prologue), conv3x3_valid (ReLU off and on), each
    on both routes, and the stats-only InstanceNorm entry against their
    twins at the flagship enhancer shape, bf16; returns {name: record} and
    details. The planner's route (wgmma) is the record's; the mma.sync
    route is timed beside it in the same call."""
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
    sms = te.device_sms(torch.cuda.current_device())
    plans = {r: te.plan_conv(B, H, W, C, C, sms, route=r)
             for r in ("wgmma", "mma_sync")}
    check(te.plan_conv(B, H, W, C, C, sms) == plans["wgmma"],
          f"conv3x3_in {list(ENH_SHAPE)}: the planner chose "
          f"{te.plan_conv(B, H, W, C, C, sms).route}, not the wgmma route")
    fn = te.conv3x3_in
    rec, detail, worst = {}, {}, 0.0
    for prologue in te.PROLOGUES:
        args = (x, w, bias, mean, scale, res, prologue)
        y_ref, (m_ref, s_ref) = te.conv3x3_in_ref(*args)
        row = dict(shape=f"{list(ENH_SHAPE)} bf16")
        for route, plan in plans.items():
            n, n_wg = fn.launches, fn.launches_wgmma
            y, (m, s) = fn(*args, plan=None if route == "wgmma" else plan)
            y2, (m2, s2) = fn(*args, plan=None if route == "wgmma" else plan)
            torch.cuda.synchronize()
            check(fn.launches - n == 2 and fn.launches_wgmma - n_wg
                  == 2 * (route == "wgmma"), f"conv3x3_in {prologue}: "
                  f"{fn.launches_wgmma - n_wg} of 2 launches on the wgmma "
                  f"route, {route} expected")
            over = ulp_excess(y, y_ref, conv_floor(y_ref))
            # a one-ulp flip of y moves the mean by ulp / (H * W) however
            # small the mean is, so mean is held against |mean| + std
            m_rel = ((m - m_ref).abs() / (m_ref.abs() + 1 / s_ref)).max().item()
            s_rel = ((s - s_ref).abs() / s_ref).max().item()
            err = (y.float() - y_ref.float()).abs().max().item()
            same = (torch.equal(y, y2) and torch.equal(m, m2)
                    and torch.equal(s, s2))
            print(f"[kernels] conv3x3_in {prologue} ({route}): max|err| "
                  f"{err:.3e}, beyond 1 ulp by {over:.3e}; mean rel "
                  f"{m_rel:.2e}, scale rel {s_rel:.2e}; two runs "
                  f"{'bit-identical' if same else 'DIFFER'}")
            check(over <= 0, f"conv3x3_in {prologue} ({route}): beyond 1 ulp "
                  f"by {over}")
            check(m_rel <= 1e-4 and s_rel <= 1e-4, f"conv3x3_in {prologue} "
                  f"({route}) stats: mean {m_rel}, scale {s_rel}")
            check(same, f"conv3x3_in {prologue} ({route}): two runs differ")
            key = "" if route == "wgmma" else "mma_sync_"
            row.update({f"{key}max_abs_err": err, f"{key}mean_rel": m_rel,
                        f"{key}scale_rel": s_rel})
            if route == "wgmma":
                worst = max(worst, err)
            del y, y2
        row["ms"] = cuda_ms(lambda: fn(*args))
        row["mma_sync_ms"] = cuda_ms(lambda: fn(*args, plan=plans["mma_sync"]))
        row["plain_ms"] = cuda_ms(lambda: te.conv3x3_in_ref(*args), iters=5)
        detail[f"conv3x3_in {prologue}"] = row
        del y_ref
    main = detail["conv3x3_in in_relu"]
    # no single PyTorch call computes conv + prologue + IN partial sums: no
    # library_ms. For scale, not a check: cuDNN's bf16 conv alone, on an
    # already padded channels_last input (no pad, bias, prologue or
    # statistics), with the algorithm search on as generate serves
    xp = F.pad(x, (1, 1, 1, 1), mode="reflect").contiguous(
        memory_format=torch.channels_last)
    wc = te.unpack_weights(w).contiguous(memory_format=torch.channels_last)
    searched = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    main["cudnn_bf16_conv_ms"] = cuda_ms(lambda: F.conv2d(xp, wc))
    torch.backends.cudnn.benchmark = searched
    del xp
    # in_relu reads x (bf16) and writes y; 9 taps of C x C MACs a position
    main.update(bound(2 * 2 * x.numel(), 2 * 9 * C * x.numel(), BF16_FLOPS))
    main.update(route="wgmma", plan=plans["wgmma"]._asdict(),
                share_of_bound=main["bound_ms"] / main["ms"],
                mma_sync_share_of_bound=main["bound_ms"] / main["mma_sync_ms"],
                speedup_vs_mma_sync=main["mma_sync_ms"] / main["ms"])
    print("[kernels] conv3x3_in in_relu: " + json.dumps(main))
    rec["conv3x3_in"] = dict(main, max_abs_err=worst, library_ms=None)

    xp = act((64, C, H + 2, W + 2))
    wk = te.unpack_weights(w).contiguous()
    vplans = {r: te.plan_conv(64, H, W, C, C, sms, route=r)
              for r in ("wgmma", "mma_sync")}
    check(te.plan_conv(64, H, W, C, C, sms) == vplans["wgmma"],
          "conv3x3_valid: the planner did not choose the wgmma route")
    worst = 0.0
    for relu in (False, True):
        y_ref = conv3x3_valid_ref(xp, wk, relu)
        row = dict(shape=f"[64, {C}, {H + 2}, {W + 2}] bf16")
        for route, plan in vplans.items():
            n, n_wg = conv3x3_valid.launches, conv3x3_valid.launches_wgmma
            y = conv3x3_valid(xp, wk, relu,
                              plan=None if route == "wgmma" else plan)
            torch.cuda.synchronize()
            check(conv3x3_valid.launches - n == 1 and conv3x3_valid.launches_wgmma
                  - n_wg == (route == "wgmma"), f"conv3x3_valid relu={relu}: "
                  f"not on the {route} route")
            over = ulp_excess(y, y_ref, conv_floor(y_ref))
            err = (y.float() - y_ref.float()).abs().max().item()
            print(f"[kernels] conv3x3_valid relu={relu} ({route}): max|err| "
                  f"{err:.3e}, beyond 1 ulp by {over:.3e}")
            check(over <= 0, f"conv3x3_valid relu={relu} ({route}): beyond 1 "
                  f"ulp by {over}")
            row["max_abs_err" if route == "wgmma" else "mma_sync_max_abs_err"] = err
            if route == "wgmma":
                worst = max(worst, err)
        row["ms"] = cuda_ms(lambda: conv3x3_valid(xp, wk, relu))
        row["mma_sync_ms"] = cuda_ms(lambda: conv3x3_valid(
            xp, wk, relu, plan=vplans["mma_sync"]))
        row["plain_ms"] = cuda_ms(lambda: conv3x3_valid_ref(xp, wk, relu),
                                  iters=5)
        detail[f"conv3x3_valid relu={relu}"] = row
    # without ReLU the function is F.conv2d on the padded input
    searched = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    main = detail["conv3x3_valid relu=False"]
    main["library_ms"] = cuda_ms(lambda: F.conv2d(xp, wk))
    torch.backends.cudnn.benchmark = searched
    n_out = xp.shape[0] * C * H * W
    main.update(bound(2 * (xp.numel() + n_out), 2 * 9 * C * n_out, BF16_FLOPS))
    main.update(route="wgmma", plan=vplans["wgmma"]._asdict(),
                share_of_bound=main["bound_ms"] / main["ms"],
                mma_sync_share_of_bound=main["bound_ms"] / main["mma_sync_ms"],
                speedup_vs_mma_sync=main["mma_sync_ms"] / main["ms"],
                vs_library=main["library_ms"] / main["ms"])
    print("[kernels] conv3x3_valid relu=False: " + json.dumps(main))
    rec["conv3x3_valid"] = dict(main, max_abs_err=worst)

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


def phase_quant_kernels(dev):
    """The stochastic quantizer against its twin: N(0, 0.02) (the flagship
    init) at a trunk conv weight's 2-D shape, and a ragged shape; q and
    scale bit-identical, q * scale within one step of x (+1e-6 for the
    product's rounding). Then the int8 trunk conv at the flagship trunk
    shape: the card's int32 accumulator equal to the CPU's, and its time
    beside cuDNN's bf16 conv on the same activation (reflect pad + conv +
    bias, as the plain trunk serves it). Returns {name: record}, details."""
    import torch
    import torch.nn.functional as F
    from pix2pixhdaudiosr_torch.ops import quant

    gen = torch.Generator(device=dev).manual_seed(9)
    rec, detail = {}, {}
    for shape in (TRUNK_W2D, (1000, 136)):
        x = torch.randn(shape, generator=gen, device=dev) * 0.02
        q, s = quant.stochastic_quantize_2d(x, 1234)
        q_ref, s_ref = quant.stochastic_quantize_2d_ref(x, 1234)
        torch.cuda.synchronize()
        err = max((q.int() - q_ref.int()).abs().max().item(),
                  (s - s_ref).abs().max().item())
        steps = ((q.float() * s - x).abs() / s).max().item()
        print(f"[kernels] stochastic_quantize_2d {list(shape)}: max|err| "
              f"{err}, max|q*s - x| {steps:.6f} steps")
        check(torch.equal(q, q_ref) and torch.equal(s, s_ref),
              f"stochastic_quantize_2d {shape}: not bit-identical ({err})")
        check(steps <= 1 + 1e-6, f"stochastic_quantize_2d {shape}: "
              f"{steps} steps from x")
        detail[f"stochastic_quantize_2d {list(shape)}"] = dict(
            max_abs_err=err, max_steps=steps,
            ms=cuda_ms(lambda: quant.stochastic_quantize_2d(x, 1234)),
            plain_ms=cuda_ms(lambda: quant.stochastic_quantize_2d_ref(x, 1234),
                             iters=5))
    main = detail[f"stochastic_quantize_2d {list(TRUNK_W2D)}"]
    # reads x (f32) and writes q (int8) and a scale a column; ~30 integer
    # ops an element for the three hashes. No PyTorch call computes it.
    n = TRUNK_W2D[0] * TRUNK_W2D[1]
    rec["stochastic_quantize_2d"] = dict(
        main, library_ms=None,
        **bound(5 * n + 4 * TRUNK_W2D[1], 30 * n, INT32_OPS))

    B, C, H, W = TRUNK_SHAPE
    cpu = torch.Generator().manual_seed(10)
    x = torch.randn(TRUNK_SHAPE, generator=cpu).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    w = (torch.randn(C, C, 3, 3, generator=cpu) * 0.02).to(torch.bfloat16)
    b = torch.zeros(C, dtype=torch.bfloat16)
    kq, sw = quant.quantize_conv_weight(w)
    t0 = time.perf_counter()
    acc, sx = quant.conv3x3_int8_acc(x, kq)
    cpu_s = time.perf_counter() - t0
    xc, wc, bc = x.to(dev), w.to(dev), b.to(dev)
    kq_c, sw_c = quant.quantize_conv_weight(wc)
    acc_c, sx_c = quant.conv3x3_int8_acc(xc, kq_c)
    torch.cuda.synchronize()
    same = (torch.equal(kq_c.cpu(), kq) and torch.equal(sw_c.cpu(), sw)
            and torch.equal(acc_c.cpu(), acc) and sx_c.item() == sx.item())
    print(f"[kernels] conv3x3_int8 {list(TRUNK_SHAPE)} bf16: int32 "
          f"accumulator on the card {'equals' if same else 'DIFFERS FROM'} "
          f"the CPU's (CPU {cpu_s:.1f} s)")
    check(same, "conv3x3_int8: the card's accumulator differs from the CPU's")
    del acc, acc_c
    cols = torch.zeros(B * H * W, 9 * C, dtype=torch.int8, device=dev)
    searched = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    detail["conv3x3_int8"] = dict(
        shape=f"{list(TRUNK_SHAPE)} bf16",
        ms=cuda_ms(lambda: quant.conv3x3_int8(xc, kq_c, sw_c, bc)),
        int_mm_ms=cuda_ms(lambda: torch._int_mm(cols, kq_c.t())),
        quantize_weight_ms=cuda_ms(lambda: quant.quantize_conv_weight(wc)),
        cudnn_bf16_ms=cuda_ms(lambda: F.conv2d(
            F.pad(xc, (1, 1, 1, 1), mode="reflect"), wc, bc)))
    torch.backends.cudnn.benchmark = searched
    print("[kernels] conv3x3_int8 timing " + json.dumps(detail["conv3x3_int8"]))
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


def phase_generate(dev, counters, wav: str, n_in: int, extra=(),
                   expect=()) -> dict:
    """One run of the generate CLI; every counter in `counters` must move,
    and every line in `expect` must be among what it printed."""
    import numpy as np
    from pix2pixhdaudiosr_torch import generate
    from pix2pixhdaudiosr_torch.data.wavio import read_wav

    argv = ["--name", "smoke", "--checkpoints_dir", WORK, "--dataroot", wav,
            "--load_pretrain", os.path.join(WORK, "smoke"), "--batchSize",
            "16", "--no_html", "--device", dev, *FLAGSHIP, *extra]
    for fn in counters.values():
        reset_counts(fn)
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        audio = generate.main(argv)
    seconds = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    launches_tc = {k: fn.launches_tc for k, fn in counters.items()
                   if hasattr(fn, "launches_tc")}
    onepass = {k: fn.launches_onepass for k, fn in counters.items()
               if hasattr(fn, "launches_onepass")}
    wgmma = {k: fn.launches_wgmma for k, fn in counters.items()
             if hasattr(fn, "launches_wgmma")}
    sys.stdout.write(out.getvalue())
    print(f"[generate{' ' + ' '.join(extra) if extra else ''}] "
          f"{seconds:.1f} s, launches {launches}, on the tensor-core route "
          f"{launches_tc}, on the one-pass route {onepass}, on the wgmma "
          f"route {wgmma}")
    for k, n in launches.items():
        check(n > 0, f"kernel {k} was not launched by the generate run")
    # the flagship codec (512/256) takes the tensor-core MDCT kernels only
    for k, n in launches_tc.items():
        check(n == launches[k], f"{k}: {launches[k] - n} of {launches[k]} "
              f"launches took the FFMA route, not the tensor-core route")
    # every flagship InstanceNorm shape takes the one-pass route
    for k, n in onepass.items():
        check(n == launches[k], f"{k}: {launches[k] - n} of {launches[k]} "
              f"launches took the two-pass route")
    # every flagship enhancer conv takes the wgmma route
    for k, n in wgmma.items():
        check(n == launches[k], f"{k}: {launches[k] - n} of {launches[k]} "
              f"launches took the mma.sync route")
    for line in expect:
        check(line in out.getvalue().splitlines(),
              f"the generate run did not print {line!r}")
    check(bool(np.isfinite(audio).all()), "generate produced non-finite audio")
    check(float(np.abs(audio).max()) > 0, "generate produced silence")
    sr, rate = read_wav(os.path.join(WORK, "smoke", "sr_audio.wav"))
    check(rate == 48000, f"sr_audio.wav at {rate} Hz")
    check(sr.shape[1] >= n_in, f"sr_audio.wav has {sr.shape[1]} < {n_in}")
    with open(os.path.join(WORK, "smoke", "metric.txt")) as f:
        vals = [float(v) for v in f.read().split("\n")[1].split(",")]
    check(all(np.isfinite(vals)), f"metric.txt not finite: {vals}")
    return dict(launches=launches, launches_tc=launches_tc,
                launches_onepass=onepass, launches_wgmma=wgmma,
                seconds=seconds, metric=vals)


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


def flagship_system(dev, extra=()):
    """The flagship system in bf16 as generate loads it, with `extra`
    flags. Its netG switches paths in place: `fused_enh_blocks` for the
    fused enhancer section, the global trunk's `int8_blocks` for the int8
    trunk (set_path)."""
    import torch
    from pix2pixhdaudiosr_torch.config import parse_config
    from pix2pixhdaudiosr_torch.generate import load_system

    cfg = parse_config(["--name", "smoke", "--checkpoints_dir", WORK,
                        "--load_pretrain", os.path.join(WORK, "smoke"),
                        *FLAGSHIP, *extra], is_train=False, save=False)
    return load_system(cfg, torch.device(dev))


def seeded_batch(system, dev, batch: int):
    """A seeded lr batch [batch, SEG] and its mask noise."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(3)
    lr = torch.randn(batch, SEG, generator=gen, device=dev) * 0.1
    b, f, t, c = system.spectro_shape(batch)
    noise = torch.randn(b, system.codec.mask_size(f), t, c, generator=gen,
                        device=dev)
    return lr, noise


def set_path(system, fused: bool = False, int8: bool = False) -> None:
    system.netG.fused_enh_blocks = fused
    getattr(system.netG, "global").int8_blocks = int8


def phase_fused_vs_plain(system, lr, noise) -> dict:
    """Fused against unfused G output on the card: bf16, one batch, the
    same weights and noise; bound max|diff| <= 0.05 max|unfused| (the JAX
    package's own bound, tests/test_enhancer_pallas.py:110)."""
    import torch
    from pix2pixhdaudiosr_torch.ops import enhancer

    out = {}
    for fused in (False, True):
        set_path(system, fused=fused)
        fn = enhancer.conv3x3_in
        n, n_wg = fn.launches, fn.launches_wgmma
        with torch.no_grad():
            out[fused] = system.inference(lr, noise=noise)[0]
        check(fn.launches - n == 4 * fused,
              f"fused={fused}: conv3x3_in launched {fn.launches - n}x")
        check(fn.launches_wgmma - n_wg == fn.launches - n,
              f"fused={fused}: {fn.launches - n - fn.launches_wgmma + n_wg} "
              f"conv3x3_in launches took the mma.sync route")
    set_path(system)
    scale = out[False].abs().max().item()
    err = (out[True] - out[False]).abs().max().item()
    res = dict(max_abs_diff=err, max_abs_unfused=scale, ratio=err / scale,
               bound=0.05)
    print("[fused vs plain] " + json.dumps(res))
    check(bool(torch.isfinite(out[True]).all()), "fused G output not finite")
    check(err <= 0.05 * scale, f"fused G output off the unfused: {err} > "
          f"0.05 * {scale}")
    return res


def phase_quant_vs_plain(system, dq_system, lr, noise) -> dict:
    """--int8_trunk G (the same system, trunk switched to int8) and
    --data_type 8 G (dq_system, loaded with the flag) against the plain G on
    the card: bf16, one batch, the same weights and noise; correlation
    >= 0.99, the JAX package's own bound (tests/test_quant.py:47, :114).
    Also prints max|diff| / max|plain|."""
    import torch
    from pix2pixhdaudiosr_torch.ops import quant

    n_convs = 2 * getattr(system.netG, "global").n_blocks
    out = {}
    for name, sys_, int8 in (("plain", system, False),
                             ("int8_trunk", system, True),
                             ("data_type_8", dq_system, False)):
        set_path(sys_, int8=int8)
        n = quant.conv3x3_int8.launches
        with torch.no_grad():
            out[name] = sys_.inference(lr, noise=noise)[0].double()
        launched = quant.conv3x3_int8.launches - n
        check(launched == (n_convs if int8 else 0),
              f"{name}: conv3x3_int8 launched {launched}x")
    set_path(system)
    plain = out["plain"].flatten()
    scale = plain.abs().max().item()
    res = {}
    for name in ("int8_trunk", "data_type_8"):
        got = out[name].flatten()
        check(bool(torch.isfinite(got).all()), f"{name} G output not finite")
        corr = torch.corrcoef(torch.stack([got, plain]))[0, 1].item()
        res[name] = dict(corr=corr, ratio=(got - plain).abs().max().item()
                         / scale, bound_corr=0.99)
        print(f"[{name} vs plain] " + json.dumps(res[name]))
        check(corr >= 0.99, f"{name} G output correlates {corr} < 0.99 with "
              f"the plain G")
    return res


def phase_serve_timing(system, lr, noise, counters) -> dict:
    """ms/batch, frames/s and peak GiB of the serve forward at batch 128,
    plain, fused and int8 trunk in turns (plain, fused, int8, int8, fused,
    plain), 5 forwards after 2 warm-ups each; plain and int8 at batch 1 in
    turns (plain, int8, int8, plain), 20 forwards after 3 warm-ups; then one
    traced forward of each path at batch 128, and the launches of each
    kernel wrapper in `counters` during one untraced forward."""
    import torch
    t = system.n_frames
    paths = {"plain": {}, "fused_enhancer": dict(fused=True),
             "int8_trunk": dict(int8=True)}

    def timed(lr_, noise_, order, iters, warmup):
        def serve():
            with torch.no_grad():
                sr, pha, norm, _ = system.inference(lr_, noise=noise_)
                return system.codec.imdct_eval(torch.abs(sr), pha, norm)
        runs = {name: [] for name in order}
        for name in order:
            set_path(system, **paths[name])
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_ms(serve, iters=iters, warmup=warmup)
            runs[name].append((ms, torch.cuda.max_memory_allocated() / 2**30))
        res = {}
        for name, rs in runs.items():
            ms = sum(r[0] for r in rs) / len(rs)
            res[name] = dict(batch=lr_.shape[0], ms_per_batch=ms,
                             ms_runs=[r[0] for r in rs],
                             frames_per_s=lr_.shape[0] * t / (ms / 1e3),
                             peak_gib=max(r[1] for r in rs))
            print(f"[serve {name} b{lr_.shape[0]}] " + json.dumps(res[name]))
        return res, serve

    res, serve = timed(lr, noise, ("plain", "fused_enhancer", "int8_trunk",
                                   "int8_trunk", "fused_enhancer", "plain"),
                       iters=5, warmup=2)
    res["batch1"], _ = timed(lr[:1], noise[:1], ("plain", "int8_trunk",
                                                 "int8_trunk", "plain"),
                             iters=20, warmup=3)
    for name in paths:
        set_path(system, **paths[name])
        res[name]["profile"] = profile_serve(serve)
        print(f"[profile {name}] " + json.dumps(res[name]["profile"]))
        for fn in counters.values():
            reset_counts(fn)
        serve()
        res[name]["launches"] = {k: fn.launches for k, fn in counters.items()}
        inorm = counters["instance_norm_act"]
        res[name]["in_launches_onepass"] = inorm.launches_onepass
        res[name]["in_launches_by_shape"] = {
            f"{h}x{w}x{c}": n for (h, w, c), n in inorm.launches_by_shape.items()}
        print(f"[launches {name} b{lr.shape[0]}] "
              + json.dumps(res[name]["launches"]) + " InstanceNorm one-pass "
              + json.dumps(res[name]["in_launches_onepass"]) + " by shape "
              + json.dumps(res[name]["in_launches_by_shape"]))
        check(inorm.launches == inorm.launches_onepass == IN_LAUNCHES[name],
              f"{name}: {inorm.launches} InstanceNorm launches, "
              f"{inorm.launches_onepass} one-pass; expected "
              f"{IN_LAUNCHES[name]}, all one-pass")
        conv = counters["conv3x3_in"]
        res[name]["conv3x3_in_launches_wgmma"] = conv.launches_wgmma
        want = 4 if name == "fused_enhancer" else 0
        check(conv.launches == conv.launches_wgmma == want,
              f"{name}: {conv.launches} conv3x3_in launches, "
              f"{conv.launches_wgmma} on the wgmma route; expected {want}, "
              f"all on the wgmma route")
    set_path(system)
    return res


def phase_sizes(pth: str) -> dict:
    """quantized_size_bytes of the flagship generator (int8 weights, f32
    scales and biases) against its f32 and bf16 sizes."""
    import torch
    from pix2pixhdaudiosr_torch.ops.quant import (quantize_state_dict,
                                                  quantized_size_bytes)
    state = torch.load(pth, map_location="cpu", weights_only=True)
    n = sum(t.numel() for t in state.values())
    qstate, scales = quantize_state_dict(state)
    res = dict(f32_bytes=4 * n, bf16_bytes=2 * n,
               int8_bytes=quantized_size_bytes(qstate),
               scale_bytes=sum(s.numel() * 4 for s in scales.values()
                               if s is not None))
    print("[sizes] " + json.dumps(res))
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


def b3_per_shape(detail: dict, calls: dict) -> dict:
    """One row per flagship InstanceNorm shape: its calls in one plain
    batch-128 forward; kernel ms by CUDA events (host time of the wrapper
    included) and by the profiler (device time), the two-pass kernels'
    device ms, library and bound ms; and calls x (device ms - bound), the
    device time the forward loses to the kernel there."""
    rows = {}
    for H, W, C in IN_SHAPES:
        d, key = detail[f"instance_norm_act {H}x{W}x{C}"], f"{H}x{W}x{C}"
        n = calls.get(key, 0)
        rows[key] = dict(calls=n, route=d["route"], ms=d["ms"],
                         device_ms=d["device_ms"],
                         two_pass_device_ms=d["two_pass_device_ms"],
                         bound_ms=d["bound_ms"], library_ms=d["library_ms"],
                         share_of_bound=d["bound_ms"] / d["device_ms"],
                         lost_ms=n * (d["device_ms"] - d["bound_ms"]))
        print(f"[B3 {key}] " + json.dumps(rows[key]))
    total = {k: sum(r["calls"] * r[k] for r in rows.values())
             for k in ("device_ms", "two_pass_device_ms", "bound_ms")}
    total["calls"] = sum(r["calls"] for r in rows.values())
    print("[B3 plain forward] " + json.dumps(total))
    return dict(rows, total=total)


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
        from pix2pixhdaudiosr_torch.ops.quant import (conv3x3_int8,
                                                      stochastic_quantize_2d)
        lib = _cuda.build()
        _cuda.library()
        print(f"[build] {lib} in {time.perf_counter() - t0:.1f} s")
        print(open(lib.parent / "build.log").read()[-3000:])

        rec, detail = phase_kernels(dev)
        for phase in (phase_conv_kernels, phase_quant_kernels):
            rec_p, detail_p = phase(dev)
            rec.update(rec_p)
            detail.update(detail_p)
        # no path calls B5 or B6: their launches are phase 3's
        valid_launches = conv3x3_valid.launches
        quant_launches = stochastic_quantize_2d.launches
        shutil.rmtree(WORK, ignore_errors=True)
        os.makedirs(os.path.join(WORK, "smoke"))
        wav = os.path.join(WORK, "input_48k.wav")
        n_in = write_synthetic_wav(wav)
        pth = flagship_generator_pth(os.path.join(WORK, "smoke"))
        counters = {"mdct2": mdct2, "imdct2": imdct2,
                    "instance_norm_act": instance_norm_act}
        gen_res = phase_generate(dev, counters, wav, n_in)
        gen_fused = phase_generate(dev, dict(
            counters, conv3x3_in=conv3x3_in, instance_stats=instance_stats),
            wav, n_in, FUSED)
        gen_quant = phase_generate(dev, dict(counters,
                                             conv3x3_int8=conv3x3_int8),
                                   wav, n_in, QUANT,
                                   expect=["int8 weight quantization enabled"])
        ref_err = phase_reference(dev)
        system = flagship_system(dev, ["--fused_enhancer"])
        lr, noise = seeded_batch(system, dev, 128)
        fused_err = phase_fused_vs_plain(system, lr, noise)
        quant_err = phase_quant_vs_plain(
            system, flagship_system(dev, ["--data_type", "8"]), lr, noise)
        serve = phase_serve_timing(system, lr, noise, dict(
            counters, conv3x3_in=conv3x3_in, conv3x3_valid=conv3x3_valid,
            stochastic_quantize_2d=stochastic_quantize_2d))
        sizes = phase_sizes(pth)
    except (SmokeFailure, ImportError, RuntimeError, ValueError) as e:
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(WORK, ignore_errors=True)

    b3 = b3_per_shape(detail, serve["plain"]["in_launches_by_shape"])
    launches = dict(gen_res["launches"],
                    conv3x3_in=gen_fused["launches"]["conv3x3_in"],
                    conv3x3_valid=valid_launches,
                    stochastic_quantize_2d=quant_launches)
    kernels = [dict(name=k, route="cuda", source=KERNELS[k][0],
                    replaces=KERNELS[k][1], launches=launches[k],
                    **{f: rec[k][f] for f in (
                        "max_abs_err", "ms", "plain_ms", "bound_ms",
                        "bound_by", "library_ms")}) for k in KERNELS]
    print("[detail] " + json.dumps(dict(
        card=smi, torch=torch.__version__, cuda=torch.version.cuda,
        kernel_detail=detail, generate=gen_res, generate_fused=gen_fused,
        generate_quant=gen_quant, reference_max_abs_err=ref_err,
        fused_vs_plain=fused_err, quant_vs_plain=quant_err, serve=serve,
        sizes=sizes, b3_per_shape=b3)))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
