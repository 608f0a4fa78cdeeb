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
     bf16 and at atol 1e-5 in f32; the fused conv3x3_in at
     [128, 96, 256, 64] bf16 for each prologue, y within one bf16 ulp
     (+1e-6 max(1, max|y|) near zero) and its mean and scale within 1e-4
     of the channel's magnitude;
     conv3x3_valid at [64, 96, 258, 66] with and without ReLU, within one
     bf16 ulp (+ the same floor); the stochastic quantizer at [13824, 1536]
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
     launch took the tensor-core route (the `launches_tc` counters), and
     that the quantized run printed "int8 weight quantization enabled";
     hold the CUDA serve path against the same path on the CPU in f32 on
     one segment, stage by stage; hold the fused G output against the
     unfused one on the card (bf16, one batch of 128, max|diff| <= 0.05
     max|unfused|), and the --int8_trunk and --data_type 8 G outputs
     against the plain one (correlation >= 0.99);
  8. time the batch-128 serve forward (encode + G + decode) in bf16, plain,
     --fused_enhancer and --int8_trunk in turns (plain, fused, int8, int8,
     fused, plain), and plain and int8 at batch 1 (plain, int8, int8,
     plain); trace one forward of each path with torch.profiler (device
     time by kernel) and count each kernel's launches in one forward; print
     the flagship's int8 size against f32 and bf16.
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
    "conv3x3_in": ("pix2pixhdaudiosr_torch/csrc/conv3x3_in.cu",
                   "pix2pixhdaudiosr_tpu/ops/enhancer_pallas.py:182"),
    "conv3x3_valid": ("pix2pixhdaudiosr_torch/csrc/conv3x3_in.cu",
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


def device_ms(fn, iters: int = 20) -> float:
    """Mean device time of the kernels fn() launches, in ms, from
    torch.profiler: unlike cuda_ms, it leaves out the host time between
    launches, which is most of a call where the kernel is short. The
    first of two traced runs is a warm-up: a process's first trace can
    come back without kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3 / iters


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
    from pix2pixhdaudiosr_torch.ops.norm import (instance_norm_act,
                                                 instance_norm_act_ref)
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
        # act "none" is the function F.instance_norm computes; one read and
        # one write of x, ~8 f32 operations an element
        detail[f"instance_norm_act {H}x{W}x{C}"] = dict(
            shape=f"B={batch} bf16", relu_ms=cuda_ms(
                lambda: instance_norm_act(xb, "relu"), iters=10),
            ms=cuda_ms(lambda: instance_norm_act(xb, "none"), iters=10),
            plain_ms=cuda_ms(lambda: instance_norm_act_ref(xb, "none"),
                             iters=10),
            library_ms=cuda_ms(lambda: F.instance_norm(xb), iters=10),
            **bound(2 * 2 * xb.numel(), 8 * xb.numel(), F32_FLOPS))
        del xb
    big = detail[f"instance_norm_act {IN_SHAPES[0][0]}x{IN_SHAPES[0][1]}x"
                 f"{IN_SHAPES[0][2]}"]
    rec["instance_norm_act"] = dict(big, max_abs_err=worst)
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
    rec["conv3x3_in"] = dict(main, max_abs_err=worst, library_ms=None)

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
    # without ReLU the function is F.conv2d on the padded input
    searched = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    main = detail["conv3x3_valid relu=False"]
    main["library_ms"] = cuda_ms(lambda: F.conv2d(xp, wk))
    torch.backends.cudnn.benchmark = searched
    n_out = xp.shape[0] * C * H * W
    main.update(bound(2 * (xp.numel() + n_out), 2 * 9 * C * n_out, BF16_FLOPS))
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
        fn.launches = 0
        if hasattr(fn, "launches_tc"):
            fn.launches_tc = 0
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        audio = generate.main(argv)
    seconds = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    launches_tc = {k: fn.launches_tc for k, fn in counters.items()
                   if hasattr(fn, "launches_tc")}
    sys.stdout.write(out.getvalue())
    print(f"[generate{' ' + ' '.join(extra) if extra else ''}] "
          f"{seconds:.1f} s, launches {launches}, on the tensor-core route "
          f"{launches_tc}")
    for k, n in launches.items():
        check(n > 0, f"kernel {k} was not launched by the generate run")
    # the flagship codec (512/256) takes the tensor-core MDCT kernels only
    for k, n in launches_tc.items():
        check(n == launches[k], f"{k}: {launches[k] - n} of {launches[k]} "
              f"launches took the FFMA route, not the tensor-core route")
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
    return dict(launches=launches, launches_tc=launches_tc, seconds=seconds,
                metric=vals)


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
        n = enhancer.conv3x3_in.launches
        with torch.no_grad():
            out[fused] = system.inference(lr, noise=noise)[0]
        check((enhancer.conv3x3_in.launches > n) == fused,
              f"fused={fused}: conv3x3_in launched {enhancer.conv3x3_in.launches - n}x")
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
            fn.launches = 0
        serve()
        res[name]["launches"] = {k: fn.launches for k, fn in counters.items()}
        print(f"[launches {name} b{lr.shape[0]}] "
              + json.dumps(res[name]["launches"]))
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
        sizes=sizes)))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
