#!/usr/bin/env python3
"""Routes of the InstanceNorm backward kernel (B3's gradient) side by side,
on one NVIDIA GPU.

    python3 tools/in_grad_ablation.py [--groups g,d,t,a] [--layouts nhwc,nchw]
                                      [--dtype bfloat16] [--warm] [--yardsticks]

At the training InstanceNorm shapes (g: the flagship generator's 6 with
relu, d: the discriminator's 6 and t: the time-domain discriminator's 6
with leaky, all at batch 64; a: Family A's 10 with relu at batch 10, bf16),
times ops/norm.instance_norm_act_grad
(pix2pixhdaudiosr_torch/csrc/instance_norm_bwd.cu) on the same x, dy and
saved statistics under every route the shape has:
  onepass     the cluster route at the widest tile a cluster holds;
  narrow      the same with 16-byte tiles admitted, where that differs;
  twopass     the two-pass kernels (partial sums, finalize, apply);
each with dy channels_last and NCHW (read in place: ops/norm.dy_layout).
With --yardsticks, the closed form
(instance_norm_act_backward, plain PyTorch) and autograd through
F.instance_norm and the activation (the library yardstick) a shape.
Times are the profiler's device time with the L2 evicted before each call
(the share of the bound is read from it) and, with --warm, with it warm;
the bound is 3 planes (x and dy read, dx written) at 3.35 TB/s. Each
variant's dx is held within one bf16 ulp + 1e-4 max|dx| of the twin, two
runs must give the same bits, and an NCHW dy's dx must equal its
channels_last copy's. Prints the card's name and power limit, then one JSON
line a shape and variant, and a summary of the fastest route a shape.
Exits non-zero without a card or on a disagreement.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import (D_IN_SHAPES, F32_FLOPS, FAMILY_A_BATCH,  # noqa: E402
                        FAMILY_A_IN_SHAPES, IN_SHAPES, TIME_D_IN_SHAPES,
                        TRAIN_BATCH, bound, cuda_ms, device_ms, ulp_excess)

GROUPS = {"g": (IN_SHAPES, "relu", TRAIN_BATCH),
          "d": (D_IN_SHAPES, "leaky", TRAIN_BATCH),
          "t": (TIME_D_IN_SHAPES, "leaky", TRAIN_BATCH),
          "a": (FAMILY_A_IN_SHAPES, "relu", FAMILY_A_BATCH)}


def grad_bound(x) -> dict:
    """3 planes of x's bytes (x, dy in, dx out), ~20 f32 operations an
    element."""
    return bound(3 * x.element_size() * x.numel(), 20 * x.numel(), F32_FLOPS)


def dx_excess(got, want) -> float:
    """<= 0 when got is within tolerance of want: one bf16 ulp + 1e-4
    max|want| in bf16, 1e-4 max|want| in f32."""
    import torch
    floor = 1e-4 * want.float().abs().max().item()
    if got.dtype == torch.float32:
        return (got - want).abs().max().item() - floor
    return ulp_excess(got, want, floor)


def variants(B, H, W, C, dtype):
    """(name, plan) for every route the shape has."""
    from pix2pixhdaudiosr_torch.ops import norm
    out = []
    wide = norm._onepass_plan(H * W, C * dtype.itemsize, dtype.itemsize, 2,
                              norm.grad_onepass_smem, norm.BLOCK_BYTES,
                              norm.MAX_CLUSTER, norm.TILE_BYTES, False)
    narrow = norm.plan_instance_norm_grad(B, H, W, C, dtype, narrow=True)
    if wide is not None:
        out.append(("onepass", wide))
    if narrow.route == "onepass" and narrow != wide:
        out.append(("narrow", narrow))

    out.append(("twopass", norm.INPlan("twopass")))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--groups", default="g,d,t,a")
    ap.add_argument("--layouts", default="nhwc,nchw")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--warm", action="store_true")
    ap.add_argument("--yardsticks", action="store_true")
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("in_grad_ablation: CUDA is not available", file=sys.stderr)
        return 1
    from pix2pixhdaudiosr_torch.ops import norm

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    dtype = getattr(torch, args.dtype)
    gen = torch.Generator(device="cuda").manual_seed(13)
    bad, best = 0, {}
    for key in args.groups.split(","):
        shapes, act, batch = GROUPS[key]
        for H, W, C in shapes:
            shape = (batch, C, H, W)
            x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5
                 ).to(dtype).contiguous(memory_format=torch.channels_last)
            dy_cl = torch.randn(shape, generator=gen, device="cuda").to(
                dtype).contiguous(memory_format=torch.channels_last)
            y, saved = norm.instance_norm_act(x, act, with_stats=True)
            want = norm.instance_norm_act_grad_ref(x, dy_cl, saved, act)
            b = grad_bound(x)
            for layout in args.layouts.split(","):
                dy = dy_cl if layout == "nhwc" else dy_cl.contiguous()
                for vname, plan in variants(batch, H, W, C, dtype):
                    def run(plan=plan):
                        return norm.instance_norm_act_grad(x, dy, saved, act,
                                                           plan=plan)
                    copies = norm.instance_norm_act_grad.dy_copies
                    got = run()
                    torch.cuda.synchronize()
                    same_as_nhwc = layout == "nhwc" or torch.equal(
                        got, norm.instance_norm_act_grad(x, dy_cl, saved, act,
                                                         plan=plan))
                    row = dict(shape=f"{H}x{W}x{C}", batch=batch,
                               dtype=args.dtype, act=act, dy=layout,
                               variant=vname, plan=plan._asdict(),
                               dy_copies=norm.instance_norm_act_grad.dy_copies
                               - copies,
                               excess=dx_excess(got, want),
                               bit_identical=bool(torch.equal(run(), got)),
                               same_as_nhwc=bool(same_as_nhwc),
                               ms=cuda_ms(run),
                               cold_device_ms=device_ms(run, cold=True), **b)
                    if args.warm:
                        row["device_ms"] = device_ms(run)
                    row["share_of_bound"] = b["bound_ms"] / row["cold_device_ms"]
                    bad += (row["excess"] > 0 or not row["bit_identical"]
                            or not same_as_nhwc or row["dy_copies"] != 0)
                    print("[in grad ablation] " + json.dumps(row), flush=True)
                    k = (batch, H, W, C, layout)
                    if k not in best or row["cold_device_ms"] < best[k][1]:
                        best[k] = (vname, row["cold_device_ms"], plan.route)
                    del got
            if args.yardsticks:
                xr = x.detach().requires_grad_(True)
                yl = norm.activate(F.instance_norm(xr), act)
                print("[in grad yardsticks] " + json.dumps(dict(
                    shape=f"{H}x{W}x{C}", batch=batch, dtype=args.dtype,
                    closed_form_ms=cuda_ms(
                        lambda: norm.instance_norm_act_backward(
                            x, y, dy_cl, act), iters=5, warmup=1),
                    library_ms=cuda_ms(lambda: torch.autograd.grad(
                        yl, xr, dy_cl, retain_graph=True), iters=10,
                        warmup=2))), flush=True)
                del xr, yl
            del x, dy, dy_cl, y, saved, want
            torch.cuda.empty_cache()
    for (batch, H, W, C, layout), (vname, ms, route) in best.items():
        planned = norm.plan_instance_norm_grad(batch, H, W, C, dtype).route
        print(f"[in grad best] {H}x{W}x{C} B={batch} dy {layout}: {vname} "
              f"({route}) {ms:.4f} ms; planner: {planned}")
    if bad:
        print(f"in_grad_ablation: {bad} runs off the twin, not "
              f"bit-identical or copying dy", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
