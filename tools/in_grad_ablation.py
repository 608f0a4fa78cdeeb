#!/usr/bin/env python3
"""Routes of the InstanceNorm backward kernel (B3's gradient) side by side,
on one NVIDIA GPU.

    python3 tools/in_grad_ablation.py [--batch 64] [--dtype bfloat16]

At every training InstanceNorm shape (the flagship generator's 6 with relu,
the discriminator's 6 with leaky), times ops/norm.instance_norm_act_grad
(pix2pixhdaudiosr_torch/csrc/instance_norm_bwd.cu) on the same x, dy and
saved statistics under:
  as_is      the planner's route (plan_instance_norm_grad);
  narrow     the one-pass route with 16-byte tiles admitted (narrow=True),
             where that plan differs from as_is (512 x 128 x 48: the only
             tile whose x and dy fit a cluster);
  two_pass   the two-pass kernels (partial sums, finalize, apply);
beside the closed form (instance_norm_act_backward, plain PyTorch) and
autograd through F.instance_norm and the activation (the library
yardstick). as_is runs first and again last. Times are CUDA events over 20
calls after 3 warm-ups (the wrapper's host time included, as on the train
path) and the profiler's device time, with the L2 warm and with it evicted
before each call (the share of the bound is read from the latter); the
bound is 3 planes (x and dy read, dx written) at 3.35 TB/s. Each route's dx is held within one bf16
ulp + 1e-4 max|dx| (f32: 1e-4 max|dx|) of the twin and two runs must give
the same bits. Prints the card's name and power limit, then one JSON line
a shape and variant. Exits non-zero without a card or on a disagreement.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import (D_IN_SHAPES, F32_FLOPS, IN_SHAPES, bound,  # noqa: E402
                        cuda_ms, device_ms, ulp_excess)


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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--dtype", default="bfloat16")
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
    bad = 0
    for shapes, act in ((IN_SHAPES, "relu"), (D_IN_SHAPES, "leaky")):
        for H, W, C in shapes:
            shape = (args.batch, C, H, W)
            x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5
                 ).to(dtype).contiguous(memory_format=torch.channels_last)
            dy = torch.randn(shape, generator=gen, device="cuda").to(
                dtype).contiguous(memory_format=torch.channels_last)
            y, saved = norm.instance_norm_act(x, act, with_stats=True)
            want = norm.instance_norm_act_grad_ref(x, dy, saved, act)
            b = grad_bound(x)
            as_is = norm.plan_instance_norm_grad(args.batch, H, W, C, dtype)
            narrow = norm.plan_instance_norm_grad(args.batch, H, W, C, dtype,
                                                  narrow=True)
            variants = [("as_is", as_is)]
            if narrow != as_is:
                variants.append(("narrow", narrow))
            if as_is.route != "twopass":
                variants.append(("two_pass", norm.INPlan("twopass")))
            variants.append(("as_is", as_is))
            for name, plan in variants:
                def run(plan=plan):
                    return norm.instance_norm_act_grad(x, dy, saved, act,
                                                       plan=plan)
                got = run()
                torch.cuda.synchronize()
                row = dict(shape=f"{H}x{W}x{C}", batch=args.batch,
                           dtype=args.dtype, act=act, variant=name,
                           plan=plan._asdict(),
                           excess=dx_excess(got, want),
                           bit_identical=bool(torch.equal(run(), got)),
                           ms=cuda_ms(run), device_ms=device_ms(run),
                           cold_device_ms=device_ms(run, cold=True), **b)
                row["share_of_bound"] = b["bound_ms"] / row["cold_device_ms"]
                bad += row["excess"] > 0 or not row["bit_identical"]
                print("[in grad ablation] " + json.dumps(row))
            xr = x.detach().requires_grad_(True)
            yl = norm.activate(F.instance_norm(xr), act)
            yardsticks = dict(
                shape=f"{H}x{W}x{C}", batch=args.batch, dtype=args.dtype,
                closed_form_ms=cuda_ms(lambda: norm.instance_norm_act_backward(
                    x, y, dy, act), iters=5, warmup=1),
                library_ms=cuda_ms(lambda: torch.autograd.grad(
                    yl, xr, dy, retain_graph=True), iters=10, warmup=2))
            print("[in grad yardsticks] " + json.dumps(yardsticks))
            del x, dy, y, saved, want, got, xr, yl
            torch.cuda.empty_cache()
    if bad:
        print(f"in_grad_ablation: {bad} runs off the twin or not "
              f"bit-identical", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
