#!/usr/bin/env python3
"""Plans of the one-pass InstanceNorm kernel (B3) side by side, on one
NVIDIA GPU.

    python3 tools/in_onepass_ablation.py [--batch 128]

At every flagship InstanceNorm shape, bf16, act "none", times the kernel of
pix2pixhdaudiosr_torch/csrc/instance_norm.cu under plans that
ops/norm.plan_instance_norm makes with other limits, and the two-pass
kernels, in turns on the same input (CUDA events, mean of 20 launches after
3 warm-ups, the torch wrapper's host time included as in the serve path).
Variants (block bytes = staged bytes a block aims at, K = cluster size,
tile = bytes of a position's channels a cluster owns):
  as_is       the planner's limits: 64 KB blocks (128 KB where that keeps a
              tile of a whole 32-byte sector), K <= 16, tile <= 128 B
              (wider for planes of at most 32 KB);
  portable    K <= 8: at 512 x 128 x 48, 16-byte tiles (half a sector of
              each 96-byte row) in 128 KB blocks;
  block128k   128 KB blocks: one an SM;
  block32k    32 KB blocks: more blocks an SM, larger clusters;
  tile512     tiles up to 512 B at every shape;
  two_pass    the two-pass kernels (statistics, finalize, apply).
as_is runs first and again last. Each variant's output is held within one
bf16 ulp of the twin. Prints the card's name and power limit, then one JSON
line a shape and variant (plan, ms, share of the bound). Exits non-zero
without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import F32_FLOPS, IN_SHAPES, bound, cuda_ms, ulp_excess  # noqa: E402

VARIANTS = {
    "as_is": {},
    "portable": dict(max_cluster=8),
    "block128k": dict(block_bytes=131072),
    "block32k": dict(block_bytes=32768),
    "tile512": dict(tile_bytes=512),
}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=128)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("in_onepass_ablation: CUDA is not available", file=sys.stderr)
        return 1
    from pix2pixhdaudiosr_torch.ops import norm

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    gen = torch.Generator(device="cuda").manual_seed(11)
    rows = []
    for H, W, C in IN_SHAPES:
        x = torch.randn(args.batch, C, H, W, generator=gen, device="cuda",
                        dtype=torch.bfloat16).contiguous(
                            memory_format=torch.channels_last)
        want = norm.instance_norm_act_ref(x, "none")
        pitches = (H * W * C, W * C)
        b = bound(2 * 2 * x.numel(), 8 * x.numel(), F32_FLOPS)["bound_ms"]
        for name in (*VARIANTS, "two_pass", "as_is"):
            y = torch.empty_like(x)
            if name == "two_pass":
                plan = norm.INPlan("twopass")

                def run():
                    norm._launch_twopass(x, y, "none", 1e-5)
            else:
                plan = norm.plan_instance_norm(args.batch, H, W, C, x.dtype,
                                               **VARIANTS[name])
                if plan.route != "onepass":
                    continue

                def run():
                    norm._launch_onepass(x, y, plan, pitches, "none", 1e-5)
            row = dict(shape=f"{H}x{W}x{C}", batch=args.batch, variant=name,
                       plan=plan._asdict())
            try:
                run()
                torch.cuda.synchronize()
            except RuntimeError as e:   # a cluster the card cannot hold
                row["refused"] = str(e)
                print("[ablation] " + json.dumps(row))
                rows.append(row)
                continue
            row["ulp_excess"] = ulp_excess(y, want)
            row["ms"] = cuda_ms(run)
            row["bound_ms"] = b
            row["share_of_bound"] = b / row["ms"]
            row["gbps"] = 2 * 2 * x.numel() / row["ms"] / 1e6
            print("[ablation] " + json.dumps(row))
            rows.append(row)
        del x, want, y
    bad = [r for r in rows if r.get("ulp_excess", 0) > 0]
    if bad:
        print(f"in_onepass_ablation: {len(bad)} variants beyond one ulp",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
