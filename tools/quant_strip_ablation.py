#!/usr/bin/env python3
"""Plans of the stochastic quantizer (B6) side by side, on one NVIDIA GPU.

    python3 tools/quant_strip_ablation.py

At [13824, 1536] (a flagship trunk conv weight as 2-D) and [1000, 136]
f32, times ops/quant.stochastic_quantize_2d (csrc/quant.cu) on the strip
route at 4, 8, 16 and 32 columns a strip and 16, 32 and 64 KB a block
(plan_quantize's arguments), and on the three-launch route, with q and
scale bit-identical to the twin in each. Times: CUDA events over 20 calls
after 3 warm-ups, and the profiler's device time with the L2 evicted before
each call; the bound is x read and q and the scale written at 3.35 TB/s.
Prints the card's name and power limit, then one JSON line a plan. Exits
non-zero without a card or on a disagreement.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import HBM_BPS, TRUNK_W2D, cuda_ms, device_ms  # noqa: E402


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("quant_strip_ablation: CUDA is not available", file=sys.stderr)
        return 1
    from pix2pixhdaudiosr_torch.ops import quant
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(9)
    bad = 0
    for M, N in (TRUNK_W2D, (1000, 136)):
        x = torch.randn(M, N, generator=gen, device="cuda") * 0.02
        q_ref, s_ref = quant.stochastic_quantize_2d_ref(x, 1234)
        plans = [quant.plan_quantize(M, N, True, cols, block)
                 for cols in (4, 8, 16, 32) for block in (16384, 32768, 65536)]
        plans = list(dict.fromkeys(plans)) + [quant.QuantPlan("threepass")]
        for plan in plans:
            def run(plan=plan):
                return quant.stochastic_quantize_2d(x, 1234, plan)
            q, s = run()
            torch.cuda.synchronize()
            same = torch.equal(q, q_ref) and torch.equal(s, s_ref)
            bad += not same
            row = dict(shape=[M, N], plan=plan._asdict(), bit_identical=same,
                       planner=plan == quant.plan_quantize(M, N),
                       ms=cuda_ms(run), cold_device_ms=device_ms(run, cold=True),
                       bound_ms=(5 * M * N + 4 * N) / HBM_BPS * 1e3)
            row["share_of_bound"] = row["bound_ms"] / row["cold_device_ms"]
            print("[quant ablation] " + json.dumps(row), flush=True)
        del x, q_ref, s_ref
    if bad:
        print(f"quant_strip_ablation: {bad} plans off the twin",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
