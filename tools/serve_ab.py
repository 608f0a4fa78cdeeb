#!/usr/bin/env python3
"""The flagship batch-128 serve times of two trees of the port, side by side
on one card; with --step, the flagship batch-64 train step's.

    python3 tools/serve_ab.py [--step] PARENT_DIR CHANGE_DIR

Each directory is a checkout of the repo (e.g. from `git archive`). The
script runs one child process a turn, in the order parent, change, change,
parent; each child imports `chip_smoke` and the package from its own tree
(building that tree's kernels into its own `_build/`), writes the flagship
generator with seeded N(0, 0.02) weights, and times the serve forward
(encode + G + decode, bf16, batch 128) with CUDA events, 5 forwards after
2 warm-ups, the paths in turns: plain, fused, int8, int8, fused, plain
(chip_smoke phase 8's order). It prints one JSON line a turn and a summary
line: ms/batch of each path for each turn, with the card's name and power
limit. With --step each child runs chip_smoke.phase_train_step (the plain
flagship step at batch 64: 5 timed steps after 2, CUDA events) instead,
and the summary holds its ms/step runs.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

PATHS = {"plain": {}, "fused_enhancer": dict(fused=True),
         "int8_trunk": dict(int8=True)}
ORDER = ("plain", "fused_enhancer", "int8_trunk", "int8_trunk",
         "fused_enhancer", "plain")


def child(root: str) -> dict:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch
    import chip_smoke as cs
    from pix2pixhdaudiosr_torch.ops import _cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True  # as the generate CLI serves
    _cuda.library()
    cs.WORK = os.path.join(root, "_smoke_run")
    os.makedirs(os.path.join(cs.WORK, "smoke"), exist_ok=True)
    cs.flagship_generator_pth(os.path.join(cs.WORK, "smoke"))
    system = cs.flagship_system("cuda", ["--fused_enhancer"])
    lr, noise = cs.seeded_batch(system, "cuda", 128)

    def serve():
        with torch.no_grad():
            sr, pha, norm, _ = system.inference(lr, noise=noise)
            return system.codec.imdct_eval(torch.abs(sr), pha, norm)

    runs = {name: [] for name in PATHS}
    for name in ORDER:
        cs.set_path(system, **PATHS[name])
        runs[name].append(cs.cuda_ms(serve, iters=5, warmup=2))
    return dict(root=root, ms=runs)


def step_child(root: str) -> dict:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch
    import chip_smoke as cs
    from pix2pixhdaudiosr_torch.ops import mdct_kernels, norm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counters = {"mdct2": mdct_kernels.mdct2, "imdct2": mdct_kernels.imdct2,
                "instance_norm_act": norm.instance_norm_act,
                "instance_norm_act_grad": norm.instance_norm_act_grad}
    res = cs.phase_train_step("cuda", counters)
    return dict(root=root, ms={"train_step": res["ms_runs"]})


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "--child":
        print(json.dumps(child(argv[1])))
        return 0
    if len(argv) == 2 and argv[0] == "--step-child":
        print(json.dumps(step_child(argv[1])))
        return 0
    step = argv[:1] == ["--step"]
    argv = argv[1:] if step else argv
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    turns = []
    for label, root in (("parent", argv[0]), ("change", argv[1]),
                        ("change", argv[1]), ("parent", argv[0])):
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--step-child" if step else "--child", root],
                             capture_output=True,
                             text=True, timeout=900)
        if res.returncode != 0:
            print(res.stdout[-3000:], res.stderr[-3000:], file=sys.stderr)
            return 1
        rec = json.loads(res.stdout.strip().splitlines()[-1])
        rec["label"] = label
        print(f"[{label}] " + json.dumps(rec))
        turns.append(rec)
    summary = {path: {label: [ms for t in turns if t["label"] == label
                              for ms in t["ms"][path]]
                      for label in ("parent", "change")}
               for path in (["train_step"] if step else PATHS)}
    print(json.dumps(dict(card=smi, batch=64 if step else 128,
                          ms_per_batch=summary)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
