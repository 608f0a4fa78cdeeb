#!/usr/bin/env python3
"""The flagship batch-128 serve times of two trees of the port, side by side
on one card; with --step, the flagship batch-64 train step's; with --ops,
the host cost of the kernels' dispatch.

    python3 tools/serve_ab.py [--step | --ops] PARENT_DIR CHANGE_DIR

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
and the summary holds its ms/step runs. With --ops each child times, by
the host clock, B3 (instance_norm_act, [1, 48, 512, 128] bf16, relu: a
batch-1 serve's largest) and B1 (mdct2, [1, 33024] at 512/256) through
their wrappers, 20 repeats of 1000 calls without a sync, each repeat's
host µs a call (the minimum is the cost with the least interference from
the shared host); on a tree whose kernels are `p2p` operators
(ops/_cuda.define_op) also the same calls through the operators; and the
plain serve forward by CUDA events at batch 1 (10 turns of 20 forwards
after 3 warm-ups) and 128 (5 after 2), the host µs of 200 batch-1
forwards one by one (each from an idle card: the time to enqueue it), and the
Python function calls of one batch-1 forward (sys.setprofile), which no
load of the host moves, and the host µs of the 4 Python calls that the
direct route of a tree with `p2p` operators adds to a launch (a replica
timed by timeit, the minimum of 20 repeats of 100,000). The summary gives each tree's minima over its
turns and the change's minus the parent's.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import timeit

PATHS = {"plain": {}, "fused_enhancer": dict(fused=True),
         "int8_trunk": dict(int8=True)}
ORDER = ("plain", "fused_enhancer", "int8_trunk", "int8_trunk",
         "fused_enhancer", "plain")
# --ops: the batch-1 serve's turns a child, the repeats of 1000 host calls
# of each kernel, and the batch-1 serve forwards timed one by one
BATCH1_TURNS, HOST_REPEATS, SERVE_REPEATS = 10, 20, 200


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


def host_us(fn, calls: int = 1000, repeats: int = HOST_REPEATS) -> list:
    """Host µs a call of fn, one reading for each of `repeats` runs of
    `calls` calls without a sync."""
    import time
    import torch
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        runs.append((time.perf_counter() - t0) * 1e6 / calls)
        torch.cuda.synchronize()
    return runs


def ops_child(root: str) -> dict:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch
    import chip_smoke as cs
    from pix2pixhdaudiosr_torch.ops import _cuda, mdct_kernels, norm
    from pix2pixhdaudiosr_torch.ops.mdct import MDCT2
    from pix2pixhdaudiosr_torch.ops.window import kbdwin

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    _cuda.library()
    cs.WORK = os.path.join(root, "_smoke_run")
    os.makedirs(os.path.join(cs.WORK, "smoke"), exist_ok=True)
    cs.flagship_generator_pth(os.path.join(cs.WORK, "smoke"))
    system = cs.flagship_system("cuda")
    x = torch.randn(1, 48, 512, 128, device="cuda", dtype=torch.bfloat16
                    ).contiguous(memory_format=torch.channels_last)
    fwd = MDCT2(512, 256, 512, kbdwin(512), device="cuda")
    sig = torch.randn(1, 33024, device="cuda")
    calls = {"instance_norm_act": lambda: norm.instance_norm_act(x, "relu"),
             "mdct2": lambda: mdct_kernels.mdct2(sig, fwd.basis, 256,
                                                 fwd.planes)}

    def serve_fn(b):
        lr, noise = cs.seeded_batch(system, "cuda", b)

        def serve():
            with torch.no_grad():
                sr, pha, nrm, _ = system.inference(lr, noise=noise)
                return system.codec.imdct_eval(torch.abs(sr), pha, nrm)
        return serve

    def python_calls(fn) -> int:
        """The Python function calls one fn() makes."""
        n = 0

        def count(frame, event, arg):
            nonlocal n
            n += event == "call"
        sys.setprofile(count)
        try:
            fn()
        finally:
            sys.setprofile(None)
        torch.cuda.synchronize()
        return n

    def impl(x, act, eps, with_stats):
        return x

    def tracing():
        return torch.compiler.is_compiling()
    # the Python calls the direct route of a `p2p` tree adds to a launch:
    # `_cuda.tracing` (is_compiling, is_scripting) and the CUDA impl's frame
    added = min(timeit.repeat("tracing(); impl(x, 'relu', 1e-5, False)",
                              number=100000, repeat=20, globals=dict(
                                  tracing=tracing, impl=impl, x=x))) * 10
    serve_b1 = serve_fn(1)
    res = dict(root=root, added_us_a_launch=added,
               host_us={k: host_us(f) for k, f in calls.items()},
               serve_b1_ms=[cs.cuda_ms(serve_b1, 20, 3)
                            for _ in range(BATCH1_TURNS)],
               serve_b1_host_us=host_us(serve_b1, 1, SERVE_REPEATS),
               serve_b1_python_calls=python_calls(serve_b1),
               serve_b128_ms=cs.cuda_ms(serve_fn(128), 5, 2))
    if hasattr(torch.ops.p2p, "instance_norm_act"):
        calls = {"instance_norm_act": lambda: torch.ops.p2p.instance_norm_act(
                     x, "relu", 1e-5, False),
                 "mdct2": lambda: torch.ops.p2p.mdct2(sig, fwd.basis, 256,
                                                      *fwd.planes)}
        res["host_us_op"] = {k: host_us(f) for k, f in calls.items()}
    return res


def ops_summary(turns) -> dict:
    """Each tree's minima over its turns (host µs a call by kernel and
    route; batch-1 serve ms, host µs and Python calls; batch-128 serve
    ms), their medians, and the change's minimum minus the parent's."""
    def tree(label):
        mine = [t for t in turns if t["label"] == label]
        out = {}
        for key in ("host_us", "host_us_op"):
            for k in (mine[0].get(key) or {}):
                runs = [us for t in mine for us in t[key][k]]
                out[f"{key}.{k}"] = dict(min=min(runs),
                                         median=statistics.median(runs))
        for key in ("added_us_a_launch", "serve_b1_ms", "serve_b1_host_us",
                    "serve_b1_python_calls", "serve_b128_ms"):
            runs = [ms for t in mine for ms in (
                t[key] if isinstance(t[key], list) else [t[key]])]
            out[key] = dict(min=min(runs), median=statistics.median(runs))
        return out
    parent, change = tree("parent"), tree("change")
    delta = {k: dict(min=change[k]["min"] - parent[k]["min"],
                     min_rel=change[k]["min"] / parent[k]["min"] - 1)
             for k in parent if k in change}
    return dict(parent=parent, change=change, change_minus_parent=delta)


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "--child":
        print(json.dumps(child(argv[1])))
        return 0
    if len(argv) == 2 and argv[0] == "--step-child":
        print(json.dumps(step_child(argv[1])))
        return 0
    if len(argv) == 2 and argv[0] == "--ops-child":
        print(json.dumps(ops_child(argv[1])))
        return 0
    if argv[:1] == ["--ops"]:
        return ops_main(argv[1:])
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


def ops_main(argv) -> int:
    """--ops: parent, change, change, parent; one JSON line a turn, then
    ops_summary's line."""
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
                              "--ops-child", root], capture_output=True,
                             text=True, timeout=900)
        if res.returncode != 0:
            print(res.stdout[-3000:], res.stderr[-3000:], file=sys.stderr)
            return 1
        rec = json.loads(res.stdout.strip().splitlines()[-1])
        rec["label"] = label
        print(f"[{label}] " + json.dumps(rec), flush=True)
        turns.append(rec)
    print(json.dumps(dict(card=smi, ops=ops_summary(turns))))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
