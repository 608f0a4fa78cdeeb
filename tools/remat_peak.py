#!/usr/bin/env python3
"""--remat_g's cost on one NVIDIA GPU: the flagship train step (bf16, batch
64, chip_smoke.FLAGSHIP) plain; with --remat_g full as shipped; with full
on cuDNN's per-thread timed algorithms, as before its recompute was made
bit-equal (system._same_convs bypassed; the output conv in OUT_ROWS
blocks all the same); with full on deterministic algorithms but the G's
output conv in one call (its OUT_ROWS blocks undone); and with
--remat_g dots.

    python3 tools/remat_peak.py

Prints the card's name and power limit, then one JSON line a variant: the
step's ms by CUDA events (4 steps after 2), its peak allocated GiB over
what was allocated before the steps, the largest transient of the output
conv's calls in one step (GiB allocated above the conv's input and output
while it runs: cuDNN's workspace and any layout copy), and for the remat
variants chip_smoke.remat_forward_check at batch 16 (each of G's 22
InstanceNorm inputs recomputed in the backward against the forward's).
Exits non-zero without a card.
"""

from __future__ import annotations

import gc
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def output_conv_transient(system, run_step) -> float:
    """The output conv's largest transient GiB over one step's calls."""
    import torch
    conv = system.netG_train.enh1_final.Conv_0
    most = [0]

    def pre(_, args):
        torch.cuda.synchronize()
        most.append(torch.cuda.memory_allocated())
        torch.cuda.reset_peak_memory_stats()

    def post(_, args, y):
        torch.cuda.synchronize()
        before = most.pop()
        most[0] = max(most[0], torch.cuda.max_memory_allocated() - before
                      - y.numel() * y.element_size())
    hooks = conv.register_forward_pre_hook(pre), conv.register_forward_hook(post)
    try:
        run_step()
    finally:
        for h in hooks:
            h.remove()
    return most[0] / 2**30


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("remat_peak: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from pix2pixhdaudiosr_torch import system as system_mod
    from pix2pixhdaudiosr_torch.config import parse_config
    from pix2pixhdaudiosr_torch.ops import _cuda
    from pix2pixhdaudiosr_torch.system import Pix2PixHDSystem
    from pix2pixhdaudiosr_torch.trainer import init_state, make_train_step
    print(cs.nvidia_smi())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    _cuda.build()
    _cuda.library()
    dev = "cuda"
    same = system_mod._same_convs
    variants = [("plain", "", same, True), ("full", "full", same, True),
                ("full timed", "full", lambda fn: fn, True),
                ("full one call", "full", same, False),
                ("dots", "dots", same, True), ("plain", "", same, True),
                ("full", "full", same, True)]
    for name, mode, wrap, rows in variants:
        system_mod._same_convs = wrap
        gc.collect()
        torch.cuda.empty_cache()
        cfg = parse_config([*cs.FLAGSHIP, "--batchSize", "64",
                            *(["--remat_g", mode] if mode else [])],
                           is_train=True, save=False)
        system = Pix2PixHDSystem(cfg, device=dev)
        if not rows:
            system.netG_train.enh1_final.rows = 0
        state = init_state(system, 0)
        data = cs.flagship_train_batch(dev, 64)
        step = make_train_step(system)
        seeds = iter(range(1000))

        def run_step():
            gen = torch.Generator(device=dev).manual_seed(next(seeds))
            return step(state, data, gen)[0]
        for _ in range(2):
            run_step()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ms = []
        for _ in range(4):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            run_step()
            b.record()
            torch.cuda.synchronize()
            ms.append(a.elapsed_time(b))
        row = dict(variant=name, ms=ms, ms_mean=sum(ms) / len(ms),
                   peak_over_base_gib=(torch.cuda.max_memory_allocated()
                                       - base) / 2**30,
                   output_conv_transient_gib=output_conv_transient(
                       system, run_step))
        if mode:
            b_, f_, t_, c_ = system.spectro_shape(16)
            noise = torch.randn(b_, system.codec.mask_size(f_), t_, c_,
                                device=dev, generator=torch.Generator(
                                    device=dev).manual_seed(9))
            row["forward_recompute"] = cs.remat_forward_check(
                *cs.remat_norm_inputs(system, cs.flagship_train_batch(
                    dev, 16, seed=8), noise, mode),
                cs.count_norms(system.netG_train))
        print("[remat peak] " + json.dumps(row), flush=True)
        del system, state, data, step, run_step
    system_mod._same_convs = same
    return 0


if __name__ == "__main__":
    sys.exit(main())
