#!/usr/bin/env python
"""Export, cost and time the serve graph of the port: the twin of
tools/aot_engine.py on torch.export.

It builds the flagship config (LocalEnhancer G3L2 at ngf 48, bf16) with
seeded N(0, 0.02) weights (the repo holds no trained checkpoint), exports
`system.inference(audio, noise)[0]` (encode + G, no decode; the mode-2
mask noise is an input, so the graph holds no draw) with
torch.export.export, and prints what the JAX tool prints:

  compile: <s>s                   the export's seconds
  cost analysis: {'flops': n}     FlopCounterMode over one forward of the
                                  exported program (the p2p operators'
                                  formulas included)
  memory analysis: ...            the peak bytes allocated by a forward
  exec: <ms> ms/call @ batch <n>  CUDA events over 10 calls after 3 warm-ups
                                  (on the CPU, the host clock over 3 after 1)
  the top rows of a torch.profiler table of one forward by device time
  serialized engine -> <path> (<bytes> bytes)    with --out
                                  (torch.export.save); the saved engine is
                                  then loaded back and held against eager

Every kernel of the graph is a `p2p` operator (ops/_cuda.define_op), so
the saved engine loads with torch.export.load in a process that imports
only pix2pixhdaudiosr_torch, and runs the same kernels as eager, counted
by the same wrappers.

Usage: python tools/aot_engine_torch.py [--batch 4] [--out engine.pt2]
       [--tiny] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch

# __graft_entry__._flagship_cfg as Config fields
FLAGSHIP = dict(net_g="local", ngf=48, n_blocks_global=3, n_blocks_local=2,
                n_downsample_global=4, n_local_enhancers=1, input_nc=2,
                output_nc=2, label_nc=0, no_instance=True,
                explicit_encoding=True, mask_mode="mode2", no_vgg_loss=True,
                compute_dtype="bfloat16")
# the JAX tool's --tiny shrink
TINY = dict(ngf=8, n_blocks_global=1, n_blocks_local=1,
            n_downsample_global=2, compute_dtype="float32")


class ServeEngine(torch.nn.Module):
    """`system.inference(audio, noise)[0]` with the generator's weights as
    this module's parameters under flat names (`weights.<i>`): torch.export
    cannot rebuild a module whose parameter path holds the Python keyword
    `global` (the LocalEnhancer's trunk, named after the flax tree)."""

    def __init__(self, system):
        super().__init__()
        object.__setattr__(self, "serve", _Inference(system))  # unregistered
        named = list(self.serve.named_parameters())
        self.names = [n for n, _ in named]
        self.weights = torch.nn.ParameterList([p for _, p in named])

    def forward(self, audio: torch.Tensor, noise: torch.Tensor):
        return torch.func.functional_call(
            self.serve, dict(zip(self.names, self.weights)), (audio, noise))


class _Inference(torch.nn.Module):
    def __init__(self, system):
        super().__init__()
        object.__setattr__(self, "system", system)
        self.netG = system.netG

    def forward(self, audio, noise):
        return self.system.inference(audio, noise)[0]


def build_system(tiny: bool, device: torch.device, seed: int = 0):
    """The flagship serving system (--tiny: shrunk) on `device` with N(0,
    0.02) weights from `seed`, cast to the compute dtype, channels_last."""
    from pix2pixhdaudiosr_torch.config import Config
    from pix2pixhdaudiosr_torch.models.generator import init_normal_
    from pix2pixhdaudiosr_torch.system import Pix2PixHDSystem

    cfg = Config(**dict(FLAGSHIP, **(TINY if tiny else {})), is_train=False)
    system = Pix2PixHDSystem(cfg, device=device)
    with torch.no_grad():
        init_normal_(system.netG, torch.Generator(device).manual_seed(seed))
    system.netG.to(dtype=system.dtype, memory_format=torch.channels_last)
    system.netG.eval().requires_grad_(False)
    return system


def serve_inputs(system, batch: int, seed: int = 0):
    """(audio [batch, segment_length], mask noise) drawn from `seed`."""
    gen = torch.Generator(system.device).manual_seed(seed)
    audio = 0.1 * torch.randn(batch, system.cfg.segment_length,
                              generator=gen, device=system.device)
    b, f, t, c = system.spectro_shape(batch)
    noise = torch.randn(b, system.codec.mask_size(f), t, c, generator=gen,
                        device=system.device)
    return audio, noise


def export_engine(system, audio, noise):
    with torch.no_grad():
        return torch.export.export(ServeEngine(system), (audio, noise),
                                   strict=False)


def count_flops(fn, *args) -> int:
    from torch.utils.flop_counter import FlopCounterMode
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        fn(*args)
    return counter.get_total_flops()


def exec_ms(fn, args, device: torch.device) -> float:
    """ms a call: CUDA events over 10 calls after 3 warm-ups on a card,
    the host clock over 3 after 1 on the CPU."""
    warm, iters = (3, 10) if device.type == "cuda" else (1, 3)
    with torch.no_grad():
        for _ in range(warm):
            fn(*args)
        if device.type != "cuda":
            t0 = time.perf_counter()
            for _ in range(iters):
                fn(*args)
            return (time.perf_counter() - t0) * 1e3 / iters
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters


def peak_bytes(fn, args, device: torch.device):
    """The peak bytes a forward allocates on the card (None on the CPU)."""
    if device.type != "cuda":
        return None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    with torch.no_grad():
        fn(*args)
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated(device)


def profile_table(fn, args, device: torch.device, rows: int = 12) -> str:
    from torch.profiler import ProfilerActivity, profile
    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with torch.no_grad(), profile(activities=acts) as prof:
        fn(*args)
        if cuda:
            torch.cuda.synchronize()
    key = "self_device_time_total" if cuda else "self_cpu_time_total"
    return prof.key_averages().table(sort_by=key, row_limit=rows)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--out", type=str, default="")
    p.add_argument("--tiny", action="store_true",
                   help="shrink the config to exercise every code path at a "
                        "toy size (the JAX tool's shrink)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; the CPU runs only when asked")
    args = p.parse_args(argv)

    from pix2pixhdaudiosr_torch.generate import resolve_device
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.benchmark = True   # as the generate CLI serves
    if args.tiny:
        args.batch = min(args.batch, 2)
    system = build_system(args.tiny, device)
    audio, noise = serve_inputs(system, args.batch)

    t0 = time.perf_counter()
    engine = export_engine(system, audio, noise)
    compile_s = time.perf_counter() - t0
    print(f"compile: {compile_s:.1f}s")
    run = engine.module()
    flops = count_flops(run, audio, noise)
    print("cost analysis:", {"flops": float(flops)})
    peak = peak_bytes(run, (audio, noise), device)
    print("memory analysis:", "not measured on the CPU" if peak is None else
          f"peak {peak} bytes ({peak / 2**30:.3f} GiB) allocated by a "
          f"forward at batch {args.batch}")
    ms = exec_ms(run, (audio, noise), device)
    print(f"exec: {ms:.3f} ms/call @ batch {args.batch} ({device.type}"
          f"{', CUDA events' if device.type == 'cuda' else ', host clock'})")
    eager_ms = exec_ms(lambda a, n: system.inference(a, n)[0],
                       (audio, noise), device)
    print(f"eager: {eager_ms:.3f} ms/call @ batch {args.batch}")
    print(profile_table(run, (audio, noise), device))

    res = dict(batch=args.batch, compile_s=compile_s, flops=flops,
               peak_bytes=peak, ms=ms, eager_ms=eager_ms, audio=audio,
               noise=noise, system=system)
    if args.out:
        torch.export.save(engine, args.out)
        size = os.path.getsize(args.out)
        print(f"serialized engine -> {args.out} ({size} bytes)")
        with torch.no_grad():
            want = system.inference(audio, noise)[0]
            got = torch.export.load(args.out).module()(audio, noise)
        err = (got - want).abs().max().item()
        print(f"reloaded engine: max|engine - eager| {err} "
              f"(bit-equal: {torch.equal(got, want)})")
        res.update(out_bytes=size, reload_err=err, eager_out=want,
                   engine_out=got)
    return res


if __name__ == "__main__":
    main()
