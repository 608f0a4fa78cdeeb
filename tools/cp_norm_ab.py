#!/usr/bin/env python3
"""B3's cross-shard InstanceNorm (B3m `instance_moments`, B3a
`instance_apply`) of one checkout, timed on one NVIDIA GPU.

    python3 tools/cp_norm_ab.py [--root DIR] [--plans] [--host]
                                [--seconds 60]

Imports pix2pixhdaudiosr_torch from DIR (default: this checkout), so that
two trees can be read side by side on one card (parent, change, change,
parent; each tree a `git archive` in a gitignored directory), and this
checkout's chip_smoke.py for its helpers. Prints the card's name and power
limit, then one JSON line each:
  kernel   at each shape of chip_smoke.CP_IN_TIMED, bf16 and f32, on a
           channels_last input: events ms (20 calls), device ms L2 warm and
           cold, the bound (bytes at 3.35 TB/s), the CUDA kernels a call
           (torch.profiler), the library yardstick (torch.var_mean for B3m;
           F.batch_norm at one sample for B3a, without the activation) and
           the twin's ms;
  forward  the bf16 flagship G's one-rank CP forward of a --seconds
           synthetic file: wall ms (CUDA events), the kernels each
           cp_instance_norm call launched, the copy kernels among them (at
           the cropped views), B3m + B3a device ms a forward, and the
           moments, apply and copy device ms by InstanceNorm shape;
  plans    (--plans; a tree with ops/norm.plan_cross_shard) B3m and B3a
           under other planner limits at each shape, each held to its twin;
  host     (--host) host time of 1000 calls without a sync at
           [1, 48, 512, 256] bf16, then cProfile's top entries over 1000.
Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import cProfile
import importlib.util
import io
import json
import os
import pstats
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# planner limits tried by --plans beside the planner's own (keyword
# arguments of ops/norm.plan_cross_shard): B3m, then B3a
MOMENT_VARIANTS = {"as_is": {}, "blocks1": dict(blocks=1),
                   "two_level": dict(group_rounds=1),
                   "blocks132": dict(blocks=132), "blocks528": dict(blocks=528)}
APPLY_VARIANTS = {"as_is": {}, "blocks1320": dict(blocks=1320),
                  "one_pass": dict(blocks=2 ** 30)}


def smoke_helpers():
    """This checkout's chip_smoke.py, loaded as a module."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernel_rows(cs, norm, dev, dtypes) -> None:
    import torch
    import torch.nn.functional as F
    gen = torch.Generator(device=dev).manual_seed(11)
    for shape in cs.CP_IN_TIMED:
        B, C, H, W = shape
        for dtype in dtypes:
            x = (torch.randn(shape, generator=gen, device=dev) * 2 + 0.5).to(
                dtype).contiguous(memory_format=torch.channels_last)
            m = norm.instance_moments(x)
            mean, var = norm.mean_var(m)
            nb = x.numel() * x.element_size()
            key = f"{B}x{C}x{H}x{W} {str(dtype)[6:]}"
            for name, fn, plain, lib, n_bytes in (
                    ("instance_moments", lambda: norm.instance_moments(x),
                     lambda: norm.instance_moments_ref(x),
                     lambda: torch.var_mean(x, dim=(2, 3)), nb),
                    ("instance_apply",
                     lambda: norm.instance_apply(x, m, "relu"),
                     lambda: norm.instance_apply_ref(x, m, "relu"),
                     (lambda: F.batch_norm(
                         x.view(1, B * C, H, W), mean.view(-1), var.view(-1),
                         training=False, eps=1e-5)) if B == 1 else None,
                     2 * nb)):
                r = dict(kernel=name, shape=key, ms=cs.cuda_ms(fn),
                         device_ms=cs.device_ms(fn),
                         cold_device_ms=cs.device_ms(fn, cold=True),
                         kernels_per_call=cs.kernels_per_call(fn),
                         library_ms=cs.cuda_ms(lib) if lib else None,
                         plain_ms=cs.cuda_ms(plain, iters=5),
                         **cs.bound(n_bytes + 4 * m.numel(), 0,
                                    cs.F32_FLOPS))
                r["cold_share_of_bound"] = r["bound_ms"] / r["cold_device_ms"]
                print("kernel " + json.dumps(r), flush=True)


def plan_rows(cs, norm, dev) -> None:
    import torch
    gen = torch.Generator(device=dev).manual_seed(12)
    plan_m, plan_a = norm.plan_instance_moments, norm.plan_instance_apply
    try:
        for shape in cs.CP_IN_TIMED:
            B, C, H, W = shape
            for dtype in (torch.bfloat16, torch.float32):
                x = (torch.randn(shape, generator=gen, device=dev) * 2
                     + 0.5).to(dtype).contiguous(
                         memory_format=torch.channels_last)
                exact = cs.moments_f64(x)
                want = norm.instance_moments_ref(x)
                twin_err = cs.moments_err(want, exact)
                y_ref = norm.instance_apply_ref(x, want, "relu")
                key = f"{B}x{C}x{H}x{W} {str(dtype)[6:]}"
                for variant, kw in MOMENT_VARIANTS.items():
                    norm.plan_instance_moments = (
                        lambda B_, H_, W_, C_, dt, vectors=True, kw=kw:
                        norm.plan_cross_shard(B_, H_, W_, C_, dt, vectors,
                                              **kw))
                    err = cs.moments_err(norm.instance_moments(x), exact)
                    cs.check(err <= max(1e-6, twin_err), f"{variant} {key}: "
                             f"moments error {err}")
                    fn = lambda: norm.instance_moments(x)  # noqa: E731
                    print("plans " + json.dumps(dict(
                        kernel="instance_moments", variant=variant, shape=key,
                        plan=norm.plan_instance_moments(
                            B, H, W, C, dtype)._asdict(),
                        ms=cs.cuda_ms(fn), device_ms=cs.device_ms(fn),
                        cold_device_ms=cs.device_ms(fn, cold=True),
                        rel_err_f64=err)), flush=True)
                norm.plan_instance_moments = plan_m
                for variant, kw in APPLY_VARIANTS.items():
                    kw = dict(dict(blocks=norm.APPLY_BLOCKS,
                                   unroll=norm.APPLY_UNROLL,
                                   group_rounds=0), **kw)
                    norm.plan_instance_apply = (
                        lambda B_, H_, W_, C_, dt, vectors=True, kw=kw:
                        norm.plan_cross_shard(B_, H_, W_, C_, dt, vectors,
                                              **kw))
                    y = norm.instance_apply(x, want, "relu")
                    cs.check((y - y_ref).abs().max().item() <= 1e-5
                             if dtype == torch.float32
                             else cs.ulp_excess(y, y_ref) <= 0,
                             f"{variant} {key}: apply beyond tolerance")
                    fn = lambda: norm.instance_apply(x, want, "relu")  # noqa: E731
                    print("plans " + json.dumps(dict(
                        kernel="instance_apply", variant=variant, shape=key,
                        plan=norm.plan_instance_apply(
                            B, H, W, C, dtype)._asdict(),
                        ms=cs.cuda_ms(fn), device_ms=cs.device_ms(fn),
                        cold_device_ms=cs.device_ms(fn, cold=True))),
                        flush=True)
                norm.plan_instance_apply = plan_a
    finally:
        norm.plan_instance_moments, norm.plan_instance_apply = plan_m, plan_a


def host_rows(norm, dev) -> None:
    import torch
    x = torch.randn(1, 48, 512, 256, device=dev, dtype=torch.bfloat16
                    ).contiguous(memory_format=torch.channels_last)
    m = norm.instance_moments(x)
    for name, fn in (("instance_moments", lambda: norm.instance_moments(x)),
                     ("instance_apply",
                      lambda: norm.instance_apply(x, m, "relu"))):
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(1000):
            fn()
        host = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        prof = cProfile.Profile()
        prof.enable()
        for _ in range(1000):
            fn()
        prof.disable()
        torch.cuda.synchronize()
        out = io.StringIO()
        pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(15)
        print("host " + json.dumps(dict(kernel=name, host_us_per_call=host)),
              flush=True)
        print(out.getvalue(), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--plans", action="store_true")
    ap.add_argument("--host", action="store_true")
    ap.add_argument("--seconds", type=float, default=60.0)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        print("cp_norm_ab: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs = smoke_helpers()
    from pix2pixhdaudiosr_torch.ops import _cuda, norm
    print("root " + json.dumps(dict(root=os.path.abspath(args.root),
                                    package=os.path.dirname(norm.__file__),
                                    library=str(_cuda.build()))), flush=True)
    dev = "cuda"
    if args.host:
        host_rows(norm, dev)
    kernel_rows(cs, norm, dev, (torch.bfloat16, torch.float32))
    if args.seconds > 0:
        run, frames = cs.cp_long_forward(dev, args.seconds)
        r = dict(seconds=args.seconds, frames=frames,
                 g_wall_ms=cs.cuda_ms(run, iters=5, warmup=2),
                 **cs.cp_norm_profile(run))
        print("forward " + json.dumps(r), flush=True)
        del run
        torch.cuda.empty_cache()
    if args.plans:
        plan_rows(cs, norm, dev)
    shutil.rmtree(cs.WORK, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
