#!/usr/bin/env python3
"""Where the time of the wgmma conv kernels (B4, B5) goes, on one NVIDIA GPU.

    python3 tools/conv_wgmma_ablation.py

Builds pix2pixhdaudiosr_torch/csrc/conv3x3_wgmma.cu as it is and in
ablated variants, each into its own library (one nvcc per variant, all
started together, under pix2pixhdaudiosr_torch/_build/ablation/), and times
the entry points p2p_conv3x3_in_wg (B4, prologue in_relu, at
[128, 96, 256, 64]) and p2p_conv3x3_valid_wg (B5, at [64, 96, 258, 66])
with CUDA events over 20 back-to-back launches made through ctypes (the
kernel alone, without the torch wrapper's host time). Source variants:
  as_is          the source as it is;
  mainloop_only  the producer stages nothing and only hands the ring's
                 slots on (wrong results: the wgmmas, the hand-off and the
                 epilogue without the loads);
  loads_only     the consumers issue no wgmma (wrong results: the staging,
                 the hand-off and the epilogue without the MMAs);
  staging_only   loads_only without the epilogue: the producer and the
                 hand-off alone;
  no_epilogue    no epilogue (no output: the staging and the MMAs).
Each is run under the plan of ops/enhancer.plan_conv and variants of it
made here (the kernel takes them; the planner never picks them):
  planner        the planner's own (alternate rows, 5 ring slots);
  slots4         4 ring slots (rows r..r+3 in use, none staged ahead);
  strip64        units of 64 rows (4 halo rows more a sample).
The mma.sync route (csrc/conv3x3_in.cu) is timed through the package in
the same call, and the correct variants are held within one bf16 ulp of
the twin. Prints the card's name and power limit, then one JSON line a
variant, plan and entry: ms, TFLOP/s, share of the bound. Exits non-zero
without a card.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import BF16_FLOPS, bound, conv_floor, ulp_excess  # noqa: E402

LOAD = "      if (ld.u < n_units) load_row(a, tasks, v, ld.u, ld.i);\n"
STORE = "      store_row(a, tasks, cur, smem + L.ring + slot * slot_bytes, ms);\n"
MAINLOOP = "      mainloop(acc, rows, smem_s, a);\n"
EPILOGUE = "      epilogue<kStats>("
VARIANTS = {"as_is": [],
            "mainloop_only": [(LOAD, ""), (STORE, "")],
            "loads_only": [(MAINLOOP, "")],
            "staging_only": [(MAINLOOP, ""), (EPILOGUE, "if (0) " + EPILOGUE)],
            "no_epilogue": [(EPILOGUE, "if (0) " + EPILOGUE)]}
CORRECT = ("as_is",)
PLANS = ("planner", "slots4", "strip64")
HEADERS = ("common.cuh", "conv_common.cuh", "in_finalize.cuh")


def plan_variant(te, plan, name: str, H: int, W: int, C: int):
    """The planner's wgmma plan, or the variant `name` of it."""
    if name == "slots4":
        return plan._replace(slots=4, smem=te.wgmma_smem_bytes(W, C, 4))
    if name == "strip64":
        strips = -(-H // 64)
        return plan._replace(strip=64, strips=strips, P=8 * strips)
    return plan


def build_all(out_root: str) -> dict:
    """One nvcc per variant, all at once; {name: loaded library}."""
    from pix2pixhdaudiosr_torch.ops import _cuda
    csrc = os.path.join(ROOT, "pix2pixhdaudiosr_torch", "csrc")
    src = open(os.path.join(csrc, "conv3x3_wgmma.cu")).read()
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: csrc/conv3x3_wgmma.cu no longer "
                                   f"holds {old!r}")
            text = text.replace(old, new)
        d = os.path.join(out_root, f"conv_{name}")
        os.makedirs(d, exist_ok=True)
        for h in HEADERS:
            shutil.copy(os.path.join(csrc, h), d)
        with open(os.path.join(d, "conv3x3_wgmma.cu"), "w") as f:
            f.write(text)
        so = os.path.join(d, "libconv.so")
        cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I", d, "-o", so,
               os.path.join(d, "conv3x3_wgmma.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-3000:]}")
        regs = [line.split(":", 1)[1].strip() for line in log.splitlines()
                if "Used" in line and "registers" in line]
        # ptxas's advisories, e.g. wgmmas it had to serialize
        notes = sorted({line.split(":", 1)[1].strip()[:160]
                        for line in log.splitlines() if "(C75" in line})
        spills = [line.strip() for line in log.splitlines()
                  if "spill" in line and not line.strip().startswith("0 bytes")]
        print(f"[build {name}] " + json.dumps(dict(ptxas=regs, spills=spills,
                                                   notes=notes)))
        lib = ctypes.CDLL(so)
        for fn in ("p2p_conv3x3_in_wg", "p2p_conv3x3_valid_wg"):
            getattr(lib, fn).argtypes = list(_cuda._SIGNATURES[fn])
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def events_ms(fn, iters: int = 20, warmup: int = 3) -> float:
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("conv_wgmma_ablation: CUDA is not available", file=sys.stderr)
        return 1
    from pix2pixhdaudiosr_torch.ops import enhancer as te
    from pix2pixhdaudiosr_torch.ops.conv import conv3x3_valid, conv3x3_valid_ref

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    libs = build_all(os.path.join(ROOT, "pix2pixhdaudiosr_torch", "_build",
                                  "ablation"))
    dev = "cuda"
    sms = te.device_sms(torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(5)
    stream = torch.cuda.current_stream().cuda_stream
    B, C, H, W = 128, 96, 256, 64

    def act(shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)

    x = act((B, C, H, W))
    w = te.pack_weights(torch.randn(C, C, 3, 3, generator=gen, device=dev) * .05)
    bias = torch.randn(C, generator=gen, device=dev) * .1
    mean = torch.randn(B, C, generator=gen, device=dev) * .3
    scale = torch.rand(B, C, generator=gen, device=dev) * 1.5 + .5
    xp = act((64, C, H + 2, W + 2))
    wk = te.unpack_weights(w).contiguous()
    want = {"B4": te.conv3x3_in_ref(x, w, bias, mean, scale, None,
                                    "in_relu")[0],
            "B5": conv3x3_valid_ref(xp, wk)}
    flop = {"B4": 2 * 9 * C * x.numel(), "B5": 2 * 9 * C * 64 * C * H * W}
    bounds = {"B4": bound(2 * 2 * x.numel(), flop["B4"], BF16_FLOPS)["bound_ms"],
              "B5": bound(2 * (xp.numel() + 64 * C * H * W), flop["B5"],
                          BF16_FLOPS)["bound_ms"]}

    def report(entry, variant, plan_name, plan, ms, y=None):
        row = dict(entry=entry, variant=variant, plan=plan_name,
                   plan_fields=plan._asdict() if plan is not None else None,
                   ms=ms, tflops=flop[entry] / ms / 1e9,
                   share_of_bound=bounds[entry] / ms)
        if y is not None:
            row["ulp_excess"] = ulp_excess(y, want[entry], conv_floor(want[entry]))
        print("[ablation] " + json.dumps(row))
        return row

    rows = []
    # the mma.sync route through the package, same call
    mplan = te.plan_conv(B, H, W, C, C, sms, route="mma_sync")
    rows.append(report("B4", "mma_sync", "planner", mplan, events_ms(
        lambda: te.conv3x3_in(x, w, bias, mean, scale, None, "in_relu",
                              plan=mplan))))
    vplan = te.plan_conv(64, H, W, C, C, sms, route="mma_sync")
    rows.append(report("B5", "mma_sync", "planner", vplan, events_ms(
        lambda: conv3x3_valid(xp, wk, plan=vplan))))
    wp = wk.permute(2, 3, 0, 1).reshape(9, C, C).to(torch.bfloat16).contiguous()
    for variant, lib in libs.items():
        for plan_name in PLANS:
            for entry in ("B4", "B5"):
                batch = B if entry == "B4" else 64
                plan = plan_variant(te, te.plan_conv(batch, H, W, C, C, sms,
                                                     route="wgmma"),
                                    plan_name, H, W, C)
                y = torch.empty(batch, C, H, W, dtype=torch.bfloat16,
                                device=dev, memory_format=torch.channels_last)
                if entry == "B4":
                    partial = torch.empty(B, plan.P, C, 2, device=dev)
                    stats = torch.empty(2, B, C, device=dev)

                    def run(lib=lib, plan=plan, y=y, partial=partial,
                            stats=stats):
                        return lib.p2p_conv3x3_in_wg(
                            x.data_ptr(), None, w.data_ptr(), bias.data_ptr(),
                            mean.data_ptr(), scale.data_ptr(), y.data_ptr(),
                            partial.data_ptr(), stats.data_ptr(), B, H, W, C,
                            C, 1, 1e-5, plan.strip, plan.slots, plan.P,
                            stream)
                else:
                    def run(lib=lib, plan=plan, y=y):
                        return lib.p2p_conv3x3_valid_wg(
                            xp.data_ptr(), wp.data_ptr(), y.data_ptr(), 64, H,
                            W, C, C, 0, plan.strip, plan.slots, stream)
                if run():
                    raise RuntimeError(f"{variant} {plan_name} {entry}: "
                                       f"launch refused")
                torch.cuda.synchronize()
                rows.append(report(entry, variant, plan_name, plan,
                                   events_ms(run),
                                   y if variant in CORRECT else None))
    bad = [r for r in rows if r.get("ulp_excess", 0) > 0]
    if bad:
        print(f"conv_wgmma_ablation: {len(bad)} variants beyond one ulp",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
