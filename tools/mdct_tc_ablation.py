#!/usr/bin/env python3
"""Where the time of the tensor-core MDCT kernels goes, on one NVIDIA GPU.

    python3 tools/mdct_tc_ablation.py

Builds pix2pixhdaudiosr_torch/csrc/mdct.cu as it is and in ablated
variants, each into its own library (one nvcc per variant, all started
together, under pix2pixhdaudiosr_torch/_build/ablation/), and times the
tensor-core entry points p2p_mdct2_tc and p2p_imdct2_tc of each at the
flagship codec (512/256), batch 128 and batch 1, with CUDA events over 50
back-to-back launches made through ctypes: the kernel alone, without the
torch wrapper's host time. Variants:
  as_is       the source as it is;
  rounded_lo  lo = a - hi rounded to tf32 by the same two integer ops as
              hi, instead of left for the tensor cores to truncate;
  guarded     rounded_lo with inf and NaN kept out of both roundings;
  one_sum     all of K summed in the tensor cores' accumulator, in place of
              one accumulator a 32-deep stage added into an f32 sum;
  no_copies   the ring is not refilled after its first two stages (wrong
              results: the time without the global loads);
  no_mma      no wgmma (wrong results: the loads, the A split and the
              barriers alone);
  mma_only    no copies, barriers or A splits after the first stage (wrong
              results: the wgmma sequence and the f32 stage sums alone).
Prints the card's name and power limit, then one JSON line per variant and
shape: ms, TFLOP/s of the transform's 2 M N K, the max error against a
float64 reference, and whether a NaN in the input (CUDA's canonical
0x7FFFFFFF) reaches the output. Exits non-zero without a card.
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

WGMMAS = ("      wgmma_tf32(part, lo[ks], d_hi + 2 * ks, ks > 0);\n"
          "      wgmma_tf32(part, hi[ks], d_lo + 2 * ks, 1);\n"
          "      wgmma_tf32(part, hi[ks], d_hi + 2 * ks, 1);\n")
REFILL = "    if (kt + 2 < KT) load_stage(kt + 2);\n"
STAGE_SYNC = (REFILL + "    cp_async_commit();\n    cp_async_wait<1>();\n"
              "    fence_proxy_async();\n    __syncthreads();\n"
              "    if (kt + 1 < KT) split_frags(kt + 1, hi_n, lo_n);\n")
SPLIT = ("  hi = (__float_as_uint(a) + 0x1000u) & 0xFFFFE000u;\n"
         "  lo = __float_as_uint(__fsub_rn(a, __uint_as_float(hi)));\n")
ROUNDED_LO = ("  hi = (__float_as_uint(a) + 0x1000u) & 0xFFFFE000u;\n"
              "  lo = (__float_as_uint(__fsub_rn(a, __uint_as_float(hi)))"
              " + 0x1000u) & 0xFFFFE000u;\n")
GUARDED = ("  const uint32_t u = __float_as_uint(a);\n"
           "  hi = (u & 0x7F800000u) == 0x7F800000u ? u"
           " : (u + 0x1000u) & 0xFFFFE000u;\n"
           "  const uint32_t v = __float_as_uint(__fsub_rn(a, __uint_as_float(hi)));\n"
           "  lo = (v & 0x7F800000u) == 0x7F800000u ? v"
           " : (v + 0x1000u) & 0xFFFFE000u;\n")
STAGE_SUM = ("      wgmma_tf32(part, lo[ks], d_hi + 2 * ks, ks > 0);\n",
             "      acc[i] = __fadd_rn(acc[i], part[i]);\n")
VARIANTS = {
    "as_is": [],
    "rounded_lo": [(SPLIT, ROUNDED_LO)],
    "guarded": [(SPLIT, GUARDED)],
    "one_sum": [(STAGE_SUM[0], STAGE_SUM[0].replace("ks > 0", "kt > 0 || ks > 0")),
                (STAGE_SUM[1], "      acc[i] = part[i];\n")],
    "no_copies": [(REFILL, "")],
    "no_mma": [(WGMMAS, "")],
    "mma_only": [(STAGE_SYNC, "")],
}
CORRECT = ("as_is", "rounded_lo", "guarded", "one_sum")


def build_all(out_root: str) -> dict:
    """One nvcc per variant, all at once; {name: loaded library}."""
    from pix2pixhdaudiosr_torch.ops import _cuda
    csrc = os.path.join(ROOT, "pix2pixhdaudiosr_torch", "csrc")
    src = open(os.path.join(csrc, "mdct.cu")).read()
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: csrc/mdct.cu no longer holds {old!r}")
            text = text.replace(old, new)
        d = os.path.join(out_root, name)
        os.makedirs(d, exist_ok=True)
        shutil.copy(os.path.join(csrc, "common.cuh"), d)
        with open(os.path.join(d, "mdct.cu"), "w") as f:
            f.write(text)
        so = os.path.join(d, "libmdct.so")
        cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I", d, "-o", so,
               os.path.join(d, "mdct.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    P, I = ctypes.c_void_p, ctypes.c_int
    for name, (proc, so) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-3000:]}")
        regs = [line.split(":", 1)[1].strip() for line in log.splitlines()
                if "Used" in line and "registers" in line]
        spills = sorted({line.strip() for line in log.splitlines()
                         if "spill" in line})
        print(f"[build {name}] " + json.dumps(dict(ptxas=regs, spills=spills)))
        lib = ctypes.CDLL(so)
        lib.p2p_mdct2_tc.argtypes = [P, P, P, P, I, I, I, I, I, I, P]
        lib.p2p_imdct2_tc.argtypes = [P, P, P, P, I, I, I, I, I, P]
        libs[name] = lib
    return libs


def events_ms(fn, iters: int = 50, warmup: int = 5) -> float:
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
        print("mdct_tc_ablation: CUDA is not available", file=sys.stderr)
        return 1
    from pix2pixhdaudiosr_torch.ops import mdct_kernels as mk
    from pix2pixhdaudiosr_torch.ops.framing import pad_signal
    from pix2pixhdaudiosr_torch.ops.mdct import IMDCT2, MDCT2
    from pix2pixhdaudiosr_torch.ops.window import kbdwin

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = build_all(os.path.join(ROOT, "pix2pixhdaudiosr_torch", "_build",
                                  "ablation"))
    win, hop, n_fft = 512, 256, 512
    kw = dict(n_fft=n_fft, hop_length=hop, win_length=win,
              window=kbdwin(win), device="cuda")
    fwd, inv = MDCT2(**kw), IMDCT2(**kw)
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for B in (128, 1):
        x = torch.randn(B, 32512, generator=gen, device="cuda") * 0.3
        x_pad = pad_signal(x, hop, True).contiguous()
        L = x_pad.shape[1]
        T = (L - win) // hop + 1
        spec = mk.mdct2_ref(x_pad, fwd.basis, hop).contiguous()
        want_f = mk.mdct2_ref(x_pad.double(), fwd.basis.double(), hop)
        want_i = mk.imdct2_ref(spec.double(), inv.basis.double(), hop)
        x_nan, spec_nan = x_pad.clone(), spec.clone()
        x_nan.view(torch.int32)[0, 3 * hop + 5] = 0x7FFFFFFF
        spec_nan.view(torch.int32)[0, 2, 9] = 0x7FFFFFFF
        flop = 2 * B * T * win * n_fft
        for name, lib in libs.items():
            out = torch.empty(B, T, n_fft, device="cuda")
            wav = torch.empty(B, (T - 1) * hop + win, device="cuda")

            def run_f(src=x_pad, dst=out, lib=lib):
                return lib.p2p_mdct2_tc(src.data_ptr(), fwd.planes[0].data_ptr(),
                                        fwd.planes[1].data_ptr(), dst.data_ptr(),
                                        B, L, T, win, hop, n_fft, stream)

            def run_i(src=spec, dst=wav, lib=lib):
                return lib.p2p_imdct2_tc(src.data_ptr(), inv.planes[0].data_ptr(),
                                         inv.planes[1].data_ptr(), dst.data_ptr(),
                                         B, T, n_fft, win, hop, stream)
            if run_f() or run_i():
                raise RuntimeError(f"{name}: launch refused")
            torch.cuda.synchronize()
            err = ((out.double() - want_f).abs().max().item(),
                   (wav.double() - want_i).abs().max().item())
            ms = (events_ms(run_f), events_ms(run_i))
            out_nan, wav_nan = torch.empty_like(out), torch.empty_like(wav)
            run_f(x_nan, out_nan)
            run_i(spec_nan, wav_nan)
            torch.cuda.synchronize()
            nan = (bool(out_nan[0].isnan().any()), bool(wav_nan[0].isnan().any()))
            for k, kind in enumerate(("mdct2", "imdct2")):
                print(f"[ablation {name} {kind} B={B}] " + json.dumps(dict(
                    ms=ms[k], tflops=flop / ms[k] / 1e9,
                    max_err_vs_f64=err[k] if name in CORRECT else None,
                    nan_propagates=nan[k] if name in CORRECT else None)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
