#!/usr/bin/env python
"""Score the reference's committed real-speech outputs with the port's
metrics: a jax-free copy of tools/score_reference_outputs.py (its flags,
its variants and its JSON), on pix2pixhdaudiosr_torch.metrics.

The reference checkout (--ref, required) ships hr/lr/sr wav triplets of
a real VCTK utterance for four trained experiment variants
(generated/GEN_VCTK_*/, its README.md:137-153) but publishes no metric
values. This tool runs the port's
`metrics.compute_metrics` (LSD / SNR / MSE and the segmental SNR) and
`metrics.lsd` of the renormalized lr over those triplets, on the CPU.

Usage: python tools/score_reference_outputs_torch.py --ref DIR [--out F]
Writes the original's JSON (a variant's scores under its name) to --out,
by default ref_speech_scores_torch.json in the working directory.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch  # noqa: E402

from pix2pixhdaudiosr_torch.data import read_wav  # noqa: E402
from pix2pixhdaudiosr_torch.metrics import (compute_metrics, lsd,  # noqa: E402
                                            renormalize)

OUT = "ref_speech_scores_torch.json"
VARIANTS = [
    "GEN_VCTK_G3L2_48ngf",
    "GEN_VCTK_G3L2_48ngf_match_loss",
    "GEN_VCTK_G3L2_48ngf_match_loss_mse",
    "GEN_VCTK_hifitts_G3L2_48ngf_time_D",
]


def score_triplet(base: str) -> dict:
    hr, rh = read_wav(os.path.join(base, "hr_audio.wav"))
    lr, rl = read_wav(os.path.join(base, "lr_audio.wav"))
    sr, rs = read_wav(os.path.join(base, "sr_audio.wav"))
    assert rh == rl == rs == 48000, (rh, rl, rs)
    n = min(hr.size, lr.size, sr.size)
    hr, lr, sr = (torch.from_numpy(a.reshape(-1)[:n][None].copy())
                  for a in (hr, lr, sr))
    mse, snr_sr, snr_lr, ssnr_sr, ssnr_lr, _, lsd_sr = compute_metrics(
        hr, lr, sr, n_fft=512, hop_length=256, win_length=512, center=True)
    hr_t = hr.float()
    lsd_lr = lsd(hr_t, renormalize(hr_t, lr.float()), n_fft=512,
                 hop_length=256, win_length=512)
    return {"samples": int(n), "mse": round(mse, 6),
            "snr_sr": round(snr_sr, 3), "snr_lr": round(snr_lr, 3),
            "ssnr_sr": round(ssnr_sr, 3), "ssnr_lr": round(ssnr_lr, 3),
            "lsd_sr": round(lsd_sr, 4), "lsd_lr": round(lsd_lr, 4)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ref", required=True,
                    help="the reference checkout, whose generated/ holds "
                         "the variants' wav triplets")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)

    res = {}
    for v in VARIANTS:
        base = os.path.join(args.ref, "generated", v)
        if not os.path.isdir(base):
            print(f"{v}: missing, skipped")
            continue
        res[v] = score_triplet(base)
        print(v, res[v])
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print("wrote", os.path.abspath(args.out))


if __name__ == "__main__":
    main()
