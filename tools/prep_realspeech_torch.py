#!/usr/bin/env python
"""Build a real-speech micro-corpus from the reference's committed wavs, on
the PyTorch port: a jax-free copy of tools/prep_realspeech.py (its flags,
its windows and its files), reading and writing through
pix2pixhdaudiosr_torch.data.

The reference checkout (--ref, required) commits real 48 kHz speech:
`test/test.wav` (728,728 samples, the README generate fixture) and the
`generated/GEN_VCTK_*/` hr_audio.wav utterance (374,855 samples). This
tool windows that ~1.1M samples of real speech into a train corpus of N files x 32512 samples at random offsets, plus
held-out eval files (each source's last 2 x 32512 samples) that share no
samples with any training window.

Usage: python tools/prep_realspeech_torch.py --ref DIR [--out realspeech] \
    [--n_train 160]
--out defaults to `realspeech` in the working directory.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from pix2pixhdaudiosr_torch.data import read_wav, write_wav  # noqa: E402

SOURCES = [
    "test/test.wav",
    "generated/GEN_VCTK_G3L2_48ngf/hr_audio.wav",
]
# The four GEN_VCTK_* variants commit the SAME utterance (hr_audio.wav is
# byte-identical across them; only the model outputs differ), so the only
# further material is their sr_audio.wav reconstructions: real speech
# below 4 kHz, MODEL-GENERATED content above. Using them as HR targets
# teaches the reference models' artifacts: opt-in augmentation for the
# data-limited-hypothesis experiment, never a quality claim.
SR_VARIANT_SOURCES = [
    "generated/GEN_VCTK_G3L2_48ngf/sr_audio.wav",
    "generated/GEN_VCTK_G3L2_48ngf_match_loss/sr_audio.wav",
    "generated/GEN_VCTK_G3L2_48ngf_match_loss_mse/sr_audio.wav",
    "generated/GEN_VCTK_hifitts_G3L2_48ngf_time_D/sr_audio.wav",
]
SEG = 32512
HOLDOUT = 2 * SEG  # tail of each source reserved for eval


def build_pools(include_sr_variants: bool, ref: str):
    """Training pools + held-out tails. Every pool ends BEFORE the holdout
    region of its utterance; for the sr variants the holdout is measured
    from the hr utterance's end, not the padded file's (sr_audio.wav is
    segment-padded past the utterance: 390,144 against 374,855 samples for
    GEN_VCTK_G3L2_48ngf, so `audio[:-HOLDOUT]` alone would leak ~15.3k
    samples of the eval region into the training pool). Returns (pools,
    [(holdout_tail, rate), ...])."""
    pools, holds, hr_len = [], [], None
    for name in SOURCES:
        path = os.path.join(ref, name)
        audio, rate = read_wav(path)
        assert rate == 48000, (path, rate)
        audio = np.asarray(audio, np.float32).reshape(-1)
        if name.startswith("generated/"):
            hr_len = audio.size  # the GEN_VCTK utterance length (374,855)
        pools.append(audio[:-HOLDOUT])
        holds.append((audio[-HOLDOUT:], rate))
    if include_sr_variants:
        for name in SR_VARIANT_SOURCES:
            path = os.path.join(ref, name)
            audio, rate = read_wav(path)
            assert rate == 48000, (path, rate)
            audio = np.asarray(audio, np.float32).reshape(-1)
            assert hr_len is not None and audio.size >= hr_len, path
            pools.append(audio[: hr_len - HOLDOUT])
    return pools, holds


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="realspeech")
    ap.add_argument("--n_train", type=int, default=160)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--include_sr_variants", action="store_true",
                    help="also window the four reference-model sr outputs "
                         "(same utterance, model-generated high band): "
                         "contaminated-target augmentation for the "
                         "data-limited-hypothesis experiment only")
    ap.add_argument("--ref", required=True,
                    help="the reference checkout, whose test/ and "
                         "generated/ hold the source wavs")
    args = ap.parse_args(argv)

    train_dir = os.path.join(args.out, "train")
    eval_dir = os.path.join(args.out, "eval")
    os.makedirs(train_dir, exist_ok=True)
    os.makedirs(eval_dir, exist_ok=True)

    pools, holds = build_pools(args.include_sr_variants, args.ref)
    total = sum(p.size for p in pools)
    for i, (hold, rate) in enumerate(holds):
        write_wav(os.path.join(eval_dir, f"held{i}.wav"), hold, rate)

    rng = np.random.default_rng(args.seed)
    weights = np.asarray([p.size for p in pools], np.float64)
    weights /= weights.sum()
    for j in range(args.n_train):
        p = pools[rng.choice(len(pools), p=weights)]
        off = int(rng.integers(0, p.size - SEG))
        write_wav(os.path.join(train_dir, f"r{j:03d}.wav"),
                  p[off: off + SEG], 48000)
    print(f"wrote {args.n_train} train files ({total} source samples) to "
          f"{train_dir}, {len(SOURCES)} held-out files to {eval_dir}")


if __name__ == "__main__":
    main()
